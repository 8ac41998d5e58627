"""Port of the Mamba2 SSD against the JAX package, on the CPU.

* The plain ``ssd_chunk_scan`` (the sequential recurrence the CUDA kernel is
  held against) against the JAX Pallas kernel in interpret mode and its
  pure-jnp oracle, on the cases of tests/test_kernels.py.
* The port's chunked ``ssd_scan`` against JAX's, with chunk invariance, the
  state carry through ``init_state`` and a ragged S; the plain kernel's
  (y, state) against ``ssd_scan``'s.
* ``ssm_forward`` and ``ssm_decode`` against JAX at reduced width, and the
  refusal of prompts shorter than d_conv - 1.

Tolerances: atol 5e-4, rtol 5e-3 between the sequential recurrence and the
chunked form (the reference's own SSD tolerance, tests/test_kernels.py);
atol 2e-5, rtol 2e-4 where both sides run the same algorithm in fp32.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.kernels import ops as jops
from repro.layers import ssm as jssm
from repro_torch.configs import get_config, reduced
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import launches, ops
from repro_torch.kernels import mamba2_chunk as tssd
from repro_torch.layers import ssm as tssm

torch.set_num_threads(1)

SSD_TOL = dict(atol=5e-4, rtol=5e-3)
TOL = dict(atol=2e-5, rtol=2e-4)


def _t(a):
    return torch.from_numpy(np.array(a))


def _softplus(x):
    return np.log1p(np.exp(x)).astype(np.float32)


def _kernel_inputs(bh, s, p, n, seed):
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    return (f(bh, s, p) * 0.5, _softplus(f(bh, s)), f(bh, s, n) * 0.3,
            f(bh, s, n) * 0.3, -np.exp(f(bh)), np.ones((bh,), np.float32))


def _layer_inputs(b, s, h, p, g, n, seed):
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    return (f(b, s, h, p) * 0.5, _softplus(f(b, s, h)), -np.exp(f(h)),
            f(b, s, g, n) * 0.3, f(b, s, g, n) * 0.3, f(h))


# ---------------------------------------------------------------------------
# The kernel's plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s,chunk", [(64, 16), (128, 32), (96, 32), (256, 64)])
@pytest.mark.parametrize("n", [16, 64])
def test_plain_ssd_chunk_scan_matches_reference(s, chunk, n):
    x, dt, Bm, Cm, a, d = _kernel_inputs(3, s, 16, n, seed=s + n)
    got = ops.ssd_chunk_scan(*map(_t, (x, dt, Bm, Cm, a, d)), chunk=chunk)
    assert got.shape == (3, s, 16) and got.dtype == torch.float32
    for force in ("interpret", "ref"):
        ref = jops.ssd_chunk_scan(x, dt, Bm, Cm, a, d, chunk=chunk,
                                  force=force)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **SSD_TOL)


def test_plain_version_counts_no_launch():
    before = dict(launches)
    x, dt, Bm, Cm, a, d = _kernel_inputs(2, 20, 8, 16, seed=1)
    ops.ssd_chunk_scan(*map(_t, (x, dt, Bm, Cm, a, d)))
    ops.ssd(*map(_t, _layer_inputs(1, 20, 2, 8, 1, 16, seed=1)))
    assert dict(launches) == before


def test_meta_tensors_give_shapes():
    xs, dt, A, Bm, Cm, D = (torch.empty(a.shape, device="meta") for a in
                            _layer_inputs(2, 7, 4, 8, 2, 16, seed=0))
    y, state = ops.ssd(xs, dt, A, Bm, Cm, D)
    assert y.shape == (2, 7, 4, 8) and state.shape == (2, 4, 8, 16)


# ---------------------------------------------------------------------------
# The layer's chunked scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [8, 16, 64])
def test_ssd_scan_matches_reference_and_is_chunk_invariant(chunk):
    args = _layer_inputs(2, 64, 4, 8, 2, 16, seed=0)
    y, s = tssm.ssd_scan(*map(_t, args), chunk=chunk)
    jy, js = jssm.ssd_scan(*args, chunk=chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), **TOL)
    y_full, s_full = tssm.ssd_scan(*map(_t, args), chunk=64)
    np.testing.assert_allclose(y.numpy(), y_full.numpy(), atol=1e-4,
                               rtol=1e-3)
    np.testing.assert_allclose(s.numpy(), s_full.numpy(), atol=1e-4,
                               rtol=1e-3)


@pytest.mark.parametrize("scan", ["ssd_scan", "plain_kernel"])
def test_ssd_state_carry_equals_concat(scan):
    """scan(x1) then scan(x2 | state) == scan([x1; x2])."""
    xs, dt, A, Bm, Cm, D = map(_t, _layer_inputs(1, 64, 2, 8, 1, 8, seed=5))
    D = torch.zeros_like(D)
    if scan == "ssd_scan":
        run = lambda *a, init_state=None: tssm.ssd_scan(
            *a, chunk=16, init_state=init_state)
    else:
        run = lambda *a, init_state=None: ops.ssd(*a, init_state=init_state)
    y_full, s_full = run(xs, dt, A, Bm, Cm, D)
    h = slice(None, 32), slice(32, None)
    y1, s1 = run(xs[:, h[0]], dt[:, h[0]], A, Bm[:, h[0]], Cm[:, h[0]], D)
    y2, s2 = run(xs[:, h[1]], dt[:, h[1]], A, Bm[:, h[1]], Cm[:, h[1]], D,
                 init_state=s1)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(),
                               y_full.numpy(), atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(s2.numpy(), s_full.numpy(), atol=1e-4,
                               rtol=1e-3)
    if scan == "ssd_scan":        # the carry through JAX's scan as well
        args = _layer_inputs(1, 64, 2, 8, 1, 8, seed=5)
        _, js1 = jssm.ssd_scan(*(a[:, :32] if a.ndim > 1 else a
                                 for a in args[:5]),
                               np.zeros(2, np.float32), chunk=16)
        jy2, _ = jssm.ssd_scan(*(a[:, 32:] if a.ndim > 1 else a
                                 for a in args[:5]),
                               np.zeros(2, np.float32), chunk=16,
                               init_state=js1)
        np.testing.assert_allclose(y2.numpy(), np.asarray(jy2), **TOL)


@pytest.mark.parametrize("s,chunk", [(50, 16), (37, 8)])
def test_ssd_scan_ragged_sequence(s, chunk):
    """S not a multiple of the chunk: the reference pads with dt = 0 steps;
    the plain kernel takes any S."""
    args = _layer_inputs(2, s, 4, 8, 2, 16, seed=s)
    y, st = tssm.ssd_scan(*map(_t, args), chunk=chunk)
    jy, js = jssm.ssd_scan(*args, chunk=chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(js), **TOL)
    py, ps = ops.ssd(*map(_t, args))
    np.testing.assert_allclose(py.numpy(), y.numpy(), **SSD_TOL)
    np.testing.assert_allclose(ps.numpy(), st.numpy(), **SSD_TOL)


@pytest.mark.parametrize("g", [1, 2])
def test_plain_kernel_matches_ssd_scan(g):
    """(y, state) of the sequential recurrence against the chunked form,
    heads sharing groups, from a nonzero init state."""
    xs, dt, A, Bm, Cm, D = map(_t, _layer_inputs(2, 48, 4, 8, g, 16, seed=g))
    init = _t(np.random.default_rng(9).standard_normal((2, 4, 8, 16))
              .astype(np.float32) * 0.1)
    y, s = ops.ssd(xs, dt, A, Bm, Cm, D, init_state=init)
    ry, rs = tssm.ssd_scan(xs, dt, A, Bm, Cm, D, chunk=16, init_state=init)
    np.testing.assert_allclose(y.numpy(), ry.numpy(), **SSD_TOL)
    np.testing.assert_allclose(s.numpy(), rs.numpy(), **SSD_TOL)


def test_reference_layout_is_the_layer_case():
    """The (BH, S, P) entry is one sequence of BH heads, one group each."""
    x, dt, Bm, Cm, a, d = map(_t, _kernel_inputs(3, 40, 8, 16, seed=2))
    y = tssd.ssd_chunk_scan_ref(x, dt, Bm, Cm, a, d)
    yl, _ = tssd.ssd_ref(x.transpose(0, 1)[None], dt.transpose(0, 1)[None],
                         a, Bm.transpose(0, 1)[None],
                         Cm.transpose(0, 1)[None], d)
    assert torch.equal(y, yl[0].transpose(0, 1))


# ---------------------------------------------------------------------------
# The Mamba2 block
# ---------------------------------------------------------------------------

def _opts(force):
    cfg = reduced(get_config("mamba2-370m"))
    jcfg = j_reduced(j_get_config("mamba2-370m"))
    return (tssm.SSMOpts(d_model=cfg.d_model, cfg=cfg.ssm,
                         kernel_force=force),
            jssm.SSMOpts(d_model=jcfg.d_model, cfg=jcfg.ssm, tp=False))


def _block_params(jopts, seed):
    """JAX-initialised block weights with a nonzero gate norm (the
    reference's init sets it to 0, which zeroes the block's output), as
    numpy."""
    p = jax.tree.map(np.asarray,
                     jssm.init_ssm(jax.random.PRNGKey(seed), jopts))
    rng = np.random.default_rng(seed)
    p["norm"] = (1.0 + 0.1 * rng.standard_normal(p["norm"].shape)) \
        .astype(np.float32)
    p["dt_bias"] = (0.1 * rng.standard_normal(p["dt_bias"].shape)) \
        .astype(np.float32)
    return p


def _port(p):
    return {k: _t(v) for k, v in p.items()}


@pytest.mark.parametrize("force", ["ref", ""])
def test_ssm_forward_and_decode_match_reference(force):
    opts, jopts = _opts(force)
    p = _block_params(jopts, seed=0)
    jp = jax.tree.map(jnp.asarray, p)
    tol = TOL if force == "ref" else SSD_TOL
    x = np.random.default_rng(1).standard_normal(
        (2, 24, opts.d_model)).astype(np.float32)
    y, (state, tail) = tssm.ssm_forward(_port(p), _t(x), opts)
    jy, (jstate, jtail) = jssm.ssm_forward(jp, jnp.asarray(x), jopts)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **tol)
    np.testing.assert_allclose(state.numpy(), np.asarray(jstate), **tol)
    np.testing.assert_allclose(tail.numpy(), np.asarray(jtail), **TOL)
    cache = tssm.init_ssm_cache(2, opts, torch.float32)
    tssm.fill_ssm_cache(cache, state, tail)
    jcache = {"state": jstate, "conv": jtail}
    xt = np.random.default_rng(2).standard_normal(
        (4, 2, 1, opts.d_model)).astype(np.float32)
    for t in range(4):
        yd, out = tssm.ssm_decode(_port(p), _t(xt[t]), cache, opts)
        jyd, jcache = jssm.ssm_decode(jp, jnp.asarray(xt[t]), jcache, jopts)
        assert out is cache                       # updated in place
        np.testing.assert_allclose(yd.numpy(), np.asarray(jyd), **tol)
        np.testing.assert_allclose(cache["state"].numpy(),
                                   np.asarray(jcache["state"]), **tol)
        np.testing.assert_allclose(cache["conv"].numpy(),
                                   np.asarray(jcache["conv"]), **TOL)


def test_causal_conv_matches_reference():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 11, 24)).astype(np.float32)
    w = rng.standard_normal((4, 24)).astype(np.float32)
    b = rng.standard_normal((24,)).astype(np.float32)
    got = tssm._causal_conv(_t(x), _t(w), _t(b))
    assert got.is_contiguous()
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jssm._causal_conv(x, w, b)), **TOL)


@pytest.mark.parametrize("s", [1, 2])
def test_prompt_shorter_than_conv_buffer_refused(s):
    opts, jopts = _opts("")
    p = _port(_block_params(jopts, seed=0))
    x = torch.randn((1, s, opts.d_model),
                    generator=torch.Generator().manual_seed(0))
    _, (state, tail) = tssm.ssm_forward(p, x, opts)
    cache = tssm.init_ssm_cache(1, opts, torch.float32)
    with pytest.raises(ValueError, match="at least d_conv-1 = 3 tokens"):
        tssm.fill_ssm_cache(cache, state, tail)


def test_ssm_fp32_leaves_stay_fp32():
    """A_log, dt_bias and D are fp32 in a bf16 model, in the port's init
    and through interop, as in the reference."""
    cfg = reduced(get_config("mamba2-370m")).replace(param_dtype="bfloat16")
    opts = tssm.SSMOpts(d_model=cfg.d_model, cfg=cfg.ssm)
    p = tssm.init_ssm(torch.Generator().manual_seed(0), opts, torch.bfloat16)
    for k, v in p.items():
        want = torch.float32 if k in ("A_log", "dt_bias", "D") \
            else torch.bfloat16
        assert v.dtype == want, k
    a = p["A_log"].exp()
    lo, hi = cfg.ssm.a_init_range
    assert bool(((a >= lo * 0.999) & (a <= hi * 1.001)).all())
    tree = {"stages": ({"ssm": {k: v.float().numpy() for k, v in p.items()},
                        "norm1": np.zeros(cfg.d_model, np.float32)},)}
    got = params_from_numpy(tree, cfg)["stages"][0]
    assert got["norm1"].dtype == torch.bfloat16
    for k, v in got["ssm"].items():
        assert v.dtype == p[k].dtype, k


def test_kernel_force_modes():
    opts, _ = _opts("interpret")
    with pytest.raises(ValueError, match="kernel_force"):
        tssm.ssm_forward({}, torch.zeros((1, 4, opts.d_model)),
                         dataclasses.replace(opts, kernel_force="interpret"))
