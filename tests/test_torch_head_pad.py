"""Head dims outside ``HEAD_DIMS`` on the CPU: the attention wrappers run a
multiple of 8 up to 256 zero-padded to the next head dim the kernels are
built for, with the true scale ``D ** -0.5`` and the output sliced back
(``pads_head_dim``, the decorator on the three CUDA wrappers), and one from
264 to 512 unpadded (the kernels built for 384 and 512 read the true width
in place). Here that decorator is put on each of the port's plain versions
(flash, dense decode, paged decode; the decode ones also with an int8 KV
cache and its scales), and the result must equal the JAX package's oracle
(``repro.kernels.ref``), which takes the unpadded D directly: padded at D
40, 80 and 200, passed through as they are at D 264, 320 and 392 (fp32 atol
2e-5, rtol 2e-4). D 84 (not a multiple of 8), D 12 and D 520 (past 512)
still raise, as the reference refuses D 84. The CUDA wrappers' own padded
and in-place launches are held in tests/test_torch_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import decode_attention as tda
from repro_torch.kernels import flash_attention as tfa

torch.set_num_threads(1)

TOL = dict(atol=2e-5, rtol=2e-4)


def _to_pool(x, B, nb, ps, fill):
    """A dense (B, ...) per-sequence array as a paged pool: page 0 left at
    ``fill`` (never referenced), sequence b's j-th page at 1 + b * nb + j."""
    x = np.asarray(x)
    L = x.shape[-1] if x.ndim == 2 else x.shape[2]
    assert L == nb * ps
    if x.ndim == 2:                                 # kpos (B, L)
        pages = x.reshape(B * nb, ps)
    else:                                           # (B, H, L[, D])
        pages = x.reshape((B, x.shape[1], nb, ps) + x.shape[3:]) \
            .swapaxes(1, 2).reshape((B * nb, x.shape[1], ps) + x.shape[3:])
    out = np.full((1,) + pages.shape[1:], fill, dtype=x.dtype)
    return np.concatenate([out, pages])


def _decode_case(rng, d, quant):
    B, L = 3, 48
    q = rng.standard_normal((B, 4, d)).astype(np.float32)
    if quant:
        k, v = (rng.integers(-127, 128, (B, 2, L, d)).astype(np.int8)
                for _ in range(2))
        scales = [rng.uniform(0.005, 0.02, (B, 2, L)).astype(np.float32)
                  for _ in range(2)]
    else:
        k, v = (rng.standard_normal((B, 2, L, d)).astype(np.float32)
                for _ in range(2))
        scales = [None, None]
    kpos = np.tile(np.arange(L, dtype=np.int32), (B, 1))
    kpos[1, 40:] = -1
    cur = np.array([47, 39, -1], dtype=np.int32)              # an idle row
    return q, k, v, kpos, cur, scales


KERNELS = ["flash", "decode", "paged_decode", "decode_int8",
           "paged_decode_int8"]


@pytest.mark.parametrize("d,dp", [(40, 64), (80, 96), (200, 256)])
@pytest.mark.parametrize("kernel", KERNELS)
def test_padded_plain_version_equals_unpadded(kernel, d, dp):
    assert tda.padded_head_dim(f"{kernel.removesuffix('_int8')}_attention",
                               d) == dp
    _run_against_oracle(kernel, d, dp)


@pytest.mark.parametrize("d,built", [(264, 384), (320, 384), (392, 512)])
@pytest.mark.parametrize("kernel", KERNELS)
def test_wide_head_dims_are_read_in_place(kernel, d, built):
    """Past 256 the decorator hands q, k and v on unpadded (the kernel
    built for the next width masks the rest of the row), and the result is
    the JAX oracle's at the true D."""
    assert tda.padded_head_dim(f"{kernel.removesuffix('_int8')}_attention",
                               d) == built
    _run_against_oracle(kernel, d, d)


def _run_against_oracle(kernel, d, dp):
    """The decorated plain version of ``kernel`` at head dim ``d`` must
    see q, k and v ``dp`` wide and equal the JAX oracle at ``d``."""
    base = kernel.removesuffix("_int8")
    name = f"{base}_attention"
    rng = np.random.default_rng(d)
    T = lambda x: None if x is None else torch.from_numpy(x)   # noqa: E731
    J = lambda x: None if x is None else jnp.asarray(x)        # noqa: E731
    seen = []

    def recorded(fn):
        def run(q, k, v, *args, **kw):
            seen.append((q.shape[-1], k.shape[-1], v.shape[-1]))
            return fn(q, k, v, *args, **kw)
        return tda.pads_head_dim(name)(run)

    if base == "flash":
        q, k, v = (rng.standard_normal(s).astype(np.float32) for s in
                   ((2, 4, 40, d), (2, 2, 40, d), (2, 2, 40, d)))
        kw = dict(window=16, softcap=30.0)
        want = jref.flash_attention_ref(J(q), J(k), J(v), **kw)
        got = recorded(tfa.flash_attention_ref)(T(q), T(k), T(v), **kw)
    else:
        q, k, v, kpos, cur, (ks, vs) = _decode_case(rng, d,
                                                    kernel.endswith("int8"))
        if base == "decode":
            want = jref.decode_attention_ref(
                J(q), J(k), J(v), J(kpos), J(cur), k_scale=J(ks),
                v_scale=J(vs))
            got = recorded(tda.decode_attention_ref)(
                T(q), T(k), T(v), T(kpos), T(cur), k_scale=T(ks),
                v_scale=T(vs))
        else:
            B, ps = q.shape[0], 16
            nb = kpos.shape[1] // ps
            bt = np.arange(1, 1 + B * nb, dtype=np.int32).reshape(B, nb)
            kp, vp = _to_pool(k, B, nb, ps, 0), _to_pool(v, B, nb, ps, 0)
            pp = _to_pool(kpos, B, nb, ps, -1)
            ksp, vsp = (None if s is None else _to_pool(s, B, nb, ps, 1.0)
                        for s in (ks, vs))
            want = jref.paged_decode_attention_ref(
                J(q), J(kp), J(vp), J(pp), J(bt), J(cur), k_scale=J(ksp),
                v_scale=J(vsp))
            got = recorded(tda.paged_decode_attention_ref)(
                T(q), T(kp), T(vp), T(pp), T(bt), T(cur), k_scale=T(ksp),
                v_scale=T(vsp))
    assert seen == [(dp, dp, dp)]
    assert got.shape == tuple(want.shape)
    torch.testing.assert_close(got, torch.from_numpy(np.array(want)),
                               **TOL)


@pytest.mark.parametrize("d", [32, 64, 96, 112, 128, 256, 384, 512])
def test_head_dims_of_the_set_are_not_padded(d):
    assert tda.padded_head_dim("decode_attention", d) == d
    x = torch.zeros((2, d))
    assert tda.pad_head_dim(x, d) is x


@pytest.mark.parametrize("d", [84, 520, 12])
def test_other_head_dims_still_raise(d):
    with pytest.raises(ValueError, match=r"up to 512 \(built for \(32, 64, "
                       r"96, 112, 128, 256, 384, 512\)"):
        tda.padded_head_dim("flash_attention", d)
