"""The launch plans and pass structures of the 2-D streaming matmul and the
SSD scan kernels, on the CPU, against the JAX package.

* ``matmul_plan``: the output tiles cover (M, N) and the splits cover every
  row of K exactly once; products with fewer tiles than SMs split K. The
  plain split-K model ``matmul_split_ref`` (partials summed in the kernel's
  split order) against the Pallas ``stream_matmul`` in interpret mode and
  its pure-jnp oracle.
* ``ssd_plan``: the chunks cover S, the row blocks P, the warps N. The
  plain model of the SSD kernel's passes ``ssd_chunked_ref`` (C B^T once a
  group, decay vectors a head, TF32 hi/lo splits emulated) against the
  Pallas ``ssd_chunk_scan`` in interpret mode, the chunked ``ssd_scan`` and
  the sequential recurrence; its bf16 error against fp32 against plain
  bf16 ``ssd_scan``'s.

The CUDA kernels are held against the plain versions on the card in
tests/test_torch_cuda.py.

Tolerances: the matmul's atol tol * sqrt(k), rtol tol (tol 2e-4 fp32, 2e-2
bf16: summation order, bf16 rounds the output once), as tests/test_kernels.py;
the SSD's atol 5e-4, rtol 5e-3 between the sequential and chunked forms (the
reference's own), atol 2e-2, rtol 2e-2 in bf16 (y rounded to bf16 once).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import mamba2_chunk as tssd
from repro_torch.kernels import stream_matmul as tmm
from repro_torch.layers.ssm import ssd_scan

torch.set_num_threads(1)

SMS = 132                      # the H100's SMs
MM_TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
SSD_TOL = dict(atol=5e-4, rtol=5e-3)
TOL_BF16 = dict(atol=2e-2, rtol=2e-2)
DTYPES = [torch.float32, torch.bfloat16]

# the rc3e path's product, the card tests' unaligned, split-K and tile-edge
# shapes, and 4096^3
MM_SHAPES = [(129, 257, 65), (200, 300, 150), (200, 301, 150),
             (16, 8192, 16), (1, 4096, 1), (64, 4096, 64),
             (127, 127, 127), (129, 129, 129), (255, 255, 255),
             (16, 16, 16), (4096, 4096, 4096)]


# ---------------------------------------------------------------------------
# Streaming matmul: the plan and the split-K model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,k,n", MM_SHAPES)
def test_matmul_plan_covers_every_tile_and_k_row_once(m, k, n, dtype):
    plan = tmm.matmul_plan(m, k, n, dtype, SMS)
    assert plan.bk == tmm.MM_BK[dtype] and plan.tile == tmm.MM_TILE
    # output tiles: the last one reaches past the edge, none lies beyond it
    assert (plan.tiles_m - 1) * plan.tile < m <= plan.tiles_m * plan.tile
    assert (plan.tiles_n - 1) * plan.tile < n <= plan.tiles_n * plan.tile
    rows = plan.kt_per * plan.bk
    ranges = [range(z * rows, min(k, (z + 1) * rows))
              for z in range(plan.n_split)]
    assert all(len(r) > 0 for r in ranges)              # no split is empty
    assert [i for r in ranges for i in r] == list(range(k))
    if plan.tiles_m * plan.tiles_n >= SMS:
        assert plan.n_split == 1
    if plan.n_split > 1:
        assert plan.kt_per >= tmm.MM_MIN_SPLIT_KT
        assert plan.n_split <= tmm.MM_MAX_SPLITS


@pytest.mark.parametrize("dtype,n_split,kt_per", [
    (torch.float32, 6, 3), (torch.bfloat16, 2, 3)])
def test_matmul_plan_at_the_rc3e_shape(dtype, n_split, kt_per):
    """129x257x65 (BAaaS / RSaaS): 2 output tiles on 132 SMs split K."""
    plan = tmm.matmul_plan(129, 257, 65, dtype, SMS)
    assert (plan.tiles_m, plan.tiles_n) == (2, 1)
    assert (plan.n_split, plan.kt_per) == (n_split, kt_per)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,k,n", [(129, 257, 65), (200, 301, 150),
                                   (16, 2048, 16), (64, 1024, 64),
                                   (1, 515, 3)])
def test_matmul_split_model_matches_reference(m, k, n, dtype):
    plan = tmm.matmul_plan(m, k, n, dtype, SMS)
    assert plan.n_split > 1                  # the split path is exercised
    rng = np.random.default_rng(m * k + n)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    ta, tb = torch.from_numpy(a).to(dtype), torch.from_numpy(b).to(dtype)
    got = tmm.matmul_split_ref(ta, tb, plan)
    assert got.dtype == dtype and tuple(got.shape) == (m, n)
    tol = MM_TOL[dtype]
    ja, jb = jnp.asarray(a, JDT[dtype]), jnp.asarray(b, JDT[dtype])
    for force in ("interpret", "ref"):
        ref = jops.matmul(ja, jb, force=force)
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(ref, np.float32),
                                   atol=tol * k ** 0.5, rtol=tol)


def test_matmul_split_model_one_split_is_the_plain_product():
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.standard_normal((40, 30)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((30, 20)).astype(np.float32))
    plan = tmm.matmul_plan(40, 30, 20, torch.float32, sms=1)
    assert plan.n_split == 1
    torch.testing.assert_close(tmm.matmul_split_ref(a, b, plan),
                               tmm.matmul_ref(a, b), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# SSD: the plan and the model of the kernel's passes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,S,H,P,N", [
    (4, 1024, 32, 64, 128), (8, 256, 32, 64, 128), (1, 2048, 32, 64, 128),
    (2, 1000, 32, 64, 128), (2, 77, 8, 48, 64), (3, 40, 4, 16, 16),
    (1, 100, 8, 32, 64), (1, 1, 1, 16, 16), (1, 65, 2, 64, 128)])
def test_ssd_plan_covers_every_step_row_and_column(B, S, H, P, N):
    plan = tssd.ssd_plan(B, S, H, P, N, SMS)
    assert plan.q == tssd.SSD_CHUNK
    assert (plan.n_chunks - 1) * plan.q < S <= plan.n_chunks * plan.q
    rows = 16 * plan.wp
    assert (plan.p_blocks - 1) * rows < P <= plan.p_blocks * rows
    assert N % plan.ns == 0 and (N // plan.ns) % 8 == 0   # whole n8 tiles
    # the block shapes the kernel is built for
    assert (plan.wp, plan.ns) in ((4, 2), (1, 8 if N >= 64 else 2))


@pytest.mark.parametrize("B,S,wp", [(4, 1024, 4), (8, 256, 4), (1, 2048, 1),
                                    (2, 1000, 1)])
def test_ssd_plan_at_the_serving_shapes(B, S, wp):
    """mamba2-370m (H 32, P 64, N 128) on 132 SMs: 64-row blocks where the
    (sequence, head) pairs fill half the card, else 16-row blocks."""
    plan = tssd.ssd_plan(B, S, 32, 64, 128, SMS)
    assert plan.wp == wp
    assert B * 32 * plan.p_blocks >= SMS // 2 or plan.wp == 1


def _ssd_inputs(b, s, h, p, g, n, seed, init=False):
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    t = torch.from_numpy
    xs, bm, cm = t(f(b, s, h, p) * 0.5), t(f(b, s, g, n) * 0.3), \
        t(f(b, s, g, n) * 0.3)
    dt = torch.nn.functional.softplus(t(f(b, s, h)) - 1.0)
    A, D = -torch.exp(t(f(h))), t(f(h))
    st = t(f(b, h, p, n) * 0.1) if init else None
    return xs, dt, A, bm, cm, D, st


@pytest.mark.parametrize("q", [32, 64])            # the kernel's, and twice
@pytest.mark.parametrize("s,chunk", [(64, 16), (128, 32), (256, 64)])
def test_ssd_pass_model_matches_pallas(s, chunk, q):
    """Reference layout (BH, S, P), one group a head, against the Pallas
    kernel in interpret mode and its oracle."""
    rng = np.random.default_rng(s + q)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    x, dt = f(3, s, 16) * 0.5, np.log1p(np.exp(f(3, s))).astype(np.float32)
    bm, cm = f(3, s, 64) * 0.3, f(3, s, 64) * 0.3
    a, d = -np.exp(f(3)), np.ones((3,), np.float32)
    t = [torch.from_numpy(v) for v in (x, dt, bm, cm)]
    xs, dtl, bl, cl = tssd._as_layer(*t)
    y, _ = tssd.ssd_chunked_ref(xs, dtl, torch.from_numpy(a), bl, cl,
                                torch.from_numpy(d), q=q)
    got = y[0].transpose(0, 1).numpy()
    for force in ("interpret", "ref"):
        ref = jops.ssd_chunk_scan(x, dt, bm, cm, a, d, chunk=chunk,
                                  force=force)
        np.testing.assert_allclose(got, np.asarray(ref), **SSD_TOL)


@pytest.mark.parametrize("case", [
    # (B, S, H, P, G, N, init, q)
    (2, 77, 8, 48, 2, 64, True, 32),       # ragged S, G 2, init state
    (1, 100, 8, 32, 4, 64, True, 64),      # G 4, S past one chunk
    (3, 40, 4, 16, 1, 16, False, 32),      # N 16, S < 2 chunks
    (1, 20, 4, 16, 1, 16, False, 64),      # S < Q
    (1, 65, 2, 64, 1, 128, True, 64)])     # S = Q + 1, mamba2's P, N
def test_ssd_pass_model_matches_ssd_scan_and_recurrence(case):
    B, S, H, P, G, N, init, q = case
    xs, dt, A, bm, cm, D, st0 = _ssd_inputs(B, S, H, P, G, N, seed=S + N,
                                            init=init)
    y, st = tssd.ssd_chunked_ref(xs, dt, A, bm, cm, D, st0, q=q)
    assert y.shape == (B, S, H, P) and st.shape == (B, H, P, N)
    for ry, rs in (ssd_scan(xs, dt, A, bm, cm, D, 256, st0),
                   tssd.ssd_ref(xs, dt, A, bm, cm, D, st0)):
        torch.testing.assert_close(y, ry, **SSD_TOL)
        torch.testing.assert_close(st, rs, **SSD_TOL)


def test_ssd_pass_model_chunk_invariant():
    """The result does not depend on the kernel's chunk but for rounding."""
    xs, dt, A, bm, cm, D, st0 = _ssd_inputs(2, 130, 4, 32, 2, 64, seed=5,
                                            init=True)
    y32, s32 = tssd.ssd_chunked_ref(xs, dt, A, bm, cm, D, st0, q=32)
    y64, s64 = tssd.ssd_chunked_ref(xs, dt, A, bm, cm, D, st0, q=64)
    torch.testing.assert_close(y32, y64, **SSD_TOL)
    torch.testing.assert_close(s32, s64, **SSD_TOL)


def test_ssd_pass_model_bf16_inputs():
    """bf16 x, B, C (exact in TF32: one split side) against ssd_scan on the
    same bf16 inputs, y rounded to bf16 once on both sides."""
    xs, dt, A, bm, cm, D, st0 = _ssd_inputs(2, 150, 4, 32, 1, 64, seed=9,
                                            init=True)
    args = (xs.bfloat16(), dt, A, bm.bfloat16(), cm.bfloat16(), D, st0)
    y, st = tssd.ssd_chunked_ref(*args)
    assert y.dtype == torch.bfloat16 and st.dtype == torch.float32
    ry, rs = ssd_scan(*args[:6], 256, st0)
    torch.testing.assert_close(y.float(), ry.float(), **TOL_BF16)
    torch.testing.assert_close(st, rs, **SSD_TOL)


def test_ssd_pass_model_bf16_error_no_worse_than_plain():
    """At a reduced width, the model's bf16 RMS error against the fp32
    recurrence is at most 1.05x that of plain bf16 ssd_scan (the gate
    ssm_serve applies to the kernel path's logits)."""
    xs, dt, A, bm, cm, D, _ = _ssd_inputs(2, 256, 8, 32, 1, 64, seed=13)
    ref, _ = tssd.ssd_ref(xs, dt, A, bm, cm, D)
    args16 = (xs.bfloat16(), dt, A, bm.bfloat16(), cm.bfloat16(), D)
    model, _ = tssd.ssd_chunked_ref(*args16)
    plain, _ = ssd_scan(*args16, 256)
    rms = lambda y: float((y.float() - ref).pow(2).mean().sqrt())
    assert rms(model) <= 1.05 * rms(plain)


def test_tf32_rounding_is_ties_away_to_10_bits():
    v = torch.tensor([1.0 + 2 ** -11, 1.0 + 2 ** -12, -(1.0 + 2 ** -11),
                      1.0 + 3 * 2 ** -11, 3.0], dtype=torch.float32)
    got = tssd._tf32(v)
    want = torch.tensor([1.0 + 2 ** -10, 1.0, -(1.0 + 2 ** -10),
                         1.0 + 2 ** -9, 3.0])
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    lo = tssd._tf32(v - got)
    torch.testing.assert_close(got + lo, v, rtol=0, atol=0)
