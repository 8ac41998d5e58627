"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card. Imports nothing of JAX, so it runs on a machine without it:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Without a CUDA device every test skips. Tolerances: atol 2e-5, rtol 2e-4 in
float32; atol 2e-2, rtol 2e-2 in bfloat16 (both sides accumulate in fp32
and round once to bf16; they differ by summation order). The SSD scan is
held at the reference's SSD tolerance, atol 5e-4, rtol 5e-3, in float32.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import decode_attention as tda
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import _lib, launches

torch.set_num_threads(1)

TOL = dict(atol=2e-5, rtol=2e-4)
TOL_BF16 = dict(atol=2e-2, rtol=2e-2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _normal(rng, shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


def _quant(x):
    amax = x.abs().amax(-1)
    s = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    return torch.clamp(torch.round(x / s[..., None]), -127, 127) \
        .to(torch.int8), s


def _decode_inputs(B, hq, hkv, L, D, cur, fill, seed):
    rng = np.random.default_rng(seed)
    kpos = torch.arange(L, dtype=torch.int32)[None].expand(B, L)
    kpos = torch.where(kpos < L - fill, kpos, -1).contiguous()
    return (_normal(rng, (B, hq, D)), _normal(rng, (B, hkv, L, D)),
            _normal(rng, (B, hkv, L, D)), kpos,
            torch.tensor(cur, dtype=torch.int32))


def _to_pool(k, v, kpos, ps, seed):
    """Scatter a dense (B, Hkv, L, ...) cache over shuffled pages of a
    (P, Hkv, ps, ...) pool, page 0 left as the null page."""
    B, L = kpos.shape
    nb = L // ps
    P = 2 * B * nb
    rng = np.random.default_rng(seed)
    bt = torch.from_numpy(rng.permutation(np.arange(1, P))[:B * nb]
                          .reshape(B, nb).astype(np.int32))

    def scatter(x, fill):
        pool = torch.full((P,) + tuple(x.shape[1:2]) * (x.dim() > 2) + (ps,)
                          + tuple(x.shape[3:]), fill, dtype=x.dtype)
        if x.dim() == 2:
            pool[bt.long()] = x.reshape(B, nb, ps)
        else:
            pool[bt.long()] = x.reshape((B, x.shape[1], nb, ps)
                                        + tuple(x.shape[3:])).movedim(2, 1)
        return pool

    return scatter(k, 0), scatter(v, 0), scatter(kpos, -1), bt, scatter


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [0, 64])
@pytest.mark.parametrize("s", [256, 300])
@pytest.mark.parametrize("hq,hkv,d", [(9, 3, 64), (4, 1, 32), (4, 2, 128)])
def test_flash_kernel_on_card(cuda, dtype, window, s, hq, hkv, d):
    rng = np.random.default_rng(s + d)
    q, k, v = (_normal(rng, shp).to(cuda, dtype) for shp in
               ((2, hq, s, d), (2, hkv, s, d), (2, hkv, s, d)))
    n = launches["flash_attention"]
    got = tfa.flash_attention_cuda(q, k, v, window=window, softcap=0.0)
    ref = tfa.flash_attention_ref(q, k, v, window=window)
    torch.testing.assert_close(got.float(), ref.float(),
                               **(TOL if dtype == torch.float32
                                  else TOL_BF16))
    assert launches["flash_attention"] == n + 1
    capped = tfa.flash_attention_cuda(q, k, v, softcap=30.0)
    torch.testing.assert_close(
        capped.float(), tfa.flash_attention_ref(q, k, v, softcap=30.0)
        .float(), **(TOL if dtype == torch.float32 else TOL_BF16))


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("window", [0, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernels_on_card(cuda, quant, window, dtype):
    """Dense and paged kernels on the same logical cache, one idle row
    (cur = -1: the kernel returns the mean of the swept V rows there)."""
    B, Hq, Hkv, D, ps = 3, 9, 3, 64, 16
    L = 32 * ps
    q, k, v, kpos, cur = _decode_inputs(B, Hq, Hkv, L, D, [400, -1, 77],
                                        fill=20, seed=3)
    q = q.to(dtype)
    ks = vs = None
    if quant:
        k, ks = _quant(k)
        v, vs = _quant(v)
    else:
        k, v = k.to(dtype), v.to(dtype)
    dev = [t.to(cuda) for t in (q, k, v, kpos, cur)]
    dks = None if ks is None else ks.to(cuda)
    dvs = None if vs is None else vs.to(cuda)
    got = tda.decode_attention_cuda(*dev, window=window, k_scale=dks,
                                    v_scale=dvs)
    ref = tda.decode_attention_ref(*dev, window=window, k_scale=dks,
                                   v_scale=dvs)
    tol = TOL if dtype == torch.float32 else TOL_BF16
    torch.testing.assert_close(got.float(), ref.float(), **tol)
    v_deq = dev[2][1].float() * (dvs[1][..., None] if quant else 1.0)
    mean_v = v_deq.mean(dim=1).repeat_interleave(Hq // Hkv, dim=0)
    torch.testing.assert_close(got[1].float(), mean_v.to(dtype).float(),
                               **tol)
    kp, vp, kpp, bt, scatter = _to_pool(k, v, kpos, ps, seed=4)
    pks = None if ks is None else scatter(ks, 1.0).to(cuda)
    pvs = None if vs is None else scatter(vs, 1.0).to(cuda)
    got_p = tda.paged_decode_attention_cuda(
        dev[0], kp.to(cuda), vp.to(cuda), kpp.to(cuda), bt.to(cuda), dev[4],
        window=window, k_scale=pks, v_scale=pvs)
    torch.testing.assert_close(got_p.float(), ref.float(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,L", [(3, 512), (1, 4096), (64, 512)])
def test_decode_kernel_lse_and_pieces_on_card(cuda, quant, dtype, B, L):
    """The merge pass's log-sum-exp (``return_lse``) against the plain
    version's, the output unchanged by it, and the kernel on two halves of
    the cache merged by ``merge_by_lse`` against the kernel on the whole
    (one split, several, the most); row 1 idle, row 0's keys all in the
    first half."""
    Hq, Hkv, D = 9, 3, 64
    cur = [min(300, L // 2 - 1)] + [-1] + [L - 90] * (B - 2)
    q, k, v, kpos, cur = _decode_inputs(B, Hq, Hkv, L, D, cur[:B], fill=50,
                                        seed=7)
    q = q.to(dtype)
    ks = vs = None
    if quant:
        k, ks = _quant(k)
        v, vs = _quant(v)
        ks, vs = ks.to(cuda), vs.to(cuda)
    else:
        k, v = k.to(dtype), v.to(dtype)
    q, k, v, kpos, cur = (t.to(cuda) for t in (q, k, v, kpos, cur))
    opt = dict(k_scale=ks, v_scale=vs)
    plain = tda.decode_attention_cuda(q, k, v, kpos, cur, **opt)
    got, lse = tda.decode_attention_cuda(q, k, v, kpos, cur, return_lse=True,
                                         **opt)
    assert torch.equal(got, plain)
    _, want = tda.decode_attention_ref(q, k, v, kpos, cur, return_lse=True,
                                       **opt)
    assert torch.equal(torch.isinf(lse), torch.isinf(want))
    torch.testing.assert_close(lse, want, atol=1e-3, rtol=1e-5)
    h = L // 2
    halves = [tda.decode_attention_cuda(
        q, k[:, :, s], v[:, :, s], kpos[:, s], cur, return_lse=True,
        k_scale=None if ks is None else ks[:, :, s],
        v_scale=None if vs is None else vs[:, :, s])
        for s in (slice(0, h), slice(h, L))]
    merged, _ = tda.merge_by_lse(torch.stack([o for o, _ in halves]),
                                 torch.stack([x for _, x in halves]))
    tol = TOL if dtype == torch.float32 else TOL_BF16
    torch.testing.assert_close(merged, plain.float(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("ps", [4, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_decode_at_small_pages(cuda, ps, dtype):
    """The soak presets' (page 4) and the adversary's (page 8) paged
    engines, 4 slots x 64, one idle row: the page size picks the kernel's
    page shift and the split plan's unit."""
    B, Hq, Hkv, D, L = 4, 9, 3, 64, 64
    q, k, v, kpos, cur = _decode_inputs(B, Hq, Hkv, L, D, [40, 7, -1, 62],
                                        fill=1, seed=5)
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    kp, vp, kpp, bt, _ = _to_pool(k, v, kpos, ps, seed=6)
    dev = [t.to(cuda) for t in (q, kp, vp, kpp, bt, cur)]
    got = tda.paged_decode_attention_cuda(*dev)
    ref = tda.paged_decode_attention_ref(*dev)
    torch.testing.assert_close(got.float(), ref.float(),
                               **(TOL if dtype == torch.float32
                                  else TOL_BF16))


@pytest.mark.cuda
def test_decode_kernel_reads_strided_cache(cuda):
    """The serving layout: (B, L, Hkv, D) cache rows passed as a transposed
    (B, Hkv, L, D) view, no copy."""
    B, Hq, Hkv, D, L = 2, 8, 2, 64, 96
    rng = np.random.default_rng(7)
    q = _normal(rng, (B, Hq, D)).to(cuda)
    k = _normal(rng, (B, L, Hkv, D)).to(cuda)
    v = _normal(rng, (B, L, Hkv, D)).to(cuda)
    kpos = torch.arange(L, dtype=torch.int32, device=cuda)[None].repeat(B, 1)
    cur = torch.tensor([50, 95], dtype=torch.int32, device=cuda)
    kt, vt = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)
    got = tda.decode_attention_cuda(q, kt, vt, kpos, cur)
    ref = tda.decode_attention_ref(q, kt.contiguous(), vt.contiguous(), kpos,
                                   cur)
    torch.testing.assert_close(got, ref, **TOL)


# ---------------------------------------------------------------------------
# Flash prefill on the tensor cores (bf16) at the serving path's shapes
# ---------------------------------------------------------------------------

def _flash_bf16(cuda, shape_q, shape_kv, seed):
    rng = np.random.default_rng(seed)
    return tuple(_normal(rng, s).to(cuda, torch.bfloat16)
                 for s in (shape_q, shape_kv, shape_kv))


@pytest.mark.cuda
@pytest.mark.parametrize("s", [64, 128, 1024, 300, 1000])
def test_flash_bf16_serving_buckets_on_card(cuda, s):
    """smollm-135m's prefill (B 1, Hq 9, Hkv 3, D 64) at the engine's
    power-of-two buckets and at ragged lengths; the output is written
    (B, S, Hq, D)-major."""
    q, k, v = _flash_bf16(cuda, (1, 9, s, 64), (1, 3, s, 64), seed=s)
    n = launches["flash_attention"]
    got = tfa.flash_attention_cuda(q, k, v)
    assert launches["flash_attention"] == n + 1
    assert got.dtype == torch.bfloat16 and got.shape == (1, 9, s, 64)
    assert got.permute(0, 2, 1, 3).is_contiguous()
    torch.testing.assert_close(got.float(),
                               tfa.flash_attention_ref(q, k, v).float(),
                               **TOL_BF16)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (100, 0.0),
                                            (0, 30.0), (100, 30.0)])
def test_flash_bf16_head_dims_window_softcap_on_card(cuda, d, window,
                                                     softcap):
    """Every head dim; a window of 100 starts inside a 64-key tile, so rows
    of a query tile meet a first key tile with no valid key; the tanh
    softcap in bf16."""
    q, k, v = _flash_bf16(cuda, (2, 4, 300, d), (2, 2, 300, d), seed=d)
    got = tfa.flash_attention_cuda(q, k, v, window=window, softcap=softcap)
    ref = tfa.flash_attention_ref(q, k, v, window=window, softcap=softcap)
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), ref.float(), **TOL_BF16)


@pytest.mark.cuda
def test_flash_bf16_reads_the_layers_views_and_refuses_misaligned(cuda):
    """q/k/v as strided views of one (B, S, (Hq + 2 Hkv) D) projection, as
    the layer passes them; a view whose rows do not start on 16 bytes is
    refused (the bf16 kernel copies rows by cp.async), and nothing
    launches."""
    B, S, Hq, Hkv, D = 1, 200, 9, 3, 64
    rng = np.random.default_rng(3)
    qkv = _normal(rng, (B, S, (Hq + 2 * Hkv) * D + 8)).to(cuda,
                                                           torch.bfloat16)

    def views(x):
        q = x[..., :Hq * D].reshape(B, S, Hq, D).permute(0, 2, 1, 3)
        k = x[..., Hq * D:(Hq + Hkv) * D].reshape(B, S, Hkv, D)
        v = x[..., (Hq + Hkv) * D:(Hq + 2 * Hkv) * D].reshape(B, S, Hkv, D)
        return q, k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)

    q, k, v = views(qkv)
    torch.testing.assert_close(
        tfa.flash_attention_cuda(q, k, v).float(),
        tfa.flash_attention_ref(q, k, v).float(), **TOL_BF16)
    n = launches["flash_attention"]
    with pytest.raises(ValueError, match="16-byte aligned"):
        tfa.flash_attention_cuda(*views(qkv[..., 4:]))      # 8 bytes off
    assert launches["flash_attention"] == n
    got32 = tfa.flash_attention_cuda(*(t.float() for t in views(qkv)))
    torch.testing.assert_close(
        got32, tfa.flash_attention_ref(*(t.float() for t in views(qkv))),
        **TOL)


# ---------------------------------------------------------------------------
# Split-K decode: many splits, some, one
# ---------------------------------------------------------------------------

def _split_decode_inputs(cuda, B, L, dtype, quant, seed):
    """Row 0's cur far below L (most splits hold no valid key), row 1 idle
    (cur = -1) where B > 1, the rest random; empty (-1) slots past each
    row's fill."""
    rng = np.random.default_rng(seed)
    cur = rng.integers(64, L - 1, size=B)
    cur[0] = 40
    if B > 1:
        cur[1] = -1
    fill = np.minimum(L, np.maximum(cur, 0) + 1 + rng.integers(0, 64, B))
    kpos = np.where(np.arange(L)[None] < fill[:, None], np.arange(L)[None],
                    -1).astype(np.int32)
    q, k, v = (_normal(rng, s) for s in ((B, 9, 64), (B, 3, L, 64),
                                         (B, 3, L, 64)))
    ks = vs = None
    if quant:
        k, ks = _quant(k)
        v, vs = _quant(v)
    else:
        k, v = k.to(dtype), v.to(dtype)
    dev = lambda t: None if t is None else t.to(cuda)  # noqa: E731
    return (dev(q.to(dtype)), dev(k), dev(v), dev(torch.from_numpy(kpos)),
            dev(torch.from_numpy(cur.astype(np.int32))), dev(ks), dev(vs))


@pytest.mark.cuda
@pytest.mark.parametrize("B,n_split", [(1, 32), (8, 11), (64, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_split_counts_on_card(cuda, B, n_split, dtype):
    """smollm-135m's decode (Hq 9, Hkv 3, D 64) at L 2048, dense and paged
    (page 16), where the plan gives 32, 11 and 1 splits on the H100; the
    wrapper counts one launch for its split and merge passes and records
    the plan it launched."""
    from repro_torch.kernels import _lib
    from repro_torch.kernels.decode_attention import _sm_count, split_plan
    q, k, v, kpos, cur, _, _ = _split_decode_inputs(cuda, B, 2048, dtype,
                                                    False, seed=B)
    h100 = _sm_count(cuda.index or 0) == 132
    if h100:
        assert split_plan(B * 3, 2048, 132)[0] == n_split
    tol = TOL if dtype == torch.float32 else TOL_BF16
    ref = tda.decode_attention_ref(q, k, v, kpos, cur)
    n = launches["decode_attention"]
    got = tda.decode_attention_cuda(q, k, v, kpos, cur)
    assert launches["decode_attention"] == n + 1
    if h100:
        assert _lib.last_plan["decode_attention"][0] == n_split
    torch.testing.assert_close(got.float(), ref.float(), **tol)
    kp, vp, kpp, bt, _ = _to_pool(k.cpu(), v.cpu(), kpos.cpu(), 16, seed=B)
    n = launches["paged_decode_attention"]
    got = tda.paged_decode_attention_cuda(q, kp.to(cuda), vp.to(cuda),
                                          kpp.to(cuda), bt.to(cuda), cur)
    assert launches["paged_decode_attention"] == n + 1
    if h100:
        assert _lib.last_plan["paged_decode_attention"][0] == n_split
    torch.testing.assert_close(got.float(), ref.float(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ragged_L2000", "window128", "int8"])
def test_decode_split_cases_on_card(cuda, case):
    """B 8 (11 splits) with a ragged L, a window and int8 K/V; the idle row
    is the mean of its (dequantized) V rows."""
    L = 2000 if case == "ragged_L2000" else 2048
    quant = case == "int8"
    window = 128 if case == "window128" else 0
    q, k, v, kpos, cur, ks, vs = _split_decode_inputs(
        cuda, 8, L, torch.bfloat16, quant, seed=len(case))
    ref = tda.decode_attention_ref(q, k, v, kpos, cur, window=window,
                                   k_scale=ks, v_scale=vs)
    got = tda.decode_attention_cuda(q, k, v, kpos, cur, window=window,
                                    k_scale=ks, v_scale=vs)
    torch.testing.assert_close(got.float(), ref.float(), **TOL_BF16)
    v_deq = v[1].float() * (vs[1][..., None] if quant else 1.0)
    torch.testing.assert_close(
        got[1].float(), v_deq.mean(dim=1).repeat_interleave(3, dim=0)
        .bfloat16().float(), **TOL_BF16)
    kp, vp, kpp, bt, scatter = _to_pool(k.cpu(), v.cpu(), kpos.cpu(), 16,
                                        seed=3)
    got = tda.paged_decode_attention_cuda(
        q, kp.to(cuda), vp.to(cuda), kpp.to(cuda), bt.to(cuda), cur,
        window=window,
        k_scale=None if ks is None else scatter(ks.cpu(), 1.0).to(cuda),
        v_scale=None if vs is None else scatter(vs.cpu(), 1.0).to(cuda))
    torch.testing.assert_close(got.float(), ref.float(), **TOL_BF16)


@pytest.mark.cuda
@pytest.mark.parametrize("hq,hkv,d", [(8, 1, 32), (8, 1, 128), (6, 2, 128),
                                      (2, 2, 32)] + [
    (g * 2, 2, d) for d in (96, 112, 256) for g in (1, 2, 4, 8)])
@pytest.mark.parametrize("kind", ["fp32", "bf16", "int8"])
def test_decode_split_head_dims_and_groups_on_card(cuda, hq, hkv, d, kind):
    """The other head dims (a row is 2 to 32 lanes: fp32 D 128 takes a
    whole warp a row, int8 D 32 two lanes; at D 96 and 112 a row is a power
    of two of lanes, some idle: bf16 D 96 is 12 slices over 16 lanes; fp32
    D 256 is 2 slices a lane) and group sizes (g 1, 2 and 4 in the 4-head
    register layout, g 6 and 8 in the 8-head one; at G 8 and D 256 the
    warps merge in two rounds), dense and paged, with an idle row and a row
    whose cur is far below L."""
    B, L, ps = 3, 640, 16
    dtype = torch.float32 if kind == "fp32" else torch.bfloat16
    q, k, v, kpos, cur = _decode_inputs(B, hq, hkv, L, d, [600, -1, 30],
                                        fill=25, seed=d + hq)
    q = q.to(dtype)
    ks = vs = None
    if kind == "int8":
        k, ks = _quant(k)
        v, vs = _quant(v)
    else:
        k, v = k.to(dtype), v.to(dtype)
    dev = [t.to(cuda) for t in (q, k, v, kpos, cur)]
    opt = {} if ks is None else dict(k_scale=ks.to(cuda),
                                     v_scale=vs.to(cuda))
    tol = TOL if dtype == torch.float32 else TOL_BF16
    ref = tda.decode_attention_ref(*dev, **opt)
    torch.testing.assert_close(tda.decode_attention_cuda(*dev, **opt).float(),
                               ref.float(), **tol)
    kp, vp, kpp, bt, scatter = _to_pool(k, v, kpos, ps, seed=d)
    popt = {} if ks is None else dict(k_scale=scatter(ks, 1.0).to(cuda),
                                      v_scale=scatter(vs, 1.0).to(cuda))
    got = tda.paged_decode_attention_cuda(
        dev[0], kp.to(cuda), vp.to(cuda), kpp.to(cuda), bt.to(cuda), dev[4],
        **popt)
    torch.testing.assert_close(got.float(), ref.float(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True])
def test_decode_no_valid_key_with_cur_set_on_card(cuda, quant):
    """Rows with cur >= 0 and still no valid key (an empty cache row; keys
    all older than the window) take the merge block's own mean-of-V pass;
    an idle slot (cur = -1) the split blocks' row sums; the other rows the
    normal merge."""
    B, L = 4, 1024
    q, k, v, kpos, cur, ks, vs = _split_decode_inputs(
        cuda, B, L, torch.float32, quant, seed=21)
    kpos[2] = -1                                 # nothing cached
    cur[2] = 500
    kpos[3] = torch.where(kpos[3] <= 50, kpos[3], -1)
    cur[3] = 900                                 # keys 0..50 out of window
    opt = dict(window=128, k_scale=ks, v_scale=vs)
    got = tda.decode_attention_cuda(q, k, v, kpos, cur, **opt)
    ref = tda.decode_attention_ref(q, k, v, kpos, cur, **opt)
    torch.testing.assert_close(got, ref, **TOL)
    v_deq = v.float() * (vs[..., None] if quant else 1.0)
    for row in (1, 2, 3):
        torch.testing.assert_close(
            got[row], v_deq[row].mean(dim=1).repeat_interleave(3, dim=0),
            **TOL)
    kp, vp, kpp, bt, scatter = _to_pool(k.cpu(), v.cpu(), kpos.cpu(), 16,
                                        seed=5)
    got = tda.paged_decode_attention_cuda(
        q, kp.to(cuda), vp.to(cuda), kpp.to(cuda), bt.to(cuda), cur,
        window=128,
        k_scale=None if ks is None else scatter(ks.cpu(), 1.0).to(cuda),
        v_scale=None if vs is None else scatter(vs.cpu(), 1.0).to(cuda))
    torch.testing.assert_close(got, ref, **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True])
def test_paged_split_null_and_repeated_pages_on_card(cuda, quant):
    """Block tables with unused entries on the null page (page 0, kpos -1)
    and a page named twice in one row; an idle row averages every V row its
    table names, null and repeated pages included."""
    B, Hq, Hkv, D, ps, nb, P = 4, 9, 3, 64, 16, 24, 100
    rng = np.random.default_rng(11)
    kp, vp = _normal(rng, (P, Hkv, ps, D)), _normal(rng, (P, Hkv, ps, D))
    ksp = vsp = None
    if quant:
        kp, ksp = _quant(kp)
        vp, vsp = _quant(vp)
        ksp[0] = vsp[0] = 1.0
    else:
        kp, vp = kp.bfloat16(), vp.bfloat16()
    kp[0] = 0
    vp[0] = 0
    kpp = (torch.arange(P * ps, dtype=torch.int32).reshape(P, ps)
           % (nb * ps))
    kpp[0] = -1
    bt = torch.from_numpy(rng.permutation(np.arange(1, P))[:B * nb]
                          .reshape(B, nb).astype(np.int32))
    bt[0, 10:] = 0
    bt[1, 7:] = 0
    bt[2, 5] = bt[2, 3]
    cur = torch.tensor([200, -1, nb * ps - 1, 60], dtype=torch.int32)
    q = _normal(rng, (B, Hq, D)).bfloat16()
    args = [t.to(cuda) for t in (q, kp, vp, kpp, bt, cur)]
    opt = {} if not quant else dict(k_scale=ksp.to(cuda),
                                    v_scale=vsp.to(cuda))
    got = tda.paged_decode_attention_cuda(*args, **opt)
    ref = tda.paged_decode_attention_ref(*args, **opt)
    torch.testing.assert_close(got.float(), ref.float(), **TOL_BF16)


# ---------------------------------------------------------------------------
# The head dims of phi3-mini (96), zamba2 (112) and the gemma families (256)
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [96, 112, 256])
@pytest.mark.parametrize("s", [64, 300, 1024])
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (100, 0.0),
                                            (0, 30.0), (100, 30.0)])
def test_flash_new_head_dims_on_card(cuda, dtype, d, s, window, softcap):
    """bf16 (mma.sync, rows padded to 128/256 elements, D 256 on 32-key
    tiles) and fp32 (3xTF32) at the new head dims; a window of 100 leaves
    rows of a query tile with no valid key in their first key tile."""
    rng = np.random.default_rng(s + d)
    q, k, v = (_normal(rng, shp).to(cuda, dtype) for shp in
               ((2, 4, s, d), (2, 2, s, d), (2, 2, s, d)))
    n = launches["flash_attention"]
    got = tfa.flash_attention_cuda(q, k, v, window=window, softcap=softcap)
    assert launches["flash_attention"] == n + 1
    ref = tfa.flash_attention_ref(q, k, v, window=window, softcap=softcap)
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), ref.float(),
                               **(TOL if dtype == torch.float32
                                  else TOL_BF16))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_head_dims_outside_the_set_are_padded(cuda, dtype):
    """A head dim the kernels are not built for (80, a multiple of 8 that
    the reference takes) runs zero-padded to 96: flash, decode and paged
    decode each launch their kernel once and agree with the plain version
    at D 80, dense and paged decode also with an int8 KV cache. D 84 (not a
    multiple of 8) is still refused, naming the largest width and the set,
    and nothing launches."""
    assert tda.HEAD_DIMS == (32, 64, 96, 112, 128, 256, 384, 512)
    rng = np.random.default_rng(0)
    tol = TOL if dtype == torch.float32 else TOL_BF16
    q, k, v = (_normal(rng, shp).to(cuda, dtype) for shp in
               ((2, 4, 300, 80), (2, 2, 300, 80), (2, 2, 300, 80)))
    n = launches["flash_attention"]
    got = tfa.flash_attention_cuda(q, k, v, window=64, softcap=30.0)
    assert launches["flash_attention"] == n + 1
    assert got.shape == (2, 4, 300, 80)
    torch.testing.assert_close(got.float(), tfa.flash_attention_ref(
        q, k, v, window=64, softcap=30.0).float(), **tol)

    B, L, ps = 3, 256, 16
    qd, kd, vd, kpos, cur = _decode_inputs(B, 4, 2, L, 80, [255, 100, -1],
                                           40, 1)
    qd, kd, vd = (t.to(cuda, dtype) for t in (qd, kd, vd))
    kpos, cur = kpos.to(cuda), cur.to(cuda)
    want = tda.decode_attention_ref(qd, kd, vd, kpos, cur)
    n = launches["decode_attention"]
    got = tda.decode_attention_cuda(qd, kd, vd, kpos, cur)
    assert launches["decode_attention"] == n + 1
    assert got.shape == (B, 4, 80)
    torch.testing.assert_close(got.float(), want.float(), **tol)
    kp, vp, pp, bt, _ = _to_pool(kd.cpu(), vd.cpu(), kpos.cpu(), ps, 2)
    kp, vp, pp, bt = (t.to(cuda) for t in (kp, vp, pp, bt))
    n = launches["paged_decode_attention"]
    got = tda.paged_decode_attention_cuda(qd, kp, vp, pp, bt, cur)
    assert launches["paged_decode_attention"] == n + 1
    torch.testing.assert_close(got.float(), want.float(), **tol)

    # the int8 KV cache at D 80: int8 k/v padded, their scales as they are
    (ki, ks), (vi, vs) = _quant(kd.float().cpu()), _quant(vd.float().cpu())
    kip, vip, pp, bt, scatter = _to_pool(ki, vi, kpos.cpu(), ps, 3)
    quant = dict(k_scale=ks.to(cuda), v_scale=vs.to(cuda))
    ki, vi = ki.to(cuda), vi.to(cuda)
    want = tda.decode_attention_ref(qd, ki, vi, kpos, cur, **quant)
    n = launches["decode_attention"]
    got = tda.decode_attention_cuda(qd, ki, vi, kpos, cur, **quant)
    assert launches["decode_attention"] == n + 1
    assert got.shape == (B, 4, 80)
    torch.testing.assert_close(got.float(), want.float(), **tol)
    n = launches["paged_decode_attention"]
    got = tda.paged_decode_attention_cuda(
        qd, kip.to(cuda), vip.to(cuda), pp.to(cuda), bt.to(cuda), cur,
        k_scale=scatter(ks, 1.0).to(cuda), v_scale=scatter(vs, 1.0).to(cuda))
    assert launches["paged_decode_attention"] == n + 1
    torch.testing.assert_close(got.float(), want.float(), **tol)

    q, k, v = (_normal(rng, shp).to(cuda, dtype) for shp in
               ((1, 2, 64, 84), (1, 1, 64, 84), (1, 1, 64, 84)))
    before = dict(launches)
    refused = r"up to 512 \(built for \(32, 64, 96, 112, 128, 256, 384, 512\)"
    with pytest.raises(ValueError, match=refused):
        tfa.flash_attention_cuda(q, k, v)
    kpos = torch.arange(64, dtype=torch.int32, device=cuda)[None]
    cur = torch.tensor([63], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match=refused):
        tda.decode_attention_cuda(q[:, :, 0], k, v, kpos, cur)
    assert dict(launches) == before


def _decode_both(cuda, hq, hkv, d, kind, B=3, L=640, ps=16, seed=0):
    """The dense and paged decode kernels against the plain version at
    (hq, hkv, d) in fp32, bf16 or int8 (bf16 q), with a long row, an idle
    row and a short one; each launches once, and the dense kernel's
    log-sum-exp agrees. Returns the dense kernel's split plan."""
    dtype = torch.float32 if kind == "fp32" else torch.bfloat16
    q, k, v, kpos, cur = _decode_inputs(B, hq, hkv, L, d, [600, -1, 30],
                                        fill=25, seed=seed)
    q = q.to(dtype)
    ks = vs = None
    if kind == "int8":
        k, ks = _quant(k)
        v, vs = _quant(v)
    else:
        k, v = k.to(dtype), v.to(dtype)
    dev = [t.to(cuda) for t in (q, k, v, kpos, cur)]
    opt = {} if ks is None else dict(k_scale=ks.to(cuda),
                                     v_scale=vs.to(cuda))
    tol = TOL if dtype == torch.float32 else TOL_BF16
    ref, ref_l = tda.decode_attention_ref(*dev, **opt, return_lse=True)
    n = launches["decode_attention"]
    got, lse = tda.decode_attention_cuda(*dev, **opt, return_lse=True)
    assert launches["decode_attention"] == n + 1
    plan = _lib.last_plan["decode_attention"]
    assert got.shape == (B, hq, d)
    torch.testing.assert_close(got.float(), ref.float(), **tol)
    fin = ~torch.isinf(ref_l)
    assert torch.equal(torch.isinf(lse), ~fin)
    torch.testing.assert_close(lse[fin], ref_l[fin], atol=1e-3, rtol=1e-5)
    kp, vp, kpp, bt, scatter = _to_pool(k, v, kpos, ps, seed=d)
    popt = {} if ks is None else dict(k_scale=scatter(ks, 1.0).to(cuda),
                                      v_scale=scatter(vs, 1.0).to(cuda))
    n = launches["paged_decode_attention"]
    got = tda.paged_decode_attention_cuda(
        dev[0], kp.to(cuda), vp.to(cuda), kpp.to(cuda), bt.to(cuda), dev[4],
        **popt)
    assert launches["paged_decode_attention"] == n + 1
    torch.testing.assert_close(got.float(), ref.float(), **tol)
    return plan


@pytest.mark.cuda
@pytest.mark.parametrize("hq,hkv,d", [(64, 4, 128), (32, 2, 64), (16, 1, 32),
                                      (71, 1, 64), (48, 1, 128),
                                      (9, 1, 112), (128, 8, 256)])
@pytest.mark.parametrize("kind", ["fp32", "bf16", "int8"])
def test_decode_any_group_on_card(cuda, hq, hkv, d, kind):
    """Groups past the 8 heads a block holds (Qwen3-235B's 16,
    Llama-3.1-405B's 16 at D 128 and at D 256, MQA's 48 and 71, 9): fp32
    runs in chunks of at most 8 (9 as 5 + 4), split_plan covering the
    chunked grid (B * Hkv * chunks blocks); bf16 and int8 K/V take the
    group kernel, split_plan covering its slices. Every head agrees with
    the plain version, dense, paged and in the log-sum-exp."""
    n_group = launches["decode_group"]
    plan = _decode_both(cuda, hq, hkv, d, kind, seed=hq + d)
    heads, n = tda.head_chunks(hq // hkv, d)
    assert n > 1
    sms = tda._sm_count(torch.cuda.current_device())
    dtype = torch.float32 if kind == "fp32" else torch.bfloat16
    assert plan == tda.launch_plan(3, hkv, hq // hkv, d, dtype, 640,
                                   sms)[:2]
    if kind == "fp32":
        assert plan == tda.split_plan(3 * hkv * n, 640, sms, unit=16)
    assert launches["decode_group"] == n_group + (0 if kind == "fp32"
                                                  else 2)


# chip_smoke.py's WIDE_GROUPS (Qwen3-235B-A22B, Llama-3.1-405B, Falcon-7B's
# and StarCoder's MQA) and a group of 16 at head dim 512
GROUP_SHAPES = [(64, 4, 128), (128, 8, 128), (71, 1, 64), (48, 1, 128),
                (16, 1, 512)]


def _group_model(q, k, v, kpos, cur, split_rows, plan, window, ks, vs):
    """The pass model of the group kernel, merged by the plain merge."""
    g = q.shape[1] // k.shape[1]
    acc, m, l = tda.decode_group_partials_ref(
        q, k, v, kpos, cur, split_rows, plan, window=window, k_scale=ks,
        v_scale=vs)
    vf = v.float() * (1.0 if vs is None else vs[..., None])
    return tda.merge_partials_ref(acc, m, l,
                                  vf.mean(2).repeat_interleave(g, dim=1))


@pytest.mark.cuda
@pytest.mark.parametrize("hq,hkv,d", GROUP_SHAPES)
@pytest.mark.parametrize("kind", ["bf16", "int8"])
@pytest.mark.parametrize("window", [0, 128])
def test_decode_group_kernel_on_card(cuda, hq, hkv, d, kind, window):
    """The group kernel (bf16 q, bf16 or int8 K/V) against its pass model
    (``decode_group_partials_ref`` at the launch's split rows and plan)
    and the plain version: dense with the log-sum-exp, and paged at pages
    of 4, 8 and 16; rows long, idle (the mean of V), short, and with cur
    set but no key cached (the merge's own mean of V)."""
    B, L = 4, 640
    q, k, v, kpos, cur = _decode_inputs(B, hq, hkv, L, d, [600, -1, 30, 300],
                                        fill=25, seed=hq + d + window)
    kpos[3] = -1
    q = q.to(torch.bfloat16)
    ks = vs = None
    if kind == "int8":
        k, ks = _quant(k)
        v, vs = _quant(v)
    else:
        k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
    dev = [t.to(cuda) for t in (q, k, v, kpos, cur)]
    ks_d, vs_d = (None, None) if ks is None else (ks.to(cuda), vs.to(cuda))
    opt = dict(window=window, k_scale=ks_d, v_scale=vs_d)
    ref, ref_l = tda.decode_attention_ref(*dev, **opt, return_lse=True)
    n = launches["decode_group"]
    got, lse = tda.decode_attention_cuda(*dev, **opt, return_lse=True)
    assert launches["decode_group"] == n + 1
    plan = _lib.last_plan["decode_group"]
    rows = _lib.last_plan["decode_attention"][1]
    assert plan == tda.decode_group_plan(hq // hkv, d)
    model = _group_model(*dev, rows, plan, window, ks_d, vs_d)
    torch.testing.assert_close(got.float(), ref.float(), **TOL_BF16)
    torch.testing.assert_close(got.float(), model, **TOL_BF16)
    fin = ~torch.isinf(ref_l)
    assert torch.equal(torch.isinf(lse), ~fin) and not fin[1:4:2].any()
    torch.testing.assert_close(lse[fin], ref_l[fin], atol=1e-3, rtol=1e-5)
    for ps in (4, 8, 16):
        kp, vp, kpp, bt, scatter = _to_pool(k, v, kpos, ps, seed=d + ps)
        popt = dict(window=window)
        if ks is not None:
            popt.update(k_scale=scatter(ks, 1.0).to(cuda),
                        v_scale=scatter(vs, 1.0).to(cuda))
        n = launches["decode_group"]
        got = tda.paged_decode_attention_cuda(
            dev[0], kp.to(cuda), vp.to(cuda), kpp.to(cuda), bt.to(cuda),
            dev[4], **popt)
        assert launches["decode_group"] == n + 1
        prow = _lib.last_plan["paged_decode_attention"][1]
        torch.testing.assert_close(got.float(), ref.float(), **TOL_BF16)
        if prow != rows:
            model = _group_model(*dev, prow, plan, window, ks_d, vs_d)
        torch.testing.assert_close(got.float(), model, **TOL_BF16)


@pytest.mark.cuda
@pytest.mark.parametrize("hq,hkv,d", [(8, 2, 264), (8, 2, 320), (8, 2, 384),
                                      (8, 2, 392), (8, 2, 512), (4, 4, 504),
                                      (16, 1, 264), (12, 1, 512)])
@pytest.mark.parametrize("kind", ["fp32", "bf16", "int8"])
def test_decode_head_dims_past_256_on_card(cuda, hq, hkv, d, kind):
    """Head dims from 264 to 512 run on the 384 and 512 builds in place
    (no padded copy: q, k and v reach the kernel as they are), a lane
    owning only the slices below the true width; a group past 4 there runs
    in chunks of 4."""
    calls = []
    real = tda._launch

    def seen(name, q, k, v, *args, **kw):
        calls.append((q.shape[-1], k.shape[-1], v.shape[-1]))
        return real(name, q, k, v, *args, **kw)

    tda._launch = seen
    try:
        _decode_both(cuda, hq, hkv, d, kind, seed=d + hq)
    finally:
        tda._launch = real
    assert calls == [(d, d, d)] * 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [264, 320, 384, 392, 512])
@pytest.mark.parametrize("s", [64, 300])
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (100, 30.0)])
def test_flash_head_dims_past_256_on_card(cuda, dtype, d, s, window,
                                          softcap):
    """bf16 (two halves of O's columns, one warp set) and fp32 (32-query
    tiles, O in D / 128 parts) at the widths past 256, read in place: one
    launch, the plain version's output, only the true width written."""
    rng = np.random.default_rng(s + d)
    q, k, v = (_normal(rng, shp).to(cuda, dtype) for shp in
               ((2, 4, s, d), (2, 2, s, d), (2, 2, s, d)))
    n = launches["flash_attention"]
    got = tfa.flash_attention_cuda(q, k, v, window=window, softcap=softcap)
    assert launches["flash_attention"] == n + 1
    assert got.shape == (2, 4, s, d)
    ref = tfa.flash_attention_ref(q, k, v, window=window, softcap=softcap)
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), ref.float(),
                               **(TOL if dtype == torch.float32
                                  else TOL_BF16))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [520, 516, 1024])
def test_head_dims_past_512_refused_on_card(cuda, d):
    """Past the largest width, or off a multiple of 8, each wrapper
    raises naming 512, and nothing launches."""
    q, k, v = (torch.zeros(shp, device=cuda) for shp in
               ((1, 2, 16, d), (1, 1, 16, d), (1, 1, 16, d)))
    kpos = torch.arange(16, dtype=torch.int32, device=cuda)[None]
    cur = torch.tensor([15], dtype=torch.int32, device=cuda)
    before = dict(launches)
    with pytest.raises(ValueError, match="up to 512"):
        tfa.flash_attention_cuda(q, k, v)
    with pytest.raises(ValueError, match="up to 512"):
        tda.decode_attention_cuda(q[:, :, 0], k, v, kpos, cur)
    with pytest.raises(ValueError, match="up to 512"):
        tda.paged_decode_attention_cuda(
            q[:, :, 0], k, v, kpos, torch.zeros((1, 1), dtype=torch.int32,
                                                device=cuda), cur)
    assert dict(launches) == before


@pytest.mark.cuda
def test_kernel_force_kernel_is_the_default_on_card(cuda):
    """kernel_force "kernel" on the card runs the kernels as "" does: the
    same logits bit for bit and the same launches."""
    import dataclasses
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import Model
    cfg = reduced(get_config("smollm-135m")).replace(dtype="float32")
    params = Model(cfg, device=cuda).init(
        torch.Generator(device=cuda).manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (2, 24), device=cuda,
                         generator=torch.Generator(device=cuda).manual_seed(1))
    out = []
    for force in ("", "kernel"):
        model = Model(cfg.replace(geometry=dataclasses.replace(
            cfg.geometry, kernel_force=force)), device=cuda)
        before = dict(launches)
        with torch.no_grad():
            h, caches = model.prefill(params, {"tokens": toks}, 32)
            lg, _ = model.decode(params, caches, toks[:, -1:],
                                 torch.full((2,), 24, dtype=torch.int32,
                                            device=cuda))
        torch.cuda.synchronize()
        out.append((model.logits(params, h), lg,
                    {k: launches[k] - before[k] for k in launches}))
    assert torch.equal(out[0][0], out[1][0])
    assert torch.equal(out[0][1], out[1][1])
    assert out[0][2] == out[1][2]
    assert out[1][2]["flash_attention"] == out[1][2]["decode_attention"] \
        == cfg.n_layers


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_gateway_configure_frees_its_warm_up(cuda, paged):
    """``Reconfigurator.configure`` warms the decode program up on zeros of
    the example's shapes: a zero copy of every weight and of the whole KV
    cache, for a moment, and the capture of a graph on them, dropped with
    them. Once the gateway stands, the card holds only the engine's own
    weights (the masters, and its bf16 copies of the matmul weights) and
    caches, plus a little slack (the warm-up's logits and the
    allocator's rounding; cuBLAS's workspaces, which the allocator keeps,
    one for each stream, are taken before the baseline: the current
    stream's and the capture stream's)."""
    from repro_torch.configs import get_config
    from repro_torch.core import ClusterSpec, Hypervisor
    from repro_torch.core.graphs import capture_stream
    from repro_torch.models import Model
    from repro_torch.runtime import ServingGateway
    cfg = get_config("smollm-135m").replace(n_layers=4)
    model = Model(cfg)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    for dt in (torch.float32, torch.bfloat16):
        x = torch.ones((2, 8, 8), dtype=dt, device=cuda)
        torch.einsum("bij,jk->bik", x, x[0])
        del x
    capture_stream(cuda)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    hv = Hypervisor(ClusterSpec(n_nodes=1, devices_per_node=1))
    gw = ServingGateway(hv, model, params, n_slots=4, max_len=512,
                        paged=paged)
    torch.cuda.synchronize()
    cache_bytes = sum(t.numel() * t.element_size()
                      for st in gw.engine.caches
                      for f in ((st,) if isinstance(st, dict) else st)
                      for t in f.values())
    held = cache_bytes + gw.engine.cast_once_bytes
    grown = torch.cuda.memory_allocated() - base
    assert held <= grown <= held + (16 << 20), (grown, held)
    gw.close()


@pytest.mark.cuda
def test_model_off_the_card_refused_by_a_card_hypervisor(cuda):
    """A CPU model under the default (card) hypervisor: the program would
    copy the weights and caches to the card on every step and decode into
    the copies, so the gateway and the fleet refuse it; a model on
    ``cuda:0`` matches a hypervisor on ``cuda``."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.core import ClusterSpec, Hypervisor
    from repro_torch.models import Model
    from repro_torch.runtime import GatewayFleet, ServingGateway
    cfg = reduced(get_config("smollm-135m")).replace(dtype="float32")
    model = Model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    for front in (ServingGateway, GatewayFleet):
        hv = Hypervisor(ClusterSpec(n_nodes=1, devices_per_node=1))
        with pytest.raises(ValueError, match="Hypervisor"):
            front(hv, model, params, n_slots=2, max_len=64)
    card = Model(cfg, device="cuda:0")
    gw = ServingGateway(Hypervisor(ClusterSpec(n_nodes=1,
                                               devices_per_node=1)),
                        card, card.init(torch.Generator(device=cuda)
                                        .manual_seed(0)),
                        n_slots=2, max_len=64)
    gw.close()


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "gemma3-1b",
                                  "gemma2-9b"])
def test_family_layers_on_card(cuda, arch):
    """Full-width layers of each dense family (gemma3: its 6-layer period,
    5 local and 1 global; the others 2 layers, gemma2's a local/global
    pair), fp32, seeded init: a 600-token prefill (past gemma3's 512-token
    window) and 3 decode steps, kernel path against the plain path
    (``kernel_force="ref"``) at the model phases' tolerance."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    cfg = get_config(arch)
    cfg = cfg.replace(n_layers=len(cfg.pattern) if len(cfg.pattern) > 2
                      else 2, dtype="float32")
    plain = cfg.replace(geometry=dataclasses.replace(cfg.geometry,
                                                     kernel_force="ref"))
    params = Model(cfg).init(torch.Generator(device=cuda).manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 600)).astype(np.int32)).to(cuda)
    out = []
    n = dict(launches)
    for c in (cfg, plain):
        m = Model(c)
        h, caches = m.prefill(params, {"tokens": toks}, 640)
        logs = [m.logits(params, h[:, -1:])[:, 0]]
        nxt = logs[0].argmax(-1).to(torch.int32)
        pos = torch.full((2,), 600, dtype=torch.int32, device=cuda)
        for _ in range(3):
            lg, caches = m.decode(params, caches, nxt[:, None], pos)
            logs.append(lg[:, 0])
            nxt, pos = lg[:, 0].argmax(-1).to(torch.int32), pos + 1
        out.append(torch.stack(logs))
        if c is cfg:
            assert launches["flash_attention"] - n["flash_attention"] \
                == cfg.n_layers
            assert launches["decode_attention"] - n["decode_attention"] \
                == (0 if cfg.attn_softcap else 3 * cfg.n_layers)
    assert torch.isfinite(out[0]).all()
    torch.testing.assert_close(out[0], out[1], atol=1e-3, rtol=1e-3)


# ---------------------------------------------------------------------------
# Streaming matmul (csrc/stream_matmul.cu) and the RC2F dataplane on the card
# ---------------------------------------------------------------------------

MM_TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}


def _mm_close(got, ref, dtype, k):
    """tests/test_kernels.py's matmul tolerance: atol tol*sqrt(k), rtol tol
    (summation order; bf16 rounds the output once)."""
    tol = MM_TOL[dtype]
    torch.testing.assert_close(got.float(), ref.float(), atol=tol * k ** 0.5,
                               rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,s,G", [
    (torch.float32, 16, 100_000), (torch.float32, 32, 100_000),
    (torch.bfloat16, 32, 100_000), (torch.bfloat16, 16, 7),
    (torch.float32, 24, 1000), (torch.float32, 32, 64),
    (torch.bfloat16, 24, 300)])
def test_stream_matmul_batched_on_card(cuda, dtype, s, G):
    """The paper's stream (G = 100,000), a ragged last block of matrices,
    and a size off the specialised path (24: the tiled kernel, G on z)."""
    from repro_torch.kernels import stream_matmul as tmm
    gen = torch.Generator(device=cuda).manual_seed(s + G)
    a = torch.randn((G, s, s), generator=gen, device=cuda).to(dtype)
    b = torch.randn((G, s, s), generator=gen, device=cuda).to(dtype)
    n = launches["stream_matmul_batched"]
    got = tmm.stream_matmul_batched_cuda(a, b)
    assert launches["stream_matmul_batched"] == n + 1
    assert got.dtype == dtype and got.shape == (G, s, s)
    _mm_close(got, tmm.matmul_batched_ref(a, b), dtype, s)


MM_CARD_SHAPES = [
    (16, 16, 16), (32, 32, 32), (128, 128, 128), (200, 300, 150),
    (129, 257, 65), (4096, 4096, 4096),
    (200, 301, 150), (129, 257, 65),                  # rows off 16 bytes
    (16, 8192, 16), (1, 4096, 1), (64, 4096, 64),     # split K
    (127, 129, 255), (255, 127, 129), (129, 255, 127),
    (255, 255, 255), (127, 127, 127)]                 # tile edges


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", MM_CARD_SHAPES[:6])
def test_stream_matmul_on_card(cuda, dtype, m, k, n):
    from repro_torch.kernels import stream_matmul as tmm
    gen = torch.Generator(device=cuda).manual_seed(m + k + n)
    a = torch.randn((m, k), generator=gen, device=cuda).to(dtype)
    b = torch.randn((k, n), generator=gen, device=cuda).to(dtype)
    cnt = launches["stream_matmul"]
    got = tmm.stream_matmul_cuda(a, b)
    assert launches["stream_matmul"] == cnt + 1
    assert got.dtype == dtype and got.shape == (m, n)
    _mm_close(got, tmm.matmul_ref(a, b), dtype, k)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", MM_CARD_SHAPES[6:])
def test_stream_matmul_plans_on_card(cuda, dtype, m, k, n):
    """Unaligned rows, split K (one launch counted for the tile kernel and
    the split sum) and tile edges; the plan launched is matmul_plan's, and
    two calls are bitwise equal (the splits are summed in a fixed order)."""
    from repro_torch.kernels import _lib
    from repro_torch.kernels import stream_matmul as tmm
    gen = torch.Generator(device=cuda).manual_seed(m * n + k)
    a = torch.randn((m, k), generator=gen, device=cuda).to(dtype)
    b = torch.randn((k, n), generator=gen, device=cuda).to(dtype)
    cnt = launches["stream_matmul"]
    got = tmm.stream_matmul_cuda(a, b)
    again = tmm.stream_matmul_cuda(a, b)
    assert launches["stream_matmul"] == cnt + 2
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert _lib.last_plan["stream_matmul"] == tmm.matmul_plan(m, k, n, dtype,
                                                              sms)
    assert got.dtype == dtype and got.shape == (m, n)
    assert torch.equal(got, again)
    _mm_close(got, tmm.matmul_ref(a, b), dtype, k)


@pytest.mark.cuda
def test_stream_matmul_refuses_what_it_cannot_take(cuda):
    """Refused on the card; nothing falls back to the plain version."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import stream_matmul as tmm
    a = torch.randn((64, 32), device=cuda)
    b = torch.randn((32, 16), device=cuda)
    cnt = launches["stream_matmul"]
    with pytest.raises(TypeError):
        tmm.stream_matmul_cuda(a.half(), b.half())
    with pytest.raises(TypeError):
        ops.matmul(a, b.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        tmm.stream_matmul_cuda(a.t().contiguous().t(), b)
    with pytest.raises(ValueError, match="chain"):
        tmm.stream_matmul_cuda(a, b.t().contiguous())
    with pytest.raises(ValueError, match="CUDA tensors"):
        tmm.stream_matmul_cuda(a.cpu(), b.cpu())
    assert launches["stream_matmul"] == cnt


@pytest.mark.cuda
def test_stream_fifo_on_card_delivers_host_blocks_in_order(cuda):
    """Blocks sliced from one pinned stream and pageable numpy blocks arrive
    on the card equal to the host blocks, in order, usable on the consumer's
    stream."""
    from repro_torch.rc2f import StreamFIFO
    rng = np.random.default_rng(11)
    host = torch.from_numpy(rng.standard_normal((40, 8, 16, 16))
                            .astype(np.float32)).pin_memory()
    items = [(host[i], rng.standard_normal((3,)).astype(np.float32))
             for i in range(40)]
    fifo = StreamFIFO(depth=3, device="cuda").feed(iter(items))
    n = 0
    for (blk, vec), (h_blk, h_vec) in zip(fifo, items):
        assert blk.device.type == "cuda" and vec.device.type == "cuda"
        torch.testing.assert_close((blk * 2).cpu(), h_blk * 2, rtol=0,
                                   atol=0)
        torch.testing.assert_close(vec.cpu(), torch.from_numpy(h_vec),
                                   rtol=0, atol=0)
        n += 1
    assert n == fifo.items_in == 40


@pytest.mark.cuda
def test_raas_slice_on_card(cuda):
    """RAaaS deploy -> FIFO -> FusedShell and SpatialShell on the card: the
    batched kernel runs once per core per cycle, through the graphs' tally;
    outputs match the plain version on the host blocks. Full blocks of 64
    and a tail of 32: the fused cycle captures one graph a block shape and
    replays it, each slot of the spatial shell likewise, and the slots'
    outputs are bitwise the fused cycle's."""
    from repro_torch.core import ClusterSpec, Hypervisor, RAaaSSession
    from repro_torch.kernels import ops
    from repro_torch.kernels import stream_matmul as tmm
    from repro_torch.rc2f import (CoreSpec, FusedShell, SpatialShell,
                                  StreamFIFO, StreamSpec)

    def core(a, b):
        return (ops.matmul_batched(a, b),)

    g, s, n, cycles = 64, 16, 4, 5
    hv = Hypervisor(ClusterSpec(n_nodes=2, devices_per_node=2))
    spec = CoreSpec("mm16", (StreamSpec((g, s, s)),) * 2,
                    (StreamSpec((g, s, s)),))
    entries = [RAaaSSession(hv, f"t{i}").deploy_core(
        core, spec.example_inputs(), "mm16") for i in range(n)]
    rng = np.random.default_rng(5)
    rows = [g] * (cycles - 2) + [32, g]        # a tail block, then full
    blocks = [[tuple(torch.from_numpy(rng.standard_normal((r, s, s))
                                      .astype(np.float32)) for _ in range(2))
               for r in rows] for _ in range(n)]
    got = {}
    for shell in (FusedShell(4), SpatialShell(n_slots=4)):
        for i, e in enumerate(entries):
            shell.load(i, e.compiled, spec, f"t{i}")
        fifos = [StreamFIFO(2).feed(iter(blocks[i])) for i in range(n)]
        before = launches["stream_matmul_batched"]
        kept = []
        for c in range(cycles):
            if isinstance(shell, FusedShell):
                outs = shell.run_cycle({i: fifos[i].get() for i in range(n)})
            else:
                outs = {i: shell.run(i, *fifos[i].get()) for i in range(n)}
                shell.join()
            kept.append([outs[i][0] for i in range(n)])
        torch.cuda.synchronize()
        for c in range(cycles):                 # each cycle's own copies
            for i in range(n):
                ref = tmm.matmul_batched_ref(*blocks[i][c])
                torch.testing.assert_close(kept[c][i].cpu(), ref, atol=1e-4,
                                           rtol=1e-4)
        assert launches["stream_matmul_batched"] - before == n * cycles
        per = 1 if isinstance(shell, FusedShell) else n    # programs
        counts = shell.counts()
        assert counts["captures"] == 2 * per
        assert counts["replays"] == (cycles - 2) * per
        assert all(ms > 0 for ms in counts["capture_ms"])
        got[type(shell).__name__] = kept
    for a, b in zip(got["FusedShell"], got["SpatialShell"]):
        assert all(torch.equal(x, y) for x, y in zip(a, b))


def _item_core(a, b, ucs):
    return a * ucs["r0"].item() + b


@pytest.mark.cuda
def test_shell_cycle_graph_on_card(cuda):
    """A FusedShell cycle's graph: a replay bitwise equal to a direct call
    of the cycle's function on the shell's buffers; a register written
    between replays read by the next one; a hot swap of slot 2 that
    captures anew and drops the old program's graphs and pool, slot 0's
    output unchanged; a core that syncs (``.item()``) refused at its first
    cycle, naming its line, and every later cycle refused."""
    from repro_torch.core.graphs import GraphCaptureError
    from repro_torch.rc2f import CoreSpec, FusedShell, StreamSpec

    def mm(a, b):
        from repro_torch.kernels import ops
        return (ops.matmul_batched(a, b),)

    def scaled(a, b, ucs):
        return (a + b) * ucs["r1"]

    def axpy(a, b):
        return a * 2.0 + b

    g, s = 64, 16
    spec = CoreSpec("mm16", (StreamSpec((g, s, s)),) * 2,
                    (StreamSpec((g, s, s)),))
    gen = torch.Generator(device=cuda).manual_seed(7)
    a, b = (torch.randn((g, s, s), generator=gen, device=cuda)
            for _ in range(2))
    shell = FusedShell(4)
    shell.load(0, mm, spec)
    shell.load(2, scaled, spec)
    shell.slots[2].ucs.write("r1", 3)
    inputs = {0: (a, b), 2: (a, b)}
    for _ in range(3):
        out = shell.run_cycle(inputs)
    program = shell.program
    assert program.counts()["captures"] == 1 and program.replays == 2
    direct = program.fn(*shell.bound)
    torch.cuda.synchronize()
    assert torch.equal(out[0][0], direct[0][0])
    assert torch.equal(out[2][0], direct[1][0])
    assert torch.equal(out[2][0], (a + b) * 3)
    shell.slots[2].ucs.write("r1", -5)
    uploads = shell.slots[2].regs.uploads
    out2 = shell.run_cycle(inputs)
    assert shell.slots[2].regs.uploads == uploads + 1
    assert program.captures == 1 and program.replays == 3
    torch.cuda.synchronize()
    assert torch.equal(out2[2][0], (a + b) * -5)
    assert torch.equal(out[2][0], (a + b) * 3)        # a copy, kept
    # hot swap of slot 2: the old program's graphs and pool go
    shell.load(2, axpy, spec)
    out3 = shell.run_cycle(inputs)
    assert shell.program is not program
    assert not program._graphs and program._pool.live == 0
    assert shell.program.captures == 1
    torch.cuda.synchronize()
    assert torch.equal(out3[0][0], out[0][0])
    assert torch.equal(out3[2][0], a * 2.0 + b)
    assert shell.counts()["captures"] == 2
    # a core that syncs with the host: refused, never run eagerly after
    shell.load(1, _item_core, spec)
    with pytest.raises(GraphCaptureError, match="_item_core"):
        shell.run_cycle({0: (a, b), 1: (a, b), 2: (a, b)})
    before = dict(launches)
    with pytest.raises(GraphCaptureError, match="cannot be captured"):
        shell.run_cycle({0: (a, b), 1: (a, b), 2: (a, b)})
    assert dict(launches) == before


# ---------------------------------------------------------------------------
# Mamba2 SSD scan
# ---------------------------------------------------------------------------

SSD_TOL = dict(atol=5e-4, rtol=5e-3)


def _ssd_layer_inputs(gen, dev, B, S, H, P, G, N, dtype):
    """The layer's operands: xs, Bm, Cm as views of one (B, S, C) activation
    (as ``_split_xbc`` makes them), dt (B, S, H) fp32, A and D (H,)."""
    C = H * P + 2 * G * N
    xbc = (torch.randn((B, S, C), generator=gen, device=dev) * 0.5).to(dtype)
    xs = xbc[..., :H * P].reshape(B, S, H, P)
    Bm = xbc[..., H * P:H * P + G * N].reshape(B, S, G, N)
    Cm = xbc[..., H * P + G * N:].reshape(B, S, G, N)
    dt = torch.nn.functional.softplus(
        torch.randn((B, S, H), generator=gen, device=dev) - 1.0)
    A = -torch.exp(torch.randn((H,), generator=gen, device=dev))
    D = torch.randn((H,), generator=gen, device=dev)
    return xs, dt, A, Bm, Cm, D


@pytest.mark.cuda
@pytest.mark.parametrize("case,dtype,B,S,H,P,G,N,init", [
    ("fp32/B4/S1024", torch.float32, 4, 1024, 32, 64, 1, 128, False),
    ("bf16/B4/S1024", torch.bfloat16, 4, 1024, 32, 64, 1, 128, False),
    ("fp32/B1/S2048", torch.float32, 1, 2048, 32, 64, 1, 128, False),
    ("fp32/B2/S1000", torch.float32, 2, 1000, 32, 64, 1, 128, True),
    ("fp32/groups", torch.float32, 2, 77, 8, 48, 2, 64, True),
    ("bf16/B8/S256", torch.bfloat16, 8, 256, 32, 64, 1, 128, False),
    ("fp32/N16", torch.float32, 3, 40, 4, 16, 1, 16, False),
    ("bf16/N64", torch.bfloat16, 1, 100, 8, 32, 4, 64, True),
    ("bf16/B1/S2048", torch.bfloat16, 1, 2048, 32, 64, 1, 128, True),
    ("bf16/S<Q", torch.bfloat16, 2, 20, 8, 64, 2, 128, True),
    ("fp32/S=Q+1", torch.float32, 3, 33, 4, 32, 1, 64, False),
    ("bf16/N16/G4", torch.bfloat16, 2, 70, 8, 16, 4, 16, True),
    ("fp32/N128/G4", torch.float32, 1, 300, 8, 64, 4, 128, True)])
def test_ssd_kernel_on_card(cuda, case, dtype, B, S, H, P, G, N, init):
    """mamba2-370m's width (H 32, P 64, N 128) at the chip_smoke cases (the
    ssm_serve batches B 4 and 8 take 64-row blocks, B 1 16-row ones), and
    groups, a ragged row tile (P 48), the other state dims, an init state,
    S below one chunk and one step past it: y and the final state against
    the sequential plain version and the chunked ``ssd_scan``."""
    from repro_torch.kernels import _lib
    from repro_torch.kernels import mamba2_chunk as tssd
    from repro_torch.layers.ssm import ssd_scan
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    plan = tssd.ssd_plan(B, S, H, P, N, sms)
    if case == "bf16/B8/S256":        # 256 (sequence, head) pairs
        assert (plan.wp, plan.ns) == (4, 2)
    if case == "bf16/B1/S2048":       # 32 pairs: 16-row blocks
        assert (plan.wp, plan.ns) == (1, 8)
    gen = torch.Generator(device=cuda).manual_seed(S + N)
    xs, dt, A, Bm, Cm, D = _ssd_layer_inputs(gen, cuda, B, S, H, P, G, N,
                                             dtype)
    st0 = (torch.randn((B, H, P, N), generator=gen, device=cuda) * 0.1
           if init else None)
    n = launches["ssd_chunk_scan"]
    y, st = tssd.ssd_cuda(xs, dt, A, Bm, Cm, D, st0)
    assert launches["ssd_chunk_scan"] == n + 1
    assert _lib.last_plan["ssd_chunk_scan"] == plan
    assert y.dtype == dtype and y.shape == (B, S, H, P)
    assert st.dtype == torch.float32 and st.shape == (B, H, P, N)
    tol = SSD_TOL if dtype == torch.float32 else TOL_BF16
    for ry, rs in (tssd.ssd_ref(xs, dt, A, Bm, Cm, D, st0),
                   ssd_scan(xs, dt, A, Bm, Cm, D, 256, st0)):
        torch.testing.assert_close(y.float(), ry.float(), **tol)
        torch.testing.assert_close(st, rs, **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,B", [(torch.bfloat16, 4), (torch.float32, 1)])
def test_ssd_kernel_is_deterministic_on_card(cuda, dtype, B):
    """Two calls give bitwise equal y and state (no atomics), one launch
    each, at both block shapes."""
    from repro_torch.kernels import mamba2_chunk as tssd
    gen = torch.Generator(device=cuda).manual_seed(B)
    args = _ssd_layer_inputs(gen, cuda, B, 1000, 32, 64, 1, 128, dtype)
    n = launches["ssd_chunk_scan"]
    y, st = tssd.ssd_cuda(*args)
    y2, st2 = tssd.ssd_cuda(*args)
    assert launches["ssd_chunk_scan"] == n + 2
    assert torch.equal(y, y2) and torch.equal(st, st2)


@pytest.mark.cuda
def test_ssd_chunk_scan_reference_layout_on_card(cuda):
    """The (BH, S, P) entry with per-head operands (the reference's
    signature), bf16 dt widened."""
    from repro_torch.kernels import mamba2_chunk as tssd
    from repro_torch.kernels import ops
    gen = torch.Generator(device=cuda).manual_seed(7)
    BH, S, P, N = 6, 300, 64, 128
    x = torch.randn((BH, S, P), generator=gen, device=cuda) * 0.5
    dt = torch.nn.functional.softplus(
        torch.randn((BH, S), generator=gen, device=cuda))
    Bm = torch.randn((BH, S, N), generator=gen, device=cuda) * 0.3
    Cm = torch.randn((BH, S, N), generator=gen, device=cuda) * 0.3
    a = -torch.exp(torch.randn((BH,), generator=gen, device=cuda))
    d = torch.ones((BH,), device=cuda)
    n = launches["ssd_chunk_scan"]
    got = ops.ssd_chunk_scan(x, dt, Bm, Cm, a, d, chunk=64)
    got16 = ops.ssd_chunk_scan(x.bfloat16(), dt.bfloat16(), Bm.bfloat16(),
                               Cm.bfloat16(), a, d)
    assert launches["ssd_chunk_scan"] == n + 2
    torch.testing.assert_close(got, tssd.ssd_chunk_scan_ref(x, dt, Bm, Cm,
                                                            a, d), **SSD_TOL)
    ref16 = tssd.ssd_chunk_scan_ref(x.bfloat16(), dt.bfloat16(),
                                    Bm.bfloat16(), Cm.bfloat16(), a, d)
    torch.testing.assert_close(got16.float(), ref16.float(), **TOL_BF16)


@pytest.mark.cuda
def test_ssd_kernel_refuses_what_it_cannot_take(cuda):
    """Refused on the card; nothing falls back to the plain version."""
    from repro_torch.kernels import mamba2_chunk as tssd
    gen = torch.Generator(device=cuda).manual_seed(1)
    args = _ssd_layer_inputs(gen, cuda, 1, 8, 2, 16, 1, 16, torch.float32)
    xs, dt, A, Bm, Cm, D = args
    n = launches["ssd_chunk_scan"]
    with pytest.raises(TypeError):
        tssd.ssd_cuda(xs.half(), dt, A, Bm.half(), Cm.half(), D)
    with pytest.raises(TypeError):
        tssd.ssd_cuda(xs, dt.bfloat16(), A, Bm, Cm, D)
    for n_state in (24, 32, 256):      # no config has these
        bad = _ssd_layer_inputs(gen, cuda, 1, 8, 2, 16, 1, n_state,
                                torch.float32)
        with pytest.raises(ValueError, match="state dim"):
            tssd.ssd_cuda(*bad)
    bad = _ssd_layer_inputs(gen, cuda, 1, 8, 2, 12, 1, 16, torch.bfloat16)
    with pytest.raises(ValueError, match="head dim 12"):
        tssd.ssd_cuda(*bad)
    with pytest.raises(ValueError, match="contiguous last dim"):
        tssd.ssd_cuda(xs.transpose(2, 3).contiguous().transpose(2, 3), dt,
                      A, Bm, Cm, D)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tssd.ssd_cuda(*(t.cpu() for t in args))
    # views of a (B, S, C + 1) activation from its second column: the base
    # is 4 bytes off and the rows are C + 1 long
    xbc = torch.randn((1, 8, 2 * 16 + 2 * 16 + 1), generator=gen,
                      device=cuda)[..., 1:]
    with pytest.raises(ValueError, match="16-byte aligned"):
        tssd.ssd_cuda(xbc[..., :32].reshape(1, 8, 2, 16), dt, A,
                      xbc[..., 32:48].reshape(1, 8, 1, 16),
                      xbc[..., 48:].reshape(1, 8, 1, 16), D)
    assert launches["ssd_chunk_scan"] == n


def _wrapper_call(name, cuda):
    """A small call of kernel wrapper ``name`` on the card (its first
    operand the one returned for ``requires_grad``)."""
    from repro_torch.kernels import ops
    gen = torch.Generator(device=cuda).manual_seed(3)
    rnd = lambda *s: torch.randn(s, generator=gen, device=cuda)
    if name in ("decode_attention", "paged_decode_attention"):
        q, k, v, kpos, cur = (t.to(cuda) for t in _decode_inputs(
            2, 4, 2, 64, 64, [40, 10], fill=0, seed=5))
        if name == "decode_attention":
            return q, lambda q: ops.decode_attention(q, k, v, kpos, cur)
        kp, vp, kpp, bt, _ = _to_pool(k.cpu(), v.cpu(), kpos.cpu(), 16, 6)
        return q, lambda q: ops.paged_decode_attention(
            q, kp.to(cuda), vp.to(cuda), kpp.to(cuda), bt.to(cuda), cur)
    if name == "flash_attention":
        k, v = rnd(1, 2, 64, 64), rnd(1, 2, 64, 64)
        return rnd(1, 4, 64, 64), lambda q: ops.flash_attention(q, k, v)
    if name == "stream_matmul":
        b = rnd(64, 32)
        return rnd(16, 64), lambda a: ops.matmul(a, b)
    xs, dt, A, Bm, Cm, D = _ssd_layer_inputs(gen, cuda, 1, 32, 2, 64, 1,
                                             64, torch.float32)
    return xs, lambda x: ops.ssd(x, dt, A, Bm, Cm, D)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["decode_attention",
                                  "paged_decode_attention",
                                  "flash_attention", "stream_matmul",
                                  "ssd_chunk_scan"])
def test_kernel_wrappers_refuse_autograd_inputs(cuda, name):
    """No kernel defines a backward (nor does the reference's): a CUDA
    dispatch that would record a graph raises and launches nothing; the
    same call with no input requiring grad launches once."""
    x, call = _wrapper_call(name, cuda)
    before = dict(launches)
    with pytest.raises(RuntimeError, match="defines no backward"):
        call(x.detach().requires_grad_(True))
    assert dict(launches) == before
    call(x)
    assert launches[name] == before[name] + 1


# ---------------------------------------------------------------------------
# The mesh slice on the card: a one-rank NCCL mesh, in a spawned process
# (the process group stays out of the test process)
# ---------------------------------------------------------------------------

def _mesh_on_card(out_file: str):
    import json

    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels import _lib, ops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import get_model
    from repro_torch.runtime import (jit_serve_step, make_prefill_step,
                                     make_serve_step)
    from repro_torch.runtime.sharding import place
    from repro_torch.tree import tree_map
    mesh = make_host_mesh(1, 1, device="cuda")
    try:
        cfg = reduced(get_config("smollm-135m")).replace(dtype="bfloat16")
        model = get_model(cfg, device="cuda")
        params = model.init(torch.Generator(device="cuda").manual_seed(0))
        prompts = torch.randint(0, cfg.vocab_size, (4, 16), device="cuda",
                                generator=torch.Generator(
                                    device="cuda").manual_seed(1),
                                dtype=torch.int32)
        h, caches = make_prefill_step(model, 32)(params, {"tokens": prompts})
        tok0 = model.logits(params, h[:, -1:]).argmax(-1).to(torch.int32)
        mstep, specs = jit_serve_step(model, mesh, 4, 32, params, caches)
        runs = {}
        for tag in ("plain", "mesh"):
            cch = tree_map(torch.clone, caches)
            prm, step = params, make_serve_step(model)
            if tag == "mesh":
                prm = place(params, mesh, specs["params"])
                cch = place(cch, mesh, specs["caches"])
                step = mstep
            tok = tok0.clone()
            pos = torch.full((4,), 16, dtype=torch.int32, device="cuda")
            _lib.launches.reset()
            toks = []
            for _ in range(8):
                logits, cch = step(prm, cch, tok, pos)
                if tag == "mesh":
                    logits = logits.to_local()
                tok = logits[:, -1:].argmax(-1).to(torch.int32)
                toks.append(tok[:, 0].tolist())
                pos = pos + 1
            runs[tag] = dict(tokens=toks,
                             launches=_lib.launches["decode_attention"])
        runs["serve_graph"] = _mesh_serve_graph(model, mesh, params, caches,
                                                tok0)
        runs["train_graph"] = _mesh_train_graph(mesh)
        runs["refusal"] = _mesh_refusal(model, mesh, params, caches, tok0)
        q = DTensor.from_local(torch.zeros(2, 4, 32, device="cuda"), mesh,
                               [Replicate(), Replicate()])
        try:
            ops.flash_attention(q, q, q)
            refused = False
        except TypeError:
            refused = True
        runs["refused"] = refused
        runs["layers"] = cfg.n_layers
        with open(out_file, "w") as f:
            json.dump(runs, f)
    finally:
        dist.destroy_process_group()


def _dt_equal(a, b):
    return a.placements == b.placements and torch.equal(a.to_local(),
                                                        b.to_local())


def _mesh_serve_graph(model, mesh, params, caches, tok0):
    """8 calls of a new jit_serve_step program from placed caches, each
    after a direct eager call of its step on a clone of the same caches:
    logits and caches bitwise equal, the caches returned as the caller's
    own DTensors, one capture and 7 replays, the decode kernel launched
    by the program once a layer a call (counted through the capture)."""
    from repro_torch.kernels import _lib
    from repro_torch.runtime import jit_serve_step
    from repro_torch.runtime.sharding import place
    from repro_torch.tree import flatten, tree_map
    mstep, specs = jit_serve_step(model, mesh, 4, 32, params, caches)
    mparams = place(params, mesh, specs["params"])
    mcaches = place(tree_map(torch.clone, caches), mesh, specs["caches"])
    leaves = flatten(mcaches)[0]
    tok = tok0.clone()
    pos = torch.full((4,), 16, dtype=torch.int32, device="cuda")
    bad, launched = [], 0
    for i in range(8):
        direct = tree_map(torch.clone, mcaches)
        want, direct = mstep.step(mparams, direct, tok, pos)
        before = _lib.launches["decode_attention"]
        logits, got = mstep(mparams, mcaches, tok, pos.cpu().numpy())
        launched += _lib.launches["decode_attention"] - before
        if not (_dt_equal(logits, want) and all(
                a is b and _dt_equal(a, c) for a, b, c in zip(
                    flatten(got)[0], leaves, flatten(direct)[0]))):
            bad.append(i)
        tok = logits.to_local()[:, -1:].argmax(-1).to(torch.int32)
        pos = pos + 1
    counts = mstep.graphs.counts()
    mstep.graphs.close()
    return dict(bad=bad, counts=counts, launches=launched)


def _mesh_train_graph(mesh):
    """3 steps of jit_train_step's program (smollm at full width, 2
    layers, fp32) on the placed state, each after a direct eager call of
    its in-place step on a clone of the same state, under deterministic
    algorithms: metrics and every leaf bitwise equal, the caller's state
    leaves returned, every local shard at its address, one capture then
    replays."""
    from repro_torch.runtime import jit_train_step
    from repro_torch.runtime.sharding import place
    from repro_torch.tree import flatten, tree_map
    model, opts, state, data = _train_setup(torch.device("cuda"))
    step, sspecs, _ = jit_train_step(model, mesh, opts, state,
                                     data.batch_at(0))
    mstate = place(state, mesh, sspecs)
    ptrs = [t.to_local().data_ptr() for t in flatten(mstate)[0]]
    bad = []
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for i in range(3):
            direct, want = step.step(tree_map(torch.clone, mstate),
                                     data.batch_at(i))
            got_state, got = step(mstate, data.batch_at(i))
            if any(a is not b for a, b in zip(flatten(got_state)[0],
                                              flatten(mstate)[0])):
                bad.append(f"step {i}: not the caller's state")
            bad += [f"step {i}: metric {k}" for k in want
                    if not torch.equal(got[k], want[k])]
            bad += [f"step {i}: leaf {j}" for j, (a, b) in enumerate(zip(
                flatten(mstate)[0], flatten(direct)[0]))
                if not _dt_equal(a, b)]
    finally:
        torch.use_deterministic_algorithms(False)
    kept = [t.to_local().data_ptr() for t in flatten(mstate)[0]] == ptrs
    counts = step.graphs.counts()
    step.graphs.close()
    return dict(bad=bad, counts=counts, addresses_kept=kept)


class _SyncingModel:
    """A model whose decode reads its positions on the host."""

    def __init__(self, model):
        self.model, self.cfg, self.dev = model, model.cfg, model.dev
        self.calls = 0

    def decode(self, params, caches, tokens, pos):
        self.calls += 1
        if int(pos.to_local().max()) < 0:
            raise ValueError("negative position")
        return self.model.decode(params, caches, tokens, pos)


def _mesh_refusal(model, mesh, params, caches, tok0):
    """jit_serve_step of a syncing model: its first call raises
    GraphCaptureError naming the line, and the next call is refused
    without running the step."""
    from repro_torch.core.graphs import GraphCaptureError
    from repro_torch.runtime import jit_serve_step
    from repro_torch.runtime.sharding import place
    from repro_torch.tree import tree_map
    syncing = _SyncingModel(model)
    step, specs = jit_serve_step(syncing, mesh, 4, 32, params, caches)
    mparams = place(params, mesh, specs["params"])
    mcaches = place(tree_map(torch.clone, caches), mesh, specs["caches"])
    pos = torch.full((4,), 16, dtype=torch.int32, device="cuda")
    msgs = []
    for _ in range(2):
        try:
            step(mparams, mcaches, tok0, pos)
            msgs.append("")
        except GraphCaptureError as e:
            msgs.append(str(e))
        msgs.append(syncing.calls)
    torch.cuda.synchronize()             # the card is still usable
    return msgs


@pytest.fixture(scope="module")
def mesh_card_run(tmp_path_factory):
    import json
    import multiprocessing
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    out = tmp_path_factory.mktemp("mesh") / "run.json"
    p = multiprocessing.get_context("spawn").Process(
        target=_mesh_on_card, args=(str(out),))
    p.start()
    p.join(600)
    if p.is_alive():
        p.kill()
    assert p.exitcode == 0, p.exitcode
    return json.loads(out.read_text())


@pytest.mark.cuda
def test_jit_serve_step_on_one_rank_nccl_mesh(mesh_card_run):
    """jit_serve_step on a one-rank NCCL mesh: the tokens of
    make_serve_step, and the decode kernel launched by the mesh path
    (layers x steps) inside its local_map region."""
    r = mesh_card_run
    assert r["mesh"]["tokens"] == r["plain"]["tokens"]
    assert r["mesh"]["launches"] == r["layers"] * 8
    assert r["plain"]["launches"] == r["layers"] * 8


@pytest.mark.cuda
def test_kernel_wrapper_refuses_a_dtensor(mesh_card_run):
    assert mesh_card_run["refused"]


@pytest.mark.cuda
def test_jit_serve_step_replays_the_direct_call(mesh_card_run):
    """jit_serve_step's program on the one-rank NCCL mesh: one capture and
    replays, each call bitwise equal to a direct eager call on cloned
    caches (tokens as device tensors, positions as numpy), the caches the
    caller's own, the decode kernel once a layer a call."""
    r = mesh_card_run["serve_graph"]
    assert r["bad"] == []
    assert r["counts"] == dict(graphs=1, captures=1, replays=7, evictions=0)
    assert r["launches"] == mesh_card_run["layers"] * 8


@pytest.mark.cuda
def test_jit_train_step_replays_the_direct_call(mesh_card_run):
    """jit_train_step's program on the one-rank NCCL mesh: the DTensor
    state updated in place at its addresses, one capture then replays,
    each step bitwise equal to the direct eager in-place step."""
    r = mesh_card_run["train_graph"]
    assert r["bad"] == [] and r["addresses_kept"]
    assert r["counts"] == dict(graphs=1, captures=1, replays=2, evictions=0)


@pytest.mark.cuda
def test_mesh_step_that_syncs_is_refused(mesh_card_run):
    """A mesh serve step that reads its positions on the host: its first
    call runs eagerly, then the capture raises GraphCaptureError naming
    the line; the next call is refused without running the step."""
    first, calls, second, calls_after = mesh_card_run["refusal"]
    assert first.startswith("mesh_serve_step")
    assert "test_torch_cuda.py" in first and "pos.to_local().max()" in first
    assert second == first and calls_after == calls == 2


# ---------------------------------------------------------------------------
# SpatialShell's sub-meshes and the port's examples on the card
# ---------------------------------------------------------------------------

SHELL_ON_CARD = """
import torch, torch.distributed as dist
from repro_torch.kernels import launches, ops
from repro_torch.kernels.stream_matmul import matmul_batched_ref
from repro_torch.rc2f import CoreSpec, SpatialShell, StreamSpec
shell = SpatialShell()
assert shell.device.type == "cuda" and shell._groups == [[0]] * 4
assert not dist.is_initialized()           # the constructor opens no group
for i in range(4):
    m = shell.slot_mesh(i)
    assert m.device_type == "cuda" and m.size() == 1, m
    x = torch.arange(4.0, device="cuda") + i
    y = x.clone()
    dist.all_reduce(y, group=m.get_group())
    assert torch.equal(x, y)
assert dist.get_backend() == "nccl"
spec = CoreSpec("mm16", (StreamSpec((64, 16, 16)),) * 2,
                (StreamSpec((64, 16, 16)),))
gen = torch.Generator(device="cuda").manual_seed(0)
a, b = (torch.randn((4, 64, 16, 16), generator=gen, device="cuda")
        for _ in range(2))
for i in range(4):
    shell.load(i, lambda p, q: (ops.matmul_batched(p, q),), spec, f"t{i}")
before = launches["stream_matmul_batched"]
outs = [shell.run(i, a[i], b[i])[0] for i in range(4)]
shell.join()
assert launches["stream_matmul_batched"] - before == 4
for i in range(4):
    torch.testing.assert_close(outs[i], matmul_batched_ref(a[i], b[i]),
                               atol=1e-4, rtol=1e-4)
dist.destroy_process_group()
print("OK")
"""


@pytest.mark.cuda
def test_spatial_shell_one_rank_on_card(cuda):
    """SpatialShell() on the card: 4 slots over rank [0], each slot mesh a
    one-rank CUDA DeviceMesh (NCCL, made at the first slot_mesh) whose
    all-reduce returns its input, the cores on the slots' streams."""
    import os
    import subprocess
    import sys
    root = os.path.join(os.path.dirname(__file__), "..")
    proc = subprocess.run([sys.executable, "-c", SHELL_ON_CARD], cwd=root,
                          capture_output=True, text=True, timeout=600,
                          env=dict(os.environ, PYTHONPATH="src"))
    assert proc.returncode == 0, proc.stderr[-2500:]
    assert "OK" in proc.stdout


def _port_example(name):
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(__file__), "..", "examples",
                        f"{name}_torch.py")
    spec = importlib.util.spec_from_file_location(f"{name}_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["quickstart", "serve_baas", "multi_tenant",
                                  "train_smollm"])
def test_port_example_on_card(cuda, name, tmp_path, capsys):
    """Each port example with --device cuda (its default) through main:
    serving launches the attention kernels, the rest launch none."""
    from repro_torch.kernels import _lib
    argv = ["--device", "cuda"]
    if name == "train_smollm":
        argv += ["--steps", "60", "--ckpt-dir", str(tmp_path)]
    before = dict(_lib.launches)
    res = _port_example(name).main(argv)
    got = {k: _lib.launches[k] - before[k] for k in before}
    if name == "quickstart":
        assert res["invoke"] == [2.0 * i for i in range(8)]
        assert not any(got.values())
    elif name == "serve_baas":
        assert res["total_new"] == 96
        assert got["paged_decode_attention"] > 0 and got["flash_attention"] > 0
    elif name == "multi_tenant":
        assert res["tenant0_unchanged"] and res["slot2_axpy"]
        assert res["gateway"]["audited"] == 9 and res["fleet"]["served"] == 5
        assert got["decode_attention"] > 0 and got["flash_attention"] > 0
    else:
        assert res["losses"][-1] < res["losses"][0]
        assert not any(got.values())
    assert capsys.readouterr().out


# ---------------------------------------------------------------------------
# The decode step as CUDA graphs (core/graphs.py)
# ---------------------------------------------------------------------------

def _graph_model(cuda, dtype="bfloat16", kv_quant=False, layers=4):
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    cfg = get_config("smollm-135m").replace(n_layers=layers, dtype=dtype,
                                            kv_quant=kv_quant)
    model = Model(cfg, device=cuda)
    return cfg, model, model.init(torch.Generator(device=cuda).manual_seed(0))


def _graph_prompts(vocab, n=6, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=int(m)).astype(np.int32)
            for m in rng.integers(2, 80, size=n)]


def _clone_tree(tree):
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_clone_tree(v) for v in tree)
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def _replay_against_direct(eng, params, cuda):
    """Wrap ``eng._decode`` so that each step, replayed from the engine's
    graph, is followed by a direct call of the captured function (the serve
    step and ``greedy_tail``, eagerly) on copies of the step's inputs.
    Returns the list of (ids equal, largest logit difference) a step."""
    step = eng._greedy.fn
    dec = eng._decode
    got = []

    def decode(tokens, pos):
        caches = _clone_tree(eng.caches)
        extra = (torch.from_numpy(np.ascontiguousarray(
            eng.pool.block_tables, np.int32)).to(cuda),) if eng.paged else ()
        logits = dec(tokens, pos).clone()
        ids = eng._step_ids.clone()
        want_logits, want_ids = step(
            params, caches, torch.from_numpy(np.array(tokens)).to(cuda),
            torch.from_numpy(np.array(pos, np.int32)).to(cuda), *extra)
        got.append((torch.equal(ids, want_ids),
                    float((logits.float() - want_logits.float()).abs()
                          .max())))
        return logits

    eng._decode = decode
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("dtype,kv_quant", [("bfloat16", False),
                                            ("float32", False),
                                            ("bfloat16", True)],
                         ids=["bf16", "fp32", "int8"])
def test_engine_replay_matches_a_direct_call(cuda, paged, dtype, kv_quant):
    """An engine's decode steps replay one graph on its own buffers (one
    capture, every later step a replay); at every step a direct call of
    the captured function on copies of the same inputs gives the same ids,
    and fp32 logits within 1e-5. The launches count executions: one decode
    a layer for each replay and each direct call."""
    from repro_torch.runtime import BatchingEngine
    cfg, model, params = _graph_model(cuda, dtype, kv_quant)
    eng = BatchingEngine(model, params, n_slots=4, max_len=128, paged=paged,
                         page_size=16)
    for p in _graph_prompts(cfg.vocab_size):
        eng.submit(p, max_new_tokens=12)
    got = _replay_against_direct(eng, params, cuda)
    launches.reset()
    assert eng.run_until_idle()
    n_dec = "paged_decode_attention" if paged else "decode_attention"
    assert launches[n_dec] == 2 * cfg.n_layers * len(got)
    assert all(same for same, _ in got)
    if dtype == "float32":
        assert max(d for _, d in got) <= 1e-5, got
    counts = eng._greedy.counts()
    assert counts == dict(graphs=1, captures=1, replays=len(got) - 1,
                          evictions=0)


@pytest.mark.cuda
def test_engine_serves_the_cast_once_weights(cuda):
    """A paged bf16 engine over fp32 masters binds bf16 copies of its
    matmul weights into its graphs; every replayed step's ids equal an
    eager ``decode_paged`` on the masters (cast at each use), and its
    token logs equal those of an engine bound to the masters."""
    from repro_torch.runtime import BatchingEngine
    cfg, model, params = _graph_model(cuda)
    assert params["final_norm"].dtype == torch.float32
    kw = dict(n_slots=4, max_len=128, paged=True, page_size=16)
    eng = BatchingEngine(model, params, **kw)
    # wq, wk, wv, wo, wg, wu, wd, each stacked over the layers (tied: no
    # head)
    assert eng.cast_once_leaves == 7
    wq = eng.params["stages"][0]["attn"]["wq"]
    assert wq.dtype == torch.bfloat16
    assert torch.equal(wq, params["stages"][0]["attn"]["wq"].to(wq.dtype))
    assert eng.params["final_norm"] is params["final_norm"]
    prompts = _graph_prompts(cfg.vocab_size)
    reqs = [eng.submit(p, max_new_tokens=12) for p in prompts]
    got = _replay_against_direct(eng, params, cuda)
    assert eng.run_until_idle()
    assert got and all(same for same, _ in got)
    masters = BatchingEngine(model, params, **kw)
    masters.params = params
    want = [masters.submit(p, max_new_tokens=12) for p in prompts]
    assert masters.run_until_idle()
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in want]


@pytest.mark.cuda
def test_engine_buffers_keep_one_graph_through_the_pool_events(cuda):
    """Preemption on an exhausted pool, copy-on-write, scrubbing, a
    hand-off's page export and import with a catch-up step, and short
    contexts replayed token by token all run between replays of one graph
    an engine."""
    from repro_torch.runtime import BatchingEngine
    cfg, model, params = _graph_model(cuda)
    rng = np.random.default_rng(5)
    prompt = lambda n: rng.integers(0, cfg.vocab_size, size=n).astype(
        np.int32)
    kw = dict(max_len=64, paged=True, page_size=16)
    tight = BatchingEngine(model, params, n_slots=4, cache_pages=5, **kw)
    for _ in range(4):
        tight.submit(prompt(20), max_new_tokens=20)
    tight.submit(prompt(2), max_new_tokens=4)
    assert tight.run_until_idle(max_steps=5000)
    assert tight.preemptions > 0 and tight.pool.pages_scrubbed > 0
    cow = BatchingEngine(model, params, n_slots=2, **kw)
    p = prompt(34)
    cow.submit(p, max_new_tokens=2, tenant="t")
    cow.submit(p, max_new_tokens=8, tenant="t")
    assert cow.run_until_idle()
    assert cow.pool.stats()["cow_copies"] >= 1
    src = BatchingEngine(model, params, n_slots=2, **kw)
    dst = BatchingEngine(model, params, n_slots=2, **kw)
    req = src.submit(prompt(20), max_new_tokens=12, tenant="m")
    for _ in range(3):
        src.step()
    payload = src.export_request_pages(req)
    ctx = len(src._ctx_tokens(req))
    src.step()                            # one token the target catches up
    src.drain_tenant("m")
    assert dst.import_request_pages(req, payload, ctx_len=ctx)
    assert dst.run_until_idle() and len(req.out_tokens) == 12
    for e in (tight, cow, src, dst):
        counts = e._greedy.counts()
        assert counts["graphs"] == 1 and counts["captures"] == 1, counts
        assert counts["replays"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["sync", "upload"])
def test_configure_refuses_a_step_that_syncs(cuda, kind):
    """A step that syncs with the host, or uploads from pageable memory,
    cannot be captured: configure raises GraphCaptureError naming the op,
    and the program refuses every later call without running the step."""
    from repro_torch.core import ClusterSpec, Hypervisor
    from repro_torch.core.graphs import GraphCaptureError
    ran = []

    def synced_step(x):
        ran.append(1)
        y = x * 2
        torch.cuda.synchronize()
        return y

    def uploading_step(x):
        ran.append(1)
        return x * torch.tensor(2.0, device=x.device)

    fn = synced_step if kind == "sync" else uploading_step
    hv = Hypervisor(ClusterSpec(n_nodes=1, devices_per_node=1))
    example = (torch.empty((4, 4), device="meta"),)
    with pytest.raises(GraphCaptureError) as err:
        hv.reconfig.configure(fn, example)
    op = "torch.cuda.synchronize()" if kind == "sync" \
        else "torch.tensor(2.0, device=x.device)"
    assert op in str(err.value) and "test_torch_cuda.py" in str(err.value)
    assert len(hv.reconfig.cache) == 0
    from repro_torch.core.graphs import GraphProgram
    program = GraphProgram(fn, cuda)
    x = torch.ones((4, 4), device=cuda)
    with pytest.raises(GraphCaptureError):
        program(x)
    n = len(ran)
    with pytest.raises(GraphCaptureError, match=op.split("(")[0]):
        program(x)
    assert len(ran) == n                 # refused: the step did not run
    torch.cuda.synchronize()             # the card is still usable
    assert float((x * 2).sum()) == 32.0
    # and its allocator still returns cached memory (a failed capture must
    # not leave it routing to the graph's pool)
    torch.cuda.empty_cache()
    before = torch.cuda.memory_reserved()
    y = torch.empty(1 << 30, dtype=torch.uint8, device=cuda)
    del y
    torch.cuda.empty_cache()
    assert torch.cuda.memory_reserved() <= before


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_fleet_engines_bind_one_program_with_a_graph_each(cuda, paged):
    """Two engines of a fleet bind the one configured program; each
    engine's buffers get a graph of their own, every later step replays
    it, and the streams equal a lone engine's."""
    from repro_torch.core import ClusterSpec, Hypervisor
    from repro_torch.core.graphs import GraphProgram
    from repro_torch.runtime import GatewayFleet
    cfg, model, params = _graph_model(cuda)
    hv = Hypervisor(ClusterSpec(n_nodes=1, devices_per_node=2))
    fleet = GatewayFleet(hv, model, params, n_slots=4, max_len=128,
                         paged=paged)
    fleet.open_session("a", slots=4, service_model="rsaas")
    fleet.open_session("b", slots=4, service_model="rsaas")
    engines = list(fleet._engines.values())
    checks = [_replay_against_direct(e, params, cuda) for e in engines]
    reqs = [fleet.submit("ab"[i % 2], p, max_new_tokens=10)
            for i, p in enumerate(_graph_prompts(cfg.vocab_size, n=8))]
    launches.reset()
    fleet.run_until_idle()
    assert all(len(r.out_tokens) == 10 for r in reqs)
    program = hv.reconfig.cache.entry_for(fleet.program_fingerprint).compiled
    assert len(engines) == 2 and isinstance(program, GraphProgram)
    assert all(e._decode_fn is program for e in engines)
    assert len({id(e._greedy) for e in engines}) == 1
    counts = program.counts()
    steps = sum(len(c) for c in checks)
    # configure's capture on its zeros is counted and dropped with them
    assert counts == dict(graphs=2, captures=3, replays=steps - 2,
                          evictions=0), counts
    assert all(same for c in checks for same, _ in c)
    n_dec = "paged_decode_attention" if paged else "decode_attention"
    assert launches[n_dec] == 2 * cfg.n_layers * steps   # replay + direct
    fleet.close()


# ---------------------------------------------------------------------------
# The prefill program and the SSM serve steps as CUDA graphs
# ---------------------------------------------------------------------------

def _tree_equal(a, b):
    from repro_torch.core.graphs import _leaves
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(
        x.shape == y.shape and x.dtype == y.dtype and torch.equal(x, y)
        for x, y in zip(la, lb))


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_prefill_replay_matches_a_direct_call(cuda, paged):
    """An engine's prefill program at three pad buckets (8, 64, 256): the
    first call of a bucket runs eagerly and captures its graph, the next
    replays it on another prompt; every call's hidden states and caches
    (the program's own tree, reset in place) equal a direct eager prefill
    of the same prompt into a new tree, bit for bit. The flash launches
    count executions: one a layer for every call."""
    from repro_torch.runtime import BatchingEngine, clear_prefill_programs
    clear_prefill_programs()
    cfg, model, params = _graph_model(cuda)
    eng = BatchingEngine(model, params, n_slots=4, max_len=256, paged=paged,
                         page_size=16)
    prog = eng._prefill_fn
    rng = np.random.default_rng(3)
    for n in (5, 40, 200):
        for _ in range(2):
            toks = eng._pad_ctx(rng.integers(0, cfg.vocab_size, size=n)
                                .astype(np.int32))
            launches.reset()
            hidden, caches = prog(params, toks)
            assert launches["flash_attention"] == cfg.n_layers
            want_h, want = model.prefill(
                params, {"tokens": torch.from_numpy(toks).to(cuda)}, 256,
                clamp_window=not paged)
            assert torch.equal(hidden, want_h)
            assert _tree_equal(caches, want)
    counts = prog.counts()
    assert (counts["graphs"], counts["captures"], counts["replays"],
            counts["evictions"]) == (3, 3, 3, 0), counts
    clear_prefill_programs()


@pytest.mark.cuda
def test_two_engines_share_one_prefill_program(cuda):
    """Two engines of one model and max_len share the prefill program and,
    sharing params, its graphs: the second engine's prefills all replay
    graphs the first captured, and its streams equal the first's."""
    from repro_torch.runtime import BatchingEngine, clear_prefill_programs
    clear_prefill_programs()
    cfg, model, params = _graph_model(cuda)
    engines = [BatchingEngine(model, params, n_slots=4, max_len=128)
               for _ in range(2)]
    assert engines[0]._prefill_fn is engines[1]._prefill_fn
    prog = engines[0]._prefill_fn
    logs = []
    for eng in engines:
        reqs = [eng.submit(p, max_new_tokens=8)
                for p in _graph_prompts(cfg.vocab_size, n=8)]
        assert eng.run_until_idle()
        logs.append([r.out_tokens for r in reqs])
        if eng is engines[0]:
            first = prog.counts()
    assert logs[0] == logs[1]
    second = prog.counts()
    assert first["captures"] >= 1
    assert second["captures"] == first["captures"]
    assert second["replays"] > first["replays"]
    clear_prefill_programs()


@pytest.mark.cuda
def test_pending_async_prefill_survives_a_replay_of_its_bucket(cuda):
    """A prefill buffered by ``step_async`` is a copy: another engine's
    admission into the same bucket replays the shared program (rewriting
    its caches) before the splice, and the pending request's stream still
    equals a lockstep engine's."""
    from repro_torch.core.graphs import _leaves
    from repro_torch.runtime import BatchingEngine, clear_prefill_programs
    clear_prefill_programs()
    cfg, model, params = _graph_model(cuda)
    rng = np.random.default_rng(9)
    a, b = (rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
            for n in (41, 50))                     # one bucket: 64
    eng = BatchingEngine(model, params, n_slots=4, max_len=128)
    other = BatchingEngine(model, params, n_slots=4, max_len=128)
    req = eng.submit(a, max_new_tokens=8)
    eng.step_async(prefill_chunk=8)
    prog = eng._prefill_fn
    pending = eng._prefilling[0].buf
    owned = {t.data_ptr() for t in _leaves(prog.caches)}
    assert not owned & {t.data_ptr() for t in _leaves(pending)}
    replays = prog.counts()["replays"]
    other.submit(b, max_new_tokens=8)
    other.step()
    assert prog.counts()["replays"] == replays + 1
    while not eng.idle():
        eng.step_async(prefill_chunk=8)
    lone = BatchingEngine(model, params, n_slots=4, max_len=128)
    want = lone.submit(a, max_new_tokens=8)
    assert lone.run_until_idle()
    assert req.out_tokens == want.out_tokens
    clear_prefill_programs()


@pytest.mark.cuda
def test_mamba2_decode_graph_replays_every_step(cuda):
    """mamba2-370m at 4 layers through ``GreedyLoop``: one prefill
    capture, one decode capture, every later step a replay, the buffers'
    addresses fixed; its tokens equal the step factories called eagerly
    (fresh token and position tensors each step)."""
    from repro_torch.configs import get_config
    from repro_torch.core.graphs import _leaves
    from repro_torch.models import Model
    from repro_torch.runtime import (GreedyLoop, make_prefill_step,
                                     make_serve_step)
    cfg = get_config("mamba2-370m").replace(n_layers=4)
    model = Model(cfg, device=cuda)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    for st in params["stages"]:
        for site in (st,) if isinstance(st, dict) else st:
            site["ssm"]["norm"].fill_(1.0)
    B, S, steps = 2, 64, 12
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)).to(cuda)
    loop = GreedyLoop(model, B, S + steps + 1)
    ptrs = [t.data_ptr() for t in _leaves(loop.caches)] + [
        loop.tokens.data_ptr(), loop.pos.data_ptr()]
    _, ids = loop.prefill(params, {"tokens": toks})
    got = [ids.clone()]
    for _ in range(steps):
        _, ids = loop.step(params)
        got.append(ids.clone())
        assert [t.data_ptr() for t in _leaves(loop.caches)] + [
            loop.tokens.data_ptr(), loop.pos.data_ptr()] == ptrs
    counts = loop.counts()
    assert counts["prefill"]["captures"] == 1
    assert counts["decode"] == dict(graphs=1, captures=1,
                                    replays=steps - 1, evictions=0)
    h, caches = make_prefill_step(model, S + steps + 1)(params,
                                                        {"tokens": toks})
    nxt = model.logits(params, h[:, -1:])[:, 0].argmax(-1).to(torch.int32)
    want = [nxt]
    step = make_serve_step(model)
    pos = torch.full((B,), S, dtype=torch.int32, device=cuda)
    for _ in range(steps):
        lg, caches = step(params, caches, nxt[:, None], pos)
        nxt = lg[:, 0].argmax(-1).to(torch.int32)
        want.append(nxt)
        pos = pos + 1
    assert torch.equal(torch.stack(got), torch.stack(want))
    loop.close()


# ---------------------------------------------------------------------------
# The training program (runtime.train.train_program): one CUDA graph a
# binding of (state, batch buffers), the state updated in place
# ---------------------------------------------------------------------------

def _train_setup(cuda, layers=2, B=2, S=128):
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, DataPipeline
    from repro_torch.models import get_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import TrainOpts, init_train_state
    cfg = get_config("smollm-135m").replace(n_layers=layers,
                                            dtype="float32")
    model = get_model(cfg, device=cuda)
    opts = TrainOpts(opt=AdamWConfig(lr=1e-3, warmup_steps=2,
                                     total_steps=20), loss_chunk=64)
    state = init_train_state(model,
                             torch.Generator(device=cuda).manual_seed(0),
                             opts)
    data = DataPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=S,
                                   batch_size=B))
    return model, opts, state, data


@pytest.mark.cuda
@pytest.mark.parametrize("variant", [{}, {"remat": True},
                                     {"microbatches": 2}],
                         ids=["plain", "remat", "micro2"])
def test_train_program_replays_the_eager_step(cuda, variant):
    """3 steps of smollm at full width (2 layers, fp32) through
    ``train_program`` against 3 eager in-place steps from one state on one
    batch a step (numpy for the program's first two, a device tensor at a
    new address for its third): metrics and every state leaf bit-equal,
    one capture and then replays, the state at its addresses, and the
    metrics of successive calls distinct tensors that keep their values."""
    import dataclasses
    from repro_torch.runtime import make_inplace_train_step, train_program
    from repro_torch.tree import flatten
    model, opts, state, data = _train_setup(cuda)
    opts = dataclasses.replace(opts, **variant)
    eager, program = make_inplace_train_step(model, opts), \
        train_program(model, opts)
    se, sg = _clone_tree(state), _clone_tree(state)
    ptrs = [t.data_ptr() for t in flatten(sg)[0]]
    kept, want = [], []
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for i in range(3):
            batch = data.batch_at(i)
            se, m = eager(se, batch)
            want.append({k: v.clone() for k, v in m.items()})
            if i == 2:
                batch = {k: torch.from_numpy(v).to(cuda)
                         for k, v in batch.items()}
            sg, got = program(sg, batch)
            kept.append(got)
    finally:
        torch.use_deterministic_algorithms(False)
    assert program.graphs.counts() == dict(graphs=1, captures=1, replays=2,
                                           evictions=0)
    assert [t.data_ptr() for t in flatten(sg)[0]] == ptrs
    assert len({id(m["loss"]) for m in kept}) == 3
    for got, w in zip(kept, want):
        for k in w:
            assert torch.equal(got[k], w[k]), k
    for i, (a, b) in enumerate(zip(flatten(se)[0], flatten(sg)[0])):
        assert torch.equal(a, b), f"leaf {i}"
    program.graphs.close()


@pytest.mark.cuda
def test_train_program_refuses_a_step_that_syncs(cuda):
    """A training step whose loss is read on the host cannot be captured:
    its first call runs eagerly, then the capture raises GraphCaptureError
    naming the line, and every later call is refused (no eager fallback)."""
    from repro_torch.core.graphs import GraphCaptureError
    from repro_torch.runtime import TrainProgram, make_inplace_train_step
    model, opts, state, data = _train_setup(cuda, layers=1, S=64)
    inner = make_inplace_train_step(model, opts)
    ran = []

    def syncing_step(state, batch):
        ran.append(1)
        state, m = inner(state, batch)
        if m["loss"].item() > 1e9:
            raise ValueError("diverged")
        return state, m

    program = TrainProgram(syncing_step, cuda, name="syncing")
    with pytest.raises(GraphCaptureError) as err:
        program(state, data.batch_at(0))
    assert 'm["loss"].item()' in str(err.value)
    assert "test_torch_cuda.py" in str(err.value)
    n = len(ran)
    with pytest.raises(GraphCaptureError):
        program(state, data.batch_at(1))
    assert len(ran) == n
    torch.cuda.synchronize()             # the card is still usable
