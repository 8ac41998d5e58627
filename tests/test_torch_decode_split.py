"""Split-K decode attention on the CPU: the split plan, the head-chunk plan
(``head_chunks``: a group past 8 query heads a kv head, or past 4 at a head
dim past 256, runs in chunks, each its own split and merge blocks), and the
plain versions of the split and merge passes (``decode_partials_ref``,
``merge_partials_ref``) against the plain dense and paged decode versions,
which tests/test_torch_kernels.py holds against the JAX package, and
against the JAX package's own oracle here (groups 16 and 71 among them).
The CUDA split and merge kernels are held against the plain versions on
the card in tests/test_torch_cuda.py.

Tolerance: atol 2e-5, rtol 2e-4 in float32 (the reference's own; the split
sweep sums in another order).
"""
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import _lib
from repro_torch.kernels import decode_attention as tda

torch.set_num_threads(1)

TOL = dict(atol=2e-5, rtol=2e-4)


def _normal(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _quant(x):
    amax = np.abs(x).max(-1)
    s = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    return np.clip(np.round(x / s[..., None]), -127, 127).astype(np.int8), s


# ---------------------------------------------------------------------------
# The split plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bh,capacity,sms,unit", [
    (3, 2048, 132, 16), (24, 2048, 132, 16), (192, 2048, 132, 16),
    (24, 2000, 132, 16), (24, 2048, 132, 64), (1, 100_000, 132, 16),
    (7, 33, 132, 16), (2, 64, 132, 16), (131, 4096, 132, 16),
    (132, 4096, 132, 16), (5, 1000, 8, 32), (1, 1, 132, 16)])
def test_split_plan_covers_every_row_once(bh, capacity, sms, unit):
    n, rows = tda.split_plan(bh, capacity, sms, unit)
    assert 1 <= n <= tda.MAX_SPLITS and rows % unit == 0
    covered = [range(i * rows, min(capacity, (i + 1) * rows))
               for i in range(n)]
    assert all(len(r) > 0 for r in covered)          # no split is empty
    assert sorted(t for r in covered for t in r) == list(range(capacity))
    if n > 1:
        assert rows >= tda.MIN_SPLIT_ROWS
    if bh >= sms:
        assert n == 1


@pytest.mark.parametrize("B,n_split", [(1, 32), (8, 11), (64, 1)])
@pytest.mark.parametrize("unit", [16, 1])
def test_split_plan_at_the_serving_shapes(B, n_split, unit):
    """smollm-135m (3 kv heads) at L 2048 on 132 SMs: many splits at B 1,
    about two blocks per SM at B 8, one split once B*Hkv fills the card."""
    assert tda.split_plan(B * 3, 2048, 132, unit)[0] == n_split


# ---------------------------------------------------------------------------
# Split pass + merge pass == the plain sweep
# ---------------------------------------------------------------------------

def _dense_inputs(B, hq, hkv, L, D, cur, seed, quant=False):
    """Row b holds positions 0..L-1 except an empty (-1) tail of 40 slots
    in row 0; cur far below L in row 0 leaves most splits with no valid
    key, cur = -1 makes an idle row."""
    rng = np.random.default_rng(seed)
    kpos = np.broadcast_to(np.arange(L, dtype=np.int32), (B, L)).copy()
    kpos[0, L - 40:] = -1
    q, k, v = (_normal(rng, s) for s in ((B, hq, D), (B, hkv, L, D),
                                         (B, hkv, L, D)))
    ks = vs = None
    if quant:
        k, ks = _quant(k)
        v, vs = _quant(v)
    t = {n: (None if a is None else torch.from_numpy(a)) for n, a in
         dict(q=q, k=k, v=v, kpos=kpos, cur=np.asarray(cur, np.int32),
              k_scale=ks, v_scale=vs).items()}
    return t


def _mean_v(v, v_scale, g):
    vf = v.float() * (1.0 if v_scale is None else v_scale[..., None])
    return vf.mean(dim=2).repeat_interleave(g, dim=1)


@pytest.mark.parametrize("split_rows", [64, 96, 192, 512])
@pytest.mark.parametrize("window", [0, 128])
@pytest.mark.parametrize("quant", [False, True])
def test_merge_of_split_sweep_matches_dense(split_rows, window, quant):
    B, Hq, Hkv, D, L = 4, 9, 3, 64, 500
    t = _dense_inputs(B, Hq, Hkv, L, D, [30, -1, 499, 250], seed=1,
                      quant=quant)
    opt = dict(window=window, k_scale=t["k_scale"], v_scale=t["v_scale"])
    args = (t["q"], t["k"], t["v"], t["kpos"], t["cur"])
    acc, m, l = tda.decode_partials_ref(*args, split_rows, **opt)
    n = -(-L // split_rows)
    assert acc.shape == (B, Hq, n, D) and m.shape == l.shape == (B, Hq, n)
    assert torch.isinf(m[1]).all() and (l[1] == 0).all()     # idle row
    if split_rows < 500:       # row 0 (cur 30): splits past it are empty
        assert torch.isinf(m[0, :, 1:]).all() and (acc[0, :, 1:] == 0).all()
    got = tda.merge_partials_ref(acc, m, l,
                                 _mean_v(t["v"], t["v_scale"], Hq // Hkv))
    ref = tda.decode_attention_ref(*args, **opt)
    torch.testing.assert_close(got, ref, **TOL)


def test_merge_of_split_sweep_matches_jax():
    """The same split + merge against the JAX package's decode oracle."""
    B, Hq, Hkv, D, L = 3, 8, 2, 32, 300
    t = _dense_inputs(B, Hq, Hkv, L, D, [299, -1, 100], seed=4)
    args = (t["q"], t["k"], t["v"], t["kpos"], t["cur"])
    acc, m, l = tda.decode_partials_ref(*args, 64)
    got = tda.merge_partials_ref(acc, m, l, _mean_v(t["v"], None, Hq // Hkv))
    ref = jops.decode_attention(*(a.numpy() for a in args), force="ref")
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("quant", [False, True])
def test_merge_of_split_sweep_matches_paged(quant):
    """Block tables with null pages (page 0, kpos -1) and a page named
    twice: the splits cover whole block-table entries; an idle row averages
    every V row its table names, null and repeated pages included."""
    B, Hq, Hkv, D, ps, nb, P = 3, 6, 3, 64, 16, 12, 40
    rng = np.random.default_rng(9)
    kp, vp = _normal(rng, (P, Hkv, ps, D)), _normal(rng, (P, Hkv, ps, D))
    ksp = vsp = None
    if quant:
        kp, ksp = _quant(kp)
        vp, vsp = _quant(vp)
    kpp = np.arange(P * ps, dtype=np.int32).reshape(P, ps) % (nb * ps)
    kpp[0] = -1                                        # the null page
    bt = rng.permutation(np.arange(1, P))[:B * nb].reshape(B, nb)
    bt = bt.astype(np.int32)
    bt[0, 8:] = 0                                      # unused entries
    bt[2, 5] = bt[2, 3]                                # a repeated page
    cur = np.asarray([150, -1, nb * ps - 1], np.int32)
    t = {n: (None if a is None else torch.from_numpy(np.ascontiguousarray(a)))
         for n, a in dict(q=_normal(rng, (B, Hq, D)), kp=kp, vp=vp, kpp=kpp,
                          bt=bt, cur=cur, ks=ksp, vs=vsp).items()}
    ref = tda.paged_decode_attention_ref(
        t["q"], t["kp"], t["vp"], t["kpp"], t["bt"], t["cur"],
        k_scale=t["ks"], v_scale=t["vs"])
    # the split pass sees the rows through the block table, as the kernel
    bt_l = t["bt"].long()

    def rows(pool):
        return pool[bt_l].movedim(2, 1).reshape(
            (B, Hkv, nb * ps) + tuple(pool.shape[3:]))

    dense = dict(k=rows(t["kp"]), v=rows(t["vp"]),
                 k_scale=None if t["ks"] is None else rows(t["ks"]),
                 v_scale=None if t["vs"] is None else rows(t["vs"]))
    split_rows = tda.split_plan(B * Hkv, nb * ps, 132, unit=ps)[1]
    acc, m, l = tda.decode_partials_ref(
        t["q"], dense["k"], dense["v"], t["kpp"][bt_l].reshape(B, nb * ps),
        t["cur"], split_rows, k_scale=dense["k_scale"],
        v_scale=dense["v_scale"])
    assert torch.isinf(m[1]).all()
    got = tda.merge_partials_ref(acc, m, l, _mean_v(dense["v"],
                                                    dense["v_scale"], 2))
    torch.testing.assert_close(got, ref.float(), **TOL)


# ---------------------------------------------------------------------------
# Head chunks: any group, MQA included
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [64, 256, 264, 512])
@pytest.mark.parametrize("g", [1, 3, 4, 5, 8, 9, 16, 48, 64, 71])
def test_head_chunks_cover_every_head_once(g, d):
    """Chunks of at most 8 heads (4 past D 256), as few as that allows, the
    last holding the rest; a group of up to 8 (4) is one chunk, as before
    chunks existed."""
    heads, n = tda.head_chunks(g, d)
    most = tda.CHUNK_HEADS if d <= tda.MAX_PADDED_HEAD_DIM \
        else tda.WIDE_CHUNK_HEADS
    assert 1 <= heads <= most and n == -(-g // most)
    cover = [h for c in range(n)
             for h in range(c * heads, min(g, (c + 1) * heads))]
    assert cover == list(range(g))
    assert all(c * heads < g for c in range(n))       # no chunk is empty
    if g <= most:
        assert (heads, n) == (g, 1)


def _chunked_sweep(t, split_rows=None, paged_rows=None, **opt):
    """The kernel's plan on the CPU: each kv head's group is cut into
    ``head_chunks``; a chunk's heads go through the split pass
    (``decode_partials_ref`` over ``split_plan``'s rows for B * Hkv *
    chunks blocks, or ``split_rows``) and the merge pass on their own, and
    their outputs land at the chunk's heads. Returns (out, (heads, n))."""
    q, k, v = t["q"], t["k"], t["v"]
    B, Hq, D = q.shape
    Hkv, L = k.shape[1], k.shape[2]
    g = Hq // Hkv
    heads, n = tda.head_chunks(g, D)
    if split_rows is None:
        split_rows = tda.split_plan(B * Hkv * n, L, 132,
                                    unit=paged_rows or 16)[1]
    out = torch.empty((B, Hkv, g, D))
    qg = q.reshape(B, Hkv, g, D)
    for c in range(n):
        lo, hi = c * heads, min(g, (c + 1) * heads)
        qc = qg[:, :, lo:hi].reshape(B, Hkv * (hi - lo), D)
        acc, m, l = tda.decode_partials_ref(qc, k, v, t["kpos"], t["cur"],
                                            split_rows, **opt)
        o = tda.merge_partials_ref(acc, m, l,
                                   _mean_v(v, opt.get("v_scale"), hi - lo))
        out[:, :, lo:hi] = o.reshape(B, Hkv, hi - lo, D)
    return out.reshape(B, Hq, D), (heads, n)


@pytest.mark.parametrize("hq,hkv,d,plan", [
    (32, 2, 64, (8, 2)),          # g 16: Qwen3-235B-A22B's group
    (71, 1, 64, (8, 9)),          # g 71: Falcon-7B's MQA
    (48, 1, 32, (8, 6)),          # g 48: StarCoder's MQA
    (16, 1, 264, (4, 4))])        # g 16 past D 256: chunks of 4
@pytest.mark.parametrize("window,quant", [(0, False), (128, False),
                                          (0, True)])
def test_chunked_split_sweep_matches_dense(hq, hkv, d, plan, window, quant):
    B, L = 3, 300
    t = _dense_inputs(B, hq, hkv, L, d, [29, -1, 299], seed=hq + d,
                      quant=quant)
    opt = dict(window=window, k_scale=t["k_scale"], v_scale=t["v_scale"])
    got, got_plan = _chunked_sweep(t, split_rows=64, **opt)
    assert got_plan == plan
    ref = tda.decode_attention_ref(t["q"], t["k"], t["v"], t["kpos"],
                                   t["cur"], **opt)
    torch.testing.assert_close(got, ref, **TOL)


@pytest.mark.parametrize("hq,hkv", [(16, 1), (32, 2), (71, 1)])
def test_chunked_split_sweep_matches_jax(hq, hkv):
    """The chunk plan at g 16 and 71 against the JAX package's decode
    oracle, split rows as ``split_plan`` cuts them for the chunked grid."""
    t = _dense_inputs(3, hq, hkv, 300, 64, [299, -1, 100], seed=hq)
    got, _ = _chunked_sweep(t)
    ref = jops.decode_attention(*(t[n].numpy() for n in (
        "q", "k", "v", "kpos", "cur")), force="ref")
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_chunked_split_sweep_matches_paged():
    """g 16 over a paged pool's rows (split rows whole pages of 16)."""
    B, Hq, Hkv, D, ps, nb, P = 2, 16, 1, 64, 16, 8, 20
    rng = np.random.default_rng(16)
    kp, vp = _normal(rng, (P, Hkv, ps, D)), _normal(rng, (P, Hkv, ps, D))
    kpp = np.arange(P * ps, dtype=np.int32).reshape(P, ps) % (nb * ps)
    kpp[0] = -1
    bt = rng.permutation(np.arange(1, P))[:B * nb].reshape(B, nb)
    bt = bt.astype(np.int32)
    bt[1, 6:] = 0
    t = {n: torch.from_numpy(np.ascontiguousarray(a)) for n, a in dict(
        q=_normal(rng, (B, Hq, D)), kp=kp, vp=vp, kpp=kpp, bt=bt,
        cur=np.asarray([nb * ps - 1, 90], np.int32)).items()}
    ref = tda.paged_decode_attention_ref(t["q"], t["kp"], t["vp"], t["kpp"],
                                         t["bt"], t["cur"])
    bt_l = t["bt"].long()

    def rows(pool):
        return pool[bt_l].movedim(2, 1).reshape(
            (B, Hkv, nb * ps) + tuple(pool.shape[3:]))

    dense = dict(q=t["q"], k=rows(t["kp"]), v=rows(t["vp"]),
                 kpos=t["kpp"][bt_l].reshape(B, nb * ps), cur=t["cur"])
    got, plan = _chunked_sweep(dense, paged_rows=ps)
    assert plan == (8, 2)
    torch.testing.assert_close(got, ref.float(), **TOL)


# ---------------------------------------------------------------------------
# Row alignment check (the kernels' vector and cp.async row copies)
# ---------------------------------------------------------------------------

def test_check_rows_aligned_refuses_misaligned_views():
    base = torch.zeros((2, 3, 8, 72), dtype=torch.bfloat16)
    _lib.check_rows_aligned("k", "q", base[..., :64])        # 144-byte rows
    with pytest.raises(ValueError, match="16-byte aligned"):
        _lib.check_rows_aligned("k", "q", base[..., 4:68])   # base 8 B off
    odd = torch.zeros((2, 3, 8, 68), dtype=torch.bfloat16)[..., :64]
    with pytest.raises(ValueError, match="16-byte aligned"):
        _lib.check_rows_aligned("k", "q", odd)               # 136-byte rows
    _lib.check_rows_aligned("k", "v", odd, 8)                # 8 bytes do
    one = torch.zeros((1, 1, 1, 64), dtype=torch.bfloat16)
    _lib.check_rows_aligned("k", "q", one.as_strided(one.shape, (3, 3, 3, 1)))
