"""Split-K decode attention on the CPU: the split plan and the plain
versions of the split and merge passes (``decode_partials_ref``,
``merge_partials_ref``) against the plain dense and paged decode versions,
which tests/test_torch_kernels.py holds against the JAX package, and
against the JAX package's own oracle here. The CUDA split and merge kernels
are held against the plain versions on the card in tests/test_torch_cuda.py.

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
