"""Port kernels: the plain PyTorch versions in ``repro_torch.kernels`` against
the JAX package's Pallas kernels (interpret mode) and pure-jnp oracles, on
the cases of tests/test_kernels.py. The CUDA kernels themselves are held
against the plain versions on the card in tests/test_torch_cuda.py.

Tolerance: atol 2e-5, rtol 2e-4 in float32 (the reference's own, covering
summation-order differences of the online softmax).

A decode row with no valid key (an idle slot, cur = -1) returns the mean of
the swept V rows on both sides, and is compared like any other row.
"""
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import decode_attention as tda
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import launches, ops

torch.set_num_threads(1)

TOL = dict(atol=2e-5, rtol=2e-4)


def _normal(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _quant(x):
    amax = np.abs(x).max(-1)
    s = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.round(x / s[..., None]), -127, 127).astype(np.int8)
    return q, s


# ---------------------------------------------------------------------------
# Flash prefill
# ---------------------------------------------------------------------------

def _flash_inputs(b, hq, hkv, s, d, seed=0):
    rng = np.random.default_rng(seed)
    return (_normal(rng, (b, hq, s, d)), _normal(rng, (b, hkv, s, d)),
            _normal(rng, (b, hkv, s, d)))


@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2), (8, 1)])
@pytest.mark.parametrize("window", [0, 64])
@pytest.mark.parametrize("s", [256, 512])
def test_flash_plain_matches_reference(hq, hkv, window, s):
    q, k, v = _flash_inputs(2, hq, hkv, s, 64)
    got = tfa.flash_attention_ref(_t(q), _t(k), _t(v), window=window).numpy()
    for force in ("ref", "interpret"):
        ref = jops.flash_attention(q, k, v, window=window, force=force)
        np.testing.assert_allclose(got, np.asarray(ref), **TOL)


def test_flash_plain_softcap():
    q, k, v = _flash_inputs(1, 2, 2, 256, 32)
    got = tfa.flash_attention_ref(_t(q), _t(k), _t(v), softcap=50.0).numpy()
    for force in ("ref", "interpret"):
        ref = jops.flash_attention(q, k, v, softcap=50.0, force=force)
        np.testing.assert_allclose(got, np.asarray(ref), **TOL)


# ---------------------------------------------------------------------------
# Dense decode
# ---------------------------------------------------------------------------

def _decode_inputs(B, hq, hkv, L, D, cur, fill=100, seed=1):
    rng = np.random.default_rng(seed)
    kpos = np.broadcast_to(np.arange(L, dtype=np.int32)[None], (B, L))
    kpos = np.where(kpos < L - fill, kpos, -1).astype(np.int32)
    return (_normal(rng, (B, hq, D)), _normal(rng, (B, hkv, L, D)),
            _normal(rng, (B, hkv, L, D)), kpos, np.asarray(cur, np.int32))


@pytest.mark.parametrize("hq,hkv,L", [(8, 2, 512), (4, 4, 1024),
                                      (16, 1, 512)])
@pytest.mark.parametrize("window", [0, 128])
def test_decode_plain_matches_reference(hq, hkv, L, window):
    q, k, v, kpos, cur = _decode_inputs(2, hq, hkv, L, 64, [L - 150, L // 3])
    got = tda.decode_attention_ref(_t(q), _t(k), _t(v), _t(kpos), _t(cur),
                                   window=window).numpy()
    for force in ("ref", "interpret"):
        ref = jops.decode_attention(q, k, v, kpos, cur, window=window,
                                    force=force)
        np.testing.assert_allclose(got, np.asarray(ref), **TOL)


def test_decode_plain_int8_cache():
    B, Hq, Hkv, D, L = 2, 8, 2, 64, 1024
    q, kf, vf, kpos, cur = _decode_inputs(B, Hq, Hkv, L, D, [800, 333],
                                          fill=0, seed=5)
    k8, ks = _quant(kf)
    v8, vs = _quant(vf)
    got = tda.decode_attention_ref(_t(q), _t(k8), _t(v8), _t(kpos), _t(cur),
                                   k_scale=_t(ks), v_scale=_t(vs)).numpy()
    for force in ("ref", "interpret"):
        ref = jops.decode_attention(q, k8, v8, kpos, cur, k_scale=ks,
                                    v_scale=vs, force=force)
        np.testing.assert_allclose(got, np.asarray(ref), **TOL)


@pytest.mark.parametrize("pieces", [2, 4])
@pytest.mark.parametrize("window", [0, 128])
@pytest.mark.parametrize("quant", [False, True])
def test_decode_plain_pieces_merge_by_lse(pieces, window, quant):
    """A cache's length cut into equal pieces (as ranks hold it): each
    piece's output and log-sum-exp (``return_lse``), merged by
    ``merge_by_lse``, give the whole cache's output, which is the JAX
    reference's. Row 0 has keys in every piece, row 1 is idle (the mean of
    V), row 2's keys all lie in the first piece; the log-sum-exp is that
    of the scaled, masked scores."""
    B, Hq, Hkv, D, L = 3, 8, 2, 64, 512
    q, k, v, kpos, cur = _decode_inputs(B, Hq, Hkv, L, D, [L - 150, -1, 40],
                                        fill=100, seed=9)
    ks = vs = None
    if quant:
        k, ks = _quant(k)
        v, vs = _quant(v)
    opt = {n: _t(x) for n, x in (("k_scale", ks), ("v_scale", vs))
           if x is not None}
    whole, lse = tda.decode_attention_ref(
        _t(q), _t(k), _t(v), _t(kpos), _t(cur), window=window,
        return_lse=True, **opt)
    ref = jops.decode_attention(q, k, v, kpos, cur, window=window,
                                k_scale=ks, v_scale=vs, force="ref")
    np.testing.assert_allclose(whole.numpy(), np.asarray(ref), **TOL)
    kd = _t(k).float() * (opt["k_scale"][..., None] if quant else 1.0)
    sc = torch.einsum("bhd,bhld->bhl", _t(q) * D ** -0.5,
                      kd.repeat_interleave(Hq // Hkv, dim=1))
    c = _t(cur)[:, None]
    ok = (_t(kpos) >= 0) & (_t(kpos) <= c)
    if window:
        ok &= (c - _t(kpos)) < window
    want = torch.logsumexp(sc.masked_fill(~ok[:, None], float("-inf")), -1)
    torch.testing.assert_close(lse, want, atol=1e-5, rtol=1e-6)
    assert torch.isinf(lse[1]).all() and not torch.isinf(lse[0]).any()
    n = L // pieces
    outs, lses = zip(*(tda.decode_attention_ref(
        _t(q), _t(k)[:, :, i * n:(i + 1) * n], _t(v)[:, :, i * n:(i + 1) * n],
        _t(kpos)[:, i * n:(i + 1) * n], _t(cur), window=window,
        return_lse=True, **{m: x[:, :, i * n:(i + 1) * n]
                            for m, x in opt.items()})
        for i in range(pieces)))
    got, got_lse = tda.merge_by_lse(torch.stack(outs), torch.stack(lses))
    torch.testing.assert_close(got, whole.float(), **TOL)
    torch.testing.assert_close(got_lse, lse, atol=1e-5, rtol=1e-6)


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("quant", [False, True])
def test_decode_plain_idle_slot_is_mean_of_v(paged, quant):
    """cur = -1 masks every key: the idle row is the mean of the swept V
    rows (dequantized on the int8 path), as in the reference, and every
    row matches the reference."""
    B, Hq, Hkv, D, L, ps = 3, 6, 3, 64, 256, 32
    q, k, v, kpos, cur = _decode_inputs(B, Hq, Hkv, L, D, [200, -1, 17])
    ks = vs = None
    if quant:
        k, ks = _quant(k)
        v, vs = _quant(v)
    v_deq = v.astype(np.float32) * (vs[..., None] if quant else 1.0)
    mean_v = np.repeat(v_deq[1].mean(axis=1), Hq // Hkv, axis=0)
    opt = dict(k_scale=ks, v_scale=vs)
    if paged:
        kp, vp, kpp, bt = _scatter_to_pool(k, v, kpos, 2 * B * L // ps, ps)
        if quant:
            ksp, vsp, _, _ = _scatter_to_pool(ks[..., None], vs[..., None],
                                              kpos, 2 * B * L // ps, ps)
            opt = dict(k_scale=ksp[..., 0], v_scale=vsp[..., 0])
        args = (q, kp, vp, kpp, bt, cur)
        got = tda.paged_decode_attention_ref(
            *(_t(a) for a in args),
            **{n: _t(x) for n, x in opt.items() if x is not None}).numpy()
        ref = jops.paged_decode_attention(*args, **opt, force="ref")
    else:
        args = (q, k, v, kpos, cur)
        got = tda.decode_attention_ref(
            *(_t(a) for a in args),
            **{n: _t(x) for n, x in opt.items() if x is not None}).numpy()
        ref = jops.decode_attention(*args, **opt, force="ref")
    np.testing.assert_allclose(got[1], mean_v, **TOL)
    np.testing.assert_allclose(got, np.asarray(ref), **TOL)


# ---------------------------------------------------------------------------
# Paged decode
# ---------------------------------------------------------------------------

def _scatter_to_pool(k, v, kpos, n_pages, page_size, seed=0):
    """Chop a dense (B, Hkv, L, D) cache into shuffled pool pages + block
    tables (page 0 left empty — the engine's reserved null page)."""
    B, Hkv, L, D = k.shape
    nb = L // page_size
    rng = np.random.default_rng(seed)
    pages = rng.permutation(np.arange(1, n_pages))[:B * nb] \
        .reshape(B, nb).astype(np.int32)
    k_pool = np.zeros((n_pages, Hkv, page_size, D), k.dtype)
    v_pool = np.zeros((n_pages, Hkv, page_size, D), v.dtype)
    kpos_pool = np.full((n_pages, page_size), -1, np.int32)
    for b in range(B):
        for j in range(nb):
            sl = slice(j * page_size, (j + 1) * page_size)
            k_pool[pages[b, j]] = k[b, :, sl]
            v_pool[pages[b, j]] = v[b, :, sl]
            kpos_pool[pages[b, j]] = kpos[b, sl]
    return k_pool, v_pool, kpos_pool, pages


@pytest.mark.parametrize("hq,hkv", [(8, 2), (4, 4)])
@pytest.mark.parametrize("window", [0, 128])
def test_paged_plain_matches_reference(hq, hkv, window):
    B, D, ps, nb = 2, 64, 64, 8
    L = nb * ps
    q, k, v, kpos, cur = _decode_inputs(B, hq, hkv, L, D, [L - 100, L // 3],
                                        fill=70, seed=2)
    kp, vp, kpp, bt = _scatter_to_pool(k, v, kpos, 2 * B * nb, ps)
    got = tda.paged_decode_attention_ref(_t(q), _t(kp), _t(vp), _t(kpp),
                                         _t(bt), _t(cur),
                                         window=window).numpy()
    for force in ("ref", "interpret"):
        ref = jops.paged_decode_attention(q, kp, vp, kpp, bt, cur,
                                          window=window, force=force)
        np.testing.assert_allclose(got, np.asarray(ref), **TOL)


def test_paged_plain_int8_pool():
    B, Hq, Hkv, D, ps, nb = 2, 8, 2, 64, 32, 8
    L = nb * ps
    q, kf, vf, kpos, cur = _decode_inputs(B, Hq, Hkv, L, D, [200, 77],
                                          fill=0, seed=6)
    k8, ks = _quant(kf)
    v8, vs = _quant(vf)
    kp, vp, kpp, bt = _scatter_to_pool(k8, v8, kpos, 2 * B * nb, ps)
    ksp, vsp, _, _ = _scatter_to_pool(ks[..., None], vs[..., None], kpos,
                                      2 * B * nb, ps)
    ksp, vsp = ksp[..., 0], vsp[..., 0]
    got = tda.paged_decode_attention_ref(
        _t(q), _t(kp), _t(vp), _t(kpp), _t(bt), _t(cur), k_scale=_t(ksp),
        v_scale=_t(vsp)).numpy()
    for force in ("ref", "interpret"):
        ref = jops.paged_decode_attention(q, kp, vp, kpp, bt, cur,
                                          k_scale=ksp, v_scale=vsp,
                                          force=force)
        np.testing.assert_allclose(got, np.asarray(ref), **TOL)


# ---------------------------------------------------------------------------
# The head dims the kernels took on for phi3-mini (96), zamba2 (112) and the
# gemma families (256): the plain versions the card holds them against
# agree with the reference's Pallas kernels there too
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [96, 112, 256])
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (48, 30.0)])
def test_flash_plain_new_head_dims(d, window, softcap):
    q, k, v = _flash_inputs(1, 4, 2, 256, d, seed=d)
    got = tfa.flash_attention_ref(_t(q), _t(k), _t(v), window=window,
                                  softcap=softcap).numpy()
    for force in ("ref", "interpret"):
        ref = jops.flash_attention(q, k, v, window=window, softcap=softcap,
                                   force=force)
        np.testing.assert_allclose(got, np.asarray(ref), **TOL)


@pytest.mark.parametrize("d", [96, 112, 256])
@pytest.mark.parametrize("quant", [False, True])
def test_decode_plain_new_head_dims(d, quant):
    """Dense and paged, g 4, a window, an idle row (the mean of V)."""
    B, Hq, Hkv, ps, nb = 3, 8, 2, 32, 8
    L = nb * ps
    q, k, v, kpos, cur = _decode_inputs(B, Hq, Hkv, L, d, [L - 40, -1, 90],
                                        fill=20, seed=d)
    opt = dict(window=128)
    if quant:
        k, ks = _quant(k)
        v, vs = _quant(v)
        opt.update(k_scale=ks, v_scale=vs)
    tt = {n: _t(x) if isinstance(x, np.ndarray) else x
          for n, x in opt.items()}
    got = tda.decode_attention_ref(_t(q), _t(k), _t(v), _t(kpos), _t(cur),
                                   **tt).numpy()
    for force in ("ref", "interpret"):
        ref = jops.decode_attention(q, k, v, kpos, cur, **opt, force=force)
        np.testing.assert_allclose(got, np.asarray(ref), **TOL)
    kp, vp, kpp, bt = _scatter_to_pool(k, v, kpos, 2 * B * nb, ps)
    popt = dict(window=128)
    if quant:
        ksp, vsp, _, _ = _scatter_to_pool(ks[..., None], vs[..., None], kpos,
                                          2 * B * nb, ps)
        popt.update(k_scale=ksp[..., 0], v_scale=vsp[..., 0])
    tt = {n: _t(x) if isinstance(x, np.ndarray) else x
          for n, x in popt.items()}
    got = tda.paged_decode_attention_ref(_t(q), _t(kp), _t(vp), _t(kpp),
                                         _t(bt), _t(cur), **tt).numpy()
    for force in ("ref", "interpret"):
        ref = jops.paged_decode_attention(q, kp, vp, kpp, bt, cur, **popt,
                                          force=force)
        np.testing.assert_allclose(got, np.asarray(ref), **TOL)


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------

def test_ops_take_the_plain_version_on_cpu():
    """A CPU tensor takes the plain version and launches nothing."""
    launches.reset()
    q, k, v, kpos, cur = _decode_inputs(2, 4, 2, 64, 32, [40, 9], fill=8)
    a = ops.decode_attention(_t(q), _t(k), _t(v), _t(kpos), _t(cur))
    b = tda.decode_attention_ref(_t(q), _t(k), _t(v), _t(kpos), _t(cur))
    assert torch.equal(a, b)
    qf, kf, vf = _flash_inputs(1, 4, 2, 40, 32)
    assert torch.equal(ops.flash_attention(_t(qf), _t(kf), _t(vf)),
                       tfa.flash_attention_ref(_t(qf), _t(kf), _t(vf)))
    assert all(n == 0 for n in launches.values())


def test_cuda_wrappers_refuse_cpu_tensors():
    """A kernel wrapper given CPU tensors raises; it never falls back."""
    q, k, v, kpos, cur = (_t(a) for a in _decode_inputs(1, 2, 1, 16, 32, [3],
                                                        fill=0))
    with pytest.raises(ValueError, match="CUDA tensors"):
        tda.decode_attention_cuda(q, k, v, kpos, cur)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tda.paged_decode_attention_cuda(q, k, v, kpos,
                                        torch.zeros((1, 1), dtype=torch.int32),
                                        cur)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tfa.flash_attention_cuda(*(_t(a) for a in _flash_inputs(1, 2, 1, 8,
                                                                32)))
