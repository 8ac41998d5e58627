"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card. Imports nothing of JAX, so it runs on a machine without it:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Without a CUDA device every test skips. Tolerances: atol 2e-5, rtol 2e-4 in
float32; atol 2e-2, rtol 2e-2 in bfloat16 (both sides accumulate in fp32
and round once to bf16; they differ by summation order).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import decode_attention as tda
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import launches

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
    (cur = -1: the kernel returns 0 there)."""
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
    assert not got[1].float().abs().any()
    kp, vp, kpp, bt, scatter = _to_pool(k, v, kpos, ps, seed=4)
    pks = None if ks is None else scatter(ks, 1.0).to(cuda)
    pvs = None if vs is None else scatter(vs, 1.0).to(cuda)
    got_p = tda.paged_decode_attention_cuda(
        dev[0], kp.to(cuda), vp.to(cuda), kpp.to(cuda), bt.to(cuda), dev[4],
        window=window, k_scale=pks, v_scale=pvs)
    torch.testing.assert_close(got_p.float(), ref.float(), **tol)


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
