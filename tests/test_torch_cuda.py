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
    (torch.float32, 24, 1000), (torch.float32, 32, 64)])
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [(16, 16, 16), (32, 32, 32),
                                   (128, 128, 128), (200, 300, 150),
                                   (129, 257, 65), (4096, 4096, 4096)])
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
    batched kernel runs once per core per cycle; outputs match the plain
    version on the host blocks."""
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
    blocks = [[tuple(torch.from_numpy(rng.standard_normal((g, s, s))
                                      .astype(np.float32)) for _ in range(2))
               for _ in range(cycles)] for _ in range(n)]
    for shell in (FusedShell(4), SpatialShell(4)):
        for i, e in enumerate(entries):
            shell.load(i, e.compiled, spec, f"t{i}")
        fifos = [StreamFIFO(2).feed(iter(blocks[i])) for i in range(n)]
        before = launches["stream_matmul_batched"]
        for c in range(cycles):
            if isinstance(shell, FusedShell):
                outs = shell.run_cycle({i: fifos[i].get() for i in range(n)})
            else:
                outs = {i: shell.run(i, *fifos[i].get()) for i in range(n)}
                shell.join()
            for i in range(n):
                ref = tmm.matmul_batched_ref(*blocks[i][c])
                torch.testing.assert_close(outs[i][0].cpu(), ref, atol=1e-4,
                                           rtol=1e-4)
        assert launches["stream_matmul_batched"] - before == n * cycles


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
    ("bf16/N64", torch.bfloat16, 1, 100, 8, 32, 4, 64, True)])
def test_ssd_kernel_on_card(cuda, case, dtype, B, S, H, P, G, N, init):
    """mamba2-370m's width (H 32, P 64, N 128) at the chip_smoke cases (the
    ssm_serve batches B 4 and 8 run 16 and 32 state rows a block), and
    groups, a ragged row tile (P 48), the other state dims, an init state:
    y and the final state against the sequential plain version and the
    chunked ``ssd_scan``."""
    from repro_torch.kernels import mamba2_chunk as tssd
    from repro_torch.layers.ssm import ssd_scan
    if case == "bf16/B8/S256":        # 256 (sequence, head) pairs
        assert tssd._rows(cuda, B * H, P) == 32
    gen = torch.Generator(device=cuda).manual_seed(S + N)
    xs, dt, A, Bm, Cm, D = _ssd_layer_inputs(gen, cuda, B, S, H, P, G, N,
                                             dtype)
    st0 = (torch.randn((B, H, P, N), generator=gen, device=cuda) * 0.1
           if init else None)
    n = launches["ssd_chunk_scan"]
    y, st = tssd.ssd_cuda(xs, dt, A, Bm, Cm, D, st0)
    assert launches["ssd_chunk_scan"] == n + 1
    assert y.dtype == dtype and y.shape == (B, S, H, P)
    assert st.dtype == torch.float32 and st.shape == (B, H, P, N)
    tol = SSD_TOL if dtype == torch.float32 else TOL_BF16
    for ry, rs in (tssd.ssd_ref(xs, dt, A, Bm, Cm, D, st0),
                   ssd_scan(xs, dt, A, Bm, Cm, D, 256, st0)):
        torch.testing.assert_close(y.float(), ry.float(), **tol)
        torch.testing.assert_close(st, rs, **tol)


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
