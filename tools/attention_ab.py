"""Two trees against each other on one card: the serving path's attention
kernels and the engine's decode step, each tree in a process of its own.

    python3 tools/attention_ab.py TREE [TREE ...]

Each TREE is the root of a checkout (its ``src/repro_torch`` is imported and
its kernels are built from its own sources). The trees run in the order
given, so ``A B B A A B B A`` alternates a parent A with a change B and
spreads drift in the host's and the card's clocks over both. Each process
measures, at smollm-135m's widths (Hq 9, Hkv 3, D 64, bf16):

* decode at B=8, L=2048 (64-2047 live keys a row; dense, and paged with
  page 16), bf16 flash prefill at B=1, S=1024, and fp32 flash prefill at
  B=1, S=512 and S=2048: ``graph_ms`` (the call
  replayed from a CUDA graph) and ``eager_ms`` (the call launched eagerly),
  means of CUDA events with L2 flushed between calls; ``host_us``, the
  wrapper's host time a call (back-to-back calls on the host clock, no
  synchronisation); and ``sdpa_graph_ms``, one
  ``scaled_dot_product_attention`` call on the same inputs (dense decode,
  flash), replayed the same way, with fp32 matmuls in full fp32 (TF32
  off);
* decode at the groups past one chunk of 8 query heads (``WIDE_GROUPS``:
  Qwen3-235B-A22B's 64 / 4 of 128, Llama-3.1-405B's 128 / 8, MQA's 71 / 1
  of 64 and 48 / 1 of 128; and 16 / 1 of 512) at B=8, L=2048, bf16 dense
  and paged (page 16) and int8 dense: ``graph_ms`` as above, SDPA's on
  the dense bf16 case, the bound (valid K/V rows once, over 3.35 TB/s)
  and ``kv_mb_requested``, the K/V bytes the tree's split blocks ask of
  L2 / HBM (each head chunk, or each group-kernel slice, reads its kv
  head's valid rows);
* ``digests``: a hash of each output at smollm's widths (fp32, bf16 and
  int8 K/V, with an idle row and a row with no valid key), so that two
  trees whose split-kernel route should agree bit for bit can be compared;
* the dense and the paged ``BatchingEngine`` (full-width smollm-135m,
  seeded weights, 8 slots, 8 prompts of 64-1024 tokens): wall ms of each
  of 20 steady decode steps after 3 warm-up steps, with their mean and
  median.

Prints one JSON line per process, then the card's name and power limit.
"""
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

B, HQ, HKV, D, L, PS, S = 8, 9, 3, 64, 2048, 16, 1024
SEED = 0
DEV = "cuda"


def uncounted():
    """A timing capture's launch tally, dropped: its replays are
    measurements, not a path's launches. A tree whose launch ledger keeps
    no tallies (before its CUDA graphs) counted the capture itself."""
    import contextlib
    from repro_torch.kernels import _lib
    return getattr(_lib, "capture_tally", contextlib.nullcontext)()


def time_ms(fn, graph, iters=20):
    flush = torch.empty(64 << 20, dtype=torch.float32, device=DEV)
    for _ in range(3):
        fn()
    run = fn
    if graph:
        g = torch.cuda.CUDAGraph()
        torch.cuda.synchronize()
        with uncounted(), torch.cuda.graph(g):
            fn()
        run = g.replay
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        run()
        e.record()
        e.synchronize()
        total += s.elapsed_time(e)
    return total / iters


def host_us(fn, n=200):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / n * 1e6


def timings(fn, sdpa=None):
    rec = dict(graph_ms=time_ms(fn, True), eager_ms=time_ms(fn, False),
               host_us=host_us(fn))
    if sdpa is not None:
        rec["sdpa_graph_ms"] = time_ms(sdpa, True)
    return rec


def kernel_cases(da, fa):
    F = torch.nn.functional
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    rng = np.random.default_rng(SEED)
    cur = rng.integers(64, L - 1, size=B)
    fill = np.minimum(L, cur + 1 + rng.integers(0, 64, size=B))
    bf = torch.bfloat16
    q = torch.randn((B, HQ, D), generator=gen, device=DEV).to(bf)
    k = torch.randn((B, HKV, L, D), generator=gen, device=DEV).to(bf)
    v = torch.randn((B, HKV, L, D), generator=gen, device=DEV).to(bf)
    ar = torch.arange(L, device=DEV, dtype=torch.int32)[None]
    fill_t = torch.tensor(fill, device=DEV, dtype=torch.int32)[:, None]
    kpos = torch.where(ar < fill_t, ar, torch.full_like(ar, -1)).contiguous()
    cur_t = torch.tensor(cur, device=DEV, dtype=torch.int32)
    mask = ((kpos >= 0) & (kpos <= cur_t[:, None]))[:, None, None, :]
    out = dict(decode_bf16_B8=timings(
        lambda: da.decode_attention_cuda(q, k, v, kpos, cur_t),
        lambda: F.scaled_dot_product_attention(
            q[:, :, None], k, v, attn_mask=mask, enable_gqa=True)))
    # paged: the same cache in a shuffled pool, page 0 the null page
    nb = L // PS
    perm = torch.randperm(B * nb, generator=gen, device=DEV) + 1
    bt = perm.reshape(B, nb).to(torch.int32)
    kp = torch.zeros((B * nb + 1, HKV, PS, D), dtype=bf, device=DEV)
    vp = torch.zeros_like(kp)
    kpp = torch.full((B * nb + 1, PS), -1, dtype=torch.int32, device=DEV)
    kp[bt.long()] = k.reshape(B, HKV, nb, PS, D).movedim(2, 1)
    vp[bt.long()] = v.reshape(B, HKV, nb, PS, D).movedim(2, 1)
    kpp[bt.long()] = kpos.reshape(B, nb, PS)
    out["paged_bf16_B8"] = timings(
        lambda: da.paged_decode_attention_cuda(q, kp, vp, kpp, bt, cur_t))
    fq = torch.randn((1, HQ, S, D), generator=gen, device=DEV).to(bf)
    fk = torch.randn((1, HKV, S, D), generator=gen, device=DEV).to(bf)
    fv = torch.randn((1, HKV, S, D), generator=gen, device=DEV).to(bf)
    out["flash_bf16_S1024"] = timings(
        lambda: fa.flash_attention_cuda(fq, fk, fv),
        lambda: F.scaled_dot_product_attention(fq, fk, fv, is_causal=True,
                                               enable_gqa=True))
    for s in (512, 2048):
        q32, k32, v32 = (torch.randn((1, h, s, D), generator=gen, device=DEV)
                         for h in (HQ, HKV, HKV))
        out[f"flash_fp32_S{s}"] = timings(
            lambda: fa.flash_attention_cuda(q32, k32, v32),
            lambda: F.scaled_dot_product_attention(
                q32, k32, v32, is_causal=True, enable_gqa=True))
    return out


WIDE_GROUPS = (("g16", (64, 4, 128)), ("g16h128", (128, 8, 128)),
               ("g71", (71, 1, 64)), ("g48", (48, 1, 128)),
               ("g16d512", (16, 1, 512)))


def _quant(x):
    amax = x.abs().amax(-1)
    s = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    return torch.clamp(torch.round(x / s[..., None]), -127, 127) \
        .to(torch.int8), s.float()


def _table(gen, Bx, nb):
    """A shuffled block table over pages 1 .. Bx * nb (page 0 null)."""
    perm = torch.randperm(Bx * nb, generator=gen, device=DEV) + 1
    return perm.reshape(Bx, nb).to(torch.int32)


def _pool(x, bt, fill):
    """(B, Hkv, L, ...) or (B, L) rows (scales: (B, Hkv, L)) over a pool
    of pages of PS rows laid out by the block table ``bt``."""
    Bx, nb = bt.shape
    if x.dim() == 2:
        pool = torch.full((Bx * nb + 1, PS), fill, dtype=x.dtype, device=DEV)
        pool[bt.long()] = x.reshape(Bx, nb, PS)
    else:
        pool = torch.full((Bx * nb + 1, x.shape[1], PS) + tuple(x.shape[3:]),
                          fill, dtype=x.dtype, device=DEV)
        pool[bt.long()] = x.reshape((Bx, x.shape[1], nb, PS)
                                    + tuple(x.shape[3:])).movedim(2, 1)
    return pool


def wide_cases(da):
    """Decode past one chunk of query heads, bf16 dense / paged and int8
    dense, with SDPA on the dense bf16 inputs and the tree's own K/V bytes
    requested."""
    F = torch.nn.functional
    gen = torch.Generator(device=DEV).manual_seed(SEED + 1)
    rng = np.random.default_rng(SEED + 1)
    cur = rng.integers(64, L - 1, size=B)
    fill = np.minimum(L, cur + 1 + rng.integers(0, 64, size=B))
    ar = torch.arange(L, device=DEV, dtype=torch.int32)[None]
    fill_t = torch.tensor(fill, device=DEV, dtype=torch.int32)[:, None]
    kpos = torch.where(ar < fill_t, ar, torch.full_like(ar, -1)).contiguous()
    cur_t = torch.tensor(cur, device=DEV, dtype=torch.int32)
    valid = (kpos >= 0) & (kpos <= cur_t[:, None])
    n_valid = int(valid.sum())
    mask = valid[:, None, None, :]
    out = {}
    for tag, (hq, hkv, d) in WIDE_GROUPS:
        q = torch.randn((B, hq, d), generator=gen, device=DEV).bfloat16()
        k = torch.randn((B, hkv, L, d), generator=gen, device=DEV)
        v = torch.randn((B, hkv, L, d), generator=gen, device=DEV)
        g = hq // hkv
        group = getattr(da, "uses_group_kernel", None)
        reads = (da.decode_group_plan(g, d).n_slices
                 if group and group(g, d, torch.bfloat16)
                 else da.head_chunks(g, d)[1])
        kv_b = n_valid * hkv * d * 2 * 2
        kb, vb = k.bfloat16(), v.bfloat16()
        rec = timings(lambda: da.decode_attention_cuda(q, kb, vb, kpos,
                                                       cur_t),
                      lambda: F.scaled_dot_product_attention(
                          q[:, :, None], kb, vb, attn_mask=mask,
                          enable_gqa=True))
        rec.update(bound_ms=(kv_b + 2 * q.numel() * 2 + kpos.numel() * 4)
                   / 3.35e12 * 1e3, kv_mb_bound=kv_b / 1e6,
                   kv_mb_requested=reads * kv_b / 1e6)
        out[f"{tag}_bf16"] = rec
        bt = _table(gen, B, L // PS)
        kp, vp, kpp = _pool(kb, bt, 0), _pool(vb, bt, 0), _pool(kpos, bt, -1)
        out[f"{tag}_bf16_paged"] = dict(graph_ms=time_ms(
            lambda: da.paged_decode_attention_cuda(q, kp, vp, kpp, bt, cur_t),
            True))
        k8, ks = _quant(k)
        v8, vs = _quant(v)
        out[f"{tag}_int8"] = dict(graph_ms=time_ms(
            lambda: da.decode_attention_cuda(q, k8, v8, kpos, cur_t,
                                             k_scale=ks, v_scale=vs), True),
            kv_mb_requested=reads * n_valid * hkv * (2 * d + 8) / 1e6)
    return out


def digests(da):
    """sha256 of decode outputs at smollm's widths (Hq 9, Hkv 3, D 64, B 4,
    L 512): fp32, bf16 and int8 K/V, with a long row, an idle row, a short
    one and one whose cur is set with nothing cached, and the log-sum-exp;
    dense and paged."""
    gen = torch.Generator(device=DEV).manual_seed(SEED + 2)
    Bd, Ld = 4, 512
    kpos = torch.arange(Ld, device=DEV, dtype=torch.int32)[None].repeat(Bd, 1)
    kpos[3] = -1
    cur_t = torch.tensor([500, -1, 30, 200], device=DEV, dtype=torch.int32)
    out = {}
    for kind in ("fp32", "bf16", "int8"):
        dt = torch.float32 if kind == "fp32" else torch.bfloat16
        q = torch.randn((Bd, HQ, D), generator=gen, device=DEV).to(dt)
        k = torch.randn((Bd, HKV, Ld, D), generator=gen, device=DEV)
        v = torch.randn((Bd, HKV, Ld, D), generator=gen, device=DEV)
        opt = {}
        if kind == "int8":
            k, ks = _quant(k)
            v, vs = _quant(v)
            opt = dict(k_scale=ks, v_scale=vs)
        else:
            k, v = k.to(dt), v.to(dt)
        o, lse = da.decode_attention_cuda(q, k, v, kpos, cur_t,
                                          return_lse=True, **opt)
        bt = _table(gen, Bd, Ld // PS)
        kp, vp, kpp = _pool(k, bt, 0), _pool(v, bt, 0), _pool(kpos, bt, -1)
        popt = {} if not opt else dict(k_scale=_pool(ks, bt, 1.0),
                                       v_scale=_pool(vs, bt, 1.0))
        po = da.paged_decode_attention_cuda(q, kp, vp, kpp, bt, cur_t,
                                            **popt)
        torch.cuda.synchronize()
        for name, t in (("dense", o), ("lse", lse), ("paged", po)):
            out[f"{kind}_{name}"] = hashlib.sha256(
                t.float().cpu().numpy().tobytes()).hexdigest()[:16]
    return out


def engine_steps(get_config, Model, BatchingEngine):
    cfg = get_config("smollm-135m")
    params = Model(cfg, device=DEV).init(
        torch.Generator(device=DEV).manual_seed(SEED))
    rng = np.random.default_rng(SEED + 1)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n)).astype(np.int32)
               for n in rng.integers(64, 1025, size=8)]
    out = {}
    for paged in (False, True):
        eng = BatchingEngine(Model(cfg, device=DEV), params, n_slots=8,
                             max_len=2048, paged=paged, page_size=PS)
        for p in prompts:
            eng.submit(p, max_new_tokens=64)
        for _ in range(3):
            eng.step()                          # admit + warm up
        ms = []
        for _ in range(20):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.step()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        out["paged_step" if paged else "dense_step"] = dict(
            wall_ms=ms, mean_ms=float(np.mean(ms)),
            p50_ms=float(np.median(ms)))
    return out


def child(tree):
    sys.path.insert(0, str(tree / "src"))
    import repro_torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import _lib
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import Model
    from repro_torch.runtime import BatchingEngine
    if not Path(repro_torch.__file__).resolve().is_relative_to(tree):
        raise SystemExit(f"imported {repro_torch.__file__}, not from {tree}")
    torch.backends.cuda.matmul.allow_tf32 = False
    _lib.build()
    rec = dict(tree=str(tree), kernels=kernel_cases(da, fa),
               wide=wide_cases(da), digests=digests(da),
               engine=engine_steps(get_config, Model, BatchingEngine))
    print(json.dumps(rec), flush=True)


def main(argv):
    if not torch.cuda.is_available():
        print("attention_ab: no CUDA device", file=sys.stderr)
        return 1
    if argv[:1] == ["--child"]:
        child(Path(argv[1]).resolve())
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    for tree in argv:
        res = subprocess.run(
            [sys.executable, __file__, "--child", str(Path(tree).resolve())],
            capture_output=True, text=True, timeout=900)
        if res.returncode:
            print(res.stdout, res.stderr, file=sys.stderr)
            return res.returncode
        print(res.stdout.strip().splitlines()[-1], flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
