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
* the dense and the paged ``BatchingEngine`` (full-width smollm-135m,
  seeded weights, 8 slots, 8 prompts of 64-1024 tokens): wall ms of each
  of 20 steady decode steps after 3 warm-up steps, with their mean and
  median.

Prints one JSON line per process, then the card's name and power limit.
"""
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


def time_ms(fn, graph, iters=20):
    flush = torch.empty(64 << 20, dtype=torch.float32, device=DEV)
    for _ in range(3):
        fn()
    run = fn
    if graph:
        g = torch.cuda.CUDAGraph()
        torch.cuda.synchronize()
        with torch.cuda.graph(g):
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
