"""Two trees against each other on one card: the 2-D streaming matmul, the
SSD scan and mamba2-370m's prefill, each tree in a process of its own.

    python3 tools/kernel_ab.py TREE [TREE ...]

Each TREE is the root of a checkout (its ``src/repro_torch`` is imported and
its kernels are built from its own sources). The trees run in the order
given, so ``A B B A`` alternates a parent A with a change B and spreads
drift in the host's and the card's clocks over both. Each process measures:

* the 2-D ``stream_matmul_cuda`` at fp32 129x257x65 (the rc3e path's BAaaS
  and RSaaS product), fp32 4096^3 and bf16 4096^3, and
* ``ssd_cuda`` at mamba2-370m's width (H 32, P 64, N 128, G 1, the layer's
  strided views) at bf16 B=4 S=1024 and fp32 B=1 S=2048:
  ``graph_ms``, the call replayed from a CUDA graph, a mean of CUDA events
  with L2 flushed between calls (as ``chip_smoke.time_ms``), and for the
  matmul ``library_ms``, ``torch.matmul`` on the same inputs replayed the
  same way with TF32 off;
* the wall ms of mamba2-370m's bf16 prefill of 4 x 1024 tokens
  (``make_prefill_step``, full width and depth, seeded weights, gate norms
  1), after one warm-up call: each of 5 calls and their median.

Prints one JSON line per process, then the card's name and power limit.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

SEED = 0
DEV = "cuda"


def uncounted():
    """A timing capture's launch tally, dropped: its replays are
    measurements, not a path's launches. A tree whose launch ledger keeps
    no tallies (before its CUDA graphs) counted the capture itself."""
    import contextlib
    from repro_torch.kernels import _lib
    return getattr(_lib, "capture_tally", contextlib.nullcontext)()


def time_ms(fn, iters=20):
    flush = torch.empty(64 << 20, dtype=torch.float32, device=DEV)
    for _ in range(3):
        fn()
    g = torch.cuda.CUDAGraph()
    torch.cuda.synchronize()
    with uncounted(), torch.cuda.graph(g):
        fn()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        g.replay()
        e.record()
        e.synchronize()
        total += s.elapsed_time(e)
    return total / iters


def matmul_cases(mm):
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    out = {}
    for case, dtype, (M, K, N) in (
            ("fp32_129x257x65", torch.float32, (129, 257, 65)),
            ("fp32_4096", torch.float32, (4096, 4096, 4096)),
            ("bf16_4096", torch.bfloat16, (4096, 4096, 4096))):
        a = torch.randn((M, K), generator=gen, device=DEV).to(dtype)
        b = torch.randn((K, N), generator=gen, device=DEV).to(dtype)
        out[case] = dict(graph_ms=time_ms(lambda: mm.stream_matmul_cuda(a, b)),
                         library_ms=time_ms(lambda: torch.matmul(a, b)))
    return out


def ssd_cases(ssd):
    F = torch.nn.functional
    gen = torch.Generator(device=DEV).manual_seed(SEED + 1)
    H, P, N, G = 32, 64, 128, 1
    out = {}
    for case, dtype, B, S in (("bf16_B4_S1024", torch.bfloat16, 4, 1024),
                              ("fp32_B1_S2048", torch.float32, 1, 2048)):
        xbc = (torch.randn((B, S, H * P + 2 * G * N), generator=gen,
                           device=DEV) * 0.5).to(dtype)
        xs = xbc[..., :H * P].reshape(B, S, H, P)
        Bm = xbc[..., H * P:H * P + G * N].reshape(B, S, G, N)
        Cm = xbc[..., H * P + G * N:].reshape(B, S, G, N)
        dt = F.softplus(torch.randn((B, S, H), generator=gen, device=DEV)
                        - 1.0)
        A = -torch.exp(torch.randn((H,), generator=gen, device=DEV))
        D = torch.randn((H,), generator=gen, device=DEV)
        out[case] = dict(graph_ms=time_ms(
            lambda: ssd.ssd_cuda(xs, dt, A, Bm, Cm, D)))
    return out


def prefill_wall(get_config, Model, make_prefill_step):
    cfg = get_config("mamba2-370m")
    model = Model(cfg, device=DEV)
    params = model.init(torch.Generator(device=DEV).manual_seed(SEED + 8))
    for st in params["stages"]:
        st["ssm"]["norm"].fill_(1.0)
    rng = np.random.default_rng(SEED + 7)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 1024))
                               .astype(np.int32)).to(DEV)
    prefill = make_prefill_step(model, 0)
    prefill(params, {"tokens": prompts})           # warm-up
    ms = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prefill(params, {"tokens": prompts})
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return dict(wall_ms=ms, median_ms=float(np.median(ms)))


def child(tree):
    sys.path.insert(0, str(tree / "src"))
    import repro_torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import _lib
    from repro_torch.kernels import mamba2_chunk as ssd
    from repro_torch.kernels import stream_matmul as mm
    from repro_torch.models import Model
    from repro_torch.runtime import make_prefill_step
    if not Path(repro_torch.__file__).resolve().is_relative_to(tree):
        raise SystemExit(f"imported {repro_torch.__file__}, not from {tree}")
    torch.backends.cuda.matmul.allow_tf32 = False
    _lib.build()
    rec = dict(tree=str(tree), matmul=matmul_cases(mm), ssd=ssd_cases(ssd),
               prefill_4x1024=prefill_wall(get_config, Model,
                                           make_prefill_step))
    print(json.dumps(rec), flush=True)


def main(argv):
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
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
