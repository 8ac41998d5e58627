"""Two trees' decode steps against each other on one card, each tree in a
process of its own: the engine's eager step against its CUDA graph, or any
host cost a change adds to a step.

    python3 tools/decode_host_ab.py TREE [TREE ...]

Each TREE is the root of a checkout (its ``src/repro_torch`` is imported and
its kernels are built from its own sources). The trees run in the order
given, so ``A B B A`` alternates a parent A with a change B and spreads
drift in the host's and the card's clocks over both. Each process runs,
bf16, seeded weights:

* ``engines``: ``BatchingEngine`` as ``chip_smoke.py``'s profile phases
  drive it (8 slots, max_len 2048, 8 prompts of 64-1024 tokens, 3 warm-up
  steps), on five paths: full-width smollm-135m dense and paged,
  phi3-mini-3.8b dense, qwen3-moe-30b-a3b cut to 6 layers dense, and its
  config at Qwen3-235B-A22B's widths cut to 2 layers dense
  (``chip_smoke.py``'s ``wide_group_cfg``). For each: the wall ms of 20
  steady steps, then 10 steps under ``torch.profiler`` for the device's
  busy ms a step and its ops a step; the idle share is 1 - busy / wall
  p50;
* ``serve_step``: full-width smollm-135m's ``make_serve_step`` called
  directly as ``chip_smoke.py``'s ``mesh_serve`` calls it for its plain
  steps (8 prompts of 64 tokens through ``make_prefill_step``, then 32
  greedy steps, each timed between two synchronisations): the wall ms of
  every step after the first.

Prints one JSON line per process, then the card's name and power limit.
"""
import dataclasses
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

SEED = 0
DEV = "cuda"
# (name, arch, layers or None for the config's, paged, config overrides)
PATHS = (("smollm_dense", "smollm-135m", None, False, {}),
         ("smollm_paged", "smollm-135m", None, True, {}),
         ("phi3_dense", "phi3-mini-3.8b", None, False, {}),
         ("qwen3moe6_dense", "qwen3-moe-30b-a3b", 6, False, {}),
         ("wide_group_dense", "qwen3-moe-30b-a3b", 2, False,
          dict(d_model=4096, n_heads=64, n_kv_heads=4, head_dim=128,
               vocab_size=151936,
               moe=dict(n_experts=128, top_k=8, d_expert=1536))))


def path_cfg(get_config, arch, layers, over):
    cfg = get_config(arch)
    over = dict(over)
    if "moe" in over:
        over["moe"] = dataclasses.replace(cfg.moe, **over["moe"])
    if layers is not None:
        over["n_layers"] = layers
    return cfg.replace(**over)


def engine(cfg, paged, Model, BatchingEngine):
    from torch.profiler import ProfilerActivity, profile
    params = Model(cfg, device=DEV).init(
        torch.Generator(device=DEV).manual_seed(SEED))
    rng = np.random.default_rng(SEED + 1)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n)).astype(np.int32)
               for n in rng.integers(64, 1025, size=8)]
    eng = BatchingEngine(Model(cfg, device=DEV), params, n_slots=8,
                         max_len=2048, paged=paged, page_size=16)
    for p in prompts:
        eng.submit(p, max_new_tokens=64)
    for _ in range(3):
        eng.step()                              # admit + warm up
    ms = []
    for _ in range(20):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    steps = 10
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in dev) / 1e3 / steps
    p50 = float(np.median(ms))
    out = dict(wall_ms=ms, p50_ms=p50, mean_ms=float(np.mean(ms)),
               busy_ms=busy, idle_share=1.0 - busy / p50,
               device_ops=sum(e.count for e in dev) / steps)
    counts = getattr(getattr(eng, "_greedy", None), "counts", None)
    if counts is not None:                      # a graph program
        out["graph"] = counts()
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def serve_step(get_config, get_model, make_prefill_step, make_serve_step):
    cfg = get_config("smollm-135m")
    model = get_model(cfg, device=DEV)
    params = model.init(torch.Generator(device=DEV).manual_seed(SEED + 60))
    gen = torch.Generator(device=DEV).manual_seed(SEED + 61)
    B, prompt, new = 8, 64, 32
    toks = torch.randint(0, cfg.vocab_size, (B, prompt), generator=gen,
                         device=DEV, dtype=torch.int32)
    h, caches = make_prefill_step(model, prompt + new)(params,
                                                       {"tokens": toks})
    tok = model.logits(params, h[:, -1:]).argmax(-1).to(torch.int32)
    pos = torch.full((B,), prompt, dtype=torch.int32, device=DEV)
    step = make_serve_step(model)
    ms = []
    for _ in range(new):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = step(params, caches, tok, pos)
        tok = logits[:, -1:].argmax(-1).to(torch.int32)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        pos = pos + 1
    ms = ms[1:]
    return dict(wall_ms=ms, p50_ms=float(np.median(ms)),
                mean_ms=float(np.mean(ms)))


def child(tree):
    sys.path.insert(0, str(tree / "src"))
    import repro_torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import _lib
    from repro_torch.models import Model, get_model
    from repro_torch.runtime import (BatchingEngine, make_prefill_step,
                                     make_serve_step)
    if not Path(repro_torch.__file__).resolve().is_relative_to(tree):
        raise SystemExit(f"imported {repro_torch.__file__}, not from {tree}")
    _lib.build()
    rec = dict(tree=str(tree), engines={
        name: engine(path_cfg(get_config, arch, layers, over), paged, Model,
                     BatchingEngine)
        for name, arch, layers, paged, over in PATHS})
    rec["serve_step"] = serve_step(get_config, get_model, make_prefill_step,
                                   make_serve_step)
    print(json.dumps(rec), flush=True)


def main(argv):
    if not torch.cuda.is_available():
        print("decode_host_ab: no CUDA device", file=sys.stderr)
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
            capture_output=True, text=True, timeout=1500)
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
