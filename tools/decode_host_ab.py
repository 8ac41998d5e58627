"""Two trees' decode steps, prefills, training steps and RC2F shell cycles
against each other on one card, each tree in a process of its own: an
eager step against its CUDA graph, or any host cost a change adds to a
step.

    python3 tools/decode_host_ab.py [--sections engines,serve_step,prefill,
        train,shell,mesh] TREE [TREE ...]

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
  every step after the first;
* ``prefill``: the engine's batched prefill (``BatchingEngine._prefill``
  of ``_pad_ctx``, whatever the tree binds there: an eager call or a
  prefill program's graph) on full-width smollm-135m dense and paged and
  phi3-mini-3.8b dense: for each pad bucket of the 8 prompts, one warm-up
  call (a graph's capture) and then 10 calls, each timed between two
  synchronisations; then the TTFT of three fresh engines, each given the
  8 prompts at once (lockstep: the first step admits all 8 and decodes),
  p50 and p95 over the 24 requests; and mamba2-370m (48 layers, gate
  norms 1) at 4 x 1024 and 8 x 256: one prefill and its first token
  through ``GreedyLoop`` where the tree has it, else the step factories
  called eagerly, a warm-up call and then 10 timed.

* ``train``: a training step in fp32 as the tree's launcher takes it (its
  ``train_program`` where the tree has one, else ``make_train_step``
  called eagerly; the DP step likewise ``dp_train_program`` or
  ``make_dp_train_step``): full-width smollm-135m at B 8, S 1024 fed
  numpy batches of the synthetic pipeline; qwen3-moe-30b-a3b cut to 2
  layers and mamba2-370m cut to 4 at B 2, S 256 and whisper-tiny in full
  at B 2, fed one batch on the card; the DP step on an NCCL world of 1,
  smollm-135m cut to 4 layers at B 8, S 256, uncompressed and
  compressed. For each: 3 warm-up steps (a program's capture among
  them), the wall ms of 10 steps, each between two synchronisations,
  then 3 steps under ``torch.profiler`` for the device's busy ms a step
  and its ops a step; the idle share is 1 - busy / wall p50.

* ``shell``: the RC2F shells as ``chip_smoke.py``'s ``rc3e`` and
  ``spatial_shell`` phases drive them: 4 RAaaS tenants deploy the
  streaming core (``ops.matmul_batched``) through a ``Hypervisor``, and a
  ``FusedShell`` loads the configured programs; each core streams 100,000
  fp32 16x16 matrices in blocks of 64 (1,562 full blocks and a tail of
  32), from pinned host memory through ``StreamFIFO`` (depth 4) and from
  blocks resident on the card; then a ``SpatialShell``'s 4 slot streams
  on the resident blocks, and both shells again at 32x32, resident. For
  each run: the wall of every cycle, ms a cycle, aggregate MB/s, the
  graphs' counts, capture ms and MB where the tree's shells have them;
  for the 16x16 runs 200 more cycles under ``torch.profiler`` for the
  device's busy ms a cycle, the idle share (1 - busy / ms a cycle) and
  the host's top ops a cycle.

* ``mesh``: the mesh steps on a one-rank NCCL mesh, as the tree has them
  (its eager DTensor steps, or its programs): ``jit_serve_step`` on
  full-width smollm-135m bf16 (8 prompts of 64 tokens prefilled plainly,
  then the decode step on the placed params and caches at one position:
  3 warm-up calls, the wall ms of 20, 10 under the profiler) and
  ``jit_train_step`` at fp32, B 8, S 1024 on a numpy batch of the
  pipeline (as ``train``); with each program's captures, replays,
  capture ms and graph MB.

``--sections`` picks the sections (all but ``train``, ``shell`` and
``mesh`` by default). Prints one JSON line per process, then the card's
name and power limit.
"""
import dataclasses
import gc
import json
import subprocess
import sys
import tempfile
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


def _timed(call, n=10):
    """Wall ms of ``n`` calls of ``call``, each between two
    synchronisations, after one warm-up call."""
    call()
    ms = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return dict(ms=ms, p50_ms=float(np.median(ms)), min_ms=min(ms))


def prefill_engine(cfg, paged, Model, BatchingEngine):
    params = Model(cfg, device=DEV).init(
        torch.Generator(device=DEV).manual_seed(SEED))
    rng = np.random.default_rng(SEED + 1)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n)).astype(np.int32)
               for n in rng.integers(64, 1025, size=8)]

    def make():
        return BatchingEngine(Model(cfg, device=DEV), params, n_slots=8,
                              max_len=2048, paged=paged, page_size=16)

    eng = make()
    buckets = {}
    for p in prompts:
        toks = eng._pad_ctx(p[:-1])
        buckets.setdefault(int(toks.shape[1]), toks)
    out = dict(buckets={b: _timed(lambda t=toks: eng._prefill(t))
                        for b, toks in sorted(buckets.items())})
    ttft = []
    for _ in range(3):
        eng = make()
        torch.cuda.synchronize()
        reqs = [eng.submit(p, max_new_tokens=4) for p in prompts]
        eng.run_until_idle()
        ttft += [(r.first_token_at - r.submitted_at) * 1e3 for r in reqs]
    out.update(ttft_ms_p50=float(np.percentile(ttft, 50)),
               ttft_ms_p95=float(np.percentile(ttft, 95)))
    counts = getattr(eng._prefill_fn, "counts", None)
    if counts is not None:                      # a prefill program
        out["prefill_program"] = counts()
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def prefill_ssm(get_config, Model, runtime):
    cfg = get_config("mamba2-370m")
    model = Model(cfg, device=DEV)
    params = model.init(torch.Generator(device=DEV).manual_seed(SEED + 8))
    for st in params["stages"]:
        for site in (st,) if isinstance(st, dict) else st:
            site["ssm"]["norm"].fill_(1.0)
    rng = np.random.default_rng(SEED + 7)
    out = {}
    for B, S in ((4, 1024), (8, 256)):
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S))
                                .astype(np.int32)).to(DEV)
        if hasattr(runtime, "GreedyLoop"):
            loop = runtime.GreedyLoop(model, B, S + 32)

            def call():
                loop.prefill(params, {"tokens": toks})
        else:
            prefill = runtime.make_prefill_step(model, S + 32)

            def call():
                h, _ = prefill(params, {"tokens": toks})
                model.logits(params, h[:, -1:])[:, 0].argmax(-1)
        out[f"{B}x{S}"] = _timed(call)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


TRAIN_PATHS = (("smollm", "smollm-135m", None, 8, 1024),  # name, arch,
                ("qwen3moe2", "qwen3-moe-30b-a3b", 2, 2, 256),  # layers,
                ("mamba2_4", "mamba2-370m", 4, 2, 256),         # B, S
                ("whisper", "whisper-tiny", None, 2, None))
TRAIN_DP = dict(layers=4, B=8, S=256)


def _measured(call, graphs, warm, timed, traced):
    """Wall ms of ``timed`` calls of ``call`` after ``warm``, each between
    two synchronisations, then the device's busy ms and ops a call over
    ``traced`` calls under the profiler; the graph program ``graphs``'s
    counts, capture ms and MB where the tree has one (it is closed)."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warm):
        call()
    ms = []
    for _ in range(timed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(traced):
            call()
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in dev) / 1e3 / traced
    p50 = float(np.median(ms))
    out = dict(wall_ms=ms, p50_ms=p50, p95_ms=float(np.percentile(ms, 95)),
               busy_ms=busy, idle_share=1.0 - busy / p50,
               device_ops=sum(e.count for e in dev) / traced)
    if graphs is not None:
        out["graph"] = graphs.counts()
        out["capture_ms"] = list(graphs.capture_ms)
        out["graph_mb"] = [b / 2**20 for b in graphs.graph_bytes]
        graphs.close()
    return out


def _profiled(step, state, batch, warm=3, timed=10, traced=3):
    """``_measured`` of a training step threading its state."""
    box = [state]

    def call():
        box[0], _ = step(box[0], batch)
    return _measured(call, getattr(step, "graphs", None), warm, timed,
                     traced)


def _train_inputs(cfg, B, S, seed, **opts_kw):
    """(model, opts, state, batch): the launcher's fp32 model and
    schedule, a seeded state, a numpy batch of the synthetic pipeline
    (frames seeded on the card for the audio family)."""
    from repro_torch.data import DataConfig, DataPipeline
    from repro_torch.models import get_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime.train import TrainOpts, init_train_state
    cfg = cfg.replace(dtype="float32")
    model = get_model(cfg, device=DEV)
    opts = TrainOpts(opt=AdamWConfig(lr=1e-3, warmup_steps=10,
                                     total_steps=30), loss_chunk=64,
                     **opts_kw)
    state = init_train_state(
        model, torch.Generator(device=DEV).manual_seed(seed), opts)
    audio = cfg.family == "audio"
    data = DataPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                   seq_len=64 if audio else S, batch_size=B))
    batch = data.batch_at(0)
    if audio:
        batch["frames"] = torch.randn(
            (B, cfg.encoder.max_frames, cfg.d_model), device=DEV,
            generator=torch.Generator(device=DEV).manual_seed(seed + 1))
    return model, opts, state, batch


def train(get_config, train_mod):
    import torch.distributed as dist
    program = getattr(train_mod, "train_program", None)
    out = {}
    for name, arch, layers, B, S in TRAIN_PATHS:
        cfg = get_config(arch)
        if layers is not None:
            cfg = cfg.replace(n_layers=layers)
        model, opts, state, batch = _train_inputs(cfg, B, S, SEED + 70)
        if name != "smollm":                    # a batch on the card
            batch = {k: v if isinstance(v, torch.Tensor)
                     else torch.from_numpy(v).to(DEV)
                     for k, v in batch.items()}
        step = program(model, opts) if program is not None \
            else train_mod.make_train_step(model, opts)
        out[name] = _profiled(step, state, batch)
        del model, state, batch, step
        gc.collect()
        torch.cuda.empty_cache()
    dp_program = getattr(train_mod, "dp_train_program", None)
    rdv = Path(tempfile.mkdtemp()) / "rendezvous"
    dist.init_process_group("nccl", init_method=f"file://{rdv}",
                            world_size=1, rank=0)
    try:
        cfg = get_config("smollm-135m").replace(n_layers=TRAIN_DP["layers"])
        for tag, compress in (("dp", False), ("dp_compressed", True)):
            model, opts, state, batch = _train_inputs(
                cfg, TRAIN_DP["B"], TRAIN_DP["S"], SEED + 71,
                compress_grads=compress)
            step = dp_program(model, None, opts) if dp_program is not None \
                else train_mod.make_dp_train_step(model, None, opts)
            out[tag] = _profiled(step, state, batch)
            del model, state, step
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    return out


MESH_SERVE = dict(B=8, prompt=64)
MESH_TRAIN = dict(B=8, S=1024)


def mesh(get_config, runtime):
    """The mesh steps as the tree has them on a one-rank NCCL mesh:
    ``jit_serve_step`` (full smollm-135m bf16, 8 prompts of 64 prefilled
    plainly, the decode step called on the placed params and caches at
    one position, 3 warm-up calls, 20 timed, 10 profiled) and
    ``jit_train_step`` (fp32, B 8, S 1024, a numpy batch of the pipeline,
    as ``train``)."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import get_model
    from repro_torch.runtime.sharding import place
    out = {}
    mesh_ = make_host_mesh(1, 1, device=DEV)
    try:
        cfg = get_config("smollm-135m")
        model = get_model(cfg, device=DEV)
        params = model.init(torch.Generator(device=DEV).manual_seed(SEED + 73))
        B, prompt = MESH_SERVE["B"], MESH_SERVE["prompt"]
        toks = torch.randint(0, cfg.vocab_size, (B, prompt), device=DEV,
                             dtype=torch.int32, generator=torch.Generator(
                                 device=DEV).manual_seed(SEED + 74))
        h, caches = runtime.make_prefill_step(model, prompt + 32)(
            params, {"tokens": toks})
        tok = model.logits(params, h[:, -1:]).argmax(-1).to(torch.int32)
        step, specs = runtime.jit_serve_step(model, mesh_, B, prompt + 32,
                                             params, caches)
        mparams = place(params, mesh_, specs["params"])
        mcaches = place(caches, mesh_, specs["caches"])
        pos = torch.full((B,), prompt, dtype=torch.int32, device=DEV)
        out["serve"] = _measured(
            lambda: step(mparams, mcaches, tok, pos),
            getattr(step, "graphs", None), warm=3, timed=20, traced=10)
        del step, mparams, mcaches, caches, params, h
        gc.collect()
        torch.cuda.empty_cache()
        model, opts, state, batch = _train_inputs(
            cfg, MESH_TRAIN["B"], MESH_TRAIN["S"], SEED + 75)
        step, sspecs, _ = runtime.jit_train_step(model, mesh_, opts, state,
                                                 batch)
        out["train"] = _profiled(step, place(state, mesh_, sspecs), batch)
        del model, state, step
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    return out


SHELL = dict(mats=100_000, block=64, cores=4, depth=4, profiled=200)


def _shell_cycles(shell, srcs, cycles, spatial):
    """Run ``cycles`` cycles of ``shell`` on the blocks ``srcs[i]()``
    gives core i; returns core 0's outputs."""
    outs0 = []
    for _ in range(cycles):
        if spatial:
            outs0.append(shell.run(0, *srcs[0]())[0])
            for i in range(1, len(srcs)):
                shell.run(i, *srcs[i]())
        else:
            outs0.append(shell.run_cycle(
                {i: src() for i, src in enumerate(srcs)})[0][0])
    if spatial:
        shell.join()
    return outs0


def _shell_run(shell, make_srcs, spatial, profile):
    """Wall, MB/s and graph counts of one stream through ``shell``; with
    ``profile`` the device's busy ms, idle share and top host ops a cycle
    over ``SHELL["profiled"]`` more cycles."""
    from torch.profiler import ProfilerActivity, profile as prof_ctx
    g, n = SHELL["block"], SHELL["cores"]
    cycles = -(-SHELL["mats"] // g)
    counts = getattr(shell, "counts", None)
    c0 = counts() if counts is not None else None
    srcs = make_srcs(SHELL["mats"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs0 = _shell_cycles(shell, srcs, cycles, spatial)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    sz = outs0[0].shape[-1]
    out = dict(wall_s=wall, cycle_ms=wall * 1e3 / cycles,
               aggregate_MBps=n * 2 * SHELL["mats"] * sz * sz * 4
               / wall / 1e6, outputs=sum(o.shape[0] for o in outs0))
    del outs0
    if c0 is not None:
        c1 = counts()
        k = len(c0["capture_ms"])
        out["graph"] = dict(captures=c1["captures"] - c0["captures"],
                            replays=c1["replays"] - c0["replays"],
                            capture_ms=c1["capture_ms"][k:],
                            graph_mb=[b / 2**20
                                      for b in c1["graph_bytes"][k:]])
    if profile:
        p = SHELL["profiled"]
        srcs = make_srcs(p * g)
        torch.cuda.synchronize()
        with prof_ctx(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            _shell_cycles(shell, srcs, p, spatial)
            torch.cuda.synchronize()
        ev = prof.key_averages()
        dev = [e for e in ev
               if e.device_type == torch.autograd.DeviceType.CUDA]
        host = sorted((e for e in ev
                       if e.device_type == torch.autograd.DeviceType.CPU),
                      key=lambda e: -e.self_cpu_time_total)[:6]
        busy = sum(e.self_device_time_total for e in dev) / 1e3 / p
        out.update(busy_ms=busy, idle_share=1.0 - busy / out["cycle_ms"],
                   host_top_ms={e.key[:60]: e.self_cpu_time_total / 1e3 / p
                                for e in host})
    return out


def shell():
    from repro_torch.core import ClusterSpec, Hypervisor, RAaaSSession
    from repro_torch.rc2f import (CoreSpec, FusedShell, SpatialShell,
                                  StreamFIFO, StreamSpec)
    g, n = SHELL["block"], SHELL["cores"]
    hv = Hypervisor(ClusterSpec(n_nodes=2, devices_per_node=2), device=DEV)
    gen = torch.Generator(device=DEV).manual_seed(SEED + 80)
    out = {}
    for sz in (16, 32):
        spec = CoreSpec(f"mm{sz}", (StreamSpec((g, sz, sz)),) * 2,
                        (StreamSpec((g, sz, sz)),))
        sessions = [RAaaSSession(hv, f"tenant{i}") for i in range(n)]
        entries = [s.deploy_core(_shell_core, spec.example_inputs(),
                                 f"mm{sz}") for s in sessions]
        dev = [[torch.randn((SHELL["mats"], sz, sz), generator=gen,
                            device=DEV) for _ in range(2)] for _ in range(n)]

        def resident(mats):
            def src(pair):
                it = ((pair[0][j:j + g], pair[1][j:j + g])
                      for j in range(0, mats, g))
                return lambda: next(it)
            return [src(pair) for pair in dev]

        fused = FusedShell(n, device=DEV)
        for i, e in enumerate(entries):
            fused.load(i, e.compiled, spec, f"tenant{i}")
        runs = {}
        if sz == 16:
            host = [[torch.empty(d.shape, pin_memory=True).copy_(d)
                     for d in pair] for pair in dev]

            def from_host(mats):
                return [StreamFIFO(depth=SHELL["depth"], device=DEV).feed(
                    (h[0][j:j + g], h[1][j:j + g])
                    for j in range(0, mats, g)).get for h in host]
            runs["fused_host"] = _shell_run(fused, from_host, False, True)
            del host
        runs["fused_resident"] = _shell_run(fused, resident, False,
                                            sz == 16)
        spatial = SpatialShell(n_slots=n, device=DEV)
        for i, e in enumerate(entries):
            spatial.load(i, e.compiled, spec, f"tenant{i}")
        runs["spatial_resident"] = _shell_run(spatial, resident, True,
                                              sz == 16)
        runs["spatial_over_fused"] = (runs["spatial_resident"]
                                      ["aggregate_MBps"]
                                      / runs["fused_resident"]
                                      ["aggregate_MBps"])
        out[f"mm{sz}"] = runs
        for s in sessions:
            s.close()
        del fused, spatial, dev, entries
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _shell_core(a, b):
    from repro_torch.kernels import ops
    return (ops.matmul_batched(a, b),)


SECTIONS = ("engines", "serve_step", "prefill", "train", "shell", "mesh")
DEFAULT_SECTIONS = SECTIONS[:3]


def child(tree, sections):
    sys.path.insert(0, str(tree / "src"))
    import repro_torch
    from repro_torch import runtime
    from repro_torch.configs import get_config
    from repro_torch.kernels import _lib
    from repro_torch.models import Model, get_model
    from repro_torch.runtime import (BatchingEngine, make_prefill_step,
                                     make_serve_step)
    if not Path(repro_torch.__file__).resolve().is_relative_to(tree):
        raise SystemExit(f"imported {repro_torch.__file__}, not from {tree}")
    if set(sections) - {"train"}:
        _lib.build()
    rec = dict(tree=str(tree))
    if "engines" in sections:
        rec["engines"] = {
            name: engine(path_cfg(get_config, arch, layers, over), paged,
                         Model, BatchingEngine)
            for name, arch, layers, paged, over in PATHS}
    if "serve_step" in sections:
        rec["serve_step"] = serve_step(get_config, get_model,
                                       make_prefill_step, make_serve_step)
    if "prefill" in sections:
        rec["prefill"] = {
            name: prefill_engine(path_cfg(get_config, arch, layers, over),
                                 paged, Model, BatchingEngine)
            for name, arch, layers, paged, over in PATHS[:3]}
        rec["prefill"]["mamba2_370m"] = prefill_ssm(get_config, Model,
                                                    runtime)
    if "train" in sections:
        from repro_torch.runtime import train as train_mod
        rec["train"] = train(get_config, train_mod)
    if "shell" in sections:
        rec["shell"] = shell()
    if "mesh" in sections:
        rec["mesh"] = mesh(get_config, runtime)
    print(json.dumps(rec), flush=True)


def main(argv):
    if not torch.cuda.is_available():
        print("decode_host_ab: no CUDA device", file=sys.stderr)
        return 1
    sections = DEFAULT_SECTIONS
    if argv[:1] == ["--sections"]:
        sections = tuple(argv[1].split(","))
        if not set(sections) <= set(SECTIONS):
            print(f"decode_host_ab: sections of {SECTIONS}", file=sys.stderr)
            return 2
        argv = argv[2:]
    if argv[:1] == ["--child"]:
        child(Path(argv[1]).resolve(), argv[2].split(","))
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    for tree in argv:
        res = subprocess.run(
            [sys.executable, __file__, "--child", str(Path(tree).resolve()),
             ",".join(sections)],
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
