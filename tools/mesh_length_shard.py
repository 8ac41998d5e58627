"""``jit_serve_step`` over caches whose length the rules shard, on a mesh of
several ranks: full-width smollm-135m (3 kv heads) on a (1, N) (data,
model) mesh with N 2 or 4, where ``cache_specs`` shards every cache's length
over "model". Each rank's decode kernel sweeps its own rows of the cache
and the ranks merge their outputs by log-sum-exp. Checks that the decode
runs the kernel (its wrapper's launch count: one a layer a step on every
rank) and that it agrees with the one-device ``make_serve_step``.

    python3 tools/mesh_length_shard.py [--ranks 2|4] [--device cuda|cpu]
                                       [--reduced]

On CUDA each rank takes one card (NCCL), so ``--ranks`` cards are needed;
``--device cpu`` runs the ranks over gloo, with ``--reduced`` for a
configuration small enough for a CPU. fp32 weights from a seed; 8 prompts
of 64 tokens through a prefill on the mesh, then 32 greedy decode steps.

On CUDA the mesh decode is ``jit_serve_step``'s program: one CUDA graph
of the step, captured at its first call (the ranks' ``all_gather``s of
the log-sum-exp merge with it) and replayed by the other 31; on the CPU
the step runs eagerly.

Each rank checks: the k/v caches' length entry is "model"; the decode
kernel's wrapper launched (on CPU: was called) n_layers x 32 times during
the decode (a replay counts through the capture's tally); on CUDA one
capture and 31 replays; the first decode step's logits within 1e-3 of the
one-device step's. Rank 0 also reports the share of greedy tokens equal to the
one-device run's and both steps' p50 wall ms. Prints one JSON line, then
(on CUDA) the card's name and power limit; exits 1 if a check failed.
"""
import argparse
import datetime
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

SEED = 0
B, PROMPT, NEW = 8, 64, 32
TOL = 1e-3


def _cfg(reduced_cfg: bool):
    from repro_torch.configs import get_config, reduced
    cfg = get_config("smollm-135m")
    if reduced_cfg:
        cfg = reduced(cfg).replace(vocab_size=256, n_kv_heads=1)
    return cfg.replace(dtype="float32")


def _sync(dev):
    if dev == "cuda":
        torch.cuda.synchronize()


def _decode(step, params, caches, tok, pos, dev, mesh_path, count):
    """NEW greedy steps; (tokens (B, NEW), first step's logits, wall ms a
    step, the decode wrapper's count over the loop)."""
    toks, ms, first = [], [], None
    before = count()
    for _ in range(NEW):
        _sync(dev)
        t0 = time.perf_counter()
        logits, caches = step(params, caches, tok, pos)
        if mesh_path:
            logits = logits.full_tensor()
        tok = logits[:, -1:].argmax(-1).to(torch.int32)
        _sync(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
        if first is None:
            first = logits.float().cpu()
        toks.append(tok[:, 0].cpu())
        pos = pos + 1
    return torch.stack(toks, 1), first, ms, count() - before


def rank_main(rank: int, world: int, dev: str, reduced_cfg: bool,
              rdv: str, out: str):
    import torch.distributed as dist
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.kernels import _lib, ops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import get_model
    from repro_torch.runtime import (jit_serve_step, make_prefill_step,
                                     make_serve_step)
    from repro_torch.runtime.sharding import P, param_specs, place, spec_of
    torch.set_num_threads(1)
    if dev == "cuda":
        torch.cuda.set_device(rank)
        count = lambda: _lib.launches["decode_attention"]   # noqa: E731
    else:
        calls = [0]
        wrapper = ops.decode_attention

        def counted(*a, **kw):
            calls[0] += 1
            return wrapper(*a, **kw)
        ops.decode_attention = counted
        count = lambda: calls[0]                            # noqa: E731
    dist.init_process_group("nccl" if dev == "cuda" else "gloo",
                            init_method=f"file://{rdv}", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    try:
        cfg = _cfg(reduced_cfg)
        model = get_model(cfg, device=dev)
        params = model.init(torch.Generator(device=dev).manual_seed(SEED))
        gen = torch.Generator(device=dev).manual_seed(SEED + 1)
        prompts = torch.randint(0, cfg.vocab_size, (B, PROMPT),
                                generator=gen, device=dev, dtype=torch.int32)
        max_len = PROMPT + NEW
        pos = torch.full((B,), PROMPT, dtype=torch.int32, device=dev)
        h, caches = make_prefill_step(model, max_len)(params,
                                                      {"tokens": prompts})
        tok = model.logits(params, h[:, -1:]).argmax(-1).to(torch.int32)
        want, want_first, plain_ms, _ = _decode(
            make_serve_step(model), params, caches, tok, pos, dev, False,
            count)
        del caches
        mesh = make_host_mesh(1, world, device=dev)
        mparams = place(params, mesh, param_specs(cfg, params, mesh))
        with implicit_replication():
            mh, mcaches = make_prefill_step(model, max_len)(
                mparams, {"tokens": place(prompts, mesh, P(None, None))})
        length = spec_of(mcaches[0]["k"])[2]       # (stack, B, L, kv, hd)
        mtok = model.logits(params, mh.full_tensor()[:, -1:]).argmax(
            -1).to(torch.int32)
        step, _ = jit_serve_step(model, mesh, B, max_len, mparams, mcaches)
        got, got_first, mesh_ms, launched = _decode(
            step, mparams, mcaches, mtok, pos, dev, True, count)
        graphs = getattr(step, "graphs", None)      # the program on CUDA
        graph = graphs.counts() if graphs is not None else None
        if graphs is not None:
            graph.update(capture_ms=list(graphs.capture_ms),
                         graph_mb=[b / 2**20 for b in graphs.graph_bytes])
            graphs.close()
        need = cfg.n_layers * NEW
        rec = dict(rank=rank, world=world, device=dev, arch=cfg.name,
                   layers=cfg.n_layers, kv_heads=cfg.n_kv_heads,
                   cache_length_spec=length, decode_launches=launched,
                   launches_needed=need,
                   first_step_logits_max_abs_err=float(
                       (got_first - want_first).abs().max()),
                   first_tokens_equal=bool(torch.equal(mtok.cpu(),
                                                       tok.cpu())),
                   token_agreement=float((got == want).float().mean()),
                   plain_step_ms_p50=float(np.median(plain_ms[1:])),
                   mesh_step_ms_p50=float(np.median(mesh_ms[1:])),
                   graph=graph)
        rec["ok"] = (length == "model" and launched == need
                     and rec["first_step_logits_max_abs_err"] <= TOL
                     and (dev == "cpu" or (graph["captures"] == 1
                                           and graph["replays"] == NEW - 1)))
        Path(out, f"rank{rank}.json").write_text(json.dumps(rec))
    finally:
        dist.destroy_process_group()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--reduced", action="store_true")
    args = ap.parse_args(argv)
    if args.ranks not in (2, 4):
        raise SystemExit("--ranks 2 or 4: a model axis that smollm's 3 kv "
                         "heads do not divide and the cache length does")
    if args.device == "cuda" and torch.cuda.device_count() < args.ranks:
        print(f"mesh_length_shard: {args.ranks} cards needed, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 1
    import torch.multiprocessing as mp
    if args.device == "cuda":
        from repro_torch.kernels import _lib
        _lib.build()                    # once, before the ranks load it
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(
            rank_main, args=(args.ranks, args.device, args.reduced,
                             os.path.join(tmp, "rdv"), tmp),
            nprocs=args.ranks, start_method="spawn")
        recs = [json.loads(Path(tmp, f"rank{r}.json").read_text())
                for r in range(args.ranks)]
    print(json.dumps(dict(ranks=recs, ok=all(r["ok"] for r in recs))),
          flush=True)
    if args.device == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip())
    return 0 if all(r["ok"] for r in recs) else 1


if __name__ == "__main__":
    sys.exit(main())
