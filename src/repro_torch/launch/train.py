"""Training launcher: trains an arch on the synthetic token pipeline with
AdamW, resuming from ``--ckpt-dir`` and saving there every 25 steps (the
last two kept).

Ported from ``repro.launch.train`` (same flags and prints, float32 as
there), plus ``--device``. ``--data D --model M`` other than 1 x 1 builds
``make_host_mesh(D, M)`` over the process group (started from the
environment that ``torchrun`` sets, or by the caller) and prints its
shape; it raises where the world is smaller. As the reference does, the
launcher then computes the parameter specs and trains the one-process
step on every rank without placing anything on the mesh (the reference
computes ``pspecs`` and never applies them; ROADMAP records it). The
port's seeded init (``torch.Generator``) draws other numbers than the
reference's ``PRNGKey(0)``, so the two launchers' losses differ. It trains
through ``train_program``, the reference's ``jax.jit(make_train_step(...))``:
on the card one CUDA graph, bound to the (restored) state and the batch
buffers, captured at the first step and replayed at every later one; the
state is updated in place. Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
      --reduce --device cpu --steps 50 --batch 8 --seq 128
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
      --steps 30 --batch 8 --seq 1024                  # on the card
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.ckpt import restore, save
from repro_torch.configs import get_config, reduced
from repro_torch.data import DataConfig, DataPipeline
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import get_model
from repro_torch.optim import AdamWConfig
from repro_torch.runtime.sharding import axis_sizes, param_specs
from repro_torch.runtime.train import (TrainOpts, init_train_state,
                                       train_program)

SAVE_EVERY = 25


def _join_group(device: str) -> None:
    """Join the process group that ``torchrun``'s environment describes
    (WORLD_SIZE > 1), unless the caller has started one."""
    import os

    import torch.distributed as dist
    if dist.is_initialized() or int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return
    dist.init_process_group("nccl" if str(device).startswith("cuda")
                            else "gloo")


def main(argv=None) -> list:
    """Run the launcher (``argv`` as on the command line; None reads
    ``sys.argv``). Returns the losses of the steps this run took, as
    floats."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduce", action="store_true",
                    help="width-reduced config for CPU runs")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--data", type=int, default=1, help="mesh data axis")
    ap.add_argument("--model", type=int, default=1, help="mesh model axis")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises where CUDA is absent) or "
                         "cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduce:
        cfg = reduced(cfg)
    cfg = cfg.replace(dtype="float32")
    model = get_model(cfg, device=args.device)
    mesh = None
    if (args.data, args.model) != (1, 1):
        _join_group(args.device)
        mesh = make_host_mesh(args.data, args.model, device=args.device)
        print(f"training {cfg.name} ({cfg.param_count()/1e6:.1f}M params) "
              f"on mesh {axis_sizes(mesh)}")
    else:
        print(f"training {cfg.name} ({cfg.param_count()/1e6:.1f}M params) "
              f"on {model.dev}")

    opts = TrainOpts(opt=AdamWConfig(lr=args.lr, warmup_steps=10,
                                     total_steps=args.steps),
                     microbatches=args.microbatches, remat=args.remat,
                     loss_chunk=min(64, args.seq))
    state = init_train_state(
        model, torch.Generator(device=model.dev).manual_seed(0), opts)
    start = 0
    if args.ckpt_dir:
        try:
            state, start = restore(args.ckpt_dir, state)
            print(f"resumed from step {start}")
        except FileNotFoundError:
            pass

    if mesh is not None:
        # computed and not applied, as the reference's launcher does
        pspecs = param_specs(cfg, state["params"], mesh)  # noqa: F841
    step = train_program(model, opts)
    data = DataPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                                   batch_size=args.batch))
    losses = []
    t0 = time.time()
    for i in range(start, args.steps):
        state, metrics = step(state, data.batch_at(i))
        losses.append(metrics["loss"])
        if (i + 1) % 10 == 0:
            print(f"step {i+1:4d} loss {float(metrics['loss']):.4f} "
                  f"gnorm {float(metrics['grad_norm']):.2f}")
        if args.ckpt_dir and (i + 1) % SAVE_EVERY == 0:
            save(state, args.ckpt_dir, step=i + 1, keep=2)
    losses = [float(l) for l in losses]      # waits for the last step
    dt = time.time() - t0
    toks = args.batch * args.seq * (args.steps - start)
    print(f"done: {toks/dt:,.0f} tok/s")
    return losses


if __name__ == "__main__":
    main()
