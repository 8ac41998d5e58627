"""End-to-end training example on the PyTorch port (``examples/
train_smollm.py`` through ``repro_torch``): train a smollm-family model
through the full stack — RC3E allocation, StreamFIFO-fed synthetic data,
AdamW, periodic checkpointing with restart support. It trains through
``train_program`` (the reference's jitted step): on the card one CUDA
graph replayed every step, the FIFO's blocks copied into its fixed batch
buffers, the state updated in place.

Default runs a width-reduced smollm (~10M params) for 300 steps and prints
the loss trajectory (which must fall under the unigram entropy).
``--full`` selects the real 135M config (same code path). Runs on the card
unless ``--device cpu`` is passed (raises where CUDA is absent). A rerun
with the same ``--ckpt-dir`` resumes from its latest checkpoint (saved
every ``--save-every`` steps, the last two kept).

``main`` returns the wall-clock-free results it printed, with every
step's loss as a float; ``state`` injects the initial train state
(default: a seeded init).

Run:  PYTHONPATH=src python examples/train_smollm_torch.py [--steps 300]
          [--full] [--device cpu]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.ckpt import restore, save
from repro_torch.configs import get_config
from repro_torch.core import ClusterSpec, Hypervisor
from repro_torch.data import DataConfig, DataPipeline
from repro_torch.models import get_model
from repro_torch.optim import AdamWConfig
from repro_torch.rc2f import StreamFIFO
from repro_torch.runtime import TrainOpts, init_train_state, train_program


def config(full: bool):
    cfg = get_config("smollm-135m").replace(dtype="float32")
    if not full:
        cfg = cfg.replace(n_layers=6, d_model=256, n_heads=8, n_kv_heads=4,
                          head_dim=32, d_ff=768, vocab_size=2048)
    return cfg


def main(argv=None, *, params=None, state=None):
    """``params`` is unused (the trainer's weights are part of ``state``;
    the keyword keeps the examples' common entry point)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--full", action="store_true",
                    help="use the real smollm-135m config")
    ap.add_argument("--ckpt-dir", default="results/train_smollm_torch")
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises where CUDA is absent) or cpu")
    args = ap.parse_args(argv)
    res = {}

    cfg = config(args.full)
    model = get_model(cfg, device=args.device)
    res["model"] = (cfg.name, round(cfg.param_count() / 1e6, 1))
    print(f"model: {cfg.name} ({cfg.param_count() / 1e6:.1f}M params, "
          f"{'full' if args.full else 'reduced'})")

    hv = Hypervisor(ClusterSpec(n_nodes=1, devices_per_node=1),
                    device=args.device)
    vs = hv.allocate_vslice("trainer", slots=4)
    res["vslice"] = (vs.slice_id, vs.device_id)
    print(f"RC3E: training on {vs.slice_id} ({vs.device_id})")

    opts = TrainOpts(opt=AdamWConfig(lr=3e-3, warmup_steps=20,
                                     total_steps=args.steps),
                     loss_chunk=64)
    step_fn = train_program(model, opts)

    if state is None:
        state = init_train_state(
            model, torch.Generator(device=model.dev).manual_seed(0), opts)
    try:
        state, start = restore(args.ckpt_dir, state)
        print(f"restored checkpoint at step {start}")
    except FileNotFoundError:
        start = 0
    res["start"] = start

    data = DataPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                   seq_len=args.seq, batch_size=args.batch))
    res["unigram_entropy"] = round(data.unigram_entropy_nats(), 3)
    print(f"unigram entropy (loss floor for context-free): "
          f"{data.unigram_entropy_nats():.3f} nats")

    fifo = StreamFIFO(depth=2, device=args.device).feed(
        data.batch_at(i) for i in range(start, args.steps))
    t0 = time.time()
    losses = []
    for i, batch in zip(range(start, args.steps), fifo):
        state, metrics = step_fn(state, batch)
        hv.monitor.record_step(vs.slice_id,
                               (time.time() - t0) * 1e3 / (i - start + 1))
        losses.append(float(metrics["loss"]))
        if (i + 1) % args.save_every == 0:
            save(state, args.ckpt_dir, step=i + 1, keep=2)
            tput = args.batch * args.seq * (i - start + 1) / (time.time() - t0)
            print(f"step {i + 1:4d}  loss {losses[-1]:.4f}  "
                  f"lr {float(metrics['lr']):.2e}  {tput:,.0f} tok/s")
    res["losses"] = losses
    print(f"\nloss: first5 {np.round(losses[:5], 3)} -> "
          f"last5 {np.round(losses[-5:], 3)}")
    assert losses[-1] < losses[0]
    hv.release(vs.slice_id)
    print("done; slice released, device parked.")
    return res


if __name__ == "__main__":
    main()
