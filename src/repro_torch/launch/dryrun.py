"""Multi-pod dry run (the reference's ``launch/dryrun.py``): build every
(architecture × input shape) cell on the production meshes as meta
DTensors over a fake process group, run one step, prove the memory fits
the card and extract roofline terms. CPU only; nothing is allocated.

The reference lowers and compiles on 512 forced host devices. Here
``fake_world(256 or 512)`` gives one process that many ranks (collectives
move nothing), the state, batch and caches are ``meta`` tensors placed by
the sharding rules, and the step runs eagerly on DTensors under
``implicit_replication`` inside ``hlo_analysis.analyze``: per-device flops,
operand bytes, collective wire bytes, and the peak of live bytes.

Per cell this prints/saves (the reference's keys, for the card):
  - memory: arguments (the placed state/params, batch and caches a
    device holds), outputs, temps, per_device_bytes = arguments + the
    peak of live bytes, fits_80GB against the card's 80 GiB;
  - per-device flops / dot-bytes / collective wire bytes;
  - three-term roofline on the H100 (``launch.mesh``): compute at the
    dense bf16 peak, memory at the HBM rate, collectives at NVLink inside
    an 8-GPU node or InfiniBand across nodes (every group of a 16×16
    mesh spans nodes); dominant term and MODEL_FLOPS ratio.

``trace_s`` replaces the reference's ``lower_s``/``compile_s``.

Usage (CPU):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-135m \\
      --shape train_4k [--mesh single|multi] [--json out.json]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import torch

from repro_torch.configs import SHAPES, get_config
from repro_torch.configs.base import ShapeCell
from repro_torch.launch.hlo_analysis import analyze, local_bytes
from repro_torch.launch.mesh import (GPUS_PER_NODE, HBM_BYTES, HBM_BYTES_S,
                                     IB_BYTES_S, NVLINK_BYTES_S,
                                     PEAK_FLOPS_BF16, chips, fake_world,
                                     make_production_mesh)
from repro_torch.models.api import get_model, input_specs
from repro_torch.runtime.serve import jit_serve_step
from repro_torch.runtime.sharding import (axis_sizes, batch_specs,
                                          param_specs, place, zero1_specs, P)
from repro_torch.runtime.train import (TrainOpts, init_train_state,
                                       make_train_step)
from repro_torch.tree import flatten

# Cells skipped with a documented reason (the reference's DESIGN.md §4)
SKIPS = {
    ("long_500k", arch): "full-attention cache at 500k infeasible by design"
    for arch in ("phi3-mini-3.8b", "smollm-135m", "deepseek-v2-lite-16b",
                 "qwen3-moe-30b-a3b", "llava-next-34b", "whisper-tiny")
}


def dryrun_cfg(arch: str, dp_total: int = 16, tp: int = 16,
               cell_kind: str = "train"):
    """Dry-run flavor: bf16 params+compute (production numerics); MoE
    dispatch made local to the mesh's data-parallel extent; attention TP
    switches to query-seq sharding on train cells when kv heads don't
    divide the model axis."""
    cfg = get_config(arch).replace(dtype="bfloat16", param_dtype="bfloat16")
    if cfg.moe is not None:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                  dp_shards=dp_total))
    # sub-GB models: the whole mesh is better used as pure DP
    if cell_kind == "train" and cfg.param_count() * 2 <= 800e6:
        return cfg.replace(tp_mode="pure_dp", attn_tp="none")
    if (cell_kind == "train" and cfg.mla is None
            and cfg.n_kv_heads % tp != 0):
        cfg = cfg.replace(attn_tp="seq")
    # int8 KV cache for decode cells (optimized variant; RC3E_KV_QUANT=1)
    if (cell_kind == "decode" and cfg.mla is None
            and os.environ.get("RC3E_KV_QUANT") == "1"):
        cfg = cfg.replace(kv_quant=True)
    return cfg


def _implicit(fn):
    """``fn`` under ``implicit_replication``: tensors made inside the
    model (positions, masks, rope tables) count as replicated."""
    from torch.distributed.tensor.experimental import implicit_replication

    def run(*args):
        with implicit_replication():
            return fn(*args)
    return run


def _train_lowerable(model, mesh, cell: ShapeCell,
                     opts: TrainOpts = TrainOpts(remat=True, loss_chunk=512)):
    cfg = model.cfg
    state_shape = init_train_state(model, None, opts)
    batch_shape = input_specs(cfg, cell)
    pspecs = param_specs(cfg, state_shape["params"], mesh)
    ospecs = zero1_specs(cfg, pspecs, state_shape["params"], mesh)
    state_specs = {
        "params": pspecs,
        "opt_state": {"mu": ospecs, "nu": ospecs, "count": P()},
        "step": P(),
    }
    bspecs = batch_specs(cfg, batch_shape, mesh)
    step = make_train_step(model, opts, grad_specs=ospecs)
    return _implicit(step), (place(state_shape, mesh, state_specs),
                             place(batch_shape, mesh, bspecs))


def _prefill_lowerable(model, mesh, cell: ShapeCell):
    """The prefill's caches are placed by the decode cells' rules inside
    the model (``models.lm``), as the reference pins its out_shardings."""
    cfg = model.cfg
    params_shape = model.init(None)
    batch_shape = input_specs(cfg, cell)
    pspecs = param_specs(cfg, params_shape, mesh)
    bspecs = batch_specs(cfg, batch_shape, mesh)

    def prefill_step(params, batch):
        return model.prefill(params, batch, cell.seq_len)

    return _implicit(prefill_step), (place(params_shape, mesh, pspecs),
                                     place(batch_shape, mesh, bspecs))


def _decode_lowerable(model, mesh, cell: ShapeCell):
    params_shape = model.init(None)
    specs = input_specs(model.cfg, cell)
    step, sp = jit_serve_step(model, mesh, cell.global_batch, cell.seq_len,
                              params_shape, specs["caches"])
    return step, (place(params_shape, mesh, sp["params"]),
                  place(specs["caches"], mesh, sp["caches"]),
                  specs["tokens"], specs["pos"])


def model_flops(cfg, cell: ShapeCell) -> float:
    """6·N_active·D for train, 2·N_active·D forward-only."""
    n = cfg.active_param_count()
    if cell.kind == "train":
        tokens = cell.global_batch * cell.seq_len
        return 6.0 * n * tokens
    if cell.kind == "prefill":
        tokens = cell.global_batch * cell.seq_len
        return 2.0 * n * tokens
    return 2.0 * n * cell.global_batch        # one token per sequence


def _link_rate(mesh) -> float:
    """Bytes/s of the mesh's collective groups: NVLink when every group
    of every mesh dim lies inside one 8-GPU node, else InfiniBand (a
    group spans nodes)."""
    sizes = list(axis_sizes(mesh).values())
    stride = 1
    spans = False
    for n in reversed(sizes):              # the last mesh dim is innermost
        if n > 1 and stride * n > GPUS_PER_NODE:
            spans = True
        stride *= n
    return IB_BYTES_S if spans else NVLINK_BYTES_S


def measure(cfg, cell: ShapeCell, mesh, mesh_name: str,
            opts: TrainOpts = None) -> dict:
    """One dry-run cell of ``cfg`` at ``cell`` on ``mesh`` (its ranks from
    ``fake_world``): the reference's result keys, for the card. ``opts``:
    a train cell's options (the dry run's remat and loss chunk 512 when
    None)."""
    model = get_model(cfg, device="meta")
    n_chips = chips(mesh)
    t0 = time.time()
    if cell.kind == "train":
        fn, args = _train_lowerable(model, mesh, cell, *(
            () if opts is None else (opts,)))
    else:
        lowerable = {"prefill": _prefill_lowerable,
                     "decode": _decode_lowerable}[cell.kind]
        fn, args = lowerable(model, mesh, cell)
    arg_b = float(sum(local_bytes(t) for t in flatten(args)[0]))
    out, costs = analyze(fn, *args, world=n_chips)
    out_b = float(sum(local_bytes(t) for t in flatten(out)[0]
                      if isinstance(t, torch.Tensor)))
    t_trace = time.time() - t0
    peak_b = arg_b + costs.peak_live_bytes

    t_compute = costs.flops / PEAK_FLOPS_BF16
    t_memory = costs.dot_bytes / HBM_BYTES_S
    t_memory_flash = (costs.dot_bytes - costs.score_bytes) / HBM_BYTES_S
    t_coll = costs.collective_bytes / _link_rate(mesh)
    terms = {"compute": t_compute, "memory": t_memory,
             "collective": t_coll}
    dominant = max(terms, key=terms.get)
    mf = model_flops(cfg, cell)
    flops_global = costs.flops * n_chips
    return {
        "arch": cfg.name, "shape": cell.name, "mesh": mesh_name,
        "chips": n_chips,
        "trace_s": round(t_trace, 2),
        "memory": {
            "per_device_bytes": int(peak_b),
            "arguments": int(arg_b), "outputs": int(out_b),
            "temps": int(max(costs.peak_live_bytes - out_b, 0)),
            "aliased": 0,                      # eager torch: no donation
            "cpu_dus_legalization_bytes": 0,   # no XLA-CPU legalisation
            "fits_80GB": bool(peak_b < HBM_BYTES),
        },
        "xla_cost_analysis": {
            "flops": costs.flops, "bytes_accessed": costs.dot_bytes,
            "note": "no XLA here: the dispatched-op counts, per device",
        },
        "per_device": {
            "flops": costs.flops,
            "dot_bytes": costs.dot_bytes,
            "collective_wire_bytes": costs.collective_bytes,
            "collective_breakdown": dict(costs.collectives),
            "collective_ops": costs.collective_count,
        },
        "roofline": {
            "compute_s": t_compute, "memory_s": t_memory,
            "memory_s_flash_kernel": t_memory_flash,
            "score_bytes": costs.score_bytes,
            "collective_s": t_coll, "dominant": dominant,
            "model_flops_global": mf,
            "hlo_flops_global": flops_global,
            "useful_flops_ratio": mf / flops_global if flops_global else 0.0,
            "step_time_bound_s": max(terms.values()),
            "roofline_fraction": t_compute / max(terms.values())
            if max(terms.values()) > 0 else 0.0,
        },
    }


def run_cell(arch: str, shape: str, multi_pod: bool = False) -> dict:
    cell = SHAPES[shape]
    reason = SKIPS.get((shape, arch))
    if reason:
        return {"arch": arch, "shape": shape, "skipped": reason}
    fake_world(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    sizes = axis_sizes(mesh)
    cfg = dryrun_cfg(arch, dp_total=chips(mesh) // sizes["model"],
                     tp=sizes["model"], cell_kind=cell.kind)
    return measure(cfg, cell, mesh,
                   "pod2x16x16" if multi_pod else "pod16x16")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=sorted(SHAPES))
    ap.add_argument("--mesh", default="single", choices=("single", "multi"))
    ap.add_argument("--json", default=None, help="write result JSON here")
    args = ap.parse_args()

    torch.set_num_threads(1)
    res = run_cell(args.arch, args.shape, multi_pod=(args.mesh == "multi"))
    text = json.dumps(res, indent=1)
    print(text)
    if args.json:
        os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
        with open(args.json, "w") as f:
            f.write(text)


if __name__ == "__main__":
    main()
