"""``SpatialShell``'s per-slot sub-meshes on several ranks: every rank of a
2- or 4-rank world builds a shell over the whole group, at 4 slots and at
2, and checks

- the slots' groups (the reference's split: with fewer ranks than slots
  the groups overlap, ``[[0], [1], [0], [1]]`` on 2 ranks; 2 slots on 4
  ranks give ``[[0, 1], [2, 3]]``);
- each ``slot_mesh``: a one-dim DeviceMesh over exactly its group, and an
  all-reduce of rank + 1 over its group that sums only the group's ranks;
- a slot's work sharded over its sub-mesh: each slot streams 4096 seeded
  fp32 16x16 products (the paper's core through the batched matmul
  kernel, ``ops.matmul_batched``) in blocks of 64; the ranks of the
  slot's group take every n-th block (n the group's size) on the slot's
  stream, all-gather the outputs over the slot's group, and every rank of
  the group holds the whole stream against the plain version; the kernel
  launches on each rank equal the blocks it ran.

    python3 tools/spatial_shell_ranks.py [--ranks 2|4] [--device cuda|cpu]

On CUDA each rank takes one card (NCCL), so ``--ranks`` cards are needed;
``--device cpu`` runs the ranks over gloo (the plain versions; a rehearsal).
Prints one JSON line, then (on CUDA) the card's name and power limit;
exits 1 if a check failed.
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

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

SEED = 0
MATS, BLOCK, SZ = 4096, 64, 16
TOL = dict(atol=2e-4 * SZ ** 0.5, rtol=2e-4)    # fp32, tests/test_kernels
GROUPS = {(2, 4): [[0], [1], [0], [1]], (2, 2): [[0], [1]],
          (4, 4): [[0], [1], [2], [3]], (4, 2): [[0, 1], [2, 3]]}


def _stream_core(a, b):
    from repro_torch.kernels import ops
    return (ops.matmul_batched(a, b),)


def shell_check(rank: int, world: int, n_slots: int, dev: str) -> dict:
    import torch.distributed as dist

    from repro_torch.kernels import _lib
    from repro_torch.kernels.stream_matmul import matmul_batched_ref
    from repro_torch.rc2f import CoreSpec, SpatialShell, StreamSpec
    shell = SpatialShell(n_slots=n_slots, device=dev)
    rec = dict(slots=n_slots, groups=shell._groups,
               groups_ok=shell._groups == GROUPS[world, n_slots])
    spec = CoreSpec(f"mm{SZ}", (StreamSpec((BLOCK, SZ, SZ)),) * 2,
                    (StreamSpec((BLOCK, SZ, SZ)),))
    sums, stream_err, mesh_ok = [], [], []
    launched = need = 0
    t0 = time.monotonic()
    for slot, group in enumerate(shell._groups):
        mesh = shell.slot_mesh(slot)
        mesh_ok.append(mesh.device_type == dev
                       and mesh.mesh.tolist() == group
                       and (mesh.get_coordinate() is None) ==
                       (rank not in group))
        if rank not in group:
            sums.append(None)
            stream_err.append(None)
            continue
        t = torch.full((4,), float(rank + 1), device=dev)
        dist.all_reduce(t, group=mesh.get_group())
        sums.append(float(t[0]))
        # the slot's stream, the same on every rank; this rank's blocks
        gen = torch.Generator(device=dev).manual_seed(SEED + slot)
        a, b = (torch.randn((MATS, SZ, SZ), generator=gen, device=dev)
                for _ in range(2))
        n, c = len(group), group.index(rank)
        shell.load(slot, _stream_core, spec, f"tenant{slot}")
        before = _lib.launches["stream_matmul_batched"]
        mine = [shell.run(slot, a[j:j + BLOCK], b[j:j + BLOCK])[0]
                for j in range(c * BLOCK, MATS, n * BLOCK)]
        shell.join()
        launched += _lib.launches["stream_matmul_batched"] - before
        need += len(mine)
        local = torch.stack(mine)                 # (blocks / n, 64, 16, 16)
        parts = [torch.empty_like(local) for _ in range(n)]
        dist.all_gather(parts, local, group=mesh.get_group())
        # block j of the stream came from rank j % n of the group
        whole = torch.stack(parts, 1).reshape(MATS, SZ, SZ)
        ref = matmul_batched_ref(a, b)
        stream_err.append(float((whole - ref).abs().max())
                          if torch.allclose(whole, ref, **TOL) else None)
    if dev == "cuda":
        torch.cuda.synchronize()
    rec.update(mesh_ok=all(mesh_ok), all_reduce_sums=sums,
               all_reduce_ok=all(s is None or s == sum(q + 1 for q in g)
                                 for s, g in zip(sums, shell._groups)),
               stream_max_abs_err=stream_err,
               stream_ok=all(e is not None for e, g in
                             zip(stream_err, shell._groups) if rank in g),
               launches=launched, launches_needed=need,
               wall_s=time.monotonic() - t0)
    # the CPU takes the plain versions, which count no launch
    rec["ok"] = (rec["groups_ok"] and rec["mesh_ok"] and rec["all_reduce_ok"]
                 and rec["stream_ok"]
                 and (launched == need if dev == "cuda" else launched == 0))
    return rec


def rank_main(rank: int, world: int, dev: str, rdv: str, out: str):
    import torch.distributed as dist
    torch.set_num_threads(1)
    if dev == "cuda":
        torch.cuda.set_device(rank)
    dist.init_process_group("nccl" if dev == "cuda" else "gloo",
                            init_method=f"file://{rdv}", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    try:
        recs = [shell_check(rank, world, n, dev) for n in (4, 2)]
        Path(out, f"rank{rank}.json").write_text(json.dumps(
            dict(rank=rank, world=world, device=dev, shells=recs,
                 ok=all(r["ok"] for r in recs))))
    finally:
        dist.destroy_process_group()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=2, choices=(2, 4))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and torch.cuda.device_count() < args.ranks:
        print(f"spatial_shell_ranks: {args.ranks} cards needed, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 1
    import torch.multiprocessing as mp
    if args.device == "cuda":
        from repro_torch.kernels import _lib
        _lib.build()                    # once, before the ranks load it
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(rank_main, args=(args.ranks, args.device,
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
