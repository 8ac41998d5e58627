"""Dry-run sweep (the reference's ``launch/sweep.py``): every
(arch × shape × mesh) cell of the port's dry run in a subprocess (each
needs a fresh fake process group), results as JSON into
``SWEEP_RESULTS_DIR`` (default ``results/dryrun_torch``, so the
reference's ``results/dryrun`` is never overwritten). A cell whose
subprocess fails is written as an error cell.

Usage (CPU):
  PYTHONPATH=src python -m repro_torch.launch.sweep            # all cells
  PYTHONPATH=src python -m repro_torch.launch.sweep --mesh single \\
      --arch gemma3-1b
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

from repro_torch.configs import SHAPES
from repro_torch.configs.registry import ARCH_IDS

RESULTS_DIR = os.environ.get("SWEEP_RESULTS_DIR", "results/dryrun_torch")


def cell_path(arch: str, shape: str, mesh: str) -> str:
    return os.path.join(RESULTS_DIR, f"{arch}__{shape}__{mesh}.json")


def run_one(arch: str, shape: str, mesh: str, timeout: int = 3000,
            force: bool = False) -> dict:
    out = cell_path(arch, shape, mesh)
    if os.path.exists(out) and not force:
        with open(out) as f:
            return json.load(f)
    env = dict(os.environ)
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
           "--shape", shape, "--mesh", mesh, "--json", out]
    t0 = time.time()
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=timeout, env=env)
    if proc.returncode != 0:
        err = {"arch": arch, "shape": shape, "mesh": mesh,
               "error": proc.stderr[-2000:], "wall_s": time.time() - t0}
        os.makedirs(RESULTS_DIR, exist_ok=True)
        with open(out, "w") as f:
            json.dump(err, f, indent=1)
        return err
    with open(out) as f:
        return json.load(f)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default=None, choices=(None, "single", "multi"))
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else list(ARCH_IDS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = [args.mesh] if args.mesh else ["single", "multi"]

    os.makedirs(RESULTS_DIR, exist_ok=True)
    n_total = len(archs) * len(shapes) * len(meshes)
    i = 0
    for mesh in meshes:
        for arch in archs:
            for shape in shapes:
                i += 1
                t0 = time.time()
                res = run_one(arch, shape, mesh, force=args.force)
                dt = time.time() - t0
                status = ("SKIP " + res.get("skipped", "")[:40]
                          if "skipped" in res else
                          "ERROR" if "error" in res else
                          f"ok fits={res['memory']['fits_80GB']} "
                          f"dom={res['roofline']['dominant']}")
                print(f"[{i}/{n_total}] {arch} {shape} {mesh}: {status} "
                      f"({dt:.0f}s)", flush=True)


if __name__ == "__main__":
    main()
