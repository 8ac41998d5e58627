"""Readings that set the benchmark's limits and rates, on the chip, many
runs in one process (set-up once a run, no process start):

    python3 bench/calibrate.py --workload <cell> --seeds 1,2,3 \\
        --seconds 20 [--control] [--rates 3,4,5]

For each seed (and each rate, which replaces the traffic's
``rate_per_s``) it runs the cell's window as ``bench/run.py`` does and
prints one JSON line: the end-to-end numbers, the counts, every number
the check reads and, with ``--control``, the same numbers for the
reference computed through fp8 (the control). With ``--rates`` the line
also holds how the first-token times moved across the window, so a
backlog that grows shows (the knee sweep).
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--rates", default="")
    args = ap.parse_args(argv)
    sys.path[:] = [str(ROOT), str(ROOT / "src")] + [
        p for p in sys.path if Path(p or ".").resolve() != ROOT / "bench"]
    import torch
    from bench.cell import load_cell
    from bench.harness import Run, percentile
    from bench.traffic import Traffic
    if not torch.cuda.is_available():
        print("no card", file=sys.stderr)
        return 1
    cell = load_cell(args.workload, ROOT / "BENCHMARK.json")
    rates = [float(r) for r in args.rates.split(",") if r] or [None]
    for rate in rates:
        if rate is not None:
            spec = dict(cell.traffic.spec, rate_per_s=rate)
            cell = dataclasses.replace(cell,
                                       traffic=Traffic(spec["name"], spec))
        for seed in (int(s) for s in args.seeds.split(",")):
            torch.cuda.reset_peak_memory_stats()
            run = Run(cell, seed, args.seconds, False, device="cuda",
                      log=lambda *a: None)
            run.setup()
            run.window()
            e2e = run.results()
            out = {"seed": seed, "rate": rate, **e2e, **run.counts,
                   "failed": run.failed, "attempted": run.attempted,
                   "page_stats": run.gw.page_stats(),
                   "memory_peak_bytes": torch.cuda.max_memory_allocated()}
            if rate is not None:
                # first-token waits of requests due in each third
                t0, t1 = run.t_open, run.t_close
                thirds = [[] for _ in range(3)]
                for r in run.records:
                    if t0 <= r.due <= t1 and r.times:
                        k = min(2, int(3 * (r.due - t0) / (t1 - t0)))
                        thirds[k].append((r.times[0] - r.due) * 1e3)
                out["ttft_p50_by_third_ms"] = [percentile(x, 50)
                                               for x in thirds]
            run.free()
            c0 = time.perf_counter()
            chk = run.check(control=args.control)
            out.update(check_s=time.perf_counter() - c0,
                       read=chk["read"], control=chk["control"],
                       tokens_checked=chk["tokens"],
                       requests_checked=chk["requests"])
            print(json.dumps(out), flush=True)
            del run, chk
            gc.collect()
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
