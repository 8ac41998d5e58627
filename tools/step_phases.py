"""Where a serving step's time goes, untraced: one benchmark cell driven
through ``bench.harness.Run`` without the profiler, in windows with the
port's span recorder (``repro_torch.core.spans``) switched on and off in
turn, in one process.

    python3 tools/step_phases.py --workload phi3-mini.decode_backlog \\
        --seed 5900000001 [--seconds 20] [--windows 6] [--device cuda]

from the root of a checkout. The windows follow off, on, on, off, off,
on, ... (each side as often as the other for a multiple of 4, and spread
over the process's drift). Each window prints one JSON line: the cell's
end-to-end numbers (``tokens_per_s``, or the gap tail of an open loop),
the median step of the harness's span around ``ServingGateway.step``
(over all steps, and over those without a prefill), and, with the
recorder on, for each span name its count and the median and 95th
percentile of its self ms (its duration less its children's), the
median device ms of a decode-graph replay, the median host gap
between the replays of consecutive decode-only steps
(``bench/program.py``), the mean device ms of a prefill with its splice
and the prefill's useful share. The last line sets the on windows'
median rate beside the off windows' (the recorder's cost) and prints the
card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def pattern(n: int) -> list:
    """Whether the recorder is on in each of ``n`` windows: off, on, on,
    off, off, on, ..."""
    return [i % 4 in (1, 2) for i in range(n)]


def span_stats(records) -> dict:
    """Per span name: count, median and 95th percentile of self ms."""
    from bench.harness import percentile
    self_s = records.self_seconds()
    by = defaultdict(list)
    for s in records.spans:
        by[s.name].append(self_s[s.id] * 1e3)
    return {k: {"n": len(v), "self_ms_p50": statistics.median(v),
                "self_ms_p95": percentile(v, 95)}
            for k, v in sorted(by.items())}


def phases(run, windows: int, log=print) -> list:
    """Run ``windows`` windows of a set-up ``run``, the recorder on in
    those ``pattern`` picks; one dict a window (also logged as JSON)."""
    from bench import program
    from repro_torch.core.spans import recorder
    out = []
    for i, on in enumerate(pattern(windows)):
        if on:
            recorder.enable()
        run.window()
        recorder.disable()
        e2e = run.results()
        row = {"window": i, "recorder": on,
               **{k: v for k, v in e2e.items() if k != "setup_s"},
               "step_ms_p50": run.counts["step_ms_p50"],
               "decode_only_step_ms_p50": program.decode_only_step_ms(run),
               "steps": run.counts["steps"]}
        got = recorder.records()
        if on:
            p = program.window(got, run.t_open, run.t_close)
            w = run.window_view()
            w.program = p
            row.update(
                decode_graph_ms=program.decode_graph_ms(w),
                host_gap_ms=program.host_gap_ms(w),
                decode_only_pairs=len(program.host_gaps_ms(p)),
                prefill_ms=program.prefill_ms(w),
                prefill_useful_share=program.prefill_useful_share(w),
                spans=span_stats(p))
        log(json.dumps(row))
        out.append(row)
    return out


def summary(rows: list) -> dict:
    """The on windows' median rate (or gap tail) beside the off windows'."""
    key = "tokens_per_s" if rows[0].get("tokens_per_s") is not None \
        and rows[0].get("ttft_p95_ms") is None else "itl_p95_ms"
    side = {on: [r[key] for r in rows if r["recorder"] is on]
            for on in (False, True)}
    med = {on: statistics.median(v) if v else None
           for on, v in side.items()}
    cost = None
    if med[False] and med[True]:
        cost = 100.0 * (med[False] - med[True]) / med[False]
        if key != "tokens_per_s":
            cost = -cost
    return {"metric": key, "off": side[False], "on": side[True],
            "off_median": med[False], "on_median": med[True],
            "recorder_cost_pct": cost}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--windows", type=int, default=6)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from bench.cell import load_cell
    from bench.harness import Run, gpu_state
    cell = load_cell(args.workload, ROOT / "BENCHMARK.json")
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("no CUDA device: step phases are measured on the card",
              file=sys.stderr)
        return 1
    torch.set_num_threads(2)            # as bench/run.py
    run = Run(cell, args.seed, args.seconds, False, device=args.device,
              log=lambda *a: print(*a, file=sys.stderr))
    run.setup()
    rows = phases(run, args.windows)
    print(json.dumps({"workload": args.workload, "seed": args.seed,
                      **summary(rows), "card": gpu_state()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
