"""Run one cell of the benchmark once.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout (``BENCHMARK.json`` beside ``bench/`` and
``src/``). Earlier lines of standard output describe the run (the card,
its power and clocks, memory, graph captures and kernel launches in the
window, the page pool, counts); the last line is one JSON object with
``correct``, ``attempted``, ``failed``, ``metrics`` (``--trace 0``: the
cell's end-to-end metrics; ``--trace 1``: its per-layer metrics),
``device`` and, traced, ``breakdown``, and ``check`` last: the numbers
compared, each beside its limit (also the last lines of standard error).

Exits with 1 and prints no result where no card is visible, where the
cell asks for more cards than there are, or where JAX, flax or the JAX
package (``repro``) was loaded once the window closed or once the check
ran. ``memory_peak_bytes`` is the peak of the window (from its opening to
the close of an open loop's drain), not of set-up.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _caches() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths
    (the port's kernels build into ``src/repro_torch/kernels/_build``)."""
    cache = ROOT / "bench" / ".cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"


def loaded_forbidden(modules=None) -> list:
    """Modules of JAX, flax or the JAX package among ``modules`` (this
    process's, by default), by whole top-level name (``repro_torch`` is
    not ``repro``)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names
                   if m.split(".")[0] in FORBIDDEN})


def _refuse_forbidden() -> bool:
    """Whether JAX, flax or the JAX package is loaded; if so, says which on
    standard error (the run then prints no result)."""
    bad = loaded_forbidden()
    if bad:
        print(f"modules of {bad} are loaded in the process that measured: "
              "the benchmark runs without JAX", file=sys.stderr)
    return bool(bad)


def _line(metrics: dict) -> dict:
    return {k: {"value": v[0], "unit": v[1]} for k, v in metrics.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _caches()
    # the checkout's root and the port's sources, and not this script's
    # own directory (its module names would shadow the standard library's)
    sys.path[:] = [str(ROOT), str(ROOT / "src")] + [
        p for p in sys.path if Path(p or ".").resolve() != ROOT / "bench"]
    from bench.cell import load_cell
    cell = load_cell(args.workload, ROOT / "BENCHMARK.json")
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} card(s); CUDA "
              f"available: {torch.cuda.is_available()}, cards: "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 1
    # the loop is single-threaded and its work is on the card: few host
    # threads, so a shared host's cores cost the window less
    torch.set_num_threads(2)
    from bench.harness import Run
    log = lambda *a: print(*a, flush=True)      # noqa: E731
    run = Run(cell, args.seed, args.seconds, bool(args.trace),
              device="cuda", t_start=T_START, log=log)
    run.setup()
    run.window()
    e2e = run.results()
    view = run.window_view()
    # the window's own peak: the harness resets the count as it opens
    peak = torch.cuda.max_memory_allocated()
    if _refuse_forbidden():
        return 1
    name = torch.cuda.get_device_name(0)
    log(json.dumps({"card": name, "count": 1, "gpu_at_open": run.gpu_before,
                    "gpu_at_close": run.gpu_after}))
    log(json.dumps({"memory_peak_bytes": peak,
                    "memory_allocated_after_window":
                        torch.cuda.memory_allocated()}))
    before, after = run.programs_before, run.programs_after
    log(json.dumps({
        "window_captures": {"decode": after["decode"]["captures"]
                            - before["decode"]["captures"],
                            "prefill": after["prefill"]["captures"]
                            - before["prefill"]["captures"]},
        "window_replays": {"decode": after["decode"]["replays"]
                           - before["decode"]["replays"],
                           "prefill": after["prefill"]["replays"]
                           - before["prefill"]["replays"]},
        "window_launches": {k: after["launches"][k]
                            - before["launches"].get(k, 0)
                            for k in after["launches"]}}))
    log(json.dumps({"page_stats": run.gw.page_stats(), "counts": run.counts,
                    "setup_s": run.setup_s}))
    if args.trace:
        values = {}
        for m in cell.per_layer:
            v = m.read(view)
            if v is not None:
                values[m.name] = (v, m.unit)
        device = {"busy_s": view.device.busy_s,
                  "window_s": view.device.window_s}
    else:
        values = {m.name: (e2e[m.name], m.unit) for m in cell.end_to_end}
        missing = [k for k, (v, _) in values.items() if v is None]
        if missing:
            print(f"no reading of {missing} in the window",
                  file=sys.stderr)
            return 1
        device = {}
    run.free()
    log(json.dumps({"memory_allocated_after_free":
                    torch.cuda.memory_allocated()}))
    t0 = time.perf_counter()
    chk = run.check()
    log(json.dumps({"check_s": time.perf_counter() - t0, **chk}))
    gc.collect()
    out = {"correct": chk["correct"], "attempted": run.attempted,
           "failed": run.failed, "metrics": _line(values),
           "device": {"platform": "gpu", "kind": name, "count": 1,
                      "memory_peak_bytes": peak, **device}}
    if args.trace:
        out["breakdown"] = view.device.breakdown()
    out["check"] = chk["numbers"]
    # the check loads the reference from a file: look again before the
    # result is printed
    if _refuse_forbidden():
        return 1
    for k, v in chk["numbers"].items():
        print(f"check: {k} {v['value']} limit {v['limit']} ({chk['tokens']} "
              f"served tokens of {chk['requests']} requests)",
              file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
