"""Dry-run and roofline tables from the port's sweep results (the
reference's ``launch/report.py``), read from ``SWEEP_RESULTS_DIR``
(default ``results/dryrun_torch``). Memory is per device against the
card's 80 GB; the roofline terms are the H100's (``launch.mesh``).

Usage: PYTHONPATH=src python -m repro_torch.launch.report [--out FILE]
(prints the markdown, or writes it to FILE)
"""
from __future__ import annotations

import argparse
import glob
import json
import os

RESULTS_DIR = os.environ.get("SWEEP_RESULTS_DIR", "results/dryrun_torch")
SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
ARCH_ORDER = ["gemma3-1b", "gemma2-9b", "phi3-mini-3.8b", "smollm-135m",
              "mamba2-370m", "deepseek-v2-lite-16b", "qwen3-moe-30b-a3b",
              "zamba2-7b", "whisper-tiny", "llava-next-34b"]


def load(d: str = None):
    cells = {}
    for p in glob.glob(os.path.join(d or RESULTS_DIR, "*.json")):
        with open(p) as f:
            r = json.load(f)
        mesh = "single" if p.endswith("__single.json") else "multi"
        cells[(r.get("arch"), r.get("shape"), mesh)] = r
    return cells


def _gb(x):
    return f"{x / 2**30:.2f}"


def dryrun_table(cells, mesh: str) -> str:
    lines = [
        f"### Mesh: {'16×16 (256 GPUs)' if mesh == 'single' else '2×16×16 (512 GPUs)'}",
        "",
        "| arch | shape | trace | per-dev GiB | fits 80GB | "
        "GFLOPs/dev | dot GiB/dev | coll. wire GiB/dev | top collective |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for arch in ARCH_ORDER:
        for shape in SHAPE_ORDER:
            r = cells.get((arch, shape, mesh))
            if r is None:
                continue
            if "skipped" in r:
                lines.append(f"| {arch} | {shape} | — | — | — | — | — | — | "
                             f"skipped: {r['skipped'][:45]} |")
                continue
            if "error" in r:
                last = r["error"].strip().splitlines()[-1:] or [""]
                lines.append(f"| {arch} | {shape} | ERROR | | | | | | "
                             f"{last[0][:60]} |")
                continue
            pd = r["per_device"]
            colls = pd.get("collective_breakdown", {})
            top = max(colls, key=colls.get) if colls else "-"
            lines.append(
                f"| {arch} | {shape} | {r['trace_s']:.0f}s "
                f"| {_gb(r['memory']['per_device_bytes'])} "
                f"| {'✓' if r['memory']['fits_80GB'] else '✗'} "
                f"| {pd['flops'] / 1e9:,.0f} "
                f"| {_gb(pd['dot_bytes'])} "
                f"| {_gb(pd['collective_wire_bytes'])} "
                f"| {top} |")
    return "\n".join(lines)


def roofline_table(cells, mesh: str = "single") -> str:
    lines = [
        "| arch | shape | compute s | memory s | mem s (flash kernel) | "
        "collective s | dominant | MODEL_FLOPS | useful ratio | "
        "roofline frac | next lever |",
        "|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    levers = {
        "memory": "cut HBM traffic of the dominant products (flash "
                  "kernel / fusion)",
        "collective": "reshard to cut the top collective (overlap or axis "
                      "change)",
        "compute": "raise tensor-core utilization (already "
                   "compute-limited)",
    }
    for arch in ARCH_ORDER:
        for shape in SHAPE_ORDER:
            r = cells.get((arch, shape, mesh))
            if r is None or "skipped" in r or "error" in r:
                continue
            rl = r["roofline"]
            lines.append(
                f"| {arch} | {shape} "
                f"| {rl['compute_s']:.3g} | {rl['memory_s']:.3g} "
                f"| {rl.get('memory_s_flash_kernel', rl['memory_s']):.3g} "
                f"| {rl['collective_s']:.3g} | **{rl['dominant']}** "
                f"| {rl['model_flops_global']:.3g} "
                f"| {rl['useful_flops_ratio']:.3f} "
                f"| {rl['roofline_fraction']:.3f} "
                f"| {levers[rl['dominant']]} |")
    return "\n".join(lines)


def summary(cells) -> str:
    ok = [r for r in cells.values() if "roofline" in r]
    n_fit = sum(1 for r in ok if r["memory"]["fits_80GB"])
    n_skip = sum(1 for r in cells.values() if "skipped" in r)
    n_err = sum(1 for r in cells.values() if "error" in r)
    out = (f"- traced cells: **{len(ok)}**, fits-80GB: **{n_fit}/{len(ok)}**"
           f", documented skips: {n_skip}, errors: {n_err}")
    if ok:
        worst = min(ok, key=lambda r: r["roofline"]["roofline_fraction"])
        most = max(ok, key=lambda r: r["roofline"]["collective_s"])
        out += (f"\n- worst roofline fraction: {worst['arch']} "
                f"{worst['shape']} {worst['mesh']} "
                f"({worst['roofline']['roofline_fraction']:.3f})\n"
                f"- most collective-bound: {most['arch']} {most['shape']} "
                f"{most['mesh']} ({most['roofline']['collective_s']:.2f}s "
                "wire time)")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    cells = load()
    text = "\n".join([
        "## Dry run (the port, H100 constants)\n", summary(cells), "\n",
        dryrun_table(cells, "single"), "\n",
        dryrun_table(cells, "multi"), "\n",
        "## Roofline (single-pod 16×16)\n",
        roofline_table(cells, "single"),
    ])
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    else:
        print(text)
    return text


if __name__ == "__main__":
    main()
