"""CLI entry point: ``python -m repro_torch.analysis [roots...]``.

Exit status is the contract CI relies on: 0 when every finding is either
pragma-suppressed or in the committed baseline, 1 when anything new
slipped in, 2 on usage errors. ``--write-baseline`` regenerates the
grandfather ledger (review the diff — shrinking is progress, growth is a
regression someone must justify). The port's ledger is its own file,
``analysis_baseline_torch.json`` at the repo root.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import List

from repro_torch.analysis import determinism, hostsync, kernelpass, ownership
from repro_torch.analysis.common import (Finding, Workspace,
                                         apply_suppressions, load_baseline,
                                         write_baseline)

PASSES = (ownership, hostsync, determinism, kernelpass)
BASELINE = "analysis_baseline_torch.json"


def _default_baseline(roots: List[Path]) -> Path:
    """analysis_baseline_torch.json next to the scanned tree's repo root
    (the directory holding src/), falling back to the CWD."""
    for root in roots:
        for parent in [root.resolve()] + list(root.resolve().parents):
            if (parent / BASELINE).exists() or (parent / ".git").exists():
                return parent / BASELINE
    return Path(BASELINE)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="rc3e-check over the port: ownership / hostsync / "
                    "determinism / kernel-wrapper passes")
    ap.add_argument("roots", nargs="*", default=["src/repro_torch"],
                    help="directories or files to scan (default: "
                         "src/repro_torch)")
    ap.add_argument("--baseline", type=Path, default=None,
                    help=f"grandfather ledger (default: {BASELINE} at the "
                         "repo root)")
    ap.add_argument("--write-baseline", action="store_true",
                    help="rewrite the baseline from the current findings "
                         "and exit 0")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="emit findings as JSON (all of them, with a "
                         "baselined flag)")
    args = ap.parse_args(argv)

    roots = [Path(r) for r in args.roots]
    for r in roots:
        if not r.exists():
            ap.error(f"no such path: {r}")

    ws = Workspace(roots)
    findings: List[Finding] = []
    for p in PASSES:
        findings.extend(p.run(ws))
    findings.sort(key=lambda f: (f.file, f.line, f.rule))

    baseline_path = args.baseline or _default_baseline(roots)
    if args.write_baseline:
        write_baseline(baseline_path, findings)
        print(f"rc3e-check: wrote {len({f.key() for f in findings})} "
              f"grandfathered finding keys to {baseline_path}")
        return 0

    fresh, old = apply_suppressions(findings, load_baseline(baseline_path))

    if args.as_json:
        keys = {f.key() for f in old}
        print(json.dumps([{
            "pass": f.pass_name, "rule": f.rule, "file": f.file,
            "line": f.line, "symbol": f.symbol, "message": f.message,
            "baselined": f.key() in keys,
        } for f in findings], indent=1))
        return 1 if fresh else 0

    for f in fresh:
        print(f.format())
    n_mod = len(ws.modules)
    if fresh:
        print(f"\nrc3e-check: {len(fresh)} unbaselined finding(s) across "
              f"{n_mod} modules ({len(old)} baselined). Fix them, justify "
              "with `# rc3e: allow-<rule>`, or (last resort) regenerate "
              "the baseline with --write-baseline.")
        return 1
    print(f"rc3e-check: clean — {n_mod} modules, {len(old)} baselined "
          f"finding(s), 0 new.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
