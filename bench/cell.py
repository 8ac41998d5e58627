"""Find a cell's parts by the names ``BENCHMARK.json`` gives them: its
configuration file, its traffic file (``traffic/<name>.json``), its
end-to-end metrics and the readers of its per-layer metrics
(``metrics/<name>.py``, each with a ``read(window)`` function). A cell,
a configuration, a traffic mix or a metric is added by adding files and
an entry of ``BENCHMARK.json``, never by editing code.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional

from bench.traffic import Traffic

HERE = Path(__file__).resolve().parent


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    read: Optional[Callable] = None      # per-layer metrics only


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: Traffic
    end_to_end: List[Metric]
    per_layer: List[Metric]


def load_reader(name: str, base: Path = HERE) -> Callable:
    """``metrics/<name>.py``'s ``read`` (under ``base``)."""
    path = base / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _reports(metric: dict, cell: str, moved: Dict[str, List[str]]) -> bool:
    """Whether a metric is reported in ``cell``: its ``workloads`` list
    where it has one; else every cell (an end-to-end metric), or every
    cell that reports the end-to-end metric it moves (per-layer)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    if "moves" in metric:
        return cell in moved[metric["moves"]]
    return True


def load_cell(name: str, bench_json: Path) -> Cell:
    """The cell ``name`` of ``bench_json``. Paths in it are relative to the
    file's directory, the root of the checkout."""
    root = bench_json.resolve().parent
    base = root / HERE.name            # this directory, in that checkout
    spec = json.loads(bench_json.read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {bench_json}; know "
                       f"{sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = Traffic.load(base / "traffic" / f"{w['traffic']}.json")
    moved = {m["name"]: [c for c in cells if _reports(m, c, {})]
             for m in spec["end_to_end"]}
    e2e = [Metric(m["name"], m["unit"])
           for m in spec["end_to_end"] if _reports(m, name, moved)]
    layer = [Metric(m["name"], m["unit"], load_reader(m["name"], base))
             for m in spec["per_layer"] if _reports(m, name, moved)]
    return Cell(name, int(w["chips"]), config, traffic, e2e, layer)
