"""CPU tests of the readers of the program's own record (``bench/program.py``):
each reader on a window without the record and on a worked one, the cut of
the record to the window, the idle split over the program's spans, and the
recorder hooked into the harness: nothing in an untraced run, the window's
steps in a traced one (its profiler stood in for on the CPU)."""
from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src"), str(Path(__file__).parent)):
    if p not in sys.path:
        sys.path.insert(0, p)

from bench import harness, program, trace  # noqa: E402
from bench.cell import load_cell  # noqa: E402
from bench.harness import Window  # noqa: E402
from bench.trace import DeviceTrace  # noqa: E402
from repro_torch.core.spans import Count, Records, Span  # noqa: E402
from test_bench_harness import (CLOSED, OPEN, TINY_MODEL,  # noqa: E402
                                tiny_cell)

READERS = {"decode_graph_ms": program.decode_graph_ms,
           "host_gap_ms": program.host_gap_ms,
           "prefill_ms": program.prefill_ms,
           "prefill_useful_share": program.prefill_useful_share}


def _window(records=None, device=None) -> Window:
    w = Window({}, {"page_size": 16}, 1.0, [], [], [], 0, 0, 0, device)
    w.program = records
    return w


def _step(spans, k, t, replay=None, extra=()):
    """The spans of gateway step ``k`` from host second ``t``: its root,
    ``extra`` children, the staging, the decode replay (device ms
    ``replay``) and the download; each child 0.1 s."""
    root = Span(len(spans), "gateway.step", t, t + 1.0, k, -1, -1)
    spans.append(root)
    names = [(n, req, dev) for n, req, dev in extra] + [
        ("engine.stage", -1, None), ("decode.replay", -1, replay),
        ("engine.download", -1, None)]
    for j, (name, req, dev) in enumerate(names):
        spans.append(Span(len(spans), name, t + 0.1 * (j + 1),
                          t + 0.1 * (j + 1) + 0.05, k, root.id, req, dev))


def worked() -> Records:
    """Five steps: decode-only steps 0, 1, 3, 4 (replays 20, 21, 21, 21 ms)
    and step 2, which admits request 7 (prefill 30 ms, splice 2 ms) before
    its replay. Gaps between decode-only neighbours: 0->1 8 ms, 3->4 4 ms
    (1->2 and 2->3 touch the prefill step)."""
    spans = []
    _step(spans, 0, 0.0, (0.0, 20.0))
    _step(spans, 1, 1.0, (28.0, 49.0))
    _step(spans, 2, 2.0, (95.0, 116.0), extra=[
        ("engine.admit", 7, None), ("prefill.replay", 7, (60.0, 90.0)),
        ("engine.splice", 7, (90.0, 92.0))])
    _step(spans, 3, 3.0, (125.0, 146.0))
    _step(spans, 4, 4.0, (150.0, 171.0))
    counts = [Count("prefill_positions", 2.3, 1024, 2, 7),
              Count("prefill_written", 2.4, 683, 2, 7)]
    return Records(spans, counts)


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_reads_nothing_without_the_record(name):
    read = READERS[name]
    assert read(Window({}, {}, 1.0, [], [], [], 0, 0, 0, None)) is None
    assert read(_window(None)) is None
    assert read(_window(Records([], []))) is None


@pytest.mark.parametrize("name,want", [
    ("decode_graph_ms", 21.0), ("host_gap_ms", 6.0), ("prefill_ms", 32.0),
    ("prefill_useful_share", 100.0 * 683 / 1024)])
def test_reader_on_a_worked_record(name, want):
    assert READERS[name](_window(worked())) == pytest.approx(want)


def test_decode_only_steps_and_their_gaps():
    p = worked()
    assert sorted(program.decode_only_steps(p)) == [0, 1, 3, 4]
    assert program.host_gaps_ms(p) == pytest.approx([8.0, 4.0])


def test_the_record_cut_to_the_window():
    p = worked()
    got = program.window(p, 0.9, 4.0)      # steps 1, 2, 3 lie inside
    assert sorted({s.step for s in got.spans}) == [1, 2, 3]
    assert [c.t for c in got.counts] == pytest.approx([1.4, 1.5])
    root = next(s for s in got.spans if s.step == 1 and s.parent < 0)
    assert (root.start, root.end) == pytest.approx((0.1, 1.1))
    assert root.device is None and any(s.device for s in got.spans)


def test_idle_split_over_the_spans_self_time():
    spans = [Span(0, "gateway.step", 0.0, 1.0, 0, -1, -1),
             Span(1, "engine.stage", 0.1, 0.2, 0, 0, -1),
             Span(2, "decode.replay", 0.2, 0.3, 0, 0, -1, (0.0, 1.0)),
             Span(3, "engine.download", 0.3, 0.9, 0, 0, -1)]
    assert program.self_intervals(Records(spans, [])) == pytest.approx([
        ("gateway.step", 0.0, 0.1), ("gateway.step", 0.9, 1.0),
        ("engine.stage", 0.1, 0.2), ("decode.replay", 0.2, 0.3),
        ("engine.download", 0.3, 0.9)])
    # the card busy 0.25-0.8: idle 0-0.25 and 0.8-1.2 of a 1.2 s window
    dev = DeviceTrace([("k", 0.25, 0.8)], 0.55, 1.2, {})
    line = program.idle_line(_window(Records(spans, []), dev))
    got = line["idle_by_program_span"]
    assert got == pytest.approx({"gateway.step": 0.2, "engine.stage": 0.1,
                                 "decode.replay": 0.05,
                                 "engine.download": 0.1,
                                 "between host spans": 0.2})
    assert list(got)[0] in ("gateway.step", "between host spans")
    assert line["decode_only_pairs"] == 0


def test_every_new_reader_loads_with_its_cells():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    new = {m["name"]: m["workloads"] for m in spec["per_layer"]
           if m["source"] == "program_counter"
           and m["name"] != "prefix_hit_share.chat"}
    assert sorted(new) == ["decode_graph_ms.decode", "host_gap_ms.chat",
                           "host_gap_ms.decode", "prefill_ms.chat",
                           "prefill_useful_share.chat"]
    for name, cells in new.items():
        for c in cells:
            read = {m.name: m.read for m in load_cell(
                c, ROOT / "BENCHMARK.json").per_layer}[name]
            assert read(_window(None)) is None
    assert harness.Run._program_hooked


def _run(traffic, trace_on, monkeypatch, lines):
    """A tiny cell on the CPU, closed loop 30 steps or open loop half a
    second; traced with the profiler and its markers stood in for."""
    program.install()
    if trace_on:
        class Profile:
            def __init__(self, **kw):
                pass

            def start(self):
                pass

            def stop(self):
                pass
        monkeypatch.setattr(torch.profiler, "profile", Profile)
        monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
        monkeypatch.setattr(torch.cuda, "_sleep", lambda *a: None)
        monkeypatch.setattr(trace.Tracer, "result", lambda self, t0, t1, sp:
                            DeviceTrace([("k", 0.0, 1e-3)], 1e-3, t1 - t0,
                                        {}))
    cell = tiny_cell(TINY_MODEL, traffic)
    closed = cell.traffic.closed
    run = harness.Run(cell, 7, 1e9 if closed else 0.5, trace_on,
                      device="cpu", max_steps=30 if closed else None,
                      log=lines.append)
    run.setup()
    run.window()
    run.results()
    return run, run.window_view()


def test_untraced_window_has_no_program_record(monkeypatch):
    lines = []
    run, w = _run(CLOSED, False, monkeypatch, lines)
    assert w.program is None
    assert not any("idle_by_program_span" in str(x) for x in lines)
    from repro_torch.core.spans import recorder
    assert not recorder.on and recorder.records().spans == []


@pytest.mark.parametrize("traffic", [CLOSED, OPEN], ids=["closed", "open"])
def test_traced_window_holds_its_steps(traffic, monkeypatch):
    lines = []
    run, w = _run(traffic, True, monkeypatch, lines)
    from repro_torch.core.spans import recorder
    assert not recorder.on
    roots = [s for s in w.program.spans if s.name == "gateway.step"]
    assert len(roots) == len(run.steps)
    for s, (a, b) in zip(roots, w.steps):
        assert a <= s.start <= s.end <= b
    assert 0.0 < program.prefill_useful_share(w) <= 100.0
    line = json.loads(next(x for x in lines
                           if "idle_by_program_span" in str(x)))
    assert "engine.admit" in line["idle_by_program_span"]
