"""The per-layer readers that read the program's own record: the spans,
timing-event pairs and counts of ``repro_torch``'s span recorder
(``repro_torch.core.spans``), kept in a ``--trace 1`` window.

``install`` hooks the recorder into the harness's traced window without
changing what the harness measures: the recorder is switched on just after
the profiler starts (``trace.Tracer.start``) and off as the window closes
(``trace.Tracer.stop``), and ``harness.Run.window_view`` gives the
``Window`` a ``program`` attribute, the recorder's records of the window's
gateway steps on its time base (host seconds from ``t_open``; device times
stay milliseconds on the card's own clock), or None: an untraced run, or
a program without the recorder, whose readers then read nothing. A traced
run also prints one earlier line of standard output,
``{"idle_by_program_span": {...}, ...}``: the device's idle seconds in the
window split over the program's spans (each span's self time: its interval
less its children's), with the sum of the host gaps between decode replays
over consecutive decode-only steps and the median of the harness's step
span over the steps it labels decode only.

A decode-only step is a gateway step with no admission, prefill, splice,
scrub, page copy or capture: its only device work besides the decode
graph is the staging of its inputs and the download of its ids.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

# spans whose device work sits between two decode replays: a step that has
# one is not decode-only
NOT_DECODE_ONLY = ("engine.admit", "engine.splice", "engine.scrub",
                   "engine.page_copy", "decode.capture")


def _recorder():
    """The program's span recorder, or None where the program has none."""
    try:
        from repro_torch.core.spans import recorder
    except ImportError:
        return None
    return recorder


def install() -> None:
    """Hook the recorder into the harness's traced windows (module
    docstring); once a process."""
    from bench import harness, trace
    if getattr(harness.Run, "_program_hooked", False):
        return
    start, stop = trace.Tracer.start, trace.Tracer.stop
    view = harness.Run.window_view

    def start_recording(tracer):
        start(tracer)
        rec = _recorder()
        if rec is not None:
            rec.enable()

    def stop_recording(tracer):
        rec = _recorder()
        if rec is not None:
            rec.disable()
        stop(tracer)

    def window_view(run):
        w = view(run)
        w.program = None
        rec = _recorder()
        if getattr(run, "tracer", None) is not None and rec is not None:
            w.program = window(rec.records(), run.t_open, run.t_close)
            if w.device is not None:
                run.log(json.dumps({**idle_line(w),
                                    "decode_only_step_ms_p50":
                                        decode_only_step_ms(run)}))
        return w

    trace.Tracer.start = start_recording
    trace.Tracer.stop = stop_recording
    harness.Run.window_view = window_view
    harness.Run._program_hooked = True


def window(records, t_open: float, t_close: float):
    """The gateway steps of ``records`` that lie inside [t_open, t_close]
    (host clock), with their spans and counts, host times in seconds from
    ``t_open``."""
    steps = {s.step for s in records.spans
             if s.name == "gateway.step" and s.parent < 0
             and s.start >= t_open and s.end <= t_close}
    spans = [dataclasses.replace(s, start=s.start - t_open,
                                 end=s.end - t_open)
             for s in records.spans if s.step in steps]
    counts = [dataclasses.replace(c, t=c.t - t_open)
              for c in records.counts if c.step in steps]
    return type(records)(spans, counts)


# ---------------------------------------------------------------------------
# reading
# ---------------------------------------------------------------------------

def _program(w):
    p = getattr(w, "program", None)
    return p if p is not None and p.spans else None


def _device_ms(s) -> float:
    return s.device[1] - s.device[0]


def decode_only_steps(p) -> Dict[int, List]:
    """Step index -> its decode replays (with device times, in order), for
    the decode-only steps that have one."""
    replays: Dict[int, List] = defaultdict(list)
    spoiled = set()
    for s in p.spans:
        if s.name in NOT_DECODE_ONLY or s.name.startswith("prefill."):
            spoiled.add(s.step)
        elif s.name == "decode.replay" and s.device is not None:
            replays[s.step].append(s)
    return {k: v for k, v in replays.items() if k not in spoiled}


def host_gaps_ms(p) -> List[float]:
    """Device ms from the last decode replay's end event of a decode-only
    step to the first one's start event of the next step, where that step
    is decode-only too: what the card waits on the host each step."""
    steps = decode_only_steps(p)
    return [steps[k + 1][0].device[0] - steps[k][-1].device[1]
            for k in sorted(steps) if k + 1 in steps]


def decode_graph_ms(w) -> Optional[float]:
    """Median device ms of one decode-graph replay in the window."""
    p = _program(w)
    ms = [_device_ms(s) for s in p.spans if s.name == "decode.replay"
          and s.device is not None] if p else []
    return statistics.median(ms) if ms else None


def host_gap_ms(w) -> Optional[float]:
    """Median device ms between consecutive decode-only steps' decode
    replays (``host_gaps_ms``)."""
    p = _program(w)
    gaps = host_gaps_ms(p) if p else []
    return statistics.median(gaps) if gaps else None


def prefill_ms(w) -> Optional[float]:
    """Mean device ms of one admission's prefill replay plus its splice,
    over the requests whose prefill replayed in the window."""
    p = _program(w)
    if p is None:
        return None
    per: Dict[int, float] = defaultdict(float)
    replayed = set()
    for s in p.spans:
        if s.device is None or s.request < 0:
            continue
        if s.name == "prefill.replay":
            replayed.add(s.request)
            per[s.request] += _device_ms(s)
        elif s.name == "engine.splice":
            per[s.request] += _device_ms(s)
    if not replayed:
        return None
    return sum(per[r] for r in replayed) / len(replayed)


def prefill_useful_share(w) -> Optional[float]:
    """Percent of the positions the prefills computed in the window
    (``prefill_positions``, padding included) that their splices wrote
    (``prefill_written``: neither padding nor held by shared pages)."""
    p = getattr(w, "program", None)
    if p is None:
        return None
    total: Dict[str, int] = defaultdict(int)
    for c in p.counts:
        total[c.name] += c.value
    if not total["prefill_positions"]:
        return None
    return 100.0 * total["prefill_written"] / total["prefill_positions"]


def self_intervals(p) -> List[Tuple[str, float, float]]:
    """Each span's self time as intervals (name, start, end): its own
    interval less its children's, which do not overlap each other."""
    children: Dict[int, List] = defaultdict(list)
    for s in p.spans:
        if s.parent >= 0:
            children[s.parent].append(s)
    out = []
    for s in p.spans:
        t = s.start
        for c in sorted(children[s.id], key=lambda c: c.start):
            if c.start > t:
                out.append((s.name, t, c.start))
            t = max(t, c.end)
        if s.end > t:
            out.append((s.name, t, s.end))
    return out


def decode_only_step_ms(run) -> Optional[float]:
    """Median ms of the harness's span around ``ServingGateway.step`` over
    the window's steps that it labels decode only (no prefill)."""
    ms = [(b - a) * 1e3 for (a, b), label in zip(run.steps, run.step_labels)
          if label.endswith("decode only")]
    return statistics.median(ms) if ms else None


def idle_line(w) -> dict:
    """The traced run's ``idle_by_program_span`` line: the device's idle
    seconds in the window by the span whose self time covers them (the
    rest ``"between host spans"``), and the host gaps between decode
    replays over consecutive decode-only steps (their number and sum)."""
    from bench.trace import idle_by_label, union
    p = _program(w)
    if p is None:
        return {"idle_by_program_span": {}}
    busy = union([(s, e) for _, s, e in w.device.events])
    idle = idle_by_label(busy, 0.0, w.device.window_s, self_intervals(p))
    gaps = host_gaps_ms(p)
    return {"idle_by_program_span": dict(sorted(
        idle.items(), key=lambda kv: -kv[1])),
        "decode_only_pairs": len(gaps), "host_gaps_s": sum(gaps) / 1e3}
