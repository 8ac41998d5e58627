"""The port's span recorder: where the time of a serving step goes, on the
host and on the card. It has no module in the reference.

One process-wide ``recorder``, off by default. Switched on (``enable``),
it keeps, in lists allocated beforehand, a span for each instrumented
stretch of host work: its name, its start and end on the port's one clock
(``now``, ``time.perf_counter``: the clock of the request stamps and of
the engine's step times too), the index of the gateway step that caused
it (``-1`` outside one), the enclosing span and the request it belongs
to (an inner span takes its enclosing span's request). A span opened
with a device (a graph replay, a splice, a scrub) also records a pair of
CUDA timing events around the work it enqueues, taken in turn from a ring
of pairs made beforehand: the pair's device times are read only once the
recorder is switched off and ``records`` is called (or, where the ring
comes round to a pair again while the recorder is on, only if its end
event has completed: otherwise a new pair is made). Nothing a step does
with the recorder on waits for the card. Counts (``count``) record a
number at the point where the work happens, with the same step and
request.

Off, each instrumentation point costs one attribute test
(``recorder.on``): no record is kept and no event is recorded.

``records`` hands every finished span and count over (``Records``) and
empties the recorder. Device times are milliseconds from an anchor event
recorded just before the first pair of an on-period, on the card's own
clock: differences between them are exact to the events' resolution
(about half a microsecond); they are not on the host's clock.

Span names used by the serving path (``runtime/gateway.py``,
``runtime/serve.py``) and by every ``GraphProgram``:
``gateway.step`` (the root of each gateway step), ``gateway.monitor``,
``engine.scrub``, ``engine.admit``, ``engine.splice``,
``engine.prepare_writes``, ``engine.page_copy``, ``engine.stage`` and its
child ``engine.stage_wait``, ``engine.download``, ``engine.post``, and a
program's ``<span>.bind``, ``<span>.stage``, ``<span>.replay`` and
``<span>.capture`` (``decode`` and ``prefill`` for the engine's; a
prefill on the CPU is ``prefill.run``). Counts: ``prefill_positions``
(the padded positions a prefill computed) and ``prefill_written`` (the
context positions its splice writes).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

CAPACITY = 1 << 16      # spans allocated beforehand (more grow the lists)
PAIRS = 4096            # timing-event pairs made beforehand, a device


def now() -> float:
    """The port's one clock for spans, request stamps and step times:
    ``time.perf_counter``, in seconds."""
    return time.perf_counter()


@dataclasses.dataclass
class Span:
    """One finished span. ``id`` is its index in the on-period, ``parent``
    the enclosing span's (-1: none), ``step`` the gateway step's index
    (-1: outside one), ``request`` the request id (-1: none); ``device``
    is (start, end) in ms on the card's clock, or None."""
    id: int
    name: str
    start: float
    end: float
    step: int
    parent: int
    request: int
    device: Optional[Tuple[float, float]] = None


@dataclasses.dataclass
class Count:
    """A number recorded where the work happened, at ``t``."""
    name: str
    t: float
    value: int
    step: int
    request: int


@dataclasses.dataclass
class Records:
    """What ``Recorder.records`` hands over: spans in the order they were
    opened, and counts in the order they were made."""
    spans: List[Span]
    counts: List[Count]

    def self_seconds(self) -> Dict[int, float]:
        """Each span's self time by id: its duration less the time its
        child spans cover (children of one span do not overlap)."""
        out = {s.id: s.end - s.start for s in self.spans}
        for s in self.spans:
            if s.parent in out:
                out[s.parent] -= s.end - s.start
        return out


class _Ring:
    """Timing-event pairs of one device, handed out in turn; ``owner[k]``
    is the span holding pair ``k`` (-1: free)."""

    def __init__(self, make: Callable, n: int, device):
        self.make = make
        self.device = device            # None: a stand-in's, no stream
        self.pairs = [(make(), make()) for _ in range(n)]
        self.owner = [-1] * n
        self.next = 0
        self.anchor = make()
        self.anchored = False


class Recorder:
    """The span recorder (module docstring). ``capacity`` spans and
    ``pairs`` event pairs a device are allocated beforehand."""

    def __init__(self):
        self.on = False
        self.capacity = CAPACITY
        self.pairs = PAIRS
        self._event: Optional[Callable] = None
        self._rings: Dict[object, _Ring] = {}
        self._alloc(self.capacity)

    def _alloc(self, n: int) -> None:
        self._n = 0
        self._name: List[Optional[str]] = [None] * n
        self._t0 = [0.0] * n
        self._t1 = [-1.0] * n
        self._step = [-1] * n
        self._parent = [-1] * n
        self._req = [-1] * n
        self._pair: List[Optional[Tuple[_Ring, int]]] = [None] * n
        self._dev: Dict[int, Tuple[float, float]] = {}
        self._counts: List[Count] = []
        self._stack: List[int] = []
        self._steps = 0
        self._root = -1
        self.step = -1

    def enable(self, event: Optional[Callable] = None) -> None:
        """Switch recording on. ``event`` makes a timing event (default:
        ``torch.cuda.Event(enable_timing=True)``, and pairs only for spans
        on a CUDA device; a stand-in class gets pairs for every device, on
        no stream). The current card's ring is made here, not in a step."""
        if event is not None or self._event is not None:
            self._rings = {}            # a stand-in's rings are not kept
        self._event = event
        if event is None and torch.cuda.is_available() \
                and torch.cuda.is_initialized():
            self._ring(torch.device("cuda", torch.cuda.current_device()))
        self.on = True

    def disable(self) -> None:
        """Switch recording off; what was recorded waits for ``records``."""
        self.on = False

    # ------------------------------------------------------------------
    def root(self) -> int:
        """Open ``gateway.step``, the span of a new gateway step: later
        spans carry its index until it ends. Spans a step left open (it
        raised) are dropped from the enclosing stack."""
        self._stack.clear()
        self.step = self._steps
        self._steps += 1
        self._root = self.begin("gateway.step")
        return self._root

    def begin(self, name: str, request: Optional[int] = None,
              t: Optional[float] = None, device=None) -> int:
        """Open a span (at ``t``, or now); with ``device``, record the start
        event of a pair on its current stream. Returns the span's id."""
        i = self._n
        if i == len(self._name):
            self._grow()
        self._n = i + 1
        parent = self._stack[-1] if self._stack else -1
        self._name[i] = name
        self._step[i] = self.step
        self._parent[i] = parent
        self._req[i] = request if request is not None else (
            self._req[parent] if parent >= 0 else -1)
        if device is not None and (self._event is not None
                                   or device.type == "cuda"):
            self._pair[i] = self._start_pair(device, i)
        self._stack.append(i)
        self._t0[i] = now() if t is None else t
        return i

    def end(self, i: int, t: Optional[float] = None) -> None:
        """Close span ``i`` (at ``t``, or now), and the spans still open
        inside it; record its pair's end event. (A span that ``records``
        has already emptied away is ignored.)"""
        if i >= self._n:
            return
        self._t1[i] = now() if t is None else t
        pair = self._pair[i]
        if pair is not None:
            ring, k = pair
            ring.pairs[k][1].record(self._stream(ring))
        stack = self._stack
        if i in stack:
            del stack[stack.index(i):]
        if i == self._root:
            self.step = -1

    def count(self, name: str, value: int,
              request: Optional[int] = None) -> None:
        """Record ``value`` under ``name`` now, with the current step and
        (by default) the enclosing span's request."""
        top = self._stack[-1] if self._stack else -1
        self._counts.append(Count(
            name, now(), int(value), self.step,
            request if request is not None else
            (self._req[top] if top >= 0 else -1)))

    # ------------------------------------------------------------------
    def records(self) -> Records:
        """Every finished span and count since the last call, with device
        times; the recorder is emptied. Waits for the card's pending
        events: call it outside the steps (after ``disable``)."""
        for ring in self._rings.values():
            for k, owner in enumerate(ring.owner):
                if owner >= 0:
                    ring.pairs[k][1].synchronize()
                    self._resolve(ring, k)
            ring.anchored = False
        spans = [Span(i, self._name[i], self._t0[i], self._t1[i],
                      self._step[i], self._parent[i], self._req[i],
                      self._dev.get(i))
                 for i in range(self._n) if self._t1[i] >= 0.0]
        out = Records(spans, self._counts)
        self._alloc(self.capacity)
        return out

    # ------------------------------------------------------------------
    def _grow(self) -> None:
        n = len(self._name)
        for col, fill in ((self._name, None), (self._t0, 0.0),
                          (self._t1, -1.0), (self._step, -1),
                          (self._parent, -1), (self._req, -1),
                          (self._pair, None)):
            col.extend([fill] * n)

    def _ring(self, device) -> _Ring:
        key = device.index if device.type == "cuda" and \
            device.index is not None else str(device)
        ring = self._rings.get(key)
        if ring is None:
            if self._event is None:
                idx = device.index if device.index is not None \
                    else torch.cuda.current_device()
                ring = _Ring(lambda: torch.cuda.Event(enable_timing=True),
                             self.pairs, torch.device("cuda", idx))
            else:
                ring = _Ring(self._event, self.pairs, None)
            self._rings[key] = ring
        return ring

    def _stream(self, ring: _Ring):
        return None if ring.device is None \
            else torch.cuda.current_stream(ring.device)

    def _start_pair(self, device, i: int) -> Tuple[_Ring, int]:
        ring = self._ring(device)
        stream = self._stream(ring)
        if not ring.anchored:
            ring.anchor.record(stream)
            ring.anchored = True
        k = ring.next
        if ring.owner[k] >= 0:
            if ring.pairs[k][1].query():        # done: read it, reuse it
                self._resolve(ring, k)
            else:                               # never wait: one pair more
                k = len(ring.pairs)
                ring.pairs.append((ring.make(), ring.make()))
                ring.owner.append(-1)
        ring.next = (k + 1) % len(ring.pairs)
        ring.owner[k] = i
        ring.pairs[k][0].record(stream)
        return ring, k

    def _resolve(self, ring: _Ring, k: int) -> None:
        start, end = ring.pairs[k]
        self._dev[ring.owner[k]] = (ring.anchor.elapsed_time(start),
                                    ring.anchor.elapsed_time(end))
        ring.owner[k] = -1


recorder = Recorder()
