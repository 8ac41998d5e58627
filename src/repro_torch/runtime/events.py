"""Deterministic event-driven serving loop (the async dataplane), ported
from ``repro.runtime.events``.

The lockstep ``GatewayFleet.step()`` is a fleet-wide barrier: every round
waits for the slowest engine, prefill stalls the whole batch, journal
syncs sit on the critical path, and a live hand-off drains its source
before the page copy even starts. This module replaces the barrier with
an **event queue** on the fleet's injected ``FakeClock``:

  * each engine advances on its OWN cadence — ``tick_s / device.speed``
    event-seconds per step — so a slow device class stops gating the
    fleet;
  * prompt prefill is chunked (``BatchingEngine.step_async``): an
    admitted request spends ``ceil(prompt / prefill_chunk)`` engine
    events in PREFILLING while the other slots keep decoding;
  * journal token-log syncs are batched: engines only MARK entries dirty
    and the loop flushes every ``flush_every`` control ticks, with the
    machine-enforced flush barrier (journal DIRTY cannot retire) forcing
    a per-request flush in front of every quota settle and hand-off
    export;
  * live migrations overlap the page copy with continued decode on the
    source: the export snapshot is taken immediately, the source keeps
    decoding for ``copy_ticks`` ticks, and adoption catches up the few
    tokens generated mid-copy (or falls back to prefix replay when the
    snapshot went stale / the copy was lost).

Everything is DETERMINISTIC: the queue orders events by ``(time, seq)``
where ``seq`` is a monotonic schedule counter, so equal-time events fire
in the order they were scheduled — two runs with the same seed, schedule
and workload are bit-identical, and the chaos tests assert
token-stream exactness of the event loop against the lockstep loop.

Determinism rule (enforced by ``python -m repro.analysis``): code in this
module must not read the fleet-wide round counter (``.steps``) — event
code paced by a round counter silently re-introduces the lockstep
barrier. The loop keeps its own ``ticks`` count.
"""
from __future__ import annotations

import heapq
import itertools
from typing import Callable, Dict, List, Optional

from repro_torch.analysis.lifecycle import sanitizer
from repro_torch.runtime.faults import FakeClock
from repro_torch.runtime.serve import Request, _req_event


class Event:
    """One scheduled callback. ``cancel`` is lazy: the queue skips
    cancelled entries at pop time (cheaper than heap surgery, and the
    skip cannot perturb ordering of live events)."""

    __slots__ = ("time", "seq", "fn", "kind", "cancelled")

    def __init__(self, time: float, seq: int, fn: Callable[[], None],
                 kind: str):
        self.time = float(time)
        self.seq = seq
        self.fn = fn
        self.kind = kind
        self.cancelled = False

    def __repr__(self):
        return f"Event(t={self.time}, seq={self.seq}, kind={self.kind!r}" \
            + (", cancelled" if self.cancelled else "") + ")"


class EventQueue:
    """Seeded-clock discrete-event queue with stable tie-breaking.

    The heap is keyed ``(time, seq)``: events at the same instant fire
    strictly in schedule order, so firing order is a pure function of the
    schedule — never of hash order, id(), or heap internals. The queue
    OWNS advancing the shared clock: popping an event sets the clock to
    that event's time (monotonically), which is how "event time" reaches
    the monitor's traffic samples and the fault injector's log."""

    def __init__(self, clock: Optional[FakeClock] = None):
        self.clock = clock if clock is not None else FakeClock()
        self._heap: List[Event] = []
        self._seq = itertools.count()
        self.fired = 0

    def at(self, t: float, fn: Callable[[], None],
           kind: str = "event") -> Event:
        """Schedule ``fn`` at absolute event time ``t`` (clamped to now —
        the past is not schedulable)."""
        ev = Event(max(float(t), self.clock()), next(self._seq), fn, kind)
        heapq.heappush(self._heap, (ev.time, ev.seq, ev))
        return ev

    def after(self, dt: float, fn: Callable[[], None],
              kind: str = "event") -> Event:
        return self.at(self.clock() + float(dt), fn, kind)

    def cancel(self, ev: Event) -> None:
        ev.cancelled = True

    def __len__(self) -> int:
        return sum(1 for (_, _, ev) in self._heap if not ev.cancelled)

    def peek(self) -> Optional[Event]:
        """Next live event without popping (cancelled ones are dropped)."""
        while self._heap:
            ev = self._heap[0][2]
            if ev.cancelled:
                heapq.heappop(self._heap)
                continue
            return ev
        return None

    def step(self) -> Optional[Event]:
        """Pop and dispatch the next live event: advance the clock to its
        time, run its callback, return it. None when the queue is empty."""
        ev = self.peek()
        if ev is None:
            return None
        heapq.heappop(self._heap)
        self.clock.t = max(self.clock.t, ev.time)
        self.fired += 1
        ev.fn()
        return ev

    def run(self, until: Optional[float] = None,
            max_events: int = 1_000_000) -> int:
        """Dispatch events up to (and including) time ``until`` (every
        event when None). Leaves the clock at ``until`` even if the last
        event fired earlier. Returns the number of events dispatched."""
        n = 0
        for _ in range(max_events):
            ev = self.peek()
            if ev is None or (until is not None and ev.time > until):
                break
            self.step()
            n += 1
        if until is not None:
            self.clock.t = max(self.clock.t, float(until))
        return n


class EventLoop:
    """The async serving loop: drives one ``GatewayFleet`` from an
    ``EventQueue`` instead of the lockstep round barrier.

    Wiring (done in the constructor):

      * the fleet's journal goes lazy (``journal_lazy``) — engine steps
        mark entries dirty, ``flush_journal`` runs every ``flush_every``
        control ticks;
      * the fleet's migration listener delegates overlapped hand-offs to
        ``_begin_handoff`` (export now, drain+adopt ``copy_ticks`` ticks
        later);
      * the fault injector's clock (when present) becomes the queue's
        clock, and ``begin_round`` stops advancing it — the queue owns
        event time.

    One CONTROL TICK per ``tick_s``: fault injection + heartbeats +
    failover sweep (``begin_round``), engine-cadence reconciliation, the
    periodic journal flush; a settlement event at the end of each tick
    window feeds the monitor's traffic sample and the autoscale/migrate
    cadences (``finish_round``). Engine events self-reschedule every
    ``tick_s / device.speed`` — a speed-0.25 device simply fires four
    times less often while the rest of the fleet decodes at full rate.
    """

    def __init__(self, fleet, tick_s: Optional[float] = None,
                 prefill_chunk: int = 4, flush_every: int = 4,
                 copy_ticks: int = 2, handoff_stale_after: int = 8):
        inj = fleet.faults
        self.fleet = fleet
        self.tick_s = float(tick_s) if tick_s is not None \
            else (inj.tick_s if inj is not None else 1.0)
        self.prefill_chunk = int(prefill_chunk)
        self.flush_every = int(flush_every)
        self.copy_ticks = int(copy_ticks)
        self.handoff_stale_after = int(handoff_stale_after)
        self.queue = EventQueue(inj.clock if inj is not None else None)
        self.ticks = 0
        self._engine_events: Dict[str, Event] = {}
        fleet.journal_lazy = True
        fleet._event_driven = True
        fleet._handoff_hook = self._begin_handoff
        # the first control tick fires at t=now, BEFORE any engine event:
        # fault injection and the failover sweep must see a round boundary
        # before any dataplane advances
        self.queue.at(self.queue.clock(), self._on_tick, kind="tick")

    # ------------------------------------------------------------------
    # Control ticks
    # ------------------------------------------------------------------
    def _on_tick(self) -> None:
        self.ticks += 1
        self.fleet.begin_round()
        self.fleet.last_round_ms = {}
        self._reconcile_engines()
        if self.flush_every and self.ticks % self.flush_every == 0:
            self.fleet.flush_journal()
        # settle BEFORE the next tick at the same instant: scheduled
        # first => lower seq => finish_round(window N) always precedes
        # begin_round(window N+1)
        self.queue.after(self.tick_s, self._finish_tick, kind="settle")
        self.queue.after(self.tick_s, self._on_tick, kind="tick")

    def _finish_tick(self) -> None:
        self.fleet.finish_round()

    def _period(self, dev: str) -> float:
        speed = getattr(self.fleet.hv.db.devices[dev], "speed", 1.0)
        return self.tick_s / max(float(speed), 1e-6)

    def _reconcile_engines(self) -> None:
        """Keep one self-rescheduling step event per live engine. Sorted
        device order makes first-schedule order (and therefore all later
        same-time tie-breaks) a pure function of the device set."""
        live = self.fleet._engines
        for dev in sorted(live):
            if dev not in self._engine_events:
                self._engine_events[dev] = self.queue.at(
                    self.queue.clock(),
                    lambda d=dev: self._on_engine(d),
                    kind=f"engine:{dev}")
        for dev in list(self._engine_events):
            if dev not in live:
                self.queue.cancel(self._engine_events.pop(dev))

    def _on_engine(self, dev: str) -> None:
        """One engine's cadence event: a guarded async step (chunked
        prefill + decode), then reschedule after this device's period.
        An engine that vanished (parked, or recovered off a dead device)
        drops its event; the next control tick re-reconciles."""
        if dev not in self.fleet._engines:
            self._engine_events.pop(dev, None)
            return
        # chunk length follows the device's class: an autotuned fleet may
        # admit prompts in bigger (fast class) or smaller (slow class)
        # prefill chunks than the loop-wide default
        self.fleet.step_engine(
            dev, prefill_chunk=self.fleet.prefill_chunk_for(
                dev, self.prefill_chunk))
        self._engine_events[dev] = self.queue.after(
            self._period(dev), lambda d=dev: self._on_engine(d),
            kind=f"engine:{dev}")

    # ------------------------------------------------------------------
    # Overlapped live hand-off (installed as fleet._handoff_hook)
    # ------------------------------------------------------------------
    def _begin_handoff(self, sess, old_dev: str, new_dev: str) -> None:
        """Phase 1, at migration time: snapshot the tenant's in-flight
        pages (behind the per-request flush barrier) WITHOUT draining —
        the source keeps decoding for the whole copy window. Remembers
        each request's generation count at export so adoption can catch
        up exactly the tokens the snapshot misses."""
        fleet = self.fleet
        source = fleet._engines.get(old_dev)
        if source is None:
            return
        payloads: Dict[int, object] = {}
        gens: Dict[int, int] = {}
        for r in source.inflight(sess.tenant):
            # flush barrier: the journal must cover everything the
            # snapshot covers before the entry can leave this engine
            fleet.flush_journal(r.request_id)
            if fleet.faults is not None and fleet.faults.fail_page_copy():
                continue            # copy lost mid-flight: replay fallback
            p = source.export_request_pages(r)
            if p is not None:
                payloads[id(r)] = p
                gens[id(r)] = len(r.out_tokens)
        fleet._handoff_begun(old_dev)
        self.queue.after(
            self.copy_ticks * self.tick_s,
            lambda: self._complete_handoff(sess, old_dev, new_dev,
                                           payloads, gens),
            kind="handoff")

    def _complete_handoff(self, sess, old_dev: str, new_dev: str,
                          payloads: Dict[int, object],
                          gens: Dict[int, int]) -> None:
        """Phase 2, ``copy_ticks`` later: drain the source and adopt on
        the tenant's CURRENT engine (which may have moved again — even to
        a recovery placement — since phase 1). Fresh snapshots import
        with a catch-up of the tokens decoded mid-copy; stale ones
        (source out-ran ``handoff_stale_after``) and lost copies fall
        back to prompt-prefix replay."""
        fleet = self.fleet
        tenant = sess.tenant
        tdev = fleet._device_of.get(tenant)
        target = None
        if tdev is not None and fleet._device_alive(tdev):
            target = fleet._engines.get(tdev)
            if target is None:
                target = fleet._ensure_engine(tdev)
        if tdev is not None and target is None:
            # the tenant's device died mid-copy and the failover sweep has
            # not re-placed it yet: retry after the next control tick
            self.queue.after(self.tick_s,
                             lambda: self._complete_handoff(
                                 sess, old_dev, new_dev, payloads, gens),
                             kind="handoff")
            return
        fleet._handoff_done(old_dev)
        source = fleet._engines.get(old_dev)
        moved: List[Request] = []
        if source is not None:
            for r in source.inflight(tenant):
                fleet.flush_journal(r.request_id)
            moved = source.drain_tenant(tenant)
            source.set_tenant_share(tenant, None)
            source.set_tenant_pages(tenant, None)
        elif target is not None:
            # the SOURCE died during the copy window: its engine (and the
            # requests' slots) are gone, and recovery skipped this tenant
            # because it was already mapped to the target device. Resume
            # from the journal, exactly like recover_device.
            for entry in list(fleet.journal.values()):
                if entry.tenant != tenant or entry.req.done.is_set() \
                        or fleet._held_elsewhere(entry.req):
                    continue
                _req_event(entry.req, "orphan")
                entry.req.out_tokens = list(entry.tokens)
                sanitizer.emit("journal",
                               (fleet._san, entry.req.request_id), "replay")
                target.resume(entry.req)
        page_copied = replayed = stale = 0
        for r in moved:
            if r.done.is_set():
                continue        # cancelled mid-copy: already settled
            if target is None:
                # session closed mid-copy: nobody will ever decode these
                from repro_torch.runtime.fleet import _mark_cancelled
                fleet._retire_entry(r.request_id)
                _mark_cancelled(r)
                continue
            payload = payloads.get(id(r))
            g = gens.get(id(r), 0)
            fresh = payload is not None \
                and len(r.out_tokens) - g <= self.handoff_stale_after
            if fresh and target.import_request_pages(
                    r, payload, ctx_len=len(r.prompt) + g):
                page_copied += 1
            else:
                if payload is not None and not fresh:
                    stale += 1
                target.resume(r)
                if payload is not None:
                    replayed += 1
        event = {"tenant": tenant, "old_device": old_dev,
                 "new_device": new_dev, "moved_requests": len(moved),
                 "page_copied": page_copied, "replayed_inflight": replayed,
                 "stale_snapshots": stale, "overlapped": True}
        fleet.handoffs.append(event)
        fleet.hv._log("handoff", **event)

    # ------------------------------------------------------------------
    # Driving
    # ------------------------------------------------------------------
    def run_ticks(self, n: int = 1) -> None:
        """Advance ``n`` control-tick windows: dispatch every event up to
        (and including) window settlement, stopping just before the
        (n+1)-th pending control tick fires."""
        target = self.ticks + int(n)
        while True:
            ev = self.queue.peek()
            if ev is None:
                return
            if ev.kind == "tick" and self.ticks >= target:
                return
            self.queue.step()

    def run_until_idle(self, max_ticks: int = 10000) -> bool:
        """Tick until every engine drained and no hand-off copy is in
        flight. Mirrors ``GatewayFleet.run_until_idle`` for the event
        path; a frozen (killed-but-undetected) engine is not a stall —
        the failover sweep recovers it once the monitor notices."""
        for _ in range(max_ticks):
            self.run_ticks(1)
            if self._idle():
                return True
        return self._idle()

    def _idle(self) -> bool:
        return not self.fleet._inflight_handoffs and \
            all(e.idle() for e in self.fleet._engines.values())
