"""Runtime lifecycle sanitizer (``RC3E_SANITIZE=1``).

The static passes check discipline at rest; this module checks it in
motion. Each RC3E object class has one declarative state machine — a
transition table mapping ``(state, event) -> state`` — and the runtime
emits events at its lifecycle points (engine admit/preempt/finish, fleet
drain/adopt/recover, pool alloc/free, device activate/kill, journal
append/retire). An emit that has no legal transition raises
``LifecycleViolation`` at the exact call site, so a chaos seed that
races e.g. a double-release dies loudly instead of corrupting counters.

Intentionally stdlib-only and branch-free when disabled: ``emit`` is a
single attribute load + early return unless ``RC3E_SANITIZE=1`` (or a
test called ``enable()``), so the production hot path pays one predictable
branch per event point.

Keys are caller-chosen; for per-instance machines (engines, pools) the
owner takes a ``scope()`` token at construction and namespaces its keys
with it — monotonic tokens, never ``id()``, so a GC'd engine's slot 3
can never collide with a new engine's slot 3.
"""
from __future__ import annotations

import dataclasses
import os
import threading
from typing import Dict, FrozenSet, Mapping, Tuple


class LifecycleViolation(AssertionError):
    """An object was driven through an illegal lifecycle transition."""


@dataclasses.dataclass(frozen=True)
class Machine:
    """One lifecycle as data: states are strings, events are strings.
    ``pop_terminal`` drops the key at a terminal state so caller-chosen
    keys (request tokens, journal ids) stay bounded; sticky terminals
    (devices) keep the entry so post-mortem events still violate."""
    initial: str
    transitions: Mapping[Tuple[str, str], str]
    terminal: FrozenSet[str] = frozenset()
    pop_terminal: bool = True

    def legal_events(self, state: str):
        return sorted(e for (s, e) in self.transitions if s == state)


MACHINES: Dict[str, Machine] = {
    # A request as the engine+fleet see it. PREFILLING = admitted to a
    # slot but its prompt prefill is not yet spliced (the event loop
    # chunks it — ``chunk`` self-loops once per chunk event; the lockstep
    # loop passes through it in one admit→ready breath). TRANSIT =
    # drained for a live hand-off; ORPHANED = its device died while it
    # was queued/decoding. ``requeue`` (engine.resume) is legal from
    # QUEUED too: preemption emits preempt first, so resume's requeue
    # self-loops — but a resume of a RUNNING or DONE request is the bug
    # class this machine exists to catch (double-queue /
    # decode-after-settle).
    "request": Machine(
        initial="NEW",
        transitions={
            ("NEW", "submit"): "QUEUED",
            ("QUEUED", "admit"): "PREFILLING",
            ("QUEUED", "requeue"): "QUEUED",
            ("QUEUED", "orphan"): "ORPHANED",
            ("QUEUED", "cancel"): "DONE",
            ("PREFILLING", "chunk"): "PREFILLING",
            ("PREFILLING", "ready"): "RUNNING",
            ("PREFILLING", "drain"): "TRANSIT",
            ("PREFILLING", "orphan"): "ORPHANED",
            ("PREFILLING", "cancel"): "DONE",
            ("RUNNING", "preempt"): "QUEUED",
            ("RUNNING", "drain"): "TRANSIT",
            ("RUNNING", "orphan"): "ORPHANED",
            ("RUNNING", "finish"): "DONE",
            ("RUNNING", "cancel"): "DONE",
            ("TRANSIT", "requeue"): "QUEUED",
            ("TRANSIT", "adopt"): "RUNNING",
            ("TRANSIT", "cancel"): "DONE",
            ("ORPHANED", "requeue"): "QUEUED",
            ("ORPHANED", "cancel"): "DONE",
        },
        terminal=frozenset({"DONE"})),
    # One engine decode slot. occupy/release must alternate exactly.
    "slot": Machine(
        initial="FREE",
        transitions={
            ("FREE", "occupy"): "BUSY",
            ("BUSY", "release"): "FREE",
        }),
    # One KV-cache page in the pool. alloc/free must alternate; shares
    # (prefix-adoption increfs) and unshares (COW detach) only while
    # allocated — a decref of a free page is a double-free. ``scrub``
    # (zero-on-free) is only legal while FREE: a scrub racing a
    # reallocation would zero a live tenant's KV and is the exact bug
    # class the isolation hardening must never ship.
    "page": Machine(
        initial="FREE",
        transitions={
            ("FREE", "alloc"): "USED",
            ("FREE", "scrub"): "FREE",
            ("USED", "share"): "USED",
            ("USED", "unshare"): "USED",
            ("USED", "free"): "FREE",
        }),
    # A physical device in the DeviceDB. DEAD is terminal AND sticky:
    # failed hardware never silently returns to the pool, and any event
    # against a dead device is a violation. ``park`` self-loops from
    # PARKED (idempotent energy gating, incl. DBs restored from JSON).
    "device": Machine(
        initial="PARKED",
        transitions={
            ("PARKED", "activate"): "ACTIVE",
            ("PARKED", "exclusive"): "EXCLUSIVE",
            ("PARKED", "park"): "PARKED",
            ("ACTIVE", "activate"): "ACTIVE",      # more slices
            ("ACTIVE", "park"): "PARKED",
            ("EXCLUSIVE", "park"): "PARKED",
            ("PARKED", "kill"): "DEAD",
            ("ACTIVE", "kill"): "DEAD",
            ("EXCLUSIVE", "kill"): "DEAD",
        },
        terminal=frozenset({"DEAD"}),
        pop_terminal=False),
    # A fleet journal entry: append exactly once, replay while open only,
    # retire exactly once. The event loop batches token syncs off the
    # critical path: ``dirty`` marks the entry stale vs the live request,
    # ``flush`` copies the token log back (DIRTY→OPEN), and ``rollback``
    # abandons unflushed tokens when their device died (crash recovery
    # replays from the last flush). Retire is ONLY legal from OPEN — that
    # is the machine-enforced flush barrier: quota can never settle, and
    # a hand-off can never export, against a dirty entry. RETIRED pops
    # the key, so a replay after retire resolves against NEW — still
    # illegal, which is exactly the "settled request replayed by
    # recovery" bug.
    "journal": Machine(
        initial="NEW",
        transitions={
            ("NEW", "append"): "OPEN",
            ("OPEN", "replay"): "OPEN",
            ("OPEN", "dirty"): "DIRTY",
            ("DIRTY", "dirty"): "DIRTY",
            ("DIRTY", "flush"): "OPEN",
            ("DIRTY", "rollback"): "OPEN",
            ("OPEN", "retire"): "RETIRED",
        },
        terminal=frozenset({"RETIRED"})),
}


class Sanitizer:
    """Process-wide transition checker. Disabled it costs one branch."""

    def __init__(self) -> None:
        self.enabled = os.environ.get("RC3E_SANITIZE", "") == "1"
        self._lock = threading.Lock()
        self._state: Dict[Tuple[str, object], str] = {}
        self._counts: Dict[str, int] = {}
        self._scope = 0

    # -- control -------------------------------------------------------
    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def reset(self) -> None:
        with self._lock:
            self._state.clear()
            self._counts.clear()

    def scope(self) -> int:
        """Fresh namespace token for a per-instance machine owner. Unlike
        ``id()``, never reused after the owner is collected."""
        with self._lock:
            self._scope += 1
            return self._scope

    # -- the event point -----------------------------------------------
    def emit(self, machine: str, key, event: str) -> None:
        if not self.enabled:
            return
        m = MACHINES[machine]
        k = (machine, key)
        with self._lock:
            state = self._state.get(k, m.initial)
            nxt = m.transitions.get((state, event))
            if nxt is None:
                raise LifecycleViolation(
                    f"[{machine}] {key!r}: illegal event {event!r} in "
                    f"state {state!r} (legal: "
                    f"{m.legal_events(state) or 'none — terminal'})")
            self._counts[machine] = self._counts.get(machine, 0) + 1
            if nxt in m.terminal and m.pop_terminal:
                self._state.pop(k, None)   # key retired; id can recycle
            else:
                self._state[k] = nxt

    # -- introspection (chaos harness asserts on this) ------------------
    def stats(self) -> Dict[str, int]:
        """Transitions checked per machine since the last reset."""
        with self._lock:
            return dict(self._counts)

    def live(self, machine: str) -> int:
        """Objects currently in a non-initial, non-terminal state."""
        with self._lock:
            return sum(1 for (m, _) in self._state if m == machine)

    def state(self, machine: str, key) -> str:
        """Current state of one tracked object (tests peek at this)."""
        with self._lock:
            return self._state.get((machine, key), MACHINES[machine].initial)


sanitizer = Sanitizer()
