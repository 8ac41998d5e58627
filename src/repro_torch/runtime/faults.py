"""Deterministic fault injection for the serving fleet + hypervisor (a copy
of ``repro.runtime.faults``, which imports nothing of JAX).

The paper's hypervisor "monitors the status of the physical FPGAs" so that
virtual user designs survive device-level events; this module supplies the
adversarial half of that contract. A ``FaultInjector`` owns a seeded RNG
and an injectable ``FakeClock`` and can, at any *step boundary* of
``GatewayFleet.step()``:

  * **kill** a node or a single device (the dataplane freezes instantly;
    a node kill is detected only when the heartbeat deadline expires, a
    device kill is reported immediately — the gcs status-read-error
    analogue);
  * **partition** a node (heartbeats stop, the device keeps decoding) and
    later **heal** it — a partition shorter than the deadline must be
    survivable without any recovery;
  * **fail individual hand-off page copies**, forcing the fleet's
    migration path down its prefix-replay fallback.

Everything is derived from the seed and the schedule: two runs with the
same seed, schedule and workload are bit-identical, which is what lets
the chaos tests assert token-stream exactness against a
fault-free run instead of merely "it didn't crash".
"""
from __future__ import annotations

import dataclasses
import random
from typing import List, Optional, Sequence, Set


def seeded_rng(seed: int) -> random.Random:
    """The one sanctioned constructor for runtime randomness.

    Every RNG in the serving stack must come from here with an explicit
    seed — the determinism pass (``python -m repro.analysis``) flags any
    ``random.Random``/``random.*`` use outside this function, so replay
    guarantees ("same seed, same run") survive refactors. Centralizing
    construction also gives one place to later swap the generator or log
    seed derivations.
    """
    return random.Random(int(seed))


class FakeClock:
    """Injectable monotonic clock. Hand the SAME instance to the
    ``Hypervisor`` (heartbeat deadlines) and the ``FaultInjector`` (which
    advances it one ``tick_s`` per fleet step), so failure detection
    latency is measured in decode steps, not wall time."""

    def __init__(self, t: float = 0.0):
        self.t = float(t)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> float:
        self.t += dt
        return self.t


@dataclasses.dataclass
class FaultEvent:
    """One scheduled fault: fires the first tick whose step >= ``step``."""
    step: int
    kind: str           # kill_node | kill_device | partition_node | heal_node
    target: str
    fired: bool = False


class FaultInjector:
    """Seeded, schedule-driven chaos for one hypervisor + fleet.

    The fleet calls ``tick(hv)`` at the top of every ``step()``: the clock
    advances, due events fire, and every alive, non-silenced node
    heartbeats. The fleet also consults ``is_dead(node, device)`` before
    stepping an engine (a killed device must stop decoding the instant it
    dies, not when the monitor notices) and ``fail_page_copy()`` per
    exported request during a live hand-off.
    """

    def __init__(self, seed: int = 0, clock: Optional[FakeClock] = None,
                 tick_s: float = 1.0, page_copy_fail_rate: float = 0.0):
        self.seed = seed
        self.rng = seeded_rng(seed)
        self.clock = clock if clock is not None else FakeClock()
        self.tick_s = tick_s
        self.page_copy_fail_rate = page_copy_fail_rate
        self.events: List[FaultEvent] = []
        self.steps = 0
        self._silenced: Set[str] = set()       # nodes not heartbeating
        self._killed_nodes: Set[str] = set()   # crashed: dataplane frozen
        self._killed_devices: Set[str] = set()
        self.log: List[dict] = []

    # ---------------- schedule ----------------
    def _schedule(self, step: int, kind: str, target: str) -> FaultEvent:
        ev = FaultEvent(int(step), kind, target)
        self.events.append(ev)
        return ev

    def kill_node_at(self, step: int, node_id: str) -> FaultEvent:
        """Crash a whole node: its engines freeze immediately, heartbeats
        stop, and the monitor declares it dead one deadline later."""
        return self._schedule(step, "kill_node", node_id)

    def kill_device_at(self, step: int, device_id: str) -> FaultEvent:
        """Kill one device. Detection is immediate (status-read error)."""
        return self._schedule(step, "kill_device", device_id)

    def partition_node_at(self, step: int, node_id: str) -> FaultEvent:
        """Silence a node's heartbeats WITHOUT stopping its dataplane."""
        return self._schedule(step, "partition_node", node_id)

    def heal_node_at(self, step: int, node_id: str) -> FaultEvent:
        return self._schedule(step, "heal_node", node_id)

    def plan_device_kill(self, device_ids: Sequence[str], lo: int,
                         hi: int) -> FaultEvent:
        """Seeded adversarial schedule: kill one of ``device_ids`` at a
        step drawn from [lo, hi). Sorted first so the draw depends only on
        the seed and the id set, never on dict/iteration order."""
        step = self.rng.randrange(lo, hi)
        target = self.rng.choice(sorted(device_ids))
        return self.kill_device_at(step, target)

    def plan_node_kill(self, node_ids: Sequence[str], lo: int,
                       hi: int) -> FaultEvent:
        step = self.rng.randrange(lo, hi)
        target = self.rng.choice(sorted(node_ids))
        return self.kill_node_at(step, target)

    def plan_soak(self, device_ids: Sequence[str], node_ids: Sequence[str],
                  lo: int, hi: int, kills: int = 1,
                  partitions: int = 1,
                  partition_len: int = 2) -> List[FaultEvent]:
        """Seeded mixed-fault schedule for one soak-matrix cell: ``kills``
        device kills plus ``partitions`` transient node partitions (each
        healed ``partition_len`` steps later), all targets and steps drawn
        from the seed inside [lo, hi). Targets are drawn from sorted id
        lists so the schedule depends only on (seed, id sets) — never on
        iteration order. Returns the scheduled events."""
        planned: List[FaultEvent] = []
        for _ in range(kills):
            if device_ids:
                planned.append(self.plan_device_kill(device_ids, lo, hi))
        for _ in range(partitions):
            if node_ids:
                step = self.rng.randrange(lo, hi)
                target = self.rng.choice(sorted(node_ids))
                planned.append(self.partition_node_at(step, target))
                planned.append(self.heal_node_at(step + partition_len,
                                                 target))
        return planned

    # ---------------- runtime hooks ----------------
    def tick(self, hv, advance_clock: bool = True) -> List[FaultEvent]:
        """One step boundary: advance the clock, fire due events, then
        heartbeat every alive, non-silenced node. Returns the events that
        fired this tick.

        ``advance_clock=False`` is the event-driven mode: the
        ``EventQueue`` owns the shared clock and has already set event
        time when the tick event fires, so advancing here would
        double-count. The fault SCHEDULE stays step-indexed either way —
        chaos timing is a pure function of the seed, not of who owns the
        clock."""
        step = self.steps
        self.steps += 1
        if advance_clock:
            self.clock.advance(self.tick_s)
        fired = []
        for ev in self.events:
            if not ev.fired and ev.step <= step:
                ev.fired = True
                self._fire(hv, ev, step)
                fired.append(ev)
        for node_id, node in hv.db.nodes.items():
            if node.alive and node_id not in self._silenced:
                hv.monitor.heartbeat(node_id)
        return fired

    def _fire(self, hv, ev: FaultEvent, step: int):
        if ev.kind == "kill_node":
            self._silenced.add(ev.target)
            self._killed_nodes.add(ev.target)
        elif ev.kind == "kill_device":
            self._killed_devices.add(ev.target)
            hv.mark_device_failed(ev.target, reason="fault_injector")
        elif ev.kind == "partition_node":
            self._silenced.add(ev.target)
        elif ev.kind == "heal_node":
            self._silenced.discard(ev.target)
        else:
            raise ValueError(f"unknown fault kind {ev.kind!r}")
        self.log.append({"t": self.clock(), "step": step, "kind": ev.kind,
                         "target": ev.target})

    def is_dead(self, node_id: str, device_id: str) -> bool:
        """Has this (node, device) crashed — whether or not the control
        plane has noticed yet? The fleet must not step a dead engine
        during the heartbeat detection window."""
        return node_id in self._killed_nodes \
            or device_id in self._killed_devices

    def fail_page_copy(self) -> bool:
        """Seeded per-request arbitration of hand-off page-copy failures
        (interconnect loss mid-migration). The fleet falls back to
        prompt-prefix replay for that request."""
        if self.page_copy_fail_rate <= 0.0:
            return False
        failed = self.rng.random() < self.page_copy_fail_rate
        if failed:
            self.log.append({"t": self.clock(), "step": self.steps,
                             "kind": "page_copy_fail"})
        return failed
