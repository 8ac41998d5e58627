"""Monitoring: heartbeats, failure detection, straggler mitigation.

The paper's RC3E monitors device status via the gcs registers; at pod scale
this grows into (a) node heartbeats with a miss deadline -> DEAD -> slice
re-placement, and (b) per-slice step-time tracking: a slice whose recent
step times exceed ``straggler_factor`` × fleet median for ``patience``
consecutive steps is flagged for migration.

A injectable ``clock`` makes every policy deterministic in tests.
"""
from __future__ import annotations

import statistics
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core.device_db import DeviceDB, VSlice


@dataclass
class MonitorConfig:
    heartbeat_interval_s: float = 5.0
    heartbeat_deadline_s: float = 15.0
    straggler_factor: float = 1.5
    straggler_patience: int = 3
    step_window: int = 16
    # fleet-wide traffic trend window: arrival / completion counts pushed
    # by the serving fleet each round feed the SLO-projection autoscaler
    # (scale out on *projected* p95 breach, not just backlog). The window
    # bounds BOTH the sample count and the event-time span in seconds —
    # under the event-driven loop samples arrive on the queue's clock, so
    # a burst of closely spaced rounds must not stretch the trend's
    # horizon, and a long quiet gap must age old samples out
    traffic_window: int = 32


class Monitor:
    def __init__(self, db: DeviceDB, cfg: Optional[MonitorConfig] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.db = db
        self.cfg = cfg if cfg is not None else MonitorConfig()
        self.clock = clock
        self._step_times: Dict[str, List[float]] = {}
        self._straggler_strikes: Dict[str, int] = {}
        self._pages: Dict[str, Tuple[int, int]] = {}   # dev -> (used, total)
        self._scrub: Dict[str, Tuple[int, float]] = {}  # dev -> (pages, ms)
        # (t, arrivals, completions, active_devices) per fleet round, t on
        # the injected clock (event time under the event-driven loop)
        self._traffic: List[Tuple[float, int, int, int]] = []
        # per-device completion samples (t, n) — cleared when the device
        # dies or parks, pruned to the same window otherwise
        self._dev_traffic: Dict[str, List[Tuple[float, int]]] = {}
        self.events: List[dict] = []

    # ---------------- heartbeats ----------------
    def heartbeat(self, node_id: str):
        self.db.nodes[node_id].last_heartbeat = self.clock()

    def check_heartbeats(self) -> List[VSlice]:
        """Mark nodes past deadline DEAD; return orphaned slices. A dead
        node's telemetry dies with it: its slices' step windows (they must
        not keep feeding the fleet median / straggler policy) and its
        devices' page-occupancy entries (a dead pool is not "pressured" —
        it would otherwise trip page-pressure scale-out forever)."""
        now = self.clock()
        orphans: List[VSlice] = []
        for node in list(self.db.nodes.values()):
            if not node.alive:
                continue
            if now - node.last_heartbeat > self.cfg.heartbeat_deadline_s:
                dead = self.db.mark_node_dead(node.node_id)
                for s in dead:
                    self.clear_slice(s.slice_id)
                for did in node.devices:
                    self.clear_pages(did)
                    self.clear_traffic(did)
                orphans.extend(dead)
                self.events.append({"t": now, "kind": "node_dead",
                                    "node": node.node_id,
                                    "orphans": [s.slice_id for s in dead]})
        return orphans

    # ---------------- stragglers ----------------
    def record_step(self, slice_id: str, step_ms: float):
        w = self._step_times.setdefault(slice_id, [])
        w.append(step_ms)
        if len(w) > self.cfg.step_window:
            del w[0]

    def median_step_ms(self) -> Optional[float]:
        all_recent = [t for w in self._step_times.values() for t in w]
        return statistics.median(all_recent) if all_recent else None

    def find_stragglers(self) -> List[str]:
        """Slices whose recent steps are consistently slow vs fleet median."""
        med = self.median_step_ms()
        if med is None:
            return []
        flagged = []
        for sid, w in self._step_times.items():
            recent = w[-self.cfg.straggler_patience:]
            if (len(recent) >= self.cfg.straggler_patience
                    and all(t > self.cfg.straggler_factor * med
                            for t in recent)):
                strikes = self._straggler_strikes.get(sid, 0) + 1
                self._straggler_strikes[sid] = strikes
                flagged.append(sid)
                self.events.append({"t": self.clock(), "kind": "straggler",
                                    "slice": sid, "median_ms": med,
                                    "recent_ms": recent})
            else:
                self._straggler_strikes.pop(sid, None)
        return flagged

    def clear_slice(self, slice_id: str):
        self._step_times.pop(slice_id, None)
        self._straggler_strikes.pop(slice_id, None)

    # ---------------- traffic trend (SLO projection input) ----------------
    def record_traffic(self, arrivals: int, completions: int,
                       active_devices: int,
                       by_device: Optional[Dict[str, int]] = None):
        """One fleet round's open-loop traffic sample: how many requests
        ARRIVED (were submitted), how many COMPLETED, and how many devices
        were serving. Samples are stamped with the injected clock (EVENT
        time under the event-driven loop — rounds are no longer equally
        spaced, so rates must divide by elapsed time, not sample count).
        ``by_device`` attributes completions to the device that served
        them; a dead device's samples are dropped by ``clear_traffic`` in
        the failure sweeps, so churn can never grow these windows."""
        t = float(self.clock())
        self._traffic.append((t, int(arrivals), int(completions),
                              int(active_devices)))
        self._prune_traffic(self._traffic, t)
        for dev, n in (by_device or {}).items():
            w = self._dev_traffic.setdefault(dev, [])
            w.append((t, int(n)))
            self._prune_traffic(w, t)

    def _prune_traffic(self, window: list, now: float) -> None:
        """Window discipline: cap the sample count AND age out samples
        older than ``traffic_window`` seconds of (event) time."""
        cap = self.cfg.traffic_window
        if len(window) > cap:
            del window[:len(window) - cap]
        cut = now - cap
        drop = 0
        while drop < len(window) - 1 and window[drop][0] < cut:
            drop += 1
        if drop:
            del window[:drop]

    def _traffic_span(self) -> float:
        """Elapsed time the window covers. Rounds recorded within one
        clock reading (lockstep tests with a wall clock) degenerate to
        per-sample rates: span == sample count, preserving the old
        rate-per-round semantics."""
        dt = self._traffic[-1][0] - self._traffic[0][0]
        return dt if dt > 0 else float(len(self._traffic))

    def arrival_rate(self) -> Optional[float]:
        """Arrivals per unit event-time over the traffic window (None
        until the first sample lands)."""
        if not self._traffic:
            return None
        return sum(a for _, a, _, _ in self._traffic) / self._traffic_span()

    def service_rate_per_device(self) -> Optional[float]:
        """Completions per device per unit event-time over the window —
        the μ the projection multiplies by the active-device count. The
        denominator is device-time: mean serving devices × window span.
        None until at least one sample saw a serving device."""
        if not self._traffic:
            return None
        mean_active = sum(n for _, _, _, n in self._traffic) \
            / len(self._traffic)
        dev_time = mean_active * self._traffic_span()
        if dev_time <= 0:
            return None
        return sum(c for _, _, c, _ in self._traffic) / dev_time

    def clear_traffic(self, device_id: str):
        """Drop a device's completion samples — called from the dead-device
        sweeps alongside step telemetry and page occupancy, so a device
        dying mid-window cannot leave its deque growing (or its stale
        completions flattering the fleet's service rate) forever."""
        self._dev_traffic.pop(device_id, None)

    def device_completion_rate(self, device_id: str) -> Optional[float]:
        """One device's completions per unit event-time (None: no samples)."""
        w = self._dev_traffic.get(device_id)
        if not w:
            return None
        dt = w[-1][0] - w[0][0]
        span = dt if dt > 0 else float(len(w))
        return sum(n for _, n in w) / span

    def traffic_stats(self) -> dict:
        return {"window": len(self._traffic),
                "span": self._traffic_span() if self._traffic else 0.0,
                "arrival_rate": self.arrival_rate(),
                "service_rate_per_device": self.service_rate_per_device()}

    # ---------------- KV page occupancy ----------------
    def record_pages(self, device_id: str, used: int, total: int):
        """Live KV page-pool occupancy for one device's dataplane (pushed
        by the serving gateway/fleet each step). ``find_page_pressure``
        and ``status()`` read it; clearing happens when an engine parks."""
        self._pages[device_id] = (int(used), int(total))

    def record_scrub(self, device_id: str, pages: int, ms: float):
        """Cumulative zero-on-free cost for one device's pool (pushed
        alongside ``record_pages``): how many freed pages were scrubbed
        and how many milliseconds the batched scrub dispatches cost. The
        operator's view of what the isolation policy is buying/costing."""
        self._scrub[device_id] = (int(pages), float(ms))

    def clear_pages(self, device_id: str):
        self._pages.pop(device_id, None)
        self._scrub.pop(device_id, None)

    def page_occupancy(self) -> Dict[str, float]:
        return {dev: used / max(1, total)
                for dev, (used, total) in self._pages.items()}

    def find_page_pressure(self, threshold: float = 0.85) -> List[str]:
        """Devices whose page pools run hot — the memory-side scale-out
        signal (ordered hottest first)."""
        occ = self.page_occupancy()
        hot = [dev for dev, o in occ.items() if o >= threshold]
        return sorted(hot, key=lambda dev: -occ[dev])

    # ---------------- status (gcs analogue) ----------------
    def status(self) -> dict:
        """FULL fleet view — operator/fleet paths only. Gateway-facing
        (tenant-callable) paths must use ``tenant_status``: this view
        names every tenant's slices, page grants and occupancy, which is
        exactly the cross-tenant observability the isolation threat model
        forbids handing to a co-tenant."""
        return {
            "devices": {d.device_id: {
                "state": d.state.value,
                "slots_used": d.used_slots(),
                "slices": {s.slice_id: s.state.value
                           for s in d.slices.values()},
            } for d in self.db.devices.values()},
            "utilization": self.db.utilization(),
            "pages": {dev: {"used": used, "total": total,
                            "occupancy": round(used / max(1, total), 4)}
                      for dev, (used, total) in self._pages.items()},
            "scrub": {dev: {"pages": pages, "ms": round(ms, 3)}
                      for dev, (pages, ms) in self._scrub.items()},
            "page_grants": self.db.page_grants(),
            "median_step_ms": self.median_step_ms(),
            "traffic": self.traffic_stats(),
        }

    def tenant_status(self, tenant: str) -> dict:
        """Tenant-scoped slice of ``status()``: ONLY what ``tenant`` owns
        — its slices (state + page grant) and the state of the devices
        hosting them. No co-tenant names, no shared-pool occupancy, no
        fleet medians or traffic rates: each of those is a channel a
        hostile tenant could poll to infer a co-resident's load."""
        slices = {}
        devices = {}
        for d in self.db.devices.values():
            own = {s.slice_id: {"state": s.state.value,
                                "cache_pages": s.cache_pages}
                   for s in d.slices.values() if s.owner == tenant}
            if own:
                slices.update(own)
                devices[d.device_id] = {"state": d.state.value}
        return {"tenant": tenant, "slices": slices, "devices": devices}
