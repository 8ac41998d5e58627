"""RC3E hypervisor (paper §IV): the control plane tying together the device
database, program cache / partial reconfiguration, batch scheduler and
monitor, and exposing the three cloud service models:

  RSaaS  - allocate a full physical device, run arbitrary programs
  RAaaS  - allocate a vSlice, plug a user core into the RC2F shell
  BAaaS  - invoke a provider-prebuilt service (model zoo), allocation hidden

Serving traffic enters through the *tenant session* API
(``open_serving_session`` / ``record_served_request`` /
``close_serving_session``): the serving gateway (``runtime/gateway.py`` of
the reference, still to port) binds every tenant to a hypervisor-allocated
vSlice, and per-step telemetry flows into the straggler monitor so hot
tenants get migrated like any other workload.

The "physical devices" are a simulated inventory; the dataplane executes on
``device`` (the card unless the caller passes ``device="cpu"``; raises where
CUDA is absent), where the reconfigurator places every configured program.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.core.device_db import (DeviceDB, DeviceState,
                                        NoCapacityError, SliceState, VSlice)
from repro_torch.core.monitor import Monitor, MonitorConfig
from repro_torch.core.reconfig import (ProgramCache, ProgramEntry,
                                       Reconfigurator)
from repro_torch.core.scheduler import BatchScheduler, JobState
from repro_torch.rc2f.admission import AdmissionController, AdmissionError


@dataclass
class ClusterSpec:
    """Inventory description, e.g. 2 nodes × 2 devices × 256 chips.
    ``cache_pages_per_device`` meters each device's KV page pool (0 =
    unmetered): page-bearing vSlice grants are then packed against it.
    ``device_draws`` assigns per-device power draws (cycled over the
    fleet-wide device index) for heterogeneous energy accounting; empty
    means a homogeneous fleet of draw 1.0. ``device_speeds`` does the
    same for relative dataplane speed: the event-driven serving loop
    steps each engine every ``tick_s / speed`` event-seconds, so mixed
    device classes decode on their own cadence."""
    n_nodes: int = 2
    devices_per_node: int = 2
    chips_per_device: int = 256
    cache_pages_per_device: int = 0
    device_draws: Tuple[float, ...] = ()
    device_speeds: Tuple[float, ...] = ()


class Hypervisor:
    def __init__(self, spec: Optional[ClusterSpec] = None,
                 monitor_cfg: Optional[MonitorConfig] = None,
                 clock: Callable[[], float] = time.monotonic,
                 admission: Optional[AdmissionController] = None,
                 device="cuda"):
        spec = spec if spec is not None else ClusterSpec()
        self.db = DeviceDB()
        for ni in range(spec.n_nodes):
            node = self.db.add_node(f"node-{ni}")
            node.last_heartbeat = clock()
            for di in range(spec.devices_per_node):
                idx = ni * spec.devices_per_node + di
                draw = spec.device_draws[idx % len(spec.device_draws)] \
                    if spec.device_draws else 1.0
                speed = spec.device_speeds[idx % len(spec.device_speeds)] \
                    if spec.device_speeds else 1.0
                self.db.add_device(f"dev-{ni}-{di}", node.node_id,
                                   spec.chips_per_device,
                                   cache_pages=spec.cache_pages_per_device,
                                   draw=draw, speed=speed)
        self.reconfig = Reconfigurator(ProgramCache(), device=device)
        self.device = self.reconfig.device
        self.scheduler = BatchScheduler(self.db, clock)
        self.monitor = Monitor(self.db,
                               monitor_cfg if monitor_cfg is not None
                               else MonitorConfig(), clock)
        # the controller's rate-limit buckets refill on the hypervisor's
        # clock — a FakeClock-driven harness rate-limits in event time
        self.admission = admission if admission is not None \
            else AdmissionController(clock=clock)
        self.clock = clock
        self.services: Dict[str, Callable[[], Any]] = {}
        self.log: List[dict] = []
        self.last_migrations: List[Tuple[str, str]] = []
        # called with (old_slice_id, new_slice_id) on every migration, so
        # components holding slice handles (serving gateway) rebind at the
        # source instead of polling
        self.migration_listeners: List[Callable[[str, str], None]] = []

    # ------------------------------------------------------------------
    # Middleware entry points (paper §IV-C)
    # ------------------------------------------------------------------
    def status(self) -> dict:
        """RC2F status call analogue (Table I row 1)."""
        return self.monitor.status()

    # ---------------- RSaaS ----------------
    def allocate_physical(self, owner: str,
                          device_id: Optional[str] = None):
        dev = self.db.allocate_exclusive(owner, device_id)
        self._log("rsaas_alloc", owner=owner, device=dev.device_id)
        return dev

    # ---------------- RAaaS ----------------
    def allocate_vslice(self, owner: str, slots: int = 1,
                        service_model: str = "raas",
                        cache_pages: int = 0) -> VSlice:
        vs = self.db.allocate_slice(owner, slots, service_model,
                                    cache_pages=cache_pages)
        self._log("vslice_alloc", owner=owner, slice=vs.slice_id,
                  device=vs.device_id, slots=slots, cache_pages=cache_pages)
        return vs

    def release(self, slice_id: str):
        self.db.release(slice_id)
        self.monitor.clear_slice(slice_id)
        self._log("release", slice=slice_id)

    def program_slice(self, slice_id: str, fn: Callable, example_inputs,
                      static_desc: str = "",
                      geometry: str = "") -> ProgramEntry:
        """Configure a vSlice with a user core (full config or PR swap).
        ``geometry`` keys tuned-kernel variants of one core apart."""
        entry, dt, hit = self.reconfig.partial_reconfigure(
            fn, example_inputs, static_desc=static_desc, geometry=geometry)
        self.db.set_slice_state(slice_id, SliceState.CONFIGURED,
                                program=entry.fingerprint)
        self._log("program", slice=slice_id, fingerprint=entry.fingerprint,
                  seconds=dt, cache_hit=hit)
        return entry

    def execute(self, slice_id: str, *args):
        """Run the slice's configured executable; records step time for the
        straggler monitor. The outputs are the caller's to keep, as the
        reference's executable returns new arrays: a graph program's replay
        rewrites its own outputs, so they are copied (``fresh``)."""
        vs = self.db.find_slice(slice_id)
        if vs.program is None:
            raise RuntimeError(f"slice {slice_id} not configured")
        entry = self._entry_for(vs.program)
        self.db.set_slice_state(slice_id, SliceState.RUNNING)
        run = getattr(entry.compiled, "fresh", entry.compiled)
        t0 = self.clock()
        out = run(*args)
        self.monitor.record_step(slice_id, (self.clock() - t0) * 1e3)
        self.db.set_slice_state(slice_id, SliceState.CONFIGURED)
        return out

    def _entry_for(self, fingerprint: str) -> ProgramEntry:
        return self.reconfig.cache.entry_for(fingerprint)

    # ---------------- BAaaS ----------------
    def register_service(self, name: str, builder: Callable[[], Any]):
        """Provider-prebuilt service (bitfile + host app in the paper)."""
        self.services[name] = builder

    def invoke_service(self, name: str, owner: str,
                       args: Optional[tuple] = None, *, slots: int = 1):
        """BAaaS: allocation + configuration happen invisibly.

        ``args`` is the explicit input tuple, or None to run the service on
        its registered example inputs. An empty tuple is respected as "call
        with no inputs" (zero-input cores) — it must NOT fall back to the
        example inputs the way a falsy check would.
        """
        if name not in self.services:
            raise KeyError(f"no service {name!r}")
        vs = self.allocate_vslice(owner, slots, service_model="baas")
        try:
            fn, example_inputs = self.services[name]()
            self.program_slice(vs.slice_id, fn, example_inputs,
                               static_desc=name)
            call_args = example_inputs if args is None else tuple(args)
            return self.execute(vs.slice_id, *call_args)
        finally:
            self.release(vs.slice_id)

    # ------------------------------------------------------------------
    # Serving gateway tenant sessions (shared-device inference traffic)
    # ------------------------------------------------------------------
    def open_serving_session(self, tenant: str, slots: int = 1,
                             service_model: str = "baas",
                             cache_pages: int = 0) -> VSlice:
        """Admit a tenant (quota check) and bind it to a vSlice. Every
        serving request is attributed to this slice in ``log`` and the
        monitor, so stragglers among serving tenants migrate exactly like
        batch workloads. ``cache_pages`` grants the slice a share of the
        device's KV page pool, clamped to the service model's
        ``max_cache_pages_per_tenant`` quota (the memory dimension of the
        vSlice)."""
        quota = self.admission.quota_for(service_model)
        if quota.max_cache_pages_per_tenant and cache_pages:
            cache_pages = min(cache_pages,
                              quota.max_cache_pages_per_tenant)
        self.admission.admit_tenant(tenant, service_model, slots)
        try:
            vs = self.allocate_vslice(tenant, slots, service_model,
                                      cache_pages=cache_pages)
        except Exception:   # NoCapacityError, bad slot count, ...
            self.admission.release_tenant(tenant, service_model, slots)
            raise
        self._log("session_open", tenant=tenant, slice=vs.slice_id,
                  device=vs.device_id, slots=slots,
                  service_model=service_model, cache_pages=cache_pages)
        return vs

    def close_serving_session(self, slice_id: str):
        vs = self.db.find_slice(slice_id)
        tenant, model, slots = vs.owner, vs.service_model, vs.slots
        self.release(slice_id)
        self.admission.release_tenant(tenant or "", model or "baas", slots)
        self._log("session_close", tenant=tenant, slice=slice_id)

    def admit_serving_request(self, slice_id: str, prompt_tokens: int,
                              new_tokens: int):
        """Per-request admission against the session's service-model quota."""
        vs = self.db.find_slice(slice_id)
        self.admission.admit_request(vs.owner or "", vs.service_model or
                                     "baas", prompt_tokens, new_tokens)

    def record_serving_step(self, slice_id: str, step_ms: float):
        """Attribute one shared decode step to a tenant's slice. Feeds the
        same straggler policy as ``execute``."""
        self.db.set_slice_state(slice_id, SliceState.RUNNING)
        self.monitor.record_step(slice_id, step_ms)

    def record_served_request(self, slice_id: str, tenant: str,
                              request_id: int, prompt_tokens: int,
                              new_tokens: int, latency_ms: float):
        """Log a completed request against its vSlice (audit trail: every
        served request is traceable to a hypervisor allocation)."""
        vs = self.db.find_slice(slice_id)
        self.admission.finish_request(tenant, vs.service_model or "baas")
        self._log("serve", tenant=tenant, slice=slice_id,
                  request=request_id, prompt_tokens=prompt_tokens,
                  new_tokens=new_tokens, latency_ms=round(latency_ms, 3))

    # ------------------------------------------------------------------
    # Failure handling / elasticity
    # ------------------------------------------------------------------
    def handle_failures(self) -> List[str]:
        """Heartbeat sweep -> mark dead nodes -> requeue orphaned batch jobs.
        Returns orphaned slice ids."""
        orphans = self.monitor.check_heartbeats()
        ids = [s.slice_id for s in orphans]
        if ids:
            self.scheduler.requeue_orphans(ids)
            self._log("failover", orphans=ids)
        return ids

    def mark_device_failed(self, device_id: str,
                           reason: str = "status_error") -> List[str]:
        """Device-granular failure: one accelerator failed its status read
        (the gcs analogue) while its node stayed up. Marks the device DEAD,
        clears its telemetry (step windows + page occupancy — a dead pool
        must not keep feeding the straggler / page-pressure policies),
        requeues orphaned batch jobs, and returns the orphaned slice ids.
        Serving sessions are re-placed by the fleet's recovery sweep, which
        watches for DEAD devices holding engines."""
        orphans = self.db.mark_device_dead(device_id)
        ids = [s.slice_id for s in orphans]
        for sid in ids:
            self.monitor.clear_slice(sid)
        self.monitor.clear_pages(device_id)
        self.monitor.clear_traffic(device_id)
        self.monitor.events.append({"t": self.clock(), "kind": "device_dead",
                                    "device": device_id, "orphans": ids})
        if ids:
            self.scheduler.requeue_orphans(ids)
        self._log("device_failed", device=device_id, reason=reason,
                  orphans=ids)
        return ids

    def migrate_slice(self, slice_id: str,
                      target_device: Optional[str] = None,
                      reason: str = "straggler") -> Optional[VSlice]:
        """Re-place ONE slice on another device, carrying its program
        fingerprint (PR makes re-programming cheap on the target).

        Directed when ``target_device`` is given (elastic scale-out wakes a
        PARKED device this way); otherwise the allocator packs it anywhere
        except its current device. Fires ``migration_listeners`` with
        (old, new) slice ids — the serving fleet's listener performs the
        live dataplane hand-off. Returns the new slice, or None when the
        move is impossible (unknown slice, no capacity, target == source).
        """
        try:
            vs = self.db.find_slice(slice_id)
        except KeyError:
            return None
        old_dev = vs.device_id
        if target_device == old_dev:
            return None
        prev_state = vs.state
        self.db.set_slice_state(slice_id, SliceState.MIGRATING)
        try:
            new = self.db.allocate_slice(vs.owner, vs.slots,
                                         vs.service_model or "raas",
                                         device_id=target_device,
                                         exclude_device=old_dev,
                                         cache_pages=vs.cache_pages)
        except NoCapacityError:
            # nowhere better to go; keep the original placement AND state
            # (a directed move may target a never-executed slice)
            self.db.set_slice_state(slice_id, prev_state)
            return None
        new.program = vs.program
        new.state = SliceState.CONFIGURED if vs.program \
            else SliceState.ALLOCATED
        self.db.release(slice_id)
        self.monitor.clear_slice(slice_id)
        # batch jobs running on the old slice follow it, like serving
        # sessions do via the listeners below — otherwise their eventual
        # complete()/fail() hits a released slice and the new one leaks
        for job in self.scheduler.jobs.values():
            if job.slice_id == slice_id and job.state == JobState.RUNNING:
                job.slice_id = new.slice_id
        self._log("migrate", old=slice_id, new=new.slice_id,
                  old_device=old_dev, new_device=new.device_id,
                  reason=reason)
        for listener in self.migration_listeners:
            listener(slice_id, new.slice_id)
        return new

    def migrate_stragglers(self) -> List[str]:
        """Re-place slices flagged by the straggler policy (paper's load
        distribution role). Returns new slice ids; ``last_migrations`` holds
        the (old, new) pairs so callers holding slice handles (e.g. the
        serving gateway) can rebind."""
        moved = []
        self.last_migrations = []
        for sid in self.monitor.find_stragglers():
            new = self.migrate_slice(sid, reason="straggler")
            if new is not None:
                moved.append(new.slice_id)
                self.last_migrations.append((sid, new.slice_id))
        return moved

    # ------------------------------------------------------------------
    def _log(self, kind: str, **kw):
        self.log.append({"t": self.clock(), "kind": kind, **kw})
