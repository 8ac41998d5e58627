"""Multi-device serving fleet: the hypervisor's placement decisions made
real at the dataplane (paper §IV load-distribution role + the outlook's
"migration of user designs between vFPGAs and physical FPGAs").

``ServingGateway`` binds every tenant to a hypervisor vSlice but decodes
everyone on ONE engine, so a migration only moved bookkeeping. The
``GatewayFleet`` closes that gap:

  * one ``BatchingEngine`` per ACTIVE physical device — the engine IS the
    device's dataplane, its KV caches are that device's memory;
  * ``open_session`` places a tenant on the engine backing its vSlice's
    device, so the DeviceDB's pack-first energy policy decides where
    decoding actually happens;
  * ``migrate_stragglers`` (or a directed ``Hypervisor.migrate_slice``)
    triggers a LIVE hand-off: the tenant's queued + in-flight requests are
    drained from the source engine and resumed on the target's, with
    already-generated tokens preserved via prompt-prefix replay; the shared
    decode program is PR-swapped from the ``ProgramCache`` (a hit,
    microseconds — the paper's partial-reconfiguration argument);
  * elastic scaling wired to ``ElasticController`` and the energy policy:
    a deep aggregate backlog wakes a PARKED device and moves the hottest
    tenant onto it; empty idle devices drain back to PARKED;
  * crash-consistent failover (paper §IV: the hypervisor monitors the
    physical devices so user designs survive device events): a recovery
    journal records every unfinished request's prompt + generated-token
    log, and ``recover_device`` re-places a dead device's sessions on
    surviving/woken engines, resuming in-flight requests by prefix replay
    — no live source engine needed, quota and pages settled exactly once.
    ``runtime/faults.py``'s seeded ``FaultInjector`` drives it all under
    test.

Ported from ``repro.runtime.fleet``. With ``autotune=True`` each device
class binds the serving geometry (slots, page size, prefill chunk) that
``repro_torch.tuning`` picks for it; the model and its kernels are the
same in every geometry.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Dict, List, Optional, Tuple

from repro_torch.analysis.lifecycle import sanitizer
from repro_torch.core.device_db import DeviceState, SliceState
from repro_torch.core.elastic import ElasticController
from repro_torch.core.hypervisor import Hypervisor
from repro_torch.models.api import Model
from repro_torch.runtime.faults import FaultInjector
from repro_torch.runtime.gateway import (TenantSession, check_program_device,
                                        serve_example,
                                        settle_finished_request,
                                        validate_submit)
from repro_torch.runtime.paged import default_pool_pages
from repro_torch.runtime.serve import (BatchingEngine, Request, _req_event,
                                      make_paged_serve_step, make_serve_step)
from repro_torch.tuning import TunedConfig, device_class, resolve_tuned


def _mark_cancelled(req: Request) -> None:
    """Stamp a request cancelled outside any engine (caught in transit
    between engines, or torn down with an evicted session)."""
    _req_event(req, "cancel")
    req.finish_reason = "cancelled"
    req.finished_at = time.monotonic()
    req.done.set()


@dataclasses.dataclass
class _ProgramBundle:
    """One serving geometry's configure-ready program: its serve-step fn,
    the example (meta tensors) the reconfigurator keys on, and the pool
    dimensions the engines built for this geometry must use (``pages``: 0
    on a dense fleet). ``tuned is None`` is the fleet's default
    (constructor args); autotuned fleets hold one bundle per device class.
    ``fingerprint`` is stamped at first configure (``_ensure_engine``) so
    failover can re-mark slices with the program they actually run."""
    tuned: Optional[TunedConfig]
    decode_fn: object
    example: tuple
    desc: str
    geometry: str
    n_slots: int
    page_size: int
    pages: int
    fingerprint: Optional[str] = None


@dataclasses.dataclass
class JournalEntry:
    """One unfinished request's durable record in the fleet's recovery
    journal: everything failover needs to resume it on another engine
    WITHOUT a live source — the prompt lives on the request, the
    generated-token log is this entry's own copy (synced after every
    fleet step), and quota state is implied by the entry's existence
    (journaled == admitted and not yet settled)."""
    req: Request
    tenant: str
    tokens: List[int] = dataclasses.field(default_factory=list)


class GatewayFleet:
    """Routes serving traffic for one model across every active device.

    One engine per physical device; tenants land on the engine backing
    their vSlice and FOLLOW their vSlice when the hypervisor re-places it.
    """

    def __init__(self, hv: Hypervisor, model: Model, params,
                 n_slots: int = 4, max_len: int = 256,
                 eos_id: Optional[int] = None, migrate_every: int = 0,
                 autoscale_every: int = 0, scale_up_queue_depth: int = 8,
                 paged: bool = False, page_size: int = 16,
                 cache_pages: Optional[int] = None,
                 page_pressure: float = 0.85,
                 slo_p95_steps: Optional[float] = None,
                 slo_horizon: int = 16,
                 scale_in_margin: float = 0.5,
                 faults: Optional[FaultInjector] = None,
                 autotune: bool = False):
        # fail fast, before any session can allocate: lazy engine creation
        # must never be the first place this surfaces (it would strand an
        # admitted tenant and its vSlice)
        if model.cfg.ssm is not None:
            raise ValueError("GatewayFleet serves attention-family models; "
                             "use jit_serve_step for SSM archs")
        if paged and model.cfg.mla is not None:
            raise ValueError("paged KV caches support plain-attention "
                             "models (MLA latents are not paged)")
        check_program_device(hv, model)
        self.hv = hv
        self.model = model
        self.params = params
        self.n_slots = n_slots
        self.max_len = max_len
        self.eos_id = eos_id
        self.paged = paged
        self.page_size = page_size
        self.cache_pages = cache_pages
        self.page_pressure = page_pressure       # occupancy scale-out trigger
        self.migrate_every = migrate_every       # steps between sweeps
        self.autoscale_every = autoscale_every   # steps between autoscale
        self.scale_up_queue_depth = scale_up_queue_depth
        # SLO-driven elasticity (opt-in): when a p95 target (in fleet
        # steps) is set, autoscale additionally wakes devices on a
        # PROJECTED p95 breach from the monitor's arrival/service-rate
        # trend, and consolidates (parks highest-draw devices first) when
        # the projection sits under scale_in_margin * slo with no backlog.
        self.slo_p95_steps = slo_p95_steps
        self.slo_horizon = slo_horizon
        self.scale_in_margin = scale_in_margin
        self.autoscale_log: List[dict] = []
        # open-loop traffic counters, drained into the monitor every step
        self._arrivals_since_step = 0
        self._completions_since_step = 0
        self._dev_completions: Dict[str, int] = {}   # per-device, same window
        # energy integral: sum over steps of the un-parked fleet's class
        # draw (device-steps x draw; PARKED/DEAD devices are free)
        self.energy = 0.0
        self.elastic = ElasticController(hv)
        # deterministic chaos: when an injector is attached, every step()
        # ticks it (clock + heartbeats + scheduled faults) and runs the
        # heartbeat/failover sweep. Without one, the sweep stays off so a
        # slow wall-clock test run can never spuriously declare nodes dead.
        self.faults = faults
        # recovery journal: request_id -> JournalEntry for every admitted,
        # not-yet-settled request. THE source of truth for failover — a
        # dead device's engine (queues, slots, KV pages) is gone, but the
        # journal re-creates its traffic by prefix replay elsewhere.
        self.journal: Dict[int, JournalEntry] = {}
        # Event-driven journal mode (set by runtime.events.EventLoop):
        # instead of copying every inflight request's token log after
        # every engine step, step_engine only MARKS entries dirty and the
        # event loop batches the copies off the critical path
        # (flush_journal on its own cadence). The hard flush barrier:
        # _retire_entry (quota settle) and the hand-off export path flush
        # per-request first — machine-enforced, since the journal machine
        # rejects retire from DIRTY.
        self.journal_lazy = False
        self._dirty: Dict[int, bool] = {}        # insertion-ordered rids
        # Overlapped hand-off (event mode): the EventLoop installs a hook
        # that exports pages WITHOUT draining and schedules the completion
        # a few ticks later, letting the source keep decoding during the
        # copy. Sources mid-copy (and scale-in drain targets) sit in
        # _draining so autoscale's backlog sample skips them.
        self._handoff_hook = None
        self._event_driven = False               # EventQueue owns the clock
        self._draining: set = set()
        self._inflight_handoffs: Dict[str, int] = {}
        self._san = sanitizer.scope()    # journal-machine key namespace
        self.recoveries: List[dict] = []
        # one id stream for the whole fleet: request ids must stay unique
        # across engines (audit log + hand-off both key on them)
        self._req_ids = itertools.count()
        self._engines: Dict[str, BatchingEngine] = {}    # device_id -> engine
        self._sessions: Dict[str, TenantSession] = {}
        self._device_of: Dict[str, str] = {}             # tenant -> device_id
        self.migrations: List[Tuple[str, str]] = []
        self.handoffs: List[dict] = []
        self.steps = 0
        self.last_round_ms: Dict[str, float] = {}        # per-device step wall

        # Per-device-class auto-tuning (opt-in): when set, each engine
        # binds the geometry the design-space tuner picked for ITS
        # device's class — slot count, KV page size, prefill chunk —
        # resolved through the ProgramCache's tuned-config store. Off by
        # default so every engine shares ONE program (one fingerprint,
        # PR cache hits fleet-wide — the paper's shared-bitstream case).
        self.autotune = autotune
        self._bundles: Dict[str, _ProgramBundle] = {}   # device class -> b

        # Configure the decode step ONCE through the hypervisor's
        # reconfigurator (full configuration); every engine spun up after
        # that binds the same program — a PR cache hit per device.
        # (Autotuned fleets still configure this default bundle: it is the
        # failover fallback and the geometry control arm.)
        if paged and max_len % page_size:
            raise ValueError(f"max_len {max_len} must be a multiple of "
                             f"page_size {page_size}")
        bundle = self._default_bundle = self._make_bundle(None)
        entry, dt, hit = hv.reconfig.partial_reconfigure(
            bundle.decode_fn, bundle.example, static_desc=bundle.desc)
        self.program_fingerprint = bundle.fingerprint = entry.fingerprint
        hv._log("fleet_up", model=model.cfg.name, n_slots=n_slots,
                fingerprint=entry.fingerprint, compile_s=dt, cache_hit=hit,
                paged=paged, autotune=autotune)
        # register LAST: a constructor failure above must not leave a
        # dead fleet's listener on the shared hypervisor
        hv.migration_listeners.append(self._on_migration)

    # ------------------------------------------------------------------
    # Program bundles (one geometry = one configured program)
    # ------------------------------------------------------------------
    def _make_bundle(self, tuned: Optional[TunedConfig]) -> _ProgramBundle:
        """Build the configure-ready program for one geometry. ``None`` is
        the fleet default (constructor args); a ``TunedConfig`` sizes the
        serve-step example with the tuned slot count / page size, so each
        geometry configures (and caches) as its own program. The model is
        the same in every geometry: the port's kernels take no block
        sizes."""
        if tuned is None:
            n_slots, page_size, geometry = self.n_slots, self.page_size, ""
        else:
            n_slots, page_size = tuned.n_slots, tuned.page_size
            geometry = tuned.geometry_key()
        pages = 0
        if self.paged:
            pages = self.cache_pages if self.cache_pages is not None \
                else default_pool_pages(n_slots, self.max_len // page_size)
        decode_fn = make_paged_serve_step(self.model) if self.paged \
            else make_serve_step(self.model)
        example = serve_example(self.model, self.params, n_slots,
                                self.max_len, self.paged, page_size, pages)
        desc = f"serve:{self.model.cfg.name}:slots{n_slots}" \
            f":len{self.max_len}" \
            + (f":paged{page_size}" if self.paged else "") \
            + (f":geom{geometry}" if geometry else "")
        return _ProgramBundle(tuned, decode_fn, example, desc, geometry,
                              n_slots, page_size, pages)

    def _bundle_for(self, device_id: str) -> _ProgramBundle:
        """The program bundle a device binds: the tuned geometry of its
        device class when autotuning, the shared default otherwise. Tuned
        configs persist in the ProgramCache keyed (model fp, class), so a
        class's sweep runs once per cache lifetime — every later bind
        (including cross-class hand-off destinations) is a lookup."""
        if not self.autotune:
            return self._default_bundle
        speed = self.hv.db.devices[device_id].speed
        cls = device_class(speed)
        bundle = self._bundles.get(cls)
        if bundle is None:
            tuned = resolve_tuned(self.hv.reconfig.cache, self.model.cfg,
                                  speed, max_len=self.max_len,
                                  paged=self.paged)
            bundle = self._make_bundle(tuned)
            self._bundles[cls] = bundle
            self.hv._log("autotune_bind", device_class=cls,
                         geometry=bundle.geometry, n_slots=bundle.n_slots,
                         page_size=bundle.page_size)
        return bundle

    def prefill_chunk_for(self, device_id: str,
                          default: Optional[int]) -> Optional[int]:
        """Tuned prefill chunk length for a device's class (the event
        loop's chunked-prefill cadence); the caller's default when
        autotuning is off or the caller runs lockstep (``None``)."""
        if default is None or not self.autotune:
            return default
        bundle = self._bundle_for(device_id)
        return bundle.tuned.prefill_chunk if bundle.tuned is not None \
            else default

    # ------------------------------------------------------------------
    # Engine lifecycle (one per active device)
    # ------------------------------------------------------------------
    def _ensure_engine(self, device_id: str) -> BatchingEngine:
        eng = self._engines.get(device_id)
        if eng is not None:
            return eng
        bundle = self._bundle_for(device_id)
        eng = BatchingEngine(self.model, self.params,
                             n_slots=bundle.n_slots,
                             max_len=self.max_len, eos_id=self.eos_id,
                             id_counter=self._req_ids, paged=self.paged,
                             page_size=bundle.page_size,
                             cache_pages=self.cache_pages)
        entry, dt, hit = self.hv.reconfig.partial_reconfigure(
            bundle.decode_fn, bundle.example, static_desc=bundle.desc,
            geometry=bundle.geometry)
        bundle.fingerprint = entry.fingerprint
        eng.use_program(entry.compiled)
        eng.on_step = lambda active, ms, dev=device_id: \
            self._on_step(dev, active, ms)
        eng.on_finish = self._on_finish
        self._engines[device_id] = eng
        self.hv._log("engine_up", device=device_id,
                     fingerprint=entry.fingerprint, swap_s=dt, cache_hit=hit,
                     geometry=bundle.geometry or "default")
        return eng

    def park_idle_engines(self) -> List[str]:
        """Drop engines whose device hosts no slices and whose queues/slots
        are empty — the device itself is already PARKED (energy policy);
        this releases its dataplane (KV caches) too."""
        parked = []
        for dev, eng in list(self._engines.items()):
            if eng.idle() and not self.hv.db.device(dev).slices:
                del self._engines[dev]
                self.hv.monitor.clear_pages(dev)
                self.hv.monitor.clear_traffic(dev)
                parked.append(dev)
                self.hv._log("engine_park", device=dev)
        return parked

    def engine_for(self, tenant: str) -> BatchingEngine:
        return self._engines[self._device_of[tenant]]

    def device_of(self, tenant: str) -> str:
        return self._device_of[tenant]

    # ------------------------------------------------------------------
    # Tenant sessions
    # ------------------------------------------------------------------
    def _session_page_grant(self, slots: int) -> int:
        """A k-slot session's share of one engine's page pool (the vSlice
        memory dimension)."""
        if not self.paged:
            return 0
        return max(1, (self._default_bundle.pages - 1) * slots
                   // self.n_slots)

    def open_session(self, tenant: str, slots: int = 1,
                     service_model: str = "baas") -> TenantSession:
        if tenant in self._sessions:
            raise ValueError(f"tenant {tenant!r} already has a session")
        vs = self.hv.open_serving_session(
            tenant, slots, service_model,
            cache_pages=self._session_page_grant(slots))
        try:
            engine = self._ensure_engine(vs.device_id)
            # PR-swap the decode program onto this tenant's slice — the
            # bundle of the device's class, so an autotuned fleet binds
            # tuned geometry with zero operator input
            bundle = self._bundle_for(vs.device_id)
            self.hv.program_slice(vs.slice_id, bundle.decode_fn,
                                  bundle.example, static_desc=bundle.desc,
                                  geometry=bundle.geometry)
            engine.set_tenant_share(tenant, slots)
            engine.set_tenant_weight(tenant, slots)
            if self.paged:
                engine.set_tenant_pages(tenant, vs.cache_pages or None)
        except Exception:
            # undo the allocation + quota: a failed open must not strand
            # the tenant admitted against a slice it can never use
            self.hv.close_serving_session(vs.slice_id)
            raise
        sess = TenantSession(tenant, vs.slice_id, slots, service_model)
        self._sessions[tenant] = sess
        self._device_of[tenant] = vs.device_id
        return sess

    def close_session(self, tenant: str):
        sess = self._sessions.pop(tenant)
        dev = self._device_of.pop(tenant)
        engine = self._engines.get(dev)
        if engine is not None:
            for r in engine.cancel_queued(tenant):
                self._retire_entry(r.request_id)
            engine.set_tenant_share(tenant, None)
            engine.set_tenant_weight(tenant, None)
            engine.set_tenant_pages(tenant, None)
        self._settle_outstanding(sess)
        self.hv.close_serving_session(sess.slice_id)

    def _settle_outstanding(self, sess: TenantSession):
        """Return a closing session's unfinished in-flight quota (requests
        still decoding finish as orphans and are not re-settled — see
        ``settle_finished_request``'s session-identity guard)."""
        for _ in range(max(0, sess.submitted - sess.served)):
            self.hv.admission.finish_request(sess.tenant, sess.service_model)

    def close(self):
        for tenant in list(self._sessions):
            self.close_session(tenant)
        self.park_idle_engines()
        try:
            self.hv.migration_listeners.remove(self._on_migration)
        except ValueError:
            pass    # already deregistered (close called twice)

    def session(self, tenant: str) -> TenantSession:
        return self._sessions[tenant]

    # ------------------------------------------------------------------
    # Request path
    # ------------------------------------------------------------------
    def submit(self, tenant: str, prompt, max_new_tokens: int = 16) -> Request:
        try:
            sess = self._sessions[tenant]
        except KeyError:
            raise KeyError(f"tenant {tenant!r} has no serving session "
                           "(call open_session first)") from None
        validate_submit(prompt, max_new_tokens, self.max_len)
        self.hv.admit_serving_request(sess.slice_id, len(prompt),
                                      max_new_tokens)
        sess.submitted += 1
        try:
            req = self.engine_for(tenant).submit(prompt, max_new_tokens,
                                                 tenant=tenant)
        except Exception:
            # an engine rejection (oversized request, paged worst-case
            # check) must hand back the quota charged two lines up, or the
            # tenant's in-flight count leaks one slot per failed submit
            sess.submitted -= 1
            self.hv.admission.finish_request(tenant, sess.service_model)
            raise
        req._session = sess
        sanitizer.emit("journal", (self._san, req.request_id), "append")
        self.journal[req.request_id] = JournalEntry(req, tenant)
        self._arrivals_since_step += 1
        return req

    # ------------------------------------------------------------------
    # Recovery journal (lazy sync + the flush barrier)
    # ------------------------------------------------------------------
    def _retire_entry(self, request_id: int, crashed: bool = False) -> bool:
        """Pop a journal entry THROUGH the flush barrier: a DIRTY entry is
        flushed first (live paths — the copy itself is moot since the
        entry is discarded, but the transition is what the journal machine
        checks) or rolled back (crash paths abandon unflushed tokens).
        Retiring from DIRTY directly is illegal under RC3E_SANITIZE=1."""
        entry = self.journal.pop(request_id, None)
        if entry is None:
            return False
        if self._dirty.pop(request_id, None):
            sanitizer.emit("journal", (self._san, request_id),
                           "rollback" if crashed else "flush")
        sanitizer.emit("journal", (self._san, request_id), "retire")
        return True

    def flush_journal(self, request_id: Optional[int] = None) -> int:
        """Copy generated-token logs into their journal entries
        (DIRTY -> OPEN). The event loop calls the batched form on its own
        cadence — journal durability off the per-token critical path; the
        per-request form is the flush barrier in front of quota settles
        and hand-off exports. Returns the number of entries flushed."""
        rids = [request_id] if request_id is not None else list(self._dirty)
        flushed = 0
        for rid in rids:
            if self._dirty.pop(rid, None) is None:
                continue
            entry = self.journal.get(rid)
            if entry is None:
                continue
            entry.tokens = list(entry.req.out_tokens)
            sanitizer.emit("journal", (self._san, rid), "flush")
            flushed += 1
        return flushed

    def _sync_journal(self, eng: BatchingEngine) -> None:
        """Post-step journal sync for one engine: eager mode copies every
        inflight token log now (lockstep PR 5 behavior); lazy mode only
        marks entries dirty for a later batched flush."""
        for r in eng.inflight():
            entry = self.journal.get(r.request_id)
            if entry is None:
                continue
            if self.journal_lazy:
                if r.request_id not in self._dirty:
                    self._dirty[r.request_id] = True
                    sanitizer.emit("journal",
                                   (self._san, r.request_id), "dirty")
            else:
                entry.tokens = list(r.out_tokens)

    def cancel(self, req: Request) -> bool:
        """Cancel one request on whichever engine holds it (queued or in
        flight; an in-flight cancel frees the slot and its pool pages).

        A request can also be caught BETWEEN engines: drained for a live
        hand-off (after its pages were exported, before ``resume``) or
        orphaned by a dead device awaiting recovery. No engine holds a
        slot or pages for it then — its pages were already freed by the
        drain / died with the device — so only the bookkeeping settles
        here, exactly once; the done-flag guard in ``resume`` keeps the
        in-flight hand-off from re-queuing it afterwards."""
        # recover first: cancelling on an engine whose device was marked
        # dead between steps would settle against a slice that died with
        # the device (and leak the in-flight quota on the KeyError)
        self._recover_dead_engines()
        for eng in self._engines.values():
            if eng.cancel(req):
                return True
        if req.request_id in self.journal and not req.done.is_set():
            _mark_cancelled(req)
            self._on_finish(req)
            return True
        return False

    def begin_round(self) -> None:
        """Control-plane half of a round boundary: tick the fault injector
        (scheduled kills + heartbeats; the clock too, unless the event
        queue owns it), run the heartbeat/failover sweep, and recover any
        engine stranded on a dead device."""
        if self.faults is not None:
            self.faults.tick(self.hv,
                             advance_clock=not self._event_driven)
            self.hv.handle_failures()
        self._recover_dead_engines()

    def step_engine(self, dev: str,
                    prefill_chunk: Optional[int] = None) -> int:
        """One guarded step of ONE engine — the unit the event loop
        schedules per-device (each engine advances on its own cadence).
        ``prefill_chunk`` selects the async engine path (chunked prefill
        interleaved with decode); None keeps the lockstep ``step()``.
        Skips engines that vanished (parked by a hand-off mid-round) or
        froze (crashed mid-detection-window). Returns slots decoded."""
        eng = self._engines.get(dev)
        if eng is None or not self._device_alive(dev):
            return 0
        t0 = time.monotonic()
        n = eng.step() if prefill_chunk is None \
            else eng.step_async(prefill_chunk)
        if n:
            self.last_round_ms[dev] = (time.monotonic() - t0) * 1e3
        self._sync_journal(eng)
        if eng.paged:
            self.hv.monitor.record_pages(dev, eng.pool.used_pages,
                                         eng.pool.total_pages)
            self.hv.monitor.record_scrub(dev, eng.pool.pages_scrubbed,
                                         eng.scrub_ms)
        return n

    def finish_round(self) -> None:
        """Round settlement: one traffic sample (fleet-wide and per-device
        completions) feeds the SLO-projection autoscaler, the energy
        integral charges every un-parked device its class draw, and the
        straggler / autoscale cadences run."""
        self.steps += 1
        self.hv.monitor.record_traffic(self._arrivals_since_step,
                                       self._completions_since_step,
                                       len(self._engines),
                                       by_device=self._dev_completions)
        self._arrivals_since_step = 0
        self._completions_since_step = 0
        self._dev_completions = {}
        self.energy += self.hv.db.active_draw()
        if self.migrate_every and self.steps % self.migrate_every == 0:
            self.rebalance()
        if self.autoscale_every and self.steps % self.autoscale_every == 0:
            self.autoscale()

    def step(self) -> int:
        """One LOCKSTEP round: a decode step on every active engine
        (devices run concurrently in hardware; ``last_round_ms`` records
        each device's wall time so callers can account device-parallel
        time), bracketed by ``begin_round``/``finish_round``. The
        event-driven loop (``runtime.events.EventLoop``) composes the same
        three pieces but schedules ``step_engine`` per device on its own
        event-time cadence — no fleet-wide barrier."""
        self.begin_round()
        total = 0
        self.last_round_ms = {}
        for dev in list(self._engines):
            total += self.step_engine(dev)
        self.finish_round()
        return total

    def run_until_idle(self, max_steps: int = 10000) -> bool:
        """Returns True when every engine drained; False on a stall
        (max_steps expired, or queued work that can make no progress).
        With a fault injector attached, a zero-progress round is NOT a
        stall: a killed-but-undetected node freezes its engine for the
        length of the heartbeat deadline, and recovery resumes the work
        a few steps later."""
        for _ in range(max_steps):
            n = self.step()
            if all(e.idle() for e in self._engines.values()):
                return True
            if n == 0 and self.faults is None:
                return False
        return all(e.idle() for e in self._engines.values())

    # ------------------------------------------------------------------
    # Telemetry -> control plane (same attribution as the single gateway,
    # but totals are per engine: each device's step is its own event)
    # ------------------------------------------------------------------
    def _on_step(self, device_id: str, active_by_tenant: Dict[str, int],
                 step_ms: float):
        total = sum(active_by_tenant.values()) or 1
        for tenant, n in active_by_tenant.items():
            sess = self._sessions.get(tenant)
            if sess is None:
                continue
            self.hv.record_serving_step(
                sess.slice_id, step_ms * n / (total * sess.slots))

    def _on_finish(self, req: Request):
        # retire the journal entry FIRST (through the flush barrier): a
        # settled request must never be replayed by a later recovery
        # (exactly-once accounting), and quota must never settle while
        # the entry is dirty
        self._retire_entry(req.request_id)
        if req.finish_reason != "cancelled":
            self._completions_since_step += 1
            dev = self._device_of.get(req.tenant)
            if dev is not None:
                self._dev_completions[dev] = \
                    self._dev_completions.get(dev, 0) + 1
        settle_finished_request(self.hv, self._sessions, req)

    # ------------------------------------------------------------------
    # Live migration hand-off
    # ------------------------------------------------------------------
    def _on_migration(self, old: str, new: str):
        """Hypervisor re-placed a slice: rebind the session AND move its
        traffic. Queued + in-flight requests are drained from the source
        engine and carried to the target. On a paged fleet an in-flight
        request's pool pages are COPIED device-to-device (exported before
        the drain frees them), so decode continues without recompute;
        prompt-prefix replay remains the fallback whenever the target
        cannot take the pages (slot/page exhaustion, dense engines)."""
        sess = next((s for s in self._sessions.values()
                     if s.slice_id == old), None)
        if sess is None:
            return
        sess.slice_id = new
        self.migrations.append((old, new))
        new_dev = self.hv.db.find_slice(new).device_id
        old_dev = self._device_of.get(sess.tenant)
        if new_dev == old_dev:
            return
        self._device_of[sess.tenant] = new_dev
        target = self._ensure_engine(new_dev)
        source = self._engines.get(old_dev)
        if (self._handoff_hook is not None and source is not None
                and source.paged and target.paged):
            # event-driven fleet: overlap the page copy with continued
            # decode on the source. New traffic routes to the target now
            # (shares set below); the hook exports snapshots, marks the
            # source draining, and schedules the drain + adoption a few
            # ticks out (export-generation check / replay fallback there).
            target.set_tenant_share(sess.tenant, sess.slots)
            target.set_tenant_weight(sess.tenant, sess.slots)
            if target.paged:
                vs = self.hv.db.find_slice(new)
                target.set_tenant_pages(sess.tenant, vs.cache_pages or None)
            self._handoff_hook(sess, old_dev, new_dev)
            return
        moved: List[Request] = []
        payloads: Dict[int, object] = {}
        if source is not None:
            # export pages BEFORE draining: released pages may be recycled
            # by the source's next admission
            if source.paged and target.paged:
                for r in source.inflight(sess.tenant):
                    # flush barrier: the journal must cover everything the
                    # snapshot covers before the entry leaves this engine
                    self.flush_journal(r.request_id)
                    if self.faults is not None \
                            and self.faults.fail_page_copy():
                        continue         # copy lost: replay fallback
                    p = source.export_request_pages(r)
                    if p is not None:
                        payloads[id(r)] = p
            moved = source.drain_tenant(sess.tenant)
            source.set_tenant_share(sess.tenant, None)
            source.set_tenant_weight(sess.tenant, None)
            source.set_tenant_pages(sess.tenant, None)
        target.set_tenant_share(sess.tenant, sess.slots)
        target.set_tenant_weight(sess.tenant, sess.slots)
        if target.paged:
            vs = self.hv.db.find_slice(new)
            target.set_tenant_pages(sess.tenant, vs.cache_pages or None)
        page_copied = replayed = 0
        for r in moved:
            if r.done.is_set():
                continue    # cancelled mid-hand-off: already settled
            payload = payloads.get(id(r))
            if payload is not None and target.import_request_pages(r, payload):
                page_copied += 1
            else:
                target.resume(r)
                if id(r) in payloads:
                    replayed += 1
        event = {"tenant": sess.tenant, "old": old, "new": new,
                 "old_device": old_dev, "new_device": new_dev,
                 "moved_requests": len(moved), "page_copied": page_copied,
                 "replayed_inflight": replayed}
        if self.autotune:
            # cross-class hand-off: geometry was re-resolved for the
            # DESTINATION class when its engine came up; record both ends
            event["dst_geometry"] = self._bundle_for(new_dev).geometry
            event["src_geometry"] = ("" if old_dev is None
                                     else self._bundle_for(old_dev).geometry)
        self.handoffs.append(event)
        self.hv._log("handoff", **event)

    def rebalance(self) -> List[Tuple[str, str]]:
        """Straggler sweep; hand-offs happen in the migration listener."""
        self.hv.migrate_stragglers()
        return self.hv.last_migrations

    # ------------------------------------------------------------------
    # Crash-consistent failover (no live source engine)
    # ------------------------------------------------------------------
    def _device_alive(self, device_id: str) -> bool:
        dev = self.hv.db.devices[device_id]
        if dev.state == DeviceState.DEAD \
                or not self.hv.db.nodes[dev.node_id].alive:
            return False
        # a killed-but-undetected device must freeze NOW, not when the
        # heartbeat deadline expires
        return self.faults is None \
            or not self.faults.is_dead(dev.node_id, device_id)

    def _recover_dead_engines(self) -> List[str]:
        """Failover sweep: any engine whose device the control plane has
        declared dead gets its sessions re-placed and its requests resumed
        from the journal. (Engines on killed-but-undetected nodes keep
        their state and simply skip stepping until the monitor notices.)"""
        recovered = []
        for dev in list(self._engines):
            d = self.hv.db.devices[dev]
            if d.state == DeviceState.DEAD \
                    or not self.hv.db.nodes[d.node_id].alive:
                self.recover_device(dev)
                recovered.append(dev)
        return recovered

    def recover_device(self, device_id: str) -> dict:
        """Re-place every session stranded on a dead device and resume its
        unfinished requests by prefix replay from the recovery journal.

        Contrast ``_on_migration``: a live hand-off drains a RUNNING
        source engine (and can copy pages). Here the source is gone —
        engine, queues, slots and KV pages died with the device — so the
        journal is the only truth: each orphaned request's generated-token
        log is restored onto the request and replayed as a prompt prefix
        on a surviving (or woken) engine. Page accounting needs no
        settling (the dead pool took its refcounts with it and the
        monitor's occupancy entry is cleared); admission quota stays held
        by each request until it finishes on its new engine — settled
        exactly once, by the normal ``_on_finish`` path.

        A tenant that fits NOWHERE (even degraded to 1 slot, even after
        waking every PARKED device) is evicted: its unfinished requests
        are cancelled and its quota settled, exactly once.
        """
        self._engines.pop(device_id, None)      # dataplane died with device
        self.hv.monitor.clear_pages(device_id)
        self.hv.monitor.clear_traffic(device_id)
        tenants = [t for t, d in self._device_of.items() if d == device_id]
        event = {"device": device_id, "tenants": tenants, "resumed": 0,
                 "evicted": []}
        for tenant in tenants:
            sess = self._sessions[tenant]
            # every unfinished request of this tenant was stranded by the
            # crash — queued or mid-decode, it is now an orphan awaiting
            # either replay (below) or eviction. Dirty entries roll back:
            # unflushed tokens died with the device, and replay from the
            # last durable flush regenerates them bit-exact (greedy)
            for entry in self.journal.values():
                if entry.tenant == tenant and not entry.req.done.is_set() \
                        and not self._held_elsewhere(entry.req):
                    rid = entry.req.request_id
                    if self._dirty.pop(rid, None):
                        sanitizer.emit("journal", (self._san, rid),
                                       "rollback")
                    _req_event(entry.req, "orphan")
            # the grant formula rides along so each degrade step asks for
            # the page grant matching ITS slot count, not the original's
            vs = self.elastic.place_failover(
                tenant, sess.slots, sess.service_model,
                cache_pages_of=self._session_page_grant)
            if vs is None:
                self._evict_session(tenant, sess)
                event["evicted"].append(tenant)
                continue
            if vs.slots < sess.slots:
                # elastic degrade: hand back the slot quota difference so
                # admission matches what the tenant actually holds now
                self.hv.admission.release_tenant(
                    tenant, sess.service_model, sess.slots - vs.slots)
                sess.slots = vs.slots
            sess.slice_id = vs.slice_id
            self._device_of[tenant] = vs.device_id
            target = self._ensure_engine(vs.device_id)
            # the surviving device may be a different class: mark the
            # slice with the program fingerprint its class actually runs
            # (stamped by _ensure_engine's configure just above)
            self.hv.db.set_slice_state(
                vs.slice_id, SliceState.CONFIGURED,
                program=self._bundle_for(vs.device_id).fingerprint
                or self.program_fingerprint)
            target.set_tenant_share(tenant, vs.slots)
            target.set_tenant_weight(tenant, vs.slots)
            if self.paged:
                target.set_tenant_pages(tenant, vs.cache_pages or None)
            # journal replay in submission order (dict preserves it): the
            # tenant's FIFO survives the crash
            for entry in list(self.journal.values()):
                if entry.tenant != tenant or entry.req.done.is_set() \
                        or self._held_elsewhere(entry.req):
                    # a surviving engine still owns it: the overlapped
                    # hand-off source keeps decoding while its copy is in
                    # flight — replaying here would double-decode
                    continue
                # crash consistency: roll the request back to its durably
                # journaled token log (tokens past it regenerate bit-exact
                # under greedy decoding — the chaos suite proves it)
                entry.req.out_tokens = list(entry.tokens)
                sanitizer.emit("journal",
                               (self._san, entry.req.request_id), "replay")
                target.resume(entry.req)
                event["resumed"] += 1
        self.recoveries.append(event)
        self.hv._log("device_recovered", **event)
        return event

    def _held_elsewhere(self, req: Request) -> bool:
        """Does any surviving engine physically own this request (slot or
        queue)? Recovery skips such requests — they are mid-overlapped-
        hand-off on a live source and the completion event will move
        them."""
        return any(eng.holds(req) for eng in self._engines.values())

    def _evict_session(self, tenant: str, sess: TenantSession):
        """Tear down a session whose vSlice died with its device and that
        no surviving capacity can host: cancel its unfinished requests and
        settle every outstanding quota exactly once. (There is no slice to
        release — ``mark_node_dead``/``mark_device_dead`` already dropped
        it — but the admission controller's slot + in-flight counts are
        fleet-side state and must not leak.)"""
        cancelled = 0
        for rid, entry in list(self.journal.items()):
            if entry.tenant != tenant or entry.req.done.is_set():
                continue
            self._retire_entry(rid, crashed=True)
            _mark_cancelled(entry.req)
            cancelled += 1
        self._settle_outstanding(sess)
        self.hv.admission.release_tenant(tenant, sess.service_model,
                                         sess.slots)
        self._sessions.pop(tenant, None)
        self._device_of.pop(tenant, None)
        self.hv._log("failover_evict", tenant=tenant, cancelled=cancelled)

    def verify_invariants(self) -> None:
        """Machine-checked fleet-wide conservation — the chaos harness
        calls this after every step:

          * every paged engine's pool passes ``PagePoolManager.verify()``
            (free + referenced == total, no refcount leaks);
          * per-tenant admission in-flight count equals that tenant's
            unfinished journaled requests (quota conservation: nothing
            settled twice, nothing leaked across kills/hand-offs);
          * sessions map onto live devices with live engines.
        """
        for dev, eng in self._engines.items():
            if eng.paged:
                eng.pool.verify()
        unfinished: Dict[str, int] = {}
        for entry in self.journal.values():
            if not entry.req.done.is_set():
                unfinished[entry.tenant] = unfinished.get(entry.tenant, 0) + 1
        for tenant, sess in self._sessions.items():
            inflight = self.hv.admission.usage(
                tenant, sess.service_model)["inflight"]
            assert inflight == unfinished.get(tenant, 0), \
                f"quota drift for {tenant!r}: admission holds {inflight} " \
                f"in flight, journal has {unfinished.get(tenant, 0)} " \
                "unfinished"
            dev = self._device_of[tenant]
            assert self.hv.db.devices[dev].state != DeviceState.DEAD, \
                f"session {tenant!r} bound to dead device {dev}"
            assert dev in self._engines, \
                f"session {tenant!r} on {dev} has no engine"

    # ------------------------------------------------------------------
    # Elastic scaling (queue depth <-> energy policy)
    # ------------------------------------------------------------------
    def queued_by_device(self) -> Dict[str, int]:
        return {dev: sum(e.queued_by_tenant().values())
                for dev, e in self._engines.items()}

    def autoscale(self) -> Optional[str]:
        """Single-action autoscale arbitration: evaluate every scaling
        signal, act on AT MOST ONE per invocation, in priority order —

          1. queue depth  (aggregate backlog outgrew the active fleet),
          2. SLO projection (projected p95 breach from the arrival-rate /
             service-rate trend; only when ``slo_p95_steps`` is set),
          3. page pressure (a device's KV pool runs hot; paged fleets),

        each waking one PARKED device and moving the deepest-queued (or
        page-hungriest) tenant onto it via a live hand-off. A burst wave
        routinely trips queue depth AND page pressure on the same tick;
        acting on both would wake two devices for one overload and
        oscillate against the energy policy, so later signals are only
        consulted when every earlier one declined to act. When NO
        scale-out fired, the backlog is empty and the projection sits
        under ``scale_in_margin`` of the SLO, the diurnal down-ramp half
        runs instead: drain the highest-draw drainable device
        (``pick_scale_in_device``) so the power-hungry classes park first.
        Always parks empty idle engines on the way out. Returns the woken
        device id, if any."""
        queued = self.queued_by_device()
        # requests on a draining device (a scale-in target mid-drain, or
        # an overlapped hand-off source mid-copy) are already on their way
        # elsewhere; counting them as backlog double-counts the demand and
        # wakes a device for traffic that is about to move — the wake/park
        # flap across a diurnal trough
        backlog = sum(n for dev, n in queued.items()
                      if dev not in self._draining)
        n_active = max(1, len(self._engines))
        woken: Optional[str] = None
        signal: Optional[str] = None
        if backlog >= self.scale_up_queue_depth * n_active:
            tenant = self._deepest_queued_tenant()
            if tenant is not None:
                new = self.elastic.scale_out(self._sessions[tenant].slice_id)
                if new is not None:
                    woken, signal = new.device_id, "queue_depth"
        if woken is None and self.slo_p95_steps is not None:
            tenant = self._deepest_queued_tenant()
            if tenant is not None:
                new = self.elastic.scale_out_on_slo(
                    self._sessions[tenant].slice_id, self.slo_p95_steps,
                    backlog, self.slo_horizon)
                if new is not None:
                    woken, signal = new.device_id, "slo_projection"
        if woken is None and self.paged:
            # memory pressure is a scale-out signal of its own: a device
            # can stall on pages with a near-empty queue (long contexts)
            new = self.elastic.scale_out_on_page_pressure(
                self._page_hungriest_slices(), self.page_pressure)
            if new is not None:
                woken, signal = new.device_id, "page_pressure"
        if woken is None and self.slo_p95_steps is not None and backlog == 0:
            self._maybe_scale_in()
        self.park_idle_engines()
        if woken is not None:
            self.autoscale_log.append({"step": self.steps, "action":
                                       "scale_out", "signal": signal,
                                       "device": woken})
        return woken

    def _maybe_scale_in(self) -> Optional[str]:
        """Down-ramp consolidation: when the fleet is comfortably under
        SLO (projection below ``scale_in_margin * slo_p95_steps``, or no
        trend at all — a dead-quiet trough has no completions to measure a
        service rate from), drain the highest-draw drainable device so it
        parks. At most one drain per autoscale tick; ``consolidate``
        dry-runs the re-packing first, so an infeasible drain is a no-op.
        """
        projected = self.elastic.projected_p95_steps(0, self.slo_horizon)
        if (projected is not None
                and projected > self.scale_in_margin * self.slo_p95_steps):
            return None
        dev = self.elastic.pick_scale_in_device(min_active=1)
        if dev is None:
            return None
        # mark the drain target BEFORE consolidating so autoscale's
        # backlog sample never counts its departing queue; overlapped
        # hand-offs keep it marked until their copy completes
        self._draining.add(dev)
        ok = self.elastic.consolidate(dev)
        if not ok or self._inflight_handoffs.get(dev, 0) == 0:
            self._draining.discard(dev)
        if not ok:
            return None
        self.autoscale_log.append({"step": self.steps, "action": "scale_in",
                                   "device": dev})
        return dev

    def _handoff_begun(self, device_id: str) -> None:
        """An overlapped hand-off started copying off ``device_id``."""
        self._draining.add(device_id)
        self._inflight_handoffs[device_id] = \
            self._inflight_handoffs.get(device_id, 0) + 1

    def _handoff_done(self, device_id: str) -> None:
        n = self._inflight_handoffs.get(device_id, 0) - 1
        if n <= 0:
            self._inflight_handoffs.pop(device_id, None)
            self._draining.discard(device_id)
        else:
            self._inflight_handoffs[device_id] = n

    def _page_hungriest_slices(self) -> Dict[str, str]:
        """device_id -> slice_id of the tenant holding the most pool pages
        there (the best candidate to move off a page-pressured device)."""
        out: Dict[str, str] = {}
        for dev, eng in self._engines.items():
            if not eng.paged:
                continue
            by_tenant = eng.pool.pages_by_tenant()
            for tenant in sorted(by_tenant, key=by_tenant.get,
                                 reverse=True):
                sess = self._sessions.get(tenant)
                if sess is not None:
                    out[dev] = sess.slice_id
                    break
        return out

    def _deepest_queued_tenant(self) -> Optional[str]:
        best, depth = None, 0
        for eng in self._engines.values():
            for tenant, n in eng.queued_by_tenant().items():
                if n > depth and tenant in self._sessions:
                    best, depth = tenant, n
        return best

    # ------------------------------------------------------------------
    def stats(self) -> dict:
        """OPERATOR view: every session's counters and quota. Anything a
        tenant can call must go through ``tenant_status`` instead."""
        return {t: {"slice": s.slice_id, "device": self._device_of.get(t),
                    "slots": s.slots, "submitted": s.submitted,
                    "served": s.served, "tokens_out": s.tokens_out,
                    "quota": self.hv.admission.usage(t)}
                for t, s in self._sessions.items()}

    def tenant_status(self, tenant: str) -> dict:
        """Tenant-facing status: ONLY ``tenant``'s own session, quota and
        page holdings, on whatever device currently hosts it. No
        co-tenant names, pool occupancy, or fleet telemetry — the
        cross-tenant observability ``stats()``/``fleet_stats()`` expose
        is operator-only (see ARCHITECTURE.md, threat model)."""
        out = dict(self.hv.monitor.tenant_status(tenant))
        sess = self._sessions.get(tenant)
        if sess is not None:
            out["session"] = {"slice": sess.slice_id, "slots": sess.slots,
                              "submitted": sess.submitted,
                              "served": sess.served,
                              "tokens_out": sess.tokens_out}
            eng = self._engines.get(self._device_of.get(tenant))
            if eng is not None and eng.paged:
                out["pages_held"] = eng.pool.tenant_pages(tenant)
        out["quota"] = self.hv.admission.usage(tenant)
        return out

    def fleet_stats(self) -> dict:
        return {dev: {"active": sum(e.active_by_tenant().values()),
                      "queued": sum(e.queued_by_tenant().values()),
                      "steps": e.steps,
                      **({"pages": e.page_stats()} if e.paged else {})}
                for dev, e in self._engines.items()}
