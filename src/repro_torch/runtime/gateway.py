"""Multi-tenant serving gateway: the hypervisor as the single entry point
for inference traffic (paper §IV + RC2F §III shared-shell multi-tenancy).

Before this layer existed, the continuous-batching engine ran *beside* the
RC3E control plane — requests never touched vSlice allocation, admission or
the straggler monitor. The gateway closes that gap:

  * every tenant opens a *session*: quota-checked by the RC2F admission
    controller, bound to a hypervisor-allocated vSlice, and its decode
    program is PR-swapped onto that slice from the program cache;
  * every request is admitted against the tenant's service-model quota and
    dynamically batched ACROSS tenants on the shared device (the engine's
    tenant-tagged queues + slice-aware slot shares);
  * every decode step is attributed to the active tenants' slices,
    share-weighted, so a tenant hogging the device shows up as a straggler
    and gets migrated by the existing ``Hypervisor.migrate_stragglers``;
  * every completed request is logged against its vSlice in
    ``Hypervisor.log`` — the audit trail the paper's middleware keeps.

One gateway owns ONE engine (one shared device). For serving across the
whole device fleet — placement that follows the DeviceDB, live hand-off of
in-flight requests on migration, elastic scale-out/park — use
``repro_torch.runtime.fleet.GatewayFleet``.

Ported from ``repro.runtime.gateway``. The decode program is configured
from an example of meta tensors (shapes and dtypes, no storage) and runs on
the engine's device (``Hypervisor(device=...)``, the card by default),
where it is a ``GraphProgram``: configure captures it once, and the
engine's buffers get a graph of their own at its first step.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.core.hypervisor import Hypervisor
from repro_torch.models import lm
from repro_torch.models.api import Model
from repro_torch.rc2f.admission import AdmissionError
from repro_torch.rc2f.core_api import meta_inputs
from repro_torch.runtime.serve import (BatchingEngine, Request,
                                      make_paged_serve_step, make_serve_step)


@dataclasses.dataclass
class TenantSession:
    """A tenant's binding to the shared serving device."""
    tenant: str
    slice_id: str
    slots: int                      # vSlice size -> engine slot share
    service_model: str = "baas"
    submitted: int = 0
    served: int = 0
    tokens_out: int = 0


def validate_submit(prompt, max_new_tokens: int, max_len: int) -> None:
    """Shared structural request checks (gateway AND fleet), applied BEFORE
    any quota is consumed so a rejection never leaks in-flight count."""
    if len(prompt) == 0:
        raise AdmissionError("empty prompt: a request needs at least one "
                             "prompt token to seed decoding")
    if len(prompt) + max_new_tokens > max_len:
        raise AdmissionError(
            f"request needs {len(prompt) + max_new_tokens} cache "
            f"positions, engine max_len is {max_len}")


def settle_finished_request(hv: Hypervisor,
                            sessions: Dict[str, TenantSession],
                            req: Request) -> None:
    """Account a completed request to its session and the hypervisor audit
    log — unless the submitting session closed while it decoded (possibly
    a new session reopened under the same tenant name), in which case its
    quota was already settled by close_session."""
    sess = sessions.get(req.tenant)
    if sess is None or sess is not getattr(req, "_session", None):
        return
    sess.served += 1
    sess.tokens_out += len(req.out_tokens)
    latency_ms = ((req.finished_at or time.monotonic())
                  - req.submitted_at) * 1e3
    hv.record_served_request(sess.slice_id, req.tenant, req.request_id,
                             len(req.prompt), len(req.out_tokens),
                             latency_ms)


def _placed(device) -> Tuple[str, int]:
    d = torch.device(device)
    if d.index is not None:
        return d.type, d.index
    current = d.type == "cuda" and torch.cuda.is_available()
    return d.type, torch.cuda.current_device() if current else 0


def check_program_device(hv: Hypervisor, model: Model) -> None:
    """Refuse a model that lives on another device than the hypervisor's
    programs. The configured program places its array arguments on
    ``hv.reconfig.device``; for a model elsewhere it would copy every weight
    and the whole KV cache on every step, and the decode's in-place cache
    writes would land in those throwaway copies (the engine's caches would
    never advance)."""
    if _placed(model.dev) != _placed(hv.reconfig.device):
        raise ValueError(
            f"the model is on {model.dev} but the hypervisor configures its "
            f"programs for {hv.reconfig.device}: pass the same device to "
            "Model(device=...) and Hypervisor(device=...)")


def serve_example(model: Model, params, n_slots: int, max_len: int,
                  paged: bool, page_size: int, cache_pages: int) -> tuple:
    """The decode program's example inputs as meta tensors: shapes and
    dtypes only, so the program cache pins neither the weights nor a
    duplicate KV-cache set (the reference keeps abstract values for the
    same reason).
    (params, caches, tokens (n_slots, 1), pos (n_slots,)) plus the
    (n_slots, max_len // page_size) block tables on a paged engine."""
    meta = torch.device("meta")
    caches = lm.make_paged_caches(model.cfg, cache_pages, page_size, meta) \
        if paged else lm.make_decode_caches(model.cfg, n_slots, max_len, meta)
    example = [meta_inputs(params), caches,
               torch.empty((n_slots, 1), dtype=torch.int32, device=meta),
               torch.empty((n_slots,), dtype=torch.int32, device=meta)]
    if paged:
        example.append(torch.empty((n_slots, max_len // page_size),
                                   dtype=torch.int32, device=meta))
    return tuple(example)


class ServingGateway:
    """Routes all serving traffic for one model through the hypervisor.

    One gateway owns one BatchingEngine (one shared device in the paper's
    terms); tenants co-reside on it exactly like vFPGAs on a physical FPGA.
    """

    def __init__(self, hv: Hypervisor, model: Model, params,
                 n_slots: int = 4, max_len: int = 256,
                 eos_id: Optional[int] = None, migrate_every: int = 0,
                 paged: bool = False, page_size: int = 16,
                 cache_pages: Optional[int] = None):
        check_program_device(hv, model)
        self.hv = hv
        self.model = model
        self.paged = paged
        self.engine = BatchingEngine(model, params, n_slots=n_slots,
                                     max_len=max_len, eos_id=eos_id,
                                     paged=paged, page_size=page_size,
                                     cache_pages=cache_pages)
        self.engine.on_step = self._on_step
        self.engine.on_finish = self._on_finish
        self.migrate_every = migrate_every   # steps between straggler sweeps
        self._sessions: Dict[str, TenantSession] = {}
        self.migrations: List[Tuple[str, str]] = []
        # the gateway owns ONE engine = one shared device; page occupancy
        # is reported against the inventory's first device (the fleet
        # reports per real device)
        self._device_key = next(iter(hv.db.devices), "device-0")
        # rebind at the source: ANY migrate_stragglers() call (ours or an
        # external ops sweep) immediately repoints affected sessions
        hv.migration_listeners.append(self._on_migration)

        # Configure the decode step THROUGH the hypervisor's reconfigurator:
        # the program lands in the RC3E program cache (full configuration
        # once), and each tenant session PR-swaps it onto its own vSlice.
        self._decode_fn = make_paged_serve_step(model) if paged \
            else make_serve_step(model)
        self._example = serve_example(model, params, n_slots, max_len,
                                      paged, page_size,
                                      self.engine.cache_pages)
        self._desc = f"serve:{model.cfg.name}:slots{n_slots}:len{max_len}" \
            + (f":paged{page_size}" if paged else "")
        entry, dt, hit = hv.reconfig.partial_reconfigure(
            self._decode_fn, self._example, static_desc=self._desc)
        self.engine.use_program(entry.compiled)
        self.program_fingerprint = entry.fingerprint
        hv._log("gateway_up", model=model.cfg.name, n_slots=n_slots,
                fingerprint=entry.fingerprint, compile_s=dt, cache_hit=hit,
                paged=paged)

    # ------------------------------------------------------------------
    # Tenant sessions
    # ------------------------------------------------------------------
    def _session_page_grant(self, slots: int) -> int:
        """A k-slot session's share of the engine's page pool (its vSlice
        memory dimension): proportional to its compute share."""
        if not self.paged:
            return 0
        return max(1, self.engine.pool.total_pages * slots
                   // self.engine.n_slots)

    def open_session(self, tenant: str, slots: int = 1,
                     service_model: str = "baas") -> TenantSession:
        if tenant in self._sessions:
            raise ValueError(f"tenant {tenant!r} already has a session")
        vs = self.hv.open_serving_session(
            tenant, slots, service_model,
            cache_pages=self._session_page_grant(slots))
        try:
            # bind the shared decode program to this tenant's slice (PR
            # swap — cache hit, microseconds; ALLOCATED -> CONFIGURED)
            self.hv.program_slice(vs.slice_id, self._decode_fn,
                                  self._example, static_desc=self._desc)
            # slice-aware scheduling: a k-slot vSlice holds k engine slots,
            # and its fair-share weight in the deficit round-robin is
            # proportional to the compute share it paid for
            self.engine.set_tenant_share(tenant, slots)
            self.engine.set_tenant_weight(tenant, slots)
            if self.paged:
                # memory-aware scheduling: the engine's admission gate
                # queues the tenant once it holds its vSlice page grant
                # (hv already clamped it to the service model's quota)
                self.engine.set_tenant_pages(tenant, vs.cache_pages or None)
        except Exception:
            # a failed bind must hand back the slice AND the tenant's
            # admission charge, or the tenant is stranded admitted against
            # a slice it can never decode on
            self.hv.close_serving_session(vs.slice_id)
            raise
        sess = TenantSession(tenant, vs.slice_id, slots, service_model)
        self._sessions[tenant] = sess
        return sess

    def close_session(self, tenant: str):
        sess = self._sessions.pop(tenant)
        # drop queued requests and settle ALL outstanding in-flight quota
        # now (requests still decoding finish as orphans — see _on_finish)
        self.engine.cancel_queued(tenant)
        for _ in range(max(0, sess.submitted - sess.served)):
            self.hv.admission.finish_request(tenant, sess.service_model)
        self.engine.set_tenant_share(tenant, None)
        self.engine.set_tenant_weight(tenant, None)
        self.engine.set_tenant_pages(tenant, None)
        self.hv.close_serving_session(sess.slice_id)

    def close(self):
        for tenant in list(self._sessions):
            self.close_session(tenant)
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
        validate_submit(prompt, max_new_tokens, self.engine.max_len)
        self.hv.admit_serving_request(sess.slice_id, len(prompt),
                                      max_new_tokens)
        sess.submitted += 1
        try:
            req = self.engine.submit(prompt, max_new_tokens, tenant=tenant)
        except Exception:
            # an engine rejection (oversized request, paged worst-case
            # check) must hand back the quota charged two lines up
            sess.submitted -= 1
            self.hv.admission.finish_request(tenant, sess.service_model)
            raise
        # stamp the session identity: if the session is closed and reopened
        # while this request still decodes, the orphan must not be
        # attributed (or quota-settled) against the new session
        req._session = sess
        return req

    def cancel(self, req: Request) -> bool:
        """Cancel one request (queued or in flight — a timed-out client
        must not burn a slot until max_new_tokens). The engine fires
        ``on_finish``, so the quota settles like a completion."""
        return self.engine.cancel(req)

    def step(self) -> int:
        """One shared decode step across all tenants; periodically sweeps
        for straggling (hot) tenants and rebinds migrated sessions."""
        n = self.engine.step()
        if self.paged:
            self.hv.monitor.record_pages(self._device_key,
                                         self.engine.pool.used_pages,
                                         self.engine.pool.total_pages)
            self.hv.monitor.record_scrub(self._device_key,
                                         self.engine.pool.pages_scrubbed,
                                         self.engine.scrub_ms)
        if self.migrate_every and self.engine.steps \
                and self.engine.steps % self.migrate_every == 0:
            self.rebalance()
        return n

    def step_async(self, prefill_chunk: int = 4) -> int:
        """The chunked-prefill engine path (``BatchingEngine.step_async``)
        behind the same telemetry/rebalance plumbing as ``step`` — newly
        admitted prompts spend a few steps PREFILLING while the resident
        slots keep decoding, instead of stalling the whole batch."""
        n = self.engine.step_async(prefill_chunk)
        if self.paged:
            self.hv.monitor.record_pages(self._device_key,
                                         self.engine.pool.used_pages,
                                         self.engine.pool.total_pages)
            self.hv.monitor.record_scrub(self._device_key,
                                         self.engine.pool.pages_scrubbed,
                                         self.engine.scrub_ms)
        if self.migrate_every and self.engine.steps \
                and self.engine.steps % self.migrate_every == 0:
            self.rebalance()
        return n

    def run_until_idle(self, max_steps: int = 10000) -> bool:
        """Returns True when fully drained; False on a stall (max_steps
        expired, or queued work that can make no progress)."""
        for _ in range(max_steps):
            n = self.step()
            if self.engine.idle():
                return True
            if n == 0:
                return False
        return self.engine.idle()

    # ------------------------------------------------------------------
    # Telemetry -> control plane
    # ------------------------------------------------------------------
    def _on_step(self, active_by_tenant: Dict[str, int], step_ms: float):
        total = sum(active_by_tenant.values()) or 1
        for tenant, n in active_by_tenant.items():
            sess = self._sessions.get(tenant)
            if sess is None:
                continue
            # per-entitled-slot attribution: tenants using exactly their
            # share record equal times (no churn from mere size
            # differences); a slice on a slow/overloaded device records
            # consistently higher and is what the straggler policy catches
            self.hv.record_serving_step(
                sess.slice_id, step_ms * n / (total * sess.slots))

    def _on_finish(self, req: Request):
        settle_finished_request(self.hv, self._sessions, req)

    def _on_migration(self, old: str, new: str):
        for sess in self._sessions.values():
            if sess.slice_id == old:
                sess.slice_id = new
                self.migrations.append((old, new))

    def rebalance(self) -> List[Tuple[str, str]]:
        """Run the hypervisor's straggler sweep; migrated sessions are
        rebound by the migration listener."""
        self.hv.migrate_stragglers()
        return self.hv.last_migrations

    # ------------------------------------------------------------------
    def stats(self) -> dict:
        """OPERATOR view: every session's counters and quota. Anything a
        tenant can call must go through ``tenant_status`` instead."""
        return {t: {"slice": s.slice_id, "slots": s.slots,
                    "submitted": s.submitted, "served": s.served,
                    "tokens_out": s.tokens_out,
                    "quota": self.hv.admission.usage(t)}
                for t, s in self._sessions.items()}

    def tenant_status(self, tenant: str) -> dict:
        """Tenant-facing status: ONLY ``tenant``'s own session counters,
        quota usage, page holdings and slices. Notably absent: co-tenant
        names, shared-pool occupancy, fleet step medians — each is a
        side channel a hostile tenant could poll to profile co-residents
        (see ARCHITECTURE.md, tenant isolation & threat model)."""
        out = dict(self.hv.monitor.tenant_status(tenant))
        sess = self._sessions.get(tenant)
        if sess is not None:
            out["session"] = {"slice": sess.slice_id, "slots": sess.slots,
                              "submitted": sess.submitted,
                              "served": sess.served,
                              "tokens_out": sess.tokens_out}
        out["quota"] = self.hv.admission.usage(tenant)
        if self.paged:
            out["pages_held"] = self.engine.pool.tenant_pages(tenant)
        return out

    def page_stats(self) -> dict:
        return self.engine.page_stats()
