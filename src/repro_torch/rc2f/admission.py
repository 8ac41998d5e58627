"""Admission control for the RC2F shell — the paper's planned "sanity
checking for (partial) bitfiles" (§VI) plus per-service-model quotas.

Two layers:

* ``admit_core`` — structural checks on a user core, realized as a run on
  meta tensors (shapes and dtypes, no data, no kernel launched): the core
  must run against its declared stream shapes, touch no out-of-contract
  state, and produce finite-sized outputs.
* ``AdmissionController`` — capacity/quota policy per service model
  (RSaaS / RAaaS / BAaaS): how many slots one tenant may hold, how many
  requests it may keep in flight, and how large a request may be. The
  hypervisor owns one controller; the serving gateway consults it before
  any tenant traffic reaches a device.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

import numpy as np

from repro_torch.rc2f.core_api import meta_inputs, tree_leaves


class AdmissionError(RuntimeError):
    pass


MAX_OUTPUT_BYTES = 16 << 30      # per block, per slice
MAX_INTERMEDIATE_RATIO = 1024    # outputs can't explode vs inputs


def admit_core(core_fn: Callable, example_inputs) -> None:
    """Run the core on meta tensors of the declared shapes (no FLOPs spent).

    Raises AdmissionError on contract violations — the analogue of rejecting
    a tampered bitstream before it touches the device.
    """
    try:
        out = core_fn(*meta_inputs(example_inputs)) \
            if isinstance(example_inputs, tuple) \
            else core_fn(meta_inputs(example_inputs))
    except Exception as e:  # noqa: BLE001
        raise AdmissionError(f"core failed abstract evaluation: {e}") from e

    in_bytes = sum(_nbytes(x) for x in tree_leaves(example_inputs))
    out_bytes = sum(_nbytes(x) for x in tree_leaves(out))
    if out_bytes > MAX_OUTPUT_BYTES:
        raise AdmissionError(
            f"core output {out_bytes} bytes exceeds per-slice limit")
    if in_bytes and out_bytes > MAX_INTERMEDIATE_RATIO * in_bytes:
        raise AdmissionError(
            f"core amplifies {in_bytes}B -> {out_bytes}B (> x{MAX_INTERMEDIATE_RATIO})")


def _nbytes(x) -> int:
    return int(np.prod(x.shape)) * x.dtype.itemsize if x.shape else \
        x.dtype.itemsize


# ---------------------------------------------------------------------------
# Per-service-model quotas (paper §III: the three models expose different
# amounts of the device, so they get different ceilings)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ServiceQuota:
    max_slots_per_tenant: int = 4        # vSlice slots one tenant may hold
    max_inflight_requests: int = 32      # concurrent serving requests
    max_prompt_tokens: int = 4096
    max_new_tokens: int = 1024
    # KV-cache pool pages one tenant may hold on a paged engine (0 = no
    # cap). Enforced at the engine's admission gate with
    # queue-on-exhaustion semantics: a tenant at its ceiling has further
    # requests wait in its queue instead of OOMing the shared pool — the
    # memory-fabric analogue of the slot quota (per-tenant accounting of
    # every shared resource, not just compute).
    max_cache_pages_per_tenant: int = 0
    # Token-bucket rate limit on request submission (0 = unlimited).
    # ``rate_limit_rps`` refills the bucket per clock second;
    # ``rate_limit_burst`` caps it (0 derives max(1, rps)). Refusals shed
    # a cancel/resubmit churn or request-flood attack at the cheapest
    # possible point — before any prefill, page, or slot is touched.
    rate_limit_rps: float = 0.0
    rate_limit_burst: int = 0


DEFAULT_QUOTAS: Dict[str, ServiceQuota] = {
    # RSaaS tenants own whole devices; request limits are irrelevant there
    "rsaas": ServiceQuota(max_slots_per_tenant=4, max_inflight_requests=256),
    "raas": ServiceQuota(max_slots_per_tenant=2, max_inflight_requests=64),
    # BAaaS is the shared serving pool: tight per-tenant ceilings so one
    # tenant cannot monopolize the provider's device
    "baas": ServiceQuota(max_slots_per_tenant=2, max_inflight_requests=16,
                         max_prompt_tokens=2048, max_new_tokens=512,
                         max_cache_pages_per_tenant=256),
}


@dataclass
class _TenantUsage:
    slots: int = 0
    inflight: int = 0
    admitted: int = 0
    rejected: int = 0
    rate_limited: int = 0
    bucket: float = -1.0        # token-bucket level (-1: not yet filled)
    refilled_at: float = 0.0


class AdmissionController:
    """Quota bookkeeping per (tenant, service model): what a tenant holds
    under RAaaS does not count against its BAaaS ceiling and vice versa.

    Raises ``AdmissionError`` when a tenant would exceed its ceiling; the
    caller (hypervisor / gateway) never allocates on a rejected request.

    ``clock`` drives the rate-limit token buckets. The hypervisor passes
    its own (fake, in tests and the soak harness) clock so refill is
    deterministic event time, never wall time — the same discipline as
    every other time source in the stack.
    """

    def __init__(self, quotas: Optional[Dict[str, ServiceQuota]] = None,
                 clock: Optional[Callable[[], float]] = None):
        self.quotas = dict(DEFAULT_QUOTAS)
        if quotas:
            self.quotas.update(quotas)
        self.clock = clock if clock is not None else time.monotonic
        self._usage: Dict[tuple, _TenantUsage] = {}

    def quota_for(self, service_model: str) -> ServiceQuota:
        try:
            return self.quotas[service_model]
        except KeyError:
            raise AdmissionError(f"unknown service model {service_model!r}") \
                from None

    def _u(self, tenant: str, service_model: str) -> _TenantUsage:
        return self._usage.setdefault((tenant, service_model),
                                      _TenantUsage())

    # ---------------- tenant (slot) admission ----------------
    def admit_tenant(self, tenant: str, service_model: str, slots: int):
        q = self.quota_for(service_model)
        u = self._u(tenant, service_model)
        if u.slots + slots > q.max_slots_per_tenant:
            u.rejected += 1
            raise AdmissionError(
                f"tenant {tenant!r} would hold {u.slots + slots} slots, "
                f"{service_model} quota is {q.max_slots_per_tenant}")
        u.slots += slots

    def release_tenant(self, tenant: str, service_model: str, slots: int):
        u = self._u(tenant, service_model)
        u.slots = max(0, u.slots - slots)

    # ---------------- request admission ----------------
    def _take_rate_token(self, tenant: str, service_model: str,
                         q: ServiceQuota, u: _TenantUsage) -> None:
        """Per-tenant token bucket: refill at ``rate_limit_rps`` per clock
        second up to the burst cap, spend one token per submission.
        Raises (and counts the refusal) when the bucket is dry — the
        caller sheds the request before it costs anything downstream."""
        if q.rate_limit_rps <= 0:
            return
        burst = float(q.rate_limit_burst) if q.rate_limit_burst > 0 \
            else max(1.0, q.rate_limit_rps)
        now = self.clock()
        if u.bucket < 0:
            u.bucket = burst               # a new tenant starts with a
            u.refilled_at = now            # full burst allowance
        else:
            u.bucket = min(burst, u.bucket +
                           max(0.0, now - u.refilled_at) * q.rate_limit_rps)
            u.refilled_at = now
        if u.bucket < 1.0:
            u.rejected += 1
            u.rate_limited += 1
            raise AdmissionError(
                f"tenant {tenant!r} rate-limited: {service_model} allows "
                f"{q.rate_limit_rps} req/s (burst {burst:g})")
        u.bucket -= 1.0

    def admit_request(self, tenant: str, service_model: str,
                      prompt_tokens: int, new_tokens: int):
        q = self.quota_for(service_model)
        u = self._u(tenant, service_model)
        self._take_rate_token(tenant, service_model, q, u)
        if u.inflight >= q.max_inflight_requests:
            u.rejected += 1
            raise AdmissionError(
                f"tenant {tenant!r} has {u.inflight} requests in flight "
                f"(quota {q.max_inflight_requests})")
        if prompt_tokens > q.max_prompt_tokens:
            u.rejected += 1
            raise AdmissionError(
                f"prompt of {prompt_tokens} tokens exceeds "
                f"{service_model} limit {q.max_prompt_tokens}")
        if new_tokens > q.max_new_tokens:
            u.rejected += 1
            raise AdmissionError(
                f"{new_tokens} new tokens exceeds {service_model} "
                f"limit {q.max_new_tokens}")
        u.inflight += 1
        u.admitted += 1

    def finish_request(self, tenant: str, service_model: str):
        u = self._u(tenant, service_model)
        u.inflight = max(0, u.inflight - 1)

    # ---------------- introspection ----------------
    def usage(self, tenant: str,
              service_model: Optional[str] = None) -> dict:
        """Usage counters for one service model, or summed across all of a
        tenant's models when ``service_model`` is None. Read-only: never
        creates usage records for unknown tenants."""
        if service_model is not None:
            us = [self._usage.get((tenant, service_model),
                                  _TenantUsage())]
        else:
            us = [u for (t, _), u in self._usage.items() if t == tenant]
        return {"slots": sum(u.slots for u in us),
                "inflight": sum(u.inflight for u in us),
                "admitted": sum(u.admitted for u in us),
                "rejected": sum(u.rejected for u in us),
                "rate_limited": sum(u.rate_limited for u in us)}
