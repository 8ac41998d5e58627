"""Adversarial-tenant scenario harness: seeded hostile behaviors against a
shared serving device, with isolation invariants machine-checked after
EVERY step (ported from ``repro.runtime.adversary``: the imports switched
to the port, a ``device`` for the scenario's hypervisor, and the
zero-on-free readback done on the device over the torch pools).

Threat model (see ARCHITECTURE.md, "Tenant isolation & threat model"): a
hostile co-tenant on a shared paged engine may try to

  * **flood** the admission queue with long prompts (prefill monopoly),
  * **squat** on the page pool with long-lived max-length decodes
    (memory exhaustion),
  * **churn** cancel/resubmit cycles (quota-settle and scrub-queue abuse),
  * **probe** the prefix cache with a co-tenant's prompts (residual-state
    and timing side channel).

``run_scenario`` replays a fixed, seeded victim workload next to one such
behavior on a single shared device (one ``ServingGateway`` — co-residency
by construction) and reports per-tenant latency/goodput so tests can
assert the victim's p95 stays within a configured fairness bound of a
solo (attacker-free) baseline run of the *bit-identical* victim workload.

Everything is deterministic: prompts come from ``seeded_rng`` sub-seeds,
time is an injected ``FakeClock`` (one tick per round — the admission
rate limiter refills on it, never on wall-clock), and two runs with the
same (model, seed, behavior) are identical.

After every step the harness checks, on the live engine:

  * ``PagePoolManager.verify`` — conservation, refcounts, prefix-cache and
    pending-scrub consistency;
  * **cross-tenant page disjointness** — no physical page is referenced by
    two tenants' slots (the salted prefix chain makes cross-tenant COW
    sharing impossible; this is the device-level restatement);

and at teardown ``assert_free_pages_zeroed`` reads the *device* pool
through the real caches: every free-list page must hold zeros (pos -1,
scales 1) — the zero-on-free contract, end to end. On the card that is
a read of the pools in device memory itself: the free pages are gathered
and compared there, and one flag a page comes back to the host.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import ClusterSpec, Hypervisor, MonitorConfig
from repro_torch.rc2f.admission import AdmissionError
from repro_torch.runtime.faults import FakeClock, seeded_rng
from repro_torch.runtime.gateway import ServingGateway
from repro_torch.runtime.serve import _site_caches

VICTIM = "victim"
HOSTILE = "mallory"


def _mix(seed: int, tag: str) -> int:
    """Stable sub-seed derivation (crc32, not Python's salted hash)."""
    return (int(seed) * 0x9E3779B1 + zlib.crc32(tag.encode())) % (2 ** 31)


# ---------------------------------------------------------------------------
# Hostile behaviors (all seeded; each acts once per round through the
# scenario's submit/cancel facade, which counts refusals as shed load)
# ---------------------------------------------------------------------------

class PromptFlood:
    """Long-prompt admission flood: every round submits ``burst`` prompts
    sized near the engine's max. The DRR admission debit is proportional
    to prefill length, so each flood admission costs Mallory several
    rounds of credit — the attack self-penalizes."""
    name = "prompt_flood"

    def __init__(self, burst: int = 4):
        self.burst = burst

    def act(self, rng, ctl) -> None:
        for _ in range(self.burst):
            n = ctl.max_len - 8 - rng.randrange(4)
            ctl.submit(HOSTILE, ctl.prompt(rng, n), new_tokens=2)


class PageSquat:
    """Page-pool squatting: keep ``keep`` long-decode requests outstanding
    so Mallory's pages stay resident as long as possible. The per-tenant
    page cap (vSlice grant) bounds what the squat can ever hold; the
    victim's grant is untouchable."""
    name = "page_squat"

    def __init__(self, keep: int = 6):
        self.keep = keep

    def act(self, rng, ctl) -> None:
        while ctl.outstanding(HOSTILE) < self.keep:
            if not ctl.submit(HOSTILE, ctl.prompt(rng, 16),
                              new_tokens=ctl.max_len - 24):
                break                     # quota/rate refusals: stop early


class CancelChurn:
    """Cancel/resubmit churn: every round cancels everything Mallory has
    outstanding and submits a fresh burst. Exercises quota settle-once,
    scrub-queue turnover, and (with a rate limit set) the token bucket."""
    name = "cancel_churn"

    def __init__(self, burst: int = 3):
        self.burst = burst

    def act(self, rng, ctl) -> None:
        ctl.cancel_all(HOSTILE)
        for _ in range(self.burst):
            ctl.submit(HOSTILE, ctl.prompt(rng, 12), new_tokens=12)


class PrefixProbe:
    """Prefix-cache probing: replay the victim's own prompts verbatim (an
    attacker who guesses or learns them). With the per-tenant salted hash
    chain the probe must never match the prefix cache or share a page —
    the per-step disjointness check is the teeth of this scenario."""
    name = "prefix_probe"

    def act(self, rng, ctl) -> None:
        if ctl.victim_prompts:
            probe = ctl.victim_prompts[rng.randrange(
                len(ctl.victim_prompts))]
            ctl.submit(HOSTILE, list(probe), new_tokens=2)


BEHAVIORS = (PromptFlood, PageSquat, CancelChurn, PrefixProbe)


# ---------------------------------------------------------------------------
# Per-step isolation checks
# ---------------------------------------------------------------------------

def check_isolation(engine) -> None:
    """Pool conservation + cross-tenant page disjointness on a live paged
    engine. Called after every scenario step."""
    pool = engine.pool
    pool.verify()
    held: Dict[str, set] = {}
    for slot, req in enumerate(engine._slots):
        if req is None:
            continue
        held.setdefault(req.tenant, set()).update(pool.slot_blocks(slot))
    tenants = sorted(held)
    for i, a in enumerate(tenants):
        for b in tenants[i + 1:]:
            shared = held[a] & held[b]
            assert not shared, \
                f"tenants {a!r} and {b!r} share physical pages " \
                f"{sorted(shared)} — cross-tenant KV exposure"


def assert_free_pages_zeroed(engine) -> int:
    """Zero-on-free, checked at the DEVICE: flush the pending scrub queue,
    then read every free-list page through the real caches — K/V must be
    all zeros, pos all -1, quant scales all 1. The pages are gathered and
    compared where the pools lie; one flag a page and cache leaf comes to
    the host, in one transfer. Returns the number of pages checked
    (callers assert it is nonzero so the check cannot pass vacuously)."""
    engine._flush_scrub()
    assert engine.pool.scrub_pending == 0
    free = sorted(engine.pool._free)
    if not free:
        return 0
    leaves, whats, oks = [], [], []
    for site in _site_caches(engine.caches):
        leaves += [(key, site[key]) for key in sorted(site)]
    sel = torch.as_tensor(free, dtype=torch.int64, device=leaves[0][1].device)
    for key, leaf in leaves:                 # (L, P, ps, ...)
        got = leaf.index_select(1, sel)
        if key == "pos":
            expect, what = -1, "pos != -1"
        elif key in ("k_scale", "v_scale"):
            expect, what = 1, "quant scale != 1"
        else:
            expect, what = 0, "nonzero K/V residue"
        oks.append((got.reshape(got.shape[0], got.shape[1], -1) == expect)
                   .all(dim=2).all(dim=0))
        whats.append(what)
    ok = torch.stack(oks).cpu().numpy()  # rc3e: allow-host-sync — test oracle
    for row, what in zip(ok, whats):
        bad = [free[i] for i in np.flatnonzero(~row)]
        assert not bad, \
            f"free pages {bad} leak freed-tenant state ({what})"
    return len(free)


# ---------------------------------------------------------------------------
# Scenario runner
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ScenarioReport:
    """Deterministic outcome of one scenario run (no wall-clock values:
    latencies are in engine steps, time is the FakeClock)."""
    behavior: str
    rounds: int
    steps: int
    latency: Dict[str, List[int]]        # completed requests, in steps
    submitted: Dict[str, int]
    completed: Dict[str, int]
    cancelled: Dict[str, int]
    shed: Dict[str, int]                 # admission/rate/validate refusals
    rate_limited: int                    # token-bucket refusals (subset)
    pages_scrubbed: int
    free_pages_checked: int

    def p95(self, tenant: str) -> float:
        lat = sorted(self.latency.get(tenant, []))
        assert lat, f"no completed requests for {tenant!r}"
        return float(lat[int(round(0.95 * (len(lat) - 1)))])

    def max_latency(self, tenant: str) -> int:
        return max(self.latency.get(tenant, [0]))

    def goodput(self, tenant: str) -> float:
        """Completions per round over the submission horizon."""
        return self.completed.get(tenant, 0) / max(1, self.rounds)


class _ScenarioControl:
    """The facade behaviors act through: submits count refusals as shed
    (never an exception — over-admission is part of the experiment)."""

    def __init__(self, gw: ServingGateway, vocab: int):
        self.gw = gw
        self.vocab = vocab
        self.max_len = gw.engine.max_len
        self.victim_prompts: List[List[int]] = []
        self.outstanding_reqs: List[Tuple[object, str, int]] = []
        self.submitted: Dict[str, int] = {}
        self.shed: Dict[str, int] = {}
        self._step = 0

    def prompt(self, rng, n: int) -> List[int]:
        return [rng.randrange(self.vocab) for _ in range(max(1, n))]

    def submit(self, tenant: str, prompt: List[int],
               new_tokens: int) -> bool:
        try:
            req = self.gw.submit(tenant, prompt, max_new_tokens=new_tokens)
        except (AdmissionError, ValueError):
            self.shed[tenant] = self.shed.get(tenant, 0) + 1
            return False
        self.submitted[tenant] = self.submitted.get(tenant, 0) + 1
        self.outstanding_reqs.append((req, tenant, self._step))
        return True

    def outstanding(self, tenant: str) -> int:
        return sum(1 for _, t, _ in self.outstanding_reqs if t == tenant)

    def cancel_all(self, tenant: str) -> int:
        n = 0
        for req, t, _ in list(self.outstanding_reqs):
            if t == tenant and self.gw.cancel(req):
                n += 1
        return n


def run_scenario(model, params, behavior=None, seed: int = 0,
                 rounds: int = 48, victim_every: int = 4,
                 victim_prompt_len: int = 6, victim_new_tokens: int = 6,
                 n_slots: int = 4, max_len: int = 64, page_size: int = 8,
                 cache_pages: Optional[int] = None, quota=None,
                 drain_slack: int = 400, device="cuda") -> ScenarioReport:
    """Run one seeded hostile behavior (or, with ``behavior=None``, the
    solo baseline) against the fixed victim workload on one shared paged
    device. The victim's submissions are a pure function of ``seed`` —
    identical across the baseline and every attacked run — so latency
    deltas are attributable to the attacker alone. The hypervisor runs its
    programs on ``device`` (the card unless the caller passes
    ``device="cpu"``; the model must be on the same device)."""
    clock = FakeClock()
    hv = Hypervisor(ClusterSpec(n_nodes=1, devices_per_node=1),
                    MonitorConfig(heartbeat_interval_s=1.0,
                                  heartbeat_deadline_s=2.5),
                    clock=clock, device=device)
    if quota is not None:
        hv.admission.quotas["baas"] = quota
    gw = ServingGateway(hv, model, params, n_slots=n_slots, max_len=max_len,
                        paged=True, page_size=page_size,
                        cache_pages=cache_pages)
    gw.open_session(VICTIM, slots=2, service_model="baas")
    if behavior is not None:
        gw.open_session(HOSTILE, slots=2, service_model="baas")

    vocab = model.cfg.vocab_size
    victim_rng = seeded_rng(_mix(seed, "adversary/victim"))
    hostile_rng = seeded_rng(_mix(seed, "adversary/hostile"))
    ctl = _ScenarioControl(gw, vocab)

    latency: Dict[str, List[int]] = {}
    completed: Dict[str, int] = {}
    cancelled: Dict[str, int] = {}
    steps = 0

    def _poll() -> None:
        for item in list(ctl.outstanding_reqs):
            req, tenant, t0 = item
            if not req.done.is_set():
                continue
            ctl.outstanding_reqs.remove(item)
            if req.finish_reason == "cancelled":
                cancelled[tenant] = cancelled.get(tenant, 0) + 1
            else:
                completed[tenant] = completed.get(tenant, 0) + 1
                latency.setdefault(tenant, []).append(steps - t0)

    def _tick() -> int:
        nonlocal steps
        n = gw.step()
        steps += 1
        ctl._step = steps
        clock.advance(1.0)
        check_isolation(gw.engine)
        _poll()
        return n

    for r in range(rounds):
        if behavior is not None:
            behavior.act(hostile_rng, ctl)
        if r % victim_every == 0:
            p = ctl.prompt(victim_rng, victim_prompt_len)
            ctl.victim_prompts.append(p)
            ctl.submit(VICTIM, p, new_tokens=victim_new_tokens)
        _tick()

    # drain: no new submissions; a stalled drain (step made no progress
    # with work outstanding) is a scheduler bug, fail loudly
    for _ in range(drain_slack):
        if not ctl.outstanding_reqs:
            break
        n = _tick()
        assert n > 0 or not ctl.outstanding_reqs, \
            "drain stalled with requests outstanding (starvation)"
    assert not ctl.outstanding_reqs, \
        f"{len(ctl.outstanding_reqs)} requests never finished"

    free_checked = assert_free_pages_zeroed(gw.engine)
    usage = hv.admission.usage(HOSTILE) if behavior is not None \
        else hv.admission.usage(VICTIM)
    report = ScenarioReport(
        behavior=behavior.name if behavior is not None else "solo",
        rounds=rounds, steps=steps, latency=latency,
        submitted=dict(ctl.submitted), completed=completed,
        cancelled=cancelled, shed=dict(ctl.shed),
        rate_limited=int(usage["rate_limited"]),
        pages_scrubbed=gw.engine.pool.pages_scrubbed,
        free_pages_checked=free_checked)
    gw.close()
    return report
