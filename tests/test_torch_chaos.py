"""The reference's chaos suite (``tests/test_chaos.py``) on the port's
fleet, on the CPU: seeded fault schedules against a multi-device serving
fleet, with machine-checked invariants after EVERY step:

  * token-stream bit-exactness vs. a fault-free run of the same workload
    (greedy decode + journal prefix replay must make failover invisible);
  * page-pool conservation on every surviving engine
    (``PagePoolManager.verify``);
  * quota conservation per tenant (admission in-flight == unfinished
    journaled requests).

Every test of the reference file, with the same assertions, seeds
(``CHAOS_SEEDS``, default 0-4) and parametrisation, on
``Hypervisor(device="cpu")`` and ``Model(device="cpu")``. Parity: seed 0's
device kill through the JAX package's fleet and the port's gives the same
token logs (exactly) and the same ``fleet.recoveries``.

Weights: reduced smollm-135m in fp32, the JAX init carried across
(``params_from_numpy``); the token-margin premise is asserted as in
tests/test_torch_engine.py (``torch_parity.assert_margins``).
"""
import os

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.core import ClusterSpec as JClusterSpec
from repro.core import Hypervisor as JHypervisor
from repro.core import MonitorConfig as JMonitorConfig
from repro.models import get_model as j_get_model
from repro.runtime import FaultInjector as JFaultInjector
from repro.runtime import GatewayFleet as JGatewayFleet
from repro_torch.analysis import sanitizer
from repro_torch.configs import get_config, reduced
from repro_torch.core import (ClusterSpec, DeviceState, Hypervisor,
                              MonitorConfig)
from repro_torch.interop import params_from_numpy
from repro_torch.models import Model
from repro_torch.runtime import (BatchingEngine, EventLoop, FaultInjector,
                                 GatewayFleet)
from repro_torch.runtime.faults import FakeClock
from torch_parity import assert_margins

torch.set_num_threads(1)

SEEDS = [int(s) for s in
         os.environ.get("CHAOS_SEEDS", "0,1,2,3,4").split(",") if s.strip()]


@pytest.fixture(autouse=True)
def _sanitizer_reset():
    """Per-test sanitizer state: scope tokens are never reused, so clearing
    tracked objects between tests cannot alias a new fleet with an old one;
    it only keeps the per-run transition counts honest."""
    sanitizer.reset()
    yield

N_TENANTS = 6          # 2 slots each -> 3 active devices + 1 parked spare
REQS_PER_TENANT = 2
NEW_TOKENS = 8


@pytest.fixture(scope="module")
def jax_model():
    jcfg = j_reduced(j_get_config("smollm-135m")).replace(dtype="float32")
    jmodel = j_get_model(jcfg)
    return jmodel, jmodel.init(jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def served_model(jax_model):
    cfg = reduced(get_config("smollm-135m")).replace(dtype="float32")
    params = params_from_numpy(jax.tree.map(np.asarray, jax_model[1]), cfg)
    return cfg, Model(cfg, device="cpu"), params


def _prompt(cfg, n, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, size=n).tolist()


def _build_fleet(model, params, injector=None, n_nodes=4, ref=False, **kw):
    """Fleet whose hypervisor shares the injector's fake clock, so
    heartbeat deadlines advance one tick per decode step. ``ref``: the JAX
    package's hypervisor and fleet (parity test)."""
    clock = injector.clock if injector is not None else FakeClock()
    spec = dict(n_nodes=n_nodes, devices_per_node=1)
    mon = dict(heartbeat_interval_s=1.0, heartbeat_deadline_s=2.5)
    if ref:
        hv = JHypervisor(JClusterSpec(**spec), JMonitorConfig(**mon),
                         clock=clock)
        fleet_cls = JGatewayFleet
    else:
        hv = Hypervisor(ClusterSpec(**spec), MonitorConfig(**mon),
                        clock=clock, device="cpu")
        fleet_cls = GatewayFleet
    fleet = fleet_cls(hv, model, params, n_slots=4, max_len=64,
                      paged=True, faults=injector, **kw)
    return hv, fleet


def _run_workload(cfg, model, params, injector=None, max_steps=400,
                  loop="lockstep", prefill_chunk=4, ref=False):
    """The fixed chaos workload (identical across seeds — only the fault
    schedule varies): 6 two-slot tenants packed onto 3 devices, 2 requests
    each, one spare PARKED device. Steps the fleet with invariant checks
    after every event until every request settles. ``loop="event"`` drives
    the same workload through the event queue (chunked prefill, batched
    journal syncs, overlapped hand-offs) instead of the round barrier."""
    hv, fleet = _build_fleet(model, params, injector, ref=ref)
    for ti in range(N_TENANTS):
        fleet.open_session(f"t{ti}", slots=2)
    assert len(fleet._engines) == 3          # packed, spare left parked
    reqs = {}
    for ti in range(N_TENANTS):
        for k in range(REQS_PER_TENANT):
            reqs[(ti, k)] = fleet.submit(
                f"t{ti}", _prompt(cfg, 5 + ti, seed=100 + ti * 10 + k),
                max_new_tokens=NEW_TOKENS)
    ev = EventLoop(fleet, prefill_chunk=prefill_chunk) \
        if loop == "event" else None
    for _ in range(max_steps):
        fleet.step() if ev is None else ev.run_ticks(1)
        fleet.verify_invariants()
        if all(r.done.is_set() for r in reqs.values()):
            break
    if ev is not None:
        fleet.flush_journal()                # drain the batched syncs
    assert all(r.done.is_set() for r in reqs.values()), \
        "workload did not drain"
    # post-drain conservation: every surviving pool returned every page,
    # every tenant's in-flight quota settled, no stale occupancy entries
    for eng in fleet._engines.values():
        eng.pool.verify()
        assert eng.pool.used_pages == 0
    for ti in range(N_TENANTS):
        if f"t{ti}" in fleet._sessions:
            assert hv.admission.usage(f"t{ti}")["inflight"] == 0
    assert set(hv.monitor.page_occupancy()) <= set(fleet._engines)
    if sanitizer.enabled and not ref:
        # the run exercised (and the sanitizer checked) every lifecycle
        # machine: requests, engine slots, pool pages, journal entries and
        # physical devices all made legal transitions only
        active = {m for m, n in sanitizer.stats().items() if n}
        assert {"request", "slot", "page", "journal", "device"} <= active
    tokens = {k: list(r.out_tokens) for k, r in reqs.items()}
    return tokens, reqs, hv, fleet


@pytest.fixture(scope="module")
def baseline_tokens(served_model):
    """The fault-free run every chaos schedule must be bit-exact against."""
    cfg, model, params = served_model
    tokens, reqs, hv, fleet = _run_workload(cfg, model, params)
    assert all(len(t) == NEW_TOKENS for t in tokens.values())
    fleet.close()
    return tokens


# ---------------------------------------------------------------------------
# Event-driven loop parity (satellite: lockstep vs event token exactness)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("loop,prefill_chunk",
                         [("lockstep", 4), ("event", 4), ("event", 2)],
                         ids=["lockstep", "event", "event-chunk2"])
def test_loop_modes_produce_identical_token_logs(served_model,
                                                 baseline_tokens, loop,
                                                 prefill_chunk):
    """Fault-free, the event-driven loop (chunked prefill, per-engine
    cadence, batched journal syncs) must emit token logs bit-identical to
    the lockstep barrier — the loop is a scheduling change, never a
    results change. Exercised at two prefill chunk sizes: chunking only
    reshapes WHEN prompt tokens are spliced, not what gets decoded."""
    cfg, model, params = served_model
    tokens, reqs, hv, fleet = _run_workload(
        cfg, model, params, loop=loop, prefill_chunk=prefill_chunk)
    assert tokens == baseline_tokens
    fleet.close()


@pytest.mark.parametrize("seed", SEEDS[:2])
def test_event_loop_device_kill_recovers_bit_exact(served_model,
                                                   baseline_tokens, seed):
    """Chaos on the async path: a seeded device kill under the EVENT loop
    (failover sweep runs on control ticks, not fleet rounds) still recovers
    every in-flight request bit-exact to the fault-free run."""
    cfg, model, params = served_model
    inj = FaultInjector(seed=seed)
    inj.plan_device_kill(["dev-0-0", "dev-1-0", "dev-2-0"], lo=2, hi=6)
    tokens, reqs, hv, fleet = _run_workload(cfg, model, params,
                                            injector=inj, loop="event")
    kills = [e for e in inj.log if e["kind"] == "kill_device"]
    assert len(kills) == 1
    assert hv.db.devices[kills[0]["target"]].state == DeviceState.DEAD
    assert fleet.recoveries and fleet.recoveries[0]["resumed"] == 4
    assert tokens == baseline_tokens
    fleet.close()


# ---------------------------------------------------------------------------
# Acceptance: seeded device kill mid-decode -> bit-exact recovery
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
def test_device_kill_mid_decode_recovers_bit_exact(served_model,
                                                   baseline_tokens, seed):
    """A seeded FaultInjector kills one of the 3 active devices mid-decode
    (step and victim drawn from the seed). Every in-flight request must
    complete with tokens bit-exact to the fault-free run, and page/quota
    conservation must hold after every step."""
    cfg, model, params = served_model
    inj = FaultInjector(seed=seed)
    inj.plan_device_kill(["dev-0-0", "dev-1-0", "dev-2-0"], lo=2, hi=6)
    tokens, reqs, hv, fleet = _run_workload(cfg, model, params, injector=inj)

    kills = [e for e in inj.log if e["kind"] == "kill_device"]
    assert len(kills) == 1
    dead = kills[0]["target"]
    assert hv.db.devices[dead].state == DeviceState.DEAD
    # all 4 of the dead device's requests were mid-flight and resumed from
    # the journal — no live source engine existed to drain
    assert fleet.recoveries and fleet.recoveries[0]["device"] == dead
    assert fleet.recoveries[0]["resumed"] == 4
    assert not fleet.recoveries[0]["evicted"]
    # the spare PARKED device was woken to absorb the orphans (no other
    # device had 2 free slots)
    assert hv.db.devices["dev-3-0"].state == DeviceState.ACTIVE
    assert tokens == baseline_tokens
    fleet.close()


@pytest.mark.parametrize("seed", SEEDS[:2])
def test_node_kill_detected_by_heartbeat_deadline(served_model,
                                                  baseline_tokens, seed):
    """A node crash is only visible through silence: its engine freezes
    immediately, the monitor declares it dead one heartbeat deadline
    later, and recovery still lands bit-exact."""
    cfg, model, params = served_model
    inj = FaultInjector(seed=seed)
    ev = inj.plan_node_kill(["node-0", "node-1", "node-2"], lo=2, hi=5)
    tokens, reqs, hv, fleet = _run_workload(cfg, model, params, injector=inj)

    dead_events = [e for e in hv.monitor.events if e["kind"] == "node_dead"]
    assert len(dead_events) == 1 and dead_events[0]["node"] == ev.target
    # detection latency: the deadline runs from the node's LAST heartbeat
    # (clock == ev.step, one tick before the kill fires at ev.step + 1) —
    # death is declared only after it expires, never at the kill instant
    assert dead_events[0]["t"] - ev.step >= 2.5
    assert dead_events[0]["t"] > ev.step + 1
    assert not hv.db.nodes[ev.target].alive
    assert fleet.recoveries and fleet.recoveries[0]["resumed"] == 4
    assert tokens == baseline_tokens
    fleet.close()


def test_transient_partition_needs_no_recovery(served_model,
                                               baseline_tokens):
    """A partition shorter than the heartbeat deadline is survivable: the
    device kept decoding the whole time, so nothing must be declared dead
    and no recovery may fire."""
    cfg, model, params = served_model
    inj = FaultInjector(seed=0)
    inj.partition_node_at(1, "node-0")
    inj.heal_node_at(3, "node-0")        # silent for 2 ticks < 2.5 deadline
    tokens, reqs, hv, fleet = _run_workload(cfg, model, params, injector=inj)
    assert not [e for e in hv.monitor.events if e["kind"] == "node_dead"]
    assert not fleet.recoveries
    assert all(d.state != DeviceState.DEAD for d in hv.db.devices.values())
    assert tokens == baseline_tokens
    fleet.close()


# ---------------------------------------------------------------------------
# Degrade / evict paths (failover under capacity pressure)
# ---------------------------------------------------------------------------

def test_failover_degrades_slots_when_survivors_are_smaller(served_model):
    """A dead 4-slot tenant lands on a survivor with only 2 free slots:
    placement degrades 4 -> 2, the admission slot quota hands back the
    difference, and the requests still finish."""
    cfg, model, params = served_model
    inj = FaultInjector(seed=0)
    hv, fleet = _build_fleet(model, params, injector=inj, n_nodes=2)
    fleet.open_session("big", slots=4, service_model="rsaas")   # fills dev-0
    fleet.open_session("b1", slots=1)                           # dev-1
    fleet.open_session("b2", slots=1)                           # dev-1
    assert fleet.device_of("big") != fleet.device_of("b1")
    reqs = [fleet.submit("big", _prompt(cfg, 6, seed=i), max_new_tokens=6)
            for i in range(2)]
    other = fleet.submit("b1", _prompt(cfg, 6, seed=9), max_new_tokens=6)
    for _ in range(2):
        fleet.step()
        fleet.verify_invariants()
    inj.kill_device_at(2, fleet.device_of("big"))
    for _ in range(60):
        fleet.step()
        fleet.verify_invariants()
        if all(r.done.is_set() for r in reqs) and other.done.is_set():
            break
    assert fleet.session("big").slots == 2                      # degraded
    assert hv.admission.usage("big", "rsaas")["slots"] == 2
    assert all(len(r.out_tokens) == 6 for r in reqs)
    assert len(other.out_tokens) == 6
    places = [e for e in hv.log if e["kind"] == "failover_place"]
    assert places and places[0]["degraded"] is True
    fleet.close()


def test_failover_degrade_shrinks_page_grant(served_model):
    """Regression: on a page-METERED cluster, each degrade step must ask
    for the page grant matching ITS slot count. A 4-slot tenant whose
    device dies lands as a 2-slot slice with the 2-slot grant — neither
    evicted because the 4-slot grant can't fit, nor over-reserving the
    full grant after the degrade."""
    cfg, model, params = served_model
    inj = FaultInjector(seed=0)
    hv = Hypervisor(ClusterSpec(n_nodes=2, devices_per_node=1,
                                cache_pages_per_device=16),
                    MonitorConfig(heartbeat_interval_s=1.0,
                                  heartbeat_deadline_s=2.5),
                    clock=inj.clock, device="cpu")
    fleet = GatewayFleet(hv, model, params, n_slots=4, max_len=64,
                         paged=True, cache_pages=17, faults=inj)
    fleet.open_session("big", slots=4, service_model="rsaas")  # grant 16
    fleet.open_session("b1", slots=1)                          # grant 4
    fleet.open_session("b2", slots=1)                          # grant 4
    assert fleet.device_of("big") != fleet.device_of("b1")
    reqs = [fleet.submit("big", _prompt(cfg, 6, seed=i), max_new_tokens=6)
            for i in range(2)]
    for _ in range(2):
        fleet.step()
        fleet.verify_invariants()
    inj.kill_device_at(2, fleet.device_of("big"))
    for _ in range(60):
        fleet.step()
        fleet.verify_invariants()
        if all(r.done.is_set() for r in reqs):
            break
    # survivor device had 2 free slots and 8 free grant pages: 4 slots /
    # 16 pages could never fit, 2 slots with ITS 8-page grant does
    assert not fleet.recoveries[0]["evicted"]
    assert fleet.session("big").slots == 2
    vs = hv.db.find_slice(fleet.session("big").slice_id)
    assert vs.cache_pages == 8
    dev = hv.db.devices[vs.device_id]
    assert dev.granted_cache_pages() <= dev.cache_pages
    assert all(len(r.out_tokens) == 6 for r in reqs)
    fleet.close()


def test_cancel_after_device_failure_before_sweep(served_model):
    """Regression: an external ``Hypervisor.mark_device_failed`` between
    fleet steps leaves the dead engine registered until the next sweep;
    a client cancel arriving in that window must recover first and settle
    exactly once — not settle against the slice that died with the device
    (KeyError + leaked in-flight quota)."""
    cfg, model, params = served_model
    hv, fleet = _build_fleet(model, params, n_nodes=2)
    fleet.open_session("a", slots=2)
    victim = fleet.submit("a", _prompt(cfg, 6, seed=1), max_new_tokens=10)
    other = fleet.submit("a", _prompt(cfg, 6, seed=2), max_new_tokens=10)
    for _ in range(2):
        fleet.step()
    hv.mark_device_failed(fleet.device_of("a"), reason="status_error")
    assert fleet.cancel(victim) is True
    assert victim.finish_reason == "cancelled"
    assert fleet.recoveries and fleet.recoveries[0]["device"] == "dev-0-0"
    assert hv.admission.usage("a")["inflight"] == 1          # other only
    fleet.verify_invariants()
    for _ in range(60):
        fleet.step()
        fleet.verify_invariants()
        if other.done.is_set():
            break
    assert other.finish_reason == "length"
    assert hv.admission.usage("a")["inflight"] == 0
    assert fleet.session("a").served == 2
    fleet.close()


def test_no_capacity_eviction_settles_quota_once(served_model):
    """When a dead device's tenants fit NOWHERE (cluster full), they are
    evicted: requests cancelled, slot + in-flight quota settled exactly
    once, and the surviving tenants drain untouched."""
    cfg, model, params = served_model
    inj = FaultInjector(seed=0)
    hv, fleet = _build_fleet(model, params, injector=inj, n_nodes=2)
    for t in ("a0", "a1", "b0", "b1"):                # 4 x 2 slots: full
        fleet.open_session(t, slots=2)
    dead_dev = fleet.device_of("a0")
    victims = [t for t in ("a0", "a1", "b0", "b1")
               if fleet.device_of(t) == dead_dev]
    survivors = [t for t in ("a0", "a1", "b0", "b1") if t not in victims]
    reqs = {t: fleet.submit(t, _prompt(cfg, 6, seed=ord(t[0]) + int(t[1])),
                            max_new_tokens=6)
            for t in ("a0", "a1", "b0", "b1")}
    for _ in range(2):
        fleet.step()
        fleet.verify_invariants()
    inj.kill_device_at(2, dead_dev)
    for _ in range(60):
        fleet.step()
        fleet.verify_invariants()
        if all(r.done.is_set() for r in reqs.values()):
            break
    assert sorted(fleet.recoveries[0]["evicted"]) == sorted(victims)
    for t in victims:
        assert reqs[t].finish_reason == "cancelled"
        assert hv.admission.usage(t)["inflight"] == 0
        assert hv.admission.usage(t)["slots"] == 0
        assert t not in fleet._sessions
    for t in survivors:
        assert reqs[t].finish_reason == "length"
        assert len(reqs[t].out_tokens) == 6
    fleet.close()


# ---------------------------------------------------------------------------
# Hand-off fault paths
# ---------------------------------------------------------------------------

def test_page_copy_failure_falls_back_to_replay(served_model):
    """Every hand-off page copy fails (interconnect loss): migration must
    fall back to prompt-prefix replay, and the tokens still match an
    unmigrated run."""
    cfg, model, params = served_model
    prompt = _prompt(cfg, 20, seed=5)
    inj = FaultInjector(seed=0, page_copy_fail_rate=1.0)
    hv, fleet = _build_fleet(model, params, injector=inj, n_nodes=2)
    fleet.open_session("a", slots=2)
    req = fleet.submit("a", prompt, max_new_tokens=12)
    for _ in range(3):
        fleet.step()
    target = next(d for d in hv.db.devices if d != fleet.device_of("a"))
    assert hv.migrate_slice(fleet.session("a").slice_id,
                            target_device=target) is not None
    assert fleet.handoffs[-1]["page_copied"] == 0
    assert fleet.handoffs[-1]["moved_requests"] == 1
    assert [e for e in inj.log if e["kind"] == "page_copy_fail"]
    for _ in range(60):
        fleet.step()
        fleet.verify_invariants()
        if req.done.is_set():
            break
    fleet.close()

    hv2, fleet2 = _build_fleet(model, params, n_nodes=1)
    fleet2.open_session("a", slots=2)
    ref = fleet2.submit("a", prompt, max_new_tokens=12)
    assert fleet2.run_until_idle() is True
    assert req.out_tokens == ref.out_tokens
    fleet2.close()


def test_cancel_racing_handoff_settles_exactly_once(served_model,
                                                    monkeypatch):
    """Regression (satellite): a request cancelled BETWEEN page export and
    resume — drained from the source, held by no engine — must settle its
    quota and free its pages exactly once, and must not be resumed on the
    target by the in-progress hand-off."""
    cfg, model, params = served_model
    hv, fleet = _build_fleet(model, params, n_nodes=2)
    fleet.open_session("a", slots=2)
    victim = fleet.submit("a", _prompt(cfg, 20, seed=1), max_new_tokens=12)
    bystander = fleet.submit("a", _prompt(cfg, 6, seed=2), max_new_tokens=6)
    for _ in range(3):
        fleet.step()
    assert not victim.done.is_set()
    assert hv.admission.usage("a")["inflight"] == 2

    orig = BatchingEngine.drain_tenant

    def drain_and_cancel(self, tenant):
        moved = orig(self, tenant)
        # the client's cancel lands in the hand-off window: pages already
        # exported and freed by the drain, resume not yet issued
        assert fleet.cancel(victim) is True
        return moved

    monkeypatch.setattr(BatchingEngine, "drain_tenant", drain_and_cancel)
    target = next(d for d in hv.db.devices if d != fleet.device_of("a"))
    assert hv.migrate_slice(fleet.session("a").slice_id,
                            target_device=target) is not None
    monkeypatch.undo()

    assert victim.finish_reason == "cancelled"
    assert victim.request_id not in fleet.journal
    # not resumed anywhere: no engine queues or decodes it
    for eng in fleet._engines.values():
        assert victim not in eng.inflight()
        assert all(victim.request_id != r.request_id
                   for q in eng._queues.values() for r in q)
    assert hv.admission.usage("a")["inflight"] == 1      # bystander only
    assert fleet.cancel(victim) is False                 # second cancel no-ops
    for _ in range(60):
        fleet.step()
        fleet.verify_invariants()
        if bystander.done.is_set():
            break
    assert bystander.finish_reason == "length"
    assert hv.admission.usage("a")["inflight"] == 0
    assert fleet.session("a").served == 2                # victim + bystander
    for eng in fleet._engines.values():
        eng.pool.verify()
        assert eng.pool.used_pages == 0
    fleet.close()


# ---------------------------------------------------------------------------
# Parity with the JAX package's fleet
# ---------------------------------------------------------------------------

def test_device_kill_matches_reference(jax_model, served_model):
    """Seed 0's device kill through the JAX package's fleet and the port's:
    the same victim and step, the same recoveries, the same token logs."""
    jmodel, jparams = jax_model
    cfg, model, params = served_model
    runs = {}
    for side, (fi, m, p) in (("ref", (JFaultInjector, jmodel, jparams)),
                             ("port", (FaultInjector, model, params))):
        inj = fi(seed=0)
        inj.plan_device_kill(["dev-0-0", "dev-1-0", "dev-2-0"], lo=2, hi=6)
        tokens, reqs, hv, fleet = _run_workload(cfg, m, p, injector=inj,
                                                ref=side == "ref")
        runs[side] = dict(tokens=tokens, recoveries=fleet.recoveries,
                          faults=inj.log,
                          prompts=[list(r.prompt) for r in reqs.values()])
        fleet.close()
    ref, got = runs["ref"], runs["port"]
    assert_margins(jmodel, jparams, ref["prompts"],
                   list(ref["tokens"].values()), 64)
    assert ref["recoveries"] and ref["recoveries"][0]["resumed"] == 4
    assert got["faults"] == ref["faults"]
    assert got["recoveries"] == ref["recoveries"]
    assert got["tokens"] == ref["tokens"]
