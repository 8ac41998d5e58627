"""The reference's event-driven dataplane tests (``tests/test_events.py``)
on the port (``repro_torch.runtime.events``), on the CPU: the deterministic
event queue (stable (time, seq) tie-breaking, clock ownership),
chunked-prefill parity with the synchronous engine, lockstep-vs-event fleet
token exactness on a mixed-speed fleet, the batched-journal flush barrier,
overlapped live hand-off (source keeps decoding during the page copy), and
the satellite regressions (autoscale ignores draining backlog; dead-device
traffic windows are swept). Every test of the reference file with the same
assertions, on ``Hypervisor(device="cpu")`` and ``Model(device="cpu")``,
under the port's lifecycle sanitizer.

Weights: reduced smollm-135m in fp32, the JAX init carried across
(``params_from_numpy``).
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.models import get_model as j_get_model
from repro_torch.analysis import sanitizer
from repro_torch.configs import get_config, reduced
from repro_torch.core import (ClusterSpec, DeviceState, Hypervisor,
                              MonitorConfig)
from repro_torch.interop import params_from_numpy
from repro_torch.models import Model
from repro_torch.runtime import BatchingEngine, EventLoop, GatewayFleet
from repro_torch.runtime.events import EventQueue
from repro_torch.runtime.faults import FakeClock

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _sanitized():
    sanitizer.reset()
    sanitizer.enable()
    yield
    sanitizer.disable()


@pytest.fixture(scope="module")
def served_model():
    jcfg = j_reduced(j_get_config("smollm-135m")).replace(dtype="float32")
    jparams = j_get_model(jcfg).init(jax.random.PRNGKey(0))
    cfg = reduced(get_config("smollm-135m")).replace(dtype="float32")
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg)
    return cfg, Model(cfg, device="cpu"), params


def _prompt(cfg, n=6, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, size=n).tolist()


# ---------------------------------------------------------------------------
# EventQueue: ordering, clock ownership, cancellation
# ---------------------------------------------------------------------------

def test_event_queue_orders_by_time_then_schedule():
    """Equal-time events fire strictly in schedule order — firing order is
    a pure function of the schedule, never of heap internals."""
    q = EventQueue()
    fired = []
    q.at(2.0, lambda: fired.append("late"))
    q.at(1.0, lambda: fired.append("a"))
    q.at(1.0, lambda: fired.append("b"))
    q.after(0.0, lambda: fired.append("now"))
    while q.step() is not None:
        pass
    assert fired == ["now", "a", "b", "late"]
    assert q.clock() == 2.0 and q.fired == 4


def test_event_queue_owns_the_clock():
    """Popping an event advances the shared clock to its time; scheduling
    in the past clamps to now (the past is not schedulable)."""
    clock = FakeClock()
    clock.t = 10.0
    q = EventQueue(clock)
    ev = q.at(3.0, lambda: None)
    assert ev.time == 10.0                      # clamped to now
    q.at(12.5, lambda: None)
    q.run()
    assert clock() == 12.5


def test_event_queue_cancellation_is_lazy_and_invisible():
    """Cancelled events are skipped at pop time without perturbing the
    ordering (or the clock advancement) of live events."""
    q = EventQueue()
    fired = []
    keep = q.at(1.0, lambda: fired.append("keep"))
    drop = q.at(0.5, lambda: fired.append("drop"))
    q.cancel(drop)
    assert len(q) == 1 and q.peek() is keep
    q.run()
    assert fired == ["keep"] and q.clock() == 1.0


def test_event_queue_run_until_leaves_clock_at_horizon():
    q = EventQueue()
    fired = []
    q.at(1.0, lambda: fired.append(1))
    q.at(5.0, lambda: fired.append(5))
    assert q.run(until=3.0) == 1
    assert fired == [1] and q.clock() == 3.0    # horizon, not last event
    q.run()
    assert fired == [1, 5]


def test_event_queue_firing_order_deterministic():
    def one_run():
        order = []
        q = EventQueue()
        for i, t in enumerate([2.0, 1.0, 1.0, 0.5, 2.0, 1.0]):
            q.at(t, lambda i=i: order.append(i), kind=f"e{i}")
        q.run()
        return order
    assert one_run() == one_run()


# ---------------------------------------------------------------------------
# Chunked prefill: step_async is token-exact with the sync engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("paged", [False, True],
                         ids=["dense", "paged"])
def test_chunked_prefill_matches_sync_engine(served_model, paged):
    """step_async (chunked prefill interleaved with decode) must produce
    bit-identical token streams to the synchronous engine — including on
    recycled KV pages, where stale position metadata once leaked previous
    occupants' K/V into attention."""
    cfg, model, params = served_model

    def run(mode):
        sanitizer.reset()
        eng = BatchingEngine(model, params, n_slots=4, max_len=64,
                             paged=paged)
        reqs = [eng.submit(_prompt(cfg, 5 + i % 3, seed=100 + i), 8,
                           tenant=f"t{i % 2}") for i in range(6)]
        for _ in range(400):
            eng.step() if mode == "sync" else eng.step_async(prefill_chunk=4)
            if all(r.done.is_set() for r in reqs):
                break
        assert all(r.done.is_set() for r in reqs)
        return [list(r.out_tokens) for r in reqs]

    assert run("sync") == run("async")


# ---------------------------------------------------------------------------
# EventLoop: fleet-level parity, cadence, flush barrier, overlapped hand-off
# ---------------------------------------------------------------------------

def _mixed_fleet(model, params, speeds=(1.0, 1.0, 1.0, 0.25), **kw):
    hv = Hypervisor(ClusterSpec(n_nodes=len(speeds), devices_per_node=1,
                                device_speeds=tuple(speeds)),
                    MonitorConfig(heartbeat_interval_s=1.0,
                                  heartbeat_deadline_s=2.5),
                    clock=FakeClock(), device="cpu")
    fleet = GatewayFleet(hv, model, params, n_slots=4, max_len=64, **kw)
    return hv, fleet


def test_event_loop_matches_lockstep_on_mixed_speeds(served_model):
    """Device speed changes the event SCHEDULE, never the tokens: a fleet
    with a 4x-slower device produces the same per-request streams under
    the event loop as under the lockstep barrier."""
    cfg, model, params = served_model

    def run(loop):
        sanitizer.reset()
        hv, fleet = _mixed_fleet(model, params, paged=True)
        reqs = {}
        for ti in range(4):
            fleet.open_session(f"t{ti}", slots=4, service_model="rsaas")
            for k in range(2):
                reqs[(ti, k)] = fleet.submit(
                    f"t{ti}", _prompt(cfg, 5 + ti, seed=10 * ti + k),
                    max_new_tokens=8)
        ev = EventLoop(fleet) if loop == "event" else None
        for _ in range(400):
            fleet.step() if ev is None else ev.run_ticks(1)
            fleet.verify_invariants()
            if all(r.done.is_set() for r in reqs.values()):
                break
        assert all(r.done.is_set() for r in reqs.values())
        toks = {k: list(r.out_tokens) for k, r in reqs.items()}
        fleet.close()
        return toks

    assert run("lockstep") == run("event")


def test_slow_device_steps_on_its_own_cadence(served_model):
    """Four always-busy engines under the event loop: each device fires
    ~speed x ticks engine events — the slow class runs at quarter rate
    WITHOUT gating the rest (fast devices still step every tick)."""
    cfg, model, params = served_model
    speeds = {"dev-0-0": 1.0, "dev-1-0": 1.0, "dev-2-0": 1.0,
              "dev-3-0": 0.25}
    hv, fleet = _mixed_fleet(model, params)
    reqs = []
    for ti in range(4):
        fleet.open_session(f"t{ti}", slots=4, service_model="rsaas")
        reqs.append(fleet.submit(f"t{ti}", _prompt(cfg, 7, seed=ti),
                                 max_new_tokens=40))
    assert len(fleet._engines) == 4             # one tenant per device
    ev = EventLoop(fleet)
    ticks = 24
    ev.run_ticks(ticks)
    for dev, eng in fleet._engines.items():
        assert abs(eng.steps / ticks - speeds[dev]) <= 0.2, \
            f"{dev}: {eng.steps} steps in {ticks} ticks"
    assert ev.run_until_idle(max_ticks=2000)
    assert all(r.done.is_set() for r in reqs)
    fleet.close()


def test_journal_flush_barrier(served_model):
    """Lazy journal mode: engine steps only MARK entries dirty — the token
    copy happens on the loop's flush cadence, and the retire path forces a
    per-request flush so a settled entry is never stale."""
    cfg, model, params = served_model
    hv, fleet = _mixed_fleet(model, params, speeds=(1.0,))
    fleet.open_session("t", slots=2)
    req = fleet.submit("t", _prompt(cfg, 5), max_new_tokens=12)
    ev = EventLoop(fleet, flush_every=10_000)   # periodic flush never fires
    ev.run_ticks(6)
    entry = fleet.journal[req.request_id]
    assert req.out_tokens                        # decode made progress...
    assert entry.tokens == []                    # ...but the copy is batched
    assert req.request_id in fleet._dirty
    fleet.flush_journal()
    assert entry.tokens == list(req.out_tokens) and not fleet._dirty
    assert ev.run_until_idle()
    # the finish settle flushed-then-retired: no dirty orphan, quota clean
    assert req.request_id not in fleet.journal
    assert req.request_id not in fleet._dirty
    assert hv.admission.usage("t")["inflight"] == 0
    fleet.close()


def test_overlapped_handoff_source_decodes_during_copy(served_model):
    """A directed migration under the event loop exports the snapshot
    immediately but keeps decoding on the source for the copy window;
    adoption catches up the mid-copy tokens and the final streams are
    bit-exact with an unmigrated run."""
    cfg, model, params = served_model

    def run(migrate):
        sanitizer.reset()
        hv, fleet = _mixed_fleet(model, params, speeds=(1.0, 1.0),
                                 paged=True)
        sess = fleet.open_session("t", slots=2)
        reqs = [fleet.submit("t", _prompt(cfg, 5 + i, seed=i),
                             max_new_tokens=24) for i in range(3)]
        ev = EventLoop(fleet, copy_ticks=2)
        ev.run_ticks(4)
        if migrate:
            src = fleet.device_of("t")
            dst = next(d for d in sorted(hv.db.devices) if d != src)
            before = [len(r.out_tokens) for r in reqs]
            hv.migrate_slice(sess.slice_id, target_device=dst,
                             reason="ops")
            assert fleet._inflight_handoffs     # copy is in flight...
            ev.run_ticks(1)                     # ...and the source still
            after = [len(r.out_tokens) for r in reqs]       # decodes
            assert sum(after) > sum(before)
        assert ev.run_until_idle()
        assert all(r.done.is_set() for r in reqs)
        if migrate:
            ho = fleet.handoffs[-1]
            assert ho["overlapped"] is True and ho["moved_requests"] > 0
            assert fleet.device_of("t") == dst
            assert not fleet._inflight_handoffs and not fleet._draining
        toks = [list(r.out_tokens) for r in reqs]
        fleet.close()
        return toks

    assert run(migrate=True) == run(migrate=False)


# ---------------------------------------------------------------------------
# Satellite regressions
# ---------------------------------------------------------------------------

def test_autoscale_ignores_draining_device_backlog(served_model):
    """Backlog queued on a hand-off source mid-copy is already on its way
    elsewhere: counting it would wake a device for traffic that is about
    to move (the wake/park flap). Once the copy completes, the same
    backlog counts again."""
    cfg, model, params = served_model
    hv = Hypervisor(ClusterSpec(n_nodes=1, devices_per_node=2),
                    device="cpu")
    fleet = GatewayFleet(hv, model, params, n_slots=1, max_len=64,
                         scale_up_queue_depth=3)
    fleet.open_session("t", slots=1)
    dev = fleet.device_of("t")
    for i in range(6):                          # deep backlog: 5 queued
        fleet.submit("t", _prompt(cfg, seed=i), max_new_tokens=4)
    assert hv.db.devices["dev-0-1"].state == DeviceState.PARKED

    fleet._handoff_begun(dev)                   # source mid-copy: draining
    assert fleet.autoscale() is None
    assert hv.db.devices["dev-0-1"].state == DeviceState.PARKED
    assert not fleet.autoscale_log

    fleet._handoff_done(dev)                    # copy done: backlog counts
    assert fleet.autoscale() == "dev-0-1"
    assert fleet.autoscale_log[-1]["signal"] == "queue_depth"
    fleet.run_until_idle()
    fleet.close()


def test_dead_device_sweep_clears_traffic_windows():
    """Per-device traffic windows must die with the device: the heartbeat
    sweep drops the dead node's device samples (so churn can never grow
    the windows) while survivors keep theirs."""
    clock = FakeClock()
    hv = Hypervisor(ClusterSpec(n_nodes=2, devices_per_node=1),
                    MonitorConfig(heartbeat_interval_s=1.0,
                                  heartbeat_deadline_s=2.5),
                    clock=clock, device="cpu")
    mon = hv.monitor
    mon.record_traffic(4, 3, 2, by_device={"dev-0-0": 2, "dev-1-0": 1})
    assert mon.device_completion_rate("dev-1-0") is not None
    clock.t = 3.0                               # node-1 misses its deadline
    mon.heartbeat("node-0")
    mon.check_heartbeats()
    assert not hv.db.nodes["node-1"].alive
    assert mon.device_completion_rate("dev-1-0") is None
    assert mon.device_completion_rate("dev-0-0") is not None


def _mid_prefill_run(hv, fleet_cls, loop_cls, model, params, cfg, migrate):
    """One tenant's 40-token prompt on a two-device fleet under the event
    loop (prefill chunk 4: 10 chunk events); with ``migrate`` the tenant
    moves to the other device two ticks in, while the request is still in
    chunked prefill (an overlapped hand-off that snapshots its pages)."""
    fleet = fleet_cls(hv, model, params, n_slots=2, max_len=128, paged=True,
                      page_size=16)
    ev = loop_cls(fleet)
    sess = fleet.open_session("t", slots=1)
    req = fleet.submit("t", _prompt(cfg, n=40, seed=3), max_new_tokens=6)
    src = fleet.device_of("t")
    for tick in range(400):
        if migrate and tick == 2:
            assert not req.out_tokens            # still prefilling
            dst = next(d for d in sorted(hv.db.devices) if d != src)
            hv.migrate_slice(sess.slice_id, target_device=dst, reason="ops")
        ev.run_ticks(1)
        if req.done.is_set() and not fleet._inflight_handoffs:
            break
    assert req.done.is_set()
    handoffs = list(fleet.handoffs)
    fleet.close()
    return list(req.out_tokens), handoffs


def test_overlapped_handoff_mid_prefill_mirrors_reference(served_model):
    """An overlapped hand-off of a request still in chunked prefill adopts
    the snapshot's pages on the target (one page copied), and the stream
    then differs from the unmigrated run's: a fault of the reference
    (``src/repro/runtime/events.py``, ``_begin_handoff`` exports the pages
    of a request whose prefill has not completed), recorded in ROADMAP
    Queue 3 and mirrored here, not fixed: the port's log equals the
    reference's, migrated and not."""
    from repro.core import ClusterSpec as JClusterSpec
    from repro.core import Hypervisor as JHypervisor
    from repro.runtime import EventLoop as JEventLoop
    from repro.runtime import GatewayFleet as JGatewayFleet
    cfg, model, params = served_model
    jcfg = j_reduced(j_get_config("smollm-135m")).replace(dtype="float32")
    jmodel = j_get_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    logs = {}
    for migrate in (False, True):
        got, handoffs = _mid_prefill_run(
            Hypervisor(ClusterSpec(n_nodes=1, devices_per_node=2),
                       device="cpu"), GatewayFleet, EventLoop, model,
            params, cfg, migrate)
        want, jhandoffs = _mid_prefill_run(
            JHypervisor(JClusterSpec(n_nodes=1, devices_per_node=2)),
            JGatewayFleet, JEventLoop, jmodel, jparams, cfg, migrate)
        assert got == want
        assert [(h["page_copied"], h["replayed_inflight"]) for h in handoffs] \
            == [(h["page_copied"], h["replayed_inflight"])
                for h in jhandoffs] == ([(1, 0)] if migrate else [])
        logs[migrate] = want
    assert logs[True] != logs[False]        # the reference's fault
