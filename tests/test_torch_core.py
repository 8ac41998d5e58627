"""Port control plane against the JAX package: the cases of tests/test_core.py,
tests/test_scheduler.py and the non-training drills of
tests/test_fault_tolerance.py.

Each case is written once as a scenario over a package (``repro`` or
``repro_torch``) and run on both under the same fake clock; the records must
be equal: the hypervisor ``log`` (without ``fingerprint``, a hash of the
core's source, and the wall-clock ``seconds``), ``status()``, the device
DB's JSON (slice ``program`` fingerprints masked), the scheduler's history
and admission usage. Array outputs are compared at atol/rtol 1e-5 (float32
products of at most 16 terms). The port's hypervisor runs with
``device="cpu"``.
"""
import json
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import repro.core as jcore
import repro.rc2f as jrc2f
import repro_torch.core as tcore
import repro_torch.rc2f as trc2f

torch.set_num_threads(1)

JAX = SimpleNamespace(name="jax", core=jcore, rc2f=jrc2f, xp=jnp,
                      kw={})
TORCH = SimpleNamespace(name="torch", core=tcore, rc2f=trc2f, xp=torch,
                        kw={"device": "cpu"})
BOTH = (JAX, TORCH)


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _hv(pkg, spec=None, monitor_cfg=None, clock=None):
    clock = clock if clock is not None else FakeClock()
    return pkg.core.Hypervisor(spec, monitor_cfg, clock=clock, **pkg.kw)


def _rc(pkg, max_entries=None):
    return pkg.core.Reconfigurator(pkg.core.ProgramCache(max_entries),
                                   **pkg.kw)


def _db_json(db):
    blob = json.loads(db.to_json())
    for dev in blob["devices"].values():
        for sl in dev["slices"].values():
            if sl.get("program"):
                sl["program"] = "<fingerprint>"
    return blob


def _record(hv, tenants=()):
    """What must agree between the packages after a scenario."""
    return dict(
        log=[{k: v for k, v in e.items() if k not in ("fingerprint",
                                                      "seconds")}
             for e in hv.log],
        status=hv.status(),
        db=_db_json(hv.db),
        history=hv.scheduler.history,
        usage={t: hv.admission.usage(t) for t in tenants})


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def _same(scenario, *args):
    """Run ``scenario`` on both packages; compare the records."""
    j, t = (scenario(pkg, *args) for pkg in BOTH)
    assert j.keys() == t.keys()
    for key in j:
        if key.startswith("out"):
            jo, to = j[key], t[key]
            assert len(jo) == len(to)
            for a, b in zip(jo, to):
                np.testing.assert_allclose(_np(b), _np(a), atol=1e-5,
                                           rtol=1e-5)
        else:
            assert t[key] == j[key], key
    return j


def make_db(pkg, nodes=2, devs=2):
    db = pkg.core.DeviceDB()
    for ni in range(nodes):
        db.add_node(f"n{ni}")
        for di in range(devs):
            db.add_device(f"d{ni}-{di}", f"n{ni}")
    return db


def _mm_core(a, b):
    return (a @ b,)


# ---------------------------------------------------------------------------
# Device DB (tests/test_core.py)
# ---------------------------------------------------------------------------

@settings(max_examples=60, deadline=None)
@given(st.lists(st.one_of(
    st.tuples(st.just("alloc"), st.sampled_from([1, 2, 4])),
    st.tuples(st.just("release"), st.integers(0, 30)),
), min_size=1, max_size=40))
def test_device_db_slot_invariants(ops):
    dbs = [make_db(pkg) for pkg in BOTH]
    live = []
    for op, arg in ops:
        if op == "alloc":
            got = []
            for pkg, db in zip(BOTH, dbs):
                try:
                    got.append(db.allocate_slice("u", arg, "raas").slice_id)
                except pkg.core.NoCapacityError:
                    got.append(None)
                    assert all(d.free_slots() < arg
                               for d in db.devices.values()
                               if d.state.value != "exclusive")
            assert got[0] == got[1]
            if got[1] is not None:
                live.append(got[1])
        elif live:
            sid = live.pop(arg % len(live))
            for db in dbs:
                db.release(sid)
        assert _db_json(dbs[0]) == _db_json(dbs[1])
        for d in dbs[1].devices.values():
            assert 0 <= d.used_slots() <= tcore.MAX_SLOTS
            if not d.slices:
                assert d.state in (tcore.DeviceState.PARKED,
                                   tcore.DeviceState.DEAD,
                                   tcore.DeviceState.EXCLUSIVE)


def _pack_first(pkg):
    db = make_db(pkg)
    a = db.allocate_slice("u1", 1, "raas")
    b = db.allocate_slice("u2", 1, "raas")
    assert a.device_id == b.device_id
    c = db.allocate_slice("u3", 4, "raas")
    assert c.device_id != a.device_id
    return dict(db=_db_json(db))


def test_pack_first_placement():
    _same(_pack_first)


def _exclusive(pkg):
    db = make_db(pkg, nodes=1, devs=1)
    db.allocate_exclusive("owner")
    with pytest.raises(pkg.core.NoCapacityError):
        db.allocate_slice("other", 1, "raas")
    return dict(db=_db_json(db))


def test_exclusive_excludes_vslices():
    _same(_exclusive)


def _roundtrip(pkg):
    db = make_db(pkg)
    db.allocate_slice("u", 2, "raas")
    db2 = pkg.core.DeviceDB.from_json(db.to_json())
    assert db2.utilization() == db.utilization()
    assert set(db2.devices) == set(db.devices)
    return dict(db=_db_json(db), db2=_db_json(db2))


def test_db_json_roundtrip():
    _same(_roundtrip)


def _node_failure(pkg):
    db = make_db(pkg)
    vs = db.allocate_slice("u", 2, "raas")
    orphans = db.mark_node_dead(db.devices[vs.device_id].node_id)
    assert [o.slice_id for o in orphans] == [vs.slice_id]
    assert db.devices[vs.device_id].state == pkg.core.DeviceState.DEAD
    vs2 = db.allocate_slice("u", 2, "raas")
    assert db.devices[vs2.device_id].node_id != \
        db.devices[vs.device_id].node_id
    return dict(db=_db_json(db))


def test_node_failure_orphans_and_parks():
    _same(_node_failure)


# ---------------------------------------------------------------------------
# Scheduler through the hypervisor (tests/test_core.py)
# ---------------------------------------------------------------------------

def _priority_capacity(pkg):
    hv = _hv(pkg, pkg.core.ClusterSpec(n_nodes=1, devices_per_node=1))
    ran = []
    hv.scheduler.submit("a", 4, run=lambda s: ran.append("low"), priority=20)
    hv.scheduler.submit("b", 4, run=lambda s: ran.append("high"), priority=1)
    hv.scheduler.run_pending()
    assert ran[0] == "high"
    hv.scheduler.run_pending()
    assert ran == ["high", "low"]
    return dict(_record(hv), ran=ran)


def test_scheduler_priority_and_capacity():
    _same(_priority_capacity)


def _backfill(pkg):
    hv = _hv(pkg, pkg.core.ClusterSpec(n_nodes=1, devices_per_node=1))
    hv.db.allocate_slice("blocker", 2, "raas")
    big = hv.scheduler.submit("a", 4, run=lambda s: "big")
    small = hv.scheduler.submit("b", 2, run=lambda s: "small")
    hv.scheduler.run_pending()
    assert small.state == pkg.core.JobState.DONE
    assert big.state in (pkg.core.JobState.QUEUED, pkg.core.JobState.REQUEUED)
    return dict(_record(hv), states=[big.state.value, small.state.value])


def test_scheduler_smaller_job_backfills():
    _same(_backfill)


def _requeue_then_fail(pkg):
    hv = _hv(pkg, pkg.core.ClusterSpec())

    def boom(slice_id):
        raise RuntimeError("core dumped")

    job = hv.scheduler.submit("u", 1, run=boom)
    for _ in range(job.max_attempts):
        hv.scheduler.run_pending()
    assert job.state == pkg.core.JobState.FAILED
    assert job.attempts == job.max_attempts
    assert hv.db.utilization() == {d: 0.0 for d in hv.db.devices}
    return dict(_record(hv), attempts=job.attempts)


def test_failed_job_requeues_then_fails():
    _same(_requeue_then_fail)


# ---------------------------------------------------------------------------
# Reconfiguration (PR cache) + service models (tests/test_core.py)
# ---------------------------------------------------------------------------

def test_pr_cache_hit_is_fast():
    hv = _hv(TORCH, tcore.ClusterSpec())
    ex = (np.ones((16, 16), np.float32),) * 2
    e1, t_full, hit1 = hv.reconfig.partial_reconfigure(_mm_core, ex)
    e2, t_pr, hit2 = hv.reconfig.partial_reconfigure(_mm_core, ex)
    assert not hit1 and hit2
    assert e2.fingerprint == e1.fingerprint
    assert t_pr < t_full  # paper Table I: PR << full configuration
    jhv = _hv(JAX, jcore.ClusterSpec())
    assert [jhv.reconfig.partial_reconfigure(_mm_core, ex)[2]
            for _ in range(2)] == [hit1, hit2]


def _geometry_variants(pkg):
    rc = _rc(pkg)
    ex = (np.ones((4, 4), np.float32),) * 2
    hits = [rc.partial_reconfigure(_mm_core, ex)[2],
            rc.partial_reconfigure(_mm_core, ex, geometry="dk1024.s8")[2]]
    assert hits == [False, False] and len(rc.cache) == 2
    hits += [rc.partial_reconfigure(_mm_core, ex)[2],
             rc.partial_reconfigure(_mm_core, ex, geometry="dk1024.s8")[2],
             rc.partial_reconfigure(_mm_core, ex, geometry="dk256.s2")[2]]
    assert hits[2:] == [True, True, False]
    return dict(hits=hits, n=len(rc.cache))


def test_cache_keys_geometry_variants_apart():
    _same(_geometry_variants)


def _mixed_eviction(pkg):
    rc = _rc(pkg, max_entries=2)
    ex = (np.ones((4, 4), np.float32),) * 2
    e_def, _ = rc.configure(_mm_core, ex)
    e_g2, _ = rc.configure(_mm_core, ex, geometry="g2")
    e_g3, _ = rc.configure(_mm_core, ex, geometry="g3")
    assert len(rc.cache) == 2 and rc.cache.evictions == 1
    assert e_def.fingerprint == e_g2.fingerprint == e_g3.fingerprint
    assert rc.cache.entry_for(e_def.fingerprint) in (e_g2, e_g3)
    hits = [rc.partial_reconfigure(_mm_core, ex, geometry="g2")[2],
            rc.partial_reconfigure(_mm_core, ex)[2]]
    assert hits == [True, False]
    return dict(hits=hits, evictions=rc.cache.evictions,
                counts=(rc.cache.hits, rc.cache.misses))


def test_mixed_geometry_eviction_repoints_fp_index():
    _same(_mixed_eviction)


def _rsaas(pkg):
    hv = _hv(pkg, pkg.core.ClusterSpec())
    sess = pkg.core.RSaaSSession(hv, "alice")
    assert hv.db.device(sess.device.device_id).state == \
        pkg.core.DeviceState.EXCLUSIVE
    sess.program(_mm_core, (np.eye(4, dtype=np.float32),
                            np.ones((4, 4), np.float32)))
    out = sess.run(np.eye(4, dtype=np.float32), np.ones((4, 4), np.float32))
    assert np.allclose(_np(out[0]), np.ones((4, 4)))
    sess.close()
    assert hv.db.device(sess.device.device_id).state == \
        pkg.core.DeviceState.PARKED
    return dict(_record(hv, ["alice"]), out=out)


def test_rsaas_full_device_and_run():
    _same(_rsaas)


def _admission_rejects(pkg):
    hv = _hv(pkg, pkg.core.ClusterSpec())
    sess = pkg.core.RAaaSSession(hv, "bob")
    xp = pkg.xp

    def bad_core(a):
        return (a @ xp.ones((5,)),)          # shape error

    with pytest.raises(pkg.rc2f.AdmissionError):
        sess.deploy_core(bad_core, (np.ones((4, 4), np.float32),))

    def amplifier(a):                         # 64 B in -> 16 MB out
        return (xp.broadcast_to(a[0, 0], (2048, 2048)) * 1.0,)

    with pytest.raises(pkg.rc2f.AdmissionError):
        sess.deploy_core(amplifier, (np.ones((4, 4), np.float32),))
    sess.close()
    return _record(hv, ["bob"])


def test_raas_admission_rejects_bad_core():
    _same(_admission_rejects)


def _fp_lookup(pkg):
    rc = _rc(pkg)
    ex = (np.ones((4, 4), np.float32),) * 2
    entry, _ = rc.configure(_mm_core, ex)
    assert rc.cache.entry_for(entry.fingerprint) is entry
    with pytest.raises(KeyError):
        rc.cache.entry_for("deadbeef00000000")
    return dict(fp=entry.fingerprint)


def test_program_cache_fingerprint_lookup():
    _same(_fp_lookup)      # one core, one hash: the fingerprints agree


def _evicted_raises(pkg):
    hv = _hv(pkg, pkg.core.ClusterSpec())
    vs = hv.allocate_vslice("u", 1)
    ex = (np.ones((4, 4), np.float32),) * 2
    entry = hv.program_slice(vs.slice_id, _mm_core, ex)
    hv.reconfig.cache.evict(entry.fingerprint)
    with pytest.raises(KeyError, match="evicted"):
        hv.execute(vs.slice_id, *ex)
    return _record(hv)


def test_evicted_program_raises_on_execute():
    _same(_evicted_raises)


def _lru_use(pkg):
    PC, PE = pkg.core.ProgramCache, pkg.core.ProgramEntry
    pc = PC(max_entries=2)
    pc.put(("hot", "a"), PE("hot", "exe-hot", None, 0.0))
    pc.put(("cold", "a"), PE("cold", "exe-cold", None, 0.0))
    pc.entry_for("hot")
    pc.put(("new", "a"), PE("new", "exe-new", None, 0.0))
    assert pc.entry_for("hot").compiled == "exe-hot"
    with pytest.raises(KeyError):
        pc.entry_for("cold")
    return dict(n=len(pc), evictions=pc.evictions)


def test_entry_for_counts_as_lru_use():
    _same(_lru_use)


def _repoint(pkg):
    PC, PE = pkg.core.ProgramCache, pkg.core.ProgramEntry
    pc = PC(max_entries=2)
    a = PE("fp1", "exe-a", None, 0.0)
    b = PE("fp1", "exe-b", None, 0.0)
    pc.put(("fp1", "avalA"), a)
    pc.put(("fp1", "avalB"), b)
    pc.get(("fp1", "avalA"))
    pc.put(("fp2", "avalC"), PE("fp2", "exe-c", None, 0.0))
    assert pc.entry_for("fp1") is a
    return dict(counts=(pc.hits, pc.misses, pc.evictions))


def test_cache_fp_index_repoints_on_variant_eviction():
    _same(_repoint)


def _lru_bound(pkg):
    def make_core(i):
        def core(a):
            return (a * float(i),)
        core.__name__ = f"core_{i}"
        return core

    rc = _rc(pkg, max_entries=2)
    ex = (np.ones((2, 2), np.float32),)
    entries = [rc.configure(make_core(i), ex, static_desc=str(i))[0]
               for i in range(3)]
    assert len(rc.cache) == 2 and rc.cache.evictions == 1
    with pytest.raises(KeyError):
        rc.cache.entry_for(entries[0].fingerprint)
    for e in entries[1:]:
        assert rc.cache.entry_for(e.fingerprint) is e
    return dict(fps=[e.fingerprint for e in entries],
                out=[e.compiled(np.full((2, 2), 3.0, np.float32))[0]
                     for e in entries[1:]])


def test_program_cache_lru_bound():
    _same(_lru_bound)


def _baaas(pkg):
    hv = _hv(pkg, pkg.core.ClusterSpec())
    hv.register_service(
        "matmul16",
        lambda: (_mm_core, (np.ones((16, 16), np.float32),) * 2))
    sess = pkg.core.BAaaSSession(hv, "carol")
    assert sess.list_services() == ["matmul16"]
    out = sess.invoke("matmul16", np.eye(16, dtype=np.float32),
                      np.ones((16, 16), np.float32))
    assert np.allclose(_np(out[0]), np.ones((16, 16)))
    assert all(u == 0.0 for u in hv.db.utilization().values())
    return dict(_record(hv, ["carol"]), out=out)


def test_baaas_hides_allocation():
    _same(_baaas)


def _invoke_args(pkg):
    hv = _hv(pkg, pkg.core.ClusterSpec())
    hv.register_service("double", lambda: (
        lambda a: (a * 2,), (np.ones((4,), np.float32),)))
    hv.register_service("const7", lambda: (
        lambda: (np.full((3,), 7.0, np.float32),), ()))
    outs = [hv.invoke_service("double", "u")[0],
            hv.invoke_service("double", "u",
                              (np.arange(4, dtype=np.float32),))[0],
            hv.invoke_service("const7", "u", ())[0],
            hv.invoke_service("const7", "u")[0]]
    np.testing.assert_allclose(_np(outs[1]), [0, 2, 4, 6])
    return dict(_record(hv, ["u"]), out=outs)


def test_invoke_service_explicit_args_vs_example_inputs():
    _same(_invoke_args)


# ---------------------------------------------------------------------------
# BatchScheduler policy (tests/test_scheduler.py)
# ---------------------------------------------------------------------------

def _sched(pkg, devs=4, **kw):
    return pkg.core.BatchScheduler(make_db(pkg, nodes=1, devs=devs),
                                   FakeClock(), **kw)


def _priority_ordering(pkg):
    sched = _sched(pkg)
    for p in (20, 1, 10):
        sched.submit("u", 1, run=lambda s: None, priority=p)
    started = sched.schedule_once()
    assert [j.priority for j in started] == [1, 10, 20]
    return dict(history=sched.history)


def test_priority_ordering():
    _same(_priority_ordering)


def _fifo_tiebreak(pkg):
    sched = _sched(pkg)
    jobs = [sched.submit("u", 1, priority=5) for _ in range(4)]
    started = sched.schedule_once()
    assert [j.job_id for j in started] == [j.job_id for j in jobs]
    return dict(history=sched.history)


def test_fifo_tiebreak_within_priority():
    _same(_fifo_tiebreak)


def _tiebreak_requeue(pkg):
    sched = _sched(pkg, devs=1)

    def boom(s):
        raise RuntimeError("boom")

    first = sched.submit("u", 4, run=boom, priority=5)
    sched.run_pending()
    assert first.state == pkg.core.JobState.REQUEUED
    sched.submit("u", 4, run=lambda s: "ok", priority=5)
    started = sched.schedule_once()
    assert [j.job_id for j in started] == [first.job_id]
    return dict(history=sched.history)


def test_fifo_tiebreak_survives_requeue():
    _same(_tiebreak_requeue)


def _max_attempts(pkg):
    sched = _sched(pkg)
    calls = []

    def boom(slice_id):
        calls.append(slice_id)
        raise RuntimeError("core dumped")

    job = sched.submit("u", 1, run=boom)
    job.max_attempts = 2
    for _ in range(5):
        sched.run_pending()
    assert job.state == pkg.core.JobState.FAILED
    assert job.attempts == 2 and len(calls) == 2
    assert job.error == "core dumped"
    assert all(d.used_slots() == 0 for d in sched.db.devices.values())
    return dict(history=sched.history, calls=calls)


def test_max_attempts_exhaustion():
    _same(_max_attempts)


def _terminal(pkg):
    sched = _sched(pkg)
    job = sched.submit("u", 1, run=lambda s: 1 / 0)
    job.max_attempts = 1
    sched.run_pending()
    assert job.state == pkg.core.JobState.FAILED
    assert sched.queued() == [] and sched.schedule_once() == []
    return dict(history=sched.history)


def test_failed_terminal_job_not_rescheduled():
    _same(_terminal)


def _no_starvation(pkg):
    sched = _sched(pkg, devs=1, starvation_patience=3)
    blocker = sched.submit("u", 1, priority=5)
    assert sched.schedule_once() == [blocker]
    big = sched.submit("big", 4, priority=5)
    after_holdback = []
    held = False
    for _ in range(8):
        sched.submit("u", 1, priority=5)
        started = sched.schedule_once()
        assert big not in started
        if held:
            after_holdback += started
        for j in started:
            if j is not blocker:
                sched.complete(j.job_id)
        held = held or big.deferrals >= 3
    assert held and after_holdback == []
    sched.complete(blocker.job_id)
    started = sched.schedule_once()
    assert big in started and big.state == pkg.core.JobState.RUNNING
    assert big.deferrals == 0
    sched.complete(big.job_id)
    assert len(sched.schedule_once()) == 4
    return dict(history=sched.history)


def test_large_job_not_starved_by_small_stream():
    _same(_no_starvation)


def _holdback_escape(pkg):
    db = make_db(pkg, nodes=1, devs=1)
    db.allocate_slice("serving-tenant", 2, "baas")
    sched = pkg.core.BatchScheduler(db, FakeClock(), starvation_patience=1)
    big = sched.submit("big", 4, priority=5)
    for _ in range(5):
        small = sched.submit("u", 1, priority=5)
        assert small in sched.schedule_once()
        sched.complete(small.job_id)
    assert big.deferrals >= 5
    assert not any(h["kind"] == "holdback" for h in sched.history)
    return dict(history=sched.history, db=_db_json(db))


def test_holdback_skipped_when_job_can_never_fit():
    _same(_holdback_escape)


def _holdback_priority(pkg):
    sched = _sched(pkg, devs=1, starvation_patience=1)
    sched.submit("u", 1, priority=5)
    sched.schedule_once()
    sched.submit("big", 4, priority=5)
    sched.schedule_once()
    urgent = sched.submit("u", 1, priority=1)
    assert urgent in sched.schedule_once()
    return dict(history=sched.history)


def test_holdback_does_not_block_higher_priority():
    _same(_holdback_priority)


def _hv_scheduler(pkg):
    hv = _hv(pkg, pkg.core.ClusterSpec(n_nodes=1, devices_per_node=1))
    order = []
    hv.scheduler.submit("a", 4, run=lambda s: order.append("low"),
                        priority=30)
    hv.scheduler.submit("b", 4, run=lambda s: order.append("high"),
                        priority=2)
    hv.scheduler.run_pending()
    hv.scheduler.run_pending()
    assert order == ["high", "low"]
    return dict(_record(hv), order=order)


def test_hypervisor_scheduler_integration():
    _same(_hv_scheduler)


def _migrate_rebinds_job(pkg):
    hv = _hv(pkg, pkg.core.ClusterSpec(n_nodes=1, devices_per_node=2))
    job = hv.scheduler.submit("u", 2)
    assert hv.scheduler.schedule_once() == [job]
    old = job.slice_id
    new = hv.migrate_slice(old, target_device="dev-0-1", reason="ops")
    assert job.slice_id == new.slice_id != old
    hv.scheduler.complete(job.job_id)
    assert job.state == pkg.core.JobState.DONE
    assert all(u == 0.0 for u in hv.db.utilization().values())
    return _record(hv)


def test_migrate_slice_rebinds_running_batch_job():
    _same(_migrate_rebinds_job)


# ---------------------------------------------------------------------------
# Fault-tolerance drills (tests/test_fault_tolerance.py, no training)
# ---------------------------------------------------------------------------

def _heartbeat_requeue(pkg):
    clock = FakeClock()
    hv = _hv(pkg, pkg.core.ClusterSpec(n_nodes=2, devices_per_node=1),
             pkg.core.MonitorConfig(heartbeat_deadline_s=10), clock)
    job = hv.scheduler.submit("u", 4, run=None)
    hv.scheduler.schedule_once()
    dead = hv.db.devices[hv.db.find_slice(job.slice_id).device_id].node_id
    for n in hv.db.nodes:
        hv.monitor.heartbeat(n)
    clock.t = 8.0
    for n in hv.db.nodes:
        if n != dead:
            hv.monitor.heartbeat(n)
    clock.t = 15.0
    orphans = hv.handle_failures()
    assert orphans and not hv.db.nodes[dead].alive
    assert job.state == pkg.core.JobState.REQUEUED
    hv.scheduler.schedule_once()
    assert job.state == pkg.core.JobState.RUNNING
    assert hv.db.devices[hv.db.find_slice(job.slice_id).device_id] \
        .node_id != dead
    return dict(_record(hv), orphans=orphans, events=hv.monitor.events)


def test_heartbeat_failure_requeues_jobs():
    _same(_heartbeat_requeue)


def _dead_sweep(pkg):
    clock = FakeClock()
    hv = _hv(pkg, pkg.core.ClusterSpec(n_nodes=2, devices_per_node=1),
             pkg.core.MonitorConfig(heartbeat_deadline_s=10), clock)
    vs = hv.allocate_vslice("t", 1)
    dead = hv.db.devices[vs.device_id].node_id
    for _ in range(4):
        hv.monitor.record_step(vs.slice_id, 400.0)
    hv.monitor.record_pages(vs.device_id, 7, 8)
    assert hv.monitor.find_page_pressure()
    for n in hv.db.nodes:
        hv.monitor.heartbeat(n)
    clock.t = 8.0
    for n in hv.db.nodes:
        if n != dead:
            hv.monitor.heartbeat(n)
    clock.t = 15.0
    assert vs.slice_id in hv.handle_failures()
    assert vs.slice_id not in hv.monitor._step_times
    assert hv.monitor.median_step_ms() is None
    assert not hv.monitor.find_page_pressure()
    assert not hv.monitor.find_stragglers()
    return dict(_record(hv), events=hv.monitor.events)


def test_dead_node_sweep_clears_monitor_state():
    _same(_dead_sweep)


def _device_granular(pkg):
    clock = FakeClock()
    hv = _hv(pkg, pkg.core.ClusterSpec(n_nodes=1, devices_per_node=2),
             clock=clock)
    job = hv.scheduler.submit("u", 1, run=None)
    hv.scheduler.schedule_once()
    sid = job.slice_id
    dev = hv.db.find_slice(sid).device_id
    hv.monitor.record_step(sid, 50.0)
    hv.monitor.record_pages(dev, 3, 8)
    assert hv.mark_device_failed(dev, reason="status_error") == [sid]
    assert hv.db.devices[dev].state == pkg.core.DeviceState.DEAD
    assert hv.db.nodes["node-0"].alive
    assert job.state == pkg.core.JobState.REQUEUED
    assert dev not in hv.monitor.page_occupancy()
    hv.scheduler.schedule_once()
    assert hv.db.find_slice(job.slice_id).device_id != dev
    return dict(_record(hv), events=hv.monitor.events)


def test_device_failure_is_device_granular():
    _same(_device_granular)


def _straggler(pkg):
    hv = _hv(pkg, pkg.core.ClusterSpec(n_nodes=2, devices_per_node=1),
             pkg.core.MonitorConfig(straggler_factor=1.5,
                                    straggler_patience=3))
    fast = hv.allocate_vslice("fast", 1)
    slow = hv.allocate_vslice("slow", 1)
    for _ in range(8):
        hv.monitor.record_step(fast.slice_id, 100.0)
        hv.monitor.record_step(slow.slice_id, 400.0)
    moved = hv.migrate_stragglers()
    assert len(moved) == 1
    new = hv.db.find_slice(moved[0])
    assert new.owner == "slow" and new.device_id != slow.device_id
    with pytest.raises(KeyError):
        hv.db.find_slice(slow.slice_id)
    return dict(_record(hv), moved=moved, pairs=hv.last_migrations)


def test_straggler_migration():
    _same(_straggler)


def _failed_directed(pkg):
    hv = _hv(pkg, pkg.core.ClusterSpec(n_nodes=1, devices_per_node=2))
    vs = hv.allocate_vslice("t", 1)
    hv.allocate_vslice("hog", 4)
    assert hv.migrate_slice(vs.slice_id) is None
    assert hv.db.find_slice(vs.slice_id).state == \
        pkg.core.SliceState.ALLOCATED
    return _record(hv)


def test_failed_directed_migration_restores_prior_state():
    _same(_failed_directed)


def _elastic_resize(pkg):
    hv = _hv(pkg, pkg.core.ClusterSpec(n_nodes=2, devices_per_node=2))
    ec = pkg.core.ElasticController(hv)
    vs = hv.allocate_vslice("u", 1)
    hv.db.set_slice_state(vs.slice_id, pkg.core.SliceState.CONFIGURED,
                          program="abc")
    new = ec.resize("u", 4)
    assert len(new) == 1 and new[0].slots == 4
    assert new[0].program == "abc"
    assert len(hv.db.slices_of("u")) == 1
    return _record(hv)


def test_elastic_resize_carries_program():
    _same(_elastic_resize)


# ---------------------------------------------------------------------------
# Port-only: the device the programs run on
# ---------------------------------------------------------------------------

def test_hypervisor_defaults_to_cuda():
    """The entry point runs on the card unless asked for the CPU, refuses
    the default where CUDA is absent, and places programs' array inputs on
    its device."""
    if torch.cuda.is_available():
        assert tcore.Hypervisor().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tcore.Hypervisor()
    hv = _hv(TORCH, tcore.ClusterSpec())
    entry = hv.program_slice(hv.allocate_vslice("u", 1).slice_id, _mm_core,
                             (np.ones((4, 4), np.float32),) * 2)
    out = entry.compiled(np.eye(4, dtype=np.float32),
                         torch.ones((4, 4)))[0]
    assert isinstance(out, torch.Tensor) and out.device == hv.device
    assert entry.lowered_text is None and entry.compile_time_s > 0
