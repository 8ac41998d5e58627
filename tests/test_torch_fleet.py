"""The port's serving fleet (``repro_torch.runtime.fleet``) on the CPU.

Mirror: the tests of ``tests/test_fleet.py`` and the fleet/gateway cases of
``tests/test_paged.py``, run on the port with the same assertions
(``Hypervisor(device="cpu")``, ``Model(device="cpu")``), the cross-class
hand-off of an autotuned fleet among them (its log held against the
reference's run of the same scenario). Parity: a paged hand-off run (a
directed migration mid-decode, pages copied) through the JAX package's
fleet and the port's, compared on the token logs (exactly),
``fleet_stats()`` after every step (with ``page_stats()``, less its
wall-clock ``scrub_ms``), the journal and the hand-off records.

Weights: reduced smollm-135m in fp32, the JAX init carried across
(``params_from_numpy``); the token-margin premise is asserted as in
tests/test_torch_engine.py (``torch_parity.assert_margins``).
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.core import ClusterSpec as JClusterSpec
from repro.core import Hypervisor as JHypervisor
from repro.models import get_model as j_get_model
from repro.runtime import GatewayFleet as JGatewayFleet
from repro_torch.configs import get_config, reduced
from repro_torch.core import ClusterSpec, DeviceState, Hypervisor
from repro_torch.interop import params_from_numpy
from repro_torch.models import Model
from repro_torch.rc2f import AdmissionError
from repro_torch.runtime import GatewayFleet, ServingGateway
from torch_parity import assert_margins

torch.set_num_threads(1)


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


def _hv(n_nodes=1, devices_per_node=2, **spec):
    return Hypervisor(ClusterSpec(n_nodes=n_nodes,
                                  devices_per_node=devices_per_node, **spec),
                      device="cpu")


def _prompt(cfg, n=6, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, size=n).tolist()


def _flag_straggler(hv, hot_slice, cold_slices, n=8):
    for _ in range(n):
        hv.monitor.record_step(hot_slice, 400.0)
        for sid in cold_slices:
            hv.monitor.record_step(sid, 1.0)


# ---------------------------------------------------------------------------
# Placement
# ---------------------------------------------------------------------------

def test_sessions_decode_on_their_slices_device(served_model):
    cfg, model, params = served_model
    hv = _hv()
    fleet = GatewayFleet(hv, model, params, n_slots=4, max_len=64)
    a = fleet.open_session("a", slots=2)
    b = fleet.open_session("b", slots=2)
    c = fleet.open_session("c", slots=2, service_model="raas")
    devs = {t: hv.db.find_slice(s.slice_id).device_id
            for t, s in (("a", a), ("b", b), ("c", c))}
    assert devs["a"] == devs["b"] != devs["c"]
    assert set(fleet._engines) == set(devs.values())
    for t in ("a", "b", "c"):
        assert fleet.device_of(t) == devs[t]
        fleet.submit(t, _prompt(cfg, seed=ord(t)), max_new_tokens=3)
    fleet.step()
    assert fleet.engine_for("a") is fleet.engine_for("b")
    assert fleet.engine_for("c") is not fleet.engine_for("a")
    assert fleet.engine_for("c").active_by_tenant() == {"c": 1}
    fleet.run_until_idle()
    assert all(s["served"] == 1 for s in fleet.stats().values())
    fleet.close()


def test_fleet_engines_share_one_decode_program(served_model):
    """Configured once; every further engine is a PR cache hit that binds
    the program the cache holds (``use_program``)."""
    cfg, model, params = served_model
    hv = _hv()
    fleet = GatewayFleet(hv, model, params, n_slots=4, max_len=64)
    fleet.open_session("a", slots=4, service_model="rsaas")
    fleet.open_session("b", slots=4, service_model="rsaas")
    ups = [e for e in hv.log if e["kind"] == "engine_up"]
    assert len(ups) == 2 and all(u["cache_hit"] for u in ups)
    assert {u["fingerprint"] for u in ups} == {fleet.program_fingerprint}
    program = hv.reconfig.cache.entry_for(fleet.program_fingerprint).compiled
    assert all(e._decode_fn is program for e in fleet._engines.values())
    fleet.close()


def test_fleet_rejects_ssm_before_any_allocation():
    cfg = reduced(get_config("mamba2-370m")).replace(dtype="float32")
    model = Model(cfg, device="cpu")
    hv = _hv(devices_per_node=1)
    with pytest.raises(ValueError, match="attention-family") as e:
        GatewayFleet(hv, model, model.init(torch.Generator().manual_seed(0)))
    assert all(u == 0.0 for u in hv.db.utilization().values())
    # the reference's fleet refuses in the same words, before its params
    # are looked at
    jhv = JHypervisor(JClusterSpec(n_nodes=1, devices_per_node=1))
    with pytest.raises(ValueError, match="attention-family") as je:
        JGatewayFleet(jhv, j_get_model(j_reduced(j_get_config(
            "mamba2-370m"))), None)
    assert str(e.value) == str(je.value)


def test_open_session_failure_unwinds_allocation(served_model, monkeypatch):
    cfg, model, params = served_model
    hv = _hv(devices_per_node=1)
    fleet = GatewayFleet(hv, model, params, n_slots=2, max_len=64)
    monkeypatch.setattr(fleet, "_ensure_engine",
                        lambda dev: (_ for _ in ()).throw(
                            RuntimeError("device wedged")))
    with pytest.raises(RuntimeError, match="device wedged"):
        fleet.open_session("t", slots=1)
    assert hv.admission.usage("t")["slots"] == 0
    assert all(u == 0.0 for u in hv.db.utilization().values())
    monkeypatch.undo()
    fleet.open_session("t", slots=1)
    fleet.close()


def test_fleet_empty_prompt_rejected(served_model):
    cfg, model, params = served_model
    hv = _hv(devices_per_node=1)
    fleet = GatewayFleet(hv, model, params, n_slots=2, max_len=64)
    fleet.open_session("t", slots=1)
    with pytest.raises(AdmissionError, match="empty prompt"):
        fleet.submit("t", [], max_new_tokens=4)
    assert hv.admission.usage("t")["inflight"] == 0
    fleet.close()


def _cross_class_run(hv, fleet_cls, model, params, tuned_cls, cfg):
    """The reference's cross-class hand-off scenario on either package:
    two device classes (1.0 / 0.25) whose tuned store is seeded with two
    different geometries, a request decoding 3 rounds on the fast class,
    then a directed migration to the slow one. Returns (request, source
    device, destination device, fleet)."""
    from repro.tuning import device_class, model_fingerprint
    fp = model_fingerprint(cfg, 64, True)
    hv.reconfig.cache.put_tuned(
        fp, device_class(1.0), tuned_cls(page_size=8, n_slots=4).to_dict())
    hv.reconfig.cache.put_tuned(
        fp, device_class(0.25), tuned_cls(page_size=16, n_slots=2).to_dict())
    fleet = fleet_cls(hv, model, params, n_slots=2, max_len=64, paged=True,
                      page_size=8, autotune=True)
    t = fleet.open_session("t", slots=1)
    src = fleet.device_of("t")
    req = fleet.submit("t", _prompt(cfg), max_new_tokens=8)
    for _ in range(3):
        fleet.step()
    dst = next(d for d in hv.db.devices if d != src)
    hv.migrate_slice(t.slice_id, target_device=dst, reason="ops")
    return req, src, dst, fleet


def test_cross_class_handoff_reresolves_geometry(served_model, jax_model):
    """A hand-off between device CLASSES re-resolves the tuned geometry on
    the destination: the target engine binds ITS class's winner from the
    ProgramCache tuned store (seeded with two different geometries), pages
    cut at the source's page size are declined by the import guard (prefix
    replay instead), and the token log equals the reference's run of the
    same scenario and an unmigrated default run of either package."""
    from repro.tuning import TunedConfig as JTunedConfig
    from repro_torch.tuning import TunedConfig, device_class
    from repro_torch.tuning import model_fingerprint
    cfg, model, params = served_model
    hv = _hv(device_speeds=(1.0, 0.25))
    fp = model_fingerprint(model.cfg, 64, True)
    req, src, dst, fleet = _cross_class_run(hv, GatewayFleet, model, params,
                                            TunedConfig, cfg)
    assert hv.db.devices[src].speed != hv.db.devices[dst].speed
    assert fleet._engines[src].page_size == 8          # fast-class winner
    assert fleet.device_of("t") == dst
    # destination bound the 0.25x-class geometry, not the source's
    assert fleet._engines[dst].page_size == 16
    assert fleet._engines[dst].n_slots == 2
    assert hv.reconfig.cache.get_tuned(fp, device_class(0.25)) == \
        TunedConfig(page_size=16, n_slots=2).to_dict()
    binds = [e for e in hv.log if e["kind"] == "autotune_bind"]
    assert {e["geometry"] for e in binds} == {"ps8.s4.pc4", "ps16.s2.pc4"}
    ev = fleet.handoffs[-1]
    assert ev["src_geometry"] == "ps8.s4.pc4"
    assert ev["dst_geometry"] == "ps16.s2.pc4"
    # page snapshot was cut at ps=8 — the ps=16 pool must decline it and
    # fall back to prefix replay (bit-exact greedy), never adopt raggedly
    assert ev["page_copied"] == 0 and ev["replayed_inflight"] == 1
    fleet.run_until_idle()
    assert len(req.out_tokens) == 8
    fleet.verify_invariants()
    fleet.close()

    jmodel, jparams = jax_model
    jhv = JHypervisor(JClusterSpec(n_nodes=1, devices_per_node=2,
                                   device_speeds=(1.0, 0.25)))
    jreq, _, _, jfleet = _cross_class_run(jhv, JGatewayFleet, jmodel,
                                          jparams, JTunedConfig, cfg)
    jev = jfleet.handoffs[-1]
    jfleet.run_until_idle()
    jfleet.close()
    assert (jev["page_copied"], jev["replayed_inflight"]) == (0, 1)
    assert list(req.out_tokens) == list(jreq.out_tokens)

    # bit-exactness across the migration + both tuned geometries
    hv2 = _hv(devices_per_node=1)
    fleet2 = GatewayFleet(hv2, model, params, n_slots=2, max_len=64,
                          paged=True, page_size=8)
    fleet2.open_session("t", slots=1)
    ref = fleet2.submit("t", _prompt(cfg), max_new_tokens=8)
    fleet2.run_until_idle()
    fleet2.close()
    assert list(req.out_tokens) == list(ref.out_tokens)


# ---------------------------------------------------------------------------
# Live migration hand-off
# ---------------------------------------------------------------------------

def test_migrated_tenant_decodes_on_target_engine(served_model):
    cfg, model, params = served_model
    hv = _hv()
    fleet = GatewayFleet(hv, model, params, n_slots=4, max_len=64)
    hot = fleet.open_session("hot", slots=1)
    cold = fleet.open_session("cold", slots=1)
    old_slice, old_dev = hot.slice_id, fleet.device_of("hot")

    reqs = [fleet.submit("hot", _prompt(cfg, seed=i), max_new_tokens=8)
            for i in range(3)]
    fleet.submit("cold", _prompt(cfg, seed=9), max_new_tokens=8)
    for _ in range(3):
        fleet.step()
    assert reqs[0].out_tokens and not reqs[0].done.is_set()
    mid_tokens = [list(r.out_tokens) for r in reqs]
    assert hv.admission.usage("hot")["inflight"] == 3

    _flag_straggler(hv, hot.slice_id, [cold.slice_id])
    moved = fleet.rebalance()
    assert moved and moved[0][0] == old_slice
    assert hot.slice_id != old_slice
    new_vs = hv.db.find_slice(hot.slice_id)
    assert new_vs.device_id != old_dev
    assert new_vs.program == fleet.program_fingerprint
    assert fleet.handoffs[-1]["moved_requests"] == 3
    assert hv.admission.usage("hot")["inflight"] == 3

    source, target = fleet._engines[old_dev], fleet._engines[new_vs.device_id]
    steps_before = target.steps
    fleet.step()
    assert target.active_by_tenant().get("hot", 0) == 1
    assert "hot" not in source.active_by_tenant()
    assert "hot" not in source.queued_by_tenant()
    assert target.steps == steps_before + 1

    fleet.run_until_idle()
    assert all(len(r.out_tokens) == 8 for r in reqs)
    for r, mid in zip(reqs, mid_tokens):
        assert r.out_tokens[:len(mid)] == mid
    assert hv.admission.usage("hot")["inflight"] == 0
    assert fleet.session("hot").served == 3
    fleet.close()


def test_handoff_tokens_match_unmigrated_run(served_model):
    cfg, model, params = served_model
    prompts = [_prompt(cfg, n=6, seed=i) for i in range(3)]

    def serve(migrate: bool):
        hv = _hv()
        fleet = GatewayFleet(hv, model, params, n_slots=4, max_len=64)
        hot = fleet.open_session("hot", slots=1)
        cold = fleet.open_session("cold", slots=1)
        reqs = [fleet.submit("hot", p, max_new_tokens=8) for p in prompts]
        fleet.submit("cold", _prompt(cfg, seed=9), max_new_tokens=8)
        for _ in range(3):
            fleet.step()
        if migrate:
            _flag_straggler(hv, hot.slice_id, [cold.slice_id])
            fleet.rebalance()
            assert fleet.handoffs, "migration must have happened"
        fleet.run_until_idle()
        fleet.close()
        return [list(r.out_tokens) for r in reqs]

    assert serve(migrate=True) == serve(migrate=False)


def test_directed_migration_api(served_model):
    cfg, model, params = served_model
    hv = _hv()
    fleet = GatewayFleet(hv, model, params, n_slots=2, max_len=64)
    t = fleet.open_session("t", slots=1)
    src = fleet.device_of("t")
    assert hv.migrate_slice(t.slice_id, target_device=src) is None
    dst = next(d for d in hv.db.devices if d != src)
    new = hv.migrate_slice(t.slice_id, target_device=dst, reason="ops")
    assert new is not None and new.device_id == dst
    assert fleet.device_of("t") == dst
    fleet.submit("t", _prompt(cfg), max_new_tokens=3)
    fleet.run_until_idle()
    assert fleet.session("t").served == 1
    fleet.close()


# ---------------------------------------------------------------------------
# Elastic scale-up / park lifecycle
# ---------------------------------------------------------------------------

def test_scale_up_wakes_parked_device_and_parks_after(served_model):
    cfg, model, params = served_model
    hv = _hv()
    fleet = GatewayFleet(hv, model, params, n_slots=2, max_len=64,
                         autoscale_every=1, scale_up_queue_depth=3)
    fleet.open_session("deep", slots=1)
    fleet.open_session("shallow", slots=1)
    assert fleet.device_of("deep") == fleet.device_of("shallow")
    assert hv.db.devices["dev-0-1"].state == DeviceState.PARKED

    reqs = [fleet.submit("deep", _prompt(cfg, seed=i), max_new_tokens=4)
            for i in range(6)]
    fleet.submit("shallow", _prompt(cfg, seed=99), max_new_tokens=4)
    fleet.step()
    assert hv.db.devices["dev-0-1"].state == DeviceState.ACTIVE
    assert fleet.device_of("deep") == "dev-0-1"
    assert fleet.handoffs[-1]["tenant"] == "deep"
    assert [e for e in hv.log if e["kind"] == "elastic_scale_out"]

    fleet.run_until_idle()
    assert all(len(r.out_tokens) == 4 for r in reqs)
    fleet.close_session("deep")
    fleet.close_session("shallow")
    fleet.step()
    assert all(d.state == DeviceState.PARKED
               for d in hv.db.devices.values())
    assert fleet._engines == {}
    assert len([e for e in hv.log if e["kind"] == "engine_park"]) >= 2
    fleet.close()


def test_request_ids_unique_across_engines(served_model):
    cfg, model, params = served_model
    hv = _hv()
    fleet = GatewayFleet(hv, model, params, n_slots=4, max_len=64)
    fleet.open_session("a", slots=4, service_model="rsaas")
    fleet.open_session("b", slots=4, service_model="rsaas")
    assert fleet.device_of("a") != fleet.device_of("b")
    reqs = [fleet.submit(t, _prompt(cfg, seed=i), max_new_tokens=3)
            for i, t in enumerate(["a", "b"] * 3)]
    assert len({r.request_id for r in reqs}) == len(reqs)
    fleet.run_until_idle()
    serve_events = {e["request"] for e in hv.log if e["kind"] == "serve"}
    assert len(serve_events) == len(reqs)
    fleet.close()


def test_consolidate_infeasible_moves_nothing(served_model):
    cfg, model, params = served_model
    hv = _hv()
    fleet = GatewayFleet(hv, model, params, n_slots=4, max_len=64)
    fleet.open_session("a", slots=2)
    fleet.open_session("b", slots=2)
    fleet.open_session("c", slots=2, service_model="raas")
    dev0 = fleet.device_of("a")
    assert fleet.device_of("c") != dev0
    assert not fleet.elastic.consolidate(dev0)
    assert fleet.device_of("a") == fleet.device_of("b") == dev0
    assert not fleet.handoffs
    fleet.close()


def test_consolidate_drains_device_for_parking(served_model):
    cfg, model, params = served_model
    hv = _hv()
    fleet = GatewayFleet(hv, model, params, n_slots=4, max_len=64)
    fleet.open_session("a", slots=4, service_model="rsaas")
    fleet.open_session("b", slots=2)
    dev_b = fleet.device_of("b")
    fleet.submit("b", _prompt(cfg), max_new_tokens=6)
    fleet.step()
    assert not fleet.elastic.consolidate(fleet.device_of("a"))
    fleet.close_session("a")
    assert fleet.elastic.consolidate(dev_b)
    assert fleet.device_of("b") != dev_b
    fleet.run_until_idle()
    assert fleet.session("b").served == 1
    fleet.park_idle_engines()
    assert list(fleet._engines) == [fleet.device_of("b")]
    fleet.close()


# ---------------------------------------------------------------------------
# Autoscale arbitration (one action per tick), SLO projection, down-ramp
# ---------------------------------------------------------------------------

def test_autoscale_one_action_when_multiple_signals_trip(served_model):
    cfg, model, params = served_model
    hv = _hv(devices_per_node=3)
    fleet = GatewayFleet(hv, model, params, n_slots=2, max_len=64,
                         paged=True, page_size=4,
                         scale_up_queue_depth=2, page_pressure=0.8)
    fleet.open_session("a", slots=1)
    fleet.open_session("b", slots=1)
    dev0 = fleet.device_of("a")
    assert fleet.device_of("b") == dev0
    for i in range(8):
        fleet.submit("a", _prompt(cfg, seed=i), max_new_tokens=4)
    hv.monitor.record_pages(dev0, 95, 100)

    active_before = len([d for d in hv.db.devices.values()
                         if d.state == DeviceState.ACTIVE])
    woken = fleet.autoscale()
    active_after = len([d for d in hv.db.devices.values()
                        if d.state == DeviceState.ACTIVE])
    assert woken is not None
    assert active_after == active_before + 1
    assert len(fleet.autoscale_log) == 1
    assert fleet.autoscale_log[0]["signal"] == "queue_depth"
    fleet.run_until_idle()
    fleet.close()


def test_autoscale_slo_projection_wakes_before_queue_threshold(served_model):
    cfg, model, params = served_model
    hv = _hv()
    fleet = GatewayFleet(hv, model, params, n_slots=2, max_len=64,
                         scale_up_queue_depth=100,
                         slo_p95_steps=8.0, slo_horizon=16)
    fleet.open_session("a", slots=1)
    fleet.open_session("b", slots=1)
    for i in range(4):
        fleet.submit("a", _prompt(cfg, seed=i), max_new_tokens=4)
    for _ in range(8):
        hv.monitor.record_traffic(4, 1, 1)
    projected = fleet.elastic.projected_p95_steps(2, 16)
    assert projected is not None and projected > 8.0

    woken = fleet.autoscale()
    assert woken is not None
    assert fleet.autoscale_log[-1]["signal"] == "slo_projection"
    assert [e for e in hv.log if e["kind"] == "elastic_slo_scale_out"]
    assert hv.db.devices[woken].state == DeviceState.ACTIVE
    fleet.run_until_idle()
    fleet.close()


def test_autoscale_slo_quiet_trend_no_wake(served_model):
    cfg, model, params = served_model
    hv = _hv()
    fleet = GatewayFleet(hv, model, params, n_slots=2, max_len=64,
                         scale_up_queue_depth=100,
                         slo_p95_steps=50.0, slo_horizon=4)
    fleet.open_session("a", slots=1)
    fleet.submit("a", _prompt(cfg), max_new_tokens=4)
    for _ in range(8):
        hv.monitor.record_traffic(1, 2, 1)
    assert fleet.autoscale() is None
    assert hv.db.devices["dev-0-1"].state == DeviceState.PARKED
    fleet.run_until_idle()
    fleet.close()


def test_downramp_consolidates_in_draw_order(served_model):
    cfg, model, params = served_model
    hv = _hv(devices_per_node=3, device_draws=(1.0, 3.0, 2.0))
    fleet = GatewayFleet(hv, model, params, n_slots=4, max_len=64,
                         slo_p95_steps=20.0)
    for t in ("a", "b", "c", "d"):
        fleet.open_session(t, slots=1)
    assert len(fleet._engines) == 1
    for t in ("a", "b"):
        assert fleet.elastic.scale_out(fleet.session(t).slice_id)
    assert len(set(fleet.device_of(t) for t in "abcd")) == 3
    assert hv.db.devices["dev-0-1"].draw == 3.0

    assert fleet._maybe_scale_in() == "dev-0-1"
    assert hv.db.devices["dev-0-1"].state == DeviceState.PARKED
    assert fleet._maybe_scale_in() == "dev-0-2"
    assert fleet._maybe_scale_in() is None
    assert [e["device"] for e in fleet.autoscale_log
            if e["action"] == "scale_in"] == ["dev-0-1", "dev-0-2"]
    assert all(fleet.device_of(t) == "dev-0-0" for t in "abcd")

    start = fleet.steps
    reqs = [fleet.submit(t, _prompt(cfg, seed=ord(t)), max_new_tokens=4)
            for t in "abcd"]
    assert fleet.run_until_idle()
    assert all(len(r.out_tokens) == 4 for r in reqs)
    assert fleet.steps - start <= 20
    fleet.close()


def test_downramp_blocked_while_projection_above_margin(served_model):
    cfg, model, params = served_model
    hv = _hv()
    fleet = GatewayFleet(hv, model, params, n_slots=4, max_len=64,
                         slo_p95_steps=10.0, scale_in_margin=0.5)
    fleet.open_session("a", slots=1)
    fleet.open_session("b", slots=1)
    assert fleet.elastic.scale_out(fleet.session("a").slice_id)
    assert len(fleet._engines) == 2
    for _ in range(8):
        hv.monitor.record_traffic(1, 1, 2)
    assert fleet._maybe_scale_in() is None
    assert len(fleet._engines) == 2
    fleet.close()


# ---------------------------------------------------------------------------
# The fleet and gateway cases of tests/test_paged.py
# ---------------------------------------------------------------------------

def test_gateway_page_grants_and_monitor_occupancy(served_model):
    cfg, model, params = served_model
    hv = _hv(devices_per_node=1, cache_pages_per_device=64)
    gw = ServingGateway(hv, model, params, n_slots=4, max_len=64, paged=True)
    sess = gw.open_session("acme", slots=2)
    vs = hv.db.find_slice(sess.slice_id)
    assert vs.cache_pages == gw._session_page_grant(2)
    assert hv.db.page_grants()
    gw.submit("acme", _prompt(cfg, 17, seed=0), max_new_tokens=4)
    gw.step()
    pages = hv.status()["pages"]
    assert pages and next(iter(pages.values()))["used"] > 0
    assert gw.run_until_idle() is True
    gw.close()


def test_fleet_handoff_copies_pages(served_model):
    cfg, model, params = served_model
    prompt = _prompt(cfg, 20, seed=5)

    hv = _hv()
    fl = GatewayFleet(hv, model, params, n_slots=4, max_len=64, paged=True)
    fl.open_session("a", slots=2)
    req = fl.submit("a", prompt, max_new_tokens=12)
    for _ in range(3):
        fl.step()
    prefix = list(req.out_tokens)
    assert hv.migrate_slice(fl.session("a").slice_id,
                            target_device="dev-0-1") is not None
    assert fl.handoffs[-1]["page_copied"] == 1
    assert fl.handoffs[-1]["replayed_inflight"] == 0
    assert fl.run_until_idle() is True
    assert req.out_tokens[:len(prefix)] == prefix

    hv2 = _hv(devices_per_node=1)
    fl2 = GatewayFleet(hv2, model, params, n_slots=4, max_len=64, paged=True)
    fl2.open_session("a", slots=2)
    ref = fl2.submit("a", prompt, max_new_tokens=12)
    assert fl2.run_until_idle() is True
    assert req.out_tokens == ref.out_tokens
    fl.close()
    fl2.close()


def test_elastic_page_pressure_scales_out(served_model):
    cfg, model, params = served_model
    hv = _hv()
    fl = GatewayFleet(hv, model, params, n_slots=2, max_len=64, paged=True,
                      cache_pages=9, autoscale_every=1, page_pressure=0.5)
    fl.open_session("big", slots=1)
    fl.open_session("small", slots=1)
    assert len(fl._engines) == 1
    fl.submit("big", _prompt(cfg, 33, seed=0), max_new_tokens=16)
    fl.submit("small", _prompt(cfg, 17, seed=1), max_new_tokens=8)
    for _ in range(6):
        fl.step()
    assert len(fl._engines) == 2, "page pressure should wake dev-0-1"
    assert [e for e in hv.log if e["kind"] == "elastic_page_pressure"]
    assert fl.run_until_idle() is True
    fl.close()


# ---------------------------------------------------------------------------
# Parity with the JAX package's fleet: a paged hand-off run
# ---------------------------------------------------------------------------

# (tenant, prompt length, seed, new tokens); "a" and "b" share a device
# until "a" is moved to dev-0-1 mid-decode
PARITY_REQS = [("a", 20, 5, 12), ("a", 9, 6, 10), ("b", 13, 7, 8),
               ("a", 33, 8, 6), ("b", 6, 9, 9)]


def _fleet_stats(fleet):
    out = {}
    for dev, fs in fleet.fleet_stats().items():
        fs = dict(fs)
        if "pages" in fs:
            fs["pages"] = {k: v for k, v in fs["pages"].items()
                           if k != "scrub_ms"}
        out[dev] = fs
    return out


def _journal(fleet):
    return {rid: (e.tenant, list(e.tokens))
            for rid, e in fleet.journal.items()}


def _handoff_run(fleet_cls, hv, model, params, vocab):
    fleet = fleet_cls(hv, model, params, n_slots=4, max_len=64, paged=True)
    fleet.open_session("a", slots=2)
    fleet.open_session("b", slots=2)
    reqs = [fleet.submit(t, np.random.default_rng(seed).integers(
        0, vocab, size=n).tolist(), max_new_tokens=new)
        for t, n, seed, new in PARITY_REQS]
    stats, journals = [], []
    for step in range(200):
        if step == 3:
            hv.migrate_slice(fleet.session("a").slice_id,
                             target_device="dev-0-1")
            journals.append(_journal(fleet))
        fleet.step()
        stats.append(_fleet_stats(fleet))
        journals.append(_journal(fleet))
        if all(r.done.is_set() for r in reqs):
            break
    fleet.verify_invariants()
    out = dict(tokens=[list(r.out_tokens) for r in reqs],
               prompts=[list(r.prompt) for r in reqs], stats=stats,
               journals=journals, handoffs=list(fleet.handoffs))
    fleet.close()
    return out


def test_handoff_run_matches_reference(jax_model, served_model):
    jmodel, jparams = jax_model
    cfg, model, params = served_model
    ref = _handoff_run(JGatewayFleet,
                       JHypervisor(JClusterSpec(n_nodes=1,
                                                devices_per_node=2)),
                       jmodel, jparams, cfg.vocab_size)
    got = _handoff_run(GatewayFleet, _hv(), model, params, cfg.vocab_size)
    assert_margins(jmodel, jparams, ref["prompts"], ref["tokens"], 64)
    assert ref["handoffs"] and ref["handoffs"][0]["page_copied"] > 0
    assert got["tokens"] == ref["tokens"]
    assert got["handoffs"] == ref["handoffs"]
    assert got["journals"] == ref["journals"]
    assert got["stats"] == ref["stats"]
