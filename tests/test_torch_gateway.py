"""The port's serving gateway (``repro_torch.runtime.gateway``) on the CPU.

Mirror: every test of ``tests/test_gateway.py``, run on the port with the
same assertions (``Hypervisor(device="cpu")``, ``Model(device="cpu")``).
Parity: one seeded multi-tenant scenario with a straggler migration through
the JAX package's gateway and the port's, compared on the token logs
(exactly), the wall-clock-free fields of every ``hv.log`` event, the
migrations and each tenant's ``tenant_status``.

Weights: reduced smollm-135m in fp32, the JAX init carried across
(``params_from_numpy``). Token logs are compared exactly; the premise, a
top-2 logit margin above 1e-3 at every generated position of the JAX run,
is asserted as in tests/test_torch_engine.py.
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
from repro.runtime import ServingGateway as JServingGateway
from repro_torch.configs import get_config, reduced
from repro_torch.core import ClusterSpec, Hypervisor, SliceState
from repro_torch.interop import params_from_numpy
from repro_torch.models import Model
from repro_torch.rc2f import AdmissionController, AdmissionError, ServiceQuota
from repro_torch.runtime import BatchingEngine, GatewayFleet, ServingGateway
from torch_parity import assert_margins

torch.set_num_threads(1)

# hv.log keys that read a clock (wall or program-configure time)
CLOCK_KEYS = ("t", "seconds", "latency_ms", "compile_s", "swap_s")


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


def _hv(n_nodes=1, devices_per_node=1, **kw):
    return Hypervisor(ClusterSpec(n_nodes=n_nodes,
                                  devices_per_node=devices_per_node),
                      device="cpu", **kw)


def _prompt(cfg, n=4, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, size=n).tolist()


# ---------------------------------------------------------------------------
# Request path: everything routed through the hypervisor
# ---------------------------------------------------------------------------

def test_every_request_bound_to_a_vslice(served_model):
    cfg, model, params = served_model
    hv = _hv()
    gw = ServingGateway(hv, model, params, n_slots=4, max_len=64)
    a = gw.open_session("alice", slots=2)
    b = gw.open_session("bob", slots=1)

    reqs = [gw.submit("alice" if i % 2 == 0 else "bob",
                      _prompt(cfg, seed=i), max_new_tokens=5)
            for i in range(6)]
    gw.run_until_idle()

    assert all(len(r.out_tokens) == 5 for r in reqs)
    serve = [e for e in hv.log if e["kind"] == "serve"]
    assert len(serve) == 6
    by_tenant = {e["request"]: e for e in serve}
    for r in reqs:
        e = by_tenant[r.request_id]
        assert e["tenant"] == r.tenant
        assert e["slice"] == (a if r.tenant == "alice" else b).slice_id
        assert e["new_tokens"] == 5
    assert hv.monitor.median_step_ms() is not None
    assert set(hv.monitor._step_times) == {a.slice_id, b.slice_id}
    assert hv.db.find_slice(a.slice_id).state == SliceState.RUNNING
    gw.close()
    assert all(u == 0.0 for u in hv.db.utilization().values())
    assert hv.admission.usage("alice")["slots"] == 0


def test_decode_program_shared_via_program_cache(served_model):
    """The decode program is configured once (full configuration) and every
    session/gateway after that is a PR cache hit; the engine runs the
    program the cache holds."""
    cfg, model, params = served_model
    hv = _hv()
    gw = ServingGateway(hv, model, params, n_slots=2, max_len=64)
    gw.open_session("a", slots=1)
    gw.open_session("b", slots=1)
    programs = [e for e in hv.log if e["kind"] == "program"]
    assert len(programs) == 2 and all(p["cache_hit"] for p in programs)
    assert {p["fingerprint"] for p in programs} == {gw.program_fingerprint}
    assert gw.engine._decode_fn is \
        hv.reconfig.cache.entry_for(gw.program_fingerprint).compiled
    gw2 = ServingGateway(hv, model, params, n_slots=2, max_len=64)
    up = [e for e in hv.log if e["kind"] == "gateway_up"]
    assert not up[0]["cache_hit"] and up[1]["cache_hit"]
    assert gw2.engine._decode_fn is gw.engine._decode_fn
    gw.close()


# ---------------------------------------------------------------------------
# Admission quotas
# ---------------------------------------------------------------------------

def test_session_quota_rejected_without_allocation(served_model):
    cfg, model, params = served_model
    hv = _hv()
    gw = ServingGateway(hv, model, params, n_slots=2, max_len=64)
    with pytest.raises(AdmissionError):
        gw.open_session("greedy", slots=4)      # baas quota: 2 slots
    assert all(u == 0.0 for u in hv.db.utilization().values())
    assert hv.admission.usage("greedy")["rejected"] == 1
    gw.open_session("greedy", slots=2)
    gw.close()


def test_request_quotas_per_service_model(served_model):
    cfg, model, params = served_model
    adm = AdmissionController({"baas": ServiceQuota(
        max_slots_per_tenant=2, max_inflight_requests=2,
        max_prompt_tokens=8, max_new_tokens=4)})
    hv = _hv(admission=adm)
    gw = ServingGateway(hv, model, params, n_slots=2, max_len=64)
    gw.open_session("t", slots=1)
    gw.submit("t", _prompt(cfg), max_new_tokens=4)
    gw.submit("t", _prompt(cfg), max_new_tokens=4)
    with pytest.raises(AdmissionError):        # in-flight ceiling
        gw.submit("t", _prompt(cfg), max_new_tokens=4)
    gw.run_until_idle()
    with pytest.raises(AdmissionError):        # prompt too long
        gw.submit("t", _prompt(cfg, n=9), max_new_tokens=4)
    with pytest.raises(AdmissionError):        # too many new tokens
        gw.submit("t", _prompt(cfg), max_new_tokens=5)
    gw.submit("t", _prompt(cfg), max_new_tokens=4)
    gw.run_until_idle()
    assert gw.session("t").served == 3
    gw.close()


def test_close_with_outstanding_requests_returns_quota(served_model):
    cfg, model, params = served_model
    hv = _hv()
    gw = ServingGateway(hv, model, params, n_slots=2, max_len=64)
    gw.open_session("t", slots=1)
    reqs = [gw.submit("t", _prompt(cfg, seed=i), max_new_tokens=4)
            for i in range(4)]
    gw.step()
    gw.close_session("t")
    gw.run_until_idle()
    assert hv.admission.usage("t")["inflight"] == 0
    assert sum(r.done.is_set() for r in reqs) == 4
    gw.open_session("t", slots=1)
    gw.submit("t", _prompt(cfg), max_new_tokens=4)
    gw.run_until_idle()
    gw.close()


def test_reopened_session_not_charged_for_orphan_requests(served_model):
    cfg, model, params = served_model
    hv = _hv()
    gw = ServingGateway(hv, model, params, n_slots=2, max_len=64)
    gw.open_session("t", slots=1)
    gw.submit("t", _prompt(cfg), max_new_tokens=6)
    gw.step()
    gw.close_session("t")
    new_sess = gw.open_session("t", slots=1)
    gw.run_until_idle()
    assert new_sess.served == 0 and new_sess.tokens_out == 0
    assert hv.admission.usage("t")["inflight"] == 0
    assert not any(e["kind"] == "serve" and e["slice"] == new_sess.slice_id
                   for e in hv.log)
    gw.submit("t", _prompt(cfg, seed=7), max_new_tokens=3)
    gw.run_until_idle()
    assert new_sess.served == 1
    gw.close()


def test_empty_prompt_rejected_before_quota(served_model):
    cfg, model, params = served_model
    hv = _hv()
    gw = ServingGateway(hv, model, params, n_slots=2, max_len=64)
    gw.open_session("t", slots=1)
    with pytest.raises(AdmissionError, match="empty prompt"):
        gw.submit("t", [], max_new_tokens=4)
    assert hv.admission.usage("t")["inflight"] == 0
    gw.submit("t", _prompt(cfg), max_new_tokens=4)
    gw.run_until_idle()
    assert gw.session("t").served == 1
    gw.close()


def test_request_exceeding_engine_max_len_rejected(served_model):
    cfg, model, params = served_model
    hv = _hv()
    gw = ServingGateway(hv, model, params, n_slots=2, max_len=32)
    gw.open_session("t", slots=1)
    with pytest.raises(AdmissionError, match="max_len"):
        gw.submit("t", _prompt(cfg, n=30), max_new_tokens=8)
    assert hv.admission.usage("t")["inflight"] == 0
    gw.close()


def test_external_migration_rebinds_session(served_model):
    cfg, model, params = served_model
    hv = _hv(n_nodes=2)
    gw = ServingGateway(hv, model, params, n_slots=2, max_len=64)
    hot = gw.open_session("hot", slots=1)
    cold = gw.open_session("cold", slots=1)
    old = hot.slice_id
    for _ in range(8):
        hv.monitor.record_step(hot.slice_id, 400.0)
        hv.monitor.record_step(cold.slice_id, 100.0)
    hv.migrate_stragglers()                    # not gw.rebalance()
    assert hot.slice_id != old
    gw.submit("hot", _prompt(cfg), max_new_tokens=3)
    gw.run_until_idle()
    assert gw.session("hot").served == 1
    gw.close()


def test_quota_usage_isolated_per_service_model():
    adm = AdmissionController()
    adm.admit_tenant("t", "raas", 2)
    adm.admit_tenant("t", "baas", 2)
    with pytest.raises(AdmissionError):
        adm.admit_tenant("t", "baas", 1)
    adm.release_tenant("t", "raas", 2)
    assert adm.usage("t", "raas")["slots"] == 0
    assert adm.usage("t", "baas")["slots"] == 2
    assert adm.usage("t")["slots"] == 2


def test_bad_slot_count_does_not_leak_quota(served_model):
    hv = _hv()
    with pytest.raises(ValueError):
        hv.open_serving_session("t", slots=3, service_model="rsaas")
    assert hv.admission.usage("t")["slots"] == 0
    hv.open_serving_session("t", slots=2, service_model="rsaas")


def test_gateway_close_deregisters_migration_listener(served_model):
    cfg, model, params = served_model
    hv = _hv()
    gw = ServingGateway(hv, model, params, n_slots=2, max_len=64)
    assert gw._on_migration in hv.migration_listeners
    gw.close()
    gw.close()                                  # idempotent
    assert gw._on_migration not in hv.migration_listeners


@pytest.mark.parametrize("front", [ServingGateway, GatewayFleet],
                         ids=["gateway", "fleet"])
@pytest.mark.parametrize("model_dev,hv_dev", [("meta", "cpu"),
                                              ("cpu", "cuda")],
                         ids=["model-elsewhere", "hypervisor-elsewhere"])
def test_model_off_the_hypervisor_device_refused(served_model, front,
                                                 model_dev, hv_dev):
    """The configured program places its arguments on the hypervisor's
    device; a model elsewhere would decode into throwaway cache copies, so
    it is refused before anything is configured or registered. (The
    second case sets the hypervisor's device by hand, so it runs without a
    card.)"""
    cfg, _, params = served_model
    hv = _hv()
    hv.reconfig.device = torch.device(hv_dev)
    with pytest.raises(ValueError, match=r"Hypervisor\(device=\.\.\.\)"):
        front(hv, Model(cfg, device=model_dev), params, n_slots=2,
              max_len=64)
    assert hv.migration_listeners == []
    assert len(hv.reconfig.cache) == 0
    assert not [e for e in hv.log if e["kind"] in ("gateway_up", "fleet_up")]


def test_submit_without_session_rejected(served_model):
    cfg, model, params = served_model
    hv = _hv()
    gw = ServingGateway(hv, model, params, n_slots=2, max_len=64)
    with pytest.raises(KeyError):
        gw.submit("nobody", _prompt(cfg))


# ---------------------------------------------------------------------------
# Slice-aware scheduling in the engine
# ---------------------------------------------------------------------------

def test_tenant_share_caps_concurrent_slots(served_model):
    cfg, model, params = served_model
    hv = _hv()
    gw = ServingGateway(hv, model, params, n_slots=4, max_len=64)
    gw.open_session("small", slots=1)
    for i in range(4):
        gw.submit("small", _prompt(cfg, seed=i), max_new_tokens=3)
    while gw.step():
        assert gw.engine.active_by_tenant().get("small", 0) <= 1
    assert gw.session("small").served == 4
    gw.close()


def test_round_robin_admission_across_tenants(served_model):
    cfg, model, params = served_model
    engine = BatchingEngine(model, params, n_slots=2, max_len=64)
    for i in range(2):
        engine.submit(_prompt(cfg, seed=i), max_new_tokens=3, tenant="a")
    for i in range(2):
        engine.submit(_prompt(cfg, seed=10 + i), max_new_tokens=3,
                      tenant="b")
    engine.step()
    assert engine.active_by_tenant() == {"a": 1, "b": 1}
    engine.run_until_idle()
    assert engine.queued_by_tenant() == {}


# ---------------------------------------------------------------------------
# Straggler telemetry -> migration -> session rebind
# ---------------------------------------------------------------------------

def test_hot_tenant_migrates_and_session_rebinds(served_model):
    cfg, model, params = served_model
    hv = _hv(n_nodes=2)
    gw = ServingGateway(hv, model, params, n_slots=4, max_len=64)
    hot = gw.open_session("hot", slots=1)
    cold = gw.open_session("cold", slots=1)
    old_slice, old_dev = hot.slice_id, hv.db.find_slice(hot.slice_id).device_id
    for _ in range(8):
        gw._on_step({"hot": 1}, 400.0)
        gw._on_step({"cold": 1}, 100.0)
    moved = gw.rebalance()
    assert moved and moved[0][0] == old_slice
    assert hot.slice_id != old_slice
    new_vs = hv.db.find_slice(hot.slice_id)
    assert new_vs.device_id != old_dev
    assert new_vs.owner == "hot"
    assert new_vs.program == gw.program_fingerprint
    gw._on_step({"hot": 1}, 50.0)
    assert hot.slice_id in hv.monitor._step_times
    gw.close()


# ---------------------------------------------------------------------------
# Parity with the JAX package's gateway
# ---------------------------------------------------------------------------

# (tenant, prompt length, seed, new tokens); "hot" migrates mid-decode
PARITY_REQS = [("alice", 5, 1, 6), ("hot", 17, 2, 8), ("bob", 9, 3, 5),
               ("alice", 12, 4, 7), ("hot", 3, 5, 6), ("bob", 20, 6, 4),
               ("alice", 7, 7, 5)]


def _gateway_scenario(gw_cls, hv, model, params, vocab, paged):
    gw = gw_cls(hv, model, params, n_slots=4, max_len=64, paged=paged)
    gw.open_session("alice", slots=2)
    hot = gw.open_session("hot", slots=1)
    cold = gw.open_session("bob", slots=1)
    reqs = [gw.submit(t, np.random.default_rng(seed).integers(
        0, vocab, size=n).tolist(), max_new_tokens=new)
        for t, n, seed, new in PARITY_REQS]
    for _ in range(3):
        gw.step()
    for _ in range(8):
        hv.monitor.record_step(hot.slice_id, 400.0)
        hv.monitor.record_step(cold.slice_id, 100.0)
    moved = gw.rebalance()
    assert gw.run_until_idle()
    out = dict(tokens=[list(r.out_tokens) for r in reqs],
               prompts=[list(r.prompt) for r in reqs],
               moved=moved, migrations=list(gw.migrations),
               status={t: gw.tenant_status(t)
                       for t in ("alice", "hot", "bob")})
    gw.close()
    out["log"] = [{k: v for k, v in e.items() if k not in CLOCK_KEYS}
                  for e in hv.log]
    return out


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_gateway_matches_reference(jax_model, served_model, paged):
    jmodel, jparams = jax_model
    cfg, model, params = served_model
    ref = _gateway_scenario(JServingGateway,
                            JHypervisor(JClusterSpec(n_nodes=2,
                                                     devices_per_node=1)),
                            jmodel, jparams, cfg.vocab_size, paged)
    got = _gateway_scenario(ServingGateway, _hv(n_nodes=2), model, params,
                            cfg.vocab_size, paged)
    # the premise of exact token comparison: clear top-2 margins (JAX)
    assert_margins(jmodel, jparams, ref["prompts"], ref["tokens"], 64)
    assert ref["moved"], "the straggler sweep must have migrated"
    assert got["tokens"] == ref["tokens"]
    assert got["moved"] == ref["moved"]
    assert got["migrations"] == ref["migrations"]
    assert got["status"] == ref["status"]
    assert got["log"] == ref["log"]
