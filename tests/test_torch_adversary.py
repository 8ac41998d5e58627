"""The reference's hostile-tenant scenario suite (``tests/test_adversary.py``)
on the port (``repro_torch.runtime.adversary``), on the CPU, with the same
constants (``FAIRNESS_FACTOR``, ``SLACK_STEPS``, ``PATIENCE_STEPS``):

  * the victim's p95 latency stays within the fairness bound of a solo
    run of the bit-identical victim workload, and no victim request
    starves past the patience bound;
  * pool conservation + cross-tenant page disjointness after EVERY step
    (``check_isolation`` inside the runner);
  * zero-on-free at the device: at teardown every free-list page reads as
    zeros (pos -1, scales 1) through the torch pools;
  * the admission token bucket sheds a flood on the injected FakeClock;
  * tenant-scoped status views leak nothing about co-tenants.

Parity: every ``ScenarioReport`` of ``SCENARIOS`` equals the JAX
package's. The JAX package's reports are committed as plain JSON in
``tests/data/torch_adversary_reference.json`` (``chip_smoke.py`` holds the
card's reports against it); ``write_reference`` regenerates the file:

    PYTHONPATH=src:tests python -c \\
        "import test_torch_adversary as t; t.write_reference()"

and ``test_reference_file_is_current`` re-derives it from the JAX package
on every run, so the file cannot drift. A report is a pure function of
(seed, behavior): prompts are random tokens from seeded streams, no EOS
is set, so weights, width and dtype cannot reach it
(``test_reports_do_not_depend_on_width``).

Weights: reduced smollm-135m in fp32, the JAX init carried across
(``params_from_numpy``).
"""
import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.analysis import sanitizer as j_sanitizer
from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.models import get_model as j_get_model
from repro.runtime import adversary as j_adversary
from repro_torch.analysis import sanitizer
from repro_torch.configs import get_config, reduced
from repro_torch.core import ClusterSpec, Hypervisor, MonitorConfig
from repro_torch.interop import params_from_numpy
from repro_torch.models import Model
from repro_torch.rc2f.admission import DEFAULT_QUOTAS
from repro_torch.runtime import adversary
from repro_torch.runtime.adversary import (HOSTILE, VICTIM, CancelChurn,
                                           PageSquat, PrefixProbe,
                                           PromptFlood,
                                           assert_free_pages_zeroed,
                                           run_scenario)
from repro_torch.runtime.faults import FakeClock
from repro_torch.runtime.gateway import ServingGateway

torch.set_num_threads(1)

DEV = "cpu"
REFERENCE = os.path.join(os.path.dirname(__file__), "data",
                         "torch_adversary_reference.json")

# Fairness bound: under ANY of the seeded attacks the victim's p95 may
# not exceed factor x solo-baseline p95 + slack steps (absolute slack
# absorbs the +-1-step quantization of tiny baselines).
FAIRNESS_FACTOR = 2.0
SLACK_STEPS = 6
PATIENCE_STEPS = 40          # no victim request may starve past this

# (behavior class name or None for the solo baseline, its kwargs, seed),
# each run at run_scenario's defaults (4 slots, max_len 64, page 8, 48
# rounds): the solo baseline and the four behaviors at seed 0, plus one
# behavior at a second seed
SCENARIOS = [(None, {}, 0), ("PromptFlood", {}, 0), ("PageSquat", {}, 0),
             ("CancelChurn", {}, 0), ("PrefixProbe", {}, 0),
             ("PageSquat", {"keep": 6}, 2)]
# The vocabulary sizes the reference reports are taken at: the reduced
# fixture's, and the full smollm-135m's (chip_smoke.py's). A report does
# depend on the vocabulary: ``randrange(vocab)`` consumes a vocabulary-
# dependent number of random bits (rejection sampling), and the hostile
# stream draws PromptFlood's prompt lengths from the same generator as its
# tokens. Width, dtype and weights cannot reach a report.
VOCABS = {512: SCENARIOS, 49152: SCENARIOS[:5]}


def _behavior(module, name, kwargs):
    return None if name is None else getattr(module, name)(**kwargs)


def _scenario_id(entry):
    name, kwargs, seed = entry
    return f"{name or 'solo'}-seed{seed}"


def reference_reports():
    """The JAX package's reports of ``SCENARIOS`` at each vocabulary size of
    ``VOCABS`` (reduced smollm-135m, fp32, ``PRNGKey(0)`` init) as plain
    JSON-ready dicts."""
    out = []
    for vocab, scenarios in VOCABS.items():
        jcfg = j_reduced(j_get_config("smollm-135m")).replace(
            dtype="float32", vocab_size=vocab)
        jmodel = j_get_model(jcfg)
        jparams = jmodel.init(jax.random.PRNGKey(0))
        for name, kwargs, seed in scenarios:
            j_sanitizer.reset()
            report = j_adversary.run_scenario(
                jmodel, jparams,
                behavior=_behavior(j_adversary, name, kwargs), seed=seed)
            out.append({"vocab_size": vocab, "behavior": name,
                        "kwargs": kwargs, "seed": seed,
                        "report": json.loads(json.dumps(
                            dataclasses.asdict(report)))})
    return {"about": "ScenarioReports of repro.runtime.adversary."
                     "run_scenario at its defaults, by vocabulary size, "
                     "written by tests/test_torch_adversary.py::"
                     "write_reference",
            "scenarios": out}


def _reference(committed, vocab, entry):
    return next(e["report"] for e in committed["scenarios"]
                if (e["vocab_size"], e["behavior"], e["kwargs"], e["seed"])
                == (vocab,) + tuple(entry))


def write_reference(path=REFERENCE):
    with open(path, "w") as f:
        json.dump(reference_reports(), f, indent=1, sort_keys=True)
        f.write("\n")


def _as_json(report):
    return json.dumps(dataclasses.asdict(report), sort_keys=True)


@pytest.fixture(autouse=True)
def _sanitizer_reset():
    sanitizer.reset()
    yield


@pytest.fixture(scope="module")
def served_model():
    jcfg = j_reduced(j_get_config("smollm-135m")).replace(dtype="float32")
    jparams = j_get_model(jcfg).init(jax.random.PRNGKey(0))
    cfg = reduced(get_config("smollm-135m")).replace(dtype="float32")
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg)
    return cfg, Model(cfg, device=DEV), params


@pytest.fixture(scope="module")
def solo_baseline(served_model):
    """The attacker-free run every scenario is judged against."""
    cfg, model, params = served_model
    report = run_scenario(model, params, behavior=None, seed=0, device=DEV)
    assert report.completed.get(VICTIM, 0) > 0
    return report


@pytest.fixture(scope="module")
def committed():
    with open(REFERENCE) as f:
        return json.load(f)


def test_solo_baseline_sane(solo_baseline):
    r = solo_baseline
    assert r.completed[VICTIM] == r.submitted[VICTIM]
    assert not r.shed and not r.cancelled
    assert r.max_latency(VICTIM) <= PATIENCE_STEPS
    assert r.pages_scrubbed > 0
    assert r.free_pages_checked > 0


@pytest.mark.parametrize("behavior", [PromptFlood(), PageSquat(),
                                      CancelChurn(), PrefixProbe()],
                         ids=lambda b: b.name)
def test_victim_p95_bounded_under_attack(served_model, solo_baseline,
                                         behavior):
    cfg, model, params = served_model
    r = run_scenario(model, params, behavior=behavior, seed=0, device=DEV)
    assert r.completed[VICTIM] == solo_baseline.submitted[VICTIM], \
        "the attack shed or starved victim requests"
    assert r.max_latency(VICTIM) <= PATIENCE_STEPS
    bound = FAIRNESS_FACTOR * solo_baseline.p95(VICTIM) + SLACK_STEPS
    assert r.p95(VICTIM) <= bound, \
        f"{behavior.name}: victim p95 {r.p95(VICTIM)} exceeds bound " \
        f"{bound} (solo p95 {solo_baseline.p95(VICTIM)})"
    assert r.free_pages_checked > 0


def test_prompt_flood_self_penalizes(served_model, solo_baseline):
    cfg, model, params = served_model
    r = run_scenario(model, params, behavior=PromptFlood(burst=4), seed=1,
                     device=DEV)
    assert r.shed.get(HOSTILE, 0) > 0, "nothing shed — quota not engaged"
    assert r.completed[VICTIM] == r.submitted[VICTIM]
    assert r.goodput(VICTIM) == pytest.approx(
        solo_baseline.goodput(VICTIM))


def test_page_squat_capped_by_grant(served_model):
    cfg, model, params = served_model
    r = run_scenario(model, params, behavior=PageSquat(keep=6), seed=2,
                     device=DEV)
    assert r.completed[VICTIM] == r.submitted[VICTIM]
    assert r.max_latency(VICTIM) <= PATIENCE_STEPS


def test_rate_limit_sheds_flood_on_fake_clock(served_model):
    cfg, model, params = served_model
    quota = dataclasses.replace(DEFAULT_QUOTAS["baas"],
                                rate_limit_rps=1.0, rate_limit_burst=2)
    r = run_scenario(model, params, behavior=PromptFlood(burst=4), seed=0,
                     quota=quota, device=DEV)
    assert r.rate_limited > 0
    assert r.shed.get(HOSTILE, 0) >= r.rate_limited
    assert not r.shed.get(VICTIM)
    assert r.completed[VICTIM] == r.submitted[VICTIM]


def test_cancel_churn_settles_and_scrubs(served_model):
    cfg, model, params = served_model
    r = run_scenario(model, params, behavior=CancelChurn(burst=3), seed=3,
                     device=DEV)
    assert r.cancelled.get(HOSTILE, 0) > 0
    assert r.pages_scrubbed > 0
    assert r.completed[VICTIM] == r.submitted[VICTIM]
    assert r.free_pages_checked > 0


def test_scenario_reports_are_deterministic(served_model):
    cfg, model, params = served_model
    a = run_scenario(model, params, behavior=CancelChurn(), seed=7,
                     rounds=16, device=DEV)
    b = run_scenario(model, params, behavior=CancelChurn(), seed=7,
                     rounds=16, device=DEV)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)


def test_tenant_status_hides_cotenants(served_model):
    cfg, model, params = served_model
    clock = FakeClock()
    hv = Hypervisor(ClusterSpec(n_nodes=1, devices_per_node=1),
                    MonitorConfig(heartbeat_interval_s=1.0,
                                  heartbeat_deadline_s=2.5), clock=clock,
                    device=DEV)
    gw = ServingGateway(hv, model, params, n_slots=4, max_len=64,
                        paged=True, page_size=8)
    gw.open_session(VICTIM, slots=2)
    gw.open_session(HOSTILE, slots=2)
    rng = np.random.default_rng(0)
    reqs = [gw.submit(t, rng.integers(0, cfg.vocab_size, size=6).tolist(),
                      max_new_tokens=4) for t in (VICTIM, HOSTILE)]
    for _ in range(3):
        gw.step()

    ts = gw.tenant_status(VICTIM)
    blob = json.dumps(ts)
    assert HOSTILE not in blob, "tenant view names a co-tenant"
    for sid in ts["slices"]:
        assert hv.db.find_slice(sid).owner == VICTIM
    for leak in ("median_step_ms", "traffic", "page_grants", "scrub",
                 "utilization"):
        assert leak not in ts
    assert ts["session"]["slots"] == 2
    assert ts["quota"]["inflight"] >= 0
    assert ts["pages_held"] == gw.engine.pool.tenant_pages(VICTIM)

    op = gw.stats()
    assert VICTIM in op and HOSTILE in op
    mon = hv.monitor.status()
    assert "pages" in mon and "scrub" in mon and "median_step_ms" in mon
    owners = {s.owner for d in hv.db.devices.values()
              for s in d.slices.values()}
    assert {VICTIM, HOSTILE} <= owners

    while not all(r.done.is_set() for r in reqs):
        gw.step()
    assert_free_pages_zeroed(gw.engine)
    gw.close()


# ---------------------------------------------------------------------------
# The zero-on-free readback over the torch pools
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quant,leaf", [
    (False, "k"), (False, "v"), (False, "pos"),
    (True, "k"), (True, "v"), (True, "pos"), (True, "scale")])
def test_free_page_residue_is_caught(served_model, quant, leaf):
    """A free page holding anything but the init state fails the check,
    naming the page and the kind of residue; a clean pool passes with
    every free page counted."""
    cfg, model, params = served_model
    if quant:
        model = Model(cfg.replace(kv_quant=True), device=DEV)
    from repro_torch.runtime import BatchingEngine
    eng = BatchingEngine(model, params, n_slots=2, max_len=64, paged=True,
                         page_size=8)
    eng.submit(list(range(1, 20)), max_new_tokens=4)
    assert eng.run_until_idle() is True
    n = assert_free_pages_zeroed(eng)
    assert n == eng.pool.total_pages == len(eng.pool._free)
    page = sorted(eng.pool._free)[3]
    site = next(adversary._site_caches(eng.caches))
    name = {"scale": "k_scale"}.get(leaf, leaf)
    site[name][-1, page, 2].flatten()[0] = 7
    what = {"pos": "pos != -1", "scale": "quant scale != 1"}.get(
        leaf, "nonzero K/V residue")
    with pytest.raises(AssertionError, match=rf"\[{page}\].*{what}"):
        assert_free_pages_zeroed(eng)


# ---------------------------------------------------------------------------
# Parity with the JAX package
# ---------------------------------------------------------------------------

def test_reference_file_is_current(committed):
    """The committed reference is what the JAX package reports today."""
    assert json.dumps(reference_reports(), sort_keys=True) == \
        json.dumps(committed, sort_keys=True)


@pytest.mark.parametrize("entry", SCENARIOS, ids=_scenario_id)
def test_report_equals_reference(served_model, committed, entry):
    cfg, model, params = served_model
    name, kwargs, seed = entry
    ref = _reference(committed, cfg.vocab_size, entry)
    r = run_scenario(model, params, behavior=_behavior(adversary, name,
                                                       kwargs),
                     seed=seed, device=DEV)
    assert r.free_pages_checked > 0
    assert _as_json(r) == json.dumps(ref, sort_keys=True)


@pytest.mark.parametrize("width,vocab", [(64, 49152), (256, 49152),
                                         (256, 512)])
def test_reports_do_not_depend_on_width(committed, width, vocab):
    """The premise ``chip_smoke.py`` leans on: a bf16 model of another
    width, with its own seeded weights, reports what the JAX package
    reports at the same vocabulary size, for every scenario taken at
    that size (the full model's vocabulary included)."""
    base = reduced(get_config("smollm-135m"))
    cfg = base.replace(d_model=width, d_ff=2 * width, vocab_size=vocab,
                       head_dim=width // base.n_heads)
    assert cfg.dtype == "bfloat16"
    model = Model(cfg, device=DEV)
    params = model.init(torch.Generator().manual_seed(width))
    for entry in VOCABS[vocab][:5]:
        name, kwargs, seed = entry
        r = run_scenario(model, params,
                         behavior=_behavior(adversary, name, kwargs),
                         seed=seed, device=DEV)
        assert _as_json(r) == json.dumps(_reference(committed, vocab, entry),
                                         sort_keys=True), entry


def test_reports_depend_on_the_vocabulary(committed):
    """Why the reference holds two vocabulary sizes: the flood's report
    differs between them, the victim-only solo run's does not."""
    assert _reference(committed, 512, SCENARIOS[1]) != \
        _reference(committed, 49152, SCENARIOS[1])
    assert _reference(committed, 512, SCENARIOS[0]) == \
        _reference(committed, 49152, SCENARIOS[0])


def test_model_off_the_scenario_device_refused(served_model):
    cfg, _, params = served_model
    with pytest.raises(ValueError, match=r"Hypervisor\(device=\.\.\.\)"):
        run_scenario(Model(cfg, device="meta"), params, device=DEV)
