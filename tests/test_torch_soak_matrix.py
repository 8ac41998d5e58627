"""The standing soak matrix on the port (the reference's
``tests/test_scale_soak.py::test_soak_matrix_green``) and its 13 pinned
records: ``smoke_cell()`` and ``SoakMatrix(preset_traces(),
preset_fleets(), seeds=[0, 1, 2], chaos=True)``, replayed through the
port's fleet on the CPU, under the port's lifecycle sanitizer.

Each record must equal
  * the committed ``benchmarks/BENCH_scale_baseline.json`` (the
    reference's own pinned output), as sorted JSON, on every field the
    baseline holds. The baseline was written before the reference's
    event-driven dataplane added two fields to every record
    (``fleet_spec.device_speeds`` and ``metrics.per_device_steps``); the
    port's record must hold exactly those two on top;
  * the JAX package's record of the same cell, run live, in full.

A file of its own: the driver distributes test files whole over its
workers, and this one replays 13 cells twice (port and reference).
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.core.reconfig import ProgramCache as JProgramCache
from repro.core.reconfig import Reconfigurator as JReconfigurator
from repro.models import get_model as j_get_model
from repro.runtime import loadgen as j_loadgen
from repro_torch.analysis import sanitizer
from repro_torch.configs import get_config, reduced
from repro_torch.core.reconfig import ProgramCache, Reconfigurator
from repro_torch.interop import params_from_numpy
from repro_torch.models import Model
from repro_torch.runtime.loadgen import (SoakMatrix, preset_fleets,
                                         preset_traces, replay_trace,
                                         smoke_cell)
from soak_baseline import on_baseline_fields

torch.set_num_threads(1)

DEV = "cpu"
BASELINE = os.path.join(os.path.dirname(__file__), "..", "benchmarks",
                        "BENCH_scale_baseline.json")
def _committed():
    with open(BASELINE) as f:
        return json.load(f)["records"]


def _matrix():
    return SoakMatrix(preset_traces(), preset_fleets(), seeds=[0, 1, 2],
                      chaos=True)


@pytest.fixture(scope="module")
def jax_model():
    jcfg = j_reduced(j_get_config("smollm-135m")).replace(dtype="float32")
    jmodel = j_get_model(jcfg)
    return jmodel, jmodel.init(jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def port_records(jax_model):
    """The smoke cell, then the 12 matrix cells, replayed on the port with
    the sanitizer on (every request/slot/page/device/journal transition
    checked)."""
    cfg = reduced(get_config("smollm-135m")).replace(dtype="float32")
    params = params_from_numpy(jax.tree.map(np.asarray, jax_model[1]), cfg)
    model = Model(cfg, device=DEV)
    sanitizer.reset()
    sanitizer.enable()
    try:
        trace, fleet, seed = smoke_cell()
        smoke = replay_trace(trace, fleet, seed, model, params, chaos=False,
                             device=DEV)
        records = _matrix().run(
            model, params, reconfig=Reconfigurator(ProgramCache(),
                                                   device=DEV), device=DEV)
    finally:
        sanitizer.disable()
    return [smoke] + records


def test_soak_matrix_green(port_records):
    """The reference's matrix test on the port: 12 cells, every arrival
    accounted for, faults injected, the fault schedule seed-dependent."""
    records = port_records[1:]
    assert len(records) == 12
    for rec in records:
        m = rec["metrics"]
        assert (m["completed"] + m["cancelled"] + m["incomplete"]
                + m["rejected"] == m["arrivals"]), rec["cell"]
        assert m["tokens_out"] > 0 and m["goodput_tokens_per_round"] > 0
        assert m["energy_device_steps"] > 0
        assert 1 <= m["peak_active_devices"] \
            <= rec["fleet_spec"]["n_nodes"] \
            * rec["fleet_spec"]["devices_per_node"]
        lat = m["latency_rounds"]
        assert lat["p50"] <= lat["p95"] <= lat["p99"] <= lat["max"]
        assert rec["faults"], "chaos cells must actually inject faults"
    by_seed = {}
    for rec in records:
        by_seed.setdefault(rec["cell"]["seed"], set()).add(
            json.dumps(rec["faults"]))
    assert len({frozenset(v) for v in by_seed.values()}) > 1


def test_preset_records_equal_committed_baseline(port_records):
    committed = _committed()
    assert len(committed) == 13
    assert [r["cell"] for r in port_records] == [r["cell"] for r in committed]
    for rec, base in zip(port_records, committed):
        assert json.dumps(on_baseline_fields(rec, base), sort_keys=True) \
            == json.dumps(base, sort_keys=True), rec["cell"]


def test_preset_records_equal_reference(port_records, jax_model):
    """The same 13 cells through the JAX package's fleet: every field of
    every record equal, the two the baseline lacks included."""
    jmodel, jparams = jax_model
    trace, fleet, seed = j_loadgen.smoke_cell()
    refs = [j_loadgen.replay_trace(trace, fleet, seed, jmodel, jparams,
                                   chaos=False)]
    refs += j_loadgen.SoakMatrix(
        j_loadgen.preset_traces(), j_loadgen.preset_fleets(),
        seeds=[0, 1, 2], chaos=True).run(
            jmodel, jparams, reconfig=JReconfigurator(JProgramCache()))
    assert len(refs) == len(port_records) == 13
    for rec, ref in zip(port_records, refs):
        assert json.dumps(rec, sort_keys=True) == \
            json.dumps(ref, sort_keys=True), rec["cell"]


def test_on_baseline_fields_refuses_other_differences():
    """The cut drops only the two named fields: a record with any other
    extra key, or missing one of them, is refused."""
    base = _committed()[0]
    rec = json.loads(json.dumps(base))
    rec["fleet_spec"]["device_speeds"] = []
    rec["metrics"]["per_device_steps"] = {}
    assert on_baseline_fields(rec, base) == base
    rec["metrics"]["extra"] = 1
    with pytest.raises(AssertionError):
        on_baseline_fields(rec, base)
    del rec["metrics"]["extra"]
    del rec["metrics"]["per_device_steps"]
    with pytest.raises(AssertionError):
        on_baseline_fields(rec, base)
