"""The reference's scale-harness tests (``tests/test_scale_soak.py``) on the
port (``repro_torch.runtime.loadgen``), on the CPU: ``replay_trace``
determinism under the port's lifecycle sanitizer, the event-loop replay,
open-loop overload, and the smoke cell against the committed baseline
(``benchmarks/BENCH_scale_baseline.json``). The standing matrix runs in
``tests/test_torch_soak_matrix.py``, a file of its own.

Parity: the mini cell's records, lockstep and event loop, equal the JAX
package's records of the same cell, run live, as sorted JSON. A record is
a pure function of ``(trace, fleet, seed)``: arrivals and lengths come
from their own seeded streams, prompts are random tokens and no EOS is
set, so weights, width and dtype cannot reach it.

Weights: reduced smollm-135m in fp32, the JAX init carried across
(``params_from_numpy``).
"""
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.models import get_model as j_get_model
from repro.runtime import loadgen as j_loadgen
from repro_torch.analysis import sanitizer
from repro_torch.configs import get_config, reduced
from repro_torch.interop import params_from_numpy
from repro_torch.models import Model
from repro_torch.runtime.loadgen import (FleetSpec, TraceSpec, build_fleet,
                                         replay_trace, smoke_cell)
from soak_baseline import on_baseline_fields

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
torch.set_num_threads(1)

DEV = "cpu"


@pytest.fixture(autouse=True)
def _sanitized():
    """Every replay in this module runs with the port's lifecycle
    sanitizer ON, reset per test."""
    sanitizer.reset()
    sanitizer.enable()
    yield
    sanitizer.disable()


@pytest.fixture(scope="module")
def jax_model():
    jcfg = j_reduced(j_get_config("smollm-135m")).replace(dtype="float32")
    jmodel = j_get_model(jcfg)
    return jmodel, jmodel.init(jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def served_model(jax_model):
    cfg = reduced(get_config("smollm-135m")).replace(dtype="float32")
    params = params_from_numpy(jax.tree.map(np.asarray, jax_model[1]), cfg)
    return cfg, Model(cfg, device=DEV), params


# a deliberately small cell so the determinism test replays it twice fast
MINI_TRACE = TraceSpec(name="mini", horizon=20, base_rate=0.8,
                       burst_rate_mult=3.0, burst_on_mean=3.0,
                       burst_off_mean=6.0, diurnal_period=10,
                       diurnal_amp=0.6, tenants=3, zipf_s=1.2)
MINI_FLEET = FleetSpec(name="mini2", n_nodes=2, devices_per_node=1,
                       slo_p95_steps=16.0, device_draws=(1.0, 2.0))


def _strip_volatile(record):
    """There is nothing volatile to strip — records carry no timestamps
    by construction. Kept as the explicit place a timing field would be
    excluded if one were ever added; asserts the invariant meanwhile."""
    blob = json.dumps(record, sort_keys=True)
    assert '"t":' not in blob and "wall" not in blob
    return blob


def test_replay_records_bit_identical(served_model):
    _, model, params = served_model
    a = replay_trace(MINI_TRACE, MINI_FLEET, 5, model, params, chaos=True,
                     device=DEV)
    b = replay_trace(MINI_TRACE, MINI_FLEET, 5, model, params, chaos=True,
                     device=DEV)
    assert _strip_volatile(a) == _strip_volatile(b)
    assert a["metrics"]["completed"] > 0


def test_replay_seed_changes_trace_and_faults(served_model):
    _, model, params = served_model
    a = replay_trace(MINI_TRACE, MINI_FLEET, 5, model, params, chaos=True,
                     device=DEV)
    c = replay_trace(MINI_TRACE, MINI_FLEET, 6, model, params, chaos=True,
                     device=DEV)
    assert a["cell"] != c["cell"]
    assert (a["faults"], a["metrics"]) != (c["faults"], c["metrics"])


def test_smoke_cell_matches_committed_baseline(served_model):
    """The reference's gate (goodput within the benchmark's 10%) and, on
    top, the record itself: equal to the committed one on every field
    the baseline holds (less the two fields the reference added after
    the baseline was written,
    ``soak_baseline.on_baseline_fields``)."""
    from benchmarks.scale_soak import BASELINE, check_regression
    _, model, params = served_model
    trace, fleet, seed = smoke_cell()
    rec = replay_trace(trace, fleet, seed, model, params, chaos=False,
                       device=DEV)
    assert os.path.exists(BASELINE), "committed baseline missing"
    assert check_regression([rec], BASELINE) == []
    with open(BASELINE) as f:
        base = json.load(f)["records"]
    assert rec["cell"] in [r["cell"] for r in base]
    committed = next(r for r in base if r["cell"] == rec["cell"])
    assert json.dumps(on_baseline_fields(rec, committed), sort_keys=True) \
        == json.dumps(committed, sort_keys=True)


def test_event_loop_replay_bit_identical_and_tagged(served_model):
    _, model, params = served_model
    a = replay_trace(MINI_TRACE, MINI_FLEET, 5, model, params, chaos=True,
                     loop="event", device=DEV)
    b = replay_trace(MINI_TRACE, MINI_FLEET, 5, model, params, chaos=True,
                     loop="event", device=DEV)
    assert _strip_volatile(a) == _strip_volatile(b)
    assert a["cell"]["loop"] == "event"
    assert a["metrics"]["completed"] > 0 and a["faults"]
    lockstep = replay_trace(MINI_TRACE, MINI_FLEET, 5, model, params,
                            chaos=True, device=DEV)
    assert "loop" not in lockstep["cell"]
    assert a["cell"] != lockstep["cell"]


def test_open_loop_overload_sheds_not_stalls(served_model):
    _, model, params = served_model
    hot = TraceSpec(name="hot", horizon=16, base_rate=6.0,
                    burst_rate_mult=1.0, tenants=2, zipf_s=1.0)
    tiny = FleetSpec(name="tiny", n_nodes=1, devices_per_node=1,
                     n_slots=2, slo_p95_steps=None, autoscale_every=0)
    rec = replay_trace(hot, tiny, 0, model, params, chaos=False,
                       drain_slack=64, device=DEV)
    m = rec["metrics"]
    assert m["rejected"] > 0, "open-loop overload must shed load"
    assert m["completed"] > 0
    assert m["rounds"] <= 16 + 64


# ---------------------------------------------------------------------------
# Parity with the JAX package, live
# ---------------------------------------------------------------------------

def _jax_spec(cls, spec):
    return cls(**{k: getattr(spec, k) for k in spec.__dataclass_fields__})


@pytest.mark.parametrize("loop", ["event", "lockstep"])
def test_mini_cell_record_equals_reference(served_model, jax_model, loop):
    """MINI_TRACE / MINI_FLEET, seed 5, chaos: the port's record equals
    the JAX package's, field for field."""
    _, model, params = served_model
    jmodel, jparams = jax_model
    got = replay_trace(MINI_TRACE, MINI_FLEET, 5, model, params, chaos=True,
                       loop=loop, device=DEV)
    ref = j_loadgen.replay_trace(_jax_spec(j_loadgen.TraceSpec, MINI_TRACE),
                                 _jax_spec(j_loadgen.FleetSpec, MINI_FLEET),
                                 5, jmodel, jparams, chaos=True, loop=loop)
    assert ref["faults"] and ref["metrics"]["completed"] > 0
    assert json.dumps(got, sort_keys=True) == json.dumps(ref, sort_keys=True)


@pytest.mark.parametrize("width,vocab", [(64, 49152), (256, 512)])
def test_record_does_not_depend_on_width_or_dtype(served_model, width,
                                                  vocab):
    """The premise the card phases lean on: another width, in bf16, with
    its own seeded weights, replays the mini cell (event loop, chaos) to
    the record of the fp32 model above; so does the full model's
    vocabulary (prompt tokens are drawn from a stream of their own)."""
    _, model, params = served_model
    base = reduced(get_config("smollm-135m"))
    cfg = base.replace(d_model=width, d_ff=2 * width, vocab_size=vocab,
                       head_dim=width // base.n_heads)
    wmodel = Model(cfg, device=DEV)
    wparams = wmodel.init(torch.Generator().manual_seed(width))
    assert cfg.dtype == "bfloat16"
    got = replay_trace(MINI_TRACE, MINI_FLEET, 5, wmodel, wparams,
                       chaos=True, loop="event", device=DEV)
    ref = replay_trace(MINI_TRACE, MINI_FLEET, 5, model, params, chaos=True,
                       loop="event", device=DEV)
    assert json.dumps(got, sort_keys=True) == json.dumps(ref, sort_keys=True)


def test_model_off_the_fleet_device_refused(served_model):
    """The hypervisor takes ``device``; a model elsewhere is refused by the
    fleet before any session opens (its program would decode into
    throwaway cache copies)."""
    cfg, _, params = served_model
    with pytest.raises(ValueError, match=r"Hypervisor\(device=\.\.\.\)"):
        replay_trace(MINI_TRACE, MINI_FLEET, 5, Model(cfg, device="meta"),
                     params, device=DEV)
    with pytest.raises(ValueError, match=r"Hypervisor\(device=\.\.\.\)"):
        build_fleet(MINI_FLEET, Model(cfg, device="meta"), params, 5,
                    device=DEV)
