"""The reference's trace-generator tests (``tests/test_loadgen.py``) on the
port (``repro_torch.runtime.loadgen``), with the same specs, seeds and
bounds: the hypothesis sweeps over spec space and the fixed seeded sweeps.
Properties:

  * arrival steps are non-decreasing and inside ``[0, horizon)``;
  * every prompt length / output budget is >= 1 and clamped to its max;
  * identical ``TraceSpec`` + seed => bit-identical trace; different
    seeds diverge;
  * observed tenant shares track the spec's Zipf weights (hot-first);
  * ``TraceSpec`` round-trips through ``dataclasses.asdict``.

Parity: ``synthesize`` gives the JAX package's arrival list, arrival for
arrival, for the pinned presets and the property specs at seeds 0-4, and
the presets themselves serialize to the reference's.
"""
import dataclasses

from hypothesis import given, settings
from hypothesis import strategies as st

import pytest
import torch

from repro.runtime import loadgen as j_loadgen
from repro_torch.runtime.faults import seeded_rng
from repro_torch.runtime.loadgen import (Arrival, TraceSpec, _poisson,
                                         percentile, preset_fleets,
                                         preset_traces, smoke_cell,
                                         synthesize, tenant_shares)

torch.set_num_threads(1)


def _spec(**kw):
    base = dict(name="prop", horizon=32, base_rate=1.0,
                burst_rate_mult=3.0, burst_on_mean=4.0, burst_off_mean=8.0,
                diurnal_period=16, diurnal_amp=0.5, tenants=4, zipf_s=1.1,
                prompt_len_max=12, out_tokens_max=12)
    base.update(kw)
    return TraceSpec(**base)


def _check_wellformed(spec, arrivals):
    last = 0
    for a in arrivals:
        assert isinstance(a, Arrival)
        assert 0 <= a.step < spec.horizon
        assert a.step >= last, "arrival steps must be non-decreasing"
        last = a.step
        assert 1 <= a.prompt_len <= spec.prompt_len_max
        assert 1 <= a.max_new_tokens <= spec.out_tokens_max
        assert a.tenant in spec.tenant_ids()


# ---------------------------------------------------------------------------
# hypothesis sweep over spec space
# ---------------------------------------------------------------------------
@given(seed=st.integers(min_value=0, max_value=2 ** 31 - 1),
       horizon=st.integers(min_value=1, max_value=64),
       base_rate=st.floats(min_value=0.0, max_value=20.0),
       burst_mult=st.floats(min_value=1.0, max_value=8.0),
       diurnal_amp=st.floats(min_value=0.0, max_value=1.0),
       tenants=st.integers(min_value=1, max_value=12),
       zipf_s=st.floats(min_value=0.0, max_value=2.5))
@settings(max_examples=60, deadline=None)
def test_trace_wellformed_prop(seed, horizon, base_rate, burst_mult,
                               diurnal_amp, tenants, zipf_s):
    spec = _spec(horizon=horizon, base_rate=base_rate,
                 burst_rate_mult=burst_mult, diurnal_amp=diurnal_amp,
                 tenants=tenants, zipf_s=zipf_s)
    arrivals = synthesize(spec, seed)
    _check_wellformed(spec, arrivals)
    # bit-identical replay of the same (spec, seed)
    assert synthesize(spec, seed) == arrivals


@given(seed=st.integers(min_value=0, max_value=2 ** 31 - 1))
@settings(max_examples=30, deadline=None)
def test_trace_seed_determinism_prop(seed):
    spec = _spec()
    a, b = synthesize(spec, seed), synthesize(spec, seed)
    assert a == b


# ---------------------------------------------------------------------------
# fixed seeded sweeps (always run)
# ---------------------------------------------------------------------------
def test_trace_wellformed_seeded():
    for seed in range(12):
        spec = _spec(tenants=1 + seed % 5, base_rate=0.2 * (1 + seed))
        _check_wellformed(spec, synthesize(spec, seed))


def test_trace_bit_identical_and_seed_sensitive():
    spec = _spec()
    assert synthesize(spec, 7) == synthesize(spec, 7)
    # a different seed must (overwhelmingly) produce a different trace
    assert synthesize(spec, 7) != synthesize(spec, 8)
    # so must a different spec under the same seed
    assert synthesize(spec, 7) != synthesize(
        dataclasses.replace(spec, base_rate=spec.base_rate * 2), 7)


def test_zipf_shares_within_tolerance():
    """Observed tenant shares track the spec's Zipf weights: a long,
    dense trace pins each share within +/-0.05 absolute of its expected
    weight, and the hot-first ordering holds."""
    spec = _spec(name="zipf", horizon=400, base_rate=8.0,
                 burst_rate_mult=1.0, diurnal_amp=0.0, tenants=5,
                 zipf_s=1.2)
    arrivals = synthesize(spec, 3)
    assert len(arrivals) > 2000
    shares = tenant_shares(arrivals)
    for t, w in zip(spec.tenant_ids(), spec.zipf_weights()):
        assert abs(shares.get(t, 0.0) - w) < 0.05, (t, shares.get(t), w)
    assert shares["t0"] > shares["t4"], "hot tenant must dominate the tail"


def test_poisson_mean_tracks_lambda():
    """The chunked Knuth sampler's mean tracks lambda, including rates
    far beyond a single exp(-lam) underflow chunk."""
    for lam in (0.5, 3.0, 25.0):
        rng = seeded_rng(11)
        n = 4000
        mean = sum(_poisson(rng, lam) for _ in range(n)) / n
        assert abs(mean - lam) < 0.1 * lam + 0.05, (lam, mean)
    assert _poisson(seeded_rng(0), 0.0) == 0


def test_diurnal_modulation_shifts_mass():
    """With a strong diurnal sinusoid, the first half-period (rate scaled
    up) must carry visibly more arrivals than the second (scaled down)."""
    spec = _spec(name="diurnal", horizon=64, base_rate=4.0,
                 burst_rate_mult=1.0, diurnal_period=64, diurnal_amp=0.9,
                 tenants=2)
    arrivals = synthesize(spec, 5)
    first = len([a for a in arrivals if a.step < 32])
    second = len(arrivals) - first
    assert first > 1.5 * second, (first, second)


def test_tracespec_asdict_roundtrip():
    spec = _spec(name="rt", tenants=3)
    d = dataclasses.asdict(spec)
    assert TraceSpec(**d) == spec


def test_percentile_nearest_rank():
    xs = list(range(1, 101))
    assert percentile(xs, 50) == 50.0
    assert percentile(xs, 95) == 95.0
    assert percentile(xs, 99) == 99.0
    assert percentile([], 95) is None
    assert percentile([7], 99) == 7.0


def test_lognormal_lengths_clamped():
    spec = _spec(name="fat", horizon=80, base_rate=4.0,
                 prompt_len_max=6, out_tokens_max=4)
    arrivals = synthesize(spec, 9)
    assert arrivals, "trace must not be empty at rate 4"
    assert max(a.prompt_len for a in arrivals) <= 6
    assert max(a.max_new_tokens for a in arrivals) <= 4
    assert min(a.prompt_len for a in arrivals) >= 1
    assert min(a.max_new_tokens for a in arrivals) >= 1
    # the clamp actually binds somewhere on a fat-tailed draw this long
    assert any(a.prompt_len == 6 for a in arrivals)


def test_large_trace_synthesis_scales():
    """The generator is used for million-session traces offline; keep a
    bounded-size canary in tier-1 — ~60k arrivals must stay well-formed
    and cheap (pure python, ~5 rng draws per arrival)."""
    spec = _spec(name="mega", horizon=2000, base_rate=30.0,
                 diurnal_period=500, tenants=100, zipf_s=1.1)
    arrivals = synthesize(spec, 1)
    assert len(arrivals) > 40_000
    _check_wellformed(spec, arrivals)
    shares = tenant_shares(arrivals)
    assert shares["t0"] == max(shares.values())


# ---------------------------------------------------------------------------
# parity with the JAX package's generator
# ---------------------------------------------------------------------------
def _as_tuples(arrivals):
    return [(a.step, a.tenant, a.prompt_len, a.max_new_tokens)
            for a in arrivals]


_PARITY_SPECS = {
    "prop": {}, "zipf": dict(name="zipf", horizon=400, base_rate=8.0,
                             burst_rate_mult=1.0, diurnal_amp=0.0,
                             tenants=5, zipf_s=1.2),
    "fat": dict(name="fat", horizon=80, base_rate=4.0, prompt_len_max=6,
                out_tokens_max=4),
}


@pytest.mark.parametrize("seed", range(5))
def test_synthesize_matches_reference_on_presets(seed):
    ports, refs = preset_traces(), j_loadgen.preset_traces()
    assert [dataclasses.asdict(s) for s in ports] == \
        [dataclasses.asdict(s) for s in refs]
    for spec, jspec in zip(ports, refs):
        got = synthesize(spec, seed)
        assert got, spec.name
        assert _as_tuples(got) == _as_tuples(j_loadgen.synthesize(jspec,
                                                                  seed))


@pytest.mark.parametrize("seed", range(5))
@pytest.mark.parametrize("name", sorted(_PARITY_SPECS))
def test_synthesize_matches_reference_on_property_specs(name, seed):
    kw = _PARITY_SPECS[name]
    spec = _spec(**kw)
    base = dict(name="prop", horizon=32, base_rate=1.0, burst_rate_mult=3.0,
                burst_on_mean=4.0, burst_off_mean=8.0, diurnal_period=16,
                diurnal_amp=0.5, tenants=4, zipf_s=1.1, prompt_len_max=12,
                out_tokens_max=12)
    base.update(kw)
    jspec = j_loadgen.TraceSpec(**base)
    assert dataclasses.asdict(spec) == dataclasses.asdict(jspec)
    assert _as_tuples(synthesize(spec, seed)) == \
        _as_tuples(j_loadgen.synthesize(jspec, seed))


def test_fleet_presets_and_smoke_cell_match_reference():
    assert [dataclasses.asdict(f) for f in preset_fleets()] == \
        [dataclasses.asdict(f) for f in j_loadgen.preset_fleets()]
    trace, fleet, seed = smoke_cell()
    jtrace, jfleet, jseed = j_loadgen.smoke_cell()
    assert (dataclasses.asdict(trace), dataclasses.asdict(fleet), seed) == \
        (dataclasses.asdict(jtrace), dataclasses.asdict(jfleet), jseed)


def test_percentile_and_poisson_match_reference():
    for xs in ([], [7], list(range(1, 101)), [5, 1, 9, 3, 3, 8]):
        for q in (0, 50, 95, 99, 100):
            assert percentile(xs, q) == j_loadgen.percentile(xs, q)
    for lam in (0.0, 0.5, 3.0, 25.0):
        a, b = seeded_rng(11), seeded_rng(11)
        assert [_poisson(a, lam) for _ in range(200)] == \
            [j_loadgen._poisson(b, lam) for _ in range(200)]
