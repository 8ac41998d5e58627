"""Open-loop trace-replay load generation + the standing soak matrix (a
copy of ``repro.runtime.loadgen`` with the imports switched to the port and
a ``device`` for the fleet's hypervisor).

The paper evaluates RC3E with a handful of hand-driven allocations; a
cloud provider's real question is what the hypervisor + serving fleet do
under *traffic* — burst waves arriving on a diurnal cycle, heavy-tailed
request sizes, a few hot tenants dominating the load — sustained across
device failures. This module synthesizes that traffic and replays it:

  * ``TraceSpec`` — a fully serializable description of a workload:
    Poisson arrivals with burst-wave and diurnal modulation, lognormal
    prompt/output lengths, Zipf tenant skew. Same spec + seed ⇒
    bit-identical trace (property-tested in
    ``tests/test_torch_loadgen.py``).
  * ``synthesize`` — spec → an explicit arrival list. The trace is
    OPEN-LOOP: arrivals land on schedule whether or not the fleet keeps
    up, so overload shows up as backlog/latency/rejections instead of the
    closed-loop trap of the generator politely slowing down.
  * ``replay_trace`` — drive one ``GatewayFleet`` through a trace on the
    injected ``FakeClock``, measuring goodput, per-tenant p50/p95/p99
    latency (in fleet rounds — deterministic), preemption/eviction
    counts, load-shed rejections and the energy integral (device-steps ×
    class draw). The record it returns contains NO wall-clock values, so
    two replays of the same cell are bit-identical (tested under
    ``RC3E_SANITIZE=1``).
  * ``SoakMatrix`` — the standing grid: chaos seeds × trace specs ×
    fleet sizes, each cell replayed with a seeded mixed-fault schedule
    (``FaultInjector.plan_soak``) and invariant-checked at the end.

All randomness flows through ``seeded_rng`` (the determinism pass
enforces this) and latency is measured in fleet rounds, never wall time,
so a soak record is stable across hosts and suitable for CI
regression checks.
"""
from __future__ import annotations

import bisect
import dataclasses
import math
import zlib
from typing import Dict, List, Optional, Tuple

from repro_torch.core import ClusterSpec, Hypervisor
from repro_torch.core.monitor import MonitorConfig
from repro_torch.rc2f import AdmissionError
from repro_torch.runtime.events import EventLoop
from repro_torch.runtime.faults import FaultInjector, seeded_rng
from repro_torch.runtime.fleet import GatewayFleet


def _mix(seed: int, tag: str) -> int:
    """Derive a sub-seed from (seed, tag) without Python's salted
    ``hash``: crc32 is stable across processes and platforms."""
    return (int(seed) * 0x9E3779B1 + zlib.crc32(tag.encode())) % (2 ** 31)


def _poisson(rng, lam: float) -> int:
    """Poisson draw via Knuth's product method, chunked so exp(-lam)
    never underflows for large rates (sums of independent Poissons are
    Poisson)."""
    n = 0
    while lam > 10.0:
        n += _poisson_knuth(rng, 10.0)
        lam -= 10.0
    return n + _poisson_knuth(rng, lam)


def _poisson_knuth(rng, lam: float) -> int:
    if lam <= 0.0:
        return 0
    limit = math.exp(-lam)
    k, p = 0, 1.0
    while True:
        p *= rng.random()
        if p <= limit:
            return k
        k += 1


def _lognormal_len(rng, mu: float, sigma: float, lo: int, hi: int) -> int:
    return max(lo, min(hi, int(rng.lognormvariate(mu, sigma))))


def percentile(xs, q: float) -> Optional[float]:
    """Nearest-rank percentile (deterministic, no interpolation)."""
    if not xs:
        return None
    s = sorted(xs)
    idx = min(len(s) - 1, max(0, math.ceil(q / 100.0 * len(s)) - 1))
    return float(s[idx])


# ---------------------------------------------------------------------------
# Trace synthesis
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class TraceSpec:
    """Serializable description of one open-loop workload.

    Arrival process per round ``t``:
      rate(t) = base_rate
                × (1 + diurnal_amp · sin(2π t / diurnal_period))
                × (burst_rate_mult if the burst wave is ON else 1)
    with the burst wave a two-state Markov chain (geometric sojourns of
    mean ``burst_on_mean`` / ``burst_off_mean`` rounds) and the count
    drawn Poisson(rate). Each arrival gets a tenant from a Zipf(zipf_s)
    over ``tenants`` hot-first, a prompt length and an output budget from
    clamped lognormals.
    """
    name: str
    horizon: int = 64                 # rounds of arrivals
    base_rate: float = 0.5            # mean arrivals/round at baseline
    burst_rate_mult: float = 1.0      # rate multiplier while bursting
    burst_on_mean: float = 4.0        # mean burst length (rounds)
    burst_off_mean: float = 12.0      # mean gap between bursts
    diurnal_period: int = 0           # 0 disables the diurnal sinusoid
    diurnal_amp: float = 0.0          # fraction of base_rate (|amp| <= 1)
    tenants: int = 4
    zipf_s: float = 1.1               # tenant-popularity skew exponent
    prompt_len_mu: float = 1.2        # lognormal params (of the length)
    prompt_len_sigma: float = 0.5
    prompt_len_max: int = 12
    out_tokens_mu: float = 1.6
    out_tokens_sigma: float = 0.4
    out_tokens_max: int = 12

    def tenant_ids(self) -> List[str]:
        return [f"t{i}" for i in range(self.tenants)]

    def zipf_weights(self) -> List[float]:
        w = [1.0 / (i + 1) ** self.zipf_s for i in range(self.tenants)]
        total = sum(w)
        return [x / total for x in w]


@dataclasses.dataclass(frozen=True)
class Arrival:
    """One scheduled request: submit at round ``step``."""
    step: int
    tenant: str
    prompt_len: int
    max_new_tokens: int


def synthesize(spec: TraceSpec, seed: int) -> List[Arrival]:
    """Spec + seed → the explicit arrival list, sorted by step (arrivals
    within a round keep draw order). Pure function of its arguments:
    identical inputs produce a bit-identical list."""
    rng = seeded_rng(_mix(seed, "trace/" + spec.name))
    weights = spec.zipf_weights()
    cum = []
    acc = 0.0
    for w in weights:
        acc += w
        cum.append(acc)
    cum[-1] = 1.0                      # guard float drift at the top end
    tenants = spec.tenant_ids()
    bursting = False
    out: List[Arrival] = []
    for t in range(spec.horizon):
        # two-state burst wave with geometric sojourn times
        if spec.burst_rate_mult > 1.0:
            flip = (1.0 / spec.burst_on_mean if bursting
                    else 1.0 / spec.burst_off_mean)
            if rng.random() < flip:
                bursting = not bursting
        rate = spec.base_rate
        if spec.diurnal_period:
            rate *= 1.0 + spec.diurnal_amp * math.sin(
                2.0 * math.pi * t / spec.diurnal_period)
        if bursting:
            rate *= spec.burst_rate_mult
        for _ in range(_poisson(rng, max(0.0, rate))):
            tenant = tenants[bisect.bisect_left(cum, rng.random())]
            out.append(Arrival(
                step=t, tenant=tenant,
                prompt_len=_lognormal_len(rng, spec.prompt_len_mu,
                                          spec.prompt_len_sigma, 1,
                                          spec.prompt_len_max),
                max_new_tokens=_lognormal_len(rng, spec.out_tokens_mu,
                                              spec.out_tokens_sigma, 1,
                                              spec.out_tokens_max)))
    return out


def tenant_shares(arrivals: List[Arrival]) -> Dict[str, float]:
    """Observed per-tenant arrival fractions (property tests compare them
    against ``TraceSpec.zipf_weights``)."""
    counts: Dict[str, int] = {}
    for a in arrivals:
        counts[a.tenant] = counts.get(a.tenant, 0) + 1
    total = max(1, len(arrivals))
    return {t: n / total for t, n in counts.items()}


# ---------------------------------------------------------------------------
# Fleet description + replay
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class FleetSpec:
    """Serializable fleet-under-test description for one soak cell."""
    name: str
    n_nodes: int = 2
    devices_per_node: int = 1
    n_slots: int = 4
    max_len: int = 64
    paged: bool = True
    page_size: int = 4
    cache_pages: Optional[int] = None
    autoscale_every: int = 4
    scale_up_queue_depth: int = 8
    slo_p95_steps: Optional[float] = 24.0
    slo_horizon: int = 16
    migrate_every: int = 0
    device_draws: Tuple[float, ...] = ()   # heterogeneous class draws
    device_speeds: Tuple[float, ...] = ()  # event-loop cadence multipliers

    def n_devices(self) -> int:
        return self.n_nodes * self.devices_per_node


def build_fleet(fleet_spec: FleetSpec, model, params, seed: int,
                reconfig=None,
                device="cuda") -> Tuple[GatewayFleet, FaultInjector]:
    """One hypervisor + fleet on a fresh FakeClock-driven injector. The
    injector's schedule is empty; ``replay_trace`` adds the soak plan.
    The hypervisor runs its programs on ``device`` (the card unless the
    caller passes ``device="cpu"``); the fleet raises ``ValueError`` unless
    the model (and a shared ``reconfig``) is on the same device."""
    inj = FaultInjector(seed=_mix(seed, "faults/" + fleet_spec.name))
    hv = Hypervisor(ClusterSpec(n_nodes=fleet_spec.n_nodes,
                                devices_per_node=fleet_spec.devices_per_node,
                                device_draws=fleet_spec.device_draws,
                                device_speeds=fleet_spec.device_speeds),
                    MonitorConfig(heartbeat_interval_s=1.0,
                                  heartbeat_deadline_s=2.5),
                    clock=inj.clock, device=device)
    if reconfig is not None:
        hv.reconfig = reconfig         # shared program cache across cells
    fleet = GatewayFleet(
        hv, model, params, n_slots=fleet_spec.n_slots,
        max_len=fleet_spec.max_len, paged=fleet_spec.paged,
        page_size=fleet_spec.page_size, cache_pages=fleet_spec.cache_pages,
        autoscale_every=fleet_spec.autoscale_every,
        scale_up_queue_depth=fleet_spec.scale_up_queue_depth,
        slo_p95_steps=fleet_spec.slo_p95_steps,
        slo_horizon=fleet_spec.slo_horizon,
        migrate_every=fleet_spec.migrate_every, faults=inj)
    return fleet, inj


def replay_trace(trace: TraceSpec, fleet_spec: FleetSpec, seed: int,
                 model, params, reconfig=None, chaos: bool = False,
                 chaos_kills: int = 1, chaos_partitions: int = 1,
                 drain_slack: int = 256, loop: str = "lockstep",
                 prefill_chunk: int = 4, device="cuda") -> dict:
    """Replay one soak cell: build the fleet, open one baas session per
    tenant, feed the trace open-loop round by round, then drain. Returns
    the cell's soak record — metrics only, no wall-clock
    values, so the record is a pure function of ``(trace, fleet, seed)``.

    ``loop`` selects the dataplane: ``"lockstep"`` drives the fleet with
    the round-barrier ``GatewayFleet.step``; ``"event"`` schedules each
    arrival as a queue event at its round's tick time and drives an
    ``EventLoop`` one control-tick window per round, so engines advance
    on their own ``device.speed`` cadence and prefill is chunked
    (``prefill_chunk`` tokens per engine event).

    Over-admission is part of the experiment: a submit the admission
    controller (tenant quota) or engine (paged worst-case) refuses counts
    as load shed, not an error. ``drain_slack`` bounds the post-horizon
    drain so a lost request can never hang the harness; whatever is still
    unfinished at the bound is reported as ``incomplete``.

    ``device`` is the fleet's (``build_fleet``); the record does not
    depend on it.
    """
    if loop not in ("lockstep", "event"):
        raise ValueError(f"unknown loop {loop!r}")
    if trace.prompt_len_max + trace.out_tokens_max > fleet_spec.max_len:
        raise ValueError(
            f"trace {trace.name!r} worst case "
            f"{trace.prompt_len_max}+{trace.out_tokens_max} exceeds fleet "
            f"max_len {fleet_spec.max_len}")
    fleet, inj = build_fleet(fleet_spec, model, params, seed,
                             reconfig=reconfig, device=device)
    if chaos:
        lo = max(1, trace.horizon // 3)
        hi = max(lo + 1, (2 * trace.horizon) // 3)
        inj.plan_soak(sorted(fleet.hv.db.devices),
                      sorted(fleet.hv.db.nodes), lo, hi,
                      kills=chaos_kills, partitions=chaos_partitions)
    for t in trace.tenant_ids():
        fleet.open_session(t, slots=1, service_model="baas")

    arrivals = synthesize(trace, seed)
    by_step: Dict[int, List[Arrival]] = {}
    for a in arrivals:
        by_step.setdefault(a.step, []).append(a)
    vocab = model.cfg.vocab_size
    prompt_rng = seeded_rng(_mix(seed, "prompts/" + trace.name))

    outstanding: List[Tuple[object, str, int]] = []   # (req, tenant, t0)
    lat_all: List[int] = []
    lat_by_tenant: Dict[str, List[int]] = {}
    done_by_tenant: Dict[str, int] = {}
    rejected = completed = cancelled = tokens_out = 0
    engines_seen: Dict[int, object] = {}
    peak_devices = 0
    rounds = 0

    def _submit(a: Arrival, t0: int) -> None:
        nonlocal rejected
        prompt = [prompt_rng.randrange(vocab)
                  for _ in range(a.prompt_len)]
        try:
            req = fleet.submit(a.tenant, prompt, a.max_new_tokens)
        except (AdmissionError, ValueError, KeyError):
            # quota breach, paged worst-case refusal, or a session the
            # failover path EVICTED (reported via ``evictions``) —
            # open-loop arrivals for it are shed, not an error
            rejected += 1
            return
        outstanding.append((req, a.tenant, t0))

    evloop = None
    if loop == "event":
        evloop = EventLoop(fleet, prefill_chunk=prefill_chunk)
        # arrivals become queue events: scheduled up-front they carry the
        # lowest seqs at their instant, so a round's arrivals fire before
        # that round's control tick — same submit-then-step order as the
        # lockstep replay
        for a in arrivals:
            evloop.queue.at(a.step * evloop.tick_s,
                            lambda a=a: _submit(a, a.step),
                            kind="arrival")
    while rounds < trace.horizon or (outstanding
                                     and rounds < trace.horizon
                                     + drain_slack):
        if evloop is None:
            for a in by_step.get(rounds, ()):
                _submit(a, rounds)
            fleet.step()
        else:
            evloop.run_ticks(1)
        rounds += 1
        peak_devices = max(peak_devices, len(fleet._engines))
        for dev, eng in fleet._engines.items():
            engines_seen[id(eng)] = (dev, eng)
        still = []
        for req, tenant, t0 in outstanding:
            if not req.done.is_set():
                still.append((req, tenant, t0))
            elif req.finish_reason == "cancelled":
                cancelled += 1
            else:
                completed += 1
                tokens_out += len(req.out_tokens)
                done_by_tenant[tenant] = done_by_tenant.get(tenant, 0) + 1
                lat_all.append(rounds - t0)
                lat_by_tenant.setdefault(tenant, []).append(rounds - t0)
        outstanding = still

    if evloop is not None:
        fleet.flush_journal()          # settle lazy dirt before checking
    fleet.verify_invariants()          # pool.verify + quota == journal
    preemptions = sum(e.preemptions for _, e in engines_seen.values())
    steps_by_device: Dict[str, int] = {}
    for dev, eng in engines_seen.values():
        steps_by_device[dev] = steps_by_device.get(dev, 0) + eng.steps
    evictions = len([e for e in fleet.hv.log
                     if e.get("kind") == "failover_evict"])
    by_signal: Dict[str, int] = {}
    scale_ins = 0
    for ev in fleet.autoscale_log:
        if ev["action"] == "scale_in":
            scale_ins += 1
        else:
            by_signal[ev["signal"]] = by_signal.get(ev["signal"], 0) + 1
    slo = fleet_spec.slo_p95_steps
    metrics = {
        "arrivals": len(arrivals),
        "rejected": rejected,
        "completed": completed,
        "cancelled": cancelled,
        "incomplete": len(outstanding),
        "tokens_out": tokens_out,
        "rounds": rounds,
        "goodput_tokens_per_round": round(tokens_out / max(1, rounds), 6),
        "latency_rounds": {
            "p50": percentile(lat_all, 50), "p95": percentile(lat_all, 95),
            "p99": percentile(lat_all, 99),
            "mean": (round(sum(lat_all) / len(lat_all), 6)
                     if lat_all else None),
            "max": max(lat_all) if lat_all else None,
        },
        "per_tenant": {
            t: {"completed": done_by_tenant.get(t, 0),
                "p50": percentile(lat_by_tenant.get(t, []), 50),
                "p95": percentile(lat_by_tenant.get(t, []), 95),
                "p99": percentile(lat_by_tenant.get(t, []), 99)}
            for t in trace.tenant_ids()},
        "slo_violations": (len([x for x in lat_all if x > slo])
                           if slo is not None else None),
        "preemptions": preemptions,
        "evictions": evictions,
        "energy_device_steps": round(fleet.energy, 6),
        "peak_active_devices": peak_devices,
        "per_device_steps": {d: steps_by_device[d]
                             for d in sorted(steps_by_device)},
        "autoscale": {"scale_out_by_signal": by_signal,
                      "scale_in": scale_ins},
    }
    cell = {"trace": trace.name, "fleet": fleet_spec.name,
            "seed": int(seed), "chaos": bool(chaos)}
    if loop != "lockstep":
        # lockstep cells keep their committed-baseline shape; event cells
        # are tagged so records from the two loops never alias
        cell["loop"] = loop
    record = {
        "cell": cell,
        "trace_spec": dataclasses.asdict(trace),
        "fleet_spec": dataclasses.asdict(fleet_spec),
        "faults": [{"step": e["step"], "kind": e["kind"],
                    "target": e.get("target")} for e in inj.log],
        "metrics": metrics,
    }
    fleet.close()
    return record


# ---------------------------------------------------------------------------
# The standing soak matrix
# ---------------------------------------------------------------------------
class SoakMatrix:
    """Chaos seeds × trace specs × fleet sizes, one ``replay_trace`` per
    cell. Each cell gets its own seeded mixed-fault schedule; every cell
    is invariant-checked (``GatewayFleet.verify_invariants``, which
    includes ``PagePoolManager.verify``) before its record is returned.
    """

    def __init__(self, traces: List[TraceSpec], fleets: List[FleetSpec],
                 seeds: List[int], chaos: bool = True,
                 loop: str = "lockstep", prefill_chunk: int = 4):
        self.traces = list(traces)
        self.fleets = list(fleets)
        self.seeds = list(seeds)
        self.chaos = chaos
        self.loop = loop
        self.prefill_chunk = prefill_chunk

    def cells(self) -> List[Tuple[TraceSpec, FleetSpec, int]]:
        return [(t, f, s) for t in self.traces for f in self.fleets
                for s in self.seeds]

    def run(self, model, params, reconfig=None, progress=None,
            device="cuda") -> List[dict]:
        records = []
        for trace, fspec, seed in self.cells():
            rec = replay_trace(trace, fspec, seed, model, params,
                               reconfig=reconfig, chaos=self.chaos,
                               loop=self.loop,
                               prefill_chunk=self.prefill_chunk,
                               device=device)
            records.append(rec)
            if progress is not None:
                progress(rec)
        return records


# ---------------------------------------------------------------------------
# Pinned presets (the reference's; its committed
# benchmarks/BENCH_scale_baseline.json records are generated from these)
# ---------------------------------------------------------------------------
def preset_traces() -> List[TraceSpec]:
    return [
        TraceSpec(name="steady", horizon=48, base_rate=0.6,
                  burst_rate_mult=1.0, diurnal_period=0, diurnal_amp=0.0,
                  tenants=4, zipf_s=1.1),
        TraceSpec(name="burst-diurnal", horizon=64, base_rate=0.5,
                  burst_rate_mult=4.0, burst_on_mean=6.0,
                  burst_off_mean=12.0, diurnal_period=32, diurnal_amp=0.8,
                  tenants=6, zipf_s=1.2),
    ]


def preset_fleets() -> List[FleetSpec]:
    return [
        FleetSpec(name="fleet2", n_nodes=2, devices_per_node=1,
                  slo_p95_steps=24.0, device_draws=(1.0, 2.0)),
        FleetSpec(name="fleet4", n_nodes=4, devices_per_node=1,
                  slo_p95_steps=24.0,
                  device_draws=(1.0, 2.0, 1.5, 1.0)),
    ]


def smoke_cell() -> Tuple[TraceSpec, FleetSpec, int]:
    """The pinned small cell CI replays (scale-smoke job): the steady
    trace on the 2-device fleet, seed 0, no chaos."""
    return preset_traces()[0], preset_fleets()[0], 0
