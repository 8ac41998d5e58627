"""One run of one cell: the system under test built from the cell's
configuration, set up and warmed, driven by its traffic for a measured
window, then checked against the plain reference.

The window drives ``repro_torch.runtime.gateway.ServingGateway``: the
hypervisor, RC2F admission, one session a tenant, a paged
``BatchingEngine`` (its prefill program and decode graph), the page pool,
the model and its CUDA kernels. The loop is single-threaded: before each
``ServingGateway.step()`` it submits every request that is due (open
loop: by its schedule; closed loop: a client's next request once its
last one finished), so the generator's lateness lands in the time to
first token. A token's time is the end of the step that produced it (the
step ends with the download of the step's ids, which waits for the
device).
"""
from __future__ import annotations

import dataclasses
import gc
import math
import subprocess
import time
from typing import Dict, List, Optional

import numpy as np

from bench import check
from bench.cell import Cell
from bench.traffic import RequestSpec
from bench.weights import make_weights

DRAIN_S = 60.0          # an open loop's wait for late first tokens
# a traced run measures at most this many seconds: the profiler's own
# processing of a 50 s window of ~1.5 million kernels took ~125 s on the
# card's host, too near a run's limit of 360 s
TRACE_S = 20.0


@dataclasses.dataclass
class Record:
    """A request as the benchmark saw it: its spec, the port's ``Request``
    (None: refused), when it was due and each token's time (host clock,
    seconds)."""
    spec: RequestSpec
    req: object
    due: float
    times: List[float] = dataclasses.field(default_factory=list)
    failed: bool = False


@dataclasses.dataclass
class Window:
    """What the per-layer readers read: the model's sizes (``cfg``: the
    configuration's ``model``), the engine's, the window's seconds, each
    step's host span, each step's decode rows (the valid key rows of every
    request that got a token in it), the real lengths of the prefills of
    requests admitted in the window, the prompt tokens admitted, the
    prefix cache's page hits in the window, the output tokens, and the
    device trace (None without ``--trace 1``)."""
    cfg: dict
    engine: dict
    seconds: float
    steps: List[tuple]
    decode_rows: List[List[int]]
    prefills: List[int]
    prompt_tokens: int
    prefix_hit_pages: int
    tokens: int
    device: Optional[object] = None


def model_config(cfg: dict):
    """The port's ``ModelConfig`` of a configuration file's ``model``."""
    from repro_torch.configs.base import ModelConfig, MoEConfig
    kw = dict(cfg)
    kw["pattern"] = tuple(kw["pattern"])
    if kw.get("moe"):
        kw["moe"] = MoEConfig(**kw["moe"])
    return ModelConfig(**kw)


def _now() -> float:
    return time.perf_counter()


def gpu_state() -> str:
    """The card's name, power limit and draw, clocks and temperature."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,power.draw,"
             "clocks.sm,clocks.mem,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def warm_lengths(lo: int, hi: int) -> List[int]:
    """Prompt lengths whose prefills reach every power-of-two bucket a
    prompt of ``lo..hi`` tokens can (its context is one token shorter):
    ``lo``, ``b + 1`` for each power of two ``b`` in between, and ``hi``."""
    out = {lo, hi}
    b = 8
    while b + 1 <= hi:
        if b + 1 >= lo:
            out.add(b + 1)
        b *= 2
    return sorted(out)


class Run:
    """One run of ``cell`` from ``seed`` on ``device``. ``max_steps``
    (tests) ends the window after that many steps instead of at its
    seconds."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool,
                 device: str = "cuda", t_start: Optional[float] = None,
                 max_steps: Optional[int] = None, log=print):
        self.cell = cell
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.device = device
        self.t_start = _now() if t_start is None else t_start
        self.max_steps = max_steps
        self.log = log
        self.cuda = device.startswith("cuda")

    # ------------------------------------------------------------------
    def setup(self) -> None:
        import torch
        from repro_torch.core import ClusterSpec, Hypervisor
        from repro_torch.models.api import Model
        from repro_torch.rc2f.admission import (AdmissionController,
                                                ServiceQuota)
        from repro_torch.runtime.gateway import ServingGateway
        cfg, eng = self.cell.config["model"], self.cell.config["engine"]
        traffic = self.cell.traffic
        self.model = Model(model_config(cfg), device=self.device)
        self.params = make_weights(self.model, self.seed)
        slots = traffic.slots()
        # quotas that this traffic never meets: slices of up to 4 slots
        # (the inventory's vSlice sizes), no cap on requests or pages
        quota = ServiceQuota(max_slots_per_tenant=4,
                             max_inflight_requests=1 << 20,
                             max_prompt_tokens=eng["max_len"],
                             max_new_tokens=eng["max_len"],
                             max_cache_pages_per_tenant=0)
        self.hv = Hypervisor(
            ClusterSpec(n_nodes=1,
                        devices_per_node=max(1, math.ceil(
                            sum(slots.values()) / 4))),
            device=self.device,
            admission=AdmissionController({"baas": quota}))
        self.gw = ServingGateway(
            self.hv, self.model, self.params, n_slots=eng["n_slots"],
            max_len=eng["max_len"], paged=True, page_size=eng["page_size"],
            cache_pages=eng["cache_pages"])
        if self.cuda:
            # configure's warm-up on zeros is freed: hand its blocks back,
            # so a later graph capture (which cannot free cached blocks)
            # finds the memory
            torch.cuda.empty_cache()
        for tenant, k in slots.items():
            self.gw.open_session(tenant, slots=k)
        self._warm_shapes()
        self.specs = traffic.requests(self.seed, cfg["vocab_size"])
        self.records: List[Record] = []
        self.inflight: List[Record] = []
        self.finished: List[Record] = []
        self.t_open = None
        if traffic.closed:
            self._start_closed()

    def _warm_shapes(self) -> None:
        """One request a prefill shape the traffic reaches (one token each),
        then drain: the prefill graphs, the decode graph, and the pool's
        growth, release and scrub, all before the window."""
        lo, hi = self.cell.traffic.prompt_range()
        rng = np.random.default_rng(self.seed ^ 0x5EED)
        tenants = list(self.cell.traffic.slots())
        vocab = self.cell.config["model"]["vocab_size"]
        for i, n in enumerate(warm_lengths(lo, hi)):
            self.gw.submit(tenants[i % len(tenants)],
                           rng.integers(0, vocab, n, dtype=np.int32),
                           max_new_tokens=1)
        if not self.gw.run_until_idle():
            raise RuntimeError("the warm-up requests did not drain")

    def _submit(self, spec: RequestSpec, due: float) -> Record:
        rec = Record(spec, None, due)
        try:
            rec.req = self.gw.submit(spec.tenant, spec.prompt,
                                     max_new_tokens=spec.max_new_tokens)
            self.inflight.append(rec)
        except (ValueError, RuntimeError) as e:  # AdmissionError included
            rec.failed = True
            self.log(f"refused request {spec.index}: {e}")
        self.records.append(rec)
        return rec

    # ------------------------------------------------------------------
    # closed loop
    def _start_closed(self) -> None:
        """Every client's first request (part-way through, where it finds a
        slot), then one step: the window opens on a full engine."""
        clients: Dict[int, List[RequestSpec]] = {}
        for s in self.specs:
            clients.setdefault(s.client, []).append(s)
        self._queue = {c: iter(v) for c, v in clients.items()}
        self._ready: List[int] = []          # clients whose turn it is
        now = _now()
        for c in sorted(clients):
            self._submit(next(self._queue[c]), now)
        self._step(record=False)

    def _due_closed(self, now: float) -> None:
        for c in self._ready:
            spec = next(self._queue[c], None)
            if spec is not None:
                self._submit(spec, now)
        self._ready = []

    # ------------------------------------------------------------------
    # open loop
    def _due_open(self, now: float) -> None:
        while self._next < len(self.specs) and \
                self.t_open + self.specs[self._next].due_s <= now:
            spec = self.specs[self._next]
            self._submit(spec, self.t_open + spec.due_s)
            self._next += 1

    # ------------------------------------------------------------------
    def _step(self, record: bool = True) -> None:
        t0 = _now()
        self.gw.step()
        t1 = _now()
        rows, prefills, admitted = [], [], 0
        still = []
        for rec in self.inflight:
            req = rec.req
            n = len(req.out_tokens)
            if n > len(rec.times):
                if not rec.times:
                    # admitted and prefilled in this step
                    prefills.append(len(rec.spec.prompt) - 1)
                    admitted += len(rec.spec.prompt)
                rec.times.extend([t1] * (n - len(rec.times)))
                rows.append(len(rec.spec.prompt) + n - 1)
            if req.done.is_set():
                if req.finish_reason not in ("length", "eos"):
                    rec.failed = True
                self.finished.append(rec)
                if self.cell.traffic.closed:
                    self._ready.append(rec.spec.client)
            else:
                still.append(rec)
        self.inflight = still
        if record:
            self.steps.append((t0, t1))
            self.step_labels.append("ServingGateway.step, with a prefill"
                                    if prefills else
                                    "ServingGateway.step, decode only")
            self.decode_rows.append(rows)
            self.prefills.extend(prefills)
            self.prompt_tokens += admitted

    def window(self) -> None:
        """Open the window, drive the traffic for ``seconds`` (or
        ``max_steps`` steps), close it; an open loop then serves on until
        every request due in the window has its first token."""
        import torch
        traffic = self.cell.traffic
        self.steps, self.decode_rows, self.prefills = [], [], []
        self.step_labels: List[str] = []
        self.prompt_tokens = 0
        self.tracer = None
        self.gpu_before = gpu_state() if self.cuda else ""
        self.programs_before = self._programs()
        if not traffic.closed:
            # the schedule's zero: arrivals of the first warm_s seconds are
            # served before the window opens; a trace starts just before
            self._next = 0
            self.t_open = _now() + float(traffic.spec.get("warm_s", 0.0))
            while _now() < self.t_open:
                if self.trace and self.tracer is None \
                        and self.t_open - _now() < 0.5:
                    self._start_trace()
                self._due_open(_now())
                self._step(record=False)
        if self.trace and self.tracer is None:
            self._start_trace()
        hits0 = self.gw.page_stats().get("prefix_hits", 0)
        if self.cuda:
            torch.cuda.synchronize()
            # the peak that memory_peak_bytes reports is the window's:
            # set-up's transient copies (configure's warm-up on zeros) are
            # no part of what serving holds
            torch.cuda.reset_peak_memory_stats()
        # what set-up made stays alive through the window: freeze it, so the
        # collector's passes inside the window scan only the window's own
        # objects and pause the loop for less
        gc.collect()
        gc.freeze()
        if traffic.closed:
            self.t_open = _now()
        self.setup_s = self.t_open - self.t_start
        seconds = min(self.seconds, TRACE_S) if self.trace \
            else self.seconds
        n = 0
        while True:
            now = _now()
            if now - self.t_open >= seconds or (
                    self.max_steps is not None and n >= self.max_steps):
                break
            if traffic.closed:
                self._due_closed(now)
            else:
                self._due_open(now)
            self._step()
            n += 1
        self.t_close = self.steps[-1][1]
        if self.tracer:
            self.tracer.stop()
        self.hits = self.gw.page_stats().get("prefix_hits", 0) - hits0
        self.programs_after = self._programs()
        self.gpu_after = gpu_state() if self.cuda else ""
        if not traffic.closed:
            self._drain()

    def _start_trace(self) -> None:
        from bench.trace import Tracer
        self.tracer = Tracer()
        self.tracer.start()

    def _drain(self) -> None:
        """Serve on, arrivals still on their schedule, until every request
        due in the window has its first token (``DRAIN_S`` at most)."""
        end = _now() + DRAIN_S
        late = [r for r in self.records if r.req is not None and not r.failed
                and self.t_open <= r.due <= self.t_close]
        while any(not r.times for r in late) and _now() < end:
            self._due_open(_now())
            self._step(record=False)
        for r in late:
            r.failed = r.failed or not r.times     # never answered: failed

    def _programs(self) -> dict:
        """Graph captures and replays of the decode programs and of the
        prefill program, and the kernel wrappers' launches."""
        from repro_torch.kernels import _lib
        from repro_torch.runtime.serve import prefill_program
        eng = self.cell.config["engine"]
        pre = prefill_program(self.model, eng["max_len"], full_len=True)
        return dict(decode=self.hv.reconfig.cache.programs(),
                    prefill=pre.counts(), launches=dict(_lib.launches))

    # ------------------------------------------------------------------
    def _in_window(self, r: Record) -> bool:
        """A request that counts for the window: in a closed loop every
        request sent before it closed, in an open loop every one due in
        it."""
        if self.cell.traffic.closed:
            return r.due <= self.t_close
        return self.t_open <= r.due <= self.t_close

    def results(self) -> dict:
        """The end-to-end numbers of the window: a rate over all of it, and
        tails over every request and every gap in it."""
        t0, t1 = self.t_open, self.t_close
        tokens = sum(1 for r in self.records for t in r.times
                     if t0 <= t <= t1)
        counted = [r for r in self.records if self._in_window(r)]
        ttft = [(r.times[0] - r.due) * 1e3 for r in counted
                if r.times and not self.cell.traffic.closed]
        gaps = [(b - a) * 1e3 for r in self.records
                for a, b in zip(r.times, r.times[1:]) if t0 <= a and b <= t1]
        self.attempted = len(counted)
        self.failed = sum(1 for r in counted if r.failed)
        # where the window's time went on the host: inside step() (its
        # median and tail, and the time of steps over twice the median,
        # which a stalled host leaves) and between steps (the loop's own)
        spans = [(b - a) * 1e3 for a, b in self.steps]
        med = percentile(spans, 50) or 0.0
        self.counts = dict(
            step_ms_p50=med, step_ms_p99=percentile(spans, 99),
            step_ms_max=max(spans, default=None),
            slow_steps=sum(1 for s in spans if s > 2 * med),
            slow_excess_s=sum(s - med for s in spans if s > 2 * med) / 1e3,
            between_steps_s=sum(b0 - a1 for (_, a1), (b0, _)
                                in zip(self.steps, self.steps[1:])),
        )
        self.counts.update(
            tokens=tokens, steps=len(self.steps), window_s=t1 - t0,
            requests=len(counted), ttft_n=len(ttft), gaps_n=len(gaps),
            ttft_p50_ms=percentile(ttft, 50), ttft_p95_ms=percentile(ttft, 95),
            itl_p50_ms=percentile(gaps, 50),
            first_tokens_missing=sum(1 for r in counted
                                     if r.req is not None and not r.times))
        return {"tokens_per_s": tokens / (t1 - t0),
                "ttft_p95_ms": percentile(ttft, 95),
                "itl_p95_ms": percentile(gaps, 95),
                "setup_s": self.setup_s}

    def window_view(self) -> Window:
        t0 = self.t_open
        steps = [(a - t0, b - t0) for a, b in self.steps]
        return Window(cfg=self.cell.config["model"],
                      engine=self.cell.config["engine"],
                      seconds=self.t_close - t0, steps=steps,
                      decode_rows=self.decode_rows, prefills=self.prefills,
                      prompt_tokens=self.prompt_tokens,
                      prefix_hit_pages=self.hits,
                      tokens=sum(len(r) for r in self.decode_rows),
                      device=self.tracer.result(
                          t0, self.t_close,
                          [(lab, a, b) for lab, (a, b)
                           in zip(self.step_labels, steps)])
                      if self.tracer else None)

    def free(self) -> None:
        """Drop the system under test (its pool, graphs and programs); the
        weights stay for the reference."""
        import torch
        from repro_torch.runtime.serve import clear_prefill_programs
        self.gw.close()
        self.finished_reqs = [(r.spec.prompt, list(r.req.out_tokens))
                              for r in self.finished
                              if not r.failed and r.req.out_tokens]
        del self.gw, self.hv
        self.inflight = []
        clear_prefill_programs()
        gc.unfreeze()           # set-up's objects may be collected again
        gc.collect()
        if self.cuda:
            torch.cuda.empty_cache()

    def check(self, control: bool = False) -> dict:
        """The comparison with the plain reference (``control``: the
        reference in fp8 beside it)."""
        return check.compare(self.cell.config, self.params,
                             self.finished_reqs, self.seed, control)


def percentile(xs, q: float) -> Optional[float]:
    """Nearest-rank percentile (no interpolation), None when empty."""
    if not xs:
        return None
    s = sorted(xs)
    idx = min(len(s) - 1, max(0, math.ceil(q / 100.0 * len(s)) - 1))
    return float(s[idx])
