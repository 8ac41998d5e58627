"""The general traffic generator: a traffic file's parameters and a seed
give the requests of a run.

Copied from ``repro_torch.runtime.loadgen`` (``_mix``, clamped lognormal
lengths, the two-state burst wave) and frozen here, with two changes:
times are seconds from the opening of the measured window, not fleet
rounds, and every seed draws the same set of sizes and gaps in another
order. Lengths and inter-arrival gaps are the quantiles of their
distribution at ``(i + 0.5) / n`` for ``i`` in a permutation drawn from
the seed, so two seeds differ in which request gets which size and in
the token ids, not in how much work there is.

A traffic file (``bench/traffic/<name>.json``) holds, besides its
``source`` (the public trace or paper whose statistics it takes), what it
``assumed`` and what the port forced it to change (``reduced``), which
the generator does not read:

* ``loop``: ``"closed"`` (each client sends its next request when the
  last one finishes) or ``"open"`` (requests arrive on a schedule);
* ``tenants``: a list of ``{"slots": k, "share": w, "clients": c}``, one
  session of ``k`` engine slots a tenant; ``share`` weighs the tenant's
  part of the arrivals (open loop), ``clients`` its closed-loop clients;
* ``prompt`` and ``output``: ``{"median", "sigma", "lo", "hi"}`` of a
  clamped lognormal length, in tokens (the prompt's is the user turn);
* ``system_prompt`` (optional): ``{"lo", "hi"}``, each tenant's own
  system prompt, drawn once, repeated at the head of its requests;
* ``max_context``: prompt plus output never exceed it (the output, then
  the user turn, is shortened);
* ``rate_per_s`` (open loop), ``burst`` (optional, ``{"mult",
  "on_mean_s", "off_mean_s"}``: the rate is multiplied while a two-state
  wave is on), ``warm_s`` (open loop: seconds of arrivals before the
  window opens, served during set-up);
* ``mid_flight`` (closed loop): each client whose request finds a slot at
  the start is already part-way through it, so completions are staggered
  from the window's first step;
* ``requests``: how many requests the stratified pool holds (more than a
  run can use), and ``block``: how many consecutive requests share one
  set of sizes (a closed loop's client count: each round of requests).
"""
from __future__ import annotations

import dataclasses
import json
import math
import statistics
import zlib
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

_NORMAL = statistics.NormalDist()


def _mix(seed: int, tag: str) -> int:
    """A sub-seed from (seed, tag): crc32 is stable across processes."""
    return (int(seed) * 0x9E3779B1 + zlib.crc32(tag.encode())) % (2 ** 63)


def _rng(seed: int, tag: str) -> np.random.Generator:
    return np.random.default_rng(_mix(seed, tag))


def strata(rng: np.random.Generator, n: int, block: int = 0) -> np.ndarray:
    """``n`` probabilities in an order drawn from ``rng``, every seed the
    same set: ``(i + 0.5) / b`` for ``i`` in a permutation of each block of
    ``b = block`` (the last block may be shorter; 0: one block of ``n``),
    so every block of requests, and so every window that spans whole
    blocks, holds the same sizes."""
    block = block or n
    out = np.empty(n)
    for lo in range(0, n, block):
        b = min(block, n - lo)
        out[lo:lo + b] = (rng.permutation(b) + 0.5) / b
    return out


def lognormal_lengths(u: np.ndarray, spec: dict) -> np.ndarray:
    """Clamped lognormal lengths at probabilities ``u``: ``median *
    exp(sigma * z)`` with ``z`` the standard normal quantile."""
    z = np.array([_NORMAL.inv_cdf(float(p)) for p in u])
    n = np.floor(spec["median"] * np.exp(spec["sigma"] * z)).astype(np.int64)
    return np.clip(n, spec["lo"], spec["hi"])


@dataclasses.dataclass
class RequestSpec:
    """One request of a run: its tenant, its closed-loop client (-1 in an
    open loop), its due time in seconds from the window's opening (None:
    a closed loop sends it when its client's last request finished; an
    open loop's first ``warm_s`` seconds of arrivals are due before 0),
    the prompt's token ids and the output length."""
    index: int
    tenant: str
    client: int
    due_s: Optional[float]
    prompt: np.ndarray
    max_new_tokens: int


@dataclasses.dataclass
class Traffic:
    name: str
    spec: dict

    @classmethod
    def load(cls, path) -> "Traffic":
        spec = json.loads(Path(path).read_text())
        return cls(spec["name"], spec)

    @property
    def closed(self) -> bool:
        return self.spec["loop"] == "closed"

    def tenants(self) -> List[str]:
        return [f"tenant-{i}" for i in range(len(self.spec["tenants"]))]

    def slots(self) -> Dict[str, int]:
        return {t: int(d["slots"])
                for t, d in zip(self.tenants(), self.spec["tenants"])}

    def max_context(self) -> int:
        return int(self.spec["max_context"])

    def prompt_range(self) -> tuple:
        """(shortest, longest) prompt a run can send, system prompt
        included, for warming the shapes it reaches."""
        s = self.spec
        sys_lo = s["system_prompt"]["lo"] if s.get("system_prompt") else 0
        sys_hi = s["system_prompt"]["hi"] if s.get("system_prompt") else 0
        hi = min(sys_hi + s["prompt"]["hi"],
                 self.max_context() - s["output"]["lo"])
        if self.closed and s.get("mid_flight"):
            hi = self.max_context() - 1   # prompt + the elapsed output
        return sys_lo + s["prompt"]["lo"], hi

    def system_prompts(self, seed: int, vocab: int) -> Dict[str, np.ndarray]:
        """Each tenant's system prompt (empty without one): lengths are the
        quantiles of a uniform over ``[lo, hi]``, one a tenant in a fixed
        order that strides over them (so tenants of every share get long
        and short ones, whatever the seed); ids uniform over the
        vocabulary, from the seed."""
        sp = self.spec.get("system_prompt")
        names = self.tenants()
        if not sp:
            return {t: np.zeros((0,), np.int32) for t in names}
        rng = _rng(seed, "system/" + self.name)
        n = len(names)
        stride = next(k for k in range(n // 2 + 1, n + 2)
                      if math.gcd(k, n) == 1)
        u = (np.arange(n) * stride % n + 0.5) / n
        lens = np.floor(sp["lo"] + u * (sp["hi"] - sp["lo"] + 1)).astype(int)
        return {t: rng.integers(0, vocab, int(n), dtype=np.int32)
                for t, n in zip(names, lens)}

    def requests(self, seed: int, vocab: int) -> List[RequestSpec]:
        """The run's requests: for a closed loop, each client's sequence
        (interleaved: request ``j`` of client ``c`` is ``j * clients +
        c``); for an open loop, in order of due time."""
        s = self.spec
        n = int(s["requests"])
        block = int(s.get("block", 0))
        rng = _rng(seed, "requests/" + self.name)
        plen = lognormal_lengths(strata(rng, n, block), s["prompt"])
        olen = lognormal_lengths(strata(rng, n, block), s["output"])
        system = self.system_prompts(seed, vocab)
        names = self.tenants()
        if self.closed:
            owners = [(t, c) for t, d in zip(names, s["tenants"])
                      for c in range(int(d["clients"]))]
            tenant_of = [owners[i % len(owners)][0] for i in range(n)]
            client_of = [i % len(owners) for i in range(n)]
            due = [None] * n
        else:
            share = np.array([float(d["share"]) for d in s["tenants"]])
            cum = np.cumsum(share / share.sum())
            cum[-1] = 1.0
            pick = np.searchsorted(cum, strata(rng, n, block), side="right")
            tenant_of = [names[min(int(k), len(names) - 1)] for k in pick]
            client_of = [-1] * n
            due = self._arrivals(rng, n, block)
        out = []
        ids = _rng(seed, "tokens/" + self.name)
        cap = self.max_context()
        for i in range(n):
            sysp = system[tenant_of[i]]
            user = int(plen[i])
            new = int(olen[i])
            # the output first, then the user turn, gives way to the cap
            new = max(s["output"]["lo"], min(new, cap - len(sysp) - user))
            user = max(1, min(user, cap - len(sysp) - new))
            prompt = np.concatenate(
                [sysp, ids.integers(0, vocab, user, dtype=np.int32)])
            out.append(RequestSpec(i, tenant_of[i], client_of[i], due[i],
                                   prompt, new))
        if self.closed and s.get("mid_flight"):
            self._mid_flight(out, seed, vocab)
        if not self.closed:
            warm = float(s.get("warm_s", 0.0))
            for r in out:
                r.due_s -= warm
        return out

    def _arrivals(self, rng: np.random.Generator, n: int,
                  block: int) -> List[float]:
        """Due times: unit-rate exponential gaps (the quantiles, in a seeded
        order) over the rate of the moment; with ``burst``, a two-state wave
        with exponential sojourns multiplies the rate while on."""
        s = self.spec
        gaps = -np.log1p(-strata(rng, n, block))
        rate = float(s["rate_per_s"])
        burst = s.get("burst")
        t, on, switch = 0.0, False, math.inf
        wave = _rng(int(rng.integers(0, 2 ** 62)), "burst")
        if burst:
            switch = wave.exponential(burst["off_mean_s"])
        due = []
        for g in gaps:
            r = rate * (burst["mult"] if on else 1.0) if burst else rate
            t += float(g) / r
            while t > switch:
                on = not on
                switch += wave.exponential(
                    burst["on_mean_s"] if on else burst["off_mean_s"])
            due.append(t)
        return due

    def _mid_flight(self, reqs: List[RequestSpec], seed: int,
                    vocab: int) -> None:
        """A client's first request, where it finds a slot at the start, is
        already part-way through its output: the part that is done joins
        the prompt (random ids), so the context is as long as it would be,
        and the rest is to come. The parts done are the quantiles of a
        uniform over clients, in a seeded order."""
        s = self.spec
        rng = _rng(seed, "mid_flight/" + self.name)
        first = {}
        for r in reqs:
            first.setdefault(r.client, r)
        seats = {t: int(d["slots"]) for t, d in
                 zip(self.tenants(), s["tenants"])}
        u = strata(rng, len(first))
        for k, (client, r) in enumerate(sorted(first.items())):
            if seats[r.tenant] <= 0:
                continue                     # it waits in the queue: fresh
            seats[r.tenant] -= 1
            done = int(u[k] * r.max_new_tokens)
            r.prompt = np.concatenate(
                [r.prompt, rng.integers(0, vocab, done, dtype=np.int32)])
            r.max_new_tokens -= done
