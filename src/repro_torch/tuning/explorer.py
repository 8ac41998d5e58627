"""Design-space exploration + persistence of winners.

``tune`` sweeps every legal candidate through the cost model and returns
a report (winner + ranked table + prune census). ``resolve_tuned`` is
the runtime entry point: look up the persisted winner for this
``(model fingerprint, device class)`` in the ProgramCache's tuned-config
store, tuning on first use — the hypervisor/fleet call it at bind time
so tenants land on class-appropriate geometry with zero operator input.

Optional ``measure`` hook: a callable scoring a candidate empirically
(e.g. decode-step wall ms a token on the card); when given, the modeled
top-k are re-ranked by measurement. The package never passes it, so the
sweep stays deterministic.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple

from repro_torch.configs.base import ModelConfig
from repro_torch.tuning.cost_model import (Cost, DeviceProfile,
                                           candidate_cost, profile_for_speed)
from repro_torch.tuning.space import TunedConfig, enumerate_candidates


def device_class(speed: float) -> str:
    """Canonical device-class name for a PhysicalDevice speed."""
    return f"c{float(speed):.2f}x"


def model_fingerprint(cfg: ModelConfig, max_len: int, paged: bool) -> str:
    """Stable key for 'this model served this way' — what tuned configs
    are persisted under (the reference's description, so the keys agree)."""
    desc = (f"{cfg.name}:{cfg.n_layers}x{cfg.d_model}"
            f":h{cfg.n_heads}/{cfg.n_kv_heads}:hd{cfg.resolved_head_dim}"
            f":ff{cfg.d_ff}:v{cfg.vocab_size}:{cfg.dtype}"
            f":kvq{int(cfg.kv_quant)}:len{max_len}:paged{int(paged)}")
    return hashlib.sha256(desc.encode()).hexdigest()[:16]


@dataclass
class TuneReport:
    best: TunedConfig
    best_cost: Cost
    default_cost: Cost
    device_class: str
    model_fp: str
    n_candidates: int = 0
    n_pruned: int = 0
    prune_census: dict = field(default_factory=dict)
    table: List[Tuple[TunedConfig, Cost]] = field(default_factory=list)

    @property
    def win(self) -> float:
        """default/tuned service-time ratio (>1 means the tuner won)."""
        if self.best_cost.us_per_token <= 0:
            return 1.0
        return self.default_cost.us_per_token / self.best_cost.us_per_token


def tune(cfg: ModelConfig, profile: DeviceProfile, *, max_len: int,
         paged: bool, top_k: int = 8,
         measure: Optional[Callable[[TunedConfig], float]] = None
         ) -> TuneReport:
    """Exhaustive sweep of the legal space, ranked by modeled
    us_per_token; ties break toward the default geometry, then by the
    geometry key, keeping results deterministic."""
    default = TunedConfig()
    fp = model_fingerprint(cfg, max_len, paged)
    scored: List[Tuple[TunedConfig, Cost]] = []
    census: dict = {}
    n_all = n_pruned = 0
    for cand in enumerate_candidates(max_len=max_len,
                                     head_dim=cfg.resolved_head_dim,
                                     paged=paged):
        n_all += 1
        c = candidate_cost(cand, cfg, profile, max_len=max_len, paged=paged)
        if c.pruned is not None:
            n_pruned += 1
            rule = c.pruned.split(" ", 1)[0]
            census[rule] = census.get(rule, 0) + 1
            continue
        scored.append((cand, c))
    if not scored:
        raise ValueError(
            f"design space empty for {cfg.name} on {profile.name}: "
            f"{n_pruned}/{n_all} pruned ({census})")
    scored.sort(key=lambda t: (t[1].us_per_token, t[0] != default,
                               t[0].geometry_key()))
    top = scored[:top_k]
    if measure is not None:
        top = sorted(top, key=lambda t: measure(t[0]))
    best, best_cost = top[0]
    return TuneReport(
        best=best, best_cost=best_cost,
        default_cost=candidate_cost(default, cfg, profile,
                                    max_len=max_len, paged=paged),
        device_class=profile.name, model_fp=fp,
        n_candidates=n_all, n_pruned=n_pruned, prune_census=census,
        table=scored[:top_k])


def resolve_tuned(cache, cfg: ModelConfig, speed: float, *, max_len: int,
                  paged: bool) -> TunedConfig:
    """Cached winner for (model fingerprint, device class), tuning once
    on first use. ``cache`` is a ``ProgramCache`` (its tuned-config side
    store); safe under concurrent callers — worst case both tune and one
    result (identical — the sweep is deterministic) is stored twice."""
    cls = device_class(speed)
    fp = model_fingerprint(cfg, max_len, paged)
    rec = cache.get_tuned(fp, cls)
    if rec is not None:
        return TunedConfig.from_dict(rec)
    report = tune(cfg, profile_for_speed(speed, cls),
                  max_len=max_len, paged=paged)
    cache.put_tuned(fp, cls, report.best.to_dict())
    return report.best
