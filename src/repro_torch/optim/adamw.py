"""AdamW + schedules + global-norm clipping (the reference's
``optim/adamw.py``, in the same order of operations, fp32).

The update runs under ``torch.no_grad`` and syncs nothing with the host:
the learning rate, the clip scale and the pre-clip norm stay 0-d tensors
on the parameters' device. ``adamw_update`` clips each leaf as it updates
it, and works in place on its own temporaries, so that a large state (a
MoE layer's stacked experts) needs no clipped copy of every gradient
beside the new state; each operation and its rounding are the
reference's.

``adamw_update_`` is the same update in place: it writes each leaf's new
parameter, ``mu`` and ``nu``, and ``count``, into the tensors it is given,
by the same operations in the same order (``mu.mul_(b1)`` rounds as
``torch.mul(mu, b1)``). It is the port's counterpart of XLA's buffer
donation (``donate_argnums``) for the training program, whose CUDA graph
is bound to the state's addresses.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.tree import flatten, tree_map, unflatten


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1


def _f32(x):
    return torch.as_tensor(x).to(torch.float32)


def schedule(cfg: AdamWConfig, step):
    """Linear warmup + cosine decay to min_lr_ratio. ``step``: an int or an
    integer tensor; returns a 0-d float32 tensor on its device."""
    step = _f32(step)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * frac))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def init_opt_state(params):
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
    dev = flatten(params)[0][0].device
    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree):
    sq = [torch.sum(torch.square(x.float())) for x in flatten(tree)[0]]
    total = sq[0]
    for s in sq[1:]:
        total = total + s
    return torch.sqrt(total)


def _clip_scale(norm, max_norm: float):
    return torch.clamp(max_norm / (norm + 1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: (g * scale).to(g.dtype), grads), norm


def _corrections(cfg: AdamWConfig, count):
    """(lr, bc1, bc2) at the advanced ``count``. The bases are filled on
    the device (an upload from pageable memory cannot be captured) and
    hold the same float32 values as ``torch.as_tensor(b1)``."""
    c32 = count.to(torch.float32)
    base = lambda b: torch.full((), b, dtype=torch.float32,
                                device=c32.device)
    return (schedule(cfg, count), 1 - torch.pow(base(cfg.b1), c32),
            1 - torch.pow(base(cfg.b2), c32))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads, opt_state, params):
    """Returns (new_params, new_opt_state, metrics {grad_norm, lr})."""
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, cfg.clip_norm)
    count = opt_state["count"] + 1
    lr, bc1, bc2 = _corrections(cfg, count)
    b1, b2 = cfg.b1, cfg.b2

    def upd(g, mu, nu, p):
        g32 = (g * scale).to(g.dtype).float()        # clip_by_global_norm
        mu = torch.mul(mu, b1).add_(torch.mul(g32, 1 - b1))
        nu = torch.mul(nu, b2).add_(torch.square(g32).mul_(1 - b2))
        del g32
        # mu_hat / (sqrt(nu_hat) + eps), then lr * (step + wd * p)
        step = torch.div(mu, bc1).div_(torch.div(nu, bc2).sqrt_()
                                       .add_(cfg.eps))
        p32 = p.float()
        step.add_(torch.mul(p32, cfg.weight_decay)).mul_(lr)
        return torch.sub(p32, step).to(p.dtype), mu, nu

    flat_g, spec = flatten(grads)
    out = [upd(g, m, n, p) for g, m, n, p in zip(
        flat_g, flatten(opt_state["mu"])[0], flatten(opt_state["nu"])[0],
        flatten(params)[0])]
    new_p = unflatten(spec, [o[0] for o in out])
    new_mu = unflatten(spec, [o[1] for o in out])
    new_nu = unflatten(spec, [o[2] for o in out])
    return new_p, {"mu": new_mu, "nu": new_nu, "count": count}, \
        {"grad_norm": gnorm, "lr": lr}


@torch.no_grad()
def adamw_update_(cfg: AdamWConfig, grads, opt_state, params):
    """``adamw_update`` in place: writes the new parameters, ``mu``, ``nu``
    and ``count`` into ``params`` and ``opt_state``. Returns the metrics
    {grad_norm, lr}."""
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, cfg.clip_norm)
    count = opt_state["count"].add_(1)
    lr, bc1, bc2 = _corrections(cfg, count)
    b1, b2 = cfg.b1, cfg.b2
    for g, mu, nu, p in zip(
            flatten(grads)[0], flatten(opt_state["mu"])[0],
            flatten(opt_state["nu"])[0], flatten(params)[0]):
        g32 = (g * scale).to(g.dtype).float()
        mu.mul_(b1).add_(torch.mul(g32, 1 - b1))
        nu.mul_(b2).add_(torch.square(g32).mul_(1 - b2))
        del g32
        step = torch.div(mu, bc1).div_(torch.div(nu, bc2).sqrt_()
                                       .add_(cfg.eps))
        p32 = p.float()            # p itself when p is fp32: read before
        step.add_(torch.mul(p32, cfg.weight_decay)).mul_(lr)
        p.copy_(torch.sub(p32, step))          # rounds as .to(p.dtype)
    return {"grad_norm": gnorm, "lr": lr}
