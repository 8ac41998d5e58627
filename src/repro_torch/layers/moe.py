"""Mixture-of-Experts layer with capacity-based gather/scatter dispatch.

The reference's dispatch, step for step:
  1. fp32 router logits and softmax -> top_k experts per token (ties go to
     the lower expert index, as ``jax.lax.top_k`` orders them);
  2. position-in-expert via a cumsum over the flattened (Tl * k)
     assignment list, token-major; assignments at or past the expert's
     capacity C are dropped;
  3. gather tokens into (D, E, C, d) through the (E, C) dispatch table
     (pad sentinel Tl, a zero row), run every expert's SwiGLU as one batched
     einsum over all E experts, multiply by the gate in the activation
     dtype, combine each token's k expert outputs, add the shared experts.

Capacity is taken over every token handed in, padding and idle rows
included (the engine pads a prefill to a power-of-two bucket and runs every
slot in a decode step): they compete with live tokens for expert slots, as
in the reference.

The combine gathers each token's k outputs (T, k, d) and sums them in the
order of its top-k list, so the result does not depend on the order of
atomic adds. The reference's ``_ep_constrain`` sharding hint has no
counterpart on one device.

``moe_forward`` also returns the Switch load-balance aux loss, E * sum_e
f_e * P_e over every token of every shard (P_e: the mean fp32 router
probability of expert e; f_e: the share of tokens whose top-1 expert is
e), from the probabilities ``route`` computes. Training adds it to the
loss; the serving steps drop it.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import MoEConfig
from repro_torch.layers.mlp import _act


@dataclasses.dataclass(frozen=True)
class MoEOpts:
    cfg: MoEConfig
    act: str = "silu"
    norm_topk: bool = True


def init_moe(generator: torch.Generator, d_model: int, opts: MoEOpts,
             dtype=torch.float32, device=None):
    """The reference's init distributions; the router is float32 whatever
    ``dtype`` is, as in the reference."""
    c = opts.cfg

    def normal(shape, s, dt=dtype):
        w = torch.randn(shape, generator=generator, device=generator.device,
                        dtype=dt) * s
        return w.to(device)

    s_in, s_out = d_model ** -0.5, c.d_expert ** -0.5
    p = {
        "router": normal((d_model, c.n_experts), s_in, torch.float32),
        "wg": normal((c.n_experts, d_model, c.d_expert), s_in),
        "wu": normal((c.n_experts, d_model, c.d_expert), s_in),
        "wd": normal((c.n_experts, c.d_expert, d_model), s_out),
    }
    if c.n_shared:
        f = c.n_shared * c.d_expert
        p["shared"] = {"wg": normal((d_model, f), s_in),
                       "wu": normal((d_model, f), s_in),
                       "wd": normal((f, d_model), f ** -0.5)}
    return p


def capacity(n_tokens: int, cfg: MoEConfig) -> int:
    c = int(n_tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts) + 1
    return max(4, -(-c // 4) * 4)  # round up to multiple of 4


def route(p, xf, opts: MoEOpts):
    """Router and queue positions for shard-local tokens xf (D, Tl, d).

    Returns (probs sorted descending (D, Tl, E) fp32, gates (D, Tl, k)
    fp32, experts (D, Tl, k), position of each assignment in its expert's
    queue (D, Tl * k), capacity C, the unsorted probs (D, Tl, E) fp32). An
    assignment is kept when its position is below C."""
    c = opts.cfg
    Tl = xf.shape[1]
    logits = torch.einsum("dtc,ce->dte", xf.float(), p["router"].float())
    probs = torch.softmax(logits, dim=-1)
    # a stable descending sort puts the lower index first on ties
    sorted_p, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, expert = sorted_p[..., :c.top_k], order[..., :c.top_k]
    if opts.norm_topk:
        gate = gate / (gate.sum(dim=-1, keepdim=True) + 1e-9)
    flat_e = expert.reshape(xf.shape[0], Tl * c.top_k)
    onehot = torch.nn.functional.one_hot(flat_e, c.n_experts)
    pos = torch.cumsum(onehot, dim=1).gather(-1, flat_e[..., None])[..., 0] - 1
    return sorted_p, gate, expert, pos, capacity(Tl, c), probs


def load_balance_loss(probs, expert, n_experts: int):
    """Switch aux loss: E * sum_e mean(probs_e) * mean(top1 == e), the
    means over every token of every shard."""
    me = torch.mean(probs, dim=(0, 1))                              # (E,)
    top1 = torch.nn.functional.one_hot(expert[..., 0], n_experts).float()
    return n_experts * torch.sum(me * torch.mean(top1, dim=(0, 1)))


def moe_forward(p, x, opts: MoEOpts):
    """x (B, S, d) -> (y (B, S, d), aux loss, a 0-d fp32 tensor).
    Dispatch is shard-local: tokens reshape to (D, Tl) with D =
    cfg.dp_shards when it divides B * S (1 otherwise), and capacity is per
    shard, as in the reference."""
    c = opts.cfg
    B, S, d = x.shape
    T = B * S
    D = c.dp_shards if T % c.dp_shards == 0 else 1
    Tl = T // D
    E, k = c.n_experts, c.top_k
    xf = x.reshape(D, Tl, d)
    _, gate, expert, pos, C, probs = route(p, xf, opts)
    aux = load_balance_loss(probs, expert, E)
    flat_e = expert.reshape(D, Tl * k)
    flat_g = gate.reshape(D, Tl * k).to(x.dtype)
    keep = pos < C
    dev = x.device
    token_id = torch.arange(Tl, device=dev).repeat_interleave(k)
    shard = torch.arange(D, device=dev)[:, None].expand(D, Tl * k)
    # dropped assignments land in the spare row E, which is cut off
    row = torch.where(keep, flat_e, E)
    col = torch.where(keep, pos, 0)
    disp = torch.full((D, E + 1, C), Tl, dtype=torch.long, device=dev)
    disp[shard, row, col] = token_id.expand(D, -1)
    gates_ec = torch.zeros((D, E + 1, C), dtype=x.dtype, device=dev)
    gates_ec[shard, row, col] = flat_g
    disp, gates_ec = disp[:, :E], gates_ec[:, :E]

    xpad = torch.cat([xf, xf.new_zeros((D, 1, d))], dim=1)
    xg = xpad[torch.arange(D, device=dev)[:, None, None], disp]  # (D,E,C,d)
    act = _act(opts.act)
    h = act(torch.einsum("xecd,edf->xecf", xg, p["wg"].to(x.dtype))) \
        * torch.einsum("xecd,edf->xecf", xg, p["wu"].to(x.dtype))
    y = torch.einsum("xecf,efd->xecd", h, p["wd"].to(x.dtype))
    y = y * gates_ec[..., None]

    # combine: each assignment's row of y (a zero row when dropped), summed
    # over the token's k assignments in top-k order
    y = torch.cat([y.reshape(D, E * C, d), y.new_zeros((D, 1, d))], dim=1)
    slot = torch.where(keep, flat_e * C + pos, E * C)
    yk = torch.gather(y, 1, slot[..., None].expand(D, Tl * k, d))
    yk = yk.reshape(D, Tl, k, d)
    out = yk[:, :, 0]
    for j in range(1, k):
        out = out + yk[:, :, j]

    if c.n_shared:
        sp = p["shared"]
        xfl = xf.reshape(T, d)
        g = act(xfl @ sp["wg"].to(x.dtype)) * (xfl @ sp["wu"].to(x.dtype))
        out = out.reshape(T, d) + g @ sp["wd"].to(x.dtype)
    return out.reshape(B, S, d), aux
