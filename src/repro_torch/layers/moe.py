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
atomic adds.

On DTensors (a mesh step) the data-dependent parts run as two local
regions (``torch.distributed.tensor.experimental.local_map``), each on
its local shard of D (over the data-parallel axes when they divide D;
otherwise every rank computes all of D, a replicated region): routing and
dispatch (``_dispatch``: router, queue positions, the (D, E, C, d) gather)
and the combine (``_combine``, on y gathered over "model"). Between them
the expert einsums run on DTensors pinned by the reference's
``_ep_constrain`` hint to (dp axes, "model"), so each rank computes its
experts only. On plain tensors the hints do nothing.

``moe_forward`` also returns the Switch load-balance aux loss, E * sum_e
f_e * P_e over every token of every shard (P_e: the mean fp32 router
probability of expert e; f_e: the share of tokens whose top-1 expert is
e), from the probabilities ``route`` computes. Training adds it to the
loss; the serving steps drop it.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.configs.base import MoEConfig
from repro_torch.layers.mlp import _act
from repro_torch.placement import P, constrain, dp_spec_for, local_region


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


def _ep_constrain(t, n_tail: int):
    """The reference's hint: pin (D, E, ...) tensors to (dp axes, "model",
    ...) (the dp axes only where they divide D). No-op on a plain
    tensor."""
    dp = dp_spec_for(t, t.shape[0])
    return constrain(t, P(dp, "model", *([None] * n_tail)))


def _dispatch(router, xf, opts: MoEOpts):
    """Shard-local routing and dispatch of xf (D, Tl, d): (xg (D, E, C, d)
    token rows by expert slot, gates (D, E, C), slot (D, Tl * k) each
    assignment's row of the flattened (E * C) outputs (E * C when
    dropped), probs (D, Tl, E) fp32, top-1 one-hot (D, Tl, E) fp32)."""
    c = opts.cfg
    D, Tl, d = xf.shape
    E, k = c.n_experts, c.top_k
    _, gate, expert, pos, C, probs = route({"router": router}, xf, opts)
    flat_e = expert.reshape(D, Tl * k)
    flat_g = gate.reshape(D, Tl * k).to(xf.dtype)
    keep = pos < C
    dev = xf.device
    token_id = torch.arange(Tl, device=dev).repeat_interleave(k)
    shard = torch.arange(D, device=dev)[:, None].expand(D, Tl * k)
    # dropped assignments land in the spare row E, which is cut off
    row = torch.where(keep, flat_e, E)
    col = torch.where(keep, pos, 0)
    disp = torch.full((D, E + 1, C), Tl, dtype=torch.long, device=dev)
    disp[shard, row, col] = token_id.expand(D, -1)
    gates_ec = torch.zeros((D, E + 1, C), dtype=xf.dtype, device=dev)
    gates_ec[shard, row, col] = flat_g
    disp, gates_ec = disp[:, :E], gates_ec[:, :E]
    xpad = torch.cat([xf, xf.new_zeros((D, 1, d))], dim=1)
    xg = xpad[torch.arange(D, device=dev)[:, None, None], disp]  # (D,E,C,d)
    slot = torch.where(keep, flat_e * C + pos, E * C)
    top1 = torch.nn.functional.one_hot(expert[..., 0], E).float()
    return xg, gates_ec, slot, probs, top1


def _combine(y, slot, k: int):
    """Each assignment's row of y (D, E, C, d) (a zero row when dropped),
    summed over the token's k assignments in top-k order -> (D, Tl, d)."""
    D, E, C, d = y.shape
    y = torch.cat([y.reshape(D, E * C, d), y.new_zeros((D, 1, d))], dim=1)
    yk = torch.gather(y, 1, slot[..., None].expand(D, slot.shape[1], d))
    yk = yk.reshape(D, -1, k, d)
    out = yk[:, :, 0]
    for j in range(1, k):
        out = out + yk[:, :, j]
    return out


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
    x_in = x
    if isinstance(x, DTensor):
        # tokens flatten batch-major: the sequence gathered first (a
        # sequence-sharded DTensor does not reshape across its shards)
        x = constrain(x, P(dp_spec_for(x, B), None, None))
    xf = x.reshape(D, Tl, d)
    dispatch, combine = _dispatch, _combine
    if isinstance(xf, DTensor):
        dispatch, combine = _mesh_regions(xf, opts)
    xg, gates_ec, slot, probs, top1 = dispatch(p["router"], xf, opts)
    # Switch aux loss: E * sum_e mean(probs_e) * mean(top1 == e), the means
    # over every token of every shard
    aux = E * torch.sum(torch.mean(probs, dim=(0, 1))
                        * torch.mean(top1, dim=(0, 1)))
    xg = _ep_constrain(xg, 2)
    act = _act(opts.act)
    h = act(torch.einsum("xecd,edf->xecf", xg, p["wg"].to(x.dtype))) \
        * torch.einsum("xecd,edf->xecf", xg, p["wu"].to(x.dtype))
    h = _ep_constrain(h, 2)
    y = torch.einsum("xecf,efd->xecd", h, p["wd"].to(x.dtype))
    y = _ep_constrain(y, 2)
    y = y * _ep_constrain(gates_ec, 1)[..., None]
    out = _as_placed_like(combine(y, slot, k).reshape(B, S, d), x_in)

    if c.n_shared:
        # on the (B, S, d) input: the same rows as the reference's (T, d)
        # flatten, and no view across a mesh-split token dim
        sp = p["shared"]
        g = act(x_in @ sp["wg"].to(x.dtype)) * (x_in @ sp["wu"].to(x.dtype))
        out = out + g @ sp["wd"].to(x.dtype)
    return out, aux


def _as_placed_like(y, x):
    """y in x's placements, a partial sum read as replicated (a no-op on
    plain tensors). The backward of this redistribute hands the (D, Tl,
    d) -> (B, S, d) view its gradient in y's own placement: a gradient
    split over more mesh axes than D's dp axes (the residual stream's
    batch split) is gathered first, where DTensor's view rule would give
    it a wrong local shape."""
    if not isinstance(y, DTensor):
        return y
    pl = tuple(Replicate() if q.is_partial() else q for q in x.placements)
    return y if tuple(y.placements) == pl else y.redistribute(x.device_mesh,
                                                              pl)


def _mesh_regions(xf, opts: MoEOpts):
    """``_dispatch`` and ``_combine`` as local regions on xf's mesh: D over
    the dp axes where they divide it, else replicated (every rank routes
    every token)."""
    mesh = xf.device_mesh
    dp = dp_spec_for(xf, xf.shape[0])
    dispatch = local_region(
        lambda r, x, o: _dispatch(r, x, o), mesh,
        in_specs=(P(None, None), P(dp, None, None), None),
        out_specs=(P(dp, None, None, None), P(dp, None, None),
                   P(dp, None), P(dp, None, None), P(dp, None, None)))
    combine = local_region(
        _combine, mesh, in_specs=(P(dp, None, None, None), P(dp, None), None),
        out_specs=P(dp, None, None))
    return dispatch, combine
