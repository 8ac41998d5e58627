"""Gradient compression for the data-parallel exchange: int8 quantization
with error feedback (the reference's ``optim/compress.py``).

Each rank quantizes its local gradient to int8 (one fp32 scale a tensor),
all-gathers the int8 payload and the scales over a ``torch.distributed``
group, dequantizes and averages locally, and keeps the quantization
residual, adding it back the next step (error feedback preserves
convergence; Seide et al. 2014, Karimireddy et al. 2019). The exchange is
an all-gather, never an int8 all-reduce, whose sums would overflow.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.tree import flatten, tree_map, unflatten


def quantize_int8(x) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8. Returns (q, scale). ``torch.round``
    rounds half to even, as ``jnp.round`` does."""
    x32 = x.float()
    amax = torch.max(torch.abs(x32))
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q, scale):
    return q.float() * scale


@torch.no_grad()
def compressed_psum(grads, residuals, group=None):
    """int8 all-gather mean with error feedback over ``group`` (the default
    group when None). Every leaf's payload goes in one int8 all-gather and
    every scale in one fp32 all-gather. The new residuals are written into
    ``residuals`` in place. Returns (mean_grads, residuals)."""
    import torch.distributed as dist
    flat_g, spec = flatten(grads)
    qs, scales = [], []
    for g, r in zip(flat_g, flatten(residuals)[0]):
        g32 = g.float() + r                              # add error feedback
        q, scale = quantize_int8(g32)
        r.copy_(g32 - dequantize_int8(q, scale))         # local residual
        qs.append(q.reshape(-1))
        scales.append(scale)
    n = dist.get_world_size(group)
    payload = torch.cat(qs)
    wire_q = payload.new_empty((n,) + payload.shape)     # int8 on the wire
    wire_s = torch.empty((n, len(scales)), dtype=torch.float32,
                         device=payload.device)
    dist.all_gather(list(wire_q.unbind(0)), payload, group=group)
    dist.all_gather(list(wire_s.unbind(0)), torch.stack(scales), group=group)
    out, off = [], 0
    for i, g in enumerate(flat_g):
        size = g.numel()
        deq = wire_q[:, off:off + size].float() * wire_s[:, i:i + 1]
        out.append(torch.mean(deq, dim=0).reshape(g.shape).to(g.dtype))
        off += size
    return unflatten(spec, out), residuals


def init_residuals(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def wire_bytes_fp32(grads) -> int:
    return sum(x.numel() * 4 for x in flatten(grads)[0])


def wire_bytes_int8(grads) -> int:
    return sum(x.numel() * 1 + 4 for x in flatten(grads)[0])
