"""Normalization layers (plain functions over parameter dicts)."""
from __future__ import annotations

import torch


def rms_norm(x, weight, eps: float = 1e-6, *, plus_one: bool = True):
    """RMSNorm. ``plus_one`` follows gemma convention (weight stored as w-1)."""
    dtype = x.dtype
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    x32 = x32 * torch.rsqrt(var + eps)
    w = weight.float()
    if plus_one:
        w = w + 1.0
    return (x32 * w).to(dtype)


def softcap(x, cap: float):
    """Gemma-style logit soft-capping: cap * tanh(x / cap)."""
    if not cap:
        return x
    return cap * torch.tanh(x / cap)
