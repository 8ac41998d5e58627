"""Gated MLP (SwiGLU / GeGLU)."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _act(name: str):
    if name == "silu":
        return F.silu
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="tanh")
    raise ValueError(f"unknown act {name}")


def init_mlp(generator: torch.Generator, d_model: int, d_ff: int,
             dtype=torch.float32, device=None):
    def normal(shape, s):
        w = torch.randn(shape, generator=generator, device=generator.device,
                        dtype=dtype) * s
        return w.to(device)

    s_in, s_out = d_model ** -0.5, d_ff ** -0.5
    return {
        "wg": normal((d_model, d_ff), s_in),
        "wu": normal((d_model, d_ff), s_in),
        "wd": normal((d_ff, d_model), s_out),
    }


def mlp_forward(p, x, act: str = "silu"):
    g = x @ p["wg"].to(x.dtype)
    u = x @ p["wu"].to(x.dtype)
    h = _act(act)(g) * u
    return h @ p["wd"].to(x.dtype)
