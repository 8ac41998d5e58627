"""Token embeddings and sinusoidal positions."""
from __future__ import annotations

import torch


def init_embedding(generator: torch.Generator, vocab: int, d_model: int,
                   dtype=torch.float32, device=None):
    tok = torch.randn((vocab, d_model), generator=generator,
                      device=generator.device, dtype=dtype) * d_model ** -0.5
    return {"tok": tok.to(device)}


def embed(p, tokens, scale_by_dim: bool = False):
    x = p["tok"][tokens]
    if scale_by_dim:
        x = x * torch.tensor(x.shape[-1] ** 0.5, dtype=x.dtype)
    return x



def sinusoidal_positions(seq: int, d_model: int, dtype=torch.float32,
                         device=None):
    """(seq, d_model) sin | cos table, computed in fp32 (whisper's stub
    frontends use it in place of learned positions)."""
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(0, d_model, 2, dtype=torch.float32,
                       device=device)[None, :]
    # one fp32 scalar uploaded a call (whisper's decode step rebuilds the
    # table every step, as the reference's does)
    base = torch.tensor(10000.0, device=device)  # rc3e: allow-host-sync
    ang = pos / torch.pow(base, dim / d_model)
    pe = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
    return pe[:, :d_model].to(dtype)
