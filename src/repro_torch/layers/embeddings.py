"""Token embeddings."""
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

