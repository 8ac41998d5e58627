"""Rotary position embeddings."""
from __future__ import annotations

import torch


def rope_freqs(head_dim: int, theta: float, device=None):
    """Inverse frequencies, shape (head_dim//2,)."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)


def apply_rope(x, positions, theta: float = 10000.0):
    """Rotate ``x`` of shape (..., seq, heads, head_dim) by ``positions`` (..., seq).

    Uses the split-halves convention (llama/gemma): the head_dim is split into
    two halves rather than interleaved pairs.
    """
    head_dim = x.shape[-1]
    inv = rope_freqs(head_dim, theta, x.device)                # (hd/2,)
    ang = positions[..., :, None].float() * inv                # (..., seq, hd/2)
    sin = torch.sin(ang)[..., :, None, :]                      # (..., seq, 1, hd/2)
    cos = torch.cos(ang)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
