"""Losses. The vocab projection runs chunk by chunk over the sequence, each
chunk recomputed in the backward pass, so the full (B, S, V) logits never
materialize (the reference's ``runtime/losses.py``).

The label slices follow the reference exactly: chunk ``i`` reads ``h`` at
``[i*c, i*c + c)`` and the labels at a start clamped to ``[0, L - c]``,
as ``jax.lax.dynamic_slice_in_dim`` clamps it. They differ only where
``h`` is longer than the labels: a VLM batch, whose hidden states cover
the image patches and the tokens while its labels cover the tokens. The
reference then reads misaligned label slices; the port does the same
(ROADMAP, Queue 3). Where the reference raises (a chunk longer than the
labels), so does the port.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.layers.norms import softcap


def _vocab_weight(cfg: ModelConfig, params):
    return params["embed"]["tok"].t() if cfg.tie_embeddings \
        else params["head"]


def _xent_sum(h, w, labels, cap: float):
    """Sum over (B, c) of logsumexp - gold logit, fp32."""
    logits = softcap(h @ w.to(h.dtype), cap).float()
    if _vocab_sharded(logits):
        return torch.sum(_sharded_lse_minus_gold(logits, labels))
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.sum(lse - gold)


def _vocab_sharded(t) -> bool:
    from torch.distributed.tensor import DTensor, Shard
    return isinstance(t, DTensor) and any(
        isinstance(p, Shard) and p.dim == t.ndim - 1 for p in t.placements)


def _sharded_lse_minus_gold(logits, labels):
    """The same terms on vocab-sharded DTensor logits without gathering
    the vocabulary: the row max and the sum of exponentials reduce as
    partial values over the model axis, and the gold logit is a masked
    sum (``gather`` on a sharded dim is a masked partial that DTensor
    cannot reduce under the chunked loss)."""
    m = logits.detach().amax(dim=-1, keepdim=True)
    lse = torch.log(torch.sum(torch.exp(logits - m), dim=-1)) + m[..., 0]
    vocab = torch.arange(logits.shape[-1], device=logits.device)
    hit = labels[..., None].long() == vocab
    gold = torch.sum(torch.where(hit, logits, torch.zeros_like(logits)),
                     dim=-1)
    return lse - gold


def chunked_xent(cfg: ModelConfig, params, h, labels, *, chunk: int = 512):
    """Mean next-token cross-entropy. h (B,S,d), labels (B,S) (already
    shifted by the caller), over ``chunk`` slices of S (one slice when
    ``chunk`` does not divide S). Each slice's logits are recomputed in the
    backward pass (non-reentrant ``torch.utils.checkpoint``: the
    reference's ``jax.checkpoint``)."""
    B, S, _ = h.shape
    w = _vocab_weight(cfg, params)
    c = min(chunk, S)
    if S % c:
        c = S  # fall back to single chunk for ragged small seqs
    n_labels = labels.shape[1]
    if c > n_labels:
        raise ValueError(
            f"chunked_xent: a chunk of {c} positions is longer than the "
            f"{n_labels} labels (h has {S} positions); the reference's "
            "dynamic_slice_in_dim refuses such a slice")
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(S // c):
        start = min(i * c, n_labels - c)      # dynamic_slice_in_dim's clamp
        total = total + checkpoint(
            _xent_sum, h[:, i * c:(i + 1) * c], w,
            labels[:, start:start + c], cfg.final_softcap,
            use_reentrant=False)
    return total / (B * S)


def full_xent(cfg: ModelConfig, params, h, labels):
    """Unchunked reference (oracle for tests)."""
    if tuple(labels.shape) != tuple(h.shape[:2]):
        raise ValueError(f"full_xent: labels {tuple(labels.shape)} do not "
                         f"match h's positions {tuple(h.shape[:2])}")
    return _xent_sum(h, _vocab_weight(cfg, params), labels,
                     cfg.final_softcap) / labels.numel()
