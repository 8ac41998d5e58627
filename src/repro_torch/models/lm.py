"""Decoder-only LM for the dense attention families (smollm, phi3,
gemma2/3) and the pure-SSM family (mamba2): plain functions over a
parameter dict laid out as the reference's pytree.

  init_lm(cfg, generator, device)                 -> params
  lm_logits(cfg, params, hidden)                  -> logits
  lm_prefill(cfg, params, tokens, max_len)        -> (hidden, caches)
  lm_decode(cfg, params, caches, tok, pos)        -> (logits, caches)
  lm_decode_paged(cfg, params, caches, tok, pos, block_tables)
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.layers.embeddings import embed, init_embedding
from repro_torch.layers.norms import rms_norm, softcap
from repro_torch.models.stages import (apply_stages, init_cache,
                                       init_paged_cache, init_stage,
                                       plan_stages)


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _param_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


def init_lm(cfg: ModelConfig, generator: torch.Generator, device) -> dict:
    """Seeded weights drawn from ``generator`` (the reference's init
    distributions; torch's stream, so not the reference's numbers)."""
    pdt = _param_dtype(cfg)
    params = {
        "embed": init_embedding(generator, cfg.vocab_size, cfg.d_model, pdt,
                                device),
        "final_norm": torch.zeros((cfg.d_model,), dtype=pdt, device=device),
        "stages": tuple(init_stage(cfg, st, generator, pdt, device)
                        for st in plan_stages(cfg)),
    }
    if not cfg.tie_embeddings:
        head = torch.randn((cfg.d_model, cfg.vocab_size), generator=generator,
                           device=generator.device, dtype=pdt)
        params["head"] = (head * cfg.d_model ** -0.5).to(device)
    return params


def _embed_tokens(cfg, params, tokens):
    x = embed(params["embed"], tokens.long(), scale_by_dim=cfg.embed_scale)
    return x.to(_dtype(cfg))


def _positions(x):
    B, S = x.shape[:2]
    return torch.arange(S, dtype=torch.int32,
                        device=x.device)[None, :].expand(B, S)


def lm_logits(cfg: ModelConfig, params, h):
    """Tied (h @ E^T) or untied (h @ W_head) vocab projection."""
    w = params["embed"]["tok"].t() if cfg.tie_embeddings else params["head"]
    return softcap(h @ w.to(h.dtype), cfg.final_softcap)


def lm_prefill(cfg: ModelConfig, params, tokens, max_len: int,
               clamp_window: bool = True):
    """Run the prompt, building decode caches sized ``max_len``.

    ``clamp_window=False`` builds full-length (non-ring) caches even for
    windowed sites — the layout the paged page-splice expects."""
    x = _embed_tokens(cfg, params, tokens)
    caches = init_cache(cfg, x.shape[0], max_len, _dtype(cfg), x.device,
                        clamp_window=clamp_window)
    x = apply_stages(cfg, params, x, _positions(x), mode="prefill",
                     caches=caches)
    return rms_norm(x, params["final_norm"]), caches


def lm_decode(cfg: ModelConfig, params, caches, tokens, pos):
    """One decode step. tokens (B,1) int32, pos (B,) absolute positions.
    The caches are updated in place and returned."""
    x = _embed_tokens(cfg, params, tokens)
    positions = pos[:, None].to(torch.int32)
    x = apply_stages(cfg, params, x, positions, mode="decode", caches=caches)
    h = rms_norm(x, params["final_norm"])
    return lm_logits(cfg, params, h), caches


def lm_decode_paged(cfg: ModelConfig, params, caches, tokens, pos,
                    block_tables):
    """One decode step against the paged KV pool. tokens (B,1) int32;
    pos (B,) absolute positions (-1 = inactive row); block_tables (B, nb)
    int32 page ids. The pool is updated in place and returned."""
    x = _embed_tokens(cfg, params, tokens)
    positions = pos[:, None].to(torch.int32)
    x = apply_stages(cfg, params, x, positions, mode="decode", caches=caches,
                     block_tables=block_tables)
    h = rms_norm(x, params["final_norm"])
    return lm_logits(cfg, params, h), caches


def make_decode_caches(cfg: ModelConfig, batch: int, max_len: int, device):
    """Empty caches for serving allocation."""
    return init_cache(cfg, batch, max_len, _dtype(cfg), device)


def make_paged_caches(cfg: ModelConfig, n_pages: int, page_size: int,
                      device):
    """Empty paged KV pool (shared across every serving slot)."""
    return init_paged_cache(cfg, n_pages, page_size, _dtype(cfg), device)
