"""Decoder-only LM for every decoder-only family (dense, MoE, SSM,
hybrid, VLM): plain functions over a parameter dict laid out as the
reference's pytree.

  init_lm(cfg, generator, device)                 -> params
  lm_forward(cfg, params, tokens, patches=None, remat=False)
                                                  -> (hidden, aux)  [train]
  lm_logits(cfg, params, hidden)                  -> logits
  lm_prefill(cfg, params, tokens, max_len, patches=None, caches=None)
                                                  -> (hidden, caches)
  lm_decode(cfg, params, caches, tok, pos)        -> (logits, caches)
  lm_decode_paged(cfg, params, caches, tok, pos, block_tables)

VLM (llava): ``patches`` (B, P, d_model), precomputed patch embeddings (the
vision tower is a stub, as in the reference), are prepended to the token
embeddings; positions then run over patches and tokens together.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import MIXER_SHARED_ATTN, ModelConfig
from repro_torch.layers.embeddings import embed, init_embedding
from repro_torch.layers.norms import rms_norm, softcap
from repro_torch.placement import place
from repro_torch.models.stages import (apply_stages, init_cache,
                                       init_paged_cache, init_shared_block,
                                       init_stage, plan_stages, reset_cache)


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _param_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


def init_lm(cfg: ModelConfig, generator: torch.Generator, device) -> dict:
    """Seeded weights drawn from ``generator`` (the reference's init
    distributions; torch's stream, so not the reference's numbers)."""
    pdt = _param_dtype(cfg)
    stages = plan_stages(cfg)
    params = {
        "embed": init_embedding(generator, cfg.vocab_size, cfg.d_model, pdt,
                                device),
        "final_norm": torch.zeros((cfg.d_model,), dtype=pdt, device=device),
        "stages": tuple(init_stage(cfg, st, generator, pdt, device)
                        for st in stages),
    }
    if not cfg.tie_embeddings:
        head = torch.randn((cfg.d_model, cfg.vocab_size), generator=generator,
                           device=generator.device, dtype=pdt)
        params["head"] = (head * cfg.d_model ** -0.5).to(device)
    if any(s.mixer == MIXER_SHARED_ATTN for st in stages for s in st.sites):
        params["shared"] = init_shared_block(cfg, generator, pdt, device)
    return params


def _embed_tokens(cfg, params, tokens, patches=None):
    x = embed(params["embed"], tokens.long(), scale_by_dim=cfg.embed_scale)
    x = x.to(_dtype(cfg))
    if patches is not None:
        x = torch.cat([patches.to(x.dtype), x], dim=1)
    return x


def _positions(x):
    B, S = x.shape[:2]
    return torch.arange(S, dtype=torch.int32,
                        device=x.device)[None, :].expand(B, S)


def lm_forward(cfg: ModelConfig, params, tokens, patches=None,
               remat: bool = False):
    """Teacher-forced full-sequence forward (training). Returns (hidden,
    the summed MoE aux loss)."""
    x = _embed_tokens(cfg, params, tokens, patches)
    x, aux = apply_stages(cfg, params, x, _positions(x), mode="train",
                          remat=remat)
    return rms_norm(x, params["final_norm"]), aux


def lm_logits(cfg: ModelConfig, params, h):
    """Tied (h @ E^T) or untied (h @ W_head) vocab projection."""
    w = params["embed"]["tok"].t() if cfg.tie_embeddings else params["head"]
    return softcap(h @ w.to(h.dtype), cfg.final_softcap)


def lm_prefill(cfg: ModelConfig, params, tokens, max_len: int, patches=None,
               clamp_window: bool = True, caches=None):
    """Run the prompt (``patches`` first, where given), building decode
    caches sized ``max_len``.

    ``clamp_window=False`` builds full-length (non-ring) caches even for
    windowed sites — the layout the paged page-splice expects. ``caches``
    (a tree of ``make_prefill_caches``'s for this batch, ``max_len`` and
    layout) is reset to its initial values and filled in place instead of
    a new tree: the result is bit for bit a new tree's, whatever an
    earlier prompt left in it."""
    x = _embed_tokens(cfg, params, tokens, patches)
    if caches is not None:
        reset_cache(caches)
    else:
        caches = _place_caches(cfg, lambda: init_cache(
            cfg, x.shape[0], max_len, _dtype(cfg), x.device,
            clamp_window=clamp_window), x)
    x = apply_stages(cfg, params, x, _positions(x), mode="prefill",
                     caches=caches)
    return rms_norm(x, params["final_norm"]), caches


def _place_caches(cfg: ModelConfig, make, x):
    """The caches a prefill builds (``make()``). On a DTensor prompt (a
    mesh step) they are placed by the decode cells' rules (the reference
    pins its prefill's output caches so) and filled shard by shard; the
    whole caches are made outside any dispatch mode (a cost analysis
    counts the shards a device holds, not a full copy that no device
    would)."""
    if not isinstance(x, DTensor):
        return make()
    from torch.utils._python_dispatch import _disable_current_modes
    from repro_torch.runtime.sharding import cache_specs   # runtime: models
    with _disable_current_modes():
        caches = make()
    mesh = x.device_mesh
    return place(caches, mesh, cache_specs(cfg, caches, mesh, x.shape[0]))


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


def make_decode_caches(cfg: ModelConfig, batch: int, max_len: int, device,
                       clamp_window: bool = True):
    """Empty caches for serving allocation (``clamp_window``: as
    ``lm_prefill``'s)."""
    return init_cache(cfg, batch, max_len, _dtype(cfg), device,
                      clamp_window=clamp_window)


def make_paged_caches(cfg: ModelConfig, n_pages: int, page_size: int,
                      device):
    """Empty paged KV pool (shared across every serving slot)."""
    return init_paged_cache(cfg, n_pages, page_size, _dtype(cfg), device)
