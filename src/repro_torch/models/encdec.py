"""Encoder-decoder model (whisper-tiny backbone).

The conv/mel frontend is a stub, as in the reference: inputs are
precomputed frame embeddings (B, F, d_model). Sinusoidal positions replace
whisper's learned embeddings (the reference's documented deviation).

The encoder is bidirectional and rope-free, so its self-attention takes the
einsum path, as does cross-attention (the flash kernel takes causal
self-attention only, as the reference's). The decoder's causal
self-attention takes the flash kernel at prefill and the decode kernel
over its ``DEC_MAX_LEN`` cache at decode; cross-attention reads a fixed
cache of the encoder output's K/V (``attn_decode(..., update_cache=False)``).

The stacked ``enc_layers`` / ``dec_layers`` (the reference's ``lax.scan``
over the stack) run as a Python loop over layer views; the self-attention
caches are filled and updated in place.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ATTN_GLOBAL, ModelConfig
from repro_torch.layers.attention import (attn_decode, attn_forward,
                                          fill_kv_cache, init_attention,
                                          init_kv_cache)
from repro_torch.layers.embeddings import (embed, init_embedding,
                                           sinusoidal_positions)
from repro_torch.layers.mlp import init_mlp, mlp_forward
from repro_torch.layers.norms import rms_norm
from repro_torch.models.lm import _place_caches
from repro_torch.models.stages import LayerSite, _stack, _unstack, attn_opts

DEC_MAX_LEN = 448


def _enc_cfg(cfg: ModelConfig) -> ModelConfig:
    return cfg.replace(causal=False, use_rope=False,
                       n_layers=cfg.encoder.n_layers)


def _site(cfg) -> LayerSite:
    return LayerSite(ATTN_GLOBAL, "dense", cfg.d_ff, cfg.rope_theta)


def _self_opts(cfg):
    return attn_opts(cfg, _site(cfg))


def _cross_opts(cfg):
    ecfg = _enc_cfg(cfg)
    return attn_opts(ecfg, _site(ecfg))


def _arange(B, n, device):
    return torch.arange(n, dtype=torch.int32, device=device)[None] \
        .expand(B, n)


def init_encdec(cfg: ModelConfig, generator: torch.Generator,
                device) -> dict:
    """Seeded weights (the reference's init distributions; torch's stream,
    so not the reference's numbers)."""
    pdt = getattr(torch, cfg.param_dtype)
    z = lambda: torch.zeros((cfg.d_model,), dtype=pdt, device=device)

    def attn(opts):
        return init_attention(generator, cfg.d_model, opts, pdt, device)

    def mlp():
        return init_mlp(generator, cfg.d_model, cfg.d_ff, pdt, device)

    enc = [{"norm1": z(), "norm2": z(), "attn": attn(_cross_opts(cfg)),
            "mlp": mlp()} for _ in range(cfg.encoder.n_layers)]
    dec = [{"norm1": z(), "norm2": z(), "norm3": z(),
            "self_attn": attn(_self_opts(cfg)),
            "cross_attn": attn(_cross_opts(cfg)), "mlp": mlp()}
           for _ in range(cfg.n_layers)]
    return {
        "embed": init_embedding(generator, cfg.vocab_size, cfg.d_model, pdt,
                                device),
        "enc_layers": _stack(enc),
        "enc_norm": z(),
        "dec_layers": _stack(dec),
        "final_norm": z(),
    }


def encode(cfg: ModelConfig, params, frames):
    """frames (B, F, d_model) precomputed embeddings -> (B, F, d_model)."""
    dt = getattr(torch, cfg.dtype)
    B, F, _ = frames.shape
    x = frames.to(dt) + sinusoidal_positions(F, cfg.d_model, dt,
                                             frames.device)[None]
    pos = _arange(B, F, frames.device)
    opts = _cross_opts(cfg)
    for p in _unstack(params["enc_layers"], cfg.encoder.n_layers):
        y, _ = attn_forward(p["attn"], rms_norm(x, p["norm1"]), pos, opts)
        x = x + y
        x = x + mlp_forward(p["mlp"], rms_norm(x, p["norm2"]), cfg.act)
    return rms_norm(x, params["enc_norm"])


def _embed_dec(cfg, params, tokens):
    dt = getattr(torch, cfg.dtype)
    St = tokens.shape[1]
    x = embed(params["embed"], tokens.long()).to(dt)
    return x + sinusoidal_positions(St, cfg.d_model, dt, x.device)[None]


def _decoder(cfg, params, tokens, enc_out, caches=None):
    """Teacher-forced decoder over ``enc_out``; with ``caches`` (from
    ``make_encdec_caches``) the self-attention caches and cross K/V are
    filled in place. Returns the final-normed hidden (B, St, d)."""
    B, St = tokens.shape
    x = _embed_dec(cfg, params, tokens)
    pos = _arange(B, St, x.device)
    enc_pos = _arange(B, enc_out.shape[1], x.device)
    self_opts, cross_opts = _self_opts(cfg), _cross_opts(cfg)
    self_caches = None if caches is None else \
        _unstack(caches["self"], cfg.n_layers)
    for i, p in enumerate(_unstack(params["dec_layers"], cfg.n_layers)):
        y, (k, v) = attn_forward(p["self_attn"], rms_norm(x, p["norm1"]),
                                 pos, self_opts)
        x = x + y
        y, (ck, cv) = attn_forward(p["cross_attn"], rms_norm(x, p["norm2"]),
                                   pos, cross_opts, kv_src=enc_out,
                                   kv_pos=enc_pos)
        x = x + y
        x = x + mlp_forward(p["mlp"], rms_norm(x, p["norm3"]), cfg.act)
        if caches is not None:
            fill_kv_cache(self_caches[i], k, v, pos)
            caches["cross_k"][i] = ck
            caches["cross_v"][i] = cv
    return rms_norm(x, params["final_norm"])


def decoder_forward(cfg: ModelConfig, params, tokens, enc_out):
    """Teacher-forced decoder. tokens (B, St). Returns hidden (B, St, d)."""
    return _decoder(cfg, params, tokens, enc_out)


def encdec_forward(cfg: ModelConfig, params, frames, tokens,
                   remat: bool = False):
    """Full training forward. Returns (hidden, aux = 0). ``remat`` is
    taken and ignored, as in the reference (its encoder-decoder is not
    rematerialized)."""
    h = decoder_forward(cfg, params, tokens, encode(cfg, params, frames))
    return h, torch.zeros((), dtype=torch.float32, device=h.device)


def encdec_logits(cfg: ModelConfig, params, h):
    return h @ params["embed"]["tok"].t().to(h.dtype)


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def make_encdec_caches(cfg: ModelConfig, batch: int, enc_len: int, device):
    """Empty caches: self-attention caches of DEC_MAX_LEN, cross K/V over
    ``enc_len`` encoder positions, stacked over the decoder layers."""
    dt = getattr(torch, cfg.dtype)
    L = cfg.n_layers
    one = init_kv_cache(batch, DEC_MAX_LEN, _self_opts(cfg), dt,
                        device=device)
    cross = (L, batch, enc_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {
        "self": {k: v[None].repeat((L,) + (1,) * v.dim())
                 for k, v in one.items()},
        "cross_k": torch.zeros(cross, dtype=dt, device=device),
        "cross_v": torch.zeros(cross, dtype=dt, device=device),
    }


def encdec_prefill(cfg: ModelConfig, params, frames, prompt):
    """Encode + run the decoder prompt; build the self-attention caches
    and the cross-attention K/V. Returns (hidden, caches)."""
    enc_out = encode(cfg, params, frames)
    caches = _place_caches(cfg, lambda: make_encdec_caches(
        cfg, frames.shape[0], enc_out.shape[1], frames.device), enc_out)
    h = _decoder(cfg, params, prompt, enc_out, caches)
    return h, caches


def encdec_decode(cfg: ModelConfig, params, caches, tokens, pos):
    """One decode token against the self caches (updated in place) and the
    fixed cross K/V. tokens (B,1) int32, pos (B,). Returns (logits,
    caches)."""
    dt = getattr(torch, cfg.dtype)
    B = tokens.shape[0]
    x = embed(params["embed"], tokens.long()).to(dt)
    posc = pos.clamp(0, DEC_MAX_LEN - 1).long()
    x = x + sinusoidal_positions(DEC_MAX_LEN, cfg.d_model, dt,
                                 x.device)[posc][:, None]
    positions = pos[:, None].to(torch.int32)
    self_opts, cross_opts = _self_opts(cfg), _cross_opts(cfg)
    F = caches["cross_k"].shape[2]
    cross_pos = _arange(B, F, x.device)
    self_caches = _unstack(caches["self"], cfg.n_layers)
    for i, p in enumerate(_unstack(params["dec_layers"], cfg.n_layers)):
        y, _ = attn_decode(p["self_attn"], rms_norm(x, p["norm1"]),
                           positions, self_caches[i], self_opts)
        x = x + y
        # cross attention: fixed cache, all positions valid
        cross = {"k": caches["cross_k"][i], "v": caches["cross_v"][i],
                 "pos": cross_pos}
        y, _ = attn_decode(p["cross_attn"], rms_norm(x, p["norm2"]),
                           positions, cross, cross_opts, update_cache=False)
        x = x + y
        x = x + mlp_forward(p["mlp"], rms_norm(x, p["norm3"]), cfg.act)
    h = rms_norm(x, params["final_norm"])
    return encdec_logits(cfg, params, h), caches
