"""Multi-head Latent Attention (DeepSeek-V2) with a compressed-latent KV
cache.

Prefill uses the expanded formulation (per-head K/V materialised from the
latent). Decode uses the absorbed formulation: queries are projected into
the latent space through W_uk, so the cache stays compressed: (B, L,
kv_lora_rank) latents plus (B, L, rope_dim) shared rope keys. Scores
accumulate in fp32 (the reference's ``preferred_element_type``).

MLA runs outside any kernel, as in the reference: every contraction is a
``torch.einsum``. Caches are filled and updated IN PLACE.

The reference's ``init_mla`` sets ``kv_norm`` to 0 and ``_latent`` applies
``rms_norm(..., plus_one=False)``, so a freshly initialised layer has a
zero latent and an output of exactly 0; the port keeps that init.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import MLAConfig
from repro_torch.layers.attention import write_cache
from repro_torch.layers.norms import rms_norm
from repro_torch.layers.rope import apply_rope

NEG_INF = -2.3819763e38


@dataclasses.dataclass(frozen=True)
class MLAOpts:
    n_heads: int
    cfg: MLAConfig
    rope_theta: float = 10000.0
    q_chunk: int = 256

    @property
    def scale(self) -> float:
        c = self.cfg
        return (c.qk_nope_head_dim + c.qk_rope_head_dim) ** -0.5


def init_mla(generator: torch.Generator, d_model: int, opts: MLAOpts,
             dtype=torch.float32, device=None):
    c = opts.cfg
    h = opts.n_heads

    def normal(shape, s):
        w = torch.randn(shape, generator=generator, device=generator.device,
                        dtype=dtype) * s
        return w.to(device)

    s = d_model ** -0.5
    r = c.kv_lora_rank
    qd = c.qk_nope_head_dim + c.qk_rope_head_dim
    return {
        "wq": normal((d_model, h, qd), s),
        "w_dkv": normal((d_model, r + c.qk_rope_head_dim), s),
        "kv_norm": torch.zeros((r,), dtype=dtype, device=device),
        "w_uk": normal((r, h, c.qk_nope_head_dim), r ** -0.5),
        "w_uv": normal((r, h, c.v_head_dim), r ** -0.5),
        "wo": normal((h, c.v_head_dim, d_model), s),
    }


def _project_q(p, x, positions, opts: MLAOpts):
    """Returns q_nope (B,S,h,nope), q_rope (B,S,h,rope)."""
    c = opts.cfg
    q = torch.einsum("bsd,dhq->bshq", x, p["wq"].to(x.dtype))
    q_nope = q[..., :c.qk_nope_head_dim]
    q_rope = apply_rope(q[..., c.qk_nope_head_dim:], positions,
                        opts.rope_theta)
    return q_nope, q_rope


def _latent(p, x, positions, opts: MLAOpts):
    """Compressed latent ``c_kv`` (B,S,r) + shared rope key (B,S,rope)."""
    r = opts.cfg.kv_lora_rank
    dkv = torch.einsum("bsd,dr->bsr", x, p["w_dkv"].to(x.dtype))
    c_kv = rms_norm(dkv[..., :r], p["kv_norm"], plus_one=False)
    k_rope = apply_rope(dkv[..., r:][:, :, None, :], positions,
                        opts.rope_theta)[:, :, 0]
    return c_kv, k_rope


def _attend(q_nope, q_rope, k_nope, k_rope, v, q_pos, k_pos, opts: MLAOpts):
    scores = (torch.einsum("bqhn,bshn->bhqs", q_nope.float(), k_nope.float())
              + torch.einsum("bqhr,bsr->bhqs", q_rope.float(),
                             k_rope.float()))
    scores = scores * opts.scale
    mask = q_pos[:, :, None] >= k_pos[:, None, :]
    scores = scores.masked_fill(~mask[:, None], NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhqs,bshv->bqhv", probs, v)


def mla_forward(p, x, positions, opts: MLAOpts):
    """Expanded-form full-sequence MLA. Returns (y, (c_kv, k_rope)).
    Queries are taken in chunks of ``q_chunk`` when the sequence is longer
    than one chunk and a multiple of it, as in the reference."""
    S = x.shape[1]
    q_nope, q_rope = _project_q(p, x, positions, opts)
    c_kv, k_rope = _latent(p, x, positions, opts)
    k_nope = torch.einsum("bsr,rhn->bshn", c_kv, p["w_uk"].to(x.dtype))
    v = torch.einsum("bsr,rhn->bshn", c_kv, p["w_uv"].to(x.dtype))
    qc = opts.q_chunk
    if qc and S > qc and S % qc == 0:
        y = torch.cat([
            _attend(q_nope[:, i:i + qc], q_rope[:, i:i + qc], k_nope,
                    k_rope, v, positions[:, i:i + qc], positions, opts)
            for i in range(0, S, qc)], dim=1)
    else:
        y = _attend(q_nope, q_rope, k_nope, k_rope, v, positions, positions,
                    opts)
    out = torch.einsum("bshv,hvd->bsd", y, p["wo"].to(x.dtype))
    return out, (c_kv, k_rope)


# ---------------------------------------------------------------------------
# Decode: absorbed formulation, compressed cache
# ---------------------------------------------------------------------------

def init_mla_cache(batch: int, cache_len: int, opts: MLAOpts, dtype,
                   device=None):
    c = opts.cfg
    return {
        "c_kv": torch.zeros((batch, cache_len, c.kv_lora_rank), dtype=dtype,
                            device=device),
        "k_rope": torch.zeros((batch, cache_len, c.qk_rope_head_dim),
                              dtype=dtype, device=device),
        "pos": torch.full((batch, cache_len), -1, dtype=torch.int32,
                          device=device),
    }


def fill_mla_cache(cache, c_kv, k_rope, positions):
    """Write prefill latents (B,S,·) at ring index ``positions % L``, in
    place (``write_cache``; on DTensor caches a local region a shard).
    Returns the cache."""
    write_cache(cache, {"c_kv": c_kv, "k_rope": k_rope, "pos": positions},
                positions)
    return cache


def mla_decode(p, x, positions, cache, opts: MLAOpts):
    """Absorbed decode: scores and values in the compressed latent space.
    x (B,1,d); positions (B,1). Returns (y, cache) with the cache updated
    in place."""
    q_nope, q_rope = _project_q(p, x, positions, opts)      # (B,1,h,·)
    c_kv_t, k_rope_t = _latent(p, x, positions, opts)
    write_cache(cache, {"c_kv": c_kv_t[:, 0], "k_rope": k_rope_t[:, 0],
                        "pos": positions[:, 0]}, positions[:, 0])
    # absorb W_uk into the query: q_lat (B,1,h,r)
    q_lat = torch.einsum("bqhn,rhn->bqhr", q_nope, p["w_uk"].to(x.dtype))
    scores = (torch.einsum("bqhr,bsr->bhqs", q_lat.float(),
                           cache["c_kv"].float())
              + torch.einsum("bqhr,bsr->bhqs", q_rope.float(),
                             cache["k_rope"].float())) * opts.scale
    kpos = cache["pos"]
    mask = (positions[:, :, None] >= kpos[:, None, :]) \
        & (kpos >= 0)[:, None, :]
    scores = scores.masked_fill(~mask[:, None], NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    o_lat = torch.einsum("bhqs,bsr->bqhr", probs,
                         cache["c_kv"].to(x.dtype))
    y = torch.einsum("bqhr,rhv->bqhv", o_lat, p["w_uv"].to(x.dtype))
    out = torch.einsum("bshv,hvd->bsd", y, p["wo"].to(x.dtype))
    return out, cache
