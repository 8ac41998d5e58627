"""Stage planner and stage execution for every decoder-only family: the
dense attention families, MoE (qwen3-moe; deepseek with MLA attention and a
dense first layer), the pure-SSM family (mamba2), the hybrid (zamba2: a
Mamba2 backbone with one shared attention+MLP block at every
``shared_attn`` site) and the VLM's language model (llava).

``plan_stages`` is the reference's planner, copied: a *site* is one layer's
static description (mixer kind, mlp kind, rope theta, window); consecutive
identical sites form a "run" stage (weights stacked over the run) and a
repeating multi-site pattern (gemma2/3 local/global alternation, zamba2's
[5 x ssm, shared_attn]) forms a "pattern" stage (each period position
stacked over the repeats). The reference scans over the stacked weights
with ``lax.scan``; here a Python loop indexes them layer by layer.
Parameters and caches keep the reference's stacked layout, so the JAX
parameter pytree maps onto them one to one (``repro_torch.interop``). A
``shared_attn`` site holds no weights of its own (``{}``): they live in
``params["shared"]``. Caches are updated in place: layer ``i`` works on
views ``leaf[i]`` of the stacked cache tensors (an SSM site's final state
and conv tail are written into its view at prefill).

Modes: "prefill" and "decode" serve (caches filled or updated in place;
the MoE load-balance aux loss is dropped); "train" runs the full sequence
with no cache and returns the summed aux loss beside the hidden states.
With ``remat`` each run-stage layer body, and each pattern-stage pattern
body, is recomputed in the backward pass (non-reentrant
``torch.utils.checkpoint``), where the reference puts ``jax.checkpoint``.
With ``remat`` and tensor parallelism (``cfg.tp_mode`` "tp") each body
gathers its input over the sequence (``_gather_act``) and shards its
output's sequence over "model" (``_seq_shard``): the reference's
Megatron-SP hints, which do nothing on plain tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import (ATTN_LOCAL, MIXER_SHARED_ATTN,
                                      MIXER_SSM, ModelConfig)
from repro_torch.layers.attention import (AttnOpts, attn_decode,
                                          attn_decode_paged, attn_forward,
                                          fill_kv_cache, init_attention,
                                          init_kv_cache, init_paged_kv_pool)
from repro_torch.layers.mla import (MLAOpts, fill_mla_cache, init_mla,
                                    init_mla_cache, mla_decode, mla_forward)
from repro_torch.layers.mlp import init_mlp, mlp_forward
from repro_torch.layers.moe import MoEOpts, init_moe, moe_forward
from repro_torch.layers.norms import rms_norm
from repro_torch.placement import P, constrain, dp_spec_for
from repro_torch.layers.ssm import (SSMOpts, fill_ssm_cache, init_ssm,
                                    init_ssm_cache, ssm_decode, ssm_forward)


# ---------------------------------------------------------------------------
# Static plan (copied from the reference)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LayerSite:
    mixer: str                  # global | local | ssm | shared_attn
    mlp: str                    # dense | moe | none
    d_ff: int = 0
    rope_theta: float = 10000.0
    window: int = 0


@dataclasses.dataclass(frozen=True)
class Stage:
    kind: str                   # run | pattern
    sites: Tuple[LayerSite, ...]
    repeats: int


def _make_site(cfg: ModelConfig, i: int) -> LayerSite:
    mixer = cfg.layer_kinds()[i]
    if mixer == MIXER_SSM:
        return LayerSite(mixer=mixer, mlp="none")
    theta = cfg.rope_theta
    window = 0
    if mixer == ATTN_LOCAL:
        window = cfg.window
        if cfg.rope_local_theta:
            theta = cfg.rope_local_theta
    if mixer == MIXER_SHARED_ATTN:
        return LayerSite(mixer=mixer, mlp="dense", d_ff=cfg.d_ff,
                         rope_theta=theta)
    if cfg.moe is not None:
        if i < cfg.moe.first_k_dense:
            return LayerSite(mixer, "dense", cfg.moe.dense_d_ff or cfg.d_ff,
                             theta, window)
        return LayerSite(mixer, "moe", 0, theta, window)
    return LayerSite(mixer, "dense", cfg.d_ff, theta, window)


def plan_stages(cfg: ModelConfig) -> Tuple[Stage, ...]:
    sites = [_make_site(cfg, i) for i in range(cfg.n_layers)]
    stages = []
    i = 0
    # prefix exceptions (e.g. deepseek first_k_dense) peel off as run stages
    k_dense = cfg.moe.first_k_dense if cfg.moe is not None else 0
    while i < k_dense:
        j = i
        while j < k_dense and sites[j] == sites[i]:
            j += 1
        stages.append(Stage("run", (sites[i],), j - i))
        i = j
    rest = sites[i:]
    p = len(cfg.pattern)
    reps, rem = divmod(len(rest), p)
    body = rest[: reps * p]
    if reps:
        period = tuple(rest[:p])
        assert body == list(period) * reps, "pattern does not tile layer list"
        if p == 1:
            stages.append(Stage("run", period, reps))
        else:
            stages.append(Stage("pattern", period, reps))
    j = i + reps * p
    while j < cfg.n_layers:
        k = j
        while k < cfg.n_layers and sites[k] == sites[j]:
            k += 1
        stages.append(Stage("run", (sites[j],), k - j))
        j = k
    return tuple(stages)


def attn_opts(cfg: ModelConfig, site: LayerSite) -> AttnOpts:
    return AttnOpts(
        n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.resolved_head_dim, window=site.window, causal=cfg.causal,
        rope_theta=site.rope_theta, use_rope=cfg.use_rope,
        softcap=cfg.attn_softcap, qk_norm=cfg.qk_norm,
        query_scale=cfg.query_scale,
        kernel_force=cfg.geometry.kernel_force, attn_tp=cfg.attn_tp)


def mla_opts(cfg: ModelConfig) -> MLAOpts:
    return MLAOpts(n_heads=cfg.n_heads, cfg=cfg.mla,
                   rope_theta=cfg.rope_theta)


def ssm_opts(cfg: ModelConfig) -> SSMOpts:
    return SSMOpts(d_model=cfg.d_model, cfg=cfg.ssm,
                   kernel_force=cfg.geometry.kernel_force,
                   tp=cfg.tp_mode == "tp")


def moe_opts(cfg: ModelConfig) -> MoEOpts:
    return MoEOpts(cfg=cfg.moe, act=cfg.act, norm_topk=cfg.moe.norm_topk)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _init_site(cfg: ModelConfig, site: LayerSite, gen, dtype, device):
    z = lambda: torch.zeros((cfg.d_model,), dtype=dtype, device=device)
    if site.mixer == MIXER_SSM:
        return {"ssm": init_ssm(gen, ssm_opts(cfg), dtype, device),
                "norm1": z()}
    if site.mixer == MIXER_SHARED_ATTN:
        return {}  # weights live in params["shared"]
    p = {"norm1": z(), "norm2": z()}
    if cfg.post_norm:
        p["norm1_post"] = z()
        p["norm2_post"] = z()
    if cfg.mla is not None:
        p["attn"] = init_mla(gen, cfg.d_model, mla_opts(cfg), dtype, device)
    else:
        p["attn"] = init_attention(gen, cfg.d_model, attn_opts(cfg, site),
                                   dtype, device)
    if site.mlp == "moe":
        p["moe"] = init_moe(gen, cfg.d_model, moe_opts(cfg), dtype, device)
    else:
        p["mlp"] = init_mlp(gen, cfg.d_model, site.d_ff, dtype, device)
    return p


def init_shared_block(cfg: ModelConfig, gen, dtype, device):
    """Zamba2's shared attention+mlp block (one copy)."""
    site = LayerSite(MIXER_SHARED_ATTN, "dense", cfg.d_ff, cfg.rope_theta)
    z = lambda: torch.zeros((cfg.d_model,), dtype=dtype, device=device)
    return {"norm1": z(), "norm2": z(),
            "attn": init_attention(gen, cfg.d_model, attn_opts(cfg, site),
                                   dtype, device),
            "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, dtype, device)}


def _stack(trees):
    """Stack a list of identically structured dicts leaf-wise on axis 0."""
    return {k: _stack([t[k] for t in trees]) if isinstance(v, dict)
            else torch.stack([t[k] for t in trees]) for k, v in trees[0].items()}


def init_stage(cfg: ModelConfig, stage: Stage, gen, dtype, device):
    def stacked(site):
        return _stack([_init_site(cfg, site, gen, dtype, device)
                       for _ in range(stage.repeats)])

    if stage.kind == "run":
        return stacked(stage.sites[0])
    return tuple(stacked(s) for s in stage.sites)


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------

def _site_cache_len(site: LayerSite, max_len: int) -> int:
    if site.window:
        return min(site.window, max_len)
    return max_len


def _stacked_caches(cfg: ModelConfig, make_one):
    """A cache tree mirroring the stage structure: ``make_one(site)`` gives
    one layer's cache dict, stacked here over the stage's repeats."""
    def stacked(site, n):
        return {k: v[None].repeat((n,) + (1,) * v.dim())
                for k, v in make_one(site).items()}

    out = []
    for st in plan_stages(cfg):
        if st.kind == "run":
            out.append(stacked(st.sites[0], st.repeats))
        else:
            out.append(tuple(stacked(s, st.repeats) for s in st.sites))
    return tuple(out)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype, device,
               clamp_window: bool = True):
    """Empty cache tree mirroring the stage structure. ``clamp_window=False``
    sizes windowed sites at ``max_len`` too (no ring). An SSM site's cache
    is its (B, H, P, N) fp32 state and (B, d_conv-1, C) conv buffer,
    whatever ``max_len``; an MLA site's, its compressed latents
    (``init_mla_cache``)."""
    def one(site):
        if site.mixer == MIXER_SSM:
            return init_ssm_cache(batch, ssm_opts(cfg), dtype, device)
        L = _site_cache_len(site, max_len) if clamp_window else max_len
        if cfg.mla is not None:
            return init_mla_cache(batch, L, mla_opts(cfg), dtype, device)
        return init_kv_cache(batch, L, attn_opts(cfg, site), dtype,
                             quant=cfg.kv_quant, device=device)

    return _stacked_caches(cfg, one)


# every cache leaf starts as one value: k/v, latents, SSM state and conv
# tail 0, positions -1 (empty), int8 scales 1
_CACHE_INIT = {"pos": -1, "k_scale": 1, "v_scale": 1}


def reset_cache(caches) -> None:
    """Restore a cache tree of ``init_cache``'s (or a paged pool of
    ``init_paged_cache``'s) to exactly what that function makes, in place:
    the same leaves at the same addresses, ring and MLA layouts as they
    are. A prefill into the reset tree fills it as it fills a new one."""
    if isinstance(caches, dict):
        for name, leaf in caches.items():
            leaf.fill_(_CACHE_INIT.get(name, 0))
        return
    for part in caches:
        reset_cache(part)


def init_paged_cache(cfg: ModelConfig, n_pages: int, page_size: int, dtype,
                     device):
    """Empty paged KV pool tree mirroring the stage structure: every
    attention site gets (n_pages, page_size, kv, hd) pool tensors. One
    logical page allocates the same physical row in every layer's pool, so
    a single block table per sequence addresses the whole stack. SSM/MLA
    archs have no paged form."""
    if cfg.ssm is not None or cfg.mla is not None:
        raise ValueError("paged KV caches support attention-family models "
                         "(SSM state and MLA latents are not paged)")
    return _stacked_caches(cfg, lambda site: init_paged_kv_pool(
        n_pages, page_size, attn_opts(cfg, site), dtype, quant=cfg.kv_quant,
        device=device))


# ---------------------------------------------------------------------------
# Site application
# ---------------------------------------------------------------------------

def _attn_post(cfg, site, pp, p, x, y):
    """The attention output ``y``'s post-norm and residual, then the
    pre-norm MLP (dense or MoE) and its residual. ``pp``: the site's
    weights or the shared block's; post-norms are the site's own. Returns
    (x, the MoE aux loss or None)."""
    if cfg.post_norm:
        y = rms_norm(y, p["norm1_post"])
    x = x + y
    h = rms_norm(x, pp["norm2"])
    aux = None
    if site.mlp == "moe":
        y, aux = moe_forward(pp["moe"], h, moe_opts(cfg))
    else:
        y = mlp_forward(pp["mlp"], h, cfg.act)
    if cfg.post_norm:
        y = rms_norm(y, p["norm2_post"])
    return x + y, aux


def _apply_site_full(cfg, site, p, shared, x, positions, cache):
    """Full-sequence site application; fills ``cache`` (a layer's view of
    the stacked prefill cache) in place when one is given. Returns (x,
    the MoE aux loss or None)."""
    if site.mixer == MIXER_SSM:
        h = rms_norm(x, p["norm1"])
        y, (state, conv_tail) = ssm_forward(p["ssm"], h, ssm_opts(cfg))
        if cache is not None:
            fill_ssm_cache(cache, state, conv_tail)
        return x + y, None
    pp = shared if site.mixer == MIXER_SHARED_ATTN else p
    h = rms_norm(x, pp["norm1"])
    if cfg.mla is not None:
        y, (c_kv, k_rope) = mla_forward(pp["attn"], h, positions,
                                        mla_opts(cfg))
        if cache is not None:
            fill_mla_cache(cache, c_kv, k_rope, positions)
    else:
        y, (k, v) = attn_forward(pp["attn"], h, positions,
                                 attn_opts(cfg, site))
        if cache is not None:
            fill_kv_cache(cache, k, v, positions)
    return _attn_post(cfg, site, pp, p, x, y)


def _apply_site_decode(cfg, site, p, shared, x, positions, cache,
                       block_tables):
    if site.mixer == MIXER_SSM:
        h = rms_norm(x, p["norm1"])
        y, _ = ssm_decode(p["ssm"], h, cache, ssm_opts(cfg))
        return x + y, None
    pp = shared if site.mixer == MIXER_SHARED_ATTN else p
    h = rms_norm(x, pp["norm1"])
    if cfg.mla is not None:
        y, _ = mla_decode(pp["attn"], h, positions, cache, mla_opts(cfg))
    elif block_tables is not None:
        y, _ = attn_decode_paged(pp["attn"], h, positions, cache,
                                 block_tables, attn_opts(cfg, site))
    else:
        y, _ = attn_decode(pp["attn"], h, positions, cache,
                           attn_opts(cfg, site))
    return _attn_post(cfg, site, pp, p, x, y)


# ---------------------------------------------------------------------------
# Stage execution
# ---------------------------------------------------------------------------

def _unstack(tree, n: int):
    """The ``n`` layers of a stacked dict, as a list of views through one
    ``unbind`` a leaf: a cache write lands in the stacked tensor, and under
    autograd a parameter's gradient is one stack of its layers' gradients
    (indexing a layer at a time would give each layer's backward a
    full-size zero tensor, summed ``n`` times)."""
    if not tree:
        return [{} for _ in range(n)]
    parts = {k: _unstack(v, n) if isinstance(v, dict) else _unbind0(v)
             for k, v in tree.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


def _unbind0(t):
    """``t.unbind(0)``; a DTensor sharded over its stack dim (the
    reference's rule shards a shared expert's stack of layers over
    "model") is gathered on that dim first, as a scan over it would."""
    if isinstance(t, DTensor) and any(
            isinstance(p, Shard) and p.dim == 0 for p in t.placements):
        t = t.redistribute(t.device_mesh, [
            Replicate() if isinstance(p, Shard) and p.dim == 0 else p
            for p in t.placements])
    return t.unbind(0)


def _layers(stage: Stage, sp, sc):
    """Yield (site, params, cache) per layer of a stage in execution order
    (``sc`` None: no cache)."""
    if stage.kind == "run":
        sp, sc = (sp,), (None if sc is None else (sc,))
    per_pos = [_unstack(t, stage.repeats) for t in sp]
    caches = None if sc is None else [_unstack(t, stage.repeats)
                                      for t in sc]
    for r in range(stage.repeats):
        for pos, site in enumerate(stage.sites):
            yield (site, per_pos[pos][r],
                   None if caches is None else caches[pos][r])


def _train_stage(cfg, stage: Stage, sp, shared, x, positions, aux, remat):
    """One stage of the training forward: a body a layer (run stage) or a
    pattern period (pattern stage), each recomputed in the backward pass
    when ``remat``. Returns (x, aux)."""
    layers = list(_layers(stage, sp, None))
    period = len(stage.sites)
    use_sp = remat and cfg.tp_mode == "tp"

    def body(xx, aa, sites):
        if use_sp:
            xx = _gather_act(xx)
        for site, p_i, _ in sites:
            xx, a = _apply_site_full(cfg, site, p_i, shared, xx, positions,
                                     None)
            if a is not None:
                aa = aa + a
        if use_sp:
            xx = _seq_shard(xx)
        return xx, aa

    for r in range(stage.repeats):
        sites = layers[r * period:(r + 1) * period]
        if remat:
            x, aux = checkpoint(body, x, aux, sites, use_reentrant=False)
        else:
            x, aux = body(x, aux, sites)
    return x, aux


def _seq_shard(x):
    """The reference's Megatron-SP hint at the end of a remat body: the
    carried (B, S, d) activation to (dp axes, "model", None), so the saved
    residual is sharded over the TP axis too. No-op on a plain tensor."""
    return constrain(x, P(dp_spec_for(x, x.shape[0]), "model", None))


def _gather_act(x):
    """The reference's hint at the start of a remat body: re-gather the
    sequence so the layer's products see (dp axes, None, None)
    activations against model-sharded weights."""
    return constrain(x, P(dp_spec_for(x, x.shape[0]), None, None))


def apply_stages(cfg: ModelConfig, params, x, positions, *,
                 mode: str, caches=None, block_tables=None,
                 remat: bool = False):
    """Run all stages. mode: train | prefill | decode.

    train: no cache; returns (x, the summed MoE aux loss, a 0-d fp32
    tensor); ``remat`` recomputes each layer (run stage) or pattern period
    (pattern stage) in the backward pass. prefill: ``caches`` (from
    ``init_cache``, batch and length of the prompt's cache) are filled in
    place. decode: ``caches`` are updated in place; ``block_tables`` (B,
    nb) switches to the paged-pool path (caches from ``init_paged_cache``).
    ``params["shared"]`` holds the shared block's weights where the pattern
    has ``shared_attn`` sites. prefill and decode return x."""
    shared = params.get("shared")
    if mode == "train":
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for si, st in enumerate(plan_stages(cfg)):
            x, aux = _train_stage(cfg, st, params["stages"][si], shared, x,
                                  positions, aux, remat)
        return x, aux
    for si, st in enumerate(plan_stages(cfg)):
        sc = caches[si] if caches is not None else None
        for site, p_i, c_i in _layers(st, params["stages"][si], sc):
            if mode == "decode":
                x, _ = _apply_site_decode(cfg, site, p_i, shared, x,
                                          positions, c_i, block_tables)
            else:
                x, _ = _apply_site_full(cfg, site, p_i, shared, x, positions,
                                        c_i)
    return x
