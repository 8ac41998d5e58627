"""Sharding rules (the reference's ``runtime/sharding.py``): map every
parameter / input / cache tensor to a partition spec over the production
mesh axes ("pod", "data", "model").

Strategy, as in the reference:
  * DP: batch dims over ("pod","data") — "pod" composes with "data".
  * TP: attention (kv-)heads, ffn hidden, vocab over "model", with
    divisibility fallbacks (small-head archs replicate attention and still
    shard mlp+vocab).
  * EP: MoE expert dim over "model".
  * SP: for batch=1 long-context cells the cache sequence dim is sharded
    over "data".

Rules are name+rank based and tolerate leading stack dims inserted by the
stage planner, by right-aligning the spec.

The rules are pure Python: they read a mesh's axis names and sizes only,
so a ``torch.distributed.device_mesh.DeviceMesh`` and a plain
``MeshShape({"data": 16, "model": 16})`` both work. ``P`` is the port's
``PartitionSpec``. ``named`` turns specs into DTensor placements on a
``DeviceMesh`` and ``place`` distributes a tree by them; ``constrain`` is
``with_sharding_constraint`` (these live in ``repro_torch.placement`` and
are re-exported here). The reference's ``shard_map`` helper has no
counterpart: the explicit data-parallel step (``make_dp_train_step``)
works on a process group.
"""
from __future__ import annotations

from typing import Tuple

from repro_torch.configs.base import ModelConfig
from repro_torch.placement import (  # noqa: F401 (re-exported)
    MeshShape, NamedSharding, P, _axis_size, _div, _dp_size, _full, _none,
    axis_names, axis_sizes, constrain, dp_axes, dp_spec_for, is_spec,
    local_offset, local_region, named, place, placements, spec_of)
from repro_torch.tree import leaf_paths, flatten, tree_map, unflatten


def _right_align(spec: Tuple, rank: int) -> P:
    """Pad spec with None on the left to match leading stack dims."""
    pad = rank - len(spec)
    return P(*([None] * pad + list(spec)))


# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------

def _param_rule(cfg: ModelConfig, name: str, shape: Tuple[int, ...],
                path_names: Tuple[str, ...], mesh) -> P:
    r = len(shape)

    def right(*spec):
        return _right_align(tuple(spec), r)

    if name == "tok":                      # (V, d)
        return right("model" if _div(shape[-2], mesh) else None, None)
    if name == "head":                     # (d, V)
        return right(None, "model" if _div(shape[-1], mesh) else None)

    in_moe = "moe" in path_names and name in ("wg", "wu", "wd")
    if in_moe:                             # (E, d, f) / (E, f, d)
        return right("model" if _div(shape[-3], mesh) else None, None, None)
    if name == "router":                   # (d, E) replicated
        return right(None, None)

    def prefer(pref_idx: int, fallback_idx: int, rank: int) -> P:
        """Shard dim ``pref_idx`` (negative) over model; if indivisible fall
        back to ``fallback_idx`` (usually the d_model dim)."""
        spec = [None] * rank
        if _div(shape[pref_idx], mesh):
            spec[pref_idx] = "model"
        elif _div(shape[fallback_idx], mesh):
            spec[fallback_idx] = "model"
        return right(*spec)

    if name in ("wg", "wu"):               # (d, f)
        return prefer(-1, -2, 2)
    if name == "wd":                       # (f, d)
        return prefer(-2, -1, 2)

    if name == "wq":
        if "attn" in path_names and cfg.mla is not None and r >= 3:
            return prefer(-2, -3, 3)       # MLA q proj (d, h, qd)
        return prefer(-3, -4, 4)           # GQA (d, h, g, hd)
    if name in ("wk", "wv"):               # (d, h, hd)
        return prefer(-2, -3, 3)
    if name == "wo":
        if cfg.mla is not None and r >= 3 and "attn" in path_names:
            return prefer(-3, -1, 3)       # (h, v, d)
        return prefer(-4, -1, 4)           # (h, g, hd, d)
    if name in ("w_uk", "w_uv"):           # (r, h, n)
        return prefer(-2, -3, 3)
    if name == "w_dkv":                    # (d, r+rope)
        return prefer(-2, -2, 2)

    if name == "in_proj":                  # ssm (d, e)
        return prefer(-1, -2, 2)
    if name == "out_proj":                 # ssm (e, d)
        return prefer(-2, -1, 2)
    if name == "conv_w":                   # (K, C) channel-sharded
        return right(None, "model" if _div(shape[-1], mesh) else None)
    if name == "conv_b":                   # (C,)
        return right("model" if _div(shape[-1], mesh) else None)

    # norms, biases, A_log, dt_bias, D, scales: replicate
    return _none(r)


def param_specs(cfg: ModelConfig, params_shape, mesh):
    """Spec tree matching a (meta) parameter tree."""
    if cfg.tp_mode == "pure_dp":
        return tree_map(lambda l: _none(l.ndim), params_shape)
    if cfg.tp_mode == "fsdp":
        return tree_map(lambda l: _fsdp_spec(tuple(l.shape), mesh),
                        params_shape)
    leaves, spec = flatten(params_shape)
    return unflatten(spec, [
        _param_rule(cfg, names[-1], tuple(leaf.shape), names, mesh)
        for names, leaf in zip(leaf_paths(params_shape), leaves)])


def _fsdp_spec(shape, mesh) -> P:
    """Fully-sharded weights: shard the largest dim over the biggest axis
    combination that divides it (data×model ≫ data ≫ model)."""
    sizes = axis_sizes(mesh)
    combos = [("data", "model"), ("data",), ("model",)]
    order = sorted(range(len(shape)), key=lambda i: -shape[i])
    for axes in combos:
        if not all(a in sizes for a in axes):
            continue
        n = 1
        for a in axes:
            n *= sizes[a]
        for i in order:
            if shape[i] % n == 0 and shape[i] >= n:
                spec = [None] * len(shape)
                spec[i] = axes if len(axes) > 1 else axes[0]
                return P(*spec)
    return _none(len(shape))


def pure_dp_axes(mesh, batch: int):
    """Largest combination of mesh axes (data, model, pod order) whose
    product divides the batch — pure-DP mode spreads batch over all of it."""
    sizes = axis_sizes(mesh)
    axes = []
    prod = 1
    for a in ("data", "model", "pod"):
        if a in sizes and batch % (prod * sizes[a]) == 0:
            axes.append(a)
            prod *= sizes[a]
    return tuple(axes) or None


# ---------------------------------------------------------------------------
# Input / activation / cache specs
# ---------------------------------------------------------------------------

def batch_specs(cfg: ModelConfig, batch_shape, mesh,
                batch_sharded: bool = True):
    """Inputs: shard the leading (global batch) dim over DP axes (all mesh
    axes in pure_dp mode)."""
    pure_dp = cfg.tp_mode in ("pure_dp", "fsdp")

    def visit(leaf):
        if leaf.ndim == 0:
            return P()
        b = leaf.shape[0]
        if not batch_sharded:
            return _none(leaf.ndim)
        if pure_dp:
            axes = pure_dp_axes(mesh, b)
            if axes is None:
                return _none(leaf.ndim)
            return P(*([axes] + [None] * (leaf.ndim - 1)))
        dp = dp_axes(mesh)
        if dp is None or b % _dp_size(mesh) != 0:
            return _none(leaf.ndim)
        return P(*([dp] + [None] * (leaf.ndim - 1)))
    return tree_map(visit, batch_shape)


_LENGTH_LEAVES = ("k", "v", "c_kv", "k_rope", "pos", "cross_k", "cross_v",
                  "k_scale", "v_scale")
_HEAD_LEAVES = ("k", "v", "cross_k", "cross_v", "k_scale", "v_scale")


def cache_specs(cfg: ModelConfig, cache_shape, mesh, batch: int,
                seq_shard: bool = False):
    """Decode caches. Layout (stack..., B, L, heads, hd) for kv caches,
    (stack..., B, H, P, N) for ssm state. Shard B over DP when divisible;
    for batch=1 long-context, shard the cache length dim over "data"
    (sequence parallelism) and kv-heads over "model" when divisible."""
    dp = dp_axes(mesh)
    dp_ok = batch % _dp_size(mesh) == 0

    def visit(names, leaf):
        r = leaf.ndim
        shp = tuple(leaf.shape)
        leaf_name = names[-1]
        spec = [None] * r
        # the batch dim: first dim equal to `batch` after stack dims
        bdim = next((i for i, s in enumerate(shp) if s == batch), None)
        if bdim is None:
            return P(*spec)
        if dp_ok and dp is not None:
            spec[bdim] = dp
        if leaf_name in _LENGTH_LEAVES:
            ldim = bdim + 1                     # cache length dim
            if ldim < r:
                if seq_shard and not dp_ok and _div(shp[ldim], mesh, "data"):
                    spec[ldim] = "data"
                # kv heads dim (k/v only): (B, L, h, hd); when heads don't
                # divide the model axis, shard the cache LENGTH over model
                if leaf_name in _HEAD_LEAVES \
                        and ldim + 1 < r and _div(shp[ldim + 1], mesh):
                    spec[ldim + 1] = "model"
                elif spec[ldim] is None and _div(shp[ldim], mesh):
                    spec[ldim] = "model"
        if leaf_name == "state":                 # ssm (B, H, P, N)
            if bdim + 1 < r and _div(shp[bdim + 1], mesh):
                spec[bdim + 1] = "model"
        if leaf_name == "conv":                  # (B, K, C)
            if bdim + 2 < r and _div(shp[bdim + 2], mesh):
                spec[bdim + 2] = "model"
        return P(*spec)
    leaves, tspec = flatten(cache_shape)
    return unflatten(tspec, [visit(n, l) for n, l in
                             zip(leaf_paths(cache_shape), leaves)])


def zero1_specs(cfg: ModelConfig, pspecs, params_shape, mesh):
    """Optimizer-state sharding (ZeRO-1): take each param's spec and
    additionally shard the first unsharded, data-divisible dim over
    "data"."""
    ds = _axis_size(mesh, "data")

    def one(spec: P, leaf):
        if ds <= 1:
            return spec
        parts = list(spec) + [None] * (leaf.ndim - len(spec))
        used = set()
        for p in parts:
            for a in (p if isinstance(p, tuple) else (p,)):
                if a:
                    used.add(a)
        if "data" in used:        # already data-sharded (e.g. FSDP specs)
            return P(*parts)
        for i, (dim, p) in enumerate(zip(leaf.shape, parts)):
            if p is None and dim % ds == 0 and dim >= ds:
                parts[i] = "data"
                break
        return P(*parts)

    return tree_map(one, pspecs, params_shape, is_leaf=is_spec)
