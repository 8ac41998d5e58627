"""Attention layers: GQA (full / sliding-window) with RoPE, decode with KV cache.

All functions take parameter dicts of tensors. Shapes (as in the reference):
  x          (B, S, d_model)
  q          (B, S, n_kv, q_per_kv, hd)
  k, v       (B, S, n_kv, hd)
  cache k/v  (B, L, n_kv, hd), cache positions (B, L) int32 (-1 = empty)
  paged pool (P, ps, n_kv, hd), pool positions (P, ps) int32

Caches are updated IN PLACE (the reference returns new arrays and relies on
XLA buffer donation; here the index writes mutate the cache tensors and the
same dict is returned).

Attention over a cache or a causal prefill goes through ``kernels.ops``: the
hand-written CUDA kernel on a CUDA tensor, its plain PyTorch version on a CPU
tensor. ``kernel_force="ref"`` selects the plain versions on any device (the
reference's spelling for "no kernel"); ``"kernel"`` (the reference's "force
the kernel") runs the kernels as ``""`` does on CUDA and raises on a tensor
off the card. The einsum path (``_attend``) serves
what the kernels do not: autograd-recording forwards (the kernels have no
backward), non-causal or cross attention, and decode with a logit softcap.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import DTensor

from repro_torch.kernels import ops
from repro_torch.kernels.decode_attention import (decode_attention_ref,
                                                  merge_by_lse,
                                                  paged_decode_attention_ref)
from repro_torch.kernels.flash_attention import flash_attention_ref
from repro_torch.layers.norms import rms_norm, softcap
from repro_torch.layers.rope import apply_rope
from repro_torch.placement import (P, _div, axis_names, constrain,
                                   dp_spec_for, local_offset, local_region,
                                   spec_of)

NEG_INF = -2.3819763e38  # matches gemma reference


@dataclasses.dataclass(frozen=True)
class AttnOpts:
    n_heads: int
    n_kv_heads: int
    head_dim: int
    window: int = 0              # 0 = global (full causal)
    causal: bool = True
    rope_theta: float = 10000.0
    use_rope: bool = True
    softcap: float = 0.0
    qk_norm: bool = False
    query_scale: float = 0.0     # 0 -> head_dim ** -0.5
    q_chunk: int = 256           # query-chunk size for long sequences
    kernel_force: str = ""       # "" = kernel on CUDA | "ref" = plain
                                 # versions | "kernel" = kernel, or raise
    attn_tp: str = "heads"       # "heads" | "seq" (query positions over
                                 # "model") | "none" (pure DP): mesh hints


def _plain(opts, t=None) -> bool:
    """Whether the plain versions run (``kernel_force="ref"``). Raises for
    a mode the port lacks, and under ``"kernel"`` where the kernel's input
    ``t`` lies off the card (a meta tensor passes: admission's shape check
    runs the plain versions there and launches nothing)."""
    force = opts.kernel_force
    if force == "interpret":
        raise ValueError("kernel_force 'interpret': the port's kernels are "
                         "CUDA sources, and no interpreter runs them off the "
                         "card; 'ref' runs their plain PyTorch versions")
    if force not in ("", "ref", "kernel"):
        raise ValueError(f"kernel_force {force!r}: the port knows '' "
                         "(kernels on CUDA), 'kernel' and 'ref'")
    if force == "kernel" and t is not None \
            and t.device.type not in ("cuda", "meta"):
        raise ValueError(f"kernel_force 'kernel': the CUDA kernels need a "
                         f"card, and this tensor is on {t.device}")
    return force == "ref"


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def init_attention(generator: torch.Generator, d_model: int, opts: AttnOpts,
                   dtype=torch.float32, device=None):
    h, g, hd = opts.n_kv_heads, opts.n_heads // opts.n_kv_heads, opts.head_dim
    s = d_model ** -0.5

    def normal(shape):
        w = torch.randn(shape, generator=generator, device=generator.device,
                        dtype=dtype) * s
        return w.to(device)

    p = {
        "wq": normal((d_model, h, g, hd)),
        "wk": normal((d_model, h, hd)),
        "wv": normal((d_model, h, hd)),
        "wo": normal((h, g, hd, d_model)),
    }
    if opts.qk_norm:
        p["q_norm"] = torch.zeros((hd,), dtype=dtype, device=device)
        p["k_norm"] = torch.zeros((hd,), dtype=dtype, device=device)
    return p


# ---------------------------------------------------------------------------
# Core score/combine helpers
# ---------------------------------------------------------------------------

def _scale(opts: AttnOpts) -> float:
    return opts.query_scale if opts.query_scale else opts.head_dim ** -0.5


def _qkv(p, x, positions, opts: AttnOpts, kv_src=None, kv_pos=None):
    """Project and rope. Returns q (B,S,kv,g,hd) already multiplied by the
    query scale, k/v (B,Skv,kv,hd). ``kv_src``: source sequence for k/v
    (cross-attention); defaults to x."""
    xs = x if kv_src is None else kv_src
    q = torch.einsum("bsd,dhgk->bshgk", x, p["wq"].to(x.dtype))
    k = torch.einsum("bsd,dhk->bshk", xs, p["wk"].to(x.dtype))
    v = torch.einsum("bsd,dhk->bshk", xs, p["wv"].to(x.dtype))
    if opts.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    if opts.use_rope:
        B, S = x.shape[:2]
        qf = q.reshape(B, S, -1, opts.head_dim)
        qf = apply_rope(qf, positions, opts.rope_theta)
        q = qf.reshape(q.shape)
        k = apply_rope(k, positions if kv_pos is None else kv_pos,
                       opts.rope_theta)
    return q * _scale(opts), k, v


def _attend(q, k, v, mask, opts: AttnOpts):
    """q (B,Sq,kv,g,hd), k/v (B,Sk,kv,hd), mask (B,Sq,Sk) -> (B,Sq,kv,g,hd)."""
    scores = torch.einsum("bqhgc,bshc->bhgqs", q.float(), k.float())
    scores = softcap(scores, opts.softcap)
    scores = scores.masked_fill(~mask[:, None, None, :, :], NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhgqs,bshc->bqhgc", probs, v.to(q.dtype))


def _causal_mask(q_pos, k_pos, window: int, causal: bool, k_valid=None):
    """q_pos (B,Sq), k_pos (B,Sk) -> bool (B,Sq,Sk)."""
    diff = q_pos[:, :, None] - k_pos[:, None, :]
    m = diff >= 0 if causal else torch.ones_like(diff, dtype=torch.bool)
    if window:
        m = m & (diff < window)
    if k_valid is not None:
        m = m & k_valid[:, None, :]
    return m


# ---------------------------------------------------------------------------
# Kernel glue: the layer's layouts are handed to the kernels as strided views
# ---------------------------------------------------------------------------

def _decode_kernel_attend(q, cache, positions, opts: AttnOpts,
                          return_lse: bool = False):
    """Dense-cache decode sweep. q (B,1,kv,g,hd) already query-scaled ->
    kernel scale=1. The cache's (B, L, kv, hd) rows are passed as a
    (B, kv, L, hd) view: no copy, the kernel reads them through strides.
    ``return_lse``: also each row's log-sum-exp, (B, kv * g) fp32."""
    B, _, kv, g, hd = q.shape
    qk = q[:, 0].reshape(B, kv * g, hd)
    ks = vs = None
    if "k_scale" in cache:
        ks = cache["k_scale"].permute(0, 2, 1)
        vs = cache["v_scale"].permute(0, 2, 1)
    fn = decode_attention_ref if _plain(opts, q) else ops.decode_attention
    o = fn(qk, cache["k"].permute(0, 2, 1, 3), cache["v"].permute(0, 2, 1, 3),
           cache["pos"], positions[:, 0], window=opts.window, scale=1.0,
           k_scale=ks, v_scale=vs, return_lse=return_lse)
    if return_lse:
        return o[0].reshape(B, 1, kv, g, hd), o[1]
    return o.reshape(B, 1, kv, g, hd)


def _paged_kernel_attend(q, cache, positions, block_tables, opts: AttnOpts):
    """Paged decode sweep: the pool's (P, ps, kv, hd) leaves are passed as a
    (P, kv, ps, hd) view and walked through the block table in place."""
    B, _, kv, g, hd = q.shape
    qk = q[:, 0].reshape(B, kv * g, hd)
    ks = vs = None
    if "k_scale" in cache:
        ks = cache["k_scale"].permute(0, 2, 1)
        vs = cache["v_scale"].permute(0, 2, 1)
    fn = paged_decode_attention_ref if _plain(opts, q) \
        else ops.paged_decode_attention
    o = fn(qk, cache["k"].permute(0, 2, 1, 3), cache["v"].permute(0, 2, 1, 3),
           cache["pos"], block_tables, positions[:, 0], window=opts.window,
           scale=1.0, k_scale=ks, v_scale=vs)
    return o.reshape(B, 1, kv, g, hd)


def _flash_kernel_attend(q, k, v, opts: AttnOpts):
    """Causal prefill through the flash kernel. Assumes standard prefill
    positions (``arange`` per row — the kernel masks from row indices).
    q (B,S,kv,g,hd) is passed as a (B, Hq, S, hd) view; the output is
    written (B, S, Hq, hd)-major so the result reshapes back without a
    copy."""
    if isinstance(q, DTensor):        # a local region: batch and kv heads
        dp = dp_spec_for(q, q.shape[0])
        hm = "model" if _div(q.shape[2], q.device_mesh) else None
        return local_region(
            lambda a, b, c: _flash_kernel_attend(a, b, c, opts),
            q.device_mesh, in_specs=(P(dp, None, hm, None, None),
                                     P(dp, None, hm, None),
                                     P(dp, None, hm, None)),
            out_specs=P(dp, None, hm, None, None))(q, k, v)
    B, S, kv, g, hd = q.shape
    qk = q.permute(0, 2, 3, 1, 4).reshape(B, kv * g, S, hd)
    fn = flash_attention_ref if _plain(opts, q) else ops.flash_attention
    o = fn(qk, k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3),
           window=opts.window, scale=1.0, softcap=opts.softcap)
    return o.reshape(B, kv, g, S, hd).permute(0, 3, 1, 2, 4)


# ---------------------------------------------------------------------------
# Full-sequence forward (train / prefill), query-chunked
# ---------------------------------------------------------------------------

def attn_forward(p, x, positions, opts: AttnOpts,
                 kv_src=None, kv_pos=None, kv_valid=None):
    """Full-sequence attention. Returns (y, (k, v)) -- k/v for cache building.

    Causal self-attention that records no autograd graph (serving prefill)
    takes the flash kernel; a forward that records one takes the einsum
    path, chunked over queries for long sequences.
    """
    q, k, v = _qkv(p, x, positions, opts, kv_src, kv_pos)
    S = x.shape[1]
    if kv_src is not None:
        k_pos, k_valid = kv_pos, kv_valid
    else:
        k_pos, k_valid = positions, None

    qc = opts.q_chunk
    if opts.attn_tp == "seq":
        # indivisible kv-heads: shard QUERY positions over the model axis
        # so score compute is TP-distributed (heads replicated); k/v
        # gathered (the reference's hint; no-op on plain tensors)
        q = _shard_q_seq(q)
        k = _gather_seq(k)
        v = _gather_seq(v)
        mask = _causal_mask(positions, k_pos, opts.window, opts.causal,
                            k_valid)
        y = _attend(q, k, v, mask, opts)
    elif opts.causal and kv_src is None and not q.requires_grad:
        y = _flash_kernel_attend(q, k, v, opts)
    elif qc and S > qc and S % qc == 0:
        y = _chunked_attend(q, k, v, positions, k_pos, k_valid, opts)
    else:
        mask = _causal_mask(positions, k_pos, opts.window, opts.causal,
                            k_valid)
        y = _attend(q, k, v, mask, opts)
    out = torch.einsum("bshgk,hgkd->bsd", y, p["wo"].to(x.dtype))
    return out, (k, v)


def _shard_q_seq(q):
    """The reference's hint: q (B, S, ...) with batch over the dp axes and
    query positions over "model"."""
    return constrain(q, P(dp_spec_for(q, q.shape[0]), "model",
                          *([None] * (q.ndim - 2))))


def _gather_seq(t):
    """The reference's hint: k/v with batch-only sharding (sequence
    gathered) before the query-chunk loop."""
    return constrain(t, P(dp_spec_for(t, t.shape[0]),
                          *([None] * (t.ndim - 1))))


def _chunked_attend(q, k, v, q_pos, k_pos, k_valid, opts: AttnOpts):
    """Loop over query chunks; local layers slice keys to the window."""
    B, S = q.shape[:2]
    qc = opts.q_chunk
    w = opts.window
    if opts.attn_tp == "heads":
        # hoist the k/v seq-gather out of the chunk loop (the reference's
        # hint for Megatron-SP residuals; "none" = pure DP)
        k = _gather_seq(k)
        v = _gather_seq(v)
    ys = []
    if bool(w) and w < S and k.shape[1] == S:
        # Pad keys on the left by `w` so chunk i reads keys [i*qc - w, i*qc + qc).
        k_pad = torch.nn.functional.pad(k, (0, 0, 0, 0, w, 0))
        v_pad = torch.nn.functional.pad(v, (0, 0, 0, 0, w, 0))
        kp_pad = torch.nn.functional.pad(k_pos, (w, 0), value=-1)
        kval = torch.ones((B, S), dtype=torch.bool, device=q.device) \
            if k_valid is None else k_valid
        kval_pad = torch.nn.functional.pad(kval, (w, 0), value=False)
        for i in range(S // qc):
            lo = i * qc
            mask = _causal_mask(q_pos[:, lo:lo + qc], kp_pad[:, lo:lo + qc + w],
                                w, opts.causal, kval_pad[:, lo:lo + qc + w])
            ys.append(_attend(q[:, lo:lo + qc], k_pad[:, lo:lo + qc + w],
                              v_pad[:, lo:lo + qc + w], mask, opts))
    else:
        for i in range(S // qc):
            lo = i * qc
            mask = _causal_mask(q_pos[:, lo:lo + qc], k_pos, w, opts.causal,
                                k_valid)
            ys.append(_attend(q[:, lo:lo + qc], k, v, mask, opts))
    return torch.cat(ys, dim=1)


# ---------------------------------------------------------------------------
# Decode (single new token against a KV cache)
# ---------------------------------------------------------------------------

def init_kv_cache(batch: int, cache_len: int, opts: AttnOpts, dtype,
                  quant: bool = False, device=None):
    """KV cache. ``quant`` stores k/v as int8 with per-(b,l,h) fp32 scales;
    the decode kernel reads the int8 form directly."""
    shp = (batch, cache_len, opts.n_kv_heads, opts.head_dim)
    kv_dtype = torch.int8 if quant else dtype
    cache = {
        "k": torch.zeros(shp, dtype=kv_dtype, device=device),
        "v": torch.zeros(shp, dtype=kv_dtype, device=device),
        "pos": torch.full((batch, cache_len), -1, dtype=torch.int32,
                          device=device),
    }
    if quant:
        cache["k_scale"] = torch.ones(shp[:3], dtype=torch.float32,
                                      device=device)
        cache["v_scale"] = torch.ones(shp[:3], dtype=torch.float32,
                                      device=device)
    return cache


def _quant_rows(x):
    """(…, hd) -> int8 values + fp32 scale over the last dim."""
    x32 = x.float()
    amax = x32.abs().amax(dim=-1)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(x32 / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _deq(k, scale, dtype):
    return (k.float() * scale[..., None]).to(dtype)


def _new_rows(cache, k, v, positions):
    """The rows to write for k/v (…, kv, hd) and their positions, by cache
    leaf (int8 values and their scales for a quantized cache)."""
    new = {"pos": positions.to(torch.int32)}
    if "k_scale" in cache:
        new["k"], new["k_scale"] = _quant_rows(k)
        new["v"], new["v_scale"] = _quant_rows(v)
    else:
        new["k"], new["v"] = k, v
    return new


def write_cache(cache, values, positions):
    """Write new rows into a dense (ring) cache in place: ``values`` maps a
    cache leaf's name to its rows, (B, ...) with positions (B,) or
    (B, S, ...) with positions (B, S), cast to the leaf's dtype; row b
    lands at length index ``positions[b] % L``. On DTensor caches (a mesh
    step) the same body runs as a local region on each rank's shards: each
    leaf keeps its placements (the write is in place), and its rows and
    positions are cut as its batch is, with its offset along its length
    where the rules shard it."""
    names = sorted(values)
    leaves = [cache[n] for n in names]
    L = leaves[0].shape[1]
    n = len(names)
    if not isinstance(leaves[0], DTensor):
        _write_local(leaves, [values[k] for k in names], [positions] * n, L,
                     [None] * n)
        return
    specs = [spec_of(t) for t in leaves]
    offs = [None if sp[1] is None else local_offset(t, 1)
            for t, sp in zip(leaves, specs)]
    extra = (None,) * (positions.ndim - 1)      # a prefill's S dim

    def local(*args):
        _write_local(args[:n], args[n:2 * n], args[2 * n:], L, offs)
    local_region(local, leaves[0].device_mesh,
                 in_specs=tuple(specs)
                 + tuple(P(sp[0], *extra, *sp[2:]) for sp in specs)
                 + tuple(P(sp[0], *extra) for sp in specs),
                 out_specs=None)(*leaves, *(values[k] for k in names),
                                 *([positions] * n))


def _write_local(leaves, values, positions, L: int, offs):
    """``write_cache``'s body, on whole leaves or on one rank's shards:
    ``positions[i]`` and ``offs[i]`` are leaf i's positions and its offset
    along its sharded length (None: the leaf holds the whole length). A
    write whose index falls outside a shard goes to the index of the row's
    first write inside it, with that write's value (to the row's first
    slot, with its own value, where none falls inside), so no two writes
    to one index differ."""
    last = None
    for t, val, pos, lo in zip(leaves, values, positions, offs):
        if pos is not last:             # the plain path: one for all leaves
            last, B = pos, pos.shape[0]
            pos = pos.reshape(B, -1)
            idx = (pos % L).long()                # (B, S)
            b = torch.arange(B, device=pos.device)[:, None]
        val = val.reshape(idx.shape + tuple(t.shape[2:])).to(t.dtype)
        li = idx
        if lo is not None:
            li = li - lo
            ok = (li >= 0) & (li < t.shape[1])
            some = ok.any(1, keepdim=True)
            first = ok.to(torch.int32).argmax(1, keepdim=True)   # (B, 1)
            li = torch.where(ok, li, torch.where(some, li.gather(1, first),
                                                 0))
            tail = (1,) * (val.ndim - 2)
            first_val = torch.gather(val, 1, first.reshape(
                (B, 1) + tail).expand((B, 1) + val.shape[2:]))
            fill = torch.where(some.reshape((B, 1) + tail), first_val,
                               t[:, :1])
            val = torch.where(ok.reshape(ok.shape + tail), val, fill)
        t[b, li] = val


def fill_kv_cache(cache, k, v, positions):
    """Write prefill k/v (B,S,kv,hd) into the cache in place (ring for
    local layers). Returns the cache."""
    L = cache["k"].shape[1]
    S = k.shape[1]
    if S > L:                                     # keep last L entries (ring)
        k, v, positions = k[:, -L:], v[:, -L:], positions[:, -L:]
    write_cache(cache, _new_rows(cache, k, v, positions), positions)
    return cache


def init_paged_kv_pool(n_pages: int, page_size: int, opts: AttnOpts, dtype,
                       quant: bool = False, device=None):
    """Paged KV pool: one shared page set instead of per-sequence rows.
    Page 0 is reserved by the engine as the null/scratch page — unused
    block-table entries point at it, and inactive batch rows write their
    (discarded) k/v there with pos -1, so a sweep through any table never
    sees a valid-looking stale position."""
    return init_kv_cache(n_pages, page_size, opts, dtype, quant=quant,
                         device=device)


def attn_decode_paged(p, x, positions, cache, block_tables, opts: AttnOpts):
    """Paged-cache decode step. x (B,1,d); positions (B,1) absolute with -1
    for inactive batch rows; cache leaves (P, ps, kv, hd) / pos (P, ps);
    block_tables (B, nb) int32 page ids (0 pads unused entries).

    The new k/v lands at page ``block_tables[b, pos // ps]`` offset
    ``pos % ps`` — the engine guarantees that page is privately owned
    (copy-on-write happens host-side before a shared page is written)."""
    ps = cache["k"].shape[1]
    q, k, v = _qkv(p, x, positions, opts)        # k/v (B,1,kv,hd)
    pos = positions[:, 0]
    active = pos >= 0
    safe = pos.clamp(min=0)
    pid = torch.gather(block_tables, 1, (safe // ps)[:, None].long())[:, 0]
    pid = torch.where(active, pid, torch.zeros_like(pid)).long()
    off = torch.where(active, safe % ps, torch.zeros_like(safe)).long()
    # inactive rows write the reserved scratch page with pos -1
    for name, rows in _new_rows(cache, k[:, 0], v[:, 0], torch.where(
            active, pos, torch.full_like(pos, -1))).items():
        cache[name][pid, off] = rows.to(cache[name].dtype)
    if opts.causal and not opts.softcap:
        y = _paged_kernel_attend(q, cache, positions, block_tables, opts)
    else:
        B = x.shape[0]
        bt = block_tables.long()
        if "k_scale" in cache:
            k_all = _deq(cache["k"][bt], cache["k_scale"][bt], x.dtype)
            v_all = _deq(cache["v"][bt], cache["v_scale"][bt], x.dtype)
        else:
            k_all, v_all = cache["k"][bt], cache["v"][bt]
        k_all = k_all.reshape((B, -1) + k_all.shape[3:])
        v_all = v_all.reshape((B, -1) + v_all.shape[3:])
        kpos = cache["pos"][bt].reshape(B, -1)
        mask = _causal_mask(positions, kpos, opts.window, opts.causal,
                            k_valid=kpos >= 0)
        y = _attend(q, k_all, v_all, mask, opts)
    out = torch.einsum("bshgk,hgkd->bsd", y, p["wo"].to(x.dtype))
    return out, cache


def attn_decode(p, x, positions, cache, opts: AttnOpts, update_cache=True):
    """x (B,1,d); positions (B,1) absolute. Returns (y, cache) with the
    cache updated in place.

    On DTensor caches (a mesh step) the write runs in a local region on
    each rank's shard of the cache (``write_cache``), and so does the
    decode kernel (``_decode_attend_mesh``)."""
    q, k, v = _qkv(p, x, positions, opts)        # k/v (B,1,kv,hd)
    if update_cache:
        write_cache(cache, _new_rows(cache, k[:, 0], v[:, 0],
                                     positions[:, 0]), positions[:, 0])
    if isinstance(cache["k"], DTensor):
        y = _decode_attend_mesh(q, cache, positions, opts)
    else:
        y = _decode_attend(q, cache, positions, opts)
    out = torch.einsum("bshgk,hgkd->bsd", y, p["wo"].to(x.dtype))
    return out, cache


def _decode_attend_mesh(q, cache, positions, opts: AttnOpts):
    """``_decode_attend`` on DTensor caches. The kernel runs in a local
    region on each rank's shards: batch over the dp axes, kv heads over
    "model", and the cache length as the rules shard it. Where the length
    is sharded each rank sweeps its own rows and the ranks merge their
    outputs by their rows' log-sum-exps (``_merge_lse``), as the kernel's
    merge pass merges its splits. The einsum path (a logit softcap, or no
    causal mask) runs on the DTensors, whose softmax DTensor reduces
    across the length shards, as GSPMD partitions the reference's."""
    bd, ld, hm, _ = spec_of(cache["k"])
    if not (opts.causal and not opts.softcap):
        return _decode_attend(q, cache, positions, opts)
    names = sorted(cache)
    mesh = cache["k"].device_mesh
    dims = [axis_names(mesh).index(a) for a in
            (() if ld is None else ld if isinstance(ld, tuple) else (ld,))]

    def local(qq, pos, *leaves):
        leaves = dict(zip(names, leaves))
        if not dims:
            return _decode_attend(qq, leaves, pos, opts)
        y, lse = _decode_kernel_attend(qq, leaves, pos, opts,
                                       return_lse=True)
        return _merge_lse(y, lse, mesh, dims)
    return local_region(
        local, mesh,
        in_specs=(P(bd, None, hm, None, None), P(bd, None))
        + tuple(P(bd, ld, *spec_of(cache[n])[2:]) for n in names),
        out_specs=P(bd, None, hm, None, None))(
            q, positions, *(cache[n] for n in names))


def _merge_lse(y, lse, mesh, dims):
    """Merge one decode step's outputs over the ranks of mesh ``dims``,
    each computed on that rank's rows of the cache: y (B,1,kv,g,hd), lse
    (B, kv * g) its rows' log-sum-exps (``merge_by_lse``)."""
    shape, dtype = y.shape, y.dtype
    o = y.reshape(lse.shape + shape[-1:])                    # (B, Hq, hd)
    for d in dims:
        group = (mesh, d)
        o, lse = merge_by_lse(funcol.all_gather_tensor(o[None], 0, group),
                              funcol.all_gather_tensor(lse[None], 0, group))
    return o.to(dtype).reshape(shape)


def _decode_attend(q, cache, positions, opts: AttnOpts):
    """q (B,1,kv,g,hd) against the whole cache: the decode kernel where it
    serves (causal, no softcap), else the einsum path."""
    if opts.causal and not opts.softcap:
        y = _decode_kernel_attend(q, cache, positions, opts)
    else:
        if "k_scale" in cache:
            k_all = _deq(cache["k"], cache["k_scale"], q.dtype)
            v_all = _deq(cache["v"], cache["v_scale"], q.dtype)
        else:
            k_all, v_all = cache["k"], cache["v"]
        kpos = cache["pos"]
        mask = _causal_mask(positions, kpos, opts.window, opts.causal,
                            k_valid=kpos >= 0)
        y = _attend(q, k_all, v_all, mask, opts)
    return y
