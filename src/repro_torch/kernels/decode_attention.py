"""Decode attention: one new query token per sequence against a dense
(ring-buffered) KV cache or a block-table-paged pool, GQA, online softmax.

Replaces the Pallas kernels ``repro.kernels.decode_attention.decode_attention``
and ``paged_decode_attention`` with hand-written split-K CUDA kernels
(``csrc/decode_attention.cu``): a split pass over (sequence, kv head,
query heads, row range) blocks that writes unnormalised fp32 partials, and
a merge pass that combines them. A dense cache is the paged case with one
"page" per sequence. The split pass has two kernels, chosen from shapes and
dtype alone (``registry.decode_route``): a bf16 group past one chunk of
query heads takes ``decode_group_kernel`` (the whole group, or M-row slices
of it, scored on the tensor cores over K/V tiles staged once in shared
memory; ``registry.decode_group_plan``), every other launch
``decode_split_kernel`` (``head_chunks`` cuts the group into the chunks a
block holds, MQA included). ``split_plan`` picks the number of splits.
Beside them, the plain PyTorch versions (``decode_attention_ref``,
``paged_decode_attention_ref``, ported from ``repro.kernels.ref``) serve
CPU tensors and are what the kernels are held against;
``decode_partials_ref`` and ``merge_partials_ref`` are the plain versions
of the two passes, and ``decode_group_partials_ref`` is the pass model of
the group kernel (its tiles, key groups, bf16 roundings and scale folds).

Layouts are the reference's: q (B, Hq, D); dense k/v (B, Hkv, L, D), kpos
(B, L), scales (B, Hkv, L); pools (P, Hkv, ps, D), kpos_pool (P, ps), scales
(P, Hkv, ps); block_tables (B, nb); cur (B,). Any of k, v, the scales and
kpos may be strided views (the serving caches are (B, L, Hkv, D) and
(P, ps, Hkv, D) rows, passed transposed without a copy); the last dim of
q/k/v must be contiguous, and K/V rows start on 16 bytes (8 for int8): the
kernel reads them as vectors.

Masking: a key counts when ``kpos >= 0 & kpos <= cur`` (and
``cur - kpos < window``). A row with no such key (an idle slot, cur = -1)
returns the mean of the swept V rows, as the Pallas kernel and
``repro.kernels.ref`` do: all L rows of a dense cache, all ``nb * ps`` rows
of the pages a block-table row names (null page and repeats included),
dequantized with ``v_scale`` on the int8 path.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.registry import (GroupPlan, decode_group_plan,
                                          decode_route)

CHUNK_HEADS = 8                # query heads a decode block holds at most
WIDE_CHUNK_HEADS = 4           # the same past MAX_PADDED_HEAD_DIM
# the head dims the three attention kernels are built for: those of every
# dense and hybrid config, then 384 and 512. Another multiple of 8 up to
# MAX_PADDED_HEAD_DIM is zero-padded to the next of them; one above it runs
# on the next of them in place, the kernel masking the row's tail
# (``padded_head_dim``)
HEAD_DIMS = (32, 64, 96, 112, 128, 256, 384, 512)
MAX_PADDED_HEAD_DIM = 256
MIN_SPLIT_ROWS = 64            # floor of rows a split sweeps
GROUP_MIN_SPLIT_ROWS = 32      # the same on the group kernel's route
SPLIT_WAVES = 2                # aim for this many blocks per SM
MAX_SPLITS = 128               # the merge pass's limit


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------

def decode_attention_ref(q, k, v, kpos, cur, *, window: int = 0,
                         scale: float = 0.0, k_scale=None, v_scale=None,
                         return_lse: bool = False):
    """q (B, Hq, D); k/v (B, Hkv, L, D) (int8 with ``k_scale``/``v_scale``
    (B, Hkv, L)); kpos (B, L); cur (B,). Returns (B, Hq, D) in q's dtype;
    with ``return_lse`` also each row's log-sum-exp of its scaled scores
    over the valid keys, (B, Hq) fp32 (-inf where there is none)."""
    B, Hq, D = q.shape
    Hkv = k.shape[1]
    g = Hq // Hkv
    scale = scale or D ** -0.5
    k = k.float()
    v = v.float()
    if k_scale is not None:
        k = k * k_scale[..., None]
        v = v * v_scale[..., None]
    kk = k.repeat_interleave(g, dim=1)
    vv = v.repeat_interleave(g, dim=1)
    s = torch.einsum("bhd,bhld->bhl", q.float() * scale, kk)
    cur = cur[:, None]
    mask = (kpos >= 0) & (kpos <= cur)
    if window:
        mask &= (cur - kpos) < window
    out = torch.einsum("bhl,bhld->bhd", torch.softmax(
        s.masked_fill(~mask[:, None, :], -1e30), dim=-1), vv).to(q.dtype)
    if not return_lse:
        return out
    return out, torch.logsumexp(
        s.masked_fill(~mask[:, None, :], float("-inf")), dim=-1)


def paged_decode_attention_ref(q, k_pool, v_pool, kpos_pool, block_tables,
                               cur, *, window: int = 0, scale: float = 0.0,
                               k_scale=None, v_scale=None):
    """Paged-cache version: gather pages through the block table into the
    dense layout, then defer to ``decode_attention_ref``.

    q (B, Hq, D); k/v pools (P, Hkv, ps, D); kpos_pool (P, ps); block_tables
    (B, nb) page ids; cur (B,). Unused block-table entries must reference
    pages whose kpos entries are -1 (the engine reserves page 0 for this).
    ``k_scale``/``v_scale`` (P, Hkv, ps) enable the int8-pool path."""
    B, nb = block_tables.shape
    Hkv, ps = k_pool.shape[1], k_pool.shape[2]
    L = nb * ps
    bt = block_tables.long()

    def gather(pool):          # (P, Hkv, ps, ...) -> (B, Hkv, L, ...)
        g = pool[bt]           # (B, nb, Hkv, ps, ...)
        return g.movedim(2, 1).reshape((B, Hkv, L) + tuple(pool.shape[3:]))

    kpos = kpos_pool[bt].reshape(B, L)
    return decode_attention_ref(
        q, gather(k_pool), gather(v_pool), kpos, cur, window=window,
        scale=scale,
        k_scale=None if k_scale is None else gather(k_scale),
        v_scale=None if v_scale is None else gather(v_scale))


# ---------------------------------------------------------------------------
# Split-K: the plan and the plain versions of the two passes
# ---------------------------------------------------------------------------

def split_plan(bh: int, capacity: int, sm_count: int, unit: int = 16,
               min_rows: int = MIN_SPLIT_ROWS) -> Tuple[int, int]:
    """(n_split, split_rows) for ``bh`` = B*Hkv (sequence, kv head) pairs
    (times the head chunks or group slices a pair's blocks) over
    ``capacity`` swept rows (L, or nb*ps), from shapes alone: about
    ``SPLIT_WAVES`` blocks per SM, at least ``min_rows`` rows a split,
    ``split_rows`` a multiple of ``unit`` (the split kernel's route: the
    page size of a paged cache, so that a split covers whole block-table
    entries), at most ``MAX_SPLITS`` splits, and one split when ``bh``
    already fills the card. Split i sweeps rows [i*split_rows,
    min(capacity, (i+1)*split_rows)); every split holds at least one
    row."""
    capacity = max(int(capacity), 1)
    n = 1
    if bh < sm_count:
        n = min(-(-SPLIT_WAVES * sm_count // bh), MAX_SPLITS,
                max(1, capacity // min_rows))
    rows = -(-capacity // n)
    rows = -(-rows // unit) * unit
    return -(-capacity // rows), rows


def head_chunks(g: int, D: int) -> Tuple[int, int]:
    """(heads a block, chunks) for a kv head's group of ``g`` query heads
    at head dim ``D``: a block holds at most ``CHUNK_HEADS`` heads
    (``WIDE_CHUNK_HEADS`` past ``MAX_PADDED_HEAD_DIM``: registers), so a
    larger group runs in ``ceil(g / most)`` chunks of ``ceil(g / chunks)``
    heads, the last holding the rest; chunk c covers heads ``c * heads``
    .. ``min(g, (c + 1) * heads) - 1`` of the group, and each reads the kv
    head's rows itself."""
    most = CHUNK_HEADS if D <= MAX_PADDED_HEAD_DIM else WIDE_CHUNK_HEADS
    n = -(-g // most)
    return -(-g // n), n


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def uses_group_kernel(g: int, D: int, dtype) -> bool:
    """Whether a launch of ``g`` query heads a kv head at head dim ``D``
    with q of ``dtype`` (a torch dtype or its name) takes
    ``decode_group_kernel`` (bf16, a group past one chunk of
    ``head_chunks``), from shapes and dtype alone."""
    return decode_route(g, D, str(dtype).replace("torch.", "")) == "group"


def launch_plan(B: int, Hkv: int, g: int, D: int, dtype, capacity: int,
                sm_count: int, page: int = 0):
    """What the wrapper launches for ``B`` sequences of ``Hkv`` kv heads
    of ``g`` query heads at head dim ``D`` over ``capacity`` swept rows
    (``page``: a paged pool's page size, 0 dense): (n_split, split_rows,
    plan), ``plan`` the group kernel's ``GroupPlan`` on its route, else
    None. On the group route ``split_plan`` counts the group's slices
    and cuts splits at any row (the kernel finds each row's page) down to
    ``GROUP_MIN_SPLIT_ROWS``: a block holds the whole group, so the
    chunked route's floor of 64 rows at 16-row units would leave an MQA
    group (one kv head a sequence) at 32 splits, under two blocks an SM
    at B 8, L 2048."""
    if uses_group_kernel(g, D, dtype):
        plan = decode_group_plan(g, D)
        return split_plan(B * Hkv * plan.n_slices, capacity, sm_count,
                          unit=1, min_rows=GROUP_MIN_SPLIT_ROWS) + (plan,)
    return split_plan(B * Hkv * head_chunks(g, D)[1], capacity, sm_count,
                      unit=page or 16) + (None,)


def decode_partials_ref(q, k, v, kpos, cur, split_rows: int, *,
                        window: int = 0, scale: float = 0.0, k_scale=None,
                        v_scale=None):
    """Plain version of the split pass on a dense cache (arguments as
    ``decode_attention_ref``): the sweep cut into splits of ``split_rows``
    rows. Returns fp32 partials acc (B, Hq, n_split, D) (unnormalised), m
    and l (B, Hq, n_split); a split with no valid key has m = -inf, l = 0
    and acc = 0. (The kernel keeps m in log2 units; this version in natural
    ones.)"""
    B, Hq, D = q.shape
    Hkv, L = k.shape[1], k.shape[2]
    g = Hq // Hkv
    scale = scale or D ** -0.5
    k = k.float()
    v = v.float()
    if k_scale is not None:
        k = k * k_scale[..., None]
        v = v * v_scale[..., None]
    s = torch.einsum("bhd,bhld->bhl", q.float() * scale,
                     k.repeat_interleave(g, dim=1))
    c = cur[:, None]
    mask = (kpos >= 0) & (kpos <= c)
    if window:
        mask &= (c - kpos) < window
    s = s.masked_fill(~mask[:, None, :], float("-inf"))
    n = -(-L // split_rows)
    pad = n * split_rows - L
    s = torch.nn.functional.pad(s, (0, pad), value=float("-inf"))
    vv = torch.nn.functional.pad(v.repeat_interleave(g, dim=1),
                                 (0, 0, 0, pad))
    s = s.reshape(B, Hq, n, split_rows)
    m = s.amax(-1)
    p = torch.exp(s - torch.where(torch.isinf(m), 0.0, m)[..., None])
    acc = torch.einsum("bhnr,bhnrd->bhnd", p,
                       vv.reshape(B, Hq, n, split_rows, D))
    return acc, m, p.sum(-1)


def decode_group_partials_ref(q, k, v, kpos, cur, split_rows: int,
                              plan: GroupPlan, *, window: int = 0,
                              scale: float = 0.0, k_scale=None, v_scale=None):
    """Pass model of ``decode_group_kernel`` on a dense cache (arguments as
    ``decode_attention_ref``; q bf16, K/V bf16 or int8 with row scales),
    partials as ``decode_partials_ref``. It does what the kernel does: a
    split's rows in tiles of ``plan.rows``, each tile in 16-key steps, step
    i of a tile taken by key group ``i % plan.key_groups`` with an online
    softmax of its own; scores q·k of bf16 values summed in fp32, times
    ``scale * log2(e)`` (and the key's ``k_scale``), in log2 units; P
    times the key's ``v_scale``, rounded to bf16, then P·V in fp32; the key
    groups merged at the end of the split. Heads are independent, so the
    M-row slices leave the numbers as they are. An idle row (cur < 0)
    reports the split's sum of its (dequantized) V rows as acc, with
    m = -inf and l = 0, as the kernel does for the merge's mean. Returns
    acc (B, Hq, n_split, D), m (natural units, as ``merge_partials_ref``
    takes it) and l (B, Hq, n_split)."""
    B, Hq, D = q.shape
    Hkv, L = k.shape[1], k.shape[2]
    g = Hq // Hkv
    log2e = 1.4426950408889634
    s_mul = (scale or D ** -0.5) * log2e
    quant = k_scale is not None
    f32 = dict(dtype=torch.float32, device=q.device)
    qf = q.float().reshape(B, Hkv, g, D)
    kf, vf = k.float(), v.float()
    ks = k_scale.float() if quant else torch.ones(B, Hkv, L, **f32)
    vs = v_scale.float() if quant else torch.ones(B, Hkv, L, **f32)
    c = cur[:, None]
    valid = (kpos >= 0) & (kpos <= c)
    if window:
        valid &= (c - kpos) < window
    idle = cur < 0
    n = -(-L // split_rows)
    acc = torch.zeros(B, Hkv, g, n, D, **f32)
    m_out = torch.full((B, Hkv, g, n), float("-inf"), **f32)
    l_out = torch.zeros(B, Hkv, g, n, **f32)
    kg = plan.key_groups
    for i in range(n):
        lo, hi = i * split_rows, min(L, (i + 1) * split_rows)
        st = [[torch.full((B, Hkv, g), float("-inf"), **f32),
               torch.zeros(B, Hkv, g, **f32), torch.zeros(B, Hkv, g, D, **f32)]
              for _ in range(kg)]
        for t0 in range(lo, hi, plan.rows):
            for j, k0 in enumerate(range(t0, min(t0 + plan.rows, hi), 16)):
                k1 = min(k0 + 16, hi)
                m, l, o = st[j % kg]
                s = torch.einsum("bhgd,bhkd->bhgk", qf, kf[:, :, k0:k1])
                s = s * (s_mul * ks[:, :, None, k0:k1])
                s = s.masked_fill(~valid[:, None, None, k0:k1],
                                  float("-inf"))
                m_new = torch.maximum(m, s.amax(-1))
                base = torch.where(torch.isinf(m_new), 0.0, m_new)
                alpha = torch.exp2(m - base)
                p = torch.exp2(s - base[..., None])
                pv = (p * vs[:, :, None, k0:k1]).to(torch.bfloat16).float()
                st[j % kg] = [m_new, l * alpha + p.sum(-1),
                              o * alpha[..., None] + torch.einsum(
                                  "bhgk,bhkd->bhgd", pv, vf[:, :, k0:k1])]
        m, l, o = st[0]
        for m2, l2, o2 in st[1:]:
            mn = torch.maximum(m, m2)
            base = torch.where(torch.isinf(mn), 0.0, mn)
            c1, c2 = torch.exp2(m - base), torch.exp2(m2 - base)
            m, l, o = mn, l * c1 + l2 * c2, (o * c1[..., None]
                                              + o2 * c2[..., None])
        vsum = (vf[:, :, lo:hi] * vs[:, :, lo:hi, None]).sum(2)
        acc[:, :, :, i] = torch.where(idle[:, None, None, None],
                                      vsum[:, :, None], o)
        m_out[:, :, :, i] = torch.where(idle[:, None, None],
                                        float("-inf"), m)
        l_out[:, :, :, i] = torch.where(idle[:, None, None], 0.0, l)
    return (acc.reshape(B, Hq, n, D), m_out.reshape(B, Hq, n) / log2e,
            l_out.reshape(B, Hq, n))


def merge_partials_ref(acc, m, l, mean_v):
    """Plain version of the merge pass: o = sum_i e^(m_i - m*) acc_i /
    sum_i e^(m_i - m*) l_i over the splits; a row whose splits are all
    empty (m = -inf everywhere) takes ``mean_v`` (B, Hq, D), the mean of
    its swept V rows. Returns (B, Hq, D) fp32."""
    mmax = m.amax(-1, keepdim=True)
    idle = torch.isinf(mmax)
    w = torch.exp(m - torch.where(idle, 0.0, mmax))
    num = (w[..., None] * acc).sum(2)
    den = (w * l).sum(2, keepdim=True)
    return torch.where(idle, mean_v.float(), num / torch.where(idle, 1.0, den))


def merge_by_lse(o, lse):
    """Merge decode outputs computed on R pieces of each row's keys (a
    cache whose length lies on R ranks): o (R, B, Hq, D), each piece's
    output normalised over its own keys, lse (R, B, Hq) fp32 its
    log-sum-exp (``return_lse``; -inf where the piece has no valid key).
    o = sum_r e^(lse_r - m) o_r / sum_r e^(lse_r - m); a row with no valid
    key in any piece takes the mean of the pieces' outputs, each the mean
    of its own V rows, which is the mean of all of them for equal pieces.
    Returns (o (B, Hq, D) fp32, lse (B, Hq))."""
    o = o.float()
    m = lse.amax(0)
    idle = torch.isinf(m)
    w = torch.exp(lse - torch.where(idle, 0.0, m))
    den = w.sum(0)
    out = torch.where(idle[..., None], o.mean(0),
                      (w[..., None] * o).sum(0)
                      / torch.where(idle, 1.0, den)[..., None])
    return out, torch.where(idle, m, m + torch.log(den))


# ---------------------------------------------------------------------------
# Head dims outside HEAD_DIMS
# ---------------------------------------------------------------------------

def padded_head_dim(name: str, D: int) -> int:
    """The head dim the kernels run a head dim ``D`` at: ``D`` itself when
    it is in ``HEAD_DIMS``, else, for a multiple of 8 up to the largest (the
    reference's kernels take any multiple of 8), the next member of the set.
    Up to ``MAX_PADDED_HEAD_DIM`` the wrappers zero-pad q, k and v to it
    (``pads_head_dim``): zero columns leave q·k unchanged and add zero
    columns to the output, so the caller pads, passes the true scale
    ``D ** -0.5`` and slices the output back to ``D``. Above it the kernel
    built for that width reads the true ``D`` in place and masks the rest.
    Raises for others, naming the largest width."""
    if D in HEAD_DIMS:
        return D
    if D % 8 or D < 8 or D > HEAD_DIMS[-1]:
        raise ValueError(f"{name}: head dim {D}: the attention kernels take "
                         f"a multiple of 8 up to {HEAD_DIMS[-1]} (built for "
                         f"{HEAD_DIMS}; others up to {MAX_PADDED_HEAD_DIM} "
                         "zero-padded to the next of them, others past it "
                         "read in place)")
    return next(d for d in HEAD_DIMS if d > D)


def pad_head_dim(x: torch.Tensor, Dp: int) -> torch.Tensor:
    """``x`` with zero columns appended along its last dim up to ``Dp``
    (a fresh contiguous tensor; ``x`` itself when it is ``Dp`` wide)."""
    if x.shape[-1] == Dp:
        return x
    return torch.nn.functional.pad(x, (0, Dp - x.shape[-1]))


def pads_head_dim(name: str):
    """Decorator for an attention function ``fn(q, k, v, *args, scale=...,
    **kw)`` whose q, k and v share their last dim ``D``: where ``D`` is not
    in ``HEAD_DIMS`` and at most ``MAX_PADDED_HEAD_DIM``, ``fn`` runs on q,
    k and v zero-padded to ``padded_head_dim(name, D)`` with the true scale
    and its output is sliced back to ``D``. The padding copies q, k and v
    (or the pools) on every call; above ``MAX_PADDED_HEAD_DIM`` nothing is
    copied (the kernels read the true width in place)."""

    def wrap(fn):
        @functools.wraps(fn)
        def padded(q, k, v, *args, scale: float = 0.0, **kw):
            D = q.shape[-1]
            Dp = padded_head_dim(name, D) \
                if k.shape[-1] == v.shape[-1] == D else D
            if Dp == D or D > MAX_PADDED_HEAD_DIM:
                return fn(q, k, v, *args, scale=scale, **kw)
            out = fn(pad_head_dim(q, Dp), pad_head_dim(k, Dp),
                     pad_head_dim(v, Dp), *args, scale=scale or D ** -0.5,
                     **kw)
            if isinstance(out, tuple):      # (output, log-sum-exp)
                return (out[0][..., :D],) + out[1:]
            return out[..., :D]
        return padded
    return wrap


# ---------------------------------------------------------------------------
# CUDA kernel wrappers
# ---------------------------------------------------------------------------

class _Args(ctypes.Structure):
    """Mirror of ``DecodeArgs`` in csrc/decode_attention.cu."""
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "q", "k", "v", "k_scale", "v_scale", "kpos", "cur", "block_tables",
        "out", "ws_acc", "ws_m", "ws_l")] + [(n, ctypes.c_longlong) for n in (
        "q_sb", "q_sh", "k_sp", "k_sh", "k_sl", "v_sp", "v_sh", "v_sl",
        "ks_sp", "ks_sh", "ks_sl", "vs_sp", "vs_sh", "vs_sl", "kp_sp",
        "kp_sl", "bt_sb", "o_sb", "o_sh")] + [(n, ctypes.c_int) for n in (
        "B", "Hq", "Hkv", "D", "nb", "ps", "ps_shift", "window", "n_split",
        "split_rows")] + [
        ("scale", ctypes.c_float), ("dtype", ctypes.c_int),
        ("quant", ctypes.c_int), ("lse", ctypes.c_void_p)] + [
        (n, ctypes.c_int) for n in ("chunk", "group_m", "n_slices",
                                    "group_kg")]


_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def _entry():
    lib = _lib.library("decode_attention")
    fn = lib.rt_decode_attention
    fn.argtypes = [ctypes.POINTER(_Args), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def group_launch_smem(kv_dtype: str, D: int, m: int) -> int:
    """Dynamic shared memory the group kernel's launch requests for a block
    of ``m`` query rows at the build of head dim ``D`` with ``kv_dtype``
    K/V (the library's ``GroupCfg::smem``; -1 for a width with no
    build)."""
    lib, _ = _entry()
    fn = lib.rt_decode_group_smem
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_int
    return fn(int(kv_dtype == "int8"), D, m)


def _check_common(name, q, k, v, kpos, cur, k_scale, v_scale):
    if q.device.type != "cuda":
        raise ValueError(f"{name}: the CUDA kernel takes CUDA tensors, got "
                         f"{q.device}")
    tensors = [q, k, v, kpos, cur] + [t for t in (k_scale, v_scale)
                                      if t is not None]
    for t in tensors:
        if t.device != q.device:
            raise ValueError(f"{name}: all tensors must be on {q.device}, "
                             f"got one on {t.device}")
        if t.requires_grad:
            raise ValueError(f"{name}: inference kernel, no backward")
    if q.dtype not in _DTYPES:
        raise TypeError(f"{name}: q dtype {q.dtype} (float32 or bfloat16)")
    quant = k_scale is not None
    if quant != (v_scale is not None):
        raise ValueError(f"{name}: pass both k_scale and v_scale or neither")
    want = torch.int8 if quant else q.dtype
    if k.dtype != want or v.dtype != want:
        raise TypeError(f"{name}: k/v dtype {k.dtype}/{v.dtype}, "
                        f"expected {want}")
    if quant and (k_scale.dtype != torch.float32
                  or v_scale.dtype != torch.float32):
        raise TypeError(f"{name}: scales must be float32")
    if kpos.dtype != torch.int32 or cur.dtype != torch.int32:
        raise TypeError(f"{name}: kpos and cur must be int32")
    B, Hq, D = q.shape
    Hkv = k.shape[1]
    if k.shape[-1] != D or v.shape[-1] != D:
        raise ValueError(f"{name}: q/k/v head dims {D}/{k.shape[-1]}/"
                         f"{v.shape[-1]} differ")
    padded_head_dim(name, D)        # raises for a width no build takes
    if Hkv < 1 or Hq % Hkv:
        raise ValueError(f"{name}: Hq={Hq} Hkv={Hkv}: need Hq % Hkv == 0")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError(f"{name}: the head dim of q/k/v must be contiguous")
    for t, what in ((k, "k"), (v, "v")):      # rows read as vectors
        _lib.check_rows_aligned(name, what, t, 8 if quant else 16)
    if cur.shape != (B,):
        raise ValueError(f"{name}: cur shape {tuple(cur.shape)} != ({B},)")
    return quant


def _launch(name, q, k, v, kpos, cur, bt, k_scale, v_scale, window, scale,
            nb, ps, lse=None):
    quant = k_scale is not None
    B, Hq, D = q.shape
    out = torch.empty((B, Hq, D), dtype=q.dtype, device=q.device)
    if B == 0:
        return out
    cur = cur.contiguous()
    dev = q.device.index
    dev = torch.cuda.current_device() if dev is None else dev
    Hkv = k.shape[1]
    g = Hq // Hkv
    chunk = head_chunks(g, D)[0]           # query heads a merge block
    n_split, rows, plan = launch_plan(B, Hkv, g, D, q.dtype, nb * ps,
                                      _sm_count(dev),
                                      ps if bt is not None else 0)
    # one workspace: acc (B, Hq, n_split, D), then m and l (B, Hq, n_split)
    n_ml = B * Hq * n_split
    ws = torch.empty(n_ml * (D + 2), dtype=torch.float32, device=q.device)
    ws_acc = ws.data_ptr()
    ks = k_scale.stride() if quant else (0, 0, 0)
    vs = v_scale.stride() if quant else (0, 0, 0)
    a = _Args(
        q=q.data_ptr(), k=k.data_ptr(), v=v.data_ptr(),
        k_scale=k_scale.data_ptr() if quant else None,
        v_scale=v_scale.data_ptr() if quant else None,
        kpos=kpos.data_ptr(), cur=cur.data_ptr(),
        block_tables=bt.data_ptr() if bt is not None else None,
        out=out.data_ptr(), ws_acc=ws_acc, ws_m=ws_acc + n_ml * D * 4,
        ws_l=ws_acc + n_ml * (D + 1) * 4,
        q_sb=q.stride(0), q_sh=q.stride(1),
        k_sp=k.stride(0), k_sh=k.stride(1), k_sl=k.stride(2),
        v_sp=v.stride(0), v_sh=v.stride(1), v_sl=v.stride(2),
        ks_sp=ks[0], ks_sh=ks[1], ks_sl=ks[2],
        vs_sp=vs[0], vs_sh=vs[1], vs_sl=vs[2],
        kp_sp=kpos.stride(0), kp_sl=kpos.stride(1),
        bt_sb=bt.stride(0) if bt is not None else 0,
        o_sb=out.stride(0), o_sh=out.stride(1),
        B=B, Hq=Hq, Hkv=Hkv, D=D, nb=nb, ps=ps,
        ps_shift=ps.bit_length() - 1 if ps & (ps - 1) == 0 else -1,
        window=int(window), n_split=n_split, split_rows=rows,
        scale=float(scale or D ** -0.5), dtype=_DTYPES[q.dtype],
        quant=int(quant), lse=lse.data_ptr() if lse is not None else None,
        chunk=chunk, group_m=plan.m if plan else 0,
        n_slices=plan.n_slices if plan else 0,
        group_kg=plan.key_groups if plan else 0)
    lib, fn = _entry()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    # the split and the merge pass; a launch on the group route also adds
    # one to decode_group, the count of that route's launches
    rc = fn(ctypes.byref(a), stream)  # rc3e: allow-launch-count
    _lib.check(rc, lib, name)
    _lib.launches[name] += 1
    _lib.last_plan[name] = (n_split, rows)
    if plan:                    # of those launches, the group kernel's
        _lib.launches["decode_group"] += 1
        _lib.last_plan["decode_group"] = plan
    return out


@pads_head_dim("decode_attention")
def decode_attention_cuda(q, k, v, kpos, cur, *, window: int = 0,
                          scale: float = 0.0, k_scale=None, v_scale=None,
                          return_lse: bool = False):
    """The CUDA kernel on a dense cache; arguments and results as
    ``decode_attention_ref`` (the merge pass writes the log-sum-exp). Any
    group of query heads a kv head (``uses_group_kernel`` picks the split
    kernel); a head dim outside ``HEAD_DIMS`` runs as ``padded_head_dim``
    says."""
    name = "decode_attention"
    quant = _check_common(name, q, k, v, kpos, cur, k_scale, v_scale)
    B, _, D = q.shape
    Hkv, L = k.shape[1], k.shape[2]
    for t, shp in ((k, (B, Hkv, L, D)), (v, (B, Hkv, L, D)), (kpos, (B, L))):
        if tuple(t.shape) != shp:
            raise ValueError(f"{name}: shape {tuple(t.shape)} != {shp}")
    if quant and (tuple(k_scale.shape) != (B, Hkv, L)
                  or tuple(v_scale.shape) != (B, Hkv, L)):
        raise ValueError(f"{name}: scales must be (B, Hkv, L)")
    if not return_lse:
        return _launch(name, q, k, v, kpos, cur, None, k_scale, v_scale,
                       window, scale, nb=1, ps=L)
    lse = torch.empty((B, q.shape[1]), dtype=torch.float32, device=q.device)
    return _launch(name, q, k, v, kpos, cur, None, k_scale, v_scale, window,
                   scale, nb=1, ps=L, lse=lse), lse


@pads_head_dim("paged_decode_attention")
def paged_decode_attention_cuda(q, k_pool, v_pool, kpos_pool, block_tables,
                                cur, *, window: int = 0, scale: float = 0.0,
                                k_scale=None, v_scale=None):
    """The CUDA kernel on a paged pool; arguments as
    ``paged_decode_attention_ref``. Any group, and a head dim outside
    ``HEAD_DIMS`` as ``padded_head_dim`` says."""
    name = "paged_decode_attention"
    quant = _check_common(name, q, k_pool, v_pool, kpos_pool, cur, k_scale,
                          v_scale)
    B, _, D = q.shape
    P, Hkv, ps = k_pool.shape[:3]
    for t, shp in ((v_pool, (P, Hkv, ps, D)), (kpos_pool, (P, ps))):
        if tuple(t.shape) != shp:
            raise ValueError(f"{name}: shape {tuple(t.shape)} != {shp}")
    if quant and (tuple(k_scale.shape) != (P, Hkv, ps)
                  or tuple(v_scale.shape) != (P, Hkv, ps)):
        raise ValueError(f"{name}: scales must be (P, Hkv, ps)")
    if block_tables.dtype != torch.int32 or block_tables.dim() != 2 \
            or block_tables.shape[0] != B or block_tables.stride(1) != 1 \
            or block_tables.device != q.device:
        raise ValueError(f"{name}: block_tables must be ({B}, nb) int32 "
                         f"with contiguous rows on {q.device}")
    return _launch(name, q, k_pool, v_pool, kpos_pool, cur, block_tables,
                   k_scale, v_scale, window, scale,
                   nb=block_tables.shape[1], ps=ps)
