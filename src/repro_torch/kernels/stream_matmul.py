"""Streaming matrix multiply: the paper's section V user core, a stream of
small (16x16 or 32x32) products, and one 2-D product.

Replaces the Pallas kernels ``repro.kernels.stream_matmul.stream_matmul``
and ``stream_matmul_batched`` with one hand-written CUDA source
(``csrc/stream_matmul.cu``, two entry points). Beside it, the plain PyTorch
versions ``matmul_ref`` / ``matmul_batched_ref`` (ported from
``repro.kernels.ref``: the product in fp32, the output in ``a``'s dtype)
serve CPU tensors and are what the kernel is held against.

The 2-D product runs on the tensor cores in 128x128 output tiles; a product
with fewer tiles than the card has SMs splits K over blocks
(``matmul_plan``), each split writing an fp32 partial that a second pass
sums in split order. ``matmul_split_ref`` is the plain model of that split:
the CPU tests hold it against the JAX package.

Shapes: ``a`` (M, K) @ ``b`` (K, N), any M, K, N; batched ``a`` (G, M, K) @
``b`` (G, K, N), one launch for the whole stream. Both operands float32 or
both bfloat16, contiguous.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _lib

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MM_TILE = 128                  # output tile rows and columns (csrc: kMmBM/BN)
MM_BK = {torch.float32: 16, torch.bfloat16: 64}   # k tile (csrc: MmCfg::kBK)
MM_MIN_SPLIT_KT = 2            # k tiles a split at least
MM_MAX_SPLITS = 64


class MatmulPlan(NamedTuple):
    """How the 2-D kernel cuts a product: ``tiles_m`` x ``tiles_n`` output
    tiles of ``tile`` x ``tile``, K in tiles of ``bk`` rows, ``n_split``
    splits of ``kt_per`` k tiles each (the last may be shorter)."""
    tile: int
    bk: int
    tiles_m: int
    tiles_n: int
    n_split: int
    kt_per: int


def matmul_plan(M: int, K: int, N: int, dtype, sms: int) -> MatmulPlan:
    """Split K over blocks when the output tiles are fewer than ``sms``
    (about one wave): as many splits as fill the card, each at least
    ``MM_MIN_SPLIT_KT`` k tiles, at most ``MM_MAX_SPLITS``; no split is
    empty."""
    bk = MM_BK[dtype]
    tm, tn = -(-M // MM_TILE), -(-N // MM_TILE)
    k_tiles = max(1, -(-K // bk))
    n = 1
    if tm * tn < sms:
        n = max(1, min(-(-sms // (tm * tn)), k_tiles // MM_MIN_SPLIT_KT,
                       MM_MAX_SPLITS))
    kt_per = -(-k_tiles // n)
    return MatmulPlan(MM_TILE, bk, tm, tn, -(-k_tiles // kt_per), kt_per)


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------

def matmul_ref(a, b):
    """(M, K) @ (K, N) in fp32, output in a's dtype."""
    return torch.matmul(a.float(), b.float()).to(a.dtype)


def matmul_split_ref(a, b, plan: MatmulPlan):
    """The kernel's split-K as plain PyTorch: split z takes K rows
    [z * kt_per * bk, (z + 1) * kt_per * bk), its product in fp32; the
    partials are summed in split order, the sum rounded to a's dtype."""
    rows = plan.kt_per * plan.bk
    out = None
    for z in range(plan.n_split):
        part = torch.matmul(a[:, z * rows:(z + 1) * rows].float(),
                            b[z * rows:(z + 1) * rows].float())
        out = part if out is None else out + part
    return out.to(a.dtype)


def matmul_batched_ref(a, b):
    """(G, M, K) @ (G, K, N) in fp32, output in a's dtype."""
    return matmul_ref(a, b)          # torch.matmul batches leading dims


# ---------------------------------------------------------------------------
# CUDA kernel wrappers
# ---------------------------------------------------------------------------

def _entry(symbol: str, argtypes):
    lib = _lib.library("stream_matmul")
    fn = getattr(lib, symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return lib, fn


def _check(name, a, b, ndim):
    if a.device.type != "cuda":
        raise ValueError(f"{name}: the CUDA kernel takes CUDA tensors, got "
                         f"{a.device}")
    if b.device != a.device:
        raise ValueError(f"{name}: both operands must be on {a.device}, got "
                         f"{b.device}")
    if a.dtype not in _DTYPES or b.dtype != a.dtype:
        raise TypeError(f"{name}: dtypes {a.dtype}/{b.dtype} (both float32 "
                        f"or both bfloat16)")
    if a.dim() != ndim or b.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim}-D operands, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if a.shape[:-2] != b.shape[:-2] or a.shape[-1] != b.shape[-2]:
        raise ValueError(f"{name}: shapes {tuple(a.shape)} @ "
                         f"{tuple(b.shape)} do not chain")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError(f"{name}: operands must be contiguous")
    if a.requires_grad or b.requires_grad:
        raise ValueError(f"{name}: inference kernel, no backward")


def stream_matmul_cuda(a, b):
    """The CUDA kernel on one (M, K) @ (K, N) product: one launch of the
    tile kernel, plus the split sum when the plan splits K (counted as one
    launch). The plan used is left in ``_lib.last_plan``."""
    name = "stream_matmul"
    _check(name, a, b, 2)
    M, K = a.shape
    N = b.shape[1]
    out = torch.empty((M, N), dtype=a.dtype, device=a.device)
    if out.numel() == 0:
        return out
    if K == 0:
        return out.zero_()
    sms = torch.cuda.get_device_properties(a.device).multi_processor_count
    plan = matmul_plan(M, K, N, a.dtype, sms)
    ws = (torch.empty((plan.n_split, M, N), dtype=torch.float32,
                      device=a.device) if plan.n_split > 1 else None)
    lib, fn = _entry("rt_stream_matmul", [ctypes.c_void_p] * 4
                     + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    stream = torch.cuda.current_stream(a.device).cuda_stream
    rc = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(),
            None if ws is None else ws.data_ptr(), M, K, N,
            _DTYPES[a.dtype], plan.n_split, plan.kt_per, stream)
    _lib.check(rc, lib, name)
    _lib.launches[name] += 1
    _lib.last_plan[name] = plan
    return out


def stream_matmul_batched_cuda(a, b):
    """The CUDA kernel on a (G, M, K) @ (G, K, N) stream, one launch."""
    name = "stream_matmul_batched"
    _check(name, a, b, 3)
    G, M, K = a.shape
    N = b.shape[2]
    out = torch.empty((G, M, N), dtype=a.dtype, device=a.device)
    if out.numel() == 0:
        return out
    if K == 0:
        return out.zero_()
    lib, fn = _entry("rt_stream_matmul_batched",
                     [ctypes.c_void_p] * 3 + [ctypes.c_longlong]
                     + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    stream = torch.cuda.current_stream(a.device).cuda_stream
    rc = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), G, M, K, N,
            _DTYPES[a.dtype], stream)
    _lib.check(rc, lib, name)
    _lib.launches[name] += 1
    return out
