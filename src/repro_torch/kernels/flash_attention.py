"""Causal flash attention (prefill): GQA, blocked online softmax with an fp32
accumulator, optional sliding window and tanh logit softcap.

Replaces the Pallas kernel ``repro.kernels.flash_attention.flash_attention``
with hand-written CUDA kernels (``csrc/flash_attention.cu``), one per dtype,
both on the tensor cores (``mma.sync``): bfloat16 directly, float32 as
3xTF32 (each operand split into two TF32 halves, three products each, so
that the fp32 tolerance holds). Head dims: ``HEAD_DIMS``; another multiple
of 8 up to 256 runs zero-padded to the next of them, one from 264 to 512 on
the next of them with its rows read in place (the kernel masks the tail).
Beside them, the
plain PyTorch version ``flash_attention_ref`` (ported from
``repro.kernels.ref``) serves CPU tensors and is what the kernels are held
against.

Layout (the reference's): q (B, Hq, S, D); k, v (B, Hkv, S, D), Hq = G·Hkv;
query and key positions are ``arange(S)``. Any S works (the kernel masks
the ragged edge itself), and q/k/v may be strided views whose last dim is
contiguous; both kernels copy rows with 16-byte ``cp.async``, so q/k/v rows
must start on 16 bytes (the layer's views do). Inference only: there is no
backward.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.decode_attention import (padded_head_dim,
                                                  pads_head_dim)


def flash_attention_ref(q, k, v, *, window: int = 0, scale: float = 0.0,
                        softcap: float = 0.0):
    """q (B,Hq,S,D); k/v (B,Hkv,S,D) causal (+optional window)."""
    B, Hq, S, D = q.shape
    Hkv = k.shape[1]
    g = Hq // Hkv
    scale = scale or D ** -0.5
    kk = k.float().repeat_interleave(g, dim=1)
    vv = v.float().repeat_interleave(g, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float() * scale, kk)
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(S, device=q.device)[None, :]
    mask = kpos <= qpos
    if window:
        mask &= (qpos - kpos) < window
    s = s.masked_fill(~mask[None, None], -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vv).to(q.dtype)


class _Args(ctypes.Structure):
    """Mirror of ``FlashArgs`` in csrc/flash_attention.cu."""
    _fields_ = [(n, ctypes.c_void_p) for n in ("q", "k", "v", "out")] + [
        (n, ctypes.c_longlong) for n in (
            "q_sb", "q_sh", "q_ss", "k_sb", "k_sh", "k_ss", "v_sb", "v_sh",
            "v_ss", "o_sb", "o_sh", "o_ss")] + [
        (n, ctypes.c_int) for n in ("B", "Hq", "Hkv", "S", "D", "window")] + [
        ("scale", ctypes.c_float), ("softcap", ctypes.c_float)]


# the kernel's C entry point per dtype
_ENTRIES = {torch.float32: "rt_flash_attention_f32",
            torch.bfloat16: "rt_flash_attention_bf16"}


@functools.lru_cache(maxsize=None)
def _entry(dtype):
    lib = _lib.library("flash_attention")
    fn = getattr(lib, _ENTRIES[dtype])
    fn.argtypes = [ctypes.POINTER(_Args), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


@pads_head_dim("flash_attention")
def flash_attention_cuda(q, k, v, *, window: int = 0, scale: float = 0.0,
                         softcap: float = 0.0):
    """The CUDA kernel; arguments as ``flash_attention_ref``. The output is
    a (B, Hq, S, D) view of (B, S, Hq, D)-major memory, the layout the
    attention layer consumes next. A head dim outside ``HEAD_DIMS`` runs
    as ``padded_head_dim`` says."""
    name = "flash_attention"
    if q.device.type != "cuda":
        raise ValueError(f"{name}: the CUDA kernel takes CUDA tensors, got "
                         f"{q.device}")
    for t in (q, k, v):
        if t.device != q.device:
            raise ValueError(f"{name}: all tensors must be on {q.device}")
        if t.requires_grad:
            raise ValueError(f"{name}: inference kernel, no backward")
        if t.dtype != q.dtype:
            raise TypeError(f"{name}: q/k/v dtypes differ")
        if t.dim() != 4 or t.stride(-1) != 1:
            raise ValueError(f"{name}: 4-d tensors with a contiguous head dim")
    if q.dtype not in _ENTRIES:
        raise TypeError(f"{name}: dtype {q.dtype} (float32 or bfloat16)")
    B, Hq, S, D = q.shape
    Hkv = k.shape[1]
    if tuple(k.shape) != (B, Hkv, S, D) or tuple(v.shape) != (B, Hkv, S, D):
        raise ValueError(f"{name}: k/v must be ({B}, Hkv, {S}, {D})")
    padded_head_dim(name, D)        # raises for a width no build takes
    if Hq % Hkv:
        raise ValueError(f"{name}: Hq={Hq} not a multiple of Hkv={Hkv}")
    for t, what in ((q, "q"), (k, "k"), (v, "v")):
        _lib.check_rows_aligned(name, what, t)
    out = torch.empty((B, S, Hq, D), dtype=q.dtype,
                      device=q.device).permute(0, 2, 1, 3)
    if B == 0 or S == 0:
        return out
    a = _Args(q=q.data_ptr(), k=k.data_ptr(), v=v.data_ptr(),
              out=out.data_ptr(),
              q_sb=q.stride(0), q_sh=q.stride(1), q_ss=q.stride(2),
              k_sb=k.stride(0), k_sh=k.stride(1), k_ss=k.stride(2),
              v_sb=v.stride(0), v_sh=v.stride(1), v_ss=v.stride(2),
              o_sb=out.stride(0), o_sh=out.stride(1), o_ss=out.stride(2),
              B=B, Hq=Hq, Hkv=Hkv, S=S, D=D, window=int(window),
              scale=float(scale or D ** -0.5), softcap=float(softcap))
    lib, fn = _entry(q.dtype)
    rc = fn(ctypes.byref(a), torch.cuda.current_stream(q.device).cuda_stream)
    _lib.check(rc, lib, name)
    _lib.launches[name] += 1
    return out
