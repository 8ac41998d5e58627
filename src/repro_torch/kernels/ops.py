"""Kernel dispatch by the tensors' device: a CUDA tensor launches the
hand-written kernel (or the wrapper raises on what the kernel does not
take); a CPU tensor takes the kernel's plain PyTorch version. A meta tensor
also takes the plain version, which computes nothing there and returns an
empty meta tensor of the output's shape and dtype (admission's shape check,
``rc2f.admission.admit_core``). Any other device raises. There is no
fallback from one to the other.

No kernel here defines a backward, and neither does any Pallas kernel of
the reference. A CUDA dispatch that would record an autograd graph (grad
mode on and an input that requires grad) raises ``RuntimeError``: the
kernels are launched on raw pointers, so their outputs would have no
``grad_fn`` and every parameter upstream would silently get no gradient.
The layers take their plain paths under a recorded graph instead (the
einsum attention, ``layers.ssm.ssd_scan``)."""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor

from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import mamba2_chunk as _ssd
from repro_torch.kernels import stream_matmul as _mm


def _on_cuda(t, name: str, *inputs) -> bool:
    """True where ``t`` (the first input) asks for the CUDA kernel;
    ``inputs``: every tensor argument, checked for autograd there. A
    DTensor is refused on any device: a kernel takes local shards, handed
    to it inside a ``local_map`` region (``runtime.sharding``), and is
    never given a DTensor to unwrap."""
    # only raises: a DTensor is refused, never sent elsewhere
    if any(isinstance(x, DTensor)  # rc3e: allow-ops-dispatch
           for x in (t,) + inputs):
        raise TypeError(f"{name}: a DTensor input; the kernels take local "
                        "shards (call them inside a local_map region)")
    if t.device.type == "cuda":
        # only raises: an autograd input is refused, never sent elsewhere
        if torch.is_grad_enabled() and any(  # rc3e: allow-ops-dispatch
                x is not None and x.requires_grad for x in (t,) + inputs):
            raise RuntimeError(
                f"{name}: the CUDA kernel defines no backward (nor does the "
                "reference's kernel), so its output would cut the autograd "
                "graph; run under torch.no_grad(), or take the plain path "
                "(kernel_force='ref': the einsum attention, "
                "layers.ssm.ssd_scan)")
        return True
    if t.device.type in ("cpu", "meta"):
        return False
    raise ValueError(f"{name}: no kernel for device {t.device}")


def matmul(a, b):
    """(M, K) @ (K, N), fp32 accumulation, output in a's dtype."""
    fn = _mm.stream_matmul_cuda if _on_cuda(a, "matmul", b) \
        else _mm.matmul_ref
    return fn(a, b)


def matmul_batched(a, b):
    """(G, M, K) @ (G, K, N): the streaming core's G-block of products."""
    fn = _mm.stream_matmul_batched_cuda if _on_cuda(a, "matmul_batched", b) \
        else _mm.matmul_batched_ref
    return fn(a, b)


def decode_attention(q, k, v, kpos, cur, *, window: int = 0,
                     scale: float = 0.0, k_scale=None, v_scale=None,
                     return_lse: bool = False):
    fn = _da.decode_attention_cuda \
        if _on_cuda(q, "decode_attention", k, v, k_scale, v_scale) \
        else _da.decode_attention_ref
    return fn(q, k, v, kpos, cur, window=window, scale=scale,
              k_scale=k_scale, v_scale=v_scale, return_lse=return_lse)


def paged_decode_attention(q, k_pool, v_pool, kpos_pool, block_tables, cur,
                           *, window: int = 0, scale: float = 0.0,
                           k_scale=None, v_scale=None):
    fn = _da.paged_decode_attention_cuda \
        if _on_cuda(q, "paged_decode_attention", k_pool, v_pool,
                    k_scale, v_scale) \
        else _da.paged_decode_attention_ref
    return fn(q, k_pool, v_pool, kpos_pool, block_tables, cur, window=window,
              scale=scale, k_scale=k_scale, v_scale=v_scale)


def flash_attention(q, k, v, *, window: int = 0, scale: float = 0.0,
                    softcap: float = 0.0):
    fn = _fa.flash_attention_cuda if _on_cuda(q, "flash_attention", k, v) \
        else _fa.flash_attention_ref
    return fn(q, k, v, window=window, scale=scale, softcap=softcap)


def ssd_chunk_scan(x, dt, Bm, Cm, a, d, chunk: int = 256):
    """The reference's signature: x (BH, S, P); dt (BH, S); Bm/Cm
    (BH, S, N); a/d (BH,). Returns y (BH, S, P) in x's dtype."""
    if _on_cuda(x, "ssd_chunk_scan", dt, Bm, Cm, a, d):
        return _ssd.ssd_chunk_scan_cuda(x, dt, Bm, Cm, a, d, chunk=chunk)
    return _ssd.ssd_chunk_scan_ref(x, dt, Bm, Cm, a, d)


def ssd(xs, dt, A, Bm, Cm, D, *, init_state=None, chunk: int = 256):
    """The same scan in the Mamba2 layer's layout: xs (B, S, H, P); dt
    (B, S, H) fp32; Bm/Cm (B, S, G, N); A/D (H,) fp32; init_state
    (B, H, P, N) fp32 or None. Returns (y (B, S, H, P), final state
    (B, H, P, N) fp32)."""
    if _on_cuda(xs, "ssd", dt, A, Bm, Cm, D, init_state):
        return _ssd.ssd_cuda(xs, dt, A, Bm, Cm, D, init_state, chunk=chunk)
    return _ssd.ssd_ref(xs, dt, A, Bm, Cm, D, init_state)
