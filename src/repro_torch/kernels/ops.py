"""Kernel dispatch by the tensors' device: a CUDA tensor launches the
hand-written kernel (or the wrapper raises on what the kernel does not
take); a CPU tensor takes the kernel's plain PyTorch version. There is no
fallback from one to the other."""
from __future__ import annotations

from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import flash_attention as _fa


def _on_cuda(t, name: str) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{name}: no kernel for device {t.device}")


def decode_attention(q, k, v, kpos, cur, *, window: int = 0,
                     scale: float = 0.0, k_scale=None, v_scale=None):
    fn = _da.decode_attention_cuda if _on_cuda(q, "decode_attention") \
        else _da.decode_attention_ref
    return fn(q, k, v, kpos, cur, window=window, scale=scale,
              k_scale=k_scale, v_scale=v_scale)


def paged_decode_attention(q, k_pool, v_pool, kpos_pool, block_tables, cur,
                           *, window: int = 0, scale: float = 0.0,
                           k_scale=None, v_scale=None):
    fn = _da.paged_decode_attention_cuda \
        if _on_cuda(q, "paged_decode_attention") \
        else _da.paged_decode_attention_ref
    return fn(q, k_pool, v_pool, kpos_pool, block_tables, cur, window=window,
              scale=scale, k_scale=k_scale, v_scale=v_scale)


def flash_attention(q, k, v, *, window: int = 0, scale: float = 0.0,
                    softcap: float = 0.0):
    fn = _fa.flash_attention_cuda if _on_cuda(q, "flash_attention") \
        else _fa.flash_attention_ref
    return fn(q, k, v, window=window, scale=scale, softcap=softcap)
