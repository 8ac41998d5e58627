"""What the per-layer readers (``metrics/<name>.py``) share: each takes the
run's ``harness.Window`` and returns its number, or None where the window
holds nothing to read (no device trace, no prefill, no prompt)."""
from __future__ import annotations

from typing import Optional

from bench import roofline

# PyTorch's dtype conversions: fp32 -> bf16, fp16 and fp8 have copy kernels
# of their own; any other conversion is direct_copy_kernel_cuda run with
# casts, contiguous (loads and stores WithCast) or strided (gpu_kernel_impl,
# not gpu_kernel_impl_nocast). A copy that keeps its dtype is no cast.
CAST_KERNELS = ("bfloat16_copy_kernel_cuda", "float16_copy_kernel_cuda",
                "float8_copy_kernel_cuda")
DECODE_KERNELS = ("decode_split_kernel", "decode_merge_kernel",
                  "decode_group_kernel")
FLASH_KERNELS = ("flash_mma_kernel", "flash_tf32_kernel")


def named(parts):
    return lambda name: any(p in name for p in parts)


def is_cast(name: str) -> bool:
    """Whether a device operation converts between dtypes."""
    if any(p in name for p in CAST_KERNELS):
        return True
    return "direct_copy_kernel_cuda" in name and (
        "WithCast" in name or "gpu_kernel_impl<" in name)


def iter_ms(w) -> Optional[float]:
    """Mean host milliseconds of one ``ServingGateway.step()``."""
    if not w.steps:
        return None
    return 1e3 * sum(b - a for a, b in w.steps) / len(w.steps)


def idle_share(w) -> Optional[float]:
    """Percent of the traced window in which no device operation ran."""
    if w.device is None or not w.device.window_s:
        return None
    return 100.0 * (1.0 - w.device.busy_s / w.device.window_s)


def cast_share(w) -> Optional[float]:
    """Percent of the device's busy time spent in dtype conversions."""
    if w.device is None or not w.device.busy_s:
        return None
    return 100.0 * w.device.seconds_of(is_cast) / w.device.busy_s


def mfu(w) -> Optional[float]:
    """Percent of the bf16 peak that the model's needed operations over the
    window's seconds reach: every token decoded (its real context, one
    logits row) and every token prefilled (causal, real length)."""
    if not w.seconds:
        return None
    m = w.cfg
    window = m.get("window", 0)
    n = sum(len(r) for r in w.decode_rows) + sum(w.prefills)
    keys = sum(sum(min(c, window) if window else c for c in r)
               for r in w.decode_rows) \
        + sum(roofline.causal_keys(p, window) for p in w.prefills)
    flops = roofline.model_flops(m, n, keys,
                                 sum(len(r) for r in w.decode_rows))
    return 100.0 * flops / (w.seconds * roofline.PEAK_FLOPS["bfloat16"])


def decode_attn_roofline(w) -> Optional[float]:
    """Percent of the paged decode kernels' device time that their bound
    takes: each step's valid key rows read once (bytes) over each layer."""
    if w.device is None:
        return None
    t = w.device.seconds_of(named(DECODE_KERNELS))
    if not t:
        return None
    m, ps = w.cfg, w.engine["page_size"]
    window = m.get("window", 0)
    total = 0.0
    for rows in w.decode_rows:
        nbytes = flops = 0
        for r in rows:
            n = min(r, window) if window else r
            b, f = roofline.decode_cost(n, -(-r // ps), m["n_heads"],
                                        m["n_kv_heads"], m["head_dim"])
            nbytes += b
            flops += f
        total += roofline.bound(nbytes, flops)[0] * m["n_layers"]
    return 100.0 * total / t


def flash_roofline(w) -> Optional[float]:
    """Percent of the prefill flash kernel's device time that its bound
    takes: the causal pairs and q, k, v, out of the real prompt lengths."""
    if w.device is None or not w.prefills:
        return None
    t = w.device.seconds_of(named(FLASH_KERNELS))
    if not t:
        return None
    m = w.cfg
    total = sum(roofline.bound(*roofline.flash_cost(
        n, m["n_heads"], m["n_kv_heads"], m["head_dim"],
        m.get("window", 0)))[0] for n in w.prefills) * m["n_layers"]
    return 100.0 * total / t


def prefix_hit_share(w) -> Optional[float]:
    """Percent of the prompt tokens admitted in the window whose pages the
    prefix cache shared (page hits times the page size)."""
    if not w.prompt_tokens:
        return None
    return 100.0 * w.prefix_hit_pages * w.engine["page_size"] \
        / w.prompt_tokens
