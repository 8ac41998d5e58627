"""The yardstick's arithmetic, frozen here: the card's published peaks,
the bound of a piece of work, and the operations and bytes that the
served model's work needs from its inputs.

``bound`` and ``decode_cost`` are copied from ``chip_smoke.py``, the peaks
from ``repro_torch.kernels.registry``. Every count is of what the
algorithm needs for the real tokens: valid key rows each read once, the
causal pairs of the real prompt (not its padded bucket), the top-k
experts a token is routed to (not every expert a batched product runs).
So a later change that drops padding or unused experts raises a share,
and no share can pass 100% unless a count or a kernel time is wrong.
"""
from __future__ import annotations

from typing import Tuple

# NVIDIA H100 SXM data sheet, dense, at the full 700 W power limit
HBM_BW = 3.35e12                       # bytes/s
PEAK_FLOPS = {"bfloat16": 989e12, "tf32": 495e12, "float32": 67e12}


def bound(nbytes: float, flops: float, dtype: str = "bfloat16"
          ) -> Tuple[float, str]:
    """The least seconds the work could take, and what bounds it."""
    t_b = nbytes / HBM_BW
    t_o = flops / PEAK_FLOPS[dtype]
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def decode_cost(n_valid: int, n_blocks: int, hq: int, hkv: int, d: int,
                kvbytes: int = 2, qbytes: int = 2) -> Tuple[int, int]:
    """Bytes and operations of one row's decode attention in one layer:
    q read and the output written, the row's position, its block-table
    entries, and ``n_valid`` key and value rows (with their positions)
    each read once; 2 * 2 * d operations a head a key (scores and the
    weighted sum)."""
    nbytes = (2 * hq * d * qbytes + 4 + n_blocks * 4
              + n_valid * (hkv * d * kvbytes * 2 + 4))
    return nbytes, 4 * d * hq * n_valid


def flash_cost(n: int, hq: int, hkv: int, d: int, window: int = 0,
               nbytes_el: int = 2) -> Tuple[int, int]:
    """Bytes and operations of one causal prefill's attention in one layer
    over ``n`` real tokens: q, k, v read once and the output written; the
    causal (and windowed) query-key pairs, 4 * d operations a pair a
    head."""
    pairs = causal_keys(n, window)
    nbytes = (2 * hq + 2 * hkv) * n * d * nbytes_el
    return nbytes, 4 * d * hq * pairs


def layer_flops_per_token(m: dict) -> int:
    """Operations of one token through one layer's projections: q, k, v,
    o; the dense MLP's three products, or the router and the top-k
    experts' three products (shared experts counted too)."""
    d, hq, hkv, hd = m["d_model"], m["n_heads"], m["n_kv_heads"], \
        m["head_dim"]
    attn = 2 * d * hd * (2 * hq + 2 * hkv)
    moe = m.get("moe")
    if moe:
        e = moe["d_expert"]
        mlp = 2 * d * moe["n_experts"] + 2 * 3 * d * e * (
            moe["top_k"] + moe.get("n_shared", 0))
    else:
        mlp = 2 * 3 * d * m["d_ff"]
    return attn + mlp


def causal_keys(n: int, window: int = 0) -> int:
    """Keys the ``n`` tokens of a causal prefill attend to, in all."""
    if window and window < n:
        return window * (window + 1) // 2 + (n - window) * window
    return n * (n + 1) // 2


def model_flops(m: dict, n_tokens: int, key_rows: int,
                logits_rows: int) -> int:
    """Operations the model needs for ``n_tokens`` tokens that attend to
    ``key_rows`` keys in all (itself included for each; each layer alike),
    plus ``logits_rows`` rows of the vocabulary projection."""
    per_layer = layer_flops_per_token(m) * n_tokens \
        + 4 * m["head_dim"] * m["n_heads"] * key_rows
    return per_layer * m["n_layers"] + 2 * m["d_model"] * m["vocab_size"] \
        * logits_rows
