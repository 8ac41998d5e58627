"""Architecture registry: ``get_config(name)`` and ``reduced(cfg)`` for smoke
tests. One module per assigned architecture lives alongside this file."""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict

from repro_torch.configs.base import ModelConfig

ARCH_IDS = (
    "gemma3-1b", "gemma2-9b", "phi3-mini-3.8b", "smollm-135m",
    "mamba2-370m", "deepseek-v2-lite-16b", "qwen3-moe-30b-a3b",
    "zamba2-7b", "whisper-tiny", "llava-next-34b",
)

_MODULES = {
    "gemma3-1b": "gemma3_1b",
    "gemma2-9b": "gemma2_9b",
    "phi3-mini-3.8b": "phi3_mini",
    "smollm-135m": "smollm_135m",
    "mamba2-370m": "mamba2_370m",
    "deepseek-v2-lite-16b": "deepseek_v2_lite",
    "qwen3-moe-30b-a3b": "qwen3_moe",
    "zamba2-7b": "zamba2_7b",
    "whisper-tiny": "whisper_tiny",
    "llava-next-34b": "llava_next_34b",
}

_cache: Dict[str, ModelConfig] = {}


def get_config(name: str) -> ModelConfig:
    if name not in _cache:
        if name not in _MODULES:
            raise KeyError(f"unknown arch {name!r}; know {sorted(_MODULES)}")
        mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
        _cache[name] = mod.config()
    return _cache[name]


def all_configs() -> Dict[str, ModelConfig]:
    return {n: get_config(n) for n in ARCH_IDS}


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests: keeps the layer pattern,
    mixer kinds and MoE/MLA/SSM structure; shrinks every dimension."""
    p = len(cfg.pattern)
    n_layers = 2 * p + 1 if p > 1 else 3
    n_kv = 1 if cfg.n_kv_heads == 1 else 2
    kw = dict(
        n_layers=n_layers, d_model=128, n_heads=4, n_kv_heads=n_kv,
        head_dim=32, d_ff=256, vocab_size=512, window=min(cfg.window, 32),
        max_seq_len=128, n_patches=min(cfg.n_patches, 16) if cfg.n_patches else 0,
    )
    if cfg.mla is not None:
        kw["mla"] = dataclasses.replace(
            cfg.mla, kv_lora_rank=64, qk_nope_head_dim=32,
            qk_rope_head_dim=16, v_head_dim=32)
    if cfg.moe is not None:
        # capacity_factor 8 -> no token drops at smoke scale, so decode and
        # full-forward outputs are exactly consistent in tests
        kw["moe"] = dataclasses.replace(
            cfg.moe, n_experts=8, top_k=2, d_expert=64, capacity_factor=8.0,
            dense_d_ff=256 if cfg.moe.first_k_dense else 0)
    if cfg.ssm is not None:
        kw["ssm"] = dataclasses.replace(
            cfg.ssm, d_state=16, head_dim=16, chunk=16)
    if cfg.encoder is not None:
        kw["encoder"] = dataclasses.replace(cfg.encoder, n_layers=2)
    return cfg.replace(**kw)
