"""Carry the JAX package's parameters into the port.

``params_from_numpy`` takes the reference's parameter pytree with every leaf
already converted to a numpy array (``jax.tree.map(np.asarray, params)`` on
the JAX side, so this module needs no JAX) and returns the port's parameter
tree: the same nesting of dicts and tuples, leaves as tensors in the
config's ``param_dtype`` on ``device``. Caches are not carried across; each
engine builds its own.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


def params_from_numpy(tree, cfg: ModelConfig, device="cpu"):
    dtype = getattr(torch, cfg.param_dtype)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (tuple, list)):
            return tuple(conv(v) for v in node)
        arr = np.ascontiguousarray(node)
        if arr.dtype.kind != "f":
            raise TypeError(f"parameter leaf of dtype {arr.dtype}")
        return torch.from_numpy(arr.astype(np.float32)).to(device=device,
                                                           dtype=dtype)

    return conv(tree)
