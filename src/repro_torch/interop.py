"""Carry the JAX package's parameters into the port.

``params_from_numpy`` takes the reference's parameter pytree with every leaf
already converted to a numpy array (``jax.tree.map(np.asarray, params)`` on
the JAX side, so this module needs no JAX) and returns the port's parameter
tree: the same nesting of dicts and tuples, leaves as tensors in the
config's ``param_dtype`` on ``device``, except an SSM block's ``A_log``,
``dt_bias`` and ``D`` and an MoE layer's ``router``, which stay float32
whatever ``param_dtype`` is (as the reference's ``init_ssm`` and
``init_moe`` make them). Caches are not carried across; each engine builds
its own.

``train_state_from_numpy`` carries a whole train state the same way (the
reference's ``{params, opt_state: {mu, nu, count}, step[, residuals]}``,
leaves as numpy arrays): the params as above, the AdamW moments and the
error-feedback residuals in float32, ``count`` and ``step`` as 0-d int32
tensors. A checkpoint or a mid-run state of either package can then be
held against the other's leaf by leaf.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


SSM_FP32_LEAVES = ("A_log", "dt_bias", "D")
MOE_FP32_LEAVES = ("router",)


def params_from_numpy(tree, cfg: ModelConfig, device="cpu"):
    dtype = getattr(torch, cfg.param_dtype)

    def conv(node, path=()):
        if isinstance(node, dict):
            return {k: conv(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, (tuple, list)):
            return tuple(conv(v, path) for v in node)
        arr = np.ascontiguousarray(node)
        if arr.dtype.kind != "f":
            raise TypeError(f"parameter leaf of dtype {arr.dtype}")
        fp32 = (path[-2:-1] == ("ssm",) and path[-1] in SSM_FP32_LEAVES) \
            or (path[-2:-1] == ("moe",) and path[-1] in MOE_FP32_LEAVES)
        return torch.from_numpy(arr.astype(np.float32)).to(
            device=device, dtype=torch.float32 if fp32 else dtype)

    return conv(tree)


def train_state_from_numpy(tree, cfg: ModelConfig, device="cpu"):
    def f32(sub):
        if isinstance(sub, dict):
            return {k: f32(v) for k, v in sub.items()}
        if isinstance(sub, (tuple, list)):
            return tuple(f32(v) for v in sub)
        return torch.from_numpy(np.array(sub, np.float32)).to(device)

    def i32(x):
        return torch.from_numpy(np.array(x, np.int32)).to(device)

    opt = tree["opt_state"]
    state = {"params": params_from_numpy(tree["params"], cfg, device),
             "opt_state": {"mu": f32(opt["mu"]), "nu": f32(opt["nu"]),
                           "count": i32(opt["count"])},
             "step": i32(tree["step"])}
    if "residuals" in tree:
        state["residuals"] = f32(tree["residuals"])
    return state
