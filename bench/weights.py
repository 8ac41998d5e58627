"""The served model's weights, made by the benchmark from the run's seed.

The port's ``Model(cfg, device="meta").init(None)`` gives the tree of
shapes the program reads its weights in (the layout both the program and
the plain reference read, as they would read one checkpoint file). The
values are the benchmark's own: one fp32 buffer on the card, filled by a
CUDA ``torch.Generator`` seeded with the run's seed in one call, and cut
into the leaves (each aligned to 256 bytes), which are then scaled in
place: N(0, fan_in^-0.5) for a projection, an expert, the router, the
embedding and the head; N(0, 0.1) for an RMSNorm's offset (the port
stores w - 1).
"""
from __future__ import annotations

from typing import Any, List, Tuple

import torch

ALIGN = 64          # elements: 256 bytes of fp32
_NORMS = ("norm1", "norm2", "final_norm", "q_norm", "k_norm",
          "norm1_post", "norm2_post")


def _walk(tree, path=()) -> List[Tuple[tuple, Any]]:
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _walk(v, path + (k,))]
    if isinstance(tree, (tuple, list)):
        return [x for i, v in enumerate(tree) for x in _walk(v, path + (i,))]
    return [(path, tree)]


def _rebuild(tree, it):
    if isinstance(tree, dict):
        return {k: _rebuild(v, it) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(v, it) for v in tree)
    return next(it)


def scale_of(path: tuple, shape: tuple) -> float:
    """A leaf's standard deviation, by its name (the path's last string).
    A leaf under ``stages`` stacks layers on dim 0, which is not part of
    its fan-in."""
    name = [p for p in path if isinstance(p, str)][-1]
    if name in _NORMS:
        return 0.1
    dims = shape[1:] if "stages" in path else shape
    if name == "tok":                        # (V, d)
        fan_in = dims[-1]
    elif name == "wo":                       # (kv, g, hd, d)
        fan_in = 1
        for n in dims[:-1]:
            fan_in *= n
    elif len(dims) == 3 and name in ("wg", "wu", "wd"):
        fan_in = dims[1]                     # experts (E, d_in, d_out)
    else:                                    # (d_in, ...)
        fan_in = dims[0]
    return float(fan_in) ** -0.5


def make_weights(model, seed: int):
    """The weights of ``model`` (a port ``Model``) drawn from ``seed`` on
    its device, in the program's tree, fp32 (the port's ``param_dtype``)."""
    from repro_torch.models.api import Model     # the program's tree
    shapes = Model(model.cfg, device="meta").init(None)
    leaves = _walk(shapes)
    sizes = [t.numel() for _, t in leaves]
    offs, total = [], 0
    for n in sizes:
        offs.append(total)
        total += -(-n // ALIGN) * ALIGN
    dtype = getattr(torch, model.cfg.param_dtype)
    gen = torch.Generator(device=model.dev).manual_seed(int(seed))
    flat = torch.empty((total,), dtype=dtype, device=model.dev)
    flat.normal_(generator=gen)
    out = []
    for (path, meta), off, n in zip(leaves, offs, sizes):
        leaf = flat[off:off + n].view(tuple(meta.shape))
        leaf.mul_(scale_of(path, tuple(meta.shape)))
        out.append(leaf)
    return _rebuild(shapes, iter(out))
