"""RC2F user-core API (paper §IV-D/E).

A *user core* is the RAaaS tenant's compute kernel: a pure function over
input streams, declared with its stream shapes. ``compile_core`` is the HLS
analogue — it takes the user's plain Python/PyTorch function ("C function")
and produces a shell-compatible core ("RTL") with the standard FIFO
interface: f(ucs_registers, *stream_blocks) -> stream_blocks. On the card
the core is a ``GraphProgram`` (``core/graphs.py``), the counterpart of the
reference's ``jax.jit(core)``: one CUDA graph a binding of its arguments.
On the CPU it runs eagerly. The kernels it calls are the port's
(``repro_torch.kernels.ops``). The shells capture their cores themselves:
a ``FusedShell`` cycle is one graph of every resident core
(``rc2f/shell.py``).

The CUDA/OpenCL-inspired host API (paper §IV-D2) groups calls into
  (a) device control / status        -> Hypervisor.status / ConfigSpace
  (b) kernel control / reconfigure   -> deploy / swap on RAaaSSession
  (c) data transfers                 -> StreamFIFO / OutputFIFO
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class StreamSpec:
    """Declared shape/dtype of one FIFO block."""
    shape: Tuple[int, ...]
    dtype: str = "float32"

    def aval(self) -> torch.Tensor:
        """An empty meta tensor of the block's shape and dtype."""
        return torch.empty(self.shape, dtype=getattr(torch, self.dtype),
                           device="meta")


@dataclasses.dataclass(frozen=True)
class CoreSpec:
    """The user core's declared interface (the HLS pragma block)."""
    name: str
    in_streams: Tuple[StreamSpec, ...]
    out_streams: Tuple[StreamSpec, ...]
    flops_per_block: float = 0.0      # for placement/roofline accounting

    def example_inputs(self):
        return tuple(s.aval() for s in self.in_streams)


def compile_core(user_fn: Callable, spec: CoreSpec,
                 donate_inputs: bool = False, *, device="cuda") -> Callable:
    """'HLS synthesis': wrap the user function into the shell calling
    convention. The wrapped core takes (ucs, *blocks) and returns a tuple.
    On the card (the default; raises where CUDA is absent) it is a
    ``GraphProgram`` of that core, the reference's ``jax.jit(core)``:
    tensors on the card are bound by address, host arrays staged through
    pinned memory. With ``device="cpu"`` it is the eager core.

    ``donate_inputs`` mirrors the reference's ``jax.jit(donate_argnums=...)``
    option; setting it raises. Donation only lets XLA's callee reuse the
    donated buffers, and a graph program's staged buffers are its own."""
    if donate_inputs:
        raise ValueError("compile_core: donate_inputs (the reference's "
                         "jax.jit donate_argnums) has no PyTorch counterpart")
    core = shell_core(user_fn, spec)
    dev = resolve_device(device)
    if dev.type != "cuda":
        return core
    from repro_torch.core.graphs import GraphProgram
    return GraphProgram(core, dev, name=core.__name__)


def shell_core(user_fn: Callable, spec: CoreSpec) -> Callable:
    """The user function in the shell calling convention, eager."""
    wants_ucs = _wants_ucs(user_fn)

    def core(ucs: Dict[str, torch.Tensor], *blocks):
        out = user_fn(*blocks, **({"ucs": ucs} if wants_ucs else {}))
        if not isinstance(out, tuple):
            out = (out,)
        return out

    core.__name__ = f"rc2f_core_{spec.name}"
    return core


def _wants_ucs(fn: Callable) -> bool:
    import inspect
    try:
        return "ucs" in inspect.signature(fn).parameters
    except (TypeError, ValueError):
        return False


# ---------------------------------------------------------------------------
# Nested inputs (the reference walks them with jax.tree)
# ---------------------------------------------------------------------------

def tree_leaves(tree) -> list:
    """Leaves of nested tuples, lists and dicts (dict keys sorted, as
    ``jax.tree.leaves`` orders them); None is an empty subtree."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in tree_leaves(t)]
    return [] if tree is None else [tree]


def tree_map(fn: Callable, tree):
    """``fn`` applied to every leaf, the containers rebuilt."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, t) for t in tree)
    return None if tree is None else fn(tree)


def is_array(x: Any) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray))


def torch_dtype(x) -> torch.dtype:
    """The torch dtype of a tensor or numpy array."""
    if isinstance(x, torch.Tensor):
        return x.dtype
    return torch.from_numpy(np.empty((0,), x.dtype)).dtype


def meta_inputs(tree):
    """Empty meta tensors of the shapes and dtypes of the arrays in ``tree``
    (tensors on any device, numpy arrays); other leaves pass through."""
    return tree_map(lambda x: torch.empty(tuple(x.shape),
                                          dtype=torch_dtype(x),
                                          device="meta")
                    if is_array(x) else x, tree)


def resolve_device(device) -> torch.device:
    """The card unless the caller asks for the CPU; raises where CUDA is
    absent (no silent fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "on the CPU")
    return dev
