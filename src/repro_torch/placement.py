"""DTensor placement helpers: the partition-spec type ``P``, the mesh
description the sharding rules read, and what turns specs into DTensor
placements on a ``torch.distributed.device_mesh.DeviceMesh``.

``runtime.sharding`` holds the reference's rules over these and re-exports
them. They live apart so that the layers can import them when they are
imported: ``runtime`` imports the models, which import the layers.

``named`` turns specs into placements and ``place`` distributes a tree by
them; ``constrain`` is ``with_sharding_constraint``; ``local_region`` runs
a function on each rank's local shards (``local_map``), which is how the
kernels, the cache writes and the ops DTensor has no rule for see a mesh.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor._utils import (
    compute_local_shape_and_global_offset)
from torch.distributed.tensor.experimental import local_map

from repro_torch.tree import tree_map


class P(tuple):
    """Partition spec: one entry per tensor dim, each ``None``, a mesh axis
    name, or a tuple of names (one dim over several mesh axes, in mesh
    order). ``P()`` is a scalar's; missing trailing entries are ``None``."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return "P(" + ", ".join(repr(p) for p in self) + ")"


def is_spec(x) -> bool:
    return isinstance(x, P)


class MeshShape:
    """A mesh's axis names and sizes without devices (what the rules
    read): ``MeshShape({"data": 16, "model": 16})``."""

    def __init__(self, shape: Dict[str, int]):
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)


def axis_names(mesh) -> Tuple[str, ...]:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def axis_sizes(mesh) -> Dict[str, int]:
    if isinstance(getattr(mesh, "shape", None), dict):
        return dict(mesh.shape)
    return {a: int(mesh.size(i)) for i, a in enumerate(axis_names(mesh))}


def dp_axes(mesh):
    names = axis_names(mesh)
    axes = tuple(a for a in ("pod", "data") if a in names)
    return axes if len(axes) > 1 else (axes[0] if axes else None)


def _axis_size(mesh, name: str) -> int:
    return axis_sizes(mesh).get(name, 1)


def _div(n: int, mesh, axis: str = "model") -> bool:
    return _axis_size(mesh, axis) > 1 and n % _axis_size(mesh, axis) == 0


def _none(r: int) -> P:
    return P(*([None] * r))


def _dp_size(mesh) -> int:
    return _axis_size(mesh, "pod") * _axis_size(mesh, "data")


# ---------------------------------------------------------------------------
# Placements on a DeviceMesh
# ---------------------------------------------------------------------------

def placements(mesh, spec: P):
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(i)`` on each
    mesh dim that tensor dim ``i`` names, else ``Replicate()``. A dim over
    two mesh dims (("pod", "data")) is sharded in mesh order, as a JAX
    ``NamedSharding`` lays it out."""
    names = axis_names(mesh)
    out = [Replicate() for _ in names]
    for i, part in enumerate(spec):
        for a in (part if isinstance(part, tuple) else (part,)):
            if a is not None and a in names:   # a hint's missing axis: none
                out[names.index(a)] = Shard(i)
    return tuple(out)


class NamedSharding:
    """A spec on a mesh (the reference's ``NamedSharding``): ``mesh``,
    ``spec`` and its DTensor ``placements``."""

    def __init__(self, mesh, spec: P):
        self.mesh = mesh
        self.spec = P(*spec)
        self.placements = placements(mesh, spec)

    def __repr__(self):
        return f"NamedSharding({self.spec!r})"


def named(mesh, spec_tree):
    """Spec tree -> tree of ``NamedSharding`` on ``mesh``."""
    return tree_map(lambda s: NamedSharding(mesh, s), spec_tree,
                    is_leaf=is_spec)


def _is_sharding(x) -> bool:
    return is_spec(x) or isinstance(x, NamedSharding)


def _full(t):
    return t.full_tensor() if isinstance(t, DTensor) else t


def place(tree, mesh, spec_tree):
    """Distribute each leaf of ``tree`` by its spec on ``mesh`` (or by a
    ``NamedSharding``, on its own mesh). Every rank holds the same full
    value (a seeded state, the same global batch, a restored checkpoint),
    so each rank cuts its own shard and nothing is scattered. A DTensor is
    gathered first (the elastic path), a numpy leaf becomes a tensor, and
    every leaf lands on the mesh's device (a meta leaf stays meta)."""

    def one(t, s):
        m, pl = (s.mesh, s.placements) if isinstance(s, NamedSharding) \
            else (mesh, placements(mesh, s))
        t = _full(t) if isinstance(t, torch.Tensor) \
            else torch.from_numpy(np.asarray(t))
        return distribute_tensor(t, m, list(pl), src_data_rank=None)
    return tree_map(one, tree, spec_tree, is_leaf=_is_sharding)


def constrain(t, spec, mesh=None):
    """``with_sharding_constraint``: redistribute a DTensor to ``spec`` on
    ``mesh`` (its own mesh when None). Axes the mesh lacks are dropped
    from the spec. A plain tensor is returned unchanged (no mesh: the
    reference's hints fall back the same way on one device)."""
    if not isinstance(t, DTensor):
        return t
    mesh = mesh if mesh is not None else t.device_mesh
    pl = placements(mesh, spec)
    if tuple(t.placements) == pl:
        return t
    return t.redistribute(mesh, pl)


def dp_spec_for(t, n: int):
    """The dp-axes entry of a spec for a dim of size ``n`` of ``t`` on its
    mesh: the dp axes where their product divides ``n``, else None (also
    for a plain tensor)."""
    if not isinstance(t, DTensor):
        return None
    mesh = t.device_mesh
    dp = dp_axes(mesh)
    return dp if dp is not None and n % _dp_size(mesh) == 0 else None


def local_region(fn, mesh, in_specs, out_specs):
    """``fn`` as a local region on ``mesh`` (``local_map``): each DTensor
    argument is redistributed to its spec in ``in_specs`` (None: not a
    tensor) and ``fn`` runs on the local shards; its outputs become
    DTensors by ``out_specs`` (one spec, or a tuple of specs)."""

    def pl(s):    # a list: local_map reads a tuple as one entry an output
        return None if s is None else list(placements(mesh, s))
    outs = pl(out_specs) if out_specs is None or is_spec(out_specs) \
        else tuple(pl(s) for s in out_specs)
    ins = tuple(pl(s) for s in in_specs)
    # the mesh dims the region splits its work over; an input replicated
    # on one of them contributes to each rank's piece only, so its
    # gradient is partial there (a replicated weight of a batch-split
    # region sums its gradient over the batch shards)
    split = {i for p in ins + (() if outs is None else (
        (outs,) if is_spec(out_specs) else outs)) if p is not None
        for i, x in enumerate(p) if isinstance(x, Shard)}
    grads = tuple(None if p is None else [
        Partial() if i in split and isinstance(x, Replicate) else x
        for i, x in enumerate(p)] for p in ins)
    mapped = local_map(fn, out_placements=outs, in_placements=ins,
                       in_grad_placements=grads, device_mesh=mesh,
                       redistribute_inputs=True)
    rep = [Replicate()] * len(axis_names(mesh))

    def run(*args):
        # a plain tensor made inside the model is replicated (as
        # implicit_replication takes it), then cut to its spec
        args = [DTensor.from_local(a, mesh, rep, run_check=False)
                if s is not None and not isinstance(a, DTensor)
                and hasattr(a, "ndim") else a
                for a, s in zip(args, in_specs)]
        return mapped(*args)
    return run


def spec_of(t) -> P:
    """The spec of a DTensor's placements (the inverse of
    ``placements``): each tensor dim names the mesh axes that shard it, in
    mesh order. A plain tensor's spec is all None."""
    if not isinstance(t, DTensor):
        return _none(t.ndim)
    names = axis_names(t.device_mesh)
    parts = [[] for _ in range(t.ndim)]
    for a, pl in zip(names, t.placements):
        if isinstance(pl, Shard):
            parts[pl.dim].append(a)
    return P(*[None if not x else (x[0] if len(x) == 1 else tuple(x))
               for x in parts])


def local_offset(t, dim: int) -> int:
    """This rank's offset of its shard of DTensor ``t`` along ``dim``."""
    _, off = compute_local_shape_and_global_offset(
        t.shape, t.device_mesh, t.placements)
    return int(off[dim])
