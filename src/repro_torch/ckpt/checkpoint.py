"""Checkpointing: atomic save/restore with keep-k retention and optional
async save (the reference's ``ckpt/checkpoint.py``, same layout on disk).

Layout:  <dir>/step_<N>/
           manifest.json   (treedef, shapes, dtypes, step, extra metadata)
           leaf_<i>.npy    (one file per leaf, copied to the host)
         <dir>/step_<N>.tmp/ -> atomic rename on completion.

Leaves are numbered in the reference's order (``repro_torch.tree``: dict
keys sorted, tuples in order), so a port checkpoint and a reference
checkpoint of the same state hold the same ``leaf_<i>.npy``. The manifest's
``treedef`` is the port's own description (the reference writes JAX's).
A bfloat16 leaf is stored as its raw 16-bit words (numpy has no bfloat16)
and its manifest dtype says "bfloat16".

A DTensor state (a mesh step's) is saved as its full leaves: every rank
calls ``save`` (the gather is a collective) and rank 0 writes, so the
files are those of a one-device save. ``restore(shardings=...)`` places
each leaf on a ``DeviceMesh`` by a placements tree (``sharding.named``)
and ``reshard`` moves a state onto another mesh: the elastic grow/shrink
path.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.placement import NamedSharding, _full, place
from repro_torch.tree import describe, flatten, unflatten

MANIFEST = "manifest.json"


def _step_dir(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:08d}")


def _dtype_name(t) -> str:
    if isinstance(t, torch.Tensor):
        return str(t.dtype).replace("torch.", "")
    return str(np.asarray(t).dtype)


def _writes() -> bool:
    """Rank 0 of a process group (or a process without one) writes."""
    import torch.distributed as dist
    return not dist.is_initialized() or dist.get_rank() == 0


def _to_numpy(t) -> np.ndarray:
    if not isinstance(t, torch.Tensor):
        return np.asarray(t)
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def save(state, directory: str, step: int, keep: int = 3,
         extra: Optional[dict] = None) -> str:
    """Atomic synchronous save. Returns the final path."""
    final = _step_dir(directory, step)
    leaves, spec = flatten(state)
    leaves = [_full(l) for l in leaves]       # a DTensor: every rank gathers
    if not _writes():
        return final
    os.makedirs(directory, exist_ok=True)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {
        "step": step,
        "n_leaves": len(leaves),
        "treedef": describe(spec),
        "shapes": [list(np.shape(l)) for l in leaves],
        "dtypes": [_dtype_name(l) for l in leaves],
        "extra": extra or {},
    }
    for i, leaf in enumerate(leaves):
        np.save(os.path.join(tmp, f"leaf_{i}.npy"), _to_numpy(leaf))
    with open(os.path.join(tmp, MANIFEST), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _retain(directory, keep)
    return final


def save_async(state, directory: str, step: int, keep: int = 3,
               extra: Optional[dict] = None) -> threading.Thread:
    """Snapshot to host memory synchronously (cheap), write in background.
    bfloat16 leaves are snapshotted as bfloat16 tensors on the host."""
    leaves, spec = flatten(state)
    host = unflatten(spec, [_full(l).detach().to("cpu", copy=True)
                            if isinstance(l, torch.Tensor) else np.asarray(l)
                            for l in leaves])
    t = threading.Thread(target=save,
                         args=(host, directory, step, keep, extra),
                         daemon=True)
    t.start()
    return t


def _retain(directory: str, keep: int):
    steps = available_steps(directory)
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(_step_dir(directory, s), ignore_errors=True)


def available_steps(directory: str) -> List[int]:
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(directory, name, MANIFEST)):
                out.append(int(name[5:]))
    return sorted(out)


def latest_step(directory: str) -> Optional[int]:
    steps = available_steps(directory)
    return steps[-1] if steps else None


def restore(directory: str, like, step: Optional[int] = None,
            shardings=None, device=None) -> Tuple[Any, int]:
    """Restore into the structure of ``like`` (a state tree; its leaves may
    be ``meta`` tensors). Each leaf lands on ``device``, or where its
    ``like`` leaf lives when ``device`` is None (a ``meta`` leaf then needs
    ``device``). ``shardings``: a matching tree of ``NamedSharding``
    (``sharding.named(mesh, specs)``); each leaf is then distributed on
    its mesh by its placements (the elastic remesh path). Returns (state,
    step)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    path = _step_dir(directory, step)
    with open(os.path.join(path, MANIFEST)) as f:
        manifest = json.load(f)
    leaves_like, spec = flatten(like)
    if manifest["n_leaves"] != len(leaves_like):
        raise ValueError(
            f"checkpoint has {manifest['n_leaves']} leaves, expected "
            f"{len(leaves_like)} — architecture mismatch")
    shard_leaves = None
    if shardings is not None:
        shard_leaves = flatten(shardings, lambda x: isinstance(
            x, NamedSharding))[0]
    out = []
    for i, ref in enumerate(leaves_like):
        arr = np.load(os.path.join(path, f"leaf_{i}.npy"))
        if tuple(arr.shape) != tuple(np.shape(ref)):
            raise ValueError(f"leaf {i}: shape {arr.shape} != "
                             f"{tuple(np.shape(ref))}")
        t = torch.from_numpy(arr)
        if manifest["dtypes"][i] == "bfloat16":
            t = t.view(torch.bfloat16)
        if shard_leaves is not None:           # every rank read the file
            shd = shard_leaves[i]
            out.append(place(t if device is None else t.to(device),
                             shd.mesh, shd.spec))
            continue
        dev = device if device is not None else getattr(ref, "device", "cpu")
        if torch.device(dev).type == "meta":
            raise ValueError(f"leaf {i}: its like leaf is on the meta "
                             "device; pass device=")
        out.append(t.to(dev))
    return unflatten(spec, out), step


def reshard(state, mesh, spec_tree):
    """Move a (host, device or DTensor) state onto ``mesh`` with
    ``spec_tree`` specs — the elastic grow/shrink primitive: ``place``,
    which gathers a DTensor leaf first (``full_tensor``), then distributes
    it (``distribute_tensor``)."""
    return place(state, mesh, spec_tree)
