"""Production meshes (the reference's ``launch/mesh.py``) as
``torch.distributed.device_mesh.DeviceMesh`` objects over the current
process group, and the card's roofline constants.

``make_production_mesh`` is a FUNCTION (importing this module touches no
process group): the single-pod mesh is 16×16 = 256 ranks (axes
data×model); multi-pod adds a leading "pod" axis (2×16×16 = 512 ranks).
The dry run gets those ranks from ``fake_world`` (one process, a fake
backend whose collectives move nothing); a real cluster from its launcher.
"""
from __future__ import annotations

import datetime

import numpy as np

from repro_torch.kernels import registry

# H100 SXM5 per-device roofline constants (the card's, kernels/registry.py)
PEAK_FLOPS_BF16 = registry.PEAK_FLOPS["bfloat16"]   # FLOP/s, dense bf16
HBM_BYTES_S = registry.HBM_BW                       # bytes/s
HBM_BYTES = registry.HBM_BYTES                      # bytes per device
# NVLink 4 on H100 SXM: 18 links x 25 GB/s per direction (NVIDIA H100
# datasheet); a collective whose group lies inside one 8-GPU node
NVLINK_BYTES_S = 450e9
# one NDR InfiniBand 400 Gb/s port per GPU (DGX H100 reference design); a
# collective whose group spans nodes
IB_BYTES_S = 50e9
GPUS_PER_NODE = 8


def _world():
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_initialized() else 0


def _mesh_device(device: str) -> str:
    """The mesh's device type: "cuda" unless the caller passes "cpu";
    where CUDA is absent a "cuda" mesh raises (nothing falls back)."""
    import torch
    kind = torch.device(device).type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"a mesh of {device!r} devices: cuda or cpu")
    if kind == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a cuda mesh needs a CUDA device and none is "
                           "available; pass device=\"cpu\" for a CPU mesh")
    return kind


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda"):
    from torch.distributed.device_mesh import init_device_mesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = int(np.prod(shape))
    kind = _mesh_device(device)
    have = _world()
    if have < n:
        raise RuntimeError(
            f"mesh {shape} needs {n} ranks but only {have} exist — the "
            "dry run must call fake_world(512) (or a launcher start that "
            "many ranks) before building it")
    return init_device_mesh(kind, shape, mesh_dim_names=axes)


def make_host_mesh(data: int = 1, model: int = 1, device: str = "cuda"):
    """Small (data, model) mesh over the current process group (gloo on
    the CPU, NCCL on the card) — used by tests and the local trainer. The
    mesh is on CUDA unless ``device`` is "cpu". A world of one needs no
    group from the caller: a one-rank group is made on a ``HashStore``
    (NCCL for a CUDA mesh, gloo for a CPU one)."""
    from torch.distributed.device_mesh import init_device_mesh
    kind = _mesh_device(device)
    if data * model <= 1:
        default_group(kind)
    n = max(_world(), 1)
    if data * model > n:
        raise ValueError(f"need {data * model} devices, have {n}")
    if data * model != n:
        raise ValueError(f"a ({data}, {model}) mesh over a world of {n}: "
                         "the mesh takes every rank of the group")
    return init_device_mesh(kind, (data, model),
                            mesh_dim_names=("data", "model"))


def default_group(kind: str) -> None:
    """Make sure a default process group exists: the caller's if there is
    one, else a one-rank group on a ``HashStore`` (NCCL for a "cuda" mesh,
    gloo for a "cpu" one)."""
    import torch.distributed as dist
    if not dist.is_initialized():
        dist.init_process_group("nccl" if kind == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1,
                                timeout=datetime.timedelta(seconds=120))


def chips(mesh) -> int:
    from repro_torch.runtime.sharding import axis_sizes
    return int(np.prod(list(axis_sizes(mesh).values())))


def fake_world(n: int) -> None:
    """Initialise the "fake" backend for ``n`` ranks in this process (rank
    0): collectives are accepted and move nothing, so one process holds a
    256- or 512-rank mesh of meta DTensors. For the dry run and tests
    only: ``FakeStore`` is imported from ``torch.testing._internal``, a
    path torch does not promise to keep."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == n:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
