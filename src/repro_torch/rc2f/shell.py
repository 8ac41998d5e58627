"""RC2F shell: hosts up to four isolated user cores on one physical device
(paper §IV-D1, Fig. 4).

Two co-residency modes:

  * ``FusedShell`` — the analogue of N partial-reconfiguration regions inside
    one bitstream: one shell cycle runs every resident core in slot order on
    the shell's CUDA stream; they share the device's HBM bandwidth exactly
    as the paper's cores share the PCIe link. Swapping one core = rebuilding
    the cycle (the other slots' cores and registers persist).

  * ``SpatialShell`` — vSlices as disjoint sub-meshes, as the reference
    carves its device set: the ranks of the ``torch.distributed`` group are
    split into one group a slot, and ``slot_mesh`` gives each slot a
    ``DeviceMesh`` over its group (what a caller shards a slot's work
    over). With fewer ranks than slots the groups overlap, as the
    reference's do: on one card every slot's group is ``[0]``. A slot's
    core runs on the caller's device, on the slot's own CUDA stream, so
    resident cores overlap there.

Both place array inputs on the shell's device (the card unless the caller
passes ``device="cpu"``; raises where CUDA is absent). The shell also owns
the gcs and one ucs per slot; a core that takes ``ucs`` sees its registers
as int32 tensors on the device (``control.device_registers``).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.core.device_db import MAX_SLOTS
from repro_torch.launch.mesh import default_group
from repro_torch.rc2f.control import (ConfigSpace, device_registers, make_gcs,
                                      make_ucs)
from repro_torch.rc2f.core_api import (CoreSpec, compile_core, is_array,
                                       resolve_device, tree_leaves, tree_map)


@dataclasses.dataclass
class _Slot:
    core_fn: Optional[Callable] = None     # uncompiled shell-convention core
    spec: Optional[CoreSpec] = None
    ucs: Optional[ConfigSpace] = None
    user: Optional[str] = None


class FusedShell:
    """N co-resident cores run as one shell cycle sharing the device."""

    def __init__(self, n_slots: int = MAX_SLOTS, device="cuda"):
        assert 1 <= n_slots <= MAX_SLOTS
        self.n_slots = n_slots
        self.device = resolve_device(device)
        # the stream current where the shell is made runs every cycle
        self.stream = torch.cuda.current_stream(self.device) \
            if self.device.type == "cuda" else None
        self.gcs = make_gcs()
        self.slots: List[_Slot] = [_Slot() for _ in range(n_slots)]
        self._fused = None           # compiled fused program
        self._dirty = True

    # ---------------- slot management (PR regions) ----------------
    def load(self, slot: int, user_fn: Callable, spec: CoreSpec,
             user: str = "anon"):
        """Partial reconfiguration of one region: only the shell cycle is
        rebuilt; other slots' cores are untouched."""
        s = self.slots[slot]
        s.core_fn, s.spec, s.user = user_fn, spec, user
        s.ucs = make_ucs()
        self._dirty = True
        self.gcs.write("active_mask",
                       self.gcs.read("active_mask") | (1 << slot))
        self.gcs.write("clock_enable", 1)

    def unload(self, slot: int):
        self.slots[slot] = _Slot()
        self._dirty = True
        mask = self.gcs.read("active_mask") & ~(1 << slot)
        self.gcs.write("active_mask", mask)
        if mask == 0:
            self.gcs.write("clock_enable", 0)   # park: gate clocks

    def active_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s.core_fn is not None]

    # ---------------- shell cycle ----------------
    def _build(self):
        active = self.active_slots()
        fns = [compile_core(self.slots[i].core_fn, self.slots[i].spec)
               for i in active]

        def fused(reg_trees, all_blocks):
            outs = []
            for fn, regs, blocks in zip(fns, reg_trees, all_blocks):
                outs.append(fn(regs, *blocks))
            return tuple(outs)

        self._fused = fused
        self._dirty = False

    def run_cycle(self, inputs: Dict[int, Tuple]) -> Dict[int, Tuple]:
        """One shell cycle: every active core consumes one block from its
        input FIFOs. ``inputs`` maps slot -> tuple of stream blocks."""
        active = self.active_slots()
        if set(inputs) != set(active):
            raise ValueError(f"inputs for slots {sorted(inputs)} but active "
                             f"slots are {active}")
        if self._dirty:
            self._build()
        with _on_stream(self.stream):
            regs = []
            blocks = []
            for i in active:
                regs.append(device_registers(self.slots[i].ucs, self.device))
                blocks.append(_placed(inputs[i], self.device))
            outs = self._fused(regs, blocks)
        self.gcs.write("step_counter", self.gcs.read("step_counter") + 1)
        return {slot: out for slot, out in zip(active, outs)}

    # ---------------- accounting ----------------
    def shell_overhead_bytes(self) -> int:
        """Device-side footprint of the shell itself (gcs + ucs replicas +
        FIFO staging) — Table II's 'framework resources' analogue."""
        gcs_bytes = len(self.gcs.snapshot()) * 4
        ucs_bytes = sum(len(s.ucs.snapshot()) * 4 for s in self.slots
                        if s.ucs is not None)
        return gcs_bytes + ucs_bytes


class SpatialShell:
    """vSlices as disjoint sub-meshes of the process group's ranks.

    ``devices`` are ranks of the current process group (default: every
    rank of it, or ``[0]`` where there is none); slot i's group is the
    reference's ``devices[i*per:(i+1)*per]``, per = len(devices) //
    n_slots (at least 1), or one rank taken round-robin.

    ``run`` enqueues a slot's core on the slot's stream after the work the
    caller's stream has queued so far (its inputs), and returns at once.
    ``join`` makes the caller's stream wait for every slot, after which the
    outputs may be read there."""

    def __init__(self, devices: Optional[Sequence[int]] = None,
                 n_slots: int = MAX_SLOTS, device="cuda"):
        self.device = resolve_device(device)
        if devices is None:
            devices = range(dist.get_world_size()) \
                if dist.is_initialized() else [0]
        self.devices = [int(r) for r in devices]
        self.n_slots = n_slots
        self.gcs = make_gcs()
        per = max(1, len(self.devices) // n_slots)
        self._groups = [self.devices[i * per:(i + 1) * per] or
                        [self.devices[i % len(self.devices)]]
                        for i in range(n_slots)]
        self._meshes: Dict[str, List[DeviceMesh]] = {}
        self._streams = [torch.cuda.Stream(self.device)
                         if self.device.type == "cuda" else None
                         for _ in range(n_slots)]
        self.slots: List[_Slot] = [_Slot() for _ in range(n_slots)]
        self._compiled: Dict[int, Callable] = {}

    def slot_mesh(self, slot: int, axis: str = "slice") -> DeviceMesh:
        """A one-dim ``DeviceMesh`` of the shell's device type over slot
        ``slot``'s group of ranks. Building a mesh over a subset of ranks
        is collective (``new_group``), so the first call for an ``axis``
        builds every slot's mesh at once, in slot order, and every rank
        of the default group must make it; where no group exists yet a
        one-rank group is made first."""
        if axis not in self._meshes:
            default_group(self.device.type)
            self._meshes[axis] = [
                DeviceMesh(self.device.type, torch.tensor(g),
                           mesh_dim_names=(axis,)) for g in self._groups]
        return self._meshes[axis][slot]

    def load(self, slot: int, user_fn: Callable, spec: CoreSpec,
             user: str = "anon"):
        s = self.slots[slot]
        s.core_fn, s.spec, s.user = user_fn, spec, user
        s.ucs = make_ucs()
        core = compile_core(user_fn, spec)
        self._compiled[slot] = core
        self.gcs.write("active_mask",
                       self.gcs.read("active_mask") | (1 << slot))

    def run(self, slot: int, *blocks):
        s = self.slots[slot]
        stream = self._streams[slot]
        regs = device_registers(s.ucs, self.device)
        blocks = _placed(blocks, self.device)
        if stream is None:
            return self._compiled[slot](regs, *blocks)
        caller = torch.cuda.current_stream(self.device)
        stream.wait_stream(caller)
        with torch.cuda.stream(stream):
            out = self._compiled[slot](regs, *blocks)
        for t in _tensors((regs, blocks)):
            t.record_stream(stream)      # read on the slot's stream
        for t in _tensors(out):
            t.record_stream(caller)      # read on the caller's after join
        return out

    def join(self):
        """Make the caller's current stream wait for every slot's work."""
        if self.device.type == "cuda":
            caller = torch.cuda.current_stream(self.device)
            for stream in self._streams:
                caller.wait_stream(stream)


def _placed(blocks, device):
    """Array leaves as tensors on ``device`` (no copy if already there)."""
    return tree_map(lambda x: torch.as_tensor(x, device=device)
                    if is_array(x) else x, blocks)


def _tensors(tree):
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _on_stream(stream):
    return torch.cuda.stream(stream) if stream is not None \
        else contextlib.nullcontext()
