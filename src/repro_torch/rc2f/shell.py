"""RC2F shell: hosts up to four isolated user cores on one physical device
(paper §IV-D1, Fig. 4).

Two co-residency modes:

  * ``FusedShell`` — the analogue of N partial-reconfiguration regions inside
    one bitstream: one program runs every resident core each shell cycle,
    in slot order on the shell's CUDA stream; they share the device's HBM
    bandwidth exactly as the paper's cores share the PCIe link. On the card
    the cycle is one ``GraphProgram`` (``core/graphs.py``): one CUDA graph
    of every resident core a block shape, the reference's compiled fused
    program. Swapping one core = capturing the cycle anew (the old graphs
    and their pool are dropped; the other slots' cores, buffers and
    registers persist).

  * ``SpatialShell`` — vSlices as disjoint sub-meshes, as the reference
    carves its device set: the ranks of the ``torch.distributed`` group are
    split into one group a slot, and ``slot_mesh`` gives each slot a
    ``DeviceMesh`` over its group (what a caller shards a slot's work
    over). With fewer ranks than slots the groups overlap, as the
    reference's do: on one card every slot's group is ``[0]``. Each slot
    has its own executable: on the card a ``GraphProgram`` of its core
    (``compile_core``), replayed on the slot's own CUDA stream, so resident
    cores overlap there.

A graph binds addresses, so each slot owns fixed block buffers, one set a
signature of its blocks (tree structure, shapes, dtypes), and its registers
as one fixed int32 buffer (``control.RegisterFile``, uploaded only when the
slot's ucs was written). A cycle copies each slot's blocks into its buffers
on the stream that runs it (a tensor on the card device to device, a host
array through pinned memory), refreshes the registers, runs the program,
and returns copies of the outputs, as the reference returns fresh arrays.
The CPU runs the same binding eagerly. A core that cannot be captured
raises ``GraphCaptureError`` naming its line at its first cycle, and the
program refuses every later cycle: nothing runs it eagerly.

Both place array inputs on the shell's device (the card unless the caller
passes ``device="cpu"``; raises where CUDA is absent). The shell also owns
the gcs and one ucs per slot. A configured ``GraphProgram`` handed to
``load`` contributes its step function to the shell's program.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.core.device_db import MAX_SLOTS
from repro_torch.core.graphs import GraphProgram, flatten, rebuild
from repro_torch.launch.mesh import default_group
from repro_torch.rc2f.control import (ConfigSpace, RegisterFile, make_gcs,
                                      make_ucs)
from repro_torch.rc2f.core_api import (CoreSpec, compile_core, is_array,
                                       resolve_device, shell_core,
                                       torch_dtype, tree_map)


@dataclasses.dataclass
class _Slot:
    core_fn: Optional[Callable] = None     # the user function, uncompiled
    spec: Optional[CoreSpec] = None
    ucs: Optional[ConfigSpace] = None
    user: Optional[str] = None
    regs: Optional[RegisterFile] = None    # made on the slot's stream
    blocks: Optional["_Blocks"] = None


def _loaded(user_fn: Callable, spec: CoreSpec, user: str,
            device: torch.device) -> _Slot:
    """A slot holding ``user_fn`` (a configured program's step function)."""
    if isinstance(user_fn, GraphProgram):
        user_fn = user_fn.fn
    return _Slot(core_fn=user_fn, spec=spec, ucs=make_ucs(), user=user,
                 blocks=_Blocks(device))


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
        self.program: Optional[Callable] = None   # the cycle's program
        self.bound: Optional[tuple] = None        # its last arguments
        self._dirty = True
        self._counts = _GraphCounts()

    # ---------------- slot management (PR regions) ----------------
    def load(self, slot: int, user_fn: Callable, spec: CoreSpec,
             user: str = "anon"):
        """Partial reconfiguration of one region: only the shell cycle is
        captured anew; other slots' cores are untouched."""
        self.slots[slot] = _loaded(user_fn, spec, user, self.device)
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
        self._counts.close(self.program)
        self.program = self.bound = None
        active = self.active_slots()
        fns = [shell_core(self.slots[i].core_fn, self.slots[i].spec)
               for i in active]

        def fused(reg_trees, all_blocks):
            outs = []
            for fn, regs, blocks in zip(fns, reg_trees, all_blocks):
                outs.append(fn(regs, *blocks))
            return tuple(outs)

        fused.__name__ = "rc2f_cycle_" + "_".join(
            f"{i}{self.slots[i].spec.name}" for i in active)
        if active:
            self.program = GraphProgram(fused, self.device, fused.__name__) \
                if self.device.type == "cuda" else fused
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
        outs = ()
        if active:
            with _ordered(self.stream, self.device) as caller:
                regs, blocks = [], []
                for i in active:
                    s = self.slots[i]
                    regs.append(_registers(s, self.device).views)
                    blocks.append(s.blocks.fill(inputs[i], caller))
                self.bound = (tuple(regs), tuple(blocks))
                outs = _copies(self.program(*self.bound), caller)
            if caller is not None:      # the outputs are read there
                caller.wait_stream(self.stream)
        self.gcs.write("step_counter", self.gcs.read("step_counter") + 1)
        return {slot: out for slot, out in zip(active, outs)}

    def counts(self) -> dict:
        """Captures, replays, capture ms and graph bytes of every cycle
        program this shell has run (none on the CPU)."""
        return self._counts.total(self.program)

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
    caller's stream has queued so far (its inputs), and returns at once
    with copies of its outputs. ``join`` makes the caller's stream wait for
    every slot, after which the outputs may be read there."""

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
        self._counts = _GraphCounts()

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
        self.slots[slot] = s = _loaded(user_fn, spec, user, self.device)
        self._counts.close(self._compiled.get(slot))
        self._compiled[slot] = compile_core(s.core_fn, spec,
                                            device=self.device)
        self.gcs.write("active_mask",
                       self.gcs.read("active_mask") | (1 << slot))

    def run(self, slot: int, *blocks):
        s = self.slots[slot]
        with _ordered(self._streams[slot], self.device) as caller:
            bound = s.blocks.fill(blocks, caller)
            return _copies(self._compiled[slot](
                _registers(s, self.device).views, *bound), caller)

    def join(self):
        """Make the caller's current stream wait for every slot's work."""
        if self.device.type == "cuda":
            caller = torch.cuda.current_stream(self.device)
            for stream in self._streams:
                caller.wait_stream(stream)

    def counts(self) -> dict:
        """Captures, replays, capture ms and graph bytes of every slot's
        program this shell has run (none on the CPU)."""
        return self._counts.total(*self._compiled.values())


# ---------------------------------------------------------------------------
# The binding: fixed buffers, copies in and out, stream order
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _BlockSet:
    tree: tuple                     # the blocks' tree over the buffers
    bufs: List[Optional[torch.Tensor]]   # a buffer an array leaf
    pinned: List[Optional[torch.Tensor]]  # a host leaf's staging mirror
    copied: Optional[torch.cuda.Event] = None   # after the staged copies


class _Blocks:
    """A slot's fixed block buffers on ``device``, one set a signature of
    its blocks: the tree's structure, each array leaf's shape and dtype,
    any other leaf's value."""

    def __init__(self, device: torch.device):
        self.device = device
        self.sets: Dict[tuple, _BlockSet] = {}

    def fill(self, blocks, caller) -> tuple:
        """Copy ``blocks`` into their set's buffers on the current stream
        and return the set's tree. ``caller``: the stream that made the
        blocks where it is not the current one (each is then kept from
        reuse until the copy has read it), else None."""
        leaves, spec = [], []
        flatten(tuple(blocks), leaves, spec)
        sig = (tuple(spec), tuple(
            (tuple(x.shape), torch_dtype(x)) if is_array(x)
            else ("value", type(x), x) for x in leaves))
        got = self.sets.get(sig)
        if got is None:
            bufs = [torch.empty(tuple(x.shape), dtype=torch_dtype(x),
                                device=self.device) if is_array(x) else None
                    for x in leaves]
            got = self.sets[sig] = _BlockSet(
                tree=rebuild(tuple(blocks), [b if b is not None else x
                                             for b, x in zip(bufs, leaves)]),
                bufs=bufs, pinned=[None] * len(leaves))
        staged = False
        for k, (buf, x) in enumerate(zip(got.bufs, leaves)):
            if buf is None:
                continue
            if isinstance(x, torch.Tensor) and x.device.type == "cuda":
                buf.copy_(x, non_blocking=True)
                if caller is not None:
                    x.record_stream(torch.cuda.current_stream(self.device))
                continue
            src = torch.from_numpy(np.ascontiguousarray(x)) \
                if isinstance(x, np.ndarray) else x
            if self.device.type != "cuda":
                buf.copy_(src)
                continue
            if not staged and got.copied is not None:
                got.copied.synchronize()    # the last staged copies landed
            staged = True
            if got.pinned[k] is None:
                got.pinned[k] = torch.empty(tuple(x.shape), dtype=buf.dtype,
                                            pin_memory=True)
            got.pinned[k].copy_(src)
            buf.copy_(got.pinned[k], non_blocking=True)
        if staged:
            if got.copied is None:
                got.copied = torch.cuda.Event()
            got.copied.record(torch.cuda.current_stream(self.device))
        return got.tree


def _registers(s: _Slot, device: torch.device) -> RegisterFile:
    """The slot's register file, made at its first use (on the stream that
    runs the slot) and refreshed."""
    if s.regs is None:
        s.regs = RegisterFile(s.ucs, device)
    s.regs.refresh()
    return s.regs


def _copies(outs, caller):
    """The outputs as tensors the caller keeps (a replay rewrites a graph's
    outputs; an output may be a block buffer), made on the current stream
    and kept from reuse until ``caller``'s work on them has run."""
    def copy(x):
        if not isinstance(x, torch.Tensor):
            return x
        y = x.clone()
        if caller is not None:
            y.record_stream(caller)
        return y
    return tree_map(copy, outs)


@contextlib.contextmanager
def _ordered(stream, device):
    """Run on ``stream`` after the work the caller's current stream has
    queued so far; yields the caller's stream where it differs from
    ``stream`` (None on the CPU or the same stream). The caller's stream
    does not wait for ``stream``'s work here."""
    if stream is None:
        yield None
        return
    caller = torch.cuda.current_stream(device)
    if caller == stream:
        yield None
        return
    stream.wait_stream(caller)
    with torch.cuda.stream(stream):
        yield caller


class _GraphCounts:
    """A shell's graph counts over the programs it has closed and those it
    holds."""

    def __init__(self):
        self._closed = dict(captures=0, replays=0, capture_ms=[],
                            graph_bytes=[])

    def close(self, program) -> None:
        """Add a program's counts and drop its graphs and their pool."""
        if isinstance(program, GraphProgram):
            self._add(self._closed, program)
            program.close()

    def total(self, *programs) -> dict:
        out = {k: list(v) if isinstance(v, list) else v
               for k, v in self._closed.items()}
        for p in programs:
            if isinstance(p, GraphProgram):
                self._add(out, p)
        return out

    @staticmethod
    def _add(into: dict, p: GraphProgram) -> None:
        into["captures"] += p.captures
        into["replays"] += p.replays
        into["capture_ms"] += p.capture_ms
        into["graph_bytes"] += p.graph_bytes
