"""RC2F configuration spaces (paper §IV-D1).

gcs — global configuration space: hypervisor-owned status/control registers
      of the shell (one per physical device).
ucs — user configuration space: per-vSlice user-defined command registers
      (the dual-port memory between host API and user core).

Registers live host-side as plain dicts (control plane) and are *threaded
through the step function* as a dict of int32 tensors on the shell's device
when a core wants on-device access (e.g. step counters, soft-reset flags) —
mirroring the paper's "accessible from the host through the API and on the
FPGA via dedicated control signals".

A shell keeps each slot's registers in a ``RegisterFile``: one fixed int32
buffer on the device whose views are the dict a core sees, so that a
captured shell cycle reads them at fixed addresses; the buffer is uploaded
only when the ucs was written since its last upload.
``device_registers`` lowers a config space into fresh tensors for callers
outside the shells.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Tuple

import torch

GCS_FIELDS = ("magic", "version", "n_slots", "active_mask", "soft_reset",
              "clock_enable", "step_counter", "error_flags")
UCS_SIZE = 16   # user-definable command registers per slice


class ConfigSpace:
    """Thread-safe register file with read/write latency accounting."""

    def __init__(self, fields, name: str):
        self._regs: Dict[str, int] = {f: 0 for f in fields}
        self._lock = threading.Lock()
        self.name = name
        self.reads = 0
        self.writes = 0

    def read(self, reg: str) -> int:
        with self._lock:
            self.reads += 1
            return self._regs[reg]

    def write(self, reg: str, value: int):
        with self._lock:
            if reg not in self._regs:
                raise KeyError(f"{self.name}: no register {reg!r}")
            self.writes += 1
            self._regs[reg] = int(value)

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._regs)

    def versioned(self) -> Tuple[int, Dict[str, int]]:
        """(writes so far, snapshot), read together."""
        with self._lock:
            return self.writes, dict(self._regs)


def make_gcs() -> ConfigSpace:
    gcs = ConfigSpace(GCS_FIELDS, "gcs")
    gcs.write("magic", 0x5C3E)
    gcs.write("version", 2)
    gcs.write("n_slots", 4)
    gcs.write("clock_enable", 0)   # parked: clocks gated (energy policy)
    return gcs


def make_ucs() -> ConfigSpace:
    return ConfigSpace([f"r{i}" for i in range(UCS_SIZE)], "ucs")


def device_registers(gcs: ConfigSpace, device) -> Dict[str, torch.Tensor]:
    """Lower a config space into int32 scalar tensors on ``device``
    (threaded through step fns): one host-to-device copy, one view each.
    On the card the copy leaves pinned memory without blocking: a copy
    from pageable memory would wait for the device, a host sync in every
    shell cycle."""
    snap = gcs.snapshot()
    vals = torch.tensor(list(snap.values()), dtype=torch.int32)
    if torch.device(device).type == "cuda":
        vals = vals.pin_memory().to(device, non_blocking=True)
    return dict(zip(snap, vals.unbind()))


class RegisterFile:
    """A config space's registers as one fixed int32 buffer on ``device``.
    ``views`` maps each register to a 0-d view of the buffer: the dict a
    core sees, at the same addresses every cycle. ``refresh`` uploads the
    registers on the current stream when the config space was written
    since the last upload; on the card the copy leaves a pinned host
    mirror without blocking, and the mirror is rewritten only once its
    last copy has landed."""

    def __init__(self, cs: ConfigSpace, device):
        self.cs = cs
        self.device = torch.device(device)
        names = list(cs.snapshot())
        self.buf = torch.zeros(len(names), dtype=torch.int32,
                               device=self.device)
        self.views: Dict[str, torch.Tensor] = dict(zip(names,
                                                       self.buf.unbind()))
        cuda = self.device.type == "cuda"
        self._host = torch.zeros(len(names), dtype=torch.int32,
                                 pin_memory=True) if cuda else self.buf
        self._copied = torch.cuda.Event() if cuda else None
        self._version = None
        self.uploads = 0

    def refresh(self) -> bool:
        """Upload the registers if the config space changed; whether it
        did."""
        version, snap = self.cs.versioned()
        if version == self._version:
            return False
        if self._copied is not None:
            self._copied.synchronize()      # the last upload has landed
        self._host.numpy()[:] = list(snap.values())
        if self._copied is not None:
            self.buf.copy_(self._host, non_blocking=True)
            self._copied.record(torch.cuda.current_stream(self.device))
        self._version = version
        self.uploads += 1
        return True
