"""RC3E device database (paper §IV-B).

Tracks nodes, physical accelerator meshes and vSlices with allocation state,
exactly as the paper's hypervisor database tracks nodes / FPGAs / vFPGAs.
Pure control plane: no torch imports, fully unit-testable, persistable to JSON.

Energy policy (paper: "minimize the number of active vFPGAs and maximize the
utilization of physical FPGAs"): physical devices with no allocated slices are
PARKED (clock-gated in the paper); the allocator packs new slices onto already
ACTIVE devices first.
"""
from __future__ import annotations

import dataclasses
import enum
import json
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.analysis.lifecycle import sanitizer

MAX_SLOTS = 4  # paper: up to four vFPGAs per physical device


class DeviceState(str, enum.Enum):
    PARKED = "parked"          # no tenants; clocks gated (paper energy policy)
    ACTIVE = "active"          # >=1 vSlice allocated
    EXCLUSIVE = "exclusive"    # RSaaS: whole device allocated to one user
    DRAINING = "draining"      # being vacated (maintenance / elastic shrink)
    DEAD = "dead"              # failed node


class SliceState(str, enum.Enum):
    FREE = "free"
    ALLOCATED = "allocated"    # owned by a tenant, no program loaded
    CONFIGURED = "configured"  # program (executable) loaded
    RUNNING = "running"
    MIGRATING = "migrating"


@dataclass
class VSlice:
    slice_id: str
    device_id: str
    slots: int                         # 1, 2 or 4 of the device's 4 slots
    state: SliceState = SliceState.FREE
    owner: Optional[str] = None
    service_model: Optional[str] = None   # rsaas | raas | baas
    program: Optional[str] = None         # executable fingerprint
    step_times_ms: List[float] = field(default_factory=list)
    # device-memory dimension: KV-cache pool pages granted to this slice
    # (0 = unmetered/dense). Compute (slots) and memory (pages) are
    # virtualized separately, so a small-compute long-context tenant is
    # expressible — and accountable.
    cache_pages: int = 0


@dataclass
class PhysicalDevice:
    device_id: str
    node_id: str
    chips: int                         # e.g. 64 chips per vSlice-slot group
    state: DeviceState = DeviceState.PARKED
    slices: Dict[str, VSlice] = field(default_factory=dict)
    cache_pages: int = 0               # pool pages this device's HBM holds
    # relative power draw while un-parked (PARKED = clock-gated = free).
    # Heterogeneous fleets give device classes different draws; the energy
    # metric (device-steps x draw) and the scale-in policy ("park the
    # power-hungry devices first") both read it.
    draw: float = 1.0
    # relative dataplane speed: the event-driven loop steps this device's
    # engine every ``tick_s / speed`` event-seconds, so a slow device
    # class (speed < 1) decodes on its own cadence instead of gating the
    # whole fleet behind a lockstep barrier. The lockstep loop ignores it
    # (every engine steps once per round, the round costs the slowest
    # member's period).
    speed: float = 1.0

    def used_slots(self) -> int:
        return sum(s.slots for s in self.slices.values()
                   if s.state != SliceState.FREE)

    def free_slots(self) -> int:
        return MAX_SLOTS - self.used_slots()

    def granted_cache_pages(self) -> int:
        return sum(s.cache_pages for s in self.slices.values()
                   if s.state != SliceState.FREE)


@dataclass
class Node:
    node_id: str
    devices: List[str] = field(default_factory=list)
    alive: bool = True
    last_heartbeat: float = 0.0


class DeviceDB:
    """Thread-safe in-memory DB with JSON persistence."""

    def __init__(self):
        self._lock = threading.RLock()
        self.nodes: Dict[str, Node] = {}
        self.devices: Dict[str, PhysicalDevice] = {}
        self._slice_counter = 0
        self._san = sanitizer.scope()    # device-machine key namespace

    # ---------------- topology ----------------
    def add_node(self, node_id: str) -> Node:
        with self._lock:
            if node_id in self.nodes:
                raise ValueError(f"node {node_id} exists")
            n = Node(node_id)
            self.nodes[node_id] = n
            return n

    def add_device(self, device_id: str, node_id: str, chips: int = 256,
                   cache_pages: int = 0, draw: float = 1.0,
                   speed: float = 1.0):
        with self._lock:
            if device_id in self.devices:
                raise ValueError(f"device {device_id} exists")
            if node_id not in self.nodes:
                raise KeyError(f"no node {node_id}")
            d = PhysicalDevice(device_id, node_id, chips,
                               cache_pages=cache_pages, draw=draw,
                               speed=speed)
            self.devices[device_id] = d
            self.nodes[node_id].devices.append(device_id)
            return d

    # ---------------- queries ----------------
    def device(self, device_id: str) -> PhysicalDevice:
        return self.devices[device_id]

    def find_slice(self, slice_id: str) -> VSlice:
        for d in self.devices.values():
            if slice_id in d.slices:
                return d.slices[slice_id]
        raise KeyError(f"no slice {slice_id}")

    def slices_of(self, owner: str) -> List[VSlice]:
        return [s for d in self.devices.values() for s in d.slices.values()
                if s.owner == owner]

    def utilization(self) -> Dict[str, float]:
        """Fraction of slots in use per device (paper's monitoring view)."""
        return {d.device_id: d.used_slots() / MAX_SLOTS
                for d in self.devices.values()}

    def page_grants(self) -> Dict[str, float]:
        """Fraction of each metered device's page pool granted to slices
        (the memory-dimension twin of ``utilization``)."""
        return {d.device_id: d.granted_cache_pages() / d.cache_pages
                for d in self.devices.values() if d.cache_pages}

    def active_draw(self) -> float:
        """Aggregate power draw of every un-parked, alive device this
        instant. PARKED devices are clock-gated (paper's energy policy)
        and DEAD ones draw nothing; everything else — ACTIVE, EXCLUSIVE,
        DRAINING — burns its class draw. The scale harness integrates this
        over fleet steps into the energy metric (device-steps x draw)."""
        with self._lock:
            return sum(d.draw for d in self.devices.values()
                       if d.state not in (DeviceState.PARKED,
                                          DeviceState.DEAD)
                       and self.nodes[d.node_id].alive)

    # ---------------- allocation ----------------
    def _alive_devices(self):
        return [d for d in self.devices.values()
                if d.state not in (DeviceState.DEAD, DeviceState.DRAINING)
                and self.nodes[d.node_id].alive]

    def alive_devices(self) -> List[PhysicalDevice]:
        """Schedulable devices (not DEAD/DRAINING, node alive) — the public
        view for policy code (elastic controller, batch scheduler)."""
        with self._lock:
            return self._alive_devices()

    def idle_devices(self) -> List[PhysicalDevice]:
        """PARKED, empty, alive devices (by id): wake candidates for
        elastic scale-out and the RSaaS exclusive allocator."""
        with self._lock:
            return sorted((d for d in self._alive_devices()
                           if d.state == DeviceState.PARKED and not d.slices),
                          key=lambda d: d.device_id)

    def allocate_slice(self, owner: str, slots: int, service_model: str,
                       device_id: Optional[str] = None,
                       exclude_device: Optional[str] = None,
                       cache_pages: int = 0) -> VSlice:
        """Pack-first placement (energy policy): prefer ACTIVE devices with
        the least free slots that still fit, park-wake only if needed.
        ``exclude_device`` supports straggler migration (must move away).
        ``cache_pages`` grants the slice a share of the device's KV page
        pool; a device whose pool is fully granted no longer fits
        page-bearing slices even when it has free compute slots."""
        if slots not in (1, 2, 4):
            raise ValueError("slots must be 1, 2 or 4")
        with self._lock:
            cands = self._alive_devices()
            if device_id is not None:
                cands = [d for d in cands if d.device_id == device_id]
            if exclude_device is not None:
                cands = [d for d in cands if d.device_id != exclude_device]
            cands = [d for d in cands
                     if d.state != DeviceState.EXCLUSIVE
                     and d.free_slots() >= slots
                     and (not cache_pages or not d.cache_pages
                          or d.granted_cache_pages() + cache_pages
                          <= d.cache_pages)]
            if not cands:
                raise NoCapacityError(
                    f"no device with {slots} free slots"
                    + (f" and {cache_pages} free cache pages"
                       if cache_pages else ""))
            # pack-first: fewest free slots among ACTIVE, then PARKED
            cands.sort(key=lambda d: (d.state != DeviceState.ACTIVE,
                                      d.free_slots(), d.device_id))
            dev = cands[0]
            self._slice_counter += 1
            vs = VSlice(f"vs-{self._slice_counter:05d}", dev.device_id, slots,
                        SliceState.ALLOCATED, owner, service_model,
                        cache_pages=cache_pages)
            dev.slices[vs.slice_id] = vs
            sanitizer.emit("device", (self._san, dev.device_id), "activate")
            dev.state = DeviceState.ACTIVE
            return vs

    def allocate_exclusive(self, owner: str,
                           device_id: Optional[str] = None) -> PhysicalDevice:
        """RSaaS: whole physical device (marked separately, paper §IV-B)."""
        with self._lock:
            cands = self.idle_devices()
            if device_id is not None:
                cands = [d for d in cands if d.device_id == device_id]
            if not cands:
                raise NoCapacityError("no idle physical device")
            dev = cands[0]
            sanitizer.emit("device", (self._san, dev.device_id), "exclusive")
            dev.state = DeviceState.EXCLUSIVE
            self._slice_counter += 1
            vs = VSlice(f"vs-{self._slice_counter:05d}", dev.device_id,
                        MAX_SLOTS, SliceState.ALLOCATED, owner, "rsaas")
            dev.slices[vs.slice_id] = vs
            return dev

    def release(self, slice_id: str):
        with self._lock:
            vs = self.find_slice(slice_id)
            dev = self.devices[vs.device_id]
            del dev.slices[slice_id]
            if not dev.slices:
                sanitizer.emit("device", (self._san, dev.device_id), "park")
                dev.state = DeviceState.PARKED   # energy policy: gate clocks

    def set_slice_state(self, slice_id: str, state: SliceState,
                        program: Optional[str] = None):
        with self._lock:
            vs = self.find_slice(slice_id)
            vs.state = state
            if program is not None:
                vs.program = program

    # ---------------- failure handling ----------------
    def mark_node_dead(self, node_id: str) -> List[VSlice]:
        """Returns the orphaned slices that need re-placement."""
        with self._lock:
            node = self.nodes[node_id]
            node.alive = False
            orphans = []
            for did in node.devices:
                orphans.extend(self._kill_device(self.devices[did]))
            return orphans

    def mark_device_dead(self, device_id: str) -> List[VSlice]:
        """Device-granular failure (the node survives): one accelerator
        dropped off the bus / failed its status read. Returns the orphaned
        slices that need re-placement."""
        with self._lock:
            return self._kill_device(self.devices[device_id])

    def _kill_device(self, dev: PhysicalDevice) -> List[VSlice]:
        if dev.state != DeviceState.DEAD:
            # guard: a node kill sweeps every device on the node, some of
            # which may already be individually dead — DEAD is sticky and
            # re-killing a dead device is not a lifecycle event
            sanitizer.emit("device", (self._san, dev.device_id), "kill")
        dev.state = DeviceState.DEAD
        orphans = list(dev.slices.values())
        dev.slices = {}
        return orphans

    # ---------------- persistence ----------------
    def to_json(self) -> str:
        with self._lock:
            def enc(o):
                if isinstance(o, enum.Enum):
                    return o.value
                if dataclasses.is_dataclass(o):
                    return dataclasses.asdict(o)
                raise TypeError(type(o))
            return json.dumps({
                "nodes": {k: dataclasses.asdict(v)
                          for k, v in self.nodes.items()},
                "devices": {k: dataclasses.asdict(v)
                            for k, v in self.devices.items()},
                "slice_counter": self._slice_counter,
            }, default=enc, indent=1)

    @classmethod
    def from_json(cls, text: str) -> "DeviceDB":
        raw = json.loads(text)
        db = cls()
        for k, v in raw["nodes"].items():
            db.nodes[k] = Node(**v)
        for k, v in raw["devices"].items():
            slices = {sk: VSlice(**{**sv, "state": SliceState(sv["state"])})
                      for sk, sv in v.pop("slices").items()}
            d = PhysicalDevice(**{**v, "state": DeviceState(v["state"]),
                                  "slices": slices})
            db.devices[k] = d
        db._slice_counter = raw["slice_counter"]
        return db


class NoCapacityError(RuntimeError):
    pass
