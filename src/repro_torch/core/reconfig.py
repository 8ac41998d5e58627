"""Configuration & partial reconfiguration (paper §IV-C, Table I).

FPGA mapping:
  full configuration  (bitstream, ~29 s)  -> a shape check on meta tensors,
                                             then one warm-up run on the
                                             slice's device (loads the kernel
                                             library, surfaces a broken
                                             kernel at configure time), then,
                                             on the card, the capture of a
                                             CUDA graph (``core/graphs.py``)
  partial reconfig    (PR region, ~0.9 s) -> hot swap of a cached program
                                             into a vSlice while co-tenants run

On the card the configured program is a ``GraphProgram``: bound to its
buffers as a bitstream is bound to its region, it replays one graph a call.
On the CPU (the caller asked for it) the program runs eagerly.

The ``ProgramCache`` is the "bitfile library": keyed by (core fingerprint,
input shapes and dtypes, kernel geometry). ``configure`` populates it (slow
path); ``partial_reconfigure`` swaps a cached program into a slice (fast
path).
Latencies of both paths are what benchmarks/table1_overhead.py measures.

The cache also persists auto-tuner winners: a side store maps
(model fingerprint, device class) -> TunedConfig dict, JSON round-trippable
via ``save_tuned``/``load_tuned``, so a provider's tuned library survives
restarts the way a bitfile store would.
"""
from __future__ import annotations

import hashlib
import json
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.core.graphs import GraphProgram
from repro_torch.rc2f.core_api import (is_array, meta_inputs, resolve_device,
                                       torch_dtype, tree_leaves, tree_map)


def fingerprint(fn: Callable, static_desc: str = "") -> str:
    """Stable fingerprint of a user core (the 'bitfile hash')."""
    src = getattr(fn, "__name__", repr(fn)) + static_desc
    try:
        import inspect
        src += inspect.getsource(fn)
    except (OSError, TypeError):
        src += repr(fn)
    return hashlib.sha256(src.encode()).hexdigest()[:16]


def _aval_key(tree) -> str:
    """Key over the shapes and dtypes of the arrays in a nested
    tuple/list/dict (a numpy array and a tensor of one shape and dtype
    share it)."""
    leaves = [(tuple(x.shape), str(torch_dtype(x)).replace("torch.", ""))
              for x in tree_leaves(tree)]
    return hashlib.sha256(repr(leaves).encode()).hexdigest()[:16]


@dataclass
class ProgramEntry:
    fingerprint: str
    compiled: Any                 # the configured program: a GraphProgram
                                  # on the card, an eager callable on the CPU
    lowered_text: Optional[str]   # None: a CUDA graph keeps no text
    compile_time_s: float
    flops: float = 0.0
    bytes_accessed: float = 0.0


class ProgramCache:
    """Executable cache ≈ the provider's pre-built bitfile store (BAaaS).

    Doubly indexed: by full key (fingerprint, input avals, kernel geometry)
    for PR swaps, and by fingerprint alone for the hypervisor's execute
    path. Optionally bounded: ``max_entries`` evicts least-recently-used
    programs, the analogue of a finite on-device bitfile library.

    Kernel geometry is part of the key: a tuned program and the default
    program for the same model/avals are distinct executables and must
    never collide (the auto-tuner compiles several geometries of one
    fingerprintable core).
    """

    def __init__(self, max_entries: Optional[int] = None):
        from collections import OrderedDict
        self._lock = threading.Lock()
        self._entries: "OrderedDict[Tuple[str, str, str], ProgramEntry]" = \
            OrderedDict()
        self._by_fp: Dict[str, ProgramEntry] = {}
        self._fp_key: Dict[str, Tuple[str, str, str]] = {}
        self._tuned: Dict[Tuple[str, str], dict] = {}
        self.max_entries = max_entries
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def key(self, fp: str, example_inputs,
            geometry: str = "") -> Tuple[str, str, str]:
        return (fp, _aval_key(example_inputs), geometry)

    def get(self, key) -> Optional[ProgramEntry]:
        with self._lock:
            e = self._entries.get(key)
            if e is not None:
                self.hits += 1
                self._entries.move_to_end(key)
            else:
                self.misses += 1
            return e

    def put(self, key, entry: ProgramEntry):
        with self._lock:
            self._entries[key] = entry
            self._entries.move_to_end(key)
            self._by_fp[entry.fingerprint] = entry
            self._fp_key[entry.fingerprint] = key
            while self.max_entries is not None \
                    and len(self._entries) > self.max_entries:
                _, old = self._entries.popitem(last=False)
                self._drop_fp(old)
                _release(old)
                self.evictions += 1

    def entry_for(self, fingerprint: str) -> ProgramEntry:
        """O(1) lookup by program fingerprint (the 'bitfile hash'). Counts
        as a use for the LRU bound — a program that keeps executing stays
        resident.

        Raises KeyError if the program was evicted or never configured —
        callers holding a stale fingerprint must reconfigure.
        """
        with self._lock:
            try:
                entry = self._by_fp[fingerprint]
            except KeyError:
                raise KeyError(
                    f"program {fingerprint} evicted or never configured"
                ) from None
            self._entries.move_to_end(self._fp_key[fingerprint])
            return entry

    def evict(self, fingerprint: str) -> None:
        """Drop every entry for a fingerprint (bitfile withdrawn)."""
        with self._lock:
            for k in [k for k in self._entries if k[0] == fingerprint]:
                old = self._entries.pop(k)
                self._drop_fp(old)
                _release(old)
                self.evictions += 1

    def _drop_fp(self, entry: ProgramEntry) -> None:
        # repoint the fingerprint index at the most-recently-used surviving
        # aval-variant, or clear it when none remains
        for k in reversed(self._entries):
            if k[0] == entry.fingerprint:
                self._by_fp[entry.fingerprint] = self._entries[k]
                self._fp_key[entry.fingerprint] = k
                return
        self._by_fp.pop(entry.fingerprint, None)
        self._fp_key.pop(entry.fingerprint, None)

    def __len__(self):
        return len(self._entries)

    def programs(self) -> Dict[str, int]:
        """Graphs held, captures, replays and evictions over the cached
        programs (all zero on the CPU, where programs run eagerly)."""
        with self._lock:
            entries = list(self._entries.values())
        out = dict(graphs=0, captures=0, replays=0, evictions=0)
        for e in entries:
            counts = getattr(e.compiled, "counts", None)
            for k, v in (counts() if counts else {}).items():
                out[k] += v
        return out

    # ---------------- tuned-config store (auto-tuner winners) ------------

    def put_tuned(self, model_fp: str, device_class: str,
                  cfg: dict) -> None:
        """Persist the auto-tuner's winning geometry for a
        (model fingerprint, device class) pair."""
        with self._lock:
            self._tuned[(model_fp, device_class)] = dict(cfg)

    def get_tuned(self, model_fp: str,
                  device_class: str) -> Optional[dict]:
        with self._lock:
            rec = self._tuned.get((model_fp, device_class))
            return dict(rec) if rec is not None else None

    def tuned_configs(self) -> Dict[Tuple[str, str], dict]:
        with self._lock:
            return {k: dict(v) for k, v in self._tuned.items()}

    def save_tuned(self, path: str) -> None:
        """JSON-persist the tuned library (survives restarts like a
        provider's bitfile store)."""
        with self._lock:
            blob = {f"{fp}|{cls}": cfg
                    for (fp, cls), cfg in sorted(self._tuned.items())}
        with open(path, "w") as f:
            json.dump(blob, f, indent=2, sort_keys=True)

    def load_tuned(self, path: str) -> int:
        with open(path) as f:
            blob = json.load(f)
        with self._lock:
            for key, cfg in blob.items():
                fp, _, cls = key.partition("|")
                self._tuned[(fp, cls)] = dict(cfg)
        return len(blob)


class Reconfigurator:
    """Implements full configure vs partial reconfigure for vSlices.

    Programs run on ``device`` (the card by default; raises where CUDA is
    absent): array inputs are placed there, as a compiled JAX executable
    places its arguments."""

    def __init__(self, cache: Optional[ProgramCache] = None,
                 device="cuda"):
        # NOT `cache or ...`: an empty ProgramCache is falsy via __len__
        self.cache = cache if cache is not None else ProgramCache()
        self.device = resolve_device(device)
        self.configures = 0

    def configure(self, fn: Callable, example_inputs, *,
                  static_desc: str = "",
                  geometry: str = "") -> Tuple[ProgramEntry, float]:
        """Full configuration: a run on meta tensors of the example shapes
        (shape errors surface here, no kernel runs), then one warm-up run on
        zeros of those shapes on the device, which loads the kernel library
        the core calls. On the card the program is a ``GraphProgram``: the
        warm-up is its first call, which captures the step on the zeros
        after running it (the port's lower + compile; a step that cannot be
        captured raises ``GraphCaptureError`` here, naming the op), and is
        synchronized, so a broken kernel fails here and not at first
        execute. The capture on the zeros is dropped with them: each
        caller's buffers get their own graph at its first call.

        Returns (entry, elapsed_seconds). Cached afterwards for PR swaps.
        """
        fp = fingerprint(fn, static_desc)
        key = self.cache.key(fp, example_inputs, geometry)
        args = example_inputs if isinstance(example_inputs, tuple) \
            else (example_inputs,)
        t0 = time.perf_counter()
        fn(*meta_inputs(args))
        if self.device.type == "cuda":
            program = GraphProgram(fn, self.device)
        else:
            program = _device_program(fn, self.device)
        program(*tree_map(lambda x: torch.zeros(
            tuple(x.shape), dtype=torch_dtype(x), device=self.device)
            if is_array(x) else x, args))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            program.purge()             # the zeros are gone
        self.configures += 1
        dt = time.perf_counter() - t0
        entry = ProgramEntry(fingerprint=fp, compiled=program,
                             lowered_text=None, compile_time_s=dt)
        self.cache.put(key, entry)
        return entry, dt

    def partial_reconfigure(self, fn: Callable, example_inputs, *,
                            static_desc: str = "",
                            geometry: str = "") -> Tuple[ProgramEntry, float, bool]:
        """PR swap: reuse a cached program if present (fast; ~ms), else
        fall back to full configuration. Returns (entry, seconds, was_hit)."""
        fp = fingerprint(fn, static_desc)
        key = self.cache.key(fp, example_inputs, geometry)
        t0 = time.perf_counter()
        entry = self.cache.get(key)
        if entry is not None:
            return entry, time.perf_counter() - t0, True
        entry, dt = self.configure(fn, example_inputs, static_desc=static_desc,
                                   geometry=geometry)
        return entry, dt, False


def _release(entry: ProgramEntry) -> None:
    """Free what an evicted program holds on the card (its graphs)."""
    close = getattr(entry.compiled, "close", None)
    if close is not None:
        close()


def _device_program(fn: Callable, device: torch.device) -> Callable:
    """``fn`` with its array arguments (numpy arrays, tensors elsewhere)
    placed on ``device``; tensors already there pass through uncopied."""

    def program(*args):
        return fn(*tree_map(lambda x: torch.as_tensor(x, device=device)
                            if is_array(x) else x, args))

    program.__name__ = getattr(fn, "__name__", "program")
    return program
