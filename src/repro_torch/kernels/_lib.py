"""Build, load and count the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface and loaded through ``ctypes``. The
build happens at first use, all sources at once (one ``nvcc`` process each,
started together), into ``kernels/_build/<hash of the sources and flags>/``
(listed in ``.gitignore``), so a fresh checkout builds everything it needs
and an edited source gets a fresh build directory. ``nvcc``'s own output,
including ``ptxas -v``'s register and spill lines, is kept beside each
library as ``<name>.log``.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent / "_build"
SOURCES = ("decode_attention", "flash_attention", "stream_matmul",
           "ssd_chunk_scan")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


class LaunchCounts(dict):
    """Kernel launches per wrapper: executions on the card. A wrapper adds
    one where it launches its kernel and nowhere else; a caller zeroes the
    counts with ``reset()`` before a run and reads them after it.

    A launch recorded while the current CUDA stream captures a graph
    executes nothing: the wrapper's increment goes to the capture's tally
    (``capture_tally()``), and each replay of that graph adds the whole
    tally (``replayed``). A wrapper called under a capture that keeps no
    tally raises, so that the counts never miss an execution."""

    def __setitem__(self, name, value):
        if _capturing():
            tally = getattr(_tallies, "open", None)
            if tally is None:
                raise RuntimeError(
                    f"{name}: a kernel launched under a CUDA graph capture "
                    "that keeps no launch tally; capture through "
                    "repro_torch.core.graphs (or _lib.capture_tally())")
            tally[name] = tally.get(name, 0) + value - self[name]
            return
        super().__setitem__(name, value)

    def reset(self) -> None:
        for name in self:
            super().__setitem__(name, 0)

    def replayed(self, tally: Dict[str, int]) -> None:
        """Add a captured graph's tally: one replay of it."""
        for name, n in tally.items():
            super().__setitem__(name, self[name] + n)


def _capturing() -> bool:
    """Whether the current CUDA stream is capturing a graph (False on a
    build or a machine without CUDA)."""
    return torch.cuda.is_available() and \
        torch.cuda.is_current_stream_capturing()


_tallies = threading.local()


@contextlib.contextmanager
def capture_tally():
    """Collect the launches the kernels record while this thread captures a
    graph; yields the tally (wrapper name -> launches a replay makes)."""
    if getattr(_tallies, "open", None) is not None:
        raise RuntimeError("capture_tally: a capture is already open on "
                           "this thread")
    _tallies.open = tally = {}
    try:
        yield tally
    finally:
        _tallies.open = None


# decode_group counts the launches of decode_attention and
# paged_decode_attention (already counted there) whose split pass was the
# group kernel.
launches = LaunchCounts(decode_attention=0, paged_decode_attention=0,
                        decode_group=0, flash_attention=0, stream_matmul=0,
                        stream_matmul_batched=0, ssd_chunk_scan=0)

# The launch plan a wrapper used on its latest launch, by wrapper name (split
# decode: (n_split, split_rows), and under "decode_group" the GroupPlan of
# the latest group launch; the 2-D stream_matmul: a MatmulPlan; the SSD: an
# SsdPlan).
last_plan: Dict[str, tuple] = {}


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def cuda_tool(tool: str = "nvcc") -> str:
    """Path of a CUDA toolkit program (nvcc, cuobjdump, cu++filt)."""
    from torch.utils.cpp_extension import CUDA_HOME
    cand = os.path.join(CUDA_HOME, "bin", tool) if CUDA_HOME else None
    if cand and os.path.exists(cand):
        return cand
    found = shutil.which(tool)
    if found is None:
        raise RuntimeError(f"{tool} not found: the CUDA kernels are built on "
                           "a machine with the CUDA toolkit")
    return found


def build() -> Dict[str, float]:
    """Compile every source missing from the build directory, all in
    parallel. Returns {"build_s": seconds spent, "built": count}."""
    out = build_dir()
    todo = [n for n in SOURCES if not (out / f"lib{n}.so").exists()]
    if not todo:
        return {"build_s": 0.0, "built": 0}
    out.mkdir(parents=True, exist_ok=True)
    nvcc = cuda_tool()
    t0 = time.monotonic()
    procs = []
    for name in todo:
        tmp = out / f"lib{name}.so.{os.getpid()}.tmp"
        log = out / f"{name}.log.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        with open(log, "w") as f:
            procs.append((name, tmp, log,
                          subprocess.Popen(cmd, stdout=f,
                                           stderr=subprocess.STDOUT)))
    failed = []
    for name, tmp, log, proc in procs:
        rc = proc.wait()
        os.replace(log, out / f"{name}.log")
        if rc != 0:
            failed.append(name)
            continue
        os.replace(tmp, out / f"lib{name}.so")   # atomic: racing builds agree
    if failed:
        logs = "\n".join((out / f"{n}.log").read_text() for n in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{logs}")
    return {"build_s": time.monotonic() - t0, "built": len(todo)}


def ptxas_table(name: str, text: str = "") -> Dict[str, Dict[str, int]]:
    """Per kernel of ``csrc/<name>.cu`` (demangled name): registers, spill
    bytes (stores + loads) and static shared memory, as ``ptxas -v``
    printed them in the build's log (or in ``text``)."""
    text = text or (build_dir() / f"{name}.log").read_text()
    table: Dict[str, Dict[str, int]] = {}
    fn = None
    for ln in text.splitlines():
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            fn = m.group(1)
            table[fn] = dict(registers=0, spill_bytes=0, smem_bytes=0)
            continue
        if fn is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            table[fn]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            table[fn]["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", ln)
            table[fn]["smem_bytes"] = int(m.group(1)) if m else 0
    names = list(table)
    try:
        pretty = subprocess.run(
            [cuda_tool("cu++filt")], input="\n".join(names),
            capture_output=True, text=True, check=True).stdout.splitlines()
    except (RuntimeError, subprocess.CalledProcessError):
        pretty = names                      # no demangler: mangled names
    return {re.sub(r"(\(anonymous namespace\)|<unnamed>)::", "", p): table[n]
            for n, p in zip(names, pretty)}


def sass_count(name: str, opcodes=("HMMA", "HGMMA")) -> Dict[str, int]:
    """How many instructions of each opcode the SASS of ``lib<name>.so``
    holds (``cuobjdump -sass``): HMMA is ``mma.sync`` on the tensor cores,
    HGMMA is ``wgmma``."""
    sass = subprocess.run(
        [cuda_tool("cuobjdump"), "-sass", str(build_dir() / f"lib{name}.so")],
        capture_output=True, text=True, check=True).stdout
    ops = re.findall(r"^\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)",
                     sass, flags=re.M)
    return {op: sum(1 for o in ops if o == op) for op in opcodes}


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build()
            lib = ctypes.CDLL(str(build_dir() / f"lib{name}.so"))
            lib.rt_error_string.argtypes = [ctypes.c_int]
            lib.rt_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def check_rows_aligned(name: str, what: str, t, nbytes: int = 16) -> None:
    """Raise unless ``t``'s rows can be read as ``nbytes``-byte vectors: the
    base and every outer stride (of a dim longer than 1) a multiple of
    ``nbytes`` bytes. The kernels that copy rows with cp.async, ldmatrix or
    vector loads need it."""
    el = t.element_size()
    if t.data_ptr() % nbytes or any(
            st * el % nbytes for st, n in zip(t.stride()[:-1], t.shape[:-1])
            if n > 1):
        raise ValueError(f"{name}: {what} rows are not {nbytes}-byte aligned "
                         f"(strides {t.stride()})")


def check(rc: int, lib: ctypes.CDLL, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if rc != 0:
        msg = lib.rt_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
