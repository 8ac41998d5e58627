"""RC2F streaming FIFOs (paper §IV-D2) + shared-link contention model.

The paper's Xillybus PCIe core gives each vFPGA an in/out FIFO pair, all
sharing one 800 MB/s host link; Table II/III measure how per-core throughput
collapses as 1→2→4 cores share it. Here:

  * ``StreamFIFO`` is the host-side double-buffered queue feeding a device
    program (a producer thread copying pinned host blocks to the card on a
    side CUDA stream = the asynchronous FIFO that "divides the system clock
    from the user clock").
  * ``SharedLink`` is an accounting model of the scarce interconnect: every
    transfer reserves bandwidth over a time interval; concurrent reservations
    split it fairly. It reproduces the paper's contention numbers exactly and
    is what benchmarks/table2_shell.py and table3_matmul.py sweep.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterable, Optional

import numpy as np
import torch

from repro_torch.rc2f.core_api import resolve_device, tree_leaves, tree_map

PCIE_LINK_BYTES_S = 800e6          # paper's Xillybus limit
# H100 SXM links, one direction (NVIDIA H100 data sheet): PCIe Gen5 x16 host
# link, 128 GB/s both ways; NVLink 4 to the host's other cards, 900 GB/s
# both ways.
H100_HOST_LINK_BYTES_S = 64e9
H100_NVLINK_BYTES_S = 450e9


# ---------------------------------------------------------------------------
# Analytic shared-link model (used by benchmarks; deterministic)
# ---------------------------------------------------------------------------

@dataclass
class SharedLink:
    """Fair-share bandwidth accounting for N concurrent streams."""
    bandwidth_bytes_s: float = PCIE_LINK_BYTES_S

    def stream_time_s(self, bytes_per_stream: float, n_streams: int) -> float:
        """Wall time for n identical concurrent streams to move their bytes
        over the fair-shared link."""
        if n_streams <= 0:
            return 0.0
        return bytes_per_stream / (self.bandwidth_bytes_s / n_streams)

    def per_stream_throughput(self, n_streams: int) -> float:
        return self.bandwidth_bytes_s / max(n_streams, 1)


def core_throughput(compute_bytes_s: float, link: SharedLink,
                    n_streams: int) -> float:
    """Effective per-core streaming throughput when a compute-bound core
    (processing ``compute_bytes_s``) shares the link with n-1 peers.

    This is the paper's Table III model: min(compute rate, fair link share).
    """
    return min(compute_bytes_s, link.per_stream_throughput(n_streams))


# ---------------------------------------------------------------------------
# Host-side streaming FIFO (double-buffered prefetch)
# ---------------------------------------------------------------------------

class StreamFIFO:
    """Bounded FIFO moving host arrays to the device ahead of consumption.

    ``depth`` plays the role of the BRAM FIFO depth; a background thread
    copies each host block (an array, or a tuple/dict of them) so compute
    and transfer overlap (the asynchronous clock-domain crossing of the
    paper's design). On the card (the default; raises where CUDA is absent)
    the copy runs from pinned memory (a pinned block, e.g. a slice of a
    stream pinned once, is used as it is; another is pinned first) with
    ``non_blocking=True`` on a side CUDA stream, and an event marks it done:
    ``get`` makes the consumer's current stream wait on that event and
    records the block's tensors on that stream, so their memory is not
    reused before the consumer's work on them has run. On
    ``device="cpu"`` the blocks are handed over as CPU tensors.
    """

    def __init__(self, depth: int = 2, device="cuda"):
        self.depth = depth
        self.device = resolve_device(device)
        self._cuda = self.device.type == "cuda"
        self._side = torch.cuda.Stream(self.device) if self._cuda else None
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._closed = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.bytes_in = 0
        self.items_in = 0

    def _put_target(self, item):
        """(block on the device, event marking its copy done or None)."""
        if not self._cuda:
            return tree_map(torch.as_tensor, item), None

        def copy(x):
            host = torch.as_tensor(x)
            if not host.is_pinned():
                host = host.pin_memory()
            return host.to(self.device, non_blocking=True)

        with torch.cuda.stream(self._side):
            dev_item = tree_map(copy, item)
            done = torch.cuda.Event()
            done.record(self._side)
        return dev_item, done

    def feed(self, iterable: Iterable):
        """Start the producer thread over ``iterable``."""
        def run():
            try:
                for item in iterable:
                    if self._closed.is_set():
                        return
                    dev_item = self._put_target(item)
                    self.bytes_in += sum(
                        _host_nbytes(x) for x in tree_leaves(item))
                    self.items_in += 1
                    self._q.put(dev_item)
            except Exception as e:  # noqa: BLE001 -- re-raised by get()
                self._q.put(_Failure(e))
                return
            self._q.put(_EOS)
        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()
        return self

    def get(self, timeout: float = 60.0):
        item = self._q.get(timeout=timeout)
        if item is _EOS:
            raise StopIteration
        if isinstance(item, _Failure):
            raise RuntimeError("StreamFIFO producer failed") from item.error
        dev_item, done = item
        if done is not None:
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(done)
            for t in tree_leaves(dev_item):
                t.record_stream(consumer)
        return dev_item

    def __iter__(self):
        while True:
            try:
                yield self.get()
            except StopIteration:
                return

    def close(self):
        self._closed.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass


def _host_nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return np.asarray(x).nbytes


class _EOSType:
    pass


_EOS = _EOSType()


@dataclass
class _Failure:
    error: BaseException


class OutputFIFO:
    """Device->host result queue: blocks arrive as numpy arrays."""

    def __init__(self, depth: int = 2):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self.bytes_out = 0

    def put(self, item):
        item = tree_map(_to_numpy, item)   # blocks until ready
        self.bytes_out += sum(x.nbytes for x in tree_leaves(item))
        self._q.put(item)

    def get(self, timeout: float = 60.0):
        return self._q.get(timeout=timeout)

    def empty(self) -> bool:
        return self._q.empty()


def _to_numpy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
