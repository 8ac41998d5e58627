"""Capture and replay of a step as CUDA graphs: the port's counterpart of
the reference's compiled executables (``jax.jit``, ``lower().compile()``).
It has no module in the reference.

An XLA executable is bound to the shapes of its arguments; a CUDA graph is
bound to their addresses. A ``GraphProgram`` wraps a step function and
keeps one graph for each binding of its arguments:

* a tensor on the program's device is bound by address (weights, caches,
  an engine's step buffers); the caller updates its contents in place;
* a host array (a numpy array, or a tensor on another device) is staged:
  copied, through pinned host memory, into a buffer the program owns;
* a DTensor (a mesh step's parameters, caches or state) is bound by its
  local shard, the tensor that holds its storage on this rank: the key
  has the shard's address, shape, strides and dtype, and the DTensor's
  mesh, placements and global shape and stride (``Placed``);
* any other leaf (a number, a string, None) is part of the key by value.

The key is the arguments' tree structure, the shape, strides and dtype of
every array, the address of every bound tensor, and whether deterministic
algorithms are on (a graph captured with them off would replay its
kernels unchanged after they were switched on). A call with a key not
seen yet runs the step eagerly (the call's real execution, and the warm-up
of whatever it loads), then captures it on the same buffers; capture
executes nothing, so no data moves twice. Later calls with that key copy
the staged inputs in and replay. The graphs of one program share a memory
pool. A graph is dropped once a tensor it is bound to is freed, and
``close`` drops them all (the program cache calls it when it evicts the
program). With ``max_graphs`` a program keeps at most that many graphs:
a capture past the cap drops the least recently called one (counted in
``evictions``), whose key captures again at its next call.

A replay rewrites the graph's outputs in place: what a call returns stays
valid until the program's next replay (``fresh`` returns copies). An
output that is one of the call's own tensors (a cache written in place,
a training state's leaf), or a DTensor whose local shard is one of theirs,
is returned as the caller's tensor. Any other DTensor output is kept as
its local shard, in the graph's pool, and rebuilt as a DTensor of its
placements after each replay (``Placed.wrap``): a replay runs no Python,
so no DTensor dispatch, sharding propagation or collective is paid on
the host after the capture.

A step must be capturable: no host sync (``.item()``, ``.cpu()``,
``torch.cuda.synchronize()``) and no upload from pageable memory
(``torch.tensor(..., device="cuda")``). A step that is not raises
``GraphCaptureError`` naming the source line of the op, and the program
refuses every later call: nothing runs the step eagerly after a capture
failed.

``then(program, post)`` is a program followed by ``post`` on its outputs,
captured as one graph (the serving engine's decode step and its argmax):
callers that bind one program share the chained program, so each caller's
buffers get one graph of it, in the program's pool.

The kernel wrappers' launch counts stay counts of executions: a capture
keeps the tally of the launches it recorded (``_lib.capture_tally``), and
each replay adds it (``_lib.launches.replayed``).

With the span recorder on (``core/spans.py``) a call records the spans
``<span>.bind`` (its arguments flattened and keyed), ``<span>.stage``
(host arrays copied in), ``<span>.replay`` (with a pair of timing events
around the replay) or ``<span>.capture`` (a first call's eager run and
capture); ``span`` is the program's name unless given.
"""
from __future__ import annotations

import dataclasses
import gc
import os
import threading
import time
import traceback
import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch.core.spans import recorder
from repro_torch.kernels import _lib

_TORCH_DIR = os.path.dirname(torch.__file__)
_streams: Dict[torch.device, Any] = {}
_streams_lock = threading.Lock()


class GraphCaptureError(RuntimeError):
    """A step that cannot be captured as a CUDA graph."""


class _Pool:
    """The memory pool that the graphs of a program, and of the programs
    chained to it, share. The allocator frees a pool with its last graph,
    and a capture into a freed pool's handle fails: once no graph of the
    pool lives, the next capture takes a new handle."""

    def __init__(self):
        self.handle = None
        self.live = 0

    def get(self):
        if self.handle is None:
            self.handle = torch.cuda.graph_pool_handle()
        return self.handle

    def dropped(self, n: int = 1) -> None:
        self.live -= n
        if self.live == 0:
            self.handle = None


@dataclasses.dataclass(frozen=True)
class _Arg:
    """An output that is the call's own leaf ``index``."""
    index: int


@dataclasses.dataclass(frozen=True)
class Placed:
    """What makes a DTensor of a local shard: its mesh, placements and
    global shape and stride."""
    mesh: Any
    placements: tuple
    shape: tuple
    stride: tuple

    @classmethod
    def of(cls, x: DTensor) -> "Placed":
        return cls(x.device_mesh, tuple(x.placements), tuple(x.shape),
                   tuple(x.stride()))

    def wrap(self, local: torch.Tensor) -> DTensor:
        """``local`` as a DTensor of these placements. Nothing is checked
        across the ranks (``run_check=True`` would issue a collective) and
        the global shape is given, so no shard sizes are exchanged."""
        return DTensor.from_local(local, self.mesh, self.placements,
                                  run_check=False, shape=self.shape,
                                  stride=self.stride)


@dataclasses.dataclass(frozen=True, eq=False)
class _Shard:
    """A DTensor output of the graph: its local shard and placements."""
    local: torch.Tensor
    placed: Placed


def local_shard(x):
    """The tensor that a leaf binds: a DTensor's local shard (the tensor
    the DTensor holds, which lives as long as it does), else the leaf."""
    return x._local_tensor if isinstance(x, DTensor) else x


def _view(t: torch.Tensor) -> tuple:
    return (t.data_ptr(), tuple(t.shape), t.stride(), t.dtype)


@dataclasses.dataclass
class _Graph:
    graph: Any                       # torch.cuda.CUDAGraph
    staged: List[Tuple[torch.Tensor, torch.Tensor]]  # (device, pinned host)
    outputs: Any                     # tensors the graph writes, _Arg, _Shard
    rebuilt: bool                    # whether ``outputs`` holds either
    tally: Dict[str, int]            # kernel launches a replay makes
    refs: list                       # weakrefs to the bound tensors
    capture_ms: float
    reserved_bytes: int              # card memory the capture reserved
    copied: Any = None               # event after the staging copies


def flatten(tree, leaves: list, spec: list) -> None:
    """Append the leaves of nested dicts, tuples and lists to ``leaves`` and
    their structure to ``spec`` (None is a leaf)."""
    if isinstance(tree, dict):
        spec.append(tuple(tree))
        for v in tree.values():
            flatten(v, leaves, spec)
    elif isinstance(tree, (tuple, list)):
        spec.append((type(tree), len(tree)))
        for v in tree:
            flatten(v, leaves, spec)
    else:
        leaves.append(tree)


def rebuild(tree, leaves):
    """``tree`` with its leaves replaced, in order, by ``leaves``. (No
    recursive closure: its cycle would keep the leaves alive until the
    garbage collector runs, and with them a graph's bound tensors.)"""
    return _rebuild(tree, iter(leaves))


def _rebuild(tree, it):
    if isinstance(tree, dict):
        return {k: _rebuild(v, it) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(v, it) for v in tree)
    return next(it)


def leaf_key(x, device: torch.device) -> tuple:
    """How a leaf binds: ``("bound", address, shape, strides, dtype)`` for a
    tensor on ``device``, that and its ``Placed`` for a DTensor (of its
    local shard, which must be on ``device``), ``("staged", shape,
    dtype)`` for a host array, ``("value", type, value)`` for anything
    else."""
    if isinstance(x, DTensor):
        local = x._local_tensor
        if local.device != device:
            raise ValueError(f"a DTensor whose local shard is on "
                             f"{local.device} cannot bind to a program on "
                             f"{device}")
        return ("bound", local.data_ptr(), local.shape, local.stride(),
                local.dtype, Placed.of(x))
    if isinstance(x, torch.Tensor):
        if x.device == device:
            return ("bound", x.data_ptr(), x.shape, x.stride(), x.dtype)
        return ("staged", x.shape, x.dtype)
    if isinstance(x, np.ndarray):
        return ("staged", x.shape, x.dtype.str)
    return ("value", type(x), x)


def binding(args: tuple, device: torch.device):
    """(leaves, key) of a call's arguments on ``device``."""
    leaves, spec = [], []
    flatten(args, leaves, spec)
    return leaves, (tuple(spec), tuple(leaf_key(x, device) for x in leaves),
                    torch.are_deterministic_algorithms_enabled())


def capture_stream(device: torch.device):
    """The side stream the programs of ``device`` capture on (capture
    cannot run on the legacy default stream). cuBLAS keeps a workspace
    for each (thread, stream), for the process's life: the stream's are
    taken when the stream is made, outside any capture, so that no graph's
    pool holds one. That is this thread's, and autograd's device thread's,
    which runs a captured backward pass: a GEMM and its backward in each
    dtype."""
    device = torch.device(device)
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    with _streams_lock:
        s = _streams.get(device)
        if s is None:
            s = torch.cuda.Stream(device)
            with torch.cuda.stream(s), torch.inference_mode(False), \
                    torch.enable_grad():
                for dt in (torch.float32, torch.bfloat16):
                    x = torch.ones((8, 8), dtype=dt, device=device,
                                   requires_grad=True)
                    torch.autograd.grad(torch.mm(x, x).sum(), x)
            torch.cuda.current_stream(device).wait_stream(s)
            _streams[device] = s
        return s


def _end_pool(device: torch.device, pool) -> None:
    """Close the allocator's routing of a failed capture into its pool.
    ``CUDAGraph.capture_end`` raises on an invalidated capture before it
    ends that routing, and while any routing is open the allocator neither
    empties its cache nor frees cached blocks to retry a failed allocation:
    the card's memory would never be returned again."""
    try:
        torch._C._cuda_endAllocateToPool(device.index, pool)
    except RuntimeError:
        pass                    # capture_end had closed it before raising


def _op_source(err: BaseException) -> str:
    """The source line, outside torch, of the op that raised ``err``, and
    the torch function it called."""
    frames = traceback.extract_tb(err.__traceback__)
    mine = os.path.abspath(__file__)
    user = [f for f in frames if not os.path.abspath(
        f.filename).startswith(_TORCH_DIR)
        and os.path.abspath(f.filename) != mine]
    where = ""
    if user:
        f = user[-1]
        path = "/".join(f.filename.replace(os.sep, "/").split("/")[-2:])
        where = f"`{f.line}` ({path}:{f.lineno}, in {f.name})"
    inner = frames[-1] if frames else None
    if inner is not None and os.path.abspath(
            inner.filename).startswith(_TORCH_DIR):
        where += f" through torch's {inner.name}()"
    return where or "an op of the step"


class GraphProgram:
    """``fn`` run as CUDA graphs on ``device``, one a binding of its
    arguments (module docstring), at most ``max_graphs`` of them (None: no
    cap). ``captures``, ``replays``, ``evictions``, ``capture_ms`` and
    ``graph_bytes`` count and measure the captures. ``span`` names the
    program's spans (module docstring; default: ``name``). With
    ``release_cache`` the allocator's cached blocks are released between
    a first call's eager run and its capture (a training step): a capture
    cannot free them to retry an allocation, so without it the eager
    run's blocks and the graph's pool would have to fit side by side."""

    def __init__(self, fn: Callable, device, name: str = "",
                 max_graphs: Optional[int] = None,
                 release_cache: bool = False, span: str = ""):
        self.fn = fn
        self.release_cache = release_cache
        self.device = torch.device(device)
        if self.device.type != "cuda":
            raise ValueError(f"GraphProgram: CUDA graphs need a CUDA "
                             f"device, not {self.device}")
        if self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.__name__ = name or getattr(fn, "__name__", "program")
        self.set_span(span or self.__name__)
        self._graphs: Dict[tuple, _Graph] = {}
        self._dead: List[tuple] = []
        self._pool = _Pool()
        self._refused: Optional[str] = None
        self._chained: Dict[Callable, "GraphProgram"] = {}
        if max_graphs is not None and max_graphs < 1:
            raise ValueError(f"max_graphs {max_graphs} < 1")
        self.max_graphs = max_graphs
        self.captures = 0
        self.replays = 0
        self.evictions = 0
        self.capture_ms: List[float] = []
        self.graph_bytes: List[int] = []

    def __call__(self, *args):
        return self._call(args, copy=False)

    def fresh(self, *args):
        """A call whose tensors are the caller's to keep: the graph's
        outputs of a replay are copied (a later replay rewrites them)."""
        return self._call(args, copy=True)

    def set_span(self, span: str) -> None:
        """Name this program's spans ``<span>.bind``, ``.stage``,
        ``.replay`` and ``.capture``."""
        self.span = span
        self._span_names = tuple(f"{span}.{k}" for k in
                                 ("bind", "stage", "replay", "capture"))

    def then(self, post: Callable, span: str = "") -> "GraphProgram":
        """This program followed by ``post`` on its outputs, one graph a
        binding, in this program's memory pool; one chained program a
        ``post``, so that every caller of this program shares it. Its
        spans are named ``span`` where given, else after this program's."""
        got = self._chained.get(post)
        if got is None:
            fn = self.fn

            def step(*args):
                return post(fn(*args))

            got = GraphProgram(step, self.device, name=f"{self.__name__}"
                               f"+{getattr(post, '__name__', 'post')}",
                               span=span or self.span)
            got._pool = self._pool
            self._chained[post] = got
        elif span:
            got.set_span(span)
        return got

    def counts(self) -> Dict[str, int]:
        """Graphs held, captures, replays and evictions, of this program
        and of the programs chained to it."""
        out = dict(graphs=len(self._graphs), captures=self.captures,
                   replays=self.replays, evictions=self.evictions)
        for c in self._chained.values():
            for k, v in c.counts().items():
                out[k] += v
        return out

    def close(self) -> None:
        """Drop every graph, this program's and its chained programs', and
        the memory pool they share."""
        for c in self._chained.values():
            c.close()
        self._pool.dropped(len(self._graphs))
        self._graphs.clear()
        self._dead.clear()

    def purge(self) -> None:
        """Drop the graphs bound to a tensor that has been freed."""
        while self._dead:
            if self._graphs.pop(self._dead.pop(), None) is not None:
                self._pool.dropped()

    # ------------------------------------------------------------------
    def _call(self, args: tuple, copy: bool):
        if self._refused is not None:
            raise GraphCaptureError(self._refused)
        if self._dead:
            self.purge()
        on = recorder.on
        if on:
            bind, stage, replay, capture = self._span_names
            sp = recorder.begin(bind)
        leaves, key = binding(args, self.device)
        g = self._graphs.get(key)
        if on:
            recorder.end(sp)
        if g is None:       # the eager run's own tensors are the caller's
            if on:
                sp = recorder.begin(capture)
            out = self._first_call(args, leaves, key)
            if on:
                recorder.end(sp)
            return out
        if self.max_graphs is not None:
            self._graphs[key] = self._graphs.pop(key)   # most recently used
        if g.staged:
            if on:
                sp = recorder.begin(stage)
            self._stage(g, [x for x, k in zip(leaves, key[1])
                            if k[0] == "staged"])
            if on:
                recorder.end(sp)
        if on:
            sp = recorder.begin(replay, device=self.device)
            g.graph.replay()
            recorder.end(sp)
        else:
            g.graph.replay()
        _lib.launches.replayed(g.tally)
        self.replays += 1
        if not (g.rebuilt or copy):
            return g.outputs
        return rebuild(g.outputs, [_output(x, leaves, copy)
                                   for x in _leaves(g.outputs)])

    def _stage(self, g: _Graph, hosts: list) -> None:
        """Copy a call's host arrays into the graph's staging buffers."""
        if g.copied is not None:
            g.copied.synchronize()      # the last call's copies have landed
        for (buf, pinned), x in zip(g.staged, hosts):
            src = torch.from_numpy(np.ascontiguousarray(x)) \
                if isinstance(x, np.ndarray) else x
            pinned.copy_(src)
            buf.copy_(pinned, non_blocking=True)
        if g.copied is None:
            g.copied = torch.cuda.Event()
        g.copied.record(torch.cuda.current_stream(self.device))

    def _first_call(self, args: tuple, leaves: list, key: tuple):
        """Run the step eagerly on the call's binding, then capture it."""
        kinds = key[1]
        staged = []
        placed = []
        for x, k in zip(leaves, kinds):
            if k[0] != "staged":
                placed.append(x)
                continue
            t = torch.from_numpy(np.ascontiguousarray(x)) \
                if isinstance(x, np.ndarray) else x
            buf = torch.empty(tuple(t.shape), dtype=t.dtype,
                              device=self.device)
            pinned = torch.empty(tuple(t.shape), dtype=t.dtype,
                                 pin_memory=True)
            staged.append((buf, pinned))
            placed.append(buf)
        g = _Graph(graph=None, staged=staged, outputs=None, rebuilt=False,
                   tally={}, refs=[], capture_ms=0.0, reserved_bytes=0)
        if staged:
            self._stage(g, [x for x, k in zip(leaves, kinds)
                            if k[0] == "staged"])
        call_args = rebuild(args, placed)
        out = self.fn(*call_args)           # the call's real execution
        if self.release_cache:
            torch.cuda.empty_cache()
        self._capture(g, call_args, placed, kinds)
        dead = self._dead
        g.refs = [weakref.ref(local_shard(x),
                              lambda _, key=key: dead.append(key))
                  for x, k in zip(leaves, kinds) if k[0] == "bound"]
        self._graphs[key] = g
        while self.max_graphs is not None \
                and len(self._graphs) > self.max_graphs:
            del self._graphs[next(iter(self._graphs))]  # least recently used
            self._pool.dropped()
            self.evictions += 1
        return out

    def _capture(self, g: _Graph, call_args: tuple, placed: list,
                 kinds: tuple) -> None:
        pool = self._pool.get()
        cur = torch.cuda.current_stream(self.device)
        side = capture_stream(self.device)
        side.wait_stream(cur)
        graph = torch.cuda.CUDAGraph()
        reserved = torch.cuda.memory_reserved(self.device)
        t0 = time.perf_counter()
        err = None
        # no cycle collection during the capture: collecting a dead engine
        # frees pinned host memory and events, CUDA calls that invalidate a
        # capture
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.stream(side), _lib.capture_tally() as tally:
                graph.capture_begin(pool=pool,
                                    capture_error_mode="thread_local")
                try:
                    out = self.fn(*call_args)
                except Exception as e:          # re-raised below, named
                    err = e
                finally:
                    try:
                        graph.capture_end()
                    except RuntimeError as e:   # an invalidated capture
                        err = err or e
                        _end_pool(self.device, pool)
        finally:
            if collecting:
                gc.enable()
        cur.wait_stream(side)
        if err is not None:
            if self._pool.live == 0:
                self._pool.handle = None    # the failed graph held it alone
            self._refused = (
                f"{self.__name__}: the step cannot be captured as a CUDA "
                f"graph: {_op_source(err)} syncs with the host or uploads "
                f"from pageable memory ({type(err).__name__}: "
                f"{str(err).splitlines()[0] if str(err) else ''})")
            raise GraphCaptureError(self._refused) from err
        g.graph = graph
        g.tally = dict(tally)
        g.capture_ms = (time.perf_counter() - t0) * 1e3
        g.reserved_bytes = torch.cuda.memory_reserved(self.device) - reserved
        outs = _graph_outputs(out, placed, kinds)
        g.rebuilt = any(isinstance(x, (_Arg, _Shard)) for x in outs)
        g.outputs = rebuild(out, outs)
        self._pool.live += 1
        self.captures += 1
        self.capture_ms.append(g.capture_ms)
        self.graph_bytes.append(g.reserved_bytes)


def _leaves(tree) -> list:
    leaves: list = []
    flatten(tree, leaves, [])
    return leaves


def _graph_outputs(out, placed: list, kinds: tuple) -> list:
    """The leaves of a captured call's output as the graph keeps them: an
    ``_Arg`` for a bound argument, or for a DTensor of a bound DTensor's
    local shard and placements (a cache or state leaf written in place);
    a ``_Shard`` for any other DTensor; the tensor itself otherwise."""
    index, shards = {}, {}
    for i, (x, k) in enumerate(zip(placed, kinds)):
        if k[0] == "bound":
            index[id(x)] = i
            if isinstance(x, DTensor):
                shards[(_view(x._local_tensor), Placed.of(x))] = i
    outs = []
    for x in _leaves(out):
        if id(x) in index:
            outs.append(_Arg(index[id(x)]))
        elif isinstance(x, DTensor):
            placed_x = Placed.of(x)
            i = shards.get((_view(x._local_tensor), placed_x))
            outs.append(_Arg(i) if i is not None
                        else _Shard(x._local_tensor, placed_x))
        else:
            outs.append(x)
    return outs


def _output(x, leaves: list, copy: bool):
    """A graph's output leaf after a replay: the caller's own argument for
    an ``_Arg``, a DTensor rebuilt on its local shard for a ``_Shard``; a
    tensor of the graph's pool is copied with ``copy``."""
    if isinstance(x, _Arg):
        return leaves[x.index]
    if isinstance(x, _Shard):
        return x.placed.wrap(x.local.clone() if copy else x.local)
    return x.clone() if copy and isinstance(x, torch.Tensor) else x


class InputBuffers:
    """Fixed buffers on ``device`` that a program binds in place of
    inputs that arrive at new addresses on every call (a batch, a decode
    step's tokens): one set a signature of names, shapes and dtypes, made
    at its first call. A host input (numpy, or a tensor elsewhere) is
    copied through pinned memory on a CUDA device, a tensor on the device
    by a copy on the device."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._sets: Dict[tuple, dict] = {}
        self._copied = None            # event after the last host copies

    def into(self, inputs: dict) -> dict:
        """``inputs`` copied into the buffers of their signature; returns
        the buffers."""
        on_card = self.device.type == "cuda"
        host = {k: torch.from_numpy(np.ascontiguousarray(v))
                if isinstance(v, np.ndarray) else v
                for k, v in inputs.items()}
        key = tuple((k, tuple(v.shape), v.dtype) for k, v in host.items())
        bufs = self._sets.get(key)
        if bufs is None:
            bufs = self._sets[key] = {
                k: (torch.empty(tuple(v.shape), dtype=v.dtype,
                                device=self.device),
                    torch.empty(tuple(v.shape), dtype=v.dtype,
                                pin_memory=True) if on_card else None)
                for k, v in host.items()}
        if self._copied is not None:
            self._copied.synchronize()  # the last pinned copies have landed
        for k, v in host.items():
            buf, pinned = bufs[k]
            if v.device == self.device or pinned is None:
                buf.copy_(v)
            else:
                pinned.copy_(v)
                buf.copy_(pinned, non_blocking=True)
        if on_card:
            if self._copied is None:
                self._copied = torch.cuda.Event()
            self._copied.record(torch.cuda.current_stream(self.device))
        return {k: b for k, (b, _) in bufs.items()}


def then(program: Callable, post: Callable, span: str = "") -> Callable:
    """``program`` followed by ``post`` on its outputs: a graph program's
    chained program (``GraphProgram.then``, its spans named ``span``), or
    the two calls in a row."""
    if isinstance(program, GraphProgram):
        return program.then(post, span)

    def step(*args):
        return post(program(*args))

    return step
