"""Serving runtime on PyTorch: the prefill and decode step factories, and
the continuous-batching engine (the reference's ``BatchingEngine``) with
dense per-slot KV rows or a paged KV pool, DRR fair-share admission,
lockstep ``step`` and event-driven ``step_async``, preemption, copy-on-write
prefix sharing, zero-on-free scrubbing and page hand-off.

SSM models (mamba2) are served by ``jit_serve_step`` (or
``make_prefill_step`` and ``make_serve_step``) directly: the engine
refuses them, as the reference's does, because slot recycling relies on
position-masked KV caches. ``jit_serve_step`` binds the decode step to a
``DeviceMesh``: parameters and caches are DTensors placed by the sharding
rules, and the caches are updated in place shard by shard (the
reference's donation). On a CUDA mesh the step is one CUDA graph a
binding of the params' and caches' local shards (``MeshServeStep``): the
host pays DTensor's dispatch once, at the capture.

Greedy decoding (argmax on the device). On the card the engine's decode
step is a ``GraphProgram`` (``core/graphs.py``), the counterpart of the
reference's ``jax.jit(step)``: the serve step and the argmax after it
(``greedy_tail``) run eagerly at its first call and are captured as one
CUDA graph on the engine's own buffers, which every later step replays.
The engine keeps those buffers for its whole life (the caches, and the
tokens, positions and block tables each step copies in from pinned host
memory), so that one graph serves admissions, preemption, copy-on-write,
scrubbing and page hand-off alike. The engine's prefill is a
``PrefillProgram`` from ``prefill_program``, the counterpart of the
reference's ``_prefill_jit``: one program a (model, max_len, layout),
shared by every engine that asks for it, filling one batch-1 cache tree
it owns; on the card one CUDA graph a padded prompt length and params.
``GreedyLoop`` runs the two step factories the same way for callers that
serve a batch directly (the SSM models). Attention goes through the
hand-written CUDA kernels on a CUDA model (``repro_torch.kernels``).

The reference's jitted pool operations with buffer donation become the
in-place index operations below: the cache tensors are mutated where they
lie and nothing is copied beyond the touched rows and pages.
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
import threading
import time
from typing import Any, Callable, Deque, Dict, Iterator, List, Optional

import numpy as np
import torch

from repro_torch.analysis.lifecycle import sanitizer
from repro_torch.core.graphs import (GraphProgram, InputBuffers, _leaves,
                                     rebuild, then)
from repro_torch.models.api import Model
from repro_torch.placement import _full
from repro_torch.runtime.paged import PagePoolManager, default_pool_pages


# ---------------------------------------------------------------------------
# Step factories
# ---------------------------------------------------------------------------

def make_serve_step(model: Model):
    """serve_step(params, caches, tokens, pos) -> (logits, caches)."""

    def serve_step(params, caches, tokens, pos):
        return model.decode(params, caches, tokens, pos)

    return serve_step


def make_paged_serve_step(model: Model):
    """serve_step over the paged pool: extra (B, nb) block-table operand."""

    def serve_step(params, caches, tokens, pos, block_tables):
        return model.decode_paged(params, caches, tokens, pos, block_tables)

    return serve_step


def jit_serve_step(model: Model, mesh, batch: int, cache_len: int,
                   params_shape, caches_shape):
    """The decode step over ``mesh`` (a ``DeviceMesh``); seq-sharding kicks
    in for batch=1 long-context. Returns (step, {"params": pspecs,
    "caches": cspecs}) as the reference. ``step(params, caches, tokens,
    pos) -> (logits, caches)`` takes params and caches placed by those
    specs (``sharding.place``), tokens (B, 1) and pos (B,) as host arrays,
    tensors or DTensors, and returns the logits as a DTensor; the caches
    are written in place and returned as the caller's own (the
    reference's ``donate_argnums=(1,)``).

    On a CUDA mesh ``step`` is a ``MeshServeStep``: one CUDA graph a
    binding of the params' and caches' local shards, with tokens and pos
    copied into its own buffers and placed inside the graph; the logits
    it returns hold until its next call. On any other mesh (gloo, or the
    dry run's meta tensors) the same step runs eagerly."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.runtime.sharding import (P, axis_sizes, cache_specs,
                                              dp_axes, param_specs, place)
    cfg = model.cfg
    pspecs = param_specs(cfg, params_shape, mesh)
    sizes = axis_sizes(mesh)
    dp_total = int(np.prod([sizes[a] for a in sizes if a in ("pod", "data")]))
    seq_shard = batch % dp_total != 0
    cspecs = cache_specs(cfg, caches_shape, mesh, batch, seq_shard=seq_shard)
    dp = dp_axes(mesh)
    tok_spec = P(dp, None) if batch % dp_total == 0 else P(None, None)
    pos_spec = P(dp) if batch % dp_total == 0 else P(None)
    inner = make_serve_step(model)

    def mesh_serve_step(params, caches, tokens, pos):
        if not isinstance(tokens, DTensor):
            tokens = place(torch.as_tensor(tokens, device=model.dev), mesh,
                           tok_spec)
        if not isinstance(pos, DTensor):
            pos = place(torch.as_tensor(pos, device=model.dev), mesh,
                        pos_spec)
        with implicit_replication():
            return inner(params, caches, tokens, pos)

    specs = {"params": pspecs, "caches": cspecs}
    if getattr(mesh, "device_type", None) != "cuda":   # or a MeshShape
        return mesh_serve_step, specs
    return MeshServeStep(mesh_serve_step), specs


class MeshServeStep:
    """``jit_serve_step``'s step on a CUDA mesh, as the reference's
    compiled step: ``step(params, caches, tokens, pos)`` copies tokens and
    pos into fixed buffers on the card (one set a shape) and calls
    ``graphs``, a ``GraphProgram`` of the eager step ``step.step``, bound
    to the params' and caches' local shards and to those buffers; the
    step places the buffers by their specs inside the graph (each rank
    cuts its own shard: nothing is sent)."""

    def __init__(self, step: Callable):
        self.step = step
        self.graphs = GraphProgram(step, "cuda", name="mesh_serve_step")
        self._inputs = InputBuffers(self.graphs.device)

    def __call__(self, params, caches, tokens, pos):
        got = self._inputs.into({"tokens": _full(tokens), "pos": _full(pos)})
        return self.graphs(params, caches, got["tokens"], got["pos"])


def make_prefill_step(model: Model, max_len: int, clamp_window: bool = True):
    """prefill_step(params, batch, caches=None) -> (hidden, caches);
    ``caches`` (``model.make_prefill_caches``) is reset and filled in
    place instead of a new tree."""

    def prefill_step(params, batch, caches=None):
        return model.prefill(params, batch, max_len,
                             clamp_window=clamp_window, caches=caches)

    return prefill_step


# ---------------------------------------------------------------------------
# Compiled prefill and greedy loops (CUDA graphs on the card)
# ---------------------------------------------------------------------------

# programs the prefill cache keeps: the reference's lru_cache(maxsize=8)
PREFILL_PROGRAMS = 8
# graphs a prefill program keeps, least recently used dropped: every
# power-of-two bucket from 8 to 16384. A dense engine with a windowed
# layer pads a prompt past the window to its own length (``_pad_ctx``),
# so its distinct lengths are unbounded; the cap bounds its graphs.
PREFILL_GRAPHS = 12


def _copy_tree(tree):
    """A copy of a tuple/dict tree of tensors."""
    return rebuild(tree, [x.clone() for x in _leaves(tree)])


class PrefillProgram:
    """The batch-1 prefill of one (model, max_len, layout), the counterpart
    of the reference's ``_prefill_jit``: ``(params, toks) -> (hidden,
    caches)`` for a (1, S) int32 host prompt ``toks``. ``full_len`` builds
    full-length caches for windowed sites (the paged splice's layout).

    The caches are one batch-1 tree the program owns (``caches``), reset
    and filled in place by every call, so they hold the last call's prompt
    until the next call: a caller splices them at once or copies them,
    never keeps them. On the card the call is a ``GraphProgram``: one CUDA
    graph a prompt length and params binding (engines that share params
    share graphs), the prompt staged through pinned memory, at most
    ``PREFILL_GRAPHS`` graphs. On the CPU it is the plain call into the
    same caches. ``close`` frees the graphs and the caches; a later call
    makes them anew."""

    def __init__(self, model: Model, max_len: int, full_len: bool = False):
        self.model = model
        self.max_len = max_len
        self.full_len = full_len
        self.caches = None
        self._program = GraphProgram(
            self._prefill_into, model.dev, max_graphs=PREFILL_GRAPHS,
            name=f"prefill[{model.cfg.name}/{max_len}"
                 f"{'/full' if full_len else ''}]") \
            if model.dev.type == "cuda" else None

    def _prefill_into(self, params, toks):
        return self.model.prefill(params, {"tokens": toks}, self.max_len,
                                  clamp_window=not self.full_len,
                                  caches=self.caches)

    def __call__(self, params, toks: np.ndarray):
        if self.caches is None and not self.model.audio:
            # (the audio family's prefill needs frames: it raises the
            # reference's KeyError at its eager first call)
            self.caches = self.model.make_prefill_caches(
                1, self.max_len, clamp_window=not self.full_len)
        if self._program is not None:
            return self._program(params, toks)
        return self._prefill_into(params, torch.from_numpy(toks))

    def counts(self) -> Dict[str, int]:
        """Graphs held, captures, replays and evictions (zeros on the CPU),
        and the bytes of the program's caches and of its captures."""
        out = dict(graphs=0, captures=0, replays=0, evictions=0)
        if self._program is not None:
            out = self._program.counts()
            out["graph_bytes"] = sum(self._program.graph_bytes)
        out["cache_bytes"] = 0 if self.caches is None else sum(
            t.numel() * t.element_size() for t in _leaves(self.caches))
        return out

    def close(self) -> None:
        """Free the graphs and the caches."""
        if self._program is not None:
            self._program.close()
        self.caches = None


_prefill_programs: "collections.OrderedDict" = collections.OrderedDict()
_prefill_lock = threading.Lock()


def prefill_program(model: Model, max_len: int,
                    full_len: bool = False) -> PrefillProgram:
    """The prefill program of ``(model, max_len, full_len)``, shared by
    every engine that asks for it (a fleet's engine woken mid-hand-off
    captures no graph another engine of its model already holds). At most
    ``PREFILL_PROGRAMS`` live here, least recently asked for evicted and
    closed."""
    key = (model, int(max_len), bool(full_len))
    with _prefill_lock:
        prog = _prefill_programs.get(key)
        if prog is not None:
            _prefill_programs.move_to_end(key)
            return prog
        prog = _prefill_programs[key] = PrefillProgram(model, max_len,
                                                       full_len)
        while len(_prefill_programs) > PREFILL_PROGRAMS:
            _prefill_programs.popitem(last=False)[1].close()
        return prog


def clear_prefill_programs() -> None:
    """Close and forget every cached prefill program."""
    with _prefill_lock:
        while _prefill_programs:
            _prefill_programs.popitem()[1].close()


class GreedyLoop:
    """Greedy generation for a batch served through ``make_prefill_step``
    and ``make_serve_step`` directly (the SSM models), over buffers the
    loop keeps for its life: the caches (``batch`` rows, ``max_len``), the
    (batch, 1) tokens and (batch,) positions a decode step reads. On the
    card both steps are ``GraphProgram``s, as the reference's callers
    ``jax.jit`` them: one prefill graph a prompt shape, one decode graph
    that every step replays (the next tokens and positions are copied into
    the same buffers). ``prefill`` and ``step`` return the step's (batch,
    V) logits and (batch,) int32 greedy ids, valid until the next call:
    copy what is kept."""

    def __init__(self, model: Model, batch: int, max_len: int):
        dev = model.dev
        self.model = model
        self.caches = model.make_prefill_caches(batch, max_len)
        self.tokens = torch.zeros((batch, 1), dtype=torch.int32, device=dev)
        self.pos = torch.zeros((batch,), dtype=torch.int32, device=dev)
        self.ids = None
        prefill = make_prefill_step(model, max_len)
        logits = model.logits

        def prefill_ids(params, batch_, caches):
            h, _ = prefill(params, batch_, caches=caches)
            return greedy_tail((logits(params, h[:, -1:]), caches))

        step = make_serve_step(model)
        if dev.type == "cuda":
            self._prefill = GraphProgram(prefill_ids, dev)
            self._step = then(GraphProgram(step, dev), greedy_tail)
        else:
            self._prefill, self._step = prefill_ids, then(step, greedy_tail)

    def prefill(self, params, batch):
        """Prefill ``batch`` (``tokens`` (B, S)) into the caches; the next
        step decodes position S."""
        logits, self.ids = self._prefill(params, batch, self.caches)
        self.pos.fill_(batch["tokens"].shape[1])
        return logits[:, 0], self.ids

    def step(self, params, feed: Optional[torch.Tensor] = None):
        """One decode step, fed the last step's greedy ids or ``feed``
        ((B,) int32 on the device)."""
        self.tokens[:, 0].copy_(self.ids if feed is None else feed)
        logits, self.ids = self._step(params, self.caches, self.tokens,
                                      self.pos)
        self.pos.add_(1)
        return logits[:, 0], self.ids

    def counts(self) -> Dict[str, Dict[str, int]]:
        """The prefill's and the decode step's graph counts (empty on the
        CPU)."""
        return {name: p.counts() for name, p in
                (("prefill", self._prefill), ("decode", self._step))
                if isinstance(p, GraphProgram)}

    def close(self) -> None:
        """Free the graphs and the buffers."""
        for p in (self._prefill, self._step):
            if isinstance(p, GraphProgram):
                p.close()
        self.caches = self.ids = None


# ---------------------------------------------------------------------------
# In-place cache/pool operations
# ---------------------------------------------------------------------------

def _site_caches(caches):
    """Yield every site's cache dict of a stage-structured cache tree; the
    audio family's ``{"self", "cross_k", "cross_v"}`` tree gives its self-
    attention cache and then its cross K/V as one dict."""
    if isinstance(caches, dict):
        yield caches["self"]
        yield {k: v for k, v in caches.items() if k != "self"}
        return
    for st in caches:
        if isinstance(st, dict):
            yield st
        else:
            yield from st


def _splice_slot(full, one, slot: int) -> None:
    """Write a batch-1 prefill cache into row ``slot`` of the shared caches,
    in place. Leaves are (L, n_slots, ...) and (L, 1, ...)."""
    for f, o in zip(_site_caches(full), _site_caches(one)):
        for name, leaf in f.items():
            leaf[:, slot] = o[name][:, 0].to(leaf.dtype)


def _splice_pages(pool, one, pages: torch.Tensor, start: int) -> None:
    """Scatter a batch-1 full-length prefill cache into pool pages, in
    place: block ``start + i`` of the context lands in page ``pages[i]``.
    Pool leaves are (L, P, ps, ...), prefill leaves (L, 1, max_len, ...)."""
    nb = pages.shape[0]
    for f, o in zip(_site_caches(pool), _site_caches(one)):
        for name, leaf in f.items():
            ps = leaf.shape[2]
            seg = o[name][:, 0, start * ps:(start + nb) * ps]
            seg = seg.reshape((seg.shape[0], nb, ps) + tuple(seg.shape[2:]))
            leaf[:, pages] = seg.to(leaf.dtype)


def _invalidate_pool_pages(pool, pages: torch.Tensor) -> None:
    """Reset the ``pos`` metadata of ``pages`` to -1 across every layer's
    pool, in place. A recycled page still carries its previous occupant's
    positions; for the new owner those can look like valid causal history,
    so every allocation that does not overwrite the whole page must
    invalidate it first. Only the positions change — k/v content is dead
    weight once pos is -1."""
    for f in _site_caches(pool):
        f["pos"][:, pages] = -1


def _scrub_pool_pages(pool, pages: torch.Tensor) -> None:
    """Zero-on-free, in place: restore ``pages`` to their init state across
    every layer's pool — k/v content to 0, ``pos`` to -1, quantization
    scales to 1 — so ``export_request_pages`` can never hand a previous
    tenant's residual K/V to a migration target."""
    for f in _site_caches(pool):
        for name, leaf in f.items():
            fill = -1 if name == "pos" else \
                1 if name in ("k_scale", "v_scale") else 0
            leaf[:, pages] = fill


def _copy_page(pool, src: int, dst: int) -> None:
    """Copy-on-write detach: duplicate page ``src`` into ``dst`` across
    every layer's pool, in place (leaves are (L, P, ps, ...))."""
    for f in _site_caches(pool):
        for leaf in f.values():
            leaf[:, dst] = leaf[:, src]


def _import_pages(pool, payload, pages: torch.Tensor) -> None:
    """Scatter a migrated request's page payload (leaves (L, nb, ps, ...))
    into freshly allocated pages of this engine's pool, in place."""
    for f, o in zip(_site_caches(pool), _site_caches(payload)):
        for name, leaf in f.items():
            leaf[:, pages] = o[name].to(device=leaf.device, dtype=leaf.dtype)


def _argmax_tokens(logits: torch.Tensor) -> torch.Tensor:
    """Greedy sampling on the device: (n_slots, 1, vocab) logits ->
    (n_slots,) int32 ids, so only 4 bytes per slot cross to the host."""
    return torch.argmax(logits[:, 0, :], dim=-1).to(torch.int32)


def greedy_tail(out):
    """What the engine runs after a serve step, in the same graph:
    (logits, caches) -> (logits, (n_slots,) int32 greedy ids)."""
    logits, _ = out
    return logits, _argmax_tokens(logits)


# ---------------------------------------------------------------------------
# Requests
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Request:
    request_id: int
    prompt: np.ndarray                 # (S,) int32
    max_new_tokens: int = 16
    tenant: str = "default"
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    done: threading.Event = dataclasses.field(default_factory=threading.Event)
    submitted_at: float = dataclasses.field(default_factory=time.monotonic)
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None
    finish_reason: Optional[str] = None   # "eos" | "length" | "cancelled"


@dataclasses.dataclass
class _PendingPrefill:
    """A slot admitted by the event-driven loop whose prompt prefill has
    not yet been spliced into the shared caches. The batched prefill is
    computed once at admission but only buffered here; the slot is
    accounted ``prefill_chunk`` context tokens per engine event and joins
    decode when the accounted chunks cover the context."""
    chunks_left: int
    buf: Any                    # batch-1 prefill caches (None: nothing to splice)
    plan: Any                   # paged AdmitPlan (None on dense engines)
    ctx_len: int                # len(prompt + replayed tokens)
    last_token: int             # final context token -> first decode input


def _req_event(req: Request, event: str) -> None:
    """Drive the request lifecycle machine (RC3E_SANITIZE=1)."""
    tok = getattr(req, "_san", None)
    if tok is not None:
        sanitizer.emit("request", tok, event)


class BatchingEngine:
    """Slot-based continuous batching: up to ``n_slots`` concurrent requests
    share one decode step; prefill happens per request into its slot.

    Requests are tenant-tagged: each tenant has its own FIFO queue, and
    admission runs weighted deficit round-robin across tenants
    (``_pop_next_request``). A tenant's share caps its concurrent slots.

    Two cache layouts:

    * dense (default): per-slot (n_slots, max_len) KV rows;
    * ``paged=True``: one shared page pool (``cache_pages`` pages of
      ``page_size`` positions) virtualized across slots by block tables,
      with queue-on-exhaustion admission, page-by-page growth, tenant-scoped
      copy-on-write prefix sharing and preemption back to the queue head.

    The engine runs on ``model.device`` (CUDA unless the model was built
    for the CPU). Its decode step is the step factories' serve step and
    ``greedy_tail``, a ``GraphProgram`` on the card (module docstring),
    over buffers it keeps for its whole life: the caches, tokens
    (n_slots, 1), positions (n_slots,) and, paged, the block tables
    (n_slots, max_blocks).
    """

    # contexts shorter than this prefill through the decode step; longer
    # ones get the batched prefill call
    PREFILL_MIN_TOKENS = 4

    def __init__(self, model: Model, params, n_slots: int = 4,
                 max_len: int = 256, eos_id: Optional[int] = None,
                 prefill_mode: str = "batched",
                 id_counter: Optional[Iterator[int]] = None,
                 paged: bool = False, page_size: int = 16,
                 cache_pages: Optional[int] = None,
                 scrub_on_free: bool = True):
        # Slot recycling relies on position-masked KV caches (stale entries
        # carry positions > current and are masked out). SSM state has no
        # such masking, so the engine serves attention-family models; SSM
        # serving uses the step factories above.
        if model.cfg.ssm is not None:
            raise ValueError("BatchingEngine supports attention-family "
                             "models; use jit_serve_step for SSM archs")
        if prefill_mode not in ("batched", "legacy"):
            raise ValueError(f"unknown prefill_mode {prefill_mode!r}")
        self.model = model
        self.device = model.dev
        self.params = params
        self.n_slots = n_slots
        self.max_len = max_len
        self.eos_id = eos_id
        self.prefill_mode = prefill_mode
        self.paged = paged
        self._queues: "Dict[str, Deque[Request]]" = {}
        self._qlock = threading.Lock()
        self._tenant_share: Dict[str, int] = {}      # max concurrent slots
        self._tenant_pages: Dict[str, int] = {}      # max pool pages held
        self._tenant_weight: Dict[str, float] = {}   # fair-share weight
        self._deficit: Dict[str, float] = {}         # DRR credit per tenant
        self._rr_offset = 0                          # DRR tie-break cursor
        self._ids = id_counter if id_counter is not None \
            else itertools.count()
        self._slots: List[Optional[Request]] = [None] * n_slots
        self._prefilling: Dict[int, _PendingPrefill] = {}
        self.steps = 0
        self.preemptions = 0
        self.scrub_ms = 0.0        # cumulative zero-on-free dispatch cost
        self._scope = sanitizer.scope()      # slot-machine key namespace
        # the pool's version the device block tables were copied at
        self._bt_version = -1
        if paged:
            if model.cfg.mla is not None:
                raise ValueError("paged KV caches support plain-attention "
                                 "models (MLA latents are not paged)")
            if max_len % page_size:
                raise ValueError(f"max_len {max_len} must be a multiple of "
                                 f"page_size {page_size}")
            self.page_size = page_size
            max_blocks = max_len // page_size
            if cache_pages is None:
                cache_pages = default_pool_pages(n_slots, max_blocks)
            self.cache_pages = cache_pages
            self.pool = PagePoolManager(cache_pages, page_size, n_slots,
                                        max_blocks,
                                        scrub_on_free=scrub_on_free)
            self.caches = model.make_paged_caches(cache_pages, page_size)
            self._pos = np.full((n_slots,), -1, np.int32)
            self._min_cache_len = max_len      # full-length pools, no ring
        else:
            self.page_size = 0
            self.cache_pages = 0
            self.pool = None
            self.caches = model.make_caches(n_slots, max_len)
            self._pos = np.zeros((n_slots,), np.int32)
            # padding a prefill past the shortest layer cache (a local-
            # attention window) would evict real in-window history; every
            # leaf with a length axis counts (K/V rows, MLA latents, pos)
            self._min_cache_len = min(
                (leaf.shape[2] for f in _site_caches(self.caches)
                 for leaf in f.values() if leaf.dim() >= 3),
                default=max_len)
        # the decode step's buffers: fixed addresses for the step's graph
        on_card = self.device.type == "cuda"
        self._tok = torch.zeros((n_slots, 1), dtype=torch.int32,
                                device=self.device)
        self._posd = torch.zeros((n_slots,), dtype=torch.int32,
                                 device=self.device)
        self._bt = torch.zeros((n_slots, max_len // page_size),
                               dtype=torch.int32, device=self.device) \
            if paged else None
        # their pinned host sides, and the ids' download buffer
        self._host = {name: torch.zeros(tuple(t.shape), dtype=torch.int32,
                                        pin_memory=on_card)
                      for name, t in (("tok", self._tok),
                                      ("pos", self._posd), ("bt", self._bt),
                                      ("ids", self._posd))
                      if t is not None}
        self._copied = torch.cuda.Event() if on_card else None
        self._copy_pending = False
        self._step_ids = None                # the last step's (n_slots,) ids
        # the model's decode step for this layout, and its prefill
        step = make_paged_serve_step(model) if paged \
            else make_serve_step(model)
        self.use_program(GraphProgram(step, self.device) if on_card
                         else step)
        # the batched prefill: one program a (model, max_len, layout),
        # shared across engines
        self._prefill_fn = prefill_program(model, max_len, full_len=paged)
        # hooks: called after every decode step / on every completion
        self.on_step: Optional[Callable[[Dict[str, int], float], None]] = None
        self.on_finish: Optional[Callable[[Request], None]] = None

    def use_program(self, compiled: Callable) -> None:
        """Swap in an externally configured decode program, of the step
        factories' signature (``make_serve_step`` / ``make_paged_serve_step``):
        the serving gateway and fleet configure the decode step through the
        hypervisor's ``Reconfigurator``, so the program lives in the RC3E
        program cache (and PR swaps bind it to each tenant's vSlice).
        The engine runs it followed by ``greedy_tail`` (``then``): on the
        card one graph of the program's, captured on this engine's buffers
        at its first step. The program must write the caches it is given
        in place, on the engine's own device (the gateway and the fleet
        refuse a model that is not on the hypervisor's device)."""
        self._decode_fn = compiled
        self._greedy = then(compiled, greedy_tail)

    def _stage(self, name: str, dev: torch.Tensor, x: np.ndarray) -> None:
        """Copy a host array into one of the step's device buffers, in
        place, through its pinned host side."""
        host = self._host[name]
        if self._copy_pending:
            self._copied.synchronize()   # the last copies have landed
            self._copy_pending = False
        # the pinned buffer's own memory: no device sync
        host.numpy()[...] = x                    # rc3e: allow-host-sync
        dev.copy_(host, non_blocking=self._copied is not None)

    def _decode(self, tokens: np.ndarray, pos: np.ndarray):
        """One decode step over all slots; the caches update in place.
        The step's inputs are copied into its buffers: (n_slots, 1) tokens,
        (n_slots,) positions and, when the pool's version moved, the block
        tables. Returns the logits (valid until the next step); the
        step's greedy ids wait in ``_step_ids``."""
        self._stage("tok", self._tok, tokens)
        self._stage("pos", self._posd, pos)
        extra = (self._block_tables_dev(),) if self.paged else ()
        if self._copied is not None:
            self._copied.record(torch.cuda.current_stream(self.device))
            self._copy_pending = True
        logits, self._step_ids = self._greedy(self.params, self.caches,
                                              self._tok, self._posd, *extra)
        return logits

    def _download_ids(self) -> np.ndarray:
        """The last decode step's (n_slots,) greedy ids on the host."""
        host = self._host["ids"]
        host.copy_(self._step_ids, non_blocking=self._copied is not None)
        if self._copied is not None:
            torch.cuda.current_stream(self.device).synchronize()
        # the step's one download, 4 bytes a slot
        return host.numpy().copy()               # rc3e: allow-host-sync

    def _prefill(self, toks: np.ndarray):
        """Batch-1 prefill of a padded (1, S) host context -> its caches
        (full length, no ring, on a paged engine): the prefill program's
        own, valid until its next call."""
        _, caches = self._prefill_fn(self.params, toks)
        return caches

    def set_tenant_share(self, tenant: str, max_slots: Optional[int]) -> None:
        """Cap a tenant's concurrent engine slots (None removes the cap)."""
        if max_slots is None:
            self._tenant_share.pop(tenant, None)
        else:
            self._tenant_share[tenant] = max(1, int(max_slots))

    def set_tenant_weight(self, tenant: str,
                          weight: Optional[float]) -> None:
        """Fair-share weight for the deficit round-robin admission policy
        (None resets to the default 1.0)."""
        if weight is None:
            self._tenant_weight.pop(tenant, None)
        else:
            self._tenant_weight[tenant] = max(1e-3, float(weight))

    def set_tenant_pages(self, tenant: str,
                         max_pages: Optional[int]) -> None:
        """Cap a tenant's pool pages (paged mode; None removes the cap)."""
        if max_pages is None:
            self._tenant_pages.pop(tenant, None)
        else:
            self._tenant_pages[tenant] = max(1, int(max_pages))

    def submit(self, prompt, max_new_tokens: int = 16,
               tenant: str = "default") -> Request:
        prompt = np.asarray(prompt, np.int32)
        if prompt.size == 0:
            raise ValueError("empty prompt: a request needs at least one "
                             "prompt token to seed decoding")
        if self.paged:
            worst = (len(prompt) + max_new_tokens - 1) // self.page_size + 1
            if worst > self.pool.max_blocks:
                raise ValueError(
                    f"request may need {worst} blocks, block table has "
                    f"{self.pool.max_blocks} (max_len {self.max_len}) — "
                    "it could never be admitted")
            if worst > self.pool.total_pages:
                raise ValueError(
                    f"request may need {worst} pages, pool has only "
                    f"{self.pool.total_pages} — it could never be admitted")
        req = Request(next(self._ids), prompt, max_new_tokens, tenant=tenant)
        if sanitizer.enabled:
            req._san = sanitizer.scope()
            _req_event(req, "submit")
        with self._qlock:
            self._queues.setdefault(tenant,
                                    collections.deque()).append(req)
        return req

    def resume(self, req: Request, front: bool = False) -> Request:
        """Requeue a request preempted locally or drained from another
        engine: its generated tokens are replayed as a prompt prefix when
        it is re-admitted. A request already settled is dropped."""
        if req.done.is_set():
            return req
        _req_event(req, "requeue")
        with self._qlock:
            q = self._queues.setdefault(req.tenant, collections.deque())
            if front:
                q.appendleft(req)
            else:
                q.append(req)
        return req

    # ---------------- tenant bookkeeping ----------------
    def _drain_queue(self, tenant: str) -> List[Request]:
        with self._qlock:
            q = self._queues.pop(tenant, None)
        return list(q) if q is not None else []

    def cancel_queued(self, tenant: str) -> List[Request]:
        """Drop a tenant's not-yet-admitted requests, marked done."""
        dropped = self._drain_queue(tenant)
        for r in dropped:
            _req_event(r, "cancel")
            r.finish_reason = "cancelled"
            r.finished_at = time.monotonic()
            r.done.set()
        return dropped

    def cancel(self, req: Request) -> bool:
        """Cancel ONE request wherever it is (queued or in flight; its slot
        and pages are freed at once). Returns False when it already
        finished."""
        if req.done.is_set():
            return False
        dequeued = False
        with self._qlock:
            q = self._queues.get(req.tenant)
            if q is not None and req in q:
                q.remove(req)
                if not q:
                    del self._queues[req.tenant]
                dequeued = True
        if dequeued:
            self._finish(req, "cancelled")
            return True
        for i, r in enumerate(self._slots):
            if r is req:
                self._release_slot(i)
                self._finish(req, "cancelled")
                return True
        return False

    def _finish(self, req: Request, reason: str):
        _req_event(req, "cancel" if reason == "cancelled" else "finish")
        req.finish_reason = reason
        req.finished_at = time.monotonic()
        req.done.set()
        if self.on_finish is not None:
            self.on_finish(req)

    def _release_slot(self, slot: int):
        """Free a slot (and its pool pages) without touching the request."""
        sanitizer.emit("slot", (self._scope, slot), "release")
        self._slots[slot] = None
        self._prefilling.pop(slot, None)   # buffered prefill dies with it
        self._pos[slot] = -1 if self.paged else 0
        if self.paged:
            self.pool.release_slot(slot)

    def drain_tenant(self, tenant: str) -> List[Request]:
        """Evict a tenant's in-flight and queued requests for hand-off to
        another engine (export pages BEFORE draining). Returns them,
        in-flight first."""
        moved: List[Request] = []
        for i, r in enumerate(self._slots):
            if r is not None and r.tenant == tenant:
                _req_event(r, "drain")
                self._release_slot(i)
                moved.append(r)
        moved.extend(self._drain_queue(tenant))
        return moved

    def inflight(self, tenant: Optional[str] = None) -> List[Request]:
        return [r for r in self._slots
                if r is not None and (tenant is None or r.tenant == tenant)]

    def holds(self, req: Request) -> bool:
        """Is this request physically on this engine (slotted or queued)?"""
        if any(r is req for r in self._slots):
            return True
        with self._qlock:
            q = self._queues.get(req.tenant)
            return q is not None and any(r is req for r in q)

    def active_by_tenant(self) -> Dict[str, int]:
        counts: Dict[str, int] = {}
        for r in self._slots:
            if r is not None:
                counts[r.tenant] = counts.get(r.tenant, 0) + 1
        return counts

    def queued_by_tenant(self) -> Dict[str, int]:
        with self._qlock:
            return {t: len(q) for t, q in self._queues.items() if q}

    def _ctx_tokens(self, req: Request) -> np.ndarray:
        """Prompt + already-generated tokens: the context a (re-)admission
        must cover (the final token seeds the next decode step)."""
        if not req.out_tokens:
            return req.prompt
        # admission-time list->array conversion, not per-decode-step
        return np.concatenate(
            [req.prompt,
             np.asarray(req.out_tokens, np.int32)])  # rc3e: allow-host-sync

    def _pages_dev(self, pages) -> torch.Tensor:
        """Upload a page-index list (block order kept) at admission, growth
        or flush time — never per decode step."""
        idx = np.asarray(pages, np.int64)            # rc3e: allow-host-sync
        return torch.from_numpy(idx).to(self.device)  # rc3e: allow-host-sync

    def _invalidate_pages(self, pages) -> None:
        """Reset recycled pages' stale ``pos`` metadata before first use by
        a token-at-a-time writer."""
        if not self.paged or not pages:
            return
        _invalidate_pool_pages(self.caches, self._pages_dev(sorted(pages)))

    def _flush_scrub(self) -> int:
        """Drain the pool's zero-on-free queue with ONE batched zeroing.
        Called at the top of every step and before any page allocation."""
        if not self.paged or not self.pool.scrub_pending:
            return 0
        pids = self.pool.take_scrub()
        t0 = time.monotonic()
        _scrub_pool_pages(self.caches, self._pages_dev(sorted(pids)))
        self.scrub_ms += (time.monotonic() - t0) * 1e3
        return len(pids)

    def _page_budget_ok(self, tenant: str, extra: int) -> bool:
        budget = self._tenant_pages.get(tenant)
        return budget is None or \
            self.pool.tenant_pages(tenant) + extra <= budget

    def _can_admit(self, req: Request) -> bool:
        """Paged admission gate: queue-on-exhaustion."""
        if not self.paged:
            return True
        needed = self.pool.pages_needed(
            req.tenant, self._ctx_tokens(req),
            share=self.prefill_mode == "batched")
        return needed <= self.pool.free_pages and \
            self._page_budget_ok(req.tenant, needed)

    def _admit_cost(self, req: Request) -> float:
        """What one admission debits from its tenant's fair-share credit:
        one decode slot plus the prefill work, in page-sized chunks."""
        unit = self.page_size if self.paged else 16
        return 1.0 + (len(self._ctx_tokens(req)) - 1) / max(1, unit)

    def _pop_next_request(self) -> Optional[Request]:
        """Weighted deficit round-robin over tenants: every eligible tenant
        accrues credit proportional to its weight each time a slot is
        offered, the highest-credit tenant is served and debited
        ``_admit_cost``; ties break in rotation order."""
        with self._qlock:
            active = self.active_by_tenant()
            for t in list(self._deficit):
                if t not in self._queues and not active.get(t):
                    del self._deficit[t]
            tenants = [t for t, q in self._queues.items() if q]
            if not tenants:
                return None
            n = len(tenants)
            order = [tenants[(self._rr_offset + k) % n] for k in range(n)]
            eligible = []
            for t in order:
                share = self._tenant_share.get(t, self.n_slots)
                if active.get(t, 0) >= share:
                    continue
                if not self._can_admit(self._queues[t][0]):
                    continue        # per-tenant FIFO: head blocks the rest
                eligible.append(t)
            if not eligible:
                return None
            best = None
            for t in eligible:
                self._deficit[t] = self._deficit.get(t, 0.0) + \
                    self._tenant_weight.get(t, 1.0)
                if best is None or self._deficit[t] > self._deficit[best]:
                    best = t        # strict >: first-in-order wins ties
            req = self._queues[best].popleft()
            if not self._queues[best]:
                del self._queues[best]
            self._deficit[best] = self._deficit.get(best, 0.0) - \
                self._admit_cost(req)
            self._rr_offset = (tenants.index(best) + 1) % n
            return req

    # ---------------- engine loop ----------------
    def _admit(self, async_chunk: Optional[int] = None):
        for slot in range(self.n_slots):
            if self._slots[slot] is not None:
                continue
            req = self._pop_next_request()
            if req is None:
                return
            self._slots[slot] = req
            sanitizer.emit("slot", (self._scope, slot), "occupy")
            _req_event(req, "admit")
            if async_chunk is not None:
                self._start_prefill_async(slot, req, async_chunk)
                continue
            toks = self._ctx_tokens(req)
            if self.paged:
                self._admit_paged(slot, req, toks)
            else:
                ctx = toks[:-1]
                if len(ctx) >= self.PREFILL_MIN_TOKENS \
                        and self.prefill_mode == "batched":
                    self._prefill_slot(slot, ctx)
                else:
                    for i, t in enumerate(ctx):
                        self._step_single(slot, int(t), i)
                self._pos[slot] = len(toks) - 1
            req._next_input = int(toks[-1])
            _req_event(req, "ready")   # lockstep: prefill completed inline

    def _start_prefill_async(self, slot: int, req: Request, chunk: int):
        """Admit ``req`` into ``slot`` without blocking the engine event:
        compute the batched prefill once, buffer the result, and let
        ``step_async`` account one ``chunk`` of context tokens per event
        before the slot joins decode."""
        toks = self._ctx_tokens(req)
        ctx = toks[:-1]
        plan = None
        if self.paged:
            self._flush_scrub()
            plan = self.pool.admit(slot, req.tenant, toks,
                                   share=self.prefill_mode == "batched")
        buf = None
        chunks = 0
        if plan is not None and plan.skip_prefill:
            pass                        # every context page prefix-matched
        elif len(ctx) >= self.PREFILL_MIN_TOKENS \
                and self.prefill_mode == "batched":
            # a copy: another admission (here or in an engine sharing the
            # program) may run the prefill again before the splice
            buf = _copy_tree(self._prefill(self._pad_ctx(ctx)))
            chunks = -(-len(ctx) // max(1, int(chunk)))   # ceil
        else:
            if plan is not None:
                self._invalidate_pages(plan.write_pages)
            for i, t in enumerate(ctx):
                self._step_single(slot, int(t), i)
        if self.paged:
            # masked until ready: decode rows at -1 write the null page
            self._pos[slot] = -1
        pending = _PendingPrefill(chunks, buf, plan, len(toks),
                                  int(toks[-1]))
        if chunks <= 0:
            self._finish_prefill(slot, pending)
        else:
            self._prefilling[slot] = pending

    def _finish_prefill(self, slot: int, pending: _PendingPrefill):
        """Splice the buffered prefill and open the slot for decode."""
        req = self._slots[slot]
        if pending.buf is not None:
            if self.paged:
                plan = pending.plan
                _splice_pages(self.caches, pending.buf,
                              self._pages_dev(plan.write_pages),
                              start=plan.write_start)
            else:
                _splice_slot(self.caches, pending.buf, slot)
        self._pos[slot] = pending.ctx_len - 1
        req._next_input = pending.last_token
        _req_event(req, "ready")

    def _admit_paged(self, slot: int, req: Request, toks: np.ndarray):
        """Page-granular admission: prefix-matched pages are adopted by
        refcount; only the unshared suffix blocks are prefilled and
        spliced."""
        self._flush_scrub()
        plan = self.pool.admit(slot, req.tenant, toks,
                               share=self.prefill_mode == "batched")
        ctx = toks[:-1]
        if not plan.skip_prefill:
            if len(ctx) >= self.PREFILL_MIN_TOKENS \
                    and self.prefill_mode == "batched":
                self._prefill_slot_paged(slot, ctx, plan)
            else:
                self._invalidate_pages(plan.write_pages)
                for i, t in enumerate(ctx):
                    self._step_single(slot, int(t), i)
        self._pos[slot] = len(toks) - 1

    def _prefill_slot(self, slot: int, ctx: np.ndarray):
        """Prefill a slot's context with ONE batched call (lengths padded
        to power-of-two buckets; padded positions sit past the context and
        are causally masked until generation overwrites them), spliced
        before anything else can run the prefill program."""
        _splice_slot(self.caches, self._prefill(self._pad_ctx(ctx)), slot)

    def _prefill_slot_paged(self, slot: int, ctx: np.ndarray, plan):
        """Prefill, then scatter ONLY the unshared suffix blocks into this
        slot's pool pages."""
        buf = self._prefill(self._pad_ctx(ctx))
        _splice_pages(self.caches, buf,
                      self._pages_dev(plan.write_pages),
                      start=plan.write_start)

    def _pad_ctx(self, ctx: np.ndarray) -> np.ndarray:
        """The (1, pad) host prompt of a context: the reference's padding
        (power-of-two buckets from 8, none past the shortest layer cache);
        the prefill program stages it on the device."""
        n = len(ctx)
        bucket = 8
        while bucket < n:
            bucket *= 2
        pad = max(n, min(bucket, self._min_cache_len))
        toks = np.zeros((1, pad), np.int32)
        toks[0, :n] = ctx
        return toks

    def _block_tables_dev(self) -> torch.Tensor:
        """The step's block-table buffer, copied into in place only when the
        pool's ``version`` counter moved (a new tensor would be a new
        address, and so a new graph)."""
        if self._bt_version != self.pool.version:
            self._stage("bt", self._bt, self.pool.block_tables)
            self._bt_version = self.pool.version
        return self._bt

    def _step_single(self, slot: int, token: int, pos: int):
        """Replay ONE context token through the decode step (short or
        legacy-mode prefill). Only the cache writes matter here."""
        tokens = np.zeros((self.n_slots, 1), np.int32)
        tokens[slot, 0] = token
        if self.paged:
            # other rows stay inactive (-1): their k/v writes land in the
            # null page instead of garbling a possibly-shared write page
            posv = np.full((self.n_slots,), -1, np.int32)
        else:
            posv = self._pos.copy()
        posv[slot] = pos
        self._decode(tokens, posv)

    def _prepare_writes(self):
        """Before a paged decode step: every active slot's write position
        must land in a privately owned page (grow at a page boundary,
        copy-on-write a shared page, preempt on exhaustion)."""
        ps = self.page_size
        for i, req in enumerate(self._slots):
            if req is None or i in self._prefilling:
                continue            # mid-prefill: pos is -1, nothing writes
            wpos = int(self._pos[i])
            block = wpos // ps
            if block >= len(self.pool.slot_blocks(i)):
                if self.pool.free_pages >= 1 and \
                        self._page_budget_ok(req.tenant, 1):
                    self._flush_scrub()
                    self._invalidate_pages([self.pool.grow(i, req.tenant)])
                else:
                    self._preempt(i)
                continue
            if self.pool.is_shared(i, block):
                if self.pool.free_pages >= 1 and \
                        self._page_budget_ok(req.tenant, 1):
                    self._flush_scrub()
                    src, dst = self.pool.cow(i, block, req.tenant)
                    _copy_page(self.caches, src, dst)
                else:
                    self._preempt(i)
                continue
            self.pool.touch_write(i, block)

    def _preempt(self, slot: int):
        req = self._slots[slot]
        _req_event(req, "preempt")
        self._release_slot(slot)
        self.resume(req, front=True)
        self.preemptions += 1

    def step(self) -> int:
        """One engine iteration: admit + one decode step for active slots.
        Returns number of active slots."""
        self._flush_scrub()       # pages freed since the last step
        self._admit()
        return self._decode_once()

    def step_async(self, prefill_chunk: int = 4) -> int:
        """One event-driven engine iteration: admit without blocking
        (prefills are buffered and accounted ``prefill_chunk`` context
        tokens per event), advance pending prefills one chunk, then decode
        the slots whose prefill already completed. Token streams equal the
        lockstep path's."""
        self._flush_scrub()
        self._admit(async_chunk=prefill_chunk)
        for slot in sorted(self._prefilling):
            pending = self._prefilling[slot]
            pending.chunks_left -= 1
            _req_event(self._slots[slot], "chunk")
            if pending.chunks_left <= 0:
                del self._prefilling[slot]
                self._finish_prefill(slot, pending)
        return self._decode_once()

    def _decode_once(self) -> int:
        """One decode step over every ready slot. Returns the number of
        slots decoded."""
        if self.paged:
            self._prepare_writes()
        active = [i for i, r in enumerate(self._slots)
                  if r is not None and i not in self._prefilling]
        if not active:
            return 0
        tokens = np.zeros((self.n_slots, 1), np.int32)
        for i in active:
            tokens[i, 0] = self._slots[i]._next_input
        t0 = time.monotonic()
        self._decode(tokens, self._pos)
        # argmax on device: download (n_slots,) int32 ids, not the logits
        next_ids = self._download_ids()
        step_ms = (time.monotonic() - t0) * 1e3
        self.steps += 1
        if self.on_step is not None:
            self.on_step(self.active_by_tenant(), step_ms)
        for i in active:
            req = self._slots[i]
            nxt = int(next_ids[i])
            if req.first_token_at is None:
                req.first_token_at = time.monotonic()
            req.out_tokens.append(nxt)
            req._next_input = nxt
            self._pos[i] += 1
            eos = self.eos_id is not None and nxt == self.eos_id
            if len(req.out_tokens) >= req.max_new_tokens or eos \
                    or self._pos[i] >= self.max_len - 1:
                self._release_slot(i)
                self._finish(req, "eos" if eos else "length")
        return len(active)

    def idle(self) -> bool:
        with self._qlock:
            queued = any(self._queues.values())
        return all(r is None for r in self._slots) and not queued

    def run_until_idle(self, max_steps: int = 10000) -> bool:
        """Run until no work remains. False when ``max_steps`` expired with
        work pending or queued work can make no progress."""
        for _ in range(max_steps):
            n = self.step()
            if self.idle():
                return True
            if n == 0:
                return False        # nothing active, nothing admittable
        return self.idle()

    # ---------------- paged introspection / hand-off ----------------
    def page_stats(self) -> dict:
        """Pool occupancy for the monitor (empty dict in dense mode)."""
        if not self.paged:
            return {}
        s = self.pool.stats()
        s["preemptions"] = self.preemptions
        s["scrub_ms"] = round(self.scrub_ms, 3)
        return s

    def export_request_pages(self, req: Request):
        """Copy an in-flight request's pool pages to host memory for a live
        hand-off: the cache tree with leaves (L, nb, ps, ...) as CPU
        tensors (numpy has no bfloat16). Call BEFORE draining. None when
        the request holds no slot or the engine is dense."""
        if not self.paged:
            return None
        for i, r in enumerate(self._slots):
            if r is req:
                pages = self.pool.slot_blocks(i)
                if not pages:
                    return None
                idx = self._pages_dev(pages)
                return tuple(
                    {k: v[:, idx].cpu() for k, v in st.items()}
                    if isinstance(st, dict) else
                    tuple({k: v[:, idx].cpu() for k, v in f.items()}
                          for f in st)
                    for st in self.caches)
        return None

    def import_request_pages(self, req: Request, payload,
                             ctx_len: Optional[int] = None) -> bool:
        """Adopt a migrated request by copying its pages into this pool —
        decode continues without prefix replay. Returns False (caller
        falls back to replay) when no slot, pages or budget are free, or
        the payload was cut at another page size. ``ctx_len`` is the
        context length at export time; tokens generated since are caught
        up through the decode step."""
        if not self.paged:
            return False
        first = next(_site_caches(payload))["pos"]
        if first.shape[2] != self.page_size:
            return False
        slot = next((i for i, r in enumerate(self._slots) if r is None),
                    None)
        if slot is None:
            return False
        nb = first.shape[1]
        if nb > self.pool.free_pages or \
                not self._page_budget_ok(req.tenant, nb):
            return False
        self._flush_scrub()
        pages = [self.pool.grow(slot, req.tenant) for _ in range(nb)]
        _import_pages(self.caches, payload, self._pages_dev(pages))
        toks = self._ctx_tokens(req)
        base = len(toks) if ctx_len is None else int(ctx_len)
        for off, t in enumerate(toks[base - 1:len(toks) - 1]):
            pos = base - 1 + off
            if pos // self.page_size >= len(self.pool.slot_blocks(slot)):
                if self.pool.free_pages >= 1 and \
                        self._page_budget_ok(req.tenant, 1):
                    self._flush_scrub()
                    self._invalidate_pages(
                        [self.pool.grow(slot, req.tenant)])
                else:
                    # can't cover the delta — roll the adoption back
                    self.pool.release_slot(slot)
                    return False
            self._step_single(slot, int(t), pos)
        self._slots[slot] = req
        sanitizer.emit("slot", (self._scope, slot), "occupy")
        _req_event(req, "adopt")
        self._pos[slot] = len(toks) - 1
        req._next_input = int(toks[-1])
        return True
