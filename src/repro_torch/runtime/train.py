"""Training step factories (the reference's ``runtime/train.py``).

``make_train_step``    — one process: gradients by autograd over the
                         parameter leaves, microbatch accumulation (the
                         reference's ``lax.scan`` over ``_split_micro``) and
                         optional remat, then AdamW.
``make_dp_train_step`` — explicit data parallelism over a
                         ``torch.distributed`` group: each rank takes its
                         rows of the global batch, and the gradients are
                         averaged by an fp32 all-reduce or by the int8
                         all-gather with error feedback
                         (``optim.compress.compressed_psum``).

TrainState is the reference's plain dict: {params, opt_state: {mu, nu,
count}, step[, residuals]}. A step returns (new_state, metrics {loss, xent,
aux, grad_norm, lr}); the metrics are 0-d tensors on the state's device and
the step syncs nothing with the host, as the reference's jitted step.
Gradients come from ``torch.autograd.grad`` over the flattened parameter
leaves (``torch.func`` transforms are not used: they need not compose with
the non-reentrant ``torch.utils.checkpoint`` that remat and the chunked
loss use).

``jit_train_step`` binds the step to a ``DeviceMesh``: the state is placed
as DTensors by the sharding rules (``runtime.sharding``), the global batch
is placed by ``batch_specs``, and the step runs on DTensors under
``implicit_replication`` (tensors made inside the model count as
replicated). Its gradients take the parameters' placements and AdamW is
written into the state's own DTensors (the reference's donated state).

``train_program`` / ``dp_train_program`` / ``jit_train_step`` are the
counterparts of the reference's compiled steps
(``jax.jit(make_train_step(...))``, ``make_dp_train_step``'s
``jax.jit(step)``, the mesh step's ``jax.jit(..., donate_argnums=(0,))``):
the in-place steps (``make_inplace_train_step``,
``make_inplace_dp_train_step``, the mesh step: the same gradients, then
AdamW and the error-feedback residuals written into the state's own
tensors), run on the card as one CUDA graph a binding of their arguments
(``core.graphs``; a mesh state binds by its local shards) and on the CPU
eagerly. ``make_train_step`` and ``make_dp_train_step`` stay functional
and eager: the dry run and the parity tests use them, and the mesh
program keeps its functional step as ``functional``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core.graphs import GraphProgram, InputBuffers
from repro_torch.models.api import Model
from repro_torch.optim.adamw import (AdamWConfig, adamw_update,
                                     adamw_update_, init_opt_state)
from repro_torch.optim.compress import compressed_psum, init_residuals
from repro_torch.runtime.losses import chunked_xent
from repro_torch.tree import flatten, tree_map, unflatten


@dataclasses.dataclass(frozen=True)
class TrainOpts:
    opt: AdamWConfig = AdamWConfig()
    microbatches: int = 1          # gradient-accumulation splits
    remat: bool = False
    loss_chunk: int = 512
    aux_weight: float = 0.001      # MoE load-balance weight
    compress_grads: bool = False   # int8 DP exchange (make_dp_train_step)


def make_loss_fn(model: Model, opts: TrainOpts):
    cfg = model.cfg

    def loss_fn(params, batch):
        h, aux = model.forward(params, batch, remat=opts.remat)
        loss = chunked_xent(cfg, params, h, batch["labels"],
                            chunk=opts.loss_chunk)
        return loss + opts.aux_weight * aux, {"xent": loss, "aux": aux}

    return loss_fn


def init_train_state(model: Model, generator: torch.Generator,
                     opts: Optional[TrainOpts] = None):
    opts = opts if opts is not None else TrainOpts()
    params = model.init(generator)
    state = {"params": params, "opt_state": init_opt_state(params),
             "step": torch.zeros((), dtype=torch.int32, device=model.dev)}
    if opts.compress_grads:
        state["residuals"] = init_residuals(params)
    return state


def _batch_to(batch, device):
    """Numpy arrays (the data pipeline's) or tensors -> tensors on
    ``device``."""
    return {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
            .to(device) for k, v in batch.items()}


def _value_and_grad(loss_fn, params, batch):
    """(loss, metrics, grads): the gradient of ``loss_fn`` with respect to
    every parameter leaf (zeros for a leaf the loss does not reach)."""
    flat, spec = flatten(params)
    leaves = [p.detach().requires_grad_(True) for p in flat]
    with torch.enable_grad():
        loss, metrics = loss_fn(unflatten(spec, leaves), batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for g, p in zip(grads, leaves)]
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
        unflatten(spec, grads)


def _apply(opts: TrainOpts, state, grads, loss, metrics, **extra):
    new_params, new_opt, om = adamw_update(
        opts.opt, grads, state["opt_state"], state["params"])
    new_state = dict(state, params=new_params, opt_state=new_opt,
                     step=state["step"] + 1, **extra)
    return new_state, {"loss": loss, **metrics, **om}


def _apply_(opts: TrainOpts, state, grads, loss, metrics):
    """``_apply`` in place: AdamW writes the state's parameters and
    moments, and ``step`` and ``count`` advance by ``add_``. Returns the
    caller's own state."""
    om = adamw_update_(opts.opt, grads, state["opt_state"], state["params"])
    state["step"].add_(1)
    return state, {"loss": loss, **metrics, **om}


def _grads_fn(model: Model, opts: TrainOpts):
    """``(params, batch) -> (loss, metrics, grads)`` of the global batch:
    with ``opts.microbatches`` > 1, accumulated over the microbatches as
    the reference's ``lax.scan`` over ``_split_micro``."""
    loss_fn = make_loss_fn(model, opts)
    n = opts.microbatches

    def grads_of(params, batch):
        if n == 1:
            return _value_and_grad(loss_fn, params, batch)
        # (B, ...) -> n slices of B/n rows, accumulated in fp32 from zeros
        # in order, as the reference's scan
        gsum = tree_map(lambda p: torch.zeros(
            p.shape, dtype=torch.float32, device=p.device), params)
        lsum = torch.zeros((), dtype=torch.float32, device=model.dev)
        ms = []
        for i in range(n):
            mb = {k: v.reshape((n, v.shape[0] // n) + v.shape[1:])[i]
                  for k, v in batch.items()}
            l, m, g = _value_and_grad(loss_fn, params, mb)
            gsum = tree_map(torch.add, gsum, g)
            lsum = lsum + l
            ms.append(m)
        metrics = {k: torch.mean(torch.stack([m[k] for m in ms]))
                   for k in ms[0]}
        return lsum / n, metrics, tree_map(lambda g: g / n, gsum)

    return grads_of


def _constrained(grads, grad_specs):
    """``grads`` constrained to the spec tree ``grad_specs``
    (``sharding.constrain``; None, or plain tensors: unchanged)."""
    if grad_specs is None:
        return grads
    from repro_torch.runtime.sharding import constrain, is_spec
    flat_s = flatten(grad_specs, is_spec)[0]
    flat_g, spec = flatten(grads)
    return unflatten(spec, [constrain(g, s) for g, s in zip(flat_g, flat_s)])


def make_train_step(model: Model, opts: Optional[TrainOpts] = None,
                    grad_specs=None):
    """One-process train step: ``train_step(state, batch) -> (state,
    metrics)``. ``batch``: numpy arrays or tensors, the global batch.

    ``grad_specs``: optional spec tree (usually the ZeRO-1 optimizer-state
    specs) the gradients are constrained to before the update
    (``sharding.constrain``; a no-op on plain tensors)."""
    opts = opts if opts is not None else TrainOpts()
    grads_of = _grads_fn(model, opts)

    def train_step(state, batch):
        loss, metrics, grads = grads_of(state["params"],
                                        _batch_to(batch, model.dev))
        return _apply(opts, state, _constrained(grads, grad_specs), loss,
                      metrics)

    return train_step


def make_inplace_train_step(model: Model, opts: Optional[TrainOpts] = None):
    """``make_train_step`` in place: ``step(state, batch) -> (state,
    metrics)`` computes the same gradients, writes AdamW's update into the
    state's tensors and returns the caller's own state (the reference's
    donated buffers)."""
    opts = opts if opts is not None else TrainOpts()
    grads_of = _grads_fn(model, opts)

    def train_step(state, batch):
        loss, metrics, grads = grads_of(state["params"],
                                        _batch_to(batch, model.dev))
        return _apply_(opts, state, grads, loss, metrics)

    return train_step


class TrainProgram:
    """An in-place training step as the reference's compiled step:
    ``program(state, batch) -> (state, metrics)`` updates ``state`` in
    place and returns it (the caller's own tensors) with metrics the caller
    may keep.

    On the card the step runs as a ``GraphProgram``: its first call for a
    binding of the state's tensors runs the step eagerly, then captures it
    (the eager run's cached blocks are released first: a training step's
    activations are a large share of the card), and every later call
    replays the graph. On the CPU the same step runs eagerly.

    A graph is bound to its arguments' addresses, so the batch is first
    copied into fixed buffers, one set a batch shape: a host batch (numpy
    arrays, the data pipeline's) through pinned memory, a batch already on
    the device (a ``StreamFIFO``'s new blocks) by a copy on the device.
    ``graphs`` is the ``GraphProgram`` (None on the CPU)."""

    def __init__(self, step, device, name: str):
        self.step = step
        self.device = torch.device(device)
        self.graphs = None
        if self.device.type == "cuda":
            self.graphs = GraphProgram(step, self.device, name=name,
                                       release_cache=True)
            self.device = self.graphs.device        # with its index
        self._inputs = InputBuffers(self.device)

    def __call__(self, state, batch):
        batch = self.into_buffers(batch)
        if self.graphs is None:
            return self.step(state, batch)
        return self.graphs.fresh(state, batch)

    def into_buffers(self, batch) -> dict:
        """``batch`` copied into the buffers of its shape (made at that
        shape's first batch); returns the buffers."""
        return self._inputs.into(batch)


def train_program(model: Model, opts: Optional[TrainOpts] = None) \
        -> TrainProgram:
    """The one-process training program: ``make_inplace_train_step`` as
    a ``TrainProgram`` on the model's device (the reference's
    ``jax.jit(make_train_step(model, opts))``)."""
    return TrainProgram(make_inplace_train_step(model, opts), model.dev,
                        name="train_step")


def jit_train_step(model: Model, mesh, opts: TrainOpts, state_shape,
                   batch_shape):
    """The train step over ``mesh`` (a ``DeviceMesh``): returns (step,
    state_specs, bspecs) as the reference. ``step(state, batch)`` takes a
    state placed by ``state_specs`` (``sharding.place``) and a global
    batch (numpy arrays or tensors), places the batch by ``bspecs``,
    writes AdamW's update into the state's own DTensors (their placements
    unchanged: the reference's ``donate_argnums=(0,)``) and returns the
    caller's state with metrics as plain 0-d tensors. The caller does not
    read a state after passing it, as the donation forbids.

    ``step`` is a ``TrainProgram``: on a CUDA mesh one CUDA graph a
    binding, bound to the state's local shards and to the batch buffers
    (the batch is copied in and placed inside the graph), and on any
    other mesh the same in-place step, eagerly. ``step.step`` is that
    in-place step called directly (eagerly, on any mesh), and
    ``step.functional`` the functional mesh step, which returns a new
    state and leaves its input as it was (``make_train_step`` on the
    DTensors); both take the same arguments."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.runtime.sharding import (P, _full, batch_specs,
                                              constrain, is_spec,
                                              param_specs, place)
    pspecs = param_specs(model.cfg, state_shape["params"], mesh)
    opt_specs = {"mu": pspecs, "nu": pspecs, "count": P()}
    state_specs = {"params": pspecs, "opt_state": opt_specs, "step": P()}
    if "residuals" in state_shape:
        state_specs["residuals"] = pspecs
    bspecs = batch_specs(model.cfg, batch_shape, mesh)
    # the gradients take their parameters' placements before the update,
    # so that AdamW writes each leaf where it lies
    inner = make_train_step(model, opts, grad_specs=pspecs)
    opts = opts if opts is not None else TrainOpts()
    grads_of = _grads_fn(model, opts)

    def functional(state, batch):
        batch = place(_batch_to(batch, model.dev), mesh, bspecs)
        with implicit_replication():
            new_state, metrics = inner(state, batch)
        new_state = tree_map(lambda t, s: constrain(t, s, mesh), new_state,
                             state_specs, is_leaf=is_spec)
        return new_state, {k: _full(v) for k, v in metrics.items()}

    def mesh_train_step(state, batch):
        batch = place(_batch_to(batch, model.dev), mesh, bspecs)
        with implicit_replication():
            loss, metrics, grads = grads_of(state["params"], batch)
            state, metrics = _apply_(opts, state,
                                     _constrained(grads, pspecs), loss,
                                     metrics)
        return state, {k: _full(v) for k, v in metrics.items()}

    program = TrainProgram(mesh_train_step,
                           getattr(mesh, "device_type", "cpu"),
                           name="mesh_train_step")
    program.functional = functional
    return program, state_specs, bspecs


# ---------------------------------------------------------------------------
# Explicit-DP path with compressed gradient exchange
# ---------------------------------------------------------------------------

def _all_reduce_mean(tensors, group, n: int):
    import torch.distributed as dist
    out = []
    for t in tensors:
        t = t.clone()
        dist.all_reduce(t, group=group)
        out.append(t / n)
    return out


def _dp_step(model: Model, group, opts: Optional[TrainOpts],
             inplace: bool):
    import torch.distributed as dist
    opts = opts if opts is not None else TrainOpts()
    loss_fn = make_loss_fn(model, opts)

    def step(state, batch):
        n, rank = dist.get_world_size(group), dist.get_rank(group)
        rows = {v.shape[0] for v in batch.values()}.pop()
        if rows % n:
            raise ValueError(f"global batch of {rows} rows does not split "
                             f"over {n} ranks")
        lo, hi = rank * (rows // n), (rank + 1) * (rows // n)
        local = _batch_to({k: v[lo:hi] for k, v in batch.items()},
                          model.dev)
        loss, metrics, grads = _value_and_grad(loss_fn, state["params"],
                                               local)
        extra = {}
        if opts.compress_grads:
            res = state["residuals"] if inplace \
                else tree_map(torch.clone, state["residuals"])
            grads, extra["residuals"] = compressed_psum(grads, res, group)
        else:
            flat, spec = flatten(grads)
            grads = unflatten(spec, _all_reduce_mean(flat, group, n))
        keys = sorted(metrics)
        means = _all_reduce_mean(
            [torch.stack([loss] + [metrics[k] for k in keys])], group, n)[0]
        loss, metrics = means[0], dict(zip(keys, means[1:]))
        if inplace:
            return _apply_(opts, state, grads, loss, metrics)
        return _apply(opts, state, grads, loss, metrics, **extra)

    return step


def make_dp_train_step(model: Model, group=None,
                       opts: Optional[TrainOpts] = None):
    """Data-parallel step over ``group`` (the default group when None):
    ``step(state, global_batch) -> (state, metrics)``. Every rank holds
    the same parameters and optimiser state and takes its rows of the
    global batch (the reference's ``shard_map`` over the data axis);
    gradients are averaged through ``compressed_psum`` when
    ``opts.compress_grads`` (each rank keeps its own residuals), else by
    an fp32 all-reduce mean; loss and metrics are averaged over the
    group."""
    return _dp_step(model, group, opts, inplace=False)


def make_inplace_dp_train_step(model: Model, group=None,
                               opts: Optional[TrainOpts] = None):
    """``make_dp_train_step`` in place: AdamW and the error-feedback
    residuals are written into the state's tensors, and the caller's own
    state is returned."""
    return _dp_step(model, group, opts, inplace=True)


def dp_train_program(model: Model, group=None,
                     opts: Optional[TrainOpts] = None) -> TrainProgram:
    """The data-parallel training program (the reference's
    ``make_dp_train_step``, which returns ``jax.jit(step)``):
    ``make_inplace_dp_train_step`` as a ``TrainProgram``. On NCCL its
    collectives are captured with the step (the fp32 all-reduce; the int8
    all-gather with error feedback); the communicator is made by the
    eager first call, before any capture. On gloo (the CPU) it runs
    eagerly."""
    return TrainProgram(make_inplace_dp_train_step(model, group, opts),
                        model.dev, name="dp_train_step")
