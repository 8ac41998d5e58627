"""The mesh steps as the reference's compiled programs, on 2 gloo ranks on
the CPU, where ``jit_train_step``'s program runs its in-place step eagerly
and ``jit_serve_step`` its step (on the card both are CUDA graphs bound to
the DTensors' local shards: tests/test_torch_cuda.py).

- the DTensor binding of ``core.graphs``: a DTensor keys by its local
  shard (address, shape, strides, dtype) and its ``Placed`` (mesh,
  placements, global shape and stride); a DTensor rebuilt on the same
  local shard by ``Placed.wrap`` keys the same; other placements, another
  shard, or deterministic algorithms switched on key apart; a graph's
  outputs map a bound DTensor, or a DTensor of its local shard and
  placements, back to the caller's own, and rebuild any other DTensor on
  its local shard (copied by ``fresh``);
- ``jit_train_step``'s in-place program against its functional mesh step
  (``step.functional``), bit for bit over 3 steps on meshes 2x1 and 1x2:
  every metric and state leaf, the caller's state returned, every local
  shard at its address;
- those losses within 1e-3 relative of the reference's ``jit_train_step``
  (JAX, a one-device CPU mesh) from the same state on the same batches,
  as tests/test_torch_train_steps.py holds the plain step;
- ``jit_serve_step``'s greedy tokens on the 1x2 mesh (caches length-
  sharded over "model") equal the reference's ``jit_serve_step`` on the
  same weights (carried by ``repro_torch.interop``), the reference's top-2
  margins asserted above ``torch_parity.MARGIN``.

The reference runs in the test process while the ranks run; a rank
(spawned) imports this module, which imports no JAX at its top.
"""
import datetime
import multiprocessing
import pickle
import time

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

WORLD = 2
STEPS = 3
MESHES = ((2, 1), (1, 2))
SERVE_MESH = (1, 2)
B, PROMPT, NEW = 4, 8, 6
OPT = dict(lr=2e-3, warmup_steps=2, total_steps=40)
KW = dict(dtype="float32", vocab_size=256, n_kv_heads=1)   # length-sharded
DEADLINE_S = 240


def _tag(shape):
    return f"{shape[0]}x{shape[1]}"


# ---------------------------------------------------------------------------
# The ranks (no JAX)
# ---------------------------------------------------------------------------

def binding_case(mesh):
    """The DTensor binding and output mapping of ``core.graphs`` on a
    (1, 2) mesh; returns {check: bool}."""
    from torch.distributed.tensor import Replicate

    from repro_torch.core import graphs
    from repro_torch.runtime.sharding import P, place
    cpu = torch.device("cpu")
    full = torch.arange(24.0).reshape(4, 6)
    x = place(full, mesh, P(None, "model"))
    local = x.to_local()
    leaves, key = graphs.binding(({"x": x}, 3), cpu)
    k = key[1][0]
    out = dict(
        leaf_is_caller=leaves[0] is x,
        key_local=k[:5] == ("bound", local.data_ptr(), local.shape,
                            local.stride(), local.dtype),
        key_placed=k[5] == graphs.Placed(mesh, tuple(x.placements), (4, 6),
                                         (6, 1)),
        value_kept=key[1][1] == ("value", int, 3))
    rewrap = k[5].wrap(x.to_local())
    out["rewrap_same_key"] = graphs.binding(({"x": rewrap}, 3), cpu)[1] \
        == key
    out["rewrap_same_value"] = torch.equal(rewrap.full_tensor(), full)
    other = place(full, mesh, P("model", None))
    out["placements_key_apart"] = graphs.binding(({"x": other}, 3),
                                                 cpu)[1] != key
    out["shard_key_apart"] = graphs.binding(({"x": place(
        full, mesh, P(None, "model"))}, 3), cpu)[1] != key
    torch.use_deterministic_algorithms(True)
    try:
        out["determinism_key_apart"] = graphs.binding(({"x": x}, 3),
                                                      cpu)[1] != key
    finally:
        torch.use_deterministic_algorithms(False)
    try:
        graphs.binding((x,), torch.device("meta"))
        out["other_device_refused"] = False
    except ValueError:
        out["other_device_refused"] = True
    # a graph's outputs: new, the caller's, a rewrap of the caller's shard,
    # the caller's values on other placements
    gathered = x.redistribute(mesh, [Replicate(), Replicate()])
    new = x * 2
    outs = graphs._graph_outputs((new, {"c": x, "r": rewrap}, gathered),
                                 [x], key[1])
    out["outputs_mapped"] = (
        isinstance(outs[0], graphs._Shard) and outs[1] == graphs._Arg(0)
        and outs[2] == graphs._Arg(0) and isinstance(outs[3], graphs._Shard))
    back = [graphs._output(o, [x], False) for o in outs]
    out["outputs_rebuilt"] = (
        back[1] is x and back[2] is x
        and back[0].placements == new.placements
        and back[0].to_local().data_ptr() == new.to_local().data_ptr()
        and torch.equal(back[3].full_tensor(), full)
        and back[3].placements == gathered.placements)
    kept = graphs._output(outs[0], [x], True)
    out["fresh_copies"] = (
        kept.to_local().data_ptr() != new.to_local().data_ptr()
        and torch.equal(kept.full_tensor(), new.full_tensor()))
    return out


def train_case(ref, mesh):
    """STEPS steps of jit_train_step's program and of its functional step
    from the reference's state; returns (what differs, the program's
    losses)."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.interop import train_state_from_numpy
    from repro_torch.models import get_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import TrainOpts, jit_train_step
    from repro_torch.runtime.sharding import place
    from repro_torch.tree import flatten, tree_map
    cfg = reduced(get_config("smollm-135m")).replace(**KW)
    model = get_model(cfg, device="cpu")
    opts = TrainOpts(opt=AdamWConfig(**OPT), loss_chunk=16)
    state = train_state_from_numpy(ref["state"], cfg)
    step, sspecs, _ = jit_train_step(model, mesh, opts, state,
                                     ref["batches"][0])
    functional = place(state, mesh, sspecs)
    mine = place(tree_map(torch.clone, state), mesh, sspecs)
    leaves = flatten(mine)[0]
    ptrs = [t.to_local().data_ptr() for t in leaves]
    bad, losses = [], []
    for i, batch in enumerate(ref["batches"]):
        functional, want = step.functional(functional, batch)
        got_state, got = step(mine, batch)
        if any(a is not b for a, b in zip(flatten(got_state)[0], leaves)):
            bad.append(f"step {i}: not the caller's state")
        bad += [f"metric {k} at step {i}" for k in want
                if not torch.equal(got[k], want[k])]
        losses.append(float(got["loss"]))
    bad += [f"leaf {j}" for j, (a, b) in enumerate(zip(
        flatten(functional)[0], leaves))
        if a.placements != b.placements
        or not torch.equal(a.to_local(), b.to_local())]
    if [t.to_local().data_ptr() for t in flatten(mine)[0]] != ptrs:
        bad.append("a local shard moved")
    if int(mine["step"].full_tensor()) != STEPS:
        bad.append("step")
    return bad, losses


def serve_case(ref, mesh):
    """Greedy tokens of the reference's prompts: a plain prefill, then
    NEW - 1 steps of jit_serve_step on ``mesh`` from the placed caches
    (tokens as tensors, positions as numpy)."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.interop import params_from_numpy
    from repro_torch.models import get_model
    from repro_torch.runtime import jit_serve_step, make_prefill_step
    from repro_torch.runtime.sharding import place, spec_of
    cfg = reduced(get_config("smollm-135m")).replace(**KW)
    model = get_model(cfg, device="cpu")
    params = params_from_numpy(ref["state"]["params"], cfg)
    h, caches = make_prefill_step(model, PROMPT + NEW)(
        params, {"tokens": torch.from_numpy(ref["prompts"])})
    tok = model.logits(params, h[:, -1:]).argmax(-1).to(torch.int32)
    step, specs = jit_serve_step(model, mesh, B, PROMPT + NEW, params, caches)
    mparams = place(params, mesh, specs["params"])
    mcaches = place(caches, mesh, specs["caches"])
    length = spec_of(mcaches[0]["k"])[2]
    pos = np.full((B,), PROMPT, np.int32)
    out = [tok[:, 0].tolist()]
    for _ in range(NEW - 1):
        logits, got = step(mparams, mcaches, tok, pos)
        assert got is mcaches
        tok = logits.full_tensor()[:, -1:].argmax(-1).to(torch.int32)
        out.append(tok[:, 0].tolist())
        pos = pos + 1
    return np.array(out).T, str(length)


def rank_main(rank: int, init_file: str, inputs: str, out_dir: str):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=WORLD, rank=rank,
                            timeout=datetime.timedelta(seconds=120))
    try:
        with open(inputs, "rb") as f:
            ref = pickle.load(f)
        meshes = {s: init_device_mesh("cpu", s,
                                      mesh_dim_names=("data", "model"))
                  for s in MESHES}
        out = {f"binding_{k}": v
               for k, v in binding_case(meshes[(1, 2)]).items()}
        for shape, mesh in meshes.items():
            bad, losses = train_case(ref, mesh)
            out[f"train_bad_{_tag(shape)}"] = np.array(bad, dtype=str)
            out[f"train_losses_{_tag(shape)}"] = np.array(losses)
        out["tokens"], out["cache_length_spec"] = serve_case(
            ref, meshes[SERVE_MESH])
        np.savez(f"{out_dir}/rank{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# The reference (JAX, in the test process)
# ---------------------------------------------------------------------------

def reference(inputs: str):
    """The JAX package's state, batches and prompts (pickled for the
    ranks), then its jit_train_step losses and jit_serve_step tokens on a
    one-device CPU mesh."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config, reduced
    from repro.data import DataConfig, DataPipeline
    from repro.launch.mesh import make_host_mesh
    from repro.models import get_model
    from repro.optim import AdamWConfig
    from repro.runtime import (TrainOpts, init_train_state, jit_serve_step,
                               jit_train_step, make_prefill_step)
    from torch_parity import assert_margins
    jmodel = get_model(reduced(get_config("smollm-135m")).replace(**KW))
    jopts = TrainOpts(opt=AdamWConfig(**OPT), loss_chunk=16)
    jstate = init_train_state(jmodel, jax.random.PRNGKey(0), jopts)
    data = DataPipeline(DataConfig(vocab_size=256, seq_len=32, batch_size=B))
    batches = [data.batch_at(i) for i in range(STEPS)]
    prompts = np.random.default_rng(3).integers(
        0, KW["vocab_size"], (B, PROMPT)).astype(np.int32)
    with open(inputs, "wb") as f:
        pickle.dump(dict(state=jax.tree.map(np.asarray, jstate),
                         batches=batches, prompts=prompts), f)
    yield                                       # the ranks start here
    mesh = make_host_mesh(1, 1)
    params = jax.tree.map(jnp.copy, jstate["params"])
    h, caches = jax.jit(make_prefill_step(jmodel, PROMPT + NEW))(
        params, {"tokens": jnp.asarray(prompts)})
    tok = jnp.argmax(jmodel.logits(params, h[:, -1:]), -1).astype(jnp.int32)
    step, _ = jit_serve_step(jmodel, mesh, B, PROMPT + NEW, params, caches)
    pos = jnp.full((B,), PROMPT, jnp.int32)
    tokens = [np.asarray(tok[:, 0])]
    for _ in range(NEW - 1):
        logits, caches = step(params, caches, tok, pos)
        tok = jnp.argmax(logits[:, -1:], -1).astype(jnp.int32)
        tokens.append(np.asarray(tok[:, 0]))
        pos = pos + 1
    tokens = np.stack(tokens, 1)
    assert_margins(jmodel, params, prompts, tokens[:, 1:], PROMPT + NEW)
    tstep, _, _ = jit_train_step(jmodel, mesh, jopts, jstate, batches[0])
    losses = []
    for batch in batches:
        jstate, m = tstep(jstate, batch)
        losses.append(float(m["loss"]))
    yield dict(tokens=tokens, losses=losses)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh_program")
    inputs = str(out / "inputs.pkl")
    ref = reference(inputs)
    next(ref)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=rank_main, args=(
        r, str(out / "rdv"), inputs, str(out))) for r in range(WORLD)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + DEADLINE_S
    try:
        want = next(ref)
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
    finally:
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.kill()
            p.join(10)
    assert not hung, f"{len(hung)} ranks still running after {DEADLINE_S} s"
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(WORLD)], want


CHECKS = ("leaf_is_caller", "key_local", "key_placed", "value_kept",
          "rewrap_same_key", "rewrap_same_value", "placements_key_apart",
          "shard_key_apart", "determinism_key_apart", "other_device_refused",
          "outputs_mapped", "outputs_rebuilt", "fresh_copies")


@pytest.mark.parametrize("check", CHECKS)
def test_dtensor_binding(world, check):
    ranks, _ = world
    assert all(bool(r[f"binding_{check}"]) for r in ranks)


@pytest.mark.parametrize("shape", MESHES, ids=_tag)
def test_inplace_program_equals_functional_mesh_step(world, shape):
    ranks, _ = world
    for r in ranks:
        assert r[f"train_bad_{_tag(shape)}"].size == 0, \
            r[f"train_bad_{_tag(shape)}"]
        np.testing.assert_array_equal(r[f"train_losses_{_tag(shape)}"],
                                      ranks[0][f"train_losses_{_tag(shape)}"])


@pytest.mark.parametrize("shape", MESHES, ids=_tag)
def test_mesh_train_losses_track_reference(world, shape):
    ranks, want = world
    got = ranks[0][f"train_losses_{_tag(shape)}"]
    np.testing.assert_allclose(got, want["losses"], rtol=1e-3)
    assert got[-1] < got[0]


def test_mesh_serve_tokens_equal_reference(world):
    ranks, want = world
    for r in ranks:
        assert str(r["cache_length_spec"]) == "model"
        np.testing.assert_array_equal(r["tokens"], want["tokens"])
