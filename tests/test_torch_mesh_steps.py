"""The mesh steps on gloo process groups on the CPU: ``jit_train_step``
(8 ranks, meshes 8x1 and 4x2, reduced smollm and reduced qwen3-moe),
``jit_serve_step`` (4 ranks, a 2x2 mesh, reduced smollm and reduced
mamba2) and the elastic shrink (tests/test_multidevice.py's case
mirrored: 8 ranks train 5 steps and save; a 4-rank world restores,
reshards and trains 5 more).

- the 8-rank losses equal the one-process ``make_train_step`` on the same
  global batches within 1e-4 relative, and every rank's local leaf shapes
  are those its specs give;
- the 2x2 greedy tokens equal the one-process ``make_serve_step``'s;
- after the shrink the loss keeps falling, the step is 10, and the
  restored state equals the saved leaves;
- each of the 8 ranks' local shard of a seeded (8, 12, 16) tensor under
  P(("pod", "data"), "model") and P(None, ("data", "model")) on a 2x2x2
  mesh equals the JAX shard of the same device index on 8 forced host
  devices (the reference runs in a subprocess).

Each world rendezvouses through a ``file://`` in ``tmp_path``; every
spawned process has a deadline. A rank (spawned) imports this module,
which imports no JAX.
"""
import datetime
import multiprocessing
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

torch.set_num_threads(1)

STEPS = 5
DEADLINE_S = 300
TRAIN_CASES = [("smollm-135m", (8, 1)), ("smollm-135m", (4, 2)),
               ("qwen3-moe-30b-a3b", (8, 1)), ("qwen3-moe-30b-a3b", (4, 2))]
SERVE_ARCHS = ("smollm-135m", "mamba2-370m")
SERVE_B, PROMPT, NEW = 4, 8, 6
SHARD_SPECS = ((("pod", "data"), "model"), (None, ("data", "model")))


def seeded_block():
    return np.random.default_rng(7).standard_normal((8, 12, 16)) \
        .astype(np.float32)


def _cfg(arch):
    from repro_torch.configs import get_config, reduced
    return reduced(get_config(arch)).replace(dtype="float32", vocab_size=256)


def _opts():
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import TrainOpts
    return TrainOpts(opt=AdamWConfig(lr=2e-3, warmup_steps=2,
                                     total_steps=40), loss_chunk=16)


def _data():
    from repro_torch.data import DataConfig, DataPipeline
    return DataPipeline(DataConfig(vocab_size=256, seq_len=32, batch_size=8))


def _state(model):
    from repro_torch.runtime import init_train_state
    return init_train_state(model, torch.Generator().manual_seed(0), _opts())


def one_process_losses(arch, steps=STEPS, start=0):
    from repro_torch.models import get_model
    from repro_torch.runtime import make_train_step
    model = get_model(_cfg(arch), device="cpu")
    state, step, data = _state(model), make_train_step(model, _opts()), \
        _data()
    losses = []
    for i in range(start, start + steps):
        state, m = step(state, data.batch_at(i))
        losses.append(float(m["loss"]))
    return losses


def _local_shape(shape, spec, sizes):
    out = list(shape)
    for i, part in enumerate(spec):
        for a in (part if isinstance(part, tuple) else (part,)):
            if a is not None:
                out[i] //= sizes[a]
    return tuple(out)


def mesh_train(arch, shape, steps=STEPS, state=None, start=0):
    """Losses of ``steps`` jit_train_step steps on a (data, model) mesh of
    the whole world, whether every leaf's local shape is its specs', and
    the final state."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.models import get_model
    from repro_torch.runtime import jit_train_step
    from repro_torch.runtime.sharding import axis_sizes, is_spec, place
    from repro_torch.tree import flatten
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
    model = get_model(_cfg(arch), device="cpu")
    data = _data()
    like = _state(model) if state is None else state
    step, sspecs, _ = jit_train_step(model, mesh, _opts(), like,
                                     data.batch_at(0))
    if state is None:
        state = place(like, mesh, sspecs)
    losses = []
    for i in range(start, start + steps):
        state, m = step(state, data.batch_at(i))
        losses.append(float(m["loss"]))
    sizes = axis_sizes(mesh)
    ok = all(tuple(t.to_local().shape) == _local_shape(t.shape, s, sizes)
             for t, s in zip(flatten(state)[0], flatten(sspecs, is_spec)[0]))
    return losses, ok, state, sspecs


def serve_tokens(arch, mesh=None):
    """Greedy tokens of SERVE_B prompts: a plain prefill, then NEW decode
    steps through jit_serve_step on ``mesh`` (None: make_serve_step in one
    process)."""
    from repro_torch.models import get_model
    from repro_torch.runtime import (jit_serve_step, make_prefill_step,
                                     make_serve_step)
    from repro_torch.runtime.sharding import place
    cfg = _cfg(arch)
    model = get_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    if cfg.ssm is not None:       # the reference's gate-norm init is 0
        for st in params["stages"]:
            for blk in (st if isinstance(st, tuple) else (st,)):
                if "ssm" in blk:
                    blk["ssm"]["norm"].fill_(1.0)
    prompts = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (SERVE_B, PROMPT)).astype(np.int32))
    max_len = PROMPT + NEW
    h, caches = make_prefill_step(model, max_len)(params, {"tokens": prompts})
    tok = model.logits(params, h[:, -1:]).argmax(-1).to(torch.int32)
    pos = torch.full((SERVE_B,), PROMPT, dtype=torch.int32)
    if mesh is None:
        step = make_serve_step(model)
    else:
        step, specs = jit_serve_step(model, mesh, SERVE_B, max_len, params,
                                     caches)
        params = place(params, mesh, specs["params"])
        caches = place(caches, mesh, specs["caches"])
    out = [tok[:, 0].tolist()]
    for _ in range(NEW - 1):
        logits, caches = step(params, caches, tok, pos)
        if mesh is not None:
            logits = logits.full_tensor()
        tok = logits[:, -1:].argmax(-1).to(torch.int32)
        out.append(tok[:, 0].tolist())
        pos = pos + 1
    return out


def _init(rank, world, init_file):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=120))


def run8(rank: int, init_file: str, out_dir: str):
    """The 8-rank world: every train case, then the elastic run's first
    half (the smollm 8x1 state saved at step 5)."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.ckpt import save
    from repro_torch.runtime.sharding import P, place
    _init(rank, 8, init_file)
    try:
        out = {}
        cube = init_device_mesh("cpu", (2, 2, 2),
                                mesh_dim_names=("pod", "data", "model"))
        for i, spec in enumerate(SHARD_SPECS):
            out[f"shard{i}"] = place(torch.from_numpy(seeded_block()), cube,
                                     P(*spec)).to_local().numpy()
        for i, (arch, shape) in enumerate(TRAIN_CASES):
            losses, ok, state, _ = mesh_train(arch, shape)
            out[f"losses{i}"], out[f"shapes_ok{i}"] = losses, ok
            if (arch, shape) == ("smollm-135m", (8, 1)):
                save(state, f"{out_dir}/ckpt", step=STEPS)
        np.savez(f"{out_dir}/rank{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


def run4(rank: int, init_file: str, out_dir: str):
    """The 4-rank world: restore the 8-rank state, reshard it onto a 4x1
    mesh and train 5 more steps; then the 2x2 serve runs."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.ckpt import reshard, restore
    from repro_torch.models import get_model
    from repro_torch.runtime.sharding import P
    from repro_torch.tree import flatten, tree_map
    _init(rank, 4, init_file)
    try:
        out = {}
        model = get_model(_cfg("smollm-135m"), device="cpu")
        restored, at = restore(f"{out_dir}/ckpt", _state(model))
        saved = [t.clone() for t in flatten(restored)[0]]
        small = init_device_mesh("cpu", (4, 1),
                                 mesh_dim_names=("data", "model"))
        moved = reshard(restored, small, tree_map(
            lambda t: P(*([None] * t.ndim)), restored))
        out["restored_equal"] = all(
            torch.equal(a, b.full_tensor())
            for a, b in zip(saved, flatten(moved)[0]))
        losses, _, state, _ = mesh_train("smollm-135m", (4, 1),
                                         state=moved, start=at)
        out["at"], out["losses"] = at, losses
        out["step"] = int(state["step"].full_tensor())
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        for arch in SERVE_ARCHS:
            out[f"tokens_{arch}"] = serve_tokens(arch, mesh)
        np.savez(f"{out_dir}/rank{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


def spawn(target, world: int, out):
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=target, args=(r, str(out / "rdv"), str(out)))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + DEADLINE_S
    try:
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
    finally:
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.kill()
            p.join(10)
    assert not hung, f"{len(hung)} ranks still running after {DEADLINE_S} s"
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(world)]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh")
    eight = spawn(run8, 8, out)
    (out / "rdv").unlink(missing_ok=True)
    four = spawn(run4, 4, out)
    return eight, four


@pytest.mark.parametrize("case", range(len(TRAIN_CASES)),
                         ids=[f"{a}-{d}x{m}" for a, (d, m) in TRAIN_CASES])
def test_jit_train_step_tracks_one_process(worlds, case):
    eight, _ = worlds
    arch, _ = TRAIN_CASES[case]
    for r in eight:
        assert bool(r[f"shapes_ok{case}"])
        np.testing.assert_array_equal(r[f"losses{case}"],
                                      eight[0][f"losses{case}"])
    np.testing.assert_allclose(eight[0][f"losses{case}"],
                               one_process_losses(arch), rtol=1e-4)


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_jit_serve_step_tokens_equal_one_process(worlds, arch):
    _, four = worlds
    want = serve_tokens(arch)
    for r in four:
        assert r[f"tokens_{arch}"].tolist() == want


def test_elastic_shrink_continues_the_state(worlds):
    eight, four = worlds
    first = eight[0]["losses0"]                   # smollm 8x1, steps 0-4
    r = four[0]
    assert int(r["at"]) == STEPS and int(r["step"]) == 2 * STEPS
    assert all(bool(x["restored_equal"]) for x in four)
    losses = list(first) + list(r["losses"])
    assert losses[-1] < losses[0], losses
    # the continued run is the one-process run's steps 5-9
    np.testing.assert_allclose(losses, one_process_losses(
        "smollm-135m", 2 * STEPS), rtol=1e-4)


def test_local_shards_equal_jax_shards(worlds, tmp_path):
    eight, _ = worlds
    code = textwrap.dedent(f"""
        import os, sys
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
        sys.path.insert(0, "tests")
        import jax, numpy as np
        from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
        from test_torch_mesh_steps import SHARD_SPECS, seeded_block
        mesh = Mesh(np.array(jax.devices()).reshape(2, 2, 2),
                    ("pod", "data", "model"))
        out = {{}}
        for i, spec in enumerate(SHARD_SPECS):
            arr = jax.device_put(seeded_block(), NamedSharding(mesh, P(*spec)))
            for sh in arr.addressable_shards:
                out[f"shard{{i}}_{{sh.device.id}}"] = np.asarray(sh.data)
        np.savez("{tmp_path}/ref.npz", **out)
    """)
    root = os.path.join(os.path.dirname(__file__), "..")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=root, timeout=DEADLINE_S,
                          env=dict(os.environ, PYTHONPATH="src",
                                   JAX_PLATFORMS="cpu"))
    assert proc.returncode == 0, proc.stderr[-2500:]
    ref = np.load(tmp_path / "ref.npz")
    for i in range(len(SHARD_SPECS)):
        for r, got in enumerate(eight):
            np.testing.assert_array_equal(got[f"shard{i}"],
                                          ref[f"shard{i}_{r}"])
