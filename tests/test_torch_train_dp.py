"""Data-parallel training on 8 gloo processes on the CPU
(tests/test_multidevice.py's compressed DP case mirrored): each rank takes
its rows of the global batch and the gradients are averaged by the int8
all-gather with error feedback or by an fp32 all-reduce.

- the compressed loss falls and tracks the uncompressed within the
  reference's 0.25 x the first uncompressed loss;
- the uncompressed 8-rank losses equal the one-process ``make_train_step``
  on the same global batches within 1e-4 relative;
- the 8-rank compressed mean (and each rank's residual) of seeded
  per-rank gradient trees over three rounds equals the reference's
  ``compressed_psum`` on 8 forced host devices within 1e-6.

The ranks rendezvous through a ``file://`` in ``tmp_path`` (test workers
run side by side, so a fixed port would collide); every spawned process
and subprocess has a deadline, so a hung rendezvous fails the test. A
rank (``run``, spawned) imports this module, which imports no JAX; the
reference runs in its own subprocess.
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

STEPS = 8


def grad_tree(rank: int, rnd: int):
    """The seeded gradient tree of ``rank`` at round ``rnd`` (the JAX
    side builds the same arrays)."""
    rng = np.random.default_rng((rank, rnd))
    return {"w": rng.standard_normal((16, 8)).astype(np.float32),
            "b": rng.standard_normal(8).astype(np.float32),
            "blk": ({"a": (3 * rng.standard_normal(32)).astype(np.float32)},)}


def train(compress: bool, steps: int = STEPS, group=None):
    """Losses of ``steps`` data-parallel steps (``group`` None) or, with
    ``group`` False, of the one-process step on the same global batches."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.data import DataConfig, DataPipeline
    from repro_torch.models import get_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import (TrainOpts, init_train_state,
                                     make_dp_train_step, make_train_step)
    cfg = reduced(get_config("smollm-135m")).replace(dtype="float32",
                                                     vocab_size=256)
    model = get_model(cfg, device="cpu")
    opts = TrainOpts(opt=AdamWConfig(lr=2e-3, warmup_steps=2,
                                     total_steps=40),
                     loss_chunk=16, compress_grads=compress)
    state = init_train_state(model, torch.Generator().manual_seed(0), opts)
    step = make_train_step(model, opts) if group is False \
        else make_dp_train_step(model, group, opts)
    data = DataPipeline(DataConfig(vocab_size=256, seq_len=32,
                                   batch_size=8))
    losses = []
    for i in range(steps):
        state, m = step(state, data.batch_at(i))
        losses.append(float(m["loss"]))
    return losses


def run(rank: int, world: int, init_file: str, out_dir: str):
    """One rank of the gloo world (a spawned process): trains compressed
    and not, runs three rounds of ``compressed_psum`` over its seeded
    gradient trees, and writes ``<out_dir>/rank<r>.npz``."""
    from repro_torch.optim.compress import compressed_psum
    from repro_torch.tree import flatten, tree_map
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=120))
    try:
        out = {"compressed": train(True), "uncompressed": train(False)}
        res = tree_map(torch.zeros_like,
                       tree_map(torch.from_numpy, grad_tree(rank, 0)))
        for rnd in range(3):
            mean, res = compressed_psum(
                tree_map(torch.from_numpy, grad_tree(rank, rnd)), res)
            for i, t in enumerate(flatten(mean)[0]):
                out[f"mean{rnd}_{i}"] = t.numpy()
            for i, t in enumerate(flatten(res)[0]):
                # a copy: compressed_psum writes the residuals in place
                out[f"res{rnd}_{i}"] = t.numpy().copy()
        np.savez(f"{out_dir}/rank{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


WORLD = 8
DEADLINE_S = 300
ROOT = os.path.join(os.path.dirname(__file__), "..")


@pytest.fixture(scope="module")
def dp_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("dp")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=run, args=(
        r, WORLD, str(out / "rendezvous"), str(out))) for r in range(WORLD)]
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
    assert all(p.exitcode == 0 for p in procs), \
        [p.exitcode for p in procs]
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(WORLD)]


def test_compressed_dp_loss_falls_and_tracks_uncompressed(dp_run):
    lc = dp_run[0]["compressed"]
    lu = dp_run[0]["uncompressed"]
    for r in dp_run[1:]:                   # metrics averaged over the group
        np.testing.assert_array_equal(r["compressed"], lc)
        np.testing.assert_array_equal(r["uncompressed"], lu)
    assert lc[-1] < lc[0], lc
    assert abs(lc[-1] - lu[-1]) < 0.25 * lu[0], (lc[-1], lu[-1])


def test_uncompressed_dp_equals_one_process(dp_run):
    single = train(False, group=False)
    np.testing.assert_allclose(dp_run[0]["uncompressed"], single, rtol=1e-4)


def test_compressed_mean_matches_reference_on_8_devices(dp_run, tmp_path):
    code = textwrap.dedent(f"""
        import os
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
        import sys
        sys.path.insert(0, "tests")
        import jax, jax.numpy as jnp, numpy as np
        from jax.sharding import Mesh, PartitionSpec as P
        from repro.optim.compress import compressed_psum
        from repro.runtime.sharding import shard_map
        from test_torch_train_dp import grad_tree
        mesh = Mesh(np.array(jax.devices()[:8]), ("data",))

        def stacked(rnd):
            trees = [grad_tree(r, rnd) for r in range(8)]
            return jax.tree.map(lambda *xs: jnp.stack(xs), *trees)

        spec = jax.tree.map(lambda _: P("data"), grad_tree(0, 0))
        # not jitted (XLA would fuse the residual's multiply-subtract)
        fn = shard_map(lambda g, r: compressed_psum(g, r, "data"), mesh,
                       in_specs=(spec, spec), out_specs=(spec, spec))
        res = jax.tree.map(jnp.zeros_like, stacked(0))
        out = {{}}
        for rnd in range(3):
            mean, res = fn(stacked(rnd), res)
            for i, x in enumerate(jax.tree.leaves(mean)):
                out[f"mean{{rnd}}_{{i}}"] = np.asarray(x)
            for i, x in enumerate(jax.tree.leaves(res)):
                out[f"res{{rnd}}_{{i}}"] = np.asarray(x)
        np.savez("{tmp_path}/ref.npz", **out)
    """)
    env = dict(os.environ, PYTHONPATH="src")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=ROOT, timeout=DEADLINE_S)
    assert proc.returncode == 0, proc.stderr[-2500:]
    ref = np.load(tmp_path / "ref.npz")
    keys = [k for k in ref.files if k.startswith(("mean", "res"))]
    assert len(keys) == 3 * 2 * 3
    for k in keys:
        for r, got in enumerate(dp_run):
            np.testing.assert_allclose(got[k], ref[k][r], atol=1e-6,
                                       err_msg=f"{k} rank {r}")
