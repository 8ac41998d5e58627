"""Caches whose length the rules shard, on a 2-rank gloo world (a 1x2
(data, model) mesh) on the CPU.

``cache_specs`` shards a cache's length over "model" where its kv heads do
not divide that axis (smollm-135m's 3 kv heads on any even model axis), and
its positions always. On such caches:

- ``fill_kv_cache`` (a prefill's write, ring included) and an int8 cache's
  write leave every leaf equal, bit for bit, to the plain fill of the same
  cache: a write that falls outside a rank's shard changes nothing there;
- a prefill on the mesh (reduced smollm with one kv head) fills caches
  whose positions equal the one-process prefill's and whose k/v agree
  within 1e-5 (the model-sharded products sum in another order);
- ``jit_serve_step``'s decode over them goes through the decode kernel's
  wrapper (``ops.decode_attention``; its plain version on the CPU) once a
  layer a step, each rank on its own rows, the ranks merging by
  log-sum-exp; its first step's logits agree with the one-process
  ``make_serve_step``'s within 1e-5 and its greedy tokens equal them.

The same world holds ``SpatialShell``'s slot meshes at 4 slots over 2
ranks, whose groups overlap (tests/test_torch_spatial_shell.py's case).

The world rendezvouses through a ``file://`` in ``tmp_path``; every
spawned process has a deadline. A rank (spawned) imports this module,
which imports no JAX.
"""
import datetime
import multiprocessing
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

torch.set_num_threads(1)

DEADLINE_S = 240
B, L, KV, HD = 2, 8, 1, 16
WRITES = {          # positions (B, S) of a prefill's write into L rows
    "ring": np.arange(4, 16).reshape(1, 12).repeat(B, 0),   # S > L: wraps
    "offset_rows": np.stack([np.arange(6), np.arange(6) + 3]),
    "int8": np.stack([np.arange(5) + 2, np.arange(5) + 1]),
}
PROMPT, NEW = 8, 6


def _opts():
    from repro_torch.layers.attention import AttnOpts
    return AttnOpts(n_heads=2, n_kv_heads=KV, head_dim=HD)


def fill(case: str, mesh=None):
    """The cache after ``fill_kv_cache`` of seeded rows at WRITES[case],
    from a seeded cache: plain, or placed on ``mesh`` with its length (and
    positions) over "model"; returned as full tensors."""
    from repro_torch.layers.attention import fill_kv_cache, init_kv_cache
    from repro_torch.runtime.sharding import P, place
    from repro_torch.tree import tree_map
    rng = np.random.default_rng(5)
    quant = case == "int8"
    cache = init_kv_cache(B, L, _opts(), torch.float32, quant=quant)
    for name, t in cache.items():      # a cache already holding rows
        if t.dtype == torch.int8:
            t.copy_(torch.from_numpy(rng.integers(-127, 128, t.shape)))
        elif name == "pos":
            t.copy_(torch.from_numpy(rng.integers(-1, 40, t.shape)))
        else:
            t.copy_(torch.from_numpy(rng.random(t.shape)).float())
    pos = torch.from_numpy(WRITES[case].astype(np.int32))
    k, v = (torch.from_numpy(rng.standard_normal(
        pos.shape + (KV, HD))).float() for _ in range(2))
    if mesh is not None:
        cache = place(cache, mesh, {
            n: P(None, "model", *([None] * (t.ndim - 2)))
            for n, t in cache.items()})
    fill_kv_cache(cache, k, v, pos)
    return tree_map(lambda t: t.full_tensor() if mesh is not None else t,
                    cache)


def _cfg():
    from repro_torch.configs import get_config, reduced
    return reduced(get_config("smollm-135m")).replace(
        dtype="float32", vocab_size=256, n_kv_heads=KV)


def serve(mesh=None):
    """A prefill of seeded prompts, then NEW - 1 greedy decode steps:
    through make_prefill_step / make_serve_step in one process, or on
    ``mesh`` (the prefill on placed params and prompts, the decode through
    jit_serve_step). Returns (caches after the prefill as full tensors,
    the cache specs' length entry of k, tokens, decode-kernel wrapper
    calls during the decode, the first decode step's logits)."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.kernels import ops
    from repro_torch.models import get_model
    from repro_torch.runtime import (jit_serve_step, make_prefill_step,
                                     make_serve_step)
    from repro_torch.runtime.sharding import P, param_specs, place, spec_of
    from repro_torch.tree import tree_map
    model = get_model(_cfg(), device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    prompts = torch.from_numpy(np.random.default_rng(3).integers(
        0, 256, (B, PROMPT)).astype(np.int32))
    max_len = PROMPT + NEW
    prefill = make_prefill_step(model, max_len)
    length = None
    if mesh is None:
        h, caches = prefill(params, {"tokens": prompts})
        step = make_serve_step(model)
        full = tree_map(lambda t: t.clone(), caches)
    else:
        params = place(params, mesh, param_specs(model.cfg, params, mesh))
        with implicit_replication():
            h, caches = prefill(params, {"tokens": place(
                prompts, mesh, P(None, None))})
        h = h.full_tensor()
        full = tree_map(lambda t: t.full_tensor(), caches)
        length = spec_of(caches[0]["k"])[2]   # (stack, B, L, kv, hd)
        step, _ = jit_serve_step(model, mesh, B, max_len, params, caches)
    tok = model.logits(params if mesh is None else
                       tree_map(lambda t: t.full_tensor(), params),
                       h[:, -1:]).argmax(-1).to(torch.int32)
    pos = torch.full((B,), PROMPT, dtype=torch.int32)
    calls = [0]
    wrapper = ops.decode_attention

    def counted(*a, **kw):
        calls[0] += 1
        return wrapper(*a, **kw)
    ops.decode_attention = counted
    first = None
    try:
        out = [tok[:, 0].tolist()]
        for _ in range(NEW - 1):
            logits, caches = step(params, caches, tok, pos)
            if mesh is not None:
                logits = logits.full_tensor()
            first = logits if first is None else first
            tok = logits[:, -1:].argmax(-1).to(torch.int32)
            out.append(tok[:, 0].tolist())
            pos = pos + 1
    finally:
        ops.decode_attention = wrapper
    return full, length, out, calls[0], first


def run2(rank: int, init_file: str, out_dir: str):
    from torch.distributed.device_mesh import init_device_mesh
    from test_torch_spatial_shell import shell_case

    from repro_torch.tree import flatten, leaf_paths
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=2, rank=rank,
                            timeout=datetime.timedelta(seconds=120))
    try:
        mesh = init_device_mesh("cpu", (1, 2),
                                mesh_dim_names=("data", "model"))
        out = {}
        for case in WRITES:
            for name, t in fill(case, mesh).items():
                out[f"fill_{case}_{name}"] = t.numpy()
        caches, length, toks, calls, first = serve(mesh)
        for path, t in zip(leaf_paths(caches), flatten(caches)[0]):
            out["cache_" + "/".join(map(str, path))] = t.numpy()
        out["length"], out["tokens"], out["calls"] = str(length), toks, calls
        out["first"] = first.numpy()
        out.update(shell_case(rank))
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
def world(tmp_path_factory):
    return spawn(run2, 2, tmp_path_factory.mktemp("mesh_cache"))


@pytest.mark.parametrize("case", sorted(WRITES))
def test_length_sharded_write_equals_plain_fill(world, case):
    want = fill(case)
    for r in world:
        for name, t in want.items():
            np.testing.assert_array_equal(r[f"fill_{case}_{name}"],
                                          t.numpy(), err_msg=name)


def test_length_sharded_prefill_fills_the_caches(world):
    from repro_torch.tree import flatten, leaf_paths
    want = serve()[0]
    for r in world:
        assert str(r["length"]) == "model"   # the case under test
        for path, t in zip(leaf_paths(want), flatten(want)[0]):
            got = r["cache_" + "/".join(map(str, path))]
            if t.dtype == torch.int32:
                np.testing.assert_array_equal(got, t.numpy(),
                                              err_msg=str(path))
            else:
                np.testing.assert_allclose(got, t.numpy(), rtol=1e-5,
                                           atol=1e-5, err_msg=str(path))


def test_length_sharded_decode_runs_the_kernel_route(world):
    _, _, want, calls, first = serve()
    n = _cfg().n_layers * (NEW - 1)
    assert calls == n
    for r in world:
        assert int(r["calls"]) == n
        np.testing.assert_allclose(r["first"], first.numpy(), rtol=1e-5,
                                   atol=1e-5)
        assert r["tokens"].tolist() == want


def test_spatial_shell_overlapping_slot_meshes(world):
    from test_torch_spatial_shell import check_shell_world
    check_shell_world(world, 2)
    assert world[0]["shell_groups"] == "[[0], [1], [0], [1]]"
