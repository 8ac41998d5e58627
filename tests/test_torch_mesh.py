"""The mesh slice's rules and primitives on the CPU, against the JAX
package:

- ``param_specs`` and ``zero1_specs`` equal the reference's, leaf for
  leaf, for all ten full configs on the 16x16 and 2x16x16 meshes, and so
  do ``batch_specs`` (train and prefill cells) and ``cache_specs`` (decode
  cells, with jit_serve_step's seq-sharding) for every ``SHAPES`` cell
  under ``dryrun_cfg``; the reference runs in a subprocess with 512
  forced host devices; every sharded dim of the port's specs divides;
- ``Model(device="meta").init(None)``, ``init_train_state`` and
  ``make_caches`` give the paths, shapes and dtypes of the reference's
  ``jax.eval_shape`` for all ten full configs;
- the analyzer's exact counts (seven tanh(c @ w); an all-reduce over 8
  fake ranks; a 2x2 product with each of its dims sharded), and the mesh
  constructors' refusals, in subprocesses (a process group never lives in
  the test process);
- ``reshard`` round trip and ``restore(shardings=...)`` on a one-rank
  gloo mesh; a kernel wrapper refuses a DTensor.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.models import get_model as j_get_model
from repro.runtime.train import TrainOpts as JTrainOpts
from repro.runtime.train import init_train_state as j_init_train_state
from repro_torch.configs import SHAPES, get_config
from repro_torch.launch.dryrun import dryrun_cfg
from repro_torch.models import get_model
from repro_torch.models.api import input_specs
from repro_torch.runtime.serve import jit_serve_step
from repro_torch.runtime.sharding import (MeshShape, batch_specs,
                                          cache_specs, is_spec, param_specs,
                                          zero1_specs)
from repro_torch.runtime.train import TrainOpts, init_train_state
from repro_torch.tree import flatten, leaf_paths

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"single": {"data": 16, "model": 16},
          "multi": {"pod": 2, "data": 16, "model": 16}}
DEADLINE_S = 300


def _run(code: str, env=None) -> str:
    env = dict(os.environ, PYTHONPATH="src", **(env or {}))
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          capture_output=True, text=True, env=env, cwd=ROOT,
                          timeout=DEADLINE_S)
    assert proc.returncode == 0, proc.stderr[-2500:]
    return proc.stdout


def _as_lists(spec):
    return [list(p) if isinstance(p, tuple) else p for p in spec]


# ---------------------------------------------------------------------------
# Spec parity with the reference
# ---------------------------------------------------------------------------

REF_SPECS = """
    import os, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    import jax, numpy as np
    from jax.sharding import PartitionSpec as P
    from repro.configs import ARCH_IDS, SHAPES, get_config
    from repro.launch.dryrun import dryrun_cfg
    from repro.launch.mesh import make_production_mesh
    from repro.models import get_model
    from repro.models.api import input_specs
    from repro.runtime.sharding import (batch_specs, cache_specs,
                                        param_specs, zero1_specs)

    def flat(tree):
        leaves = jax.tree.flatten(tree, is_leaf=lambda x: isinstance(x, P))[0]
        return [[list(p) if isinstance(p, tuple) else p for p in s]
                for s in leaves]

    out = {}
    for mname, multi in (("single", False), ("multi", True)):
        mesh = make_production_mesh(multi_pod=multi)
        dp_total = int(np.prod([mesh.shape[a] for a in mesh.axis_names
                                if a in ("pod", "data")]))
        for arch in ARCH_IDS:
            cfg = get_config(arch)
            shapes = jax.eval_shape(
                lambda: get_model(cfg).init(jax.random.key(0)))
            ps = param_specs(cfg, shapes, mesh)
            out[f"{mname}/{arch}/params"] = flat(ps)
            out[f"{mname}/{arch}/zero1"] = flat(
                zero1_specs(cfg, ps, shapes, mesh))
            for sname, cell in SHAPES.items():
                dcfg = dryrun_cfg(arch, dp_total=dp_total,
                                  tp=mesh.shape["model"], cell_kind=cell.kind)
                specs = input_specs(dcfg, cell)
                key = f"{mname}/{arch}/{sname}"
                if cell.kind == "decode":
                    seq = cell.global_batch % dp_total != 0
                    out[key] = flat(cache_specs(dcfg, specs["caches"], mesh,
                                                cell.global_batch,
                                                seq_shard=seq))
                else:
                    out[key] = flat(batch_specs(dcfg, specs, mesh))
    print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def ref_specs():
    return json.loads(_run(REF_SPECS).strip().splitlines()[-1])


def _divides(shapes, specs, sizes):
    for leaf, sp in zip(shapes, specs):
        for dim, ax in zip(leaf.shape, tuple(sp) + (None,) * 9):
            if ax is None:
                continue
            n = int(np.prod([sizes[a] for a in
                             (ax if isinstance(ax, tuple) else (ax,))]))
            assert dim % n == 0, (tuple(leaf.shape), sp)


@pytest.mark.parametrize("mname", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_and_zero1_specs_equal_reference(ref_specs, arch, mname):
    mesh = MeshShape(MESHES[mname])
    cfg = get_config(arch)
    shapes = get_model(cfg, device="meta").init(None)
    ps = param_specs(cfg, shapes, mesh)
    zs = zero1_specs(cfg, ps, shapes, mesh)
    got_p = [_as_lists(s) for s in flatten(ps, is_spec)[0]]
    got_z = [_as_lists(s) for s in flatten(zs, is_spec)[0]]
    assert got_p == ref_specs[f"{mname}/{arch}/params"]
    assert got_z == ref_specs[f"{mname}/{arch}/zero1"]
    # the reference's test_param_specs_divisible, on the port's specs
    leaves = flatten(shapes)[0]
    _divides(leaves, flatten(ps, is_spec)[0], mesh.shape)
    _divides(leaves, flatten(zs, is_spec)[0], mesh.shape)


@pytest.mark.parametrize("mname", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_and_cache_specs_equal_reference(ref_specs, arch, mname):
    mesh = MeshShape(MESHES[mname])
    sizes = mesh.shape
    dp_total = int(np.prod([sizes[a] for a in sizes
                            if a in ("pod", "data")]))
    for sname, cell in SHAPES.items():
        cfg = dryrun_cfg(arch, dp_total=dp_total, tp=sizes["model"],
                         cell_kind=cell.kind)
        specs = input_specs(cfg, cell)
        if cell.kind == "decode":
            model = get_model(cfg, device="meta")
            _, got = jit_serve_step(model, mesh, cell.global_batch,
                                    cell.seq_len, model.init(None),
                                    specs["caches"])
            tree = got["caches"]
            want_seq = cell.global_batch % dp_total != 0
            assert tree == cache_specs(cfg, specs["caches"], mesh,
                                       cell.global_batch, seq_shard=want_seq)
        else:
            tree = batch_specs(cfg, specs, mesh)
        got_l = [_as_lists(s) for s in flatten(tree, is_spec)[0]]
        assert got_l == ref_specs[f"{mname}/{arch}/{sname}"], sname


# ---------------------------------------------------------------------------
# The meta init against jax.eval_shape
# ---------------------------------------------------------------------------

def _jax_paths(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [(tuple(str(getattr(k, "key", getattr(k, "idx", k)))
                   for k in path), tuple(leaf.shape), str(leaf.dtype))
            for path, leaf in flat]


def _port_paths(tree):
    return [(p, tuple(t.shape), str(t.dtype).replace("torch.", ""))
            for p, t in zip(leaf_paths(tree), flatten(tree)[0])]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_meta_init_equals_reference_eval_shape(arch):
    from repro.configs import get_config as j_get_config
    jcfg = j_get_config(arch)
    jmodel = j_get_model(jcfg)
    want = jax.eval_shape(lambda: j_init_train_state(
        jmodel, jax.random.key(0), JTrainOpts(compress_grads=True)))
    model = get_model(get_config(arch), device="meta")
    got = init_train_state(model, None, TrainOpts(compress_grads=True))
    assert all(t.device.type == "meta" for t in flatten(got)[0])
    assert _port_paths(got) == _jax_paths(want)
    assert _port_paths(model.init(None)) == _jax_paths(want["params"])
    jc = jax.eval_shape(lambda: jmodel.make_caches(2, 64))
    assert _port_paths(model.make_caches(2, 64)) == _jax_paths(jc)


# ---------------------------------------------------------------------------
# The analyzer's exact counts; the mesh constructors
# ---------------------------------------------------------------------------

def test_analyzer_exact_counts():
    out = _run("""
        import json, torch
        import torch.distributed as dist
        import torch.distributed._functional_collectives as funcol
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import Replicate, Shard, distribute_tensor
        from repro_torch.launch.hlo_analysis import analyze
        from repro_torch.launch.mesh import fake_world
        torch.manual_seed(0)
        res = {}

        def seven(c, w):
            for _ in range(7):
                c = torch.tanh(c @ w)
            return c
        res["seven"] = analyze(seven, torch.randn(64, 64),
                               torch.randn(64, 64))[1].flops
        fake_world(8)
        _, co = analyze(lambda t: funcol.all_reduce(t, "sum", dist.group.WORLD),
                        torch.randn(8, 128), world=8)
        res["allreduce"] = [co.collective_bytes, dict(co.collectives),
                            co.collective_count]
        dist.destroy_process_group()
        fake_world(4)
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        A, B = torch.randn(8, 64), torch.randn(64, 32)
        S0, S1, R = [Shard(0)] * 2, [Shard(1)] * 2, [Replicate()] * 2
        for name, pa, pb in (("M", S0, R), ("N", R, S1), ("K", S1, S0)):
            a = distribute_tensor(A, mesh, pa, src_data_rank=None)
            b = distribute_tensor(B, mesh, pb, src_data_rank=None)
            res[name] = analyze(lambda x, y: x @ y, a, b, world=4)[1].flops
        dist.destroy_process_group()
        print(json.dumps(res))
    """)
    res = json.loads(out.strip().splitlines()[-1])
    assert res["seven"] == 7 * 2 * 64 ** 3
    wire, by_kind, count = res["allreduce"]
    assert wire == pytest.approx(2 * 4096 * 7 / 8, rel=1e-6)
    assert by_kind == {"all-reduce": wire} and count == 1
    # (8, 64) @ (64, 32): 2*8*64*32 = 32768 global flops, a quarter a rank
    assert res["M"] == res["N"] == res["K"] == 8192


def test_mesh_constructors_refuse_a_small_world():
    out = _run("""
        from repro_torch.launch.mesh import (chips, make_host_mesh,
                                             make_production_mesh)
        from repro_torch.runtime.sharding import MeshShape
        for f, kind in ((lambda: make_host_mesh(2, 1, device="cpu"),
                         ValueError),
                        (lambda: make_production_mesh(device="cpu"),
                         RuntimeError),
                        (lambda: make_production_mesh(multi_pod=True,
                                                      device="cpu"),
                         RuntimeError),
                        # the meshes are on CUDA unless "cpu" is passed
                        (lambda: make_host_mesh(1, 1), RuntimeError),
                        (lambda: make_production_mesh(), RuntimeError)):
            try:
                f()
            except kind as e:
                print(type(e).__name__, str(e))
        import torch.distributed as dist
        print(dist.is_initialized())
        print(chips(MeshShape({"pod": 2, "data": 16, "model": 16})))
    """)
    lines = out.strip().splitlines()
    assert lines[0] == "ValueError need 2 devices, have 1"
    assert lines[1].startswith("RuntimeError mesh (16, 16) needs 256 ")
    assert lines[2].startswith("RuntimeError mesh (2, 16, 16) needs 512 ")
    no_cuda = ("RuntimeError a cuda mesh needs a CUDA device and none is "
               "available; pass device=\"cpu\" for a CPU mesh")
    assert lines[3] == lines[4] == no_cuda
    assert lines[5] == "False"     # refused before any group was made
    assert lines[6] == "512"


# ---------------------------------------------------------------------------
# reshard / restore(shardings=) / the kernels' refusal, one gloo rank
# ---------------------------------------------------------------------------

def test_reshard_restore_and_kernel_refusal_on_one_rank(tmp_path):
    out = _run(f"""
        import torch
        import torch.distributed as dist
        from repro_torch.ckpt import reshard, restore, save
        from repro_torch.kernels import ops
        from repro_torch.launch.mesh import make_host_mesh
        from repro_torch.runtime.sharding import P, named
        from repro_torch.tree import flatten
        mesh = make_host_mesh(1, 1, device="cpu")
        state = {{"w": torch.arange(16.0).reshape(4, 4),
                  "b": torch.ones(4)}}
        specs = {{"w": P(None, None), "b": P(None)}}
        # the reference's test_elastic_reshard_roundtrip
        moved = reshard(state, mesh, specs)
        print(all(torch.equal(a, b.full_tensor()) for a, b in
                  zip(flatten(state)[0], flatten(moved)[0])))
        save(moved, "{tmp_path}/ck", step=3)
        got, at = restore("{tmp_path}/ck", state,
                          shardings=named(mesh, specs))
        print(at, all(torch.equal(a, b.full_tensor()) for a, b in
                      zip(flatten(state)[0], flatten(got)[0])),
              all(hasattr(t, "placements") for t in flatten(got)[0]))
        plain, _ = restore("{tmp_path}/ck", state)
        print(all(torch.equal(a, b) for a, b in
                  zip(flatten(state)[0], flatten(plain)[0])))
        q = moved["w"].reshape(1, 4, 4)
        try:
            ops.flash_attention(q, q, q)
            print("launched")
        except TypeError as e:
            print("refused")
        dist.destroy_process_group()
    """)
    assert out.split() == ["True", "3", "True", "True", "True", "refused"]


def test_launcher_trains_on_a_two_rank_mesh():
    """``launch.train --data 2 --model 1`` on 2 gloo ranks (torchrun,
    standalone rendezvous on localhost): every rank prints the mesh and
    trains, the loss falls."""
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", "repro_torch.launch.train",
         "--arch", "smollm-135m", "--reduce", "--device", "cpu",
         "--steps", "20", "--batch", "4", "--seq", "32", "--data", "2",
         "--model", "1"], capture_output=True, text=True, cwd=ROOT,
        timeout=DEADLINE_S, env=dict(os.environ, PYTHONPATH="src",
                                     OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-2500:]
    out = proc.stdout
    assert out.count("on mesh {'data': 2, 'model': 1}") == 2, out
    losses = [float(line.split()[3]) for line in out.splitlines()
              if line.startswith("step ")]
    assert len(losses) == 4 and losses[-1] < losses[0], out
    assert out.count("done:") == 2
