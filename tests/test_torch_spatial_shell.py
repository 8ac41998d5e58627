"""``SpatialShell``'s per-slot groups and sub-meshes over the ranks of a
gloo process group on the CPU, held against the reference's
(``tests/test_multidevice.py::test_spatial_shell_submeshes``):

- the groups equal the reference's ``_groups`` (as device ids, the
  reference on forced host devices in a subprocess) for 8 devices and for
  2 devices with 4 slots (the 2-device groups overlap);
- on gloo ranks (``shell_case`` runs in the 8-rank world of
  tests/test_torch_mesh_steps.py and the 2-rank world of
  tests/test_torch_mesh_cache.py, whose tests hold it with
  ``check_shell_world``): every slot mesh over exactly its group
  (``slot_mesh(0).size() == 2`` on 8 ranks), the cores of slots 0 and 3
  give 2.0 as the reference's do, and an all-reduce over each slot's
  group sums only that group's ranks;
- one process: the default ranks (``[0]`` without a group, no group made
  by the constructor), the CUDA default that raises without a card, and a
  one-rank mesh made on the first ``slot_mesh``, in a subprocess.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
import torch.distributed as dist

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(__file__), "..")
DEADLINE_S = 240
N_SLOTS = 4
WORLDS = (8, 2)


def _core_spec():
    from repro_torch.rc2f import CoreSpec, StreamSpec
    return CoreSpec("t", (StreamSpec((8, 8)),), (StreamSpec((8, 8)),))


def shell_case(rank: int) -> dict:
    """One rank's view of a 4-slot SpatialShell over the whole group: the
    groups, every slot mesh's size and this rank's coordinate in it, an
    all-reduce of rank + 1 over each slot's group (NaN outside it), and
    the outputs of the reference example's two cores; every key prefixed
    ``shell_``."""
    from repro_torch.rc2f import SpatialShell
    shell = SpatialShell(n_slots=N_SLOTS, device="cpu")
    out = {"groups": json.dumps(shell._groups)}
    sizes, coords, sums = [], [], []
    for slot in range(N_SLOTS):
        mesh = shell.slot_mesh(slot)
        assert mesh.device_type == "cpu"
        assert mesh.mesh_dim_names == ("slice",)
        assert mesh.mesh.tolist() == shell._groups[slot]
        sizes.append(mesh.size())
        coord = mesh.get_coordinate()
        coords.append(-1 if coord is None else coord[0])
        t = torch.full((3,), float(rank + 1))
        if coord is not None:
            dist.all_reduce(t, group=mesh.get_group())
            sums.append(float(t[0]))
        else:
            sums.append(float("nan"))
    spec = _core_spec()
    shell.load(0, lambda a: a * 2, spec, "u0")
    shell.load(3, lambda a: a + 1, spec, "u3")
    (out["run0"],) = shell.run(0, np.ones((8, 8), np.float32))
    (out["run3"],) = shell.run(3, np.ones((8, 8), np.float32))
    shell.join()
    out["run0"], out["run3"] = out["run0"].numpy(), out["run3"].numpy()
    out["active_mask"] = shell.gcs.read("active_mask")
    out["sizes"], out["coords"], out["sums"] = sizes, coords, sums
    return {f"shell_{k}": v for k, v in out.items()}


def check_shell_world(ranks, world: int):
    """Every rank's ``shell_case`` (keys prefixed ``shell_``) of a world
    of ``world`` ranks: its groups those of ``SpatialShell`` over
    range(world) (equal to the reference's:
    ``test_groups_equal_the_reference``), each slot mesh of its group's
    size with this rank at its index or outside it, the all-reduce summing
    only the group's ranks, both cores' outputs 2.0."""
    from repro_torch.rc2f import SpatialShell
    groups = SpatialShell(list(range(world)), n_slots=N_SLOTS,
                          device="cpu")._groups
    for rank, r in enumerate(ranks):
        assert json.loads(str(r["shell_groups"])) == groups
        assert r["shell_sizes"].tolist() == [len(g) for g in groups]
        for slot, g in enumerate(groups):
            if rank in g:
                assert r["shell_coords"][slot] == g.index(rank)
                # only the group's ranks are summed
                assert r["shell_sums"][slot] == sum(q + 1 for q in g)
            else:
                assert r["shell_coords"][slot] == -1
        np.testing.assert_array_equal(r["shell_run0"], 2.0)
        np.testing.assert_array_equal(r["shell_run3"], 2.0)
        assert int(r["shell_active_mask"]) == 0b1001


@pytest.fixture(scope="module")
def reference():
    """The reference's groups (device ids) for 8 and 2 devices, its first
    slot mesh's size and its two cores' outputs, on 8 forced host
    devices."""
    code = textwrap.dedent(f"""
        import os, json
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
        import jax, numpy as np
        from repro.rc2f import CoreSpec, SpatialShell, StreamSpec
        out = {{}}
        for n in {WORLDS!r}:
            shell = SpatialShell(jax.devices()[:n], n_slots={N_SLOTS})
            out[n] = {{"groups": [[d.id for d in g] for g in shell._groups],
                      "mesh0": int(shell.slot_mesh(0).devices.size)}}
            spec = CoreSpec("t", (StreamSpec((8, 8)),),
                            (StreamSpec((8, 8)),))
            shell.load(0, lambda a: a * 2, spec, "u0")
            shell.load(3, lambda a: a + 1, spec, "u3")
            out[n]["run0"] = float(np.asarray(shell.run(
                0, np.ones((8, 8), np.float32))).mean())
            out[n]["run3"] = float(np.asarray(shell.run(
                3, np.ones((8, 8), np.float32))).mean())
            out[n]["active_mask"] = shell.gcs.read("active_mask")
        print(json.dumps(out))
    """)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=ROOT, timeout=DEADLINE_S,
                          env=dict(os.environ, PYTHONPATH="src",
                                   JAX_PLATFORMS="cpu"))
    assert proc.returncode == 0, proc.stderr[-2500:]
    return {int(k): v for k, v in
            json.loads(proc.stdout.strip().splitlines()[-1]).items()}


@pytest.mark.parametrize("world", WORLDS)
def test_groups_equal_the_reference(reference, world):
    from repro_torch.rc2f import SpatialShell
    shell = SpatialShell(list(range(world)), n_slots=N_SLOTS, device="cpu")
    assert shell._groups == reference[world]["groups"]
    if world == 8:
        assert len({r for g in shell._groups for r in g}) == 8
        assert reference[world]["mesh0"] == 2
    else:                                   # fewer ranks than slots
        assert shell._groups == [[0], [1], [0], [1]]
    # the ranks' cores (check_shell_world) give what the reference's give
    assert reference[world]["run0"] == reference[world]["run3"] == 2.0
    assert reference[world]["active_mask"] == 0b1001


def test_one_process_defaults():
    """Without a group: devices [0], no group made by the constructor, and
    the first slot_mesh makes a one-rank gloo group; CUDA by default."""
    code = textwrap.dedent("""
        import torch, torch.distributed as dist
        from repro_torch.rc2f import SpatialShell
        shell = SpatialShell(device="cpu")
        assert shell.devices == [0] and shell.n_slots == 4
        assert shell._groups == [[0]] * 4
        assert not dist.is_initialized()
        meshes = [shell.slot_mesh(i) for i in range(4)]
        assert dist.is_initialized() and dist.get_world_size() == 1
        assert dist.get_backend() == "gloo"
        assert all(m.size() == 1 and m.device_type == "cpu" for m in meshes)
        assert shell.slot_mesh(2) is meshes[2]            # cached
        t = torch.arange(3.0)
        dist.all_reduce(t, group=meshes[1].get_group())
        assert t.tolist() == [0.0, 1.0, 2.0]
        if not torch.cuda.is_available():
            try:
                SpatialShell()
            except RuntimeError as e:
                assert "CUDA is not available" in str(e)
            else:
                raise AssertionError("a CUDA shell without a card")
        dist.destroy_process_group()
        print("OK")
    """)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=ROOT, timeout=DEADLINE_S,
                          env=dict(os.environ, PYTHONPATH="src"))
    assert proc.returncode == 0, proc.stderr[-2500:]
    assert "OK" in proc.stdout
