"""The port's dry run on a fake 2x2 mesh for four more families (reduced;
the others in tests/test_torch_dryrun.py and
tests/test_torch_mesh_dryrun_b.py), and the
analyzer's per-device flops of reduced smollm's train and decode steps
against the reference's ``analyze_hlo`` on 4 forced host devices (within
10%; the ratio is in the assertion's message)."""
import json

import pytest
import torch

from test_torch_dryrun import check_family, family_cells, run_py

torch.set_num_threads(1)

FAMILIES_B = ("gemma3-1b", "mamba2-370m", "qwen3-moe-30b-a3b",
              "whisper-tiny")


@pytest.fixture(scope="module")
def cells_b():
    return family_cells(FAMILIES_B)


@pytest.mark.parametrize("arch", FAMILIES_B)
def test_family_kinds_on_fake_2x2(cells_b, arch):
    check_family(cells_b, arch)


PORT = """
    import json, torch
    torch.set_num_threads(1)
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get_config, reduced
    from repro_torch.configs.base import ShapeCell
    from repro_torch.launch.dryrun import measure
    from repro_torch.launch.mesh import fake_world
    fake_world(4)
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    cfg = reduced(get_config("smollm-135m"))
    print(json.dumps({k: measure(cfg, ShapeCell(k, 64, 4, k), mesh,
                                 "fake2x2")["per_device"]["flops"]
                      for k in ("train", "decode")}))
"""

REF = """
    import os, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    from repro.configs import get_config, reduced
    from repro.configs.base import ShapeCell
    from repro.launch import dryrun
    from repro.launch.hlo_analysis import analyze_hlo
    from repro.launch.mesh import make_host_mesh
    from repro.models import get_model
    mesh = make_host_mesh(2, 2)
    model = get_model(reduced(get_config("smollm-135m")))
    out = {}
    for kind, fn in (("train", dryrun._train_lowerable),
                     ("decode", dryrun._decode_lowerable)):
        jitted, args = fn(model, mesh, ShapeCell(kind, 64, 4, kind))
        with mesh:
            hlo = jitted.lower(*args).compile().as_text()
        out[kind] = analyze_hlo(hlo, 4).flops
    print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def flops_pair():
    port = json.loads(run_py(PORT).strip().splitlines()[-1])
    ref = json.loads(run_py(REF, env={"JAX_PLATFORMS": "cpu"})
                     .strip().splitlines()[-1])
    return port, ref


@pytest.mark.parametrize("kind", ["train", "decode"])
def test_per_device_flops_match_reference_analyzer(flops_pair, kind):
    port, ref = flops_pair
    ratio = port[kind] / ref[kind]
    assert abs(ratio - 1) <= 0.10, \
        f"{kind}: port {port[kind]:.4g} / reference {ref[kind]:.4g} = " \
        f"{ratio:.4f}"
