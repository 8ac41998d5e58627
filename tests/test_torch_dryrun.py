"""The port's dry run (``repro_torch.launch.dryrun``), sweep and report on
the CPU:

- three families' three kinds (train, prefill, decode) on a fake 2x2
  mesh, reduced (the other seven in tests/test_torch_mesh_dryrun*.py);
- one full-width CLI cell in a subprocess, ``smollm-135m train_4k`` on
  16x16: its JSON has every key of the reference's, renamed for the card;
- ``sweep`` and ``report`` over two cells and an error cell in tmp_path.

Every fake process group lives in a subprocess with a deadline.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
DEADLINE_S = 300
FAMILIES_A = ("smollm-135m", "phi3-mini-3.8b", "gemma2-9b")

FAMILY_RUN = """
    import dataclasses, json, sys, traceback
    import torch
    torch.set_num_threads(1)
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get_config, reduced
    from repro_torch.configs.base import ShapeCell
    from repro_torch.launch.dryrun import measure
    from repro_torch.launch.mesh import fake_world
    from repro_torch.runtime.train import TrainOpts
    fake_world(4)
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    out = {}
    for arch in ARCHS:
        for kind in ("train", "prefill", "decode"):
            # the dry run's flavor on the 2x2 mesh, tensor-parallel
            cfg = reduced(get_config(arch))
            if cfg.moe is not None:
                cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                          dp_shards=2))
            if kind == "train" and cfg.mla is None and cfg.n_kv_heads % 2:
                cfg = cfg.replace(attn_tp="seq")
            try:
                r = measure(cfg, ShapeCell(kind, 64, 4, kind), mesh,
                            "fake2x2", opts=TrainOpts(remat=True,
                                                      loss_chunk=16))
                out[arch + "/" + kind] = r
            except Exception as e:
                out[arch + "/" + kind] = {"error": repr(e)[-400:]}
    print(json.dumps(out))
"""


def run_py(code: str, env=None, timeout=DEADLINE_S) -> str:
    env = dict(os.environ, PYTHONPATH="src", **(env or {}))
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          capture_output=True, text=True, env=env, cwd=ROOT,
                          timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-2500:]
    return proc.stdout


def family_cells(archs):
    code = textwrap.dedent(FAMILY_RUN).replace("ARCHS", repr(tuple(archs)))
    return json.loads(run_py(code).strip().splitlines()[-1])


def check_family(cells, arch):
    for kind in ("train", "prefill", "decode"):
        r = cells[f"{arch}/{kind}"]
        assert "error" not in r, r
        assert r["chips"] == 4 and r["per_device"]["flops"] > 0
        assert r["memory"]["arguments"] > 0 and r["memory"]["fits_80GB"]
        if kind == "train":          # a 2x2 step exchanges gradients
            assert r["per_device"]["collective_wire_bytes"] > 0


@pytest.fixture(scope="module")
def cells_a():
    return family_cells(FAMILIES_A)


@pytest.mark.parametrize("arch", FAMILIES_A)
def test_family_kinds_on_fake_2x2(cells_a, arch):
    check_family(cells_a, arch)


# every key of the reference's result (repro/launch/dryrun.py run_cell),
# renamed for the card: lower_s/compile_s -> trace_s, fits_16GB ->
# fits_80GB, projected_tpu_bytes -> per_device_bytes
REF_KEYS = {
    "": {"arch", "shape", "mesh", "chips", "lower_s", "compile_s", "memory",
         "xla_cost_analysis", "per_device", "roofline"},
    "memory": {"per_device_bytes", "arguments", "outputs", "temps",
               "aliased", "cpu_dus_legalization_bytes",
               "projected_tpu_bytes", "fits_16GB"},
    "xla_cost_analysis": {"flops", "bytes_accessed", "note"},
    "per_device": {"flops", "dot_bytes", "collective_wire_bytes",
                   "collective_breakdown", "collective_ops"},
    "roofline": {"compute_s", "memory_s", "memory_s_flash_kernel",
                 "score_bytes", "collective_s", "dominant",
                 "model_flops_global", "hlo_flops_global",
                 "useful_flops_ratio", "step_time_bound_s",
                 "roofline_fraction"},
}
RENAMED = {"lower_s": "trace_s", "compile_s": "trace_s",
           "fits_16GB": "fits_80GB",
           "projected_tpu_bytes": "per_device_bytes"}


def test_cli_full_width_cell(tmp_path):
    out = tmp_path / "cell.json"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "smollm-135m", "--shape", "train_4k", "--json", str(out)],
        capture_output=True, text=True, cwd=ROOT, timeout=DEADLINE_S,
        env=dict(os.environ, PYTHONPATH="src"))
    assert proc.returncode == 0, proc.stderr[-2500:]
    r = json.loads(out.read_text())
    for section, keys in REF_KEYS.items():
        got = set(r[section] if section else r)
        assert {RENAMED.get(k, k) for k in keys} == got, section
    assert r["mesh"] == "pod16x16" and r["chips"] == 256
    assert r["memory"]["fits_80GB"]
    # pure data parallelism over all 256 ranks: one token row a rank
    assert r["roofline"]["model_flops_global"] == pytest.approx(
        6 * 134515008 * 256 * 4096, rel=1e-3)
    assert r["per_device"]["collective_breakdown"]


def test_sweep_and_report(tmp_path):
    env = {"SWEEP_RESULTS_DIR": str(tmp_path)}
    out = run_py("""
        from repro_torch.launch import report, sweep
        sweep.main(["--arch", "smollm-135m", "--shape", "decode_32k",
                    "--mesh", "single"])
        sweep.main(["--arch", "smollm-135m", "--shape", "long_500k",
                    "--mesh", "single"])
        err = sweep.run_one("no-such-arch", "decode_32k", "single")
        print("error" in err)
        print(report.main([]))
    """, env=env)
    files = sorted(p.name for p in tmp_path.glob("*.json"))
    assert files == ["no-such-arch__decode_32k__single.json",
                     "smollm-135m__decode_32k__single.json",
                     "smollm-135m__long_500k__single.json"]
    err = json.loads((tmp_path / files[0]).read_text())
    assert "error" in err and err["arch"] == "no-such-arch"
    assert "skipped" in json.loads((tmp_path / files[2]).read_text())
    assert "True" in out
    assert "| smollm-135m | decode_32k |" in out
    assert "| smollm-135m | long_500k | — |" in out
    assert "errors: 1" in out
