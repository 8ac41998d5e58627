"""Import guard for the port: every module of ``repro_torch`` and every
port example (``examples/*_torch.py``) imports with JAX made unimportable,
and none of them loads anything of the JAX package ``repro``;
``chip_smoke.py`` and the port examples name neither in an import. The
copied configs must stay equal to the reference's, field for field, for
every architecture."""
import ast
import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from repro.configs import ARCH_IDS as J_ARCH_IDS
from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro_torch.configs import ARCH_IDS, get_config, reduced

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


def test_port_imports_without_jax_or_reference():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        sys.modules["jax"] = None          # any `import jax` now fails
        import repro_torch
        names = sorted(m.name for m in pkgutil.walk_packages(
            repro_torch.__path__, "repro_torch."))
        for name in names:
            importlib.import_module(name)
        bad = sorted(m for m in sys.modules
                     if m == "repro" or m.startswith("repro."))
        assert not bad, bad
        print(" ".join(names))
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    walked = set(out.stdout.split())
    assert len(walked) >= 55                     # every module was walked
    assert {f"repro_torch.runtime.{m}" for m in
            ("faults", "events", "gateway", "fleet", "loadgen",
             "adversary")} | {
        "repro_torch.launch", "repro_torch.launch.serve",
        "repro_torch.layers.moe", "repro_torch.layers.mla",
        "repro_torch.models.encdec", "repro_torch.kernels.registry"} | {
        f"repro_torch.tuning.{m}" for m in
            ("space", "cost_model", "explorer")} | {
        f"repro_torch.analysis.{m}" for m in
            ("common", "ownership", "determinism", "hostsync", "kernelpass",
             "__main__", "lifecycle")} | {
        "repro_torch.optim.adamw", "repro_torch.optim.compress",
        "repro_torch.runtime.train", "repro_torch.runtime.losses",
        "repro_torch.data.synthetic", "repro_torch.ckpt.checkpoint",
        "repro_torch.launch.train", "repro_torch.tree"} | {
        "repro_torch.runtime.sharding"} | {
        f"repro_torch.launch.{m}" for m in
            ("mesh", "hlo_analysis", "dryrun", "sweep", "report")} <= walked


PORT_EXAMPLES = sorted(p.name for p in (REPO / "examples").glob(
    "*_torch.py"))


def test_port_examples_import_without_jax_or_reference():
    assert PORT_EXAMPLES == ["multi_tenant_torch.py", "quickstart_torch.py",
                             "serve_baas_torch.py", "train_smollm_torch.py"]
    code = textwrap.dedent(f"""
        import importlib.util, sys
        sys.modules["jax"] = None          # any `import jax` now fails
        for name in {PORT_EXAMPLES!r}:
            spec = importlib.util.spec_from_file_location(
                name[:-3], "{REPO / 'examples'}/" + name)
            spec.loader.exec_module(importlib.util.module_from_spec(spec))
        bad = sorted(m for m in sys.modules
                     if m == "repro" or m.startswith("repro."))
        assert not bad, bad
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def imported_roots(path):
    tree = ast.parse((REPO / path).read_text())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            mods.add(node.module.split(".")[0])
    return mods


def test_chip_smoke_imports_neither_jax_nor_reference():
    mods = imported_roots("chip_smoke.py")
    assert not mods & {"jax", "jaxlib", "repro"}, mods


@pytest.mark.parametrize("name", PORT_EXAMPLES)
def test_port_example_names_neither_jax_nor_reference(name):
    mods = imported_roots(f"examples/{name}")
    assert not mods & {"jax", "jaxlib", "repro"}, mods
    assert "repro_torch" in mods and "torch" in mods


@pytest.mark.parametrize("arch", J_ARCH_IDS)
def test_ported_config_equals_reference(arch):
    assert ARCH_IDS == J_ARCH_IDS
    assert dataclasses.asdict(get_config(arch)) == \
        dataclasses.asdict(j_get_config(arch))
    assert dataclasses.asdict(reduced(get_config(arch))) == \
        dataclasses.asdict(j_reduced(j_get_config(arch)))
