"""Import guard for the port: every module of ``repro_torch`` imports with
JAX made unimportable, and none of them loads anything of the JAX package
``repro``; ``chip_smoke.py`` imports neither. The copied configs must stay
equal to the reference's, field for field, for every architecture."""
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
        "repro_torch.launch", "repro_torch.launch.serve"} <= walked


def test_chip_smoke_imports_neither_jax_nor_reference():
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            mods.add(node.module.split(".")[0])
    assert not mods & {"jax", "jaxlib", "repro"}, mods


@pytest.mark.parametrize("arch", J_ARCH_IDS)
def test_ported_config_equals_reference(arch):
    assert ARCH_IDS == J_ARCH_IDS
    assert dataclasses.asdict(get_config(arch)) == \
        dataclasses.asdict(j_get_config(arch))
    assert dataclasses.asdict(reduced(get_config(arch))) == \
        dataclasses.asdict(j_reduced(j_get_config(arch)))
