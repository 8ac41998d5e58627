"""Helpers of the examples' parity tests (tests/test_torch_examples_*.py):
load a port example (``examples/*_torch.py``) as a module, run the
reference example's ``main`` in this process with its prints captured, and
mask the times and rates two runs cannot share."""
import contextlib
import importlib.util
import io
import re
import runpy
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# times and rates, the only printed numbers two runs may differ in
_CLOCKED = (
    r"(cold configure )[\d.]+( ms)",
    r"(cache hit\): )[\d.]+( ms \()\d+(x faster)",
    r"(TTFT )\d+( ms)",
    r"(tokens in )[\d.]+(s \()[\d.]+( tok/s)",
    r"(tenant\(s\):) +[\d.]+( MB/s/core,) +[\d.]+( MB/s total)",
    r"(= )[\d.]+(x of 1 tenant)",
    r"(steps, )[\d.]+(s \(cross)",
    r"(e-\d\d  )[\d,]+( tok/s)",
)


def mask(text: str) -> str:
    for pat in _CLOCKED:
        text = re.sub(pat, lambda m: "#".join(m.groups()), text)
    return text


def port_example(name: str):
    """``examples/<name>_torch.py`` as a module (its ``main`` not run)."""
    spec = importlib.util.spec_from_file_location(
        f"{name}_torch", ROOT / "examples" / f"{name}_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def captured(fn, *a, **kw):
    """(fn's result, what it printed)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*a, **kw)
    return out, buf.getvalue()


def reference_main(name: str, argv=(), patch=None):
    """Run the reference ``examples/<name>.py``'s ``main`` in this process
    (its own run name, so the file's ``__main__`` block does not run) with
    ``sys.argv`` set to ``argv``; ``patch`` maps names of its globals to
    replacements. Returns what it printed."""
    g = runpy.run_path(str(ROOT / "examples" / f"{name}.py"),
                       run_name=f"reference_{name}")
    main = g["main"]
    main.__globals__.update(patch or {})
    saved = sys.argv
    sys.argv = [f"{name}.py", *argv]
    try:
        return captured(main)[1]
    finally:
        sys.argv = saved
