"""Kernel-wrapper pass.

The reference's pass checks Pallas kernel bodies; the port's kernels are
CUDA C++ behind Python wrappers, so the static rules check the wrappers'
hygiene over ``kernels/`` (and the compute paths for the CUDA branch):

  * **launch-count** — a function that launches a kernel (the C entry
    point whose return code goes to ``check(rc, ...)``) adds exactly one to
    ``launches[...]``, after the launch; a function that adds to
    ``launches`` launches. The counts are how a run shows that its path
    went through the kernels.
  * **launch-fallback** — no ``try``/``except`` around a build or launch
    whose handler does not re-raise: a failed build or launch must fail,
    never turn into the plain version.
  * **cuda-branch** — no ``torch.cuda.is_available()`` in a branch test
    on a compute path (``kernels/``, ``layers/``, ``models/``), unless the
    branch only raises: dispatch is by the tensor's device, and a missing
    card is an error, not another path.
  * **ops-dispatch** — ``kernels/ops.py`` branches on the tensor's device
    alone (``_on_cuda(t, ...)``, ``t.device.type``, ``t.is_cuda``).
  * **unchecked-launch** — every launch is preceded by the wrapper's
    shape, dtype and contiguity checks: a ``raise`` or a ``_check*`` /
    ``check_*`` call before it, in the launching function or in every
    caller of it in the module.

Two executed checks (the registry is data):

  * **registry-shapes** — every config, full and ``reduced()``: its head
    dim taken by the attention kernels directly or padded, its query-head
    group within the decode kernel's, its ``d_state`` one of the SSD's,
    its ``max_seq_len`` divisible by every page size of the sweep; and
    every kernel instantiation's shared memory a block within the card's.
  * **tuner-shapes** — the tuner's winners for the pinned archs on each
    device class, dense and paged, pass the registry's rules, and split-K
    decode at the winner cuts whole pages.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional

from repro_torch.analysis.common import (Finding, ModuleInfo, Workspace,
                                         call_name, dotted_call)

PASS = "kernels"

# calls whose failure a handler must not swallow: building or loading a
# kernel library, binding an entry point, checking a launch's return code
LAUNCH_CALLS = {"build", "library", "_entry", "CDLL", "check"}
COMPUTE_DIRS = ("kernels", "layers", "models")
DEVICE_TESTS = {"_on_cuda"}


def _is_launch_count(node: ast.AST) -> bool:
    """``...launches[...] += 1``."""
    return isinstance(node, ast.AugAssign) and isinstance(node.op, ast.Add) \
        and isinstance(node.target, ast.Subscript) \
        and ast.unparse(node.target.value).split(".")[-1] == "launches"


def _launch_line(func: ast.AST) -> Optional[int]:
    """Line of the C entry call whose return code ``check(rc, ...)``
    tests (``rc = fn(...)``), or None when the function launches
    nothing."""
    checked = set()
    for node in ast.walk(func):
        if isinstance(node, ast.Call) and call_name(node) == "check" \
                and node.args and isinstance(node.args[0], ast.Name):
            checked.add(node.args[0].id)
    lines = [node.value.lineno for node in ast.walk(func)
             if isinstance(node, ast.Assign) and isinstance(node.value,
                                                            ast.Call)
             and any(isinstance(t, ast.Name) and t.id in checked
                     for t in node.targets)]
    return min(lines) if lines else None


def _validates_before(func: ast.AST, line: int) -> bool:
    """A raise, or a ``_check*`` / ``check_*`` call, before ``line``."""
    for node in ast.walk(func):
        if getattr(node, "lineno", line) >= line:
            continue
        if isinstance(node, ast.Raise):
            return True
        if isinstance(node, ast.Call):
            name = call_name(node) or ""
            if name.startswith(("_check", "check_")):
                return True
    return False


def _check_launches(mod: ModuleInfo, out: List[Finding]):
    launching: Dict[str, int] = {}
    for fi in mod.functions:
        line = _launch_line(fi.node)
        counts = [n for n in ast.walk(fi.node) if _is_launch_count(n)]
        if line is None:
            for n in counts:
                if not mod.allows(n.lineno, "launch-count", fi.node):
                    out.append(Finding(
                        PASS, "launch-count", mod.rel, n.lineno, fi.qualname,
                        "launches[...] counted where no kernel launches: "
                        "a count must mean a launch"))
            continue
        launching[fi.name] = line
        ok = len(counts) == 1 and counts[0].lineno > line \
            and isinstance(counts[0].value, ast.Constant) \
            and counts[0].value.value == 1
        if not ok and not mod.allows(line, "launch-count", fi.node):
            out.append(Finding(
                PASS, "launch-count", mod.rel, line, fi.qualname,
                f"a kernel launch with {len(counts)} launches[...] "
                "increment(s): add exactly one (+= 1) after the launch"))
    for fi in mod.functions:
        line = launching.get(fi.name)
        if line is None or _validates_before(fi.node, line):
            continue
        callers = [(c, n.lineno) for c in mod.functions
                   for n in ast.walk(c.node) if isinstance(n, ast.Call)
                   and call_name(n) == fi.name]
        if callers and all(_validates_before(c.node, ln)
                           for c, ln in callers):
            continue
        if mod.allows(line, "unchecked-launch", fi.node):
            continue
        out.append(Finding(
            PASS, "unchecked-launch", mod.rel, line, fi.qualname,
            "kernel launched without the wrapper's shape/dtype/contiguity "
            "checks before it (a raise or a _check*/check_* call here or "
            "in every caller)"))


def _reraises(handler: ast.ExceptHandler) -> bool:
    return any(isinstance(n, ast.Raise) for n in ast.walk(handler))


def _check_fallback(mod: ModuleInfo, out: List[Finding]):
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Try):
            continue
        calls = {call_name(n) for stmt in node.body for n in ast.walk(stmt)
                 if isinstance(n, ast.Call)}
        if not (calls & LAUNCH_CALLS
                or any(c and c.endswith("_cuda") for c in calls)):
            continue
        for h in node.handlers:
            if _reraises(h):
                continue
            fi = mod.enclosing_function(node)
            func = fi.node if fi else None
            if mod.allows(h.lineno, "launch-fallback", func):
                continue
            out.append(Finding(
                PASS, "launch-fallback", mod.rel, h.lineno,
                fi.qualname if fi else "",
                "an except around a kernel build/launch that does not "
                "re-raise: a failed kernel must fail, not fall back to the "
                "plain version"))


def _only_raises(body: List[ast.stmt]) -> bool:
    return bool(body) and all(isinstance(s, ast.Raise) for s in body)


def _check_cuda_branch(mod: ModuleInfo, out: List[Finding]):
    for node in ast.walk(mod.tree):
        if not isinstance(node, (ast.If, ast.IfExp, ast.While)):
            continue
        if not any(isinstance(n, ast.Call)
                   and dotted_call(n).endswith("cuda.is_available")
                   for n in ast.walk(node.test)):
            continue
        if isinstance(node, ast.If) and _only_raises(node.body) \
                and not node.orelse:
            continue       # a refusal, not another path
        fi = mod.enclosing_function(node)
        func = fi.node if fi else None
        if mod.allows(node.lineno, "cuda-branch", func):
            continue
        out.append(Finding(
            PASS, "cuda-branch", mod.rel, node.lineno,
            fi.qualname if fi else "",
            "branch on torch.cuda.is_available() on a compute path: "
            "dispatch by the tensor's device (kernels/ops.py) and raise "
            "where the card is missing"))


def _device_test(test: ast.AST) -> bool:
    for n in ast.walk(test):
        if isinstance(n, ast.Call) and call_name(n) in DEVICE_TESTS:
            return True
        if isinstance(n, ast.Attribute) and (
                n.attr == "is_cuda" or (
                    n.attr == "type" and isinstance(n.value, ast.Attribute)
                    and n.value.attr == "device")):
            return True
    return False


def _check_ops_dispatch(mod: ModuleInfo, out: List[Finding]):
    if not mod.rel.endswith("kernels/ops.py"):
        return
    for node in ast.walk(mod.tree):
        if not isinstance(node, (ast.If, ast.IfExp)):
            continue
        if _device_test(node.test):
            continue
        fi = mod.enclosing_function(node)
        func = fi.node if fi else None
        if mod.allows(node.lineno, "ops-dispatch", func):
            continue
        out.append(Finding(
            PASS, "ops-dispatch", mod.rel, node.lineno,
            fi.qualname if fi else "",
            "kernels/ops.py branches on something else than the tensor's "
            "device: a CUDA tensor launches the kernel, a CPU tensor takes "
            "the plain version, nothing else decides"))


# ---------------------------------------------------------------------------
# registry-shapes (executed)
# ---------------------------------------------------------------------------

def check_registry_shapes() -> List[Finding]:
    """Every registered architecture (full and reduced) against the
    kernels' head dims, group, state dims and the sweep's page sizes, and
    every kernel instantiation's shared memory against the card.
    Executed, not AST: the registry is data."""
    out: List[Finding] = []
    try:
        from repro_torch.configs import registry
        from repro_torch.kernels import registry as kreg
    except Exception as e:   # a broken registry is a finding, not a crash
        out.append(Finding(
            PASS, "registry-shapes", "configs/registry.py", 1, "",
            f"could not import the config or kernel registry: {e}"))
        return out
    for name in registry.ARCH_IDS:
        for variant, cfg in (("full", registry.get_config(name)),
                             ("reduced", registry.reduced(
                                 registry.get_config(name)))):
            reasons = [kreg.check_page_size(cfg.max_seq_len, ps)
                       for ps in kreg.PAGE_SIZE_CHOICES]
            if cfg.mla is None:      # MLA decodes on its own einsum path
                reasons += [kreg.check_head_dim(cfg.resolved_head_dim),
                            kreg.check_group(cfg.n_heads, cfg.n_kv_heads)]
            if cfg.ssm is not None:
                reasons.append(kreg.check_state_dim(cfg.ssm.d_state))
            for msg in reasons:
                if msg is not None:
                    out.append(Finding(
                        PASS, "registry-shapes", "configs/registry.py", 1,
                        f"{name}:{variant}",
                        f"{msg} — no kernel of the port takes this shape"))
    for kname, nbytes in sorted(kreg.kernel_footprints().items()):
        msg = kreg.check_smem(kname, nbytes)
        if msg is not None:
            out.append(Finding(PASS, "registry-shapes",
                               "kernels/registry.py", 1, kname, msg))
    return out


# ---------------------------------------------------------------------------
# tuner-shapes (executed)
# ---------------------------------------------------------------------------

TUNER_ARCHS = ("smollm-135m", "gemma3-1b")   # pinned: one small, one local/
TUNER_SPEEDS = (1.0, 0.25)                   # global-pattern arch; 2 classes
TUNER_MAX_LEN = 2048


def check_tuner_shapes() -> List[Finding]:
    """Tuner-emitted geometry is legal: run the sweep for the pinned archs
    on each device class and re-verify every winner against the registry's
    rules, and that split-K decode at the winner's slots splits the sweep
    into whole pages. Executed, not AST — the winners are data the model
    produces, and a cost-model change that starts emitting an illegal
    geometry must fail here, not on the card."""
    out: List[Finding] = []
    try:
        from repro_torch.configs import registry
        from repro_torch.kernels import registry as kreg
        from repro_torch.kernels.decode_attention import split_plan
        from repro_torch.tuning import profile_for_speed, tune
    except Exception as e:   # a broken tuner is a finding, not a crash
        out.append(Finding(
            PASS, "tuner-shapes", "tuning/explorer.py", 1, "",
            f"could not import the tuner: {e}"))
        return out
    for name in TUNER_ARCHS:
        cfg = registry.get_config(name)
        for speed in TUNER_SPEEDS:
            prof = profile_for_speed(speed)
            for paged in (False, True):
                best = tune(cfg, prof, max_len=TUNER_MAX_LEN,
                            paged=paged).best
                checks = [
                    kreg.check_head_dim(cfg.resolved_head_dim),
                    kreg.check_slots(TUNER_MAX_LEN, best.n_slots),
                    kreg.check_prefill_chunk(best.prefill_chunk),
                ]
                if paged:
                    checks.append(kreg.check_page_size(TUNER_MAX_LEN,
                                                       best.page_size))
                    _, rows = split_plan(best.n_slots * cfg.n_kv_heads,
                                         TUNER_MAX_LEN, prof.sm_count,
                                         unit=best.page_size)
                    if rows % best.page_size:
                        checks.append(f"split_rows={rows} not a multiple "
                                      f"of page_size={best.page_size}")
                where = f"{name}:c{speed:.2f}x:" \
                    + ("paged" if paged else "dense")
                for reason in checks:
                    if reason is not None:
                        out.append(Finding(
                            PASS, "tuner-shapes", "tuning/explorer.py", 1,
                            where,
                            f"tuned geometry {best.geometry_key()} "
                            f"violates: {reason}"))
    return out


def run(ws: Workspace) -> List[Finding]:
    out: List[Finding] = []
    for mod in ws.select("kernels"):
        _check_launches(mod, out)
        _check_fallback(mod, out)
        _check_ops_dispatch(mod, out)
    for mod in ws.select(*COMPUTE_DIRS):
        _check_cuda_branch(mod, out)
    out.extend(check_registry_shapes())
    out.extend(check_tuner_shapes())
    return out
