"""Determinism pass.

The chaos harness (``runtime/faults.py``) replays seeded kill schedules
bit-exactly; that only holds if the runtime is a pure function of (seed,
workload). Four things silently break it:

  * **time-time** — ``time.time()`` (wall clock) in ``runtime/`` or
    ``core/``: chaos runs use the injectable ``FakeClock``; wall-clock
    reads make replays diverge. ``time.monotonic()`` stays legal — the
    codebase uses it for latency *measurement*, never control flow.
  * **unseeded-random** — ``random.random()``, ``random.choice``, bare
    ``random.Random()``: any randomness must flow through
    ``repro_torch.runtime.faults.seeded_rng(seed)`` so a seed pins the
    run. Enforced tree-wide.
  * **set-iteration** — ``for x in <set-literal/set()/set-typed attr>``:
    Python set iteration order is salted per process; iterating one in
    ``runtime/``/``core/`` makes event order differ between runs. Wrap
    in ``sorted(...)`` to fix the order.
  * **round-counter** — reading the fleet-wide round counter
    (``.steps``) inside the event loop (``runtime/events.py``): event
    code paced by the lockstep round counter silently re-introduces the
    barrier the event queue exists to remove. The loop keeps its own
    ``ticks`` count; engine-local pacing belongs in the engine.
"""
from __future__ import annotations

import ast
from typing import List, Optional

from repro_torch.analysis.common import Finding, ModuleInfo, Workspace

PASS = "determinism"

SCOPED_DIRS = ("runtime", "core")      # time-time / set-iteration scope
RNG_HELPER = "seeded_rng"              # the one sanctioned constructor

UNSEEDED_RANDOM_FUNCS = {
    "random", "randint", "randrange", "choice", "choices", "shuffle",
    "sample", "uniform", "gauss", "normalvariate", "betavariate",
    "expovariate",
}


def _attr_chain(node: ast.AST) -> Optional[str]:
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _check_time(mod: ModuleInfo, out: List[Finding]):
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        if _attr_chain(node.func) != "time.time":
            continue
        fi = mod.enclosing_function(node)
        func = fi.node if fi else None
        if mod.allows(node.lineno, "time-time", func):
            continue
        out.append(Finding(
            PASS, "time-time", mod.rel, node.lineno,
            fi.qualname if fi else "",
            "time.time() reads the wall clock — chaos replays use the "
            "injectable FakeClock; use time.monotonic() for durations or "
            "take a clock parameter"))


def _check_random(mod: ModuleInfo, out: List[Finding]):
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        chain = _attr_chain(node.func)
        if chain is None:
            continue
        bad = ""
        if chain.startswith("random.") \
                and chain.split(".", 1)[1] in UNSEEDED_RANDOM_FUNCS:
            bad = f"{chain}() draws from the process-global unseeded RNG"
        elif chain in ("random.Random", "Random"):
            # even a seeded construction bypasses the choke point: the
            # helper is where seed derivation / reproducibility lives
            bad = f"{chain}() constructed outside {RNG_HELPER}()"
        if not bad:
            continue
        fi = mod.enclosing_function(node)
        if fi is not None and fi.name == RNG_HELPER:
            continue    # the sanctioned choke point itself
        func = fi.node if fi else None
        if mod.allows(node.lineno, "unseeded-random", func):
            continue
        out.append(Finding(
            PASS, "unseeded-random", mod.rel, node.lineno,
            fi.qualname if fi else "",
            f"{bad} — route it through "
            f"repro_torch.runtime.faults.{RNG_HELPER}(seed) so a seed pins "
            "the whole run"))


def _is_set_expr(node: ast.AST) -> bool:
    if isinstance(node, ast.Set):
        return True
    if isinstance(node, ast.SetComp):
        return True
    if isinstance(node, ast.Call):
        f = node.func
        if isinstance(f, ast.Name) and f.id in ("set", "frozenset"):
            return True
        # .keys() of a dict is insertion-ordered: fine. set ops are not.
        if isinstance(f, ast.Attribute) and f.attr in (
                "union", "intersection", "difference",
                "symmetric_difference"):
            return True
    if isinstance(node, ast.BinOp) and isinstance(
            node.op, (ast.BitOr, ast.BitAnd, ast.Sub, ast.BitXor)):
        # a | b etc. over sets — only flag when one side is clearly a set
        return _is_set_expr(node.left) or _is_set_expr(node.right)
    return False


def _set_typed_names(scope: ast.AST) -> set:
    """Local names bound to a set expression (``s = set(xs)``; ``s = {..}``)
    anywhere in ``scope`` — iterating them later is just as unordered."""
    names = set()
    for node in ast.walk(scope):
        if isinstance(node, ast.Assign) and _is_set_expr(node.value):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    names.add(t.id)
    return names


def _check_set_iter(mod: ModuleInfo, out: List[Finding]):
    set_names = {}   # function node -> names bound to sets
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.For):
            it = node.iter
        elif isinstance(node, ast.comprehension):
            it = node.iter
        else:
            continue
        direct = _is_set_expr(it)
        via_name = False
        if not direct and isinstance(it, ast.Name):
            fi0 = mod.enclosing_function(it)
            scope = fi0.node if fi0 else mod.tree
            if scope not in set_names:
                set_names[scope] = _set_typed_names(scope)
            via_name = it.id in set_names[scope]
        if not (direct or via_name):
            continue
        fi = mod.enclosing_function(it)
        func = fi.node if fi else None
        if mod.allows(it.lineno, "set-iteration", func):
            continue
        out.append(Finding(
            PASS, "set-iteration", mod.rel, it.lineno,
            fi.qualname if fi else "",
            "iterating a set: order is salted per process, so event "
            "order differs between runs — wrap in sorted(...) or iterate "
            "the ordered source collection"))


EVENT_LOOP_SUFFIXES = ("runtime/events.py",)
ROUND_COUNTER_ATTR = "steps"


def _check_round_counter(mod: ModuleInfo, out: List[Finding]):
    """Flag READS of ``.steps`` in event-loop modules. Stores/AugAssigns
    are fine (an engine counts its own steps); it is basing event-loop
    control flow on the fleet round counter that re-couples the loops."""
    if not any(mod.rel.endswith(s) for s in EVENT_LOOP_SUFFIXES):
        return
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Attribute) \
                or node.attr != ROUND_COUNTER_ATTR \
                or not isinstance(node.ctx, ast.Load):
            continue
        fi = mod.enclosing_function(node)
        func = fi.node if fi else None
        if mod.allows(node.lineno, "round-counter", func):
            continue
        out.append(Finding(
            PASS, "round-counter", mod.rel, node.lineno,
            fi.qualname if fi else "",
            "event-loop code reading the fleet round counter (.steps) — "
            "pacing events off the lockstep round counter re-introduces "
            "the barrier; use the loop's own ticks / the event clock"))


def run(ws: Workspace) -> List[Finding]:
    out: List[Finding] = []
    scoped = ws.select(*SCOPED_DIRS)
    for mod in scoped:
        _check_time(mod, out)
        _check_set_iter(mod, out)
        _check_round_counter(mod, out)
    for mod in ws.modules:          # unseeded randomness: repo-wide
        _check_random(mod, out)
    return out
