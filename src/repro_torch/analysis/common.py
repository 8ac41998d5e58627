"""Shared infrastructure for the ``rc3e-check`` static analyzer (the
reference's, over the port's tree).

Every pass works from the same picture of the tree: a ``Workspace`` of
parsed modules, a per-function index (qualnames, call sites, pragma
lines), and the suppression machinery — inline ``# rc3e: allow-<rule>``
pragmas for sites that are *justified*, and a committed JSON baseline for
sites that are merely *grandfathered* (the debt ledger new code must not
grow). Findings carry exact locations so tests can pin them; baseline
matching deliberately ignores line numbers so moving code does not churn
the ledger.
"""
from __future__ import annotations

import ast
import dataclasses
import json
import re
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Set, Tuple

PRAGMA_RE = re.compile(r"#\s*rc3e:\s*allow-([a-z0-9-]+)")
PACKAGE = "repro_torch"          # relative paths start below this directory


@dataclasses.dataclass(frozen=True)
class Finding:
    """One analyzer hit. ``key()`` (pass, rule, file, symbol) is what the
    baseline stores — line numbers are reported but not matched on."""
    pass_name: str          # ownership | hostsync | determinism | kernels
    rule: str               # e.g. unguarded-acquire, host-sync, set-iteration
    file: str               # path relative to the scanned root
    line: int
    symbol: str             # enclosing function qualname ("" = module level)
    message: str

    def key(self) -> Tuple[str, str, str, str]:
        return (self.pass_name, self.rule, self.file, self.symbol)

    def format(self) -> str:
        sym = f" [{self.symbol}]" if self.symbol else ""
        return (f"{self.file}:{self.line}: "
                f"[{self.pass_name}/{self.rule}]{sym} {self.message}")


@dataclasses.dataclass
class FunctionInfo:
    """One function/method definition and everything passes ask about it."""
    qualname: str                   # "Class.method" or "func"
    name: str
    node: ast.AST                   # FunctionDef | AsyncFunctionDef
    module: "ModuleInfo"
    callees: Set[str]               # simple names of every call target

    @property
    def lineno(self) -> int:
        return self.node.lineno


class ModuleInfo:
    """A parsed source file plus its pragma map and function index."""

    def __init__(self, path: Path, rel: str, source: str):
        self.path = path
        self.rel = rel
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=str(path))
        # line -> set of allowed rule names from "# rc3e: allow-<rule>"
        self.pragmas: Dict[int, Set[str]] = {}
        for i, text in enumerate(self.lines, start=1):
            hits = PRAGMA_RE.findall(text)
            if hits:
                self.pragmas[i] = set(hits)
        self.functions: List[FunctionInfo] = []
        self._index_functions()

    def _index_functions(self):
        def visit(node, prefix):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    qual = f"{prefix}{child.name}"
                    self.functions.append(FunctionInfo(
                        qual, child.name, child, self,
                        callees=call_names(child)))
                    visit(child, f"{qual}.")
                elif isinstance(child, ast.ClassDef):
                    visit(child, f"{prefix}{child.name}.")
        visit(self.tree, "")

    def allows(self, line: int, rule: str, func: Optional[ast.AST] = None
               ) -> bool:
        """Pragma on the finding's line, or on/above the enclosing def
        (a def-line pragma waives the rule for the whole function)."""
        if rule in self.pragmas.get(line, ()):
            return True
        if func is not None:
            for ln in range(func.lineno,
                            getattr(func, "body", [func])[0].lineno):
                if rule in self.pragmas.get(ln, ()):
                    return True
        return False

    def enclosing_function(self, node: ast.AST) -> Optional[FunctionInfo]:
        best = None
        for fi in self.functions:
            f = fi.node
            end = getattr(f, "end_lineno", f.lineno)
            if f.lineno <= node.lineno <= end:
                if best is None or f.lineno > best.node.lineno:
                    best = fi
        return best


def call_name(node: ast.Call) -> Optional[str]:
    """Simple name of a call target: ``foo(..)`` -> foo, ``a.b.c(..)`` -> c."""
    f = node.func
    if isinstance(f, ast.Name):
        return f.id
    if isinstance(f, ast.Attribute):
        return f.attr
    return None


def call_names(node: ast.AST) -> Set[str]:
    return {n for c in ast.walk(node) if isinstance(c, ast.Call)
            for n in [call_name(c)] if n is not None}


def dotted_call(node: ast.Call) -> str:
    """Render ``a.b.c(...)``'s target as "a.b.c" (best effort)."""
    parts: List[str] = []
    f = node.func
    while isinstance(f, ast.Attribute):
        parts.append(f.attr)
        f = f.value
    if isinstance(f, ast.Name):
        parts.append(f.id)
    return ".".join(reversed(parts))


class Workspace:
    """All parsed modules under the scanned roots, plus a name-indexed
    function table for the (conservative, name-based) call graph."""

    def __init__(self, roots: Iterable[Path]):
        self.modules: List[ModuleInfo] = []
        seen: Set[Path] = set()
        for root in roots:
            root = root.resolve()
            files = [root] if root.is_file() else sorted(root.rglob("*.py"))
            for path in files:
                if path in seen:
                    continue
                seen.add(path)
                try:
                    src = path.read_text()
                    # canonical rel path: from the `repro_torch` package
                    # root when present, so baseline keys are identical
                    # whether the scan root is src/, src/repro_torch/ or a
                    # single file
                    parts = path.parts
                    if PACKAGE in parts:
                        i = len(parts) - 1 - parts[::-1].index(PACKAGE)
                        rel = "/".join(parts[i + 1:])
                    else:
                        base = root if root.is_dir() else root.parent
                        rel = path.relative_to(base).as_posix()
                    self.modules.append(ModuleInfo(path, rel, src))
                except (SyntaxError, UnicodeDecodeError) as e:
                    raise SystemExit(f"rc3e-check: cannot parse {path}: {e}")
        self.by_name: Dict[str, List[FunctionInfo]] = {}
        for mod in self.modules:
            for fi in mod.functions:
                self.by_name.setdefault(fi.name, []).append(fi)

    def select(self, *subdirs: str) -> List[ModuleInfo]:
        """Modules whose relative path contains any of ``subdirs`` (empty
        selection = every module)."""
        if not subdirs:
            return list(self.modules)
        return [m for m in self.modules
                if any(f"/{d}/" in f"/{m.rel}" for d in subdirs)]

    def reachable_from(self, qualname: str) -> Set[str]:
        """Name-based reachability: start at the function whose qualname
        matches, follow callee *simple names* to any same-named definition
        in the workspace. Over-approximates (any same-named method is
        considered a callee) — exactly right for a lint that must not miss
        the hot path through duck-typed hooks."""
        start = [fi for m in self.modules for fi in m.functions
                 if fi.qualname == qualname]
        seen: Set[int] = set()
        out: Set[str] = set()
        work = list(start)
        while work:
            fi = work.pop()
            if id(fi) in seen:
                continue
            seen.add(id(fi))
            out.add(f"{fi.module.rel}::{fi.qualname}")
            for name in fi.callees:
                work.extend(self.by_name.get(name, ()))
        return out


# ---------------------------------------------------------------------------
# Baseline (grandfathered findings)
# ---------------------------------------------------------------------------

def load_baseline(path: Optional[Path]) -> Set[Tuple[str, str, str, str]]:
    if path is None or not path.exists():
        return set()
    raw = json.loads(path.read_text())
    return {(e["pass"], e["rule"], e["file"], e.get("symbol", ""))
            for e in raw.get("findings", [])}


def write_baseline(path: Path, findings: List[Finding]) -> None:
    entries = sorted({f.key() for f in findings})
    path.write_text(json.dumps({
        "comment": "rc3e-check grandfathered findings; regenerate with "
                   "`python -m repro_torch.analysis src/repro_torch "
                   "--write-baseline`. "
                   "New code must ship clean or carry an inline "
                   "`# rc3e: allow-<rule>` pragma with a justification.",
        "findings": [{"pass": p, "rule": r, "file": f, "symbol": s}
                     for (p, r, f, s) in entries],
    }, indent=1) + "\n")


def apply_suppressions(findings: List[Finding],
                       baseline: Set[Tuple[str, str, str, str]]
                       ) -> Tuple[List[Finding], List[Finding]]:
    """Split into (unbaselined, baselined). Pragma suppression happens in
    the passes themselves (they know the enclosing function)."""
    fresh = [f for f in findings if f.key() not in baseline]
    old = [f for f in findings if f.key() in baseline]
    return fresh, old
