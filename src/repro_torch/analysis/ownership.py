"""Ownership pass: linear-types discipline for RC3E's resource grants,
checked at rest.

The serving stack hand-maintains ~10 call-site conventions pairing every
resource *acquire* with exactly one *release*:

  * ``PagePoolManager`` — ``_alloc_one``/``admit``/``grow``/``cow`` vs
    ``_decref``/``release_slot`` (pool pages);
  * ``AdmissionController`` — ``admit_tenant``/``admit_request``/
    ``admit_serving_request`` vs ``release_tenant``/``finish_request``
    (quota charge vs settle);
  * the fleet recovery journal — append vs retire (``journal.pop`` /
    ``del journal[...]`` / the ``_on_finish`` settle path).

The chaos suite checks these dynamically (conservation after every
step); this pass checks the same discipline statically, so a refactor
that drops a rollback is caught before any seed ever has to find it.

Rules:

  * **unguarded-acquire** — an acquire call followed, in the same
    function, by a statement that can raise, with no matching release
    anywhere after it and no try/except/finally handler releasing it:
    the charge escapes on the error path.
  * **discarded-handle** — the result of a handle-returning acquire used
    as a bare expression statement: the handle is dropped on the floor
    and can never be released.
  * **unretired-cancel** — a function marking fleet requests cancelled
    (``_mark_cancelled``) without retiring their journal entries in the
    same function: a settled request could later be replayed.
  * **unscrubbed-free** — a function allocating pool pages
    (``pool.admit``/``pool.grow``/``pool.cow`` — every path that can hand
    a RECYCLED page to a new tenant) without the zero-on-free flush
    (``_flush_scrub``/``take_scrub``) anywhere in the same function: a
    freed tenant's KV could be re-exposed through a recycled page. The
    dynamic backstop is ``PagePoolManager._alloc_one``'s pending-scrub
    assert; this catches the bypass at rest.
"""
from __future__ import annotations

import ast
import dataclasses
from typing import List, Optional, Set

from repro_torch.analysis.common import (Finding, ModuleInfo, Workspace,
                                         call_name, dotted_call)

PASS = "ownership"


@dataclasses.dataclass(frozen=True)
class ResourceRule:
    name: str                 # resource family, used in messages
    acquires: frozenset      # call names that charge/allocate
    releases: frozenset      # call names that settle/free
    returns_handle: frozenset = frozenset()   # subset whose result is a handle


RULES = [
    ResourceRule(
        "pool-page",
        acquires=frozenset({"_alloc_one"}),
        releases=frozenset({"_decref", "release_slot"}),
        returns_handle=frozenset({"_alloc_one"})),
    ResourceRule(
        "admission-quota",
        acquires=frozenset({"admit_tenant", "admit_request",
                            "admit_serving_request"}),
        releases=frozenset({"release_tenant", "finish_request"})),
    ResourceRule(
        "vslice",
        acquires=frozenset({"allocate_slice", "allocate_vslice",
                            "allocate_exclusive", "open_serving_session"}),
        releases=frozenset({"release", "close_serving_session",
                            "mark_device_dead", "mark_node_dead"}),
        returns_handle=frozenset({"allocate_slice", "allocate_vslice",
                                  "open_serving_session"})),
    # note: PagePoolManager.grow/cow are NOT acquire rules — they register
    # the new page into the pool's slot block table before returning, so
    # the pool owns the handle from birth (release_slot frees it).
]

# Calls that cannot meaningfully raise mid-protocol: bookkeeping,
# logging, container ops, cheap builtins. Anything else after an acquire
# counts as fallible.
SAFE_CALLS = {
    "_log", "log", "append", "appendleft", "extend", "remove", "discard",
    "add", "pop", "popleft", "get", "set", "setdefault", "update", "clear",
    "items", "keys", "values", "copy", "join", "split", "format",
    "len", "int", "str", "float", "bool", "max", "min", "abs", "round",
    "sum", "any", "all", "sorted", "list", "dict", "tuple", "frozenset",
    "range", "enumerate", "zip", "next", "iter", "id", "hash", "repr",
    "isinstance", "issubclass", "getattr", "hasattr", "setattr",
    "monotonic", "time", "is_set", "deque", "count", "field", "replace",
    "print", "debug", "info", "warning",
    "heappush", "heappop", "heapify",
    # registered-state bookkeeping on already-validated handles, and the
    # injectable clock (a FakeClock/monotonic read)
    "set_slice_state", "clock",
    # sanitizer event points: emit() raises only on a lifecycle violation,
    # at which point the process is dying — not an escape path
    "emit", "scope",
}

JOURNAL_MARK = "_mark_cancelled"
JOURNAL_RETIRE_CALLS = {"_on_finish", "cancel_queued", "_retire_entry"}

# Every PagePoolManager entry point that can hand a RECYCLED page to a new
# tenant, and the scrub hooks that must run first (the engine's batched
# device-side zeroing, or a direct drain of the pending-scrub queue).
POOL_RECYCLE_CALLS = frozenset({"admit", "grow", "cow"})
SCRUB_HOOKS = frozenset({"_flush_scrub", "take_scrub"})


def _is_fallible(stmt: ast.stmt) -> Optional[ast.AST]:
    """First node in ``stmt`` that can raise: a non-safe call, or an
    explicit raise/assert."""
    for node in ast.walk(stmt):
        if isinstance(node, (ast.Raise, ast.Assert)):
            return node
        if isinstance(node, ast.Call):
            name = call_name(node)
            if name is not None and name not in SAFE_CALLS:
                return node
    return None


def _calls_in(nodes) -> Set[str]:
    out: Set[str] = set()
    for n in nodes:
        for c in ast.walk(n):
            if isinstance(c, ast.Call):
                name = call_name(c)
                if name:
                    out.add(name)
    return out


def _protecting_trys(func: ast.AST, node: ast.AST,
                     releases: frozenset) -> bool:
    """Is ``node`` inside a try whose except handlers or finally body
    release the resource? (The codebase's rollback idiom.)"""
    for t in ast.walk(func):
        if not isinstance(t, ast.Try):
            continue
        start = t.body[0].lineno
        end = max(getattr(s, "end_lineno", s.lineno) for s in t.body)
        if not (start <= node.lineno <= end):
            continue
        guarded = _calls_in(t.handlers) | _calls_in(t.finalbody)
        if guarded & releases:
            return True
    return False


def _handler_ranges(func: ast.AST, line: int) -> List[tuple]:
    """Line ranges of except handlers belonging to trys whose body holds
    ``line``: those statements only run if the acquire (or something
    before it) ALREADY failed, so they are not escape paths for it."""
    out = []
    for t in ast.walk(func):
        if not isinstance(t, ast.Try):
            continue
        start = t.body[0].lineno
        end = max(getattr(s, "end_lineno", s.lineno) for s in t.body)
        if not (start <= line <= end):
            continue
        for h in t.handlers:
            out.append((h.lineno, getattr(h, "end_lineno", h.lineno)))
    return out


def _statements_after(func: ast.AST, line: int,
                      include_handlers: bool = True) -> List[ast.stmt]:
    """Top-to-bottom statements of ``func`` strictly after ``line``
    (flattened: a statement inside try/if bodies appears itself).
    ``include_handlers=False`` drops the acquire's own except handlers —
    they only run when the protocol already failed, so they are release
    paths, not escape paths."""
    skip = [] if include_handlers else _handler_ranges(func, line)
    out = []
    for node in ast.walk(func):
        if isinstance(node, ast.stmt) and node.lineno > line \
                and not isinstance(node, (ast.FunctionDef,
                                          ast.AsyncFunctionDef,
                                          ast.ClassDef)) \
                and not any(a <= node.lineno <= b for a, b in skip):
            out.append(node)
    return sorted(out, key=lambda s: s.lineno)


def _release_after(func: ast.AST, line: int, releases: frozenset) -> bool:
    for stmt in _statements_after(func, line):
        for c in ast.walk(stmt):
            if isinstance(c, ast.Call) and call_name(c) in releases:
                return True
    return False


def _check_unguarded(fi, rule: ResourceRule, out: List[Finding]):
    mod = fi.module
    func = fi.node
    for node in ast.walk(func):
        if not isinstance(node, ast.Call):
            continue
        name = call_name(node)
        if name not in rule.acquires or name == fi.name:
            continue       # skip the definition's own recursion
        if _release_after(func, node.lineno, rule.releases):
            continue       # a settle path exists downstream
        # find the first fallible statement after the acquire that is not
        # itself protected by a rollback try
        for stmt in _statements_after(func, node.lineno,
                                      include_handlers=False):
            bad = _is_fallible(stmt)
            if bad is None:
                continue
            if _protecting_trys(func, stmt, rule.releases):
                break      # rollback handler covers the remainder
            if mod.allows(node.lineno, "unguarded-acquire", func):
                break
            out.append(Finding(
                PASS, "unguarded-acquire", mod.rel, node.lineno,
                fi.qualname,
                f"{rule.name} acquired via {dotted_call(node)}() can "
                f"escape: line {stmt.lineno} may raise before any "
                f"matching release ({'/'.join(sorted(rule.releases))}) "
                "— wrap in try/except with a rollback, or release on "
                "the error path"))
            break
        # note: an acquire as the last fallible action needs no guard


def _check_discarded(mod: ModuleInfo, out: List[Finding]):
    handle_names = {n for r in RULES for n in r.returns_handle}
    rule_of = {n: r for r in RULES for n in r.returns_handle}
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Expr) \
                or not isinstance(node.value, ast.Call):
            continue
        name = call_name(node.value)
        if name not in handle_names:
            continue
        fi = mod.enclosing_function(node)
        if fi is not None and fi.name == name:
            continue
        func = fi.node if fi is not None else None
        if mod.allows(node.lineno, "discarded-handle", func):
            continue
        out.append(Finding(
            PASS, "discarded-handle", mod.rel, node.lineno,
            fi.qualname if fi else "",
            f"result of {dotted_call(node.value)}() discarded: the "
            f"{rule_of[name].name} handle escapes without an owner and "
            "can never be released"))


def _check_unscrubbed(fi, out: List[Finding]):
    """Pool allocation sites must sit behind the zero-on-free flush: a
    function calling ``pool.admit``/``pool.grow``/``pool.cow`` without a
    scrub hook in the same function can re-expose a freed tenant's KV
    through a recycled page. (``_alloc_one``'s pending-scrub assert is the
    dynamic backstop; this flags the bypass at rest.)"""
    if fi.callees & SCRUB_HOOKS:
        return
    mod = fi.module
    for node in ast.walk(fi.node):
        if not isinstance(node, ast.Call) \
                or call_name(node) not in POOL_RECYCLE_CALLS:
            continue
        recv = node.func.value if isinstance(node.func, ast.Attribute) \
            else None
        recv_name = recv.attr if isinstance(recv, ast.Attribute) else \
            recv.id if isinstance(recv, ast.Name) else None
        if recv_name != "pool":
            continue
        if mod.allows(node.lineno, "unscrubbed-free", fi.node):
            continue
        out.append(Finding(
            PASS, "unscrubbed-free", mod.rel, node.lineno, fi.qualname,
            f"pool pages allocated via {dotted_call(node)}() with no "
            "zero-on-free flush in this function: a recycled page may "
            "still hold a freed tenant's KV — call _flush_scrub() (or "
            "drain take_scrub()) before any pool allocation"))


def _check_journal(mod: ModuleInfo, out: List[Finding]):
    """Functions cancelling journaled requests must retire the journal
    entry in the same function (pop/del/_on_finish) — a settled request
    must never be replayable."""
    for fi in mod.functions:
        if fi.name == JOURNAL_MARK:
            continue
        marks = [n for n in ast.walk(fi.node) if isinstance(n, ast.Call)
                 and call_name(n) == JOURNAL_MARK]
        if not marks:
            continue
        retired = bool(fi.callees & JOURNAL_RETIRE_CALLS)
        if not retired:
            for n in ast.walk(fi.node):
                # journal.pop(...) / del self.journal[...]
                if isinstance(n, ast.Call) and call_name(n) == "pop" \
                        and isinstance(n.func, ast.Attribute) \
                        and isinstance(n.func.value, ast.Attribute) \
                        and n.func.value.attr == "journal":
                    retired = True
                if isinstance(n, ast.Delete):
                    for t in n.targets:
                        if isinstance(t, ast.Subscript) \
                                and isinstance(t.value, ast.Attribute) \
                                and t.value.attr == "journal":
                            retired = True
        if retired:
            continue
        node = marks[0]
        if mod.allows(node.lineno, "unretired-cancel", fi.node):
            continue
        out.append(Finding(
            PASS, "unretired-cancel", mod.rel, node.lineno, fi.qualname,
            f"{JOURNAL_MARK}() without retiring the journal entry in the "
            "same function: a cancelled (settled) request would stay "
            "journaled and could be replayed by a later recovery"))


def run(ws: Workspace) -> List[Finding]:
    out: List[Finding] = []
    for mod in ws.modules:
        for fi in mod.functions:
            for rule in RULES:
                _check_unguarded(fi, rule, out)
            _check_unscrubbed(fi, out)
        _check_discarded(mod, out)
        _check_journal(mod, out)
    return out
