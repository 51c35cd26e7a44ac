"""AST passes: the determinism lint and the thread-sharing audit.

**determinism** — the repo's recovery math and its CI gates lean on
byte-reproducibility (byte-identical campaign CSVs, bit-identical
requeued decodes, deterministic trace exports), so code that smuggles
ambient nondeterminism in is a correctness bug, not a style issue:

``wall-clock``       ``time.time()`` / ``datetime.now()``: durations
                     must use the monotonic clocks, provenance stamps an
                     injectable clock (see ``repro_torch.ckpt``).
``unseeded-random``  module-level ``random.*`` / legacy ``np.random.*``
                     draws share hidden global state; use a seeded
                     ``Generator`` / ``random.Random`` instance.
``set-iteration``    iterating a set literal/constructor draws an
                     order that can vary with PYTHONHASHSEED; wrap in
                     ``sorted(...)``.
``builtin-hash``     ``hash()`` of str/bytes is salted per process —
                     anything persisted or compared across processes
                     must use a content hash.
``mutable-default``  a mutable default (``def f(x=[])`` or an unwrapped
                     dataclass field) is shared across calls/instances.

**thread-shared-state** — the feed thread (``exec/executor.py``) and
the async checkpoint writer (``ckpt/checkpoint.py``) must receive all
mutable inputs *by argument at submit time* (the snapshot is the
declared immutable channel). The audit resolves each thread target
(``pool.submit(f, ...)`` / ``threading.Thread(target=f)``), walks its
body plus same-class helper calls, and flags:

* writes to ``self.<attr>`` or ``nonlocal`` names from the thread body;
* reads of ``self.<attr>`` where the same class visibly reassigns the
  attribute outside ``__init__`` (mutable shared state, racy to read);
* reads of enclosing-function locals that are reassigned *after* the
  closure is defined (late-binding capture races).
"""
from __future__ import annotations

import ast
from pathlib import Path

from repro_torch.analysis.core import (Report, Violation, file_skipped,
                                 iter_source_files, suppressed_lines)

__all__ = ["AST_PASSES", "lint_source", "run_ast_passes"]

_WALL_CLOCK_CALLS = {
    ("time", "time"),
    ("datetime", "now"), ("datetime", "utcnow"), ("datetime", "today"),
    ("date", "today"),
}
_RANDOM_MODULE_FNS = {
    "random", "randint", "randrange", "choice", "choices", "shuffle",
    "sample", "uniform", "gauss", "normalvariate", "getrandbits",
    "betavariate", "expovariate", "seed",
}
# the np.random.* legacy global-state API; the Generator constructors
# are the sanctioned replacements
_NP_RANDOM_OK = {"default_rng", "Generator", "SeedSequence", "Philox",
                 "PCG64", "MT19937", "BitGenerator"}
_MUTABLE_CTORS = {"list", "dict", "set"}


def _attr_chain(node: ast.AST) -> list[str]:
    """``np.random.choice`` -> ["np", "random", "choice"] (best effort)."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return parts[::-1]


def _is_set_expr(node: ast.AST) -> bool:
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    return (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
            and node.func.id in ("set", "frozenset"))


class _DeterminismVisitor(ast.NodeVisitor):
    def __init__(self, path: str):
        self.path = path
        self.found: list[Violation] = []
        self._np_aliases = {"numpy"}         # names numpy is imported as

    def _emit(self, node: ast.AST, rule: str, msg: str) -> None:
        self.found.append(Violation(self.path, node.lineno, rule, msg))

    # -- imports: track numpy aliases ------------------------------ #
    def visit_Import(self, node: ast.Import) -> None:
        for alias in node.names:
            if alias.name == "numpy":
                self._np_aliases.add(alias.asname or "numpy")
        self.generic_visit(node)

    # -- calls ------------------------------------------------------ #
    def visit_Call(self, node: ast.Call) -> None:
        chain = _attr_chain(node.func)
        if len(chain) >= 2:
            if tuple(chain[-2:]) in _WALL_CLOCK_CALLS and \
                    chain[0] in ("time", "datetime"):
                self._emit(node, "wall-clock",
                           f"{'.'.join(chain)}() reads the wall clock; use "
                           "time.monotonic()/perf_counter() for durations "
                           "or inject a clock for provenance stamps")
            elif chain[0] == "random" and len(chain) == 2 and \
                    chain[1] in _RANDOM_MODULE_FNS:
                self._emit(node, "unseeded-random",
                           f"random.{chain[1]}() draws from the hidden "
                           "module-global state; use random.Random(seed)")
            elif len(chain) == 3 and chain[0] in self._np_aliases and \
                    chain[1] == "random" and chain[2] not in _NP_RANDOM_OK:
                self._emit(node, "unseeded-random",
                           f"{'.'.join(chain)}() uses the legacy global "
                           "RNG; use np.random.default_rng(seed)")
        elif chain == ["hash"]:
            self._emit(node, "builtin-hash",
                       "builtin hash() is salted per process "
                       "(PYTHONHASHSEED); use a content hash for anything "
                       "persisted or compared across processes")
        self.generic_visit(node)

    # -- set iteration ---------------------------------------------- #
    def _check_iter(self, it: ast.AST) -> None:
        if _is_set_expr(it):
            self._emit(it, "set-iteration",
                       "iteration order of a set can vary with "
                       "PYTHONHASHSEED; wrap in sorted(...)")

    def visit_For(self, node: ast.For) -> None:
        self._check_iter(node.iter)
        self.generic_visit(node)

    def visit_comprehension(self, node: ast.comprehension) -> None:
        self._check_iter(node.iter)
        self.generic_visit(node)

    # -- mutable defaults ------------------------------------------- #
    def _check_defaults(self, node) -> None:
        for d in list(node.args.defaults) + [d for d in
                                             node.args.kw_defaults if d]:
            if isinstance(d, (ast.List, ast.Dict, ast.Set)) or (
                    isinstance(d, ast.Call)
                    and isinstance(d.func, ast.Name)
                    and d.func.id in _MUTABLE_CTORS):
                self._emit(d, "mutable-default",
                           f"mutable default in {node.name}() is shared "
                           "across calls; default to None (or "
                           "dataclasses.field(default_factory=...))")

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self._check_defaults(node)
        self.generic_visit(node)

    def visit_AsyncFunctionDef(self, node: ast.AsyncFunctionDef) -> None:
        self._check_defaults(node)
        self.generic_visit(node)

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        is_dataclass = any(
            (isinstance(d, ast.Name) and d.id == "dataclass")
            or (isinstance(d, ast.Attribute) and d.attr == "dataclass")
            or (isinstance(d, ast.Call) and "dataclass" in _attr_chain(
                d.func)[-1:])
            for d in node.decorator_list)
        if is_dataclass:
            for stmt in node.body:
                if isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
                    v = stmt.value
                    if isinstance(v, (ast.List, ast.Dict, ast.Set)) or (
                            isinstance(v, ast.Call)
                            and isinstance(v.func, ast.Name)
                            and v.func.id in _MUTABLE_CTORS):
                        self.found.append(Violation(
                            self.path, stmt.lineno, "mutable-default",
                            f"dataclass field in {node.name} holds a "
                            "mutable default shared across instances; use "
                            "field(default_factory=...)"))
        self.generic_visit(node)


# ------------------------------------------------------------------ #
# thread-sharing audit                                               #
# ------------------------------------------------------------------ #
def _self_attr(node: ast.AST) -> str | None:
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and node.value.id == "self":
        return node.attr
    return None


class _ClassInfo:
    """Per-class mutation map: which self attributes are visibly
    reassigned outside ``__init__`` (mutable shared state)."""

    def __init__(self, node: ast.ClassDef):
        self.node = node
        self.methods = {m.name: m for m in node.body
                        if isinstance(m, (ast.FunctionDef,
                                          ast.AsyncFunctionDef))}
        self.mutated_outside_init: set[str] = set()
        for name, m in self.methods.items():
            if name == "__init__":
                continue
            for sub in ast.walk(m):
                targets = []
                if isinstance(sub, ast.Assign):
                    targets = sub.targets
                elif isinstance(sub, (ast.AugAssign, ast.AnnAssign)):
                    targets = [sub.target]
                for t in targets:
                    attr = _self_attr(t)
                    if attr:
                        self.mutated_outside_init.add(attr)


def _thread_targets(func: ast.AST) -> list[tuple[ast.Call, ast.AST]]:
    """(call, target_expr) for every thread hand-off in ``func``:
    ``<pool>.submit(f, ...)`` and ``threading.Thread(target=f)``."""
    out = []
    for node in ast.walk(func):
        if not isinstance(node, ast.Call):
            continue
        if isinstance(node.func, ast.Attribute) and \
                node.func.attr == "submit" and node.args:
            out.append((node, node.args[0]))
        chain = _attr_chain(node.func)
        if chain[-1:] == ["Thread"]:
            for kw in node.keywords:
                if kw.arg == "target":
                    out.append((node, kw.value))
    return out


class _ThreadAudit:
    MAX_DEPTH = 3

    def __init__(self, path: str, tree: ast.Module):
        self.path = path
        self.tree = tree
        self.found: list[Violation] = []
        self.classes = [_ClassInfo(n) for n in ast.walk(tree)
                        if isinstance(n, ast.ClassDef)]

    def run(self) -> list[Violation]:
        for cls in self.classes:
            for method in cls.methods.values():
                self._audit_scope(method, cls)
        for node in self.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._audit_scope(node, None)
        return self.found

    def _audit_scope(self, func: ast.AST, cls: _ClassInfo | None) -> None:
        for call, target in self._local_targets(func):
            if isinstance(target, ast.Attribute):
                attr = _self_attr(target)
                if attr and cls and attr in cls.methods:
                    self._audit_body(cls.methods[attr], cls, call,
                                     depth=0, seen={attr})
            elif isinstance(target, ast.Name):
                local = self._local_def(func, target.id)
                if local is not None:
                    self._audit_closure(local, func, cls, call)
                elif cls and target.id in cls.methods:
                    pass        # bare-name method ref: not a pattern used

    def _local_targets(self, func):
        return _thread_targets(func)

    @staticmethod
    def _local_def(func: ast.AST, name: str):
        for node in ast.walk(func):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and node.name == name:
                return node
        return None

    # -- method target: self.<attr> reads/writes -------------------- #
    def _audit_body(self, method, cls: _ClassInfo, call: ast.Call,
                    depth: int, seen: set[str]) -> None:
        if depth > self.MAX_DEPTH:
            return
        for node in ast.walk(method):
            targets = []
            if isinstance(node, ast.Assign):
                targets = node.targets
            elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
                targets = [node.target]
            for t in targets:
                attr = _self_attr(t)
                if attr:
                    self.found.append(Violation(
                        self.path, node.lineno, "thread-shared-state",
                        f"thread target {method.name}() writes "
                        f"self.{attr}; mutate shared state on the "
                        "submitting thread and pass results back"))
            if isinstance(node, ast.Call):
                attr = _self_attr(node.func)
                if attr and attr in cls.methods and attr not in seen:
                    seen.add(attr)
                    self._audit_body(cls.methods[attr], cls, call,
                                     depth + 1, seen)
        for node in ast.walk(method):
            if isinstance(node, ast.Attribute) and not isinstance(
                    node.ctx, ast.Store):
                attr = _self_attr(node)
                if attr and attr in cls.mutated_outside_init:
                    self.found.append(Violation(
                        self.path, node.lineno, "thread-shared-state",
                        f"thread target {method.name}() reads "
                        f"self.{attr}, which {cls.node.name} reassigns "
                        "outside __init__; snapshot it into the submit "
                        "arguments instead"))

    # -- closure target: captured locals + self reads --------------- #
    def _audit_closure(self, closure, enclosing, cls: _ClassInfo | None,
                       call: ast.Call) -> None:
        params = {a.arg for a in closure.args.args}
        local_names = set(params)
        for node in ast.walk(closure):
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        local_names.add(t.id)
            elif isinstance(node, ast.Nonlocal):
                self.found.append(Violation(
                    self.path, node.lineno, "thread-shared-state",
                    f"thread closure {closure.name}() rebinds nonlocal "
                    f"{', '.join(node.names)}; return the value and "
                    "assign on the submitting thread"))
        # self reads inside the closure body
        if cls is not None:
            for node in ast.walk(closure):
                attr = _self_attr(node)
                if attr and isinstance(node, ast.Attribute) and \
                        attr in cls.mutated_outside_init:
                    self.found.append(Violation(
                        self.path, node.lineno, "thread-shared-state",
                        f"thread closure {closure.name}() reads "
                        f"self.{attr}, which {cls.node.name} reassigns "
                        "outside __init__; snapshot it into a local "
                        "before defining the closure"))
        # late-binding captures: enclosing locals reassigned after the def
        reads = {node.id for node in ast.walk(closure)
                 if isinstance(node, ast.Name)
                 and isinstance(node.ctx, ast.Load)
                 and node.id not in local_names}
        for node in ast.walk(enclosing):
            if isinstance(node, ast.Assign) and \
                    node.lineno > closure.lineno:
                for t in node.targets:
                    if isinstance(t, ast.Name) and t.id in reads:
                        self.found.append(Violation(
                            self.path, node.lineno, "thread-shared-state",
                            f"{t.id} is reassigned after thread closure "
                            f"{closure.name}() captured it; the thread "
                            "may observe either value"))


def _determinism_pass(path: str, tree: ast.Module) -> list[Violation]:
    v = _DeterminismVisitor(path)
    v.visit(tree)
    return v.found


def _thread_pass(path: str, tree: ast.Module) -> list[Violation]:
    return _ThreadAudit(path, tree).run()


AST_PASSES = {
    "determinism": _determinism_pass,
    "thread-shared-state": _thread_pass,
}


def lint_source(path: str, source: str,
                passes=None) -> tuple[list[Violation], list[Violation]]:
    """Run the AST passes over one file; returns (violations,
    suppressed). Syntax errors surface as a ``parse-error`` finding
    rather than crashing the sweep."""
    if file_skipped(source):
        return [], []
    try:
        tree = ast.parse(source)
    except SyntaxError as e:
        return [Violation(path, e.lineno or 0, "parse-error",
                          f"file does not parse: {e.msg}")], []
    found: list[Violation] = []
    for name, fn in (passes or AST_PASSES).items():
        found.extend(fn(path, tree))
    sup = suppressed_lines(source)
    kept, quiet = [], []
    for v in sorted(found):
        (quiet if v.rule in sup.get(v.line, ()) else kept).append(v)
    return kept, quiet


def run_ast_passes(root: str | Path, report: Report | None = None) -> Report:
    """Lint every repo source file into a :class:`Report`."""
    from pathlib import Path as _P
    root = _P(root)
    report = report if report is not None else Report()
    n_files = 0
    for f in iter_source_files(root):
        n_files += 1
        kept, quiet = lint_source(str(f.relative_to(root)),
                                  f.read_text(encoding="utf-8"))
        report.violations.extend(kept)
        report.suppressed.extend(quiet)
    report.note("ast", files_scanned=n_files)
    return report
