"""Static AST lint for the comm-API invariants (the port's copy of
``repro.analysis.lint``, with the raw-collective rule restated for
PyTorch).

    PYTHONPATH=src python -m repro_torch.analysis.lint [PATH ...]

lints ``src/repro_torch`` by default: ``SHMEMLINT_PASS`` and exit 0, or
one ``path:line: [rule] message`` line a finding, then
``SHMEMLINT_FAIL findings=N`` and exit 1 (``scripts/shmemlint.py``'s
contract).

Four rules, each encoding a convention the substrate's correctness
arguments lean on but that nothing enforced mechanically until now:

  nbi-drain           every ``*_nbi`` issue must be dominated by a
                      ``fence``/``quiet``/``signal_wait_until``/
                      ``amo_wait`` on all
                      paths to the end of its function: a function that
                      issues and returns with the op still pending has
                      silently widened its contract to "caller must
                      drain" (``put_signal_nbi`` ends in ``_nbi`` and
                      so is covered; its paired wait is the drain the
                      rule accepts for it).  Explicitly
                      deferred drains are annotated
                      ``# shmem: deferred-drain`` on the call line or
                      the enclosing ``def`` line (the CommQueue wrapper
                      functions themselves, proposer-style pipelines).

  raw-collective      no ``torch.distributed`` collective (nor its
                      point-to-point send / recv), and no direct call
                      into ``repro_torch.core.collectives`` (its module
                      or the names ``repro_torch.core`` re-exports from
                      it), outside ``repro_torch/comm/`` and
                      ``repro_torch/core/`` — every collective goes
                      through a ``Communicator`` so backend dispatch,
                      instrumentation and the safety guard see it.
                      ``RAW_COLLECTIVE_EXEMPT`` names the files that
                      call the schedules directly on purpose, each with
                      its reason.  (Rank and size queries are no
                      collectives and stay legal everywhere.)

  handle-after-free   a ``SymHandle`` variable must not be used after
                      being passed to ``free`` — the CommQueue would
                      happily deliver through the stale name (the
                      static twin of shmemcheck's use-after-free).

  drain-callback      a callback handed to ``allreduce_nbi`` runs
                      inside the drain; calling ``fence``/``quiet``/
                      ``barrier*`` there re-enters completion handling
                      (the deadlock analogue shmemcheck flags
                      dynamically as ``nested-drain``).

The analysis is deliberately conservative and function-local: loops
may run zero times (a drain inside one does not dominate), ``raise``
is an accepted exit (exceptional paths abandon the queue), and traced
or dynamic control flow falls back to "not drained".
"""
from __future__ import annotations

import ast
import dataclasses
import os
from typing import Optional

DEFER_ANNOTATION = "shmem: deferred-drain"

# directories where the schedules and their transports are the
# implementation, not a bypass (matched on '/'-separated paths)
RAW_COLLECTIVE_ALLOWED = ("repro_torch/comm/", "repro_torch/core/")

# files outside them that call core.collectives directly, and why
RAW_COLLECTIVE_EXEMPT = {
    "repro_torch/launch/comm_bench.py":
        "its schedule sweep times every algorithm of each collective "
        "without the communicator's dispatch: the numbers the dispatch "
        "table is tuned from",
}

# torch.distributed's collectives and point-to-point calls
TORCH_COLLECTIVES = frozenset({
    "all_reduce", "all_gather", "all_gather_into_tensor",
    "all_gather_object", "reduce", "reduce_scatter",
    "reduce_scatter_tensor", "all_to_all", "all_to_all_single",
    "broadcast", "broadcast_object_list", "barrier", "monitored_barrier",
    "scatter", "scatter_object_list", "gather", "gather_object", "send",
    "recv", "isend", "irecv", "batch_isend_irecv",
})

# what repro_torch.core re-exports from core.collectives
CORE_COLLECTIVES = frozenset({
    "allreduce", "alltoall", "barrier_all", "broadcast", "fcollect",
    "reduce", "reduce_scatter",
})

# signal_wait_until is the put-with-signal extension's per-transfer
# drain point (core.signals): it validly completes the guarded
# put_signal_nbi, so the nbi-drain walk accepts it next to fence/quiet
# — and, being a drain, it is just as illegal inside a drain callback.
# amo_wait is the same per-word completion point for atomics
# (core.atomics): amo_nbi issues retire under it without a fence.
DRAIN_NAMES = frozenset({"fence", "quiet", "signal_wait_until",
                         "amo_wait"})
DRAIN_CALLBACK_FORBIDDEN = frozenset(
    {"fence", "quiet", "barrier", "barrier_all", "signal_wait_until",
     "amo_wait"})

# path-status lattice for the post-dominator scan
_DRAINED, _BAD, _CONT = "drained", "bad", "continue"


@dataclasses.dataclass(frozen=True)
class LintError:
    path: str
    line: int
    rule: str
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


# ======================================================================
# shared AST helpers
# ======================================================================
def _call_name(call: ast.Call) -> Optional[str]:
    f = call.func
    if isinstance(f, ast.Attribute):
        return f.attr
    if isinstance(f, ast.Name):
        return f.id
    return None


def _is_drain_call(node: ast.AST) -> bool:
    return (isinstance(node, ast.Call)
            and _call_name(node) in DRAIN_NAMES)


def _contains_drain(node: ast.AST) -> bool:
    """A drain call anywhere in this expression/statement, excluding
    nested function bodies (their execution is deferred)."""
    for sub in _walk_no_nested_defs(node):
        if _is_drain_call(sub):
            return True
    return False


def _walk_no_nested_defs(node: ast.AST):
    stack = [node]
    while stack:
        n = stack.pop()
        yield n
        for child in ast.iter_child_nodes(n):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)) and child is not node:
                continue
            stack.append(child)


def _annotated(lines: list[str], lineno: int) -> bool:
    if 1 <= lineno <= len(lines):
        return DEFER_ANNOTATION in lines[lineno - 1]
    return False


# ======================================================================
# rule: nbi-drain — post-dominating drain on all paths
# ======================================================================
def _path_status(stmts: list[ast.stmt]) -> str:
    """Walk a statement list: does every path through it reach an
    unconditional drain before leaving the function normally?

    _DRAINED  every path hits a drain inside this list
    _BAD      some path returns (function exit) without a drain
    _CONT     control can fall off the end of this list undrained
    """
    for s in stmts:
        if isinstance(s, ast.Return):
            return _DRAINED if _contains_drain(s) else _BAD
        if isinstance(s, ast.Raise):
            return _DRAINED          # exceptional exit: queue abandoned
        if isinstance(s, (ast.Break, ast.Continue)):
            return _CONT             # loop-local jump: resolved upward
        if isinstance(s, ast.If):
            sb = _path_status(s.body)
            so = _path_status(s.orelse) if s.orelse else _CONT
            if _BAD in (sb, so):
                return _BAD
            if sb == so == _DRAINED:
                return _DRAINED
            continue                 # some branch falls through: scan on
        if isinstance(s, (ast.For, ast.AsyncFor, ast.While)):
            body = _path_status(s.body)
            if body == _BAD or (s.orelse
                                and _path_status(s.orelse) == _BAD):
                return _BAD
            continue                 # zero iterations possible: no drain
        if isinstance(s, (ast.With, ast.AsyncWith)):
            sw = _path_status(s.body)
            if sw != _CONT:
                return sw
            continue
        if isinstance(s, ast.Try):
            parts = [s.body] + [h.body for h in s.handlers]
            if s.orelse:
                parts.append(s.orelse)
            if any(_path_status(p) == _BAD for p in parts):
                return _BAD
            if s.finalbody:
                sf = _path_status(s.finalbody)
                if sf != _CONT:
                    return sf
            if all(_path_status(p) == _DRAINED
                   for p in [s.body] + [h.body for h in s.handlers]):
                return _DRAINED
            continue
        if _contains_drain(s):
            return _DRAINED
    return _CONT


class _NbiDrainRule(ast.NodeVisitor):
    def __init__(self, path: str, lines: list[str]):
        self.path = path
        self.lines = lines
        self.errors: list[LintError] = []

    def visit_FunctionDef(self, node):
        self._check_function(node)
        self.generic_visit(node)     # nested defs checked on their own

    visit_AsyncFunctionDef = visit_FunctionDef

    def _check_function(self, fn) -> None:
        if _annotated(self.lines, fn.lineno):
            return
        for call, chain in _nbi_calls_with_chain(fn):
            if _annotated(self.lines, call.lineno):
                continue
            if not self._drained(chain):
                name = _call_name(call)
                self.errors.append(LintError(
                    self.path, call.lineno, "nbi-drain",
                    f"'{name}' is not followed by a fence/quiet on all "
                    f"paths of '{fn.name}' — drain before returning, or "
                    f"annotate the call '# {DEFER_ANNOTATION}' if the "
                    f"caller owns the drain"))

    @staticmethod
    def _drained(chain) -> bool:
        """chain: [(stmt_list, index), ...] innermost block last.  The
        issue is covered if, at some enclosing level, everything after
        it drains on all paths (and no level exposes an undrained
        return first)."""
        for stmts, idx in reversed(chain):
            status = _path_status(stmts[idx + 1:])
            if status == _DRAINED:
                return True
            if status == _BAD:
                return False
        return False


def _nbi_calls_with_chain(fn):
    """Yield (call, enclosing-block chain) for every ``*_nbi`` call in
    ``fn``, excluding nested function bodies."""
    out = []

    def walk_block(stmts, chain):
        for i, s in enumerate(stmts):
            here = chain + [(stmts, i)]
            for sub in _walk_no_nested_defs_stmt(s):
                if isinstance(sub, ast.Call):
                    name = _call_name(sub)
                    if name and name.endswith("_nbi") \
                            and not name.startswith("on_"):
                        # on_*_nbi are observer hooks, not issue APIs
                        out.append((sub, here))
            for blk in _child_blocks(s):
                walk_block(blk, here)

    walk_block(fn.body, [])
    return out


def _child_blocks(stmt):
    blocks = []
    for field in ("body", "orelse", "finalbody"):
        val = getattr(stmt, field, None)
        if val and isinstance(val, list) \
                and all(isinstance(x, ast.stmt) for x in val):
            blocks.append(val)
    for h in getattr(stmt, "handlers", []) or []:
        blocks.append(h.body)
    return blocks


def _walk_no_nested_defs_stmt(stmt):
    """Expressions of one statement only: neither nested statement
    blocks (walked separately) nor deferred function bodies."""
    todo = [stmt]
    while todo:
        n = todo.pop()
        yield n
        for child in ast.iter_child_nodes(n):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda, ast.stmt)):
                continue
            todo.append(child)


# ======================================================================
# rule: raw-collective
# ======================================================================
def _dotted(node: ast.AST) -> Optional[str]:
    """``a.b.c`` of a Name/Attribute chain, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(node.id)
    return ".".join(reversed(parts))


def _is_collectives(mod: str, level: int) -> bool:
    """``from <mod> import ...`` (``level`` leading dots, inside the
    package) names the module ``repro_torch.core.collectives``."""
    if level:
        return mod in ("collectives", "core.collectives")
    return mod == "repro_torch.core.collectives"


def _is_core(mod: str, level: int) -> bool:
    """... names the package ``repro_torch.core``."""
    return mod == "core" if level else mod == "repro_torch.core"


def _raw_bindings(tree):
    """Names in this module that lead to a raw collective: (module
    aliases, collective function names), from its imports."""
    dist_mods = {"torch.distributed"}      # dotted prefixes of the module
    coll_mods: set[str] = set()
    funcs: dict[str, str] = {}            # local name -> what it is
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "torch.distributed" and a.asname:
                    dist_mods.add(a.asname)
                elif _is_collectives(a.name, 0):
                    coll_mods.add(a.asname or a.name)
        elif isinstance(node, ast.ImportFrom):
            mod, level = node.module or "", node.level
            for a in node.names:
                local = a.asname or a.name
                if mod == "torch" and a.name == "distributed":
                    dist_mods.add(local)
                elif mod == "torch.distributed" \
                        and a.name in TORCH_COLLECTIVES:
                    funcs[local] = f"torch.distributed.{a.name}"
                elif _is_collectives(mod, level):
                    funcs[local] = f"repro_torch.core.collectives.{a.name}"
                elif _is_core(mod, level) and a.name == "collectives":
                    coll_mods.add(local)
                elif _is_core(mod, level) and a.name in CORE_COLLECTIVES:
                    funcs[local] = f"repro_torch.core.{a.name}"
    return dist_mods, coll_mods, funcs


def _raw_collective(call: ast.Call, dist_mods, coll_mods, funcs
                    ) -> Optional[str]:
    f = call.func
    if isinstance(f, ast.Name):
        return funcs.get(f.id)
    if not isinstance(f, ast.Attribute):
        return None
    owner = _dotted(f.value)
    if owner is None:
        return None
    if owner in dist_mods and f.attr in TORCH_COLLECTIVES:
        return f"torch.distributed.{f.attr}"
    if owner in coll_mods or owner == "repro_torch.core.collectives":
        return f"repro_torch.core.collectives.{f.attr}"
    if owner == "repro_torch.core" and f.attr in CORE_COLLECTIVES:
        return f"repro_torch.core.{f.attr}"
    return None


def _raw_collective_errors(tree, path: str, relpath: str):
    rel = "/" + relpath.replace(os.sep, "/")
    if any("/" + a in rel for a in RAW_COLLECTIVE_ALLOWED) \
            or any(rel.endswith("/" + f) for f in RAW_COLLECTIVE_EXEMPT):
        return []
    bindings = _raw_bindings(tree)
    errors = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            name = _raw_collective(node, *bindings)
            if name:
                errors.append(LintError(
                    path, node.lineno, "raw-collective",
                    f"raw {name} outside repro_torch/comm|core: route it "
                    f"through a Communicator (ctx.tp_comm/dp_comm) so "
                    f"dispatch, instrumentation and the safety guard "
                    f"see it"))
    return errors


# ======================================================================
# rule: handle-after-free
# ======================================================================
ALLOC_METHODS = frozenset({"alloc", "align_alloc", "realloc"})


class _HandleAfterFreeRule(ast.NodeVisitor):
    def __init__(self, path: str):
        self.path = path
        self.errors: list[LintError] = []

    def visit_FunctionDef(self, node):
        self._check(node)
        self.generic_visit(node)

    visit_AsyncFunctionDef = visit_FunctionDef

    def _check(self, fn) -> None:
        allocated: set[str] = set()
        freed: dict[str, int] = {}          # var -> line of the free
        for node in _walk_in_lineno_order(fn):
            if isinstance(node, ast.Assign):
                v = node.value
                if isinstance(v, ast.Call) \
                        and _call_name(v) in ALLOC_METHODS:
                    for t in node.targets:
                        if isinstance(t, ast.Name):
                            allocated.add(t.id)
                            freed.pop(t.id, None)
                else:
                    for t in node.targets:
                        if isinstance(t, ast.Name):
                            freed.pop(t.id, None)  # rebound: new object
            elif isinstance(node, ast.Call) and _call_name(node) == "free":
                for a in node.args:
                    if isinstance(a, ast.Name) and a.id in allocated:
                        freed[a.id] = node.lineno
            elif isinstance(node, ast.Name) \
                    and isinstance(node.ctx, ast.Load) \
                    and node.id in freed and node.lineno > freed[node.id]:
                self.errors.append(LintError(
                    self.path, node.lineno, "handle-after-free",
                    f"SymHandle '{node.id}' used after free "
                    f"(freed at line {freed[node.id]}) — the queue would "
                    f"deliver through the stale symmetric name"))
                freed.pop(node.id)          # one report per free


def _walk_in_lineno_order(fn):
    nodes = [n for n in _walk_no_nested_defs(fn)
             if hasattr(n, "lineno")]
    seen_free_args = set()
    # the free(...) call's own argument is a legal (last) use
    for n in nodes:
        if isinstance(n, ast.Call) and _call_name(n) == "free":
            for a in n.args:
                seen_free_args.add(id(a))
    nodes.sort(key=lambda n: (n.lineno, n.col_offset))
    for n in nodes:
        if id(n) in seen_free_args:
            continue
        yield n


# ======================================================================
# rule: drain-callback
# ======================================================================
class _DrainCallbackRule(ast.NodeVisitor):
    def __init__(self, path: str, tree):
        self.path = path
        self.errors: list[LintError] = []
        self._defs = {}
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._defs.setdefault(node.name, []).append(node)

    def visit_Call(self, node):
        if _call_name(node) == "allreduce_nbi" and node.args:
            cb = node.args[-1]
            body = None
            if isinstance(cb, ast.Lambda):
                body = cb.body
            elif isinstance(cb, ast.Name) \
                    and len(self._defs.get(cb.id, [])) == 1:
                body = self._defs[cb.id][0]
            if body is not None:
                self._scan_callback(body, node.lineno)
        self.generic_visit(node)

    def _scan_callback(self, body, issue_line: int) -> None:
        for sub in ast.walk(body):
            if isinstance(sub, ast.Call):
                name = _call_name(sub)
                if name in DRAIN_CALLBACK_FORBIDDEN:
                    self.errors.append(LintError(
                        self.path, sub.lineno, "drain-callback",
                        f"'{name}' inside a drain callback (allreduce_nbi "
                        f"at line {issue_line}): completion handling must "
                        f"not block on another drain or barrier"))


# ======================================================================
# driver
# ======================================================================
def lint_source(src: str, path: str, relpath: Optional[str] = None
                ) -> list[LintError]:
    relpath = relpath if relpath is not None else path
    try:
        tree = ast.parse(src, filename=path)
    except SyntaxError as e:
        return [LintError(path, e.lineno or 0, "parse-error", str(e))]
    lines = src.splitlines()
    nbi = _NbiDrainRule(path, lines)
    nbi.visit(tree)
    haf = _HandleAfterFreeRule(path)
    haf.visit(tree)
    dcb = _DrainCallbackRule(path, tree)
    dcb.visit(tree)
    errors = (nbi.errors + _raw_collective_errors(tree, path, relpath)
              + haf.errors + dcb.errors)
    return sorted(errors, key=lambda e: (e.path, e.line, e.rule))


def lint_paths(paths) -> list[LintError]:
    """Lint every ``.py`` file under the given files/directories (the
    raw-collective rule reads each file's absolute path)."""
    errors: list[LintError] = []
    for root in paths:
        if os.path.isfile(root):
            files = [root]
        else:
            files = []
            for dirpath, _, names in os.walk(root):
                files.extend(os.path.join(dirpath, f)
                             for f in sorted(names) if f.endswith(".py"))
        for f in files:
            with open(f, encoding="utf-8") as fh:
                src = fh.read()
            errors.extend(lint_source(src, f, os.path.abspath(f)))
    return errors


def main(argv=None) -> int:
    """The CLI: lint ``argv``'s paths (default ``src/repro_torch``)."""
    import sys
    argv = sys.argv[1:] if argv is None else list(argv)
    paths = argv or [os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))]
    errors = lint_paths(paths)
    for e in errors:
        print(e)
    if errors:
        print(f"SHMEMLINT_FAIL findings={len(errors)}")
        return 1
    print("SHMEMLINT_PASS")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
