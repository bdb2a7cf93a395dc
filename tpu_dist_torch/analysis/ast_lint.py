"""shardcheck AST lint pass — process-group and capture misuse caught
before a process group comes up.

Counterpart of ``tpu_dist/analysis/ast_lint.py``. Walks Python source (no
import, no torch initialization) and flags the mistake classes that run
fine on one process and fail only across ranks or on the card:

* **SC101** — an axis name that no mesh declares, given to the port's
  axis lookups (``axis_group(mesh, ...)``, ``coordinate``,
  ``batch_sharded``, ``shard_batch``, ``neighbours``) or to any
  ``axis_name=`` keyword: not canonical (``tpu_dist_torch/parallel/
  axes.py``), not a ``*_AXIS`` constant in the file, not in an
  ``axis_shapes``/``make_mesh`` literal, not an axis parameter default.
* **SC102** — a ``Placement(mesh, spec)`` whose spec names more
  dimensions than the tensor it places (``.place(x)``) has, where the
  tensor's constructor shape is visible in the same scope.
* **SC103** — host side effects (``print``, ``time.*``, stdlib or numpy
  ``random``, ``input``/``breakpoint``, ``.item()``/``.tolist()``/
  ``.cpu()``/``.numpy()``, and ``tpu_dist_torch.observe`` recording)
  inside a function that a ``CapturedProgram`` or
  ``torch.cuda.make_graphed_callables`` captures, or lexically inside a
  ``with torch.cuda.graph(...)`` block: they run once, at capture, and
  never on replay.
* **SC104** — a ``CapturedProgram``'s result read after the same program
  was called again: the program hands out its static output buffers and
  every replay overwrites them.
* **SC105** — broad ``except Exception`` / bare ``except`` handlers around
  liveness-raising calls (``raise_if_failed``, ``barrier``, chief
  broadcasts, host reductions) that swallow ``PeerUnavailableError``
  without a dedicated handler or re-raise.

The pass is deliberately conservative: an axis name or tensor rank it
cannot resolve statically is skipped, never guessed. Findings carry rule
IDs from :mod:`tpu_dist_torch.analysis.rules`; inline suppressions
(``# shardcheck: disable=<rule> -- why``) are honored per line.
"""

from __future__ import annotations

import ast
import os
from typing import Iterable, Optional

from tpu_dist_torch.analysis.rules import Finding, apply_suppressions
from tpu_dist_torch.parallel.axes import CANONICAL_AXES

#: The port's axis lookups -> positional index of their axis argument
#: (``parallel/mesh.py``, ``parallel/p2p.py``).
_AXIS_CALL_POS = {
    "axis_group": 1,
    "coordinate": 1,
    "batch_sharded": 1,
    "shard_batch": 2,
    "neighbours": 1,
}

#: Call roots accepted for the axis-call table — bare names (from-import)
#: always match; dotted calls must come through one of these.
_AXIS_ROOTS = ("tpu_dist_torch", "mesh", "mesh_lib", "p2p", "parallel")

#: torch/numpy constructors whose arguments spell a shape.
_TENSOR_CTORS = frozenset({
    "zeros", "ones", "empty", "full", "rand", "randn", "randint",
})

_TIME_EFFECTS = {"time.time", "time.perf_counter", "time.monotonic",
                 "time.time_ns", "time.perf_counter_ns", "time.sleep"}

#: Tensor methods that read the device from the host: at capture they
#: synchronize a stream the capture records (an error on CUDA) and bake
#: the value read then into every replay.
_HOST_READS = frozenset({"item", "tolist", "cpu", "numpy"})

#: tpu_dist_torch.observe call tails SC103 does NOT flag inside captured
#: code: pure reads with no recording side effect.
_OBSERVE_CAPTURE_SAFE = {"enabled", "get_registry", "active_step_timer",
                         "quantile"}

#: Call tails whose failure semantics include PeerUnavailableError — the
#: liveness verdict surface (cluster/liveness.py) and the host-level
#: rendezvous points that a dead peer turns into raises/hangs.
_LIVENESS_RAISING = {"raise_if_failed", "check_peer_health", "barrier",
                     "broadcast_from_chief", "host_all_reduce_sum",
                     "host_all_gather"}

#: Exception names that make a handler "broad" for SC105.
_BROAD_EXCEPTIONS = {"Exception", "BaseException"}


def _collect_aliases(tree: ast.Module) -> dict:
    """Local name -> dotted origin, from import statements."""
    aliases: dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                aliases[a.asname or a.name.split(".")[0]] = (
                    a.name if a.asname else a.name.split(".")[0])
        elif isinstance(node, ast.ImportFrom) and node.module:
            for a in node.names:
                aliases[a.asname or a.name] = f"{node.module}.{a.name}"
    return aliases


def _dotted(node: ast.AST, aliases: dict) -> Optional[str]:
    """Resolve an expression to a dotted path through import aliases, or
    None for anything not a plain Name/Attribute chain."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(aliases.get(node.id, node.id))
    return ".".join(reversed(parts))


def _str_const(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


class _FileLint:
    """One file's lint state; produces findings via run()."""

    def __init__(self, path: str, tree: ast.Module):
        self.path = path
        self.tree = tree
        self.aliases = _collect_aliases(tree)
        self.findings: list[Finding] = []
        #: module-level `NAME = "str"` assignments (axis-name resolution).
        self.str_consts: dict[str, str] = {}
        self.declared_axes: set[str] = set(CANONICAL_AXES)

    # -- shared helpers -------------------------------------------------------

    def _flag(self, rule_id: str, node: ast.AST, message: str) -> None:
        self.findings.append(Finding(
            rule_id, self.path, getattr(node, "lineno", 1),
            getattr(node, "col_offset", 0), message))

    def _call_tail(self, call: ast.Call) -> Optional[str]:
        dotted = _dotted(call.func, self.aliases)
        return dotted.rsplit(".", 1)[-1] if dotted else None

    def _scopes(self) -> Iterable[ast.AST]:
        yield self.tree
        for node in ast.walk(self.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield node

    @staticmethod
    def _scope_walk(scope: ast.AST) -> Iterable[ast.AST]:
        """Walk one scope WITHOUT descending into nested functions — those
        are separate entries in _scopes(), and visiting them from the
        enclosing scope too would double-report their findings."""
        stack = list(ast.iter_child_nodes(scope))
        while stack:
            node = stack.pop()
            yield node
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                     ast.Lambda)):
                stack.extend(ast.iter_child_nodes(node))

    # -- declaration collection (SC101 context) -------------------------------

    def _collect_declarations(self) -> None:
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                t = node.targets[0]
                s = _str_const(node.value)
                if isinstance(t, ast.Name) and s is not None:
                    self.str_consts.setdefault(t.id, s)
                    if t.id.upper().endswith("AXIS"):
                        self.declared_axes.add(s)
            elif isinstance(node, ast.Call):
                for kw in node.keywords:
                    if kw.arg in ("axis_shapes", "axis_names"):
                        self._declare_from_literal(kw.value)
                if self._call_tail(node) == "make_mesh" and node.args:
                    self._declare_from_literal(node.args[0])
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                args = node.args
                for name, default in zip(
                        [a.arg for a in args.args[-len(args.defaults):]]
                        if args.defaults else [], args.defaults):
                    s = _str_const(default)
                    if s is not None and "axis" in name.lower():
                        self.declared_axes.add(s)
                for a, d in zip(args.kwonlyargs, args.kw_defaults):
                    s = _str_const(d) if d is not None else None
                    if s is not None and "axis" in a.arg.lower():
                        self.declared_axes.add(s)

    def _declare_from_literal(self, node: ast.AST) -> None:
        if isinstance(node, ast.Dict):
            for k in node.keys:
                s = _str_const(k) if k is not None else None
                if s is not None:
                    self.declared_axes.add(s)
        elif isinstance(node, (ast.Tuple, ast.List, ast.Set)):
            for e in node.elts:
                s = _str_const(e)
                if s is not None:
                    self.declared_axes.add(s)

    # -- SC101 ----------------------------------------------------------------

    def _axis_strings(self, node: ast.AST) -> list[str]:
        """String axis names an axis argument resolves to ([] if opaque)."""
        s = _str_const(node)
        if s is not None:
            return [s]
        if isinstance(node, (ast.Tuple, ast.List)):
            out = []
            for e in node.elts:
                out.extend(self._axis_strings(e))
            return out
        if isinstance(node, ast.Name) and node.id in self.str_consts:
            return [self.str_consts[node.id]]
        return []  # parameter, attribute, computed — not statically visible

    def _check_axes(self) -> None:
        for node in ast.walk(self.tree):
            if not isinstance(node, ast.Call):
                continue
            dotted = _dotted(node.func, self.aliases)
            axis_args = [kw.value for kw in node.keywords
                         if kw.arg == "axis_name"]
            tail = dotted.rsplit(".", 1)[-1] if dotted else None
            if dotted and tail in _AXIS_CALL_POS and not axis_args:
                root = dotted.rpartition(".")[0]
                if not root or any(part in _AXIS_ROOTS
                                   for part in root.split(".")):
                    pos = _AXIS_CALL_POS[tail]
                    named = [kw.value for kw in node.keywords
                             if kw.arg == "axis"]
                    if named:
                        axis_args = named
                    elif len(node.args) > pos:
                        axis_args = [node.args[pos]]
            for arg in axis_args:
                for name in self._axis_strings(arg):
                    if name not in self.declared_axes:
                        self._flag(
                            "SC101", node,
                            f"{tail or 'call'}() over axis {name!r}, which "
                            f"no mesh in scope declares (known axes: "
                            f"{sorted(self.declared_axes)}); a typo here "
                            "reduces over the wrong process group or "
                            "raises at run time")

    # -- SC102 ----------------------------------------------------------------

    def _spec_arity(self, node: ast.AST) -> Optional[int]:
        """Entry count of an inline ``Placement(mesh, (..))`` spec."""
        if not isinstance(node, ast.Call) or self._call_tail(node) != \
                "Placement":
            return None
        spec = node.args[1] if len(node.args) >= 2 else next(
            (k.value for k in node.keywords if k.arg == "spec"), None)
        if isinstance(spec, (ast.Tuple, ast.List)):
            return len(spec.elts)
        return None

    def _ctor_rank(self, call: ast.Call) -> Optional[int]:
        tail = self._call_tail(call)
        if tail in ("arange", "linspace"):
            return 1
        if tail not in _TENSOR_CTORS:
            return None
        shape = next((k.value for k in call.keywords
                      if k.arg in ("size", "shape")), None)
        if shape is None and tail in ("randint",):
            # randint(low, high, size) / randint(high, size)
            shape = next((a for a in call.args
                          if isinstance(a, (ast.Tuple, ast.List))), None)
        if shape is None and tail == "full" and call.args:
            shape = call.args[0]
        if shape is None and call.args:
            first = call.args[0]
            if isinstance(first, (ast.Tuple, ast.List)):
                shape = first
            elif all(isinstance(a, ast.Constant)
                     and isinstance(a.value, int) for a in call.args):
                return len(call.args)  # torch.zeros(4, 8)
        if isinstance(shape, (ast.Tuple, ast.List)):
            return len(shape.elts)
        if isinstance(shape, ast.Constant) and isinstance(shape.value, int):
            return 1
        return None

    def _check_spec_ranks(self) -> None:
        for scope in self._scopes():
            ranks: dict[str, int] = {}
            specs: dict[str, int] = {}
            for node in self._scope_walk(scope):
                if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                        and isinstance(node.targets[0], ast.Name) \
                        and isinstance(node.value, ast.Call):
                    rank = self._ctor_rank(node.value)
                    if rank is not None:
                        ranks[node.targets[0].id] = rank
                    arity = self._spec_arity(node.value)
                    if arity is not None:
                        specs[node.targets[0].id] = arity
            for node in self._scope_walk(scope):
                if not isinstance(node, ast.Call) or not isinstance(
                        node.func, ast.Attribute) or \
                        node.func.attr != "place" or not node.args:
                    continue
                recv = node.func.value
                arity = (specs.get(recv.id) if isinstance(recv, ast.Name)
                         else self._spec_arity(recv))
                if arity is None:
                    continue
                target = node.args[0]
                rank = None
                if isinstance(target, ast.Name):
                    rank = ranks.get(target.id)
                elif isinstance(target, ast.Call):
                    rank = self._ctor_rank(target)
                if rank is not None and arity > rank:
                    self._flag(
                        "SC102", node,
                        f"placement spec with {arity} entries placed on a "
                        f"rank-{rank} tensor; a spec may not name more "
                        "dimensions than the tensor has")

    # -- SC103 ----------------------------------------------------------------

    def _captured_functions(self) -> list[tuple]:
        """``(node, how)`` for every captured body: functions handed to
        ``CapturedProgram``/``make_graphed_callables`` (by name or as a
        lambda) and the bodies of ``with torch.cuda.graph(...)``."""
        by_name: dict[str, ast.AST] = {}
        for node in ast.walk(self.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                by_name.setdefault(node.name, node)
        out: list[tuple] = []
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Call) and self._call_tail(node) in (
                    "CapturedProgram", "make_graphed_callables"):
                fn = node.args[0] if node.args else next(
                    (k.value for k in node.keywords if k.arg == "fn"), None)
                if isinstance(fn, ast.Name) and fn.id in by_name:
                    out.append((by_name[fn.id], by_name[fn.id].name))
                elif isinstance(fn, ast.Lambda):
                    out.append((fn, "<lambda>"))
            elif isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    e = item.context_expr
                    if isinstance(e, ast.Call) and (
                            _dotted(e.func, self.aliases) or "").endswith(
                            "cuda.graph"):
                        out.append((ast.Module(body=node.body,
                                               type_ignores=[]),
                                    "torch.cuda.graph block"))
        return out

    def _effect(self, call: ast.Call) -> Optional[str]:
        dotted = _dotted(call.func, self.aliases)
        if isinstance(call.func, ast.Attribute) and \
                call.func.attr in _HOST_READS and not call.args:
            return (f".{call.func.attr}() (a host read of the device: it "
                    "runs once, at capture)")
        if dotted is None:
            return None
        parts = dotted.split(".")
        if dotted in ("print", "input", "breakpoint"):
            return f"{dotted}()"
        if dotted in _TIME_EFFECTS:
            return f"{dotted}() (frozen at capture)"
        if parts[0] == "random" or (parts[0] in ("numpy", "np")
                                    and "random" in parts):
            return (f"{dotted}() (host randomness is baked into the graph "
                    "at capture; draw from a torch generator)")
        if dotted.startswith("tpu_dist_torch.observe") \
                and parts[-1] not in _OBSERVE_CAPTURE_SAFE:
            return (f"{dotted}() (metric recording is a host side effect; "
                    "record from a callback or the eager fit loop)")
        return None

    def _check_capture_side_effects(self) -> None:
        seen: set[int] = set()
        for fn, label in self._captured_functions():
            if id(fn) in seen:
                continue
            seen.add(id(fn))
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                effect = self._effect(node)
                if effect is not None:
                    self._flag(
                        "SC103", node,
                        f"host side effect {effect} inside captured "
                        f"{label!r}: runs once at capture, never on "
                        "replay")

    # -- SC104 ----------------------------------------------------------------

    def _check_captured_output_reuse(self) -> None:
        programs: set[str] = set()
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.value, ast.Call) \
                    and self._call_tail(node.value) == "CapturedProgram":
                t = node.targets[0]
                if isinstance(t, ast.Name):
                    programs.add(t.id)
                elif isinstance(t, ast.Attribute):
                    programs.add(ast.unparse(t))
        if not programs:
            return
        for scope in self._scopes():
            self._scan_replays(getattr(scope, "body", []), programs)

    def _scan_replays(self, body, programs: set) -> None:
        """Linear scan of a statement list: a name bound to a program's
        result goes stale at that program's next call, until rebound."""
        bound: dict[str, tuple] = {}  # result name -> (program, line)
        stale: dict[str, tuple] = {}  # result name -> (program, line)

        def program_calls(stmt):
            for node in ast.walk(stmt):
                if isinstance(node, ast.Call):
                    name = ast.unparse(node.func)
                    if name in programs:
                        yield name

        for stmt in body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue
            loads = {n.id for n in ast.walk(stmt)
                     if isinstance(n, ast.Name)
                     and isinstance(n.ctx, ast.Load)}
            for name in sorted(loads & set(stale)):
                prog, line = stale.pop(name)
                self._flag(
                    "SC104", stmt,
                    f"{name!r} holds {prog}'s static output, which the "
                    f"call on line {line} overwrote in place; clone the "
                    "result before calling the program again")
            called = list(program_calls(stmt))
            for prog in called:
                for name, (p, _line) in list(bound.items()):
                    if p == prog:
                        stale[name] = (prog, stmt.lineno)
                        del bound[name]
            stores = {n.id for n in ast.walk(stmt)
                      if isinstance(n, ast.Name)
                      and isinstance(n.ctx, ast.Store)}
            for name in stores:
                stale.pop(name, None)
                bound.pop(name, None)
            if called and isinstance(stmt, ast.Assign) \
                    and isinstance(stmt.value, ast.Call) \
                    and ast.unparse(stmt.value.func) in programs:
                for t in stmt.targets:
                    for n in ast.walk(t):
                        if isinstance(n, ast.Name):
                            bound[n.id] = (ast.unparse(stmt.value.func),
                                           stmt.lineno)

    # -- SC105 ----------------------------------------------------------------

    def _handler_names(self, handler: ast.ExceptHandler) -> set:
        t = handler.type
        if t is None:
            return set()
        nodes = t.elts if isinstance(t, ast.Tuple) else (t,)
        names = set()
        for node in nodes:
            dotted = _dotted(node, self.aliases)
            if dotted:
                names.add(dotted.rsplit(".", 1)[-1])
        return names

    def _check_swallowed_liveness(self) -> None:
        for node in ast.walk(self.tree):
            if not isinstance(node, ast.Try):
                continue
            raising = [
                self._call_tail(c)
                for stmt in node.body for c in ast.walk(stmt)
                if isinstance(c, ast.Call)
                and self._call_tail(c) in _LIVENESS_RAISING]
            if not raising:
                continue
            liveness_handled = False
            for handler in node.handlers:
                names = self._handler_names(handler)
                if "PeerUnavailableError" in names:
                    liveness_handled = True
                    continue
                broad = handler.type is None or (names & _BROAD_EXCEPTIONS)
                if not broad or liveness_handled:
                    continue
                if any(isinstance(n, ast.Raise)
                       for s in handler.body for n in ast.walk(s)):
                    continue  # re-raises: the signal still propagates
                caught = ("bare except" if handler.type is None
                          else f"except {sorted(names)[0]}")
                self._flag(
                    "SC105", handler,
                    f"{caught} around {sorted(set(raising))[0]}() swallows "
                    "PeerUnavailableError; a dead-peer verdict must "
                    "propagate so supervision can restart the worker — "
                    "catch PeerUnavailableError separately first, or "
                    "re-raise")

    # -- driver ---------------------------------------------------------------

    def run(self) -> list[Finding]:
        self._collect_declarations()
        self._check_axes()
        self._check_spec_ranks()
        self._check_capture_side_effects()
        self._check_captured_output_reuse()
        self._check_swallowed_liveness()
        return self.findings


def iter_python_files(paths: Iterable[str]) -> list[str]:
    """Expand files/directories into a sorted list of .py files."""
    out = []
    for p in paths:
        if os.path.isdir(p):
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames[:] = [d for d in dirnames
                               if not d.startswith(".")
                               and d not in ("__pycache__", "_build")]
                for f in sorted(filenames):
                    if f.endswith(".py"):
                        out.append(os.path.join(dirpath, f))
        elif p.endswith(".py"):
            out.append(p)
    return sorted(dict.fromkeys(out))


def lint_file_raw(path: str):
    """``(pre-suppression findings, source lines)`` for one file. Syntax
    errors come back as an SC900 info finding rather than crashing the
    whole run."""
    with open(path, "r", encoding="utf-8") as fh:
        source = fh.read()
    lines = source.splitlines()
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return [Finding("SC900", path, e.lineno or 1, e.offset or 0,
                        f"file does not parse: {e.msg}")], lines
    return _FileLint(path, tree).run(), lines


def lint_file(path: str) -> list[Finding]:
    """Lint one file; honors inline suppressions."""
    findings, lines = lint_file_raw(path)
    return apply_suppressions(findings, {path: lines})


def lint_paths_raw(paths: Iterable[str]):
    """``(pre-suppression findings, {path: source lines})`` over every
    .py file under ``paths``."""
    findings: list[Finding] = []
    source_by_path: dict[str, list] = {}
    for path in iter_python_files(paths):
        file_findings, lines = lint_file_raw(path)
        findings.extend(file_findings)
        source_by_path[path] = lines
    return findings, source_by_path


def lint_paths(paths: Iterable[str]) -> list[Finding]:
    findings, source_by_path = lint_paths_raw(paths)
    return apply_suppressions(findings, source_by_path)
