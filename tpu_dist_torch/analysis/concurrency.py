"""Host-runtime thread-safety analyzer — the SC4xx family.

Counterpart of ``tpu_dist/analysis/concurrency.py``, with PyTorch's
rendezvous and dispatch vocabulary: ``torch.distributed`` collectives and
point-to-point calls and the port's wrappers around them
(``parallel/collectives.py``, ``parallel/p2p.py``, ``tensor.py``,
``expert.py``) rendezvous; a hand-written kernel's launch (every wrapper
counts it through ``utils/graphs.count_launch``), ``CapturedProgram``/
``CUDAGraph`` replays and ``torch.cuda.synchronize`` dispatch.

The recorded program (SC1xx/SC2xx) is only half the distributed runtime;
the other half is plain Python threads: the async-checkpoint writer, the
device prefetcher, the decode-stall watchdog, liveness probers, signal
handlers. Their safety rules lived in review prose ("never join a
collective on the writer thread", "publish results via join, not shared
attributes"); this pass machine-checks them.

It is an interprocedural AST analysis, no imports and no backend:

1. **Call graph** — every ``def``/``async def``/method (and any lambda
   spawned as a thread target) in the analyzed paths becomes a node;
   edges are resolved conservatively: bare names through the lexical
   nesting chain and module scope, ``self.method`` within the class,
   ``obj.method`` when ``obj`` is a local or attribute whose
   construction from a project class was seen, dotted paths through
   import aliases into other analyzed modules. Unresolvable calls are
   simply absent (the graph under-approximates; rules stay quiet rather
   than guess).
2. **Thread-entry map** — targets of ``threading.Thread(target=...)``,
   ``threading.Timer(interval, fn)``, ``signal.signal(sig, handler)``
   and the ``run()`` method of ``threading.Thread`` subclasses. Targets
   are resolved through the same machinery plus the spawn-specific
   idioms: ``functools.partial(fn, ...)``, ``lambda: fn(...)`` wrappers,
   nested closures, and ``self.attr`` where the attribute was assigned a
   function (including ``self.cb = cb or _default`` fallbacks). A target
   the resolver cannot pin down is **reported** (SC900 info), never
   silently dropped — an unanalyzed thread entry is a hole in every
   SC4xx guarantee.
3. **Closures** — reachability from thread entries, and per-function
   transitive "reaches a rendezvous/collective" and "reaches os._exit"
   bits.

Rules (see rules.py for the catalogue text): SC401 unlocked shared
attribute (write/write race between thread and non-thread code, lockset
approximation over ``with <lock>:`` scopes), SC402 blocking call while
holding a lock (``Condition.wait`` inside ``with cond:`` is exempt —
wait releases that lock), SC403 collective/dispatch reachable from a
thread entry, SC404 ``os._exit`` while a lock is held (directly or
through a callee). The lockset model is lexical and intraprocedural
(locks named ``*lock*``/``*mutex*``/``*cond*``/``*cv*`` or attributes
assigned ``threading.Lock/RLock/Condition``); SC402/SC404 look one call
level deep through the "reaches os._exit" bit, SC401/SC403 are fully
transitive through the call graph. Module-level statements outside any
``def`` are not scanned (the runtime spawns threads from functions).

``liveness.py`` builds its SC5xx rules on the same :class:`Project`.
"""

from __future__ import annotations

import ast
import dataclasses
import os
import re
from typing import Iterable, Optional

from tpu_dist_torch.analysis.ast_lint import (
    _collect_aliases,
    _dotted,
    iter_python_files,
)
from tpu_dist_torch.analysis.rules import Finding

#: Host-level barrier/rendezvous/collective call tails (the port's
#: ``cluster/bootstrap.py`` and ``parallel/collectives.py``). These block
#: until every rank shows up, so they are both "blocking" for SC402 and
#: "collective" for SC403/SC501.
RENDEZVOUS_TAILS = frozenset({
    "barrier", "epoch_rendezvous", "generation_rendezvous",
    "host_all_reduce_sum", "host_all_gather", "broadcast_from_chief",
    "bucketed_all_reduce",
})

#: ``torch.distributed`` collectives and point-to-point calls; matched only
#: when the dotted path runs through ``torch.distributed`` (``dist.``), so
#: a project helper sharing a name does not false-match.
_TORCH_COLLECTIVE_TAILS = frozenset({
    "all_reduce", "all_gather", "all_gather_into_tensor",
    "all_gather_object", "reduce_scatter", "reduce_scatter_tensor",
    "all_to_all", "all_to_all_single", "broadcast", "broadcast_object_list",
    "reduce", "gather", "scatter", "send", "recv", "isend", "irecv",
    "batch_isend_irecv", "monitored_barrier",
})

#: CUDA dispatch — SC403 only (a dispatch does not rendezvous by itself,
#: but issuing it off the main thread races the stream's other work):
#: every hand-written kernel's wrapper counts its launch through
#: ``count_launch``; a captured program launches on an argument-free
#: ``.replay()``; ``torch.cuda.synchronize`` waits on every stream.


def _is_torch_collective(tail, dotted) -> bool:
    if tail not in _TORCH_COLLECTIVE_TAILS or not dotted:
        return False
    parts = dotted.split(".")
    return "distributed" in parts or parts[0] == "dist"


#: Constructor tails whose instances are synchronization primitives or
#: thread handles: attributes holding these are coordination machinery,
#: not shared mutable *data*, so SC401 skips them.
_SYNC_CTOR_TAILS = frozenset({
    "Lock", "RLock", "Condition", "Event", "Semaphore",
    "BoundedSemaphore", "Barrier", "Queue", "SimpleQueue", "LifoQueue",
    "PriorityQueue", "deque", "Thread", "Timer", "local",
})

_LOCK_CTOR_TAILS = frozenset({"Lock", "RLock", "Condition"})

#: Name-based lock recognition for `with <expr>:` — final identifier
#: segment looks like a lock/condition.
_LOCK_NAME_RE = re.compile(r"(?:^|_)(lock|locks|mutex|cond|cv)$", re.I)

_INIT_METHODS = frozenset({"__init__", "__new__", "__post_init__"})


def _tail(node: ast.AST) -> Optional[str]:
    """Final identifier of a Name/Attribute chain (``a.b.c`` -> ``c``)."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def _unparse(node: ast.AST) -> str:
    try:
        return ast.unparse(node)
    except Exception:  # pragma: no cover - unparse is total on 3.9+
        return "<expr>"


def _has_timeout_kw(call: ast.Call) -> bool:
    return any(k.arg and "timeout" in k.arg for k in call.keywords)


def module_name_for(path: str) -> str:
    """Dotted module name, walking up while __init__.py exists — so
    ``.../tpu_dist_torch/cluster/bootstrap.py`` ->
    ``tpu_dist_torch.cluster.bootstrap``
    and a loose fixture file is just its basename."""
    p = os.path.abspath(path)
    base = os.path.splitext(os.path.basename(p))[0]
    parts = [] if base == "__init__" else [base]
    d = os.path.dirname(p)
    while os.path.isfile(os.path.join(d, "__init__.py")):
        parts.insert(0, os.path.basename(d))
        d = os.path.dirname(d)
    return ".".join(parts) or base


@dataclasses.dataclass
class ClassInfo:
    name: str
    module: str
    base_dots: list = dataclasses.field(default_factory=list)
    methods: dict = dataclasses.field(default_factory=dict)  # name -> key
    #: attrs assigned a sync-primitive constructor (any method).
    sync_attrs: set = dataclasses.field(default_factory=set)
    #: attrs assigned a Lock/RLock/Condition constructor.
    lock_attrs: set = dataclasses.field(default_factory=set)
    #: attrs assigned a project-class instance: attr -> (module, class).
    attr_types: dict = dataclasses.field(default_factory=dict)
    #: attrs assigned function-valued expressions: attr -> [value exprs].
    attr_value_exprs: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class FunctionInfo:
    key: str
    qualname: str
    name: str
    path: str
    module: str
    node: ast.AST
    class_name: Optional[str] = None
    parent: Optional[str] = None
    inner: dict = dataclasses.field(default_factory=dict)
    callees: dict = dataclasses.field(default_factory=dict)  # key -> line
    #: (callee key, line, col, locks held, Call node) per resolved call.
    call_sites: list = dataclasses.field(default_factory=list)
    rendezvous_sites: list = dataclasses.field(default_factory=list)
    dispatch_sites: list = dataclasses.field(default_factory=list)
    #: (line, col, lock tokens held at the call).
    exit_sites: list = dataclasses.field(default_factory=list)
    #: (attr, line, col, lockset) — self.<attr> stores, methods only.
    attr_writes: list = dataclasses.field(default_factory=list)
    #: raw SC402 findings (line, col, message).
    blocking_under_lock: list = dataclasses.field(default_factory=list)
    #: (kind, line, target expr, var_types snapshot) — resolved in pass 3.
    spawns: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class ModuleInfo:
    path: str
    modname: str
    tree: ast.Module
    aliases: dict
    source_lines: list
    top_level: dict = dataclasses.field(default_factory=dict)
    classes: dict = dataclasses.field(default_factory=dict)
    lock_globals: set = dataclasses.field(default_factory=set)


class Project:
    """All analyzed modules plus the derived graphs and closures."""

    def __init__(self) -> None:
        self.modules: dict[str, ModuleInfo] = {}
        self.by_path: dict[str, ModuleInfo] = {}
        self.functions: dict[str, FunctionInfo] = {}
        #: entry key -> human description of the spawn site.
        self.entries: dict[str, str] = {}
        #: (path, line, kind, expr text) for targets nobody could resolve.
        self.unresolved_spawns: list = []
        #: (path, line, message) for files ast.parse rejected.
        self.syntax_errors: list = []
        self.thread_reachable: set = set()
        #: reached key -> entry key it was first discovered from.
        self.entry_origin: dict = {}
        self.reaches_exit: set = set()
        self.reaches_rendezvous: set = set()

    # -- resolution ---------------------------------------------------

    def lookup_dotted(self, dotted: str) -> Optional[str]:
        """``pkg.mod.fn`` -> function key when pkg.mod is analyzed."""
        if "." not in dotted:
            return None
        modpart, leaf = dotted.rsplit(".", 1)
        mod = self.modules.get(modpart)
        if mod is not None:
            return mod.top_level.get(leaf)
        return None

    def lookup_class(self, dotted: str) -> Optional[ClassInfo]:
        if "." in dotted:
            modpart, leaf = dotted.rsplit(".", 1)
            mod = self.modules.get(modpart)
            if mod is not None:
                return mod.classes.get(leaf)
        return None

    def class_method(self, cls: ClassInfo, name: str,
                     _depth: int = 0) -> Optional[str]:
        """Method key, following one level of project-class bases."""
        if name in cls.methods:
            return cls.methods[name]
        if _depth >= 2:
            return None
        for base in cls.base_dots:
            parent = self.lookup_class(base)
            if parent is None and "." not in base:
                mod = self.modules.get(cls.module)
                parent = mod.classes.get(base) if mod else None
            if parent is not None:
                found = self.class_method(parent, name, _depth + 1)
                if found:
                    return found
        return None

    def lookup_name(self, name: str, fn: FunctionInfo) -> Optional[str]:
        """Bare-name resolution through the lexical chain, module scope,
        then import aliases into other analyzed modules."""
        cur: Optional[FunctionInfo] = fn
        while cur is not None:
            if name in cur.inner:
                return cur.inner[name]
            cur = self.functions.get(cur.parent) if cur.parent else None
        mod = self.modules.get(fn.module)
        if mod is None:
            return None
        if name in mod.top_level:
            return mod.top_level[name]
        dotted = mod.aliases.get(name)
        if dotted and dotted != name:
            return self.lookup_dotted(dotted)
        return None

    def resolve_call(self, func: ast.AST, fn: FunctionInfo,
                     var_types: dict) -> Optional[str]:
        mod = self.modules.get(fn.module)
        aliases = mod.aliases if mod else {}
        if isinstance(func, ast.Name):
            return self.lookup_name(func.id, fn)
        if isinstance(func, ast.Attribute):
            base = func.value
            # self.method() / cls.method()
            if (isinstance(base, ast.Name) and base.id in ("self", "cls")
                    and fn.class_name and mod):
                cls = mod.classes.get(fn.class_name)
                if cls is not None:
                    m = self.class_method(cls, func.attr)
                    if m:
                        return m
                return None
            # self.attr.method() where attr's class was seen at assignment
            if (isinstance(base, ast.Attribute)
                    and isinstance(base.value, ast.Name)
                    and base.value.id in ("self", "cls")
                    and fn.class_name and mod):
                cls = mod.classes.get(fn.class_name)
                typed = cls.attr_types.get(base.attr) if cls else None
                if typed:
                    tmod, tcls = typed
                    target = self.modules.get(tmod, mod).classes.get(tcls)
                    if target is not None:
                        return self.class_method(target, func.attr)
                return None
            # local.method() where local = ProjectClass(...)
            if isinstance(base, ast.Name) and base.id in var_types:
                tmod, tcls = var_types[base.id]
                target_mod = self.modules.get(tmod)
                cls = target_mod.classes.get(tcls) if target_mod else None
                if cls is not None:
                    return self.class_method(cls, func.attr)
                return None
            dotted = _dotted(func, aliases)
            if dotted:
                return self.lookup_dotted(dotted)
        return None


# ----------------------------------------------------------------------
# pass 1: registration


def _register_module(project: Project, path: str) -> Optional[ModuleInfo]:
    try:
        with open(path, "r", encoding="utf-8") as fh:
            source = fh.read()
        tree = ast.parse(source, filename=path)
    except OSError:
        return None
    except SyntaxError as exc:
        # surfaced as SC900 by check_project: in --concurrency mode
        # ast_lint does not run, so this is the only report the file gets
        project.syntax_errors.append((path, exc.lineno or 1,
                                      exc.msg or "syntax error"))
        return None
    mod = ModuleInfo(
        path=path, modname=module_name_for(path), tree=tree,
        aliases=_collect_aliases(tree), source_lines=source.splitlines())
    project.modules[mod.modname] = mod
    project.by_path[path] = mod
    for stmt in tree.body:  # module-level lock globals (_STATE_LOCK = ...)
        if isinstance(stmt, ast.Assign) and isinstance(stmt.value, ast.Call):
            if _tail(stmt.value.func) in _LOCK_CTOR_TAILS:
                for t in stmt.targets:
                    if isinstance(t, ast.Name):
                        mod.lock_globals.add(t.id)
    _register_body(project, mod, tree.body, parent=None, class_name=None,
                   prefix=mod.modname + ".")
    return mod


def _register_body(project: Project, mod: ModuleInfo, body,
                   parent: Optional[str], class_name: Optional[str],
                   prefix: str) -> None:
    for node in body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            _register_function(project, mod, node, parent=parent,
                               class_name=class_name, prefix=prefix)
        elif isinstance(node, ast.ClassDef) and parent is None:
            cls = ClassInfo(name=node.name, module=mod.modname)
            for b in node.bases:
                dotted = _dotted(b, mod.aliases)
                if dotted:
                    cls.base_dots.append(dotted)
            mod.classes[node.name] = cls
            _register_body(project, mod, node.body, parent=None,
                           class_name=node.name,
                           prefix=f"{prefix}{node.name}.")
        elif isinstance(node, (ast.If, ast.Try, ast.With)):
            # defs behind TYPE_CHECKING / try-import guards still count
            inner = list(getattr(node, "body", []))
            inner += list(getattr(node, "orelse", []))
            inner += list(getattr(node, "finalbody", []))
            for h in getattr(node, "handlers", []):
                inner += h.body
            _register_body(project, mod, inner, parent=parent,
                           class_name=class_name, prefix=prefix)


def _register_function(project: Project, mod: ModuleInfo, node,
                       parent: Optional[str], class_name: Optional[str],
                       prefix: str) -> FunctionInfo:
    key = f"{mod.path}:{node.lineno}:{node.name}"
    info = FunctionInfo(
        key=key, qualname=f"{prefix}{node.name}", name=node.name,
        path=mod.path, module=mod.modname, node=node,
        class_name=class_name, parent=parent)
    project.functions[key] = info
    if parent is not None:
        project.functions[parent].inner[node.name] = key
    elif class_name is None:
        mod.top_level.setdefault(node.name, key)
    if class_name is not None and parent is None:
        mod.classes[class_name].methods[node.name] = key
    _register_body(project, mod, node.body, parent=key,
                   class_name=class_name, prefix=info.qualname + ".")
    return info


# ----------------------------------------------------------------------
# pass 2: per-function body scan


def _iter_calls(node: ast.AST):
    """Every Call in an expression/statement subtree, pruning nested
    function/class definitions and lambdas (they are their own nodes)."""
    stack = [node]
    while stack:
        n = stack.pop()
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.ClassDef, ast.Lambda)):
            continue
        if isinstance(n, ast.Call):
            yield n
        stack.extend(ast.iter_child_nodes(n))


def _flat_targets(targets):
    for t in targets:
        if isinstance(t, (ast.Tuple, ast.List)):
            yield from _flat_targets(t.elts)
        elif isinstance(t, ast.Starred):
            yield from _flat_targets([t.value])
        else:
            yield t


class _BodyScan:
    """One function's statement walk: lock stack, local instance types,
    call/spawn/write collection, and the lexical SC402 check."""

    def __init__(self, project: Project, fn: FunctionInfo):
        self.project = project
        self.fn = fn
        self.mod = project.modules[fn.module]
        self.cls = (self.mod.classes.get(fn.class_name)
                    if fn.class_name else None)
        self.locks: list = []  # unparse tokens of held lock exprs
        self.var_types: dict = {}

    def run(self) -> None:
        node = self.fn.node
        if isinstance(node, ast.Lambda):
            self._expr(node.body)
        else:
            self._stmts(node.body)

    # -- helpers ------------------------------------------------------

    def _is_lock_expr(self, expr: ast.AST) -> bool:
        if isinstance(expr, ast.Call):
            return False  # `with open(...)`, `with span(...)`: not locks
        tail = _tail(expr)
        if tail is None:
            return False
        if _LOCK_NAME_RE.search(tail):
            return True
        if (isinstance(expr, ast.Attribute)
                and isinstance(expr.value, ast.Name)
                and expr.value.id in ("self", "cls") and self.cls
                and expr.attr in self.cls.lock_attrs):
            return True
        if isinstance(expr, ast.Name) and expr.id in self.mod.lock_globals:
            return True
        return False

    def _lockset(self):
        return frozenset(self.locks)

    # -- statements ---------------------------------------------------

    def _stmts(self, body) -> None:
        for stmt in body:
            self._stmt(stmt)

    def _stmt(self, stmt: ast.stmt) -> None:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return  # separately registered/scanned
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            pushed = 0
            for item in stmt.items:
                self._expr(item.context_expr)
                if self._is_lock_expr(item.context_expr):
                    self.locks.append(_unparse(item.context_expr))
                    pushed += 1
            self._stmts(stmt.body)
            for _ in range(pushed):
                self.locks.pop()
            return
        if isinstance(stmt, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            self._assign(stmt)
            return
        if isinstance(stmt, (ast.If, ast.While)):
            self._expr(stmt.test)
            self._stmts(stmt.body)
            self._stmts(stmt.orelse)
            return
        if isinstance(stmt, (ast.For, ast.AsyncFor)):
            self._expr(stmt.iter)
            self._stmts(stmt.body)
            self._stmts(stmt.orelse)
            return
        if isinstance(stmt, ast.Try):
            self._stmts(stmt.body)
            for h in stmt.handlers:
                self._stmts(h.body)
            self._stmts(stmt.orelse)
            self._stmts(stmt.finalbody)
            return
        # Return/Raise/Expr/Assert/Delete/...: scan contained expressions
        for child in ast.iter_child_nodes(stmt):
            if isinstance(child, ast.expr):
                self._expr(child)

    def _assign(self, stmt) -> None:
        value = getattr(stmt, "value", None)
        if value is not None:
            self._expr(value)
        targets = (stmt.targets if isinstance(stmt, ast.Assign)
                   else [stmt.target])
        for t in _flat_targets(targets):
            if (isinstance(t, ast.Attribute)
                    and isinstance(t.value, ast.Name)
                    and t.value.id in ("self", "cls")):
                self._self_attr_write(t.attr, t, value)
            elif isinstance(t, ast.Name) and isinstance(value, ast.Call):
                typed = self._class_of_ctor(value)
                if typed:
                    self.var_types[t.id] = typed

    def _class_of_ctor(self, call: ast.Call):
        """(module, class) when the call constructs an analyzed class."""
        func = call.func
        if isinstance(func, ast.Name):
            dotted = self.mod.aliases.get(func.id, func.id)
            cls = self.project.lookup_class(dotted)
            if cls is None:
                cls = self.mod.classes.get(func.id)
            if cls is not None:
                return (cls.module, cls.name)
            return None
        dotted = _dotted(func, self.mod.aliases)
        if dotted:
            cls = self.project.lookup_class(dotted)
            if cls is not None:
                return (cls.module, cls.name)
        return None

    def _self_attr_write(self, attr: str, target, value) -> None:
        if self.cls is None:
            return
        if isinstance(value, ast.Call):
            ctor = _tail(value.func)
            if ctor in _SYNC_CTOR_TAILS:
                self.cls.sync_attrs.add(attr)
                if ctor in _LOCK_CTOR_TAILS:
                    self.cls.lock_attrs.add(attr)
            typed = self._class_of_ctor(value)
            if typed:
                self.cls.attr_types[attr] = typed
        if value is not None and isinstance(
                value, (ast.Name, ast.Attribute, ast.BoolOp, ast.Lambda)):
            self.cls.attr_value_exprs.setdefault(attr, []).append(
                (value, self.fn.key, dict(self.var_types)))
        self.fn.attr_writes.append(
            (attr, target.lineno, target.col_offset, self._lockset()))

    # -- expressions --------------------------------------------------

    def _expr(self, node: ast.AST) -> None:
        for call in _iter_calls(node):
            self._call(call)

    def _call(self, call: ast.Call) -> None:
        func = call.func
        tail = _tail(func)
        dotted = _dotted(func, self.mod.aliases)

        # thread/timer/signal spawns: target resolution deferred to pass 3
        if tail == "Thread":
            target = next((k.value for k in call.keywords
                           if k.arg == "target"), None)
            self.fn.spawns.append(
                ("threading.Thread", call.lineno,
                 target if target is not None else call,
                 dict(self.var_types)))
        elif tail == "Timer":
            target = (call.args[1] if len(call.args) >= 2 else
                      next((k.value for k in call.keywords
                            if k.arg == "function"), None))
            self.fn.spawns.append(
                ("threading.Timer", call.lineno,
                 target if target is not None else call,
                 dict(self.var_types)))
        elif dotted == "signal.signal" and len(call.args) >= 2:
            handler = call.args[1]
            if not (isinstance(handler, ast.Attribute)
                    and handler.attr in ("SIG_IGN", "SIG_DFL")):
                self.fn.spawns.append(
                    ("signal handler", call.lineno, handler,
                     dict(self.var_types)))

        resolved = self.project.resolve_call(func, self.fn, self.var_types)
        if resolved:
            self.fn.callees.setdefault(resolved, call.lineno)
            self.fn.call_sites.append(
                (resolved, call.lineno, call.col_offset, self._lockset(),
                 call))

        if tail in RENDEZVOUS_TAILS or _is_torch_collective(tail, dotted):
            self.fn.rendezvous_sites.append(
                (tail, call.lineno, call.col_offset))
        elif (tail == "count_launch" or (
                tail == "replay" and isinstance(func, ast.Attribute)
                and not call.args and not call.keywords) or (
                tail == "synchronize" and dotted
                and "cuda" in dotted.split("."))):
            self.fn.dispatch_sites.append(
                (tail, call.lineno, call.col_offset))

        if tail == "_exit" or dotted == "os.abort":
            self.fn.exit_sites.append(
                (call.lineno, call.col_offset, self._lockset()))

        if self.locks:
            self._check_blocking_under_lock(call, tail)

    def _check_blocking_under_lock(self, call: ast.Call, tail) -> None:
        """SC402: direct blocking call lexically inside `with <lock>:`."""
        recv = (call.func.value if isinstance(call.func, ast.Attribute)
                else None)
        what = None
        if tail == "join" and not call.args and not _has_timeout_kw(call):
            if not (isinstance(recv, ast.Constant)):  # "sep".join has args
                what = ".join()"
        elif tail == "get" and not call.args and not _has_timeout_kw(call):
            what = ".get() with no timeout"
        elif tail == "wait" and not call.args and not _has_timeout_kw(call):
            # Condition.wait inside `with cond:` releases that lock.
            if recv is None or _unparse(recv) not in self.locks:
                what = ".wait() with no timeout"
        elif tail in RENDEZVOUS_TAILS or _is_torch_collective(
                tail, _dotted(call.func, self.mod.aliases)):
            what = f"{tail}() rendezvous"
        if what is not None:
            self.fn.blocking_under_lock.append((
                call.lineno, call.col_offset,
                f"blocking {what} while holding "
                f"{' and '.join(sorted(self.locks))}; any thread needing "
                f"that lock to make progress deadlocks here"))


# ----------------------------------------------------------------------
# pass 3: spawn-target resolution + entries


def _resolve_target(project: Project, fn: FunctionInfo, expr: ast.AST,
                    var_types: dict, _depth: int = 0) -> list:
    """Function keys a spawn target can invoke; [] means unresolved."""
    if _depth > 4 or expr is None:
        return []
    mod = project.modules[fn.module]
    if isinstance(expr, ast.Lambda):
        key = f"{mod.path}:{expr.lineno}:{expr.col_offset}:<lambda>"
        if key not in project.functions:
            info = FunctionInfo(
                key=key, qualname=f"{fn.qualname}.<lambda>",
                name="<lambda>", path=mod.path, module=mod.modname,
                node=expr, class_name=fn.class_name, parent=fn.key)
            project.functions[key] = info
            scan = _BodyScan(project, info)
            scan.var_types.update(var_types)
            scan.run()
        return [key]
    if isinstance(expr, ast.Call):
        dotted = _dotted(expr.func, mod.aliases)
        if dotted and dotted.split(".")[-1] == "partial" and expr.args:
            return _resolve_target(project, fn, expr.args[0], var_types,
                                   _depth + 1)
        return []
    if isinstance(expr, ast.BoolOp):
        out = []
        for v in expr.values:
            out.extend(_resolve_target(project, fn, v, var_types,
                                       _depth + 1))
        return out
    if isinstance(expr, ast.Name):
        key = project.lookup_name(expr.id, fn)
        if key:
            return [key]
        return _resolve_param(project, fn, expr.id, _depth)
    if isinstance(expr, ast.Attribute):
        base = expr.value
        if (isinstance(base, ast.Name) and base.id in ("self", "cls")
                and fn.class_name):
            cls = mod.classes.get(fn.class_name)
            if cls is not None:
                m = project.class_method(cls, expr.attr)
                if m:
                    return [m]
                out = []
                for value, owner_key, vt in cls.attr_value_exprs.get(
                        expr.attr, []):
                    owner = project.functions.get(owner_key, fn)
                    out.extend(_resolve_target(project, owner, value, vt,
                                               _depth + 1))
                return out
            return []
        if isinstance(base, ast.Name) and base.id in var_types:
            tmod, tcls = var_types[base.id]
            target_mod = project.modules.get(tmod)
            cls = target_mod.classes.get(tcls) if target_mod else None
            if cls is not None:
                m = project.class_method(cls, expr.attr)
                return [m] if m else []
            return []
        dotted = _dotted(expr, mod.aliases)
        if dotted:
            key = project.lookup_dotted(dotted)
            return [key] if key else []
    return []


def _resolve_param(project: Project, fn: FunctionInfo, name: str,
                   _depth: int) -> list:
    """A spawn target that is a *parameter* of the spawning function
    (``def _spawn(self, fn): Thread(target=fn)``) resolves through the
    arguments every caller passes for it — one interprocedural level."""
    node = fn.node
    if isinstance(node, ast.Lambda) or _depth > 4:
        return []
    posonly = [a.arg for a in getattr(node.args, "posonlyargs", [])]
    positional = posonly + [a.arg for a in node.args.args]
    kwonly = [a.arg for a in node.args.kwonlyargs]
    if name not in positional and name not in kwonly:
        return []
    pidx = positional.index(name) if name in positional else None
    out = []
    # snapshot: _resolve_target registers lambda arguments as new
    # FunctionInfo entries in project.functions while we iterate it
    for caller in list(project.functions.values()):
        for key, _line, _col, _locks, call in caller.call_sites:
            if key != fn.key:
                continue
            arg = next((k.value for k in call.keywords if k.arg == name),
                       None)
            if arg is None and pidx is not None and not any(
                    isinstance(a, ast.Starred) for a in call.args):
                # bound-method calls don't spell out `self`
                skip = (1 if (fn.class_name is not None
                              and isinstance(call.func, ast.Attribute))
                        else 0)
                i = pidx - skip
                if 0 <= i < len(call.args):
                    arg = call.args[i]
            if arg is not None:
                out.extend(_resolve_target(project, caller, arg, {},
                                           _depth + 1))
    return sorted(set(out))


def _relpath(path: str) -> str:
    try:
        rel = os.path.relpath(path)
        return rel if not rel.startswith("..") else path
    except ValueError:  # pragma: no cover - different drive on win32
        return path


def _build_entries(project: Project) -> None:
    for fn in list(project.functions.values()):
        for kind, line, expr, var_types in fn.spawns:
            keys = _resolve_target(project, fn, expr, var_types)
            where = f"{_relpath(fn.path)}:{line}"
            if not keys:
                project.unresolved_spawns.append(
                    (fn.path, line, kind, _unparse(expr)))
                continue
            for k in keys:
                project.entries.setdefault(
                    k, f"{kind} target "
                       f"{project.functions[k].qualname} ({where})")
    # threading.Thread subclasses: run() is an entry.
    for mod in project.modules.values():
        for cls in mod.classes.values():
            if any(b.split(".")[-1] == "Thread" for b in cls.base_dots):
                run_key = cls.methods.get("run")
                if run_key:
                    project.entries.setdefault(
                        run_key,
                        f"Thread subclass {cls.name}.run "
                        f"({_relpath(mod.path)})")


def _closures(project: Project) -> None:
    # thread reachability, remembering the originating entry.
    frontier = list(project.entries)
    for k in frontier:
        project.entry_origin.setdefault(k, k)
    project.thread_reachable = set(frontier)
    while frontier:
        key = frontier.pop()
        fn = project.functions.get(key)
        if fn is None:
            continue
        for callee in fn.callees:
            if callee not in project.thread_reachable:
                project.thread_reachable.add(callee)
                project.entry_origin[callee] = project.entry_origin[key]
                frontier.append(callee)
    # transitive "reaches os._exit" / "reaches a rendezvous" bits.
    project.reaches_exit = _transitive(
        project, lambda f: bool(f.exit_sites))
    project.reaches_rendezvous = _transitive(
        project, lambda f: bool(f.rendezvous_sites))


def _transitive(project: Project, base) -> set:
    hit = {k for k, f in project.functions.items() if base(f)}
    changed = True
    while changed:
        changed = False
        for k, f in project.functions.items():
            if k in hit:
                continue
            if any(c in hit for c in f.callees):
                hit.add(k)
                changed = True
    return hit


# ----------------------------------------------------------------------
# rule evaluation


def build_project(paths: Iterable[str]) -> Project:
    project = Project()
    for path in iter_python_files(paths):
        _register_module(project, path)
    for fn in list(project.functions.values()):
        _BodyScan(project, fn).run()
    _build_entries(project)
    _closures(project)
    return project


def check_project(project: Project) -> list:
    """SC401-SC404 over a built project, plus SC900 causes for files
    that failed to parse and thread targets the resolver could not pin
    down."""
    findings: list[Finding] = []

    for path, line, msg in project.syntax_errors:
        findings.append(Finding(
            "SC900", path, line, 0,
            f"file could not be parsed ({msg}); excluded from the "
            f"SC4xx/SC5xx analysis"))

    for path, line, kind, text in project.unresolved_spawns:
        findings.append(Finding(
            "SC900", path, line, 0,
            f"{kind} target `{text}` could not be resolved statically; "
            f"its callees are excluded from the SC4xx thread analysis"))

    # SC402: collected lexically during the body scans.
    for fn in project.functions.values():
        for line, col, msg in fn.blocking_under_lock:
            findings.append(Finding("SC402", fn.path, line, col, msg))

    # SC403: rendezvous/dispatch sites inside thread-reachable functions.
    for key in sorted(project.thread_reachable):
        fn = project.functions.get(key)
        if fn is None:
            continue
        origin = project.entry_origin.get(key, key)
        entry_desc = project.entries.get(
            origin, project.functions[origin].qualname
            if origin in project.functions else origin)
        for name, line, col in fn.rendezvous_sites:
            findings.append(Finding(
                "SC403", fn.path, line, col,
                f"{name}() runs on a worker thread — reachable from "
                f"{entry_desc}; collectives/barriers must stay on the "
                f"main thread"))
        for name, line, col in fn.dispatch_sites:
            findings.append(Finding(
                "SC403", fn.path, line, col,
                f"CUDA dispatch {name}() runs on a worker thread — "
                f"reachable from {entry_desc}; keep device dispatch on "
                f"the main thread and hand results to the worker"))

    # SC404: os._exit while a lock is held, directly or via a callee.
    for fn in project.functions.values():
        for line, col, locks in fn.exit_sites:
            if locks:
                findings.append(Finding(
                    "SC404", fn.path, line, col,
                    f"os._exit while holding {' and '.join(sorted(locks))}"
                    f"; _exit skips all teardown, abandoning the "
                    f"protected state mid-update"))
        for callee, line, col, locks, _call in fn.call_sites:
            if locks and callee in project.reaches_exit:
                target = project.functions[callee]
                findings.append(Finding(
                    "SC404", fn.path, line, col,
                    f"call to {target.qualname}() while holding "
                    f"{' and '.join(sorted(locks))} can reach os._exit "
                    f"without releasing it"))

    findings.extend(_check_shared_attrs(project))
    return findings


def _check_shared_attrs(project: Project) -> list:
    """SC401: write/write races on self.<attr> between thread-reachable
    and non-thread code with disjoint locksets."""
    findings: list[Finding] = []
    # group writes per (module, class, attr)
    writes: dict = {}
    for fn in project.functions.values():
        if fn.class_name is None or fn.name in _INIT_METHODS:
            continue
        for attr, line, col, locks in fn.attr_writes:
            writes.setdefault((fn.module, fn.class_name, attr), []).append(
                (fn, line, col, locks))
    for (modname, clsname, attr), sites in sorted(
            writes.items(), key=lambda kv: (kv[0][0], kv[0][1], kv[0][2])):
        mod = project.modules.get(modname)
        cls = mod.classes.get(clsname) if mod else None
        if cls is not None and attr in cls.sync_attrs:
            continue
        thread_side = [s for s in sites
                       if s[0].key in project.thread_reachable]
        main_side = [s for s in sites
                     if s[0].key not in project.thread_reachable]
        if not thread_side or not main_side:
            continue
        flagged = None
        for t in thread_side:
            for m in main_side:
                if not (t[3] & m[3]):
                    flagged = (t, m)
                    break
            if flagged:
                break
        if flagged is None:
            continue
        (tfn, tline, tcol, tlocks), (mfn, mline, _mc, mlocks) = flagged
        def _held(locks):
            return ("holding " + " and ".join(sorted(locks))
                    if locks else "with no lock held")
        findings.append(Finding(
            "SC401", tfn.path, tline, tcol,
            f"self.{attr} is written on a thread ({tfn.qualname}, "
            f"{_held(tlocks)}) and from non-thread code "
            f"({mfn.qualname} at {_relpath(mfn.path)}:{mline}, "
            f"{_held(mlocks)}) with no common lock; the writes can race"))
    return findings


def check_paths(paths: Iterable[str]):
    """Convenience: build the project and run SC4xx. Returns
    ``(findings, project)`` so liveness.py can reuse the graphs."""
    project = build_project(paths)
    return check_project(project), project
