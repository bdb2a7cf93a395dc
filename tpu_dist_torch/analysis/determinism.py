"""Determinism & RNG-lineage analyzer — the SC6xx family.

Counterpart of ``tpu_dist/analysis/determinism.py`` over PyTorch's RNG:
the sources add ``torch.seed()``, an unseeded ``torch.Generator()`` and
the global torch generator's draws (``torch.rand*``/``randperm``/
``normal``/``bernoulli``/``multinomial`` with no ``generator=``); the
sinks add ``manual_seed`` (a generator's or the global one's). SC602 has
no consumed key to find — torch generators are stateful — so it flags the
counterpart: one seed value given to ``manual_seed`` twice in a function,
or inside a loop whose iterations do not change it, which replays one
stream where two were meant.

Every headline exactness gate this repo ships — rollback-and-replay loss
parity, journal-replay token identity, the PS apply-log's bit-identical
replay — rests on one unwritten invariant: **all randomness is
coordinate-derived** (epoch/step/rank folds), **all ordering that feeds
state is explicit**, and **no wall-clock or unordered-iteration value
ever taints persisted state**. This pass machine-checks that invariant,
the way concurrency.py machine-checked the threading rules.

It is a pure-AST interprocedural analysis over the same
:class:`~tpu_dist_torch.analysis.concurrency.Project` call graph — no imports,
no backend:

* **SC601 nondet-source-taints-state.** A transitive taint walk seeded
  by nondeterministic sources: wall-clock reads (``time.time``/
  ``time_ns``, ``datetime.now/utcnow/today``), ``uuid1``/``uuid4``,
  ``os.urandom``, unseeded stdlib ``random.*`` draws, unseeded
  ``np.random`` (``default_rng()`` with no argument, the global-state
  samplers), and ``st_mtime``/``st_mtime_ns`` attribute reads. Taint
  propagates through assignments, arithmetic/f-strings, calls (a call
  with a tainted receiver or argument returns taint), subscript stores
  into local containers, ``self.<attr>`` stores (class-wide, cross
  method), and — interprocedurally — through project functions whose
  return value is tainted (fixed point over the call graph). Sinks are
  the exactness contracts: RNG seeding (``manual_seed``/
  ``Generator``/``SeedSequence``/``seed=``/``key=`` keywords, stdlib/np
  seeding) and durable replay-bearing payloads — calls whose resolved
  callee, enclosing function, or written path matches the
  checkpoint/journal/apply-log family. ``scan_grads`` is exempt by name:
  mtime-ordered arrival is that function's *documented* contract.
  Duration clocks (``perf_counter``/``monotonic``) are deliberately NOT
  sources — they measure intervals, and flagging them would bury the
  wall-clock signal in telemetry noise.
* **SC602 rng-key-reuse.** A linear per-function walk over
  ``manual_seed`` calls: a seed expression given twice (no store to a
  name it reads in between) seeds two streams that are one; inside a loop
  a seed that reads nothing the loop changes replays one stream every
  iteration. if/else arms are merged conservatively.
* **SC603 unordered-iteration-feeds-order.** ``for`` loops (and
  comprehensions feeding persisted sequences) over unordered iterables —
  ``os.listdir``/``scandir``/``glob``/``rglob``/``iterdir``, ``set()``
  values — with an order-sensitive body: a durable write, an append to a
  sequence that is never ``sorted()`` in the function, or a collective
  launch. Append-then-``sorted``-at-return, pure ``set.add``/counter/
  ``unlink`` bodies, and ``sorted(...)``-wrapped iterables are all
  clean.
* **SC604 fold-constant-collision.** A project-wide registry of integer
  constants (>= 1000) folded at seed-derivation sites — ``manual_seed``
  and ``fold_in`` arguments, constants inside ``*seed*``/``*key*``-named calls or
  derivation functions, ``*FOLD*`` module constants. The same constant
  folded at two distinct derive sites is a stream-collision risk.
* **SC605 float-accumulation-over-unordered.** ``sum()`` over an
  unordered iterable, or ``+=`` accumulation inside a loop over one,
  within functions whose name matches the checksum/replay/verify/audit
  family — the paths where accumulation order changes the bits that a
  replay gate then compares.

Degradation is never silent: files that fail to parse and tainted values
escaping into stores the walk cannot track (attributes of non-``self``
objects) surface as SC900 info findings, exactly like concurrency.py's
unresolvable spawn targets.

The recorded companion (SC610, per-entry-point baselines of random aten
ops) lives in trace_checks.py/baseline.py — this module is the host-code
half of the exactness contract.
"""

from __future__ import annotations

import ast
import re
from typing import Iterable, Optional

from tpu_dist_torch.analysis.ast_lint import _dotted
from tpu_dist_torch.analysis.concurrency import (
    RENDEZVOUS_TAILS,
    FunctionInfo,
    Project,
    _is_torch_collective,
    _iter_calls,
    _tail,
    _unparse,
    build_project,
)
from tpu_dist_torch.analysis.rules import Finding

# ----------------------------------------------------------------------
# source / sink vocabulary

#: Dotted calls that produce nondeterministic values. Matched on the
#: alias-resolved dotted path where one exists, else on the raw tail.
_WALLCLOCK_DOTTED = frozenset({
    "time.time", "time.time_ns", "os.urandom",
    "uuid.uuid1", "uuid.uuid4",
})

#: Attribute tails whose *call* is a nondet source regardless of the
#: receiver (datetime.datetime.now / datetime.date.today / pd.Timestamp
#: .utcnow all end the same way).
_WALLCLOCK_CALL_TAILS = frozenset({"utcnow", "today"})

#: stdlib `random` module samplers — nondeterministic unless the module
#: was seeded, and module-level seeding is exactly what coordinate-derived
#: RNG forbids, so every draw counts as a source.
_STDLIB_RANDOM_TAILS = frozenset({
    "random", "randint", "randrange", "uniform", "choice", "choices",
    "sample", "shuffle", "getrandbits", "gauss", "normalvariate",
    "betavariate", "expovariate", "triangular",
})

#: np.random global-state samplers (np.random.rand / np.random.randint
#: ... read the unseeded global BitGenerator).
_NP_RANDOM_TAILS = _STDLIB_RANDOM_TAILS | frozenset({
    "rand", "randn", "random_sample", "standard_normal", "integers",
    "bytes", "permutation",
})

#: The global torch generator's samplers: nondeterministic unless the
#: process seeded it, which coordinate-derived RNG forbids, so a draw with
#: no ``generator=`` counts as a source.
_TORCH_GLOBAL_TAILS = frozenset({
    "rand", "randn", "randint", "randperm", "rand_like", "randn_like",
    "randint_like", "normal", "bernoulli", "multinomial", "poisson",
})

#: Attribute READS that are nondet sources (no call involved).
_MTIME_ATTRS = frozenset({"st_mtime", "st_mtime_ns"})

#: Function names exempt from SC601 sources: mtime-ordered arrival is
#: scan_grads' documented contract (ties broken by name — see
#: cluster/ps_transport.py and the property test pinning it).
_SOURCE_EXEMPT_FN = frozenset({"scan_grads"})

#: RNG-derivation call tails (sink a): a tainted argument here converts
#: a nondet value into a stream identity.
_RNG_DERIVE_TAILS = frozenset({
    "manual_seed", "seed", "default_rng", "Generator", "SeedSequence",
    "RandomState", "set_seed",
})

#: Durable replay-bearing context (sink b): matched against the resolved
#: callee's qualname, the enclosing function's qualname, and the written
#: path/call expression. Deliberately TIGHT — checkpoint/journal/apply-log
#: are the replay contracts; heartbeats, liveness markers, telemetry
#: exports and transport packet metadata are wall-clock by nature and
#: excluded on purpose.
_PERSIST_RE = re.compile(
    r"(checkpoint|ckpt|journal|apply_log|applylog|snapshot)", re.I)

#: File-write call tails considered durable when the context matches.
_WRITE_TAILS = frozenset({
    "write", "write_text", "write_bytes", "dump", "save", "savez",
    "savez_compressed", "open", "replace", "rename",
})

#: Unordered-iterable producing call tails (SC603/SC605).
_FS_SCAN_TAILS = frozenset({
    "listdir", "scandir", "glob", "rglob", "iterdir",
})

#: Loop-body call tails that mark a body order-INSENSITIVE on their own
#: (pure removal / set membership bookkeeping).
_ORDER_FREE_TAILS = frozenset({
    "add", "discard", "unlink", "remove", "rmdir", "rmtree", "pop",
})

#: Functions whose name marks a checksum/replay/verify path (SC605).
_EXACT_PATH_FN_RE = re.compile(
    r"(checksum|replay|verify|audit|digest|fingerprint)", re.I)

#: Seed-derivation context for SC604 constant harvesting.
_DERIVE_FN_RE = re.compile(r"(seed|fold|derive_key)", re.I)
_DERIVE_CALL_RE = re.compile(r"(fold_in|seed|key)", re.I)
_FOLD_GLOBAL_RE = re.compile(r"FOLD", re.I)

#: Constants below this are ignored by SC604: manual_seed(0), axis sizes,
#: small shape arithmetic. Real fold constants are large primes.
_FOLD_MIN = 1000


def _call_dotted(call: ast.Call, aliases: dict) -> Optional[str]:
    return _dotted(call.func, aliases)


def _is_nondet_source(call: ast.Call, aliases: dict,
                      fn: FunctionInfo) -> Optional[str]:
    """Reason string when this call produces a nondeterministic value."""
    if fn.name in _SOURCE_EXEMPT_FN:
        return None
    tail = _tail(call.func)
    dotted = _call_dotted(call, aliases) or ""
    parts = dotted.split(".")
    if dotted in _WALLCLOCK_DOTTED:
        return f"{dotted}()"
    if tail == "now" and ("datetime" in parts or "date" in parts):
        return f"{dotted or 'datetime.now'}()"
    if tail in _WALLCLOCK_CALL_TAILS and isinstance(call.func,
                                                    ast.Attribute):
        return f"{dotted or tail}()"
    if tail in ("uuid1", "uuid4"):
        return f"{tail}()"
    if parts[0] == "torch":
        if dotted == "torch.seed":
            return "torch.seed()"
        if tail == "Generator" and not call.args and not call.keywords:
            return "an unseeded torch.Generator()"
        if len(parts) == 2 and tail in _TORCH_GLOBAL_TAILS and not any(
                k.arg == "generator" for k in call.keywords):
            return f"the global torch generator's {dotted}()"
    if "random" in parts:
        np_rooted = parts[0] in ("np", "numpy")
        if tail == "default_rng" and not call.args and not call.keywords:
            return "unseeded default_rng()"
        if np_rooted and tail in _NP_RANDOM_TAILS:
            return f"unseeded np.random.{tail}()"
        if not np_rooted and parts[0] == "random" \
                and tail in _STDLIB_RANDOM_TAILS:
            return f"unseeded random.{tail}()"
    return None


def _mtime_reads(node: ast.AST, fn: FunctionInfo) -> list:
    if fn.name in _SOURCE_EXEMPT_FN:
        return []
    return [n for n in ast.walk(node)
            if isinstance(n, ast.Attribute) and n.attr in _MTIME_ATTRS]


# ----------------------------------------------------------------------
# the taint walk (SC601)


class _TaintScan:
    """One function's taint walk. ``tainted`` maps local name -> reason
    string (the original source, carried through for the message)."""

    def __init__(self, project: Project, fn: FunctionInfo,
                 returns_taint: dict, class_taint: dict,
                 findings: Optional[list] = None):
        self.project = project
        self.fn = fn
        self.mod = project.modules[fn.module]
        self.aliases = self.mod.aliases
        self.returns_taint = returns_taint  # fn key -> reason
        self.class_taint = class_taint      # (module, class) -> {attr: why}
        self.findings = findings            # None during fixed-point passes
        self.tainted: dict = {}
        self.returns: Optional[str] = None  # reason if a return is tainted
        self._reported: set = set()

    # -- expression taint ---------------------------------------------

    def taint_of(self, node: ast.AST) -> Optional[str]:
        """Reason string when the expression's value is tainted. Lambda
        and nested-def subtrees are pruned: passing a closure that READS
        a nondet value is not itself passing a nondet value."""
        if node is None:
            return None
        stack = [node]
        while stack:
            sub = stack.pop()
            if isinstance(sub, (ast.Lambda, ast.FunctionDef,
                                ast.AsyncFunctionDef)) and sub is not node:
                continue
            if isinstance(sub, ast.Call) and _tail(sub.func) == \
                    "manual_seed":
                # g.manual_seed(s) returns g seeded by s: only s counts.
                stack.extend(sub.args)
                stack.extend(k.value for k in sub.keywords)
                continue
            why = self._node_taint(sub)
            if why:
                return why
            stack.extend(ast.iter_child_nodes(sub))
        return None

    def _node_taint(self, sub: ast.AST) -> Optional[str]:
        if isinstance(sub, ast.Name):
            return self.tainted.get(sub.id)
        if isinstance(sub, ast.Attribute):
            if sub.attr in _MTIME_ATTRS \
                    and self.fn.name not in _SOURCE_EXEMPT_FN:
                return f".{sub.attr} read"
            if isinstance(sub.value, ast.Name) \
                    and sub.value.id in ("self", "cls") \
                    and self.fn.class_name:
                attrs = self.class_taint.get(
                    (self.fn.module, self.fn.class_name), {})
                return attrs.get(sub.attr)
            return None
        if isinstance(sub, ast.Call):
            why = _is_nondet_source(sub, self.aliases, self.fn)
            if why:
                return why
            resolved = self.project.resolve_call(sub.func, self.fn, {})
            if resolved and resolved in self.returns_taint:
                target = self.project.functions[resolved]
                return (f"{self.returns_taint[resolved]} via "
                        f"{target.qualname}()")
        return None

    # -- statements ----------------------------------------------------

    def run(self) -> None:
        node = self.fn.node
        if isinstance(node, ast.Lambda):
            self._sinks_in(node.body)
            if self.taint_of(node.body):
                self.returns = self.taint_of(node.body)
            return
        self._stmts(node.body)

    def _stmts(self, body) -> None:
        for stmt in body:
            self._stmt(stmt)

    def _stmt(self, stmt: ast.stmt) -> None:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return
        if isinstance(stmt, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            self._assign(stmt)
            return
        if isinstance(stmt, ast.Return):
            if stmt.value is not None:
                self._sinks_in(stmt.value)
                why = self.taint_of(stmt.value)
                if why:
                    self.returns = self.returns or why
            return
        if isinstance(stmt, (ast.If, ast.While)):
            self._sinks_in(stmt.test)
            self._stmts(stmt.body)
            self._stmts(stmt.orelse)
            return
        if isinstance(stmt, (ast.For, ast.AsyncFor)):
            self._sinks_in(stmt.iter)
            why = self.taint_of(stmt.iter)
            if why:
                for t in ast.walk(stmt.target):
                    if isinstance(t, ast.Name):
                        self.tainted.setdefault(t.id, why)
            self._stmts(stmt.body)
            self._stmts(stmt.orelse)
            return
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                self._sinks_in(item.context_expr)
                if item.optional_vars is not None:
                    why = self.taint_of(item.context_expr)
                    if why:
                        for t in ast.walk(item.optional_vars):
                            if isinstance(t, ast.Name):
                                self.tainted.setdefault(t.id, why)
            self._stmts(stmt.body)
            return
        if isinstance(stmt, ast.Try):
            self._stmts(stmt.body)
            for h in stmt.handlers:
                self._stmts(h.body)
            self._stmts(stmt.orelse)
            self._stmts(stmt.finalbody)
            return
        if isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Call) \
                and _tail(stmt.value.func) == "manual_seed" \
                and isinstance(stmt.value.func, ast.Attribute) \
                and isinstance(stmt.value.func.value, ast.Name) \
                and not self.taint_of(stmt.value):
            # g = torch.Generator(); g.manual_seed(clean): g is seeded now.
            self.tainted.pop(stmt.value.func.value.id, None)
        for child in ast.iter_child_nodes(stmt):
            if isinstance(child, ast.expr):
                self._sinks_in(child)

    def _assign(self, stmt) -> None:
        value = getattr(stmt, "value", None)
        if value is not None:
            self._sinks_in(value)
        why = self.taint_of(value) if value is not None else None
        if isinstance(stmt, ast.AugAssign):
            # x += tainted taints x; x += clean keeps x's current state.
            targets = [stmt.target]
        else:
            targets = (stmt.targets if isinstance(stmt, ast.Assign)
                       else [stmt.target])
        for t in targets:
            self._taint_target(t, why,
                               clear=not isinstance(stmt, ast.AugAssign))

    def _taint_target(self, t: ast.AST, why: Optional[str],
                      clear: bool) -> None:
        if isinstance(t, (ast.Tuple, ast.List)):
            for el in t.elts:
                self._taint_target(el, why, clear)
            return
        if isinstance(t, ast.Starred):
            self._taint_target(t.value, why, clear)
            return
        if isinstance(t, ast.Name):
            if why:
                self.tainted[t.id] = why
            elif clear:
                self.tainted.pop(t.id, None)
            return
        if isinstance(t, ast.Subscript):
            # d[k] = tainted taints the container (payload dicts).
            base = t.value
            if why and isinstance(base, ast.Name):
                self.tainted[base.id] = why
            elif why and isinstance(base, ast.Attribute) \
                    and isinstance(base.value, ast.Name) \
                    and base.value.id in ("self", "cls") \
                    and self.fn.class_name:
                self.class_taint.setdefault(
                    (self.fn.module, self.fn.class_name), {}).setdefault(
                    base.attr, why)
            return
        if isinstance(t, ast.Attribute):
            if isinstance(t.value, ast.Name) and t.value.id in ("self",
                                                                "cls"):
                if self.fn.class_name:
                    attrs = self.class_taint.setdefault(
                        (self.fn.module, self.fn.class_name), {})
                    if why:
                        attrs.setdefault(t.attr, why)
                return
            if why:
                # Cross-object store the walk cannot track: degrade loudly.
                self._report(
                    "SC900", t.lineno, t.col_offset,
                    f"nondeterministic value ({why}) stored into "
                    f"`{_unparse(t)}`; cross-object taint is not tracked "
                    f"— the SC601 guarantee has a hole here")

    # -- sinks ----------------------------------------------------------

    def _sinks_in(self, node: ast.AST) -> None:
        if self.findings is None:
            return
        for call in _iter_calls(node):
            self._check_sink(call)

    def _check_sink(self, call: ast.Call) -> None:
        tail = _tail(call.func) or ""
        dotted = _call_dotted(call, self.aliases) or ""
        rng_ish = (tail in _RNG_DERIVE_TAILS
                   or "random" in dotted.split("."))
        tainted_args = []
        for a in call.args:
            w = self.taint_of(a.value if isinstance(a, ast.Starred) else a)
            if w:
                tainted_args.append(w)
        for k in call.keywords:
            w = self.taint_of(k.value)
            if w:
                tainted_args.append(w)
                # `key=` is an RNG sink only on RNG-ish calls —
                # max(key=...)/sorted(key=...) comparators are not keys.
                if k.arg and (k.arg in ("seed", "rng")
                              or (k.arg == "key" and rng_ish)):
                    self._report(
                        "SC601", call.lineno, call.col_offset,
                        f"nondeterministic value ({w}) passed as "
                        f"`{k.arg}=` to {_unparse(call.func)}(); RNG "
                        f"identity must be coordinate-derived "
                        f"(epoch/step/rank), never wall-clock or "
                        f"unseeded-RNG derived")
        if not tainted_args:
            return
        why = tainted_args[0]
        if tail in _RNG_DERIVE_TAILS:
            self._report(
                "SC601", call.lineno, call.col_offset,
                f"nondeterministic value ({why}) flows into RNG "
                f"derivation {_unparse(call.func)}(); the stream is no "
                f"longer coordinate-derived and replay diverges")
            return
        context = f"{self.fn.qualname} {_unparse(call)}"
        resolved = self.project.resolve_call(call.func, self.fn, {})
        if resolved:
            context += " " + self.project.functions[resolved].qualname
        if tail in _WRITE_TAILS and _PERSIST_RE.search(context):
            self._report(
                "SC601", call.lineno, call.col_offset,
                f"nondeterministic value ({why}) written into a durable "
                f"replay-bearing payload via {_unparse(call.func)}(); "
                f"replayed state can never be bit-compared against it")
        elif resolved and _PERSIST_RE.search(
                self.project.functions[resolved].qualname):
            self._report(
                "SC601", call.lineno, call.col_offset,
                f"nondeterministic value ({why}) passed to "
                f"{self.project.functions[resolved].qualname}(), a "
                f"durable checkpoint/journal/apply-log writer; replayed "
                f"state can never be bit-compared against it")
        elif _PERSIST_RE.search(tail):
            # unresolved, but the method NAME declares durability
            # (append_apply_log, write_checkpoint, ...)
            self._report(
                "SC601", call.lineno, call.col_offset,
                f"nondeterministic value ({why}) passed to "
                f"{_unparse(call.func)}(), a durable "
                f"checkpoint/journal/apply-log writer; replayed state "
                f"can never be bit-compared against it")

    def _report(self, rule: str, line: int, col: int, msg: str) -> None:
        if self.findings is None:
            return
        key = (rule, line, col)
        if key in self._reported:
            return
        self._reported.add(key)
        self.findings.append(Finding(rule, self.fn.path, line, col, msg))


def _taint_fixed_point(project: Project) -> tuple[dict, dict]:
    """(returns_taint, class_taint) fixed point: which project functions
    return nondeterministic values, and which self attributes hold them."""
    returns_taint: dict = {}
    class_taint: dict = {}
    for _round in range(6):
        changed = False
        for fn in project.functions.values():
            scan = _TaintScan(project, fn, returns_taint, class_taint)
            scan.run()
            if scan.returns and fn.key not in returns_taint:
                returns_taint[fn.key] = scan.returns
                changed = True
        if not changed:
            break
    return returns_taint, class_taint


def _check_taint(project: Project) -> list:
    returns_taint, class_taint = _taint_fixed_point(project)
    findings: list[Finding] = []
    for fn in sorted(project.functions.values(),
                     key=lambda f: (f.path, getattr(f.node, "lineno", 0))):
        _TaintScan(project, fn, returns_taint, class_taint,
                   findings=findings).run()
    return findings


# ----------------------------------------------------------------------
# SC602: one seed replayed


def _seed_value(call: ast.Call) -> Optional[ast.AST]:
    """The value a ``manual_seed`` call seeds with, if this is one."""
    if _tail(call.func) != "manual_seed" or not isinstance(
            call.func, ast.Attribute):
        return None
    if call.args:
        return call.args[0]
    return next((k.value for k in call.keywords if k.arg == "seed"), None)


def _names(node: ast.AST) -> set:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


def _stored_names(stmts) -> set:
    out: set = set()
    for stmt in stmts:
        for n in ast.walk(stmt):
            if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Store):
                out.add(n.id)
    return out


class _SeedScan:
    """Linear walk for SC602: ``seen`` maps a seed expression's text to
    the line that first seeded with it; a store to any name it reads
    forgets it. Inside a loop, a seed that reads nothing the loop
    changes replays the same stream every iteration."""

    def __init__(self, fn: FunctionInfo, findings: list):
        self.fn = fn
        self.findings = findings
        self._reported: set = set()

    def run(self) -> None:
        if not isinstance(self.fn.node, ast.Lambda):
            self._stmts(self.fn.node.body, {}, loop_vars=None)

    def _report(self, call: ast.Call, msg: str) -> None:
        key = (call.lineno, call.col_offset)
        if key not in self._reported:
            self._reported.add(key)
            self.findings.append(Finding(
                "SC602", self.fn.path, call.lineno, call.col_offset, msg))

    def _stmts(self, body, seen: dict, loop_vars) -> None:
        for stmt in body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue
            if isinstance(stmt, (ast.For, ast.AsyncFor, ast.While)):
                changed = _stored_names(stmt.body)
                if not isinstance(stmt, ast.While):
                    changed |= _names(stmt.target)
                inner = (changed if loop_vars is None
                         else changed | loop_vars)
                self._stmts(stmt.body, dict(seen), inner)
                self._stmts(stmt.orelse, seen, loop_vars)
                continue
            if isinstance(stmt, ast.If):
                self._calls(stmt.test, seen, loop_vars)
                then_seen, else_seen = dict(seen), dict(seen)
                self._stmts(stmt.body, then_seen, loop_vars)
                self._stmts(stmt.orelse, else_seen, loop_vars)
                seen.update(then_seen)
                seen.update(else_seen)
                continue
            if isinstance(stmt, (ast.With, ast.AsyncWith, ast.Try)):
                for field in ("body", "orelse", "finalbody"):
                    self._stmts(getattr(stmt, field, []), seen, loop_vars)
                for h in getattr(stmt, "handlers", []):
                    self._stmts(h.body, seen, loop_vars)
                continue
            self._calls(stmt, seen, loop_vars)
            for name in _stored_names([stmt]):
                for text in [t for t, (_l, names) in seen.items()
                             if name in names]:
                    del seen[text]

    def _calls(self, node, seen: dict, loop_vars) -> None:
        for call in _iter_calls(node):
            value = _seed_value(call)
            if value is None:
                continue
            text = _unparse(value)
            names = _names(value)
            if loop_vars is not None and not (names & loop_vars):
                self._report(
                    call, f"manual_seed({text}) inside a loop whose "
                    f"iterations do not change the seed: every iteration "
                    f"replays the same stream — fold the loop's "
                    f"coordinate into the seed, or seed once before it")
            elif text in seen:
                self._report(
                    call, f"manual_seed({text}) seeds a stream with the "
                    f"value already given on line {seen[text][0]}: the two "
                    f"streams are one, not independent — give each domain "
                    f"its own seed")
            else:
                seen[text] = (call.lineno, names)


def _check_seed_reuse(project: Project) -> list:
    findings: list[Finding] = []
    for fn in sorted(project.functions.values(),
                     key=lambda f: (f.path, getattr(f.node, "lineno", 0))):
        _SeedScan(fn, findings).run()
    return findings


# ----------------------------------------------------------------------
# SC603 / SC605: unordered iteration


def _unordered_reason(node: ast.AST, aliases: dict,
                      set_names: set) -> Optional[str]:
    """Why this iterable expression is unordered, or None. A sorted(...)
    wrapper (anywhere enclosing) makes it ordered."""
    if isinstance(node, ast.Call):
        tail = _tail(node.func)
        if tail == "sorted":
            return None
        if tail in _FS_SCAN_TAILS:
            return f"{_unparse(node.func)}() (filesystem enumeration " \
                   f"order is arbitrary)"
        if tail == "set":
            return "set() (hash iteration order)"
        if tail == "list" and node.args:
            return _unordered_reason(node.args[0], aliases, set_names)
    if isinstance(node, (ast.Set, ast.SetComp)):
        return "a set literal (hash iteration order)"
    if isinstance(node, ast.Name) and node.id in set_names:
        return f"`{node.id}` (a set; hash iteration order)"
    if isinstance(node, ast.BinOp) and isinstance(
            node.op, (ast.BitOr, ast.BitAnd, ast.Sub)):
        # set algebra: a | b, a & b, a - b over sets
        left = _unordered_reason(node.left, aliases, set_names)
        right = _unordered_reason(node.right, aliases, set_names)
        return left or right
    return None


def _collect_set_names(fn: FunctionInfo) -> set:
    """Local names assigned set()/set-literal/set-comprehension values."""
    out: set = set()
    node = fn.node
    if isinstance(node, ast.Lambda):
        return out
    for stmt in ast.walk(node):
        if isinstance(stmt, ast.Assign):
            v = stmt.value
            is_set = (isinstance(v, (ast.Set, ast.SetComp))
                      or (isinstance(v, ast.Call)
                          and _tail(v.func) == "set"))
            if is_set:
                for t in stmt.targets:
                    if isinstance(t, ast.Name):
                        out.add(t.id)
    return out


def _sorted_names(fn: FunctionInfo) -> set:
    """Names passed to sorted()/.sort() anywhere in the function — an
    append target later sorted is order-clean."""
    out: set = set()
    node = fn.node
    if isinstance(node, ast.Lambda):
        return out
    for call in ast.walk(node):
        if not isinstance(call, ast.Call):
            continue
        tail = _tail(call.func)
        if tail == "sorted" and call.args and isinstance(call.args[0],
                                                        ast.Name):
            out.add(call.args[0].id)
        elif tail == "sort" and isinstance(call.func, ast.Attribute) \
                and isinstance(call.func.value, ast.Name):
            out.add(call.func.value.id)
    return out


def _body_order_sensitivity(fn: FunctionInfo, project: Project, body,
                            sorted_later: set) -> Optional[str]:
    """Why this loop body is order-sensitive, or None."""
    aliases = project.modules[fn.module].aliases
    for stmt in body:
        for call in _iter_calls(stmt):
            tail = _tail(call.func) or ""
            dotted = _dotted(call.func, aliases) or ""
            if tail in RENDEZVOUS_TAILS or _is_torch_collective(
                    tail, dotted):
                return f"launches {tail}() (collective operand order " \
                       f"must be rank-uniform)"
            if tail == "append" and isinstance(call.func, ast.Attribute) \
                    and isinstance(call.func.value, ast.Name):
                target = call.func.value.id
                if target not in sorted_later:
                    return f"appends to `{target}`, which is never " \
                           f"sorted in this function"
            if tail in _WRITE_TAILS and tail not in ("replace", "rename"):
                context = _unparse(call)
                resolved = project.resolve_call(call.func, fn, {})
                if resolved:
                    context += " " + project.functions[resolved].qualname
                if _PERSIST_RE.search(f"{fn.qualname} {context}"):
                    return f"writes durable state via " \
                           f"{_unparse(call.func)}()"
            resolved = project.resolve_call(call.func, fn, {})
            if resolved and _PERSIST_RE.search(
                    project.functions[resolved].qualname):
                return (f"calls durable writer "
                        f"{project.functions[resolved].qualname}()")
        for sub in ast.walk(stmt):
            if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.Lambda)):
                break
            if isinstance(sub, ast.AugAssign) and isinstance(
                    sub.target, ast.Name) \
                    and isinstance(sub.op, ast.Add) \
                    and sub.target.id not in sorted_later \
                    and isinstance(sub.value, (ast.List, ast.ListComp)):
                return f"extends `{sub.target.id}`, which is never " \
                       f"sorted in this function"
    return None


def _check_unordered_iteration(project: Project) -> list:
    findings: list[Finding] = []
    for fn in sorted(project.functions.values(),
                     key=lambda f: (f.path, getattr(f.node, "lineno", 0))):
        node = fn.node
        if isinstance(node, ast.Lambda):
            continue
        mod = project.modules[fn.module]
        set_names = _collect_set_names(fn)
        sorted_later = _sorted_names(fn)
        exact_path = bool(_EXACT_PATH_FN_RE.search(fn.qualname))
        for stmt in ast.walk(node):
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and stmt is not node:
                continue
            if isinstance(stmt, (ast.For, ast.AsyncFor)):
                reason = _unordered_reason(stmt.iter, mod.aliases,
                                           set_names)
                if reason is None:
                    continue
                sens = _body_order_sensitivity(fn, project, stmt.body,
                                               sorted_later)
                if sens is not None:
                    findings.append(Finding(
                        "SC603", fn.path, stmt.lineno, stmt.col_offset,
                        f"iteration over {reason} {sens}; run-to-run "
                        f"order differs — wrap the iterable in sorted() "
                        f"or make the body order-insensitive"))
                elif exact_path and _has_float_accumulation(stmt):
                    findings.append(Finding(
                        "SC605", fn.path, stmt.lineno, stmt.col_offset,
                        f"float accumulation over {reason} inside "
                        f"{fn.qualname}; addition order changes the "
                        f"bits a replay/verify gate compares — sort the "
                        f"iterable or accumulate in integers"))
            elif isinstance(stmt, ast.Call) and exact_path \
                    and _tail(stmt.func) == "sum" and stmt.args:
                reason = _unordered_reason(stmt.args[0], mod.aliases,
                                           set_names)
                if reason is None and isinstance(stmt.args[0],
                                                 ast.GeneratorExp):
                    gen = stmt.args[0].generators[0]
                    reason = _unordered_reason(gen.iter, mod.aliases,
                                               set_names)
                if reason is not None:
                    findings.append(Finding(
                        "SC605", fn.path, stmt.lineno, stmt.col_offset,
                        f"sum() over {reason} inside {fn.qualname}; "
                        f"float addition order changes the bits a "
                        f"replay/verify gate compares — sort the "
                        f"iterable or accumulate in integers"))
    return findings


def _has_float_accumulation(loop) -> bool:
    for sub in ast.walk(loop):
        if isinstance(sub, ast.AugAssign) and isinstance(sub.op, ast.Add):
            return True
    return False


# ----------------------------------------------------------------------
# SC604: fold-constant collision


def _module_fold_constants(mod) -> dict:
    """Module-level ``_FOLD``-style int constants: name -> value."""
    out: dict = {}
    for stmt in mod.tree.body:
        if isinstance(stmt, ast.Assign) \
                and isinstance(stmt.value, ast.Constant) \
                and isinstance(stmt.value.value, int) \
                and not isinstance(stmt.value.value, bool):
            for t in stmt.targets:
                if isinstance(t, ast.Name) \
                        and _FOLD_GLOBAL_RE.search(t.id):
                    out[t.id] = stmt.value.value
    return out


def _derive_site_constants(fn: FunctionInfo, fold_globals: dict):
    """(value, line, col) int constants folded at this function's
    seed-derivation sites."""
    node = fn.node
    if isinstance(node, ast.Lambda):
        return
    in_derive_fn = bool(_DERIVE_FN_RE.search(fn.name))

    def _consts(expr):
        for sub in ast.walk(expr):
            if isinstance(sub, ast.Constant) \
                    and isinstance(sub.value, int) \
                    and not isinstance(sub.value, bool) \
                    and abs(sub.value) >= _FOLD_MIN:
                yield (sub.value, sub.lineno, sub.col_offset)
            elif isinstance(sub, ast.Name) and sub.id in fold_globals \
                    and abs(fold_globals[sub.id]) >= _FOLD_MIN:
                yield (fold_globals[sub.id], sub.lineno, sub.col_offset)

    seen_lines: set = set()
    # _iter_calls prunes FunctionDef nodes, including the one passed in —
    # walk the body statements instead.
    for call in (c for stmt in node.body for c in _iter_calls(stmt)):
        tail = _tail(call.func) or ""
        if not _DERIVE_CALL_RE.search(tail):
            continue
        for arg in list(call.args) + [k.value for k in call.keywords]:
            for hit in _consts(arg):
                if hit[1:] not in seen_lines:
                    seen_lines.add(hit[1:])
                    yield hit
    if in_derive_fn:
        for stmt in node.body:
            if isinstance(stmt, ast.Return) and stmt.value is not None:
                for hit in _consts(stmt.value):
                    if hit[1:] not in seen_lines:
                        seen_lines.add(hit[1:])
                        yield hit


def _check_fold_constants(project: Project) -> list:
    registry: dict = {}  # value -> [(fn, line, col)]
    for fn in sorted(project.functions.values(),
                     key=lambda f: (f.path, getattr(f.node, "lineno", 0))):
        mod = project.modules[fn.module]
        fold_globals = _module_fold_constants(mod)
        for value, line, col in _derive_site_constants(fn, fold_globals):
            registry.setdefault(value, []).append((fn, line, col))
    findings: list[Finding] = []
    for value in sorted(registry):
        sites = registry[value]
        distinct = {(fn.qualname,) for fn, _l, _c in sites}
        if len(distinct) < 2:
            continue
        where = ", ".join(sorted({
            f"{fn.qualname} ({fn.path}:{line})"
            for fn, line, _c in sites}))
        fn, line, col = sites[-1]
        findings.append(Finding(
            "SC604", fn.path, line, col,
            f"fold constant {value} is used by {len(distinct)} distinct "
            f"seed-derivation sites ({where}); derivations sharing a "
            f"fold constant can collide into one stream — give each "
            f"derive domain its own constant"))
    return findings


# ----------------------------------------------------------------------


def check_project(project: Project) -> list:
    """SC601-SC605 over a built project, plus SC900 for files that failed
    to parse (determinism mode runs without ast_lint, so this is the only
    report such a file gets) and for taint flows the walk cannot track."""
    findings: list[Finding] = []
    for path, line, msg in project.syntax_errors:
        findings.append(Finding(
            "SC900", path, line, 0,
            f"file could not be parsed ({msg}); excluded from the SC6xx "
            f"analysis"))
    findings.extend(_check_taint(project))
    findings.extend(_check_seed_reuse(project))
    findings.extend(_check_unordered_iteration(project))
    findings.extend(_check_fold_constants(project))
    return findings


def check_paths(paths: Iterable[str]):
    """Convenience: build the project and run SC6xx. Returns
    ``(findings, project)``."""
    project = build_project(paths)
    return check_project(project), project
