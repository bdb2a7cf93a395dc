"""Host-runtime liveness & protocol analyzer — the SC5xx family.

Counterpart of ``tpu_dist/analysis/liveness.py``. The rank predicates are
the port's: ``dist.get_rank()``, ``bootstrap.process_index()`` and
``is_chief()``, ``self.chief``, ``rank == 0``; "reaches a collective"
uses concurrency.py's PyTorch vocabulary.

Where SC4xx (concurrency.py) asks "can these threads corrupt each
other", SC5xx asks "can this rank hang the gang or tear the protocol":

* **SC501 rank-divergent barrier** — a rank-conditional ``if`` (chief
  checks, ``process_index() == 0``, ``rank == 0``) where one arm
  transitively reaches a barrier/rendezvous/collective and the other
  cannot. The barrier-free ranks never show up and everyone else blocks.
  Arms that *abort* (end in ``raise`` or hard-exit) are exempt — dying
  instead of diverging is the supervised-restart contract, not a hang.
  An ``if`` whose body terminates in ``return`` compares against the
  rest of the enclosing block (the guard-clause form); an ``if`` with
  no ``else`` and no return compares against an empty arm.
* **SC502 unbounded blocking wait** — a ``while`` loop that waits or
  polls (``.wait()``/``.get()``/``.join()``/``.acquire()``/``sleep``)
  where no wait carries a timeout and neither the loop condition nor
  the body consults a deadline/abort escape. Every blocking wait in
  this runtime is supposed to be bounded or abortable (the PR-3 rule).
* **SC503 torn protocol write** — ``open(..., "w")`` /
  ``Path.write_text`` / ``write_bytes`` whose path expression looks
  protocol-ish (marker/reform/generation/pointer/manifest/heartbeat…)
  but is neither a tmp/staging name nor in a function that also calls
  ``os.replace``. Readers polling such files must never observe a
  half-written payload; the repo idiom is tmp + ``os.replace``.

All three run over the :class:`~tpu_dist_torch.analysis.concurrency.Project`
call graph, so "reaches a collective" is transitive, with the same
conservative resolution (an unresolvable call contributes nothing).
"""

from __future__ import annotations

import ast
import re
from typing import Iterable, Optional

from tpu_dist_torch.analysis.concurrency import (
    FunctionInfo,
    Project,
    _iter_calls,
    _tail,
    _unparse,
    build_project,
)
from tpu_dist_torch.analysis.rules import Finding

#: Does an if-test look rank-conditional? Matched against the unparsed
#: test expression, so `bootstrap.is_chief()`, `rank == 0`,
#: `dist.get_rank() != 0`, `bootstrap.process_index()` and `self.chief`
#: all hit.
_RANK_TEST_RE = re.compile(
    r"\b(is_chief|chief|rank|get_rank|process_index|worker_index)\b")

#: Loop-condition identifiers that are themselves an escape: the loop
#: exits when a stop/deadline signal flips, so it is not an unbounded
#: wait on a peer.
_ESCAPE_TEST_RE = re.compile(
    r"\b(deadline|timeout|stop|shutdown|abort|done|exit|budget|"
    r"remaining|max_steps|attempts|retries|monotonic|perf_counter)", re.I)

#: Inside the loop body only deadline-ish comparisons count as escapes
#: (a sentinel `break` alone still blocks forever on the unbounded get).
_ESCAPE_BODY_RE = re.compile(
    r"\b(deadline|timeout|abort|remaining|budget|max_restarts|max_steps|"
    r"attempts|retries)", re.I)

#: Clock reads that mark a loop as deadline-driven when paired with a
#: `break`/`return` — the `wait = target - monotonic(); if wait <= 0:
#: break` pacing idiom, where the deadline variable carries no
#: deadline-ish name.
_CLOCK_TAILS = frozenset({"monotonic", "perf_counter"})

#: Path expressions that look like gang-protocol artifacts.
_PROTOCOL_PATH_RE = re.compile(
    r"(marker|reform|protocol|generation|pointer|latest|manifest|"
    r"barrier|rendezvous|gang|heartbeat|commit)", re.I)

#: ...and the staging half of the atomic-publish idiom.
_STAGING_PATH_RE = re.compile(r"(tmp|temp|stage|staging|partial)", re.I)

_WAIT_TAILS = frozenset({"wait", "get", "join", "acquire", "sleep"})


def _stmt_lines(stmts) -> list:
    """(first, last) physical-line spans covered by a statement list."""
    spans = []
    for s in stmts:
        end = getattr(s, "end_lineno", None) or s.lineno
        spans.append((s.lineno, end))
    return spans


def _in_spans(line: int, spans) -> bool:
    return any(a <= line <= b for a, b in spans)


def _iter_own_stmts(node):
    """Statement lists belonging to this function, pruning nested defs."""
    todo = [node.body]
    while todo:
        body = todo.pop()
        yield body
        for stmt in body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue
            for field in ("body", "orelse", "finalbody"):
                sub = getattr(stmt, field, None)
                if sub:
                    todo.append(sub)
            for h in getattr(stmt, "handlers", []):
                todo.append(h.body)


# ----------------------------------------------------------------------
# SC501


def _arm_reaches_rendezvous(fn: FunctionInfo, project: Project,
                            stmts) -> Optional[str]:
    """Name of a rendezvous the arm can reach, or None."""
    spans = _stmt_lines(stmts)
    for name, line, _col in fn.rendezvous_sites:
        if _in_spans(line, spans):
            return name
    for callee, line, _col, _locks, _call in fn.call_sites:
        if callee in project.reaches_rendezvous and _in_spans(line, spans):
            return project.functions[callee].qualname + "()"
    return None


def _arm_aborts(fn: FunctionInfo, stmts) -> bool:
    if stmts and isinstance(stmts[-1], ast.Raise):
        return True
    spans = _stmt_lines(stmts)
    return any(_in_spans(line, spans) for line, _c, _l in fn.exit_sites)


def _terminates(stmts) -> bool:
    return bool(stmts) and isinstance(stmts[-1], (ast.Return, ast.Raise))


def _check_rank_divergence(fn: FunctionInfo, project: Project) -> list:
    findings = []
    if isinstance(fn.node, ast.Lambda):
        return findings
    for body in _iter_own_stmts(fn.node):
        for i, stmt in enumerate(body):
            if not isinstance(stmt, ast.If):
                continue
            if not _RANK_TEST_RE.search(_unparse(stmt.test)):
                continue
            then_arm = stmt.body
            if stmt.orelse:
                else_arm = stmt.orelse
            elif _terminates(then_arm):
                # guard clause: the implicit else is the rest of the block
                else_arm = body[i + 1:]
            else:
                else_arm = []
            then_hit = _arm_reaches_rendezvous(fn, project, then_arm)
            else_hit = (_arm_reaches_rendezvous(fn, project, else_arm)
                        if else_arm else None)
            if bool(then_hit) == bool(else_hit):
                continue
            if (_arm_aborts(fn, then_arm)
                    or (else_arm and _arm_aborts(fn, else_arm))):
                continue
            hit = then_hit or else_hit
            which = "taken" if then_hit else "skipped"
            findings.append(Finding(
                "SC501", fn.path, stmt.lineno, stmt.col_offset,
                f"rank-conditional `if {_unparse(stmt.test)}` reaches "
                f"{hit} only when the test arm is {which}; ranks on the "
                f"other arm never join that rendezvous and the gang "
                f"blocks"))
    return findings


# ----------------------------------------------------------------------
# SC502


def _wait_calls(node: ast.While):
    """(call, bounded) for every wait/poll call in the loop, nested defs
    pruned. `sleep` marks a poll loop but never bounds it."""
    for call in _iter_calls(node):
        tail = _tail(call.func)
        if tail not in _WAIT_TAILS:
            continue
        timeout_kw = any(k.arg and "timeout" in k.arg
                         for k in call.keywords)
        recv = (call.func.value if isinstance(call.func, ast.Attribute)
                else None)
        if tail == "get":
            first = call.args[0] if call.args else None
            if first is not None and not (isinstance(first, ast.Constant)
                                          and first.value is True):
                continue  # dict.get(key)/environ.get(key): not a wait
            # q.get() / q.get(True) block; only a timeout bounds them
            yield call, timeout_kw or len(call.args) > 1
        elif tail == "join":
            if call.args or timeout_kw:
                continue  # "sep".join(parts) or a bounded join: ignore
            if isinstance(recv, ast.Constant):
                continue  # literal-separator string join
            yield call, False
        elif tail in ("wait", "acquire"):
            bounded = timeout_kw
            if call.args:
                first = call.args[0]
                if (isinstance(first, ast.Constant)
                        and (first.value is None or first.value is True)):
                    # cond.wait(None) / lock.acquire(True) spell out the
                    # defaults and still block forever; a second arg is
                    # acquire's timeout
                    bounded = bounded or len(call.args) > 1
                else:
                    # a numeric first arg is a timeout; acquire(False)
                    # never blocks
                    bounded = True
            yield call, bounded
        else:  # sleep: bounded per call, but it never bounds the loop
            yield call, False


def _loop_has_escape(node: ast.While) -> bool:
    if _ESCAPE_TEST_RE.search(_unparse(node.test)):
        return True
    reads_clock = has_break = False
    for sub in ast.walk(node):
        if isinstance(sub, ast.If) and _ESCAPE_BODY_RE.search(
                _unparse(sub.test)):
            return True
        if isinstance(sub, ast.Call):
            t = _tail(sub.func)
            if t and "abort" in t.lower():
                return True
            if t in _CLOCK_TAILS or _unparse(sub.func) == "time.time":
                reads_clock = True
        if isinstance(sub, (ast.Break, ast.Return)):
            has_break = True
        if isinstance(sub, ast.Raise) and sub.exc is not None:
            if _ESCAPE_BODY_RE.search(_unparse(sub.exc)):
                return True
    return reads_clock and has_break


def _check_unbounded_waits(fn: FunctionInfo) -> list:
    findings = []
    if isinstance(fn.node, ast.Lambda):
        return findings
    for body in _iter_own_stmts(fn.node):
        for stmt in body:
            if not isinstance(stmt, ast.While):
                continue
            waits = list(_wait_calls(stmt))
            if not waits:
                continue
            if any(bounded for _c, bounded in waits):
                continue
            if _loop_has_escape(stmt):
                continue
            calls = ", ".join(sorted({
                f"{_unparse(c.func)}()" for c, _b in waits}))
            findings.append(Finding(
                "SC502", fn.path, stmt.lineno, stmt.col_offset,
                f"wait loop blocks on {calls} with no timeout and no "
                f"deadline/abort escape; a dead peer leaves this rank "
                f"hung forever"))
    return findings


# ----------------------------------------------------------------------
# SC503


def _fn_calls(fn: FunctionInfo):
    """Calls in the function's own body (nested defs pruned) — _iter_calls
    seeded below the def node itself, which it would otherwise prune."""
    if isinstance(fn.node, ast.Lambda):
        yield from _iter_calls(fn.node.body)
        return
    for stmt in fn.node.body:
        yield from _iter_calls(stmt)


def _write_sites(fn: FunctionInfo):
    """(path expression text, line, col) for plain-file writes."""
    for call in _fn_calls(fn):
        tail = _tail(call.func)
        if tail in ("write_text", "write_bytes") and isinstance(
                call.func, ast.Attribute):
            yield (_unparse(call.func.value), call.lineno,
                   call.col_offset)
        elif tail == "open" and len(call.args) >= 2:
            mode = call.args[1]
            if (isinstance(mode, ast.Constant)
                    and isinstance(mode.value, str)
                    and mode.value[:1] in ("w", "x")):
                yield (_unparse(call.args[0]), call.lineno,
                       call.col_offset)
        elif tail == "open":
            mode = next((k.value for k in call.keywords
                         if k.arg == "mode"), None)
            if (mode is not None and isinstance(mode, ast.Constant)
                    and isinstance(mode.value, str)
                    and mode.value[:1] in ("w", "x") and call.args):
                yield (_unparse(call.args[0]), call.lineno,
                       call.col_offset)


def _has_os_replace(fn: FunctionInfo) -> bool:
    for call in _fn_calls(fn):
        if _tail(call.func) == "replace" and isinstance(
                call.func, ast.Attribute):
            return True
    return False


def _check_protocol_writes(fn: FunctionInfo) -> list:
    findings = []
    sites = list(_write_sites(fn))
    if not sites:
        return findings
    atomic = _has_os_replace(fn)
    for pathexpr, line, col in sites:
        if not _PROTOCOL_PATH_RE.search(pathexpr):
            continue
        if _STAGING_PATH_RE.search(pathexpr) or atomic:
            continue
        findings.append(Finding(
            "SC503", fn.path, line, col,
            f"protocol file {pathexpr} written in place; a polling "
            f"reader can observe a torn payload — stage to a tmp name "
            f"and os.replace() it into place"))
    return findings


# ----------------------------------------------------------------------


def check_project(project: Project) -> list:
    """SC501-SC503 over an already-built concurrency project."""
    findings: list[Finding] = []
    for fn in sorted(project.functions.values(), key=lambda f: (
            f.path, f.node.lineno if hasattr(f.node, "lineno") else 0)):
        findings.extend(_check_rank_divergence(fn, project))
        findings.extend(_check_unbounded_waits(fn))
        findings.extend(_check_protocol_writes(fn))
    return findings


def check_paths(paths: Iterable[str]):
    """Convenience for standalone use: build + check. Returns
    ``(findings, project)``."""
    project = build_project(paths)
    return check_project(project), project
