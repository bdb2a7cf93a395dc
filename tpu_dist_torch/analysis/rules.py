"""shardcheck rule catalogue, findings, and suppression handling.

Counterpart of ``tpu_dist/analysis/rules.py``, with the same rule IDs,
slugs and severities; each rule's text speaks of PyTorch's idioms
(process groups, ``torch.distributed`` collectives, CUDA graphs, torch
generators). The rule IDs are the stable public contract: tests assert on
them, JSON output carries them, and inline suppressions name them
(``# shardcheck: disable=SC101``). Message text is free to evolve.

Severity model: ``error`` findings are bugs-in-waiting (the CLI exits
non-zero on them); ``warning`` is suspicious-but-possibly-intended;
``info`` is diagnostics (e.g. an entry point the recorder could not run).
A rule the port keeps only as a decision (:attr:`Rule.decision`) is in
the catalogue so that its ID stays reserved, and no pass raises it.
"""

from __future__ import annotations

import dataclasses
import enum
import re
from typing import Optional


class Severity(enum.IntEnum):
    """Ordered so comparisons read naturally: ERROR > WARNING > INFO."""

    INFO = 10
    WARNING = 20
    ERROR = 30

    def __str__(self) -> str:  # JSON/text rendering
        return self.name.lower()

    @classmethod
    def parse(cls, value: "Severity | str") -> "Severity":
        if isinstance(value, cls):
            return value
        try:
            return cls[str(value).upper()]
        except KeyError:
            raise ValueError(
                f"unknown severity {value!r}; valid: "
                f"{[s.name.lower() for s in cls]}") from None


@dataclasses.dataclass(frozen=True)
class Rule:
    id: str
    name: str
    severity: Severity
    description: str
    #: Why the port does not check this rule (None: it does).
    decision: Optional[str] = None


#: The advertised catalogue. SC1xx are AST rules (ast_lint.py); SC2xx are
#: rules over recorded collective sequences (trace_checks.py); SC3xx are
#: cost/baseline rules (costmodel.py/baseline.py); SC4xx are host-runtime
#: thread-safety rules and SC5xx liveness/protocol rules
#: (concurrency.py/liveness.py, the ``--concurrency`` mode); SC6xx are
#: determinism/RNG-lineage rules (determinism.py, the ``--determinism``
#: mode, plus the SC610 recorded companion in trace_checks.py); SC901
#: polices the suppressions themselves.
RULES = {r.id: r for r in (
    Rule(
        "SC101", "unknown-collective-axis", Severity.ERROR,
        "An axis name given to a mesh's group lookup (axis_group(mesh, "
        "...), mesh.shape[...]), an axis_name= keyword or one of the "
        "port's collective wrappers that is neither canonical "
        "(tpu_dist_torch.parallel.axes) nor declared anywhere in the file "
        "(axis_shapes/mesh literal, *_AXIS constant, axis parameter "
        "default). A wrong axis name raises at best and reduces over the "
        "wrong process group at worst."),
    Rule(
        "SC102", "partitionspec-rank-mismatch", Severity.ERROR,
        "A placement (mesh.Placement(mesh, spec), a tensor-parallel rule "
        "or a DenseShard layout) names more dimensions than the tensor it "
        "places has. Placement.place narrows dimensions that do not "
        "exist and raises at run time; catching it statically saves the "
        "process-group bring-up."),
    Rule(
        "SC103", "host-side-effect-in-jit", Severity.ERROR,
        "A host side effect (print, time.*, stdlib or numpy random, "
        "input, .item(), .tolist(), .cpu(), metric recording) inside a "
        "function that a CapturedProgram or torch.cuda.graph captures. "
        "It runs once, at capture, and never on replay: prints go "
        "silent, clocks freeze, host randomness is baked into the graph, "
        "and a host read syncs a stream that capture forbids."),
    Rule(
        "SC104", "donated-buffer-reuse", Severity.ERROR,
        "A CapturedProgram's result is read after that program was "
        "called again. A captured program hands out its static output "
        "buffers, and every replay overwrites them in place: the first "
        "result now holds the second call's values. Copy (clone) the "
        "result before the next call, or read it first."),
    Rule(
        "SC105", "swallowed-liveness-error", Severity.ERROR,
        "A bare `except Exception` (or `except:`) around a call that can "
        "raise PeerUnavailableError (liveness verdicts, barriers, chief "
        "broadcasts, host reductions) swallows the dead-peer signal. A "
        "supervised run recovers from that error by restarting the "
        "worker; a handler that eats it leaves the job half-alive. Catch "
        "PeerUnavailableError explicitly first, or re-raise."),
    Rule(
        "SC201", "collective-order-divergence", Severity.ERROR,
        "Ranks of one process group record different collective "
        "sequences on it (a collective under `if rank == 0`, a branch on "
        "a rank-varying value). The collectives pair up in launch order, "
        "so the ranks that launch a different one deadlock or exchange "
        "the wrong tensors."),
    Rule(
        "SC202", "data-dependent-collective-trip-count", Severity.ERROR,
        "One rank's recorded collective sequence changes length between "
        "two input seeds: a collective inside a loop whose trip count "
        "depends on the data. Ranks whose data differ launch different "
        "numbers of collectives and the rendezvous deadlocks. Bound the "
        "loop by a rank-uniform count, or hoist the collective out."),
    Rule(
        "SC203", "collective-payload-mismatch", Severity.ERROR,
        "Paired collective launches whose payloads cannot line up across "
        "ranks: the same position of a group's sequence carries another "
        "shape or dtype on another rank, or a send has no matching recv "
        "(or the recv's bytes differ). Both run on a fake group and hang "
        "or corrupt at the rendezvous on real hardware."),
    Rule(
        "SC301", "comm-budget-regression", Severity.ERROR,
        "An entry point's total modeled communication volume exceeds "
        "the committed baseline (tpu_dist_torch/analysis/"
        "ANALYSIS_BASELINE.json) by more than the tolerance. Comm "
        "regressions only show up as step-time cliffs across many cards; "
        "the recorded diff catches them first. Intended growth: re-run "
        "with --update-baseline and commit."),
    Rule(
        "SC302", "peak-hbm-over-budget", Severity.WARNING,
        "An entry point's recorded per-rank peak of live tensor bytes "
        "exceeds the baseline's memory budget. Lifetimes run from a "
        "tensor's allocation to its last reference (autograd-saved "
        "tensors included), so the peak tracks the caching allocator's; "
        "a jump usually means a batch/width change that will OOM first "
        "on the card."),
    Rule(
        "SC303", "undonated-dead-argument", Severity.WARNING,
        "A large entry-point argument dead after its single use yet "
        "never donated to jit(donate_argnums=...).",
        decision="PyTorch has no buffer donation: an eager step frees a "
                 "dead tensor at its last reference, and a CUDA graph's "
                 "static inputs are owned by the program, so there is no "
                 "undonated argument to find"),
    Rule(
        "SC401", "unlocked-shared-attribute", Severity.WARNING,
        "An instance attribute is written both from a thread entry "
        "(Thread/Timer target, signal handler) and from non-thread code "
        "with no common lock held at either write (lockset approximation "
        "over `with self._lock:` scopes). Writes racing from two threads "
        "tear multi-step updates and publish half-built state; either "
        "share a lock across both writers or confine the attribute to "
        "one side and hand results over via a queue/join."),
    Rule(
        "SC402", "blocking-call-under-lock", Severity.ERROR,
        "A blocking call (Thread.join, Queue.get without timeout, "
        "Event.wait without timeout, a barrier or a torch.distributed "
        "collective) issued while holding a lock. Any other thread that "
        "needs the same lock to make progress — including the one being "
        "joined — deadlocks the process. Release the lock first, or bound "
        "the wait. (Condition.wait inside `with cond:` is exempt: wait "
        "releases the condition's own lock.)"),
    Rule(
        "SC403", "collective-on-worker-thread", Severity.ERROR,
        "A torch.distributed collective or point-to-point call (or one of "
        "the port's wrappers around them), a barrier, or a CUDA dispatch "
        "(a hand-written kernel's launch, CapturedProgram.replay, "
        "torch.cuda.synchronize) is reachable from a non-main thread "
        "entry. Collectives pair up across ranks in launch order; one "
        "issued from a helper thread races the main thread's and "
        "deadlocks or mismatches the pairing. Keep them on the main "
        "thread and hand the result to the worker."),
    Rule(
        "SC404", "hard-exit-under-lock", Severity.ERROR,
        "os._exit reachable from a code path that holds a lock. _exit "
        "skips atexit/finally teardown, so lock-protected state (a "
        "half-written protocol file, an unpublished async save) is "
        "abandoned in whatever state the holder left it; exit from "
        "outside the critical section or use the supervised-exit path."),
    Rule(
        "SC501", "rank-divergent-barrier", Severity.ERROR,
        "A rank-conditional branch (`if dist.get_rank() == 0`, "
        "bootstrap.process_index(), chief checks) where one arm reaches a "
        "barrier or collective the other arm cannot. The rank(s) taking "
        "the barrier-free arm never show up at the rendezvous and every "
        "other rank blocks until timeout. Hoist the barrier out of the "
        "conditional, or make both arms join it."),
    Rule(
        "SC502", "unbounded-blocking-wait", Severity.WARNING,
        "A wait/poll loop whose blocking calls carry no timeout and "
        "whose body has no deadline or abort_check-style escape. If the "
        "peer it waits on dies, the loop spins or blocks forever and "
        "the rank hangs the gang; bound each wait or consult an abort "
        "signal per iteration."),
    Rule(
        "SC503", "torn-protocol-write", Severity.ERROR,
        "A write to a protocol/marker/manifest file not staged through "
        "tmp + os.replace. Readers polling the path can observe a "
        "truncated or half-written payload mid-write; write to a tmp "
        "name in the same directory and os.replace it into place so "
        "publication is atomic."),
    Rule(
        "SC601", "nondet-source-taints-state", Severity.ERROR,
        "A nondeterministic value (wall-clock time.time/datetime.now, "
        "uuid1/uuid4, os.urandom, unseeded stdlib/np.random, torch.seed(), "
        "an unseeded torch.Generator's or the global generator's "
        "initial_seed()) flows — through the transitive assignment/call "
        "taint walk — into RNG seeding (manual_seed, Generator/"
        "default_rng/SeedSequence, seed=), a checkpoint/journal/apply-log "
        "payload, or a protocol-file name used for ordering. One such "
        "value silently converts 'bit-exact replay' into 'usually "
        "replays'. Coordinate-derived seeds (epoch/step/rank) are the "
        "contract; mtime read back inside scan_grads is exempt (arrival "
        "order is the documented PS contract)."),
    Rule(
        "SC602", "rng-key-reuse", Severity.ERROR,
        "One torch generator is seeded (manual_seed) with the same value "
        "at two places of one function, or once inside a loop whose "
        "iterations do not change the value, with draws in between: the "
        "second stream replays the first, so 'independent' draws are "
        "identical. PyTorch generators are stateful — there is no key to "
        "consume twice — so this is the port's counterpart of reusing a "
        "PRNG key. Fold a coordinate into the seed, or seed once."),
    Rule(
        "SC603", "unordered-iteration-feeds-order", Severity.ERROR,
        "A loop over an unordered iterable (os.listdir/glob/scandir/"
        "iterdir, a set) whose body writes durable state, appends to a "
        "sequence that is never sorted, or launches collectives. "
        "Filesystem enumeration order is arbitrary; state derived from "
        "it differs run to run and rank to rank. Wrap the iterable in "
        "sorted(), or prove order-insensitivity (pure set/count/unlink "
        "bodies are not flagged)."),
    Rule(
        "SC604", "fold-constant-collision", Severity.WARNING,
        "Two distinct seed-derivation sites fold an identical constant "
        "into their streams. Derivations sharing a fold constant can "
        "collide (job A's seed arithmetic landing on job B's epoch "
        "stream), correlating 'independent' RNG streams. Give each "
        "derive domain its own constant."),
    Rule(
        "SC605", "float-accumulation-over-unordered", Severity.WARNING,
        "A float reduction (sum()/+= in a loop) over an unordered "
        "iterable inside a checksum/replay/verify/audit path. Float "
        "addition is not associative, so accumulation order changes the "
        "bits — exactly where bit-identity is the contract. Sort the "
        "iterable or use an order-insensitive (integer) accumulator."),
    Rule(
        "SC610", "rng-consumption-regression", Severity.ERROR,
        "A recorded entry point whose committed baseline records ZERO "
        "random aten ops (serve decode/prefill, audit checksums, the PS "
        "server apply — the contractually RNG-free steps) now draws from "
        "a generator. Randomness sneaking into an RNG-free step breaks "
        "replay/token-identity gates. Intended randomness: re-run cost "
        "--update-baseline and commit the diff."),
    Rule(
        "SC901", "stale-suppression", Severity.WARNING,
        "A `# shardcheck: disable=SCnnn` comment that suppresses "
        "nothing: no finding for that rule is raised at that line by "
        "the current pass. Stale suppressions rot into blanket "
        "exemptions as code moves; delete the comment or re-point it "
        "at the line that still needs it. Only rules the running mode "
        "actually evaluates are judged."),
    Rule(
        "SC900", "entry-point-untraceable", Severity.INFO,
        "A registered entry point could not be recorded in this "
        "environment; its collective checks were skipped."),
)}


@dataclasses.dataclass(frozen=True)
class Finding:
    rule_id: str
    path: str
    line: int
    col: int
    message: str

    @property
    def rule(self) -> Rule:
        return RULES[self.rule_id]

    @property
    def severity(self) -> Severity:
        return self.rule.severity

    def to_json(self) -> dict:
        return {
            "rule_id": self.rule_id,
            "name": self.rule.name,
            "severity": str(self.severity),
            "path": self.path,
            "line": self.line,
            "col": self.col,
            "message": self.message,
        }

    def render(self) -> str:
        return (f"{self.path}:{self.line}:{self.col}: "
                f"[{self.rule_id} {self.severity}] {self.message}")


#: ``# shardcheck: disable=SC101`` or ``disable=SC101,SC103`` or
#: ``disable=all``; anything after the rule list (a justification) is free
#: text. Matches anywhere in the physical line so it can trail code.
_SUPPRESS_RE = re.compile(
    r"#\s*shardcheck:\s*disable=([A-Za-z0-9_,\s]+?)(?:\s+--?\s|$|#)")


def suppressions_for_line(source_line: str) -> Optional[set]:
    """Rule IDs suppressed on this physical line, or None when no
    suppression comment is present. ``{"all"}`` suppresses every rule."""
    m = _SUPPRESS_RE.search(source_line)
    if not m:
        return None
    ids = {part.strip() for part in m.group(1).split(",") if part.strip()}
    return {i if i.lower() != "all" else "all" for i in ids}


def apply_suppressions(findings, source_by_path) -> list:
    """Drop findings whose source line carries a matching suppression.

    ``source_by_path`` maps path -> list of source lines (1-indexed via
    ``line - 1``). Findings for paths not in the map pass through.
    """
    kept = []
    for f in findings:
        lines = source_by_path.get(f.path)
        if lines is not None and 1 <= f.line <= len(lines):
            sup = suppressions_for_line(lines[f.line - 1])
            if sup is not None and ("all" in sup or f.rule_id in sup):
                continue
        kept.append(f)
    return kept


def stale_suppressions(pre_findings, source_by_path, evaluated) -> list:
    """SC901: suppression comments that suppress nothing.

    ``pre_findings`` must be the findings *before* apply_suppressions,
    so a live suppression (one that is eating a real finding) can be
    told apart from a stale one. Only rule IDs in ``evaluated`` — the
    rules the current mode actually ran — are judged; a comment naming
    a rule from another family is left alone (its finding may exist in
    the other mode), and ``disable=all`` is never judged for the same
    reason.
    """
    fired: dict = {}
    for f in pre_findings:
        fired.setdefault((f.path, f.line), set()).add(f.rule_id)
    evaluated = set(evaluated)
    out = []
    for path in sorted(source_by_path):
        for i, line in enumerate(source_by_path[path], 1):
            sup = suppressions_for_line(line)
            if not sup or "all" in sup:
                continue
            live = fired.get((path, i), set())
            for rule_id in sorted(sup & (evaluated - live)):
                out.append(Finding(
                    "SC901", path, i, 0,
                    f"suppression for {rule_id} matches no {rule_id} "
                    f"finding at this line; delete the comment or "
                    f"re-point it at the code that still needs it"))
    return out
