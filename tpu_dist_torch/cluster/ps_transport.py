"""Host-side parameter-server transport: an atomic file protocol, no sockets.

Counterpart of ``tpu_dist/cluster/ps_transport.py``, byte for byte on disk:
the same directory layout, file names, JSON fields and ``npz`` keys, so a
process of either package can read a session directory the other wrote.
The PS execution model (``parallel/ps_strategy.py``) needs three wire
primitives between one server process and N worker processes on a shared
filesystem:

* the server **publishes** a versioned parameter snapshot workers can read
  at any moment without tearing;
* each worker **pushes** gradient packets the server discovers and applies
  in arrival order;
* both sides exchange small **control** facts (per-rank applied counts for
  the staleness gate, heartbeats, a STOP marker, DONE markers).

All three use the durability idiom of ``cluster/bootstrap.py`` and
``training/checkpoint.py``: write to a pid-suffixed temp name in the same
directory, then ``os.replace``, so readers see the old complete file or
the new one, never a torn one. JSON carries control facts
(``bootstrap._atomic_write_json`` / ``_read_json``); ``npz`` carries
arrays, each keyed by the ``jax.tree_util.keystr`` spelling of its tree
path (``models/bridge.keypath``), with a packet's metadata inside its npz
(one file per push: a sidecar json could land before or after its arrays).

Numpy and the standard library only: the server loop, a worker's hot loop,
the tests and the chaos runner import it alike. No threads; one writer per
file class (the server for params and control, rank r for its own grads
and marks).
"""

from __future__ import annotations

import json
import os
import pathlib
import time
from typing import Optional

import numpy as np

from tpu_dist_torch.cluster.bootstrap import _atomic_write_json, _read_json

#: Environment knobs (the chaos runner launches one argv for every role and
#: tells them apart through these, as the entry points do).
PS_DIR_ENV = "TPU_DIST_PS_DIR"
PS_ROLE_ENV = "TPU_DIST_PS_ROLE"            # "server" | "worker"
PS_RANK_ENV = "TPU_DIST_PS_RANK"            # worker rank (server has none)
PS_WORLD_ENV = "TPU_DIST_PS_WORLD"          # number of worker ranks
PS_STALENESS_ENV = "TPU_DIST_PS_STALENESS"  # bounded-staleness window
PS_SYNC_ENV = "TPU_DIST_PS_SYNC"            # "1" = gang-synchronous control
PS_PULL_TIMEOUT_ENV = "TPU_DIST_PS_PULL_TIMEOUT"  # worker pull deadline (s)

#: Default bounded-staleness window: a worker may have at most this many of
#: its own pushes still unapplied when it pulls. Small by design — the
#: convergence contract is *bounded* staleness, not eventual consistency.
DEFAULT_STALENESS = 4

_META_KEY = "__ps_meta__"
_MANIFEST = "PUBLISHED.json"
_STOP = "STOP.json"


def _atomic_write_npz(path: pathlib.Path, arrays: dict) -> None:
    tmp = path.parent / f".{path.name}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _load_npz(path: pathlib.Path) -> Optional[dict]:
    """All arrays of ``path``, or None when the file is gone/unreadable —
    publishes are atomic, so unreadable means racing a GC unlink, and the
    caller re-resolves from the manifest."""
    import zipfile

    try:
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    except (OSError, ValueError, zipfile.BadZipFile):
        return None


class PSDir:
    """One PS session's on-disk layout under ``root``::

        params/params-<version>.npz     server-published snapshots
        params/PUBLISHED.json           manifest: version, file, applied
                                        counts per rank, leaf checksums
        grads/g-r<rank>-<seq>.npz       worker-pushed gradient packets
        control/hb-rank<r>.json         worker heartbeats (one per step)
        control/done-rank<r>.json       worker completion marks
        control/STOP.json               server's budget-reached stop order
        apply_log.jsonl                 server's apply-order log
    """

    def __init__(self, root):
        self.root = pathlib.Path(root)
        self.params = self.root / "params"
        self.grads = self.root / "grads"
        self.control = self.root / "control"
        self.apply_log = self.root / "apply_log.jsonl"

    def ensure(self) -> "PSDir":
        for d in (self.params, self.grads, self.control):
            d.mkdir(parents=True, exist_ok=True)
        return self

    # -- server: publish / discover -----------------------------------------

    def publish_params(self, arrays: dict, *, version: int,
                       applied: dict, checksums: dict,
                       extra: Optional[dict] = None) -> None:
        """Publish snapshot ``version``: arrays first, then the manifest
        that names them — a reader following the manifest always finds a
        complete npz. Keeps the last two snapshots so a reader holding the
        previous manifest never loses a race with GC."""
        fname = f"params-{int(version)}.npz"
        _atomic_write_npz(self.params / fname, arrays)
        manifest = {
            "version": int(version),
            "file": fname,
            "applied": {str(r): int(n) for r, n in applied.items()},
            "checksums": {k: int(v) for k, v in checksums.items()},
            "time": time.time(),
        }
        if extra:
            manifest.update(extra)
        _atomic_write_json(self.params / _MANIFEST, manifest)
        for old in self.params.glob("params-*.npz"):
            try:
                v = int(old.stem.split("-", 1)[1])
            except ValueError:
                continue
            if v < version - 1:
                try:
                    old.unlink()
                except OSError:
                    pass

    def read_manifest(self) -> Optional[dict]:
        return _read_json(self.params / _MANIFEST)

    def load_published(self) -> Optional[tuple]:
        """(manifest, arrays) of the newest readable snapshot, or None
        before the first publish. Re-resolves once if the npz was GC'd
        between manifest read and array read."""
        for _ in range(2):
            manifest = self.read_manifest()
            if manifest is None:
                return None
            arrays = _load_npz(self.params / manifest["file"])
            if arrays is not None:
                return manifest, arrays
        return None

    # -- worker: push / heartbeat / done -------------------------------------

    def push_grad(self, arrays: dict, *, rank: int, seq: int,
                  meta: dict) -> pathlib.Path:
        """One gradient packet; ``meta`` (rank, worker seq, base version,
        loss) rides inside the npz so packet and provenance are one atomic
        unit."""
        payload = dict(arrays)
        payload[_META_KEY] = np.frombuffer(
            json.dumps({"rank": int(rank), "seq": int(seq), **meta}).encode(
                "utf-8"), dtype=np.uint8).copy()
        path = self.grads / f"g-r{int(rank)}-{int(seq):08d}.npz"
        _atomic_write_npz(path, payload)
        return path

    def heartbeat(self, rank: int, *, step: int) -> None:
        _atomic_write_json(self.control / f"hb-rank{int(rank)}.json",
                           {"step": int(step), "time": time.time()})

    def mark_done(self, rank: int, *, steps: int) -> None:
        _atomic_write_json(self.control / f"done-rank{int(rank)}.json",
                           {"steps": int(steps), "time": time.time()})

    def done_ranks(self) -> set:
        out = set()
        for p in self.control.glob("done-rank*.json"):
            try:
                out.add(int(p.stem[len("done-rank"):]))
            except ValueError:
                continue
        return out

    def heartbeat_age_s(self, rank: int) -> Optional[float]:
        rec = _read_json(self.control / f"hb-rank{int(rank)}.json")
        if rec is None:
            return None
        return max(0.0, time.time() - float(rec.get("time", 0.0)))

    # -- server: gradient discovery ------------------------------------------

    def scan_grads(self, *, seen: set) -> list:
        """Unconsumed packet paths in arrival order. ``os.replace`` stamps
        the destination mtime at publish, so (mtime, name) is the honest
        arrival order; the name breaks exact ties deterministically."""
        entries = []
        try:
            with os.scandir(self.grads) as it:
                for e in it:
                    if (e.name.startswith("g-r") and e.name.endswith(".npz")
                            and e.name not in seen):
                        try:
                            entries.append((e.stat().st_mtime_ns, e.name))
                        except OSError:
                            continue
        except OSError:
            return []
        entries.sort()
        return [self.grads / name for _, name in entries]

    @staticmethod
    def load_grad(path: pathlib.Path) -> Optional[tuple]:
        """(meta, arrays) of one packet, or None when unreadable."""
        arrays = _load_npz(path)
        if arrays is None or _META_KEY not in arrays:
            return None
        meta = json.loads(bytes(arrays.pop(_META_KEY)).decode("utf-8"))
        return meta, arrays

    # -- control --------------------------------------------------------------

    def write_stop(self, *, reason: str, applies: int) -> None:
        _atomic_write_json(self.control / _STOP,
                           {"reason": reason, "applies": int(applies),
                            "time": time.time()})

    def stop_requested(self) -> Optional[dict]:
        return _read_json(self.control / _STOP)

    # -- apply-order log -------------------------------------------------------

    def append_apply_log(self, record: dict) -> None:
        """Single-writer (the server) append; one fsync'd line per apply so
        the log survives the same crashes the checkpoints do."""
        with open(self.apply_log, "a", encoding="utf-8") as f:
            f.write(json.dumps(record) + "\n")
            f.flush()
            os.fsync(f.fileno())

    def read_apply_log(self) -> list:
        try:
            text = self.apply_log.read_text(encoding="utf-8")
        except OSError:
            return []
        out = []
        for line in text.splitlines():
            try:
                out.append(json.loads(line))
            except ValueError:
                continue  # torn trailing line after a crash
        return out

    def rewrite_apply_log(self, records: list) -> None:
        """Truncate the log to ``records`` (server restart: entries past
        the restored checkpoint describe applies the restore rewound)."""
        tmp = self.root / f".apply_log.{os.getpid()}.tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            for rec in records:
                f.write(json.dumps(rec) + "\n")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.apply_log)


# -- env resolution ------------------------------------------------------------

def staleness_from_env() -> int:
    try:
        return max(0, int(os.environ.get(PS_STALENESS_ENV,
                                         DEFAULT_STALENESS)))
    except ValueError:
        return DEFAULT_STALENESS


def role_from_env() -> Optional[str]:
    role = os.environ.get(PS_ROLE_ENV, "").strip().lower()
    return role if role in ("server", "worker") else None


def rank_from_env() -> int:
    for var in (PS_RANK_ENV, "TPU_DIST_REJOIN_RANK"):
        val = os.environ.get(var)
        if val is not None:
            try:
                return int(val)
            except ValueError:
                continue
    return 0


def world_from_env() -> int:
    try:
        return max(1, int(os.environ.get(PS_WORLD_ENV, "1")))
    except ValueError:
        return 1


def sync_from_env() -> bool:
    return os.environ.get(PS_SYNC_ENV, "") == "1"


def pull_timeout_from_env() -> float:
    try:
        return max(1.0, float(os.environ.get(PS_PULL_TIMEOUT_ENV, "300")))
    except ValueError:
        return 300.0
