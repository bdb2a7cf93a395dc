"""Peer liveness on the process group's store.

Counterpart of ``tpu_dist/cluster/liveness.py``. The reference's
failure detection (TF's ``check_collective_ops_peer_health``: every peer
probed every 30 s, 3 retries x 10 s) turns an unreachable peer into an
error that restarts the job; the JAX package reads the coordination
service's ``get_live_nodes``. ``torch.distributed`` has no such call, so
the port keeps heartbeats in the store that ``init_process_group`` brings
up (the ``TCPStore`` rank 0 hosts, ``bootstrap.initialize``):

* each process's heartbeat thread writes its wall-clock time under
  ``tpu_dist/liveness/<rank>`` every quarter of the probe timeout;
* :func:`check_peer_health` reads every peer's stamp: a peer whose stamp
  is older than the timeout is dead (a peer that has not stamped yet is
  not). Each read runs on one persistent prober thread with a deadline
  (:class:`_Prober`), retried ``retries`` times; a store that does not
  answer (rank 0, its host, gone) raises :class:`PeerUnavailableError`;
* :class:`LivenessMonitor` probes every ``interval_s`` on a thread; a dead
  peer fails it, and :meth:`LivenessMonitor.raise_if_failed` (the fit
  loop calls it at each epoch's start) raises
  :class:`PeerUnavailableError`, which a supervised worker turns into
  ``EXIT_PEER_UNAVAILABLE``.

Stamps are wall-clock seconds, so the hosts' clocks must agree to well
within the timeout (one host always does). Knobs, the JAX package's:
``TPU_DIST_HEALTH_INTERVAL`` (default 30 s) and ``TPU_DIST_HEALTH_TIMEOUT``
(10 s). The threads are daemons, one of each per process
(:func:`shared_monitor`); they stop with :meth:`LivenessMonitor.stop`,
which ``bootstrap``'s shutdown calls before it destroys the process group,
and they end by themselves once the group they were started on is gone.
``MultiWorkerMirroredStrategy`` starts the shared monitor after its
startup barrier, where the reference starts its health checks;
``bootstrap.reinitialize`` stops it before a reform and restarts it on the
new group. ``rejoin_window_s > 0`` is the reference's rejoin window
(:class:`LivenessMonitor`).
"""

from __future__ import annotations

import logging
import os
import queue
import threading
import time
from typing import Optional, Sequence

import torch.distributed as dist

logger = logging.getLogger("tpu_dist_torch.liveness")

#: Reference knobs (tf:...collective_all_reduce_strategy.py:337-349):
#: check every 30 s, 10 s per-probe timeout.
DEFAULT_INTERVAL_S = float(os.environ.get("TPU_DIST_HEALTH_INTERVAL", "30"))
DEFAULT_TIMEOUT_S = float(os.environ.get("TPU_DIST_HEALTH_TIMEOUT", "10"))

_KEY = "tpu_dist/liveness/{}"


class PeerUnavailableError(RuntimeError):
    """A peer process is unreachable; the job must be restarted (TF's
    ``UnavailableError`` from its health-check thread)."""


class _Prober:
    """One long-lived daemon thread that runs probes with a deadline.

    A store read has no deadline of its own, so a store that accepts the
    connection and never answers can hang a probe. A probe that times out
    mid-call marks its worker wedged, and the next probe starts a fresh
    worker (a fresh read), at most ``MAX_WEDGED_WORKERS`` times a process,
    after which probes fail at once."""

    MAX_WEDGED_WORKERS = 4

    def __init__(self):
        self._submit_lock = threading.Lock()
        self._requests: "queue.Queue" = queue.Queue()
        self._cv = threading.Condition()
        self._results: dict = {}
        self._abandoned: set = set()
        self._seq = 0
        self._thread: Optional[threading.Thread] = None
        self._in_flight: Optional[int] = None
        self._wedged_count = 0
        self._gen = 0  # worker generation; a replaced worker stops counting

    def _run(self, requests, gen: int) -> None:
        while True:  # shardcheck: disable=SC502 -- idle state of a daemon worker; probe() callers carry the timeout
            seq, fn = requests.get()
            with self._cv:
                if seq in self._abandoned:
                    self._abandoned.discard(seq)
                    continue
                if self._gen == gen:
                    self._in_flight = seq
            try:
                out = fn()
            except Exception as e:  # handed to the caller as the result
                out = e
            with self._cv:
                if self._gen == gen:
                    self._in_flight = None
                if seq in self._abandoned:
                    self._abandoned.discard(seq)
                else:
                    self._results[seq] = out
                    self._cv.notify_all()

    def probe(self, fn, timeout_s: float):
        """``fn()`` on the worker: its result or exception, or a
        ``TimeoutError`` when it does not answer within ``timeout_s``."""
        with self._submit_lock:
            with self._cv:
                wedged = (self._in_flight is not None
                          and self._in_flight in self._abandoned)
            if wedged:
                if self._wedged_count >= self.MAX_WEDGED_WORKERS:
                    return TimeoutError(
                        f"store unresponsive: {self._wedged_count} probe "
                        "workers wedged; not spawning more")
                self._wedged_count += 1
                self._thread = None
                self._requests = queue.Queue()
                with self._cv:
                    self._gen += 1
                    self._in_flight = None
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._run, args=(self._requests, self._gen),
                    daemon=True, name="tpu_dist_torch_probe")
                self._thread.start()
            self._seq += 1
            seq = self._seq
            requests = self._requests
        requests.put((seq, fn))
        deadline = time.monotonic() + timeout_s
        with self._cv:
            while seq not in self._results:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    self._abandoned.add(seq)
                    return TimeoutError(
                        f"probe did not answer within {timeout_s}s")
                self._cv.wait(remaining)
            return self._results.pop(seq)


_prober = _Prober()


def _store():
    """The default process group's store, or None without a group."""
    if not (dist.is_available() and dist.is_initialized()):
        return None
    from torch.distributed import distributed_c10d

    return distributed_c10d._get_default_store()


def _read_stamps(store, ranks: Sequence[int]) -> dict:
    """``{rank: stamp}`` of the ranks that have stamped."""
    out = {}
    for r in ranks:
        key = _KEY.format(r)
        if store.check([key]):
            out[r] = float(store.get(key).decode())
    return out


def check_peer_health(timeout_s: float = DEFAULT_TIMEOUT_S,
                      retries: int = 3) -> Sequence[int]:
    """Probe peer liveness; returns the dead process ids (module
    docstring). A failed read is retried ``retries`` times, each with the
    full ``timeout_s`` on the persistent prober thread (the reference's 3 x
    10 s rule); when every attempt fails the store itself is unreachable
    and this raises :class:`PeerUnavailableError`. One process reports no
    dead peers."""
    store = _store()
    if store is None or dist.get_world_size() <= 1:
        return []
    n, me = dist.get_world_size(), dist.get_rank()
    peers = [r for r in range(n) if r != me]
    last_error: object = None
    retries = max(retries, 1)
    for attempt in range(retries):
        out = _prober.probe(lambda: _read_stamps(store, peers), timeout_s)
        if not isinstance(out, Exception):
            now = time.time()
            return sorted(r for r, t in out.items() if now - t > timeout_s)
        last_error = out
        logger.warning("liveness probe attempt %d/%d failed: %s",
                       attempt + 1, retries, last_error)
        if attempt + 1 < retries:
            time.sleep(min(1.0, timeout_s / 10))
    raise PeerUnavailableError(
        f"process group store unreachable after {retries} probe attempts: "
        f"{last_error}. Restart the job.")


class LivenessMonitor:
    """The background peer-health check: this process's heartbeat thread
    and a probe every ``interval_s``; a dead peer (or an unreachable
    store) fails the monitor for good, and :meth:`raise_if_failed`
    surfaces it.

    With ``rejoin_window_s > 0`` (the JAX package's elastic extension) a
    dead peer is first a suspect until ``rejoin_window_s`` after it was
    detected: one that answers again inside its window recovers
    (``peer_rejoined``), one still dead past it fails the monitor
    (``peer_rejoin_expired``); each suspect has its own deadline. A new
    suspect's ``detect_s`` (``elastic.detect_s``, the ``peer_suspect``
    event) is measured from the last round it answered in, else from the
    last healthy round."""

    def __init__(self, interval_s: float = DEFAULT_INTERVAL_S,
                 timeout_s: float = DEFAULT_TIMEOUT_S,
                 rejoin_window_s: float = 0.0):
        self.interval_s = interval_s
        self.timeout_s = timeout_s
        self.rejoin_window_s = float(rejoin_window_s)
        self._stop = threading.Event()
        self._threads: list = []
        self._dead_peers: Sequence[int] = []
        self._failed = threading.Event()
        #: peer -> monotonic deadline by which it must answer again.
        self._suspects: dict = {}
        #: peer -> monotonic time it last answered (``detect_s``'s base).
        self._last_seen: dict = {}
        #: Detection latency of the newest suspect, seconds.
        self.last_detect_s: Optional[float] = None
        #: Monotonic time of the previous round: the base of a peer never
        #: seen on its own.
        self._prev_round_t: Optional[float] = None
        #: Guards the verdict state, which the probe thread writes and
        #: ``reset`` (a reform, on the main thread) clears.
        self._lock = threading.Lock()
        #: Bumped by ``reset``: a probe round that began before a reset
        #: probed the old group, and its verdict is dropped.
        self._resets = 0

    def start(self) -> "LivenessMonitor":
        """Start the heartbeat and probe threads (no-op for one process,
        when running, or once failed)."""
        store = _store()
        if store is None or dist.get_world_size() <= 1:
            return self
        if any(t.is_alive() for t in self._threads) or self.failed:
            return self
        self._stop.clear()
        world = dist.group.WORLD
        key = _KEY.format(dist.get_rank())
        self._beat(store, key)  # stamped before any peer can probe it
        self._threads = [
            threading.Thread(target=self._heartbeat, args=(store, key, world),
                             name="tpu_dist_torch_heartbeat", daemon=True),
            threading.Thread(target=self._loop, args=(world,),
                             name="tpu_dist_torch_health", daemon=True)]
        for t in self._threads:
            t.start()
        logger.info("liveness monitor started (interval=%.1fs, "
                    "timeout=%.1fs)", self.interval_s, self.timeout_s)
        return self

    def stop(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=self.timeout_s)
            if t.is_alive():
                logger.warning("liveness thread %s did not stop within "
                               "%.1fs; leaving it to finish", t.name,
                               self.timeout_s)
        self._threads = [t for t in self._threads if t.is_alive()]

    @staticmethod
    def _beat(store, key: str) -> None:
        store.set(key, repr(time.time()))

    @staticmethod
    def _group_gone(world) -> bool:
        return not dist.is_initialized() or dist.group.WORLD is not world

    def _heartbeat(self, store, key: str, world) -> None:
        period = max(0.05, self.timeout_s / 4)
        while not self._stop.wait(period):
            if self._group_gone(world):
                return
            try:
                self._beat(store, key)
            except Exception:  # noqa: BLE001 - the store is gone: peers see us stale
                logger.debug("heartbeat write failed", exc_info=True)

    def _loop(self, world) -> None:
        while not self._stop.wait(self.interval_s):
            if self._group_gone(world):
                return
            with self._lock:
                round_resets = self._resets
            try:
                dead = check_peer_health(self.timeout_s)
            except PeerUnavailableError:
                # The store is unreachable even after the retries: every
                # peer is suspect; raise_if_failed surfaces it.
                me, n = dist.get_rank(world), dist.get_world_size(world)
                dead = [i for i in range(n) if i != me]
            if self._observe(dead, round_resets=round_resets):
                return

    def _observe(self, dead: Sequence[int], now: Optional[float] = None,
                 round_resets: Optional[int] = None) -> bool:
        """Fold one probe's dead peers in; True once failed (terminal:
        a late answer clears nothing). ``now`` is for tests. A round that
        began before the latest ``reset`` (``round_resets`` behind) probed
        the group a reform replaced: its verdict is dropped."""
        from tpu_dist_torch.resilience import events

        now = time.monotonic() if now is None else now
        with self._lock:
            if round_resets is not None and round_resets != self._resets:
                return False
            if self._failed.is_set():
                return True
            dead_set = set(dead)
            if self.rejoin_window_s <= 0 and dead_set:
                self._dead_peers = sorted(dead_set)
                self._failed.set()
                logger.error(
                    "peer process(es) %s unreachable; collectives will not "
                    "complete — restart the job", self._dead_peers)
                return True
            for peer in dead_set - set(self._suspects):
                base = self._last_seen.get(peer, self._prev_round_t)
                detect_s = None if base is None else max(0.0, now - base)
                self.last_detect_s = detect_s
                if detect_s is not None:
                    from tpu_dist_torch.observe import metrics as metrics_lib

                    metrics_lib.observe_value("elastic.detect_s", detect_s)
                self._suspects[peer] = now + self.rejoin_window_s
                logger.warning("peer %d unreachable; suspect for %.0fs "
                               "pending rejoin", peer, self.rejoin_window_s)
                events.maybe_log(
                    "peer_suspect", peer=peer,
                    rejoin_window_s=self.rejoin_window_s,
                    detect_s=(None if detect_s is None
                              else round(detect_s, 6)))
            for peer in sorted(set(self._suspects) - dead_set):
                del self._suspects[peer]
                self._last_seen[peer] = now
                logger.info("peer %d answered again; rejoin complete", peer)
                events.maybe_log("peer_rejoined", peer=peer)
            expired = sorted(p for p, t in self._suspects.items() if now > t)
            if expired:
                self._dead_peers = expired
                self._failed.set()
                logger.error("peer process(es) %s did not rejoin within "
                             "%.0fs; restart the job", expired,
                             self.rejoin_window_s)
                events.maybe_log("peer_rejoin_expired", peers=expired)
                return True
            self._prev_round_t = now
            return False

    @property
    def suspect_peers(self) -> Sequence[int]:
        """Peers inside their rejoin window (not yet condemned)."""
        return sorted(self._suspects)

    def reset(self) -> None:
        """Forget every verdict (a reformed group starts healthy); a probe
        round still running against the old group is dropped when it
        ends."""
        with self._lock:
            self._resets += 1
            self._failed.clear()
            self._dead_peers = []
            self._suspects.clear()
            self._last_seen.clear()
            self._prev_round_t = None

    @property
    def failed(self) -> bool:
        return self._failed.is_set()

    @property
    def dead_peers(self) -> Sequence[int]:
        return list(self._dead_peers)

    def raise_if_failed(self) -> None:
        if self.failed:
            raise PeerUnavailableError(
                f"peer process(es) {list(self._dead_peers)} are unreachable; "
                "synchronous training cannot continue. Restart the job "
                "(resume from the latest checkpoint if one was written).")


_shared_monitor: Optional[LivenessMonitor] = None
_shared_lock = threading.Lock()


def shared_monitor() -> LivenessMonitor:
    """The per-process monitor: repeated strategy constructions reuse one
    pair of threads."""
    global _shared_monitor
    with _shared_lock:
        if _shared_monitor is None:
            _shared_monitor = LivenessMonitor()
        return _shared_monitor


def stop_shared() -> bool:
    """Stop the shared monitor's threads, if any (before the process group
    is destroyed); True when they were running."""
    with _shared_lock:
        monitor = _shared_monitor
    if monitor is None:
        return False
    ran = any(t.is_alive() for t in monitor._threads)
    monitor.stop()
    return ran


def restart_shared() -> None:
    """Start the shared monitor afresh on the current process group (after
    ``bootstrap.reinitialize``): verdicts on the old group are dropped."""
    monitor = shared_monitor()
    monitor.reset()
    monitor.start()
