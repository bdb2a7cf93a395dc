"""Host-side page management for the paged KV cache.

The port's own copy of ``tpu_dist/serve/paging.py`` (the port imports
nothing of ``tpu_dist``), unchanged in behaviour and in error text;
``tests/test_torch_paging.py`` drives both with one random sequence of
operations. ``kv_cache.init_page_pool`` carves device memory into
fixed-size pages; this module owns everything about which page holds
what:

* :class:`PageAllocator` — the free list, per-page refcounts, and the
  per-slot page table ``[slots, max_pages]`` of pool indices (scratch-
  filled for unallocated entries). Reclaim is compaction-free: finishing
  a request just drops its refcounts, and any page that hits zero goes
  straight back on the free list — no copying, no defragmentation.
  Exhaustion raises a loud :class:`PageExhaustedError` naming the exact
  accounting instead of letting a device scatter corrupt another
  request's pages. A *reservation* ledger makes admission deadlock-free:
  a request is only admitted once ``ceil(total_tokens / page_size)``
  pages are set aside for its worst case (zero sharing), so every later
  incremental allocation — decode appends, copy-on-write clones — is
  guaranteed to succeed.
* :class:`PrefixCache` — chain-hashes page-aligned prompt chunks
  (blake2b over parent digest + chunk tokens) and maps them to
  refcounted read-only pages, so a repeated system prompt resolves to
  already-computed K/V and prefill runs only over the suffix. Partial
  tail chunks are cached too (registered when a request finishes, keyed
  under the parent full-page digest), and a write into any shared page
  triggers copy-on-write: the allocator hands out a private clone and
  the device runs one ``kv_cache.copy_page``. Eviction is
  leaf-first LRU and only ever drops the *cache's* reference — pages
  still used by active requests stay resident until those finish.
* :class:`PagedKVState` — the engine-facing facade tying both together:
  admission headroom checks, prefix lookup + page-table construction at
  prefill, tail-page writability for decode appends, registration +
  release at finish, and the pointer-swap that replaces the contiguous
  engine's device-side ``swap_slots``.

The invariant everything hangs on: **a page is writable by a slot iff
its refcount is exactly 1** (the slot's own reference). The prefix cache
holds its own +1 on every page it indexes, so cached pages are read-only
by construction and sharing can never alias a write.

Device state never leaves this module's hands as anything but *indices*:
a page table can be rebuilt from prompt tokens alone, so no page state
needs to be persisted.
"""

from __future__ import annotations

import dataclasses
import hashlib
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np

from tpu_dist_torch.observe import metrics

__all__ = [
    "PageAllocator",
    "PageExhaustedError",
    "PagedKVState",
    "PrefixCache",
    "PrefillSetup",
]

#: Chain-hash root for the empty prefix.
_ROOT = b"tpu_dist.serve.prefix-root"


class PageExhaustedError(RuntimeError):
    """The pool has no page to give — raised loudly instead of letting a
    scatter land on a page another request owns."""


def _digest(parent: bytes, chunk: Tuple[int, ...]) -> bytes:
    h = hashlib.blake2b(parent, digest_size=16)
    h.update(np.asarray(chunk, np.int64).tobytes())
    return h.digest()


class PageAllocator:
    """Free list + refcounts + per-slot page tables over a fixed pool.

    Page index ``num_pages`` is the device pool's scratch row: it never
    enters the free list, unallocated table entries point at it, and
    kernels route invalid-position writes to it.
    """

    def __init__(self, *, num_pages: int, page_size: int, slots: int,
                 max_pages: int) -> None:
        if num_pages < 1:
            raise ValueError(f"num_pages must be >= 1, got {num_pages}")
        self.num_pages = num_pages
        self.page_size = page_size
        self.slots = slots
        self.max_pages = max_pages
        self.scratch = num_pages
        self._free: deque = deque(range(num_pages))
        self.refcount = np.zeros(num_pages, np.int64)
        #: int32 [slots, max_pages]; position-ordered page indices.
        self.table = np.full((slots, max_pages), self.scratch, np.int32)
        #: allocated (position-ordered) entries per slot.
        self.count = np.zeros(slots, np.int64)
        #: outstanding worst-case future allocations per slot.
        self.reserved = np.zeros(slots, np.int64)
        #: reservations made at admission, not yet bound to a slot.
        self.pending_reserved = 0

    # -- accounting -----------------------------------------------------------

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        return self.num_pages - len(self._free)

    def headroom(self) -> int:
        """Pages available beyond every outstanding reservation."""
        return (len(self._free) - int(self.reserved.sum())
                - self.pending_reserved)

    def pages_needed(self, total_tokens: int) -> int:
        return -(-total_tokens // self.page_size)

    def _exhausted(self, what: str) -> PageExhaustedError:
        return PageExhaustedError(
            f"serve: page pool exhausted while {what} — "
            f"{self.pages_in_use}/{self.num_pages} pages in use, "
            f"{self.free_pages} free, "
            f"{int(self.reserved.sum()) + self.pending_reserved} reserved "
            "for admitted requests. Raise num_pages/budget_bytes, lower "
            "max_new_tokens, or let active requests drain.")

    # -- reservation (admission) ----------------------------------------------

    def reserve_pending(self, n: int) -> None:
        """Set aside ``n`` pages for a request admitted this round but
        not yet bound to a slot."""
        if n > self.headroom():
            raise self._exhausted(f"reserving {n} page(s) at admission")
        self.pending_reserved += n

    def bind_reservation(self, slot: int, n: int) -> None:
        """Move an admission reservation onto the slot that got it."""
        self.pending_reserved -= min(n, self.pending_reserved)
        self.reserved[slot] += n

    # -- page lifecycle -------------------------------------------------------

    def alloc(self, slot: int) -> int:
        """Append one fresh private page to ``slot``'s table. Draws from
        the slot's reservation, which guarantees the free list is
        non-empty for every covered allocation."""
        if not self._free:
            raise self._exhausted(f"allocating a page for slot {slot}")
        if self.count[slot] >= self.max_pages:
            raise PageExhaustedError(
                f"serve: slot {slot} already holds max_pages="
                f"{self.max_pages} pages — the request outgrew "
                "max_len // page_size, which submit() should have caught")
        pg = self._free.popleft()
        self.refcount[pg] = 1
        self.table[slot, self.count[slot]] = pg
        self.count[slot] += 1
        self.reserved[slot] = max(self.reserved[slot] - 1, 0)
        return pg

    def attach(self, slot: int, pages: List[int], *,
               full: bool = True) -> None:
        """Append shared (prefix-cache) pages to ``slot``'s table,
        bumping refcounts. ``full`` pages retire one unit of the slot's
        reservation each — they will never need a private replacement;
        a partial page keeps its unit, which the follow-up copy-on-write
        clone consumes."""
        for pg in pages:
            if self.count[slot] >= self.max_pages:
                raise PageExhaustedError(
                    f"serve: slot {slot} page table overflow attaching "
                    "shared pages")
            self.refcount[pg] += 1
            self.table[slot, self.count[slot]] = pg
            self.count[slot] += 1
            if full:
                self.reserved[slot] = max(self.reserved[slot] - 1, 0)

    def retain(self, pg: int) -> None:
        """Add an owner (the prefix cache) to an allocated page."""
        self.refcount[pg] += 1

    def release_page(self, pg: int) -> None:
        self.refcount[pg] -= 1
        if self.refcount[pg] < 0:
            raise AssertionError(f"page {pg} refcount went negative")
        if self.refcount[pg] == 0:
            self._free.append(pg)

    def writable(self, pg: int) -> bool:
        """A slot may write a page iff it is the sole owner."""
        return pg != self.scratch and self.refcount[pg] == 1

    def cow(self, slot: int, idx: int) -> Tuple[int, int]:
        """Clone table entry ``idx`` (a shared page) into a private page
        and repoint the slot at it. Returns ``(src, dst)`` for the
        device-side ``copy_page`` the caller must run before writing."""
        src = int(self.table[slot, idx])
        if not self._free:
            raise self._exhausted(
                f"copy-on-write for slot {slot} page {idx}")
        dst = self._free.popleft()
        self.refcount[dst] = 1
        self.table[slot, idx] = dst
        self.reserved[slot] = max(self.reserved[slot] - 1, 0)
        self.release_page(src)
        return src, dst

    def release_slot(self, slot: int) -> None:
        """Compaction-free reclaim: drop the slot's references (pages the
        prefix cache still indexes stay resident) and return any unused
        reservation."""
        for i in range(int(self.count[slot])):
            self.release_page(int(self.table[slot, i]))
        self.table[slot, :] = self.scratch
        self.count[slot] = 0
        self.reserved[slot] = 0

    def swap_slots(self, i: int, j: int) -> None:
        """The paged analogue of the contiguous engine's device-side
        ``swap_slots``: a host pointer swap."""
        self.table[[i, j]] = self.table[[j, i]]
        self.count[[i, j]] = self.count[[j, i]]
        self.reserved[[i, j]] = self.reserved[[j, i]]

    def check(self) -> None:
        """Internal-consistency audit (tests): every table reference is
        counted, every free page has refcount 0."""
        refs = np.zeros(self.num_pages, np.int64)
        for s in range(self.slots):
            for i in range(int(self.count[s])):
                pg = int(self.table[s, i])
                assert pg != self.scratch, (s, i)
                refs[pg] += 1
        assert np.all(self.refcount >= refs), (self.refcount, refs)
        for pg in self._free:
            assert self.refcount[pg] == 0, pg
        held = set(int(p) for p in self._free)
        assert len(held) == len(self._free), "free list has duplicates"


@dataclasses.dataclass
class _Node:
    """One cached chunk: a page plus its place in the chain."""

    page: int
    parent: Optional[bytes]  #: parent FULL-chunk digest (None for root)
    tokens: Optional[Tuple[int, ...]]  #: partial chunks only
    children: int = 0
    tick: int = 0


class PrefixCache:
    """Chain-hashed page-aligned prompt chunks -> refcounted pages.

    Full ``page_size`` chunks are indexed by the digest chain
    ``d_i = H(d_{i-1}, chunk_i)`` and registered right after prefill
    (full prompt pages are complete and never rewritten, so concurrent
    requests can share immediately). A partial tail chunk is registered
    when its request *finishes* — its page keeps being written during
    decode — keyed by ``(parent digest, tail tokens)``; a later prompt
    extending past a cached partial copy-on-writes the clone at its
    first divergent/extending position.
    """

    def __init__(self, allocator: PageAllocator) -> None:
        self._alloc = allocator
        self._full: Dict[bytes, _Node] = {}
        self._partial: Dict[Tuple[bytes, Tuple[int, ...]], _Node] = {}
        self._tick = 0
        self.hits = 0
        self.misses = 0

    @property
    def pages_held(self) -> int:
        return len(self._full) + len(self._partial)

    def _touch(self, node: _Node) -> None:
        self._tick += 1
        node.tick = self._tick

    def _chunks(self, prompt) -> List[Tuple[int, ...]]:
        ps = self._alloc.page_size
        return [tuple(int(t) for t in prompt[i:i + ps])
                for i in range(0, len(prompt), ps)]

    @staticmethod
    def prompt_digest(tokens, page_size: int) -> bytes:
        """Chained prefix digest of a prompt, computable without an
        engine or allocator — a prefix-affinity router's key.

        Walks the same chain :meth:`lookup`/:meth:`register_full` walk:
        ``d_i = H(d_{i-1}, chunk_i)`` over the full ``page_size`` chunks
        (so the result for a page-aligned prompt IS the ``_full`` cache
        key of its last page), then folds a partial tail chunk in with
        one more ``H(parent, tail)`` step — the hashed form of the
        ``(parent digest, tail tokens)`` key ``_partial`` uses. Two
        prompts share a digest iff the cache would key them identically,
        which is exactly the warm-replica question such a router asks.
        """
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        toks = [int(t) for t in tokens]
        digest = _ROOT
        k_full = len(toks) // page_size
        for i in range(k_full):
            digest = _digest(
                digest, tuple(toks[i * page_size:(i + 1) * page_size]))
        tail = tuple(toks[k_full * page_size:])
        if tail:
            digest = _digest(digest, tail)
        return digest

    def lookup(self, prompt) -> Tuple[List[int], int, bool]:
        """Longest cached prefix of ``prompt``.

        Returns ``(pages, matched_tokens, tail_is_partial)`` —
        position-ordered pages covering ``matched_tokens``; when
        ``tail_is_partial`` the last page is a partially-filled cached
        tail (its clone must be copy-on-written before any write).
        """
        ps = self._alloc.page_size
        pages: List[int] = []
        matched = 0
        digest = _ROOT
        for chunk in self._chunks(prompt):
            if len(chunk) < ps:
                break
            nxt = _digest(digest, chunk)
            node = self._full.get(nxt)
            if node is None:
                break
            self._touch(node)
            pages.append(node.page)
            matched += ps
            digest = nxt
        if matched < len(prompt):
            remainder = tuple(int(t) for t in prompt[matched:])
            best: Optional[_Node] = None
            best_len = 0
            for (parent, toks), node in self._partial.items():
                if parent != digest or len(toks) <= best_len:
                    continue
                if remainder[:len(toks)] == toks:
                    best, best_len = node, len(toks)
            if best is not None:
                self._touch(best)
                pages.append(best.page)
                matched += best_len
                return pages, matched, True
        return pages, matched, False

    def register_full(self, prompt, table_row, *, upto: int) -> None:
        """Index the full ``page_size`` chunks of ``prompt[:upto]``
        against the slot's (already written) pages, taking a cache
        reference on each newly indexed page."""
        ps = self._alloc.page_size
        digest = _ROOT
        for i in range(int(upto) // ps):
            chunk = tuple(int(t) for t in prompt[i * ps:(i + 1) * ps])
            nxt = _digest(digest, chunk)
            node = self._full.get(nxt)
            if node is None:
                pg = int(table_row[i])
                if pg == self._alloc.scratch:
                    break
                self._alloc.retain(pg)
                node = _Node(page=pg, parent=None if digest is _ROOT
                             else digest, tokens=None)
                self._full[nxt] = node
                if node.parent is not None:
                    self._full[node.parent].children += 1
            self._touch(node)
            digest = nxt

    def register_partial(self, prompt, table_row) -> None:
        """Index the prompt's partial tail chunk (if any) under its
        parent digest. Called at request finish — by then the tail page
        is private and stable for the cached positions."""
        ps = self._alloc.page_size
        k_full = len(prompt) // ps
        tail = tuple(int(t) for t in prompt[k_full * ps:])
        if not tail:
            return
        digest = _ROOT
        for i in range(k_full):
            chunk = tuple(int(t) for t in prompt[i * ps:(i + 1) * ps])
            nxt = _digest(digest, chunk)
            if nxt not in self._full:
                return  # full chain not cached; don't dangle a partial
            digest = nxt
        key = (digest, tail)
        if key in self._partial:
            self._touch(self._partial[key])
            return
        pg = int(table_row[k_full])
        if pg == self._alloc.scratch:
            return
        self._alloc.retain(pg)
        node = _Node(page=pg, parent=None if digest is _ROOT else digest,
                     tokens=tail)
        self._partial[key] = node
        if node.parent is not None:
            self._full[node.parent].children += 1
        self._touch(node)

    def evict(self, need: int) -> int:
        """Leaf-first LRU: drop cache references until ``need`` pages
        came free (or nothing evictable remains). Only pages no active
        slot shares actually return to the free list."""
        freed = 0
        while freed < need:
            candidates: List[Tuple[int, object, _Node]] = []
            for key, node in self._partial.items():
                candidates.append((node.tick, key, node))
            for key, node in self._full.items():
                if node.children == 0:
                    candidates.append((node.tick, key, node))
            if not candidates:
                break
            _, key, node = min(candidates, key=lambda c: c[0])
            if isinstance(key, tuple):
                del self._partial[key]
            else:
                del self._full[key]
            if node.parent is not None:
                self._full[node.parent].children -= 1
            if self._alloc.refcount[node.page] == 1:
                freed += 1
            self._alloc.release_page(node.page)
        return freed

    def clear(self) -> None:
        """Drop every cache reference (tests / shutdown)."""
        for node in list(self._partial.values()):
            self._alloc.release_page(node.page)
        for node in list(self._full.values()):
            self._alloc.release_page(node.page)
        self._partial.clear()
        self._full.clear()


@dataclasses.dataclass
class PrefillSetup:
    """What the engine must do before running ``paged_prefill``."""

    start: int  #: cached-prefix length; prefill covers [start, len(seq))
    copies: List[Tuple[int, int]]  #: copy_page (src, dst) pairs, in order


class PagedKVState:
    """Engine-facing facade: allocator + prefix cache + metrics.

    Pure host state. The engine owns the device pool and runs
    ``copy_page``; this class only ever returns *indices* and
    ``(src, dst)`` copy instructions.
    """

    def __init__(self, *, num_pages: int, page_size: int, slots: int,
                 max_pages: int, bytes_per_token: int,
                 prefix_caching: bool = True) -> None:
        self.allocator = PageAllocator(
            num_pages=num_pages, page_size=page_size, slots=slots,
            max_pages=max_pages)
        self.prefix: Optional[PrefixCache] = (
            PrefixCache(self.allocator) if prefix_caching else None)
        self._bytes_per_token = bytes_per_token

    # -- admission ------------------------------------------------------------

    def pages_needed(self, total_tokens: int) -> int:
        return self.allocator.pages_needed(total_tokens)

    def check_fits(self, total_tokens: int) -> None:
        """submit()-time guard: reject requests that could never fit
        even into an empty pool, loudly."""
        need = self.pages_needed(total_tokens)
        if need > self.allocator.num_pages:
            raise ValueError(
                f"serve: request needs {need} pages "
                f"({total_tokens} tokens at page_size="
                f"{self.allocator.page_size}) but the pool only has "
                f"{self.allocator.num_pages} — raise num_pages/"
                "budget_bytes or lower max_new_tokens")

    def try_admit(self, total_tokens: int) -> bool:
        """Admission gate: reserve worst-case pages for one request,
        evicting cold prefix-cache pages if that is what it takes.
        Returns False (leave it queued) when headroom is short."""
        need = self.pages_needed(total_tokens)
        short = need - self.allocator.headroom()
        if short > 0 and self.prefix is not None:
            self.prefix.evict(short)
        if need > self.allocator.headroom():
            return False
        self.allocator.reserve_pending(need)
        return True

    # -- prefill --------------------------------------------------------------

    def begin(self, slot: int, seq, total_tokens: int, *,
              chunk: int = 0) -> PrefillSetup:
        """Build ``slot``'s page table for prefilling ``seq``: bind the
        admission reservation, attach any cached prefix (copy-on-write
        on a partial tail), and allocate private pages for the suffix.

        ``chunk > 0`` switches to chunk-granular allocation: only the
        pages the FIRST chunk (positions ``[start, start + chunk)``)
        writes are allocated now; :meth:`extend_prefill` draws the rest
        from the admission reservation one chunk at a time, so a
        half-prefilled long prompt pins pages proportional to its
        progress, not its full length. Prefix-cache hits skip whole
        cached chunks — the suffix starts at ``start``.
        """
        alloc = self.allocator
        ps = alloc.page_size
        need = self.pages_needed(total_tokens)
        alloc.bind_reservation(slot, need)
        copies: List[Tuple[int, int]] = []
        start = 0
        if self.prefix is not None:
            pages, matched, partial = self.prefix.lookup(seq)
            # Always leave >= 1 token to prefill: the suffix pass is
            # what produces the first generated token's logits.
            matched = min(matched, len(seq) - 1)
            k_full = matched // ps
            rem = matched % ps
            alloc.attach(slot, pages[:k_full], full=True)
            if rem:
                # Partially-used hit page: attach then immediately make
                # it private — positions >= rem get overwritten.
                alloc.attach(slot, [pages[k_full]], full=False)
                copies.append(alloc.cow(slot, k_full))
            start = matched
            if matched:
                self.prefix.hits += 1
                metrics.inc("serve.prefix.hits")
                metrics.inc("serve.prefix.bytes_saved",
                            matched * self._bytes_per_token)
            else:
                self.prefix.misses += 1
                metrics.inc("serve.prefix.misses")
            metrics.observe_value("serve.prefill.skipped_tokens",
                                  float(matched))
        # Private pages for every position the suffix will write — the
        # whole suffix up front, or just the first chunk's worth.
        upto = len(seq) if chunk <= 0 else min(start + chunk, len(seq))
        last_page = (upto - 1) // ps
        while alloc.count[slot] <= last_page:
            alloc.alloc(slot)
        return PrefillSetup(start=start, copies=copies)

    def extend_prefill(self, slot: int, upto: int) -> None:
        """Chunk-granular growth: allocate pages so positions
        ``[0, upto)`` all have a table entry. Draws from the admission
        reservation bound in :meth:`begin`, so it cannot deadlock
        against other requests."""
        alloc = self.allocator
        last_page = (int(upto) - 1) // alloc.page_size
        while alloc.count[slot] <= last_page:
            alloc.alloc(slot)

    def register_prefill(self, slot: int, prompt) -> None:
        """Index the prompt's full pages right after prefill wrote them,
        so requests admitted later this round already share."""
        if self.prefix is not None:
            self.prefix.register_full(prompt, self.allocator.table[slot],
                                      upto=len(prompt))

    # -- decode ---------------------------------------------------------------

    def prepare_append(self, slot: int, length: int) -> List[Tuple[int, int]]:
        """Make the write target for position ``length`` writable:
        allocate the next page at a boundary, copy-on-write a shared
        tail. Returns ``copy_page`` (src, dst) pairs to run first."""
        alloc = self.allocator
        idx = length // alloc.page_size
        if idx >= alloc.count[slot]:
            alloc.alloc(slot)
            return []
        if not alloc.writable(int(alloc.table[slot, idx])):
            return [alloc.cow(slot, idx)]
        return []

    # -- finish / swap --------------------------------------------------------

    def finish(self, slot: int, prompt, *,
               upto: Optional[int] = None) -> None:
        """Release the slot's pages; first index the prompt's tail chunk
        (and any full chunks a recovery prefill skipped registering) so
        the next identical prompt hits.

        ``upto`` bounds registration to prompt positions whose K/V were
        actually WRITTEN — a request evicted mid-chunked-prefill may
        hold allocated-but-unwritten pages, and registering those would
        poison the prefix cache with garbage K/V. The partial tail is
        only indexed when the whole prompt landed."""
        if self.prefix is not None:
            n = len(prompt) if upto is None else min(int(upto), len(prompt))
            self.prefix.register_full(prompt, self.allocator.table[slot],
                                      upto=n)
            if n == len(prompt):
                self.prefix.register_partial(prompt,
                                             self.allocator.table[slot])
        self.allocator.release_slot(slot)

    def swap_slots(self, i: int, j: int) -> None:
        self.allocator.swap_slots(i, j)

    # -- telemetry ------------------------------------------------------------

    def note_usage(self) -> None:
        metrics.set_gauge("serve.pages.in_use",
                          float(self.allocator.pages_in_use))
        metrics.set_gauge("serve.pages.free",
                          float(self.allocator.free_pages))
        # Pool bytes actually held per occupied slot (page-table
        # references x page bytes — shared prefix pages count once per
        # referencing slot on purpose: this is the capacity-planning
        # "what does one more request cost" number, and with an int8
        # pool it is roughly half the float figure at equal lengths).
        held = int(self.allocator.count.sum())
        occupied = int(np.count_nonzero(self.allocator.count))
        if occupied:
            per_page = self.allocator.page_size * self._bytes_per_token
            metrics.set_gauge("serve.pages.bytes_per_slot",
                              held * per_page / occupied)
