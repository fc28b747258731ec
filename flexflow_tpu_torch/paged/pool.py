"""Host-side page-pool bookkeeping for the paged KV cache (a copy of
flexflow_tpu/paged/pool.py: the pool is numpy and Python only, so the port
takes it as it is, with the invariant checks it calls copied in below).

All allocation state is plain numpy/python on the host; the device only
ever sees int32 page tables (one row per decode slot), so the jitted
decode step stays a single compiled program regardless of which requests
hold which pages. Page 0 is reserved as the NULL page: unallocated page
table entries point at it, and idle decode slots write their garbage
K/V row into it (those rows sit past every live request's position and
are masked by the absolute-position attention mask).

Pages are REFCOUNTED and CONTENT-ADDRESSED (vLLM-style prefix caching):
a sha1 hash chain over page-aligned token blocks names each full page by
the entire token prefix it closes, so two requests whose prompts share a
page-aligned prefix map the SAME physical pages (refcount counts the
mappers). A page whose refcount drops to zero is not erased: if it is
hash-registered it parks on an LRU dead list — still addressable as a
cache hit, reclaimed lazily when a fresh allocation needs it. Partially
filled tail pages are registered under (parent chain hash, tail tokens)
and are served copy-on-write: a hit clones the rows into a private page
before the new owner writes past them (paged/scheduler.py owns the
device copy; the pool only does the bookkeeping).
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np

# chain hash of the empty prefix (parent of the first block)
EMPTY_HASH = hashlib.sha1().hexdigest()


class PagePool:
    """Fixed-size page allocator over `num_pages` KV pages of `page_size`
    tokens each. Page 0 is never handed out (the null page), so usable
    capacity is `num_pages - 1` pages."""

    def __init__(self, num_pages: int, page_size: int,
                 max_pages_per_seq: int):
        if num_pages < 2:
            raise ValueError(f"need >= 2 pages (one is the null page), "
                             f"got {num_pages}")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self.max_pages_per_seq = int(max_pages_per_seq)
        # LIFO free list: freshly freed pages are reused first (their HBM
        # is warm) — order is a host-side detail, invisible to the device
        self._free: List[int] = list(range(num_pages - 1, 0, -1))
        self._refs: Dict[int, int] = {}          # page id -> refcount > 0
        # dead-but-cached pages, oldest first (refcount 0, still indexed);
        # an OrderedDict so revival and LRU eviction are both O(1)
        self._lru: "OrderedDict[int, None]" = OrderedDict()
        # content addressing: chain hash -> page for FULL blocks; parent
        # chain hash -> (page, tail tokens) for the partial tail block.
        # _keys_of tracks every index entry naming a page, for O(1)
        # unregister on eviction and id rewrite on defrag.
        self._full: Dict[str, int] = {}
        self._partial: Dict[str, Tuple[int, Tuple[int, ...]]] = {}
        self._keys_of: Dict[int, List[Tuple[str, str]]] = {}
        # prefix-cache counters (served by scheduler/server metrics)
        self.hit_tokens = 0
        self.lookup_tokens = 0
        self.hits = 0          # lookups that mapped at least one row
        self.misses = 0
        self.evictions = 0     # cached pages reclaimed for fresh allocs
        # host-memory tier (disagg/host_tier.py), attached lazily: dead-
        # list evictions SPILL full pages' payloads instead of dropping
        # them, and lookups transparently FETCH spilled hashes back into
        # fresh pages. The pool only moves bookkeeping; payloads travel
        # through the attached reader/writer closures.
        self._tier = None
        self._tier_read = None   # page id -> opaque payload (+ scales)
        self._tier_write = None  # (page id, payload) -> None
        self.spilled_pages = 0   # pages pushed to the tier (evict+handoff)
        self.fetched_pages = 0   # pages pulled back from the tier

    # -- accounting -----------------------------------------------------

    @property
    def capacity(self) -> int:
        return self.num_pages - 1

    @property
    def free_pages(self) -> int:
        """Allocatable pages: truly free + dead-but-cached (the LRU list
        is reclaimed lazily, so admission math treats it as free)."""
        return len(self._free) + len(self._lru)

    @property
    def pages_in_use(self) -> int:
        """Live (refcount > 0) pages — shared pages count ONCE; that is
        the whole point of prefix sharing."""
        return self.capacity - self.free_pages

    @property
    def cached_pages(self) -> int:
        return len(self._lru)

    def refcount(self, page: int) -> int:
        return self._refs.get(page, 0)

    # -- host-memory tier (disagg) ---------------------------------------

    @property
    def tier(self):
        """The attached HostTier, or None (untired pool — evictions
        drop, lookups never fetch; the pre-disagg behaviour)."""
        return self._tier

    def attach_tier(self, tier, read_page, write_page) -> None:
        """Arm the host tier: `read_page(page) -> payload` snapshots one
        device page's rows AND its scale-sidecar entries into an opaque
        host payload; `write_page(page, payload)` restores one. The
        scheduler supplies device_get/device_put closures; the poolcheck
        model supplies its bookkeeping mirrors. Attach before the pool
        serves traffic — the closures run inside alloc()/lookup()."""
        if tier is None or read_page is None or write_page is None:
            raise ValueError(
                "attach_tier needs a tier and both payload closures")
        self._tier = tier
        self._tier_read = read_page
        self._tier_write = write_page

    def _spill_page(self, page: int) -> int:
        """Push `page`'s payload into the tier under every FULL chain
        hash naming it (a hash-addressed page is its payload — partial
        tail entries are COW hints and just drop). Returns the number of
        tier entries written. The caller unregisters afterwards, so the
        hash is never resident and spilled at once."""
        if self._tier is None:
            return 0
        fulls = [h for kind, h in self._keys_of.get(page, ())
                 if kind == "full"]
        if not fulls:
            return 0
        payload = self._tier_read(page)
        for h in fulls:
            self._tier.spill(h, payload)
        self.spilled_pages += len(fulls)
        return len(fulls)

    def _fetch_full(self, chain_hash: str) -> Optional[int]:
        """Pull one spilled full page back: pop the tier entry (move
        semantics — a fetched hash leaves the tier), allocate a device
        page, restore the payload (scales included), and re-register the
        hash. Returns the page PINNED at refcount 1 (the allocation is
        the lookup's retain), or None when the pool is too full to land
        it (the tier entry is rolled back — still fetchable later)."""
        payload = self._tier.fetch(chain_hash)
        if payload is None:
            return None  # raced a tier-capacity drop
        got = self.alloc(1)  # may itself evict-and-spill the LRU oldest
        if got is None:
            self._tier.unfetch(chain_hash, payload)
            return None
        page = got[0]
        self._tier_write(page, payload)
        self._full[chain_hash] = page
        self._keys_of.setdefault(page, []).append(("full", chain_hash))
        self.fetched_pages += 1
        return page

    def spill_request(self, pages: List[int]) -> int:
        """Handoff spill (disagg/workers.py): push every full-registered
        page of a request into the tier and UNREGISTER it here — the
        pages' content moves to host RAM where another server's pool can
        fetch it, and this pool's hash index stays disjoint from the
        tier's. The caller still holds the refcounts and frees the now
        index-less pages normally (they return to the free list).
        Returns tier entries written. Requires an attached tier."""
        if self._tier is None:
            raise RuntimeError("spill_request needs an attached tier")
        moved = 0
        for p in pages:
            moved += self._spill_page(p)
            self._unregister(p)
        return moved

    def spill_oldest(self) -> Optional[int]:
        """Force-spill the OLDEST dead-cached page (the next eviction
        victim) to the tier ahead of allocation pressure — the proactive
        variant of alloc()'s spill, used by the poolcheck `spill` op and
        available to background pressure-relief. Returns the freed page
        id, or None when nothing is dead-cached or no tier is armed."""
        if self._tier is None or not self._lru:
            return None
        p, _ = self._lru.popitem(last=False)
        self._spill_page(p)
        self._unregister(p)
        self._free.append(p)
        return p

    def prefetch(self, chain_hash: str) -> Optional[int]:
        """Pull one spilled hash back WITHOUT pinning it: the fetched
        page parks dead-cached (registered, refcount 0 — LRU newest), so
        a later lookup hits it at device speed. The poolcheck `fetch` op
        and warm-up paths use this. Returns the page id or None."""
        if self._tier is None or not self._tier.contains(chain_hash):
            return None
        page = self._fetch_full(chain_hash)
        if page is None:
            return None
        self.free([page])  # registered: parks on the LRU dead list
        return page

    def fragmentation(self) -> float:
        """Hole fraction of the occupied span: 1 - occupied/span where
        span reaches the highest non-free page. 0.0 when compact (or
        empty); defrag drives it back to 0."""
        # metrics threads (server.metrics(), the HTTP endpoint) call this
        # while the scheduler thread allocates/frees; dict iteration can
        # race a resize, so retry the cheap snapshot instead of locking
        # the hot path
        for _ in range(8):
            try:
                used = set(self._refs) | set(self._lru)
                break
            except RuntimeError:  # dict resized mid-iteration
                continue
        else:
            return 0.0
        if not used:
            return 0.0
        return 1.0 - len(used) / max(used)

    def pages_for(self, n_tokens: int) -> int:
        """Pages needed to hold `n_tokens` cache rows."""
        return -(-int(n_tokens) // self.page_size)

    # -- content addressing ---------------------------------------------

    def chain_hashes(self, tokens) -> List[str]:
        """Chain hash of every FULL page-aligned block of `tokens`:
        entry i names blocks 0..i — the whole prefix, not just block i —
        so equal hashes mean equal prefixes (position is implicit)."""
        toks = np.asarray(tokens, np.int32)
        h = hashlib.sha1()
        out = []
        P = self.page_size
        for i in range(len(toks) // P):
            h.update(toks[i * P:(i + 1) * P].tobytes())
            out.append(h.hexdigest())
        return out

    def _is_free(self, page: int) -> bool:
        """Neither refcounted nor dead-cached — O(1), unlike a `_free`
        list scan (publication runs per page boundary on the hot loop)."""
        return page not in self._refs and page not in self._lru

    def register_full(self, page: int, chain_hash: str) -> None:
        """Publish a fully written page under its prefix chain hash.
        First writer wins — an existing entry keeps its page (the rows
        are identical by construction; re-pointing would orphan refs)."""
        if self._is_free(page) or chain_hash in self._full:
            return
        self._full[chain_hash] = page
        self._keys_of.setdefault(page, []).append(("full", chain_hash))
        if self._tier is not None:
            # a writer recomputed this prefix while a spilled copy sat in
            # the tier: residency wins, the tier entry drops — resident ⊎
            # spilled stays a true partition of the hash index
            self._tier.drop(chain_hash)

    def register_partial(self, page: int, parent_hash: str,
                         tokens) -> None:
        """Publish a partially filled tail page: rows [0, len(tokens))
        hold the K/V of `tokens` continuing the `parent_hash` prefix.
        Latest wins (the entry is a hint, hits are COW-copied anyway)."""
        toks = tuple(int(t) for t in tokens)
        if self._is_free(page) or not toks or len(toks) >= self.page_size:
            return
        prev = self._partial.get(parent_hash)
        if prev is not None and prev[0] != page:
            keys = self._keys_of.get(prev[0])
            if keys and ("partial", parent_hash) in keys:
                keys.remove(("partial", parent_hash))
            if not keys and prev[0] in self._lru:
                # the displaced donor lost its last index entry: it can
                # never hit again, so free it rather than let it squat
                # in the LRU ahead of genuinely hittable pages
                del self._lru[prev[0]]
                self._keys_of.pop(prev[0], None)
                self._free.append(prev[0])
        self._partial[parent_hash] = (page, toks)
        keys = self._keys_of.setdefault(page, [])
        if ("partial", parent_hash) not in keys:
            keys.append(("partial", parent_hash))

    def lookup(self, tokens) -> Tuple[List[int], int, Optional[int]]:
        """Map the longest cached prefix of `tokens`. Returns
        (full_pages, cached_tokens, cow_page):

          full_pages — one page per matched FULL block, refcount bumped
          (revived from the LRU dead list when necessary);
          cached_tokens — rows covered: len(full_pages) * page_size plus
          any tail rows matched in cow_page;
          cow_page — a partial tail page whose leading rows continue the
          matched prefix, refcount bumped. The CALLER must clone its rows
          into a private page before anyone writes past them and then
          free() this reference (copy-on-write).

        Every returned page is pinned (refcounted) until freed."""
        toks = np.asarray(tokens, np.int32)
        n = len(toks)
        self.lookup_tokens += n
        chain = self.chain_hashes(toks)
        pages: List[int] = []
        parent = EMPTY_HASH
        for h in chain:
            p = self._full.get(h)
            if p is not None:
                # pin AS we walk (not after): a tier fetch further down
                # the chain allocates, and allocation may evict exactly
                # the dead-cached pages this walk already matched
                self._retain(p)
                if self._tier is not None:
                    # residency wins over a spilled twin: a SHARED tier
                    # (disagg handoff) can re-receive a prefix this pool
                    # still holds — e.g. the prefill worker re-spills a
                    # repeat prompt the decode pool never released. Drop
                    # the duplicate so resident ⊎ spilled is a partition
                    # again once the walk that observed it completes.
                    self._tier.drop(h)
            elif self._tier is not None and self._tier.contains(h):
                # transparent fetch: the prefix was spilled, not lost —
                # _fetch_full re-registers it and returns it pinned
                p = self._fetch_full(h)
            if p is None:
                break
            pages.append(p)
            parent = h
        cached = len(pages) * self.page_size
        cow_page = None
        # wherever the full-chain match stopped, a registered partial
        # tail continuing the matched prefix can still serve its leading
        # rows (identical prompts, prompt extensions, resume)
        if cached < n:
            ent = self._partial.get(parent)
            if ent is not None:
                pg, ptoks = ent
                rest = toks[cached:]
                m = 0
                for a, b in zip(rest, ptoks):
                    if int(a) != int(b):
                        break
                    m += 1
                if m > 0:
                    cow_page = pg
                    cached += m
        if cow_page is not None:
            self._retain(cow_page)
        self.hit_tokens += cached
        if cached > 0:
            self.hits += 1
        else:
            self.misses += 1
        return pages, cached, cow_page

    def _retain(self, page: int) -> None:
        self._refs[page] = self._refs.get(page, 0) + 1
        self._lru.pop(page, None)  # revive a dead-cached page

    def _unregister(self, page: int) -> None:
        for kind, h in self._keys_of.pop(page, []):
            if kind == "full" and self._full.get(h) == page:
                del self._full[h]
            elif kind == "partial" and \
                    self._partial.get(h, (None,))[0] == page:
                del self._partial[h]

    # -- alloc / free ---------------------------------------------------

    def alloc(self, n: int) -> Optional[List[int]]:
        """Allocate `n` PRIVATE pages (refcount 1), or None when the pool
        cannot satisfy the request (callers queue or preempt — never
        partial). Truly free pages first; then the oldest dead-but-cached
        pages are evicted (their hash entries drop — a future lookup of
        that prefix misses and recomputes)."""
        if n > self.free_pages:
            return None
        pages = []
        for _ in range(n):
            if self._free:
                p = self._free.pop()
            else:
                p, _ = self._lru.popitem(last=False)  # oldest first
                # with a host tier armed, eviction SPILLS instead of
                # dropping: the payload moves to host RAM under its
                # chain hashes, then the hash leaves the resident index
                self._spill_page(p)
                self._unregister(p)
                self.evictions += 1
            self._refs[p] = 1
            pages.append(p)
        return pages

    def free(self, pages: List[int]) -> None:
        """Drop one reference per page. At refcount 0 a hash-registered
        page parks on the LRU dead list (reusable as a cache hit); an
        unregistered one returns to the free list."""
        for p in pages:
            r = self._refs.get(p)
            if r is None:
                continue
            if r > 1:
                self._refs[p] = r - 1
                continue
            del self._refs[p]
            if self._keys_of.get(p):
                self._lru[p] = None  # newest at the end
            else:
                self._keys_of.pop(p, None)
                self._free.append(p)

    # -- defrag ---------------------------------------------------------

    def defrag(self) -> tuple:
        """Compact occupied pages (live AND dead-cached) to the low end
        of the pool. Returns (perm, old_to_new):

          perm[new_id] = old_id  — gather indices for moving the DEVICE
          pool buffers (`new_pool = old_pool[perm]`);
          old_to_new[old_id]     — rewrite for every live page table
          (`table = old_to_new[table]`; null stays null).

        Every owner's table AND the hash index are rewritten: the caller
        applies old_to_new to each slot's table row and every request's
        page list; the pool rewrites refcounts, the LRU list (order
        preserved) and the content-address indexes here. Pure bookkeeping
        on this side; the caller owns applying the device gather
        atomically (the scheduler does this between decode ticks, when no
        jitted program is in flight)."""
        allocated = sorted(set(self._refs) | set(self._lru))
        perm = np.arange(self.num_pages, dtype=np.int32)
        old_to_new = np.arange(self.num_pages, dtype=np.int32)
        for new_id, old_id in enumerate(allocated, start=1):
            perm[new_id] = old_id
            old_to_new[old_id] = new_id
        # remaining slots of perm point at the (now free) old pages, keeping
        # perm a true permutation; their content is garbage either way
        occupied = set(allocated)
        free_old = [p for p in range(1, self.num_pages)
                    if p not in occupied]
        for i, old_id in zip(range(len(allocated) + 1, self.num_pages),
                             free_old):
            perm[i] = old_id
        remap = lambda p: int(old_to_new[p])  # noqa: E731
        self._refs = {remap(p): r for p, r in self._refs.items()}
        self._lru = OrderedDict((remap(p), None) for p in self._lru)
        self._keys_of = {remap(p): ks for p, ks in self._keys_of.items()}
        self._full = {h: remap(p) for h, p in self._full.items()}
        self._partial = {h: (remap(p), t)
                         for h, (p, t) in self._partial.items()}
        self._free = list(range(self.num_pages - 1, len(allocated), -1))
        return perm, old_to_new

    def check_invariants(self, owners: Optional[dict] = None) -> None:
        """Debug hook: assert the pool-scope invariants of the reference's
        catalog (flexflow_tpu/analysis/pool_invariants.py: free-accounting,
        dead-list, index, tier-partition, and refcount-owners when an
        {owner_id: [pages]} map of every live page list is given) over the
        current bookkeeping state. Raises AssertionError naming every
        violated invariant. O(pages + index entries) — cheap enough for
        tests after every op, too hot for the serving loop."""
        violations = (_free_accounting(self) + _dead_list(self)
                      + _index(self) + _tier_partition(self))
        if owners is not None:
            violations += _refcount_owners(self, owners)
        if violations:
            raise AssertionError(
                "PagePool invariant violation(s):\n  "
                + "\n  ".join(violations))


# ---------------------------------------------------------------------------
# pool-scope invariant checks (a local copy of the reference catalog's
# check functions; each returns a list of "name: detail" violations)


def _free_accounting(pool: PagePool) -> List[str]:
    v = []
    free, lru, refs = set(pool._free), set(pool._lru), set(pool._refs)
    if len(pool._free) != len(free):
        v.append(f"free list holds duplicates: {sorted(pool._free)}")
    for a, b, la, lb in ((free, lru, "free", "lru"),
                         (free, refs, "free", "refs"),
                         (lru, refs, "lru", "refs")):
        both = a & b
        if both:
            v.append(f"pages {sorted(both)} are in both {la} and {lb}")
    everywhere = free | lru | refs
    if 0 in everywhere:
        v.append("null page 0 entered the allocator")
    bad = [p for p in everywhere if not 1 <= p < pool.num_pages]
    if bad:
        v.append(f"out-of-range page ids {sorted(bad)}")
    total = len(free) + len(lru) + len(refs)
    if total != pool.capacity:
        v.append(f"free({len(free)}) + cached({len(lru)}) + "
                 f"live({len(refs)}) = {total} != capacity "
                 f"{pool.capacity}")
    bad_refs = {p: r for p, r in pool._refs.items() if r < 1}
    if bad_refs:
        v.append(f"non-positive refcounts {bad_refs}")
    return [f"free-accounting: {m}" for m in v]


def _dead_list(pool: PagePool) -> List[str]:
    v = []
    for p in pool._lru:
        if p in pool._refs:
            v.append(f"page {p} is dead-cached AND refcounted")
        if not pool._keys_of.get(p):
            v.append(f"page {p} is dead-cached but has no hash-index "
                     "entry (unhittable; it should be on the free list)")
    for p, keys in pool._keys_of.items():
        if keys and p not in pool._refs and p not in pool._lru:
            v.append(f"page {p} is hash-registered ({keys}) but neither "
                     "live nor dead-cached")
    return [f"dead-list: {m}" for m in v]


def _index(pool: PagePool) -> List[str]:
    v = []
    for h, p in pool._full.items():
        if ("full", h) not in pool._keys_of.get(p, []):
            v.append(f"full entry {h[:8]} -> {p} missing from the "
                     "inverse index")
    for h, (p, toks) in pool._partial.items():
        if ("partial", h) not in pool._keys_of.get(p, []):
            v.append(f"partial entry {h[:8]} -> {p} missing from the "
                     "inverse index")
        if not 0 < len(toks) < pool.page_size:
            v.append(f"partial entry {h[:8]} -> {p} has {len(toks)} "
                     f"tail tokens (must be in (0, page_size))")
    for p, keys in pool._keys_of.items():
        for kind, h in keys:
            if kind == "full" and pool._full.get(h) != p:
                v.append(f"inverse entry ('full', {h[:8]}) on page {p} "
                         f"points elsewhere ({pool._full.get(h)})")
            elif kind == "partial" and \
                    pool._partial.get(h, (None,))[0] != p:
                v.append(f"inverse entry ('partial', {h[:8]}) on page "
                         f"{p} points elsewhere")
    return [f"index: {m}" for m in v]


def _refcount_owners(pool: PagePool, owners: dict) -> List[str]:
    held: Dict[int, int] = {}
    for pages in owners.values():
        for p in pages:
            held[p] = held.get(p, 0) + 1
    v = []
    for p in set(held) | set(pool._refs):
        if pool._refs.get(p, 0) != held.get(p, 0):
            v.append(f"page {p}: refcount {pool._refs.get(p, 0)} != "
                     f"{held.get(p, 0)} live owner-table references")
    return [f"refcount-owners: {m}" for m in v]


def _tier_partition(pool: PagePool) -> List[str]:
    tier = pool._tier
    if tier is None:
        return []
    v = []
    both = set(tier.hashes()) & set(pool._full)
    if both:
        v.append(f"hashes {sorted(h[:8] for h in both)} are resident "
                 "AND spilled — the hash index is no longer a partition")
    if tier.occupancy_pages > tier.capacity_pages:
        v.append(f"tier holds {tier.occupancy_pages} entries over its "
                 f"capacity {tier.capacity_pages}")
    return [f"tier-partition: {m}" for m in v]
