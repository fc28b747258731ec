"""Host-memory KV tier behind the PagePool's LRU dead list (counterpart
of flexflow_tpu/disagg/host_tier.py).

Pages are CONTENT-ADDRESSED (paged/pool.py): a full page is named by the
sha1 chain hash of the entire token prefix it closes. That makes a host
tier almost free to express — spilling a page is a dict move keyed by
its hash (one copy of the page's rows of every cache leaf, the int8
scale sidecar included, into host memory), and fetching it back is one
copy into a freshly allocated page plus re-registration under the same
hash. No address translation, no per-owner fixups: hashes are stable
across defrag, preemption, even across POOLS — which is exactly what the
prefill/decode KV-transfer path (disagg/workers.py) rides.

Tier state machine:

    resident (in pool._full, has a device page)
        │ LRU eviction under allocation pressure /
        │ explicit handoff spill (PagePool.spill_request)
        ▼
    spilled (in HostTier, hash -> host payload; registered-but-
        │    not-resident: NO device page, NOT in pool._full)
        │ lookup hit on the spilled hash / prefetch
        ▼
    resident again (fresh page, payload copied back, re-registered)

An entry is in EXACTLY one place at a time: the pool unregisters before
it spills, and a fetch POPS the tier entry before re-registering — the
"resident ⊎ spilled partitions the hash index" invariant
(PagePool.check_invariants, `tier-partition`). The tier itself is
bounded (capacity_pages) with LRU eviction of its own: a spill beyond
capacity drops the OLDEST tier entry — that prefix misses and recomputes,
the same failure mode as an untiered pool, just much further away.

The tier holds OPAQUE payloads. The pool moves them via the
reader/writer closures handed to `PagePool.attach_tier` — the scheduler
supplies device closures (paged/scheduler.py `_tier_read_page` /
`_tier_write_page`: a payload is the page's rows of every leaf as host
tensors, in the caches dict's structure), and plain pool unit tests can
use anything hashable. Payloads carry the scale sidecar alongside the
K/V rows ("scales travel with their page").

A HostTier SHARED between two servers' pools is the KV-transfer channel
of the prefill/decode split: the prefill worker spills a finished
request's pages into it and the decode worker's admission lookup fetches
them out — per-request page adoption through host RAM, generalizing
`adopt_pool_from`'s whole-pool swap.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, List


class HostTier:
    """Bounded host-RAM store of spilled KV pages, keyed by the pool's
    prefix chain hashes. Thread-safe: the prefill worker's loop spills
    while the decode worker's loop fetches."""

    def __init__(self, capacity_pages: int = 1024):
        if capacity_pages < 1:
            raise ValueError(
                f"capacity_pages must be >= 1, got {capacity_pages}")
        self.capacity_pages = int(capacity_pages)
        # hash -> opaque payload (the page's rows + scale sidecar, in
        # whatever form the attached reader produced), oldest first
        self._entries: "OrderedDict[str, object]" = OrderedDict()
        self._lock = threading.Lock()
        # counters (scraped into ff_kv_spill_pages_total /
        # ff_kv_fetch_pages_total and the host-tier gauges)
        self.spilled_pages_total = 0
        self.fetched_pages_total = 0
        self.dropped_pages_total = 0   # tier-capacity evictions
        self.fetch_seconds_total = 0.0  # write-back side, timed by caller

    # -- query ------------------------------------------------------------

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    @property
    def occupancy_pages(self) -> int:
        with self._lock:
            return len(self._entries)

    def contains(self, chain_hash: str) -> bool:
        with self._lock:
            return chain_hash in self._entries

    def hashes(self) -> List[str]:
        with self._lock:
            return list(self._entries)

    def peek(self, chain_hash: str):
        """Read a payload WITHOUT popping it (invariant checks; the
        serving path always uses fetch's move semantics)."""
        with self._lock:
            return self._entries.get(chain_hash)

    # -- spill / fetch ------------------------------------------------------

    def spill(self, chain_hash: str, payload) -> None:
        """Store one page's payload under its chain hash (latest wins —
        identical hash means identical content by construction). Evicts
        its own oldest entry beyond capacity; the pool has already
        unregistered the hash, so residency is never double-counted."""
        with self._lock:
            self._entries.pop(chain_hash, None)
            self._entries[chain_hash] = payload
            self.spilled_pages_total += 1
            while len(self._entries) > self.capacity_pages:
                self._entries.popitem(last=False)
                self.dropped_pages_total += 1

    def fetch(self, chain_hash: str):
        """POP one payload (move semantics: the caller re-registers the
        hash as resident, so the entry must leave the tier). Returns
        None when the hash is absent (raced a capacity drop)."""
        with self._lock:
            payload = self._entries.pop(chain_hash, None)
            if payload is not None:
                self.fetched_pages_total += 1
            return payload

    def unfetch(self, chain_hash: str, payload) -> None:
        """Roll back a fetch whose device page allocation failed: the
        payload returns to the tier (front of the LRU order — it was the
        oldest claim on the entry) and the fetch is uncounted."""
        with self._lock:
            self._entries[chain_hash] = payload
            self._entries.move_to_end(chain_hash, last=False)
            self.fetched_pages_total -= 1

    def drop(self, chain_hash: str) -> None:
        """Discard a tier entry whose hash just became resident some
        other way (a writer recomputed and re-registered the prefix) —
        keeps resident ⊎ spilled a true partition."""
        with self._lock:
            if self._entries.pop(chain_hash, None) is not None:
                self.dropped_pages_total += 1

    def observe_fetch_seconds(self, dt: float) -> None:
        with self._lock:
            self.fetch_seconds_total += max(0.0, float(dt))

    # locks don't survive copy/pickle — rebuild the lock on a deep copy.
    # _entries is snapshotted INSIDE the lock: deepcopy walks the
    # returned state after this method exits, and a concurrent spill
    # mutating the live OrderedDict mid-walk is a crash, not a copy
    def __getstate__(self):
        with self._lock:
            d = self.__dict__.copy()
            d["_entries"] = OrderedDict(self._entries)
        del d["_lock"]
        return d

    def __setstate__(self, d):
        self.__dict__.update(d)
        self._lock = threading.Lock()

    # -- metrics ------------------------------------------------------------

    def metrics(self) -> Dict:
        """Occupancy + lifetime counters (the /v2 host_tier block and
        the Prometheus gauges read this)."""
        with self._lock:
            n = len(self._entries)
            fetched = self.fetched_pages_total
            return {
                "capacity_pages": self.capacity_pages,
                "occupancy_pages": n,
                "occupancy_ratio": n / self.capacity_pages,
                "spilled_pages_total": self.spilled_pages_total,
                "fetched_pages_total": fetched,
                "dropped_pages_total": self.dropped_pages_total,
                "fetch_seconds_total": self.fetch_seconds_total,
                "fetch_latency_s_avg": (self.fetch_seconds_total / fetched
                                        if fetched else 0.0),
            }
