"""Prefix-affinity router over N serving instances (counterpart of
flexflow_tpu/disagg/router.py: the same policy, so both route the same
prompts to the same instances).

Prefix caching only pays when requests sharing a prompt prefix land on
the SAME pool — spread them round-robin and every instance recomputes
the prefix from scratch. The router keys each request by its first
page-aligned chain hash (the pool's own content address, so the router
and the cache agree byte-for-byte on what "same prefix" means) and
pins that key to one instance:

  affinity   — a prefix key routes to the instance that served it
               first, forever (sticky map; deterministic across runs
               given the same arrival order). An affinity hit routes
               there even under load: a tier fetch or LRU hit is far
               cheaper than recomputing the prefix elsewhere.
  placement  — a NEVER-seen prefix goes to the least-loaded instance:
               load = router-tracked in-flight requests plus a
               reqlog-derived service-time estimate (mean decode
               seconds over the instance's recent records), so a slow
               instance sheds new prefixes while it drains.
  spill-aware admission — page pressure (low pool free_pages) only
               counts against an instance when its host tier cannot
               absorb it: with tier headroom, admission just spills
               cold pages to host RAM instead of preempting, so the
               router keeps routing there. An instance that is BOTH
               page-starved and tier-full is skipped for new prefixes.

Every routed request is stamped `routed_to=<instance name>` before
enqueue, so the per-instance reqlogs reconstruct the routing decision
offline.

The router is plain bookkeeping over instance.submit_request — it
holds no model state, so it fronts any mix of PagedGenerationServer,
SpeculativePagedServer, or DisaggPair-shaped instances that expose
`pool`, `submit_request`, and `stop`.
"""

from __future__ import annotations

import hashlib
import threading
from typing import Dict, Optional, Sequence

import numpy as np


class PrefixAffinityRouter:
    """Shard requests across `instances` by prefix chain hash."""

    # free-page ratio below which an instance is "under page pressure"
    PRESSURE_FLOOR = 0.1
    # reqlog records consulted for the service-time load estimate
    LOAD_WINDOW = 64

    def __init__(self, instances: Sequence,
                 names: Optional[Sequence[str]] = None):
        if not instances:
            raise ValueError("router needs at least one instance")
        self._instances = list(instances)
        n = len(self._instances)
        self._names = (list(names) if names is not None
                       else [f"s{i}" for i in range(n)])
        if len(self._names) != n:
            raise ValueError(
                f"{n} instances but {len(self._names)} names")
        sizes = {inst.pool.page_size for inst in self._instances}
        if len(sizes) != 1:
            raise ValueError(
                f"instances disagree on page_size ({sorted(sizes)}) — "
                "their chain hashes would never match")
        self._affinity: Dict[str, int] = {}
        self._inflight = [0] * n
        self.routed_total = [0] * n
        self.affinity_hits = 0
        self.affinity_misses = 0
        self._lock = threading.Lock()

    # -- policy ------------------------------------------------------------

    def _prefix_key(self, prompt: np.ndarray) -> str:
        """The pool's FIRST page-aligned chain hash — the root every
        shared prefix runs through. A prompt shorter than one page has
        no full block; its whole token string is the key instead."""
        chain = self._instances[0].pool.chain_hashes(prompt)
        if chain:
            return chain[0]
        return "short:" + hashlib.sha1(
            np.asarray(prompt, np.int32).tobytes()).hexdigest()

    def _load(self, i: int) -> float:
        """In-flight requests weighted by the instance's recent mean
        request service time (reqlog-derived; 0 when no records yet) —
        two queued requests on a slow instance outweigh three on a
        fast one."""
        inst = self._instances[i]
        svc = 0.0
        log = getattr(inst, "request_log", None)
        if log:
            recent = log.tail(self.LOAD_WINDOW)
            if recent:
                svc = sum(
                    max(0.0, (r["done_ns"] - r["admit_ns"]) / 1e9)
                    for r in recent) / len(recent)
        return self._inflight[i] * (1.0 + svc)

    def _pressured(self, i: int) -> bool:
        """Page-starved AND nowhere to spill: free pages below the
        floor and the tier (if any) at capacity. With tier headroom the
        pool sheds cold pages to host RAM instead of preempting, so
        pressure alone never diverts traffic."""
        pool = self._instances[i].pool
        if pool.free_pages / max(1, pool.num_pages) >= self.PRESSURE_FLOOR:
            return False
        tier = pool.tier
        return tier is None or len(tier) >= tier.capacity_pages

    def _route_locked(self, key: str) -> int:
        """Routing policy body; caller holds self._lock."""
        i = self._affinity.get(key)
        if i is not None:
            self.affinity_hits += 1
            return i
        self.affinity_misses += 1
        candidates = [j for j in range(len(self._instances))
                      if not self._pressured(j)]
        if not candidates:
            candidates = list(range(len(self._instances)))
        i = min(candidates, key=lambda j: (self._load(j), j))
        self._affinity[key] = i
        return i

    def route_index(self, prompt) -> int:
        """Pick (and pin) the instance for `prompt`. Deterministic:
        sticky map first, then min (load, index) over unpressured
        instances, then min over all."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        key = self._prefix_key(prompt)
        with self._lock:
            return self._route_locked(key)

    # -- serving surface ----------------------------------------------------

    def submit(self, prompt_ids, max_new_tokens: int,
               temperature: float = 0.0):
        from flexflow_tpu_torch.serving import _GenRequest

        if max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {max_new_tokens}")
        prompt = np.asarray(prompt_ids, np.int32).reshape(-1)
        if len(prompt) == 0:
            raise ValueError("prompt must contain at least one token")
        req = _GenRequest(prompt, max_new_tokens, temperature)
        key = self._prefix_key(prompt)
        # route + stamp + count under ONE acquisition: a concurrent
        # submit must never observe the routing decision without the
        # load bump that goes with it (stale-load window)
        with self._lock:
            i = self._route_locked(key)
            req.routed_to = self._names[i]
            self._inflight[i] += 1
            self.routed_total[i] += 1
        req.future.add_done_callback(lambda _f, i=i: self._done(i))
        try:
            self._instances[i].submit_request(req)
        except BaseException:
            # compensating decrement for a request that never enqueued —
            # no decision spans the lock release, so the split is benign
            self._done(i)
            raise
        return req.future

    def _done(self, i: int) -> None:
        with self._lock:
            self._inflight[i] = max(0, self._inflight[i] - 1)

    def generate(self, prompt_ids, max_new_tokens: int,
                 temperature: float = 0.0):
        return self.submit(prompt_ids, max_new_tokens,
                           temperature).result()

    def stop(self):
        for inst in self._instances:
            inst.stop()

    def metrics(self) -> Dict:
        with self._lock:
            return {
                "instances": list(self._names),
                "routed_total": list(self.routed_total),
                "inflight": list(self._inflight),
                "affinity_prefixes": len(self._affinity),
                "affinity_hits": self.affinity_hits,
                "affinity_misses": self.affinity_misses,
            }
