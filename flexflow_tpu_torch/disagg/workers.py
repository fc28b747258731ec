"""Prefill/decode disaggregation (counterpart of
flexflow_tpu/disagg/workers.py): a PrefillWorker that runs admission and
chunked prefill ONLY, handing each request off to a decode worker the
moment its prefill completes, with the KV transferred through a shared
host tier.

Pages are content-addressed (paged/pool.py), so a request's KV is fully
named by its prefix chain hashes, and preempt-resume already proves that
"publish pages, free them, re-admit from seq_tokens()" is
token-identical. The handoff is per-REQUEST page adoption: the prefill
worker spills the finished request's full pages into the shared
HostTier (a dict move keyed by chain hash, scales riding along), hands
the live _GenRequest — future, first sampled token, counters intact —
to the decode worker's queue, and the decode worker's ordinary admission
lookup fetches the pages back out of the tier. The decode side IS the
preempt-resume path, entered on another server.

Handoff protocol, step by step (PrefillWorker._on_prefill_complete):

  1. prefill finishes a request's last chunk; the base scheduler has
     already published the tail, taken the FIRST token, and run
     _finish_if_done — a request that finished outright (max_new=1, an
     instant eos) never reaches the hook;
  2. _publish_tail again: with the first token appended, every full
     prompt page is now hash-registered (the partial tail stays a local
     hint — its rows are recomputed decode-side);
  3. pool.spill_request: every full-registered page of the request moves
     into the shared tier and leaves THIS pool's hash index (resident ⊎
     spilled stays a partition on both pools);
  4. free and clear the slot — the pages return to the free list, the
     prefill worker's capacity is reusable at once;
  5. decode_server.submit_request(req): the untouched request object
     (the Future the client holds) enters the decode worker's queue; its
     admission lookup walks the chain hashes, finds them in the tier,
     and _fetch_full lands each page in the decode pool. At most the
     tail rows and the clamped last token are recomputed — the
     preempt-resume contract, so greedy output is token-identical to a
     monolithic server.

Thread-safety: the hook runs on the prefill worker's loop thread;
submit_request only takes the decode server's queue lock; the tier's own
lock covers the spill/fetch race. Neither pool is ever touched from the
other worker's thread — the tier is the ONLY shared state. Both loops
enqueue onto the card's current stream: a spill reads its page back
synchronously (the rows the prefill wrote are complete when the payload
exists), and the kernels are loaded by their first launch under their
own lock.

DisaggPair wires the whole thing: one shared HostTier, a PrefillWorker,
a decode-side PagedGenerationServer, and a submit()/generate()/stop()
surface that looks like a single server.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

from flexflow_tpu_torch.disagg.host_tier import HostTier
from flexflow_tpu_torch.paged.scheduler import PagedGenerationServer
from flexflow_tpu_torch.serving import _GenRequest


class PrefillWorker(PagedGenerationServer):
    """A paged server that never decodes: every admitted request runs
    chunked prefill, then hands off through the shared host tier to the
    `handoff` callable (normally a decode server's submit_request)."""

    def __init__(self, ff, *, handoff: Callable[[_GenRequest], object],
                 host_tier, **kwargs):
        if handoff is None:
            raise ValueError("PrefillWorker needs a handoff target "
                             "(decode_server.submit_request)")
        if host_tier is None or host_tier == 0:
            raise ValueError(
                "PrefillWorker needs a host_tier — the tier IS the "
                "KV-transfer channel to the decode worker")
        if not kwargs.get("prefix_cache", True):
            raise ValueError(
                "PrefillWorker requires prefix_cache=True: the handoff "
                "rides the content-addressed hash chain")
        self._handoff = handoff
        self.handoffs = 0
        super().__init__(ff, host_tier=host_tier, **kwargs)

    def _on_prefill_complete(self, slot: int):
        req = self._active[slot]
        self._close_canary(req)
        # with the first token appended, publish so every FULL page is
        # hash-registered — spill_request only moves registered pages
        self._publish_tail(req)
        req.spilled_pages += self.pool.spill_request(req.pages)
        self.pool.free(list(reversed(req.pages)))  # leaf-first
        req.pages = []
        self._reset_prefill_state(req)
        self._tables[slot] = 0
        self._mark_tables_dirty()
        self._mark_temps_dirty()
        self._active[slot] = None
        if slot in self._admit_order:
            self._admit_order.remove(slot)
        self.handoffs += 1
        try:
            self._handoff(req)
        except BaseException as e:  # decode worker stopped mid-handoff
            if not req.future.done():
                req.future.set_exception(e)


class DisaggPair:
    """One disaggregated serving unit: PrefillWorker + decode-side
    PagedGenerationServer sharing a HostTier, presented through the
    single-server submit()/generate()/stop() surface. Both pools must
    store the same kv dtype (the tier moves raw payloads), so the pair
    constructor configures both sides from one set of knobs."""

    def __init__(self, ff, *, tier_pages: int = 1024,
                 host_tier: Optional[HostTier] = None,
                 prefill_slots: Optional[int] = None,
                 prefill_num_pages: Optional[int] = None,
                 decode_num_pages: Optional[int] = None,
                 **kwargs):
        self.host_tier = (host_tier if host_tier is not None
                          else HostTier(tier_pages))
        if not kwargs.get("prefix_cache", True):
            raise ValueError("DisaggPair requires prefix_cache=True")
        decode_kw = dict(kwargs)
        decode_kw["num_pages"] = decode_num_pages or kwargs.get("num_pages")
        self.decode = PagedGenerationServer(
            ff, host_tier=self.host_tier, **decode_kw)
        prefill_kw = dict(kwargs)
        prefill_kw["num_pages"] = (prefill_num_pages
                                   or kwargs.get("num_pages"))
        if prefill_slots is not None:
            prefill_kw["slots"] = prefill_slots
        self.prefill = PrefillWorker(
            ff, handoff=self.decode.submit_request,
            host_tier=self.host_tier, **prefill_kw)

    # -- single-server surface -------------------------------------------

    def submit(self, prompt_ids, max_new_tokens: int,
               temperature: float = 0.0):
        return self.prefill.submit(prompt_ids, max_new_tokens, temperature)

    def submit_request(self, req: _GenRequest):
        return self.prefill.submit_request(req)

    @property
    def pool(self):
        """Admission-side pool — what a fronting router inspects for
        page pressure and chain hashes."""
        return self.prefill.pool

    @property
    def request_log(self):
        """Decode-side reqlog: requests COMPLETE on the decode worker,
        so that is where the service-time records live."""
        return self.decode.request_log

    def generate(self, prompt_ids, max_new_tokens: int,
                 temperature: float = 0.0):
        return self.submit(prompt_ids, max_new_tokens,
                           temperature).result()

    def stop(self):
        # prefill first: no new handoffs can arrive at a live decode
        # queue after its producer is down
        self.prefill.stop()
        self.decode.stop()

    @property
    def handoffs(self) -> int:
        return self.prefill.handoffs

    def metrics(self) -> Dict:
        return {
            "prefill": self.prefill.metrics(),
            "decode": self.decode.metrics(),
            "host_tier": self.host_tier.metrics(),
            "handoffs": self.prefill.handoffs,
        }
