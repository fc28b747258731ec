"""Continuous-batching scheduler over the paged KV cache (counterpart of
flexflow_tpu/paged/scheduler.py).

Admission is by FREE-PAGE BUDGET: a request is admitted when a decode slot
is free AND the pool can hold its prompt's pages; it grows one page at a
time as it decodes; page pressure preempts the youngest other request
(its pages are freed and it requeues at the FRONT of the queue, to
re-prefill prompt + generated prefix). EOS/max-new free pages and slot
at once. All bookkeeping is host numpy; the step sees only int32 page
tables and positions.

PREFIX CACHING (prefix_cache=True, the default): admission first maps the
longest content-addressed prefix of the prompt from the pool's hash
index (paged/pool.py) — full pages are SHARED by refcount, a partially
filled tail page is cloned copy-on-write — and only the uncached suffix
is computed. Completed and preempted requests leave their pages behind
as dead-but-cached LRU entries, so a preempted request's resume
re-attaches its own K/V instead of recomputing it.

CHUNKED PREFILL inside the decode loop: at most `prefill_chunk` prompt
tokens per tick, packed into window pieces of at most PREFILL_WINDOW_ROWS
rows. Every model call is the ONE ragged step (Executor.ragged_step_fn):
a tick assembles work items — decode rows and prefill chunk pieces —
into a (B, S) launch whose per-item descriptor (pos, q_len, depths, anc)
says which rows are live. Items padded to the launch shape carry q_len 0;
the attention kernel skips them and their K/V writes go to the null page.
Splitting a chunk into pieces is sound because every item's K/V rows are
written into the pool BEFORE attention runs at each layer, so piece i+1
sees piece i's rows as committed.

POOL DTYPES (kv_dtype): "auto" pools at the model's dtype; "bf16", "fp16",
"fp32" are plain storage casts; "int8" stores quantized pages with a
per-(page, kv head) fp32 scale sidecar in the same per-node dict
(paged/quant.py), so the copy-on-write clone and the defrag permutation
move scales with their pages by construction, and pages coming off the
free list get their scales zeroed.

Decode flow per tick:
  1. defrag if requested (one gather per cache buffer, between ticks)
  2. admit queued requests into free slots while pages last (FIFO;
     preempted requests re-enter ahead of the queue); admission maps
     prefix-cache hits and allocates the remaining pages — no model run
  3. grow: decoding slots whose next write position crosses a page
     boundary allocate a page, preempting under pressure
  4. one packed prefill launch for the mid-prefill slots (the chunk that
     finishes a prompt samples its first token)
  5. one ragged decode launch for the decoding slots
  6. sample, append, publish freshly filled pages, finish/free

`ragged_pack=False` keeps the kernel but reverts to one launch a
mid-prefill slot at _bucket(take) rows (8, 16, 32, 64): the baseline the
padded-row share (`padding_waste_ratio` in metrics()) is judged against.
Tokens are identical either way.

DECODE MEGASTEPS (megastep_ticks=N > 1): a pure-decode tick (no slot
mid-prefill) runs up to N decode ticks from device-resident state
(Executor.paged_megastep_fn) and reads the (N, slots) token buffer, the
finish flags and the tick count back in ONE transfer; the host then
replays its bookkeeping token by token in the one-tick order. The
megastep stops where the one-tick loop would resume the host: after a
slot finishes, or before a write row past a slot's pages. The host knows
every stop but an eos in advance and enqueues exactly that many ticks; an
eos sampled mid-megastep predicates the rest off on the device, and the
generator is set back to where the one-tick loop would have left it.

UNIVERSAL MEGASTEPS (megastep_mixed=True): every tick is one dispatch of
up to N fused ticks (Executor.paged_mixed_megastep_fn) that carries the
decode rows, the mid-prefill chunk rows (at most min(8, prefill_chunk)
rows a slot a tick) and, on the speculative server, device-drafted
chains, all fed from a device-resident ledger of committed tokens. It
hands control back after a chunk completes (`chunk`), when a drafting
slot's next chain would cross its pages (`verify`), and for the decode
megastep's reasons. A completing prefill's first token comes from the
tick's own draw, so fixed-seed sampled tokens do not depend on N (they
differ from the unfused loop's, as in the reference). The host enqueues
the ticks it can prove may run, a drafting row counted at one token a
tick; a tick the device's condition refuses is predicated off.
`overlap_dispatch=True` runs admission (free slots and free pages only)
after the fused ticks are enqueued and before their one read back.

HOST KV TIER (host_tier=capacity or a shared disagg.HostTier): LRU
evictions SPILL full pages (every cache leaf's row, an int8 pool's scales
included) into host memory under their chain hashes, and admission's
lookup fetches a spilled prefix back into a fresh page. A spill is one
gather of the page's bytes and one copy to host (one sync a page); a fetch
writes the rows back from pinned memory without a sync. A tier shared by
two servers is the prefill/decode handoff channel (disagg/workers.py).

KV QUANT CANARY (kv_quant_canary=N, or FF_TPU_KV_QUANT_CANARY): every Nth
admission opens a window in which an fp32 SHADOW of the pool (the int8
pool dequantized, another pool cast) replays every launch; the running max
abs delta of the probabilities over live rows stays on the device and is
read only by metrics() (the kv_quant_error gauge, a breach counted once a
crossing of the catalog's "kv-canary-shadow-delta" band). The window
closes when its request leaves (finish, preemption) or a tier fetch
rewrites the pool behind the shadow; while it is open the megasteps stand
down to the one-tick path. FF_TPU_KV_QUANT_DEBUG=1 on an int8 pool keeps
the shadow for every launch of the server's life and forces
megastep_ticks=1 and megastep_mixed=False.

TRACING (obs.enable()): the tick phases run inside obs spans (tick_prep,
defrag, admit_pending, idle_wait, prefill_tick, decode_tick, megastep,
overlap_admit) and record their host wall times in the tick ledger
(prefill / decode shape keys). A span stamps the host clock around work
already enqueued and never reads the device.

DRAIN-AND-SWAP (serving_autopilot.py): detach_for_swap() stops the loop
and hands back every live and waiting request with its future pending
(_detach_active publishes and frees a live request's pages); a successor
built with defer_start=True loads its K3 body (warm_launch_shapes()),
adopts this pool
when the geometry matches (adopt_pool_from), takes the requests with
absorb_requests() and starts. Every server carries the ServeStrategy it
runs (derived from its knobs when none was passed), whose fingerprint
stamps its reqlog records.

Speculative decoding is the subclass in spec/server.py.
"""

from __future__ import annotations

import logging
import os
import queue
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from flexflow_tpu_torch import obs
from flexflow_tpu_torch.analysis.num_budgets import tolerance
from flexflow_tpu_torch.paged.pool import EMPTY_HASH, PagePool
from flexflow_tpu_torch.paged.quant import (
    dequantize_pages,
    is_quantized_dtype,
    resolve_kv_dtype,
)
from flexflow_tpu_torch.serving import (
    _GenerationServerBase,
    _GenRequest,
    pick_tokens,
)

_log = logging.getLogger(__name__)

# Packed prefill windows are capped at this many rows.
PREFILL_WINDOW_ROWS = 8


def copy_page(caches, src: int, dst: int):
    """Copy-on-write clone of one pool page, in place: every leaf of every
    node's dict (an int8 pool's scale sidecar included) gets row `src`
    copied into row `dst`."""
    for bufs in caches.values():
        for b in bufs.values():
            b[dst].copy_(b[src])


def reset_page_scales(caches, pages: List[int]):
    """Zero the scale-sidecar entries of `pages`, in place (a no-op on a
    pool without scales)."""
    for bufs in caches.values():
        for name, b in bufs.items():
            if name.endswith("_scale"):
                b[pages] = 0.0


def shadow_snapshot(caches):
    """An fp32 copy of the pool, coherent with what it holds: an int8
    pool's pages dequantized with their scales (the sidecar leaves drop),
    any other pool cast. Divergence measured from here on is pure
    quantization drift."""
    out = {}
    for key, bufs in caches.items():
        out[key] = {n: (dequantize_pages(b, bufs[n + "_scale"])
                        if n + "_scale" in bufs
                        else b.to(torch.float32, copy=True))
                    for n, b in bufs.items() if not n.endswith("_scale")}
    return out


class PagedGenerationServer(_GenerationServerBase):
    """Continuous batching over the block-paged KV cache
    (serve_generation(..., paged=True)). Device memory scales with the
    page pool instead of slots x max_len, shared prompt prefixes are
    stored once, and page pressure preempts instead of refusing."""

    def __init__(self, ff, slots: int = 4, max_len: int = 512,
                 eos_id: Optional[int] = None, seed: int = 0,
                 page_size: int = 64, num_pages: Optional[int] = None,
                 preemption: bool = True, prefix_cache: bool = True,
                 table_slack_tokens: int = 0, prefill_chunk: int = 64,
                 ragged_pack: bool = True, megastep_ticks: int = 1,
                 megastep_mixed: bool = False,
                 overlap_dispatch: bool = False, kv_dtype: str = "auto",
                 host_tier=None, kv_quant_canary: Optional[int] = None,
                 request_record_limit: Optional[int] = None,
                 reqlog_capacity: Optional[int] = None, slo=None,
                 slo_dump_dir: Optional[str] = None,
                 serve_strategy=None, defer_start: bool = False):
        self.megastep_ticks = int(megastep_ticks)
        if self.megastep_ticks < 1:
            raise ValueError(
                f"megastep_ticks must be >= 1, got {megastep_ticks}")
        self.megastep_mixed = bool(megastep_mixed)
        self.overlap_dispatch = bool(overlap_dispatch)
        if self.overlap_dispatch and not self.megastep_mixed:
            raise ValueError(
                "overlap_dispatch overlaps host work with the in-flight "
                "MIXED megastep dispatch; pass megastep_mixed=True")
        self.ragged_pack = bool(ragged_pack)
        self.kv_dtype = str(kv_dtype)
        pool_dt = resolve_kv_dtype(self.kv_dtype)  # validates the name
        self._quantized = pool_dt is not None and is_quantized_dtype(pool_dt)
        # FF_TPU_KV_QUANT_DEBUG=1 keeps an fp32 shadow of an int8 pool for
        # the server's life and replays every launch against it; the
        # shadow must observe every tick, so the megasteps are forced off
        self._kv_quant_debug = (self._quantized and os.environ.get(
            "FF_TPU_KV_QUANT_DEBUG") == "1")
        if self._kv_quant_debug and self.megastep_ticks > 1:
            _log.info("FF_TPU_KV_QUANT_DEBUG=1: forcing megastep_ticks=1 "
                      "so the fp32 shadow cache observes every tick")
            self.megastep_ticks = 1
        if self._kv_quant_debug and self.megastep_mixed:
            _log.info("FF_TPU_KV_QUANT_DEBUG=1: forcing megastep_mixed="
                      "False so the fp32 shadow cache observes every launch")
            self.megastep_mixed = False
            self.overlap_dispatch = False
        if kv_quant_canary is None:
            kv_quant_canary = int(
                os.environ.get("FF_TPU_KV_QUANT_CANARY", "0") or 0)
        if kv_quant_canary < 0:
            raise ValueError(
                f"kv_quant_canary must be >= 0, got {kv_quant_canary}")
        super().__init__(ff, slots, max_len, eos_id, seed,
                         request_record_limit=request_record_limit,
                         reqlog_capacity=reqlog_capacity, slo=slo,
                         slo_dump_dir=slo_dump_dir,
                         serve_strategy=serve_strategy)
        self.page_size = int(page_size)
        # table_slack_tokens widens every page table past max_len: the
        # speculative verify writes its draft tree's rows past the
        # committed head, so the table addresses max_len + max_nodes rows
        # though pos never passes max_len
        self.max_pages_per_seq = -(-(self.max_len + int(table_slack_tokens))
                                   // self.page_size)
        if num_pages is None:
            # the dense layout's capacity (+ the null page); size it DOWN
            # to oversubscribe slots, and preemption absorbs the pressure
            num_pages = self.slots * self.max_pages_per_seq + 1
        self.pool = PagePool(num_pages, self.page_size,
                             self.max_pages_per_seq)
        self.preemption = bool(preemption)
        self.prefix_cache = bool(prefix_cache)
        self.prefill_chunk = max(1, int(prefill_chunk))
        self._chunk_rows = PREFILL_WINDOW_ROWS
        ex = ff.executor
        self._step = ex.ragged_step_fn
        self._megastep = ex.paged_megastep_fn
        self._mixed_fn = ex.paged_mixed_megastep_fn
        # the universal megastep's launch: chunk pieces of at most the
        # packed window, drafted chains of depth + 1 rows (depth 0 on the
        # plain server; the speculative one sets `spec` before this)
        spec_cfg = getattr(self, "spec", None)
        self._spec_depth = int(spec_cfg.depth) if spec_cfg is not None \
            else 0
        self._mixed_window = min(self._chunk_rows, self.prefill_chunk)
        self._caches = ex.init_paged_kv_cache(num_pages, self.page_size,
                                              dtype=pool_dt)
        # the fp32 shadow pool: for the server's life under the debug
        # flag, else only inside a canary window (_maybe_open_canary);
        # the running max abs probability delta stays on the device
        self._caches_ref = (ex.init_paged_kv_cache(
            num_pages, self.page_size, dtype=torch.float32)
            if self._kv_quant_debug else None)
        self._quant_err_dev = torch.zeros((), dtype=torch.float32,
                                          device=self.device)
        self.kv_quant_canary = (0 if self._kv_quant_debug
                                else int(kv_quant_canary))
        self._canary_admits = 0
        self._canary_req: Optional[_GenRequest] = None
        self._c_canary = self.registry.counter(
            "kv_quant_canary_windows_total")
        self._g_qerr = self.registry.gauge("kv_quant_error")
        self._g_qerr.set(0.0)
        # the canary is a watchdog: its alert band is the catalog's, and
        # the running max crossing it counts one breach and logs once
        self.kv_quant_threshold = float(tolerance("kv-canary-shadow-delta"))
        self._quant_breached = False
        self._c_qbreach = self.registry.counter(
            "kv_quant_canary_breaches_total")
        # the host KV tier (an int capacity for a private tier, or a
        # HostTier shared with another server: the disagg handoff
        # channel); its payload layout is the caches dict's, fixed
        # for the pool's life
        self.host_tier = None
        self._payload_layout = None
        if host_tier is not None and host_tier != 0:
            from flexflow_tpu_torch.disagg.host_tier import HostTier

            if self._kv_quant_debug:
                raise ValueError(
                    "host_tier and FF_TPU_KV_QUANT_DEBUG=1 are mutually "
                    "exclusive: the all-ticks fp32 shadow cannot observe "
                    "pages restored behind its back")
            self.host_tier = (host_tier if isinstance(host_tier, HostTier)
                              else HostTier(int(host_tier)))
            self.pool.attach_tier(self.host_tier, self._tier_read_page,
                                  self._tier_write_page)
        # spill/fetch counters (synced from the pool's truth by metrics())
        # and the tier's occupancy and fetch-latency gauges
        self._c_spill = self.registry.counter("kv_spill_pages_total")
        self._c_fetch = self.registry.counter("kv_fetch_pages_total")
        self._g_tier_occ = self.registry.gauge("host_tier_occupancy_pages")
        self._g_tier_ratio = self.registry.gauge("host_tier_occupancy_ratio")
        self._g_tier_lat = self.registry.gauge("host_tier_fetch_latency_s")
        self._tables = np.zeros((self.slots, self.max_pages_per_seq),
                                np.int32)
        # device mirrors of host state, uploaded again only once a write
        # marked them dirty (None): the page tables (admission, growth,
        # release, defrag), the slots' temperatures (occupancy), and the
        # universal megastep's (slots, Lbuf + 1) token ledger (occupancy;
        # between its dispatches the megastep's own output is reused)
        self._seq_cols = self.max_pages_per_seq * self.page_size
        self._tables_dev: Optional[torch.Tensor] = None
        self._temps_dev: Optional[torch.Tensor] = None
        self._seq_dev: Optional[torch.Tensor] = None
        self._chain_desc_cache: Dict[Tuple[int, int], tuple] = {}
        self._admit_order: List[int] = []  # live slots, oldest first
        self._requeue: List[_GenRequest] = []  # preempted, ahead of queue
        self._defrag_req = threading.Event()
        self.preemptions = 0
        self.defrags = 0
        self.peak_active = 0
        self.prefill_ticks = 0
        # ragged steps run: each launches the attention kernel once per
        # attention layer; and the canary's replays of them on the shadow
        self.ragged_steps = 0
        self.shadow_steps = 0
        self._prefill_rr = 0    # rotating start slot for the chunk budget
        # the registry's counters, all summed on the host from what the
        # loop already knows (no device read): ticks the loop slept with
        # nothing live or admitted and the seconds asleep; launch rows
        # shipped and those of them that were padding (q_len 0 entries,
        # rows past an entry's q_len), the last launch's padded share;
        # ticks a megastep ran, host round trips of the decode path (a
        # one-tick decode or a megastep each pay one) and the tokens they
        # decoded, why each megastep handed control back; and the share
        # of the wait on a mixed dispatch that overlapped host work
        self._c_idle = self.registry.counter("idle_ticks_total")
        self._c_idle_s = self.registry.counter("idle_wait_seconds_total")
        self._c_rows = self.registry.counter("launch_rows_total")
        self._c_pad = self.registry.counter("padded_rows_total")
        self._g_waste = self.registry.gauge("padding_waste_ratio")
        self._h_mega = self.registry.histogram("megastep_ticks",
                                               obs.COUNT_BUCKETS)
        self._c_rt = self.registry.counter("host_roundtrips_total")
        self._c_dtok = self.registry.counter("decode_tokens_total")
        self._g_rt_tok = self.registry.gauge("host_roundtrips_per_token")
        self._c_break = {
            r: self.registry.counter(f"megastep_break_{r}_total")
            for r in ("finish", "page", "limit", "chunk", "verify")}
        self._g_overlap = self.registry.gauge("host_overlap_ratio")
        # dispatches, ticks run and the ticks enqueued that the device
        # predicated off
        self.megastep_dispatches = 0
        self.megastep_ticks_run = 0
        self.megastep_wasted_ticks = 0
        if self.serve_strategy is None:
            # derived from the knobs as they stand (after the debug flag's
            # adjustments), so the fingerprint names what this server runs
            self.serve_strategy = self._derive_strategy()
        self._start(defer_start)

    def shape_config(self) -> dict:
        """The knobs that decide which launches this server can dispatch:
        the pool geometry, the prefill packing, the megastep modes and the
        storage dtype (the speculative server adds its tree): the
        reference's enumerate_catalog kwargs. The shapecheck catalog that
        reads them waits for ROADMAP.md queue 1 item 13."""
        return {
            "slots": self.slots, "max_len": self.max_len, "paged": True,
            "page_size": self.page_size,
            "prefill_chunk": self.prefill_chunk,
            "ragged_pack": self.ragged_pack,
            "megastep_ticks": self.megastep_ticks,
            "megastep_mixed": self.megastep_mixed,
            "num_pages": self.pool.num_pages,
            "kv_dtype": self.kv_dtype,
            "window_rows": self._chunk_rows,
        }

    # -- capacity and metrics ----------------------------------------------

    def _peak_rows(self, prompt_len: int, max_new_tokens: int) -> int:
        """Cache rows a request touches at its deepest point (subclass
        hook: the speculative verify adds its tree's scratch rows)."""
        return prompt_len + max_new_tokens

    def _check_capacity(self, prompt: np.ndarray, max_new_tokens: int):
        super()._check_capacity(prompt, max_new_tokens)
        need = self.pool.pages_for(self._peak_rows(len(prompt),
                                                   max_new_tokens))
        if need > self.pool.capacity:
            raise ValueError(
                f"request needs {need} pages at its longest "
                f"({len(prompt)}+{max_new_tokens} tokens, page_size="
                f"{self.page_size}) but the pool only holds "
                f"{self.pool.capacity}; raise num_pages")

    def _kv_pool_dtype_name(self) -> str:
        """The pool's storage dtype name ("int8" for a quantized pool)."""
        kbuf = next(iter(self._caches.values()))["k"]
        return str(kbuf.dtype).replace("torch.", "")

    # -- request log (obs.reqlog) ------------------------------------------

    def _prefix_chain(self, req: _GenRequest) -> tuple:
        """The pool's sha1 chain over the prompt's page-aligned blocks:
        entry i content-addresses the whole prefix through block i, so
        two records share a chain prefix iff their prompts shared those
        pages."""
        return tuple(self.pool.chain_hashes(req.prompt))

    def _reqlog_kv_dtype(self) -> str:
        return self._kv_pool_dtype_name()

    def _reqlog_record(self, req: _GenRequest, m: dict,
                       done_t: float) -> dict:
        rec = super()._reqlog_record(req, m, done_t)
        rec["page_size"] = self.page_size
        return rec

    def metrics(self) -> dict:
        """Aggregate serving metrics and the per-request records, plus
        pool occupancy and fragmentation and the prefix-cache counters."""
        m = super().metrics()
        pool = self.pool
        m.update({
            "preemptions": self.preemptions,
            "defrags": self.defrags,
            "peak_active": self.peak_active,
            "page_size": self.page_size,
            "num_pages": pool.num_pages,
            "pages_in_use": pool.pages_in_use,
            "free_pages": pool.free_pages,
            "cached_pages": pool.cached_pages,
            "pool_occupancy": pool.pages_in_use / pool.capacity,
            "fragmentation": pool.fragmentation(),
            "prefill_ticks": self.prefill_ticks,
            "ragged_steps": self.ragged_steps,
            "kv_cache_dtype": self._kv_pool_dtype_name(),
            "kv_quant_error": self._kv_quant_error(),
            "kv_quant_canary": {
                "every": self.kv_quant_canary,
                "debug_mode": self._kv_quant_debug,
                "windows": int(self._c_canary.value),
                "window_open": (self._canary_req is not None
                                or self._kv_quant_debug),
                "threshold": self.kv_quant_threshold,
                "breaches": int(self._c_qbreach.value),
            },
            "launch_rows": int(self._c_rows.value),
            "padded_rows": int(self._c_pad.value),
            "padding_waste_ratio": (
                self._c_pad.value / self._c_rows.value
                if self._c_rows.value else 0.0),
            "megastep": {
                "ticks_max": self.megastep_ticks,
                "mixed": self.megastep_mixed,
                "overlap_dispatch": self.overlap_dispatch,
                "host_overlap_ratio": float(self._g_overlap.value),
                "host_roundtrips": int(self._c_rt.value),
                "decode_tokens": int(self._c_dtok.value),
                "host_roundtrips_per_token": (
                    self._c_rt.value / self._c_dtok.value
                    if self._c_dtok.value else 0.0),
                "dispatches": self.megastep_dispatches,
                "ticks_run": self.megastep_ticks_run,
                "wasted_ticks": self.megastep_wasted_ticks,
                "breaks": {r: int(c.value)
                           for r, c in self._c_break.items()},
            },
            "prefix_cache": {
                "enabled": self.prefix_cache,
                "hit_tokens": pool.hit_tokens,
                "miss_tokens": pool.lookup_tokens - pool.hit_tokens,
                "lookup_tokens": pool.lookup_tokens,
                "hits": pool.hits,
                "misses": pool.misses,
                "evictions": pool.evictions,
            },
        })
        # the tier block, and the registry synced at scrape time: the
        # counters follow THIS pool's spill/fetch truth (a shared tier's
        # totals add up both servers'), the gauges follow the tier
        self._c_spill.inc(pool.spilled_pages - self._c_spill.value)
        self._c_fetch.inc(pool.fetched_pages - self._c_fetch.value)
        tier = self.host_tier
        m["host_tier"] = {"enabled": tier is not None,
                          "spilled_pages": pool.spilled_pages,
                          "fetched_pages": pool.fetched_pages}
        if tier is not None:
            tm = tier.metrics()
            m["host_tier"].update(tm)
            self._g_tier_occ.set(tm["occupancy_pages"])
            self._g_tier_ratio.set(tm["occupancy_ratio"])
            self._g_tier_lat.set(tm["fetch_latency_s_avg"])
        return m

    def _kv_quant_error(self) -> float:
        """The running max abs probability delta against the fp32 shadow
        (0.0 until a window or the debug flag samples it). Read from the
        device only here, at scrape time, and only once a shadow launch
        has run, so the serving loop never waits for it (an SLO breach
        dumps metrics() from inside a tick); the first read past the
        band counts a breach and logs once (the running max only
        grows)."""
        err = float(self._quant_err_dev) if self.shadow_steps else 0.0
        self._g_qerr.set(err)
        if err > self.kv_quant_threshold and not self._quant_breached:
            self._quant_breached = True
            self._c_qbreach.inc()
            _log.warning(
                "kv_quant_error %.3g breached the kv-canary-shadow-delta "
                "budget %.3g (analysis/num_budgets.py): the quantized pool "
                "has drifted past its declared band vs the fp32 shadow",
                err, self.kv_quant_threshold)
        return err

    def request_defrag(self):
        """Ask the loop to compact the page pool between ticks (host
        bookkeeping + one device gather per cache buffer)."""
        self._defrag_req.set()

    # -- prefix-cache publication -------------------------------------------

    def _publish_prefix(self, req: _GenRequest, valid_rows: int):
        """Register every freshly FILLED page (all page_size rows hold
        committed K/V) under its token-prefix chain hash, so concurrent
        and later requests sharing the prefix map it instead of
        recomputing. A no-op until a page boundary is crossed."""
        if not self.prefix_cache:
            return
        P = self.page_size
        target = min(valid_rows // P, len(req.pages))
        if req.hashed_blocks >= target:
            return
        chain = self.pool.chain_hashes(req.seq_tokens()[:target * P])
        for b in range(req.hashed_blocks, target):
            self.pool.register_full(req.pages[b], chain[b])
        req.hashed_blocks = target

    def _publish_tail(self, req: _GenRequest):
        """On prefill completion, release and preemption: publish the
        remaining full pages and the partially filled tail page, so a
        resume (or an identical prompt) re-attaches these rows instead of
        recomputing them."""
        if not self.prefix_cache or not req.pages:
            return
        P = self.page_size
        valid = max(req.pos, req.prefill_pos)
        self._publish_prefix(req, valid)
        full = req.hashed_blocks
        tail = valid - full * P
        if tail > 0 and full < len(req.pages):
            seq = req.seq_tokens()
            chain = self.pool.chain_hashes(seq[:full * P])
            parent = chain[-1] if chain else EMPTY_HASH
            self.pool.register_partial(req.pages[full], parent,
                                       seq[full * P:valid])

    # -- slot lifecycle -----------------------------------------------------

    def _reset_prefill_state(self, req: _GenRequest):
        req.pos = 0
        req.prefill_pos = 0
        req.prefill_target = 0
        req.prefill_seq = None
        req.hashed_blocks = 0

    def _maybe_open_canary(self, req: _GenRequest):
        """Every `kv_quant_canary`-th successful admission opens a shadow
        window on that request: the shadow becomes an fp32 snapshot of
        the CURRENT pool, so _launch's replay measures the divergence
        accrued from this admission on. One window at a time; the
        megasteps stand down while one is open."""
        if not self.kv_quant_canary:
            return
        self._canary_admits += 1
        if (self._canary_admits % self.kv_quant_canary == 0
                and self._caches_ref is None):
            self._caches_ref = shadow_snapshot(self._caches)
            self._canary_req = req
            self._c_canary.inc()

    def _close_canary(self, req: _GenRequest):
        """Drop the shadow window when its request leaves (finish,
        cancellation or preemption: a preempted request's replay would
        resume against a stale shadow)."""
        if self._canary_req is req:
            self._canary_req = None
            self._caches_ref = None

    def _free_pages_of(self, slot: int, req: _GenRequest):
        """Publish what the request wrote, then drop its page references
        LEAF-first: a chain lookup stops at its first missing block, so
        under pressure the LRU must reclaim tail pages before the roots
        every shared prefix runs through. A canary window on the request
        closes."""
        self._close_canary(req)
        self._publish_tail(req)
        self.pool.free(list(reversed(req.pages)))
        req.pages = []
        self._tables[slot] = 0
        self._mark_tables_dirty()
        self._mark_temps_dirty()
        if slot in self._admit_order:
            self._admit_order.remove(slot)

    def _release_slot(self, slot: int, req: _GenRequest,
                      completed: bool = False):
        self._free_pages_of(slot, req)
        super()._release_slot(slot, req, completed)

    def _evict(self, slot: int):
        """Preempt: free the victim's pages and requeue it at the front;
        its future stays pending. With the prefix cache on, the freed
        pages stay content-addressed on the LRU dead list, so the resume
        re-attaches them and recomputes only what was evicted in
        between."""
        req = self._active[slot]
        self._free_pages_of(slot, req)
        self._reset_prefill_state(req)
        self._active[slot] = None
        req.preemptions += 1
        self.preemptions += 1
        self._requeue.insert(0, req)

    # -- drain-and-swap (serving_autopilot) ----------------------------------

    def _derive_strategy(self):
        """The ServeStrategy this server runs, read from its knobs: for a
        server built without one, so reqlog stamping and the autopilot's
        window segmentation work on hand-built servers too. A page (or
        chunk) wider than max_len behaves as one clamped to it, and is
        clamped so the strategy passes its own validate()."""
        from flexflow_tpu_torch.search.servesearch import ServeStrategy

        spec = getattr(self, "spec", None)
        dense_pages = self.slots * self.max_pages_per_seq
        frac = (1.0 if self.pool.num_pages >= dense_pages + 1
                else max((self.pool.num_pages - 1) / dense_pages, 1e-6))
        return ServeStrategy(
            page_size=min(self.page_size, self.max_len),
            prefill_chunk=min(self.prefill_chunk, self.max_len),
            spec_width=(spec.width if spec is not None else 0),
            spec_depth=(spec.depth if spec is not None else 0),
            megastep_ticks=self.megastep_ticks,
            megastep_mixed=self.megastep_mixed,
            overlap_dispatch=self.overlap_dispatch,
            ragged_pack=self.ragged_pack,
            pool_fraction=round(frac, 6),
            kv_dtype=self.kv_dtype,
        )

    def _detach_active(self) -> List[_GenRequest]:
        """The carry-over side of detach_for_swap(): every live request
        leaves its slot with its future untouched. Its pages are published
        to the prefix cache (tail included) and freed leaf first, and a
        canary window on it closes, so a successor that adopts this pool
        re-attaches what survives the LRU and recomputes only the rest.
        Not a preemption: no counter moves. The preempted requests waiting
        to resume follow, in their order."""
        carried: List[_GenRequest] = []
        for slot in list(self._admit_order):
            req = self._active[slot]
            self._free_pages_of(slot, req)
            self._reset_prefill_state(req)
            self._active[slot] = None
            carried.append(req)
        carried.extend(self._requeue)
        self._requeue.clear()
        return carried

    def absorb_requests(self, reqs: List[_GenRequest]):
        """Seed this not-yet-started server (defer_start=True) with the
        requests a predecessor's detach_for_swap() carried out. They go
        to the FRONT of the admission order, ahead of anything submitted
        here directly, so in-flight work resumes first after cutover."""
        if self._thread.ident is not None:
            raise RuntimeError(
                "absorb_requests() requires a server whose loop has not "
                "started (construct with defer_start=True)")
        self._requeue[:0] = list(reqs)

    def warm_launch_shapes(self) -> List[str]:
        """Build (where the checkout has no build yet) and bind the K3
        body this server's pool takes, before its loop starts: the
        drain-and-swap warm-up. The reference compiles every jit launch
        shape of its shapecheck catalog here; a CUDA launch needs no
        compile per shape, and running one step of each tick kind on
        scratch pages first left the successor's first tick as it was
        (chip_smoke.py phase 23c's swap probe). On the CPU the plain
        version runs and nothing is loaded. Returns the kernels readied."""
        if self._thread.ident is not None:
            raise RuntimeError(
                "warm_launch_shapes() runs before the loop starts "
                "(construct with defer_start=True)")
        if self.device.type != "cuda":
            return []
        from flexflow_tpu_torch.kernels import (
            RAGGED_PAGED_ATTENTION,
            RAGGED_PAGED_ATTENTION_INT8,
        )

        kernel = (RAGGED_PAGED_ATTENTION_INT8 if self._quantized
                  else RAGGED_PAGED_ATTENTION)
        kernel.function()
        return [kernel.name]

    # -- host-tier payloads (disagg/host_tier.py) ----------------------------

    def _page_layout(self):
        """[(node key, leaf name, row shape, dtype, byte offset, bytes)]
        of one page's rows across every leaf of the pool (an int8 pool's
        scales included), and the total bytes: the layout of a tier
        payload, fixed for the pool's life."""
        if self._payload_layout is None:
            layout, off = [], 0
            for key, bufs in self._caches.items():
                for name, b in bufs.items():
                    nbytes = b[0].numel() * b.element_size()
                    layout.append((key, name, tuple(b.shape[1:]), b.dtype,
                                   off, nbytes))
                    off += nbytes
            self._payload_layout = (layout, off)
        return self._payload_layout

    def _tier_read_page(self, page: int):
        """Snapshot one pool page to host: the page's rows of every leaf
        (its scales too, so scales travel with their page) gathered into
        one contiguous byte buffer on the device and moved in ONE copy
        to host memory (pinned on the card), which waits for the writes
        the rows came from: one sync a spilled page. The payload keeps
        the caches dict's structure, each leaf a host view of that
        buffer."""
        layout, total = self._page_layout()
        rows = torch.cat([self._caches[key][name][page].reshape(-1)
                          .view(torch.uint8)
                          for key, name, *_ in layout])
        host = torch.empty(total, dtype=torch.uint8,
                           pin_memory=self.device.type == "cuda")
        host.copy_(rows)
        payload: Dict[str, Dict[str, torch.Tensor]] = {}
        for key, name, shape, dt, off, nbytes in layout:
            payload.setdefault(key, {})[name] = (
                host[off:off + nbytes].view(dt).reshape(shape))
        return payload

    def _write_payload(self, page: int, payload):
        """Copy a payload's rows into `page` of every leaf. From pinned
        memory the copies do not block the host; the host allocator
        keeps a pinned block until the copies reading it have run, so
        the payload may be dropped at once."""
        for key, bufs in payload.items():
            for name, rows in bufs.items():
                self._caches[key][name][page].copy_(rows, non_blocking=True)

    def _tier_write_page(self, page: int, payload):
        """Restore one spilled payload into a freshly allocated page. A
        fetch rewrites pool content behind any open canary shadow, so the
        window closes (the probe aborts rather than report a phantom
        divergence). The tier's fetch latency is the host time of the
        enqueue."""
        t0 = time.monotonic()
        self._write_payload(page, payload)
        if self._canary_req is not None:
            self._close_canary(self._canary_req)
        if self.host_tier is not None:
            self.host_tier.observe_fetch_seconds(time.monotonic() - t0)

    def adopt_pool_from(self, old: "PagedGenerationServer") -> bool:
        """Take over the predecessor's PagePool and device caches when the
        pool geometry and storage dtype are identical, so content-
        addressed prefix pages survive a server swap and carried requests
        re-attach instead of recomputing. Returns False on any mismatch
        (or when either side runs a shadow cache) and keeps the fresh
        pool — correct either way, just a colder start. Both loops must
        be quiescent: this server's not started (defer_start=True), the
        predecessor's stopped."""
        if self._thread.ident is not None:
            raise RuntimeError(
                "adopt_pool_from() requires a server whose loop has not "
                "started (construct with defer_start=True)")
        same = (self.page_size == old.page_size
                and self.pool.num_pages == old.pool.num_pages
                and self.max_pages_per_seq == old.max_pages_per_seq
                and self._kv_pool_dtype_name() == old._kv_pool_dtype_name()
                and self._caches_ref is None and old._caches_ref is None)
        if not same:
            return False
        self.pool = old.pool
        self._caches = old._caches
        return True

    def adopt_request_pages(self, src: "PagedGenerationServer",
                            req: _GenRequest) -> int:
        """Per-request page adoption on one device (generalizing
        adopt_pool_from's whole-pool swap): copy the FULL prefix pages
        `req`'s sequence has resident on `src` into this server's pool,
        registered under the same chain hashes and parked dead-cached, so
        this server's admission lookup re-attaches them. For a quiescent
        receiver (its loop not started, or the call made from its own
        loop thread); the live handoff goes through a shared HostTier
        (disagg/workers.py). Returns the pages adopted; a full pool or a
        dtype mismatch adopts fewer — the remainder recomputes."""
        if self._kv_pool_dtype_name() != src._kv_pool_dtype_name():
            return 0
        adopted = 0
        for h in self.pool.chain_hashes(req.seq_tokens()):
            if h in self.pool._full:
                continue
            page = src.pool._full.get(h)
            if page is None:
                break  # src's chain broke; nothing deeper is resident
            got = self.pool.alloc(1)
            if got is None:
                break
            self._write_payload(got[0], src._tier_read_page(page))
            self.pool.register_full(got[0], h)
            self.pool.free(got)  # registered: parks on the LRU dead list
            adopted += 1
        return adopted

    def _reset_page_scales(self, pages: List[int]):
        """Zero the scales of freshly ALLOCATED pages (int8 pools only),
        wherever pages come off the free list — admission's private pages
        and per-tick growth — so a page's grow-only scale lifetime starts
        at zero and no stale scale leaks across owners. LRU revivals skip
        this: a revived page keeps its content, so it keeps its scale."""
        if self._quantized and pages:
            reset_page_scales(self._caches, pages)

    def _admit(self, req: _GenRequest, slot: int) -> bool:
        """Map the longest cached prefix (shared full pages by refcount,
        copy-on-write clone of a matched partial tail), allocate private
        pages for the rest, and queue the uncached suffix for CHUNKED
        prefill. No model step runs here."""
        seq = req.seq_tokens()
        n = len(seq)
        P = self.page_size
        shared: List[int] = []
        cached = 0
        cow = None
        if self.prefix_cache:
            fetched0 = self.pool.fetched_pages
            shared, cached, cow = self.pool.lookup(seq)
            # host-tier fetches the lookup made count for THIS request
            # (the reqlog's fetched_pages; a disagg handoff lands so)
            req.fetched_pages += self.pool.fetched_pages - fetched0
        # always recompute at least the LAST prompt token: its forward
        # pass gives the first sampled token's distribution (the cache
        # stores K/V, not logits)
        start = min(cached, n - 1)
        b0 = start // P            # first block this request writes into
        keep = shared[:b0]
        # a shared page at or after the write boundary is cloned before
        # anyone writes into it: the partial-tail donor or, on a
        # page-aligned full-prompt hit, the last matched full page
        cow_src = cow if cow is not None else (
            shared[b0] if b0 < len(shared) else None)
        assert not shared[b0 + 1:], (shared, b0, cached, n)
        total = self.pool.pages_for(n)
        fresh = self.pool.alloc(total - b0)
        if fresh is None:
            # transient shortfall (LRU revival vs the conservative gate):
            # drop every cache hit, retry as a full recompute, and roll
            # the pool's hit counters back
            self.pool.free(keep + ([cow_src] if cow_src is not None
                                   else []))
            if cached > 0:
                self.pool.hit_tokens -= cached
                self.pool.hits -= 1
                self.pool.misses += 1
            keep, cached, cow_src = [], 0, None
            start, b0 = 0, 0
            fresh = self.pool.alloc(total)
            if fresh is None:
                self._push_back(req)
                return False
        if cached > start:
            # full-prompt hit: the clamped last prompt token is recomputed
            # for its logits, not served
            self.pool.hit_tokens -= cached - start
        pages = keep + fresh
        req.pages = pages
        req.peak_pages = max(req.peak_pages, len(pages))
        # fresh pages start a new scale lifetime BEFORE the COW clone, so
        # the clone's copied scale is not wiped
        self._reset_page_scales(fresh)
        self._tables[slot] = 0
        self._tables[slot, :len(pages)] = pages
        self._mark_tables_dirty()
        self._mark_temps_dirty()
        if cow_src is not None:
            copy_page(self._caches, cow_src, pages[b0])
            if self._caches_ref is not None:
                copy_page(self._caches_ref, cow_src, pages[b0])
            self.pool.free([cow_src])
        req.prefill_seq = seq
        req.prefill_pos = start
        req.prefill_target = n
        req.pos = 0
        req.hashed_blocks = min(b0, n // P)
        req.cached_prefill_tokens += start
        req.admit_t = time.monotonic()
        self._active[slot] = req
        self._admit_order.append(slot)
        self._maybe_open_canary(req)
        return True

    def _pop_next(self) -> Optional[_GenRequest]:
        if self._requeue:
            return self._requeue.pop(0)
        try:
            return self._queue.get_nowait()
        except queue.Empty:
            return None

    def _push_back(self, req: _GenRequest):
        self._requeue.insert(0, req)

    # -- page growth, preemption, defrag -------------------------------------

    def _pages_target(self, req: _GenRequest) -> int:
        """Pages a live slot must hold before the next tick: the page of
        its next write position (mid-prefill slots already hold their
        prompt's pages)."""
        return min(self.pool.pages_for(req.pos + 1), self.max_pages_per_seq)

    def _ensure_pages(self):
        """Before a tick, every live slot grows to its _pages_target; pool
        pressure preempts the youngest OTHER live request
        (`preemption=False` requeues the starved request itself — a
        stall, never a wrong answer)."""
        for slot in list(self._admit_order):
            req = self._active[slot]
            if req is None:
                continue
            target = self._pages_target(req)
            while req is self._active[slot] and len(req.pages) < target:
                got = self.pool.alloc(1)
                if got is not None:
                    self._reset_page_scales(got)
                    req.pages.append(got[0])
                    req.peak_pages = max(req.peak_pages, len(req.pages))
                    self._tables[slot, len(req.pages) - 1] = got[0]
                    self._mark_tables_dirty()
                    continue
                victims = [s for s in self._admit_order if s != slot]
                if self.preemption and victims:
                    self._evict(victims[-1])  # youngest other request
                else:
                    self._evict(slot)  # stall self until pages free up
                    break

    def _apply_defrag(self):
        """Compact the pool: the host bookkeeping (pool.defrag) and one
        gather per leaf of every node's dict, in place — an int8 pool's
        (num_pages, Hkv) scales permute on the same axis 0 as its pages.
        Every owner's table row and page list is rewritten through the
        one global old-to-new map, so shared pages stay shared."""
        perm, old_to_new = self.pool.defrag()
        perm_t = torch.from_numpy(perm.astype(np.int64)).to(self.device)
        for caches in (self._caches, self._caches_ref or {}):
            for bufs in caches.values():
                for b in bufs.values():
                    b.copy_(b[perm_t])
        self._tables = old_to_new[self._tables]
        self._mark_tables_dirty()
        for s in self._admit_order:
            req = self._active[s]
            if req is not None:
                req.pages = [int(old_to_new[p]) for p in req.pages]
        self.defrags += 1

    # -- scheduler loop -----------------------------------------------------

    def _admission_pages(self, req: _GenRequest) -> int:
        """Free pages required before admitting `req`: the prompt's rows
        plus the first decode tick's write row. Conservative: prefix-cache
        hits can only reduce what admission allocates."""
        return self.pool.pages_for(len(req.seq_tokens()) + 1)

    def _outstanding_growth(self) -> int:
        """Pages the live slots still need to reach their _pages_target:
        admission must not hand them out."""
        debt = 0
        for s in self._admit_order:
            req = self._active[s]
            if req is not None:
                debt += max(0, self._pages_target(req) - len(req.pages))
        return debt

    def _admit_pending(self) -> bool:
        """Admission: a free slot + the request's page budget (net of
        pages the live slots are still owed), FIFO — a head request too
        big for the pool blocks later ones, so nothing starves. Returns
        whether anything was admitted."""
        admitted = False
        for slot in range(self.slots):
            if self._active[slot] is not None:
                continue
            req = self._pop_next()
            if req is None:
                break
            if (self._admission_pages(req) + self._outstanding_growth()
                    > self.pool.free_pages):
                self._push_back(req)
                break
            if not self._admit(req, slot):
                break
            admitted = True
        return admitted

    def _live(self) -> List[int]:
        return [s for s in range(self.slots) if self._active[s] is not None]

    def _mid_prefill(self, slot: int) -> bool:
        req = self._active[slot]
        return req is not None and req.prefill_pos < req.prefill_target

    # -- device mirrors of host state ----------------------------------------

    def _mark_tables_dirty(self):
        """Every write to `self._tables` calls this: the device copy is
        uploaded again at its next use, never a tick."""
        self._tables_dev = None

    def _mark_temps_dirty(self):
        """Slot occupancy changed: the temperatures' device copy and the
        universal megastep's token ledger no longer match the host, and
        are rebuilt at their next use. (Page growth and defrag move
        pages, never tokens.)"""
        self._temps_dev = None
        self._seq_dev = None

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        """A host array's device copy, enqueued without a host sync; it
        copies from a private pageable copy, so the host may write `a`
        again at once."""
        return torch.from_numpy(np.array(a)).to(self.device,
                                                non_blocking=True)

    def _tables_device(self) -> torch.Tensor:
        """The (slots, max_pages) page tables on the device."""
        if self._tables_dev is None:
            self._tables_dev = self._upload(self._tables)
        return self._tables_dev

    def _temps_device(self) -> torch.Tensor:
        """The slots' sampling temperatures on the device (0.0, greedy,
        for an empty slot)."""
        if self._temps_dev is None:
            self._temps_dev = self._upload(np.array(
                [self._active[s].temperature if self._active[s] else 0.0
                 for s in range(self.slots)], np.float32))
        return self._temps_dev

    def _seq_device(self) -> torch.Tensor:
        """The universal megastep's (slots, Lbuf + 1) ledger of committed
        tokens on the device: row s holds slot s's prompt and generated
        tokens (a mid-prefill slot's whole prompt, which its chunk rows
        read), column Lbuf is the trash column of masked scatters.
        Between dispatches the megastep's own output is reused."""
        if self._seq_dev is None:
            seq = np.zeros((self.slots, self._seq_cols + 1), np.int32)
            for s in range(self.slots):
                req = self._active[s]
                if req is None:
                    continue
                toks = (req.prefill_seq if self._mid_prefill(s)
                        else req.seq_tokens())
                seq[s, :len(toks)] = toks
            self._seq_dev = self._upload(seq)
        return self._seq_dev

    def _chain_descriptor_device(self, B: int, window: int):
        """Cached device copies of the causal-chain descriptor for a
        (B, window) launch: depths 0..window-1 and the lower-triangular
        window visibility, identical every tick of the same shape."""
        key = (B, window)
        hit = self._chain_desc_cache.get(key)
        if hit is None:
            deps = np.tile(np.arange(window, dtype=np.int32), (B, 1))
            anc = np.tile(np.tril(np.ones((window, window), np.bool_)),
                          (B, 1, 1))
            hit = (torch.from_numpy(deps).to(self.device),
                   torch.from_numpy(anc).to(self.device))
            self._chain_desc_cache[key] = hit
        return hit

    def _launch(self, items, window, tr, ntr):
        """Run ONE ragged step over packed work items, each (slot, pos,
        tokens, depths, anc): `tokens` the item's q_len <= window live
        ids, depths/anc None for the causal chain (decode rows, chunk
        pieces) or the (window,) node depths and (window, window)
        ancestor relation of a drafted tree. Rows past an item's q_len are
        padding, counted in `padded_rows`. Returns the (len(items), window,
        vocab) probs."""
        B = len(items)
        ids = np.zeros((B, window), np.int32)
        pos = np.zeros((B,), np.int32)
        qls = np.zeros((B,), np.int32)
        slot_idx = np.zeros((B,), np.int64)
        chain = all(d is None and a is None for *_, d, a in items)
        if not chain:
            deps = np.tile(np.arange(window, dtype=np.int32), (B, 1))
            anc = np.tile(np.tril(np.ones((window, window), np.bool_)),
                          (B, 1, 1))
        for i, (slot, p, toks, d, a) in enumerate(items):
            ql = len(toks)
            ids[i, :ql] = toks
            pos[i] = p
            qls[i] = ql
            slot_idx[i] = slot
            if d is not None:
                deps[i] = d
            if a is not None:
                anc[i] = a
        dev = self.device
        if chain:
            deps_d, anc_d = self._chain_descriptor_device(B, window)
        else:
            deps_d = torch.from_numpy(deps).to(dev)
            anc_d = torch.from_numpy(anc).to(dev)
        # the tables ride their device mirror: the one-item-a-slot launch
        # takes it as it is, a packed one gathers its rows on the device
        tbl = self._tables_device()
        if not np.array_equal(slot_idx, np.arange(self.slots)):
            tbl = tbl[torch.from_numpy(slot_idx).to(dev)]
        pos_d = torch.from_numpy(pos).to(dev)
        qls_d = torch.from_numpy(qls).to(dev)
        ids_d = torch.from_numpy(ids).to(dev)
        probs, upd = self._step(tr, ntr, self._caches, tbl, pos_d, qls_d,
                                deps_d, anc_d, ids_d)
        self._caches = upd
        if self._caches_ref is not None:
            # the canary's replay: the same launch against the fp32
            # shadow; the running max abs probability delta over LIVE rows
            # stays on the device until metrics() reads it
            probs_ref, self._caches_ref = self._step(
                tr, ntr, self._caches_ref, tbl, pos_d, qls_d, deps_d, anc_d,
                ids_d)
            live_rows = (torch.arange(window, device=dev)[None, :]
                         < qls_d[:, None])
            delta = torch.max((probs.float() - probs_ref.float()).abs()
                              * live_rows[:, :, None])
            self._quant_err_dev = torch.maximum(self._quant_err_dev, delta)
            self.shadow_steps += 1
        self.ragged_steps += 1
        self._count_rows(B * window, B * window - int(qls.sum()))
        return probs

    def _count_rows(self, rows: int, padded: int):
        """Launch rows shipped and how many of them were padding."""
        self._c_rows.inc(rows)
        self._c_pad.inc(padded)
        self._g_waste.set(padded / rows if rows else 0.0)

    def _count_roundtrip(self, tokens: int):
        """One host round trip of the decode path, which bought `tokens`
        decoded tokens."""
        self._c_rt.inc()
        self._c_dtok.inc(tokens)
        if self._c_dtok.value:
            self._g_rt_tok.set(self._c_rt.value / self._c_dtok.value)

    def _tick_prep(self) -> Optional[List[int]]:
        """Defrag if requested, admit, grow pages. Returns the live slots
        (decoding AND mid-prefill), or None when nothing is live (sleeps
        briefly when nothing was admitted either)."""
        with obs.span("tick_prep") as sp:
            if self._defrag_req.is_set():
                self._defrag_req.clear()
                with obs.span("defrag"):
                    self._apply_defrag()
            with obs.span("admit_pending"):
                admitted = self._admit_pending()
            live = self._live()
            self.peak_active = max(self.peak_active, len(live))
            if sp:
                sp.set(live=len(live),
                       mid_prefill=sum(1 for s in live
                                       if self._mid_prefill(s)),
                       pages_in_use=self.pool.pages_in_use,
                       admitted=admitted)
            if not live:
                if not admitted:
                    # waiting for work is a span of its own, apart from
                    # real prep
                    t0 = time.monotonic()
                    with obs.span("idle_wait"):
                        time.sleep(0.001)
                    self._c_idle.inc()
                    self._c_idle_s.inc(time.monotonic() - t0)
                return None
            self._ensure_pages()  # may preempt: recompute live after
            return self._live() or None

    def _split_live(self, live):
        """(mid-prefill slots, decoding slots) for this tick."""
        pre = [s for s in live if self._mid_prefill(s)]
        dec = [s for s in live if not self._mid_prefill(s)]
        return pre, dec

    def _prefill_tick(self, slots, tr, ntr):
        """Advance mid-prefill slots by at most `prefill_chunk` tokens
        ACROSS the tick, starting from a slot that rotates tick to tick.
        With ragged_pack every slot's chunk is split into window pieces
        and the whole tick rides ONE packed launch; ragged_pack=False
        launches once a slot, at _bucket(take) rows. The chunk finishing
        a prompt publishes the prompt's tail page and samples the
        request's first token from its own last-row probs."""
        t0 = time.monotonic()
        sp = obs.span("prefill_tick").__enter__()
        budget = self.prefill_chunk
        self.prefill_ticks += 1
        rot = self._prefill_rr % len(slots)
        self._prefill_rr += 1
        slots = slots[rot:] + slots[:rot]
        plan = []  # (slot, req, start, take)
        for s in slots:
            if budget <= 0:
                break
            req = self._active[s]
            take = min(budget, req.prefill_target - req.prefill_pos)
            plan.append((s, req, req.prefill_pos, take))
            budget -= take
        if self.ragged_pack:
            items = []
            ends = []  # (item index, row) of each chunk's last piece
            W = min(self._chunk_rows, max(take for _, _, _, take in plan))
            for s, req, start, take in plan:
                for off in range(0, take, W):
                    piece = min(W, take - off)
                    items.append((s, start + off,
                                  req.prefill_seq[start + off:
                                                  start + off + piece],
                                  None, None))
                ends.append((len(items) - 1, (take - 1) % W))
            probs = self._launch(items, W, tr, ntr)
            rows = [probs[i:i + 1, r, :] for i, r in ends]
        else:
            rows = []
            for s, req, start, take in plan:
                probs = self._launch(
                    [(s, start, req.prefill_seq[start:start + take], None,
                      None)], self._bucket(take), tr, ntr)
                rows.append(probs[0:1, take - 1, :])
        for (s, req, start, take), row in zip(plan, rows):
            req.prefill_pos = start + take
            req.prefill_tokens += take
            self._publish_prefix(req, req.prefill_pos)
            if req.prefill_pos >= req.prefill_target:
                # publish the PROMPT's partial tail before decode appends
                # rows to the same page: the entry names only rows
                # [0, tail), which never change, so an identical or
                # extending prompt can clone this page while this
                # request keeps decoding into it
                self._publish_tail(req)
                self._sample_first_token(s, req, row)
                self._finish_if_done(s)
                if self._active[s] is not None:
                    self._on_prefill_complete(s)
        chunked = self.prefill_chunk - budget
        if sp:
            sp.set(slots=len(slots), chunk_tokens=chunked)
        sp.__exit__(None, None, None)
        dt = time.monotonic() - t0
        self._h_prefill.observe(dt)
        led = obs.ledger()
        if led is not None:
            led.record("prefill", dt, batch=len(slots), chunk=chunked)

    def _on_prefill_complete(self, slot: int):
        """Hook fired after a request's prefill completed (tail published,
        first token taken) and it did not finish on it. The server
        decodes in place and does nothing here."""

    def _count_decode_overlap(self):
        """A decode tick ran while these slots were mid-prefill."""
        for s in self._admit_order:
            if self._mid_prefill(s):
                self._active[s].decode_overlap_ticks += 1

    def _decode_tick(self, live, tr, ntr):
        """One single-token decode step for the decoding slots: one item
        per slot, q_len 1 for decoding slots and 0 for idle and
        mid-prefill ones, so probs stays slot-indexed."""
        t0 = time.monotonic()
        sp = obs.span("decode_tick").__enter__()
        if sp:
            sp.set(live=len(live), pages_in_use=self.pool.pages_in_use)
        dec = set(live)
        items = [(s, self._active[s].pos if s in dec else 0,
                  [int(self._tokens[s])] if s in dec else [], None, None)
                 for s in range(self.slots)]
        probs = self._launch(items, 1, tr, ntr)
        toks = pick_tokens(probs[:, -1, :], self._temps_device(),
                           self._gen).cpu().numpy()
        self._steps += 1
        self._count_roundtrip(len(live))
        self._count_decode_overlap()
        for s in live:
            req = self._active[s]
            req.pos += 1
            req.tokens.append(int(toks[s]))
            self._tokens[s] = toks[s]
            self._publish_prefix(req, req.pos)
            self._finish_if_done(s)
        sp.__exit__(None, None, None)
        dt = time.monotonic() - t0
        self._h_tick.observe(dt)
        self._h_tokens.observe(len(live))
        led = obs.ledger()
        if led is not None:
            led.record("decode", dt, batch=len(live))

    def _decode_megastep(self, live, tr, ntr):
        """Up to `megastep_ticks` decode ticks in one dispatch
        (Executor.paged_megastep_fn) for the decoding slots, with one
        transfer back: the (ticks, slots) token buffer, the finish flags
        and the tick count. The host enqueues exactly the ticks the
        reference's device loop would run but for an eos: up to the tick
        limit, to the last write row inside every live slot's pages, and
        to the tick where the first live slot emits its last token. Then
        it replays the bookkeeping
        (append, prefix publication, finish) token by token in the
        one-tick order, so page growth, admission, eviction and defrag
        stay between megasteps, and greedy and fixed-seed sampled tokens
        equal the one-tick loop's. While a canary window is open it stands
        down to the one-tick path, whose launches the shadow replays (a
        window opens on any admission, so this is decided a dispatch)."""
        if self._caches_ref is not None:
            return self._decode_tick(live, tr, ntr)
        t0 = time.monotonic()
        sp = obs.span("megastep").__enter__()
        if sp:
            sp.set(live=len(live), pages_in_use=self.pool.pages_in_use)
        N = self.megastep_ticks
        pos = np.zeros((self.slots,), np.int32)
        rem = np.zeros((self.slots,), np.int32)
        cap = np.zeros((self.slots,), np.int32)
        act = np.zeros((self.slots,), np.bool_)
        for s in live:
            req = self._active[s]
            pos[s] = req.pos
            rem[s] = req.max_new - len(req.tokens)
            cap[s] = len(req.pages) * self.page_size
            act[s] = True
        # >= 1: _ensure_pages gave every live slot the page of its next
        # write row, and a decoding slot has a token left to emit
        n = min(N, int((cap - pos)[act].min()), int(rem[act].min()))
        up = self._upload
        caches, out, done, ran, states = self._megastep(
            tr, ntr, self._caches, self._tables_device(), up(pos),
            up(self._tokens), self._temps_device(), up(rem), up(cap),
            up(act), self._gen, max_ticks=N, ticks=n, eos_id=self.eos_id)
        self._caches = caches
        # the ONE host transfer of the megastep
        back = torch.cat([out.reshape(-1), done.to(torch.int32),
                          ran.reshape(1)]).cpu().numpy()
        out_np = back[:N * self.slots].reshape(N, self.slots)
        done_np = back[N * self.slots:-1]
        ran = int(back[-1])
        if ran < n:
            # an eos stopped the run: the predicated-off ticks drew from
            # the generator, the one-tick loop would not have
            self._gen.set_state(states[ran])
            self.megastep_wasted_ticks += n - ran
        if done_np.any():
            reason = "finish"
        elif ran < N:
            reason = "page"
        else:
            reason = "limit"
        for t in range(ran):
            self._steps += 1
            for s in live:
                req = self._active[s]
                tok = int(out_np[t, s])
                req.pos += 1
                req.tokens.append(tok)
                self._tokens[s] = tok
                self._publish_prefix(req, req.pos)
                self._finish_if_done(s)
        self._on_megastep_resume()
        self.ragged_steps += n
        self._count_rows(n * self.slots, n * self.slots - ran * len(live))
        self._count_roundtrip(ran * len(live))
        self.megastep_dispatches += 1
        self.megastep_ticks_run += ran
        self._h_mega.observe(ran)
        self._c_break[reason].inc()
        if sp:
            sp.set(ticks=ran, break_reason=reason,
                   fused_rows=ran * len(live))
        sp.__exit__(None, None, None)
        dt = time.monotonic() - t0
        # the latency a tick, so the histogram compares across widths
        self._h_tick.observe(dt / max(ran, 1))
        self._h_tokens.observe(len(live))
        led = obs.ledger()
        if led is not None:
            led.record("decode", dt, batch=len(live), width=max(ran, 1))

    def _on_megastep_resume(self):
        """Hook fired after a megastep's bookkeeping replay, the point
        where the host resumes. Tests override it to check the pool's
        invariants at every resume; the server does nothing here."""

    # -- the universal (mixed) megastep ---------------------------------------

    def _mixed_spec_slot(self, req: _GenRequest) -> bool:
        """Whether a decoding slot drafts a chain on the device inside the
        mixed megastep: never here; the speculative server drafts on its
        greedy slots."""
        return False

    def _on_mixed_spec_tick(self, req: _GenRequest, emitted: int):
        """Hook: one drafting slot's tick committed `emitted` tokens (the
        accepted prefix and the verifier's token)."""

    def _overlap_window(self):
        """Host work run while a mixed dispatch's ticks are enqueued and
        before their one read back (overlap_dispatch=True): admission. It
        touches only free slots and free pages, never a live slot's table
        row, and never preempts; its device work (a copy-on-write page
        clone, a scale reset, the next dispatch's uploads) is ordered
        after the enqueued ticks by the stream. Page growth, eviction and
        defrag stay after the fence (the next _tick_prep)."""
        with obs.span("overlap_admit"):
            self._admit_pending()

    def _mixed_dispatch(self, live, tr, ntr) -> bool:
        """Serve this tick as one universal megastep when the mode is on
        and no canary window is open (the shadow must observe every
        launch, so an open window stands the fused dispatch down to the
        one-tick path); returns whether it did."""
        if not self.megastep_mixed or self._caches_ref is not None:
            return False
        self._mixed_megastep(live, tr, ntr)
        return True

    def _mixed_ticks(self, live, pos, pfp, pft, rem, cap, pf_act,
                     spec_m) -> int:
        """The ticks the host can prove the device loop may run: the tick
        limit; the tick on which the first chunk completes (the loop
        breaks after it); a plain decode row's page room and remaining
        tokens (one a tick); a drafting row's the same at its slowest
        advance, one token a tick. An eos and a drafting row's faster
        advance stop the loop earlier, on the device."""
        W, D = self._mixed_window, self._spec_depth
        n = self.megastep_ticks
        for s in live:
            if pf_act[s]:
                n = min(n, -(-int(pft[s] - pfp[s]) // W))
            else:
                room = cap[s] - pos[s] - (D if spec_m[s] else 0)
                n = min(n, int(room), int(rem[s]))
        return max(n, 0)

    def _mixed_megastep(self, live, tr, ntr):
        """Up to `megastep_ticks` MIXED ticks in one dispatch
        (Executor.paged_mixed_megastep_fn): decode rows, mid-prefill
        chunk rows and device-drafted chains, with one transfer back of
        the (ticks, slots, depth + 1) tokens, their counts, the finish and
        prefill-finished flags and the tick count. With overlap_dispatch
        the host admits between the enqueue and that read back, and
        `host_overlap_ratio` is the host work's share of the wait. The
        bookkeeping is replayed tick by tick in the one-tick order; a
        completing prefill's first token is the one the device drew for
        it. Break reasons: `chunk` after a chunk completed, `verify` when
        a drafting slot's next chain would cross its pages, and the decode
        megastep's `finish`, `page` and `limit`. Ticks enqueued but
        predicated off count in wasted_ticks, and the generator is set
        back to the state before the first of them."""
        t0 = time.monotonic()
        sp = obs.span("megastep").__enter__()
        if sp:
            sp.set(live=len(live), pages_in_use=self.pool.pages_in_use)
        P, W, D = self.page_size, self._mixed_window, self._spec_depth
        N = self.megastep_ticks
        pos = np.zeros((self.slots,), np.int32)
        pfp = np.zeros((self.slots,), np.int32)
        pft = np.zeros((self.slots,), np.int32)
        rem = np.zeros((self.slots,), np.int32)
        cap = np.zeros((self.slots,), np.int32)
        dec_act = np.zeros((self.slots,), np.bool_)
        pf_act = np.zeros((self.slots,), np.bool_)
        spec_m = np.zeros((self.slots,), np.bool_)
        for s in live:
            req = self._active[s]
            cap[s] = len(req.pages) * P
            if self._mid_prefill(s):
                pf_act[s] = True
                pfp[s] = req.prefill_pos
                pft[s] = req.prefill_target
                rem[s] = req.max_new  # the first token counts
            else:
                dec_act[s] = True
                pos[s] = req.pos
                rem[s] = req.max_new - len(req.tokens)
                spec_m[s] = self._mixed_spec_slot(req)
        n = self._mixed_ticks(live, pos, pfp, pft, rem, cap, pf_act, spec_m)
        if n == 0:
            # defensive only (_ensure_pages gives every slot its room):
            # one unfused tick, and the ledger is rebuilt from the host
            sp.__exit__(None, None, None)
            self._seq_dev = None
            pre, dec = self._split_live(live)
            if pre:
                self._prefill_tick(pre, tr, ntr)
            if dec:
                self._decode_tick(dec, tr, ntr)
            return
        up = self._upload
        caches, seq, out, cnt, done, pf_fin, ran, states = self._mixed_fn(
            tr, ntr, self._caches, self._tables_device(), self._seq_device(),
            up(pos), up(pfp), up(pft), self._temps_device(), up(rem),
            up(cap), up(dec_act), up(pf_act), up(spec_m), self._gen,
            max_ticks=N, window=W, depth=D, ticks=n, eos_id=self.eos_id)
        self._caches = caches
        self._seq_dev = seq
        host_s = 0.0
        if self.overlap_dispatch:
            h0 = time.monotonic()
            self._overlap_window()
            host_s = time.monotonic() - h0
        f0 = time.monotonic()
        # the ONE host transfer of the dispatch: the fence
        E = D + 1
        back = torch.cat([out.reshape(-1), cnt.reshape(-1),
                          done.to(torch.int32), pf_fin.to(torch.int32),
                          ran.reshape(1)]).cpu().numpy()
        fence_s = time.monotonic() - f0
        if self.overlap_dispatch:
            wait = host_s + fence_s
            self._g_overlap.set(host_s / wait if wait > 0 else 0.0)
        k = N * self.slots
        out_np = back[:k * E].reshape(N, self.slots, E)
        cnt_np = back[k * E:k * (E + 1)].reshape(N, self.slots)
        done_np = back[k * (E + 1):k * (E + 1) + self.slots]
        pf_np = back[k * (E + 1) + self.slots:-1]
        ran = int(back[-1])
        if ran < n:
            self._gen.set_state(states[ran])
            self.megastep_wasted_ticks += n - ran
        pf_slots = [s for s in live if pf_act[s]]
        dec_slots = [s for s in live if dec_act[s]]
        if pf_slots:
            self.prefill_ticks += 1
            if dec_slots:
                for s in pf_slots:
                    self._active[s].decode_overlap_ticks += ran
        # replay the bookkeeping tick by tick in the one-tick order; chunk
        # completions and finishes land on the last run tick only (the
        # device loop stops after them)
        fused = dtok = 0
        for t in range(ran):
            self._steps += 1
            last = t == ran - 1
            for s in pf_slots:
                req = self._active[s]
                if req is None or req.prefill_pos >= req.prefill_target:
                    continue
                take = min(W, req.prefill_target - req.prefill_pos)
                fused += take
                req.prefill_pos += take
                req.prefill_tokens += take
                self._publish_prefix(req, req.prefill_pos)
                if pf_np[s] and last:
                    # _prefill_tick's completion sequence: the tail is
                    # published while seq_tokens() is still the prompt,
                    # then the device's first token
                    self._publish_tail(req)
                    self._first_token_from_device(s, req,
                                                  int(out_np[t, s, 0]))
                    self._finish_if_done(s)
                    if self._active[s] is not None:
                        self._on_prefill_complete(s)
            for s in dec_slots:
                req = self._active[s]
                if req is None:
                    continue
                fused += (D + 1) if spec_m[s] else 1
                c = int(cnt_np[t, s])
                for j in range(c):
                    tok = int(out_np[t, s, j])
                    req.pos += 1
                    req.tokens.append(tok)
                    self._tokens[s] = tok
                dtok += c
                if spec_m[s]:
                    self._on_mixed_spec_tick(req, c)
                if c:
                    self._publish_prefix(req, req.pos)
                    self._finish_if_done(s)
        self._on_megastep_resume()
        if done_np.any():
            reason = "finish"
        elif pf_np.any():
            reason = "chunk"
        elif ran < N:
            # the slot that stopped the loop needs pages: a drafting slot
            # whose next chain would cross them is a verify break, a plain
            # decode row at its page boundary a page break
            blocked = any(spec_m[s] and self._active[s] is not None
                          and self._active[s].pos + D + 1 > cap[s]
                          for s in dec_slots)
            reason = "verify" if blocked else "page"
        else:
            reason = "limit"
        rows = n * self.slots * max(W, D + 1)
        self.ragged_steps += n
        self._count_rows(rows, rows - fused)
        self._count_roundtrip(dtok)
        self.megastep_dispatches += 1
        self.megastep_ticks_run += ran
        self._h_mega.observe(ran)
        self._c_break[reason].inc()
        if sp:
            sp.set(ticks=ran, break_reason=reason, fused_rows=fused,
                   pf_slots=len(pf_slots), dec_slots=len(dec_slots))
        sp.__exit__(None, None, None)
        dt = time.monotonic() - t0
        self._h_tick.observe(dt / max(ran, 1))
        self._h_tokens.observe(len(live))
        led = obs.ledger()
        if led is not None:
            led.record("decode", dt, batch=len(live), width=max(ran, 1))

    def _loop_body(self, tr, ntr):
        while not self._stop.is_set():
            live = self._tick_prep()
            if live is None:
                continue
            if self._mixed_dispatch(live, tr, ntr):
                continue
            pre, dec = self._split_live(live)
            if pre:
                self._prefill_tick(pre, tr, ntr)
            if dec:
                if self.megastep_ticks > 1 and not pre:
                    self._decode_megastep(dec, tr, ntr)
                else:
                    self._decode_tick(dec, tr, ntr)

    def _drain(self):
        if self._detaching:
            return  # the successor owns the carried futures
        super()._drain()
        for req in self._requeue:
            self._fail_or_cancel(req)
        self._requeue.clear()
