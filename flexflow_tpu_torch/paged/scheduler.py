"""Continuous-batching scheduler over the paged KV cache (counterpart of
flexflow_tpu/paged/scheduler.py, in the configuration this port serves).

Admission is by free slot; a request's prompt is
prefilled CHUNKED inside the decode loop (at most `prefill_chunk` prompt
tokens per tick, packed into window pieces of at most PREFILL_WINDOW_ROWS
rows), and it then grows one page at a time as it decodes. Every model
call is the ONE ragged step (Executor.ragged_step_fn): a tick assembles
work items — decode rows and prefill chunk pieces — into a (B, S) launch
whose per-item descriptor (pos, q_len, depths, anc) says which rows are
live. Items padded to the launch shape carry q_len 0; the attention
kernel skips them and their K/V writes go to the null page. Splitting a
chunk into pieces is sound because every item's K/V rows are written
into the pool BEFORE attention runs at each layer, so piece i+1 sees
piece i's rows as committed.

Decode flow per tick:
  1. admit queued requests into free slots while pages last (FIFO)
  2. grow: decoding slots whose next write position crosses a page
     boundary allocate a page
  3. one packed prefill launch for the mid-prefill slots (the chunk that
     finishes a prompt samples its first token)
  4. one ragged decode launch for the decoding slots
  5. sample, append, finish/free

Not ported yet, and refused at construction rather than ignored: prefix
caching (with copy-on-write), preemption, decode megasteps, speculative
decoding, quantized (int8) pools, the host KV tier, the unpacked
(`ragged_pack=False`) launch, and a pool smaller than every slot's
longest sequence (which the reference serves by preempting).
"""

from __future__ import annotations

import queue
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from flexflow_tpu_torch.paged.pool import PagePool
from flexflow_tpu_torch.serving import (
    _GenerationServerBase,
    _GenRequest,
    pick_tokens,
)

# Packed prefill windows are capped at this many rows.
PREFILL_WINDOW_ROWS = 8


def _not_ported(what: str):
    raise NotImplementedError(
        f"{what} is not ported to the PyTorch server yet (ROADMAP.md, "
        "queue 1 item 3)")


class PagedGenerationServer(_GenerationServerBase):
    """Continuous batching over the block-paged KV cache
    (serve_generation(..., paged=True))."""

    def __init__(self, ff, slots: int = 4, max_len: int = 512,
                 eos_id: Optional[int] = None, seed: int = 0,
                 page_size: int = 64, num_pages: Optional[int] = None,
                 preemption: bool = False, prefix_cache: bool = False,
                 prefill_chunk: int = 64, speculate=None,
                 ragged_pack: bool = True, megastep_ticks: int = 1,
                 megastep_mixed: bool = False,
                 overlap_dispatch: bool = False, kv_dtype: str = "auto",
                 host_tier=None):
        if prefix_cache:
            _not_ported("prefix_cache=True (prefix caching with COW)")
        if preemption:
            _not_ported("preemption=True")
        if int(megastep_ticks) != 1 or megastep_mixed or overlap_dispatch:
            _not_ported("megastep_ticks > 1 / megastep_mixed / "
                        "overlap_dispatch")
        if speculate is not None:
            _not_ported("speculative decoding (speculate=...)")
        if kv_dtype != "auto":
            _not_ported(f"kv_dtype={kv_dtype!r}")
        if host_tier is not None and host_tier != 0:
            _not_ported("host_tier")
        if not ragged_pack:
            _not_ported("ragged_pack=False")
        super().__init__(ff, slots, max_len, eos_id, seed)
        self.page_size = int(page_size)
        self.max_pages_per_seq = -(-self.max_len // self.page_size)
        full = self.slots * self.max_pages_per_seq + 1
        if num_pages is None:
            num_pages = full
        if num_pages < full:
            _not_ported(
                f"num_pages={num_pages} below slots x pages-per-sequence "
                f"+ 1 = {full} (an undersized pool needs preemption)")
        self.pool = PagePool(num_pages, self.page_size,
                             self.max_pages_per_seq)
        self.prefill_chunk = max(1, int(prefill_chunk))
        self._chunk_rows = PREFILL_WINDOW_ROWS
        ex = ff.executor
        self._step = ex.ragged_step_fn
        self._caches = ex.init_paged_kv_cache(num_pages, self.page_size)
        self._tables = np.zeros((self.slots, self.max_pages_per_seq),
                                np.int32)
        self._chain_desc_cache: Dict[Tuple[int, int], tuple] = {}
        self._admit_order: List[int] = []  # live slots, oldest first
        self.prefill_ticks = 0
        # ragged steps run: each launches the attention kernel once per
        # attention layer
        self.ragged_steps = 0
        self._prefill_rr = 0    # rotating start slot for the chunk budget
        self._start()

    def metrics(self) -> dict:
        m = super().metrics()
        m["paged"] = {
            "page_size": self.page_size,
            "num_pages": self.pool.num_pages,
            "pages_in_use": self.pool.pages_in_use,
            "prefill_ticks": self.prefill_ticks,
            "ragged_steps": self.ragged_steps,
        }
        return m

    # -- slot lifecycle ---------------------------------------------------

    def _release_slot(self, slot: int, req: _GenRequest,
                      completed: bool = False):
        self.pool.free(list(reversed(req.pages)))
        req.pages = []
        self._tables[slot] = 0
        if slot in self._admit_order:
            self._admit_order.remove(slot)
        super()._release_slot(slot, req, completed)

    def _alloc(self, n: int) -> List[int]:
        pages = self.pool.alloc(n)
        if pages is None:
            raise RuntimeError("page pool exhausted although it holds "
                               "every slot's longest sequence")
        return pages

    def _admit(self, req: _GenRequest, slot: int):
        """Allocate the prompt's pages and queue the whole prompt for
        CHUNKED prefill. No model step runs here."""
        seq = req.seq_tokens()
        n = len(seq)
        pages = self._alloc(self.pool.pages_for(n))
        req.pages = pages
        req.peak_pages = max(req.peak_pages, len(pages))
        self._tables[slot] = 0
        self._tables[slot, :len(pages)] = pages
        req.prefill_seq = seq
        req.prefill_pos = 0
        req.prefill_target = n
        req.pos = 0
        req.admit_t = time.monotonic()
        self._active[slot] = req
        self._admit_order.append(slot)

    # -- page growth ------------------------------------------------------

    def _pages_target(self, req: _GenRequest) -> int:
        """Pages a live slot must hold before the next tick: the page of
        its next write position."""
        return min(self.pool.pages_for(req.pos + 1), self.max_pages_per_seq)

    def _ensure_pages(self):
        """Before a tick, every live slot grows to its _pages_target. The
        pool holds every slot's longest sequence, so growth never runs
        short."""
        for slot in list(self._admit_order):
            req = self._active[slot]
            if req is None:
                continue
            while len(req.pages) < self._pages_target(req):
                got = self._alloc(1)
                req.pages.append(got[0])
                req.peak_pages = max(req.peak_pages, len(req.pages))
                self._tables[slot, len(req.pages) - 1] = got[0]

    # -- scheduler loop ---------------------------------------------------

    def _admit_pending(self) -> bool:
        """Admission, FIFO, into every free slot (the pool holds every
        slot's longest sequence, so pages never hold a request back).
        Returns whether anything was admitted."""
        admitted = False
        for slot in range(self.slots):
            if self._active[slot] is not None:
                continue
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            self._admit(req, slot)
            admitted = True
        return admitted

    def _live(self) -> List[int]:
        return [s for s in range(self.slots) if self._active[s] is not None]

    def _mid_prefill(self, slot: int) -> bool:
        req = self._active[slot]
        return req is not None and req.prefill_pos < req.prefill_target

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
        """Run ONE ragged step over packed work items, each
        (slot, pos, tokens): `tokens` the item's q_len <= window live ids.
        Rows past an item's q_len are padding. Returns the
        (len(items), window, vocab) probs."""
        B = len(items)
        ids = np.zeros((B, window), np.int32)
        pos = np.zeros((B,), np.int32)
        qls = np.zeros((B,), np.int32)
        slot_idx = np.zeros((B,), np.int64)
        for i, (slot, p, toks) in enumerate(items):
            ql = len(toks)
            ids[i, :ql] = toks
            pos[i] = p
            qls[i] = ql
            slot_idx[i] = slot
        deps_d, anc_d = self._chain_descriptor_device(B, window)
        dev = self.device
        probs, upd = self._step(
            tr, ntr, self._caches,
            torch.from_numpy(self._tables[slot_idx]).to(dev),
            torch.from_numpy(pos).to(dev), torch.from_numpy(qls).to(dev),
            deps_d, anc_d, torch.from_numpy(ids).to(dev))
        self._caches = upd
        self.ragged_steps += 1
        return probs

    def _tick_prep(self) -> Optional[List[int]]:
        """Admit, grow pages. Returns the live slots (decoding AND
        mid-prefill), or None when nothing is live (sleeps briefly when
        nothing was admitted either)."""
        admitted = self._admit_pending()
        live = self._live()
        if not live:
            if not admitted:
                time.sleep(0.001)
            return None
        self._ensure_pages()
        return live

    def _split_live(self, live):
        """(mid-prefill slots, decoding slots) for this tick."""
        pre = [s for s in live if self._mid_prefill(s)]
        dec = [s for s in live if not self._mid_prefill(s)]
        return pre, dec

    def _prefill_tick(self, slots, tr, ntr):
        """Advance mid-prefill slots by at most `prefill_chunk` tokens
        ACROSS the tick, starting from a slot that rotates tick to tick.
        Every slot's chunk is split into window pieces and the whole tick
        rides ONE packed launch; the chunk finishing a prompt samples the
        request's first token from its own last-row probs."""
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
        items = []
        ends = []  # (item index, row) of each chunk's last piece
        W = min(self._chunk_rows, max(take for _, _, _, take in plan))
        for s, req, start, take in plan:
            for off in range(0, take, W):
                piece = min(W, take - off)
                items.append((s, start + off,
                              req.prefill_seq[start + off:
                                              start + off + piece]))
            ends.append((len(items) - 1, (take - 1) % W))
        probs = self._launch(items, W, tr, ntr)
        for (s, req, start, take), (i, r) in zip(plan, ends):
            req.prefill_pos = start + take
            req.prefill_tokens += take
            if req.prefill_pos >= req.prefill_target:
                self._sample_first_token(s, req, probs[i:i + 1, r, :])
                self._finish_if_done(s)

    def _decode_tick(self, live, tr, ntr):
        """One single-token decode step for the decoding slots: one item
        per slot, q_len 1 for decoding slots and 0 for idle and
        mid-prefill ones, so probs stays slot-indexed."""
        dec = set(live)
        items = [(s, self._active[s].pos if s in dec else 0,
                  [int(self._tokens[s])] if s in dec else [])
                 for s in range(self.slots)]
        probs = self._launch(items, 1, tr, ntr)
        temps = torch.tensor(
            [self._active[s].temperature if s in dec else 0.0
             for s in range(self.slots)], dtype=torch.float32,
            device=self.device)
        toks = pick_tokens(probs[:, -1, :], temps, self._gen).cpu().numpy()
        self._steps += 1
        for s in live:
            req = self._active[s]
            req.pos += 1
            req.tokens.append(int(toks[s]))
            self._tokens[s] = toks[s]
            self._finish_if_done(s)

    def _loop_body(self, tr, ntr):
        while not self._stop.is_set():
            live = self._tick_prep()
            if live is None:
                continue
            pre, dec = self._split_live(live)
            if pre:
                self._prefill_tick(pre, tr, ntr)
            if dec:
                self._decode_tick(dec, tr, ntr)

