"""Continuous-batching generation serving (counterpart of the generation
half of flexflow_tpu/serving.py).

The request queue, loop thread, submit/generate/stop contract, sampling
and the finish/release bookkeeping that the paged scheduler
(paged/scheduler.py) builds on, and the dense GenerationServer, the
default: every slot owns a max_len KV buffer, decoded through the MHA
lowering's dense-cache branch (Executor.decode_fn). The HTTP front end,
the batch Server and the obs/reqlog/SLO machinery are not ported yet.

  ff = FFModel(FFConfig(device="cuda")); build_llama(ff, cfg); ff.compile()
  server = ff.serve_generation(slots=4, max_len=2048)   # dense
  server = ff.serve_generation(paged=True, slots=4, max_len=2048)
  tokens = server.submit(prompt_ids, max_new_tokens=64).result(timeout=60)
  server.stop()
"""

from __future__ import annotations

import collections
import queue
import threading
import time
from concurrent.futures import Future
from typing import List, Optional

import numpy as np
import torch


def pick_tokens(probs_last: torch.Tensor, temps: torch.Tensor,
                gen: torch.Generator) -> torch.Tensor:
    """One token per row of (B, V) probabilities: greedy argmax where
    temps <= 0, else a draw from softmax(log p / temp). Every call draws
    one (B, V) noise tensor from `gen`, whatever the temperatures, and
    reads nothing back to the host, so a tick can run from device state
    alone and the generator advances the same way on every serving path
    (the one-tick decode, the megastep tick, the speculative tick's root
    rows), as the reference splits its key once a tick. The draw is
    Gumbel-max, argmax(logits - log E) with E ~ Exp(1): torch.multinomial
    draws the same way but reads its arguments' validity back to the
    host. Row b's draw depends only on its own logits and noise. Greedy
    rows are token-identical to the JAX package's; sampled rows match it
    in distribution only (torch.Generator is not jax.random's
    threefry)."""
    greedy = torch.argmax(probs_last, dim=-1).to(torch.int32)
    logits = torch.log(probs_last.float().clamp_min(1e-30)) / \
        temps.clamp_min(1e-6)[:, None]
    noise = torch.empty_like(logits).exponential_(generator=gen)
    sampled = torch.argmax(logits - torch.log(noise), dim=-1).to(
        torch.int32)
    return torch.where(temps > 0.0, sampled, greedy)


class _GenRequest:
    __slots__ = ("prompt", "max_new", "temperature", "future", "tokens",
                 "pos", "pages", "submit_t", "admit_t", "first_token_t",
                 "done_t", "prefill_tokens", "peak_pages", "prefill_pos",
                 "prefill_target", "prefill_seq", "hashed_blocks",
                 "preemptions", "cached_prefill_tokens", "spec_steps",
                 "spec_drafted", "spec_accepted", "spec_emitted",
                 "decode_overlap_ticks")

    def __init__(self, prompt: np.ndarray, max_new: int, temperature: float):
        self.prompt = np.asarray(prompt, np.int32).reshape(-1)
        self.max_new = int(max_new)
        self.temperature = float(temperature)
        self.future: Future = Future()
        self.tokens: List[int] = []
        self.pos = 0                    # next cache write position
        self.pages: List[int] = []      # pool pages held
        self.submit_t = time.monotonic()
        self.admit_t: Optional[float] = None
        self.first_token_t: Optional[float] = None
        self.done_t: Optional[float] = None
        self.prefill_tokens = 0         # prompt rows computed
        self.cached_prefill_tokens = 0  # prompt rows served by the cache
        self.peak_pages = 0
        self.preemptions = 0
        # chunked-prefill progress: rows [0, prefill_pos) of prefill_seq
        # hold valid K/V; the slot decodes once prefill_pos reaches
        # prefill_target. hashed_blocks counts the full pages already
        # published to the prefix cache (the hash chain is re-derived
        # from seq_tokens(), so nothing of it survives a preemption).
        self.prefill_pos = 0
        self.prefill_target = 0
        self.prefill_seq: Optional[np.ndarray] = None
        self.hashed_blocks = 0
        # speculative decoding (spec/server.py): verify steps, drafted,
        # accepted and emitted tokens
        self.spec_steps = 0
        self.spec_drafted = 0
        self.spec_accepted = 0
        self.spec_emitted = 0
        self.decode_overlap_ticks = 0   # decode ticks run mid-prefill

    def seq_tokens(self) -> np.ndarray:
        """prompt + generated-so-far: what a (re-)prefill after a
        preemption feeds, without ever changing the prompt itself."""
        if not self.tokens:
            return self.prompt
        return np.concatenate([self.prompt,
                               np.asarray(self.tokens, np.int32)])

    def metrics(self) -> dict:
        """Per-request metrics (the queue time runs from submit to the
        LAST admission, so a preempted request's requeue wait counts)."""
        m = {
            "queue_time_s": (self.admit_t - self.submit_t
                             if self.admit_t is not None else None),
            "ttft_s": (self.first_token_t - self.submit_t
                       if self.first_token_t is not None else None),
            # first token to last: the request's decode phase
            "decode_s": (self.done_t - self.first_token_t
                         if self.done_t is not None
                         and self.first_token_t is not None else None),
            "prefill_tokens": self.prefill_tokens,
            "cached_prefill_tokens": self.cached_prefill_tokens,
            "decode_tokens": len(self.tokens),
            "pages_held_peak": self.peak_pages,
            "preemptions": self.preemptions,
            "decode_overlap_ticks": self.decode_overlap_ticks,
        }
        if self.spec_steps:
            m.update({
                "spec_steps": self.spec_steps,
                "spec_draft_tokens": self.spec_drafted,
                "spec_accepted_tokens": self.spec_accepted,
                "spec_acceptance_rate": (
                    self.spec_accepted / self.spec_drafted
                    if self.spec_drafted else 0.0),
                "spec_accepted_tokens_per_step": (
                    self.spec_emitted / self.spec_steps),
            })
        return m


class _GenerationServerBase:
    """Request queue + stop/drain contract + sampling shared by the
    generation servers. The loop thread runs under torch.inference_mode
    (grad mode is thread-local, so the thread enters it itself)."""

    MAX_REQUEST_RECORDS = 1024

    def __init__(self, ff, slots: int, max_len: int,
                 eos_id: Optional[int], seed: int):
        self.ff = ff
        self.slots = int(slots)
        self.max_len = int(max_len)
        # learned-position models (GPT-2/BERT-style): a position past the
        # table has no row; refuse at construction, as the reference does
        rows = ff.position_table_rows()
        if rows is not None and self.max_len > rows:
            raise ValueError(
                f"max_len ({self.max_len}) exceeds the model's learned "
                f"position table ({rows} rows); rebuild with a longer "
                "seq_len or lower max_len")
        self.eos_id = eos_id
        self._params = ff._params
        self.device = ff.device
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(int(seed))
        self._queue: "queue.Queue[_GenRequest]" = queue.Queue()
        self._active: List[Optional[_GenRequest]] = [None] * self.slots
        self._tokens = np.zeros((self.slots,), np.int32)
        self._stop = threading.Event()
        # guards the _running/queue.put pair against a submit racing stop()
        self._lock = threading.Lock()
        self._running = True
        self._served = 0
        self._steps = 0
        self._request_metrics = collections.deque(
            maxlen=self.MAX_REQUEST_RECORDS)
        self.loop_error: Optional[BaseException] = None
        self._thread: Optional[threading.Thread] = None

    def _start(self, defer: bool = False):
        """Subclasses call this LAST in __init__; with `defer` the loop
        waits for start()."""
        self._thread = threading.Thread(target=self._loop, daemon=True)
        if not defer:
            self._thread.start()

    def start(self):
        """Start the loop of a server built with defer_start=True: what
        was submitted before is admitted in submission order from the
        first tick on."""
        if self._thread.ident is None:
            self._thread.start()

    # -- public API ------------------------------------------------------

    def _check_capacity(self, prompt: np.ndarray, max_new_tokens: int):
        if len(prompt) + max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens ({max_new_tokens}) "
                f"exceeds max_len ({self.max_len})")

    def submit(self, prompt_ids: np.ndarray, max_new_tokens: int,
               temperature: float = 0.0) -> Future:
        if max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {max_new_tokens}")
        prompt = np.asarray(prompt_ids, np.int32).reshape(-1)
        if len(prompt) == 0:
            raise ValueError("prompt must contain at least one token")
        self._check_capacity(prompt, max_new_tokens)
        req = _GenRequest(prompt, max_new_tokens, temperature)
        with self._lock:
            if not self._running:
                raise RuntimeError(f"{type(self).__name__} is stopped")
            self._queue.put(req)
        return req.future

    def generate(self, prompt_ids: np.ndarray, max_new_tokens: int,
                 temperature: float = 0.0,
                 timeout: Optional[float] = None) -> np.ndarray:
        return self.submit(prompt_ids, max_new_tokens,
                           temperature).result(timeout=timeout)

    def stop(self):
        with self._lock:
            self._running = False
            self._stop.set()
        if self._thread.ident is not None:
            self._thread.join(timeout=30)
        # drain from this thread only once the loop thread is dead —
        # otherwise its finally-drain owns the cleanup
        if not self._thread.is_alive():
            self._drain()

    @property
    def requests_served(self) -> int:
        return self._served

    @property
    def decode_steps(self) -> int:
        return self._steps

    def metrics(self) -> dict:
        return {"requests_served": self._served,
                "decode_steps": self._steps,
                "requests": list(self._request_metrics)}

    # -- shared scheduler pieces -----------------------------------------

    @staticmethod
    def _bucket(n: int) -> int:
        """The launch rows of an n-row prefill: the next power of two from
        8 (the dense admission's bucket, the unpacked prefill's window)."""
        b = 8
        while b < n:
            b *= 2
        return b

    def _sample_first_token(self, slot: int, req: _GenRequest, row_probs):
        """Pick a request's FIRST token from its last prompt row's (1, V)
        probs, append it, and stamp TTFT."""
        temps = torch.full((1,), req.temperature, dtype=torch.float32,
                           device=row_probs.device)
        tok = int(pick_tokens(row_probs, temps, self._gen)[0])
        self._first_token_from_device(slot, req, tok)

    def _first_token_from_device(self, slot: int, req: _GenRequest,
                                 tok: int):
        """Commit a request's FIRST token when it is already drawn (the
        universal megastep draws a completing prefill's first token from
        the tick's own (slots, V) draw, so the generator is not drawn
        again): append it and stamp TTFT."""
        req.pos = len(req.seq_tokens())  # before the append below
        req.tokens.append(tok)
        self._tokens[slot] = tok
        if req.first_token_t is None:
            req.first_token_t = time.monotonic()

    def _admit_common(self, req: _GenRequest, slot: int, padded_len: int,
                      scatter_rows):
        """The dense admission: one prefill of the prompt padded right to
        `padded_len` rows (the pad rows land past the slot's position, so
        they stay masked until decode overwrites them) through the
        one-slot prefill caches, its K/V rows handed to `scatter_rows`,
        and the first token picked from the last real prompt row."""
        tr, ntr = self._params
        seq = req.seq_tokens()
        n = len(seq)
        padded = np.zeros((1, padded_len), np.int32)
        padded[0, :n] = seq
        probs, upd = self._prefill_step(
            tr, ntr, self._prefill_caches, 0,
            torch.from_numpy(padded).to(self.device))
        scatter_rows(upd)
        req.admit_t = time.monotonic()
        req.prefill_tokens += n
        self._sample_first_token(slot, req, probs[:, n - 1, :])
        self._active[slot] = req

    def _release_slot(self, slot: int, req: _GenRequest,
                      completed: bool = False):
        """Subclass hook: reclaim per-slot resources (paged frees pages).
        Completed requests record their per-request metrics."""
        if completed:
            req.done_t = time.monotonic()
            self._request_metrics.append(req.metrics())
        self._active[slot] = None

    def _finish_if_done(self, slot: int):
        req = self._active[slot]
        if req is None:
            return
        done = len(req.tokens) >= req.max_new
        if (self.eos_id is not None and req.tokens
                and req.tokens[-1] == self.eos_id):
            done = True
        if done:
            self._release_slot(slot, req, completed=True)
            self._served += 1
            req.future.set_result(np.asarray(req.tokens, np.int32))

    def _loop(self):
        try:
            with torch.inference_mode():
                self._loop_body(*self._params)
        except BaseException as e:  # surfaced through every pending future
            self.loop_error = e
            raise
        finally:
            # runs on ANY exit so blocked callers always unblock
            self._drain()

    def _loop_body(self, tr, ntr):
        raise NotImplementedError

    def _fail_or_cancel(self, req: _GenRequest):
        if req.future.done():
            return
        if self.loop_error is not None:
            req.future.set_exception(RuntimeError(
                f"serving loop failed: {self.loop_error!r}"))
        else:
            req.future.cancel()

    def _drain(self):
        """Cancel (or fail, after a loop error) whatever is still queued
        or mid-decode, so callers unblock — a truncated sequence must not
        look like a completed one."""
        for s in range(self.slots):
            req = self._active[s]
            if req is not None:
                self._release_slot(s, req)
                self._fail_or_cancel(req)
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            self._fail_or_cancel(req)


class GenerationServer(_GenerationServerBase):
    """Continuous batching over a DENSE KV cache (serve_generation's
    default, paged=False): each of `slots` owns a max_len buffer a
    layer. A tick admits queued requests into free slots (one bucketed
    prefill each, its K/V rows copied into the slot's rows), then
    advances every live slot one token in one decode step at per-slot
    positions (the MHA lowering's cached_attention). A finished request
    frees its slot at once. The step is plain PyTorch, as the reference
    computes it outside any Pallas kernel; for memory that scales with
    the tokens in flight, pass paged=True. Greedy tokens equal the JAX
    package's; sampled ones match it in distribution only
    (pick_tokens)."""

    def __init__(self, ff, slots: int = 4, max_len: int = 512,
                 eos_id: Optional[int] = None, seed: int = 0,
                 defer_start: bool = False):
        super().__init__(ff, slots, max_len, eos_id, seed)
        ex = ff.executor
        self._step = ex.decode_fn
        self._prefill_step = self._step  # one step, two input shapes
        self._caches = ex.init_kv_cache(self.slots, self.max_len)
        # a one-slot cache of the same rows, which admission prefills
        self._prefill_caches = ex.init_kv_cache(1, self.max_len)
        self._start(defer_start)

    def _admit(self, req: _GenRequest, slot: int):
        """Bucketed prefill into `slot` (_admit_common), its K/V rows
        copied into the slot's dense rows."""

        def scatter(upd):
            for key, bufs in upd.items():
                for name, rows in bufs.items():
                    self._caches[key][name][slot].copy_(rows[0])

        self._admit_common(
            req, slot, min(self._bucket(len(req.seq_tokens())),
                           self.max_len), scatter)
        self._finish_if_done(slot)

    def _loop_body(self, tr, ntr):
        dev = self.device
        while not self._stop.is_set():
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
            live = [s for s in range(self.slots)
                    if self._active[s] is not None]
            if not live:
                if not admitted:
                    time.sleep(0.001)
                continue
            # one decode step for the whole pool (idle slots compute too)
            pos = np.array([self._active[s].pos if self._active[s] else 0
                            for s in range(self.slots)], np.int32)
            temps = np.array([self._active[s].temperature
                              if self._active[s] else 0.0
                              for s in range(self.slots)], np.float32)
            probs, self._caches = self._step(
                tr, ntr, self._caches, torch.from_numpy(pos).to(dev),
                torch.from_numpy(self._tokens[:, None].copy()).to(dev))
            toks = pick_tokens(probs[:, -1, :],
                               torch.from_numpy(temps).to(dev),
                               self._gen).cpu().numpy()
            self._steps += 1
            for s in live:
                req = self._active[s]
                req.pos += 1
                req.tokens.append(int(toks[s]))
                self._tokens[s] = toks[s]
                self._finish_if_done(s)


def not_ported(what: str, item: int):
    """Refuse a knob the port does not serve yet, naming the ROADMAP.md
    queue-1 item that ports it."""
    raise NotImplementedError(
        f"{what} is not ported to the PyTorch server yet (ROADMAP.md, "
        f"queue 1 item {item})")


def serve_generation(ff, slots: int = 4, max_len: int = 512,
                     eos_id: Optional[int] = None, seed: int = 0,
                     paged: bool = False, page_size: int = 64,
                     num_pages: Optional[int] = None,
                     preemption: bool = True, prefix_cache: bool = True,
                     prefill_chunk: int = 64, speculate=None,
                     ragged_pack: bool = True, megastep_ticks: int = 1,
                     megastep_mixed: bool = False,
                     overlap_dispatch: bool = False,
                     kv_dtype: str = "auto",
                     kv_quant_canary: Optional[int] = None, host_tier=None,
                     defer_start: bool = False):
    """Continuous-batching generation endpoint over a compiled causal-LM
    FFModel, with the reference's defaults. `paged=False` (the default)
    returns the dense GenerationServer; `paged=True` serves through the
    block-paged KV cache (paged/scheduler.py) with the prefix cache and
    preemption on. `speculate=SpecConfig(...)` returns the speculative
    server (spec/server.py); `megastep_ticks=N` runs up to N pure-decode
    ticks per host round trip; `megastep_mixed=True` makes every tick a
    universal megastep (chunk rows and, with speculate, device-drafted
    chains fused with decode rows), `overlap_dispatch=True` admits while
    its ticks run; `ragged_pack=False` launches the unpacked prefill.
    The host KV tier and the kv_quant_canary shadow cache are not ported
    and raise NotImplementedError naming their ROADMAP item; the
    reference's invalid combinations raise its ValueErrors.
    `defer_start=True` builds the server without starting its loop
    (start() does)."""
    megastep_ticks = int(megastep_ticks)
    if megastep_ticks < 1:
        raise ValueError(
            f"megastep_ticks must be >= 1, got {megastep_ticks}")
    if megastep_mixed and not paged:
        raise ValueError(
            "megastep_mixed fuses the paged mixed tick; pass paged=True")
    if overlap_dispatch and not megastep_mixed:
        raise ValueError(
            "overlap_dispatch overlaps host work with the in-flight "
            "MIXED megastep dispatch; pass megastep_mixed=True")
    if (megastep_ticks > 1 and not megastep_mixed
            and (not paged or speculate is not None)):
        raise ValueError(
            "megastep_ticks > 1 rides the paged one-tick decode loop; "
            "pass paged=True and no speculate (the speculative server's "
            "verify step already emits multiple tokens per dispatch), "
            "or megastep_mixed=True to fuse spec verify into the "
            "universal megastep")
    if speculate is not None and not paged:
        raise ValueError(
            "speculative decoding rides the paged KV cache (rollback is a "
            "position rewind, not a cache copy); pass paged=True")
    if not paged:
        if kv_dtype != "auto":
            raise ValueError(
                "kv_dtype rides the paged KV pool; pass paged=True")
        if kv_quant_canary:
            raise ValueError(
                "kv_quant_canary probes the paged KV pool's quantization "
                "error; pass paged=True")
        if host_tier is not None and host_tier != 0:
            raise ValueError(
                "host_tier spills the paged KV pool's content-addressed "
                "pages; pass paged=True")
        return GenerationServer(ff, slots=slots, max_len=max_len,
                                eos_id=eos_id, seed=seed,
                                defer_start=defer_start)
    kw = dict(slots=slots, max_len=max_len, eos_id=eos_id, seed=seed,
              page_size=page_size, num_pages=num_pages,
              preemption=preemption, prefix_cache=prefix_cache,
              prefill_chunk=prefill_chunk, ragged_pack=ragged_pack,
              megastep_ticks=megastep_ticks, megastep_mixed=megastep_mixed,
              overlap_dispatch=overlap_dispatch, kv_dtype=kv_dtype,
              kv_quant_canary=kv_quant_canary, host_tier=host_tier,
              defer_start=defer_start)
    if speculate is not None:
        from flexflow_tpu_torch.spec.server import SpeculativePagedServer

        return SpeculativePagedServer(ff, speculate, **kw)
    from flexflow_tpu_torch.paged.scheduler import PagedGenerationServer

    return PagedGenerationServer(ff, **kw)
