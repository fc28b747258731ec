"""Continuous-batching generation serving (counterpart of the generation
half of flexflow_tpu/serving.py).

The request queue, loop thread, submit/generate/stop contract, sampling
and the finish/release bookkeeping that the paged scheduler
(paged/scheduler.py) builds on. The dense GenerationServer, the HTTP
front end and the obs/reqlog/SLO machinery are not ported yet.

  ff = FFModel(FFConfig(device="cuda")); build_llama(ff, cfg); ff.compile()
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
    temps <= 0, else a draw from softmax(log p / temp) with `gen`. Greedy
    rows are token-identical to the JAX package's; sampled rows match it
    in distribution only (torch.Generator and jax.random differ)."""
    greedy = torch.argmax(probs_last, dim=-1).to(torch.int32)
    hot = temps > 0.0
    if not bool(hot.any()):
        return greedy
    logits = torch.log(probs_last.float().clamp_min(1e-30)) / \
        temps.clamp_min(1e-6)[:, None]
    sampled = torch.multinomial(torch.softmax(logits, dim=-1), 1,
                                generator=gen)[:, 0].to(torch.int32)
    return torch.where(hot, sampled, greedy)


class _GenRequest:
    __slots__ = ("prompt", "max_new", "temperature", "future", "tokens",
                 "pos", "pages", "submit_t", "admit_t", "first_token_t",
                 "done_t", "prefill_tokens", "peak_pages", "prefill_pos",
                 "prefill_target", "prefill_seq")

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
        self.peak_pages = 0
        # chunked-prefill progress: rows [0, prefill_pos) of prefill_seq
        # hold valid K/V; the slot decodes once prefill_pos reaches
        # prefill_target
        self.prefill_pos = 0
        self.prefill_target = 0
        self.prefill_seq: Optional[np.ndarray] = None

    def seq_tokens(self) -> np.ndarray:
        """prompt + generated-so-far."""
        if not self.tokens:
            return self.prompt
        return np.concatenate([self.prompt,
                               np.asarray(self.tokens, np.int32)])

    def metrics(self) -> dict:
        return {
            "queue_time_s": (self.admit_t - self.submit_t
                             if self.admit_t is not None else None),
            "ttft_s": (self.first_token_t - self.submit_t
                       if self.first_token_t is not None else None),
            # first token to last: the request's decode phase
            "decode_s": (self.done_t - self.first_token_t
                         if self.done_t is not None
                         and self.first_token_t is not None else None),
            "prefill_tokens": self.prefill_tokens,
            "decode_tokens": len(self.tokens),
            "pages_held_peak": self.peak_pages,
        }


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

    def _start(self):
        """Subclasses call this LAST in __init__."""
        self._thread = threading.Thread(target=self._loop, daemon=True)
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

    def _sample_first_token(self, slot: int, req: _GenRequest, row_probs):
        """Pick a request's FIRST token from its last prompt row's (1, V)
        probs, append it, and stamp TTFT."""
        temps = torch.full((1,), req.temperature, dtype=torch.float32,
                           device=row_probs.device)
        tok = int(pick_tokens(row_probs, temps, self._gen)[0])
        req.pos = len(req.seq_tokens())  # before the append below
        req.tokens.append(tok)
        self._tokens[slot] = tok
        if req.first_token_t is None:
            req.first_token_t = time.monotonic()

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


def serve_generation(ff, slots: int = 4, max_len: int = 512,
                     eos_id: Optional[int] = None, seed: int = 0,
                     paged: bool = False, page_size: int = 64,
                     num_pages: Optional[int] = None,
                     preemption: bool = False, prefix_cache: bool = False,
                     prefill_chunk: int = 64, speculate=None,
                     ragged_pack: bool = True, megastep_ticks: int = 1,
                     megastep_mixed: bool = False,
                     overlap_dispatch: bool = False,
                     kv_dtype: str = "auto", host_tier=None):
    """Continuous-batching generation endpoint over a compiled causal-LM
    FFModel, through the block-paged KV cache (paged/scheduler.py). Only
    the paged server is ported; each knob it does not honour yet raises
    NotImplementedError (PagedGenerationServer names them)."""
    if not paged:
        raise NotImplementedError(
            "the dense GenerationServer is not ported yet; pass paged=True "
            "(ROADMAP.md, queue 1)")
    from flexflow_tpu_torch.paged.scheduler import PagedGenerationServer

    return PagedGenerationServer(
        ff, slots=slots, max_len=max_len, eos_id=eos_id, seed=seed,
        page_size=page_size, num_pages=num_pages, preemption=preemption,
        prefix_cache=prefix_cache, prefill_chunk=prefill_chunk,
        speculate=speculate, ragged_pack=ragged_pack,
        megastep_ticks=megastep_ticks, megastep_mixed=megastep_mixed,
        overlap_dispatch=overlap_dispatch, kv_dtype=kv_dtype,
        host_tier=host_tier)
