"""Inference serving (counterpart of flexflow_tpu/serving.py).

The batch server: a ModelInstance runs the executor's forward on the
device at each allowed batch size, and the dynamic batcher (Server)
queues requests, concatenates them up to the largest batch or until
`max_delay_ms` passes, pads to the nearest allowed size by repeating the
last row, runs one forward a batch (one copy back), and splits the
result per request. `http_serve` puts the KServe-v2 JSON surface (and
the Prometheus `/metrics` text) in front of it, stdlib only.

The generation servers: the request queue, loop thread,
submit/generate/stop contract, sampling and the finish/release
bookkeeping that the paged scheduler (paged/scheduler.py) builds on,
and the dense GenerationServer, the default: every slot owns a max_len
KV buffer, decoded through the MHA lowering's dense-cache branch
(Executor.decode_fn). Every generation server owns a MetricsRegistry
(obs.metrics: tick latency, TTFT, queue time, tokens a tick), keeps the
per-request records of the last `request_record_limit` requests in a
BoundedRing, writes one reqlog record per completed request
(`reqlog_capacity`, obs.reqlog) and, with `slo=SLOTarget(...)`, feeds
the SLO monitor, which dumps a breach bundle under `slo_dump_dir`. Under
obs.enable() the tick phases run inside obs spans, record their wall
times in the tick ledger, and each completed request becomes a request
track of the trace. All of it is host bookkeeping on what the server
already knows: no device read is added to a tick. The reqlog record's
`spilled_pages` and `fetched_pages` come from the paged server's host
tier, `routed_to` from the prefix-affinity router (disagg/), and its
`strategy` is the fingerprint of the ServeStrategy the server realizes
(search/servesearch.py; the paged server derives one from its knobs when
none was passed), which `metrics()["strategy"]` and a breach bundle's
`strategy.json` carry too. `detach_for_swap()` pauses the loop without
cancelling a future and hands back every request still owed a result,
the drain half of the autopilot's drain-and-swap (serving_autopilot.py).
The reference's compile tracker has no counterpart here yet: a
request's compile seconds are 0.0 (its TTFT without compile is its
TTFT), and breach dumps carry no compile snapshot.

  ff = FFModel(FFConfig(device="cuda")); build_llama(ff, cfg); ff.compile()
  server = ff.serve(batch_sizes=(1, 8, 32), max_delay_ms=2)  # batch
  y = server.submit(x).result()
  server = ff.serve_generation(slots=4, max_len=2048)   # dense
  server = ff.serve_generation(paged=True, slots=4, max_len=2048)
  tokens = server.submit(prompt_ids, max_new_tokens=64).result(timeout=60)
  server.stop()
"""

from __future__ import annotations

import json
import queue
import threading
import time
from concurrent.futures import Future
from typing import List, Optional, Sequence

import numpy as np
import torch

from flexflow_tpu_torch import obs
from flexflow_tpu_torch.ffconst import DataType


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


def _host_dtype(dt: DataType) -> np.dtype:
    """The numpy dtype of a host batch for an input declared `dt`
    (numpy has no bfloat16: such inputs travel as float32 and are cast on
    the device)."""
    return np.dtype("float32" if dt == DataType.BFLOAT16 else dt.value)


class ModelInstance:
    """The executor's forward on the model's device, run at each allowed
    batch size (the reference's compiled instance a batch size; the
    port's forward is eager, so one forward serves every size)."""

    def __init__(self, ff, batch_sizes: Sequence[int]):
        self.ff = ff
        self.batch_sizes = tuple(sorted(set(batch_sizes)))
        self._fwd = ff.executor.forward
        self._params = ff._params
        self._in_dtypes = [n.outputs[0].dtype.torch_dtype
                           for n in ff.executor.input_nodes]

    def pick_batch(self, n: int) -> int:
        for b in self.batch_sizes:
            if n <= b:
                return b
        return self.batch_sizes[-1]

    def run(self, inputs: List[np.ndarray]) -> np.ndarray:
        """Run one already-padded batch; the output comes back in one copy
        (a bfloat16 one as float32, which numpy lacks)."""
        tr, ntr = self._params
        with torch.inference_mode():
            xs = [x.to(dt) if x.is_floating_point() and dt.is_floating_point
                  else x
                  for x, dt in zip(self.ff._to_device(inputs),
                                   self._in_dtypes)]
            out = self._fwd(tr, ntr, *xs)
            if out.dtype == torch.bfloat16:
                out = out.float()
            return out.cpu().numpy()

    def warmup(self):
        """Run zeros at every batch size before the first request (the
        allocator and the kernels' first launches off the clock)."""
        specs = [n.outputs[0] for n in self.ff.executor.input_nodes]
        for b in self.batch_sizes:
            self.run([np.zeros((b,) + tuple(d.size for d in s.dims[1:]),
                               _host_dtype(s.dtype)) for s in specs])


class _Request:
    __slots__ = ("inputs", "future", "n")

    def __init__(self, inputs: List[np.ndarray]):
        self.inputs = inputs
        self.n = inputs[0].shape[0]
        self.future: Future = Future()


class Server:
    """Dynamic batcher: requests queue up, are concatenated up to the
    largest allowed batch (or until `max_delay_ms` passes), run as one
    forward, and split back per request. One thread, the loop's, touches
    the device."""

    def __init__(self, instance: ModelInstance, max_delay_ms: float = 2.0):
        self.instance = instance
        self.max_delay = max_delay_ms / 1e3
        self._q: "queue.Queue[Optional[_Request]]" = queue.Queue()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._running = True
        self._served = 0
        self._thread.start()

    # -- client side ----------------------------------------------------

    def submit(self, *inputs: np.ndarray) -> Future:
        """Queue one request (its batch dim may be any size >= 1)."""
        if not self._running:
            raise RuntimeError("server is stopped")
        req = _Request([np.asarray(x) for x in inputs])
        self._q.put(req)
        return req.future

    def predict(self, *inputs: np.ndarray) -> np.ndarray:
        return self.submit(*inputs).result()

    def stop(self):
        self._running = False
        self._q.put(None)
        self._thread.join(timeout=10)
        self._drain()

    def _drain(self):
        """Fail any request still queued when the loop exits (a request
        racing stop() must not leave its future forever pending)."""
        while True:
            try:
                req = self._q.get_nowait()
            except queue.Empty:
                return
            if req is not None and not req.future.done():
                req.future.set_exception(RuntimeError("server stopped"))

    @property
    def requests_served(self) -> int:
        return self._served

    # -- scheduler ------------------------------------------------------

    def _loop(self):
        max_b = self.instance.batch_sizes[-1]
        while self._running:
            req = self._q.get()
            if req is None:
                break
            batch = [req]
            total = req.n
            deadline = time.monotonic() + self.max_delay
            while total < max_b:
                timeout = deadline - time.monotonic()
                if timeout <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=timeout)
                except queue.Empty:
                    break
                if nxt is None:
                    self._running = False
                    break
                batch.append(nxt)
                total += nxt.n
            self._run_batch(batch, total)
        self._drain()

    def _run_batch(self, batch: List[_Request], total: int):
        b = self.instance.pick_batch(total)
        try:
            n_inputs = len(batch[0].inputs)
            cat = [np.concatenate([r.inputs[i] for r in batch])
                   for i in range(n_inputs)]
            # pad to the allowed batch by repeating the last row (padded
            # rows are computed and sliced off); past the largest size,
            # several chunks
            outs = []
            for off in range(0, total, b):
                chunk = [c[off:off + b] for c in cat]
                pad = b - chunk[0].shape[0]
                if pad:
                    chunk = [np.concatenate([c, np.repeat(c[-1:], pad, 0)])
                             for c in chunk]
                out = self.instance.run(chunk)
                outs.append(out[:min(b, total - off)])
            full = np.concatenate(outs)
            off = 0
            for r in batch:
                r.future.set_result(full[off:off + r.n])
                off += r.n
                self._served += 1
        except Exception as e:  # sent to every waiting client
            for r in batch:
                if not r.future.done():
                    r.future.set_exception(e)


def serve(ff, batch_sizes: Sequence[int] = (1, 8), max_delay_ms: float = 2.0,
          warmup: bool = True) -> Server:
    """A batch-serving endpoint over a compiled FFModel."""
    inst = ModelInstance(ff, batch_sizes)
    if warmup:
        inst.warmup()
    return Server(inst, max_delay_ms=max_delay_ms)


def serve_onnx(path: str, *args, **kwargs):
    """ONNX model -> served model: needs the ONNX frontend, which needs
    the `onnx` package (installed neither where the port's tests run nor
    on the card's machine, and the JAX package has no ONNX test to hold a
    port against)."""
    raise NotImplementedError(
        "serve_onnx needs the ONNX frontend, which waits for the onnx "
        "package (ROADMAP.md, queue 1 item 10)")


# ---------------------------------------------------------------------------
# HTTP endpoint (KServe-v2-shaped JSON)


_DTYPE_TO_V2 = {"float32": "FP32", "float64": "FP64", "int32": "INT32",
                "int64": "INT64", "bool": "BOOL", "float16": "FP16"}
_V2_TO_DTYPE = {v: k for k, v in _DTYPE_TO_V2.items()}


def http_serve(server: Server, port: int = 8000, model_name: str = "model",
               generation_server=None):
    """Expose a Server over HTTP with the KServe v2 JSON surface:

      GET  /v2/health/ready                 -> 200, 503 once stopped
      GET  /v2/models/<name>               -> metadata
      GET  /v2/models/<name>/metrics       -> serving metrics JSON
      GET  /metrics                        -> Prometheus text exposition
      POST /v2/models/<name>/infer         -> {"inputs": [{"name","shape",
                                               "datatype","data"}...]}

    Inputs bind by name when every one is named after a graph input, by
    position otherwise. The JSON metrics carry the batcher's counters
    and, with a `generation_server` (serve_generation) attached, its
    metrics(); `GET /metrics` serves the same numbers (its
    MetricsRegistry plus the flattened scalar metrics, `ff_` prefix) as
    Prometheus text. Binds 127.0.0.1 (`port=0` takes a free port: read it
    from `server_address`). Returns the ThreadingHTTPServer, serving on
    a daemon thread; call .shutdown() to stop it."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    input_names = [n.name for n in server.instance.ff.executor.input_nodes]

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code: int, payload: dict):
            self._send_raw(code, json.dumps(payload).encode(),
                           "application/json")

        def _send_raw(self, code: int, body: bytes, ctype: str):
            try:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            except OSError:
                # the client went away mid-response (a second status
                # line would corrupt the stream)
                self.close_connection = True

        def do_GET(self):
            if self.path == "/v2/health/ready":
                ready = getattr(server, "_running", True)
                self._send(200 if ready else 503, {"ready": bool(ready)})
            elif self.path == f"/v2/models/{model_name}":
                self._send(200, {"name": model_name,
                                 "platform": "flexflow_tpu_torch",
                                 "requests_served": server.requests_served})
            elif self.path == f"/v2/models/{model_name}/metrics":
                payload = {
                    "server": {"requests_served": server.requests_served},
                }
                if generation_server is not None:
                    payload["generation"] = generation_server.metrics()
                self._send(200, payload)
            elif self.path == "/metrics":
                scalars = {"server_requests_served":
                           float(server.requests_served)}
                if generation_server is not None:
                    gm = generation_server.metrics()
                    gm.pop("requests", None)    # per-request detail and
                    gm.pop("histograms", None)  # the registry's own
                    scalars.update(obs.flatten_scalars(gm, "generation"))
                    reg = generation_server.registry
                else:
                    reg = obs.MetricsRegistry()
                self._send_raw(
                    200,
                    reg.prometheus_text(extra_scalars=scalars).encode(),
                    "text/plain; version=0.0.4")
            else:
                self._send(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            if self.path != f"/v2/models/{model_name}/infer":
                self._send(404, {"error": f"unknown path {self.path}"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n))
                specs = req["inputs"]
                names = [s.get("name") for s in specs]
                if (len(specs) == len(input_names) and all(names)
                        and set(names) == set(input_names)):
                    specs = sorted(
                        specs, key=lambda s: input_names.index(s["name"]))
                arrays = []
                for spec in specs:
                    v2dt = spec.get("datatype", "FP32")
                    if v2dt not in _V2_TO_DTYPE:
                        raise ValueError(f"unsupported datatype {v2dt!r}")
                    arrays.append(
                        np.asarray(spec["data"], dtype=_V2_TO_DTYPE[v2dt])
                        .reshape(spec["shape"]))
            except Exception as e:
                self._send(400, {"error": f"{type(e).__name__}: {e}"})
                return
            try:
                out = np.asarray(server.predict(*arrays))
            except Exception as e:
                # an inference failure is a server error (retryable),
                # unlike the request-decode 400s above
                self._send(503, {"error": f"{type(e).__name__}: {e}"})
                return
            self._send(200, {
                "model_name": model_name,
                "outputs": [{
                    "name": "output0",
                    "shape": list(out.shape),
                    "datatype": _DTYPE_TO_V2.get(str(out.dtype), "FP32"),
                    "data": out.reshape(-1).tolist(),
                }],
            })

    httpd = ThreadingHTTPServer(("127.0.0.1", port), Handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd


# ---------------------------------------------------------------------------
# continuous batching for autoregressive generation


class _GenRequest:
    __slots__ = ("prompt", "max_new", "temperature", "future", "tokens",
                 "pos", "pages", "submit_t", "admit_t", "first_token_t",
                 "done_t", "prefill_tokens", "peak_pages", "prefill_pos",
                 "prefill_target", "prefill_seq", "hashed_blocks",
                 "preemptions", "cached_prefill_tokens", "spec_steps",
                 "spec_drafted", "spec_accepted", "spec_emitted",
                 "decode_overlap_ticks", "spilled_pages", "fetched_pages",
                 "routed_to")

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
        # the paged server's host KV tier and the prefix-affinity router
        # fill these (disagg/)
        self.spilled_pages = 0
        self.fetched_pages = 0
        self.routed_to: Optional[str] = None

    def seq_tokens(self) -> np.ndarray:
        """prompt + generated-so-far: what a (re-)prefill after a
        preemption feeds, without ever changing the prompt itself."""
        if not self.tokens:
            return self.prompt
        return np.concatenate([self.prompt,
                               np.asarray(self.tokens, np.int32)])

    def metrics(self) -> dict:
        """Per-request metrics (the queue time runs from submit to the
        LAST admission, so a preempted request's requeue wait counts).
        The port compiles nothing at serve time: a request's compile
        seconds are 0.0 and its TTFT without them is its TTFT."""
        ttft = (self.first_token_t - self.submit_t
                if self.first_token_t is not None else None)
        m = {
            "queue_time_s": (self.admit_t - self.submit_t
                             if self.admit_t is not None else None),
            "ttft_s": ttft,
            "first_compile_s": 0.0 if ttft is not None else None,
            "ttft_excl_compile_s": ttft,
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
    """Request queue + stop/drain contract + sampling + observability
    (registry, bounded request records, reqlog, SLO monitor) shared by
    the generation servers. The loop thread runs under
    torch.inference_mode (grad mode is thread-local, so the thread enters
    it itself)."""

    # default cap on the per-request records metrics() returns; the
    # oldest drop first (counted). Override with request_record_limit.
    MAX_REQUEST_RECORDS = 1024

    def __init__(self, ff, slots: int, max_len: int,
                 eos_id: Optional[int], seed: int,
                 request_record_limit: Optional[int] = None,
                 reqlog_capacity: Optional[int] = None,
                 slo=None, slo_dump_dir: Optional[str] = None,
                 serve_strategy=None):
        self.ff = ff
        # the ServeStrategy this server realizes (search.servesearch),
        # when known: its fingerprint stamps every reqlog record and the
        # metrics payload, so records attribute to the strategy that
        # served them across autopilot swaps
        self.serve_strategy = serve_strategy
        self._strategy_fp: Optional[str] = None
        # set while detach_for_swap() pauses the loop: the finally-drain
        # must not cancel futures that are about to be carried over
        self._detaching = False
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
        limit = (int(request_record_limit) if request_record_limit
                 is not None else self.MAX_REQUEST_RECORDS)
        if limit < 1:
            raise ValueError(
                f"request_record_limit must be >= 1, got {limit}")
        self.request_record_limit = limit
        # per-request metric records and the reqlog share one bounded
        # retention path (obs.BoundedRing); both drop counts ride metrics()
        self._request_metrics = obs.BoundedRing(limit)
        # the flight recorder: one record per completed request, on by
        # default; capacity 0 gives the falsy NULL_REQLOG
        self._reqlog = obs.request_log(reqlog_capacity)
        if slo is not None and not isinstance(slo, obs.SLOMonitor):
            slo = obs.SLOMonitor(slo, dump_dir=slo_dump_dir)
        elif slo is not None and slo_dump_dir is not None:
            slo.dump_dir = slo_dump_dir
        self._slo = slo
        # always-on histograms: the JSON metrics payload and the
        # Prometheus text endpoint both read them
        self.registry = obs.MetricsRegistry()
        self._h_tick = self.registry.histogram("tick_latency_s")
        self._h_prefill = self.registry.histogram("prefill_tick_s")
        self._h_ttft = self.registry.histogram("ttft_s")
        self._h_queue = self.registry.histogram("queue_time_s")
        self._h_tokens = self.registry.histogram("tokens_per_tick",
                                                 obs.COUNT_BUCKETS)
        self._h_ttft_excl = self.registry.histogram("ttft_excl_compile_s")
        # the SLO series exist only when a target is declared
        if self._slo is not None:
            self._c_slo_breaches = self.registry.counter(
                "slo_breaches_total")
            self._g_goodput = self.registry.gauge("goodput_ratio")
            self._g_goodput.set(1.0)
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
        return self.submit_request(
            _GenRequest(prompt, max_new_tokens, temperature))

    def submit_request(self, req: _GenRequest) -> Future:
        """Enqueue an ALREADY-BUILT request: the disagg handoff path
        (disagg/workers.py) hands a prefill worker's live request (its
        future, first token and counters intact) to the decode worker,
        whose admission re-attaches its spilled pages through the shared
        host tier; the router stamps `routed_to` before it enqueues."""
        self._check_capacity(req.prompt, req.max_new)
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

    @property
    def request_log(self):
        """The flight recorder (obs.RequestLog, or the falsy NULL_REQLOG
        with reqlog_capacity=0); `export_jsonl(path)` writes it out."""
        return self._reqlog

    @property
    def slo_monitor(self):
        """The SLO judge (obs.SLOMonitor), or None without a target."""
        return self._slo

    @property
    def strategy_fingerprint(self) -> Optional[str]:
        """Short content hash of the ServeStrategy this server realizes
        (None when unknown: the dense server without an explicit
        strategy). Stamped into reqlog records and metrics() so records
        after a swap segment by the strategy that served them."""
        if self._strategy_fp is None and self.serve_strategy is not None:
            self._strategy_fp = self.serve_strategy.fingerprint()
        return self._strategy_fp

    def metrics(self) -> dict:
        """Aggregate serving metrics, the records of the last
        `request_record_limit` completed requests (and how many fell
        off), the reqlog's state, the registry's histograms and, with a
        target, the SLO snapshot (subclasses extend it). This dict is
        what http_serve's /v2/models/<name>/metrics serves."""
        out = {
            "requests_served": self._served,
            "decode_steps": self._steps,
            "requests": list(self._request_metrics),
            "request_records_dropped": self._request_metrics.dropped,
            "reqlog": {
                "enabled": bool(self._reqlog),
                "records": len(self._reqlog),
                "capacity": self._reqlog.capacity,
                "dropped": self._reqlog.dropped,
            },
            "histograms": self.registry.to_json(),
        }
        if self.serve_strategy is not None:
            out["strategy"] = {
                "fingerprint": self.strategy_fingerprint,
                "knobs": self.serve_strategy.to_json(),
            }
        if self._slo is not None:
            out["slo"] = self._slo.snapshot()
        return out

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

    # -- request log (obs.reqlog) ----------------------------------------

    def _prefix_chain(self, req: _GenRequest) -> tuple:
        """The content-hash prefix chain of the reqlog record (never the
        raw tokens); the dense server has no page pool to derive one
        from, the paged one overrides it."""
        return ()

    def _reqlog_kv_dtype(self) -> str:
        """The KV storage dtype of the reqlog record (the paged server
        overrides it with its pool's)."""
        return "dense"

    def _reqlog_record(self, req: _GenRequest, m: dict,
                       done_t: float) -> dict:
        """One flight-recorder record per completed request, the
        reference's keys (obs.reqlog's schema): lifecycle stamps in ns of
        time.monotonic (a missing stamp collapses forward to done), prompt
        length and prefix chain, sampling params, kv dtype, the
        speculative, preemption and page counters, and the per-phase
        breakdown the stamps imply."""
        admit_t = req.admit_t if req.admit_t is not None else done_t
        first_t = (req.first_token_t if req.first_token_t is not None
                   else done_t)
        rec = {
            "rid": self._served + 1,
            "label": f"req {self._served + 1}",
            "submit_ns": int(req.submit_t * 1e9),
            "admit_ns": int(admit_t * 1e9),
            "first_token_ns": int(first_t * 1e9),
            "done_ns": int(done_t * 1e9),
            "prompt_tokens": int(len(req.prompt)),
            "prefix_chain": list(self._prefix_chain(req)),
            "temperature": req.temperature,
            "max_new_tokens": req.max_new,
            "kv_dtype": self._reqlog_kv_dtype(),
            "decode_tokens": m["decode_tokens"],
            "prefill_tokens": m["prefill_tokens"],
            "cached_prefill_tokens": m["cached_prefill_tokens"],
            "pages_held_peak": m["pages_held_peak"],
            "preemptions": m["preemptions"],
            "spec_steps": m.get("spec_steps", 0),
            "spec_draft_tokens": m.get("spec_draft_tokens", 0),
            "spec_accepted_tokens": m.get("spec_accepted_tokens", 0),
            "spilled_pages": req.spilled_pages,
            "fetched_pages": req.fetched_pages,
            "routed_to": req.routed_to,
            "phases": {
                "queue_s": max(0.0, admit_t - req.submit_t),
                "prefill_s": max(0.0, first_t - admit_t),
                "decode_s": max(0.0, done_t - first_t),
            },
        }
        fp = self.strategy_fingerprint
        if fp is not None:
            rec["strategy"] = fp
        return rec

    def _release_slot(self, slot: int, req: _GenRequest,
                      completed: bool = False):
        """Subclass hook: reclaim per-slot resources (paged frees pages).
        A completed request (not a cancellation) records its metrics,
        feeds the histograms, and writes its reqlog record, which the SLO
        monitor judges; a breach it trips dumps the bundle (with the span
        trace's tail under obs.enable()) from this, the loop's, thread.
        Under obs.enable() the request's lifecycle goes to the trace as
        a request track."""
        if completed:
            req.done_t = done_t = time.monotonic()
            m = req.metrics()
            self._request_metrics.append(m)
            if m["ttft_s"] is not None:
                self._h_ttft.observe(m["ttft_s"])
            if m["ttft_excl_compile_s"] is not None:
                self._h_ttft_excl.observe(m["ttft_excl_compile_s"])
            if m["queue_time_s"] is not None:
                self._h_queue.observe(m["queue_time_s"])
            # one record build for both, none when both are off
            if self._reqlog or self._slo is not None:
                record = self._reqlog_record(req, m, done_t)
                self._reqlog.log(record)
                if self._slo is not None:
                    tripped = self._slo.observe(record)
                    self._g_goodput.set(self._slo.goodput)
                    if tripped:
                        self._c_slo_breaches.inc()
                        self._slo.dump(
                            reqlog=self._reqlog, recorder=obs.recorder(),
                            metrics=self.metrics,
                            strategy=(self.serve_strategy.to_json()
                                      if self.serve_strategy is not None
                                      else None))
            rec = obs.recorder()
            if rec is not None:
                # the request's lifecycle track (queued, prefill, decode)
                # on the spans' monotonic clock
                rec.record_request(req.submit_t, req.admit_t,
                                   req.first_token_t, done_t,
                                   label=f"req {self._served + 1}", attrs=m)
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

    # -- drain-and-swap (serving_autopilot) ------------------------------

    def detach_for_swap(self) -> List[_GenRequest]:
        """Pause the serving loop WITHOUT cancelling futures and hand
        back every request still owed a result, in service order:
        mid-flight requests first (oldest first, so re-admission keeps
        their priority), then whatever was queued. Each keeps its Future,
        its prompt and every token it has decoded (seq_tokens()), so a
        successor resumes it through absorb_requests() and greedy streams
        stay token-identical. This server is stopped afterwards; only its
        pool and caches remain adoptable (adopt_pool_from)."""
        with self._lock:
            self._running = False
            self._detaching = True
            self._stop.set()
        if self._thread.ident is not None:
            self._thread.join(timeout=30)
            if self._thread.is_alive():
                with self._lock:
                    self._detaching = False
                raise RuntimeError(
                    "serving loop did not pause within 30s — refusing to "
                    "detach requests from a live loop")
        carried = self._detach_active()
        while True:
            try:
                carried.append(self._queue.get_nowait())
            except queue.Empty:
                break
        return carried

    def _detach_active(self) -> List[_GenRequest]:
        """Subclass hook: pull mid-flight requests out of their slots
        without cancelling them (the paged server also publishes their
        pages and frees them). Only called with the loop stopped."""
        carried: List[_GenRequest] = []
        for s in range(self.slots):
            req = self._active[s]
            if req is not None:
                self._active[s] = None
                carried.append(req)
        return carried

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
        look like a completed one. During a detach_for_swap the successor
        owns every pending future, so cancellation stands down."""
        if self._detaching:
            return
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
                 request_record_limit: Optional[int] = None,
                 reqlog_capacity: Optional[int] = None, slo=None,
                 slo_dump_dir: Optional[str] = None,
                 serve_strategy=None, defer_start: bool = False):
        super().__init__(ff, slots, max_len, eos_id, seed,
                         request_record_limit=request_record_limit,
                         reqlog_capacity=reqlog_capacity, slo=slo,
                         slo_dump_dir=slo_dump_dir,
                         serve_strategy=serve_strategy)
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
                    # a PIPELINE node's caches lead with the layer dim:
                    # (L, B, T, Hkv, D), the batch dim second
                    big = self._caches[key][name]
                    if rows.ndim == 5:
                        big[:, slot].copy_(rows[:, 0])
                    else:
                        big[slot].copy_(rows[0])

        self._admit_common(
            req, slot, min(self._bucket(len(req.seq_tokens())),
                           self.max_len), scatter)
        self._finish_if_done(slot)

    def _loop_body(self, tr, ntr):
        dev = self.device
        while not self._stop.is_set():
            admitted = False
            with obs.span("admit") as sp:
                n_admitted = 0
                for slot in range(self.slots):
                    if self._active[slot] is not None:
                        continue
                    try:
                        req = self._queue.get_nowait()
                    except queue.Empty:
                        break
                    self._admit(req, slot)
                    admitted = True
                    n_admitted += 1
                if sp and n_admitted:
                    sp.set(admitted=n_admitted)
            live = [s for s in range(self.slots)
                    if self._active[s] is not None]
            if not live:
                if not admitted:
                    time.sleep(0.001)
                continue
            # one decode step for the whole pool (idle slots compute too)
            t0 = time.monotonic()
            with obs.span("decode_tick") as sp:
                if sp:
                    sp.set(live=len(live))
                pos = np.array([self._active[s].pos if self._active[s]
                                else 0 for s in range(self.slots)], np.int32)
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
            dt = time.monotonic() - t0
            self._h_tick.observe(dt)
            self._h_tokens.observe(len(live))
            led = obs.ledger()
            if led is not None:
                led.record("decode", dt, batch=len(live))


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
                     request_record_limit: Optional[int] = None,
                     serve_strategy=None, search_budget=None,
                     traffic="smoke", reqlog_capacity: Optional[int] = None,
                     slo=None, slo_dump_dir: Optional[str] = None,
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
    `request_record_limit` bounds the per-request records metrics()
    keeps, `reqlog_capacity` sizes the request log (0 disables it), and
    `slo=SLOTarget(...)` arms the SLO monitor with breach dumps under
    `slo_dump_dir`. `host_tier` (a page capacity, or a shared
    disagg.HostTier) spills evicted prefix pages to host memory and
    fetches them back; `kv_quant_canary=N` replays every Nth admission's
    launches against an fp32 shadow of the pool (the kv_quant_error
    gauge). `search_budget=N` runs the serving-strategy search
    (search/servesearch.py) for N anneal iterations against the `traffic`
    profile (a name of search/traffic.py, a TrafficProfile or a
    RecordedProfile) on the H100 machine model and serves the winner.
    On the card the winner can serve fewer tokens a second than
    ServeStrategy(): the pricer takes a fused megastep for one dispatch,
    but until ticks run as CUDA graphs (ROADMAP.md queue 1 item 7) each
    fused tick is enqueued from the host; a calibration whose ledger
    holds fused shapes (`fftrace smoke --megastep`) prices that in.
    `serve_strategy` applies a known ServeStrategy (or its to_json()
    dict). Either decides the paged knobs wholesale, and passing an
    explicit `speculate` beside it raises; a strategy whose mesh spans
    more than one card raises as the port's meshes do. The reference's
    invalid combinations raise its ValueErrors. `defer_start=True` builds
    the server without starting its loop (start() does)."""
    if search_budget is not None and serve_strategy is None:
        from flexflow_tpu_torch.search.servesearch import (
            search_serve_strategy,
        )

        serve_strategy = search_serve_strategy(
            ff, traffic=traffic, budget=int(search_budget), slots=slots,
            max_len=max_len).best
    if serve_strategy is not None:
        from flexflow_tpu_torch.parallel.mesh import check_axes
        from flexflow_tpu_torch.search.servesearch import ServeStrategy

        if isinstance(serve_strategy, dict):
            serve_strategy = ServeStrategy.from_json(serve_strategy)
        if speculate is not None:
            raise ValueError(
                "serve_strategy already decides speculation — drop the "
                "explicit speculate= argument")
        kw = serve_strategy.to_server_kwargs(slots, max_len)
        check_axes(dict(serve_strategy.mesh))
        paged = True
        page_size = kw["page_size"]
        prefill_chunk = kw["prefill_chunk"]
        ragged_pack = kw["ragged_pack"]
        megastep_ticks = kw["megastep_ticks"]
        megastep_mixed = kw["megastep_mixed"]
        overlap_dispatch = kw["overlap_dispatch"]
        speculate = kw["speculate"]
        kv_dtype = kw["kv_dtype"]
        if kw["num_pages"] is not None:
            num_pages = kw["num_pages"]
        # the strategy's host-tier capacity applies only when the caller
        # did not hand over a tier of their own (a shared tier wins)
        if host_tier is None and kw["host_tier"] is not None:
            host_tier = kw["host_tier"]
    obs_kw = dict(request_record_limit=request_record_limit,
                  reqlog_capacity=reqlog_capacity, slo=slo,
                  slo_dump_dir=slo_dump_dir, serve_strategy=serve_strategy)
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
                                defer_start=defer_start, **obs_kw)
    kw = dict(slots=slots, max_len=max_len, eos_id=eos_id, seed=seed,
              page_size=page_size, num_pages=num_pages,
              preemption=preemption, prefix_cache=prefix_cache,
              prefill_chunk=prefill_chunk, ragged_pack=ragged_pack,
              megastep_ticks=megastep_ticks, megastep_mixed=megastep_mixed,
              overlap_dispatch=overlap_dispatch, kv_dtype=kv_dtype,
              kv_quant_canary=kv_quant_canary, host_tier=host_tier,
              defer_start=defer_start, **obs_kw)
    if speculate is not None:
        from flexflow_tpu_torch.spec.server import SpeculativePagedServer

        return SpeculativePagedServer(ff, speculate, **kw)
    from flexflow_tpu_torch.paged.scheduler import PagedGenerationServer

    return PagedGenerationServer(ff, **kw)
