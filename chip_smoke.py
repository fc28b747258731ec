"""Chip smoke test of flexflow_tpu_torch, the PyTorch/CUDA port: drives the
port's paged Llama serving path on one NVIDIA card and holds every
hand-written kernel on it to its plain PyTorch version.

    python3 chip_smoke.py            # all phases, one card

Phases (each raises on failure: non-zero exit, no "ok" line):
  1. card: name and power limit; build every kernel from csrc/ (nvcc,
     sm_90a, one process per source, all started together);
  2. kernels vs their plain versions on the card at the serving path's
     shapes (Llama-3-8B attention: H=32, Hkv=8, D=128, page 64, 129
     pages; decode, chunk and pad entries; window 1 and 8; bf16 and
     fp32), with kernel / plain / library times and the roofline bound;
  3. one packed ragged step at Llama-3-8B widths, depth 2, fp32 (TF32
     off): the card against the CPU on the same seeded weights;
  4. serving: Llama-3-8B (32 layers, bf16, random weights from a seed)
     through serve_generation(paged=True); 8 requests of 128..1024
     prompt tokens, 64 new tokens each; every kernel of the path must
     have launched (counts reset just before, read just after).
The line before the last is the kernel list as JSON; the last line is
{"ok": true, "device": {...}}. Exits non-zero without CUDA.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from flexflow_tpu_torch import DataType, FFConfig, FFModel
from flexflow_tpu_torch.kernels import KERNELS, RAGGED_PAGED_ATTENTION, build
from flexflow_tpu_torch.models.llama import LlamaConfig, build_llama
from flexflow_tpu_torch.paged.attention import (
    ragged_flash_attention,
    ragged_gather_attention,
    ragged_visibility_mask,
)

# NVIDIA H100 SXM data sheet: HBM rate and dense peaks by operand type
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# kernel vs plain version: fp32 differs by summation order only; bf16
# rounds probabilities to bf16 at different points (the kernel before
# normalising, the plain version after) and rounds the output to bf16
TOLS = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2e-2, 2e-2)}
# card step vs CPU step, fp32 with TF32 off: summation order only
STEP_RTOL, STEP_ATOL = 1e-3, 1e-7

H, HKV, D, P, NUM_PAGES, MAXP = 32, 8, 128, 64, 129, 32
DEVICE = "cuda"


def log(msg: str):
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0] if out else ""


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of one fn() call, by CUDA events around each call,
    with the 50 MB L2 cache flushed (a 64 MB buffer rewritten) before each:
    on the serving path every layer reads its own pool, so a kernel finds
    its K/V cold."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=DEVICE)
    for _ in range(warmup):
        fn()
    events = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in events) / iters


# ---------------------------------------------------------------------------
# phase 2: the ragged paged-attention kernel against its plain version


def attention_case(window: int, kinds, dtype, seed: int, fixed_pos=None):
    """Inputs of one ragged attention call at the serving path's shapes:
    one entry per kind ("decode" q_len 1, "chunk:N" q_len N, "pad"),
    positions `fixed_pos` or random up to ~2000, distinct random pages per
    entry."""
    rs = np.random.RandomState(seed)
    B = len(kinds)
    pos = np.zeros(B, np.int32)
    qls = np.zeros(B, np.int32)
    anc = np.zeros((B, window, window), bool)
    for b, kind in enumerate(kinds):
        if kind == "pad":
            continue
        n = 1 if kind == "decode" else int(kind.split(":")[1])
        qls[b] = n
        pos[b] = (fixed_pos if fixed_pos is not None
                  else rs.randint(1, MAXP * P - 48))
        anc[b, :n, :n] = np.tril(np.ones((n, n), bool))
    pt = (rs.permutation(NUM_PAGES - 1)[:B * MAXP] + 1).reshape(B, MAXP)
    dev = DEVICE
    q = torch.from_numpy(rs.standard_normal((B, window, H, D))
                         .astype(np.float32)).to(dev, dtype)
    kc = torch.from_numpy(rs.standard_normal((NUM_PAGES, P, HKV, D))
                          .astype(np.float32)).to(dev, dtype)
    vc = torch.from_numpy(rs.standard_normal((NUM_PAGES, P, HKV, D))
                          .astype(np.float32)).to(dev, dtype)
    return (q, kc, vc, torch.from_numpy(pt.astype(np.int32)).to(dev),
            torch.from_numpy(pos).to(dev), torch.from_numpy(qls).to(dev),
            torch.from_numpy(anc).to(dev))


def attention_bound(args) -> tuple:
    """(bound_ms, bound_by, bytes, ops): the least time the card could
    take — every input byte the call needs read once (q; the K/V rows up
    to each entry's horizon; the descriptor), every output byte written
    once — against the ops the visible keys need (QK and PV dots, 4*D
    per visible (q head, key) pair) at the operand type's peak."""
    q, kc, vc, pt, pos, qls, anc = args
    B, S = q.shape[:2]
    isz = q.element_size()
    horizon = (pos.long() + qls.long()) * (qls > 0).long()
    kv_rows = int(horizon.sum())
    nbytes = (2 * q.numel() * isz + 2 * kv_rows * HKV * D * isz
              + pt.numel() * 4 + pos.numel() * 4 + qls.numel() * 4
              + anc.numel())
    vis = ragged_visibility_mask(pt, pos, qls, anc, P)
    live = torch.arange(S, device=q.device)[None, :] < qls[:, None]
    visible = int((vis.sum(-1) * live).sum())
    ops = 4 * D * H * visible
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS[q.dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, ops)


def library_call(args, scale):
    """The yardstick: F.scaled_dot_product_attention on the pre-gathered
    K/V with the same visibility mask (timed only; the port never calls
    it)."""
    q, kc, vc, pt, pos, qls, anc = args
    B, S = q.shape[:2]
    kg = kc[pt.long()].reshape(B, -1, HKV, D).transpose(1, 2).contiguous()
    vg = vc[pt.long()].reshape(B, -1, HKV, D).transpose(1, 2).contiguous()
    qh = q.transpose(1, 2).contiguous()
    mask = ragged_visibility_mask(pt, pos, qls, anc, P)[:, None]
    try:
        F.scaled_dot_product_attention(qh, kg, vg, attn_mask=mask,
                                       scale=scale, enable_gqa=True)
        return lambda: F.scaled_dot_product_attention(
            qh, kg, vg, attn_mask=mask, scale=scale, enable_gqa=True)
    except TypeError:  # a torch without enable_gqa: repeat heads first
        kr = kg.repeat_interleave(H // HKV, dim=1)
        vr = vg.repeat_interleave(H // HKV, dim=1)
        return lambda: F.scaled_dot_product_attention(
            qh, kr, vr, attn_mask=mask, scale=scale)


# (name, window, entries, fixed position): the first is the serving
# path's steady decode launch (4 slots at pos 1024), the kernel line's case
ATTENTION_CASES = [
    ("decode_b4_pos1024", 1, ["decode"] * 4, 1024),
    ("decode_pad_w1", 1, ["decode", "decode", "decode", "pad"], None),
    ("mixed_w8", 8, ["decode", "chunk:8", "chunk:5", "pad"], None),
]


def phase_kernels(card: str) -> list:
    scale = 1.0 / D ** 0.5
    results = []
    for dtype in (torch.bfloat16, torch.float32):
        for i, (name, window, kinds, fixed) in enumerate(ATTENTION_CASES):
            args = attention_case(window, kinds, dtype, seed=i,
                                  fixed_pos=fixed)
            got = ragged_flash_attention(*args, scale=scale)
            want = ragged_gather_attention(*args, scale=scale)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs()
            atol, rtol = TOLS[dtype]
            ok = bool((err <= atol + rtol * want.float().abs()).all())
            zero_tail = all(not got[b, int(args[5][b]):].any()
                            for b in range(len(kinds)))
            bound_ms, bound_by, nbytes, ops = attention_bound(args)
            res = {
                "case": name, "dtype": str(dtype).replace("torch.", ""),
                "window": window, "kinds": kinds,
                "pos": args[4].tolist(), "q_lens": args[5].tolist(),
                "max_abs_err": float(err.max()), "atol": atol, "rtol": rtol,
                "ms": time_ms(lambda: ragged_flash_attention(
                    *args, scale=scale)),
                "plain_ms": time_ms(lambda: ragged_gather_attention(
                    *args, scale=scale)),
                "library_ms": time_ms(library_call(args, scale)),
                "bound_ms": bound_ms, "bound_by": bound_by,
                "bytes": nbytes, "ops": ops, "card": card,
            }
            log(f"kernel {json.dumps(res)}")
            if not ok or not zero_tail:
                raise AssertionError(
                    f"ragged_paged_attention {name} {dtype}: max |err| "
                    f"{res['max_abs_err']:.3g} vs atol {atol} rtol {rtol}, "
                    f"zero tail {zero_tail}")
            results.append(res)
    return results


# ---------------------------------------------------------------------------
# phase 3: one ragged step at full width, card vs CPU


def _step_inputs(device, vocab):
    """Two packed window-8 steps: two 8-row prompt chunks beside a pad
    entry, then a decode row, the second prompt's next 8-row piece and a
    pad entry."""
    rs = np.random.RandomState(3)
    tables = np.zeros((3, 4), np.int32)
    tables[0, :1] = [5]
    tables[1, :1] = [9]
    deps = np.tile(np.arange(8, dtype=np.int32), (3, 1))
    anc = np.tile(np.tril(np.ones((8, 8), bool)), (3, 1, 1))
    steps = [(np.array([0, 0, 0], np.int32), np.array([8, 8, 0], np.int32)),
             (np.array([8, 8, 0], np.int32), np.array([1, 8, 0], np.int32))]
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return [(t(tables), t(pos), t(qls), t(deps), t(anc),
             t(rs.randint(0, vocab, (3, 8)).astype(np.int32)))
            for pos, qls in steps]


def phase_step(seed: int) -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = LlamaConfig.llama3_8b()
    cfg.layers = 2

    def make(device, params=None):
        ff = FFModel(FFConfig(batch_size=1, seed=seed, device=device))
        build_llama(ff, cfg, batch_size=1, seq_len=8, dtype=DataType.FLOAT)
        return ff.compile(params=params)

    def run(ff):
        ex = ff.executor
        caches = ex.init_paged_kv_cache(16, P)
        tr, ntr = ff._params
        out = []
        for tables, pos, qls, deps, anc, ids in _step_inputs(
                ex.device, cfg.vocab_size):
            p, caches = ex.ragged_step_fn(tr, ntr, caches, tables, pos,
                                          qls, deps, anc, ids)
            out.append(p.float().cpu())
        return torch.stack(out)

    card_ff = make(DEVICE)
    gpu = run(card_ff)
    # the card's seeded weights, copied to the CPU
    cpu = run(make("cpu", params=card_ff._params))
    del card_ff
    ok = torch.allclose(gpu, cpu, rtol=STEP_RTOL, atol=STEP_ATOL)
    res = {"shape": list(gpu.shape),
           "max_abs_err": float((gpu - cpu).abs().max()),
           # relative error where a probability is above 1e-6
           "max_rel_err": float(((gpu - cpu).abs() / cpu.abs())[
               cpu > 1e-6].max()),
           "rtol": STEP_RTOL, "atol": STEP_ATOL,
           "finite": bool(torch.isfinite(gpu).all())}
    log(f"step {json.dumps(res)}")
    torch.cuda.empty_cache()
    if not ok or not res["finite"]:
        raise AssertionError(f"card step disagrees with CPU step: {res}")
    return res


# ---------------------------------------------------------------------------
# phase 4: serving Llama-3-8B through the paged server


def phase_serve(seed: int, card: str) -> dict:
    cfg = LlamaConfig.llama3_8b()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    ff = FFModel(FFConfig(batch_size=1, seed=seed, device=DEVICE))
    build_llama(ff, cfg, batch_size=1, seq_len=2048,
                dtype=DataType.BFLOAT16)
    ff.compile()
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    server = ff.serve_generation(paged=True, slots=4, max_len=2048,
                                 page_size=64, prefill_chunk=64, seed=seed)
    rs = np.random.RandomState(seed)
    lens = rs.randint(128, 1025, size=8)
    prompts = [rs.randint(0, cfg.vocab_size, (n,)).astype(np.int32)
               for n in lens]
    try:
        # warm cuBLAS and the allocator off the clock
        server.generate(prompts[0][:16], max_new_tokens=2, timeout=600)
        steps0, served0 = server.ragged_steps, server.requests_served
        for k in KERNELS:
            k.launches = 0
        t1 = time.monotonic()
        futs = [server.submit(p, max_new_tokens=64) for p in prompts]
        outs = [f.result(timeout=900) for f in futs]
        wall = time.monotonic() - t1
        launches = {k.name: k.launches for k in KERNELS}
        steps = server.ragged_steps - steps0
        recs = server.metrics()["requests"][served0:]
    finally:
        server.stop()
    for o in outs:
        if len(o) != 64 or not ((0 <= o) & (o < cfg.vocab_size)).all():
            raise AssertionError(f"bad output {o}")
    n_attn = len(ff.executor.paged_kv_cache_specs(2, 1))  # one pool each
    if launches["ragged_paged_attention"] != n_attn * steps or steps == 0:
        raise AssertionError(f"launches {launches} != {n_attn} x {steps}")
    ttft = sorted(r["ttft_s"] for r in recs)
    # decode rate of each request: tokens after its first over the time
    # from its first token to its last
    decode_rates = [(r["decode_tokens"] - 1) / r["decode_s"] for r in recs]
    res = {
        "model": "llama3_8b", "layers": cfg.layers, "dtype": "bfloat16",
        "requests": len(outs), "prompt_lens": lens.tolist(),
        "new_tokens": 64, "ragged_steps": steps, "launches": launches,
        "wall_s": wall, "generated_tokens_per_s": 64 * len(outs) / wall,
        "decode_tokens_per_s_per_request_mean": float(np.mean(decode_rates)),
        "ttft_p50_s": ttft[len(ttft) // 2], "ttft_max_s": ttft[-1],
        "init_s": init_s,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "card": card,
    }
    log(f"serve {json.dumps(res)}")
    return res


# ---------------------------------------------------------------------------
# phase 5 (on request): where a serving step's time goes


def _decode_launch(device, vocab, rs, B=4, pos=1024):
    """A steady decode launch: B slots at `pos`, each with its own
    pages."""
    tables = (1 + np.arange(B * MAXP, dtype=np.int32)).reshape(B, MAXP)
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return (t(tables), t(np.full(B, pos, np.int32)),
            t(np.ones(B, np.int32)), t(np.zeros((B, 1), np.int32)),
            t(np.ones((B, 1, 1), bool)),
            t(rs.randint(0, vocab, (B, 1)).astype(np.int32)))


def _prefill_launch(device, vocab, rs, B=8, W=8, pos=512):
    """A packed prefill launch: B window-W pieces of prompts."""
    tables = (1 + np.arange(B * 16, dtype=np.int32)).reshape(B, 16) % 128 + 1
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return (t(tables.astype(np.int32)), t(np.full(B, pos, np.int32)),
            t(np.full(B, W, np.int32)),
            t(np.tile(np.arange(W, dtype=np.int32), (B, 1))),
            t(np.tile(np.tril(np.ones((W, W), bool)), (B, 1, 1))),
            t(rs.randint(0, vocab, (B, W)).astype(np.int32)))


def phase_profile(seed: int, card: str) -> dict:
    """Llama-3-8B bf16 ragged steps at the serving shapes, timed by the
    host clock around synchronised steps and traced with torch.profiler:
    device-busy time per step, idle share and the kernels by time."""
    from torch.profiler import ProfilerActivity, profile

    cfg = LlamaConfig.llama3_8b()
    ff = FFModel(FFConfig(batch_size=1, seed=seed, device=DEVICE))
    build_llama(ff, cfg, batch_size=1, seq_len=2048,
                dtype=DataType.BFLOAT16)
    ff.compile()
    ex = ff.executor
    tr, ntr = ff._params
    caches = ex.init_paged_kv_cache(NUM_PAGES, P)
    rs = np.random.RandomState(seed)
    out = {"card": card}
    for name, make in (("decode_b4_pos1024", _decode_launch),
                       ("prefill_8x8_pos512", _prefill_launch)):
        launch = make(DEVICE, cfg.vocab_size, rs)

        def step():
            return ex.ragged_step_fn(tr, ntr, caches, *launch)

        for _ in range(3):
            step()
        torch.cuda.synchronize()
        n = 10
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / n * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                step()
            torch.cuda.synchronize()
        # device-side events only (kernels, memcpy/memset): the CPU-side
        # aten ops also carry their children's device time
        evs = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
        dev_ms = sum(e.self_device_time_total for e in evs) / n / 1e3
        top = sorted(evs, key=lambda e: -e.self_device_time_total)[:8]
        res = {
            "wall_ms": wall_ms,
            "device_ms": dev_ms if evs else "not measured",
            "idle_share": (1 - dev_ms / wall_ms) if evs else "not measured",
            "device_launches": sum(e.count for e in evs) // n,
            "top": [(e.key[:60], e.self_device_time_total / n / 1e3,
                     e.count // n) for e in top],
        }
        log(f"profile {name} {json.dumps(res)}")
        out[name] = res
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default="1,2,3,4",
                    help="comma-separated phases to run (default 1,2,3,4; "
                    "5 profiles the serving steps)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    phases = {int(p) for p in args.phases.split(",")}
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", flush=True)
        return 2
    card = card_line()
    log(f"card {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    t0 = time.monotonic()
    secs = build(KERNELS)
    for k in KERNELS:
        k.function()  # load and bind
    log(f"build {json.dumps({'seconds': time.monotonic() - t0, 'per_source': secs})}")
    kern = phase_kernels(card) if 2 in phases else []
    if 3 in phases:
        phase_step(args.seed)
    serve = phase_serve(args.seed, card) if 4 in phases else None
    if 5 in phases:
        phase_profile(args.seed, card)
    main_case = next((r for r in kern if r["case"] == ATTENTION_CASES[0][0]
                      and r["dtype"] == "bfloat16"), None)
    entry = {
        "name": RAGGED_PAGED_ATTENTION.name, "route": "cuda",
        "source": "flexflow_tpu_torch/csrc/ragged_paged_attention.cu",
        "replaces": RAGGED_PAGED_ATTENTION.replaces,
        "launches": serve["launches"][RAGGED_PAGED_ATTENTION.name]
        if serve else 0,
    }
    if main_case is not None:
        entry.update({k: main_case[k] for k in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")})
        entry["tol"] = {"atol": main_case["atol"],
                        "rtol": main_case["rtol"]}
    print(card, flush=True)
    print(json.dumps({"kernels": [entry]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
