"""Chip smoke test of flexflow_tpu_torch, the PyTorch/CUDA port: drives the
port's two main paths on one NVIDIA card, paged Llama serving and Llama
training, and holds every hand-written kernel on it to its plain PyTorch
version.

    python3 chip_smoke.py            # phases 1,2,3,4,6 on one card
    python3 chip_smoke.py --phases 5 # + profiles of serving and training

Phases (each raises on failure: non-zero exit, no "ok" line):
  1. card: name and power limit; build every kernel from csrc/ (nvcc,
     sm_90a, one process per source, all started together);
  2. kernels vs their plain versions on the card, with kernel / plain /
     library times and the roofline bound: the ragged paged attention at
     the serving path's shapes (Llama-3-8B attention: H=32, Hkv=8,
     D=128, page 64, 129 pages; decode, chunk and pad entries; window 1
     and 8), and the flash-attention forward, dq and dk/dv kernels at
     the training path's shape (bench_1b attention: B 8, S = T 1024,
     H 16, Hkv 8, D 128, causal); bf16 and fp32;
  3. full-width checks, card against CPU on the same seeded weights, fp32
     with TF32 off: one packed ragged step at Llama-3-8B widths, depth 2;
     one Adam train step at bench_1b widths, depth 2, batch 1, seq 256
     (the loss and every parameter after the step);
  4. serving: Llama-3-8B (32 layers, bf16, random weights from a seed)
     through serve_generation(paged=True); 8 requests of 128..1024
     prompt tokens, 64 new tokens each; the ragged kernel must have
     launched once per layer and step (counts reset just before, read
     just after);
  5. (on request) torch.profiler breakdowns of one decode step, one
     prefill step and one bench_1b train step;
  6. training: bench_1b (16 layers, bf16, batch 8, seq 1024,
     remat="none", Adam lr 1e-4, random weights from a seed) through
     ff.fit for one epoch of 10 seeded batches, then 10 timed steps on
     one repeated batch (the loss must fall); each flash kernel must
     launch 16 times per step; then two remat="attention" steps, where
     the forward kernel launches twice per layer.
The line before the last is the kernel list as JSON; the last line is
{"ok": true, "device": {...}}. Exits non-zero without CUDA.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import warnings

import numpy as np
import torch
import torch.nn.functional as F

from flexflow_tpu_torch import (
    AdamOptimizer,
    DataType,
    FFConfig,
    FFModel,
    LossType,
    MetricsType,
)
from flexflow_tpu_torch.kernels import (
    FLASH_ATTENTION_DKV,
    FLASH_ATTENTION_DQ,
    FLASH_ATTENTION_FWD,
    KERNELS,
    RAGGED_PAGED_ATTENTION,
    build,
    launch_flash_attention_dkv,
    launch_flash_attention_dq,
    launch_flash_attention_fwd,
)
from flexflow_tpu_torch.models.llama import LlamaConfig, build_llama
from flexflow_tpu_torch.ops.flash_attention import (
    flash_attention_reference,
    flash_delta,
    flash_dkv_reference,
    flash_dq_reference,
)
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
# flash kernels vs plain versions, max |err| <= tol * max(1, max |plain|):
# fp32 differs by summation order only (out and lse 1e-5; the gradients
# sum up to 1024 products per element, 1e-4); bf16 rounds p and ds to
# bf16 at other points than the plain version and every output is bf16
FLASH_TOLS = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (2e-2, 2e-2)}
# card step vs CPU step, fp32 with TF32 off: summation order only
STEP_RTOL, STEP_ATOL = 1e-3, 1e-7
# card train step vs CPU train step, fp32 with TF32 off: the loss differs
# by summation order only (1e-5). Adam's first step moves each weight by
# lr * g / (|g| + eps): about lr whatever |g| is, so where a gradient
# element is near 0 a summation-order difference in it becomes a
# sizeable part of lr. Every weight is held to 2 lr (the most two first
# steps can differ), and all but a 1e-5 fraction of them to 1e-5
# absolute and relative (a wrong gradient moves ~half the weights of a
# leaf by lr)
TRAIN_LR = 1e-4
TRAIN_LOSS_RTOL, TRAIN_PARAM_TOL, TRAIN_OUTLIER_FRACTION = 1e-5, 1e-5, 1e-5

H, HKV, D, P, NUM_PAGES, MAXP = 32, 8, 128, 64, 129, 32
# the training path's attention: bench_1b at batch 8, seq 1024
FB, FS, FH, FHKV, FD = 8, 1024, 16, 8, 128
TRAIN_BATCH, TRAIN_SEQ, TRAIN_BATCHES, TIMED_STEPS = 8, 1024, 10, 10
DEVICE = "cuda"
FLASH_KERNELS = (FLASH_ATTENTION_FWD, FLASH_ATTENTION_DQ, FLASH_ATTENTION_DKV)


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
# phase 2: the flash-attention kernels against their plain versions


def flash_case(dtype, seed: int):
    """q, k, v and a fixed dO at the training path's attention shape."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)

    def rand(*shape):
        return torch.randn(*shape, generator=g, device=DEVICE).to(dtype)

    return (rand(FB, FS, FH, FD), rand(FB, FS, FHKV, FD),
            rand(FB, FS, FHKV, FD), rand(FB, FS, FH, FD))


def flash_bounds(q, k, causal: bool) -> dict:
    """{kernel: (bound_ms, bound_by, bytes, ops)}: every input read once
    and every output written once, against 4 (fwd), 6 (dq) or 8 (dk/dv)
    * D operations per visible (query head, key) pair at the operand
    type's peak."""
    B, S, Hq, Dh = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    isz = q.element_size()
    rows = np.arange(S)
    pairs = B * Hq * int((np.minimum(rows + 1, T) if causal
                          else np.full(S, T)).sum())
    qb, kvb, rowb = q.numel() * isz, k.numel() * isz, B * Hq * S * 4
    work = {
        # q, k, v in; out, lse out
        FLASH_ATTENTION_FWD.name: (qb + 2 * kvb + qb + rowb, 4 * Dh * pairs),
        # q, k, v, dO, lse, delta in; dq out
        FLASH_ATTENTION_DQ.name: (qb + 2 * kvb + qb + 2 * rowb + qb,
                                  6 * Dh * pairs),
        # q, k, v, dO, lse, delta in; dk, dv out
        FLASH_ATTENTION_DKV.name: (qb + 2 * kvb + qb + 2 * rowb + 2 * kvb,
                                   8 * Dh * pairs),
    }
    out = {}
    for name, (nbytes, ops) in work.items():
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = ops / PEAK_OPS[q.dtype]
        out[name] = (max(t_bytes, t_ops) * 1e3,
                     "bytes" if t_bytes >= t_ops else "operations", nbytes,
                     ops)
    return out


def sdpa_calls(q, k, v, do, scale):
    """The yardsticks (timed only; the port never calls them):
    F.scaled_dot_product_attention's causal GQA forward, and one
    autograd call of its backward (dq, dk and dv together)."""
    qh, kh, vh = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    doh = do.transpose(1, 2).contiguous()

    def fwd():
        return F.scaled_dot_product_attention(qh, kh, vh, is_causal=True,
                                              scale=scale, enable_gqa=True)

    out = fwd()
    return fwd, lambda: torch.autograd.grad(out, (qh, kh, vh), doh,
                                            retain_graph=True)


def phase_flash_kernels(card: str) -> dict:
    """Each flash kernel against its plain version on the same inputs
    (K2's take the plain forward's lse and delta), causal, both dtypes.
    Returns {dtype name: {kernel name: result}}."""
    scale = 1.0 / FD ** 0.5
    results = {}
    for seed, dtype in enumerate((torch.bfloat16, torch.float32)):
        q, k, v, do = flash_case(dtype, seed)
        fwd_tol, grad_tol = FLASH_TOLS[dtype]
        out = torch.empty_like(q)
        lse = torch.empty(FB, FH, FS, device=DEVICE)
        dq = torch.empty_like(q)
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        want_out, want_lse = flash_attention_reference(q, k, v, True, scale)
        delta = flash_delta(do, want_out)
        bwd_args = (q, k, v, do, want_lse, delta)
        want_dq = flash_dq_reference(*bwd_args, True, scale)
        want_dk, want_dv = flash_dkv_reference(*bwd_args, True, scale)
        # name: (kernel launch, plain version, (got, want) pairs, tol)
        calls = {
            FLASH_ATTENTION_FWD.name: (
                lambda: launch_flash_attention_fwd(q, k, v, out, lse, True,
                                                   scale),
                lambda: flash_attention_reference(q, k, v, True, scale),
                [(out, want_out), (lse, want_lse)], fwd_tol),
            FLASH_ATTENTION_DQ.name: (
                lambda: launch_flash_attention_dq(*bwd_args, dq, True,
                                                  scale),
                lambda: flash_dq_reference(*bwd_args, True, scale),
                [(dq, want_dq)], grad_tol),
            FLASH_ATTENTION_DKV.name: (
                lambda: launch_flash_attention_dkv(*bwd_args, dk, dv, True,
                                                   scale),
                lambda: flash_dkv_reference(*bwd_args, True, scale),
                [(dk, want_dk), (dv, want_dv)], grad_tol),
        }
        lib_fwd, lib_bwd = sdpa_calls(q, k, v, do, scale)
        lib_ms = {FLASH_ATTENTION_FWD.name: time_ms(lib_fwd)}
        lib_ms[FLASH_ATTENTION_DQ.name] = lib_ms[FLASH_ATTENTION_DKV.name] \
            = time_ms(lib_bwd)
        bounds = flash_bounds(q, k, True)
        per = {}
        for name, (kernel, plain, pairs, tol) in calls.items():
            kernel()
            torch.cuda.synchronize()
            errs, ok = [], True
            for got, want in pairs:
                err = float((got.float() - want.float()).abs().max())
                limit = tol * max(1.0, float(want.float().abs().max()))
                errs.append(err)
                ok = ok and err <= limit
            bound_ms, bound_by, nbytes, ops = bounds[name]
            res = {
                "case": "bench_1b_causal", "kernel": name,
                "dtype": str(dtype).replace("torch.", ""),
                "shape": [FB, FS, FH, FHKV, FD],
                "max_abs_err": max(errs), "tol": tol,
                "ms": time_ms(kernel), "plain_ms": time_ms(plain),
                "library_ms": lib_ms[name], "bound_ms": bound_ms,
                "bound_by": bound_by, "bytes": nbytes, "ops": ops,
                "card": card,
            }
            log(f"kernel {json.dumps(res)}")
            if not ok:
                raise AssertionError(
                    f"{name} {dtype}: max |err| {errs} over tol {tol} x "
                    "max(1, max |plain|)")
            per[name] = res
        results[res["dtype"]] = per
    torch.cuda.empty_cache()
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


def _train_model(cfg, device, *, batch, seq, dtype, remat, seed,
                 params=None) -> FFModel:
    """build_llama -> compile(Adam lr 1e-4, sparse CE, accuracy and
    sparse-CE metrics), the training path's entry points."""
    ff = FFModel(FFConfig(batch_size=batch, seed=seed, device=device,
                          remat=remat))
    build_llama(ff, cfg, batch_size=batch, seq_len=seq, dtype=dtype)
    return ff.compile(
        optimizer=AdamOptimizer(lr=TRAIN_LR),
        loss_type=LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
        metrics=[MetricsType.ACCURACY,
                 MetricsType.SPARSE_CATEGORICAL_CROSSENTROPY],
        params=params)


def _token_batches(n: int, seq: int, vocab: int, seed: int):
    """n sequences of seeded random tokens, labels the next token."""
    x = np.random.RandomState(seed).randint(0, vocab, (n, seq)).astype(
        np.int32)
    return x, np.roll(x, -1, axis=1).astype(np.int32)


def phase_train_step(seed: int) -> dict:
    """One Adam train step at bench_1b widths, depth 2, fp32 (TF32 off),
    batch 1, seq 256: the card against the CPU from the same seeded
    weights, the loss and every parameter after the step."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = LlamaConfig.bench_1b()
    cfg.layers = 2
    kw = dict(batch=1, seq=256, dtype=DataType.FLOAT, remat="none",
              seed=seed)
    card_ff = _train_model(cfg, DEVICE, **kw)
    # the card's seeded weights, copied to the CPU before the step
    cpu_ff = _train_model(cfg, "cpu", **kw, params=tuple(
        {k: {n: t.cpu() for n, t in w.items()} for k, w in tree.items()}
        for tree in card_ff._params))
    x, y = _token_batches(1, 256, cfg.vocab_size, seed + 1)
    out = []
    for ff in (card_ff, cpu_ff):
        ex = ff.executor
        tr, ntr = ff._params
        bx, by = (torch.from_numpy(a).to(ex.device) for a in (x, y))
        tr, ntr, _, m = ex.train_step(tr, ntr, ff._opt_state, by, bx)
        out.append((float(m["loss"]), {f"{k}/{n}": t.cpu() for k, w in
                                       tr.items() for n, t in w.items()}))
    (gl, gp), (cl, cp) = out
    diffs = {n: (gp[n] - cp[n]).abs() for n in gp}
    worst = max(diffs, key=lambda n: float(diffs[n].max()))
    outside = sum(int((d > TRAIN_PARAM_TOL * (1 + cp[n].abs())).sum())
                  for n, d in diffs.items())
    total = sum(d.numel() for d in diffs.values())
    res = {"model": "bench_1b", "layers": 2, "loss_card": gl,
           "loss_cpu": cl, "loss_rel_err": abs(gl - cl) / abs(cl),
           "max_param_abs_err": float(diffs[worst].max()),
           "worst_param": worst, "weights": total,
           "weights_outside_tol": outside, "lr": TRAIN_LR,
           "loss_rtol": TRAIN_LOSS_RTOL, "param_tol": TRAIN_PARAM_TOL,
           "outlier_fraction_allowed": TRAIN_OUTLIER_FRACTION}
    log(f"train_step {json.dumps(res)}")
    del card_ff, cpu_ff
    torch.cuda.empty_cache()
    ok = (np.isfinite(gl) and res["loss_rel_err"] <= TRAIN_LOSS_RTOL
          and res["max_param_abs_err"] <= 2 * TRAIN_LR
          and outside <= TRAIN_OUTLIER_FRACTION * total)
    if not ok:
        raise AssertionError(f"card train step disagrees with CPU: {res}")
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


def _profile_summary(prof, n: int, wall_ms: float) -> dict:
    """Device-busy ms per step, idle share, device launches and the
    kernels by time from a torch.profiler run of n steps. Device-side
    events only (kernels, memcpy/memset): the CPU-side aten ops also
    carry their children's device time."""
    evs = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and e.self_device_time_total > 0]
    dev_ms = sum(e.self_device_time_total for e in evs) / n / 1e3
    top = sorted(evs, key=lambda e: -e.self_device_time_total)[:10]
    return {
        "wall_ms": wall_ms,
        "device_ms": dev_ms if evs else "not measured",
        "idle_share": (1 - dev_ms / wall_ms) if evs else "not measured",
        "device_launches": sum(e.count for e in evs) // n,
        "top": [(e.key[:60], e.self_device_time_total / n / 1e3,
                 e.count // n) for e in top],
    }


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
        res = _profile_summary(prof, n, wall_ms)
        log(f"profile {name} {json.dumps(res)}")
        out[name] = res
    return out


# ---------------------------------------------------------------------------
# phase 6: training bench_1b through ff.fit


def llama_flops_per_token(cfg, seq: int) -> float:
    """Matmul FLOPs per trained token, forward and backward, causal
    attention at half density: the model of bench.py's
    _flops_per_token (bench.py:94), copied."""
    hd = cfg.dim // cfg.heads
    per_layer = (cfg.dim * cfg.heads * hd + 2 * cfg.dim * cfg.kv_heads * hd
                 + cfg.heads * hd * cfg.dim + 3 * cfg.dim * cfg.hidden)
    n_matmul = cfg.layers * per_layer + cfg.dim * cfg.vocab_size
    return 6.0 * n_matmul + 6.0 * cfg.layers * seq * cfg.dim


def _flash_launches() -> dict:
    return {k.name: k.launches for k in FLASH_KERNELS}


def _reset_launches():
    for k in KERNELS:
        k.launches = 0


def phase_train(seed: int, card: str) -> dict:
    """bench_1b, bf16, batch 8, seq 1024: one ff.fit epoch of 10 seeded
    batches (the main path; counts reset just before, read just after),
    10 timed train steps on one repeated batch, then two steps with
    remat="attention"."""
    cfg = LlamaConfig.bench_1b()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    ff = _train_model(cfg, DEVICE, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                      dtype=DataType.BFLOAT16, remat="none", seed=seed)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    x, y = _token_batches(TRAIN_BATCH * TRAIN_BATCHES, TRAIN_SEQ,
                          cfg.vocab_size, seed)
    _reset_launches()
    t0 = time.monotonic()
    pm = ff.fit(x, y, epochs=1, verbose=False)
    torch.cuda.synchronize()
    fit_s = time.monotonic() - t0
    fit_launches = _flash_launches()
    want = cfg.layers * TRAIN_BATCHES
    if any(n != want for n in fit_launches.values()) \
            or RAGGED_PAGED_ATTENTION.launches != 0:
        raise AssertionError(f"fit launches {fit_launches} != {want} each")
    fit_loss = pm.sparse_cce_loss / pm.train_all
    if pm.train_all != TRAIN_BATCH * TRAIN_BATCHES \
            or not np.isfinite(fit_loss):
        raise AssertionError(f"fit: {pm}")

    # timed steps on one repeated batch, already on the card
    ex = ff.executor
    tr, ntr = ff._params
    opt = ff._opt_state
    bx, by = (torch.from_numpy(a[:TRAIN_BATCH]).to(DEVICE) for a in (x, y))
    torch.cuda.synchronize()
    _reset_launches()
    losses = []
    # every host sync inside the steps is reported as a warning
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as syncs:
        warnings.simplefilter("always")
        t0 = time.perf_counter()
        for _ in range(TIMED_STEPS):
            tr, ntr, opt, m = ex.train_step(tr, ntr, opt, by, bx)
            losses.append(m["loss"])
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / TIMED_STEPS
    torch.cuda.set_sync_debug_mode("default")
    host_syncs = sorted({str(w.message)[:120] for w in syncs})
    losses = [float(v) for v in losses]
    timed_launches = _flash_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops = llama_flops_per_token(cfg, TRAIN_SEQ) * tokens
    res = {
        "model": "bench_1b", "layers": cfg.layers, "dtype": "bfloat16",
        "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "remat": "none",
        "params": sum(t.numel() for w in tr.values() for t in w.values()),
        "init_s": init_s, "fit_s": fit_s, "fit_steps": TRAIN_BATCHES,
        "fit_loss": fit_loss, "fit_launches": fit_launches,
        "timed_steps": TIMED_STEPS, "losses": losses,
        "timed_launches": timed_launches, "step_ms": step_s * 1e3,
        "host_syncs_in_timed_steps": host_syncs,
        "tokens_per_s": tokens / step_s, "flops_per_step": flops,
        "mfu": flops / step_s / PEAK_OPS[torch.bfloat16],
        "peak_mem_gb": peak_gb, "card": card,
    }
    del ff, ex, tr, ntr, opt, m
    torch.cuda.empty_cache()
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"loss on a repeated batch did not fall: "
                             f"{losses}")
    if any(n != cfg.layers * TIMED_STEPS for n in timed_launches.values()):
        raise AssertionError(f"timed launches {timed_launches}")

    # remat="attention": checkpoint re-runs the forward kernel in backward
    torch.cuda.reset_peak_memory_stats()
    ff = _train_model(cfg, DEVICE, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                      dtype=DataType.BFLOAT16, remat="attention", seed=seed)
    _reset_launches()
    pm = ff.fit(x[:2 * TRAIN_BATCH], y[:2 * TRAIN_BATCH], verbose=False)
    torch.cuda.synchronize()
    remat = {"steps": 2, "loss": pm.sparse_cce_loss / pm.train_all,
             "launches": _flash_launches()}
    # timed after the fit: the first checkpointed step pays a one-time
    # import of torch's compiler stack, seconds long
    ex = ff.executor
    tr, ntr = ff._params
    opt = ff._opt_state
    t0 = time.perf_counter()
    for _ in range(3):
        tr, ntr, opt, m = ex.train_step(tr, ntr, opt, by, bx)
    torch.cuda.synchronize()
    remat["step_ms"] = (time.perf_counter() - t0) / 3 * 1e3
    remat["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    res["remat_attention"] = remat
    del ff, ex, tr, ntr, opt, m
    torch.cuda.empty_cache()
    log(f"train {json.dumps(res)}")
    want = {FLASH_ATTENTION_FWD.name: 2 * cfg.layers * 2,
            FLASH_ATTENTION_DQ.name: cfg.layers * 2,
            FLASH_ATTENTION_DKV.name: cfg.layers * 2}
    if remat["launches"] != want or not np.isfinite(remat["loss"]):
        raise AssertionError(f"remat='attention' run: {remat}, launches "
                             f"wanted {want}")
    return res


def phase_profile_train(seed: int, card: str) -> dict:
    """One bench_1b train step (bf16, batch 8, seq 1024, remat none),
    timed by the host clock around synchronised steps and traced with
    torch.profiler: device-busy time, idle share, kernels by time."""
    from torch.profiler import ProfilerActivity, profile

    cfg = LlamaConfig.bench_1b()
    ff = _train_model(cfg, DEVICE, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                      dtype=DataType.BFLOAT16, remat="none", seed=seed)
    ex = ff.executor
    state = list(ff._params) + [ff._opt_state]
    x, y = _token_batches(TRAIN_BATCH, TRAIN_SEQ, cfg.vocab_size, seed)
    bx, by = (torch.from_numpy(a).to(DEVICE) for a in (x, y))

    def step():
        state[0], state[1], state[2], _ = ex.train_step(*state, by, bx)

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    n = 3
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
    res = _profile_summary(prof, n, wall_ms)
    res["card"] = card
    log(f"profile train_step {json.dumps(res)}")
    del ff, ex, state
    torch.cuda.empty_cache()
    return res


def _kernel_entry(kernel, source: str, launches: int, res) -> dict:
    """One kernel's record for the kernels line: its main-path launches
    and, when phase 2 ran, its measured case."""
    entry = {"name": kernel.name, "route": "cuda", "source": source,
             "replaces": kernel.replaces, "launches": launches}
    if res is not None:
        entry.update({k: res[k] for k in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")})
        entry["tol"] = ({"atol": res["atol"], "rtol": res["rtol"]}
                        if "atol" in res else
                        {"max_abs_err_over_max_plain": res["tol"]})
    return entry


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default="1,2,3,4,6",
                    help="comma-separated phases to run (default "
                    "1,2,3,4,6; 5 profiles serving and training steps)")
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
    flash = phase_flash_kernels(card) if 2 in phases else {}
    if 3 in phases:
        phase_step(args.seed)
        phase_train_step(args.seed)
    serve = phase_serve(args.seed, card) if 4 in phases else None
    train = phase_train(args.seed, card) if 6 in phases else None
    if 5 in phases:
        phase_profile(args.seed, card)
        phase_profile_train(args.seed, card)
    main_case = next((r for r in kern if r["case"] == ATTENTION_CASES[0][0]
                      and r["dtype"] == "bfloat16"), None)
    entries = [_kernel_entry(
        RAGGED_PAGED_ATTENTION,
        "flexflow_tpu_torch/csrc/ragged_paged_attention.cu",
        serve["launches"][RAGGED_PAGED_ATTENTION.name] if serve else 0,
        main_case)]
    for k, src in ((FLASH_ATTENTION_FWD, "flash_attention_fwd.cu"),
                   (FLASH_ATTENTION_DQ, "flash_attention_bwd.cu"),
                   (FLASH_ATTENTION_DKV, "flash_attention_bwd.cu")):
        entries.append(_kernel_entry(
            k, f"flexflow_tpu_torch/csrc/{src}",
            train["fit_launches"][k.name] if train else 0,
            flash.get("bfloat16", {}).get(k.name)))
    print(card, flush=True)
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
