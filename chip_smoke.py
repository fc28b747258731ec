"""Chip smoke test of flexflow_tpu_torch, the PyTorch/CUDA port: drives the
port's main paths on one NVIDIA card, paged Llama serving (fp and int8 KV
pools, prefix cache, preemption, defrag), Llama training (head dims 128
and 64), GPT-2 training and paged serving, and Llama training through
ring attention, and holds every hand-written kernel on them to its plain
PyTorch version.

    python3 chip_smoke.py            # phases 1,2,3,4,6,7,8,9,10,11, one card
    python3 chip_smoke.py --phases 5 # + profiles of serving and training

Phases (each raises on failure: non-zero exit, no "ok" line):
  1. card: name and power limit; build every kernel from csrc/ (nvcc,
     sm_90a, one process per source, all started together), with the
     seconds each source took and the HGMMA (wgmma) instructions in the
     SASS of each tensor-core flash kernel: K1/K2's and K4's forward, dq
     and dk/dv and K5's forward at head dims 64, 128 and 256
     (WGMMA_KERNELS), and the tf32 HMMA (mma.sync) instructions of the
     3xTF32 fp32 bodies: K4's forward, dq and dk/dv at those widths and
     K2's flat dq and dk/dv at 128 and 256 (TF32_KERNELS);
  2. kernels vs their plain versions on the card, with kernel / plain /
     library times and the roofline bound: the ragged paged attention at
     the serving path's shapes (Llama-3-8B attention: H=32, Hkv=8,
     D=128, page 64, 129 pages; decode, chunk and pad entries; window 1
     and 8; a decode at the end of the 32-page table; and GPT-2 XL's
     decode: H = Hkv = 25, D 64) over fp pools, the fp kernel's pages
     per split swept at the steady decode case (SPLIT_SWEEP, fp and int8
     pools), over int8 pools (Llama's cases) written by the port's own
     quantize-on-append, and over a bf16 pool under fp32 q; and the
     flash-attention forward, dq and dk/dv kernels at the training
     path's shape (bench_1b attention: B 8, S = T 1024, H 16, Hkv 8,
     D 128, causal), then at a ragged S = T = 1000, at S 256 against
     T 1024 (full), at head dim 256 (Gemma-7B's attention: B 2, S = T
     1024, 16 heads of 256, causal) and at 384 and 512 (FLASH_CASES);
     bf16 and fp32 (K2's fp32 at 128 and 256 on its 3xTF32 body, with
     the body's floor, 3 x ops at the tf32 peak, beside the bound); and
     the head-major flash kernels K4 (forward, dq, dk/dv) at GPT-2 XL
     training's shape (B*H 8*25, S = T 1024, D 64, causal) and at phase
     11's (B*H 8*16, bf16) with times, then at head dims 48, 80, 96, 100
     and 256, non-causal, S != T, S not a multiple of the tile and phase
     10's ring block (B*H 16, S = T 2048, D 128, causal and full), each
     timed beside SDPA in its dtype and each backward also fed a shifted
     lse (the ring's contract); the flash
     checks (max |err|, error norm, lse; FLASH_TOLS, LSE_ATOL) must
     reject a planted fault at GPT-2 XL's shape, bf16 and fp32 (the
     plain results with one key tile skipped for the last query rows);
     fp32 cases' library time is SDPA's in fp32; K1/K2 timed at
     D 64 on the same shape beside K4 and the head-major route; the ring
     step K5 at phase 10's block (B*H 16, S = T
     2048, D 128, full and causal, a carried-in state) with times, then at
     head dims 48..256 and S != T;
  3. full-width checks, card against CPU on the same seeded weights, fp32
     with TF32 off: two packed ragged steps at Llama-3-8B widths, depth 2,
     on an fp pool and on an int8 pool, and at GPT-2 XL widths, depth 2,
     on an fp pool; one Adam train step at bench_1b widths and one at
     GPT-2 XL widths, depth 2, batch 1, seq 256 (the loss and every
     parameter after the step), and one of the ring-built bench_1b,
     depth 2, seq 1024 over a {"seq": 4} mesh (K5 launched per fold;
     the bench_1b step launches K1 and K2 once a layer, K2 on its
     3xTF32 body);
     and the ring at a local sequence that is not a multiple of 128
     (s_loc 192, bench_1b's attention widths; the same K5 ring, no
     length gate): its output, gradients and launches;
  4. serving: Llama-3-8B (32 layers, bf16, random weights from a seed)
     through serve_generation(paged=True) at its defaults (prefix cache
     and preemption on); 8 requests of 128..1024 prompt tokens, 64 new
     tokens each; the ragged kernel must have launched once per layer and
     step (counts reset just before, read just after);
  5. (on request) torch.profiler breakdowns of one decode step, one
     prefill step, one decode step on an int8 pool (with the int8 ragged
     kernels' and quantize-on-append's launches and ms), one bench_1b
     train step, one GPT-2 XL train step, one phase-10 ring step and one
     phase-11 step;
  6. training: bench_1b (16 layers, bf16, batch 8, seq 1024,
     remat="none", Adam lr 1e-4, random weights from a seed) through
     ff.fit for one epoch of 10 seeded batches, then 10 timed steps on
     one repeated batch (the loss must fall); each flash kernel must
     launch 16 times per step; then two remat="attention" steps, where
     the forward kernel launches twice per layer;
  7. the whole paged server: Llama-3-8B (32 layers, bf16) through
     serve_generation(paged=True, kv_dtype="int8") with a pool smaller
     than four slots' longest sequences; a 512-token system prompt served
     first, then 8 requests of that prompt + a 64..512-token suffix, 192
     new tokens each, and a defrag while they run; the int8 kernel must
     launch once per layer and step and the fp kernel never, the shared
     pages must hit, growth must preempt, and the pool's invariants must
     hold after the drain;
  8. training GPT-2 XL (openai-community/gpt2-xl widths: vocab 50257, dim
     1600, 48 layers, 25 heads of 64, FFN 6400, 1024 positions; declared
     bf16, fp32 from the position add on as the reference computes it,
     batch 8, seq 1024, remat="none", Adam lr 1e-4, random weights from a
     seed) through ff.fit for one epoch of 10 seeded batches, then 10
     timed steps on one repeated batch (the loss must fall); each K4
     kernel must launch 48 times per step and K1/K2 never, and two
     profiled steps must show K4's fp32 forward, dq and dk/dv on their
     3xTF32 bodies only (K4's forward and backward ms a step reported);
     then the
     masters before timed step 8 (where the loss jumps) give that step's
     loss and gradients, fp32, batch 1, on the card and on the CPU, which
     must agree;
  9. serving GPT-2 XL (48 layers, bf16, max_len 1024 = its position
     table) through serve_generation(paged=True) at its defaults; 8
     requests of 128..768 prompt tokens, 64 new tokens each; the ragged
     kernel must launch once per layer and step; max_len 1025 must be
     refused;
 10. training bench_1b (16 layers, full width, bf16) at Llama-3's
     8192-token context, batch 1, through ring attention over a
     {"seq": 4} mesh (remat="none", Adam lr 1e-4) through ff.fit for one
     epoch of 10 seeded batches, then 10 timed steps on one batch (the
     loss must fall); per layer and step K5 must fold 10 blocks and K4's
     dq and dk/dv kernels run once per fold, no other attention kernel;
     a profiled step must show K5 on its tensor-core body only (and its
     share of the device time); then the same model and weights without
     the ring (K1/K2 over all 8192 rows): its step time, and its logits
     against the ring's;
 11. training bench.py's 200m Llama (bench.py:56-58: vocab 32000, dim
     1024, 12 layers, 16 heads over 8 kv heads, head dim 64, FFN 2816;
     bf16, fp32 masters, batch 8, seq 1024, remat="none", Adam lr 1e-4,
     random weights from a seed) through ff.fit for one epoch of 10
     seeded batches, then 10 timed steps on one repeated batch (the loss
     must fall); each K4 kernel must launch 12 times per step and no
     other attention kernel, and a profiled step must show K4 on its
     tensor-core bodies only (K4's share of the device time reported).
     The kernels line takes K4's launches from this phase.
The line before the last is the kernel list as JSON; the last line is
{"ok": true, "device": {...}}. Exits non-zero without CUDA.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import re
import shutil
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
    FLASH_ATTENTION_BH_DKV,
    FLASH_ATTENTION_BH_DQ,
    FLASH_ATTENTION_BH_FWD,
    FLASH_ATTENTION_BH_FWD_CARRY,
    FLASH_ATTENTION_DKV,
    FLASH_ATTENTION_DQ,
    FLASH_ATTENTION_FWD,
    KERNELS,
    RAGGED_PAGED_ATTENTION,
    RAGGED_PAGED_ATTENTION_INT8,
    build,
    launch_ragged_paged_attention,
    launch_ragged_paged_attention_int8,
    launch_flash_attention_bh_dkv,
    launch_flash_attention_bh_dq,
    launch_flash_attention_bh_fwd,
    launch_flash_attention_bh_fwd_carry,
    launch_flash_attention_dkv,
    launch_flash_attention_dq,
    launch_flash_attention_fwd,
)
from flexflow_tpu_torch.models.gpt2 import GPT2Config, build_gpt2
from flexflow_tpu_torch.models.llama import LlamaConfig, build_llama
from flexflow_tpu_torch.ops.flash_attention import (
    FlashAttentionFunction,
    flash_attention,
    flash_attention_reference,
    flash_bh_delta,
    flash_bh_dkv_reference,
    flash_bh_dq_reference,
    flash_bh_fwd_carry_reference,
    flash_bh_reference,
    flash_delta,
    flash_dkv_reference,
    flash_dq_reference,
)
from flexflow_tpu_torch.paged.attention import (
    SplitPlan,
    ragged_flash_attention,
    ragged_gather_attention,
    ragged_split_plan,
    ragged_visibility_mask,
)
from flexflow_tpu_torch.paged.quant import dequantize_pages, quantized_append
from flexflow_tpu_torch.parallel.mesh import make_mesh
from flexflow_tpu_torch.parallel.ring import ring_dot_product_attention

# NVIDIA H100 SXM data sheet: HBM rate and dense peaks by operand type.
# fp32 operands reach the tensor cores as tf32 (3xTF32 keeps fp32's
# accuracy at 3 tf32 products each), so the least time of fp32 work takes
# the tf32 rate, not the 67 TF/s of fp32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 494.7e12}
# kernel vs plain version: fp32 differs by summation order only; bf16
# rounds probabilities to bf16 at different points (the kernel before
# normalising, the plain version after) and rounds the output to bf16
TOLS = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2e-2, 2e-2)}
# flash kernels vs plain versions, max |err| <= tol * max(1, max |plain|):
# fp32 differs by summation order only (out and lse 1e-5; the gradients
# sum up to 1024 products per element, 1e-4); bf16 rounds p and ds to
# bf16 at other points than the plain version and every output is bf16
FLASH_TOLS = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (2e-2, 2e-2)}
# and besides that max |err|, which scales with the tensor's largest value
# (row 0's v in a causal output) and so is loose for late rows: the error's
# norm within tol / 2 of the plain result's (||got - want|| <= tol / 2 *
# ||want||), and a forward's lse within LSE_ATOL of the plain lse
# everywhere. `planted_fault_check` shows that they reject a skipped key
# tile
LSE_ATOL = 1e-2
# int8 kernel vs plain version, max |err| <= tol * max(1, max |plain|), as
# for the flash kernels: an int8 pool is dequantized to fp32 and attended
# in fp32 by both (summation order only) for fp32 q; bf16 q rounds the
# output to bf16
INT8_TOLS = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
# card step vs CPU step, fp32 with TF32 off: summation order only
STEP_RTOL, STEP_ATOL = 1e-3, 1e-7
# the same on an int8 pool: the fp32 rows entering the pools differ by
# summation order, so a stored byte can land on the other side of a
# rounding boundary (+-1, rarely), and a scale (the amax of 128 elements
# of 4096-term dot products, / 127) by as much as those elements do: a
# few 1e-6 relative (H100 80GB HBM3: 1.17e-6 for the scales, 4.2e-6 for
# the fp step's probabilities); the probabilities follow within 1e-4
INT8_STEP_PROB_ATOL, INT8_STEP_BYTE_FRACTION, INT8_STEP_SCALE_RTOL = (
    1e-4, 1e-4, 1e-5)
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
K4_KERNELS = (FLASH_ATTENTION_BH_FWD, FLASH_ATTENTION_BH_DQ,
              FLASH_ATTENTION_BH_DKV)
# K4's main shape: GPT-2 XL training attention, B 8 x H 25 heads, S = T
# 1024, D 64, causal (the kernels line's case)
KB, KS, KH, KD = 8, 1024, 25, 64
# K5's main shape: one step of phase 10's ring, bench_1b attention at B 1
# x H 16 heads, s_loc = 8192 / 4 = 2048 rows of each block, D 128
K5_BH, K5_S, K5_D = 16, 2048, 128
# K4 beyond the main shape (name, B*H, S, T, D, causal): the head dims of
# the reference's own test (48), Phi-3-mini / OpenLLaMA-3B-like widths
# (80, 96, 100), the widest instantiation (256), BERT's non-causal
# route, S != T and S not a multiple of the 64-row tile, and phase 10's
# ring block, where K4's dq and dk/dv run the ring's backward (a causal
# block on the diagonal, a full one below it) against the final lse
K4_CASES = [
    ("d128_ring_block_causal", K5_BH, K5_S, K5_S, K5_D, True),
    ("d128_ring_block_full", K5_BH, K5_S, K5_S, K5_D, False),
    ("d48", 32, 512, 512, 48, True),
    ("d80", 32, 512, 512, 80, True),
    ("d96", 32, 512, 512, 96, True),
    ("d100", 32, 512, 512, 100, True),
    ("d256", 32, 512, 512, 256, True),
    ("d64_noncausal", 32, 512, 512, 64, False),
    ("d64_s1000_t1536", 16, 1000, 1536, 64, True),
    ("d96_s777_noncausal", 16, 777, 777, 96, False),
]
# K5 beyond the main shape (name, B*H, S, T, D, causal): the card test's
# head dims, S != T, S not a multiple of the tile
K5_CASES = [
    ("d48", 32, 512, 512, 48, True),
    ("d64", 32, 512, 512, 64, False),
    ("d80", 32, 512, 512, 80, True),
    ("d128", 32, 512, 512, 128, False),
    ("d256", 16, 512, 512, 256, True),
    ("d64_s1000_t1536", 16, 1000, 1536, 64, False),
    ("d128_s777_t300", 16, 777, 300, 128, True),
]
# K1/K2 at head dim 256: Gemma-7B's attention widths (16 heads of 256, no
# GQA), B 2, S = T 1024, causal
D256_SHAPE = (2, 1024, 16, 16, 256)
# K1/K2 beyond the main shape (name, (B, S, H, Hkv, D), T or None for S,
# causal): Gemma-7B's D 256; bench_1b's heads at a ragged S = T = 1000
# (plain attention sends any length to K1 on the card) and at S 256
# against T 1024, full; D 384 and 512, the flat route's widest (the
# CUDA-core bodies), 8 heads, B 2
FLASH_CASES = [
    ("gemma7b_d256_causal", D256_SHAPE, None, True),
    ("bench_1b_s1000_causal", (FB, 1000, FH, FHKV, FD), None, True),
    ("bench_1b_s256_t1024_full", (FB, 256, FH, FHKV, FD), 1024, False),
    ("d384_causal", (2, 1024, 8, 8, 384), None, True),
    ("d512_causal", (2, 1024, 8, 8, 512), None, True),
]
# phase 10: bench_1b at Llama-3's 8192-token context, cut over a
# {"seq": 4} mesh (s_loc 2048), batch 1, 10 batches for fit; then timed
# steps of the same model without the ring
RING_SEQ, RING_SHARDS, RING_BATCHES, RING_PLAIN_STEPS = 8192, 4, 10, 3
# ring vs plain route, bf16 forward logits at the same weights: the two
# fold the 8192 keys in other orders, so p is rounded to bf16 against
# other running maxima in each of 16 layers. A coarse check of the whole
# model, not set from a faulty ring: phase 2's kernel checks and phase
# 3's card-vs-CPU ring steps hold the ring to its contract
RING_LOGITS_RTOL = 0.1
GPT2_POSITIONS = 1024  # n_positions: the position table, serving's max_len
GPT2_BATCHES = 10
# phase 8's timed step (1-based) whose loss jumps in every run, and the
# card-vs-CPU gradient check of it: each leaf's gradient in norm, fp32
# with TF32 off, summation order only over 48 layers at seq 1024
GPT2_CHECK_STEP, GPT2_GRAD_RTOL = 8, 1e-3
# phase 9's traffic: 8 prompts uniform in 128..768 tokens, 64 new each
GPT2_PROMPTS, GPT2_PROMPT_MIN, GPT2_PROMPT_MAX, GPT2_NEW = 8, 128, 768, 64


def llama_200m() -> LlamaConfig:
    """bench.py's 200m profile, built inline as bench.py:56-58 builds it
    (no constructor of its own): vocab 32000, dim 1024, 12 layers, 16
    heads over 8 kv heads (head dim 64: the head-major route, K4), FFN
    2816."""
    return LlamaConfig(vocab_size=32000, dim=1024, layers=12, heads=16,
                       kv_heads=8, hidden=2816)


def gpt2_xl() -> GPT2Config:
    """openai-community/gpt2-xl config.json: vocab 50257, n_embd 1600,
    n_layer 48, n_head 25 (head dim 64), n_inner null (4 x 1600),
    layer_norm_epsilon 1e-5, gelu_new (= tanh-GELU)."""
    return GPT2Config(vocab_size=50257, dim=1600, layers=48, heads=25,
                      inner=0, ln_eps=1e-5)


def log(msg: str):
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0] if out else ""


# every tensor-core instantiation the sources build: K1/K2's bodies under
# the FlatLayout tag and K4's under HeadMajor, forward, dq and dk/dv, and
# K5's forward under HeadMajorCarry, at head dims 64, 128 and 256
WGMMA_KERNELS = tuple(f"flash_{k}_wgmma_kernel<{tag},{d}>"
                      for tag in ("FlatLayout", "HeadMajor")
                      for k in ("fwd", "dq", "dkv") for d in (64, 128, 256)
                      ) + tuple(f"flash_fwd_wgmma_kernel<HeadMajorCarry,{d}>"
                                for d in (64, 128, 256))


def wgmma_name(symbol: str):
    """'flash_fwd_wgmma_kernel<HeadMajor,64,128,2>' (kernel, layout tag,
    head dim, tile, stages) from a mangled or demangled symbol of one of
    the tensor-core bodies, or None."""
    m = re.search(r"(flash_(?:fwd|dq|dkv)_wgmma_kernel)I.*?"
                  r"(FlatLayout|HeadMajorCarry|HeadMajor)E((?:Li\d+E)+)",
                  symbol)
    if m:
        return f"{m[1]}<{m[2]},{','.join(re.findall(r'Li(\d+)E', m[3]))}>"
    m = re.search(r"(flash_(?:fwd|dq|dkv)_wgmma_kernel)<(?:ffwg::)?"
                  r"(FlatLayout|HeadMajorCarry|HeadMajor), ([\d, ]+)>",
                  symbol)
    return f"{m[1]}<{m[2]},{m[3].replace(' ', '')}>" if m else None


def hgmma_counts() -> dict:
    """{tensor-core kernel: HGMMA instructions in its SASS}, for every
    `flash_*_wgmma_kernel` instantiation of K1/K2's and K4/K5's built
    libraries (cuobjdump -sass): the proof that their bf16 bodies run on
    the tensor cores. Raises if one of WGMMA_KERNELS is missing or holds
    no HGMMA."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    counts = {}
    # the four flash sources: K1, K2, K4's forward, K4's backward
    for kern in (FLASH_ATTENTION_FWD, FLASH_ATTENTION_DQ,
                 FLASH_ATTENTION_BH_FWD, FLASH_ATTENTION_BH_DQ):
        sass = subprocess.run([tool, "-sass", str(kern.library_path())],
                              capture_output=True, text=True, timeout=300,
                              check=True).stdout
        name = None
        for line in sass.splitlines():
            if "Function :" in line:
                name = wgmma_name(line)
                if name:
                    counts[name] = 0
            elif name and "HGMMA" in line:
                counts[name] += 1
    found = {",".join(n.split(",")[:2]) + ">" for n in counts}
    if set(WGMMA_KERNELS) - found or not all(counts.values()):
        raise AssertionError(f"tensor-core kernels missing or without "
                             f"HGMMA: {counts}, want {WGMMA_KERNELS}")
    return counts


# the fp32 bodies on the tensor cores, 3xTF32 on mma.sync: K4's forward
# (flash_bh_fwd_tf32_kernel<D>), dq (false) and dk/dv (true) at head dims
# 64, 128 and 256, and K2's flat-layout dq and dk/dv at 128 and 256
TF32_KERNELS = tuple(
    f"flash_bh_fwd_tf32_kernel<{d}>" for d in (64, 128, 256)) + tuple(
    f"flash_bh_bwd_tf32_kernel<{k},{d}>"
    for k in ("false", "true") for d in (64, 128, 256)) + tuple(
    f"flash_bwd_tf32_kernel<{k},{d}>"
    for k in ("false", "true") for d in (128, 256))


def tf32_name(symbol: str):
    """'flash_bh_fwd_tf32_kernel<64>', 'flash_bh_bwd_tf32_kernel<true,64>'
    (K4) or 'flash_bwd_tf32_kernel<false,128>' (K2, flat layout) from a
    mangled or demangled symbol of a 3xTF32 body, or None."""
    m = re.search(r"(flash_(?:bh_fwd|bh_bwd|bwd)_tf32_kernel)I"
                  r"(?:Lb([01])E)?Li(\d+)E", symbol)
    if m:
        flag = "" if m[2] is None else \
            ("true," if m[2] == "1" else "false,")
        return f"{m[1]}<{flag}{m[3]}>"
    m = re.search(r"(flash_(?:bh_fwd|bh_bwd|bwd)_tf32_kernel)<"
                  r"(?:(false|true), )?(\d+)>", symbol)
    if not m:
        return None
    return f"{m[1]}<{'' if m[2] is None else m[2] + ','}{m[3]}>"


def tf32_hmma_counts() -> dict:
    """{3xTF32 body: tf32 HMMA instructions in its SASS} from K4's forward
    and backward libraries and K2's (cuobjdump -sass): the proof that
    the fp32 bodies of TF32_KERNELS run on the tensor cores. Raises if
    one of them is missing or holds none."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    counts, name = {}, None
    for kern in (FLASH_ATTENTION_BH_FWD, FLASH_ATTENTION_BH_DQ,
                 FLASH_ATTENTION_DQ):
        sass = subprocess.run(
            [tool, "-sass", str(kern.library_path())],
            capture_output=True, text=True, timeout=300, check=True).stdout
        for line in sass.splitlines():
            if "Function :" in line:
                name = tf32_name(line)
                if name:
                    counts[name] = 0
            elif name and "HMMA" in line and "TF32" in line:
                counts[name] += 1
    if set(TF32_KERNELS) - set(counts) or not all(counts.values()):
        raise AssertionError(f"3xTF32 bodies missing or without tf32 "
                             f"HMMA: {counts}, want {TF32_KERNELS}")
    return counts


# a spin on the card (torch.cuda._sleep cycles, ~1 ms at the H100's
# clock) before each timed call, so the host has queued the whole call
# before its start event is reached: the events then time the device's
# work and not the host's launch overhead
TIME_SLEEP_CYCLES = 2_000_000


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of one fn() call, by CUDA events around each call,
    with the 50 MB L2 cache flushed (a 64 MB buffer rewritten) before each:
    on the serving path every layer reads its own pool, so a kernel finds
    its K/V cold. The card spins TIME_SLEEP_CYCLES between the flush and
    the start event, so a call whose host side takes longer than its
    device side (a small kernel behind its Python wrapper) is timed on
    the device alone."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=DEVICE)
    for _ in range(warmup):
        fn()
    events = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(TIME_SLEEP_CYCLES)
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


def attention_case(window: int, kinds, dtype, seed: int, fixed_pos=None,
                   heads=(H, HKV, D)):
    """Inputs of one ragged attention call at the serving path's shapes
    (`heads` = (H, Hkv, D), Llama-3-8B's by default): one entry per kind
    ("decode" q_len 1, "chunk:N" q_len N, "pad"), positions `fixed_pos` or
    random up to ~2000, distinct random pages per entry."""
    nh, nkv, hd = heads
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
    q = torch.from_numpy(rs.standard_normal((B, window, nh, hd))
                         .astype(np.float32)).to(dev, dtype)
    kc = torch.from_numpy(rs.standard_normal((NUM_PAGES, P, nkv, hd))
                          .astype(np.float32)).to(dev, dtype)
    vc = torch.from_numpy(rs.standard_normal((NUM_PAGES, P, nkv, hd))
                          .astype(np.float32)).to(dev, dtype)
    return (q, kc, vc, torch.from_numpy(pt.astype(np.int32)).to(dev),
            torch.from_numpy(pos).to(dev), torch.from_numpy(qls).to(dev),
            torch.from_numpy(anc).to(dev))


def attention_bound(args, quantized: bool = False) -> tuple:
    """(bound_ms, bound_by, bytes, ops): the least time the card could
    take — every input byte the call needs read once (q; the K/V rows up
    to each entry's horizon at the pool's element size, and for an int8
    pool one fp32 scale per (page read, kv head) for K and for V; the
    descriptor), every output byte written once — against the ops the
    visible keys need (QK and PV dots, 4*D per visible (q head, key)
    pair) at the peak of the type they run in: q's, or fp32 for an int8
    pool (q is upcast and the pages dequantized to fp32)."""
    q, kc, vc, pt, pos, qls, anc = args
    B, S, nh, hd = q.shape
    nkv = kc.shape[2]
    isz, kv_isz = q.element_size(), kc.element_size()
    horizon = (pos.long() + qls.long()) * (qls > 0).long()
    kv_rows = int(horizon.sum())
    nbytes = (2 * q.numel() * isz + 2 * kv_rows * nkv * hd * kv_isz
              + pt.numel() * 4 + pos.numel() * 4 + qls.numel() * 4
              + anc.numel())
    if quantized:
        nbytes += 2 * int(((horizon + P - 1) // P).sum()) * nkv * 4
    vis = ragged_visibility_mask(pt, pos, qls, anc, P)
    live = torch.arange(S, device=q.device)[None, :] < qls[:, None]
    visible = int((vis.sum(-1) * live).sum())
    ops = 4 * hd * nh * visible
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS[torch.float32 if quantized else q.dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, ops)


def library_call(args, scale):
    """The yardstick: F.scaled_dot_product_attention on the pre-gathered
    K/V with the same visibility mask (timed only; the port never calls
    it)."""
    q, kc, vc, pt, pos, qls, anc = args
    B, S, nh, hd = q.shape
    nkv = kc.shape[2]
    kg = kc[pt.long()].reshape(B, -1, nkv, hd).transpose(1, 2).contiguous()
    vg = vc[pt.long()].reshape(B, -1, nkv, hd).transpose(1, 2).contiguous()
    qh = q.transpose(1, 2).contiguous()
    mask = ragged_visibility_mask(pt, pos, qls, anc, P)[:, None]
    try:
        F.scaled_dot_product_attention(qh, kg, vg, attn_mask=mask,
                                       scale=scale, enable_gqa=True)
        return lambda: F.scaled_dot_product_attention(
            qh, kg, vg, attn_mask=mask, scale=scale, enable_gqa=True)
    except TypeError:  # a torch without enable_gqa: repeat heads first
        kr = kg.repeat_interleave(nh // nkv, dim=1)
        vr = vg.repeat_interleave(nh // nkv, dim=1)
        return lambda: F.scaled_dot_product_attention(
            qh, kr, vr, attn_mask=mask, scale=scale)


# (name, window, entries, fixed position): the first is the serving
# path's steady decode launch (4 slots at pos 1024), the kernel line's
# case; the last decodes at the end of a full table (pos MAXP x P - 8:
# every split of the fp kernel live)
ATTENTION_CASES = [
    ("decode_b4_pos1024", 1, ["decode"] * 4, 1024),
    ("decode_pad_w1", 1, ["decode", "decode", "decode", "pad"], None),
    ("mixed_w8", 8, ["decode", "chunk:8", "chunk:5", "pad"], None),
    ("decode_b4_pos2040", 1, ["decode"] * 4, MAXP * P - 8),
]
# the fp kernel's pages per split timed at the kernel line's case (bf16
# and fp32 q) beside the plan's choice (ragged_split_plan)
SPLIT_SWEEP = (1, 2, 4, 8, MAXP)
# GPT-2 XL serving's steady decode launch: 25 heads of 64, no GQA; its
# 1024-row position table caps pos
GPT2_ATTENTION_CASE = ("gpt2_xl_decode_b4_pos960", 1, ["decode"] * 4, 960)
GPT2_HEADS = (25, 25, 64)


def phase_kernels(card: str) -> list:
    """The fp-pool ragged kernel against its plain version at Llama-3-8B's
    serving cases and GPT-2 XL's decode case, bf16 and fp32 q."""
    cases = [(c, (H, HKV, D)) for c in ATTENTION_CASES] + [
        (GPT2_ATTENTION_CASE, GPT2_HEADS)]
    results = []
    for dtype in (torch.bfloat16, torch.float32):
        for i, ((name, window, kinds, fixed), heads) in enumerate(cases):
            scale = 1.0 / heads[2] ** 0.5
            args = attention_case(window, kinds, dtype, seed=i,
                                  fixed_pos=fixed, heads=heads)
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
                "heads": list(heads), "window": window, "kinds": kinds,
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


def split_sweep(card: str) -> dict:
    """The split kernels at the kernel line's case with each SPLIT_SWEEP
    pages per split beside the plan's, bf16 and fp32 q, over the fp pool
    and over its int8 pages (keys "int8_<q dtype>"): every result held to
    the plain version (TOLS; INT8_TOLS) and timed. The times show the
    plan's choice against its neighbours."""
    name, window, kinds, fixed = ATTENTION_CASES[0]
    scale = 1.0 / D ** 0.5
    plan = ragged_split_plan(len(kinds), window, H, HKV, P, MAXP,
                             torch.cuda.get_device_properties(0)
                             .multi_processor_count)
    res = {"case": name, "plan_pages_per_split": plan.pages_per_split,
           "card": card}
    q, kc, vc, pt, pos, qls, anc = attention_case(
        window, kinds, torch.float32, seed=0, fixed_pos=fixed)
    kq, ks, vq, vs = int8_pools(kc, vc)
    for dtype in (torch.bfloat16, torch.float32):
        for pool in ("fp", "int8"):
            if pool == "fp":
                args = (q.to(dtype), kc.to(dtype), vc.to(dtype), pt, pos,
                        qls, anc)
                want = ragged_gather_attention(*args, scale=scale).float()
                atol, rtol = TOLS[dtype]
                launch = launch_ragged_paged_attention
            else:
                args = (q.to(dtype), kq, vq, ks, vs, pt, pos, qls, anc)
                want = ragged_gather_attention(
                    *args[:3], *args[5:], scale=scale, k_scales=ks,
                    v_scales=vs).float()
                atol = INT8_TOLS[dtype] * max(1.0, float(want.abs().max()))
                rtol = 0.0
                launch = launch_ragged_paged_attention_int8
            times = {}
            for pps in sorted(set(SPLIT_SWEEP) | {plan.pages_per_split}):
                sp = SplitPlan(pps, -(-MAXP // pps))
                out = torch.empty_like(args[0])

                def run():
                    return launch(*args, out, scale, sp)

                run()
                torch.cuda.synchronize()
                err = (out.float() - want).abs()
                if not bool((err <= atol + rtol * want.abs()).all()):
                    raise AssertionError(
                        f"split sweep {pool} pool {dtype} pps {pps}: max "
                        f"|err| {float(err.max()):.3g}")
                times[pps] = time_ms(run)
            key = str(dtype).replace("torch.", "")
            res[key if pool == "fp" else f"int8_{key}"] = times
    log(f"split_sweep {json.dumps(res)}")
    return res


def int8_pools(kc, vc):
    """(k pages, k scales, v pages, v scales): the int8 pool the port's own
    quantize-on-append writes for the seeded fp rows, one page a call."""
    N = kc.shape[0]
    out = []
    for x in (kc, vc):
        pool = torch.zeros(x.shape, dtype=torch.int8, device=x.device)
        scales = torch.zeros((N, HKV), device=x.device)
        off = torch.arange(P, device=x.device)[None]
        live = torch.ones((1, P), dtype=torch.bool, device=x.device)
        for page in range(N):
            quantized_append(pool, scales, x[page][None],
                             torch.full_like(off, page), off, live)
        out += [pool, scales]
    return out


def _kernel_check(name, dtype, tol, args, sc, scale, card, extra):
    """Launch the wrapper once, hold it to the plain version (max |err|
    <= tol * max(1, max |plain|), rows past q_len exact zeros), and time
    kernel, plain version and bound."""
    got = ragged_flash_attention(*args, scale=scale, **sc)
    want = ragged_gather_attention(*args, scale=scale, **sc)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    limit = tol * max(1.0, float(want.float().abs().max()))
    zero_tail = all(not got[b, int(args[5][b]):].any()
                    for b in range(args[0].shape[0]))
    bound_ms, bound_by, nbytes, ops = attention_bound(args, bool(sc))
    res = {
        "case": name, "dtype": str(dtype).replace("torch.", ""),
        "pool": str(args[1].dtype).replace("torch.", ""),
        "pos": args[4].tolist(), "q_lens": args[5].tolist(),
        "max_abs_err": err, "tol": tol, "limit": limit,
        "ms": time_ms(lambda: ragged_flash_attention(*args, scale=scale,
                                                     **sc)),
        "plain_ms": time_ms(lambda: ragged_gather_attention(
            *args, scale=scale, **sc)),
        "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
        "ops": ops, "card": card, **extra,
    }
    log(f"kernel {json.dumps(res)}")
    if err > limit or not zero_tail:
        raise AssertionError(f"{name} {dtype} {res['pool']} pool: max |err| "
                             f"{err:.3g} over {limit:.3g}, zero tail "
                             f"{zero_tail}")
    return res


def phase_int8_kernels(card: str) -> list:
    """The int8 kernel at the serving shapes (the cases of phase_kernels,
    q in bf16 and fp32) over int8 pages written by quantized_append from
    seeded rows; then the fp-pool kernel over a bf16 pool under fp32 q
    (the mixed-dtype route). No single PyTorch call dequantizes and
    attends, so library_ms is None; SDPA over the same pages
    pre-dequantized to bf16 is timed beside it as a yardstick only."""
    scale = 1.0 / D ** 0.5
    results = []
    for dtype in (torch.bfloat16, torch.float32):
        for i, (name, window, kinds, fixed) in enumerate(ATTENTION_CASES):
            q, kc, vc, pt, pos, qls, anc = attention_case(
                window, kinds, torch.float32, seed=i, fixed_pos=fixed)
            kq, ks, vq, vs = int8_pools(kc, vc)
            del kc, vc
            args = (q.to(dtype), kq, vq, pt, pos, qls, anc)
            deq = [dequantize_pages(p, s).bfloat16()
                   for p, s in ((kq, ks), (vq, vs))]
            yard = time_ms(library_call(
                (q.bfloat16(), *deq, pt, pos, qls, anc), scale))
            del deq
            results.append(_kernel_check(
                name, dtype, INT8_TOLS[dtype], args,
                {"k_scales": ks, "v_scales": vs}, scale, card,
                {"window": window, "kinds": kinds, "library_ms": None,
                 "library": "none (no single PyTorch call dequantizes "
                            "and attends)",
                 "sdpa_bf16_predequantized_ms": yard}))
    name, window, kinds, fixed = ATTENTION_CASES[0]
    q, kc, vc, pt, pos, qls, anc = attention_case(
        window, kinds, torch.float32, seed=0, fixed_pos=fixed)
    args = (q, kc.bfloat16(), vc.bfloat16(), pt, pos, qls, anc)
    del kc, vc
    results.append(_kernel_check(
        name + "_bf16_pool", torch.float32, TOLS[torch.float32][0], args,
        {}, scale, card,
        {"window": window, "kinds": kinds,
         "library_ms": time_ms(library_call(
             (q, args[1].float(), args[2].float(), pt, pos, qls, anc),
             scale)),
         "library": "SDPA over the pages cast to fp32"}))
    torch.cuda.empty_cache()
    return results


# ---------------------------------------------------------------------------
# phase 2: the flash-attention kernels against their plain versions


def _err_parts(got, want, tol, lse: bool = False) -> dict:
    """One (got, want) pair's verdicts: max |err| within tol x max(1, max
    |want|), ||got - want|| within tol / 2 x ||want||, and with `lse`
    every |err| within LSE_ATOL."""
    diff = got.float() - want.float()
    err = float(diff.abs().max())
    dn, wn = float(diff.norm()), float(want.float().norm())
    res = {"max_abs_err": err,
           "max_abs": err <= tol * max(1.0, float(want.float().abs().max())),
           "rel_norm_err": dn / wn if wn else (0.0 if dn == 0 else np.inf)}
    res["norm"] = res["rel_norm_err"] <= tol / 2
    if lse:
        res["lse"] = err <= LSE_ATOL
    return res


def _err_ok(pairs, tol, lse=None):
    """(max |err| over the (got, want) pairs and the (got, want) `lse`
    pair, whether every verdict of `_err_parts` holds for each, the
    largest ||got - want|| / ||want||)."""
    parts = [_err_parts(got, want, tol) for got, want in pairs]
    if lse is not None:
        parts.append(_err_parts(*lse, tol, lse=True))
    return (max(r["max_abs_err"] for r in parts),
            all(r["max_abs"] and r["norm"] and r.get("lse", True)
                for r in parts),
            max(r["rel_norm_err"] for r in parts))


def flash_case(dtype, seed: int, shape=(FB, FS, FH, FHKV, FD), T=None):
    """q, k, v and a fixed dO at `shape` = (B, S, H, Hkv, D), the training
    path's attention by default; k and v have T rows (S by default)."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    B, S, Hq, Hkv, Dh = shape
    T = S if T is None else T

    def rand(*dims):
        return torch.randn(*dims, generator=g, device=DEVICE).to(dtype)

    return (rand(B, S, Hq, Dh), rand(B, T, Hkv, Dh), rand(B, T, Hkv, Dh),
            rand(B, S, Hq, Dh))


def flash_bounds(q, k, causal: bool, kernels=FLASH_KERNELS) -> dict:
    """{kernel: (bound_ms, bound_by, bytes, ops)}: every input read once
    and every output written once, against 4 (fwd), 6 (dq) or 8 (dk/dv)
    * D operations per visible (query head, key) pair at the operand
    type's peak. q (B, S, H, D), k (B, T, Hkv, D); `kernels` names the
    (fwd, dq, dkv) triple (K4's head-major tensors pass as H = 1)."""
    B, S, Hq, Dh = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    isz = q.element_size()
    rows = np.arange(S)
    pairs = B * Hq * int((np.minimum(rows + 1, T) if causal
                          else np.full(S, T)).sum())
    qb, kvb, rowb = q.numel() * isz, k.numel() * isz, B * Hq * S * 4
    fwd, dq, dkv = (kk.name for kk in kernels)
    work = {
        # q, k, v in; out, lse out
        fwd: (qb + 2 * kvb + qb + rowb, 4 * Dh * pairs),
        # q, k, v, dO, lse, delta in; dq out
        dq: (qb + 2 * kvb + qb + 2 * rowb + qb, 6 * Dh * pairs),
        # q, k, v, dO, lse, delta in; dk, dv out
        dkv: (qb + 2 * kvb + qb + 2 * rowb + 2 * kvb, 8 * Dh * pairs),
    }
    out = {}
    for name, (nbytes, ops) in work.items():
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = ops / PEAK_OPS[q.dtype]
        out[name] = (max(t_bytes, t_ops) * 1e3,
                     "bytes" if t_bytes >= t_ops else "operations", nbytes,
                     ops)
    return out


def floor_3xtf32_ms(q, ops: int):
    """The least time of an fp32 body on the tensor cores in 3xTF32: 3
    tf32 products for each fp32 one at the tf32 peak (the design's floor,
    beside the bound, which counts one); None for another dtype."""
    if q.dtype != torch.float32:
        return None
    return 3 * ops / PEAK_OPS[torch.float32] * 1e3


def sdpa_calls(q, k, v, do, scale, causal=True):
    """The yardsticks (timed only; the port never calls them):
    F.scaled_dot_product_attention's GQA forward (causal: top-left, as
    the kernels), and one autograd call of its backward (dq, dk and dv
    together)."""
    qh, kh, vh = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    doh = do.transpose(1, 2).contiguous()

    def fwd():
        return F.scaled_dot_product_attention(qh, kh, vh, is_causal=causal,
                                              scale=scale, enable_gqa=True)

    out = fwd()
    return fwd, lambda: torch.autograd.grad(out, (qh, kh, vh), doh,
                                            retain_graph=True)


def phase_flash_kernels(card: str, shape=(FB, FS, FH, FHKV, FD),
                        case: str = "bench_1b_causal", T=None,
                        causal: bool = True) -> dict:
    """Each flash kernel against its plain version on the same inputs
    (K2's take the plain forward's lse and delta), both dtypes, at
    `shape` = (B, S, H, Hkv, D) with T keys (S by default). Returns
    {dtype name: {kernel name: result}}."""
    B, S, Hq, _, Dh = shape
    scale = 1.0 / Dh ** 0.5
    results = {}
    for seed, dtype in enumerate((torch.bfloat16, torch.float32)):
        q, k, v, do = flash_case(dtype, seed, shape, T)
        fwd_tol, grad_tol = FLASH_TOLS[dtype]
        out = torch.empty_like(q)
        lse = torch.empty(B, Hq, S, device=DEVICE)
        dq = torch.empty_like(q)
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        want_out, want_lse = flash_attention_reference(q, k, v, causal, scale)
        delta = flash_delta(do, want_out)
        bwd_args = (q, k, v, do, want_lse, delta)
        want_dq = flash_dq_reference(*bwd_args, causal, scale)
        want_dk, want_dv = flash_dkv_reference(*bwd_args, causal, scale)
        # name: (kernel launch, plain version, (got, want) pairs, tol,
        # (got, want) lse or None)
        calls = {
            FLASH_ATTENTION_FWD.name: (
                lambda: launch_flash_attention_fwd(q, k, v, out, lse,
                                                   causal, scale),
                lambda: flash_attention_reference(q, k, v, causal, scale),
                [(out, want_out)], fwd_tol, (lse, want_lse)),
            FLASH_ATTENTION_DQ.name: (
                lambda: launch_flash_attention_dq(*bwd_args, dq, causal,
                                                  scale),
                lambda: flash_dq_reference(*bwd_args, causal, scale),
                [(dq, want_dq)], grad_tol, None),
            FLASH_ATTENTION_DKV.name: (
                lambda: launch_flash_attention_dkv(*bwd_args, dk, dv,
                                                   causal, scale),
                lambda: flash_dkv_reference(*bwd_args, causal, scale),
                [(dk, want_dk), (dv, want_dv)], grad_tol, None),
        }
        lib_fwd, lib_bwd = sdpa_calls(q, k, v, do, scale, causal)
        lib_ms = {FLASH_ATTENTION_FWD.name: time_ms(lib_fwd)}
        lib_ms[FLASH_ATTENTION_DQ.name] = lib_ms[FLASH_ATTENTION_DKV.name] \
            = time_ms(lib_bwd)
        bounds = flash_bounds(q, k, causal)
        per = {}
        for name, (kernel, plain, pairs, tol, lse_pair) in calls.items():
            kernel()
            torch.cuda.synchronize()
            err, ok, rel = _err_ok(pairs, tol, lse_pair)
            bound_ms, bound_by, nbytes, ops = bounds[name]
            res = {
                "case": case, "kernel": name,
                "dtype": str(dtype).replace("torch.", ""),
                "shape": list(shape), "T": k.shape[1], "causal": causal,
                "max_abs_err": err, "rel_norm_err": rel, "tol": tol,
                "ms": time_ms(kernel), "plain_ms": time_ms(plain),
                "library_ms": lib_ms[name], "bound_ms": bound_ms,
                "bound_by": bound_by, "bytes": nbytes, "ops": ops,
                "floor_3xtf32_ms": floor_3xtf32_ms(q, ops), "card": card,
            }
            log(f"kernel {json.dumps(res)}")
            if not ok:
                raise AssertionError(
                    f"{name} {dtype}: outside tol {tol} (max |err| {err} "
                    "over tol x max(1, max |plain|), error norm over tol / "
                    "2 x the plain norm, or lse over LSE_ATOL)")
            per[name] = res
        results[res["dtype"]] = per
    torch.cuda.empty_cache()
    return results


# ---------------------------------------------------------------------------
# phase 2: the head-major flash kernels K4 against their plain versions


def k4_check(BH, S, T, D, causal, dtype, seed, timed=False):
    """K4's three kernels on seeded (BH, S, D) q / dO and (BH, T, D) k, v
    against their plain versions: the forward's out and lse, then dq and
    dk/dv fed the plain forward's lse and a shifted one (the ring
    backward's contract: the final lse, not the block's own). With
    `timed`, kernel / plain / SDPA times and the bound at this shape.
    Returns {kernel name: result}."""
    scale = 1.0 / D ** 0.5
    g = torch.Generator(device=DEVICE).manual_seed(seed)

    def rand(*shape):
        return torch.randn(*shape, generator=g, device=DEVICE).to(dtype)

    q, k, v, do = rand(BH, S, D), rand(BH, T, D), rand(BH, T, D), \
        rand(BH, S, D)
    fwd_tol, grad_tol = FLASH_TOLS[dtype]
    out = torch.empty_like(q)
    lse = torch.empty(BH, S, device=DEVICE)
    dq = torch.empty_like(q)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    want_out, want_lse = flash_bh_reference(q, k, v, causal, scale)
    delta = flash_bh_delta(do, want_out)
    shifted = want_lse + torch.rand(BH, S, generator=g, device=DEVICE)
    fwd = lambda: launch_flash_attention_bh_fwd(  # noqa: E731
        q, k, v, out, lse, causal, scale)
    fwd()
    torch.cuda.synchronize()
    errs = {FLASH_ATTENTION_BH_FWD.name: _err_ok(
        [(out, want_out)], fwd_tol, (lse, want_lse))}
    bwd_err = {FLASH_ATTENTION_BH_DQ.name: [], FLASH_ATTENTION_BH_DKV.name: []}
    for given in (want_lse, shifted):
        args = (q, k, v, do, given, delta)
        launch_flash_attention_bh_dq(*args, dq, causal, scale)
        launch_flash_attention_bh_dkv(*args, dk, dv, causal, scale)
        torch.cuda.synchronize()
        want_dk, want_dv = flash_bh_dkv_reference(*args, causal, scale)
        bwd_err[FLASH_ATTENTION_BH_DQ.name].append(_err_ok(
            [(dq, flash_bh_dq_reference(*args, causal, scale))], grad_tol))
        bwd_err[FLASH_ATTENTION_BH_DKV.name].append(_err_ok(
            [(dk, want_dk), (dv, want_dv)], grad_tol))
        del want_dk, want_dv
    for name, pair in bwd_err.items():
        errs[name] = (max(e[0] for e in pair), all(e[1] for e in pair),
                      max(e[2] for e in pair))
    res = {}
    for kernel in K4_KERNELS:
        err, ok, rel = errs[kernel.name]
        res[kernel.name] = {
            "kernel": kernel.name, "dtype": str(dtype).replace("torch.", ""),
            "shape": [BH, S, T, D], "causal": causal, "max_abs_err": err,
            "rel_norm_err": rel,
            "tol": fwd_tol if kernel is FLASH_ATTENTION_BH_FWD else grad_tol,
            "ok": ok}
    if timed:
        bwd_args = (q, k, v, do, want_lse, delta)
        calls = {
            FLASH_ATTENTION_BH_FWD.name: (
                fwd, lambda: flash_bh_reference(q, k, v, causal, scale)),
            FLASH_ATTENTION_BH_DQ.name: (
                lambda: launch_flash_attention_bh_dq(*bwd_args, dq, causal,
                                                     scale),
                lambda: flash_bh_dq_reference(*bwd_args, causal, scale)),
            FLASH_ATTENTION_BH_DKV.name: (
                lambda: launch_flash_attention_bh_dkv(*bwd_args, dk, dv,
                                                      causal, scale),
                lambda: flash_bh_dkv_reference(*bwd_args, causal, scale)),
        }
        bounds = flash_bounds(q[:, :, None], k[:, :, None], causal,
                              K4_KERNELS)
        lib_fwd, lib_bwd = sdpa_bh_calls(q, k, v, do, scale, causal)
        lib_ms = {FLASH_ATTENTION_BH_FWD.name: time_ms(lib_fwd)}
        lib_ms[FLASH_ATTENTION_BH_DQ.name] = \
            lib_ms[FLASH_ATTENTION_BH_DKV.name] = time_ms(lib_bwd)
        for name, (kernel, plain) in calls.items():
            bound_ms, bound_by, nbytes, ops = bounds[name]
            res[name].update({
                "ms": time_ms(kernel), "plain_ms": time_ms(plain),
                "library_ms": lib_ms[name], "bound_ms": bound_ms,
                "bound_by": bound_by, "bytes": nbytes, "ops": ops,
                "floor_3xtf32_ms": floor_3xtf32_ms(q, ops)})
    return res


def sdpa_bh_calls(q, k, v, do, scale, causal):
    """The yardsticks for K4 (timed only; the port never calls them):
    F.scaled_dot_product_attention's forward on the same head-major
    tensors viewed as (BH, 1, S, D), and one autograd call of its
    backward (dq, dk and dv together)."""
    qh, kh, vh = (t[:, None].detach().requires_grad_() for t in (q, k, v))
    doh = do[:, None]

    def fwd():
        return F.scaled_dot_product_attention(qh, kh, vh, is_causal=causal,
                                              scale=scale)

    out = fwd()
    return fwd, lambda: torch.autograd.grad(out, (qh, kh, vh), doh,
                                            retain_graph=True)


def k1_vs_k4_d64() -> dict:
    """The cost of the reference's head-major route at D 64 on K4's main
    shape (B 8, S 1024, H 25, bf16, causal): K1/K2 launched directly on
    the projection layout (their D 64 instantiation, which the lowering
    does not reach: the tensor-core bodies K4 runs, under the FlatLayout
    tag) beside the whole routes, forward and forward + backward:
    flash_attention (transposes to and from (B*H, S, D) around K4) and
    FlashAttentionFunction (K1/K2)."""
    scale = 1.0 / KD ** 0.5
    g = torch.Generator(device=DEVICE).manual_seed(11)
    q, k, v, do = (torch.randn(KB, KS, KH, KD, generator=g, device=DEVICE)
                   .bfloat16() for _ in range(4))
    out = torch.empty_like(q)
    lse = torch.empty(KB, KH, KS, device=DEVICE)
    launch_flash_attention_fwd(q, k, v, out, lse, True, scale)
    delta = flash_delta(do, out)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    res = {
        "shape": [KB, KS, KH, KD], "dtype": "bfloat16",
        "k1_fwd_ms": time_ms(lambda: launch_flash_attention_fwd(
            q, k, v, out, lse, True, scale)),
        "k2_dq_ms": time_ms(lambda: launch_flash_attention_dq(
            q, k, v, do, lse, delta, dq, True, scale)),
        "k2_dkv_ms": time_ms(lambda: launch_flash_attention_dkv(
            q, k, v, do, lse, delta, dk, dv, True, scale)),
    }
    routes = {
        "k4_route": lambda *t: flash_attention(*t, causal=True, scale=scale),
        "k1_route": lambda *t: FlashAttentionFunction.apply(*t, True, scale),
    }
    for name, route in routes.items():
        with torch.no_grad():
            res[f"{name}_fwd_ms"] = time_ms(lambda: route(q, k, v))
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        res[f"{name}_fwd_bwd_ms"] = time_ms(lambda: torch.autograd.grad(
            route(*leaves), leaves, do))
    return res


def planted_fault_check(BH, S, D, dtype, seed, rows=128, keys=128,
                        device=None) -> dict:
    """The power of the flash checks: the plain versions' results on
    seeded (BH, S, D) inputs, causal, with one key tile (the first `keys`
    keys) left out of the last `rows` query rows, as from a kernel whose
    K/V ring skipped that tile there: the forward's out and lse, and dq.
    Returns each criterion's verdicts on each faulted result and whether
    `_err_ok` rejects the forward and dq (it must)."""
    device = device or DEVICE
    scale = 1.0 / D ** 0.5
    g = torch.Generator(device=device).manual_seed(seed)
    q, k, v, do = (torch.randn(BH, S, D, generator=g, device=device)
                   .to(dtype) for _ in range(4))
    out, lse = flash_bh_reference(q, k, v, True, scale)
    delta = flash_bh_delta(do, out)
    dq = flash_bh_dq_reference(q, k, v, do, lse, delta, True, scale)
    late, tile = slice(S - rows, S), slice(0, keys)
    # the tile's part of the late rows, where all of its keys are visible
    sub = (q[:, late], k[:, tile], v[:, tile])
    out_t, lse_t = flash_bh_reference(*sub, False, scale)
    share = torch.exp(lse_t - lse[:, late])  # of each late row's mass
    bad_lse, bad_out, bad_dq = (t.float().clone() for t in (lse, out, dq))
    bad_lse[:, late] += torch.log1p(-share)
    bad_out[:, late] = ((bad_out[:, late] - share[..., None] * out_t.float())
                        / (1 - share[..., None]))
    bad_dq[:, late] -= flash_bh_dq_reference(
        *sub, do[:, late], lse[:, late], delta[:, late], False, scale).float()
    bad_out, bad_dq = bad_out.to(dtype), bad_dq.to(dtype)
    fwd_tol, grad_tol = FLASH_TOLS[dtype]
    return {
        "shape": [BH, S, D], "dtype": str(dtype).replace("torch.", ""),
        "rows": rows, "keys": keys,
        "out": _err_parts(bad_out, out, fwd_tol),
        "lse": _err_parts(bad_lse, lse, fwd_tol, lse=True),
        "dq": _err_parts(bad_dq, dq, grad_tol),
        "rejected": {
            "fwd": not _err_ok([(bad_out, out)], fwd_tol, (bad_lse, lse))[1],
            "dq": not _err_ok([(bad_dq, dq)], grad_tol)[1]}}


def phase_k4_kernels(card: str) -> dict:
    """K4 at GPT-2 XL's shape (bf16 and fp32, timed) and at phase 11's
    (bench.py's 200m Llama: B*H 8*16, S = T 1024, D 64, causal; bf16,
    timed: the kernels line's case), then at every case of K4_CASES in
    both dtypes (errors and times: the padded widths' CUDA-core bodies,
    the ring block's bf16 ones, the fp32 3xTF32 ones at 64..256), then
    the planted fault (the checks must reject a skipped key tile at
    GPT-2 XL's shape, bf16 and fp32), then the K1-vs-K4 record. Fails
    on any error over its tolerance. Returns {"main": {dtype name:
    {kernel: result}}, "timed": {case: {kernel: result}}, "cases":
    [...], "planted_fault": {dtype name: {...}}, "k1_vs_k4_d64":
    {...}}."""
    main, timed, cases = {}, {}, []
    for seed, dtype in enumerate((torch.bfloat16, torch.float32)):
        res = k4_check(KB * KH, KS, KS, KD, True, dtype, seed, timed=True)
        for r in res.values():
            r.update(case="gpt2_xl_causal", card=card)
            log(f"kernel {json.dumps(r)}")
        main[str(dtype).replace("torch.", "")] = res
        torch.cuda.empty_cache()
    cfg = llama_200m()
    res = k4_check(TRAIN_BATCH * cfg.heads, TRAIN_SEQ, TRAIN_SEQ,
                   cfg.dim // cfg.heads, True, torch.bfloat16, 2,
                   timed=True)
    for r in res.values():
        r.update(case="llama_200m_causal", card=card)
        log(f"kernel {json.dumps(r)}")
    timed["llama_200m_causal"] = res
    for i, (name, BH, S, T, D, causal) in enumerate(K4_CASES):
        for dtype in (torch.bfloat16, torch.float32):
            res = k4_check(BH, S, T, D, causal, dtype, 100 + i, timed=True)
            for r in res.values():
                r.update(case=name, card=card)
                log(f"kernel {json.dumps(r)}")
                cases.append(r)
            timed[f"{name}_{str(dtype).replace('torch.', '')}"] = res
        torch.cuda.empty_cache()
    bad = [r for d in main.values() for r in d.values() if not r["ok"]]
    bad += [r for d in timed.values() for r in d.values() if not r["ok"]]
    if bad:
        raise AssertionError(f"K4 kernels disagree with their plain "
                             f"versions: {bad}")
    # bf16 for the wgmma bodies, fp32 for the 3xTF32 ones
    fault = {}
    for dtype in (torch.bfloat16, torch.float32):
        f = planted_fault_check(KB * KH, KS, KD, dtype, 12)
        log(f"planted_fault {json.dumps(f)}")
        if not all(f["rejected"].values()):
            raise AssertionError(f"the flash checks pass a skipped key "
                                 f"tile: {f}")
        fault[f["dtype"]] = f
        torch.cuda.empty_cache()
    cmp = k1_vs_k4_d64()
    cmp["card"] = card
    log(f"k1_vs_k4_d64 {json.dumps(cmp)}")
    torch.cuda.empty_cache()
    return {"main": main, "timed": timed, "cases": cases,
            "planted_fault": fault, "k1_vs_k4_d64": cmp}


# ---------------------------------------------------------------------------
# phase 2: the ring step kernel K5 against its plain version


def k5_bound(q, k, causal: bool) -> tuple:
    """(bound_ms, bound_by, bytes, ops) of one K5 call: q, k and v read
    once, the fp32 m, l and acc read once and written once, against 4 * D
    operations per visible (query, key) pair at the operand type's
    peak."""
    BH, S, Dh = q.shape
    T = k.shape[1]
    rows = np.arange(S)
    pairs = BH * int((np.minimum(rows + 1, T) if causal
                      else np.full(S, T)).sum())
    nbytes = (q.numel() + 2 * k.numel()) * q.element_size() \
        + 2 * (2 * BH * S + q.numel()) * 4
    ops = 4 * Dh * pairs
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[q.dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, ops)


def k5_check(BH, S, T, D, causal, dtype, seed, timed=False) -> dict:
    """K5 on seeded (BH, S, D) q and (BH, T, D) k, v against its plain
    version, from the initial statistics and from a carried-in state (the
    plain fold of another block). With `timed`, the kernel's, the plain
    version's and SDPA's forward times (a yardstick: no PyTorch call
    takes a carried state) on the carried case, and the bound."""
    scale = 1.0 / D ** 0.5
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    q = torch.randn(BH, S, D, generator=g, device=DEVICE).to(dtype)
    k, v, k0, v0 = (torch.randn(BH, T, D, generator=g, device=DEVICE)
                    .to(dtype) for _ in range(4))
    fresh = (torch.full((BH, S), -1e30, device=DEVICE),
             torch.zeros(BH, S, device=DEVICE),
             torch.zeros(BH, S, D, device=DEVICE))
    carried = flash_bh_fwd_carry_reference(q, k0, v0, *fresh, False, scale)
    tol = FLASH_TOLS[dtype][0]
    errs = []
    for stats in (fresh, carried):
        want = flash_bh_fwd_carry_reference(q, k, v, *stats, causal, scale)
        bufs = [t.clone() for t in stats]
        launch_flash_attention_bh_fwd_carry(q, k, v, *bufs, causal, scale)
        torch.cuda.synchronize()
        errs.append(_err_ok(list(zip(bufs, want)), tol))
        del want, bufs
    res = {"kernel": FLASH_ATTENTION_BH_FWD_CARRY.name,
           "dtype": str(dtype).replace("torch.", ""),
           "shape": [BH, S, T, D], "causal": causal,
           "max_abs_err": max(e[0] for e in errs),
           "rel_norm_err": max(e[2] for e in errs), "tol": tol,
           "ok": all(e[1] for e in errs)}
    if timed:
        bufs = [t.clone() for t in carried]
        qh, kh, vh = q[:, None], k[:, None], v[:, None]
        bound_ms, bound_by, nbytes, ops = k5_bound(q, k, causal)
        res.update({
            "ms": time_ms(lambda: launch_flash_attention_bh_fwd_carry(
                q, k, v, *bufs, causal, scale)),
            "plain_ms": time_ms(lambda: flash_bh_fwd_carry_reference(
                q, k, v, *carried, causal, scale)),
            "library_ms": None,
            "library": "none (no PyTorch call takes a carried state)",
            "sdpa_fwd_yardstick_ms": time_ms(
                lambda: F.scaled_dot_product_attention(
                    qh, kh, vh, is_causal=causal, scale=scale)),
            "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
            "ops": ops})
    return res


def phase_k5_kernels(card: str) -> dict:
    """K5 at phase 10's block shape (bf16 and fp32, full and causal,
    timed), then at every case of K5_CASES in both dtypes (errors only).
    Fails on any error over its tolerance. Returns {"main": {"<dtype>_
    <full|causal>": result}, "cases": [...]}."""
    main, cases = {}, []
    for seed, dtype in enumerate((torch.bfloat16, torch.float32)):
        for causal in (False, True):
            r = k5_check(K5_BH, K5_S, K5_S, K5_D, causal, dtype, seed,
                         timed=True)
            mode = "causal" if causal else "full"
            r.update(case=f"bench_1b_ring_step_{mode}", card=card)
            log(f"kernel {json.dumps(r)}")
            main[f"{r['dtype']}_{mode}"] = r
        torch.cuda.empty_cache()
    for i, (name, BH, S, T, D, causal) in enumerate(K5_CASES):
        for dtype in (torch.bfloat16, torch.float32):
            r = k5_check(BH, S, T, D, causal, dtype, 200 + i)
            r["case"] = name
            log(f"kernel {json.dumps(r)}")
            cases.append(r)
    bad = [r for r in list(main.values()) + cases if not r["ok"]]
    if bad:
        raise AssertionError(f"K5 disagrees with its plain version: {bad}")
    return {"main": main, "cases": cases}


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


def _ragged_steps(make, vocab, kv_dtypes):
    """Run _step_inputs' two packed ragged steps on a model built by
    make(device, params) on the card and, from the card's seeded weights
    copied over, on the CPU, for each pool dtype (None: the model's).
    Returns ({kv dtype: (probs, pools)} of the card, the same of the
    CPU)."""

    def run(ff, kv_dtype):
        ex = ff.executor
        caches = ex.init_paged_kv_cache(16, P, dtype=kv_dtype)
        tr, ntr = ff._params
        out = []
        for tables, pos, qls, deps, anc, ids in _step_inputs(ex.device,
                                                             vocab):
            p, caches = ex.ragged_step_fn(tr, ntr, caches, tables, pos,
                                          qls, deps, anc, ids)
            out.append(p.float().cpu())
        return torch.stack(out), {k: {n: t.cpu() for n, t in b.items()}
                                  for k, b in caches.items()}

    card_ff = make(DEVICE)
    gpu = {dt: run(card_ff, dt) for dt in kv_dtypes}
    # the card's seeded weights, copied to the CPU
    cpu_ff = make("cpu", params=card_ff._params)
    del card_ff
    torch.cuda.empty_cache()
    cpu = {dt: run(cpu_ff, dt) for dt in kv_dtypes}
    return gpu, cpu


def _fp_step_check(label, g, c) -> dict:
    """The fp pool's probabilities, card against CPU, to STEP_RTOL/ATOL;
    raises on a difference."""
    ok = torch.allclose(g, c, rtol=STEP_RTOL, atol=STEP_ATOL)
    res = {"model": label, "shape": list(g.shape),
           "max_abs_err": float((g - c).abs().max()),
           # relative error where a probability is above 1e-6
           "max_rel_err": float(((g - c).abs() / c.abs())[
               c > 1e-6].max()),
           "rtol": STEP_RTOL, "atol": STEP_ATOL,
           "finite": bool(torch.isfinite(g).all())}
    log(f"step {json.dumps(res)}")
    if not ok or not res["finite"]:
        raise AssertionError(f"card step disagrees with CPU step: {res}")
    return res


def phase_step(seed: int) -> dict:
    """Two packed ragged steps at Llama-3-8B widths, depth 2, fp32 with
    TF32 off, card against CPU on the same seeded weights: on an fp pool
    (probabilities to STEP_RTOL/ATOL) and on an int8 pool (probabilities
    to 1e-4; int8 bytes equal but for +-1 at a fraction <= 1e-4 of the
    pools' elements; scales to 1e-5 relative)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = LlamaConfig.llama3_8b()
    cfg.layers = 2

    def make(device, params=None):
        ff = FFModel(FFConfig(batch_size=1, seed=seed, device=device))
        build_llama(ff, cfg, batch_size=1, seq_len=8, dtype=DataType.FLOAT)
        return ff.compile(params=params)

    gpu, cpu = _ragged_steps(make, cfg.vocab_size, (None, torch.int8))
    res = _fp_step_check("llama3_8b_depth2", gpu[None][0], cpu[None][0])

    (g8, gp), (c8, cp) = gpu[torch.int8], cpu[torch.int8]
    byte_diff = [(gp[k][n].int() - cp[k][n].int()).abs()
                 for k in gp for n in ("k", "v")]
    scale_rel = max(float(((gp[k][n] - cp[k][n]).abs()
                           / cp[k][n].abs().clamp_min(1e-30))[
                               cp[k][n] > 0].max())
                    for k in gp for n in ("k_scale", "v_scale"))
    n_bytes = sum(d.numel() for d in byte_diff)
    n_off = sum(int((d > 0).sum()) for d in byte_diff)
    res8 = {"shape": list(g8.shape),
            "max_abs_err": float((g8 - c8).abs().max()),
            "prob_atol": INT8_STEP_PROB_ATOL,
            "pool_bytes": n_bytes,
            "written_bytes": sum(int((cp[k][n] != 0).sum())
                                 for k in cp for n in ("k", "v")),
            "bytes_off": n_off,
            "max_byte_diff": max(int(d.max()) for d in byte_diff),
            "byte_fraction_allowed": INT8_STEP_BYTE_FRACTION,
            "max_scale_rel_err": scale_rel,
            "scale_rtol": INT8_STEP_SCALE_RTOL,
            "finite": bool(torch.isfinite(g8).all())}
    log(f"step_int8 {json.dumps(res8)}")
    if not (res8["finite"] and res8["max_abs_err"] <= INT8_STEP_PROB_ATOL
            and res8["max_byte_diff"] <= 1
            and n_off <= INT8_STEP_BYTE_FRACTION * n_bytes
            and scale_rel <= INT8_STEP_SCALE_RTOL):
        raise AssertionError(f"card int8 step disagrees with CPU: {res8}")
    res["int8"] = res8
    return res


def phase_gpt2_step(seed: int) -> dict:
    """The same two packed ragged steps at GPT-2 XL widths, depth 2, fp32
    with TF32 off, over an fp pool, card against CPU: learned positions
    at the ragged rows, LayerNorm, biased attention through the ragged
    kernel."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(gpt2_xl(), layers=2)

    def make(device, params=None):
        ff = FFModel(FFConfig(batch_size=1, seed=seed, device=device))
        build_gpt2(ff, cfg, batch_size=1, seq_len=GPT2_POSITIONS,
                   dtype=DataType.FLOAT)
        return ff.compile(params=params)

    gpu, cpu = _ragged_steps(make, cfg.vocab_size, (None,))
    return _fp_step_check("gpt2_xl_depth2", gpu[None][0], cpu[None][0])


def _train_model(cfg, device, *, batch, seq, dtype, remat, seed,
                 params=None, mesh_shape=None) -> FFModel:
    """build_llama or build_gpt2 (by the config's type) -> compile(Adam
    lr 1e-4, sparse CE, accuracy and sparse-CE metrics), the training
    path's entry points. With a `mesh_shape` the Llama is built with ring
    attention over its `seq` axis."""
    ff = FFModel(FFConfig(batch_size=batch, seed=seed, device=device,
                          remat=remat, mesh_shape=mesh_shape))
    if isinstance(cfg, GPT2Config):
        build_gpt2(ff, cfg, batch_size=batch, seq_len=seq, dtype=dtype)
    else:
        build_llama(ff, cfg, batch_size=batch, seq_len=seq, dtype=dtype,
                    use_ring_attention=mesh_shape is not None)
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


def ring_folds(n: int) -> int:
    """Blocks a causal ring of n shards folds per attention call: the
    diagonal and every block before it, n (n + 1) / 2 (10 at n 4)."""
    return n * (n + 1) // 2


def phase_train_step(seed: int, cfg=None, label="bench_1b", seq=256,
                     mesh_shape=None) -> dict:
    """One Adam train step at `cfg`'s widths (bench_1b by default), depth
    2, fp32 (TF32 off), batch 1, seq 256 (or `seq`): the card against the
    CPU from the same seeded weights, the loss and every parameter after
    the step. With a `mesh_shape` the model is the ring-built Llama, and
    the card's step must fold every visible block through K5."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(cfg or LlamaConfig.bench_1b(), layers=2)
    kw = dict(batch=1, seq=seq, dtype=DataType.FLOAT, remat="none",
              seed=seed, mesh_shape=mesh_shape)
    card_ff = _train_model(cfg, DEVICE, **kw)
    # the card's seeded weights, copied to the CPU before the step
    cpu_ff = _train_model(cfg, "cpu", **kw, params=tuple(
        {k: {n: t.cpu() for n, t in w.items()} for k, w in tree.items()}
        for tree in card_ff._params))
    x, y = _token_batches(1, seq, cfg.vocab_size, seed + 1)
    out = []
    for ff in (card_ff, cpu_ff):
        ex = ff.executor
        tr, ntr = ff._params
        bx, by = (torch.from_numpy(a).to(ex.device) for a in (x, y))
        _reset_launches()
        tr, ntr, _, m = ex.train_step(tr, ntr, ff._opt_state, by, bx)
        out.append((float(m["loss"]), {f"{k}/{n}": t.cpu() for k, w in
                                       tr.items() for n, t in w.items()}))
        if ff is card_ff:
            k5 = FLASH_ATTENTION_BH_FWD_CARRY.launches
            flat = _flash_launches()
    (gl, gp), (cl, cp) = out
    diffs = {n: (gp[n] - cp[n]).abs() for n in gp}
    worst = max(diffs, key=lambda n: float(diffs[n].max()))
    outside = sum(int((d > TRAIN_PARAM_TOL * (1 + cp[n].abs())).sum())
                  for n, d in diffs.items())
    total = sum(d.numel() for d in diffs.values())
    res = {"model": label, "layers": 2, "seq": seq,
           "mesh_shape": mesh_shape, "k5_launches": k5,
           "flash_launches": flat, "loss_card": gl,
           "loss_cpu": cl, "loss_rel_err": abs(gl - cl) / abs(cl),
           "max_param_abs_err": float(diffs[worst].max()),
           "worst_param": worst, "weights": total,
           "weights_outside_tol": outside, "lr": TRAIN_LR,
           "loss_rtol": TRAIN_LOSS_RTOL, "param_tol": TRAIN_PARAM_TOL,
           "outlier_fraction_allowed": TRAIN_OUTLIER_FRACTION}
    log(f"train_step {json.dumps(res)}")
    del card_ff, cpu_ff
    torch.cuda.empty_cache()
    n = (mesh_shape or {}).get("seq", 1)
    want_k5 = 2 * ring_folds(n) if n > 1 else 0
    # the plain route at a head dim of 128 (bench_1b) runs K1 and K2
    # (fp32: K2 on its 3xTF32 body) once a layer
    flat_route = n == 1 and cfg.dim // cfg.heads % 128 == 0
    want_flat = {k: 2 if flat_route else 0 for k in flat}
    ok = (np.isfinite(gl) and res["loss_rel_err"] <= TRAIN_LOSS_RTOL
          and res["max_param_abs_err"] <= 2 * TRAIN_LR
          and outside <= TRAIN_OUTLIER_FRACTION * total and k5 == want_k5
          and flat == want_flat)
    if not ok:
        raise AssertionError(f"card train step disagrees with CPU: {res}")
    return res


def phase_ring_untiled(seed: int) -> dict:
    """The ring at a local length that is not a multiple of 128 (no
    length gate: the same K5 ring as any other length; the reference
    takes its einsum ring there): ring_dot_product_attention over a
    {"seq": 4} mesh at bench_1b's attention widths (B 1, H 16, Hkv 8, D
    128) and S 768, so s_loc is 192. Its output and the gradients of q,
    k and v on the card against the same call on the CPU (the plain
    versions), bf16 and fp32 (TF32 off), causal and full, within
    FLASH_TOLS; on the card K5 and K4's dq and dk/dv kernels launch once
    per folded block (10 causal, 16 full), no other attention kernel."""
    torch.backends.cuda.matmul.allow_tf32 = False
    S, H, Hkv, D = 768, 16, 8, 128
    scale = D ** -0.5
    ring_kernels = (FLASH_ATTENTION_BH_FWD_CARRY, FLASH_ATTENTION_BH_DQ,
                    FLASH_ATTENTION_BH_DKV)
    res = []
    for i, (dtype, causal) in enumerate(
            (d, c) for d in (torch.bfloat16, torch.float32)
            for c in (True, False)):
        g = torch.Generator().manual_seed(seed + i)
        q, w = (torch.randn(1, S, H, D, generator=g).to(dtype)
                for _ in range(2))
        k, v = (torch.randn(1, S, Hkv, D, generator=g).to(dtype)
                for _ in range(2))
        got = []
        for device in (DEVICE, "cpu"):
            leaves = [t.to(device).requires_grad_() for t in (q, k, v)]
            _reset_launches()
            out = ring_dot_product_attention(
                *leaves, mesh=make_mesh({"seq": RING_SHARDS}),
                causal=causal, scale=scale)
            (out.float() * w.to(device).float()).sum().backward()
            if device == DEVICE:
                launched = {kk.name: kk.launches for kk in KERNELS}
            got.append([t.detach().cpu() for t in
                        [out] + [x.grad for x in leaves]])
        folded = ring_folds(RING_SHARDS) if causal else RING_SHARDS ** 2
        want = {kk.name: folded if kk in ring_kernels else 0
                for kk in KERNELS}
        fwd_tol, grad_tol = FLASH_TOLS[dtype]
        err_fwd, ok_fwd, rel_fwd = _err_ok([(got[0][0], got[1][0])],
                                           fwd_tol)
        err_grad, ok_grad, rel_grad = _err_ok(
            list(zip(got[0][1:], got[1][1:])), grad_tol)
        r = {"dtype": str(dtype).replace("torch.", ""), "causal": causal,
             "shape": [1, S, H, Hkv, D], "shards": RING_SHARDS,
             "s_loc": S // RING_SHARDS, "out_max_abs_err": err_fwd,
             "grad_max_abs_err": err_grad,
             "rel_norm_err": [rel_fwd, rel_grad], "tol": [fwd_tol, grad_tol],
             "launches": launched,
             "ok": ok_fwd and ok_grad and launched == want}
        log(f"ring_untiled {json.dumps(r)}")
        res.append(r)
    bad = [r for r in res if not r["ok"]]
    if bad:
        raise AssertionError(f"the ring at s_loc {S // RING_SHARDS} on the "
                             f"card disagrees with the CPU: {bad}")
    return {"cases": res}


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
# phase 7: the whole paged server — int8 pool, prefix cache, preemption,
# defrag — serving Llama-3-8B

# serve_generation's settings for phase 7 and its traffic
SERVE7 = dict(slots=4, max_len=2048, page_size=64, prefill_chunk=64,
              kv_dtype="int8")
SYS_LEN, SUFFIX_MIN, SUFFIX_MAX, SERVE7_REQUESTS, SERVE7_NEW = (
    512, 64, 512, 8, 192)


def serve7_num_pages(prompts) -> int:
    """The pool for phase 7, null page included: the fewest pages that
    admit the first four requests together. Admission asks for each
    prompt's pages plus the first decode row's as free pages, counting
    the shared system-prompt pages again each time though only the first
    request takes them, so after the four are in, exactly that reserve of
    SYS_LEN / page_size = 8 pages (plus at most one) is left. Each of the
    four then grows by SERVE7_NEW / page_size = 3 pages, 12 in all, before
    any finishes, so growth preempts. (At 64 new tokens they would grow
    by 4 pages in all, which the 8 always cover: no preemption.) The
    count is host arithmetic, the same at any width;
    tests/test_torch_paged_server.py runs this traffic on the CPU with a
    narrow model and holds it to at least one preemption."""
    P = SERVE7["page_size"]
    shared = SYS_LEN // P
    held, capacity = 0, 0
    for i, p in enumerate(prompts[:SERVE7["slots"]]):
        capacity = max(capacity, held + -(-(len(p) + 1) // P))
        held += -(-len(p) // P) - (shared if i else 0)
    return capacity + 1


def int8_traffic(vocab: int, seed: int):
    """A seeded SYS_LEN-token system prompt, and SERVE7_REQUESTS prompts:
    that prompt + a unique seeded suffix of SUFFIX_MIN..SUFFIX_MAX
    tokens."""
    rs = np.random.RandomState(seed + 7)
    # lengths first: how many draws randint takes depends on its range, so
    # drawn after the tokens they would change with the vocabulary
    lens = rs.randint(SUFFIX_MIN, SUFFIX_MAX + 1, size=SERVE7_REQUESTS)
    sys_prompt = rs.randint(0, vocab, (SYS_LEN,)).astype(np.int32)
    return sys_prompt, [np.concatenate(
        [sys_prompt, rs.randint(0, vocab, (n,)).astype(np.int32)])
        for n in lens]


def serve_int8_traffic(ff, vocab: int, seed: int,
                       sync=lambda: None) -> dict:
    """Phase 7's traffic through serve_generation(paged=True,
    kv_dtype="int8", prefix cache and preemption at their defaults): the
    system prompt alone first, off the clock (its 8 full pages publish to
    the prefix cache), then the requests at once, with one
    request_defrag() once the first has finished (the others are live or
    queued). Kernel counts are reset just before the requests and read
    just after. The pool's invariants are checked after the drain."""
    sys_prompt, prompts = int8_traffic(vocab, seed)
    num_pages = serve7_num_pages(prompts)
    server = ff.serve_generation(paged=True, num_pages=num_pages, seed=seed,
                                 **SERVE7)
    try:
        server.generate(sys_prompt, max_new_tokens=1, timeout=900)
        sync()
        steps0, served0 = server.ragged_steps, server.requests_served
        _reset_launches()
        t1 = time.monotonic()
        futs = [server.submit(p, max_new_tokens=SERVE7_NEW)
                for p in prompts]
        futs[0].result(timeout=900)
        server.request_defrag()
        outs = [f.result(timeout=900) for f in futs]
        sync()
        wall = time.monotonic() - t1
        launches = {k.name: k.launches for k in KERNELS}
        steps = server.ragged_steps - steps0
        m = server.metrics()
    finally:
        server.stop()
    server.pool.check_invariants(owners={})
    return {"server": server, "outs": outs, "wall": wall,
            "launches": launches, "steps": steps, "metrics": m,
            "records": m["requests"][served0:], "num_pages": num_pages,
            "prompt_lens": [len(p) for p in prompts]}
def phase_serve_int8(seed: int, card: str) -> dict:
    """Phase 7 on the card: Llama-3-8B, 32 layers, bf16, random weights
    from the seed, through serve_int8_traffic. Fails unless every output
    has SERVE7_NEW valid tokens, the int8 kernel launched once per layer
    and ragged step and the fp kernel never, the four requests admitted
    first each mapped the 8 shared pages (hit tokens >= 4 x 512), growth
    preempted at least once and a defrag ran."""
    cfg = LlamaConfig.llama3_8b()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    ff = FFModel(FFConfig(batch_size=1, seed=seed, device=DEVICE))
    build_llama(ff, cfg, batch_size=1, seq_len=SERVE7["max_len"],
                dtype=DataType.BFLOAT16)
    ff.compile()
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    r = serve_int8_traffic(ff, cfg.vocab_size, seed,
                           sync=torch.cuda.synchronize)
    log(f"serve_int8 num_pages {r['num_pages']}")
    m, recs, launches, steps = (r["metrics"], r["records"], r["launches"],
                                r["steps"])
    bufs = [b for node in r["server"]._caches.values() for b in node.values()]
    pool_bytes = sum(b.numel() * b.element_size() for b in bufs)
    kv = [b for node in r["server"]._caches.values()
          for n, b in node.items() if n in ("k", "v")]
    bf16_bytes = sum(b.numel() * 2 for b in kv)
    n_attn = len(kv) // 2
    ttft = sorted(x["ttft_s"] for x in recs)
    decode_rates = [(x["decode_tokens"] - 1) / x["decode_s"] for x in recs]
    pc = m["prefix_cache"]
    res = {
        "model": "llama3_8b", "layers": cfg.layers, "dtype": "bfloat16",
        "kv_dtype": m["kv_cache_dtype"], "num_pages": r["num_pages"],
        **{k: SERVE7[k] for k in ("slots", "max_len", "page_size",
                                  "prefill_chunk")},
        "requests": len(r["outs"]), "prompt_lens": r["prompt_lens"],
        "new_tokens": SERVE7_NEW, "ragged_steps": steps,
        "launches": launches, "wall_s": r["wall"],
        "generated_tokens_per_s": SERVE7_NEW * len(r["outs"]) / r["wall"],
        "decode_tokens_per_s_per_request_mean": float(
            np.mean(decode_rates)),
        "ttft_p50_s": ttft[len(ttft) // 2], "ttft_max_s": ttft[-1],
        "init_s": init_s, "preemptions": m["preemptions"],
        "defrags": m["defrags"], "hit_tokens": pc["hit_tokens"],
        "miss_tokens": pc["miss_tokens"], "evictions": pc["evictions"],
        "cached_prefill_tokens": [x["cached_prefill_tokens"] for x in recs],
        "request_preemptions": [x["preemptions"] for x in recs],
        "pool_bytes": pool_bytes, "bf16_pool_bytes_same_pages": bf16_bytes,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "card": card,
    }
    log(f"serve_int8 {json.dumps(res)}")
    outs = r["outs"]
    del r, ff, bufs, kv
    torch.cuda.empty_cache()
    for o in outs:
        if len(o) != SERVE7_NEW or not ((0 <= o) & (o < cfg.vocab_size)).all():
            raise AssertionError(f"bad output {o}")
    if (steps == 0
            or launches[RAGGED_PAGED_ATTENTION_INT8.name] != n_attn * steps
            or launches[RAGGED_PAGED_ATTENTION.name] != 0):
        raise AssertionError(f"launches {launches} != {n_attn} x {steps} "
                             "int8, 0 fp")
    if pc["hit_tokens"] < 4 * SYS_LEN or m["preemptions"] < 1 \
            or m["defrags"] < 1:
        raise AssertionError(f"hit tokens {pc['hit_tokens']} (want >= "
                             f"{4 * SYS_LEN}), preemptions "
                             f"{m['preemptions']}, defrags {m['defrags']}")
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
    """Device-busy ms per step, idle share, device launches, the kernels
    by time and the port's own kernels (csrc/: flash_*, ragged_*) by time
    from a torch.profiler run of n steps. Device-side events only
    (kernels, memcpy/memset): the CPU-side aten ops also carry their
    children's device time."""
    evs = _device_events(prof)
    dev_ms = sum(e.self_device_time_total for e in evs) / n / 1e3
    by_time = sorted(evs, key=lambda e: -e.self_device_time_total)

    def row(e):
        return (_short(e.key)[:60], e.self_device_time_total / n / 1e3,
                e.count // n)

    return {
        "wall_ms": wall_ms,
        "device_ms": dev_ms if evs else "not measured",
        "idle_share": (1 - dev_ms / wall_ms) if evs else "not measured",
        "device_launches": sum(e.count for e in evs) // n,
        "top": [row(e) for e in by_time[:10]],
        "own": [row(e) for e in by_time if _own_kernel(e.key)],
    }


# record_function spans chip_smoke opens: the trace also draws each on the
# device's timeline (from its first kernel to its last), which is no work
# of the device's own
_SPANS = ("quantized_append",)


def _device_events(prof) -> list:
    """The profile's device-side events with device time (kernels,
    memcpy/memset), summed by name."""
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0 and e.key not in _SPANS]


# the namespaces of the port's kernels: each source's own anonymous one
# (K4's 3xTF32 body in its tf32 namespace there), and ffwg for the
# tensor-core bodies the flash sources share
_OWN_NAMESPACES = ("void (anonymous namespace)::tf32::",
                   "void (anonymous namespace)::", "void ffwg::")


def _short(key: str) -> str:
    for ns in _OWN_NAMESPACES + ("ffwg::",):
        key = key.replace(ns, "")
    return key


def _span_device(prof, name: str, n: int) -> tuple:
    """(device launches, device ms) per step of the kernels launched under
    the profiler spans called `name` (record_function), or "not measured"
    where the trace links no kernel to them."""
    launches, us = 0, 0.0

    def walk(ev):
        nonlocal launches, us
        for k in ev.kernels:
            launches += 1
            us += k.duration
        for c in ev.cpu_children:
            walk(c)

    for ev in prof.events():
        if ev.name == name:
            walk(ev)
    if not launches:
        return "not measured", "not measured"
    return launches / n, us / n / 1e3


def _own_kernel(key: str) -> bool:
    """Whether a profiled kernel is one of csrc/'s (flash_*, ragged_*)."""
    return key.startswith(tuple(ns + p for ns in _OWN_NAMESPACES
                                for p in ("flash_", "ragged_")))


def phase_profile(seed: int, card: str) -> dict:
    """Llama-3-8B bf16 ragged steps at the serving shapes, timed by the
    host clock around synchronised steps and traced with torch.profiler:
    device-busy time per step, idle share and the kernels by time; on
    an fp pool a decode and a prefill step, on an int8 pool (phase 7's)
    a decode step with the int8 ragged kernels' launches and ms and
    quantize-on-append's (its calls traced as record_function spans)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    import flexflow_tpu_torch.paged.attention as paged_attention

    cfg = LlamaConfig.llama3_8b()
    ff = FFModel(FFConfig(batch_size=1, seed=seed, device=DEVICE))
    build_llama(ff, cfg, batch_size=1, seq_len=2048,
                dtype=DataType.BFLOAT16)
    ff.compile()
    ex = ff.executor
    tr, ntr = ff._params
    pools = {None: ex.init_paged_kv_cache(NUM_PAGES, P),
             "int8": ex.init_paged_kv_cache(NUM_PAGES, P, torch.int8)}
    append = paged_attention.quantized_append

    def traced_append(*a, **kw):
        with record_function(_SPANS[0]):
            return append(*a, **kw)

    rs = np.random.RandomState(seed)
    out = {"card": card}
    for name, make, kv in (("decode_b4_pos1024", _decode_launch, None),
                           ("prefill_8x8_pos512", _prefill_launch, None),
                           ("decode_b4_pos1024_int8", _decode_launch,
                            "int8")):
        launch = make(DEVICE, cfg.vocab_size, rs)
        caches = pools[kv]

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
        paged_attention.quantized_append = traced_append
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(n):
                    step()
                torch.cuda.synchronize()
        finally:
            paged_attention.quantized_append = append
        res = _profile_summary(prof, n, wall_ms)
        if kv == "int8":
            rag = [r for r in res["own"] if r[0].startswith("ragged_")]
            res["int8_ragged_ms"] = sum(r[1] for r in rag)
            res["int8_ragged_launches"] = sum(r[2] for r in rag)
            res["quantized_append_launches"], res["quantized_append_ms"] = \
                _span_device(prof, _SPANS[0], n)
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


def phase_profile_train(seed: int, card: str, cfg=None,
                        label: str = "bench_1b", batch: int = TRAIN_BATCH,
                        seq: int = TRAIN_SEQ, mesh_shape=None) -> dict:
    """One train step of `cfg` (bench_1b by default; bf16, batch 8, seq
    1024, remat none; or `batch`, `seq` and a ring over `mesh_shape`),
    timed by the host clock around synchronised steps and traced with
    torch.profiler: device-busy time, idle share, kernels by time."""
    from torch.profiler import ProfilerActivity, profile

    cfg = cfg or LlamaConfig.bench_1b()
    ff = _train_model(cfg, DEVICE, batch=batch, seq=seq,
                      dtype=DataType.BFLOAT16, remat="none", seed=seed,
                      mesh_shape=mesh_shape)
    ex = ff.executor
    state = list(ff._params) + [ff._opt_state]
    x, y = _token_batches(batch, seq, cfg.vocab_size, seed)
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
    log(f"profile train_step_{label} {json.dumps(res)}")
    del ff, ex, state
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phases 8 and 9: GPT-2 XL, trained and served


def gpt2_flops_per_token(cfg, seq: int) -> float:
    """Matmul FLOPs per trained token, forward and backward, as
    llama_flops_per_token counts them: 6 x the matmul weights (q, k, v, o,
    fc, proj per layer; lm_head) + causal attention at half density."""
    per_layer = 4 * cfg.dim * cfg.dim + 2 * cfg.dim * cfg.intermediate
    n_matmul = cfg.layers * per_layer + cfg.dim * cfg.vocab_size
    return 6.0 * n_matmul + 6.0 * cfg.layers * seq * cfg.dim


def _k4_launches() -> dict:
    return {k.name: k.launches for k in K4_KERNELS}


def phase_gpt2_train(seed: int, card: str) -> dict:
    """GPT-2 XL, bf16 (fp32 from the position add on, as the reference
    computes it), batch 8, seq 1024, remat none: one ff.fit epoch of 10
    seeded batches (the main path; counts reset just before, read just
    after), then 10 timed train steps on one repeated batch, then two
    profiled ones. Each K4 kernel must launch once per layer and step,
    K1/K2 and the ragged kernels never, and K4's fp32 forward, dq and
    dk/dv run their 3xTF32 bodies alone."""
    cfg = gpt2_xl()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    ff = _train_model(cfg, DEVICE, batch=TRAIN_BATCH, seq=GPT2_POSITIONS,
                      dtype=DataType.BFLOAT16, remat="none", seed=seed)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    x, y = _token_batches(TRAIN_BATCH * GPT2_BATCHES, GPT2_POSITIONS,
                          cfg.vocab_size, seed)
    _reset_launches()
    t0 = time.monotonic()
    pm = ff.fit(x, y, epochs=1, verbose=False)
    torch.cuda.synchronize()
    fit_s = time.monotonic() - t0
    fit_launches = {k.name: k.launches for k in KERNELS}
    want = cfg.layers * GPT2_BATCHES
    if any(fit_launches[k.name] != want for k in K4_KERNELS) \
            or any(fit_launches[k.name] != 0 for k in KERNELS
                   if k not in K4_KERNELS):
        raise AssertionError(f"fit launches {fit_launches}: want {want} "
                             "of each K4 kernel and no other")
    fit_loss = pm.sparse_cce_loss / pm.train_all
    if pm.train_all != TRAIN_BATCH * GPT2_BATCHES \
            or not np.isfinite(fit_loss):
        raise AssertionError(f"fit: {pm}")

    ex = ff.executor
    tr, ntr = ff._params
    opt = ff._opt_state
    bx, by = (torch.from_numpy(a[:TRAIN_BATCH]).to(DEVICE) for a in (x, y))
    torch.cuda.synchronize()
    _reset_launches()
    losses = []
    step_s = 0.0
    # the masters before step GPT2_CHECK_STEP, copied to the CPU outside
    # the timed windows, for the check below
    for steps in (range(GPT2_CHECK_STEP - 1),
                  range(GPT2_CHECK_STEP - 1, TIMED_STEPS)):
        t0 = time.perf_counter()
        for _ in steps:
            tr, ntr, opt, m = ex.train_step(tr, ntr, opt, by, bx)
            losses.append(m["loss"])
        torch.cuda.synchronize()
        step_s += (time.perf_counter() - t0) / TIMED_STEPS
        if len(losses) == GPT2_CHECK_STEP - 1:
            saved = tuple({k: {n: t.cpu() for n, t in w.items()}
                           for k, w in tree.items()} for tree in (tr, ntr))
    losses = [float(v) for v in losses]
    timed_launches = _k4_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # two profiled steps: K4's bodies (fp32 forward, dq and dk/dv on the
    # 3xTF32 ones) and K4's device ms a step, forward and backward
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            tr, ntr, opt, m = ex.train_step(tr, ntr, opt, by, bx)
        torch.cuda.synchronize()
    bodies = flash_bodies(prof, 2)
    k4_us = {"fwd": 0.0, "bwd": 0.0}
    for e in _device_events(prof):
        t32 = tf32_name(e.key) or ""
        if t32.startswith("flash_bh_"):
            k4_us["fwd" if "_fwd_" in t32 else "bwd"] += \
                e.self_device_time_total
    for part, us in k4_us.items():
        bodies[f"k4_{part}_ms_per_step"] = us / 2 / 1e3
    del prof
    tokens = TRAIN_BATCH * GPT2_POSITIONS
    flops = gpt2_flops_per_token(cfg, GPT2_POSITIONS) * tokens
    res = {
        "model": "gpt2_xl", "layers": cfg.layers, "dim": cfg.dim,
        "heads": cfg.heads, "dtype": "bfloat16", "batch": TRAIN_BATCH,
        "seq": GPT2_POSITIONS, "remat": "none",
        "params": sum(t.numel() for w in tr.values() for t in w.values()),
        "init_s": init_s, "fit_s": fit_s, "fit_steps": GPT2_BATCHES,
        "fit_loss": fit_loss, "fit_launches": fit_launches,
        "timed_steps": TIMED_STEPS, "losses": losses,
        "timed_launches": timed_launches, "step_ms": step_s * 1e3,
        "tokens_per_s": tokens / step_s, "flops_per_step": flops,
        "mfu": flops / step_s / PEAK_OPS[torch.bfloat16],
        "peak_mem_gb": peak_gb, "profile": bodies, "card": card,
    }
    log(f"train_gpt2 {json.dumps(res)}")
    del ff, ex, tr, ntr, opt, m
    torch.cuda.empty_cache()
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"GPT-2 loss on a repeated batch did not "
                             f"fall: {losses}")
    if any(n != cfg.layers * TIMED_STEPS for n in timed_launches.values()):
        raise AssertionError(f"timed launches {timed_launches}")
    if bodies["launches_per_step"] != {
            "tensor_core": {}, "cuda_core": {},
            "tf32": {"fwd": cfg.layers, "dq": cfg.layers,
                     "dkv": cfg.layers}}:
        raise AssertionError(f"K4's fp32 forward, dq and dk/dv did not run "
                             f"on their 3xTF32 bodies alone: {bodies}")
    res["step_check"] = gpt2_step_check(cfg, saved, x[:1], y[:1], seed)
    return res


def _loss_and_grads(ff, x, y):
    """The loss and {leaf name: gradient} (on the CPU) of one batch, with
    no update: Executor.loss_and_grads, the first half of a train step."""
    ex = ff.executor
    tr, ntr = ff._params
    bx, by = (torch.from_numpy(a).to(ex.device) for a in (x, y))
    loss, _, grads = ex.loss_and_grads(tr, ntr, by, bx)
    return float(loss), {f"{k}/{n}": g.cpu() for k, ws in grads.items()
                         for n, g in ws.items()}


def gpt2_step_check(cfg, saved, x, y, seed) -> dict:
    """Phase 8's step GPT2_CHECK_STEP (where its loss jumps, 9.90 ->
    11.34, with the same digits in every run) looked at again: the
    masters before that step, loaded into GPT-2 XL built in fp32 (TF32
    off) on the card and on the CPU, give the loss and every gradient of the step's first sequence
    (batch 1). If the two agree the card computes the step as the CPU's
    plain path does, and the jump is the optimizer's dynamics (Adam on a
    repeated batch), not a fault of the card's kernels. Agreement: the
    loss to TRAIN_LOSS_RTOL; all gradients together, and every leaf's, to
    GPT2_GRAD_RTOL in norm (fp32 summation order over 48 layers); except
    the key biases, whose gradient is 0 in exact arithmetic (softmax does
    not see a constant added to a row of scores), so both sides hold only
    rounding noise there: each must be under GPT2_GRAD_RTOL of the norm of
    all gradients."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = []
    for device in (DEVICE, "cpu"):
        params = tuple({k: {n: t.to(device) for n, t in w.items()}
                        for k, w in tree.items()} for tree in saved)
        ff = _train_model(cfg, device, batch=1, seq=GPT2_POSITIONS,
                          dtype=DataType.FLOAT, remat="none", seed=seed,
                          params=params)
        t0 = time.monotonic()
        out.append(_loss_and_grads(ff, x, y) + (time.monotonic() - t0,))
        del ff, params
        if device != "cpu":
            torch.cuda.empty_cache()
    (gl, gg, gs), (cl, cg, cs) = out
    norm = float(torch.cat([g.flatten() for g in cg.values()]).norm())
    diff = float(torch.cat([(gg[n] - cg[n]).flatten() for n in cg]).norm())
    key_bias = [n for n in cg if n.endswith("/bk")]
    rel = {n: float((gg[n] - cg[n]).norm() / cg[n].norm().clamp_min(1e-30))
           for n in cg if n not in key_bias}
    worst = max(rel, key=rel.get)
    bk_noise = max((float(max(gg[n].norm(), cg[n].norm())) / norm
                    for n in key_bias), default=0.0)
    res = {"step": GPT2_CHECK_STEP, "batch": 1, "dtype": "float32",
           "loss_card": gl, "loss_cpu": cl,
           "loss_rel_err": abs(gl - cl) / abs(cl),
           "grad_norm": norm, "grad_rel_err": diff / norm,
           "worst_grad": worst, "worst_grad_rel_err": rel[worst],
           "leaves": len(cg), "key_bias_leaves": len(key_bias),
           "key_bias_grad_over_norm": bk_noise, "card_s": gs, "cpu_s": cs,
           "loss_rtol": TRAIN_LOSS_RTOL, "grad_rtol": GPT2_GRAD_RTOL}
    log(f"gpt2_step_check {json.dumps(res)}")
    if not (np.isfinite(gl) and res["loss_rel_err"] <= TRAIN_LOSS_RTOL
            and res["grad_rel_err"] <= GPT2_GRAD_RTOL
            and rel[worst] <= GPT2_GRAD_RTOL
            and bk_noise <= GPT2_GRAD_RTOL):
        raise AssertionError(f"GPT-2 XL step {GPT2_CHECK_STEP}: card and "
                             f"CPU disagree: {res}")
    return res


# ---------------------------------------------------------------------------
# phase 10: bench_1b at an 8192-token context through ring attention


def _forward_logits(ff, bx):
    """The lm_head's logits (the sink softmax skipped) of one batch."""
    with torch.no_grad():
        return ff.executor.run_forward(*ff._params, [bx],
                                       skip_sink_softmax=True)


def phase_ring_train(seed: int, card: str) -> dict:
    """bench_1b, full depth and width, bf16, batch 1 x RING_SEQ tokens,
    ring attention over {"seq": RING_SHARDS}, remat none: one ff.fit epoch
    of RING_BATCHES seeded batches (the main path; counts reset just
    before, read just after: per layer and step K5 folds
    ring_folds(RING_SHARDS) blocks and K4's dq and dk/dv kernels run once
    per folded block, no other attention kernel), then 10 timed steps on
    one repeated batch (the loss must fall). Then the same model and
    weights without the ring (K1/K2 over the whole 8192 rows): its step
    time, and its forward logits against the ring model's at the initial
    weights (bf16, so within RING_LOGITS_RTOL of their largest). A
    profiled ring step between the two must show K5's launches on its
    tensor-core body (flash_fwd_wgmma_kernel<HeadMajorCarry, 128, ...>)
    and none on its CUDA-core one (flash_bh_fwd_carry_kernel)."""
    from torch.profiler import ProfilerActivity, profile

    cfg = LlamaConfig.bench_1b()
    mesh = {"seq": RING_SHARDS}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    ff = _train_model(cfg, DEVICE, batch=1, seq=RING_SEQ,
                      dtype=DataType.BFLOAT16, remat="none", seed=seed,
                      mesh_shape=mesh)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    x, y = _token_batches(RING_BATCHES, RING_SEQ, cfg.vocab_size, seed)
    bx, by = (torch.from_numpy(a[:1]).to(DEVICE) for a in (x, y))
    ring_logits = _forward_logits(ff, bx)
    _reset_launches()
    t0 = time.monotonic()
    pm = ff.fit(x, y, epochs=1, verbose=False)
    torch.cuda.synchronize()
    fit_s = time.monotonic() - t0
    fit_launches = {k.name: k.launches for k in KERNELS}
    per_step = cfg.layers * ring_folds(RING_SHARDS)
    ring_kernels = (FLASH_ATTENTION_BH_FWD_CARRY, FLASH_ATTENTION_BH_DQ,
                    FLASH_ATTENTION_BH_DKV)
    want = {k.name: (per_step * RING_BATCHES if k in ring_kernels else 0)
            for k in KERNELS}
    if fit_launches != want:
        raise AssertionError(f"fit launches {fit_launches}, want {want}")
    fit_loss = pm.sparse_cce_loss / pm.train_all
    if pm.train_all != RING_BATCHES or not np.isfinite(fit_loss):
        raise AssertionError(f"fit: {pm}")

    ex = ff.executor
    tr, ntr = ff._params
    opt = ff._opt_state
    torch.cuda.synchronize()
    _reset_launches()
    losses = []
    t0 = time.perf_counter()
    for _ in range(TIMED_STEPS):
        tr, ntr, opt, m = ex.train_step(tr, ntr, opt, by, bx)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / TIMED_STEPS
    losses = [float(v) for v in losses]
    timed_launches = {k.name: k.launches for k in ring_kernels}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tr, ntr, opt, m = ex.train_step(tr, ntr, opt, by, bx)
        torch.cuda.synchronize()
    carry = flash_bodies(prof, 1, "HeadMajorCarry",
                         r"flash_bh_fwd_(carry)_kernel<", "k5")
    del prof
    flops = llama_flops_per_token(cfg, RING_SEQ) * RING_SEQ
    res = {
        "model": "bench_1b", "layers": cfg.layers, "dtype": "bfloat16",
        "batch": 1, "seq": RING_SEQ, "mesh_shape": mesh, "remat": "none",
        "params": sum(t.numel() for w in tr.values() for t in w.values()),
        "init_s": init_s, "fit_s": fit_s, "fit_steps": RING_BATCHES,
        "fit_loss": fit_loss, "fit_launches": fit_launches,
        "launches_per_step": {k.name: per_step for k in ring_kernels},
        "timed_steps": TIMED_STEPS, "losses": losses,
        "timed_launches": timed_launches, "step_ms": step_s * 1e3,
        "tokens_per_s": RING_SEQ / step_s, "flops_per_step": flops,
        "mfu": flops / step_s / PEAK_OPS[torch.bfloat16],
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "profile": carry, "card": card,
    }
    del ff, ex, tr, ntr, opt, m
    torch.cuda.empty_cache()
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"ring loss on a repeated batch did not fall: "
                             f"{losses}")
    if any(n != per_step * TIMED_STEPS for n in timed_launches.values()):
        raise AssertionError(f"timed launches {timed_launches}")
    if carry["launches_per_step"] != {"tensor_core": {"fwd": per_step},
                                      "cuda_core": {}}:
        raise AssertionError(f"K5 did not run on its tensor-core body "
                             f"alone: {carry}")

    # the same model and seed without the ring: K1/K2 over all 8192 rows
    torch.cuda.reset_peak_memory_stats()
    ff = _train_model(cfg, DEVICE, batch=1, seq=RING_SEQ,
                      dtype=DataType.BFLOAT16, remat="none", seed=seed)
    plain_logits = _forward_logits(ff, bx)
    diff = float((ring_logits.float() - plain_logits.float()).abs().max())
    scale = float(plain_logits.float().abs().max())
    del ring_logits, plain_logits
    ex = ff.executor
    tr, ntr = ff._params
    opt = ff._opt_state
    tr, ntr, opt, m = ex.train_step(tr, ntr, opt, by, bx)  # warm-up
    torch.cuda.synchronize()
    _reset_launches()
    t0 = time.perf_counter()
    for _ in range(RING_PLAIN_STEPS):
        tr, ntr, opt, m = ex.train_step(tr, ntr, opt, by, bx)
    torch.cuda.synchronize()
    plain_s = (time.perf_counter() - t0) / RING_PLAIN_STEPS
    res["no_ring"] = {
        "step_ms": plain_s * 1e3, "steps": RING_PLAIN_STEPS,
        "launches": _flash_launches(),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "logits_max_abs_diff_vs_ring": diff, "logits_max_abs": scale,
        "logits_rtol": RING_LOGITS_RTOL}
    res["ring_step_over_no_ring"] = step_s / plain_s
    del ff, ex, tr, ntr, opt, m
    torch.cuda.empty_cache()
    log(f"train_ring {json.dumps(res)}")
    if diff > RING_LOGITS_RTOL * scale or not np.isfinite(diff):
        raise AssertionError(f"ring logits differ from the plain route's "
                             f"by {diff} (largest {scale})")
    if any(n != cfg.layers * RING_PLAIN_STEPS
           for n in res["no_ring"]["launches"].values()):
        raise AssertionError(f"no-ring launches {res['no_ring']}")
    return res


# ---------------------------------------------------------------------------
# phase 11: bench.py's 200m Llama (head dim 64) trained through K4


def flash_bodies(prof, n: int, tag: str = "HeadMajor",
                 cuda_core=r"flash_bh_(fwd|dq|dkv)_kernel<",
                 label: str = "k4") -> dict:
    """From a torch.profiler run of n train steps: per step, the launches
    of each body of one head-major kernel family ({"tensor_core": {fwd,
    dq, dkv}, "cuda_core": {...}}, and "tf32": {fwd, dq, dkv} where K4's
    3xTF32 bodies ran): the tensor-core bodies under the layout tag
    `tag`, the CUDA-core ones whose names match `cuda_core` (K4 by
    default; K5 is tag "HeadMajorCarry" and the
    flash_bh_fwd_carry_kernel); and their device ms and share of the
    device time, keyed by `label`."""
    evs = _device_events(prof)
    dev = sum(e.self_device_time_total for e in evs)
    launches = {"tensor_core": {}, "cuda_core": {}}
    own_us = 0.0
    for e in evs:
        name = wgmma_name(e.key)
        t32 = tf32_name(e.key)
        if name and name.split("<")[1].split(",")[0] == tag:
            body, kind = "tensor_core", name.split("_")[1]
        elif t32 and t32.startswith("flash_bh_") and tag == "HeadMajor":
            body = "tf32"
            kind = ("fwd" if t32.startswith("flash_bh_fwd") else
                    "dkv" if "<true" in t32 else "dq")
            launches.setdefault(body, {})
        else:
            m = re.search(cuda_core, e.key)
            if not m:
                continue
            body, kind = "cuda_core", m[1]
        launches[body][kind] = launches[body].get(kind, 0) + e.count // n
        own_us += e.self_device_time_total
    return {"launches_per_step": launches,
            f"{label}_ms_per_step": own_us / n / 1e3,
            "device_ms_per_step": dev / n / 1e3,
            f"{label}_share_of_device_time": own_us / dev if dev else
            "not measured"}


def phase_train_200m(seed: int, card: str) -> dict:
    """bench.py's 200m Llama (llama_200m: head dim 64, so every attention
    takes the head-major route), bf16, fp32 masters, batch 8, seq 1024,
    remat none, Adam lr 1e-4: one ff.fit epoch of 10 seeded batches (the
    main path; counts reset just before, read just after: each K4 kernel
    once per layer and step, no other attention kernel), 10 timed steps
    on one repeated batch (the loss must fall), then two profiled steps
    that must show K4's launches on its tensor-core bodies
    (flash_*_wgmma_kernel<HeadMajor, 64, ...>) and none on its CUDA-core
    bodies; reports K4's share of the device time and the device's idle
    share of a timed step."""
    from torch.profiler import ProfilerActivity, profile

    cfg = llama_200m()
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
    fit_launches = {k.name: k.launches for k in KERNELS}
    want = {k.name: (cfg.layers * TRAIN_BATCHES if k in K4_KERNELS else 0)
            for k in KERNELS}
    if fit_launches != want:
        raise AssertionError(f"fit launches {fit_launches}, want {want}")
    fit_loss = pm.sparse_cce_loss / pm.train_all
    if pm.train_all != TRAIN_BATCH * TRAIN_BATCHES \
            or not np.isfinite(fit_loss):
        raise AssertionError(f"fit: {pm}")

    ex = ff.executor
    tr, ntr = ff._params
    opt = ff._opt_state
    bx, by = (torch.from_numpy(a[:TRAIN_BATCH]).to(DEVICE) for a in (x, y))
    torch.cuda.synchronize()
    _reset_launches()
    losses = []
    t0 = time.perf_counter()
    for _ in range(TIMED_STEPS):
        tr, ntr, opt, m = ex.train_step(tr, ntr, opt, by, bx)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / TIMED_STEPS
    losses = [float(v) for v in losses]
    timed_launches = _k4_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n = 2
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            tr, ntr, opt, m = ex.train_step(tr, ntr, opt, by, bx)
        torch.cuda.synchronize()
    bodies = flash_bodies(prof, n)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops = llama_flops_per_token(cfg, TRAIN_SEQ) * tokens
    res = {
        "model": "llama_200m", "layers": cfg.layers, "dim": cfg.dim,
        "heads": cfg.heads, "kv_heads": cfg.kv_heads,
        "head_dim": cfg.dim // cfg.heads, "dtype": "bfloat16",
        "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "remat": "none",
        "params": sum(t.numel() for w in tr.values() for t in w.values()),
        "init_s": init_s, "fit_s": fit_s, "fit_steps": TRAIN_BATCHES,
        "fit_loss": fit_loss, "fit_launches": fit_launches,
        "timed_steps": TIMED_STEPS, "losses": losses,
        "timed_launches": timed_launches, "step_ms": step_s * 1e3,
        "tokens_per_s": tokens / step_s, "flops_per_step": flops,
        "mfu": flops / step_s / PEAK_OPS[torch.bfloat16],
        "peak_mem_gb": peak_gb, "profile": bodies, "card": card,
    }
    if isinstance(bodies["k4_share_of_device_time"], float):
        # the device's idle share of a timed step
        res["idle_share"] = 1 - bodies["device_ms_per_step"] / (step_s * 1e3)
    log(f"train_200m {json.dumps(res)}")
    del ff, ex, tr, ntr, opt, m
    torch.cuda.empty_cache()
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"200m loss on a repeated batch did not fall: "
                             f"{losses}")
    if any(n != cfg.layers * TIMED_STEPS for n in timed_launches.values()):
        raise AssertionError(f"timed launches {timed_launches}")
    per_step = {k: cfg.layers for k in ("fwd", "dq", "dkv")}
    if bodies["launches_per_step"] != {"tensor_core": per_step,
                                       "cuda_core": {}}:
        raise AssertionError(f"K4 did not run on its tensor-core bodies "
                             f"alone: {bodies}")
    return res


def gpt2_traffic(vocab: int, seed: int):
    """GPT2_PROMPTS seeded prompts of GPT2_PROMPT_MIN..GPT2_PROMPT_MAX
    tokens."""
    rs = np.random.RandomState(seed)
    lens = rs.randint(GPT2_PROMPT_MIN, GPT2_PROMPT_MAX + 1,
                      size=GPT2_PROMPTS)
    return [rs.randint(0, vocab, (n,)).astype(np.int32) for n in lens]


def phase_gpt2_serve(seed: int, card: str) -> dict:
    """GPT-2 XL, 48 layers, bf16, random weights from the seed, through
    serve_generation(paged=True) at its defaults (4 slots, page 64, a
    pool for every slot's longest sequence) with max_len 1024, the
    position table's rows: gpt2_traffic's 8 requests at once, 64 new
    tokens each, greedy. The ragged kernel must launch once per layer
    and ragged step (counts reset just before, read just after); max_len
    1025 must be refused."""
    cfg = gpt2_xl()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    ff = FFModel(FFConfig(batch_size=1, seed=seed, device=DEVICE))
    build_gpt2(ff, cfg, batch_size=1, seq_len=GPT2_POSITIONS,
               dtype=DataType.BFLOAT16)
    ff.compile()
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    try:
        ff.serve_generation(paged=True, max_len=GPT2_POSITIONS + 1)
    except ValueError as e:
        refused = str(e)
    else:
        raise AssertionError("max_len past the position table was served")
    server = ff.serve_generation(paged=True, slots=4,
                                 max_len=GPT2_POSITIONS, page_size=64,
                                 seed=seed)
    prompts = gpt2_traffic(cfg.vocab_size, seed)
    try:
        # warm cuBLAS and the allocator off the clock
        server.generate(prompts[0][:16], max_new_tokens=2, timeout=600)
        steps0, served0 = server.ragged_steps, server.requests_served
        _reset_launches()
        t1 = time.monotonic()
        futs = [server.submit(p, max_new_tokens=GPT2_NEW)
                for p in prompts]
        outs = [f.result(timeout=900) for f in futs]
        torch.cuda.synchronize()
        wall = time.monotonic() - t1
        launches = {k.name: k.launches for k in KERNELS}
        steps = server.ragged_steps - steps0
        recs = server.metrics()["requests"][served0:]
        num_pages = server.pool.num_pages
    finally:
        server.stop()
    server.pool.check_invariants(owners={})
    for o in outs:
        if len(o) != GPT2_NEW \
                or not ((0 <= o) & (o < cfg.vocab_size)).all():
            raise AssertionError(f"bad output {o}")
    if launches[RAGGED_PAGED_ATTENTION.name] != cfg.layers * steps \
            or steps == 0 or any(launches[k.name] for k in K4_KERNELS):
        raise AssertionError(f"launches {launches} != {cfg.layers} x "
                             f"{steps} ragged, 0 K4")
    ttft = sorted(r["ttft_s"] for r in recs)
    decode_rates = [(r["decode_tokens"] - 1) / r["decode_s"] for r in recs]
    res = {
        "model": "gpt2_xl", "layers": cfg.layers, "dtype": "bfloat16",
        "max_len": GPT2_POSITIONS, "num_pages": num_pages,
        "requests": len(outs), "prompt_lens": [len(p) for p in prompts],
        "new_tokens": GPT2_NEW, "ragged_steps": steps,
        "launches": launches, "wall_s": wall,
        "generated_tokens_per_s": GPT2_NEW * len(outs) / wall,
        "decode_tokens_per_s_per_request_mean": float(np.mean(decode_rates)),
        "ttft_p50_s": ttft[len(ttft) // 2], "ttft_max_s": ttft[-1],
        "init_s": init_s, "max_len_1025_refused": refused,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "card": card,
    }
    log(f"serve_gpt2 {json.dumps(res)}")
    del ff
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
        entry.update({k: res[k] for k in (
            "library", "sdpa_bf16_predequantized_ms",
            "sdpa_fwd_yardstick_ms") if k in res})
    return entry


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default="1,2,3,4,6,7,8,9,10,11",
                    help="comma-separated phases to run (default "
                    "1,2,3,4,6,7,8,9,10,11; 5 profiles serving and "
                    "training steps)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    phases = {int(p) for p in args.phases.split(",")}
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", flush=True)
        return 2
    t_start = time.monotonic()
    card = card_line()
    log(f"card {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    t0 = time.monotonic()
    secs = build(KERNELS)
    for k in KERNELS:
        k.function()  # load and bind
    built = {"seconds": time.monotonic() - t0, "per_source": secs,
             "hgmma": hgmma_counts(), "tf32_hmma": tf32_hmma_counts()}
    log(f"build {json.dumps(built)}")
    kern = phase_kernels(card) if 2 in phases else []
    if 2 in phases:
        split_sweep(card)
    kern8 = phase_int8_kernels(card) if 2 in phases else []
    flash = phase_flash_kernels(card) if 2 in phases else {}
    if 2 in phases:
        for case, shape, T, causal in FLASH_CASES:
            phase_flash_kernels(card, shape, case, T, causal)
    k4 = phase_k4_kernels(card) if 2 in phases else {}
    k5 = phase_k5_kernels(card) if 2 in phases else {}
    step3 = None
    if 3 in phases:
        phase_step(args.seed)
        phase_gpt2_step(args.seed)
        step3 = phase_train_step(args.seed)
        phase_train_step(args.seed, gpt2_xl(), "gpt2_xl")
        phase_train_step(args.seed, label="bench_1b_ring", seq=1024,
                         mesh_shape={"seq": RING_SHARDS})
        phase_ring_untiled(args.seed)
    serve = phase_serve(args.seed, card) if 4 in phases else None
    train = phase_train(args.seed, card) if 6 in phases else None
    serve8 = phase_serve_int8(args.seed, card) if 7 in phases else None
    gpt2 = phase_gpt2_train(args.seed, card) if 8 in phases else None
    if 9 in phases:
        phase_gpt2_serve(args.seed, card)
    ring = phase_ring_train(args.seed, card) if 10 in phases else None
    train_200m = phase_train_200m(args.seed, card) if 11 in phases else None
    if 5 in phases:
        phase_profile(args.seed, card)
        phase_profile_train(args.seed, card)
        phase_profile_train(args.seed, card, gpt2_xl(), "gpt2_xl")
        phase_profile_train(args.seed, card, label="bench_1b_ring_s8192",
                            batch=1, seq=RING_SEQ,
                            mesh_shape={"seq": RING_SHARDS})
        phase_profile_train(args.seed, card, llama_200m(), "llama_200m")
    main_case = next((r for r in kern if r["case"] == ATTENTION_CASES[0][0]
                      and r["dtype"] == "bfloat16"), None)
    entries = [_kernel_entry(
        RAGGED_PAGED_ATTENTION,
        "flexflow_tpu_torch/csrc/ragged_paged_attention.cu",
        serve["launches"][RAGGED_PAGED_ATTENTION.name] if serve else 0,
        main_case)]
    int8_case = next((r for r in kern8 if r["case"] == ATTENTION_CASES[0][0]
                      and r["dtype"] == "bfloat16"), None)
    entries.append(_kernel_entry(
        RAGGED_PAGED_ATTENTION_INT8,
        "flexflow_tpu_torch/csrc/ragged_paged_attention.cu",
        serve8["launches"][RAGGED_PAGED_ATTENTION_INT8.name] if serve8
        else 0, int8_case))
    # K1/K2 on phase 6's bf16 fit, timed at bench_1b's attention shape
    # (phase 2), and their fp32 bodies under "fp32": launches in phase 3's
    # fp32 bench_1b step (K2 there on its 3xTF32 body), timed at the same
    # shape
    for k, src in ((FLASH_ATTENTION_FWD, "flash_attention_fwd.cu"),
                   (FLASH_ATTENTION_DQ, "flash_attention_bwd.cu"),
                   (FLASH_ATTENTION_DKV, "flash_attention_bwd.cu")):
        entry = _kernel_entry(
            k, f"flexflow_tpu_torch/csrc/{src}",
            train["fit_launches"][k.name] if train else 0,
            flash.get("bfloat16", {}).get(k.name))
        fp32 = _kernel_entry(
            k, entry["source"],
            step3["flash_launches"][k.name] if step3 else 0,
            flash.get("float32", {}).get(k.name))
        entry["fp32"] = {key: val for key, val in fp32.items()
                         if key not in ("name", "route", "source",
                                        "replaces")}
        entries.append(entry)
    # K4 on this slice's main path: phase 11's bf16 fit, timed at its
    # attention shape (phase 2)
    # and its fp32 bodies on phase 8's: GPT-2 XL's fit, timed at its
    # attention shape (phase 2), under "fp32"
    for k, src in ((FLASH_ATTENTION_BH_FWD, "flash_attention_bh_fwd.cu"),
                   (FLASH_ATTENTION_BH_DQ, "flash_attention_bh_bwd.cu"),
                   (FLASH_ATTENTION_BH_DKV, "flash_attention_bh_bwd.cu")):
        entry = _kernel_entry(
            k, f"flexflow_tpu_torch/csrc/{src}",
            train_200m["fit_launches"][k.name] if train_200m else 0,
            k4.get("timed", {}).get("llama_200m_causal", {}).get(k.name))
        fp32 = _kernel_entry(
            k, entry["source"],
            gpt2["fit_launches"][k.name] if gpt2 else 0,
            k4.get("main", {}).get("float32", {}).get(k.name))
        entry["fp32"] = {key: val for key, val in fp32.items()
                         if key not in ("name", "route", "source",
                                        "replaces")}
        entries.append(entry)
    entries.append(_kernel_entry(
        FLASH_ATTENTION_BH_FWD_CARRY,
        "flexflow_tpu_torch/csrc/flash_attention_bh_fwd.cu",
        ring["fit_launches"][FLASH_ATTENTION_BH_FWD_CARRY.name] if ring
        else 0, k5.get("main", {}).get("bfloat16_full")))
    log(f"total {json.dumps({'seconds': time.monotonic() - t_start})}")
    print(card, flush=True)
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
