"""Chip smoke test of flexflow_tpu_torch, the PyTorch/CUDA port: drives the
port's main paths on one NVIDIA card, paged Llama serving (fp and int8 KV
pools, prefix cache, preemption, defrag, decode and universal megasteps,
speculative decoding, the unpacked launch), dense KV-cache serving and
generation, Llama training (head dims 128,
64, 96 and 100), GPT-2 training and paged serving, Llama training
through ring attention (head dims 128, 96 and 100), Mixtral-8x7B's
widths trained and served paged (the MoE ops), and the model zoo trained
at full width (BERT-base, the encoder-decoder Transformer, ResNet-50, the
LSTM NMT, DLRM), a Llama built as one PIPELINE composite trained and
decoded, BERT-base behind the batch server and the paged server behind
the HTTP endpoint with its request log and SLO, the paged server with a
host KV tier, disaggregated into prefill and decode workers, behind a
prefix-affinity router, with the kv_quant_canary shadow cache and under
the span tracer, GPT-2 imported from the HuggingFace layout, trained from
file loaders with periodic checkpoints and resumed, a Llama-3-8B-width
HF import, and every example script, the strategy search with measured
costs and the timed playoff on bench_1b and its ring candidates, the
serving-strategy search with its calibration loop and the autopilot's
drain-and-swap, and holds every hand-written kernel on them to its plain
PyTorch version.

    python3 chip_smoke.py            # phases 1..4, 6..23, one card
    python3 chip_smoke.py --phases 5 # + profiles of serving and training

Phases (each raises on failure: non-zero exit, no "ok" line):
  1. card: name and power limit; build every kernel from csrc/ (nvcc,
     sm_90a, one process per source, all started together), with the
     seconds each source took and the HGMMA (wgmma) instructions in the
     SASS of each tensor-core flash kernel: K1/K2's forward, dq and
     dk/dv at head dims 64, 128 and 256, K4's at 48, 64, 80, 96, 100,
     128 and 256, and K5's forward at those seven (WGMMA_KERNELS; D
     100's tiles filled by cp.async), with ptxas's registers and spills
     for each (none may spill), and the tf32 HMMA (mma.sync)
     instructions of the 3xTF32 fp32 bodies: K4's forward, dq and dk/dv
     at 64, 128 and 256 and K2's flat dq and dk/dv at 128 and 256
     (TF32_KERNELS);
  2. kernels vs their plain versions on the card, with kernel / plain /
     library times and the roofline bound: the ragged paged attention at
     the serving path's shapes (Llama-3-8B attention: H=32, Hkv=8,
     D=128, page 64, 129 pages; decode, chunk and pad entries; window 1
     and 8; a decode at the end of the 32-page table; the speculative
     verify at its 9-row tree window under two real draft trees'
     ancestor masks, tree_w9; and GPT-2 XL's decode: H = Hkv = 25, D
     64) over fp pools, then at the windows whose q and acc rows one
     block cannot hold, which the kernel cuts into row tiles: the
     unpacked prefill's one entry of a 13-token (window 16) and a
     64-token chunk (window 64) and a 65-node tree (WIDE_CASES), bf16 and
     fp32 q over fp and int8 pools, each with its split plan, the fp kernel's pages per split swept at the
     steady decode case and at tree_w9 (SPLIT_SWEEP, fp and int8
     pools), over int8 pools (Llama's cases) written by the port's own
     quantize-on-append, over a bf16 pool under fp32 q and over an fp32
     pool under bf16 q (the canary's shadow launch, phase 20c), and at
     the page sizes the serving search offers besides 64 (8, 16, 32,
     128: the steady decode, mixed_w8 and tree_w9 cases, bf16 q over
     bf16 and int8 pools, PAGE_SIZES); and the flash-attention forward, dq and dk/dv kernels at the training
     path's shape (bench_1b attention: B 8, S = T 1024, H 16, Hkv 8,
     D 128, causal) and at phase 17a's (Mixtral-8x7B attention: B 2,
     S = T 2048, H 32, Hkv 8, D 128, causal), then at a ragged S = T =
     1000, at S 256 against
     T 1024 (full), at head dim 256 (Gemma-7B's attention: B 2, S = T
     1024, 16 heads of 256, causal), at 384 and 512, and at S = T 4096
     (4 heads over 2, D 128, causal and full: K2's fp32 sums past 2048
     rows) (FLASH_CASES);
     bf16 and fp32 (K2's fp32 at 128 and 256 on its 3xTF32 body, with
     the body's floor, 3 x ops at the tf32 peak, beside the bound); and
     the head-major flash kernels K4 (forward, dq, dk/dv) at GPT-2 XL
     training's shape (B*H 8*25, S = T 1024, D 64, causal) and at phase
     11's (B*H 8*16, bf16), phase 12's (B*H 8*32, D 96, bf16) and phase
     13's (B*H 8*32, D 100, bf16) with
     times, then at head dims 48, 80, 96, 100 and 256, non-causal, S !=
     T, S not a multiple of the tile and phase 10's ring block (B*H 16,
     S = T 2048, D 128, causal and full), each timed beside SDPA in its
     dtype and each backward also fed a shifted lse (the ring's
     contract), and in fp32 at S = T 4096 and 8192 (D 64 and 128, causal
     and full: the 3xTF32 backward's sums past 2048 rows); the flash
     checks (max |err|, error norm, lse; FLASH_TOLS, LSE_ATOL) must
     reject a planted fault at GPT-2 XL's shape, bf16 and fp32, and at
     phase 13's (D 100, bf16) (the plain results with one key tile
     skipped for the last query rows);
     fp32 cases' library time is SDPA's in fp32; K1/K2 timed at
     D 64 on the same shape beside K4 and the head-major route; the ring
     step K5 at phase 10's block (B*H 16, S = T
     2048, D 128, full and causal, a carried-in state) and at phase 14's
     (B*H 32, S = T 2048, D 96 and 100, bf16; K5_RING_BLOCKS) with times,
     then at head dims 48..256, S != T and s_loc 192 at D 96 and 100
     (K5_CASES); the K5 checks must reject a planted fault at phase 14's
     blocks, from the initial and from a carried state
     (planted_carry_fault_check);
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
     length gate): its output, gradients and launches; at Mixtral-8x7B's
     widths two packed ragged steps, depth 2, on an fp pool, and one Adam
     train step, depth 1, batch 1, seq 256 (the load-balance term too),
     each first reporting the expert assignment of both sides and the
     (row, choice) pairs dropped at capacity (some must drop in the
     train step), and refusing a difference in assignment; and the zoo
     (phase_zoo_step): one Adam step of BERT at BERT-base's widths,
     depth 2, dropout 0 (K4 twice a kernel), of the encoder-decoder at
     TransformerConfig()'s widths, depth 1, src 256, tgt 200 (K4 three
     times a kernel: non-causal, causal, cross), of the NMT at
     NMTConfig()'s widths, depth 1, and of DLRM at a 10 k vocabulary,
     each to phase_train_step's bounds, and one SGD step of ResNet-50 at
     64x64, batch 8, held by each leaf's update direction with its moved
     running statistics (the ZOO_RESNET_* bounds: its random-init fp32
     gradients are ill-conditioned);
  4. serving: Llama-3-8B (32 layers, bf16, random weights from a seed)
     through serve_generation(paged=True) at its defaults (prefix cache
     and preemption on); 8 requests of 128..1024 prompt tokens, 64 new
     tokens each; the ragged kernel must have launched once per layer and
     step (counts reset just before, read just after);
  5. (on request) torch.profiler breakdowns of one decode step, one
     prefill step, one decode step on an int8 pool (with the int8 ragged
     kernels' and quantize-on-append's launches and ms), one decode
     megastep of 8 ticks (Executor.paged_megastep_fn and its one
     transfer back) at the decode step's launch, one universal megastep
     of 8 ticks at phase 16's window 8 (three decode rows, one prefill
     row; wall, device time, idle share, launches a tick), one bench_1b
     train step, one GPT-2 XL train step, one phase-10 ring step, one
     phase-11 step, one phase-12 step, one phase-13 step, one ring
     step of phase 14's Phi-3-mini-width Llama and one step of phase
     17a's Mixtral (on uniform ids: the experts' rows nearly even);
  6. training: bench_1b (16 layers, bf16, batch 8, seq 1024,
     remat="none", Adam lr 1e-4, random weights from a seed) through
     ff.fit for one epoch of 10 seeded batches, then 10 timed steps on
     one repeated batch (the loss must fall); each flash kernel must
     launch 16 times per step; then two remat="attention" steps, where
     the forward kernel launches twice per layer;
  7. the whole paged server: Llama-3-8B's widths (8 of its 32 layers,
     SERVE7_LAYERS; bf16) through
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
     loss and gradients, fp32, batch 1, its first 256 tokens
     (GPT2_CHECK_SEQ), on the card and on the CPU, which must agree;
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
     a profiled step must show K5 and K4's dq and dk/dv on their
     tensor-core bodies at head dim 128 only (their ms a step, the idle
     share); then the same model and weights without the ring (K1/K2
     over all 8192 rows): its step time, and its logits against the
     ring's;
 11. training bench.py's 200m Llama (bench.py:56-58: vocab 32000, dim
     1024, 12 layers, 16 heads over 8 kv heads, head dim 64, FFN 2816;
     bf16, fp32 masters, batch 8, seq 1024, remat="none", Adam lr 1e-4,
     random weights from a seed) through ff.fit for one epoch of 10
     seeded batches, then 10 timed steps on one repeated batch (the loss
     must fall); each K4 kernel must launch 12 times per step and no
     other attention kernel, and a profiled step must show K4 on its
     tensor-core bodies only (K4's share of the device time reported).
     The kernels line takes K4's launches from this phase;
 12. training a Llama at Phi-3-mini's widths
     (microsoft/Phi-3-mini-4k-instruct: vocab 32064, dim 3072, 32 heads
     and 32 kv heads of 96, FFN 8192, rope theta 10000; 16 of its 32
     layers) as phase 11 trains the 200m one: each K4 kernel must launch
     16 times per step, on its tensor-core bodies at head dim 96 only
     (the kernels line records these launches under "phi3_mini");
 13. training a Llama at OpenLLaMA-3B's widths
     (openlm-research/open_llama_3b: vocab 32000, dim 3200, 32 heads and
     32 kv heads of 100, FFN 8640, rope theta 10000, rms_norm_eps 1e-6,
     untied embeddings; 16 of its 26 layers) the same way: each K4 kernel
     must launch 16 times per step, on its tensor-core bodies at head dim
     100 only, whose tiles are filled by cp.async (the kernels line
     records these launches under "openllama_3b");
 14. training phase 12's Llama at Phi-3-mini's widths (16 layers, head
     dim 96; its family's 128k-context variant shares these widths) at
     8192 tokens, batch 1, through ring attention over {"seq": 4}, as
     phase 10 trains bench_1b: per layer and step K5 folds 10 blocks and
     K4's dq and dk/dv run once per fold, no other attention kernel; the
     loss must fall; a profiled step must show K5 on
     flash_fwd_wgmma_kernel<HeadMajorCarry, 96, ...> only and K4's
     backward on <HeadMajor, 96, ...> only (their ms a step, the idle
     share); then the same model without the ring (K4 over all 8192
     rows): its step time, and its logits against the ring's. The
     reference's build_llama has neither Phi-3's sliding window nor its
     LongRoPE scaling, so this is a Llama at Phi-3-mini's widths, not
     Phi-3-mini. Then OpenLLaMA-3B's widths (head dim 100: K5's
     cp.async-loaded body) cut to 2 layers (RING_OPENLLAMA_LAYERS, to keep
     the phase short) the same way (the kernels line records K5's
     launches of each under "phi3_mini" and "openllama_3b");
 15. serving Llama-3-8B's widths at 2 of its 32 layers (MEGASTEP_LAYERS;
     phase 4's requests and server defaults)
     (a) through megastep_ticks=8 against the one-tick loop, greedy and
     sampled at a fixed seed: tokens identical, one synchronizing CUDA
     call a megastep (set_sync_debug_mode("warn")), the ragged kernel
     once per layer and ragged step (a megastep tick is one); (b)
     through speculate=SpecConfig(width=2, depth=4) on make_token_cyclic
     weights, each request's last 65 prompt tokens holding the cyclic
     stream (prompt lookup has nothing to accept in phase 4's random
     prompts at 128256 tokens): >= 1.5 tokens per verify step per
     request, the ragged kernel once per layer and verify step at the
     9-row window; (c) fp32 with TF32 off, depth 2, random weights,
     requests rebuilt the same way from this model's own tokens: the
     one-tick, megastep and speculative servers' tokens identical; the
     speculative server on an int8 pool too, and a commit on the pools
     it left equal on the card and on the CPU (the kernels line records
     the tree-window launches of (b) and of (c)'s int8 pool under
     "tree_w9");
 16. serving Llama-3-8B's widths at MEGASTEP_LAYERS layers (phase 4's
     server settings and requests)
     (a) through megastep_mixed=True, megastep_ticks=8 (the universal
     megastep: chunk rows and decode rows in one dispatch, K3 at window
     8) against the one-tick loop and the decode-only megastep, greedy,
     and mixed N = 1 against N = 8 sampled, one synchronizing call a
     mixed dispatch; tokens/s, TTFT, wall a tick, host round trips a
     token, ticks a dispatch, breaks, predicated-off ticks; (b) +
     overlap_dispatch=True; (e) serve_generation's dense default and
     ff.generate, cache bytes and tokens/s; (d) ragged_pack=False (K3 at
     windows 8..64) and its padded-row share; (c) on make_token_cyclic
     weights speculation through the mixed megastep (device-drafted
     chains), and (d) on the speculative server; tokens identical where
     the runs launch the same shapes (bf16 rounds other shapes
     differently: those shares are reported); (f) fp32, TF32 off, depth
     2: the one-tick, mixed, mixed + speculative, unpacked and
     draft-model speculative servers and dense generate, greedy tokens
     identical, and the int8 mixed megastep against the int8 one-tick
     server (the kernels line records K3's window-8 launches of (a)
     under "mixed_w8" and its window-64 launches of (d) under
     "unpacked_w64");
 17. Mixtral-8x7B's widths (vocab 32000, dim 4096, 32 heads over 8 of
     128, rope theta 1e6, 8 experts of FFN 14336 top-2, capacity factor
     1.25, lambda_bal 1e-2; the repo's experts have two matrices, no w3
     gate; random weights from a seed): (a) trained at depth 2 of 32,
     bf16, batch 2 x 2048, Adam lr 1e-4, through ff.fit a step at a
     time on one batch: losses (finite, falling), tokens/s, MFU from the
     active FLOPs (attention, router, 2 of 8 experts, lm head) with the
     computed expert rows' share beside it, peak memory, the pairs
     dropped at capacity in each step, and K1, K2 dq and K2 dk/dv
     once a layer and step; (b) served at all 32 layers in bf16 (63.3
     GB; the deepest that fits beside the pool otherwise, its reckoning
     printed) through serve_generation(paged=True): 8 prompts of
     64..512 tokens, 64 new each, greedy: tokens/s, TTFT p50, peak
     memory, K3 once per layer and step, and a profiled steady decode
     step's wall and device ms beside its floor (every weight read, the
     bytes over the HBM rate); (c) bench_1b at phase 6's shape under
     remat="none" and remat="hidden": peak memory, step ms, the first
     loss alike (the kernels line records K1/K2's launches of (a) and
     K3's of (b) under "mixtral");
 18. the model zoo at full width, each a fit of 10 steps on one repeated
     batch (Adam lr 1e-4; the loss must fall), with PyTorch's default
     precision flags (fp32 matmuls in fp32, cuDNN's convolutions in
     TF32): (a) BERT-base (BertConfig(): 12 x 768, 12 heads of 64, FFN
     3072, vocab 30522), batch 32 x seq 512, declared bf16 (fp32 from
     its position add on, as the reference computes it), remat none, at
     the reference's attention dropout 0.1 (the dense dropout route once
     a layer and step, K4 never), then eval and predict (K4's forward once
     a layer a call), then a fresh model at dropout 0 (K4's forward, dq
     and dk/dv once a layer and step): ms a step, tokens/s, MFU at 989
     TF/s (bert_flops_per_token), peak memory; (b) the encoder-decoder
     Transformer at TransformerConfig() (512 wide, 8 heads, FFN 2048, 6 + 6
     layers, fp32), src 256, tgt 200, batch 32, MSE: K4's fp32 bodies
     three times a layer and step (encoder, causal decoder,
     cross-attention at S 200 != T 256); (c) ResNet-50 at 224x224, batch
     64, 1000 classes, fp32: images/s, every BatchNorm's running
     statistics moved and read by predict; (d) the LSTM NMT at
     NMTConfig() (1024 / 1024, 2 + 2 layers, 32000-word vocabularies), 32
     + 32 tokens, batch 64: tokens/s; (e) DLRM at build_dlrm's defaults
     (8 tables of 1 M x 64 fp32), batch 2048, MSE: samples/s; then K4
     against its plain versions at their attention shapes, timed beside
     SDPA in fp32 (K4_ZOO_CASES; the kernels line records K4's launches
     of (a) and (b) under "bert_base", "encdec_self", "encdec_causal",
     "encdec_cross");
 19. the PIPELINE composite and the serving surface: (a) bench_1b (16
     layers, bf16, batch 8 x 1024, Adam lr 1e-4, remat none) built with
     use_pipeline=True on phase 6's weights (the unstacked build from the
     same seed, its leaves stacked on a leading layer dim:
     stacked_llama_params) through ff.fit over phase 6's 10 batches: K1,
     K2 dq and K2 dk/dv once a layer and step, the first loss the
     unstacked build's within the bf16 TOLS, then 10 timed steps on one
     batch (the loss must fall) beside the unstacked build's, timed in
     the same run; (b) FFModel.generate through the stacked dense cache
     ((32, 4, 1024, 8, 128)) at Llama-3-8B's widths, bf16, 4 prompts of
     128 tokens, 64 new, greedy, beside the unstacked build on the same
     weights (ms a token, the share of equal tokens), identical tokens at
     depth 2 in fp32, and serve_generation(paged=True) refused with the
     reference's ValueError; (c) BERT-base (BertConfig(), seq 128,
     declared bf16, so K4's fp32 bodies) behind ff.serve(batch_sizes=
     (32,), max_delay_ms=2) (its [CLS] reshape fixes the batch dim): 256
     requests of 1..4 rows from 8 client threads, each answer predict's
     within FLASH_TOLS, requests/s, latency p50 / p99, rows a batch, K4's
     forward once a layer a forward; then
     http_serve: ready, a KServe-v2 infer equal to predict, /metrics, 503
     after stop; K4's forward timed at the 32-row batch's attention
     shape; (d) phase 4's requests at Llama-3-8B's widths, 2 layers,
     through the paged server behind http_serve with the request log
     (64), 4 kept records and an SLO every request misses (a breach
     bundle in a temporary directory), against the same requests with
     the log off: 8 records, their JSONL export read back, 4 kept and 4
     dropped, /v2 metrics equal to metrics(), /metrics parsed with
     ff_slo_breaches_total >= 1, the bundle, equal tokens, and the decode
     tick's ms and synchronizing calls with and without (the kernels
     line records K1/K2's launches of (a) under "pipeline_1b", K4's
     forward's of (c) under "bert_serve", K3's of (d) under
     "http_serve");
 20. the host KV tier, disaggregation, the canary and the tracer, at
     Llama-3-8B's widths, 2 of its 32 layers (TIER_LAYERS), bf16, random
     weights from the seed (a page of 64 rows is 512 KiB): (a) four
     1024-token system prompts, 32 requests of one plus 64 tokens of
     their own, 32 new each, in 8 waves of 4 sharing a prompt (A, B, C,
     D, A, B, C, D; each wave's first request alone, then the other
     three), through serve_generation(paged=True) at its defaults with
     40 pages and no tier, 40 pages and host_tier=128, and 160 pages
     (every prefix resident): prefill tokens computed, hit tokens,
     spilled and fetched pages, tier drops, fetch latency, TTFT p50 of
     the second round's wave-first requests and of all, tokens/s, peak
     memory, K3's launches; the tiered run's tokens must equal the
     resident run's, one page's spill and fetch must be bit-exact, and
     at fp32 (TF32 off) and depth 2 the three runs token-identical;
     (b) the same waves through DisaggPair(ff, tier_pages=128,
     num_pages=40): 32 handoffs, pages spilled and fetched, tokens
     beside (a)'s resident run (the bf16 share; fp32 depth 2
     identical), TTFT and tokens/s beside the monolithic server's (one
     card and one interpreter serve both workers: no gain); then the
     32 requests in seeded shuffled order through a PrefixAffinityRouter
     over two 40-page servers against a round-robin spread: hit tokens
     (the router's must be more); (c) phase 4's requests through an int8
     pool with no canary, kv_quant_canary=1 and FF_TPU_KV_QUANT_DEBUG=1:
     identical tokens, kv_quant_error under the catalog's 1e-2 band with
     no breach, windows, decode tick ms with a window open against none,
     the shadow pool's bytes, the int8 kernel once a layer and step and
     the fp kernel (bf16 q over the fp32 shadow) once a layer and shadow
     step; (d) phase 4's requests at 4 layers through the paged server
     with obs.enable() against without (and an SLO every request misses):
     identical tokens, decode tick ms and equal synchronizing calls a
     tick, the spans by name, the ledger's shape keys and stats, a
     request track, the Chrome trace loaded back, the breach bundle's
     trace tail; a torch.profiler capture (every thread) over 10 traced
     decode ticks whose decode_tick ranges enclose K3's split-kernel
     launches, a layer's each; fit under FFConfig(profiler_trace_dir=...)
     at bench_1b's widths, depth 2, batch 8 x 1024, 3 steps, whose trace
     names K1's and K2's kernels (the kernels line records K3's
     launches of (a)'s tiered run, (b)'s pair and (d)'s traced run under
     "tier_disagg_trace", its shadow launches of (c) under
     "canary_shadow", timed at phase 2's fp32-pool case, and the int8
     kernel's of (c) under "canary");
 21. checkpoints, data loaders, recompilation, the frontends and the
     examples, under a temporary directory removed at the end: (a) GPT-2
     124M's widths (vocab 50257, 768 wide, 12 layers of 12 heads, 1024
     positions, gelu_new, tied head; a GPT2LMHeadModel-shaped stand-in,
     no transformers on the card, its weights seeded) through
     import_hf_causal_lm at seq 1024, bf16 compute (fp32 from the
     position add: K4's fp32 bodies), copy_hf_weights and compile(Adam
     lr 1e-4), then fit over two FileDataLoaders of 16 batches of 8 x
     1024 (.npy files written from the seed) with checkpoint_every 8 and
     a RecompileState whose alter changes nothing firing once at step 4:
     K4's three kernels once a layer and step, each save's seconds and
     GB, the syncs a step under transfer_guard "log" against the same
     batches through fit(x, y) (equal, and equal weights bit for bit);
     restore_model(step_8) trained on batches 9-16 must end bit for bit
     on the writer's state; (b) restore_model(step_16) through
     serve_generation(paged=True), 4 greedy requests of 32 tokens (K3
     once a layer and ragged step), tokens equal to the writer's; (c)
     Llama-3-8B's widths (a LlamaForCausalLM-shaped stand-in, untied) at
     2 of its 32 layers (memory and time) through the HF importer: the
     weights copied (3 + 9 a layer), bf16 predict at seq 128 (K1 once a
     layer) against the port's fp32 path on the CPU over the same
     weights, within the hf-import-parity budgets, argmax agreeing on
     90% of rows; (d) every example of flexflow_tpu_torch/examples in
     this process, one epoch on the card; the resnet example's module
     through torch.fx at batch 64 against the module's own output on the
     card; the keras MNIST MLP (784-512-512-10), its loss falling; then
     K4 (fp32) at (a)'s attention shape, K1/K2 at (c)'s and K3 at (b)'s
     decode, timed (the kernels line records K4's launches of (a) under
     "gpt2_124m", K3's of (b) under "gpt2_124m_restored" and K1's of (c)
     under "llama3_8b_hf");
 22. the strategy search: (a) bench_1b (16 layers, bf16, batch 8 x
     1024, Adam lr 1e-4, remat none) compiled with search_budget=8,
     measure_costs (op shards timed through the lowerings on the card,
     mxu_efficiency fitted), validate_top_k=2 (the candidates' real
     train steps timed by CUDA events), the event simulator, a strategy
     file and a costed DOT export, from the weights of the same model
     compiled without the search; both fit 8 steps and the losses must
     agree within the catalog's bf16 band (hf-import-parity-atol); K1
     must launch in the measurement, the playoff and the fit, K2 in the
     playoff and the fit; (b) bench_1b's plain graph at batch 1 x 8192
     over {"seq": 4}, searched at budget 12 with validate_top_k=2: the
     pool must keep a ring candidate, which the playoff times through K5
     and K4's backward beside the unrewritten graph (and any Ulysses
     candidate); modeled ms price 4 H100s, timed ms this one card (not
     comparable); the winner fits 4 steps (its loss falls) and the ring
     candidate's initial loss holds to the unrewritten graph's (the
     kernels line records K1/K2's launches of (a) under "search_1b" and
     K5's and K4's backward's of (b) under "search_ring");
 23. the serving-strategy search: (a) Llama-3-8B's widths at 4 of its 32
     layers (P23_LAYERS), bf16, random weights from the seed, through
     serve_generation(paged=True, search_budget=64, traffic=the
     shared-system-prompt profile at page 64: a 128-token system prompt,
     16 requests of 64 new tokens, 8 offered at once), 8 slots, max_len
     256, priced on the H100 machine model: the search's seconds, the
     winner's knobs and its predicted TTFT p95 and seconds a token; the
     profile's sample through the winner and through ServeStrategy():
     measured TTFT p95, tokens/s and K3's fp and int8 launches beside
     the predictions (the winner's K3 body once a layer and ragged step);
     (b) fftrace's traced serve (plain, speculative, and decode and
     mixed megasteps of 2, 4, 8 and 16 ticks) of 8 of those
     requests on the card, `fftrace calibrate` (scales by tick shape,
     stamped with the card), the search again with the report (the
     winner and its predictions before and after), and `servesearch
     simulate`'s simulator on (a)'s winner request log, uncalibrated and
     calibrated, beside (a)'s measured TTFT p95, and the calibrated
     search's winner served as (a) serves; (c) fp32 with TF32 off,
     2 layers: ServingAutopilot.swap_to from page 16 / chunk 32 to chunk
     16 under continuous submits: nothing dropped, every stream equal to
     the one-tick loop's, at least one request carried, the pool
     adopted, the cutover ms; then the same swap in four fresh
     processes (`--swap-probe`: cold, warm, warm, cold), the
     successor's first tick and the stall after cutover with the warm-up
     off and on; after each part, K3 held to its plain
     version on the very inputs of that part's calls (the first, 8th,
     64th, ... call of each launch geometry: page size, pool dtype,
     window, batch), each geometry timed (the kernels line records K3's
     launches of (a) and of (b)'s calibrated winner under "servesearch",
     with those geometries' checks and times).
Each phase, and each part of phases 2 and 3, logs its wall seconds on a
`phase_time` line. The line before the last is the kernel list as JSON;
the last line is {"ok": true, "device": {...}}. Exits non-zero without
CUDA.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
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
    OpType,
    SGDOptimizer,
    obs,
)
from flexflow_tpu_torch.analysis import num_budgets
from flexflow_tpu_torch.disagg import DisaggPair, PrefixAffinityRouter
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
from flexflow_tpu_torch.model import carry_params
from flexflow_tpu_torch.models.bert import BertConfig, build_bert
from flexflow_tpu_torch.models.dlrm import build_dlrm
from flexflow_tpu_torch.models.gpt2 import GPT2Config, build_gpt2
from flexflow_tpu_torch.models.llama import LlamaConfig, build_llama
from flexflow_tpu_torch.models.mixtral import MixtralConfig, build_mixtral
from flexflow_tpu_torch.models.nmt import NMTConfig, build_nmt
from flexflow_tpu_torch.models.resnet import build_resnet50
from flexflow_tpu_torch.models.transformer import (
    TransformerConfig,
    build_transformer_encoder_decoder,
)
from flexflow_tpu_torch.ops import torch_ops
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
from flexflow_tpu_torch.runtime.executor import merge_state
from flexflow_tpu_torch.parallel.ring import ring_dot_product_attention
from flexflow_tpu_torch.obs import SLOTarget, load_jsonl
from flexflow_tpu_torch.obs.slo import percentile
from flexflow_tpu_torch.search import api as search_api
from flexflow_tpu_torch.search.substitution import structural_class
from flexflow_tpu_torch.serving import _GenRequest, http_serve, pick_tokens
from flexflow_tpu_torch.spec import SpecConfig
from flexflow_tpu_torch.spec.fixtures import make_token_cyclic
from flexflow_tpu_torch.spec.tree import ancestor_masks, build_tree

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
# phase 15: the speculation policy (max_nodes 9: the tree window phase 2
# times K3 at), the megastep width, the sampled runs' temperature, and
# the least tokens a request may emit per verify step on the
# token-cyclic fixture (the reference's contract, tests/test_spec.py:237)
SPEC_CONFIG = SpecConfig(width=2, depth=4)
# a speculation policy SpecConfig does not cap: its 65-node tree is a
# window whose q and acc rows no one block holds (phase 2's tree_w65)
WIDE_SPEC = SpecConfig(width=8, depth=8)
MEGASTEP_TICKS = 8
SAMPLE_TEMPERATURE = 0.8
ACCEPT_FLOOR = 1.5
# phases 15 and 16 serve Llama-3-8B's widths at 2 of its 32 layers (phase
# 4 serves all 32): each runs about a dozen serves of phase 4's traffic,
# and a decode tick's host time grows ~2 ms a layer, so at 32 layers the
# two took 350 of the default run's 1000 s, at 4 layers 97 s of 958 s
# with phase 22 (H100 80GB HBM3, 700 W)
MEGASTEP_LAYERS = 2


def llama3_8b_cut(layers: int) -> LlamaConfig:
    """Llama-3-8B's widths at `layers` of its 32 layers."""
    return dataclasses.replace(LlamaConfig.llama3_8b(), layers=layers)
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
# K4's fp32 backward past 2048 rows (name, B*H, S, T, D, causal): its
# 3xTF32 dq and dk/dv sum one head's products over every streamed row, so
# a longer sequence is a longer chain of tensor-core sums (errors only)
K4_LONG_FP32_CASES = [
    (f"fp32_s{S}_d{D}_{'causal' if c else 'full'}", 2, S, S, D, c)
    for S in (4096, 8192) for D in (64, 128) for c in (True, False)]
# K5 at phase 14's ring blocks (name, B*H, D), S = T = K5_S: a Llama at
# Phi-3-mini's widths (32 heads of 96) and one at OpenLLaMA-3B's (32 of
# 100; tiles filled by cp.async), batch 1 at s_loc = 8192 / 4
K5_RING_BLOCKS = [("phi3_mini_ring_step", 32, 96),
                  ("openllama_3b_ring_step", 32, 100)]
# K5 beyond the main shape (name, B*H, S, T, D, causal): the card test's
# head dims, S != T, S not a multiple of the tile, and the ring's s_loc
# 192 (phase 3) at the widths of phase 14
K5_CASES = [
    ("d48", 32, 512, 512, 48, True),
    ("d64", 32, 512, 512, 64, False),
    ("d80", 32, 512, 512, 80, True),
    ("d96", 32, 512, 512, 96, False),
    ("d100", 32, 512, 512, 100, True),
    ("d128", 32, 512, 512, 128, False),
    ("d256", 16, 512, 512, 256, True),
    ("d64_s1000_t1536", 16, 1000, 1536, 64, False),
    ("d128_s777_t300", 16, 777, 300, 128, True),
    ("d100_s777_t300", 16, 777, 300, 100, False),
    ("d100_s1000_t1536", 16, 1000, 1536, 100, True),
    ("d96_s192", 32, 192, 192, 96, True),
    ("d100_s192", 32, 192, 192, 100, True),
]
# the K5_CASES also timed: the padded widths no phase trains through
K5_TIMED_CASES = ("d48", "d80")
# K1/K2 at phase 17a's attention: Mixtral-8x7B's widths (32 heads over 8
# of 128) at batch 2, S = T 2048, causal
MIXTRAL_FLASH_SHAPE = (2, 2048, 32, 8, 128)
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
    # the 3xTF32 dq and dk/dv past 2048 rows: each sums a GQA group's
    # products over every streamed row (K2's fp32 is the point; bf16 rides)
    ("heads_s4096_gqa2_causal", (1, 4096, 4, 2, 128), None, True),
    ("heads_s4096_gqa2_full", (1, 4096, 4, 2, 128), None, False),
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
# phase 14's second model: OpenLLaMA-3B's widths through the same ring at
# depth 2, so that K5's cp.async-loaded body (D 100) runs on a model path
# and the phase stays short
RING_OPENLLAMA_LAYERS = 2
GPT2_POSITIONS = 1024  # n_positions: the position table, serving's max_len
GPT2_BATCHES = 10
# phase 8's timed step (1-based) whose loss jumps in every run, and the
# card-vs-CPU gradient check of it: each leaf's gradient in norm, fp32
# with TF32 off, summation order only over 48 layers. It takes the first
# GPT2_CHECK_SEQ tokens of the step's first sequence: the CPU's side of
# all 1024 took 62-74 s of the run, and its time on a shared host varies
GPT2_CHECK_STEP, GPT2_GRAD_RTOL, GPT2_CHECK_SEQ = 8, 1e-3, 256
# phase 9's traffic: 8 prompts uniform in 128..768 tokens, 64 new each
GPT2_PROMPTS, GPT2_PROMPT_MIN, GPT2_PROMPT_MAX, GPT2_NEW = 8, 128, 768, 64


def llama_200m() -> LlamaConfig:
    """bench.py's 200m profile, built inline as bench.py:56-58 builds it
    (no constructor of its own): vocab 32000, dim 1024, 12 layers, 16
    heads over 8 kv heads (head dim 64: the head-major route, K4), FFN
    2816."""
    return LlamaConfig(vocab_size=32000, dim=1024, layers=12, heads=16,
                       kv_heads=8, hidden=2816)


# phase 12: Phi-3-mini's 32 layers cut to 16 (fp32 masters, gradients and
# Adam's two moments of the whole depth do not fit one 80 GB card)
PHI3_LAYERS = 16


def phi3_mini() -> LlamaConfig:
    """microsoft/Phi-3-mini-4k-instruct config.json's widths, built inline
    (no constructor of its own): vocab 32064, hidden 3072, 32 heads and 32
    kv heads (head dim 96: the head-major route, K4), intermediate 8192,
    rope_theta 10000, rms_norm_eps 1e-5; PHI3_LAYERS of its 32 layers.
    Its sliding window (2047) does not bind at seq 1024, where plain
    causal attention is its exact mask."""
    return LlamaConfig(vocab_size=32064, dim=3072, layers=PHI3_LAYERS,
                       heads=32, kv_heads=32, hidden=8192,
                       rope_theta=10000.0, norm_eps=1e-5)


# phase 13: OpenLLaMA-3B's 26 layers cut to 16 (fp32 masters, gradients
# and Adam's two moments of the whole depth, with the activations of a
# batch of 8 x 1024, do not fit one 80 GB card)
OPENLLAMA_LAYERS = 16


def open_llama_3b() -> LlamaConfig:
    """openlm-research/open_llama_3b config.json's widths, built inline (no
    constructor of its own): vocab 32000, hidden 3200, 32 heads and 32 kv
    heads (head dim 100: the head-major route, K4, whose 200-byte rows
    its tensor-core bodies load by cp.async), intermediate 8640,
    rope_theta 10000, rms_norm_eps 1e-6, untied embeddings (build_llama's
    lm_head is its own); OPENLLAMA_LAYERS of its 26 layers."""
    return LlamaConfig(vocab_size=32000, dim=3200, layers=OPENLLAMA_LAYERS,
                       heads=32, kv_heads=32, hidden=8640,
                       rope_theta=10000.0, norm_eps=1e-6)


def gpt2_xl() -> GPT2Config:
    """openai-community/gpt2-xl config.json: vocab 50257, n_embd 1600,
    n_layer 48, n_head 25 (head dim 64), n_inner null (4 x 1600),
    layer_norm_epsilon 1e-5, gelu_new (= tanh-GELU)."""
    return GPT2Config(vocab_size=50257, dim=1600, layers=48, heads=25,
                      inner=0, ln_eps=1e-5)


def log(msg: str):
    print(msg, flush=True)


def timed(phase: str, fn, *args, **kw):
    """Runs fn(*args, **kw) and logs its wall seconds under `phase`."""
    t0 = time.monotonic()
    out = fn(*args, **kw)
    secs = time.monotonic() - t0
    log(f"phase_time {json.dumps({'phase': phase, 'seconds': secs})}")
    return out


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0] if out else ""


# every tensor-core instantiation the sources build: K1/K2's bodies under
# the FlatLayout tag, forward, dq and dk/dv, at head dims 64, 128 and 256;
# K4's under HeadMajor and K5's forward under HeadMajorCarry at those and
# at 48, 80, 96 and 100 (tiles zero-padded to 64 / 128 columns; D 100's
# filled by cp.async)
WGMMA_KERNELS = tuple(
    f"flash_{k}_wgmma_kernel<{tag},{d}>"
    for tag, dims in (("FlatLayout", (64, 128, 256)),
                      ("HeadMajor", (48, 64, 80, 96, 100, 128, 256)))
    for k in ("fwd", "dq", "dkv") for d in dims) + tuple(
    f"flash_fwd_wgmma_kernel<HeadMajorCarry,{d}>"
    for d in (48, 64, 80, 96, 100, 128, 256))


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


def ptxas_report() -> dict:
    """{tensor-core kernel: {"registers", "spill_stores", "spill_loads"}}
    from ptxas -v in this process's build of the four flash sources
    (each kernel's `build_log`; a source built before this process is not
    reported). Raises if one of them spills (the consumers' accumulators
    and the producer's 40 registers after setmaxnreg must fit) or, when
    all four were built, one of WGMMA_KERNELS is missing."""
    report, built = {}, 0
    for kern in (FLASH_ATTENTION_FWD, FLASH_ATTENTION_DQ,
                 FLASH_ATTENTION_BH_FWD, FLASH_ATTENTION_BH_DQ):
        log = kern.build_log
        if log is None:
            continue
        built += 1
        name = None
        for line in log.splitlines():
            if "Compiling entry function" in line \
                    or "Function properties for" in line:
                name = wgmma_name(line)
                if name:
                    report.setdefault(name, {})
            elif name and "spill stores" in line:
                st, ld = re.findall(r"(\d+) bytes spill (?:stores|loads)",
                                    line)
                report[name].update(spill_stores=int(st),
                                    spill_loads=int(ld))
            elif name and "registers" in line:
                report[name]["registers"] = int(
                    re.search(r"Used (\d+) registers", line)[1])
    if not built:
        return {"not built in this run": True}
    spilled = {n: r for n, r in report.items()
               if r.get("spill_stores") or r.get("spill_loads")}
    found = {",".join(n.split(",")[:2]) + ">" for n in report}
    if (built == 4 and set(WGMMA_KERNELS) - found) or spilled:
        raise AssertionError(f"tensor-core kernels missing from ptxas's "
                             f"report or spilling: {spilled or report}")
    return report


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


def spec_trees() -> list:
    """Two draft trees of phase 15's SpecConfig(width=2, depth=4) window
    (max_nodes 9) from build_tree: three chains sharing prefixes that fill
    all 9 nodes, and one chain of 2 (3 live nodes, 6 padding); then
    WIDE_SPEC's full tree, 8 chains of 8 distinct tokens (65 nodes)."""
    return [build_tree(5, [np.array([1, 2, 3, 4]), np.array([1, 2, 7, 8]),
                           np.array([6, 9])], SPEC_CONFIG.max_nodes),
            build_tree(3, [np.array([4, 5])], SPEC_CONFIG.max_nodes),
            build_tree(7, [np.arange(8) + 10 * w + 1 for w in range(8)],
                       WIDE_SPEC.max_nodes)]


def attention_case(window: int, kinds, dtype, seed: int, fixed_pos=None,
                   heads=(H, HKV, D), page: int = P):
    """Inputs of one ragged attention call at the serving path's shapes
    (`heads` = (H, Hkv, D), Llama-3-8B's by default): one entry per kind
    ("decode" q_len 1, "chunk:N" q_len N, "tree:i" spec_trees()[i] as the
    speculative server launches it: q_len its live nodes under its
    ancestor mask, "pad"), positions `fixed_pos` or random up to ~2000,
    distinct random pages per entry. Pages of `page` rows, a table as
    many rows long as MAXP pages of P rows."""
    nh, nkv, hd = heads
    maxp = MAXP * P // page
    num_pages = (NUM_PAGES - 1) * P // page + 1
    rs = np.random.RandomState(seed)
    B = len(kinds)
    pos = np.zeros(B, np.int32)
    qls = np.zeros(B, np.int32)
    anc = np.zeros((B, window, window), bool)
    for b, kind in enumerate(kinds):
        if kind == "pad":
            continue
        if kind.startswith("tree:"):
            tree = spec_trees()[int(kind[5:])]
            qls[b] = tree.n_nodes
            pos[b] = rs.randint(1, maxp * page - window)
            anc[b] = ancestor_masks(tree.parents[None])[0]
            continue
        n = 1 if kind == "decode" else int(kind.split(":")[1])
        qls[b] = n
        pos[b] = (fixed_pos if fixed_pos is not None
                  else rs.randint(1, maxp * page - max(48, window)))
        anc[b, :n, :n] = np.tril(np.ones((n, n), bool))
    pt = (rs.permutation(num_pages - 1)[:B * maxp] + 1).reshape(B, maxp)
    dev = DEVICE
    q = torch.from_numpy(rs.standard_normal((B, window, nh, hd))
                         .astype(np.float32)).to(dev, dtype)
    kc = torch.from_numpy(rs.standard_normal((num_pages, page, nkv, hd))
                          .astype(np.float32)).to(dev, dtype)
    vc = torch.from_numpy(rs.standard_normal((num_pages, page, nkv, hd))
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
    page, nkv = kc.shape[1], kc.shape[2]
    isz, kv_isz = q.element_size(), kc.element_size()
    horizon = (pos.long() + qls.long()) * (qls > 0).long()
    kv_rows = int(horizon.sum())
    nbytes = (2 * q.numel() * isz + 2 * kv_rows * nkv * hd * kv_isz
              + pt.numel() * 4 + pos.numel() * 4 + qls.numel() * 4
              + anc.numel())
    if quantized:
        nbytes += 2 * int(((horizon + page - 1) // page).sum()) * nkv * 4
    vis = ragged_visibility_mask(pt, pos, qls, anc, page)
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
    mask = ragged_visibility_mask(pt, pos, qls, anc, kc.shape[1])[:, None]
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
    # the speculative verify launch at phase 15's tree window: two real
    # draft trees, twice each, at varied positions
    ("tree_w9", 9, ["tree:0", "tree:1", "tree:0", "tree:1"], None),
]
# the fp kernel's pages per split timed at the kernel line's case (bf16
# and fp32 q) beside the plan's choice (ragged_split_plan)
SPLIT_SWEEP = (1, 2, 4, 8, MAXP)
# GPT-2 XL serving's steady decode launch: 25 heads of 64, no GQA; its
# 1024-row position table caps pos
GPT2_ATTENTION_CASE = ("gpt2_xl_decode_b4_pos960", 1, ["decode"] * 4, 960)
GPT2_HEADS = (25, 25, 64)


def k3_case(case, heads, dtype, seed: int, card: str) -> dict:
    """The fp-pool ragged kernel against its plain version at one case
    (name, window, entry kinds, fixed position) and `heads` = (H, Hkv, D):
    error, kernel / plain / SDPA times, the bound; raises on a
    difference past TOLS or a non-zero tail."""
    name, window, kinds, fixed = case
    scale = 1.0 / heads[2] ** 0.5
    args = attention_case(window, kinds, dtype, seed=seed, fixed_pos=fixed,
                          heads=heads)
    got = ragged_flash_attention(*args, scale=scale)
    want = ragged_gather_attention(*args, scale=scale)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs()
    atol, rtol = TOLS[dtype]
    ok = bool((err <= atol + rtol * want.float().abs()).all())
    zero_tail = all(not got[b, int(args[5][b]):].any()
                    for b in range(len(kinds)))
    bound_ms, bound_by, nbytes, ops = attention_bound(args)
    plan = ragged_split_plan(len(kinds), window, heads[0], heads[1], P,
                             MAXP, torch.cuda.get_device_properties(
                                 0).multi_processor_count)
    res = {
        "case": name, "dtype": str(dtype).replace("torch.", ""),
        "heads": list(heads), "window": window, "kinds": kinds,
        "split_plan": list(plan),
        "pos": args[4].tolist(), "q_lens": args[5].tolist(),
        "max_abs_err": float(err.max()), "atol": atol, "rtol": rtol,
        "ms": time_ms(lambda: ragged_flash_attention(*args, scale=scale)),
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
    return res


def phase_kernels(card: str) -> list:
    """The fp-pool ragged kernel against its plain version at Llama-3-8B's
    serving cases and GPT-2 XL's decode case, bf16 and fp32 q."""
    cases = [(c, (H, HKV, D)) for c in ATTENTION_CASES] + [
        (GPT2_ATTENTION_CASE, GPT2_HEADS)]
    return [k3_case(case, heads, dtype, i, card)
            for dtype in (torch.bfloat16, torch.float32)
            for i, (case, heads) in enumerate(cases)]


def split_sweep(card: str, case: int = 0) -> dict:
    """The split kernels at ATTENTION_CASES[case] (the kernel line's by
    default) with each SPLIT_SWEEP pages per split beside the plan's,
    bf16 and fp32 q, over the fp pool and over its int8 pages (keys
    "int8_<q dtype>"): every result held to the plain version (TOLS;
    INT8_TOLS) and timed. The times show the plan's choice against its
    neighbours."""
    name, window, kinds, fixed = ATTENTION_CASES[case]
    scale = 1.0 / D ** 0.5
    plan = ragged_split_plan(len(kinds), window, H, HKV, P, MAXP,
                             torch.cuda.get_device_properties(0)
                             .multi_processor_count)
    res = {"case": name, "plan_pages_per_split": plan.pages_per_split,
           "card": card}
    q, kc, vc, pt, pos, qls, anc = attention_case(
        window, kinds, torch.float32, seed=case, fixed_pos=fixed)
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


# K3 at the windows the unpacked prefill (ragged_pack=False) launches, one
# entry at _bucket(take) rows (a 13-token chunk: 16; the default 64-token
# chunk: 64), and at WIDE_SPEC's 65-node tree: windows whose rep x S q and
# acc rows do not fit one block beside the K/V sub-tiles (64 and 65 at
# rep 4, D 128), which the kernel cuts into row tiles
WIDE_CASES = [
    ("unpacked_chunk13_w16", 16, ["chunk:13"], None),
    ("unpacked_chunk64_w64", 64, ["chunk:64"], None),
    ("tree_w65", 65, ["tree:2"], None),
]


def wide_window_case(case, dtype, pool: str, card: str,
                     seed: int = None) -> dict:
    """One WIDE_CASES entry (or any ATTENTION_CASES-style case) with q in
    `dtype` over an fp pool of q's dtype or over its int8 pages: held to
    the plain version and timed (_kernel_check) beside SDPA (fp pool) or
    SDPA over the pages pre-dequantized to bf16 (int8 pool, a yardstick
    only), with the split plan (ragged_split_plan) it ran under."""
    name, window, kinds, fixed = case
    scale = 1.0 / D ** 0.5
    if seed is None:
        seed = 100 + [c[0] for c in WIDE_CASES].index(name)
    q, kc, vc, pt, pos, qls, anc = attention_case(
        window, kinds, torch.float32, seed=seed, fixed_pos=fixed)
    plan = ragged_split_plan(len(kinds), window, H, HKV, P, MAXP,
                             torch.cuda.get_device_properties(0)
                             .multi_processor_count)
    extra = {"window": window, "kinds": kinds, "split_plan": list(plan)}
    if pool == "int8":
        kq, ks, vq, vs = int8_pools(kc, vc)
        deq = [dequantize_pages(p, s).bfloat16()
               for p, s in ((kq, ks), (vq, vs))]
        extra.update(library_ms=None, sdpa_bf16_predequantized_ms=time_ms(
            library_call((q.bfloat16(), *deq, pt, pos, qls, anc), scale)))
        del deq
        return _kernel_check(name, dtype, INT8_TOLS[dtype],
                             (q.to(dtype), kq, vq, pt, pos, qls, anc),
                             {"k_scales": ks, "v_scales": vs}, scale, card,
                             extra)
    args = (q.to(dtype), kc.to(dtype), vc.to(dtype), pt, pos, qls, anc)
    extra["library_ms"] = time_ms(library_call(args, scale))
    return _kernel_check(name, dtype, TOLS[dtype][0], args, {}, scale, card,
                         extra)


def phase_wide_windows(card: str) -> list:
    """Every WIDE_CASES entry, bf16 and fp32 q, fp and int8 pools."""
    out = [wide_window_case(c, dtype, pool, card) for c in WIDE_CASES
           for dtype in (torch.bfloat16, torch.float32)
           for pool in ("fp", "int8")]
    torch.cuda.empty_cache()
    return out


# K3 at the page sizes the serving-strategy search offers
# (search.servesearch.default_space) besides phase 2's P: at 8, 16 and 32
# rows several pages share one 64-row key sub-tile, at 128 one page spans
# two (and an int8 page's one scale covers both); each at the steady
# decode launch, the mixed megastep's window and the tree verify's
PAGE_SIZES = (8, 16, 32, 128)
PAGE_SIZE_CASES = ("decode_b4_pos1024", "mixed_w8", "tree_w9")


def phase_page_sizes(card: str) -> list:
    """Every PAGE_SIZE_CASES case at every PAGE_SIZES page, bf16 q, over a
    bf16 pool and over its int8 pages, held to the plain version and
    timed (_kernel_check) with the split plan it ran under."""
    scale = 1.0 / D ** 0.5
    sm = torch.cuda.get_device_properties(0).multi_processor_count
    out = []
    for page in PAGE_SIZES:
        for i, (name, window, kinds, fixed) in enumerate(ATTENTION_CASES):
            if name not in PAGE_SIZE_CASES:
                continue
            q, kc, vc, pt, pos, qls, anc = attention_case(
                window, kinds, torch.float32, seed=i, fixed_pos=fixed,
                page=page)
            extra = {"page_size": page, "window": window, "kinds": kinds,
                     "split_plan": list(ragged_split_plan(
                         len(kinds), window, H, HKV, page, pt.shape[1], sm))}
            args = (q.bfloat16(), kc.bfloat16(), vc.bfloat16(), pt, pos,
                    qls, anc)
            out.append(_kernel_check(
                f"{name}_page{page}", torch.bfloat16,
                TOLS[torch.bfloat16][0], args, {}, scale, card,
                dict(extra, library_ms=time_ms(library_call(args, scale)))))
            kq, ks, vq, vs = int8_pools(kc, vc)
            out.append(_kernel_check(
                f"{name}_page{page}", torch.bfloat16,
                INT8_TOLS[torch.bfloat16], (args[0], kq, vq, *args[3:]),
                {"k_scales": ks, "v_scales": vs}, scale, card,
                dict(extra, library_ms=None)))
            del q, kc, vc, args, kq, vq
    torch.cuda.empty_cache()
    return out


def int8_pools(kc, vc):
    """(k pages, k scales, v pages, v scales): the int8 pool the port's own
    quantize-on-append writes for the seeded fp rows, one page a call."""
    N, rows = kc.shape[:2]
    out = []
    for x in (kc, vc):
        pool = torch.zeros(x.shape, dtype=torch.int8, device=x.device)
        scales = torch.zeros((N, HKV), device=x.device)
        off = torch.arange(rows, device=x.device)[None]
        live = torch.ones((1, rows), dtype=torch.bool, device=x.device)
        for page in range(N):
            quantized_append(pool, scales, x[page][None],
                             torch.full_like(off, page), off, live)
        out += [pool, scales]
    return out


def _kernel_check(name, dtype, tol, args, sc, scale, card, extra,
                  time_it: bool = True):
    """Launch the wrapper once, hold it to the plain version (max |err|
    <= tol * max(1, max |plain|), rows past q_len exact zeros), and time
    kernel and plain version (unless not `time_it`) beside the bound."""
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
        "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
        "ops": ops, "card": card, **extra,
    }
    if time_it:
        res["ms"] = time_ms(lambda: ragged_flash_attention(
            *args, scale=scale, **sc))
        res["plain_ms"] = time_ms(lambda: ragged_gather_attention(
            *args, scale=scale, **sc))
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
    (the mixed-dtype route) and over an fp32 pool under bf16 q (the
    kv_quant_canary's shadow launch). No single PyTorch call dequantizes and
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
    # the kv_quant_canary's shadow launch: bf16 q over the fp32 shadow
    # pool, at the decode launch's shape (phase 20c), its bound the fp32
    # pool's bytes; SDPA in bf16 over the pages cast to bf16 beside it
    q, kc, vc, pt, pos, qls, anc = attention_case(
        window, kinds, torch.float32, seed=0, fixed_pos=fixed)
    qb = q.bfloat16()
    args = (qb, kc, vc, pt, pos, qls, anc)
    results.append(_kernel_check(
        name + "_fp32_pool", torch.bfloat16, TOLS[torch.bfloat16][0], args,
        {}, scale, card,
        {"window": window, "kinds": kinds,
         "library_ms": time_ms(library_call(
             (qb, kc.bfloat16(), vc.bfloat16(), pt, pos, qls, anc), scale)),
         "library": "SDPA in bf16 over the pages cast to bf16"}))
    del q, kc, vc, args
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


def planted_carry_fault_check(BH, S, D, dtype, seed, rows=128, keys=128,
                              carried=False, device=None) -> dict:
    """The same planted fault applied to K5: the plain fold of seeded
    (BH, S, D) q, k, v, causal (the ring's diagonal block), into the
    initial statistics or, with `carried`, into those of a full fold of
    another block, with the first `keys` keys left out of the last `rows`
    query rows (keys <= S - rows): those rows fold keys keys .. S - rows
    - 1 (all visible to them) and then their own diagonal square. Returns
    the verdicts on m, l and acc and whether `_err_ok` rejects the fold
    (it must)."""
    device = device or DEVICE
    scale = 1.0 / D ** 0.5
    g = torch.Generator(device=device).manual_seed(seed)
    q, k, v, k0, v0 = (torch.randn(BH, S, D, generator=g, device=device)
                       .to(dtype) for _ in range(5))
    stats = (torch.full((BH, S), -1e30, device=device),
             torch.zeros(BH, S, device=device),
             torch.zeros(BH, S, D, device=device))
    if carried:
        stats = flash_bh_fwd_carry_reference(q, k0, v0, *stats, False, scale)
    want = flash_bh_fwd_carry_reference(q, k, v, *stats, True, scale)
    late, rest, diag = (slice(S - rows, S), slice(keys, S - rows),
                        slice(S - rows, S))
    part = flash_bh_fwd_carry_reference(
        q[:, late], k[:, rest], v[:, rest], *(t[:, late] for t in stats),
        False, scale)
    part = flash_bh_fwd_carry_reference(q[:, late], k[:, diag], v[:, diag],
                                        *part, True, scale)
    bad = [t.clone() for t in want]
    for b, p in zip(bad, part):
        b[:, late] = p
    tol = FLASH_TOLS[dtype][0]
    return {
        "shape": [BH, S, D], "dtype": str(dtype).replace("torch.", ""),
        "rows": rows, "keys": keys, "carried": carried,
        **{name: _err_parts(b, w, tol)
           for name, b, w in zip(("m", "l", "acc"), bad, want)},
        "rejected": not _err_ok(list(zip(bad, want)), tol)[1]}


def phase_k4_kernels(card: str) -> dict:
    """K4 at GPT-2 XL's shape (bf16 and fp32, timed), at phase 11's
    (bench.py's 200m Llama: B*H 8*16, S = T 1024, D 64, causal; bf16,
    timed: the kernels line's case), at phase 12's (Phi-3-mini: B*H
    8*32, S = T 1024, D 96, causal; bf16, timed) and at phase 13's
    (OpenLLaMA-3B: B*H 8*32, S = T 1024, D 100, causal; bf16, timed: the
    cp.async-loaded bodies), then at every case of
    K4_CASES in both dtypes (errors and times: the wgmma bodies at D 48..
    256 in bf16, the fp32 3xTF32 ones at 64..256, the CUDA-core bodies
    at the rest), then K4_LONG_FP32_CASES (errors), then the planted
    fault (the checks must reject a skipped key tile at GPT-2 XL's
    shape, bf16 and fp32, and at OpenLLaMA-3B's, bf16), then the
    K1-vs-K4 record. Fails on any error
    over its tolerance. Returns {"main": {dtype name: {kernel: result}},
    "timed": {case: {kernel: result}}, "cases": [...], "long_fp32":
    [...], "planted_fault": {case: {...}}, "k1_vs_k4_d64":
    {...}}."""
    main, timed, cases, long_fp32 = {}, {}, [], []
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
    cfg = phi3_mini()
    res = k4_check(TRAIN_BATCH * cfg.heads, TRAIN_SEQ, TRAIN_SEQ,
                   cfg.dim // cfg.heads, True, torch.bfloat16, 3,
                   timed=True)
    for r in res.values():
        r.update(case="phi3_mini_causal", card=card)
        log(f"kernel {json.dumps(r)}")
    timed["phi3_mini_causal"] = res
    cfg = open_llama_3b()
    res = k4_check(TRAIN_BATCH * cfg.heads, TRAIN_SEQ, TRAIN_SEQ,
                   cfg.dim // cfg.heads, True, torch.bfloat16, 4,
                   timed=True)
    for r in res.values():
        r.update(case="openllama_3b_causal", card=card)
        log(f"kernel {json.dumps(r)}")
    timed["openllama_3b_causal"] = res
    torch.cuda.empty_cache()
    for i, (name, BH, S, T, D, causal) in enumerate(K4_CASES):
        for dtype in (torch.bfloat16, torch.float32):
            res = k4_check(BH, S, T, D, causal, dtype, 100 + i, timed=True)
            for r in res.values():
                r.update(case=name, card=card)
                log(f"kernel {json.dumps(r)}")
                cases.append(r)
            timed[f"{name}_{str(dtype).replace('torch.', '')}"] = res
        torch.cuda.empty_cache()
    for i, (name, BH, S, T, D, causal) in enumerate(K4_LONG_FP32_CASES):
        res = k4_check(BH, S, T, D, causal, torch.float32, 300 + i)
        for r in res.values():
            r.update(case=name, card=card)
            log(f"kernel {json.dumps(r)}")
            long_fp32.append(r)
        torch.cuda.empty_cache()
    bad = [r for d in main.values() for r in d.values() if not r["ok"]]
    bad += [r for d in timed.values() for r in d.values() if not r["ok"]]
    bad += [r for r in long_fp32 if not r["ok"]]
    if bad:
        raise AssertionError(f"K4 kernels disagree with their plain "
                             f"versions: {bad}")
    # bf16 for the wgmma bodies, fp32 for the 3xTF32 ones, and bf16 at
    # OpenLLaMA-3B's head dim 100 for the cp.async-loaded bodies
    fault = {}
    cfg = open_llama_3b()
    for key, (BH, D), dtype in (
            ("bfloat16", (KB * KH, KD), torch.bfloat16),
            ("float32", (KB * KH, KD), torch.float32),
            ("bfloat16_d100", (TRAIN_BATCH * cfg.heads,
                               cfg.dim // cfg.heads), torch.bfloat16)):
        f = planted_fault_check(BH, KS, D, dtype, 12)
        log(f"planted_fault {json.dumps(f)}")
        if not all(f["rejected"].values()):
            raise AssertionError(f"the flash checks pass a skipped key "
                                 f"tile: {f}")
        fault[key] = f
        torch.cuda.empty_cache()
    cmp = k1_vs_k4_d64()
    cmp["card"] = card
    log(f"k1_vs_k4_d64 {json.dumps(cmp)}")
    torch.cuda.empty_cache()
    return {"main": main, "timed": timed, "cases": cases,
            "long_fp32": long_fp32, "planted_fault": fault,
            "k1_vs_k4_d64": cmp}


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
    timed), at phase 14's (K5_RING_BLOCKS: bf16, full and causal,
    timed), then at every case of K5_CASES in both dtypes (errors only;
    K5_TIMED_CASES timed too),
    then the planted fault (the checks must reject a skipped key tile in
    a fold at each of phase 14's blocks, from the initial and from a
    carried state). Fails on any error over its tolerance. Returns
    {"main": {"<dtype>_<full|causal>": result}, "timed": {"<block>_<full|
    causal>": result}, "cases": [...], "planted_fault": {...}}."""
    main, timed, cases, fault = {}, {}, [], {}
    for seed, dtype in enumerate((torch.bfloat16, torch.float32)):
        for causal in (False, True):
            r = k5_check(K5_BH, K5_S, K5_S, K5_D, causal, dtype, seed,
                         timed=True)
            mode = "causal" if causal else "full"
            r.update(case=f"bench_1b_ring_step_{mode}", card=card)
            log(f"kernel {json.dumps(r)}")
            main[f"{r['dtype']}_{mode}"] = r
        torch.cuda.empty_cache()
    for i, (name, BH, D) in enumerate(K5_RING_BLOCKS):
        for causal in (False, True):
            r = k5_check(BH, K5_S, K5_S, D, causal, torch.bfloat16, 10 + i,
                         timed=True)
            r.update(case=f"{name}_{'causal' if causal else 'full'}",
                     card=card)
            log(f"kernel {json.dumps(r)}")
            timed[r["case"]] = r
        torch.cuda.empty_cache()
    for i, (name, BH, S, T, D, causal) in enumerate(K5_CASES):
        for dtype in (torch.bfloat16, torch.float32):
            r = k5_check(BH, S, T, D, causal, dtype, 200 + i,
                         timed=name in K5_TIMED_CASES)
            r["case"] = name
            log(f"kernel {json.dumps(r)}")
            cases.append(r)
    bad = [r for r in list(main.values()) + list(timed.values()) + cases
           if not r["ok"]]
    if bad:
        raise AssertionError(f"K5 disagrees with its plain version: {bad}")
    for name, BH, D in K5_RING_BLOCKS:
        for carried in (False, True):
            f = planted_carry_fault_check(BH, K5_S, D, torch.bfloat16, 12,
                                          carried=carried)
            log(f"planted_fault {json.dumps(f)}")
            if not f["rejected"]:
                raise AssertionError(f"the K5 checks pass a skipped key "
                                     f"tile: {f}")
            fault[f"{name}_{'carried' if carried else 'fresh'}"] = f
            torch.cuda.empty_cache()
    return {"main": main, "timed": timed, "cases": cases,
            "planted_fault": fault}


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
                 params=None, mesh_shape=None,
                 use_pipeline=False) -> FFModel:
    """build_llama, build_gpt2 or build_mixtral (by the config's type) ->
    compile(Adam
    lr 1e-4, sparse CE, accuracy and sparse-CE metrics), the training
    path's entry points. With a `mesh_shape` the Llama is built with ring
    attention over its `seq` axis, with `use_pipeline` as one PIPELINE
    composite."""
    ff = FFModel(FFConfig(batch_size=batch, seed=seed, device=device,
                          remat=remat, mesh_shape=mesh_shape))
    if isinstance(cfg, GPT2Config):
        build_gpt2(ff, cfg, batch_size=batch, seq_len=seq, dtype=dtype)
    elif isinstance(cfg, MixtralConfig):
        build_mixtral(ff, cfg, batch_size=batch, seq_len=seq, dtype=dtype)
    else:
        build_llama(ff, cfg, batch_size=batch, seq_len=seq, dtype=dtype,
                    use_ring_attention=mesh_shape is not None,
                    use_pipeline=use_pipeline)
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


class RouteRecorder:
    """Records every EXPERTS sort plan while it is entered
    (torch_ops.sorted_dispatch, the module attribute the lowering calls,
    wrapped): each call's (t, k) top-k expert ids, its slots, the expert
    count and the capacity, the tensors kept on their device with no read
    back."""

    def __enter__(self):
        self.calls = []
        self._real = torch_ops.sorted_dispatch

        def record(topi, n, cap):
            slot, kept = self._real(topi, n, cap)
            self.calls.append((topi, slot, n, cap))
            return slot, kept

        torch_ops.sorted_dispatch = record
        return self

    def __exit__(self, *exc):
        torch_ops.sorted_dispatch = self._real

    def dropped(self, calls=None) -> int:
        """(row, choice) pairs that found their expert full."""
        return int(sum(int((slot == n * cap).sum())
                       for _, slot, n, cap in (calls or self.calls)))


def route_report(calls_both) -> dict:
    """The expert assignment of each EXPERTS call of a card run and of the
    same run on the CPU after it (the first half of `calls_both`, then
    the second): rows routed to each expert (both choices), pairs
    dropped, and whether the choices and slots agree. Raises, before any
    value is compared, when they do not."""
    half = len(calls_both) // 2
    card_calls, cpu_calls = calls_both[:half], calls_both[half:]
    calls = []
    for (ti, ts, n, cap), (ci, cs, _, _) in zip(card_calls, cpu_calls):
        ti, ts = ti.cpu(), ts.cpu()
        cut = n * cap
        calls.append({
            "rows": ti.shape[0], "capacity": cap,
            "card_per_expert": torch.bincount(ti.reshape(-1),
                                              minlength=n).tolist(),
            "cpu_per_expert": torch.bincount(ci.reshape(-1),
                                             minlength=n).tolist(),
            "card_dropped": int((ts == cut).sum()),
            "cpu_dropped": int((cs == cut).sum()),
            "choices_differ": int((ti != ci).sum()),
            "slots_differ": int((ts != cs).sum())})
    res = {"calls": calls, "same": 2 * half == len(calls_both) and all(
        c["choices_differ"] == 0 and c["slots_differ"] == 0 for c in calls)}
    log(f"routes {json.dumps(res)}")
    if not res["same"]:
        raise AssertionError("the card routes tokens to other experts than "
                             f"the CPU: {res}")
    return res


# the Zipf exponent of the MoE phases' token ids: text's token
# frequencies fall off as a power of their rank. Uniformly random ids
# route evenly (every expert near k * t / n rows), so capacity would
# rarely bind at alpha 1.25; a text-like skew makes the drop path run
ZIPF_A = 1.2


def zipf_tokens(n: int, seq: int, vocab: int, seed: int):
    """n sequences of token ids whose frequencies follow Zipf's law
    (ZIPF_A), ranks mapped onto a seeded permutation of the vocabulary;
    labels the next token."""
    rs = np.random.RandomState(seed)
    ranks = np.minimum(rs.zipf(ZIPF_A, (n, seq)), vocab) - 1
    x = rs.permutation(vocab)[ranks].astype(np.int32)
    return x, np.roll(x, -1, axis=1).astype(np.int32)


def mixtral_8x7b(layers: int = None) -> MixtralConfig:
    cfg = MixtralConfig.mixtral_8x7b()
    return dataclasses.replace(cfg, layers=layers or cfg.layers)


def phase_mixtral_step(seed: int) -> dict:
    """Two packed ragged steps at Mixtral-8x7B widths, depth 2, fp32 with
    TF32 off, over an fp pool, card against CPU on the same seeded
    weights (phase_step's): the expert assignment of both sides
    (route_report), then the probabilities to STEP_RTOL/ATOL. Each step
    routes all 24 rows of its window, the pad entry's too."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = mixtral_8x7b(2)

    def make(device, params=None):
        ff = FFModel(FFConfig(batch_size=1, seed=seed, device=device))
        build_mixtral(ff, cfg, batch_size=1, seq_len=8, dtype=DataType.FLOAT)
        return ff.compile(params=params)

    with RouteRecorder() as routes:
        gpu, cpu = _ragged_steps(make, cfg.vocab_size, (None,))
    res = {"routes": route_report(routes.calls)}
    res.update(_fp_step_check("mixtral_8x7b_depth2", gpu[None][0],
                              cpu[None][0]))
    return res


def phase_mixtral_train_step(seed: int, seq: int = 256) -> dict:
    """One Adam train step at Mixtral-8x7B widths, depth 1, fp32 (TF32
    off), batch 1, seq 256 (cap 80 of the 512 (row, choice) pairs an
    expert at alpha 1.25; Zipf-distributed ids, so some pairs drop), card
    against CPU from the
    same seeded weights: the expert assignment of both sides
    (route_report), then the load-balance term of a forward at the
    starting weights, the step's loss and every parameter after it,
    under phase_train_step's tolerances. The card's step launches K1 and
    K2 once."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = mixtral_8x7b(1)
    kw = dict(batch=1, seq=seq, dtype=DataType.FLOAT, remat="none",
              seed=seed)
    card_ff = _train_model(cfg, DEVICE, **kw)
    cpu_ff = _train_model(cfg, "cpu", **kw, params=tuple(
        {k: {n: t.cpu() for n, t in w.items()} for k, w in tree.items()}
        for tree in card_ff._params))
    x, y = zipf_tokens(1, seq, cfg.vocab_size, seed + 1)
    out = []
    with RouteRecorder() as routes:
        for ff in (card_ff, cpu_ff):
            ex = ff.executor
            tr, ntr = ff._params
            bx, by = (torch.from_numpy(a).to(ex.device) for a in (x, y))
            with torch.no_grad():
                _, aux = ex.run_forward(tr, ntr, [bx], training=True,
                                        skip_sink_softmax=True,
                                        return_aux=True)
            _reset_launches()
            tr, ntr, _, m = ex.train_step(tr, ntr, ff._opt_state, by, bx)
            if ff is card_ff:
                flat = _flash_launches()
            out.append((float(m["loss"]), float(aux),
                        {f"{k}/{n}": t.cpu() for k, w in tr.items()
                         for n, t in w.items()}))
    # the forward and the step route alike, both at the starting weights
    route = route_report(routes.calls)
    (gl, ga, gp), (cl, ca, cp) = out
    diffs = {n: (gp[n] - cp[n]).abs() for n in gp}
    worst = max(diffs, key=lambda n: float(diffs[n].max()))
    outside = sum(int((d > TRAIN_PARAM_TOL * (1 + cp[n].abs())).sum())
                  for n, d in diffs.items())
    total = sum(d.numel() for d in diffs.values())
    res = {"model": "mixtral_8x7b", "layers": 1, "seq": seq,
           "dropped_pairs": route["calls"][0]["cpu_dropped"],
           "flash_launches": flat, "loss_card": gl, "loss_cpu": cl,
           "loss_rel_err": abs(gl - cl) / abs(cl), "aux_card": ga,
           "aux_cpu": ca, "aux_rel_err": abs(ga - ca) / abs(ca),
           "max_param_abs_err": float(diffs[worst].max()),
           "worst_param": worst, "weights": total,
           "weights_outside_tol": outside, "lr": TRAIN_LR,
           "loss_rtol": TRAIN_LOSS_RTOL, "param_tol": TRAIN_PARAM_TOL,
           "outlier_fraction_allowed": TRAIN_OUTLIER_FRACTION}
    log(f"train_step {json.dumps(res)}")
    del card_ff, cpu_ff
    torch.cuda.empty_cache()
    ok = (np.isfinite(gl) and res["loss_rel_err"] <= TRAIN_LOSS_RTOL
          and res["aux_rel_err"] <= TRAIN_LOSS_RTOL
          and res["max_param_abs_err"] <= 2 * TRAIN_LR
          and outside <= TRAIN_OUTLIER_FRACTION * total
          and res["dropped_pairs"] > 0
          and flat == {k: 1 for k in flat})
    if not ok:
        raise AssertionError(f"card Mixtral train step disagrees with CPU: "
                             f"{res}")
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
# phase 7: the whole paged server — int8 pool, prefix cache, preemption,
# defrag — serving Llama-3-8B

# serve_generation's settings for phase 7 and its traffic; its Llama-3-8B
# at 8 of 32 layers (58 s of the run at 32, almost all host time a layer)
SERVE7_LAYERS = 8
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
    """Phase 7 on the card: Llama-3-8B's widths, SERVE7_LAYERS layers,
    bf16, random weights from the seed, through serve_int8_traffic. Fails unless every output
    has SERVE7_NEW valid tokens, the int8 kernel launched once per layer
    and ragged step and the fp kernel never, the four requests admitted
    first each mapped the 8 shared pages (hit tokens >= 4 x 512), growth
    preempted at least once and a defrag ran."""
    cfg = llama3_8b_cut(SERVE7_LAYERS)
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
    # one decode megastep of MEGASTEP_TICKS ticks at the same launch (each
    # tick the window-1 step and pick_tokens, then the one transfer back),
    # where the one-tick step above neither samples nor reads back
    tables, pos, qls, _, _, ids = _decode_launch(DEVICE, cfg.vocab_size, rs)
    B = pos.shape[0]
    state = (ids[:, 0].contiguous(), torch.zeros(B, device=DEVICE),
             torch.full((B,), 1 << 20, dtype=torch.int32, device=DEVICE),
             torch.full((B,), MAXP * P, dtype=torch.int32, device=DEVICE),
             qls.bool())
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed)

    def megastep():
        _, toks, done, ran, _ = ex.paged_megastep_fn(
            tr, ntr, pools[None], tables, pos, state[0], state[1],
            state[2], state[3], state[4], gen, max_ticks=MEGASTEP_TICKS)
        return torch.cat([toks.reshape(-1), done.int(),
                          ran.reshape(1)]).cpu()

    for _ in range(2):
        megastep()
    n = 5
    t0 = time.perf_counter()
    for _ in range(n):
        megastep()
    wall_ms = (time.perf_counter() - t0) / n * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            megastep()
    res = _profile_summary(prof, n, wall_ms)
    res.update({"ticks": MEGASTEP_TICKS,
                "wall_ms_per_tick": wall_ms / MEGASTEP_TICKS})
    if res["device_ms"] != "not measured":
        res["device_ms_per_tick"] = res["device_ms"] / MEGASTEP_TICKS
    name = f"megastep_x{MEGASTEP_TICKS}_b4_pos1024"
    log(f"profile {name} {json.dumps(res)}")
    out[name] = res
    out.update(profile_mixed_megastep(ex, tr, ntr, pools[None], cfg.vocab_size,
                                      rs, seed))
    return out


def profile_mixed_megastep(ex, tr, ntr, caches, vocab: int, rs,
                           seed: int) -> dict:
    """One universal megastep of MEGASTEP_TICKS ticks at phase 16's launch
    (Executor.paged_mixed_megastep_fn, window MIXED_WINDOW, no drafting):
    three slots decoding at pos 1024 and one mid-prefill slot taking 8
    prompt rows a tick (its prompt of 512 does not complete), then the
    one transfer back. Wall, device time and idle share by the profiler,
    and launches a tick."""
    from torch.profiler import ProfilerActivity, profile

    B = 4
    t = lambda a: torch.from_numpy(a).to(DEVICE)  # noqa: E731
    tables = t((1 + np.arange(B * MAXP, dtype=np.int32)).reshape(B, MAXP))
    seq = t(rs.randint(0, vocab, (B, MAXP * P + 1)).astype(np.int32))
    pos = t(np.array([1024, 1024, 0, 1024], np.int32))
    pf_pos = t(np.array([0, 0, 64, 0], np.int32))
    pf_target = t(np.array([0, 0, 512, 0], np.int32))
    dec = t(np.array([True, True, False, True]))
    pf = t(np.array([False, False, True, False]))
    temps = torch.zeros(B, device=DEVICE)
    rem = torch.full((B,), 1 << 20, dtype=torch.int32, device=DEVICE)
    cap = torch.full((B,), MAXP * P, dtype=torch.int32, device=DEVICE)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed)

    def megastep():
        _, _, toks, cnt, done, pf_fin, ran, _ = ex.paged_mixed_megastep_fn(
            tr, ntr, caches, tables, seq.clone(), pos, pf_pos, pf_target,
            temps, rem, cap, dec, pf, torch.zeros_like(dec), gen,
            max_ticks=MEGASTEP_TICKS, window=MIXED_WINDOW)
        return torch.cat([toks.reshape(-1), cnt.reshape(-1), done.int(),
                          pf_fin.int(), ran.reshape(1)]).cpu()

    for _ in range(2):
        megastep()
    n = 5
    t0 = time.perf_counter()
    for _ in range(n):
        got = megastep()
    wall_ms = (time.perf_counter() - t0) / n * 1e3
    if int(got[-1]) != MEGASTEP_TICKS:
        raise AssertionError(f"mixed megastep ran {int(got[-1])} ticks")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            megastep()
    res = _profile_summary(prof, n, wall_ms)
    res.update({"ticks": MEGASTEP_TICKS, "window": MIXED_WINDOW,
                "wall_ms_per_tick": wall_ms / MEGASTEP_TICKS,
                "device_launches_per_tick":
                    res["device_launches"] / MEGASTEP_TICKS})
    if res["device_ms"] != "not measured":
        res["device_ms_per_tick"] = res["device_ms"] / MEGASTEP_TICKS
    name = f"mixed_megastep_x{MEGASTEP_TICKS}_w{MIXED_WINDOW}"
    log(f"profile {name} {json.dumps(res)}")
    return {name: res}


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
    res["step_check"] = gpt2_step_check(
        cfg, saved, *(np.ascontiguousarray(a[:1, :GPT2_CHECK_SEQ])
                      for a in (x, y)), seed)
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
    off) on the card and on the CPU, give the loss and every gradient of
    the step's first sequence, its first GPT2_CHECK_SEQ tokens (batch 1). If the two agree the card computes the step as the CPU's
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
        # the position table's first rows: a build at seq S has S of them
        params = tuple({k: {n: (t[:x.shape[1]] if k.startswith("wpe")
                                else t).to(device) for n, t in w.items()}
                        for k, w in tree.items()} for tree in saved)
        ff = _train_model(cfg, device, batch=1, seq=x.shape[1],
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
    res = {"step": GPT2_CHECK_STEP, "batch": 1, "seq": x.shape[1],
           "dtype": "float32",
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


def phase_ring_train(seed: int, card: str, cfg=None,
                     label: str = "bench_1b") -> dict:
    """`cfg` (bench_1b by default), bf16, batch 1 x RING_SEQ tokens, ring
    attention over {"seq": RING_SHARDS}, remat none: one ff.fit epoch of
    RING_BATCHES seeded batches (the main path; counts reset just before,
    read just after: per layer and step K5 folds ring_folds(RING_SHARDS)
    blocks and K4's dq and dk/dv kernels run once per folded block, no
    other attention kernel), then 10 timed steps on one repeated batch
    (the loss must fall). A profiled ring step must show K5's launches on
    its tensor-core body at the model's head dim
    (flash_fwd_wgmma_kernel<HeadMajorCarry, D, ...>) and none on its
    CUDA-core one (flash_bh_fwd_carry_kernel), and K4's dq and dk/dv on
    their tensor-core bodies at D alone; it gives their ms a step and the
    device's idle share. Then the same model and weights without the ring
    (K1/K2 over the whole RING_SEQ rows at a head dim that is a multiple
    of 128, K4 otherwise): its step time, and its forward logits against
    the ring model's at the initial weights (bf16, so within
    RING_LOGITS_RTOL of their largest). Logged as train_ring_`label`
    (before the ring half's checks) and train_ring_`label`_no_ring."""
    from torch.profiler import ProfilerActivity, profile

    cfg = cfg or LlamaConfig.bench_1b()
    head_dim = cfg.dim // cfg.heads
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
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tr, ntr, opt, m = ex.train_step(tr, ntr, opt, by, bx)
        torch.cuda.synchronize()
    carry = flash_bodies(prof, 1, "HeadMajorCarry",
                         r"flash_bh_fwd_(carry)_kernel<", "k5")
    k4 = flash_bodies(prof, 1)
    del prof
    flops = llama_flops_per_token(cfg, RING_SEQ) * RING_SEQ
    res = {
        "model": label, "layers": cfg.layers, "dim": cfg.dim,
        "heads": cfg.heads, "kv_heads": cfg.kv_heads,
        "head_dim": head_dim, "dtype": "bfloat16",
        "batch": 1, "seq": RING_SEQ, "mesh_shape": mesh, "remat": "none",
        "params": sum(t.numel() for w in tr.values() for t in w.values()),
        "init_s": init_s, "fit_s": fit_s, "fit_steps": RING_BATCHES,
        "fit_loss": fit_loss, "fit_launches": fit_launches,
        "launches_per_step": {k.name: per_step for k in ring_kernels},
        "timed_steps": TIMED_STEPS, "losses": losses,
        "timed_launches": timed_launches, "step_ms": step_s * 1e3,
        "tokens_per_s": RING_SEQ / step_s, "flops_per_step": flops,
        "mfu": flops / step_s / PEAK_OPS[torch.bfloat16],
        "peak_mem_gb": peak_gb, "profile": carry, "k4_profile": k4,
        "card": card,
    }
    if isinstance(carry["k5_share_of_device_time"], float):
        # the device's idle share of a timed step
        res["idle_share"] = 1 - carry["device_ms_per_step"] / (step_s * 1e3)
    log(f"train_ring_{label} {json.dumps(res)}")
    del ff, ex, tr, ntr, opt, m
    torch.cuda.empty_cache()
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"ring loss on a repeated batch did not fall: "
                             f"{losses}")
    if any(n != per_step * TIMED_STEPS for n in timed_launches.values()):
        raise AssertionError(f"timed launches {timed_launches}")
    if carry["launches_per_step"] != {"tensor_core": {"fwd": per_step},
                                      "cuda_core": {}} \
            or carry["tensor_core_head_dims"] != [head_dim]:
        raise AssertionError(f"K5 did not run on its tensor-core body at "
                             f"head dim {head_dim} alone: {carry}")
    if k4["launches_per_step"] != {
            "tensor_core": {"dq": per_step, "dkv": per_step},
            "cuda_core": {}} or k4["tensor_core_head_dims"] != [head_dim]:
        raise AssertionError(f"K4's backward did not run on its tensor-core "
                             f"bodies at head dim {head_dim} alone: {k4}")

    # the same model and seed without the ring: K1/K2 (D a multiple of
    # 128) or K4 over all RING_SEQ rows
    route = FLASH_KERNELS if head_dim % 128 == 0 else K4_KERNELS
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
    plain_launches = {k.name: k.launches for k in KERNELS}
    res["no_ring"] = {
        "step_ms": plain_s * 1e3, "steps": RING_PLAIN_STEPS,
        "launches": plain_launches,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "logits_max_abs_diff_vs_ring": diff, "logits_max_abs": scale,
        "logits_rtol": RING_LOGITS_RTOL}
    res["ring_step_over_no_ring"] = res["no_ring"]["ring_step_over_no_ring"] \
        = step_s / plain_s
    del ff, ex, tr, ntr, opt, m
    torch.cuda.empty_cache()
    log(f"train_ring_{label}_no_ring {json.dumps(res['no_ring'])}")
    if diff > RING_LOGITS_RTOL * scale or not np.isfinite(diff):
        raise AssertionError(f"ring logits differ from the plain route's "
                             f"by {diff} (largest {scale})")
    if plain_launches != {k.name: (cfg.layers * RING_PLAIN_STEPS
                                   if k in route else 0) for k in KERNELS}:
        raise AssertionError(f"no-ring launches {res['no_ring']}")
    return res


def phase_ring_train_wide_heads(seed: int, card: str) -> dict:
    """Phase 14: a Llama at Phi-3-mini's widths (phi3_mini: head dim 96,
    PHI3_LAYERS layers) through phase_ring_train, then one at
    OpenLLaMA-3B's widths (open_llama_3b: head dim 100, whose tiles K5
    fills by cp.async) cut to RING_OPENLLAMA_LAYERS layers the same way.
    Returns {"phi3_mini": ..., "openllama_3b": ...}."""
    return {
        "phi3_mini": phase_ring_train(seed, card, phi3_mini(), "phi3_mini"),
        "openllama_3b": phase_ring_train(
            seed, card, dataclasses.replace(
                open_llama_3b(), layers=RING_OPENLLAMA_LAYERS),
            "openllama_3b")}


# ---------------------------------------------------------------------------
# phases 11 and 12: Llamas whose head dims take the head-major route (K4)


def flash_bodies(prof, n: int, tag: str = "HeadMajor",
                 cuda_core=r"flash_bh_(fwd|dq|dkv)_kernel<",
                 label: str = "k4") -> dict:
    """From a torch.profiler run of n train steps: per step, the launches
    of each body of one head-major kernel family ({"tensor_core": {fwd,
    dq, dkv}, "cuda_core": {...}}, and "tf32": {fwd, dq, dkv} where K4's
    3xTF32 bodies ran): the tensor-core bodies under the layout tag
    `tag`, the CUDA-core ones whose names match `cuda_core` (K4 by
    default; K5 is tag "HeadMajorCarry" and the
    flash_bh_fwd_carry_kernel); the head dims of the tensor-core bodies
    that ran; and their device ms and share of the device time, keyed by
    `label`."""
    evs = _device_events(prof)
    dev = sum(e.self_device_time_total for e in evs)
    launches = {"tensor_core": {}, "cuda_core": {}}
    dims = set()
    own_us = 0.0
    for e in evs:
        name = wgmma_name(e.key)
        t32 = tf32_name(e.key)
        if name and name.split("<")[1].split(",")[0] == tag:
            body, kind = "tensor_core", name.split("_")[1]
            dims.add(int(name.split(",")[1]))
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
            "tensor_core_head_dims": sorted(dims),
            f"{label}_ms_per_step": own_us / n / 1e3,
            "device_ms_per_step": dev / n / 1e3,
            f"{label}_share_of_device_time": own_us / dev if dev else
            "not measured"}


def _train_head_major(seed: int, card: str, cfg, label: str) -> dict:
    """`cfg` (a head dim that is not a multiple of 128, so every attention
    takes the head-major route), bf16, fp32 masters, batch 8, seq 1024,
    remat none, Adam lr 1e-4: one ff.fit epoch of 10 seeded batches (the
    main path; counts reset just before, read just after: each K4 kernel
    once per layer and step, no other attention kernel), 10 timed steps
    on one repeated batch (the loss must fall), then two profiled steps
    that must show K4's launches on its tensor-core bodies at the
    model's head dim (flash_*_wgmma_kernel<HeadMajor, D, ...>) and none
    on its CUDA-core bodies; reports K4's share of the device time and
    the device's idle share of a timed step. Logged as `label`."""
    from torch.profiler import ProfilerActivity, profile

    head_dim = cfg.dim // cfg.heads
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
        "model": label, "layers": cfg.layers, "dim": cfg.dim,
        "heads": cfg.heads, "kv_heads": cfg.kv_heads,
        "head_dim": head_dim, "hidden": cfg.hidden,
        "vocab": cfg.vocab_size, "dtype": "bfloat16",
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
    log(f"train_{label} {json.dumps(res)}")
    del ff, ex, tr, ntr, opt, m
    torch.cuda.empty_cache()
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"{label} loss on a repeated batch did not "
                             f"fall: {losses}")
    if any(n != cfg.layers * TIMED_STEPS for n in timed_launches.values()):
        raise AssertionError(f"timed launches {timed_launches}")
    per_step = {k: cfg.layers for k in ("fwd", "dq", "dkv")}
    if bodies["launches_per_step"] != {"tensor_core": per_step,
                                       "cuda_core": {}} \
            or bodies["tensor_core_head_dims"] != [head_dim]:
        raise AssertionError(f"K4 did not run on its tensor-core bodies "
                             f"at head dim {head_dim} alone: {bodies}")
    return res


def phase_train_200m(seed: int, card: str) -> dict:
    """Phase 11: bench.py's 200m Llama (llama_200m: head dim 64) through
    _train_head_major."""
    return _train_head_major(seed, card, llama_200m(), "llama_200m")


def phase_train_phi3(seed: int, card: str) -> dict:
    """Phase 12: a Llama at Phi-3-mini's widths (phi3_mini: head dim 96,
    PHI3_LAYERS layers) through _train_head_major."""
    return _train_head_major(seed, card, phi3_mini(), "phi3_mini")


def phase_train_openllama(seed: int, card: str) -> dict:
    """Phase 13: a Llama at OpenLLaMA-3B's widths (open_llama_3b: head dim
    100, OPENLLAMA_LAYERS layers) through _train_head_major."""
    return _train_head_major(seed, card, open_llama_3b(), "openllama_3b")


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


# ---------------------------------------------------------------------------
# phase 15: speculative decoding and decode megasteps, Llama-3-8B


def serve_traffic(vocab: int, seed: int):
    """Phase 4's 8 requests: 128..1024 prompt tokens each."""
    rs = np.random.RandomState(seed)
    lens = rs.randint(128, 1025, size=8)
    return [rs.randint(0, vocab, (n,)).astype(np.int32) for n in lens]


def _timed(server, name, calls):
    """Replace the server's method `name` by one that appends each call's
    host seconds to calls[name] (the loop calls it through the
    instance)."""
    fn = getattr(server, name)

    def run(*a):
        t0 = time.perf_counter()
        try:
            return fn(*a)
        finally:
            calls[name].append(time.perf_counter() - t0)

    setattr(server, name, run)


# what torch.cuda.set_sync_debug_mode("warn") says at each synchronizing
# call (c10/cuda/CUDAFunctions.cpp)
SYNC_WARNING = "called a synchronizing CUDA operation"


def _count_syncs(server, counts, name="_decode_megastep"):
    """Run each megastep of `server` (its method `name`: the decode
    megastep, or _mixed_megastep) under torch.cuda.set_sync_debug_mode
    ("warn") and append to `counts` the synchronizing CUDA calls it made
    (each one warns once)."""
    fn = getattr(server, name)

    def run(*a):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                return fn(*a)
            finally:
                torch.cuda.set_sync_debug_mode(0)
                counts.append(sum(SYNC_WARNING in str(w.message)
                                  for w in caught))

    setattr(server, name, run)


class _WindowCounter:
    """Counts the ragged attention calls by window (q's S) and pool dtype
    while installed as paged.attention.ragged_flash_attention, the name
    the paged attention step calls."""

    def __init__(self):
        import flexflow_tpu_torch.paged.attention as pa

        self.module, self.fn, self.counts = pa, pa.ragged_flash_attention, {}

    def __enter__(self):
        def count(q, kc, *a, **kw):
            key = (int(q.shape[1]), str(kc.dtype).replace("torch.", ""))
            self.counts[key] = self.counts.get(key, 0) + 1
            return self.fn(q, kc, *a, **kw)

        self.module.ragged_flash_attention = count
        return self

    def __exit__(self, *exc):
        self.module.ragged_flash_attention = self.fn

    def at(self, window: int, pool: str) -> int:
        return self.counts.get((window, pool), 0)

    def by_window(self) -> dict:
        """{"<window>/<pool>": launches}, for the record."""
        return {f"{w}/{p}": n for (w, p), n in sorted(self.counts.items())}


def serve_closed(ff, vocab: int, prompts, new: int,
                 temperature: float = 0.0, syncs=None, **kw) -> dict:
    """Serve `prompts` (`new` tokens each) through
    ff.serve_generation(paged=True) at the paged server's defaults (4
    slots, max_len 2048, page 64, prefix cache and preemption on) and
    `kw`, every request queued before the loop starts (defer_start), so
    the schedule is a function of the tokens alone. Kernel counts are
    reset just before and read just after; the tick methods are timed
    on the host clock; with `syncs` (a list), each megastep's
    synchronizing CUDA calls are counted into it."""
    kw = {"prefill_chunk": 64, **kw}
    server = ff.serve_generation(paged=True, slots=4, max_len=2048,
                                 page_size=64, defer_start=True, **kw)
    calls = {n: [] for n in ("_decode_tick", "_decode_megastep",
                             "_mixed_megastep", "_spec_tick")}
    for name in calls:
        if hasattr(server, name):
            _timed(server, name, calls)
    if syncs is not None:
        _count_syncs(server, syncs, "_mixed_megastep"
                     if kw.get("megastep_mixed") else "_decode_megastep")
    try:
        futs = [server.submit(p, max_new_tokens=new,
                              temperature=temperature) for p in prompts]
        torch.cuda.synchronize()
        _reset_launches()
        t0 = time.monotonic()
        server.start()
        outs = [np.asarray(f.result(timeout=900)) for f in futs]
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = {k.name: k.launches for k in KERNELS}
        m = server.metrics()
    finally:
        server.stop()
    server.pool.check_invariants(owners={})
    for o in outs:
        if len(o) != new or not ((0 <= o) & (o < vocab)).all():
            raise AssertionError(f"bad output {o}")
    ms = m["megastep"]
    ttft = sorted(r["ttft_s"] for r in m["requests"])
    res = {
        "wall_s": wall, "generated_tokens_per_s": new * len(outs) / wall,
        "ttft_p50_s": ttft[len(ttft) // 2], "ttft_max_s": ttft[-1],
        "ragged_steps": m["ragged_steps"], "launches": launches,
        "decode_tick_ms": (1e3 * float(np.mean(calls["_decode_tick"]))
                           if calls["_decode_tick"] else None),
        "decode_ticks": len(calls["_decode_tick"]),
        "prefill_ticks": m["prefill_ticks"], "kv_dtype": m["kv_cache_dtype"],
        "host_roundtrips": ms["host_roundtrips"],
        "decode_tokens": ms["decode_tokens"],
        "host_roundtrips_per_token": ms["host_roundtrips_per_token"],
        "launch_rows": m["launch_rows"], "padded_rows": m["padded_rows"],
        "padding_waste_ratio": m["padding_waste_ratio"],
    }
    if ms["dispatches"]:
        fused = calls["_mixed_megastep" if ms["mixed"]
                      else "_decode_megastep"]
        res.update({
            "mixed": ms["mixed"],
            "megastep_ms": 1e3 * float(np.mean(fused)),
            "megastep_ms_per_tick": 1e3 * sum(fused) / ms["ticks_run"],
            "megasteps": ms["dispatches"],
            "ticks_per_megastep": ms["ticks_run"] / ms["dispatches"],
            "breaks": ms["breaks"], "wasted_ticks": ms["wasted_ticks"],
            "wasted_ticks_per_megastep": ms["wasted_ticks"]
            / ms["dispatches"],
            "host_overlap_ratio": ms["host_overlap_ratio"]})
    if "speculative" in m:
        per_req = [r["spec_accepted_tokens_per_step"] for r in m["requests"]
                   if "spec_accepted_tokens_per_step" in r]
        res.update({
            "verify_step_ms": (1e3 * float(np.mean(calls["_spec_tick"]))
                               if calls["_spec_tick"] else None),
            "speculative": m["speculative"],
            "tokens_per_verify_step_per_request_mean": float(
                np.mean(per_req)) if per_req else 0.0})
    return {"outs": outs, "res": res, "server": server}


def commit_check(ex, caches, seed: int) -> dict:
    """The accepted-path commit (Executor.paged_commit_fn) at full width
    on the pools a served run left: 4 slots each commit a 5-row path
    (tree nodes 0, 2, 3, 7, 8 onto rows pos..pos+4) through random
    tables, on the card and on CPU copies of the same pools, which must
    end equal, bytes and scales included on an int8 pool."""
    rs = np.random.RandomState(seed)
    N = next(iter(caches.values()))["k"].shape[0]
    tables = (rs.permutation(N - 1)[:4 * 8] + 1).reshape(4, 8)
    pos = rs.randint(0, 7 * P - 9, size=4)
    src = pos[:, None] + np.array([0, 2, 3, 7, 8])
    dst = pos[:, None] + np.arange(5)
    args = [a.astype(np.int32) for a in (tables, src, dst)]
    before = {k: {n: b.to("cpu", copy=True) for n, b in bufs.items()}
              for k, bufs in caches.items()}
    cpu = {k: {n: b.clone() for n, b in bufs.items()}
           for k, bufs in before.items()}
    card = {k: {n: b.clone() for n, b in bufs.items()}
            for k, bufs in caches.items()}
    ex.paged_commit_fn(card, *[torch.from_numpy(a).to(DEVICE)
                               for a in args])
    ex.paged_commit_fn(cpu, *[torch.from_numpy(a) for a in args])
    diff = {f"{k}/{n}": int((card[k][n].cpu() != b).sum())
            for k, bufs in cpu.items() for n, b in bufs.items()}
    moved = sum(int((card[k][n].cpu() != b).sum())
                for k, bufs in before.items() for n, b in bufs.items())
    res = {"elements_differing": sum(diff.values()),
           "elements_moved": moved,
           "buffers": sorted(diff)}
    if res["elements_differing"] or not moved:
        raise AssertionError(f"commit card vs CPU: {diff}, moved {moved}")
    return res


def _launches_ok(label, r, n_attn):
    """Raise unless K3 (fp or int8, by the pool) launched once per
    attention layer and ragged step."""
    res = r["res"]
    kern = (RAGGED_PAGED_ATTENTION_INT8 if res["kv_dtype"] == "int8"
            else RAGGED_PAGED_ATTENTION)
    got = res["launches"][kern.name]
    if res["ragged_steps"] == 0 or got != n_attn * res["ragged_steps"]:
        raise AssertionError(f"{label}: {kern.name} launched {got} times, "
                             f"not {n_attn} x {res['ragged_steps']} steps")


def lookup_prompts(prompts, outs):
    """Each prompt with its last 65 tokens replaced by its last token t,
    the first 63 tokens `outs` holds for it and t again: prompt lookup
    finds t earlier in the context and drafts what followed it there."""
    return [np.concatenate([p[:len(p) - 65], p[-1:], o[:63], p[-1:]])
            for p, o in zip(prompts, outs)]


def _same_share(a, b) -> float:
    return float(np.mean([np.mean(x == y) for x, y in zip(a, b)]))


def phase_spec_megastep(seed: int, card: str) -> dict:
    """Phase 15: the paged server's decode megastep and speculative
    decoding at Llama-3-8B's widths, MEGASTEP_LAYERS layers (phase 4's 8
    requests, 64 new each).
    (a) megastep_ticks=8 against the one-tick loop at full width, bf16:
    tokens identical, greedy and sampled at a fixed seed; one host sync a
    megastep; K3 once per layer and ragged step (each megastep tick one
    step). (b) speculate=SpecConfig(width=2, depth=4) on the
    make_token_cyclic weights: >= ACCEPT_FLOOR tokens per verify step
    per request, K3 once per layer and verify step at the 9-row tree
    window. (c) fp32 with TF32 off,
    depth 2, random weights, on the same lookup prompts: the one-tick,
    the megastep and the speculative servers' greedy tokens identical on
    an fp pool; the
    speculative server on an int8 pool too, its tokens' share equal to
    the int8 one-tick server's reported, and a commit on the pools it
    left equal on the card and on the CPU."""
    cfg = llama3_8b_cut(MEGASTEP_LAYERS)
    out = {"card": card, "layers": cfg.layers}
    t0 = time.monotonic()
    ff = FFModel(FFConfig(batch_size=1, seed=seed, device=DEVICE))
    build_llama(ff, cfg, batch_size=1, seq_len=2048,
                dtype=DataType.BFLOAT16)
    ff.compile()
    torch.cuda.synchronize()
    out["init_s"] = time.monotonic() - t0
    n_attn = len(ff.executor.paged_kv_cache_specs(2, 1))
    prompts = serve_traffic(cfg.vocab_size, seed)
    # warm cuBLAS and the allocator off the clock, through both loops
    for kw in ({}, {"megastep_ticks": MEGASTEP_TICKS}):
        serve_closed(ff, cfg.vocab_size, [prompts[0][:16]], 4, **kw)

    # (a) megastep against the one-tick loop
    runs, syncs = {}, []
    for temp in (0.0, SAMPLE_TEMPERATURE):
        for n in (1, MEGASTEP_TICKS):
            runs[temp, n] = serve_closed(
                ff, cfg.vocab_size, prompts, 64, temperature=temp, seed=seed,
                megastep_ticks=n,
                syncs=syncs if temp and n > 1 else None)
            _launches_ok(f"15a t={temp} n={n}", runs[temp, n], n_attn)
    a = {("sampled_" if t else "greedy_") + (
        "megastep" if n > 1 else "one_tick"): r["res"]
        for (t, n), r in runs.items()}
    a["syncs_per_megastep"] = sorted(set(syncs))
    a["identical"] = {
        kind: all(np.array_equal(x, y) for x, y in zip(
            runs[t, 1]["outs"], runs[t, MEGASTEP_TICKS]["outs"]))
        for kind, t in (("greedy", 0.0), ("sampled", SAMPLE_TEMPERATURE))}
    log(f"spec_megastep a {json.dumps(a)}")
    out["a"] = a
    if not all(a["identical"].values()) or syncs == [] or set(syncs) != {1}:
        raise AssertionError(f"15a: identical {a['identical']}, syncs a "
                             f"megastep {a['syncs_per_megastep']} (want 1)")

    # (b) speculation on the token-cyclic weights, where the next token
    # is a function of the current one alone. At 128256 tokens that
    # function's stream repeats only after hundreds of tokens, and phase
    # 4's random prompts hold no n-gram it follows, so prompt lookup would
    # draft nothing that can be accepted. Each request's last 65 tokens
    # therefore become its last token t, the stream the one-tick run
    # emitted from t (63 tokens) and t again: the context holds the
    # continuation, as prompt lookup's users' (edits, quotes) do, and the
    # 64 tokens served must equal the one-tick run's.
    make_token_cyclic(ff)
    plain = serve_closed(ff, cfg.vocab_size, prompts, 64, seed=seed)
    lookup = lookup_prompts(prompts, plain["outs"])
    with _WindowCounter() as wc:
        spec = serve_closed(ff, cfg.vocab_size, lookup, 64, seed=seed,
                            speculate=SPEC_CONFIG)
    _launches_ok("15b", spec, n_attn)
    r = spec["res"]
    r["tree_window_launches"] = wc.at(SPEC_CONFIG.max_nodes, "bfloat16")
    r["equal_to_one_tick_share"] = _same_share(plain["outs"], spec["outs"])
    b = {"one_tick": plain["res"], "spec": r}
    log(f"spec_megastep b {json.dumps(b)}")
    steps = r["speculative"]["steps"]
    if (r["tokens_per_verify_step_per_request_mean"] < ACCEPT_FLOOR
            or r["tree_window_launches"] != n_attn * steps):
        raise AssertionError(
            f"15b: {r['tokens_per_verify_step_per_request_mean']} tokens a "
            f"verify step (want >= {ACCEPT_FLOOR}), "
            f"{r['tree_window_launches']} tree-window launches for "
            f"{steps} verify steps")
    out["b"] = b
    del ff, runs, plain, spec
    torch.cuda.empty_cache()

    # (c) identity at full width, fp32, depth 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg2 = dataclasses.replace(cfg, layers=2)
    ff = FFModel(FFConfig(batch_size=1, seed=seed, device=DEVICE))
    build_llama(ff, cfg2, batch_size=1, seq_len=2048, dtype=DataType.FLOAT)
    ff.compile()
    # the lookup prompts, from phase 4's prompts and this model's own
    # one-tick tokens, give the drafter trees to verify: K3 under real
    # tree masks, and commits of accepted paths beside rejected rows
    first = serve_closed(ff, cfg.vocab_size, prompts, 64, seed=seed)
    lookup = lookup_prompts(prompts, first["outs"])
    c, toks = {}, {}
    for name, kw in (("one_tick", {}),
                     ("megastep", {"megastep_ticks": MEGASTEP_TICKS}),
                     ("spec", {"speculate": SPEC_CONFIG}),
                     ("one_tick_int8", {"kv_dtype": "int8"}),
                     ("spec_int8", {"speculate": SPEC_CONFIG,
                                    "kv_dtype": "int8"})):
        with _WindowCounter() as wc:
            r = serve_closed(ff, cfg.vocab_size, lookup, 64, seed=seed,
                             **kw)
        _launches_ok(f"15c {name}", r, 2)
        if name == "spec_int8":
            r["res"]["commit_check"] = commit_check(
                ff.executor, r["server"]._caches, seed)
        r["res"]["tree_window_launches"] = wc.at(
            SPEC_CONFIG.max_nodes, "int8" if "int8" in name else "float32")
        c[name], toks[name] = r["res"], r["outs"]
        if "spec" in name and r["res"]["tree_window_launches"] != \
                2 * r["res"]["speculative"]["steps"]:
            raise AssertionError(f"15c {name}: tree-window launches "
                                 f"{r['res']['tree_window_launches']}")
    # the int8 pair is reported, not required to match: the verify
    # writes every drafted row, and a rejected row can grow its page's
    # scale (grow-only, paged/quant.py), re-quantizing the committed rows
    # there, which the one-tick loop never does (so in the reference)
    c["identical"] = {
        pair: all(np.array_equal(x, y) for x, y in zip(
            toks[pair.split("=")[0]], toks[pair.split("=")[1]]))
        for pair in ("one_tick=megastep", "one_tick=spec",
                     "one_tick_int8=spec_int8")}
    c["equal_share"] = {pair: _same_share(
        toks[pair.split("=")[0]], toks[pair.split("=")[1]])
        for pair in c["identical"]}
    log(f"spec_megastep c {json.dumps(c)}")
    out["c"] = c
    del ff
    torch.cuda.empty_cache()
    if not (c["identical"]["one_tick=megastep"]
            and c["identical"]["one_tick=spec"]):
        raise AssertionError(f"15c: identical {c['identical']}, shares "
                             f"{c['equal_share']}")
    return out


# ---------------------------------------------------------------------------
# phase 16: the universal megastep, overlap_dispatch, the unpacked launch
# and the dense KV-cache path, serving Llama-3-8B

# the mixed megastep's launch window: min(PREFILL_WINDOW_ROWS,
# prefill_chunk) at phase 4's prefill_chunk of 64
MIXED_WINDOW = 8
# 16(f): the fp32 int8 pair's chunk (one the one-tick loop's budget
# never splits when prompts are whole multiples of it, so both servers
# write every page's rows in the same groups: grow-only page scales make
# the int8 bytes depend on that grouping)
INT8_PAIR_CHUNK = 8


def serve_dense(ff, vocab: int, prompts, new: int, **kw) -> dict:
    """Serve `prompts` through serve_generation's default, the dense
    GenerationServer (4 slots, max_len 2048, `kw`), every request queued
    before the loop starts; kernel counts reset just before and read just
    after. No hand kernel runs on this path (the reference computes it
    outside any Pallas kernel), so every count must stay 0."""
    server = ff.serve_generation(slots=4, max_len=2048, defer_start=True,
                                 **kw)
    try:
        futs = [server.submit(p, max_new_tokens=new) for p in prompts]
        torch.cuda.synchronize()
        _reset_launches()
        t0 = time.monotonic()
        server.start()
        outs = [np.asarray(f.result(timeout=900)) for f in futs]
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = {k.name: k.launches for k in KERNELS}
        m = server.metrics()
    finally:
        server.stop()
    for o in outs:
        if len(o) != new or not ((0 <= o) & (o < vocab)).all():
            raise AssertionError(f"bad output {o}")
    if any(launches.values()):
        raise AssertionError(f"dense server launched kernels {launches}")
    ttft = sorted(r["ttft_s"] for r in m["requests"])
    return {"outs": outs, "res": {
        "wall_s": wall, "generated_tokens_per_s": new * len(outs) / wall,
        "ttft_p50_s": ttft[len(ttft) // 2], "ttft_max_s": ttft[-1],
        "decode_steps": m["decode_steps"],
        "kv_cache_bytes": _pool_bytes(server)}}


def _identical(a, b) -> bool:
    return all(np.array_equal(x, y) for x, y in zip(a, b))


def _pool_bytes(server) -> int:
    return sum(b.numel() * b.element_size()
               for bufs in server._caches.values() for b in bufs.values())


def phase_mixed_dense(seed: int, card: str) -> dict:
    """Phase 16 at Llama-3-8B's widths, MEGASTEP_LAYERS layers (phase 4's
    server settings and 8 requests, 64 new tokens each), bf16 unless
    said:
    (a) megastep_mixed=True, megastep_ticks=8 against the one-tick loop
    and the decode-only megastep, greedy, and mixed N = 1 against N = 8,
    sampled (0.8): K3 once per layer and enqueued tick, every mixed
    launch at window 8, one synchronizing call a mixed dispatch; each
    run's tokens/s, TTFT, wall a tick, host round trips a token, ticks a
    dispatch, breaks and predicated-off ticks. (b) + overlap_dispatch
    =True: host_overlap_ratio. (e) the dense default serve_generation (4
    slots, max_len 2048) and ff.generate on two prompts: cache bytes and
    tokens/s beside the paged pool's, no hand kernel launched. (d)
    ragged_pack=False on the one-tick server: the padded-row share
    against packed, K3's launches by window (8..64). (c) on
    make_token_cyclic weights and lookup prompts (phase 15b's):
    speculate=SpecConfig(width=2, depth=4) with the mixed megastep,
    tokens a drafting tick a request, verify breaks; then (d) on the
    speculative server, packed against unpacked.
    Greedy tokens must be identical where the two runs launch the same
    shapes: one-tick = decode megastep, mixed N = 1 = N = 8 (sampled
    too), mixed = mixed + overlap; and on the cyclic weights, whose next
    token is a function of the current one, spec = one-tick, packed or
    not. In bf16 a different launch shape (the mixed window 8 for a
    decode row, the unpacked windows, the dense attention) rounds
    differently, and on random weights the logits are too close for the
    argmax to survive that: those pairs' equal shares are reported, and
    (f) holds them to identity in fp32, TF32 off, depth 2, random
    weights, on lookup prompts: the one-tick, mixed, mixed + speculative
    and unpacked servers, dense generate and the speculative server
    drafting with DraftModelDrafter over the target itself (the drafts
    accepted reported); on an int8 pool the mixed megastep against the
    int8 one-tick server, both at INT8_PAIR_CHUNK on prompts cut to
    whole chunks. A failed check is recorded and the phase goes on, so
    one run reports every check; it raises at the end if any failed."""
    from flexflow_tpu_torch.spec import DraftModelDrafter

    t_phase = time.monotonic()
    cfg = llama3_8b_cut(MEGASTEP_LAYERS)
    out = {"card": card, "layers": cfg.layers}
    problems = []
    ff = FFModel(FFConfig(batch_size=1, seed=seed, device=DEVICE))
    build_llama(ff, cfg, batch_size=1, seq_len=2048,
                dtype=DataType.BFLOAT16)
    ff.compile()
    n_attn = len(ff.executor.paged_kv_cache_specs(2, 1))
    prompts = serve_traffic(cfg.vocab_size, seed)
    V = cfg.vocab_size
    mixed = {"megastep_ticks": MEGASTEP_TICKS, "megastep_mixed": True}
    # warm cuBLAS and the allocator off the clock, through each loop
    for kw in ({}, mixed, {"ragged_pack": False}):
        serve_closed(ff, V, [prompts[0][:16]], 4, **kw)

    # (a) the mixed megastep against the one-tick loop and the decode-only
    # megastep, greedy; mixed N = 1 against N = 8, sampled
    runs, syncs = {}, []
    for name, temp, kw in (
            ("one_tick", 0.0, {}),
            ("decode_megastep", 0.0, {"megastep_ticks": MEGASTEP_TICKS}),
            ("mixed", 0.0, mixed),
            ("mixed_n1_sampled", SAMPLE_TEMPERATURE,
             {"megastep_ticks": 1, "megastep_mixed": True}),
            ("mixed_sampled", SAMPLE_TEMPERATURE, mixed)):
        with _WindowCounter() as wc:
            runs[name] = serve_closed(
                ff, V, prompts, 64, temperature=temp, seed=seed,
                syncs=syncs if name == "mixed" else None, **kw)
        _launches_ok(f"16a {name}", runs[name], n_attn)
        runs[name]["res"]["launches_by_window"] = wc.by_window()
    a = {name: r["res"] for name, r in runs.items()}
    paged_pool_bytes = _pool_bytes(runs["one_tick"]["server"])
    for r in runs.values():
        r.pop("server")
    a["syncs_per_mixed_megastep"] = sorted(set(syncs))
    a["identical"] = identical = {
        "one_tick=decode_megastep": _identical(
            runs["one_tick"]["outs"], runs["decode_megastep"]["outs"]),
        "one_tick=mixed": _identical(runs["one_tick"]["outs"],
                                     runs["mixed"]["outs"]),
        "mixed_n1_sampled=mixed_sampled": _identical(
            runs["mixed_n1_sampled"]["outs"], runs["mixed_sampled"]["outs"]),
    }
    a["equal_share"] = {
        "one_tick=decode_megastep": _same_share(
            runs["one_tick"]["outs"], runs["decode_megastep"]["outs"]),
        "one_tick=mixed": _same_share(runs["one_tick"]["outs"],
                                      runs["mixed"]["outs"]),
        "mixed_n1_sampled=mixed_sampled": _same_share(
            runs["mixed_n1_sampled"]["outs"], runs["mixed_sampled"]["outs"])}
    mixed_w8 = {k: runs[k]["res"]["launches_by_window"].get(
        f"{MIXED_WINDOW}/bfloat16", 0) for k in ("mixed", "mixed_sampled")}
    log(f"mixed_dense a {json.dumps(a)}")
    out["a"] = a
    same_shapes = ("one_tick=decode_megastep",
                   "mixed_n1_sampled=mixed_sampled")
    if not all(identical[k] for k in same_shapes) or set(syncs) != {1} \
            or any(mixed_w8[k] != n_attn * runs[k]["res"]["ragged_steps"]
                   for k in mixed_w8):
        problems.append(f"16a: identical {identical}, syncs a mixed "
                        f"megastep {a['syncs_per_mixed_megastep']} (want "
                        f"1), window-8 launches {mixed_w8}")
    greedy = runs["one_tick"]["outs"]

    # (b) + overlap_dispatch
    b = serve_closed(ff, V, prompts, 64, seed=seed, overlap_dispatch=True,
                     **mixed)
    _launches_ok("16b", b, n_attn)
    b["res"]["identical_to_a"] = _identical(runs["mixed"]["outs"],
                                            b["outs"])
    log(f"mixed_dense b {json.dumps(b['res'])}")
    out["b"] = b["res"]
    if not b["res"]["identical_to_a"]:
        problems.append("16b: overlap_dispatch changed the tokens")

    # (e) the dense default server and ff.generate
    dense = serve_dense(ff, V, prompts, 64)
    gen = [ff.generate(p[None], max_new_tokens=64)[0] for p in prompts[:2]]
    e = dense["res"]
    e.update({
        "identical_to_paged": _identical(greedy, dense["outs"]),
        "equal_share_to_paged": _same_share(greedy, dense["outs"]),
        "generate_identical": _identical(dense["outs"][:2], gen),
        "paged_pool_bytes": paged_pool_bytes,
        "paged_generated_tokens_per_s":
            runs["one_tick"]["res"]["generated_tokens_per_s"]})
    log(f"mixed_dense e {json.dumps(e)}")
    out["e"] = e
    e["generate_equal_share"] = _same_share(dense["outs"][:2], gen)

    # (d) the unpacked launch on the one-tick server
    with _WindowCounter() as wc:
        unpacked = serve_closed(ff, V, prompts, 64, seed=seed,
                                ragged_pack=False)
    _launches_ok("16d", unpacked, n_attn)
    d = {"one_tick": {
        "identical": _identical(greedy, unpacked["outs"]),
        "equal_share": _same_share(greedy, unpacked["outs"]),
        "padding_waste_ratio_packed":
            runs["one_tick"]["res"]["padding_waste_ratio"],
        "padding_waste_ratio_unpacked":
            unpacked["res"]["padding_waste_ratio"],
        "launches_by_window": wc.by_window(), "res": unpacked["res"]}}
    wide = {w: wc.at(w, "bfloat16") for w in (8, 16, 32, 64)}
    out["unpacked_w64_launches"] = wide[64]
    if not all(wide.values()):
        problems.append(f"16d: launches by window {wide}")
    del runs, b, dense, unpacked
    torch.cuda.empty_cache()

    # (c) speculation through the mixed megastep on the token-cyclic
    # weights and lookup prompts (phase 15b's), then (d)'s unpacked
    # speculative server against the packed one
    make_token_cyclic(ff)
    plain = serve_closed(ff, V, prompts, 64, seed=seed)
    lookup = lookup_prompts(prompts, plain["outs"])
    spec = serve_closed(ff, V, lookup, 64, seed=seed, speculate=SPEC_CONFIG,
                        **mixed)
    _launches_ok("16c", spec, n_attn)
    r = spec["res"]
    c = {"one_tick": plain["res"], "spec_mixed": r,
         "identical": _identical(plain["outs"], spec["outs"]),
         "equal_share": _same_share(plain["outs"], spec["outs"]),
         "tokens_per_drafting_tick_per_request":
             r["tokens_per_verify_step_per_request_mean"],
         "verify_breaks": r["breaks"]["verify"]}
    log(f"mixed_dense c {json.dumps(c)}")
    out["c"] = c
    if (not c["identical"]
            or c["tokens_per_drafting_tick_per_request"] < ACCEPT_FLOOR):
        problems.append(f"16c: identical {c['identical']}, "
                        f"{c['tokens_per_drafting_tick_per_request']} "
                        f"tokens a drafting tick")
    sp = {}
    for pack in (True, False):
        with _WindowCounter() as wc:
            sp[pack] = serve_closed(ff, V, lookup, 64, seed=seed,
                                    speculate=SPEC_CONFIG, ragged_pack=pack)
        _launches_ok(f"16d spec pack={pack}", sp[pack], n_attn)
        sp[pack]["res"]["launches_by_window"] = wc.by_window()
    d["spec"] = {
        "identical": _identical(plain["outs"], sp[False]["outs"])
        and _identical(plain["outs"], sp[True]["outs"]),
        "padding_waste_ratio_packed": sp[True]["res"]["padding_waste_ratio"],
        "padding_waste_ratio_unpacked":
            sp[False]["res"]["padding_waste_ratio"],
        "packed": sp[True]["res"], "unpacked": sp[False]["res"]}
    log(f"mixed_dense d {json.dumps(d)}")
    out["d"] = d
    if not d["spec"]["identical"]:
        problems.append("16d: the unpacked speculative server's tokens "
                        "differ")
    del ff, plain, spec, sp
    torch.cuda.empty_cache()

    # (f) fp32, TF32 off, depth 2, random weights
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        out["f"] = phase_mixed_fp32(seed, cfg, prompts, DraftModelDrafter,
                                    problems)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    out["seconds"] = time.monotonic() - t_phase
    log(f"mixed_dense seconds {out['seconds']}")
    if problems:
        raise AssertionError("phase 16: " + "; ".join(problems))
    return out


def phase_mixed_fp32(seed, cfg, prompts, drafter_cls, problems) -> dict:
    """Phase 16 (f): see phase_mixed_dense. A failed check is appended to
    `problems`."""
    cfg2 = dataclasses.replace(cfg, layers=2)
    V = cfg.vocab_size
    ff = FFModel(FFConfig(batch_size=1, seed=seed, device=DEVICE))
    build_llama(ff, cfg2, batch_size=1, seq_len=2048, dtype=DataType.FLOAT)
    ff.compile()
    first = serve_closed(ff, V, prompts, 64, seed=seed)
    lookup = lookup_prompts(prompts, first["outs"])
    mixed = {"megastep_ticks": MEGASTEP_TICKS, "megastep_mixed": True}
    toks, res = {}, {}
    for name, kw in (
            ("one_tick", {}), ("mixed", mixed),
            ("mixed_spec", {"speculate": SPEC_CONFIG, **mixed}),
            ("unpacked", {"ragged_pack": False}),
            ("spec_draft_model", {"speculate": SpecConfig(
                drafter=drafter_cls(ff), depth=SPEC_CONFIG.depth)})):
        r = serve_closed(ff, V, lookup, 64, seed=seed, **kw)
        _launches_ok(f"16f {name}", r, 2)
        toks[name], res[name] = r["outs"], r["res"]
    toks["generate"] = [ff.generate(p[None], max_new_tokens=64)[0]
                        for p in lookup]
    cut = [p[:len(p) // INT8_PAIR_CHUNK * INT8_PAIR_CHUNK] for p in lookup]
    for name, kw in (("int8_one_tick", {}), ("int8_mixed", mixed)):
        r = serve_closed(ff, V, cut, 64, seed=seed, kv_dtype="int8",
                         prefill_chunk=INT8_PAIR_CHUNK, **kw)
        _launches_ok(f"16f {name}", r, 2)
        toks[name], res[name] = r["outs"], r["res"]
    f = {"res": res, "identical": {
        f"one_tick={k}": _identical(toks["one_tick"], toks[k])
        for k in ("mixed", "mixed_spec", "unpacked", "generate",
                  "spec_draft_model")}}
    f["identical"]["int8_one_tick=int8_mixed"] = _identical(
        toks["int8_one_tick"], toks["int8_mixed"])
    f["equal_share"] = {
        pair: _same_share(toks[pair.split("=")[0]], toks[pair.split("=")[1]])
        for pair in f["identical"]}
    dm = res["spec_draft_model"]["speculative"]
    f["draft_model"] = {k: dm[k] for k in (
        "steps", "draft_tokens", "accepted_tokens", "acceptance_rate")}
    log(f"mixed_dense f {json.dumps(f)}")
    del ff
    torch.cuda.empty_cache()
    if not all(f["identical"].values()):
        problems.append(f"16f: identical {f['identical']}, shares "
                        f"{f['equal_share']}")
    return f


# ---------------------------------------------------------------------------
# phase 17: Mixtral-8x7B's widths trained through K1/K2 and served paged
# through K3; remat="hidden" against "none" on bench_1b

# 17a: depth 2 of 32 (2.225 B parameters: fp32 masters, gradients and
# Adam's moments ~35.6 GB, depth 3 would pass 60 GB), bf16, batch 2 x
# 2048, MIXTRAL_STEPS fit steps on one repeated batch, the last
# MIXTRAL_TIMED timed
MIXTRAL_TRAIN_LAYERS, MIXTRAL_BATCH, MIXTRAL_SEQ = 2, 2, 2048
MIXTRAL_STEPS, MIXTRAL_TIMED = 6, 3
# 17b: serve_generation(paged=True)'s settings and traffic: 8 prompts of
# 64..512 tokens from the seed, 64 new tokens each, greedy
MIXTRAL_SERVE = dict(slots=4, max_len=2048, page_size=64, prefill_chunk=64)
MIXTRAL_PROMPTS, MIXTRAL_PROMPT_MIN, MIXTRAL_PROMPT_MAX, MIXTRAL_NEW = (
    8, 64, 512, 64)
# what a serving step needs on the card beside its weights and its pool
# (activations, the (B, S, vocab) probabilities, the allocator's slack)
MIXTRAL_SERVE_MARGIN_GB = 4.0


def free_card() -> float:
    """Collect what earlier phases left in reference cycles (a server and
    its loop thread keep each other, and with them a model's weights),
    return the cached blocks, and give the GB still allocated."""
    gc.collect()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated() / 1e9


def mixtral_param_count(cfg) -> dict:
    """Parameters of the repo's Mixtral (two expert matrices, no w3 gate):
    per layer and in all."""
    hd = cfg.dim // cfg.heads
    layer = (cfg.dim * cfg.heads * hd + 2 * cfg.dim * cfg.kv_heads * hd
             + cfg.heads * hd * cfg.dim + cfg.dim * cfg.n_experts
             + 2 * cfg.n_experts * cfg.dim * cfg.hidden + 2 * cfg.dim)
    other = 2 * cfg.vocab_size * cfg.dim + cfg.dim
    return {"per_layer": layer, "other": other,
            "total": cfg.layers * layer + other}


def mixtral_flops_per_token(cfg, seq: int) -> float:
    """ACTIVE matmul FLOPs per trained token, forward and backward:
    attention's projections, the router, k of the n experts and the lm
    head, plus causal attention at half density, as
    llama_flops_per_token counts a dense model."""
    hd = cfg.dim // cfg.heads
    per_layer = (cfg.dim * cfg.heads * hd + 2 * cfg.dim * cfg.kv_heads * hd
                 + cfg.heads * hd * cfg.dim + cfg.dim * cfg.n_experts
                 + cfg.top_k * 2 * cfg.dim * cfg.hidden)
    n_matmul = cfg.layers * per_layer + cfg.dim * cfg.vocab_size
    return 6.0 * n_matmul + 6.0 * cfg.layers * seq * cfg.dim


def phase_mixtral_train(seed: int, card: str) -> dict:
    """17a: Mixtral-8x7B's widths (dim 4096, 32 heads over 8, FFN 14336, 8
    experts top-2, alpha 1.25, lambda 1e-2, vocab 32000) at depth 2, bf16,
    batch 2 x 2048, Adam lr 1e-4, through ff.fit one step at a time on
    one repeated batch of Zipf-distributed ids (zipf_tokens; each fit's
    loss is its step's; counts reset just
    before the first, read just after the last): the loss must be finite
    and fall, and K1, K2 dq and K2 dk/dv launch once a layer and step."""
    cfg = mixtral_8x7b(MIXTRAL_TRAIN_LAYERS)
    held_gb = free_card()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    ff = _train_model(cfg, DEVICE, batch=MIXTRAL_BATCH, seq=MIXTRAL_SEQ,
                      dtype=DataType.BFLOAT16, remat="none", seed=seed)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    x, y = zipf_tokens(MIXTRAL_BATCH, MIXTRAL_SEQ, cfg.vocab_size, seed)
    losses, step_s, dropped = [], [], []
    _reset_launches()
    with RouteRecorder() as routes:
        for i in range(MIXTRAL_STEPS):
            routes.calls.clear()
            t0 = time.perf_counter()
            pm = ff.fit(x, y, epochs=1, verbose=False)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            losses.append(pm.sparse_cce_loss / pm.train_all)
            dropped.append(routes.dropped())
        cap = routes.calls[0][3]
    fit_launches = _flash_launches()
    timed = step_s[-MIXTRAL_TIMED:]
    step = sum(timed) / len(timed)
    tokens = MIXTRAL_BATCH * MIXTRAL_SEQ
    flops = mixtral_flops_per_token(cfg, MIXTRAL_SEQ) * tokens
    res = {
        "model": "mixtral_8x7b", "layers": cfg.layers, "of_layers": 32,
        "dtype": "bfloat16", "batch": MIXTRAL_BATCH, "seq": MIXTRAL_SEQ,
        "remat": "none",
        "params": sum(t.numel() for w in ff._params[0].values()
                      for t in w.values()),
        "init_s": init_s, "losses": losses, "step_s": step_s,
        "timed_steps": len(timed), "step_ms": step * 1e3,
        "tokens_per_s": tokens / step, "active_flops_per_step": flops,
        "mfu_active": flops / step / PEAK_OPS[torch.bfloat16],
        "expert_capacity": cap,
        "expert_rows_computed_over_active":
            cfg.n_experts * cap / (tokens * cfg.top_k),
        "dropped_pairs_by_step": dropped,
        "dropped_share_by_step": [
            n / (tokens * cfg.top_k * cfg.layers) for n in dropped],
        "fit_launches": fit_launches, "held_before_gb": held_gb,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "card": card,
    }
    log(f"mixtral_train {json.dumps(res)}")
    del ff
    torch.cuda.empty_cache()
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"Mixtral loss did not fall: {losses}")
    want = cfg.layers * MIXTRAL_STEPS
    if any(n != want for n in fit_launches.values()):
        raise AssertionError(f"Mixtral fit launches {fit_launches} != "
                             f"{want} each")
    return res


def mixtral_serve_layers(cfg, num_pages: int) -> dict:
    """The reckoning of 17b's depth: the bf16 weights and the pool of
    `num_pages` pages at each depth against the card's free memory less
    MIXTRAL_SERVE_MARGIN_GB; the deepest that fits, up to all 32
    layers."""
    free, total = torch.cuda.mem_get_info()
    counts = mixtral_param_count(cfg)
    hd = cfg.dim // cfg.heads
    page_layer = MIXTRAL_SERVE["page_size"] * 2 * cfg.kv_heads * hd * 2

    def need(layers):
        return (2 * (layers * counts["per_layer"] + counts["other"])
                + num_pages * page_layer * layers)

    room = free - MIXTRAL_SERVE_MARGIN_GB * 1e9
    layers = max([n for n in range(1, cfg.layers + 1) if need(n) <= room],
                 default=1)
    return {"free_gb": free / 1e9, "total_gb": total / 1e9,
            "margin_gb": MIXTRAL_SERVE_MARGIN_GB,
            "weights_gb_32": 2 * (32 * counts["per_layer"]
                                  + counts["other"]) / 1e9,
            "pool_gb_32": num_pages * page_layer * 32 / 1e9,
            "params_32": 32 * counts["per_layer"] + counts["other"],
            "layers": layers, "weights_gb": 2 * (
                layers * counts["per_layer"] + counts["other"]) / 1e9}


def phase_mixtral_serve(seed: int, card: str) -> dict:
    """17b: Mixtral-8x7B's widths, bf16, all 32 layers (or the depth
    mixtral_serve_layers' reckoning allows), random weights from the seed,
    through serve_generation(paged=True) at MIXTRAL_SERVE: 8 prompts of
    64..512 tokens, 64 new each, greedy; counts reset just before, read
    just after; K3 once per layer and ragged step. Then a profiled
    steady decode step (4 slots at pos 1024): wall and device ms."""
    cfg = mixtral_8x7b()
    num_pages = MIXTRAL_SERVE["slots"] * (
        MIXTRAL_SERVE["max_len"] // MIXTRAL_SERVE["page_size"]) + 1
    held_gb = free_card()
    reckoning = mixtral_serve_layers(cfg, num_pages)
    reckoning["held_before_gb"] = held_gb
    log(f"mixtral_serve reckoning {json.dumps(reckoning)}")
    cfg = mixtral_8x7b(reckoning["layers"])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    ff = FFModel(FFConfig(batch_size=1, seed=seed, device=DEVICE))
    build_mixtral(ff, cfg, batch_size=1, seq_len=MIXTRAL_SERVE["max_len"],
                  dtype=DataType.BFLOAT16)
    ff.compile()
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    rs = np.random.RandomState(seed)
    lens = rs.randint(MIXTRAL_PROMPT_MIN, MIXTRAL_PROMPT_MAX + 1,
                      size=MIXTRAL_PROMPTS)
    prompts = [rs.randint(0, cfg.vocab_size, (n,)).astype(np.int32)
               for n in lens]
    server = ff.serve_generation(paged=True, seed=seed, **MIXTRAL_SERVE)
    try:
        server.generate(prompts[0][:16], max_new_tokens=2, timeout=600)
        steps0, served0 = server.ragged_steps, server.requests_served
        _reset_launches()
        t1 = time.monotonic()
        futs = [server.submit(p, max_new_tokens=MIXTRAL_NEW)
                for p in prompts]
        outs = [f.result(timeout=900) for f in futs]
        wall = time.monotonic() - t1
        launches = {k.name: k.launches for k in KERNELS}
        steps = server.ragged_steps - steps0
        recs = server.metrics()["requests"][served0:]
    finally:
        server.stop()
    del server
    torch.cuda.empty_cache()
    for o in outs:
        if len(o) != MIXTRAL_NEW or not (
                (0 <= o) & (o < cfg.vocab_size)).all():
            raise AssertionError(f"bad output {o}")
    if launches[RAGGED_PAGED_ATTENTION.name] != cfg.layers * steps \
            or steps == 0:
        raise AssertionError(f"launches {launches} != {cfg.layers} x "
                             f"{steps}")
    ttft = sorted(r["ttft_s"] for r in recs)
    # a steady decode step, profiled: 4 slots at pos 1024 on a fresh pool
    ex = ff.executor
    tr, ntr = ff._params
    caches = ex.init_paged_kv_cache(NUM_PAGES, P)
    args = _decode_launch(DEVICE, cfg.vocab_size, rs)
    for _ in range(2):
        ex.ragged_step_fn(tr, ntr, caches, *args)
    torch.cuda.synchronize()
    n = 3
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            ex.ragged_step_fn(tr, ntr, caches, *args)
        torch.cuda.synchronize()
        prof_wall = (time.perf_counter() - t0) / n * 1e3
    decode = _profile_summary(prof, n, prof_wall)
    # a decode tick reads every weight but the embedding table (each
    # expert takes >= 1 row): its least time is those bytes over the HBM
    # rate
    bytes_read = sum(t.numel() * t.element_size() for k, w in tr.items()
                     if not k.startswith("tok_emb") for t in w.values())
    res = {
        "model": "mixtral_8x7b", "layers": cfg.layers, "dtype": "bfloat16",
        "reckoning": reckoning, "requests": len(outs),
        "prompt_lens": lens.tolist(), "new_tokens": MIXTRAL_NEW,
        "ragged_steps": steps, "launches": launches, "wall_s": wall,
        "generated_tokens_per_s": MIXTRAL_NEW * len(outs) / wall,
        "ttft_p50_s": ttft[len(ttft) // 2], "ttft_max_s": ttft[-1],
        "decode_step": {k: decode[k] for k in (
            "wall_ms", "device_ms", "idle_share", "device_launches",
            "top")},
        "decode_floor_ms": bytes_read / HBM_BYTES_PER_S * 1e3,
        "init_s": init_s,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "card": card,
    }
    log(f"mixtral_serve {json.dumps(res)}")
    del ff, ex, tr, ntr, caches
    torch.cuda.empty_cache()
    return res


def phase_remat_hidden(seed: int, card: str) -> dict:
    """17c: bench_1b at phase 6's shape (16 layers, bf16, batch 8, seq
    1024, Adam lr 1e-4) under remat="none" and remat="hidden" (each
    SwiGLU MLP recomputed in backward): three train steps on one batch
    each, peak memory and the mean ms of the last two; the first step's
    loss must agree within the bf16 TOLS."""
    cfg = LlamaConfig.bench_1b()
    x, y = _token_batches(TRAIN_BATCH, TRAIN_SEQ, cfg.vocab_size, seed)
    res = {"model": "bench_1b", "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
           "card": card}
    for remat in ("none", "hidden"):
        res[f"held_before_gb_{remat}"] = free_card()
        torch.cuda.reset_peak_memory_stats()
        ff = _train_model(cfg, DEVICE, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                          dtype=DataType.BFLOAT16, remat=remat, seed=seed)
        ex = ff.executor
        tr, ntr = ff._params
        opt = ff._opt_state
        bx, by = (torch.from_numpy(a).to(DEVICE) for a in (x, y))
        losses, times = [], []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tr, ntr, opt, m = ex.train_step(tr, ntr, opt, by, bx)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(float(m["loss"]))
        res[remat] = {"losses": losses,
                      "step_ms": sum(times[1:]) / 2 * 1e3,
                      "groups": len(ex.remat_groups),
                      "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
        del ff, ex, tr, ntr, opt, m
    torch.cuda.empty_cache()
    _, rtol = TOLS[torch.bfloat16]
    a, b = res["none"]["losses"][0], res["hidden"]["losses"][0]
    res["first_loss_rel_diff"] = abs(a - b) / abs(a)
    res["rtol"] = rtol
    log(f"remat_hidden {json.dumps(res)}")
    if res["first_loss_rel_diff"] > rtol \
            or res["hidden"]["groups"] != cfg.layers \
            or not all(np.isfinite(res["hidden"]["losses"])):
        raise AssertionError(f"remat='hidden' run: {res}")
    return res


def phase_mixtral(seed: int, card: str) -> dict:
    t0 = time.monotonic()
    res = {"a": phase_mixtral_train(seed, card),
           "b": phase_mixtral_serve(seed, card),
           "c": phase_remat_hidden(seed, card)}
    log(f"mixtral seconds {time.monotonic() - t0}")
    return res


# ---------------------------------------------------------------------------
# phase 18 (and phase 3's zoo checks): the model zoo on the card

# the zoo's cells: a fit of ZOO_STEPS steps on one repeated batch (Adam
# lr ZOO_LR), so the loss must fall. BERT takes BERT_LR, the bottom of
# its paper's fine-tuning range (arXiv:1810.04805: 5e-5, 3e-5, 2e-5):
# with no warmup, Adam's first steps move every weight by about lr, and
# the 12 post-LayerNorm layers of random BERT-base swing the loss on one
# repeated batch from 1.31 to 8.03 at 1e-4 and to 6.24 at 5e-5, ending
# above where they began (H100 80GB HBM3, 700 W)
ZOO_STEPS, ZOO_LR, BERT_LR = 10, 1e-4, 2e-5
BERT_BATCH, BERT_SEQ = 32, 512
ENCDEC_BATCH, ENCDEC_SRC, ENCDEC_TGT = 32, 256, 200
RESNET_BATCH, RESNET_IMAGE, RESNET_CLASSES = 64, 224, 1000
NMT_BATCH, NMT_SRC, NMT_TGT = 64, 32, 32
DLRM_BATCH, DLRM_VOCAB = 2048, 1000000
# K4 at the zoo's attention shapes (B·H, S, T, D, causal), in fp32 as the
# models run them (BERT declared bf16 runs fp32 from its position add on,
# the table being stored fp32, as the reference computes it; the
# Transformer builder fixes fp32): BERT-base's, and the encoder's,
# the decoder's causal self-attention and its cross-attention (S 200 !=
# T 256) at TransformerConfig()
K4_ZOO_CASES = (
    ("bert_base", BERT_BATCH * 12, BERT_SEQ, BERT_SEQ, 64, False),
    ("encdec_self", ENCDEC_BATCH * 8, ENCDEC_SRC, ENCDEC_SRC, 64, False),
    ("encdec_causal", ENCDEC_BATCH * 8, ENCDEC_TGT, ENCDEC_TGT, 64, True),
    ("encdec_cross", ENCDEC_BATCH * 8, ENCDEC_TGT, ENCDEC_SRC, 64, False),
)
# phase 3's encoder-decoder and ResNet-50 checks compare the step's
# gradients (and ResNet's moved running statistics), not weights after
# an optimizer step. Adam's first step (lr * g / (|g| + 1e-8)) does not
# fit phase_train_step's bounds for the encoder-decoder: its encoder's
# gradients peak near 1e-5 (the query and key projections' near 2e-8),
# so many entries sit where eps sets the step, and a 1e-9 summation-order
# difference in g moves a weight by 1e-5 (H100 80GB HBM3, 700 W: 2933 of
# 7.35 M weights past 1e-5, the loss equal to 8e-8); and an SGD step's
# update, read back as the difference of two fp32 weights, carries the
# weights' rounding (1 / 316 of a 1e-6 update). Leaves whose CPU
# gradient is below ZOO_GRAD_NOISE of the model's largest are zero in
# exact arithmetic (a key bias, a conv bias before BatchNorm) and must
# stay below ten times that on the card; every other leaf is held to
# ZOO_GRAD_RTOL of its largest entry (the encoder-decoder), or by its
# direction (ResNet-50). Random-init ResNet-50's fp32 gradients are
# ill-conditioned: against a float64 evaluation of the graph, PyTorch's
# own fp32 CPU gradients are off by up to 14% of a leaf's largest entry
# (64x64, batch 16), so no elementwise bound holds between two fp32
# runs; each leaf must point the CPU's way (cosine >= ZOO_RESNET_COS).
# Its forward drifts by summation order through 50 layers (two CPU
# backends: 2.5e-4 of the logits' largest entry), so its loss takes
# ZOO_RESNET_LOSS_RTOL and its moved running statistics
# ZOO_RESNET_STAT_TOL (abs and rel)
ZOO_GRAD_NOISE, ZOO_GRAD_RTOL = 1e-6, 1e-4
ZOO_RESNET_COS, ZOO_RESNET_LOSS_RTOL, ZOO_RESNET_STAT_TOL = 0.995, 1e-4, 1e-3


def _route_launches() -> dict:
    """Each kernel's launches and the dense dropout route's calls."""
    out = {k.name: k.launches for k in KERNELS}
    route = torch_ops.DENSE_DROPOUT_ATTENTION
    out[route.name] = route.launches
    return out


def _reset_routes():
    _reset_launches()
    torch_ops.DENSE_DROPOUT_ATTENTION.launches = 0


def _k4_route(launches: dict) -> dict:
    return {k: launches[k] for k in (
        FLASH_ATTENTION_BH_FWD.name, FLASH_ATTENTION_BH_DQ.name,
        FLASH_ATTENTION_BH_DKV.name, torch_ops.DENSE_DROPOUT_ATTENTION.name)}


def zoo_fit(ff, xs, y, steps: int = ZOO_STEPS) -> dict:
    """ff.fit over `steps` copies of one batch, the main path: kernel and
    route counts reset just before, read just after. A wrapper of the
    executor's train_step records each step's loss (a tensor on the
    card, read after the fit) and CUDA events around it; step_ms is the
    events' mean over steps 2..n (the first pays one-time setup)."""
    ex = ff.executor
    step = ex.train_step
    losses, events = [], []

    def recorded(*args, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = step(*args, **kw)
        end.record()
        losses.append(out[3]["loss"])
        events.append((start, end))
        return out

    xs = [np.concatenate([a] * steps) for a in xs]
    y = np.concatenate([y] * steps)
    ex.train_step = recorded
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_routes()
    t0 = time.perf_counter()
    try:
        pm = ff.fit(xs, y, epochs=1, verbose=False)
        torch.cuda.synchronize()
    finally:
        del ex.train_step
    wall = time.perf_counter() - t0
    return {"steps": len(losses), "samples": pm.train_all,
            "losses": [float(v) for v in losses],
            "step_ms": events[1][0].elapsed_time(events[-1][1])
            / (len(events) - 1),
            "fit_s": wall, "launches": _route_launches(),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}


def _falls(label: str, losses, problems: list):
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        problems.append(f"{label}: the loss on a repeated batch did not "
                        f"fall: {losses}")


def _want_routes(label, launches, want: dict, problems: list):
    got = _k4_route(launches)
    if got != want:
        problems.append(f"{label}: K4 / dense-route launches {got}, want "
                        f"{want}")


def _k4_want(fwd: int, bwd: int, dense: int) -> dict:
    return {FLASH_ATTENTION_BH_FWD.name: fwd, FLASH_ATTENTION_BH_DQ.name: bwd,
            FLASH_ATTENTION_BH_DKV.name: bwd,
            torch_ops.DENSE_DROPOUT_ATTENTION.name: dense}


def bert_flops_per_token(cfg, seq: int) -> float:
    """Matmul FLOPs per trained token, forward and backward: the four
    attention projections and the two MLP matrices a layer, and the
    non-causal scores and value products over `seq` keys (the embedding
    lookup and the 2-class head left out), as llama_flops_per_token
    counts a Llama's."""
    per_layer = 4 * cfg.hidden * cfg.hidden + 2 * cfg.hidden \
        * cfg.intermediate
    return 6.0 * cfg.layers * per_layer + 12.0 * cfg.layers * seq \
        * cfg.hidden


def _zoo_model(build, loss_type, batch, seed, metrics=(),
               lr=ZOO_LR) -> FFModel:
    ff = FFModel(FFConfig(batch_size=batch, seed=seed, device=DEVICE,
                          remat="none"))
    build(ff)
    return ff.compile(optimizer=AdamOptimizer(lr=lr),
                      loss_type=loss_type, metrics=list(metrics))


def phase_zoo_bert(seed: int, problems: list) -> dict:
    """18a: BERT-base (BertConfig(): 12 x 768, 12 heads of 64, FFN 3072,
    vocab 30522) at batch 32 x seq 512, declared bf16, remat none: fit at
    the reference's attention dropout 0.1 (the dense route once a layer
    and step, K4 never), eval and predict (K4's forward once a layer a
    call, the dense route never), then a fresh model fit at dropout 0
    (K4's forward, dq and dk/dv once a layer and step)."""
    cfg = BertConfig()
    rs = np.random.RandomState(seed)
    x = rs.randint(0, cfg.vocab_size, (BERT_BATCH, BERT_SEQ)).astype(
        np.int32)
    y = rs.randint(0, cfg.num_classes, BERT_BATCH).astype(np.int32)
    tokens = BERT_BATCH * BERT_SEQ
    flops = bert_flops_per_token(cfg, BERT_SEQ) * tokens
    res = {"model": "bert_base", "batch": BERT_BATCH, "seq": BERT_SEQ,
           "declared": "bfloat16", "runs": "float32 after add_pos",
           "flops_per_step": flops}
    n = cfg.layers * ZOO_STEPS
    for dropout in (cfg.dropout, 0.0):
        free_card()
        ff = _zoo_model(lambda f: build_bert(
            f, dataclasses.replace(cfg, dropout=dropout),
            batch_size=BERT_BATCH, seq_len=BERT_SEQ,
            dtype=DataType.BFLOAT16),
            LossType.SPARSE_CATEGORICAL_CROSSENTROPY, BERT_BATCH, seed,
            metrics=[MetricsType.ACCURACY], lr=BERT_LR)
        fit = zoo_fit(ff, [x], y)
        fit.update(tokens_per_s=tokens / fit["step_ms"] * 1e3,
                   mfu=flops / (fit["step_ms"] / 1e3)
                   / PEAK_OPS[torch.bfloat16])
        label = f"bert dropout {dropout}"
        _falls(label, fit["losses"], problems)
        _want_routes(label, fit["launches"],
                     _k4_want(0, 0, n) if dropout else _k4_want(n, n, 0),
                     problems)
        res[f"fit_dropout_{dropout}"] = fit
        if dropout:
            _reset_routes()
            pm = ff.eval(x, y, verbose=False)
            probs = ff.predict(x)
            torch.cuda.synchronize()
            launches = _route_launches()
            res["eval_predict"] = {
                "launches": _k4_route(launches),
                "accuracy": pm.train_correct / max(pm.train_all, 1),
                "shape": list(probs.shape),
                "finite": bool(np.isfinite(probs).all()),
                "row_sum_err": float(np.abs(probs.sum(-1) - 1).max())}
            _want_routes("bert eval + predict", launches,
                         _k4_want(2 * cfg.layers, 0, 0), problems)
            if not res["eval_predict"]["finite"] \
                    or res["eval_predict"]["row_sum_err"] > 1e-4 \
                    or probs.shape != (BERT_BATCH, cfg.num_classes):
                problems.append(f"bert predict: {res['eval_predict']}")
        del ff
    return res


def phase_zoo_encdec(seed: int, problems: list) -> dict:
    """18b: the encoder-decoder Transformer at TransformerConfig() (512
    wide, 8 heads of 64, FFN 2048, 6 + 6 layers, fp32 as the builder
    fixes it), src 256, tgt 200, batch 32, MSE as the reference example
    trains it: K4's fp32 (3xTF32) bodies on the encoder's non-causal
    self-attention, the decoder's causal one and its cross-attention
    (S 200 != T 256), each once a layer and step."""
    cfg = TransformerConfig()
    rs = np.random.RandomState(seed + 1)
    src = rs.randn(ENCDEC_BATCH, ENCDEC_SRC, cfg.dim).astype(np.float32)
    tgt = rs.randn(ENCDEC_BATCH, ENCDEC_TGT, cfg.dim).astype(np.float32)
    y = rs.randn(ENCDEC_BATCH, ENCDEC_TGT, 1).astype(np.float32)
    free_card()
    ff = _zoo_model(lambda f: build_transformer_encoder_decoder(
        f, cfg, batch_size=ENCDEC_BATCH, src_len=ENCDEC_SRC,
        tgt_len=ENCDEC_TGT), LossType.MEAN_SQUARED_ERROR_AVG_REDUCE,
        ENCDEC_BATCH, seed)
    fit = zoo_fit(ff, [src, tgt], y)
    tokens = ENCDEC_BATCH * (ENCDEC_SRC + ENCDEC_TGT)
    fit.update(model="transformer_encoder_decoder", batch=ENCDEC_BATCH,
               src=ENCDEC_SRC, tgt=ENCDEC_TGT, dtype="float32",
               tokens_per_s=tokens / fit["step_ms"] * 1e3)
    n = 3 * cfg.layers * ZOO_STEPS
    _falls("encoder-decoder", fit["losses"], problems)
    _want_routes("encoder-decoder", fit["launches"], _k4_want(n, n, 0),
                 problems)
    del ff
    return fit


def phase_zoo_resnet(seed: int, problems: list) -> dict:
    """18c: ResNet-50 at 224x224, batch 64, 1000 classes, fp32: every
    BatchNorm's running statistics must move in the fit, and predict must
    read them (its output differs from the same weights' under the
    initial statistics)."""
    rs = np.random.RandomState(seed + 2)
    x = rs.randn(RESNET_BATCH, 3, RESNET_IMAGE, RESNET_IMAGE).astype(
        np.float32)
    y = rs.randint(0, RESNET_CLASSES, RESNET_BATCH).astype(np.int32)
    free_card()
    ff = _zoo_model(lambda f: build_resnet50(
        f, batch_size=RESNET_BATCH, classes=RESNET_CLASSES,
        image_size=RESNET_IMAGE), LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
        RESNET_BATCH, seed)
    stats0 = {k: {n: t.clone() for n, t in w.items()}
              for k, w in ff._params[1].items()}
    fit = zoo_fit(ff, [x], y)
    tr, ntr = ff._params
    moved = sum(not torch.equal(ntr[k]["running_mean"],
                                stats0[k]["running_mean"])
                and not torch.equal(ntr[k]["running_var"],
                                    stats0[k]["running_var"])
                for k in stats0)
    p_trained = ff.predict(x)
    ff._params = (tr, stats0)
    p_initial = ff.predict(x)
    ff._params = (tr, ntr)
    fit.update(model="resnet50", batch=RESNET_BATCH, image=RESNET_IMAGE,
               dtype="float32", images_per_s=RESNET_BATCH
               / fit["step_ms"] * 1e3, batch_norms=len(stats0),
               stats_moved=moved,
               predict_stats_effect=float(np.abs(p_trained
                                                 - p_initial).max()),
               predict_finite=bool(np.isfinite(p_trained).all()))
    _falls("resnet50", fit["losses"], problems)
    if moved != len(stats0) or not fit["predict_stats_effect"] > 0 \
            or not fit["predict_finite"]:
        problems.append(f"resnet50 running statistics: {fit}")
    del ff, tr, ntr, stats0
    return fit


def phase_zoo_nmt(seed: int, problems: list) -> dict:
    """18d: the LSTM NMT at NMTConfig() (embeddings and hidden 1024, 2 + 2
    layers, 32000-word vocabularies), 32 + 32 tokens, batch 64, fp32."""
    cfg = NMTConfig()
    rs = np.random.RandomState(seed + 3)
    src = rs.randint(0, cfg.src_vocab, (NMT_BATCH, NMT_SRC)).astype(np.int32)
    tgt = rs.randint(0, cfg.tgt_vocab, (NMT_BATCH, NMT_TGT)).astype(np.int32)
    y = np.roll(tgt, -1, axis=1).astype(np.int32)
    free_card()
    ff = _zoo_model(lambda f: build_nmt(
        f, cfg, batch_size=NMT_BATCH, src_len=NMT_SRC, tgt_len=NMT_TGT),
        LossType.SPARSE_CATEGORICAL_CROSSENTROPY, NMT_BATCH, seed)
    fit = zoo_fit(ff, [src, tgt], y)
    fit.update(model="nmt", batch=NMT_BATCH, src=NMT_SRC, tgt=NMT_TGT,
               dtype="float32",
               tokens_per_s=NMT_BATCH * (NMT_SRC + NMT_TGT)
               / fit["step_ms"] * 1e3,
               target_tokens_per_s=NMT_BATCH * NMT_TGT / fit["step_ms"]
               * 1e3)
    _falls("nmt", fit["losses"], problems)
    del ff
    return fit


def phase_zoo_dlrm(seed: int, problems: list) -> dict:
    """18e: DLRM at build_dlrm's defaults (8 tables of 1 M x 64 fp32, a
    13-wide dense input, MLPs 512-256-64 and 512-256-1), batch 2048,
    MSE."""
    rs = np.random.RandomState(seed + 4)
    xs = [rs.randn(DLRM_BATCH, 13).astype(np.float32)] + [
        rs.randint(0, DLRM_VOCAB, (DLRM_BATCH, 1)).astype(np.int32)
        for _ in range(8)]
    y = rs.rand(DLRM_BATCH, 1).astype(np.float32)
    free_card()
    ff = _zoo_model(lambda f: build_dlrm(f, vocab=DLRM_VOCAB,
                                         batch_size=DLRM_BATCH),
                    LossType.MEAN_SQUARED_ERROR_AVG_REDUCE, DLRM_BATCH, seed)
    fit = zoo_fit(ff, xs, y)
    fit.update(model="dlrm", batch=DLRM_BATCH, dtype="float32",
               params=sum(t.numel() for w in ff._params[0].values()
                          for t in w.values()),
               samples_per_s=DLRM_BATCH / fit["step_ms"] * 1e3)
    _falls("dlrm", fit["losses"], problems)
    del ff
    return fit


def phase_zoo(seed: int, card: str) -> dict:
    """Phase 18. Runs with PyTorch's default precision flags (fp32
    matmuls in fp32, cuDNN's fp32 convolutions in TF32), set here and
    restored after; collects every sub-phase's problems and raises at
    the end. The kernels line records K4's launches of (a) and (b) and
    its times at their shapes (K4_ZOO_CASES)."""
    t0 = time.monotonic()
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    problems: list = []
    res = {"card": card, "matmul_tf32": False, "cudnn_tf32": True}
    try:
        for key, fn in (("a", phase_zoo_bert), ("b", phase_zoo_encdec),
                        ("c", phase_zoo_resnet), ("d", phase_zoo_nmt),
                        ("e", phase_zoo_dlrm)):
            res[key] = fn(seed, problems)
            log(f"zoo_{key} {json.dumps(res[key])}")
        free_card()
        timed = {}
        for i, (case, BH, S, T, D, causal) in enumerate(K4_ZOO_CASES):
            r = k4_check(BH, S, T, D, causal, torch.float32, seed + 10 + i,
                         timed=True)
            timed[case] = r
            if not all(v["ok"] for v in r.values()):
                problems.append(f"K4 at {case}: {r}")
        res["k4"] = timed
        log(f"zoo_k4 {json.dumps(timed)}")
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
    res["seconds"] = time.monotonic() - t0
    log(f"zoo seconds {res['seconds']}")
    if problems:
        raise AssertionError(f"phase 18: {problems}")
    return res


def _zoo_step_check(label, build, loss_type, xs, y, seed, optimizer,
                    grads: bool = False):
    """One train step of a zoo model at fp32 with TF32 off, the card
    against the CPU from the same seeded weights: the loss, and every
    parameter after the step (with `grads` every gradient of the step
    instead) and the non-trainable tree after it, and the card's K4
    launches. Returns (result, card leaves, CPU leaves, card and CPU
    non-trainable leaves), leaves keyed "node key/weight name"."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card_ff = FFModel(FFConfig(batch_size=len(y), seed=seed, device=DEVICE,
                               remat="none"))
    build(card_ff)
    card_ff.compile(optimizer=optimizer(), loss_type=loss_type)
    cpu_ff = FFModel(FFConfig(batch_size=len(y), seed=seed, device="cpu",
                              remat="none"))
    build(cpu_ff)
    cpu_ff.compile(optimizer=optimizer(), loss_type=loss_type,
                   params=tuple({k: {n: t.cpu() for n, t in w.items()}
                                 for k, w in tree.items()}
                                for tree in card_ff._params))
    out = []
    for ff in (card_ff, cpu_ff):
        ex = ff.executor
        tr, ntr = ff._params
        by = torch.from_numpy(y).to(ex.device)
        bx = [torch.from_numpy(a).to(ex.device) for a in xs]
        _reset_routes()
        if grads:
            state = {}
            loss, _, tr = ex.loss_and_grads(tr, ntr, by, *bx,
                                            state_out=state)
            ntr = merge_state(ntr, state)
        else:
            tr, ntr, _, m = ex.train_step(tr, ntr, ff._opt_state, by, *bx)
            loss = m["loss"]
        out.append((float(loss),
                    {f"{k}/{n}": t.cpu() for k, w in tr.items()
                     for n, t in w.items()},
                    {f"{k}/{n}": t.cpu() for k, w in ntr.items()
                     for n, t in w.items()}))
        if ff is card_ff:
            k4 = _k4_route(_route_launches())
    (gl, gp, gs), (cl, cp, cs) = out
    res = {"model": label, "loss_card": gl, "loss_cpu": cl,
           "loss_rel_err": abs(gl - cl) / abs(cl), "k4": k4,
           "weights": sum(t.numel() for t in cp.values())}
    del card_ff, cpu_ff
    torch.cuda.empty_cache()
    return res, gp, cp, gs, cs


def _grad_agreement(gp, cp):
    """Card gradients `gp` against CPU gradients `cp`, leaf by leaf: the
    least cosine and the largest error over the leaf's largest entry,
    over the leaves above ZOO_GRAD_NOISE of the largest gradient; and
    whether the card's stays below ten times that on every other leaf."""
    floor = ZOO_GRAD_NOISE * max(float(t.abs().max()) for t in cp.values())
    cos, rel, noise_ok = 1.0, 0.0, True
    for n in gp:
        want, got = cp[n].double().flatten(), gp[n].double().flatten()
        top = float(want.abs().max())
        if top <= floor:
            noise_ok &= float(got.abs().max()) <= 10 * floor
            continue
        cos = min(cos, float(got @ want / got.norm() / want.norm()))
        rel = max(rel, float((got - want).abs().max()) / top)
    return cos, rel, noise_ok


def phase_zoo_step(seed: int) -> dict:
    """Phase 3's zoo checks, fp32 with TF32 off, card against CPU: one
    Adam step (lr TRAIN_LR, phase_train_step's bounds) of BERT at
    BERT-base's widths, depth 2, dropout 0, seq 128, batch 2 (K4 twice
    a kernel), of the NMT at NMTConfig()'s widths, depth 1, batch 2, and
    of DLRM at a 10 k vocabulary, batch 256; the gradients of one step of
    the encoder-decoder at TransformerConfig()'s widths, depth 1, src
    256, tgt 200, batch 2 (K4 three times a kernel; ZOO_GRAD_RTOL), and
    of ResNet-50 at 64x64, batch 8, with its running statistics compared
    after the step (the ZOO_RESNET_* bounds)."""
    rs = np.random.RandomState(seed + 5)
    adam = lambda: AdamOptimizer(lr=TRAIN_LR)  # noqa: E731
    bert = dataclasses.replace(BertConfig(), layers=2, dropout=0.0)
    tcfg = dataclasses.replace(TransformerConfig(), layers=1)
    ncfg = dataclasses.replace(NMTConfig(), layers=1)
    cases = [
        ("bert_base_depth2", lambda f: build_bert(
            f, bert, batch_size=2, seq_len=128),
         LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
         [rs.randint(0, bert.vocab_size, (2, 128)).astype(np.int32)],
         rs.randint(0, 2, 2).astype(np.int32), 2),
        ("nmt_depth1", lambda f: build_nmt(f, ncfg, batch_size=2),
         LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
         [rs.randint(0, ncfg.src_vocab, (2, 32)).astype(np.int32),
          rs.randint(0, ncfg.tgt_vocab, (2, 32)).astype(np.int32)],
         rs.randint(0, ncfg.tgt_vocab, (2, 32)).astype(np.int32), 0),
        ("dlrm_vocab10k", lambda f: build_dlrm(f, vocab=10000,
                                               batch_size=256),
         LossType.MEAN_SQUARED_ERROR_AVG_REDUCE,
         [rs.randn(256, 13).astype(np.float32)]
         + [rs.randint(0, 10000, (256, 1)).astype(np.int32)
            for _ in range(8)],
         rs.rand(256, 1).astype(np.float32), 0),
    ]
    encdec = ("encdec_depth1", lambda f: build_transformer_encoder_decoder(
        f, tcfg, batch_size=2, src_len=ENCDEC_SRC, tgt_len=ENCDEC_TGT),
        LossType.MEAN_SQUARED_ERROR_AVG_REDUCE,
        [rs.randn(2, ENCDEC_SRC, tcfg.dim).astype(np.float32),
         rs.randn(2, ENCDEC_TGT, tcfg.dim).astype(np.float32)],
        rs.randn(2, ENCDEC_TGT, 1).astype(np.float32))
    out, problems = {}, []
    for label, build, loss, xs, y, k4_n in cases:
        res, gp, cp, _, _ = _zoo_step_check(label, build, loss, xs, y,
                                            seed, adam)
        diffs = {n: (gp[n] - cp[n]).abs() for n in gp}
        worst = max(diffs, key=lambda n: float(diffs[n].max()))
        outside = sum(int((d > TRAIN_PARAM_TOL * (1 + cp[n].abs())).sum())
                      for n, d in diffs.items())
        res.update(max_param_abs_err=float(diffs[worst].max()),
                   worst_param=worst, weights_outside_tol=outside)
        log(f"zoo_step {json.dumps(res)}")
        want = _k4_want(k4_n, k4_n, 0)
        if not (np.isfinite(res["loss_card"])
                and res["loss_rel_err"] <= TRAIN_LOSS_RTOL
                and res["max_param_abs_err"] <= 2 * TRAIN_LR
                and outside <= TRAIN_OUTLIER_FRACTION * res["weights"]
                and res["k4"] == want):
            problems.append(res)
        out[label] = res
    res, gp, cp, _, _ = _zoo_step_check(*encdec, seed, SGDOptimizer,
                                        grads=True)
    cos, rel, noise_ok = _grad_agreement(gp, cp)
    res.update(min_grad_cos=cos, max_grad_rel_err=rel,
               noise_leaves_ok=noise_ok, grad_rtol=ZOO_GRAD_RTOL)
    log(f"zoo_step {json.dumps(res)}")
    if not (np.isfinite(res["loss_card"])
            and res["loss_rel_err"] <= TRAIN_LOSS_RTOL
            and rel <= ZOO_GRAD_RTOL and noise_ok
            and res["k4"] == _k4_want(3, 3, 0)):
        problems.append(res)
    out["encdec_depth1"] = res
    x = rs.randn(8, 3, 64, 64).astype(np.float32)
    y = rs.randint(0, RESNET_CLASSES, 8).astype(np.int32)
    res, gp, cp, gs, cs = _zoo_step_check(
        "resnet50_64", lambda f: build_resnet50(f, batch_size=8,
                                                image_size=64),
        LossType.SPARSE_CATEGORICAL_CROSSENTROPY, [x], y, seed,
        SGDOptimizer, grads=True)
    cos, rel, noise_ok = _grad_agreement(gp, cp)
    stat_err = max(float(((gs[n] - cs[n]).abs()
                          / (1 + cs[n].abs())).max()) for n in cs)
    # the running means start at zeros: each must have moved
    means = [n for n in gs if n.endswith("/running_mean")]
    moved = sum(bool(gs[n].any()) for n in means)
    res.update(min_grad_cos=cos, max_grad_rel_err=rel,
               noise_leaves_ok=noise_ok, max_stat_err=stat_err,
               stats=len(cs), cos_bound=ZOO_RESNET_COS, loss_rtol=ZOO_RESNET_LOSS_RTOL,
               stat_tol=ZOO_RESNET_STAT_TOL)
    log(f"zoo_step {json.dumps(res)}")
    if not (np.isfinite(res["loss_card"])
            and res["loss_rel_err"] <= ZOO_RESNET_LOSS_RTOL
            and cos >= ZOO_RESNET_COS and noise_ok
            and stat_err <= ZOO_RESNET_STAT_TOL and moved == len(means)):
        problems.append(res)
    out["resnet50_64"] = res
    if problems:
        raise AssertionError(f"card zoo train steps disagree with CPU: "
                             f"{problems}")
    return out


# ---------------------------------------------------------------------------
# phase 19: the PIPELINE composite trained and decoded, BERT-base behind
# the batch server, the paged server behind http_serve with its request
# log and SLO

# the names build_llama gives the blocks' nodes and their leaves, by the
# PIPELINE composite's stacked leaf
PIPELINE_LEAVES = {"ln1": ("attn_norm", "scale"), "wq": ("attn", "wq"),
                   "wk": ("attn", "wk"), "wv": ("attn", "wv"),
                   "wo": ("attn", "wo"), "ln2": ("mlp_norm", "scale"),
                   "gate": ("gate", "kernel"), "up": ("up", "kernel"),
                   "down": ("down", "kernel")}
# 19b: FFModel.generate at Llama-3-8B's widths (all 32 layers, bf16),
# 4 prompts of 128 tokens, 64 new, greedy; the token identity check at
# depth 2 in fp32 (as phase 16f)
DECODE_PROMPTS, DECODE_PROMPT_LEN, DECODE_NEW = 4, 128, 64
# 19c: BERT-base served at the sequence length run_classifier.py uses by
# default; 256 requests of 1..4 rows from 8 client threads. The batcher
# runs the graph at the batch it was built for: BERT's [CLS] reshape
# (cls_flat) fixes the batch dim, in the reference's graph as in the
# port's, so every batch is padded to 32 rows
BATCH_SIZES, BATCH_DELAY_MS, BERT_SERVE_SEQ = (32,), 2.0, 128
BATCH_REQUESTS, BATCH_CLIENTS = 256, 8
# 19d: an SLO no request of phase 4's traffic meets (a prompt of 128 or
# more tokens is prefilled over at least two 64-row chunk ticks, each
# taking milliseconds), so the first completed request trips a breach
SLO_TTFT_P95_S = 1e-3
RECORD_LIMIT, REQLOG_CAPACITY = 4, 64


def stacked_llama_params(flat: FFModel, pipe: FFModel) -> tuple:
    """The (trainable, nontrainable) trees of `pipe`, a
    build_llama(use_pipeline=True) graph, from the leaves of `flat`, the
    unstacked build of the same config: each block leaf stacked on a
    leading layer dim, the embedding, final norm and head as they are.
    The stacked tensors are new; `flat` may be dropped after."""
    fkey = {n.name: n.stable_key() for n in flat.graph.nodes}
    pkey = {n.name: n.stable_key() for n in pipe.graph.nodes}
    ftr, fntr = flat._params
    layers = sum(1 for n in flat.graph.nodes if n.name.endswith("_attn"))
    tr = {pkey["decoder_pipeline"]: {
        leaf: torch.stack([ftr[fkey[f"l{i}_{node}"]][w]
                           for i in range(layers)])
        for leaf, (node, w) in PIPELINE_LEAVES.items()}}
    for name in ("tok_emb", "final_norm", "lm_head"):
        tr[pkey[name]] = {w: t.clone() for w, t in ftr[fkey[name]].items()}
    return tr, {}


def _pipeline_graph(cfg, batch, seq, dtype, seed) -> FFModel:
    """The PIPELINE build of `cfg`, not compiled (its node keys)."""
    ff = FFModel(FFConfig(batch_size=batch, seed=seed, device=DEVICE,
                          remat="none"))
    build_llama(ff, cfg, batch_size=batch, seq_len=seq, dtype=dtype,
                use_pipeline=True)
    return ff


def _timed_steps(ff, bx, by) -> dict:
    """TIMED_STEPS train steps on one repeated batch on the card: step ms
    (host clock over the steps, ending in a synchronize), tokens/s, peak
    GB and the losses."""
    ex = ff.executor
    tr, ntr = ff._params
    opt = ff._opt_state
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses = []
    t0 = time.perf_counter()
    for _ in range(TIMED_STEPS):
        tr, ntr, opt, m = ex.train_step(tr, ntr, opt, by, bx)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / TIMED_STEPS
    ff._params, ff._opt_state = (tr, ntr), opt
    return {"step_ms": step_s * 1e3,
            "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / step_s,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "losses": [float(v) for v in losses]}


def _recorded_fit(ff, x, y) -> tuple:
    """ff.fit over (x, y), one epoch, kernel counts reset just before and
    read just after; a wrapper of the executor's train_step records each
    step's loss (read after the fit). Returns (fit seconds, steps,
    losses, flash launches)."""
    ex = ff.executor
    step = ex.train_step
    losses = []

    def recorded(*args, **kw):
        out = step(*args, **kw)
        losses.append(out[3]["loss"])
        return out

    ex.train_step = recorded
    torch.cuda.synchronize()
    _reset_launches()
    t0 = time.monotonic()
    try:
        pm = ff.fit(x, y, epochs=1, verbose=False)
        torch.cuda.synchronize()
    finally:
        del ex.train_step
    return (time.monotonic() - t0, pm.train_all // TRAIN_BATCH,
            [float(v) for v in losses], _flash_launches())


def phase_pipeline_train(seed: int, problems: list) -> dict:
    """19a: bench_1b (16 layers, bf16, batch 8, seq 1024, remat="none",
    Adam lr 1e-4) built with use_pipeline=True on phase 6's weights (the
    unstacked build from the same seed, its leaves stacked by
    stacked_llama_params): ff.fit over the 10 seeded batches of phase 6
    (the main path: counts reset just before, read just after; K1, K2 dq
    and K2 dk/dv once a layer and step), then 10 timed steps on one
    repeated batch (the loss must fall); the unstacked build the same
    way first, re-timed in this run. The two fits' first losses (the
    same weights, the same batch) must agree within the bf16 TOLS."""
    cfg = LlamaConfig.bench_1b()
    x, y = _token_batches(TRAIN_BATCH * TRAIN_BATCHES, TRAIN_SEQ,
                          cfg.vocab_size, seed)
    bx, by = (torch.from_numpy(a[:TRAIN_BATCH]).to(DEVICE) for a in (x, y))
    free_card()
    flat = _train_model(cfg, DEVICE, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                        dtype=DataType.BFLOAT16, remat="none", seed=seed)
    pipe = _pipeline_graph(cfg, TRAIN_BATCH, TRAIN_SEQ, DataType.BFLOAT16,
                           seed)
    params = stacked_llama_params(flat, pipe)
    _, _, flat_losses, _ = _recorded_fit(flat, x, y)
    unstacked = _timed_steps(flat, bx, by)
    unstacked["fit_losses"] = flat_losses
    del flat
    free_card()
    pipe.compile(optimizer=AdamOptimizer(lr=TRAIN_LR),
                 loss_type=LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
                 metrics=[MetricsType.ACCURACY,
                          MetricsType.SPARSE_CATEGORICAL_CROSSENTROPY],
                 params=params)
    del params
    fit_s, fit_steps, fit_losses, fit_launches = _recorded_fit(pipe, x, y)
    stacked = _timed_steps(pipe, bx, by)
    flops = llama_flops_per_token(cfg, TRAIN_SEQ) * TRAIN_BATCH * TRAIN_SEQ
    res = {"model": "bench_1b", "layers": cfg.layers, "dtype": "bfloat16",
           "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "remat": "none",
           "fit_s": fit_s, "fit_steps": fit_steps,
           "fit_losses": fit_losses, "fit_launches": fit_launches,
           "launches_per_step": {k: n / TRAIN_BATCHES
                                 for k, n in fit_launches.items()},
           "first_loss_unstacked": flat_losses[0],
           "pipeline": stacked, "unstacked": unstacked,
           "step_ms_ratio": stacked["step_ms"] / unstacked["step_ms"],
           "mfu": flops / (stacked["step_ms"] / 1e3)
           / PEAK_OPS[torch.bfloat16]}
    del pipe
    free_card()
    log(f"pipeline_train {json.dumps(res)}")
    want = cfg.layers * TRAIN_BATCHES
    if any(n != want for n in fit_launches.values()) \
            or RAGGED_PAGED_ATTENTION.launches != 0:
        problems.append(f"19a: fit launches {fit_launches} != {want} each")
    rtol, atol = TOLS[torch.bfloat16]
    if not abs(fit_losses[0] - flat_losses[0]) <= \
            atol + rtol * abs(flat_losses[0]):
        problems.append(f"19a: first loss {fit_losses[0]} vs the unstacked "
                        f"build's {flat_losses[0]}")
    for label, losses in (("pipeline", stacked["losses"]),
                          ("unstacked", unstacked["losses"])):
        _falls(f"19a {label}", losses, problems)
    return res


def _generate_timed(ff, prompts, new: int) -> tuple:
    """FFModel.generate on the card after a 2-token warm-up generate (the
    allocator and cuBLAS's first calls off the clock): (tokens, ms a
    generated token)."""
    ff.generate(prompts, max_new_tokens=2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = ff.generate(prompts, max_new_tokens=new)
    return out, (time.perf_counter() - t0) / new * 1e3


def phase_pipeline_decode(seed: int, problems: list) -> dict:
    """19b: FFModel.generate through the PIPELINE composite's stacked
    dense cache ((32, 4, 1024, 8, 128) "k"/"v") at Llama-3-8B's widths,
    bf16, 4 prompts of 128 tokens, 64 new, greedy, beside the unstacked
    build on the same weights: ms a token and the share of tokens they
    agree on; then at depth 2 in fp32 the two must agree token for
    token; and serve_generation(paged=True) on the PIPELINE graph must
    raise the reference's ValueError."""
    res = {}
    rs = np.random.RandomState(seed)
    for label, layers, dtype in (("bf16", None, DataType.BFLOAT16),
                                 ("fp32_depth2", 2, DataType.FLOAT)):
        cfg = LlamaConfig.llama3_8b()
        if layers is not None:
            cfg = dataclasses.replace(cfg, layers=layers)
        prompts = rs.randint(0, cfg.vocab_size,
                             (DECODE_PROMPTS, DECODE_PROMPT_LEN)).astype(
                                 np.int32)
        free_card()
        flat = FFModel(FFConfig(batch_size=DECODE_PROMPTS, seed=seed,
                                device=DEVICE))
        build_llama(flat, cfg, batch_size=DECODE_PROMPTS, seq_len=2048,
                    dtype=dtype)
        flat.compile()
        _reset_launches()
        want, flat_ms = _generate_timed(flat, prompts, DECODE_NEW)
        pipe = _pipeline_graph(cfg, DECODE_PROMPTS, 2048, dtype, seed)
        params = stacked_llama_params(flat, pipe)
        del flat
        free_card()
        torch.cuda.reset_peak_memory_stats()
        pipe.compile(params=params)
        del params
        caches = pipe.executor.init_kv_cache(
            DECODE_PROMPTS, DECODE_PROMPT_LEN + DECODE_NEW)
        shape = list(next(iter(caches.values()))["k"].shape)
        del caches
        got, pipe_ms = _generate_timed(pipe, prompts, DECODE_NEW)
        launches = {k.name: k.launches for k in KERNELS}
        r = {"layers": cfg.layers, "dtype": str(dtype.value),
             "prompts": DECODE_PROMPTS, "prompt_len": DECODE_PROMPT_LEN,
             "new_tokens": DECODE_NEW, "stacked_cache_shape": shape,
             "pipeline_ms_per_token": pipe_ms,
             "unstacked_ms_per_token": flat_ms,
             "equal_share": float(np.mean(got == want)),
             "identical": bool(np.array_equal(got, want)),
             "launches": launches,
             "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
        if layers is not None:
            try:
                pipe.serve_generation(paged=True, slots=4, max_len=2048)
                r["paged_refused"] = None
            except ValueError as e:
                r["paged_refused"] = str(e)
        res[label] = r
        del pipe
        free_card()
        if any(launches.values()):
            problems.append(f"19b {label}: the dense-cache path launched "
                            f"kernels {launches}")
    log(f"pipeline_decode {json.dumps(res)}")
    if not res["fp32_depth2"]["identical"]:
        problems.append(f"19b: fp32 depth 2 tokens differ from the "
                        f"unstacked build's: share "
                        f"{res['fp32_depth2']['equal_share']}")
    if not (res["fp32_depth2"]["paged_refused"] or "").startswith(
            "paged decode does not support PIPELINE composite graphs"):
        problems.append(f"19b: paged serve of the PIPELINE graph: "
                        f"{res['fp32_depth2']['paged_refused']}")
    return res


def _http_json(base: str, path: str):
    with urllib.request.urlopen(base + path, timeout=60) as r:
        return r.status, json.load(r)


def _http_text(base: str, path: str) -> str:
    with urllib.request.urlopen(base + path, timeout=60) as r:
        return r.read().decode()


def prometheus_samples(text: str) -> dict:
    """{sample name with labels: value} of a Prometheus text exposition;
    raises unless every line is a `# TYPE name kind` line or a sample of
    the family its last TYPE line named."""
    out, family = {}, None
    for ln in text.splitlines():
        if ln.startswith("# TYPE "):
            _, _, family, kind = ln.split(" ")
            if kind not in ("counter", "gauge", "histogram"):
                raise ValueError(f"bad kind: {ln}")
            continue
        name, value = ln.rsplit(" ", 1)
        base = name.split("{")[0]
        if family is None or not (base == family
                                  or base.startswith(family + "_")):
            raise ValueError(f"sample outside its family: {ln}")
        out[name] = float(value)
    return out


def phase_batch_serve(seed: int, problems: list) -> dict:
    """19c: BERT-base (BertConfig(), declared bf16: fp32 from its position
    add on, so K4's fp32 bodies) at seq 128 behind ff.serve(batch_sizes=
    (32,), max_delay_ms=2) (BATCH_SIZES): 256 requests of 1..4 seeded rows
    from 8 closed-loop client threads (the main path: counts reset just
    before, read just after; K4's forward once a layer a forward), every
    answer equal to predict on its rows within FLASH_TOLS[fp32];
    requests/s, latency p50 / p99, forwards, the real rows a batch
    gathered (a batch past 32 rows runs as more forwards). Then
    http_serve(port=0):
    ready, one KServe-v2 infer equal to predict, /metrics as Prometheus
    text, and 503 on ready after stop(). K4's forward is timed at the
    largest batch's attention shape."""
    cfg = BertConfig()
    free_card()
    ff = FFModel(FFConfig(batch_size=BATCH_SIZES[-1], seed=seed,
                          device=DEVICE))
    build_bert(ff, cfg, batch_size=BATCH_SIZES[-1], seq_len=BERT_SERVE_SEQ,
               dtype=DataType.BFLOAT16)
    ff.compile()
    rs = np.random.RandomState(seed)
    reqs = [rs.randint(0, cfg.vocab_size, (int(n), BERT_SERVE_SEQ)).astype(
        np.int32) for n in rs.randint(1, 5, size=BATCH_REQUESTS)]
    server = ff.serve(batch_sizes=BATCH_SIZES, max_delay_ms=BATCH_DELAY_MS)
    batches = []  # the real rows of each forward the batcher runs
    run = server.instance.run
    server.instance.run = lambda xs: batches.append(len(xs[0])) or run(xs)
    cat = server._run_batch
    server._run_batch = lambda batch, total: (
        batches.append(-total), cat(batch, total))
    answers, latency = [None] * len(reqs), [0.0] * len(reqs)

    def client(c):
        for i in range(c, len(reqs), BATCH_CLIENTS):
            t0 = time.perf_counter()
            answers[i] = server.submit(reqs[i]).result(timeout=600)
            latency[i] = time.perf_counter() - t0

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(BATCH_CLIENTS)]
    torch.cuda.synchronize()
    _reset_routes()
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    wall = time.perf_counter() - t0
    launches = _k4_route(_route_launches())
    served = server.requests_served
    rows = [len(r) for r in reqs]
    want = ff.predict(np.concatenate(reqs), batch_size=BATCH_SIZES[-1])
    err = float(max(np.abs(a - w).max() for a, w in zip(
        answers, np.split(want, np.cumsum(rows)[:-1]))))
    lat = sorted(latency)
    res = {"model": "bert_base", "seq": BERT_SERVE_SEQ,
           "declared": "bfloat16", "runs": "float32 after add_pos",
           "batch_sizes": list(BATCH_SIZES), "max_delay_ms": BATCH_DELAY_MS,
           "requests": len(reqs), "clients": BATCH_CLIENTS,
           "rows": int(sum(rows)), "served": served, "wall_s": wall,
           "requests_per_s": len(reqs) / wall,
           "rows_per_s": sum(rows) / wall,
           "latency_p50_ms": 1e3 * lat[len(lat) // 2],
           "latency_p99_ms": 1e3 * lat[int(np.ceil(0.99 * len(lat))) - 1],
           "batches": sum(1 for b in batches if b > 0),
           "rows_per_batch_mean": float(np.mean(
               [-b for b in batches if b < 0])),
           "launches": launches, "max_abs_err_vs_predict": err}
    n_batches = sum(1 for b in batches if b > 0)
    server.instance.run, server._run_batch = run, cat
    httpd = http_serve(server, port=0, model_name="bert")
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        status, ready = _http_json(base, "/v2/health/ready")
        x = reqs[0]
        req = urllib.request.Request(
            f"{base}/v2/models/bert/infer", data=json.dumps({"inputs": [{
                "name": "input_ids", "shape": list(x.shape),
                "datatype": "INT32", "data": x.reshape(-1).tolist()}]})
            .encode(), headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            out = json.load(r)["outputs"][0]
        got = np.asarray(out["data"], np.float32).reshape(out["shape"])
        samples = prometheus_samples(_http_text(base, "/metrics"))
        server.stop()
        try:
            _http_json(base, "/v2/health/ready")
            after_stop = 200
        except urllib.error.HTTPError as e:
            after_stop = e.code
    finally:
        httpd.shutdown()
        server.stop()
    res["http"] = {
        "ready": [status, ready["ready"]],
        "infer_max_abs_err": float(np.abs(got - want[:len(x)]).max()),
        "metrics_requests_served": samples.get("ff_server_requests_served"),
        "ready_after_stop": after_stop}
    del ff
    free_card()
    timed = k4_check(BATCH_SIZES[-1] * cfg.heads, BERT_SERVE_SEQ,
                     BERT_SERVE_SEQ, cfg.hidden // cfg.heads, False,
                     torch.float32, seed + 20, timed=True)
    res["k4"] = timed
    log(f"batch_serve {json.dumps(res)}")
    tol = FLASH_TOLS[torch.float32][0]
    if served != len(reqs) or any(a is None for a in answers) \
            or not err <= tol:
        problems.append(f"19c: served {served}, max |err| vs predict {err}")
    if launches != _k4_want(cfg.layers * n_batches, 0, 0):
        problems.append(f"19c: launches {launches} for {n_batches} "
                        f"batches")
    h = res["http"]
    if h["ready"] != [200, True] or not h["infer_max_abs_err"] <= tol \
            or h["metrics_requests_served"] != served + 1 \
            or h["ready_after_stop"] != 503:
        problems.append(f"19c: http {h}")
    if not all(v["ok"] for v in timed.values()):
        problems.append(f"19c: K4 at the serving shape {timed}")
    return res


def _serve_http(ff, vocab, prompts, new, observe: bool) -> dict:
    """Phase 4's requests through serve_generation(paged=True) at its
    defaults (4 slots, max_len 2048, page 64, chunk 64), every request
    queued before the loop starts, behind http_serve; with `observe` the
    request log (REQLOG_CAPACITY), bounded records (RECORD_LIMIT) and an
    SLO monitor dumping to a temporary directory, else the request log
    off. Each decode tick is timed on the host and its synchronizing
    CUDA calls counted (sync debug "warn"); kernel counts reset just
    before the loop starts, read after its last request. Stops the
    server, then scrapes its JSON and Prometheus metrics."""
    dump_dir = tempfile.mkdtemp(prefix="ff_slo_") if observe else None
    kw = (dict(reqlog_capacity=REQLOG_CAPACITY,
               request_record_limit=RECORD_LIMIT,
               slo=SLOTarget(ttft_p95_s=SLO_TTFT_P95_S, window=8,
                             min_samples=1), slo_dump_dir=dump_dir)
          if observe else dict(reqlog_capacity=0))
    gen = ff.serve_generation(paged=True, slots=4, max_len=2048,
                              page_size=64, prefill_chunk=64,
                              defer_start=True, **kw)
    syncs, calls = [], {"_decode_tick": []}
    _count_syncs(gen, syncs, "_decode_tick")
    _timed(gen, "_decode_tick", calls)
    fwd = ff.serve(batch_sizes=(1,), warmup=False)
    httpd = http_serve(fwd, port=0, model_name="llama",
                       generation_server=gen)
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        futs = [gen.submit(p, max_new_tokens=new) for p in prompts]
        torch.cuda.synchronize()
        _reset_launches()
        t0 = time.monotonic()
        gen.start()
        outs = [np.asarray(f.result(timeout=900)) for f in futs]
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = {k.name: k.launches for k in KERNELS}
        gen.stop()
        m = gen.metrics()
        status, v2 = _http_json(base, "/v2/models/llama/metrics")
        text = _http_text(base, "/metrics")
    finally:
        httpd.shutdown()
        fwd.stop()
        gen.stop()
    gen.pool.check_invariants(owners={})
    for o in outs:
        if len(o) != new or not ((0 <= o) & (o < vocab)).all():
            raise AssertionError(f"bad output {o}")
    return {"outs": outs, "gen": gen, "metrics": m, "v2": v2,
            "v2_status": status, "prometheus": text, "dump_dir": dump_dir,
            "res": {"wall_s": wall, "launches": launches,
                    "ragged_steps": m["ragged_steps"],
                    "decode_ticks": len(calls["_decode_tick"]),
                    "decode_tick_ms": 1e3 * float(np.mean(
                        calls["_decode_tick"])),
                    "syncs_per_decode_tick": float(np.mean(syncs)),
                    "generated_tokens_per_s": new * len(outs) / wall}}


def phase_http_serve(seed: int, problems: list) -> dict:
    """19d: Llama-3-8B's widths at MEGASTEP_LAYERS layers, bf16, phase 4's
    8 requests (128..1024 prompt tokens, 64 new) through the paged server
    behind http_serve, with the request log (capacity 64), bounded
    request records (4) and an SLO (TTFT p95 under SLO_TTFT_P95_S) dumping
    to a temporary directory, against the same requests with the request
    log off: the reqlog's 8 records and their JSONL export, 4 records
    kept and 4 dropped, the /v2 metrics equal to metrics(), /metrics as
    Prometheus text with ff_slo_breaches_total >= 1, the breach bundle,
    equal tokens, K3 once a layer and ragged step, and the decode tick's
    host ms and synchronizing calls with and without."""
    cfg = llama3_8b_cut(MEGASTEP_LAYERS)
    free_card()
    ff = FFModel(FFConfig(batch_size=1, seed=seed, device=DEVICE))
    build_llama(ff, cfg, batch_size=1, seq_len=2048,
                dtype=DataType.BFLOAT16)
    ff.compile()
    prompts = serve_traffic(cfg.vocab_size, seed)
    plain = _serve_http(ff, cfg.vocab_size, prompts, 64, observe=False)
    seen = _serve_http(ff, cfg.vocab_size, prompts, 64, observe=True)
    gen, m = seen["gen"], seen["metrics"]
    recs = gen.request_log.records()
    path = os.path.join(seen["dump_dir"], "reqlog.jsonl")
    exported = gen.request_log.export_jsonl(path)
    reread = load_jsonl(path)
    slo = m.get("slo", {})
    bundle = slo.get("last_dump")
    bundle_files = sorted(os.listdir(bundle)) if bundle else []
    samples = prometheus_samples(seen["prometheus"])
    res = {"model": "llama3_8b", "layers": cfg.layers, "dtype": "bfloat16",
           "requests": len(prompts), "new_tokens": 64,
           "plain": plain["res"], "observed": seen["res"],
           "decode_tick_ms_ratio": seen["res"]["decode_tick_ms"]
           / plain["res"]["decode_tick_ms"],
           "reqlog": m["reqlog"], "records": len(recs),
           "exported": exported, "export_reads_back": reread == recs,
           "requests_kept": len(m["requests"]),
           "request_records_dropped": m["request_records_dropped"],
           "v2_status": seen["v2_status"],
           "v2_equals_metrics": seen["v2"]["generation"] == json.loads(
               json.dumps(m)),
           "slo": {k: slo.get(k) for k in ("breaches", "goodput_ratio",
                                           "ttft_p95_s", "samples")},
           "prometheus_samples": len(samples),
           "ff_slo_breaches_total": samples.get("ff_slo_breaches_total"),
           "ff_goodput_ratio": samples.get("ff_goodput_ratio"),
           "bundle_files": bundle_files,
           "identical_tokens": _identical(plain["outs"], seen["outs"]),
           "ttft_p50_s": sorted(r["first_token_ns"] - r["submit_ns"]
                                for r in recs)[len(recs) // 2] / 1e9}
    shutil.rmtree(seen["dump_dir"], ignore_errors=True)
    del ff, gen, plain, seen
    free_card()
    log(f"http_serve {json.dumps(res)}")
    n_attn = cfg.layers
    for label in ("plain", "observed"):
        r = res[label]
        got = r["launches"][RAGGED_PAGED_ATTENTION.name]
        if r["ragged_steps"] == 0 or got != n_attn * r["ragged_steps"]:
            problems.append(f"19d {label}: K3 launched {got}, not {n_attn} "
                            f"x {r['ragged_steps']} steps")
    checks = {
        "records": res["records"] == len(prompts),
        "export": res["exported"] == len(prompts)
        and res["export_reads_back"],
        "retention": res["requests_kept"] == RECORD_LIMIT
        and res["request_records_dropped"] == len(prompts) - RECORD_LIMIT,
        "v2": res["v2_status"] == 200 and res["v2_equals_metrics"],
        "breach": (res["ff_slo_breaches_total"] or 0) >= 1
        and (res["slo"]["breaches"] or 0) >= 1,
        "bundle": {"reqlog_tail.jsonl", "metrics.json",
                   "slo.json"} <= set(bundle_files),
        "tokens": res["identical_tokens"],
        "no_device_read": res["observed"]["syncs_per_decode_tick"]
        == res["plain"]["syncs_per_decode_tick"]}
    res["checks"] = checks
    if not all(checks.values()):
        problems.append(f"19d: {checks}")
    return res


def phase_pipeline_and_serving(seed: int, card: str) -> dict:
    """Phase 19 (a-d), each part timed on its own phase_time line;
    collects every part's problems and raises at the end. The kernels
    line records K1/K2's launches of (a) under "pipeline_1b", K4's
    forward's of (c) under "bert_serve" (timed at its largest batch's
    attention shape) and K3's of (d) under "http_serve"."""
    problems: list = []
    res = {"card": card}
    for key, fn in (("a", phase_pipeline_train), ("b", phase_pipeline_decode),
                    ("c", phase_batch_serve), ("d", phase_http_serve)):
        res[key] = timed(f"19{key}", fn, seed, problems)
    if problems:
        raise AssertionError(f"phase 19: {problems}")
    return res


# ---------------------------------------------------------------------------
# phase 20: the host KV tier, prefill/decode disaggregation, the router,
# the kv_quant_canary shadow cache and the span tracer

# Llama-3-8B's widths at 2 of its 32 layers (8 until the default run
# neared 1000 s with phase 21, 4 until it did again with phase 22),
# bf16: a page of 64 rows is 2 x 2 x 8 x 128 x 64 x 2 B = 512 KiB
TIER_LAYERS = 2
TIER_SERVE = dict(slots=4, max_len=2048, page_size=64, prefill_chunk=64)
# four 1024-token system prompts (16 pages each); a request is one of them
# plus 64 tokens of its own and asks for 32 new; TIER_WAVES waves of four
# requests sharing a prompt, in the order A, B, C, D, A, B, C, D: a chat
# service that keeps more system prompts than its pool holds
TIER_SYS, TIER_SUFFIX, TIER_NEW, TIER_WAVES = 1024, 64, 32, 8
# the small pool (a wave holds ~24 pages live, so by the second round
# every prefix has been evicted), the tier (128 pages: 64 MiB of host
# memory) and a pool that keeps every prefix resident
TIER_SMALL_POOL, TIER_CAPACITY, TIER_BIG_POOL = 40, 128, 160
# the fp32 check (TF32 off): depth 2, the same prompts, 8 new tokens
TIER_FP32_LAYERS, TIER_FP32_NEW = 2, 8
# the tracer: phase 19d's depth, the decode ticks of its profiler capture;
# fit's capture at bench_1b's widths, depth 2, batch 8 x 1024, 3 steps
TRACE_LAYERS, TRACE_TICKS = 4, 10
# phase 4's new tokens a request, for the canary's and the tracer's runs
SERVE4_NEW = 64
FIT_TRACE_LAYERS, FIT_TRACE_STEPS = 2, 3


def tier_traffic(vocab: int, seed: int) -> list:
    """TIER_WAVES waves of four prompts: wave w's share system prompt
    w % 4 (TIER_SYS seeded tokens), each with TIER_SUFFIX seeded tokens of
    its own."""
    rs = np.random.RandomState(seed + 20)
    systems = [rs.randint(0, vocab, (TIER_SYS,)).astype(np.int32)
               for _ in range(4)]
    return [[np.concatenate([systems[w % 4], rs.randint(
        0, vocab, (TIER_SUFFIX,)).astype(np.int32)]) for _ in range(4)]
        for w in range(TIER_WAVES)]


def serve_waves(target, waves, new: int) -> list:
    """Each wave through target.submit_request (a paged server or a
    DisaggPair): its first request alone to completion (its prefix pages
    publish), then the other three together. Returns the requests in
    submission order: tokens, TTFT stamps and page counters on each."""
    reqs = []
    for wave in waves:
        first = _GenRequest(wave[0], new, 0.0)
        target.submit_request(first)
        first.future.result(timeout=900)
        rest = [_GenRequest(p, new, 0.0) for p in wave[1:]]
        for r in rest:
            target.submit_request(r)
        for r in rest:
            r.future.result(timeout=900)
        reqs += [first] + rest
    return reqs


def _p50(xs) -> float:
    xs = sorted(xs)
    return xs[len(xs) // 2]


def wave_report(reqs, wall: float, new: int) -> dict:
    """Prefill tokens computed (all, second round), hit tokens, fetched
    pages, TTFT p50 of the second round's wave-first requests and of all,
    and tokens/s."""
    half = len(reqs) // 2
    ttft = [r.first_token_t - r.submit_t for r in reqs]
    return {
        "prefill_tokens": sum(r.prefill_tokens for r in reqs),
        "prefill_tokens_round2": sum(r.prefill_tokens for r in reqs[half:]),
        "hit_tokens": sum(r.cached_prefill_tokens for r in reqs),
        "fetched_pages": sum(r.fetched_pages for r in reqs),
        "ttft_p50_round2_first_s": _p50(ttft[half::4]),
        "ttft_round2_first_s": ttft[half::4],
        "ttft_p50_s": _p50(ttft), "wall_s": wall,
        "generated_tokens_per_s": new * len(reqs) / wall,
    }


def _tier_block(m: dict) -> dict:
    """The host-tier numbers of a server's metrics()."""
    ht = m["host_tier"]
    return {k: ht.get(k) for k in (
        "spilled_pages", "fetched_pages", "dropped_pages_total",
        "occupancy_pages", "fetch_latency_s_avg", "fetch_seconds_total")}


def tier_run(ff, waves, new: int, num_pages: int, seed: int,
             host_tier=None) -> dict:
    """The waves through serve_generation(paged=True) at TIER_SERVE with
    `num_pages` and `host_tier`; kernel counts reset just before and
    read just after; the pool's invariants checked after the drain."""
    server = ff.serve_generation(paged=True, num_pages=num_pages, seed=seed,
                                 host_tier=host_tier, **TIER_SERVE)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        steps0 = server.ragged_steps
        _reset_launches()
        t0 = time.monotonic()
        reqs = serve_waves(server, waves, new)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = {k.name: k.launches for k in KERNELS}
        steps = server.ragged_steps - steps0
        m = server.metrics()
    finally:
        server.stop()
    server.pool.check_invariants(owners={})
    res = wave_report(reqs, wall, new)
    res.update({"num_pages": num_pages, "ragged_steps": steps,
                "launches": launches, "preemptions": m["preemptions"],
                "evictions": m["prefix_cache"]["evictions"],
                "host_tier": _tier_block(m),
                "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    return {"server": server,
            "outs": [np.asarray(r.future.result()) for r in reqs],
            "res": res}


def page_roundtrip(server) -> dict:
    """One resident page of `server`'s pool spilled to a host payload, the
    page overwritten, the payload fetched back: every leaf's row must be
    the same bytes as before."""
    page = next(iter(server.pool._full.values()))
    before = {k: {n: b[page].clone() for n, b in bufs.items()}
              for k, bufs in server._caches.items()}
    payload = server._tier_read_page(page)
    for bufs in server._caches.values():
        for b in bufs.values():
            b[page].fill_(3)
    server._tier_write_page(page, payload)
    torch.cuda.synchronize()
    exact = all(torch.equal(b[page], before[k][n])
                for k, bufs in server._caches.items()
                for n, b in bufs.items())
    pinned = all(t.is_pinned() for bufs in payload.values()
                 for t in bufs.values())
    nbytes = server._page_layout()[1]
    return {"page": int(page), "bit_exact": exact, "payload_pinned": pinned,
            "payload_bytes": nbytes, "leaves": sum(
                len(b) for b in payload.values())}


def _llama_cut(layers: int, seed: int, dtype) -> FFModel:
    """Llama-3-8B's widths at `layers` layers, compiled on the card."""
    ff = FFModel(FFConfig(batch_size=1, seed=seed, device=DEVICE))
    build_llama(ff, llama3_8b_cut(layers), batch_size=1,
                seq_len=TIER_SERVE["max_len"], dtype=dtype)
    return ff.compile()


def _warm(ff, prompt):
    """cuBLAS and the allocator warmed off the clock."""
    server = ff.serve_generation(paged=True, **TIER_SERVE)
    try:
        server.generate(prompt[:16], max_new_tokens=2, timeout=900)
    finally:
        server.stop()


def _k3_ok(label, r, layers, problems, kernel=None, steps=None):
    kernel = kernel or RAGGED_PAGED_ATTENTION
    steps = r["ragged_steps"] if steps is None else steps
    got = r["launches"][kernel.name]
    if steps == 0 or got != layers * steps:
        problems.append(f"{label}: {kernel.name} launched {got}, not "
                        f"{layers} x {steps} steps")


def phase_host_tier(seed: int, problems: list, ff, ff32) -> dict:
    """20a: the waves through three servers of `ff` (Llama-3-8B's widths,
    TIER_LAYERS layers, bf16): (1) TIER_SMALL_POOL pages, no tier; (2) the
    same pool with a TIER_CAPACITY-page host tier; (3) TIER_BIG_POOL
    pages, no tier (every prefix resident: the reference tokens). Run 2's
    tokens must equal run 3's (a fetched page is the spilled bytes, and
    the launch shapes match), it must fetch, one page's spill and fetch
    must be bit-exact, and through `ff32` (fp32, TF32 off, depth 2) the
    three runs must be token-identical. Returns the runs' reports and
    run 3's tokens in both precisions, which 20b compares against."""
    cfg = llama3_8b_cut(TIER_LAYERS)
    waves = tier_traffic(cfg.vocab_size, seed)
    runs = {}
    for key, pages, tier in (("no_tier", TIER_SMALL_POOL, None),
                             ("tier", TIER_SMALL_POOL, TIER_CAPACITY),
                             ("resident", TIER_BIG_POOL, None)):
        runs[key] = tier_run(ff, waves, TIER_NEW, pages, seed, tier)
        _k3_ok(f"20a {key}", runs[key]["res"], cfg.layers, problems)
    trip = page_roundtrip(runs["tier"]["server"])
    res = {"model": "llama3_8b", "layers": cfg.layers, "dtype": "bfloat16",
           "requests": TIER_WAVES * 4, "new_tokens": TIER_NEW,
           "prompt_tokens": TIER_SYS + TIER_SUFFIX,
           "tier_capacity_pages": TIER_CAPACITY,
           **{k: r["res"] for k, r in runs.items()},
           "roundtrip": trip,
           "tier_vs_resident_same_share": _same_share(
               runs["tier"]["outs"], runs["resident"]["outs"]),
           "tier_vs_resident_identical": _identical(
               runs["tier"]["outs"], runs["resident"]["outs"]),
           "no_tier_vs_resident_same_share": _same_share(
               runs["no_tier"]["outs"], runs["resident"]["outs"])}
    bf16_outs = runs["resident"]["outs"]
    del runs
    free_card()
    fp32 = {key: tier_run(ff32, waves, TIER_FP32_NEW, pages, seed, tier)
            for key, pages, tier in (
                ("no_tier", TIER_SMALL_POOL, None),
                ("tier", TIER_SMALL_POOL, TIER_CAPACITY),
                ("resident", TIER_BIG_POOL, None))}
    res["fp32_depth2"] = {
        "layers": TIER_FP32_LAYERS, "new_tokens": TIER_FP32_NEW,
        **{k: {"prefill_tokens_round2": r["res"]["prefill_tokens_round2"],
               "host_tier": r["res"]["host_tier"]} for k, r in fp32.items()},
        "identical": _identical(fp32["no_tier"]["outs"],
                                fp32["resident"]["outs"])
        and _identical(fp32["tier"]["outs"], fp32["resident"]["outs"])}
    fp32_outs = fp32["resident"]["outs"]
    del fp32
    free_card()
    log(f"host_tier {json.dumps(res)}")
    checks = {
        "tier_tokens": res["tier_vs_resident_identical"],
        "fetched": (res["tier"]["host_tier"]["fetched_pages"] or 0) > 0,
        "spilled": (res["tier"]["host_tier"]["spilled_pages"] or 0) > 0,
        "roundtrip": trip["bit_exact"],
        "fp32_identical": res["fp32_depth2"]["identical"]}
    res["checks"] = checks
    if not all(checks.values()):
        problems.append(f"20a: {checks}")
    return {"res": res, "bf16_outs": bf16_outs, "fp32_outs": fp32_outs}


def pair_run(ff, waves, new: int, seed: int) -> dict:
    """The waves through DisaggPair(ff, tier_pages=TIER_CAPACITY,
    num_pages=TIER_SMALL_POOL) at TIER_SERVE: a prefill worker and a decode
    server, each with its own loop thread on the card, the KV handed over
    through the shared host tier."""
    pair = DisaggPair(ff, tier_pages=TIER_CAPACITY,
                      num_pages=TIER_SMALL_POOL, seed=seed, **TIER_SERVE)
    try:
        torch.cuda.synchronize()
        steps0 = pair.prefill.ragged_steps + pair.decode.ragged_steps
        _reset_launches()
        t0 = time.monotonic()
        reqs = serve_waves(pair, waves, new)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = {k.name: k.launches for k in KERNELS}
        steps = (pair.prefill.ragged_steps + pair.decode.ragged_steps
                 - steps0)
        m = pair.metrics()
    finally:
        pair.stop()
    pair.prefill.pool.check_invariants(owners={})
    pair.decode.pool.check_invariants(owners={})
    res = wave_report(reqs, wall, new)
    res.update({"handoffs": m["handoffs"], "ragged_steps": steps,
                "prefill_steps": pair.prefill.ragged_steps,
                "decode_steps": pair.decode.ragged_steps,
                "launches": launches,
                "spilled_pages": sum(r.spilled_pages for r in reqs),
                "host_tier": {k: m["host_tier"][k] for k in (
                    "spilled_pages_total", "fetched_pages_total",
                    "dropped_pages_total", "occupancy_pages",
                    "fetch_latency_s_avg")}})
    return {"outs": [np.asarray(r.future.result()) for r in reqs],
            "res": res}


def router_run(ff, reqs, seed: int, affinity: bool) -> dict:
    """The requests, all at once, over two paged servers of
    TIER_SMALL_POOL pages each: through a PrefixAffinityRouter, or round
    robin. Hit tokens summed over both pools."""
    servers = [ff.serve_generation(paged=True, num_pages=TIER_SMALL_POOL,
                                   seed=seed, **TIER_SERVE)
               for _ in range(2)]
    router = PrefixAffinityRouter(servers, names=["a", "b"])
    try:
        t0 = time.monotonic()
        if affinity:
            futs = [router.submit(p, TIER_NEW) for p in reqs]
        else:
            futs = [servers[i % 2].submit(p, TIER_NEW)
                    for i, p in enumerate(reqs)]
        for f in futs:
            f.result(timeout=900)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        ms = [s.metrics() for s in servers]
    finally:
        router.stop()
    for s in servers:
        s.pool.check_invariants(owners={})
    out = {"hit_tokens": sum(m["prefix_cache"]["hit_tokens"] for m in ms),
           "prefill_tokens": sum(r["prefill_tokens"] for m in ms
                                 for r in m["requests"]),
           "per_server": [m["requests_served"] for m in ms],
           "wall_s": wall,
           "generated_tokens_per_s": TIER_NEW * len(reqs) / wall}
    if affinity:
        out["router"] = router.metrics()
    return out


def phase_disagg(seed: int, problems: list, tier: dict, ff, ff32) -> dict:
    """20b: the waves through a DisaggPair at 20a's widths and pool (32
    handoffs, pages spilled and fetched, tokens beside 20a's resident run;
    TTFT and tokens/s beside the monolithic server's: one card and one
    interpreter serve both workers, so this is no gain); fp32 at depth 2,
    tokens identical to the monolithic server's; then the same requests
    in seeded shuffled order through a PrefixAffinityRouter over two
    paged servers against a round-robin spread: hit tokens."""
    cfg = llama3_8b_cut(TIER_LAYERS)
    waves = tier_traffic(cfg.vocab_size, seed)
    pair = pair_run(ff, waves, TIER_NEW, seed)
    mono = tier["res"]["resident"]
    res = {"model": "llama3_8b", "layers": cfg.layers, "dtype": "bfloat16",
           "pair": pair["res"],
           "monolithic": {k: mono[k] for k in (
               "ttft_p50_s", "ttft_p50_round2_first_s",
               "generated_tokens_per_s", "prefill_tokens")},
           "pair_vs_monolithic_same_share": _same_share(
               pair["outs"], tier["bf16_outs"])}
    _k3_ok("20b pair", pair["res"], cfg.layers, problems)
    order = np.random.RandomState(seed + 21).permutation(TIER_WAVES * 4)
    flat = [p for wave in waves for p in wave]
    shuffled = [flat[i] for i in order]
    res["round_robin"] = router_run(ff, shuffled, seed, affinity=False)
    res["affinity"] = router_run(ff, shuffled, seed, affinity=True)
    free_card()
    pair32 = pair_run(ff32, waves, TIER_FP32_NEW, seed)
    res["fp32_depth2"] = {
        "handoffs": pair32["res"]["handoffs"],
        "identical": _identical(pair32["outs"], tier["fp32_outs"])}
    free_card()
    log(f"disagg {json.dumps(res)}")
    n = TIER_WAVES * 4
    checks = {
        "handoffs": res["pair"]["handoffs"] == n
        and res["fp32_depth2"]["handoffs"] == n,
        "spilled": res["pair"]["host_tier"]["spilled_pages_total"] > 0,
        "fetched": res["pair"]["host_tier"]["fetched_pages_total"] > 0,
        "fp32_identical": res["fp32_depth2"]["identical"],
        "router_hits": res["affinity"]["hit_tokens"]
        > res["round_robin"]["hit_tokens"]}
    res["checks"] = checks
    if not all(checks.values()):
        problems.append(f"20b: {checks}")
    return res


def canary_run(ff, prompts, new: int, debug: bool = False, **kw) -> dict:
    """Phase 4's requests through serve_generation(paged=True,
    kv_dtype="int8") at TIER_SERVE and `kw`, every request queued before
    the loop starts; with `debug`, the server built under
    FF_TPU_KV_QUANT_DEBUG=1. Each decode tick is timed on the host and
    filed by whether a shadow window was open; kernel counts reset just
    before the loop starts, read after its last request."""
    if debug:
        os.environ["FF_TPU_KV_QUANT_DEBUG"] = "1"
    try:
        server = ff.serve_generation(paged=True, kv_dtype="int8",
                                     defer_start=True, **TIER_SERVE, **kw)
    finally:
        os.environ.pop("FF_TPU_KV_QUANT_DEBUG", None)
    ticks = {"window_open": [], "no_window": []}
    tick = server._decode_tick

    def timed_tick(*a):
        key = "window_open" if server._caches_ref is not None \
            else "no_window"
        t0 = time.perf_counter()
        try:
            return tick(*a)
        finally:
            ticks[key].append(time.perf_counter() - t0)

    server._decode_tick = timed_tick
    try:
        futs = [server.submit(p, max_new_tokens=new) for p in prompts]
        torch.cuda.synchronize()
        _reset_launches()
        t0 = time.monotonic()
        server.start()
        outs = [np.asarray(f.result(timeout=900)) for f in futs]
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = {k.name: k.launches for k in KERNELS}
        m = server.metrics()
    finally:
        server.stop()
    server.pool.check_invariants(owners={})
    kv = [b for bufs in server._caches.values()
          for n, b in bufs.items() if n in ("k", "v")]
    res = {"kv_quant_error": m["kv_quant_error"],
           "canary": m["kv_quant_canary"],
           "ragged_steps": m["ragged_steps"],
           "shadow_steps": server.shadow_steps, "launches": launches,
           "decode_ticks": {k: len(v) for k, v in ticks.items()},
           "decode_tick_ms": {k: 1e3 * float(np.mean(v)) if v else None
                              for k, v in ticks.items()},
           "wall_s": wall,
           "generated_tokens_per_s": new * len(outs) / wall,
           "pool_bytes": _pool_bytes(server),
           "shadow_pool_bytes": sum(b.numel() * 4 for b in kv)}
    return {"outs": outs, "res": res}


def phase_canary(seed: int, problems: list, ff) -> dict:
    """20c: phase 4's eight requests (128..1024 prompt tokens, 64 new) at
    Llama-3-8B's widths, TIER_LAYERS layers, bf16, through an int8 pool
    three times: no canary, kv_quant_canary=1, FF_TPU_KV_QUANT_DEBUG=1.
    Tokens identical (the shadow only observes), kv_quant_error under the
    catalog's band with no breach, the int8 kernel once a layer and
    ragged step, and the fp kernel (bf16 q over the fp32 shadow pool)
    once a layer and shadow step; decode tick ms with a window open
    against no canary, the shadow pool's bytes."""
    cfg = llama3_8b_cut(TIER_LAYERS)
    prompts = serve_traffic(cfg.vocab_size, seed)
    runs = {"plain": canary_run(ff, prompts, SERVE4_NEW),
            "canary": canary_run(ff, prompts, SERVE4_NEW,
                                 kv_quant_canary=1),
            "debug": canary_run(ff, prompts, SERVE4_NEW, debug=True)}
    band = num_budgets.tolerance("kv-canary-shadow-delta")
    res = {"model": "llama3_8b", "layers": cfg.layers, "dtype": "bfloat16",
           "band": band, **{k: r["res"] for k, r in runs.items()},
           "identical_tokens": _identical(runs["plain"]["outs"],
                                          runs["canary"]["outs"])
           and _identical(runs["plain"]["outs"], runs["debug"]["outs"])}
    plain_ms = res["plain"]["decode_tick_ms"]["no_window"]
    open_ms = res["canary"]["decode_tick_ms"]["window_open"]
    res["window_open_tick_ratio"] = (open_ms / plain_ms if open_ms
                                     and plain_ms else None)
    del runs
    free_card()
    log(f"canary {json.dumps(res)}")
    for key in ("plain", "canary", "debug"):
        r = res[key]
        _k3_ok(f"20c {key}", r, cfg.layers, problems,
               kernel=RAGGED_PAGED_ATTENTION_INT8)
        if key != "plain":
            _k3_ok(f"20c {key} shadow", r, cfg.layers, problems,
                   steps=r["shadow_steps"])
    checks = {
        "tokens": res["identical_tokens"],
        "in_band": all(0.0 < res[k]["kv_quant_error"] < band
                       for k in ("canary", "debug")),
        "no_breach": all(res[k]["canary"]["breaches"] == 0
                         for k in ("canary", "debug")),
        "windows": res["canary"]["canary"]["windows"] >= 1,
        "plain_shadowless": res["plain"]["shadow_steps"] == 0
        and res["plain"]["launches"][RAGGED_PAGED_ATTENTION.name] == 0}
    res["checks"] = checks
    if not all(checks.values()):
        problems.append(f"20c: {checks}")
    return res


def _traced_serve(ff, prompts, new: int, traced: bool, dump_dir: str):
    """Phase 4's requests through the paged server at TIER_SERVE, every
    request queued before the loop starts, with an SLO every request
    misses (bundles under `dump_dir`), under obs.enable() or not. Each
    decode tick is timed on the host and its synchronizing CUDA calls
    counted (sync debug "warn")."""
    rec = obs.enable() if traced else None
    server = ff.serve_generation(
        paged=True, defer_start=True, slo_dump_dir=dump_dir,
        slo=SLOTarget(ttft_p95_s=SLO_TTFT_P95_S, window=8, min_samples=1),
        **TIER_SERVE)
    syncs, calls = [], {"_decode_tick": []}
    _count_syncs(server, syncs, "_decode_tick")
    _timed(server, "_decode_tick", calls)
    try:
        futs = [server.submit(p, max_new_tokens=new) for p in prompts]
        torch.cuda.synchronize()
        _reset_launches()
        server.start()
        outs = [np.asarray(f.result(timeout=900)) for f in futs]
        torch.cuda.synchronize()
        launches = {k.name: k.launches for k in KERNELS}
        m = server.metrics()
    finally:
        server.stop()
        obs.disable()
    server.pool.check_invariants(owners={})
    return {"outs": outs, "rec": rec, "metrics": m, "res": {
        "launches": launches, "ragged_steps": m["ragged_steps"],
        "decode_ticks": len(calls["_decode_tick"]),
        "decode_tick_ms": 1e3 * float(np.mean(calls["_decode_tick"])),
        "syncs_per_decode_tick": float(np.mean(syncs))}}


def _enclosed(doc: dict, kernel: str, spans=("decode_tick",
                                              "prefill_tick")) -> dict:
    """From a torch.profiler Chrome trace: each launch of a device kernel
    whose name holds `kernel` — its launch call on the host, found by
    correlation id — filed by the host span range of `spans` (the obs
    spans' record_function ranges) on the same thread that encloses it;
    "none" counts the launches no such range encloses."""
    evs = doc.get("traceEvents", [])
    ranges = [e for e in evs if e.get("ph") == "X"
              and e.get("cat") == "user_annotation"
              and e.get("name") in spans]
    device = ("kernel", "gpu_memcpy", "gpu_memset", "gpu_user_annotation")
    calls = {e["args"]["correlation"]: e for e in evs
             if e.get("ph") == "X" and e.get("cat") not in device
             and "correlation" in e.get("args", {})}
    out = {s: 0 for s in spans}
    out["none"] = 0
    out["ranges"] = {s: sum(1 for r in ranges if r["name"] == s)
                     for s in spans}
    for e in evs:
        if e.get("cat") != "kernel" or kernel not in e.get("name", ""):
            continue
        call = calls.get(e.get("args", {}).get("correlation"))
        home = None
        if call is not None:
            for r in ranges:
                if (r["tid"] == call["tid"] and r["ts"] <= call["ts"]
                        <= r["ts"] + r["dur"]):
                    home = r["name"]
                    break
        out[home or "none"] += 1
    return out


def profile_traced_ticks(ff, prompts, layers: int) -> dict:
    """A traced paged server (obs.enable()) serving four of phase 4's
    prompts cut to 64 tokens, TRACE_TICKS + 1 new tokens each (one
    prefill tick a prompt, then TRACE_TICKS decode ticks), under
    torch.profiler (CPU and CUDA activity, every thread: the loop runs
    on its own), exported as a Chrome trace and parsed: the decode_tick
    ranges must enclose `layers` K3 split-kernel launches each."""
    cfg = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    obs.enable()
    server = ff.serve_generation(paged=True, defer_start=True, **TIER_SERVE)
    try:
        futs = [server.submit(p[:64], max_new_tokens=TRACE_TICKS + 1)
                for p in prompts[:4]]
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU,
                            torch.profiler.ProfilerActivity.CUDA],
                experimental_config=cfg) as prof:
            server.start()
            for f in futs:
                f.result(timeout=900)
            torch.cuda.synchronize()
    finally:
        server.stop()
        obs.disable()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            doc = json.load(f)
    finally:
        os.remove(path)
    found = _enclosed(doc, "ragged_split_kernel")
    return {"split_kernel_launches": found,
            "decode_ticks_enclosing_all": found["decode_tick"]
            == layers * found["ranges"]["decode_tick"] > 0
            and found["none"] == 0}


def fit_trace(seed: int) -> dict:
    """fit under FFConfig(profiler_trace_dir=...) at bench_1b's widths,
    FIT_TRACE_LAYERS layers, bf16, batch 8 x 1024, FIT_TRACE_STEPS steps:
    the trace file it writes, loaded, must name K1's forward and K2's dq
    and dk/dv (their tensor-core bodies at head dim 128), each launched
    once a layer and step."""
    cfg = dataclasses.replace(LlamaConfig.bench_1b(),
                              layers=FIT_TRACE_LAYERS)
    trace_dir = tempfile.mkdtemp(prefix="ff_fit_trace_")
    ff = FFModel(FFConfig(batch_size=TRAIN_BATCH, seed=seed, device=DEVICE,
                          remat="none", profiler_trace_dir=trace_dir))
    build_llama(ff, cfg, batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                dtype=DataType.BFLOAT16)
    ff.compile(optimizer=AdamOptimizer(lr=TRAIN_LR),
               loss_type=LossType.SPARSE_CATEGORICAL_CROSSENTROPY)
    x, y = _token_batches(TRAIN_BATCH * FIT_TRACE_STEPS, TRAIN_SEQ,
                          cfg.vocab_size, seed)
    _reset_launches()
    t0 = time.monotonic()
    ff.fit(x, y, epochs=1, verbose=False)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = _flash_launches()
    files = sorted(os.listdir(trace_dir))
    named = {}
    size = 0
    for name in files:
        path = os.path.join(trace_dir, name)
        size += os.path.getsize(path)
        with open(path) as f:
            doc = json.load(f)
        for e in doc.get("traceEvents", []):
            if e.get("cat") == "kernel":
                body = wgmma_name(e.get("name", ""))
                if body:
                    kernel, args = body.rstrip(">").split("<")
                    key = f"{kernel}<{','.join(args.split(',')[:2])}>"
                    named[key] = named.get(key, 0) + 1
    shutil.rmtree(trace_dir, ignore_errors=True)
    want = {f"flash_{k}_wgmma_kernel<FlatLayout,128>"
            for k in ("fwd", "dq", "dkv")}
    per = FIT_TRACE_LAYERS * FIT_TRACE_STEPS
    return {"files": files, "trace_bytes": size, "wall_s": wall,
            "launches": launches, "kernels_named": named,
            "names_k1_k2": want <= set(named)
            and all(named[w] == per for w in want),
            "launches_ok": all(v == per for v in launches.values())}


def phase_tracer(seed: int, problems: list) -> dict:
    """20d: phase 4's requests at Llama-3-8B's widths, TRACE_LAYERS
    layers, bf16, through the paged server with obs.enable() against the
    same requests without it: tokens, decode tick ms and synchronizing
    calls a tick, the spans by name, the ledger's shape keys and stats,
    one request track, the exported Chrome trace loaded back, the SLO
    breach bundle's trace tail; a torch.profiler capture over
    TRACE_TICKS traced ticks whose decode_tick ranges enclose K3's
    launches; and fit's capture under profiler_trace_dir."""
    cfg = llama3_8b_cut(TRACE_LAYERS)
    free_card()
    ff = _llama_cut(TRACE_LAYERS, seed, DataType.BFLOAT16)
    prompts = serve_traffic(cfg.vocab_size, seed)
    _warm(ff, prompts[0])
    dump_dir = tempfile.mkdtemp(prefix="ff_trace_slo_")
    plain = _traced_serve(ff, prompts, SERVE4_NEW, False,
                          os.path.join(dump_dir, "plain"))
    seen = _traced_serve(ff, prompts, SERVE4_NEW, True,
                         os.path.join(dump_dir, "traced"))
    rec, m = seen["rec"], seen["metrics"]
    spans = {}
    for e in rec.events:
        n, dur = spans.get(e[0], (0, 0.0))
        spans[e[0]] = (n + 1, dur + e[2] / 1e9)
    doc_path = os.path.join(dump_dir, "trace.json")
    rec.export_chrome_trace(doc_path)
    with open(doc_path) as f:
        doc = json.load(f)
    track = [e for e in doc["traceEvents"] if e["ph"] == "X"
             and e["pid"] == 2 and e["tid"] == 1]
    bundle = m["slo"]["last_dump"]
    tail_path = os.path.join(bundle, "trace_tail.json") if bundle else ""
    tail = {}
    if tail_path and os.path.exists(tail_path):
        with open(tail_path) as f:
            tail = json.load(f)
    res = {"model": "llama3_8b", "layers": cfg.layers, "dtype": "bfloat16",
           "plain": plain["res"], "traced": seen["res"],
           "decode_tick_ms_ratio": seen["res"]["decode_tick_ms"]
           / plain["res"]["decode_tick_ms"],
           "identical_tokens": _identical(plain["outs"], seen["outs"]),
           "spans": {k: {"count": n, "ms_mean": 1e3 * s / n}
                     for k, (n, s) in sorted(spans.items())},
           "ledger": {k: rec.ledger.stats(k) for k in rec.ledger.shapes()},
           "request_tracks": len(rec.requests),
           "request_track_1": [(e["name"], e["dur"]) for e in track],
           "trace_events": len(doc["traceEvents"]),
           "slo_breaches": m["slo"]["breaches"],
           "bundle_trace_tail_events": len(tail.get("traceEvents", []))}
    shutil.rmtree(dump_dir, ignore_errors=True)
    res["profile"] = profile_traced_ticks(ff, prompts, cfg.layers)
    del ff, plain, seen, rec
    free_card()
    res["fit"] = fit_trace(seed)
    free_card()
    log(f"tracer {json.dumps(res)}")
    for label in ("plain", "traced"):
        _k3_ok(f"20d {label}", res[label], cfg.layers, problems)
    checks = {
        "tokens": res["identical_tokens"],
        "no_device_read": res["traced"]["syncs_per_decode_tick"]
        == res["plain"]["syncs_per_decode_tick"],
        "spans": {"tick_prep", "admit_pending", "prefill_tick",
                  "decode_tick"} <= set(res["spans"]),
        "ledger": any(k.startswith("decode|") for k in res["ledger"])
        and any(k.startswith("prefill|") for k in res["ledger"]),
        "request_tracks": res["request_tracks"] == len(prompts)
        and [n for n, _ in res["request_track_1"]]
        == ["queued", "prefill", "decode"],
        "bundle_tail": res["slo_breaches"] >= 1
        and res["bundle_trace_tail_events"] > 0,
        "profile_encloses_k3": res["profile"]["decode_ticks_enclosing_all"],
        "fit_trace_names_k1_k2": res["fit"]["names_k1_k2"],
        "fit_launches": res["fit"]["launches_ok"]}
    res["checks"] = checks
    if not all(checks.values()):
        problems.append(f"20d: {checks}")
    return res


def phase_tier_disagg_canary_trace(seed: int, card: str) -> dict:
    """Phase 20 (a-d), each part timed on its own phase_time line;
    collects every part's problems and raises at the end. The kernels
    line records K3's launches of (a)'s tiered run, (b)'s pair, (c)'s
    live and shadow steps and (d)'s traced run."""
    problems: list = []
    res = {"card": card}
    free_card()
    ff = _llama_cut(TIER_LAYERS, seed, DataType.BFLOAT16)
    ff32 = _llama_cut(TIER_FP32_LAYERS, seed, DataType.FLOAT)
    prompt = tier_traffic(llama3_8b_cut(TIER_LAYERS).vocab_size, seed)[0][0]
    _warm(ff, prompt)
    _warm(ff32, prompt)
    tier = timed("20a", phase_host_tier, seed, problems, ff, ff32)
    res["a"] = tier["res"]
    res["b"] = timed("20b", phase_disagg, seed, problems, tier, ff, ff32)
    del ff32
    res["c"] = timed("20c", phase_canary, seed, problems, ff)
    del ff, tier
    res["d"] = timed("20d", phase_tracer, seed, problems)
    if problems:
        raise AssertionError(f"phase 20: {problems}")
    return res


# ---------------------------------------------------------------------------
# phase 21: checkpoints, data loaders, recompilation, the frontends, the
# CLI's examples

# GPT-2 124M (openai-community/gpt2: GPT2Config()'s widths, 12 layers),
# trained from two FileDataLoaders over P21_BATCHES batches of 8 x 1024
P21_BATCHES, P21_EVERY, P21_RECOMPILE_AT = 16, 8, 4
# the restored step-16 model serves these greedy requests
P21_REQUESTS, P21_NEW, P21_PROMPT_MIN, P21_PROMPT_MAX = 4, 32, 64, 256
# Llama-3-8B's widths through the HF importer at this depth, predict at
# this sequence (K1 at D 128)
P21_LLAMA_LAYERS, P21_LLAMA_SEQ = 2, 128
# (example module, flags): every port example, one epoch on the card
P21_EXAMPLES = [
    ("mnist_mlp", ("-b", "64")), ("alexnet_cifar10", ("-b", "32")),
    ("bert_attribute_parallel", ("-b", "8")), ("candle_uno", ("-b", "16")),
    ("dlrm_train", ("-b", "32")), ("inception_v3", ("-b", "4")),
    ("llama_train", ("-b", "4")), ("llama_train", ("-b", "4", "--pipeline")),
    ("mixtral_moe", ("-b", "8")), ("nmt_seq2seq", ("-b", "32")),
    ("resnet_torch_import", ("-b", "8")), ("hf_finetune", ("-b", "4")),
    ("transformer", ("-b", "8")), ("transformer", ("-b", "8", "--enc-dec")),
]
P21_FX_BATCH = 64
P21_FX_TOL = 1e-4  # fp32, cuDNN's convolutions on both sides


def _gpt2_import(hf_model, seed: int, **cfg) -> tuple:
    """The HF importer's main path: GPT-2 at seq 1024, bf16 compute (fp32
    from the position add, as the reference computes it), Adam's fp32
    masters; (model, weights copied)."""
    from flexflow_tpu_torch.frontends.hf import (
        copy_hf_weights, import_hf_causal_lm,
    )

    ff = FFModel(FFConfig(batch_size=TRAIN_BATCH, seed=seed, device=DEVICE,
                          remat="none", **cfg))
    import_hf_causal_lm(hf_model, ff, batch_size=TRAIN_BATCH,
                        seq_len=GPT2_POSITIONS, dtype=DataType.BFLOAT16)
    ff.compile(optimizer=AdamOptimizer(lr=TRAIN_LR),
               loss_type=LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
               metrics=[MetricsType.ACCURACY,
                        MetricsType.SPARSE_CATEGORICAL_CROSSENTROPY])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the tied head is copied
        n = copy_hf_weights(hf_model, ff)
    return ff, n


def _state_leaves(ff) -> dict:
    from flexflow_tpu_torch.runtime.checkpoint import _flatten

    tr, ntr = ff._params
    return _flatten({"trainable": tr, "nontrainable": ntr,
                     "opt_state": ff._opt_state})


def _state_diff(a, b) -> dict:
    """Leaf by leaf: bit-equal, and the largest |a - b| over the largest
    |b| of any leaf that differs."""
    la, lb = _state_leaves(a), _state_leaves(b)
    if sorted(la) != sorted(lb):
        return {"same_leaves": False}
    unequal, worst = 0, 0.0
    for k, v in la.items():
        w = lb[k]
        if isinstance(v, int):
            unequal += int(v != w)
            continue
        if not torch.equal(v, w):
            unequal += 1
            d = float((v.float() - w.float()).abs().max())
            worst = max(worst, d / max(float(w.float().abs().max()), 1e-30))
    return {"same_leaves": True, "leaves": len(la), "unequal": unequal,
            "bit_equal": unequal == 0, "max_rel_diff": worst}


def _synced_fit(ff, **kw) -> tuple:
    """ff.fit under its config's transfer_guard ("log": sync debug
    "warn" around the step loop; checkpoints and the recompile trigger
    exempt): (metrics, synchronizing calls warned, wall s, launches)."""
    _reset_launches()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        t0 = time.monotonic()
        pm = ff.fit(epochs=1, verbose=False, **kw)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    syncs = sum(SYNC_WARNING in str(w.message) for w in caught)
    return pm, syncs, wall, {k.name: k.launches for k in KERNELS}


def phase_checkpoint_resume(seed: int, problems: list, work: str) -> dict:
    """21a: GPT-2 124M's widths (a GPT2LMHeadModel-shaped stand-in, seeded
    weights) through import_hf_causal_lm / copy_hf_weights, compile(Adam),
    fit(dataloaders=[two FileDataLoaders], recompile_state=...) over
    P21_BATCHES batches of 8 x 1024 with checkpoint_every P21_EVERY (the
    main path: K4's three kernels once a layer and step); the same
    batches through fit(x, y) from the same import (equal syncs a step,
    equal weights: the no-op recompile and the loaders change nothing);
    restore_model(step_8) trained on batches 9-16 against the writer.
    Returns the result and the writer (for 21b)."""
    from flexflow_tpu_torch.frontends.hf_standin import gpt2_standin
    from flexflow_tpu_torch.runtime import checkpoint as ckpt
    from flexflow_tpu_torch.runtime.recompile import RecompileState

    cfg = GPT2Config()
    hf_model = gpt2_standin(vocab_size=cfg.vocab_size,
                            n_positions=GPT2_POSITIONS, n_embd=cfg.dim,
                            n_layer=cfg.layers, n_head=cfg.heads, seed=seed,
                            device=DEVICE)
    x, y = _token_batches(TRAIN_BATCH * P21_BATCHES, GPT2_POSITIONS,
                          cfg.vocab_size, seed)
    half = TRAIN_BATCH * P21_EVERY
    files = {}
    for name, arr in (("x", x), ("y", y), ("x_tail", x[half:]),
                      ("y_tail", y[half:])):
        files[name] = os.path.join(work, f"{name}.npy")
        np.save(files[name], arr)
    ck_dir = os.path.join(work, "ck")
    saves = []
    real_save = ckpt.periodic_save

    def timed_save(d, model, **kw):
        t0 = time.monotonic()
        path = real_save(d, model, **kw)
        saves.append({"path": os.path.basename(path),
                      "s": time.monotonic() - t0,
                      "gb": os.path.getsize(os.path.join(
                          path, "arrays.npz")) / 1e9})
        return path

    writer, copied = _gpt2_import(hf_model, seed, checkpoint_dir=ck_dir,
                                  checkpoint_every=P21_EVERY,
                                  transfer_guard="log")
    fired = []
    state = RecompileState(
        lambda s: not fired and writer._step_count >= P21_RECOMPILE_AT,
        lambda s: fired.append(writer._step_count), writer)
    executor0 = writer.executor
    loaders = [writer.create_data_loader(None, files[n])
               for n in ("x", "y")]
    ckpt.periodic_save = timed_save
    try:
        pm, syncs, wall, launches = _synced_fit(
            writer, dataloaders=loaders, recompile_state=state)
    finally:
        ckpt.periodic_save = real_save
    plain, _ = _gpt2_import(hf_model, seed, transfer_guard="log")
    pm_np, syncs_np, wall_np, _ = _synced_fit(plain, x=x, y=y)
    same_as_plain = _state_diff(plain, writer)
    del plain
    free_card()
    t0 = time.monotonic()
    resumed = ckpt.restore_model(os.path.join(ck_dir, "step_8"),
                                 device=DEVICE)
    torch.cuda.synchronize()
    restore_s = time.monotonic() - t0
    resumed.fit(dataloaders=[resumed.create_data_loader(None, files[n])
                             for n in ("x_tail", "y_tail")],
                verbose=False)
    resume = _state_diff(resumed, writer)
    del resumed
    free_card()
    with open(os.path.join(ck_dir, "latest.json")) as f:
        latest = json.load(f)
    want = cfg.layers * P21_BATCHES
    res = {"model": "gpt2_124m", "layers": cfg.layers,
           "weights_copied": copied, "steps": writer._step_count,
           "samples": pm.train_all,
           "loss": pm.sparse_cce_loss / max(pm.train_all, 1),
           "fit_wall_s": wall, "fit_x_y_wall_s": wall_np,
           "launches": launches, "saves": saves, "restore_s": restore_s,
           "restore_gb": saves[0]["gb"] if saves else None,
           "latest": latest, "recompiled_at_step": fired,
           "executor_rebuilt": writer.executor is not executor0,
           "syncs_per_step_loaders": syncs / P21_BATCHES,
           "syncs_per_step_x_y": syncs_np / P21_BATCHES,
           "loaders_vs_x_y": same_as_plain, "resume_vs_writer": resume}
    log(f"checkpoint_resume {json.dumps(res)}")
    checks = {
        "copied": copied == 5 + 16 * cfg.layers,
        "steps": writer._step_count == P21_BATCHES
        and pm.train_all == TRAIN_BATCH * P21_BATCHES
        and bool(np.isfinite(res["loss"])),
        "saves": [s["path"] for s in saves] == ["step_8", "step_16"]
        and latest == {"name": "step_16", "step": 16},
        "recompiled_once": fired == [P21_RECOMPILE_AT]
        and state.recompilations == 1 and res["executor_rebuilt"],
        "k4_each_layer_and_step": all(launches[k.name] == want
                                      for k in K4_KERNELS),
        "no_other_attention": all(launches[k.name] == 0 for k in KERNELS
                                  if k not in K4_KERNELS),
        "equal_syncs": syncs == syncs_np,
        "no_op_recompile_and_loaders_change_nothing":
            same_as_plain.get("bit_equal", False),
        "resume_bit_equal": resume.get("bit_equal", False),
    }
    res["checks"] = checks
    if not all(checks.values()):
        problems.append(f"21a: {checks}")
    return res, writer


def _greedy_tokens(ff, prompts) -> tuple:
    """Greedy tokens of `prompts` through the paged server, every request
    queued before the first tick (the schedule depends on the tokens
    alone); (tokens, launches, ragged steps, wall s)."""
    server = ff.serve_generation(paged=True, slots=4,
                                 max_len=GPT2_POSITIONS, page_size=64,
                                 defer_start=True)
    try:
        _reset_launches()
        t0 = time.monotonic()
        futs = [server.submit(p, max_new_tokens=P21_NEW) for p in prompts]
        server.start()
        outs = [np.asarray(f.result(timeout=600)) for f in futs]
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = {k.name: k.launches for k in KERNELS}
        steps = server.ragged_steps
    finally:
        server.stop()
    server.pool.check_invariants(owners={})
    return outs, launches, steps, wall


def phase_serve_restored(seed: int, problems: list, writer,
                         work: str) -> dict:
    """21b: restore_model(step_16), bit for bit the writer's state, served
    through serve_generation(paged=True): P21_REQUESTS greedy requests of
    P21_NEW tokens (K3 once a layer and ragged step) against the model
    that wrote the checkpoint, token for token."""
    from flexflow_tpu_torch.runtime.checkpoint import restore_model

    t0 = time.monotonic()
    restored = restore_model(os.path.join(work, "ck", "step_16"),
                             device=DEVICE)
    torch.cuda.synchronize()
    restore_s = time.monotonic() - t0
    # step_16 holds the writer's final state: with 21a's resume equal to
    # the writer, the resume equals step_16
    step16 = _state_diff(restored, writer)
    vocab = GPT2Config().vocab_size
    rs = np.random.RandomState(seed + 21)
    prompts = [rs.randint(0, vocab, (n,)).astype(np.int32) for n in
               rs.randint(P21_PROMPT_MIN, P21_PROMPT_MAX + 1,
                          P21_REQUESTS)]
    outs, launches, steps, wall = _greedy_tokens(restored, prompts)
    want, _, _, _ = _greedy_tokens(writer, prompts)
    layers = GPT2Config().layers
    res = {"restore_s": restore_s, "step_16_vs_writer": step16,
           "requests": len(prompts),
           "prompt_lens": [len(p) for p in prompts], "new": P21_NEW,
           "ragged_steps": steps, "launches": launches, "wall_s": wall,
           "tokens_per_s": P21_NEW * len(prompts) / wall,
           "identical_tokens": all(np.array_equal(a, b)
                                   for a, b in zip(outs, want))}
    log(f"serve_restored {json.dumps(res)}")
    checks = {"step_16_is_the_writer": step16.get("bit_equal", False),
              "tokens": res["identical_tokens"]
              and all(len(o) == P21_NEW for o in outs),
              "k3": steps > 0 and launches[RAGGED_PAGED_ATTENTION.name]
              == layers * steps}
    res["checks"] = checks
    if not all(checks.values()):
        problems.append(f"21b: {checks}")
    return res


def phase_hf_llama(seed: int, problems: list) -> dict:
    """21c: a LlamaForCausalLM-shaped stand-in at Llama-3-8B's widths,
    P21_LLAMA_LAYERS of its 32 layers (memory and time), seeded fp32
    weights on the card, through import_hf_causal_lm (bf16) and
    copy_hf_weights: the weights copied, then predict at seq
    P21_LLAMA_SEQ through K1 (once a layer) against the port's fp32 path
    on the CPU over the same (bf16-stored) weights, within the
    hf-import-parity budgets with argmax agreeing on 90% of rows."""
    from flexflow_tpu_torch.frontends.hf import (
        copy_hf_weights, import_hf_causal_lm,
    )
    from flexflow_tpu_torch.frontends.hf_standin import llama_standin

    cfg = llama3_8b_cut(P21_LLAMA_LAYERS)
    free_card()
    t0 = time.monotonic()
    hf_model = llama_standin(
        vocab_size=cfg.vocab_size, hidden_size=cfg.dim,
        intermediate_size=cfg.hidden, num_hidden_layers=cfg.layers,
        num_attention_heads=cfg.heads, num_key_value_heads=cfg.kv_heads,
        rope_theta=cfg.rope_theta, rms_norm_eps=cfg.norm_eps, seed=seed,
        device=DEVICE)
    ff = FFModel(FFConfig(batch_size=1, seed=seed, device=DEVICE))
    import_hf_causal_lm(hf_model, ff, batch_size=1, seq_len=P21_LLAMA_SEQ,
                        dtype=DataType.BFLOAT16)
    ff.compile()
    copied = copy_hf_weights(hf_model, ff)
    del hf_model
    torch.cuda.synchronize()
    import_s = time.monotonic() - t0
    ids = np.random.RandomState(seed).randint(
        0, cfg.vocab_size, (1, P21_LLAMA_SEQ)).astype(np.int32)
    _reset_launches()
    got = ff.predict(ids)
    launches = {k.name: k.launches for k in KERNELS}
    cpu = FFModel(FFConfig(batch_size=1, seed=seed, device="cpu"))
    build_llama(cpu, cfg, batch_size=1, seq_len=P21_LLAMA_SEQ,
                dtype=DataType.FLOAT)
    cpu.compile(params=tuple({k: {n: t.float().cpu() for n, t in w.items()}
                              for k, w in tree.items()}
                             for tree in ff._params))
    del ff
    free_card()
    want = cpu.predict(ids)
    del cpu
    atol = num_budgets.tolerance("hf-import-parity-atol")
    rtol = num_budgets.tolerance("hf-import-parity-rtol")
    agree = float((got.argmax(-1) == want.argmax(-1)).mean())
    res = {"model": "llama3_8b", "layers": cfg.layers,
           "seq": P21_LLAMA_SEQ, "weights_copied": copied,
           "import_s": import_s, "launches": launches,
           "max_abs_err": float(np.abs(got - want).max()),
           "atol": atol, "rtol": rtol, "argmax_agreement": agree,
           "finite": bool(np.isfinite(got).all())}
    log(f"hf_llama {json.dumps(res)}")
    checks = {
        "copied": copied == 3 + 9 * cfg.layers,
        "close": res["finite"] and bool(np.allclose(got, want, atol=atol,
                                                    rtol=rtol)),
        "argmax": agree >= 0.9,
        "k1": launches[FLASH_ATTENTION_FWD.name] == cfg.layers,
    }
    res["checks"] = checks
    if not all(checks.values()):
        problems.append(f"21c: {checks}")
    return res


def phase_examples(seed: int, problems: list) -> dict:
    """21d: every port example in this process, one epoch on the card
    (a reported epoch, its samples, seconds, launches); the resnet
    example's torch module imported through torch.fx at batch
    P21_FX_BATCH against the module's own output on the card; and the
    keras MNIST MLP (784-512-512-10) on the synthetic mnist."""
    import contextlib
    import importlib
    import io

    from flexflow_tpu_torch.examples.resnet_torch_import import (
        make_torch_resnet_block,
    )
    from flexflow_tpu_torch.frontends import keras
    from flexflow_tpu_torch.frontends.torch_fx import PyTorchModel

    runs = []
    for name, flags in P21_EXAMPLES:
        mod = importlib.import_module(f"flexflow_tpu_torch.examples.{name}")
        _reset_launches()
        out = io.StringIO()
        t0 = time.monotonic()
        try:
            with contextlib.redirect_stdout(out):
                pm = mod.main([*flags, "-e", "1"])
            torch.cuda.synchronize()
            err = None
        except Exception as e:  # noqa: BLE001 - each example reports
            pm, err = None, repr(e)
        runs.append({"example": " ".join((name,) + flags[2:]),
                     "s": time.monotonic() - t0,
                     "samples": pm.train_all if pm else 0,
                     "epoch_line": "epoch 0: samples=" in out.getvalue(),
                     "launches": {k.name: k.launches for k in KERNELS
                                  if k.launches},
                     "error": err})
        free_card()
    torch.manual_seed(seed)
    module = make_torch_resnet_block().to(DEVICE).eval()
    ff = FFModel(FFConfig(batch_size=P21_FX_BATCH, seed=seed, device=DEVICE))
    pm_fx = PyTorchModel(module)
    (out,) = pm_fx.torch_to_ff(ff, [ff.create_tensor(
        (P21_FX_BATCH, 3, 32, 32), name="input")])
    ff.softmax(out)
    ff.compile(loss_type=LossType.SPARSE_CATEGORICAL_CROSSENTROPY)
    pm_fx.copy_weights(ff)
    xs = np.random.RandomState(seed).standard_normal(
        (P21_FX_BATCH, 3, 32, 32)).astype(np.float32)
    got = ff.predict(xs)
    with torch.no_grad():
        want = torch.softmax(module(torch.from_numpy(xs).to(DEVICE)),
                             -1).cpu().numpy()
    fx_err = float(np.abs(got - want).max())
    del ff, module
    (xtr, ytr), _ = keras.datasets.mnist.load_data(seed=seed)
    xk = (xtr.reshape(len(xtr), 784) / 255.0).astype(np.float32)
    yk = ytr.astype(np.int32)
    km = keras.Sequential(config=FFConfig(batch_size=64, seed=seed,
                                          device=DEVICE))
    km.add_input((784,))
    km.add(keras.Dense(512, activation="relu"))
    km.add(keras.Dense(512, activation="relu"))
    km.add(keras.Dense(10))
    km.add(keras.Activation("softmax"))
    km.compile(optimizer="sgd", loss="sparse_categorical_crossentropy",
               metrics=["accuracy"])
    t0 = time.monotonic()
    hist = km.fit(xk, yk, epochs=2, verbose=False)
    torch.cuda.synchronize()
    keras_s = time.monotonic() - t0
    res = {"examples": runs, "fx_resnet_block": {
        "batch": P21_FX_BATCH, "max_abs_err": fx_err, "tol": P21_FX_TOL},
           "keras_mnist_mlp": {"loss": hist.history["loss"],
                               "accuracy": hist.history["accuracy"],
                               "s": keras_s}}
    log(f"examples {json.dumps(res)}")
    loss = hist.history["loss"]
    checks = {
        "examples": all(r["error"] is None and r["samples"] > 0
                        and r["epoch_line"] for r in runs),
        "fx": fx_err <= P21_FX_TOL,
        "keras": all(np.isfinite(loss)) and loss[-1] < loss[0],
    }
    res["checks"] = checks
    if not all(checks.values()):
        problems.append(f"21d: {checks}")
    return res


def phase_frontends_checkpoints(seed: int, card: str) -> dict:
    """Phase 21 (a-d), each part timed on its own phase_time line, its
    checkpoints and data files under a temporary directory removed at
    the end; collects every part's problems and raises at the end. The
    kernels line records K4's launches of (a) under "gpt2_124m", K3's of
    (b) under "gpt2_124m_restored" and K1's of (c) under "llama3_8b_hf",
    each timed at its shape here."""
    problems: list = []
    res = {"card": card}
    work = tempfile.mkdtemp(prefix="ff_phase21_")
    try:
        free_card()
        res["a"], writer = timed("21a", phase_checkpoint_resume, seed,
                                 problems, work)
        res["b"] = timed("21b", phase_serve_restored, seed, problems,
                         writer, work)
        del writer
    finally:
        shutil.rmtree(work, ignore_errors=True)
    res["c"] = timed("21c", phase_hf_llama, seed, problems)
    res["d"] = timed("21d", phase_examples, seed, problems)
    cfg = GPT2Config()
    res["k4"] = k4_check(TRAIN_BATCH * cfg.heads, GPT2_POSITIONS,
                         GPT2_POSITIONS, cfg.dim // cfg.heads, True,
                         torch.float32, seed, timed=True)
    lcfg = llama3_8b_cut(P21_LLAMA_LAYERS)
    res["k1"] = phase_flash_kernels(
        card, (1, P21_LLAMA_SEQ, lcfg.heads, lcfg.kv_heads,
               lcfg.dim // lcfg.heads), "llama3_8b_s128")
    res["k3"] = k3_case(("gpt2_124m_decode_b4_pos192", 1, ["decode"] * 4,
                         192), (cfg.heads, cfg.heads, cfg.dim // cfg.heads),
                        torch.float32, 21, card)
    for r in res["k4"].values():
        r.update(case="gpt2_124m_causal", card=card)
        log(f"kernel {json.dumps(r)}")
    if not all(r["ok"] for r in res["k4"].values()):
        problems.append(f"21: K4 at GPT-2 124M's shape: {res['k4']}")
    free_card()
    if problems:
        raise AssertionError(f"phase 21: {problems}")
    return res


P22_STEPS = 8  # 22a: fit steps, searched and unsearched
P22_RING_STEPS = 4  # 22b: fit steps of the adopted winner
# the catalog's bf16 band (analysis/num_budgets.py): a bf16 loss of a
# rewritten graph against the graph as built, on the same weights
P22_LOSS_ATOL = num_budgets.tolerance("hf-import-parity-atol")


class StageLaunches:
    """The kernels' launches inside each stage of one compile(): the
    measured cost model's sweep (search.api._maybe_measure) and the timed
    playoff (FFModel._validate_candidates), read around each call; the
    playoff's candidate pool is kept too."""

    def __init__(self):
        self.stages = {}
        self.playoff_pool = []

    def _wrap(self, owner, name, stage):
        inner = getattr(owner, name)

        def wrapper(*args, **kw):
            if stage == "playoff":
                self.playoff_pool = list(args[1])
            before = {k.name: k.launches for k in KERNELS}
            try:
                return inner(*args, **kw)
            finally:
                self.stages[stage] = {k.name: k.launches - before[k.name]
                                      for k in KERNELS}

        setattr(owner, name, wrapper)
        return inner

    def __enter__(self):
        self._saved = [(search_api, "_maybe_measure", self._wrap(
            search_api, "_maybe_measure", "measurement")),
            (FFModel, "_validate_candidates", self._wrap(
                FFModel, "_validate_candidates", "playoff"))]
        return self

    def __exit__(self, *exc):
        for owner, name, fn in self._saved:
            setattr(owner, name, fn)


def _kinds(graph) -> list:
    """A candidate's structural modes (substitution.structural_class)."""
    return sorted("/".join(k) for k in structural_class(graph))


def _playoff_report(ff, pool) -> list:
    """Each timed candidate: its modeled and timed step ms, its node
    count and structural modes, and whether it won (empty when the pool
    held one candidate and compile() timed nothing)."""
    v = getattr(ff, "strategy_validation", None)
    if v is None:
        return []
    return [{"modeled_rank": r, "modeled_ms": m, "timed_ms": t,
             "nodes": len(pool[r][1]), "structure": _kinds(pool[r][1]),
             "won": r == v["picked_modeled_rank"]}
            for r, m, t in zip(v["modeled_ranks"], v["modeled_ms"],
                               v["timed_ms"])]


def _clone_params(ff) -> tuple:
    return tuple({k: {n: t.detach().clone() for n, t in w.items()}
                  for k, w in tree.items()} for tree in ff._params)


def _fit_losses(ff, x, y, batch: int) -> list:
    """ff.fit over the batches one call each: each call's loss is that
    step's."""
    out = []
    for i in range(x.shape[0] // batch):
        pm = ff.fit(x[i * batch:(i + 1) * batch],
                    y[i * batch:(i + 1) * batch], verbose=False)
        out.append(pm.sparse_cce_loss / pm.train_all)
    return out


def phase_search_train(seed: int, problems: list, work: str) -> dict:
    """22a: bench_1b (16 layers, D 128, bf16, batch 8 x 1024, Adam lr
    1e-4, remat none) compiled with search_budget=8, measure_costs,
    validate_top_k=2 and the event simulator, exporting its strategy and
    its costed graph, from the weights of the same model compiled without
    the search (compile(params=)); both fit P22_STEPS steps on the same
    batches. The searched model's losses must hold to the unsearched
    one's within P22_LOSS_ATOL (every rewrite keeps the function on one
    card); K1 must launch in the measurement, the playoff and the fit,
    K2 in the playoff and the fit (the sweep times forwards only)."""
    cfg = LlamaConfig.bench_1b()
    x, y = _token_batches(TRAIN_BATCH * P22_STEPS, TRAIN_SEQ,
                          cfg.vocab_size, seed)
    free_card()
    plain = _train_model(cfg, DEVICE, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                         dtype=DataType.BFLOAT16, remat="none", seed=seed)
    params = _clone_params(plain)
    plain_losses = _fit_losses(plain, x, y, TRAIN_BATCH)
    del plain
    free_card()
    ff = FFModel(FFConfig(
        batch_size=TRAIN_BATCH, seed=seed, device=DEVICE, remat="none",
        search_budget=8, measure_costs=True, validate_top_k=2,
        use_simulator=True,
        export_strategy_file=os.path.join(work, "strategy.json"),
        export_strategy_computation_graph_file=os.path.join(work, "pcg.dot"),
        include_costs_dot_graph=True))
    build_llama(ff, cfg, batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                dtype=DataType.BFLOAT16)
    built_nodes = len(ff.graph)
    _reset_launches()
    t0 = time.monotonic()
    with StageLaunches() as stages:
        ff.compile(optimizer=AdamOptimizer(lr=TRAIN_LR),
                   loss_type=LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
                   metrics=[MetricsType.ACCURACY,
                            MetricsType.SPARSE_CATEGORICAL_CROSSENTROPY],
                   params=params)
    compile_s = time.monotonic() - t0
    del params
    before = _flash_launches()
    losses = _fit_losses(ff, x, y, TRAIN_BATCH)
    torch.cuda.synchronize()
    fit = {n: v - before[n] for n, v in _flash_launches().items()}
    st = ff.search_stats
    knobs = st["measured"]
    strategy = json.load(open(os.path.join(work, "strategy.json")))
    dot = open(os.path.join(work, "pcg.dot")).read()
    res = {
        "model": "bench_1b", "layers": cfg.layers, "dtype": "bfloat16",
        "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
        "op_shards_measured": knobs["op_shards"],
        "median_analytic_over_measured": knobs["median_ratio"],
        "mxu_efficiency": knobs["mxu_efficiency"],
        "search_wall_s": st["wall_s"], "best_cost_ms": st["best_cost"] * 1e3,
        "baseline_cost_ms": st["baseline_cost"] * 1e3,
        "candidates_seen": st["candidates_seen"],
        "pool": len(ff.searched_candidates),
        "winner_rules": st["winner_rules"],
        "nodes_built": built_nodes, "nodes_adopted": len(ff.graph),
        "playoff": _playoff_report(ff, stages.playoff_pool),
        "compile_s": compile_s,
        "launches": {"measurement": stages.stages.get("measurement"),
                     "playoff": stages.stages.get("playoff"),
                     "fit": fit},
        "losses": losses, "unsearched_losses": plain_losses,
        "loss_atol": P22_LOSS_ATOL,
        "strategy_views": len(strategy), "dot_costed": "ms}" in dot,
    }
    log(f"search_train {json.dumps(res)}")
    del ff
    free_card()
    k1, k2 = FLASH_ATTENTION_FWD.name, FLASH_ATTENTION_DQ.name
    for stage, names in (("measurement", (k1,)), ("playoff", (k1, k2)),
                         ("fit", (k1, k2, FLASH_ATTENTION_DKV.name))):
        got = res["launches"][stage] or {}
        if not all(got.get(n, 0) > 0 for n in names):
            problems.append(f"22a: {stage} launched {got}, wanted "
                            f"{names} each")
    if fit[k1] != cfg.layers * P22_STEPS:
        problems.append(f"22a: fit launched K1 {fit[k1]} times, wanted "
                        f"{cfg.layers * P22_STEPS}")
    if not 0 < res["mxu_efficiency"] <= 1 or res["op_shards_measured"] < 1:
        problems.append(f"22a: calibration {knobs}")
    if len(res["playoff"]) != len(stages.playoff_pool) \
            or len(res["playoff"]) < 2:
        problems.append(f"22a: playoff timed {res['playoff']} of "
                        f"{len(stages.playoff_pool)} candidates")
    diff = max(abs(a - b) for a, b in zip(losses, plain_losses))
    if not all(np.isfinite(losses)) or diff > P22_LOSS_ATOL:
        problems.append(f"22a: searched losses {losses} vs unsearched "
                        f"{plain_losses} (max diff {diff})")
    if not res["strategy_views"] or not res["dot_costed"]:
        problems.append("22a: the exports are empty")
    return res


def _eval_loss(ff, bx, by) -> float:
    with torch.no_grad():
        m = ff.executor.eval_step(*ff._params, by, bx)
    return float(m["loss"])


def phase_search_ring(seed: int, problems: list) -> dict:
    """22b: the plain bench_1b graph (no use_ring_attention) at batch 1 x
    RING_SEQ over {"seq": RING_SHARDS}, searched at budget 12 with
    validate_top_k=2 from the weights of the same graph compiled without
    the search. The pool must keep a ring-attention candidate; the
    playoff times it (K5 and K4's backward) beside the unrewritten graph
    (K1/K2 over all RING_SEQ rows) and any Ulysses candidate; modeled ms
    price RING_SHARDS H100s, timed ms are this one card's, so the two are
    not comparable. The winner fits P22_RING_STEPS steps on one repeated
    batch (finite, falling); the ring candidate's loss on the initial
    weights holds to the unrewritten graph's within P22_LOSS_ATOL."""
    cfg = LlamaConfig.bench_1b()
    mesh = {"seq": RING_SHARDS}
    x, y = _token_batches(1, RING_SEQ, cfg.vocab_size, seed)
    bx, by = (torch.from_numpy(a).to(DEVICE) for a in (x, y))
    free_card()

    def model(search: bool):
        kw = dict(search_budget=12, validate_top_k=2) if search else {}
        ff = FFModel(FFConfig(batch_size=1, seed=seed, device=DEVICE,
                              remat="none", mesh_shape=mesh, **kw))
        build_llama(ff, cfg, batch_size=1, seq_len=RING_SEQ,
                    dtype=DataType.BFLOAT16)
        return ff

    compile_kw = dict(
        optimizer=AdamOptimizer(lr=TRAIN_LR),
        loss_type=LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
        metrics=[MetricsType.SPARSE_CATEGORICAL_CROSSENTROPY])
    plain = model(False)
    plain.compile(**compile_kw)
    params = _clone_params(plain)
    plain_loss = _eval_loss(plain, bx, by)
    built = plain.graph
    del plain
    free_card()
    ff = model(True)
    _reset_launches()
    t0 = time.monotonic()
    with StageLaunches() as stages:
        ff.compile(params=params, **compile_kw)
    compile_s = time.monotonic() - t0
    pool = ff.searched_candidates
    rings = [c for c in pool if any(
        n.op_type == OpType.RING_ATTENTION and n.attrs.seq_mode == "ring"
        for n in c[1].nodes)]
    before = {k.name: k.launches for k in KERNELS}
    losses = []
    for _ in range(P22_RING_STEPS):
        pm = ff.fit(x, y, verbose=False)
        losses.append(pm.sparse_cce_loss / pm.train_all)
    torch.cuda.synchronize()
    fit = {k.name: k.launches - before[k.name] for k in KERNELS}
    st = ff.search_stats
    res = {
        "model": "bench_1b", "layers": cfg.layers, "dtype": "bfloat16",
        "batch": 1, "seq": RING_SEQ, "mesh_shape": mesh,
        "modeled_for": f"{RING_SHARDS} H100s (the modeled mesh)",
        "timed_on": "this one card: modeled and timed ms are not "
                    "comparable",
        "search_wall_s": st["wall_s"], "best_cost_ms": st["best_cost"] * 1e3,
        "baseline_cost_ms": st["baseline_cost"] * 1e3,
        "pool": [{"modeled_ms": c * 1e3, "nodes": len(g),
                  "structure": _kinds(g)} for c, g, _ in pool],
        "playoff": _playoff_report(ff, stages.playoff_pool),
        "compile_s": compile_s, "winner_structure": _kinds(ff.graph),
        "launches": {"playoff": stages.stages.get("playoff"), "fit": fit},
        "losses": losses, "unrewritten_initial_loss": plain_loss,
        "loss_atol": P22_LOSS_ATOL,
    }
    del ff
    free_card()
    if rings:
        # the ring candidate on the initial weights
        rf = model(False)
        rf.graph = min(rings, key=lambda c: c[0])[1].copy()
        rf.compile(params=carry_params(params, built, rf.graph),
                   **compile_kw)
        res["ring_initial_loss"] = _eval_loss(rf, bx, by)
        del rf
        free_card()
    log(f"search_ring {json.dumps(res)}")
    carry = FLASH_ATTENTION_BH_FWD_CARRY.name
    timed_ring = [p for p in res["playoff"] if "seq_attention/ring"
                  in p["structure"]]
    if not rings or not timed_ring:
        problems.append(f"22b: no ring candidate in the pool or playoff: "
                        f"{res['pool']}, {res['playoff']}")
    if not (res["launches"]["playoff"] or {}).get(carry):
        problems.append(f"22b: the playoff launched no K5: "
                        f"{res['launches']['playoff']}")
    ulysses = [c for c in res["pool"] if "seq_attention/ulysses"
               in c["structure"]]
    if ulysses and not any("seq_attention/ulysses" in p["structure"]
                           for p in res["playoff"]):
        problems.append(f"22b: a Ulysses candidate was not timed: "
                        f"{res['playoff']}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        problems.append(f"22b: the winner's loss did not fall: {losses}")
    ring_loss = res.get("ring_initial_loss")
    if ring_loss is None or not abs(ring_loss - plain_loss) <= P22_LOSS_ATOL:
        problems.append(f"22b: ring candidate's initial loss {ring_loss} vs "
                        f"the unrewritten graph's {plain_loss}")
    return res


def phase_search(seed: int, card: str) -> dict:
    """Phase 22 (a, b), each part timed on its own phase_time line, the
    exports under a temporary directory removed at the end; collects
    every part's problems and raises at the end. The kernels line
    records K1/K2's launches of (a) under "search_1b" and K5's and K4's
    backward's of (b) under "search_ring"."""
    problems: list = []
    res = {"card": card}
    work = tempfile.mkdtemp(prefix="ff_phase22_")
    try:
        res["a"] = timed("22a", phase_search_train, seed, problems, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    res["b"] = timed("22b", phase_search_ring, seed, problems)
    free_card()
    if problems:
        raise AssertionError(f"phase 22: {problems}")
    return res


# ---------------------------------------------------------------------------
# phase 23: the serving-strategy search, its calibration loop and the
# autopilot's drain-and-swap

# Llama-3-8B's widths at this depth, bf16: the search's priced graph and
# the servers of 23a and 23b
P23_LAYERS = 4
P23_SLOTS, P23_MAX_LEN, P23_BUDGET = 8, 256, 64
# the shared-system-prompt profile at the server's page (64: a 128-token
# system prompt) and 16 requests of 64 new tokens, 8 offered at once
P23_PROFILE = dict(page_size=64, requests=16, new_tokens=64,
                   offered_concurrency=8)
# 23b's traced serve (fftrace smoke's runs: plain paged, speculative,
# then a decode and a mixed megastep of each of the search's megastep
# widths past 1) on the first requests of the same sample
P23_TRACE_REQUESTS, P23_TRACE_NEW = 8, 32
P23_TRACE_MEGASTEP = (2, 4, 8, 16)
# 23c: fp32 (TF32 off) at this depth, for token identity, as phases 15
# and 16 compare servers; the prompts cycle through this pool
P23_SWAP_LAYERS, P23_SWAP_SLOTS, P23_SWAP_MAX_LEN = 2, 4, 128
P23_SWAP_PROMPTS, P23_SWAP_NEW = (24, 40, 56, 72), 16


# phase 23 holds K3 to its plain version at the calls its servers made:
# of each launch geometry the inputs of these calls (1-based) are kept
K3_KEEP_CALLS = (1, 8, 64, 512, 4096)


class _K3Capture:
    """Installed as paged.attention.ragged_flash_attention (the name the
    paged attention step calls): counts the calls by launch geometry (q
    dtype, pool dtype, page size, window, batch, table pages) and keeps
    clones of the inputs of each geometry's K3_KEEP_CALLS-th calls, taken
    in stream order right after the call, so that the kernel can be held
    to its plain version at what the servers gave it."""

    def __init__(self):
        import flexflow_tpu_torch.paged.attention as pa

        self.module, self.fn = pa, pa.ragged_flash_attention
        self.counts, self.kept = {}, {}
        self.lock = threading.Lock()

    def __enter__(self):
        def capture(q, kc, vc, pt, pos, qls, anc, *, scale, k_scales=None,
                    v_scales=None):
            out = self.fn(q, kc, vc, pt, pos, qls, anc, scale=scale,
                          k_scales=k_scales, v_scales=v_scales)
            key = (str(q.dtype).replace("torch.", ""),
                   str(kc.dtype).replace("torch.", ""), int(kc.shape[1]),
                   int(q.shape[1]), int(q.shape[0]), int(pt.shape[1]))
            with self.lock:
                n = self.counts[key] = self.counts.get(key, 0) + 1
            if n in K3_KEEP_CALLS:
                sc = ({} if k_scales is None else
                      {"k_scales": k_scales.clone(),
                       "v_scales": v_scales.clone()})
                kept = tuple(t.clone() for t in (q, kc, vc, pt, pos, qls,
                                                 anc))
                with self.lock:
                    self.kept.setdefault(key, []).append(
                        (n, kept, sc, scale))
            return out

        self.module.ragged_flash_attention = capture
        return self

    def __exit__(self, *exc):
        self.module.ragged_flash_attention = self.fn


def k3_served_checks(cap: _K3Capture, card: str, label: str) -> list:
    """Every call `cap` kept, through the K3 wrapper and its plain version
    on the same inputs (_kernel_check: max |err| within TOLS's tol, or
    INT8_TOLS's for an int8 pool, x max(1, max |plain|); rows past q_len
    exact zeros; an AssertionError on any difference); each geometry's
    last kept call timed beside its bound and, over an fp pool, SDPA.
    Returns one record a geometry (its last kept call) with its calls."""
    sm = torch.cuda.get_device_properties(0).multi_processor_count
    out = []
    with torch.inference_mode():
        for key in sorted(cap.kept):
            qd, pool, page, window, batch, maxp = key
            kept = sorted(cap.kept[key], key=lambda k: k[0])
            for i, (n, args, sc, scale) in enumerate(kept):
                last = i == len(kept) - 1
                extra = {"served": label, "page_size": page,
                         "window": window, "batch": batch,
                         "table_pages": maxp, "call": n,
                         "calls": cap.counts[key],
                         "split_plan": list(ragged_split_plan(
                             batch, window, args[0].shape[2],
                             args[1].shape[2], page, maxp, sm))}
                if last:
                    extra["library_ms"] = (None if sc else time_ms(
                        library_call(args, scale)))
                tol = (INT8_TOLS[args[0].dtype] if sc
                       else TOLS[args[0].dtype][0])
                res = _kernel_check(f"{label}_{pool}_page{page}_w{window}"
                                    f"_b{batch}_t{maxp}",
                                    args[0].dtype, tol, args, sc, scale,
                                    card, extra, time_it=last)
                if last:
                    out.append(res)
    cap.kept.clear()
    torch.cuda.empty_cache()
    return out


def p23_profile(vocab: int, seed: int):
    """23a's traffic: the shared-system-prompt profile sized to the
    server (P23_PROFILE) and one seeded sample of it."""
    from flexflow_tpu_torch.search.traffic import get_profile

    prof = get_profile("shared-system-prompt", **P23_PROFILE)
    return prof, prof.sample(np.random.RandomState(seed), vocab)


def serve_strategy_run(ff, strategy, prompts, new: int) -> dict:
    """`prompts` through serve_generation(serve_strategy=strategy), every
    request queued before the loop starts (the burst the pricer's
    offered concurrency fills); kernel counts reset just before start,
    read after the last result. TTFT p95 from the request log, decoded
    tokens over the wall, K3's fp and int8 launches."""
    server = ff.serve_generation(slots=P23_SLOTS, max_len=P23_MAX_LEN,
                                 serve_strategy=strategy, defer_start=True)
    try:
        futs = [server.submit(p, max_new_tokens=new) for p in prompts]
        torch.cuda.synchronize()
        _reset_launches()
        t0 = time.monotonic()
        server.start()
        outs = [np.asarray(f.result(timeout=900)) for f in futs]
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = {k.name: k.launches for k in KERNELS}
    finally:
        server.stop()
    records = server.request_log.records()
    server.pool.check_invariants(owners={})
    m = server.metrics()
    return {"server": server, "outs": outs, "records": records,
            "res": {"fingerprint": server.strategy_fingerprint,
                    "preemptions": m["preemptions"],
                    "prefix_hit_tokens": m["prefix_cache"]["hit_tokens"],
                    "host_tier": m["host_tier"],
                    "decode_steps": m["decode_steps"],
                    "megastep": {k: m["megastep"][k] for k in (
                        "dispatches", "ticks_run", "host_roundtrips",
                        "host_roundtrips_per_token", "breaks")},
                    "wall_s": wall,
                    # nearest rank, as the simulator's and the SLO's
                    "ttft_p95_s": percentile([(r["first_token_ns"]
                                               - r["submit_ns"]) / 1e9
                                              for r in records], 0.95),
                    "tokens_per_s": sum(len(o) for o in outs) / wall,
                    "launches": {k: launches[k] for k in (
                        RAGGED_PAGED_ATTENTION.name,
                        RAGGED_PAGED_ATTENTION_INT8.name)},
                    "ragged_steps": m["ragged_steps"]}}


def _predicted(m: dict) -> dict:
    return {"ttft_p95_s": m["ttft_p95_s"],
            "s_per_token": 1.0 / max(m["tokens_per_s"], 1e-12),
            "tokens_per_s": m["tokens_per_s"]}


def phase_search_serve(seed: int, problems: list, ff, work: str) -> dict:
    """23a: serve_generation(paged=True, search_budget=P23_BUDGET,
    traffic=the shared-system-prompt profile) on the H100 machine model:
    the search's seconds, winner and predicted TTFT p95 and seconds a
    token; then the profile's sample served through the winner and
    through ServeStrategy() (each warmed first on two requests): measured
    TTFT p95, tokens/s and K3's launches (fp, int8) beside the
    predictions. The winner's K3 body must launch once a layer and
    ragged step, every output must be in the vocabulary, and the
    strategy serve_generation searched must be the one search_serve_
    strategy returns for the same call. The share of tokens the two
    serves agree on is reported, not checked: their pools differ in
    dtype and page size, so int8 rounding and bf16 sums in another order
    may pick other tokens; each K3 call is held to its plain version on
    its own inputs after the part (k3_served_checks), and 23c holds
    whole streams in fp32."""
    from flexflow_tpu_torch.search.servesearch import search_serve_strategy

    cfg = llama3_8b_cut(P23_LAYERS)
    prof, sample = p23_profile(cfg.vocab_size, seed)
    t0 = time.monotonic()
    found = search_serve_strategy(ff, traffic=prof, budget=P23_BUDGET,
                                  slots=P23_SLOTS, max_len=P23_MAX_LEN)
    search_s = time.monotonic() - t0
    gen = ff.serve_generation(paged=True, search_budget=P23_BUDGET,
                              traffic=prof, slots=P23_SLOTS,
                              max_len=P23_MAX_LEN, defer_start=True)
    gen.stop()
    if gen.serve_strategy != found.best:
        problems.append(f"23a: serve_generation served "
                        f"{gen.serve_strategy}, the search found "
                        f"{found.best}")
    res = {"model": "llama3_8b", "layers": cfg.layers, "dtype": "bfloat16",
           "slots": P23_SLOTS, "max_len": P23_MAX_LEN,
           "profile": {"name": prof.name, **P23_PROFILE,
                       "stats": found.stats},
           "search": {"seconds": search_s, "budget": P23_BUDGET,
                      "trials": found.trials,
                      "machine": "H100MachineModel (datasheet defaults)",
                      "layouts": found.layouts,
                      "winner": found.best.to_json(),
                      "winner_describe": found.best.describe(),
                      "improvement": found.improvement}}
    runs = {}
    for key, strategy, predicted in (
            ("winner", found.best, found.best_metrics),
            ("default", found.default, found.default_metrics)):
        serve_strategy_run(ff, strategy, sample.prompts[:2], 4)  # warm
        run = serve_strategy_run(ff, strategy, sample.prompts,
                                 prof.new_tokens)
        runs[key] = run
        res[key] = dict(run["res"], predicted=_predicted(predicted),
                        describe=strategy.describe())
        for o in run["outs"]:
            if len(o) != prof.new_tokens or not (
                    (0 <= o) & (o < cfg.vocab_size)).all():
                problems.append(f"23a {key}: bad output {o}")
    body = (RAGGED_PAGED_ATTENTION_INT8 if found.best.kv_dtype == "int8"
            else RAGGED_PAGED_ATTENTION)
    _k3_ok("23a winner", {"launches": runs["winner"]["res"]["launches"],
                          "ragged_steps": runs["winner"]["res"][
                              "ragged_steps"]}, cfg.layers, problems, body)
    res["same_tokens_share"] = _same_share(runs["winner"]["outs"],
                                           runs["default"]["outs"])
    reqlog_path = os.path.join(work, "winner_reqlog.jsonl")
    runs["winner"]["server"].request_log.export_jsonl(reqlog_path)
    log(f"servesearch {json.dumps(res)}")
    return {"res": res, "found": found, "profile": prof, "sample": sample,
            "reqlog": reqlog_path,
            "measured_ttft_p95_s": runs["winner"]["res"]["ttft_p95_s"]}


def phase_calibration_loop(seed: int, problems: list, ff, a: dict,
                           work: str) -> dict:
    """23b: fftrace's traced serve (the smoke's plain and speculative
    runs, and decode and mixed megasteps of P23_TRACE_MEGASTEP ticks) of
    the first P23_TRACE_REQUESTS requests on the card, stamped
    with the card; `fftrace calibrate` of its ledger: measured/predicted
    scales by tick shape; the search again with that report: how the
    winner and its predictions move, and the new winner served as 23a
    serves (measured TTFT p95, tokens/s, K3); then `servesearch simulate`'s
    simulator on 23a's winner request log, uncalibrated and calibrated,
    beside the TTFT p95 23a measured. The report must carry this card's
    name, a decode, a prefill and a verify shape and a fused decode
    shape (width past 1), and the second search must have used it."""
    from flexflow_tpu_torch.search.servesearch import search_serve_strategy
    from flexflow_tpu_torch.tools import fftrace
    from flexflow_tpu_torch.tools import servesearch as servesearch_cli

    out = os.path.join(work, "fftrace")
    summary = fftrace.traced_serve(
        ff, a["sample"].prompts[:P23_TRACE_REQUESTS], out,
        max_new=P23_TRACE_NEW, speculate=SpecConfig(width=2, depth=3),
        megastep=P23_TRACE_MEGASTEP, server_kwargs=dict(slots=P23_SLOTS, max_len=P23_MAX_LEN,
                           page_size=64), fixture="chip_smoke 23b")
    cal_path = os.path.join(work, "calibration.json")
    rc = fftrace.main(["calibrate", summary["ledger"], "--out", cal_path])
    with open(cal_path) as f:
        report = json.load(f)
    prof = a["profile"]
    again = search_serve_strategy(ff, traffic=prof, budget=P23_BUDGET,
                                  slots=P23_SLOTS, max_len=P23_MAX_LEN,
                                  calibration=cal_path)
    winner = a["found"].best
    serve_strategy_run(ff, again.best, a["sample"].prompts[:2], 4)  # warm
    served = serve_strategy_run(ff, again.best, a["sample"].prompts,
                                prof.new_tokens)
    sims = {}
    for key, calib in (("uncalibrated", None), ("calibrated", cal_path)):
        sim, closed = servesearch_cli.simulate(
            ff, a["reqlog"], winner, slots=P23_SLOTS, max_len=P23_MAX_LEN,
            seed=seed, calibration=calib)
        sims[key] = {"sim_ttft_p95_s": sim.metrics["ttft_p95_s"],
                     "sim_tokens_per_s": sim.metrics["tokens_per_s"],
                     "closed_form_ttft_p95_s": closed["ttft_p95_s"],
                     "ticks": sim.ticks}
    res = {"card": report["meta"].get("card"),
           "trace": {k: summary[k] for k in ("reqlog_records", "events",
                                             "shapes")},
           "base": report["base"],
           "tick_scales": report["tick_scales"],
           "phases": report["phases"],
           "search_before": {"winner": winner.describe(),
                             "predicted": _predicted(
                                 a["found"].best_metrics)},
           "search_after": {"winner": again.best.describe(),
                            "predicted": _predicted(again.best_metrics),
                            "calibration": again.calibration,
                            "measured": served["res"]},
           "winner_moved": again.best != winner,
           "simulate": sims,
           "measured_ttft_p95_s": a["measured_ttft_p95_s"]}
    log(f"calibration {json.dumps(res)}")
    phases = {parse.split("|")[0] for parse in report["tick_scales"]}
    body = (RAGGED_PAGED_ATTENTION_INT8 if again.best.kv_dtype == "int8"
            else RAGGED_PAGED_ATTENTION)
    _k3_ok("23b calibrated winner", served["res"],
           llama3_8b_cut(P23_LAYERS).layers, problems, body)
    checks = {"calibrate_rc": rc == 0,
              "card": res["card"] == torch.cuda.get_device_name(0),
              "shapes": {"decode", "prefill", "verify"} <= phases,
              "fused_shapes": any(k.startswith("decode|")
                                  and not k.endswith("|w1")
                                  for k in report["tick_scales"]),
              "used": bool((again.calibration or {}).get("used"))}
    if not all(checks.values()):
        problems.append(f"23b: {checks}")
    res["checks"] = checks
    res["launches"] = served["res"]["launches"]
    return res


def swap_fixture(seed: int):
    """23c's model (Llama-3-8B's widths at P23_SWAP_LAYERS layers, fp32,
    seeded), its prompt pool, and the strategies swapped from and to."""
    from flexflow_tpu_torch.search.servesearch import ServeStrategy

    cfg = llama3_8b_cut(P23_SWAP_LAYERS)
    ff = FFModel(FFConfig(batch_size=1, seed=seed, device=DEVICE))
    build_llama(ff, cfg, batch_size=1, seq_len=P23_SWAP_MAX_LEN,
                dtype=DataType.FLOAT)
    ff.compile()
    rs = np.random.RandomState(seed + 23)
    pool = [rs.randint(0, cfg.vocab_size, (n,)).astype(np.int32)
            for n in P23_SWAP_PROMPTS]
    first = ServeStrategy(page_size=16, prefill_chunk=32)
    return ff, cfg, pool, first, dataclasses.replace(first, prefill_chunk=16)


# 23c's probe of the swap's warm-up: one fresh process a mode, in this
# order, so that no swap inherits another's loaded modules or allocator
P23_PROBE_ORDER = ("cold", "warm", "warm", "cold")


def swap_probe(seed: int, mode: str) -> dict:
    """One swap in this (fresh) process, 23c's model, strategies and
    prompts, fp32 with TF32 off: the predecessor serves two requests,
    the pool's four are submitted and the autopilot swaps to the
    successor with its warm-up (warm_launch_shapes) on (`mode` "warm")
    or stood in by a no-op ("cold"). The
    wall of the successor's first tick (a prefill of the carried
    requests) and of its second, the stall from the cutover's start to
    the first tick's end, and the warm-up's seconds, by timing every
    prefill and decode tick of the server class."""
    from flexflow_tpu_torch.serving_autopilot import ServingAutopilot

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ff, cfg, pool, first, alt = swap_fixture(seed)
    ap = ServingAutopilot(ff, first, slots=P23_SWAP_SLOTS,
                          max_len=P23_SWAP_MAX_LEN)
    ticks = []
    cls = type(ap.server)
    if mode == "cold":
        cls.warm_launch_shapes = lambda self: []
    for name in ("_prefill_tick", "_decode_tick"):
        def timed_tick(self, *a, _fn=getattr(cls, name), _name=name):
            t = time.monotonic()
            try:
                return _fn(self, *a)
            finally:
                ticks.append((id(self), _name, t, time.monotonic()))
        setattr(cls, name, timed_tick)
    try:
        for k in range(2):
            ap.generate(pool[k], P23_SWAP_NEW)
        futs = [ap.submit(p, max_new_tokens=P23_SWAP_NEW) for p in pool]
        t_call = time.monotonic()
        swap = ap.swap_to(alt)
        t_cut = time.monotonic() - swap["cutover_s"]
        for f in futs:
            f.result(timeout=900)
        new = id(ap.server)
    finally:
        ap.stop()
    mine = sorted((t for t in ticks if t[0] == new), key=lambda t: t[2])
    return {"mode": mode, "carried": swap["carried"],
            "warmed": swap["warmed"], "build_and_warm_s": t_cut - t_call,
            "cutover_ms": 1e3 * swap["cutover_s"],
            "first_tick": mine[0][1],
            "first_tick_ms": 1e3 * (mine[0][3] - mine[0][2]),
            "stall_ms": 1e3 * (mine[0][3] - t_cut),
            "second_tick_ms": 1e3 * (mine[1][3] - mine[1][2]),
            "ticks": len(mine)}


def phase_swap_probes(seed: int) -> dict:
    """P23_PROBE_ORDER's swap_probe runs, each `chip_smoke.py --swap-probe
    MODE` in a process of its own; a failed probe raises."""
    runs = []
    for mode in P23_PROBE_ORDER:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--swap-probe",
             mode, "--seed", str(seed)], capture_output=True, text=True,
            timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"swap probe {mode}: exit "
                                 f"{proc.returncode}: {proc.stderr[-3000:]}")
        runs.append(json.loads(proc.stdout.splitlines()[-1]))
    res = {"runs": runs}
    for mode in ("cold", "warm"):
        mine = [r for r in runs if r["mode"] == mode]
        for key in ("first_tick_ms", "stall_ms", "second_tick_ms"):
            res[f"{mode}_{key}"] = [r[key] for r in mine]
    log(f"swap_probe {json.dumps(res)}")
    return res


def phase_hot_swap(seed: int, problems: list) -> dict:
    """23c: fp32 with TF32 off, Llama-3-8B's widths at P23_SWAP_LAYERS
    layers: a ServingAutopilot on ServeStrategy(page 16, chunk 32) serves
    the P23_SWAP_PROMPTS pool, two requests before the swap and four in
    flight when swap_to(chunk 16) is called while a thread keeps
    submitting; every request's tokens must equal the one-tick loop's
    for its prompt (one server of the first strategy, no swap), at least
    one request must be carried, the pool adopted, the request log must
    hold both fingerprints and metrics() one swap. The cutover ms."""
    from flexflow_tpu_torch.serving_autopilot import ServingAutopilot

    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        ff, cfg, pool, first, alt = swap_fixture(seed)
        ref = ff.serve_generation(slots=P23_SWAP_SLOTS,
                                  max_len=P23_SWAP_MAX_LEN,
                                  serve_strategy=first)
        try:
            want = [ref.generate(p, P23_SWAP_NEW, timeout=900)
                    for p in pool]
        finally:
            ref.stop()
        ap = ServingAutopilot(ff, first, slots=P23_SWAP_SLOTS,
                              max_len=P23_SWAP_MAX_LEN)
        futs, done = [], threading.Event()

        def submitter():
            i = 0
            while not done.is_set():
                if sum(1 for _, f in futs if not f.done()) < 8:
                    futs.append((i % len(pool), ap.submit(
                        pool[i % len(pool)], max_new_tokens=P23_SWAP_NEW)))
                    i += 1
                else:
                    time.sleep(0.002)

        try:
            fp_old = ap.strategy_fingerprint
            before = [ap.generate(pool[k], P23_SWAP_NEW) for k in range(2)]
            for k in range(len(pool)):
                futs.append((k, ap.submit(pool[k],
                                          max_new_tokens=P23_SWAP_NEW)))
            feeder = threading.Thread(target=submitter)
            feeder.start()
            swap = ap.swap_to(alt)
            time.sleep(0.2)
            done.set()
            feeder.join(timeout=120)
            outs = [(k, np.asarray(f.result(timeout=900)))
                    for k, f in futs]
            after = [ap.generate(pool[k], P23_SWAP_NEW)
                     for k in range(len(pool))]
            stamps = {r.get("strategy")
                      for r in ap.request_log.records()}
            swaps = ap.metrics()["autopilot"]["swaps"]
        finally:
            done.set()
            ap.stop()
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    mismatched = sum(not np.array_equal(o, want[k]) for k, o in outs)
    mismatched += sum(not np.array_equal(o, want[k])
                      for k, o in enumerate(before))
    mismatched += sum(not np.array_equal(o, want[k])
                      for k, o in enumerate(after))
    res = {"layers": cfg.layers, "dtype": "float32",
           "from": first.describe(), "to": alt.describe(),
           "requests": len(outs) + len(before) + len(after),
           "mismatched": mismatched, "carried": swap["carried"],
           "pool_adopted": swap["pool_adopted"],
           "warmed": swap["warmed"],
           "cutover_ms": 1e3 * swap["cutover_s"],
           "fingerprints": sorted(s for s in stamps if s)}
    log(f"hot_swap {json.dumps(res)}")
    checks = {"tokens": mismatched == 0, "carried": swap["carried"] >= 1,
              "adopted": swap["pool_adopted"] is True,
              "stamps": stamps == {fp_old, alt.fingerprint()},
              "swaps": swaps == 1}
    res["checks"] = checks
    if not all(checks.values()):
        problems.append(f"23c: {checks}")
    return res


def phase_servesearch(seed: int, card: str) -> dict:
    """Phase 23 (a-c), each part timed on its own phase_time line, the
    request log and the fftrace output under a temporary directory
    removed at the end; collects every part's problems and raises at the
    end. Each part runs under a _K3Capture, and after it every K3 call
    kept is held to the plain version (k3_served_checks, "k3_served":
    one timed record a launch geometry), so whatever strategy the search
    picked is checked at its page size, pool dtype and windows. The
    kernels line records K3's launches (fp and int8) of (a)'s winner and
    default serves and (b)'s calibrated winner's under "servesearch",
    with those records."""
    problems: list = []
    res = {"card": card, "k3_served": []}
    free_card()
    work = tempfile.mkdtemp(prefix="ff_phase23_")
    try:
        ff = _llama_cut(P23_LAYERS, seed, DataType.BFLOAT16)
        with _K3Capture() as cap:
            a = timed("23a", phase_search_serve, seed, problems, ff, work)
        res["k3_served"] += timed("23a:k3", k3_served_checks, cap, card,
                                  "23a")
        res["a"] = a["res"]
        launches = {k: res["a"]["winner"]["launches"][k]
                    + res["a"]["default"]["launches"][k]
                    for k in res["a"]["winner"]["launches"]}
        with _K3Capture() as cap:
            res["b"] = timed("23b", phase_calibration_loop, seed, problems,
                             ff, a, work)
        res["k3_served"] += timed("23b:k3", k3_served_checks, cap, card,
                                  "23b")
        launches = {k: n + res["b"]["launches"][k]
                    for k, n in launches.items()}
        res["launches"] = launches
        del ff, a
    finally:
        shutil.rmtree(work, ignore_errors=True)
    free_card()
    with _K3Capture() as cap:
        res["c"] = timed("23c", phase_hot_swap, seed, problems)
    res["k3_served"] += timed("23c:k3", k3_served_checks, cap, card, "23c")
    free_card()
    res["c"]["probe"] = timed("23c:probe", phase_swap_probes, seed)
    if problems:
        raise AssertionError(f"phase 23: {problems}")
    return res


def _zoo_k4_entries(kernel, zoo) -> tuple:
    """(key, launches, timed case) of K4 kernel `kernel` on phase 18: BERT-
    base's fit at dropout 0 (18a) under "bert_base", and the encoder-
    decoder's fit (18b, all three attentions) under "encdec_self",
    "encdec_causal" and "encdec_cross", each timed at its own shape
    (K4_ZOO_CASES); the encoder-decoder's launches, one fit over all
    three shapes, stand under each of its keys."""
    out = []
    for case, *_ in K4_ZOO_CASES:
        if zoo is None:
            launches = 0
        elif case == "bert_base":
            launches = zoo["a"]["fit_dropout_0.0"]["launches"][kernel.name]
        else:
            launches = zoo["b"]["launches"][kernel.name]
        timed = (zoo or {}).get("k4", {}).get(case, {}).get(kernel.name)
        out.append((case, launches, timed))
    return tuple(out)


def _batch_serve_k4_entry(kernel, p19) -> tuple:
    """K4's forward under the batch server (phase 19c: BERT-base, fp32
    bodies), timed at its largest batch's attention shape; the backward
    kernels do not run there."""
    if kernel is not FLASH_ATTENTION_BH_FWD:
        return ()
    if p19 is None:
        return (("bert_serve", 0, None),)
    return (("bert_serve",
             p19["c"]["launches"][FLASH_ATTENTION_BH_FWD.name],
             p19["c"]["k4"][FLASH_ATTENTION_BH_FWD.name]),)


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
    ap.add_argument("--phases",
                    default="1,2,3,4,6,7,8,9,10,11,12,13,14,15,16,17,18,19,"
                    "20,21,22,23",
                    help="comma-separated phases to run (default "
                    "1,2,3,4,6,7,8,9,10,11,12,13,14,15,16,17,18,19,20,21,"
                    "22,23; 5 profiles serving and training steps)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--swap-probe", choices=("warm", "cold"),
                    help="run only phase 23c's swap_probe in this mode and "
                    "print its JSON (phase 23 starts these itself)")
    args = ap.parse_args(argv)
    phases = {int(p) for p in args.phases.split(",")}
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", flush=True)
        return 2
    if args.swap_probe:
        print(json.dumps(swap_probe(args.seed, args.swap_probe)),
              flush=True)
        return 0
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
             "hgmma": hgmma_counts(), "ptxas": ptxas_report(),
             "tf32_hmma": tf32_hmma_counts()}
    log(f"build {json.dumps(built)}")
    kern = timed("2:k3", phase_kernels, card) if 2 in phases else []
    if 2 in phases:
        timed("2:split_sweep", split_sweep, card)
        timed("2:split_sweep_tree", split_sweep, card,
              [c[0] for c in ATTENTION_CASES].index("tree_w9"))
    kern8 = timed("2:k3_int8", phase_int8_kernels, card) \
        if 2 in phases else []
    wide = timed("2:k3_wide", phase_wide_windows, card) \
        if 2 in phases else []
    if 2 in phases:
        timed("2:k3_pages", phase_page_sizes, card)
    flash = timed("2:k1k2", phase_flash_kernels, card) \
        if 2 in phases else {}
    flash_mixtral = (timed("2:k1k2_mixtral", phase_flash_kernels, card,
                           MIXTRAL_FLASH_SHAPE, "mixtral_8x7b_causal")
                     if 2 in phases else {})
    if 2 in phases:
        for case, shape, T, causal in FLASH_CASES:
            timed(f"2:k1k2_{case}", phase_flash_kernels, card, shape, case,
                  T, causal)
    k4 = timed("2:k4", phase_k4_kernels, card) if 2 in phases else {}
    k5 = timed("2:k5", phase_k5_kernels, card) if 2 in phases else {}
    step3 = None
    if 3 in phases:
        timed("3:step", phase_step, args.seed)
        timed("3:gpt2_step", phase_gpt2_step, args.seed)
        step3 = timed("3:train_step", phase_train_step, args.seed)
        timed("3:train_step_gpt2_xl", phase_train_step, args.seed,
              gpt2_xl(), "gpt2_xl")
        timed("3:train_step_ring", phase_train_step, args.seed,
              label="bench_1b_ring", seq=1024,
              mesh_shape={"seq": RING_SHARDS})
        timed("3:ring_untiled", phase_ring_untiled, args.seed)
        timed("3:mixtral_step", phase_mixtral_step, args.seed)
        timed("3:mixtral_train_step", phase_mixtral_train_step, args.seed)
        timed("3:zoo_step", phase_zoo_step, args.seed)
    serve = timed("4", phase_serve, args.seed, card) if 4 in phases \
        else None
    train = timed("6", phase_train, args.seed, card) if 6 in phases \
        else None
    serve8 = timed("7", phase_serve_int8, args.seed, card) if 7 in phases \
        else None
    gpt2 = timed("8", phase_gpt2_train, args.seed, card) if 8 in phases \
        else None
    if 9 in phases:
        timed("9", phase_gpt2_serve, args.seed, card)
    ring = timed("10", phase_ring_train, args.seed, card) if 10 in phases \
        else None
    train_200m = (timed("11", phase_train_200m, args.seed, card)
                  if 11 in phases else None)
    train_phi3 = (timed("12", phase_train_phi3, args.seed, card)
                  if 12 in phases else None)
    train_ollama = (timed("13", phase_train_openllama, args.seed, card)
                    if 13 in phases else None)
    ring_wide = (timed("14", phase_ring_train_wide_heads, args.seed, card)
                 if 14 in phases else None)
    spec15 = (timed("15", phase_spec_megastep, args.seed, card)
              if 15 in phases else None)
    mixed16 = (timed("16", phase_mixed_dense, args.seed, card)
               if 16 in phases else None)
    mixtral17 = (timed("17", phase_mixtral, args.seed, card)
                 if 17 in phases else None)
    zoo18 = timed("18", phase_zoo, args.seed, card) if 18 in phases \
        else None
    p19 = (timed("19", phase_pipeline_and_serving, args.seed, card)
           if 19 in phases else None)
    p20 = (timed("20", phase_tier_disagg_canary_trace, args.seed, card)
           if 20 in phases else None)
    p21 = (timed("21", phase_frontends_checkpoints, args.seed, card)
           if 21 in phases else None)
    p22 = timed("22", phase_search, args.seed, card) if 22 in phases \
        else None
    p23 = timed("23", phase_servesearch, args.seed, card) if 23 in phases \
        else None
    if 5 in phases:
        phase_profile(args.seed, card)
        phase_profile_train(args.seed, card)
        phase_profile_train(args.seed, card, gpt2_xl(), "gpt2_xl")
        phase_profile_train(args.seed, card, label="bench_1b_ring_s8192",
                            batch=1, seq=RING_SEQ,
                            mesh_shape={"seq": RING_SHARDS})
        phase_profile_train(args.seed, card, llama_200m(), "llama_200m")
        phase_profile_train(args.seed, card, phi3_mini(), "phi3_mini")
        phase_profile_train(args.seed, card, open_llama_3b(),
                            "openllama_3b")
        phase_profile_train(args.seed, card, phi3_mini(),
                            "phi3_mini_ring_s8192", batch=1, seq=RING_SEQ,
                            mesh_shape={"seq": RING_SHARDS})
        phase_profile_train(args.seed, card,
                            mixtral_8x7b(MIXTRAL_TRAIN_LAYERS),
                            "mixtral_8x7b", batch=MIXTRAL_BATCH,
                            seq=MIXTRAL_SEQ)
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
    # K3 at the speculative verify's tree window: launches at S 9 in
    # phase 15 (b) (bf16, fp pool) and (c) (fp32 q, int8 pool), timed at
    # phase 2's tree_w9 case in the same q dtype
    for entry, results, part, name, dtype in (
            (entries[0], kern, "b", "spec", "bfloat16"),
            (entries[1], kern8, "c", "spec_int8", "float32")):
        launches = spec15[part][name]["tree_window_launches"] if spec15 \
            else 0
        case = next((r for r in results if r["case"] == "tree_w9"
                     and r["dtype"] == dtype), None)
        tree = _kernel_entry(RAGGED_PAGED_ATTENTION, entry["source"],
                             launches, case)
        entry["tree_w9"] = {name: val for name, val in tree.items()
                            if name not in ("name", "route", "source",
                                            "replaces")}
    # K3 at the universal megastep's window 8 (launches in phase 16 (a)'s
    # greedy mixed run, timed at phase 2's mixed_w8) and at the unpacked
    # prefill's window 64 (launches in 16 (d), timed at phase 2's
    # unpacked_chunk64_w64), bf16 q over a bf16 pool
    w8 = (mixed16["a"]["mixed"]["launches_by_window"].get(
        f"{MIXED_WINDOW}/bfloat16", 0) if mixed16 else 0)
    for key, launches, results, case in (
            ("mixed_w8", w8, kern, "mixed_w8"),
            ("unpacked_w64", mixed16["unpacked_w64_launches"] if mixed16
             else 0, wide, "unpacked_chunk64_w64")):
        res = next((r for r in results if r["case"] == case
                    and r["dtype"] == "bfloat16"
                    and r.get("pool", "bfloat16") == "bfloat16"), None)
        other = _kernel_entry(RAGGED_PAGED_ATTENTION, entries[0]["source"],
                              launches, res)
        entries[0][key] = {name: val for name, val in other.items()
                           if name not in ("name", "route", "source",
                                           "replaces")}
    # K3 serving Mixtral-8x7B's widths (phase 17b), timed at phase 2's
    # steady decode case, whose attention widths (32 heads over 8 of 128,
    # page 64) are Mixtral's
    moe = _kernel_entry(
        RAGGED_PAGED_ATTENTION, entries[0]["source"],
        mixtral17["b"]["launches"][RAGGED_PAGED_ATTENTION.name]
        if mixtral17 else 0, main_case)
    entries[0]["mixtral"] = {name: val for name, val in moe.items()
                             if name not in ("name", "route", "source",
                                             "replaces")}
    # K3 serving phase 19d's requests behind http_serve with the request
    # log and the SLO on (Llama-3-8B's widths at 4 layers), timed at
    # phase 2's steady decode case
    other = _kernel_entry(
        RAGGED_PAGED_ATTENTION, entries[0]["source"],
        p19["d"]["observed"]["launches"][RAGGED_PAGED_ATTENTION.name]
        if p19 else 0, main_case)
    entries[0]["http_serve"] = {name: val for name, val in other.items()
                                if name not in ("name", "route", "source",
                                                "replaces")}
    # K3 on phase 20's main paths, timed at phase 2's steady decode case:
    # the tiered server of (a), the disaggregated pair of (b) and the
    # traced server of (d), bf16 q over bf16 pools ("tier_disagg_trace");
    # the canary's shadow replays of (c), bf16 q over the fp32 shadow
    # pool, timed at phase 2's case of that dtype pair ("canary_shadow");
    # and the int8 kernel under the canary's live steps of (c)
    fp32_pool = next((r for r in kern8 if r["case"].endswith("_fp32_pool")),
                     None)
    for entry, kernel, key, launches, case in (
            (entries[0], RAGGED_PAGED_ATTENTION, "tier_disagg_trace",
             (p20["a"]["tier"]["launches"][RAGGED_PAGED_ATTENTION.name]
              + p20["b"]["pair"]["launches"][RAGGED_PAGED_ATTENTION.name]
              + p20["d"]["traced"]["launches"][RAGGED_PAGED_ATTENTION.name])
             if p20 else 0, main_case),
            (entries[0], RAGGED_PAGED_ATTENTION, "canary_shadow",
             p20["c"]["canary"]["launches"][RAGGED_PAGED_ATTENTION.name]
             if p20 else 0, fp32_pool),
            (entries[1], RAGGED_PAGED_ATTENTION_INT8, "canary",
             p20["c"]["canary"]["launches"][
                 RAGGED_PAGED_ATTENTION_INT8.name] if p20 else 0,
             int8_case)):
        other = _kernel_entry(kernel, entry["source"], launches, case)
        entry[key] = {name: val for name, val in other.items()
                      if name not in ("name", "route", "source", "replaces")}
    # K3 serving phase 21b's restored GPT-2 124M (fp32 q over an fp32
    # pool: Adam's masters), timed at its decode shape in phase 21
    other = _kernel_entry(
        RAGGED_PAGED_ATTENTION, entries[0]["source"],
        p21["b"]["launches"][RAGGED_PAGED_ATTENTION.name] if p21 else 0,
        p21["k3"] if p21 else None)
    entries[0]["gpt2_124m_restored"] = {
        name: val for name, val in other.items()
        if name not in ("name", "route", "source", "replaces")}
    # K3 serving phase 23a's searched winner and the default strategy and
    # 23b's calibrated winner (Llama-3-8B's widths at 4 layers, bf16 q):
    # each body's numbers are those of phase 23's own calls, held to the
    # plain version at the geometry it launched most ("k3_served"), and
    # every geometry phase 23 launched stands under "served"
    for entry, kernel, int8 in (
            (entries[0], RAGGED_PAGED_ATTENTION, False),
            (entries[1], RAGGED_PAGED_ATTENTION_INT8, True)):
        served = [r for r in (p23["k3_served"] if p23 else [])
                  if (r["pool"] == "int8") == int8]
        case = max(served, key=lambda r: r["calls"], default=None)
        other = _kernel_entry(kernel, entry["source"],
                              p23["launches"][kernel.name] if p23 else 0,
                              case)
        if case is not None:
            other.update({k: case[k] for k in ("page_size", "window",
                                                "batch", "dtype", "pool")},
                         part=case["served"])
        other["served"] = [
            {k: r[k] for k in ("served", "dtype", "pool", "page_size",
                               "window", "batch", "calls", "split_plan",
                               "max_abs_err", "limit", "ms", "plain_ms",
                               "bound_ms", "bound_by", "library_ms")}
            for r in served]
        entry["servesearch"] = {name: val for name, val in other.items()
                                if name not in ("name", "route", "source",
                                                "replaces")}
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
        # phase 17a's fit at Mixtral-8x7B's widths, timed at its
        # attention shape (phase 2's mixtral_8x7b_causal)
        moe = _kernel_entry(
            k, entry["source"],
            mixtral17["a"]["fit_launches"][k.name] if mixtral17 else 0,
            flash_mixtral.get("bfloat16", {}).get(k.name))
        entry["mixtral"] = {key: val for key, val in moe.items()
                            if key not in ("name", "route", "source",
                                           "replaces")}
        # phase 19a's fit of bench_1b built as one PIPELINE composite,
        # whose attention shape is phase 2's bench_1b case
        pipe = _kernel_entry(
            k, entry["source"],
            p19["a"]["fit_launches"][k.name] if p19 else 0,
            flash.get("bfloat16", {}).get(k.name))
        entry["pipeline_1b"] = {key: val for key, val in pipe.items()
                                if key not in ("name", "route", "source",
                                               "replaces")}
        # phase 22a's searched bench_1b: launches in its measurement,
        # playoff and fit together, timed at bench_1b's attention shape
        srch = _kernel_entry(
            k, entry["source"],
            sum(n[k.name] for n in p22["a"]["launches"].values() if n)
            if p22 else 0, flash.get("bfloat16", {}).get(k.name))
        entry["search_1b"] = {key: val for key, val in srch.items()
                              if key not in ("name", "route", "source",
                                             "replaces")}
        if k is FLASH_ATTENTION_FWD:
            # phase 21c's bf16 predict of the HF-imported Llama-3-8B
            # widths, timed at its attention shape in phase 21
            hfl = _kernel_entry(
                k, entry["source"],
                p21["c"]["launches"][k.name] if p21 else 0,
                p21["k1"]["bfloat16"][k.name] if p21 else None)
            entry["llama3_8b_hf"] = {key: val for key, val in hfl.items()
                                     if key not in ("name", "route",
                                                    "source", "replaces")}
        entries.append(entry)
    # K4 on phase 11's bf16 fit (D 64), timed at its attention shape
    # (phase 2); under "phi3_mini" on phase 12's (D 96, the padded wgmma
    # bodies), timed at its shape; under "openllama_3b" on phase 13's (D
    # 100, the cp.async-loaded bodies), timed at its shape; and its fp32
    # bodies on phase 8's: GPT-2 XL's fit, timed at its attention shape
    # (phase 2), under "fp32"; and on phase 21a's fit of the HF-imported
    # GPT-2 124M (fp32 bodies too), timed at its shape, under "gpt2_124m"
    for k, src in ((FLASH_ATTENTION_BH_FWD, "flash_attention_bh_fwd.cu"),
                   (FLASH_ATTENTION_BH_DQ, "flash_attention_bh_bwd.cu"),
                   (FLASH_ATTENTION_BH_DKV, "flash_attention_bh_bwd.cu")):
        entry = _kernel_entry(
            k, f"flexflow_tpu_torch/csrc/{src}",
            train_200m["fit_launches"][k.name] if train_200m else 0,
            k4.get("timed", {}).get("llama_200m_causal", {}).get(k.name))
        for key, launches, res in (
                ("phi3_mini",
                 train_phi3["fit_launches"][k.name] if train_phi3 else 0,
                 k4.get("timed", {}).get("phi3_mini_causal", {}).get(
                     k.name)),
                ("openllama_3b",
                 train_ollama["fit_launches"][k.name] if train_ollama
                 else 0,
                 k4.get("timed", {}).get("openllama_3b_causal", {}).get(
                     k.name)),
                ("fp32", gpt2["fit_launches"][k.name] if gpt2 else 0,
                 k4.get("main", {}).get("float32", {}).get(k.name)),
                ("gpt2_124m", p21["a"]["launches"][k.name] if p21 else 0,
                 p21["k4"][k.name] if p21 else None),
                # phase 22b's ring candidate's backward in the playoff and
                # the winner's fit, timed at phase 10's ring block
                ("search_ring",
                 sum(n[k.name] for n in p22["b"]["launches"].values() if n)
                 if p22 else 0,
                 k4.get("timed", {}).get(
                     "d128_ring_block_causal_bfloat16", {}).get(k.name))) \
                + _zoo_k4_entries(k, zoo18) + _batch_serve_k4_entry(k, p19):
            other = _kernel_entry(k, entry["source"], launches, res)
            entry[key] = {name: val for name, val in other.items()
                          if name not in ("name", "route", "source",
                                          "replaces")}
        entries.append(entry)
    # K5 on phase 10's fit (bench_1b's ring, D 128), timed at its block;
    # under "phi3_mini" and "openllama_3b" on phase 14's fits (D 96 and
    # 100), timed at their blocks (full)
    carry = FLASH_ATTENTION_BH_FWD_CARRY
    entry = _kernel_entry(
        carry, "flexflow_tpu_torch/csrc/flash_attention_bh_fwd.cu",
        ring["fit_launches"][carry.name] if ring else 0,
        k5.get("main", {}).get("bfloat16_full"))
    # K5 on phase 22b's playoff and fit (the searched ring candidate of
    # bench_1b), timed at phase 10's block
    other = _kernel_entry(
        carry, entry["source"],
        sum(n[carry.name] for n in p22["b"]["launches"].values() if n)
        if p22 else 0, k5.get("main", {}).get("bfloat16_full"))
    entry["search_ring"] = {name: val for name, val in other.items()
                            if name not in ("name", "route", "source",
                                            "replaces")}
    for key, (block, _, _) in zip(("phi3_mini", "openllama_3b"),
                                  K5_RING_BLOCKS):
        other = _kernel_entry(
            carry, entry["source"],
            ring_wide[key]["fit_launches"][carry.name] if ring_wide else 0,
            k5.get("timed", {}).get(f"{block}_full"))
        entry[key] = {name: val for name, val in other.items()
                      if name not in ("name", "route", "source", "replaces")}
    entries.append(entry)
    log(f"total {json.dumps({'seconds': time.monotonic() - t_start})}")
    print(card, flush=True)
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
