#!/usr/bin/env python3
"""Smoke run of the PyTorch port (long_context_attention_tpu_torch) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON line each; any failure exits non-zero:
  1. device: the card, its power limit, torch and CUDA versions;
  2. build: nvcc builds every kernel under long_context_attention_tpu_torch/
     csrc/ (one process per source, in parallel) into build/kernels/;
  3. kernels: each kernel against its plain PyTorch version at its path's
     shapes (B7 through decode_attention, the wrapper the decode step calls,
     against the same call on CPU copies of the layer; B4, B3 and B7 also
     with the sliding window, sinks and softcap, and a band check: every
     kv tile outside a kernel's walk, at that kernel's tile width, poisoned
     with NaN must leave its output finite and bit-equal; B1 and B3 also
     where lengths, q_start and the window and sink edges cut their
     128-wide tiles, B1 at the trainer's b=1, s=8192, B3 over a bf16 kv
     at the offsets call's shape and B4 at the windowed one-shot prefill's
     b=4, s=8192, each timed; the backward kernels B2a, B2b
     and B5 at the trainer's per-layer attention shape, causal, with
     offsets that leave rows dead, and ragged (B2b and B5 also timed at
     s=32768), and with the masks (B5: window 4096 and 4 sinks, a
     non-causal two-sided window, softcap 50; B2a and B2b: the windowed
     offsets call, and window, sinks and softcap with dead rows), each
     with band checks on both sides (kv tiles no row of a block sees,
     and q tiles that see none of the last kv columns, poisoned with NaN)
     and timed; sage's quantization kernels bit for bit against their plain
     versions (a 4 x 8192 prefill, ragged, the q-only step of the
     pre-quantized entry); the sage kernels B8a, B8c and B8b on the
     int8 operands of a 4 x 8192 prefill, with window and sinks, one-chunk
     offsets, s_q != s_kv, dead rows, ragged, and B8b's band check, timed
     beside B1 and B4 at the same shape and the whole sage_attention call
     split into its quantization and its kernel; their pv_int8 forms (the
     int8 PV product over groups of T kv columns) at that shape (T =
     1024), B8a also at bench_sage.py's 32/8 heads, ragged (T = 1000), at
     T = 64 and at T = 768 (BlockSizes(768, 768), through B8c), B8b with
     window and sinks, offsets, s_q != s_kv, dead rows and its band check,
     and the pre-quantized entry; the
     block-sparse kernels B9a, B9b and B9c at b=1, s=32768 in tiles of 512
     on the StreamingLLM, strided and per-head masks, a mask whose last
     quarter of rows has no live tile, one with an empty kv column, and a
     non-causal 8192 x 32768 random mask, and at s=6144 in tiles of 192;
     B9a on the wgmma/TMA forward pipeline, B9b on the dq pipeline, B9c on
     B2b's backward pipeline; and B3, B2a, B2b and B8b at the dense ring's
     multi-chunk and strided descriptors, those of a W=4 ring at a local
     length of 8192 from the ring's own ring_step_kwargs: zigzag rank 1
     step 2, stripe with src > rank (dead rows), the bidirectional basic
     ring, zigzag with window 4096 and 4 sinks; at the first of them B3
     over int8 K/V, with softcap and in the online form, B2a and B2b with
     softcap), each
     output row held against its own size (ROW_REL_TOL), with its time,
     the plain version's, a PyTorch library call's (timed here only) and
     the least time the card could take;
  4. slice, then slice_windowed: the 0.88B llama config at full width and
     depth, random weights from a seed, served by Engine(cache_dtype="int8",
     weight_dtype="int8"): prefill_chunked of 4 x 8192 tokens in chunks of
     2048, then decode_scan of 32 greedy tokens; then one generate at b=2
     over a 1024-token prompt with a bf16 cache. The windowed run serves the
     same model with a 4096-token sliding window and 4 attention sinks
     (kernels B4, B3, B6, B7; B1 never). Each run starts from zeroed launch
     counters and checks that every kernel of its path launched as often
     as the path implies; logits must be finite and the first decode step
     must agree with a prefill of prompt + that token (teacher forcing);
     then slice_fp8 and slice_int4: the dense slice over an fp8 and an int4
     cache (B3 over the quantized prefix, B6 writing fp8 or packed int4
     rows, B7 on fp8's cast path and int4's s8 path), exact launch counts,
     finite logits, teacher forcing (fp8 held to the int8 gate, int4's
     error reported), prefill s, decode ms/step and the cache's bytes
     against the int8 slice's;
  5. slice_sage: the same model with attn_impl="sage", Engine.prefill of
     4 x 8192 in one shot against attn_impl="pallas" on the same weights,
     dense (B8a) and windowed (B8b), timed in turns, with exact launch
     counts and the logit gap; then decode_scan of 32 steps from the sage
     prefill (B6, B7), teacher forcing, and a generate at b=2;
  6. train, train_sage, then train_windowed: the same config trained by
     make_train_step (AdamW lr 1e-4, weight decay 1e-4, as the JAX
     benchmark's optax.adamw(1e-4)) at b=1, s=8192 under remat none, full
     and attn (sage: none and attn; windowed, the slice_windowed model:
     none and attn), with exact launch counts per step (B1, B8a or B4, and
     B5; B2a, B2b and B3 never) and a falling loss, and one profiled step
     each;
  7. grad_check: the config at 2 layers, s=1024: loss and every parameter
     gradient on the card under remat none, attn and full (sage: none and
     attn; and the model with window 256, 4 sinks and softcap 50) against
     the same backward on CPU copies (plain versions), each leaf within
     GRAD_TOL of its largest value;
  8. offsets: the JAX trainer's per-layer call, flash_attention with
     q_offsets=[0], kv_offsets=[0] (B3 + B2a + B2b), against the
     no-offsets path (B1 + B5) on the same inputs, row by row; and the
     same with window 4096 and 4 sinks (B3 + B2a + B2b against B4 + B5);
  9. sage_api: the public sage calls at b=1, s=8192: non-causal (B8c),
     one-chunk offsets (B8b) against none (B8a), and the pre-quantized
     entry (B8b); then sage_api_pv_int8: sage_attention at b=4, s=8192
     with pv_int8=False and True, causal (B8a), non-causal (B8c) and
     windowed (B8b), each with exact launch counts and its gap to
     flash_attention's output, timed in turns with it; and the registry's
     full with pv_int8=True through one backward (B8a's pv_int8 entry,
     B5);
 10. usp_sparse: LongContextAttention(block_mask=...) on a one-rank NCCL
     mesh from make_usp_mesh() at b=1, s=32768, forward and backward on
     each of the three causal masks (exactly one B9a, B9b and B9c per call,
     no other kernel), against a direct block_sparse_attention call, and
     timed against the dense flash_attention(causal=True);
 11. ring_emulated: a W=4 ring on one card at s=32768 (NCCL puts no two
     ranks on one card): every (rank, step) call of ring_attention_local
     for the basic, zigzag, stripe and bidirectional rings (B3, B2a, B2b
     at the ring's own descriptors), merged and summed onto their owners
     as the ring does, against one-device flash_attention fwd+bwd; and
     zigzag with impl sage and kv_quant="int8" (B8b over the rotated int8
     K/V) against one-device sage_attention; zigzag with kv_quant fp8 and
     int4 (B3 over the held quantized bytes at every (rank, step)) against
     one-device flash_attention over the dequantized K/V; and zigzag and
     stripe rings over packed documents with ALiBi and dropout against
     one-device flash_attention with the global ids, slopes and seed;
 12. usp_dense: the dense LongContextAttention(layout="zigzag") on a
     one-rank NCCL mesh at s=32768 (the two-chunk descriptor (0, s/2)):
     exactly one B3, B2a and B2b per forward and backward, against
     flash_attention(causal=True), timed beside its kernels; then
     usp_varlen: the same layer on packed documents with ALiBi and
     dropout 0.1 (exactly one featured B3, B2a and B2b), against a direct
     flash_attention with the same ids, slopes and dropout key, and q-row
     and kv-column slices of its out, lse and grads against the plain
     versions at the layer's own descriptor, timed beside the layer
     without the features and beside its kernels;
 13. train_usp: make_train_step(mesh=make_usp_mesh()) on the 0.88B config
     (zigzag) at b=1, s=8192: one step against the single-device step from
     the same params and batch (loss, every leaf), then remat none and attn
     with exact launch counts (B3, B2a, B2b; B1 and B5 never) and a
     falling loss, timed beside the single-device step;
 14. serve_continuous and serve_paged: benchmarks/bench_paged.py's 48
     requests (prompts of 1024 or 2048 tokens, 64 new each) through
     ContinuousEngine at 8 rows and PagedContinuousEngine at 32 rows over
     a pool of 65 pages of 2048, int8 cache and weights, step_block 8,
     host_overlap: exact launch counts (16 B6 and 16 B7 per decode step,
     over the page table on the paged engine; 16 B1 and one B6, the
     row's insert of every layer, per admission), tok/s
     of an unprofiled run, and one decode block each profiled in an
     untimed warm-up with every row busy; the paged engine at 8 rows on the
     first 16 requests gives the dense engine's tokens, and its logprobs
     pass teacher forcing; then serve_paged_fp8: the paged run over an fp8
     pool beside the int8 one, and the paged engine at 8 rows on the first
     8 requests with interleaved admission in chunks of 256 (the
     multi-token cast path of B7, decode_run, through the page table),
     exact launch counts (every chunk's sub-runs on decode_run, every
     decode step on decode_attention) and teacher forcing on its logprobs;
 15. serve_prefix: benchmarks/bench_prefix.py's 8 requests (a shared
     16384-token system prompt + 64 tokens, 16 new) at 4 rows, plain
     against prefix_cache=True: 7 x 16384 prefix-hit tokens, the suffix
     chunks' multi-token B7 launches (decode_run) as the tile rule splits
     them, first-token logits against the plain engine's;
 16. serve_stall: a 32768-token prompt admitted while a row decodes
     (bench_paged.py's stall at ctx 32768), batch admission against
     interleave_admission: the running row's largest inter-token gap,
     exact launch counts (the interleaved chunks' sub-runs on decode_run),
     and each run teacher-forced on its own tokens (every step's logits
     within 0.5 of a bf16 prefill);
 17. serve_mesh: Engine(mesh=make_usp_mesh(), cache_dtype="int8",
     weight_dtype="int8") on a one-rank NCCL mesh, the 0.88B config in the
     zigzag layout: a one-shot 4 x 8192 prefill (the ring's B3, one a
     layer; B6 writing the gathered K/V) and 32 greedy decode steps,
     against Engine() without a mesh (B1): logits and the cache's prompt
     rows within TEACHER_TOL, the greedy tokens' first divergence, exact
     launch counts, both prefills timed;
 18. usp_async: AsyncLongContextAttention (default groups and n_groups=2)
     against LongContextAttention at s=32768, forward and backward, out
     and grads bit for bit, the ring's lse per group, exact counts (one
     B3, B2a, B2b a group), both timed in turns;
 19. dit_forward: the DiT at Wan2.1-T2V-1.3B's widths, 30 layers, 32760
     tokens (an 81-frame 480p clip), random non-zero weights: under
     "pallas" (30 non-causal B3) and "sage" (30 B8b), timed, sage's gap to
     pallas; its 2-layer cut at 7800 tokens against the CPU path;
 20. dit_train: make_dit_train_step at those widths over 7800 tokens (17
     frames), AdamW, a warm-up and 3 timed steps with exact counts (B3,
     B2a, B2b) and a falling loss, peak memory; a 2-layer gradient check
     with non-zero mod and out against the CPU;
 21. serve_windowed_paged: the slice_windowed model through
     PagedContinuousEngine with rolling window pages (int8 cache and
     weights, pages of 2048, 8 rows, step_block 8) on 12 requests of 64
     new tokens, prompts of 10225-10231 and 8186-8191 tokens, over a pool
     of 8 rows' rolling pages + 1: tokens equal to the same engine's with
     whole-span reservations, at most _rolling_pages() pages a row, the
     same tokens when every page is poisoned (127, scales 1e4) the moment
     it is released, a page reclaimed by every row and grown by every 10K
     row, exact launch counts (B4 and B6 per admission, B6 and one-token
     B7 per step over page tables that change mid-serve), the native
     allocator; then the same requests admitted interleaved in chunks of
     2048 (B7's windowed runs on decode_run), teacher-forced on their own
     tokens, their first parting from the batch run reported;
 22. serve_speculative: the 0.88B target (int8 cache and weights, gamma 4)
     with a draft at a quarter of its width and depth (dim 1024, 4 layers,
     8/4 heads of 128): PagedSpeculativeContinuousEngine on bench_paged's
     first 16 requests (32 new tokens), SpeculativeContinuousEngine on 8 of
     them (the same tokens), a self-draft on 8 (acceptance at least 0.75),
     SpeculativeEngine.generate at b=2 and a sampled paged run on 4; every
     greedy token target-greedy under a bf16 teacher within TEACHER_TOL,
     exact launch counts per round (gamma + 1 draft steps of B6 and
     one-token B7, the verify's B6 and B7 run on decode_run), rounds,
     drafted and accepted tokens, tok/s and acceptance per run;
 23. sharded_emulated and serve_sharded: B7 with each rank's columns
     emulated on one card, then the sharded engines on a one-rank NCCL
     mesh against their meshless counterparts;
 24. moe_serve: the 0.88B config with 8 experts a layer (top-1 routing at
     capacity 2.0, parallel/moe.py), bf16 weights, int8 cache:
     prefill_chunked of 4 x 8192 in chunks of 2048 and 32 greedy decode
     steps, generate at b=2 (bf16 cache), ContinuousEngine on 8 requests;
     exact B1 / B3 / B6 / B7 counts, each layer's dropped-token share and
     the tokens' teacher gaps; then generate and the requests at full
     capacity, every greedy token within TEACHER_TOL of its bf16
     teacher's largest logit (forward_local over prompt and tokens); and
     weight_dtype="int8" raising;
 25. moe_train: that model through make_train_step at b=1, s=8192, AdamW:
     one step on a one-rank NCCL mesh against the meshless step
     (USP_LOSS_TOL, USP_LEAF_TOL), then 3 timed meshless steps with exact
     B1 / B5 counts, a falling loss, each layer's dropped-token share and
     the peak memory, and one step profiled;
 26. zero_train: make_zero_train_step and make_zero3_train_step (remat
     full) on a one-rank NCCL mesh at the dense 0.88B config, one step
     each against make_train_step's (the same gates), then timed steps
     with exact B3 / B2a / B2b counts;
 27. slice_hd64: a Llama of head dim 64 at TinyLlama-1.1B's widths
     (TINYLLAMA: 22 layers, dim 2048, 32 / 4 heads of 64, ffn 5632;
     random weights) served as the slice serves the 0.88B config
     (serve_phase), on the d = 64 kernels (ops/_build.py: each of the
     serving path's sources built a second time with -DLCA_HEAD_DIM=64):
     exact counts of B1, B3, B6 and one-token B7 at d = 64 and none at d
     = 128, teacher forcing, a bf16-cache generate; then a two-chunk
     prefill and 4 decode steps over fp8 and int4 caches;
 28. serve_paged_hd64: that model through PagedContinuousEngine with
     interleaved admission over int8, fp8 and int4 pages: every chunk
     sub-run on decode_run at d = 64 (the tile rule's plan, exact counts),
     logprobs against teacher forcing;
 29. train_hd64: that model trained as train trains the 0.88B config
     (b=1, s=8192, AdamW; remat none and attn): exact counts of B1 and B5
     at d = 64 and no other kernel, a falling loss, ms/step, tok/s, 6ND
     MFU, peak memory, one step profiled;
 30. grad_check_hd64: its loss and every gradient at 2 layers, s=1024,
     under remat none, attn and full, against the CPU's plain backward;
 31. train_usp_hd64: train_usp at that model (zigzag, a one-rank NCCL
     mesh): one mesh step against the single-device step (loss, leaves,
     updates), then timed steps with exact counts of B3, B2a and B2b at
     d = 64 and no other kernel;
 32. usp_varlen_hd64: usp_varlen at its attention width (32 / 4 heads of
     64, s = 32768): one B3, B2a and B2b at d = 64 a forward and backward.
The kernel phase's kernel_hd64 holds the d = 64 kernels at TinyLlama's
shapes against their plain versions at their rows' tolerances, each
timed: B1 (fast and online, ragged), B3 over bf16, int8, fp8 and int4
(fast, window 4096 and 4 sinks with its band check, online and softcap),
B6 in every kind, dense and paged, at 1, 256 and 2048 tokens bit for bit,
one-token B7 at G = 8 in every kind dense and paged (cast path, window
and sinks), and B7's runs of 256 (three sub-runs) in every kind with the
poison check; and (kernel_hd64_train) at b=1, s=8192: B5 causal, B3, B2a
and B2b at a one-rank zigzag ring's two chunks, B5 / B2a / B2b with the
masks and their band checks, B3 / B2a / B2b at the W = 4 ring's
descriptors and with segments, ALiBi and dropout; the d = 64 kernels get
rows of their own in the kernel table, their cases' launches from the
phases above.
Every paged phase asserts that the engine took the native allocator
(csrc/lca_host.cc, built with g++ into build/host/).
The kernel phase holds B6's quantizing entry (cache_append_rows: bf16
rows quantized and written in one launch, b6_rows_case) for every cache
kind, dense and paged, at runs of 1, 256 and 2048 tokens, bit for bit
against its plain version on CPU copies, with the card-side torch
quantizer's misses (a Python divisor's against quantize_kv's, which must
be 0), device ms under torch.profiler, the call's and the wrapper's host
ms, and an empty kernel's device ms as the launch floor; the public
cache_append's byte-copy kind as before. It also holds B6's byte copy
and one-token B7 (decode_attention.cu's span kernel) through the page
table against their plain versions, and paged against dense bit for bit;
one-token B7 is held to B7_ROW_TOL and B7_LSE_TOL and timed as device ms
per launch under torch.profiler over its cache's layers in turn
(kernel_timing), beside the call's CUDA-event ms and the wrapper's host
ms, at the slice's shape, with window and sinks, a run of 4 tokens (G =
8) and a 192-column tile (kernel_b7_shapes); B7's runs on decode_run
(kernel_b7_runs: csrc/decode_run_sm90.cu, every sub-run of the JAX
rule's split on it by its launch counter) over a paged pool at RUN_LENS:
int8 runs of 256 and 64, timed, paged against dense bit for bit and a
poison check (the pages no table names and the columns past each row's
length set to 127 with NaN scales leave the bits unchanged); the run of
256 in the online form, with window 4096 and 4 sinks, with softcap 50,
with ALiBi and on the cast path; the route's edges (G = 10, 64, 66, 130
rows per kv head); a row whose length is its run; kv_splits=4 on the
dense cache; runs of 256 over bf16, fp8, int4 (s8 and cast) pools,
timed, bf16 and fp8 poison-checked; and B3, B2a and B2b with packed
segments, ALiBi, dropout 0.1 and all three at the trainer's per-layer
shape, at one chunk and at the ring's zigzag and stripe steps (LSE_FLOOR
says which rows a per-step check holds), B3 over int8 K/V with segments
and dropout and with kv_lengths on the chunked-prefill cache call, each
timed with its bound and SDPA's yardstick, and exact probes of the
dropout keep mask in all three; and the fp8 and int4 caches
(kernel_quant_cache): B6's byte copy appending fp8 and packed int4 rows,
dense and paged, bit for bit; B7 at the slice's decode shape on fp8's
cast path, int8's and int4's cast path (mxu_int8=False), int4's s8 path,
int8 with ALiBi and with kv_splits=4, and paged fp8 over one token; B3
over fp8 and int4 K/V at the chunk shape, dense and with window 4096 and
4 sinks (with its band check), and in the online and softcap forms; each
against its plain version with its bound and SDPA over the dequantized
cache; and kernel_dit: B3 and B8b non-causal at the DiT forward's s_q =
s_kv = 32760 (12 heads of 128; row blocks, the ragged last tile included,
the storage past s_kv poisoned, B3's scores all negative so that an
unmasked zero-filled column would show) and at 130 (126 of the last tile's
columns past s_kv), B2a and B2b non-causal at training's 7800.
Then the kernel table, the card's name and power limit, and as the last line
{"ok": true, "device": {...}}.
"""

import contextlib
import ctypes
import dataclasses
import functools
import json
import math
import re
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor-core rate
PEAK_INT8_OPS = 1979e12    # H100 SXM dense int8 tensor-core rate
PEAK_BYTES = 3.35e12       # H100 SXM HBM3 rate
PEAK_FP32_FLOPS = 67e12    # H100 SXM fp32 rate outside the tensor cores
# sage's operations are half int8 (QK) and half bf16 (PV): their joint rate
PEAK_SAGE_OPS = 2 / (1 / PEAK_INT8_OPS + 1 / PEAK_BF16_FLOPS)
SEED = 0

# The 0.88B llama config that bench.py serves (full width and depth).
MODEL = dict(vocab=32000, dim=2048, n_layers=16, n_heads=16, n_kv_heads=8,
             head_dim=128, ffn_hidden=int(2048 * 2.7), layout="basic")
# A Llama of head dim 64 at TinyLlama-1.1B's published widths
# (TinyLlama/TinyLlama-1.1B-intermediate-step-1431k-3T, config.json: vocab
# 32000, hidden 2048, 22 layers, 32 heads and 4 kv heads of 64, ffn 5632,
# rope_theta 10000, rms eps 1e-5, an untied lm_head), random weights from
# SEED; served at the slice's shapes (slice_hd64, serve_paged_hd64)
TINYLLAMA = dict(vocab=32000, dim=2048, n_layers=22, n_heads=32,
                 n_kv_heads=4, head_dim=64, ffn_hidden=5632,
                 rope_theta=10000.0, norm_eps=1e-5, layout="basic")
BATCH, PROMPT, CHUNK, NEW = 4, 8192, 2048, 32
S_MAX = ((PROMPT + NEW + 4095) // 4096) * 4096
GEN_BATCH, GEN_PROMPT, GEN_NEW = 2, 1024, 16
# The windowed serving config, the same model with the sliding_window of
# Mistral-7B-v0.1's published config.json and the four initial tokens that
# StreamingLLM keeps as attention sinks (arXiv:2309.17453). Softcap 50 is
# Gemma-2's attn_logit_softcapping; no public model pairs it with this
# window and these sinks, so only the kernel phase holds it.
WINDOW, SINKS, SOFTCAP = 4096, 4, 50.0
WINDOWED = dict(window_left=WINDOW, sink_tokens=SINKS)
# The kv-tile width of each kernel's walk, which its band check poisons: a
# NaN inside a visited tile is not masked out of the PV product.
B4_KV_TILE = 128   # csrc/flash_fwd_sm90.cu BKV (B4)
B3_KV_TILE = 128   # csrc/flash_fwd_sm90.cu BKV (B1, B3)
B8_KV_TILE = 128   # csrc/sage_fwd_sm90.cu BKV (B8a, B8b)

# Kernel vs plain version (same inputs). Each output row -- one query row
# of one head, its d features -- is held against its own size: the row's
# max |kernel - plain| over its max |plain| must stay within ROW_REL_TOL
# (a dead row must be exactly 0). Typical |out| is about 0.05 for B1's
# random bf16 inputs and 0.01 for B3's and B7's int8 caches (each case
# prints its own); holding each row against itself keeps the limit tight
# for the small late rows as for the large early ones. Both sides round the
# same fp32 arithmetic to a bf16 output, summed in another order, so an
# element may land on the neighbouring bf16 value: one ulp, at most 2^-7 of
# the row's max. B7's int8 path also requantizes P per tile, where a
# last-bit difference can move one column by one level. On the H100 the
# worst row of every case came to 2^-7 or less; the limit is 4x that, so a
# fault of a few percent in any row fails.
ROW_REL_TOL = 2.0 ** -5
# lse is fp32 from fp32 sums on both sides
LSE_TOL = 1e-3
# One-token B7 (decode_attention.cu) is held tighter: each output row within
# 2^-7 of its size (one bf16 ulp of the row's largest value: both sides
# round the same fp32 values, summed in another order, to bf16) and lse
# within 1e-4 (fp32 sums of ~8K columns)
B7_ROW_TOL = 2.0 ** -7
B7_LSE_TOL = 1e-4
# One-token B7 is timed over every layer of its cache in turn, as a decode
# step calls it, so that no call finds its bytes in the 50 MB L2 (the
# windowed and paged-window cases read 22-35 MB a layer), B7_ROUNDS times
B7_ROUNDS = 4
# ... and its paged cases over a pool of this many layers (the paged
# window case reads ~22 MB a layer)
B7_PAGED_LAYERS = 4
# Teacher forcing, int8 weights and int8 cache in decode against the bf16
# prefill of prompt + token: the JAX suite's int8-cache gate
# (tests/test_serving.py:47).
TEACHER_TOL = 0.5
# The backward kernels are held to ROW_REL_TOL too: each row of dq, dk and
# dv against its own size. Kernel and plain version compute the same fp32
# products from the same bf16 casts of p and ds, summed in another order;
# B5 adds each tile's dq by a TMA reduce-add, in an order that changes from
# run to run, so its dq is not bit-stable, and the row limit covers that as
# well.
CANCEL_FLOOR = 2.0 ** -10

# Training: the trainer's shapes (benchmarks/bench_train.py:45-49: b=1,
# s=8192, optax.adamw(1e-4), whose weight decay is 1e-4).
TRAIN_SEQ = 8192
TRAIN_STEPS = (("none", 3), ("full", 2), ("attn", 2))
SAGE_TRAIN_STEPS = (("none", 3), ("attn", 2))
# the windowed model (WINDOWED): B4 forward, B5 over the band and the sinks
WINDOWED_TRAIN_STEPS = (("none", 3), ("attn", 2))
# the self-attention forward kernel of the model's layer, by attn_impl
FORWARD_KERNEL = {"pallas": "flash_fwd_causal_self", "sage": "sage_fwd_tri"}
# sage's quantization pass: one K/V and one q launch per sage call
SAGE_QUANT = ("sage_quant_kv", "sage_quant_q")
LR, WEIGHT_DECAY = 1e-4, 1e-4
# Gradient check: the card's loss and each parameter gradient against the
# same backward on CPU copies (the plain versions), max |card - cpu| over
# max |cpu| per leaf. Both sides round the same bf16 model at other places
# (cuBLAS and the CPU's GEMMs, the kernels' summation order); the grads are
# bf16, one ulp 2^-8 of a value. On the H100 the worst leaf came to 0.011
# (1-1.4 ulps of its largest value) and the loss (about 10.9) to 4.4e-5
# apart; the limits are ~3x and ~20x that, so a fault of a few percent in
# any leaf fails.
GRAD_LAYERS, GRAD_SEQ = 2, 1024
GRAD_TOL = 0.03
LOSS_TOL = 1e-3
# The windowed gradient check's model: a window of 256 (WINDOW would drop
# nothing at GRAD_SEQ), 4 sinks and Gemma-2's softcap, so B4 and B5 drop
# columns, keep the sinks and cap scores in every layer.
GRAD_WINDOWED = dict(window_left=256, sink_tokens=SINKS, softcap=SOFTCAP)

# Block-sparse USP: the model's attention width at s = 32768 in tiles of
# 512 (the API's default block), the masks users run
# (benchmarks/bench_sparse.py:66-69, :189-196): StreamingLLM's sink tile
# plus an 8-tile (4096-token) window, every 8th tile plus a 4-tile band,
# and a window of 4 + 2 * (i % 5) tiles per head
SPARSE_SEQ, SPARSE_BLOCK = 32768, 512
SPARSE_TILES = SPARSE_SEQ // SPARSE_BLOCK
SPARSE_KERNELS = ("sparse_fwd", "sparse_bwd_dq", "sparse_bwd_dkv")


def emit(obj):
    print(json.dumps(obj), flush=True)


def ptxas_entries(log):
    """{kernel entry: registers, spill stores and loads (bytes)} from one
    source's `ptxas -v` output."""
    entries, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            entries.setdefault(name, {})
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
            entries.setdefault(name, {})
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name in entries:
            entries[name].update(spill_stores=int(m.group(1)),
                                 spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name in entries:
            entries[name]["registers"] = int(m.group(1))
    return entries


def smi_line():
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return res.stdout.strip().splitlines()[0]


def time_ms(fn, iters=10, warmup=2):
    """Mean device time of fn over `iters` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def bound(flops, nbytes, peak=PEAK_BF16_FLOPS):
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    if t_ops >= t_bytes:
        return t_ops * 1e3, "operations"
    return t_bytes * 1e3, "bytes"


def max_err(a, b):
    a, b = a.float(), b.float()
    both_inf = torch.isinf(a) & torch.isinf(b) & (a == b)
    d = torch.where(both_inf, torch.zeros_like(a), (a - b).abs())
    return float(d.max())


def check(name, err, tol):
    if not err <= tol:
        raise AssertionError(f"{name}: max abs error {err} > {tol}")


def check_out(name, got, want, cancel_rows=None, tol=ROW_REL_TOL):
    """Hold an output (..., d) row by row against its size (``tol``,
    ROW_REL_TOL by default); print the case's numbers and return (max abs
    error, worst row).

    ``cancel_rows`` (an index into dim 1) names rows whose exact value is 0
    by cancellation: a query row that sees a single column has p = 1, so
    ds = dp - delta is fp32 rounding noise on both sides. Such a row is
    held against CANCEL_FLOOR of the output's largest value instead of its
    own (noise) size."""
    got, want = got.float(), want.float()
    diff = (got - want).abs().amax(-1)
    size = want.abs().amax(-1)
    if cancel_rows is not None:
        floor = CANCEL_FLOOR * float(want.abs().max())
        size[:, cancel_rows] = size[:, cancel_rows].clamp_min(floor)
    rel = torch.where(size > 0, diff / size.clamp_min(1e-30),
                      torch.where(diff > 0, math.inf, 0.0))
    worst = float(rel.max())
    err = max_err(got, want)
    emit({"phase": "check", "case": name, "max_abs_err": err,
          "out_mean_abs": float(want.abs().mean()), "row_rel_err": worst,
          "row_rel_tol": tol})
    if not worst <= tol:
        raise AssertionError(f"{name}: a row differs from the plain version "
                             f"by {worst} of its size, limit {tol}")
    return err, worst


def case_row(checks, ms, plain_ms, flops, nbytes, library_ms,
             peak=PEAK_BF16_FLOPS):
    """A kernel's numbers at one shape: errors, times, its bound."""
    b_ms, b_by = bound(flops, nbytes, peak)
    return {"launches": None, "max_abs_err": max(e for e, _ in checks),
            "row_rel_err": max(r for _, r in checks), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": library_ms}


def row(kernel, checks, ms, plain_ms, flops, nbytes, library_ms,
        peak=PEAK_BF16_FLOPS):
    """A kernel's line of the table; its source from the registry."""
    return {"name": kernel.name, "route": "cuda",
            "source": f"long_context_attention_tpu_torch/csrc/{kernel.source}",
            "replaces": kernel.replaces,
            **case_row(checks, ms, plain_ms, flops, nbytes, library_ms, peak)}


def quant_counts(n):
    """Expected launches of sage's quantization kernels on a path with n
    sage calls (each one K/V and one q launch)."""
    return dict.fromkeys(SAGE_QUANT, n)


def visible(s_q, s_kv, q_start=0, causal=True, left=-1, right=-1, sink=0,
            dev="cpu"):
    """(s_q, s_kv) bool: True where the q row at position q_start + i sees
    kv column j (flash-attn masks: causal sets right to 0; columns below
    sink stay visible through the left window)."""
    rows = q_start + torch.arange(s_q, device=dev)[:, None]
    cols = torch.arange(s_kv, device=dev)[None, :]
    vis = torch.ones((s_q, s_kv), dtype=torch.bool, device=dev)
    if causal:
        right = 0
    if right >= 0:
        vis &= cols <= rows + right
    if left >= 0:
        vis &= (cols >= rows - left) | (cols < sink)
    return vis


def live_pairs(s_q, s_kv, q_start, causal, **window):
    """(q row, kv column) pairs the masks keep: the work of one head."""
    return int(visible(s_q, s_kv, q_start, causal, **window).sum())


def unseen_tiles(vis, tile):
    """kv tiles of `tile` columns that no row of `vis` sees."""
    seen = torch.zeros(-(-vis.shape[1] // tile) * tile, dtype=torch.bool,
                       device=vis.device)
    seen[:vis.shape[1]] = vis.any(0)
    return (~seen.view(-1, tile).any(-1)).nonzero()[:, 0].tolist()


def poison(t, dim, tiles, tile):
    """A copy of t with the columns of `tiles` along `dim` set to NaN."""
    if not tiles:
        raise AssertionError("band check: no kv tile lies outside the walk")
    cols = torch.cat([torch.arange(i * tile, min((i + 1) * tile,
                                                 t.shape[dim]))
                      for i in tiles]).to(t.device)
    return t.index_fill(dim, cols, math.nan)


def band_check(name, got, want, n_tiles):
    """The band check: with every kv tile outside the kernel's walk (the
    sink tiles and each q tile's window band) poisoned with NaN, the output
    must be finite and bit-equal to the clean run's."""
    ok = bool(torch.isfinite(got).all()) and torch.equal(got, want)
    emit({"phase": "check", "case": f"{name} band check",
          "poisoned_tiles": n_tiles, "finite_and_equal": ok})
    if not ok:
        raise AssertionError(f"{name}: kv tiles outside the walk changed "
                             f"the output")


def rows_seeing_less(vis, tile, n=2048):
    """The last n rows (else the first n) and the kv tiles of `tile`
    columns that none of them sees: a kernel's dq of those rows must not
    read those tiles."""
    s_q = vis.shape[0]
    for rows in (slice(s_q - n, s_q), slice(0, n)):
        tiles = unseen_tiles(vis[rows], tile)
        if tiles:
            return rows, tiles
    raise AssertionError("band check: every kv tile is seen by every block")


def cols_seen_by_few(vis, tile, n=2048):
    """The last n kv columns and the q tiles of `tile` rows that see none
    of them: a kernel's dk and dv of those columns must not read those
    tiles."""
    cols = slice(vis.shape[1] - n, vis.shape[1])
    return cols, unseen_tiles(vis[:, cols].T, tile)


# ---------------------------------------------------------------------------
# phase 3: every kernel against its plain version
# ---------------------------------------------------------------------------


def kernel_b1(K, flash, gen, dev):
    """B1 against its plain version: the chunk's shape (b=4, s=2048) in the
    fast and online forms, ragged lengths that cut a 128-row tile (64, an
    admission's smallest bucket, 1000 and 4096 + 37), and the trainer's shape (b=1, s=8192); times at the chunk's
    shape and, in "train", at the trainer's."""
    b, s, h, hk, d = BATCH, CHUNK, MODEL["n_heads"], MODEL["n_kv_heads"], 128
    scale = d ** -0.5
    checks = []

    def qkv(bb, ss):
        return [torch.randn(shape, generator=gen, device=dev).bfloat16()
                for shape in ((bb, ss, h, d), (bb, ss, hk, d),
                              (bb, ss, hk, d))]

    def case(tag, q, k, v, safe=False):
        o, l = flash.flash_fwd_causal_self(q, k, v, scale=scale,
                                           safe_softmax=safe)
        po, pl_ = flash.flash_fwd_causal_self_plain(q, k, v, scale=scale,
                                                    safe_softmax=safe)
        torch.cuda.synchronize()
        checks.append(check_out(f"B1 out {tag} safe={safe}", o, po))
        check(f"B1 lse {tag} safe={safe}", max_err(l, pl_), LSE_TOL)

    def times(q, k, v):
        bb, ss = q.shape[:2]
        ms = time_ms(lambda: flash.flash_fwd_causal_self(q, k, v,
                                                         scale=scale))
        plain_ms = time_ms(lambda: flash.flash_fwd_causal_self_plain(
            q, k, v, scale=scale), iters=3, warmup=1)
        qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
        kr, vr = (t.repeat_interleave(h // hk, dim=1) for t in (kh, vh))
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qh, kr, vr, is_causal=True))
        flops = 2 * bb * h * ss * ss * d
        nbytes = 2 * (2 * q.numel() + k.numel() + v.numel()) + 4 * bb * h * ss
        return ms, plain_ms, flops, nbytes, lib_ms

    q, k, v = qkv(b, s)
    for safe in (False, True):
        case(f"b={b} s={s}", q, k, v, safe)
    # ragged lengths: partial q and kv tiles at the end (64: an admission
    # prefill's smallest bucket, less than one tile)
    for sr in (64, 1000, 4096 + 37):
        qr, kr_, vr_ = qkv(1, sr)
        for safe in (False, True):
            case(f"ragged s={sr}", qr, kr_, vr_, safe)
    res = row(K["flash_fwd_causal_self"], checks,
              *times(q, k, v))
    # the trainer's forward: b=1, s=8192
    del q, k, v
    qt, kt, vt = qkv(1, TRAIN_SEQ)
    checks = []
    for safe in (False, True):
        case(f"b=1 s={TRAIN_SEQ}", qt, kt, vt, safe)
    res["train"] = {"case": f"b=1 s={TRAIN_SEQ}",
                    **case_row(checks, *times(qt, kt, vt))}
    return res


def kernel_b4(K, flash, gen, dev):
    """B4 against its plain version: the windowed path's chunk
    self-attention (b=4, s=2048, window 4096, 4 sinks) in the fast, online
    and softcap forms, the non-causal cases, and the windowed one-shot
    prefill's shape (b=4, s=8192; the plain version one batch row at a
    time) with its band check at B4's 128-wide kv tiles; times, bound and
    SDPA's bool-mask call at both shapes."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    h, hk, d = MODEL["n_heads"], MODEL["n_kv_heads"], 128
    scale = d ** -0.5
    win = dict(causal=True, window_size=(WINDOW, -1), sink_tokens=SINKS)
    checks = []

    def qkv(b, s):
        return [torch.randn(shape, generator=gen, device=dev).bfloat16()
                for shape in ((b, s, h, d), (b, s, hk, d), (b, s, hk, d))]

    def plain(q, k, v, **kw):  # one batch row at a time
        parts = [flash.flash_fwd_static_plain(q[i:i + 1], k[i:i + 1],
                                              v[i:i + 1], scale=scale, **kw)
                 for i in range(q.shape[0])]
        return tuple(torch.cat([p[j] for p in parts]) for j in range(2))

    def case(tag, q, k, v, **kw):
        o, l = flash.flash_fwd_static(q, k, v, scale=scale, **kw)
        po, pl_ = plain(q, k, v, **kw)
        torch.cuda.synchronize()
        checks.append(check_out(f"B4 out {tag}", o, po))
        check(f"B4 lse {tag}", max_err(l, pl_), LSE_TOL)
        return o

    def times(q, k, v, sdpa):
        b, s = q.shape[:2]
        ms = time_ms(lambda: flash.flash_fwd_static(q, k, v, scale=scale,
                                                    **win))
        plain_ms = time_ms(lambda: plain(q, k, v, **win), iters=1, warmup=0)
        mask = visible(s, s, 0, True, left=WINDOW, sink=SINKS, dev=dev)
        lib_ms = time_ms(lambda: sdpa(mask))
        flops = 4 * b * h * d * int(mask.sum())
        nbytes = 2 * (2 * q.numel() + k.numel() + v.numel()) + 4 * b * h * s
        return ms, plain_ms, flops, nbytes, lib_ms

    q, k, v = qkv(BATCH, CHUNK)
    for tag, kw in (
            ("window sinks", win),
            ("window sinks safe", dict(win, safe_softmax=True)),
            ("window sinks softcap", dict(win, softcap=SOFTCAP)),
            ("non-causal", dict(causal=False)),
            ("non-causal softcap", dict(causal=False, softcap=SOFTCAP)),
            ("non-causal window (512, 256) sinks",
             dict(causal=False, window_size=(512, 256), sink_tokens=SINKS))):
        case(f"{tag} b={BATCH} s={CHUNK}", q, k, v, **kw)
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    res = {**row(K["flash_fwd_static"], checks, *times(
               q, k, v, lambda m: F.scaled_dot_product_attention(
                   qh, kh, vh, attn_mask=m, enable_gqa=True))),
           "case": f"b={BATCH} s={CHUNK}, window {WINDOW}, {SINKS} sinks "
                   f"(a chunk of the windowed chunked prefill)",
           "library": "SDPA with the bool band mask"}
    del q, k, v, qh, kh, vh
    torch.cuda.empty_cache()

    # the windowed one-shot prefill's shape; its last 2048 rows never see kv
    # tiles 1..15, which the band check poisons
    checks = []
    q1, k1, v1 = qkv(BATCH, PROMPT)
    out = case(f"window sinks b={BATCH} s={PROMPT}", q1, k1, v1, **win)
    rows = slice(PROMPT - CHUNK, PROMPT)
    vis = visible(PROMPT, PROMPT, 0, True, left=WINDOW, sink=SINKS, dev=dev)
    tiles = unseen_tiles(vis[rows], B4_KV_TILE)
    kp, vp = (poison(t, 1, tiles, B4_KV_TILE) for t in (k1, v1))
    got, _ = flash.flash_fwd_static(q1, kp, vp, scale=scale, **win)
    torch.cuda.synchronize()
    band_check("B4", got[:, rows], out[:, rows], len(tiles))
    del kp, vp, got, out, vis
    torch.cuda.empty_cache()
    qh = q1.transpose(1, 2)
    kr, vr = (t.transpose(1, 2).repeat_interleave(h // hk, 1)
              for t in (k1, v1))

    def sdpa(mask):
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            return F.scaled_dot_product_attention(qh, kr, vr, attn_mask=mask)

    res["one_shot"] = {"case": f"b={BATCH} s={PROMPT}, window {WINDOW}, "
                               f"{SINKS} sinks (Engine.prefill, windowed)",
                       **case_row(checks, *times(q1, k1, v1, sdpa)),
                       "library": "SDPA memory-efficient with the bool band "
                                  "mask, K/V repeated to the query heads"}
    del q1, k1, v1, qh, kr, vr
    torch.cuda.empty_cache()
    return res


def kernel_b3(K, flash, gen, dev):
    b, h, hk, d = BATCH, MODEL["n_heads"], MODEL["n_kv_heads"], 128
    s_q, start = CHUNK, PROMPT - CHUNK
    q = torch.randn((b, s_q, h, d), generator=gen, device=dev).bfloat16()
    # a 2-layer int8 cache; the kernel reads layer 1's prefix in place
    kc = torch.randint(-127, 128, (2, b, hk, S_MAX, d), generator=gen,
                       device=dev, dtype=torch.int8)
    vc = torch.randint(-127, 128, (2, b, hk, S_MAX, d), generator=gen,
                       device=dev, dtype=torch.int8)
    ks = torch.rand((2, b, hk, 1, S_MAX), generator=gen, device=dev) / 64
    vs = torch.rand((2, b, hk, 1, S_MAX), generator=gen, device=dev) / 64
    k, v = kc[1, :, :, :start], vc[1, :, :, :start]
    ksl, vsl = ks[1, :, :, 0, :start], vs[1, :, :, 0, :start]
    scale = d ** -0.5
    checks = []
    for quant, safe in ((True, False), (True, True), (False, False)):
        args = (k, v, ksl, vsl) if quant else (
            (k.float() * ksl[..., None]).bfloat16(),
            (v.float() * vsl[..., None]).bfloat16(), None, None)
        o, l = flash.flash_fwd_pos(q, *args, q_start=start, causal=True,
                                   scale=scale, safe_softmax=safe)
        po, pl_ = flash.flash_fwd_pos_plain(q, *args, q_start=start,
                                            causal=True, scale=scale,
                                            safe_softmax=safe)
        torch.cuda.synchronize()
        checks.append(check_out(f"B3 out int8={quant} safe={safe}", o, po))
        check(f"B3 lse int8={quant} safe={safe}", max_err(l, pl_), LSE_TOL)
    # ragged: 100 rows at q_start 700 over a 777-slot prefix, so the causal
    # diagonal and the kv end cut tiles; q_start -8 gives dead rows
    for q_start in (700, -8):
        qr = q[:, :100].contiguous()
        args = (k[:, :, :777], v[:, :, :777], ksl[:, :, :777],
                vsl[:, :, :777])
        o, l = flash.flash_fwd_pos(qr, *args, q_start=q_start, causal=True,
                                   scale=scale)
        po, pl_ = flash.flash_fwd_pos_plain(qr, *args, q_start=q_start,
                                            causal=True, scale=scale)
        torch.cuda.synchronize()
        if q_start < 0:  # the first 8 rows see nothing: out 0, lse -inf
            if o[:, :8].any() or not torch.isneginf(l[:, :, :8]).all():
                raise AssertionError("B3: dead rows are not out 0, lse -inf")
        checks.append(check_out(f"B3 out ragged q_start={q_start}", o, po))
        check(f"B3 lse ragged q_start={q_start}", max_err(l, pl_), LSE_TOL)
    # lengths, q_start, the window edge and the sink edge inside 128-wide
    # tiles: 300 rows at q_start 1037 over a 1337-slot prefix, window 500,
    # 70 sinks, int8 and bf16, in every form
    sr, qr_start, kvr = 300, 1037, 1337
    qr = q[:, :sr].contiguous()
    i8 = (k[:, :, :kvr], v[:, :, :kvr], ksl[:, :, :kvr], vsl[:, :, :kvr])
    b16 = ((i8[0].float() * i8[2][..., None]).bfloat16(),
           (i8[1].float() * i8[3][..., None]).bfloat16(), None, None)
    for kv_tag, args in (("int8", i8), ("bf16", b16)):
        for f_tag, kw in (("fast", {}), ("safe", dict(safe_softmax=True)),
                          ("softcap", dict(softcap=SOFTCAP))):
            tag = f"{kv_tag} {f_tag} s_q={sr} q_start={qr_start} s_kv={kvr}"
            kw = dict(kw, q_start=qr_start, causal=True, scale=scale,
                      window_size=(500, -1), sink_tokens=70)
            o, l = flash.flash_fwd_pos(qr, *args, **kw)
            po, pl_ = flash.flash_fwd_pos_plain(qr, *args, **kw)
            torch.cuda.synchronize()
            checks.append(check_out(f"B3 out {tag} window 500 sinks 70", o,
                                    po))
            check(f"B3 lse {tag}", max_err(l, pl_), LSE_TOL)
    ms = time_ms(lambda: flash.flash_fwd_pos(
        q, k, v, ksl, vsl, q_start=start, causal=True, scale=scale))
    plain_ms = time_ms(lambda: flash.flash_fwd_pos_plain(
        q, k, v, ksl, vsl, q_start=start, causal=True, scale=scale),
        iters=2, warmup=1)
    kd = (k.float() * ksl[..., None]).bfloat16().repeat_interleave(h // hk, 1)
    vd = (v.float() * vsl[..., None]).bfloat16().repeat_interleave(h // hk, 1)
    qh = q.transpose(1, 2)
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(qh, kd, vd))
    flops = 4 * b * h * s_q * start * d
    nbytes = (2 * 2 * q.numel() + 4 * b * h * s_q
              + 2 * b * hk * start * (d + 4))
    res = row(K["flash_fwd_pos"], checks, ms, plain_ms,
              flops, nbytes, lib_ms)
    del kd, vd
    res["windowed"] = kernel_b3_windowed(flash, q, k, v, ksl, vsl, start,
                                         scale, dev)
    del q, kc, vc, ks, vs, k, v, ksl, vsl
    torch.cuda.empty_cache()
    res["bf16"] = kernel_b3_bf16(flash, gen, dev)
    return res


def kernel_b3_bf16(flash, gen, dev):
    """B3 over a bf16 kv as the training offsets call's forward runs it
    (flash_attention with one-chunk offsets: b=1, s=8192, q_start 0,
    causal), fast and online, with its times."""
    b, s, h, hk, d = 1, TRAIN_SEQ, MODEL["n_heads"], MODEL["n_kv_heads"], 128
    scale = d ** -0.5
    q = torch.randn((b, s, h, d), generator=gen, device=dev).bfloat16()
    k, v = (torch.randn((b, s, hk, d), generator=gen, device=dev).bfloat16()
            .transpose(1, 2) for _ in range(2))
    checks = []
    for safe in (False, True):
        o, l = flash.flash_fwd_pos(q, k, v, q_start=0, causal=True,
                                   scale=scale, safe_softmax=safe)
        po, pl_ = flash.flash_fwd_pos_plain(q, k, v, q_start=0, causal=True,
                                            scale=scale, safe_softmax=safe)
        torch.cuda.synchronize()
        checks.append(check_out(f"B3 out bf16 b=1 s={s} safe={safe}", o, po))
        check(f"B3 lse bf16 b=1 s={s} safe={safe}", max_err(l, pl_), LSE_TOL)
    ms = time_ms(lambda: flash.flash_fwd_pos(q, k, v, q_start=0, causal=True,
                                             scale=scale))
    plain_ms = time_ms(lambda: flash.flash_fwd_pos_plain(
        q, k, v, q_start=0, causal=True, scale=scale), iters=2, warmup=1)
    qh = q.transpose(1, 2)
    kr, vr = (t.repeat_interleave(h // hk, dim=1) for t in (k, v))
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qh, kr, vr, is_causal=True))
    flops = 4 * b * h * d * live_pairs(s, s, 0, True)
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel()) + 4 * b * h * s
    return {"case": f"bf16 kv, b=1 s={s}, q_start 0, causal (the training "
                    f"offsets call)",
            **case_row(checks, ms, plain_ms, flops, nbytes, lib_ms)}


def kernel_b3_windowed(flash, q, k, v, ksl, vsl, start, scale, dev):
    """B3 as the windowed path's cache-prefix call runs it (2048 rows at
    q_start 6144 over the int8 prefix, window 4096, 4 sinks) in the fast,
    online and softcap forms and over bf16; a chunk longer than the window
    without sinks (rows past it see no slot: out 0, lse -inf); a band over
    the sink tiles; the band check; and its times."""
    b, s_q, h, d = q.shape
    hk = k.shape[1]
    win = dict(window_size=(WINDOW, -1), sink_tokens=SINKS)
    kb16, vb16 = ((t.float() * sc[..., None]).bfloat16()
                  for t, sc in ((k, ksl), (v, vsl)))
    checks = []

    def case(tag, qq, args, q_start, **kw):
        o, l = flash.flash_fwd_pos(qq, *args, q_start=q_start, causal=True,
                                   scale=scale, **kw)
        po, pl_ = flash.flash_fwd_pos_plain(qq, *args, q_start=q_start,
                                            causal=True, scale=scale, **kw)
        torch.cuda.synchronize()
        checks.append(check_out(f"B3 out {tag}", o, po))
        check(f"B3 lse {tag}", max_err(l, pl_), LSE_TOL)
        return o, l

    quant = (k, v, ksl, vsl)
    clean, _ = case("int8 window sinks", q, quant, start, **win)
    case("int8 window sinks safe", q, quant, start, safe_softmax=True, **win)
    case("int8 window sinks softcap", q, quant, start, softcap=SOFTCAP, **win)
    case("bf16 window sinks", q, (kb16, vb16, None, None), start, **win)
    o, l = case("int8 chunk longer than window 1000, no sinks", q, quant,
                start, window_size=(1000, -1))
    if o[:, 1000:].any() or not torch.isneginf(l[:, :, 1000:]).all():
        raise AssertionError("B3: rows past the window are not out 0, "
                             "lse -inf")
    # 100 rows at q_start 100 with 70 sinks and window 60: the band and the
    # sinks share kv tiles 0 and 1
    case("int8 band over the sinks", q[:, :100].contiguous(),
         tuple(t[..., :200, :] if t.dim() == 4 else t[..., :200]
               for t in quant), 100, window_size=(60, -1), sink_tokens=70)
    vis = visible(s_q, start, start, True, left=WINDOW, sink=SINKS, dev=dev)
    tiles = unseen_tiles(vis, B3_KV_TILE)
    ksp, vsp = (poison(t, 2, tiles, B3_KV_TILE) for t in (ksl, vsl))
    got, _ = flash.flash_fwd_pos(q, k, v, ksp, vsp, q_start=start,
                                 causal=True, scale=scale, **win)
    torch.cuda.synchronize()
    band_check("B3", got, clean, len(tiles))

    ms = time_ms(lambda: flash.flash_fwd_pos(
        q, k, v, ksl, vsl, q_start=start, causal=True, scale=scale, **win))
    plain_ms = time_ms(lambda: flash.flash_fwd_pos_plain(
        q, k, v, ksl, vsl, q_start=start, causal=True, scale=scale, **win),
        iters=2, warmup=1)
    qh = q.transpose(1, 2)
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qh, kb16, vb16, attn_mask=vis, enable_gqa=True))
    cols = int(vis.any(0).sum())  # the prefix columns some row sees
    nbytes = (2 * 2 * q.numel() + 4 * b * h * s_q
              + 2 * b * hk * cols * (d + 4))
    res = case_row(checks, ms, plain_ms, 4 * b * h * d * int(vis.sum()),
                   nbytes, lib_ms)
    return {"case": f"int8 prefix {start}, {s_q} rows, window {WINDOW}, "
                    f"{SINKS} sinks", **res}


def sage_operands(sage, q, k, v, scale):
    """The int8 operands the sage entry points hand their kernels (the
    quantization kernels): q8 with scale*log2e folded into its (b, h, s)
    scales, K centred, all BSHD."""
    k_mean = sage.sage_k_mean(k)
    k8, ks, v8, vs = sage.sage_quant_kv(k, v, k_mean)
    q8, qs, _ = sage.sage_quant_q(q, scale, k_mean)
    return q8, qs, k8, ks, v8, vs


def kernel_quant(K, sage, gen, dev):
    """Sage's quantization kernels against their plain versions on the
    inputs of the one-shot prefill (b=4, s=8192, 16/8 heads), a ragged
    b=1, s=1000, and the pre-quantized entry's q-only step (no K mean, no
    shift): int8 values and scales bit-equal, the lse shift (fp32 sums in
    another order) within LSE_TOL. Times at the main shape, K's mean (a
    torch reduction) beside them."""
    b, s, h, hk, d = BATCH, PROMPT, MODEL["n_heads"], MODEL["n_kv_heads"], 128
    scale = d ** -0.5
    checks = {n: [] for n in SAGE_QUANT}

    def inputs(bb, ss):
        return [torch.randn(shape, generator=gen, device=dev).bfloat16()
                for shape in ((bb, ss, h, d), (bb, ss, hk, d),
                              (bb, ss, hk, d))]

    def case(tag, q, k, v):
        k_mean = sage.sage_k_mean(k)
        got = sage.sage_quant_kv(k, v, k_mean)
        want = sage.sage_quant_kv_plain(k, v, k_mean)
        gq, wq = (fn(q, scale, k_mean) for fn in (sage.sage_quant_q,
                                                   sage.sage_quant_q_plain))
        pq, wpq = (fn(q, scale) for fn in (sage.sage_quant_q,
                                           sage.sage_quant_q_plain))
        torch.cuda.synchronize()
        equal = {n: torch.equal(a, w) for n, a, w in zip(
            ("k8", "ks", "v8", "vs", "q8", "qs", "prequant q8",
             "prequant qs"), (*got, *gq[:2], *pq[:2]),
            (*want, *wq[:2], *wpq[:2]))}
        err = max_err(gq[2], wq[2])
        emit({"phase": "check", "case": f"sage quantization {tag}",
              "bit_equal": equal, "shift_max_abs_err": err,
              "lse_tol": LSE_TOL})
        if not all(equal.values()) or pq[2] is not None:
            raise AssertionError(f"sage quantization {tag}: the kernels "
                                 f"differ from their plain versions: {equal}")
        check(f"sage quantization {tag} lse shift", err, LSE_TOL)
        checks["sage_quant_kv"].append((0.0, 0.0))
        checks["sage_quant_q"].append((err, 0.0))

    case("ragged b=1 s=1000", *inputs(1, 1000))
    q, k, v = inputs(b, s)
    case(f"b={b} s={s}", q, k, v)
    k_mean = sage.sage_k_mean(k)
    ms = {"sage_quant_kv": time_ms(lambda: sage.sage_quant_kv(k, v, k_mean)),
          "sage_quant_q": time_ms(lambda: sage.sage_quant_q(q, scale,
                                                            k_mean))}
    plain_ms = {
        "sage_quant_kv": time_ms(lambda: sage.sage_quant_kv_plain(
            k, v, k_mean), iters=3, warmup=1),
        "sage_quant_q": time_ms(lambda: sage.sage_quant_q_plain(
            q, scale, k_mean), iters=3, warmup=1)}
    mean_ms = time_ms(lambda: sage.sage_k_mean(k))
    # each element read once (bf16) and written once (int8); a scale (and
    # a shift) per row; ~6 fp32 operations per element
    elems = {"sage_quant_kv": k.numel() + v.numel(),
             "sage_quant_q": q.numel()}
    rows_out = {"sage_quant_kv": 2 * b * hk * s, "sage_quant_q": 2 * b * h * s}
    res = []
    for n in SAGE_QUANT:
        nbytes = 3 * elems[n] + 4 * (rows_out[n] + k_mean.numel())
        res.append({**row(K[n], checks[n], ms[n], plain_ms[n], 6 * elems[n],
                          nbytes, None, PEAK_FP32_FLOPS),
                    "library": None, "k_mean_ms": mean_ms})
    return res


def kernel_b8(K, sage, gen, dev):
    """B8a, B8c and B8b against their plain versions on the int8 operands
    of the 0.88B model's one-shot prefill (b=4, s=8192, 16/8 heads): B8a
    causal and ragged; B8c, and ragged with s_q != s_kv; B8b with window
    4096 and 4 sinks, at q_start 0 (one-chunk offsets), with s_q != s_kv
    (bottom-right), with dead rows, and the band check. Times at the main
    shape, SDPA's flash kernel on the bf16 inputs beside them, and the
    whole sage_attention call (quantizers, kernel, lse correction)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from long_context_attention_tpu_torch.ops import flash

    b, s, h, hk, d = BATCH, PROMPT, MODEL["n_heads"], MODEL["n_kv_heads"], 128
    scale = d ** -0.5
    q, k, v = (torch.randn(shape, generator=gen, device=dev).bfloat16()
               for shape in ((b, s, h, d), (b, s, hk, d), (b, s, hk, d)))
    ops = sage_operands(sage, q, k, v, scale)
    ragged = sage_operands(sage, q[:1, :1000], k[:1, :1000], v[:1, :1000],
                           scale)
    checks = {"B8a": [], "B8b": [], "B8c": []}
    fns = {"B8a": (sage.sage_fwd_tri, sage.sage_fwd_tri_plain),
           "B8c": (sage.sage_fwd_rect, sage.sage_fwd_rect_plain),
           "B8b": (sage.sage_fwd_pos, sage.sage_fwd_pos_plain)}

    def case(name, tag, args, **kw):
        fn, plain = fns[name]
        o, l = fn(*args, **kw)
        po, pl_ = plain(*args, **kw)
        torch.cuda.synchronize()
        checks[name].append(check_out(f"{name} out {tag}", o, po))
        check(f"{name} lse {tag}", max_err(l, pl_), LSE_TOL)
        del po, pl_
        torch.cuda.empty_cache()
        return o, l

    win = dict(causal=True, window_size=(WINDOW, -1), sink_tokens=SINKS)
    case("B8a", f"b={b} s={s}", ops)
    case("B8a", "ragged s=1000", ragged)
    case("B8c", f"b={b} s={s}", ops)
    case("B8c", "ragged s_q=1000 s_kv=777",
         (*ragged[:2], ragged[2][:, :777], ragged[3][:, :, :777],
          ragged[4][:, :777], ragged[5][:, :, :777]))
    clean, _ = case("B8b", f"window sinks b={b} s={s}", ops, **win)
    case("B8b", "causal q_start 0 (one-chunk offsets)", ops, q_start=0,
         causal=True)
    tail = (ops[0][:, -CHUNK:], ops[1][:, :, -CHUNK:], *ops[2:])
    case("B8b", f"s_q={CHUNK} s_kv={s} bottom-right", tail,
         q_start=s - CHUNK, causal=True)
    case("B8b", f"s_q={CHUNK} s_kv={s} bottom-right window sinks", tail,
         q_start=s - CHUNK, **win)
    o, l = case("B8b", "ragged q_start=-8", ragged, q_start=-8, causal=True)
    if o[:, :8].any() or not torch.isneginf(l[:, :, :8]).all():
        raise AssertionError("B8b: dead rows are not out 0, lse -inf")
    # band check: rows 6144.. never see kv tiles 1..15, whose scales get NaN
    rows = slice(s - CHUNK, s)
    vis = visible(s, s, 0, True, left=WINDOW, sink=SINKS, dev=dev)
    tiles = unseen_tiles(vis[rows], B8_KV_TILE)
    ksp, vsp = (poison(t, 2, tiles, B8_KV_TILE) for t in (ops[3], ops[5]))
    got, _ = sage.sage_fwd_pos(ops[0], ops[1], ops[2], ksp, ops[4], vsp,
                               **win)
    torch.cuda.synchronize()
    band_check("B8b", got[:, rows], clean[:, rows], len(tiles))
    pairs = {"B8a": b * h * live_pairs(s, s, 0, True),
             "B8c": b * h * s * s, "B8b": b * h * int(vis.sum())}
    del ksp, vsp, got, clean, o, l, vis
    torch.cuda.empty_cache()

    kws = {"B8a": {}, "B8c": {}, "B8b": win}
    ms = {n: time_ms(lambda: fns[n][0](*ops, **kws[n])) for n in kws}
    plain_ms = {}
    for n in kws:
        plain_ms[n] = time_ms(lambda: fns[n][1](*ops, **kws[n]), iters=1,
                              warmup=0)
        torch.cuda.empty_cache()
    call_kw = {"B8a": dict(causal=True), "B8c": dict(causal=False),
               "B8b": win}
    call_ms = {n: time_ms(lambda: sage.sage_attention(q, k, v, **call_kw[n]))
               for n in call_kw}

    def quantize():  # the call's quantization: K's mean and both kernels
        k_mean = sage.sage_k_mean(k)
        sage.sage_quant_kv(k, v, k_mean)
        sage.sage_quant_q(q, scale, k_mean)

    quant_ms = time_ms(quantize)
    # pallas at the same shape: B1 (causal), B4 (window and sinks)
    pallas = {
        "B8a": ("flash_fwd_causal_self", time_ms(
            lambda: flash.flash_fwd_causal_self(q, k, v, scale=scale))),
        "B8b": ("flash_fwd_static", time_ms(lambda: flash.flash_fwd_static(
            q, k, v, scale=scale, **win)))}
    qh = q.transpose(1, 2)
    kr, vr = (t.transpose(1, 2).repeat_interleave(h // hk, 1) for t in (k, v))
    with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
        lib_ms = {c: time_ms(lambda: F.scaled_dot_product_attention(
            qh, kr, vr, is_causal=c)) for c in (True, False)}
    nbytes = (q.numel() + k.numel() + v.numel() + 2 * q.numel()
              + 4 * (2 * b * h * s + 2 * b * hk * s))
    kern = {"B8a": "sage_fwd_tri", "B8b": "sage_fwd_pos", "B8c": "sage_fwd_rect"}
    # 2*d int8 ops (QK) and 2*d bf16 FLOPs (PV) per visible pair
    return [{**row(K[kern[n]], checks[n], ms[n], plain_ms[n],
                   4 * d * pairs[n], nbytes, lib_ms[n != "B8c"],
                   PEAK_SAGE_OPS),
             "library": "SDPA flash on the bf16 q, k, v (not the same "
                        "function: no int8 quantization)",
             "sage_attention_ms": call_ms[n], "quant_ms": quant_ms,
             "kernel_ms": ms[n], "outside_kernel_ms": call_ms[n] - ms[n],
             **({"pallas_same_shape": {"kernel": pallas[n][0],
                                       "ms": pallas[n][1]}}
                if n in pallas else {})}
            for n in ("B8a", "B8b", "B8c")]


def kernel_b8_pv8(K, sage, gen, dev):
    """B8a, B8b and B8c's pv_int8 forms (the int8 PV product, P requantized
    per row over groups of T kv columns, ops/sage.py pv_tile) against their
    plain versions on the int8 operands of the 0.88B model's one-shot
    prefill (b=4, s=8192, 16/8 heads, T = 1024): B8a causal, also at
    benchmarks/bench_sage.py's heads (32/8, b=1), ragged (s=1000, T =
    1000), at s=1088 (T = 64, a divisor of 128) and at s=1536 under
    BlockSizes(768, 768) (T = 768, no power of two, through B8c); B8c, and
    ragged with s_q != s_kv (T = 777); B8b with window 4096 and 4 sinks,
    one-chunk offsets, s_q != s_kv (bottom-right) and dead rows, and its
    band check; the pre-quantized entry. Each case row by row within
    ROW_REL_TOL, with its time, its plain version's, its bound (both
    products s8: 4 * d int8 ops per visible pair at PEAK_INT8_OPS) and SDPA
    flash on the bf16 inputs (not the same function)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from long_context_attention_tpu_torch.ops.kv_cache import quantize_kv
    from long_context_attention_tpu_torch.utils.config import BlockSizes

    b, s, h, hk, d = BATCH, PROMPT, MODEL["n_heads"], MODEL["n_kv_heads"], 128
    scale = d ** -0.5

    def inputs(bb, s_q, s_kv, hh=h, hkk=hk):
        return [torch.randn(shape, generator=gen, device=dev).bfloat16()
                for shape in ((bb, s_q, hh, d), (bb, s_kv, hkk, d),
                              (bb, s_kv, hkk, d))]

    kern = {"B8a": "sage_fwd_tri_pv8", "B8b": "sage_fwd_pos_pv8",
            "B8c": "sage_fwd_rect_pv8"}
    fns = {"B8a": (sage.sage_fwd_tri, sage.sage_fwd_tri_plain),
           "B8c": (sage.sage_fwd_rect, sage.sage_fwd_rect_plain),
           "B8b": (sage.sage_fwd_pos, sage.sage_fwd_pos_plain)}
    checks = {n: [] for n in kern}
    cases = {n: [] for n in kern}
    main = {}

    def sdpa_ms(qkv, causal):
        q, k, v = qkv
        qh = q.transpose(1, 2)
        kr, vr = (t.transpose(1, 2).repeat_interleave(q.shape[2] // k.shape[2],
                                                      1) for t in (k, v))
        with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
            ms = time_ms(lambda: F.scaled_dot_product_attention(
                qh, kr, vr, is_causal=causal))
        del kr, vr
        return ms

    def case(name, tag, qkv, args, tile, vis, run=None, plain_run=None,
             **kw):
        """Kernel against plain at one shape; vis: the visible-pair
        kwargs (q_start, causal, left, sink) of live_pairs."""
        fn, plain = fns[name]
        run = run or (lambda: fn(*args, pv_tile=tile, **kw))
        plain_run = plain_run or (lambda: plain(*args, pv_tile=tile, **kw))
        o, l = run()
        po, pl_ = plain_run()
        torch.cuda.synchronize()
        checks[name].append(check_out(f"{name} pv_int8 out {tag}", o, po))
        check(f"{name} pv_int8 lse {tag}", max_err(l, pl_), LSE_TOL)
        del po, pl_
        torch.cuda.empty_cache()
        q8 = args[0]
        bb, s_q, hh, _ = q8.shape
        s_kv, hkk = args[2].shape[1], args[2].shape[2]
        pairs = bb * hh * live_pairs(s_q, s_kv, **vis)
        nbytes = (q8.numel() + 2 * args[2].numel() + 2 * q8.numel()
                  + 4 * (2 * bb * hh * s_q + 2 * bb * hkk * s_kv))
        ms = time_ms(run)
        plain_ms = time_ms(plain_run, iters=1, warmup=0)
        torch.cuda.empty_cache()
        lib = sdpa_ms(qkv, vis["causal"] and s_q == s_kv)
        res = case_row(checks[name][-1:], ms, plain_ms, 4 * d * pairs, nbytes,
                       lib, PEAK_INT8_OPS)
        cases[name].append({"case": tag, "pv_tile": tile, **res})
        if name not in main:
            main[name] = (ms, plain_ms, 4 * d * pairs, nbytes, lib)
        return o, l

    full = dict(q_start=0, causal=False)
    tri = dict(q_start=0, causal=True)
    win = dict(causal=True, window_size=(WINDOW, -1), sink_tokens=SINKS)
    win_vis = dict(q_start=0, causal=True, left=WINDOW, sink=SINKS)
    T = sage.pv_tile
    qkv = inputs(b, s, s)
    ops = sage_operands(sage, *qkv, scale)
    case("B8a", f"b={b} s={s}", qkv, ops, T(sage._TRI, s, s), tri)
    case("B8c", f"b={b} s={s}", qkv, ops, T(sage._RECT, s, s), full)
    clean, _ = case("B8b", f"window sinks b={b} s={s}", qkv, ops,
                    T(sage._POS, s, s), win_vis, **win)
    case("B8b", "causal q_start 0 (one-chunk offsets)", qkv, ops,
         T(sage._POS, s, s), tri, q_start=0, causal=True)
    tail = (ops[0][:, -CHUNK:], ops[1][:, :, -CHUNK:], *ops[2:])
    case("B8b", f"s_q={CHUNK} s_kv={s} bottom-right",
         (qkv[0][:, -CHUNK:], *qkv[1:]), tail, T(sage._POS, CHUNK, s),
         dict(q_start=s - CHUNK, causal=True), q_start=s - CHUNK,
         causal=True)
    # band check: rows 6144.. never see kv tiles 1..15, whose scales get NaN
    rows = slice(s - CHUNK, s)
    vis = visible(s, s, 0, True, left=WINDOW, sink=SINKS, dev=dev)
    tiles = unseen_tiles(vis[rows], B8_KV_TILE)
    ksp, vsp = (poison(t, 2, tiles, B8_KV_TILE) for t in (ops[3], ops[5]))
    got, _ = sage.sage_fwd_pos(ops[0], ops[1], ops[2], ksp, ops[4], vsp,
                               pv_tile=T(sage._POS, s, s), **win)
    torch.cuda.synchronize()
    band_check("B8b pv_int8", got[:, rows], clean[:, rows], len(tiles))
    del ksp, vsp, got, clean, vis, ops
    torch.cuda.empty_cache()
    # the pre-quantized entry (sage_quant_q and B8b) over the cache's int8
    # K/V, at b=1
    q1, k1, v1 = (t[:1] for t in qkv)
    k8, ks = quantize_kv(k1, "int8")
    v8, vs = quantize_kv(v1, "int8")
    pre = (k8, v8, ks.transpose(1, 2), vs.transpose(1, 2))
    q8, qs, _ = sage.sage_quant_q_plain(q1, scale)
    pre_ops = (q8, qs, k8, pre[2].float(), v8, pre[3].float())
    case("B8b", f"pre-quantized entry b=1 s={s}", (q1, k1, v1), pre_ops,
         T(sage._POS, s, s), tri,
         run=lambda: sage.sage_attention_fwd_prequant(
             q1, *pre, causal=True, pv_int8=True),
         plain_run=lambda: sage.sage_fwd_pos_plain(
             *pre_ops, causal=True, pv_tile=T(sage._POS, s, s)))
    del qkv, q1, k1, v1, pre, pre_ops, k8, v8, q8
    torch.cuda.empty_cache()
    # B8a at bench_sage.py's heads (benchmarks/bench_sage.py: 32 q heads,
    # 8 kv heads)
    qkv = inputs(1, s, s, 32, 8)
    case("B8a", f"bench_sage heads 32/8 b=1 s={s}", qkv,
         sage_operands(sage, *qkv, scale), T(sage._TRI, s, s), tri)
    # ragged: T = 1000 (one group a row), s_q != s_kv (T = 777), dead rows
    qkv = inputs(1, 1000, 1000)
    ragged = sage_operands(sage, *qkv, scale)
    case("B8a", "ragged s=1000", qkv, ragged, T(sage._TRI, 1000, 1000), tri)
    cut = (*ragged[:2], ragged[2][:, :777], ragged[3][:, :, :777],
           ragged[4][:, :777], ragged[5][:, :, :777])
    case("B8c", "ragged s_q=1000 s_kv=777",
         (qkv[0], qkv[1][:, :777], qkv[2][:, :777]), cut,
         T(sage._RECT, 1000, 777), dict(q_start=0, causal=False))
    o, l = case("B8b", "ragged q_start=-8 (dead rows)", qkv, ragged,
                T(sage._POS, 1000, 1000), dict(q_start=-8, causal=True),
                q_start=-8, causal=True)
    if o[:, :8].any() or not torch.isneginf(l[:, :, :8]).all():
        raise AssertionError("B8b pv_int8: dead rows are not out 0, lse -inf")
    # T = 64 divides a tile (s = 1088 under the default tiles), and T =
    # 768 under BlockSizes(768, 768) at s = 1536
    qkv = inputs(1, 1088, 1088)
    case("B8a", "s=1088 (T=64)", qkv, sage_operands(sage, *qkv, scale),
         T(sage._TRI, 1088, 1088), tri)
    qkv = inputs(1, 1536, 1536)
    case("B8c", "s=1536 BlockSizes(768, 768) (T=768)", qkv,
         sage_operands(sage, *qkv, scale),
         T(sage._RECT, 1536, 1536, 1, BlockSizes(768, 768)), full)
    del qkv, ragged, cut, o, l
    torch.cuda.empty_cache()
    for name, tile in (("B8a", 64), ("B8c", 768)):
        got = [c["pv_tile"] for c in cases[name]]
        if tile not in got:
            raise AssertionError(f"{name} pv_int8: no case at T={tile}")
    return [{**row(K[kern[n]], checks[n], *main[n], PEAK_INT8_OPS),
             "pv_tile": cases[n][0]["pv_tile"],
             "library": "SDPA flash on the bf16 q, k, v (not the same "
                        "function: no int8 quantization)",
             "cases": cases[n]}
            for n in ("B8a", "B8b", "B8c")]


# B6's quantizing entry (cache_append_rows) at the decode step's one token,
# an interleaved admission's chunk of 256 and a prefill chunk of 2048, for
# every cache kind, dense and paged, with the phase whose counters give
# each case its launches (None: no phase of the run takes that form)
B6_RUNS = (1, 256, 2048)
B6_PATHS = {("int8", False, 1): "slice", ("int8", False, 2048): "slice",
            ("int8", True, 1): "serve_paged",
            ("int8", True, 256): "serve_stall interleaved",
            ("float8_e4m3fn", False, 1): "slice_fp8",
            ("float8_e4m3fn", False, 2048): "slice_fp8",
            ("int4", False, 1): "slice_int4",
            ("int4", False, 2048): "slice_int4",
            ("float8_e4m3fn", True, 1): "serve_paged_fp8",
            ("float8_e4m3fn", True, 256): "serve_paged_fp8 interleaved"}


def scalar_divisor_quantize(kv_cache, x, dtype):
    """quantize_kv's arithmetic with qmax as a Python divisor, which CUDA
    turns into a multiply by its reciprocal: the torch chain that wrote the
    cache on the card before B6 quantized (kept here to count what it gets
    wrong against the IEEE quotients)."""
    qmax = kv_cache._QMAX[dtype]
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1), min=1e-6) / qmax
    q = xf / scale[..., None]
    if dtype != "float8_e4m3fn":
        q = torch.round(q)
    q = torch.clamp(q, -qmax, qmax)
    if dtype == "int4":
        return kv_cache.pack_int4(q), scale
    return q.to(kv_cache._STORAGE[dtype]), scale


def as_bytes(t):
    """A stored tensor as comparable integers (bf16 and fp8 by their
    bytes)."""
    if t.dtype in (torch.bfloat16, torch.float8_e4m3fn):
        return t.view(torch.uint8)
    return t


def quantize_mismatch(kv_cache, x, dtype, quantizer):
    """Scales and stored values of ``quantizer`` run on the card that differ
    from quantize_kv on CPU copies of the same rows (the plain version's
    quotients)."""
    qc, sc = quantizer(x, dtype)
    qr, sr = kv_cache.quantize_kv(x.cpu(), dtype)
    return {"scales": int((sc.cpu() != sr).sum()),
            "values": int((as_bytes(qc.cpu()) != as_bytes(qr)).sum()),
            "of": [sr.numel(), qr.numel()]}


def b6_cache(kv_cache, dtype, paged, gen, dev, hk=MODEL["n_kv_heads"],
             d=128):
    """A two-layer cache of ``dtype`` on the card with random contents:
    dense (BATCH rows of S_MAX) or the paged engine's pool (POOL pages of
    PAGE, rows of PAGED_S_MAX on distinct random pages), ``hk`` kv heads
    of head dim ``d``."""
    if paged:
        c = kv_cache.PagedKVCache.init(2, BATCH, POOL, PAGE,
                                       PAGED_S_MAX // PAGE, hk, d, dtype,
                                       device=dev)
        pages = torch.randperm(POOL - 1, generator=torch.Generator()
                               .manual_seed(SEED)) + 1
        c.page_table.copy_(pages[:c.page_table.numel()].view(
            c.page_table.shape))
    else:
        c = kv_cache.KVCache.init(2, BATCH, S_MAX, hk, d, dtype, device=dev)
    for t in (c.k, c.v):
        t.view(torch.uint8).copy_(torch.randint(
            0, 256, t.view(torch.uint8).shape, generator=gen, device=dev,
            dtype=torch.uint8))
    for t in (c.k_scale, c.v_scale):
        if t is not None:
            t.copy_(torch.rand(t.shape, generator=gen, device=dev))
    return c


def cpu_cache(c):
    """The same cache object with CPU copies of its tensors."""
    return dataclasses.replace(c, **{
        f.name: getattr(c, f.name).cpu() for f in dataclasses.fields(c)
        if f.init and getattr(c, f.name) is not None})


def b6_rows_case(decode, kv_cache, dtype, paged, n, gen, dev,
                 hk=MODEL["n_kv_heads"], d=128, paths=None):
    """B6's quantizing entry at one kind, layout and run: bf16 rows (b, n,
    h_kv, d) of the projection's layout written into layer 1 at slots that
    skip a row (append_pos = -n), run past the capacity and straddle a
    page; the whole cache bit for bit against cache_append_rows_plain on CPU
    copies; the card-side torch chains' scales and values that differ from
    the CPU's quotients (quantize_kv must match: 0); device ms per launch
    under torch.profiler, the call's ms and the wrapper's host ms; the plain
    version on the card; the chain it replaces (quantize_kv of K and V on
    the card, then the byte-copy append) as its library time. ``hk``,
    ``d``: the cache's kv heads and head dim; ``paths``: the phase of each
    (dtype, paged, n) case (B6_PATHS by default)."""
    c = b6_cache(kv_cache, dtype, paged, gen, dev, hk, d)
    cap = PAGED_S_MAX if paged else S_MAX
    pos = torch.tensor([{1: PROMPT, 256: 3 * PAGE - 100,
                         2048: PAGE - 1000}[n], -n, cap - (n + 1) // 2, 0],
                       dtype=torch.int32)
    k = (torch.randn((BATCH, n, hk, d), generator=gen, device=dev)
         * 2).bfloat16()
    v = torch.randn((BATCH, n, hk, d), generator=gen, device=dev).bfloat16()
    ref = cpu_cache(c)
    pos_d = pos.to(dev)
    decode.cache_append_rows(c, 1, k, v, pos_d)
    decode.cache_append_rows_plain(ref, 1, k.cpu(), v.cpu(), pos)
    torch.cuda.synchronize()
    tag = f"{dtype} {'paged' if paged else 'dense'} n={n}"
    for f in ("k", "v", "k_scale", "v_scale"):
        if getattr(c, f) is not None and not torch.equal(
                as_bytes(getattr(c, f).cpu()), as_bytes(getattr(ref, f))):
            raise AssertionError(f"B6 {tag}: the kernel's cache.{f} differs "
                                 f"from the plain version's")
    mismatch = None
    if dtype != "bfloat16":
        kt = k.transpose(1, 2)
        mismatch = {
            "scalar_divisor_chain": quantize_mismatch(
                kv_cache, kt, dtype,
                functools.partial(scalar_divisor_quantize, kv_cache)),
            "quantize_kv": quantize_mismatch(kv_cache, kt, dtype,
                                             kv_cache.quantize_kv)}
        if mismatch["quantize_kv"]["scales"] or \
                mismatch["quantize_kv"]["values"]:
            raise AssertionError(f"B6 {tag}: quantize_kv on the card "
                                 f"misses the CPU's quotients: {mismatch}")
    emit({"phase": "check", "case": f"B6 {tag}", "bit_equal": True,
          "torch_chain_mismatch": mismatch})
    times = kernel_timing([lambda: decode.cache_append_rows(c, 1, k, v,
                                                            pos_d)],
                          rounds=50 if n < 2048 else 20)
    plain_ms = time_ms(lambda: decode.cache_append_rows_plain(
        c, 1, k, v, pos_d), iters=5)

    def replaced_chain():
        kq, ks = kv_cache.quantize_kv(k.transpose(1, 2), dtype)
        vq, vs = kv_cache.quantize_kv(v.transpose(1, 2), dtype)
        decode.cache_append(c.k, c.v, kq, vq, pos_d, c.k_scale, c.v_scale,
                            ks, vs, layer=1,
                            page_table=getattr(c, "page_table", None))

    lib_ms = time_ms(replaced_chain, iters=10)
    slots = pos[:, None] + torch.arange(n)[None]
    live = int(((slots >= 0) & (slots < cap)).sum())
    # each live token: K and V rows read in bf16, written quantized with
    # their fp32 scales
    nbytes = 2 * live * hk * (2 * d + int(CACHE_ELT[dtype] * d)
                              + 4 * (dtype != "bfloat16"))
    res = b7_row_times({"case": tag, "dtype": dtype, "paged": paged, "n": n,
                        "head_dim": d, "rows_at": pos.tolist(),
                        "path": (B6_PATHS if paths is None else paths).get(
                            (dtype, paged, n)),
                        "torch_chain_mismatch": mismatch,
                        **case_row([(0.0, 0.0)], times["ms"], plain_ms, 0,
                                   nbytes, lib_ms),
                        "library": "quantize_kv of K and V on the card, "
                                   "then cache_append's byte copy (the "
                                   "chain B6's quantizing kinds replace)"},
                       times)
    del c, ref, k, v
    torch.cuda.empty_cache()
    return res


def b6_launch_floor(build, blocks):
    """Device ms of an empty kernel of ``blocks`` blocks of 256 threads
    (cache_append.cu's lca_empty_launch), the launch floor a B6 launch is
    held against, under torch.profiler as kernel_timing times B6."""
    lib = build.library("cache_append.cu")
    fn = lib.lca_empty_launch
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def launch():
        if fn(blocks, build.stream_ptr(torch.device("cuda"))) != 0:
            raise AssertionError("the empty launch failed")

    return {"blocks": blocks, **kernel_timing([launch], rounds=50)}


def kernel_b6(K, decode, gen, dev):
    """B6: the quantizing entry at the slice's shapes, dense int8 and bf16
    (b6_rows_case, the decode step's int8 token the row's main case), the
    launch floor beside it, then the public cache_append's byte-copy kind
    against cache_append_plain."""
    from long_context_attention_tpu_torch.ops import _build as build
    from long_context_attention_tpu_torch.ops import kv_cache

    cases = [b6_rows_case(decode, kv_cache, dt, False, n, gen, dev)
             for dt in ("int8", "bfloat16") for n in B6_RUNS]
    main = cases[0]
    floor = b6_launch_floor(build, -(-2 * BATCH * MODEL["n_kv_heads"]
                                     // 8))
    L, b, hk, d = MODEL["n_layers"], BATCH, MODEL["n_kv_heads"], 128
    kc = torch.randint(-127, 128, (L, b, hk, S_MAX, d), generator=gen,
                       device=dev, dtype=torch.int8)
    vc = torch.randint(-127, 128, kc.shape, generator=gen, device=dev,
                       dtype=torch.int8)
    ks = torch.rand((L, b, hk, 1, S_MAX), generator=gen, device=dev)
    vs = torch.rand(ks.shape, generator=gen, device=dev)
    kn = torch.randint(-127, 128, (b, hk, 1, d), generator=gen, device=dev,
                       dtype=torch.int8)
    vn = torch.randint(-127, 128, kn.shape, generator=gen, device=dev,
                       dtype=torch.int8)
    ksn = torch.rand((b, hk, 1), generator=gen, device=dev)
    vsn = torch.rand(ksn.shape, generator=gen, device=dev)
    pos = torch.tensor([PROMPT, -1, S_MAX - 1, 100], dtype=torch.int32,
                       device=dev)
    layer = L - 1
    cache = [kc, vc, ks, vs]
    ref = [t.clone() for t in cache]
    skipped = kc[layer, 1].clone()  # pos -1: this row must stay as it was
    decode.cache_append(*cache[:2], kn, vn, pos, *cache[2:], ksn, vsn,
                        layer=layer)
    decode.cache_append_plain(*ref[:2], kn, vn, pos, *ref[2:], ksn, vsn,
                              layer=layer)
    torch.cuda.synchronize()
    for a, r in zip(cache, ref):
        if not torch.equal(a, r):
            raise AssertionError("B6: kernel and plain caches differ")
    if not torch.equal(kc[layer, 1], skipped):
        raise AssertionError("B6: the row at position -1 was written")
    if not (torch.equal(kc[layer, 0, :, PROMPT], kn[0, :, 0])
            and torch.equal(vs[layer, 2, :, 0, S_MAX - 1], vsn[2, :, 0])):
        raise AssertionError("B6: a live token was not written")
    times = kernel_timing([lambda: decode.cache_append(
        *cache[:2], kn, vn, pos, *cache[2:], ksn, vsn, layer=layer)],
        rounds=50)
    plain_ms = time_ms(lambda: decode.cache_append_plain(
        *ref[:2], kn, vn, pos, *ref[2:], ksn, vsn, layer=layer), iters=20)
    live = (pos >= 0) & (pos < S_MAX)
    bi = torch.nonzero(live)[:, 0]
    si = pos[bi].long()

    def indexed_copy():
        kc[layer, bi, :, si] = kn[bi, :, 0]
        vc[layer, bi, :, si] = vn[bi, :, 0]
        ks[layer, bi, :, 0, si] = ksn[bi, :, 0]
        vs[layer, bi, :, 0, si] = vsn[bi, :, 0]

    lib_ms = time_ms(indexed_copy, iters=20)
    n_live = int(live.sum())
    nbytes = 2 * n_live * 2 * hk * (d + 4)  # read new + write cache, k and v
    copy = b7_row_times({"case": "byte copy (cache_append), int8 dense n=1",
                         **case_row([(0.0, 0.0)], times["ms"], plain_ms, 0,
                                    nbytes, lib_ms)}, times)
    res = {**row(K["cache_append"], [(0.0, 0.0)], main["ms"],
                 main["plain_ms"], 0, 0, main["library_ms"]),
           **{k: main[k] for k in ("bound_ms", "bound_by", "call_ms",
                                   "host_ms", "device_ms_by_kernel",
                                   "kernels_per_call")},
           "case": main["case"], "library": main["library"],
           "launch_floor": floor, "rows_cases": cases, "copy_case": copy}
    return res




def kernel_timing(calls, rounds=B7_ROUNDS):
    """Times of a decode kernel's wrapper over ``calls`` (B7: one
    zero-argument call per layer of its cache), run in turn ``rounds``
    times, so no B7 call finds its bytes in L2: the kernels' device ms per
    call under torch.profiler (``ms``; B7: the span kernel and the spans'
    merge, each launched once a call, by kernel in
    ``device_ms_by_kernel``), the call's ms by CUDA events (``call_ms``)
    and the wrapper's host ms per call (``host_ms``: the enqueue, no
    synchronisation inside)."""
    n = len(calls) * rounds

    def sweep():
        for _ in range(rounds):
            for c in calls:
                c()

    call_ms = time_ms(sweep, iters=2, warmup=1) / n
    _, prof = profiled(sweep)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sweep()
    host_ms = (time.perf_counter() - t0) * 1e3 / n
    torch.cuda.synchronize()
    # each kernel launches once a call: its mean duration, summed over the
    # kernels (a trace that misses some events still gives the means)
    by_kernel = {name: t / cnt for name, cnt, t in prof["top"]}
    return {"ms": sum(by_kernel.values()), "call_ms": call_ms,
            "host_ms": host_ms, "device_ms_by_kernel": by_kernel,
            "kernels_per_call": prof["kernel_launches"] / n}


def b7_layer_calls(decode, args, layers, **kw):
    """One decode_attention_core call per layer on the same operands."""
    return [functools.partial(decode.decode_attention_core, *args, layer=li,
                              **kw) for li in range(layers)]


def b7_row_times(res, times):
    """A B6 or one-token B7 row or case with its timing's other
    numbers."""
    for key in ("call_ms", "host_ms", "device_ms_by_kernel",
                "kernels_per_call"):
        res[key] = times[key]
    return res


def kernel_b7(K, decode, gen, dev):
    """decode_attention, the wrapper the decode step calls (its q
    quantization or fold included), on the card against the same call on
    CPU copies of the layer, which runs the plain version; the kernel timed
    over the cache's layers in turn (b7_timing); then window and sinks, a
    run of 4 tokens (G = 8 query rows per kv head) and a 192-column tile."""
    L, b, hk, d = MODEL["n_layers"], BATCH, MODEL["n_kv_heads"], 128
    h = MODEL["n_heads"]
    g = h // hk
    lens = torch.tensor([PROMPT + 1, PROMPT - 42, PROMPT + NEW, PROMPT - 193],
                        dtype=torch.int32, device=dev)
    layer, scale = L // 3, d ** -0.5
    win = dict(window_size=(WINDOW, -1), sink_tokens=SINKS)
    checks, wchecks, times = [], [], {}
    for cache_dtype in ("int8", "bfloat16"):
        if cache_dtype == "int8":
            kc = torch.randint(-127, 128, (L, b, hk, S_MAX, d), generator=gen,
                               device=dev, dtype=torch.int8)
            vc = torch.randint(-127, 128, kc.shape, generator=gen,
                               device=dev, dtype=torch.int8)
            ks = torch.rand((L, b, hk, 1, S_MAX), generator=gen,
                            device=dev) / 64
            vs = torch.rand(ks.shape, generator=gen, device=dev) / 64
        else:
            kc = torch.randn((L, b, hk, S_MAX, d), generator=gen,
                             device=dev).bfloat16()
            vc = torch.randn(kc.shape, generator=gen,
                             device=dev).bfloat16()
            ks = vs = None
        q = torch.randn((b, h, d), generator=gen, device=dev).bfloat16()
        cache = (kc, vc, lens, ks, vs)
        cpu = [None if t is None else (t[layer:layer + 1] if t.dim() == 5
                                       else t).cpu() for t in cache]
        for safe in (False, True):
            o, l = decode.decode_attention(q, *cache, layer=layer,
                                           return_lse=True, safe_softmax=safe)
            po, pl_ = decode.decode_attention(q.cpu(), *cpu, layer=0,
                                              return_lse=True,
                                              safe_softmax=safe)
            torch.cuda.synchronize()
            checks.append(check_out(f"B7 out {cache_dtype} safe={safe}",
                                    o.cpu(), po, tol=B7_ROW_TOL))
            check(f"B7 lse {cache_dtype} safe={safe}", max_err(l.cpu(), pl_),
                  B7_LSE_TOL)
        for tag, kw in (("window sinks", win),
                        ("window sinks safe", dict(win, safe_softmax=True)),
                        ("window sinks softcap", dict(win, softcap=SOFTCAP))):
            if cache_dtype == "bfloat16" and tag != "window sinks":
                continue
            o, l = decode.decode_attention(q, *cache, layer=layer,
                                           return_lse=True, **kw)
            po, pl_ = decode.decode_attention(q.cpu(), *cpu, layer=0,
                                              return_lse=True, **kw)
            torch.cuda.synchronize()
            wchecks.append(check_out(f"B7 out {cache_dtype} {tag}", o.cpu(),
                                     po, tol=B7_ROW_TOL))
            check(f"B7 lse {cache_dtype} {tag}", max_err(l.cpu(), pl_),
                  B7_LSE_TOL)
        if cache_dtype == "int8":
            # the kernel alone, on the operands the wrapper makes, over
            # every layer in turn
            q_in, q_rs, bkv = decode.decode_query_operands(
                q, kc, True, scale=scale, block_kv=4096)
            args = (q_in, q_rs, kc, vc, ks, vs, lens)
            kw = dict(block_kv=bkv, scale=scale)
            times = kernel_timing(b7_layer_calls(decode, args, L, **kw))
            times["plain_ms"] = time_ms(
                lambda: decode.decode_attention_core_plain(
                    *args, layer=layer, **kw), iters=3, warmup=1)
            n = int(lens.max())
            kd = (kc[layer, :, :, :n].float() * ks[layer, :, :, 0, :n, None]
                  ).bfloat16().repeat_interleave(g, 1)
            vd = (vc[layer, :, :, :n].float() * vs[layer, :, :, 0, :n, None]
                  ).bfloat16().repeat_interleave(g, 1)
            mask = (torch.arange(n, device=dev)[None, :]
                    < lens[:, None])[:, None, None, :]
            qh = q[:, :, None, :]
            times["lib"] = time_ms(lambda: F.scaled_dot_product_attention(
                qh, kd, vd, attn_mask=mask), iters=20)
            live = int(lens.sum())
            nbytes_int8 = (2 * hk * live * d + 8 * hk * live
                           + b * h * d * 2 * 2)
            del kd, vd
            int8_case = (q, kc, vc, ks, vs)
    windowed = kernel_b7_windowed(decode, *int8_case, lens, layer, wchecks)
    shapes = kernel_b7_shapes(decode, *int8_case[1:], lens, gen)
    # int8 ops: q.k and p.v, 2 each per (head, column, feature)
    res = row(K["decode_attention"], checks,
              times["ms"], times["plain_ms"], 4 * h * int(lens.sum()) * d,
              nbytes_int8, times["lib"], PEAK_INT8_OPS)
    res = b7_row_times(res, times)
    res["windowed"] = windowed
    res["shape_cases"] = shapes
    return res


def kernel_b7_windowed(decode, q, kc, vc, ks, vs, lens, layer, checks):
    """B7 with the window and sinks over the int8 cache: the band check
    (each row's kv tiles outside its sink tile and window band get NaN
    scales) and the times over the layers in turn, with the bound of the
    sink and band tokens."""
    b, h, d = q.shape
    L, hk, s_max = kc.shape[0], kc.shape[2], kc.shape[3]
    scale = d ** -0.5
    win = dict(window_size=(WINDOW, -1), sink_tokens=SINKS)
    q_in, q_rs, bkv = decode.decode_query_operands(q, kc, True, scale=scale,
                                                   block_kv=4096)
    ksp, vsp = ks.clone(), vs.clone()
    n_tiles = 0
    for r, n in enumerate(lens.tolist()):
        band = range(max(n - 1 - WINDOW, 0) // bkv, (n - 1) // bkv + 1)
        for t in range(-(-s_max // bkv)):
            if t != 0 and t not in band:  # tile 0 holds the sinks
                ksp[layer, r, :, 0, t * bkv:(t + 1) * bkv] = math.nan
                vsp[layer, r, :, 0, t * bkv:(t + 1) * bkv] = math.nan
                n_tiles += 1
    clean = decode.decode_attention(q, kc, vc, lens, ks, vs, layer=layer,
                                    **win)
    got = decode.decode_attention(q, kc, vc, lens, ksp, vsp, layer=layer,
                                  **win)
    torch.cuda.synchronize()
    band_check("B7", got, clean, n_tiles)
    del ksp, vsp

    args = (q_in, q_rs, kc, vc, ks, vs, lens)
    kw = dict(block_kv=bkv, scale=scale, window_left=WINDOW,
              sink_tokens=SINKS)
    times = kernel_timing(b7_layer_calls(decode, args, L, **kw))
    plain_ms = time_ms(lambda: decode.decode_attention_core_plain(
        *args, layer=layer, **kw), iters=3, warmup=1)
    n = int(lens.max())
    cols = torch.arange(n, device=q.device)[None, :]
    last = lens.long()[:, None] - 1
    vis = (cols <= last) & ((cols >= last - WINDOW) | (cols < SINKS))
    kd, vd = ((t[layer, :, :, :n].float() * sc[layer, :, :, 0, :n, None])
              .bfloat16() for t, sc in ((kc, ks), (vc, vs)))
    qh = q[:, :, None, :]
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qh, kd, vd, attn_mask=vis[:, None, None, :], enable_gqa=True),
        iters=20)
    seen = int(vis.sum())  # sink and band tokens over the rows
    nbytes = 2 * hk * seen * d + 8 * hk * seen + b * h * d * 2 * 2
    res = case_row(checks, times["ms"], plain_ms, 4 * h * seen * d, nbytes,
                   lib_ms, PEAK_INT8_OPS)
    return b7_row_times({"case": f"int8 cache, lengths {lens.tolist()}, "
                                 f"window {WINDOW}, {SINKS} sinks", **res},
                        times)


def sdpa_b7_ms(qr, kd, vd, lens, win=-1, sinks=0, iters=10):
    """SDPA's time over a dequantized cache (b, h_kv, n, d) bf16 for runs
    qr (b, n_tok, h, d), each query row masked to its causal columns (and
    window and sinks), as B7's library yardstick."""
    n_tok, n = qr.shape[1], kd.shape[2]
    qpos = (lens.long()[:, None] - n_tok
            + torch.arange(n_tok, device=qr.device)[None])[:, :, None]
    cols = torch.arange(n, device=qr.device)[None, None]
    vis = cols <= qpos
    if win >= 0:
        vis &= (cols >= qpos - win) | (cols < sinks)
    qh = qr.transpose(1, 2)
    return time_ms(lambda: F.scaled_dot_product_attention(
        qh, kd, vd, attn_mask=vis[:, None], enable_gqa=True), iters=iters)


def kernel_b7_shapes(decode, kc, vc, ks, vs, lens, gen):
    """One-token B7's kernel at two other shapes over the int8 cache: a run
    of 4 tokens per row (G = g * 4 = 8 query rows per kv head, one group)
    and a 192-column tile (no 128-multiple: a cluster of one span), each
    on decode_attention by its counter, against the plain version and
    timed over the layers in turn."""
    L, b, hk, _, d = kc.shape
    h = MODEL["n_heads"]
    layer, scale = L // 3, d ** -0.5
    cpu = [t[layer:layer + 1].cpu() for t in (kc, vc, ks, vs)]
    cases = []
    for tag, n_tok, block_kv in (("int8 run of 4 (G=8)", 4, 4096),
                                 ("int8 tile 192", 1, 192)):
        qr = torch.randn((b, n_tok, h, d), generator=gen,
                         device=kc.device).bfloat16()
        q = qr if n_tok > 1 else qr[:, 0]
        decode._build.reset_launch_counts()
        o, l = decode.decode_attention(q, kc, vc, lens, ks, vs, layer=layer,
                                       block_kv=block_kv, return_lse=True)
        torch.cuda.synchronize()
        got = decode._build.launch_counts()
        if got["decode_attention"] != 1 or got["decode_run"] != 0:
            raise AssertionError(f"B7 {tag}: launched {got}")
        po, pl_ = decode.decode_attention(q.cpu(), cpu[0], cpu[1], lens.cpu(),
                                          cpu[2], cpu[3], layer=0,
                                          block_kv=block_kv, return_lse=True)
        checks = [check_out(f"B7 out {tag}", o.cpu(), po, tol=B7_ROW_TOL)]
        check(f"B7 lse {tag}", max_err(l.cpu(), pl_), B7_LSE_TOL)
        q_in, q_rs, bkv = decode.decode_query_operands(
            qr, kc, True, scale=scale, block_kv=block_kv)
        args = (q_in, q_rs, kc, vc, ks, vs, lens)
        kw = dict(block_kv=bkv, scale=scale, n_tok=n_tok)
        times = kernel_timing(b7_layer_calls(decode, args, L, **kw))
        plain_ms = time_ms(lambda: decode.decode_attention_core_plain(
            *args, layer=layer, **kw), iters=2, warmup=1)
        n = int(lens.max())
        kd, vd = ((t[layer, :, :, :n].float() * sc[layer, :, :, 0, :n, None])
                  .bfloat16() for t, sc in ((kc, ks), (vc, vs)))
        lib_ms = sdpa_b7_ms(qr, kd, vd, lens)
        del kd, vd
        nbytes, ops = b7_bound(lens.tolist(), n_tok, h, hk, d, 1)
        launch = decode.decode_launch("decode_attention", b, hk,
                                      q_in.shape[2], kc.shape[3], bkv, n_tok,
                                      row_bytes=d)
        cases.append(b7_row_times(
            {"case": f"{tag}, lengths {lens.tolist()}, tile {bkv}, "
                     f"cluster {launch.cluster} x span {launch.span}",
             **case_row(checks, times["ms"], plain_ms, ops, nbytes, lib_ms,
                        PEAK_INT8_OPS)}, times))
    return cases


# ---------------------------------------------------------------------------
# B6 and B7 over the paged pool, and B7 over multi-token runs
# ---------------------------------------------------------------------------

# The paged engine's pool (benchmarks/bench_paged.py:180-186): pages of
# 2048, a row of 16384 = 8 pages, 65 pages (8 rows + the scratch page 0).
PAGE, PAGED_S_MAX, POOL = 2048, 16384, 65
PAGED_LENS = (16384, 9000, 2049, 1)   # rows' lengths (a full row, ragged)
# Multi-token runs: the prefix cache's suffix chunk (64 tokens) and a
# 256-token chunk of interleaved admission, which the tile rule splits,
# over serve_prefix's rows (s_max 20480: 10 pages).
RUN_LENS, RUN_PAGES = (16448, 5000), 10


def paged_pool(gen, dev, dtype, L=2, lens=None, n_pages=None,
               hk=MODEL["n_kv_heads"], d=128):
    """A pool (L, POOL, h_kv, PAGE, d) of random values (int8 with scales
    in (0, 1/64]) and a page table: each row's live pages on random pool
    pages (never the scratch page 0), -1 past its prefix."""
    lens = PAGED_LENS if lens is None else lens
    n_pages = n_pages or PAGED_S_MAX // PAGE
    shape = (L, POOL, hk, PAGE, d)
    if dtype == "int8":
        kc = torch.randint(-127, 128, shape, generator=gen, device=dev,
                           dtype=torch.int8)
        vc = torch.randint(-127, 128, shape, generator=gen, device=dev,
                           dtype=torch.int8)
        ks = torch.rand((L, POOL, hk, 1, PAGE), generator=gen,
                        device=dev) / 64
        vs = torch.rand(ks.shape, generator=gen, device=dev) / 64
    else:
        kc = torch.randn(shape, generator=gen, device=dev).bfloat16()
        vc = torch.randn(shape, generator=gen, device=dev).bfloat16()
        ks = vs = None
    pt = torch.full((len(lens), n_pages), -1, dtype=torch.int32)
    free = (torch.randperm(POOL - 1, generator=torch.Generator()
                           .manual_seed(SEED)) + 1).tolist()
    for r, n in enumerate(lens):
        for i in range(-(-n // PAGE)):
            pt[r, i] = free.pop()
    return kc, vc, ks, vs, pt.to(dev)


def gather_dense(pool, pt, scales=False):
    """The dense layered cache (L, b, h_kv, n_pages * page, ...) that holds
    the pool's pages in each row's logical order (zeros where -1)."""
    L, P = pool.shape[:2]
    b, n_pages = pt.shape
    page = pool.shape[-1] if scales else pool.shape[3]
    idx = pt.long().clamp(min=0)
    g = pool[:, idx]  # (L, b, n_pages, h_kv, page or 1, ...)
    g = torch.where((pt >= 0).view(1, b, n_pages, *[1] * (g.dim() - 3)), g,
                    torch.zeros_like(g))
    if scales:  # (L, b, n, h, 1, page) -> (L, b, h, 1, n * page)
        return g.permute(0, 1, 3, 4, 2, 5).reshape(L, b, g.shape[3], 1,
                                                   n_pages * page)
    return g.permute(0, 1, 3, 2, 4, 5).reshape(L, b, g.shape[3],
                                               n_pages * page, g.shape[-1])


def kernel_b6_paged(decode, gen, dev):
    """B6 through the page table: the quantizing entry over the paged
    engine's pool, int8 and bf16 (b6_rows_case); then the public
    cache_append's byte-copy kind: a one-token run per row (the decode step)
    and a 256-token run (an interleaved-admission chunk) that straddles a
    page, against the plain version; a skipped row; and paging as pure
    indexing: the pool after the paged append, gathered through the table,
    equals a dense cache of the same content after the dense append.
    Returns (the byte-copy cases, the quantizing cases)."""
    from long_context_attention_tpu_torch.ops import kv_cache

    rows = [b6_rows_case(decode, kv_cache, dt, True, n, gen, dev)
            for dt in ("int8", "bfloat16") for n in B6_RUNS]
    hk, d, layer = MODEL["n_kv_heads"], 128, 1
    kc, vc, ks, vs, pt = paged_pool(gen, dev, "int8")
    cases = []
    for n, pos in ((1, [PAGED_S_MAX - 1, *PAGED_LENS[1:]]),
                   (256, [3 * PAGE - 100, -256, PAGED_LENS[2] - 256, 0])):
        b = len(pos)
        # the rows' pages cover the run: grow the table to its last slot
        # (entries past it stay -1)
        ptn = pt.clone()
        used = set(ptn[ptn >= 0].tolist())
        spare = [p for p in range(1, POOL) if p not in used]
        for r, p0 in enumerate(pos):
            for i in range(max(p0 + n, 1) // PAGE + 1):
                if i < ptn.shape[1] and p0 + n > i * PAGE and ptn[r, i] < 0:
                    ptn[r, i] = spare.pop()
        kn = torch.randint(-127, 128, (b, hk, n, d), generator=gen,
                           device=dev, dtype=torch.int8)
        vn = torch.randint(-127, 128, kn.shape, generator=gen, device=dev,
                           dtype=torch.int8)
        ksn = torch.rand((b, hk, n), generator=gen, device=dev)
        vsn = torch.rand(ksn.shape, generator=gen, device=dev)
        pos_t = torch.tensor(pos, dtype=torch.int32, device=dev)
        cache = [kc.clone(), vc.clone(), ks.clone(), vs.clone()]
        ref = [t.clone() for t in cache]
        dense = [gather_dense(cache[0], ptn), gather_dense(cache[1], ptn),
                 gather_dense(cache[2], ptn, True),
                 gather_dense(cache[3], ptn, True)]
        decode.cache_append(*cache[:2], kn, vn, pos_t, *cache[2:], ksn, vsn,
                            layer=layer, page_table=ptn)
        decode.cache_append_plain(*ref[:2], kn, vn, pos_t, *ref[2:], ksn,
                                  vsn, layer=layer, page_table=ptn)
        decode.cache_append(*dense[:2], kn, vn, pos_t, *dense[2:], ksn, vsn,
                            layer=layer)
        torch.cuda.synchronize()
        for a, r in zip(cache, ref):
            if not torch.equal(a, r):
                raise AssertionError(f"B6 paged n={n}: kernel and plain "
                                     f"pools differ")
        for i, (a, r) in enumerate(zip(cache, dense)):
            got = gather_dense(a, ptn, scales=i >= 2)
            if not torch.equal(got, r):
                raise AssertionError(f"B6 paged n={n}: the gathered pool "
                                     f"differs from the dense append")
        skip = [r for r, p0 in enumerate(pos) if p0 + n <= 0]
        for r in skip:
            for p in ptn[r][ptn[r] >= 0].tolist():
                if not torch.equal(cache[0][layer, p], kc[layer, p]):
                    raise AssertionError("B6 paged: a skipped row wrote")
        emit({"phase": "check", "case": f"B6 paged n={n}", "bit_equal": True,
              "dense_after_gather_equal": True})
        times = kernel_timing([lambda: decode.cache_append(
            *cache[:2], kn, vn, pos_t, *cache[2:], ksn, vsn, layer=layer,
            page_table=ptn)], rounds=50)
        plain_ms = time_ms(lambda: decode.cache_append_plain(
            *ref[:2], kn, vn, pos_t, *ref[2:], ksn, vsn, layer=layer,
            page_table=ptn), iters=10)
        slots = pos_t.long()[:, None] + torch.arange(n, device=dev)[None]
        bi, ti = ((slots >= 0) & (slots < PAGED_S_MAX)).nonzero(
            as_tuple=True)
        si = slots[bi, ti]
        pg, off = ptn.long()[bi, si // PAGE], si % PAGE

        def indexed_copy():
            kc[layer, pg, :, off] = kn[bi, :, ti]
            vc[layer, pg, :, off] = vn[bi, :, ti]
            ks[layer, pg, :, 0, off] = ksn[bi, :, ti]
            vs[layer, pg, :, 0, off] = vsn[bi, :, ti]

        lib_ms = time_ms(indexed_copy, iters=10)
        n_live = int(bi.numel())
        nbytes = 2 * n_live * 2 * hk * (d + 4)
        cases.append(b7_row_times(
            {"case": f"paged, run of {n}, rows at {pos}",
             **case_row([(0.0, 0.0)], times["ms"], plain_ms, 0, nbytes,
                        lib_ms)}, times))
        del cache, ref, dense
    return cases, rows


def b7_bound(lens, n_tok, h, hk, d, elt, window=-1, sinks=0, scales=None):
    """Bytes and operations B7 needs for runs of n_tok tokens at these
    lengths over a cache of ``elt``-byte values (with scales: ``scales``,
    by default for 1-byte values):
    each visible cache column once (K and V, their scales), q and out;
    q.k and p.v per (head, query token, visible column)."""
    nbytes = ops = 0
    for n in lens:
        def seen(q):  # columns the query at q sees, from lo
            lo = 0 if window < 0 else max(q - window, 0)
            return q + 1 - lo + (min(sinks, lo) if window >= 0 else 0)
        q0 = n - n_tok
        ops += sum(4 * h * d * seen(q0 + i) for i in range(n_tok))
        # the run's columns: its first token's window to its last token
        cols = seen(q0) + n_tok - 1
        quant = elt == 1 if scales is None else scales
        col_bytes = 2 * hk * d * elt + (8 * hk if quant else 0)
        nbytes += col_bytes * cols + 2 * 2 * h * n_tok * d
    return nbytes, ops


def b7_case(decode, tag, q, kc, vc, ks, vs, lens, pt, layer, **kw):
    """decode_attention through the page table against the same call on
    CPU copies of the layer (the plain version), row by row; then the
    kernel alone and its plain version timed over the run's sub-runs
    (decode_run_plan), and SDPA over the gathered, dequantized cache."""
    quant = ks is not None
    win = kw.get("window_size", (-1, -1))[0]
    sinks = kw.get("sink_tokens", 0) if win >= 0 else 0
    o, l = decode.decode_attention(q, kc, vc, lens, ks, vs, layer=layer,
                                   page_table=pt, return_lse=True, **kw)
    cpu = [None if t is None else t[layer:layer + 1].cpu()
           for t in (kc, vc, ks, vs)]
    po, pl_ = decode.decode_attention(q.cpu(), cpu[0], cpu[1], lens.cpu(),
                                      cpu[2], cpu[3], layer=0,
                                      page_table=pt.cpu(), return_lse=True,
                                      **kw)
    torch.cuda.synchronize()
    checks = [check_out(f"B7 paged out {tag}", o.cpu(), po, tol=B7_ROW_TOL)]
    check(f"B7 paged lse {tag}", max_err(l.cpu(), pl_), B7_LSE_TOL)
    multi = q.dim() == 4
    qr = q if multi else q[:, None]
    b, n_tok, h, d = qr.shape
    hk = kc.shape[2]
    scale = d ** -0.5
    # the s8 path over int8 (and int4); fp8 takes the cast path
    s8 = quant and kc.dtype in (torch.int8, torch.uint8)
    plan = decode.decode_run_plan(n_tok, hk, h // hk, d, PAGE,
                                  kc.element_size(), paged=True)
    subs = []
    for i, e, bkv in plan:
        q_in, q_rs, _ = decode.decode_query_operands(
            qr[:, i:e], kc, s8, scale=scale, block_kv=4096, paged=True)
        subs.append(((q_in, q_rs, kc, vc, ks, vs, lens - (n_tok - e)),
                     dict(block_kv=bkv, scale=scale, window_left=win,
                          sink_tokens=sinks, n_tok=e - i, page_table=pt)))
    # the pool's layers in turn
    times = kernel_timing([functools.partial(
        lambda li: [decode.decode_attention_core(*a, layer=li, **k)
                    for a, k in subs], li) for li in range(kc.shape[0])])
    plain_ms = time_ms(lambda: [decode.decode_attention_core_plain(
        *a, layer=layer, **k) for a, k in subs], iters=2, warmup=1)
    # the library's attention over the gathered, dequantized rows (the
    # stored values widened first: bf16 holds them exactly)
    from long_context_attention_tpu_torch.ops.kv_cache import _widen

    kd, vd = (gather_dense(_widen(t[layer:layer + 1]), pt)[0]
              for t in (kc, vc))
    if quant:
        kd = kd.float() * gather_dense(ks[layer:layer + 1], pt, True)[0][
            :, :, 0, :, None]
        vd = vd.float() * gather_dense(vs[layer:layer + 1], pt, True)[0][
            :, :, 0, :, None]
    n = int(lens.max())
    lib_ms = sdpa_b7_ms(qr, kd[:, :, :n].bfloat16(), vd[:, :, :n].bfloat16(),
                        lens, win, sinks)
    nbytes, ops = b7_bound(lens.tolist(), n_tok, h, hk, d,
                            kc.element_size(), win, sinks)
    return b7_row_times(
        {"case": f"paged {tag}, lengths {lens.tolist()}, sub-runs "
                 f"{[(e - i, bkv) for i, e, bkv in plan]}",
         **case_row(checks, times["ms"], plain_ms, ops, nbytes, lib_ms,
                    PEAK_INT8_OPS if s8 else PEAK_BF16_FLOPS)}, times)


def kernel_b7_paged(decode, gen, dev):
    """One-token B7 (decode_attention.cu) through the page table: one
    token per row, int8 and bf16, and window 4096 with 4 sinks over pages.
    Paging is only indexing: over the same logical cache at the same tile,
    the paged kernel equals the dense kernel bit for bit. (The runs are
    kernel_b7_runs'.)"""
    h, hk, d, layer = MODEL["n_heads"], MODEL["n_kv_heads"], 128, 1
    lens = torch.tensor(PAGED_LENS, dtype=torch.int32, device=dev)
    win = dict(window_size=(WINDOW, -1), sink_tokens=SINKS)
    cases = []
    for dtype in ("int8", "bfloat16"):
        kc, vc, ks, vs, pt = paged_pool(gen, dev, dtype, L=B7_PAGED_LAYERS)
        q = torch.randn((len(PAGED_LENS), h, d), generator=gen,
                        device=dev).bfloat16()
        cases.append(b7_case(decode, f"{dtype} n=1", q, kc, vc, ks, vs,
                             lens, pt, layer))
        if dtype == "int8":
            cases.append(b7_case(decode, "int8 n=1 window sinks", q, kc, vc,
                                 ks, vs, lens, pt, layer, **win))
            dense = [gather_dense(kc, pt), gather_dense(vc, pt),
                     gather_dense(ks, pt, True), gather_dense(vs, pt, True)]
            bit_equal(decode, "n=1", q, (kc, vc, ks, vs), dense, lens, pt,
                      layer)
            bit_equal(decode, "n=1 window sinks", q, (kc, vc, ks, vs),
                      dense, lens, pt, layer, **win)
            del dense
        del kc, vc, ks, vs
        torch.cuda.empty_cache()
    return cases


def bit_equal(decode, tag, q, pool, dense, lens, pt, layer, **kw):
    """Paged and dense B7 over the same logical cache at the same tiles
    (the dense call starts its tile rule from the page, and both rules
    pick the same tile at these shapes): equal bits."""
    po, pl_ = decode.decode_attention(q, *pool[:2], lens, *pool[2:],
                                      layer=layer, page_table=pt,
                                      return_lse=True, **kw)
    do, dl = decode.decode_attention(q, *dense[:2], lens, *dense[2:],
                                     layer=layer, block_kv=PAGE,
                                     return_lse=True, **kw)
    torch.cuda.synchronize()
    if not (torch.equal(po, do) and torch.equal(pl_, dl)):
        raise AssertionError(f"B7 {tag}: paged and dense kernels differ "
                             f"(max {max_err(po, do)})")
    emit({"phase": "check", "case": f"B7 paged = dense {tag}",
          "bit_equal": True})


# B7's runs (decode_run, csrc/decode_run_sm90.cu): the phase whose
# multi-token launches give a case its count (a case that no phase takes
# has none): serve_stall's interleaved chunks of 256, serve_prefix's suffix
# chunks of 64, serve_paged_fp8's interleaved chunks of 256
RUN_PATHS = {"int8 n=256": "serve_stall interleaved",
             "int8 n=64": "serve_prefix",
             "fp8 cast n=256": "serve_paged_fp8 interleaved"}


def b7_run_case(decode, tag, q, cache, lens, pt, layer, timed=True, **kw):
    """decode_attention over a run of tokens, dense or through the page
    table: every sub-run of the tile rule's plan on decode_run (by shape,
    decode_route, and by the launch counters), out row by row (ROW_REL_TOL)
    and lse (LSE_TOL) against the same call on CPU copies of the layer
    (the plain version, decode_attention_core_plain). ``timed``: the
    kernel alone over the sub-runs, its plain version on the card and SDPA
    over the gathered, dequantized cache, with the bound. Returns (the
    case's numbers, (out, lse) on the card)."""
    kc, vc, ks, vs = cache
    b, n_tok, h, d = q.shape
    hk, slot = kc.shape[2], kc.shape[3]
    g = h // hk
    paged = pt is not None
    quant = ks is not None
    s8 = quant and kw.get("mxu_int8", True) and kc.dtype in (torch.int8,
                                                            torch.uint8)
    plan = decode.decode_run_plan(n_tok, hk, g, d, slot, kc.element_size(),
                                  block_kv=kw.get("block_kv", 4096),
                                  paged=paged)
    routes = {decode.decode_route(g * (e - i), bkv, slot)
              for i, e, bkv in plan}
    if routes != {"decode_run"}:
        raise AssertionError(f"B7 run {tag}: sub-runs routed to {routes}")
    build = decode._build
    run_k, token_k = (build.kernel(n, d).name
                      for n in ("decode_run", "decode_attention"))
    build.reset_launch_counts()
    o, l = decode.decode_attention(q, kc, vc, lens, ks, vs, layer=layer,
                                   page_table=pt, return_lse=True, **kw)
    torch.cuda.synchronize()
    got = build.launch_counts()
    if got[run_k] != len(plan) or got[token_k] != 0:
        raise AssertionError(f"B7 run {tag}: {run_k} launched {got[run_k]} "
                             f"times, {token_k} {got[token_k]}, for "
                             f"{len(plan)} sub-runs")
    cpu = [None if t is None else t[layer:layer + 1].cpu() for t in cache]
    po, pl_ = decode.decode_attention(
        q.cpu(), cpu[0], cpu[1], lens.cpu(), cpu[2], cpu[3], layer=0,
        page_table=None if pt is None else pt.cpu(), return_lse=True, **kw)
    checks = [check_out(f"B7 run out {tag}", o.cpu(), po)]
    check(f"B7 run lse {tag}", max_err(l.cpu(), pl_), LSE_TOL)
    res = {"case": f"{'paged' if paged else 'dense'} {tag}, lengths "
                   f"{lens.tolist()}, sub-runs "
                   f"{[(e - i, bkv) for i, e, bkv in plan]}",
           "path": RUN_PATHS.get(tag), "launches": None,
           "max_abs_err": checks[0][0], "row_rel_err": checks[0][1]}
    if not timed:
        return res, (o, l)
    win = kw.get("window_size", (-1, -1))[0]
    sinks = kw.get("sink_tokens", 0) if win >= 0 else 0
    online = kw.get("safe_softmax", False) or kw.get("softcap", 0.0) > 0
    scale = d ** -0.5
    subs = []
    for i, e, bkv in plan:
        q_in, q_rs, _ = decode.decode_query_operands(
            q[:, i:e], kc, s8, scale=scale, block_kv=4096, paged=paged,
            safe_softmax=online)
        subs.append(((q_in, q_rs, kc, vc, ks, vs, lens - (n_tok - e)),
                     dict(layer=layer, block_kv=bkv, scale=scale,
                          safe_softmax=online, window_left=win,
                          sink_tokens=sinks,
                          softcap=float(kw.get("softcap", 0.0)),
                          n_tok=e - i, page_table=pt)))
    ms = time_ms(lambda: [decode.decode_attention_core(*a, **k)
                          for a, k in subs], iters=20)
    plain_ms = time_ms(lambda: [decode.decode_attention_core_plain(*a, **k)
                                for a, k in subs], iters=2, warmup=1)
    # the library's attention over the gathered, dequantized rows (the
    # stored values widened first: bf16 holds them exactly)
    from long_context_attention_tpu_torch.ops.kv_cache import _widen

    n = int(lens.max())
    if paged:
        kd, vd = (gather_dense(_widen(t[layer:layer + 1]), pt)[0]
                  for t in (kc, vc))
    else:
        kd, vd = (_widen(t[layer]) for t in (kc, vc))
    if quant:
        for t, sc in ((kd, ks), (vd, vs)):
            scd = (gather_dense(sc[layer:layer + 1], pt, True)[0] if paged
                   else sc[layer])
            t.copy_((t.float() * scd[:, :, 0, :, None]).bfloat16())
    kd, vd = kd[:, :, :n], vd[:, :, :n]
    qpos = (lens.long()[:, None] - n_tok
            + torch.arange(n_tok, device=q.device)[None])[:, :, None]
    cols = torch.arange(n, device=q.device)[None, None]
    vis = cols <= qpos
    if win >= 0:
        vis &= (cols >= qpos - win) | (cols < sinks)
    qh = q.transpose(1, 2)
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qh, kd, vd, attn_mask=vis[:, None], enable_gqa=True), iters=10)
    del kd, vd
    elt = 0.5 if kc.dtype == torch.uint8 else kc.element_size()
    nbytes, ops = b7_bound(lens.tolist(), n_tok, h, hk, d, elt, win, sinks,
                           scales=quant)
    res.update(case_row(checks, ms, plain_ms, ops, nbytes, lib_ms,
                        PEAK_INT8_OPS if s8 else PEAK_BF16_FLOPS))
    res["path"] = RUN_PATHS.get(tag)
    return res, (o, l)


def poison_check(decode, tag, q, cache, lens, pt, layer, clean, **kw):
    """The poison check of B7's runs: the pool pages that no row's table
    names (the scratch page 0 among them) and each row's columns past its
    length set to 127 (NaN for fp8) with NaN scales; decode_attention's
    out and lse must keep their bits (the walk never reads those pages, and
    a chunk's columns past a row's length reach neither the scores nor the
    PV product)."""
    kc, vc, ks, vs = (None if t is None else t.clone() for t in cache)
    vals = [t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t
            for t in (kc, vc)]
    scales = [t for t in (ks, vs) if t is not None]
    named = set(pt[pt >= 0].tolist())
    unnamed = torch.tensor([p for p in range(kc.shape[1]) if p not in named],
                           device=kc.device)
    for t in vals:
        t[layer, unnamed] = 127
    for t in scales:
        t[layer, unnamed] = math.nan
    n_cols = 0
    for r, n in enumerate(lens.tolist()):
        off = n % PAGE
        if n > 0 and off:
            p = int(pt[r, (n - 1) // PAGE])
            for t in vals:
                t[layer, p, :, off:] = 127
            for t in scales:
                t[layer, p, :, :, off:] = math.nan
            n_cols += PAGE - off
    o, l = decode.decode_attention(q, kc, vc, lens, ks, vs, layer=layer,
                                   page_table=pt, return_lse=True, **kw)
    torch.cuda.synchronize()
    same = torch.equal(o, clean[0]) and torch.equal(l, clean[1])
    emit({"phase": "check", "case": f"B7 run poison {tag}",
          "poisoned_pages": len(unnamed), "poisoned_columns": n_cols,
          "bit_equal": same})
    if not same:
        raise AssertionError(f"B7 run {tag}: poisoned pages or columns past "
                             f"the lengths changed the output")


def kernel_b7_runs(K, decode, kv_cache, gen, dev):
    """B7's runs on decode_run (csrc/decode_run_sm90.cu), through the page
    table over RUN_LENS's pool: int8 runs of 256 (two sub-runs, an
    interleaved-admission chunk) and 64 (the prefix cache's suffix chunk),
    timed, paged against dense bit for bit and with the poison check; the
    run of 256 in the online form, with window 4096 and 4 sinks, with the
    softcap 50 (online), with ALiBi and on the cast path; the route's
    edges, G = 10, 64, 66 and 130 rows per kv head (runs of 5, 32, 33 and
    65); a row whose length is its run; kv_splits=4 on the dense cache;
    then runs of 256 over bf16, fp8 (cast), int4 (s8 and cast) pools,
    timed, bf16 and fp8 with the poison check. Each against the plain
    version; the kernel's row takes the int8 run of 256's numbers."""
    h, hk, d, layer = MODEL["n_heads"], MODEL["n_kv_heads"], 128, 1
    g = h // hk
    win = dict(window_size=(WINDOW, -1), sink_tokens=SINKS)
    rl = torch.tensor(RUN_LENS, dtype=torch.int32, device=dev)

    def randq(n):
        return torch.randn((len(RUN_LENS), n, h, d), generator=gen,
                           device=dev).bfloat16()

    cases = []
    kc, vc, ks, vs, pt = paged_pool(gen, dev, "int8", lens=RUN_LENS,
                                    n_pages=RUN_PAGES)
    pool = (kc, vc, ks, vs)
    dense = [gather_dense(kc, pt), gather_dense(vc, pt),
             gather_dense(ks, pt, True), gather_dense(vs, pt, True)]
    q256 = randq(256)
    for n in (256, 64):
        q = q256 if n == 256 else randq(n)
        res, out = b7_run_case(decode, f"int8 n={n}", q, pool, rl, pt, layer)
        cases.append(res)
        bit_equal(decode, f"n={n}", q, pool, dense, rl, pt, layer)
        poison_check(decode, f"int8 n={n}", q, pool, rl, pt, layer, out)
    for tag, kw in (("safe", dict(safe_softmax=True)),
                    ("window sinks", win),
                    ("window sinks softcap", dict(win, softcap=SOFTCAP)),
                    ("ALiBi", dict(alibi_slopes=alibi_slopes(h, dev))),
                    ("cast", dict(mxu_int8=False))):
        cases.append(b7_run_case(decode, f"int8 n=256 {tag}", q256, pool,
                                 rl, pt, layer, timed=False, **kw)[0])
    for n in (5, 32, 33, 65):  # G = g * n rows per kv head
        cases.append(b7_run_case(decode, f"int8 n={n} G={g * n}", randq(n),
                                 pool, rl, pt, layer, timed=False)[0])
    whole = torch.tensor((RUN_LENS[0], 64), dtype=torch.int32, device=dev)
    cases.append(b7_run_case(decode, "int8 n=64, a row of 64", randq(64),
                             pool, whole, pt, layer, timed=False)[0])
    cases.append(b7_run_case(decode, "int8 n=256 kv_splits=4", q256, dense,
                             rl, None, layer, timed=False, block_kv=PAGE,
                             kv_splits=4)[0])
    del kc, vc, ks, vs, pool, dense
    torch.cuda.empty_cache()
    for dtype, tags in (("bfloat16", (("bf16", {}),)),
                        ("float8_e4m3fn", (("fp8 cast", {}),)),
                        ("int4", (("int4 s8", {}),
                                  ("int4 cast", dict(mxu_int8=False))))):
        kc, vc, ks, vs, pt = paged_pool(gen, dev, "bfloat16", lens=RUN_LENS,
                                        n_pages=RUN_PAGES)
        if dtype != "bfloat16":
            (kc, ks), (vc, vs) = (kv_cache.quantize_kv(t, dtype)
                                  for t in (kc, vc))
            ks, vs = ks[..., None, :], vs[..., None, :]
        pool = (kc, vc, ks, vs)
        for tag, kw in tags:
            res, out = b7_run_case(decode, f"{tag} n=256", q256, pool, rl,
                                   pt, layer, **kw)
            cases.append(res)
            if dtype != "int4":
                poison_check(decode, tag, q256, pool, rl, pt, layer, out, **kw)
        del kc, vc, ks, vs, pool
        torch.cuda.empty_cache()
    main = cases[0]  # int8, run of 256
    return {"name": "decode_run", "route": "cuda",
            "source": ("long_context_attention_tpu_torch/csrc/"
                       f"{K['decode_run'].source}"),
            "replaces": K["decode_run"].replaces, "launches": None,
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "row_rel_err": max(c["row_rel_err"] for c in cases),
            **{k: main[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                    "library_ms")},
            "case": main["case"], "run_cases": cases}


# ---------------------------------------------------------------------------
# head dim 64: B1, B3, B6 and both B7 kernels at TinyLlama's shapes
# ---------------------------------------------------------------------------

# the phase whose counters give each d = 64 case its launches (None: a form
# no phase of this run takes)
HD_B3_PATHS = {"int8": "slice_hd64", "float8_e4m3fn": "slice_hd64 fp8",
               "int4": "slice_hd64 int4"}
HD_B6_PATHS = {("bfloat16", False, 1): "slice_hd64 generate",
               ("int8", False, 1): "slice_hd64",
               ("int8", False, 2048): "slice_hd64",
               ("float8_e4m3fn", False, 2048): "slice_hd64 fp8",
               ("int4", False, 2048): "slice_hd64 int4",
               ("int8", True, 1): "serve_paged_hd64",
               ("float8_e4m3fn", True, 1): "serve_paged_hd64 fp8",
               ("int4", True, 1): "serve_paged_hd64 int4",
               ("int8", True, 256): "serve_paged_hd64",
               ("float8_e4m3fn", True, 256): "serve_paged_hd64 fp8",
               ("int4", True, 256): "serve_paged_hd64 int4"}
HD_B7_PATHS = {"bf16": "slice_hd64 generate",
               "int8 s8": "slice_hd64", "fp8 cast": "slice_hd64 fp8",
               "int4 s8": "slice_hd64 int4", "paged int8 s8":
               "serve_paged_hd64", "paged fp8 cast": "serve_paged_hd64 fp8",
               "paged int4 s8": "serve_paged_hd64 int4"}
HD_RUN_PATHS = {"int8 n=256": "serve_paged_hd64",
                "fp8 cast n=256": "serve_paged_hd64 fp8",
                "int4 s8 n=256": "serve_paged_hd64 int4"}


def kernel_hd64(K, flash, decode, kv_cache, gen, dev):
    """The d = 64 kernels (their own libraries, -DLCA_HEAD_DIM=64) at
    TinyLlama-1.1B's attention widths (32 heads, 4 kv heads of 64: G = 8),
    each against its plain version on the card at its row's tolerance and
    timed: B1 at the chunk's shape (b=4, s=2048) and ragged lengths, fast
    and online; B3 over a bf16, int8, fp8 and int4 prefix of 6144 at the
    next chunk's 2048 rows, fast, with a window of 4096 and 4 sinks (band
    check), and online and softcap where the edges cut tiles; B6 in every
    kind, dense and paged, n = 1, 256 and 2048, bit for bit; one-token B7
    in every kind, dense and paged (the cast path too, window and sinks);
    B7's runs of 256 (three sub-runs of the tile rule) over int8, bf16,
    fp8 and int4 pools, with the poison check, window and sinks and the
    online form. Returns {d = 128 row name: [cases]}."""
    cfg = TINYLLAMA
    h, hk, d = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    b, scale = BATCH, d ** -0.5
    out = {n: [] for n in decode._build.HEAD_DIM_64}

    def qkv(bb, ss):
        return [torch.randn(shape, generator=gen, device=dev).bfloat16()
                for shape in ((bb, ss, h, d), (bb, ss, hk, d),
                              (bb, ss, hk, d))]

    # B1
    checks = []
    for bb, ss in ((b, CHUNK), (1, 1000), (1, 64)):
        q, k, v = qkv(bb, ss)
        for safe in (False, True):
            o, l = flash.flash_fwd_causal_self(q, k, v, scale=scale,
                                               safe_softmax=safe)
            po, pl_ = flash.flash_fwd_causal_self_plain(
                q, k, v, scale=scale, safe_softmax=safe)
            torch.cuda.synchronize()
            checks.append(check_out(f"B1 d=64 out b={bb} s={ss} safe={safe}",
                                    o, po))
            check(f"B1 d=64 lse b={bb} s={ss} safe={safe}", max_err(l, pl_),
                  LSE_TOL)
        if bb == b:
            qb, kb, vb = q, k, v
    ms = time_ms(lambda: flash.flash_fwd_causal_self(qb, kb, vb,
                                                     scale=scale))
    plain_ms = time_ms(lambda: flash.flash_fwd_causal_self_plain(
        qb, kb, vb, scale=scale), iters=3, warmup=1)
    qh, kh, vh = (t.transpose(1, 2) for t in (qb, kb, vb))
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qh, kh, vh, is_causal=True, enable_gqa=True))
    out["flash_fwd_causal_self"].append({
        "case": f"d=64 b={b} s={CHUNK} (and ragged 1000, 64), h={h} h_kv={hk}",
        "kernel": K["flash_fwd_causal_self_d64"].name, "path": "slice_hd64",
        **case_row(checks, ms, plain_ms, 2 * b * h * CHUNK * CHUNK * d,
                   2 * (2 * qb.numel() + kb.numel() + vb.numel())
                   + 4 * b * h * CHUNK, lib_ms)})
    del qb, kb, vb, qh, kh, vh
    # B3: the next chunk's rows against the cache's prefix, each kind
    s_q, start = CHUNK, PROMPT - CHUNK
    q = torch.randn((b, s_q, h, d), generator=gen, device=dev).bfloat16()
    qh = q.transpose(1, 2)
    win = dict(window_size=(WINDOW, -1), sink_tokens=SINKS)
    for dtype in ("bfloat16", "int8", "float8_e4m3fn", "int4"):
        kc, kst = quant_values(kv_cache, (b, hk, start, d), dtype, gen, dev)
        vc, vst = quant_values(kv_cache, (b, hk, start, d), dtype, gen, dev)
        args = (kc, vc, kst, vst)
        kd, vd = ((t if sc is None else kv_cache.dequantize_kv(t, sc))
                  for t, sc in ((kc, kst), (vc, vst)))
        for wtag, wkw in (("dense", {}), ("window sinks", win)):
            o, l = flash.flash_fwd_pos(q, *args, q_start=start, causal=True,
                                       scale=scale, **wkw)
            po, pl_ = flash.flash_fwd_pos_plain(q, *args, q_start=start,
                                                causal=True, scale=scale,
                                                **wkw)
            torch.cuda.synchronize()
            checks = [check_out(f"B3 d=64 out {dtype} {wtag}", o, po)]
            check(f"B3 d=64 lse {dtype} {wtag}", max_err(l, pl_), LSE_TOL)
            del po, pl_
            vis = visible(s_q, start, start, True,
                          **(dict(left=WINDOW, sink=SINKS) if wkw else {}),
                          dev=dev)
            if wkw and dtype != "bfloat16":  # NaN scales outside the walk
                tiles = unseen_tiles(vis, B3_KV_TILE)
                ksp, vsp = (poison(t, 2, tiles, B3_KV_TILE)
                            for t in (kst, vst))
                got, _ = flash.flash_fwd_pos(q, kc, vc, ksp, vsp,
                                             q_start=start, causal=True,
                                             scale=scale, **wkw)
                torch.cuda.synchronize()
                band_check(f"B3 d=64 {dtype}", got, o, len(tiles))
                del ksp, vsp, got
            # the online and softcap forms where lengths, the window edge
            # and the sink edge cut tiles (300 rows at 1037 over 1337)
            if not wkw:
                small = tuple(t[:, :, :1337] for t in args if t is not None)
                if dtype == "bfloat16":
                    small = small + (None, None)
                for ftag, fkw in (("safe", dict(safe_softmax=True)),
                                  ("softcap", dict(softcap=SOFTCAP))):
                    kw = dict(fkw, q_start=1037, causal=True, scale=scale,
                              window_size=(500, -1), sink_tokens=70)
                    qs_ = q[:, :300].contiguous()
                    o2, l2 = flash.flash_fwd_pos(qs_, *small, **kw)
                    po2, pl2 = flash.flash_fwd_pos_plain(qs_, *small, **kw)
                    torch.cuda.synchronize()
                    checks.append(check_out(
                        f"B3 d=64 out {dtype} {ftag} window 500 sinks 70",
                        o2, po2))
                    check(f"B3 d=64 lse {dtype} {ftag}", max_err(l2, pl2),
                          LSE_TOL)
            ms = time_ms(lambda: flash.flash_fwd_pos(
                q, *args, q_start=start, causal=True, scale=scale, **wkw))
            plain_ms = time_ms(lambda: flash.flash_fwd_pos_plain(
                q, *args, q_start=start, causal=True, scale=scale, **wkw),
                iters=2, warmup=1)
            lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
                qh, kd, vd, attn_mask=vis if wkw else None, enable_gqa=True))
            cols = int(vis.any(0).sum())
            quant = dtype != "bfloat16"
            nbytes = int(2 * 2 * q.numel() + 4 * b * h * s_q + 2 * b * hk
                         * cols * (d * CACHE_ELT[dtype] + 4 * quant))
            out["flash_fwd_pos"].append({
                "case": f"d=64 {dtype} prefix {start}, {s_q} rows, {wtag}"
                        + ("" if wkw else "; safe and softcap at 300 rows "
                           "over 1337"),
                "kernel": K["flash_fwd_pos_d64"].name,
                "path": None if wkw else HD_B3_PATHS.get(dtype),
                **case_row(checks, ms, plain_ms,
                           4 * b * h * d * int(vis.sum()), nbytes, lib_ms)})
            del vis
        del kc, vc, kst, vst, kd, vd, args
        torch.cuda.empty_cache()
    del q, qh
    # B6: every kind, dense and paged, a decode token, a chunk's run and an
    # admission's chunk
    for dtype in ("bfloat16", "int8", "float8_e4m3fn", "int4"):
        for paged in (False, True):
            for n in (1, 256, 2048):
                out["cache_append"].append(b6_rows_case(
                    decode, kv_cache, dtype, paged, n, gen, dev, hk=hk, d=d,
                    paths=HD_B6_PATHS))
    # one-token B7 at G = 8 over the slice's cache (dense, a layer of
    # B7_PAGED_LAYERS timed in turn) and the paged pool
    lens = torch.tensor([PROMPT + 1, PROMPT - 42, PROMPT + NEW, PROMPT - 193],
                        dtype=torch.int32, device=dev)
    qt = torch.randn((b, h, d), generator=gen, device=dev).bfloat16()
    L = B7_PAGED_LAYERS
    for dtype, tags in (("bfloat16", (("bf16", {}),)),
                        ("int8", (("int8 s8", {}),
                                  ("int8 cast", dict(mxu_int8=False)))),
                        ("float8_e4m3fn", (("fp8 cast", {}),)),
                        ("int4", (("int4 s8", {}),))):
        kc, ks = quant_values(kv_cache, (L, b, hk, S_MAX, d), dtype, gen, dev)
        vc, vs = quant_values(kv_cache, (L, b, hk, S_MAX, d), dtype, gen, dev)
        if ks is not None:
            ks, vs = ks[..., None, :], vs[..., None, :]
        for tag, kw in tags:
            out["decode_attention"].append(
                {**b7_dense_case(decode, kv_cache, f"d=64 {tag}", qt, kc, vc,
                                 ks, vs, lens, 1, **kw),
                 "kernel": K["decode_attention_d64"].name,
                 "path": HD_B7_PATHS.get(tag)})
        del kc, vc, ks, vs
        torch.cuda.empty_cache()
    lt = torch.tensor(PAGED_LENS, dtype=torch.int32, device=dev)
    qp = torch.randn((len(PAGED_LENS), h, d), generator=gen,
                     device=dev).bfloat16()
    for dtype, tag, kw in (("bfloat16", "bf16", {}), ("int8", "int8 s8", {}),
                           ("int8", "int8 s8 window sinks", win),
                           ("float8_e4m3fn", "fp8 cast", {}),
                           ("int4", "int4 s8", {})):
        kc, vc, ks, vs, pt = paged_pool(gen, dev, "bfloat16", L=L, hk=hk,
                                        d=d)
        if dtype != "bfloat16":
            (kc, ks), (vc, vs) = (kv_cache.quantize_kv(t, dtype)
                                  for t in (kc, vc))
            ks, vs = ks[..., None, :], vs[..., None, :]
        out["decode_attention"].append(
            {**b7_case(decode, f"d=64 {tag}", qp, kc, vc, ks, vs, lt, pt, 1,
                       **kw),
             "kernel": K["decode_attention_d64"].name,
             "path": HD_B7_PATHS.get(f"paged {tag}")})
        del kc, vc, ks, vs, pt
        torch.cuda.empty_cache()
    # B7's runs: a chunk of 256 over RUN_LENS's pool in every kind
    rl = torch.tensor(RUN_LENS, dtype=torch.int32, device=dev)
    q256 = torch.randn((len(RUN_LENS), 256, h, d), generator=gen,
                       device=dev).bfloat16()
    for dtype, tags in (("int8", (("int8", {}), ("int8 safe",
                                                 dict(safe_softmax=True)),
                                  ("int8 window sinks", win),
                                  ("int8 cast", dict(mxu_int8=False)))),
                        ("bfloat16", (("bf16", {}),)),
                        ("float8_e4m3fn", (("fp8 cast", {}),)),
                        ("int4", (("int4 s8", {}),))):
        kc, vc, ks, vs, pt = paged_pool(gen, dev, "bfloat16", lens=RUN_LENS,
                                        n_pages=RUN_PAGES, hk=hk, d=d)
        if dtype != "bfloat16":
            (kc, ks), (vc, vs) = (kv_cache.quantize_kv(t, dtype)
                                  for t in (kc, vc))
            ks, vs = ks[..., None, :], vs[..., None, :]
        pool = (kc, vc, ks, vs)
        for tag, kw in tags:
            timed = tag in ("int8", "bf16", "fp8 cast", "int4 s8")
            res, o = b7_run_case(decode, f"{tag} n=256", q256, pool, rl, pt,
                                 1, timed=timed, **kw)
            res.update(kernel=K["decode_run_d64"].name,
                       path=HD_RUN_PATHS.get(f"{tag} n=256"))
            out["decode_run"].append(res)
            if timed and dtype != "int4":
                poison_check(decode, f"d=64 {tag}", q256, pool, rl, pt, 1, o,
                             **kw)
        del kc, vc, ks, vs, pool, pt
        torch.cuda.empty_cache()
    return out


# the d = 64 kernel rows' main paths, in order: a row's launches are its
# kernel's on the first of them that runs it
HD_MAIN_PATHS = ("slice_hd64", "serve_paged_hd64", "train_hd64",
                 "train_usp_hd64")
# head dim 64 in training (train_hd64): remat policies and timed steps
HD_TRAIN_STEPS = (("none", 3), ("attn", 2))


def kernel_hd64_train(K, flash, ring, gen, dev):
    """The d = 64 training kernels at TinyLlama-1.1B's attention widths
    (b=1, s=8192, 32 / 4 heads of 64), each against its plain version on
    the card at its d = 128 row's gate (ROW_REL_TOL) and timed beside its
    bound and SDPA's: B5 causal (train_hd64's call), with SDPA's flash
    backward; B3, B2a and B2b at the two-chunk descriptor of a one-rank
    zigzag ring (train_usp_hd64's calls), B3 beside SDPA's causal forward
    (the same function over the permuted sequence); B5 with window 4096 + 4
    sinks, a non-causal two-sided window and softcap 50, B2a + B2b with
    the windowed offsets and window + sinks + softcap from kv offset s/2
    (kernel_bwd_masked, with its band checks); B3, B2a and B2b at the W = 4
    ring's descriptors (kernel_ring, with ring_forms' softcap and online
    forms) and with segments, ALiBi and dropout together at one chunk and
    the ring's zigzag and stripe steps (kernel_features). Returns {d = 128
    row name: [cases]}."""
    cfg = TINYLLAMA
    b, s, h, hk = 1, TRAIN_SEQ, cfg["n_heads"], cfg["n_kv_heads"]
    d = cfg["head_dim"]
    scale = d ** -0.5
    out = {n: [] for n in ("flash_fwd_pos", "flash_bwd_dq", "flash_bwd_dkv",
                           "flash_bwd_fused")}
    tags = {"B3": "flash_fwd_pos", "B2a": "flash_bwd_dq",
            "B2b": "flash_bwd_dkv", "B5": "flash_bwd_fused"}
    q, dout = (torch.randn((b, s, h, d), generator=gen, device=dev)
               .bfloat16() for _ in range(2))
    k, v = (torch.randn((b, s, hk, d), generator=gen, device=dev).bfloat16()
            for _ in range(2))
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)
    lib_bwd = sdpa_backward_ms(q, k, v, dout)
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    lib_fwd = time_ms(lambda: F.scaled_dot_product_attention(
        qh, kh, vh, is_causal=True, enable_gqa=True))
    del qh, kh, vh
    live = b * h * s * (s + 1) // 2
    in_bytes = 2 * (2 * q.numel() + 2 * k.numel()) + 8 * b * h * s
    work = {"B3": (4, 2 * (2 * q.numel() + 2 * k.numel()) + 4 * b * h * s),
            "B2a": (6, in_bytes + 4 * q.numel()),
            "B2b": (8, in_bytes + 8 * k.numel()),
            "B5": (10, in_bytes + 4 * q.numel() + 8 * k.numel())}
    library = {"B3": "SDPA causal forward, GQA",
               **dict.fromkeys(("B2a", "B2b", "B5"),
                               "SDPA flash backward (dq, dk, dv), K/V "
                               "repeated to the query heads")}

    def add(n, tag, checks, fn, plain, path):
        ms = time_ms(fn)
        pms = time_ms(plain, iters=1, warmup=0)
        torch.cuda.empty_cache()
        out[tags[n]].append({
            "case": f"d=64 b={b} s={s} h={h}/{hk} {tag}",
            "kernel": K[f"{tags[n]}_d64"].name, "path": path,
            "library": library[n],
            **case_row(checks, ms, pms, work[n][0] * d * live, work[n][1],
                       lib_fwd if n == "B3" else lib_bwd)})

    def delta_of(o):
        return (dout.float() * o.float()).sum(-1).transpose(1, 2).contiguous()

    # B5: causal self-attention on B1's out and lse, train_hd64's call
    o, lse = flash.flash_fwd_causal_self(q, k, v, scale=scale)
    args = (q, k, v, dout, lse, delta_of(o))
    del o
    kw = dict(scale=scale, causal=True)
    got = flash.flash_bwd_fused(*args, **kw)
    want = flash.flash_bwd_fused_plain(*args, **kw)
    torch.cuda.synchronize()
    checks = [check_out(f"B5 d=64 {g} causal", a, w, 0 if g == "dq" else None)
              for g, a, w in zip(("dq", "dk", "dv"), got, want)]
    del got, want
    add("B5", "causal", checks, lambda: flash.flash_bwd_fused(*args, **kw),
        lambda: flash.flash_bwd_fused_plain(*args, **kw), "train_hd64")
    del args
    # B3, B2a and B2b at a one-rank zigzag ring's descriptor (its two
    # chunks at 0 and s / 2), train_usp_hd64's calls
    fw = dict(pos=flash.Positions((0, s // 2), (0, s // 2)), causal=True,
              scale=scale)
    o, lse = flash.flash_fwd_pos(q, kt, vt, **fw)
    po, pl_ = flash.flash_fwd_pos_plain(q, kt, vt, **fw)
    torch.cuda.synchronize()
    c3 = [check_out("B3 d=64 out zigzag one-rank", o, po)]
    check("B3 d=64 lse zigzag one-rank", max_err(lse, pl_), LSE_TOL)
    del po, pl_
    add("B3", "zigzag one-rank ring", c3,
        lambda: flash.flash_fwd_pos(q, kt, vt, **fw),
        lambda: flash.flash_fwd_pos_plain(q, kt, vt, **fw), "train_usp_hd64")
    args = (q, k, v, dout, lse, delta_of(o))
    del o
    dq = flash.flash_bwd_dq(*args, **fw)
    pdq = flash.flash_bwd_dq_plain(*args, **fw)
    torch.cuda.synchronize()
    c2a = [check_out("B2a d=64 dq zigzag one-rank", dq, pdq, 0)]
    del dq, pdq
    dk, dv = flash.flash_bwd_dkv(*args, **fw)
    pdk, pdv = flash.flash_bwd_dkv_plain(*args, **fw)
    torch.cuda.synchronize()
    c2b = [check_out("B2b d=64 dk zigzag one-rank", dk, pdk),
           check_out("B2b d=64 dv zigzag one-rank", dv, pdv)]
    del dk, dv, pdk, pdv
    add("B2a", "zigzag one-rank ring", c2a,
        lambda: flash.flash_bwd_dq(*args, **fw),
        lambda: flash.flash_bwd_dq_plain(*args, **fw), "train_usp_hd64")
    add("B2b", "zigzag one-rank ring", c2b,
        lambda: flash.flash_bwd_dkv(*args, **fw),
        lambda: flash.flash_bwd_dkv_plain(*args, **fw), "train_usp_hd64")
    del args
    torch.cuda.empty_cache()
    # the masks with their band checks, the ring's descriptors, the
    # features (their launches: usp_varlen_hd64's)
    masked = kernel_bwd_masked(flash, dev, q, k, v, dout, scale)
    del q, k, v, dout, kt, vt
    torch.cuda.empty_cache()
    groups = [(masked, "", None)]
    groups.append((kernel_ring(K, flash, None, ring, gen, dev, model=cfg),
                   "ring ", None))
    torch.cuda.empty_cache()
    groups.append((kernel_features(K, flash, ring, gen, dev, model=cfg),
                   "features ", "usp_varlen_hd64"))
    torch.cuda.empty_cache()
    for rows, prefix, path in groups:
        for n, cases in rows.items():
            out[tags[n]] += [{**c, "case": f"d=64 {prefix}{c['case']}",
                              "kernel": K[f"{tags[n]}_d64"].name,
                              "path": path} for c in cases]
    return out


# ---------------------------------------------------------------------------
# the fp8 and int4 caches: B6, B7 and B3 over fp8 and packed int4 values
# ---------------------------------------------------------------------------

QUANT_DTYPES = ("float8_e4m3fn", "int4")
# the phases whose counters give the fp8 and int4 kernel cases their
# launches (a case's "path"; a form that no phase takes has None and no
# count): the slices over each cache, and serve_paged_fp8's one-token
# run and its interleaved run of 256-token chunks
QUANT_SLICE = {"float8_e4m3fn": "slice_fp8", "int4": "slice_int4"}
FP8_RUNS = {1: "serve_paged_fp8", 256: "serve_paged_fp8 interleaved"}
# bytes a cache element takes, by cache dtype
CACHE_ELT = {"bfloat16": 2, "int8": 1, "float8_e4m3fn": 1, "int4": 0.5}


def quant_values(kv_cache, shape, dtype, gen, dev):
    """Cache values of ``shape`` (..., d) quantized to ``dtype`` from random
    normal K/V, as a cache stores them: (storage, fp32 scales (...))."""
    return kv_cache.quantize_kv(torch.randn(shape, generator=gen,
                                            device=dev), dtype)


def b6_quant_case(decode, kv_cache, tag, dtype, gen, dev, paged, path):
    """B6 over an fp8 or int4 cache, dense (one token per row of the
    slice's layered cache: rows at the prompt's end, -1, the last slot and
    100) or through the page table (a 256-token run straddling a page):
    the kernel's cache bit-equal to the plain version's, the skipped row
    untouched, with times. `path`: the phase whose counters give the
    case its launches (QUANT_SLICE, FP8_RUNS), or None."""
    L, hk, d = MODEL["n_layers"], MODEL["n_kv_heads"], 128
    layer = L - 1 if not paged else 1
    if paged:
        L = 2
        n, pos = 256, [3 * PAGE - 100, -256, PAGED_LENS[2] - 256, 0]
        kc, ks = quant_values(kv_cache, (L, POOL, hk, PAGE, d), dtype, gen,
                              dev)
        vc, vs = quant_values(kv_cache, (L, POOL, hk, PAGE, d), dtype, gen,
                              dev)
        ks, vs = ks[..., None, :], vs[..., None, :]
        pt = torch.full((len(pos), PAGED_S_MAX // PAGE), -1,
                        dtype=torch.int32)
        free = list(range(1, POOL))
        for r, p0 in enumerate(pos):
            for i in range(max(p0 + n, 1) // PAGE + 1):
                pt[r, i] = free.pop()
        pt, cap, slot_dim = pt.to(dev), PAGED_S_MAX, PAGE
    else:
        n, pos = 1, [PROMPT, -1, S_MAX - 1, 100]
        kc, ks = quant_values(kv_cache, (L, BATCH, hk, S_MAX, d), dtype, gen,
                              dev)
        vc, vs = quant_values(kv_cache, (L, BATCH, hk, S_MAX, d), dtype, gen,
                              dev)
        ks, vs = ks[..., None, :], vs[..., None, :]
        pt, cap, slot_dim = None, S_MAX, S_MAX
    b = len(pos)
    kn, ksn = quant_values(kv_cache, (b, hk, n, d), dtype, gen, dev)
    vn, vsn = quant_values(kv_cache, (b, hk, n, d), dtype, gen, dev)
    pos_t = torch.tensor(pos, dtype=torch.int32, device=dev)
    cache = [kc, vc, ks, vs]
    ref = [t.clone() for t in cache]
    before = [t.clone() for t in cache]
    decode.cache_append(*cache[:2], kn, vn, pos_t, *cache[2:], ksn, vsn,
                        layer=layer, page_table=pt)
    decode.cache_append_plain(*ref[:2], kn, vn, pos_t, *ref[2:], ksn, vsn,
                              layer=layer, page_table=pt)
    torch.cuda.synchronize()

    def same(a, r):
        if a.dtype == torch.float8_e4m3fn:
            a, r = a.view(torch.uint8), r.view(torch.uint8)
        return torch.equal(a, r)

    if not all(same(a, r) for a, r in zip(cache, ref)):
        raise AssertionError(f"B6 {tag}: kernel and plain caches differ")
    if not paged and not same(kc[layer, 1], before[0][layer, 1]):
        raise AssertionError(f"B6 {tag}: the row at position -1 was written")
    if sum(not same(a, r) for a, r in zip(cache, before)) != 4:
        raise AssertionError(f"B6 {tag}: a live token was not written")
    emit({"phase": "check", "case": f"B6 {tag}", "bit_equal": True})
    ms = time_ms(lambda: decode.cache_append(
        *cache[:2], kn, vn, pos_t, *cache[2:], ksn, vsn, layer=layer,
        page_table=pt), iters=50)
    plain_ms = time_ms(lambda: decode.cache_append_plain(
        *ref[:2], kn, vn, pos_t, *ref[2:], ksn, vsn, layer=layer,
        page_table=pt), iters=10)
    slots = pos_t.long()[:, None] + torch.arange(n, device=dev)[None]
    bi, ti = ((slots >= 0) & (slots < cap)).nonzero(as_tuple=True)
    si = slots[bi, ti]
    pg, off = ((pt.long()[bi, si // slot_dim], si % slot_dim) if paged
               else (bi, si))
    # the library's indexed copy of the same rows (as bytes: torch's
    # index_put takes no fp8)
    kb, vb, knb, vnb = (t.view(torch.uint8) for t in (kc, vc, kn, vn))

    def indexed_copy():
        kb[layer, pg, :, off] = knb[bi, :, ti]
        vb[layer, pg, :, off] = vnb[bi, :, ti]
        ks[layer, pg, :, 0, off] = ksn[bi, :, ti]
        vs[layer, pg, :, 0, off] = vsn[bi, :, ti]

    lib_ms = time_ms(indexed_copy, iters=10)
    n_live = int(bi.numel())
    nbytes = 2 * n_live * 2 * hk * (d * CACHE_ELT[dtype] + 4)
    return {"case": f"{tag}: {'paged, run of 256' if paged else 'dense, '
                    'one token'} per row at {pos}", "path": path,
            **case_row([(0.0, 0.0)], ms, plain_ms, 0, nbytes, lib_ms)}


def b7_dense_case(decode, kv_cache, tag, q, kc, vc, ks, vs, lens, layer,
                  **kw):
    """decode_attention on the card against the same call on CPU copies of
    the layer (the plain version), row by row; the kernel alone (the core
    wrapper on the operands decode_attention makes) and its plain version
    timed; SDPA over the dequantized cache (with ALiBi's bias) as the
    library's yardstick."""
    o, l = decode.decode_attention(q, kc, vc, lens, ks, vs, layer=layer,
                                   return_lse=True, **kw)
    cpu = [None if t is None else t[layer:layer + 1].cpu()
           for t in (kc, vc, ks, vs)]
    po, pl_ = decode.decode_attention(q.cpu(), cpu[0], cpu[1], lens.cpu(),
                                      cpu[2], cpu[3], layer=0,
                                      return_lse=True, **kw)
    torch.cuda.synchronize()
    checks = [check_out(f"B7 out {tag}", o.cpu(), po, tol=B7_ROW_TOL)]
    check(f"B7 lse {tag}", max_err(l.cpu(), pl_), B7_LSE_TOL)
    b, h, d = q.shape
    hk = kc.shape[2]
    g = h // hk
    scale = d ** -0.5
    s8 = kw.get("mxu_int8", True) and kc.dtype in (torch.int8, torch.uint8)
    q_in, q_rs, bkv = decode.decode_query_operands(q, kc, s8, scale=scale,
                                                   block_kv=4096)
    slopes = kw.get("alibi_slopes")
    # the row slopes decode_attention hands the kernel (times log2e in the
    # fast form)
    rows = (None if slopes is None else
            (slopes * math.log2(math.e)).reshape(hk, g))
    ckw = dict(block_kv=bkv, scale=scale, alibi=rows,
               kv_splits=kw.get("kv_splits"))
    args = (q_in, q_rs, kc, vc, ks, vs, lens)
    times = kernel_timing(b7_layer_calls(decode, args, kc.shape[0], **ckw))
    plain_ms = time_ms(lambda: decode.decode_attention_core_plain(
        *args, layer=layer, **ckw), iters=3, warmup=1)
    n = int(lens.max())
    kd, vd = ((t[layer, :, :, :n] if sc is None else kv_cache.dequantize_kv(
        t[layer, :, :, :n], sc[layer, :, :, 0, :n])).repeat_interleave(g, 1)
              for t, sc in ((kc, ks), (vc, vs)))
    cols = torch.arange(n, device=q.device)
    last = lens.long()[:, None] - 1
    mask = torch.where(cols[None] <= last, 0.0, -math.inf)[:, None, None]
    if slopes is not None:
        mask = mask - (slopes[None, :, None, None]
                       * (last[:, None, None] - cols).float())
    mask = mask.expand(b, h, 1, n).to(torch.bfloat16)
    qh = q[:, :, None, :]
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qh, kd, vd, attn_mask=mask), iters=20)
    live = int(lens.sum())
    elt = 0.5 if kc.dtype == torch.uint8 else kc.element_size()
    nbytes = int(2 * hk * live * d * elt + 8 * hk * live * (ks is not None)
                 + b * h * d * 2 * 2)
    del kd, vd, mask
    return b7_row_times(
        {"case": f"{tag}, lengths {lens.tolist()}",
         **case_row(checks, times["ms"], plain_ms, 4 * h * live * d, nbytes,
                    lib_ms, PEAK_INT8_OPS if s8 else PEAK_BF16_FLOPS)},
        times)



def kernel_b7_quant(decode, kv_cache, gen, dev):
    """B7 at the slice's decode shape (b=4, a cache of S_MAX slots, ~8.2K
    live): fp8 on the cast path, int8 on the cast path (mxu_int8=False),
    int4 on the s8 path and on the cast path, int8 with ALiBi (the
    geometric slopes of BLOOM and MPT) and int8 with kv_splits=4; then
    paged fp8 through the page table, one token per row (the fp8 runs are
    kernel_b7_runs')."""
    L, b, hk, d = MODEL["n_layers"], BATCH, MODEL["n_kv_heads"], 128
    h = MODEL["n_heads"]
    lens = torch.tensor([PROMPT + 1, PROMPT - 42, PROMPT + NEW, PROMPT - 193],
                        dtype=torch.int32, device=dev)
    layer = L // 3
    cases = []
    # (tag, kwargs, the phase whose counters give its launches or None)
    for dtype, tag_kw in (
            ("float8_e4m3fn", (("fp8 cast", {}, "slice_fp8"),)),
            ("int8", (("int8 cast", dict(mxu_int8=False), None),
                      ("int8 ALiBi", dict(alibi_slopes=alibi_slopes(h, dev)),
                       None),
                      ("int8 kv_splits=4", dict(kv_splits=4), None))),
            ("int4", (("int4 s8", {}, "slice_int4"),
                      ("int4 cast", dict(mxu_int8=False), None)))):
        kc, ks = quant_values(kv_cache, (L, b, hk, S_MAX, d), dtype, gen, dev)
        vc, vs = quant_values(kv_cache, (L, b, hk, S_MAX, d), dtype, gen, dev)
        ks, vs = ks[..., None, :], vs[..., None, :]
        q = torch.randn((b, h, d), generator=gen, device=dev).bfloat16()
        for tag, kw, path in tag_kw:
            cases.append({**b7_dense_case(decode, kv_cache, tag, q, kc, vc,
                                          ks, vs, lens, layer, **kw),
                          "path": path})
        del kc, vc, ks, vs
        torch.cuda.empty_cache()
    # paged fp8, one token per row over PAGED_LENS (its runs are
    # kernel_b7_runs')
    kc, vc, ks, vs, pt = paged_pool(gen, dev, "bfloat16", L=B7_PAGED_LAYERS)
    (kc, ks), (vc, vs) = (kv_cache.quantize_kv(t, "float8_e4m3fn")
                          for t in (kc, vc))
    ks, vs = ks[..., None, :], vs[..., None, :]
    lt = torch.tensor(PAGED_LENS, dtype=torch.int32, device=dev)
    q = torch.randn((len(PAGED_LENS), h, d), generator=gen,
                    device=dev).bfloat16()
    cases.append({**b7_case(decode, "fp8 n=1", q, kc, vc, ks, vs, lt, pt, 1),
                  "path": FP8_RUNS[1]})
    del kc, vc, ks, vs
    torch.cuda.empty_cache()
    return cases


def kernel_b3_quant(flash, kv_cache, gen, dev):
    """B3 over fp8 and packed int4 K/V as the chunked prefill runs it on
    such a cache (2048 rows at q_start 6144 over the layer's prefix, read
    in place as a strided slice), dense and with window 4096 and 4 sinks;
    the online and softcap forms where lengths and the window cut tiles;
    the band check over the windowed call; each against the plain version
    on the card (the values widened exactly), with times and SDPA over the
    dequantized prefix."""
    b, h, hk, d = BATCH, MODEL["n_heads"], MODEL["n_kv_heads"], 128
    s_q, start = CHUNK, PROMPT - CHUNK
    scale = d ** -0.5
    q = torch.randn((b, s_q, h, d), generator=gen, device=dev).bfloat16()
    win = dict(window_size=(WINDOW, -1), sink_tokens=SINKS)
    cases = []
    for dtype in QUANT_DTYPES:
        kc, kst = quant_values(kv_cache, (2, b, hk, S_MAX, d), dtype, gen,
                               dev)
        vc, vst = quant_values(kv_cache, (2, b, hk, S_MAX, d), dtype, gen,
                               dev)
        kst, vst = kst[..., None, :], vst[..., None, :]
        args = (kc[1, :, :, :start], vc[1, :, :, :start],
                kst[1, :, :, 0, :start], vst[1, :, :, 0, :start])
        kd, vd = (kv_cache.dequantize_kv(t, sc) for t, sc in
                  ((args[0], args[2]), (args[1], args[3])))
        qh = q.transpose(1, 2)
        for wtag, wkw in (("dense", {}), ("window sinks", win)):
            checks = []
            o, l = flash.flash_fwd_pos(q, *args, q_start=start, causal=True,
                                       scale=scale, **wkw)
            po, pl_ = flash.flash_fwd_pos_plain(q, *args, q_start=start,
                                                causal=True, scale=scale,
                                                **wkw)
            torch.cuda.synchronize()
            checks.append(check_out(f"B3 out {dtype} {wtag}", o, po))
            check(f"B3 lse {dtype} {wtag}", max_err(l, pl_), LSE_TOL)
            del po, pl_
            vis = visible(s_q, start, start, True,
                          **({} if not wkw else dict(left=WINDOW,
                                                     sink=SINKS)), dev=dev)
            if wkw:  # the band check: NaN scales outside the walk
                tiles = unseen_tiles(vis, B3_KV_TILE)
                ksp, vsp = (poison(t, 2, tiles, B3_KV_TILE)
                            for t in args[2:])
                got, _ = flash.flash_fwd_pos(q, *args[:2], ksp, vsp,
                                             q_start=start, causal=True,
                                             scale=scale, **wkw)
                torch.cuda.synchronize()
                band_check(f"B3 {dtype}", got, o, len(tiles))
                del ksp, vsp, got
            ms = time_ms(lambda: flash.flash_fwd_pos(
                q, *args, q_start=start, causal=True, scale=scale, **wkw))
            plain_ms = time_ms(lambda: flash.flash_fwd_pos_plain(
                q, *args, q_start=start, causal=True, scale=scale, **wkw),
                iters=2, warmup=1)
            lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
                qh, kd, vd, attn_mask=None if not wkw else vis,
                enable_gqa=True))
            cols = int(vis.any(0).sum())
            nbytes = int(2 * 2 * q.numel() + 4 * b * h * s_q
                         + 2 * b * hk * cols * (d * CACHE_ELT[dtype] + 4))
            cases.append({"case": f"{dtype} prefix {start}, {s_q} rows, "
                                  f"{wtag}",
                          "path": None if wkw else QUANT_SLICE[dtype],
                          **case_row(checks, ms, plain_ms,
                                     4 * b * h * d * int(vis.sum()), nbytes,
                                     lib_ms)})
        # the online and softcap forms where the edges cut 128-wide tiles
        sr, qs0, kvr = 300, 1037, 1337
        small = tuple(t[..., :kvr, :] if t.dim() == 4 else t[..., :kvr]
                      for t in args)
        for ftag, fkw in (("safe", dict(safe_softmax=True)),
                          ("softcap", dict(softcap=SOFTCAP))):
            kw = dict(fkw, q_start=qs0, causal=True, scale=scale,
                      window_size=(500, -1), sink_tokens=70)
            o, l = flash.flash_fwd_pos(q[:, :sr].contiguous(), *small, **kw)
            po, pl_ = flash.flash_fwd_pos_plain(q[:, :sr].contiguous(),
                                                *small, **kw)
            torch.cuda.synchronize()
            cases[-1].setdefault("form_row_rel_err", {})[ftag] = check_out(
                f"B3 out {dtype} {ftag} window 500 sinks 70", o, po)[1]
            check(f"B3 lse {dtype} {ftag}", max_err(l, pl_), LSE_TOL)
        del kc, vc, kst, vst, args, kd, vd
        torch.cuda.empty_cache()
    return cases


def kernel_quant_cache(K, flash, decode, kv_cache, gen, dev):
    """The kernel cases of the fp8 and int4 caches: B6's byte copy (dense
    one token, paged run of 256), B7 (kernel_b7_quant) and B3
    (kernel_b3_quant), by kernel name; and B6's quantizing entry over fp8
    and int4 caches, dense and paged (b6_rows_case)."""
    b6 = [b6_quant_case(decode, kv_cache, f"{dt} {'paged' if p else 'dense'}",
                        dt, gen, dev, p, path)
          for dt in QUANT_DTYPES
          for p, path in ((False, QUANT_SLICE[dt]),
                          (True, FP8_RUNS[256] if dt == "float8_e4m3fn"
                           else None))]
    b6_rows = [b6_rows_case(decode, kv_cache, dt, p, n, gen, dev)
               for dt in QUANT_DTYPES for p in (False, True) for n in B6_RUNS]
    torch.cuda.empty_cache()
    b7 = kernel_b7_quant(decode, kv_cache, gen, dev)
    torch.cuda.empty_cache()
    b3 = kernel_b3_quant(flash, kv_cache, gen, dev)
    torch.cuda.empty_cache()
    return {"cache_append": b6, "decode_attention": b7,
            "flash_fwd_pos": b3}, b6_rows


def sdpa_backward_ms(q, k, v, dout, causal=True):
    """SDPA's flash backward (fwd+bwd minus fwd), causal unless told, K/V
    repeated to the query heads (its flash backend takes no GQA)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    g = q.shape[2] // k.shape[2]
    qh = q.transpose(1, 2).detach().requires_grad_()
    kh, vh = (t.transpose(1, 2).repeat_interleave(g, 1).detach()
              .requires_grad_() for t in (k, v))
    doh = dout.transpose(1, 2)

    def fwd():
        with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
            return F.scaled_dot_product_attention(qh, kh, vh,
                                                  is_causal=causal)

    def fwd_bwd():
        torch.autograd.grad(fwd(), (qh, kh, vh), doh)

    return time_ms(fwd_bwd) - time_ms(fwd)


def kernel_bwd(K, flash, gen, dev):
    """B2a, B2b and B5 against their plain versions at the trainer's
    per-layer attention shape (b=1, s=8192, 16/8 heads, d=128), on the
    forward's own out and lse: causal from position 0 (all three), causal
    with kv offset s/2 so the first half of the rows see nothing (B2a,
    B2b: those dq rows, and the dk/dv rows no q row sees, must be exactly
    0), and ragged lengths, non-causal included. Times at the causal shape,
    and B2b's and B5's also at usp_sparse's dense reference (s = 32768),
    each beside SDPA's flash backward at the same shape."""
    b, s, h, hk, d = 1, TRAIN_SEQ, MODEL["n_heads"], MODEL["n_kv_heads"], 128
    scale = d ** -0.5
    q = torch.randn((b, s, h, d), generator=gen, device=dev).bfloat16()
    k = torch.randn((b, s, hk, d), generator=gen, device=dev).bfloat16()
    v = torch.randn((b, s, hk, d), generator=gen, device=dev).bfloat16()
    dout = torch.randn((b, s, h, d), generator=gen, device=dev).bfloat16()

    def inputs(q, k, v, dout, q_start):
        if q_start is None:
            out, lse = flash.flash_fwd_causal_self(q, k, v, scale=scale)
        else:
            out, lse = flash.flash_fwd_pos(q, k.transpose(1, 2),
                                           v.transpose(1, 2), q_start=q_start,
                                           causal=True, scale=scale)
        delta = (dout.float() * out.float()).sum(-1).transpose(1, 2)
        return q, k, v, dout, lse, delta.contiguous()

    checks = {"B2a": [], "B2b": [], "B5": []}

    def run_pair(tag, args, q_start, causal=True, dead_rows=0, dead_cols=0):
        kw = dict(scale=scale, q_start=q_start, causal=causal)
        dq = flash.flash_bwd_dq(*args, **kw)
        pdq = flash.flash_bwd_dq_plain(*args, **kw)
        torch.cuda.synchronize()
        if dead_rows and dq[:, :dead_rows].any():
            raise AssertionError(f"B2a {tag}: dead rows have nonzero dq")
        one_col = -q_start if causal else None  # sees column 0 only
        checks["B2a"].append(check_out(f"B2a dq {tag}", dq, pdq, one_col))
        del dq, pdq
        dk, dv = flash.flash_bwd_dkv(*args, **kw)
        pdk, pdv = flash.flash_bwd_dkv_plain(*args, **kw)
        torch.cuda.synchronize()
        unseen = slice(-dead_cols, None) if dead_cols else slice(0)
        if dk[:, unseen].any() or dv[:, unseen].any():
            raise AssertionError(f"B2b {tag}: unseen kv rows have nonzero "
                                 f"dk/dv")
        checks["B2b"].append(check_out(f"B2b dk {tag}", dk, pdk))
        checks["B2b"].append(check_out(f"B2b dv {tag}", dv, pdv))
        del dk, dv, pdk, pdv
        torch.cuda.empty_cache()

    def run_fused(tag, args, causal=True):
        got = flash.flash_bwd_fused(*args, scale=scale, causal=causal)
        want = flash.flash_bwd_fused_plain(*args, scale=scale, causal=causal)
        torch.cuda.synchronize()
        for name, a, w in zip(("dq", "dk", "dv"), got, want):
            one_col = 0 if causal and name == "dq" else None
            checks["B5"].append(check_out(f"B5 {name} {tag}", a, w, one_col))
        del got, want
        torch.cuda.empty_cache()

    causal_args = inputs(q, k, v, dout, None)
    run_fused("causal", causal_args)
    run_pair("causal", causal_args, 0)
    half = s // 2
    run_pair("kv offset s/2", inputs(q, k, v, dout, -half), -half,
             dead_rows=half, dead_cols=half)
    # ragged: 1000 rows, partial tiles at the end; a dead band of 300 rows
    rq, rk, rv, rdo = (t[:, :1000].contiguous() for t in (q, k, v, dout))
    run_fused("ragged", inputs(rq, rk, rv, rdo, None))
    run_pair("ragged q_start=-300", inputs(rq, rk, rv, rdo, -300), -300,
             dead_rows=300, dead_cols=300)
    out, lse = flash.flash_fwd_pos(rq, rk.transpose(1, 2), rv.transpose(1, 2),
                                   causal=False, scale=scale)
    delta = (rdo.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    run_pair("ragged non-causal", (rq, rk, rv, rdo, lse, delta), 0,
             causal=False)
    run_fused("ragged non-causal", (rq, rk, rv, rdo, lse, delta),
              causal=False)

    masked = kernel_bwd_masked(flash, dev, q, k, v, dout, scale)

    # times at the causal shape
    kw = dict(scale=scale, causal=True)
    ms = {"B2a": time_ms(lambda: flash.flash_bwd_dq(*causal_args, **kw)),
          "B2b": time_ms(lambda: flash.flash_bwd_dkv(*causal_args, **kw)),
          "B5": time_ms(lambda: flash.flash_bwd_fused(*causal_args, **kw))}
    plain = {"B2a": flash.flash_bwd_dq_plain, "B2b": flash.flash_bwd_dkv_plain,
             "B5": flash.flash_bwd_fused_plain}
    plain_ms = {}
    for name, fn in plain.items():
        plain_ms[name] = time_ms(lambda: fn(*causal_args, **kw), iters=1,
                                 warmup=1)
        torch.cuda.empty_cache()
    lib_ms = sdpa_backward_ms(q, k, v, dout)
    del causal_args
    torch.cuda.empty_cache()
    products = {"B2a": 3, "B2b": 4, "B5": 5}  # matmuls of depth d per pair

    def work(n, q, k):  # (FLOPs, bytes) of one causal call
        s = q.shape[1]
        live = b * h * s * (s + 1) // 2
        in_bytes = 2 * (2 * q.numel() + k.numel() * 2) + 8 * b * h * s
        grads = {"B2a": 4 * q.numel(), "B2b": 8 * k.numel(),
                 "B5": 4 * q.numel() + 8 * k.numel()}[n]
        return 2 * products[n] * d * live, in_bytes + grads

    # B5 and B2b at the dense reference's shape in usp_sparse (s = 32768)
    gen32 = torch.Generator(device=dev).manual_seed(SEED + 5)
    q32, dout32 = (torch.randn((b, SPARSE_SEQ, h, d), generator=gen32,
                               device=dev).bfloat16() for _ in range(2))
    k32, v32 = (torch.randn((b, SPARSE_SEQ, hk, d), generator=gen32,
                            device=dev).bfloat16() for _ in range(2))
    args32 = inputs(q32, k32, v32, dout32, None)
    at32 = {}
    for n, fn in (("B2b", flash.flash_bwd_dkv), ("B5", flash.flash_bwd_fused)):
        t = time_ms(lambda: fn(*args32, **kw), iters=3, warmup=1)
        b_ms, b_by = bound(*work(n, q32, k32))
        at32[n] = {"seq": SPARSE_SEQ, "ms": t, "bound_ms": b_ms,
                   "bound_by": b_by}
    del args32
    torch.cuda.empty_cache()
    lib32 = sdpa_backward_ms(q32, k32, v32, dout32)
    for n in at32:
        at32[n]["library_ms"] = lib32
    del q32, k32, v32, dout32
    torch.cuda.empty_cache()

    kern = {"B2a": "flash_bwd_dq", "B2b": "flash_bwd_dkv",
            "B5": "flash_bwd_fused"}
    return [{**row(K[kern[n]], checks[n], ms[n], plain_ms[n], *work(n, q, k),
                   lib_ms),
             "library": "SDPA flash backward (dq, dk, dv), K/V repeated to "
                        "the query heads",
             **({"at_usp_seq": at32[n]} if n in at32 else {}),
             "masked_cases": masked[n]}
            for n in ("B2a", "B2b", "B5")]


# The backward's masked cases at the trainer's per-layer shape: (tag,
# q_start or None for B5, the flash_attention mask kwargs). B5: the windowed
# model's training call (window 4096, 4 sinks), a non-causal two-sided
# window and the softcap; B2a + B2b: the offsets call with the window and
# sinks (the windowed offsets_phase call), and with the softcap too from kv
# offset s/2, whose first half of rows see nothing (dq 0) and whose second
# half of kv rows no row sees (dk, dv 0).
BWD_WINDOW = dict(causal=True, window_size=(WINDOW, -1), sink_tokens=SINKS)
BWD_MASKED = {
    "B5": (("window sinks", None, BWD_WINDOW),
           ("non-causal window (512, 256) sinks", None,
            dict(causal=False, window_size=(512, 256), sink_tokens=SINKS)),
           ("window sinks softcap", None, dict(BWD_WINDOW, softcap=SOFTCAP))),
    "B2a": (("offsets window sinks", 0, BWD_WINDOW),
            ("kv offset s/2 window sinks softcap", -TRAIN_SEQ // 2,
             dict(BWD_WINDOW, softcap=SOFTCAP))),
}


def kernel_bwd_masked(flash, dev, q, k, v, dout, scale):
    """B5, B2a and B2b with the sliding window, sinks and softcap (BWD_MASKED)
    against their plain versions, each row within ROW_REL_TOL, on the
    forward's own out and lse, with the band checks: kv tiles that no row
    of a block of rows sees, poisoned with NaN, leave that block's dq
    finite (B5: within the row limit, its dq being added in no fixed order;
    B2a: bit-equal), and q tiles (64 rows: B5's and B2b's) that see none of
    the last kv columns leave their dk and dv bit-equal. Each case timed,
    with its bound from the visible pairs. At head dim 64 B5's forward is
    B3 at q position 0 (B4 takes 128 only). Returns {kernel: [case
    rows]}."""
    b, s, h, _ = q.shape
    d = q.shape[-1]
    out = {"B2a": [], "B2b": [], "B5": []}

    def fwd(q_start, shape):
        if q_start is None and d == 128:
            return flash.flash_fwd_static(q, k, v, scale=scale, **shape)
        return flash.flash_fwd_pos(q, k.transpose(1, 2), v.transpose(1, 2),
                                   q_start=q_start or 0, scale=scale,
                                   **shape)

    def vis_of(q_start, shape):
        left, right = shape["window_size"]
        return visible(s, s, q_start or 0, shape["causal"], left=left,
                       right=right, sink=shape["sink_tokens"], dev=dev)

    def case(n, tag, fns, plain, q_start, shape, args, vis, cancel=None):
        kw = dict(scale=scale, **shape, **({} if q_start is None
                                          else dict(q_start=q_start)))
        got, want = fns(*args, **kw), plain(*args, **kw)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        torch.cuda.synchronize()
        names = {"B5": ("dq", "dk", "dv"), "B2a": ("dq",),
                 "B2b": ("dk", "dv")}[n]
        checks = [check_out(f"{n} {g} {tag}", a, w,
                            cancel if g == "dq" else None)
                  for g, a, w in zip(names, got, want)]
        del got, want
        ms = time_ms(lambda: fns(*args, **kw))
        plain_ms = time_ms(lambda: plain(*args, **kw), iters=1, warmup=0)
        torch.cuda.empty_cache()
        # SDPA takes the band as a bool mask, but no softcap
        lib_ms = (None if shape.get("softcap") else
                  sdpa_masked_ms(q, k, v, dout, vis)[1])
        torch.cuda.empty_cache()
        live = b * h * int(vis.sum())
        products = {"B2a": 3, "B2b": 4, "B5": 5}[n]
        in_bytes = 2 * (2 * q.numel() + 2 * k.numel()) + 8 * b * h * s
        grads = {"B2a": 4 * q.numel(), "B2b": 8 * k.numel(),
                 "B5": 4 * q.numel() + 8 * k.numel()}[n]
        return kw, {"case": tag, **case_row(checks, ms, plain_ms,
                                             2 * products * d * live,
                                             in_bytes + grads, lib_ms),
                    "library": "SDPA memory-efficient backward (dq, dk, dv) "
                               "with the bool band mask" if lib_ms else None,
                    "visible_pairs_per_head": int(vis.sum())}

    def poisoned(n, tag, fn, kw, args, vis):
        q_, k_, v_, do_, lse, delta = args
        clean = fn(*args, **kw)
        clean = clean if isinstance(clean, tuple) else (clean,)
        if n in ("B5", "B2a"):  # kv side: dq of a block of rows
            rows, tiles = rows_seeing_less(vis, 128)
            kp, vp = (poison(t, 1, tiles, 128) for t in (k_, v_))
            dq = fn(q_, kp, vp, do_, lse, delta, **kw)
            dq = (dq if n == "B2a" else dq[0])[:, rows]
            torch.cuda.synchronize()
            if n == "B2a":
                band_check(f"B2a {tag}", dq, clean[0][:, rows], len(tiles))
            else:
                ok = bool(torch.isfinite(dq).all())
                emit({"phase": "check", "case": f"B5 dq {tag} band check",
                      "poisoned_tiles": len(tiles), "finite": ok})
                if not ok:
                    raise AssertionError(f"B5 {tag}: kv tiles outside the "
                                         f"walk reached dq")
                check_out(f"B5 dq {tag} (poisoned kv)", dq,
                          clean[0][:, rows], 0 if rows.start == 0 else None)
            del kp, vp, dq
        if n in ("B5", "B2b"):  # q side: dk and dv of the last kv columns
            cols, tiles = cols_seen_by_few(vis, 64)
            qp, dop = (poison(t, 1, tiles, 64) for t in (q_, do_))
            got = fn(qp, k_, v_, dop, lse, delta, **kw)
            torch.cuda.synchronize()
            band_check(f"{n} dk, dv {tag}",
                       torch.stack([got[-2][:, cols], got[-1][:, cols]]),
                       torch.stack([clean[-2][:, cols], clean[-1][:, cols]]),
                       len(tiles))
            del qp, dop, got
        del clean
        torch.cuda.empty_cache()

    for n, cases in BWD_MASKED.items():
        for tag, q_start, shape in cases:
            o, lse = fwd(q_start, shape)
            delta = (dout.float() * o.float()).sum(-1).transpose(1, 2)
            args = (q, k, v, dout, lse, delta.contiguous())
            del o
            vis = vis_of(q_start, shape)
            dead = (-q_start if q_start is not None and q_start < 0 else 0)
            if n == "B5":
                kw, r = case("B5", tag, flash.flash_bwd_fused,
                             flash.flash_bwd_fused_plain, None, shape, args,
                             vis, 0 if shape["causal"] else None)
                out["B5"].append(r)
                poisoned("B5", tag, flash.flash_bwd_fused, kw, args, vis)
            else:
                kw, r = case("B2a", tag, flash.flash_bwd_dq,
                             flash.flash_bwd_dq_plain, q_start, shape, args,
                             vis, dead)
                out["B2a"].append(r)
                dq = flash.flash_bwd_dq(*args, **kw)
                torch.cuda.synchronize()
                if dead and dq[:, :dead].any():
                    raise AssertionError(f"B2a {tag}: dead rows have "
                                         f"nonzero dq")
                del dq
                poisoned("B2a", tag, flash.flash_bwd_dq, kw, args, vis)
                kw, r = case("B2b", tag, flash.flash_bwd_dkv,
                             flash.flash_bwd_dkv_plain, q_start, shape, args,
                             vis)
                out["B2b"].append(r)
                dk, dv = flash.flash_bwd_dkv(*args, **kw)
                torch.cuda.synchronize()
                if dead and (dk[:, s - dead:].any() or dv[:, s - dead:].any()):
                    raise AssertionError(f"B2b {tag}: unseen kv rows have "
                                         f"nonzero dk/dv")
                del dk, dv
                poisoned("B2b", tag, flash.flash_bwd_dkv, kw, args, vis)
            del args, lse, delta, vis
            torch.cuda.empty_cache()
    return out


def sparse_masks(sparse):
    """The causal tile masks of the usp_sparse path (SPARSE_* above)."""
    n, h = SPARSE_TILES, MODEL["n_heads"]
    return {"streaming": sparse.global_local_block_mask(n, n, 8,
                                                        sink_tiles=1),
            "strided": sparse.strided_block_mask(n, n, 8, local_tiles=4),
            "per_head": np.stack([sparse.global_local_block_mask(
                n, n, 4 + 2 * (i % 5), sink_tiles=1) for i in range(h)])}


def sparse_plan(sparse, mask, s_q, s_kv, causal, block=None):
    """The live-tile plan block_sparse_attention builds for this call (in
    tiles of SPARSE_BLOCK unless `block` says otherwise)."""
    h, hk = MODEL["n_heads"], MODEL["n_kv_heads"]
    block = block or SPARSE_BLOCK
    m = np.ascontiguousarray(mask)
    return sparse._plan(m.tobytes(), m.shape, h, s_q // block, s_kv // block,
                        causal, block, block, h // hk, 0, 1)


def sparse_pairs(plan, h):
    """Visible (row, column) pairs of a sparse call over its h heads: whole
    live tiles, and on a straddling tile the pairs at or below the diagonal
    by global position."""
    bq, bkv = plan.bq, plan.bkv
    per_tile = np.full(plan.straddle.shape, bq * bkv, dtype=np.int64)
    rows = np.arange(bq)
    for iq, ik in zip(*np.nonzero(plan.straddle)):
        seen = plan.q_first[iq] + rows - plan.kv_first[ik] + 1
        per_tile[iq, ik] = int(np.clip(seen, 0, bkv).sum())
    heads = plan.mh.sum(0) if plan.per_head else plan.mh[0] * h
    return int((heads * per_tile).sum())


def dense_mask(plan, dev):
    """(s_q, s_kv) bool: the pairs a shared-mask plan keeps."""
    live = torch.from_numpy(plan.mh[0]).to(dev)
    live = live.repeat_interleave(plan.bq, 0).repeat_interleave(plan.bkv, 1)
    rows = torch.arange(live.shape[0], device=dev) + int(plan.q_first[0])
    cols = torch.arange(live.shape[1], device=dev)
    strad = torch.from_numpy(plan.straddle).to(dev)
    strad = strad.repeat_interleave(plan.bq, 0).repeat_interleave(plan.bkv, 1)
    return live & ~(strad & (cols[None, :] > rows[:, None]))


def sdpa_masked_ms(q, k, v, dout, mask, dropout_p=0.0):
    """SDPA's memory-efficient kernel (it takes a boolean or an additive
    float mask, and dropout; flash takes no mask) on the same function:
    (forward ms, backward ms), K/V repeated to the query heads. With
    dropout it draws its own mask: a cost yardstick, not the function."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    g = q.shape[2] // k.shape[2]
    qh = q.transpose(1, 2).detach().requires_grad_()
    kh, vh = (t.transpose(1, 2).repeat_interleave(g, 1).detach()
              .requires_grad_() for t in (k, v))
    doh = dout.transpose(1, 2)

    def fwd():
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask,
                                                  dropout_p=dropout_p)

    def fwd_bwd():
        torch.autograd.grad(fwd(), (qh, kh, vh), doh)

    fwd_ms = time_ms(fwd, iters=3, warmup=1)
    return fwd_ms, time_ms(fwd_bwd, iters=3, warmup=1) - fwd_ms


def kernel_b9(K, sparse, gen, dev):
    """B9a, B9b and B9c against their plain versions at the usp_sparse
    path's shape (b=1, s=32768, 16/8 heads, d=128, tiles of 512): the three
    causal masks, a mask whose last quarter of q rows has no live tile (out
    0, lse -inf, dq 0 there), a mask with an empty kv column (dk, dv 0
    there), a non-causal rectangular call (8192 rows over the 32768
    columns, random tiles at density 0.25), and the StreamingLLM mask in
    tiles of 192 (an odd multiple of the kernels' 64: B9c's last 128-row
    item of each kv tile is half the next tile's) at s=6144. Times, the
    bound and SDPA's masked call at the StreamingLLM mask."""
    h, hk, d = MODEL["n_heads"], MODEL["n_kv_heads"], 128
    s, n, scale = SPARSE_SEQ, SPARSE_TILES, d ** -0.5
    q, dout = (torch.randn((1, s, h, d), generator=gen, device=dev).bfloat16()
               for _ in range(2))
    k, v = (torch.randn((1, s, hk, d), generator=gen, device=dev).bfloat16()
            for _ in range(2))
    masks = sparse_masks(sparse)
    uncovered = masks["streaming"].copy()
    uncovered[3 * n // 4:] = False
    dead_rows = slice(3 * s // 4, s)
    empty_col = masks["streaming"].copy()
    empty_col[:, n // 2] = False  # kv tile n/2: no live tile, dk = dv = 0
    dead_cols = slice(s // 2, s // 2 + SPARSE_BLOCK)
    rect = s // 4
    s192, n192 = 6144, 6144 // 192
    cases = [(f"{name} causal", m, True, s, s, SPARSE_BLOCK)
             for name, m in masks.items()]
    cases += [("uncovered rows causal", uncovered, True, s, s, SPARSE_BLOCK),
              ("empty kv column causal", empty_col, True, s, s,
               SPARSE_BLOCK),
              (f"s_q={rect} non-causal random 0.25",
               sparse.random_block_mask(rect // SPARSE_BLOCK, n, 0.25), False,
               rect, s, SPARSE_BLOCK),
              (f"streaming causal tiles 192 s={s192}",
               sparse.global_local_block_mask(n192, n192, 8, sink_tiles=1),
               True, s192, s192, 192)]
    checks = {"B9a": [], "B9b": [], "B9c": []}
    for tag, mask, causal, s_q, s_kv, blk in cases:
        qq, do = q[:, -s_q:].contiguous(), dout[:, -s_q:].contiguous()
        kk, vv = k[:, :s_kv], v[:, :s_kv]
        plan = sparse_plan(sparse, mask, s_q, s_kv, causal, blk)
        o, l = sparse.sparse_fwd(qq, kk, vv, plan, scale=scale)
        po, pl_ = sparse.sparse_fwd_plain(qq, kk, vv, plan, scale=scale)
        torch.cuda.synchronize()
        checks["B9a"].append(check_out(f"B9a out {tag}", o, po))
        check(f"B9a lse {tag}", max_err(l, pl_), LSE_TOL)
        ops = sparse.sparse_bwd_operands(o, l, do, qq.dtype)
        dq = sparse.sparse_bwd_dq(qq, kk, vv, *ops, plan, scale=scale)
        pdq = sparse.sparse_bwd_dq_plain(qq, kk, vv, *ops, plan, scale=scale)
        torch.cuda.synchronize()
        if tag.startswith("uncovered"):
            if (o[:, dead_rows].any() or dq[:, dead_rows].any()
                    or not torch.isneginf(l[:, :, dead_rows]).all()):
                raise AssertionError("B9a/B9b: uncovered rows are not out 0, "
                                     "lse -inf, dq 0")
        # row 0 sees column 0 alone under the causal mask: its ds cancels
        checks["B9b"].append(check_out(f"B9b dq {tag}", dq, pdq,
                                       0 if causal else None))
        del dq, pdq, po, pl_
        dk, dv = sparse.sparse_bwd_dkv(qq, kk, vv, *ops, plan, scale=scale)
        pdk, pdv = sparse.sparse_bwd_dkv_plain(qq, kk, vv, *ops, plan,
                                               scale=scale)
        torch.cuda.synchronize()
        if tag.startswith("empty kv column") and (
                dk[:, dead_cols].any() or dv[:, dead_cols].any()):
            raise AssertionError("B9c: the empty kv column's dk, dv are not 0")
        checks["B9c"].append(check_out(f"B9c dk {tag}", dk, pdk))
        checks["B9c"].append(check_out(f"B9c dv {tag}", dv, pdv))
        emit({"phase": "check", "case": f"B9 {tag}",
              "density": sparse.mask_density(mask, causal),
              "pairs": sparse_pairs(plan, h)})
        del dk, dv, pdk, pdv, o, l, ops
        torch.cuda.empty_cache()

    # times at the StreamingLLM mask
    plan = sparse_plan(sparse, masks["streaming"], s, s, True)
    o, l = sparse.sparse_fwd(q, k, v, plan, scale=scale)
    ops = sparse.sparse_bwd_operands(o, l, dout, q.dtype)
    fns = {"B9a": (sparse.sparse_fwd, sparse.sparse_fwd_plain, ()),
           "B9b": (sparse.sparse_bwd_dq, sparse.sparse_bwd_dq_plain, ops),
           "B9c": (sparse.sparse_bwd_dkv, sparse.sparse_bwd_dkv_plain, ops)}
    ms, plain_ms = {}, {}
    for name, (fn, plain, extra) in fns.items():
        ms[name] = time_ms(lambda: fn(q, k, v, *extra, plan, scale=scale))
        plain_ms[name] = time_ms(lambda: plain(q, k, v, *extra, plan,
                                               scale=scale), iters=1, warmup=0)
        torch.cuda.empty_cache()
    vis = dense_mask(plan, dev)
    lib_fwd, lib_bwd = sdpa_masked_ms(q, k, v, dout, vis)
    del vis
    torch.cuda.empty_cache()
    pairs = sparse_pairs(plan, h)
    in_bytes = 2 * (q.numel() + k.numel() + v.numel())
    nbytes = {"B9a": in_bytes + 2 * q.numel() + 4 * h * s,
              "B9b": in_bytes + 2 * q.numel() + 8 * h * s + 4 * q.numel(),
              "B9c": in_bytes + 2 * q.numel() + 8 * h * s + 8 * k.numel()}
    products = {"B9a": 2, "B9b": 3, "B9c": 4}  # matmuls of depth d per pair
    kern = {"B9a": "sparse_fwd", "B9b": "sparse_bwd_dq",
            "B9c": "sparse_bwd_dkv"}
    return [{**row(K[kern[n]], checks[n], ms[n], plain_ms[n],
                   2 * products[n] * d * pairs, nbytes[n],
                   lib_fwd if n == "B9a" else lib_bwd),
             "library": "SDPA memory-efficient with the dense boolean mask"
                        + (" (backward: all three grads)" if n != "B9a"
                           else ""),
             "mask": "streaming", "pairs": pairs}
            for n in ("B9a", "B9b", "B9c")]


# ---------------------------------------------------------------------------
# phase 4: the serving slice
# ---------------------------------------------------------------------------


def profiled(fn):
    """Run fn once under torch.profiler; return its result and the device
    time by kernel name, the device-busy share of the wall time (the
    profiler adds host time of its own) and the number of kernel launches."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device kernels only: a GPU user annotation (the optimizer's step
    # range) spans kernels already counted
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    by_name = {}
    for e in kernels:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + getattr(e, "device_time", 0.0) / 1e3)
    busy_ms = sum(t for _, t in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    return out, {"wall_ms": wall * 1e3, "device_ms": busy_ms,
                 "device_busy_share": busy_ms / (wall * 1e3),
                 "kernel_launches": len(kernels),
                 "top": [[name[:80], n, t] for name, (n, t) in top]}


def expect_counts(build, want):
    got = build.launch_counts()
    for name, n in want.items():
        if got[name] != n:
            raise AssertionError(f"{name} launched {got[name]} times on the "
                                 f"path, expected {n} (all: {got})")
    return got


def exact_counts(build, want, d=128):
    """expect_counts over every kernel: each entry point of ``want`` (its
    d = 128 name) at its count on its head dim d kernel, every other kernel
    at 0."""
    return expect_counts(build, {**dict.fromkeys(build.KERNELS, 0),
                                 **{build.kernel(n, d).name: c
                                    for n, c in want.items() if c}})


def expect_native(tag, eng):
    """A paged engine's page bookkeeping ran in the C++ host core
    (serving/native.py over csrc/lca_host.cc)."""
    if eng.last_alloc_kind != "native":
        raise AssertionError(f"{tag}: allocator {eng.last_alloc_kind}")


def cache_bytes(cache):
    """Bytes the cache's values and scales take on the card."""
    return sum(t.numel() * t.element_size() for t in (
        cache.k, cache.v, cache.k_scale, cache.v_scale) if t is not None)


def serve_phase(pkg, build, dev, card, windowed, cache_dtype="int8",
                model=MODEL, label="llama-0.88B", tag=None):
    """Serve the 0.88B config (dense, or with the sliding window and sinks)
    over a cache of ``cache_dtype``: prefill_chunked + decode_scan with
    exact launch counts, teacher forcing (its decode step profiled), and
    the cache's bytes. The int8 runs add a profile of a two-chunk prefill,
    and a generate at b=2. The fp8 and int4 runs (slice_fp8, slice_int4)
    hold fp8 to the int8 gate (TEACHER_TOL) and report int4's error, gated
    on finite logits as the JAX suite gates an int4 cache. ``model``,
    ``label``, ``tag``: another config to serve the same way (slice_hd64:
    TinyLlama's widths at head dim 64, on the d = 64 kernels, whose
    launches are counted and the d = 128 ones' held at 0). Returns the
    prefill_chunked + decode_scan run's launch counts and its serving
    numbers."""
    from long_context_attention_tpu_torch.models.llama import (
        decode_step, init_params)
    from long_context_attention_tpu_torch.serving.engine import Engine

    quant = cache_dtype != "int8"  # the fp8 and int4 slices
    if tag is None:
        tag = "slice_windowed" if windowed else "slice"
        if quant:
            tag = f"slice_{QUANT_TAG[cache_dtype]}"
    cfg = pkg.ModelConfig(**model, **(WINDOWED if windowed else {}))
    L, d = cfg.n_layers, cfg.head_dim
    kn = {n: build.kernel(n, d).name for n in build.HEAD_DIM_64}
    # the other head dim's serving kernels launch none
    idle = {} if d == 128 else dict.fromkeys(build.HEAD_DIM_64, 0)
    # a chunk's self-attention: B4 under the window, B1 without it
    own, other = (("flash_fwd_static", kn["flash_fwd_causal_self"])
                  if windowed else
                  (kn["flash_fwd_causal_self"], "flash_fwd_static"))
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = init_params(gen, cfg, device=dev)
    prompt = torch.randint(0, cfg.vocab, (BATCH, PROMPT), generator=gen,
                           device=dev)
    eng = Engine(cfg=cfg, s_max=S_MAX, cache_dtype=cache_dtype,
                 weight_dtype="int8", device=dev)
    dparams = eng.decode_params(params)

    # warm-up (cuBLAS handles and heuristics, the allocator's pools) on a
    # short prompt; the decode loop is host-bound and takes a few steps to
    # reach its steady rate
    wl, wc = eng.prefill_chunked(params, prompt[:, :CHUNK], CHUNK)
    eng.decode_scan(dparams, wc, 8, torch.argmax(wl, -1).to(torch.int32))
    del wl, wc
    torch.cuda.synchronize()

    build.reset_launch_counts()
    t0 = time.perf_counter()
    logits, cache = eng.prefill_chunked(params, prompt, CHUNK)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    first = torch.argmax(logits, -1).to(torch.int32)
    fork = {f: getattr(cache, f).clone() for f in
            ("k", "v", "k_scale", "v_scale", "length")}
    t0 = time.perf_counter()
    toks, cache = eng.decode_scan(dparams, cache, NEW, first)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    counts = expect_counts(build, {
        **idle, own: L * (PROMPT // CHUNK), other: 0,
        kn["flash_fwd_pos"]: L * (PROMPT // CHUNK - 1),
        # B6: each chunk's write_prompt per layer, then each decode step's
        kn["cache_append"]: L * (PROMPT // CHUNK) + L * NEW,
        kn["decode_attention"]: L * NEW, kn["decode_run"]: 0})
    if not torch.isfinite(logits).all():
        raise AssertionError("prefill logits are not finite")
    if toks.shape != (BATCH, NEW) or cache.length.tolist() != [
            PROMPT + NEW] * BATCH:
        raise AssertionError(f"decode_scan shapes {tuple(toks.shape)}, "
                             f"lengths {cache.length.tolist()}")

    # teacher forcing: step 1 of decode vs a prefill of prompt + first (its
    # self-attention kernel at s=8193); that step runs under the profiler
    # for the decode-step breakdown
    for f, t in fork.items():
        if t is not None:
            getattr(cache, f).copy_(t)
    torch.cuda.synchronize()
    n_bytes = cache_bytes(cache)
    step1, profile = profiled(lambda: decode_step(dparams, cache, first,
                                                  cfg)[0])
    emit({"phase": "decode_profile", "serving": tag, **profile})
    del cache, fork
    tf_logits, _ = eng.prefill(params, torch.cat([prompt, first[:, None]],
                                                 dim=1))
    if not (torch.isfinite(step1).all() and torch.isfinite(tf_logits).all()):
        raise AssertionError("teacher-forcing logits are not finite")
    if not quant:
        # breakdown of a two-chunk prefill (the self-attention kernel on
        # both chunks, B3 on the second)
        _, prefill_profile = profiled(lambda: eng.prefill_chunked(
            params, prompt[:, :2 * CHUNK], CHUNK)[0])
        emit({"phase": "prefill_profile", "serving": tag,
              "tokens": BATCH * 2 * CHUNK, **prefill_profile})
    tf_err = float((step1 - tf_logits).abs().max())
    tf_argmax = float((step1.argmax(-1) == tf_logits.argmax(-1)).float()
                      .mean())
    gated = cache_dtype != "int4"  # int4: finite logits (checked above)
    if gated:
        check(f"{tag} teacher forcing", tf_err, TEACHER_TOL)
    numbers = {"prefill_s": prefill_s,
               "prefill_tok_per_s": BATCH * PROMPT / prefill_s,
               "decode_ms_per_step": 1e3 * decode_s / NEW,
               "decode_tok_per_s": BATCH * NEW / decode_s,
               "decode_step_device_ms": profile["device_ms"],
               "cache_bytes": n_bytes}
    emit({"phase": tag, "card": card, "model": label, "head_dim": d,
          "window_left": cfg.window_left, "sink_tokens": cfg.sink_tokens,
          "batch": BATCH, "prompt": PROMPT, "chunk": CHUNK,
          "new_tokens": NEW, "cache_dtype": cache_dtype,
          "weight_dtype": "int8", **numbers,
          "teacher_forcing_max_abs_err": tf_err,
          "teacher_tol": TEACHER_TOL if gated else None,
          "teacher_argmax_agree": tf_argmax, "launches": counts})
    if quant:
        return counts, numbers

    # generate over a prompt shorter than the window: with sinks, the band
    # and the sink tile overlap
    gen_eng = Engine(cfg=cfg, s_max=GEN_PROMPT + GEN_NEW,
                     cache_dtype="bfloat16", weight_dtype="int8", device=dev)
    gprompt = prompt[:GEN_BATCH, :GEN_PROMPT]
    build.reset_launch_counts()
    t0 = time.perf_counter()
    res = gen_eng.generate(params, gprompt, GEN_NEW)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    gcounts = expect_counts(build, {
        **idle, own: L, other: 0, kn["flash_fwd_pos"]: 0,
        kn["cache_append"]: L + L * GEN_NEW,
        kn["decode_attention"]: L * GEN_NEW, kn["decode_run"]: 0})
    if not torch.isfinite(res.prefill_logits).all() or res.tokens.shape != (
            GEN_BATCH, GEN_NEW):
        raise AssertionError("generate gave non-finite logits or bad shapes")
    emit({"phase": "generate", "serving": tag, "card": card,
          "batch": GEN_BATCH, "prompt": GEN_PROMPT, "new_tokens": GEN_NEW,
          "cache_dtype": "bfloat16", "weight_dtype": "int8",
          "seconds": gen_s, "launches": gcounts})
    numbers["generate_launches"] = gcounts
    return counts, numbers


# ---------------------------------------------------------------------------
# continuous and paged serving
# ---------------------------------------------------------------------------

QUANT_TAG = {"float8_e4m3fn": "fp8", "int4": "int4"}

# benchmarks/bench_paged.py:160-189: 48 requests, prompts of 1024 or 2048
# tokens from numpy.random.default_rng(0), 64 new tokens each; rows of
# 16384 (the long-tail reservation of a dense engine), step_block 8 and
# host_overlap; the dense engine at 8 rows, the paged one at 32 over a pool
# of the same bytes (8 rows of 16384 in pages of 2048, plus scratch).
CONT_REQUESTS, CONT_PROMPTS, CONT_NEW, CONT_S_MAX = 48, (1024, 2048), 64, 16384
CONT_GATE = 16          # requests the paged engine serves at 8 rows too
FP8_INTERLEAVED = 8     # requests of serve_paged_fp8's interleaved run
CONT_TF_SAMPLE = 4      # requests held to teacher forcing
STEP_BLOCK = 8
# benchmarks/bench_prefix.py:40-75: 8 requests of a shared 16384-token
# system prompt and a 64-token tail, 16 new tokens, 4 rows, pool 50
PREFIX_SYS, PREFIX_TAIL, PREFIX_REQS, PREFIX_NEW = 16384, 64, 8, 16
PREFIX_CHUNK = 256
# benchmarks/bench_paged.py:130-158 at ctx 32768: a 32768-token prompt
# admitted while a 2048-token request decodes (a 1024-token one finishes
# first), batch admission against interleaved
STALL_CTX, STALL_RUNNING, STALL_CHUNK = 32768, (2048, 1024), 256
PROBE = {}


def probe_engine(base):
    """A subclass of an engine class that counts its decode blocks, notes
    whether each ran over a page table, time-stamps each block after a
    sync when PROBE["stamps"] is a list, profiles the block numbered
    PROBE["profile_at"], and keeps each admission's first-token logits;
    when PROBE["logits"] is a dict, it also keeps every decode step's
    logits by request id (the row's request at the block's dispatch)."""

    @dataclasses.dataclass(frozen=True)
    class Probe(base):
        def _decode_block(self, dparams, cache, *a, **kw):
            PROBE["blocks"] += 1
            PROBE["paged"].add(getattr(cache, "page_table", None)
                               is not None)

            def run():
                return base._decode_block(self, dparams, cache, *a, **kw)

            if PROBE.get("profile_at") == PROBE["blocks"]:
                out, PROBE["profile"] = profiled(run)
                return out
            out = run()
            if PROBE.get("stamps") is not None:
                torch.cuda.synchronize()
                PROBE["stamps"].append(time.perf_counter())
            return out

        def _sample_first(self, logits, *a, **kw):
            PROBE["first_logits"].append(logits.float().cpu())
            return base._sample_first(self, logits, *a, **kw)

        def _sample_rows(self, logits, *a, **kw):
            if PROBE.get("logits") is not None:
                PROBE["steps"].append(logits.float().clone())
            return base._sample_rows(self, logits, *a, **kw)

        def _consume(self, nxt, lp, slot, *a, ids=None, **kw):
            # the non-overlapped loops consume each block right after it
            # ran: its steps are the last nxt.shape[1] of PROBE["steps"]
            if PROBE.get("logits") is not None:
                rows = ids if ids is not None else [
                    None if r is None else r.id for r in slot]
                steps = PROBE["steps"][-nxt.shape[1]:]
                for bi, rid in enumerate(rows):
                    if rid is not None:
                        PROBE["logits"].setdefault(rid, []).extend(
                            st[bi] for st in steps)
                PROBE["steps"].clear()
            return base._consume(self, nxt, lp, slot, *a, ids=ids, **kw)

    return Probe


def probe_reset(**kw):
    PROBE.clear()
    PROBE.update(blocks=0, paged=set(), first_logits=[], steps=[], **kw)


def serve_timed(build, eng, params, reqs, **kw):
    """Serve with zeroed launch counts and a fresh probe: (results, wall
    s, tokens, decode steps, launch counts)."""
    probe_reset(**kw)
    build.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = eng.serve(params, reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    toks = sum(len(r.tokens) for r in res.values())
    return res, wall, toks, PROBE["blocks"] * eng.step_block, \
        build.launch_counts()


def expect_serving_counts(tag, counts, L, steps, admissions, b6_runs=0,
                          b7_runs=0, d=128):
    """Every decode step launches L B6 and L B7 (decode_attention, one
    token), every bucket admission L B1 and one B6 (the row's insert, every
    layer at once); multi-token chunks add ``b6_runs`` B6 and ``b7_runs``
    B7 runs (decode_run). ``d``: the model's head dim, whose kernels count
    (at d = 64 the d = 128 kernels launch none)."""
    from long_context_attention_tpu_torch.ops import _build as build

    want = {build.kernel(n, d).name: c for n, c in (
        ("cache_append", L * steps + admissions + b6_runs),
        ("decode_attention", L * steps), ("decode_run", b7_runs),
        ("flash_fwd_causal_self", L * admissions))}
    if d != 128:
        want.update(dict.fromkeys(build.HEAD_DIM_64, 0))
    for name, n in want.items():
        if counts[name] != n:
            raise AssertionError(f"{tag}: {name} launched {counts[name]} "
                                 f"times, expected {n}")
    return want


def run_subruns(decode, n_tok, cfg):
    """The sub-runs of a paged chunk of n_tok tokens (an int8, fp8 or int4
    pool: one storage byte an element, as the tile rule counts) at the
    model's heads (the tile rule's plan), each of which must take B7's run
    kernel, decode_run (decode_route)."""
    hk = cfg.n_kv_heads
    g = cfg.n_heads // hk
    plan = decode.decode_run_plan(n_tok, hk, g, cfg.head_dim, PAGE, 1,
                                  paged=True)
    routes = {decode.decode_route(g * (e - i), bkv, PAGE)
              for i, e, bkv in plan}
    if routes != {"decode_run"}:
        raise AssertionError(f"a chunk of {n_tok}: sub-runs routed to "
                             f"{routes}")
    return len(plan)


def teacher_forced_logprobs(params, cfg, prompt, tokens, dev):
    """log softmax of the bf16 prefill of prompt + tokens[:-1] at each
    generated token (the teacher-forcing reference)."""
    from long_context_attention_tpu_torch.models.llama import forward_local

    seq = torch.tensor([list(prompt) + list(tokens[:-1])], device=dev)
    with torch.no_grad():
        logits = forward_local(params, seq, cfg)[0, len(prompt) - 1:]
    lsm = torch.log_softmax(logits.float(), -1)
    return lsm[torch.arange(len(tokens)), torch.tensor(tokens)].cpu()


def serve_paged_phase(pkg, build, dev, card):
    """serve_continuous and serve_paged: the 0.88B config through
    ContinuousEngine (8 rows) and PagedContinuousEngine (32 rows over the
    same bytes), int8 cache and weights, step_block 8, host_overlap, on
    bench_paged's 48 requests; exact launch counts (every decode step 16
    B6 and 16 B7, paged on the paged engine; 16 B1 per admission); the
    paged engine at 8 rows on the first 16 requests gives the dense
    engine's tokens; a sample of requests passes teacher forcing on its
    logprobs; one decode block each profiled in the untimed warm-up."""
    from long_context_attention_tpu_torch.models.llama import init_params
    from long_context_attention_tpu_torch.serving import (
        ContinuousEngine, PagedContinuousEngine, Request)

    cfg = pkg.ModelConfig(**MODEL)
    L = cfg.n_layers
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = init_params(gen, cfg, device=dev)
    rng = np.random.default_rng(0)
    ctxs = [int(c) for c in rng.choice(list(CONT_PROMPTS), CONT_REQUESTS)]
    reqs = [Request(id=i, tokens=[int(t) for t in
                                  rng.integers(0, cfg.vocab, c)],
                    max_new=CONT_NEW) for i, c in enumerate(ctxs)]
    common = dict(s_max=CONT_S_MAX, cache_dtype="int8", weight_dtype="int8",
                  step_block=STEP_BLOCK, host_overlap=True, device=dev)
    pool = (8 * CONT_S_MAX) // PAGE + 1
    dense = probe_engine(ContinuousEngine)(cfg, max_batch=8, **common)
    paged = probe_engine(PagedContinuousEngine)(
        cfg, max_batch=32, page_size=PAGE, pool_pages=pool, **common)
    out, results = {}, {}
    for tag, eng in (("serve_continuous", dense), ("serve_paged", paged)):
        # warm-up, untimed: its first max_batch requests fill every row,
        # and its decode block 3 runs under the profiler
        probe_reset(profile_at=3)
        eng.serve(params, reqs[:eng.max_batch])
        prof = PROBE["profile"]
        res, wall, toks, steps, counts = serve_timed(build, eng, params,
                                                     reqs)
        results[tag] = res
        if tag == "serve_paged":
            expect_native(tag, eng)
        if sorted(res) != list(range(CONT_REQUESTS)) or any(
                len(r.tokens) != CONT_NEW for r in res.values()):
            raise AssertionError(f"{tag}: not every request completed")
        if PROBE["paged"] != {tag == "serve_paged"}:
            raise AssertionError(f"{tag}: decode blocks over a page table: "
                                 f"{PROBE['paged']}")
        launches = expect_serving_counts(tag, counts, L, steps,
                                         CONT_REQUESTS)
        out[tag] = {"wall_s": wall, "tok_per_s": toks / wall,
                    "tokens": toks, "decode_steps": steps,
                    "launches": launches,
                    "block_profile": {k: prof[k] for k in (
                        "wall_ms", "device_ms", "device_busy_share",
                        "kernel_launches")},
                    "block_top": prof["top"][:6]}
        emit({"phase": tag, "card": card, "model": "llama-0.88B",
              "requests": CONT_REQUESTS, "max_new": CONT_NEW,
              "max_batch": eng.max_batch, "s_max": CONT_S_MAX,
              "cache_dtype": "int8", "weight_dtype": "int8",
              "step_block": STEP_BLOCK, "host_overlap": True,
              **({"page_size": PAGE, "pool_pages": pool}
                 if tag == "serve_paged" else {}), **out[tag]})
        torch.cuda.empty_cache()
    # the paged engine at the dense engine's 8 rows: the same tile, the
    # same splits, so the same tokens; its logprobs against teacher forcing
    gate = probe_engine(PagedContinuousEngine)(
        cfg, max_batch=8, page_size=PAGE, pool_pages=pool,
        return_logprobs=True, **common)
    res, _, _, steps, counts = serve_timed(build, gate, params,
                                           reqs[:CONT_GATE])
    expect_serving_counts("serve_paged at 8 rows", counts, L, steps,
                          CONT_GATE)
    expect_native("serve_paged at 8 rows", gate)
    for i in range(CONT_GATE):
        if res[i].tokens != results["serve_continuous"][i].tokens:
            raise AssertionError(f"request {i}: paged tokens "
                                 f"{res[i].tokens} != dense "
                                 f"{results['serve_continuous'][i].tokens}")
    tf = []
    for i in range(CONT_TF_SAMPLE):
        want = teacher_forced_logprobs(params, cfg, reqs[i].tokens,
                                       res[i].tokens, dev)
        tf.append(float((torch.tensor(res[i].logprobs) - want).abs().max()))
    check("serve_paged teacher forcing (logprobs)", max(tf), TEACHER_TOL)
    emit({"phase": "serve_paged_gate", "card": card,
          "requests": CONT_GATE, "max_batch": 8,
          "tokens_equal_dense": True, "teacher_forcing_max_abs_err": tf,
          "teacher_tol": TEACHER_TOL})
    torch.cuda.empty_cache()
    out.update(serve_paged_fp8(build, cfg, params, reqs, common, pool, card,
                               out["serve_paged"]))
    return out


def serve_paged_fp8(build, cfg, params, reqs, common, pool, card, int8):
    """serve_paged_fp8: serve_paged's workload and engine (32 rows, pages
    of 2048, step_block 8, host_overlap) over an fp8 pool, beside the int8
    run's numbers: B6 writing fp8 rows and B7 on the cast path through the
    page table, exact launch counts. Then the interleaved fp8 run: the
    paged engine at 8 rows on the first FP8_INTERLEAVED requests with
    interleave_admission in chunks of STALL_CHUNK (no host overlap, which
    interleaving does not take), so every admission runs
    the multi-token cast path of B7 (each chunk split by the tile rule)
    over the fp8 pool; exact launch counts, and its logprobs of a sample
    of requests against teacher forcing (TEACHER_TOL)."""
    from long_context_attention_tpu_torch.ops import decode
    from long_context_attention_tpu_torch.serving import PagedContinuousEngine

    L = cfg.n_layers
    fp8 = dict(common, cache_dtype="float8_e4m3fn")
    eng = probe_engine(PagedContinuousEngine)(
        cfg, max_batch=32, page_size=PAGE, pool_pages=pool, **fp8)
    probe_reset()
    eng.serve(params, reqs[:eng.max_batch])  # warm-up, untimed
    res, wall, toks, steps, counts = serve_timed(build, eng, params, reqs)
    if sorted(res) != list(range(CONT_REQUESTS)) or any(
            len(r.tokens) != CONT_NEW for r in res.values()):
        raise AssertionError("serve_paged_fp8: not every request completed")
    expect_native("serve_paged_fp8", eng)
    if PROBE["paged"] != {True}:
        raise AssertionError("serve_paged_fp8: a decode block without the "
                             "page table")
    launches = expect_serving_counts("serve_paged_fp8", counts, L, steps,
                                     CONT_REQUESTS)
    out = {"serve_paged_fp8": {"wall_s": wall, "tok_per_s": toks / wall,
                               "tokens": toks, "decode_steps": steps,
                               "launches": launches}}
    emit({"phase": "serve_paged_fp8", "card": card, "model": "llama-0.88B",
          "requests": CONT_REQUESTS, "max_new": CONT_NEW, "max_batch": 32,
          "s_max": CONT_S_MAX, "cache_dtype": "float8_e4m3fn",
          "weight_dtype": "int8", "step_block": STEP_BLOCK,
          "host_overlap": True, "page_size": PAGE, "pool_pages": pool,
          **out["serve_paged_fp8"],
          "int8_serve_paged": {k: int8[k] for k in ("wall_s", "tok_per_s",
                                                    "tokens")}})
    del eng
    torch.cuda.empty_cache()
    # (interleaved admission does not compose with host_overlap)
    gate = probe_engine(PagedContinuousEngine)(
        cfg, max_batch=8, page_size=PAGE, pool_pages=pool,
        return_logprobs=True, interleave_admission=True,
        prefill_chunk=STALL_CHUNK, **dict(fp8, host_overlap=False))
    subruns = run_subruns(decode, STALL_CHUNK, cfg)
    sub = reqs[:FP8_INTERLEAVED]
    chunks = sum(-(-len(r.tokens) // STALL_CHUNK) for r in sub)
    res, wall, toks, steps, counts = serve_timed(build, gate, params, sub)
    expect_native("serve_paged_fp8 interleaved", gate)
    multi = {"cache_append": L * chunks, "decode_run": L * chunks * subruns}
    launches = expect_serving_counts(
        "serve_paged_fp8 interleaved", counts, L, steps, 0,
        multi["cache_append"], multi["decode_run"])
    tf = []
    for i in range(CONT_TF_SAMPLE):
        want = teacher_forced_logprobs(params, cfg, sub[i].tokens,
                                       res[i].tokens, gate.device)
        tf.append(float((torch.tensor(res[i].logprobs) - want).abs().max()))
    check("serve_paged_fp8 interleaved teacher forcing (logprobs)", max(tf),
          TEACHER_TOL)
    out["fp8_interleaved"] = {"wall_s": wall, "tok_per_s": toks / wall,
                              "chunks": chunks, "subruns_per_chunk": subruns,
                              "launches": launches,
                              "multi_token_launches": multi}
    emit({"phase": "serve_paged_fp8_interleaved", "card": card,
          "requests": FP8_INTERLEAVED, "max_batch": 8,
          "prefill_chunk": STALL_CHUNK, **out["fp8_interleaved"],
          "teacher_forcing_max_abs_err": tf, "teacher_tol": TEACHER_TOL})
    return out


def slice_hd64_phase(pkg, build, dev, card):
    """slice_hd64: the TinyLlama-1.1B-shaped model (head dim 64, 22 layers,
    32 / 4 heads: G = 8) served as the slice serves the 0.88B one
    (serve_phase: Engine(cache_dtype="int8", weight_dtype="int8"),
    prefill_chunked 4 x 8192 in chunks of 2048, 32 decode_scan steps,
    teacher forcing, a bf16-cache generate at b = 2), on the d = 64
    kernels with exact counts and none of the d = 128 ones; then a
    two-chunk prefill and 4 decode steps over an fp8 and an int4 cache (B3
    over those kinds at d = 64), exact counts, finite logits. Returns
    {path: launch counts}."""
    from long_context_attention_tpu_torch.models.llama import init_params
    from long_context_attention_tpu_torch.serving.engine import Engine

    counts, numbers = serve_phase(pkg, build, dev, card, False,
                                  model=TINYLLAMA,
                                  label="TinyLlama-1.1B-shaped",
                                  tag="slice_hd64")
    paths = {"slice_hd64": counts,
             "slice_hd64 generate": numbers["generate_launches"]}
    cfg = pkg.ModelConfig(**TINYLLAMA)
    L, steps = cfg.n_layers, 4
    kn = {n: build.kernel(n, 64).name for n in build.HEAD_DIM_64}
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = init_params(gen, cfg, device=dev)
    prompt = torch.randint(0, cfg.vocab, (BATCH, 2 * CHUNK), generator=gen,
                           device=dev)
    for dt in QUANT_DTYPES:
        eng = Engine(cfg=cfg, s_max=S_MAX, cache_dtype=dt,
                     weight_dtype="int8", device=dev)
        build.reset_launch_counts()
        logits, cache = eng.prefill_chunked(params, prompt, CHUNK)
        toks, cache = eng.decode_scan(eng.decode_params(params), cache,
                                      steps,
                                      torch.argmax(logits, -1).to(
                                          torch.int32))
        torch.cuda.synchronize()
        if not torch.isfinite(logits).all() or toks.shape != (BATCH, steps):
            raise AssertionError(f"slice_hd64 {dt}: non-finite logits or "
                                 f"shapes {tuple(toks.shape)}")
        tag = f"slice_hd64 {QUANT_TAG[dt]}"
        paths[tag] = expect_counts(build, {
            **dict.fromkeys(build.HEAD_DIM_64, 0),
            kn["flash_fwd_causal_self"]: 2 * L, kn["flash_fwd_pos"]: L,
            kn["cache_append"]: 2 * L + L * steps,
            kn["decode_attention"]: L * steps, kn["decode_run"]: 0})
        emit({"phase": tag, "card": card, "cache_dtype": dt,
              "batch": BATCH, "prompt": 2 * CHUNK, "chunk": CHUNK,
              "new_tokens": steps, "launches": paths[tag]})
        del eng, cache, logits
        torch.cuda.empty_cache()
    return paths


HD_REQUESTS, HD_PROMPTS, HD_NEW, HD_S_MAX = 8, (1024, 2048), 16, 4096


def serve_paged_hd64_phase(pkg, build, decode, dev, card):
    """serve_paged_hd64: the TinyLlama-1.1B-shaped model through
    PagedContinuousEngine at 8 rows with interleaved admission (chunks of
    STALL_CHUNK) over int8, fp8 and int4 pages of 2048, int8 weights:
    HD_REQUESTS requests of 1-2K tokens (numpy.random.default_rng(0)), so
    every prompt runs as chunk sub-runs on decode_run at d = 64 (each
    sub-run's route asserted by the tile rule's plan, every launch counted
    exactly), decode steps on one-token B7 at G = 8; int8 and fp8 held to
    teacher forcing on their logprobs (TEACHER_TOL), int4's error
    reported. Returns {path: launch counts}."""
    from long_context_attention_tpu_torch.models.llama import init_params
    from long_context_attention_tpu_torch.serving import (
        PagedContinuousEngine, Request)

    cfg = pkg.ModelConfig(**TINYLLAMA)
    L = cfg.n_layers
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = init_params(gen, cfg, device=dev)
    rng = np.random.default_rng(0)
    reqs = [Request(id=i, tokens=[int(t) for t in rng.integers(
        0, cfg.vocab, int(rng.integers(HD_PROMPTS[0], HD_PROMPTS[1] + 1)))],
        max_new=HD_NEW) for i in range(HD_REQUESTS)]
    subruns = run_subruns(decode, STALL_CHUNK, cfg)
    chunks = sum(-(-len(r.tokens) // STALL_CHUNK) for r in reqs)
    pool = 8 * HD_S_MAX // PAGE + 1
    paths = {}
    for dt in ("int8",) + QUANT_DTYPES:
        eng = probe_engine(PagedContinuousEngine)(
            cfg, max_batch=8, page_size=PAGE, pool_pages=pool,
            return_logprobs=True, interleave_admission=True,
            prefill_chunk=STALL_CHUNK, s_max=HD_S_MAX, cache_dtype=dt,
            weight_dtype="int8", step_block=STEP_BLOCK, host_overlap=False,
            device=dev)
        tag = "serve_paged_hd64" + ("" if dt == "int8"
                                    else f" {QUANT_TAG[dt]}")
        res, wall, toks, steps, counts = serve_timed(build, eng, params,
                                                     reqs)
        expect_native(tag, eng)
        if sorted(res) != list(range(HD_REQUESTS)) or any(
                len(r.tokens) != HD_NEW for r in res.values()):
            raise AssertionError(f"{tag}: not every request completed")
        launches = expect_serving_counts(tag, counts, L, steps, 0, L * chunks,
                                         L * chunks * subruns, d=64)
        paths[tag] = counts
        tf = []
        for i in range(CONT_TF_SAMPLE):
            want = teacher_forced_logprobs(params, cfg, reqs[i].tokens,
                                           res[i].tokens, dev)
            tf.append(float((torch.tensor(res[i].logprobs) - want).abs()
                            .max()))
        if not all(math.isfinite(x) for x in tf):
            raise AssertionError(f"{tag}: non-finite logprobs")
        if dt != "int4":
            check(f"{tag} teacher forcing (logprobs)", max(tf), TEACHER_TOL)
        emit({"phase": tag, "card": card, "model": "TinyLlama-1.1B-shaped",
              "cache_dtype": dt, "weight_dtype": "int8",
              "requests": HD_REQUESTS, "max_new": HD_NEW, "max_batch": 8,
              "s_max": HD_S_MAX, "page_size": PAGE, "pool_pages": pool,
              "prefill_chunk": STALL_CHUNK, "chunks": chunks,
              "subruns_per_chunk": subruns, "wall_s": wall,
              "tok_per_s": toks / wall, "decode_steps": steps,
              "launches": launches, "teacher_forcing_max_abs_err": tf,
              "teacher_tol": None if dt == "int4" else TEACHER_TOL})
        del eng
        torch.cuda.empty_cache()
    return paths


def serve_prefix_phase(pkg, build, decode, dev, card):
    """serve_prefix: bench_prefix's 8 requests (a shared 16384-token system
    prompt + a 64-token tail, 16 new tokens) through PagedContinuousEngine
    at 4 rows, plain against prefix_cache=True: the prefix hit count, the
    suffix chunk's B7 sub-runs (the tile rule's count), exact launch
    counts, and each request's first-token logits within the teacher-
    forcing gate of the plain engine's."""
    from long_context_attention_tpu_torch.models.llama import init_params
    from long_context_attention_tpu_torch.serving import (
        PagedContinuousEngine, Request)

    cfg = pkg.ModelConfig(**MODEL)
    L = cfg.n_layers
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = init_params(gen, cfg, device=dev)
    rng = np.random.default_rng(0)
    system = [int(t) for t in rng.integers(0, cfg.vocab, PREFIX_SYS)]
    reqs = [Request(id=i, tokens=system + [int(t) for t in rng.integers(
        0, cfg.vocab, PREFIX_TAIL)], max_new=PREFIX_NEW)
        for i in range(PREFIX_REQS)]
    prompt = PREFIX_SYS + PREFIX_TAIL
    s_max = ((prompt + PREFIX_NEW + 4095) // 4096) * 4096
    pool = 4 * (s_max // PAGE) + PREFIX_SYS // PAGE + 2
    common = dict(s_max=s_max, max_batch=4, cache_dtype="int8",
                  weight_dtype="int8", step_block=STEP_BLOCK,
                  host_overlap=True, page_size=PAGE, pool_pages=pool,
                  device=dev)
    engines = {"plain": probe_engine(PagedContinuousEngine)(cfg, **common),
               "prefix": probe_engine(PagedContinuousEngine)(
                   cfg, prefix_cache=True, prefill_chunk=PREFIX_CHUNK,
                   **common)}
    # the suffix chunk: min(prefill_chunk, bucket(64)) = 64 tokens, one
    # chunk, split by the tile rule into these sub-runs
    subruns = run_subruns(decode, min(PREFIX_CHUNK, 64), cfg)
    hits_want = (PREFIX_REQS - 1) * PREFIX_SYS
    out, firsts = {}, {}
    for tag, eng in engines.items():
        probe_reset()
        eng.serve(params, reqs[:1])  # warm-up, then the suffix path too
        eng.serve(params, reqs[:2])
        res, wall, toks, steps, counts = serve_timed(build, eng, params,
                                                     reqs)
        expect_native(f"serve_prefix {tag}", eng)
        firsts[tag] = PROBE["first_logits"]
        if tag == "prefix":
            hits = eng.stats["prefix_hit_tokens"]
            if hits != hits_want:
                raise AssertionError(f"prefix hits {hits}, expected "
                                     f"{hits_want}")
            cold, chunks = 1, PREFIX_REQS - 1
        else:
            cold, chunks = PREFIX_REQS, 0
        launches = expect_serving_counts(f"serve_prefix {tag}", counts, L,
                                         steps, cold, L * chunks,
                                         L * chunks * subruns)
        out[tag] = {"wall_s": wall, "tok_per_s": toks / wall,
                    "tokens": toks, "decode_steps": steps,
                    "launches": launches,
                    "multi_token_launches": {
                        "cache_append": L * chunks,
                        "decode_run": L * chunks * subruns},
                    "stats": dict(eng.stats)}
        torch.cuda.empty_cache()
    tf = [float((a - b).abs().max())
          for a, b in zip(firsts["prefix"], firsts["plain"])]
    if len(tf) != PREFIX_REQS:
        raise AssertionError(f"{len(tf)} admissions, expected {PREFIX_REQS}")
    check("serve_prefix first-token logits", max(tf), TEACHER_TOL)
    emit({"phase": "serve_prefix", "card": card, "model": "llama-0.88B",
          "requests": PREFIX_REQS, "system": PREFIX_SYS,
          "tail": PREFIX_TAIL, "max_new": PREFIX_NEW, "max_batch": 4,
          "s_max": s_max, "pool_pages": pool, "prefill_chunk": PREFIX_CHUNK,
          "suffix_subruns": subruns, "prefix_hit_tokens_expected": hits_want,
          "first_logits_max_abs_err": tf, "teacher_tol": TEACHER_TOL,
          **out})
    return out


def serve_stall_phase(pkg, build, decode, dev, card):
    """serve_stall: a 2048-token request decoding while a 32768-token
    prompt is admitted, the running row's largest inter-token gap with
    batch admission and with interleave_admission (chunks of 256), with
    exact launch counts (each interleaved chunk 16 B6 and 16 x its sub-
    runs B7, no B1). The two admissions differ in arithmetic (B1 over bf16
    K/V against the multi-token B7 over the int8 cache), so each run is
    teacher-forced on its own tokens: every step's logits, the first
    token's included, within TEACHER_TOL of a bf16 prefill of the prompt
    and the run's tokens before that step. Where the runs' tokens part,
    the position and both runs' logits of the two tokens are reported."""
    from long_context_attention_tpu_torch.models.llama import (
        forward_local, init_params)
    from long_context_attention_tpu_torch.serving import (
        PagedContinuousEngine, Request)

    cfg = pkg.ModelConfig(**MODEL)
    L = cfg.n_layers
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = init_params(gen, cfg, device=dev)
    rng = np.random.default_rng(0)
    long_prompt = [int(t) for t in rng.integers(0, cfg.vocab, STALL_CTX)]
    reqs = [Request(id=0, tokens=[int(t) for t in rng.integers(
                0, cfg.vocab, STALL_RUNNING[0])],
                    max_new=24 + STALL_CTX // STALL_CHUNK),
            Request(id=1, tokens=[int(t) for t in rng.integers(
                0, cfg.vocab, STALL_RUNNING[1])],
                    max_new=4),
            Request(id=2, tokens=long_prompt, max_new=4)]
    s_cap = ((STALL_CTX + 8191) // 4096) * 4096
    pool = (3 * s_cap) // PAGE + 1
    subruns = run_subruns(decode, STALL_CHUNK, cfg)
    chunks = sum(-(-len(r.tokens) // STALL_CHUNK) for r in reqs)
    out, runs = {}, {}
    for tag, inter in (("batch", False), ("interleaved", True)):
        eng = probe_engine(PagedContinuousEngine)(
            cfg, s_max=s_cap, max_batch=2, cache_dtype="int8",
            weight_dtype="int8", page_size=PAGE, pool_pages=pool,
            interleave_admission=inter, prefill_chunk=STALL_CHUNK,
            device=dev)
        probe_reset()
        eng.serve(params, reqs[:2])  # warm-up
        res, wall, _, steps, counts = serve_timed(build, eng, params, reqs,
                                                  stamps=[], logits={})
        expect_native(f"serve_stall {tag}", eng)
        if sorted(res) != [r.id for r in reqs] or any(
                len(res[r.id].tokens) != r.max_new for r in reqs):
            raise AssertionError(f"serve_stall {tag}: not every request "
                                 f"completed")
        gaps = np.diff(np.asarray(PROBE["stamps"])) * 1e3
        multi = ({"cache_append": L * chunks,
                  "decode_run": L * chunks * subruns} if inter
                 else {"cache_append": 0, "decode_run": 0})
        launches = expect_serving_counts(
            f"serve_stall {tag}", counts, L, steps,
            0 if inter else len(reqs), multi["cache_append"],
            multi["decode_run"])
        if len(PROBE["first_logits"]) != len(reqs):
            raise AssertionError(f"serve_stall {tag}: "
                                 f"{len(PROBE['first_logits'])} admissions")
        # admissions run in request order: the first token's logits, then
        # one decode step's per later token
        runs[tag] = {}
        for r in reqs:
            toks, step_logits = res[r.id].tokens, PROBE["logits"][r.id]
            if len(step_logits) != len(toks) - 1:
                raise AssertionError(f"serve_stall {tag} request {r.id}: "
                                     f"{len(step_logits)} decode steps for "
                                     f"{len(toks)} tokens")
            runs[tag][r.id] = (toks, torch.stack(
                [PROBE["first_logits"][r.id][0].to(dev), *step_logits]))
        out[tag] = {"max_gap_ms": float(gaps.max()),
                    "median_gap_ms": float(np.median(gaps)),
                    "wall_s": wall, "decode_steps": steps,
                    "admissions": len(reqs), "chunks": chunks if inter else 0,
                    "subruns_per_chunk": subruns if inter else 0,
                    "launches": launches, "multi_token_launches": multi}
        del PROBE["logits"]
        torch.cuda.empty_cache()
    # each run against the bf16 prefill of its own prompt + tokens
    tf, parted = {}, {}
    for r in reqs:
        want = {}
        for tag, run in runs.items():
            toks, got = run[r.id]
            seq = torch.tensor([list(r.tokens) + toks[:-1]], device=dev)
            with torch.no_grad():
                want[tag] = forward_local(params, seq, cfg)[
                    0, len(r.tokens) - 1:].float()
            err = (got - want[tag]).abs().amax(-1)
            top2 = want[tag].topk(2, dim=-1).values
            tf[f"{r.id} {tag}"] = {
                "max_abs_err": float(err.max()), "at": int(err.argmax()),
                "first_token": float(err[0]),
                # how near the teacher's greedy choices are to ties
                "teacher_top2_margin_median": float(
                    (top2[:, 0] - top2[:, 1]).median())}
            check(f"serve_stall request {r.id} teacher forcing ({tag})",
                  float(err.max()), TEACHER_TOL)
        (a, la), (b, lb) = runs["batch"][r.id], runs["interleaved"][r.id]
        j = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if j is not None:
            # both runs' prefixes agree up to j, and so do their teachers
            tj = want["batch"][j]
            top2 = tj.topk(2).values
            parted[r.id] = {
                "position": j, "tokens": [a[j], b[j]],
                "teacher_logits": [float(tj[a[j]]), float(tj[b[j]])],
                "teacher_top2_margin": float(top2[0] - top2[1]),
                "batch_logits": [float(la[j, a[j]]), float(la[j, b[j]])],
                "interleaved_logits": [float(lb[j, a[j]]),
                                       float(lb[j, b[j]])],
                "runs_max_abs_diff_to_j": [
                    float((la[i] - lb[i]).abs().max()) for i in range(j + 1)]}
    emit({"phase": "serve_stall", "card": card, "model": "llama-0.88B",
          "ctx": STALL_CTX, "pool_pages": pool, "page_size": PAGE,
          "prefill_chunk": STALL_CHUNK, "cache_dtype": "int8",
          "weight_dtype": "int8", "teacher_forcing": tf,
          "teacher_tol": TEACHER_TOL, "tokens_equal": not parted,
          "parted": parted, **out})
    return out

# ---------------------------------------------------------------------------
# phase 4c: rolling window pages and speculative serving
# ---------------------------------------------------------------------------

# serve_windowed_paged: the slice_windowed model (WINDOWED) through
# PagedContinuousEngine, int8 cache and weights, pages of 2048, 8 rows,
# step_block 8, no host overlap. 12 requests of 64 new tokens, half with
# prompts of 10225-10231 tokens, half of 8186-8191 (numpy seed 0). A 10K
# row is admitted with 5 pages (= _rolling_pages(); a prompt of 10232 or
# more would take 6 and grow only past 12288), frees logical pages 1 and 2
# behind its window and grows into page 5 within its 64 tokens; an 8K row
# frees page 1. The pool is 8 rows' rolling pages + the scratch page, the
# admission gate's minimum, so freed pages go to other rows' growth and
# admissions.
WPAGED_REQS, WPAGED_NEW, WPAGED_S_MAX = 12, 64, 12288
WPAGED_PROMPTS = ((10225, 10232), (8186, 8192))
WPAGED_CHUNK = 2048
WATCH = {}


class PageWatch:
    """Wraps a page allocator: each admission (take) opens a record of its
    row's pages, updated by the row's growth (take_extra) and releases
    (release_pages), so a row's holding is read off the allocator's own
    answers. With ``poison``, every released page is overwritten at once,
    in every layer of the pool, with large finite values (127 with scales
    of 1e4): a kernel that visited such a page inside a row's walk would
    change the tokens (NaN would be wrong: a reused page's unwritten tail
    sits masked inside its new owner's last tile, and a NaN there is not
    masked out of PV)."""

    def __init__(self, alloc, poison):
        self._alloc, self._poison = alloc, poison
        self._rows = {}

    def __getattr__(self, name):
        return getattr(self._alloc, name)

    def take(self, bi, need):
        pages = self._alloc.take(bi, need)
        rec = {"row": bi, "held": need, "max_held": need, "released": 0,
               "grown": 0}
        self._rows[bi] = rec
        WATCH["records"].append(rec)
        return pages

    def take_extra(self, bi, need):
        pages = self._alloc.take_extra(bi, need)
        rec = self._rows[bi]
        rec["held"] += need
        rec["grown"] += need
        rec["max_held"] = max(rec["max_held"], rec["held"])
        return pages

    def release_pages(self, bi, pages):
        self._alloc.release_pages(bi, pages)
        rec = self._rows[bi]
        rec["held"] -= len(pages)
        rec["released"] += len(pages)
        if self._poison:
            cache = WATCH["cache"]
            idx = torch.tensor(pages, device=cache.k.device)
            for t in (cache.k, cache.v):
                t[:, idx] = 127
            for t in (cache.k_scale, cache.v_scale):
                t[:, idx] = 1e4
            WATCH["poisoned"] += len(pages)


def watched_engine(base, poison=False, whole_span=False):
    """probe_engine(base) whose allocator is a PageWatch; ``whole_span``
    turns the rolling window pages off (whole-span reservations, as JAX's
    tests/test_paged.py:455 reference does)."""
    probe = probe_engine(base)

    @dataclasses.dataclass(frozen=True)
    class Watched(probe):
        @property
        def _windowed_paging(self):
            return not whole_span and base._windowed_paging.fget(self)

        def init_cache(self):
            WATCH["cache"] = probe.init_cache(self)
            return WATCH["cache"]

        def _make_alloc(self):
            return PageWatch(probe._make_alloc(self), poison)

    return Watched


def watch_reset():
    WATCH.clear()
    WATCH.update(records=[], poisoned=0)


def serve_windowed_paged_phase(pkg, build, decode, dev, card):
    """serve_windowed_paged: rolling window pages at the 0.88B widths with
    window 4096 and 4 sinks (WPAGED_*). Gates: the tokens equal, request
    for request, the same engine's with whole-span reservations over 49
    pages (the same kernels, tiles and splits; only the physical pages
    differ); no row holds more than _rolling_pages() pages at once; a run
    that poisons every page at its release gives the same tokens; every
    row reclaims a page and every 10K row grows one; exact launch counts
    (every admission 16 B4 and one B6, every decode step 16 B6 and 16
    one-token B7 over page tables that change mid-serve); the native
    allocator. Then the same requests admitted interleaved in chunks of
    2048 (each chunk 16 B6 and 16 x its sub-runs on decode_run with the
    window and sinks), teacher-forced on their own tokens as serve_stall's
    interleaved run is, with the first place they part from the batch
    run's tokens reported."""
    from long_context_attention_tpu_torch.models.llama import (
        forward_local, init_params)
    from long_context_attention_tpu_torch.serving import (
        PagedContinuousEngine, Request)

    cfg = pkg.ModelConfig(**MODEL, **WINDOWED)
    L = cfg.n_layers
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = init_params(gen, cfg, device=dev)
    rng = np.random.default_rng(0)
    lens = [int(rng.integers(*WPAGED_PROMPTS[i % 2]))
            for i in range(WPAGED_REQS)]
    reqs = [Request(id=i, tokens=[int(t) for t in rng.integers(
        0, cfg.vocab, n)], max_new=WPAGED_NEW) for i, n in enumerate(lens)]
    common = dict(s_max=WPAGED_S_MAX, max_batch=8, cache_dtype="int8",
                  weight_dtype="int8", step_block=STEP_BLOCK,
                  page_size=PAGE, device=dev)
    rolling = PagedContinuousEngine(cfg, pool_pages=2,
                                    **common)._rolling_pages()
    pool = 8 * rolling + 1
    whole_pool = 8 * (WPAGED_S_MAX // PAGE) + 1
    runs, out, paths = {}, {}, {}
    # warm-up, untimed: the windowed engine on two requests
    watch_reset()
    probe_reset()
    watched_engine(PagedContinuousEngine)(cfg, pool_pages=pool,
                                          **common).serve(params, reqs[:2])
    for tag, kw in (
            ("windowed", dict(pool_pages=pool)),
            ("whole_span", dict(pool_pages=whole_pool, whole_span=True)),
            ("poisoned", dict(pool_pages=pool, poison=True)),
            ("interleaved", dict(pool_pages=pool, interleave_admission=True,
                                 prefill_chunk=WPAGED_CHUNK))):
        flags = {k: kw.pop(k) for k in ("whole_span", "poison") if k in kw}
        eng = watched_engine(PagedContinuousEngine, **flags)(cfg, **common,
                                                             **kw)
        watch_reset()
        inter = tag == "interleaved"
        res, wall, toks, steps, counts = serve_timed(
            build, eng, params, reqs, **({"logits": {}} if inter else {}))
        if sorted(res) != list(range(WPAGED_REQS)) or any(
                len(r.tokens) != WPAGED_NEW for r in res.values()):
            raise AssertionError(f"serve_windowed_paged {tag}: not every "
                                 f"request completed")
        expect_native(f"serve_windowed_paged {tag}", eng)
        if eng._windowed_paging == (tag == "whole_span"):
            raise AssertionError(f"serve_windowed_paged {tag}: rolling "
                                 f"pages {eng._windowed_paging}")
        recs = WATCH["records"]
        if len(recs) != WPAGED_REQS:
            raise AssertionError(f"serve_windowed_paged {tag}: "
                                 f"{len(recs)} admissions")
        held = max(r["max_held"] for r in recs)
        limit = WPAGED_S_MAX // PAGE if tag == "whole_span" else rolling
        if held > limit:
            raise AssertionError(f"serve_windowed_paged {tag}: a row held "
                                 f"{held} pages, more than {limit}")
        if tag != "whole_span":
            for r, rec in zip(reqs, recs):
                long_row = len(r.tokens) >= WPAGED_PROMPTS[0][0]
                if rec["released"] < 1 or (long_row and rec["grown"] < 1):
                    raise AssertionError(
                        f"serve_windowed_paged {tag}: request {r.id} "
                        f"({len(r.tokens)} tokens) released "
                        f"{rec['released']} and grew {rec['grown']} pages")
        if inter:
            chunks = sum(-(-len(r.tokens) // WPAGED_CHUNK) for r in reqs)
            subruns = run_subruns(decode, WPAGED_CHUNK, cfg)
            multi = {"cache_append": L * chunks,
                     "decode_run": L * chunks * subruns}
            admissions = 0
        else:
            chunks, subruns = 0, 0
            multi = {"cache_append": 0, "decode_run": 0}
            admissions = WPAGED_REQS
        want = {"cache_append": L * steps + admissions
                + multi["cache_append"],
                "decode_attention": L * steps,
                "decode_run": multi["decode_run"],
                "flash_fwd_static": L * admissions,
                "flash_fwd_causal_self": 0}
        launches = expect_counts(build, want)
        runs[tag] = res
        paths[f"serve_windowed_paged {tag}"] = launches
        out[tag] = {"wall_s": wall, "tok_per_s": toks / wall,
                    "decode_steps": steps, "pool_pages": eng.pool_pages,
                    "max_pages_held": held,
                    "pages_released": sum(r["released"] for r in recs),
                    "pages_grown": sum(r["grown"] for r in recs),
                    "pages_poisoned": WATCH["poisoned"],
                    "chunks": chunks, "subruns_per_chunk": subruns,
                    "launches": {k: launches[k] for k in want},
                    "multi_token_launches": multi}
        if inter:
            step_logits = {rid: torch.stack(v) for rid, v in
                           PROBE["logits"].items()}
            del PROBE["logits"]
        torch.cuda.empty_cache()
    base = runs["windowed"]
    for tag in ("whole_span", "poisoned"):
        for r in reqs:
            if runs[tag][r.id].tokens != base[r.id].tokens:
                raise AssertionError(
                    f"serve_windowed_paged: request {r.id}'s tokens "
                    f"{base[r.id].tokens} != the {tag} run's "
                    f"{runs[tag][r.id].tokens}")
    # the interleaved run against the bf16 prefill of its own tokens, and
    # where it parts from the batch run
    tf, parted = [], {}
    for r in reqs:
        toks = runs["interleaved"][r.id].tokens
        seq = torch.tensor([list(r.tokens) + toks[:-1]], device=dev)
        with torch.no_grad():
            teacher = forward_local(params, seq, cfg)[
                0, len(r.tokens) - 1:].float()
        # a block runs on past a row's last token: its later steps' logits
        # are not the request's
        got = torch.cat([PROBE["first_logits"][r.id].to(dev),
                         step_logits[r.id][:len(toks) - 1]])
        tf.append(float((got - teacher).abs().max()))
        a = base[r.id].tokens
        j = next((j for j, (x, y) in enumerate(zip(a, toks)) if x != y),
                 None)
        if j is not None:
            parted[r.id] = {"position": j, "tokens": [a[j], toks[j]],
                            "teacher_logits": [float(teacher[j, a[j]]),
                                               float(teacher[j, toks[j]])]}
    check("serve_windowed_paged interleaved teacher forcing", max(tf),
          TEACHER_TOL)
    emit({"phase": "serve_windowed_paged", "card": card,
          "model": "llama-0.88B", "window_left": WINDOW,
          "sink_tokens": SINKS, "requests": WPAGED_REQS,
          "prompt_lens": lens, "max_new": WPAGED_NEW,
          "s_max": WPAGED_S_MAX, "page_size": PAGE, "max_batch": 8,
          "step_block": STEP_BLOCK, "rolling_pages": rolling,
          "cache_dtype": "int8", "weight_dtype": "int8",
          "allocator": "native", "tokens_equal_whole_span": True,
          "tokens_equal_poisoned": True,
          "interleaved_teacher_forcing_max_abs_err": tf,
          "teacher_tol": TEACHER_TOL,
          "interleaved_tokens_equal_batch": not parted,
          "interleaved_parted": parted, **out})
    return paths


# serve_speculative: the 0.88B target (int8 cache and weights, gamma 4)
# with a draft of the same family at a quarter of its width and depth (the
# card's kernels take head_dim 128 only, so the draft keeps it: dim 1024, 4
# layers, 8/4 heads), random weights from seed 1; bench_paged.py's first
# 16 requests (prompts of 1024 or 2048 tokens) with 32 new tokens each
SPEC_DRAFT = dict(vocab=32000, dim=1024, n_layers=4, n_heads=8,
                  n_kv_heads=4, head_dim=128, ffn_hidden=int(1024 * 2.7),
                  layout="basic")
SPEC_GAMMA, SPEC_REQS, SPEC_NEW, SPEC_S_MAX = 4, 16, 32, 4096
SPEC_DENSE, SPEC_SELF, SPEC_SAMPLED = 8, 8, 4
SPEC_GEN_BATCH, SPEC_GEN_NEW = 2, 16
# a broken verify accepts about nothing; a self-draft on the card accepts
# all but the near-ties of its one-token and run kernels
SELF_DRAFT_MIN = 0.75


def spec_subruns(decode, cfg, n_tok, slot_dim, paged):
    """The sub-runs of a verify run of n_tok tokens (the tile rule's plan),
    each of which must take B7's run kernel, decode_run."""
    hk, g = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    plan = decode.decode_run_plan(n_tok, hk, g, cfg.head_dim, slot_dim, 1,
                                  paged=paged)
    routes = {decode.decode_route(g * (e - i), bkv, slot_dim)
              for i, e, bkv in plan}
    if routes != {"decode_run"}:
        raise AssertionError(f"a verify run of {n_tok}: sub-runs routed to "
                             f"{routes}")
    return len(plan)


def spec_counts(tag, counts, rounds, admissions, Lt, Ld, subruns,
                prefill_b6):
    """Every round: gamma + 1 draft steps of one B6 and one one-token B7 a
    draft layer, and the verify's B6 and B7 sub-runs (decode_run) a target
    layer; every admission the target's and the draft's prefill (B1 a
    layer) and their B6 inserts (``prefill_b6`` of them)."""
    steps = SPEC_GAMMA + 1
    want = {"cache_append": rounds * (steps * Ld + Lt)
            + admissions * prefill_b6,
            "decode_attention": rounds * steps * Ld,
            "decode_run": rounds * Lt * subruns,
            "flash_fwd_causal_self": admissions * (Lt + Ld),
            "flash_fwd_static": 0, "flash_fwd_pos": 0}
    for name, n in want.items():
        if counts[name] != n:
            raise AssertionError(f"serve_speculative {tag}: {name} launched "
                                 f"{counts[name]} times, expected {n} "
                                 f"({rounds} rounds, {admissions} "
                                 f"admissions)")
    return want


def target_greedy_gaps(params, cfg, prompt, tokens, dev):
    """max over the emitted tokens of (the bf16 teacher's largest logit -
    its logit of the emitted token), the teacher a prefill of prompt + the
    tokens before each one; and the position of the largest gap."""
    from long_context_attention_tpu_torch.models.llama import forward_local

    seq = torch.tensor([list(prompt) + list(tokens[:-1])], device=dev)
    with torch.no_grad():
        logits = forward_local(params, seq, cfg)[0, len(prompt) - 1:].float()
    gap = logits.max(-1).values - logits[torch.arange(len(tokens)),
                                         torch.tensor(tokens)]
    return float(gap.max()), int(gap.argmax())


def serve_speculative_phase(pkg, build, decode, dev, card):
    """serve_speculative: (a) PagedSpeculativeContinuousEngine (pages of
    2048, 8 rows) on SPEC_REQS requests, (b) SpeculativeContinuousEngine on
    the first SPEC_DENSE of them, (c) a self-draft (the target drafts for
    itself) on SPEC_SELF, (d) SpeculativeEngine.generate at b=2, (e) a
    sampled paged run (temperature 1.0) on SPEC_SAMPLED. Gates: every
    greedy token is target-greedy (its bf16 teacher's logit within
    TEACHER_TOL of the row's largest); (a) and (b) give the same tokens;
    the self-draft accepts at least SELF_DRAFT_MIN of its drafts; the
    sampled run completes within the vocabulary; exact launch counts per
    round and admission; the native allocator on the paged runs. Rounds,
    drafted and accepted tokens, tok/s and acceptance per run."""
    from long_context_attention_tpu_torch.models.llama import init_params
    from long_context_attention_tpu_torch.serving import (
        PagedSpeculativeContinuousEngine, Request, SamplingParams,
        SpeculativeContinuousEngine, SpeculativeEngine)

    cfg = pkg.ModelConfig(**MODEL)
    dcfg = pkg.ModelConfig(**SPEC_DRAFT)
    Lt, Ld = cfg.n_layers, dcfg.n_layers
    params = init_params(torch.Generator(device=dev).manual_seed(SEED), cfg,
                         device=dev)
    dparams = init_params(torch.Generator(device=dev).manual_seed(SEED + 1),
                          dcfg, device=dev)
    rng = np.random.default_rng(0)
    ctxs = [int(c) for c in rng.choice(list(CONT_PROMPTS), CONT_REQUESTS)]
    reqs = [Request(id=i, tokens=[int(t) for t in
                                  rng.integers(0, cfg.vocab, c)],
                    max_new=SPEC_NEW)
            for i, c in enumerate(ctxs)][:SPEC_REQS]
    common = dict(s_max=SPEC_S_MAX, max_batch=8, cache_dtype="int8",
                  weight_dtype="int8", gamma=SPEC_GAMMA, device=dev)
    paged_kw = dict(page_size=PAGE, pool_pages=8 * (SPEC_S_MAX // PAGE) + 1)
    n_run = SPEC_GAMMA + 1
    sub_paged = spec_subruns(decode, cfg, n_run, PAGE, True)
    sub_dense = spec_subruns(decode, cfg, n_run, SPEC_S_MAX, False)
    runs, out, paths = {}, {}, {}
    greedy = SamplingParams()
    for tag, eng, dp, sub, sub_reqs, sampling in (
            ("paged", PagedSpeculativeContinuousEngine(
                cfg, draft_cfg=dcfg, **paged_kw, **common), dparams,
             sub_paged, reqs, greedy),
            ("dense", SpeculativeContinuousEngine(
                cfg, draft_cfg=dcfg, **common), dparams, sub_dense,
             reqs[:SPEC_DENSE], greedy),
            ("self_draft", PagedSpeculativeContinuousEngine(
                cfg, draft_cfg=cfg, **paged_kw, **common), params,
             sub_paged, reqs[:SPEC_SELF], greedy),
            ("sampled", PagedSpeculativeContinuousEngine(
                cfg, draft_cfg=dcfg, **paged_kw, **common), dparams,
             sub_paged, reqs[:SPEC_SAMPLED],
             SamplingParams(temperature=1.0))):
        build.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = eng.serve(params, dp, sub_reqs, sampling=sampling, seed=SEED)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = build.launch_counts()
        if sorted(res) != [r.id for r in sub_reqs] or any(
                len(res[r.id].tokens) != r.max_new for r in sub_reqs):
            raise AssertionError(f"serve_speculative {tag}: not every "
                                 f"request completed")
        if tag != "dense":
            expect_native(f"serve_speculative {tag}", eng)
        st = dict(eng.round_stats)
        ld = cfg.n_layers if tag == "self_draft" else Ld
        launches = spec_counts(tag, counts, st["rounds"], len(sub_reqs), Lt,
                               ld, sub, 2)
        toks = sum(len(r.tokens) for r in res.values())
        runs[tag] = res
        paths[f"serve_speculative {tag}"] = counts
        out[tag] = {"requests": len(sub_reqs), **st,
                    "acceptance": st["accepted"] / st["drafted"],
                    "wall_s": wall, "tok_per_s": toks / wall,
                    "tokens": toks, "verify_subruns": sub,
                    "launches": launches}
        del eng
        torch.cuda.empty_cache()
    if any(t < 0 or t >= cfg.vocab for r in runs["sampled"].values()
           for t in r.tokens):
        raise AssertionError("serve_speculative sampled: a token outside "
                             "the vocabulary")
    if out["self_draft"]["acceptance"] < SELF_DRAFT_MIN:
        raise AssertionError(f"serve_speculative: self-draft acceptance "
                             f"{out['self_draft']['acceptance']} < "
                             f"{SELF_DRAFT_MIN}")
    # (d) SpeculativeEngine.generate at b=2 (Engine.prefill: B1 and one B6
    # a layer of each model)
    spec = SpeculativeEngine(cfg, dcfg, s_max=SPEC_S_MAX, gamma=SPEC_GAMMA,
                             cache_dtype="int8", weight_dtype="int8",
                             device=dev)
    short = min(len(r.tokens) for r in reqs)
    prompt = torch.tensor([r.tokens[:short] for r in
                           reqs[:SPEC_GEN_BATCH]], device=dev)
    build.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gres = spec.generate(params, dparams, prompt, SPEC_GEN_NEW)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = build.launch_counts()
    launches = spec_counts("generate", counts, gres.rounds, 1, Lt, Ld,
                           sub_dense, Lt + Ld)
    paths["serve_speculative generate"] = counts
    out["generate"] = {"batch": SPEC_GEN_BATCH, "prompt": short,
                       "max_new": SPEC_GEN_NEW, "rounds": gres.rounds,
                       "drafted": gres.drafted, "accepted": gres.accepted,
                       "acceptance": gres.accepted / gres.drafted,
                       "wall_s": wall,
                       "tok_per_s": SPEC_GEN_BATCH * SPEC_GEN_NEW / wall,
                       "launches": launches}
    # every greedy token target-greedy under the bf16 teacher
    gaps = {}
    for tag in ("paged", "dense", "self_draft"):
        for r in reqs:
            if r.id in runs[tag]:
                gaps[f"{tag} {r.id}"] = target_greedy_gaps(
                    params, cfg, r.tokens, runs[tag][r.id].tokens, dev)
    for i in range(SPEC_GEN_BATCH):
        gaps[f"generate {i}"] = target_greedy_gaps(
            params, cfg, prompt[i].tolist(), gres.tokens[i].tolist(), dev)
    worst = max(gaps, key=lambda k: gaps[k][0])
    check(f"serve_speculative target-greedy ({worst} at "
          f"{gaps[worst][1]})", gaps[worst][0], TEACHER_TOL)
    # the paged and the dense engine on their shared requests
    for r in reqs[:SPEC_DENSE]:
        a, b = runs["paged"][r.id].tokens, runs["dense"][r.id].tokens
        j = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if j is not None:
            seq = torch.tensor([list(r.tokens) + a[:j]], device=dev)
            from long_context_attention_tpu_torch.models.llama import (
                forward_local)
            with torch.no_grad():
                t = forward_local(params, seq, cfg)[0, -1].float()
            raise AssertionError(
                f"serve_speculative: request {r.id}'s paged and dense tokens "
                f"part at {j}: {a[j]} (teacher logit {float(t[a[j]])}) "
                f"against {b[j]} ({float(t[b[j]])})")
    emit({"phase": "serve_speculative", "card": card,
          "model": "llama-0.88B", "draft": SPEC_DRAFT, "gamma": SPEC_GAMMA,
          "max_new": SPEC_NEW, "s_max": SPEC_S_MAX, "page_size": PAGE,
          "max_batch": 8, "cache_dtype": "int8", "weight_dtype": "int8",
          "target_greedy_max_gap": gaps[worst][0], "worst": worst,
          "teacher_tol": TEACHER_TOL, "paged_tokens_equal_dense": True,
          "self_draft_min": SELF_DRAFT_MIN, **out})
    return paths

# ---------------------------------------------------------------------------
# phase 5: the training slice
# ---------------------------------------------------------------------------


def train_batch(vocab, seq, dev):
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    tokens = torch.randint(0, vocab, (1, seq), generator=gen, device=dev)
    return tokens, torch.roll(tokens, -1, dims=1), torch.ones(
        (1, seq), dtype=torch.float32, device=dev)


def train_phase(pkg, build, dev, card, impl="pallas", plan=TRAIN_STEPS,
                windowed=False, model=None, tag=None):
    """make_train_step on ``model`` (the 0.88B config by default) at b=1,
    s=8192 with attention ``impl`` (pallas: B1 forward; sage: B8a and its
    quantization kernels; B5 backward for both; ``windowed``: pallas with
    WINDOWED, B4 forward and B5 over the band and the sink tiles): one
    warm-up step, then timed steps on the same batch under each remat
    policy of ``plan``, each step's launch counts checked exactly (those
    kernels at the model's head dim, no other kernel). Returns the counts
    of the `none` run."""
    from long_context_attention_tpu_torch.models.llama import (
        init_params, make_train_step, param_leaves)

    model = model or MODEL
    L, d = model["n_layers"], model["head_dim"]
    fwd = FORWARD_KERNEL[impl]
    shape, phase = {}, tag or ("train" if impl == "pallas" else "train_sage")
    if windowed:
        shape, phase = WINDOWED, "train_windowed"
        fwd = "flash_fwd_static"
    tokens, labels, mask = train_batch(model["vocab"], TRAIN_SEQ, dev)
    opt = functools.partial(torch.optim.AdamW, lr=LR,
                            weight_decay=WEIGHT_DECAY)
    main_counts = None
    for remat, steps in plan:
        cfg = pkg.ModelConfig(**model, **shape, remat=remat, attn_impl=impl)
        params = init_params(torch.Generator(device=dev).manual_seed(SEED),
                             cfg, device=dev)
        n_params = sum(t.numel() for t in param_leaves(params))
        step = make_train_step(cfg, opt, device=dev)
        params, state, loss = step(params, None, tokens, labels, mask)
        losses = [float(loss)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        build.reset_launch_counts()
        times = []
        for _ in range(steps):
            t0 = time.perf_counter()
            params, state, loss = step(params, state, tokens, labels, mask)
            losses.append(float(loss))  # synchronizes
            times.append(time.perf_counter() - t0)
        n_fwd = steps * L * (2 if remat == "full" else 1)
        counts = exact_counts(build, {
            fwd: n_fwd, "flash_bwd_fused": steps * L,
            **quant_counts(n_fwd if impl == "sage" else 0)}, d)
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"remat={remat}: loss not finite: {losses}")
        if remat == "none":
            main_counts = counts
            if not losses[-1] < losses[0]:
                raise AssertionError(f"the loss did not fall: {losses}")
        # the whole timed window over its steps; the spread beside it
        ms = 1e3 * sum(times) / steps
        flops = 6 * TRAIN_SEQ * n_params  # the 6ND convention
        emit({"phase": phase, "card": card, "attn_impl": impl,
              **shape, "remat": remat, "batch": 1, "head_dim": d,
              "seq": TRAIN_SEQ, "params": n_params, "steps": steps,
              "ms_per_step": ms, "ms_min": 1e3 * min(times),
              "ms_max": 1e3 * max(times), "ms_all": [1e3 * t for t in times],
              "tok_per_s": TRAIN_SEQ / (ms / 1e3),
              "tflops_6nd": flops / (ms / 1e3) / 1e12,
              "mfu": flops / (ms / 1e3) / PEAK_BF16_FLOPS,
              "max_memory_allocated_gb":
                  torch.cuda.max_memory_allocated() / 2 ** 30,
              "losses": losses, "launches_per_step":
                  {n: c // steps for n, c in counts.items() if c}})
        if remat == "none":
            _, prof = profiled(lambda: step(params, state, tokens, labels,
                                            mask)[2])
            emit({"phase": "train_profile", "of": phase, "attn_impl": impl,
                  **shape, "remat": remat, **prof})
        del params, state, step, loss
        torch.cuda.empty_cache()
    return main_counts


def named_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from named_leaves(v, f"{prefix}{k}/")
    else:
        yield prefix.rstrip("/"), tree


def grad_check_phase(pkg, build, dev, card, impl="pallas",
                     remats=("none", "attn", "full"), shape=None,
                     model=None, tag="grad_check"):
    """The loss and every parameter gradient of loss_local with attention
    ``impl`` on the card (kernels) under each remat policy against the same
    backward on CPU copies without remat (plain versions), at 2 layers of
    ``model`` (the 0.88B config by default), full width, b=1, s=1024, each
    card run's forward kernel (B1 or B8a; B4 with a ``shape``:
    GRAD_WINDOWED's window, sinks and softcap) and B5 launches checked
    exactly (at the model's head dim, no other kernel)."""
    from long_context_attention_tpu_torch.models.llama import (
        init_params, loss_local)

    model = model or MODEL
    d = model["head_dim"]
    fwd = "flash_fwd_static" if shape else FORWARD_KERNEL[impl]
    cfg = pkg.ModelConfig(**{**model, "n_layers": GRAD_LAYERS},
                          **(shape or {}), attn_impl=impl)
    params = init_params(torch.Generator(device=dev).manual_seed(SEED), cfg,
                         device=dev)
    tokens, labels, mask = train_batch(cfg.vocab, GRAD_SEQ, dev)

    def loss_and_grads(where, remat):
        def leaf(t):
            return t.detach().to(where, copy=True).requires_grad_()

        p = {k: ({kk: leaf(vv) for kk, vv in v.items()}
                 if isinstance(v, dict) else leaf(v))
             for k, v in params.items()}
        loss = loss_local(p, tokens.to(where), labels.to(where),
                          mask.to(where),
                          dataclasses.replace(cfg, remat=remat))
        loss.backward()
        return float(loss.detach()), {n: t.grad.float().cpu()
                                      for n, t in named_leaves(p)}

    loss_cpu, g_cpu = loss_and_grads(torch.device("cpu"), "none")
    for remat in remats:
        build.reset_launch_counts()
        loss_card, g_card = loss_and_grads(dev, remat)
        n_fwd = GRAD_LAYERS * (2 if remat == "full" else 1)
        counts = exact_counts(build, {
            fwd: n_fwd, "flash_bwd_fused": GRAD_LAYERS,
            **quant_counts(n_fwd if impl == "sage" else 0)}, d)
        leaves = {}
        for n, want in g_cpu.items():
            size = float(want.abs().max())
            leaves[n] = {"rel_err": float((g_card[n] - want).abs().max())
                         / size, "max_abs": size,
                         "mean_abs": float(want.abs().mean())}
        worst = max(x["rel_err"] for x in leaves.values())
        emit({"phase": tag, "card": card, "attn_impl": impl,
              **(shape or {}), "remat": remat, "layers": GRAD_LAYERS,
              "seq": GRAD_SEQ, "head_dim": d,
              "loss_card": loss_card,
              "loss_cpu": loss_cpu, "loss_tol": LOSS_TOL,
              "grad_tol": GRAD_TOL, "worst_rel_err": worst,
              "launches": {n: c for n, c in counts.items() if c},
              "leaves": leaves})
        what = f"{tag} {impl}{' windowed' if shape else ''} remat={remat}"
        check(f"{what} loss", abs(loss_card - loss_cpu), LOSS_TOL)
        for n, x in leaves.items():
            check(f"{what} {n} (relative to its largest value)",
                  x["rel_err"], GRAD_TOL)


# The dense ring's descriptors: a W=4 ring at the 0.88B attention width
# (b=1, 16/8 heads, d=128), a local length of 8192 (s = 32768). Each case
# is one (layout, rank, step) call that ring_attention_local makes, its
# kwargs built by the ring's own parallel/ring.py ring_step_kwargs.
RING_W, RING_LOCAL = 4, 8192
RING_CASES = (
    # two q chunks and two kv chunks; q chunk 0 sees none of them
    ("zigzag rank 1 step 2", dict(layout="zigzag"), 1, 2),
    # src 2 > rank 1: q row 0 sees no key (dead rows for the whole step)
    ("stripe rank 1 src 2", dict(layout="stripe"), 1, 3),
    # kv halves from ranks 0 and 2, one two-chunk descriptor
    ("bidirectional basic rank 1 step 1",
     dict(layout="basic", bidirectional=True), 1, 1),
    # src 0 holds the sinks: q chunk 1 sees only them
    ("zigzag rank 1 step 1 window sinks",
     dict(layout="zigzag", window=(WINDOW, -1), sink=SINKS), 1, 1),
)


def ring_case_kwargs(ring, tag, fields, rank, step):
    """(Positions, mask kwargs) of one RING_CASES entry, from the ring's
    own descriptors (parallel/ring.py ring_step_kwargs)."""
    from long_context_attention_tpu_torch.ops.flash import Positions

    cfg = ring.RingConfig(ring_size=RING_W, causal=True, **fields)
    kw = ring.ring_step_kwargs(cfg, rank, step, RING_LOCAL, RING_LOCAL)
    pos = Positions(tuple(kw["q_offsets"]), tuple(kw["kv_offsets"]),
                    kw["q_stride"], kw["kv_stride"])
    return pos, dict(causal=True, window_size=kw["window_size"],
                     sink_tokens=kw.get("sink_tokens", 0))


def kernel_ring(K, flash, sage, ring, gen, dev, model=None):
    """B3, B2a, B2b and B8b at the dense ring's multi-chunk and strided
    descriptors (RING_CASES), each against its plain version row by row
    (dead rows exactly 0, lse -inf), timed beside its bound from the
    case's visible pairs and SDPA's memory-efficient kernel with the
    equivalent boolean mask, at the attention widths of ``model`` (MODEL
    by default; at head dim 64 without B8b, which takes 128 only).
    Returns {kernel: [case rows]}."""
    model = model or MODEL
    b, s, h, hk = 1, RING_LOCAL, model["n_heads"], model["n_kv_heads"]
    d = model["head_dim"]
    scale = d ** -0.5
    q, dout = (torch.randn((b, s, h, d), generator=gen, device=dev)
               .bfloat16() for _ in range(2))
    k, v = (torch.randn((b, s, hk, d), generator=gen, device=dev).bfloat16()
            for _ in range(2))
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)
    with_sage = d == 128
    if with_sage:
        q8, qs, _ = sage.sage_quant_q(q, scale)
        (k8, ks), (v8, vs) = (ring._quantize(t, "int8") for t in (k, v))
    out_rows = {n: [] for n in ("B3", "B2a", "B2b", "B8b")[:3 + with_sage]}
    for tag, fields, rank, step in RING_CASES:
        pos, mk = ring_case_kwargs(ring, tag, fields, rank, step)
        left, right, sink = flash._masks(mk["causal"], mk["window_size"],
                                         mk["sink_tokens"], 0.0)
        vis = ~flash._mask(pos.q_positions(s, dev), pos.kv_positions(s, dev),
                           left, right, sink)
        pairs = int(vis.sum()) * b * h
        dead = int((vis.sum(1) == 0).sum())
        one_col = (vis.sum(1) == 1).nonzero()[:, 0]
        fw = dict(pos=pos, scale=scale, **mk)
        out, lse = flash.flash_fwd_pos(q, kt, vt, **fw)
        pout, plse = flash.flash_fwd_pos_plain(q, kt, vt, **fw)
        torch.cuda.synchronize()
        c3 = [check_out(f"B3 {tag} out", out, pout)]
        check(f"B3 {tag} lse", max_err(lse, plse), LSE_TOL)
        delta = (dout.float() * out.float()).sum(-1).transpose(1, 2)
        args = (q, k, v, dout, lse, delta.contiguous())
        bw = dict(pos=pos, scale=scale, **mk)
        dq = flash.flash_bwd_dq(*args, **bw)
        pdq = flash.flash_bwd_dq_plain(*args, **bw)
        torch.cuda.synchronize()
        c2a = [check_out(f"B2a {tag} dq", dq, pdq, one_col)]
        del dq, pdq
        dk, dv = flash.flash_bwd_dkv(*args, **bw)
        pdk, pdv = flash.flash_bwd_dkv_plain(*args, **bw)
        torch.cuda.synchronize()
        c2b = [check_out(f"B2b {tag} dk", dk, pdk),
               check_out(f"B2b {tag} dv", dv, pdv)]
        del dk, dv, pdk, pdv
        if with_sage:
            sargs = (q8, qs, k8, ks, v8, vs)
            so, sl = sage.sage_fwd_pos(*sargs, pos=pos, **mk)
            pso, psl = sage.sage_fwd_pos_plain(*sargs, pos=pos, **mk)
            torch.cuda.synchronize()
            c8 = [check_out(f"B8b {tag} out", so, pso)]
            check(f"B8b {tag} lse", max_err(sl, psl), LSE_TOL)
            del so, sl, pso, psl
        torch.cuda.empty_cache()
        sdpa_f, sdpa_b = sdpa_masked_ms(q, k, v, dout, vis)
        in_b = 2 * (2 * q.numel() + 2 * k.numel())
        kinds = (
            ("B3", c3, lambda: flash.flash_fwd_pos(q, kt, vt, **fw),
             lambda: flash.flash_fwd_pos_plain(q, kt, vt, **fw), 4,
             in_b + 4 * b * h * s, PEAK_BF16_FLOPS, sdpa_f),
            ("B2a", c2a, lambda: flash.flash_bwd_dq(*args, **bw),
             lambda: flash.flash_bwd_dq_plain(*args, **bw), 6,
             in_b + 8 * b * h * s + 4 * q.numel(), PEAK_BF16_FLOPS, sdpa_b),
            ("B2b", c2b, lambda: flash.flash_bwd_dkv(*args, **bw),
             lambda: flash.flash_bwd_dkv_plain(*args, **bw), 8,
             in_b + 8 * b * h * s + 8 * k.numel(), PEAK_BF16_FLOPS, sdpa_b))
        if with_sage:
            kinds += (
                ("B8b", c8, lambda: sage.sage_fwd_pos(*sargs, pos=pos, **mk),
                 lambda: sage.sage_fwd_pos_plain(*sargs, pos=pos, **mk), 4,
                 q.numel() + 2 * k.numel() + 2 * q.numel()
                 + 4 * b * (h + 2 * hk) * s, PEAK_SAGE_OPS, sdpa_f),)
        for n, checks, fn, plain, per_pair, nbytes, peak, lib in kinds:
            ms = time_ms(fn)
            pms = time_ms(plain, iters=1, warmup=1)
            torch.cuda.empty_cache()
            out_rows[n].append({
                "case": tag, "q_offsets": list(pos.q_offsets),
                "kv_offsets": list(pos.kv_offsets), "stride": pos.q_stride,
                **mk, "visible_pairs": pairs, "dead_rows": dead,
                **case_row(checks, ms, pms, per_pair * d * pairs, nbytes,
                           lib, peak)})
        emit({"phase": "ring_kernels", "case": tag, "dead_rows": dead,
              "ms": {n: out_rows[n][-1]["ms"] for n in out_rows}})
        del out, lse, pout, plse, args, delta
        torch.cuda.empty_cache()
    ring_forms(flash, ring, q, k, v, dout, scale)
    return out_rows


def ring_forms(flash, ring, q, k, v, dout, scale):
    """The other instantiations the ring's steps reach at a two-chunk
    descriptor (zigzag rank 1 step 2), each against its plain version row
    by row: B3 over int8 K/V (kv_quant="int8"; head dim 128 only), with
    softcap 50 and in the online form (safe_softmax); B2a and B2b with
    softcap 50."""
    pos, mk = ring_case_kwargs(ring, *RING_CASES[0])
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)
    forms = [("softcap", (q, kt, vt), dict(softcap=SOFTCAP)),
             ("safe_softmax", (q, kt, vt), dict(safe_softmax=True))]
    if q.shape[-1] == 128:
        (k8, ks), (v8, vs) = (ring._quantize(t, "int8") for t in (k, v))
        forms.insert(0, ("int8 K/V", (q, k8.transpose(1, 2),
                                      v8.transpose(1, 2), ks, vs), {}))
    errs = {}
    for tag, args, kw in forms:
        fw = dict(pos=pos, scale=scale, **mk, **kw)
        got = flash.flash_fwd_pos(*args, **fw)
        want = flash.flash_fwd_pos_plain(*args, **fw)
        torch.cuda.synchronize()
        errs[f"B3 {tag}"] = check_out(f"B3 ring {tag} out", got[0],
                                      want[0])[1]
        check(f"B3 ring {tag} lse", max_err(got[1], want[1]), LSE_TOL)
    fw = dict(pos=pos, scale=scale, softcap=SOFTCAP, **mk)
    out, lse = flash.flash_fwd_pos(q, kt, vt, **fw)
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2)
    args = (q, k, v, dout, lse, delta.contiguous())
    for tag, fn, plain in (("B2a", flash.flash_bwd_dq, flash.flash_bwd_dq_plain),
                           ("B2b", flash.flash_bwd_dkv,
                            flash.flash_bwd_dkv_plain)):
        got, want = fn(*args, **fw), plain(*args, **fw)
        torch.cuda.synchronize()
        if tag == "B2a":  # dq alone
            got, want = (got,), (want,)
        for i, (a, w) in enumerate(zip(got, want)):
            errs[f"{tag} softcap {i}"] = check_out(
                f"{tag} ring softcap grad {i}", a, w)[1]
        del got, want
        torch.cuda.empty_cache()
    emit({"phase": "ring_forms", "case": RING_CASES[0][0],
          "head_dim": q.shape[-1], "row_rel_err": errs})


# ---------------------------------------------------------------------------
# packed varlen, ALiBi and dropout (segment ids, kv_lengths, the hash
# dropout) in B3, B2a and B2b
# ---------------------------------------------------------------------------

# attention dropout at the rate a training run of the reference layer takes
# (its dropout_p, hybrid/attn_layer.py:62)
DROPOUT_P = 0.1
# packed documents: lengths uniform on DOC_LENS from a seeded numpy
# generator, the last cut to fill the sequence, so that document
# boundaries cut the kernels' 128-wide tiles
DOC_LENS = (512, 8192)
# The max-free forward sums p = exp2(s) unnormalised. ALiBi at a far ring
# step (the zigzag and stripe descriptors) can push every visible score of
# a row to the bottom of fp32's range, exp2 between -149 and -126: the
# plain version keeps those subnormal p, while the card's exp2 and its
# bf16 tensor-core operands may flush them, so that one side's row is dead
# (out 0, lse -inf) and the other's full-sized (acc / l of two tiny
# numbers is not tiny). The merged result is the same, since such a step's
# weight beside the row's own diagonal step is about exp(-80). So a
# per-step forward row is held against its plain version where the plain
# lse is above LSE_FLOOR (below it the kernel's lse must be below
# LSE_FLOOR + 10 or -inf), and merged outputs (ring_emulated, usp_varlen)
# everywhere; a row that sees no column at all must be out 0, lse -inf.
LSE_FLOOR = -80.0


def alibi_slopes(h, dev):
    """The geometric ALiBi slopes 2^(-8 (i + 1) / h) of Press et al.
    (arXiv:2108.12409), the slopes BLOOM and MPT use."""
    return torch.tensor([2.0 ** (-8.0 * (i + 1) / h) for i in range(h)],
                        dtype=torch.float32, device=dev)


def packed_ids(s, dev, seed=SEED):
    """(1, s) int32 segment ids of documents packed into one sequence
    (DOC_LENS), built by the layouts' segment_ids_from_cu_seqlens."""
    from long_context_attention_tpu_torch.parallel.layouts import (
        segment_ids_from_cu_seqlens)

    rng = np.random.RandomState(seed)
    cu = [0]
    while cu[-1] < s:
        cu.append(min(s, cu[-1] + int(rng.randint(DOC_LENS[0],
                                                  DOC_LENS[1] + 1))))
    return segment_ids_from_cu_seqlens(cu, s).to(dev)


def feature_descs(flash, ring, dev):
    """(tag, Positions, mask kwargs, q ids, kv ids) of the descriptors the
    feature cases run at: one chunk (a static self-attention call with a
    feature, b=1, s=8192), and RING_CASES' zigzag (rank 1, step 2) and
    stripe (src > rank) steps of a W=4 ring over packed documents of
    W * 8192 tokens, with the rank's and the source's shards of the ids."""
    from long_context_attention_tpu_torch.parallel.layouts import (
        permute_for_layout)

    ids = packed_ids(TRAIN_SEQ, dev)
    out = [("one chunk", flash.Positions.at(0),
            dict(causal=True, window_size=(-1, -1), sink_tokens=0), ids,
            ids)]
    glob = packed_ids(RING_W * RING_LOCAL, dev, SEED + 1)
    for tag, fields, rank, step in RING_CASES[:2]:
        pos, mk = ring_case_kwargs(ring, tag, fields, rank, step)
        shards = permute_for_layout(glob, fields["layout"],
                                    RING_W).chunk(RING_W, 1)
        src = (rank - step) % RING_W
        out.append((tag, pos, mk, shards[rank].contiguous(),
                    shards[src].contiguous()))
    return out


def feature_sets(flash, q_ids, kv_ids, slopes, seed):
    """The feature cases: (a) packed segments, (b) ALiBi, (c) dropout 0.1,
    (d) all three."""
    return (("segments", flash.Features(q_ids, kv_ids)),
            ("alibi", flash.Features(slopes=slopes)),
            ("dropout", flash.Features(dropout_p=DROPOUT_P, seed=seed)),
            ("segments alibi dropout",
             flash.Features(q_ids, kv_ids, slopes, DROPOUT_P, seed)))


def feature_vis(flash, pos, mk, feat, s_q, s_kv, dev):
    """(b or 1, s_q, s_kv) bool: the pairs the masks and the segments
    keep."""
    left, right, sink = flash._masks(mk["causal"], mk["window_size"],
                                     mk["sink_tokens"], 0.0)
    vis = ~flash._mask(pos.q_positions(s_q, dev), pos.kv_positions(s_kv, dev),
                       left, right, sink)[None]
    if feat.q_seg is not None:
        vis = vis & (feat.q_seg[:, :, None] == feat.kv_seg[:, None, :])
    return vis


def check_fwd_rows(name, out, lse, pout, plse, seen):
    """A featured forward's rows against the plain version's: rows that see
    no column (``seen`` (b, s_q) False) out 0 and lse -inf exactly; rows
    whose plain lse is at or below LSE_FLOOR held only to a kernel lse
    below LSE_FLOOR + 10 (or -inf: see LSE_FLOOR); every other row within
    ROW_REL_TOL of its size and its lse within LSE_TOL. Returns
    check_out's (max abs error, worst row) and the count of floor rows."""
    dead = ~seen[:, None, :].expand_as(plse)
    if out.transpose(1, 2)[dead].any() or not torch.isneginf(lse[dead]).all():
        raise AssertionError(f"{name}: rows that see no column are not out "
                             f"0, lse -inf")
    low = (plse <= LSE_FLOOR) & ~dead
    klow = lse[low]
    if not bool(((klow <= LSE_FLOOR + 10) | torch.isneginf(klow)).all()):
        raise AssertionError(f"{name}: a row whose plain lse is below "
                             f"{LSE_FLOOR} is full-sized on the card")
    held = (~low).transpose(1, 2)[..., None]
    res = check_out(name, torch.where(held, out, torch.zeros_like(out)),
                    torch.where(held, pout, torch.zeros_like(pout)))
    keep = ~low & ~dead
    if keep.any():
        check(f"{name} lse", max_err(lse[keep], plse[keep]), LSE_TOL)
    return res, int(low.sum())


def feature_mask(vis, feat, pos, s_q, s_kv, dev, dtype):
    """SDPA's additive float mask of the same function (segments and
    masks -inf, plus the ALiBi bias), (b, h or 1, s_q, s_kv)."""
    mask = torch.zeros(vis.shape, dtype=dtype, device=dev).masked_fill(
        ~vis, -math.inf)[:, None]
    if feat.slopes is not None:
        dist = (pos.q_positions(s_q, dev)[:, None]
                - pos.kv_positions(s_kv, dev)[None, :]).abs().float()
        mask = mask + (-feat.slopes[:, None, None] * dist).to(dtype)[None]
    return mask


def kernel_features(K, flash, ring, gen, dev, model=None):
    """B3, B2a and B2b with the features (packed segments, ALiBi with the
    geometric slopes, dropout 0.1, all three; at head dim 64 all three
    together only, and no int8 K/V nor kv_lengths: B3 over quantized K/V
    takes the features at 128 only) at the trainer's per-layer shape (b=1,
    s=8192, at ``model``'s widths: MODEL's 16/8 heads of 128 by default,
    causal), at one chunk and at the ring's
    zigzag and stripe steps (feature_descs), each against its plain version
    (check_fwd_rows; the backward on the kernel forward's out and lse, rows
    within ROW_REL_TOL), timed with its bound (the visible pairs: causal and
    same segment) and SDPA's memory-efficient kernel: with the equivalent
    additive float mask for segments and ALiBi (the same function), with
    dropout 0.1 (its own mask: a cost yardstick). Then B3 over int8 K/V
    with segments and dropout at the zigzag step and with all three at one
    chunk, and with kv_lengths. Returns {kernel: [case rows]}."""
    model = model or MODEL
    b, s, h, hk = 1, TRAIN_SEQ, model["n_heads"], model["n_kv_heads"]
    d = model["head_dim"]
    scale = d ** -0.5
    slopes = alibi_slopes(h, dev)
    seed = (SEED + 0x5EED, 0)
    q, dout = (torch.randn((b, s, h, d), generator=gen, device=dev)
               .bfloat16() for _ in range(2))
    k, v = (torch.randn((b, s, hk, d), generator=gen, device=dev).bfloat16()
            for _ in range(2))
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)
    rows = {n: [] for n in ("B3", "B2a", "B2b")}
    descs = feature_descs(flash, ring, dev)
    for dtag, pos, mk, q_ids, kv_ids in descs:
        for ftag, feat in feature_sets(flash, q_ids, kv_ids, slopes, seed):
            if d != 128 and ftag != "segments alibi dropout":
                continue
            tag = f"{dtag}, {ftag}"
            vis = feature_vis(flash, pos, mk, feat, s, s, dev)
            pairs = int(vis.sum()) * h * (b if vis.shape[0] == 1 else 1)
            fw = dict(pos=pos, scale=scale, features=feat, **mk)
            out, lse = flash.flash_fwd_pos(q, kt, vt, **fw)
            pout, plse = flash.flash_fwd_pos_plain(q, kt, vt, **fw)
            torch.cuda.synchronize()
            c3, floor_rows = check_fwd_rows(
                f"B3 {tag} out", out, lse, pout, plse,
                vis.any(-1).expand(b, s))
            del pout, plse
            delta = (dout.float() * out.float()).sum(-1).transpose(1, 2)
            args = (q, k, v, dout, lse, delta.contiguous())
            dq = flash.flash_bwd_dq(*args, **fw)
            pdq = flash.flash_bwd_dq_plain(*args, **fw)
            torch.cuda.synchronize()
            # a row that sees one column: ds = dp - delta cancels to noise
            one_col = (vis[0].sum(-1) == 1).nonzero()[:, 0]
            c2a = [check_out(f"B2a {tag} dq", dq, pdq, one_col)]
            del dq, pdq
            dk, dv = flash.flash_bwd_dkv(*args, **fw)
            pdk, pdv = flash.flash_bwd_dkv_plain(*args, **fw)
            torch.cuda.synchronize()
            c2b = [check_out(f"B2b {tag} dk", dk, pdk),
                   check_out(f"B2b {tag} dv", dv, pdv)]
            del dk, dv, pdk, pdv
            torch.cuda.empty_cache()
            dropout = feat.dropout_p > 0.0
            if dropout and feat.q_seg is None and feat.slopes is None:
                lib_mask = vis
            else:
                lib_mask = feature_mask(vis, feat, pos, s, s, dev, q.dtype)
            sdpa_f, sdpa_b = sdpa_masked_ms(q, k, v, dout, lib_mask,
                                            DROPOUT_P if dropout else 0.0)
            del lib_mask
            library = ("SDPA memory-efficient with dropout 0.1 (its own "
                       "mask: a cost yardstick, not the same function)"
                       if dropout else
                       "SDPA memory-efficient, the equivalent additive "
                       "float mask (the same function)")
            in_b = 2 * (2 * q.numel() + 2 * k.numel()) + 8 * b * s
            kinds = (
                ("B3", [c3], lambda: flash.flash_fwd_pos(q, kt, vt, **fw),
                 lambda: flash.flash_fwd_pos_plain(q, kt, vt, **fw), 4,
                 in_b + 4 * b * h * s, sdpa_f),
                ("B2a", c2a, lambda: flash.flash_bwd_dq(*args, **fw),
                 lambda: flash.flash_bwd_dq_plain(*args, **fw), 6,
                 in_b + 8 * b * h * s + 4 * q.numel(), sdpa_b),
                ("B2b", c2b, lambda: flash.flash_bwd_dkv(*args, **fw),
                 lambda: flash.flash_bwd_dkv_plain(*args, **fw), 8,
                 in_b + 8 * b * h * s + 8 * k.numel(), sdpa_b))
            for n, checks, fn, plain, per_pair, nbytes, lib in kinds:
                ms = time_ms(fn)
                pms = time_ms(plain, iters=1, warmup=0)
                torch.cuda.empty_cache()
                rows[n].append({
                    "case": tag, "q_offsets": list(pos.q_offsets),
                    "kv_offsets": list(pos.kv_offsets),
                    "stride": pos.q_stride, "visible_pairs": pairs,
                    "floor_rows": floor_rows, "library": library,
                    **case_row(checks, ms, pms, per_pair * d * pairs,
                               nbytes, lib)})
            emit({"phase": "feature_kernels", "case": tag,
                  "visible_pairs": pairs, "floor_rows": floor_rows,
                  "ms": {n: rows[n][-1]["ms"] for n in rows},
                  "bound_ms": {n: rows[n][-1]["bound_ms"] for n in rows}})
            del out, lse, args, delta
            torch.cuda.empty_cache()
    if d != 128:
        return rows
    # B3 over int8 K/V (kv_quant="int8"): segments and dropout at the
    # zigzag step, and all three features at one chunk (live pairs there:
    # the zigzag step's documents may not reach across its gap)
    (k8, ks), (v8, vs) = (ring._quantize(t, "int8") for t in (k, v))
    i8 = (q, k8.transpose(1, 2), v8.transpose(1, 2), ks, vs)
    for (dtag, pos, mk, _, _), ftag, feat in (
            (descs[1], "segments dropout",
             flash.Features(descs[1][3], descs[1][4], dropout_p=DROPOUT_P,
                            seed=seed)),
            (descs[0], "segments alibi dropout",
             flash.Features(descs[0][3], descs[0][4], slopes, DROPOUT_P,
                            seed))):
        fw = dict(pos=pos, scale=scale, features=feat, **mk)
        out, lse = flash.flash_fwd_pos(*i8, **fw)
        pout, plse = flash.flash_fwd_pos_plain(*i8, **fw)
        torch.cuda.synchronize()
        vis = feature_vis(flash, pos, mk, feat, s, s, dev)
        c8, floor_rows = check_fwd_rows(f"B3 {dtag}, int8 K/V {ftag}", out,
                                        lse, pout, plse,
                                        vis.any(-1).expand(b, s))
        del pout, plse
        pairs = int(vis.sum()) * h
        ms = time_ms(lambda: flash.flash_fwd_pos(*i8, **fw))
        pms = time_ms(lambda: flash.flash_fwd_pos_plain(*i8, **fw), iters=1,
                      warmup=0)
        nbytes = (2 * 2 * q.numel() + 2 * k8.numel() + 8 * b * hk * s
                  + 8 * b * s + 4 * b * h * s)
        rows["B3"].append({"case": f"{dtag}, int8 K/V, {ftag}",
                           "visible_pairs": pairs, "floor_rows": floor_rows,
                           "library": None,
                           **case_row([c8], ms, pms, 4 * d * pairs, nbytes,
                                      None)})
        torch.cuda.empty_cache()
    del q, k, v, dout, kt, vt, out, lse
    torch.cuda.empty_cache()
    rows["B3"].append(kernel_b3_kv_lengths(flash, gen, dev))
    return rows


# kv_lengths on the chunked-prefill cache call: each batch row's filled
# prefix (ragged, one row empty: out 0, lse -inf)
KV_LENGTHS = (6144, 5000, 0, 3001)


def kernel_b3_kv_lengths(flash, gen, dev):
    """B3 with kv_lengths (segment ids: q 1, kv j < kv_lengths[b], the JAX
    construction) on the chunked-prefill cache call: b=4, 2048 rows at
    q_start 6144 over an int8 cache of 6144 slots, lengths KV_LENGTHS,
    against its plain version; timed with its bound (the slots each row
    sees) and SDPA's memory-efficient kernel over the dequantized cache
    with the equivalent float mask (the same function)."""
    b, h, hk, d = BATCH, MODEL["n_heads"], MODEL["n_kv_heads"], 128
    s_q, start = CHUNK, PROMPT - CHUNK
    q = torch.randn((b, s_q, h, d), generator=gen, device=dev).bfloat16()
    kc, vc = (torch.randint(-127, 128, (b, hk, start, d), generator=gen,
                            device=dev, dtype=torch.int8) for _ in range(2))
    ks, vs = (torch.rand((b, hk, start), generator=gen, device=dev) / 64
              for _ in range(2))
    lens = torch.tensor(KV_LENGTHS, device=dev)
    kw = dict(k_scale=ks, v_scale=vs, q_start=start, causal=True,
              kv_lengths=lens)
    out, lse = flash.flash_attention_fwd_cache(q, kc, vc, **kw)
    feat = flash.Features(torch.ones((b, s_q), dtype=torch.int32, device=dev),
                          (torch.arange(start, device=dev)[None]
                           < lens[:, None]).int())
    pout, plse = flash.flash_fwd_pos_plain(q, kc, vc, ks, vs, q_start=start,
                                           causal=True, scale=d ** -0.5,
                                           features=feat)
    torch.cuda.synchronize()
    seen = (lens > 0)[:, None].expand(b, s_q)
    res, _ = check_fwd_rows("B3 kv_lengths out", out, lse, pout, plse, seen)
    ms = time_ms(lambda: flash.flash_attention_fwd_cache(q, kc, vc, **kw))
    pms = time_ms(lambda: flash.flash_fwd_pos_plain(
        q, kc, vc, ks, vs, q_start=start, causal=True, scale=d ** -0.5,
        features=feat), iters=1, warmup=0)
    kd, vd = ((t.float() * sc[..., None]).bfloat16()
              .repeat_interleave(h // hk, 1) for t, sc in ((kc, ks), (vc, vs)))
    mask = torch.zeros((b, 1, s_q, start), dtype=torch.bfloat16,
                       device=dev).masked_fill(
        ~feat.kv_seg.bool()[:, None, None, :], -math.inf)
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        q.transpose(1, 2), kd, vd, attn_mask=mask))
    pairs = s_q * h * sum(KV_LENGTHS)
    nbytes = (2 * 2 * q.numel() + 4 * b * h * s_q
              + 2 * hk * sum(KV_LENGTHS) * (d + 4))
    return {"case": f"kv_lengths {list(KV_LENGTHS)}, int8 cache {start}, "
                    f"{s_q} rows at q_start {start}",
            "visible_pairs": pairs,
            "library": "SDPA memory-efficient over the dequantized cache, "
                       "the equivalent float mask (the same function)",
            **case_row([res], ms, pms, 4 * d * pairs, nbytes, lib_ms)}


# the keep-mask probes' global offsets: above 2^20 on both sides, several
# kv offsets, a head base that is not 0
PROBE_Q_OFFSET = (1 << 20) + 4133
PROBE_KV_OFFSETS = ((1 << 20) + 96, (1 << 20) + 77777, (1 << 21) + 5)
PROBE_SEED = (0x2545F491, 5)


def feature_probes(flash, gen, dev):
    """Exact probes of the dropout keep mask, which a row check cannot see
    (one flipped bit in 8192 columns): b=2, 16 heads (h == h_kv),
    non-causal, q and kv at global offsets above 2^20, head base 5.
      B3: one kv tile of 128 columns, V the identity per kv head: out[i, j]
        != 0 exactly where pair (i, j) is kept; at several kv offsets.
      B2b: dout the identity over 128 q rows: dv[j, i] != 0 exactly where
        (i, j) is kept.
      B2a: K the identity, V and dout rows all one vector u (dp = |u|^2)
        and delta 0: dq[i, j] = bf16(ds) != 0 exactly where kept; each
        element against the plain version, whose error must stay below the
        smallest change one flipped bit makes (the smallest kept |dq|).
    Each pattern against flash.dropout_keep bit for bit; the kept share
    against 1 - p within 4 sigma of the binomial."""
    b, h, d = 2, MODEL["n_heads"], 128
    s_q, s_kv = 2048, 128
    scale = d ** -0.5
    eye = torch.eye(d, device=dev).bfloat16()
    P = flash.Positions
    kept, total, res = 0, 0, {}

    def keep_of(pos, sq, skv):
        return flash.dropout_keep(PROBE_SEED, pos.q_positions(sq, dev),
                                  pos.kv_positions(skv, dev), b, h,
                                  DROPOUT_P)

    feat = flash.Features(dropout_p=DROPOUT_P, seed=PROBE_SEED)
    q = torch.randn((b, s_q, h, d), generator=gen, device=dev).bfloat16()
    k = torch.randn((b, s_kv, h, d), generator=gen, device=dev).bfloat16()
    v_eye = eye[None, :, None, :].expand(b, s_kv, h, d).contiguous()
    for kvo in PROBE_KV_OFFSETS:
        pos = P((PROBE_Q_OFFSET,), (kvo,))
        out, _ = flash.flash_fwd_pos(q, k.transpose(1, 2),
                                     v_eye.transpose(1, 2), pos=pos,
                                     scale=scale, features=feat)
        torch.cuda.synchronize()
        want = keep_of(pos, s_q, s_kv).permute(0, 2, 1, 3)  # (b, s_q, h, j)
        got = out != 0
        flips = int((got != want).sum())
        res[f"B3 kv offset {kvo}"] = flips
        kept += int(want.sum())
        total += want.numel()
        if flips:
            raise AssertionError(f"B3 keep probe at kv offset {kvo}: {flips} "
                                 f"pairs differ from dropout_keep")
    # B2b: dv with dout the identity over 128 q rows
    sq2, skv2 = 128, 2048
    q2 = torch.randn((b, sq2, h, d), generator=gen, device=dev).bfloat16()
    k2, v2 = (torch.randn((b, skv2, h, d), generator=gen, device=dev)
              .bfloat16() for _ in range(2))
    pos = P((PROBE_Q_OFFSET,), (PROBE_KV_OFFSETS[1],))
    out, lse = flash.flash_fwd_pos(q2, k2.transpose(1, 2), v2.transpose(1, 2),
                                   pos=pos, scale=scale, features=feat)
    do_eye = eye[None, :, None, :].expand(b, sq2, h, d).contiguous()
    delta = (do_eye.float() * out.float()).sum(-1).transpose(1, 2)
    _, dv = flash.flash_bwd_dkv(q2, k2, v2, do_eye, lse, delta.contiguous(),
                                pos=pos, causal=False, scale=scale,
                                features=feat)
    torch.cuda.synchronize()
    want = keep_of(pos, sq2, skv2).permute(0, 3, 1, 2)  # (b, j, h, i)
    flips = int(((dv != 0) != want).sum())
    res["B2b dv"] = flips
    kept += int(want.sum())
    total += want.numel()
    if flips:
        raise AssertionError(f"B2b keep probe: {flips} pairs differ from "
                             f"dropout_keep")
    # B2a: dq with K the identity
    u = torch.full((d,), 0.1, device=dev)
    k_eye = eye[None, :, None, :].expand(b, s_kv, h, d).contiguous()
    v_u = u.bfloat16().expand(b, s_kv, h, d).contiguous()
    do_u = u.bfloat16().expand(b, s_q, h, d).contiguous()
    pos = P((PROBE_Q_OFFSET,), (PROBE_KV_OFFSETS[2],))
    out, lse = flash.flash_fwd_pos(q, k_eye.transpose(1, 2),
                                   v_u.transpose(1, 2), pos=pos, scale=scale,
                                   features=feat)
    zero = torch.zeros((b, h, s_q), device=dev)
    bw = dict(pos=pos, causal=False, scale=scale, features=feat)
    dq = flash.flash_bwd_dq(q, k_eye, v_u, do_u, lse, zero, **bw)
    pdq = flash.flash_bwd_dq_plain(q, k_eye, v_u, do_u, lse, zero, **bw)
    torch.cuda.synchronize()
    want = keep_of(pos, s_q, s_kv).permute(0, 2, 1, 3)  # (b, s_q, h, j)
    flips = int(((dq != 0) != want).sum())
    err = float((dq - pdq).abs().max())
    min_flip = float(pdq.abs()[want].min())
    res["B2a dq"] = {"pattern_flips": flips, "max_abs_err": err,
                     "smallest_flip_change": min_flip}
    kept += int(want.sum())
    total += want.numel()
    if flips or not err < min_flip:
        raise AssertionError(f"B2a keep probe: {flips} pairs differ; max "
                             f"error {err} against the smallest flip "
                             f"{min_flip}")
    share = kept / total
    sigma = math.sqrt(DROPOUT_P * (1 - DROPOUT_P) / total)
    res.update(kept_share=share, expected=1 - DROPOUT_P, sigma=sigma,
               pairs=total)
    emit({"phase": "keep_probes", **res})
    if abs(share - (1 - DROPOUT_P)) > 4 * sigma:
        raise AssertionError(f"kept share {share} is more than 4 sigma from "
                             f"{1 - DROPOUT_P}")
    return res


def offsets_phase(build, flash, dev, card):
    """flash_attention with one-chunk offsets (B3 + B2a + B2b, the JAX
    trainer's per-layer call) against the no-offsets path (B1 + B5) on the
    same inputs, fwd and bwd through autograd; then the same with the
    window (4096) and sinks (4): with the offsets B3 + B2a + B2b against
    none (B4 + B5). Returns the offsets runs' launch counts, dense and
    windowed."""
    b, s, h, hk, d = 1, TRAIN_SEQ, MODEL["n_heads"], MODEL["n_kv_heads"], 128
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    q, k, v, dout = (torch.randn(shape, generator=gen, device=dev).bfloat16()
                     .requires_grad_()
                     for shape in ((b, s, h, d), (b, s, hk, d), (b, s, hk, d),
                                   (b, s, h, d)))
    dout = dout.detach()
    runs = {}
    for name, kw in (("offsets", dict(q_offsets=[0], kv_offsets=[0])),
                     ("static", {})):
        build.reset_launch_counts()
        out = flash.flash_attention(q, k, v, causal=True, **kw)
        grads = torch.autograd.grad(out, (q, k, v), dout)
        torch.cuda.synchronize()
        runs[name] = (build.launch_counts(), (out.detach(), *grads))
    counts, got = runs["offsets"]
    want_counts = {"flash_fwd_pos": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1,
                   "flash_fwd_causal_self": 0, "flash_bwd_fused": 0}
    static_counts, want = runs["static"]
    for n, c in want_counts.items():
        if counts[n] != c:
            raise AssertionError(f"offsets path: {n} launched {counts[n]} "
                                 f"times, expected {c} (all: {counts})")
    if static_counts["flash_fwd_causal_self"] != 1 or static_counts[
            "flash_bwd_fused"] != 1:
        raise AssertionError(f"static path counts {static_counts}")
    errs = {name: check_out(f"offsets vs static {name}", a, w,
                            0 if name == "dq" else None)
            for name, a, w in zip(("out", "dq", "dk", "dv"), got, want)}

    win = dict(causal=True, window_size=(WINDOW, -1), sink_tokens=SINKS)
    wruns = {}
    for name, kw, kernels in (
            ("offsets", dict(q_offsets=[0], kv_offsets=[0]),
             ("flash_fwd_pos", "flash_bwd_dq", "flash_bwd_dkv")),
            ("static", {}, ("flash_fwd_static", "flash_bwd_fused"))):
        build.reset_launch_counts()
        out, lse = flash.flash_attention(q, k, v, return_lse=True, **win,
                                         **kw)
        grads = torch.autograd.grad(out, (q, k, v), dout)
        torch.cuda.synchronize()
        wcounts = build.launch_counts()
        if (any(wcounts[n] != 1 for n in kernels)
                or sum(wcounts.values()) != len(kernels)):
            raise AssertionError(f"windowed {name} path counts {wcounts}")
        wruns[name] = (wcounts, (out.detach(), lse.detach(), *grads))
    (wcounts, got), (_, want) = wruns["offsets"], wruns["static"]
    for name, a, w in zip(("out", "lse", "dq", "dk", "dv"), got, want):
        if name == "lse":
            check("windowed offsets vs static lse", max_err(a, w), LSE_TOL)
            continue
        errs[f"windowed {name}"] = check_out(
            f"windowed offsets (B3, B2a, B2b) vs static (B4, B5) {name}", a,
            w, 0 if name == "dq" else None)
    emit({"phase": "offsets", "card": card, "seq": s, "launches": counts,
          "windowed_launches": wcounts,
          "row_rel_err": {n: r for n, (_, r) in errs.items()}})
    return counts, wcounts


# every attention forward kernel a prefill could take
PREFILL_KERNELS = ("flash_fwd_causal_self", "flash_fwd_static",
                   "flash_fwd_pos", "sage_fwd_tri", "sage_fwd_pos",
                   "sage_fwd_rect")


def sage_serve_phase(pkg, build, dev, card):
    """Serve the 0.88B config with attn_impl="sage" next to "pallas" on the
    same weights and prompt: Engine.prefill of 4 x 8192 in one shot, dense
    (B8a in every layer) and windowed (B8b), each sage layer with one
    launch of each quantization kernel, timed in turns (pallas, sage,
    sage, pallas) with exact launch counts, the sage-vs-pallas last-token
    logit gap and argmax agreement; then, dense, decode_scan of 32 steps
    from the sage prefill's int8 cache (B6, B7: decode ignores attn_impl,
    as in JAX) with teacher forcing against a sage prefill of prompt + the
    first token (B8a at s=8193), and a generate at b=2 over 1024 tokens.
    Returns the launch counts of the dense and the windowed sage prefill
    (by kernel name) and of the windowed pallas one ("pallas window")."""
    from long_context_attention_tpu_torch.models.llama import (
        decode_step, init_params)
    from long_context_attention_tpu_torch.serving.engine import Engine

    L = MODEL["n_layers"]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    prompt = torch.randint(0, MODEL["vocab"], (BATCH, PROMPT), generator=gen,
                           device=dev)
    path = {}
    for windowed in (False, True):
        tag = "window" if windowed else "dense"
        cfgs = {impl: pkg.ModelConfig(**MODEL, attn_impl=impl,
                                      **(WINDOWED if windowed else {}))
                for impl in ("pallas", "sage")}
        params = init_params(torch.Generator(device=dev).manual_seed(SEED),
                             cfgs["sage"], device=dev)
        engs = {impl: Engine(cfg=cfg, s_max=S_MAX, cache_dtype="int8",
                             weight_dtype="int8", device=dev)
                for impl, cfg in cfgs.items()}
        own = {"pallas": "flash_fwd_static" if windowed
               else "flash_fwd_causal_self",
               "sage": "sage_fwd_pos" if windowed else "sage_fwd_tri"}
        for eng in engs.values():  # warm-up
            eng.prefill(params, prompt[:, :CHUNK])
        torch.cuda.synchronize()
        times, logits = {"pallas": [], "sage": []}, {}
        for impl in ("pallas", "sage", "sage", "pallas"):
            build.reset_launch_counts()
            t0 = time.perf_counter()
            logits[impl], cache = engs[impl].prefill(params, prompt)
            torch.cuda.synchronize()
            times[impl].append(time.perf_counter() - t0)
            counts = expect_counts(build, {
                **{k: (L if k == own[impl] else 0) for k in PREFILL_KERNELS},
                **quant_counts(L if impl == "sage" else 0)})
            if impl == "sage":
                path[own["sage"]] = counts
                sage_cache = cache
            elif windowed:
                path["pallas window"] = counts
            del cache
        for impl, lg in logits.items():
            if not torch.isfinite(lg).all():
                raise AssertionError(f"{impl} prefill logits not finite")
        gap = (logits["sage"] - logits["pallas"]).abs()
        agree = float((logits["sage"].argmax(-1)
                       == logits["pallas"].argmax(-1)).float().mean())
        emit({"phase": "slice_sage_prefill", "card": card, "model":
              "llama-0.88B", "window_left": cfgs["sage"].window_left,
              "sink_tokens": cfgs["sage"].sink_tokens, "batch": BATCH,
              "prompt": PROMPT, "prefill_s": times,
              "prefill_tok_per_s": {k: BATCH * PROMPT * len(v) / sum(v)
                                    for k, v in times.items()},
              "logit_gap_max": float(gap.max()),
              "logit_gap_mean": float(gap.mean()),
              "argmax_agree": agree, "launches": path[own["sage"]]})
        if windowed:
            del sage_cache
            break
        # decode from the sage prefill's cache, then teacher forcing
        eng, cfg = engs["sage"], cfgs["sage"]
        dparams = eng.decode_params(params)
        first = torch.argmax(logits["sage"], -1).to(torch.int32)
        fork = {f: getattr(sage_cache, f).clone() for f in
                ("k", "v", "k_scale", "v_scale", "length")}
        eng.decode_scan(dparams, sage_cache, 4, first)  # warm-up
        for f, t in fork.items():
            getattr(sage_cache, f).copy_(t)
        build.reset_launch_counts()
        t0 = time.perf_counter()
        toks, sage_cache = eng.decode_scan(dparams, sage_cache, NEW, first)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        dcounts = expect_counts(build, {
            **{k: 0 for k in PREFILL_KERNELS}, **quant_counts(0),
            "cache_append": L * NEW, "decode_attention": L * NEW,
            "decode_run": 0})
        if toks.shape != (BATCH, NEW):
            raise AssertionError(f"decode_scan shape {tuple(toks.shape)}")
        for f, t in fork.items():
            getattr(sage_cache, f).copy_(t)
        step1, _ = decode_step(dparams, sage_cache, first, cfg)
        del sage_cache, fork
        build.reset_launch_counts()
        tf_logits, _ = eng.prefill(params, torch.cat([prompt, first[:, None]],
                                                     dim=1))
        expect_counts(build, {"sage_fwd_tri": L, "flash_fwd_causal_self": 0,
                              **quant_counts(L)})
        tf_err = float((step1 - tf_logits).abs().max())
        check("slice_sage teacher forcing", tf_err, TEACHER_TOL)
        gen_eng = Engine(cfg=cfg, s_max=GEN_PROMPT + GEN_NEW,
                         cache_dtype="bfloat16", weight_dtype="int8",
                         device=dev)
        build.reset_launch_counts()
        t0 = time.perf_counter()
        res = gen_eng.generate(params, prompt[:GEN_BATCH, :GEN_PROMPT],
                               GEN_NEW)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        gcounts = expect_counts(build, {
            **{k: (L if k == "sage_fwd_tri" else 0) for k in PREFILL_KERNELS},
            **quant_counts(L), "cache_append": L + L * GEN_NEW,
            "decode_attention": L * GEN_NEW, "decode_run": 0})
        if not torch.isfinite(res.prefill_logits).all() or res.tokens.shape != (
                GEN_BATCH, GEN_NEW):
            raise AssertionError("sage generate: non-finite logits or shapes")
        emit({"phase": "slice_sage", "card": card, "model": "llama-0.88B",
              "batch": BATCH, "prompt": PROMPT, "new_tokens": NEW,
              "cache_dtype": "int8", "weight_dtype": "int8",
              "decode_ms_per_step": 1e3 * decode_s / NEW,
              "teacher_forcing_max_abs_err": tf_err,
              "teacher_tol": TEACHER_TOL,
              "teacher_argmax_agree": float((step1.argmax(-1) == tf_logits
                                             .argmax(-1)).float().mean()),
              "decode_launches": dcounts, "generate_s": gen_s,
              "generate_launches": gcounts})
        del engs, eng, gen_eng, params, dparams, res, step1, tf_logits
        torch.cuda.empty_cache()
    return path


def sage_api_phase(build, sage, dev, card):
    """The public sage entry points at the trainer's per-layer shape (b=1,
    s=8192, 16/8 heads): non-causal sage_attention (B8c, the path of a
    bidirectional model such as the JAX package's DiT); the causal call
    with one-chunk offsets (B8b, the JAX ring's per-step call) against the
    call without (B8a), row by row; and sage_attention_fwd_prequant over
    an int8 K/V of ops.kv_cache (B8b). Each call from zeroed counts: its
    kernel once, the K/V and the q quantization kernels once each (the
    pre-quantized entry the q one only), nothing else. Then
    sage_api_pv_int8. Returns the launch counts of the non-causal call
    (B8c) and of each pv_int8 kernel's call."""
    from long_context_attention_tpu_torch.ops.kv_cache import quantize_kv

    b, s, h, hk, d = 1, TRAIN_SEQ, MODEL["n_heads"], MODEL["n_kv_heads"], 128
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    q, k, v = (torch.randn(shape, generator=gen, device=dev).bfloat16()
               for shape in ((b, s, h, d), (b, s, hk, d), (b, s, hk, d)))
    k8, ks = quantize_kv(k, "int8")
    v8, vs = quantize_kv(v, "int8")
    runs = {}
    for name, kernel, fn in (
            ("noncausal", "sage_fwd_rect", lambda: sage.sage_attention(
                q, k, v, causal=False, return_lse=True)),
            ("causal", "sage_fwd_tri", lambda: sage.sage_attention(
                q, k, v, causal=True, return_lse=True)),
            ("offsets", "sage_fwd_pos", lambda: sage.sage_attention(
                q, k, v, causal=True, q_offsets=[0], kv_offsets=[0],
                return_lse=True)),
            ("prequant", "sage_fwd_pos", lambda: sage.sage_attention_fwd_prequant(
                q, k8, v8, ks.transpose(1, 2), vs.transpose(1, 2),
                causal=True))):
        build.reset_launch_counts()
        out, lse = fn()
        torch.cuda.synchronize()
        counts = build.launch_counts()
        want = {n: 0 for n in counts}
        want.update({kernel: 1, "sage_quant_q": 1,
                     "sage_quant_kv": int(name != "prequant")})
        if counts != want:
            raise AssertionError(f"sage {name} call counts {counts}")
        if not (torch.isfinite(out).all() and torch.isfinite(lse).all()):
            raise AssertionError(f"sage {name} call: non-finite output")
        runs[name] = (counts, out, lse)
    counts_rect = runs["noncausal"][0]
    (_, o, l), (_, wo, wl) = runs["offsets"], runs["causal"]
    err = check_out("sage offsets (B8b) vs none (B8a) out", o, wo)
    check("sage offsets vs none lse", max_err(l, wl), LSE_TOL)
    emit({"phase": "sage_api", "card": card, "seq": s,
          "launches": {n: c for n, (c, _, _) in runs.items()},
          "offsets_row_rel_err": err[1]})
    del runs, o, l, wo, wl, q, k, v, k8, v8
    torch.cuda.empty_cache()
    return {"sage_fwd_rect": counts_rect, **sage_api_pv_int8(build, sage,
                                                            dev, card)}


def sage_api_pv_int8(build, sage, dev, card):
    """The public sage_attention at the 0.88B model's attention width (b=4,
    s=8192, 16/8 heads) with pv_int8=False and True against
    flash_attention on the same bf16 inputs: causal (B8a), non-causal (B8c)
    and windowed (4096 + 4 sinks, B8b). Each sage call from zeroed counts
    launches exactly one sage_quant_kv, one sage_quant_q and its B8 kernel
    (the _pv8 entry with pv_int8), nothing else; each output's gap to the
    bf16 flash output is recorded (row by row against its size, and the
    lse); the three calls of a mode are timed in turns (flash, bf16 PV,
    int8 PV, int8 PV, bf16 PV, flash). Then the registry's full with
    pv_int8=True through one backward: exactly B8a's pv_int8 entry, the
    quantization kernels and B5, finite grads. Returns each pv_int8
    kernel's launches in its call."""
    from long_context_attention_tpu_torch.ops import flash, registry

    b, s, h, hk, d = BATCH, PROMPT, MODEL["n_heads"], MODEL["n_kv_heads"], 128
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    q, k, v = (torch.randn(shape, generator=gen, device=dev).bfloat16()
               for shape in ((b, s, h, d), (b, s, hk, d), (b, s, hk, d)))
    modes = {"causal": ("sage_fwd_tri", dict(causal=True)),
             "noncausal": ("sage_fwd_rect", dict(causal=False)),
             "windowed": ("sage_fwd_pos", dict(
                 causal=True, window_size=(WINDOW, -1), sink_tokens=SINKS))}
    found, pv_counts = {}, {}
    for mode, (kernel, kw) in modes.items():
        fo, fl = flash.flash_attention(q, k, v, return_lse=True, **kw)
        calls = {"flash": lambda: flash.flash_attention(q, k, v, **kw)}
        res = {}
        for pv in (False, True):
            name = kernel + ("_pv8" if pv else "")
            build.reset_launch_counts()
            out, lse = sage.sage_attention(q, k, v, pv_int8=pv,
                                           return_lse=True, **kw)
            torch.cuda.synchronize()
            counts = build.launch_counts()
            want = {n: 0 for n in counts}
            want.update({name: 1, "sage_quant_kv": 1, "sage_quant_q": 1})
            if counts != want:
                raise AssertionError(f"sage {mode} pv_int8={pv} call counts "
                                     f"{counts}")
            if not (torch.isfinite(out).all() and torch.isfinite(lse).all()):
                raise AssertionError(f"sage {mode} pv_int8={pv}: non-finite "
                                     f"output")
            if pv:
                pv_counts[name] = counts
            diff = (out.float() - fo.float()).abs().amax(-1)
            size = fo.float().abs().amax(-1).clamp_min(1e-30)
            res[f"pv_int8={pv}"] = {
                "kernel": name, "max_abs_gap_to_flash": max_err(out, fo),
                "row_rel_gap_to_flash": float((diff / size).max()),
                "lse_gap_to_flash": max_err(lse, fl)}
            calls[f"pv_int8={pv}"] = (lambda pv=pv: sage.sage_attention(
                q, k, v, pv_int8=pv, **kw))
            del out, lse, diff, size
        ms = {n: [] for n in calls}
        for n in ["flash", "pv_int8=False", "pv_int8=True", "pv_int8=True",
                  "pv_int8=False", "flash"]:
            ms[n].append(time_ms(calls[n]))
        found[mode] = {**res, "ms": ms}
        del fo, fl, calls
        torch.cuda.empty_cache()
    # the registry's full with pv_int8, through one backward
    impl = registry.get_attn_impl("sage")
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    dout = torch.randn(q.shape, generator=gen, device=dev).bfloat16()
    build.reset_launch_counts()
    out = impl.full(*leaves, causal=True, pv_int8=True)
    grads = torch.autograd.grad(out, leaves, dout)
    torch.cuda.synchronize()
    counts = build.launch_counts()
    want = {n: 0 for n in counts}
    want.update({"sage_fwd_tri_pv8": 1, "sage_quant_kv": 1, "sage_quant_q": 1,
                 "flash_bwd_fused": 1})
    if counts != want:
        raise AssertionError(f"registry full pv_int8 counts {counts}")
    if not all(bool(torch.isfinite(g).all()) for g in grads):
        raise AssertionError("registry full pv_int8: non-finite gradient")
    emit({"phase": "sage_api_pv_int8", "card": card, "batch": b, "seq": s,
          "modes": found, "registry_full_backward_launches": {
              n: c for n, c in counts.items() if c}})
    del leaves, grads, out, dout, q, k, v
    torch.cuda.empty_cache()
    return {n: c for n, c in pv_counts.items()}


# ---------------------------------------------------------------------------
# phase 10: the block-sparse USP layer
# ---------------------------------------------------------------------------


def usp_sparse_phase(build, sparse, flash, dev, card):
    """LongContextAttention(block_mask=...) at the path's shape (b=1,
    s=32768, 16/8 heads, d=128, tiles of 512) on a one-rank NCCL world
    from make_usp_mesh() (ring 1, ulysses 1: no collective runs, and the
    zigzag order of one rank is the natural one). For each causal mask of
    sparse_masks, from zeroed counts, one forward and backward: exactly one
    B9a, one B9b and one B9c and no other kernel; out and grads finite and,
    row by row, equal to a direct block_sparse_attention call's. Then the
    layer's forward and forward+backward times against the dense
    flash_attention(causal=True) (B1, B1 + B5) on the same inputs, timed
    before and after the masks, with each mask's density, speedup and
    efficiency (speedup * density / 0.5, benchmarks/bench_sparse.py:208).
    Returns the launch counts summed over the three layer calls."""
    import torch.distributed as dist

    from long_context_attention_tpu_torch.parallel import (
        LongContextAttention, make_usp_mesh)

    b, s, h, hk, d = 1, SPARSE_SEQ, MODEL["n_heads"], MODEL["n_kv_heads"], 128
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    q, k, v = (torch.randn(shape, generator=gen, device=dev).bfloat16()
               .requires_grad_()
               for shape in ((b, s, h, d), (b, s, hk, d), (b, s, hk, d)))
    dout = torch.randn((b, s, h, d), generator=gen, device=dev).bfloat16()
    blocks = dict(sparse_block_q=SPARSE_BLOCK, sparse_block_kv=SPARSE_BLOCK)
    only_b9 = {n: int(n in SPARSE_KERNELS) for n in build.KERNELS}

    def fwd_ms(fn):
        with torch.no_grad():
            return time_ms(fn, iters=5, warmup=1)

    def fwd_bwd_ms(fn):
        return time_ms(lambda: torch.autograd.grad(fn(), (q, k, v), dout),
                       iters=3, warmup=1)

    def dense():
        return flash.flash_attention(q, k, v, causal=True)

    mesh = make_usp_mesh()
    try:
        if (mesh.ring, mesh.ulysses, mesh.seq_idx) != (1, 1, 0):
            raise AssertionError(f"usp_sparse: mesh {mesh}")
        layer = LongContextAttention(mesh, layout="zigzag")
        dense_ms = [(fwd_ms(dense), fwd_bwd_ms(dense))]
        total = dict.fromkeys(build.KERNELS, 0)
        masks = {}
        for name, mask in sparse_masks(sparse).items():
            def call(mask=mask):
                return layer(q, k, v, causal=True, block_mask=mask, **blocks)

            build.reset_launch_counts()
            out = call()
            grads = torch.autograd.grad(out, (q, k, v), dout)
            torch.cuda.synchronize()
            counts = expect_counts(build, only_b9)
            for n, c in counts.items():
                total[n] += c
            got = (out.detach(), *grads)
            if not all(bool(torch.isfinite(t).all()) for t in got):
                raise AssertionError(f"usp_sparse {name}: non-finite output")
            ref = sparse.block_sparse_attention(
                q, k, v, mask, causal=True, block_q=SPARSE_BLOCK,
                block_kv=SPARSE_BLOCK)
            want = (ref.detach(), *torch.autograd.grad(ref, (q, k, v), dout))
            errs = {g: check_out(f"usp_sparse {name} {g} vs "
                                 f"block_sparse_attention", a, w)[1]
                    for g, a, w in zip(("out", "dq", "dk", "dv"), got, want)}
            del out, grads, got, ref, want
            torch.cuda.empty_cache()
            masks[name] = {"density": sparse.mask_density(mask, causal=True),
                           "fwd_ms": fwd_ms(call),
                           "fwd_bwd_ms": fwd_bwd_ms(call),
                           "row_rel_err": errs, "launches": counts}
        dense_ms.append((fwd_ms(dense), fwd_bwd_ms(dense)))
    finally:
        dist.destroy_process_group()
    dense_fwd = sum(f for f, _ in dense_ms) / 2
    dense_fb = sum(fb for _, fb in dense_ms) / 2
    for m in masks.values():
        for key, ref_ms in (("fwd", dense_fwd), ("fwd_bwd", dense_fb)):
            m[f"{key}_speedup"] = ref_ms / m[f"{key}_ms"]
            m[f"{key}_efficiency"] = m[f"{key}_speedup"] * m["density"] / 0.5
    emit({"phase": "usp_sparse", "card": card, "layer":
          "LongContextAttention(layout='zigzag'), ring 1 x ulysses 1 (NCCL)",
          "batch": b, "seq": s, "heads": h, "kv_heads": hk, "head_dim": d,
          "block": SPARSE_BLOCK, "dense_causal_fwd_ms": [f for f, _ in dense_ms],
          "dense_causal_fwd_bwd_ms": [fb for _, fb in dense_ms],
          "masks": masks})
    return total


# ---------------------------------------------------------------------------
# phases 11-13: the dense ring, the dense USP layer, training over a mesh
# ---------------------------------------------------------------------------

# ring_emulated: every (rank, step) call of a W=4 ring on one card, per
# layout (the bidirectional ring in the basic layout), s = 32768
RING_LAYOUTS = (("basic", {}), ("zigzag", {}), ("stripe", {}),
                ("bidirectional basic", dict(layout="basic",
                                             bidirectional=True)))
# ring x sage direct-int8 against one-device sage_attention: the bound of
# the JAX package's own check of the two (tests/test_sage.py:345)
RING_SAGE_TOL = 5e-2
# end to end in bf16 (tests/test_ring.py's gate)
BF16_ATOL = 1e-1


def ring_emulated_phase(build, flash, ring, dev, card):
    """A W=4 ring on one card: for each layout (RING_LAYOUTS) every (rank,
    step) call that ring_attention_local makes, at the kwargs of the ring's
    own ring_step_kwargs, through the registry's pallas impl (B3 forward,
    B2a + B2b backward); each rank's per-step (out, lse) merged in fp32
    (ops/merge.py), and the backward fed the merged out and lse, each
    rank's dq summed and each dk/dv partial summed onto its K/V's owner, as
    the two-ring backward does. Held against one-device
    flash_attention(causal=True) fwd+bwd (B1 + B5) on the unpermuted
    sequence: out within ROW_REL_TOL of each row, out and grads within
    BF16_ATOL. Then zigzag with impl sage and kv_quant="int8": the rotated
    int8 K/V through B8b, against one-device sage_attention. Returns the
    launch counts of one layout's ring (W * W calls of each kernel)."""
    from long_context_attention_tpu_torch.ops.merge import merge_attn_blocks
    from long_context_attention_tpu_torch.ops.registry import get_attn_impl
    from long_context_attention_tpu_torch.ops.sage import sage_attention
    from long_context_attention_tpu_torch.parallel.layouts import (
        permute_for_layout, unpermute_from_layout)

    W, L = RING_W, RING_LOCAL
    b, s, h, hk, d = 1, W * L, MODEL["n_heads"], MODEL["n_kv_heads"], 128
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    q, k, v = (torch.randn(shape, generator=gen, device=dev).bfloat16()
               .requires_grad_()
               for shape in ((b, s, h, d), (b, s, hk, d), (b, s, hk, d)))
    dout = torch.randn((b, s, h, d), generator=gen, device=dev).bfloat16()
    ref = flash.flash_attention(q, k, v, causal=True)
    want = (ref.detach(), *torch.autograd.grad(ref, (q, k, v), dout))
    del ref
    impl = get_attn_impl("pallas")
    ring_kernels = ("flash_fwd_pos", "flash_bwd_dq", "flash_bwd_dkv")
    results, counts = {}, None
    for tag, fields in RING_LAYOUTS:
        cfg = ring.RingConfig(ring_size=W, causal=True,
                              **(fields or dict(layout=tag)))
        shards = [permute_for_layout(t.detach(), cfg.layout, W).chunk(W, 1)
                  for t in (q, k, v, dout)]

        def kv_at(rank, step):  # the K/V rank holds at step (ring order)
            if cfg.bidirectional:
                a, c = (rank - step) % W, (rank + step) % W
                return [torch.cat([x[a][:, :L // 2], x[c][:, L // 2:]], 1)
                        for x in shards[1:3]]
            return [x[(rank - step) % W] for x in shards[1:3]]

        build.reset_launch_counts()
        t0 = time.perf_counter()
        outs, lses = [], []
        for r in range(W):
            acc = None
            for t in range(W):
                kw = ring.ring_step_kwargs(cfg, r, t, L, L)
                o, l = impl.fwd(shards[0][r], *kv_at(r, t), **kw)
                acc = ((o.float(), l) if acc is None else
                       merge_attn_blocks(acc[0], acc[1], o, l))
            outs.append(acc[0].to(q.dtype))
            lses.append(acc[1])
        dq = [torch.zeros_like(x, dtype=torch.float32) for x in shards[0]]
        dk = [torch.zeros_like(x, dtype=torch.float32) for x in shards[1]]
        dv = [torch.zeros_like(x, dtype=torch.float32) for x in shards[2]]
        for r in range(W):
            for t in range(W):
                kw = ring.ring_step_kwargs(cfg, r, t, L, L)
                gq, gk, gv = impl.bwd(shards[0][r], *kv_at(r, t), outs[r],
                                      lses[r], shards[3][r], **kw)
                dq[r] += gq
                if cfg.bidirectional:  # each half home to its owner
                    a, c = (r - t) % W, (r + t) % W
                    dk[a][:, :L // 2] += gk[:, :L // 2]
                    dv[a][:, :L // 2] += gv[:, :L // 2]
                    dk[c][:, L // 2:] += gk[:, L // 2:]
                    dv[c][:, L // 2:] += gv[:, L // 2:]
                else:
                    dk[(r - t) % W] += gk
                    dv[(r - t) % W] += gv
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
        counts = expect_counts(build, {
            n: W * W if n in ring_kernels else 0 for n in build.KERNELS})
        got = [unpermute_from_layout(torch.cat(x, 1), cfg.layout, W)
               for x in (outs, dq, dk, dv)]
        errs = {}
        for name, a, w in zip(("out", "dq", "dk", "dv"), got, want):
            e = max_err(a, w)
            check(f"ring_emulated {tag} {name}", e, BF16_ATOL)
            errs[name] = e
        errs["out_row_rel"] = check_out(f"ring_emulated {tag} out vs "
                                        f"flash_attention", got[0],
                                        want[0])[1]
        results[tag] = {"max_abs_err": errs, "launches": counts,
                        "wall_ms": wall_ms}
        del shards, outs, lses, dq, dk, dv, got
        torch.cuda.empty_cache()

    # ring x sage direct-int8, zigzag: the rotated int8 K/V into B8b
    cfg = ring.RingConfig(ring_size=W, causal=True, layout="zigzag",
                          impl="sage", kv_quant="int8")
    qs, ks, vs = (permute_for_layout(t.detach(), "zigzag", W).chunk(W, 1)
                  for t in (q, k, v))
    parts = [ring._kv_parts(cfg, ks[r], vs[r]) for r in range(W)]
    build.reset_launch_counts()
    outs = []
    for r in range(W):
        acc = None
        for t in range(W):
            kw = ring.ring_step_kwargs(cfg, r, t, L, L)
            o, l = ring._block(cfg, None, qs[r], parts[(r - t) % W], kw)
            acc = ((o.float(), l) if acc is None else
                   merge_attn_blocks(acc[0], acc[1], o, l))
        outs.append(acc[0].to(q.dtype))
    torch.cuda.synchronize()
    sage_counts = expect_counts(build, {
        n: W * W if n == "sage_fwd_pos" else int(n == "sage_quant_q") * W * W
        for n in build.KERNELS})
    got = unpermute_from_layout(torch.cat(outs, 1), "zigzag", W)
    one = sage_attention(q.detach(), k.detach(), v.detach(), causal=True)
    sage_err = max_err(got, one)
    check("ring_emulated zigzag sage int8 vs sage_attention", sage_err,
          RING_SAGE_TOL)
    # kv_quant fp8 and int4, zigzag: each rank's K/V quantized once, the
    # held quantized bytes into B3 at every (rank, step), against one-device
    # attention over the dequantized K/V
    from long_context_attention_tpu_torch.ops.kv_cache import (
        dequantize_kv, quantize_kv)

    quant, quant_counts = {}, {}
    for kq in QUANT_DTYPES:
        cfg = ring.RingConfig(ring_size=W, causal=True, layout="zigzag",
                              kv_quant=kq)
        parts = [ring._kv_parts(cfg, ks[r], vs[r]) for r in range(W)]
        build.reset_launch_counts()
        t0 = time.perf_counter()
        outs = []
        for r in range(W):
            acc = None
            for t in range(W):
                kw = ring.ring_step_kwargs(cfg, r, t, L, L)
                o, l = ring._block(cfg, impl, qs[r], parts[(r - t) % W], kw)
                acc = ((o.float(), l) if acc is None else
                       merge_attn_blocks(acc[0], acc[1], o, l))
            outs.append(acc[0].to(q.dtype))
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
        quant_counts[kq] = expect_counts(build, {
            n: W * W if n == "flash_fwd_pos" else 0 for n in build.KERNELS})
        got = unpermute_from_layout(torch.cat(outs, 1), "zigzag", W)
        kd, vd = (dequantize_kv(*quantize_kv(t.detach(), kq), t.dtype)
                  for t in (k, v))
        one = flash.flash_attention(q.detach(), kd, vd, causal=True)
        err = max_err(got, one)
        check(f"ring_emulated zigzag kv_quant={kq} vs flash_attention over "
              f"the dequantized K/V", err, BF16_ATOL)
        row_err = check_out(f"ring_emulated zigzag kv_quant={kq} out", got,
                            one)[1]
        rotated = sum(t.numel() * t.element_size() for t in parts[0])
        quant[kq] = {"max_abs_err": err, "out_row_rel": row_err,
                     "rotated_bytes_per_hop": rotated,
                     "launches": quant_counts[kq], "wall_ms": wall_ms}
        del parts, outs, got, kd, vd, one
        torch.cuda.empty_cache()
    emit({"phase": "ring_emulated", "card": card, "ring": W, "seq": s,
          "local": L, "heads": h, "kv_heads": hk, "layouts": results,
          "sage_int8": {"max_abs_err_vs_sage_attention": sage_err,
                        "tol": RING_SAGE_TOL, "launches": sage_counts},
          "kv_quant": quant, "tol": BF16_ATOL})
    del q, k, v, dout, want
    torch.cuda.empty_cache()
    return counts, sage_counts, quant_counts


def ring_features_phase(build, flash, ring, dev, card):
    """W=4 zigzag and stripe rings over packed documents with ALiBi (the
    geometric slopes) and dropout 0.1: every (rank, step) call that
    ring_attention_local makes, at the ring's own ring_step_kwargs with the
    rank's q ids, the held K/V's ids, the slopes and the seed (B3, B2a, B2b
    with the features), merged and summed onto owners as in
    ring_emulated_phase, against one-device flash_attention with the global
    ids, slopes and seed, fwd+bwd (B3 + B2a + B2b at one chunk): out within
    ROW_REL_TOL of each row, out and grads within BF16_ATOL. The check that
    the distributed dropout pattern equals the single-device one. Returns
    one ring's launch counts."""
    from long_context_attention_tpu_torch.ops.merge import merge_attn_blocks
    from long_context_attention_tpu_torch.ops.registry import get_attn_impl
    from long_context_attention_tpu_torch.parallel.layouts import (
        permute_for_layout, unpermute_from_layout)

    W, L = RING_W, RING_LOCAL
    b, s, h, hk, d = 1, W * L, MODEL["n_heads"], MODEL["n_kv_heads"], 128
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    q, k, v = (torch.randn(shape, generator=gen, device=dev).bfloat16()
               .requires_grad_()
               for shape in ((b, s, h, d), (b, s, hk, d), (b, s, hk, d)))
    dout = torch.randn((b, s, h, d), generator=gen, device=dev).bfloat16()
    ids = packed_ids(s, dev, SEED + 2)
    slopes = alibi_slopes(h, dev)
    seed = (SEED + 0xD509, 0)
    ref = flash.flash_attention(q, k, v, causal=True, q_segment_ids=ids,
                                kv_segment_ids=ids, alibi_slopes=slopes,
                                dropout_p=DROPOUT_P, dropout_seed=seed)
    want = (ref.detach(), *torch.autograd.grad(ref, (q, k, v), dout))
    del ref
    impl = get_attn_impl("pallas")
    ring_kernels = ("flash_fwd_pos", "flash_bwd_dq", "flash_bwd_dkv")
    results, counts = {}, None
    for layout in ("zigzag", "stripe"):
        cfg = ring.RingConfig(ring_size=W, causal=True, layout=layout,
                              dropout_p=DROPOUT_P)
        shards = [permute_for_layout(t.detach(), layout, W).chunk(W, 1)
                  for t in (q, k, v, dout, ids)]

        def step_kw(r, t):  # the kwargs of rank r's step t (ring order)
            src = (r - t) % W
            return src, ring.ring_step_kwargs(
                cfg, r, t, L, L, q_seg=shards[4][r], kv_seg=shards[4][src],
                alibi_sl=slopes, seed=seed)

        build.reset_launch_counts()
        t0 = time.perf_counter()
        outs, lses = [], []
        for r in range(W):
            acc = None
            for t in range(W):
                src, kw = step_kw(r, t)
                o, l = impl.fwd(shards[0][r], shards[1][src], shards[2][src],
                                **kw)
                acc = ((o.float(), l) if acc is None else
                       merge_attn_blocks(acc[0], acc[1], o, l))
            outs.append(acc[0].to(q.dtype))
            lses.append(acc[1])
        dq = [torch.zeros_like(x, dtype=torch.float32) for x in shards[0]]
        dk = [torch.zeros_like(x, dtype=torch.float32) for x in shards[1]]
        dv = [torch.zeros_like(x, dtype=torch.float32) for x in shards[2]]
        for r in range(W):
            for t in range(W):
                src, kw = step_kw(r, t)
                gq, gk, gv = impl.bwd(shards[0][r], shards[1][src],
                                      shards[2][src], outs[r], lses[r],
                                      shards[3][r], **kw)
                dq[r] += gq
                dk[src] += gk
                dv[src] += gv
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
        counts = expect_counts(build, {
            n: W * W if n in ring_kernels else 0 for n in build.KERNELS})
        got = [unpermute_from_layout(torch.cat(x, 1), layout, W)
               for x in (outs, dq, dk, dv)]
        errs = {}
        for name, a, w in zip(("out", "dq", "dk", "dv"), got, want):
            e = max_err(a, w)
            check(f"ring_features {layout} {name}", e, BF16_ATOL)
            errs[name] = e
        errs["out_row_rel"] = check_out(
            f"ring_features {layout} out vs one-device flash_attention",
            got[0], want[0])[1]
        results[layout] = {"max_abs_err": errs, "launches": counts,
                           "wall_ms": wall_ms}
        del shards, outs, lses, dq, dk, dv, got
        torch.cuda.empty_cache()
    emit({"phase": "ring_emulated_features", "card": card, "ring": W,
          "seq": s, "local": L, "heads": h, "kv_heads": hk,
          "features": f"packed documents (lengths {DOC_LENS}), ALiBi "
                      f"geometric slopes, dropout {DROPOUT_P}",
          "layouts": results})
    del q, k, v, dout, want
    torch.cuda.empty_cache()
    return counts


def usp_dense_phase(build, flash, dev, card):
    """LongContextAttention(layout="zigzag") with no mask on a one-rank
    NCCL mesh (make_usp_mesh()) at b=1, s=32768, 16/8 heads: the zigzag
    order of one rank is the natural one, and its descriptor is the two
    chunks (0, s/2), so the public entry runs the multi-chunk B3, B2a and
    B2b, exactly once each per forward and backward and nothing else.
    Against direct flash_attention(causal=True) (B1 + B5): out within
    ROW_REL_TOL of each row, grads within BF16_ATOL; the layer's fwd+bwd
    time beside its three kernels' own. Returns the layer's launch counts."""
    import torch.distributed as dist

    from long_context_attention_tpu_torch.parallel import (
        LongContextAttention, make_usp_mesh)

    b, s, h, hk, d = 1, SPARSE_SEQ, MODEL["n_heads"], MODEL["n_kv_heads"], 128
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    q, k, v = (torch.randn(shape, generator=gen, device=dev).bfloat16()
               .requires_grad_()
               for shape in ((b, s, h, d), (b, s, hk, d), (b, s, hk, d)))
    dout = torch.randn((b, s, h, d), generator=gen, device=dev).bfloat16()
    mesh = make_usp_mesh()
    try:
        layer = LongContextAttention(mesh, layout="zigzag")
        build.reset_launch_counts()
        out = layer(q, k, v, causal=True)
        grads = torch.autograd.grad(out, (q, k, v), dout)
        torch.cuda.synchronize()
        counts = expect_counts(build, {
            n: int(n in ("flash_fwd_pos", "flash_bwd_dq", "flash_bwd_dkv"))
            for n in build.KERNELS})
        ref = flash.flash_attention(q, k, v, causal=True)
        want = (ref.detach(), *torch.autograd.grad(ref, (q, k, v), dout))
        errs = {"out_row_rel": check_out("usp_dense out vs flash_attention",
                                         out.detach(), want[0])[1]}
        for name, a, w in zip(("dq", "dk", "dv"), grads, want[1:]):
            errs[name] = max_err(a, w)
            check(f"usp_dense {name} vs flash_attention", errs[name],
                  BF16_ATOL)
        del out, grads, ref, want
        torch.cuda.empty_cache()
        layer_ms = time_ms(lambda: torch.autograd.grad(
            layer(q, k, v, causal=True), (q, k, v), dout), iters=5,
            warmup=1)
        dense_ms = time_ms(lambda: torch.autograd.grad(
            flash.flash_attention(q, k, v, causal=True), (q, k, v), dout),
            iters=5, warmup=1)
        # the three kernels alone, at the layer's descriptor
        pos = flash.Positions((0, s // 2), (0, s // 2))
        scale = d ** -0.5
        kt, vt = k.detach().transpose(1, 2), v.detach().transpose(1, 2)
        qd = q.detach()
        o, l = flash.flash_fwd_pos(qd, kt, vt, pos=pos, causal=True,
                                   scale=scale)
        delta = (dout.float() * o.float()).sum(-1).transpose(1, 2)
        args = (qd, k.detach(), v.detach(), dout, l, delta.contiguous())
        kern_ms = {
            "B3": time_ms(lambda: flash.flash_fwd_pos(
                qd, kt, vt, pos=pos, causal=True, scale=scale), iters=5),
            "B2a": time_ms(lambda: flash.flash_bwd_dq(
                *args, pos=pos, causal=True, scale=scale), iters=5),
            "B2b": time_ms(lambda: flash.flash_bwd_dkv(
                *args, pos=pos, causal=True, scale=scale), iters=5)}
        # B3 at the trainer's shape (train_usp's per-layer call, s=8192)
        # beside B1 on the same inputs
        n = TRAIN_SEQ
        q8k, k8k, v8k = (t[:, :n].contiguous() for t in (qd, kt.transpose(
            1, 2), vt.transpose(1, 2)))
        pos8k = flash.Positions((0, n // 2), (0, n // 2))
        at_train = {
            "seq": n,
            "B3_ms": time_ms(lambda: flash.flash_fwd_pos(
                q8k, k8k.transpose(1, 2), v8k.transpose(1, 2), pos=pos8k,
                causal=True, scale=scale)),
            "B1_ms": time_ms(lambda: flash.flash_fwd_causal_self(
                q8k, k8k, v8k, scale=scale))}
    finally:
        dist.destroy_process_group()
    emit({"phase": "usp_dense", "card": card, "layer":
          "LongContextAttention(layout='zigzag'), ring 1 x ulysses 1 (NCCL)",
          "batch": b, "seq": s, "heads": h, "kv_heads": hk, "head_dim": d,
          "launches": counts, "errors": errs, "layer_fwd_bwd_ms": layer_ms,
          "kernels_ms": kern_ms, "kernels_sum_ms": sum(kern_ms.values()),
          "zigzag_w1_at_train_seq": at_train,
          "flash_attention_fwd_bwd_ms": dense_ms})
    del q, k, v, dout
    torch.cuda.empty_cache()
    return counts


# usp_varlen's outputs held against the plain versions at the layer's own
# descriptor (q and kv chunks at 0 and s/2): out, lse and dq on the q rows
# of VARLEN_ROWS, dk and dv on the kv columns of VARLEN_COLS, each a slice
# of VARLEN_SLICE from its first index; the blocks at s/2 - 256 straddle
# the chunk boundary. A plain slice holds a few (16, 512, s) fp32 tensors,
# 1 GiB each.
VARLEN_SLICE = 512
VARLEN_ROWS = (SPARSE_SEQ // 2 - VARLEN_SLICE // 2, SPARSE_SEQ - VARLEN_SLICE)
VARLEN_COLS = (0, SPARSE_SEQ // 2 - VARLEN_SLICE // 2)


def half_offsets(a, n, s):
    """The chunk offsets of local tokens [a, a + n) of a side cut in two
    chunks at 0 and s/2 (unit stride): one chunk, or two of n/2 when the
    slice straddles s/2."""
    half = s // 2
    if a < half < a + n:
        if half - a != n // 2:
            raise ValueError(f"slice [{a}, {a + n}) straddles {half} "
                             f"unevenly")
        return (a, half)
    return (a,)


def varlen_plain_checks(flash, out, grads, lse, q, k, v, dout, ids, slopes,
                        word):
    """usp_varlen's out and grads (the layer's, bf16) and the lse of B3 at
    the layer's descriptor and features, held slice by slice against
    flash_fwd_pos_plain, flash_bwd_dq_plain and flash_bwd_dkv_plain at that
    descriptor (VARLEN_ROWS, VARLEN_COLS): each row within ROW_REL_TOL, the
    forward by check_fwd_rows (every row sees its own column), dq with the
    documents' first rows (one visible column) as cancel rows. The plain
    side's delta is the layer backward's, from the bf16 out. Returns
    {slice: worst row}."""
    b, s, h, d = q.shape
    n = VARLEN_SLICE
    mk = dict(causal=True, scale=d ** -0.5)
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    whole = half_offsets(0, s, s)
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)
    res = {}
    for a in VARLEN_ROWS:
        r = slice(a, a + n)
        pos = flash.Positions(half_offsets(a, n, s), whole)
        feat = flash.Features(ids[:, r].contiguous(), ids, slopes, DROPOUT_P,
                              (word, 0))
        pout, plse = flash.flash_fwd_pos_plain(q[:, r], kt, vt, pos=pos,
                                               features=feat, **mk)
        torch.cuda.synchronize()
        (_, worst), _ = check_fwd_rows(
            f"usp_varlen rows {a}+{n} out, lse vs plain", out[:, r],
            lse[:, :, r], pout, plse, torch.ones((b, n), dtype=torch.bool,
                                                 device=q.device))
        res[f"rows {a}+{n} out"] = worst
        del pout, plse
        pdq = flash.flash_bwd_dq_plain(
            q[:, r], k, v, dout[:, r], lse[:, :, r].contiguous(),
            delta[:, :, r].contiguous(), pos=pos, features=feat, **mk)
        first = (ids[0, r] != ids[0, a - 1:a + n - 1]).nonzero()[:, 0]
        res[f"rows {a}+{n} dq"] = check_out(
            f"usp_varlen rows {a}+{n} dq vs plain", grads[0][:, r], pdq,
            first)[1]
        del pdq
        torch.cuda.empty_cache()
    for c in VARLEN_COLS:
        cs = slice(c, c + n)
        pos = flash.Positions(whole, half_offsets(c, n, s))
        feat = flash.Features(ids, ids[:, cs].contiguous(), slopes,
                              DROPOUT_P, (word, 0))
        pdk, pdv = flash.flash_bwd_dkv_plain(
            q, k[:, cs], v[:, cs], dout, lse, delta, pos=pos, features=feat,
            **mk)
        for name, got, want in (("dk", grads[1], pdk), ("dv", grads[2], pdv)):
            res[f"cols {c}+{n} {name}"] = check_out(
                f"usp_varlen cols {c}+{n} {name} vs plain", got[:, cs],
                want)[1]
        del pdk, pdv
        torch.cuda.empty_cache()
    return res


def usp_varlen_phase(build, flash, dev, card, model=None, tag="usp_varlen"):
    """The slice's path: LongContextAttention(layout="zigzag") on a one-rank
    NCCL mesh (make_usp_mesh()) at ``model``'s attention width (the 0.88B
    model's by default: b=1, s=32768, 16/8 heads, d=128; at head dim 64 the
    d = 64 kernels), causal, on packed documents (DOC_LENS)
    with the geometric ALiBi slopes and dropout 0.1 keyed by a seeded
    torch.Generator: exactly one B3, one B2a and one B2b per forward and
    backward, nothing else; against a direct flash_attention with the same
    ids, slopes and key (B3 at one chunk, B2a + B2b): out within
    ROW_REL_TOL of each row, grads within BF16_ATOL; and slices of its out,
    lse and grads against the plain versions at the layer's own two-chunk
    descriptor (varlen_plain_checks). The key is a CPU generator: its word
    reaches the kernels with no device sync (ops/flash.py dropout_word).
    The layer's fwd+bwd time beside the same layer without the features and
    beside its three kernels' own. Returns the layer's launch counts."""
    import torch.distributed as dist

    from long_context_attention_tpu_torch.parallel import (
        LongContextAttention, make_usp_mesh)

    model = model or MODEL
    b, s, h, hk = 1, SPARSE_SEQ, model["n_heads"], model["n_kv_heads"]
    d = model["head_dim"]
    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    q, k, v = (torch.randn(shape, generator=gen, device=dev).bfloat16()
               .requires_grad_()
               for shape in ((b, s, h, d), (b, s, hk, d), (b, s, hk, d)))
    dout = torch.randn((b, s, h, d), generator=gen, device=dev).bfloat16()
    ids = packed_ids(s, dev, SEED + 3)
    slopes = alibi_slopes(h, dev)

    def key():  # the training step's dropout key, seeded alike each time
        return torch.Generator().manual_seed(SEED + 11)

    feats = dict(segment_ids=ids, alibi_slopes=slopes, dropout_p=DROPOUT_P)
    mesh = make_usp_mesh()
    try:
        layer = LongContextAttention(mesh, layout="zigzag")
        build.reset_launch_counts()
        out = layer(q, k, v, causal=True, dropout_key=key(), **feats)
        grads = torch.autograd.grad(out, (q, k, v), dout)
        torch.cuda.synchronize()
        counts = exact_counts(build, dict.fromkeys(
            ("flash_fwd_pos", "flash_bwd_dq", "flash_bwd_dkv"), 1), d)
        ref = flash.flash_attention(q, k, v, causal=True, q_segment_ids=ids,
                                    kv_segment_ids=ids, alibi_slopes=slopes,
                                    dropout_p=DROPOUT_P, dropout_key=key())
        want = (ref.detach(), *torch.autograd.grad(ref, (q, k, v), dout))
        errs = {"out_row_rel": check_out(f"{tag} out vs flash_attention",
                                         out.detach(), want[0])[1]}
        for name, a, w in zip(("dq", "dk", "dv"), grads, want[1:]):
            errs[name] = max_err(a, w)
            check(f"{tag} {name} vs flash_attention", errs[name], BF16_ATOL)
        del ref, want
        torch.cuda.empty_cache()
        # B3 at the layer's descriptor and features gives the lse the layer
        # keeps; its out and grads against the plain versions
        word = flash.dropout_word(key())
        pos = flash.Positions((0, s // 2), (0, s // 2))
        scale = d ** -0.5
        kt, vt = k.detach().transpose(1, 2), v.detach().transpose(1, 2)
        qd = q.detach()
        feat = flash.Features(ids, ids, slopes, DROPOUT_P, (word, 0))
        fw = dict(pos=pos, causal=True, scale=scale, features=feat)
        o, l = flash.flash_fwd_pos(qd, kt, vt, **fw)
        errs["plain_slices_row_rel"] = varlen_plain_checks(
            flash, out.detach(), grads, l, qd, k.detach(), v.detach(), dout,
            ids, slopes, word)
        del out, grads
        torch.cuda.empty_cache()
        layer_ms = time_ms(lambda: torch.autograd.grad(
            layer(q, k, v, causal=True, dropout_key=key(), **feats),
            (q, k, v), dout), iters=5, warmup=1)
        dense_layer_ms = time_ms(lambda: torch.autograd.grad(
            layer(q, k, v, causal=True), (q, k, v), dout), iters=5,
            warmup=1)
        # the three kernels alone, at the layer's descriptor and features
        delta = (dout.float() * o.float()).sum(-1).transpose(1, 2)
        args = (qd, k.detach(), v.detach(), dout, l, delta.contiguous())
        kern_ms = {
            "B3": time_ms(lambda: flash.flash_fwd_pos(qd, kt, vt, **fw),
                          iters=5),
            "B2a": time_ms(lambda: flash.flash_bwd_dq(*args, **fw), iters=5),
            "B2b": time_ms(lambda: flash.flash_bwd_dkv(*args, **fw),
                           iters=5)}
    finally:
        dist.destroy_process_group()
    emit({"phase": tag, "card": card, "layer":
          "LongContextAttention(layout='zigzag'), ring 1 x ulysses 1 (NCCL)",
          "batch": b, "seq": s, "heads": h, "kv_heads": hk, "head_dim": d,
          "documents": int(ids.max()), "features":
          f"packed documents (lengths {DOC_LENS}), ALiBi geometric slopes, "
          f"dropout {DROPOUT_P}", "launches": counts, "errors": errs,
          "layer_fwd_bwd_ms": layer_ms,
          "layer_without_features_fwd_bwd_ms": dense_layer_ms,
          "kernels_ms": kern_ms, "kernels_sum_ms": sum(kern_ms.values())})
    del q, k, v, dout
    torch.cuda.empty_cache()
    return counts


# train_usp: remat policies and steps over the one-rank mesh
USP_TRAIN_STEPS = (("none", 3), ("attn", 2))
# the mesh step's loss against the single-device step's on one batch
USP_LOSS_TOL = 1e-2
# a leaf after one step against the single-device step's, of its largest
# value: two bf16 ulps (AdamW's first update is about lr in size, below one
# ulp of most weights, so the leaves differ where a gradient's sign does)
USP_LEAF_TOL = 2.0 ** -7
# moe_train and zero_train: a leaf's first update against the
# single-device step's, ||p1 - p1_want|| over ||p1_want - p0||. USP_LEAF_TOL
# alone passes a step that moved no weight (one update is about an ulp);
# this reads 1 for that, about 1.4 for an update uncorrelated with the
# single device's, and 2 sqrt(f) where a share f of the elements moved
# the other way (a gradient within the rounding of zero)
UPDATE_TOL = 0.25


def train_usp_phase(pkg, build, dev, card, model=None, tag="train_usp"):
    """make_train_step(mesh=make_usp_mesh()) on a full-width ``model`` (the
    0.88B config by default; layout zigzag: the ring of one's two-chunk
    descriptor) at b=1, s=8192, AdamW as in train: every layer's attention
    through usp_attention_local (B3 forward, B2a + B2b backward, at the
    model's head dim; B1 and B5 never). From the same initial params and
    batch, one single-device step (B1 + B5) and one mesh step: their
    losses within USP_LOSS_TOL, each leaf within USP_LEAF_TOL of its
    largest value and its update within UPDATE_TOL of the single device's.
    Then timed steps under remat none and attn with exact launch counts and
    a falling loss, beside the single-device steps' time."""
    import torch.distributed as dist

    from long_context_attention_tpu_torch.models.llama import (
        init_params, make_train_step, param_leaves)
    from long_context_attention_tpu_torch.parallel import make_usp_mesh

    model = model or MODEL
    L, d = model["n_layers"], model["head_dim"]
    usp_model = dict(model, layout="zigzag")
    tokens, labels, mask = train_batch(model["vocab"], TRAIN_SEQ, dev)
    opt = functools.partial(torch.optim.AdamW, lr=LR,
                            weight_decay=WEIGHT_DECAY)

    def fresh(cfg):
        return init_params(torch.Generator(device=dev).manual_seed(SEED),
                           cfg, device=dev)

    mesh = make_usp_mesh()
    report = {}
    try:
        cfg = pkg.ModelConfig(**usp_model)
        single = make_train_step(cfg, opt, device=dev)
        sharded = make_train_step(cfg, opt, mesh=mesh)
        p1, s1, loss1 = single(fresh(cfg), None, tokens, labels, mask)
        p2, s2, loss2 = sharded(fresh(cfg), None, tokens, labels, mask)
        dloss = abs(float(loss1) - float(loss2))
        check(f"{tag} loss vs single device", dloss, USP_LOSS_TOL)
        worst = leaf_rel(p2, p1)
        check(f"{tag} leaves vs single device", worst, USP_LEAF_TOL)
        upd, upd_leaf = update_rel(p2, p1, fresh(cfg))
        check(f"{tag} update of {upd_leaf} vs single device", upd,
              UPDATE_TOL)
        report["one_step"] = {"loss_single": float(loss1),
                              "loss_mesh": float(loss2), "loss_diff": dloss,
                              "worst_leaf_rel": worst,
                              "worst_update_rel": upd,
                              "worst_update_leaf": upd_leaf}
        # the single-device steps' time on this batch (B1 + B5)
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            p1, s1, loss1 = single(p1, s1, tokens, labels, mask)
            float(loss1)
            times.append(time.perf_counter() - t0)
        report["single_ms_per_step"] = 1e3 * sum(times) / len(times)
        del p1, s1, p2, s2, single, sharded
        torch.cuda.empty_cache()
        for remat, steps in USP_TRAIN_STEPS:
            cfg = pkg.ModelConfig(**usp_model, remat=remat)
            params = fresh(cfg)
            step = make_train_step(cfg, opt, mesh=mesh)
            params, state, loss = step(params, None, tokens, labels, mask)
            losses = [float(loss)]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            build.reset_launch_counts()
            times = []
            for _ in range(steps):
                t0 = time.perf_counter()
                params, state, loss = step(params, state, tokens, labels,
                                           mask)
                losses.append(float(loss))
                times.append(time.perf_counter() - t0)
            counts = exact_counts(build, dict.fromkeys(
                ("flash_fwd_pos", "flash_bwd_dq", "flash_bwd_dkv"),
                steps * L), d)
            if not all(math.isfinite(x) for x in losses):
                raise AssertionError(f"{tag} {remat}: loss {losses}")
            if not losses[-1] < losses[0]:
                raise AssertionError(f"{tag} {remat}: the loss did not "
                                     f"fall: {losses}")
            ms = 1e3 * sum(times) / steps
            n_params = sum(t.numel() for t in param_leaves(params))
            flops = 6 * TRAIN_SEQ * n_params
            report[remat] = {
                "steps": steps, "ms_per_step": ms,
                "ms_all": [1e3 * t for t in times],
                "tok_per_s": TRAIN_SEQ / (ms / 1e3),
                "mfu": flops / (ms / 1e3) / PEAK_BF16_FLOPS,
                "max_memory_allocated_gb":
                    torch.cuda.max_memory_allocated() / 2 ** 30,
                "losses": losses, "launches_per_step":
                    {n: c // steps for n, c in counts.items() if c}}
            del params, state, step, loss
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    report["single_tok_per_s"] = TRAIN_SEQ / (report["single_ms_per_step"]
                                              / 1e3)
    emit({"phase": tag, "card": card, "mesh": "dp 1 x ring 1 x "
          "ulysses 1 (NCCL)", "layout": "zigzag", "batch": 1,
          "seq": TRAIN_SEQ, "head_dim": d, **report})
    return counts


# ---------------------------------------------------------------------------
# the sequence-sharded prefill, the async USP layer and the DiT family
# ---------------------------------------------------------------------------

# Wan2.1-T2V-1.3B's widths (Wan-AI/Wan2.1-T2V-1.3B config.json: dim 1536,
# 12 heads of 128, ffn_dim 8960, 30 layers, 16 latent channels patchified
# by (1, 2, 2): in_dim 64) on the repo's DiT block (adaLN-zero, unit-weight
# RMSNorm, tanh GELU, self-attention only: no text cross-attention, no
# RoPE); random weights from the seed, nothing downloaded
WAN_DIT = dict(in_dim=64, dim=1536, n_layers=30, n_heads=12, head_dim=128,
               ffn_hidden=8960)
# a 480p (832 x 480) clip through Wan's VAE (8x spatial, 4x temporal
# strides: 1 + (frames - 1) / 4 latent frames) and the (1, 2, 2) patch:
# 52 x 30 patches a latent frame; 81 frames give 21 latent frames, the
# forward's 32760 tokens, and 17 frames 5, training's 7800. Neither is a
# multiple of 128: the last kv tile of every non-causal call is ragged.
DIT_FWD_TOKENS = 21 * 30 * 52
DIT_TRAIN_TOKENS = 5 * 30 * 52
DIT_TRAIN_STEPS = 3
# the DiT's 2-layer checks against the CPU plain path: the forward at the
# training token count, the gradient check at grad_check's sequence
DIT_CHECK_LAYERS = 2


def dit_params(cfg, dev, seed=SEED):
    """init_dit_params with ``mod`` and ``out`` drawn too (adaLN-zero's
    zero init makes every block the identity, whose checks prove nothing
    about attention), normal / sqrt(dim), from the seed on the card."""
    from long_context_attention_tpu_torch.models.dit import init_dit_params

    gen = torch.Generator(device=dev).manual_seed(seed)
    params = init_dit_params(gen, cfg, device=dev)
    for node, key in ((params["layers"], "mod"), (params, "out")):
        node[key] = (torch.randn(node[key].shape, generator=gen, device=dev)
                     / math.sqrt(cfg.dim)).to(cfg.dtype)
    return params


def dit_data(n, dev, seed=SEED + 11):
    """Latents, noise (1, n, in_dim) fp32 and a timestep (1,) from the
    seed on the card."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    x, noise = (torch.randn((1, n, WAN_DIT["in_dim"]), generator=gen,
                            device=dev) for _ in range(2))
    t = torch.randint(0, 1000, (1,), generator=gen, device=dev)
    return x, noise, t


def cpu_tree(tree):
    return {k: cpu_tree(v) if isinstance(v, dict) else v.detach().cpu()
            for k, v in tree.items()}


def dit_kernel_case(name, fn, plain, rows, tag, checks, lse=True):
    """One kernel call held row block by row block against its plain
    version (the plain version at a row block's q rows and every kv
    column); returns the plain version's ms over the blocks."""
    o, l = fn()
    plain_ms = 0.0
    for r in rows:
        t0 = time.perf_counter()
        po, pl_ = plain(r)
        torch.cuda.synchronize()
        plain_ms += 1e3 * (time.perf_counter() - t0)
        checks.append(check_out(f"{name} out {tag} rows {r.start}:{r.stop}",
                                o[:, r], po))
        if lse:
            check(f"{name} lse {tag} rows {r.start}:{r.stop}",
                  max_err(l[:, :, r], pl_), LSE_TOL)
        del po, pl_
    return plain_ms


def kernel_dit(K, flash, sage, gen, dev):
    """The DiT path's kernel calls at Wan2.1-1.3B's attention width (b=1,
    12 heads of 128, h_kv = h), non-causal over a ragged last tile: B3 and
    B8b at s_q = s_kv = 32760 (the 480p, 81-frame forward), B2a and B2b at
    7800 (training's 17 frames), each against its plain version.

    B3's q is drawn about -1 and K about +1, so every real score is about
    -11 in natural units: a kv column past s_kv that TMA fills with zeros
    scores 0 and, left unmasked, would outweigh its whole row. K/V (and
    B8b's int8 K/V) live in storage padded to the next 128 rows, whose rows
    past s_kv hold 10^4 (127 with NaN scales for B8b): the kernels get the
    views of the first s_kv rows, so a read past them shows too. Sage's K
    is centred, so its scores cannot be made all negative; B3 and B8b are
    held at s_q = s_kv = 130 as well, 126 of the 128 columns of the last
    tile past s_kv, where an unmasked column moves every row by tens of
    percent. Out and lse row by row (ROW_REL_TOL, LSE_TOL) over the first,
    a middle and the last 512 rows (the ragged last q tile), each block
    against every kv column; B2a and B2b in full. Times with the bound
    and SDPA (flash, non-causal) beside them. Returns {kernel tag: case
    row}."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    b, s, h, d = 1, DIT_FWD_TOKENS, WAN_DIT["n_heads"], 128
    scale = d ** -0.5
    pad = -(-s // 128) * 128
    blocks = (slice(0, 512), slice(s // 2 - 256, s // 2 + 256),
              slice(s - 512, s))
    q = (torch.randn((b, s, h, d), generator=gen, device=dev) - 1).bfloat16()
    kst, vst = (torch.randn((b, h, pad, d), generator=gen, device=dev)
                for _ in range(2))
    kst += 1
    kst, vst = kst.bfloat16(), vst.bfloat16()
    for t in (kst, vst):
        t[:, :, s:] = 1e4
    k, v = kst[:, :, :s], vst[:, :, :s]
    checks = {"B3": [], "B8b": [], "B2a": [], "B2b": []}
    fw = dict(causal=False, scale=scale)
    b3_plain = dit_kernel_case(
        "B3", lambda: flash.flash_fwd_pos(q, k, v, **fw),
        lambda r: flash.flash_fwd_pos_plain(q[:, r], k, v, **fw), blocks,
        f"non-causal s={s}", checks["B3"])
    ms = {"B3": time_ms(lambda: flash.flash_fwd_pos(q, k, v, **fw),
                        iters=5, warmup=1)}
    qh = q.transpose(1, 2)
    with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
        lib = time_ms(lambda: F.scaled_dot_product_attention(qh, k, v),
                      iters=5, warmup=1)
    # B8b on the sage operands of the same q, k, v, past s_kv poisoned
    k8st = torch.full((b, pad, h, d), 127, dtype=torch.int8, device=dev)
    v8st = torch.full((b, pad, h, d), 127, dtype=torch.int8, device=dev)
    ksst, vsst = (torch.full((b, h, pad), math.nan, device=dev)
                  for _ in range(2))
    q8, qs, k8, ks, v8, vs = sage_operands(
        sage, q, k.transpose(1, 2).contiguous(),
        v.transpose(1, 2).contiguous(), scale)
    k8st[:, :s], v8st[:, :s], ksst[:, :, :s], vsst[:, :, :s] = k8, v8, ks, vs
    ops = (q8, qs, k8st[:, :s], ksst[:, :, :s], v8st[:, :s], vsst[:, :, :s])
    del k8, ks, v8, vs
    b8_plain = dit_kernel_case(
        "B8b", lambda: sage.sage_fwd_pos(*ops, causal=False),
        lambda r: sage.sage_fwd_pos_plain(ops[0][:, r], ops[1][:, :, r],
                                          *ops[2:], causal=False),
        blocks, f"non-causal s={s}", checks["B8b"])
    ms["B8b"] = time_ms(lambda: sage.sage_fwd_pos(*ops, causal=False),
                        iters=5, warmup=1)
    del ops, k8st, v8st, ksst, vsst, q8, qs
    # s = 130: 126 of the last tile's 128 columns past s_kv
    sm = 130
    qs_, ks_, vs_ = (torch.randn((b, sm, h, d), generator=gen, device=dev)
                     .bfloat16() for _ in range(3))
    small = sage_operands(sage, qs_, ks_, vs_, scale)
    for name, fn, plain, args, kw in (
            ("B3", flash.flash_fwd_pos, flash.flash_fwd_pos_plain,
             (qs_, ks_.transpose(1, 2), vs_.transpose(1, 2)), fw),
            ("B8b", sage.sage_fwd_pos, sage.sage_fwd_pos_plain, small,
             dict(causal=False))):
        dit_kernel_case(name, lambda: fn(*args, **kw),
                        lambda r: plain(*args, **kw), (slice(0, sm),),
                        f"non-causal s={sm}", checks[name])
    del q, kst, vst, k, v, qh
    torch.cuda.empty_cache()
    # B2a and B2b at training's 7800 tokens, non-causal, on B3's out, lse
    n = DIT_TRAIN_TOKENS
    q, k, v, dout = (torch.randn((b, n, h, d), generator=gen, device=dev)
                     .bfloat16() for _ in range(4))
    out, lse = flash.flash_fwd_pos(q, k.transpose(1, 2), v.transpose(1, 2),
                                   **fw)
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, dout, lse, delta)
    dq = flash.flash_bwd_dq(*args, **fw)
    t0 = time.perf_counter()
    pdq = flash.flash_bwd_dq_plain(*args, **fw)
    torch.cuda.synchronize()
    bwd_plain = {"B2a": 1e3 * (time.perf_counter() - t0)}
    checks["B2a"].append(check_out(f"B2a dq non-causal s={n}", dq, pdq))
    del dq, pdq
    dk, dv = flash.flash_bwd_dkv(*args, **fw)
    t0 = time.perf_counter()
    pdk, pdv = flash.flash_bwd_dkv_plain(*args, **fw)
    torch.cuda.synchronize()
    bwd_plain["B2b"] = 1e3 * (time.perf_counter() - t0)
    checks["B2b"].append(check_out(f"B2b dk non-causal s={n}", dk, pdk))
    checks["B2b"].append(check_out(f"B2b dv non-causal s={n}", dv, pdv))
    del dk, dv, pdk, pdv
    torch.cuda.empty_cache()
    ms["B2a"] = time_ms(lambda: flash.flash_bwd_dq(*args, **fw), iters=5)
    ms["B2b"] = time_ms(lambda: flash.flash_bwd_dkv(*args, **fw), iters=5)
    lib_bwd = sdpa_backward_ms(q, k, v, dout, causal=False)
    in_bytes = 2 * 4 * q.numel() + 8 * b * h * n
    res = {
        "B3": (b3_plain, 4 * d * b * h * s * s,
               2 * 4 * b * s * h * d + 4 * b * h * s, lib, PEAK_BF16_FLOPS),
        "B8b": (b8_plain, 4 * d * b * h * s * s,
                5 * b * s * h * d + 4 * b * h * s * 4, lib, PEAK_SAGE_OPS),
        "B2a": (bwd_plain["B2a"], 2 * 3 * d * b * h * n * n,
                in_bytes + 4 * q.numel(), lib_bwd, PEAK_BF16_FLOPS),
        "B2b": (bwd_plain["B2b"], 2 * 4 * d * b * h * n * n,
                in_bytes + 8 * k.numel(), lib_bwd, PEAK_BF16_FLOPS)}
    del q, k, v, dout, out, lse, delta, args
    torch.cuda.empty_cache()
    seq = {"B3": s, "B8b": s, "B2a": n, "B2b": n}
    return {name: {"case": f"Wan2.1-1.3B width, b=1, {h} heads, non-causal, "
                           f"s_q = s_kv = {seq[name]} (ragged last tile)",
                   "plain_rows": ("3 blocks of 512 rows" if name in
                                  ("B3", "B8b") else "all"),
                   **case_row(checks[name], ms[name], plain_ms, flops,
                              nbytes, lib_ms, peak),
                   "library": ("SDPA flash, non-causal, bf16" if name in
                               ("B3", "B8b") else
                               "SDPA flash backward, non-causal (dq, dk, "
                               "dv)")}
            for name, (plain_ms, flops, nbytes, lib_ms, peak) in res.items()}


def serve_mesh_phase(pkg, build, dev, card):
    """Engine(mesh=make_usp_mesh(), cache_dtype="int8", weight_dtype="int8")
    on a one-rank NCCL mesh, the 0.88B config in the zigzag layout: a
    one-shot 4 x 8192 prefill (every layer's attention through the ring's
    B3 at the two-chunk descriptor; B6 writing the gathered K/V) and 32
    greedy decode steps (B6, B7). Against Engine() without a mesh on the
    same weights and prompt (B1): the last token's logits and the cache's
    dequantized prompt rows within TEACHER_TOL, the greedy tokens' first
    divergence printed. Returns the mesh engine's launch counts."""
    import torch.distributed as dist

    from long_context_attention_tpu_torch.models.llama import init_params
    from long_context_attention_tpu_torch.parallel import make_usp_mesh
    from long_context_attention_tpu_torch.serving.engine import Engine

    cfg = pkg.ModelConfig(**dict(MODEL, layout="zigzag"))
    L = cfg.n_layers
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = init_params(gen, cfg, device=dev)
    prompt = torch.randint(0, cfg.vocab, (BATCH, PROMPT), generator=gen,
                           device=dev)
    kw = dict(cfg=cfg, s_max=S_MAX, cache_dtype="int8", weight_dtype="int8")
    single = Engine(**kw, device=dev)
    mesh = make_usp_mesh()
    try:
        eng = Engine(**kw, mesh=mesh)
        for e in (single, eng):  # warm-up: cuBLAS, the allocator's pools
            e.prefill(params, prompt[:, :CHUNK])
        dparams = eng.decode_params(params)
        torch.cuda.synchronize()
        seconds = {}

        def timed(tag, fn):
            t0 = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            seconds[tag] = time.perf_counter() - t0
            return res

        build.reset_launch_counts()
        ref_logits, ref_cache = timed("single_prefill", lambda:
                                      single.prefill(params, prompt))
        single_counts = expect_counts(build, {
            "flash_fwd_causal_self": L, "flash_fwd_pos": 0,
            "cache_append": L})
        build.reset_launch_counts()
        logits, cache = timed("mesh_prefill", lambda:
                              eng.prefill(params, prompt))
        first = torch.argmax(logits, -1).to(torch.int32)
        cache_err = 0.0
        for layer in range(L):
            for name in ("k", "v"):
                a, w = (dequantized_rows(c, name, layer, PROMPT)
                        for c in (cache, ref_cache))
                cache_err = max(cache_err, max_err(a, w))
        toks, cache = timed("mesh_decode", lambda: eng.decode_scan(
            dparams, cache, NEW, first))
        counts = expect_counts(build, {
            "flash_fwd_pos": L, "flash_fwd_causal_self": 0,
            "flash_fwd_static": 0, "cache_append": L + L * NEW,
            "decode_attention": L * NEW, "decode_run": 0})
        ref_toks, _ = single.decode_scan(
            dparams, ref_cache, NEW,
            torch.argmax(ref_logits, -1).to(torch.int32))
    finally:
        dist.destroy_process_group()
    if not torch.isfinite(logits).all():
        raise AssertionError("serve_mesh: prefill logits are not finite")
    if toks.shape != (BATCH, NEW) or cache.length.tolist() != [
            PROMPT + NEW] * BATCH:
        raise AssertionError(f"serve_mesh: decode_scan shapes "
                             f"{tuple(toks.shape)}, lengths "
                             f"{cache.length.tolist()}")
    logit_err = max_err(logits, ref_logits)
    check("serve_mesh logits vs Engine()", logit_err, TEACHER_TOL)
    check("serve_mesh prompt cache rows vs Engine()", cache_err, TEACHER_TOL)
    differ = (toks != ref_toks).any(0).nonzero()
    emit({"phase": "serve_mesh", "card": card, "model": "llama-0.88B",
          "layout": "zigzag", "mesh": "dp 1 x ring 1 x ulysses 1 (NCCL)",
          "batch": BATCH, "prompt": PROMPT, "new_tokens": NEW,
          "cache_dtype": "int8", "weight_dtype": "int8", **seconds,
          "mesh_decode_ms_per_step": 1e3 * seconds["mesh_decode"] / NEW,
          "logits_max_abs_err": logit_err,
          "prompt_cache_max_abs_err": cache_err,
          "teacher_tol": TEACHER_TOL,
          "greedy_first_divergence": (int(differ[0]) if len(differ)
                                      else None),
          "greedy_agree": float((toks == ref_toks).float().mean()),
          "launches": counts, "single_prefill_launches": {
              n: single_counts[n] for n in ("flash_fwd_causal_self",
                                            "cache_append")}})
    del params, cache, ref_cache
    torch.cuda.empty_cache()
    return counts


def dequantized_rows(cache, name, layer, n):
    """A layer's first n rows of the cache's K or V, dequantized, fp32."""
    vals = getattr(cache, name)[layer, :, :, :n].float()
    scale = getattr(cache, f"{name}_scale")
    if scale is None:
        return vals
    return vals * scale[layer, :, :, 0, :n, None]


def usp_async_phase(build, ring, dev, card):
    """AsyncLongContextAttention(layout="zigzag") with the default groups
    (one kv head a group: 8) and n_groups=2 against LongContextAttention on
    a one-rank NCCL mesh at usp_dense's shape (b=1, s=32768, 16/8 heads),
    causal, forward and backward: each group's ring runs B3 (and B2a +
    B2b) on its heads alone, the same arithmetic per head, so out and
    grads are expected bit-equal (each differing tensor is reported with
    its error and held to ROW_REL_TOL row by row, grads to BF16_ATOL); the
    ring's lse per group against the whole call's, bit for bit. Exactly one
    B3, B2a and B2b per group. ms of the forward and of forward +
    backward, in turns; on one card no collective runs, so no overlap can
    show. Returns the default layer's launch counts."""
    import torch.distributed as dist

    from long_context_attention_tpu_torch.parallel import (
        AsyncLongContextAttention, LongContextAttention, make_usp_mesh)

    b, s, h, hk, d = 1, SPARSE_SEQ, MODEL["n_heads"], MODEL["n_kv_heads"], 128
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    q, k, v = (torch.randn(shape, generator=gen, device=dev).bfloat16()
               .requires_grad_()
               for shape in ((b, s, h, d), (b, s, hk, d), (b, s, hk, d)))
    dout = torch.randn((b, s, h, d), generator=gen, device=dev).bfloat16()
    mesh = make_usp_mesh()
    report = {}
    try:
        layers = {"dense": LongContextAttention(mesh, layout="zigzag"),
                  "async default": AsyncLongContextAttention(
                      mesh, layout="zigzag"),
                  "async n_groups=2": AsyncLongContextAttention(
                      mesh, layout="zigzag", n_groups=2)}
        groups = {"dense": 1, "async default": hk, "async n_groups=2": 2}

        def run(layer):
            out = layer(q, k, v, causal=True)
            return (out.detach(), *torch.autograd.grad(out, (q, k, v),
                                                       dout))

        build.reset_launch_counts()
        want = run(layers["dense"])
        torch.cuda.synchronize()
        main_counts = None
        for tag in ("async default", "async n_groups=2"):
            build.reset_launch_counts()
            got = run(layers[tag])
            torch.cuda.synchronize()
            counts = expect_counts(build, {
                n: groups[tag] if n in ("flash_fwd_pos", "flash_bwd_dq",
                                        "flash_bwd_dkv") else 0
                for n in build.KERNELS})
            main_counts = main_counts or counts
            equal = {}
            for name, a, w in zip(("out", "dq", "dk", "dv"), got, want):
                equal[name] = torch.equal(a, w)
                if equal[name]:
                    continue
                if name == "out":
                    check_out(f"usp_async {tag} out vs dense", a, w)
                else:
                    check(f"usp_async {tag} {name} vs dense", max_err(a, w),
                          BF16_ATOL)
                equal[f"{name}_max_abs_err"] = max_err(a, w)
            report[tag] = {"n_groups": groups[tag], "bit_equal": equal,
                           "launches": {n: c for n, c in counts.items()
                                        if c}}
            del got
        # the ring's lse per group of the default layer against the whole
        # heads' (zigzag ring of one: B3 at the two-chunk descriptor)
        with torch.no_grad():
            _, lse = ring.ring_attention_local(q, k, v, causal=True,
                                               return_lse=True)
            g = h // hk
            lse_equal = all(torch.equal(ring.ring_attention_local(
                q[:, :, i * g:(i + 1) * g], k[:, :, i:i + 1],
                v[:, :, i:i + 1], causal=True, return_lse=True)[1],
                lse[:, i * g:(i + 1) * g]) for i in range(hk))
        report["lse_bit_equal_per_group"] = lse_equal
        if not lse_equal:
            raise AssertionError("usp_async: a group's ring lse differs "
                                 "from the whole call's")
        del want, lse
        torch.cuda.empty_cache()
        ms = {}
        for turn in range(2):  # in turns: dense, async, async, dense, ...
            order = list(layers) if turn == 0 else list(layers)[::-1]
            for tag in order:
                layer = layers[tag]
                with torch.no_grad():
                    f = time_ms(lambda: layer(q, k, v, causal=True),
                                iters=5, warmup=1)
                fb = time_ms(lambda: torch.autograd.grad(
                    layer(q, k, v, causal=True), (q, k, v), dout), iters=5,
                    warmup=1)
                ms.setdefault(tag, {"fwd_ms": [], "fwd_bwd_ms": []})
                ms[tag]["fwd_ms"].append(f)
                ms[tag]["fwd_bwd_ms"].append(fb)
        report["ms"] = ms
    finally:
        dist.destroy_process_group()
    emit({"phase": "usp_async", "card": card, "layout": "zigzag",
          "mesh": "dp 1 x ring 1 x ulysses 1 (NCCL): no collective runs",
          "batch": b, "seq": s, "heads": h, "kv_heads": hk, "head_dim": d,
          **report})
    del q, k, v, dout
    torch.cuda.empty_cache()
    return main_counts


def dit_forward_phase(build, dev, card):
    """The DiT forward at Wan2.1-1.3B's widths, 30 layers, b=1, 32760
    tokens, random non-zero weights (mod and out included): make_dit_forward
    under attn_impl "pallas" (B3 non-causal, one launch a layer) and
    "sage" (B8b and its two quantization kernels, one each a layer) on the
    same weights and latents, each timed over two forwards after a
    warm-up, finite outputs of the right shape, sage's gap to pallas. Then
    the model at 2 layers against the port's CPU path (plain versions) at
    7800 tokens within BF16_ATOL. Returns the launch counts by impl."""
    from long_context_attention_tpu_torch.models.dit import (
        DiTConfig, make_dit_forward)
    from long_context_attention_tpu_torch.models.llama import param_leaves

    L, n = WAN_DIT["n_layers"], DIT_FWD_TOKENS
    x, _, t = dit_data(n, dev)
    cfg = DiTConfig(**WAN_DIT)
    params = dit_params(cfg, dev)
    n_params = sum(p.numel() for p in param_leaves(params))
    report, outs, counts = {}, {}, {}
    fwd_kernels = {"pallas": "flash_fwd_pos", "sage": "sage_fwd_pos"}
    for impl in ("pallas", "sage"):
        fwd = make_dit_forward(dataclasses.replace(cfg, attn_impl=impl),
                               device=dev)
        fwd(params, x[:, :2048], t)  # warm-up
        torch.cuda.synchronize()
        build.reset_launch_counts()
        t0 = time.perf_counter()
        out = fwd(params, x, t)
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
        counts[impl] = expect_counts(build, {
            **{k: L if k == fwd_kernels[impl] else 0 for k in (
                "flash_fwd_pos", "sage_fwd_pos", "flash_fwd_causal_self",
                "flash_fwd_static", "sage_fwd_tri", "sage_fwd_rect")},
            **quant_counts(L if impl == "sage" else 0)})
        t0 = time.perf_counter()
        fwd(params, x, t)
        torch.cuda.synchronize()
        second = time.perf_counter() - t0
        if out.shape != x.shape or out.dtype != torch.float32 or not bool(
                torch.isfinite(out).all()):
            raise AssertionError(f"dit_forward {impl}: output "
                                 f"{tuple(out.shape)} {out.dtype}, finite "
                                 f"{bool(torch.isfinite(out).all())}")
        outs[impl] = out
        report[impl] = {"s_per_forward": [first, second],
                        "tok_per_s": n / min(first, second),
                        "out_mean_abs": float(out.abs().mean()),
                        "launches": {k: c for k, c in counts[impl].items()
                                     if c}}
    gap = max_err(outs["sage"], outs["pallas"])
    report["sage_vs_pallas"] = {
        "max_abs_err": gap,
        "rel_to_max": gap / float(outs["pallas"].abs().max()),
        "mean_abs_err": float((outs["sage"] - outs["pallas"]).abs().mean())}
    del params, outs, out
    torch.cuda.empty_cache()
    # 2 layers at full width, 7800 tokens: the card against the CPU path
    cfg2 = dataclasses.replace(cfg, n_layers=DIT_CHECK_LAYERS)
    p2 = dit_params(cfg2, dev, seed=SEED + 1)
    x2 = x[:, :DIT_TRAIN_TOKENS].contiguous()
    card_out = make_dit_forward(cfg2, device=dev)(p2, x2, t)
    t0 = time.perf_counter()
    cpu_out = make_dit_forward(cfg2, device="cpu")(cpu_tree(p2), x2.cpu(),
                                                   t.cpu())
    cpu_s = time.perf_counter() - t0
    err = max_err(card_out.cpu(), cpu_out)
    report["cpu_check"] = {"layers": DIT_CHECK_LAYERS,
                           "tokens": DIT_TRAIN_TOKENS, "max_abs_err": err,
                           "out_max_abs": float(cpu_out.abs().max()),
                           "tol": BF16_ATOL, "cpu_seconds": cpu_s}
    check("dit_forward 2 layers card vs CPU", err, BF16_ATOL)
    emit({"phase": "dit_forward", "card": card,
          "model": "Wan2.1-T2V-1.3B widths (repo DiT block)", **WAN_DIT,
          "params": n_params, "batch": 1, "tokens": n,
          "frames": "81 at 480p (21 x 30 x 52 latent patches)", **report})
    del p2, card_out, cpu_out
    torch.cuda.empty_cache()
    return counts


def dit_train_phase(build, dev, card):
    """make_dit_train_step at Wan2.1-1.3B's widths, 30 layers, b=1, 7800
    tokens, from init_dit_params (adaLN-zero), AdamW as in train: one
    warm-up step, then DIT_TRAIN_STEPS timed steps with exact launch counts
    (B3, B2a, B2b one each a layer a step; B1, B4, B5 never), a finite,
    falling loss, ms/step, tok/s and peak memory. Then a gradient check at
    2 layers, full width, GRAD_SEQ tokens with non-zero mod and out: the
    loss and every parameter gradient on the card against the same
    backward on CPU copies (plain versions), gated as grad_check. Returns
    the timed steps' launch counts."""
    from long_context_attention_tpu_torch.models.dit import (
        DiTConfig, dit_forward_local, init_dit_params, make_dit_train_step)
    from long_context_attention_tpu_torch.models.llama import param_leaves

    L, n = WAN_DIT["n_layers"], DIT_TRAIN_TOKENS
    cfg = DiTConfig(**WAN_DIT)
    params = init_dit_params(torch.Generator(device=dev).manual_seed(SEED),
                             cfg, device=dev)
    n_params = sum(p.numel() for p in param_leaves(params))
    x, noise, t = dit_data(n, dev)
    step = make_dit_train_step(cfg, functools.partial(
        torch.optim.AdamW, lr=LR, weight_decay=WEIGHT_DECAY), device=dev)
    params, state, loss = step(params, None, x, noise, t)
    losses = [float(loss)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    times = []
    for _ in range(DIT_TRAIN_STEPS):
        t0 = time.perf_counter()
        params, state, loss = step(params, state, x, noise, t)
        losses.append(float(loss))
        times.append(time.perf_counter() - t0)
    steps = DIT_TRAIN_STEPS
    counts = expect_counts(build, {
        "flash_fwd_pos": steps * L, "flash_bwd_dq": steps * L,
        "flash_bwd_dkv": steps * L, "flash_fwd_causal_self": 0,
        "flash_fwd_static": 0, "flash_bwd_fused": 0, "sage_fwd_pos": 0})
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"dit_train: loss not finite: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"dit_train: the loss did not fall: {losses}")
    ms = 1e3 * sum(times) / steps
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    flops = 6 * n * n_params  # the 6ND convention, attention not counted
    report = {"params": n_params, "steps": steps, "ms_per_step": ms,
              "ms_all": [1e3 * t for t in times], "tok_per_s": n / (ms / 1e3),
              "mfu_6nd": flops / (ms / 1e3) / PEAK_BF16_FLOPS,
              "max_memory_allocated_gb": peak_gb, "losses": losses,
              "launches_per_step": {k: c // steps for k, c in counts.items()
                                    if c}}
    del params, state, step, loss
    torch.cuda.empty_cache()

    # the gradient check: 2 layers with non-zero mod and out
    cfg2 = dataclasses.replace(cfg, n_layers=DIT_CHECK_LAYERS)
    p2 = dit_params(cfg2, dev, seed=SEED + 2)
    x2, noise2, t2 = dit_data(GRAD_SEQ, dev, seed=SEED + 12)

    def loss_and_grads(where):
        p = {k: ({kk: vv.detach().to(where, copy=True).requires_grad_()
                  for kk, vv in v.items()} if isinstance(v, dict) else
                 v.detach().to(where, copy=True).requires_grad_())
             for k, v in p2.items()}
        pred = dit_forward_local(p, x2.to(where), t2.to(where), cfg2)
        lval = ((pred - noise2.to(where)) ** 2).sum() / noise2.numel()
        lval.backward()
        return float(lval.detach()), {k: g.grad.float().cpu()
                                      for k, g in named_leaves(p)}

    loss_cpu, g_cpu = loss_and_grads(torch.device("cpu"))
    build.reset_launch_counts()
    loss_card, g_card = loss_and_grads(dev)
    gcounts = expect_counts(build, {
        "flash_fwd_pos": DIT_CHECK_LAYERS, "flash_bwd_dq": DIT_CHECK_LAYERS,
        "flash_bwd_dkv": DIT_CHECK_LAYERS, "flash_bwd_fused": 0})
    leaves = {}
    for name, want in g_cpu.items():
        size = float(want.abs().max())
        leaves[name] = {"rel_err": float((g_card[name] - want).abs().max())
                        / size, "max_abs": size}
    report["grad_check"] = {
        "layers": DIT_CHECK_LAYERS, "tokens": GRAD_SEQ,
        "loss_card": loss_card, "loss_cpu": loss_cpu, "loss_tol": LOSS_TOL,
        "grad_tol": GRAD_TOL,
        "worst_rel_err": max(x["rel_err"] for x in leaves.values()),
        "launches": {k: c for k, c in gcounts.items() if c},
        "leaves": leaves}
    emit({"phase": "dit_train", "card": card,
          "model": "Wan2.1-T2V-1.3B widths (repo DiT block)", **WAN_DIT,
          "batch": 1, "tokens": n,
          "frames": "17 at 480p (5 x 30 x 52 latent patches)",
          "optimizer": f"AdamW lr {LR} weight decay {WEIGHT_DECAY}",
          **report})
    check("dit_train grad_check loss", abs(loss_card - loss_cpu), LOSS_TOL)
    for name, x in leaves.items():
        check(f"dit_train grad_check {name} (relative to its largest value)",
              x["rel_err"], GRAD_TOL)
    del p2
    torch.cuda.empty_cache()
    return counts


# sharded_emulated: B7 over a sequence-sharded cache of SHARD_N blocks of
# SHARD_SLOTS slots on one card (the 0.88B config's attention widths, b = 4,
# one layer): every rank's call (serving/sharded.py's per-rank partial)
# against the plain version, and the merged result against the unsharded
# call over the whole cache, for every cache kind, dense and paged
SHARD_N, SHARD_SLOTS, SHARD_B = 4, 32768, 4
SHARD_CASES = (
    ("one token in block 1", 1, (41769, 36001, 50000, 32769), {}),
    ("one token on block boundaries", 1, (32768, 65536, 98304, 131072), {}),
    ("one token in block 0", 1, (20000, 9000, 32768, 1), {}),
    ("window over blocks 1 and 2", 1, (66000, 67000, 68000, 69000),
     WINDOWED),
    ("run of 5 over a boundary", 5, (65538, 65540, 98306, 32770), WINDOWED),
    ("run of 256 over a boundary", 256, (65600, 65791, 98404, 32968),
     WINDOWED),
)
SHARD_DTYPES = ("bfloat16", "int8", "float8_e4m3fn", "int4")


def b7_device_ms(fn, calls=20):
    """Device ms per call of B7's kernels (its span or run kernel and its
    merge) in ``calls`` calls of fn, under torch.profiler."""
    def run():
        for _ in range(calls):
            fn()

    _, prof = profiled(run)
    return sum(t for name, _, t in prof["top"] if any(
        k in name for k in ("decode_span_kernel", "merge_spans",
                            "decode_run_kernel", "merge_rows"))) / calls


def b7_column_times(decode, q, part, lens, n_tok, win, sinks):
    """Rank 1's B7 call with its sharded columns (lengths, first columns
    and sink slice as serving/sharded.py makes them, computed once) and
    the same call without them (the block's local lengths, the window
    derived by the kernel): device ms per call of the kernels (no L2
    flush: the window's ~34 MB of int8 K/V fit the 50 MB L2) and the
    calls' CUDA-event ms."""
    local = lens - SHARD_SLOTS
    if n_tok == 1:
        local = local.clamp(0, SHARD_SLOTS)
    fc = lens - n_tok - win - SHARD_SLOTS
    sc = torch.full_like(lens, sinks).sub_(SHARD_SLOTS).clamp_(
        0, SHARD_SLOTS)
    kw = dict(layer=0, window_size=(win, -1))

    def with_cols():
        return decode.decode_attention(q, *part[:2], local, *part[2:],
                                       first_cols=fc, sink_cols=sc,
                                       sink_band=sinks, **kw)

    def without():
        return decode.decode_attention(q, *part[:2], local, *part[2:],
                                       sink_tokens=sinks, **kw)

    out = {}
    for tag, fn in (("", with_cols), ("_without_columns", without),
                    ("_without_columns", without), ("", with_cols)):
        out.setdefault(f"ms{tag}", []).append(b7_device_ms(fn))
        out.setdefault(f"call_ms{tag}", []).append(time_ms(fn, iters=20))
    return out


@contextlib.contextmanager
def plain_b7(decode):
    """decode_attention's calls (and the sharded partials through it) take
    B7's plain version on the card's tensors, in place of the kernels."""
    saved = decode.decode_attention_core
    decode.decode_attention_core = decode.decode_attention_core_plain
    try:
        yield
    finally:
        decode.decode_attention_core = saved


def sharded_cache(kv_cache, dtype, paged, gen, dev):
    """A one-layer cache of SHARD_N * SHARD_SLOTS slots of random K/V
    quantized to ``dtype``, and each rank's part: dense, the (1, b, h_kv,
    slots, d) blocks (copies); paged, the pool (1, SHARD_N * p_local,
    h_kv, PAGE, d) whose partition r is pages [r * p_local, (r + 1) *
    p_local) (local page 0 its scratch), with the global page table (a
    row's logical page j on partition j // ppr, shuffled among its pages
    there)."""
    hk, d = MODEL["n_kv_heads"], MODEL["head_dim"]
    s = SHARD_N * SHARD_SLOTS
    ppr = SHARD_SLOTS // PAGE
    p_local = SHARD_B * ppr + 1
    if paged:
        shape = (1, SHARD_N * p_local, hk, PAGE, d)
    else:
        shape = (1, SHARD_B, hk, s, d)
    vals = []
    for _ in range(2):  # K, V: values and scales in the cache's layout
        q, sc = quant_values(kv_cache, shape, dtype, gen, dev)
        vals.append((q, None if sc is None else sc[..., None, :]))
    kc, vc, ks, vs = vals[0][0], vals[1][0], vals[0][1], vals[1][1]
    if paged:
        pt = torch.full((SHARD_B, SHARD_N * ppr), -1, dtype=torch.int32)
        for i in range(SHARD_B):
            for j in range(SHARD_N * ppr):
                r = j // ppr
                pt[i, j] = r * p_local + 1 + i * ppr + (j * 7) % ppr
        whole = (kc, vc, ks, vs)
        parts = [tuple(None if t is None else
                       t[:, r * p_local:(r + 1) * p_local] for t in whole)
                 for r in range(SHARD_N)]
        return whole, parts, pt.to(dev)
    whole = (kc, vc, ks, vs)
    parts = []
    for r in range(SHARD_N):
        sl = slice(r * SHARD_SLOTS, (r + 1) * SHARD_SLOTS)
        parts.append((kc[:, :, :, sl].contiguous(),
                      vc[:, :, :, sl].contiguous(),
                      None if ks is None else ks[..., sl].contiguous(),
                      None if vs is None else vs[..., sl].contiguous()))
    return whole, parts, None


def sharded_emulated_phase(build, decode, kv_cache, sharded, gen, dev,
                           card):
    """sharded_emulated: for every cache kind, dense and paged, and every
    SHARD_CASES case: each rank's B7 call (decode_attention.cu for one
    token, decode_run for the runs, by decode_route) against its plain
    version on the same tensors, row by row with B7's gates; the n-way
    merge of the ranks' partials against the unsharded call over the whole
    cache (ROW_REL_TOL: the partials are bf16); a run of 5 bf16 rows
    appended across the block boundary at 65536 rank by rank, bit for bit
    the unsharded append. The window case and the run of 256 are timed on
    rank 1 with its sharded columns and without them (the same block and
    query at its local lengths, the window derived by the kernel). Returns
    the cases by kernel and the phase's launch counts (the kernels' and the
    plain versions' calls alike are comparisons)."""
    from long_context_attention_tpu_torch.ops.kv_cache import (
        KVCache, PagedKVCache)

    h, hk, d = MODEL["n_heads"], MODEL["n_kv_heads"], MODEL["head_dim"]
    out = {"decode_attention": [], "decode_run": []}
    timed = {}
    t_phase = time.perf_counter()
    build.reset_launch_counts()
    for dtype in SHARD_DTYPES:
        for paged in (False, True):
            whole, parts, pt = sharded_cache(kv_cache, dtype, paged, gen,
                                             dev)
            store = "paged" if paged else "dense"
            for tag, n_tok, lengths, shape in SHARD_CASES:
                win = shape.get("window_left", -1)
                sinks = shape.get("sink_tokens", 0)
                lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
                qshape = ((SHARD_B, h, d) if n_tok == 1
                          else (SHARD_B, n_tok, h, d))
                q = torch.randn(qshape, generator=gen, device=dev).bfloat16()
                kw = dict(layer=0, window_left=win, sink_tokens=sinks,
                          page_table=pt)
                kernel = ("decode_attention" if n_tok == 1
                          else "decode_run")
                row_tol, lse_tol = ((B7_ROW_TOL, B7_LSE_TOL)
                                    if kernel == "decode_attention"
                                    else (ROW_REL_TOL, LSE_TOL))
                outs, lses, errs = [], [], []
                for r in range(SHARD_N):
                    o, lse = sharded.sharded_decode_attention(
                        q, *parts[r][:2], lens, *parts[r][2:],
                        axis_name=(r, SHARD_N), **kw)
                    with plain_b7(decode):
                        po, pl_ = sharded.sharded_decode_attention(
                            q, *parts[r][:2], lens, *parts[r][2:],
                            axis_name=(r, SHARD_N), **kw)
                    name = f"sharded {dtype} {store} {tag} rank {r}"
                    e, _ = check_out(name, o, po, tol=row_tol)
                    check(f"{name} lse", max_err(lse, pl_), lse_tol)
                    errs.append(e)
                    outs.append(o.float())
                    lses.append(lse.transpose(1, 2) if n_tok > 1 else lse)
                merged = sharded.merge_sharded_partials(torch.stack(outs),
                                                        torch.stack(lses))
                ref = decode.decode_attention(
                    q, *whole[:2], lens, *whole[2:], layer=0,
                    window_size=(win, -1), sink_tokens=sinks,
                    page_table=pt)
                m_err, _ = check_out(
                    f"sharded {dtype} {store} {tag} merged vs unsharded",
                    merged, ref)
                dead = [r for r in range(SHARD_N)
                        if bool(torch.isneginf(lses[r]).all())]
                case = {"case": f"{dtype} {store}: {tag}",
                        "lengths": list(lengths), "n_tok": n_tok,
                        "window_left": win, "sink_tokens": sinks,
                        "max_abs_err": max(errs),
                        "merged_vs_unsharded_max_abs_err": m_err,
                        "dead_ranks": dead}
                key = (dtype, store, tag)
                if dtype == "int8" and store == "dense" and tag in (
                        "window over blocks 1 and 2",
                        "run of 256 over a boundary"):
                    case.update(b7_column_times(decode, q, parts[1], lens,
                                                n_tok, win, sinks))
                    timed[kernel] = case
                out[kernel].append(case)
                emit({"phase": "sharded_emulated", "card": card, **case})
            # a run of 5 appended across the boundary at 65536
            pos = torch.full((SHARD_B,), 2 * SHARD_SLOTS - 2,
                             dtype=torch.int32, device=dev)
            pos[1] = -5  # a skipped row
            k5, v5 = (torch.randn((SHARD_B, 5, hk, d), generator=gen,
                                  device=dev).bfloat16() for _ in range(2))
            length = torch.zeros(SHARD_B, dtype=torch.int32, device=dev)
            if paged:
                ref = PagedKVCache(*(None if t is None else t.clone()
                                     for t in whole), pt, length)
                blocks = [PagedKVCache(*p, pt, length) for p in parts]
            else:
                ref = KVCache(*whole, length)
                blocks = [KVCache(*p, length) for p in parts]
            decode.cache_append_rows(ref, 0, k5, v5, pos)
            for r, blk in enumerate(blocks):
                sharded.sharded_cache_append_rows(blk, 0, k5, v5, pos,
                                                  axis_name=(r, SHARD_N))
            torch.cuda.synchronize()
            for i, name in enumerate(("k", "v", "k_scale", "v_scale")):
                if whole[i] is None:
                    continue
                got = whole[i] if paged else torch.cat(
                    [getattr(b, name) for b in blocks],
                    dim=-1 if i >= 2 else -2)
                if not torch.equal(as_bytes(got),
                                   as_bytes(getattr(ref, name))):
                    raise AssertionError(
                        f"sharded_emulated {dtype} {store}: the straddling "
                        f"append's {name} differs from the unsharded one")
            emit({"phase": "sharded_emulated", "card": card,
                  "case": f"{dtype} {store}: append of 5 across 65536",
                  "bit_equal": True})
            del whole, parts, ref, blocks
            torch.cuda.empty_cache()
    counts = build.launch_counts()
    emit({"phase": "sharded_emulated_summary", "card": card,
          "seconds": time.perf_counter() - t_phase,
          "timed_rank1": timed, "launches": counts})
    return out, counts


# serve_sharded: the 0.88B config with window 4096 and 4 sinks, int8 cache,
# on a one-rank NCCL mesh: ShardedEngine.generate on a 16384-token prompt,
# the sharded continuous engines on SHARDED_REQS requests, the speculative
# ones (a self-draft) on the first SHARDED_SPEC of them
SHARDED_PROMPT, SHARDED_NEW = 16384, 64
SHARDED_REQS, SHARDED_SPEC, SHARDED_REQ_NEW = 8, 4, 16
SHARDED_PROMPTS = (4500, 6200)
SHARDED_S_MAX = 16384


def sharded_tokens_gate(tag, params, cfg, reqs, got, want, dev):
    """Each request's tokens equal the meshless engine's; where a near tie
    parts them, the sharded run's tokens are held to its bf16 teacher
    (their largest gap within TEACHER_TOL). Returns the parted requests."""
    parted = {}
    for r in reqs:
        a, b = got[r.id].tokens, want[r.id].tokens
        if len(a) != r.max_new:
            raise AssertionError(f"serve_sharded {tag}: request {r.id} "
                                 f"emitted {len(a)} tokens")
        if a != b:
            gap, at = target_greedy_gaps(params, cfg, r.tokens, a, dev)
            check(f"serve_sharded {tag} request {r.id} teacher gap", gap,
                  TEACHER_TOL)
            parted[r.id] = {"gap": gap, "at": at}
    return parted


def serve_sharded_phase(pkg, build, decode, dev, card):
    """serve_sharded: the sharded serving path on a one-rank NCCL mesh, each
    engine against its meshless counterpart on the same weights and
    requests: ShardedEngine.generate (b = 1, 16384 prompt tokens, 64 new,
    window 4096 + 4 sinks: B7 takes the sharded columns) against
    Engine.generate; ShardedContinuousEngine and
    ShardedPagedContinuousEngine (pages of 2048) against ContinuousEngine
    and PagedContinuousEngine on SHARDED_REQS requests; the two sharded
    speculative engines (self-draft, gamma 4) against the meshless ones.
    Gates: tokens equal, or at a near tie within TEACHER_TOL of the bf16
    teacher; exact B6 / B7 / decode_run counts on every sharded run.
    Returns the launch counts of each sharded run."""
    import torch.distributed as dist

    from long_context_attention_tpu_torch import serving
    from long_context_attention_tpu_torch.models.llama import init_params
    from long_context_attention_tpu_torch.parallel import make_usp_mesh

    cfg = pkg.ModelConfig(**MODEL, **WINDOWED)
    L = cfg.n_layers
    gen = torch.Generator(device=dev).manual_seed(SEED + 22)
    params = init_params(gen, cfg, device=dev)
    rng = np.random.default_rng(22)
    reqs = [serving.Request(id=i, tokens=[int(t) for t in rng.integers(
        0, cfg.vocab, int(rng.integers(*SHARDED_PROMPTS)))],
        max_new=SHARDED_REQ_NEW) for i in range(SHARDED_REQS)]
    prompt = torch.randint(0, cfg.vocab, (1, SHARDED_PROMPT), generator=gen,
                           device=dev)
    counts, numbers, parted = {}, {}, {}
    t_phase = time.perf_counter()
    mesh = make_usp_mesh()
    try:
        s_max = SHARDED_PROMPT + 4096
        eng = serving.ShardedEngine(cfg, mesh, s_max, "int8")
        one = serving.Engine(cfg, s_max, "int8", device=dev)
        eng.prefill(params, prompt[:, :CHUNK])  # warm-up
        build.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks, cache, logits = eng.generate(params, prompt, SHARDED_NEW)
        torch.cuda.synchronize()
        numbers["generate_s"] = time.perf_counter() - t0
        counts["serve_sharded generate"] = expect_counts(build, {
            "cache_append": 1 + L * SHARDED_NEW,
            "decode_attention": L * SHARDED_NEW, "decode_run": 0})
        ref = one.generate(params, prompt, SHARDED_NEW)
        numbers["cache_bytes"] = cache_bytes(cache)
        if cache.k.shape[3] != s_max or cache.length.tolist() != [
                SHARDED_PROMPT + SHARDED_NEW]:
            raise AssertionError(f"serve_sharded generate: cache "
                                 f"{tuple(cache.k.shape)}, length "
                                 f"{cache.length.tolist()}")
        a, b = toks[0].tolist(), ref.tokens[0].tolist()
        numbers["generate_prefill_logits_max_abs_err"] = max_err(
            logits, ref.prefill_logits)
        check("serve_sharded generate prefill logits",
              numbers["generate_prefill_logits_max_abs_err"], TEACHER_TOL)
        if a != b:
            gap, at = target_greedy_gaps(params, cfg, prompt[0].tolist(), a,
                                         dev)
            check("serve_sharded generate teacher gap", gap, TEACHER_TOL)
            parted["generate"] = {"gap": gap, "at": at}
        del cache, ref
        torch.cuda.empty_cache()
        common = dict(s_max=SHARDED_S_MAX, max_batch=8, cache_dtype="int8",
                      weight_dtype="int8", step_block=STEP_BLOCK)
        page = dict(page_size=PAGE, pool_pages=8 * (SHARDED_S_MAX // PAGE)
                    + 1)
        for tag, sh, base, extra in (
                ("continuous", serving.ShardedContinuousEngine,
                 serving.ContinuousEngine, {}),
                ("paged", serving.ShardedPagedContinuousEngine,
                 serving.PagedContinuousEngine, page)):
            want = base(cfg, **common, **extra, device=dev).serve(params,
                                                                  reqs)
            sheng = probe_engine(sh)(cfg, **common, **extra, mesh=mesh)
            res, wall, ntok, steps, got = serve_timed(build, sheng, params,
                                                      reqs)
            counts[f"serve_sharded {tag}"] = expect_counts(build, {
                "cache_append": L * steps + SHARDED_REQS,
                "decode_attention": L * steps, "decode_run": 0})
            if tag == "paged":
                expect_native("serve_sharded paged", sheng)
            parted[tag] = sharded_tokens_gate(tag, params, cfg, reqs, res,
                                              want, dev)
            numbers[tag] = {"wall_s": wall, "tok_per_s": ntok / wall,
                            "decode_steps": steps}
            torch.cuda.empty_cache()
        spec_reqs = reqs[:SHARDED_SPEC]
        sub = spec_subruns(decode, cfg, SPEC_GAMMA + 1, SHARDED_S_MAX,
                           False)
        psub = spec_subruns(decode, cfg, SPEC_GAMMA + 1, PAGE, True)
        for tag, sh, base, extra, n_sub in (
                ("speculative", serving.ShardedSpeculativeContinuousEngine,
                 serving.SpeculativeContinuousEngine, {}, sub),
                ("speculative paged",
                 serving.ShardedPagedSpeculativeContinuousEngine,
                 serving.PagedSpeculativeContinuousEngine, page, psub)):
            kw = dict(common, step_block=1, draft_cfg=cfg, gamma=SPEC_GAMMA,
                      **extra)
            want = base(cfg, **kw, device=dev).serve(params, params,
                                                     spec_reqs)
            sheng = sh(cfg, **kw, mesh=mesh)
            build.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = sheng.serve(params, params, spec_reqs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            rounds = sheng.round_stats["rounds"]
            steps = SPEC_GAMMA + 1
            counts[f"serve_sharded {tag}"] = expect_counts(build, {
                "cache_append": rounds * (steps + 1) * L
                + 2 * SHARDED_SPEC,
                "decode_attention": rounds * steps * L,
                "decode_run": rounds * L * n_sub})
            parted[tag] = sharded_tokens_gate(tag, params, cfg, spec_reqs,
                                              res, want, dev)
            stats = sheng.round_stats
            numbers[tag] = {"wall_s": wall, "rounds": rounds,
                            "acceptance": stats["accepted"]
                            / max(stats["drafted"], 1)}
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    emit({"phase": "serve_sharded", "card": card, "model": "llama-0.88B",
          "mesh": "dp 1 x ring 1 x ulysses 1 (NCCL)", "window_left": WINDOW,
          "sink_tokens": SINKS, "cache_dtype": "int8",
          "generate_prompt": SHARDED_PROMPT, "generate_new": SHARDED_NEW,
          "requests": SHARDED_REQS, "speculative_requests": SHARDED_SPEC,
          "max_new": SHARDED_REQ_NEW, "teacher_tol": TEACHER_TOL,
          "parted_at_near_ties": parted, **numbers,
          "launches": counts, "seconds": time.perf_counter() - t_phase})
    return counts

# ---------------------------------------------------------------------------
# the MoE model, served and trained; ZeRO-1/2 and ZeRO-3
# ---------------------------------------------------------------------------

# The 0.88B config with a routed FFN: 8 experts of its FFN width a layer,
# top-1, at the JAX ModelConfig's default capacity factor 2.0 (3.23B
# parameters, 2.90B of them experts); random weights from the seed. The
# experts stay bf16 (int8 decode weights raise, as in JAX). With random
# weights the deeper layers' routers send most tokens one way: at 2.0
# they drop 12-75% of a prefill's tokens in layers 4-16.
MOE = dict(MODEL, n_experts=8)
MOE_REQS, MOE_REQ_NEW = 8, 16
MOE_TRAIN_STEPS = 3
ZERO_STEPS = 2


def moe_drop_shares(drops, L):
    """Each layer's dropped share of the routed tokens over the calls a
    record_drops block saw (L a pass, in layer order), and the least router
    margin."""
    shares = []
    for i in range(L):
        rec = drops[i::L]
        shares.append(sum(int(d["dropped"]) for d in rec)
                      / sum(d["tokens"] for d in rec))
    return shares, min(float(d["margin"]) for d in drops)


def full_capacity(cfg):
    """The config whose MoE routing drops nothing: the decode steps'."""
    return dataclasses.replace(cfg, moe_capacity_factor=float(cfg.n_experts))


def moe_serve_phase(pkg, build, dev, card):
    """moe_serve: the MoE model (MOE) served with bf16 weights, int8 cache
    unless named: at its capacity factor 2.0, prefill_chunked (4 x 8192 in
    chunks of 2048) and decode_scan of NEW tokens, generate at b=2 over a
    bf16 cache and ContinuousEngine on MOE_REQS requests, with exact launch
    counts, each layer's dropped share and every token's teacher gap
    (reported: the chunks, the admissions and a teacher's one forward
    route different token sets, so where tokens drop their FFNs differ by
    design, in JAX too); then the same generate and requests at full
    capacity (nothing drops), where every greedy token is held within
    TEACHER_TOL of its bf16 teacher's largest logit (forward_local).
    weight_dtype="int8" raises. Returns each run's counts."""
    from long_context_attention_tpu_torch.models.llama import init_params
    from long_context_attention_tpu_torch.parallel.moe import record_drops
    from long_context_attention_tpu_torch.serving import (
        ContinuousEngine, Engine, Request)

    base = pkg.ModelConfig(**MOE)
    L = base.n_layers
    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED + 23)
    params = init_params(gen, base, device=dev)
    prompt = torch.randint(0, base.vocab, (BATCH, PROMPT), generator=gen,
                           device=dev)
    try:
        Engine(cfg=base, s_max=S_MAX, weight_dtype="int8",
               device=dev).decode_params(params)
        raise AssertionError("moe_serve: int8 weights did not raise")
    except ValueError:
        pass
    eng = Engine(cfg=base, s_max=S_MAX, cache_dtype="int8", device=dev)
    wl, wc = eng.prefill_chunked(params, prompt[:, :CHUNK], CHUNK)  # warm-up
    eng.decode_scan(params, wc, 4, torch.argmax(wl, -1).to(torch.int32))
    del wl, wc
    torch.cuda.synchronize()
    counts, numbers = {}, {}
    gaps = {"capacity 2.0": {}, "full capacity": {}}
    build.reset_launch_counts()
    t0 = time.perf_counter()
    with record_drops() as drops:
        logits, cache = eng.prefill_chunked(params, prompt, CHUNK)
        torch.cuda.synchronize()
    numbers["prefill_s"] = time.perf_counter() - t0
    numbers["prefill_drop_share_per_layer"], numbers[
        "prefill_router_margin"] = moe_drop_shares(drops, L)
    first = torch.argmax(logits, -1).to(torch.int32)
    t0 = time.perf_counter()
    toks, cache = eng.decode_scan(params, cache, NEW, first)
    torch.cuda.synchronize()
    numbers["decode_ms_per_step"] = 1e3 * (time.perf_counter() - t0) / NEW
    counts["moe_serve prefill_chunked"] = expect_counts(build, {
        "flash_fwd_causal_self": L * (PROMPT // CHUNK),
        "flash_fwd_static": 0, "flash_fwd_pos": L * (PROMPT // CHUNK - 1),
        "cache_append": L * (PROMPT // CHUNK) + L * NEW,
        "decode_attention": L * NEW, "decode_run": 0})
    if not torch.isfinite(logits).all() or toks.shape != (BATCH, NEW):
        raise AssertionError("moe_serve: prefill logits not finite or bad "
                             "decode shapes")
    del cache
    torch.cuda.empty_cache()
    for i in range(BATCH):  # token 0 is the prefill's
        gaps["capacity 2.0"][f"decode_scan {i}"] = target_greedy_gaps(
            params, base, prompt[i].tolist(), toks[i].tolist(), dev)
    rng = np.random.default_rng(23)
    reqs = [Request(id=i, tokens=[int(t) for t in rng.integers(
        0, base.vocab, int(rng.choice(list(CONT_PROMPTS))))],
        max_new=MOE_REQ_NEW) for i in range(MOE_REQS)]
    gprompt = prompt[:GEN_BATCH, :GEN_PROMPT]
    for tag, cfg in (("capacity 2.0", base),
                     ("full capacity", full_capacity(base))):
        # generate at b=2 over a bf16 cache
        gen_eng = Engine(cfg=cfg, s_max=GEN_PROMPT + GEN_NEW,
                         cache_dtype="bfloat16", device=dev)
        build.reset_launch_counts()
        t0 = time.perf_counter()
        with record_drops() as gdrops:
            res = gen_eng.generate(params, gprompt, GEN_NEW)
            torch.cuda.synchronize()
        run = {"generate_s": time.perf_counter() - t0,
               "generate_prefill_drop_share_per_layer": moe_drop_shares(
                   gdrops[:L], L)[0]}
        counts[f"moe_serve generate {tag}"] = expect_counts(build, {
            "flash_fwd_causal_self": L, "flash_fwd_static": 0,
            "flash_fwd_pos": 0, "cache_append": L + L * GEN_NEW,
            "decode_attention": L * GEN_NEW, "decode_run": 0})
        for i in range(GEN_BATCH):
            gaps[tag][f"generate {i}"] = target_greedy_gaps(
                params, cfg, gprompt[i].tolist(), res.tokens[i].tolist(),
                dev)
        # ContinuousEngine on MOE_REQS requests, bench_paged's lengths
        ceng = probe_engine(ContinuousEngine)(
            cfg, max_batch=MOE_REQS, s_max=CONT_S_MAX, cache_dtype="int8",
            step_block=STEP_BLOCK, device=dev)
        with record_drops() as cdrops:
            out, wall, ntok, steps, ccounts = serve_timed(build, ceng,
                                                          params, reqs)
        expect_serving_counts(f"moe_serve continuous {tag}", ccounts, L,
                              steps, MOE_REQS)
        counts[f"moe_serve continuous {tag}"] = ccounts
        run["continuous"] = {"wall_s": wall, "tok_per_s": ntok / wall,
                             "decode_steps": steps,
                             "dropped_tokens": sum(int(d["dropped"])
                                                   for d in cdrops)}
        for r in reqs:
            if len(out[r.id].tokens) != MOE_REQ_NEW:
                raise AssertionError(f"moe_serve continuous: request "
                                     f"{r.id} emitted "
                                     f"{len(out[r.id].tokens)} tokens")
            gaps[tag][f"continuous {r.id}"] = target_greedy_gaps(
                params, cfg, r.tokens, out[r.id].tokens, dev)
        numbers[tag] = run
        torch.cuda.empty_cache()
    if numbers["full capacity"]["continuous"]["dropped_tokens"]:
        raise AssertionError("moe_serve: tokens dropped at full capacity")
    full = gaps["full capacity"]
    worst = max(full, key=lambda k: full[k][0])
    check(f"moe_serve full-capacity teacher gap ({worst} at "
          f"{full[worst][1]})", full[worst][0], TEACHER_TOL)
    emit({"phase": "moe_serve", "card": card, "model": "llama-0.88B moe",
          "n_experts": base.n_experts,
          "capacity_factor": base.moe_capacity_factor,
          "batch": BATCH, "prompt": PROMPT, "chunk": CHUNK,
          "new_tokens": NEW, "cache_dtype": "int8",
          "weight_dtype": "bfloat16", "int8_weights_raise": True,
          "generate": {"batch": GEN_BATCH, "prompt": GEN_PROMPT,
                       "new_tokens": GEN_NEW, "cache_dtype": "bfloat16"},
          "continuous_requests": MOE_REQS, "max_new": MOE_REQ_NEW,
          "teacher_tol": TEACHER_TOL, "teacher_gaps": {
              tag: {k: v[0] for k, v in g.items()}
              for tag, g in gaps.items()}, **numbers,
          "launches": counts, "seconds": time.perf_counter() - t_phase})
    del params
    torch.cuda.empty_cache()
    return counts


def leaf_rel(got, want):
    """The worst leaf's max |got - want| over max |want|."""
    from long_context_attention_tpu_torch.models.llama import param_leaves

    worst = 0.0
    for a, w in zip(param_leaves(got), param_leaves(want)):
        a, w = a.detach().float(), w.detach().float()
        worst = max(worst, float((a - w).abs().max()
                                 / w.abs().max().clamp_min(1e-30)))
    return worst


def update_rel(got, want, p0):
    """The worst leaf's ||got - want|| over ||want - p0|| (0 where neither
    moved from p0), and that leaf's name."""
    from long_context_attention_tpu_torch.models.llama import named_leaves

    worst, name = 0.0, None
    for (k, a), w, z in zip(named_leaves(got), (t for _, t in named_leaves(
            want)), (t for _, t in named_leaves(p0))):
        w = w.detach().float()
        diff = float((a.detach().float() - w).norm())
        move = float((w - z.float()).norm())
        rel = (diff / move if move else 0.0 if diff == 0.0
               else float("inf"))
        if name is None or rel > worst:
            worst, name = rel, k
    return worst, name


def moe_train_phase(pkg, build, dev, card):
    """moe_train: make_train_step on the MoE model at b=1, s=TRAIN_SEQ,
    AdamW: one step on a one-rank NCCL mesh against the meshless step from
    the same params (USP_LOSS_TOL, USP_LEAF_TOL, UPDATE_TOL), then a
    warm-up and
    MOE_TRAIN_STEPS timed meshless steps with exact B1 / B5 counts, a
    falling loss, each layer's dropped share and the peak memory, and one
    more step profiled."""
    import torch.distributed as dist

    from long_context_attention_tpu_torch.models.llama import (
        init_params, make_train_step, param_leaves)
    from long_context_attention_tpu_torch.parallel import make_usp_mesh
    from long_context_attention_tpu_torch.parallel.moe import record_drops

    cfg = pkg.ModelConfig(**MOE)
    L = cfg.n_layers
    t_phase = time.perf_counter()
    tokens, labels, mask = train_batch(cfg.vocab, TRAIN_SEQ, dev)
    opt = functools.partial(torch.optim.AdamW, lr=LR,
                            weight_decay=WEIGHT_DECAY)

    def fresh():
        return init_params(torch.Generator(device=dev).manual_seed(SEED),
                           cfg, device=dev)

    single = make_train_step(cfg, opt, device=dev)
    p1, s1, loss1 = single(fresh(), None, tokens, labels, mask)
    del s1
    torch.cuda.empty_cache()
    mesh = make_usp_mesh()
    try:
        p2, s2, loss2 = make_train_step(cfg, opt, mesh=mesh)(
            fresh(), None, tokens, labels, mask)
        one = {"loss_single": float(loss1), "loss_mesh": float(loss2),
               "loss_diff": abs(float(loss1) - float(loss2)),
               "worst_leaf_rel": leaf_rel(p2, p1)}
    finally:
        dist.destroy_process_group()
    del s2
    torch.cuda.empty_cache()
    one["worst_update_rel"], one["worst_update_leaf"] = update_rel(
        p2, p1, fresh())
    check("moe_train one-rank mesh loss vs meshless", one["loss_diff"],
          USP_LOSS_TOL)
    check("moe_train one-rank mesh leaves vs meshless",
          one["worst_leaf_rel"], USP_LEAF_TOL)
    check("moe_train one-rank mesh update vs meshless",
          one["worst_update_rel"], UPDATE_TOL)
    del p1, p2
    torch.cuda.empty_cache()
    params, state, loss = single(fresh(), None, tokens, labels, mask)
    losses = [float(loss)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    times = []
    for i in range(MOE_TRAIN_STEPS):
        t0 = time.perf_counter()
        with record_drops() as drops:
            params, state, loss = single(params, state, tokens, labels, mask)
            losses.append(float(loss))
        times.append(time.perf_counter() - t0)
        if i == 0:
            shares, margin = moe_drop_shares(drops, L)
    counts = expect_counts(build, {
        "flash_fwd_causal_self": MOE_TRAIN_STEPS * L,
        "flash_bwd_fused": MOE_TRAIN_STEPS * L, "flash_fwd_static": 0,
        "flash_fwd_pos": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0})
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"moe_train: the loss did not fall: {losses}")
    ms = 1e3 * sum(times) / MOE_TRAIN_STEPS
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    # one more step under the profiler: where the MoE step's time goes
    _, prof = profiled(lambda: single(params, state, tokens, labels,
                                      mask)[2])
    emit({"phase": "moe_train_profile", **prof})
    emit({"phase": "moe_train", "card": card, "model": "llama-0.88B moe",
          "n_experts": cfg.n_experts,
          "capacity_factor": cfg.moe_capacity_factor, "batch": 1,
          "seq": TRAIN_SEQ, "remat": cfg.remat,
          "params": sum(t.numel() for t in param_leaves(params)),
          "one_rank_mesh_step": one, "loss_tol": USP_LOSS_TOL,
          "leaf_tol": USP_LEAF_TOL, "update_tol": UPDATE_TOL,
          "steps": MOE_TRAIN_STEPS,
          "ms_per_step": ms, "ms_all": [1e3 * t for t in times],
          "tok_per_s": TRAIN_SEQ / (ms / 1e3),
          "max_memory_allocated_gb": peak,
          "drop_share_per_layer": shares, "router_margin": margin,
          "losses": losses,
          "launches_per_step": {n: c // MOE_TRAIN_STEPS
                                for n, c in counts.items() if c},
          "seconds": time.perf_counter() - t_phase})
    del params, state, single
    torch.cuda.empty_cache()
    return counts


def zero_train_phase(pkg, build, dev, card):
    """zero_train: make_zero_train_step (ZeRO-1/2) and make_zero3_train_step
    under remat full on a one-rank NCCL mesh at the dense 0.88B config,
    b=1, s=TRAIN_SEQ, AdamW: one step each from the same params against
    make_train_step's meshless step (USP_LOSS_TOL, USP_LEAF_TOL,
    UPDATE_TOL), then
    ZERO_STEPS timed steps with exact counts (the mesh's B3, B2a, B2b; B3
    twice a layer under remat full), the optimizer's state bytes and the
    peak memory. Returns each run's counts."""
    import torch.distributed as dist

    from long_context_attention_tpu_torch.models.llama import (
        init_params, make_train_step, param_shapes, shard_params)
    from long_context_attention_tpu_torch.parallel import make_usp_mesh
    from long_context_attention_tpu_torch.parallel import zero

    cfg = pkg.ModelConfig(**dict(MODEL, layout="zigzag"))
    L = cfg.n_layers
    t_phase = time.perf_counter()
    tokens, labels, mask = train_batch(cfg.vocab, TRAIN_SEQ, dev)
    opt = functools.partial(torch.optim.AdamW, lr=LR,
                            weight_decay=WEIGHT_DECAY)

    def fresh():
        return init_params(torch.Generator(device=dev).manual_seed(SEED),
                           cfg, device=dev)

    want, _, want_loss = make_train_step(cfg, opt, device=dev)(
        fresh(), None, tokens, labels, mask)
    torch.cuda.empty_cache()
    p0 = fresh()
    mesh = make_usp_mesh()
    report, counts = {}, {}
    try:
        for tag in ("zero1", "zero3"):
            if tag == "zero1":
                rcfg = cfg
                step = zero.make_zero_train_step(rcfg, mesh, opt)
                params = shard_params(fresh(), mesh)
            else:
                rcfg = dataclasses.replace(cfg, remat="full")
                zs = zero.zero3_param_specs(param_shapes(rcfg), mesh)
                step = zero.make_zero3_train_step(rcfg, mesh, opt)
                params = zero.shard_params_zero3(fresh(), mesh, zs)
            params, state, loss = step(params, None, tokens, labels, mask)
            one = {"loss": float(loss), "loss_single": float(want_loss),
                   "loss_diff": abs(float(loss) - float(want_loss)),
                   "worst_leaf_rel": leaf_rel(params, want)}
            one["worst_update_rel"], one["worst_update_leaf"] = update_rel(
                params, want, p0)
            check(f"zero_train {tag} loss vs make_train_step",
                  one["loss_diff"], USP_LOSS_TOL)
            check(f"zero_train {tag} leaves vs make_train_step",
                  one["worst_leaf_rel"], USP_LEAF_TOL)
            check(f"zero_train {tag} update vs make_train_step",
                  one["worst_update_rel"], UPDATE_TOL)
            losses = [float(loss)]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            build.reset_launch_counts()
            times = []
            for _ in range(ZERO_STEPS):
                t0 = time.perf_counter()
                params, state, loss = step(params, state, tokens, labels,
                                           mask)
                losses.append(float(loss))
                times.append(time.perf_counter() - t0)
            n_fwd = ZERO_STEPS * L * (2 if rcfg.remat == "full" else 1)
            counts[f"zero_train {tag}"] = expect_counts(build, {
                **{n: 0 for n in build.KERNELS},
                "flash_fwd_pos": n_fwd, "flash_bwd_dq": ZERO_STEPS * L,
                "flash_bwd_dkv": ZERO_STEPS * L})
            if not losses[-1] < losses[0]:
                raise AssertionError(f"zero_train {tag}: the loss did not "
                                     f"fall: {losses}")
            opt_state = state.optimizer if tag == "zero1" else state
            state_bytes = sum(t.numel() * t.element_size()
                              for st in opt_state.state.values()
                              for t in st.values()
                              if isinstance(t, torch.Tensor))
            ms = 1e3 * sum(times) / ZERO_STEPS
            report[tag] = {"remat": rcfg.remat, "one_step": one,
                           "steps": ZERO_STEPS, "ms_per_step": ms,
                           "ms_all": [1e3 * t for t in times],
                           "tok_per_s": TRAIN_SEQ / (ms / 1e3),
                           "optimizer_state_bytes": state_bytes,
                           "max_memory_allocated_gb":
                               torch.cuda.max_memory_allocated() / 2 ** 30,
                           "losses": losses}
            del params, state, step, loss
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    emit({"phase": "zero_train", "card": card, "model": "llama-0.88B",
          "mesh": "dp 1 x ring 1 x ulysses 1 (NCCL)", "layout": "zigzag",
          "batch": 1, "seq": TRAIN_SEQ, "loss_tol": USP_LOSS_TOL,
          "leaf_tol": USP_LEAF_TOL, "update_tol": UPDATE_TOL, **report,
          "launches": counts, "seconds": time.perf_counter() - t_phase})
    del want, p0
    torch.cuda.empty_cache()
    return counts


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    import long_context_attention_tpu_torch as pkg
    from long_context_attention_tpu_torch.ops import _build as build
    from long_context_attention_tpu_torch.ops import (
        decode, flash, kv_cache, sage, sparse)
    from long_context_attention_tpu_torch.parallel import ring
    from long_context_attention_tpu_torch.serving import sharded

    dev = torch.device("cuda")
    smi = smi_line()
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})

    t0 = time.perf_counter()
    logs = build.build_all()
    # the sm90 kernels' dynamic shared memory (ptxas sees only static
    # memory)
    bwd_smem = {}
    for hd in (128, 64):
        bwd_lib = build.library("flash_bwd_sm90.cu", hd)
        bwd_smem.update({("" if hd == 128 else "d=64 ") + n:
                         bwd_lib.lca_flash_bwd_smem(f, ft) for n, f, ft in (
                             ("B2b, B9c" if hd == 128 else "B2b", 0, 0),
                             ("B5", 1, 0), ("B2b features", 0, 1))})
    fwd_lib = build.library("flash_fwd_sm90.cu")
    fwd_smem = {n: fwd_lib.lca_flash_fwd_smem(qt, ft) for n, qt, ft in (
        ("B1, B3, B4, B9a", 0, 0), ("B3 quantized", 1, 0),
        ("B3 features", 0, 1), ("B3 quantized features", 1, 1))}
    fwd64 = build.library("flash_fwd_sm90.cu", 64)
    fwd_smem.update({"d=64 B1, B3": fwd64.lca_flash_fwd_smem(0, 0),
                     "d=64 B3 quantized": fwd64.lca_flash_fwd_smem(1, 0),
                     "d=64 B3 features": fwd64.lca_flash_fwd_smem(0, 1)})
    dq_smem = {}
    for hd in (128, 64):
        dq_lib = build.library("flash_dq_sm90.cu", hd)
        dq_smem.update({("" if hd == 128 else "d=64 ") + n:
                        dq_lib.lca_flash_dq_smem(ft) for n, ft in (
                            ("B2a, B9b" if hd == 128 else "B2a", 0),
                            ("B2a features", 1))})
    sage_lib = build.library("sage_fwd_sm90.cu")
    sage_smem = {"B8a, B8b, B8c": sage_lib.lca_sage_fwd_smem(0),
                 "pv_int8": sage_lib.lca_sage_fwd_smem(1)}
    run_smem, want_smem = {}, {}
    for hd in (128, 64):
        run_lib = build.library("decode_run_sm90.cu", hd)
        for tag, s8 in (("bf16 and cast", 0), ("s8", 1)):
            key = tag if hd == 128 else f"d=64 {tag}"
            run_smem[key] = run_lib.lca_decode_run_smem(s8)
            want_smem[key] = decode.decode_run_smem(bool(s8), hd)
    if run_smem != want_smem:
        raise AssertionError(f"decode_run's shared memory {run_smem} is not "
                             f"the wrapper's (ops/decode.py decode_run_smem)")
    # one-token B7's block at the serving spans (int8 and fp8 256 columns,
    # bf16 128, int4 512), one token (G = 2) and a run of 4 (G = 8)
    tok_lib = build.library("decode_attention.cu")
    tok_smem = {f"G={g} span={sp} s8={s8}":
                tok_lib.lca_decode_attention_smem(g, sp, s8)
                for g in (2, 8) for sp, s8 in ((256, 1), (128, 0), (512, 1))}
    # the backward kernels' instantiations (B5, B2b and B9c: FUSED, SPARSE,
    # MASK, MULTI, FEAT; B2a and B9b: the dq kernel's walk) and B9a's of
    # the forward; and, apart, the featured instantiations of B3
    # (TRI, FORM, QUANT, SPARSE, MULTI, FEAT = true), B2a (DenseRows<CAP,
    # MULTI, FEAT = true>) and B2b
    entries = {n: e for src in ("flash_fwd_sm90.cu", "flash_dq_sm90.cu",
                                "flash_bwd_sm90.cu")
               for n, e in ptxas_entries(logs.get(src, "")).items()}
    # (B3's template arguments: TRI, FORM, QUANT, SPARSE, MULTI, FEAT; the
    # quantized kind is a run-time value of its producers)
    featured = re.compile(r"flash_fwd_sm90_kernelILb0ELi\dELb[01]ELb0ELb[01]"
                          r"ELb1E|DenseRowsILb[01]ELb[01]ELb1E|"
                          r"flash_bwd_sm90_kernelILb0ELb0ELi\dELb[01]ELb1E")
    new = {n: e for n, e in entries.items()
           if ("kernelILb0ELi0ELb0ELb1E" in n or "flash_dq_sm90_kernel" in n
               or "flash_bwd_sm90_kernel" in n) and not featured.search(n)}
    feat_entries = {n: e for n, e in entries.items() if featured.search(n)}
    # B3's quantized K/V instantiations (QUANT: int8, fp8 and int4 in one)
    # and B7's kinds
    quant_kernels = re.compile(r"flash_fwd_sm90_kernelILb0ELi\dELb1E|"
                               r"decode_span_kernelILi\dELb[01]E")
    quant_entries = {n: e for src in ("flash_fwd_sm90.cu",
                                      "decode_attention.cu")
                     for n, e in ptxas_entries(logs.get(src, "")).items()
                     if quant_kernels.search(n)}
    # every instantiation of the head dim 64 libraries
    hd64_entries = {src: ptxas_entries(log) for src, log in logs.items()
                    if src.endswith(":d64")}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "sources": sorted(logs),
          "flash_fwd_sm90_dynamic_smem_bytes": fwd_smem,
          "flash_dq_sm90_dynamic_smem_bytes": dq_smem,
          "flash_bwd_sm90_dynamic_smem_bytes": bwd_smem,
          "sage_fwd_sm90_dynamic_smem_bytes": sage_smem,
          "ptxas_sage": ptxas_entries(logs.get("sage_fwd_sm90.cu", "")),
          "decode_run_dynamic_smem_bytes": run_smem,
          "ptxas_decode_run": ptxas_entries(logs.get("decode_run_sm90.cu",
                                                     "")),
          "decode_attention_dynamic_smem_bytes": tok_smem,
          "ptxas_decode_attention": ptxas_entries(
              logs.get("decode_attention.cu", "")),
          "source_seconds": build.build_seconds(),
          "ptxas_bwd_dq_b9a": new, "ptxas_features": feat_entries,
          "ptxas_quant_cache": quant_entries, "ptxas_hd64": hd64_entries})
    for src, log in logs.items():
        for line in log.splitlines():
            if any(w in line for w in ("entry function", "registers",
                                       "spill")):
                print(f"ptxas {src}: {line.strip()}", file=sys.stderr)
    print(f"flash_fwd_sm90.cu: dynamic shared memory per block {fwd_smem}",
          file=sys.stderr)
    print(f"flash_dq_sm90.cu: dynamic shared memory per block {dq_smem}",
          file=sys.stderr)
    print(f"flash_bwd_sm90.cu: dynamic shared memory per block {bwd_smem}",
          file=sys.stderr)
    print(f"sage_fwd_sm90.cu: dynamic shared memory per block {sage_smem}",
          file=sys.stderr)
    print(f"decode_run_sm90.cu: dynamic shared memory per block {run_smem}",
          file=sys.stderr)

    K = build.KERNELS
    gen = torch.Generator(device=dev).manual_seed(SEED)
    seconds = {"build": time.perf_counter() - t0}

    def lap(name):  # command time by phase, for the run's budget
        seconds[name] = time.perf_counter() - t0 - sum(seconds.values())

    rows = []
    for fn, mod in ((kernel_b1, flash), (kernel_b4, flash),
                    (kernel_b3, flash), (kernel_quant, sage),
                    (kernel_b8, sage), (kernel_b8_pv8, sage),
                    (kernel_b6, decode),
                    (kernel_b7, decode), (kernel_bwd, flash),
                    (kernel_b9, sparse)):
        res = fn(K, mod, gen, dev)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        for r in res if isinstance(res, list) else [res]:
            emit({"phase": "kernel", **r})
            rows.append(r)
    # B6 and B7 through the page table, B7 over multi-token runs
    by_name = {r["name"]: r for r in rows}
    by_name["cache_append"]["paged_cases"], paged_rows = kernel_b6_paged(
        decode, gen, dev)
    by_name["cache_append"]["rows_cases"] += paged_rows
    for case in paged_rows:
        emit({"phase": "kernel_paged", "name": "cache_append", **case})
    by_name["decode_attention"]["paged_cases"] = kernel_b7_paged(decode,
                                                                 gen, dev)
    for name in ("cache_append", "decode_attention"):
        for case in by_name[name]["paged_cases"]:
            emit({"phase": "kernel_paged", "name": name, **case})
    torch.cuda.empty_cache()
    # B6, B7 and B3 over the fp8 and int4 caches
    quant_cases, quant_rows = kernel_quant_cache(K, flash, decode, kv_cache,
                                                 gen, dev)
    for name, cases in quant_cases.items():
        by_name[name]["quant_cases"] = cases
        for case in cases:
            emit({"phase": "kernel_quant_cache", "name": name, **case})
    by_name["cache_append"]["rows_cases"] += quant_rows
    for case in quant_rows:
        emit({"phase": "kernel_quant_cache", "name": "cache_append", **case})
    emit({"phase": "b6_summary", "card": smi, "cases": [
        {k: c[k] for k in ("case", "ms", "call_ms", "host_ms", "plain_ms",
                           "library_ms", "bound_ms", "torch_chain_mismatch",
                           "path")}
        for c in by_name["cache_append"]["rows_cases"]],
        "launch_floor_ms": by_name["cache_append"]["launch_floor"]["ms"]})
    torch.cuda.empty_cache()
    # B7's runs on decode_run
    run_row = kernel_b7_runs(K, decode, kv_cache, gen, dev)
    emit({"phase": "kernel", **run_row})
    rows.append(run_row)
    torch.cuda.empty_cache()
    lap("kernels")
    # the d = 64 kernels at TinyLlama's shapes, serving's and training's
    hd64_cases = kernel_hd64(K, flash, decode, kv_cache, gen, dev)
    torch.cuda.empty_cache()
    for name, cases in kernel_hd64_train(K, flash, ring, gen, dev).items():
        hd64_cases[name] += cases
    for name, cases in hd64_cases.items():
        for case in cases:
            emit({"phase": "kernel_hd64", "name": name, **case})
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    lap("kernel_hd64")
    # the four kernels at the dense ring's multi-chunk descriptors
    ring_rows = kernel_ring(K, flash, sage, ring, gen, dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    lap("kernel_ring")
    # B3, B2a and B2b with the features, and the exact keep-mask probes
    feat_rows = kernel_features(K, flash, ring, gen, dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    probes = feature_probes(flash, gen, dev)
    torch.cuda.empty_cache()
    lap("feature_kernels")
    # B3, B8b, B2a and B2b at the DiT's non-causal ragged shapes
    dit_rows = kernel_dit(K, flash, sage, gen, dev)
    for tag, case in dit_rows.items():
        emit({"phase": "kernel_dit", "kernel": tag, **case})
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    lap("kernel_dit")

    # each kernel's launches on its own path: serving (B1, B3, B6, B7),
    # windowed serving (B4; B3, B6, B7 in their "windowed" entries),
    # training (B5; its windowed case in windowed training), the offsets
    # call (B2a, B2b; their windowed case in the windowed offsets call),
    # sage serving (B8a dense,
    # B8b windowed; the quantization kernels in the dense one), the
    # non-causal sage call (B8c), the block-sparse USP
    # layer (B9a, B9b, B9c)
    counts, dense = serve_phase(pkg, build, dev, smi, windowed=False)
    torch.cuda.empty_cache()
    wcounts, windowed = serve_phase(pkg, build, dev, smi, windowed=True)
    emit({"phase": "serving_compare", "card": smi, "dense": dense,
          "windowed": {**windowed, "window_left": WINDOW,
                       "sink_tokens": SINKS}})
    torch.cuda.empty_cache()
    lap("slice")
    # the same slice over fp8 and int4 caches
    compared = ("prefill_s", "decode_ms_per_step", "decode_step_device_ms",
                "cache_bytes")
    qcounts, qnumbers = {}, {}
    for dt in QUANT_DTYPES:
        qcounts[dt], qnumbers[dt] = serve_phase(pkg, build, dev, smi,
                                                windowed=False,
                                                cache_dtype=dt)
        torch.cuda.empty_cache()
    emit({"phase": "slice_quant_compare", "card": smi,
          "int8": {k: dense[k] for k in compared},
          **{QUANT_TAG[dt]: {k: qnumbers[dt][k] for k in compared}
             for dt in QUANT_DTYPES},
          "cache_bytes_vs_int8": {QUANT_TAG[dt]: qnumbers[dt]["cache_bytes"]
                                  / dense["cache_bytes"]
                                  for dt in QUANT_DTYPES}})
    lap("slice_fp8_int4")
    sage_counts = sage_serve_phase(pkg, build, dev, smi)
    torch.cuda.empty_cache()
    lap("slice_sage")
    train_counts = train_phase(pkg, build, dev, smi)
    torch.cuda.empty_cache()
    train_phase(pkg, build, dev, smi, impl="sage", plan=SAGE_TRAIN_STEPS)
    torch.cuda.empty_cache()
    lap("train")
    wtrain_counts = train_phase(pkg, build, dev, smi,
                                plan=WINDOWED_TRAIN_STEPS, windowed=True)
    torch.cuda.empty_cache()
    lap("train_windowed")
    grad_check_phase(pkg, build, dev, smi)
    grad_check_phase(pkg, build, dev, smi, impl="sage",
                     remats=("none", "attn"))
    grad_check_phase(pkg, build, dev, smi, shape=GRAD_WINDOWED)
    torch.cuda.empty_cache()
    lap("grad_check")
    offsets_counts, woffsets_counts = offsets_phase(build, flash, dev, smi)
    api_counts = sage_api_phase(build, sage, dev, smi)
    lap("offsets")
    torch.cuda.empty_cache()
    usp_counts = usp_sparse_phase(build, sparse, flash, dev, smi)
    lap("usp_sparse")
    ring_counts, ring_sage_counts, ring_quant_counts = ring_emulated_phase(
        build, flash, ring, dev, smi)
    ring_features_phase(build, flash, ring, dev, smi)
    lap("ring_emulated")
    usp_dense_phase(build, flash, dev, smi)
    lap("usp_dense")
    varlen_counts = usp_varlen_phase(build, flash, dev, smi)
    lap("usp_varlen")
    train_usp_phase(pkg, build, dev, smi)
    torch.cuda.empty_cache()
    lap("train_usp")
    # the sequence-sharded prefill, the async USP layer, the DiT family
    new_paths = {"serve_mesh": serve_mesh_phase(pkg, build, dev, smi)}
    lap("serve_mesh")
    new_paths["usp_async"] = usp_async_phase(build, ring, dev, smi)
    lap("usp_async")
    dit_counts = dit_forward_phase(build, dev, smi)
    new_paths.update({f"dit_forward {impl}": c
                      for impl, c in dit_counts.items()})
    lap("dit_forward")
    new_paths["dit_train"] = dit_train_phase(build, dev, smi)
    lap("dit_train")
    paged = serve_paged_phase(pkg, build, dev, smi)
    lap("serve_continuous_paged")
    prefix = serve_prefix_phase(pkg, build, decode, dev, smi)
    lap("serve_prefix")
    stall = serve_stall_phase(pkg, build, decode, dev, smi)
    lap("serve_stall")
    # rolling window pages and speculative serving: their runs' launches
    new_paths.update(serve_windowed_paged_phase(pkg, build, decode, dev,
                                                smi))
    torch.cuda.empty_cache()
    lap("serve_windowed_paged")
    new_paths.update(serve_speculative_phase(pkg, build, decode, dev, smi))
    torch.cuda.empty_cache()
    lap("serve_speculative")
    # sequence-sharded serving: B7 with each rank's columns, emulated on
    # one card, then the sharded engines on a one-rank NCCL mesh
    sharded_cases, new_paths["sharded_emulated"] = sharded_emulated_phase(
        build, decode, kv_cache, sharded, gen, dev, smi)
    lap("sharded_emulated")
    new_paths.update(serve_sharded_phase(pkg, build, decode, dev, smi))
    torch.cuda.empty_cache()
    lap("serve_sharded")
    # the MoE model served and trained, ZeRO-1/2 and ZeRO-3
    new_paths.update(moe_serve_phase(pkg, build, dev, smi))
    lap("moe_serve")
    new_paths["moe_train"] = moe_train_phase(pkg, build, dev, smi)
    lap("moe_train")
    new_paths.update(zero_train_phase(pkg, build, dev, smi))
    lap("zero_train")
    # head dim 64: the TinyLlama-1.1B-shaped model served, dense and paged
    hd_paths = slice_hd64_phase(pkg, build, dev, smi)
    torch.cuda.empty_cache()
    lap("slice_hd64")
    hd_paths.update(serve_paged_hd64_phase(pkg, build, decode, dev, smi))
    torch.cuda.empty_cache()
    lap("serve_paged_hd64")
    # head dim 64 in training: the same model on one card, its gradients
    # against the CPU's, over a one-rank mesh, and the USP layer on packed
    # documents
    hd_paths["train_hd64"] = train_phase(pkg, build, dev, smi,
                                         plan=HD_TRAIN_STEPS,
                                         model=TINYLLAMA, tag="train_hd64")
    torch.cuda.empty_cache()
    lap("train_hd64")
    grad_check_phase(pkg, build, dev, smi, model=TINYLLAMA,
                     tag="grad_check_hd64")
    torch.cuda.empty_cache()
    lap("grad_check_hd64")
    hd_paths["train_usp_hd64"] = train_usp_phase(pkg, build, dev, smi,
                                                 model=TINYLLAMA,
                                                 tag="train_usp_hd64")
    torch.cuda.empty_cache()
    lap("train_usp_hd64")
    hd_paths["usp_varlen_hd64"] = usp_varlen_phase(build, flash, dev, smi,
                                                   model=TINYLLAMA,
                                                   tag="usp_varlen_hd64")
    torch.cuda.empty_cache()
    lap("usp_varlen_hd64")
    emit({"phase": "timing", "seconds": seconds})
    path = {"flash_fwd_static": wcounts, "flash_bwd_fused": train_counts,
            "flash_bwd_dq": offsets_counts, "flash_bwd_dkv": offsets_counts,
            "sage_fwd_tri": sage_counts["sage_fwd_tri"],
            "sage_fwd_pos": sage_counts["sage_fwd_pos"],
            **api_counts,
            **{n: sage_counts["sage_fwd_tri"] for n in SAGE_QUANT},
            **{n: usp_counts for n in SPARSE_KERNELS},
            "decode_run": stall["interleaved"]["multi_token_launches"]}
    quant_paths = {
        **{QUANT_SLICE[dt]: qcounts[dt] for dt in QUANT_DTYPES},
        FP8_RUNS[1]: paged["serve_paged_fp8"]["launches"],
        FP8_RUNS[256]: paged["fp8_interleaved"]["multi_token_launches"]}
    # the phases of B6's quantizing cases (B6_PATHS)
    b6_paths = {
        "slice": counts,
        **{QUANT_SLICE[dt]: qcounts[dt] for dt in QUANT_DTYPES},
        "serve_paged": paged["serve_paged"]["launches"],
        "serve_stall interleaved": stall["interleaved"][
            "multi_token_launches"],
        "serve_paged_fp8": paged["serve_paged_fp8"]["launches"],
        "serve_paged_fp8 interleaved": paged["fp8_interleaved"][
            "multi_token_launches"]}
    # the phases of B7's runs (RUN_PATHS)
    run_paths = {
        "serve_stall interleaved": stall["interleaved"][
            "multi_token_launches"],
        "serve_prefix": prefix["prefix"]["multi_token_launches"],
        "serve_paged_fp8 interleaved": paged["fp8_interleaved"][
            "multi_token_launches"]}
    for r in rows:
        r["launches"] = path.get(r["name"], counts)[r["name"]]
        if "windowed" in r:
            r["windowed"]["launches"] = wcounts[r["name"]]
        if "one_shot" in r:  # B4 in the windowed one-shot pallas prefill
            r["one_shot"]["launches"] = sage_counts["pallas window"][r["name"]]
        if "train" in r:  # B1 in the 3 timed `none` training steps
            r["train"]["launches"] = train_counts[r["name"]]
        if "bf16" in r:  # B3 in the offsets call
            r["bf16"]["launches"] = offsets_counts[r["name"]]
        # the masked backward cases on a path: B5's windowed model's
        # training call (3 timed `none` steps), B2a's and B2b's windowed
        # offsets call
        for case in r.get("masked_cases", []):
            if case["case"] == "window sinks":
                case["launches"] = wtrain_counts[r["name"]]
            elif case["case"] == "offsets window sinks":
                case["launches"] = woffsets_counts[r["name"]]
        # the ring's descriptor cases: launches in one layout's emulated
        # ring (ring x sage direct-int8 for B8b)
        tag = {"flash_fwd_pos": "B3", "flash_bwd_dq": "B2a",
               "flash_bwd_dkv": "B2b", "sage_fwd_pos": "B8b"}.get(r["name"])
        if tag:
            launches = (ring_sage_counts if tag == "B8b"
                        else ring_counts)[r["name"]]
            r["ring_cases"] = [dict(c, launches=launches)
                               for c in ring_rows[tag]]
        # the feature cases: launches on the slice's path (usp_varlen's
        # forward and backward)
        if tag in feat_rows:
            r["feature_cases"] = [dict(c, launches=varlen_counts[r["name"]])
                                  for c in feat_rows[tag]]
        if tag == "B3":
            r["keep_probes"] = probes
        # the paged cases: one-token launches on the paged engine's 32-row
        # run; B6's run of 256 in the interleaved stall run's chunks (B7's
        # runs are decode_run's run_cases)
        for case in r.get("paged_cases", []):
            src = (stall["interleaved"]["multi_token_launches"]
                   if "run of 256" in case["case"]
                   else paged["serve_paged"]["launches"])
            case["launches"] = src[r["name"]]
        # the fp8 and int4 cases: launches on the phase each names; none
        # for the forms that no phase of this run takes
        for case in r.get("quant_cases", []):
            if case["path"] is not None:
                case["launches"] = quant_paths[case["path"]][r["name"]]
        # B6's quantizing cases: launches on the phase each names
        # (B6_PATHS)
        for case in r.get("rows_cases", []):
            case["launches"] = (None if case["path"] is None else
                                b6_paths[case["path"]][r["name"]])
        # B7's runs: launches on the phase each names (RUN_PATHS)
        for case in r.get("run_cases", []):
            if case["path"] is not None:
                case["launches"] = run_paths[case["path"]][r["name"]]
        if tag == "B3":  # B3 over fp8 and int4 K/V in the emulated rings
            r["quant_ring_cases"] = {
                QUANT_TAG[dt]: {"launches": ring_quant_counts[dt][r["name"]]}
                for dt in QUANT_DTYPES}
        # the DiT's cases: launches in the 30-layer forward (B3 under
        # pallas, B8b under sage) and in dit_train's timed steps (B2a, B2b)
        if tag in dit_rows:
            src = {"B3": new_paths["dit_forward pallas"],
                   "B8b": new_paths["dit_forward sage"]}.get(
                       tag, new_paths["dit_train"])
            r["dit_cases"] = [dict(dit_rows[tag], launches=src[r["name"]])]
        # the sequence-sharded cases: launches on serve_sharded's generate
        # (one token) and its speculative engine's verify runs
        if r["name"] in sharded_cases:
            src = new_paths["serve_sharded generate"
                            if r["name"] == "decode_attention"
                            else "serve_sharded speculative"]
            r["sharded_cases"] = [dict(c, launches=src[r["name"]])
                                  for c in sharded_cases[r["name"]]]
        # launches on the mesh engine's prefill and decode, the async
        # layer's forward and backward, the DiT forward and training, the
        # rolling window pages' and the speculative engines' runs, the
        # sharded engines', the MoE model's serving and training runs and
        # the ZeRO steps
        r["new_path_launches"] = {p: c[r["name"]] for p, c in
                                  new_paths.items() if c[r["name"]]}
    # the d = 64 kernels: a row each (the launches on the first of
    # HD_MAIN_PATHS that runs it, the numbers of its first case there),
    # their cases with the launches on the phase each names, and the d =
    # 128 row naming it
    by_name = {r["name"]: r for r in rows}
    for name, cases in hd64_cases.items():
        k64 = K[f"{name}_d64"]
        for c in cases:
            c["launches"] = (None if c["path"] is None
                             else hd_paths[c["path"]][k64.name])
        timed = [c for c in cases if "ms" in c]
        main_path = next(p for p in HD_MAIN_PATHS if hd_paths[p][k64.name])
        main_case = next((c for c in timed if c["path"] == main_path),
                         timed[0])
        rows.append({
            "name": k64.name, "route": "cuda",
            "source": f"long_context_attention_tpu_torch/csrc/{k64.source}",
            "replaces": k64.replaces, "head_dim": 64,
            "build": f"{k64.lib} (-DLCA_HEAD_DIM=64)",
            "launches": hd_paths[main_path][k64.name],
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            **{k: main_case[k] for k in ("ms", "plain_ms", "bound_ms",
                                         "bound_by", "library_ms")},
            "case": main_case["case"], "hd64_cases": cases,
            "path_launches": {p: c[k64.name] for p, c in hd_paths.items()
                              if c[k64.name]}})
        by_name[name]["hd64_row"] = k64.name
    emit({"kernels": rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
