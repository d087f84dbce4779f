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
     split into its quantization and its kernel; the
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
     entry (B8b);
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
     K/V) against one-device sage_attention;
 12. usp_dense: the dense LongContextAttention(layout="zigzag") on a
     one-rank NCCL mesh at s=32768 (the two-chunk descriptor (0, s/2)):
     exactly one B3, B2a and B2b per forward and backward, against
     flash_attention(causal=True), timed beside its kernels;
 13. train_usp: make_train_step(mesh=make_usp_mesh()) on the 0.88B config
     (zigzag) at b=1, s=8192: one step against the single-device step from
     the same params and batch (loss, every leaf), then remat none and attn
     with exact launch counts (B3, B2a, B2b; B1 and B5 never) and a
     falling loss, timed beside the single-device step.
Then the kernel table, the card's name and power limit, and as the last line
{"ok": true, "device": {...}}.
"""

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


def check_out(name, got, want, cancel_rows=None):
    """Hold an output (..., d) row by row against its size (ROW_REL_TOL);
    print the case's numbers and return (max abs error, worst row).

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
          "row_rel_tol": ROW_REL_TOL})
    if not worst <= ROW_REL_TOL:
        raise AssertionError(f"{name}: a row differs from the plain version "
                             f"by {worst} of its size, limit {ROW_REL_TOL}")
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
    fast and online forms, ragged lengths that cut a 128-row tile (1000 and
    4096 + 37), and the trainer's shape (b=1, s=8192); times at the chunk's
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
    # ragged lengths: partial q and kv tiles at the end
    for sr in (1000, 4096 + 37):
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


def kernel_b6(K, decode, gen, dev):
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
    ms = time_ms(lambda: decode.cache_append(
        *cache[:2], kn, vn, pos, *cache[2:], ksn, vsn, layer=layer), iters=50)
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
    return row(K["cache_append"], [(0.0, 0.0)], ms,
               plain_ms, 0, nbytes, lib_ms)


def kernel_b7(K, decode, gen, dev):
    """decode_attention, the wrapper the decode step calls (its q
    quantization or fold included), on the card against the same call on
    CPU copies of the layer, which runs the plain version."""
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
                                    o.cpu(), po))
            check(f"B7 lse {cache_dtype} safe={safe}", max_err(l.cpu(), pl_),
                  LSE_TOL)
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
                                     po))
            check(f"B7 lse {cache_dtype} {tag}", max_err(l.cpu(), pl_),
                  LSE_TOL)
        if cache_dtype == "int8":
            # the kernel alone, on the operands the wrapper makes
            q_in, q_rs, bkv = decode.decode_query_operands(
                q, kc, True, scale=scale, block_kv=4096)
            args = (q_in, q_rs, kc, vc, ks, vs, lens)
            kw = dict(layer=layer, block_kv=bkv, scale=scale)
            times["ms"] = time_ms(lambda: decode.decode_attention_core(
                *args, **kw), iters=20)
            times["plain_ms"] = time_ms(
                lambda: decode.decode_attention_core_plain(*args, **kw),
                iters=3, warmup=1)
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
    # int8 ops: q.k and p.v, 2 each per (head, column, feature)
    res = row(K["decode_attention"], checks,
              times["ms"], times["plain_ms"], 4 * h * int(lens.sum()) * d,
              nbytes_int8, times["lib"], PEAK_INT8_OPS)
    res["windowed"] = windowed
    return res


def kernel_b7_windowed(decode, q, kc, vc, ks, vs, lens, layer, checks):
    """B7 with the window and sinks over the int8 cache: the band check
    (each row's kv tiles outside its sink tile and window band get NaN
    scales) and the times, with the bound of the sink and band tokens."""
    b, h, d = q.shape
    hk, s_max = kc.shape[2], kc.shape[3]
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
    kw = dict(layer=layer, block_kv=bkv, scale=scale, window_left=WINDOW,
              sink_tokens=SINKS)
    ms = time_ms(lambda: decode.decode_attention_core(*args, **kw), iters=20)
    plain_ms = time_ms(lambda: decode.decode_attention_core_plain(
        *args, **kw), iters=3, warmup=1)
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
    res = case_row(checks, ms, plain_ms, 4 * h * seen * d, nbytes, lib_ms,
                   PEAK_INT8_OPS)
    return {"case": f"int8 cache, lengths {lens.tolist()}, window {WINDOW}, "
                    f"{SINKS} sinks", **res}


def sdpa_backward_ms(q, k, v, dout):
    """SDPA's flash backward (fwd+bwd minus fwd), causal, K/V repeated to
    the query heads (its flash backend takes no GQA)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    g = q.shape[2] // k.shape[2]
    qh = q.transpose(1, 2).detach().requires_grad_()
    kh, vh = (t.transpose(1, 2).repeat_interleave(g, 1).detach()
              .requires_grad_() for t in (k, v))
    doh = dout.transpose(1, 2)

    def fwd():
        with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
            return F.scaled_dot_product_attention(qh, kh, vh, is_causal=True)

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
    with its bound from the visible pairs. Returns {kernel: [case rows]}."""
    b, s, h, _ = q.shape
    d = q.shape[-1]
    out = {"B2a": [], "B2b": [], "B5": []}

    def fwd(q_start, shape):
        if q_start is None:
            return flash.flash_fwd_static(q, k, v, scale=scale, **shape)
        return flash.flash_fwd_pos(q, k.transpose(1, 2), v.transpose(1, 2),
                                   q_start=q_start, scale=scale, **shape)

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


def sdpa_masked_ms(q, k, v, dout, mask):
    """SDPA's memory-efficient kernel (it takes a boolean mask; flash does
    not) on the same function: (forward ms, backward ms), K/V repeated to
    the query heads."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    g = q.shape[2] // k.shape[2]
    qh = q.transpose(1, 2).detach().requires_grad_()
    kh, vh = (t.transpose(1, 2).repeat_interleave(g, 1).detach()
              .requires_grad_() for t in (k, v))
    doh = dout.transpose(1, 2)

    def fwd():
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)

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


def serve_phase(pkg, build, dev, card, windowed):
    """Serve the 0.88B config (dense, or with the sliding window and sinks):
    prefill_chunked + decode_scan with exact launch counts, teacher
    forcing, profiles of one decode step and a two-chunk prefill, and a
    generate at b=2. Returns the prefill_chunked + decode_scan run's launch
    counts and its serving numbers."""
    from long_context_attention_tpu_torch.models.llama import (
        decode_step, init_params)
    from long_context_attention_tpu_torch.serving.engine import Engine

    tag = "slice_windowed" if windowed else "slice"
    cfg = pkg.ModelConfig(**MODEL, **(WINDOWED if windowed else {}))
    L = cfg.n_layers
    # a chunk's self-attention: B4 under the window, B1 without it
    own, other = (("flash_fwd_static", "flash_fwd_causal_self") if windowed
                  else ("flash_fwd_causal_self", "flash_fwd_static"))
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = init_params(gen, cfg, device=dev)
    prompt = torch.randint(0, cfg.vocab, (BATCH, PROMPT), generator=gen,
                           device=dev)
    eng = Engine(cfg=cfg, s_max=S_MAX, cache_dtype="int8",
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
        own: L * (PROMPT // CHUNK), other: 0,
        "flash_fwd_pos": L * (PROMPT // CHUNK - 1),
        "cache_append": L * NEW, "decode_attention": L * NEW})
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
        getattr(cache, f).copy_(t)
    torch.cuda.synchronize()
    step1, profile = profiled(lambda: decode_step(dparams, cache, first,
                                                  cfg)[0])
    emit({"phase": "decode_profile", "serving": tag, **profile})
    del cache, fork
    tf_logits, _ = eng.prefill(params, torch.cat([prompt, first[:, None]],
                                                 dim=1))
    if not (torch.isfinite(step1).all() and torch.isfinite(tf_logits).all()):
        raise AssertionError("teacher-forcing logits are not finite")
    # breakdown of a two-chunk prefill (the self-attention kernel on both
    # chunks, B3 on the second)
    _, prefill_profile = profiled(lambda: eng.prefill_chunked(
        params, prompt[:, :2 * CHUNK], CHUNK)[0])
    emit({"phase": "prefill_profile", "serving": tag,
          "tokens": BATCH * 2 * CHUNK, **prefill_profile})
    tf_err = float((step1 - tf_logits).abs().max())
    tf_argmax = float((step1.argmax(-1) == tf_logits.argmax(-1)).float()
                      .mean())
    check(f"{tag} teacher forcing", tf_err, TEACHER_TOL)
    numbers = {"prefill_s": prefill_s,
               "prefill_tok_per_s": BATCH * PROMPT / prefill_s,
               "decode_ms_per_step": 1e3 * decode_s / NEW,
               "decode_tok_per_s": BATCH * NEW / decode_s}
    emit({"phase": tag, "card": card, "model": "llama-0.88B",
          "window_left": cfg.window_left, "sink_tokens": cfg.sink_tokens,
          "batch": BATCH, "prompt": PROMPT, "chunk": CHUNK,
          "new_tokens": NEW, "cache_dtype": "int8", "weight_dtype": "int8",
          **numbers, "teacher_forcing_max_abs_err": tf_err,
          "teacher_tol": TEACHER_TOL, "teacher_argmax_agree": tf_argmax,
          "launches": counts})

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
        own: L, other: 0, "flash_fwd_pos": 0,
        "cache_append": L * GEN_NEW, "decode_attention": L * GEN_NEW})
    if not torch.isfinite(res.prefill_logits).all() or res.tokens.shape != (
            GEN_BATCH, GEN_NEW):
        raise AssertionError("generate gave non-finite logits or bad shapes")
    emit({"phase": "generate", "serving": tag, "card": card,
          "batch": GEN_BATCH, "prompt": GEN_PROMPT, "new_tokens": GEN_NEW,
          "cache_dtype": "bfloat16", "weight_dtype": "int8",
          "seconds": gen_s, "launches": gcounts})
    return counts, numbers


# ---------------------------------------------------------------------------
# phase 5: the training slice
# ---------------------------------------------------------------------------


def train_batch(vocab, seq, dev):
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    tokens = torch.randint(0, vocab, (1, seq), generator=gen, device=dev)
    return tokens, torch.roll(tokens, -1, dims=1), torch.ones(
        (1, seq), dtype=torch.float32, device=dev)


def train_phase(pkg, build, dev, card, impl="pallas", plan=TRAIN_STEPS,
                windowed=False):
    """make_train_step on the 0.88B config at b=1, s=8192 with attention
    ``impl`` (pallas: B1 forward; sage: B8a and its quantization kernels;
    B5 backward for both; ``windowed``: pallas with WINDOWED, B4 forward
    and B5 over the band and the sink tiles): one
    warm-up step, then timed steps on the same batch under each remat
    policy of ``plan``, each step's launch counts checked exactly. Returns
    the counts of the `none` run."""
    from long_context_attention_tpu_torch.models.llama import (
        init_params, make_train_step, param_leaves)

    L = MODEL["n_layers"]
    fwd, other = FORWARD_KERNEL[impl], FORWARD_KERNEL[
        "pallas" if impl == "sage" else "sage"]
    shape, phase = {}, "train" if impl == "pallas" else "train_sage"
    if windowed:
        shape, phase = WINDOWED, "train_windowed"
        fwd, other = "flash_fwd_static", "flash_fwd_causal_self"
    tokens, labels, mask = train_batch(MODEL["vocab"], TRAIN_SEQ, dev)
    opt = functools.partial(torch.optim.AdamW, lr=LR,
                            weight_decay=WEIGHT_DECAY)
    main_counts = None
    for remat, steps in plan:
        cfg = pkg.ModelConfig(**MODEL, **shape, remat=remat, attn_impl=impl)
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
        counts = expect_counts(build, {
            fwd: n_fwd, other: 0, "flash_bwd_fused": steps * L,
            "flash_bwd_dq": 0, "flash_bwd_dkv": 0, "flash_fwd_pos": 0,
            "sage_fwd_pos": 0, **quant_counts(n_fwd if impl == "sage" else 0)})
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
              **shape, "remat": remat, "batch": 1,
              "seq": TRAIN_SEQ, "params": n_params, "steps": steps,
              "ms_per_step": ms, "ms_min": 1e3 * min(times),
              "ms_max": 1e3 * max(times), "ms_all": [1e3 * t for t in times],
              "tok_per_s": TRAIN_SEQ / (ms / 1e3),
              "tflops_6nd": flops / (ms / 1e3) / 1e12,
              "mfu": flops / (ms / 1e3) / PEAK_BF16_FLOPS,
              "max_memory_allocated_gb":
                  torch.cuda.max_memory_allocated() / 2 ** 30,
              "losses": losses, "launches_per_step":
                  {n: c // steps for n, c in counts.items()}})
        if remat == "none":
            _, prof = profiled(lambda: step(params, state, tokens, labels,
                                            mask)[2])
            emit({"phase": "train_profile", "attn_impl": impl, **shape,
                  "remat": remat, **prof})
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
                     remats=("none", "attn", "full"), shape=None):
    """The loss and every parameter gradient of loss_local with attention
    ``impl`` on the card (kernels) under each remat policy against the same
    backward on CPU copies without remat (plain versions), at 2 layers,
    full width, b=1, s=1024, each card run's forward kernel (B1 or B8a; B4
    with a ``shape``: GRAD_WINDOWED's window, sinks and softcap) and B5
    launches checked."""
    from long_context_attention_tpu_torch.models.llama import (
        init_params, loss_local)

    fwd = "flash_fwd_static" if shape else FORWARD_KERNEL[impl]
    cfg = pkg.ModelConfig(**{**MODEL, "n_layers": GRAD_LAYERS},
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
        counts = expect_counts(build, {
            fwd: n_fwd, "flash_bwd_fused": GRAD_LAYERS,
            **quant_counts(n_fwd if impl == "sage" else 0)})
        leaves = {}
        for n, want in g_cpu.items():
            size = float(want.abs().max())
            leaves[n] = {"rel_err": float((g_card[n] - want).abs().max())
                         / size, "max_abs": size,
                         "mean_abs": float(want.abs().mean())}
        worst = max(x["rel_err"] for x in leaves.values())
        emit({"phase": "grad_check", "card": card, "attn_impl": impl,
              **(shape or {}), "remat": remat, "layers": GRAD_LAYERS,
              "seq": GRAD_SEQ,
              "loss_card": loss_card,
              "loss_cpu": loss_cpu, "loss_tol": LOSS_TOL,
              "grad_tol": GRAD_TOL, "worst_rel_err": worst,
              "launches": {n: counts[n] for n in (fwd, "flash_bwd_fused",
                                                 *SAGE_QUANT)},
              "leaves": leaves})
        tag = f"{impl}{' windowed' if shape else ''} remat={remat}"
        check(f"grad_check {tag} loss",
              abs(loss_card - loss_cpu), LOSS_TOL)
        for n, x in leaves.items():
            check(f"grad_check {tag} {n} (relative to its "
                  f"largest value)", x["rel_err"], GRAD_TOL)


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


def kernel_ring(K, flash, sage, ring, gen, dev):
    """B3, B2a, B2b and B8b at the dense ring's multi-chunk and strided
    descriptors (RING_CASES), each against its plain version row by row
    (dead rows exactly 0, lse -inf), timed beside its bound from the
    case's visible pairs and SDPA's memory-efficient kernel with the
    equivalent boolean mask. Returns {kernel: [case rows]}."""
    b, s, h, hk, d = 1, RING_LOCAL, MODEL["n_heads"], MODEL["n_kv_heads"], 128
    scale = d ** -0.5
    q, dout = (torch.randn((b, s, h, d), generator=gen, device=dev)
               .bfloat16() for _ in range(2))
    k, v = (torch.randn((b, s, hk, d), generator=gen, device=dev).bfloat16()
            for _ in range(2))
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)
    q8, qs, _ = sage.sage_quant_q(q, scale)
    (k8, ks), (v8, vs) = (ring._quantize(t) for t in (k, v))
    out_rows = {n: [] for n in ("B3", "B2a", "B2b", "B8b")}
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
             in_b + 8 * b * h * s + 8 * k.numel(), PEAK_BF16_FLOPS, sdpa_b),
            ("B8b", c8, lambda: sage.sage_fwd_pos(*sargs, pos=pos, **mk),
             lambda: sage.sage_fwd_pos_plain(*sargs, pos=pos, **mk), 4,
             q.numel() + 2 * k.numel() + 2 * q.numel() + 4 * b * (h + 2 * hk) * s,
             PEAK_SAGE_OPS, sdpa_f))
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
    by row: B3 over int8 K/V (kv_quant="int8"), with softcap 50 and in the
    online form (safe_softmax); B2a and B2b with softcap 50."""
    pos, mk = ring_case_kwargs(ring, *RING_CASES[0])
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)
    (k8, ks), (v8, vs) = (ring._quantize(t) for t in (k, v))
    errs = {}
    for tag, args, kw in (
            ("int8 K/V", (q, k8.transpose(1, 2), v8.transpose(1, 2), ks, vs),
             {}),
            ("softcap", (q, kt, vt), dict(softcap=SOFTCAP)),
            ("safe_softmax", (q, kt, vt), dict(safe_softmax=True))):
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
          "row_rel_err": errs})


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
            "cache_append": L * NEW, "decode_attention": L * NEW})
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
            **quant_counts(L), "cache_append": L * GEN_NEW,
            "decode_attention": L * GEN_NEW})
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
    pre-quantized entry the q one only), nothing else. Returns the
    non-causal call's launch counts."""
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
    (_, o, l), (_, wo, wl) = runs["offsets"], runs["causal"]
    err = check_out("sage offsets (B8b) vs none (B8a) out", o, wo)
    check("sage offsets vs none lse", max_err(l, wl), LSE_TOL)
    emit({"phase": "sage_api", "card": card, "seq": s,
          "launches": {n: c for n, (c, _, _) in runs.items()},
          "offsets_row_rel_err": err[1]})
    return runs["noncausal"][0]


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
    emit({"phase": "ring_emulated", "card": card, "ring": W, "seq": s,
          "local": L, "heads": h, "kv_heads": hk, "layouts": results,
          "sage_int8": {"max_abs_err_vs_sage_attention": sage_err,
                        "tol": RING_SAGE_TOL, "launches": sage_counts}})
    del q, k, v, dout, want
    torch.cuda.empty_cache()
    return counts, sage_counts


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


# train_usp: remat policies and steps over the one-rank mesh
USP_TRAIN_STEPS = (("none", 3), ("attn", 2))
# the mesh step's loss against the single-device step's on one batch
USP_LOSS_TOL = 1e-2
# a leaf after one step against the single-device step's, of its largest
# value: two bf16 ulps (AdamW's first update is about lr in size, below one
# ulp of most weights, so the leaves differ where a gradient's sign does)
USP_LEAF_TOL = 2.0 ** -7


def train_usp_phase(pkg, build, dev, card):
    """make_train_step(mesh=make_usp_mesh()) on the full-width 0.88B config
    (layout zigzag: the ring of one's two-chunk descriptor) at b=1,
    s=8192, AdamW as in train: every layer's attention through
    usp_attention_local (B3 forward, B2a + B2b backward; B1 and B5 never).
    From the same initial params and batch, one single-device step (B1 +
    B5) and one mesh step: their losses within USP_LOSS_TOL, each leaf
    within USP_LEAF_TOL of its largest value. Then timed steps under remat
    none and attn with exact launch counts and a falling loss, beside the
    single-device steps' time."""
    import torch.distributed as dist

    from long_context_attention_tpu_torch.models.llama import (
        init_params, make_train_step, param_leaves)
    from long_context_attention_tpu_torch.parallel import make_usp_mesh

    L = MODEL["n_layers"]
    usp_model = dict(MODEL, layout="zigzag")
    tokens, labels, mask = train_batch(MODEL["vocab"], TRAIN_SEQ, dev)
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
        check("train_usp loss vs single device", dloss, USP_LOSS_TOL)
        worst = 0.0
        for a, w in zip(param_leaves(p2), param_leaves(p1)):
            a, w = a.detach().float(), w.detach().float()
            rel = float((a - w).abs().max() / w.abs().max().clamp_min(1e-30))
            worst = max(worst, rel)
        check("train_usp leaves vs single device", worst, USP_LEAF_TOL)
        report["one_step"] = {"loss_single": float(loss1),
                              "loss_mesh": float(loss2), "loss_diff": dloss,
                              "worst_leaf_rel": worst}
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
            counts = expect_counts(build, {
                n: steps * L if n in ("flash_fwd_pos", "flash_bwd_dq",
                                      "flash_bwd_dkv") else 0
                for n in build.KERNELS})
            if not all(math.isfinite(x) for x in losses):
                raise AssertionError(f"train_usp {remat}: loss {losses}")
            if not losses[-1] < losses[0]:
                raise AssertionError(f"train_usp {remat}: the loss did not "
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
    emit({"phase": "train_usp", "card": card, "mesh": "dp 1 x ring 1 x "
          "ulysses 1 (NCCL)", "layout": "zigzag", "batch": 1,
          "seq": TRAIN_SEQ, **report})
    return counts


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    import long_context_attention_tpu_torch as pkg
    from long_context_attention_tpu_torch.ops import _build as build
    from long_context_attention_tpu_torch.ops import decode, flash, sage, sparse
    from long_context_attention_tpu_torch.parallel import ring

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
    bwd_smem = {n: build.library("flash_bwd_sm90.cu").lca_flash_bwd_smem(f)
                for n, f in (("B2b, B9c", 0), ("B5", 1))}
    fwd_smem = {n: build.library("flash_fwd_sm90.cu").lca_flash_fwd_smem(f)
                for n, f in (("B1, B3, B4, B9a", 0), ("B3 int8", 1))}
    dq_smem = build.library("flash_dq_sm90.cu").lca_flash_dq_smem()
    sage_smem = build.library("sage_fwd_sm90.cu").lca_sage_fwd_smem()
    # the backward kernels' instantiations (B5, B2b and B9c: FUSED, SPARSE,
    # MASK; B2a and B9b: the dq kernel's walk) and B9a's of the forward
    new = {n: e for src in ("flash_fwd_sm90.cu", "flash_dq_sm90.cu",
                            "flash_bwd_sm90.cu")
           for n, e in ptxas_entries(logs.get(src, "")).items()
           if "kernelILb0ELi0ELb0ELb1E" in n or "flash_dq_sm90_kernel" in n
           or "flash_bwd_sm90_kernel" in n}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "sources": sorted(logs),
          "flash_fwd_sm90_dynamic_smem_bytes": fwd_smem,
          "flash_dq_sm90_dynamic_smem_bytes": {"B2a, B9b": dq_smem},
          "flash_bwd_sm90_dynamic_smem_bytes": bwd_smem,
          "sage_fwd_sm90_dynamic_smem_bytes": {"B8a, B8b": sage_smem},
          "ptxas_bwd_dq_b9a": new})
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

    K = build.KERNELS
    gen = torch.Generator(device=dev).manual_seed(SEED)
    seconds = {"build": time.perf_counter() - t0}

    def lap(name):  # command time by phase, for the run's budget
        seconds[name] = time.perf_counter() - t0 - sum(seconds.values())

    rows = []
    for fn, mod in ((kernel_b1, flash), (kernel_b4, flash),
                    (kernel_b3, flash), (kernel_quant, sage),
                    (kernel_b8, sage), (kernel_b6, decode),
                    (kernel_b7, decode), (kernel_bwd, flash),
                    (kernel_b9, sparse)):
        res = fn(K, mod, gen, dev)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        for r in res if isinstance(res, list) else [res]:
            emit({"phase": "kernel", **r})
            rows.append(r)
    # the four kernels at the dense ring's multi-chunk descriptors
    ring_rows = kernel_ring(K, flash, sage, ring, gen, dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    lap("kernels")

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
    rect_counts = sage_api_phase(build, sage, dev, smi)
    lap("offsets")
    torch.cuda.empty_cache()
    usp_counts = usp_sparse_phase(build, sparse, flash, dev, smi)
    lap("usp_sparse")
    ring_counts, ring_sage_counts = ring_emulated_phase(build, flash, ring,
                                                        dev, smi)
    lap("ring_emulated")
    usp_dense_phase(build, flash, dev, smi)
    lap("usp_dense")
    train_usp_phase(pkg, build, dev, smi)
    torch.cuda.empty_cache()
    lap("train_usp")
    emit({"phase": "timing", "seconds": seconds})
    path = {"flash_fwd_static": wcounts, "flash_bwd_fused": train_counts,
            "flash_bwd_dq": offsets_counts, "flash_bwd_dkv": offsets_counts,
            "sage_fwd_tri": sage_counts["sage_fwd_tri"],
            "sage_fwd_pos": sage_counts["sage_fwd_pos"],
            "sage_fwd_rect": rect_counts,
            **{n: sage_counts["sage_fwd_tri"] for n in SAGE_QUANT},
            **{n: usp_counts for n in SPARSE_KERNELS}}
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
    emit({"kernels": rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
