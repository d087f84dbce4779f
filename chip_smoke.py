#!/usr/bin/env python3
"""Smoke run of the PyTorch port (long_context_attention_tpu_torch) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON line each; any failure exits non-zero:
  1. device: the card, its power limit, torch and CUDA versions;
  2. build: nvcc builds every kernel under long_context_attention_tpu_torch/
     csrc/ (one process per source, in parallel) into build/kernels/;
  3. kernels: each kernel against its plain PyTorch version at the serving
     slice's shapes (B7 through decode_attention, the wrapper the decode
     step calls, against the same call on CPU copies of the layer), each
     output row held against its own size (ROW_REL_TOL), with its time, the plain version's, a PyTorch library call's
     (timed here only) and the least time the card could take;
  4. slice: the 0.88B llama config at full width and depth, random weights
     from a seed, served by Engine(cache_dtype="int8", weight_dtype="int8"):
     prefill_chunked of 4 x 8192 tokens in chunks of 2048, then decode_scan
     of 32 greedy tokens; then one generate at b=2 over a 1024-token prompt
     with a bf16 cache. Each run starts from zeroed launch counters and
     checks that every kernel of its path launched as often as the path
     implies; logits must be finite and the first decode step must agree
     with a prefill of prompt + that token (teacher forcing).
Then the kernel table, the card's name and power limit, and as the last line
{"ok": true, "device": {...}}.
"""

import json
import math
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor-core rate
PEAK_INT8_OPS = 1979e12    # H100 SXM dense int8 tensor-core rate
PEAK_BYTES = 3.35e12       # H100 SXM HBM3 rate
SEED = 0

# The 0.88B llama config that bench.py serves (full width and depth).
MODEL = dict(vocab=32000, dim=2048, n_layers=16, n_heads=16, n_kv_heads=8,
             head_dim=128, ffn_hidden=int(2048 * 2.7), layout="basic")
BATCH, PROMPT, CHUNK, NEW = 4, 8192, 2048, 32
S_MAX = ((PROMPT + NEW + 4095) // 4096) * 4096
GEN_BATCH, GEN_PROMPT, GEN_NEW = 2, 1024, 16

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


def emit(obj):
    print(json.dumps(obj), flush=True)


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


def check_out(name, got, want):
    """Hold an output (..., d) row by row against its size (ROW_REL_TOL);
    print the case's numbers and return (max abs error, worst row)."""
    got, want = got.float(), want.float()
    diff = (got - want).abs().amax(-1)
    size = want.abs().amax(-1)
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


def row(kernel, source, checks, ms, plain_ms, flops, nbytes, library_ms,
        peak=PEAK_BF16_FLOPS):
    b_ms, b_by = bound(flops, nbytes, peak)
    return {"name": kernel.name, "route": "cuda",
            "source": f"long_context_attention_tpu_torch/csrc/{source}",
            "replaces": kernel.replaces, "launches": None,
            "max_abs_err": max(e for e, _ in checks),
            "row_rel_err": max(r for _, r in checks), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": library_ms}


# ---------------------------------------------------------------------------
# phase 3: every kernel against its plain version
# ---------------------------------------------------------------------------


def kernel_b1(K, flash, gen, dev):
    b, s, h, hk, d = BATCH, CHUNK, MODEL["n_heads"], MODEL["n_kv_heads"], 128
    q = torch.randn((b, s, h, d), generator=gen, device=dev).bfloat16()
    k = torch.randn((b, s, hk, d), generator=gen, device=dev).bfloat16()
    v = torch.randn((b, s, hk, d), generator=gen, device=dev).bfloat16()
    scale = d ** -0.5
    checks = []
    for safe in (False, True):
        o, l = flash.flash_fwd_causal_self(q, k, v, scale=scale,
                                           safe_softmax=safe)
        po, pl_ = flash.flash_fwd_causal_self_plain(q, k, v, scale=scale,
                                                    safe_softmax=safe)
        torch.cuda.synchronize()
        checks.append(check_out(f"B1 out safe={safe}", o, po))
        check(f"B1 lse safe={safe}", max_err(l, pl_), LSE_TOL)
    # a ragged length: partial q and kv tiles at the end
    qr, kr_, vr_ = (t[:1, :1000].contiguous() for t in (q, k, v))
    o, l = flash.flash_fwd_causal_self(qr, kr_, vr_, scale=scale)
    po, pl_ = flash.flash_fwd_causal_self_plain(qr, kr_, vr_, scale=scale)
    torch.cuda.synchronize()
    checks.append(check_out("B1 out ragged", o, po))
    check("B1 lse ragged", max_err(l, pl_), LSE_TOL)
    ms = time_ms(lambda: flash.flash_fwd_causal_self(q, k, v, scale=scale))
    plain_ms = time_ms(lambda: flash.flash_fwd_causal_self_plain(
        q, k, v, scale=scale), iters=3, warmup=1)
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    kr, vr = (t.repeat_interleave(h // hk, dim=1) for t in (kh, vh))
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qh, kr, vr, is_causal=True))
    flops = 2 * b * h * s * s * d
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel()) + 4 * b * h * s
    return row(K["flash_fwd_causal_self"], "flash_fwd.cu", checks, ms,
               plain_ms, flops, nbytes, lib_ms)


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
    return row(K["flash_fwd_pos"], "flash_fwd.cu", checks, ms, plain_ms,
               flops, nbytes, lib_ms)


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
    return row(K["cache_append"], "cache_append.cu", [(0.0, 0.0)], ms,
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
    checks, times = [], {}
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
    # int8 ops: q.k and p.v, 2 each per (head, column, feature)
    return row(K["decode_attention"], "decode_attention.cu", checks,
               times["ms"], times["plain_ms"], 4 * h * int(lens.sum()) * d,
               nbytes_int8, times["lib"], PEAK_INT8_OPS)


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
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
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


def slice_phase(pkg, build, dev, card):
    from long_context_attention_tpu_torch.models.llama import (
        decode_step, init_params)
    from long_context_attention_tpu_torch.serving.engine import Engine

    cfg = pkg.ModelConfig(**MODEL)
    L = cfg.n_layers
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
        "flash_fwd_causal_self": L * (PROMPT // CHUNK),
        "flash_fwd_pos": L * (PROMPT // CHUNK - 1),
        "cache_append": L * NEW, "decode_attention": L * NEW})
    if not torch.isfinite(logits).all():
        raise AssertionError("prefill logits are not finite")
    if toks.shape != (BATCH, NEW) or cache.length.tolist() != [
            PROMPT + NEW] * BATCH:
        raise AssertionError(f"decode_scan shapes {tuple(toks.shape)}, "
                             f"lengths {cache.length.tolist()}")

    # teacher forcing: step 1 of decode vs a prefill of prompt + first; that
    # step runs under the profiler for the decode-step breakdown
    for f, t in fork.items():
        getattr(cache, f).copy_(t)
    torch.cuda.synchronize()
    step1, profile = profiled(lambda: decode_step(dparams, cache, first,
                                                  cfg)[0])
    emit({"phase": "decode_profile", **profile})
    del cache, fork
    tf_logits, _ = eng.prefill(params, torch.cat([prompt, first[:, None]],
                                                 dim=1))
    if not (torch.isfinite(step1).all() and torch.isfinite(tf_logits).all()):
        raise AssertionError("teacher-forcing logits are not finite")
    # breakdown of a two-chunk prefill (B1 on both chunks, B3 on the second)
    _, prefill_profile = profiled(lambda: eng.prefill_chunked(
        params, prompt[:, :2 * CHUNK], CHUNK)[0])
    emit({"phase": "prefill_profile", "tokens": BATCH * 2 * CHUNK,
          **prefill_profile})
    tf_err = float((step1 - tf_logits).abs().max())
    tf_argmax = float((step1.argmax(-1) == tf_logits.argmax(-1)).float()
                      .mean())
    check("teacher forcing", tf_err, TEACHER_TOL)
    emit({"phase": "slice", "card": card, "model": "llama-0.88B",
          "batch": BATCH,
          "prompt": PROMPT, "chunk": CHUNK, "new_tokens": NEW,
          "cache_dtype": "int8", "weight_dtype": "int8",
          "prefill_s": prefill_s,
          "prefill_tok_per_s": BATCH * PROMPT / prefill_s,
          "decode_ms_per_step": 1e3 * decode_s / NEW,
          "decode_tok_per_s": BATCH * NEW / decode_s,
          "teacher_forcing_max_abs_err": tf_err, "teacher_tol": TEACHER_TOL,
          "teacher_argmax_agree": tf_argmax, "launches": counts})

    gen_eng = Engine(cfg=cfg, s_max=GEN_PROMPT + GEN_NEW,
                     cache_dtype="bfloat16", weight_dtype="int8", device=dev)
    gprompt = prompt[:GEN_BATCH, :GEN_PROMPT]
    build.reset_launch_counts()
    t0 = time.perf_counter()
    res = gen_eng.generate(params, gprompt, GEN_NEW)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    gcounts = expect_counts(build, {
        "flash_fwd_causal_self": L, "flash_fwd_pos": 0,
        "cache_append": L * GEN_NEW, "decode_attention": L * GEN_NEW})
    if not torch.isfinite(res.prefill_logits).all() or res.tokens.shape != (
            GEN_BATCH, GEN_NEW):
        raise AssertionError("generate gave non-finite logits or bad shapes")
    emit({"phase": "generate", "card": card, "batch": GEN_BATCH,
          "prompt": GEN_PROMPT,
          "new_tokens": GEN_NEW, "cache_dtype": "bfloat16",
          "weight_dtype": "int8", "seconds": gen_s, "launches": gcounts})
    return counts


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    import long_context_attention_tpu_torch as pkg
    from long_context_attention_tpu_torch.ops import _build as build
    from long_context_attention_tpu_torch.ops import decode, flash

    dev = torch.device("cuda")
    smi = smi_line()
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})

    t0 = time.perf_counter()
    logs = build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "sources": sorted(logs)})
    for src, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {src}: {line.strip()}", file=sys.stderr)

    K = build.KERNELS
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rows = []
    for fn, mod in ((kernel_b1, flash), (kernel_b3, flash),
                    (kernel_b6, decode), (kernel_b7, decode)):
        r = fn(K, mod, gen, dev)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        emit({"phase": "kernel", **r})
        rows.append(r)

    counts = slice_phase(pkg, build, dev, smi)
    for r in rows:
        r["launches"] = counts[r["name"]]
    emit({"kernels": rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
