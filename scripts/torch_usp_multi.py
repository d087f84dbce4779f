#!/usr/bin/env python3
"""The dense USP layer, the async USP layer, the sequence-sharded serving
prefill and the DiT forward over several ranks: one per card with NCCL, or
gloo processes on the CPU.

    python3 scripts/torch_usp_multi.py            # 4 cards (NCCL)
    python3 scripts/torch_usp_multi.py --cpu      # 4 gloo processes, small

Every rank makes the same global q, k, v and dout from one seed, takes its
shard (the sequence in layout order, ``seq_shard``), and runs
``LongContextAttention`` forward and backward for each mesh of MESHES; the
output and the gradients are gathered, and rank 0 holds them against
one-device ``flash_attention(causal=True)`` on the whole sequence (out
within 2^-5 of each row's size, out and gradients within 0.1, the bf16
gate), each rank's kernel launches against the ring's (one B3, B2a and
B2b per ring step). On the cards it then times the layer's forward and
backward (CUDA events, a barrier before each window) beside the
one-device call. Then, on the same ranks:

* ``AsyncLongContextAttention`` (default head groups) against
  ``LongContextAttention`` on the same mesh, at ulysses 2 x ring 2 and
  ulysses 4: out and gradients bit for bit (each differing tensor held to
  the row and bf16 gates instead, and reported), both timed;
* ``Engine(mesh=..., cache_dtype="int8")`` (the 0.88B config, zigzag) at
  ulysses 2 x ring 2 and ring 4 against one device's ``Engine.prefill``
  of the same prompt (1 x 32768 on the cards): the last token's logits
  and the cache's dequantized prompt rows within 0.5 (the teacher-forcing
  gate), both timed;
* the DiT forward at Wan2.1-1.3B's widths (30 layers, 32760 tokens on the
  cards) at ulysses 4 (3 heads a rank) and ring 4, timed beside one
  device's, and its 2-layer model against one device's within 0.1;
* ``ShardedEngine`` (the 0.88B config, int8 cache, s_max 131072: each card
  holds a quarter of the cache) at ring 4 (zigzag), ulysses 4 and ulysses
  2 x ring 2 on a 65536-token prompt with 64 new tokens, against one
  card's ``Engine``: greedy tokens equal, or where a near tie parts them
  the sharded tokens teacher-forced through one card's cache within 0.5
  of the largest logit; each card's cache bytes and decode ms per step
  beside one card's;
* ``ShardedContinuousEngine``, ``ShardedPagedContinuousEngine`` and
  ``ShardedSpeculativeContinuousEngine`` (self-draft) at ulysses 2 x ring
  2 on 8 requests of 8K-32K tokens, against the one-card engines by the
  same gate.

Prints one JSON line per case, the card and its power limit, and exits
non-zero when a check fails.
"""

import argparse
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

WORLD = 4
SEED = 0
ROW_REL_TOL = 2.0 ** -5
ATOL = 1e-1
# (name, ulysses, ring, layout, bidirectional)
MESHES = (("ring 4 zigzag", 1, 4, "zigzag", False),
          ("ring 4 stripe", 1, 4, "stripe", False),
          ("ring 4 basic bidirectional", 1, 4, "basic", True),
          ("ulysses 2 x ring 2 zigzag", 2, 2, "zigzag", False),
          ("ulysses 4", 4, 1, "basic", False))
RING_KERNELS = ("flash_fwd_pos", "flash_bwd_dq", "flash_bwd_dkv")
TEACHER_TOL = 0.5
# (name, ulysses, ring) of the async layer, the mesh engine and the DiT
ASYNC_MESHES = (("ulysses 2 x ring 2", 2, 2), ("ulysses 4", 4, 1))
ENGINE_MESHES = (("ulysses 2 x ring 2", 2, 2), ("ring 4", 1, 4))
DIT_MESHES = (("ulysses 4", 4, 1), ("ring 4", 1, 4))
# the models: the 0.88B llama of bench.py and Wan2.1-T2V-1.3B's DiT widths
# on the cards (chip_smoke.py MODEL, WAN_DIT), tiny ones on the CPU
LLAMA = {False: dict(vocab=32000, dim=2048, n_layers=16, n_heads=16,
                     n_kv_heads=8, head_dim=128, ffn_hidden=int(2048 * 2.7),
                     layout="zigzag"),
         True: dict(vocab=64, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
                    head_dim=32, ffn_hidden=128, layout="zigzag")}
PROMPT = {False: (1, 32768), True: (2, 64)}
DIT = {False: dict(in_dim=64, dim=1536, n_layers=30, n_heads=12,
                   head_dim=128, ffn_hidden=8960),
       True: dict(in_dim=8, dim=64, n_layers=2, n_heads=4, head_dim=16,
                  ffn_hidden=128)}
DIT_TOKENS = {False: 21 * 30 * 52, True: 256}
# the sharded engines: (name, ulysses, ring, layout), cache slots, the
# generate prompt and new tokens, the continuous engines' request prompts
SHARDED_MESHES = (("ring 4", 1, 4, "zigzag"), ("ulysses 4", 4, 1, "basic"),
                  ("ulysses 2 x ring 2", 2, 2, "zigzag"))
SHARDED_S_MAX = {False: 131072, True: 512}
SHARDED_GEN = {False: (65536, 64), True: (128, 8)}
CONT_S_MAX = {False: 65536, True: 512}
CONT_PROMPTS = {False: (8192, 32768), True: (40, 200)}
CONT_REQS, CONT_NEW = 8, {False: 32, True: 6}


def _row_rel(got, want):
    diff = (got.float() - want.float()).abs().amax(-1)
    size = want.float().abs().amax(-1)
    return float(torch.where(size > 0, diff / size.clamp_min(1e-30),
                             (diff > 0).float() * float("inf")).max())


def _time_ms(fn, iters):
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    dist.barrier()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def _wall(fn, cpu, barrier=True):
    """(result, seconds) of fn, the card synchronized before and after;
    with ``barrier`` every rank starts it together (all ranks must call)."""
    if not cpu:
        torch.cuda.synchronize()
    if barrier:
        dist.barrier()
    t0 = time.perf_counter()
    res = fn()
    if not cpu:
        torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def _async_cases(device, cpu, q, k, v, dout):
    """The async layer against the dense one on each of ASYNC_MESHES."""
    from long_context_attention_tpu_torch.parallel import (
        AsyncLongContextAttention, LongContextAttention, make_usp_mesh,
        seq_shard)

    rows, ok = [], True
    for name, uly, ring in ASYNC_MESHES:
        mesh = make_usp_mesh(ulysses=uly, ring=ring, device=device)
        shards = [seq_shard(mesh, t) for t in (q, k, v, dout)]
        leaves = [t.clone().requires_grad_() for t in shards[:3]]
        layers = {"dense": LongContextAttention(mesh),
                  "async": AsyncLongContextAttention(mesh)}

        def run(layer):
            out = layer(*leaves, causal=True)
            return (out.detach(), *torch.autograd.grad(out, leaves,
                                                       shards[3]))

        want, got = run(layers["dense"]), run(layers["async"])
        row = {"case": "async vs dense layer", "mesh": name,
               "n_groups": k.shape[2] // uly, "bit_equal": {}}
        for g, a, w in zip(("out", "dq", "dk", "dv"), got, want):
            row["bit_equal"][g] = bool(torch.equal(a, w))
            if not row["bit_equal"][g]:
                err = float((a.float() - w.float()).abs().max())
                row["bit_equal"][f"{g}_max_abs_err"] = err
                ok = ok and err <= ATOL and (
                    g != "out" or _row_rel(a, w) <= ROW_REL_TOL)
        if not cpu:
            for tag, layer in list(layers.items()) * 2:  # in turns
                row.setdefault(f"{tag}_fwd_bwd_ms", []).append(_time_ms(
                    lambda: torch.autograd.grad(layer(*leaves, causal=True),
                                                leaves, shards[3]), 5))
        rows.append(row)
        del want, got, leaves, shards
    return rows, ok


def _dequantized(cache, name, n):
    vals = getattr(cache, name)[:, :, :, :n].float()
    scale = getattr(cache, f"{name}_scale")
    return vals if scale is None else vals * scale[:, :, :, 0, :n, None]


def _engine_cases(rank, device, cpu):
    """Engine(mesh=...) on each of ENGINE_MESHES against one device's
    Engine.prefill (rank 0) of the same weights and prompt."""
    from long_context_attention_tpu_torch.models.llama import (
        ModelConfig, init_params)
    from long_context_attention_tpu_torch.parallel import make_usp_mesh
    from long_context_attention_tpu_torch.serving.engine import Engine

    cfg = ModelConfig(**LLAMA[cpu])
    b, s = PROMPT[cpu]
    gen = torch.Generator(device=device).manual_seed(SEED + 3)
    params = init_params(gen, cfg, device=device)
    prompt = torch.randint(0, cfg.vocab, (b, s), generator=gen,
                           device=device)
    kw = dict(cfg=cfg, s_max=s + 64, cache_dtype="int8")
    want = one_s = None
    if rank == 0:
        one = Engine(**kw, device=device)
        one.prefill(params, prompt[:, :s // 8])  # warm-up
        (logits, cache), one_s = _wall(lambda: one.prefill(params, prompt),
                                       cpu, barrier=False)
        want = (logits, _dequantized(cache, "k", s),
                _dequantized(cache, "v", s))
        del cache
    rows, ok = [], True
    for name, uly, ring in ENGINE_MESHES:
        mesh = make_usp_mesh(ulysses=uly, ring=ring, device=device)
        eng = Engine(**kw, mesh=mesh)
        eng.prefill(params, prompt[:, :s // 8])  # warm-up
        (logits, cache), mesh_s = _wall(lambda: eng.prefill(params, prompt),
                                        cpu)
        row = {"case": "Engine(mesh=...).prefill vs one device",
               "mesh": name, "batch": b, "prompt": s,
               "cache_dtype": "int8", "mesh_prefill_s": mesh_s,
               "one_device_prefill_s": one_s}
        if rank == 0:
            got = (logits, _dequantized(cache, "k", s),
                   _dequantized(cache, "v", s))
            row["max_abs_err"] = {
                g: float((a - w).abs().max())
                for g, a, w in zip(("logits", "k", "v"), got, want)}
            ok = ok and bool(torch.isfinite(logits).all()) and all(
                e <= TEACHER_TOL for e in row["max_abs_err"].values())
            del got
        rows.append(row)
        del cache, logits
    return rows, ok


def _dit_cases(rank, device, cpu):
    """The DiT forward on each of DIT_MESHES against one device's (rank 0):
    the whole model timed, its 2-layer cut held within ATOL."""
    import dataclasses

    from long_context_attention_tpu_torch.models.dit import (
        DiTConfig, init_dit_params, make_dit_forward)
    from long_context_attention_tpu_torch.parallel import (
        make_usp_mesh, seq_shard, seq_unshard)

    cfg = DiTConfig(**DIT[cpu])
    n = DIT_TOKENS[cpu]
    gen = torch.Generator(device=device).manual_seed(SEED + 4)
    models = {}
    for tag, c in (("full", cfg), ("2 layers",
                                   dataclasses.replace(cfg, n_layers=2))):
        p = init_dit_params(gen, c, device=device)
        for node, key in ((p["layers"], "mod"), (p, "out")):
            node[key] = (torch.randn(node[key].shape, generator=gen,
                                     device=device)
                         / c.dim ** 0.5).to(c.dtype)
        models[tag] = (c, p)
    x = torch.randn((1, n, cfg.in_dim), generator=gen, device=device)
    t = torch.randint(0, 1000, (1,), generator=gen, device=device)
    want = one_s = None
    if rank == 0:
        fwd = make_dit_forward(cfg, device=device)
        fwd(models["full"][1], x[:, :n // 8], t)  # warm-up
        _, one_s = _wall(lambda: fwd(models["full"][1], x, t), cpu,
                         barrier=False)
        c2, p2 = models["2 layers"]
        want = make_dit_forward(c2, device=device)(p2, x, t)
    rows, ok = [], True
    for name, uly, ring in DIT_MESHES:
        mesh = make_usp_mesh(ulysses=uly, ring=ring, device=device)
        xs = seq_shard(mesh, x)
        fwd = make_dit_forward(cfg, mesh)
        fwd(models["full"][1], xs[:, :xs.shape[1] // 8], t)  # warm-up
        out, mesh_s = _wall(lambda: fwd(models["full"][1], xs, t), cpu)
        c2, p2 = models["2 layers"]
        got = seq_unshard(mesh, make_dit_forward(c2, mesh)(p2, xs, t))
        row = {"case": "DiT forward vs one device", "mesh": name,
               "tokens": n, "layers": cfg.n_layers, "heads": cfg.n_heads,
               "mesh_forward_s": mesh_s, "one_device_forward_s": one_s,
               "finite": bool(torch.isfinite(out).all())}
        ok = ok and row["finite"]
        if rank == 0:
            row["two_layer_max_abs_err"] = float((got - want).abs().max())
            ok = ok and row["two_layer_max_abs_err"] <= ATOL
        rows.append(row)
        del out, got
    return rows, ok


def _cache_bytes(cache):
    return sum(t.numel() * t.element_size() for t in (
        cache.k, cache.v, cache.k_scale, cache.v_scale) if t is not None)


def _teacher_gap(one, params, prompt, tokens):
    """Largest gap between one card's greedy logit and its logit of the
    sharded run's token, over the sharded tokens teacher-forced through one
    card's int8 cache (prefill, then one multi-token step)."""
    from long_context_attention_tpu_torch.models.llama import (
        decode_multi_step)

    logits, cache = one.prefill(params, prompt)
    seq = torch.tensor([tokens[:-1]], device=prompt.device)
    steps, _ = decode_multi_step(params, cache, seq, one.cfg)
    lg = torch.cat([logits[:, None], steps], dim=1)[0].float()
    idx = torch.tensor(tokens, device=lg.device)
    return float((lg.max(-1).values - lg[torch.arange(len(tokens)),
                                         idx]).max())


def _sharded_cases(rank, device, cpu):
    """ShardedEngine on each of SHARDED_MESHES and the sharded continuous
    engines at ulysses 2 x ring 2, against one card's engines (rank 0)."""
    from long_context_attention_tpu_torch import serving
    from long_context_attention_tpu_torch.models.llama import (
        ModelConfig, init_params)
    from long_context_attention_tpu_torch.parallel import make_usp_mesh

    base = {k: v for k, v in LLAMA[cpu].items() if k != "layout"}
    if cpu:  # kv heads for ulysses 4
        base.update(n_heads=8, n_kv_heads=4)
    s_max = SHARDED_S_MAX[cpu]
    s, new = SHARDED_GEN[cpu]
    gen = torch.Generator(device=device).manual_seed(SEED + 5)
    params = init_params(gen, ModelConfig(**base), device=device)
    prompt = torch.randint(0, base["vocab"], (1, s), generator=gen,
                           device=device)
    rows, ok = [], True
    one = want = None
    one_row = {}
    if rank == 0:  # one card (no collective here: the others wait)
        one = serving.Engine(ModelConfig(**base), s_max, "int8",
                             device=device)
        one.prefill(params, prompt[:, :s // 8])  # warm-up
        res, one_row["one_device_generate_s"] = _wall(
            lambda: one.generate(params, prompt, new), cpu, barrier=False)
        want = res.tokens[0].tolist()
        one_row["one_device_cache_bytes"] = _cache_bytes(res.cache)
        logits, cache = one.prefill(params, prompt)
        first = torch.argmax(logits, -1).to(torch.int32)
        _, one_s = _wall(lambda: one.decode_scan(params, cache, new, first),
                         cpu, barrier=False)
        one_row["one_device_decode_ms_per_step"] = 1e3 * one_s / new
        del res, cache
    for name, uly, ring, layout in SHARDED_MESHES:
        mesh = make_usp_mesh(ulysses=uly, ring=ring, device=device)
        eng = serving.ShardedEngine(ModelConfig(**base, layout=layout), mesh,
                                    s_max, "int8")
        eng.prefill(params, prompt[:, :s // 8])  # warm-up
        (logits, cache), prefill_s = _wall(lambda: eng.prefill(params,
                                                               prompt), cpu)
        first = torch.argmax(logits, -1).to(torch.int32)
        (toks, cache), decode_s = _wall(
            lambda: eng._decode_scan(params, cache, new, first), cpu)
        row = {"case": "ShardedEngine vs one card", "mesh": name,
               "layout": layout, "prompt": s, "new_tokens": new,
               "s_max": s_max, "cache_dtype": "int8",
               "prefill_s": prefill_s,
               "decode_ms_per_step": 1e3 * decode_s / new,
               "cache_bytes_per_card": _cache_bytes(cache),
               "cache_slots_per_card": cache.k.shape[3], **one_row}
        if rank == 0:
            got = toks[0].tolist()
            row["tokens_equal"] = got == want
            row["cache_bytes_vs_one_card"] = (
                row["cache_bytes_per_card"]
                / one_row["one_device_cache_bytes"])
            if got != want:
                row["first_divergence"] = next(
                    i for i, (a, b) in enumerate(zip(got, want)) if a != b)
                row["teacher_gap"] = _teacher_gap(one, params, prompt, got)
                ok = ok and row["teacher_gap"] <= TEACHER_TOL
        rows.append(row)
        del cache, logits, toks
        if not cpu:
            torch.cuda.empty_cache()
    del one
    rows += _sharded_continuous(rank, device, cpu, base, params)[0]
    return rows, ok and all(r.get("ok", True) for r in rows)


def _sharded_continuous(rank, device, cpu, base, params):
    """The sharded continuous engines at ulysses 2 x ring 2 (zigzag) on
    CONT_REQS requests against the one-card engines (rank 0)."""
    import numpy as np

    from long_context_attention_tpu_torch import serving
    from long_context_attention_tpu_torch.models.llama import ModelConfig
    from long_context_attention_tpu_torch.parallel import make_usp_mesh

    cfg = ModelConfig(**base, layout="zigzag")
    rng = np.random.default_rng(SEED + 6)
    reqs = [serving.Request(id=i, tokens=[int(t) for t in rng.integers(
        0, cfg.vocab, int(rng.integers(*CONT_PROMPTS[cpu])))],
        max_new=CONT_NEW[cpu]) for i in range(CONT_REQS)]
    s_max, page = CONT_S_MAX[cpu], 2048 if not cpu else 128
    common = dict(s_max=s_max, max_batch=8, cache_dtype="int8")
    paged = dict(page_size=page, pool_pages=4 * (2 * (s_max // page) + 1))
    one_paged = dict(page_size=page, pool_pages=8 * (s_max // page) + 1)
    spec = dict(draft_cfg=cfg, gamma=4)
    cases = (("ShardedContinuousEngine", serving.ShardedContinuousEngine,
              serving.ContinuousEngine, {}, {}, False),
             ("ShardedPagedContinuousEngine",
              serving.ShardedPagedContinuousEngine,
              serving.PagedContinuousEngine, paged, one_paged, False),
             ("ShardedSpeculativeContinuousEngine",
              serving.ShardedSpeculativeContinuousEngine,
              serving.SpeculativeContinuousEngine, spec, spec, True))
    mesh = make_usp_mesh(ulysses=2, ring=2, device=device)
    rows = []
    for name, sh, one_cls, kw, one_kw, draft in cases:
        args = (params, params) if draft else (params,)
        want = one_s = None
        if rank == 0:
            want, one_s = _wall(lambda: one_cls(
                cfg, **common, **one_kw, device=device).serve(*args, reqs),
                cpu, barrier=False)
        got, sh_s = _wall(lambda: sh(cfg, **common, **kw, mesh=mesh).serve(
            *args, reqs), cpu)
        row = {"case": f"{name} vs one card", "mesh": "ulysses 2 x ring 2",
               "requests": CONT_REQS, "prompts": [len(r.tokens)
                                                   for r in reqs],
               "max_new": CONT_NEW[cpu], "sharded_s": sh_s,
               "one_device_s": one_s}
        if rank == 0:
            parted = [r.id for r in reqs if got[r.id].tokens
                      != want[r.id].tokens]
            row["parted"] = parted
            row["ok"] = all(len(got[r.id].tokens) == r.max_new
                            for r in reqs)
            if parted:
                one = serving.Engine(cfg, s_max, "int8", device=device)
                row["teacher_gap"] = max(_teacher_gap(
                    one, params, torch.tensor([reqs[i].tokens],
                                              device=device),
                    got[i].tokens) for i in parted)
                row["ok"] = row["ok"] and row["teacher_gap"] <= TEACHER_TOL
        rows.append(row)
        if not cpu:
            torch.cuda.empty_cache()
    return rows, True


def _worker(rank, port, cpu, shape, out_path):
    from long_context_attention_tpu_torch.ops import _build
    from long_context_attention_tpu_torch.ops.flash import flash_attention
    from long_context_attention_tpu_torch.parallel import (
        LongContextAttention, make_usp_mesh, permute_for_layout, seq_shard,
        seq_unshard, unpermute_from_layout)

    torch.set_num_threads(1)
    if not cpu:
        torch.cuda.set_device(rank)
    dist.init_process_group("gloo" if cpu else "nccl",
                            init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=WORLD)
    device = "cpu" if cpu else "cuda"
    b, s, h, hk, d = shape
    gen = torch.Generator(device=device).manual_seed(SEED)
    q, k, v, dout = (torch.randn(sh, generator=gen, device=device).bfloat16()
                     for sh in ((b, s, h, d), (b, s, hk, d), (b, s, hk, d),
                                (b, s, h, d)))
    want = None
    one_ms = None
    if rank == 0:
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        ref = flash_attention(*leaves, causal=True)
        want = (ref.detach(), *torch.autograd.grad(ref, leaves, dout))
        if not cpu:
            def one():
                torch.autograd.grad(flash_attention(*leaves, causal=True),
                                    leaves, dout)
            one_ms = _time_ms(one, 3)
    else:
        if not cpu:
            dist.barrier()  # rank 0's timing window
    results, ok = [], True
    for name, uly, ring, layout, bidir in MESHES:
        mesh = make_usp_mesh(ulysses=uly, ring=ring, device=device)
        layer = LongContextAttention(mesh, layout=layout,
                                     bidirectional=bidir)
        shards = [seq_shard(mesh, permute_for_layout(t, layout, ring))
                  for t in (q, k, v, dout)]
        leaves = [t.clone().requires_grad_() for t in shards[:3]]
        _build.reset_launch_counts()
        out = layer(*leaves, causal=True)
        grads = torch.autograd.grad(out, leaves, shards[3])
        if not cpu:
            torch.cuda.synchronize()
        counts = _build.launch_counts()
        want_counts = {n: (0 if cpu else ring) for n in RING_KERNELS}
        got = [unpermute_from_layout(seq_unshard(mesh, t.detach()), layout,
                                     ring) for t in (out, *grads)]
        row = {"mesh": name, "ulysses": uly, "ring": ring, "layout": layout,
               "bidirectional": bidir,
               "launches_rank0": {n: counts[n] for n in RING_KERNELS}}
        if any(counts[n] != c for n, c in want_counts.items()) or any(
                c for n, c in counts.items() if n not in RING_KERNELS):
            ok = False
            row["launch_error"] = counts
        if rank == 0:
            row["out_row_rel"] = _row_rel(got[0], want[0])
            row["max_abs_err"] = {
                g: float((a.float() - w.float()).abs().max())
                for g, a, w in zip(("out", "dq", "dk", "dv"), got, want)}
            ok = ok and row["out_row_rel"] <= ROW_REL_TOL and all(
                e <= ATOL for e in row["max_abs_err"].values())
        if not cpu:
            def call():
                torch.autograd.grad(layer(*leaves, causal=True), leaves,
                                    shards[3])
            row["layer_fwd_bwd_ms"] = _time_ms(call, 5)
            row["one_device_fwd_bwd_ms"] = one_ms
        results.append(row)
        del out, grads, got, leaves, shards
    for cases in (lambda: _async_cases(device, cpu, q, k, v, dout),
                  lambda: _engine_cases(rank, device, cpu),
                  lambda: _dit_cases(rank, device, cpu),
                  lambda: _sharded_cases(rank, device, cpu)):
        rows, case_ok = cases()
        results += rows
        ok = ok and case_ok
        if not cpu:
            torch.cuda.empty_cache()
    flag = torch.tensor([int(ok)], device=device)
    dist.all_reduce(flag, op=dist.ReduceOp.MIN)
    if rank == 0:
        Path(out_path).write_text(json.dumps(
            {"ok": bool(flag.item()), "results": results}))
    dist.barrier()
    dist.destroy_process_group()


def _free_port():
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--cpu", action="store_true",
                        help="gloo processes on the CPU at a small size")
    args = parser.parse_args()
    if not args.cpu and torch.cuda.device_count() < WORLD:
        print(f"needs {WORLD} cards, found {torch.cuda.device_count()}",
              file=sys.stderr)
        return 1
    # b, s, h, h_kv, d: the 0.88B attention width at s = 32768 on cards;
    # on the CPU h_kv 4 for the async layer's groups at ulysses 4
    shape = (1, 512, 8, 4, 32) if args.cpu else (1, 32768, 16, 8, 128)
    out_path = ROOT / "build" / f"usp_multi_{os.getpid()}.json"
    out_path.parent.mkdir(exist_ok=True)
    t0 = time.perf_counter()
    if not args.cpu:  # once, before the ranks load the libraries
        from long_context_attention_tpu_torch.ops import _build
        _build.build_all()
    mp.start_processes(_worker, args=(_free_port(), args.cpu, shape,
                                      str(out_path)),
                       nprocs=WORLD, join=True, start_method="spawn")
    res = json.loads(out_path.read_text())
    out_path.unlink()
    for row in res["results"]:
        print(json.dumps({"shape": shape, **row}))
    if not args.cpu:
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip())
    print(json.dumps({"ok": res["ok"], "seconds": time.perf_counter() - t0,
                      "device": "cpu" if args.cpu else
                      torch.cuda.get_device_name(0)}))
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
