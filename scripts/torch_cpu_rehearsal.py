#!/usr/bin/env python3
"""Rehearse ``chip_smoke.py`` serving phases on the CPU at a tiny config.

    python3 scripts/torch_cpu_rehearsal.py serve_windowed_paged --runs 20
    python3 scripts/torch_cpu_rehearsal.py sharded_emulated serve_sharded
    python3 scripts/torch_cpu_rehearsal.py kernel_hd64 slice_hd64 \
        serve_paged_hd64
    python3 scripts/torch_cpu_rehearsal.py train_hd64 grad_check_hd64 \
        train_usp_hd64 usp_varlen_hd64

Each phase runs its own functions with the kernels' plain versions: a tiny
model (vocab 256, dim 64, 2 layers, 4/2 heads of 32; 2/1 heads for
``serve_windowed_paged``, as its first rehearsals ran), the CUDA syncs,
timers, memory statistics and SDPA yardsticks stubbed, and the
launch-count gates off (the plain versions count no launch). The sharded
phases also shrink their caches (blocks of 4096 slots, window 100 and 4
sinks, pages of 128), keeping the ranks' kv tiles the unsharded call's as
the card's shapes do. The head-dim-64 phases (``kernel_hd64``,
``slice_hd64``, ``serve_paged_hd64``) take a tiny d = 64 model (vocab 256,
dim 64, 2 layers, 8/1 heads of 64) in place of TinyLlama's widths, prompts
of a few hundred tokens, pages of 128, the profiler stubbed and B7's plain
version counting the launch its route names; the training ones
(``train_hd64``, ``grad_check_hd64``, ``train_usp_hd64``,
``usp_varlen_hd64``, and ``kernel_hd64``'s training kernels) sequences of
512 (ring shards too; the varlen layer's 1024, the gradient check's 128),
documents of 40-200 tokens and a window of 100 with 4 sinks, on a one-rank
gloo mesh. Every other gate of a phase runs. A check of the Python, not of
the kernels: prints one JSON line per run with its gates' result and
seconds, and exits non-zero when a run fails.
"""

import argparse
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

TINY = dict(vocab=256, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
            head_dim=32, ffn_hidden=128, layout="basic")
TINY_HD64 = dict(TINY, n_heads=8, n_kv_heads=1, head_dim=64)


def _stub(cs):
    torch.cuda.synchronize = lambda *a, **k: None
    torch.cuda.empty_cache = lambda *a, **k: None
    cs.time_ms = lambda fn, iters=10, warmup=2: (fn(), 0.0)[1]
    cs.expect_counts = lambda build, want: dict(build.launch_counts())
    cs.emit = lambda obj: None
    cs.sdpa_backward_ms = lambda *a, **k: 0.0
    cs.sdpa_masked_ms = lambda *a, **k: (0.0, 0.0)
    torch.cuda.reset_peak_memory_stats = lambda *a, **k: None
    torch.cuda.max_memory_allocated = lambda *a, **k: 0


def _hd64_sizes(cs):
    """The head-dim-64 phases at a tiny model and sizes: prompts of 1024 in
    chunks of 256, pages of 128, short requests; the serving counts' gates
    off (the plain versions count no launch), the band and poison checks
    off (the plain versions read every tile) and the profiler stubbed."""
    cs.TINYLLAMA = TINY_HD64
    cs.BATCH, cs.PROMPT, cs.CHUNK, cs.NEW = 4, 1024, 256, 4
    cs.S_MAX, cs.GEN_PROMPT, cs.GEN_NEW = 2048, 64, 4
    cs.PAGE, cs.PAGED_S_MAX, cs.POOL = 128, 512, 17
    cs.PAGED_LENS, cs.RUN_LENS, cs.RUN_PAGES = (512, 300, 129, 1), (400,
                                                                    200), 4
    cs.WINDOW, cs.B7_PAGED_LAYERS = 100, 2
    cs.WINDOWED = dict(window_left=100, sink_tokens=cs.SINKS)
    cs.HD_REQUESTS, cs.HD_PROMPTS, cs.HD_NEW, cs.HD_S_MAX = 3, (100, 200), \
        3, 512
    cs.STALL_CHUNK, cs.CONT_TF_SAMPLE = 64, 2
    cs.expect_serving_counts = lambda *a, **k: {}
    # B7's plain version counts the launch of the kernel its route names,
    # as the card's wrapper does (b7_run_case holds the sub-runs' count)
    from long_context_attention_tpu_torch.ops import _build, decode

    plain = decode.decode_attention_core

    def counted(q_in, *a, block_kv, **k):
        kern = decode.decode_route(q_in.shape[2], block_kv, a[1].shape[3])
        _build.kernel(kern, q_in.shape[-1]).launches += 1
        return plain(q_in, *a, block_kv=block_kv, **k)

    decode.decode_attention_core = counted
    # the band and poison checks hold a kernel that skips tiles: the plain
    # versions read every tile
    cs.band_check = lambda *a, **k: None
    cs.poison_check = lambda *a, **k: None
    cs.poison = lambda t, *a, **k: t
    cs.profiled = lambda fn: (fn(), {"wall_ms": 0.0, "device_ms": 0.0,
                                     "device_busy_share": 0.0,
                                     "kernel_launches": 0, "top": []})
    # training: short sequences, small documents, the masked backward's
    # cases at a window of 100 and band checks over blocks of 128
    cs.TRAIN_SEQ, cs.GRAD_SEQ, cs.RING_LOCAL, cs.DOC_LENS = 512, 128, 512, (
        40, 200)
    cs.SPARSE_SEQ, cs.VARLEN_SLICE = 1024, 128
    cs.VARLEN_ROWS, cs.VARLEN_COLS = (448, 896), (0, 448)
    win = dict(causal=True, window_size=(100, -1), sink_tokens=4)
    cs.BWD_MASKED = {
        "B5": (("window sinks", None, win),
               ("non-causal window (64, 32) sinks", None,
                dict(causal=False, window_size=(64, 32), sink_tokens=4)),
               ("window sinks softcap", None, dict(win, softcap=cs.SOFTCAP))),
        "B2a": (("offsets window sinks", 0, win),
                ("kv offset s/2 window sinks softcap", -256,
                 dict(win, softcap=cs.SOFTCAP)))}
    rows, cols = cs.rows_seeing_less, cs.cols_seen_by_few
    cs.rows_seeing_less = lambda vis, tile, n=2048: rows(vis, tile, 128)
    cs.cols_seen_by_few = lambda vis, tile, n=2048: cols(vis, tile, 128)
    import long_context_attention_tpu_torch.parallel as par

    if not getattr(par.make_usp_mesh, "on_cpu", False):
        real = par.make_usp_mesh
        par.make_usp_mesh = lambda *a, **k: real(device="cpu")
        par.make_usp_mesh.on_cpu = True


def _sharded_sizes(cs, par):
    """Blocks of 4096 slots (the tiles of a block and of the whole cache
    both 4096), window 100 with 4 sinks, pages of 128; the one-rank mesh
    on the CPU."""
    w = dict(window_left=100, sink_tokens=4)
    cs.WINDOWED, cs.WINDOW, cs.SINKS, cs.PAGE = w, 100, 4, 128
    s = cs.SHARD_SLOTS = 4096
    cs.SHARD_CASES = (
        ("one token in block 1", 1, (s + 900, s + 600, s + 3000, s + 1), {}),
        ("one token on block boundaries", 1, (s, 2 * s, 3 * s, 4 * s), {}),
        ("one token in block 0", 1, (3000, 100, s, 1), {}),
        ("window over blocks 1 and 2", 1,
         (2 * s + 30, 2 * s + 60, 2 * s + 100, 2 * s + 2), w),
        ("run of 5 over a boundary", 5,
         (2 * s + 2, 2 * s + 4, 3 * s + 2, s + 2), w),
        ("run of 40 over a boundary", 40,
         (2 * s + 26, 2 * s + 36, 3 * s + 36, s + 6), w))
    cs.SHARDED_PROMPT, cs.SHARDED_NEW = 512, 8
    cs.SHARDED_PROMPTS, cs.SHARDED_S_MAX, cs.SHARDED_REQ_NEW = (200, 400), \
        512, 6
    cs.CHUNK = 128
    if not getattr(par.make_usp_mesh, "on_cpu", False):
        real = par.make_usp_mesh
        par.make_usp_mesh = lambda *a, **k: real(device="cpu")
        par.make_usp_mesh.on_cpu = True


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("phases", nargs="+", choices=(
        "serve_windowed_paged", "sharded_emulated", "serve_sharded",
        "kernel_hd64", "slice_hd64", "serve_paged_hd64", "train_hd64",
        "grad_check_hd64", "train_usp_hd64", "usp_varlen_hd64"))
    parser.add_argument("--runs", type=int, default=1)
    parser.add_argument("--threads", type=int, default=2)
    args = parser.parse_args()
    torch.set_num_threads(args.threads)
    import chip_smoke as cs
    import long_context_attention_tpu_torch as pkg
    import long_context_attention_tpu_torch.parallel as par
    from long_context_attention_tpu_torch.ops import (
        _build, decode, flash, kv_cache)
    from long_context_attention_tpu_torch.parallel import ring
    from long_context_attention_tpu_torch.serving import sharded

    _stub(cs)
    dev = torch.device("cpu")
    phases = {
        "serve_windowed_paged": lambda: cs.serve_windowed_paged_phase(
            pkg, _build, decode, dev, "cpu"),
        "sharded_emulated": lambda: cs.sharded_emulated_phase(
            _build, decode, kv_cache, sharded,
            torch.Generator().manual_seed(0), dev, "cpu"),
        "serve_sharded": lambda: cs.serve_sharded_phase(
            pkg, _build, decode, dev, "cpu"),
        "kernel_hd64": lambda: (
            cs.kernel_hd64(_build.KERNELS, flash, decode, kv_cache,
                           torch.Generator().manual_seed(0), dev),
            cs.kernel_hd64_train(_build.KERNELS, flash, ring,
                                 torch.Generator().manual_seed(0), dev)),
        "slice_hd64": lambda: cs.slice_hd64_phase(pkg, _build, dev, "cpu"),
        "serve_paged_hd64": lambda: cs.serve_paged_hd64_phase(
            pkg, _build, decode, dev, "cpu"),
        "train_hd64": lambda: cs.train_phase(
            pkg, _build, dev, "cpu", plan=cs.HD_TRAIN_STEPS,
            model=cs.TINYLLAMA, tag="train_hd64"),
        "grad_check_hd64": lambda: cs.grad_check_phase(
            pkg, _build, dev, "cpu", model=cs.TINYLLAMA,
            tag="grad_check_hd64"),
        "train_usp_hd64": lambda: cs.train_usp_phase(
            pkg, _build, dev, "cpu", model=cs.TINYLLAMA,
            tag="train_usp_hd64"),
        "usp_varlen_hd64": lambda: cs.usp_varlen_phase(
            _build, flash, dev, "cpu", model=cs.TINYLLAMA,
            tag="usp_varlen_hd64")}
    failed = 0
    for name in args.phases:
        cs.MODEL = dict(TINY, **({"n_heads": 2, "n_kv_heads": 1}
                                 if name == "serve_windowed_paged" else {}))
        if name.endswith("hd64"):
            _hd64_sizes(cs)
        elif name != "serve_windowed_paged":
            _sharded_sizes(cs, par)
        for run in range(args.runs):
            t0 = time.perf_counter()
            try:
                phases[name]()
                ok, err = True, None
            except AssertionError as e:
                ok, err = False, str(e)[:500]
                failed += 1
            print(json.dumps({"phase": name, "run": run, "ok": ok,
                              "error": err,
                              "seconds": time.perf_counter() - t0}),
                  flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
