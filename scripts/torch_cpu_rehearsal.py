#!/usr/bin/env python3
"""Rehearse ``chip_smoke.py`` serving phases on the CPU at a tiny config.

    python3 scripts/torch_cpu_rehearsal.py serve_windowed_paged --runs 20
    python3 scripts/torch_cpu_rehearsal.py sharded_emulated serve_sharded

Each phase runs its own functions with the kernels' plain versions: a
tiny model (vocab 256, dim 64, 2 layers, 4/2 heads of 32; 2/1 heads for
``serve_windowed_paged``, as its first rehearsals ran), the CUDA syncs and
timers stubbed, and the launch-count gates off (the plain versions count
no launch). The sharded phases also shrink their caches (blocks of 4096
slots, window 100 and 4 sinks, pages of 128), keeping the ranks' kv tiles
the unsharded call's as the card's shapes do. Every other gate of a phase
runs. A check of the Python, not of the kernels: prints one JSON line per
run with its gates' result and seconds, and exits non-zero when a run
fails.
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


def _stub(cs):
    torch.cuda.synchronize = lambda *a, **k: None
    torch.cuda.empty_cache = lambda *a, **k: None
    cs.time_ms = lambda fn, iters=10, warmup=2: (fn(), 0.0)[1]
    cs.expect_counts = lambda build, want: dict(build.launch_counts())
    cs.emit = lambda obj: None


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
    real = par.make_usp_mesh
    par.make_usp_mesh = lambda *a, **k: real(device="cpu")


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("phases", nargs="+", choices=(
        "serve_windowed_paged", "sharded_emulated", "serve_sharded"))
    parser.add_argument("--runs", type=int, default=1)
    parser.add_argument("--threads", type=int, default=2)
    args = parser.parse_args()
    torch.set_num_threads(args.threads)
    import chip_smoke as cs
    import long_context_attention_tpu_torch as pkg
    import long_context_attention_tpu_torch.parallel as par
    from long_context_attention_tpu_torch.ops import _build, decode, kv_cache
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
            pkg, _build, decode, dev, "cpu")}
    failed = 0
    for name in args.phases:
        cs.MODEL = dict(TINY, **({"n_heads": 2, "n_kv_heads": 1}
                                 if name == "serve_windowed_paged" else {}))
        if name != "serve_windowed_paged":
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
