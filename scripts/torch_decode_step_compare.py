#!/usr/bin/env python3
"""One decode step of the 0.88B Llama in this tree against another
checkout's, on one NVIDIA GPU: kernel launches, device ms and host wall
of a profiled step, and ms per step of unprofiled steps, per cache dtype.

    python3 scripts/torch_decode_step_compare.py --other DIR [--json PATH]

DIR is the root of another checkout of this repository, such as the parent
commit unpacked by ``git archive`` into a directory that ``.gitignore``
lists. Each tree runs in its own process (the two packages share a name),
in turns: other, this, this, other. A process builds the kernels the step
runs (B6 and B7, into its tree's ``build/kernels/``), makes the config's
random weights from seed 0 with int8 decode weights, as
``Engine(weight_dtype="int8")`` decodes, and for each cache dtype a cache
of b = 4 rows of 12288 slots (``chip_smoke.py``'s slice) holding random
values at length 8192 (each step appends a token), then: three warm-up
steps; two steps under torch.profiler, the second kept (its CUDA
kernels, their device ms and the step's wall ms, which the profiler
inflates); B6's launches in one step by its counter; and 20 unprofiled
steps after a sync, ms per step (host-bound: the host's enqueue sets the
pace). The step is ``decode_step`` with every row active.

Prints one JSON line per (turn, cache dtype), then a summary line with
each tree's mean over its two turns, then the card's name and power limit;
with ``--json`` also writes every line to PATH.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

MODEL = dict(vocab=32000, dim=2048, n_layers=16, n_heads=16, n_kv_heads=8,
             head_dim=128, ffn_hidden=int(2048 * 2.7), layout="basic")
BATCH, S_MAX, LENGTH = 4, 12288, 8192
DTYPES = ("int8", "bfloat16", "float8_e4m3fn", "int4")
STEPS = 20


def worker(root: Path) -> None:
    """Measure the step in the checkout at ``root``; one JSON line per
    cache dtype on stdout."""
    sys.path.insert(0, str(root))
    import torch
    from torch.profiler import ProfilerActivity, profile

    import long_context_attention_tpu_torch as pkg
    from long_context_attention_tpu_torch.models.llama import (
        decode_step, init_params)
    from long_context_attention_tpu_torch.ops import _build
    from long_context_attention_tpu_torch.ops.kv_cache import KVCache
    from long_context_attention_tpu_torch.ops.wquant import (
        quantize_decode_params)

    if not Path(pkg.__file__).resolve().is_relative_to(root.resolve()):
        raise RuntimeError(f"imported {pkg.__file__}, not {root}'s package")
    _build.build_all(["cache_append.cu", "decode_attention.cu"])
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    cfg = pkg.ModelConfig(**MODEL)
    params = quantize_decode_params(init_params(gen, cfg, device=dev))
    tok = torch.randint(0, cfg.vocab, (BATCH,), generator=gen, device=dev)
    for dtype in DTYPES:
        cache = KVCache.init(cfg.n_layers, BATCH, S_MAX, cfg.n_kv_heads,
                             cfg.head_dim, dtype, device=dev)
        for t in (cache.k, cache.v):
            if dtype == "bfloat16":
                t.copy_(torch.randn(t.shape, generator=gen, device=dev))
            else:
                t.view(torch.uint8).copy_(torch.randint(
                    0, 256, t.view(torch.uint8).shape, generator=gen,
                    device=dev, dtype=torch.uint8))
        for t in (cache.k_scale, cache.v_scale):
            if t is not None:
                t.copy_(torch.rand(t.shape, generator=gen, device=dev) / 64)
        # every step appends one token: the length goes from 8192 to 8218
        cache.length.fill_(LENGTH)

        def step():
            return decode_step(params, cache, tok, cfg)[0]

        for _ in range(3):
            step()
        torch.cuda.synchronize()
        for _ in range(2):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                step()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        _build.reset_launch_counts()
        step()
        b6 = _build.launch_counts()["cache_append"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(STEPS):
            step()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / STEPS
        print(json.dumps({
            "root": str(root), "cache_dtype": dtype,
            "kernel_launches": len(kernels),
            "device_ms": sum(getattr(e, "device_time", 0.0)
                             for e in kernels) / 1e3,
            "profiled_wall_ms": wall * 1e3, "b6_launches": b6,
            "ms_per_step": ms}), flush=True)
        del cache
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path, help="the other checkout's root")
    ap.add_argument("--json", type=Path, help="also write the lines here")
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker is not None:
        worker(args.worker)
        return 0
    if args.other is None:
        ap.error("--other is required")
    import torch

    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    this = Path(__file__).resolve().parents[1]
    trees = {"other": args.other.resolve(), "this": this}
    lines, by = [], {}
    for turn, name in enumerate(("other", "this", "this", "other")):
        res = subprocess.run([sys.executable, __file__, "--worker",
                              str(trees[name])], capture_output=True,
                             text=True, cwd=trees[name])
        if res.returncode != 0:
            print(res.stderr[-4000:], file=sys.stderr)
            return 1
        for line in res.stdout.splitlines():
            if not line.startswith("{"):
                continue
            d = {"turn": turn, "tree": name, **json.loads(line)}
            lines.append(d)
            by.setdefault((name, d["cache_dtype"]), []).append(d)
            print(json.dumps(d), flush=True)
    keys = ("kernel_launches", "device_ms", "profiled_wall_ms",
            "b6_launches", "ms_per_step")
    summary = {"summary": {
        dt: {name: {k: sum(d[k] for d in by[(name, dt)]) / len(
            by[(name, dt)]) for k in keys} for name in trees}
        for dt in DTYPES}}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    summary["card"] = smi
    lines.append(summary)
    print(json.dumps(summary), flush=True)
    print(smi, flush=True)
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text("".join(json.dumps(d) + "\n" for d in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
