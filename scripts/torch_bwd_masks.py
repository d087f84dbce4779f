#!/usr/bin/env python3
"""The flash backward kernels B5, B2b and B2a under each mask, on one NVIDIA
GPU: what a window, the sinks and the softcap cost each kernel.

    python3 scripts/torch_bwd_masks.py [--json PATH]

At the trainer's per-layer attention shape (b=1, s=8192, 16/8 heads,
head_dim 128, bf16), on the forward's own out and lse, each kernel is timed
(CUDA events, 20 calls after 3) under: the dense causal mask; a left window
of 8192, which drops nothing but runs the band body (kBand in
``csrc/flash_bwd_sm90.cu``); windows of 4096 and 1024 with and without 4
sinks; a non-causal (512, 256) window with and without 4 sinks; the softcap
50 alone and with window 4096 and 4 sinks. B5 runs static self-attention,
B2b and B2a the same call at q_start 0. Prints one JSON line per mask (its
visible pairs per head, each kernel's ms and its bound: 10, 8 and 6 d
FLOPs per visible pair at 989 TFLOP/s), then the card's name and power
limit; with ``--json`` also writes the lines to PATH.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from long_context_attention_tpu_torch.ops import _build, flash  # noqa: E402

B, S, H, HKV, D = 1, 8192, 16, 8, 128
PEAK_BF16_FLOPS = 989e12
WIN = dict(causal=True, window_size=(4096, -1))
MASKS = {
    "dense causal": dict(causal=True),
    "window 8192 (drops nothing)": dict(causal=True, window_size=(8192, -1)),
    "window 4096": WIN,
    "window 4096 sinks 4": dict(WIN, sink_tokens=4),
    "window 1024": dict(causal=True, window_size=(1024, -1)),
    "window 1024 sinks 4": dict(causal=True, window_size=(1024, -1),
                                sink_tokens=4),
    "non-causal (512, 256)": dict(causal=False, window_size=(512, 256)),
    "non-causal (512, 256) sinks 4": dict(causal=False,
                                          window_size=(512, 256),
                                          sink_tokens=4),
    "softcap 50": dict(causal=True, softcap=50.0),
    "window 4096 sinks 4 softcap 50": dict(WIN, sink_tokens=4, softcap=50.0),
}
PRODUCTS = {"B5": 5, "B2b": 4, "B2a": 3}  # products of depth d per pair


def time_ms(fn, iters=20, warmup=3):
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


def visible_pairs(causal, window_size=(-1, -1), sink_tokens=0, **_):
    """(q row, kv column) pairs a head keeps (flash-attn masks)."""
    left, right = window_size
    if causal:
        right = 0
    rows = torch.arange(S, device="cuda")[:, None]
    cols = torch.arange(S, device="cuda")[None, :]
    vis = torch.ones((S, S), dtype=torch.bool, device="cuda")
    if right >= 0:
        vis &= cols <= rows + right
    if left >= 0:
        vis &= (cols >= rows - left) | (cols < sink_tokens)
    return int(vis.sum())


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--json", type=Path, help="also write the lines here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    _build.build_all(sorted({_build.KERNELS[n].source for n in (
        "flash_fwd_static", "flash_bwd_fused", "flash_bwd_dkv",
        "flash_bwd_dq")}))
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, dout = (torch.randn(shape, generator=gen, device="cuda")
                     .bfloat16() for shape in ((B, S, H, D), (B, S, HKV, D),
                                               (B, S, HKV, D), (B, S, H, D)))
    scale = D ** -0.5
    kernels = {"B5": flash.flash_bwd_fused, "B2b": flash.flash_bwd_dkv,
               "B2a": flash.flash_bwd_dq}
    lines = []
    for name, kw in MASKS.items():
        out, lse = flash.flash_fwd_static(q, k, v, scale=scale, **kw)
        delta = (dout.float() * out.float()).sum(-1).transpose(1, 2)
        ops = (q, k, v, dout, lse, delta.contiguous())
        pairs = visible_pairs(**kw)
        res = {"card": smi, "mask": name, "visible_pairs_per_head": pairs}
        for kn, fn in kernels.items():
            extra = {} if kn == "B5" else dict(q_start=0)
            res[f"{kn}_ms"] = time_ms(lambda: fn(*ops, scale=scale, **kw,
                                                 **extra))
            res[f"{kn}_bound_ms"] = (2 * PRODUCTS[kn] * D * B * H * pairs
                                     / PEAK_BF16_FLOPS * 1e3)
        lines.append(res)
        print(json.dumps(res), flush=True)
        del out, lse, delta, ops
    print(smi, flush=True)
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text("".join(json.dumps(x) + "\n" for x in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
