#!/usr/bin/env python3
"""Item order of the backward kernels B5 and B2b on one NVIDIA GPU.

    python3 scripts/torch_bwd_order.py

``csrc/flash_bwd_sm90.cu`` deals its (kv tile, kv head, batch) items to the
persistent blocks with the kv tiles outside, longest causal walk first
(``item_of``). The variant this script builds takes the kv heads outside
instead, so that the blocks running at once share few kv heads and B5's dq
rows stay in L2: it rewrites ``item_of`` in a copy of the source under
build/kernels/order/ and builds that beside the default, checks both
against the plain versions on a ragged causal call, and times both at b=1,
16/8 heads, d=128, causal, s=8192 and s=32768, in turns (default, variant,
variant, default) on the same inputs. It prints one JSON line per shape and
the card's name and power limit.
"""

import ctypes
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from long_context_attention_tpu_torch.ops import _build, flash  # noqa: E402

ENTRIES = {"flash_bwd_fused": "lca_flash_bwd_fused",
           "flash_bwd_dkv": "lca_flash_bwd_dkv"}
H, HKV, D = 16, 8, 128


# item_of's order, kv tiles outside, and the variant's, kv heads outside
KV_TILES_OUTSIDE = """  const int r = t % (p.b * p.h_kv);
  x.ik = t / (p.b * p.h_kv);"""
KV_HEADS_OUTSIDE = """  const int r = t / p.nk;
  x.ik = t % p.nk;"""


def build_variant():
    """The kernel with the kv heads outside, built from a copy of the
    source beside the shared header."""
    work = _build.BUILD_DIR / "order"
    work.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / "flash_bwd_sm90.cu").read_text()
    if src.count(KV_TILES_OUTSIDE) != 1:
        raise RuntimeError("item_of changed: update this script")
    (work / "flash_bwd_sm90.cu").write_text(
        src.replace(KV_TILES_OUTSIDE, KV_HEADS_OUTSIDE))
    (work / "sm90.cuh").write_bytes((_build.CSRC / "sm90.cuh").read_bytes())
    out = work / "flash_bwd_sm90_kv_heads_outside.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                    str(work / "flash_bwd_sm90.cu")], check=True,
                   capture_output=True)
    return ctypes.CDLL(str(out))


def bind(lib):
    """The wrappers' B5 and B2b entry points, from lib (None: the default
    build)."""
    for name, symbol in ENTRIES.items():
        k = _build.KERNELS[name]
        k._fn = None
        if lib is not None:
            fn = getattr(lib, symbol)
            fn.argtypes = k.argtypes
            fn.restype = ctypes.c_int
            k._fn = fn


def inputs(s, gen, dev):
    q, do = (torch.randn((1, s, H, D), generator=gen, device=dev).bfloat16()
             for _ in range(2))
    k, v = (torch.randn((1, s, HKV, D), generator=gen, device=dev).bfloat16()
            for _ in range(2))
    out, lse = flash.flash_fwd_causal_self(q, k, v, scale=D ** -0.5)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    return q, k, v, do, lse, delta


def time_ms(fn, iters):
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


def main():
    if not torch.cuda.is_available():
        print("torch_bwd_order: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    variant = build_variant()
    kw = dict(scale=D ** -0.5, causal=True)
    small = inputs(1000, gen, dev)
    want = flash.flash_bwd_fused_plain(*small, **kw)
    for lib in (None, variant):
        bind(lib)
        got = flash.flash_bwd_fused(*small, **kw)
        err = max(float((a - w).abs().max() / w.abs().max())
                  for a, w in zip(got, want))
        if not err < 2.0 ** -5:
            raise AssertionError(f"order variant differs: {err}")
    for s, iters in ((8192, 10), (32768, 3)):
        args = inputs(s, gen, dev)
        ms = {o: {"B5": [], "B2b": []} for o in ("kv_tiles_outside",
                                                 "kv_heads_outside")}
        for order, lib in (("kv_tiles_outside", None),
                           ("kv_heads_outside", variant),
                           ("kv_heads_outside", variant),
                           ("kv_tiles_outside", None)):
            bind(lib)
            ms[order]["B5"].append(time_ms(
                lambda: flash.flash_bwd_fused(*args, **kw), iters))
            ms[order]["B2b"].append(time_ms(
                lambda: flash.flash_bwd_dkv(*args, **kw), iters))
        print(json.dumps({"seq": s, "heads": H, "kv_heads": HKV,
                          "head_dim": D, "ms": ms}), flush=True)
        del args
        torch.cuda.empty_cache()
    bind(None)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
