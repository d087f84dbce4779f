#!/usr/bin/env python3
"""Which side bounds the sage kernels B8a and B8b on one NVIDIA GPU.

    python3 scripts/torch_sage_bound.py

``csrc/sage_fwd_sm90.cu`` runs a pipeline of two producer warpgroups (TMA,
the k/v scales, and the widening of each int8 V tile to bf16, or with
pv_int8 its transposing) and two consumer warpgroups (the int8 QK^T and
the PV products on wgmma, the softmax). This script builds the source
twice more with ``LCA_SAGE_PART`` set: 1 skips the consumers' products and
softmax (the producers alone, with the same barriers), 2 skips the
producers' widening or transposing (the consumers alone). Both variants
give wrong outputs; only their times count. It times the kernel and both
variants on the int8 operands of the 0.88B model's one-shot prefill (b=4,
s=8192, 16/8 heads, d=128), B8a causal, B8b with window 4096 and 4 sinks,
and B8a's pv_int8 entry (T = 1024), in turns (kernel, variants, variants,
kernel), beside kernel B1 on the bf16 inputs of the same shape. It prints
one JSON line and the card's name and power limit.
"""

import ctypes
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from long_context_attention_tpu_torch.ops import _build, flash, sage  # noqa: E402

B, S, H, HKV, D = 4, 8192, 16, 8, 128
WINDOW, SINKS = 4096, 4
PARTS = {"producers_only": 1, "consumers_only": 2}
ENTRIES = {"B8a": "lca_sage_fwd_tri", "B8b": "lca_sage_fwd_pos",
           "B8a pv_int8": "lca_sage_fwd_tri_pv8"}
# pv_int8's group width at this shape (ops/sage.py pv_tile, default tiles)
PV_TILE = 1024


def build_part(part: int) -> ctypes.CDLL:
    """The source built with LCA_SAGE_PART=part beside the kernels."""
    out = _build.BUILD_DIR / "bound" / f"sage_fwd_sm90_part{part}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, f"-DLCA_SAGE_PART={part}",
                    "-o", str(out), str(_build.CSRC / "sage_fwd_sm90.cu")],
                   check=True, capture_output=True)
    return ctypes.CDLL(str(out))


def launcher(lib, entry, args, **kw):
    """A call of one entry of `lib` with the operands and dims that the
    ``sage_fwd_*`` wrapper would pass (its launch goes uncounted)."""
    fn = getattr(lib, entry)
    fn.argtypes = [ctypes.c_void_p] * 11
    fn.restype = ctypes.c_int
    q8, qs, k8, ks, v8, vs = args
    out = torch.empty((B, S, H, D), dtype=torch.bfloat16, device=q8.device)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q8.device)
    left, right, sink = kw.get("left", -1), kw.get("right", 0), kw.get("sink", 0)
    # pv_int8's entries take T, the groups, and a table of 128 rows of
    # group maxima for each block of the persistent grid; the bf16 PV's
    # none
    table, pv = None, [0, 0, 0]
    if entry.endswith("_pv8"):
        slots = torch.cuda.get_device_properties(
            q8.device).multi_processor_count
        table = torch.empty(slots * 128 * (S // PV_TILE), device=q8.device)
        pv = [PV_TILE, S // PV_TILE, slots]
    dims = _build.dims_array([
        B, H, HKV, S, S, *q8.stride()[:3], *k8.stride()[:3], *v8.stride()[:3],
        *out.stride()[:3], *qs.stride(), *ks.stride(), *vs.stride(), 0, left,
        right, sink, *flash.pair_masks(flash.Positions.at(0), S, S, left,
                                       right, sink), *pv])
    ptrs = [t.data_ptr() for t in (q8, qs, k8, ks, v8, vs, out, lse)] + [
        None if table is None else table.data_ptr()]
    stream = _build.stream_ptr(q8.device)

    def call():
        err = fn(*ptrs, dims, stream)
        if err:
            raise RuntimeError(f"{entry}: CUDA error {err}")
    return call


def time_ms(fn, iters=10, warmup=2):
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


def main():
    if not torch.cuda.is_available():
        print("torch_sage_bound: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn(shape, generator=gen, device=dev).bfloat16()
               for shape in ((B, S, H, D), (B, S, HKV, D), (B, S, HKV, D)))
    k_mean = sage.sage_k_mean(k)
    k8, ks, v8, vs = sage.sage_quant_kv(k, v, k_mean)
    q8, qs, _ = sage.sage_quant_q(q, D ** -0.5, k_mean)
    args = (q8, qs, k8, ks, v8, vs)
    kernel = _build.library("sage_fwd_sm90.cu")
    libs = {"kernel": kernel, **{n: build_part(p) for n, p in PARTS.items()}}
    win = dict(left=WINDOW, sink=SINKS)
    calls = {(name, tag): launcher(lib, ENTRIES[name], args,
                                   **(win if name == "B8b" else {}))
             for name in ENTRIES for tag, lib in libs.items()}
    order = ["kernel", *PARTS, *reversed(PARTS), "kernel"]
    ms = {f"{name} {tag}": [] for name, tag in calls}
    for tag in order:
        for name in ENTRIES:
            ms[f"{name} {tag}"].append(time_ms(calls[(name, tag)]))
    b1 = time_ms(lambda: flash.flash_fwd_causal_self(q, k, v, scale=D ** -0.5))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(json.dumps({"shape": {"b": B, "s": S, "h": H, "h_kv": HKV, "d": D},
                      "b8b_window": WINDOW, "b8b_sinks": SINKS, "ms": ms,
                      "b1_ms": b1, "card": smi}), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
