#!/usr/bin/env python3
"""Which side bounds one-token B7 (csrc/decode_attention.cu) on one NVIDIA
GPU: its loads or its arithmetic.

    python3 scripts/torch_decode_token_bound.py [--json PATH]

The kernel cuts each JAX kv tile into spans, one block each, a thread
block cluster per tile: one thread issues the span's K and V rows as bulk
async copies, and the block's warps compute the scores, the softmax with
the cluster's exchanges and PV. This script builds the source three more
times with ``LCA_TOKEN_PART`` set: 1 skips the arithmetic of
the scores, the softmax and PV (the loads and every barrier alone), 2
skips the loads (the arithmetic alone, over whatever shared memory
holds), 3 skips both (the launch, the barriers, the cluster's exchanges
and the stores: the skeleton). The variants give wrong outputs; only
their times count. At chip_smoke.py's one-token cases
(the slice's b = 4 cache of 12288 slots at its lengths, 16/8 heads,
d = 128: int8, int8 with window 4096 and 4 sinks, int8 with kv_splits=4,
bf16 and fp8 on the cast path; a paged pool of pages of 2048 at
PAGED_LENS: int8, bf16 and int8 with the window), it times the kernel
through ``decode_attention_core`` over the cache's layers in turn
(chip_smoke.py kernel_timing: device ms per call under torch.profiler,
the call's CUDA-event ms and the wrapper's host ms), the variants, and the
kernel again (kernel, variants, kernel), beside the least time the card
could take for the bytes (3.35 TB/s). One JSON line per case, then the
card's name and power limit.
"""

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from long_context_attention_tpu_torch.ops import (  # noqa: E402
    _build, decode, kv_cache)

H, HKV, D = 16, 8, 128
# the variants timed beside the kernel: their nvcc flags
VARIANTS = {name: [f"-DLCA_TOKEN_PART={part}"] for name, part in
            (("loads_only", 1), ("math_only", 2), ("skeleton", 3))}
DENSE_LENS = (cs.PROMPT + 1, cs.PROMPT - 42, cs.PROMPT + cs.NEW,
              cs.PROMPT - 193)
WIN = dict(window_left=cs.WINDOW, sink_tokens=cs.SINKS)


def build_variant(name: str, flags):
    """Start nvcc for the source with ``flags``; returns a function that
    waits for it and loads its lca_decode_attention."""
    out = _build.BUILD_DIR / "bound" / f"decode_attention_{name}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, *flags,
                             "-o", str(out),
                             str(_build.CSRC / "decode_attention.cu")],
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL)

    def load():
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed for {name} ({flags})")
        fn = ctypes.CDLL(str(out)).lca_decode_attention
        fn.argtypes = _build.KERNELS["decode_attention"].argtypes
        fn.restype = ctypes.c_int
        return fn

    return load


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--json", type=Path, help="also write the lines here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = cs.smi_line()
    # every nvcc at once
    parts = {k: build_variant(k, v) for k, v in VARIANTS.items()}
    _build.build_all(["decode_attention.cu"])
    kernel = _build.KERNELS["decode_attention"].function()
    fns = {"kernel": kernel, **{k: load() for k, load in parts.items()}}
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    lines = []

    def case(tag, q, cache, lens, pt=None, **kw):
        """q (b, h, d) bf16 over cache (k, v, k scales, v scales) of L
        layers: the core wrapper on decode_attention's operands."""
        kc = cache[0]
        s8 = cache[2] is not None and kc.dtype in (torch.int8, torch.uint8)
        q_in, q_rs, bkv = decode.decode_query_operands(
            q, kc, s8, scale=D ** -0.5, block_kv=4096, paged=pt is not None)
        ckw = dict(block_kv=bkv, scale=D ** -0.5, page_table=pt, **kw)
        calls = cs.b7_layer_calls(decode, (q_in, q_rs, *cache, lens),
                                  kc.shape[0], **ckw)
        res = {"case": tag, "card": smi, "tile": bkv}
        for name in ("kernel", *VARIANTS, "kernel"):
            _build.KERNELS["decode_attention"]._fn = fns[name]
            t = cs.kernel_timing(calls)
            res.setdefault(f"{name}_ms", []).append(t["ms"])
            if name == "kernel":
                for key in ("call_ms", "host_ms"):
                    res.setdefault(key, []).append(t[key])
                res["device_ms_by_kernel"] = t["device_ms_by_kernel"]
        _build.KERNELS["decode_attention"]._fn = kernel
        win = kw.get("window_left", -1)
        nbytes, _ = cs.b7_bound(lens.tolist(), 1, H, HKV, D,
                                kc.element_size(), win,
                                kw.get("sink_tokens", 0),
                                scales=cache[2] is not None)
        res["bound_ms"] = nbytes / cs.PEAK_BYTES * 1e3
        res["bytes"] = nbytes
        lines.append(res)
        print(json.dumps(res), flush=True)

    L, b, S = cs.MODEL["n_layers"], len(DENSE_LENS), cs.S_MAX
    lens = torch.tensor(DENSE_LENS, dtype=torch.int32, device=dev)
    q = torch.randn((b, H, D), generator=gen, device=dev).bfloat16()
    for dtype in ("int8", "bfloat16", "float8_e4m3fn"):
        shape = (L, b, HKV, S, D)
        if dtype == "bfloat16":
            cache = [torch.randn(shape, generator=gen, device=dev).bfloat16()
                     for _ in range(2)] + [None, None]
        else:
            (kc, ks), (vc, vs) = (cs.quant_values(kv_cache, shape, dtype, gen,
                                                  dev) for _ in range(2))
            cache = [kc, vc, ks[..., None, :], vs[..., None, :]]
        tag = {"int8": "dense int8", "bfloat16": "dense bf16",
               "float8_e4m3fn": "dense fp8 cast"}[dtype]
        case(tag, q, cache, lens)
        if dtype == "int8":
            case("dense int8 window sinks", q, cache, lens, **WIN)
            case("dense int8 kv_splits=4", q, cache, lens, kv_splits=4)
        del cache
        torch.cuda.empty_cache()
    lens = torch.tensor(cs.PAGED_LENS, dtype=torch.int32, device=dev)
    q = torch.randn((len(cs.PAGED_LENS), H, D), generator=gen,
                    device=dev).bfloat16()
    for dtype in ("int8", "bfloat16"):
        kc, vc, ks, vs, pt = cs.paged_pool(gen, dev, dtype,
                                           L=cs.B7_PAGED_LAYERS)
        case(f"paged {dtype}", q, (kc, vc, ks, vs), lens, pt)
        if dtype == "int8":
            case("paged int8 window sinks", q, (kc, vc, ks, vs), lens, pt,
                 **WIN)
        del kc, vc, ks, vs
        torch.cuda.empty_cache()
    if args.json:
        args.json.write_text("".join(json.dumps(x) + "\n" for x in lines))
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
