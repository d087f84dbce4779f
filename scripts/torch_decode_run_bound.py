#!/usr/bin/env python3
"""Which side bounds B7's run kernel, decode_run, on one NVIDIA GPU.

    python3 scripts/torch_decode_run_bound.py [--json PATH]

``csrc/decode_run_sm90.cu`` runs a pipeline of one producer warpgroup (the
TMA of each 128-column chunk of K and V and its scales through the page
table, the widening, sign extension or transposing of the raw kinds) and
two consumer warpgroups (QK^T and PV on wgmma, the score arithmetic). This
script builds the source twice more with ``LCA_RUN_PART`` set: 1 skips the
consumers' products and score arithmetic (the producer alone, with the same
barriers), 2 skips the producer's operand making (the consumers alone). Both
variants give wrong outputs; only their times count. At chip_smoke.py's
run cases (a paged pool of pages of 2048, RUN_LENS (16448, 5000), 16/8
heads, d = 128: the int8 runs of 256 and 64, the int8 run of 256 with
window 4096 and 4 sinks, the bf16 and fp8 runs of 256), it times the
kernel over the tile rule's sub-runs through ``decode_attention_core``
(CUDA events), the variants, and the kernel again (kernel, variants,
kernel), each case's device time by kernel (decode_run and the split
merge) under torch.profiler, and the wrapper's host time per call. One
JSON line per case, then the card's name and power limit.
"""

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from long_context_attention_tpu_torch.ops import (  # noqa: E402
    _build, decode, kv_cache)

H, HKV, D, LAYER = 16, 8, 128, 1
PARTS = {"producer_only": 1, "consumers_only": 2}


def build_part(part: int):
    """lca_decode_run of the source built with LCA_RUN_PART=part."""
    out = _build.BUILD_DIR / "bound" / f"decode_run_sm90_part{part}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS,
                    f"-DLCA_RUN_PART={part}", "-o", str(out),
                    str(_build.CSRC / "decode_run_sm90.cu")], check=True,
                   capture_output=True)
    fn = ctypes.CDLL(str(out)).lca_decode_run
    fn.argtypes = _build.KERNELS["decode_run"].argtypes
    fn.restype = ctypes.c_int
    return fn


def sub_runs(q, cache, lens, pt, **kw):
    """The core calls decode_attention makes for a run: (args, kwargs) of
    each sub-run of the tile rule's plan."""
    kc = cache[0]
    s8 = cache[2] is not None and kc.dtype in (torch.int8, torch.uint8)
    n_tok = q.shape[1]
    subs = []
    for i, e, bkv in decode.decode_run_plan(n_tok, HKV, H // HKV, D,
                                            kc.shape[3], kc.element_size(),
                                            paged=True):
        q_in, q_rs, _ = decode.decode_query_operands(
            q[:, i:e], kc, s8, scale=D ** -0.5, block_kv=4096, paged=True)
        subs.append(((q_in, q_rs, *cache, lens - (n_tok - e)),
                     dict(layer=LAYER, block_kv=bkv, scale=D ** -0.5,
                          n_tok=e - i, page_table=pt, **kw)))
    return subs


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--json", type=Path, help="also write the lines here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = cs.smi_line()
    _build.build_all(["decode_run_sm90.cu"])
    kernel = _build.KERNELS["decode_run"].function()
    fns = {"kernel": kernel, **{k: build_part(v) for k, v in PARTS.items()}}
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    lens = torch.tensor(cs.RUN_LENS, dtype=torch.int32, device=dev)
    lines = []

    def case(tag, q, cache, pt, **kw):
        subs = sub_runs(q, cache, lens, pt, **kw)

        def run():
            return [decode.decode_attention_core(*a, **k) for a, k in subs]

        res = {"case": tag, "card": smi}
        for name in ("kernel", *PARTS, "kernel"):
            _build.KERNELS["decode_run"]._fn = fns[name]
            res.setdefault(f"{name}_ms", []).append(
                cs.time_ms(run, iters=20))
        _build.KERNELS["decode_run"]._fn = kernel
        _, prof = cs.profiled(lambda: [run() for _ in range(10)])
        res["device_ms_by_kernel"] = {n[:40]: t / 10 for n, _, t in
                                      prof["top"][:4]}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            run()
        res["host_ms_per_call"] = (time.perf_counter() - t0) / 20 * 1e3
        torch.cuda.synchronize()
        lines.append(res)
        print(json.dumps(res), flush=True)

    kc, vc, ks, vs, pt = cs.paged_pool(gen, dev, "int8", lens=cs.RUN_LENS,
                                       n_pages=cs.RUN_PAGES)
    for n in (256, 64):
        q = torch.randn((len(cs.RUN_LENS), n, H, D), generator=gen,
                        device=dev).bfloat16()
        case(f"int8 n={n}", q, (kc, vc, ks, vs), pt)
        if n == 256:
            case("int8 n=256 window sinks", q, (kc, vc, ks, vs), pt,
                 window_left=cs.WINDOW, sink_tokens=cs.SINKS)
    del kc, vc, ks, vs
    torch.cuda.empty_cache()
    kc, vc, ks, vs, pt = cs.paged_pool(gen, dev, "bfloat16",
                                       lens=cs.RUN_LENS, n_pages=cs.RUN_PAGES)
    q = torch.randn((len(cs.RUN_LENS), 256, H, D), generator=gen,
                    device=dev).bfloat16()
    case("bf16 n=256", q, (kc, vc, ks, vs), pt)
    (kc, ks), (vc, vs) = (kv_cache.quantize_kv(t, "float8_e4m3fn")
                          for t in (kc, vc))
    case("fp8 cast n=256", q, (kc, vc, ks[..., None, :], vs[..., None, :]),
         pt)
    if args.json:
        args.json.write_text("".join(json.dumps(x) + "\n" for x in lines))
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
