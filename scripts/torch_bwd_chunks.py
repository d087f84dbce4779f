#!/usr/bin/env python3
"""B2a and B2b at one position chunk against two, on one NVIDIA GPU.

    python3 scripts/torch_bwd_chunks.py

At b=1, s=8192, causal, for head dims 128 and 64 and groups of 2 and 8
query heads a kv head, each kernel's call at one chunk (positions 0..s-1)
and at a one-rank zigzag ring's two chunks (0 and s/2: the same positions,
the same walk and order, through the kernels' MULTI instantiations, as
``make_train_step(mesh=make_usp_mesh())`` runs them). The inputs' lse
comes from the plain forward. Per call: CUDA-event ms over 10 calls, the
host's enqueue ms, and the kernel's device ms under torch.profiler. Builds
only the two backward sources at both head dims. Prints the card's name
and power limit, then one JSON line per shape.
"""

import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from long_context_attention_tpu_torch.ops import _build as build  # noqa: E402
from long_context_attention_tpu_torch.ops import flash  # noqa: E402

SEQ = 8192
# (head dim, query heads, kv heads)
SHAPES = ((128, 16, 8), (128, 32, 4), (64, 32, 4), (64, 32, 16))


def main():
    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    build.build_all(["flash_bwd_sm90.cu", "flash_bwd_sm90.cu:d64",
                     "flash_dq_sm90.cu", "flash_dq_sm90.cu:d64"])
    print(cs.smi_line(), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    s = SEQ
    for d, h, hk in SHAPES:
        scale = d ** -0.5
        q, dout = (torch.randn((1, s, h, d), generator=gen, device=dev)
                   .bfloat16() for _ in range(2))
        k, v = (torch.randn((1, s, hk, d), generator=gen, device=dev)
                .bfloat16() for _ in range(2))
        kt, vt = k.transpose(1, 2), v.transpose(1, 2)
        res = {}
        for tag, pos in (("one", flash.Positions.at(0)),
                         ("zigzag", flash.Positions((0, s // 2),
                                                    (0, s // 2)))):
            o, lse = flash.flash_fwd_pos_plain(q, kt, vt, pos=pos,
                                               causal=True, scale=scale)
            delta = (dout.float() * o.float()).sum(-1).transpose(1, 2)
            args = (q, k, v, dout, lse, delta.contiguous())
            kw = dict(pos=pos, causal=True, scale=scale)
            for n, fn in (("B2a", flash.flash_bwd_dq),
                          ("B2b", flash.flash_bwd_dkv)):
                ev = cs.time_ms(lambda: fn(*args, **kw))
                t0 = time.perf_counter()
                for _ in range(20):
                    fn(*args, **kw)
                host = (time.perf_counter() - t0) / 20 * 1e3
                torch.cuda.synchronize()
                _, prof = cs.profiled(lambda: [fn(*args, **kw)
                                               for _ in range(5)])
                dev_ms = [t / c for name, c, t in prof["top"]
                          if "sm90_kernel" in name]
                res[f"{n} {tag}"] = {
                    "event_ms": round(ev, 4), "host_enqueue_ms": round(host, 4),
                    "device_ms": [round(x, 4) for x in dev_ms]}
            del o, lse, delta, args
            torch.cuda.empty_cache()
        print(json.dumps({"d": d, "h": h, "hk": hk, **res}), flush=True)
        del q, k, v, dout, kt, vt
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
