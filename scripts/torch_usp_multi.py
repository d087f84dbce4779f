#!/usr/bin/env python3
"""The dense USP layer over several ranks: one per card with NCCL, or gloo
processes on the CPU.

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
one-device call. Prints one JSON line per mesh, the card and its power
limit, and exits non-zero when a check fails.
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
    # b, s, h, h_kv, d: the 0.88B attention width at s = 32768 on cards
    shape = (1, 512, 4, 4, 32) if args.cpu else (1, 32768, 16, 8, 128)
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
