#!/usr/bin/env python3
"""Tensor, pipeline and expert parallelism and ZeRO-1/2/3 of the port over
several ranks: one per card with NCCL, or gloo processes on the CPU.

    python3 scripts/torch_parallel_multi.py          # 4 cards (NCCL)
    python3 scripts/torch_parallel_multi.py --cpu    # 4 gloo processes, small
    python3 scripts/torch_parallel_multi.py --kinds ep tp   # some cases

Every case trains the 0.88B llama config (chip_smoke.py MODEL; tiny on the
CPU) from the same seed for STEPS AdamW steps over a 4-rank mesh, and rank
0 holds it against one card's ``make_train_step`` on the same global batch
from the same params: every step's loss within USP_LOSS_TOL, every leaf
after the first step within USP_LEAF_TOL of its largest value
(chip_smoke.py train_usp's gates), every leaf's first update (its move
from the initial params) within UPDATE_TOL (MOE_UPDATE_TOL for the MoE
model) of one card's update, in the norm of that update, and a falling
loss. The leaves after the last step are reported beside them, with the
element that differs most and its moves (no gate). Each mesh rank's
kernel launches are counted exactly (the ring's B3, B2a and B2b, one of
each per ring step and layer; B1 and B5 never). Cases:

* tp: tp 2 x ring 2 (zigzag) and tp 4, ``make_train_step`` at ffn 5632
  (the next multiple of 256 above 5529, which no tp degree divides), b=1,
  s=8192;
* pp: pp 2 x ring 2 and pp 4, ``make_pp_train_step`` in 4 microbatches,
  b=4, s=8192, remat full on both sides;
* ep (first: its one-card reference, 3.23B parameters with AdamW, is the
  largest): ep 2 x ring 2 and ep 4, the MoE model (8 experts) at capacity
  8.0 (no token drops, so the ranks route as one card does but for
  tokens within rounding of a tie), b=1, s=8192, remat full; each
  layer's share of tokens that the mesh's first forward routes to
  another expert than one card's; and each layer's dropped share of a
  forward at capacity 2.0;
* ZeRO-1/2: dp 4 and dp 2 x tp 2, ``make_zero_train_step``, b=4, s=8192,
  remat full; the optimizer state's bytes per card against one card's
  (1/dp of them, 1/(dp tp) with tp);
* ZeRO-3: dp 4 and dp 2 x ring 2, ``make_zero3_train_step``, b=4, s=8192,
  remat full; params and optimizer state bytes per card.

Each case is timed (ms per step after the first, wall, every rank
synchronized, beside one card's) with each card's peak memory. Prints one
JSON line per case (also into ``--out``), the card and its power limit,
and exits non-zero when a check fails.
"""

import argparse
import dataclasses
import functools
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
STEPS = 3
LR, WEIGHT_DECAY = 1e-4, 1e-4
# chip_smoke.py's gates for a mesh step against one card's
USP_LOSS_TOL = 1e-2
USP_LEAF_TOL = 2.0 ** -7
# a leaf's first update against one card's: ||p1 - p1_card|| over
# ||p1_card - p0||. One bf16 AdamW step moves an element by about lr
# (one ulp or none), so USP_LEAF_TOL passes a step that moved nothing;
# this reads 1 for that, about 1.4 for an update uncorrelated with one
# card's, and 2 sqrt(f) where a share f of the elements moved the other
# way (a gradient within the rounding of zero)
UPDATE_TOL = 0.25
# the ep cases' UPDATE_TOL: a token whose two largest router logits are
# within rounding can take another expert on the mesh than on one card,
# and then its FFN output and every gradient it feeds differ whole; the
# mesh's share of such tokens is reported ("route_flip_share")
MOE_UPDATE_TOL = 0.5
N_MICRO = 4
MOE_EXPERTS, MOE_CAP, MOE_DROP_CAP = 8, 8.0, 2.0
LLAMA = {False: dict(vocab=32000, dim=2048, n_layers=16, n_heads=16,
                     n_kv_heads=8, head_dim=128, ffn_hidden=int(2048 * 2.7),
                     layout="zigzag"),
         True: dict(vocab=64, dim=64, n_layers=4, n_heads=4, n_kv_heads=4,
                    head_dim=16, ffn_hidden=128, layout="zigzag")}
FFN_TP = {False: 5632, True: 128}
SEQ = {False: 8192, True: 64}
# (name, kind, make_usp_mesh kwargs, global batch, config changes)
CASES = (
    ("ep 2 x ring 2", "ep", dict(ep=2, ring=2), 1,
     dict(n_experts=MOE_EXPERTS, moe_capacity_factor=MOE_CAP,
          remat="full")),
    ("ep 4", "ep", dict(ep=4), 1,
     dict(n_experts=MOE_EXPERTS, moe_capacity_factor=MOE_CAP,
          remat="full")),
    ("tp 2 x ring 2", "tp", dict(tp=2, ring=2), 1, {}),
    ("tp 4", "tp", dict(tp=4), 1, {}),
    ("pp 2 x ring 2", "pp", dict(pp=2, ring=2), 4, dict(remat="full")),
    ("pp 4", "pp", dict(pp=4), 4, dict(remat="full")),
    ("zero dp 4", "zero", dict(dp=4), 4, dict(remat="full")),
    ("zero dp 2 x tp 2", "zero", dict(dp=2, tp=2), 4, dict(remat="full")),
    ("zero3 dp 4", "zero3", dict(dp=4), 4, dict(remat="full")),
    ("zero3 dp 2 x ring 2", "zero3", dict(dp=2, ring=2), 4,
     dict(remat="full")),
)


def _config(cpu, kind, extra):
    from long_context_attention_tpu_torch.models.llama import ModelConfig

    dims = dict(LLAMA[cpu])
    if kind in ("tp", "zero") and "tp" in extra.get("_mesh", {}):
        dims["ffn_hidden"] = FFN_TP[cpu]
    return ModelConfig(**dims, **{k: v for k, v in extra.items()
                                  if not k.startswith("_")},
                       **({"dtype": torch.float32} if cpu else {}))


def _batch(cfg, b, s, device):
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    tokens = torch.randint(0, cfg.vocab, (b, s), generator=gen,
                           device=device)
    mask = torch.ones((b, s), dtype=torch.float32, device=device)
    mask[:, -1] = 0
    return tokens, torch.roll(tokens, -1, dims=1), mask


def _params(cfg, device):
    from long_context_attention_tpu_torch.models.llama import init_params

    return init_params(torch.Generator(device=device).manual_seed(SEED),
                       cfg, device=device)


def _sync(cpu):
    if not cpu:
        torch.cuda.synchronize()


def _state_bytes(opt):
    return sum(t.numel() * t.element_size() for st in opt.state.values()
               for t in st.values() if isinstance(t, torch.Tensor))


def _tensor_bytes(tree):
    from long_context_attention_tpu_torch.models.llama import param_leaves

    return sum(t.numel() * t.element_size() for t in param_leaves(tree))


def _one_card(cfg, b, s, device, cpu):
    """One card's make_train_step: losses, the initial params and those
    after the first and the last step (CPU copies in their dtype), ms per
    step, optimizer state bytes."""
    from long_context_attention_tpu_torch.models.llama import make_train_step

    opt = functools.partial(torch.optim.AdamW, lr=LR,
                            weight_decay=WEIGHT_DECAY)
    step = make_train_step(cfg, opt, device=device)
    tokens, labels, mask = _batch(cfg, b, s, device)
    params, state, losses, times = _params(cfg, device), None, [], []
    p0 = _host_copy(params)
    experts = _routes(params, tokens, cfg) if cfg.moe else None
    for i in range(STEPS):
        _sync(cpu)
        t0 = time.perf_counter()
        params, state, loss = step(params, state, tokens, labels, mask)
        losses.append(float(loss))
        times.append(time.perf_counter() - t0)
        if i == 0:
            first = _host_copy(params)
    out = {"losses": losses, "p0": p0, "params": first, "experts": experts,
           "last": _host_copy(params),
           "ms_per_step": 1e3 * sum(times[1:]) / max(len(times) - 1, 1),
           "state_bytes": _state_bytes(state),
           "param_bytes": _tensor_bytes(params)}
    del params, state
    if not cpu:
        torch.cuda.empty_cache()
    return out


def _named(tree):
    from long_context_attention_tpu_torch.models.llama import named_leaves

    return named_leaves(tree)


def _routes(params, tokens, cfg, mesh=None):
    """(n_layers, routed tokens) int64: each layer's expert for every token
    this rank routes, in one forward with no gradient."""
    from long_context_attention_tpu_torch.models.llama import forward_local
    from long_context_attention_tpu_torch.parallel.moe import record_drops

    with torch.no_grad(), record_drops() as drops:
        forward_local(params, tokens, cfg, mesh=mesh, last_index=0)
    return torch.stack([d["expert"] for d in drops])


def _route_flips(mesh, cfg, mine, card, b, s):
    """The share of tokens, per layer, that the mesh's first forward routed
    to another expert than one card's: ``card`` (n_layers, b * s), rank
    0's only, is broadcast and cut as the mesh cuts the tokens (layout,
    sequence shard, then this rank's 1/ep of them); ``mine`` is this
    rank's (n_layers, routed tokens). Every token is routed by one
    rank."""
    from long_context_attention_tpu_torch.parallel import layouts, seq_shard

    L = cfg.n_layers
    ids = (card.to(mine.device) if card is not None
           else mine.new_empty((L, b * s))).reshape(L, b, s)
    dist.broadcast(ids, src=0)
    ids = seq_shard(mesh, layouts.permute_for_layout(
        ids, cfg.layout, mesh.ring, axis=2), batch_axis=1, seq_axis=2)
    ids = ids.reshape(L, mesh.ep, -1)[:, mesh.ep_idx]
    counts = torch.stack([(ids != mine).sum(1), torch.full(
        (L,), mine.shape[1], device=mine.device)]).double()
    dist.all_reduce(counts)
    return (counts[0] / counts[1]).tolist()


def _host_copy(tree):
    """{leaf name: a CPU copy in the leaf's dtype}, never a view of it."""
    return {k: v.detach().to("cpu", copy=True) for k, v in _named(tree)}


def _leaf_diff(p0, want, got, device):
    """One leaf's numbers, ``got`` against ``want`` (both moved from
    ``p0``), in fp32 on ``device`` a slice of the leading dimension at a
    time: max |got - want|, max |want|, the flat index of the first,
    sum (got - want)^2, sum (want - p0)^2, the elements that ``want``
    moved and those whose two moves differ in sign (0 a sign of its
    own)."""
    out = dict(diff=0.0, ref=0.0, at=0, diff_sq=0.0, move_sq=0.0, moved=0,
               flipped=0)
    base = 0
    rows = p0.reshape(p0.shape[0] if p0.dim() > 1 else 1, -1)
    want, got = want.reshape(rows.shape), got.reshape(rows.shape)
    step = max(1, (1 << 27) // max(rows.shape[1], 1))
    for i in range(0, rows.shape[0], step):
        a, w, g = (t[i:i + step].to(device).float()
                   for t in (rows, want, got))
        d = (g - w).abs().reshape(-1)
        j = int(d.argmax())
        if float(d[j]) > out["diff"]:
            out["diff"], out["at"] = float(d[j]), base + j
        out["ref"] = max(out["ref"], float(w.abs().max()))
        out["diff_sq"] += float((d.double() ** 2).sum())
        mw, mg = w - a, g - a
        out["move_sq"] += float((mw.double() ** 2).sum())
        out["moved"] += int((mw != 0).sum())
        out["flipped"] += int((torch.sign(mw) != torch.sign(mg)).sum())
        base += d.numel()
    return out


def _update_rel(d):
    """||got - want|| over ||want - p0|| (0 when neither moved)."""
    if d["move_sq"] == 0.0:
        return 0.0 if d["diff_sq"] == 0.0 else float("inf")
    return (d["diff_sq"] / d["move_sq"]) ** 0.5


def _compare(ref, first, last, device):
    """The mesh's leaves after the first and the last step against one
    card's: the gated numbers of the first step (the worst leaf's
    max-relative difference and update error), the same after the last
    step, the share of moved elements that moved the other way, and the
    element that differs most after the last step with its values."""
    one = {k: _leaf_diff(ref["p0"][k], ref["params"][k], v, device)
           for k, v in first.items()}
    end = {k: _leaf_diff(ref["p0"][k], ref["last"][k], v, device)
           for k, v in last.items()}

    def worst(stats, fn):
        name = max(stats, key=lambda k: fn(stats[k]))
        return fn(stats[name]), name

    leaf, _ = worst(one, lambda d: d["diff"] / max(d["ref"], 1e-30))
    upd, upd_name = worst(one, _update_rel)
    flip, flip_name = worst(one, lambda d: d["flipped"] / max(d["moved"], 1))
    leaf3, name3 = worst(end, lambda d: d["diff"] / max(d["ref"], 1e-30))
    at = end[name3]["at"]

    def value(t):
        return float(t.reshape(-1)[at].float())

    p0 = value(ref["p0"][name3])
    return {"worst_leaf_rel": leaf, "worst_update_rel": upd,
            "worst_update_leaf": upd_name, "worst_flip_share": flip,
            "worst_flip_leaf": flip_name,
            "update_rel_by_leaf": {k: _update_rel(d) for k, d in one.items()},
            "last_step_leaf_rel": leaf3, "last_step_update_rel": max(
                _update_rel(d) for d in end.values()),
            "last_step_worst_element": {
                "leaf": name3, "flat_index": at, "leaf_max": end[name3]["ref"],
                "p0": p0,
                "first_move_card": value(ref["params"][name3]) - p0,
                "first_move_mesh": value(first[name3]) - p0,
                "last_move_card": value(ref["last"][name3]) - p0,
                "last_move_mesh": value(last[name3]) - p0}}


def _expected_counts(kind, cfg, mesh):
    """Each rank's B3 / B2a / B2b launches over the timed steps."""
    L = cfg.n_layers
    fwd = 2 if cfg.remat == "full" else 1
    if kind == "pp":  # every stage runs its layers on every tick
        calls = (N_MICRO + mesh.pp - 1) * (L // mesh.pp)
    else:
        calls = L
    calls *= mesh.ring  # one call per ring step
    return {"flash_fwd_pos": STEPS * calls * fwd,
            "flash_bwd_dq": STEPS * calls, "flash_bwd_dkv": STEPS * calls}


def _case(rank, device, cpu, name, kind, mesh_kw, b, extra, ref):
    from long_context_attention_tpu_torch.models.llama import (
        gather_params, make_pp_train_step, make_train_step, param_shapes,
        shard_params)
    from long_context_attention_tpu_torch.ops import _build
    from long_context_attention_tpu_torch.parallel import (
        layouts, make_usp_mesh, seq_shard, zero)
    from long_context_attention_tpu_torch.parallel.moe import record_drops

    cfg = _config(cpu, kind, dict(extra, _mesh=mesh_kw))
    s = SEQ[cpu]
    mesh = make_usp_mesh(**mesh_kw, device=device)
    opt = functools.partial(torch.optim.AdamW, lr=LR,
                            weight_decay=WEIGHT_DECAY)
    zs = None
    full = _params(cfg, device)
    if kind == "zero3":
        zs = zero.zero3_param_specs(param_shapes(cfg), mesh)
        params = zero.shard_params_zero3(full, mesh, zs)
        step = zero.make_zero3_train_step(cfg, mesh, opt)
    else:
        params = shard_params(full, mesh)
        step = (make_pp_train_step(cfg, mesh, opt, N_MICRO) if kind == "pp"
                else zero.make_zero_train_step(cfg, mesh, opt)
                if kind == "zero" else make_train_step(cfg, opt, mesh=mesh))
    del full
    batch = [seq_shard(mesh, layouts.permute_for_layout(
        x, cfg.layout, mesh.ring)) for x in _batch(cfg, b, s, device)]
    flips = None
    if kind == "ep":  # the first forward's routes against one card's
        flips = _route_flips(mesh, cfg, _routes(params, batch[0], cfg, mesh),
                             ref["experts"] if rank == 0 else None, b, s)
    if not cpu:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    state, losses, times, gathered = None, [], [], {}
    _build.reset_launch_counts()
    for i in range(STEPS):
        _sync(cpu)
        dist.barrier()
        t0 = time.perf_counter()
        params, state, loss = step(params, state, *batch)
        losses.append(float(loss))
        times.append(time.perf_counter() - t0)
        if i in (0, STEPS - 1):  # the leaves (collectives only)
            full = gather_params(params, mesh, zs)
            if rank == 0:
                gathered[i] = _host_copy(full)
            del full
    counts = _build.launch_counts()
    row = {"case": name, "kind": kind, "mesh": mesh_kw, "batch": b,
           "seq": s, "remat": cfg.remat, "ffn_hidden": cfg.ffn_hidden,
           "losses": losses,
           "ms_per_step": 1e3 * sum(times[1:]) / max(len(times) - 1, 1),
           "ms_all": [1e3 * t for t in times]}
    ok = True
    want = {n: 0 for n in counts}
    if not cpu:
        want.update(_expected_counts(kind, cfg, mesh))
    if counts != want:
        ok = False
        row["launch_error"] = {"got": counts, "want": want}
    row["launches_per_step"] = {n: c // STEPS for n, c in counts.items()
                                if c}
    opt_state = state.optimizer if kind == "zero" else state
    row["state_bytes_per_card"] = _state_bytes(opt_state)
    row["param_bytes_per_card"] = _tensor_bytes(params)
    if not cpu:
        row["max_memory_allocated_gb"] = \
            torch.cuda.max_memory_allocated() / 2 ** 30
    if kind == "ep":  # the dropped shares at capacity 2.0, one forward
        from long_context_attention_tpu_torch.models.llama import (
            forward_local)
        drop_cfg = dataclasses.replace(cfg, moe_capacity_factor=MOE_DROP_CAP)
        with torch.no_grad(), record_drops() as drops:
            forward_local(params, batch[0], drop_cfg, mesh=mesh,
                          last_index=0)
        L = cfg.n_layers
        row["drop_share_per_layer_at_2.0"] = [
            int(drops[i]["dropped"]) / drops[i]["tokens"] for i in range(L)]
        row["router_margin"] = min(float(d["margin"]) for d in drops)
        row["route_flip_share"] = flips
    del params, state, step
    if rank == 0:
        if not cpu:
            torch.cuda.empty_cache()
        update_tol = MOE_UPDATE_TOL if kind == "ep" else UPDATE_TOL
        cmp = _compare(ref, gathered[0], gathered[STEPS - 1], device)
        dloss = max(abs(a - c) for a, c in zip(losses, ref["losses"]))
        row.update({"one_card_losses": ref["losses"],
                    "one_card_ms_per_step": ref["ms_per_step"],
                    "one_card_state_bytes": ref["state_bytes"],
                    "one_card_param_bytes": ref["param_bytes"],
                    "loss_diff": dloss, **cmp,
                    "loss_tol": USP_LOSS_TOL, "leaf_tol": USP_LEAF_TOL,
                    "update_tol": update_tol})
        row["state_bytes_ratio"] = (row["state_bytes_per_card"]
                                    / ref["state_bytes"])
        ok = (ok and dloss <= USP_LOSS_TOL
              and cmp["worst_leaf_rel"] <= USP_LEAF_TOL
              and cmp["worst_update_rel"] <= update_tol
              and losses[-1] < losses[0])
        if kind in ("zero", "zero3"):  # the state falls by 1/dp
            ok = ok and row["state_bytes_ratio"] <= 1.0 / mesh.dp + 0.01
    del gathered
    if not cpu:
        torch.cuda.empty_cache()
    return row, ok


def _worker(rank, port, cpu, out_path, kinds):
    torch.set_num_threads(1)
    if not cpu:
        torch.cuda.set_device(rank)
    dist.init_process_group("gloo" if cpu else "nccl",
                            init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=WORLD)
    device = "cpu" if cpu else "cuda"
    results, ok = [], True
    for name, kind, mesh_kw, b, extra in CASES:
        if kinds and kind not in kinds:
            continue
        ref = None
        if rank == 0:  # one card's steps; the other ranks wait below
            cfg = _config(cpu, kind, dict(extra, _mesh=mesh_kw))
            ref = _one_card(cfg, b, SEQ[cpu], device, cpu)
        dist.barrier()
        row, case_ok = _case(rank, device, cpu, name, kind, mesh_kw, b,
                             extra, ref)
        mem = [None] * WORLD
        dist.all_gather_object(mem, row.get("max_memory_allocated_gb"))
        row["peak_memory_gb_by_rank"] = mem
        flags = [None] * WORLD
        dist.all_gather_object(flags, (case_ok, row.get("launch_error")))
        row["ok"] = all(f[0] for f in flags)
        errors = [f[1] for f in flags if f[1]]
        if errors:
            row["launch_errors"] = errors
        ok = ok and row["ok"]
        results.append(row)
        if rank == 0:
            print(json.dumps({"progress": name, "ok": row["ok"]}),
                  flush=True)
    if rank == 0:
        Path(out_path).write_text(json.dumps({"ok": ok, "results": results}))
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
    parser.add_argument("--out", type=Path, default=None,
                        help="also write the JSON lines into this file")
    parser.add_argument("--kinds", nargs="*", default=None,
                        choices=sorted({c[1] for c in CASES}),
                        help="run only the cases of these kinds")
    args = parser.parse_args()
    if not args.cpu and torch.cuda.device_count() < WORLD:
        print(f"needs {WORLD} cards, found {torch.cuda.device_count()}",
              file=sys.stderr)
        return 1
    out_path = ROOT / "build" / f"parallel_multi_{os.getpid()}.json"
    out_path.parent.mkdir(exist_ok=True)
    t0 = time.perf_counter()
    if not args.cpu:  # once, before the ranks load the libraries
        from long_context_attention_tpu_torch.ops import _build
        _build.build_all(["flash_fwd_sm90.cu", "flash_dq_sm90.cu",
                          "flash_bwd_sm90.cu"])
    mp.start_processes(_worker, args=(_free_port(), args.cpu,
                                      str(out_path), args.kinds),
                       nprocs=WORLD, join=True, start_method="spawn")
    res = json.loads(out_path.read_text())
    out_path.unlink()
    lines = [json.dumps(row) for row in res["results"]]
    print("\n".join(lines))
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("\n".join(lines) + "\n")
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
