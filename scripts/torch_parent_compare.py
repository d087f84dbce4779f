#!/usr/bin/env python3
"""This tree's kernels against another checkout's, on one NVIDIA GPU: each
pair timed in one process, in turns (other, this, this, other), and their
outputs compared.

    python3 scripts/torch_parent_compare.py --other DIR [--json PATH]

DIR is the root of another checkout of this repository, such as the parent
commit unpacked by ``git archive`` into a directory that ``.gitignore``
lists. Each tree builds its own ``csrc/`` into its own ``build/kernels/``
(all sources of both trees compiled at once), and each kernel runs through
this tree's wrapper with the other tree's library swapped in (its launch
counts as usual). Cases, at the serving and training paths' shapes (16/8
heads, head_dim 128, bf16):

* kernels whose arithmetic both trees share, which must agree bit for bit:
  B1 causal self-attention at b=4, s=2048 and s=8192; B3 over an int8 kv
  prefix of 6144 with 2048 rows at q_start 6144, causal, and with window
  4096 and 4 sinks, in the online and softcap forms, the same over fp8
  and packed int4 prefixes (every quantized kind, whose widening the
  producers choose by a run-time value or a template argument), and over
  a bf16 kv at b=1, s=8192; B2b and B5 at b=1,
  s=8192, causal (B5's dq is added by TMA reduce-adds in an order that
  changes from run to run, so it is held to ROW_REL_TOL of each row); the
  sage kernels B8a and B8b on the int8 operands of a 4 x 8192 prefill
  (B8b with window 4096 and 4 sinks); B6 over int8 and bf16 caches,
  dense (the slice's b=4 cache of 12288 slots, ~8.2K live) and paged
  (pages of 2048 from a pool of 65), one token per row and a run of 256
  (the cache after the append), through the public cache_append (the
  byte copy; a tree whose B6 takes pointers and a dims array is called
  through its first entry point from this tree's argument array). A tree
  whose B7 entry takes no ALiBi slopes is called without them, and one
  whose sage entries take no pv_int8 table without it;
* B7 over the same caches, one token per row (``decode_attention``,
  decode_attention.cu) and a run of 256 (two sub-runs, on ``decode_run``,
  decode_run_sm90.cu, in a tree that has it): each tree's out and lse row
  by row against the plain version (ROW_REL_TOL), timed in turns. A tree
  whose one-token kernel is the first design (no cluster launch) is called
  with that design's dims (splits and tiles per split by its rule) and
  partial buffers; a tree without ``decode_run`` runs its runs through its
  ``decode_attention`` entry (the same C signature) at its own split rule
  (8 rows a block);
* B2a at b=1, s=8192, causal, B4 at b=4, s=2048 and s=8192 with window
  4096 and 4 sinks, and B9a, B9b and B9c at b=1, s=32768 in tiles of 512
  on the StreamingLLM mask, where a tree may have another kernel: each
  tree's output row by row against the plain version (ROW_REL_TOL), and
  whether the two trees' outputs are bit-equal (reported). A tree whose
  ``sparse_fwd``, ``sparse_bwd_dq`` or ``sparse_bwd_dkv`` is in
  ``sparse.cu`` has it called with that source's arguments; a tree whose
  backward entry points take no softcap (and no window) is called without
  it, on the dense cases only.

Then, in this tree alone: B5, B2b and B2a with the sliding window, sinks
and softcap at b=1, s=8192 (chip_smoke.py's masked backward cases),
each against its plain version and timed; and B9c on the StreamingLLM and
per-head masks with two schedules of the same items: the persistent
kernels' snake deal (``csrc/sm90.cuh`` item_index) and
``SparsePlan.dkv_schedule``'s, timed in turns (snake, schedule, schedule,
snake); their outputs must be bit-equal.

Prints one JSON line per case, then the card's name and power limit; with
``--json`` also writes every line to PATH. Exits non-zero when a check
fails.
"""

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from long_context_attention_tpu_torch.ops import (  # noqa: E402
    _build, flash, sage, sparse)

H, HKV, D = 16, 8, 128
WINDOW, SINKS = 4096, 4
ROW_REL_TOL = 2.0 ** -5
# chip_smoke.py's floor for a row whose exact value is 0 by cancellation
# (under the causal mask q row 0 sees column 0 alone: p = 1, so its ds =
# dp - delta is fp32 rounding noise on both sides)
CANCEL_FLOOR = 2.0 ** -10
SCALE = D ** -0.5
# the masked backward cases (chip_smoke.py's BWD_MASKED): (tag, q_start or
# None for B5, the mask kwargs)
_WIN = dict(causal=True, window_size=(WINDOW, -1), sink_tokens=SINKS)
MASKED = (
    ("window sinks", None, _WIN),
    ("non-causal window (512, 256) sinks", None,
     dict(causal=False, window_size=(512, 256), sink_tokens=SINKS)),
    ("window sinks softcap", None, dict(_WIN, softcap=50.0)),
    ("offsets window sinks", 0, _WIN),
    ("kv offset s/2 window sinks softcap", -4096, dict(_WIN, softcap=50.0)))
# the kernels each case runs
KERNELS = ("flash_fwd_causal_self", "flash_fwd_pos", "flash_fwd_static",
           "flash_bwd_dq", "flash_bwd_dkv", "flash_bwd_fused", "sage_fwd_tri",
           "sage_fwd_pos", "sparse_fwd", "sparse_bwd_dq", "sparse_bwd_dkv",
           "cache_append", "decode_attention", "decode_run")
BACKWARD = ("flash_bwd_dq", "flash_bwd_dkv", "flash_bwd_fused")
SAGE = ("sage_fwd_tri", "sage_fwd_pos")
SPARSE = ("sparse_fwd", "sparse_bwd_dq", "sparse_bwd_dkv")
# the one argument list of sparse.cu's entry points: q, k, v, dout, lse,
# delta, out, out_lse, dk, dv, the CSR walk, dims, qfold, scale, stream
OLD_SPARSE_ARGS = [ctypes.c_void_p] * 13 + [ctypes.c_float] * 2 + [
    ctypes.c_void_p]
# the backward entry points' arguments before they took the softcap: q, k,
# v, dout, lse, delta, dq, dk, dv, dims, scale, stream
OLD_BWD_ARGS = [ctypes.c_void_p] * 10 + [ctypes.c_float, ctypes.c_void_p]


def kernel_sources(root: Path):
    """{kernel: source file} of a checkout, read from its ops/_build.py."""
    text = (root / "long_context_attention_tpu_torch" / "ops"
            / "_build.py").read_text()
    found = {}
    for name in KERNELS:
        key = f'Kernel(\n        "{name}", '
        if key in text:  # a tree may lack a kernel (decode_run)
            found[name] = text[text.index(key):].split('"')[3]
    return found


def first_design_splits(b, h_kv, G, cap, bkv, n_tok, left, sink):
    """The first design's split of a row's live tiles (decode_attention.cu
    before the span kernel): (splits, tiles per split), 264 blocks of 8
    query rows aimed at, bounded by the most live tiles a row can have
    (the cases pass no kv_splits)."""
    nk = -(-cap // bkv)
    if left >= 0:
        nk = min(nk, -(-sink // bkv) + (left + n_tok - 1 + bkv) // bkv + 1)
    splits = max(1, min(nk, -(-264 // (b * h_kv * -(-G // 8)))))
    per = -(-nk // splits)
    return -(-nk // per), per


def runs_on_first_design(fn):
    """B7 on the first design's decode_attention entry (the same C
    signature): a tree's one-token kernel, or its runs in a tree with no
    decode_run, with the splits (and their partial buffers) of that
    design's rule, 8 query rows a block."""
    keep = {}

    def call(*a):
        dims = [int(x) for x in a[12]]
        b, h_kv, G, cap, _, bkv, _, _, left, sink, n_tok = dims[:11]
        splits, per = first_design_splits(b, h_kv, G, cap, bkv, n_tok, left,
                                          sink)
        dims[6], dims[7] = splits, per
        args = list(a)
        if splits > 1:
            key = (b, splits, h_kv, G)
            if key not in keep:
                keep[key] = [torch.empty(shape, device="cuda") for shape in
                             ((b, splits, h_kv, G, D), (b, splits, h_kv, G))]
            args[8], args[9] = (t.data_ptr() for t in keep[key])
        args[12] = _build.dims_array(dims)
        return fn(*args)

    return call


# B6's first entry point: k, v, the new rows (2), scales (4), append_pos,
# page table, dims, stream
OLD_B6_ARGS = [ctypes.c_void_p] * 12


def b6_from_args(fn):
    """B6 on the first entry point (pointers and a dims array) from this
    tree's int64 argument array: the byte-copy kind only (the public
    cache_append, contiguous (b, h_kv, n, row) rows), whose arithmetic both
    entry points share."""
    from long_context_attention_tpu_torch.ops import decode

    def call(addr, stream):
        a = (ctypes.c_longlong * decode._A_COUNT).from_address(addr)
        if a[decode._A_KIND] != decode._B6_COPY or a[decode._A_NL] != 1:
            raise ValueError("the first B6 entry takes only the byte copy "
                             "of one layer")
        dims = _build.dims_array([a[i] for i in (
            decode._A_B, decode._A_HKV, decode._A_N, decode._A_CAP,
            decode._A_LAYER0, decode._A_ROW_BYTES, decode._A_POOL,
            decode._A_PAGE, decode._A_NPAGES)])
        ptrs = [a[decode._A_DST], a[decode._A_DST + 1], a[decode._A_SRC],
                a[decode._A_SRC + 1], a[decode._A_DSC], a[decode._A_DSC + 1],
                a[decode._A_SSC], a[decode._A_SSC + 1], a[decode._A_POS],
                a[decode._A_PT]]
        return fn(*[p or None for p in ptrs], dims, stream)

    return call


class Tree:
    """One checkout's kernel libraries, built from its csrc/."""

    def __init__(self, root: Path):
        self.root = root
        self.csrc = root / "long_context_attention_tpu_torch" / "csrc"
        self.build = root / "build" / "kernels"
        self.sources = kernel_sources(root)
        self.fns = {}
        # whether the backward entry points take the softcap (and the
        # window and sinks in dims)
        self.masked_bwd = "float softcap" in "".join(
            (self.csrc / f).read_text() for f in ("sm90.cuh",
                                                  "flash_bwd_sm90.cu"))
        # whether B7's entry point takes the ALiBi slopes (its last
        # argument), and whether its one-token kernel is the span kernel
        b7 = (self.csrc / "decode_attention.cu").read_text()
        self.b7_slopes = ("const float* slopes)" in b7
                          or "const float* slopes,\n" in b7)
        # whether B7's entry points take a sharded cache's columns (after
        # the slopes)
        self.b7_cols = "const int* sink_cols)" in b7
        self.b7_spans = "cudaLaunchKernelEx" in b7
        # whether the sage entries take pv_int8's table (after lse)
        self.sage_table = "float *tbl" in (
            self.csrc / "sage_fwd_sm90.cu").read_text()
        # whether B6 takes one int64 argument array (else its first entry:
        # pointers and dims)
        self.b6_args = "const long long* a, void* stream" in (
            self.csrc / "cache_append.cu").read_text()

    def paths(self, source):
        saved = _build.CSRC, _build.BUILD_DIR
        _build.CSRC, _build.BUILD_DIR = self.csrc, self.build
        try:
            return _build._lib_path(source)
        finally:
            _build.CSRC, _build.BUILD_DIR = saved

    def start(self):
        saved = _build.CSRC, _build.BUILD_DIR
        _build.CSRC, _build.BUILD_DIR = self.csrc, self.build
        try:
            return [(s, _build._start_build(s))
                    for s in sorted(set(self.sources.values()))]
        finally:
            _build.CSRC, _build.BUILD_DIR = saved

    def load(self):
        for name, source in self.sources.items():
            lib = ctypes.CDLL(str(self.paths(source)))
            fn = getattr(lib, _build.KERNELS[name].symbol)
            fn.restype = ctypes.c_int
            self.fns[name] = fn
        # a sparse kernel in sparse.cu takes that source's argument list
        for name in self.sources:
            self.fns[name].argtypes = (
                OLD_SPARSE_ARGS if self.old(name)
                else OLD_BWD_ARGS if name in BACKWARD and not self.masked_bwd
                else _build.KERNELS[name].argtypes)
            if name in BACKWARD and not self.masked_bwd:
                # drop the softcap (and read dims up to causal): dense only
                self.fns[name] = (lambda fn: lambda *a: fn(*a[:11], a[12]))(
                    self.fns[name])
            if name in SAGE and not self.sage_table:
                # no table (the bf16 PV's is null): the argument is dropped
                args = self.fns[name].argtypes
                self.fns[name].argtypes = args[:8] + args[9:]
                self.fns[name] = (lambda fn: lambda *a: fn(*a[:8], *a[9:]))(
                    self.fns[name])
            if name in ("decode_attention", "decode_run"):
                # no sharded columns (and, for decode_attention, no ALiBi
                # slopes, dims read up to n_pages): those trailing
                # arguments are dropped; the cases pass none
                drop = (0 if self.b7_cols else 2) + (
                    0 if self.b7_slopes or name == "decode_run" else 1)
                if drop:
                    self.fns[name].argtypes = self.fns[name].argtypes[:-drop]
                    self.fns[name] = (lambda fn, k: lambda *a: fn(*a[:-k]))(
                        self.fns[name], drop)
        if not self.b6_args:
            self.fns["cache_append"].argtypes = OLD_B6_ARGS
            self.fns["cache_append"] = b6_from_args(self.fns["cache_append"])
        first = self.fns["decode_attention"]
        if not self.b7_spans:  # the first design's dims and partials
            self.fns["decode_attention"] = runs_on_first_design(first)
        if "decode_run" not in self.sources:
            self.fns["decode_run"] = runs_on_first_design(first)

    def old(self, name):
        return self.sources[name] == "sparse.cu"

    def active(self, name):
        return _build.KERNELS[name]._fn is self.fns[name]

    def use(self):
        for name in KERNELS:
            _build.KERNELS[name]._fn = self.fns[name]


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


def row_rel(got, want, cancel_rows=None):
    """Max over rows of max |got - want| / max |want| (0 / 0 = 0); the rows
    ``cancel_rows`` (an index into dim 1) against CANCEL_FLOOR of the
    largest |want| at least."""
    got, want = got.float(), want.float()
    diff = (got - want).abs().amax(-1)
    size = want.abs().amax(-1)
    if cancel_rows is not None:
        floor = CANCEL_FLOOR * float(want.abs().max())
        size[:, cancel_rows] = size[:, cancel_rows].clamp_min(floor)
    rel = torch.where(size > 0, diff / size.clamp_min(1e-30),
                      torch.where(diff > 0, float("inf"), 0.0))
    return float(rel.max())


def snake_schedule(n, blocks):
    """(ptr, work) of the snake deal of n work items over `blocks` blocks:
    block i takes item j * blocks + i on even turns j and (j + 1) * blocks
    - 1 - i on odd ones."""
    per = [[] for _ in range(blocks)]
    for j in range(-(-n // blocks)):
        for i in range(blocks):
            t = (j + 1) * blocks - 1 - i if j & 1 else j * blocks + i
            if t < n:
                per[i].append(t)
    ptr = torch.tensor([0] + [len(x) for x in per]).cumsum(0).int()
    return ptr, torch.tensor([t for x in per for t in x], dtype=torch.int32)


def old_sparse(tree, name, q, k, v, plan, dout=None, lse=None,
               delta=None):
    """A sparse kernel through sparse.cu's entry point (its argument list):
    B9a's (out, lse), B9b's (dq,) or B9c's (dk, dv)."""
    b, s_q, h, _ = q.shape
    dev = q.device
    row_ptr, row_ent, col_ptr, col_ent = plan.csr(dev)
    out = out_lse = dk = dv = None
    if name == "sparse_fwd":
        out = torch.empty(q.shape, dtype=torch.bfloat16, device=dev)
        out_lse = torch.empty((b, h, s_q), dtype=torch.float32, device=dev)
    elif name == "sparse_bwd_dq":
        out = torch.empty(q.shape, dtype=torch.float32, device=dev)
    else:
        dk = torch.empty(k.shape, dtype=torch.float32, device=dev)
        dv = torch.empty_like(dk)
    walk = (col_ptr, col_ent) if name == "sparse_bwd_dkv" else (row_ptr,
                                                                 row_ent)

    def strides(t):
        return t.stride()[:3] if t is not None else (0, 0, 0)

    def ptr(t):
        return None if t is None else t.data_ptr()

    dims = _build.dims_array([
        b, h, k.shape[2], s_q, k.shape[1], *strides(q), *strides(k),
        *strides(v), *strides(dout), *strides(out), *strides(dk),
        plan.n_q, plan.n_kv, plan.bq, plan.bkv, int(plan.per_head)])
    err = tree.fns[name](
        *(ptr(t) for t in (q, k, v, dout, lse, delta, out, out_lse, dk, dv,
                           *walk)),
        dims, SCALE * 1.4426950408889634, SCALE, _build.stream_ptr(dev))
    if err:
        raise RuntimeError(f"sparse.cu {name}: CUDA error {err}")
    return {"sparse_fwd": (out, out_lse), "sparse_bwd_dq": (out,),
            "sparse_bwd_dkv": (dk, dv)}[name]


# B6 and B7: the slice's dense cache and serve_paged's pool (chip_smoke.py)
PAGE, POOL, S_MAX = 2048, 65, 12288
DENSE_LENS, PAGED_LENS = (8193, 8150, 8224, 7999), (16384, 9000, 2049, 1)


def decode_cases(compare, gen, dev):
    """B6 and B7 over int8 and bf16 caches, dense and paged, one token per
    row and a run of 256: B6 bit for bit between the trees, B7 each tree
    against the plain version."""
    from long_context_attention_tpu_torch.ops import decode

    L = 2
    for dtype in ("int8", "bfloat16"):
        for paged in (False, True):
            slots = PAGE if paged else S_MAX
            rows = POOL if paged else len(DENSE_LENS)
            shape = (L, rows, HKV, slots, D)
            if dtype == "int8":
                kc, vc = (torch.randint(-127, 128, shape, generator=gen,
                                        device=dev, dtype=torch.int8)
                          for _ in range(2))
                ks, vs = (torch.rand((L, rows, HKV, 1, slots), generator=gen,
                                     device=dev) / 64 for _ in range(2))
            else:
                kc, vc = (torch.randn(shape, generator=gen,
                                      device=dev).bfloat16()
                          for _ in range(2))
                ks = vs = None
            lens = PAGED_LENS if paged else DENSE_LENS
            pt = None
            if paged:
                pt = torch.full((len(lens), 8), -1, dtype=torch.int32)
                free = (torch.randperm(POOL - 1, generator=torch.Generator()
                                       .manual_seed(0)) + 1).tolist()
                for r, n in enumerate(lens):
                    for i in range(-(-n // PAGE)):
                        pt[r, i] = free.pop()
                pt = pt.to(dev)
            lt = torch.tensor(lens, dtype=torch.int32, device=dev)
            b = len(lens)
            where = "paged" if paged else "dense"
            cache = [t for t in (kc, vc, ks, vs) if t is not None]
            saved = [t.clone() for t in cache]

            def reset(cache=cache, saved=saved):
                for t, c in zip(cache, saved):
                    t.copy_(c)

            for n in (1, 256):
                pos = lt - n
                kn, vn = ((torch.randint(-127, 128, (b, HKV, n, D),
                                         generator=gen, device=dev,
                                         dtype=torch.int8)
                           if dtype == "int8" else
                           torch.randn((b, HKV, n, D), generator=gen,
                                       device=dev).bfloat16())
                          for _ in range(2))
                ksn, vsn = ((torch.rand((b, HKV, n), generator=gen,
                                        device=dev) for _ in range(2))
                            if dtype == "int8" else (None, None))

                def append(kn=kn, vn=vn, ksn=ksn, vsn=vsn, pos=pos):
                    decode.cache_append(kc, vc, kn, vn, pos, ks, vs, ksn,
                                        vsn, layer=1, page_table=pt)
                    return cache

                compare(f"B6 {dtype} {where} n={n}", append, reset=reset)
                reset()
                q = torch.randn((b, n, H, D) if n > 1 else (b, H, D),
                                generator=gen, device=dev).bfloat16()

                def plain(q=q):  # on CPU copies of the layer
                    cpu = [None if t is None else t[1:2].cpu()
                           for t in (kc, vc, ks, vs)]
                    return decode.decode_attention(
                        q.cpu(), cpu[0], cpu[1], lt.cpu(), cpu[2], cpu[3],
                        layer=0, page_table=None if pt is None else pt.cpu(),
                        return_lse=True)

                # one token on decode_attention, a run on decode_run: each
                # tree against the plain version
                compare(f"B7 {dtype} {where} n={n}",
                        lambda q=q: decode.decode_attention(
                            q, kc, vc, lt, ks, vs, layer=1, page_table=pt,
                            return_lse=True), same=False,
                        plain=lambda q=q: [t.to(dev) for t in plain(q)])
            del kc, vc, ks, vs, cache, saved
            torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True, type=Path,
                    help="root of the other checkout")
    ap.add_argument("--json", type=Path, help="also write the lines here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    other, this = Tree(args.other.resolve()), Tree(ROOT)
    jobs = other.start() + this.start()  # every nvcc at once
    for source, job in jobs:
        _build._finish_build(source, job)
    for tree in (other, this):
        tree.load()
    lines, failed = [], []

    def emit(obj):
        obj = {"card": smi, **obj}
        lines.append(obj)
        print(json.dumps(obj), flush=True)

    def compare(name, fn, same=True, plain=None, loose=(), cancel_rows=None,
                reset=None):
        """Run fn under each tree; times in turns; outputs bit-equal
        (same) or each against the plain outputs (row tolerance). ``reset``
        restores what fn updates in place before each tree's run."""
        outs = {}
        for tag, tree in (("other", other), ("this", this)):
            tree.use()
            if reset is not None:
                reset()
            outs[tag] = [t.clone() for t in fn()]
            torch.cuda.synchronize()
        times = {"other": [], "this": []}
        for tag, tree in (("other", other), ("this", this), ("this", this),
                          ("other", other)):
            tree.use()
            times[tag].append(time_ms(fn))
        res = {"case": name, "other_ms": times["other"],
               "this_ms": times["this"],
               "other_sources": sorted(set(other.sources.values())),
               "this_sources": sorted(set(this.sources.values()))}
        res["bit_equal"] = all(
            torch.equal(a, b) for i, (a, b) in
            enumerate(zip(outs["other"], outs["this"])) if i not in loose)
        if same:
            res["loose_row_rel"] = [row_rel(outs["this"][i], outs["other"][i])
                                    for i in loose]
            ok = res["bit_equal"] and all(r <= ROW_REL_TOL
                                          for r in res["loose_row_rel"])
        else:
            want = plain()
            res["row_rel_vs_plain"] = {
                tag: max(row_rel(a, w, cancel_rows) for a, w in zip(o, want))
                for tag, o in outs.items()}
            ok = all(r <= ROW_REL_TOL
                     for r in res["row_rel_vs_plain"].values())
        res["ok"] = ok
        if not ok:
            failed.append(name)
        emit(res)

    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).bfloat16()

    # B1
    for b, s in ((4, 2048), (4, 8192)):
        q, k, v = randn(b, s, H, D), randn(b, s, HKV, D), randn(b, s, HKV, D)
        compare(f"B1 b={b} s={s}", lambda: flash.flash_fwd_causal_self(
            q, k, v, scale=SCALE))
    # B3: int8 prefix (dense, windowed), bf16 kv
    b, start, s_q = 4, 6144, 2048
    q = randn(b, s_q, H, D)
    k8, v8 = (torch.randint(-127, 128, (b, HKV, start, D), generator=gen,
                            device=dev, dtype=torch.int8) for _ in range(2))
    ks, vs = (torch.rand((b, HKV, start), generator=gen, device=dev) / 64
              for _ in range(2))
    compare("B3 int8 dense", lambda: flash.flash_fwd_pos(
        q, k8, v8, ks, vs, q_start=start, causal=True, scale=SCALE))
    compare("B3 int8 window sinks", lambda: flash.flash_fwd_pos(
        q, k8, v8, ks, vs, q_start=start, causal=True, scale=SCALE,
        window_size=(WINDOW, -1), sink_tokens=SINKS))
    for tag, kw in (("safe", dict(safe_softmax=True)),
                    ("softcap", dict(softcap=50.0))):
        compare(f"B3 int8 {tag}", lambda: flash.flash_fwd_pos(
            q, k8, v8, ks, vs, q_start=start, causal=True, scale=SCALE,
            **kw))
    from long_context_attention_tpu_torch.ops import kv_cache
    for dt in ("float8_e4m3fn", "int4"):
        (kq, ksq), (vq, vsq) = (kv_cache.quantize_kv(
            torch.randn((b, HKV, start, D), generator=gen, device=dev), dt)
            for _ in range(2))
        compare(f"B3 {dt} dense", lambda: flash.flash_fwd_pos(
            q, kq, vq, ksq, vsq, q_start=start, causal=True, scale=SCALE))
        compare(f"B3 {dt} window sinks safe", lambda: flash.flash_fwd_pos(
            q, kq, vq, ksq, vsq, q_start=start, causal=True, scale=SCALE,
            window_size=(WINDOW, -1), sink_tokens=SINKS, safe_softmax=True))
        del kq, ksq, vq, vsq
    q1 = randn(1, 8192, H, D)
    kb, vb = (randn(1, 8192, HKV, D).transpose(1, 2) for _ in range(2))
    compare("B3 bf16 b=1 s=8192", lambda: flash.flash_fwd_pos(
        q1, kb, vb, q_start=0, causal=True, scale=SCALE))
    del q, k8, v8, ks, vs, q1, kb, vb
    torch.cuda.empty_cache()
    decode_cases(compare, gen, dev)
    # B2b, B5
    s = 8192
    q, k, v, dout = (randn(1, s, H, D), randn(1, s, HKV, D),
                     randn(1, s, HKV, D), randn(1, s, H, D))
    out, lse = flash.flash_fwd_causal_self(q, k, v, scale=SCALE,
                                           safe_softmax=True)
    delta = (out.float() * dout.float()).sum(-1).transpose(1, 2).contiguous()
    compare("B2b b=1 s=8192", lambda: flash.flash_bwd_dkv(
        q, k, v, dout, lse, delta, scale=SCALE, causal=True))
    compare("B5 b=1 s=8192", lambda: flash.flash_bwd_fused(
        q, k, v, dout, lse, delta, scale=SCALE, causal=True), loose=(0,))
    compare("B2a b=1 s=8192", lambda: (flash.flash_bwd_dq(
        q, k, v, dout, lse, delta, scale=SCALE, causal=True),), same=False,
        plain=lambda: (flash.flash_bwd_dq_plain(
            q, k, v, dout, lse, delta, scale=SCALE, causal=True),),
        cancel_rows=0)
    # B5, B2b, B2a with the masks, this tree alone: against the plain
    # versions, timed
    this.use()
    for tag, q_start, shape in MASKED:
        o, l_ = (flash.flash_fwd_static(q, k, v, scale=SCALE, **shape)
                 if q_start is None else flash.flash_fwd_pos(
                     q, k.transpose(1, 2), v.transpose(1, 2), scale=SCALE,
                     q_start=q_start, **shape))
        dl = (o.float() * dout.float()).sum(-1).transpose(1, 2).contiguous()
        a = (q, k, v, dout, l_, dl)
        kw = dict(scale=SCALE, **shape)
        fns = ((("B5", flash.flash_bwd_fused, flash.flash_bwd_fused_plain),)
               if q_start is None else
               (("B2a", flash.flash_bwd_dq, flash.flash_bwd_dq_plain),
                ("B2b", flash.flash_bwd_dkv, flash.flash_bwd_dkv_plain)))
        if q_start is not None:
            kw["q_start"] = q_start
        for name, fn, plain in fns:
            got, want = fn(*a, **kw), plain(*a, **kw)
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            cancel = (max(-(q_start or 0), 0)
                      if shape["causal"] and name != "B2b" else None)
            rel = max(row_rel(g, w, cancel if i == 0 else None)
                      for i, (g, w) in enumerate(zip(got, want)))
            del got, want
            ok = rel <= ROW_REL_TOL
            if not ok:
                failed.append(f"{name} {tag}")
            emit({"case": f"{name} b=1 s={s} {tag}", "this_ms": [
                time_ms(lambda: fn(*a, **kw)) for _ in range(2)],
                "row_rel_vs_plain": rel, "ok": ok})
            torch.cuda.empty_cache()
        del o, l_, dl, a
    del q, k, v, dout, out, lse, delta
    torch.cuda.empty_cache()
    # B8a, B8b on the int8 operands of a 4 x 8192 prefill (this tree's
    # quantization kernels)
    b, s = 4, 8192
    q, k, v = randn(b, s, H, D), randn(b, s, HKV, D), randn(b, s, HKV, D)
    this.use()
    k_mean = sage.sage_k_mean(k)
    k8, ks, v8, vs = sage.sage_quant_kv(k, v, k_mean)
    q8, qs, _ = sage.sage_quant_q(q, SCALE, k_mean)
    ops = (q8, qs, k8, ks, v8, vs)
    compare(f"B8a b={b} s={s}", lambda: sage.sage_fwd_tri(*ops))
    compare(f"B8b b={b} s={s} window {WINDOW} sinks {SINKS}",
            lambda: sage.sage_fwd_pos(*ops, q_start=0, causal=True,
                                      window_size=(WINDOW, -1),
                                      sink_tokens=SINKS))
    del q, k, v, k_mean, ops, q8, qs, k8, ks, v8, vs
    torch.cuda.empty_cache()
    # B4
    win = dict(causal=True, window_size=(WINDOW, -1), sink_tokens=SINKS)
    for b, s in ((4, 2048), (4, 8192)):
        q, k, v = randn(b, s, H, D), randn(b, s, HKV, D), randn(b, s, HKV, D)

        def plain(q=q, k=k, v=v):  # one batch row at a time
            parts = [flash.flash_fwd_static_plain(
                q[i:i + 1], k[i:i + 1], v[i:i + 1], scale=SCALE, **win)
                for i in range(q.shape[0])]
            return [torch.cat([p[j] for p in parts]) for j in range(2)]

        compare(f"B4 b={b} s={s} window {WINDOW} sinks {SINKS}",
                lambda: flash.flash_fwd_static(q, k, v, scale=SCALE, **win),
                same=False, plain=lambda: plain()[:1])
        del q, k, v
        torch.cuda.empty_cache()
    # B9a, B9b, B9c: the backward's operands from this tree's B9a
    s, blk = 32768, 512
    n = s // blk
    mask = sparse.global_local_block_mask(n, n, 8, sink_tiles=1)
    plan = sparse._plan(mask.tobytes(), mask.shape, H, n, n, True, blk, blk,
                        H // HKV, 0, 1)
    q, k, v, dout = (randn(1, s, H, D), randn(1, s, HKV, D),
                     randn(1, s, HKV, D), randn(1, s, H, D))
    this.use()
    o, l = sparse.sparse_fwd(q, k, v, plan, scale=SCALE)
    ops = sparse.sparse_bwd_operands(o, l, dout, q.dtype)
    calls = {
        "sparse_fwd": ("B9a", (), lambda: sparse.sparse_fwd(
            q, k, v, plan, scale=SCALE), lambda: sparse.sparse_fwd_plain(
            q, k, v, plan, scale=SCALE)),
        "sparse_bwd_dq": ("B9b", ops, lambda: (sparse.sparse_bwd_dq(
            q, k, v, *ops, plan, scale=SCALE),),
            lambda: (sparse.sparse_bwd_dq_plain(q, k, v, *ops, plan,
                                                scale=SCALE),)),
        "sparse_bwd_dkv": ("B9c", ops, lambda: sparse.sparse_bwd_dkv(
            q, k, v, *ops, plan, scale=SCALE),
            lambda: sparse.sparse_bwd_dkv_plain(q, k, v, *ops, plan,
                                                scale=SCALE)),
    }
    for name, (row_name, extra, new, plain) in calls.items():
        def call(name=name, extra=extra, new=new):
            for tree in (other, this):
                if tree.old(name) and tree.active(name):
                    return old_sparse(tree, name, q, k, v, plan, *extra)
            return new()

        compare(f"{row_name} b=1 s={s} tiles {blk} streaming", call,
                same=False, plain=plain,
                cancel_rows=0 if name == "sparse_bwd_dq" else None)
        torch.cuda.empty_cache()

    # B9c's schedule: the snake deal against dkv_schedule's, this tree
    this.use()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    masks = {"streaming": mask, "per_head": np.stack([
        sparse.global_local_block_mask(n, n, 4 + 2 * (i % 5), sink_tiles=1)
        for i in range(H)])}
    for name, m in masks.items():
        plan = sparse._plan(m.tobytes(), m.shape, H, n, n, True, blk, blk,
                            H // HKV, 0, 1)
        o, l = sparse.sparse_fwd(q, k, v, plan, scale=SCALE)
        ops = sparse.sparse_bwd_operands(o, l, dout, q.dtype)
        key = f"dkv_schedule 1 {HKV} {sms} {q.device}"  # the wrapper's
        greedy = plan.dkv_schedule(1, HKV, sms, q.device)
        n_work = int(greedy[1].numel())
        snake = tuple(t.to(dev) for t in snake_schedule(n_work,
                                                         min(sms, n_work)))
        steps = np.repeat(plan.dkv_items()[:, 2],
                          1 if plan.per_head else HKV) + 2
        loads = {}
        for tag, sched in (("snake", snake), ("schedule", greedy)):
            ptr, work = (t.cpu().numpy() for t in sched)
            loads[tag] = max(int(steps[work[ptr[i]:ptr[i + 1]]].sum())
                             for i in range(ptr.size - 1))
        outs, times = {}, {"snake": [], "schedule": []}
        for tag in ("snake", "schedule", "schedule", "snake"):
            plan._on_device[key] = snake if tag == "snake" else greedy
            outs[tag] = [t.clone() for t in sparse.sparse_bwd_dkv(
                q, k, v, *ops, plan, scale=SCALE)]
            times[tag].append(time_ms(lambda: sparse.sparse_bwd_dkv(
                q, k, v, *ops, plan, scale=SCALE)))
        plan._on_device[key] = greedy
        equal = all(torch.equal(a, b) for a, b in
                    zip(outs["snake"], outs["schedule"]))
        emit({"case": f"B9c schedule {name}", "snake_ms": times["snake"],
              "schedule_ms": times["schedule"],
              "max_block_steps": loads,
              "mean_block_steps": float(steps.sum()) / sms,
              "bit_equal": equal, "ok": equal})
        if not equal:
            failed.append(f"B9c schedule {name}")
    print(smi, flush=True)
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text("".join(json.dumps(x) + "\n" for x in lines))
    if failed:
        print(f"failed: {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
