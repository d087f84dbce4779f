"""Head dim 64 on the serving path of the PyTorch port, against the JAX
package: a narrow Llama of head dim 64 with 8 query heads a kv head (G = 8,
TinyLlama-1.1B's grouping) through Engine and PagedContinuousEngine, B7's
plain version at JAX's d = 64 tiles and run split, the one-token kernel's
walk at d = 64 row bytes, decode_run's shared memory and B6's host plan at
both head dims, and which head dims each kernel entry point takes. The
port runs its plain versions on the CPU, JAX its Pallas kernels in
interpret mode, on the same numpy inputs.

Tolerances:
* Engine logits 5e-2 (a float32 model with int8 weights and cache: fp32
  sums in another order, the same int8 quantizations; in a bf16 model one
  activation's bf16 rounding can move its int8 level, which moved a
  decode step's logits by up to 0.07 here);
* greedy tokens equal (a tie-free prompt seed), engines token for token;
* decode attention out 2e-2 plus one bf16 ulp (2^-7) of the value, lse
  1e-4 (tests/test_torch_paged.py's B7 gates);
* B6: bit for bit.
"""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from long_context_attention_tpu import serving as jserving
from long_context_attention_tpu.models import llama as jllama
from long_context_attention_tpu.ops import decode as jdec
from long_context_attention_tpu.ops import kv_cache as jkv
from long_context_attention_tpu_torch import serving as tserving
from long_context_attention_tpu_torch.models import llama as tllama
from long_context_attention_tpu_torch.ops import _build
from long_context_attention_tpu_torch.ops import decode as tdec
from long_context_attention_tpu_torch.ops import flash as tflash
from long_context_attention_tpu_torch.ops import kv_cache as tkv
from long_context_attention_tpu_torch.ops import sage as tsage
from long_context_attention_tpu_torch.ops import sparse as tsp
from long_context_attention_tpu_torch.utils.convert import (
    cache_values_from_jax, params_from_jax)

torch.set_num_threads(1)

D = 64
SHAPE = dict(vocab=256, dim=256, n_layers=2, n_heads=8, n_kv_heads=1,
             head_dim=D, ffn_hidden=512, layout="basic")
B, S_PROMPT, S_MAX, CHUNK, NEW = 2, 16, 64, 8, 4
PROMPT_SEED = 2
LOGITS_TOL = dict(atol=5e-2, rtol=0)
OUT_TOL = dict(atol=2e-2, rtol=2.0 ** -7)
LSE_TOL = dict(atol=1e-4, rtol=0)
KINDS = ("bfloat16", "int8", "float8_e4m3fn", "int4")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _port(x):
    return None if x is None else cache_values_from_jax(np.asarray(x), "cpu")


# ---------------------------------------------------------------------------
# the model: Engine and PagedContinuousEngine at head dim 64, G = 8
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def model():
    jcfg = jllama.ModelConfig(**SHAPE, dtype=jnp.float32)
    jparams = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    nparams = jax.tree.map(np.asarray, jparams)
    tparams = params_from_jax(nparams, device="cpu")
    prompt = np.random.default_rng(PROMPT_SEED).integers(
        0, SHAPE["vocab"], (B, S_PROMPT)).astype(np.int32)
    tcfg = tllama.ModelConfig(**SHAPE, dtype=torch.float32)
    return jcfg, tcfg, jparams, nparams, tparams, prompt


def test_params_from_jax_carries_the_head_dim_64_tree():
    """params_from_jax leaves a bf16 d = 64 tree as it is: the same leaves,
    shapes and values (the attention projections (dim, heads * 64))."""
    jparams = jllama.init_params(jax.random.PRNGKey(0),
                                 jllama.ModelConfig(**SHAPE))
    nparams = jax.tree.map(np.asarray, jparams)
    tparams = params_from_jax(nparams, device="cpu")
    want = jax.tree_util.tree_flatten_with_path(nparams)[0]
    got = {jax.tree_util.keystr(p): v for p, v in
           jax.tree_util.tree_flatten_with_path(
               tparams, is_leaf=lambda x: isinstance(x, torch.Tensor))[0]}
    assert len(got) == len(want)
    for path, leaf in want:
        t = got[jax.tree_util.keystr(path)]
        assert tuple(t.shape) == leaf.shape
        np.testing.assert_array_equal(_np(t), np.asarray(leaf, np.float32))
    assert tparams["layers"]["wq"].shape[-1] == SHAPE["n_heads"] * D
    assert tparams["layers"]["wq"].dtype == torch.bfloat16


def test_engine_int8_matches_jax(model):
    """Engine(cache_dtype="int8", weight_dtype="int8"): prefill_chunked in
    chunks of 8 (the second reads the first's int8 rows through B3) within
    5e-2 of JAX's logits, a teacher-forced decode step (the first token
    fed) within 5e-2 of JAX's logits, then greedy decode_scan steps (B6 and
    one-token B7 at G = 8) giving JAX's tokens."""
    jcfg, tcfg, jparams, _, tparams, prompt = model
    kw = dict(s_max=S_MAX, cache_dtype="int8", weight_dtype="int8")
    je = jserving.Engine(cfg=jcfg, **kw)
    te = tserving.Engine(cfg=tcfg, device="cpu", **kw)
    jl, jc = je.prefill_chunked(jparams, jnp.asarray(prompt), CHUNK)
    tl, tc = te.prefill_chunked(tparams, torch.from_numpy(prompt), CHUNK)
    np.testing.assert_allclose(_np(tl), _np(jl), **LOGITS_TOL)
    first = np.asarray(jnp.argmax(jl, -1).astype(jnp.int32))
    assert torch.argmax(tl, -1).tolist() == first.tolist()
    jdp, tdp = je.decode_params(jparams), te.decode_params(tparams)
    jstep, _ = jllama.decode_step(jdp, jc, jnp.asarray(first), jcfg)
    tstep, _ = tllama.decode_step(tdp, tc, torch.tensor(first), tcfg)
    np.testing.assert_allclose(_np(tstep), _np(jstep), **LOGITS_TOL)
    # decode_step advanced both caches by the first token: scan on
    jt, _ = je.decode_scan(jdp, jc, NEW, jnp.argmax(jstep, -1).astype(
        jnp.int32), jserving.SamplingParams(), jax.random.PRNGKey(0))
    tt, _ = te.decode_scan(tdp, tc, NEW, torch.argmax(tstep, -1).to(
        torch.int32))
    assert tt.tolist() == np.asarray(jt).tolist()


CONT_SHAPE = dict(SHAPE, vocab=96)
SPECS = [(40, 3), (100, 2)]


def _requests(pkg):
    rng = np.random.default_rng(5)
    return [pkg.Request(id=i, tokens=[int(t) for t in rng.integers(
        0, CONT_SHAPE["vocab"], n)], max_new=m)
        for i, (n, m) in enumerate(SPECS)]


@pytest.fixture(scope="module")
def f32_model():
    jcfg = jllama.ModelConfig(**CONT_SHAPE, dtype=jnp.float32)
    jparams = jllama.init_params(jax.random.PRNGKey(1), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              device="cpu")
    return jcfg, tllama.ModelConfig(**CONT_SHAPE, dtype=torch.float32), \
        jparams, tparams


@pytest.mark.parametrize("cache_dtype", ["int8", "float8_e4m3fn", "int4"])
def test_paged_interleaved_matches_jax(f32_model, cache_dtype):
    """PagedContinuousEngine with interleaved admission (chunks of 64
    tokens, so each admission's prompt runs through B7's multi-token runs
    at G = 8 x 64 rows a kv head) over an int8, fp8 or int4 pool of pages
    of 128: JAX's greedy tokens (a float32 model, as the port's scheduler
    tests compare engines)."""
    jcfg, tcfg, jparams, tparams = f32_model
    kw = dict(s_max=256, max_batch=2, cache_dtype=cache_dtype,
              page_size=128, pool_pages=7, prefill_chunk=64,
              interleave_admission=True)
    want = jserving.PagedContinuousEngine(
        jcfg, native_runtime=False, **kw).serve(jparams,
                                                _requests(jserving))
    got = tserving.PagedContinuousEngine(tcfg, device="cpu", **kw).serve(
        tparams, _requests(tserving))
    assert {i: r.tokens for i, r in got.items()} == {
        i: r.tokens for i, r in want.items()}


# ---------------------------------------------------------------------------
# B7 at JAX's d = 64 tiles
# ---------------------------------------------------------------------------


def _jax_plan(n_tok, h_kv, g, d, slot, itemsize, block_kv=4096,
              paged=False):
    """JAX decode_attention's split and tiles from its own _fit_run_tokens,
    _vmem_est and budget (decode.py:696-765)."""
    bounds = [(0, n_tok)]
    if n_tok > 1:
        fit = jdec._fit_run_tokens(h_kv, g, d, min(256, slot), itemsize)
        if fit < n_tok:
            bounds = [(i, min(i + fit, n_tok)) for i in range(0, n_tok, fit)]
    out = []
    for i, e in bounds:
        rows = g * (e - i)
        if paged:
            bkv = slot
            while bkv > 128 and jdec._vmem_est(h_kv, rows, d, bkv,
                                               itemsize) > jdec._VMEM_BUDGET:
                bkv = next((c for c in range(bkv - 128, 127, -128)
                            if slot % c == 0), 128)
        else:
            bkv = min(block_kv, slot)
            while bkv > 128 and jdec._vmem_est(h_kv, rows, d, bkv,
                                               itemsize) > jdec._VMEM_BUDGET:
                bkv //= 2
            while slot % bkv:
                bkv //= 2
        out.append((i, e, bkv))
    return out


# (run, h_kv, g, slot, itemsize, paged): TinyLlama's chunk sub-runs (4 kv
# heads of G = 8 over pages of 2048), a decode token, and smaller shapes
PLAN_CASES = [(256, 4, 8, 2048, 1, True), (107, 4, 8, 2048, 1, True),
              (1, 4, 8, 2048, 1, True), (1, 4, 8, 12288, 1, False),
              (256, 4, 8, 2048, 2, True), (1, 4, 8, 16384, 2, False),
              (250, 2, 8, 256, 1, True), (64, 4, 8, 2048, 1, True),
              (512, 8, 8, 2048, 1, True)]


def test_run_plan_at_head_dim_64_matches_jax():
    """decode_run_plan (through reference_block_kv and _fit_run_tokens) at
    d = 64 against JAX's rule, the worked TinyLlama numbers (a chunk of 256
    at 4 kv heads of G = 8: sub-runs of 107, 107 and 42 in tiles of 256,
    256 and 512, each routed to decode_run), and the d = 64 split differing
    from d = 128's at the same run."""
    for n, hk, g, slot, isz, paged in PLAN_CASES:
        got = tdec.decode_run_plan(n, hk, g, D, slot, isz, paged=paged)
        assert got == _jax_plan(n, hk, g, D, slot, isz, paged=paged), (
            n, hk, g, slot, isz, paged)
    plan = tdec.decode_run_plan(256, 4, 8, D, 2048, 1, paged=True)
    assert plan == [(0, 107, 256), (107, 214, 256), (214, 256, 512)]
    assert {tdec.decode_route(8 * (e - i), bkv, 2048)
            for i, e, bkv in plan} == {"decode_run"}
    assert tdec.decode_route(8, 2048, 2048) == "decode_attention"
    assert tdec.decode_run_plan(256, 4, 8, 128, 2048, 1, paged=True) != plan


def _cache_pair(rng, dtype, shape):
    """Random cache values of ``dtype`` (L, b or P, h_kv, slots, d), and
    their scales (L, b or P, h_kv, 1, slots), on both sides: JAX's eager
    quantize_kv of normal rows, carried over bit for bit."""
    x = rng.standard_normal((2,) + shape).astype(np.float32)
    vals, scales = [], []
    for i in range(2):
        q, s = jkv.quantize_kv(jnp.asarray(x[i]), dtype)
        vals.append(q)
        scales.append(None if s is None else s[..., None, :])
    j = vals + scales
    return j, [_port(a) for a in j]


def _decode_case(rng, dtype, paged, n_tok, mxu_int8=True, window=False):
    hk, g, page = 2, 8, 256
    lens = np.array([500, 37, 300], np.int32)
    if paged:
        j, t = _cache_pair(rng, dtype, (2, 7, hk, page, D))
        pt = np.array([[3, 1], [5, -1], [2, 6]], np.int32)
        extra_j = dict(page_table=jnp.asarray(pt))
        extra_t = dict(page_table=torch.from_numpy(pt))
    else:
        j, t = _cache_pair(rng, dtype, (2, 3, hk, 512, D))
        extra_j = extra_t = {}
    kw = dict(mxu_int8=mxu_int8)
    if window:
        kw.update(window_size=(200, -1), sink_tokens=4)
    shape = (3, n_tok, hk * g, D) if n_tok > 1 else (3, hk * g, D)
    q = rng.standard_normal(shape).astype(np.float32)
    jo, jl = jdec.decode_attention(
        jnp.asarray(q, jnp.bfloat16), j[0], j[1], jnp.asarray(lens), j[2],
        j[3], layer=jnp.int32(1), return_lse=True, **kw, **extra_j)
    to, tl = tdec.decode_attention(
        torch.from_numpy(q).to(torch.bfloat16), t[0], t[1],
        torch.from_numpy(lens), t[2], t[3], layer=1, return_lse=True, **kw,
        **extra_t)
    np.testing.assert_allclose(_np(to), _np(jo), **OUT_TOL)
    np.testing.assert_allclose(_np(tl), _np(jl), **LSE_TOL)


B7_CASES = ([(k, p, 1) for k in KINDS for p in (False, True)]
            + [(k, True, 250) for k in KINDS])


@pytest.mark.parametrize("dtype,paged,n_tok", B7_CASES,
                         ids=lambda x: str(x))
def test_b7_plain_at_head_dim_64_matches_jax(rng, dtype, paged, n_tok):
    """B7's plain version at d = 64 and G = 8 rows a kv head against JAX's
    decode_attention, in each cache kind (bf16; int8 and int4 on the s8
    path, whose P is requantized per JAX tile; fp8 on the cast path), one
    token dense and paged, and a paged run of 250 tokens that JAX splits
    into sub-runs of 217 and 33 at d = 64, each at its own tile."""
    _decode_case(rng, dtype, paged, n_tok)


def test_b7_plain_at_head_dim_64_window_and_cast(rng):
    """The same gate with a window of 200 and 4 sinks (int8, a one-token
    call and a run), and on the cast path (int8 under mxu_int8=False)."""
    _decode_case(rng, "int8", True, 1, window=True)
    _decode_case(rng, "int8", True, 250, window=True)
    _decode_case(rng, "int8", True, 1, mxu_int8=False)


# ---------------------------------------------------------------------------
# the one-token kernel's walk, decode_run's shared memory, B6's plan
# ---------------------------------------------------------------------------


# (cap, page or None, bkv, row bytes at d = 64, n_tok, left, sink)
TOKEN_PLANS = [
    (12288, None, 4096, 64, 1, -1, 0),     # int8, TinyLlama's dense slice
    (12288, None, 2048, 128, 1, -1, 0),    # bf16
    (16384, 2048, 2048, 32, 1, -1, 0),     # int4 pages
    (16384, 2048, 2048, 64, 1, 4096, 4),   # int8 pages, window and sinks
    (4096, None, 1024, 64, 4, 300, 4),     # a run of 4 (G = 8 at g = 2)
]


def _visible(length, n_tok, left, sink):
    if length <= 0:
        return set()
    first = max(length - n_tok - left, 0) if left >= 0 else 0
    return set(range(first, length)) | (
        set(range(min(sink, length))) if left >= 0 else set())


@pytest.mark.parametrize("plan", TOKEN_PLANS,
                         ids=lambda p: "-".join(map(str, p)))
def test_token_walk_at_head_dim_64(plan):
    """decode_token_span / decode_launch / decode_token_reads at d = 64
    row bytes (a span of ~32 KB of K: 512 int8 columns, 256 bf16, 1024
    int4): every visible column read once, nothing outside the sink tiles
    and the window band, no span past its tile or page."""
    cap, page, bkv, row_bytes, n_tok, left, sink = plan
    cluster, span = tdec.decode_token_span(bkv, row_bytes)
    assert span == min(bkv, max(bkv // 8, 32768 // row_bytes))
    launch = tdec.decode_launch("decode_attention", 4, 4, 8, cap, bkv,
                                n_tok, left, sink, row_bytes=row_bytes)
    assert (launch.cluster, launch.span) == (cluster, span)
    for length in sorted({n_tok, 37, bkv - 1, bkv + 1, cap // 3, cap}):
        reads = tdec.decode_token_reads(launch, length, n_tok, cap, bkv,
                                        left, sink)
        cols = [c for _, _, lo, hi in reads for c in range(lo, hi)]
        assert len(cols) == len(set(cols)), length
        want = _visible(length, n_tok, left, sink)
        assert want <= set(cols), length
        band = set(range(((max(length - n_tok - left, 0) if left >= 0
                           else 0) // bkv) * bkv, length))
        assert set(cols) <= band | (set(range(min(sink, length)))
                                    if left >= 0 else set()), length
        for _, _, lo, hi in reads:
            assert 0 < hi - lo <= span and lo // bkv == (hi - 1) // bkv
            if page is not None:
                assert lo // page == (hi - 1) // page


def test_decode_run_smem_at_both_head_dims():
    """decode_run_smem at d = 128 and 64 is csrc/decode_run_sm90.cu's
    Smem<S8>::BYTES (bf16 / cast, s8), within the 227 KB a block takes."""
    assert tdec.decode_run_smem(False) == tdec.decode_run_smem(False, 128) \
        == 224512
    assert tdec.decode_run_smem(True, 128) == 228608
    assert tdec.decode_run_smem(False, 64) == 118016
    assert tdec.decode_run_smem(True, 64) == 130304
    for s8 in (False, True):
        for d in (64, 128):
            assert tdec.decode_run_smem(s8, d) <= 232448


def _b6_bytes(t):
    return (t.view(torch.uint8) if t.dtype in (torch.bfloat16,
                                               torch.float8_e4m3fn)
            else t).numpy()


def _mem(ptr, ctype, count):
    return np.ctypeslib.as_array((ctype * count).from_address(ptr))


class _FakeB6:
    """Stands in for the d = 64 "cache_append" kernel: the quantizing kinds
    of csrc/cache_append.cu in Python over the plan's argument array, the
    head dim read off the row bytes and the kind."""

    def __init__(self):
        self.launches = 0

    def __call__(self, addr, stream):
        a = list((ctypes.c_longlong * tdec._A_COUNT).from_address(addr))
        name = {v: k for k, v in tdec._B6_KIND.items()}[a[tdec._A_KIND]]
        rb = a[tdec._A_ROW_BYTES]
        d = {"bfloat16": rb // 2, "int4": 2 * rb}.get(name, rb)
        nl, l0, b, n, h = (a[tdec._A_NL], a[tdec._A_LAYER0], a[tdec._A_B],
                           a[tdec._A_N], a[tdec._A_HKV])
        pool, page, n_pages = (a[tdec._A_POOL], a[tdec._A_PAGE],
                               a[tdec._A_NPAGES])
        pos = _mem(a[tdec._A_POS], ctypes.c_int32, b)
        pt = (_mem(a[tdec._A_PT], ctypes.c_int32, b * n_pages)
              if a[tdec._A_PT] else None)
        for t in range(2):
            st = a[tdec._A_ST + 4 * t:tdec._A_ST + 4 * t + 4]
            for li in range(nl):
                for ib in range(b):
                    for hh in range(h):
                        for it in range(n):
                            slot = int(pos[ib]) + it
                            if not 0 <= slot < a[tdec._A_CAP]:
                                continue
                            pg, off = ib, slot
                            if pt is not None:
                                pg = min(max(int(pt[ib * n_pages
                                                    + slot // page]), 0),
                                         pool - 1)
                                off = slot % page
                            drow = ((((l0 + li) * pool + pg) * h + hh)
                                    * page + off)
                            se = (li * st[0] + ib * st[1] + it * st[2]
                                  + hh * st[3])
                            raw = _mem(a[tdec._A_SRC + t] + 2 * se,
                                       ctypes.c_uint16, d).copy()
                            x = torch.from_numpy(raw.astype(np.int32)
                                                 << 16).view(torch.float32)
                            q, s = tkv.quantize_kv(x, name)
                            _mem(a[tdec._A_DST + t] + drow * rb,
                                 ctypes.c_uint8, rb)[:] = (
                                q.contiguous().view(torch.uint8).numpy())
                            if s is not None:
                                _mem(a[tdec._A_DSC + t] + 4 * drow,
                                     ctypes.c_float, 1)[0] = float(s)
        self.launches += 1


@pytest.mark.parametrize("dtype", KINDS)
@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_rows_plan_takes_head_dim_64(monkeypatch, rng, layout, dtype):
    """B6's host plan on a d = 64 cache: it holds the d = 64 kernel, and its
    argument array (row bytes 128, 64 or 32), read by a plain emulation of
    the kernel, writes what the plain path writes, bit for bit; rows of
    another head dim raise."""
    fake = _FakeB6()
    monkeypatch.setitem(_build.KERNELS, "cache_append_d64", fake)

    def make():
        if layout == "dense":
            return tkv.KVCache.init(2, 2, 256, 2, D, dtype, device="cpu")
        c = tkv.PagedKVCache.init(2, 2, 5, 128, 2, 2, D, dtype, device="cpu")
        c.page_table.copy_(torch.tensor([[3, 1], [2, -1]]))
        return c

    got, want = make(), make()
    plan = tdec._RowsPlan(got)
    plan.stream = lambda index: 0
    assert plan.kernel is fake and plan.d == D
    k = torch.from_numpy(rng.standard_normal((2, 2, 5, D)).astype(
        np.float32)).bfloat16().transpose(1, 2)
    v = torch.from_numpy(rng.standard_normal((2, 2, 5, D)).astype(
        np.float32)).bfloat16().transpose(1, 2)
    pos = torch.tensor([125, -5], dtype=torch.int32)
    plan.launch(1, k, v, pos, None)
    tdec.cache_append_rows_plain(want, 1, k, v, pos)
    assert fake.launches == 1
    for name in ("k", "v", "k_scale", "v_scale"):
        if getattr(got, name) is not None:
            np.testing.assert_array_equal(_b6_bytes(getattr(got, name)),
                                          _b6_bytes(getattr(want, name)))
    with pytest.raises(ValueError, match=f"d={D}"):
        plan.launch(1, torch.zeros(2, 5, 2, 128, dtype=torch.bfloat16),
                    torch.zeros(2, 5, 2, 128, dtype=torch.bfloat16), pos,
                    None)


# ---------------------------------------------------------------------------
# which head dims each entry point takes (meta tensors stand in for the
# card's: the wrappers take their kernel path and raise before a launch)
# ---------------------------------------------------------------------------


def _meta(*shape, dtype=torch.bfloat16):
    return torch.zeros(shape, dtype=dtype, device="meta")


def test_head_dims_of_each_entry_point():
    """B1, B3, B6, both B7 kernels and the backward (B2a, B2b, B5) take
    head dims 64 and 128, every other entry point 128; each picks its own
    kernel (and launch count) at each head dim."""
    both = ("flash_fwd_causal_self", "flash_fwd_pos", "cache_append",
            "decode_attention", "decode_run", "flash_bwd_dq",
            "flash_bwd_dkv", "flash_bwd_fused")
    for name in _build.KERNELS:
        if name.endswith("_d64"):
            continue
        want = (64, 128) if name in both else (128,)
        assert _build.head_dims(name) == want, name
        for d in want:
            k = _build.kernel(name, d)
            assert k.head_dim == d and k.symbol == _build.KERNELS[name].symbol
        if 64 in want:
            assert _build.kernel(name, 64) is not _build.kernel(name, 128)
            assert _build.kernel(name, 64).lib == f"{k.source}:d64"


@pytest.mark.parametrize("d", [32, 96])
def test_serving_kernels_raise_at_other_head_dims(d):
    """B1, B3 (at one chunk, two position chunks and with the features),
    B6, B7 and the backward (B2a, B2b, B5) raise NotImplementedError naming
    64 and 128 at another head dim, before any launch."""
    msg = "head_dim 64 or 128"
    with pytest.raises(NotImplementedError, match=f"B1.*{msg}"):
        tflash.flash_fwd_causal_self(_meta(1, 128, 8, d), _meta(1, 128, 1, d),
                                     _meta(1, 128, 1, d), scale=1.0)
    with pytest.raises(NotImplementedError, match=f"B3.*{msg}"):
        tflash.flash_fwd_pos(_meta(1, 128, 8, d), _meta(1, 1, 256, d),
                             _meta(1, 1, 256, d), q_start=128, causal=True,
                             scale=1.0)
    with pytest.raises(NotImplementedError, match=f"B7.*{msg}"):
        tdec.decode_attention_core(
            _meta(1, 1, 8, d), None, _meta(1, 1, 1, 256, d),
            _meta(1, 1, 1, 256, d), None, None,
            torch.ones(1, dtype=torch.int32, device="meta"), layer=0,
            block_kv=256, scale=1.0)
    cache = tkv.KVCache.init(1, 1, 128, 1, d, "int8", device="cpu")
    with pytest.raises(NotImplementedError, match=f"B6.*{msg}"):
        tdec._RowsPlan(cache)
    kv = _meta(1, 1, 512, d)
    with pytest.raises(NotImplementedError, match=f"B3.*{msg}"):
        tflash.flash_fwd_pos(_meta(1, 256, 8, d), kv, kv, scale=1.0,
                             causal=True,
                             pos=tflash.Positions((0, 1 << 20),
                                                  (0, 1 << 20), 1))
    with pytest.raises(NotImplementedError, match=f"B3.*{msg}"):
        tflash.flash_fwd_pos(
            _meta(1, 256, 8, d), kv, kv, q_start=256, causal=True, scale=1.0,
            features=tflash.Features(slopes=torch.ones(8, device="meta")))
    q, k = _meta(1, 256, 8, d), _meta(1, 256, 1, d)
    lse = torch.zeros((1, 8, 256), device="meta")
    for fn in (tflash.flash_bwd_dq, tflash.flash_bwd_dkv,
               tflash.flash_bwd_fused):
        with pytest.raises(NotImplementedError, match=f"backward.*{msg}"):
            fn(q, k, k, q, lse, lse, scale=1.0)


def test_other_kernels_raise_at_head_dim_64():
    """B4, sage (its quantizers and B8a-c), the block-sparse kernels
    (B9a-c) and B3 over quantized K/V at two position chunks or with the
    features raise NotImplementedError naming head dim 128 at d = 64."""
    q, k, v = _meta(1, 256, 8, D), _meta(1, 256, 1, D), _meta(1, 256, 1, D)
    msg = "head_dim 128, got d=64"
    with pytest.raises(NotImplementedError, match=f"B4.*{msg}"):
        tflash.flash_fwd_static(q, k, v, scale=1.0, causal=True,
                                window_size=(64, -1))
    with pytest.raises(NotImplementedError,
                       match=f"sage quantization.*{msg}"):
        tsage.sage_quant_kv(k, v, torch.zeros(1, 1, D, device="meta"))
    q8, k8 = (torch.zeros(t.shape, dtype=torch.int8, device="meta")
              for t in (q, k))
    qs, ks = torch.zeros((1, 8, 256), device="meta"), torch.zeros(
        (1, 1, 256), device="meta")
    for fn in (tsage.sage_fwd_tri, tsage.sage_fwd_rect):
        with pytest.raises(NotImplementedError, match=f"sage.*{msg}"):
            fn(q8, qs, k8, ks, k8, ks)
    with pytest.raises(NotImplementedError, match=f"sparse.*{msg}"):
        tsp.block_sparse_attention(q, k, v, np.ones((4, 4), bool),
                                   block_q=64, block_kv=64)
    kv8 = _meta(1, 1, 512, D, dtype=torch.int8)
    sc = torch.zeros((1, 1, 512), device="meta")
    with pytest.raises(NotImplementedError,
                       match=f"B3.*quantized K/V.*position chunks.*{msg}"):
        tflash.flash_fwd_pos(q, kv8, kv8, sc, sc, scale=1.0, causal=True,
                             pos=tflash.Positions((0, 1 << 20), (0, 1 << 20),
                                                  1))
    with pytest.raises(NotImplementedError,
                       match=f"B3.*quantized K/V.*features.*{msg}"):
        tflash.flash_fwd_pos(
            q, kv8, kv8, sc, sc, q_start=256, causal=True, scale=1.0,
            features=tflash.Features(slopes=torch.ones(8, device="meta")))
