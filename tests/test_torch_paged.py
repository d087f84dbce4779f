"""The paged cache and multi-token runs of the PyTorch port against the JAX
package: PagedKVCache, kernel B6 (cache_append) and kernel B7
(decode_attention) through a page table, B7 over multi-token runs with
JAX's run split and tiles, and the model's paged decode_step and
decode_multi_step. The port runs its plain versions on the CPU, JAX its
Pallas kernels in interpret mode, on the same numpy inputs.

Tolerances:
* cache contents (a copy): exact;
* decode attention out 2e-2 plus one bf16 ulp (2^-7) of the value, lse
  1e-4 in fp32 (as tests/test_torch_decode.py: integer products exact on
  both sides, exp2 and the tile sums differ in the last fp32 bits, which
  can move one P level of 1/127 of a row's max or the output's bf16
  rounding by one ulp; the int8 caches here reach outputs of 8);
* paging is indexing: the port's paged and dense versions at the same
  tile are equal bit for bit;
* model logits 5e-2 (a bf16 model: bf16 roundings of activations at the
  same places on both sides, fp32 sums in another order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from long_context_attention_tpu.models import llama as jllama
from long_context_attention_tpu.ops import decode as jdec
from long_context_attention_tpu.ops import kv_cache as jkv
from long_context_attention_tpu_torch.models import llama as tllama
from long_context_attention_tpu_torch.ops import decode as tdec
from long_context_attention_tpu_torch.ops import kv_cache as tkv
from long_context_attention_tpu_torch.utils.convert import params_from_jax

torch.set_num_threads(1)

L, HKV, G, D = 2, 2, 2, 32
PAGE, N_PAGES, POOL = 128, 4, 12
OUT_TOL = dict(atol=2e-2, rtol=2.0 ** -7)
LSE_TOL = dict(atol=1e-4, rtol=0)
LOGIT_TOL = dict(atol=5e-2, rtol=0)
SHAPE = dict(vocab=96, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
             head_dim=32, ffn_hidden=128, layout="basic")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _pair(a, dtype):
    """The same values as a JAX array and a torch tensor (bf16 through
    float32, int8 and int32 as they are)."""
    a = np.asarray(a)
    if dtype == "bfloat16":
        return (jnp.asarray(a, jnp.float32).astype(jnp.bfloat16),
                torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16))
    return jnp.asarray(a), torch.from_numpy(a.copy())


def _pools(rng, dtype, pool=POOL, page=PAGE, hkv=HKV, d=D, layers=L):
    """Random pools (values, and scales for int8) on both sides."""
    shape = (layers, pool, hkv, page, d)
    if dtype == "int8":
        vals = [rng.integers(-127, 128, shape).astype(np.int8)
                for _ in range(2)]
        scales = [(rng.random((layers, pool, hkv, 1, page)) / 16 + 1e-3)
                  .astype(np.float32) for _ in range(2)]
    else:
        vals = [rng.standard_normal(shape).astype(np.float32)
                for _ in range(2)]
        scales = []
    return ([_pair(v, dtype) for v in vals]
            + [_pair(s, "float32") for s in scales])


def _table(rows):
    """(b, N_PAGES) page table from each row's pool pages, -1 after."""
    pt = np.full((len(rows), N_PAGES), -1, np.int32)
    for r, pages in enumerate(rows):
        pt[r, :len(pages)] = pages
    return pt


def _dense(pool, pt, scales=False):
    """The dense layered cache holding each row's pages in logical order
    (zeros where the table has -1)."""
    pool = np.asarray(pool)
    b = pt.shape[0]
    page = pool.shape[-1] if scales else pool.shape[3]
    out = np.zeros(pool.shape[:1] + (b,) + pool.shape[2:3]
                   + ((1, N_PAGES * page) if scales
                      else (N_PAGES * page, pool.shape[-1])), pool.dtype)
    for r in range(b):
        for i, p in enumerate(pt[r]):
            if p < 0:
                continue
            if scales:
                out[:, r, :, :, i * page:(i + 1) * page] = pool[:, p]
            else:
                out[:, r, :, i * page:(i + 1) * page] = pool[:, p]
    return out


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_paged_kv_cache_matches_jax(dtype):
    """PagedKVCache.init: the same pools, page table and length as JAX's,
    and the same dtype, page size and logical capacity; an int4 pool packs
    two values a byte (tests/test_torch_quant_cache.py holds it to
    JAX's)."""
    j = jkv.PagedKVCache.init(L, 3, POOL, PAGE, N_PAGES, HKV, D, dtype)
    t = tkv.PagedKVCache.init(L, 3, POOL, PAGE, N_PAGES, HKV, D, dtype,
                              device="cpu")
    for name in ("k", "v", "k_scale", "v_scale", "page_table", "length"):
        a, b = getattr(j, name), getattr(t, name)
        if a is None:
            assert b is None, name
            continue
        assert tuple(b.shape) == a.shape, name
        np.testing.assert_array_equal(_np(b), _np(a))
    assert (t.dtype, t.page_size, t.s_max) == (j.dtype, j.page_size,
                                               j.s_max)
    assert t.k.dtype == (torch.int8 if dtype == "int8" else torch.bfloat16)
    p4 = tkv.PagedKVCache.init(L, 3, POOL, PAGE, N_PAGES, HKV, D, "int4",
                               device="cpu")
    assert p4.dtype == "int4" and p4.k.dtype == torch.uint8
    assert p4.k.shape == (L, POOL, HKV, PAGE, D // 2)


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_paged_append_straddles_pages_matches_jax(rng, dtype):
    """A 5-token run crossing a page boundary lands token by token in its
    owner pages; a row at -n writes nothing; a run past the row's pages
    writes its live slots through the -1 entry into the scratch page 0, as
    JAX's clamped index map does; other layers stay. Equal to JAX's pool,
    and the paged append gathered equals the dense append."""
    n, layer = 5, 1
    pools = _pools(rng, dtype)
    pt = _table([[3, 7], [4, 5, 6], [8]])
    pos = np.array([PAGE - 2, -n, PAGE - 3], np.int32)  # row 2 runs past
    new = [rng.standard_normal((3, HKV, n, D)).astype(np.float32)
           for _ in range(2)]
    jk, jks = jkv.quantize_kv(jnp.asarray(new[0]), dtype)
    jv, jvs = jkv.quantize_kv(jnp.asarray(new[1]), dtype)
    tk, tks = tkv.quantize_kv(torch.from_numpy(new[0]), dtype)
    tv, tvs = tkv.quantize_kv(torch.from_numpy(new[1]), dtype)
    j_args = [p[0] for p in pools]
    t_args = [p[1] for p in pools]
    before = [t.clone() for t in t_args]
    jres = jdec.cache_append(j_args[0], j_args[1], jk, jv, jnp.asarray(pos),
                             *j_args[2:], jks, jvs, layer=jnp.int32(layer),
                             page_table=jnp.asarray(pt))
    dense = [torch.from_numpy(_dense(_np(t), pt, i >= 2)).to(t.dtype)
             for i, t in enumerate(t_args)]
    tres = tdec.cache_append(t_args[0], t_args[1], tk, tv,
                             torch.from_numpy(pos), *t_args[2:], tks, tvs,
                             layer=layer, page_table=torch.from_numpy(pt))
    assert tres[0] is t_args[0] and len(tres) == len(jres)
    for a, b in zip(jres, tres):
        np.testing.assert_array_equal(_np(b), _np(a))
    # token t of row 0 in its owner page
    for t in range(n):
        s = PAGE - 2 + t
        np.testing.assert_array_equal(
            _np(t_args[0][layer, pt[0, s // PAGE], :, s % PAGE]),
            _np(tk[0, :, t]))
    np.testing.assert_array_equal(_np(t_args[0][0]), _np(before[0][0]))
    for p in (4, 5, 6):  # the skipped row's pages
        np.testing.assert_array_equal(_np(t_args[1][layer, p]),
                                      _np(before[1][layer, p]))
    # paging is indexing: the dense append of the same run, gathered
    tdec.cache_append(dense[0], dense[1], tk, tv, torch.from_numpy(pos),
                      *dense[2:], tks, tvs, layer=layer)
    live = np.zeros((3, N_PAGES * PAGE), bool)
    for r in range(3):
        live[r, :(pt[r] >= 0).sum() * PAGE] = True
    for i, (t, d) in enumerate(zip(t_args, dense)):
        got = _dense(_np(t), pt, i >= 2)
        want = _np(d)
        m = live[None, :, None, None, :] if i >= 2 else live[None, :, None,
                                                            :, None]
        np.testing.assert_array_equal(np.where(m, got, 0),
                                      np.where(m, want, 0))


@pytest.mark.parametrize("window", [False, True], ids=["full", "window"])
@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_paged_decode_matches_jax(rng, dtype, window):
    """decode_attention through the page table (rows of 1, 300 and 500
    tokens over shuffled pages, -1 past the prefix), with window 100 and
    4 sinks or without, against JAX's paged kernel; and the port's paged
    version equals its dense version at the same tile bit for bit."""
    pools = _pools(rng, dtype)
    pt = _table([[9], [2, 11, 5], [7, 1, 10, 3]])
    lens = np.array([1, 300, 500], np.int32)
    q = rng.standard_normal((3, HKV * G, D)).astype(np.float32)
    kw = dict(window_size=(100, -1), sink_tokens=4) if window else {}
    j_args = [p[0] for p in pools]
    t_args = [p[1] for p in pools]
    jo, jl = jdec.decode_attention(
        jnp.asarray(q, jnp.bfloat16), j_args[0], j_args[1],
        jnp.asarray(lens), *j_args[2:], layer=jnp.int32(1), return_lse=True,
        page_table=jnp.asarray(pt), **kw)
    tq = torch.from_numpy(q).to(torch.bfloat16)
    to, tl = tdec.decode_attention(
        tq, t_args[0], t_args[1], torch.from_numpy(lens), *t_args[2:],
        layer=1, return_lse=True, page_table=torch.from_numpy(pt), **kw)
    assert to.shape == (3, HKV * G, D) and to.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(to), _np(jo), **OUT_TOL)
    np.testing.assert_allclose(_np(tl), _np(jl), **LSE_TOL)
    dense = [torch.from_numpy(_dense(_np(t), pt, i >= 2)).to(t.dtype)
             for i, t in enumerate(t_args)]
    do, dl = tdec.decode_attention(tq, dense[0], dense[1],
                                   torch.from_numpy(lens), *dense[2:],
                                   layer=1, return_lse=True, block_kv=PAGE,
                                   **kw)
    assert torch.equal(do, to) and torch.equal(dl, tl)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_multi_token_decode_matches_jax(rng, paged):
    """A 200-token run at the serving model's 8 kv heads x 2 x 128 over an
    int8 cache, window 300 and 4 sinks: JAX splits it into sub-runs of 176
    and 24 (each its own tile), token i of row b sees its own causal and
    window bounds. Out and lse against JAX's, and the split and tiles
    equal."""
    hkv, g, d, n = 8, 2, 128, 200
    lens = np.array([512, 230], np.int32)
    kw = dict(window_size=(300, -1), sink_tokens=4)
    if paged:
        pools = _pools(rng, "int8", pool=6, page=256, hkv=hkv, d=d,
                       layers=1)
        pt = np.array([[4, 2], [5, -1]], np.int32)
        j_args = [p[0] for p in pools]
        t_args = [p[1] for p in pools]
        extra_j = dict(page_table=jnp.asarray(pt))
        extra_t = dict(page_table=torch.from_numpy(pt))
        slot = 256
    else:
        pools = _pools(rng, "int8", pool=2, page=512, hkv=hkv, d=d,
                       layers=1)
        j_args = [p[0] for p in pools]
        t_args = [p[1] for p in pools]
        extra_j = extra_t = {}
        slot = 512
    plan = tdec.decode_run_plan(n, hkv, g, d, slot, 1, paged=paged)
    assert [(i, e) for i, e, _ in plan] == [(0, 176), (176, 200)]
    q = rng.standard_normal((2, n, hkv * g, d)).astype(np.float32)
    jo, jl = jdec.decode_attention(
        jnp.asarray(q, jnp.bfloat16), j_args[0], j_args[1],
        jnp.asarray(lens), *j_args[2:], layer=jnp.int32(0), return_lse=True,
        **kw, **extra_j)
    to, tl = tdec.decode_attention(
        torch.from_numpy(q).to(torch.bfloat16), t_args[0], t_args[1],
        torch.from_numpy(lens), *t_args[2:], layer=0, return_lse=True, **kw,
        **extra_t)
    assert to.shape == (2, n, hkv * g, d) and tl.shape == (2, hkv * g, n)
    np.testing.assert_allclose(_np(to), _np(jo), **OUT_TOL)
    np.testing.assert_allclose(_np(tl), _np(jl), **LSE_TOL)


def _jax_plan(n_tok, h_kv, g, d, slot, itemsize, block_kv=4096,
              paged=False):
    """JAX decode_attention's split and tiles, written out from its own
    _fit_run_tokens, _vmem_est and budget (decode.py:696-765)."""
    bounds = [(0, n_tok)]
    if n_tok > 1:
        fit = jdec._fit_run_tokens(h_kv, g, d, min(256, slot), itemsize)
        if fit < n_tok:
            bounds = [(i, min(i + fit, n_tok))
                      for i in range(0, n_tok, fit)]
    out = []
    for i, e in bounds:
        G_ = g * (e - i)
        if paged:
            bkv = slot
            while bkv > 128 and jdec._vmem_est(h_kv, G_, d, bkv, itemsize) \
                    > jdec._VMEM_BUDGET:
                bkv = next((c for c in range(bkv - 128, 127, -128)
                            if slot % c == 0), 128)
        else:
            bkv = min(block_kv, slot)
            while bkv > 128 and jdec._vmem_est(h_kv, G_, d, bkv, itemsize) \
                    > jdec._VMEM_BUDGET:
                bkv //= 2
            while slot % bkv:
                bkv //= 2
        out.append((i, e, bkv))
    return out


# (run length, cache itemsize, slot axis, paged) at the serving model's 8
# kv heads x 2 x 128, and smaller shapes
PLAN_CASES = [(256, 1, 2048, True), (64, 1, 2048, True), (1, 1, 2048, True),
              (256, 2, 2048, True), (1, 2, 2048, True), (256, 1, 16384, False),
              (1, 1, 16384, False), (1, 2, 16384, False), (512, 1, 2048, True),
              (176, 1, 3200, True), (1000, 2, 4096, False),
              (7, 1, 128, True)]


def test_run_plan_matches_jax():
    """The port's split of a run and its tiles (decode_run_plan, through
    reference_block_kv) against JAX's rule over a table of shapes, and the
    worked numbers at the serving model's shape (page 2048): int8 256 ->
    176 + 80 in tiles 256, 512; int8 64 -> 512; int8 1 -> 2048; bf16 256
    -> 160 + 96 in tiles 256, 256; bf16 1 -> 1024 (two tiles a page)."""
    for n, isz, slot, paged in PLAN_CASES:
        for h_kv, g, d in ((8, 2, 128), (2, 2, 32), (4, 4, 64)):
            assert tdec.decode_run_plan(n, h_kv, g, d, slot, isz,
                                        paged=paged) == _jax_plan(
                n, h_kv, g, d, slot, isz, paged=paged), (n, isz, slot,
                                                         h_kv, g, d)

    def worked(n, isz):
        return [(e - i, bkv) for i, e, bkv in tdec.decode_run_plan(
            n, 8, 2, 128, 2048, isz, paged=True)]

    assert worked(256, 1) == [(176, 256), (80, 512)]
    assert worked(64, 1) == [(64, 512)]
    assert worked(1, 1) == [(1, 2048)]
    assert worked(256, 2) == [(160, 256), (96, 256)]
    assert worked(1, 2) == [(1, 1024)]
    assert tdec.reference_block_kv(4096, 2048, 8, 2, 128, 2,
                                   paged=True) == 1024


def _model(dtype=torch.bfloat16):
    jcfg = jllama.ModelConfig(**SHAPE)
    tcfg = tllama.ModelConfig(**SHAPE, dtype=dtype)
    jparams = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              device="cpu")
    return jcfg, tcfg, jparams, tparams


def _paged_copy(dense, pt, pool_pages):
    """A PagedKVCache with the dense cache's content at the table's pages."""
    page = PAGE
    p = tkv.PagedKVCache.init(SHAPE["n_layers"], pt.shape[0], pool_pages,
                              page, pt.shape[1], SHAPE["n_kv_heads"],
                              SHAPE["head_dim"], dense.dtype, device="cpu")
    for r in range(pt.shape[0]):
        for i, pg in enumerate(pt[r]):
            if pg < 0:
                continue
            sl = slice(i * page, (i + 1) * page)
            p.k[:, pg] = dense.k[:, r, :, sl]
            p.v[:, pg] = dense.v[:, r, :, sl]
            if p.k_scale is not None:
                p.k_scale[:, pg] = dense.k_scale[:, r, :, :, sl]
                p.v_scale[:, pg] = dense.v_scale[:, r, :, :, sl]
    p.page_table.copy_(torch.from_numpy(pt))
    p.length.copy_(dense.length)
    return p


def test_paged_decode_step_matches_dense():
    """decode_step over a PagedKVCache equals the same step over a dense
    KVCache of the same logical content, logits and appended K/V bit for
    bit (the dense cache is one page long, so both use the page's tile),
    and the lengths advance alike."""
    _, tcfg, _, tparams = _model()
    rng = np.random.default_rng(2)
    b, n0 = 2, 100
    dense = tkv.KVCache.init(SHAPE["n_layers"], b, PAGE, SHAPE["n_kv_heads"],
                             SHAPE["head_dim"], "int8", device="cpu")
    kv = [torch.from_numpy(rng.standard_normal(
        (b, n0, SHAPE["n_kv_heads"], SHAPE["head_dim"])).astype(np.float32))
        for _ in range(2)]
    for li in range(SHAPE["n_layers"]):
        dense.write_prompt(li, *kv)
    dense.advance(n0)
    pt = np.array([[3], [1]], np.int32)
    paged = _paged_copy(dense, pt, 5)
    tok = torch.tensor([3, 7], dtype=torch.int32)
    ld, _ = tllama.decode_step(tparams, dense, tok, tcfg)
    lp, _ = tllama.decode_step(tparams, paged, tok, tcfg)
    assert torch.equal(ld, lp)
    assert paged.length.tolist() == dense.length.tolist() == [n0 + 1] * b
    for r in range(b):
        assert torch.equal(paged.k[:, pt[r, 0], :, n0], dense.k[:, r, :, n0])


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_decode_multi_step_matches_jax(paged):
    """decode_multi_step: an 8-token run against a bf16 cache (dense, or
    paged over two pages per row) gives JAX's logits; with last_index=5
    only that position's logits, equal to the full run's row 5."""
    jcfg, tcfg, jparams, tparams = _model()
    toks = np.array(jax.random.randint(jax.random.PRNGKey(1), (2, 8), 0,
                                         SHAPE["vocab"]), np.int32)
    hkv, hd = SHAPE["n_kv_heads"], SHAPE["head_dim"]

    def caches():
        if paged:
            pt = np.array([[2, 4], [3, 1]], np.int32)
            j = dataclasses.replace(
                jkv.PagedKVCache.init(2, 2, 5, PAGE, 2, hkv, hd, "bfloat16"),
                page_table=jnp.asarray(pt))
            t = tkv.PagedKVCache.init(2, 2, 5, PAGE, 2, hkv, hd, "bfloat16",
                                      device="cpu")
            t.page_table.copy_(torch.from_numpy(pt))
            return j, t
        return (jkv.KVCache.init(2, 2, 256, hkv, hd, "bfloat16"),
                tkv.KVCache.init(2, 2, 256, hkv, hd, "bfloat16",
                                 device="cpu"))

    jc, tc = caches()
    jfull, _ = jllama.decode_multi_step(jparams, jc, jnp.asarray(toks), jcfg)
    tfull, tc = tllama.decode_multi_step(tparams, tc,
                                         torch.from_numpy(toks), tcfg)
    assert tfull.shape == (2, 8, SHAPE["vocab"])
    np.testing.assert_allclose(_np(tfull), _np(jfull), **LOGIT_TOL)
    assert tc.length.tolist() == [8, 8]
    _, tc2 = caches()
    one, _ = tllama.decode_multi_step(tparams, tc2, torch.from_numpy(toks),
                                      tcfg, last_index=5)
    assert torch.equal(one[:, 0], tfull[:, 5])


def _entry_arity(source: str, symbol: str) -> int:
    """The parameter count of an extern "C" entry point in a csrc source."""
    from long_context_attention_tpu_torch.ops import _build

    text = (_build.CSRC / source).read_text()
    start = text.index(f"{symbol}(") + len(symbol) + 1
    depth, n, i = 1, 1, start
    while depth:
        c = text[i]
        depth += c == "("
        depth -= c == ")"
        n += c == "," and depth == 1
        i += 1
    return n


@pytest.mark.parametrize("name", ["cache_append", "decode_attention",
                                  "decode_run"])
def test_entry_point_takes_the_bound_arguments(name):
    """B6 and B7 (both its kernels) bind as many ctypes arguments as their
    C entry points take (the page table added one to each)."""
    from long_context_attention_tpu_torch.ops import _build

    k = _build.KERNELS[name]
    assert len(k.argtypes) == _entry_arity(k.source, k.symbol)
