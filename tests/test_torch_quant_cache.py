"""The fp8 and int4 KV caches of the PyTorch port against the JAX package,
op by op, on the same numpy inputs: the quantizers, int4's packing, the
caches' writes, kernel B6's and B7's plain versions (the dequant-cast path
for fp8, int8 and int4, int4 on the s8 path, ALiBi, kv_splits, paged fp8)
and B3's plain version over fp8 and int4 K/V, against JAX's Pallas kernels
in interpret mode. JAX's caches are carried over with
``cache_values_from_jax`` (fp8 by its bytes, int4 widened and packed).

Tolerances:
* the quantizers, int4's packing and every cache write: exact (fp8 bytes,
  int4 values, fp32 scales);
* decode attention, bf16 out 2e-2 / lse 1e-4 (tests/test_torch_decode.py):
  the widened values are exact on both sides, the fp32 sums run in
  another order (and the s8 path's requantization of P may move one level
  at a .5 boundary);
* B3 over fp8 / int4 K/V, bf16 out 2e-2 / lse 1e-4: the same widened
  values and scales, fp32 sums in another order before the bf16 output.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from long_context_attention_tpu.ops import decode as jdec
from long_context_attention_tpu.ops import flash as jflash
from long_context_attention_tpu.ops import kv_cache as jkv
from long_context_attention_tpu_torch.ops import decode as tdec
from long_context_attention_tpu_torch.ops import flash as tflash
from long_context_attention_tpu_torch.ops import kv_cache as tkv
from long_context_attention_tpu_torch.utils.convert import (
    cache_values_from_jax)

torch.set_num_threads(1)

L, B, HKV, G, D = 2, 3, 2, 2, 32
H = HKV * G
QUANT = ("int8", "int4", "float8_e4m3fn")
OUT_TOL = dict(atol=2e-2, rtol=0)
LSE_TOL = dict(atol=1e-4, rtol=0)
SLOPES = np.array([0.5, 0.25, 0.125, 0.0625], np.float32)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _port(x):
    """A JAX cache array in the port's storage form, on the CPU."""
    return None if x is None else cache_values_from_jax(np.asarray(x), "cpu")


def _bytes(t):
    """Stored values as comparable integers (fp8 by its bytes)."""
    return (t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn
            else t).numpy()


def _same_storage(got, want_jax):
    """The port's stored tensor equals JAX's, carried over, bit for bit."""
    want = _port(want_jax)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(_bytes(got), _bytes(want))


def _filled(rng, s_max, dtype):
    """A layered JAX cache of random tokens and its port form (k, v, k
    scales, v scales)."""
    jc = jkv.KVCache.init(L, B, s_max, HKV, D, dtype)
    for layer in range(L):
        k = rng.standard_normal((B, s_max, HKV, D)).astype(np.float32)
        v = rng.standard_normal((B, s_max, HKV, D)).astype(np.float32)
        jc = jc.write_prompt(layer, jnp.asarray(k), jnp.asarray(v))
    return jc, [_port(x) for x in (jc.k, jc.v, jc.k_scale, jc.v_scale)]


# ---------------------------------------------------------------------------
# the quantizers and the caches
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", QUANT)
def test_quantize_kv_bit_for_bit(rng, dtype):
    """quantize_kv against JAX's: the same fp8 bytes and int4 values (the
    port's packed), the same scales; zero rows (the 1e-6 floor), values at
    half-level boundaries and a row whose absmax is one huge outlier; and
    dequantize_kv's values."""
    x = rng.standard_normal((4, 5, 64)).astype(np.float32) * 3
    x[0, 0] = 0.0
    x[0, 1] = np.arange(64, dtype=np.float32) / 63 * 7.5 - 3.75  # .5 steps
    x[0, 2, 3] = 1e4
    jq, js = jkv.quantize_kv(jnp.asarray(x), dtype)
    tq, ts = tkv.quantize_kv(torch.from_numpy(x), dtype)
    _same_storage(tq, jq)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        _np(tkv.dequantize_kv(tq, ts, torch.float32)),
        _np(jkv.dequantize_kv(jq, js, jnp.float32)))


def test_pack_int4_round_trip(rng):
    """pack_int4 / unpack_int4: a round trip of every value in [-8, 7];
    element 2i in the low nibble, 2i + 1 in the high one, two's
    complement."""
    q = torch.from_numpy(rng.integers(-8, 8, (3, 7, 32)).astype(np.int8))
    p = tkv.pack_int4(q)
    assert p.dtype == torch.uint8 and p.shape == (3, 7, 16)
    assert torch.equal(tkv.unpack_int4(p), q)
    one = tkv.pack_int4(torch.tensor([-1, 2, 7, -8], dtype=torch.int8))
    assert one.tolist() == [0x2F, 0x87]


@pytest.mark.parametrize("dtype", ["int4", "float8_e4m3fn"])
def test_kv_cache_write_and_append_match_jax(rng, dtype):
    """KVCache.init and write_prompt (two segments) as JAX's, then B6's
    plain version appends one token per row (a skipped row, the last slot)
    and a run of three: every stored array equal to JAX's."""
    s_max = 128
    jc = jkv.KVCache.init(L, B, s_max, HKV, D, dtype)
    tc = tkv.KVCache.init(L, B, s_max, HKV, D, dtype, device="cpu")
    assert tc.dtype == jc.dtype == dtype and tc.s_max == s_max
    for start, s in ((0, 40), (40, 30)):
        k = rng.standard_normal((B, s, HKV, D)).astype(np.float32)
        v = rng.standard_normal((B, s, HKV, D)).astype(np.float32)
        jc = jc.write_prompt(1, jnp.asarray(k), jnp.asarray(v), start)
        tc.write_prompt(1, torch.from_numpy(k), torch.from_numpy(v), start)
    for n, pos in ((1, [5, -1, s_max - 1]), (3, [70, -3, s_max - 2])):
        k = rng.standard_normal((B, HKV, n, D)).astype(np.float32)
        v = rng.standard_normal((B, HKV, n, D)).astype(np.float32)
        jk, jks = jkv.quantize_kv(jnp.asarray(k), dtype)
        jv, jvs = jkv.quantize_kv(jnp.asarray(v), dtype)
        tk, tks = tkv.quantize_kv(torch.from_numpy(k), dtype)
        tv, tvs = tkv.quantize_kv(torch.from_numpy(v), dtype)
        p = np.array(pos, np.int32)
        jres = jdec.cache_append(jc.k, jc.v, jk, jv, jnp.asarray(p),
                                 jc.k_scale, jc.v_scale, jks, jvs,
                                 layer=jnp.int32(1))
        jc = jkv.KVCache(*jres, jc.length)
        tres = tdec.cache_append(tc.k, tc.v, tk, tv, torch.from_numpy(p),
                                 tc.k_scale, tc.v_scale, tks, tvs, layer=1)
        assert tres[0] is tc.k and tres[1] is tc.v
    for name in ("k", "v", "k_scale", "v_scale"):
        _same_storage(getattr(tc, name), getattr(jc, name))


@pytest.mark.parametrize("dtype", ["int4", "float8_e4m3fn"])
def test_paged_cache_append_matches_jax(rng, dtype):
    """PagedKVCache.init as JAX's (the pool's storage, its d // 2 for
    int4), then a paged run of 40 tokens per row that straddles a page,
    through each row's table: the pools equal JAX's."""
    pool, page, n_pages = 6, 128, 3
    jp = jkv.PagedKVCache.init(L, B, pool, page, n_pages, HKV, D, dtype)
    tp = tkv.PagedKVCache.init(L, B, pool, page, n_pages, HKV, D, dtype,
                               device="cpu")
    assert tp.dtype == dtype and (tp.page_size, tp.s_max) == (page,
                                                              n_pages * page)
    for name in ("k", "v", "k_scale", "v_scale"):
        _same_storage(getattr(tp, name), getattr(jp, name))
    pt = np.array([[1, 2, -1], [3, -1, -1], [4, 5, -1]], np.int32)
    pos = np.array([100, 10, 200], np.int32)
    k = rng.standard_normal((B, HKV, 40, D)).astype(np.float32)
    v = rng.standard_normal((B, HKV, 40, D)).astype(np.float32)
    jk, jks = jkv.quantize_kv(jnp.asarray(k), dtype)
    jv, jvs = jkv.quantize_kv(jnp.asarray(v), dtype)
    tk, tks = tkv.quantize_kv(torch.from_numpy(k), dtype)
    tv, tvs = tkv.quantize_kv(torch.from_numpy(v), dtype)
    jres = jdec.cache_append(jp.k, jp.v, jk, jv, jnp.asarray(pos), jp.k_scale,
                             jp.v_scale, jks, jvs, layer=jnp.int32(0),
                             page_table=jnp.asarray(pt))
    tdec.cache_append(tp.k, tp.v, tk, tv, torch.from_numpy(pos), tp.k_scale,
                      tp.v_scale, tks, tvs, layer=0,
                      page_table=torch.from_numpy(pt))
    for got, want in zip((tp.k, tp.v, tp.k_scale, tp.v_scale), jres):
        _same_storage(got, want)


# ---------------------------------------------------------------------------
# B7: decode attention
# ---------------------------------------------------------------------------


def _decode_pair(jc, tc, q, lens, **kw):
    jo, jl = jdec.decode_attention(
        jnp.asarray(q, jnp.bfloat16), jc.k, jc.v, jnp.asarray(lens),
        jc.k_scale, jc.v_scale, return_lse=True, **{
            k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
            for k, v in kw.items()}, layer=jnp.int32(1))
    to, tl = tdec.decode_attention(
        torch.from_numpy(q).to(torch.bfloat16), tc[0], tc[1],
        torch.from_numpy(lens), tc[2], tc[3], return_lse=True, layer=1,
        **kw)
    np.testing.assert_allclose(_np(to), _np(jo), **OUT_TOL)
    np.testing.assert_allclose(_np(tl), _np(jl), **LSE_TOL)
    return to


@pytest.mark.parametrize("safe", [False, True], ids=["fast", "safe"])
@pytest.mark.parametrize("dtype,mxu_int8", [
    ("float8_e4m3fn", True), ("int4", True), ("int4", False),
    ("int8", False)], ids=["fp8 cast", "int4 s8", "int4 cast", "int8 cast"])
def test_decode_paths_match_jax(rng, dtype, mxu_int8, safe):
    """B7's plain version on the cast path (fp8 always; int8 and int4 under
    mxu_int8=False) and int4 on the s8 path against JAX's decode_attention
    on the same quantized cache: 512 slots, block_kv 128 (four tiles, so
    the s8 path requantizes P over the same columns), ragged lengths."""
    jc, tc = _filled(rng, 512, dtype)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    lens = np.array([100, 300, 512], np.int32)
    _decode_pair(jc, tc, q, lens, block_kv=128, mxu_int8=mxu_int8,
                 safe_softmax=safe)


@pytest.mark.parametrize("dtype", ["int8", "float8_e4m3fn"])
def test_decode_alibi_matches_jax(rng, dtype):
    """ALiBi in B7 (JAX tests/test_decode.py:250 and :271): one token per
    row and a run of three tokens (each at its own position), with the
    window on the run, against JAX's kernel."""
    jc, tc = _filled(rng, 256, dtype)
    lens = np.array([1, 192, 77], np.int32)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    out = _decode_pair(jc, tc, q, lens, block_kv=128, alibi_slopes=SLOPES)
    plain = tdec.decode_attention(
        torch.from_numpy(q).to(torch.bfloat16), tc[0], tc[1],
        torch.from_numpy(lens), tc[2], tc[3], layer=1, block_kv=128)
    assert not torch.equal(out, plain)  # the bias moved the output
    qr = rng.standard_normal((B, 3, H, D)).astype(np.float32)
    _decode_pair(jc, tc, qr, lens + 3, block_kv=128, alibi_slopes=SLOPES)
    _decode_pair(jc, tc, qr, lens + 3, block_kv=128, alibi_slopes=SLOPES,
                 window_size=(40, -1), softcap=8.0)


@pytest.mark.parametrize("splits", [2, 3])
def test_decode_kv_splits_match_jax(rng, splits):
    """kv_splits as JAX's split count (tests/test_decode.py:140): 640 slots
    in five tiles of 128 (ragged for both counts), a row that dies inside
    the first split; int8 (s8) and fp8 (cast)."""
    for dtype in ("int8", "float8_e4m3fn"):
        jc, tc = _filled(rng, 640, dtype)
        q = rng.standard_normal((B, H, D)).astype(np.float32)
        lens = np.array([500, 77, 640], np.int32)
        _decode_pair(jc, tc, q, lens, block_kv=128, kv_splits=splits)


def test_paged_fp8_decode_matches_jax(rng):
    """Paged fp8 B7 (the cast path through the page table): one token per
    row and a run of 64, against JAX's paged kernel over the same pool."""
    pool, page, n_pages = 8, 128, 4
    jp = jkv.PagedKVCache.init(L, B, pool, page, n_pages, HKV, D,
                               "float8_e4m3fn")
    vals = [rng.standard_normal((L, pool, HKV, page, D)).astype(np.float32)
            for _ in range(2)]
    (jk, jks), (jv, jvs) = (jkv.quantize_kv(jnp.asarray(x), "float8_e4m3fn")
                            for x in vals)
    jks, jvs = jks[..., None, :], jvs[..., None, :]
    pt = np.array([[3, 1, 7, -1], [2, -1, -1, -1], [6, 5, 4, -1]], np.int32)
    lens = np.array([300, 128, 384], np.int32)
    tk, tv, tks, tvs = (_port(x) for x in (jk, jv, jks, jvs))
    for q in (rng.standard_normal((B, H, D)),
              rng.standard_normal((B, 64, H, D))):
        q = q.astype(np.float32)
        jo, jl = jdec.decode_attention(
            jnp.asarray(q, jnp.bfloat16), jk, jv, jnp.asarray(lens), jks,
            jvs, layer=jnp.int32(1), page_table=jnp.asarray(pt),
            return_lse=True)
        to, tl = tdec.decode_attention(
            torch.from_numpy(q).to(torch.bfloat16), tk, tv,
            torch.from_numpy(lens), tks, tvs, layer=1,
            page_table=torch.from_numpy(pt), return_lse=True)
        np.testing.assert_allclose(_np(to), _np(jo), **OUT_TOL)
        np.testing.assert_allclose(_np(tl), _np(jl), **LSE_TOL)


def test_decode_raises_what_remains():
    """What raises: JAX's guards on the sequence-sharded columns (sink_cols
    without first_cols, the global sink count beside first_cols:
    ValueError) and paged + kv_splits (ValueError, as JAX refuses it). The
    columns themselves run: a row's first column equal to its window's
    gives the windowed call's result, and its sink slice the sinks'."""
    g = torch.Generator().manual_seed(0)
    kc = torch.randn((1, 2, 128, D), generator=g).to(torch.float8_e4m3fn)
    sc = torch.rand((1, 2, 1, 128), generator=g) + 0.5
    q = torch.randn((1, 4, D), generator=g).to(torch.bfloat16)
    lens = torch.full((1,), 100, dtype=torch.int32)
    cols = torch.full((1,), 100 - 1 - 10, dtype=torch.int32)
    for kw in (dict(sink_cols=cols),
               dict(first_cols=cols, sink_tokens=4, window_size=(10, -1))):
        with pytest.raises(ValueError, match="sink"):
            tdec.decode_attention(q, kc, kc, lens, sc, sc, **kw)
    want = tdec.decode_attention(q, kc, kc, lens, sc, sc,
                                 window_size=(10, -1), sink_tokens=4)
    got = tdec.decode_attention(q, kc, kc, lens, sc, sc, first_cols=cols,
                                sink_cols=torch.full((1,), 4,
                                                     dtype=torch.int32),
                                window_size=(10, -1), sink_band=4)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="kv_splits"):
        tdec.decode_attention(q, kc, kc, lens, sc, sc, kv_splits=2,
                              page_table=torch.zeros((1, 1),
                                                     dtype=torch.int32))


# ---------------------------------------------------------------------------
# B3 over fp8 and int4 K/V
# ---------------------------------------------------------------------------

B3_SHAPES = {
    "causal": dict(causal=True),
    "window sinks": dict(causal=True, window_size=(64, 0), sink_tokens=4),
    "softcap": dict(causal=True, softcap=20.0),
    "safe": dict(causal=True, safe_softmax=True),
}


@pytest.mark.parametrize("shape", sorted(B3_SHAPES))
@pytest.mark.parametrize("dtype", ["int4", "float8_e4m3fn"])
def test_flash_fwd_cache_matches_jax(rng, dtype, shape):
    """flash_attention_fwd_cache (B3's plain version) over an fp8 or int4
    cache prefix: 64 rows at q_start 192 against 256 slots, read through a
    strided slice of a longer cache, against JAX's kernel."""
    s_q, s_kv, q_start = 64, 256, 192
    q = rng.standard_normal((B, s_q, H, D)).astype(np.float32)
    full = [rng.standard_normal((B, HKV, 320, D)).astype(np.float32)
            for _ in range(2)]
    (jk, jks), (jv, jvs) = (jkv.quantize_kv(jnp.asarray(x), dtype)
                            for x in full)
    tk, tks, tv, tvs = (_port(x) for x in (jk, jks, jv, jvs))
    kw = B3_SHAPES[shape]
    jo, jl = jflash.flash_attention_fwd_cache(
        jnp.asarray(q, jnp.bfloat16), jk[:, :, :s_kv], jv[:, :, :s_kv],
        k_scale=jks[..., :s_kv], v_scale=jvs[..., :s_kv], q_start=q_start,
        **kw)
    to, tl = tflash.flash_attention_fwd_cache(
        torch.from_numpy(q).to(torch.bfloat16), tk[:, :, :s_kv],
        tv[:, :, :s_kv], k_scale=tks[..., :s_kv], v_scale=tvs[..., :s_kv],
        q_start=q_start, **kw)
    np.testing.assert_allclose(_np(to), _np(jo), **OUT_TOL)
    np.testing.assert_allclose(_np(tl), _np(jl), **LSE_TOL)


@pytest.mark.parametrize("dtype", ["int4", "float8_e4m3fn"])
def test_flash_attention_fwd_k_scale_matches_jax(rng, dtype):
    """flash_attention_fwd(k_scale=...) over BSHD fp8 / int4 K/V (the
    ring's quantized step), causal and at two-chunk offsets, against JAX's;
    forward-only as in JAX."""
    s = 128
    q = rng.standard_normal((B, s, H, D)).astype(np.float32)
    kv = [rng.standard_normal((B, s, HKV, D)).astype(np.float32)
          for _ in range(2)]
    (jk, jks), (jv, jvs) = (jkv.quantize_kv(jnp.asarray(x), dtype)
                            for x in kv)
    jks, jvs = jnp.swapaxes(jks, 1, 2), jnp.swapaxes(jvs, 1, 2)
    tk, tks, tv, tvs = (_port(x) for x in (jk, jks, jv, jvs))
    for kw in (dict(causal=True),
               dict(causal=True, q_offsets=(64, 256), kv_offsets=(0, 192))):
        jo, jl = jflash.flash_attention_fwd(
            jnp.asarray(q, jnp.bfloat16), jk, jv, k_scale=jks, v_scale=jvs,
            **kw)
        tq = torch.from_numpy(q).to(torch.bfloat16)
        to, tl = tflash.flash_attention_fwd(tq, tk, tv, k_scale=tks,
                                            v_scale=tvs, **kw)
        np.testing.assert_allclose(_np(to), _np(jo), **OUT_TOL)
        np.testing.assert_allclose(_np(tl), _np(jl), **LSE_TOL)
    with pytest.raises(NotImplementedError, match="forward-only"):
        tflash.flash_attention_fwd(tq.requires_grad_(), tk, tv, k_scale=tks,
                                   v_scale=tvs, causal=True)
