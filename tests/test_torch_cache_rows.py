"""Kernel B6's quantizing entry, ``cache_append_rows``, on the CPU: its plain
path against JAX's eager ``quantize_kv`` followed by its ``cache_append``
(Pallas, interpret mode) on the same numpy inputs, for every cache dtype,
dense and paged, at a run of 40 (int8 and int4 also at one token and a run
of 3), with skipped rows, slots past the capacity, a run straddling a page
and exact half-level quotients;
every layer at once; ``KVCache.write_prompt`` and the engines' row inserts
against the quantize-then-slice writes they replace; and the card path's
host side (the plan's one-time checks and its argument array), run here
against a plain emulation of the C kernel that reads and writes the
tensors' memory through the array's pointers.

Tolerance: exact everywhere (fp8 by its bytes, int4 values, fp32 scales).
"""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from long_context_attention_tpu.ops import decode as jdec
from long_context_attention_tpu.ops import kv_cache as jkv
from long_context_attention_tpu_torch.models.llama import ModelConfig
from long_context_attention_tpu_torch.ops import decode as tdec
from long_context_attention_tpu_torch.ops import kv_cache as tkv
from long_context_attention_tpu_torch.serving import (
    ContinuousEngine,
    PagedContinuousEngine,
)
from long_context_attention_tpu_torch.utils.convert import (
    cache_values_from_jax)

torch.set_num_threads(1)

L, B, HKV, D = 2, 3, 2, 32
S_MAX, PAGE, POOL, N_PAGES = 128, 128, 6, 3
DTYPES = ("bfloat16", "int8", "float8_e4m3fn", "int4")
# slots per run length: a skipped row (append_pos = -n), slots past the
# capacity, a run that straddles a page (paged) or reaches past s_max
POS = {"dense": {1: [127, -1, 5], 3: [126, -3, 40], 40: [100, -40, 20]},
       "paged": {1: [127, -1, 383], 3: [126, -3, 382], 40: [100, -40, 360]}}
TABLE = np.array([[1, 2, 5], [3, -1, -1], [4, -1, 0]], np.int32)
QMAX = {"int8": 127.0, "int4": 7.0, "float8_e4m3fn": 448.0}


def _bytes(t):
    """Stored values as comparable integers (fp8 and bf16 by their
    bytes)."""
    if t.dtype in (torch.float8_e4m3fn, torch.bfloat16):
        t = t.view(torch.uint8)
    return t.numpy()


def _same(got, want_jax):
    """The port's stored tensor equals JAX's, carried over, bit for bit."""
    want = cache_values_from_jax(np.asarray(want_jax), "cpu")
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(_bytes(got), _bytes(want))


def _rows(rng, shape, dtype):
    """bf16-exact K/V rows (..., d) whose quotients x / scale hit exact
    half levels (int8 and int4 round them half to even) or fp8's midpoints:
    a row's absmax is qmax, so its scale is 1."""
    x = rng.standard_normal(shape).astype(np.float32) * 2
    if dtype != "bfloat16":
        qmax = QMAX[dtype]
        ties = ([8.5, 9.5, 17.0, 19.0, -13.0, 0.0]
                if dtype == "float8_e4m3fn"
                else [0.5, 1.5, 2.5, -0.5, -1.5, 6.5 if qmax == 7 else 126.5])
        flat = x.reshape(-1, shape[-1])
        flat[::2, 0] = qmax
        flat[::2, 1:1 + len(ties)] = ties
    return torch.from_numpy(x).bfloat16()


def _jax_cache(layout, dtype):
    if layout == "dense":
        return jkv.KVCache.init(L, B, S_MAX, HKV, D, dtype)
    jp = jkv.PagedKVCache.init(L, B, POOL, PAGE, N_PAGES, HKV, D, dtype)
    return jkv.PagedKVCache(jp.k, jp.v, jp.k_scale, jp.v_scale,
                            jnp.asarray(TABLE), jp.length)


def _port_cache(layout, dtype):
    if layout == "dense":
        return tkv.KVCache.init(L, B, S_MAX, HKV, D, dtype, device="cpu")
    tc = tkv.PagedKVCache.init(L, B, POOL, PAGE, N_PAGES, HKV, D, dtype,
                               device="cpu")
    tc.page_table.copy_(torch.from_numpy(TABLE))
    return tc


# each run length's tokens in one array of every run (1 + 3 + 40)
RUNS = {1: (0, 1), 3: (1, 4), 40: (4, 44)}
_INPUTS = {}


def _inputs(dtype):
    """bf16 K/V rows (b, 44, h, d) for the runs of 1, 3 and 40 tokens, and
    JAX's eager quantize_kv of them ((b, h, 44, d) values, (b, h, 44)
    scales): one call a tensor (a row's quantization is its own, so the
    runs' slices are what each run's own call gives)."""
    if dtype not in _INPUTS:
        rng = np.random.default_rng(DTYPES.index(dtype))
        kv = [_rows(rng, (B, 44, HKV, D), dtype) for _ in range(2)]
        jq = [jkv.quantize_kv(jnp.asarray(x.float().numpy(), jnp.bfloat16)
                              .transpose(0, 2, 1, 3), dtype) for x in kv]
        _INPUTS[dtype] = kv, jq
    return _INPUTS[dtype]


def _check(tc, jarrays):
    for name, want in zip(("k", "v", "k_scale", "v_scale"), jarrays):
        got = getattr(tc, name)
        if want is None:
            assert got is None
        else:
            _same(got, want)


# every dtype at the run of 40; the one token and the run of 3 at int8
# and packed int4 (JAX's interpret-mode cache_append costs ~1 s a call)
ROW_CASES = ([(dt, n) for dt in DTYPES for n in (40,)]
             + [(dt, n) for dt in ("int8", "int4") for n in (1, 3)])


@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("dtype,n", ROW_CASES)
def test_rows_match_jax(dtype, n, layout):
    """cache_append_rows (the plain path) against JAX's quantize_kv +
    cache_append into layer 1, every stored array bit for bit: a skipped
    row, slots past the capacity, a run over a page boundary (paged) or
    past s_max (dense), half-level ties."""
    paged = layout == "paged"
    jc, tc = _jax_cache(layout, dtype), _port_cache(layout, dtype)
    (k, v), ((jk, jks), (jv, jvs)) = _inputs(dtype)
    lo, hi = RUNS[n]
    pos = np.asarray(POS[layout][n], np.int32)
    cut = (lambda s: None if s is None else s[:, :, lo:hi])
    res = jdec.cache_append(
        jc.k, jc.v, cut(jk), cut(jv), jnp.asarray(pos), jc.k_scale,
        jc.v_scale, cut(jks), cut(jvs), layer=jnp.int32(1),
        page_table=jc.page_table if paged else None)
    out = tdec.cache_append_rows(tc, 1, k[:, lo:hi], v[:, lo:hi],
                                 torch.from_numpy(pos))
    assert out is tc
    _check(tc, res if len(res) == 4 else (*res, None, None))


@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("dtype", ["int8", "int4"])
def test_every_layer_in_one_call(rng, dtype, layout):
    """layer=None takes (L, b, n, h_kv, d) rows and an int start: the same
    arrays as one call per layer."""
    tc, ref = _port_cache(layout, dtype), _port_cache(layout, dtype)
    k = _rows(rng, (L, B, 40, HKV, D), dtype)
    v = _rows(rng, (L, B, 40, HKV, D), dtype)
    tdec.cache_append_rows(tc, None, k, v, 90)
    for li in range(L):
        tdec.cache_append_rows(ref, li, k[li], v[li],
                               torch.full((B,), 90, dtype=torch.int32))
    for name in ("k", "v", "k_scale", "v_scale"):
        np.testing.assert_array_equal(_bytes(getattr(tc, name)),
                                      _bytes(getattr(ref, name)))


# ---------------------------------------------------------------------------
# the callers: write_prompt and the engines' row inserts
# ---------------------------------------------------------------------------


def _quantized_slices(k, v, dtype):
    """The quantize-then-slice form the callers wrote with: (b, s, h, d)
    rows -> (values (b, h, s, d'), scales (b, h, s))."""
    kq, ks = tkv.quantize_kv(k.transpose(1, 2), dtype)
    vq, vs = tkv.quantize_kv(v.transpose(1, 2), dtype)
    return kq, vq, ks, vs


@pytest.mark.parametrize("dtype", DTYPES)
def test_write_prompt_as_before(rng, dtype):
    """KVCache.write_prompt (two segments into layer 1) writes what the
    quantize-then-slice write did (tests/test_torch_quant_cache.py and the
    engine tests hold write_prompt to JAX's)."""
    tc = tkv.KVCache.init(L, B, S_MAX, HKV, D, dtype, device="cpu")
    ref = tkv.KVCache.init(L, B, S_MAX, HKV, D, dtype, device="cpu")
    for start, s in ((0, 40), (40, 30)):
        k = _rows(rng, (B, s, HKV, D), dtype)
        v = _rows(rng, (B, s, HKV, D), dtype)
        assert tc.write_prompt(1, k, v, start) is tc
        kq, vq, ks, vs = _quantized_slices(k, v, dtype)
        ref.k[1, :, :, start:start + s] = kq
        ref.v[1, :, :, start:start + s] = vq
        if ks is not None:
            ref.k_scale[1, :, :, 0, start:start + s] = ks
            ref.v_scale[1, :, :, 0, start:start + s] = vs
    for name in ("k", "v", "k_scale", "v_scale"):
        got = getattr(tc, name)
        if got is None:
            assert getattr(ref, name) is None
            continue
        np.testing.assert_array_equal(_bytes(got), _bytes(getattr(ref, name)))


def _tiny_cfg():
    return ModelConfig(vocab=64, dim=64, n_layers=L, n_heads=4,
                       n_kv_heads=HKV, head_dim=16, ffn_hidden=96,
                       dtype=torch.float32)


@pytest.mark.parametrize("dtype", ["int8", "float8_e4m3fn", "int4"])
def test_insert_row_as_before(rng, dtype):
    """ContinuousEngine._insert_row (row 2 of 3, a bucket past s_max) and
    PagedContinuousEngine._insert_row_paged (a bucket of 300 over pages 4,
    1, 5 of a 4-page table, pages of 128) write what the
    quantize-then-slice inserts did, and install the row's length (and
    table)."""
    cfg = _tiny_cfg()
    kv_k = _rows(rng, (L, 1, 300, HKV, 16), dtype)
    kv_v = _rows(rng, (L, 1, 300, HKV, 16), dtype)
    kq, ks = tkv.quantize_kv(kv_k[:, 0].transpose(1, 2), dtype)
    vq, vs = tkv.quantize_kv(kv_v[:, 0].transpose(1, 2), dtype)

    eng = ContinuousEngine(cfg, max_batch=3, s_max=128, cache_dtype=dtype,
                           device="cpu")
    cache, ref = eng.init_cache(), eng.init_cache()
    assert eng._insert_row(cache, kv_k, kv_v, 2, 100) is cache
    ref.k[:, 2, :, :128] = kq[:, :, :128]
    ref.v[:, 2, :, :128] = vq[:, :, :128]
    ref.k_scale[:, 2, :, 0, :128] = ks[:, :, :128]
    ref.v_scale[:, 2, :, 0, :128] = vs[:, :, :128]
    ref.length[2] = 100
    for name in ("k", "v", "k_scale", "v_scale", "length"):
        np.testing.assert_array_equal(_bytes(getattr(cache, name)),
                                      _bytes(getattr(ref, name)))

    peng = PagedContinuousEngine(cfg, max_batch=2, s_max=512, page_size=128,
                                 pool_pages=7, cache_dtype=dtype,
                                 device="cpu")
    cache, ref = peng.init_cache(), peng.init_cache()
    pages = np.array([4, 1, 5, -1], np.int32)
    assert peng._insert_row_paged(cache, kv_k, kv_v, 1, 290, 3,
                                  pages) is cache
    for pi in range(3):
        lo, w, pg = pi * 128, min(128, 300 - pi * 128), int(pages[pi])
        ref.k[:, pg, :, :w] = kq[:, :, lo:lo + w]
        ref.v[:, pg, :, :w] = vq[:, :, lo:lo + w]
        ref.k_scale[:, pg, :, 0, :w] = ks[:, :, lo:lo + w]
        ref.v_scale[:, pg, :, 0, :w] = vs[:, :, lo:lo + w]
    ref.page_table[1] = torch.from_numpy(pages)
    ref.length[1] = 290
    for name in ("k", "v", "k_scale", "v_scale", "page_table", "length"):
        np.testing.assert_array_equal(_bytes(getattr(cache, name)),
                                      _bytes(getattr(ref, name)))


# ---------------------------------------------------------------------------
# the card path's host side, against a plain emulation of the kernel
# ---------------------------------------------------------------------------

_D128 = 128


def _mem(ptr, ctype, count):
    """``count`` elements of ``ctype`` at address ``ptr`` as a writable
    numpy view (CPU tensors' memory)."""
    return np.ctypeslib.as_array((ctype * count).from_address(ptr))


def _emulate_b6(addr):
    """csrc/cache_append.cu's kernel in Python, over the argument array at
    ``addr``: every (tensor, layer, row, head, token) item, its slot, page
    and row index, the row read through the given strides, quantized by
    quantize_kv's arithmetic and stored, or copied (kCopy)."""
    a = list((ctypes.c_longlong * tdec._A_COUNT).from_address(addr))
    kind = a[tdec._A_KIND]
    nl, l0, b, n, h = (a[tdec._A_NL], a[tdec._A_LAYER0], a[tdec._A_B],
                       a[tdec._A_N], a[tdec._A_HKV])
    cap, pool, page = a[tdec._A_CAP], a[tdec._A_POOL], a[tdec._A_PAGE]
    n_pages, rb = a[tdec._A_NPAGES], a[tdec._A_ROW_BYTES]
    pos = (_mem(a[tdec._A_POS], ctypes.c_int32, b) if a[tdec._A_POS]
           else None)
    pt = (_mem(a[tdec._A_PT], ctypes.c_int32, b * n_pages)
          if a[tdec._A_PT] else None)
    name = {v: k for k, v in tdec._B6_KIND.items()}.get(kind)
    for t in range(2):
        st = a[tdec._A_ST + 4 * t:tdec._A_ST + 4 * t + 4]
        for li in range(nl):
            for ib in range(b):
                for hh in range(h):
                    for it in range(n):
                        slot = (int(pos[ib]) if pos is not None
                                else a[tdec._A_POS0]) + it
                        if not 0 <= slot < cap:
                            continue
                        pg, off = ib, slot
                        if pt is not None:
                            pg = min(max(int(pt[ib * n_pages
                                                + slot // page]), 0),
                                     pool - 1)
                            off = slot % page
                        drow = (((l0 + li) * pool + pg) * h + hh) * page \
                            + off
                        se = li * st[0] + ib * st[1] + it * st[2] \
                            + hh * st[3]
                        dst = _mem(a[tdec._A_DST + t] + drow * rb,
                                   ctypes.c_uint8, rb)
                        if name is None:  # kCopy
                            dst[:] = _mem(a[tdec._A_SRC + t] + se,
                                          ctypes.c_uint8, rb)
                            if a[tdec._A_DSC + t]:
                                _mem(a[tdec._A_DSC + t] + 4 * drow,
                                     ctypes.c_float, 1)[0] = _mem(
                                    a[tdec._A_SSC + t]
                                    + 4 * ((ib * h + hh) * n + it),
                                    ctypes.c_float, 1)[0]
                            continue
                        raw = _mem(a[tdec._A_SRC + t] + 2 * se,
                                   ctypes.c_uint16, _D128).copy()
                        x = torch.from_numpy(raw.astype(np.int32) << 16)\
                            .view(torch.float32)
                        q, s = tkv.quantize_kv(x, name)
                        dst[:] = q.contiguous().view(torch.uint8).numpy()
                        if s is not None:
                            _mem(a[tdec._A_DSC + t] + 4 * drow,
                                 ctypes.c_float, 1)[0] = float(s)


class _FakeKernel:
    """Stands in for the "cache_append" Kernel: runs the emulation and
    counts its launches."""

    def __init__(self):
        self.launches = 0

    def __call__(self, addr, stream):
        _emulate_b6(addr)
        self.launches += 1


@pytest.fixture
def fake_b6(monkeypatch):
    fake = _FakeKernel()
    monkeypatch.setitem(tdec._build.KERNELS, "cache_append", fake)
    return fake


def _plan(cache):
    plan = tdec._RowsPlan(cache)
    plan.stream = lambda index: 0
    return plan


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_plan_launch_writes_what_the_plain_path_does(rng, fake_b6, layout,
                                                     dtype):
    """The plan's argument array, read by the kernel's emulation, writes
    the cache the plain path writes: a layer's run over a transposed
    (strided) view, every layer at once through an explicit one-row table
    or the dense rows, an int start; one launch each."""
    def make():
        if layout == "dense":
            return tkv.KVCache.init(L, 2, 256, HKV, _D128, dtype,
                                    device="cpu")
        c = tkv.PagedKVCache.init(L, 2, 5, 128, 2, HKV, _D128, dtype,
                                  device="cpu")
        c.page_table.copy_(torch.tensor([[3, 1], [2, -1]]))
        return c

    got, want = make(), make()
    plan = _plan(got)
    # (b, n, h, d) as a transposed view of (b, h, n, d) storage
    k = _rows(rng, (2, HKV, 5, _D128), dtype).transpose(1, 2)
    v = _rows(rng, (2, HKV, 5, _D128), dtype).transpose(1, 2)
    pos = torch.tensor([125, -5], dtype=torch.int32)
    plan.launch(1, k, v, pos, None)
    tdec.cache_append_rows_plain(want, 1, k, v, pos)
    kl = _rows(rng, (L, 1, 7, HKV, _D128), dtype)
    vl = _rows(rng, (L, 1, 7, HKV, _D128), dtype)
    table = (torch.tensor([[1]], dtype=torch.int32) if layout == "dense"
             else got.page_table[1:2])
    plan.launch(None, kl, vl, 250 if layout == "dense" else 124, table)
    tdec.cache_append_rows_plain(want, None, kl, vl,
                                 250 if layout == "dense" else 124,
                                 page_table=table)
    assert fake_b6.launches == 2
    for name in ("k", "v", "k_scale", "v_scale"):
        if getattr(got, name) is not None:
            np.testing.assert_array_equal(_bytes(getattr(got, name)),
                                          _bytes(getattr(want, name)))


def test_plan_checks_the_cache_once():
    """The plan holds a cache's own arrays by identity (replacing one
    makes a new plan) and raises, when made, on a cache the kernel cannot
    take: head_dim other than 64 or 128, scales of the wrong dtype or
    shape, a bf16 cache with scales."""
    c = tkv.KVCache.init(L, 2, 64, HKV, _D128, "int8", device="cpu")
    plan = _plan(c)
    assert plan.holds(c)
    c.k = c.k.clone()
    assert not plan.holds(c)
    with pytest.raises(NotImplementedError, match="head_dim 64 or 128"):
        tdec._RowsPlan(tkv.KVCache.init(L, 2, 64, HKV, 32, "int8",
                                        device="cpu"))
    bad = tkv.KVCache.init(L, 2, 64, HKV, _D128, "int8", device="cpu")
    bad.k_scale = bad.k_scale.double()
    with pytest.raises(ValueError, match="k_scale"):
        tdec._RowsPlan(bad)
    bad = tkv.KVCache.init(L, 2, 64, HKV, _D128, "int8", device="cpu")
    bad.v_scale = bad.v_scale[..., :32]
    with pytest.raises(ValueError, match="v_scale"):
        tdec._RowsPlan(bad)
    bad = tkv.KVCache.init(L, 2, 64, HKV, _D128, "bfloat16", device="cpu")
    bad.k_scale = torch.zeros(L, 2, HKV, 1, 64)
    with pytest.raises(ValueError, match="bf16 cache"):
        tdec._RowsPlan(bad)
    bad = tkv.KVCache.init(L, 2, 64, HKV, _D128, "int8", device="cpu")
    bad.v = bad.v[:, :, :, :, :64]
    with pytest.raises(ValueError, match="cache.v"):
        tdec._RowsPlan(bad)


@pytest.mark.parametrize("case", ["fp32", "shape", "heads", "layer", "rows",
                                  "d_stride", "pos", "table", "table_rows"])
def test_plan_launch_raises_on_what_the_kernel_cannot_read(fake_b6, case):
    """Each call's rows and slots are checked before the launch: fp32 rows,
    K and V of other shapes, the wrong head count, a layer out of range,
    b other than the dense cache's rows, d not contiguous, append_pos of
    the wrong length, a table that is not int32, a table of other rows.
    Nothing launches."""
    c = tkv.KVCache.init(L, 2, 64, HKV, _D128, "int8", device="cpu")
    plan = _plan(c)
    k = torch.zeros(2, 3, HKV, _D128, dtype=torch.bfloat16)
    v = k.clone()
    pos = torch.zeros(2, dtype=torch.int32)
    layer, table = 0, None
    if case == "fp32":
        k, v = k.float(), v.float()
    elif case == "shape":
        v = v[:, :2]
    elif case == "heads":
        k = v = torch.zeros(2, 3, HKV + 1, _D128, dtype=torch.bfloat16)
    elif case == "layer":
        layer = L
    elif case == "rows":
        k = v = torch.zeros(3, 3, HKV, _D128, dtype=torch.bfloat16)
        pos = torch.zeros(3, dtype=torch.int32)
    elif case == "d_stride":
        k = v = torch.zeros(2, 3, HKV, 2 * _D128,
                            dtype=torch.bfloat16)[..., ::2]
    elif case == "pos":
        pos = torch.zeros(3, dtype=torch.int32)
    elif case == "table":
        table = torch.zeros(2, 1, dtype=torch.int64)
    else:
        table = torch.zeros(1, 1, dtype=torch.int32)
    with pytest.raises(ValueError):
        plan.launch(layer, k, v, pos, table)
    assert fake_b6.launches == 0


def test_copy_kind_through_the_public_wrapper(rng, monkeypatch, fake_b6):
    """The public cache_append's card path (the kernel's byte-copy kind,
    new scales beside the rows) writes what its plain version writes, read
    by the kernel's emulation: int8 through a page table."""
    cache = tkv.PagedKVCache.init(L, 2, 5, 128, 2, HKV, _D128, "int8",
                                  device="cpu")
    ref = tkv.PagedKVCache.init(L, 2, 5, 128, 2, HKV, _D128, "int8",
                                device="cpu")
    table = torch.tensor([[3, 1], [2, -1]], dtype=torch.int32)
    kq, ks = tkv.quantize_kv(_rows(rng, (2, HKV, 4, _D128), "int8"), "int8")
    vq, vs = tkv.quantize_kv(_rows(rng, (2, HKV, 4, _D128), "int8"), "int8")
    pos = torch.tensor([126, 3], dtype=torch.int32)
    monkeypatch.setattr(tdec._build, "stream_ptr", lambda dev: 0)
    tdec._cache_append_cuda(cache.k, cache.v, kq, vq, pos, cache.k_scale,
                            cache.v_scale, ks, vs, 1, table)
    tdec.cache_append_plain(ref.k, ref.v, kq, vq, pos, ref.k_scale,
                            ref.v_scale, ks, vs, layer=1, page_table=table)
    assert fake_b6.launches == 1
    for name in ("k", "v", "k_scale", "v_scale"):
        np.testing.assert_array_equal(_bytes(getattr(cache, name)),
                                      _bytes(getattr(ref, name)))
