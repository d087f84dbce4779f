"""The fp8 and int4 KV caches of the PyTorch port end to end, against the
JAX package on the same weights and inputs: Engine over fp8 and int4
caches (chunked prefill, greedy decode, generate), ContinuousEngine and
PagedContinuousEngine (prefix caching on) over an fp8 cache, and the ring
with ``kv_quant`` fp8 and int4 on 4 gloo ranks against JAX's ring on 4
virtual devices and the dequantized oracle, forward and gradients. JAX's
ring runs both quantized
dtypes on the CPU (its Pallas kernels in interpret mode).

Tolerances:
* Engine prefill logits 1e-1 (tests/test_torch_engine.py's int8 gate):
  bf16 activations rounded at the same places, fp32 sums in another
  order, and the cache's quantization of K/V that may differ by a level
  where a bf16 ulp moves a value across a rounding boundary;
* greedy tokens equal (tie-free prompts), engines token for token;
* teacher forcing over the quantized cache against the bf16 prefill of
  the prompt and the token: fp8 within the JAX suite's int8-cache gate 0.5
  (tests/test_serving.py:47), int4 finite (JAX gates int4 on NaN-freedom,
  tests/test_serving.py:450);
* the ring: the bf16 gate atol 1e-1 (tests/test_ring.py): out and lse
  against JAX's ring, and out, lse and gradients against the oracle over
  the dequantized K/V (see test_quantized_ring_matches_jax for why the
  gradients' reference is the oracle).
"""

import functools
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from long_context_attention_tpu import serving as jserving
from long_context_attention_tpu.models import llama as jllama
from long_context_attention_tpu_torch import serving as tserving
from long_context_attention_tpu_torch.models import llama as tllama
from long_context_attention_tpu_torch.parallel import layouts as tlay
from long_context_attention_tpu_torch.parallel import mesh as tmesh
from long_context_attention_tpu_torch.utils.convert import params_from_jax

torch.set_num_threads(1)

SHAPE = dict(vocab=64, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
             head_dim=32, ffn_hidden=128, layout="basic")
B, S_PROMPT, S_MAX = 2, 16, 64
PROMPT_SEED = 2  # tie-free greedy decode (tests/test_torch_engine.py)
LOGITS_TOL = dict(atol=1e-1, rtol=0)
TEACHER_TOL = 0.5


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.fixture(scope="module")
def bf16_model():
    jcfg = jllama.ModelConfig(**SHAPE)
    jparams = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              device="cpu")
    prompt = np.random.default_rng(PROMPT_SEED).integers(
        0, SHAPE["vocab"], (B, S_PROMPT)).astype(np.int32)
    return jcfg, tllama.ModelConfig(**SHAPE), jparams, tparams, prompt


@pytest.mark.parametrize("cache_dtype,weight_dtype", [
    ("float8_e4m3fn", "int8"), ("int4", "int8"), ("float8_e4m3fn",
                                                  "bfloat16")])
def test_engine_matches_jax(bf16_model, cache_dtype, weight_dtype):
    """Engine over an fp8 or int4 cache (int8 decode weights, as the chip's
    slices serve; fp8 with bf16 ones too): prefill_chunked (chunk 8: the
    second chunk reads the quantized first through B3) within 1e-1 of
    JAX's logits, six greedy decode_scan steps (B6 writing the cache's
    rows, B7 on fp8's cast path and int4's s8 path) and generate giving
    JAX's tokens."""
    jcfg, tcfg, jparams, tparams, prompt = bf16_model
    je = jserving.Engine(cfg=jcfg, s_max=S_MAX, cache_dtype=cache_dtype,
                         weight_dtype=weight_dtype)
    te = tserving.Engine(cfg=tcfg, s_max=S_MAX, cache_dtype=cache_dtype,
                         weight_dtype=weight_dtype, device="cpu")
    jl, jc = je.prefill_chunked(jparams, jnp.asarray(prompt), 8)
    tl, tc = te.prefill_chunked(tparams, torch.from_numpy(prompt), 8)
    np.testing.assert_allclose(_np(tl), _np(jl), **LOGITS_TOL)
    assert tc.dtype == cache_dtype and tc.length.tolist() == [S_PROMPT] * B
    first = jnp.argmax(jl, -1).astype(jnp.int32)
    assert torch.argmax(tl, -1).tolist() == np.asarray(first).tolist()
    jt, _ = je.decode_scan(je.decode_params(jparams), jc, 6, first,
                           jserving.SamplingParams(), jax.random.PRNGKey(0))
    tt, tc = te.decode_scan(te.decode_params(tparams), tc, 6,
                            torch.from_numpy(np.array(first)))
    assert tt.tolist() == np.asarray(jt).tolist()
    jr = je.generate(jparams, jnp.asarray(prompt), 4)
    tr = te.generate(tparams, torch.from_numpy(prompt), 4)
    assert tr.tokens.tolist() == np.asarray(jr.tokens).tolist()
    np.testing.assert_allclose(_np(tr.prefill_logits),
                               _np(jr.prefill_logits), **LOGITS_TOL)


def test_quantized_cache_teacher_forcing(bf16_model):
    """The chip gate's measure at small size: the first decode step over
    the chunk-prefilled cache against the bf16 prefill of prompt + token,
    for each cache dtype. fp8 stays within the int8-cache gate (0.5), well
    inside it like int8; int4 gives finite logits."""
    _, tcfg, _, tparams, prompt = bf16_model
    toks = torch.from_numpy(prompt)
    ref = tserving.Engine(cfg=tcfg, s_max=S_MAX, device="cpu")
    errs = {}
    for dtype in ("int8", "float8_e4m3fn", "int4"):
        eng = tserving.Engine(cfg=tcfg, s_max=S_MAX, cache_dtype=dtype,
                              weight_dtype="int8", device="cpu")
        logits, cache = eng.prefill_chunked(tparams, toks, 8)
        first = torch.argmax(logits, -1).to(torch.int32)
        step, _ = tllama.decode_step(eng.decode_params(tparams), cache,
                                     first, tcfg)
        want, _ = ref.prefill(tparams, torch.cat([toks, first[:, None]], 1))
        assert torch.isfinite(step).all()
        errs[dtype] = float((step - want).abs().max())
    assert errs["float8_e4m3fn"] <= TEACHER_TOL / 2, errs
    assert errs["int8"] <= TEACHER_TOL / 2, errs


# ---------------------------------------------------------------------------
# continuous and paged serving over an fp8 cache (float32 tiny model, as
# tests/test_torch_continuous.py compares schedulers)
# ---------------------------------------------------------------------------

CONT_SHAPE = dict(SHAPE, vocab=96)
CONT_S_MAX, PAGE = 512, 128
SPECS = [(24, 6), (200, 4), (100, 8), (17, 3), (300, 5)]


def _requests(pkg):
    rng = np.random.default_rng(5)
    return [pkg.Request(id=i, tokens=[int(t) for t in rng.integers(
        0, CONT_SHAPE["vocab"], n)], max_new=m)
        for i, (n, m) in enumerate(SPECS)]


def _prefix_requests(pkg):
    """Two system pages shared by four requests, and one stranger."""
    rng = np.random.default_rng(7)
    system = [int(t) for t in rng.integers(0, CONT_SHAPE["vocab"], 2 * PAGE)]
    tails = [(30, 5), (70, 4), (5, 6), (140, 3)]
    return [pkg.Request(id=i, tokens=system + [int(t) for t in np.random
                                               .default_rng(20 + i).integers(
                                                   0, CONT_SHAPE["vocab"],
                                                   t)], max_new=m)
            for i, (t, m) in enumerate(tails)] + [
        pkg.Request(id=9, tokens=[int(t) for t in rng.integers(
            0, CONT_SHAPE["vocab"], 50)], max_new=4)]


@pytest.fixture(scope="module")
def f32_model():
    jcfg = jllama.ModelConfig(**CONT_SHAPE, dtype=jnp.float32)
    jparams = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              device="cpu")
    return jcfg, tllama.ModelConfig(**CONT_SHAPE, dtype=torch.float32), \
        jparams, tparams


def _tokens(res):
    return {i: r.tokens for i, r in res.items()}


def test_continuous_fp8_matches_jax(f32_model):
    """ContinuousEngine over an fp8 cache (queueing through 2 rows, a
    block of 3 steps) gives JAX's greedy tokens."""
    jcfg, tcfg, jparams, tparams = f32_model
    kw = dict(s_max=CONT_S_MAX, max_batch=2, cache_dtype="float8_e4m3fn",
              step_block=3)
    want = jserving.ContinuousEngine(jcfg, **kw).serve(
        jparams, _requests(jserving))
    got = tserving.ContinuousEngine(tcfg, device="cpu", **kw).serve(
        tparams, _requests(tserving))
    assert _tokens(got) == _tokens(want)


@pytest.mark.parametrize("interleave", [False, True],
                         ids=["prefix", "prefix_interleaved"])
def test_paged_prefix_fp8_matches_jax(f32_model, interleave):
    """PagedContinuousEngine over an fp8 pool with prefix caching (the
    shared pages' suffixes prefilled by the multi-token cast path of B7
    through the page table), alone and with interleaved admission: JAX's
    tokens and prefix stats."""
    jcfg, tcfg, jparams, tparams = f32_model
    kw = dict(s_max=CONT_S_MAX, max_batch=2, cache_dtype="float8_e4m3fn",
              page_size=PAGE, pool_pages=14, prefix_cache=True,
              prefill_chunk=64, interleave_admission=interleave)
    jeng = jserving.PagedContinuousEngine(jcfg, native_runtime=False, **kw)
    want = jeng.serve(jparams, _prefix_requests(jserving))
    teng = tserving.PagedContinuousEngine(tcfg, device="cpu", **kw)
    got = teng.serve(tparams, _prefix_requests(tserving))
    assert _tokens(got) == _tokens(want)
    assert teng.stats == jeng.stats and teng.stats["prefix_hit_tokens"] > 0


# ---------------------------------------------------------------------------
# the ring with quantized K/V: 4 gloo processes against JAX's ring on 4
# virtual devices (tests/test_ring.py:128 and :196)
# ---------------------------------------------------------------------------

WORLD = 4
RB, RS, RH, RHKV, RD = 1, 256, 4, 2, 32
RING_TOL = 1e-1
# name: (ring kwargs, gradients)
RING_CASES = {
    "zigzag fp8": (dict(layout="zigzag", causal=True,
                        kv_quant="float8_e4m3fn"), True),
    "zigzag int4": (dict(layout="zigzag", causal=True, kv_quant="int4"),
                    True),
    "bidirectional stripe fp8": (dict(layout="stripe", causal=True,
                                      bidirectional=True,
                                      kv_quant="float8_e4m3fn"), False),
    "bidirectional basic int4": (dict(layout="basic", causal=True,
                                      bidirectional=True, kv_quant="int4"),
                                 False),
}


def _ring_inputs():
    rng = np.random.default_rng(0)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((RB, RS, RH, RD), (RB, RS, RHKV, RD),
                           (RB, RS, RHKV, RD), (RB, RS, RH, RD)))


def _jax_ring_references(path: pathlib.Path) -> None:
    """Per case, in natural order: JAX's ring (Pallas in interpret mode)
    out and lse, and the dequantized oracle's out, lse and gradients
    (xla_attention over K/V quantized by JAX's eager quantizer, straight
    through)."""
    from jax.sharding import Mesh, PartitionSpec as P

    from long_context_attention_tpu.ops.kv_cache import (
        dequantize_kv, quantize_kv)
    from long_context_attention_tpu.ops.reference import xla_attention
    from long_context_attention_tpu.parallel.layouts import (
        permute_for_layout, unpermute_from_layout)
    from long_context_attention_tpu.parallel.ring import ring_attention_local

    mesh = Mesh(np.array(jax.devices()[:WORLD]), axis_names=("ring",))
    spec, lspec = P(None, "ring", None, None), P(None, None, "ring")
    q, k, v, dout = (jnp.asarray(x, jnp.bfloat16) for x in _ring_inputs())
    saved = {}
    for name, (kw, grads) in RING_CASES.items():
        layout = kw["layout"]
        mapped = jax.jit(jax.shard_map(
            functools.partial(ring_attention_local, axis_name="ring",
                              return_lse=True, **kw),
            mesh=mesh, in_specs=(spec,) * 3, out_specs=(spec, lspec),
            check_vma=False))
        o, l = mapped(*(permute_for_layout(x, layout, WORLD)
                        for x in (q, k, v)))
        saved[f"{name}/ring_out"] = np.asarray(
            unpermute_from_layout(o, layout, WORLD), np.float32)
        saved[f"{name}/ring_lse"] = np.asarray(
            unpermute_from_layout(l, layout, WORLD, axis=2), np.float32)
        kd, vd = (dequantize_kv(*quantize_kv(x, kw["kv_quant"]), x.dtype)
                  for x in (k, v))

        def loss(q, kd, vd):
            o, l = xla_attention(q, kd, vd, causal=True)
            return jnp.sum(o.astype(jnp.float32)
                           * dout.astype(jnp.float32)), (o, l)

        (_, (out, lse)), gs = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1, 2), has_aux=True))(q, kd, vd)
        saved[f"{name}/out"] = np.asarray(out, np.float32)
        saved[f"{name}/lse"] = np.asarray(lse, np.float32)
        for gname, g in zip(("dq", "dk", "dv"), gs):
            saved[f"{name}/{gname}"] = np.asarray(g, np.float32)
    np.savez(path / "ref.npz", **saved)


def _ring_worker(rank: int, tmp: str) -> None:
    """One gloo rank: every case through the port's ring_attention_local;
    rank 0 writes the largest error of each output against JAX's."""
    from long_context_attention_tpu_torch.parallel.ring import (
        ring_attention_local)

    torch.set_num_threads(1)
    path = pathlib.Path(tmp)
    dist.init_process_group("gloo", init_method=f"file://{path}/rdzv",
                            rank=rank, world_size=WORLD)
    mesh = tmesh.make_usp_mesh(ring=WORLD, device="cpu")
    ref = np.load(path / "ref.npz")
    arrays = [torch.from_numpy(x).bfloat16() for x in _ring_inputs()]
    errs = {}
    for name, (kw, grads) in RING_CASES.items():
        layout = kw["layout"]
        local = [tlay.extract_local(t, rank, WORLD, layout) for t in arrays]
        q, k, v = (t.clone().requires_grad_(grads) for t in local[:3])
        out, lse = ring_attention_local(q, k, v, group=mesh.ring_group,
                                        return_lse=True, **kw)
        if grads:
            (out.float() * local[3].float()).sum().backward()

        def gather(t, axis=1):
            parts = [torch.empty_like(t) for _ in range(WORLD)]
            dist.all_gather(parts, t.contiguous())
            return tlay.unpermute_from_layout(torch.cat(parts, axis), layout,
                                              WORLD, axis=axis).float()

        got = {"out": gather(out.detach()), "lse": gather(lse.detach(), 2)}
        if grads:
            got.update(dq=gather(q.grad), dk=gather(k.grad),
                       dv=gather(v.grad))
        for key, t in got.items():
            errs[f"{name}/{key}"] = float(np.abs(
                t.numpy() - ref[f"{name}/{key}"]).max())
            if key in ("out", "lse"):
                errs[f"{name}/ring_{key}"] = float(np.abs(
                    t.numpy() - ref[f"{name}/ring_{key}"]).max())
    if rank == 0:
        (path / "errs.json").write_text(json.dumps(errs))
    dist.barrier()
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def ring_errors(tmp_path_factory):
    path = tmp_path_factory.mktemp("quant_ring")
    _jax_ring_references(path)
    mp.start_processes(_ring_worker, args=(str(path),), nprocs=WORLD,
                       join=True, start_method="spawn")
    return json.loads((path / "errs.json").read_text())


@pytest.mark.parametrize("case", RING_CASES)
def test_quantized_ring_matches_jax(ring_errors, case):
    """The port's ring rotating fp8 or packed int4 K/V (B3 over the held
    quantized K/V each step; the backward over the dequantized values):
    out and lse against JAX's ring with the same kv_quant, and out, lse
    and (where the case has them) dq, dk, dv against the dequantized
    oracle, within the bf16 gate. JAX's ring quantizes inside a jitted
    program, whose division rounds a few values to the neighbouring fp8 or
    int4 level (2 of 4096 fp8 values, 5 of 4096 int4 values in a sample;
    its eager quantizer, which the port's matches bit for bit, moves none),
    so its gradients are not the port's reference: the oracle over the
    eagerly quantized K/V is (as tests/test_torch_ring.py holds the int8
    ring, after JAX's tests/test_ring.py:163)."""
    keys = ["ring_out", "ring_lse", "out", "lse"] + (
        ["dq", "dk", "dv"] if RING_CASES[case][1] else [])
    for key in keys:
        assert ring_errors[f"{case}/{key}"] <= RING_TOL, (key, ring_errors)


def test_ring_config_quantized_kinds():
    """RingConfig takes kv_quant fp8 and int4 with the pallas impl; sage
    keeps JAX's ValueError for anything but int8; an unknown dtype raises;
    int4's rotated K/V are half of int8's bytes."""
    from long_context_attention_tpu_torch.parallel import ring as tring

    for kq in ("int8", "float8_e4m3fn", "int4"):
        tring.RingConfig(ring_size=2, kv_quant=kq)
    for kq in ("float8_e4m3fn", "int4"):
        with pytest.raises(ValueError, match="int8"):
            tring.RingConfig(ring_size=2, impl="sage", kv_quant=kq)
    with pytest.raises(ValueError, match="quantized"):
        tring.RingConfig(ring_size=2, kv_quant="fp8")
    k = torch.randn(1, 64, 2, 32)
    sizes = {}
    for kq in ("int8", "int4"):
        cfg = tring.RingConfig(ring_size=2, kv_quant=kq)
        parts = tring._kv_parts(cfg, k, k)
        sizes[kq] = sum(p.numel() * p.element_size() for p in parts[:2])
    assert sizes["int4"] * 2 == sizes["int8"]
