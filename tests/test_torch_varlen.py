"""Packed varlen attention (segment ids, ``kv_lengths``) of the PyTorch port
against the JAX package.

In this process: segments forward and gradients against JAX's
``flash_attention`` (Pallas in interpret mode) and against per-document
unpacked attention; ``kv_lengths`` on the cache path, bf16 and int8, with
a zero length, against JAX's ``flash_attention_fwd_cache``; that a static
self-attention call with a feature takes B3 forward and B2a + B2b backward
(never B1, B4 or B5), as JAX routes it; and that the guards raise where
JAX's do.

In 4 gloo processes on the CPU (one spawn, one rendezvous): the ring with
segment ids in every layout, bidirectional, and ``kv_quant="int8"``
against JAX's ring on the 4-device virtual mesh of ``tests/conftest.py``;
the dense USP layer at ulysses 2 x ring 2 (the ids' all-gather over the
ulysses group) against JAX's ``LongContextAttention``. Workers never import
JAX.

Tolerances: fp32 on both sides, outputs and lse within 1e-5 absolute and
relative, gradients within 1e-5 of their largest value (the ring tests'
rule); bf16 and int8 caches 2e-2 (one output's bf16 rounding apart); the
int8 ring the bf16 gate 1e-1.
"""

import json
import pathlib

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from long_context_attention_tpu_torch.ops import flash as tflash
from long_context_attention_tpu_torch.parallel import layouts as tlay
from long_context_attention_tpu_torch.parallel import mesh as tmesh

torch.set_num_threads(1)

WORLD = 4
B, S, H, HKV, D = 1, 256, 4, 2, 64
F32 = dict(atol=1e-5, rtol=1e-5)
F32_GRAD = 1e-5  # of the gradient's largest value
CACHE_TOL = dict(atol=2e-2, rtol=0)
BF16_TOL = 1e-1
CU = [0, 96, 160, S]  # documents of 96, 64 and 96 tokens
DIST_CU = [0, 40, 150, S]  # documents that cross the ring's shards


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().float()
    return np.asarray(x, np.float32)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((B, S, H, D), (B, S, HKV, D), (B, S, HKV, D),
                               (B, S, H, D)))


def _assert_grad(got, want):
    got, want = _np(got), _np(want)
    assert np.abs(got - want).max() <= F32_GRAD * np.abs(want).max()


# ---------------------------------------------------------------------------
# in this process
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("causal", [False, True])
def test_segments_match_jax_and_unpacked(causal):
    """Packed documents (segment ids from cu_seqlens): out, lse and the
    gradients equal JAX's flash_attention with the same ids, and out and
    the gradients equal each document attended on its own."""
    import jax
    import jax.numpy as jnp
    from long_context_attention_tpu.ops.flash import flash_attention

    seg = tlay.segment_ids_from_cu_seqlens(CU, S)
    arrays = _inputs()
    jx = [jnp.asarray(x) for x in arrays]
    jseg = jnp.asarray(seg.numpy())

    def jfwd(q, k, v):
        return flash_attention(q, k, v, causal=causal, q_segment_ids=jseg,
                               kv_segment_ids=jseg, return_lse=True,
                               interpret=True)

    (jo, jl), vjp = jax.vjp(jfwd, *jx[:3])
    jg = vjp((jx[3], jnp.zeros_like(jl)))
    q, k, v, dout = (torch.from_numpy(x) for x in arrays)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out, lse = tflash.flash_attention(*leaves, causal=causal,
                                      q_segment_ids=seg, kv_segment_ids=seg,
                                      return_lse=True)
    (out * dout).sum().backward()
    np.testing.assert_allclose(_np(out), _np(jo), **F32)
    np.testing.assert_allclose(_np(lse), _np(jl), **F32)
    for g, w in zip(leaves, jg):
        _assert_grad(g.grad, w)
    # each document on its own
    parts = [[t.clone().requires_grad_() for t in (q[:, lo:hi], k[:, lo:hi],
                                                   v[:, lo:hi])]
             for lo, hi in zip(CU[:-1], CU[1:])]
    outs = [tflash.flash_attention(*p, causal=causal) for p in parts]
    torch.cat(outs, 1).mul(dout).sum().backward()
    np.testing.assert_allclose(_np(out), _np(torch.cat(outs, 1)), **F32)
    for i, g in enumerate(leaves):
        _assert_grad(g.grad, torch.cat([p[i].grad for p in parts], 1))


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_kv_lengths_cache_matches_jax(dtype):
    """flash_attention_fwd_cache with kv_lengths (each row's filled prefix;
    one row empty: out 0, lse -inf) over a bf16 or int8 cache slice, q rows
    at q_start 200, against JAX's on the same values."""
    import jax.numpy as jnp
    from long_context_attention_tpu.ops.flash import (
        flash_attention_fwd_cache)

    b, s_q, s_kv, q_start = 3, 64, 256, 200
    lens = np.array([256, 130, 0], np.int32)
    rng = np.random.default_rng(5)
    q = rng.standard_normal((b, s_q, H, D)).astype(np.float32)
    if dtype == "int8":
        kc, vc = (rng.integers(-127, 128, (b, HKV, s_kv, D)).astype(np.int8)
                  for _ in range(2))
        ks, vs = ((rng.random((b, HKV, s_kv)) / 64).astype(np.float32)
                  for _ in range(2))
    else:
        kc, vc = (rng.standard_normal((b, HKV, s_kv, D)).astype(np.float32)
                  for _ in range(2))
        ks = vs = None
    jq = jnp.asarray(q, jnp.bfloat16)
    jk, jv = ((jnp.asarray(x) if dtype == "int8"
               else jnp.asarray(x, jnp.bfloat16)) for x in (kc, vc))
    scales = {} if ks is None else dict(k_scale=ks, v_scale=vs)
    jo, jl = flash_attention_fwd_cache(
        jq, jk, jv, q_start=q_start, causal=True, kv_lengths=lens,
        interpret=True, **{n: jnp.asarray(x) for n, x in scales.items()})
    to, tl = tflash.flash_attention_fwd_cache(
        torch.tensor(_np(jq)).bfloat16(),
        *(torch.tensor(np.asarray(x)) if dtype == "int8"
          else torch.tensor(_np(x)).bfloat16() for x in (jk, jv)),
        q_start=q_start, causal=True, kv_lengths=torch.from_numpy(lens),
        **{n: torch.from_numpy(x) for n, x in scales.items()})
    np.testing.assert_allclose(_np(to), _np(jo), **CACHE_TOL)
    np.testing.assert_allclose(_np(tl), _np(jl), **CACHE_TOL)
    assert not to[2].any() and torch.isneginf(tl[2]).all()


def test_featured_self_attention_routes_to_b3(monkeypatch):
    """A static self-attention call with segments, ALiBi or dropout runs
    B3 forward and B2a + B2b backward (JAX's _flash_fwd_bhsd and
    _flash_bwd_bhsd send every feature to the position kernels); without a
    feature it keeps B1 and B5."""
    calls = []
    for name in ("flash_fwd_causal_self", "flash_fwd_static", "flash_fwd_pos",
                 "flash_bwd_fused", "flash_bwd_dq", "flash_bwd_dkv"):
        real = getattr(tflash, name)
        monkeypatch.setattr(tflash, name, (lambda n, f: lambda *a, **k: (
            calls.append(n), f(*a, **k))[1])(name, real))
    q, k, v, dout = (torch.from_numpy(x) for x in _inputs())
    seg = tlay.segment_ids_from_cu_seqlens(CU, S)
    for feats in (dict(q_segment_ids=seg, kv_segment_ids=seg),
                  dict(alibi_slopes=torch.ones(H)),
                  dict(dropout_p=0.2, dropout_seed=(3, 0))):
        calls.clear()
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        tflash.flash_attention(*leaves, causal=True, **feats).mul(
            dout).sum().backward()
        assert calls == ["flash_fwd_pos", "flash_bwd_dq", "flash_bwd_dkv"], (
            feats, calls)
    calls.clear()
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    tflash.flash_attention(*leaves, causal=True).mul(dout).sum().backward()
    assert calls == ["flash_fwd_causal_self", "flash_bwd_fused"]


def test_guards_raise_as_jax():
    """The JAX package's guards, and the port's: q and kv segment ids
    together, 0 <= dropout_p < 1, a dropout key or seed with dropout_p > 0
    (JAX asserts or raises ValueError; the port raises ValueError)."""
    import jax.numpy as jnp
    from long_context_attention_tpu.ops.flash import flash_attention

    arrays = _inputs()
    jq, jk, jv = (jnp.asarray(x) for x in arrays[:3])
    q, k, v = (torch.from_numpy(x) for x in arrays[:3])
    seg = tlay.segment_ids_from_cu_seqlens(CU, S)
    for kw, jax_error in ((dict(q_segment_ids=seg), AssertionError),
                          (dict(dropout_p=1.0, dropout_seed=(1, 0)),
                           AssertionError),
                          (dict(dropout_p=-0.1, dropout_seed=(1, 0)),
                           AssertionError),
                          (dict(dropout_p=0.1), ValueError)):
        jkw = {n: jnp.asarray(x.numpy()) if isinstance(x, torch.Tensor)
               else x for n, x in kw.items()}
        with pytest.raises(jax_error):
            flash_attention(jq, jk, jv, causal=True, interpret=True, **jkw)
        with pytest.raises(ValueError):
            tflash.flash_attention(q, k, v, causal=True, **kw)
    with pytest.raises(ValueError, match="one slope per q head"):
        tflash.flash_attention(q, k, v, alibi_slopes=torch.ones(H + 1))


# ---------------------------------------------------------------------------
# 4 gloo processes against JAX's ring and USP layer on 4 virtual devices
# ---------------------------------------------------------------------------

# name: (kind, layout, kwargs, inputs' dtype)
DIST_CASES = {
    "ring basic": ("ring", "basic", {}, "f32"),
    "ring zigzag": ("ring", "zigzag", {}, "f32"),
    "ring stripe": ("ring", "stripe", {}, "f32"),
    "ring bidirectional zigzag": ("ring", "zigzag", dict(bidirectional=True),
                                  "f32"),
    "ring kv_quant int8": ("ring", "zigzag", dict(kv_quant="int8"), "bf16"),
    "usp 2x2 zigzag": ("usp", "zigzag", {}, "f32"),
    "usp 2x2 stripe": ("usp", "stripe", {}, "f32"),
}


def _jax_references(path: pathlib.Path) -> None:
    """Each distributed case's JAX out and gradients (global, natural
    order): the fp32 oracle per ring step (impl xla), Pallas in interpret
    mode where JAX's ring needs it (kv_quant)."""
    import functools

    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    from long_context_attention_tpu.parallel import mesh as jmesh
    from long_context_attention_tpu.parallel import usp as jusp
    from long_context_attention_tpu.parallel.layouts import (
        permute_for_layout, segment_ids_from_cu_seqlens,
        unpermute_from_layout)
    from long_context_attention_tpu.parallel.ring import ring_attention_local

    devs = jax.devices()[:WORLD]
    arrays = _inputs(seed=1)
    seg = segment_ids_from_cu_seqlens(DIST_CU, S)
    saved = {}
    for name, (kind, layout, kw, dtype) in DIST_CASES.items():
        jd = jnp.float32 if dtype == "f32" else jnp.bfloat16
        q, k, v, dout = (jnp.asarray(x, jd) for x in arrays)
        ring = WORLD if kind == "ring" else 2
        perm = functools.partial(permute_for_layout, layout=layout,
                                 ring_size=ring)
        unperm = functools.partial(unpermute_from_layout, layout=layout,
                                   ring_size=ring)
        segp = permute_for_layout(seg, layout, ring, axis=1)
        impl = "pallas" if "kv_quant" in kw else "xla"
        if kind == "ring":
            mesh = Mesh(np.array(devs), axis_names=("ring",))
            spec = P(None, "ring", None, None)
            def local(q, k, v, ids, kw=kw):
                return ring_attention_local(
                    q, k, v, segment_ids=ids, axis_name="ring", layout=layout,
                    causal=True, impl=impl, interpret=True, **kw)

            fn = jax.shard_map(local, mesh=mesh,
                               in_specs=(spec,) * 3 + (P(None, "ring"),),
                               out_specs=spec, check_vma=False)
            call = functools.partial(lambda f, q, k, v: f(q, k, v, segp), fn)
        else:
            jm = jmesh.make_usp_mesh(ulysses=2, ring=2, devices=devs)
            call = functools.partial(
                jusp.LongContextAttention(mesh=jm, layout=layout, impl=impl),
                causal=True, segment_ids=segp)

        def loss(q, k, v):
            out = call(q, k, v)
            return jnp.sum(out.astype(jnp.float32)
                           * perm(dout).astype(jnp.float32)), out

        (_, out), grads = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1, 2), has_aux=True))(perm(q), perm(k),
                                                     perm(v))
        saved[f"{name}/out"] = _np(unperm(out))
        for gname, g in zip(("dq", "dk", "dv"), grads):
            saved[f"{name}/{gname}"] = _np(unperm(g))
    np.savez(path / "ref.npz", **saved)


def _worker(rank: int, tmp: str) -> None:
    """One gloo rank: every distributed case through the port; rank 0
    writes the errors against JAX's (in units of each case's bound)."""
    from long_context_attention_tpu_torch.parallel import usp as tusp
    from long_context_attention_tpu_torch.parallel.ring import (
        ring_attention_local)

    torch.set_num_threads(1)
    path = pathlib.Path(tmp)
    dist.init_process_group("gloo", init_method=f"file://{path}/rdzv",
                            rank=rank, world_size=WORLD)
    ref = np.load(path / "ref.npz")
    arrays = _inputs(seed=1)
    seg = tlay.segment_ids_from_cu_seqlens(DIST_CU, S)
    errs = {}
    for name, (kind, layout, kw, dtype) in DIST_CASES.items():
        td = torch.float32 if dtype == "f32" else torch.bfloat16
        ring = WORLD if kind == "ring" else 2
        mesh = tmesh.make_usp_mesh(ulysses=WORLD // ring, ring=ring,
                                   device="cpu")
        shard = [tmesh.seq_shard(mesh, tlay.permute_for_layout(
            torch.from_numpy(x).to(td), layout, ring)) for x in arrays]
        seg_l = tmesh.seq_shard(mesh, tlay.permute_for_layout(seg, layout,
                                                              ring))
        leaves = [t.clone().requires_grad_() for t in shard[:3]]
        if kind == "ring":
            out = ring_attention_local(*leaves, group=mesh.ring_group,
                                       layout=layout, causal=True,
                                       segment_ids=seg_l, **kw)
        else:
            out = tusp.LongContextAttention(mesh, layout=layout)(
                *leaves, causal=True, segment_ids=seg_l)
        (out.float() * shard[3].float()).sum().backward()
        for gname, t in zip(("out", "dq", "dk", "dv"),
                            (out, *(x.grad for x in leaves))):
            got = _np(tlay.unpermute_from_layout(
                tmesh.seq_unshard(mesh, t.detach()), layout, ring))
            want = ref[f"{name}/{gname}"]
            if dtype != "f32":
                bound = BF16_TOL
            elif gname == "out":
                bound = F32["atol"] + F32["rtol"] * np.abs(want)
            else:
                bound = F32_GRAD * np.abs(want).max()
            errs[f"{name}/{gname}"] = float(np.max(np.abs(got - want)
                                                   / bound))
    if rank == 0:
        (path / "errs.json").write_text(json.dumps(errs))
    dist.barrier()
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def dist_errors(tmp_path_factory):
    path = tmp_path_factory.mktemp("varlen")
    _jax_references(path)
    mp.start_processes(_worker, args=(str(path),), nprocs=WORLD, join=True,
                       start_method="spawn")
    return json.loads((path / "errs.json").read_text())


@pytest.mark.parametrize("case", DIST_CASES)
def test_distributed_segments_match_jax(dist_errors, case):
    """The port's ring (4 gloo ranks) or dense USP layer (ulysses 2 x ring
    2, the ids gathered over the ulysses group) with segment ids against
    JAX's on 4 devices: out, dq, dk, dv each within its bound (the error
    here is in units of it)."""
    for key in ("out", "dq", "dk", "dv"):
        assert dist_errors[f"{case}/{key}"] <= 1.0, (key, dist_errors)
