"""The dense ring of the PyTorch port against the JAX package.

In this process (no gloo): the position descriptor of kernels B3, B2a, B2b
and B8b -- each plain version under two-chunk and strided descriptors,
with dead rows and with sinks under kv offsets, against JAX's
``flash_attention``, ``flash_attention_bwd`` and
``sage_attention_fwd_prequant`` (Pallas in interpret mode) at the same
``q_offsets``, ``kv_offsets`` and strides; the layouts' bidirectional
descriptor and ``segment_ids_from_cu_seqlens`` (exact).

In 4 gloo processes on the CPU: ``ring_attention_local`` on a ring of 4
against JAX's on the 4-device virtual mesh of ``tests/conftest.py``
(``shard_map``; impl ``xla``, or Pallas in interpret mode where JAX's ring
needs it), on the same global inputs: layouts basic, zigzag and stripe,
causal and not, with gradients; window + sinks; softcap; GQA 4/2 (every
case); the lse; the bidirectional ring with gradients; impl ``xla``;
``kv_quant="int8"`` forward and gradients against the dequantized oracle
(JAX ``tests/test_ring.py:163``); ring x sage direct-int8. The JAX side runs
first; one spawn of 4 workers then runs every port case and writes its
errors; each case is its own test. Workers never import JAX.

Tolerances: fp32 on both sides 1e-5 (outputs and lse absolute, gradients
of their largest value); bf16 and int8 paths the bf16 gate atol 1e-1
(``tests/test_ring.py``).
"""

import json
import pathlib

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from long_context_attention_tpu_torch.ops import flash as tflash
from long_context_attention_tpu_torch.ops import sage as tsage
from long_context_attention_tpu_torch.parallel import layouts as tlay
from long_context_attention_tpu_torch.parallel import mesh as tmesh

torch.set_num_threads(1)

WORLD = 4
B, S, H, HKV, D = 1, 256, 4, 2, 32
F32_OUT = 1e-5
F32_GRAD = 1e-5  # of the gradient's largest value
BF16_TOL = 1e-1

# name: (ring kwargs, grads, inputs' dtype, the JAX reference)
#   "ring": JAX's ring_attention_local with the same kwargs (impl xla when
#   the port's is pallas: the fp32 oracle per step); "dequant": JAX's
#   xla_attention on the dequantized K/V (straight-through)
CASES = {
    "basic causal": (dict(layout="basic", causal=True), True, "f32", "ring"),
    "basic": (dict(layout="basic"), True, "f32", "ring"),
    "zigzag causal": (dict(layout="zigzag", causal=True), True, "f32",
                      "ring"),
    "zigzag": (dict(layout="zigzag"), True, "f32", "ring"),
    "stripe causal": (dict(layout="stripe", causal=True), True, "f32",
                      "ring"),
    "stripe": (dict(layout="stripe"), True, "f32", "ring"),
    "zigzag window sinks": (dict(layout="zigzag", causal=True,
                                 window_size=(40, -1), sink_tokens=3),
                            True, "f32", "ring"),
    "stripe window sinks": (dict(layout="stripe", causal=True,
                                 window_size=(40, -1), sink_tokens=3),
                            True, "f32", "ring"),
    "zigzag softcap": (dict(layout="zigzag", causal=True, softcap=5.0),
                       True, "f32", "ring"),
    "bidirectional zigzag": (dict(layout="zigzag", causal=True,
                                  bidirectional=True), True, "f32", "ring"),
    "bidirectional stripe": (dict(layout="stripe", causal=True,
                                  bidirectional=True), True, "f32", "ring"),
    "zigzag causal impl xla": (dict(layout="zigzag", causal=True,
                                    impl="xla"), True, "f32", "ring"),
    "kv_quant int8": (dict(layout="zigzag", causal=True, kv_quant="int8"),
                      True, "bf16", "dequant"),
    "sage direct int8": (dict(layout="zigzag", causal=True, impl="sage",
                              kv_quant="int8"), False, "bf16", "ring"),
}


def _inputs():
    rng = np.random.default_rng(0)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((B, S, H, D), (B, S, HKV, D), (B, S, HKV, D),
                               (B, S, H, D)))


# ---------------------------------------------------------------------------
# in this process: the kernels' descriptor and the layouts
# ---------------------------------------------------------------------------

# (q_offsets, kv_offsets, stride, mask kwargs) at s_q = s_kv = 128:
#   zigzag rank 1 of 2 at step 1: q chunks (32, 64), kv chunks (0, 96)
#   stripe rank 1 holding rank 2's K/V (stride 4): row 0 sees no key
#   the bidirectional ring's two kv halves from two sources
#   sinks at kv offset 0 seen through a window by a later q chunk
DESCRIPTORS = {
    "two chunks": ((32, 64), (0, 96), 1, dict(causal=True)),
    "strided dead rows": ((1,), (2,), 4, dict(causal=True)),
    "bidirectional kv": ((128,), (0, 192), 1, dict(causal=True)),
    "sinks under kv offsets": ((64, 256), (16, 200), 1,
                               dict(causal=True, window_size=(24, -1),
                                    sink_tokens=20)),
    "strided window": ((3,), (1,), 4, dict(causal=True,
                                          window_size=(30, -1))),
}


def _desc_inputs(rng, dtype=np.float32):
    q = rng.standard_normal((B, 128, H, D)).astype(dtype)
    k = rng.standard_normal((B, 128, HKV, D)).astype(dtype)
    v = rng.standard_normal((B, 128, HKV, D)).astype(dtype)
    dout = rng.standard_normal((B, 128, H, D)).astype(dtype)
    return q, k, v, dout


@pytest.mark.parametrize("case", DESCRIPTORS)
def test_descriptor_forward_matches_jax(rng, case):
    """B3's plain version at two-chunk and strided descriptors (through
    flash_attention, and through flash_fwd_pos with the Positions) equals
    JAX's flash_attention with the same offsets and strides: out and lse,
    dead rows 0 and -inf."""
    import jax.numpy as jnp
    from long_context_attention_tpu.ops.flash import flash_attention

    q_off, kv_off, st, mk = DESCRIPTORS[case]
    q, k, v, _ = _desc_inputs(rng)
    kw = dict(q_offsets=list(q_off), kv_offsets=list(kv_off), q_stride=st,
              kv_stride=st, **mk)
    jo, jl = flash_attention(*(jnp.asarray(x) for x in (q, k, v)),
                             return_lse=True, **kw)
    to, tl = tflash.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                                    return_lse=True, **kw)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=F32_OUT,
                               rtol=0)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=F32_OUT,
                               rtol=0)
    pos = tflash.Positions(q_off, kv_off, st, st)
    po, pl_ = tflash.flash_fwd_pos_plain(
        torch.from_numpy(q), torch.from_numpy(k).transpose(1, 2),
        torch.from_numpy(v).transpose(1, 2), pos=pos, scale=D ** -0.5, **mk)
    assert torch.equal(po, to) and torch.equal(pl_, tl)
    if case == "strided dead rows":
        assert not to[:, 0].any() and torch.isneginf(tl[:, :, 0]).all()


@pytest.mark.parametrize("case", DESCRIPTORS)
def test_descriptor_backward_matches_jax(rng, case):
    """B2a's and B2b's plain versions at the same descriptors equal JAX's
    flash_attention_bwd on the same (out, lse): fp32 dq, dk, dv."""
    import jax.numpy as jnp
    from long_context_attention_tpu.ops.flash import (
        flash_attention, flash_attention_bwd)

    q_off, kv_off, st, mk = DESCRIPTORS[case]
    q, k, v, dout = _desc_inputs(rng)
    kw = dict(q_offsets=list(q_off), kv_offsets=list(kv_off), q_stride=st,
              kv_stride=st, **mk)
    jq, jk, jv, jdo = (jnp.asarray(x) for x in (q, k, v, dout))
    jo, jl = flash_attention(jq, jk, jv, return_lse=True, **kw)
    want = flash_attention_bwd(jq, jk, jv, jo, jl, jdo, **kw)
    got = tflash.flash_attention_bwd(
        *(torch.from_numpy(x) for x in (q, k, v)),
        torch.from_numpy(np.asarray(jo)), torch.from_numpy(np.asarray(jl)),
        torch.from_numpy(dout), **kw)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= F32_GRAD * np.abs(w).max()
    if case == "strided dead rows":
        assert not got[0][:, 0].any()


@pytest.mark.parametrize("case", DESCRIPTORS)
def test_descriptor_sage_matches_jax(rng, case):
    """B8b's plain version (through sage_attention_fwd_prequant, the ring x
    sage direct-int8 step) at the same descriptors equals JAX's on the same
    int8 K/V: out within the sage suite's 2e-2, lse 1e-4."""
    import jax.numpy as jnp
    from long_context_attention_tpu.ops import kv_cache as jkv
    from long_context_attention_tpu.ops.sage import (
        sage_attention_fwd_prequant)

    q_off, kv_off, st, mk = DESCRIPTORS[case]
    q, k, v, _ = _desc_inputs(rng)
    kw = dict(q_offsets=list(q_off), kv_offsets=list(kv_off), q_stride=st,
              kv_stride=st, **mk)
    jk8, jks = jkv.quantize_kv(jnp.asarray(k), "int8")
    jv8, jvs = jkv.quantize_kv(jnp.asarray(v), "int8")
    jks, jvs = (jnp.swapaxes(x, 1, 2) for x in (jks, jvs))
    jo, jl = sage_attention_fwd_prequant(jnp.asarray(q), jk8, jv8, jks, jvs,
                                         **kw)
    t8 = [torch.from_numpy(np.asarray(x)) for x in (jk8, jv8, jks, jvs)]
    to, tl = tsage.sage_attention_fwd_prequant(torch.from_numpy(q), *t8, **kw)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=2e-2, rtol=0)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)


def test_kernel_descriptor_limits():
    """What the kernels' descriptor (pair_masks) refuses: three chunks, two
    strides, a multi-chunk side not cut in multiples of 128. One chunk a
    side at stride 1 is the old (q_start, left, right, sink) in local
    units."""
    P = tflash.Positions
    with pytest.raises(NotImplementedError, match="position chunks"):
        tflash.pair_masks(P((0, 128, 256), (0,)), 384, 128, -1, 0, 0)
    with pytest.raises(NotImplementedError, match="kv_stride"):
        tflash.pair_masks(P((0,), (0,), 2, 4), 128, 128, -1, 0, 0)
    with pytest.raises(ValueError, match="cross a position chunk"):
        tflash.pair_masks(P((0, 64), (0,)), 128, 128, -1, 0, 0)
    assert tflash.pair_masks(P.at(100), 64, 512, 256, 0, 4)[:7] == [
        1, 1, 64, 512, 100, 100 - 256, 4]


@pytest.mark.parametrize("layout", ["basic", "zigzag", "stripe"])
def test_bidir_descriptor_and_cu_seqlens_match_jax(layout):
    """bidir_position_descriptor for every (src_a, src_b) of a ring of 4,
    and segment_ids_from_cu_seqlens, equal JAX's exactly."""
    from long_context_attention_tpu.parallel import layouts as jlay

    for a in range(WORLD):
        for b in range(WORLD):
            offs, st = tlay.bidir_position_descriptor(layout, a, b, WORLD, 64)
            joffs, jst = jlay.bidir_position_descriptor(layout, a, b, WORLD,
                                                        64)
            np.testing.assert_array_equal(offs.numpy(), np.asarray(joffs))
            assert st == jst
    for cu, n in (([0, 3, 7, 12], 16), ([0, 5], 5), ([0, 2, 2, 9], 12)):
        np.testing.assert_array_equal(
            tlay.segment_ids_from_cu_seqlens(cu, n).numpy(),
            np.asarray(jlay.segment_ids_from_cu_seqlens(cu, n)))


# ---------------------------------------------------------------------------
# 4 gloo processes against JAX's ring on 4 virtual devices
# ---------------------------------------------------------------------------


def _jax_references(path: pathlib.Path) -> None:
    """Every case's JAX out, lse and gradients (global, natural order)."""
    import functools

    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    from long_context_attention_tpu.ops.kv_cache import (
        dequantize_kv, quantize_kv)
    from long_context_attention_tpu.ops.reference import xla_attention
    from long_context_attention_tpu.parallel.layouts import (
        permute_for_layout, unpermute_from_layout)
    from long_context_attention_tpu.parallel.ring import ring_attention_local

    mesh = Mesh(np.array(jax.devices()[:WORLD]), axis_names=("ring",))
    spec = P(None, "ring", None, None)
    lspec = P(None, None, "ring")
    arrays = _inputs()
    saved = {}
    for name, (kw, grads, dtype, ref) in CASES.items():
        jt = jnp.float32 if dtype == "f32" else jnp.bfloat16
        q, k, v, dout = (jnp.asarray(x, jt) for x in arrays)
        layout = kw["layout"]
        if ref == "dequant":
            def ste(x):
                xd = dequantize_kv(*quantize_kv(x, "int8"), x.dtype)
                return x + jax.lax.stop_gradient(xd - x)

            def fwd(q, k, v):
                return xla_attention(q, ste(k), ste(v), causal=True)
        else:
            rkw = dict(kw)
            if rkw.get("impl", "pallas") == "pallas":
                rkw["impl"] = "xla"
            perm = functools.partial(permute_for_layout, layout=layout,
                                     ring_size=WORLD)
            unperm = functools.partial(unpermute_from_layout, layout=layout,
                                       ring_size=WORLD)
            mapped = jax.jit(jax.shard_map(
                functools.partial(ring_attention_local, axis_name="ring",
                                  return_lse=True, **rkw),
                mesh=mesh, in_specs=(spec,) * 3, out_specs=(spec, lspec),
                check_vma=False))

            def fwd(q, k, v):
                o, l = mapped(perm(q), perm(k), perm(v))
                return unperm(o), unpermute_from_layout(
                    l, layout, WORLD, axis=2)
        def loss(q, k, v):
            out, lse = fwd(q, k, v)
            return (jnp.sum(out.astype(jnp.float32)
                            * dout.astype(jnp.float32)), (out, lse))

        if grads:
            (_, (out, lse)), gs = jax.jit(jax.value_and_grad(
                loss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
            for gname, g in zip(("dq", "dk", "dv"), gs):
                saved[f"{name}/{gname}"] = np.asarray(g, np.float32)
        else:
            out, lse = fwd(q, k, v)
        saved[f"{name}/out"] = np.asarray(out, np.float32)
        saved[f"{name}/lse"] = np.asarray(lse, np.float32)
    np.savez(path / "ref.npz", **saved)


def _worker(rank: int, tmp: str) -> None:
    """One gloo rank: every case through the port's ring_attention_local
    on this rank's shard; rank 0 writes the errors against JAX's."""
    from long_context_attention_tpu_torch.parallel.ring import (
        ring_attention_local)

    torch.set_num_threads(1)
    path = pathlib.Path(tmp)
    dist.init_process_group("gloo", init_method=f"file://{path}/rdzv",
                            rank=rank, world_size=WORLD)
    mesh = tmesh.make_usp_mesh(ring=WORLD, device="cpu")
    ref = np.load(path / "ref.npz")
    arrays = _inputs()
    errs = {}
    for name, (kw, grads, dtype, _) in CASES.items():
        td = torch.float32 if dtype == "f32" else torch.bfloat16
        layout = kw["layout"]
        full = [torch.from_numpy(x).to(td) for x in arrays]
        local = [tlay.extract_local(t, rank, WORLD, layout) for t in full]
        q, k, v = (t.clone().requires_grad_() for t in local[:3])
        out, lse = ring_attention_local(q, k, v, group=mesh.ring_group,
                                        return_lse=True, **kw)
        if grads:
            (out.float() * local[3].float()).sum().backward()

        def gather(t, axis=1):
            parts = [torch.empty_like(t) for _ in range(WORLD)]
            dist.all_gather(parts, t.contiguous())
            return tlay.unpermute_from_layout(torch.cat(parts, axis), layout,
                                              WORLD, axis=axis).float()

        got = {"out": gather(out.detach()), "lse": gather(lse, axis=2)}
        if grads:
            got.update(dq=gather(q.grad), dk=gather(k.grad),
                       dv=gather(v.grad))
        for key, t in got.items():
            want = ref[f"{name}/{key}"]
            fin = np.isfinite(want)
            same_inf = np.array_equal(np.isfinite(t.numpy()), fin)
            diff = np.abs(t.numpy()[fin] - want[fin]).max()
            if key in ("dq", "dk", "dv") and dtype == "f32":
                diff = diff / np.abs(want).max()  # of the largest value
            errs[f"{name}/{key}"] = float(diff) if same_inf else float("inf")
    if rank == 0:
        (path / "errs.json").write_text(json.dumps(errs))
    dist.barrier()
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def ring_errors(tmp_path_factory):
    path = tmp_path_factory.mktemp("ring")
    _jax_references(path)
    mp.start_processes(_worker, args=(str(path),), nprocs=WORLD, join=True,
                       start_method="spawn")
    return json.loads((path / "errs.json").read_text())


@pytest.mark.parametrize("case", CASES)
def test_ring_matches_jax(ring_errors, case):
    """The port's ring on 4 gloo ranks against JAX's ring on 4 devices: out
    and lse, and (where the case has them) dq, dk, dv."""
    kw, grads, dtype, _ = CASES[case]
    out_tol = F32_OUT if dtype == "f32" else BF16_TOL
    grad_tol = F32_GRAD if dtype == "f32" else BF16_TOL
    keys = ["out", "lse"] + (["dq", "dk", "dv"] if grads else [])
    for key in keys:
        tol = grad_tol if key.startswith("d") else out_tol
        assert ring_errors[f"{case}/{key}"] <= tol, (key, ring_errors)
