"""ALiBi and the counter-hash attention dropout of the PyTorch port against
the JAX package (kernels B3, B2a, B2b; the ring; the dense USP layer).

In this process: the port's plain keep mask (``flash.dropout_keep``)
against the mask JAX's Pallas kernel draws (interpret mode), bit for bit,
read off ``flash_attention`` with V the identity (out[i, j] != 0 exactly
where pair (i, j) is kept) at global offsets above 2^20, batch 2 and head
base 5; ALiBi and dropout forward and gradients against JAX's
``flash_attention`` / ``flash_attention_bwd`` at one-chunk, two-chunk and
strided descriptors, causal and not, GQA 4/2; and the ``xla`` impl's fault
that the port does not copy (JAX's drops the ALiBi bias silently, the
port's raises).

In 4 gloo processes on the CPU (one spawn, one rendezvous): the ring with
ALiBi and dropout (basic, zigzag, stripe, bidirectional zigzag, with
gradients) against JAX's ring on the 4-device virtual mesh of
``tests/conftest.py``, and the dense USP layer at ulysses 2 x ring 2
against JAX's ``LongContextAttention`` (the slopes' head-block slice and
the dropout seed's head base), JAX's drawn dropout word passed to the port
as its key. Workers never import JAX.

Tolerances: fp32 on both sides, outputs and lse within 1e-5 absolute and
relative, gradients within 1e-5 of their largest value (the same fp32
arithmetic summed in another order; the ring tests' rule); bf16 within
1e-1, the reference's bf16 gate.
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
BF16 = dict(atol=1e-1, rtol=0)
SLOPES = np.geomspace(1.0 / 2, 1.0 / 16, H).astype(np.float32)
SEED = (9999, 0)
P_DROP = 0.3


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().float()
    return np.asarray(x, np.float32)


def _assert_grad(got, want, tol):
    """A gradient against JAX's: fp32 within F32_GRAD of its largest value,
    bf16 within the bf16 gate."""
    got, want = _np(got), _np(want)
    if tol is F32:
        assert np.abs(got - want).max() <= F32_GRAD * np.abs(want).max()
    else:
        np.testing.assert_allclose(got, want, **tol)


def _inputs(dtype=np.float32, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(dtype)
                 for shape in ((B, S, H, D), (B, S, HKV, D), (B, S, HKV, D),
                               (B, S, H, D)))


# ---------------------------------------------------------------------------
# in this process
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("p", [0.1, 0.5])
def test_keep_mask_matches_jax_kernel(p):
    """flash.dropout_keep equals the keep mask of JAX's Pallas kernel bit
    for bit (V the identity: out != 0 exactly where kept), and the port's
    flash_attention gives the same pattern: batch 2, head base 5, q and kv
    at global offsets above 2^20."""
    import jax.numpy as jnp
    from long_context_attention_tpu.ops.flash import flash_attention

    b, h, sq, skv, d = 2, 4, 256, 128, 128
    rng = np.random.default_rng(3)
    q = (0.1 * rng.standard_normal((b, sq, h, d))).astype(np.float32)
    k = (0.1 * rng.standard_normal((b, skv, h, d))).astype(np.float32)
    v = np.broadcast_to(np.eye(skv, d, dtype=np.float32)[None, :, None],
                        (b, skv, h, d)).copy()
    qo, ko = (1 << 20) + 4133, (1 << 21) + 77
    seed = (123456789, 5)
    kw = dict(q_offsets=[qo], kv_offsets=[ko], dropout_p=p)
    jout = flash_attention(*(jnp.asarray(x) for x in (q, k, v)),
                           dropout_seed=jnp.asarray(seed, jnp.int32),
                           interpret=True, **kw)
    jkeep = np.asarray(jout) != 0
    keep = tflash.dropout_keep(seed, torch.arange(sq) + qo,
                               torch.arange(skv) + ko, b, h, p)
    np.testing.assert_array_equal(keep.permute(0, 2, 1, 3).numpy(), jkeep)
    tout = tflash.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                                  dropout_seed=seed, **kw)
    np.testing.assert_array_equal(tout.numpy() != 0, jkeep)
    assert abs(jkeep.mean() - (1 - p)) < 0.02


# name: (feature kwargs, causal, descriptor kwargs, dtype)
FEATURE_CASES = {
    "alibi causal": ("alibi", True, {}, "f32"),
    "alibi noncausal two chunks": (
        "alibi", False, dict(q_offsets=[0, 384], kv_offsets=[128, 256]),
        "f32"),
    "dropout causal strided": (
        "dropout", True, dict(q_offsets=[3], kv_offsets=[1], q_stride=4,
                              kv_stride=4), "f32"),
    "dropout noncausal": ("dropout", False, {}, "f32"),
    "alibi dropout causal two chunks": (
        "both", True, dict(q_offsets=[0, 384], kv_offsets=[128, 256]),
        "f32"),
    "alibi dropout causal strided": (
        "both", True, dict(q_offsets=[3], kv_offsets=[1], q_stride=4,
                           kv_stride=4), "f32"),
    "alibi dropout causal bf16": ("both", True, {}, "bf16"),
    "alibi dropout two chunks bf16": (
        "both", True, dict(q_offsets=[0, 384], kv_offsets=[128, 256]),
        "bf16"),
}


def _features(kind, jax_side):
    kw = {}
    if kind in ("alibi", "both"):
        kw["alibi_slopes"] = SLOPES
    if kind in ("dropout", "both"):
        kw["dropout_p"] = P_DROP
        kw["dropout_seed"] = SEED
        if jax_side:
            import jax.numpy as jnp
            kw["dropout_seed"] = jnp.asarray(SEED, jnp.int32)
    return kw


@pytest.mark.parametrize("case", FEATURE_CASES)
def test_features_match_jax(case):
    """Forward (out, lse), autograd gradients and flash_attention_bwd with
    ALiBi and/or dropout against JAX's flash_attention (its custom VJP) and
    flash_attention_bwd on the same inputs: B3 and B2a + B2b's plain
    versions at the case's descriptor."""
    import jax
    import jax.numpy as jnp
    from long_context_attention_tpu.ops.flash import (
        flash_attention, flash_attention_bwd)

    kind, causal, desc, dtype = FEATURE_CASES[case]
    jd = jnp.float32 if dtype == "f32" else jnp.bfloat16
    td = torch.float32 if dtype == "f32" else torch.bfloat16
    tol = F32 if dtype == "f32" else BF16
    jx = [jnp.asarray(x, jd) for x in _inputs()]
    tx = [torch.tensor(_np(x)).to(td) for x in jx]
    jkw = dict(causal=causal, **desc, **_features(kind, True))
    tkw = dict(causal=causal, **desc, **_features(kind, False))

    def jfwd(q, k, v):
        return flash_attention(q, k, v, return_lse=True, interpret=True,
                               **jkw)

    (jo, jl), vjp = jax.vjp(jfwd, *jx[:3])
    jg = vjp((jx[3], jnp.zeros_like(jl)))
    leaves = [t.clone().requires_grad_() for t in tx[:3]]
    to, tl = tflash.flash_attention(*leaves, return_lse=True, **tkw)
    (to.float() * tx[3].float()).sum().backward()
    np.testing.assert_allclose(_np(to.detach()), _np(jo), **tol)
    np.testing.assert_allclose(tl.detach().numpy(), _np(jl), **tol)
    for g, w in zip(leaves, jg):
        _assert_grad(g.grad, w, tol)
    # the backward-only entry (the ring's per-step call) on JAX's (out, lse)
    want = flash_attention_bwd(*jx[:3], jo, jl, jx[3], interpret=True,
                               **jkw)
    got = tflash.flash_attention_bwd(
        *tx[:3], torch.tensor(_np(jo)).to(td), torch.tensor(_np(jl)),
        tx[3], **tkw)
    for g, w in zip(got, want):
        _assert_grad(g, w, tol)


def test_xla_impl_drops_alibi_in_jax_and_raises_in_port():
    """The reference's fault the port does not copy: JAX's ``xla`` impl
    forwards neither ALiBi nor dropout (its registry's _xla_kw), so its
    ring with ``impl="xla"`` and slopes equals the ring without them, while
    the Pallas kernel's output moves. The port's ``xla`` impl raises
    ValueError for ALiBi and dropout, and its ring refuses ALiBi unless
    ``impl="pallas"``."""
    import functools

    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P
    from long_context_attention_tpu.ops.flash import flash_attention
    from long_context_attention_tpu.ops.registry import (
        get_attn_impl as jimpl)
    from long_context_attention_tpu.parallel.ring import ring_attention_local

    from long_context_attention_tpu_torch.ops.registry import get_attn_impl
    from long_context_attention_tpu_torch.parallel.ring import (
        ring_attention_local as tring)

    q, k, v, _ = (jnp.asarray(x) for x in _inputs())
    mesh = Mesh(np.array(jax.devices()[:WORLD]), axis_names=("ring",))
    spec = P(None, "ring", None, None)

    def ring(**kw):
        fn = functools.partial(ring_attention_local, axis_name="ring",
                               layout="zigzag", causal=True, impl="xla", **kw)
        return np.asarray(jax.jit(jax.shard_map(
            fn, mesh=mesh, in_specs=(spec,) * 3, out_specs=spec,
            check_vma=False))(q, k, v))

    np.testing.assert_array_equal(ring(alibi_slopes=SLOPES), ring())
    xo, _ = jimpl("xla").fwd(q, k, v, causal=True, alibi_slopes=SLOPES)
    np.testing.assert_array_equal(
        np.asarray(xo), np.asarray(jimpl("xla").fwd(q, k, v, causal=True)[0]))
    biased = flash_attention(q, k, v, causal=True, alibi_slopes=SLOPES,
                             interpret=True)
    assert np.abs(np.asarray(biased) - np.asarray(xo)).max() > 0.1

    tq, tk, tv, _ = (torch.from_numpy(x) for x in _inputs())
    xla = get_attn_impl("xla")
    for kw in (dict(alibi_slopes=torch.from_numpy(SLOPES)),
               dict(dropout_p=0.5, dropout_seed=(1, 0))):
        with pytest.raises(ValueError, match="silently dropping"):
            xla.fwd(tq, tk, tv, causal=True, **kw)
        with pytest.raises(ValueError, match="silently dropping"):
            xla.bwd(tq, tk, tv, tq, torch.zeros(B, H, S), tq, causal=True,
                    **kw)
    for impl in ("xla", "sage"):
        with pytest.raises(ValueError, match="ALiBi requires the pallas"):
            tring(tq, tk, tv, causal=True, impl=impl,
                  alibi_slopes=torch.from_numpy(SLOPES))


# ---------------------------------------------------------------------------
# 4 gloo processes against JAX's ring and USP layer on 4 virtual devices
# ---------------------------------------------------------------------------

# name: (kind, ring layout or USP (ulysses, ring), ring kwargs)
DIST_CASES = {
    "ring basic": ("ring", "basic", {}),
    "ring zigzag": ("ring", "zigzag", {}),
    "ring stripe": ("ring", "stripe", {}),
    "ring bidirectional zigzag": ("ring", "zigzag",
                                  dict(bidirectional=True)),
    "usp 2x2 zigzag": ("usp", "zigzag", {}),
}
USP_KEY = 11  # jax.random.PRNGKey of the USP case's dropout


def _jax_references(path: pathlib.Path) -> None:
    """Each distributed case's JAX out and gradients (global, natural
    order), and the USP case's drawn dropout word."""
    import functools

    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    from long_context_attention_tpu.parallel import mesh as jmesh
    from long_context_attention_tpu.parallel import usp as jusp
    from long_context_attention_tpu.parallel.layouts import (
        permute_for_layout, unpermute_from_layout)
    from long_context_attention_tpu.parallel.ring import ring_attention_local

    devs = jax.devices()[:WORLD]
    q, k, v, dout = (jnp.asarray(x) for x in _inputs(seed=1))
    saved = {}
    for name, (kind, layout, kw) in DIST_CASES.items():
        ring = WORLD if kind == "ring" else 2
        perm = functools.partial(permute_for_layout, layout=layout,
                                 ring_size=ring)
        unperm = functools.partial(unpermute_from_layout, layout=layout,
                                   ring_size=ring)
        if kind == "ring":
            mesh = Mesh(np.array(devs), axis_names=("ring",))
            spec = P(None, "ring", None, None)
            fn = jax.shard_map(
                functools.partial(
                    ring_attention_local, axis_name="ring", layout=layout,
                    causal=True, alibi_slopes=SLOPES, dropout_p=P_DROP,
                    dropout_seed=jnp.asarray(SEED, jnp.int32),
                    interpret=True, **kw),
                mesh=mesh, in_specs=(spec,) * 3, out_specs=spec,
                check_vma=False)
        else:
            jm = jmesh.make_usp_mesh(ulysses=2, ring=2, devices=devs)
            key = jax.random.PRNGKey(USP_KEY)
            saved["usp/word"] = np.asarray(
                jax.random.bits(key, (1,), jnp.uint32))
            fn = functools.partial(
                jusp.LongContextAttention(mesh=jm, layout=layout,
                                          interpret=True),
                causal=True, alibi_slopes=SLOPES, dropout_p=P_DROP,
                dropout_key=key)

        def loss(q, k, v):
            out = fn(q, k, v)
            return jnp.sum(out * perm(dout)), out

        (_, out), grads = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1, 2), has_aux=True))(perm(q), perm(k),
                                                     perm(v))
        saved[f"{name}/out"] = np.asarray(unperm(out))
        for gname, g in zip(("dq", "dk", "dv"), grads):
            saved[f"{name}/{gname}"] = np.asarray(unperm(g))
    np.savez(path / "ref.npz", **saved)


def _worker(rank: int, tmp: str) -> None:
    """One gloo rank: every distributed case through the port; rank 0
    writes the errors against JAX's."""
    from long_context_attention_tpu_torch.parallel import usp as tusp
    from long_context_attention_tpu_torch.parallel.ring import (
        ring_attention_local)

    torch.set_num_threads(1)
    path = pathlib.Path(tmp)
    dist.init_process_group("gloo", init_method=f"file://{path}/rdzv",
                            rank=rank, world_size=WORLD)
    ref = np.load(path / "ref.npz")
    q, k, v, dout = (torch.from_numpy(x) for x in _inputs(seed=1))
    slopes = torch.from_numpy(SLOPES)
    errs = {}
    for name, (kind, layout, kw) in DIST_CASES.items():
        ring = WORLD if kind == "ring" else 2
        mesh = tmesh.make_usp_mesh(ulysses=WORLD // ring, ring=ring,
                                   device="cpu")
        shard = [tmesh.seq_shard(mesh, tlay.permute_for_layout(t, layout,
                                                               ring))
                 for t in (q, k, v, dout)]
        leaves = [t.clone().requires_grad_() for t in shard[:3]]
        if kind == "ring":
            out = ring_attention_local(
                *leaves, group=mesh.ring_group, layout=layout, causal=True,
                alibi_slopes=slopes, dropout_p=P_DROP, dropout_seed=SEED,
                **kw)
        else:  # JAX's drawn word as the key: the same bits
            out = tusp.LongContextAttention(mesh, layout=layout)(
                *leaves, causal=True, alibi_slopes=slopes, dropout_p=P_DROP,
                dropout_key=int(ref["usp/word"][0]))
        out.backward(shard[3])
        for gname, t in zip(("out", "dq", "dk", "dv"),
                            (out, *(x.grad for x in leaves))):
            got = tlay.unpermute_from_layout(
                tmesh.seq_unshard(mesh, t.detach()), layout, ring).numpy()
            want = ref[f"{name}/{gname}"]
            bound = (F32["atol"] + F32["rtol"] * np.abs(want)
                     if gname == "out" else F32_GRAD * np.abs(want).max())
            errs[f"{name}/{gname}"] = float(np.max(np.abs(got - want)
                                                   / bound))
    if rank == 0:
        (path / "errs.json").write_text(json.dumps(errs))
    dist.barrier()
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def dist_errors(tmp_path_factory):
    path = tmp_path_factory.mktemp("dropout_alibi")
    _jax_references(path)
    mp.start_processes(_worker, args=(str(path),), nprocs=WORLD, join=True,
                       start_method="spawn")
    return json.loads((path / "errs.json").read_text())


@pytest.mark.parametrize("case", DIST_CASES)
def test_distributed_matches_jax(dist_errors, case):
    """The port's ring (4 gloo ranks) or dense USP layer (ulysses 2 x ring
    2) with ALiBi and dropout against JAX's on 4 devices: out within 1e-5
    absolute + 1e-5 relative, dq, dk, dv within 1e-5 of their largest
    value (the error here is in units of that bound)."""
    for key in ("out", "dq", "dk", "dv"):
        assert dist_errors[f"{case}/{key}"] <= 1.0, (key, dist_errors)
