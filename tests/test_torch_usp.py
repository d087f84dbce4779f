"""USP of the PyTorch port against the JAX package: the mesh's rank grid
and the layouts (exact, in this process), and, in 4 gloo processes on the
CPU, the Ulysses all-to-all against JAX's tiled ``lax.all_to_all`` (exact),
the sparse layers and the dense layers (LongContextAttention, its
``.packed``, UlyssesAttention; the cases of ``tests/test_usp.py``) against
JAX's layers on the 4-device virtual mesh of ``tests/conftest.py``, on the
same global inputs (the pattern of ``tests/test_ring_sparse.py:178-200``).
JAX's dense layers run the fp32 oracle per ring step (impl ``xla``), the
port's the kernels' plain versions (impl ``pallas``).

The JAX side runs first, in the test process; one spawn of 4 workers then
runs every port case and writes its errors, and each case is its own test.
Workers never import JAX (a spawned worker imports this module afresh).

Tolerances (those of ``tests/test_sparse.py``): fp32 outputs 2e-5 and
gradients 2e-4, the same fp32 arithmetic in another summation order.
"""

import json
import pathlib

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from long_context_attention_tpu_torch.ops import sparse as tsp
from long_context_attention_tpu_torch.parallel import layouts as tlay
from long_context_attention_tpu_torch.parallel import mesh as tmesh

torch.set_num_threads(1)

WORLD = 4
B, H, HKV, D = 1, 8, 4, 64
BQ = BKV = 64
OUT_TOL = 2e-5
GRAD_TOL = 2e-4

# name: (layer, (dp, ulysses, ring), layout, seq, mask kind; None: dense,
# with gradients but for "packed")
CASES = {
    "dense 2x2 zigzag": ("usp", (1, 2, 2), "zigzag", 256, None),
    "dense 2x2 basic": ("usp", (1, 2, 2), "basic", 256, None),
    "dense 2x2 stripe": ("usp", (1, 2, 2), "stripe", 256, None),
    "dense 4x1 zigzag": ("usp", (1, 4, 1), "zigzag", 256, None),
    "dense dp2 ring2": ("usp", (2, 1, 2), "zigzag", 256, None),
    "dense non-causal basic": ("usp noncausal", (1, 2, 2), "basic", 256,
                               None),
    "dense packed": ("packed", (1, 2, 2), "zigzag", 256, None),
    "dense ulysses 4": ("ulysses", (1, 4, 1), "basic", 256, None),
    "usp 2x2 basic": ("usp", (1, 2, 2), "basic", 256, "global_local"),
    "usp 2x2 zigzag": ("usp", (1, 2, 2), "zigzag", 256, "global_local"),
    "usp 2x2 per-head": ("usp", (1, 2, 2), "zigzag", 256, "per_head"),
    "ring 4 zigzag": ("ring", (1, 1, 4), "zigzag", 512, "window"),
    "ulysses 4": ("ulysses", (1, 4, 1), "basic", 256, "global_local"),
}


def _mask(kind, s):
    n = s // BQ
    if kind == "global_local":
        return tsp.global_local_block_mask(n, n, 2, sink_tiles=1)
    if kind == "window":
        return tsp.sliding_window_block_mask(n, n, 3)
    rs = np.random.RandomState(7)
    m = np.stack([rs.rand(n, n) < 0.4 for _ in range(H)])
    return m | np.eye(n, dtype=bool)[None]


def _inputs(s, batch=B):
    rng = np.random.default_rng(0)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((batch, s, H, D), (batch, s, HKV, D),
                               (batch, s, HKV, D), (batch, s, H, D)))


def _dense_inputs(name, s):
    """A dense case's global q, k, v, dout: batch 2 under dp 2, and for the
    packed layer k and v with every query head (qkv stacked on one axis)."""
    q, k, v, dout = _inputs(s, 2 if "dp2" in name else B)
    if name == "dense packed":
        k, v = (np.repeat(x, H // HKV, axis=2) for x in (k, v))
    return q, k, v, dout


# ---------------------------------------------------------------------------
# in this process: the rank grid and the layouts (exact)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ulysses_low", [True, False])
@pytest.mark.parametrize("dp,ulysses,ring", [(1, 2, 2), (2, 2, 1), (1, 1, 4)])
def test_rank_grid_matches_jax_mesh(dp, ulysses, ring, ulysses_low):
    """usp_rank_grid is JAX's make_usp_mesh device grid for an explicit
    device list, with rank i in the place of device i."""
    import jax
    from long_context_attention_tpu.parallel.mesh import make_usp_mesh

    n = dp * ulysses * ring
    jm = make_usp_mesh(dp=dp, ulysses=ulysses, ring=ring,
                       devices=jax.devices()[:n], ulysses_low=ulysses_low)
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    np.testing.assert_array_equal(
        tmesh.usp_rank_grid(dp, ulysses, ring, ulysses_low=ulysses_low), ids)
    assert jm.axis_names == ("dp", "ring", "ulysses")


@pytest.mark.parametrize("ring", [2, 4])
@pytest.mark.parametrize("layout", ["basic", "zigzag", "stripe"])
def test_layouts_match_jax(layout, ring):
    """The permutation, permute/unpermute, extract_local and each rank's
    position descriptor equal JAX's."""
    import jax.numpy as jnp
    from long_context_attention_tpu.parallel import layouts as jlay

    seq = 32
    x = np.random.default_rng(1).standard_normal((2, seq, 3)).astype(np.float32)
    np.testing.assert_array_equal(tlay.layout_permutation(layout, ring, seq),
                                  jlay.layout_permutation(layout, ring, seq))
    perm = tlay.permute_for_layout(torch.from_numpy(x), layout, ring)
    np.testing.assert_array_equal(
        perm.numpy(), np.asarray(jlay.permute_for_layout(jnp.asarray(x),
                                                         layout, ring)))
    np.testing.assert_array_equal(
        tlay.unpermute_from_layout(perm, layout, ring).numpy(), x)
    for r in range(ring):
        np.testing.assert_array_equal(
            tlay.extract_local(torch.from_numpy(x), r, ring, layout).numpy(),
            np.asarray(jlay.extract_local(jnp.asarray(x), r, ring, layout)))
        offs, stride = tlay.position_descriptor(layout, r, ring, seq // ring)
        j_offs, j_stride = jlay.position_descriptor(layout, r, ring,
                                                    seq // ring)
        np.testing.assert_array_equal(offs.numpy(), np.asarray(j_offs))
        assert stride == j_stride


def test_mesh_raises(monkeypatch):
    """make_usp_mesh() is the card (NCCL): RuntimeError without CUDA; a
    mesh of several ranks needs an initialised world; tp/pp/ep raise
    NotImplementedError. On a one-rank gloo world the dense layers equal
    flash_attention (a zigzag ring of one: the two-chunk descriptor (0,
    s/2)), and they raise for what is not ported (segments, fp8 K/V); the
    sparse layers raise for stripe and for a window beside a block mask."""
    from long_context_attention_tpu_torch.ops.flash import flash_attention
    from long_context_attention_tpu_torch.parallel.usp import (
        LongContextAttention, UlyssesAttention)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmesh.make_usp_mesh()
    with pytest.raises(NotImplementedError, match="tensor, pipeline"):
        tmesh.make_usp_mesh(tp=2, device="cpu")
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="not initialised"):
        tmesh.make_usp_mesh(dp=2, device="cpu")
    mesh = tmesh.make_usp_mesh(device="cpu")
    try:
        assert (mesh.rank, mesh.seq_idx, mesh.ring_next) == (0, 0, 0)
        q = torch.zeros(1, 128, 2, 64)
        mask = np.ones((2, 2), bool)
        x = torch.randn(1, 128, 2, 64, generator=torch.Generator()
                        .manual_seed(0))
        want = flash_attention(x, x, x, causal=True)
        got = LongContextAttention(mesh)(x, x, x, causal=True)
        torch.testing.assert_close(got, want, atol=1e-6, rtol=0)
        torch.testing.assert_close(UlyssesAttention(mesh)(x, x, x),
                                   flash_attention(x, x, x), atol=1e-6,
                                   rtol=0)
        with pytest.raises(NotImplementedError, match="segment_ids"):
            LongContextAttention(mesh)(
                q, q, q, causal=True,
                segment_ids=torch.zeros(1, 128, dtype=torch.int32))
        with pytest.raises(NotImplementedError, match="fp8"):
            LongContextAttention(mesh, kv_quant="float8_e4m3fn")(
                q, q, q, causal=True)
        with pytest.raises(NotImplementedError, match="stripe"):
            LongContextAttention(mesh, layout="stripe")(
                q, q, q, block_mask=mask, sparse_block_q=64,
                sparse_block_kv=64)
        with pytest.raises(NotImplementedError, match="encode"):
            LongContextAttention(mesh)(q, q, q, block_mask=mask,
                                       window_size=(64, 0))
        out = LongContextAttention(mesh, layout="basic")(
            q, q, q, causal=True, block_mask=mask, sparse_block_q=64,
            sparse_block_kv=64)
        assert out.shape == q.shape
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# 4 gloo processes against JAX on 4 virtual devices
# ---------------------------------------------------------------------------


def _jax_references(path: pathlib.Path) -> None:
    """Every case's JAX results (global arrays, sequence in natural order)
    and the all-to-all references, saved for the workers."""
    import functools

    import jax
    import jax.numpy as jnp
    from jax import lax
    from jax.sharding import Mesh, PartitionSpec as P

    from long_context_attention_tpu.parallel import mesh as jmesh
    from long_context_attention_tpu.parallel import usp as jusp
    from long_context_attention_tpu.parallel.layouts import (
        permute_for_layout, unpermute_from_layout)
    from long_context_attention_tpu.parallel.ring_sparse import (
        ring_sparse_attention_local)

    devs = jax.devices()[:WORLD]
    saved = {}
    for name, (layer, (dp, uly, ring), layout, s, kind) in CASES.items():
        jm = jmesh.make_usp_mesh(dp=dp, ulysses=uly, ring=ring, devices=devs)
        perm = functools.partial(permute_for_layout, layout=layout,
                                 ring_size=ring)
        unperm = functools.partial(unpermute_from_layout, layout=layout,
                                   ring_size=ring)
        if kind is None:  # the dense layers, the fp32 oracle per ring step
            q, k, v, dout = (jnp.asarray(x) for x in _dense_inputs(name, s))
            if layer == "ulysses":
                fn = functools.partial(
                    jusp.UlyssesAttention(mesh=jm, impl="xla"), causal=True)
            else:
                lca = jusp.LongContextAttention(mesh=jm, layout=layout,
                                                impl="xla")
                fn = functools.partial(lca, causal=layer != "usp noncausal")
            if layer == "packed":
                qkv = jnp.stack([q, k, v], axis=2)
                saved[f"{name}/out"] = np.asarray(unperm(jax.jit(
                    functools.partial(lca.packed, causal=True))(perm(qkv))))
                continue
            def dloss(q, k, v):
                out = fn(q, k, v)
                return jnp.sum(out * perm(dout)), out

            (_, out), grads = jax.jit(jax.value_and_grad(
                dloss, argnums=(0, 1, 2), has_aux=True))(perm(q), perm(k),
                                                         perm(v))
            saved[f"{name}/out"] = np.asarray(unperm(out))
            for gname, g in zip(("dq", "dk", "dv"), grads):
                saved[f"{name}/{gname}"] = np.asarray(unperm(g))
            continue
        q, k, v, dout = (jnp.asarray(x) for x in _inputs(s))
        mask = _mask(kind, s)
        kw = dict(causal=True, block_mask=mask, sparse_block_q=BQ,
                  sparse_block_kv=BKV)
        if layer == "usp":
            fn = functools.partial(jusp.LongContextAttention(
                mesh=jm, layout=layout), **kw)
        elif layer == "ulysses":
            fn = functools.partial(jusp.UlyssesAttention(mesh=jm), **kw)
        else:
            rmesh = Mesh(np.array(devs), axis_names=("ring",))
            spec = P(None, "ring", None, None)
            fn = jax.shard_map(
                functools.partial(ring_sparse_attention_local, block_mask=mask,
                                  axis_name="ring", layout=layout,
                                  causal=True, block_q=BQ, block_kv=BKV),
                mesh=rmesh, in_specs=(spec,) * 3, out_specs=spec,
                check_vma=False)
        out = unperm(jax.jit(fn)(perm(q), perm(k), perm(v)))
        saved[f"{name}/out"] = np.asarray(out)

        def loss(q, k, v):
            return jnp.sum(fn(q, k, v) * perm(dout))

        grads = [unperm(g) for g in jax.grad(loss, argnums=(0, 1, 2))(
            perm(q), perm(k), perm(v))]
        for gname, g in zip(("dq", "dk", "dv"), grads):
            saved[f"{name}/{gname}"] = np.asarray(g)

    # the all-to-all: x sharded over the sequence on 4 devices in rank
    # order, ulysses groups of U consecutive devices; each device's output
    # concatenated along the sequence in rank order
    x = np.random.default_rng(2).standard_normal((2, 32, 8, 4)).astype(
        np.float32)
    saved["a2a/x"] = x
    for u in (2, 4):
        amesh = Mesh(np.array(devs).reshape(WORLD // u, u), ("r", "u"))
        spec = P(None, ("r", "u"), None, None)
        for name, split, concat in (("scatter", 2, 1), ("gather", 1, 2)):
            f = jax.shard_map(
                functools.partial(lax.all_to_all, axis_name="u",
                                  split_axis=split, concat_axis=concat,
                                  tiled=True),
                mesh=amesh, in_specs=spec, out_specs=spec, check_vma=False)
            saved[f"a2a/{name}{u}"] = np.asarray(jax.jit(f)(jnp.asarray(x)))
    np.savez(path / "ref.npz", **saved)


def _err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64) - b)))


def _worker(rank: int, tmp: str) -> None:
    """One gloo rank: every port case, errors written by rank 0."""
    from long_context_attention_tpu_torch.parallel import ulysses as tuly
    from long_context_attention_tpu_torch.parallel import usp as tusp
    from long_context_attention_tpu_torch.parallel.ring_sparse import (
        ring_sparse_attention_local)

    torch.set_num_threads(1)
    path = pathlib.Path(tmp)
    dist.init_process_group("gloo", init_method=f"file://{path}/rdzv",
                            rank=rank, world_size=WORLD)
    ref = np.load(path / "ref.npz")
    errs = {}
    for name, (layer, (dp, uly, ring), layout, s, kind) in CASES.items():
        mesh = tmesh.make_usp_mesh(dp=dp, ulysses=uly, ring=ring,
                                   device="cpu")
        inputs = _inputs(s) if kind else _dense_inputs(name, s)
        q, k, v, dout = (torch.from_numpy(x) for x in inputs)
        shard = [tmesh.seq_shard(mesh, tlay.permute_for_layout(t, layout, ring))
                 for t in (q, k, v, dout)]
        q_l, k_l, v_l = (t.clone().requires_grad_() for t in shard[:3])

        def unshard(t):
            return tlay.unpermute_from_layout(
                tmesh.seq_unshard(mesh, t.detach()), layout, ring)

        if layer == "packed":
            out = tusp.LongContextAttention(mesh, layout=layout).packed(
                torch.stack(shard[:3], dim=2), causal=True)
            errs[f"{name}/out"] = _err(unshard(out).numpy(),
                                       ref[f"{name}/out"])
            continue
        if kind is None and layer == "ulysses":
            out = tusp.UlyssesAttention(mesh)(q_l, k_l, v_l, causal=True)
        elif kind is None:
            out = tusp.LongContextAttention(mesh, layout=layout)(
                q_l, k_l, v_l, causal=layer != "usp noncausal")
        elif layer == "ring":
            out = ring_sparse_attention_local(
                q_l, k_l, v_l, _mask(kind, s), group=mesh.ring_group,
                layout=layout, causal=True, block_q=BQ, block_kv=BKV)
        else:
            cls = (tusp.LongContextAttention if layer == "usp"
                   else tusp.UlyssesAttention)
            out = cls(mesh, layout=layout)(
                q_l, k_l, v_l, causal=True, block_mask=_mask(kind, s),
                sparse_block_q=BQ, sparse_block_kv=BKV)
        out.backward(shard[3])
        for gname, t in (("out", out), ("dq", q_l.grad), ("dk", k_l.grad),
                         ("dv", v_l.grad)):
            errs[f"{name}/{gname}"] = _err(unshard(t).numpy(),
                                           ref[f"{name}/{gname}"])

    x = torch.from_numpy(ref["a2a/x"])
    for u in (2, 4):
        mesh = tmesh.make_usp_mesh(dp=1, ulysses=u, ring=WORLD // u,
                                   device="cpu")
        x_l = tmesh.seq_shard(mesh, x).clone().requires_grad_()
        y = tuly.scatter_heads(x_l, mesh.ulysses_group)
        want = ref[f"a2a/scatter{u}"]
        errs[f"a2a scatter {u}"] = _err(
            y.detach().numpy(), np.split(want, WORLD, axis=1)[rank])
        z = tuly.gather_heads(y, mesh.ulysses_group)
        errs[f"a2a round trip {u}"] = _err(z.detach().numpy(),
                                           x_l.detach().numpy())
        w = torch.randn(y.shape, generator=torch.Generator().manual_seed(rank))
        y.backward(w)  # the backward of scatter is gather
        errs[f"a2a scatter backward {u}"] = _err(
            x_l.grad.numpy(), tuly.gather_heads(w, mesh.ulysses_group).numpy())
        g = tuly.gather_heads(x_l.detach(), mesh.ulysses_group)
        errs[f"a2a gather {u}"] = _err(
            g.numpy(), np.split(ref[f"a2a/gather{u}"], WORLD, axis=1)[rank])
    if rank == 0:
        (path / "errs.json").write_text(json.dumps(errs))
    dist.barrier()
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def port_errors(tmp_path_factory):
    path = tmp_path_factory.mktemp("usp")
    _jax_references(path)
    mp.start_processes(_worker, args=(str(path),), nprocs=WORLD, join=True,
                       start_method="spawn")
    return json.loads((path / "errs.json").read_text())


SPARSE_CASES = [n for n, c in CASES.items() if c[4] is not None]
DENSE_CASES = [n for n, c in CASES.items() if c[4] is None]


@pytest.mark.parametrize("case", SPARSE_CASES)
def test_sparse_layers_match_jax(port_errors, case):
    """Out of the port's layer (LongContextAttention at ring 2 x ulysses 2,
    basic, zigzag and per-head; ring_sparse_attention_local at ring 4;
    UlyssesAttention at ulysses 4) and its three gradients against JAX's
    on the same global inputs."""
    assert port_errors[f"{case}/out"] <= OUT_TOL, port_errors
    for g in ("dq", "dk", "dv"):
        assert port_errors[f"{case}/{g}"] <= GRAD_TOL, (g, port_errors)


@pytest.mark.parametrize("case", DENSE_CASES)
def test_dense_layers_match_jax(port_errors, case):
    """Out of the port's dense layers (LongContextAttention at ulysses 2 x
    ring 2 in each layout, causal and not, at ulysses 4 x ring 1 and at dp
    2 x ring 2; its .packed; UlyssesAttention at ulysses 4) and, but for
    the packed entry, the three gradients against JAX's layers on the same
    global inputs (tests/test_usp.py's cases)."""
    assert port_errors[f"{case}/out"] <= OUT_TOL, port_errors
    if case != "dense packed":
        for g in ("dq", "dk", "dv"):
            assert port_errors[f"{case}/{g}"] <= GRAD_TOL, (g, port_errors)


@pytest.mark.parametrize("u", [2, 4])
def test_all_to_all_matches_jax(port_errors, u):
    """scatter_heads and gather_heads equal JAX's tiled lax.all_to_all
    element for element, the round trip is the identity, and the backward
    of scatter is gather."""
    for what in ("scatter", "gather", "round trip", "scatter backward"):
        assert port_errors[f"a2a {what} {u}"] == 0.0, (what, port_errors)
