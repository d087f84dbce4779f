"""Sage's int8 PV product (``pv_int8=True``) in the PyTorch port against the
JAX package, on the same numpy inputs (d = 64): the plain versions of
kernels B8a (causal), B8c (no mask) and B8b (positions, window, sinks)
through ``sage_attention`` against JAX's ``sage_attention(pv_int8=True)``
in interpret mode, under ``BlockSizes(64, 64)`` and the default tiles; the
registry entries and the pre-quantized entry; the tile rule that groups P's
requantization; that the grouping changes the result; and the
straight-through gradient.

Tolerances (those of B7's s8-path sweep): out within 2e-2 with at most 1%
of the elements more than 1e-4 apart, lse within 1e-4. Both sides requantize
the same fp32 p * vs per row and group with the same fp32 ps, divide and
round half to even, and sum the int8 products exactly; the exp2
implementations may differ in a last bit, which can move a p8 across a
rounding boundary (one level, ps of that term), and the groups' scaled sums
add in another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from long_context_attention_tpu.ops import flash as jflash
from long_context_attention_tpu.ops import sage as jsage
from long_context_attention_tpu.utils.config import BlockSizes as JBlockSizes
from long_context_attention_tpu_torch.ops import kv_cache as tkv
from long_context_attention_tpu_torch.ops import reference as tref
from long_context_attention_tpu_torch.ops import sage as tsage
from long_context_attention_tpu_torch.utils.config import BlockSizes

torch.set_num_threads(1)

B, S, H, HKV, D = 2, 128, 4, 2, 64
OUT_TOL, OUT_NEAR, OUT_NEAR_SHARE = 2e-2, 1e-4, 0.01
LSE_TOL = 1e-4
SMALL = (64, 64)  # the CPU tests' tiles: T = 64


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _qkv(rng, s_q=S, s_kv=S):
    """q, k, v as (JAX, torch) fp32 pairs; K with a +0.7 common mode."""
    q = rng.standard_normal((B, s_q, H, D))
    k = rng.standard_normal((B, s_kv, HKV, D)) + 0.7
    v = rng.standard_normal((B, s_kv, HKV, D))
    return [(jnp.asarray(x, jnp.float32),
             torch.from_numpy(x.astype(np.float32))) for x in (q, k, v)]


def _out_close(got, want):
    diff = np.abs(_np(got) - _np(want))
    assert diff.max() <= OUT_TOL, diff.max()
    assert (diff > OUT_NEAR).mean() <= OUT_NEAR_SHARE, (diff > OUT_NEAR).mean()


def _lse_close(got, want):
    got, want = _np(got), _np(want)
    dead = np.isneginf(want)
    np.testing.assert_array_equal(np.isneginf(got), dead)
    np.testing.assert_allclose(got[~dead], want[~dead], atol=LSE_TOL, rtol=0)


def _blocks(tiles):
    """(JAX BlockSizes, port BlockSizes) for (block_q, block_kv), or the
    defaults for None."""
    if tiles is None:
        return None, None
    return JBlockSizes(*tiles), BlockSizes(*tiles)


def _jax_kw(kw):
    return {k: (jnp.asarray(v, jnp.int32) if k.endswith("offsets") else v)
            for k, v in kw.items()}


# case -> (route, s_q, s_kv, kwargs)
CASES = {
    "causal": ("B8a", S, S, dict(causal=True)),
    "noncausal": ("B8c", S, S, dict(causal=False)),
    "noncausal_cross": ("B8c", S // 2, S, dict(causal=False)),
    "window_sinks": ("B8b", S, S, dict(causal=True, window_size=(48, -1),
                                       sink_tokens=4)),
    "bottom_right": ("B8b", S // 2, S, dict(causal=True)),
    "two_chunks": ("B8b", S, S, dict(causal=True, q_offsets=[0, 192],
                                     kv_offsets=[0, 192])),
    "dead_rows": ("B8b", S // 2, S, dict(causal=True, q_offsets=[0],
                                         kv_offsets=[32])),
}
KERNEL = {"B8a": "sage_fwd_tri", "B8c": "sage_fwd_rect",
          "B8b": "sage_fwd_pos"}


@pytest.mark.parametrize("tiles", [SMALL, None], ids=["tiles64", "default"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_pv_int8_matches_jax(rng, monkeypatch, case, tiles):
    """sage_attention(pv_int8=True): out and lse equal JAX's on every route
    (the port's kernel as JAX's routing picks it), with the group width T
    that JAX's kv tile gives under these tiles; dead rows out 0, lse
    -inf."""
    route, s_q, s_kv, kw = CASES[case]
    calls = []
    for name in KERNEL.values():
        real = getattr(tsage, name)
        monkeypatch.setattr(tsage, name, (lambda real, name: (
            lambda *a, **k: calls.append((name, k["pv_tile"]))
            or real(*a, **k)))(real, name))
    (jq, tq), (jk, tk), (jv, tv) = _qkv(rng, s_q, s_kv)
    jbs, tbs = _blocks(tiles)
    jo, jl = jsage.sage_attention(jq, jk, jv, pv_int8=True, block_sizes=jbs,
                                  return_lse=True, **_jax_kw(kw))
    to, tl = tsage.sage_attention(tq, tk, tv, pv_int8=True, block_sizes=tbs,
                                  return_lse=True, **kw)
    n_kv = len(kw.get("kv_offsets", [0]))
    want_tile = 64 if tiles else S // n_kv
    assert calls == [(KERNEL[route], want_tile)]
    _out_close(to, jo)
    _lse_close(tl, jl)
    if case == "dead_rows":
        assert not _np(to)[:, :32].any()
        assert np.isneginf(_np(tl)[:, :, :32]).all()


@pytest.mark.parametrize("causal", [True, False])
def test_pv_int8_tile_not_a_power_of_two(rng, causal):
    """At s = 96 the default tiles give T = 96 (one group, no power of
    two); BlockSizes(48, 48) gives 48 on each route."""
    (jq, tq), (jk, tk), (jv, tv) = _qkv(rng, 96, 96)
    for jbs, tbs in (_blocks(None), _blocks((48, 48))):
        jo, jl = jsage.sage_attention(jq, jk, jv, causal=causal,
                                      pv_int8=True, block_sizes=jbs,
                                      return_lse=True)
        to, tl = tsage.sage_attention(tq, tk, tv, causal=causal,
                                      pv_int8=True, block_sizes=tbs,
                                      return_lse=True)
        _out_close(to, jo)
        _lse_close(tl, jl)


def test_pv_int8_grouping_is_honoured(rng):
    """pv_int8's result depends on the groups: under BlockSizes(64, 64) (T
    = 64) and the default (T = 128) the port's outputs differ, and each
    matches JAX's under the same tiles; pv_int8=False ignores the tiles."""
    (jq, tq), (jk, tk), (jv, tv) = _qkv(rng)
    outs = {}
    for tiles in (SMALL, None):
        jbs, tbs = _blocks(tiles)
        jo = jsage.sage_attention(jq, jk, jv, causal=True, pv_int8=True,
                                  block_sizes=jbs)
        outs[tiles] = tsage.sage_attention(tq, tk, tv, causal=True,
                                           pv_int8=True, block_sizes=tbs)
        _out_close(outs[tiles], jo)
    assert np.abs(_np(outs[SMALL]) - _np(outs[None])).max() > 10 * OUT_NEAR
    plain = [tsage.sage_attention(tq, tk, tv, causal=True, block_sizes=bs)
             for bs in (BlockSizes(*SMALL), None)]
    assert torch.equal(plain[0], plain[1])


@pytest.mark.parametrize("tiles", [SMALL, None], ids=["tiles64", "default"])
def test_registry_fwd_matches_jax(rng, tiles):
    """sage_attention_fwd (the registry's fwd) with pv_int8 and the tiles
    from its kwargs, against JAX's."""
    (jq, tq), (jk, tk), (jv, tv) = _qkv(rng)
    jbs, tbs = _blocks(tiles)
    jo, jl = jsage.sage_attention_fwd(jq, jk, jv, causal=True, pv_int8=True,
                                      block_sizes=jbs)
    to, tl = tsage.sage_attention_fwd(tq, tk, tv, causal=True, pv_int8=True,
                                      block_sizes=tbs)
    _out_close(to, jo)
    _lse_close(tl, jl)


@pytest.mark.parametrize("causal", [True, False])
def test_registry_full_matches_jax(rng, causal):
    """sage_attention_full (the registry's full) with pv_int8 against
    JAX's, which runs the default tiles."""
    (jq, tq), (jk, tk), (jv, tv) = _qkv(rng)
    jo = jsage.sage_attention_full(jq, jk, jv, causal=causal, pv_int8=True)
    to = tsage.sage_attention_full(tq, tk, tv, causal=causal, pv_int8=True)
    _out_close(to, jo)


@pytest.mark.parametrize("tiles", [SMALL, None], ids=["tiles64", "default"])
@pytest.mark.parametrize("pos", ["bottom_right", "two_chunks"])
def test_prequant_matches_jax(rng, pos, tiles):
    """sage_attention_fwd_prequant with pv_int8 over an int8 K/V of the
    cache's quantizer against JAX's, at bottom-right s_q != s_kv and at a
    two-chunk descriptor (T fitted to one kv chunk)."""
    _, s_q, s_kv, kw = CASES[pos]
    (jq, tq), (jk, tk), (jv, tv) = _qkv(rng, s_q, s_kv)
    k8, ks = tkv.quantize_kv(tk, "int8")
    v8, vs = tkv.quantize_kv(tv, "int8")
    jbs, tbs = _blocks(tiles)
    jo, jl = jsage.sage_attention_fwd_prequant(
        jq, jnp.asarray(k8.numpy()), jnp.asarray(v8.numpy()),
        jnp.asarray(ks.transpose(1, 2).numpy()),
        jnp.asarray(vs.transpose(1, 2).numpy()), pv_int8=True,
        block_sizes=jbs, **_jax_kw(kw))
    to, tl = tsage.sage_attention_fwd_prequant(
        tq, k8, v8, ks.transpose(1, 2), vs.transpose(1, 2), pv_int8=True,
        block_sizes=tbs, **kw)
    _out_close(to, jo)
    _lse_close(tl, jl)


def test_tile_rule_matches_jax():
    """The port's copy of JAX's tile rule equals ``_fit`` over a grid of
    (seq, block), and its table cap equals JAX's."""
    for seq in list(range(1, 300)) + [1000, 1024, 1088, 1536, 3000, 4096,
                                      8192, 8256, 32768, 65537]:
        for block in (1, 3, 48, 64, 96, 128, 768, 1000, 1024, 4096):
            assert tsage._fit(block, seq) == jsage._fit(block, seq), (
                block, seq)
    assert tsage._TRI_TABLE_MAX == jflash._TRI_TABLE_MAX


@pytest.mark.parametrize("route,s,n_kv,tiles,want", [
    ("tri", 8192, 1, None, 1024),
    ("pos", 8192, 2, None, 1024),      # a zigzag chunk of 4096
    ("rect", 1000, 1, None, 1000),     # ragged: one group of 1000
    ("tri", 3000, 1, None, 8),
    ("tri", 128, 1, (64, 64), 64),
    ("rect", 1536, 1, (768, 768), 768),
    ("tri", 1088, 1, None, 64),
    # causal self-attention follows JAX's tri_fits: block_q 64 fits the
    # tile table at s = 8192 (T = min(64, 128)) but not at s = 32768, where
    # JAX takes its position path (T = block_kv 128)
    ("tri", 8192, 1, (64, 128), 64),
    ("tri", 32768, 1, (64, 128), 128),
])
def test_pv_tile_follows_jax_routes(route, s, n_kv, tiles, want):
    """T on each route: JAX's kv tile for the call (``_fit`` of the
    route's block and length, the tri table's cap included)."""
    r = {"tri": tsage._TRI, "rect": tsage._RECT, "pos": tsage._POS}[route]
    bs = BlockSizes(*tiles) if tiles else None
    assert tsage.pv_tile(r, s, s, n_kv, bs) == want
    jbs = JBlockSizes(*tiles) if tiles else JBlockSizes()
    if route == "tri":
        t = jsage._fit(min(jbs.block_q, jbs.block_kv), s)
        fits = (s // t) * (s // t + 1) // 2 <= jflash._TRI_TABLE_MAX
        assert want == (t if fits else jsage._fit(jbs.block_kv, s))
    else:
        assert want == jsage._fit(jbs.block_kv, s // n_kv)


def test_plain_kernels_take_the_tile(rng):
    """Each kernel's plain version takes pv_tile: None is the bf16 PV, and
    the group width changes the result; the card's path refuses a tile
    that does not divide the kv chunk."""
    q8 = torch.from_numpy(rng.integers(-127, 128, (1, 64, 2, D),
                                       dtype=np.int8))
    k8 = torch.from_numpy(rng.integers(-127, 128, (1, 64, 1, D),
                                       dtype=np.int8))
    qs = torch.full((1, 2, 64), 1e-3)
    ks = torch.full((1, 1, 64), 1e-2)
    for fn in (tsage.sage_fwd_tri, tsage.sage_fwd_rect, tsage.sage_fwd_pos):
        bf16, _ = fn(q8, qs, k8, ks, k8, ks)
        none, _ = fn(q8, qs, k8, ks, k8, ks, pv_tile=None)
        one, _ = fn(q8, qs, k8, ks, k8, ks, pv_tile=64)
        four, _ = fn(q8, qs, k8, ks, k8, ks, pv_tile=16)
        assert torch.equal(bf16, none)
        assert not torch.equal(one, four)
    for tile, chunk in ((48, 128), (64, 96), (0, 128)):
        with pytest.raises(ValueError, match="pv_tile"):
            tsage._check_pv_tile(tile, chunk)
    tsage._check_pv_tile(64, 128)


def test_full_grad_is_straight_through(rng):
    """The gradient of sage_attention_full(pv_int8=True) is the flash
    backward on the unquantized inputs anchored on the op's own (out,
    lse), as with the bf16 PV."""
    (_, tq), (_, tk), (_, tv) = _qkv(rng)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    out, lse = tsage.sage_attention(*leaves, causal=True, pv_int8=True,
                                    return_lse=True)
    dout = torch.from_numpy(rng.standard_normal(tq.shape).astype(np.float32))
    got = torch.autograd.grad((out * dout).sum(), leaves)
    full = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    out_full = tsage.sage_attention_full(*full, causal=True, pv_int8=True)
    torch.testing.assert_close(out_full, out.detach(), atol=0, rtol=0)
    got_full = torch.autograd.grad((out_full * dout).sum(), full)
    want = tref.xla_attention_bwd(tq, tk, tv, out.detach(), lse.detach(),
                                  dout, causal=True)
    for g, gf, w in zip(got, got_full, want):
        scale = float(w.abs().max())
        assert float((g - w).abs().max()) <= 1e-5 * scale
        assert float((gf - w).abs().max()) <= 1e-5 * scale
