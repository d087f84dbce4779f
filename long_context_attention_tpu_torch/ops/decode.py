"""Decode on Hopper: in-place cache append and single-token attention.

Counterpart of ``long_context_attention_tpu/ops/decode.py``, for the dense
KV cache (layer-stacked or not), bf16 or int8:

* :func:`cache_append` is the wrapper of kernel B6 (``csrc/cache_append.cu``):
  it writes one run of new tokens per row into the cache IN PLACE.
* :func:`decode_attention` quantizes / folds the query as the JAX wrapper
  does and calls :func:`decode_attention_core`, the wrapper of kernel B7
  (``csrc/decode_attention.cu``), which attends the query rows of every kv
  head to the cache up to per-row lengths.

Each wrapper runs its plain version (``*_plain``, same arithmetic) for CPU
tensors and launches its kernel, or raises, for CUDA tensors. Decode takes
a sliding window with StreamingLLM sinks and a logit softcap; the kernel
walks a row's sink tiles and window band only. Not ported yet, and raising
``NotImplementedError``: paged caches, ALiBi, sharded-cache columns
(``first_cols``, ``sink_cols``, ``sink_band``), multi-token verify runs,
``kv_splits``, fp8/int4 caches and the int8 dequant-cast path
(``mxu_int8=False``).
"""

from __future__ import annotations

import math

import torch

from long_context_attention_tpu_torch.ops import _build
from long_context_attention_tpu_torch.ops.flash import _CLAMP, _LOG2E, _fold
from long_context_attention_tpu_torch.utils.config import NEG_INF, not_ported

__all__ = ["cache_append", "cache_append_plain", "decode_attention",
           "decode_attention_core", "decode_attention_core_plain",
           "decode_query_operands", "reference_block_kv"]

_HEAD_DIM = 128
_MAX_ROWS = 8          # query rows per kv head the B7 kernel takes
_TARGET_BLOCKS = 264   # two resident blocks on each of the H100's 132 SMs


# ---------------------------------------------------------------------------
# B6: cache append
# ---------------------------------------------------------------------------


def cache_append_plain(k_cache, v_cache, k_new, v_new, append_pos,
                       k_scale=None, v_scale=None, ks_new=None, vs_new=None,
                       *, layer: int = 0):
    """Plain version of kernel B6, IN PLACE on the layered cache.

    k_cache, v_cache (L, b, h_kv, s_max, d); k_new, v_new (b, h_kv, n, d);
    scales (L, b, h_kv, 1, s_max) with new scales (b, h_kv, n). Token t of
    row b lands at slot append_pos[b] + t when that slot is in [0, s_max);
    other tokens write nothing."""
    b, h_kv, n, d = k_new.shape
    s_max = k_cache.shape[3]
    slots = (append_pos.to(torch.long)[:, None]
             + torch.arange(n, device=append_pos.device)[None])
    bi, ti = ((slots >= 0) & (slots < s_max)).nonzero(as_tuple=True)
    si = slots[bi, ti]
    k_cache[layer, bi, :, si] = k_new[bi, :, ti]
    v_cache[layer, bi, :, si] = v_new[bi, :, ti]
    if k_scale is not None:
        ksn = ks_new.reshape(b, h_kv, n).float()
        vsn = vs_new.reshape(b, h_kv, n).float()
        k_scale[layer, bi, :, 0, si] = ksn[bi, :, ti]
        v_scale[layer, bi, :, 0, si] = vsn[bi, :, ti]


def cache_append(k_cache, v_cache, k_new, v_new, append_pos,
                 k_scale=None, v_scale=None, ks_new=None, vs_new=None, *,
                 layer=None, interpret=None, page_table=None):
    """Splice a run of n tokens per batch row into the cache IN PLACE
    (kernel B6).

    ``k_cache``/``v_cache``: (b, h_kv, s_max, d), or the stacked
    (L, b, h_kv, s_max, d) with ``layer`` (an int); bf16 or int8.
    ``k_new``/``v_new``: (b, h_kv, n, d) in the cache dtype.
    ``append_pos``: (b,) int32 first slot per row; slots outside
    [0, s_max) are skipped, so ``append_pos = -n`` skips a row.
    int8 caches pass scales (.., b, h_kv, 1, s_max) and new scales
    (b, h_kv, n). ``interpret`` is accepted for API parity. Returns the same
    tensors it was given: ``(k_cache, v_cache)`` or with the scales."""
    del interpret
    if page_table is not None:
        raise not_ported("the paged cache")
    layered = layer is not None
    li = int(layer) if layered else 0
    kc = k_cache if layered else k_cache[None]
    vc = v_cache if layered else v_cache[None]
    quant = k_scale is not None
    ks = None if not quant else (k_scale if layered else k_scale[None])
    vs = None if not quant else (v_scale if layered else v_scale[None])
    if k_cache.device.type == "cpu":
        cache_append_plain(kc, vc, k_new, v_new, append_pos, ks, vs,
                           ks_new, vs_new, layer=li)
    else:
        _cache_append_cuda(kc, vc, k_new, v_new, append_pos, ks, vs,
                           ks_new, vs_new, li)
    if quant:
        return k_cache, v_cache, k_scale, v_scale
    return k_cache, v_cache


def _cache_append_cuda(kc, vc, k_new, v_new, append_pos, ks, vs, ks_new,
                       vs_new, layer: int) -> None:
    L, b, h_kv, s_max, d = kc.shape
    n = k_new.shape[2]
    dev = kc.device
    if kc.dtype not in (torch.bfloat16, torch.int8):
        raise not_ported(f"a {kc.dtype} cache")
    for name, t in (("k_cache", kc), ("v_cache", vc)):
        if t.shape != kc.shape or t.dtype != kc.dtype or t.device != dev \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {kc.dtype} "
                             f"{tuple(kc.shape)} tensor on {dev}")
    if not 0 <= layer < L:
        raise ValueError(f"layer {layer} out of range for {L} layers")
    row_bytes = d * kc.element_size()
    if row_bytes % 16:
        raise ValueError("cache rows must be a multiple of 16 bytes")
    k_new = k_new.to(kc.dtype).contiguous()
    v_new = v_new.to(kc.dtype).contiguous()
    if k_new.shape != (b, h_kv, n, d) or v_new.shape != k_new.shape:
        raise ValueError(f"new tokens must be (b, h_kv, n, d), got "
                         f"{tuple(k_new.shape)}")
    quant = ks is not None
    if quant:
        for name, t in (("k_scale", ks), ("v_scale", vs)):
            if t.shape != (L, b, h_kv, 1, s_max) or t.dtype != torch.float32 \
                    or not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous fp32 "
                                 f"(L, b, h_kv, 1, s_max)")
        ks_new = ks_new.reshape(b, h_kv, n).float().contiguous()
        vs_new = vs_new.reshape(b, h_kv, n).float().contiguous()
    pos = append_pos.to(device=dev, dtype=torch.int32).contiguous()
    if pos.shape != (b,):
        raise ValueError("append_pos must be (b,)")
    dims = _build.dims_array([b, h_kv, n, s_max, layer, row_bytes])
    p = _build.ptr
    _build.KERNELS["cache_append"](
        p(kc), p(vc), p(k_new), p(v_new), p(ks), p(vs),
        p(ks_new if quant else None), p(vs_new if quant else None), p(pos),
        dims, _build.stream_ptr(dev))


# ---------------------------------------------------------------------------
# B7: decode attention
# ---------------------------------------------------------------------------


def reference_block_kv(block_kv: int, s_max: int, h_kv: int, rows: int,
                       d: int, itemsize: int) -> int:
    """The kv tile the JAX package's decode kernel picks at these shapes
    (its VMEM-fitting rule, decode.py:752-765). The int8 path requantizes P
    per tile, so the tile is part of the result; the port uses the same
    tile to give the same numbers."""
    def est(bkv):
        return (4 * h_kv * bkv * d * itemsize + 8 * h_kv * rows * bkv
                + 8 * h_kv * rows * d + 8 * h_kv * rows * 128)

    bkv = min(block_kv, s_max)
    while bkv > 128 and est(bkv) > 12 * 2 ** 20:
        bkv //= 2
    while s_max % bkv:
        bkv //= 2
    return bkv


def decode_attention_core_plain(q_in, q_rs, k_cache, v_cache, k_scale,
                                v_scale, lengths, *, layer: int,
                                block_kv: int, scale: float,
                                safe_softmax: bool = False,
                                window_left: int = -1, sink_tokens: int = 0,
                                softcap: float = 0.0):
    """Plain version of kernel B7, tile by tile on the kernel's tile grid.

    q_in (b, h_kv, G, d): int8 with fp32 row scales q_rs (b, h_kv, G) that
    already carry the softmax scale (and log2e in the fast form), or bf16
    (folded in the fast form) with q_rs None. Cache (L, b, h_kv, s_max, d),
    scales (L, b, h_kv, 1, s_max). A row at length n sees columns [n - 1 -
    window_left, n - 1] (all up to n - 1 when window_left < 0) and those
    below ``sink_tokens``; ``softcap`` caps the scores before the mask and
    needs the online form (``safe_softmax``). Every tile is visited here;
    the kernel skips those with no visible column, which add nothing.
    Returns fp32 out (b, h_kv, G, d) and lse (b, h_kv, G)."""
    kc, vc = k_cache[layer], v_cache[layer]
    b, h_kv, G, d = q_in.shape
    s_max = kc.shape[2]
    quant = q_rs is not None
    dev = q_in.device
    m = torch.full((b, h_kv, G), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, h_kv, G), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, h_kv, G, d), dtype=torch.float32, device=dev)
    qpos = lengths.to(device=dev, dtype=torch.long) - 1
    first = (qpos - window_left if window_left >= 0
             else torch.zeros_like(qpos))
    qf = q_in.float()
    for c0 in range(0, s_max, block_kv):
        kt = kc[:, :, c0:c0 + block_kv].float()
        vt = vc[:, :, c0:c0 + block_kv]
        n = kt.shape[2]
        s = torch.einsum("bhgd,bhnd->bhgn", qf, kt)
        if quant:
            s = s * q_rs[..., None]
            s = s * k_scale[layer][:, :, :, c0:c0 + n]
        elif safe_softmax:
            s = s * scale
        if softcap:
            s = softcap * torch.tanh(s / softcap)
        cols = torch.arange(c0, c0 + n, device=dev)[None, :]
        invisible = (cols > qpos[:, None]) | (
            (cols < first[:, None]) & (cols >= sink_tokens))
        invisible = invisible[:, None, None, :]
        s = s.masked_fill(invisible, NEG_INF)
        if safe_softmax:
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None]).masked_fill(invisible, 0.0)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            m = m_new
        else:
            p = torch.exp2(torch.clamp(s, max=_CLAMP))
            l = l + p.sum(dim=-1)
        if quant:
            p = p * v_scale[layer][:, :, :, c0:c0 + n]
            ps = torch.clamp(p.amax(dim=-1, keepdim=True), min=1e-20) * (
                1.0 / 127.0)
            p8 = torch.round(p / ps)
            # int8 x int8 sums are exact in float64, as in the int32 kernel
            pv = torch.einsum("bhgn,bhnd->bhgd", p8.double(),
                              vt.double()).float() * ps
        else:
            pv = torch.einsum("bhgn,bhnd->bhgd", p.to(torch.bfloat16).float(),
                              vt.float())
        acc = acc * alpha[..., None] + pv if safe_softmax else acc + pv
    dead = l == 0.0
    safe_l = torch.where(dead, torch.ones_like(l), l)
    out = torch.where(dead[..., None], torch.zeros_like(acc),
                      acc / safe_l[..., None])
    lse = torch.log(safe_l) + (m if safe_softmax else 0.0)
    lse = torch.where(dead, torch.full_like(lse, -math.inf), lse)
    return out, lse


def decode_attention_core(q_in, q_rs, k_cache, v_cache, k_scale, v_scale,
                          lengths, *, layer: int, block_kv: int, scale: float,
                          safe_softmax: bool = False, window_left: int = -1,
                          sink_tokens: int = 0, softcap: float = 0.0):
    """Kernel B7 wrapper (arguments as :func:`decode_attention_core_plain`).

    A row's live ``block_kv`` tiles (its sink tiles, then its window band,
    or all up to its length) split into runs, one block per (run, kv head,
    row), so small batches still fill the card; a second kernel in the
    same entry point merges the runs' partials with the arithmetic of
    :func:`merge_partials`. CPU tensors take the plain version."""
    if softcap and not safe_softmax:
        raise ValueError("softcap needs the online form (safe_softmax)")
    if q_in.device.type == "cpu":
        return decode_attention_core_plain(
            q_in, q_rs, k_cache, v_cache, k_scale, v_scale, lengths,
            layer=layer, block_kv=block_kv, scale=scale,
            safe_softmax=safe_softmax, window_left=window_left,
            sink_tokens=sink_tokens, softcap=softcap)
    b, h_kv, G, d = q_in.shape
    L, _, _, s_max, _ = k_cache.shape
    dev = q_in.device
    quant = q_rs is not None
    kv_dtype = torch.int8 if quant else torch.bfloat16
    if d != _HEAD_DIM or G > _MAX_ROWS:
        raise NotImplementedError(
            f"the B7 kernel takes head_dim {_HEAD_DIM} and at most "
            f"{_MAX_ROWS} query rows per kv head, got d={d}, rows={G}")
    if q_in.dtype != kv_dtype or not q_in.is_contiguous():
        raise ValueError(f"q must be contiguous {kv_dtype}")
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        if t.shape != (L, b, h_kv, s_max, d) or t.dtype != kv_dtype \
                or t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {kv_dtype} "
                             f"(L, b, h_kv, s_max, d) tensor on {dev}")
    if quant:
        if q_rs.shape != (b, h_kv, G) or q_rs.dtype != torch.float32:
            raise ValueError("q row scales must be fp32 (b, h_kv, rows)")
        q_rs = q_rs.contiguous()
        for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            if t.shape != (L, b, h_kv, 1, s_max) or t.dtype != torch.float32 \
                    or not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous fp32 "
                                 f"(L, b, h_kv, 1, s_max)")
    if not 0 <= layer < L:
        raise ValueError(f"layer {layer} out of range for {L} layers")
    # a tile too large for shared memory fails in the launch (the C entry
    # point returns cudaErrorInvalidValue) and raises there
    lens = lengths.to(device=dev, dtype=torch.int32).contiguous()
    nk = -(-s_max // block_kv)
    if window_left >= 0:  # the most live tiles a row can have
        nk = min(nk, -(-sink_tokens // block_kv)
                 + (window_left + block_kv) // block_kv + 1)
    splits = max(1, min(nk, -(-_TARGET_BLOCKS // (b * h_kv))))
    per_split = -(-nk // splits)
    splits = -(-nk // per_split)
    out = torch.empty((b, h_kv, G, d), dtype=torch.float32, device=dev)
    lse = torch.empty((b, h_kv, G), dtype=torch.float32, device=dev)
    part_out = part_lse = None
    if splits > 1:
        part_out = torch.empty((b, splits, h_kv, G, d), dtype=torch.float32,
                               device=dev)
        part_lse = torch.empty((b, splits, h_kv, G), dtype=torch.float32,
                               device=dev)
    dims = _build.dims_array([b, h_kv, G, s_max, layer, block_kv, splits,
                              per_split, window_left,
                              sink_tokens if window_left >= 0 else 0])
    p = _build.ptr
    _build.KERNELS["decode_attention"](
        p(q_in), p(q_rs), p(k_cache), p(v_cache), p(k_scale), p(v_scale),
        p(lens), p(part_out), p(part_lse), p(out), p(lse), dims, scale,
        float(softcap), int(safe_softmax), _build.stream_ptr(dev))
    return out, lse


def decode_query_operands(q, k_cache, quant: bool, *, scale: float,
                          block_kv: int, safe_softmax: bool = False):
    """The query operands of kernel B7, as :func:`decode_attention` makes
    them: q (b, h, d) bf16 and the layered cache (L, b, h_kv, s_max, d) ->
    (q_in (b, h_kv, g, d), q_rs (b, h_kv, g) or None, the kv tile). int8:
    q row-quantized (absmax/127, floor 1e-6, half to even) with the softmax
    scale (and log2e in the fast form) folded into the row scale; bf16: q
    folded by scale*log2e in its dtype (fast form) or as it is (safe)."""
    b, h, d = q.shape
    h_kv, s_max = k_cache.shape[2], k_cache.shape[3]
    g = h // h_kv
    bkv = reference_block_kv(block_kv, s_max, h_kv, g, d,
                             k_cache.element_size())
    qg = q.reshape(b, h_kv, g, d)
    if not quant:
        q_in = _fold(qg, scale) if not safe_softmax else qg
        return q_in.contiguous(), None, bkv
    qf = qg.float()
    q_rs = torch.clamp(qf.abs().amax(dim=-1), min=1e-6) * (1.0 / 127.0)
    q_in = torch.round(qf / q_rs[..., None]).to(torch.int8)
    return q_in, q_rs * (scale if safe_softmax else scale * _LOG2E), bkv


def decode_attention(q, k_cache, v_cache, lengths, k_scale=None,
                     v_scale=None, *, softmax_scale=None, block_kv=4096,
                     interpret=None, return_lse=False, layer=None,
                     kv_splits=None, window_size=(-1, -1), softcap=0.0,
                     alibi_slopes=None, sink_tokens=0, first_cols=None,
                     sink_cols=None, sink_band=0, page_table=None,
                     mxu_int8=True, safe_softmax=False):
    """Single-step decode attention over a bf16 or int8 cache.

    q (b, h, d) (or (b, 1, h, d)); cache (b, h_kv, s_max, d) or the stacked
    (L, b, h_kv, s_max, d) with ``layer`` (an int); int8 caches pass scales
    in the cache's (.., h_kv, 1, s_max) layout; ``lengths`` (b,) int32 is
    the visible prefix per row including the newest token. A left
    ``window_size`` keeps the last window + 1 columns of each row, and
    ``sink_tokens`` the first ones beside them (sinks act only with a
    window); ``softcap`` caps the scores and takes the online form. The
    int8 path row-quantizes q (absmax/127, scale and log2e folded into the
    row scale) and runs s8 x s8 products, requantizing P per ``block_kv``
    tile; the tile follows the JAX package's rule
    (:func:`reference_block_kv`). Returns out (b, h, d) bf16 (+ lse (b, h)
    fp32 with ``return_lse``)."""
    del interpret
    multi = q.dim() == 4
    if multi:
        if q.shape[1] != 1:
            raise not_ported("multi-token decode (verify runs)")
        q = q[:, 0]
    if page_table is not None:
        raise not_ported("the paged cache")
    if kv_splits not in (None, 1):
        raise not_ported("kv_splits")
    if alibi_slopes is not None:
        raise not_ported("ALiBi decode")
    if first_cols is not None or sink_cols is not None or sink_band:
        raise not_ported("sequence-sharded decode (first_cols/sink_cols/"
                         "sink_band)")
    if softcap < 0:
        raise ValueError(f"softcap must be >= 0, got {softcap}")
    w_left = int(tuple(window_size)[0])
    sink = int(sink_tokens) if w_left >= 0 else 0
    online = bool(safe_softmax) or softcap > 0
    layered = layer is not None
    li = int(layer) if layered else 0
    kc = k_cache if layered else k_cache[None]
    vc = v_cache if layered else v_cache[None]
    quant = k_scale is not None
    ks = None if not quant else (k_scale if layered else k_scale[None])
    vs = None if not quant else (v_scale if layered else v_scale[None])
    if quant and (kc.dtype != torch.int8 or not mxu_int8):
        raise not_ported("fp8/int4 caches and the int8 dequant-cast path")
    b, h, d = q.shape
    scale = softmax_scale if softmax_scale is not None else d ** -0.5
    q_in, q_rs, bkv = decode_query_operands(q, kc, quant, scale=scale,
                                            block_kv=block_kv,
                                            safe_softmax=online)
    out, lse = decode_attention_core(q_in, q_rs, kc, vc, ks, vs, lengths,
                                     layer=li, block_kv=bkv, scale=scale,
                                     safe_softmax=online, window_left=w_left,
                                     sink_tokens=sink, softcap=float(softcap))
    out = out.to(torch.bfloat16).reshape(b, h, d)
    lse = lse.reshape(b, h)
    if multi:
        out, lse = out[:, None], lse[..., None]
    return (out, lse) if return_lse else out
