"""The port's kernel registry and the operand checks of its wrappers, on the
CPU: every kernel binds a source under ``csrc/`` and names the Pallas kernel
it replaces (sage's quantization pass, the JAX function it computes); B2b,
B5 and B9c live in the wgmma/TMA source ``flash_bwd_sm90.cu``, B1, B3, B4
and B9a in ``flash_fwd_sm90.cu``, B2a and B9b in ``flash_dq_sm90.cu``, B8a,
B8b and B8c (and their pv_int8 forms) in ``sage_fwd_sm90.cu``, B7's runs
(decode_run) in ``decode_run_sm90.cu``; a library
is rebuilt when a shared header changes; and the strides a kernel cannot
read (TMA's tensor maps, cp.async's 16-byte rows) raise, while the BSHD
views the model and the cache hand the kernels pass."""

import pathlib

import pytest
import torch

from long_context_attention_tpu_torch.ops import _build
from long_context_attention_tpu_torch.ops import flash as tflash

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
B, S, H, HKV, D = 1, 1000, 16, 8, 128


def _replaced_line(k):
    path, line = k.replaces.rsplit(":", 1)
    return (ROOT / path).read_text().splitlines()[int(line) - 1]


@pytest.mark.parametrize("name", sorted(set(_build.KERNELS)
                                        - set(_build.QUANT_PASSES)))
def test_kernel_source_and_replaced_site(name):
    """The source exists under csrc/, and ``replaces`` names the line of
    the JAX package where the replaced Pallas kernel is defined."""
    k = _build.KERNELS[name]
    assert (_build.CSRC / k.source).is_file()
    text = _replaced_line(k)
    assert text.startswith("def _") and "kernel" in text


@pytest.mark.parametrize("name,function", [
    ("sage_quant_kv", "sage_quantize_kv"),
    ("sage_quant_q", "_quant_per_token"),
])
def test_quant_pass_source_and_replaced_function(name, function):
    """Sage's quantization kernels port an XLA fusion, no Pallas kernel:
    they live in ``sage_quant.cu`` and ``replaces`` names the line where
    the JAX quantizer they compute is defined."""
    k = _build.KERNELS[name]
    assert name in _build.QUANT_PASSES and k.source == "sage_quant.cu"
    assert (_build.CSRC / k.source).is_file()
    assert _replaced_line(k).startswith(f"def {function}(")


@pytest.mark.parametrize("name,source,site", [
    ("flash_bwd_fused", "flash_bwd_sm90.cu", "flash.py:1291"),
    ("flash_bwd_dkv", "flash_bwd_sm90.cu", "flash.py:1174"),
    ("flash_bwd_dq", "flash_dq_sm90.cu", "flash.py:1089"),
])
def test_backward_kernel_sources(name, source, site):
    """B5 and B2b run from the Hopper backward source (wgmma, TMA), B2a
    from the dq pipeline's source (wgmma, TMA) as B9b's second walk. Each C
    entry point is defined in its source only, and the mma.sync source
    ``flash_bwd.cu`` is gone."""
    k = _build.KERNELS[name]
    assert k.source == source
    assert k.replaces == f"long_context_attention_tpu/ops/{site}"
    defined = [p.name for p in sorted(_build.CSRC.glob("*.cu"))
               if f'extern "C" int {k.symbol}(' in p.read_text()]
    assert defined == [source]
    assert not (_build.CSRC / "flash_bwd.cu").exists()


@pytest.mark.parametrize("name,source,site", [
    ("sage_fwd_tri", "sage_fwd_sm90.cu", "sage.py:186"),
    ("sage_fwd_pos", "sage_fwd_sm90.cu", "sage.py:246"),
    ("sage_fwd_rect", "sage_fwd_sm90.cu", "sage.py:223"),
    ("sage_fwd_tri_pv8", "sage_fwd_sm90.cu", "sage.py:186"),
    ("sage_fwd_pos_pv8", "sage_fwd_sm90.cu", "sage.py:246"),
    ("sage_fwd_rect_pv8", "sage_fwd_sm90.cu", "sage.py:223"),
])
def test_sage_kernel_sources(name, source, site):
    """B8a, B8b and B8c run from the Hopper source (wgmma, TMA), each with
    a pv_int8 entry; the mma.sync source ``flash_fwd.cu`` is gone. Each C
    entry point is defined in its source only."""
    k = _build.KERNELS[name]
    assert k.source == source
    assert k.replaces == f"long_context_attention_tpu/ops/{site}"
    defined = [p.name for p in sorted(_build.CSRC.glob("*.cu"))
               if f'extern "C" int {k.symbol}(' in p.read_text()]
    assert defined == [source]
    assert not (_build.CSRC / "flash_fwd.cu").exists()


@pytest.mark.parametrize("name,source,site", [
    ("flash_fwd_causal_self", "flash_fwd_sm90.cu", "flash.py:338"),
    ("flash_fwd_static", "flash_fwd_sm90.cu", "flash.py:475"),
    ("flash_fwd_pos", "flash_fwd_sm90.cu", "flash.py:696"),
    ("sparse_fwd", "flash_fwd_sm90.cu", "sparse.py:314"),
    ("sparse_bwd_dq", "flash_dq_sm90.cu", "sparse.py:469"),
    ("sparse_bwd_dkv", "flash_bwd_sm90.cu", "sparse.py:516"),
])
def test_forward_and_sparse_kernel_sources(name, source, site):
    """B1, B3, B4 and B9a run from the Hopper forward source (wgmma, TMA);
    B9c runs on B2b's wgmma/TMA pipeline in the backward source and B9b on
    the dq pipeline. Each C entry point is defined in its source only."""
    k = _build.KERNELS[name]
    assert k.source == source
    assert k.replaces == f"long_context_attention_tpu/ops/{site}"
    defined = [p.name for p in sorted(_build.CSRC.glob("*.cu"))
               if f'extern "C" int {k.symbol}(' in p.read_text()]
    assert defined == [source]


def test_sage_sm90_source_uses_the_s8_wgmma():
    """B8a, B8b and B8c's QK^T runs on wgmma's int8 path (both operands
    K-major from shared memory), built for sm_90a, on the shared Hopper
    header; so does pv_int8's PV (the template parameter PV8 of the one
    kernel, over a transposed V), and no source uses mma.sync."""
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    src = (_build.CSRC / "sage_fwd_sm90.cu").read_text()
    for needle in ("wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8",
                   '#include "sm90.cuh"', "setmaxnreg_inc", "tma_load_4d",
                   "cp_async_mbar_arrive", "transpose_v(",
                   "wgmma_s8_tile(acc, p8s"):
        assert needle in src
    assert src.count("__global__") == 1
    for pv8 in ("false", "true"):
        assert f"launch<true, false, {pv8}>(" in src
    for pv8 in ("false, PV8", "true, PV8"):
        assert f"launch<false, {pv8}>(" in src
    for pv8 in ("false", "true"):
        assert f"pos<{pv8}>(" in src and f"rect<{pv8}>(" in src
    for path in sorted(_build.CSRC.glob("*.cu")):
        assert "mma.sync.aligned" not in path.read_text(), path.name


def test_sm90_sources_build_for_sm90a():
    """wgmma and setmaxnreg exist only for sm_90a. The backward source
    (B5, B2b and B9c), the forward source (B1, B3, B4, B9a) and the dq
    source (B2a, B9b) use them, with TMA; B9c's walk is a template parameter
    of B2b's kernel, B9a's of the forward kernel and B2a's and B9b's of the
    dq kernel, not second pipelines; so are the multi-chunk descriptor of
    B3, B2a, B2b and B8b (MULTI) and the features of B3, B2a and B2b
    (FEAT: segments, ALiBi, dropout); B3's quantized K/V kind is a
    run-time value of its producers. The backward entry points share one C
    signature (B2b's takes its kv tile order after it, and B2a's and B2b's
    the features' operands last). The three sources build at head dim 64
    too (-DLCA_HEAD_DIM=64): B2a, B2b, B5, and B3 at two chunks and with
    the features over bf16 K/V; B9b and B9c return cudaErrorNotSupported
    there."""
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    header = (_build.CSRC / "sm90.cuh").read_text()
    bwd = (_build.CSRC / "flash_bwd_sm90.cu").read_text()
    for needle in ("wgmma.mma_async", "cp.reduce.async.bulk.tensor",
                   "setmaxnreg", "sm90.cuh"):
        assert needle in bwd or needle in header
    assert bwd.count("__global__") == 1
    assert "launch<false, true>(" in bwd
    for mask in ("kBand", "kCap"):  # the windowed and softcapped bodies
        assert f"launch<FUSED, false, {mask}>(" in bwd
    # B2b at multi-chunk positions and with the features, every mask
    for mask in ("kDense", "kBand", "kCap"):
        assert f"launch<false, false, {mask}, MULTI, FEAT>(" in bwd
    for multi in ("true", "false"):
        assert f"launch_dkv<{multi}, true>(" in bwd
    # head dim 64: the d-wide products through wgmma_rs_d (m64n64 at d =
    # 64); the sparse entries stay at 128
    dq = (_build.CSRC / "flash_dq_sm90.cu").read_text()
    for src in (bwd, dq):
        assert "constexpr int D = LCA_HEAD_DIM;" in src
        assert "wgmma_rs_d(" in src
        assert ("#if LCA_HEAD_DIM != 128\n  return (int)cudaErrorNotSupported;"
                in src)
    assert "wgmma_rs_n64(" in header
    fwd = (_build.CSRC / "flash_fwd_sm90.cu").read_text()
    for needle in ("wgmma.mma_async", "tma_load_4d", "setmaxnreg_inc",
                   '#include "sm90.cuh"'):
        assert needle in fwd
    assert fwd.count("__global__") == 1
    assert "flash_fwd_sm90_kernel<false, kFast, false, true>" in fwd
    # B3 at multi-chunk positions and with the features, over bf16 K/V or
    # the quantized cache (QUANT): its kind, int8, fp8 or packed int4, is a
    # run-time value that the producers read to widen the raw tiles
    assert "launch<false, kFast, QUANT, MULTI, FEAT>" in fwd
    for quant in ("true", "false"):
        assert f"pos_form<{quant}, MULTI, true>(" in fwd
    assert "widen_rows<BKV, KV, D>(" in fwd
    for kind in ("kKvInt8", "kKvFp8", "kKvInt4"):
        assert f"stream(KvKind<{kind}>())" in fwd
    for multi in ("true", "false"):
        assert f"pos_kind<{multi}>(" in fwd
    # at head dim 64: MULTI and FEAT over bf16 K/V
    assert fwd.count("pos_form<false, MULTI, true>(") == 2
    # B7's kinds: bf16, the s8 path over int8 and int4, the cast path over
    # int8, fp8 and int4
    b7 = (_build.CSRC / "decode_attention.cu").read_text()
    for kind in ("kBF16", "kS8I8", "kS8I4", "kCastI8", "kCastF8", "kCastI4"):
        assert f"LCA_KIND({kind})" in b7
    # one-token B7: a thread block cluster of span blocks per JAX tile, K/V
    # by 1-D bulk async copies on mbarriers, the tile's statistics pushed
    # over distributed shared memory; the span kernel and the spans' merge
    for needle in ("cudaLaunchKernelEx", "cudaLaunchAttributeClusterDimension",
                   "cp.async.bulk.shared::cluster.global.mbarrier::"
                   "complete_tx::bytes", "mbar_wait(", "mbar_expect_tx(",
                   "barrier.cluster.arrive.release", "mapa.shared::cluster",
                   "st.shared::cluster", '#include "sm90.cuh"', "__dp4a("):
        assert needle in b7, needle
    assert b7.count("__global__") == 2
    for gp in (2, 4, 8):
        assert f"launch<KIND, true, {gp}>(p, st)" in b7
        assert f"launch<KIND, false, {gp}>(p, st)" in b7
    dq = (_build.CSRC / "flash_dq_sm90.cu").read_text()
    for needle in ("wgmma.mma_async", "wgmma_rs", "tma_load_4d",
                   "setmaxnreg_inc", "setmaxnreg_dec", '#include "sm90.cuh"'):
        assert needle in dq
    assert dq.count("__global__") == 1
    for walk in ("SparseRows", "DenseRows<true, MULTI, FEAT>",
                 "DenseRows<false, MULTI, FEAT>"):
        assert f"launch<{walk}>(" in dq
    for multi in ("true", "false"):
        for feat in ("true", "false"):
            assert f"launch_dense<{multi}, {feat}>(" in dq
    assert "#define LCA_BWD_ARGS" in header
    assert "#define LCA_FEAT_ARGS" in header
    assert ('extern "C" int lca_flash_bwd_dq(LCA_BWD_ARGS, LCA_FEAT_ARGS)'
            in dq)
    assert ('extern "C" int lca_flash_bwd_dkv(LCA_BWD_ARGS, const int* order,'
            '\n                                 LCA_FEAT_ARGS)') in bwd
    assert "struct Desc" in header and "desc_ok" in header
    assert not (_build.CSRC / "sparse.cu").exists()
    # no source derives its aligned shared base through an integer cast
    for src in sorted(_build.CSRC.glob("*.cu")):
        assert "uintptr_t" not in src.read_text(), src.name


def test_decode_run_sm90_source():
    """B7's multi-token kernel, decode_run, is its own sm_90a source on the
    shared header: QK^T and PV on wgmma (s8: m64n128k32 s32.s8.s8, V
    transposed; bf16 and the cast kinds: m64n128k16 with P in registers),
    TMA and setmaxnreg; the consumers are templated on the s8 path and the
    online form alone (the cache kind is the producer's run-time value),
    and its C entry takes decode_attention's arguments."""
    src = (_build.CSRC / "decode_run_sm90.cu").read_text()
    for needle in ("wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8",
                   "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16",
                   "wgmma_rs_d(", '#include "sm90.cuh"', "setmaxnreg_inc",
                   "setmaxnreg_dec", "tma_load_3d", "transpose_chunk(",
                   "widen_chunk<kKvFp8>", "widen_chunk<kKvInt4>",
                   "widen_chunk<kKvInt8>"):
        assert needle in src, needle
    assert src.count("__global__") == 2  # the kernel and the split merge
    for s8 in ("true", "false"):
        for safe in ("true", "false"):
            assert f"launch<{s8}, {safe}>(maps, p, st)" in src
    assert "template <bool S8, bool SAFE>\n__global__" in src
    first = (_build.CSRC / "decode_attention.cu").read_text()
    args = first[first.index('extern "C" int lca_decode_attention('):]
    args = args[args.index("(") + 1:args.index(")")]
    run = src[src.index('extern "C" int lca_decode_run('):]
    run = run[run.index("(") + 1:run.index(")")]
    assert run.split() == args.split()
    assert "uintptr_t" not in src


def test_build_key_covers_shared_headers(tmp_path, monkeypatch):
    """A change to a csrc/*.cuh header gives every source a new library."""
    for p in _build.CSRC.iterdir():
        (tmp_path / p.name).write_bytes(p.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = {s: _build._lib_path(s) for s in ("flash_bwd_sm90.cu",
                                               "flash_fwd_sm90.cu",
                                               "sage_fwd_sm90.cu")}
    header = tmp_path / "sm90.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {s: _build._lib_path(s) for s in before}
    assert all(before[s] != after[s] for s in before)


def _views():
    """The BSHD views the kernels are handed: the model's q/k/v (a linear
    output reshaped), a slice of a fused qkv projection, a BHSD cache
    slice transposed, one batch row of a larger batch, and dout made
    contiguous by the backward."""
    x = torch.empty((B, S, (H + 2 * HKV) * D), dtype=torch.bfloat16)
    cache = torch.empty((2, HKV, 4096, D), dtype=torch.bfloat16)
    big = torch.empty((4, S, H, D), dtype=torch.bfloat16)
    return {
        "reshaped q": torch.empty((B, S, H * D), dtype=torch.bfloat16)
        .reshape(B, S, H, D),
        "fused qkv k slice": x[..., H * D:(H + HKV) * D].unflatten(
            -1, (HKV, D)),
        "cache slice": cache[:1, :, :S].transpose(1, 2),
        "batch row": big[2:3],
        "fp32 dq": torch.empty((B, S, H, D), dtype=torch.float32),
    }


@pytest.mark.parametrize("view", sorted(_views()))
def test_operand_views_pass(view):
    t = _views()[view]
    assert tflash.strided_operand_problem(
        t.shape, t.stride(), t.element_size(), t.data_ptr()) is None
    tflash._check_cuda_operand(view, t, t.dtype, t.device)


def _bad():
    base = torch.empty((B, S, H, D + 4), dtype=torch.bfloat16)
    flat = torch.empty(B * S * H * D + 4, dtype=torch.bfloat16)
    return {
        "head stride of 132 elements": (base[..., :D], "16-byte aligned"),
        "misaligned base": (flat[4:].view(B, S, H, D), "aligned address"),
        "strided last dim": (torch.empty((B, S, H, 2 * D),
                                         dtype=torch.bfloat16)[..., ::2],
                             "contiguous last dim"),
        "broadcast sequence": (torch.empty((B, 1, H, D), dtype=torch.bfloat16)
                               .expand(B, S, H, D), "16-byte aligned"),
    }


@pytest.mark.parametrize("case", sorted(_bad()))
def test_operand_views_rejected(case):
    t, why = _bad()[case]
    problem = tflash.strided_operand_problem(t.shape, t.stride(),
                                             t.element_size(), t.data_ptr())
    assert problem is not None and why in problem
    with pytest.raises(ValueError, match=f"^q .*{why}"):
        tflash._check_cuda_operand("q", t, t.dtype, t.device)


def test_size_one_dims_are_never_stepped():
    """A dim of one entry takes any stride (the tensor map packs it)."""
    assert tflash.strided_operand_problem(
        (1, 64, 1, D), (12345, D, 7, 1), 2, 0) is None
    assert tflash.strided_operand_problem(
        (2, 64, 1, D), (12345, D, 7, 1), 2, 0) is not None
