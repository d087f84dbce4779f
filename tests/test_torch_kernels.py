"""The port's kernel registry and the operand checks of its wrappers, on the
CPU: every kernel binds a source under ``csrc/`` and names the Pallas kernel
it replaces (sage's quantization pass, the JAX function it computes); B2b,
B5 and B9c live in the wgmma/TMA source ``flash_bwd_sm90.cu``, B1, B3, B4
and B9a in ``flash_fwd_sm90.cu``, B2a and B9b in ``flash_dq_sm90.cu``, B8a
and B8b in ``sage_fwd_sm90.cu``; a library
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
    ("sage_fwd_rect", "flash_fwd.cu", "sage.py:223"),
])
def test_sage_kernel_sources(name, source, site):
    """B8a and B8b run from the Hopper source (wgmma, TMA); B8c stays on
    the mma.sync template of flash_fwd.cu. Each C entry point is defined in
    its source only."""
    k = _build.KERNELS[name]
    assert k.source == source
    assert k.replaces == f"long_context_attention_tpu/ops/{site}"
    defined = [p.name for p in sorted(_build.CSRC.glob("*.cu"))
               if f'extern "C" int {k.symbol}(' in p.read_text()]
    assert defined == [source]


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
    """B8a and B8b's QK^T runs on wgmma's int8 path (both operands K-major
    from shared memory), built for sm_90a, on the shared Hopper header."""
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    src = (_build.CSRC / "sage_fwd_sm90.cu").read_text()
    for needle in ("wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8",
                   '#include "sm90.cuh"', "setmaxnreg_inc", "tma_load_4d",
                   "cp_async_mbar_arrive"):
        assert needle in src


def test_sm90_sources_build_for_sm90a():
    """wgmma and setmaxnreg exist only for sm_90a. The backward source
    (B5, B2b and B9c), the forward source (B1, B3, B4, B9a) and the dq
    source (B2a, B9b) use them, with TMA; B9c's walk is a template parameter
    of B2b's kernel, B9a's of the forward kernel and B2a's and B9b's of the
    dq kernel, not second pipelines; so is the multi-chunk descriptor of
    B3, B2a, B2b and B8b (MULTI). The backward entry points share one C
    signature (B2b's takes its kv tile order after it)."""
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
    for mask in ("kDense", "kBand", "kCap"):  # B2b at multi-chunk positions
        assert f"launch<false, false, {mask}, true>(" in bwd
    fwd = (_build.CSRC / "flash_fwd_sm90.cu").read_text()
    for needle in ("wgmma.mma_async", "tma_load_4d", "setmaxnreg_inc",
                   '#include "sm90.cuh"'):
        assert needle in fwd
    assert fwd.count("__global__") == 1
    assert "flash_fwd_sm90_kernel<false, kFast, false, true>" in fwd
    for quant in ("true", "false"):  # B3 at multi-chunk positions
        assert f"launch<false, kFast, {quant}, true>" in fwd
    dq = (_build.CSRC / "flash_dq_sm90.cu").read_text()
    for needle in ("wgmma.mma_async", "wgmma_rs", "tma_load_4d",
                   "setmaxnreg_inc", "setmaxnreg_dec", '#include "sm90.cuh"'):
        assert needle in dq
    assert dq.count("__global__") == 1
    for walk in ("SparseRows", "DenseRows<true, false>",
                 "DenseRows<false, false>", "DenseRows<true, true>",
                 "DenseRows<false, true>"):
        assert f"launch<{walk}>(" in dq
    assert "#define LCA_BWD_ARGS" in header
    assert 'extern "C" int lca_flash_bwd_dq(LCA_BWD_ARGS)' in dq
    assert 'extern "C" int lca_flash_bwd_dkv(LCA_BWD_ARGS, const int* order)' \
        in bwd
    assert "struct Desc" in header and "desc_ok" in header
    assert not (_build.CSRC / "sparse.cu").exists()
    # no source derives its aligned shared base through an integer cast
    for src in sorted(_build.CSRC.glob("*.cu")):
        assert "uintptr_t" not in src.read_text(), src.name


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
