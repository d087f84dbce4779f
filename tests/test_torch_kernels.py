"""The port's kernel registry and the operand checks of its wrappers, on the
CPU: every kernel binds a source under ``csrc/`` and names the Pallas kernel
it replaces; B2b and B5 live in the wgmma/TMA source ``flash_bwd_sm90.cu``;
a library is rebuilt when a shared header changes; and the strides a kernel
cannot read (TMA's tensor maps, cp.async's 16-byte rows) raise, while the
BSHD views the model and the cache hand the kernels pass."""

import pathlib

import pytest
import torch

from long_context_attention_tpu_torch.ops import _build
from long_context_attention_tpu_torch.ops import flash as tflash

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
B, S, H, HKV, D = 1, 1000, 16, 8, 128


@pytest.mark.parametrize("name", sorted(_build.KERNELS))
def test_kernel_source_and_replaced_site(name):
    """The source exists under csrc/, and ``replaces`` names the line of
    the JAX package where the replaced Pallas kernel is defined."""
    k = _build.KERNELS[name]
    assert (_build.CSRC / k.source).is_file()
    path, line = k.replaces.rsplit(":", 1)
    text = (ROOT / path).read_text().splitlines()[int(line) - 1]
    assert text.startswith("def _") and "kernel" in text


@pytest.mark.parametrize("name,source,site", [
    ("flash_bwd_fused", "flash_bwd_sm90.cu", "flash.py:1291"),
    ("flash_bwd_dkv", "flash_bwd_sm90.cu", "flash.py:1174"),
    ("flash_bwd_dq", "flash_bwd.cu", "flash.py:1089"),
])
def test_backward_kernel_sources(name, source, site):
    """B5 and B2b run from the Hopper source (wgmma, TMA); B2a stays on
    mma.sync. Each C entry point is defined in its source only."""
    k = _build.KERNELS[name]
    assert k.source == source
    assert k.replaces == f"long_context_attention_tpu/ops/{site}"
    defined = [p.name for p in sorted(_build.CSRC.glob("*.cu"))
               if f'extern "C" int {k.symbol}(' in p.read_text()]
    assert defined == [source]


def test_sm90_sources_build_for_sm90a():
    """wgmma and setmaxnreg exist only for sm_90a."""
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    src = (_build.CSRC / "flash_bwd_sm90.cu").read_text()
    for needle in ("wgmma.mma_async", "cp.reduce.async.bulk.tensor",
                   "setmaxnreg", "sm90.cuh"):
        assert needle in src or needle in (
            _build.CSRC / "sm90.cuh").read_text()


def test_build_key_covers_shared_headers(tmp_path, monkeypatch):
    """A change to a csrc/*.cuh header gives every source a new library."""
    for p in _build.CSRC.iterdir():
        (tmp_path / p.name).write_bytes(p.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = {s: _build._lib_path(s) for s in ("flash_bwd_sm90.cu",
                                               "flash_fwd_sm90.cu")}
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
