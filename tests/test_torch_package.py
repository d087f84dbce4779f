"""Package rules of the PyTorch port: no JAX inside it, the card by default,
and a kernel build directory that git ignores."""

import ast
import pathlib

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "long_context_attention_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "long_context_attention_tpu")


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize(
    "path", sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    """No module of the port, and not chip_smoke.py, imports JAX or the JAX
    package (not even its JAX-free modules)."""
    for name in _imports(path):
        assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_default_device_needs_cuda(monkeypatch):
    """device=None means the card: without one, entry points raise instead
    of running on the CPU; device="cpu" is taken as asked."""
    from long_context_attention_tpu_torch.models.llama import (
        ModelConfig, init_params)
    from long_context_attention_tpu_torch.ops.kv_cache import KVCache
    from long_context_attention_tpu_torch.serving.engine import Engine
    from long_context_attention_tpu_torch.utils.config import resolve_device
    from long_context_attention_tpu_torch.utils.convert import params_from_jax

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ModelConfig()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Engine(cfg=cfg, s_max=64)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        KVCache.init(1, 1, 8, 1, 8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_params(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        params_from_jax({"embed": np.zeros((4, 2), np.float32)})
    assert Engine(cfg=cfg, s_max=64, device="cpu").device.type == "cpu"


def test_build_dir_is_gitignored():
    """The kernels build into a directory that .gitignore lists, so git
    never commits a built library."""
    from long_context_attention_tpu_torch.ops import _build

    top = _build.BUILD_DIR.relative_to(ROOT).parts[0]
    patterns = {line.strip().strip("/")
                for line in (ROOT / ".gitignore").read_text().splitlines()}
    assert top in patterns, f"{top}/ is not in .gitignore"


def test_unported_features_raise():
    """Features outside the ported slices raise NotImplementedError, and so
    does a gradient through the int8-KV path, which is forward-only in the
    JAX package too, and what the dense USP layers do not take yet
    (segments, fp8 K/V). A gradient through a sliding window now comes
    back, equal to the fp32 oracle's, and the dense layers compute."""
    from long_context_attention_tpu_torch.ops.decode import decode_attention
    from long_context_attention_tpu_torch.ops.flash import (
        flash_attention, flash_attention_fwd)
    from long_context_attention_tpu_torch.ops.kv_cache import KVCache
    from long_context_attention_tpu_torch.ops.reference import (
        xla_attention_bwd)

    q = torch.zeros(1, 8, 2, 128, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError):
        flash_attention(q, q, q, causal=False,
                        alibi_slopes=torch.ones(2))
    x = torch.randn(1, 8, 2, 128, generator=torch.Generator().manual_seed(0))
    xg = x.clone().requires_grad_()
    out, lse = flash_attention(xg, x, x, causal=True, window_size=(4, -1),
                               return_lse=True)
    out.sum().backward()
    dq, _, _ = xla_attention_bwd(x, x, x, out.detach(), lse.detach(),
                                 torch.ones_like(x), causal=True,
                                 window_size=(4, -1))
    torch.testing.assert_close(xg.grad, dq, atol=1e-5, rtol=1e-5)
    kv8 = torch.zeros(1, 8, 2, 128, dtype=torch.int8)
    scales = torch.ones(1, 2, 8)
    with pytest.raises(NotImplementedError, match="forward-only"):
        flash_attention_fwd(q.requires_grad_(), kv8, kv8, k_scale=scales,
                            v_scale=scales, causal=True)
    with pytest.raises(NotImplementedError):
        KVCache.init(1, 1, 8, 1, 8, dtype="int4", device="cpu")
    cache = torch.zeros(1, 2, 8, 128, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError):
        decode_attention(q[:, 0], cache, cache, torch.ones(1, dtype=torch.int32),
                         alibi_slopes=torch.ones(2))
    # the dense USP layers (block_mask=None) compute since the dense ring;
    # segments and fp8 K/V through them still raise
    from long_context_attention_tpu_torch.parallel import (
        LongContextAttention, UlyssesAttention, make_usp_mesh)

    mesh = make_usp_mesh(device="cpu")
    try:
        want = flash_attention(x, x, x, causal=True)
        for layer in (LongContextAttention, UlyssesAttention):
            torch.testing.assert_close(layer(mesh)(x, x, x, causal=True),
                                       want, atol=1e-6, rtol=0)
        seg = torch.zeros(1, 8, dtype=torch.int32)
        with pytest.raises(NotImplementedError, match="segment_ids"):
            LongContextAttention(mesh)(q, q, q, causal=True,
                                       segment_ids=seg)
        with pytest.raises(NotImplementedError, match="fp8"):
            LongContextAttention(mesh, kv_quant="float8_e4m3fn")(
                q, q, q, causal=True)
    finally:
        torch.distributed.destroy_process_group()


def test_engine_rejects_params_off_its_device():
    """An engine computes only on its own device: params or tokens that
    live elsewhere raise rather than run there."""
    from long_context_attention_tpu_torch.models.llama import (
        ModelConfig, init_params)
    from long_context_attention_tpu_torch.serving.engine import Engine

    cfg = ModelConfig(n_layers=1, layout="basic")
    eng = Engine(cfg=cfg, s_max=16, device="cpu")
    params = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    tokens = torch.zeros((1, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="tokens is on meta"):
        eng.prefill(params, tokens.to("meta"))
    meta_params = dict(params, embed=params["embed"].to("meta"))
    with pytest.raises(ValueError, match="embed"):
        eng.prefill_chunked(meta_params, tokens, 4)
    _, cache = eng.prefill(params, tokens)
    with pytest.raises(ValueError, match="first_token is on meta"):
        eng.decode_scan(params, cache, 1,
                        torch.zeros(1, dtype=torch.int32, device="meta"))


@pytest.mark.parametrize("field,value", [
    ("window_left", 64), ("softcap", 30.0), ("sink_tokens", 4),
    ("attn_impl", "xla"), ("block_sizes", "BlockSizes"), ("n_experts", 4),
    ("moe_capacity_factor", 1.0)])
def test_model_config_rejects_unported_fields(field, value):
    """ModelConfig keeps the JAX config's fields; a value that needs a
    slice not ported yet raises instead of being ignored. A window, sinks
    or softcap serve and train, so the config takes them, hands them to
    every attention call and builds a train step. attn_impl takes the
    registry's impls (xla, sage) and raises ValueError on an unknown
    one."""
    from long_context_attention_tpu_torch.models.llama import (
        ModelConfig, make_train_step)
    from long_context_attention_tpu_torch.utils.config import BlockSizes

    if field == "attn_impl":
        for impl in (value, "sage"):
            assert ModelConfig(attn_impl=impl).attn_impl == impl
        with pytest.raises(ValueError, match="unknown attention impl"):
            ModelConfig(attn_impl="flashinfer")
        return
    if value == "BlockSizes":
        value = BlockSizes(block_q=512)
    if field in ("window_left", "softcap", "sink_tokens"):
        cfg = ModelConfig(**{field: value})
        assert getattr(cfg, field) == value
        kw = cfg.attention_kwargs()
        assert (kw["window_size"][0] if field == "window_left"
                else kw[field]) == value
        assert callable(make_train_step(cfg, torch.optim.SGD, device="cpu"))
        return
    with pytest.raises(NotImplementedError, match=field):
        ModelConfig(**{field: value})


def test_model_config_layouts():
    """Every sequence layout of the JAX package is accepted (on one device
    they are the same model); an unknown one raises."""
    from long_context_attention_tpu_torch.models.llama import ModelConfig

    with pytest.raises(ValueError, match="unknown layout"):
        ModelConfig(layout="spiral")
    for layout in ("basic", "zigzag", "stripe"):
        assert ModelConfig(layout=layout).layout == layout
