"""Configuration, device rule and parameter conversion for the port."""

from long_context_attention_tpu_torch.utils.config import (  # noqa: F401
    NEG_INF,
    BlockSizes,
    resolve_device,
)
