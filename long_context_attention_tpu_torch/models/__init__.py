"""The llama model, serving side."""

from long_context_attention_tpu_torch.models.llama import (  # noqa: F401
    ModelConfig,
    decode_step,
    forward_local,
    init_params,
    prefill_chunk_step,
)
