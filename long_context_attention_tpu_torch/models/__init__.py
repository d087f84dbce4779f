"""The llama model: serving and single-device training."""

from long_context_attention_tpu_torch.models.llama import (  # noqa: F401
    ModelConfig,
    decode_step,
    forward_local,
    init_params,
    loss_local,
    make_train_step,
    param_leaves,
    prefill_chunk_step,
)
