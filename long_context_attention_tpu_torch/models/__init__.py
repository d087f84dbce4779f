"""The llama model (serving, training on one device or a mesh) and the DiT
family."""

from long_context_attention_tpu_torch.models.llama import (  # noqa: F401
    ModelConfig,
    decode_step,
    forward_local,
    init_params,
    local_positions,
    loss_local,
    make_forward,
    make_pp_train_step,
    make_train_step,
    param_leaves,
    param_specs,
    prefill_chunk_step,
    shard_params,
)
from long_context_attention_tpu_torch.models.dit import (  # noqa: F401
    DiTConfig,
    dit_forward_local,
    init_dit_params,
    make_dit_forward,
    make_dit_train_step,
    timestep_embedding,
)
