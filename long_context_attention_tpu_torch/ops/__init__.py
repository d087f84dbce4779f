"""Attention, cache and quantization ops of the port, with their kernels."""

from long_context_attention_tpu_torch.ops.decode import (  # noqa: F401
    cache_append,
    decode_attention,
)
from long_context_attention_tpu_torch.ops.flash import (  # noqa: F401
    flash_attention,
    flash_attention_bwd,
    flash_attention_fwd,
    flash_attention_fwd_cache,
)
from long_context_attention_tpu_torch.ops.kv_cache import (  # noqa: F401
    KVCache,
    dequantize_kv,
    quantize_kv,
)
from long_context_attention_tpu_torch.ops.merge import (  # noqa: F401
    init_merge_state,
    merge_attn_blocks,
    merge_partials,
)
from long_context_attention_tpu_torch.ops.reference import (  # noqa: F401
    xla_attention,
    xla_attention_bwd,
)
from long_context_attention_tpu_torch.ops.registry import (  # noqa: F401
    ATTN_IMPLS,
    AttnImpl,
    get_attn_impl,
    register_attn_impl,
)
from long_context_attention_tpu_torch.ops.sage import (  # noqa: F401
    sage_attention,
    sage_attention_fwd,
    sage_attention_fwd_prequant,
    sage_attention_full,
)
from long_context_attention_tpu_torch.ops.sparse import (  # noqa: F401
    block_sparse_attention,
    block_sparse_attention_fwd,
    causal_block_mask,
    global_local_block_mask,
    mask_density,
    random_block_mask,
    sliding_window_block_mask,
    strided_block_mask,
)
from long_context_attention_tpu_torch.ops.wquant import (  # noqa: F401
    QTensor,
    qdot,
    quantize_decode_params,
    quantize_weight,
)
