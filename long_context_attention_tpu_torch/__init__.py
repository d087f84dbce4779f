"""long_context_attention_tpu_torch: the PyTorch / H100 port of
long_context_attention_tpu.

It keeps the JAX package's public names, BSHD layout, kwargs and
``(out, lse fp32)`` contract, and replaces each Pallas TPU kernel with a
CUDA C++ kernel for Hopper (``csrc/``), each with a plain PyTorch version
that runs for CPU tensors. Entry points run on the card unless given
``device="cpu"``. The package imports neither JAX nor the JAX package.
"""

from long_context_attention_tpu_torch.models import ModelConfig, init_params  # noqa: F401
from long_context_attention_tpu_torch.ops import (  # noqa: F401
    KVCache,
    block_sparse_attention,
    flash_attention,
    flash_attention_fwd,
    flash_attention_fwd_cache,
    get_attn_impl,
    merge_attn_blocks,
    xla_attention,
)
from long_context_attention_tpu_torch.parallel import (  # noqa: F401
    LongContextAttention,
    UlyssesAttention,
    make_usp_mesh,
)
from long_context_attention_tpu_torch.serving import Engine, SamplingParams  # noqa: F401
