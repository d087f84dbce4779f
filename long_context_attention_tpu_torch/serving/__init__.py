"""Serving: the single-device generation engine, speculative decoding,
continuous batching over a dense or paged cache, and the same engines over
a sequence-sharded (multi-card) cache."""

from long_context_attention_tpu_torch.serving.continuous import (  # noqa: F401
    ContinuousEngine,
    PagedContinuousEngine,
    PagedSpeculativeContinuousEngine,
    Request,
    RequestResult,
    ShardedContinuousEngine,
    ShardedSpeculativeContinuousEngine,
    SpeculativeContinuousEngine,
)
from long_context_attention_tpu_torch.serving.engine import (  # noqa: F401
    Engine,
    GenerationResult,
    SamplingParams,
    sample_token,
)
from long_context_attention_tpu_torch.serving.paged_sharded import (  # noqa: F401
    ShardedPagedContinuousEngine,
    ShardedPagedSpeculativeContinuousEngine,
)
from long_context_attention_tpu_torch.serving.sharded import (  # noqa: F401
    sharded_cache_append,
    sharded_decode_attention,
)
from long_context_attention_tpu_torch.serving.sharded_engine import (  # noqa: F401
    ShardedEngine,
)
from long_context_attention_tpu_torch.serving.speculative import (  # noqa: F401
    SpeculativeEngine,
    SpeculativeResult,
)
