"""Serving: the single-device generation engine, speculative decoding, and
continuous batching over a dense or paged cache."""

from long_context_attention_tpu_torch.serving.continuous import (  # noqa: F401
    ContinuousEngine,
    PagedContinuousEngine,
    PagedSpeculativeContinuousEngine,
    Request,
    RequestResult,
    SpeculativeContinuousEngine,
)
from long_context_attention_tpu_torch.serving.engine import (  # noqa: F401
    Engine,
    GenerationResult,
    SamplingParams,
    sample_token,
)
from long_context_attention_tpu_torch.serving.speculative import (  # noqa: F401
    SpeculativeEngine,
    SpeculativeResult,
)
