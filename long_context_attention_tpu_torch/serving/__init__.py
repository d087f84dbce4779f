"""The single-device generation engine."""

from long_context_attention_tpu_torch.serving.engine import (  # noqa: F401
    Engine,
    GenerationResult,
    SamplingParams,
    sample_token,
)
