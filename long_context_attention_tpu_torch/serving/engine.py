"""Generation engine: prefill, chunked prefill and the decode loop.

Counterpart of ``long_context_attention_tpu/serving/engine.py`` on one
device: the prompt prefills through the model forward (whole, or in chunks
against the growing cache), its post-RoPE K/V land in a bf16 or int8
:class:`KVCache`, and generation is a Python loop of single-token
:func:`decode_step` calls that update the cache in place. JAX PRNG keys
become ``torch.Generator``s.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from long_context_attention_tpu_torch.models.llama import (
    ModelConfig,
    decode_step,
    forward_local,
    prefill_chunk_step,
)
from long_context_attention_tpu_torch.ops.kv_cache import KVCache
from long_context_attention_tpu_torch.ops.wquant import quantize_decode_params
from long_context_attention_tpu_torch.utils.config import (
    not_ported,
    resolve_device,
)

__all__ = ["Engine", "GenerationResult", "SamplingParams", "sample_token",
           "sampling_probs", "token_logprob", "transform_logits"]


@dataclasses.dataclass
class GenerationResult:
    tokens: torch.Tensor          # (b, max_new) generated token ids
    cache: KVCache                # final cache (prompt + generated)
    prefill_logits: torch.Tensor  # (b, vocab) logits at the last prompt token


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Greedy by default; temperature/top-k/top-p compose in that order."""

    temperature: float = 0.0   # 0 = greedy argmax
    top_k: int = 0             # 0 = disabled
    top_p: float = 1.0         # 1 = disabled


def transform_logits(logits: torch.Tensor, params: SamplingParams
                     ) -> torch.Tensor:
    """Apply temperature / top-k / top-p to (..., vocab) fp32 logits; the
    softmax of the result is the sampling distribution."""
    if params.temperature <= 0.0:
        raise ValueError("transform_logits needs temperature > 0")
    logits = logits / params.temperature
    neg = torch.tensor(-float("inf"), device=logits.device)
    if params.top_k > 0:
        kth = torch.sort(logits, dim=-1).values[..., -params.top_k][..., None]
        logits = torch.where(logits < kth, neg, logits)
    if params.top_p < 1.0:
        sorted_l = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_l, dim=-1), dim=-1)
        cutoff_idx = (cum < params.top_p).sum(dim=-1, keepdim=True)
        cutoff = torch.gather(sorted_l, -1, cutoff_idx)
        logits = torch.where(logits < cutoff, neg, logits)
    return logits


def sampling_probs(logits: torch.Tensor, params: SamplingParams
                   ) -> torch.Tensor:
    """(..., vocab) fp32 logits -> the post-transform sampling distribution."""
    return torch.softmax(transform_logits(logits, params), dim=-1)


def sample_token(logits: torch.Tensor, params: SamplingParams,
                 generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
    """(b, vocab) fp32 logits -> (b,) int32 token ids."""
    if params.temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = sampling_probs(logits, params)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)


def token_logprob(logits: torch.Tensor, tok: torch.Tensor) -> torch.Tensor:
    """(b, vocab) logits + (b,) chosen ids -> (b,) fp32 log P(tok) under the
    softmax of the raw logits."""
    lsm = torch.log_softmax(logits.float(), dim=-1)
    return torch.gather(lsm, -1, tok[:, None].long())[:, 0]


@dataclasses.dataclass(frozen=True)
class Engine:
    """Single-device generation engine for the llama model.

    ``cache_dtype``: "bfloat16" | "int8". ``weight_dtype``: "bfloat16" |
    "int8"; int8 quantizes the decode weights per output channel
    (:meth:`decode_params`), prefill keeps the bf16 ``params``.
    ``device``: where the engine runs and its caches are made; None means
    the card (raises without one), "cpu" runs every kernel's plain version.
    Params, tokens and caches on another device raise. The JAX engine's
    ``mesh`` (sequence-sharded prefill) is not ported: passing one raises.
    """

    cfg: ModelConfig
    s_max: int
    cache_dtype: str = "bfloat16"
    weight_dtype: str = "bfloat16"
    mesh: Optional[object] = None
    device: Optional[object] = None

    def __post_init__(self):
        if self.mesh is not None:
            raise not_ported("sequence-sharded prefill (mesh)")
        if self.weight_dtype not in ("bfloat16", "int8"):
            raise ValueError(f"weight_dtype {self.weight_dtype!r}")
        object.__setattr__(self, "device", resolve_device(self.device))

    def decode_params(self, params):
        """The params the decode loop runs with: int8 QTensor weights when
        ``weight_dtype="int8"``, else ``params`` unchanged."""
        if self.weight_dtype == "bfloat16":
            return params
        return quantize_decode_params(params)

    def init_cache(self, b: int) -> KVCache:
        return KVCache.init(self.cfg.n_layers, b, self.s_max,
                            self.cfg.n_kv_heads, self.cfg.head_dim,
                            self.cache_dtype, device=self.device)

    def prefill(self, params, tokens: torch.Tensor
                ) -> Tuple[torch.Tensor, KVCache]:
        """tokens (b, s_prompt) -> (last-token logits (b, vocab), cache)."""
        b, s = tokens.shape
        self._check_fits(s)
        self._check_device(params, tokens=tokens)
        with torch.no_grad():
            logits, (kv_k, kv_v) = forward_local(
                params, tokens, self.cfg, return_kv=True, last_index=s - 1)
        cache = self.init_cache(b)
        for layer in range(self.cfg.n_layers):
            cache.write_prompt(layer, kv_k[layer], kv_v[layer])
        cache.advance(s)
        return logits[:, 0], cache

    def prefill_chunked(self, params, tokens: torch.Tensor, chunk_size: int
                        ) -> Tuple[torch.Tensor, KVCache]:
        """Bounded-memory prefill: the prompt streams through in chunks,
        each attending causally to itself and fully to the cache prefix.
        Same contract as :meth:`prefill`."""
        b, s = tokens.shape
        if s % chunk_size:
            raise ValueError(f"prompt length {s} is not a multiple of the "
                             f"chunk size {chunk_size}")
        self._check_fits(s)
        self._check_device(params, tokens=tokens)
        cache = self.init_cache(b)
        for start in range(0, s, chunk_size):
            logits, cache = prefill_chunk_step(
                params, cache, tokens[:, start:start + chunk_size], start,
                self.cfg, last_logit_only=True)
        return logits[:, -1], cache

    def decode_scan(self, params, cache: KVCache, max_new: int,
                    first_token: torch.Tensor,
                    sampling: SamplingParams = SamplingParams(),
                    generator: Optional[torch.Generator] = None):
        """Decode ``max_new`` steps from a filled cache, IN PLACE on it.
        ``params`` are the :meth:`decode_params` weights. Returns ((b,
        max_new) int32 tokens, cache); token i is the input of step i, the
        first one being ``first_token``, as in the JAX engine."""
        self._check_device(params, first_token=first_token, cache=cache.k)
        tok = first_token.to(torch.int32)
        toks = []
        for _ in range(max_new):
            logits, cache = decode_step(params, cache, tok, self.cfg)
            toks.append(tok)
            tok = sample_token(logits, sampling, generator)
        return torch.stack(toks, dim=1), cache

    def generate(self, params, prompt: torch.Tensor, max_new: int, *,
                 sampling: SamplingParams = SamplingParams(),
                 generator: Optional[torch.Generator] = None
                 ) -> GenerationResult:
        """Generate ``max_new`` tokens per row (greedy unless ``sampling``
        says otherwise). prompt (b, s) int."""
        s = prompt.shape[1]
        if s + max_new > self.s_max:
            raise ValueError(
                f"prompt ({s}) + max_new ({max_new}) exceeds cache capacity "
                f"s_max={self.s_max}")
        logits, cache = self.prefill(params, prompt)
        first = sample_token(logits, sampling, generator)
        toks, cache = self.decode_scan(self.decode_params(params), cache,
                                       max_new, first, sampling, generator)
        return GenerationResult(tokens=toks, cache=cache,
                                prefill_logits=logits)

    def _check_device(self, params, **tensors) -> None:
        """Raise unless the weights and ``tensors`` live on the engine's
        device: a card engine never computes on CPU tensors."""
        tensors = {"params['embed']": params["embed"], **tensors}
        for name, t in tensors.items():
            if t.device != self.device:
                raise ValueError(f"{name} is on {t.device}, but the engine "
                                 f"runs on {self.device}")

    def _check_fits(self, s: int) -> None:
        if s > self.s_max:
            raise ValueError(f"prompt length {s} exceeds cache capacity "
                             f"s_max={self.s_max}")
