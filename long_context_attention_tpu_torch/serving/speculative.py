"""Speculative decoding: a small draft model proposes, the target verifies.

Counterpart of ``long_context_attention_tpu/serving/speculative.py``
(Leviathan et al., arXiv:2211.17192). Each round the draft emits ``gamma``
tokens one decode step at a time (kernels B6 and one-token B7 per draft
layer), then the target scores all of them in one
:func:`decode_multi_step` (per target layer one B6 and B7's run of ``gamma
+ 1`` tokens). Greedy mode accepts the longest draft prefix that equals the
target's own argmax choices, so every emitted token is a target-greedy
token. Sampled mode (``sampling.temperature > 0``) runs the full acceptance
rule, accept d ~ q with probability min(1, p(d) / q(d)), else draw from
normalize(max(p - q, 0)), whose output is distributed exactly as sampling
from the target. Either way a round costs one target forward for up to
``gamma + 1`` emitted tokens.

Rollback is a reset of each cache's ``length``: the verify writes its run's
K/V in place, and the slots past a row's kept length are masked by every
reader and overwritten by the next round's appends; no cache is copied.
JAX's keys become ``torch.Generator``s: one per row (the continuous
engines: a request's own), or one for the batch (:meth:`generate`).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from long_context_attention_tpu_torch.models.llama import (
    ModelConfig,
    decode_multi_step,
    decode_step,
)
from long_context_attention_tpu_torch.ops.wquant import quantize_decode_params
from long_context_attention_tpu_torch.serving.engine import (
    Engine,
    SamplingParams,
    sample_token,
    sampling_probs,
)
from long_context_attention_tpu_torch.utils.config import resolve_device

__all__ = ["SpeculativeEngine", "SpeculativeResult", "leviathan_accept",
           "speculative_residual"]

Gens = Sequence[Optional[torch.Generator]]


def speculative_residual(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Leviathan's rejection residual normalize(max(p - q, 0)) over the last
    axis. Drawing d ~ q, accepting it with probability min(1, p(d) / q(d))
    and else drawing from this residual gives exactly p. Where p == q the
    residual is never drawn, and p itself is returned."""
    r = torch.clamp(p - q, min=0.0)
    z = r.sum(dim=-1, keepdim=True)
    return torch.where(z > 0, r / torch.clamp(z, min=1e-37), p)


def leviathan_accept(logits: torch.Tensor, drafts: torch.Tensor,
                     qdist: torch.Tensor, sampling: SamplingParams,
                     generator: Optional[torch.Generator] = None):
    """The Leviathan acceptance rule on the target's verify logits.

    logits (b, gamma+1, vocab): position j's logits follow token j of the
    verify run [t, d_1..d_gamma]; drafts (b, gamma) were drawn from qdist
    (b, gamma, vocab). Returns (accept (b, gamma) bool: d_{j+1} passes the
    min(1, p_j(d) / q_j(d)) test, and fallback (b, gamma+1) int32:
    fallback[:, j] is a draw from the residual at j, or from p_gamma at j =
    gamma, so the caller takes the entry of the first rejection). The
    accepted prefix and its fallback are distributed exactly as sampling
    every token from the target (arXiv:2211.17192, Theorem 1). The uniform
    draws come first from ``generator``, then the fallbacks."""
    b, n, vocab = logits.shape
    p = sampling_probs(logits, sampling)
    idx = drafts[..., None].long()
    p_d = torch.gather(p[:, :-1], -1, idx)[..., 0]
    q_d = torch.gather(qdist, -1, idx)[..., 0]
    u = torch.rand(drafts.shape, generator=generator, device=p.device)
    accept = u < torch.clamp(p_d / torch.clamp(q_d, min=1e-37), max=1.0)
    resid = speculative_residual(p[:, :-1], qdist)
    fb_dist = torch.cat([resid, p[:, -1:]], dim=1)
    fallback = torch.multinomial(fb_dist.reshape(b * n, vocab), 1,
                                 generator=generator).reshape(b, n)
    return accept, fallback.to(torch.int32)


def draw_rows(probs: torch.Tensor, gens: Gens) -> torch.Tensor:
    """(b, vocab) probabilities -> (b,) int32, row i drawn with ``gens[i]``
    (a row without a generator takes the argmax, which nobody reads)."""
    out = torch.argmax(probs, dim=-1).to(torch.int32)
    for i, gen in enumerate(gens):
        if gen is not None:
            out[i] = torch.multinomial(probs[i:i + 1], 1, generator=gen)[0, 0]
    return out


@dataclasses.dataclass
class SpeculativeResult:
    tokens: np.ndarray        # (b, max_new) emitted tokens
    rounds: int               # verify rounds run
    drafted: int              # draft tokens proposed (b * gamma * rounds)
    accepted: int             # draft tokens accepted over all rows and rounds


@dataclasses.dataclass(frozen=True)
class SpeculativeEngine:
    """Speculative decoding for the llama family: ``cfg`` the target,
    ``draft_cfg`` the (smaller) draft over the same vocabulary; each keeps
    its own dense cache. ``weight_dtype="int8"`` runs both models' decode
    and verify steps on w8a8 weights (the prefills keep the bf16 params);
    with sampling the acceptance stays exact for the distribution the
    quantized target computes. ``device``: None means the card, "cpu" runs
    every kernel's plain version."""

    cfg: ModelConfig
    draft_cfg: ModelConfig
    s_max: int
    gamma: int = 4
    cache_dtype: str = "bfloat16"
    weight_dtype: str = "bfloat16"
    device: Optional[object] = None

    def __post_init__(self):
        if self.cfg.vocab != self.draft_cfg.vocab:
            raise ValueError("the target's and the draft's vocabularies "
                             "differ")
        if self.gamma < 1:
            raise ValueError(f"gamma {self.gamma} < 1")
        if self.weight_dtype not in ("bfloat16", "int8"):
            raise ValueError(f"weight_dtype {self.weight_dtype!r}")
        object.__setattr__(self, "device", resolve_device(self.device))

    def _decode_params(self, p):
        return p if self.weight_dtype == "bfloat16" else \
            quantize_decode_params(p)

    # --- round pieces ------------------------------------------------------

    @torch.no_grad()
    def _draft_run(self, draft_params, dcache, t: torch.Tensor,
                   active: Optional[torch.Tensor] = None, mesh=None):
        """gamma + 1 greedy draft steps from the last tokens t (b,): the
        first gamma proposals (b, gamma) and the draft cache, advanced IN
        PLACE. The extra step writes d_gamma's K/V, so a round that keeps
        every draft leaves the draft cache covering every kept slot.
        ``active``: inactive rows write nothing, advance nothing and repeat
        their input token. ``mesh``: the caches are sequence-sharded over
        it (the sharded continuous engines)."""
        tok, toks = t, []
        for _ in range(self.gamma + 1):
            logits, dcache = decode_step(draft_params, dcache, tok,
                                         self.draft_cfg, active=active,
                                         mesh=mesh)
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)
            if active is not None:
                nxt = torch.where(active, nxt, tok)
            toks.append(nxt)
            tok = nxt
        return torch.stack(toks, dim=1)[:, :self.gamma], dcache

    @torch.no_grad()
    def _verify(self, params, tcache, toks: torch.Tensor,
                active: Optional[torch.Tensor] = None, mesh=None):
        """The target scores the run [t, d_1..d_gamma] (b, gamma+1) in one
        multi-token step: its greedy choice after each position (b,
        gamma+1) and the cache advanced by gamma + 1, IN PLACE."""
        logits, tcache = decode_multi_step(params, tcache, toks, self.cfg,
                                           active=active, mesh=mesh)
        return torch.argmax(logits, dim=-1).to(torch.int32), tcache

    @torch.no_grad()
    def _draft_run_sampled(self, draft_params, dcache, t: torch.Tensor,
                           sampling: SamplingParams, gens: Gens,
                           active: Optional[torch.Tensor] = None,
                           mesh=None):
        """gamma + 1 sampled draft steps, row i drawing with ``gens[i]``:
        (drafts (b, gamma), qdist (b, gamma, vocab), the distributions the
        drafts were drawn from, and the advanced cache)."""
        tok, toks, qs = t, [], []
        for _ in range(self.gamma + 1):
            logits, dcache = decode_step(draft_params, dcache, tok,
                                         self.draft_cfg, active=active,
                                         mesh=mesh)
            q = sampling_probs(logits, sampling)
            nxt = draw_rows(q, gens)
            if active is not None:
                nxt = torch.where(active, nxt, tok)
            toks.append(nxt)
            qs.append(q)
            tok = nxt
        return (torch.stack(toks, dim=1)[:, :self.gamma],
                torch.stack(qs[:self.gamma], dim=1), dcache)

    @torch.no_grad()
    def _verify_sampled(self, params, tcache, toks, drafts, qdist,
                        sampling: SamplingParams, gens: Gens,
                        active: Optional[torch.Tensor] = None, mesh=None):
        """The target's verify and the Leviathan rule, row i drawing with
        ``gens[i]`` (rows without one accept nothing): (accept (b, gamma),
        fallback (b, gamma+1), the advanced cache)."""
        logits, tcache = decode_multi_step(params, tcache, toks, self.cfg,
                                           active=active, mesh=mesh)
        accept = torch.zeros(drafts.shape, dtype=torch.bool,
                             device=drafts.device)
        fallback = torch.zeros(toks.shape, dtype=torch.int32,
                               device=toks.device)
        for i, gen in enumerate(gens):
            if gen is not None:
                accept[i:i + 1], fallback[i:i + 1] = leviathan_accept(
                    logits[i:i + 1], drafts[i:i + 1], qdist[i:i + 1],
                    sampling, gen)
        return accept, fallback, tcache

    # --- generation --------------------------------------------------------

    def generate(self, params, draft_params, prompt: torch.Tensor,
                 max_new: int, *,
                 sampling: SamplingParams = SamplingParams(),
                 generator: Optional[torch.Generator] = None
                 ) -> SpeculativeResult:
        """Generate ``max_new`` tokens per row of prompt (b, s). Greedy by
        default; with ``sampling.temperature > 0`` the full Leviathan rule,
        every draw from ``generator`` (seed 0 when None)."""
        b, s = prompt.shape
        sampled = sampling.temperature > 0.0
        if s + max_new + self.gamma > self.s_max:
            raise ValueError(
                f"prompt ({s}) + max_new ({max_new}) + gamma ({self.gamma}) "
                f"exceeds cache capacity s_max={self.s_max}")
        teng = Engine(self.cfg, s_max=self.s_max,
                      cache_dtype=self.cache_dtype, device=self.device)
        deng = Engine(self.draft_cfg, s_max=self.s_max,
                      cache_dtype=self.cache_dtype, device=self.device)
        tl, tcache = teng.prefill(params, prompt)
        _, dcache = deng.prefill(draft_params, prompt)
        # the rounds run on the (optionally int8) decode weights; the
        # prefills above took the bf16 params
        params = self._decode_params(params)
        draft_params = self._decode_params(draft_params)
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        gens = [generator] * b
        t = sample_token(tl, sampling, generator)
        emitted: List[List[int]] = [[x] for x in t.tolist()]
        rounds = drafted = accepted = 0
        while min(len(e) for e in emitted) < max_new:
            base_len = tcache.length.cpu().numpy().copy()
            if sampled:
                drafts, qdist, dcache = self._draft_run_sampled(
                    draft_params, dcache, t, sampling, gens)
                run = torch.cat([t[:, None], drafts], dim=1)
                accept_m, fallback, tcache = self._verify_sampled(
                    params, tcache, run, drafts, qdist, sampling, gens)
                acc_np = accept_m.cpu().numpy()
                c_np = fallback.cpu().numpy()
            else:
                drafts, dcache = self._draft_run(draft_params, dcache, t)
                run = torch.cat([t[:, None], drafts], dim=1)
                choices, tcache = self._verify(params, tcache, run)
                c_np = choices.cpu().numpy()
                acc_np = drafts.cpu().numpy() == c_np[:, :self.gamma]
            d_np = drafts.cpu().numpy()
            t_np = t.cpu().numpy()
            # each row keeps the longest draft prefix the target ratified,
            # then its correction (or the bonus token after gamma); a row
            # that already has max_new keeps nothing, so its cache stops
            acc = np.zeros((b,), np.int64)
            adv = np.ones((b,), np.int64)
            nxt = np.zeros((b,), np.int32)
            for i in range(b):
                if len(emitted[i]) >= max_new:
                    adv[i] = 0
                    nxt[i] = t_np[i]
                    continue
                a = 0
                while a < self.gamma and acc_np[i, a]:
                    a += 1
                acc[i] = a
                nxt[i] = c_np[i, a]
                emitted[i].extend([int(x) for x in d_np[i, :a]]
                                  + [int(c_np[i, a])])
                drafted += self.gamma
                accepted += a
            rounds += 1
            # roll both caches back to [.., t, d_1..d_a]: each its own
            # length, no cache copied
            keep = base_len + adv * (acc + 1)
            tcache.length.copy_(torch.as_tensor(keep, dtype=torch.int32))
            dcache.length.copy_(torch.as_tensor(keep, dtype=torch.int32))
            t = torch.as_tensor(nxt, device=self.device)
        toks = np.asarray([e[:max_new] for e in emitted], np.int32)
        return SpeculativeResult(tokens=toks, rounds=rounds,
                                 drafted=drafted, accepted=accepted)
