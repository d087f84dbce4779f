"""Generation over a mesh with a sequence-sharded KV cache.

Counterpart of ``long_context_attention_tpu/serving/sharded_engine.py``:
the multi-card serving path for contexts whose cache does not fit one
card. The prompt prefills with the USP-sharded model forward
(``forward_local(mesh=...)``), each sequence rank (ring x ulysses) keeps
its own contiguous block of ``s_max / n`` cache slots, and every decode
step runs the sharded :func:`decode_step`: replicated one-token compute,
the new token's K/V appended on its owner rank, attention merged over the
ranks' partials (``serving/sharded.py``). Weights stay replicated; only
the cache is distributed.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from long_context_attention_tpu_torch.models.llama import (
    ModelConfig,
    check_devices,
    decode_step,
    forward_local,
    step_device,
)
from long_context_attention_tpu_torch.ops.decode import cache_append_rows
from long_context_attention_tpu_torch.ops.kv_cache import KVCache
from long_context_attention_tpu_torch.parallel.layouts import (
    layout_permutation,
    permute_for_layout,
)
from long_context_attention_tpu_torch.parallel.mesh import (
    MeshAxes,
    check_seq_mesh,
)

__all__ = ["ShardedEngine", "slot_exchange"]


def slot_exchange(layout: str, ring: int, n: int, s: int, slots: int):
    """How a prompt of ``s`` tokens moves from the prefill's layout chunks
    to the cache's slot blocks: for each rank r, (its chunk's local
    indices in send order, the counts it sends to each rank, the counts it
    receives from each rank, and the received tokens' slots in its block).
    Rank r's chunk holds layout positions [r * s / n, (r + 1) * s / n);
    natural position p belongs to rank p // slots, at slot p % slots."""
    perm = layout_permutation(layout, ring, s).astype(np.int64)
    c = s // n
    chunks = perm.reshape(n, c)            # natural positions of chunk q
    dest = chunks // slots                 # their owner ranks
    plans = []
    for r in range(n):
        order = np.lexsort((chunks[r], dest[r]))
        send = np.bincount(dest[r], minlength=n)[:n]
        recv = (dest == r).sum(axis=1)
        # what r receives, source by source, in each source's send order
        got = np.concatenate([np.sort(chunks[q][dest[q] == r])
                              for q in range(n)])
        plans.append((order, send, recv, got - r * slots))
    return plans


@dataclasses.dataclass(frozen=True)
class ShardedEngine:
    """Generation over a USP mesh with a sequence-sharded cache.

    ``mesh`` (``make_usp_mesh``; every rank builds the engine and calls it
    alike): the cache's slots are split over its ring x ulysses ranks in
    contiguous blocks of ``s_max / n`` (rank ``seq_idx`` holds slots
    [seq_idx * s_max / n, ...)); the batch is replicated over dp. Prompt
    length and ``s_max`` must divide by n. Any training ``layout`` serves:
    the prompt is permuted into it for the USP prefill, then each layer's
    K/V moves once from layout order to the ranks' slot blocks (one
    ``all_to_all_single`` over the sequence group; none when every rank's
    chunk is already its block, as in the basic layout with s = s_max).
    ``device``: the mesh's (None). ``cache_dtype``: "bfloat16" | "int8" |
    "float8_e4m3fn" | "int4". ``interpret`` is accepted for API parity."""

    cfg: ModelConfig
    mesh: object
    s_max: int
    cache_dtype: str = "bfloat16"
    axes: MeshAxes = MeshAxes()
    interpret: Optional[bool] = None
    device: Optional[object] = None

    def __post_init__(self):
        if self.mesh is None:
            raise ValueError("ShardedEngine needs a mesh")
        check_seq_mesh(self.mesh, "ShardedEngine")
        object.__setattr__(self, "device",
                           step_device(self.mesh, self.device))
        if self.s_max % self.n_seq:
            raise ValueError(f"s_max {self.s_max} does not divide over the "
                             f"{self.n_seq} sequence ranks")

    @property
    def n_seq(self) -> int:
        return self.mesh.ring * self.mesh.ulysses

    @property
    def slots(self) -> int:
        """Cache slots a rank holds: s_max / n."""
        return self.s_max // self.n_seq

    @property
    def seq_axes(self):
        return (self.axes.ring, self.axes.ulysses)

    def init_cache(self, b: int) -> KVCache:
        """This rank's block of a sharded cache of ``b`` rows."""
        return KVCache.init(self.cfg.n_layers, b, self.slots,
                            self.cfg.n_kv_heads, self.cfg.head_dim,
                            self.cache_dtype, device=self.device)

    def prefill_block(self, params, tokens: torch.Tensor,
                      last_index: Optional[int] = None):
        """The USP prefill of tokens (b, s) in natural order: (the logits
        of natural position ``last_index`` (default s - 1), (b, vocab) on
        every rank, and this rank's block of the prompt's K/V in slot
        order, each (L, b, m, h_kv, d) with m = clip(s - r * slots, 0,
        slots)). Only the owner of the last token projects it through
        lm_head; one all-reduce over the sequence group replicates it."""
        mesh, cfg = self.mesh, self.cfg
        b, s = tokens.shape
        n = self.n_seq
        if s % n:
            raise ValueError(f"prompt length {s} does not divide over the "
                             f"{n} sequence ranks")
        if s > self.s_max:
            raise ValueError(f"prompt length {s} exceeds cache capacity "
                             f"s_max={self.s_max}")
        check_devices(self.device, "engine",
                      **{"params['embed']": params["embed"]}, tokens=tokens)
        natural_last = s - 1 if last_index is None else int(last_index)
        perm = layout_permutation(cfg.layout, mesh.ring, s)
        s_local = s // n
        owner, loc = divmod(int((perm == natural_last).argmax()), s_local)
        r = mesh.seq_idx
        local = permute_for_layout(tokens, cfg.layout, mesh.ring,
                                   axis=1).chunk(n, dim=1)[r]
        with torch.no_grad():
            logits, (kk, vv) = forward_local(
                params, local, cfg, mesh=mesh, return_kv=True,
                last_index=loc)
        logits = logits[:, 0]
        if r != owner:
            logits = torch.zeros_like(logits)
        if mesh.seq_group is not None:
            dist.all_reduce(logits, group=mesh.seq_group)
        return logits, self._to_slots(kk, vv, s)

    def _to_slots(self, kk, vv, s: int):
        """This rank's layout chunk of K and V (L, b, s / n, h_kv, d) ->
        its block of the cache's slots, in slot order."""
        n, r = self.n_seq, self.mesh.seq_idx
        c = s // n
        perm = layout_permutation(self.cfg.layout, self.mesh.ring, s)
        if np.array_equal(perm.reshape(n, c), np.arange(n)[:, None]
                          * self.slots + np.arange(c)):
            return kk, vv  # every chunk is the head of its rank's block
        order, send, recv, got = slot_exchange(
            self.cfg.layout, self.mesh.ring, n, s, self.slots)[r]
        x = torch.stack([kk, vv])              # (2, L, b, c, h_kv, d)
        x = x.movedim(3, 0)[torch.as_tensor(order, device=x.device)]
        out = x.new_empty((int(recv.sum()),) + tuple(x.shape[1:]))
        dist.all_to_all_single(out, x.contiguous(),
                               output_split_sizes=[int(v) for v in recv],
                               input_split_sizes=[int(v) for v in send],
                               group=self.mesh.seq_group)
        block = out.new_empty(out.shape)
        block[torch.as_tensor(got, device=out.device)] = out
        block = block.movedim(0, 3)
        return block[0], block[1]

    def prefill(self, params, tokens: torch.Tensor,
                last_index: Optional[int] = None
                ) -> Tuple[torch.Tensor, KVCache]:
        """tokens (b, s) in natural order -> (the last token's logits (b,
        vocab), this rank's block of the sharded cache with ``length`` the
        global s). ``last_index``: the natural position whose logits to
        return (a bucket-padded prompt's true last token)."""
        b, s = tokens.shape
        logits, (kk, vv) = self.prefill_block(params, tokens, last_index)
        cache = self.init_cache(b)
        if kk.shape[2]:
            cache_append_rows(cache, None, kk, vv, 0)
        cache.length.fill_(s)
        return logits, cache

    def _decode_scan(self, params, cache: KVCache, max_new: int,
                     first_token: torch.Tensor):
        """``max_new`` greedy sharded decode steps from ``first_token``, IN
        PLACE on the cache: ((b, max_new) int32 tokens, token i the input
        of step i, and the cache)."""
        tok = first_token.to(torch.int32)
        toks = []
        for _ in range(max_new):
            logits, cache = decode_step(params, cache, tok, self.cfg,
                                        mesh=self.mesh)
            toks.append(tok)
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
        return torch.stack(toks, dim=1), cache

    def generate(self, params, prompt: torch.Tensor, max_new: int):
        """Greedy generation: (tokens (b, max_new), this rank's cache, the
        prefill's last-token logits)."""
        s = prompt.shape[1]
        if s + max_new > self.s_max:
            raise ValueError(
                f"prompt ({s}) + max_new ({max_new}) exceeds cache capacity "
                f"s_max={self.s_max}")
        logits, cache = self.prefill(params, prompt)
        first = torch.argmax(logits, dim=-1).to(torch.int32)
        toks, cache = self._decode_scan(params, cache, max_new, first)
        return toks, cache, logits
