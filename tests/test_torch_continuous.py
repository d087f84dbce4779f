"""Continuous and paged serving of the PyTorch port against the JAX package:
the port's ContinuousEngine and PagedContinuousEngine (batch admission,
step_block, host_overlap, interleaved admission, the prefix cache,
backpressure) give the JAX ContinuousEngine's greedy tokens for the same
requests and weights, through queueing, page reuse and EOS exits; logprobs
against teacher forcing; sampled runs of the port's schedulers against its
sequential loop.

The model is the tiny config in float32 (as the JAX suite's
tests/test_paged.py compares schedulers): interleaved and prefix admission
prefill through the multi-token decode kernel, batch admission through the
flash kernel, and a bf16 model can break a near-tie of the greedy argmax
differently on the two (or on the two packages); in float32 the kernels'
last-bit differences vanish inside the cache's bf16 or int8 storage
rounding. The JAX engines run once per module, their Pallas kernels in
interpret mode.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from long_context_attention_tpu import serving as jserving
from long_context_attention_tpu.models import llama as jllama
from long_context_attention_tpu_torch import serving as tserving
from long_context_attention_tpu_torch.models import llama as tllama
from long_context_attention_tpu_torch.utils.convert import params_from_jax

torch.set_num_threads(1)

SHAPE = dict(vocab=96, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
             head_dim=32, ffn_hidden=128, layout="basic")
JCFG = jllama.ModelConfig(**SHAPE, dtype=jnp.float32)
TCFG = tllama.ModelConfig(**SHAPE, dtype=torch.float32)
S_MAX, PAGE = 512, 128
# (prompt length, max_new): queueing through 2 rows, prompts from one to
# three pages, buckets 64 to 512
SPECS = [(24, 6), (200, 4), (100, 8), (17, 3), (300, 5)]
EOS_AT = (2, 3)   # EOS = request 2's 4th greedy token (ends it early)


def _requests(pkg):
    rng = np.random.default_rng(5)
    return [pkg.Request(id=i, tokens=[int(t) for t in rng.integers(
        0, SHAPE["vocab"], n)], max_new=m) for i, (n, m) in enumerate(SPECS)]


@pytest.fixture(scope="module")
def setup():
    """JAX's ContinuousEngine tokens (int8 and bf16 caches, and with EOS)
    and the port's params from the same weights."""
    jparams = jllama.init_params(jax.random.PRNGKey(0), JCFG)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              device="cpu")
    jreqs = _requests(jserving)
    want = {}
    for dtype in ("int8", "bfloat16"):
        eng = jserving.ContinuousEngine(JCFG, s_max=S_MAX, max_batch=2,
                                        cache_dtype=dtype)
        want[dtype] = {i: r.tokens for i, r in
                       eng.serve(jparams, jreqs).items()}
    eos = want["int8"][EOS_AT[0]][EOS_AT[1]]
    eng = jserving.ContinuousEngine(JCFG, s_max=S_MAX, max_batch=2,
                                    cache_dtype="int8", step_block=3)
    want["eos"] = {i: r.tokens for i, r in
                   eng.serve(jparams, jreqs, eos_id=eos).items()}
    return tparams, _requests(tserving), want, eos


def _tokens(res):
    return {i: r.tokens for i, r in res.items()}


CONT_VARIANTS = {
    "plain": {}, "step_block": dict(step_block=3),
    "host_overlap": dict(host_overlap=True),
    "overlap_block": dict(host_overlap=True, step_block=2)}
PAGED_VARIANTS = {
    "plain": {}, "host_overlap": dict(host_overlap=True, step_block=2),
    "interleaved": dict(interleave_admission=True, prefill_chunk=64),
    "prefix": dict(prefix_cache=True, prefill_chunk=64),
    "prefix_interleaved": dict(prefix_cache=True, interleave_admission=True,
                               prefill_chunk=64)}


@pytest.mark.parametrize("eos", [False, True], ids=["budget", "eos"])
@pytest.mark.parametrize("variant", sorted(CONT_VARIANTS))
def test_continuous_matches_jax(setup, variant, eos):
    """The port's ContinuousEngine (int8 cache) gives the JAX engine's
    greedy tokens per request, with or without an EOS that ends a request
    mid-block, under each scheduler."""
    tparams, reqs, want, eos_id = setup
    eng = tserving.ContinuousEngine(TCFG, s_max=S_MAX, max_batch=2,
                                    cache_dtype="int8", device="cpu",
                                    **CONT_VARIANTS[variant])
    got = _tokens(eng.serve(tparams, reqs, eos_id=eos_id if eos else None))
    assert got == want["eos" if eos else "int8"]
    if eos:  # request 2 ends at the EOS's first appearance, before its budget
        full = want["int8"][EOS_AT[0]]
        assert len(got[EOS_AT[0]]) == full.index(eos_id) + 1 < len(full)


@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
@pytest.mark.parametrize("variant", sorted(PAGED_VARIANTS))
def test_paged_matches_jax(setup, variant, dtype):
    """The port's PagedContinuousEngine (pages of 128 from a pool of 12)
    gives the JAX ContinuousEngine's greedy tokens: batch admission, host
    overlap, interleaved chunked admission, the prefix cache, both."""
    tparams, reqs, want, _ = setup
    eng = tserving.PagedContinuousEngine(
        TCFG, s_max=S_MAX, max_batch=2, cache_dtype=dtype, page_size=PAGE,
        pool_pages=12, device="cpu", **PAGED_VARIANTS[variant])
    assert _tokens(eng.serve(tparams, reqs)) == want[dtype]


def test_paged_backpressure_still_completes(setup):
    """A pool of one allocatable page holds one request at a time: the
    second row waits at each block boundary, and every request still gives
    the JAX engine's tokens; a request the pool can never hold raises."""
    tparams, reqs, want, _ = setup
    small = [r for r in reqs if len(r.tokens) + r.max_new <= PAGE]
    eng = tserving.PagedContinuousEngine(
        TCFG, s_max=S_MAX, max_batch=2, cache_dtype="int8", page_size=PAGE,
        pool_pages=2, device="cpu")
    got = _tokens(eng.serve(tparams, small))
    assert got == {r.id: want["int8"][r.id] for r in small}
    with pytest.raises(ValueError, match="pages"):
        eng.serve(tparams, [tserving.Request(id=9, tokens=[1] * 100,
                                             max_new=200)])


def test_logprobs_match_teacher_forcing(setup):
    """return_logprobs: every reported logprob (the admission's first
    token and each decode step) is the log-softmax of a full forward over
    prompt + generation at that position; the blocked, overlapped and
    paged-interleaved schedulers report the same tokens and logprobs."""
    tparams, reqs, _, _ = setup
    req = reqs[1]
    base = tserving.ContinuousEngine(TCFG, s_max=S_MAX, max_batch=2,
                                     return_logprobs=True, device="cpu")
    res = base.serve(tparams, [req])[req.id]
    assert len(res.logprobs) == len(res.tokens) == req.max_new
    seq = torch.tensor([list(req.tokens) + res.tokens[:-1]])
    with torch.no_grad():
        lsm = torch.log_softmax(tllama.forward_local(tparams, seq, TCFG)[0],
                                -1)
    for j, (tok, lp) in enumerate(zip(res.tokens, res.logprobs)):
        assert abs(lp - float(lsm[len(req.tokens) - 1 + j, tok])) < 5e-2, j
    for eng in (
            tserving.ContinuousEngine(TCFG, s_max=S_MAX, max_batch=2,
                                      step_block=3, return_logprobs=True,
                                      device="cpu"),
            tserving.ContinuousEngine(TCFG, s_max=S_MAX, max_batch=2,
                                      step_block=2, host_overlap=True,
                                      return_logprobs=True, device="cpu"),
            tserving.PagedContinuousEngine(
                TCFG, s_max=S_MAX, max_batch=2, page_size=PAGE, pool_pages=8,
                interleave_admission=True, prefill_chunk=64,
                return_logprobs=True, device="cpu")):
        r2 = eng.serve(tparams, [req])[req.id]
        assert r2.tokens == res.tokens
        np.testing.assert_allclose(r2.logprobs, res.logprobs, atol=2e-2)


def test_sampled_runs_equal_sequential(setup):
    """Sampled runs (temperature 0.8, top-k 20): each request draws from
    its own generator seeded from (seed, request id), so step_block,
    host_overlap and the paged engine (at one page a row: the dense tile,
    the same arithmetic) give the sequential loop's tokens; another seed
    gives other tokens."""
    tparams, reqs, _, _ = setup
    sp = tserving.SamplingParams(temperature=0.8, top_k=20)

    def run(eng_cls=tserving.ContinuousEngine, seed=0, **kw):
        eng = eng_cls(TCFG, s_max=S_MAX, max_batch=2, cache_dtype="int8",
                      device="cpu", **kw)
        return _tokens(eng.serve(tparams, reqs, sampling=sp, seed=seed))

    seq = run()
    assert run(step_block=3) == seq
    assert run(host_overlap=True, step_block=2) == seq
    assert run(tserving.PagedContinuousEngine, page_size=S_MAX,
               pool_pages=3, host_overlap=True) == seq
    assert run(seed=1) != seq
    assert all(len(seq[i]) == m for i, (_, m) in enumerate(SPECS))


def test_interleaved_admission_decodes_between_chunks(setup):
    """While a four-chunk prompt admits, the running row decodes between
    its chunks (the order of device calls, seen by a probing subclass)."""
    tparams, _, _, _ = setup
    log = []

    @dataclasses.dataclass(frozen=True)
    class Probe(tserving.PagedContinuousEngine):
        def _admission_advance(self, params, cache, st):
            log.append("chunk")
            return super()._admission_advance(params, cache, st)

        def _decode_block(self, *a, **kw):
            log.append("step")
            return tserving.PagedContinuousEngine._decode_block(self, *a,
                                                                **kw)

    reqs = [tserving.Request(id=0, tokens=list(range(16)), max_new=12),
            tserving.Request(id=1, tokens=[5] * 250, max_new=3)]
    eng = Probe(TCFG, s_max=S_MAX, max_batch=2, page_size=PAGE,
                pool_pages=12, interleave_admission=True, prefill_chunk=64,
                device="cpu")
    assert set(eng.serve(tparams, reqs)) == {0, 1}
    chunks = [i for i, e in enumerate(log) if e == "chunk"]
    assert len(chunks) == 1 + 4  # request 0's chunk, request 1's four
    assert all("step" in log[a + 1:b]
               for a, b in zip(chunks[1:], chunks[2:]))


def test_engine_guards(monkeypatch):
    """Requests past capacity and interleaving with host_overlap raise;
    native_runtime=True and a sliding-window model construct (the window
    pages by its rolling pages without the prefix cache); without a card
    the engines raise unless given the CPU."""
    eng = tserving.ContinuousEngine(TCFG, s_max=64, device="cpu")
    with pytest.raises(ValueError, match="capacity"):
        eng.serve({"embed": torch.zeros(1)},
                  [tserving.Request(id=0, tokens=[1] * 60, max_new=8)])
    kw = dict(s_max=S_MAX, page_size=PAGE, pool_pages=4, device="cpu")
    with pytest.raises(ValueError, match="host_overlap"):
        tserving.PagedContinuousEngine(TCFG, interleave_admission=True,
                                       host_overlap=True, **kw)
    eng = tserving.PagedContinuousEngine(TCFG, native_runtime=True, **kw)
    assert eng.native_runtime and eng.last_alloc_kind == "unused"
    wcfg = dataclasses.replace(TCFG, window_left=64)
    assert tserving.PagedContinuousEngine(wcfg, **kw)._windowed_paging
    # a windowed model pages by whole spans with the prefix cache
    assert not tserving.PagedContinuousEngine(
        wcfg, prefix_cache=True, **kw)._windowed_paging
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tserving.ContinuousEngine(TCFG, s_max=S_MAX)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tserving.PagedContinuousEngine(TCFG, s_max=S_MAX, page_size=PAGE,
                                       pool_pages=4)
