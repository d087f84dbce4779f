"""Speculative decoding in the PyTorch port against the JAX package:
SpeculativeEngine, SpeculativeContinuousEngine and
PagedSpeculativeContinuousEngine.

Greedy tokens are held equal to JAX's (its SpeculativeEngine with its
rounds and drafted and accepted counts, and the target-greedy chains of its
plain engines, which JAX's own tests hold its speculative engines to), and
every emitted token is target-greedy under the port's cache-free forward.
Sampled tokens cannot equal JAX's (the generators differ), so the
Leviathan rule is held by its closed-form identity, exact, and by the
distribution of its draws. The configs are JAX's
tests/test_speculative.py and tests/test_continuous.py ones, in float32 (see
tests/test_torch_continuous.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from long_context_attention_tpu import serving as jserving
from long_context_attention_tpu.models import llama as jllama
from long_context_attention_tpu.serving import speculative as jspec
from long_context_attention_tpu_torch import serving as tserving
from long_context_attention_tpu_torch.models import llama as tllama
from long_context_attention_tpu_torch.serving import speculative as tspec
from long_context_attention_tpu_torch.utils.convert import params_from_jax

torch.set_num_threads(1)

# tests/test_speculative.py:20-23
SPEC = dict(vocab=64, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
            head_dim=32, ffn_hidden=128, layout="basic")
SPEC_DRAFT = dict(vocab=64, dim=32, n_layers=1, n_heads=2, n_kv_heads=1,
                  head_dim=32, ffn_hidden=64, layout="basic")
B, S_PROMPT = 2, 16
# tests/test_continuous.py and tests/test_paged.py:26
CONT = dict(vocab=96, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
            head_dim=32, ffn_hidden=128, layout="basic")
CONT_DRAFT = dict(CONT, dim=32, n_layers=1, n_heads=2, n_kv_heads=1,
                  ffn_hidden=64)
S_MAX, PAGE = 256, 128
CONT_SPECS = [(12, 7), (40, 5), (25, 9), (18, 4)]
SHARED = 140   # a shared prompt prefix longer than a page (test_paged.py)
PAGED_SPECS = [(12, 7), (40, 5), (80, 9), (18, 4)]
GENERATE = {"gamma1": dict(gamma=1), "gamma3": dict(gamma=3),
            "int8": dict(gamma=2, cache_dtype="int8")}


def _jcfg(shape):
    return jllama.ModelConfig(**shape, dtype=jnp.float32)


def _tcfg(shape):
    return tllama.ModelConfig(**shape, dtype=torch.float32)


def _tokens(seed, n, vocab):
    return [int(t) for t in np.random.default_rng(seed).integers(
        0, vocab, n)]


def _cont_requests(pkg):
    return [pkg.Request(id=i, tokens=_tokens(30 + i, n, CONT["vocab"]),
                        max_new=m) for i, (n, m) in enumerate(CONT_SPECS)]


def _paged_requests(pkg):
    shared = _tokens(90, SHARED, CONT["vocab"])
    return [pkg.Request(id=i, tokens=shared + _tokens(50 + i, n,
                                                      CONT["vocab"]),
                        max_new=m) for i, (n, m) in enumerate(PAGED_SPECS)]


def _ported(p):
    return params_from_jax(jax.tree.map(np.asarray, p), device="cpu")


def _results(res):
    return {i: r.tokens for i, r in res.items()}


@pytest.fixture(scope="module")
def setup():
    """The JAX side, once: SpeculativeEngine.generate at gamma 3 (tokens
    and counts); the target's greedy chain from Engine.generate over a bf16
    and an int8 cache (the chain every greedy speculative run must emit,
    whatever its draft or gamma); the plain continuous engine's tokens
    (with and without EOS, and on the paged requests); and the port's
    params of the same weights."""
    out = {}
    sp = jllama.init_params(jax.random.PRNGKey(0), _jcfg(SPEC))
    sdp = jllama.init_params(jax.random.PRNGKey(9), _jcfg(SPEC_DRAFT))
    prompt = np.array(jax.random.randint(
        jax.random.PRNGKey(1), (B, S_PROMPT), 0, SPEC["vocab"], jnp.int32))
    out["gamma3"] = jserving.SpeculativeEngine(
        _jcfg(SPEC), _jcfg(SPEC_DRAFT), s_max=96, gamma=3).generate(
        sp, sdp, jnp.asarray(prompt), 10)
    for dtype in ("bfloat16", "int8"):
        out[f"chain {dtype}"] = np.asarray(jserving.Engine(
            _jcfg(SPEC), s_max=96, cache_dtype=dtype).generate(
            sp, jnp.asarray(prompt), 20).tokens)
    cp = jllama.init_params(jax.random.PRNGKey(0), _jcfg(CONT))
    reqs = _cont_requests(jserving)
    out["plain"] = _results(jserving.ContinuousEngine(
        _jcfg(CONT), s_max=S_MAX, max_batch=2).serve(cp, reqs))
    eos = out["plain"][0][3]
    out["eos"] = (eos, _results(jserving.ContinuousEngine(
        _jcfg(CONT), s_max=S_MAX, max_batch=1).serve(cp, reqs[:2],
                                                     eos_id=eos)))
    out["paged"] = _results(jserving.ContinuousEngine(
        _jcfg(CONT), s_max=2 * S_MAX, max_batch=2).serve(
        cp, _paged_requests(jserving)))
    cdp = jllama.init_params(jax.random.PRNGKey(9), _jcfg(CONT_DRAFT))
    return {"jax": out, "prompt": prompt,
            "spec": (_ported(sp), _ported(sdp)),
            "cont": (_ported(cp), _ported(cdp))}


def _forward_logits(params, cfg, seq):
    with torch.no_grad():
        return tllama.forward_local(params, torch.as_tensor(seq), cfg)


def _assert_target_greedy(params, cfg, prompt, toks, tol=0.06):
    """Every emitted token is greedy-optimal under the port's cache-free
    forward, up to a tie tolerance (two valid attention orders may flip
    exact near-ties; anything past tol is a fault)."""
    seq = np.concatenate([prompt, toks], axis=1)
    logits = _forward_logits(params, cfg, seq)[:, prompt.shape[1] - 1:-1]
    gap = logits.max(-1).values - torch.gather(
        logits, -1, torch.as_tensor(toks, dtype=torch.long)[..., None])[..., 0]
    assert float(gap.max()) <= tol, gap


@pytest.mark.parametrize("name", list(GENERATE))
def test_speculative_generate_matches_jax(setup, name):
    """With any draft and gamma, the tokens are JAX's target-greedy chain
    (at gamma 3 also JAX's SpeculativeEngine's, with the same rounds and
    drafted and accepted counts), and target-greedy under the port's
    forward."""
    params, dparams = setup["spec"]
    kw = GENERATE[name]
    eng = tserving.SpeculativeEngine(_tcfg(SPEC), _tcfg(SPEC_DRAFT),
                                     s_max=96, device="cpu", **kw)
    max_new = 20 if name == "int8" else 10
    res = eng.generate(params, dparams, torch.as_tensor(setup["prompt"]),
                       max_new)
    assert res.tokens.shape == (B, max_new)
    chain = setup["jax"][f"chain {kw.get('cache_dtype', 'bfloat16')}"]
    np.testing.assert_array_equal(res.tokens, chain[:, :max_new])
    if name in setup["jax"]:
        want = setup["jax"][name]
        np.testing.assert_array_equal(res.tokens, np.asarray(want.tokens))
        assert (res.rounds, res.drafted, res.accepted) == (
            want.rounds, want.drafted, want.accepted)
    assert 0 <= res.accepted <= res.drafted
    assert res.drafted == B * kw["gamma"] * res.rounds
    _assert_target_greedy(params, _tcfg(SPEC), setup["prompt"], res.tokens,
                          tol=0.6 if name == "int8" else 0.06)


def test_self_draft_accepts_heavily(setup):
    """Draft = target: the draft proposes the target's own chain, most
    drafts are accepted, and each round emits at least one token a row."""
    params, _ = setup["spec"]
    eng = tserving.SpeculativeEngine(_tcfg(SPEC), _tcfg(SPEC), s_max=96,
                                     gamma=4, device="cpu")
    res = eng.generate(params, params, torch.as_tensor(setup["prompt"]), 8)
    np.testing.assert_array_equal(res.tokens,
                                  setup["jax"]["chain bfloat16"][:, :8])
    assert res.accepted / res.drafted >= 0.4, (res.accepted, res.drafted)
    assert res.rounds <= 8
    _assert_target_greedy(params, _tcfg(SPEC), setup["prompt"], res.tokens)


def test_int8_weights_keep_the_target_chain(setup):
    """weight_dtype="int8": the rounds run on w8a8 weights; the tokens
    equal the int8-weight target's own greedy chain (the port's Engine with
    the same decode weights)."""
    params, dparams = setup["spec"]
    prompt = torch.as_tensor(setup["prompt"])
    res = tserving.SpeculativeEngine(
        _tcfg(SPEC), _tcfg(SPEC_DRAFT), s_max=96, gamma=3,
        weight_dtype="int8", device="cpu").generate(params, dparams, prompt,
                                                    10)
    plain = tserving.Engine(_tcfg(SPEC), s_max=96, weight_dtype="int8",
                            device="cpu").generate(params, prompt, 10)
    np.testing.assert_array_equal(res.tokens, plain.tokens.numpy())


def test_acceptance_math_is_exact():
    """The Leviathan identity q * min(1, p/q) + P(reject) * residual = p
    for arbitrary p and q, in closed form, and the residual equals JAX's."""
    rng = np.random.default_rng(0)
    for _ in range(5):
        p = rng.random(97)
        p /= p.sum()
        q = rng.random(97)
        q /= q.sum()
        pt, qt = torch.as_tensor(p), torch.as_tensor(q)
        accept_mass = torch.minimum(pt, qt)
        out = accept_mass + (1.0 - accept_mass.sum()) \
            * tspec.speculative_residual(pt, qt)
        np.testing.assert_allclose(out.numpy(), p, atol=1e-12, rtol=0)
        np.testing.assert_allclose(
            tspec.speculative_residual(pt.float(), qt.float()).numpy(),
            np.asarray(jspec.speculative_residual(jnp.asarray(p, jnp.float32),
                                                  jnp.asarray(q,
                                                              jnp.float32))),
            atol=1e-7, rtol=0)
    r = tspec.speculative_residual(pt, pt)
    assert torch.equal(r, pt) and abs(float(r.sum()) - 1.0) < 1e-12


def test_leviathan_draws_follow_the_target():
    """Drafts drawn from q and passed through leviathan_accept emit tokens
    distributed as p: the first emitted token (the draft if accepted, else
    the fallback) over 40000 rows, each frequency within 0.012 of p (about
    5 standard errors), where q alone is far from p."""
    gen = torch.Generator().manual_seed(3)
    vocab, rows = 6, 40000
    logits_p = torch.tensor([2.0, 0.5, -1.0, 1.0, 0.0, -0.5])
    q = torch.softmax(torch.tensor([-1.0, 1.5, 0.5, 0.0, 1.0, -2.0]), -1)
    sampling = tserving.SamplingParams(temperature=1.0)
    p = torch.softmax(logits_p, -1)
    logits = logits_p.expand(rows, 2, vocab)
    drafts = torch.multinomial(q.expand(rows, vocab), 1, replacement=True,
                               generator=gen)
    accept, fallback = tspec.leviathan_accept(
        logits, drafts, q.expand(rows, 1, vocab), sampling, gen)
    first = torch.where(accept[:, 0], drafts[:, 0].int(), fallback[:, 0])
    freq = torch.bincount(first.long(), minlength=vocab).double() / rows
    assert float((freq - p.double()).abs().max()) < 0.012, (freq, p)
    assert float((q - p).abs().max()) > 0.2
    # the bonus position draws from p_gamma itself
    bonus = torch.bincount(fallback[:, 1].long(), minlength=vocab) / rows
    assert float((bonus.double() - p.double()).abs().max()) < 0.012


def test_sampled_runs_and_self_draft_accepts(setup):
    """temperature > 0: the Leviathan path gives the right shapes and ids;
    with draft = target (p = q) the ratio test accepts nearly always."""
    params, dparams = setup["spec"]
    prompt = torch.as_tensor(setup["prompt"])
    sp = tserving.SamplingParams(temperature=0.8, top_k=16)
    res = tserving.SpeculativeEngine(
        _tcfg(SPEC), _tcfg(SPEC_DRAFT), s_max=96, gamma=2,
        device="cpu").generate(params, dparams, prompt, 8, sampling=sp,
                               generator=torch.Generator().manual_seed(3))
    assert res.tokens.shape == (B, 8)
    assert res.tokens.min() >= 0 and res.tokens.max() < SPEC["vocab"]
    res2 = tserving.SpeculativeEngine(
        _tcfg(SPEC), _tcfg(SPEC), s_max=96, gamma=3, device="cpu").generate(
        params, params, prompt, 8, sampling=sp,
        generator=torch.Generator().manual_seed(4))
    assert res2.accepted / res2.drafted >= 0.5, (res2.accepted, res2.drafted)


def _spec_engine(cls=tserving.SpeculativeContinuousEngine, **kw):
    args = dict(s_max=S_MAX, max_batch=2, draft_cfg=_tcfg(CONT_DRAFT),
                gamma=3, device="cpu")
    args.update(kw)
    return cls(_tcfg(CONT), **args)


def test_speculative_continuous_matches_jax(setup):
    """Speculative rounds in the continuous scheduler: the tokens equal
    JAX's plain continuous engine's (which JAX's tests hold its speculative
    one to), through queueing and different budgets; the round counts add
    up."""
    params, dparams = setup["cont"]
    eng = _spec_engine()
    got = _results(eng.serve(params, dparams, _cont_requests(tserving)))
    assert got == setup["jax"]["plain"]
    st = eng.round_stats
    assert st["rounds"] > 0 and 0 <= st["accepted"] <= st["drafted"]


def test_speculative_continuous_eos_and_self_draft(setup):
    """EOS ends a row mid-round (the freed row admits the next request);
    a self-draft accepts nearly everything and keeps the plain tokens."""
    params, dparams = setup["cont"]
    reqs = _cont_requests(tserving)[:2]
    eos, want = setup["jax"]["eos"]
    got = _spec_engine(max_batch=1, gamma=4).serve(params, dparams, reqs,
                                                   eos_id=eos)
    assert _results(got) == want
    assert any(t[-1] == eos and len(t) < r.max_new
               for r, t in zip(reqs, _results(got).values()))
    eng = _spec_engine(draft_cfg=_tcfg(CONT), gamma=4)
    got = eng.serve(params, params, reqs)
    assert _results(got) == {i: setup["jax"]["plain"][i] for i in (0, 1)}
    st = eng.round_stats
    assert st["accepted"] / st["drafted"] >= 0.75, st


def test_speculative_continuous_sampled_runs(setup):
    """Leviathan sampling in the continuous scheduler completes every
    request with its budget; each request draws from its own generator, so
    a request's tokens do not depend on the batch it shared."""
    params, dparams = setup["cont"]
    reqs = _cont_requests(tserving)[:3]
    sp = tserving.SamplingParams(temperature=0.8, top_k=20)
    out = _spec_engine().serve(params, dparams, reqs, sampling=sp, seed=5)
    assert sorted(out) == [0, 1, 2]
    assert all(len(out[r.id].tokens) == r.max_new for r in reqs)
    one = _spec_engine(max_batch=1).serve(params, dparams, reqs,
                                          sampling=sp, seed=5)
    assert _results(one) == _results(out)


def test_guards(setup, monkeypatch):
    """Logprobs are refused by the speculative engines, a draft over
    another vocabulary is refused, and the paged one refuses interleaved
    admission and host overlap; requests past s_max with the gamma
    overhang raise; without a card the engines raise unless given the
    CPU."""
    with pytest.raises(ValueError, match="logprobs"):
        _spec_engine(max_batch=1, draft_cfg=_tcfg(CONT),
                     return_logprobs=True)
    with pytest.raises(ValueError, match="vocabularies"):
        _spec_engine(draft_cfg=_tcfg(SPEC_DRAFT))
    for kw in (dict(interleave_admission=True), dict(host_overlap=True)):
        with pytest.raises(ValueError, match="compose"):
            _spec_engine(tserving.PagedSpeculativeContinuousEngine,
                         page_size=PAGE, pool_pages=9, **kw)
    params, dparams = setup["cont"]
    with pytest.raises(ValueError, match="gamma"):
        _spec_engine().serve(params, dparams, [tserving.Request(
            id=0, tokens=[1] * 250, max_new=4)])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tserving.SpeculativeEngine(_tcfg(SPEC), _tcfg(SPEC_DRAFT), s_max=96)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _spec_engine(device=None)


@pytest.mark.parametrize("prefix", [False, True])
def test_paged_speculative_matches_jax(setup, prefix):
    """Paged pool x speculative rounds x continuous batching emits JAX's
    target-greedy tokens through queueing, page reuse, rollback past page
    boundaries and prefix sharing; the allocator is the native core."""
    params, _ = setup["cont"]
    dcfg = dataclasses.replace(_tcfg(CONT), n_layers=1)
    dparams = tllama.init_params(torch.Generator().manual_seed(7), dcfg,
                                 device="cpu")
    eng = _spec_engine(tserving.PagedSpeculativeContinuousEngine,
                       s_max=2 * S_MAX, draft_cfg=dcfg, page_size=PAGE,
                       pool_pages=9, prefix_cache=prefix)
    assert not eng._windowed_paging
    got = eng.serve(params, dparams, _paged_requests(tserving))
    assert _results(got) == setup["jax"]["paged"]
    assert eng.last_alloc_kind == "native"
    if prefix:
        assert eng.stats["prefix_hit_tokens"] > 0


def test_paged_speculative_capacity_guard(setup):
    """A request whose pages, with the verify's gamma + 1 overhang, exceed
    the pool raises before serving."""
    params, dparams = setup["cont"]
    eng = _spec_engine(tserving.PagedSpeculativeContinuousEngine,
                       page_size=PAGE, pool_pages=3)
    req = tserving.Request(id=0, tokens=[1] * 100, max_new=153)
    assert eng._pages_needed(req) == 3   # 100 + 153 + gamma + 1 > 256
    with pytest.raises(ValueError, match="pages"):
        eng.serve(params, dparams, [req])
