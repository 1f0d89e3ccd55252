"""ddp_tpu_torch's speculative decoding ≡ the JAX package's, on the CPU.

At ``tests/test_spec_decode.py``'s size (target: vocab 37, total_len 32,
d 32, depth 2, 4 heads; draft: d 16, depth 1, 2 heads), weights made
with numpy and carried to the port by ``lm_params_from_jax``:

- ``slot_verify_step`` ≡ JAX's on the same cache state, fp32/int8 ×
  fixed-lane/paged × MHA/GQA: target tokens, matched, next tokens, pos
  and steps exact; K/V rows within 1e-5 (int8 within one quantization
  step); the verify logits within 1e-4.
- The verify contract (the twins of ``TestVerifyStep``): a full match
  advances γ, garbage drafts still emit the correct token, and a seeded
  block equals γ sequential ``slot_decode_sample_step`` draws.
- The engine: greedy streams with speculation equal the JAX spec
  engine's and the port's non-speculative engine's, across bucket edges
  and staggered admission, fixed-lane and paged (a prefix hit included);
  seeded streams equal the port's non-speculative ones; a self-draft
  accepts everything; acceptance reaches completions, ``serve_step``
  records and ``/stats``; budgets charge γ a decode lane and admission
  reserves the verify room (in pages too); construction errors match
  JAX's messages; a request's first token lands before its first verify
  round's tokens; the CLI serves with ``--spec_tokens``.
- Negative control: a verify that counts the first mismatch as a match
  must fail the stream-identity check.

Every compared greedy stream checks that its top-2 logit gap exceeds
1e-4 at each emitted token, so a near tie cannot make identity flaky.
"""

import contextlib
import copy
import functools
import io
import json
import os
import signal
import threading
import time
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddp_tpu.models import generate as jgen
from ddp_tpu.models.lm import LMSpec as JSpec
from ddp_tpu.serve.engine import ServeEngine as JEngine
from ddp_tpu_torch.interop.jax_params import flatten_tree, lm_params_from_jax
from ddp_tpu_torch.models import generate as tgen
from ddp_tpu_torch.models.lm import CausalLM, truncated_draft
from ddp_tpu_torch.serve import engine as engine_mod
from ddp_tpu_torch.serve.__main__ import main as serve_main
from ddp_tpu_torch.serve.engine import COMPLETE, ServeEngine
from ddp_tpu_torch.serve.pages import page_demand
from ddp_tpu_torch.serve.server import LMServer
from ddp_tpu_torch.utils.metrics import MetricsWriter
from test_torch_generate import (
    LOGITS_ATOL,
    _assert_cache_close,
    _random_caches,
    numpy_lm_tree,
)
from test_torch_paged import TABLE, _assert_pool_close, _jax_tree, _paged_caches
from test_torch_serve import _assert_gaps

SPEC = JSpec(vocab_size=37, total_len=32, d_model=32, depth=2, num_heads=4)
DRAFT = SPEC._replace(d_model=16, depth=1, num_heads=2)
K = 3  # γ


@functools.lru_cache(maxsize=None)
def pair(jspec: JSpec, seed: int):
    """(JAX params, port model) over the same numpy weights."""
    tree = numpy_lm_tree(jspec, seed)
    spec, state = lm_params_from_jax(tree, num_heads=jspec.num_heads)
    return _jax_tree(tree), CausalLM.from_state(spec, state, "cpu")


def target(kv_heads=0):
    jspec = SPEC._replace(num_kv_heads=kv_heads)
    return (jspec, *pair(jspec, 0))


def draft():
    return (DRAFT, *pair(DRAFT, 1))


# ---- the verify step against JAX's ----------------------------------------


def _capture(monkeypatch, module, store):
    """Record the logits each package's verify hands its block sampler."""
    real = module.sample_slot_tokens_block

    def spy(logits, *a, **kw):
        store.append(np.asarray(logits))
        return real(logits, *a, **kw)

    monkeypatch.setattr(module, "sample_slot_tokens_block", spy)


def _jverify(jspec, jparams, jc, toks, drafts, S):
    zeros = jnp.zeros(S, jnp.int32)
    return jgen.slot_verify_step(
        jspec, jparams, jc, jnp.asarray(toks), jnp.asarray(drafts),
        zeros, jnp.full(S, 5, jnp.int32), jnp.zeros(S, jnp.float32),
        jnp.ones(S, jnp.float32))


def _drafts_with_prefixes(model, tc, toks, lengths):
    """Drafts whose accepted prefix is ``lengths[s]`` tokens on lane s
    (a lane whose K positions fit below L): the verify is causal there,
    so iterating drafts ← target K times (the port's verify, on copies
    of the cache) reaches the greedy stream; lane s then gets a wrong
    token at ``lengths[s]``."""
    S = len(toks)
    drafts = torch.zeros(S, K, dtype=torch.int64)
    zeros = torch.zeros(S, dtype=torch.int64)
    for _ in range(K):
        drafts = tgen.slot_verify_step(
            model, copy.deepcopy(tc), torch.from_numpy(toks), drafts, zeros,
            zeros.clone(), torch.zeros(S), torch.ones(S), sampling=False)[1]
    for s, n in enumerate(lengths):
        if n < K:
            drafts[s, n] = (drafts[s, n] + 1) % model.spec.vocab_size
    return drafts.numpy().astype(np.int32)


@pytest.mark.parametrize("kv_heads", [0, 2], ids=["mha", "gqa"])
@pytest.mark.parametrize("layout", ["fixed", "paged"])
@pytest.mark.parametrize("kv_dtype", ["fp32", "int8"])
def test_verify_step_matches_jax(kv_dtype, layout, kv_heads, monkeypatch):
    """Mixed per-lane positions and accepted prefixes (full, none, one,
    two), an idle lane parked at the position ceiling (fixed-lane: its
    write start clamps at L-K in both packages) or on the scratch page
    (paged; the mapped lanes' rows stay inside their pages)."""
    jspec, jparams, model = target(kv_heads)
    if layout == "fixed":
        pos = [0, 5, 17, SPEC.total_len]
        jc, tc = _random_caches(jspec, kv_dtype, 4, pos)
        compared = [0, 1, 2, 3]
    else:
        pos = [5, 9, 0, SPEC.total_len]
        jc, tc = _paged_caches(jspec, kv_dtype, TABLE, pos, 13)
        compared = [0, 1, 3]  # lane 2 is idle: it reads the scratch page
    toks = np.asarray([3, 30, 7, 11], np.int32)
    lengths = [K, 0, 1, 2]
    drafts = _drafts_with_prefixes(model, tc, toks, lengths)
    jlog, tlog = [], []
    _capture(monkeypatch, jgen, jlog)
    _capture(monkeypatch, tgen, tlog)
    jnext, jc2, jsteps, jtarget, jmatched = _jverify(
        jspec, jparams, jc, toks, drafts, 4)
    steps = torch.full((4,), 5, dtype=torch.int64)
    tnext, ttarget, tmatched = tgen.slot_verify_step(
        model, tc, torch.from_numpy(toks).long(),
        torch.from_numpy(drafts).long(), torch.zeros(4, dtype=torch.int64),
        steps, torch.zeros(4), torch.ones(4), sampling=False, nucleus=False)
    np.testing.assert_allclose(tlog[0][compared], jlog[0][compared],
                               atol=LOGITS_ATOL, rtol=0)
    np.testing.assert_array_equal(ttarget.numpy()[compared],
                                  np.asarray(jtarget)[compared])
    np.testing.assert_array_equal(tmatched.numpy()[compared],
                                  np.asarray(jmatched)[compared])
    np.testing.assert_array_equal(tnext.numpy()[compared],
                                  np.asarray(jnext)[compared])
    below = [s for s in compared if pos[s] + K <= SPEC.total_len]
    assert [int(tmatched[s]) for s in below] == [lengths[s] for s in below]
    np.testing.assert_array_equal(steps.numpy(), np.asarray(jsteps))
    if layout == "fixed":
        _assert_cache_close(tc, jc2)
    else:
        _assert_pool_close(tc, jc2)
    for s in compared:  # gaps of the compared greedy tokens
        top2 = np.sort(tlog[0][s], axis=-1)[:, -2:]
        assert (top2[:, 1] - top2[:, 0]).min() > 1e-4


# ---- the verify contract (TestVerifyStep's twins) -------------------------


def _state(model, t0, temps=0.0):
    """One token fed per lane from an empty cache → (cache, next token,
    seeds, steps, temps, top_ps): the smallest real decode state."""
    S = len(t0)
    cache = tgen.init_slot_cache(model.spec, S, device="cpu")
    seeds = torch.zeros(S, dtype=torch.int64)
    steps = torch.ones(S, dtype=torch.int64)
    tv = torch.full((S,), temps)
    tp = torch.ones(S)
    toks = tgen.slot_decode_sample_step(model, cache, torch.tensor(t0),
                                        seeds, steps, tv, tp)
    return cache, toks, seeds, steps, tv, tp


def _clone(cache):
    return tgen.SlotCache(cache.k.clone(), cache.v.clone(), cache.pos.clone())


def _sequential(model, cache, toks, seeds, steps, tv, tp, n):
    """The non-speculative stream: n more tokens, one step each (on
    copies of the state)."""
    cache, steps, out = _clone(cache), steps.clone(), []
    for _ in range(n):
        toks = tgen.slot_decode_sample_step(model, cache, toks, seeds, steps,
                                            tv, tp)
        out.append(toks)
    return torch.stack(out, dim=1)


def test_full_match_advances_gamma():
    _, _, model = target()
    cache, toks, seeds, steps, tv, tp = _state(model, [5, 9])
    truth = _sequential(model, cache, toks, seeds, steps, tv, tp, K)
    pos0, steps0 = cache.pos.clone(), steps.clone()
    nxt, tgt, matched = tgen.slot_verify_step(
        model, cache, toks, truth, seeds, steps, tv, tp)
    assert matched.tolist() == [K, K]
    assert torch.equal(tgt, truth) and torch.equal(nxt, truth[:, -1])
    assert torch.equal(cache.pos, pos0 + K)
    assert torch.equal(steps, steps0 + K)


def test_garbage_drafts_still_emit_correct_token():
    """matched 0: one token, the target's own draw, one position."""
    _, _, model = target()
    cache, toks, seeds, steps, tv, tp = _state(model, [5, 9])
    truth = _sequential(model, cache, toks, seeds, steps, tv, tp, 1)
    bad = torch.cat([(truth + 1) % SPEC.vocab_size,
                     torch.zeros(2, K - 1, dtype=torch.int64)], dim=1)
    pos0 = cache.pos.clone()
    nxt, _, matched = tgen.slot_verify_step(
        model, cache, toks, bad, seeds, steps, tv, tp)
    assert matched.tolist() == [0, 0]
    assert torch.equal(nxt, truth[:, 0])
    assert torch.equal(cache.pos, pos0 + 1)


def test_seeded_block_equals_sequential_draws():
    """Seeded lanes (a negative seed too, and one with top-p): offset j
    draws at step ``steps + j``, the non-speculative counter, so the
    target block is the sequential sampled stream, bit for bit."""
    _, _, model = target()
    cache, toks, seeds, steps, tv, tp = _state(model, [5, 9], temps=0.9)
    seeds = torch.tensor([7, -3])
    tp = torch.tensor([1.0, 0.8])
    truth = _sequential(model, cache, toks, seeds, steps, tv, tp, K)
    _, tgt, matched = tgen.slot_verify_step(
        model, cache, toks, truth, seeds, steps, tv, tp)
    assert matched.tolist() == [K, K]
    assert torch.equal(tgt, truth)


def test_block_sampler_rows_equal_the_single_sampler():
    """Row (s, j) of sample_slot_tokens_block is sample_slot_tokens' draw
    for lane s at step steps[s] + j, greedy, seeded and nucleus lanes."""
    rng = np.random.default_rng(4)
    S, V = 4, 37
    logits = torch.from_numpy(rng.standard_normal((S, K, V), np.float32))
    seeds = torch.tensor([1, -2, 3, 4])
    steps = torch.tensor([0, 5, 9, 2])
    temps = torch.tensor([0.0, 0.7, 1.2, 0.9])
    top_ps = torch.tensor([1.0, 1.0, 0.6, 0.9])
    block = tgen.sample_slot_tokens_block(logits, seeds, steps, temps, top_ps)
    for j in range(K):
        want = tgen.sample_slot_tokens(logits[:, j], seeds, steps + j, temps,
                                       top_ps)
        assert torch.equal(block[:, j], want)


# ---- the engine -----------------------------------------------------------


def _spec_engine(model, draft_model, gamma=K, **kw):
    kw.setdefault("slots", 2)
    kw.setdefault("prefill_len", 8)
    return ServeEngine(model, spec_tokens=gamma, draft_model=draft_model, **kw)


def _jspec_engine(jparams, djparams, gamma=K, jspec=SPEC, **kw):
    kw.setdefault("slots", 2)
    kw.setdefault("prefill_len", 8)
    return JEngine(jspec, jparams, draft_spec=DRAFT, draft_params=djparams,
                   spec_tokens=gamma, decode_attn="reference", **kw)


def _serve(eng, cases, *, step_between=False):
    """Submit (prompt, n, sampling) cases and run to idle → streams."""
    rids = []
    for prompt, n, kw in cases:
        rids.append(eng.submit(prompt, n, **kw).request.rid)
        if step_between:
            eng.step()
    eng.run()
    done = [eng.result(r) for r in rids]
    assert all(c.status == COMPLETE for c in done)
    assert [len(c.tokens) for c in done] == [n for _, n, _ in cases]
    return [c.tokens for c in done]


EDGES = [([(7 * n + i) % SPEC.vocab_size for i in range(n)], 3 + n % 4, {})
         for n in (1, 4, 5, 8, 9, 15)]


EDGE_KNOBS = dict(prefill_len=16, prefill_chunk=8, min_bucket=4)


def test_greedy_streams_match_jax_spec_engine():
    """Bucket edges (buckets {4, 8}, chunk 8), staggered admission, mixed
    budgets; the random draft mostly misses, so partial and zero
    acceptance run too. (int8 KV against JAX: the paged twin below and
    test_torch_serve's plain engines; here against the plain engine.)"""
    _, jparams, model = target()
    _, djparams, dmodel = draft()
    got = _serve(_spec_engine(model, dmodel, **EDGE_KNOBS), EDGES,
                 step_between=True)
    want = _serve(_jspec_engine(jparams, djparams, **EDGE_KNOBS), EDGES,
                  step_between=True)
    assert got == want
    for (prompt, _, _), toks in zip(EDGES, got):
        _assert_gaps(model, prompt, toks)


@pytest.mark.parametrize("kv_dtype", ["fp32", "int8"])
def test_greedy_streams_match_the_plain_engine(kv_dtype):
    """The same traffic: the speculative streams are the port's
    non-speculative engine's, fp32 and int8 KV."""
    _, _, model = target()
    _, _, dmodel = draft()
    knobs = dict(EDGE_KNOBS, kv_dtype=kv_dtype)
    got = _serve(_spec_engine(model, dmodel, **knobs), EDGES,
                 step_between=True)
    assert got == _serve(ServeEngine(model, slots=2, **knobs), EDGES,
                         step_between=True)
    for (prompt, _, _), toks in zip(EDGES, got):
        _assert_gaps(model, prompt, toks)


SEEDED = [([3, 1, 4, 1], 6, dict(temperature=0.8, seed=7)),
          ([2, 7], 5, dict(temperature=1.3, top_p=0.9, seed=3)),
          ([5, 3, 5, 8], 4, dict(temperature=0.6, top_p=0.7, seed=-3)),
          ([9, 9, 2], 7, {})]


def test_seeded_streams_match_the_plain_engine():
    """The port's generator is not JAX's, so seeded spec streams are held
    to the port's non-speculative streams (a greedy lane rides along)."""
    _, _, model = target()
    _, _, dmodel = draft()
    got = _serve(_spec_engine(model, dmodel, slots=3), SEEDED)
    assert got == _serve(ServeEngine(model, slots=3, prefill_len=8), SEEDED)


def test_selfdraft_acceptance_is_one():
    """Draft == target (truncated_draft at full depth: the same tensors)
    → every greedy proposal accepted."""
    _, _, model = target()
    selfd = truncated_draft(model, SPEC.depth)
    assert selfd.embed is model.embed and selfd.block2 is model.block2
    eng = _spec_engine(model, selfd)
    (toks,) = _serve(eng, [([3, 1, 4], 9, {})])
    assert toks == _serve(ServeEngine(model, slots=2, prefill_len=8),
                          [([3, 1, 4], 9, {})])[0]
    assert eng.spec_acceptance_rate() == 1.0
    assert eng.spec_drafted_total == eng.spec_accepted_total > 0
    assert eng.stats()["decode_path"]["spec_acceptance_per_request"][
        "min"] == 1.0


def _records(path):
    return [json.loads(line) for line in open(path).read().splitlines()]


def _get(url, route):
    with urllib.request.urlopen(url + route, timeout=30) as r:
        return json.loads(r.read())


def _post(url, body):
    req = urllib.request.Request(url + "/generate",
                                 data=json.dumps(body).encode(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def test_acceptance_reaches_completions_records_and_stats(tmp_path):
    """serve_step records carry per-step drafted/accepted counts,
    serve_request records and completions the per-request acceptance,
    /stats the lifetime totals; a plain engine's records and stats keep
    their schema."""
    _, _, model = target()
    _, _, dmodel = draft()
    writer = MetricsWriter(str(tmp_path / "spec.jsonl"))
    eng = _spec_engine(model, dmodel, metrics=writer)
    rid = eng.submit([1, 2, 3], 6).request.rid
    eng.run()
    writer.close()
    with LMServer(eng) as srv:
        stats = _get(srv.url, "/stats")
    records = _records(tmp_path / "spec.jsonl")
    steps = [r for r in records if r["kind"] == "serve_step"]
    spec_steps = [r for r in steps if r["spec_drafted"]]
    assert spec_steps and all(0 <= r["spec_accepted"] <= r["spec_drafted"]
                              for r in spec_steps)
    assert all(r["spec_acceptance"] == round(
        r["spec_accepted"] / r["spec_drafted"], 4) for r in spec_steps)
    (req,) = [r for r in records if r["kind"] == "serve_request"]
    dp = stats["decode_path"]
    assert req["spec_acceptance"] == round(
        dp["spec_accepted_total"] / dp["spec_drafted_total"], 4)
    assert dp["spec_tokens"] == K
    assert dp["spec_drafted_total"] == sum(r["spec_drafted"] for r in steps)
    assert dp["spec_acceptance"] == eng.spec_acceptance_rate()
    assert dp["spec_acceptance_per_request"]["count"] == 1
    assert eng.result(rid).spec_acceptance == req["spec_acceptance"]

    writer = MetricsWriter(str(tmp_path / "plain.jsonl"))
    plain = ServeEngine(model, slots=2, prefill_len=8, metrics=writer)
    plain.submit([1, 2, 3], 6)
    plain.run()
    writer.close()
    records = _records(tmp_path / "plain.jsonl")
    assert not any(k.startswith("spec_") for r in records for k in r)
    assert set(plain.stats()["decode_path"]) == {
        "attn_impl", "kv_dtype", "cache_bytes_per_slot"}


def test_budget_accounts_gamma_per_decode_lane():
    """A decoding lane costs γ budget tokens: the default budget is
    chunk + slots·γ, and a budget that cannot fit the smallest bucket
    beside γ-wide verify rounds is refused with JAX's message."""
    jspec, jparams, model = target()
    _, djparams, dmodel = draft()
    eng = _spec_engine(model, dmodel)
    assert eng.step_token_budget == eng.prefill_chunk + 2 * K
    knobs = dict(min_bucket=8, step_token_budget=9)
    with pytest.raises(ValueError, match="step_token_budget") as ours:
        _spec_engine(model, dmodel, **knobs)
    with pytest.raises(ValueError) as theirs:
        _jspec_engine(jparams, djparams, **knobs)
    assert str(ours.value) == str(theirs.value)
    plan = eng.scheduler.plan_chunks([(0, 0, 16)], 2 * K)
    assert plan and plan[0][1] <= eng.step_token_budget - 2 * K


def test_admission_reserves_verify_room():
    """The context ceiling shrinks by γ-1: total_len 32 at γ 4 admits an
    8-token prompt with at most 21 new tokens."""
    _, _, model = target()
    _, _, dmodel = draft()
    eng = _spec_engine(model, dmodel, gamma=4)
    assert eng.submit([1] * 8, 21).accepted
    adm = eng.submit([1] * 8, 22)
    assert not adm.accepted and adm.reason == "budget_exceeds_context"


def test_construction_errors_match_jax():
    """Mismatched vocab or total_len, γ too large and a missing draft
    raise (the first three with JAX's very messages); so does a draft on
    another device, and an explicit kernel path on a CPU engine stays
    plain only because the tensors are on the CPU."""
    jspec, jparams, model = target()
    _, djparams, dmodel = draft()
    for dspec in (DRAFT._replace(vocab_size=99), DRAFT._replace(total_len=64)):
        other = CausalLM.from_state(
            *lm_params_from_jax(numpy_lm_tree(dspec, 1), num_heads=2), "cpu")
        with pytest.raises(ValueError) as ours:
            ServeEngine(model, spec_tokens=2, draft_model=other)
        with pytest.raises(ValueError) as theirs:
            JEngine(jspec, jparams, spec_tokens=2, draft_spec=dspec,
                    draft_params=djparams)
        assert str(ours.value) == str(theirs.value)
    with pytest.raises(ValueError) as ours:
        ServeEngine(model, prefill_len=8, spec_tokens=24, draft_model=dmodel)
    with pytest.raises(ValueError) as theirs:
        JEngine(jspec, jparams, prefill_len=8, spec_tokens=24,
                draft_spec=DRAFT, draft_params=djparams)
    assert str(ours.value) == str(theirs.value)
    with pytest.raises(ValueError, match="needs a draft_model"):
        ServeEngine(model, spec_tokens=2)
    with pytest.raises(ValueError, match="spec_tokens must be >= 1"):
        ServeEngine(model, spec_tokens=-1, draft_model=dmodel)
    # A fresh draft: .to() moves parameters in place, and a truncated
    # draft's are the target's.
    elsewhere = CausalLM.from_state(
        *lm_params_from_jax(numpy_lm_tree(DRAFT, 1), num_heads=2),
        "cpu").to("meta")
    with pytest.raises(ValueError, match="target's device"):
        ServeEngine(model, spec_tokens=2, draft_model=elsewhere)
    with pytest.raises(ValueError, match="draft depth"):
        truncated_draft(model, 3)


def test_first_token_lands_before_the_same_steps_verify_tokens():
    """A request whose final chunk and first verify round fall in the
    same step: its first token (a device scalar of this step) must come
    before the round's tokens, though the round reads its tokens in the
    same step and the plain engine reads one step late."""
    _, _, model = target()
    eng = _spec_engine(model, truncated_draft(model, SPEC.depth))
    rid = eng.submit([4, 2, 7], 8).request.rid
    assert eng.step() == 1 + K  # the first token, then a full round
    slot = next(s for s in eng._slots if s.request is not None)
    plain = ServeEngine(model, slots=2, prefill_len=8)
    want = _serve(plain, [([4, 2, 7], 8, {})])[0]
    assert slot.tokens == want[:1 + K]
    eng.run()
    assert eng.result(rid).tokens == want


# ---- paged (test_paged.py's speculative twins) ----------------------------


def test_speculative_paged_identity():
    """test_paged.py:175: a paged target (fixed-lane draft), greedy and
    seeded, streams equal the port's fixed-lane non-speculative engine's
    (the greedy ones the JAX paged spec engine's too); then a prefix hit
    of 4 tokens, whose draft lane is NOT prefilled over the match (its
    first draft chunk starts at 4), keeps the stream."""
    _, jparams, model = target()
    dmodel = truncated_draft(model, 1)
    jdraft = {k: jparams[k] for k in ("embed", "pos_embed", "ln_final",
                                      "block1")}
    cases = [([1, 2, 3], 8, {}),
             ([1, 2, 3, 4], 8, dict(temperature=0.9, top_p=0.8, seed=5))]
    hit = [([1, 2, 3, 4, 9], 6, {})]
    eng = _spec_engine(model, dmodel, page_size=4)
    jeng = JEngine(SPEC, jparams, slots=2, prefill_len=8, page_size=4,
                   draft_spec=SPEC._replace(depth=1), draft_params=jdraft,
                   spec_tokens=K, decode_attn="reference")
    plain = ServeEngine(model, slots=2, prefill_len=8)
    starts = []
    real = engine_mod.prefill_chunk_device

    def spy(m, *a, **kw):
        if m is dmodel:
            starts.append(int(a[8]))  # the chunk's start
        return real(m, *a, **kw)

    got = _serve(eng, cases)
    want = _serve(plain, cases)
    assert got == want
    assert got[0] == _serve(jeng, cases[:1])[0]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(engine_mod, "prefill_chunk_device", spy)
        (toks,) = _serve(eng, hit)
    done = eng.result(max(eng._completed))
    assert done.prefix_hit_tokens == 4 and starts == [4]
    assert toks == _serve(plain, hit)[0] == _serve(jeng, hit)[0]
    for (prompt, _, _), t in zip(cases[:1] + hit, [got[0], toks]):
        _assert_gaps(model, prompt, t)
    eng._prefix.check_invariants()


def test_spec_engine_allocates_reserve_pages():
    """test_paged.py:375: a paged speculative bind maps prompt + budget +
    γ-1 in pages."""
    _, _, model = target()
    eng = _spec_engine(model, truncated_draft(model, 1), slots=1,
                       page_size=4)
    eng.submit([1, 2, 3, 4, 5], 6)
    eng.step()
    want = page_demand(5, 6, 4, total_len=SPEC.total_len, reserve=K - 1)
    assert len(eng._slots[0].pages) == want == 4
    assert want > page_demand(5, 6, 4, total_len=SPEC.total_len)
    eng.run()


# ---- the CLI --------------------------------------------------------------


def _free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _serve_main_once(argv):
    """Run the CLI's main() in this thread; a client thread posts one
    request and ends main() with SIGTERM → (printed JSON, reply)."""
    port = _free_port()
    url = f"http://127.0.0.1:{port}"
    out, errors = {}, []

    def client():
        try:
            deadline = time.monotonic() + 60
            while True:
                try:
                    _get(url, "/healthz")
                    break
                except OSError:
                    if time.monotonic() > deadline:
                        raise
                    time.sleep(0.05)
            out["reply"] = _post(url, {"prompt_tokens": [1, 2, 3],
                                       "max_new_tokens": 5})
            out["stats"] = _get(url, "/stats")
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(repr(e))
        finally:
            os.kill(os.getpid(), signal.SIGTERM)

    old = signal.getsignal(signal.SIGTERM)
    printed = io.StringIO()
    thread = threading.Thread(target=client)
    try:
        thread.start()
        with contextlib.redirect_stdout(printed):
            serve_main([*argv, "--device", "cpu", "--port", str(port)])
    finally:
        signal.signal(signal.SIGTERM, old)
        thread.join(timeout=60)
    assert not thread.is_alive() and not errors, errors
    return json.loads(printed.getvalue().strip().splitlines()[0]), out


def test_cli_serves_with_spec_tokens(tmp_path):
    """--init_demo --spec_tokens: the half-width, half-depth draft
    (scripts/serve.py's); --params_npz with --draft_params_npz: a JAX
    draft tree. Both serve on the CPU when asked."""
    line, out = _serve_main_once(["--init_demo", "--spec_tokens", "3"])
    assert line["spec_tokens"] == 3 and line["device"] == "cpu"
    assert line["draft_spec"]["d_model"] == 32
    assert line["draft_spec"]["depth"] == 1
    assert out["reply"]["status"] == COMPLETE
    assert len(out["reply"]["tokens"]) == 5
    assert out["stats"]["decode_path"]["spec_tokens"] == 3

    draft_spec = SPEC._replace(d_model=16, depth=1)  # the target's heads
    for name, spec, seed in (("t.npz", SPEC, 0), ("d.npz", draft_spec, 1)):
        np.savez(tmp_path / name, **flatten_tree(numpy_lm_tree(spec, seed)))
    line, out = _serve_main_once([
        "--params_npz", str(tmp_path / "t.npz"), "--num_heads", "4",
        "--draft_params_npz", str(tmp_path / "d.npz"), "--spec_tokens", "2"])
    assert line["draft_spec"]["d_model"] == 16 and line["spec_tokens"] == 2
    _, _, model = target()
    assert out["reply"]["tokens"] == _serve(
        ServeEngine(model, slots=4, prefill_len=16), [([1, 2, 3], 5, {})])[0]


def test_cli_spec_tokens_without_a_draft_exits(tmp_path):
    np.savez(tmp_path / "t.npz", **flatten_tree(numpy_lm_tree(SPEC, 0)))
    with pytest.raises(SystemExit, match="--spec_tokens needs"):
        serve_main(["--params_npz", str(tmp_path / "t.npz"),
                    "--spec_tokens", "2", "--device", "cpu"])


# ---- negative control -----------------------------------------------------


def test_stream_identity_rejects_a_verify_that_over_accepts(monkeypatch):
    """A verify that counts the first mismatch as a match (matched + 1)
    emits a token computed on a rejected draft: the stream-identity check
    of test_greedy_streams_match_the_plain_engine must fail on it."""
    _, _, model = target()
    _, _, dmodel = draft()
    real = engine_mod.slot_verify_step

    def over_accepts(*a, **kw):
        nxt, tgt, matched = real(*a, **kw)
        return nxt, tgt, torch.clamp(matched + 1, max=tgt.shape[1])

    plain = _serve(ServeEngine(model, slots=2, **EDGE_KNOBS), EDGES,
                   step_between=True)
    monkeypatch.setattr(engine_mod, "slot_verify_step", over_accepts)
    faulty = _serve(_spec_engine(model, dmodel, **EDGE_KNOBS), EDGES,
                    step_between=True)
    assert faulty != plain
