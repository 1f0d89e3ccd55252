"""ddp_tpu_torch.serve ≡ the JAX package's serving engine, on the CPU.

- The scheduler copy plans chunks exactly as the JAX scheduler does.
- The port's ``ServeEngine`` (device="cpu") serves greedy streams
  token-identical to ``ddp_tpu.serve.engine.ServeEngine(decode_attn=
  "reference")`` on the same numpy-made weights, for fp32 and int8 KV,
  MHA and GQA, across prefill-bucket edges, staggered admission (mixed
  per-lane positions) and a tail chunk near total_len. Every stream
  checks that its top-2 logit gap exceeds 1e-4 at each emitted token,
  so a near tie cannot make the identity flaky.
- ``LMServer`` answers POST /generate (200), a malformed body (400) and
  a full queue (429 queue_full).
"""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from ddp_tpu.serve.engine import ServeEngine as JEngine
from ddp_tpu.serve.scheduler import Scheduler as JScheduler
from ddp_tpu_torch.ops import decode as tdec
from ddp_tpu_torch.serve.engine import COMPLETE, ServeEngine
from ddp_tpu_torch.serve.scheduler import QUEUE_FULL, Scheduler
from ddp_tpu_torch.serve.server import LMServer
from test_torch_generate import VOCAB, make_pair

MIN_GAP = 1e-4  # top-2 logit gap every compared greedy token must clear


def test_scheduler_plans_like_jax():
    """bucket_list / chunk_width / plan_chunks over a sweep of configs,
    positions, budgets and prefill queues."""
    rng = np.random.default_rng(0)
    for prefill_len, total_len, chunk, min_bucket, budget in [
        (16, 32, 8, 4, 12), (36, 38, 16, 2, 0), (64, 128, 16, 4, 24),
        (17, 19, 8, 2, 10), (128, 256, 64, 8, 72),
    ]:
        kw = dict(max_queue=8, prefill_len=prefill_len, total_len=total_len,
                  chunk=chunk, min_bucket=min_bucket, token_budget=budget)
        ours, theirs = Scheduler(**kw), JScheduler(**kw)
        assert ours.bucket_list() == theirs.bucket_list()
        for start in range(0, prefill_len):
            for remaining in (1, 2, 3, 5, 8, 13, prefill_len - start):
                for b in (None, 1, 4, 9, budget or None):
                    assert ours.chunk_width(start, remaining, b) == (
                        theirs.chunk_width(start, remaining, b)
                    )
        for _ in range(50):
            n = int(rng.integers(0, 5))
            starts = rng.integers(0, prefill_len, n)
            prefilling = [
                (i, int(s), int(rng.integers(1, prefill_len - s + 1)))
                for i, s in enumerate(starts)
            ]
            decoding = int(rng.integers(0, 6))
            assert ours.plan_chunks(prefilling, decoding) == (
                theirs.plan_chunks(prefilling, decoding)
            )


def _assert_gaps(model, prompt, tokens):
    """Top-2 gap of the port's dense logits at every emitted token."""
    seq = torch.tensor([prompt + tokens[:-1]])
    with torch.no_grad():
        logits = model(seq)[0, len(prompt) - 1:]
    top2 = torch.topk(logits, 2, dim=-1).values
    gaps = (top2[:, 0] - top2[:, 1]).numpy()
    assert gaps.min() > MIN_GAP, f"near tie along the stream: {gaps.min()}"


def _serve_both(kv_heads, kv_dtype, prompts, n_new, *, total_len=64, **knobs):
    jspec, jparams, model = make_pair(kv_heads, total_len=total_len)
    jeng = JEngine(jspec, jparams, decode_attn="reference",
                   kv_dtype=kv_dtype, **knobs)
    teng = ServeEngine(model, kv_dtype=kv_dtype, **knobs)
    assert teng.buckets == jeng.buckets
    assert teng.decode_attn == "reference"  # auto on the CPU
    streams = []
    for eng in (jeng, teng):
        rids = []
        for p in prompts:
            rids.append(eng.submit(p, n_new).request.rid)
            eng.step()  # staggered admission: mixed-age batch
        eng.run()
        results = [eng.result(r) for r in rids]
        assert all(c.status == COMPLETE for c in results)
        streams.append([c.tokens for c in results])
    return model, streams


@pytest.mark.parametrize("kv_dtype", ["fp32", "int8"])
@pytest.mark.parametrize("kv_heads", [0, 2], ids=["mha", "gqa"])
def test_greedy_streams_match_jax_engine(kv_heads, kv_dtype):
    """Prompt lengths around the 4-edge, the 8-edge and the chunk
    boundary (buckets {4, 8}, chunk 8, prompts up to 2×chunk)."""
    prompts = [
        [(7 * n + i) % VOCAB for i in range(n)]
        for n in (1, 3, 4, 5, 8, 9, 15, 16)
    ]
    before = dict(tdec.flash_decode_attention.launches)
    model, (jax_streams, port_streams) = _serve_both(
        kv_heads, kv_dtype, prompts, 6,
        slots=2, prefill_len=16, prefill_chunk=8, min_bucket=4,
    )
    assert port_streams == jax_streams
    assert all(len(s) == 6 for s in port_streams)
    for p, s in zip(prompts, port_streams):
        _assert_gaps(model, p, s)
    assert tdec.flash_decode_attention.launches == before  # plain on CPU


def test_tail_chunk_near_unaligned_total_len_matches_jax():
    """Prompt 17 in a 19-long cache: the tail chunk at start 16 must take
    width 2, not a min_bucket that would cross 19 (a clamped write would
    shift over live lines)."""
    prompt = [(3 * i + 1) % VOCAB for i in range(17)]
    model, (jax_streams, port_streams) = _serve_both(
        0, "fp32", [prompt], 2, total_len=19,
        slots=1, prefill_len=17, prefill_chunk=8, min_bucket=8,
    )
    assert port_streams == jax_streams
    _assert_gaps(model, prompt, port_streams[0])


def test_engine_chunk_calls_self_attend_only_the_first_chunk(monkeypatch):
    """A 21-token prompt at chunk 8 / min_bucket 4 is ingested as chunks
    (start, live, width) (0, 8, 8), (8, 8, 8), (16, 5, 8); only the
    first self-attends (lane_attend=False), as the JAX engine's
    first-chunk program does. At this model size int8 streams do not
    show the difference, so the call itself is pinned."""
    import ddp_tpu_torch.serve.engine as engine_mod

    calls = []
    real = engine_mod.prefill_chunk

    def spy(model, cache, *state_and_args, lane_attend):
        slot, chunk, start, live, final = state_and_args[5:10]
        calls.append((start, live, chunk.shape[0], final, lane_attend))
        return real(model, cache, *state_and_args, lane_attend=lane_attend)

    monkeypatch.setattr(engine_mod, "prefill_chunk", spy)
    _, _, model = make_pair(0)
    eng = ServeEngine(model, slots=2, prefill_len=24, prefill_chunk=8,
                      min_bucket=4, kv_dtype="int8")
    eng.submit(list(range(21)), 3)
    eng.run()
    assert calls == [(0, 8, 8, False, False), (8, 8, 8, False, True),
                     (16, 5, 8, True, True)]


def test_engine_validation_and_stats():
    _, _, model = make_pair(0)
    with pytest.raises(ValueError, match="step_token_budget"):
        ServeEngine(model, slots=4, prefill_len=8, min_bucket=8,
                    step_token_budget=4)
    with pytest.raises(ValueError, match="kv_dtype"):
        ServeEngine(model, kv_dtype="fp8")
    fp32 = ServeEngine(model, slots=2, prefill_len=8)
    int8 = ServeEngine(model, slots=2, prefill_len=8, kv_dtype="int8")
    # int8 rows + one fp32 scale per head row: (1 + 4/Dh)/4 of fp32.
    assert int8.cache_bytes_per_slot() == fp32.cache_bytes_per_slot() * 3 // 8
    fp32.submit([1, 2, 3], 4, temperature=0.7, top_p=0.9, seed=-3)
    fp32.run()
    s = fp32.stats()
    assert s["decode_steps"] == 3 and s["tokens_total"] == 4
    assert s["requests_by_status"] == {COMPLETE: 1}
    assert s["decode_path"] == {"attn_impl": "reference", "kv_dtype": "fp32",
                                "cache_bytes_per_slot": 2 * 2 * 64 * 4 * 8 * 4}


def _post(url, body: bytes):
    req = urllib.request.Request(url + "/generate", data=body, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def test_http_generate_malformed_and_queue_full():
    _, _, model = make_pair(2)
    eng = ServeEngine(model, slots=2, prefill_len=8)
    with LMServer(eng) as srv:
        body = {"prompt_tokens": [3, 1, 4], "max_new_tokens": 5}
        status, out, _ = _post(srv.url, json.dumps(body).encode())
        assert status == 200 and out["status"] == COMPLETE
        assert len(out["tokens"]) == 5 and out["prompt_tokens"] == [3, 1, 4]
        assert set(out) == {"rid", "status", "prompt_tokens", "tokens",
                            "ttft_s", "decode_tokens_per_s"}
        status, out, _ = _post(srv.url, b"{not json")
        assert status == 400 and "bad JSON" in out["error"]
        status, out, _ = _post(srv.url, b'{"prompt_tokens": [1]}')
        assert status == 400
        status, out, _ = _post(
            srv.url, json.dumps({"prompt_tokens": list(range(9)),
                                 "max_new_tokens": 2}).encode())
        assert (status, out) == (400, {"error": "prompt_too_long"})
        with urllib.request.urlopen(srv.url + "/healthz", timeout=10) as r:
            health = json.loads(r.read())
        assert health["ok"] and health["slots"] == 2
        with urllib.request.urlopen(srv.url + "/stats", timeout=10) as r:
            assert json.loads(r.read())["completed"] == 0  # popped
    full = ServeEngine(model, slots=1, prefill_len=8, max_queue=0)
    with LMServer(full) as srv:
        status, out, headers = _post(
            srv.url, json.dumps({"prompt_tokens": [1], "max_new_tokens": 2})
            .encode())
        assert status == 429 and out["error"] == QUEUE_FULL
        assert int(headers["Retry-After"]) >= 1


@pytest.mark.parametrize(
    "d_model,heads,kv_dtype,want",
    [
        (256, 2, "fp32", "flash"),      # Dh 128: the kernel's shape
        (256, 2, "int8", "flash"),
        (96, 4, "fp32", "flash"),       # Dh 24: whole float4 rows
        (96, 4, "int8", "reference"),   # Dh 24: not whole int8 vectors
        (640, 2, "fp32", "reference"),  # Dh 320 > 256
    ],
)
def test_engine_resolves_decode_attention_by_shape(d_model, heads, kv_dtype,
                                                   want):
    """On a CUDA device the engine's ``auto`` decode attention resolves to
    the kernel only where ``ops/decode.kernel_takes`` the model's head
    shape and cache dtype, else to the plain version (reported as
    ``decode_attn``, the path /stats shows); the request itself is kept,
    so each call routes, and is counted, in ``decode_attention``. An
    explicit ``flash`` on a shape the kernel does not take raises."""
    from ddp_tpu_torch.models.lm import LMSpec
    from ddp_tpu_torch.serve.engine import resolve_engine_knobs

    spec = LMSpec(vocab_size=64, total_len=32, d_model=d_model, depth=1,
                  num_heads=heads)
    cuda = torch.device("cuda")
    knobs = resolve_engine_knobs(spec, device=cuda, kv_dtype=kv_dtype)
    assert knobs["decode_attn"] == want
    assert knobs["decode_attn_requested"] == "auto"
    cpu = resolve_engine_knobs(spec, device=torch.device("cpu"),
                               kv_dtype=kv_dtype)
    assert cpu["decode_attn"] == "reference"
    if want == "reference":
        with pytest.raises(ValueError, match="does not take"):
            resolve_engine_knobs(spec, device=cuda, kv_dtype=kv_dtype,
                                 decode_attn="flash")
