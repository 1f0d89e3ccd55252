"""``python -m ddp_tpu_torch.serve``'s scheduler flags (``--prefill_chunk
--min_bucket --step_token_budget --max_queue --decode_attn``) ≡
``scripts/serve.py``'s, on the CPU.

The flags reach the engine as the script passes them; the engine clamps
and defaults them as JAX's ``resolve_engine_knobs`` does (the same
numbers, the same refusals); ``/stats`` carries them under JAX's
``prefill`` keys; greedy streams at a non-default ``--prefill_chunk``
are JAX's token for token on the same weights; and the compile
contract of chip_smoke's flag runs (``SERVE_FLAGS``) is JAX's
``warmup()`` for the same flags (``FLAG_COMPILE_COUNTS``).
"""

import numpy as np
import pytest
import torch

import chip_smoke
from ddp_tpu.models.lm import LMSpec as JSpec
from ddp_tpu.serve.engine import ServeEngine as JEngine
from ddp_tpu.serve.engine import resolve_engine_knobs as jax_knobs
from ddp_tpu_torch.serve import __main__ as serve_cli
from ddp_tpu_torch.serve import engine as engine_mod
from ddp_tpu_torch.serve.engine import ServeEngine, resolve_engine_knobs
from test_torch_generate import make_pair
from test_torch_serve import _serve_both

KNOB_CASES = [  # slots, total_len, prefill_len, chunk, min_bucket, budget
    (4, 64, None, None, None, None), (8, 256, 128, 32, 8, 40),
    (2, 64, 16, 5, 3, None), (4, 128, 100, 200, 64, None),
    (1, 19, 17, 8, 8, 10), (4, 64, 60, 16, 16, None), (3, 64, None, 4, 1, 7),
]


@pytest.mark.parametrize("case", KNOB_CASES, ids=str)
def test_knob_clamping_equals_jax(case):
    slots, total_len, prefill_len, chunk, min_bucket, budget = case
    kw = dict(slots=slots, prefill_len=prefill_len, prefill_chunk=chunk,
              min_bucket=min_bucket, step_token_budget=budget)
    spec = JSpec(vocab_size=32, total_len=total_len, d_model=16, depth=1,
                 num_heads=2)
    want = jax_knobs(spec, **kw)
    got = resolve_engine_knobs(engine_mod.LMSpec(32, total_len, 16, 1, 2),
                               device=torch.device("cpu"), **kw)
    for k in ("prefill_len", "chunk", "min_bucket", "step_token_budget"):
        assert got[k] == want[k], k


def test_budget_refusal_equals_jax():
    spec = JSpec(vocab_size=32, total_len=64, d_model=16, depth=1,
                 num_heads=2)
    kw = dict(slots=4, prefill_len=32, prefill_chunk=16, min_bucket=8,
              step_token_budget=11)
    with pytest.raises(ValueError) as want:
        jax_knobs(spec, **kw)
    with pytest.raises(ValueError) as got:
        resolve_engine_knobs(engine_mod.LMSpec(32, 64, 16, 1, 2),
                             device=torch.device("cpu"), **kw)
    assert str(got.value) == str(want.value)


class _Stop(Exception):
    pass


def test_cli_flags_reach_the_engine(monkeypatch):
    """main() threads every flag into the engine, as scripts/serve.py
    does (``ServeEngine(..., prefill_chunk=, min_bucket=,
    step_token_budget=, max_queue=, decode_attn=)``); the defaults are
    the script's: None, None, None, 64, auto."""
    seen = []

    def fake(model, **kw):
        seen.append(kw)
        raise _Stop

    monkeypatch.setattr(engine_mod, "ServeEngine", fake)
    base = ["--init_demo", "--device", "cpu", "--vocab_size", "32",
            "--seq_len", "64", "--d_model", "16", "--depth", "1"]
    for argv, want in [
        ([], dict(prefill_chunk=None, min_bucket=None, step_token_budget=None,
                  max_queue=64, decode_attn="auto")),
        (["--prefill_chunk", "16", "--min_bucket", "4", "--step_token_budget",
          "24", "--max_queue", "2", "--decode_attn", "reference"],
         dict(prefill_chunk=16, min_bucket=4, step_token_budget=24,
              max_queue=2, decode_attn="reference")),
    ]:
        with pytest.raises(_Stop):
            serve_cli.main(base + argv)
        assert {k: seen[-1][k] for k in want} == want
    with pytest.raises(SystemExit):
        serve_cli.main(base + ["--decode_attn", "pallas"])


def test_stats_prefill_keys_equal_jax():
    jspec, jparams, model = make_pair(0, total_len=64)
    kw = dict(slots=3, prefill_len=40, prefill_chunk=16, min_bucket=4,
              step_token_budget=22, max_queue=5)
    jeng = JEngine(jspec, jparams, decode_attn="reference", **kw)
    teng = ServeEngine(model, decode_attn="reference", **kw)
    assert teng.stats()["prefill"] == jeng.stats()["prefill"]
    assert teng.stats()["decode_path"]["attn_impl"] == "reference"
    assert teng.scheduler.max_queue == jeng.scheduler.max_queue == 5
    reasons = [teng.submit([1, 2, 3], 2).reason for _ in range(7)]
    assert reasons.count("queue_full") == 2  # 429 past --max_queue


def test_greedy_streams_at_non_default_chunk_equal_jax():
    """Chunk 4 with buckets {2, 4} and a budget of 6: prompts are ingested
    in several chunks a step, co-scheduled with decode."""
    prompts = [[(5 * n + i) % 50 for i in range(n)] for n in (3, 7, 13, 16)]
    _, (jax_streams, port_streams) = _serve_both(
        0, "fp32", prompts, 5, slots=2, prefill_len=16, prefill_chunk=4,
        min_bucket=2, step_token_budget=6)
    assert port_streams == jax_streams
    assert all(len(s) == 5 for s in port_streams)


def test_flag_runs_compile_counts_equal_jax_warmup():
    """chip_smoke's phase-4 flag runs (full width there; the counts depend
    only on the buckets): JAX's warmup() for the same flags, slots and
    lengths gives FLAG_COMPILE_COUNTS, and so does the port's."""
    flags = dict(zip(chip_smoke.SERVE_FLAGS[::2], chip_smoke.SERVE_FLAGS[1::2]))
    kw = dict(slots=chip_smoke.SLOTS, prefill_len=chip_smoke.PREFILL_LEN,
              prefill_chunk=int(flags["--prefill_chunk"]),
              min_bucket=int(flags["--min_bucket"]),
              step_token_budget=int(flags["--step_token_budget"]))
    jspec, jparams, model = make_pair(
        0, total_len=chip_smoke.FULL["total_len"])
    jeng = JEngine(jspec, jparams, decode_attn="reference", **kw)
    assert jeng.warmup() == chip_smoke.FLAG_COMPILE_COUNTS
    teng = ServeEngine(model, **kw)
    assert teng.warmup() == chip_smoke.FLAG_COMPILE_COUNTS
    assert teng.buckets == jeng.buckets
    assert np.sum(list(chip_smoke.FLAG_COMPILE_COUNTS.values())) == (
        teng.compile_budget())
