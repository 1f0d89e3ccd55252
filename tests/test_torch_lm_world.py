"""The causal-LM trainer data-parallel at world 2 ≡ world 1, on the CPU.

A world of 2 runs in-process (``runtime/dist.ThreadWorld``: one thread a
rank, each with its replica, the gradient bucket summed over both) on
``train/fast.make_lm_epoch_runner``'s strided shards, against world 1 on
the same global batch and plan: per-step loss, accuracy and grad norm,
the parameters after two epochs, with strided gradient accumulation too.
A bucket divided by the world twice must fail the same check. Then
``python -m ddp_tpu_torch.train --model causal_lm --spawn 2 --device
cpu`` (two gloo processes) against the world-1 command: the same
checkpointed parameters and test metrics, one ``lm_spec.json`` and
``tokenizer.json`` written by rank 0.

Tolerances (tests/test_torch_ddp.py's): metrics rtol 1e-5, parameters
atol 2e-5 — the two worlds sum in different orders.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ddp_tpu_torch.models.lm import CausalLM, LMSpec, init_lm_state
from ddp_tpu_torch.runtime import dist as tdist
from ddp_tpu_torch.train import fast as tfast
from ddp_tpu_torch.train.optim import make_optimizer
from ddp_tpu_torch.train.trainer import main as train_main

RTOL, ATOL = 1e-5, 2e-5
REPO = Path(__file__).resolve().parent.parent
SPEC = LMSpec(vocab_size=32, total_len=16, d_model=32, depth=2, num_heads=2)
N, GLOBAL = 40, 8  # 40 sequences: 5 global batches of 8 an epoch


def _tokens():
    rng = np.random.default_rng(3)
    return torch.from_numpy(rng.integers(0, SPEC.vocab_size,
                                         (N, SPEC.total_len)).astype(np.int64))


def _run(opt_kw, *, rank=0, world=1, reduce=None, accum=1, epochs=2):
    """Epochs of the LM runner from the seeded weights → (model, the
    per-step [loss, accuracy, grad norm] rows)."""
    model = CausalLM.from_state(SPEC, init_lm_state(SPEC, seed=0), "cpu",
                                trainable=True)
    opt = make_optimizer(model.parameters(), **opt_kw)
    run = tfast.make_lm_epoch_runner(
        model, opt, _tokens(), GLOBAL, seed=0, grad_accum_steps=accum,
        rank=rank, world=world,
        **({} if reduce is None else {"reduce": reduce}))
    rows = []
    for epoch in range(epochs):
        m = run(epoch)
        rows += torch.stack([m.loss, m.accuracy, m.grad_norm], 1).tolist()
    return model, rows


def _world2(opt_kw, *, extra_div=1, accum=1):
    tw = tdist.ThreadWorld(2)

    def body(rank):
        inner = tw.reduce(rank)
        return _run(opt_kw, rank=rank, world=2, accum=accum,
                    reduce=lambda t: inner(t).div_(extra_div))

    return tw.run(body)


def _max_param_diff(a, b):
    return max(float((p - q).detach().abs().max())
               for p, q in zip(a.parameters(), b.parameters()))


@pytest.mark.parametrize("opt_kw,accum", [
    (dict(name="sgd", lr=0.5, momentum=0.9), 1),
    (dict(name="sgd", lr=0.5, grad_clip_norm=0.05), 1),
    (dict(name="sgd", lr=0.5), 2),
], ids=["sgd-momentum", "sgd-clip", "sgd-accum2"])
def test_world_2_equals_world_1_on_the_same_global_batch(opt_kw, accum):
    """Each rank takes rows r::2 of every global batch; one all-reduce a
    step averages the ranks: metrics and parameters equal world 1's,
    and the two replicas stay bit for bit equal. (SGD: Adam would move
    the K bias, whose gradient is 0 in exact arithmetic, by lr-sized
    steps of noise; test_torch_train.py pins Adam's step itself.)"""
    want_model, want_rows = _run(opt_kw, accum=accum)
    (m0, rows0), (m1, _) = _world2(opt_kw, accum=accum)
    assert len(rows0) == len(want_rows) == 2 * N // GLOBAL
    np.testing.assert_allclose(np.array(rows0), np.array(want_rows),
                               rtol=RTOL)
    assert _max_param_diff(m0, want_model) <= ATOL
    assert _max_param_diff(m0, m1) == 0.0


def test_world_2_average_divided_twice_fails():
    """The negative control: a bucket divided by the world once more (the
    mistake phase 11f also plants on the card) moves the parameters
    outside the limit."""
    opt_kw = dict(name="sgd", lr=0.5)
    want_model, _ = _run(opt_kw)
    (m0, _), _ = _world2(opt_kw, extra_div=2)
    assert _max_param_diff(m0, want_model) > ATOL


def test_rank_rows_are_the_samplers_strided_shards(monkeypatch):
    """41 sequences over 2 ranks at a global batch of 6: rank r's rows in
    each step are ``data/sampler.ShardSampler``'s (the plan padded by
    wrapping, shard r the stride r::2), 7 steps on both ranks."""
    from ddp_tpu_torch.data.sampler import ShardSampler, default_permutation
    from ddp_tpu_torch.parallel.ddp import StepMetrics

    tokens = torch.arange(41)[:, None].repeat(1, 4)
    model = CausalLM.from_state(SPEC, init_lm_state(SPEC), "cpu",
                                trainable=True)
    for rank in (0, 1):
        seen = []

        def record(*args, **kw):
            def step(toks):
                seen.append(toks[:, 0].tolist())
                zero = torch.zeros(())
                return StepMetrics(zero, zero, zero)
            return step

        monkeypatch.setattr(tfast, "make_lm_train_step", record)
        run = tfast.make_lm_epoch_runner(model, None, tokens, 6, seed=5,
                                         rank=rank, world=2)
        run(1)
        sampler = ShardSampler(41, 2, rank,
                               permutation=default_permutation(41, 5))
        want = sampler.shard_indices(1)
        assert run.steps_per_epoch == 7
        assert seen == [want[t * 3:(t + 1) * 3].tolist() for t in range(7)]


CLI = [sys.executable, "-m", "ddp_tpu_torch.train", "--device", "cpu",
       "--model", "causal_lm", "--seq_len", "16", "--model_dim", "32",
       "--num_heads", "2", "--epochs", "2", "--optimizer", "sgd", "--lr",
       "0.5", "--dataset", "text", "--vocab_size", "300"]


def test_spawn_2_on_gloo_equals_world_1(tmp_path, capsys):
    """``--spawn 2`` (per-rank batch 4) against world 1 (batch 8) on a
    BPE text corpus: the same checkpointed parameters and step count, the
    same final test metrics, the sidecars written once, by rank 0."""
    corpus = tmp_path / "c.txt"
    rng = np.random.default_rng(0)
    words = ["alpha", "beta", "gamma", "delta", "aaaa", "kernel", "step"]
    corpus.write_text(" ".join(words[i] for i in rng.integers(0, 7, 900)))
    def argv(name, *extra):
        return CLI + ["--text_file", str(corpus), "--checkpoint_dir",
                      str(tmp_path / name), *extra]

    res = subprocess.run(argv("w2", "--batch_size", "4", "--spawn", "2"),
                         cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    out = {"w2": res.stdout}
    train_main(argv("w1", "--batch_size", "8")[3:])  # in this process
    out["w1"] = capsys.readouterr().out
    a = torch.load(tmp_path / "w1/epoch_1/state.pt", weights_only=True)
    b = torch.load(tmp_path / "w2/epoch_1/state.pt", weights_only=True)
    assert a["step"] == b["step"] > 0
    assert max(float((a["params"][k] - b["params"][k]).abs().max())
               for k in a["params"]) <= ATOL
    finals = [line for name in ("w1", "w2") for line in
              out[name].splitlines() if line.startswith("final_accuracy=")]
    assert len(finals) == 2 and finals[0] == finals[1]
    for f in ("lm_spec.json", "tokenizer.json"):
        assert ((tmp_path / "w1" / f).read_bytes()
                == (tmp_path / "w2" / f).read_bytes())
    assert json.loads((tmp_path / "w2/lm_spec.json").read_text())
    assert not list((tmp_path / "w2").glob("*.tmp"))
