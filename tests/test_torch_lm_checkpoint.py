"""The causal LM from training to serving in ddp_tpu_torch, on the CPU.

- The ``lm_spec.json`` sidecar crosses between the packages both ways
  (every field the port's spec knows, the MoE fields among them), and a
  JAX sidecar of an MoE model over dense shapes is refused, naming the
  sidecar's routing and the shapes'; a real MoE checkpoint serves.
- ``derive_spec_with_sidecar`` equals the JAX package's on the same
  shapes (MHA, GQA, no sidecar), and both raise on a head count the
  shapes refute.
- ``LMTrainer`` checkpoints every epoch: 2 epochs then ``--epochs 3``
  equals an uninterrupted 3-epoch run bit for bit (parameters, Adam's
  moments and count); a flipped byte in the latest epoch quarantines it
  and training resumes from the one before; ``--resume_epoch`` deletes
  the later epochs; ``restore_for_inference`` returns the parameters
  bit for bit.
- ``python -m ddp_tpu_torch.train --model causal_lm`` writes a
  checkpoint that ``python -m ddp_tpu_torch.serve --checkpoint_dir``
  serves; its greedy stream over HTTP equals the JAX engine's on
  ``lm_params_to_jax`` of the same checkpoint.

Sizes: vocab 64, d_model 32, depth 2, 4 heads, T 32.
"""

import json
import os
import subprocess
import sys
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch

from ddp_tpu.models.lm import LMSpec as JSpec
from ddp_tpu.serve.engine import ServeEngine as JEngine
from ddp_tpu.train import checkpoint as jck
from ddp_tpu_torch.interop.jax_params import lm_params_from_jax, lm_params_to_jax
from ddp_tpu_torch.models.lm import CausalLM, LMSpec, init_lm_state
from ddp_tpu_torch.parallel.ddp import TrainState
from ddp_tpu_torch.serve.__main__ import main as serve_main
from ddp_tpu_torch.serve.engine import ServeEngine
from ddp_tpu_torch.train import checkpoint as ck
from ddp_tpu_torch.train.config import TrainConfig
from ddp_tpu_torch.train.optim import make_optimizer
from ddp_tpu_torch.train.trainer import LMTrainer
from ddp_tpu_torch.train.trainer import main as train_main
from test_torch_generate import numpy_lm_tree

REPO = Path(__file__).resolve().parent.parent
VOCAB, T, D, DEPTH, HEADS = 64, 32, 32, 2, 4
DENSE = LMSpec._fields


def _args(ckdir, epochs, *extra):
    return ["--model", "causal_lm", "--device", "cpu", "--synthetic_size",
            "32", "--seq_len", str(T), "--vocab_size", str(VOCAB),
            "--model_dim", str(D), "--num_heads", str(HEADS), "--batch_size",
            "8", "--optimizer", "adam", "--lr", "3e-3", "--checkpoint_dir",
            str(ckdir), "--epochs", str(epochs), *extra]


def _dense(spec) -> dict:
    return {f: getattr(spec, f) for f in DENSE}


def _flip_byte(path, offset=-100):
    data = bytearray(Path(path).read_bytes())
    data[offset] ^= 0xFF
    Path(path).write_bytes(bytes(data))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_sidecar_crosses_between_packages(tmp_path, writer):
    """The port's file read by JAX's ``load_lm_spec_fields``, and JAX's
    ``save_lm_spec`` (every JAX field, MoE knobs at their dense
    defaults) read by the port: the same dense fields."""
    spec = LMSpec(vocab_size=VOCAB, total_len=T, d_model=D, depth=3,
                  num_heads=HEADS, num_kv_heads=2)
    if writer == "port":
        ck.save_lm_spec(str(tmp_path), spec)
        got = jck.load_lm_spec_fields(str(tmp_path))
        assert json.loads((tmp_path / ck.LM_SPEC_FILENAME).read_text()) \
            == _dense(spec)
    else:
        jck.save_lm_spec(str(tmp_path), JSpec(**_dense(spec)))
        got = ck.load_lm_spec_fields(str(tmp_path))
        assert set(got) == set(DENSE)
        assert got["num_experts"] == 0
    assert {f: got[f] for f in DENSE} == _dense(spec)
    assert ck.LM_SPEC_FILENAME == jck.LM_SPEC_FILENAME


def test_moe_sidecar_is_refused(tmp_path):
    """A JAX MoE sidecar over dense shapes must not serve as a dense
    model: the port raises and names the sidecar's routing and the
    shapes' (JAX, which reads MoE from the sidecar alone, derives an MoE
    spec from the same files). Beside it, a real MoE checkpoint (routed
    shapes under the same sidecar) derives and serves."""
    jspec = JSpec(vocab_size=VOCAB, total_len=T, d_model=D, depth=DEPTH,
                  num_heads=HEADS, num_experts=4)
    jck.save_lm_spec(str(tmp_path), jspec)
    tree = numpy_lm_tree(JSpec(VOCAB, T, D, DEPTH, HEADS))
    _, state = lm_params_from_jax(tree, num_heads=HEADS)
    assert jck.derive_spec_with_sidecar(
        str(tmp_path), tree, num_heads_fallback=HEADS).num_experts == 4
    with pytest.raises(ValueError, match=r"sidecar says num_experts 4.*"
                       r"routed blocks \[2\].*shapes say num_experts 0"):
        ck.derive_spec_with_sidecar(str(tmp_path), state,
                                    num_heads_fallback=HEADS)

    moe = LMSpec(vocab_size=VOCAB, total_len=T, d_model=D, depth=DEPTH,
                 num_heads=HEADS, num_experts=4)
    routed = CausalLM.from_state(moe, init_lm_state(moe, seed=1), "cpu",
                                 trainable=True)
    ck.CheckpointManager(str(tmp_path)).save(
        0, TrainState(0, routed, make_optimizer(routed.parameters(), "sgd")))
    state, _ = ck.CheckpointManager(str(tmp_path)).restore_for_inference()
    spec = ck.derive_spec_with_sidecar(str(tmp_path), state,
                                       num_heads_fallback=1)
    assert spec == moe
    served = CausalLM.from_state(spec, state, "cpu")
    eng = ServeEngine(served, slots=2, prefill_len=8)
    rid = eng.submit([1, 2, 3], 4).request.rid
    eng.run()
    assert len(eng.result(rid).tokens) == 4


@pytest.mark.parametrize("case", ["mha", "gqa", "no_sidecar", "wrong_heads"])
def test_derive_spec_with_sidecar_equals_jax(tmp_path, case):
    kv = 2 if case == "gqa" else 0
    jspec = JSpec(VOCAB, T, D, DEPTH, HEADS, num_kv_heads=kv)
    tree = numpy_lm_tree(jspec)
    _, state = lm_params_from_jax(tree, num_heads=HEADS)
    if case == "wrong_heads":
        jck.save_lm_spec(str(tmp_path), jspec._replace(num_heads=3))
    elif case != "no_sidecar":
        jck.save_lm_spec(str(tmp_path), jspec)
    fallback = HEADS if case == "no_sidecar" else 8
    if case == "wrong_heads":
        for derive, params in ((jck.derive_spec_with_sidecar, tree),
                               (ck.derive_spec_with_sidecar, state)):
            with pytest.raises(ValueError, match="num_heads 3"):
                derive(str(tmp_path), params, num_heads_fallback=fallback)
        return
    want = jck.derive_spec_with_sidecar(str(tmp_path), tree,
                                        num_heads_fallback=fallback)
    got = ck.derive_spec_with_sidecar(str(tmp_path), state,
                                      num_heads_fallback=fallback)
    assert _dense(got) == _dense(want)
    assert got.num_kv_heads == kv and got.num_heads == HEADS


def _opt_equal(a, b) -> bool:
    sa, sb = a.state_dict(), b.state_dict()
    return sa["count"] == sb["count"] and all(
        torch.equal(x, y) for k in ("mu", "nu")
        for x, y in zip(sa[k], sb[k]))


def test_resume_equals_the_uninterrupted_run(tmp_path, capsys):
    """2 epochs, then ``--epochs 3`` on the same directory, against 3
    epochs in one run: the same parameters, Adam moments and count bit
    for bit, the resumed epoch on the same data order. The sidecar and
    every epoch's manifest are written; ``restore_for_inference`` is the
    trained state bit for bit and builds no optimizer."""
    whole = train_main(_args(tmp_path / "whole", 3))
    train_main(_args(tmp_path / "split", 2))
    capsys.readouterr()
    resumed = train_main(_args(tmp_path / "split", 3))
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "Resumed from checkpoint epoch 1"
    assert [h["epoch"] for h in resumed.history] == [3]
    for k, v in whole.model.state_dict().items():
        assert torch.equal(v, resumed.model.state_dict()[k]), k
    assert _opt_equal(whole.optimizer, resumed.optimizer)
    assert resumed.optimizer.count == 3 * whole.runner.steps_per_epoch
    assert resumed.history[0]["loss"] == whole.history[2]["loss"]

    mgr = ck.CheckpointManager(str(tmp_path / "split"))
    assert mgr.all_epochs() == [0, 1, 2]
    assert all(mgr.verify_epoch(e) == [] for e in (0, 1, 2))
    assert mgr.read(2)["step"] == resumed.optimizer.count
    sidecar = ck.load_lm_spec_fields(str(tmp_path / "split"))
    assert sidecar == resumed.spec._asdict()
    state, epoch = mgr.restore_for_inference()
    assert epoch == 2 and set(state) == set(resumed.model.state_dict())
    for k, v in resumed.model.state_dict().items():
        assert torch.equal(state[k], v), k
    meta = mgr.params_metadata(2)
    assert {k: (tuple(m.shape), m.dtype) for k, m in meta.items()} == {
        k: (tuple(v.shape), v.dtype) for k, v in state.items()}
    assert ck.derive_spec_with_sidecar(
        str(tmp_path / "split"), meta, num_heads_fallback=1) == resumed.spec


def test_corrupt_latest_epoch_quarantined_then_resumed_before_it(
        tmp_path, capsys):
    """A flipped byte in epoch 1: serving's restore quarantines it and
    falls back to epoch 0, an explicit epoch 1 raises, and the trainer
    resumes from epoch 0 and trains epochs 1 and 2."""
    train_main(_args(tmp_path, 2))
    _flip_byte(tmp_path / "epoch_1" / ck.STATE_FILE)
    with pytest.raises(RuntimeError, match="integrity"):
        ck.CheckpointManager(str(tmp_path)).restore_for_inference(1)
    state, epoch = ck.CheckpointManager(str(tmp_path)).restore_for_inference()
    assert epoch == 0 and (tmp_path / "quarantine.epoch-1").is_dir()
    capsys.readouterr()
    again = train_main(_args(tmp_path, 3))
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "Resumed from checkpoint epoch 0"
    assert [h["epoch"] for h in again.history] == [2, 3]
    assert ck.CheckpointManager(str(tmp_path)).all_epochs() == [0, 1, 2]


def test_resume_epoch_deletes_later_epochs(tmp_path, capsys):
    first = train_main(_args(tmp_path, 3))
    saved = ck.CheckpointManager(str(tmp_path)).read(0)
    capsys.readouterr()
    rewound = train_main(_args(tmp_path, 2, "--resume_epoch", "0"))
    out = capsys.readouterr().out
    assert "Resumed from requested epoch 0" in out
    assert "deleted the abandoned branch's checkpoints [1, 2]" in out
    assert [h["epoch"] for h in rewound.history] == [2]
    assert ck.CheckpointManager(str(tmp_path)).all_epochs() == [0, 1]
    assert rewound.optimizer.count == 2 * saved["step"]
    assert first.optimizer.count == 3 * saved["step"]


def test_a_trainer_that_never_trains_writes_nothing(tmp_path):
    """The sidecar is written by ``train()``, not at construction."""
    LMTrainer(TrainConfig.from_args(_args(tmp_path / "ck", 1)))
    assert not (tmp_path / "ck").exists()


def test_serve_from_a_checkpoint_needs_the_gpu_or_the_cpu_flag(tmp_path):
    """No fallback hides the device: without ``--device cpu`` and with no
    GPU, serving a checkpoint raises; a draft of another length exits
    with a message."""
    train_main(_args(tmp_path / "t", 1))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve_main(["--checkpoint_dir", str(tmp_path / "t")])
    train_main(_args(tmp_path / "d", 1) + ["--seq_len", str(T // 2)])
    with pytest.raises(SystemExit, match="total_len"):
        serve_main(["--checkpoint_dir", str(tmp_path / "t"), "--device",
                    "cpu", "--spec_tokens", "2", "--draft_checkpoint_dir",
                    str(tmp_path / "d")])


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def test_cli_train_then_serve_matches_jax_generation(tmp_path):
    """``python -m ddp_tpu_torch.train --model causal_lm --checkpoint_dir
    D``, then ``python -m ddp_tpu_torch.serve --checkpoint_dir D
    --device cpu --port 0``: the /generate greedy stream equals the JAX
    engine's on the checkpoint's weights, and the reply names the
    version."""
    train_main(_args(tmp_path, 2, "--lr", "3e-2"))
    state, epoch = ck.CheckpointManager(str(tmp_path)).restore_for_inference()
    prompt = list(range(5, 17))
    proc = subprocess.Popen(
        [sys.executable, "-m", "ddp_tpu_torch.serve", "--checkpoint_dir",
         str(tmp_path), "--device", "cpu", "--port", "0", "--slots", "2"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    try:
        started = json.loads(proc.stdout.readline())
        reply = _post(started["serving"] + "/generate",
                      {"prompt_tokens": prompt, "max_new_tokens": 12})
    finally:
        proc.terminate()
        out, err = proc.communicate(timeout=60)
    assert proc.returncode == 0, err[-2000:]
    assert json.loads(out.splitlines()[-1])["drained"] is True
    assert started["model_version"] == f"{tmp_path.name}@epoch1"
    assert started["epoch"] == epoch == 1
    assert started["spec"]["num_heads"] == HEADS
    assert reply["model_version"] == started["model_version"]

    jspec = JSpec(VOCAB, T, D, DEPTH, HEADS)
    tree = lm_params_to_jax(state)
    jeng = JEngine(jspec, jax.tree.map(jnp.asarray, tree),
                   decode_attn="reference", slots=2)
    rid = jeng.submit(prompt, 12).request.rid
    jeng.run()
    assert reply["tokens"] == jeng.result(rid).tokens
    # The stream is no accident of a near tie: every emitted token's
    # top-2 gap in the port's dense logits clears 1e-4.
    from ddp_tpu_torch.models.lm import CausalLM

    model = CausalLM.from_state(lm_params_from_jax(tree, num_heads=HEADS)[0],
                                state, "cpu")
    seq = torch.tensor([prompt + reply["tokens"][:-1]])
    with torch.no_grad():
        top2 = torch.topk(model(seq)[0, len(prompt) - 1:], 2, -1).values
    assert float((top2[:, 0] - top2[:, 1]).min()) > 1e-4
    assert os.path.isfile(tmp_path / ck.LM_SPEC_FILENAME)
