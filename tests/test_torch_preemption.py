"""Preemption-safe mid-epoch checkpoint and resume in ddp_tpu_torch, on
the CPU: the twins of ``tests/test_preemption.py``, the causal LM's
mid-epoch resume, and a gloo world of 2.

SIGTERM only sets a flag; the trainer checks it between steps, saves the
epoch in flight tagged with its ``mid_batch``, and a re-run re-enters
that epoch at that batch with the same data order — bit for bit the
uninterrupted run. The position is the explicit marker, never step
arithmetic: an imported checkpoint's step counter starts at 0 whatever
its epoch tag. In a world of 2 the flag of one rank stops both at the
same step, through one agreement at the log cadence.
"""

import json
import os
import signal

import numpy as np
import torch

from ddp_tpu_torch.models.cnn import SimpleCNN, init_cnn_state
from ddp_tpu_torch.parallel.ddp import TrainState
from ddp_tpu_torch.runtime import dist, launch
from ddp_tpu_torch.train import checkpoint as ck
from ddp_tpu_torch.train.config import TrainConfig
from ddp_tpu_torch.train.optim import make_optimizer
from ddp_tpu_torch.train.trainer import ImageTrainer
from ddp_tpu_torch.train.trainer import main as train_main


def _config(tmp_path, *extra, ckdir="ck"):
    # 512 / 32 = 16 steps an epoch.
    return TrainConfig.from_args([
        "--device", "cpu", "--synthetic_data", "--synthetic_size", "512",
        "--batch_size", "32", "--epochs", "2", "--log_interval", "4",
        "--eval_every", "0", "--checkpoint_dir", str(tmp_path / ckdir),
        "--data_root", str(tmp_path / "data"), *extra])


def _run(config, wrap=None):
    """An ImageTrainer on a one-rank gloo group; ``wrap(trainer)``
    before it trains → (trainer, summary)."""
    ctx = dist.setup(device="cpu")
    try:
        trainer = ImageTrainer(config, ctx)
        if wrap:
            wrap(trainer)
        return trainer, trainer.train()
    finally:
        dist.cleanup()


def _preempt_after(n):
    """Set the trainer's flag inside its n-th step (what the handler
    does on SIGTERM)."""

    def wrap(trainer):
        real, count = trainer.train_step, {"n": 0}

        def step(images, labels):
            out = real(images, labels)
            count["n"] += 1
            if count["n"] == n:
                trainer._preempt_requested = True
            return out

        trainer.train_step = step

    return wrap


def _recording(seen):
    def wrap(trainer):
        real = trainer.train_step

        def step(images, labels):
            seen.append(labels.numpy().copy())
            return real(images, labels)

        trainer.train_step = step

    return wrap


def _state_equal(a, b):
    sa, sb = a.state.model.state_dict(), b.state.model.state_dict()
    oa, ob = a.optimizer.state_dict(), b.optimizer.state_dict()
    return (all(torch.equal(sa[k], sb[k]) for k in sa)
            and a.state.step == b.state.step and oa["count"] == ob["count"]
            and all(torch.equal(x, y) for k in ("trace", "mu", "nu", "ema")
                    for x, y in zip(oa[k] or [], ob[k] or [])))


def test_preempt_mid_epoch_then_resume_exactly(tmp_path):
    seen_ref = []
    ref, _ = _run(_config(tmp_path, "--momentum", "0.9", ckdir="ref"),
                  _recording(seen_ref))
    cfg = _config(tmp_path, "--momentum", "0.9")
    _, summary1 = _run(cfg, _preempt_after(3))
    assert summary1["preempted"] is True
    assert summary1["epochs_run"] == 0  # epoch 0 incomplete
    blob = ck.CheckpointManager(cfg.checkpoint_dir).read(0)
    assert (blob["mid_batch"], blob["spe"], blob["step"]) == (3, 16, 3)

    seen = []
    t2, summary2 = _run(cfg, _recording(seen))
    assert not summary2.get("preempted")
    assert t2.state.step == 32  # 2 epochs × 16 steps, no step lost
    assert len(seen) == len(seen_ref) - 3  # the data order from batch 3
    for a, b in zip(seen, seen_ref[3:]):
        np.testing.assert_array_equal(a, b)
    assert _state_equal(t2, ref)  # bit for bit the uninterrupted run


def test_preempt_after_imported_checkpoint_resumes_exactly(tmp_path):
    """An import-style save: epoch tag 1, step 0. A preemption 3 batches
    into epoch 2 must re-enter epoch 2 at batch 3: 13 + 16 batches."""
    cfg = _config(tmp_path, "--epochs", "4")
    model = SimpleCNN.from_state(init_cnn_state(), "cpu")
    state = TrainState(0, model, make_optimizer(model.parameters(), "sgd"))
    assert ck.CheckpointManager(cfg.checkpoint_dir).save(1, state)

    _, summary1 = _run(cfg, _preempt_after(3))
    assert summary1["preempted"] is True
    counted = []
    t2, summary2 = _run(cfg, _recording(counted))
    assert not summary2.get("preempted")
    assert len(counted) == 29
    assert summary2["epochs_run"] == 2


def test_sigterm_handler_sets_flag_and_restores_the_previous(tmp_path):
    seen = []
    previous = signal.signal(signal.SIGTERM, lambda *a: seen.append(a[0]))
    try:
        ctx = dist.setup(device="cpu")
        try:
            t = ImageTrainer(_config(tmp_path, "--epochs", "1"), ctx)
            installed, prev = t._install_preemption_handler()
            assert installed and t._preempt_requested is False
            os.kill(os.getpid(), signal.SIGTERM)
            assert t._preempt_requested is True and seen == []
            signal.signal(signal.SIGTERM, prev)
            os.kill(os.getpid(), signal.SIGTERM)
            assert seen == [signal.SIGTERM]
            # train() installs its handler and puts the previous one back.
            mine = signal.getsignal(signal.SIGTERM)
            t.train()
            assert signal.getsignal(signal.SIGTERM) is mine
        finally:
            dist.cleanup()
    finally:
        signal.signal(signal.SIGTERM, previous)


LM = ["--model", "causal_lm", "--device", "cpu", "--seq_len", "32",
      "--vocab_size", "64", "--model_dim", "32", "--num_heads", "4",
      "--synthetic_size", "48", "--batch_size", "8", "--epochs", "2",
      "--optimizer", "adam", "--lr", "3e-3"]


def test_lm_sigterm_mid_epoch_resumes_to_the_uninterrupted_run(tmp_path):
    """The causal LM's runner loop: ``sigterm:rank0@step8`` (epoch 1,
    batch 2 of 6) stops before step 8's dispatch, saves epoch 1 at
    mid_batch 2 and exits clean; the re-run trains the 4 remaining
    batches and ends bit for bit on the uninterrupted parameters, Adam
    moments and count."""
    whole = train_main(LM + ["--checkpoint_dir", str(tmp_path / "whole")])
    args = LM + ["--checkpoint_dir", str(tmp_path / "cut"),
                 "--chaos", "sigterm:rank0@step8"]
    cut = train_main(args)
    assert cut.summary["preempted"] and cut.optimizer.count == 8
    mgr = ck.CheckpointManager(str(tmp_path / "cut"))
    assert mgr.all_epochs() == [0, 1]
    assert mgr.read(1)["mid_batch"] == 2 and mgr.verify_epoch(1) == []
    resumed = train_main(args)
    assert [len(h["loss"]) for h in resumed.history] == [4]
    assert resumed.history[0]["loss"] == whole.history[1]["loss"][2:]
    assert _state_equal(resumed, whole)
    assert mgr.read(1)["mid_batch"] == 0  # the last epoch superseded it


def _world2_worker(rank, world, ckdir, data, out):
    config = TrainConfig.from_args([
        "--device", "cpu", "--synthetic_data", "--synthetic_size", "256",
        "--batch_size", "8", "--epochs", "2", "--log_interval", "2",
        "--eval_every", "0", "--checkpoint_dir", ckdir, "--data_root", data,
        "--chaos", "sigterm:rank1@step5"])
    torch.set_num_threads(1)
    ctx = dist.setup(rank, world, device="cpu")
    try:
        trainer = ImageTrainer(config, ctx)
        summary = trainer.train()
    finally:
        dist.cleanup()
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump({"preempted": bool(summary.get("preempted")),
                   "step": trainer.state.step}, f)


def test_one_ranks_flag_stops_both_ranks_at_the_same_step(tmp_path):
    """World 2 over gloo: rank 1 alone is sent SIGTERM before step 5;
    the agreement at the next log cadence (after batch 6) stops both
    ranks after step 7, and rank 0 saves epoch 0 at mid_batch 7."""
    out = tmp_path / "out"
    out.mkdir()
    ckdir = str(tmp_path / "ck")
    restarts = launch.spawn(_world2_worker, 2,
                            (ckdir, str(tmp_path / "data"), str(out)),
                            timeout=300, grace=5.0)
    assert restarts == 0
    got = [json.loads((out / f"rank{r}.json").read_text()) for r in (0, 1)]
    assert got == [{"preempted": True, "step": 7}] * 2
    blob = ck.CheckpointManager(ckdir).read(0)
    assert (blob["mid_batch"], blob["step"]) == (7, 7)
    assert json.loads((tmp_path / "ck" / "chaos_ledger.rank1.json")
                      .read_text()) == {"fired": ["sigterm:rank1@step5"]}
    assert not (tmp_path / "ck" / "chaos_ledger.rank0.json").exists()


def test_deterministic_flag_pins_cudnn(tmp_path):
    """--deterministic: cuDNN's deterministic algorithms, so that a rerun
    or a resume reproduces the run bit for bit on the card too."""
    before = (torch.backends.cudnn.deterministic,
              torch.backends.cudnn.benchmark)
    try:
        torch.backends.cudnn.benchmark = True
        _run(_config(tmp_path, "--epochs", "1", "--deterministic"))
        assert torch.backends.cudnn.deterministic is True
        assert torch.backends.cudnn.benchmark is False
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = before
