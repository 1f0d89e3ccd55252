"""ddp_tpu_torch's checkpoints and auto-resume, on the CPU.

The manifest is held against ``ddp_tpu.train.checkpoint.build_manifest``
of the same directory; a save/restore round trip must be bitwise
(parameters, the step count, and the optimizer's count and moment
buffers); a corrupt byte must quarantine its epoch and fall back to the
previous one; ``--resume_epoch`` deletes the later epochs;
``max_checkpoints`` prunes. The CLI runs ``python -m
ddp_tpu_torch.train --device cpu`` at synthetic size 256 and holds the
JAX trainer's resume contract: 0-based epoch tags, ``Resumed from
checkpoint epoch N``, history from N+1.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ddp_tpu.train.checkpoint import build_manifest as jax_build_manifest
from ddp_tpu.train.checkpoint import verify_manifest as jax_verify_manifest
from ddp_tpu_torch.models.cnn import SimpleCNN, init_cnn_state
from ddp_tpu_torch.parallel.ddp import TrainState, make_train_step
from ddp_tpu_torch.train import checkpoint as ck
from ddp_tpu_torch.train.optim import make_optimizer
from ddp_tpu_torch.train.trainer import main as train_main

REPO = Path(__file__).resolve().parent.parent
CLI = [sys.executable, "-m", "ddp_tpu_torch.train", "--device", "cpu",
       "--synthetic_data", "--synthetic_size", "256", "--log_interval", "4"]


def _trained_state(opt_kw, seed=0, steps=2):
    model = SimpleCNN.from_state(init_cnn_state((4, 8), seed=seed), "cpu")
    state = TrainState(0, model, make_optimizer(model.parameters(), **opt_kw))
    step = make_train_step(state, reduce=lambda t: t)
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        step(torch.from_numpy(rng.integers(0, 256, (4, 28, 28, 1),
                                           dtype=np.uint8)),
             torch.from_numpy(rng.integers(0, 10, 4).astype(np.int32)))
    return state


def _flip_byte(path, offset=-100):
    data = bytearray(Path(path).read_bytes())
    data[offset] ^= 0xFF
    Path(path).write_bytes(bytes(data))


@pytest.mark.parametrize("opt_kw", [
    dict(name="sgd", lr=0.05, momentum=0.9),
    dict(name="adam", lr=1e-3),
    dict(name="sgd", lr=0.05),
], ids=["momentum", "adam", "sgd"])
def test_save_restore_round_trip_is_bitwise(tmp_path, opt_kw):
    saved = _trained_state(opt_kw, seed=0)
    mgr = ck.CheckpointManager(str(tmp_path))
    assert mgr.save(0, saved, steps_per_epoch=2)
    fresh = _trained_state(opt_kw, seed=1, steps=1)
    assert mgr.restore_or_init(fresh) == 1
    assert fresh.step == saved.step == 2
    assert mgr.read(0)["spe"] == 2
    for a, b in zip(saved.model.state_dict().values(),
                    fresh.model.state_dict().values()):
        assert torch.equal(a, b)
    sa, sb = saved.optimizer.state_dict(), fresh.optimizer.state_dict()
    assert sa["count"] == sb["count"] == 2
    for k in ("trace", "mu", "nu"):
        assert (sa[k] is None) == (sb[k] is None)
        for a, b in zip(sa[k] or [], sb[k] or []):
            assert torch.equal(a, b)
    # A checkpoint of another optimizer layout is refused by name.
    other = _trained_state(dict(name="sgd", lr=0.05, momentum=0.0)
                           if opt_kw.get("momentum") else
                           dict(name="sgd", lr=0.05, momentum=0.9))
    with pytest.raises(ValueError, match="optimizer state"):
        mgr.restore(other, 0)


def test_manifest_equals_jax_build_manifest(tmp_path):
    mgr = ck.CheckpointManager(str(tmp_path))
    mgr.save(3, _trained_state(dict(name="sgd", lr=0.05)))
    mgr.wait()  # the save is asynchronous: durable once wait() returns
    step_dir = tmp_path / "epoch_3"
    assert ck.build_manifest(str(step_dir)) == jax_build_manifest(str(step_dir))
    on_disk = json.loads((tmp_path / "epoch_3.manifest.json").read_text())
    assert on_disk == jax_build_manifest(str(step_dir))
    assert sorted(on_disk["files"]) == ["state.pt"]
    assert ck.verify_manifest(str(tmp_path), 3) == []
    assert jax_verify_manifest(str(tmp_path), 3) == []
    assert ck.verify_manifest(str(tmp_path), 4) is None
    # No temporary directory survives the commit.
    assert sorted(os.listdir(tmp_path)) == ["epoch_3", "epoch_3.manifest.json"]


def test_corrupt_byte_quarantines_and_falls_back(tmp_path):
    mgr = ck.CheckpointManager(str(tmp_path))
    s0 = _trained_state(dict(name="sgd", lr=0.05, momentum=0.9), steps=1)
    mgr.save(0, s0)
    s1 = _trained_state(dict(name="sgd", lr=0.05, momentum=0.9), steps=2)
    mgr.save(1, s1)
    mgr.wait()  # the save is asynchronous: durable once wait() returns
    _flip_byte(tmp_path / "epoch_1" / "state.pt")
    problems = mgr.verify_epoch(1)
    assert problems == ["state.pt: checksum mismatch"]
    assert jax_verify_manifest(str(tmp_path), 1) == problems
    with pytest.raises(RuntimeError, match="integrity"):
        mgr.restore(s1, 1)
    target = _trained_state(dict(name="sgd", lr=0.05, momentum=0.9), seed=5)
    assert mgr.restore_or_init(target) == 1  # epoch 0 + 1
    assert target.step == 1
    assert mgr.all_epochs() == [0]
    q = tmp_path / "quarantine.epoch-1"
    assert (q / "state.pt").exists() and (q / "ddp_tpu.manifest.json").exists()
    assert [e["epoch"] for e in mgr.quarantined] == [1]
    # A manifest-less epoch is accepted unverified.
    os.remove(tmp_path / "epoch_0.manifest.json")
    assert mgr.latest_intact_epoch() == 0
    # Nothing intact left: quarantined, and training starts from scratch.
    lone = ck.CheckpointManager(str(tmp_path / "lone"))
    lone.save(0, s0)
    lone.wait()
    _flip_byte(tmp_path / "lone" / "epoch_0" / "state.pt", offset=10)
    assert lone.restore_or_init(target) == 0
    assert (tmp_path / "lone" / "quarantine.epoch-0").is_dir()


def test_max_checkpoints_prunes_oldest(tmp_path):
    mgr = ck.CheckpointManager(str(tmp_path), max_to_keep=2)
    state = _trained_state(dict(name="sgd", lr=0.05), steps=1)
    for epoch in range(4):
        mgr.save(epoch, state)
    assert mgr.all_epochs() == [2, 3]
    assert sorted(p for p in os.listdir(tmp_path) if "manifest" in p) == [
        "epoch_2.manifest.json", "epoch_3.manifest.json"]
    assert mgr.delete_after(2) == [3]
    assert mgr.all_epochs() == [2]


def test_resume_epoch_rewinds_and_deletes_later_epochs(tmp_path, capsys):
    args = ["--device", "cpu", "--synthetic_data", "--synthetic_size", "128",
            "--checkpoint_dir", str(tmp_path), "--log_interval", "100",
            "--momentum", "0.9"]
    first = train_main(args + ["--epochs", "3"])
    assert [h["epoch"] for h in first.history] == [0, 1, 2]
    saved = ck.CheckpointManager(str(tmp_path)).read(0)
    capsys.readouterr()
    rewound = train_main(args + ["--epochs", "2", "--resume_epoch", "0"])
    out = capsys.readouterr().out
    assert "Resumed from requested epoch 0" in out
    assert "deleted the abandoned branch's checkpoints [1, 2]" in out
    assert [h["epoch"] for h in rewound.history] == [1]
    assert ck.CheckpointManager(str(tmp_path)).all_epochs() == [0, 1]
    # The rewound run started from epoch 0's state, momentum included.
    assert rewound.state.step == 2 * saved["step"]


def test_cli_trains_then_resumes_from_the_latest_epoch(tmp_path):
    """``--epochs 2`` prints final_accuracy=; ``--epochs 3`` on the same
    directory prints ``Resumed from checkpoint epoch 1`` and trains one
    epoch (tag 2), from epoch 1's parameters and optimizer state."""
    ckdir = ["--checkpoint_dir", str(tmp_path), "--momentum", "0.9"]
    first = subprocess.run(CLI + ckdir + ["--epochs", "2"], cwd=REPO,
                           capture_output=True, text=True, timeout=300)
    assert first.returncode == 0, first.stderr[-3000:]
    lines = first.stdout.strip().splitlines()
    assert lines[-1].startswith("final_accuracy=")
    assert lines[0] == "No checkpoint found — starting from scratch"
    assert sum(" done: " in line for line in lines) == 2
    again = subprocess.run(CLI + ckdir + ["--epochs", "3"], cwd=REPO,
                           capture_output=True, text=True, timeout=300)
    assert again.returncode == 0, again.stderr[-3000:]
    lines = again.stdout.strip().splitlines()
    assert lines[0] == "Resumed from checkpoint epoch 1"
    assert [line.split(" done:")[0] for line in lines if " done: " in line] == [
        "Epoch 2"]
    assert lines[-1].startswith("final_accuracy=")
    mgr = ck.CheckpointManager(str(tmp_path))
    assert mgr.all_epochs() == [0, 1, 2]
    assert mgr.read(2)["step"] == 3 * mgr.read(0)["step"]
    assert all(mgr.verify_epoch(e) == [] for e in (0, 1, 2))


def test_auto_resume_restores_the_saved_state_bitwise(tmp_path):
    """A re-run with no epoch left to train holds exactly what the last
    epoch saved: parameters, step count and momentum buffers."""
    args = ["--device", "cpu", "--synthetic_data", "--synthetic_size", "64",
            "--checkpoint_dir", str(tmp_path), "--epochs", "1",
            "--momentum", "0.9", "--batch_size", "16"]
    train_main(args)
    again = train_main(args)
    blob = ck.CheckpointManager(str(tmp_path)).read(0)
    assert again.history == [] and again.state.step == blob["step"] == 4
    for k, v in again.state.model.state_dict().items():
        assert torch.equal(v, blob["params"][k]), k
    opt = again.state.optimizer.state_dict()
    assert opt["count"] == blob["opt_state"]["count"] == 4
    for a, b in zip(opt["trace"], blob["opt_state"]["trace"]):
        assert torch.equal(a, b)
