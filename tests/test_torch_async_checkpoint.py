"""Asynchronous checkpoint saves in the port (``async_save=True``, JAX's
default, ``ddp_tpu/train/checkpoint.py:367-383``), on the CPU.

``save`` snapshots the state and returns; the writer thread commits
(rename) and only then manifests (``_flush_manifests``'s rule) and
prunes. Pinned here: the directory read while the writer is held before
its commit shows neither the epoch nor its manifest (and a writer that
skips that wait is caught by the same read); retention never deletes an
epoch while another save is in flight; the state saved is the state at
``save`` even when the loop writes the parameters at once; a process
that exits right after ``save`` returns leaves a durable, intact epoch;
a writer's failure is raised by ``wait()``; a resume is bit for bit and
the file equals the blocking save's. On the CPU the staging copy is a
plain host copy (pinned memory needs CUDA).
"""

import os
import subprocess
import sys
import textwrap
import threading
from pathlib import Path

import pytest
import torch

import chip_smoke
from ddp_tpu_torch.models.cnn import SimpleCNN, init_cnn_state
from ddp_tpu_torch.parallel.ddp import TrainState
from ddp_tpu_torch.train import checkpoint as ck
from ddp_tpu_torch.train.optim import make_optimizer

REPO = Path(__file__).resolve().parents[1]


def _state(seed=0, momentum=0.9):
    model = SimpleCNN.from_state(init_cnn_state(seed=seed), "cpu")
    opt = make_optimizer(model.parameters(), "sgd", lr=0.1,
                         momentum=momentum)
    for p in model.parameters():  # a non-zero momentum buffer
        p.grad = torch.full_like(p, 0.01 * (seed + 1))
    opt.step()
    return TrainState(1, model, opt)


def _same(a: TrainState, b: TrainState) -> bool:
    sa, sb = a.model.state_dict(), b.model.state_dict()
    oa, ob = a.optimizer.state_dict(), b.optimizer.state_dict()
    return (a.step == b.step and oa["count"] == ob["count"]
            and all(torch.equal(sa[k], sb[k]) for k in sa)
            and all(torch.equal(x, y) for x, y in zip(oa["trace"],
                                                      ob["trace"])))


@pytest.fixture
def held(monkeypatch):
    """Holds every writer just before its commit until ``go()``."""
    gate = threading.Event()
    reached = threading.Event()
    real = ck.CheckpointManager._commit

    def commit(self, tmp, final):
        reached.set()
        assert gate.wait(60)
        real(self, tmp, final)

    monkeypatch.setattr(ck.CheckpointManager, "_commit", commit)
    return reached, gate


@pytest.mark.parametrize("skips", [False, True], ids=["writer",
                                                      "control-skips-wait"])
def test_manifest_only_after_the_commit(tmp_path, skips):
    failed = chip_smoke.manifest_order_failures(
        _state(), str(tmp_path), writer_skips_wait=skips)
    if skips:
        assert failed and "before the commit" in failed[0]
    else:
        assert failed == []


def test_save_returns_before_the_commit(tmp_path, held):
    reached, gate = held
    mgr = ck.CheckpointManager(str(tmp_path))
    state = _state()
    assert mgr.save(0, state) and mgr.in_flight == 0
    assert reached.wait(60)
    assert not (tmp_path / "epoch_0").exists()
    with torch.no_grad():  # the loop goes on writing its parameters
        for p in state.model.parameters():
            p.add_(1.0)
        state.optimizer.trace[0].mul_(3.0)
    gate.set()
    mgr.wait()
    assert mgr.in_flight is None and mgr.verify_epoch(0) == []
    fresh = _state(seed=5)
    mgr.restore(fresh, 0)
    assert _same(fresh, _state())  # the state as it was at save()


def test_retention_spares_the_epoch_in_flight(tmp_path, held):
    reached, gate = held
    gate.set()
    mgr = ck.CheckpointManager(str(tmp_path), max_to_keep=1)
    mgr.save(0, _state())
    mgr.wait()
    gate.clear()
    reached.clear()
    mgr.save(1, _state(1))
    assert reached.wait(60)
    names = sorted(os.listdir(tmp_path))
    assert "epoch_0" in names and "epoch_0.manifest.json" in names
    assert not any(n.startswith("epoch_1") and "tmp" not in n for n in names)
    gate.set()
    assert mgr.all_epochs() == [1]  # a read waits for the save in flight
    assert sorted(os.listdir(tmp_path)) == ["epoch_1",
                                            "epoch_1.manifest.json"]


def test_a_second_save_waits_for_the_first(tmp_path, held):
    reached, gate = held
    mgr = ck.CheckpointManager(str(tmp_path))
    mgr.save(0, _state())
    assert reached.wait(60)
    second = threading.Thread(target=mgr.save, args=(1, _state(1)))
    second.start()
    second.join(0.5)
    assert second.is_alive()  # at most one save in flight
    gate.set()
    second.join(60)
    assert not second.is_alive()
    mgr.wait()
    assert mgr.all_epochs() == [0, 1]


def test_async_resume_is_bitwise_and_equals_the_blocking_file(tmp_path):
    state = _state(2)
    ck.CheckpointManager(str(tmp_path / "a")).save(0, state, mid_batch=3,
                                                   steps_per_epoch=7)
    blocking = ck.CheckpointManager(str(tmp_path / "b"), async_save=False)
    blocking.save(0, state, mid_batch=3, steps_per_epoch=7)
    assert blocking.in_flight is None
    mgr = ck.CheckpointManager(str(tmp_path / "a"))
    fresh = _state(seed=9)
    assert mgr.restore(fresh) == 0  # waits for the writer
    assert _same(fresh, state) and mgr.last_restored_mid_batch == 3
    a = (tmp_path / "a" / "epoch_0" / "state.pt").read_bytes()
    b = (tmp_path / "b" / "epoch_0" / "state.pt").read_bytes()
    assert a == b


def test_writer_failure_is_raised_by_wait(tmp_path, monkeypatch):
    def broken(tmp, blob, metrics):
        raise OSError("disk full")

    monkeypatch.setattr(ck.CheckpointManager, "_write_files",
                        staticmethod(broken))
    mgr = ck.CheckpointManager(str(tmp_path))
    mgr.save(0, _state())
    with pytest.raises(RuntimeError, match="epoch 0 failed: disk full"):
        mgr.wait()
    mgr.wait()  # raised once


def test_exit_right_after_save_leaves_a_durable_epoch(tmp_path):
    """A process that returns from its main right after ``save`` (the
    writer held a second before writing) still commits: the writer is
    not a daemon, so the interpreter finishes it."""
    code = textwrap.dedent(f"""
        import time
        from ddp_tpu_torch.train import checkpoint as ck
        from test_torch_async_checkpoint import _state
        real = ck.CheckpointManager._write_files
        def slow(tmp, blob, metrics):
            time.sleep(1.0)
            real(tmp, blob, metrics)
        ck.CheckpointManager._write_files = staticmethod(slow)
        mgr = ck.CheckpointManager({str(tmp_path)!r})
        mgr.save(0, _state(3), mid_batch=2, steps_per_epoch=5)
        print("returned", mgr.in_flight, flush=True)
    """)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": os.pathsep.join(
                             [str(REPO), str(REPO / "tests")])})
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip() == "returned 0"  # exited with the save in flight
    mgr = ck.CheckpointManager(str(tmp_path))
    assert mgr.verify_epoch(0) == []
    fresh = _state(seed=7)
    mgr.restore(fresh)
    assert _same(fresh, _state(3))


@pytest.mark.parametrize("loop_fails", [False, True],
                         ids=["clean-run", "loop-fails-too"])
def test_trainer_cleans_up_before_a_writer_error(tmp_path, monkeypatch,
                                                 loop_fails):
    """The trainer's epoch loop ends with the writer's error only after
    its clean-up: the step watchdog stopped (it could otherwise abort the
    caller later), the SIGTERM handler put back, the loader closed. When
    the loop failed as well, its own error is the one raised. The clean
    run takes one epoch, so that its failing save is the one waited for
    at the end."""
    import signal

    from ddp_tpu_torch.train import trainer as ttrainer
    from ddp_tpu_torch.train.config import TrainConfig

    def broken(tmp, blob, metrics):
        raise OSError("disk full")

    monkeypatch.setattr(ck.CheckpointManager, "_write_files",
                        staticmethod(broken))
    cfg = TrainConfig.from_args([
        "--device", "cpu", "--synthetic_data", "--synthetic_size", "32",
        "--batch_size", "16", "--epochs", "2" if loop_fails else "1",
        "--eval_every", "0",
        "--watchdog_timeout", "600", "--checkpoint_dir", str(tmp_path)])

    def ours(signum, frame):
        pass

    prev = signal.signal(signal.SIGTERM, ours)
    ctx = ttrainer.dist.setup(device="cpu")
    try:
        t = ttrainer.ImageTrainer(cfg, ctx)
        if loop_fails:
            real = t._train_epoch

            def train_epoch(epoch, skip):
                if epoch == 1:
                    raise ValueError("the loop's own error")
                return real(epoch, skip)

            t._train_epoch = train_epoch
        want = ((ValueError, "the loop's own error") if loop_fails else
                (RuntimeError, "failed: disk full"))
        with pytest.raises(want[0], match=want[1]):
            t.train()
        assert t.watchdog._thread is None
        assert signal.getsignal(signal.SIGTERM) is ours
        assert t.loader is None or t.loader._prefetcher is None
        t.ckpt.wait()  # the writer was joined, its error reported once
    finally:
        ttrainer.dist.cleanup()
        signal.signal(signal.SIGTERM, prev)
