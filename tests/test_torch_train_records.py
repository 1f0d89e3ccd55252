"""The ``--metrics_file`` stream, ``--keep_best`` retention and the
reference ``.pt`` import of ddp_tpu_torch, on the CPU.

- A tiny image run and a tiny causal-LM run of each package write
  their streams: the port's has JAX's record kinds, with JAX's keys per
  kind, less :data:`NOT_PORTED` (the observability records and fields of
  ROADMAP A5/A6). Without the flag nothing is written.
- ``scripts/health_report.py`` reads a port stream and exits 0.
- ``keep_best`` keeps the best N ∪ the latest ∪ the saves without
  metrics, each with its manifest, and no manifest of a pruned epoch
  (the port's deliberate difference from the JAX manager under orbax's
  preservation policy, which leaves an orphaned manifest).
- A reference ``.pt`` with DDP's ``module.`` prefix: JAX's SimpleCNN on
  JAX's import and the port's SimpleCNN on the port's give the same
  logits on the same images within 1e-5; export then import is bitwise;
  the import CLI writes an epoch the trainer resumes after.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddp_tpu.interop.torch_checkpoint import (
    import_torch_checkpoint as jax_import,
)
from ddp_tpu.models.cnn import SimpleCNN as JaxCNN
from ddp_tpu.train.config import TrainConfig as JaxConfig
from ddp_tpu.train.trainer import Trainer as JaxTrainer
from ddp_tpu_torch.interop import import_torch_checkpoint as import_cli
from ddp_tpu_torch.interop.torch_checkpoint import (
    export_torch_checkpoint,
    import_torch_checkpoint,
)
from ddp_tpu_torch.models.cnn import SimpleCNN, init_cnn_state
from ddp_tpu_torch.parallel.ddp import TrainState
from ddp_tpu_torch.train import checkpoint as ck
from ddp_tpu_torch.train.optim import make_optimizer
from ddp_tpu_torch.train.trainer import main as train_main

REPO = Path(__file__).resolve().parent.parent
# What the port's stream leaves out: JAX's compile / xprof / tuning /
# health records and the goodput accounting's fields (goodput, and the
# MFU it estimates), all ``ddp_tpu/obs`` (ROADMAP A5/A6).
NOT_PORTED = {"kinds": {"compile", "xprof_check", "tuning", "health"},
              "fields": {"goodput", "mfu"}}


def _keys(path) -> dict:
    kinds: dict = {}
    for line in open(path):
        rec = json.loads(line)
        kinds.setdefault(rec["kind"], set()).update(rec)
    return kinds


def _jax_stream(tmp_path, **kw) -> dict:
    path = tmp_path / "jax.jsonl"
    t = JaxTrainer(JaxConfig(
        epochs=1, checkpoint_dir=str(tmp_path / "jck"),
        data_root=str(tmp_path / "data"), log_interval=2,
        metrics_file=str(path), **kw))
    try:
        t.train()
    finally:
        t.close()
    return _keys(path)


def _port_stream(tmp_path, args) -> dict:
    path = tmp_path / "port.jsonl"
    train_main(args + ["--epochs", "1", "--log_interval", "2",
                       "--device", "cpu", "--checkpoint_dir",
                       str(tmp_path / "pck"), "--metrics_file", str(path)])
    return _keys(path)


def _same_schema(port, jax):
    want = {k: v - NOT_PORTED["fields"] for k, v in jax.items()
            if k not in NOT_PORTED["kinds"]}
    assert port == want


def test_image_stream_has_jax_kinds_and_keys(tmp_path):
    jax = _jax_stream(tmp_path, batch_size=4, synthetic_data=True,
                      synthetic_size=64)  # global 32 over 8 CPU devices
    port = _port_stream(tmp_path, ["--synthetic_data", "--synthetic_size",
                                   "64", "--batch_size", "32",
                                   "--data_root", str(tmp_path / "data")])
    assert set(jax) == {"run_start", "step", "epoch", "final"}
    _same_schema(port, jax)


@pytest.mark.slow  # the JAX LM trainer compiles its step and eval: ~11 s
def test_lm_stream_has_jax_kinds_and_keys(tmp_path):
    # JAX's batch is per data shard (8 CPU devices): global 16 on both.
    jax = _jax_stream(tmp_path, model="causal_lm", batch_size=2, seq_len=16,
                      vocab_size=32, model_dim=16, synthetic_size=64,
                      optimizer="adam", lr=3e-3)
    port = _port_stream(tmp_path, ["--model", "causal_lm", "--seq_len", "16",
                                   "--vocab_size", "32", "--model_dim", "16",
                                   "--synthetic_size", "64", "--batch_size",
                                   "16", "--optimizer", "adam", "--lr",
                                   "3e-3"])
    assert "perplexity" in port["final"] and "tokens_per_sec" in port["epoch"]
    _same_schema(port, jax)


def test_health_report_reads_a_port_stream(tmp_path):
    path = tmp_path / "m.jsonl"
    train_main(["--device", "cpu", "--synthetic_data", "--synthetic_size",
                "128", "--batch_size", "16", "--epochs", "2",
                "--log_interval", "2", "--checkpoint_dir",
                str(tmp_path / "ck"), "--metrics_file", str(path)])
    res = subprocess.run([sys.executable, str(REPO / "scripts" /
                                              "health_report.py"), str(path)],
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "steps logged  : 8 (epochs 2)" in res.stdout
    # Without the flag, nothing is written.
    train_main(["--device", "cpu", "--synthetic_data", "--synthetic_size",
                "64", "--batch_size", "16", "--epochs", "1",
                "--checkpoint_dir", str(tmp_path / "quiet")])
    assert not list(tmp_path.glob("quiet/*.jsonl"))


def _state(value: float):
    model = SimpleCNN.from_state(init_cnn_state((4, 8)), "cpu")
    with torch.no_grad():
        for p in model.parameters():
            p.fill_(value)
    return TrainState(int(value), model,
                      make_optimizer(model.parameters(), "sgd"))


def _manifests(d):
    return sorted(int(n.split("_")[1].split(".")[0]) for n in os.listdir(d)
                  if n.endswith(".manifest.json"))


def test_keep_best_keeps_best_latest_and_metricless(tmp_path):
    d = str(tmp_path / "ck")
    mgr = ck.CheckpointManager(d, max_to_keep=1, keep_best_metric="accuracy")
    mgr.save(0, _state(0), metrics={"accuracy": 0.5})
    mgr.save(1, _state(1), metrics={"accuracy": 0.9})
    mgr.save(2, _state(2), metrics={"accuracy": 0.7})
    assert mgr.all_epochs() == [1, 2] == _manifests(d)  # best ∪ latest
    mgr.save(3, _state(3), mid_batch=5)  # a preemption save: no metrics
    mgr.save(4, _state(4), metrics={"accuracy": 0.95})
    assert mgr.all_epochs() == [3, 4] == _manifests(d)
    assert mgr.saved_metrics(3) is None and mgr.saved_metrics(4) == {
        "accuracy": 0.95}
    assert all(mgr.verify_epoch(e) == [] for e in mgr.all_epochs())


def test_trainer_keep_best_leaves_no_orphaned_manifest(tmp_path):
    d = tmp_path / "ck"
    t = train_main(["--device", "cpu", "--synthetic_data", "--synthetic_size",
                    "128", "--batch_size", "16", "--epochs", "3",
                    "--keep_best", "--max_checkpoints", "1",
                    "--checkpoint_dir", str(d)])
    assert t.summary["epochs_run"] == 3
    kept = ck.CheckpointManager(str(d)).all_epochs()
    assert 1 <= len(kept) <= 2 and kept[-1] == 2
    assert kept == _manifests(d)
    quick = ["--device", "cpu", "--synthetic_data", "--synthetic_size", "64",
             "--keep_best", "--checkpoint_dir", str(d)]
    with pytest.raises(ValueError, match="eval_every 1"):
        train_main(quick + ["--eval_every", "0"])
    with pytest.raises(ValueError, match="max_checkpoints"):
        train_main(quick)


def _reference_pt(path, seed=0):
    """A reference-format file from seeded weights, saved with DDP's
    ``module.`` prefix (what ``model.state_dict()`` of a wrapped model
    gives)."""
    state = {f"module.{k}": torch.from_numpy(v)
             for k, v in init_cnn_state(seed=seed).items()}
    rng = np.random.default_rng(seed)
    for k in ("module.net.0.bias", "module.net.2.bias", "module.fl.bias"):
        state[k] = torch.from_numpy(
            rng.standard_normal(state[k].shape).astype(np.float32) * 0.1)
    torch.save({"epoch": 1, "model": state, "optimizer": {
        "state": {}, "param_groups": [{"lr": 0.01, "params": list(range(6))}]}},
        path)


def test_pt_import_logits_equal_jax(tmp_path):
    pt = str(tmp_path / "epoch_1.pt")
    _reference_pt(pt)
    sd, epoch = import_torch_checkpoint(pt)
    jparams, jepoch = jax_import(pt)
    assert epoch == jepoch == 1
    assert sorted(sd) == sorted(
        ["net.0.weight", "net.0.bias", "net.2.weight", "net.2.bias",
         "fl.weight", "fl.bias"])
    images = np.random.default_rng(1).integers(0, 256, (8, 28, 28, 1),
                                               dtype=np.uint8)
    x = images.astype(np.float32) / 255.0
    want = np.asarray(JaxCNN().apply({"params": jparams}, jnp.asarray(x)))
    model = SimpleCNN.from_state({k: v.numpy() for k, v in sd.items()}, "cpu")
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_pt_export_then_import_is_bitwise(tmp_path):
    model = SimpleCNN.from_state(init_cnn_state(seed=3), "cpu")
    pt = str(tmp_path / "out.pt")
    export_torch_checkpoint(pt, model, 4, lr=0.05, momentum=0.9)
    raw = torch.load(pt, weights_only=True)
    assert raw["epoch"] == 4 and raw["optimizer"]["param_groups"][0][
        "momentum"] == 0.9
    sd, epoch = import_torch_checkpoint(pt)
    assert epoch == 4
    for k, v in model.state_dict().items():
        assert torch.equal(sd[k], v), k
    bad = dict(raw["model"])
    del bad["fl.bias"]
    torch.save({"epoch": 0, "model": bad}, pt)
    with pytest.raises(KeyError, match="fl.bias"):
        import_torch_checkpoint(pt)


def test_import_cli_writes_an_epoch_the_trainer_resumes(tmp_path, capsys):
    pt, d = str(tmp_path / "epoch_1.pt"), str(tmp_path / "ck")
    _reference_pt(pt)
    assert import_cli.main(["--pt", pt, "--checkpoint_dir", d]) == 0
    assert ck.CheckpointManager(d).all_epochs() == [1]
    with pytest.raises(SystemExit, match="refusing"):
        import_cli.main(["--pt", pt, "--checkpoint_dir", d])
    capsys.readouterr()
    t = train_main(["--device", "cpu", "--synthetic_data", "--synthetic_size",
                    "128", "--batch_size", "16", "--epochs", "3",
                    "--checkpoint_dir", d])
    assert capsys.readouterr().out.splitlines()[0] == \
        "Resumed from checkpoint epoch 1"
    assert [h["epoch"] for h in t.history] == [2]
