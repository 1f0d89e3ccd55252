"""The trainer flags that ``python -m ddp_tpu_torch.train`` lacked
(``--no_shuffle``, ``--num_classes``, ``--profile_dir``,
``--num_workers``, ``--remat`` and the multi-host trio) ≡ the JAX
package's, on the CPU.

Each flag parses to JAX's value and default (``ddp_tpu/train/config.py``)
and does what it does there: ``--no_shuffle`` feeds the first batch in
index order (and is refused with ``--fast_epoch``), ``--num_classes``
sizes the head, ``--profile_dir`` writes a ``torch.profiler``
chrome-trace, ``--dataset imagenet`` trains on the synthetic 224² set.
"""

import json
import os

import numpy as np
import pytest
import torch

from ddp_tpu.train.config import TrainConfig as JaxConfig
from ddp_tpu_torch.train import trainer as ttrainer
from ddp_tpu_torch.train.config import TrainConfig

FLAGS = [
    [], ["--no_shuffle"], ["--num_workers", "0"], ["--num_workers", "5"],
    ["--num_classes", "37"], ["--profile_dir", "/tmp/p"], ["--remat",
                                                           "--model",
                                                           "resnet50"],
    ["--coordinator_address", "10.0.0.1:1234", "--num_processes", "2",
     "--process_id", "1"],
]
KEYS = ("shuffle", "num_workers", "num_classes", "profile_dir", "remat",
        "coordinator_address", "num_processes", "process_id")


@pytest.mark.parametrize("argv", FLAGS, ids=lambda a: " ".join(a) or "none")
def test_flags_parse_as_jax(argv):
    got, want = TrainConfig.from_args(argv), JaxConfig.from_args(argv)
    for k in KEYS:
        assert getattr(got, k) == getattr(want, k), k


def _batches(trainer, epoch=0):
    return [b.labels.numpy().copy() for b in trainer.loader.epoch(epoch)]


def test_no_shuffle_feeds_index_order(tmp_path):
    base = ["--device", "cpu", "--synthetic_data", "--synthetic_size", "128",
            "--batch_size", "16", "--epochs", "1", "--eval_every", "0"]
    cfg = TrainConfig.from_args(base + ["--no_shuffle", "--checkpoint_dir",
                                        str(tmp_path / "a")])
    ctx = ttrainer.dist.setup(device="cpu")
    try:
        plain = ttrainer.ImageTrainer(cfg, ctx)
        order = plain.loader.sampler.shard_indices(0)
        assert np.array_equal(order, np.arange(len(order)))
        labels = plain.train_split.labels
        first = _batches(plain)[0]
        assert np.array_equal(first, labels[:16])
        assert np.array_equal(_batches(plain, 1)[0], labels[:16])
        shuffled = ttrainer.ImageTrainer(TrainConfig.from_args(
            base + ["--checkpoint_dir", str(tmp_path / "b")]), ctx)
        assert not np.array_equal(
            shuffled.loader.sampler.shard_indices(0), order)
    finally:
        ttrainer.dist.cleanup()
    with pytest.raises(ValueError, match="drop --no_shuffle"):
        TrainConfig.from_args(["--fast_epoch", "--no_shuffle"])


def test_num_classes_sizes_the_head(tmp_path):
    t = ttrainer.main(["--device", "cpu", "--synthetic_data",
                       "--synthetic_size", "64", "--batch_size", "16",
                       "--epochs", "1", "--num_classes", "13",
                       "--checkpoint_dir", str(tmp_path / "c")])
    assert t.num_classes == 13
    fc = t.state.model.state_dict()
    assert any(v.shape[0] == 13 for k, v in fc.items() if k.endswith("weight")
               and v.ndim == 2)
    assert np.isfinite(t.summary["final_loss"])


def test_profile_dir_writes_a_chrome_trace(tmp_path):
    prof = tmp_path / "prof"
    ttrainer.main(["--device", "cpu", "--synthetic_data", "--synthetic_size",
                   "64", "--batch_size", "16", "--epochs", "1",
                   "--checkpoint_dir", str(tmp_path / "ck"),
                   "--profile_dir", str(prof)])
    assert os.listdir(prof) == ["trace_rank0.json"]
    trace = json.loads((prof / "trace_rank0.json").read_text())
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("conv" in n for n in names)  # the step's ops, on the CPU


def test_imagenet_trains_on_the_synthetic_224_set(tmp_path):
    """``--dataset imagenet --synthetic_data``: 224² uint8 images, 1000
    classes, the loader path with the native pool, a checkpoint and an
    exact resume."""
    def argv(epochs):
        return ["--device", "cpu", "--model", "vit_micro", "--dataset",
                "imagenet", "--synthetic_data", "--synthetic_size", "32",
                "--batch_size", "16", "--epochs", str(epochs),
                "--eval_every", "0", "--checkpoint_dir", str(tmp_path / "in")]

    t = ttrainer.main(argv(1))
    assert t.train_split.images.shape == (32, 224, 224, 3)
    assert t.num_classes == 1000 and t.state.model.head.out_features == 1000
    assert len(t.history) == 1 and np.isfinite(t.summary["final_loss"])
    if (os.cpu_count() or 1) >= 2:  # the pool's gate: a 2.4 MB batch
        assert t.loader.pool_batches == 2
    again = ttrainer.main(argv(2))
    assert len(again.history) == 1 and again.history[0]["epoch"] == 1
    blob = torch.load(tmp_path / "in" / "epoch_0" / "state.pt",
                      weights_only=True)
    assert blob["step"] == 2
