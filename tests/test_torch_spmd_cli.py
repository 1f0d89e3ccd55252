"""The image family's GSPMD flags through ``python -m ddp_tpu_torch.train``
on the CPU (``--spawn N --device cpu``, gloo): the port's counterparts of
tests/test_trainer_spmd.py and of the CLI half of tests/test_zero1.py.

- TP × FSDP (``--mesh_model 2 --mesh_fsdp 2``) trains, equals the
  world-1 run on the same global batch (parameters after an epoch, atol
  1e-5), and resumes; expert parallelism trains; an attention-free model
  trains under ``--zero1``; every rank records its bytes at rest.
- Checkpoints hold the full state: each is restored by a trainer at
  another mesh or strategy (GSPMD ↔ world-1 DDP, another GSPMD mesh,
  ``--zero1`` ↔ DDP and ``--parallel zero``) and saved again from there,
  and the step, parameters and optimizer state equal the original's bit
  for bit.
- The guards raise with JAX's messages; ``--model vit_tiny --mesh_model
  3`` (whole heads) and ``--mesh_model 2`` (heads that do not divide,
  which JAX accepts) are taken.
"""

import json

import numpy as np
import pytest

from ddp_tpu_torch.interop.jax_params import leaf_maps
from ddp_tpu_torch.parallel import spmd
from ddp_tpu_torch.train.config import TrainConfig

from test_torch_zero_cli import (
    _assert_bitwise,
    _assert_params_close,
    _blob,
    _cli,
    _resave,
)

VIT = ["--model", "vit_micro", "--device", "cpu", "--synthetic_data",
       "--synthetic_size", "64", "--epochs", "1", "--log_interval", "2",
       "--eval_every", "0", "--optimizer", "sgd", "--momentum", "0.9",
       "--lr", "0.05"]
CNN = ["--model", "simple_cnn", "--device", "cpu", "--synthetic_data",
       "--synthetic_size", "64", "--epochs", "1", "--log_interval", "2",
       "--eval_every", "0", "--optimizer", "adam", "--lr", "0.001"]
TP_FSDP = ["--mesh_model", "2", "--mesh_fsdp", "2", "--spawn", "4",
           "--batch_size", "8"]
ZERO1 = ["--zero1", "--spawn", "2", "--batch_size", "8"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """vit_micro at model 2 × fsdp 2 (the global batch 16 over fsdp's
    two replicas) and at world 1 (batch 16); simple_cnn under --zero1
    --spawn 2 and at world 1, the same global batch."""
    from ddp_tpu_torch.train.trainer import main

    root = tmp_path_factory.mktemp("spmd")
    _cli(*VIT, *TP_FSDP, "--checkpoint_dir", str(root / "tp_fsdp"),
         "--profile_dir", str(root / "tp_fsdp_prof"))
    _cli(*CNN, *ZERO1, "--checkpoint_dir", str(root / "zero1"),
         "--profile_dir", str(root / "zero1_prof"))
    # The world-1 runs in this process (main(), as the CLI runs it).
    main([*VIT, "--batch_size", "16", "--checkpoint_dir", str(root / "vit1")])
    main([*CNN, "--batch_size", "16", "--checkpoint_dir", str(root / "cnn1")])
    return root


def test_tp_fsdp_trains_equals_world_1_and_records_its_shards(runs):
    gspmd, one = _blob(runs / "tp_fsdp"), _blob(runs / "vit1")
    assert gspmd["step"] == one["step"] == 4
    _assert_params_close(gspmd, one, atol=1e-5)
    states = [json.loads((runs / "tp_fsdp_prof" / f"state_rank{r}.json")
                         .read_text()) for r in range(4)]
    full = sum(v.numel() for v in one["params"].values()) * 4
    # qkv, proj, mlp1, mlp2 halve over model, the big leaves over fsdp.
    assert all(s["params"] < full / 2 for s in states)
    assert all(s["optimizer"] == s["params"] for s in states)  # the trace


def test_tp_fsdp_resumes(runs, tmp_path):
    import shutil

    shutil.copytree(runs / "tp_fsdp", tmp_path / "ck")
    res = _cli(*VIT, *TP_FSDP, "--epochs", "2", "--checkpoint_dir",
               str(tmp_path / "ck"))
    assert "Resumed from checkpoint epoch 0" in res.stdout
    assert _blob(tmp_path / "ck", 1)["step"] == 8


def test_expert_parallel_trains(tmp_path):
    res = _cli("--model", "vit_moe_micro", "--device", "cpu",
               "--synthetic_data", "--synthetic_size", "32", "--epochs", "1",
               "--batch_size", "8", "--mesh_expert", "2", "--spawn", "2",
               "--checkpoint_dir", str(tmp_path / "ep"))
    acc = float(res.stdout.strip().splitlines()[-1].split("=")[1])
    assert np.isfinite(acc)
    blob = _blob(tmp_path / "ep")
    assert blob["params"]["block2.moe.wi"].shape[0] == 4  # full experts


def test_attention_free_model_under_zero1(runs):
    zero1, one = _blob(runs / "zero1"), _blob(runs / "cnn1")
    assert zero1["step"] == one["step"] == 4
    _assert_params_close(zero1, one, atol=1e-5)
    states = [json.loads((runs / "zero1_prof" / f"state_rank{r}.json")
                         .read_text()) for r in range(2)]
    full = sum(v.numel() for v in one["params"].values()) * 4
    # Adam's two moments: each leaf's data slice (1/2 where ZeRO-1's
    # spec shards it), and optax's int32 count.
    maps = leaf_maps({k: tuple(v.shape)
                           for k, v in one["params"].items()})
    moments = sum(v.numel() // (2 if any(spmd.zero1_spec_for(
        maps[k].jax_shape, {"data": 2})) else 1)
        for k, v in one["params"].items()) * 4
    for s in states:
        assert s["params"] == full  # the parameters stay whole
        assert s["optimizer"] == 2 * moments + 4 < 2 * full


RESUMES = {  # name: (source run, the restoring trainer's flags, world)
    "tp_fsdp4-to-ddp1": ("tp_fsdp", [*VIT, "--batch_size", "16"], 1),
    "tp_fsdp4-to-model2": ("tp_fsdp", [*VIT, "--mesh_model", "2", "--spawn",
                                       "2", "--batch_size", "16"], 2),
    "ddp1-to-tp_fsdp4": ("vit1", [*VIT, *TP_FSDP], 4),
    "zero1-to-ddp1": ("zero1", [*CNN, "--batch_size", "16"], 1),
    "zero1-to-parallel_zero2": ("zero1", [*CNN, "--parallel", "zero",
                                          "--spawn", "2"], 2),
    "ddp1-to-zero1": ("cnn1", [*CNN, *ZERO1], 2),
}


@pytest.mark.parametrize("case", list(RESUMES))
def test_checkpoint_restores_bit_for_bit(runs, tmp_path, case):
    source, argv, world = RESUMES[case]
    _assert_bitwise(_resave(argv, runs / source, tmp_path, world),
                    _blob(runs / source))


def test_mesh_flags_parse():
    c = TrainConfig.from_args(["--model", "vit_micro", "--mesh_model", "2",
                               "--mesh_fsdp", "2", "--mesh_expert", "2",
                               "--spawn", "8"])
    assert (c.mesh_model, c.mesh_fsdp, c.mesh_expert) == (2, 2, 2)
    assert c.use_spmd
    assert TrainConfig.from_args(["--model", "resnet18", "--zero1"]).use_spmd
    assert not TrainConfig.from_args(["--model", "resnet18"]).use_spmd
    assert not TrainConfig.from_args(["--model", "causal_lm", "--mesh_fsdp",
                                      "2", "--spawn", "2"]).use_spmd


@pytest.mark.parametrize("argv", [
    ["--model", "vit_tiny", "--mesh_model", "3", "--spawn", "3"],
    ["--model", "vit_tiny", "--mesh_model", "2", "--spawn", "2"],
    ["--model", "simple_cnn", "--mesh_expert", "2", "--spawn", "2"],
    ["--model", "vit_moe_tiny", "--mesh_expert", "2", "--mesh_model", "3",
     "--spawn", "6"],
])
def test_meshes_jax_accepts_are_taken(argv):
    """JAX checks the Megatron dims (``_check_tp_dims``, --num_heads, 4 by
    default) for the pipe and sequence families only."""
    assert TrainConfig.from_args(argv).use_spmd


@pytest.mark.parametrize("argv,match", [
    (["--model", "vit_micro", "--zero1", "--mesh_model", "2", "--spawn", "2"],
     "zero1 only composes with pure data-parallel meshes; {'model': 2}"),
    (["--model", "resnet18", "--zero1", "--mesh_fsdp", "2", "--spawn", "2"],
     "{'fsdp': 2} already shard optimizer state"),
    (["--model", "vit_micro", "--mesh_fsdp", "2", "--spawn", "2",
      "--fast_epoch"], "--fast_epoch supports the pure-DDP step without "
     "gradient accumulation"),
    (["--model", "simple_cnn", "--fast_epoch", "--grad_accum_steps", "2"],
     "--fast_epoch supports the pure-DDP step"),
    (["--model", "vit_micro", "--parallel", "zero", "--zero1"],
     "fsdp IS ZeRO-3"),
    (["--model", "vit_micro", "--parallel", "zero", "--mesh_expert", "2",
      "--spawn", "2"], "fsdp/expert meshes"),
    (["--model", "vit_micro", "--mesh_model", "3", "--spawn", "4"],
     "does not tile"),
])
def test_guards_raise_with_jax_messages(argv, match):
    with pytest.raises(ValueError) as e:
        TrainConfig.from_args(argv)
    assert match in str(e.value)
