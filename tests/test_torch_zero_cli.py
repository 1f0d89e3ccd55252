"""``--parallel zero`` and ``--mesh_fsdp`` through ``python -m
ddp_tpu_torch.train`` on the CPU, over real gloo process groups
(``--spawn N --device cpu``).

- ``--model simple_cnn --parallel zero --spawn 2`` equals ``--spawn 2``
  DDP on the same global batch (parameters after an epoch, atol 1e-5),
  and its records carry ``comm_bytes`` = ``zero_comm_bytes``' total,
  which is JAX's on JAX's SimpleCNN tree. Under ``--zero_gather_dtype
  bf16`` the checkpoint's parameters are its master rounded to bf16.
- ``--model causal_lm --mesh_fsdp 2 --mesh_seq 2 --spawn 4`` equals the
  world-1 run at the same global batch (atol 1e-5).
- Checkpoints hold the full state, so a run resumes at any mesh and
  strategy: each checkpoint is restored by a trainer at another mesh or
  strategy (FSDP 2 → world 1 and world 1 → FSDP 2; zero at world 2 →
  world 1 and 4; zero ↔ DDP) and saved again from there, and the saved
  parameters, optimizer state and step equal the original's bit for bit.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch

from ddp_tpu.models.cnn import SimpleCNN as JaxCNN
from ddp_tpu.parallel import zero as jz
from ddp_tpu_torch.runtime import dist, launch
from ddp_tpu_torch.train.checkpoint import CheckpointManager
from ddp_tpu_torch.train.config import TrainConfig
from ddp_tpu_torch.train.trainer import ImageTrainer, LMTrainer

REPO = Path(__file__).resolve().parent.parent
CNN = ["--model", "simple_cnn", "--device", "cpu", "--synthetic_data",
       "--synthetic_size", "64", "--epochs", "1", "--log_interval", "2",
       "--eval_every", "0", "--batch_size", "8", "--optimizer", "adam",
       "--lr", "0.001", "--zero_bucket_mb", "0.05"]
LM = ["--model", "causal_lm", "--device", "cpu", "--seq_len", "32",
      "--vocab_size", "64", "--model_dim", "32", "--num_heads", "4",
      "--synthetic_size", "32", "--epochs", "1", "--eval_every", "0",
      "--log_interval", "1", "--optimizer", "sgd", "--momentum", "0.9",
      "--lr", "0.1"]


def _cli(*argv, timeout=240):
    res = subprocess.run([sys.executable, "-m", "ddp_tpu_torch.train",
                          *argv], cwd=REPO, capture_output=True, text=True,
                         timeout=timeout)
    assert res.returncode == 0, res.stderr[-3000:]
    return res


def _blob(directory, epoch=0):
    return torch.load(Path(directory, f"epoch_{epoch}", "state.pt"),
                      weights_only=True)


def _assert_params_close(a, b, atol):
    assert sorted(a["params"]) == sorted(b["params"])
    for k in a["params"]:
        torch.testing.assert_close(a["params"][k], b["params"][k],
                                   atol=atol, rtol=0)


def _assert_bitwise(a, b):
    """The state of two checkpoints equal bit for bit: the step, every
    parameter, every optimizer buffer."""
    assert a["step"] == b["step"]
    assert sorted(a["params"]) == sorted(b["params"])
    for k in a["params"]:
        assert torch.equal(a["params"][k], b["params"][k]), k
    oa, ob = a["opt_state"], b["opt_state"]
    assert oa["count"] == ob["count"]
    for k in ("trace", "mu", "nu", "master"):
        if oa.get(k) is None or ob.get(k) is None:
            continue
        for x, y in zip(oa[k], ob[k]):
            assert torch.equal(x, y), k


def _trainer(argv, ctx):
    config = TrainConfig.from_args(argv)
    if config.model == "causal_lm":
        return LMTrainer(config, ctx)
    return ImageTrainer(config, ctx)


def resave(rank, world, argv, out):
    """A trainer of ``argv`` (its --checkpoint_dir the source) restores
    the latest checkpoint, then saves it again under ``out`` from its own
    mesh and strategy (every rank; rank 0 writes)."""
    torch.set_num_threads(1)
    ctx = dist.setup(rank, world, backend="gloo", device="cpu")
    try:
        trainer = _trainer(argv, ctx)
        epoch = trainer._restore() - 1
        mgr = CheckpointManager(out, is_main=rank == 0, async_save=False,
                                layout=trainer.ckpt.layout)
        mgr.save(epoch, trainer.state)
    finally:
        dist.cleanup()


def _resave(argv, source, out, world):
    argv = [*argv, "--checkpoint_dir", str(source)]
    if world == 1:
        resave(0, 1, argv, str(out))
    else:
        assert launch.spawn(resave, world, (argv, str(out)), timeout=240,
                            grace=5.0) == 0
    return _blob(out)


@pytest.fixture(scope="module")
def cnn_runs(tmp_path_factory):
    """The zero and the DDP CNN runs at --spawn 2 → (directory, zero's
    metrics file)."""
    root = tmp_path_factory.mktemp("cnn")
    _cli(*CNN, "--parallel", "zero", "--spawn", "2", "--checkpoint_dir",
         str(root / "zero"), "--metrics_file", str(root / "zero.jsonl"))
    _cli(*CNN, "--spawn", "2", "--checkpoint_dir", str(root / "ddp"))
    _cli(*CNN, "--parallel", "zero", "--zero_gather_dtype", "bf16",
         "--spawn", "2", "--checkpoint_dir", str(root / "bf16"))
    return root


@pytest.fixture(scope="module")
def lm_runs(tmp_path_factory):
    """The LM at fsdp 2 × seq 2 (--spawn 4) and at world 1, the same
    global batch."""
    root = tmp_path_factory.mktemp("lm")
    _cli(*LM, "--mesh_fsdp", "2", "--mesh_seq", "2", "--spawn", "4",
         "--batch_size", "2", "--checkpoint_dir", str(root / "fsdp"))
    _cli(*LM, "--batch_size", "4", "--checkpoint_dir", str(root / "one"))
    return root


def test_zero_cli_equals_ddp_with_jax_comm_bytes(cnn_runs):
    zero, ddp = _blob(cnn_runs / "zero"), _blob(cnn_runs / "ddp")
    assert zero["step"] == ddp["step"] == 4
    _assert_params_close(zero, ddp, atol=1e-5)
    tree = jax.eval_shape(JaxCNN().init, jax.random.key(0),
                          jnp.zeros((1, 28, 28, 1)))["params"]
    want = jz.zero_comm_bytes(jz.build_layout(tree, 2, bucket_mb=0.05),
                              2)["total"]
    records = [json.loads(line) for line in
               (cnn_runs / "zero.jsonl").read_text().splitlines()]
    steps = [r for r in records if r.get("kind") == "step"]
    assert steps and all(r["comm_bytes"] == want for r in steps)


def test_zero_bf16_cli_params_are_its_master_rounded(cnn_runs):
    """The bf16 gather over gloo (its bytes on the wire): the checkpoint's
    parameters are its fp32 master rounded to bf16, bit for bit, and
    track the fp32 gather's run."""
    bf16, zero = _blob(cnn_runs / "bf16"), _blob(cnn_runs / "zero")
    master = bf16["opt_state"]["master"]
    names = list(bf16["params"])
    assert len(master) == len(names)
    for k, m in zip(names, master):
        assert torch.equal(bf16["params"][k], m.bfloat16().float()), k
    _assert_params_close(bf16, zero, atol=1e-2)


ZERO = [*CNN, "--parallel", "zero"]
CNN_RESUMES = {  # name: (source run, the restoring trainer's flags, world)
    "zero2-to-zero1": ("zero", ZERO, 1),
    "zero2-to-zero4": ("zero", ZERO, 4),
    "zero2-to-ddp1": ("zero", CNN, 1),
    "ddp2-to-zero2": ("ddp", ZERO, 2),
}


@pytest.mark.parametrize("case", list(CNN_RESUMES))
def test_cnn_checkpoint_restores_bit_for_bit(cnn_runs, tmp_path, case):
    source, argv, world = CNN_RESUMES[case]
    _assert_bitwise(_resave(argv, cnn_runs / source, tmp_path, world),
                    _blob(cnn_runs / source))


def test_fsdp_cli_equals_world_1(lm_runs):
    fsdp, one = _blob(lm_runs / "fsdp"), _blob(lm_runs / "one")
    assert fsdp["step"] == one["step"] == 8
    _assert_params_close(fsdp, one, atol=1e-5)
    assert os.path.exists(lm_runs / "fsdp" / "lm_spec.json")


LM_RESUMES = {
    "fsdp2-to-world1": ("fsdp", [*LM, "--batch_size", "4"], 1),
    "world1-to-fsdp2": ("one", [*LM, "--batch_size", "2", "--mesh_fsdp", "2",
                                "--spawn", "2"], 2),
}


@pytest.mark.parametrize("case", list(LM_RESUMES))
def test_lm_checkpoint_restores_bit_for_bit(lm_runs, tmp_path, case):
    source, argv, world = LM_RESUMES[case]
    _assert_bitwise(_resave(argv, lm_runs / source, tmp_path, world),
                    _blob(lm_runs / source))
