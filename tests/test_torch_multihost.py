"""The multi-host flags of ``python -m ddp_tpu_torch.train``
(``--coordinator_address --num_processes --process_id``) ≡ the JAX
package's meaning, on the CPU: two processes started by hand, each with
its rank, meet at the address over gloo (``tests/test_multihost.py``'s
two-process pattern), and train what one process trains at the global
batch; a missing or inconsistent value raises before anything runs.
"""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

from ddp_tpu_torch.runtime.dist import free_port, multi_host_world
from ddp_tpu_torch.train.config import TrainConfig

REPO = Path(__file__).resolve().parents[1]
BASE = ["-m", "ddp_tpu_torch.train", "--device", "cpu", "--synthetic_data",
        "--synthetic_size", "256", "--epochs", "1", "--log_interval", "4"]


def test_two_hand_started_ranks_equal_world_1(tmp_path):
    """Rank 0 and rank 1 at batch 16 against one process at batch 32: the
    union of the two strided shards is the world-1 batch, so the
    parameters after one epoch agree to fp32 summation order (atol 1e-6,
    as ``test_spawn_2_over_gloo_equals_world_1``)."""
    address = f"localhost:{free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, *BASE, "--batch_size", "16", "--checkpoint_dir",
         str(tmp_path / "mh"), "--coordinator_address", address,
         "--num_processes", "2", "--process_id", str(r)],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    one = subprocess.run(
        [sys.executable, *BASE, "--batch_size", "32", "--checkpoint_dir",
         str(tmp_path / "w1")], cwd=REPO, capture_output=True, text=True,
        timeout=300)
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    assert one.returncode == 0, one.stderr[-3000:]
    rank0, rank1 = (o.strip().splitlines() for o, _ in outs)
    assert rank0[-1].startswith("final_accuracy=") and not rank1  # rank 0 logs
    assert sum(" done: 8 batches" in line for line in rank0) == 1
    a = torch.load(tmp_path / "w1/epoch_0/state.pt", weights_only=True)
    b = torch.load(tmp_path / "mh/epoch_0/state.pt", weights_only=True)
    assert a["step"] == b["step"] == 8
    for k in a["params"]:
        torch.testing.assert_close(b["params"][k], a["params"][k], atol=1e-6,
                                   rtol=0)


@pytest.mark.parametrize("flags,match", [
    (["--num_processes", "2"], "missing"),
    (["--process_id", "0"], "missing"),
    (["--coordinator_address", "h:1"], "missing"),
    (["--coordinator_address", "h:1", "--num_processes", "2"], "missing"),
    (["--coordinator_address", "nohost", "--num_processes", "2",
      "--process_id", "0"], "host:port"),
    (["--coordinator_address", "h:1", "--num_processes", "2",
      "--process_id", "2"], "outside the world"),
    (["--coordinator_address", "h:1", "--num_processes", "2",
      "--process_id", "-1"], "outside the world"),
    (["--coordinator_address", "h:1", "--num_processes", "0",
      "--process_id", "0"], "num_processes must be >= 1"),
    (["--coordinator_address", "h:1", "--num_processes", "2",
      "--process_id", "0", "--spawn", "2"], "--spawn"),
])
def test_inconsistent_flags_raise(flags, match):
    with pytest.raises(ValueError, match=match):
        TrainConfig.from_args(flags)


def test_resolution():
    assert multi_host_world(None, None, None) is None
    assert multi_host_world("10.0.0.2:8476", 4, 3) == ("10.0.0.2:8476", 4, 3)
    assert TrainConfig.from_args([]).multi_host() is None
