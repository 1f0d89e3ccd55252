"""The port's mesh over ranks and the sequence models' CLI across ranks,
on the CPU.

- ``runtime/mesh.Mesh`` places every rank where JAX's ``make_mesh``
  places the device of the same index (8 CPU devices), for each spec
  over 1, 2, 4 and 8 ranks.
- ``models/lm.shard_targets`` over a ``seq`` ring of 2 and 4 equals the
  world-1 shift: each shard's last position targets the next shard's
  first token, and only the last global position has weight 0.
- ``runtime/dist.DistComm`` over two gloo processes (all-reduce,
  all-gather, all-to-all, the ring shift) gives what the in-process
  communicator gives.
- ``python -m ddp_tpu_torch.train --model causal_lm --mesh_seq 2 --spawn
  2 --device cpu`` against world 1 on the same global batch: the
  checkpointed parameters (atol 2e-5, tests/test_torch_lm_world.py's)
  and the test metrics.
- A checkpoint written at ``--mesh_model 2`` holds the full state and
  restores at world 1, and one written at world 1 restores at
  ``--mesh_model 2`` (the optimizer's buffers too), bit for bit; the CLI
  resumes across the two.
"""

import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from ddp_tpu.runtime.mesh import MeshSpec, make_mesh
from ddp_tpu_torch.models import lm as tlm
from ddp_tpu_torch.parallel.tp import shard_module
from ddp_tpu_torch.runtime import dist as tdist
from ddp_tpu_torch.runtime.mesh import Mesh, mesh_sizes, thread_mesh
from ddp_tpu_torch.train.checkpoint import CheckpointManager
from ddp_tpu_torch.train.optim import make_optimizer
from ddp_tpu_torch.train.trainer import main as train_main

ATOL = 2e-5
REPO = Path(__file__).resolve().parent.parent

SPECS = [dict(), dict(seq=2), dict(model=2), dict(expert=2),
         dict(seq=2, model=2), dict(expert=2, seq=2), dict(seq=4),
         dict(model=4), dict(seq=2, model=2, expert=2), dict(seq=8),
         dict(expert=2, model=4), dict(seq=4, model=2)]


@pytest.mark.parametrize("world", [1, 2, 4, 8])
def test_rank_coordinates_equal_make_mesh(world):
    """Every spec that tiles the world: the rank at each mesh coordinate
    is the index of the device JAX's make_mesh puts there."""
    devices = jax.devices()[:world]
    for axes in SPECS:
        if world % int(np.prod(list(axes.values()) or [1])):
            continue
        jmesh = make_mesh(MeshSpec(data=-1, **axes), devices=devices)
        port = Mesh(mesh_sizes(world, **axes), 0)
        assert tuple(port.shape.values()) == tuple(jmesh.devices.shape)
        for idx in np.ndindex(jmesh.devices.shape):
            coords = dict(zip(jmesh.axis_names, idx))
            assert port.rank_of(coords) == jmesh.devices[idx].id
            assert port.coords_of(jmesh.devices[idx].id) == coords


@pytest.mark.parametrize("n", [2, 4])
def test_shifted_targets_across_shards(n):
    """The ring exchange of the targets: concatenated over the shards they
    are the world-1 targets and weights (the last global position alone
    has weight 0)."""
    tokens = torch.from_numpy(
        np.random.default_rng(0).integers(0, 50, (3, 16)))
    want_t, want_m = tlm._shifted_targets(tokens)
    world = tdist.ThreadWorld(n, timeout=30)

    def body(r):
        mesh = thread_mesh(mesh_sizes(n, seq=n), world, r)
        return tlm.shard_targets(mesh.seq_shard(tokens), mesh.comm("seq"))

    got = world.run(body)
    mask = torch.cat([m for _, m in got])
    assert torch.equal(mask, want_m)
    # The last position's target (the ring wraps, as JAX's ppermute does)
    # has weight 0: every weighted target is world 1's.
    assert torch.equal(torch.cat([t for t, _ in got], 1) * mask.long(),
                       want_t * want_m.long())
    assert float(torch.cat([m for _, m in got]).sum()) == 15


def _collectives(rank, port, out):
    """One gloo rank: each collective of DistComm on a known tensor."""
    tdist.setup(rank, 2, backend="gloo", device="cpu")
    try:
        import torch.distributed as d

        comm = tdist.DistComm([0, 1], d.group.WORLD, rank)
        x = torch.arange(8.0).reshape(2, 4) + 10 * rank
        res = [comm.all_reduce_(x.clone()), comm.all_gather(x, 1),
               comm.all_to_all(x, 1, 0), comm.shift(x, 1),
               comm.shift(x, -1)]
        torch.save(res, f"{out}/rank{rank}.pt")
    finally:
        tdist.cleanup()


def test_dist_comm_over_gloo_equals_the_thread_comm(tmp_path, monkeypatch):
    """Two gloo processes through DistComm: every collective gives what
    the in-process ThreadComm gives on the same tensors."""
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", str(tdist.free_port()))
    mp.spawn(_collectives, args=(None, str(tmp_path)), nprocs=2, join=True)
    world = tdist.ThreadWorld(2, timeout=30)

    def body(r):
        comm = world.comm([0, 1], r)
        x = torch.arange(8.0).reshape(2, 4) + 10 * r
        return [comm.all_reduce_(x.clone()), comm.all_gather(x, 1),
                comm.all_to_all(x, 1, 0), comm.shift(x, 1), comm.shift(x, -1)]

    want = world.run(body)
    for r in (0, 1):
        got = torch.load(tmp_path / f"rank{r}.pt", weights_only=True)
        for g, w in zip(got, want[r]):
            assert torch.equal(g, w)


CLI = [sys.executable, "-m", "ddp_tpu_torch.train", "--device", "cpu",
       "--model", "causal_lm", "--seq_len", "16", "--vocab_size", "32",
       "--model_dim", "32", "--num_heads", "2", "--optimizer", "sgd",
       "--lr", "0.5", "--momentum", "0.9", "--synthetic_size", "24",
       "--batch_size", "8"]


def _state(path):
    return torch.load(path, weights_only=True)


def _max_diff(a, b):
    return max(float((a[k] - b[k]).abs().max()) for k in a)


def _spawn(*args):
    res = subprocess.run(CLI + list(args), cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    return res.stdout


def test_cli_mesh_seq_2_equals_world_1(tmp_path, capsys):
    """--mesh_seq 2 --spawn 2 (one data replica of batch 8, each rank 8
    tokens of every sequence) against world 1 (batch 8): the same
    checkpointed parameters and step count, the same final test
    metrics."""
    out2 = _spawn("--epochs", "1", "--mesh_seq", "2", "--spawn", "2",
                  "--checkpoint_dir", str(tmp_path / "s2"))
    train_main(CLI[3:] + ["--epochs", "1", "--checkpoint_dir",
                          str(tmp_path / "w1")])
    out1 = capsys.readouterr().out
    a = _state(tmp_path / "w1/epoch_0/state.pt")
    b = _state(tmp_path / "s2/epoch_0/state.pt")
    assert a["step"] == b["step"] == 3
    assert _max_diff(a["params"], b["params"]) <= ATOL
    finals = [line for text in (out1, out2) for line in text.splitlines()
              if line.startswith("final_accuracy=")]
    assert len(finals) == 2 and finals[0] == finals[1]


def _sharded_pair(sizes, world, state, rank):
    mesh = thread_mesh(sizes, world, rank)
    model = tlm.CausalLM.from_state(SPEC, state, "cpu", trainable=True)
    layout = shard_module(model, mesh)
    opt = make_optimizer(model.parameters(), "adam", lr=1e-2)
    opt.norm = layout.norm
    return mesh, model, layout, opt


SPEC = tlm.LMSpec(vocab_size=32, total_len=16, d_model=32, depth=2,
                  num_heads=2)


def test_checkpoints_cross_meshes_bit_for_bit(tmp_path):
    """Written at --mesh_model 2 (two ranks in threads, one Adam step so
    the moments are live): the file holds the full state, which restores
    at world 1 exactly; and restored back at --mesh_model 2, every
    rank's shards and moments are the ones it saved, bit for bit."""
    tokens = torch.from_numpy(
        np.random.default_rng(0).integers(0, 32, (4, 16)))
    full = tlm.init_lm_state(SPEC, seed=0)
    sizes = mesh_sizes(2, model=2)
    world = tdist.ThreadWorld(2, timeout=30)
    ckdir = str(tmp_path / "m2")

    def save(r):
        mesh, model, layout, opt = _sharded_pair(sizes, world, full, r)
        tlm.make_lm_train_step(model, opt, mesh=mesh)(tokens)
        mgr = CheckpointManager(ckdir, is_main=r == 0, layout=layout)
        from ddp_tpu_torch.parallel.ddp import TrainState

        mgr.save(0, TrainState(1, model, opt))
        mgr.wait()
        return ({k: v.clone() for k, v in model.state_dict().items()},
                opt.state_dict())

    saved = world.run(save)
    blob = _state(f"{ckdir}/epoch_0/state.pt")
    assert blob["params"]["block1.attn.qkv.weight"].shape == (96, 32)
    one = tlm.CausalLM.from_state(SPEC, full, "cpu", trainable=True)
    opt1 = make_optimizer(one.parameters(), "adam", lr=1e-2)
    from ddp_tpu_torch.parallel.ddp import TrainState

    CheckpointManager(ckdir).restore(TrainState(0, one, opt1))
    for k, v in one.state_dict().items():
        assert torch.equal(v, blob["params"][k])
    assert all(torch.equal(a, b) for a, b in
               zip(opt1.state_dict()["mu"], blob["opt_state"]["mu"]))

    def restore(r):
        mesh, model, layout, opt = _sharded_pair(sizes, world, full, r)
        CheckpointManager(ckdir, is_main=r == 0, layout=layout).restore(
            TrainState(0, model, opt))
        return model.state_dict(), opt.state_dict()

    for (p, o), (sp, so) in zip(world.run(restore), saved):
        assert all(torch.equal(p[k], sp[k]) for k in p)
        assert all(torch.equal(a, b) for a, b in zip(o["nu"], so["nu"]))


@pytest.mark.parametrize("writer", ["world1", "model2"])
def test_cli_resumes_across_meshes(tmp_path, capsys, writer):
    """World 1 writes epoch 0 and --mesh_model 2 resumes it to epoch 1, or
    the other way round: the result equals a world-1 run of two epochs
    (atol 2e-5)."""
    train_main(CLI[3:] + ["--epochs", "2", "--checkpoint_dir",
                          str(tmp_path / "ref")])
    ckdir = str(tmp_path / "run")
    mesh = ["--mesh_model", "2", "--spawn", "2"]
    if writer == "world1":
        train_main(CLI[3:] + ["--epochs", "1", "--checkpoint_dir", ckdir])
        text = _spawn("--epochs", "2", "--checkpoint_dir", ckdir, *mesh)
    else:
        _spawn("--epochs", "1", "--checkpoint_dir", ckdir, *mesh)
        capsys.readouterr()
        train_main(CLI[3:] + ["--epochs", "2", "--checkpoint_dir", ckdir])
        text = capsys.readouterr().out
    assert "Resumed from checkpoint epoch 0" in text
    got = _state(f"{ckdir}/epoch_1/state.pt")["params"]
    ref = _state(tmp_path / "ref/epoch_1/state.pt")["params"]
    assert _max_diff(got, ref) <= ATOL
