"""Elastic world resize in ddp_tpu_torch, on the CPU: the twins of
``tests/test_elastic.py``'s data-parallel tests.

- The shrink/grow grammar round-trips and the supervisor classifies the
  elastic exit codes.
- The shard math keeps the global batch: the port's per-rank rescale
  equals JAX's, and one step's sample window is the same at any divisor
  world.
- ``elastic.json`` is written once; the port's file is read by JAX's
  ``load_elastic_contract`` and JAX's by the port's.
- The supervisor's and the CLI's guards.
- The drills in real gloo worlds: ``shrink:rank1@step12`` at world 2
  finishes at world 1 with the global batch kept, close to an
  uninjected world-1 run, one ``run_start`` a generation; shrink then
  ``grow:+1@epoch1`` restores world 2.
"""

import json
import os

import numpy as np
import pytest
import torch

from ddp_tpu.data.sampler import rescale_per_shard_batch as jax_rescale
from ddp_tpu.train import checkpoint as jck
from ddp_tpu_torch.data.sampler import ShardSampler, rescale_per_shard_batch
from ddp_tpu_torch.runtime import dist, launch
from ddp_tpu_torch.runtime.chaos import ChaosEvent, format_chaos, parse_chaos
from ddp_tpu_torch.train import checkpoint as ck
from ddp_tpu_torch.train.config import TrainConfig
from ddp_tpu_torch.train.trainer import ImageTrainer
from ddp_tpu_torch.train.trainer import main as train_main


def test_shrink_grow_grammar_roundtrip():
    spec = "shrink:rank1@step12,grow:+1@epoch2,shrink:rank0@epoch1"
    ev = parse_chaos(spec)
    assert [e.kind for e in ev] == ["shrink", "grow", "shrink"]
    assert ev[0] == ChaosEvent(kind="shrink", rank=1, step=12)
    assert ev[1] == ChaosEvent(kind="grow", epoch=2)
    assert format_chaos(ev) == spec


def test_classify_exit_elastic_codes():
    assert "shrink" in launch.classify_exit(launch.SHRINK_EXIT_CODE)
    assert "grow" in launch.classify_exit(launch.GROW_EXIT_CODE)


@pytest.mark.parametrize("args", [(8, 1, 1), (8, 2, 1), (8, 2, 2),
                                  (8, 3, 1), (2, 2, 2), (48, 4, 3)])
def test_rescale_per_shard_batch_equals_jax(args):
    g, shards, accum = args
    try:
        want = jax_rescale(g, shards, grad_accum_steps=accum)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            rescale_per_shard_batch(g, shards, grad_accum_steps=accum)
        assert str(got.value) == str(e)
    else:
        assert rescale_per_shard_batch(g, shards, grad_accum_steps=accum) \
            == want


def test_step_sample_windows_identical_across_worlds():
    """Shard r of N takes ``indices[r::N]``: one step's union of per-rank
    slices is the same window of the epoch's permutation at any divisor
    world (what the rescale rests on)."""
    n, G = 64, 8
    for epoch in (0, 1, 5):
        one = ShardSampler(num_examples=n, num_shards=1, shard_id=0,
                           seed=3).shard_indices(epoch)
        for world in (2, 4):
            b = G // world
            shards = [ShardSampler(num_examples=n, num_shards=world,
                                   shard_id=r, seed=3).shard_indices(epoch)
                      for r in range(world)]
            for k in range(n // G):
                union = set()
                for s in shards:
                    union |= set(s[k * b:(k + 1) * b].tolist())
                assert union == set(one[k * G:(k + 1) * G].tolist())


def test_elastic_contract_write_once_and_across_packages(tmp_path):
    d = str(tmp_path / "port")
    assert ck.load_elastic_contract(d) == {}
    assert ck.save_elastic_contract(d, global_batch_size=8, world_size=2)
    assert ck.save_elastic_contract(d, global_batch_size=4,
                                    world_size=1) is None
    assert ck.load_elastic_contract(d) == {"global_batch_size": 8,
                                           "world_size": 2}
    assert jck.load_elastic_contract(d) == ck.load_elastic_contract(d)
    j = str(tmp_path / "jax")
    jck.save_elastic_contract(j, global_batch_size=24, world_size=3)
    assert ck.load_elastic_contract(j) == {"global_batch_size": 24,
                                           "world_size": 3}
    assert ck.save_elastic_contract(j, global_batch_size=8,
                                    world_size=1) is None


def test_cli_elastic_guards():
    with pytest.raises(ValueError, match="min_world"):
        TrainConfig.from_args(["--min_world", "2"])
    with pytest.raises(ValueError, match="min_world"):
        TrainConfig.from_args(["--spawn", "2", "--elastic", "--min_world",
                               "3"])
    with pytest.raises(ValueError, match="elastic"):
        TrainConfig.from_args(["--model", "pipe_vit", "--elastic"])
    with pytest.raises(ValueError, match="min_world"):
        launch.spawn(lambda r, w: None, 2, min_world=0)


def _elastic_worker(rank, world, ckdir, data, out, chaos):
    """One rank, --batch_size 4 in every generation: the contract is what
    rescales it."""
    torch.set_num_threads(1)
    argv = ["--device", "cpu", "--synthetic_data", "--synthetic_size", "64",
            "--batch_size", "4", "--epochs", "2", "--log_interval", "4",
            "--eval_every", "0", "--checkpoint_dir", ckdir, "--data_root",
            data, "--chaos", chaos, "--elastic",
            "--metrics_file", os.path.join(out, "metrics.jsonl")]
    config = TrainConfig.from_args(argv)
    ctx = dist.setup(rank, world, device="cpu")
    try:
        trainer = ImageTrainer(config, ctx)
        summary = trainer.train()
    finally:
        dist.cleanup()
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump({"world": world, "loss": summary["final_loss"],
                   "acc": summary["final_accuracy"],
                   "step": trainer.state.step,
                   "global_batch": trainer.global_batch_size,
                   "per_shard": trainer.per_shard_batch}, f)


def _records(out, kind):
    return [json.loads(line) for line in open(out / "metrics.jsonl")
            if f'"{kind}"' in line]


@pytest.mark.slow  # two generations of spawned ranks: ~23 s on the CPU
def test_spawn_shrink_drill_completes_at_world1(tmp_path):
    """Rank 1 is permanently lost at step 12 (epoch 1 of 8-step epochs):
    the supervisor resizes without the restart budget, the survivor
    resumes epoch 0's checkpoint at the kept global batch 8 (per-rank 4
    → 8), completes 16 steps, and lands close to an uninjected world-1
    run (epoch 0 differed only in summation order)."""
    out = tmp_path / "out"
    out.mkdir()
    ckdir, events = str(tmp_path / "ck"), []
    restarts = launch.spawn(
        _elastic_worker, 2, (ckdir, str(tmp_path / "data"), str(out),
                             "shrink:rank1@step12"),
        timeout=300, grace=1.0, max_restarts=0, restart_backoff=0.1,
        elastic=True, min_world=1, events_out=events)
    assert restarts == 0
    assert [e["kind"] for e in events] == ["resize"]
    assert (events[0]["old_world"], events[0]["new_world"],
            events[0]["shrunk_ranks"]) == (2, 1, [1])
    got = json.loads((out / "rank0.json").read_text())
    assert (got["world"], got["step"], got["global_batch"],
            got["per_shard"]) == (1, 16, 8, 8)
    ref = train_main(["--device", "cpu", "--synthetic_data",
                      "--synthetic_size", "64", "--batch_size", "8",
                      "--epochs", "2", "--eval_every", "0",
                      "--checkpoint_dir", str(tmp_path / "ref"),
                      "--data_root", str(tmp_path / "data")])
    assert np.isclose(got["acc"], ref.summary["final_accuracy"], atol=1e-3)
    assert np.isclose(got["loss"], ref.summary["final_loss"], rtol=1e-3)
    starts = _records(out, "run_start")
    assert [s["data_shards"] for s in starts] == [2, 1]
    assert [s["restarts"] for s in starts] == [0, 1]
    assert starts[1]["prev_data_shards"] == 2
    assert all(s["global_batch_size"] == 8 for s in starts)
    assert ck.load_elastic_contract(ckdir) == {"global_batch_size": 8,
                                               "world_size": 2}
    assert json.loads((tmp_path / "ck" / "chaos_ledger.rank1.json")
                      .read_text()) == {"fired": ["shrink:rank1@step12"]}


@pytest.mark.slow  # three generations of spawned ranks: ~34 s on the CPU
def test_spawn_shrink_then_grow_restores_world(tmp_path):
    out = tmp_path / "out"
    out.mkdir()
    events = []
    restarts = launch.spawn(
        _elastic_worker, 2, (str(tmp_path / "ck"), str(tmp_path / "data"),
                             str(out), "shrink:rank1@step4,grow:+1@epoch1"),
        timeout=300, grace=1.0, max_restarts=0, restart_backoff=0.1,
        elastic=True, min_world=1, events_out=events)
    assert restarts == 0
    assert [(e["old_world"], e["new_world"]) for e in events] == [(2, 1),
                                                                  (1, 2)]
    got = [json.loads((out / f"rank{r}.json").read_text()) for r in (0, 1)]
    assert all(g["world"] == 2 and g["step"] == 16 and g["per_shard"] == 4
               for g in got)
    assert [s["data_shards"] for s in _records(out, "run_start")] == [2, 1, 2]
