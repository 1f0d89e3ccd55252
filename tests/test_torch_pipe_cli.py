"""``python -m ddp_tpu_torch.train --model pipe_lm|pipe_vit --mesh_pipe S``:
the flags and guards, the checkpoint, and one run over processes.

- Each of the JAX trainer's pipe guards (``ddp_tpu/train/trainer.py:284-
  402``, ``:497-524``, ``:634-642``, ``:1653-1669``) is pinned by a case
  whose message is JAX's; each composition JAX's pipe family takes and the
  port's does not yet is refused naming ``ROADMAP A4.1b``; the ``dcn``
  axis names A4.2.
- A checkpoint of a pipe world holds the full stacked state (JAX's [S, …]
  and [v, S, …] layouts) gathered from the pipe ranks, and a world that
  restores it takes the next step to the same bits as the world that
  never stopped (in-process: ``runtime/dist.ThreadWorld``).
- One spawned run (``--spawn 2`` over gloo on the CPU, interleaved,
  pipe_lm): it trains, evaluates, logs the bubble fraction, writes
  ``--metrics_file``, and its checkpoint's ``to_dense_lm`` is a
  ``CausalLM`` whose logits are the pipeline's ``sequential_apply``
  (atol 2e-5).
"""

import json
import os

import numpy as np
import pytest
import torch

from ddp_tpu_torch.models import lm as tlm
from ddp_tpu_torch.models import pipeline_lm as tplm
from ddp_tpu_torch.models import pipeline_vit as tpv
from ddp_tpu_torch.parallel.ddp import TrainState
from ddp_tpu_torch.runtime.dist import ThreadWorld
from ddp_tpu_torch.runtime.mesh import Mesh, mesh_sizes, thread_mesh
from ddp_tpu_torch.train.checkpoint import CheckpointManager
from ddp_tpu_torch.train.config import TrainConfig
from ddp_tpu_torch.train.optim import make_optimizer

LM = ["--model", "pipe_lm", "--mesh_pipe", "2", "--spawn", "2"]
VIT = ["--model", "pipe_vit", "--mesh_pipe", "2", "--spawn", "2"]

# argv → a piece of JAX's message.
GUARDS = {
    "pipe_without_model": (["--model", "simple_cnn", "--mesh_pipe", "2",
                            "--spawn", "2"],
                           "--mesh_pipe cuts a model into stages, which only "
                           "the pipeline family has"),
    "one_stage": (["--model", "pipe_vit"], "needs --mesh_pipe >= 2 (a "
                  "1-stage pipeline is the plain step"),
    "zero1": (VIT + ["--zero1"], "not expert/seq/zero1, accumulation (use "
              "--num_microbatches)"),
    "accumulation": (LM + ["--grad_accum_steps", "2"],
                     "not zero1, accumulation (use --num_microbatches), "
                     "or augment"),
    "augment_lm": (LM + ["--augment", "flip"], ", or augment"),
    "vit_expert": (["--model", "pipe_vit", "--mesh_pipe", "2", "--spawn",
                    "4", "--mesh_expert", "2"],
                   "composes with the data axis, fsdp (ZeRO-sharded stage "
                   "params), tp (--mesh_model, PP×TP), augment"),
    "vit_seq": (VIT + ["--mesh_seq", "2", "--spawn", "4"],
                "--mesh_seq shards tokens, which only the sequence models"),
    "heads": (LM + ["--model_dim", "30"], "--num_heads 4 must be >= 1 and "
              "divide --model_dim 30"),
    "kv_heads_vit": (VIT + ["--num_kv_heads", "2"], "--num_kv_heads "
                     "(grouped-query attention) shrinks the causal LM's"),
    "virtual_without_pipe": (["--model", "simple_cnn", "--virtual_stages",
                              "2"], "--virtual_stages cuts a pipelined "
                             "model into chunks"),
    "virtual_without_interleaved": (LM + ["--virtual_stages", "2"],
                                    "only the interleaved schedule streams"),
    "microbatches_below_one": (LM + ["--num_microbatches", "0"],
                               "--num_microbatches must be >= 1, got 0"),
    "microbatches_not_multiple": (LM + ["--num_microbatches", "3"],
                                  "must be a multiple of --mesh_pipe 2"),
    "elastic": (LM + ["--elastic"], "--elastic excludes the in-graph "
                "pipeline family"),
    "parallel_zero": (LM + ["--parallel", "zero"], "--parallel zero "
                      "composes with the data axis only (the sharded "
                      "update scatters over it)"),
}
# The compositions of JAX's pipe family the port refuses until A4.1b.
LATER = {
    "fsdp_vit": ["--model", "pipe_vit", "--mesh_fsdp", "2"],
    "fsdp": LM + ["--mesh_fsdp", "2", "--spawn", "4"],
    "model": LM + ["--mesh_model", "2", "--spawn", "4"],
    "expert": LM + ["--mesh_expert", "2", "--spawn", "4"],
    "seq": LM + ["--mesh_seq", "2", "--spawn", "4"],
    "moe": LM + ["--moe_experts", "4"],
    "fast_epoch": VIT + ["--fast_epoch"],
}


@pytest.mark.parametrize("argv,match", list(GUARDS.values()), ids=list(GUARDS))
def test_guards_carry_jax_messages(argv, match):
    with pytest.raises(ValueError) as e:
        TrainConfig.from_args(argv)
    assert match in str(e.value)


@pytest.mark.parametrize("argv", list(LATER.values()), ids=list(LATER))
def test_compositions_refused_naming_a41b(argv):
    with pytest.raises(ValueError, match="ROADMAP A4.1b"):
        TrainConfig.from_args(argv)


def test_flags_parse_and_batch_guards():
    c = TrainConfig.from_args(LM + ["--pipe_schedule", "interleaved",
                                    "--virtual_stages", "2",
                                    "--num_microbatches", "8"])
    assert (c.mesh_pipe, c.pipe_schedule, c.virtual_stages,
            c.num_microbatches, c.mesh_axes) == (2, "interleaved", 2, 8, 2)
    assert not c.use_spmd
    with pytest.raises(ValueError, match="not divisible by "
                       "--num_microbatches 8"):
        c.check_pipe_batch(12, 1)
    with pytest.raises(ValueError, match="microbatch size 2 .* not divisible "
                       "by 4 data shards"):
        c.check_pipe_batch(16, 4)
    with pytest.raises(ValueError, match="ROADMAP A4.2"):
        Mesh({"dcn": 2, "data": 1}, 0)


def _world_steps(cfg, state, toks, ckdir, *, restore: bool, steps):
    """A pipe 2 world's ``steps`` 1F1B steps after saving (or, with
    ``restore``, restoring) epoch 0 → rank 0's gathered parameters and
    moments."""
    world = ThreadWorld(2, timeout=60)

    def body(r):
        mesh = thread_mesh(mesh_sizes(2, pipe=2), world, r)
        model = tplm.build_pipe_lm(cfg, state, mesh, "cpu")
        opt = make_optimizer(model.parameters(), "adam", lr=1e-2)
        opt.norm = model.shard_layout.norm
        st = TrainState(0, model, opt)
        step = tplm.make_pipe_lm_train_step(model, opt, mesh,
                                            schedule="1f1b")
        ck = CheckpointManager(ckdir, is_main=r == 0, async_save=False,
                               layout=model.shard_layout)
        if restore:
            assert ck.restore(st) == 0
        else:
            step(toks)
            st.step = opt.count
            ck.save(0, st)
        for _ in range(steps):
            step(toks)
        lay = model.shard_layout
        return (lay.gather({n: p.detach().clone()
                            for n, p in model.named_parameters()}),
                lay.gather(dict(zip(lay.names, opt.mu))), opt.count)

    return world.run(body)[0]


def test_checkpoint_holds_the_stacked_state_and_resumes_bit_for_bit(tmp_path):
    cfg = tplm.PipeLMConfig(vocab_size=64, seq_len=16, d_model=32,
                            num_heads=2, num_stages=2, num_microbatches=2)
    state = tplm.init_pipe_lm(cfg, seed=1)
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, 64, (4, 16)))
    ckdir = str(tmp_path / "ck")
    ran = _world_steps(cfg, state, toks, ckdir, restore=False, steps=1)
    blob = torch.load(os.path.join(ckdir, "epoch_0", "state.pt"),
                      weights_only=True)
    assert blob["step"] == 1
    assert set(blob["params"]) == set(state)
    for k, v in state.items():
        assert tuple(blob["params"][k].shape) == v.shape, k
    assert set(blob["opt_state"]["mu"]) == set(state)
    resumed = _world_steps(cfg, state, toks, ckdir, restore=True, steps=1)
    assert ran[2] == resumed[2] == 2
    for got, want in zip(resumed[:2], ran[:2]):
        for k in want:
            assert torch.equal(got[k], want[k]), k


def test_vit_checkpoint_layout_interleaved(tmp_path):
    cfg = tpv.PipeViTConfig(num_classes=10, patch_size=7, embed_dim=16,
                            num_heads=2, num_stages=2, virtual_stages=2,
                            num_microbatches=2)
    state = tpv.init_pipe_vit(cfg, seed=2, interleaved=True)
    world = ThreadWorld(2, timeout=60)

    def body(r):
        mesh = thread_mesh(mesh_sizes(2, pipe=2), world, r)
        model = tpv.build_pipe_vit(cfg, state, mesh, "cpu", interleaved=True)
        opt = make_optimizer(model.parameters(), "sgd", lr=0.1)
        ck = CheckpointManager(str(tmp_path / "v"), is_main=r == 0,
                               async_save=False, layout=model.shard_layout)
        ck.save(0, TrainState(0, model, opt))

    world.run(body)
    blob = torch.load(tmp_path / "v" / "epoch_0" / "state.pt",
                      weights_only=True)
    for k, v in state.items():  # [v, S, …] chunk-major, bit for bit
        np.testing.assert_array_equal(blob["params"][k].numpy(), v)


def test_cli_pipe_lm_interleaved_over_two_processes(tmp_path, capfd):
    """``main`` of the CLI in this process (its ranks spawned: the one
    process start-up saved is ~4 s of the test)."""
    from ddp_tpu_torch.train.trainer import main

    ck, metrics = tmp_path / "ck", tmp_path / "m.jsonl"
    assert main(LM + [
        "--device", "cpu", "--pipe_schedule", "interleaved",
        "--virtual_stages", "2", "--synthetic_size", "32", "--seq_len", "16",
        "--vocab_size", "64", "--model_dim", "32", "--num_heads", "2",
        "--batch_size", "8", "--epochs", "1", "--optimizer", "adam", "--lr",
        "1e-3", "--checkpoint_dir", str(ck), "--metrics_file",
        str(metrics)]) is None
    out = capfd.readouterr().out
    assert ("Pipeline LM: 2 stages × 2 virtual × 1 blocks, 4 microbatches, "
            "interleaved schedule, tp=1, bubble fraction 0.111") in out
    assert "final_accuracy=" in out
    kinds = [json.loads(line)["kind"] for line in open(metrics)]
    assert kinds[0] == "run_start" and "epoch" in kinds and \
        kinds[-1] == "final"
    params = torch.load(ck / "epoch_0" / "state.pt",
                        weights_only=True)["params"]
    assert tuple(params["stages.block1.attn.qkv.weight"].shape) == \
        (2, 2, 96, 32)
    cfg = tplm.PipeLMConfig(vocab_size=64, seq_len=16, d_model=32,
                            num_heads=2, num_stages=2, virtual_stages=2)
    spec, dense = tplm.to_dense_lm(cfg, params)
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, 64, (2, 16)))
    with torch.no_grad():
        got = tlm.CausalLM.from_state(spec, dense, "cpu")(toks)
    np.testing.assert_allclose(
        got.numpy(), tplm.sequential_apply(cfg, params, toks).numpy(),
        atol=2e-5)
