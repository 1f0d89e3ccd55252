"""``python -m ddp_tpu_torch.train --model pipe_lm|pipe_vit --mesh_pipe S``:
the flags and guards, the checkpoint, and one run over processes.

- Each of the JAX trainer's pipe guards (``ddp_tpu/train/trainer.py:251-
  402``, ``:497-524``, ``:600-642``, ``:1022-1045``, ``:1653-1669``, and
  ``pipeline_lm.py:187-194``'s TP×MoE rule) is pinned by a case whose
  message is JAX's; each composition JAX's pipe family takes parses to
  the composed config; the ``dcn`` axis names A4.2.
- A checkpoint of a pipe world holds the full stacked state (JAX's [S, …]
  and [v, S, …] layouts) gathered from every axis, and a world that
  restores it takes the next step to the same bits as the world that
  never stopped, at pipe 2 and at pipe 2 × model 2 (in-process:
  ``runtime/dist.ThreadWorld``); one written at pipe 2 × fsdp 2 restores
  at pipe 2 to the same full state.
- ``--fast_epoch``'s epoch runners drive the pipe steps: their losses
  are those of the step loop over the same rows, each data replica its
  own (pipe 2 × data 2).
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
LM4 = LM[:-1] + ["4"]
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
    "fsdp_vit_one_stage": (["--model", "pipe_vit", "--mesh_fsdp", "2"],
                           "needs --mesh_pipe >= 2"),
    "ring_1f1b": (LM4 + ["--mesh_seq", "2", "--pipe_schedule", "1f1b"],
                  "PP×SP under the hand-scheduled schedules (1f1b/"
                  "interleaved) needs --seq_strategy ulysses"),
    "ring_interleaved": (LM4 + ["--mesh_seq", "2", "--pipe_schedule",
                                "interleaved", "--virtual_stages", "2"],
                         "ring works under --pipe_schedule gpipe"),
    "tp_moe_1f1b": (LM4 + ["--mesh_model", "2", "--moe_experts", "4",
                           "--model_depth", "2", "--pipe_schedule", "1f1b"],
                    "the pipelined MoE-LM composes with tp under the GPipe "
                    "schedule only"),
    "moe_every": (LM + ["--moe_experts", "4"], "the pipelined MoE-LM needs "
                  "--moe_every (2) to divide --model_depth (1)"),
    "moe_vit": (VIT + ["--moe_experts", "4"], "--moe_experts routes the "
                "causal LM's MLPs: use --model causal_lm or pipe_lm"),
    "expert_without_experts": (LM4 + ["--mesh_expert", "2"],
                               "--mesh_expert shards MoE expert weights"),
    "experts_not_divisible": (LM4 + ["--mesh_expert", "2", "--moe_experts",
                                     "3", "--moe_every", "1"],
                              "--moe_experts 3 not divisible by "
                              "--mesh_expert 2"),
    "tp_heads_lm": (LM + ["--mesh_model", "3", "--spawn", "6"],
                    "tensor parallelism splits attention heads: "
                    "--num_heads 4 not divisible by --mesh_model 3"),
    "tp_heads_vit": (VIT + ["--mesh_model", "8", "--spawn", "16",
                            "--num_heads", "4"],
                     "--num_heads 4 not divisible by --mesh_model 8"),
    "tp_kv_heads": (LM4 + ["--mesh_model", "2", "--num_kv_heads", "1"],
                    "GQA under TP shards whole kv groups: --num_kv_heads 1 "
                    "not divisible by --mesh_model 2"),
    "ulysses_heads": (LM + ["--mesh_model", "2", "--mesh_seq", "4",
                            "--seq_strategy", "ulysses", "--spawn", "16"],
                      "ulysses shards attention heads: 2 heads per model "
                      "shard (4 total / --mesh_model 2) not divisible by "
                      "--mesh_seq 4"),
}
# Each composition of JAX's pipe family (pipe_lm and pipe_vit over fsdp and
# model, pipe_lm over expert with routed stages and over seq, fast_epoch)
# → the config fields it sets.
COMPOSED = {
    "fsdp_vit": (VIT + ["--mesh_fsdp", "2", "--spawn", "4"],
                 dict(mesh_fsdp=2, mesh_axes=4)),
    "fsdp": (LM4 + ["--mesh_fsdp", "2"], dict(mesh_fsdp=2, mesh_axes=4)),
    "model": (LM4 + ["--mesh_model", "2"], dict(mesh_model=2, mesh_axes=4)),
    "expert": (LM4 + ["--mesh_expert", "2", "--moe_experts", "4",
                      "--model_depth", "2"],
               dict(mesh_expert=2, moe_experts=4, mesh_axes=4)),
    "seq": (LM4 + ["--mesh_seq", "2"], dict(mesh_seq=2, mesh_axes=4)),
    "moe": (LM + ["--moe_experts", "4", "--model_depth", "2"],
            dict(moe_experts=4, moe_every=2)),
    "fast_epoch": (VIT + ["--fast_epoch"], dict(fast_epoch=True)),
}


@pytest.mark.parametrize("argv,match", list(GUARDS.values()), ids=list(GUARDS))
def test_guards_carry_jax_messages(argv, match):
    with pytest.raises(ValueError) as e:
        TrainConfig.from_args(argv)
    assert match in str(e.value)


@pytest.mark.parametrize("argv,fields", list(COMPOSED.values()),
                         ids=list(COMPOSED))
def test_compositions_parse_to_the_composed_config(argv, fields):
    config = TrainConfig.from_args(argv)
    assert config.pipe_mode and not config.use_spmd
    for name, value in fields.items():
        assert getattr(config, name) == value, name


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


def _world_steps(cfg, state, toks, ckdir, *, restore: bool, steps,
                 axes=None):
    """A pipe world's (``axes``, default pipe 2) ``steps`` 1F1B steps
    after saving (or, with ``restore``, restoring) epoch 0 → rank 0's
    gathered parameters and moments."""
    axes = axes or dict(pipe=2)
    n = int(np.prod(list(axes.values())))
    world = ThreadWorld(n, timeout=60)

    def body(r):
        mesh = thread_mesh(mesh_sizes(n, **axes), world, r)
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


def test_resume_bit_for_bit_at_pipe_2_model_2(tmp_path):
    cfg = tplm.PipeLMConfig(vocab_size=64, seq_len=16, d_model=32,
                            num_heads=4, num_stages=2, num_microbatches=2,
                            tp_size=2)
    state = tplm.init_pipe_lm(cfg, seed=4)
    toks = torch.from_numpy(np.random.default_rng(4).integers(0, 64, (4, 16)))
    axes = dict(pipe=2, model=2)
    ckdir = str(tmp_path / "ck")
    ran = _world_steps(cfg, state, toks, ckdir, restore=False, steps=1,
                       axes=axes)
    blob = torch.load(os.path.join(ckdir, "epoch_0", "state.pt"),
                      weights_only=True)
    for k, v in state.items():  # the full stacked state, uncut
        assert tuple(blob["params"][k].shape) == v.shape, k
    resumed = _world_steps(cfg, state, toks, ckdir, restore=True, steps=1,
                           axes=axes)
    assert ran[2] == resumed[2] == 2
    for got, want in zip(resumed[:2], ran[:2]):
        for k in want:
            assert torch.equal(got[k], want[k]), k


def _vit_world(cfg, state, axes, fn):
    """``fn(rank, model, optimizer, mesh)`` on every rank of a pipe_vit
    world over ``axes`` → the results by rank."""
    n = int(np.prod(list(axes.values())))
    world = ThreadWorld(n, timeout=60)

    def body(r):
        mesh = thread_mesh(mesh_sizes(n, **axes), world, r)
        model = tpv.build_pipe_vit(cfg, state, mesh, "cpu")
        opt = make_optimizer(model.parameters(), "adam", lr=1e-2)
        return fn(r, model, opt, mesh)

    return world.run(body)


def test_fsdp_checkpoint_restores_at_another_mesh(tmp_path):
    """A checkpoint written at pipe 2 × fsdp 2 (its stage leaves rest cut
    over fsdp) holds the full state, and a pipe 2 world restores it to
    that state, moments included."""
    cfg = tpv.PipeViTConfig(num_classes=10, patch_size=7, embed_dim=64,
                            num_heads=4, num_stages=2, num_microbatches=2)
    state = tpv.init_pipe_vit(cfg, seed=5)
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.integers(0, 256, (4, 28, 28, 1), dtype=np.uint8))
    y = torch.from_numpy(rng.integers(0, 10, 4))
    ckdir = str(tmp_path / "ck")

    def save(r, model, opt, mesh):
        lay = model.shard_layout
        assert lay.axes("chunks.0.block1.mlp1.weight") == {"fsdp"}
        step = tpv.make_pipe_vit_train_step(model, opt, mesh,
                                            schedule="1f1b")
        b = x.shape[0] // mesh.data_size
        step(x[mesh.data_rank * b:][:b], y[mesh.data_rank * b:][:b])
        ck = CheckpointManager(ckdir, is_main=r == 0, async_save=False,
                               layout=lay)
        ck.save(0, TrainState(int(opt.count), model, opt))
        return lay.gather({n: p.detach().clone()
                           for n, p in model.named_parameters()})

    saved = _vit_world(cfg, state, dict(pipe=2, fsdp=2), save)[0]
    blob = torch.load(os.path.join(ckdir, "epoch_0", "state.pt"),
                      weights_only=True)
    for k, v in state.items():
        assert tuple(blob["params"][k].shape) == v.shape, k
        assert torch.equal(blob["params"][k], saved[k]), k

    def restore(r, model, opt, mesh):
        st = TrainState(0, model, opt)
        CheckpointManager(ckdir, is_main=r == 0,
                          layout=model.shard_layout).restore(st)
        lay = model.shard_layout
        return (st.step, lay.gather({n: p.detach().clone()
                                     for n, p in model.named_parameters()}),
                lay.gather(dict(zip(lay.names, opt.mu))))

    step, params, mu = _vit_world(cfg, state, dict(pipe=2), restore)[0]
    assert step == 1
    for k in state:
        assert torch.equal(params[k], blob["params"][k]), k
        assert torch.equal(mu[k], blob["opt_state"]["mu"][k]), k


@pytest.mark.parametrize("family", ["pipe_lm", "pipe_vit"])
def test_fast_epoch_losses_equal_the_step_loop(family):
    """``--fast_epoch``'s runners (``train/fast``: the LM's, and the image
    one's with ``step=``) drive the pipe step over each data replica's
    rows of the epoch's plan: their losses are the step loop's over the
    same rows, bit for bit (pipe 2 × data 2, 2 steps)."""
    from ddp_tpu_torch.data.sampler import default_permutation
    from ddp_tpu_torch.train.fast import (
        make_epoch_runner,
        make_lm_epoch_runner,
    )

    rng = np.random.default_rng(6)
    G, world = 8, ThreadWorld(4, timeout=60)
    if family == "pipe_lm":
        cfg = tplm.PipeLMConfig(vocab_size=64, seq_len=16, d_model=32,
                                num_heads=4, num_stages=2, num_microbatches=2)
        state = tplm.init_pipe_lm(cfg, seed=6)
        data = (torch.from_numpy(rng.integers(0, 64, (16, 16))),)
    else:
        cfg = tpv.PipeViTConfig(num_classes=10, patch_size=7, embed_dim=32,
                                num_heads=4, num_stages=2, num_microbatches=2)
        state = tpv.init_pipe_vit(cfg, seed=6)
        data = (torch.from_numpy(rng.integers(0, 256, (16, 28, 28, 1),
                                              dtype=np.uint8)),
                torch.from_numpy(rng.integers(0, 10, 16)))

    def body(r, fast):
        mesh = thread_mesh(mesh_sizes(4, pipe=2), world, r)
        build, make = ((tplm.build_pipe_lm, tplm.make_pipe_lm_train_step)
                       if family == "pipe_lm" else
                       (tpv.build_pipe_vit, tpv.make_pipe_vit_train_step))
        model = build(cfg, state, mesh, "cpu")
        opt = make_optimizer(model.parameters(), "adam", lr=1e-2)
        step = make(model, opt, mesh, schedule="1f1b")
        me, n = mesh.data_rank, mesh.data_size
        if fast and family == "pipe_lm":
            return make_lm_epoch_runner(model, opt, data[0], G, rank=me,
                                        world=n, step=step)(0).loss
        if fast:
            return make_epoch_runner(None, *data, G, rank=me, world=n,
                                     step=step)(0).loss
        perm = default_permutation(16, 0)(0)
        losses = []
        for t in range(2):
            rows = perm[t * G:(t + 1) * G]
            rows = (rows[me::n] if family == "pipe_lm"
                    else rows[me * G // n:][:G // n])
            losses.append(step(*(d[rows] for d in data)).loss)
        return torch.stack(losses)

    fast = world.run(lambda r: body(r, True))
    loop = world.run(lambda r: body(r, False))
    for a, b in zip(fast, loop):
        assert a.shape == (2,) and torch.equal(a, b)


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
