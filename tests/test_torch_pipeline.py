"""The port's pipeline machinery (``ddp_tpu_torch/parallel/{pipeline,
one_f1b,interleaved,pipe_common}.py``) against the JAX package's.

- The timetables: ``schedule_1f1b`` and ``schedule_interleaved`` equal
  JAX's entry for entry over a grid of (S, M, v), with their bubble
  fractions and the interleaved stash and ring depths; GPipe's table
  runs every (microbatch, stage) forward and backward once, idle
  (S−1)/(M+S−1) of the time, JAX's ``bubble_fraction``; 1F1B's stash
  holds at most S − d inputs on stage d whatever M is.
- The strided microbatch split and merge equal JAX's on the same array.
- The point-to-point exchange: two members that send to each other in
  one call do not deadlock, and a receive with no sender fails within
  the world's timeout instead of hanging.
- ``PipeLayout``: a rank's chunks are the JAX device slice of its index
  of the stacked [S, …] / [v, S, …] state, and gathering them gives the
  state back bit for bit; a rank's end leaves count once in the norm.
- ``interop/jax_params``: both families' states, either layout, go to
  JAX's tree and back bit for bit.

Exact (integer tables, bitwise copies) except the norm (rtol 1e-6).
"""

import numpy as np
import pytest
import torch

from ddp_tpu.parallel import interleaved as jinter
from ddp_tpu.parallel import one_f1b as jf1b
from ddp_tpu.parallel import pipe_common as jcommon
from ddp_tpu.parallel.pipeline import bubble_fraction as jax_bubble
from ddp_tpu_torch.interop.jax_params import (
    pipe_params_from_jax,
    pipe_params_to_jax,
)
from ddp_tpu_torch.models import pipeline_lm as tplm
from ddp_tpu_torch.models import pipeline_vit as tpv
from ddp_tpu_torch.parallel import interleaved as tinter
from ddp_tpu_torch.parallel import one_f1b as tf1b
from ddp_tpu_torch.parallel import pipe_common as tcommon
from ddp_tpu_torch.parallel import pipeline as tpipe
from ddp_tpu_torch.runtime.dist import ThreadWorld
from ddp_tpu_torch.runtime.mesh import mesh_sizes, thread_mesh

GRID_1F1B = sorted({(S, M) for S in (2, 3, 4) for M in (S, 2 * S, 8, 12)
                    if M % S == 0})
GRID_INTER = sorted({(S, M, V) for S in (2, 4) for M in (S, 2 * S, 8)
                     for V in (1, 2, 3) if M % S == 0})


def _stash_depth(schedule, stage: int) -> int:
    """The most stage inputs ``stage`` holds at once under a 1F1B table
    (0 at stage 0, which re-reads its raw microbatch)."""
    if stage == 0:
        return 0
    held = most = 0
    for op in schedule.op[:, stage]:
        held += 1 if op == tpipe.FWD else -1 if op == tpipe.BWD else 0
        most = max(most, held)
    return most


@pytest.mark.parametrize("S,M", GRID_1F1B)
def test_1f1b_table_equals_jax(S, M):
    want, got = jf1b.schedule_1f1b(S, M), tf1b.schedule_1f1b(S, M)
    np.testing.assert_array_equal(got.op, np.asarray(want.op))
    np.testing.assert_array_equal(got.mb, np.asarray(want.mb))
    assert got.bubble_fraction() == want.bubble_fraction()
    assert got.bubble_fraction() == pytest.approx(jax_bubble(S, M))
    for d in range(S):  # the O(S) stash, whatever M is
        assert _stash_depth(got, d) == (0 if d == 0 else min(S - d, M))


@pytest.mark.parametrize("S,M,V", GRID_INTER)
def test_interleaved_table_equals_jax(S, M, V):
    want = jinter.schedule_interleaved(S, M, V)
    got = tinter.schedule_interleaved(S, M, V)
    for field in ("op", "mb", "ck"):
        np.testing.assert_array_equal(getattr(got, field),
                                      np.asarray(getattr(want, field)))
    assert (got.stash_depth, got.ring_depth, got.virtual_stages) == (
        want.stash_depth, want.ring_depth, want.virtual_stages)
    assert got.bubble_fraction() == want.bubble_fraction()
    assert tinter._device_op_sequence(S, M, V) == \
        jinter._device_op_sequence(S, M, V)


def test_schedules_refuse_bad_shapes():
    with pytest.raises(ValueError, match="divisible"):
        tinter.schedule_interleaved(2, 3, 2)
    with pytest.raises(ValueError, match=">= 2 stages"):
        tinter.schedule_interleaved(1, 4, 2)


@pytest.mark.parametrize("S,M", [(2, 4), (3, 3), (4, 8)])
def test_gpipe_table(S, M):
    op, mb = tpipe.schedule_gpipe(S, M)
    for d in range(S):
        for kind in (tpipe.FWD, tpipe.BWD):
            assert sorted(mb[op[:, d] == kind, d]) == list(range(M))
    # Every backward after its stage's forward and its successor's.
    t_of = {(int(op[t, d]), int(mb[t, d]), d): t
            for t in range(op.shape[0]) for d in range(S) if op[t, d]}
    for m in range(M):
        for d in range(S):
            assert t_of[(tpipe.BWD, m, d)] > t_of[(tpipe.FWD, m, S - 1)]
            if d < S - 1:
                assert t_of[(tpipe.BWD, m, d)] > t_of[(tpipe.BWD, m, d + 1)]
    assert (op == tpipe.IDLE).mean() == pytest.approx(jax_bubble(S, M))
    assert tpipe.bubble_fraction(S, M) == jax_bubble(S, M)


def test_microbatch_split_and_merge_equal_jax():
    x = np.arange(24 * 3).reshape(24, 3)
    for M, S in ((4, 2), (6, 3), (8, 4)):
        want = np.asarray(jcommon.split_microbatch_stream(x, M, S))
        got = tcommon.split_microbatch_stream(torch.from_numpy(x), M, S)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            tcommon.split_microbatch_labels(torch.from_numpy(x), M).numpy(),
            np.asarray(jcommon.split_microbatch_labels(x, M)))
        np.testing.assert_array_equal(
            tcommon.merge_microbatch_stream(got).numpy(), x)
        # Microbatch m = r·S + s of the stream is the rows m::M.
        for m, rows in enumerate(tcommon.microbatches(torch.from_numpy(x),
                                                      M)):
            np.testing.assert_array_equal(rows.numpy(), want[m // S, m % S])
    with pytest.raises(ValueError, match="not divisible by 3 pipeline"):
        tcommon.split_microbatch_stream(torch.zeros(8, 1), 4, 3)


def test_p2p_pairs_without_deadlock_and_times_out():
    world = ThreadWorld(2, timeout=20)

    def body(r):
        comm = world.comm([0, 1], r)
        mine = torch.full((3,), float(r))
        # Both members send first, twice, with two tags in one call.
        got = comm.p2p([(1 - r, 0, mine), (1 - r, 1, mine + 10)],
                       [(1 - r, 1, (3,), torch.float32, "cpu"),
                        (1 - r, 0, (3,), torch.float32, "cpu")])
        return [g.tolist() for g in got]

    out = world.run(body)
    assert out[0] == [[11.0] * 3, [1.0] * 3]
    assert out[1] == [[10.0] * 3, [0.0] * 3]
    lonely = ThreadWorld(2, timeout=0.5).comm([0, 1], 0)  # member 1 idles
    with pytest.raises(TimeoutError, match="no tensor from member 1"):
        lonely.p2p([], [(1, 0, (1,), torch.float32, "cpu")])


@pytest.mark.parametrize("S,data,V", [(2, 1, 1), (2, 2, 1), (4, 1, 2)])
def test_layout_slices_are_jax_device_slices(S, data, V):
    rng = np.random.default_rng(S + V)
    lead = (V, S) if V > 1 else (S,)
    full = {"front.embed": rng.standard_normal((5, 4)).astype(np.float32),
            "stages.block1.ln1.weight":
                rng.standard_normal(lead + (4,)).astype(np.float32),
            "stages.block1.mlp1.weight":
                rng.standard_normal(lead + (6, 4)).astype(np.float32)}
    world = ThreadWorld(S * data, timeout=20)
    sizes = mesh_sizes(S * data, pipe=S)

    def body(r):
        mesh = thread_mesh(sizes, world, r)
        d = mesh.coords["pipe"]
        names = ["front.embed"] + [f"chunks.{k}.{leaf}" for k in range(V)
                                   for leaf in ("block1.ln1.weight",
                                                "block1.mlp1.weight")]
        layout = tcommon.PipeLayout(names, num_stages=S, virtual_stages=V,
                                    interleaved=V > 1,
                                    comm=mesh.comm("pipe"), rank=d)
        local = layout.shard({k: torch.from_numpy(v) for k, v in full.items()})
        # JAX's P(pipe) / P(None, pipe) slice of device index d.
        for name in ("block1.ln1.weight", "block1.mlp1.weight"):
            slab = full["stages." + name]
            want = slab[:, d] if V > 1 else slab[d:d + 1]
            got = torch.stack([local[f"chunks.{k}.{name}"]
                               for k in range(V)]).numpy()
            np.testing.assert_array_equal(got, want.reshape(got.shape))
        back = layout.gather(local)
        tensors = [local[n] for n in names]
        return ({k: v.numpy() for k, v in back.items()},
                float(layout.norm(tensors)))

    for back, norm in world.run(body):
        assert set(back) == set(full)
        for k in full:
            np.testing.assert_array_equal(back[k], full[k])
        want = np.sqrt(sum(float((v.astype(np.float64) ** 2).sum())
                           for v in full.values()))
        assert norm == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("family", ["lm", "vit"])
@pytest.mark.parametrize("interleaved", [False, True])
def test_jax_param_maps_round_trip(family, interleaved):
    if family == "lm":
        cfg = tplm.PipeLMConfig(vocab_size=16, seq_len=8, d_model=8,
                                num_heads=2, num_stages=2, virtual_stages=2)
        state = tplm.init_pipe_lm(cfg, interleaved=interleaved)
    else:
        cfg = tpv.PipeViTConfig(embed_dim=8, num_heads=2, num_stages=2,
                                virtual_stages=2, patch_size=7)
        state = tpv.init_pipe_vit(cfg, interleaved=interleaved)
    tree = pipe_params_to_jax(state)
    lead = (2, 2) if interleaved else (2,)
    assert tree["stages"]["block1"]["mlp1"]["kernel"].shape == lead + (8, 32)
    back = pipe_params_from_jax(tree)
    assert set(back) == set(state)
    for k, v in state.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
