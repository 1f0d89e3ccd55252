"""``--parallel zero`` (``ddp_tpu_torch/parallel/zero.py``) ≡ the JAX
package's ``ddp_tpu/parallel/zero.py``, on the CPU (after
``tests/test_zero.py``).

- The bucket layout (count, members by JAX path, totals, padding) equals
  JAX's ``build_layout`` on SimpleCNN's, ViT-Tiny's and the LM's trees at
  2 and 4 replicas and two bucket sizes; flatten/unflatten round-trip
  with a zero pad; the reduce-scatter / owned slice / all-gather
  convention is JAX's (replica ``r`` owns block ``r``).
- ``ddp_comm_bytes``/``zero_comm_bytes`` (accumulation, both gather
  dtypes, the LM's in-graph pricing) and ``opt_bytes_per_device`` equal
  JAX's; the state at rest is 1/N a rank.
- One Adam step and a 3-step SGD-momentum trajectory at world 2 and 4,
  with accumulation and with the in-step clip, equal the port's DDP step
  and JAX's ``make_zero_train_step`` on the same mesh (metrics rtol
  1e-5, parameters atol 2e-5: tests/test_torch_ddp.py's limits).
- bf16 gather against JAX's bf16 gather: the masters within the fp32
  tolerance, the parameters the masters rounded to bf16 bit for bit,
  after one step the master equals the fp32-gather run's parameters, and
  a checkpoint written and restored under bf16 gather resumes bit for
  bit, with its master.
- The contract's rejections, with JAX's messages. Two controls must
  fail: an update at the neighbour's offset, and an update of the
  rounded parameters in place of the masters.

Port worlds run in threads (``runtime/dist.ThreadWorld``); JAX on the
first 2 or 4 of the 8 CPU devices.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddp_tpu.models import get_model as jax_get_model
from ddp_tpu.models.cnn import SimpleCNN as JaxCNN
from ddp_tpu.models.lm import LMSpec as JSpec
from ddp_tpu.models.lm import init_lm as jax_init_lm
from ddp_tpu.parallel import ddp as jddp
from ddp_tpu.parallel import zero as jz
from ddp_tpu.runtime.mesh import MeshSpec, make_mesh
from ddp_tpu.train.optim import make_optimizer as jax_make_optimizer
from ddp_tpu_torch.interop.jax_params import (
    cnn_params_to_jax,
    flatten_tree,
    jax_leaf_order,
    jax_leaf_path,
)
from ddp_tpu_torch.models import get_model
from ddp_tpu_torch.models.cnn import SimpleCNN, init_cnn_state
from ddp_tpu_torch.models.lm import LMSpec, init_lm_state
from ddp_tpu_torch.parallel import zero as tz
from ddp_tpu_torch.parallel.ddp import TrainState, make_train_step
from ddp_tpu_torch.runtime.dist import ThreadWorld
from ddp_tpu_torch.train.checkpoint import CheckpointManager
from ddp_tpu_torch.train.config import TrainConfig
from ddp_tpu_torch.train.optim import check_zero_compatible, make_optimizer

RTOL, ATOL = 1e-5, 2e-5
SMALL = (4, 8)
B = 8
BUCKET_MB = 0.002  # two buckets on the small CNN, padded at world 4
LM = dict(vocab_size=32, total_len=16, d_model=32, depth=2, num_heads=4)


def _mesh(world):
    return make_mesh(MeshSpec(data=world), devices=jax.devices()[:world])


def _batches(n, batch=B, seed=1):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 256, (batch, 28, 28, 1), dtype=np.uint8),
             rng.integers(0, 10, batch).astype(np.int32)) for _ in range(n)]


# ---- the bucket layout ----------------------------------------------


def _family(name):
    """(port (name, shape) pairs in module order, JAX abstract tree)."""
    key = jax.random.key(0)
    if name == "simple_cnn":
        model = get_model("simple_cnn", num_classes=10, side=28,
                          in_channels=1)
        tree = jax.eval_shape(JaxCNN().init, key,
                              jnp.zeros((1, 28, 28, 1)))["params"]
    elif name == "vit_tiny":
        model = get_model("vit_tiny", num_classes=100, side=32,
                          in_channels=3)
        tree = jax.eval_shape(jax_get_model("vit_tiny", num_classes=100).init,
                              key, jnp.zeros((1, 32, 32, 3)))["params"]
    else:
        spec = LMSpec(**LM)
        return ([(k, v.shape) for k, v in init_lm_state(spec).items()],
                jax.eval_shape(lambda: jax_init_lm(JSpec(**LM), seed=0)))
    return [(n, tuple(p.shape)) for n, p in model.named_parameters()], tree


@pytest.mark.parametrize("bucket_mb", [0.01, 4.0])
@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("family", ["simple_cnn", "vit_tiny", "lm"])
def test_bucket_layout_equals_jax(family, world, bucket_mb):
    named, tree = _family(family)
    names = [n for n, _ in named]
    shapes = [s for _, s in named]
    order = jax_leaf_order(names, shapes)
    port = tz.build_layout([shapes[i] for i in order], world,
                           bucket_mb=bucket_mb)
    want = jz.build_layout(tree, world, bucket_mb=bucket_mb)
    jpaths = ["/".join(str(getattr(k, "key", k)) for k in path) for path, _
              in jax.tree_util.tree_flatten_with_path(tree)[0]]
    ppaths = ["/".join(jax_leaf_path(names[i], len(shapes[i])))
              for i in order]
    assert ppaths == jpaths
    assert len(port.buckets) == len(want.buckets)
    for b, w in zip(port.buckets, want.buckets):
        assert (b.leaf_ids, b.sizes, b.total, b.padded, b.shard) == (
            w.leaf_ids, w.sizes, w.total, w.padded, w.shard)
    assert port.padded_total == want.padded_total


def test_flatten_unflatten_round_trip_with_zero_pad():
    rng = np.random.default_rng(0)
    leaves = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
              for s in ((3, 5), (7,), (2, 2, 2))]
    leaves[2] = leaves[2].bfloat16()
    layout = tz.build_layout([t.shape for t in leaves], 8, bucket_mb=1e-9)
    flats = tz.flatten_buckets(layout, leaves)
    for b, f in zip(layout.buckets, flats):
        assert f.shape == (b.padded,) and f.dtype == torch.float32
        assert not f[b.total:].any()
    back = tz.unflatten_buckets(layout, flats, leaves)
    for got, want in zip(back, leaves):
        assert got.dtype == want.dtype and torch.equal(got, want)
    for owner in range(8):
        cut = tz.shard_of(layout, leaves, owner)
        for b, f, c in zip(layout.buckets, flats, cut):
            assert torch.equal(c, f[owner * b.shard:(owner + 1) * b.shard])


@pytest.mark.parametrize("world", [2, 4])
def test_scatter_slice_gather_convention(world):
    """Reduce-scatter block ↔ owned slice ↔ all-gather agree on the
    order (``test_scatter_slice_gather_convention``): member r keeps
    block r of the sum."""
    tw = ThreadWorld(world)
    x = torch.arange(16.0)
    layout = tz.build_layout([(16,)], world)

    def body(r):
        comm = tw.comm(range(world), r)
        s = comm.reduce_scatter(x.clone())
        mine = tz.shard_of(layout, [x], r)[0]
        g = tz.gather_buckets([s], comm)[0]
        h = comm.reduce_scatter(x.clone(), async_op=True).wait()
        return s, mine, g, h

    for r, (s, mine, g, h) in enumerate(tw.run(body)):
        assert torch.equal(s, world * mine) and torch.equal(h, s)
        assert torch.equal(mine, x[r * 16 // world:(r + 1) * 16 // world])
        assert torch.equal(g, world * x)


# ---- accounting -----------------------------------------------------


def test_comm_bytes_equal_jax():
    for family in ("simple_cnn", "vit_tiny", "lm"):
        named, tree = _family(family)
        names = [n for n, _ in named]
        shapes = [s for _, s in named]
        sizes = [int(np.prod(s)) for s in shapes]
        for world in (2, 4, 8):
            want_ddp = jz.ddp_comm_bytes(tree, world)
            assert tz.ddp_comm_bytes(sizes, world) == want_ddp
            for mb in (0.01, 4.0):
                port = tz.build_layout(
                    [shapes[i] for i in jax_leaf_order(names, shapes)],
                    world, bucket_mb=mb)
                jl = jz.build_layout(tree, world, bucket_mb=mb)
                for k in (1, 4):
                    for g in ("fp32", "bf16"):
                        for gspmd in (False, True):
                            kw = dict(grad_accum_steps=k, gather_dtype=g,
                                      gspmd=gspmd)
                            assert tz.zero_comm_bytes(port, world, **kw) == \
                                jz.zero_comm_bytes(jl, world, **kw), (
                                    family, world, mb, kw)
    with pytest.raises(ValueError, match="ROADMAP A4.2"):
        tz.zero_comm_bytes(port, 2, dcn=2)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("opt", ["adam", "sgd_momentum"])
def test_opt_bytes_equal_jax_and_rest_one_nth(world, opt):
    opt_kw = (dict(name="adam", lr=1e-3) if opt == "adam"
              else dict(name="sgd", lr=0.05, momentum=0.9))
    tree = cnn_params_to_jax(init_cnn_state(SMALL))
    tx = jax_make_optimizer(**opt_kw)
    mesh = _mesh(world)
    jl = jz.build_layout(tree, world, bucket_mb=BUCKET_MB)
    for g in ("fp32", "bf16"):
        jopt = jz.create_zero_opt_state(tree, tx, mesh, jl, gather_dtype=g)
        model = SimpleCNN.from_state(init_cnn_state(SMALL), "cpu")
        zopt = tz.ZeroOptimizer(model.named_parameters(),
                                ThreadWorld(world).comm(range(world), 0),
                                bucket_mb=BUCKET_MB, gather_dtype=g,
                                **opt_kw)
        assert tz.opt_bytes_per_device(zopt) == jz.opt_bytes_per_device(jopt)
    full = make_optimizer(model.parameters(), **opt_kw)
    jfull = jddp.replicate_state(jddp.TrainState(
        jnp.zeros((), jnp.int32), tree, tx.init(tree), {}), mesh).opt_state
    assert tz.opt_bytes_per_device(full) == jz.opt_bytes_per_device(jfull)
    fp32 = tz.ZeroOptimizer(model.named_parameters(),
                            ThreadWorld(world).comm(range(world), 0),
                            bucket_mb=BUCKET_MB, **opt_kw)
    moments = sum(b.numel() for k in ("mu", "nu", "trace")
                  for b in getattr(fp32.inner, k, None) or [])
    padded = fp32.layout.padded_total * (2 if opt == "adam" else 1)
    assert moments * world == padded


# ---- the step -------------------------------------------------------


def _run_jax(opt_kw, world, batches, *, gather="fp32", **step_kw):
    tree = cnn_params_to_jax(init_cnn_state(SMALL, seed=0))
    tx = jax_make_optimizer(**opt_kw)
    mesh = _mesh(world)
    layout = jz.build_layout(tree, world, bucket_mb=BUCKET_MB)
    state = jddp.TrainState(
        step=jnp.zeros((), jnp.int32), params=tree,
        opt_state=jz.create_zero_opt_state(tree, tx, mesh, layout,
                                           gather_dtype=gather),
        model_state={})
    state = state._replace(params=jddp.replicate_state(
        state._replace(opt_state=()), mesh).params)
    step = jz.make_zero_train_step(JaxCNN(features=SMALL), tx, mesh, layout,
                                   donate=False, gather_dtype=gather,
                                   **step_kw)
    rows = []
    for x, y in batches:
        state, m = step(state, jnp.asarray(x), jnp.asarray(y))
        rows.append((float(m.loss), float(m.accuracy), float(m.grad_norm)))
    return state, rows, layout


def _run_port(opt_kw, world, batches, *, zero=True, gather="fp32",
              clip=0.0, accum=1, after=None):
    """Every rank steps on its contiguous rows → per rank (state, rows,
    ``after(state, comm)``'s result)."""
    tw = ThreadWorld(world)

    def body(rank):
        model = SimpleCNN.from_state(init_cnn_state(SMALL, seed=0), "cpu")
        comm = tw.comm(range(world), rank)
        if zero:
            opt = tz.ZeroOptimizer(model.named_parameters(), comm,
                                   bucket_mb=BUCKET_MB, gather_dtype=gather,
                                   grad_clip_norm=clip, **opt_kw)
            state = TrainState(0, model, opt)
            step = tz.make_zero_train_step(state, comm,
                                           grad_accum_steps=accum)
        else:
            opt = make_optimizer(model.parameters(), grad_clip_norm=clip,
                                 **opt_kw)
            state = TrainState(0, model, opt)
            step = make_train_step(state, world=world, reduce=tw.reduce(rank),
                                   grad_accum_steps=accum)
        local = len(batches[0][1]) // world
        rows = []
        for x, y in batches:
            sl = slice(rank * local, (rank + 1) * local)
            m = step(torch.from_numpy(x[sl]), torch.from_numpy(y[sl]))
            rows.append((float(m.loss), float(m.accuracy),
                         float(m.grad_norm)))
        return state, rows, after and after(state, comm)

    return tw.run(body)


def _assert_params_close(model, jtree, atol=ATOL):
    got = flatten_tree(cnn_params_to_jax(model.state_dict()))
    want = flatten_tree(jax.tree.map(np.asarray, jtree))
    for k in want:
        err = float(np.abs(got[k] - want[k]).max())
        assert err <= atol, (k, err)


ADAM = dict(name="adam", lr=1e-3)
SGD = dict(name="sgd", lr=0.05, momentum=0.9)
CASES = {
    "adam_1step": (ADAM, 1, {}),
    "sgd_momentum_3steps": (SGD, 3, {}),
    "accum2": (SGD, 2, dict(accum=2)),
    "clip": (SGD, 3, dict(clip=0.1)),
}


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("case", list(CASES))
def test_zero_step_equals_ddp_and_jax(case, world):
    opt_kw, n, kw = CASES[case]
    batch = B * kw.get("accum", 1)
    batches = _batches(n, batch=batch)
    jkw = dict(grad_accum_steps=kw.get("accum", 1),
               grad_clip_norm=kw.get("clip", 0.0))
    jstate, jrows, layout = _run_jax(opt_kw, world, batches, **jkw)
    if world == 4:  # (every leaf of the small CNN is even)
        assert any(b.padded > b.total for b in layout.buckets)
    ranks = _run_port(opt_kw, world, batches, **kw)
    ddp = _run_port(opt_kw, world, batches, zero=False, **kw)[0]
    for state, rows, _ in ranks:
        np.testing.assert_allclose(np.array(rows), np.array(jrows), rtol=RTOL)
        np.testing.assert_allclose(np.array(rows), np.array(ddp[1]),
                                   rtol=RTOL)
        _assert_params_close(state.model, jstate.params)
        _assert_params_close(state.model, cnn_params_to_jax(
            ddp[0].model.state_dict()))
    for p0, p1 in zip(ranks[0][0].model.parameters(),
                      ranks[-1][0].model.parameters()):
        assert torch.equal(p0, p1)


def test_wrong_offset_control_fails(monkeypatch):
    """The neighbour's shard updated with this replica's gradient block:
    the parameters leave JAX's."""
    batches = _batches(1)
    jstate, _, _ = _run_jax(SGD, 2, batches)
    monkeypatch.setattr(tz, "FAULT", "offset")
    state = _run_port(SGD, 2, batches)[0][0]
    with pytest.raises(AssertionError):
        _assert_params_close(state.model, jstate.params)


def _full_state(state, comm):
    return state.optimizer.state_dict()


def _master_tree(state, full):
    """A ZeroOptimizer's full master (its ``state_dict``) as the JAX
    tree."""
    return cnn_params_to_jax(dict(zip(state.optimizer.names,
                                       full["master"])))


def _jax_master_tree(jstate, layout):
    leaves, tdef = jax.tree_util.tree_flatten(jstate.params)
    flats = [jstate.opt_state["master"][k] for k in jz.opt_keys(layout)]
    return jax.tree_util.tree_unflatten(
        tdef, jz._unflatten_buckets(layout, flats, leaves))


def test_bf16_gather_tracks_jax_and_keeps_its_master():
    """Two steps under bf16 gather: the masters equal JAX's within the
    fp32 tolerance, the parameters are the masters rounded to bf16 bit
    for bit and track JAX's (``test_zero_bf16_gather_tracks_fp32``'s
    tolerance); after one step the master equals the fp32-gather run's
    parameters."""
    batches = _batches(2)
    jstate, jrows, layout = _run_jax(ADAM, 2, batches, gather="bf16")
    ranks = _run_port(ADAM, 2, batches, gather="bf16", after=_full_state)
    want = flatten_tree(jax.tree.map(np.asarray,
                                     _jax_master_tree(jstate, layout)))
    for state, rows, full in ranks:
        assert abs(rows[-1][0] - jrows[-1][0]) < 5e-3
        _assert_params_close(state.model, jstate.params, atol=1e-2)
        got = flatten_tree(_master_tree(state, full))
        for k in want:
            assert np.abs(got[k] - want[k]).max() <= ATOL, k
        for p, m in zip(state.optimizer.params, full["master"]):
            assert torch.equal(p.detach(), m.bfloat16().float())
    one, _, full = _run_port(ADAM, 2, batches[:1], gather="bf16",
                             after=_full_state)[0]
    fp32 = _run_port(ADAM, 2, batches[:1])[0][0]
    _assert_params_close(fp32.model, _master_tree(one, full))


def test_rounded_update_control_fails(monkeypatch):
    """The update run on the bf16-rounded parameters in place of the
    masters: after two steps the masters leave JAX's."""
    batches = _batches(2)
    jstate, _, layout = _run_jax(ADAM, 2, batches, gather="bf16")
    monkeypatch.setattr(tz, "FAULT", "rounded")
    state, _, full = _run_port(ADAM, 2, batches, gather="bf16",
                               after=_full_state)[0]
    master = cnn_params_to_jax(dict(zip(state.optimizer.names,
                                        full["master"])))
    want = _jax_master_tree(jstate, layout)
    with pytest.raises(AssertionError):
        for k, w in flatten_tree(jax.tree.map(np.asarray, want)).items():
            assert np.abs(flatten_tree(master)[k] - w).max() <= ATOL, k


def test_bf16_checkpoint_resumes_bit_for_bit(tmp_path):
    """Save after one bf16-gather step, restore into fresh replicas, and
    the next step's parameters and masters equal the uninterrupted
    run's, bit for bit."""
    batches = _batches(2)
    straight = _run_port(ADAM, 2, batches, gather="bf16", after=_full_state)
    tw = ThreadWorld(2)

    def body(rank):
        comm = tw.comm(range(2), rank)

        def run(seed, todo, restore):
            model = SimpleCNN.from_state(init_cnn_state(SMALL, seed=seed),
                                         "cpu")
            opt = tz.ZeroOptimizer(model.named_parameters(), comm,
                                   bucket_mb=BUCKET_MB, gather_dtype="bf16",
                                   **ADAM)
            state = TrainState(0, model, opt)
            step = tz.make_zero_train_step(state, comm)
            mgr = CheckpointManager(str(tmp_path), is_main=rank == 0,
                                    async_save=False)
            if restore:
                comm.all_reduce_(torch.zeros(1))  # rank 0 has written
                mgr.restore(state)
            for x, y in todo:
                step(torch.from_numpy(x[rank * 4:(rank + 1) * 4]),
                     torch.from_numpy(y[rank * 4:(rank + 1) * 4]))
            if not restore:
                mgr.save(0, state)
            return state.optimizer.state_dict()

        run(0, batches[:1], False)
        return run(5, batches[1:], True)  # other weights until restored

    resumed = tw.run(body)
    for want, got in zip(straight, resumed):
        for k in ("mu", "nu", "master"):
            for a, b in zip(want[2][k], got[k]):
                assert torch.equal(a, b), k
        assert want[2]["count"] == got["count"] == 2


# ---- the contract ---------------------------------------------------


def test_contract_rejections_with_jax_messages():
    with pytest.raises(ValueError, match="full-shape parameter average"):
        check_zero_compatible("adamw", ema_decay=0.999)
    check_zero_compatible("adam")
    check_zero_compatible("sgd", grad_clip_norm=1.0)
    with pytest.raises(ValueError, match="data axis only"):
        tz.check_zero_mesh({"data": 4, "fsdp": 2})
    with pytest.raises(ValueError, match="data axis only"):
        tz.check_zero_mesh({"data": 4, "model": 2})
    tz.check_zero_mesh({"data": 4, "model": 2}, allow_model_axes=True)
    with pytest.raises(ValueError, match="fp16"):
        tz._resolve_gather_dtype("fp16")
    base = ["--parallel", "zero", "--spawn", "4"]
    cases = [
        (["--zero1"], "shard optimizer state"),
        (["--model", "causal_lm", "--mesh_fsdp", "2"],
         "shard optimizer state"),
        (["--mesh_fsdp", "2"], "shard optimizer state"),
        (["--model", "vit_tiny", "--mesh_model", "2"], "causal_lm only"),
        (["--model", "long_context"], "causal_lm"),
        (["--fast_epoch"], "own hot loop"),
        (["--ema_decay", "0.99", "--optimizer", "adamw"],
         "parameter average"),
        (["--zero_bucket_mb", "0"], "zero_bucket_mb"),
    ]
    for extra, match in cases:
        with pytest.raises(ValueError, match=match):
            TrainConfig.from_args(base + extra)
    for extra in (["--model", "causal_lm", "--mesh_model", "2"],
                  ["--model", "causal_lm", "--mesh_seq", "2"],
                  ["--grad_clip_norm", "1.0", "--zero_gather_dtype", "bf16"],
                  ["--elastic"]):
        assert TrainConfig.from_args(base + extra).zero
