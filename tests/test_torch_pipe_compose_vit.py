"""The pipelined ViT's compositions in the port ≡ the JAX package's
``models/pipeline_vit.py`` steps on the same meshes, on the CPU: PP×TP
(``--mesh_model``; ``TestPpTp``'s case: GPipe at pipe 2 × model 2 × data
2, 1F1B at pipe 2 × model 2) and PP×fsdp (``tests/test_pipe_fsdp.py``'s
GPipe and hand-scheduled cases, pipe 2 × fsdp 2: the stage leaves of at
least 4096 elements rest sharded, gathered once a step and
reduce-scattered back).

The same seeded weights (the port's init, biases and LayerNorm scales
moved off their init values; carried into JAX by
``interop/jax_params.pipe_params_to_jax``) and numpy uint8 28×28 images
(patch 7: 16 tokens) go through JAX's step on the first world-size of
the 8 CPU devices and through the port's in an in-process world
(``runtime/dist.ThreadWorld``). Compared at the pipeline tests'
tolerances: the loss and accuracy at rtol 1e-5 (the step reports no grad
norm, as JAX's); every leaf of the updated stacked parameters and Adam
moments at atol 2e-5 (an element whose gradient is zero in exact
arithmetic held to the step's size, 2·lr); each rank's stage leaves
against the JAX device shard of its index. An ``expert`` axis is refused
with JAX's message.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddp_tpu.models import pipeline_vit as jpv
from ddp_tpu.runtime.mesh import MeshSpec, make_mesh
from ddp_tpu.train.optim import make_optimizer as jax_make_optimizer
from ddp_tpu_torch.interop.jax_params import flatten_tree, pipe_params_to_jax
from ddp_tpu_torch.models import pipeline_vit as tpv
from ddp_tpu_torch.runtime.dist import ThreadWorld
from ddp_tpu_torch.runtime.mesh import mesh_sizes, thread_mesh
from ddp_tpu_torch.train.optim import make_optimizer

RTOL, ATOL, LR = 1e-5, 2e-5, 1e-3
BATCH, SIDE = 8, 28
# id: (mesh axes, schedule, virtual stages); d 32: the qkv and MLP
# kernels ([2, 96, 32], [2, 128, 32]) pass FSDP_MIN_SIZE, the LayerNorms
# stay whole.
CASES = {
    "tp_gpipe": (dict(pipe=2, model=2, data=2), "gpipe", 1),
    "tp_1f1b": (dict(pipe=2, model=2), "1f1b", 1),
    "fsdp_gpipe": (dict(pipe=2, fsdp=2), "gpipe", 1),
    "fsdp_1f1b": (dict(pipe=2, fsdp=2), "1f1b", 1),
}


def _fields(case):
    axes, _, v = CASES[case]
    return dict(num_classes=10, patch_size=7, embed_dim=32, num_heads=4,
                num_stages=2, depth_per_stage=1, num_microbatches=4,
                virtual_stages=v, tp_size=axes.get("model", 1))


def _state(cfg, interleaved, seed=0):
    rng = np.random.default_rng(seed + 7)
    state = tpv.init_pipe_vit(cfg, seed=seed, interleaved=interleaved)
    moved = (".bias", "ln1.weight", "ln2.weight", "ln.weight")
    return {k: (v + rng.uniform(-0.3, 0.3, v.shape)).astype(np.float32)
            if k.endswith(moved) else v for k, v in state.items()}


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (BATCH, SIDE, SIDE, 1), dtype=np.uint8),
            rng.integers(0, 10, BATCH).astype(np.int32))


def _world(axes):
    n = int(np.prod(list(axes.values())))
    return n, mesh_sizes(n, **{a: s for a, s in axes.items() if a != "data"})


def port_step(case, state, x, y):
    axes, schedule, _ = CASES[case]
    cfg = tpv.PipeViTConfig(**_fields(case), side=SIDE, in_channels=1)
    inter = schedule == "interleaved"
    n, sizes = _world(axes)
    world = ThreadWorld(n, timeout=60)

    def body(r):
        mesh = thread_mesh(sizes, world, r)
        model = tpv.build_pipe_vit(cfg, state, mesh, "cpu", interleaved=inter)
        o = make_optimizer(model.parameters(), "adam", lr=LR)
        o.norm = model.shard_layout.norm
        step = tpv.make_pipe_vit_train_step(model, o, mesh, schedule=schedule)
        b = BATCH // mesh.data_size
        rows = slice(mesh.data_rank * b, (mesh.data_rank + 1) * b)
        m = step(torch.from_numpy(x[rows]), torch.from_numpy(y[rows]))
        lay = model.shard_layout
        named = dict(model.named_parameters())
        return dict(metrics=m,
                    params=lay.gather({n: p.detach().clone()
                                       for n, p in named.items()}),
                    mu=lay.gather(dict(zip(lay.names, o.mu))),
                    nu=lay.gather(dict(zip(lay.names, o.nu))),
                    local={n: p.detach().clone() for n, p in named.items()
                           if n.startswith("chunks.")})

    return world.run(body)


def _opt_arrays(opt_state, key):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(opt_state)[0]:
        keys = [getattr(k, "key", getattr(k, "name", None)) for k in path]
        if key in keys:
            out["/".join(str(k) for k in keys[keys.index(key) + 1:])] = leaf
    return out


def jax_step(case, state, x, y, devices):
    from jax.sharding import NamedSharding, PartitionSpec as P

    axes, schedule, _ = CASES[case]
    inter = schedule == "interleaved"
    n, _ = _world(axes)
    mesh = make_mesh(MeshSpec(**{"data": 1, **axes}), devices=devices[:n])
    cfg_j = jpv.PipeViTConfig(**_fields(case))
    tree = pipe_params_to_jax(state)
    specs = jpv._vit_stage_specs(cfg_j, tree["stages"], mesh,
                                 lead=2 if inter else 1)
    rep = NamedSharding(mesh, P())
    params = jpv.PipeViTParams(
        embed=jax.tree.map(lambda a: jax.device_put(a, rep), tree["embed"]),
        stages=jax.tree.map(lambda a, s: jax.device_put(
            a, NamedSharding(mesh, s)), tree["stages"], specs),
        head=jax.tree.map(lambda a: jax.device_put(a, rep), tree["head"]))
    tx = jax_make_optimizer("adam", lr=LR)
    st = jpv.PipeViTState(jnp.zeros((), jnp.int32), params, tx.init(params))
    make = {"gpipe": jpv.make_pipe_vit_train_step,
            "1f1b": jpv.make_pipe_vit_1f1b_train_step,
            "interleaved": jpv.make_pipe_vit_interleaved_train_step}[schedule]
    return make(cfg_j, tx, mesh, donate=False)(st, jnp.asarray(x),
                                               jnp.asarray(y))


@pytest.fixture(scope="module", params=list(CASES))
def case(request, devices):
    name = request.param
    cfg = tpv.PipeViTConfig(**_fields(name), side=SIDE, in_channels=1)
    state = _state(cfg, CASES[name][1] == "interleaved")
    x, y = _batch(len(name))
    jnew, jm = jax_step(name, state, x, y, devices)
    return name, port_step(name, state, x, y), jnew, jm


def test_metrics_equal_jax(case):
    _, ranks, _, jm = case
    for out in ranks:
        m = out["metrics"]
        np.testing.assert_allclose(float(m.loss), float(jm.loss), rtol=RTOL)
        np.testing.assert_allclose(float(m.accuracy), float(jm.accuracy),
                                   rtol=RTOL)
        assert m.grad_norm is None


def test_updated_params_and_moments_equal_jax(case):
    _, ranks, jnew, _ = case
    mu = {k: np.asarray(v) for k, v in _opt_arrays(jnew.opt_state,
                                                   "mu").items()}
    gmax = max(np.abs(v).max() for v in mu.values())
    want = flatten_tree({"embed": jnew.params.embed,
                         "stages": jnew.params.stages,
                         "head": jnew.params.head})
    for out in ranks:
        got = flatten_tree(pipe_params_to_jax(out["params"]))
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            w = np.asarray(w)
            diff, noise = np.abs(got[k] - w), np.abs(mu[k]) < 1e-6 * gmax
            assert diff[noise].max(initial=0) <= 2 * LR, k
            assert diff[~noise].max(initial=0) <= ATOL + RTOL * np.abs(
                w[~noise]).max(initial=0), k
        for key in ("mu", "nu"):
            pm = flatten_tree(pipe_params_to_jax(out[key]))
            for k, v in _opt_arrays(jnew.opt_state, key).items():
                np.testing.assert_allclose(pm[k], np.asarray(v), rtol=RTOL,
                                           atol=ATOL, err_msg=f"{key} {k}")


def test_rank_stage_leaves_are_jax_shards(case, devices):
    name, ranks, jnew, _ = case
    V = CASES[name][2]
    mu = _opt_arrays(jnew.opt_state, "mu")
    gmax = max(float(np.abs(np.asarray(v)).max()) for v in mu.values())
    paths = jax.tree_util.tree_flatten_with_path(jnew.params.stages)[0]
    cut = set()
    for r, out in enumerate(ranks):
        mine = {}
        for n in out["local"]:
            if n.startswith("chunks.0."):
                leaf = n[len("chunks.0."):]
                t = torch.stack([out["local"][f"chunks.{k}.{leaf}"]
                                 for k in range(V)])
                mine["stages." + leaf] = t[:, None] if V > 1 else t
        got = flatten_tree(pipe_params_to_jax(mine))
        for path, leaf in paths:
            k = "stages/" + "/".join(str(getattr(p, "key", p)) for p in path)

            def shard(a):
                return np.asarray(next(s.data for s in a.addressable_shards
                                       if s.device == devices[r]))

            want = shard(leaf)
            noise = np.abs(shard(mu[k])) < 1e-6 * gmax
            assert got[k].shape == want.shape, (r, k)
            if want.size < np.asarray(leaf).size // 2:
                cut.add(k)  # smaller than its pipe slice: cut further
            diff = np.abs(got[k] - want)
            assert diff[~noise].max(initial=0) <= ATOL, (r, k)
            assert diff[noise].max(initial=0) <= 2 * LR, (r, k)
    assert cut, "no stage leaf rests cut beyond its pipe slice"


def test_expert_axis_refused_with_jax_message():
    cfg = tpv.PipeViTConfig(num_stages=2, side=SIDE, in_channels=1)
    world = ThreadWorld(4, timeout=30)

    def body(r):
        mesh = thread_mesh(mesh_sizes(4, pipe=2, expert=2), world, r)
        with pytest.raises(ValueError, match="no expert mesh axis"):
            tpv.build_pipe_vit(cfg, tpv.init_pipe_vit(cfg), mesh, "cpu")

    world.run(body)
