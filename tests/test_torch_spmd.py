"""The image family's GSPMD step (``--mesh_model``, ``--mesh_fsdp``,
``--mesh_expert``) in the port ≡ the JAX package's
``parallel/spmd.make_spmd_train_step`` on the same mesh, on the CPU.

The same seeded weights (the port's init, LayerNorms, BatchNorm scales
and biases moved off their init values; carried into JAX by
``interop/jax_params``) and numpy image batches go through JAX's GSPMD
step on the first ``world`` of the 8 CPU devices and through the port's
step in an in-process world (``runtime/dist.ThreadWorld``), each rank
holding its shard (``parallel/spmd.shard_model``) and its data replica's
rows. Compared: the loss and grad norm (rtol 1e-5), every gathered
leaf's gradient (SGD momentum's trace after one step IS the gradient;
within 1e-5 of the leaf's largest magnitude, with a floor of 1e-3 of the
gradient's largest), the updated parameters, BatchNorm's running
statistics and moments (atol 2e-5), and each rank's shard at rest
against the JAX device shard of its index. Also: ``param_specs`` equals
JAX's, the three controls of this file each fail the check (BN by
the rank's own moments, MoE capacity and slot order per rank, the fsdp
gradient left unscaled by its axis), and under ``--augment`` a rank
draws its rows as world 1 draws them.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from ddp_tpu.models import get_model as jax_get_model
from ddp_tpu.parallel import spmd as jspmd
from ddp_tpu.parallel.ddp import TrainState as JaxState
from ddp_tpu.runtime.mesh import MeshSpec, make_mesh
from ddp_tpu.train.optim import make_optimizer as jax_make_optimizer
from ddp_tpu_torch.data.augment import get_augmentation
from ddp_tpu_torch.interop.jax_params import (
    cnn_params_to_jax,
    flatten_tree,
    jax_leaf_path,
    resnet_params_to_jax,
    vit_params_to_jax,
)
from ddp_tpu_torch.models import get_model
from ddp_tpu_torch.models import moe as tmoe
from ddp_tpu_torch.models.resnet import BatchNorm
from ddp_tpu_torch.parallel import seq_fsdp
from ddp_tpu_torch.parallel import spmd
from ddp_tpu_torch.parallel.ddp import TrainState
from ddp_tpu_torch.runtime.dist import LocalComm, ThreadWorld
from ddp_tpu_torch.runtime.mesh import Mesh, mesh_sizes, thread_mesh
from ddp_tpu_torch.train.optim import make_optimizer

RTOL, ATOL, GRAD_TOL = 1e-5, 2e-5, 1e-5
BATCH = 8
# name: (port kwargs, JAX kwargs, image side, channels)
MODELS = {
    "vit_micro": ({}, {}, 28, 1),
    "vit_moe_micro": ({}, {}, 28, 1),
    "vit_moe_drop": ({"capacity_factor": 0.5}, {"capacity_factor": 0.5},
                     28, 1),
    "vit_tiny": ({"depth": 1}, {"depth": 1}, 32, 3),
    "resnet18": ({}, {}, 8, 3),
    # ResNet-18's BasicBlocks, its first two stages of one block each, at
    # width 16 (of 64): the step's case inside the CPU test's time (JAX
    # compiles the full depth's GSPMD step in ~8 s here); fsdp shards
    # stage 2's convs, the 3×3 32 → 32 one on its tie, and stage 2
    # downsamples through its own BatchNorm.
    "resnet_w16": ({}, {}, 8, 3),
    # ResNet-18's four stages of one BasicBlock each at width 8 (of 64):
    # stages 2-4 stride and downsample through their own BatchNorms (the
    # last at 1x1), and fsdp shards stages 3-4's convs.
    "resnet_w8x4": ({}, {}, 8, 3),
    "simple_cnn": ({}, {}, 28, 1),
}
REGISTRY = {"vit_moe_drop": "vit_moe_micro"}
# The ResNet-18 cuts above: (stage sizes, width).
RESNET_CUTS = {"resnet_w16": ((1, 1), 16), "resnet_w8x4": ((1, 1, 1, 1), 8)}


def _port_model(name):
    kw, _, side, ch = MODELS[name]
    if name in RESNET_CUTS:
        from ddp_tpu_torch.models import resnet as tres

        stages, width = RESNET_CUTS[name]
        return tres.ResNet(stages, tres.BasicBlock, 10, width=width,
                           cifar_stem=True, in_channels=ch)
    return get_model(REGISTRY.get(name, name), num_classes=10, side=side,
                     in_channels=ch, **kw)


def _jax_model(name):
    if name in RESNET_CUTS:
        from ddp_tpu.models import resnet as jres

        stages, width = RESNET_CUTS[name]
        return jres.ResNet(stage_sizes=stages, block=jres.BasicBlock,
                           num_classes=10, width=width, cifar_stem=True)
    return jax_get_model(REGISTRY.get(name, name), num_classes=10,
                         **MODELS[name][1])


def _moved(state, seed):
    """1-D leaves (LayerNorm and BatchNorm scales, biases) moved off their
    init; running statistics as they are."""
    rng = np.random.default_rng(seed + 100)
    return {k: (v + rng.uniform(-0.3, 0.3, v.shape)).astype(np.float32)
            if v.ndim == 1 and "running" not in k else v
            for k, v in state.items()}


def to_jax(name, state):
    """A port state (or gradients keyed alike) → (params, batch_stats)."""
    base = REGISTRY.get(name, name)
    if base == "simple_cnn":
        return cnn_params_to_jax(state), {}
    if base.startswith("resnet"):
        return resnet_params_to_jax(state)
    return vit_params_to_jax(state), {}


def _jax_mesh(world, **axes):
    return make_mesh(MeshSpec(data=-1, **axes), devices=jax.devices()[:world])


def _inputs(name, seed=0):
    _, _, side, ch = MODELS[name]
    state = _moved(_port_model(name).init_state(seed), seed)
    rng = np.random.default_rng(seed + 1)
    x = rng.integers(0, 256, (BATCH, side, side, ch), dtype=np.uint8)
    y = rng.integers(0, 10, BATCH).astype(np.int32)
    return state, x, y


def _model_state(jm, name, stats):
    _, _, side, ch = MODELS[name]
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), jnp.zeros(
        (1, side, side, ch))))
    out = {k: jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), v)
           for k, v in shapes.items() if k != "params"}
    if "batch_stats" in out:
        out["batch_stats"] = jax.tree.map(jnp.asarray, stats)
    return out


def _opt_kw(opt):
    return (dict(name="sgd", lr=0.1, momentum=0.9) if opt == "sgd"
            else dict(name="adam", lr=1e-2))


@functools.lru_cache(maxsize=None)
def jax_step(name, world, axes_items, opt="sgd", accum=1, zero1=False,
             seed=0):
    """JAX's GSPMD step (cached) → (state, x, y, metrics, new state)."""
    state, x, y = _inputs(name, seed)
    jm = _jax_model(name)
    mesh = _jax_mesh(world, **dict(axes_items))
    params, stats = to_jax(name, state)
    params = jax.tree.map(jnp.asarray, params)
    tx = jax_make_optimizer(**_opt_kw(opt))
    st = JaxState(jnp.zeros((), jnp.int32), params, tx.init(params),
                  _model_state(jm, name, stats))
    step = jspmd.make_spmd_train_step(jm, tx, mesh, donate=False,
                                      grad_accum_steps=accum, zero1=zero1)
    sh = NamedSharding(mesh, P(*jspmd.batch_spec(mesh)))
    new, m = step(st, jax.device_put(x, sh), jax.device_put(y, sh))
    return state, x, y, m, new


def _opt_leaves(opt_state, key):
    """{path below ``key``: leaf} of an optax state (e.g. "trace")."""
    flat = jax.tree_util.tree_flatten_with_path(opt_state)[0]
    out = {}
    for path, leaf in flat:
        keys = [getattr(k, "key", getattr(k, "name", None)) for k in path]
        if key in keys:
            rest = keys[keys.index(key) + 1:]
            out["/".join(str(k) for k in rest)] = leaf
    return out


def port_step(name, world, axes, state, x, y, opt="sgd", accum=1,
              zero1=False, patch=None, augment=None):
    """The port's GSPMD step on every rank of a thread world → per rank:
    (metrics, gathered gradients, gathered parameters after the update,
    gathered buffers, local parameter shards, local optimizer buffers,
    layout)."""
    sizes = mesh_sizes(world, **axes)
    tw = ThreadWorld(world, timeout=60)

    def body(r):
        mesh = thread_mesh(sizes, tw, r)
        model = _port_model(name)
        model.load_state_dict({k: torch.from_numpy(v)
                               for k, v in state.items()})
        layout = spmd.shard_model(model, mesh, zero1=zero1)
        if patch is not None:
            patch(model)
        o = make_optimizer(model.parameters(), **_opt_kw(opt),
                           zero1_layout=layout if zero1 else None)
        o.norm = layout.norm
        st = TrainState(0, model, o)
        per = BATCH // mesh.data_size
        rows = slice(mesh.data_rank * per, (mesh.data_rank + 1) * per)
        m = spmd.make_spmd_train_step(
            st, mesh, grad_accum_steps=accum,
            augment_fn=get_augmentation(augment))(
            torch.from_numpy(x[rows]), torch.from_numpy(y[rows]))
        named = dict(model.named_parameters())
        grads = layout.gather({n: p.grad for n, p in named.items()})
        params = layout.gather({n: p.detach() for n, p in named.items()})
        bufs = {k: v for k, v in model.state_dict().items()
                if "running" in k}
        local = {n: p.detach().clone() for n, p in named.items()}
        return m, grads, params, bufs, local, o.state_dict(), layout

    return tw.run(body)


def _grad_close(got_tree, want_tree):
    got, want = flatten_tree(got_tree), flatten_tree(
        jax.tree.map(np.asarray, want_tree))
    assert sorted(got) == sorted(want)
    floor = 1e-3 * max(np.abs(w).max() for w in want.values())
    worst = 0.0
    for k in want:
        scale = max(np.abs(want[k]).max(), floor)
        worst = max(worst, np.abs(got[k] - want[k]).max() / scale)
    return worst


def check(name, world, axes, *, opt="sgd", accum=1, zero1=False,
          patch=None):
    """Hold the port's step to JAX's; raises AssertionError where they
    part."""
    state, x, y, jm, jnew = jax_step(name, world, tuple(sorted(axes.items())),
                                     opt, accum, zero1)
    out = port_step(name, world, axes, state, x, y, opt, accum, zero1, patch)
    m, grads, params, bufs, _, _, _ = out[0]
    np.testing.assert_allclose(float(m.loss), float(jm.loss), rtol=RTOL)
    np.testing.assert_allclose(float(m.grad_norm), float(jm.grad_norm),
                               rtol=RTOL)
    np.testing.assert_allclose(float(m.accuracy), float(jm.accuracy),
                               rtol=RTOL)
    if opt == "sgd":  # the trace after one step is the gradient
        want = _opt_leaves(jnew.opt_state, "trace")
        got = flatten_tree(to_jax(name, {k: v for k, v in grads.items()})[0])
        assert _grad_close(got, want) <= GRAD_TOL
    got = flatten_tree(to_jax(name, params)[0])
    want = flatten_tree(jax.tree.map(np.asarray, jnew.params))
    noise = {}
    if opt == "adam":
        # Adam's first update is ±lr·g/(|g| + eps): where the gradient is
        # zero in exact arithmetic (the key bias: softmax ignores it) both
        # sides normalise rounding noise, so those elements are held to
        # the step's size; the moments below are held to atol everywhere.
        mu = flatten_tree(jax.tree.map(np.asarray,
                                       _opt_leaves(jnew.opt_state, "mu")))
        gmax = max(np.abs(v).max() for v in mu.values())
        noise = {k: np.abs(v) < 1e-6 * gmax for k, v in mu.items()}
        got_mu = flatten_tree(to_jax(name, {
            n: out_mu for n, out_mu in zip(
                out[0][6].names, layout_full(out, "mu"))})[0])
        for k in mu:
            assert np.abs(got_mu[k] - mu[k]).max() <= ATOL, k
    for k in want:
        diff = np.abs(got[k] - want[k])
        if k in noise:
            assert diff[noise[k]].max(initial=0) <= 2 * 1e-2, k
            diff = diff[~noise[k]]
        assert diff.max(initial=0) <= ATOL, k
    if bufs:
        got = flatten_tree(to_jax(name, bufs)[1])
        want = flatten_tree(jax.tree.map(np.asarray,
                                         jnew.model_state["batch_stats"]))
        for k in want:
            assert np.abs(got[k] - want[k]).max() <= ATOL, k
    return out, jnew


def layout_full(out, key) -> list:
    """Rank 0's optimizer buffers ``key``, gathered over the ranks (the
    gather of each rank's shard, in parameter order)."""
    ranks = [o[5][key] for o in out]
    layout = out[0][6]
    full = []
    for i, n in enumerate(layout.names):
        spec = layout.state_specs.get(n)
        if not spec:
            full.append(ranks[0][i])
            continue
        mesh = layout.mesh
        by = {tuple(mesh.coords_of(r)[a] for _, a in spmd._pairs(spec)):
              ranks[r][i] for r in range(len(ranks))}
        t = _assemble(by, spmd._pairs(spec), mesh)
        full.append(layout.maps[n].to_port(t))
    return full


def _assemble(by, pairs, mesh):
    """The whole JAX-layout leaf from its shards keyed by their axis
    coordinates."""
    if not pairs:
        return by[()]
    (d, a), rest = pairs[0], pairs[1:]
    return torch.cat([_assemble({k[1:]: v for k, v in by.items()
                                 if k[0] == i}, rest, mesh)
                      for i in range(mesh.shape[a])], d)


def _jax_shards(leaf) -> dict:
    """{device id: numpy shard} of a JAX array."""
    return {s.device.id: np.asarray(s.data) for s in leaf.addressable_shards}


def check_shards(name, out, jnew, opt="sgd"):
    """Each rank's parameter and optimizer shards at rest ≡ the JAX device
    shard of its index: SGD's parameters and trace; Adam's moments (its
    parameters by shape: their noise elements are held in :func:`check`)."""
    moms = ("trace",) if opt == "sgd" else ("mu", "nu")
    by_path = {"/".join(getattr(p, "key", str(p)) for p in path): leaf
               for path, leaf in
               jax.tree_util.tree_flatten_with_path(jnew.params)[0]}
    jmoms = {k: _opt_leaves(jnew.opt_state, k) for k in moms}
    for r, (_, _, _, _, local, opt_state, layout) in enumerate(out):
        for i, n in enumerate(layout.names):
            path = "/".join(jax_leaf_path(n, len(layout.maps[n].shape)))
            pairs = [(local[n], by_path[path], layout.specs, opt == "sgd")]
            pairs += [(opt_state[k][i], jmoms[k][path], layout.state_specs,
                       True) for k in moms]
            for got, jleaf, specs, values in pairs:
                want = _jax_shards(jleaf)[r]
                g = got.numpy() if n in specs else \
                    layout.maps[n].to_jax(got).numpy()
                assert g.shape == want.shape, (r, n, g.shape, want.shape)
                if values:
                    np.testing.assert_allclose(g, want, atol=ATOL,
                                               err_msg=n)


# ---- the specs ----------------------------------------------------------

SPEC_MESHES = {"data2_model2_fsdp2": (8, dict(model=2, fsdp=2)),
               "model4": (4, dict(model=4)),
               "expert2_model2": (4, dict(expert=2, model=2))}


@functools.lru_cache(maxsize=None)
def _jax_shapes(name):
    jm = _jax_model(name)
    _, _, side, ch = MODELS[name]
    return jax.eval_shape(lambda: jm.init(jax.random.key(0), jnp.zeros(
        (1, side, side, ch))))["params"]


@pytest.mark.parametrize("mesh_name", sorted(SPEC_MESHES))
@pytest.mark.parametrize("name", ["vit_micro", "vit_moe_micro", "resnet18",
                                  "simple_cnn"])
def test_param_specs_equal_jax(name, mesh_name):
    world, axes = SPEC_MESHES[mesh_name]
    jmesh = _jax_mesh(world, **axes)
    jspecs = {"/".join(getattr(k, "key", str(k)) for k in path): tuple(s)
              for path, s in jax.tree_util.tree_flatten_with_path(
                  jspmd.param_specs(_jax_shapes(name), jmesh),
                  is_leaf=lambda s: isinstance(s, P))[0]}
    model = _port_model(name)
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    mine = spmd.param_specs(shapes, Mesh(mesh_sizes(world, **axes), 0))
    got = {"/".join(jax_leaf_path(n, len(shapes[n]))): s
           for n, s in mine.items()}
    assert sorted(got) == sorted(jspecs)
    for k, s in jspecs.items():
        assert got[k] == s + (None,) * (len(got[k]) - len(s)), k


def test_conv_tie_breaks_on_flax_input_dim_and_small_leaves_stay_whole():
    """A 3×3 conv of 64 → 64 (HWIO [3, 3, 64, 64]) ties I and O: fsdp
    takes flax's I (dim 2), the port's OIHW dim 1; a leaf just under
    4096 elements stays whole."""
    shapes = {n: tuple(p.shape)
              for n, p in _port_model("resnet18").named_parameters()}
    specs = spmd.param_specs(shapes, {"fsdp": 2})
    assert specs["stage1_block1.Conv_0.weight"] == (None, None, "fsdp", None)
    layout = spmd.SpmdLayout(shapes, list(shapes),
                             Mesh(mesh_sizes(2, fsdp=2), 1))
    w = torch.arange(64 * 64 * 9, dtype=torch.float32).view(64, 64, 3, 3)
    shard = layout.shard_leaf("stage1_block1.Conv_0.weight", w)
    assert torch.equal(shard, w.permute(2, 3, 1, 0)[:, :, 32:])
    assert spmd.ShardingRules().spec_for(("x",), (4095,), {"fsdp": 2}) == \
        (None,)
    assert spmd.ShardingRules().spec_for(("x",), (4096,), {"fsdp": 2}) == \
        ("fsdp",)
    assert spmd.batch_spec({"data": 2, "fsdp": 2, "model": 2}) == \
        (("data", "fsdp"),)


# ---- the steps ------------------------------------------------------------

CASES = {
    "vit_micro data2 model2 fsdp2 sgd": ("vit_micro", 8,
                                         dict(model=2, fsdp=2), "sgd", 1),
    "vit_micro model4 adam": ("vit_micro", 4, dict(model=4), "adam", 1),
    "vit_tiny model2 heads do not divide": ("vit_tiny", 2, dict(model=2),
                                            "sgd", 1),
    "resnet BasicBlocks fsdp2 data2 (synchronized BN)": ("resnet_w16", 4, dict(fsdp=2), "sgd", 1),
    "resnet four strided stages fsdp2 data2": ("resnet_w8x4", 4,
                                               dict(fsdp=2), "sgd", 1),
    "vit_moe expert2 model2 tokens drop": ("vit_moe_drop", 4,
                                           dict(expert=2, model=2), "sgd", 1),
    "vit_micro data2 fsdp2 accum2": ("vit_micro", 4, dict(fsdp=2), "sgd", 2),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_step_equals_jax_gspmd_step(case):
    name, world, axes, opt, accum = CASES[case]
    out, jnew = check(name, world, axes, opt=opt, accum=accum)
    check_shards(name, out, jnew, opt)


def test_moe_case_drops_tokens():
    """The routed case's capacity factor drops tokens (global routing:
    counted over every rank's kept assignments)."""
    state, x, y = _inputs("vit_moe_drop")
    kept = []
    real = tmoe.route_global

    def spy(*a, **kw):
        r = real(*a, **kw)
        kept.append((int(r.kept.sum()), r.kept.numel()))
        return r

    tmoe.route_global = spy
    try:
        port_step("vit_moe_drop", 4, dict(expert=2, model=2), state, x, y)
    finally:
        tmoe.route_global = real
    assert kept and all(k < n for k, n in kept)


def _local_bn(model):
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.sync = LocalComm()


def _local_routing(model):
    for m in model.modules():
        if isinstance(m, tmoe.MoEMLP):
            m.spmd.data = LocalComm()


CONTROLS = {
    "BN by the rank's own moments": ("resnet_w16", 4, dict(fsdp=2),
                                     _local_bn, None),
    "MoE capacity and slot order per rank": ("vit_moe_drop", 4,
                                             dict(expert=2, model=2),
                                             _local_routing, None),
    "an fsdp gradient unscaled by its axis": ("vit_micro", 8,
                                              dict(model=2, fsdp=2), None,
                                              "drop_scale"),
}


@pytest.mark.parametrize("control", sorted(CONTROLS))
def test_control_fails_the_check(control, monkeypatch):
    name, world, axes, patch, fault = CONTROLS[control]
    if fault:
        monkeypatch.setattr(seq_fsdp, "FAULT", fault)
    with pytest.raises(AssertionError):
        check(name, world, axes, patch=patch)


def test_augmented_step_draws_each_row_as_world_1():
    """Under ``--augment`` a rank draws its rows' crops and flips as world
    1 draws them for the global microbatch (the key of the step and
    microbatch, each row's place in it): the step at data 2 × fsdp 2 with
    accumulation equals world 1's GSPMD step on the global batch."""
    state, x, y = _inputs("vit_micro")
    got = port_step("vit_micro", 4, dict(fsdp=2), state, x, y, accum=2,
                    augment="crop_flip")[0]
    want = port_step("vit_micro", 1, {}, state, x, y, accum=2,
                     augment="crop_flip")[0]
    np.testing.assert_allclose(float(got[0].loss), float(want[0].loss),
                               rtol=RTOL)
    for k, w in want[1].items():
        assert float((got[1][k] - w).abs().max()) <= GRAD_TOL * max(
            float(w.abs().max()), 1e-3), k


@pytest.mark.parametrize("D,dtype", [(8, torch.bfloat16), (64, torch.float16),
                                     (144, torch.float32)])
def test_gspmd_attention_never_routes_off_the_cpu(D, dtype, monkeypatch):
    """``gspmd_flash_attention`` on a tensor that is not on the CPU (a meta
    tensor stands in for a CUDA one) hands every shape to the kernels: one
    they do not take raises, nothing is counted as routed and nothing
    launches; on a CPU tensor it is the dense path, bit for bit."""
    from ddp_tpu_torch.ops import attention as tattn
    from ddp_tpu_torch.ops import flash as tflash

    fn = tattn.gspmd_flash_attention(mesh=None)
    q, k, v = (torch.empty(2, 65, 1, D, dtype=dtype, device="meta")
               for _ in range(3))
    routed = tflash.flash_attention.plain_routed
    before = dict(tflash.flash_attention.launches)
    with pytest.raises(ValueError, match="flash_attention"):
        fn(q, k, v)
    assert tflash.flash_attention.plain_routed == routed
    assert tflash.flash_attention.launches == before
    calls = []
    monkeypatch.setattr(tattn, "flash_attention",
                        lambda *a: calls.append(a) or a[0])
    monkeypatch.setattr(tattn, "dot_product_attention", None)
    assert fn(q, k, v) is q and len(calls) == 1
    monkeypatch.undo()
    cpu = [torch.tensor(np.random.default_rng(i).standard_normal(
        (2, 65, 1, 16), dtype=np.float32)) for i in range(3)]
    torch.testing.assert_close(fn(*cpu),
                               tattn.dot_product_attention(*cpu),
                               atol=0, rtol=0)
