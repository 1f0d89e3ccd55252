"""ddp_tpu_torch's ResNet ≡ the JAX package's (Flax), on the CPU.

Shared weights (random, BatchNorm scales included, so every conv counts;
carried across by ``interop/jax_params.resnet_params_from_jax``) and the
same inputs go through ``ddp_tpu.models.resnet`` and the port at width 8:
a BasicBlock ResNet with the CIFAR stem at 32×32, and a Bottleneck ResNet
with the ImageNet stem at 64×64 (SAME padding at stride 2 and the −inf
max pool). Compared: logits in train and eval mode, the gradient, and the
running mean and variance after a train step; then one DDP step of world
2 (two threads summing one bucket) against a 2-device JAX mesh, with the
running statistics averaged, and a checkpoint round trip of them.

Tolerances: fp32, every tensor within 1e-5 of its own scale (max|want|,
at least 1): the frameworks sum in other orders. The DDP steps, as
tests/test_torch_ddp.py: metrics rtol 1e-5, parameters and statistics
atol 2e-5. bf16 compute: 2e-2 of the scale (bf16 rounds at other places
in the two frameworks). Each trap the port must get right has a
negative control that must fail the same check: torch's unbiased running
variance, torch's momentum 0.1, and symmetric padding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from ddp_tpu.models import resnet as jres
from ddp_tpu.parallel import common as jcommon
from ddp_tpu.parallel import ddp as jddp
from ddp_tpu.runtime.mesh import MeshSpec, make_mesh
from ddp_tpu.train.optim import make_optimizer as jax_make_optimizer
from ddp_tpu_torch.interop.jax_params import (
    flatten_tree,
    resnet_params_from_jax,
    resnet_params_to_jax,
)
from ddp_tpu_torch.models import get_model
from ddp_tpu_torch.models import resnet as tres
from ddp_tpu_torch.parallel.common import _preprocess
from ddp_tpu_torch.parallel.ddp import TrainState, make_eval_step, make_train_step
from ddp_tpu_torch.runtime import dist as tdist
from ddp_tpu_torch.train import checkpoint as ck
from ddp_tpu_torch.train.optim import make_optimizer

TOL = 1e-5
BF16_TOL = 2e-2
RTOL, ATOL = 1e-5, 2e-5
KINDS = {  # JAX block, port block, CIFAR stem, image side
    "cifar_basic": (jres.BasicBlock, tres.BasicBlock, True, 32),
    "imagenet_bottleneck": (jres.BottleneckBlock, tres.BottleneckBlock,
                            False, 64),
}


def _models(kind):
    jblock, tblock, stem, side = KINDS[kind]
    jm = jres.ResNet((1, 1), jblock, num_classes=10, width=8, cifar_stem=stem)
    tm = tres.ResNet((1, 1), tblock, 10, width=8, cifar_stem=stem)
    return jm, tm, side


def _variables(jm, side, seed=0):
    """Random params (He-scale convs, BN scales in [0.5, 1.5], biases and
    running statistics off their init) → (params, batch_stats)."""
    v = jax.eval_shape(lambda: jm.init(
        jax.random.key(0), jnp.zeros((1, side, side, 3)), train=False))
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        name = jax.tree_util.keystr(path)
        if a.ndim == 4:
            fan_in = a.shape[0] * a.shape[1] * a.shape[2]
            return rng.standard_normal(a.shape, np.float32) * np.float32(
                (2 / fan_in) ** 0.5)
        if a.ndim == 2:
            return rng.standard_normal(a.shape, np.float32) * np.float32(
                a.shape[0] ** -0.5)
        if "scale" in name:
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if "var" in name:
            return rng.uniform(0.5, 2.0, a.shape).astype(np.float32)
        return rng.normal(0, 0.1, a.shape).astype(np.float32)

    return (jax.tree_util.tree_map_with_path(leaf, v["params"]),
            jax.tree_util.tree_map_with_path(leaf, v["batch_stats"]))


def _load(tm, params, stats):
    tm.load_state_dict({k: torch.tensor(v) for k, v in
                        resnet_params_from_jax(params, stats).items()})
    return tm


def _images(side, n=4, seed=1):
    return np.random.default_rng(seed).random((n, side, side, 3),
                                              dtype=np.float32)


def _scale_err(got, want):
    """max |got − want| over want's scale (max |want|, at least 1)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max()) / max(1.0, float(np.abs(want).max()))


def _tree_err(got, want):
    """The worst :func:`_scale_err` over the leaves of two trees."""
    g, w = flatten_tree(got), flatten_tree(jax.tree.map(np.asarray, want))
    assert sorted(g) == sorted(w)
    return max(_scale_err(g[k], w[k]) for k in w)


def _flax_train(jm, params, stats, x, y):
    """Flax in train mode → (logits, grads tree, new batch_stats)."""
    def loss(p):
        logits, new = jm.apply({"params": p, "batch_stats": stats},
                               jnp.asarray(x), train=True,
                               mutable=["batch_stats"])
        xe = optax.softmax_cross_entropy_with_integer_labels(logits, y).mean()
        return xe, (logits, new["batch_stats"])

    (_, (logits, new)), grads = jax.jit(
        jax.value_and_grad(loss, has_aux=True))(params)
    return logits, grads, new


def _port_train(tm, x, y):
    tm.train()
    logits = tm(torch.tensor(x).permute(0, 3, 1, 2))
    F.cross_entropy(logits, torch.tensor(y).long()).backward()
    grads = {n: p.grad for n, p in tm.named_parameters()}
    stats = resnet_params_to_jax(tm.state_dict())[1]
    return logits.detach().numpy(), resnet_params_to_jax(grads)[0], stats


def _compare(kind, seed=0):
    """Every reading of the forward/backward/statistics parity → errors."""
    jm, tm, side = _models(kind)
    params, stats = _variables(jm, side, seed)
    x = _images(side)
    y = np.arange(4, dtype=np.int32)
    errs = {}
    want = jax.jit(lambda v, x: jm.apply(v, x, train=False))(
        {"params": params, "batch_stats": stats}, jnp.asarray(x))
    tm = _load(tm, params, stats).eval()
    with torch.no_grad():
        errs["eval logits"] = _scale_err(
            tm(torch.tensor(x).permute(0, 3, 1, 2)), want)
    j_logits, j_grads, j_stats = _flax_train(jm, params, stats, x, y)
    t_logits, t_grads, t_stats = _port_train(tm, x, y)
    errs["train logits"] = _scale_err(t_logits, j_logits)
    errs["gradient"] = _tree_err(t_grads, j_grads)
    errs["running stats"] = _tree_err(t_stats, j_stats)
    return errs


@pytest.mark.parametrize("kind", list(KINDS))
def test_forward_gradient_and_running_stats_equal_flax(kind):
    errs = _compare(kind)
    assert max(errs.values()) <= TOL, errs


@pytest.mark.parametrize("trap,patch,fails", [
    ("unbiased running variance", "batch_stats", "running stats"),
    ("torch's momentum 0.1", "BN_MOMENTUM", "running stats"),
    ("symmetric padding", "same_pads", "eval logits"),
])
@pytest.mark.parametrize("kind", list(KINDS))
def test_each_trap_fails_the_parity_check(monkeypatch, kind, trap, patch,
                                          fails):
    """Negative controls: the port with one of torch's defaults in place
    of Flax's must fail the same check."""
    wrong = {
        "batch_stats": lambda x: tuple(reversed(torch.var_mean(
            x.float(), dim=(0, 2, 3), unbiased=True))),
        "BN_MOMENTUM": 0.1,
        "same_pads": lambda size, kernel, stride: (kernel // 2, kernel // 2),
    }[patch]
    monkeypatch.setattr(tres, patch, wrong)
    errs = _compare(kind)
    assert errs[fails] > TOL, (trap, errs)


def test_bf16_batch_norm_normalises_in_fp32_and_outputs_bf16():
    """compute_dtype bf16, as the JAX step runs it (``make_loss_fn``: the
    params cast to bf16, the running statistics fp32): the BN output is
    bf16, the logits and the new running statistics agree with JAX's."""
    jm, tm, side = _models("cifar_basic")
    params, stats = _variables(jm, side)
    images = (_images(side, seed=3) * 255).astype(np.uint8)
    labels = np.arange(4, dtype=np.int32)
    loss_fn = jcommon.make_loss_fn(jm, jnp.bfloat16, 0.0)
    _, (j_logits, new) = jax.jit(lambda *a: loss_fn(*a, ["batch_stats"]))(
        params, {"batch_stats": stats}, jnp.asarray(images),
        jnp.asarray(labels), jax.random.key(0))
    tm = _load(tm, params, stats).train()
    x = _preprocess(torch.tensor(images), torch.bfloat16)
    seen = []
    tm.stem_bn.register_forward_hook(lambda m, i, o: seen.append(o.dtype))
    with torch.no_grad():
        t_logits = tm(x, compute_dtype=torch.bfloat16)
    assert seen == [torch.bfloat16] and t_logits.dtype == torch.float32
    assert tm.stem_bn.running_var.dtype == torch.float32
    assert _scale_err(t_logits, np.asarray(j_logits, np.float32)) <= BF16_TOL
    t_stats = resnet_params_to_jax(tm.state_dict())[1]
    assert _tree_err(t_stats, new["batch_stats"]) <= BF16_TOL


def test_fp64_model_computes_in_fp64():
    """A model cast to fp64 keeps fp64 through the BatchNorm statistics
    and the head (a reference for fp32 steps, whose rounding it does not
    share): fp64 logits within 1e-5 of the fp32 model's, and fp64 running
    statistics."""
    jm, tm, side = _models("cifar_basic")
    tm = _load(tm, *_variables(jm, side)).train()
    x = torch.tensor(_images(side, seed=4)).permute(0, 3, 1, 2)
    t64 = tres.ResNet((1, 1), tres.BasicBlock, 10, width=8, cifar_stem=True)
    t64.load_state_dict(tm.state_dict())
    t64 = t64.double().train()
    with torch.no_grad():
        want, got = tm(x), t64(x.double())
    assert got.dtype == torch.float64
    assert t64.stem_bn.running_var.dtype == torch.float64
    assert _scale_err(got, want.numpy()) <= TOL


@pytest.mark.parametrize("name,classes,stem", [
    ("resnet18", 10, True), ("resnet34", 1000, False),
    ("resnet50", 1000, False)])
def test_full_width_parameter_and_statistics_counts_equal_flax(name, classes,
                                                               stem):
    ctor = {"resnet18": jres.ResNet18, "resnet34": jres.ResNet34,
            "resnet50": jres.ResNet50}[name]
    shapes = jax.eval_shape(
        lambda: ctor(num_classes=classes, cifar_stem=stem).init(
            jax.random.key(0), jnp.zeros((1, 32, 32, 3)), train=False))
    tm = get_model(name, num_classes=classes, side=32, in_channels=3)
    got = resnet_params_to_jax(tm.state_dict())
    for mine, theirs in zip(got, (shapes["params"], shapes["batch_stats"])):
        g = {k: v.shape for k, v in flatten_tree(mine).items()}
        w = {"/".join(str(getattr(p, "key", p)) for p in path): leaf.shape
             for path, leaf in jax.tree_util.tree_leaves_with_path(theirs)}
        assert g == w
    if name == "resnet18":
        assert sum(p.numel() for p in tm.parameters()) == 11_173_962


# ---- the data-parallel step ----------------------------------------------

def _run_jax(params, stats, batches, world, accum):
    jm, _, _ = _models("cifar_basic")
    tx = jax_make_optimizer(name="sgd", lr=0.05, momentum=0.9)
    mesh = make_mesh(MeshSpec(data=world), devices=jax.devices()[:world])
    state = jddp.replicate_state(jddp.TrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        opt_state=tx.init(params), model_state={"batch_stats": stats}), mesh)
    step = jddp.make_train_step(jm, tx, mesh, donate=False,
                                grad_accum_steps=accum)
    rows = []
    for x, y in batches:
        state, m = step(state, jnp.asarray(x), jnp.asarray(y))
        rows.append((float(m.loss), float(m.accuracy), float(m.grad_norm)))
    return state, rows


def _run_port(params, stats, batches, world, accum):
    tw = tdist.ThreadWorld(world)

    def rank_body(rank):
        _, tm, _ = _models("cifar_basic")
        tm = _load(tm, params, stats)
        state = TrainState(0, tm, make_optimizer(tm.parameters(), "sgd",
                                                 lr=0.05, momentum=0.9))
        step = make_train_step(state, world=world, reduce=tw.reduce(rank),
                               grad_accum_steps=accum, rank=rank)
        local = len(batches[0][1]) // world
        rows = []
        for x, y in batches:
            sl = slice(rank * local, (rank + 1) * local)
            m = step(torch.tensor(x[sl]), torch.tensor(y[sl]))
            rows.append((float(m.loss), float(m.accuracy), float(m.grad_norm)))
        return state, rows

    return tw.run(rank_body)


def _batches(n, size=8, seed=2):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 256, (size, 32, 32, 3), dtype=np.uint8),
             rng.integers(0, 10, size).astype(np.int32)) for _ in range(n)]


@pytest.mark.parametrize("world,accum", [(2, 1), (1, 2)],
                         ids=["world2", "accum2"])
def test_ddp_step_matches_jax_with_running_stats_averaged(world, accum):
    """Two SGD-momentum steps: world 2 (the running statistics averaged
    over the ranks in the step's bucket, as JAX's pmean of new_ms), and
    world 1 with two microbatches (the statistics advance once each)."""
    jm, _, side = _models("cifar_basic")
    params, stats = _variables(jm, side)
    batches = _batches(2)
    jstate, jrows = _run_jax(params, stats, batches, world, accum)
    for state, rows in _run_port(params, stats, batches, world, accum):
        np.testing.assert_allclose(np.array(rows), np.array(jrows), rtol=RTOL)
        got_p, got_s = resnet_params_to_jax(state.model.state_dict())
        for got, want in ((got_p, jstate.params),
                          (got_s, jstate.model_state["batch_stats"])):
            g, w = flatten_tree(got), flatten_tree(jax.tree.map(np.asarray, want))
            for k in w:
                np.testing.assert_allclose(g[k], w[k], atol=ATOL, rtol=0,
                                           err_msg=k)
        assert state.step == 2
    if world == 2:
        # The control: a rank's own statistics, not averaged, part from
        # JAX's (each rank saw other images).
        (alone, _), = _run_port(params, stats, [(x[:4], y[:4])
                                                for x, y in batches[:1]], 1, 1)
        jone, _ = _run_jax(params, stats, batches[:1], 2, 1)
        g = flatten_tree(resnet_params_to_jax(alone.model.state_dict())[1])
        w = flatten_tree(jax.tree.map(np.asarray,
                                      jone.model_state["batch_stats"]))
        assert max(float(np.abs(g[k] - w[k]).max()) for k in w) > 10 * ATOL


def test_eval_uses_the_running_averages():
    """The eval step's loss (running statistics) differs from the loss of
    a train-mode forward on the same batch (batch statistics), and equals
    Flax's eval-mode loss."""
    jm, tm, side = _models("cifar_basic")
    params, stats = _variables(jm, side)
    tm = _load(tm, params, stats)
    x, y = _batches(1)[0]
    c, total = make_eval_step(tm, reduce=lambda t: t)(
        torch.tensor(x), torch.tensor(y), torch.ones(8))
    logits = jm.apply({"params": params, "batch_stats": stats},
                      jnp.asarray(x) / 255.0, train=False)
    want = float(optax.softmax_cross_entropy_with_integer_labels(
        logits, jnp.asarray(y)).sum())
    np.testing.assert_allclose(float(total), want, rtol=RTOL)
    tm.train()
    with torch.no_grad():
        train_logits = tm(_preprocess(torch.tensor(x), torch.float32))
    train_loss = float(F.cross_entropy(train_logits, torch.tensor(y).long(),
                                       reduction="sum"))
    assert abs(train_loss - float(total)) > 1e-3 * abs(float(total))


def test_checkpoint_round_trip_of_the_running_stats_is_bitwise(tmp_path):
    """After two steps the running statistics have moved; a save and a
    restore into a fresh model bring back every buffer bit for bit."""
    jm, tm, side = _models("cifar_basic")
    params, stats = _variables(jm, side)
    (state, _), = _run_port(params, stats, _batches(2), 1, 1)
    moved = state.model.stem_bn.running_mean
    assert not torch.equal(moved, torch.tensor(np.asarray(
        stats["stem_bn"]["mean"])))
    mgr = ck.CheckpointManager(str(tmp_path))
    mgr.save(0, state)
    blob = mgr.read(0)
    assert "stage2_block1.downsample_bn.running_var" in blob["params"]
    _, fresh, _ = _models("cifar_basic")
    again = TrainState(0, fresh, make_optimizer(fresh.parameters(), "sgd",
                                                lr=0.05, momentum=0.9))
    assert mgr.restore(again) == 0 and again.step == 2
    for k, v in state.model.state_dict().items():
        assert torch.equal(again.model.state_dict()[k], v), k
