"""Megatron tensor parallelism (``--mesh_model``), alone and with
``--mesh_seq``, in the port ≡ the JAX package on the same mesh, on the
CPU.

The same seeded weights (the port's init, LayerNorms and biases moved off
their init values; carried into JAX by ``interop/jax_params``) and numpy
token batches go through JAX's sharded step — ``_make_sharded_forward``
with ``_make_sharded_token_metrics`` (the LM) or
``make_seq_parallel_apply`` with the cross-entropy (the long-context
model) under ``jax.value_and_grad``, then the optimizer's update, as
``make_lm_train_step`` / ``make_seq_parallel_train_step`` run them — over
the first ``world`` of the 8 CPU devices, and through the port's mesh
step in an in-process world (``runtime/dist.ThreadWorld``), every rank
holding its shard (``parallel/tp.shard_params``) and its data replica's
rows. Compared: the loss and grad norm (rtol 1e-5), every gathered
leaf's gradient (within 1e-5 of the leaf's largest magnitude, with a
floor of 1e-3 of the gradient's largest), and the updated parameters
(atol 2e-5: tests/test_torch_lm_world.py's limits). Two controls that
double-count must fail: f/g plus an extra all-reduce of the replicated
leaves over ``model``, and the long-context head's gradient summed over
``seq`` without the loss scale. Also: ``seq_param_specs`` equals JAX's on
the same trees, and indivisible dims are refused with JAX's messages.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ddp_tpu.models import lm as jlm
from ddp_tpu.models import seq_transformer as jst
from ddp_tpu.parallel import tp as jtp
from ddp_tpu.runtime.mesh import MeshSpec, make_mesh
from ddp_tpu.train.optim import make_optimizer as jax_make_optimizer
from ddp_tpu_torch.interop.jax_params import (
    flatten_tree,
    lm_params_to_jax,
    seq_transformer_params_to_jax,
)
from ddp_tpu_torch.models import lm as tlm
from ddp_tpu_torch.models import seq_transformer as tst
from ddp_tpu_torch.parallel import tp as ttp
from ddp_tpu_torch.parallel.ddp import TrainState
from ddp_tpu_torch.runtime.dist import ThreadWorld
from ddp_tpu_torch.runtime.mesh import mesh_sizes, thread_mesh
from ddp_tpu_torch.train.config import TrainConfig
from ddp_tpu_torch.train.optim import make_optimizer

RTOL, ATOL, GRAD_TOL = 1e-5, 2e-5, 1e-5
OPT = dict(name="sgd", lr=0.5, momentum=0.9)
LM = dict(vocab_size=32, total_len=16, d_model=32, depth=2, num_heads=4)
LC = dict(num_classes=5, total_len=16, d_in=8, d_model=32, depth=2,
          num_heads=4)


def _moved(state, seed):
    """LayerNorms and biases moved off their init (a zero bias or a unit
    scale hides a transposed or dropped parameter)."""
    rng = np.random.default_rng(seed + 100)
    return {k: (v + rng.uniform(-0.5, 0.5, v.shape)).astype(np.float32)
            if v.ndim == 1 else v for k, v in state.items()}


def _jax_mesh(world, model=1, seq=1, expert=1):
    return make_mesh(MeshSpec(data=-1, model=model, seq=seq, expert=expert),
                     devices=jax.devices()[:world])


def _port_step(build, step_of, state, batches, sizes, world):
    """The port's mesh step on every rank of a thread world → rank 0's
    (metrics, gathered gradients, gathered parameters after the update).
    ``build(state, mesh) -> model``; ``step_of(model, opt, mesh)``;
    ``batches(mesh) -> args`` of this rank's data replica."""
    tw = ThreadWorld(world, timeout=60)

    def body(r):
        mesh = thread_mesh(sizes, tw, r)
        model = build(state, mesh)
        layout = model.shard_layout
        opt = make_optimizer(model.parameters(), **OPT)
        opt.norm = layout.norm
        m = step_of(model, opt, mesh)(*batches(mesh))
        grads = layout.gather({n: p.grad for n, p in model.named_parameters()})
        params = layout.gather(dict(model.named_parameters()))
        return m, grads, params

    return tw.run(body)[0]


def _assert_close(port_metrics, port_grads, port_params, to_jax, jm, jgrads,
                  jparams):
    np.testing.assert_allclose(float(port_metrics.loss), float(jm[0]),
                               rtol=RTOL)
    np.testing.assert_allclose(float(port_metrics.grad_norm),
                               float(optax.global_norm(jgrads)), rtol=RTOL)
    got = flatten_tree(to_jax({k: v.detach() for k, v in port_grads.items()}))
    want = flatten_tree(jax.tree.map(np.asarray, jgrads))
    assert sorted(got) == sorted(want)
    floor = 1e-3 * max(np.abs(w).max() for w in want.values())
    for k in want:
        scale = max(np.abs(want[k]).max(), floor)
        assert np.abs(got[k] - want[k]).max() <= GRAD_TOL * scale, k
    got = flatten_tree(to_jax(port_params))
    want = flatten_tree(jax.tree.map(np.asarray, jparams))
    for k in want:
        assert np.abs(got[k] - want[k]).max() <= ATOL, k


def _jax_update(tree, grads):
    tx = jax_make_optimizer(**OPT)
    updates, _ = tx.update(grads, tx.init(tree), tree)
    return optax.apply_updates(tree, updates)


# ---- the causal LM -----------------------------------------------------


@functools.lru_cache(maxsize=None)
def jax_lm_step(lm_items, world, model=1, seq=1, expert=1, seed=0):
    """JAX's LM step on the mesh (cached: controls reuse it) → (state,
    tokens, tree, loss, gradients, updated parameters); ``lm_items`` the
    spec's fields as sorted pairs."""
    spec = tlm.LMSpec(**dict(lm_items))
    jspec = jlm.LMSpec(**dict(lm_items))
    state = _moved(tlm.init_lm_state(spec, seed=seed), seed)
    rng = np.random.default_rng(seed + 1)
    tokens = rng.integers(0, spec.vocab_size, (4, spec.total_len)).astype(
        np.int32)
    tree = lm_params_to_jax(state)
    mesh = _jax_mesh(world, model=model, seq=seq, expert=expert)
    fwd, _ = jlm._make_sharded_forward(jspec, mesh, jnp.float32)
    metrics = jlm._make_sharded_token_metrics(jspec, mesh)

    def loss_fn(params, toks):
        logits, aux = fwd(params, toks)
        loss, correct = metrics(logits, toks)
        if jspec.num_experts:
            loss = loss + jspec.aux_loss_weight * aux
        return loss, correct

    (jloss, _), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        tree, jnp.asarray(tokens))
    return state, tokens, tree, (jloss,), jgrads, _jax_update(tree, jgrads)


def _lm_case(world, model, seq, *, seed=0):
    spec = tlm.LMSpec(**LM)
    state, tokens, _, jm, jgrads, jparams = jax_lm_step(
        tuple(sorted(LM.items())), world, model, seq, seed=seed)
    B = len(tokens)

    def build(st, m):
        model_ = tlm.CausalLM.from_state(spec, st, "cpu", trainable=True)
        ttp.shard_module(model_, m)
        return model_

    def rows(m):
        per = B // m.data_size
        return (torch.from_numpy(tokens[m.data_rank * per:][:per]).long(),)

    out = _port_step(build, lambda mdl, opt, m: tlm.make_lm_train_step(
        mdl, opt, mesh=m), state, rows,
        mesh_sizes(world, model=model, seq=seq), world)
    return out, jm, jgrads, jparams


LM_MESHES = [(2, 2, 1), (4, 4, 1), (4, 2, 2)]


@pytest.mark.parametrize("world,model,seq", LM_MESHES,
                         ids=[f"world{w}-model{m}-seq{s}"
                              for w, m, s in LM_MESHES])
def test_lm_step_equals_jax_on_the_same_mesh(world, model, seq):
    """One step of the causal LM at --mesh_model 2 and 4, and 2 ×
    --mesh_seq 2: loss, grad norm, every gradient, the updated
    parameters."""
    (m, grads, params), jm, jgrads, jparams = _lm_case(world, model, seq)
    _assert_close(m, grads, params, lm_params_to_jax, jm, jgrads, jparams)


def test_extra_model_reduction_fails(monkeypatch):
    """The first control: f/g, then the replicated leaves' gradients
    all-reduced over ``model`` once more (what a shard_map-style
    reduction added to Megatron's f/g would do) doubles them."""
    real = tlm._reduce_gradients

    def doubled(params, names, layout, mesh, extras):
        rest = real(params, names, layout, mesh, extras)
        for n, p in zip(names, params):
            if n not in layout.specs:
                mesh.comm("model").all_reduce_(p.grad)
        return rest

    monkeypatch.setattr(tlm, "_reduce_gradients", doubled)
    (m, grads, params), jm, jgrads, jparams = _lm_case(2, 2, 1)
    with pytest.raises(AssertionError):
        _assert_close(m, grads, params, lm_params_to_jax, jm, jgrads,
                      jparams)


# ---- the long-context classifier ---------------------------------------


@functools.lru_cache(maxsize=None)
def jax_lc_step(world, model, seq, strategy, seed=0):
    """JAX's long-context step on the mesh (cached) → (state, x, y, loss,
    gradients, updated parameters)."""
    spec = tst.SeqTransformerSpec(**LC, strategy=strategy)
    jspec = jst.SeqTransformerSpec(**LC, strategy=strategy)
    state = _moved(tst.init_seq_transformer(spec, seed=seed), seed)
    rng = np.random.default_rng(seed + 1)
    x = rng.standard_normal((4, LC["total_len"], LC["d_in"])).astype(
        np.float32)
    y = rng.integers(0, LC["num_classes"], 4).astype(np.int32)
    tree = seq_transformer_params_to_jax(state)
    apply = jst.make_seq_parallel_apply(
        jspec, _jax_mesh(world, model=model, seq=seq))

    def loss_fn(params):
        logits = apply(params, jnp.asarray(x))
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(y)).mean()

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(tree)
    return state, x, y, (jloss,), jgrads, _jax_update(tree, jgrads)


def _lc_case(world, model, seq, strategy="ring", *, seed=0):
    spec = tst.SeqTransformerSpec(**LC, strategy=strategy)
    state, x, y, jm, jgrads, jparams = jax_lc_step(world, model, seq,
                                                   strategy, seed)
    B = len(y)

    def rows(m):
        per = B // m.data_size
        lo = m.data_rank * per
        return torch.from_numpy(x[lo:lo + per]), torch.from_numpy(
            y[lo:lo + per]).long()

    out = _port_step(
        lambda st, m: tst.build_model(spec, st, "cpu", mesh=m),
        lambda mdl, opt, m: tst.make_seq_parallel_train_step(
            TrainState(0, mdl, opt), m),
        state, rows, mesh_sizes(world, model=model, seq=seq), world)
    return out, jm, jgrads, jparams


LC_MESHES = [(2, 2, 1, "ring"), (4, 2, 2, "ring"), (4, 1, 4, "ring"),
             (4, 2, 2, "ulysses")]


@pytest.mark.parametrize("world,model,seq,strategy", LC_MESHES,
                         ids=[f"world{w}-model{m}-seq{s}-{st}"
                              for w, m, s, st in LC_MESHES])
def test_long_context_step_equals_jax_on_the_same_mesh(world, model, seq,
                                                       strategy):
    """One step of the long-context classifier at --mesh_model 2, 2 ×
    --mesh_seq 2 (ring and Ulysses) and --mesh_seq 4: loss, grad norm,
    every gradient, the updated parameters."""
    (m, grads, params), jm, jgrads, jparams = _lc_case(world, model, seq,
                                                       strategy)
    _assert_close(m, grads, params, seq_transformer_params_to_jax, jm,
                  jgrads, jparams)


def test_head_summed_over_seq_without_the_scale_fails(monkeypatch):
    """The second control: every seq rank computes the same pooled logits;
    without the 1/n_seq scale on its loss, the sum over ``seq`` counts the
    head's gradient (and every token's) n times."""
    monkeypatch.setattr(tst, "seq_loss_scale", lambda n: 1.0)
    (m, grads, params), jm, jgrads, jparams = _lc_case(2, 1, 2)
    with pytest.raises(AssertionError):
        _assert_close(m, grads, params, seq_transformer_params_to_jax, jm,
                      jgrads, jparams)


# ---- the layout and the guards -------------------------------------------


def _jax_spec_of(port_name, port_specs, ndim):
    """A port ((dim, axis), ...) entry as JAX's PartitionSpec tuple on the
    JAX leaf: a Dense weight is the kernel transposed."""
    entry = [None] * ndim
    for dim, axis in port_specs.get(port_name, ()):
        linear = port_name.endswith(".weight") and ndim == 2
        entry[1 - dim if linear else dim] = axis
    return tuple(entry)


@pytest.mark.parametrize("family,sizes", [
    ("lm", dict(model=2)), ("lm", dict(model=4, seq=2)),
    ("moe", dict(expert=2)), ("moe", dict(expert=2, model=2)),
    ("lc", dict(model=2)), ("lc", dict(model=4)),
])
def test_param_specs_equal_jax(family, sizes):
    """``seq_param_specs`` on the port's state assigns every leaf JAX's
    axis and dim on the same tree and mesh (``fsdp`` 1)."""
    world = int(np.prod(list(sizes.values())))
    if family == "lc":
        state = tst.init_seq_transformer(tst.SeqTransformerSpec(**LC))
        to_jax = seq_transformer_params_to_jax
    else:
        extra = dict(num_experts=4, num_kv_heads=2) if family == "moe" else {}
        state = tlm.init_lm_state(tlm.LMSpec(**LM, **extra))
        to_jax = lm_params_to_jax
    jmesh = _jax_mesh(world, **sizes)
    tree = to_jax(state)
    specs = jtp.seq_param_specs(tree, jmesh)
    flat_specs = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, prefix + k + "/")
            else:
                flat_specs[prefix + k] = v

    walk(specs, "")
    port = ttp.seq_param_specs({k: v.shape for k, v in state.items()},
                               thread_mesh(mesh_sizes(world, **sizes),
                                           ThreadWorld(world), 0))
    # The port's names in JAX's flat paths, through the interop.
    for name, v in state.items():
        path = next(iter(flatten_tree(to_jax({name: v}))))
        want = tuple(flat_specs[path]) + (None,) * (
            np.ndim(v) - len(tuple(flat_specs[path])))
        assert _jax_spec_of(name, port, np.ndim(v)) == want, name


def test_indivisible_dims_refused_with_jax_messages():
    """A dim the axis does not divide is refused by both, in the same
    words (the row-parallel projection's 32 inputs over a model axis of
    3); the
    trainer's guards refuse heads, 4·d and kv heads as JAX's trainer
    does."""
    state = tlm.init_lm_state(tlm.LMSpec(**LM))
    words = (r"attn.proj.*: dim 32 not divisible by the sharding axis size 3 "
             r"\(num_heads and mlp_dim must divide by --mesh_model; "
             r"num_experts by --mesh_expert\)")
    with pytest.raises(ValueError, match=words):
        jtp.seq_param_specs(lm_params_to_jax(state), _jax_mesh(3, model=3))
    with pytest.raises(ValueError, match=words):
        ttp.seq_param_specs({k: v.shape for k, v in state.items()},
                            thread_mesh(mesh_sizes(3, model=3),
                                        ThreadWorld(3), 0))
    base = ["--model", "causal_lm", "--model_dim", "48", "--spawn", "8"]
    for extra, match in (
            (["--num_heads", "6", "--mesh_model", "4"],
             "splits attention heads: --num_heads 6 not divisible by "
             "--mesh_model 4"),
            (["--num_heads", "3", "--model_dim", "40", "--mesh_model", "3"],
             r"splits the MLP hidden dim: 160 \(4 × --model_dim\) not "
             "divisible by --mesh_model 3"),
            (["--num_heads", "4", "--num_kv_heads", "1", "--mesh_model", "2"],
             "GQA under TP shards whole kv groups: --num_kv_heads 1 not "
             "divisible by --mesh_model 2")):
        with pytest.raises(ValueError, match=match):
            TrainConfig.from_args(base + extra)
