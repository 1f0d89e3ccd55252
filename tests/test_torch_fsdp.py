"""FSDP of the sequence models (``--mesh_fsdp``, ``ddp_tpu_torch/parallel/
seq_fsdp.py``) ≡ the JAX package on the same mesh, on the CPU (after
``tests/test_seq_compose.py`` and ``tests/test_tp.py``).

- ``seq_param_specs`` gives every leaf of the LM, the long-context and
  the routed LM's trees JAX's axes and dims (through the [out, in] ↔
  [in, out] map) at fsdp 2, alone and with model 2 and expert 2.
- One SGD-momentum step at data 2 × fsdp 2 × seq 2 (world 8), fsdp 2 ×
  model 2, fsdp 2 × expert 2 (the routed LM; its routing held exactly by
  the gradients) and the long-context model at fsdp 2 × seq 2 (ring and
  Ulysses) equals JAX's step on the same mesh: the loss and grad norm
  (rtol 1e-5), every gathered leaf's gradient (1e-5 of its scale), the
  parameters and the momentum (atol 2e-5): tests/test_torch_tp.py's
  limits.
- At rest the parameters and the moments are 1/fsdp a rank where JAX
  shards them and whole where it does not
  (``test_fsdp_actually_shards_params_and_moments``).
- Two double-count controls must fail: an fsdp leaf's gradient left
  unscaled by the axis (the reduce-scatter's 1/n dropped), and an fsdp
  leaf also all-reduced over the data axes after its reduce-scatter.

Port worlds run in threads (``runtime/dist.ThreadWorld``); JAX over the
first ``world`` of the 8 CPU devices.
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
from ddp_tpu_torch.interop.jax_params import (
    flatten_tree,
    lm_params_to_jax,
    seq_transformer_params_to_jax,
)
from ddp_tpu_torch.models import lm as tlm
from ddp_tpu_torch.models import seq_transformer as tst
from ddp_tpu_torch.parallel import seq_fsdp
from ddp_tpu_torch.parallel import tp as ttp
from ddp_tpu_torch.parallel.ddp import TrainState
from ddp_tpu_torch.runtime.dist import ThreadWorld
from ddp_tpu_torch.runtime.mesh import mesh_sizes, thread_mesh
from ddp_tpu_torch.train.optim import make_optimizer
from test_torch_tp import ATOL, OPT, _assert_close, _jax_update, _moved

LM = dict(vocab_size=32, total_len=16, d_model=32, depth=1, num_heads=4)
LC = dict(num_classes=5, total_len=16, d_in=8, d_model=32, depth=1,
          num_heads=4)
MOE_LM = dict(vocab_size=32, total_len=16, d_model=32, depth=1, num_heads=4,
              num_kv_heads=2, num_experts=4, moe_every=1)


def _jax_mesh(world, **sizes):
    return make_mesh(MeshSpec(data=-1, **sizes),
                     devices=jax.devices()[:world])


def _flat_specs(specs):
    out = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, prefix + k + "/")
            else:
                out[prefix + k] = tuple(v)

    walk(specs, "")
    return out


def _as_jax_spec(name, pairs, ndim):
    """A port entry ((dim, axis), ...) as JAX's PartitionSpec tuple."""
    entry = [None] * ndim
    for dim, axis in pairs:
        entry[ttp.jax_dim(name, ndim, dim)] = axis
    return tuple(entry)


FAMILIES = [("lm", dict(fsdp=2)), ("lm", dict(fsdp=2, model=2)),
            ("lc", dict(fsdp=2)), ("lc", dict(fsdp=2, model=2)),
            ("moe", dict(fsdp=2)), ("moe", dict(fsdp=2, expert=2))]


@pytest.mark.parametrize("family,sizes", FAMILIES,
                         ids=[f"{f}-" + "-".join(f"{k}{v}" for k, v in s.items())
                              for f, s in FAMILIES])
def test_param_specs_equal_jax(family, sizes):
    world = int(np.prod(list(sizes.values())))
    if family == "lc":
        state = tst.init_seq_transformer(tst.SeqTransformerSpec(**LC))
        to_jax = seq_transformer_params_to_jax
    else:
        state = tlm.init_lm_state(tlm.LMSpec(**(MOE_LM if family == "moe"
                                                else LM)))
        to_jax = lm_params_to_jax
    want = _flat_specs(jtp.seq_param_specs(to_jax(state),
                                           _jax_mesh(world, **sizes)))
    mesh = thread_mesh(mesh_sizes(world, **sizes), ThreadWorld(world), 0)
    port = ttp.seq_param_specs({k: v.shape for k, v in state.items()}, mesh)
    assert any("fsdp" in dict(map(reversed, p)) for p in port.values())
    for name, v in state.items():
        path = next(iter(flatten_tree(to_jax({name: v}))))
        w = want[path] + (None,) * (np.ndim(v) - len(want[path]))
        assert _as_jax_spec(name, port.get(name, ()), np.ndim(v)) == w, name


# ---- one step against JAX's on the same mesh -------------------------


@functools.lru_cache(maxsize=None)
def jax_lm_step(lm_items, world, sizes_items, seed=0):
    spec = tlm.LMSpec(**dict(lm_items))
    jspec = jlm.LMSpec(**dict(lm_items))
    state = _moved(tlm.init_lm_state(spec, seed=seed), seed)
    tokens = np.random.default_rng(seed + 1).integers(
        0, spec.vocab_size, (8, spec.total_len)).astype(np.int32)
    tree = lm_params_to_jax(state)
    mesh = _jax_mesh(world, **dict(sizes_items))
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
    return state, tokens, (jloss,), jgrads, _jax_update(tree, jgrads)


@functools.lru_cache(maxsize=None)
def jax_lc_step(world, sizes_items, strategy, seed=0):
    spec = tst.SeqTransformerSpec(**LC, strategy=strategy)
    jspec = jst.SeqTransformerSpec(**LC, strategy=strategy)
    state = _moved(tst.init_seq_transformer(spec, seed=seed), seed)
    rng = np.random.default_rng(seed + 1)
    x = rng.standard_normal((8, LC["total_len"], LC["d_in"])).astype(
        np.float32)
    y = rng.integers(0, LC["num_classes"], 8).astype(np.int32)
    tree = seq_transformer_params_to_jax(state)
    apply = jst.make_seq_parallel_apply(jspec,
                                        _jax_mesh(world, **dict(sizes_items)))

    def loss_fn(params):
        logits = apply(params, jnp.asarray(x))
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(y)).mean()

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(tree)
    return state, (x, y), (jloss,), jgrads, _jax_update(tree, jgrads)


def _port_step(family, state, batch, sizes, world, strategy="ring"):
    """The port's mesh step on every rank of a thread world → rank 0's
    (metrics, gathered gradients, gathered parameters, gathered momentum,
    per-rank local/full sizes of parameters and moments)."""
    tw = ThreadWorld(world, timeout=60)

    def body(r):
        mesh = thread_mesh(sizes, tw, r)
        per = len(batch[0]) // mesh.data_size
        rows = slice(mesh.data_rank * per, (mesh.data_rank + 1) * per)
        if family == "lc":
            spec = tst.SeqTransformerSpec(**LC, strategy=strategy)
            model = tst.build_model(spec, state, "cpu", mesh=mesh)
            args = (torch.from_numpy(batch[0][rows]),
                    torch.from_numpy(batch[1][rows]).long())
        else:
            lm = MOE_LM if family == "moe" else LM
            model = tlm.CausalLM.from_state(tlm.LMSpec(**lm), state, "cpu",
                                            trainable=True)
            ttp.shard_module(model, mesh)
            args = (torch.from_numpy(batch[0][rows]).long(),)
        layout = model.shard_layout
        opt = make_optimizer(model.parameters(), **OPT)
        opt.norm = layout.norm
        if family == "lc":
            step = tst.make_seq_parallel_train_step(
                TrainState(0, model, opt), mesh)
        else:
            step = tlm.make_lm_train_step(model, opt, mesh=mesh)
        m = step(*args)
        named = dict(model.named_parameters())
        grads = layout.gather({n: p.grad for n, p in named.items()})
        params = layout.gather(named)
        trace = layout.gather(dict(zip(named, opt.trace)))
        sizes_ = {n: (p.numel(), b.numel())
                  for (n, p), b in zip(named.items(), opt.trace)}
        return m, grads, params, trace, sizes_

    return tw.run(body)


CASES = {
    "data2-fsdp2-seq2": ("lm", 8, dict(fsdp=2, seq=2), "ring"),
    "fsdp2-model2": ("lm", 4, dict(fsdp=2, model=2), "ring"),
    "fsdp2-expert2": ("moe", 4, dict(fsdp=2, expert=2), "ring"),
    "lc-fsdp2-seq2-ring": ("lc", 4, dict(fsdp=2, seq=2), "ring"),
    "lc-fsdp2-seq2-ulysses": ("lc", 4, dict(fsdp=2, seq=2), "ulysses"),
}


def _case(name):
    family, world, sizes, strategy = CASES[name]
    items = tuple(sorted(sizes.items()))
    if family == "lc":
        state, batch, jm, jgrads, jparams = jax_lc_step(world, items,
                                                        strategy)
        to_jax = seq_transformer_params_to_jax
    else:
        lm = MOE_LM if family == "moe" else LM
        state, tokens, jm, jgrads, jparams = jax_lm_step(
            tuple(sorted(lm.items())), world, items)
        batch = (tokens,)
        to_jax = lm_params_to_jax
    ranks = _port_step(family, state, batch, mesh_sizes(world, **sizes),
                       world, strategy)
    return ranks, to_jax, jm, jgrads, jparams


@pytest.mark.parametrize("case", list(CASES))
def test_fsdp_step_equals_jax_on_the_same_mesh(case):
    ranks, to_jax, jm, jgrads, jparams = _case(case)
    m, grads, params, trace, _ = ranks[0]
    _assert_close(m, grads, params, to_jax, jm, jgrads, jparams)
    # After one step SGD's momentum trace is the (reduced) gradient.
    got = flatten_tree(to_jax(trace))
    for k, w in flatten_tree(jax.tree.map(np.asarray, jgrads)).items():
        assert np.abs(got[k] - w).max() <= ATOL, k


def test_fsdp_shards_params_and_moments_at_rest():
    """At data 2 × fsdp 2 × seq 2 every leaf JAX shards over fsdp rests
    as half of itself on a rank, its moment too; the position table
    ([1, L, d]: dim 0 does not divide) stays whole."""
    ranks, *_ = _case("data2-fsdp2-seq2")
    full = tlm.init_lm_state(tlm.LMSpec(**LM))
    specs = ttp.seq_param_specs({k: v.shape for k, v in full.items()},
                                thread_mesh(mesh_sizes(8, fsdp=2, seq=2),
                                            ThreadWorld(8), 0))
    assert "pos_embed" not in specs and "embed" in specs
    for _, _, _, _, sizes in ranks:
        for name, (param, moment) in sizes.items():
            want = full[name].size // (2 if name in specs else 1)
            assert param == moment == want, name
    local = sum(p for p, _ in ranks[0][4].values())
    assert local < 0.6 * sum(v.size for v in full.values())


@pytest.mark.parametrize("fault", ["drop_scale", "double"])
def test_double_count_controls_fail(monkeypatch, fault):
    """An fsdp leaf's gradient without the reduce-scatter's 1/n, or
    all-reduced over the data axes once more after it, leaves JAX's."""
    monkeypatch.setattr(seq_fsdp, "FAULT", fault)
    ranks, to_jax, jm, jgrads, jparams = _case("fsdp2-model2")
    m, grads, params, _, _ = ranks[0]
    with pytest.raises(AssertionError):
        _assert_close(m, grads, params, to_jax, jm, jgrads, jparams)
