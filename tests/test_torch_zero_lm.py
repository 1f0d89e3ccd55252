"""The causal LM under ``--parallel zero`` ≡ the JAX package's zero LM
step on the same mesh, on the CPU (after ``tests/test_zero.py``'s
``test_zero_lm_gspmd_matches_plain_lm`` and
``test_zero_lm_composes_with_model_axis``).

JAX runs ``make_lm_train_step(..., zero_layout=, zero_grad_clip_norm=)``
(the in-graph ``zero_gspmd_update``: buckets sharded over ``data``,
replicated over ``model``/``seq``) on the port's seeded weights over the
first 4 CPU devices; the port runs ``models/lm.make_lm_train_step`` with a
``parallel/zero.ZeroOptimizer`` on the data group in an in-process world,
every rank holding its ``model`` shard and its replica's rows, the
buckets reduce-scattered over ``data`` after the ``seq`` sum. At data 2,
data 2 × model 2 and data 2 × seq 2, with the in-step clip engaged,
three SGD-momentum steps: the loss and the grad norm every step (rtol
1e-5), the parameters and the momentum after the last (atol 2e-5).
A clip whose norm sums the replicated leaves over ``model`` too must
fail.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from ddp_tpu.models import lm as jlm
from ddp_tpu.models.seq_transformer import _batch_axes
from ddp_tpu.parallel import ddp as jddp
from ddp_tpu.parallel import zero as jz
from ddp_tpu.runtime.mesh import MeshSpec, make_mesh
from ddp_tpu.train.optim import make_optimizer as jax_make_optimizer
from ddp_tpu_torch.interop.jax_params import flatten_tree, lm_params_to_jax
from ddp_tpu_torch.models import lm as tlm
from ddp_tpu_torch.parallel import tp as ttp
from ddp_tpu_torch.parallel import zero as tz
from ddp_tpu_torch.runtime.dist import ThreadWorld
from ddp_tpu_torch.runtime.mesh import mesh_sizes, thread_mesh
from test_torch_tp import _moved

RTOL, ATOL = 1e-5, 2e-5
LM = dict(vocab_size=32, total_len=16, d_model=32, depth=1, num_heads=4)
OPT = dict(name="sgd", lr=0.05, momentum=0.9)
CLIP, BUCKET_MB, STEPS = 0.5, 0.01, 3
MESHES = {"data2": dict(), "data2-model2": dict(model=2),
          "data2-seq2": dict(seq=2)}


def _tokens():
    return np.random.default_rng(3).integers(
        0, LM["vocab_size"], (4, LM["total_len"])).astype(np.int32)


@functools.lru_cache(maxsize=None)
def jax_zero_lm(mesh_name):
    sizes = MESHES[mesh_name]
    world = 2 * int(np.prod(list(sizes.values()) or [1]))
    mesh = make_mesh(MeshSpec(data=2, **sizes),
                     devices=jax.devices()[:world])
    state = _moved(tlm.init_lm_state(tlm.LMSpec(**LM)), 0)
    tree = lm_params_to_jax(state)
    tx = jax_make_optimizer(**OPT)
    layout = jz.build_layout(tree, 2, bucket_mb=BUCKET_MB)
    params = jddp.replicate_state(jddp.TrainState(
        jnp.zeros((), jnp.int32), tree, (), {}), mesh).params
    jstate = jlm.LMTrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        opt_state=jz.create_zero_opt_state(params, tx, mesh, layout))
    step = jlm.make_lm_train_step(jlm.LMSpec(**LM), tx, mesh, donate=False,
                                  zero_layout=layout,
                                  zero_grad_clip_norm=CLIP)
    toks = jax.device_put(jnp.asarray(_tokens()),
                          NamedSharding(mesh, P(_batch_axes(mesh), "seq")))
    rows = []
    for _ in range(STEPS):
        jstate, m = step(jstate, toks)
        rows.append((float(m.loss), float(m.grad_norm)))
    leaves, tdef = jax.tree_util.tree_flatten(jstate.params)
    trace = jax.tree_util.tree_unflatten(tdef, jz._unflatten_buckets(
        layout, [jstate.opt_state[0].trace[k] for k in jz.opt_keys(layout)],
        leaves))
    return state, rows, jstate.params, trace, layout


def _port(mesh_name):
    sizes = MESHES[mesh_name]
    world = 2 * int(np.prod(list(sizes.values()) or [1]))
    state = _moved(tlm.init_lm_state(tlm.LMSpec(**LM)), 0)
    tokens = _tokens()
    tw = ThreadWorld(world, timeout=60)
    msizes = mesh_sizes(world, **sizes)

    def body(r):
        mesh = thread_mesh(msizes, tw, r)
        model = tlm.CausalLM.from_state(tlm.LMSpec(**LM), state, "cpu",
                                        trainable=True)
        layout = ttp.shard_module(model, mesh)
        opt = tz.ZeroOptimizer(
            model.named_parameters(), mesh.comm("data"), bucket_mb=BUCKET_MB,
            grad_clip_norm=CLIP, model_comm=mesh.comm("model"),
            model_names={n for n in layout.specs
                         if "model" in layout.axes(n)}, **OPT)
        step = tlm.make_lm_train_step(model, opt, mesh=mesh)
        per = len(tokens) // mesh.data_size
        rows_ = torch.from_numpy(tokens[mesh.data_rank * per:][:per]).long()
        rows = []
        for _ in range(STEPS):
            m = step(rows_)
            rows.append((float(m.loss), float(m.grad_norm)))
        full = opt.state_dict()
        params = layout.gather(dict(model.named_parameters()))
        trace = layout.gather(dict(zip(opt.names, full["trace"])))
        return rows, params, trace, opt.layout

    return tw.run(body)


def _assert_tree_close(got_state, want_tree, atol=ATOL):
    got = flatten_tree(lm_params_to_jax(got_state))
    want = flatten_tree(jax.tree.map(np.asarray, want_tree))
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.abs(got[k] - want[k]).max() <= atol, k


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_zero_lm_step_equals_jax_on_the_same_mesh(mesh_name):
    _, jrows, jparams, jtrace, jlayout = jax_zero_lm(mesh_name)
    assert len(jlayout.buckets) > 1
    assert jrows[0][1] > CLIP  # the clip engages
    for rows, params, trace, layout in _port(mesh_name):
        np.testing.assert_allclose(np.array(rows), np.array(jrows),
                                   rtol=RTOL)
        _assert_tree_close(params, jparams)
        _assert_tree_close(trace, jtrace)
        if mesh_name == "data2":  # a rank's buckets are JAX's
            assert [(b.total, b.padded) for b in layout.buckets] == \
                [(b.total, b.padded) for b in jlayout.buckets]


def test_clip_summing_replicated_leaves_over_model_fails(monkeypatch):
    _, jrows, jparams, _, _ = jax_zero_lm("data2-model2")
    monkeypatch.setattr(tz, "FAULT", "clip_model")
    rows, params, _, _ = _port("data2-model2")[0]
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(np.array(rows), np.array(jrows),
                                   rtol=RTOL)
    with pytest.raises(AssertionError):
        _assert_tree_close(params, jparams)
