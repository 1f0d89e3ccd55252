"""The pipelined causal LM (``--model pipe_lm``) in the port ≡ the JAX
package's ``models/pipeline_lm.py`` steps on the same mesh, on the CPU.

The same seeded weights (the port's init, the 1-D leaves moved off their
init values; carried into JAX by ``interop/jax_params.pipe_params_to_jax``)
and numpy token batches go through JAX's GPipe, 1F1B and interleaved
steps on the first S × data of the 8 CPU devices (pipe 2 × data 2, pipe
2, pipe 4 with v 2) and through the port's step in an in-process world
(``runtime/dist.ThreadWorld``), each rank holding its chunks and its
data replica's rows. Compared at rtol 1e-5 / atol 2e-5: the loss,
accuracy and grad norm; every leaf of the updated stacked parameters and
Adam moments; each rank's chunks against the JAX device shard of its
index. Adam's first update of an element whose gradient is zero in exact
arithmetic (the key bias: softmax ignores it) normalises rounding noise
on both sides, so those elements are held to the step's size (2·lr), as
in tests/test_torch_spmd.py.

Also, without JAX: each schedule's gradients equal the port's own dense
``CausalLM`` step on ``to_dense_lm`` of the same weights (atol 2e-6),
and three controls fail that check — a 1F1B backward dropped at one
stage, the tied embedding without the head's part, interleaved chunks
placed stage-major; ``to_dense_lm`` through ``CausalLM`` gives
``sequential_apply``'s logits, which are JAX's; the eval step gives
JAX's ``make_pipe_lm_eval_step`` sums.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddp_tpu.models import pipeline_lm as jplm
from ddp_tpu.runtime.mesh import MeshSpec, make_mesh
from ddp_tpu.train.optim import make_optimizer as jax_make_optimizer
from ddp_tpu_torch.interop.jax_params import flatten_tree, pipe_params_to_jax
from ddp_tpu_torch.models import lm as tlm
from ddp_tpu_torch.models import pipeline_lm as tplm
from ddp_tpu_torch.parallel import interleaved as tinter
from ddp_tpu_torch.parallel import one_f1b as tf1b
from ddp_tpu_torch.runtime.dist import ThreadWorld
from ddp_tpu_torch.runtime.mesh import mesh_sizes, thread_mesh
from ddp_tpu_torch.train.optim import make_optimizer

RTOL, ATOL, LR = 1e-5, 2e-5, 1e-3
SEQ_ATOL = 2e-6  # the pipeline's gradients against the dense step's
BATCH, T, VOCAB = 8, 16, 64
# schedule: (pipe, data, virtual stages)
CASES = {"gpipe": (2, 2, 1), "1f1b": (2, 1, 1), "interleaved": (4, 1, 2)}


def _cfg(schedule, **kw):
    S, _, V = CASES[schedule]
    return tplm.PipeLMConfig(vocab_size=VOCAB, seq_len=T, d_model=32,
                             num_heads=2, num_stages=S, depth_per_stage=1,
                             num_microbatches=4, virtual_stages=V, **kw)


def _state(cfg, interleaved, seed=0):
    """The port's init with the biases and LayerNorm scales moved off
    their init values (so that a mapping mix-up between them shows)."""
    rng = np.random.default_rng(seed + 7)
    state = tplm.init_pipe_lm(cfg, seed=seed, interleaved=interleaved)
    moved = (".bias", "ln1.weight", "ln2.weight", "ln.weight")
    return {k: (v + rng.uniform(-0.3, 0.3, v.shape)).astype(np.float32)
            if k.endswith(moved) else v for k, v in state.items()}


def _tokens(seed=0):
    return np.random.default_rng(seed).integers(0, VOCAB, (BATCH, T))


def port_step(schedule, state, toks, *, cfg=None, opt="adam"):
    """The port's step on every rank of a thread world → per rank: the
    metrics, the gathered gradients, parameters and moments after the
    update, its local chunks."""
    cfg = cfg or _cfg(schedule)
    S, data, _ = CASES[schedule]
    inter = schedule == "interleaved"
    world = ThreadWorld(S * data, timeout=60)
    sizes = mesh_sizes(S * data, pipe=S)

    def body(r):
        mesh = thread_mesh(sizes, world, r)
        model = tplm.build_pipe_lm(cfg, state, mesh, "cpu", interleaved=inter)
        o = make_optimizer(model.parameters(), opt, lr=LR)
        o.norm = model.shard_layout.norm
        step = tplm.make_pipe_lm_train_step(model, o, mesh, schedule=schedule)
        b = BATCH // mesh.data_size
        m = step(torch.from_numpy(toks[mesh.data_rank * b:][:b]))
        lay = model.shard_layout
        named = dict(model.named_parameters())
        out = dict(metrics=m, grads=lay.gather({n: p.grad.clone()
                                                for n, p in named.items()}),
                   params=lay.gather({n: p.detach().clone()
                                      for n, p in named.items()}),
                   local={n: p.detach().clone() for n, p in named.items()})
        if opt == "adam":
            out["mu"] = lay.gather(dict(zip(lay.names, o.mu)))
            out["nu"] = lay.gather(dict(zip(lay.names, o.nu)))
        return out

    return world.run(body)


def _opt_leaves(opt_state, key):
    flat = jax.tree_util.tree_flatten_with_path(opt_state)[0]
    out = {}
    for path, leaf in flat:
        keys = [getattr(k, "key", getattr(k, "name", None)) for k in path]
        if key in keys:
            out["/".join(str(k) for k in keys[keys.index(key) + 1:])] = \
                np.asarray(leaf)
    return out


def _jax_params(cfg_j, mesh, state, inter):
    """The port's weights as JAX's ``PipeLMParams``, placed as
    ``create_pipe_lm_state`` places them (stages over ``pipe``, the ends
    replicated)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    tree = pipe_params_to_jax(state)
    specs = jplm._param_specs(cfg_j, tree["stages"], mesh,
                              lead=2 if inter else 1)
    rep = NamedSharding(mesh, P())
    return jplm.PipeLMParams(
        front=jax.tree.map(lambda a: jax.device_put(a, rep), tree["front"]),
        stages=jax.tree.map(lambda a, s: jax.device_put(
            a, NamedSharding(mesh, s)), tree["stages"], specs),
        back=jax.tree.map(lambda a: jax.device_put(a, rep), tree["back"]))


@pytest.fixture(scope="module", params=list(CASES))
def case(request, devices):
    """(schedule, the port's ranks, JAX's metrics, params, state, mesh)."""
    schedule = request.param
    S, data, V = CASES[schedule]
    inter = schedule == "interleaved"
    cfg = _cfg(schedule)
    state, toks = _state(cfg, inter), _tokens()
    mesh = make_mesh(MeshSpec(pipe=S, data=data), devices=devices[:S * data])
    cfg_j = jplm.PipeLMConfig(vocab_size=VOCAB, seq_len=T, d_model=32,
                              num_heads=2, num_stages=S, depth_per_stage=1,
                              num_microbatches=4, virtual_stages=V)
    tx = jax_make_optimizer("adam", lr=LR)
    params = _jax_params(cfg_j, mesh, state, inter)
    jstate = jplm.PipeLMState(jnp.zeros((), jnp.int32), params,
                              tx.init(params))
    make = {"gpipe": jplm.make_pipe_lm_train_step,
            "1f1b": jplm.make_pipe_lm_1f1b_train_step,
            "interleaved": jplm.make_pipe_lm_interleaved_train_step}[schedule]
    jnew, jm = make(cfg_j, tx, mesh, donate=False)(jstate,
                                                   jnp.asarray(toks,
                                                               jnp.int32))
    return schedule, port_step(schedule, state, toks), jm, jnew, state, toks


def test_metrics_equal_jax(case):
    _, ranks, jm, _, _, _ = case
    for out in ranks:  # every rank reports the same figures
        m = out["metrics"]
        np.testing.assert_allclose(float(m.loss), float(jm.loss), rtol=RTOL)
        np.testing.assert_allclose(float(m.accuracy), float(jm.accuracy),
                                   rtol=RTOL)
        np.testing.assert_allclose(float(m.grad_norm), float(jm.grad_norm),
                                   rtol=RTOL)


def test_updated_params_and_moments_equal_jax(case):
    _, ranks, _, jnew, _, _ = case
    mu = _opt_leaves(jnew.opt_state, "mu")
    gmax = max(np.abs(v).max() for v in mu.values())
    want = flatten_tree({"front": jnew.params.front,
                         "stages": jnew.params.stages,
                         "back": jnew.params.back})
    for out in ranks:
        got = flatten_tree(pipe_params_to_jax(out["params"]))
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            diff = np.abs(got[k] - np.asarray(w))
            noise = np.abs(mu[k]) < 1e-6 * gmax
            assert diff[noise].max(initial=0) <= 2 * LR, k
            assert diff[~noise].max(initial=0) <= ATOL + RTOL * np.abs(
                np.asarray(w)[~noise]).max(initial=0), k
        for key in ("mu", "nu"):
            jm = _opt_leaves(jnew.opt_state, key)
            pm = flatten_tree(pipe_params_to_jax(out[key]))
            for k in jm:
                np.testing.assert_allclose(pm[k], jm[k], rtol=RTOL,
                                           atol=ATOL, err_msg=f"{key} {k}")


def test_rank_chunks_are_jax_shards(case, devices):
    schedule, ranks, _, jnew, _, _ = case
    S, data, V = CASES[schedule]
    mu = _opt_leaves(jnew.opt_state, "mu")
    gmax = max(np.abs(v).max() for v in mu.values())
    paths = jax.tree_util.tree_flatten_with_path(jnew.params.stages)[0]
    for r, out in enumerate(ranks):
        d = r // data  # the rank's pipe coordinate
        # Its chunks in the shard's layout: [1, …], or [v, 1, …].
        mine = {}
        for name in out["local"]:
            if name.startswith("chunks.0."):
                leaf = name[len("chunks.0."):]
                t = torch.stack([out["local"][f"chunks.{k}.{leaf}"]
                                 for k in range(V)])
                mine["stages." + leaf] = t[:, None] if V > 1 else t
        got = flatten_tree(pipe_params_to_jax(mine))
        for path, leaf in paths:
            k = "/".join(str(getattr(p, "key", p)) for p in path)
            want = np.asarray(next(s.data for s in leaf.addressable_shards
                                   if s.device == devices[r]))
            full_mu = np.abs(mu["stages/" + k])
            noise = (full_mu[:, d:d + 1] if V > 1 else full_mu[d:d + 1]) \
                < 1e-6 * gmax
            diff = np.abs(got["stages/" + k] - want)
            assert diff[~noise].max(initial=0) <= ATOL, (r, k)
            assert diff[noise].max(initial=0) <= 2 * LR, (r, k)


def _dense_grads(cfg, state, toks):
    spec, dense = tplm.to_dense_lm(cfg, state)
    model = tlm.CausalLM.from_state(spec, dense, "cpu", trainable=True)
    opt = make_optimizer(model.parameters(), "sgd", lr=0.0)
    m = tlm.make_lm_train_step(model, opt)(torch.from_numpy(toks))
    return m, {n: p.grad for n, p in model.named_parameters()}


def _seq_error(cfg, ranks, want):
    _, got = tplm.to_dense_lm(cfg, ranks[0]["grads"])
    return max(float((got[k] - want[k]).abs().max()) for k in want)


def test_step_equals_dense_sequential_step(case):
    schedule, ranks, _, _, state, toks = case
    cfg = _cfg(schedule)
    m, want = _dense_grads(cfg, state, toks)
    assert _seq_error(cfg, ranks, want) <= SEQ_ATOL
    np.testing.assert_allclose(float(ranks[0]["metrics"].loss),
                               float(m.loss), rtol=RTOL)


@pytest.mark.parametrize("schedule,control", [
    ("1f1b", "dropped_backward"), ("1f1b", "untied_head"),
    ("interleaved", "stage_major")])
def test_controls_fail_the_sequential_check(schedule, control, monkeypatch):
    cfg = _cfg(schedule)
    inter = schedule == "interleaved"
    state, toks = _state(cfg, inter), _tokens()
    _, want = _dense_grads(cfg, state, toks)
    if control == "dropped_backward":
        monkeypatch.setattr(tf1b, "FAULT", (0, 1))
    elif control == "untied_head":
        monkeypatch.setattr(tplm, "FAULT", "untied_head")
    else:
        monkeypatch.setattr(tinter, "FAULT", "stage_major")
    ranks = port_step(schedule, state, toks, opt="sgd")
    assert _seq_error(cfg, ranks, want) > 100 * SEQ_ATOL


@pytest.mark.parametrize("interleaved", [False, True])
def test_to_dense_lm_and_sequential_apply_equal_jax(interleaved):
    cfg = _cfg("interleaved" if interleaved else "1f1b", num_kv_heads=1)
    state, toks = _state(cfg, interleaved), _tokens()
    t = torch.from_numpy(toks)
    seq = tplm.sequential_apply(cfg, state, t)
    spec, dense = tplm.to_dense_lm(cfg, state)
    assert spec.depth == cfg.num_stages * cfg.virtual_stages ** interleaved
    with torch.no_grad():
        got = tlm.CausalLM.from_state(spec, dense, "cpu")(t)
    np.testing.assert_allclose(got.numpy(), seq.numpy(), atol=2e-5)
    tree = pipe_params_to_jax(state)
    cfg_j = jplm.PipeLMConfig(vocab_size=VOCAB, seq_len=T, d_model=32,
                              num_heads=2, num_stages=cfg.num_stages,
                              virtual_stages=cfg.virtual_stages,
                              num_kv_heads=1)
    want = jplm.sequential_apply(cfg_j, jplm.PipeLMParams(**tree),
                                 jnp.asarray(toks, jnp.int32))
    np.testing.assert_allclose(seq.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_eval_step_equals_jax(devices):
    cfg = _cfg("1f1b")
    state, toks = _state(cfg, False), _tokens(3)
    weights = np.ones(BATCH, np.float32)
    weights[-3:] = 0.0
    mesh = make_mesh(MeshSpec(pipe=2), devices=devices[:2])
    cfg_j = jplm.PipeLMConfig(vocab_size=VOCAB, seq_len=T, d_model=32,
                              num_heads=2, num_stages=2)
    params = _jax_params(cfg_j, mesh, state, False)
    want = jplm.make_pipe_lm_eval_step(cfg_j, mesh)(
        params, {}, jnp.asarray(toks, jnp.int32), None, jnp.asarray(weights))
    world = ThreadWorld(2, timeout=60)

    def body(r):
        tmesh = thread_mesh(mesh_sizes(2, pipe=2), world, r)
        model = tplm.build_pipe_lm(cfg, state, tmesh, "cpu")
        return tplm.make_pipe_lm_eval_step(model, tmesh)(
            torch.from_numpy(toks), torch.from_numpy(weights))

    for acc, loss in world.run(body):
        np.testing.assert_allclose(float(acc), float(want[0]), rtol=RTOL)
        np.testing.assert_allclose(float(loss), float(want[1]), rtol=RTOL)
