"""The pipelined causal LM's compositions in the port ≡ the JAX package's
``models/pipeline_lm.py`` steps on the same meshes, on the CPU: PP×TP
(``--mesh_model``) under each schedule (GQA's whole kv groups a rank
under 1F1B), PP×fsdp under GPipe and 1F1B,
PP×EP (routed stages, ``--mesh_expert``) under GPipe and 1F1B and with
fsdp, PP×SP (``--mesh_seq``) with Ulysses under each schedule and the
ring under GPipe, the EP×SP triple and TP×MoE under GPipe.

The same seeded weights (the port's init, the 1-D leaves moved off their
init values; carried into JAX by ``interop/jax_params.pipe_params_to_jax``,
routed stages included) and numpy token batches go through JAX's step on
the first world-size of the 8 CPU devices and through the port's step in
an in-process world (``runtime/dist.ThreadWorld``), each rank holding its
piece of the stages and its data replica's rows (a ``seq`` rank their
columns). The width is tiny: d 32, 4 heads, T 16, vocab 64, one block a
chunk (routed over 4 experts where the stages route), M 4. Compared at
the pipeline tests' tolerances: the loss, accuracy and grad norm at
rtol 1e-5; every leaf of the updated stacked parameters and Adam moments
at atol 2e-5 (an element whose gradient is zero in exact arithmetic —
the key bias — held to the step's size, 2·lr); each rank's stage leaves
against the JAX device shard of its index. JAX's steps at capacity
factor 2.0 route per microbatch, as the port's do, so the routed cases
are exact whatever drops.

Four controls must move the loss or a leaf's first moments far off
JAX's: a stage gradient scattered over ``fsdp`` without its sum, the
rebuilt 1F1B chunk's Megatron backward without its cross-member sum
(f's all-reduce), an expert leaf's gradient summed over ``expert``, and
stage 0's position table without the ``seq`` shard's offset. Last, a routed
pipeline's ``to_dense_lm`` through the port's ``CausalLM`` gives its
``sequential_apply``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddp_tpu.models import pipeline_lm as jplm
from ddp_tpu.runtime.mesh import MeshSpec, make_mesh
from ddp_tpu.train.optim import make_optimizer as jax_make_optimizer
from ddp_tpu_torch.interop.jax_params import (
    flatten_tree,
    pipe_params_from_jax,
    pipe_params_to_jax,
)
from ddp_tpu_torch.models import lm as tlm
from ddp_tpu_torch.models import pipeline_lm as tplm
from ddp_tpu_torch.parallel import pipeline as tpipe
from ddp_tpu_torch.parallel import tp as ttp
from ddp_tpu_torch.runtime.dist import ThreadWorld
from ddp_tpu_torch.runtime.mesh import mesh_sizes, thread_mesh
from ddp_tpu_torch.train.optim import make_optimizer

RTOL, ATOL, LR = 1e-5, 2e-5, 1e-3
T, VOCAB = 16, 64
MOE = dict(num_experts=4, moe_every=1)  # every block routed
# id: (mesh axes, schedule, config fields, global batch)
CASES = {
    "tp_gpipe": (dict(pipe=2, model=2), "gpipe", {}, 8),
    "tp_1f1b": (dict(pipe=2, model=2), "1f1b", dict(num_kv_heads=2), 8),
    "tp_interleaved": (dict(pipe=2, model=2), "interleaved",
                       dict(virtual_stages=2), 8),
    "fsdp_gpipe": (dict(pipe=2, fsdp=2), "gpipe", {}, 8),
    "fsdp_1f1b": (dict(pipe=2, fsdp=2), "1f1b", {}, 8),
    "ep_gpipe": (dict(pipe=2, expert=2), "gpipe", MOE, 8),
    "ep_1f1b": (dict(pipe=2, expert=2), "1f1b", dict(MOE, num_kv_heads=2),
                8),
    "ep_fsdp_1f1b": (dict(pipe=2, expert=2, fsdp=2), "1f1b", MOE, 16),
    "sp_ulysses_gpipe": (dict(pipe=2, seq=2), "gpipe",
                         dict(sp_strategy="ulysses"), 8),
    "sp_ulysses_1f1b": (dict(pipe=2, seq=2), "1f1b",
                        dict(sp_strategy="ulysses"), 8),
    "sp_ulysses_interleaved": (dict(pipe=2, seq=2), "interleaved",
                               dict(sp_strategy="ulysses",
                                    virtual_stages=2), 8),
    "sp_ring_gpipe": (dict(pipe=2, seq=2), "gpipe", {}, 8),
    "ep_sp_gpipe": (dict(pipe=2, expert=2, seq=2), "gpipe",
                    dict(MOE, sp_strategy="ulysses"), 8),
    "tp_moe_gpipe": (dict(pipe=2, model=2), "gpipe", MOE, 8),
}
# control: (the case it breaks, where the fault goes)
CONTROLS = {
    "fsdp_unsummed": ("fsdp_1f1b", (tpipe, "FAULT", "fsdp_unsummed")),
    "tp_rebuilt_chunk_unsummed": ("tp_1f1b", (ttp, "FAULT", "unsummed_f")),
    "expert_leaf_summed": ("ep_1f1b", (tpipe, "FAULT", "expert_summed")),
    "sp_no_pos_offset": ("sp_ulysses_1f1b", (tplm, "FAULT",
                                             "no_pos_offset")),
}


def _fields(case):
    axes, _, extra, _ = CASES[case]
    return dict(extra, tp_size=axes.get("model", 1),
                ep_size=axes.get("expert", 1), sp_size=axes.get("seq", 1))


def _cfg(case):
    return tplm.PipeLMConfig(vocab_size=VOCAB, seq_len=T, d_model=32,
                             num_heads=4, num_stages=2, num_microbatches=4,
                             **_fields(case))


def _state(cfg, interleaved, seed=0):
    """The port's init with the biases and LayerNorm scales moved off
    their init values (so that a mapping mix-up between them shows)."""
    rng = np.random.default_rng(seed + 7)
    state = tplm.init_pipe_lm(cfg, seed=seed, interleaved=interleaved)
    moved = (".bias", "ln1.weight", "ln2.weight", "ln.weight")
    return {k: (v + rng.uniform(-0.3, 0.3, v.shape)).astype(np.float32)
            if k.endswith(moved) else v for k, v in state.items()}


def _tokens(n, seed=0):
    return np.random.default_rng(seed).integers(0, VOCAB, (n, T))


def port_step(case, state, toks):
    """The port's step on every rank of a thread world → per rank: the
    metrics, the gathered parameters and moments after the update, its
    local stage leaves."""
    axes, schedule, _, _ = CASES[case]
    cfg = _cfg(case)
    inter = schedule == "interleaved"
    n = int(np.prod(list(axes.values())))
    world = ThreadWorld(n, timeout=60)
    sizes = mesh_sizes(n, **axes)

    def body(r):
        mesh = thread_mesh(sizes, world, r)
        model = tplm.build_pipe_lm(cfg, state, mesh, "cpu", interleaved=inter)
        o = make_optimizer(model.parameters(), "adam", lr=LR)
        o.norm = model.shard_layout.norm
        step = tplm.make_pipe_lm_train_step(model, o, mesh, schedule=schedule)
        b = toks.shape[0] // mesh.data_size
        m = step(torch.from_numpy(toks[mesh.data_rank * b:][:b]))
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
    """{JAX path under ``key``: the (sharded) moment array}."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(opt_state)[0]:
        keys = [getattr(k, "key", getattr(k, "name", None)) for k in path]
        if key in keys:
            out["/".join(str(k) for k in keys[keys.index(key) + 1:])] = leaf
    return out


def _jax_params(cfg_j, mesh, state, inter):
    """The port's weights as JAX's ``PipeLMParams``, placed as
    ``create_pipe_lm_state`` places them."""
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


def jax_step(case, state, toks, devices):
    axes, schedule, _, _ = CASES[case]
    inter = schedule == "interleaved"
    n = int(np.prod(list(axes.values())))
    mesh = make_mesh(MeshSpec(data=1, **axes), devices=devices[:n])
    cfg_j = jplm.PipeLMConfig(vocab_size=VOCAB, seq_len=T, d_model=32,
                              num_heads=4, num_stages=2, num_microbatches=4,
                              **_fields(case))
    tx = jax_make_optimizer("adam", lr=LR)
    params = _jax_params(cfg_j, mesh, state, inter)
    st = jplm.PipeLMState(jnp.zeros((), jnp.int32), params, tx.init(params))
    make = {"gpipe": jplm.make_pipe_lm_train_step,
            "1f1b": jplm.make_pipe_lm_1f1b_train_step,
            "interleaved": jplm.make_pipe_lm_interleaved_train_step}[schedule]
    return make(cfg_j, tx, mesh, donate=False)(st, jnp.asarray(toks,
                                                               jnp.int32))


_CACHE = {}


def _run(case, devices):
    """(the port's ranks, JAX's new state, JAX's metrics), once a case."""
    if case not in _CACHE:
        _, schedule, _, batch = CASES[case]
        state = _state(_cfg(case), schedule == "interleaved")
        toks = _tokens(batch, seed=len(case))
        jnew, jm = jax_step(case, state, toks, devices)
        _CACHE[case] = port_step(case, state, toks), jnew, jm, state, toks
    return _CACHE[case]


@pytest.fixture(scope="module", params=list(CASES))
def case(request, devices):
    return (request.param, *_run(request.param, devices))


def test_metrics_equal_jax(case):
    _, ranks, _, jm, _, _ = case
    for out in ranks:  # every rank reports the same figures
        m = out["metrics"]
        np.testing.assert_allclose(float(m.loss), float(jm.loss), rtol=RTOL)
        np.testing.assert_allclose(float(m.accuracy), float(jm.accuracy),
                                   rtol=RTOL)
        np.testing.assert_allclose(float(m.grad_norm), float(jm.grad_norm),
                                   rtol=RTOL)


def _noise(mu, gmax):
    return np.abs(mu) < 1e-6 * gmax


def test_updated_params_and_moments_equal_jax(case):
    _, ranks, jnew, _, _, _ = case
    mu = {k: np.asarray(v) for k, v in _opt_arrays(jnew.opt_state,
                                                   "mu").items()}
    gmax = max(np.abs(v).max() for v in mu.values())
    want = flatten_tree({"front": jnew.params.front,
                         "stages": jnew.params.stages,
                         "back": jnew.params.back})
    for out in ranks:
        got = flatten_tree(pipe_params_to_jax(out["params"]))
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            w = np.asarray(w)
            diff, noise = np.abs(got[k] - w), _noise(mu[k], gmax)
            assert diff[noise].max(initial=0) <= 2 * LR, k
            assert diff[~noise].max(initial=0) <= ATOL + RTOL * np.abs(
                w[~noise]).max(initial=0), k
        for key in ("mu", "nu"):
            jmom = _opt_arrays(jnew.opt_state, key)
            pm = flatten_tree(pipe_params_to_jax(out[key]))
            for k, v in jmom.items():
                np.testing.assert_allclose(pm[k], np.asarray(v), rtol=RTOL,
                                           atol=ATOL, err_msg=f"{key} {k}")


def test_rank_stage_leaves_are_jax_shards(case, devices):
    """Each rank's stage leaves (its chunks, cut over fsdp/model/expert)
    are the bytes of the JAX device shard of its index, parameters and
    first moments."""
    name, ranks, jnew, _, _, _ = case
    V = _cfg(name).virtual_stages if CASES[name][1] == "interleaved" else 1
    mu = _opt_arrays(jnew.opt_state, "mu")
    gmax = max(float(np.abs(np.asarray(v)).max()) for v in mu.values())
    paths = jax.tree_util.tree_flatten_with_path(jnew.params.stages)[0]
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

            want, noise = shard(leaf), _noise(shard(mu[k]), gmax)
            assert got[k].shape == want.shape, (r, k)
            diff = np.abs(got[k] - want)
            assert diff[~noise].max(initial=0) <= ATOL, (r, k)
            assert diff[noise].max(initial=0) <= 2 * LR, (r, k)


@pytest.mark.parametrize("control", list(CONTROLS))
def test_controls_fail_against_jax(control, devices, monkeypatch):
    """Each fault moves the loss or the first moments (0.1 × the
    gradient) of some leaf far off JAX's: by more than 100 × RTOL of the
    leaf's largest moment."""
    case, fault = CONTROLS[control]
    _, jnew, jm, state, toks = _run(case, devices)
    monkeypatch.setattr(*fault)
    out = port_step(case, state, toks)[0]
    got = flatten_tree(pipe_params_to_jax(out["mu"]))
    off = abs(float(out["metrics"].loss) - float(jm.loss)) / float(jm.loss)
    for k, v in _opt_arrays(jnew.opt_state, "mu").items():
        v = np.asarray(v)
        off = max(off, float(np.abs(got[k] - v).max() / np.abs(v).max()))
    assert off > 100 * RTOL, (control, off)


def test_expert_leaves_rest_one_ep_a_rank(devices):
    """PP×EP×fsdp: ``wi`` [S, E, d, F] rests [1, E/ep, d/fsdp, F] on each
    rank, as ``test_pp_ep_fsdp_composition`` pins JAX's; the router stays
    whole over ``expert``."""
    ranks = _run("ep_fsdp_1f1b", devices)[0]
    for out in ranks:
        assert tuple(out["local"]["chunks.0.block1.moe.wi"].shape) == \
            (2, 16, 128)
        assert tuple(out["local"]["chunks.0.block1.moe.router.weight"]
                     .shape) == (4, 32)


def test_to_dense_lm_of_a_routed_pipeline_equals_causal_lm():
    cfg = _cfg("ep_gpipe")._replace(ep_size=1, num_kv_heads=2)
    state = _state(cfg, False)
    toks = _tokens(4, seed=5)
    t = torch.from_numpy(toks)
    seq = tplm.sequential_apply(cfg, state, t)
    spec, dense = tplm.to_dense_lm(cfg, state)
    assert (spec.num_experts, spec.moe_every, spec.depth) == (4, 1, 2)
    assert "block1.moe.wi" in dense and "block2.moe.wi" in dense
    with torch.no_grad():
        got = tlm.CausalLM.from_state(spec, dense, "cpu")(t)
    np.testing.assert_allclose(got.numpy(), seq.numpy(), atol=2e-5)


def test_routed_stage_params_round_trip_and_malformed_moe_raises():
    """A routed pipeline's state to JAX's tree (JAX's leaf shapes: the
    router a Dense kernel [d, E]) and back, bit for bit; a ``moe``
    subtree without its router, or without ``bi``, raises naming ``moe``
    (the steps above feed JAX this tree)."""
    cfg = _cfg("ep_gpipe")._replace(ep_size=1)
    state = tplm.init_pipe_lm(cfg, seed=3, interleaved=True)
    tree = pipe_params_to_jax(state)
    flat = flatten_tree(tree)
    assert flat["stages/block1/moe/router/kernel"].shape == (1, 2, 32, 4)
    assert flat["stages/block1/moe/wi"].shape == (1, 2, 4, 32, 128)
    back = pipe_params_from_jax(tree)
    assert sorted(back) == sorted(state)
    for k, v in state.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    del flat["stages/block1/moe/router/kernel"]
    with pytest.raises(ValueError, match="malformed moe subtree"):
        pipe_params_from_jax(flat)
    with pytest.raises(ValueError, match="malformed moe subtree"):
        pipe_params_to_jax({k: v for k, v in state.items()
                            if not k.endswith("moe.bi")})
