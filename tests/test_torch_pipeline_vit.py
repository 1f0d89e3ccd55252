"""The pipelined ViT (``--model pipe_vit``) in the port ≡ the JAX
package's ``models/pipeline_vit.py`` steps on the same mesh, on the CPU.

The same seeded weights (the port's init, biases and LayerNorm scales
moved off their init values; carried into JAX by
``interop/jax_params.pipe_params_to_jax``) and numpy uint8 28×28 images
(patch 7: 16 tokens, no class token) go through JAX's GPipe (pipe 2),
1F1B (pipe 2 × data 2, label smoothing 0.1) and interleaved (pipe 2 ×
data 2, v 2) steps on the first S × data of the 8 CPU devices and
through the port's step in an in-process world
(``runtime/dist.ThreadWorld``). Compared at rtol 1e-5 / atol 2e-5: the
loss and accuracy (the step reports no grad norm, as JAX's); every leaf
of the updated stacked parameters and Adam moments; each rank's chunks
against the JAX device shard of its index. Adam's first update of an
element whose gradient is zero in exact arithmetic (the key bias)
normalises rounding noise on both sides and is held to the step's size
(2·lr), as in tests/test_torch_spmd.py.

Without JAX: each schedule's gradients equal the port's own sequential
step on the same weights (atol 2e-6), and under ``--augment crop_flip``
stage 0 draws its rows of the global batch as world 1 draws them, so
the step equals world 1's sequential step on the augmented batch; the
pipelined forward, the evaluation's, gives JAX's ``sequential_apply``
logits in both layouts and the eval step JAX's sums; JAX's own init
(``init_pipe_vit``) carried into the port by
``pipe_params_from_jax`` gives JAX's logits, and back, its tree bit for
bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddp_tpu.models import pipeline_vit as jpv
from ddp_tpu.runtime.mesh import MeshSpec, make_mesh
from ddp_tpu.train.optim import make_optimizer as jax_make_optimizer
from ddp_tpu_torch.data.augment import get_augmentation, step_key
from ddp_tpu_torch.interop.jax_params import (
    flatten_tree,
    pipe_params_from_jax,
    pipe_params_to_jax,
)
from ddp_tpu_torch.models import pipeline_vit as tpv
from ddp_tpu_torch.parallel.common import _preprocess, xent
from ddp_tpu_torch.runtime.dist import ThreadWorld
from ddp_tpu_torch.runtime.mesh import mesh_sizes, thread_mesh
from ddp_tpu_torch.train.optim import make_optimizer

RTOL, ATOL, LR = 1e-5, 2e-5, 1e-3
SEQ_ATOL = 2e-6
BATCH, SIDE = 8, 28
# schedule: (pipe, data, virtual stages, label smoothing)
CASES = {"gpipe": (2, 1, 1, 0.0), "1f1b": (2, 2, 1, 0.1),
         "interleaved": (2, 2, 2, 0.0)}


def _cfg(schedule):
    S, _, V, _ = CASES[schedule]
    return tpv.PipeViTConfig(num_classes=10, patch_size=7, embed_dim=32,
                             num_heads=2, num_stages=S, depth_per_stage=1,
                             num_microbatches=4, virtual_stages=V, side=SIDE,
                             in_channels=1)


def _jax_cfg(schedule):
    S, _, V, _ = CASES[schedule]
    return jpv.PipeViTConfig(num_classes=10, patch_size=7, embed_dim=32,
                             num_heads=2, num_stages=S, depth_per_stage=1,
                             num_microbatches=4, virtual_stages=V)


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


def port_step(schedule, state, x, y, *, augment=None):
    S, data, _, ls = CASES[schedule]
    cfg = _cfg(schedule)
    inter = schedule == "interleaved"
    world = ThreadWorld(S * data, timeout=60)
    sizes = mesh_sizes(S * data, pipe=S)

    def body(r):
        mesh = thread_mesh(sizes, world, r)
        model = tpv.build_pipe_vit(cfg, state, mesh, "cpu", interleaved=inter)
        o = make_optimizer(model.parameters(), "adam", lr=LR)
        o.norm = model.shard_layout.norm
        step = tpv.make_pipe_vit_train_step(
            model, o, mesh, schedule=schedule, label_smoothing=ls,
            augment_fn=get_augmentation(augment))
        b = BATCH // mesh.data_size
        rows = slice(mesh.data_rank * b, (mesh.data_rank + 1) * b)
        m = step(torch.from_numpy(x[rows]), torch.from_numpy(y[rows]))
        lay = model.shard_layout
        named = dict(model.named_parameters())
        return dict(metrics=m,
                    grads=lay.gather({n: p.grad.clone()
                                      for n, p in named.items()}),
                    params=lay.gather({n: p.detach().clone()
                                       for n, p in named.items()}),
                    local={n: p.detach().clone() for n, p in named.items()},
                    mu=lay.gather(dict(zip(lay.names, o.mu))),
                    nu=lay.gather(dict(zip(lay.names, o.nu))))

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
    from jax.sharding import NamedSharding, PartitionSpec as P

    tree = pipe_params_to_jax(state)
    specs = jpv._vit_stage_specs(cfg_j, tree["stages"], mesh,
                                 lead=2 if inter else 1)
    rep = NamedSharding(mesh, P())
    return jpv.PipeViTParams(
        embed=jax.tree.map(lambda a: jax.device_put(a, rep), tree["embed"]),
        stages=jax.tree.map(lambda a, s: jax.device_put(
            a, NamedSharding(mesh, s)), tree["stages"], specs),
        head=jax.tree.map(lambda a: jax.device_put(a, rep), tree["head"]))


@pytest.fixture(scope="module", params=list(CASES))
def case(request, devices):
    schedule = request.param
    S, data, V, ls = CASES[schedule]
    inter = schedule == "interleaved"
    state, (x, y) = _state(_cfg(schedule), inter), _batch()
    mesh = make_mesh(MeshSpec(pipe=S, data=data), devices=devices[:S * data])
    cfg_j = _jax_cfg(schedule)
    tx = jax_make_optimizer("adam", lr=LR)
    params = _jax_params(cfg_j, mesh, state, inter)
    jstate = jpv.PipeViTState(jnp.zeros((), jnp.int32), params,
                              tx.init(params))
    make = {"gpipe": jpv.make_pipe_vit_train_step,
            "1f1b": jpv.make_pipe_vit_1f1b_train_step,
            "interleaved": jpv.make_pipe_vit_interleaved_train_step}[schedule]
    jnew, jm = make(cfg_j, tx, mesh, donate=False, label_smoothing=ls)(
        jstate, jnp.asarray(x), jnp.asarray(y))
    return schedule, port_step(schedule, state, x, y), jm, jnew, state, (x, y)


def test_metrics_equal_jax(case):
    _, ranks, jm, _, _, _ = case
    for out in ranks:
        m = out["metrics"]
        np.testing.assert_allclose(float(m.loss), float(jm.loss), rtol=RTOL)
        np.testing.assert_allclose(float(m.accuracy), float(jm.accuracy),
                                   rtol=RTOL)
        assert m.grad_norm is None and jm.grad_norm is None


def test_updated_params_and_moments_equal_jax(case):
    _, ranks, _, jnew, _, _ = case
    mu = _opt_leaves(jnew.opt_state, "mu")
    gmax = max(np.abs(v).max() for v in mu.values())
    want = flatten_tree({"embed": jnew.params.embed,
                         "stages": jnew.params.stages,
                         "head": jnew.params.head})
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
            jmom = _opt_leaves(jnew.opt_state, key)
            pm = flatten_tree(pipe_params_to_jax(out[key]))
            for k in jmom:
                np.testing.assert_allclose(pm[k], jmom[k], rtol=RTOL,
                                           atol=ATOL, err_msg=f"{key} {k}")


def test_rank_chunks_are_jax_shards(case, devices):
    schedule, ranks, _, jnew, _, _ = case
    S, data, V, _ = CASES[schedule]
    mu = _opt_leaves(jnew.opt_state, "mu")
    gmax = max(np.abs(v).max() for v in mu.values())
    paths = jax.tree_util.tree_flatten_with_path(jnew.params.stages)[0]
    for r, out in enumerate(ranks):
        d = r // data
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


def _sequential_grads(cfg, state, images, labels, ls=0.0):
    """World 1's step without the pipeline: embed → every chunk in chunk
    order → head, the mean cross-entropy's gradients, in the full
    state's names."""
    embed, head = tpv.PatchEmbed(cfg), tpv.PipeHead(cfg)
    embed.load_state_dict({k[6:]: torch.from_numpy(v) for k, v in
                           state.items() if k.startswith("embed.")})
    head.load_state_dict({k[5:]: torch.from_numpy(v) for k, v in
                          state.items() if k.startswith("head.")})
    chunks = []
    for c in tpv.chunk_states(state):
        blocks = tpv.StageBlocks(cfg.depth_per_stage, cfg.embed_dim,
                                 cfg.num_heads, cfg.embed_dim * cfg.mlp_ratio)
        blocks.load_state_dict({k: torch.from_numpy(np.array(v))
                                for k, v in c.items()})
        chunks.append(blocks)
    h = embed(images)
    for blocks in chunks:
        h = blocks(h, torch.float32)
    loss = xent(head(h), torch.from_numpy(labels), ls).mean()
    loss.backward()
    grads = {f"embed.{n}": p.grad for n, p in embed.named_parameters()}
    grads.update({f"head.{n}": p.grad for n, p in head.named_parameters()})
    for n, _ in chunks[0].named_parameters():
        stacked = torch.stack([dict(b.named_parameters())[n].grad
                               for b in chunks])
        full = state["stages." + n]
        grads["stages." + n] = stacked.reshape(full.shape)
    return float(loss.detach()), grads


def _max_err(got, want):
    return max(float((got[k] - want[k]).abs().max()) for k in want)


def test_step_equals_sequential_step(case):
    schedule, ranks, _, _, state, (x, y) = case
    loss, want = _sequential_grads(_cfg(schedule), state,
                                   _preprocess(torch.from_numpy(x),
                                               torch.float32), y,
                                   CASES[schedule][3])
    assert _max_err(ranks[0]["grads"], want) <= SEQ_ATOL
    np.testing.assert_allclose(float(ranks[0]["metrics"].loss), loss,
                               rtol=RTOL)


def test_augmented_step_draws_world1_rows():
    schedule = "1f1b"  # pipe 2 × data 2: each data rank its own rows
    cfg = _cfg(schedule)
    state, (x, y) = _state(cfg, False, seed=3), _batch(3)
    ranks = port_step(schedule, state, x, y, augment="crop_flip")
    images = get_augmentation("crop_flip")(
        step_key(0, 0, 0), _preprocess(torch.from_numpy(x), torch.float32))
    _, want = _sequential_grads(cfg, state, images, y, CASES[schedule][3])
    assert _max_err(ranks[0]["grads"], want) <= SEQ_ATOL
    # The control: each rank drawing as if its rows began the batch.
    wrong = torch.cat([get_augmentation("crop_flip")(
        step_key(0, 0, 0), _preprocess(torch.from_numpy(x[i:i + 4]),
                                       torch.float32)) for i in (0, 4)])
    _, other = _sequential_grads(cfg, state, wrong, y, CASES[schedule][3])
    assert _max_err(ranks[0]["grads"], other) > 100 * SEQ_ATOL


@pytest.mark.parametrize("interleaved", [False, True])
def test_pipelined_eval_equals_jax(interleaved):
    schedule = "interleaved" if interleaved else "gpipe"
    S, data, V, _ = CASES[schedule]
    cfg = _cfg(schedule)
    state, (x, y) = _state(cfg, interleaved, seed=5), _batch(5)
    weights = np.ones(BATCH, np.float32)
    weights[-2:] = 0.0
    tree = pipe_params_to_jax(state)
    apply = (jpv.sequential_apply_interleaved if interleaved
             else jpv.sequential_apply)
    logits = np.asarray(apply(_jax_cfg(schedule), jpv.PipeViTParams(**tree),
                              jnp.asarray(x, jnp.float32) / 255.0))
    np.testing.assert_allclose(
        tpv.sequential_apply(cfg, state, _preprocess(torch.from_numpy(x),
                                                     torch.float32)).numpy(),
        logits, rtol=RTOL, atol=ATOL)
    lse = np.log(np.exp(logits - logits.max(-1, keepdims=True)).sum(-1)) \
        + logits.max(-1)
    want = (((logits.argmax(-1) == y) * weights).sum(),
            ((lse - logits[np.arange(BATCH), y]) * weights).sum())
    world = ThreadWorld(S * data, timeout=60)

    def body(r):
        mesh = thread_mesh(mesh_sizes(S * data, pipe=S), world, r)
        model = tpv.build_pipe_vit(cfg, state, mesh, "cpu",
                                   interleaved=interleaved)
        b = BATCH // data
        rows = slice(mesh.data_rank * b, (mesh.data_rank + 1) * b)
        return tpv.make_pipe_vit_eval_step(model, mesh)(
            torch.from_numpy(x[rows]), torch.from_numpy(y[rows]),
            torch.from_numpy(weights[rows]))

    for correct, loss in world.run(body):
        np.testing.assert_allclose(float(correct), want[0], rtol=RTOL)
        np.testing.assert_allclose(float(loss), want[1], rtol=RTOL)


def test_jax_init_carried_into_the_port():
    cfg, cfg_j = _cfg("gpipe"), _jax_cfg("gpipe")
    x, _ = _batch(7)
    images = jnp.asarray(x, jnp.float32) / 255.0
    tree = jax.jit(lambda im: jpv.init_pipe_vit(cfg_j, im, seed=4))(
        images[:1])
    state = pipe_params_from_jax(tree._asdict())
    assert state["stages.block1.attn.qkv.weight"].shape == (2, 96, 32)
    back = flatten_tree(pipe_params_to_jax(state))
    for k, v in flatten_tree(tree._asdict()).items():
        np.testing.assert_array_equal(back[k], np.asarray(v), err_msg=k)
    want = jax.jit(lambda p, im: jpv.sequential_apply(cfg_j, p, im))(
        tree, images)
    got = tpv.sequential_apply(cfg, state, _preprocess(torch.from_numpy(x),
                                                       torch.float32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
