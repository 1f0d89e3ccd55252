"""ddp_tpu_torch.models.moe ≡ the JAX package's ``models/moe.py``, on the CPU.

Seeded numpy weights and tokens go through JAX's ``MoEMLP.apply`` (the
``losses`` collection mutable, for the aux loss) and the port's
``MoEMLP`` at capacity factors 2.0 and 0.5 (which drops), top_k 1 and 2,
normalised and raw gates, fp32. Compared: the experts each token chose
(from JAX's own softmax), which (token, expert) assignments were kept
(read from JAX's output through a probe whose experts each emit a unit
vector), the output, the aux loss, and the gradients of the router, the
experts and the input. The port's two forms (the index form every model
runs, the one-hot plain version) hold each other: the experts' input
buffer bit for bit in fp32. Then the MoE ViT: ``vit_moe_micro``'s logits,
aux and whole gradient, one SGD-momentum step against JAX's
``make_train_step`` (aux in the loss, ×0.01), ``vit_moe_tiny``'s
parameter shapes, and ``python -m ddp_tpu_torch.train --model
vit_moe_micro``.

Tolerances (fp32, the frameworks sum in other orders): each tensor
within 1e-5 of its own scale (max|want|, at least 1); the aux loss
rtol 1e-6. Routing is compared first and exactly. A token whose top-2
JAX gates lie within 1e-6 of each other is a near tie and may route
otherwise; the tests count them and expect none at these seeds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from ddp_tpu.models import get_model as jax_get_model
from ddp_tpu.models import moe as jmoe
from ddp_tpu.parallel import ddp as jddp
from ddp_tpu.runtime.mesh import MeshSpec, make_mesh
from ddp_tpu.train.optim import make_optimizer as jax_make_optimizer
from ddp_tpu_torch.interop.jax_params import (
    flatten_tree,
    vit_params_from_jax,
    vit_params_to_jax,
)
from ddp_tpu_torch.models import get_model
from ddp_tpu_torch.models import moe as tmoe
from ddp_tpu_torch.parallel.ddp import TrainState, make_train_step
from ddp_tpu_torch.train import checkpoint as ck
from ddp_tpu_torch.train.optim import make_optimizer
from ddp_tpu_torch.train.trainer import main as train_main

TOL = 1e-5
AUX_RTOL = 1e-6
NEAR_TIE = 1e-6
B, T, D, E, FF = 2, 24, 32, 4, 128  # n = 48 tokens, F = 4d


def _scale_err(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max()) / max(1.0, float(np.abs(want).max()))


def _layer(seed=0):
    """A JAX-layout MoEMLP tree (biases random too) and tokens."""
    rng = np.random.default_rng(seed)

    def nrm(shape, std):
        return (rng.standard_normal(shape) * std).astype(np.float32)

    params = {"router": {"kernel": nrm((D, E), 1.0), "bias": nrm((E,), 0.3)},
              "wi": nrm((E, D, FF), D ** -0.5), "bi": nrm((E, 1, FF), 0.1),
              "wo": nrm((E, FF, D), FF ** -0.5), "bo": nrm((E, 1, D), 0.1)}
    return params, nrm((B, T, D), 1.0)


def _port_layer(params, **cfg):
    m = tmoe.MoEMLP(D, FF, E, **cfg)
    m.load_state_dict({
        "router.weight": torch.tensor(params["router"]["kernel"].T),
        "router.bias": torch.tensor(params["router"]["bias"]),
        **{k: torch.tensor(params[k]) for k in ("wi", "bi", "wo", "bo")}})
    return m


def _jax_routing(params, x, top_k):
    """JAX's gates and its iterative choices [K, n], and the near ties."""
    toks = jnp.asarray(x.reshape(-1, D))
    gates = np.asarray(jax.nn.softmax(
        toks @ params["router"]["kernel"] + params["router"]["bias"], -1))
    remaining, idxs = gates.copy(), []
    for _ in range(top_k):
        idx = np.asarray(jnp.argmax(jnp.asarray(remaining), -1))
        idxs.append(idx)
        remaining[np.arange(len(idx)), idx] = 0.0
    top = np.sort(gates, -1)[:, ::-1]
    near = int((top[:, 0] - top[:, 1] < NEAR_TIE).sum()
               + (top_k > 1) * (top[:, 1] - top[:, 2] < NEAR_TIE).sum())
    return np.stack(idxs), near


def _jax_kept(params, x, cfg):
    """The (token, expert) pairs JAX kept: its experts replaced by
    constant unit vectors (wo 0, bo row e = e_e), its output at [n, e]
    is that pair's combine weight — positive iff the pair was kept."""
    probe = dict(params, wo=np.zeros_like(params["wo"]),
                 bo=np.eye(E, D, dtype=np.float32)[:, None, :])
    out = jmoe.MoEMLP(num_experts=E, mlp_dim=FF, **cfg).apply(
        {"params": probe}, jnp.asarray(x))
    return np.asarray(out).reshape(-1, D)[:, :E] > 0


CASES = [dict(capacity_factor=cf, top_k=k, normalize_gates=g)
         for cf in (2.0, 0.5) for k in (1, 2) for g in (True, False)]


@pytest.mark.parametrize("cfg", CASES, ids=lambda c: "cf{capacity_factor}-"
                         "top{top_k}-{normalize_gates}".format(**c))
def test_moe_mlp_equals_jax(cfg):
    params, x = _layer()
    jm = jmoe.MoEMLP(num_experts=E, mlp_dim=FF, **cfg)
    proj = np.random.default_rng(3).standard_normal((B, T, D)).astype(
        np.float32)

    def loss(p, xx):
        out, v = jm.apply({"params": p}, xx, mutable=["losses"])
        aux = v["losses"]["moe_aux"]
        return jnp.sum(out * proj) + 0.37 * aux, (out, aux)

    (_, (want, want_aux)), (gp, gx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    choices, near = _jax_routing(params, x, cfg["top_k"])
    assert near == 0, f"{near} near ties at this seed"

    tm = _port_layer(params, **cfg)
    xt = torch.tensor(x).requires_grad_()
    got, aux, r = tm.routed(xt)
    # Routing first, exactly: the choices, then the kept pairs.
    np.testing.assert_array_equal(r.expert.numpy(), choices)
    kept = np.zeros((B * T, E), bool)
    for k in range(cfg["top_k"]):
        kept[np.arange(B * T)[r.kept[k].numpy()],
             r.expert[k][r.kept[k]].numpy()] = True
    np.testing.assert_array_equal(kept, _jax_kept(params, x, cfg))
    if cfg["capacity_factor"] == 0.5:
        assert not r.kept.all()  # the drops this case is for
    assert r.capacity == tmoe.expert_capacity(B * T, E, cfg["top_k"],
                                              cfg["capacity_factor"])
    assert _scale_err(got.detach(), want) <= TOL
    np.testing.assert_allclose(float(aux.detach()), float(want_aux),
                               rtol=AUX_RTOL)
    (torch.sum(got * torch.tensor(proj)) + 0.37 * aux).backward()
    assert _scale_err(xt.grad, gx) <= TOL
    grads = {"router.weight": gp["router"]["kernel"].T,
             "router.bias": gp["router"]["bias"],
             **{k: gp[k] for k in ("wi", "bi", "wo", "bo")}}
    for name, p in tm.named_parameters():
        assert _scale_err(p.grad, grads[name]) <= TOL, name


@pytest.mark.parametrize("cf", [2.0, 0.5])
@pytest.mark.parametrize("top_k", [1, 2])
def test_index_form_equals_onehot_form(cf, top_k):
    """The experts' input buffer bit for bit (dispatch is a selection),
    the output and every gradient within TOL (the combine sums ≤ top_k
    products in another order)."""
    params, x = _layer(seed=1)
    tm = _port_layer(params, capacity_factor=cf, top_k=top_k)
    toks = torch.tensor(x.reshape(-1, D))
    r = tm.routed(toks[None])[2]
    np.testing.assert_array_equal(
        tmoe.dispatch(toks, r, E, "indexed").numpy(),
        tmoe.dispatch(toks, r, E, "onehot").numpy())
    outs = {}
    for form in tmoe.FORMS:
        tm.zero_grad()
        xt = torch.tensor(x).requires_grad_()
        y, aux, _ = tm.routed(xt, form=form)
        (torch.sin(y).sum() + aux).backward()
        outs[form] = [y.detach(), xt.grad] + [
            p.grad.clone() for p in tm.parameters()]
    for a, b in zip(outs["indexed"], outs["onehot"]):
        assert _scale_err(a, b) <= TOL


def test_dispatch_that_ignores_capacity_fails():
    """The control: an index form that keeps every assignment (its slot
    taken modulo the capacity) must not equal JAX's at a capacity that
    drops."""
    params, x = _layer()
    cfg = dict(capacity_factor=0.5, top_k=2, normalize_gates=True)
    want = jmoe.MoEMLP(num_experts=E, mlp_dim=FF, **cfg).apply(
        {"params": params}, jnp.asarray(x))
    tm = _port_layer(params, **cfg)
    r = tm.routed(torch.tensor(x))[2]
    wrong = r._replace(kept=torch.ones_like(r.kept),
                       slot=r.slot % r.capacity)
    toks = torch.tensor(x.reshape(-1, D))
    y = tmoe.combine(tmoe._ffn(tmoe.dispatch(toks, wrong, E), tm.weights()),
                     wrong)
    assert _scale_err(y.detach().reshape(B, T, D), want) > 1e-2


def test_serving_form_equals_the_training_form_without_drops():
    """No capacity in serving: equal to the capacity form wherever that
    drops nothing (cf·top_k/E = 1 here, so it never does)."""
    params, x = _layer(seed=2)
    tm = _port_layer(params, capacity_factor=2.0, top_k=2).requires_grad_(
        False)
    y, _, r = tm.routed(torch.tensor(x))
    assert r.kept.all()
    served = tm.serve(torch.tensor(x), top_k=2, normalize_gates=True)
    assert _scale_err(served, y.detach()) <= TOL


def test_initialiser_scales():
    """lecun_normal on a 3-D kernel: fan_in E·d for wi, E·F for wo."""
    state = {}
    tmoe.moe_init(state, "m.", np.random.default_rng(0), dim=256,
                  mlp_dim=1024, num_experts=8)
    assert abs(state["m.wi"].std() - (8 * 256) ** -0.5) < 1e-4
    assert abs(state["m.wo"].std() - (8 * 1024) ** -0.5) < 1e-4
    assert abs(state["m.router.weight"].std() - 256 ** -0.5) < 2e-3
    assert not state["m.bi"].any() and not state["m.router.bias"].any()
    assert state["m.bi"].shape == (8, 1, 1024) and state["m.bo"].shape == (
        8, 1, 256)


# ---- the MoE ViT ---------------------------------------------------------


def _vit_pair(seed=0):
    jm = jax_get_model("vit_moe_micro", num_classes=10)
    tm = get_model("vit_moe_micro", num_classes=10, side=32, in_channels=3)
    rng = np.random.default_rng(seed + 100)
    state = tm.init_state(seed)
    for k, v in state.items():  # move LayerNorms and biases off their init
        if v.ndim == 1 or k.endswith((".bi", ".bo")):
            state[k] = (v + rng.normal(0, 0.2, v.shape)).astype(np.float32)
    tm.load_state_dict({k: torch.tensor(v) for k, v in state.items()})
    return jm, tm, vit_params_to_jax(state)


def _images(n=8, seed=1):
    x = np.random.default_rng(seed).integers(0, 256, (n, 32, 32, 3))
    return (x / 255.0).astype(np.float32)


def test_vit_moe_micro_equals_flax():
    """Logits, the aux sum and the whole gradient of CE + 0.01·aux."""
    jm, tm, params = _vit_pair()
    x, y = _images(), np.arange(8, dtype=np.int32) % 10

    def loss(p):
        logits, v = jm.apply({"params": p}, jnp.asarray(x),
                             mutable=["losses"])
        aux = sum(jax.tree.leaves(v["losses"]))
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, y).mean() + 0.01 * aux, (logits, aux)

    (_, (want, want_aux)), grads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(params)
    got, aux = tm(torch.tensor(x).permute(0, 3, 1, 2), with_aux=True)
    assert _scale_err(got.detach(), want) <= TOL
    np.testing.assert_allclose(float(aux.detach()), float(want_aux),
                               rtol=AUX_RTOL)
    (F.cross_entropy(got, torch.tensor(y).long()) + 0.01 * aux).backward()
    g = flatten_tree(vit_params_to_jax(
        {n: p.grad for n, p in tm.named_parameters()}))
    w = flatten_tree(jax.tree.map(np.asarray, grads))
    assert sorted(g) == sorted(w)
    assert any("/moe/" in k for k in w)
    for k in w:
        assert _scale_err(g[k], w[k]) <= TOL, k


def test_vit_moe_params_cross_both_ways():
    """vit_params_from_jax of a Flax-initialised MoEViT tree loads into
    the port strictly, and vit_params_to_jax gives the tree back."""
    jm = jax_get_model("vit_moe_micro", num_classes=10)
    params = jax.tree.map(np.asarray, jax.jit(jm.init)(
        jax.random.key(0), jnp.zeros((1, 32, 32, 3)))["params"])
    state = vit_params_from_jax(params)
    tm = get_model("vit_moe_micro", num_classes=10, side=32, in_channels=3)
    tm.load_state_dict({k: torch.tensor(v) for k, v in state.items()},
                       strict=True)
    back = flatten_tree(vit_params_to_jax(tm.state_dict()))
    want = flatten_tree(params)
    assert sorted(back) == sorted(want)
    assert all(np.array_equal(back[k], want[k]) for k in want)


def test_vit_moe_micro_step_equals_jax_make_train_step():
    """Two SGD-momentum steps (lr 0.05, momentum 0.9) on uint8 batches
    of 8 through ``parallel/ddp.make_train_step`` against JAX's on a
    1-device mesh, the aux losses in both objectives: loss, accuracy and
    grad norm per step (rtol 1e-5), then every parameter (atol 2e-5)."""
    jm, tm, params = _vit_pair()
    rng = np.random.default_rng(5)
    batches = [(rng.integers(0, 256, (8, 32, 32, 3), dtype=np.uint8),
                rng.integers(0, 10, 8).astype(np.int32)) for _ in range(2)]
    tx = jax_make_optimizer(name="sgd", lr=0.05, momentum=0.9)
    mesh = make_mesh(MeshSpec(data=1), devices=jax.devices()[:1])
    losses = jax.eval_shape(jm.init, jax.random.key(0),
                            jnp.zeros((1, 32, 32, 3)))["losses"]
    losses = jax.tree.map(lambda a: jnp.zeros(a.shape, a.dtype), losses)
    jstate = jddp.replicate_state(jddp.TrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        opt_state=tx.init(params), model_state={"losses": losses}), mesh)
    jstep = jddp.make_train_step(jm, tx, mesh, donate=False)
    state = TrainState(0, tm, make_optimizer(tm.parameters(), "sgd", lr=0.05,
                                             momentum=0.9))
    step = make_train_step(state, reduce=lambda t: t)
    for x, y in batches:
        jstate, jm_ = jstep(jstate, jnp.asarray(x), jnp.asarray(y))
        m = step(torch.tensor(x), torch.tensor(y))
        np.testing.assert_allclose(
            [float(m.loss), float(m.accuracy), float(m.grad_norm)],
            [float(jm_.loss), float(jm_.accuracy), float(jm_.grad_norm)],
            rtol=1e-5)
    got = flatten_tree(vit_params_to_jax(tm.state_dict()))
    want = flatten_tree(jax.tree.map(np.asarray, jstate.params))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=2e-5, rtol=0,
                                   err_msg=k)


def test_vit_moe_tiny_shapes_equal_flax():
    """vit_moe_tiny at CIFAR-100's shape: every parameter's shape and the
    count; 64 tokens (no cls), every 2nd of 12 blocks routed to 8."""
    shapes = jax.eval_shape(lambda: jmoe.MoEViTTiny(num_classes=100).init(
        jax.random.key(0), jnp.zeros((1, 32, 32, 3))))
    tm = get_model("vit_moe_tiny", num_classes=100, side=32, in_channels=3)
    got = {k: v.shape for k, v in
           flatten_tree(vit_params_to_jax(tm.state_dict())).items()}
    want = {"/".join(str(getattr(p, "key", p)) for p in path): leaf.shape
            for path, leaf in
            jax.tree_util.tree_leaves_with_path(shapes["params"])}
    assert got == want
    assert tm.pos_embed.shape == (1, 64, 192)
    assert sum("/moe/wi" in k for k in got) == 6
    assert got["block2/moe/wi"] == (8, 192, 768)


def test_cli_trains_vit_moe_micro_and_resumes(tmp_path, capsys):
    """``python -m ddp_tpu_torch.train --model vit_moe_micro`` (its
    main(), in-process): two epochs, then a resume that trains the
    third alone; the restored model is the MoE ViT."""
    args = ["--model", "vit_moe_micro", "--dataset", "cifar10",
            "--synthetic_data", "--device", "cpu", "--synthetic_size", "64",
            "--batch_size", "16", "--augment", "crop_flip",
            "--checkpoint_dir", str(tmp_path)]
    first = train_main(args + ["--epochs", "2"])
    assert all(np.isfinite(h["train_loss"]) for h in first.history)
    again = train_main(args + ["--epochs", "3"])
    out = capsys.readouterr().out.splitlines()
    assert "Resumed from checkpoint epoch 1" in out
    assert [h["epoch"] for h in again.history] == [2]
    assert ck.CheckpointManager(str(tmp_path)).read(2)["step"] == 12
    assert isinstance(again.state.model, tmoe.MoEViT)
    assert "block2.moe.wi" in again.state.model.state_dict()
