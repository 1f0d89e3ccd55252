"""ddp_tpu_torch's ViT ≡ the JAX package's (Flax), on the CPU.

Shared weights (the port's seeded init with every LayerNorm, bias and the
cls token moved off their init, carried across by
``interop/jax_params.vit_params_to_jax``) and the same images go through
``ddp_tpu.models.vit`` and the port: ``vit_micro`` (patch 7, d 32, 4
heads: 17 tokens at 32×32) and a patch-4, d-48, 3-head model at T 65
(ViT-Tiny's sequence: 64 patches + cls), with the cls token and
mean-pooled. Compared: logits and the whole gradient; the GQA
(group-major) and MHA (head-major) fused qkv layouts; the plain attention
the port runs on a CPU tensor at T = S = 65, non-causal, D 16, against
JAX's Pallas kernel in interpret mode; one SGD-momentum step against
JAX's ``make_train_step``; and ``python -m ddp_tpu_torch.train --model
vit_micro`` trains two epochs and resumes.

Tolerances: fp32, every tensor within 1e-5 of its own scale (max|want|,
at least 1): the frameworks sum in other orders. Attention against the
Pallas kernel: atol 2e-5 (tests/test_torch_flash.py's). The step: metrics
rtol 1e-5, parameters atol 2e-5 (tests/test_torch_ddp.py's). Negative
controls: torch's exact GELU or its LayerNorm eps 1e-5 must fail the
forward check (on dim images, where LayerNorm's eps shows).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from ddp_tpu.models import vit as jvit
from ddp_tpu.models import get_model as jax_get_model
from ddp_tpu.ops import flash as jflash
from ddp_tpu.parallel import ddp as jddp
from ddp_tpu.runtime.mesh import MeshSpec, make_mesh
from ddp_tpu.train.optim import make_optimizer as jax_make_optimizer
from ddp_tpu_torch.interop.jax_params import (
    flatten_tree,
    vit_params_from_jax,
    vit_params_to_jax,
)
from ddp_tpu_torch.models import get_model
from ddp_tpu_torch.models import vit as tvit
from ddp_tpu_torch.ops import attention as tattn
from ddp_tpu_torch.ops import flash as tflash
from ddp_tpu_torch.parallel.ddp import TrainState, make_train_step
from ddp_tpu_torch.train import checkpoint as ck
from ddp_tpu_torch.train.optim import make_optimizer
from ddp_tpu_torch.train.trainer import main as train_main

TOL = 1e-5
ATOL = 2e-5
RTOL = 1e-5
CONFIGS = {  # JAX model, port model (at 32×32×3, 10 classes)
    "micro": (lambda: jax_get_model("vit_micro", num_classes=10),
              lambda: get_model("vit_micro", num_classes=10, side=32,
                                in_channels=3)),
    "t65": (lambda: jvit.ViT(num_classes=10, patch_size=4, embed_dim=48,
                             depth=2, num_heads=3),
            lambda: tvit.ViT(10, 4, 48, 2, 3)),
    "t65_mean_pool": (lambda: jvit.ViT(num_classes=10, patch_size=4,
                                       embed_dim=48, depth=2, num_heads=3,
                                       use_cls_token=False),
                      lambda: tvit.ViT(10, 4, 48, 2, 3, use_cls_token=False)),
}


def _state(tm, seed=0):
    """The port's init with LayerNorms, biases and the cls token moved."""
    rng = np.random.default_rng(seed + 100)
    state = tm.init_state(seed)
    for k, v in state.items():
        if v.ndim == 1 or k == "cls_token":
            state[k] = (v + rng.normal(0, 0.2, v.shape)).astype(np.float32)
    tm.load_state_dict({k: torch.tensor(v) for k, v in state.items()})
    return vit_params_to_jax(state)


def _images(n=4, seed=1, scale=1.0):
    x = np.random.default_rng(seed).integers(0, 256, (n, 32, 32, 3))
    return (x / 255.0 * scale).astype(np.float32)


def _scale_err(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max()) / max(1.0, float(np.abs(want).max()))


def _compare(name, scale=1.0):
    """Logits and the whole gradient, port vs Flax → worst scaled errors."""
    jm, tm = (f() for f in CONFIGS[name])
    params = _state(tm)
    x = _images(scale=scale)
    y = np.arange(4, dtype=np.int32)

    def loss(p):
        logits = jm.apply({"params": p}, jnp.asarray(x))
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, y).mean(), logits

    (_, want), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    got = tm(torch.tensor(x).permute(0, 3, 1, 2))
    F.cross_entropy(got, torch.tensor(y).long()).backward()
    g = flatten_tree(vit_params_to_jax(
        {n: p.grad for n, p in tm.named_parameters()}))
    w = flatten_tree(jax.tree.map(np.asarray, grads))
    assert sorted(g) == sorted(w)
    return {"logits": _scale_err(got.detach(), want),
            "gradient": max(_scale_err(g[k], w[k]) for k in w)}


@pytest.mark.parametrize("scale", [1.0, 0.01], ids=["bright", "dim"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_forward_and_gradient_equal_flax(name, scale):
    errs = _compare(name, scale)
    assert max(errs.values()) <= TOL, errs


@pytest.mark.parametrize("attr,value", [("GELU_APPROXIMATE", "none"),
                                        ("LN_EPS", 1e-5)],
                         ids=["exact_gelu", "ln_eps_1e-5"])
def test_torch_defaults_fail_the_parity_check(monkeypatch, attr, value):
    monkeypatch.setattr(tvit, attr, value)
    errs = [_compare("t65", scale) for scale in (1.0, 0.01)]
    assert max(e["logits"] for e in errs) > TOL, errs


@pytest.mark.parametrize("kv_heads", [0, 2], ids=["mha", "gqa"])
def test_fused_qkv_layout_equals_flax(kv_heads):
    """The attention module alone, 4 heads of 8 over [2, 9, 32]: MHA's
    head-major and GQA's group-major column order, forward and the
    gradient of every parameter and of the input."""
    jm = jvit.MultiHeadAttention(num_heads=4, num_kv_heads=kv_heads)
    tm = tvit.MultiHeadAttention(32, 4, num_kv_heads=kv_heads)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 9, 32), np.float32)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0),
                                            jnp.zeros((2, 9, 32))))
    params = jax.tree.map(
        lambda a: rng.standard_normal(a.shape, np.float32) * 0.3,
        shapes["params"])
    tm.load_state_dict({k: torch.tensor(v) for k, v in
                        vit_params_from_jax(params).items()})
    (want, (gp, gx)) = jax.value_and_grad(
        lambda p, x: jnp.sum(jnp.sin(jm.apply({"params": p}, x))),
        argnums=(0, 1))(params, jnp.asarray(x))
    xt = torch.tensor(x).requires_grad_()
    got = torch.sin(tm(xt, torch.float32)).sum()
    got.backward()
    got = float(got.detach())
    assert abs(got - float(want)) <= TOL * max(1.0, abs(float(want)))
    assert _scale_err(xt.grad, gx) <= TOL
    g = flatten_tree(vit_params_to_jax(
        {n: p.grad for n, p in tm.named_parameters()}))
    w = flatten_tree(jax.tree.map(np.asarray, gp))
    assert max(_scale_err(g[k], w[k]) for k in w) <= TOL


def test_plain_attention_at_t65_equals_the_pallas_kernel():
    """What the ViT block runs on a CPU tensor (ops.attention's plain
    attention, and the flash wrapper's plain version) at T = S = 65,
    non-causal, H 3, D 16, against JAX's Pallas kernel (interpret mode,
    one 65-row block), forward and backward."""
    B, T, H, D = 2, 65, 3, 16
    rng = np.random.default_rng(9)
    q, k, v, do = (rng.standard_normal((B, T, H, D), np.float32)
                   for _ in range(4))
    (out, lse), vjp = jax.vjp(
        lambda q, k, v: jflash.flash_attention_with_lse(
            q, k, v, False, 512, 512, True),
        *(jnp.asarray(a) for a in (q, k, v)))
    want = [np.asarray(a) for a in (out, *vjp((jnp.asarray(do),
                                               jnp.zeros((B, T, H)))))]
    for fn in (lambda *a: tattn.best_attention()(*a),
               lambda *a: tflash.flash_attention(*a, False)):
        leaves = [torch.tensor(a).requires_grad_() for a in (q, k, v)]
        o = fn(*leaves)
        grads = torch.autograd.grad(o, leaves, torch.tensor(do))
        for a, b in zip([o, *grads], want):
            np.testing.assert_allclose(a.detach().numpy(), b, atol=ATOL,
                                       rtol=0)
    _, lse_t = tflash.flash_attention_with_lse(
        *(torch.tensor(a) for a in (q, k, v)), False)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse), atol=ATOL)


@pytest.mark.parametrize("name", ["t65", "micro"])
def test_sgd_momentum_steps_equal_jax_make_train_step(name):
    """Two SGD-momentum steps (lr 0.05, momentum 0.9) on uint8 batches
    of 4 through ``parallel/ddp.make_train_step`` against JAX's on a
    1-device mesh: loss, accuracy and grad norm per step, then every
    parameter."""
    jm, tm = (f() for f in CONFIGS[name])
    params = _state(tm)
    rng = np.random.default_rng(5)
    batches = [(rng.integers(0, 256, (4, 32, 32, 3), dtype=np.uint8),
                rng.integers(0, 10, 4).astype(np.int32)) for _ in range(2)]
    tx = jax_make_optimizer(name="sgd", lr=0.05, momentum=0.9)
    mesh = make_mesh(MeshSpec(data=1), devices=jax.devices()[:1])
    jstate = jddp.replicate_state(jddp.TrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        opt_state=tx.init(params), model_state={}), mesh)
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
            rtol=RTOL)
    got = flatten_tree(vit_params_to_jax(tm.state_dict()))
    want = flatten_tree(jax.tree.map(np.asarray, jstate.params))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=ATOL, rtol=0,
                                   err_msg=k)


def test_full_width_vit_tiny_shapes_equal_flax():
    """ViT-Tiny at CIFAR-100's shape: every parameter's shape, and the
    count (5.5 M)."""
    shapes = jax.eval_shape(lambda: jvit.ViTTiny(num_classes=100).init(
        jax.random.key(0), jnp.zeros((1, 32, 32, 3))))
    tm = get_model("vit_tiny", num_classes=100, side=32, in_channels=3)
    got = {k: v.shape for k, v in
           flatten_tree(vit_params_to_jax(tm.state_dict())).items()}
    want = {"/".join(str(getattr(p, "key", p)) for p in path): leaf.shape
            for path, leaf in
            jax.tree_util.tree_leaves_with_path(shapes["params"])}
    assert got == want
    assert sum(p.numel() for p in tm.parameters()) == sum(
        int(np.prod(s)) for s in want.values())
    assert tm.pos_embed.shape == (1, 65, 192)


def test_cli_trains_vit_micro_on_cifar10_and_resumes(tmp_path, capsys):
    """``python -m ddp_tpu_torch.train --model vit_micro --dataset cifar10
    --synthetic_data --device cpu`` (its main(), in-process): two epochs
    with crop-and-flip, checkpoints, then a resume that trains epoch 2
    alone."""
    args = ["--model", "vit_micro", "--dataset", "cifar10", "--synthetic_data",
            "--device", "cpu", "--synthetic_size", "64", "--batch_size", "16",
            "--augment", "crop_flip", "--log_interval", "100",
            "--checkpoint_dir", str(tmp_path)]
    first = train_main(args + ["--epochs", "2"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "No checkpoint found — starting from scratch"
    assert [h["epoch"] for h in first.history] == [0, 1]
    assert all(np.isfinite(h["train_loss"]) for h in first.history)
    assert out[-1].startswith("final_accuracy=")
    again = train_main(args + ["--epochs", "3"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "Resumed from checkpoint epoch 1"
    assert [h["epoch"] for h in again.history] == [2]
    mgr = ck.CheckpointManager(str(tmp_path))
    assert mgr.all_epochs() == [0, 1, 2] and mgr.read(2)["step"] == 12
    assert isinstance(again.state.model, tvit.ViT)
