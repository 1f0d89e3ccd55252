"""ddp_tpu_torch's long-context classifier ≡ the JAX package's, on the CPU.

Shared weights (the port's seeded init with every LayerNorm and bias
moved off its init, carried across by
``interop/jax_params.seq_transformer_params_to_jax``) and the same
numpy-seeded [B, T, d_in] sequences (T 64, d_model 32, depth 2, 2 heads:
head dim 16) go through ``ddp_tpu.models.seq_transformer`` and the port.
Compared: ``dense_apply``'s logits and ``jax.grad``'s gradients; the
ring and Ulysses attention at a ``seq`` world of one against JAX's
``make_seq_parallel_apply`` on a one-device mesh; the bf16
mixed-precision step; a few train steps against
``make_seq_parallel_train_step`` (label smoothing, strided
accumulation); the ``synthetic`` arrays; and ``python -m
ddp_tpu_torch.train --model long_context``'s train → eval → checkpoint →
resume flow with the JAX trainer's guards.

Tolerances: fp32, every tensor within 1e-5 of its own max-abs (the
frameworks sum in other orders); bf16 compute, the logits within 2e-2 of
their max-abs and each gradient within 2e-2 relative norm error (bf16
rounds at other places in the two frameworks, and one bf16 ulp of a
gradient's largest element is 0.4% of it). The step: metrics rtol 1e-5,
parameters atol 2e-5 (tests/test_torch_ddp.py's).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddp_tpu.data import sequences as jseq
from ddp_tpu.models import seq_transformer as jst
from ddp_tpu.runtime.mesh import MeshSpec, make_mesh
from ddp_tpu.train.optim import make_optimizer as jax_make_optimizer
from ddp_tpu_torch.data import sequences as tseq
from ddp_tpu_torch.interop.jax_params import (
    flatten_tree,
    seq_transformer_params_from_jax,
    seq_transformer_params_to_jax,
)
from ddp_tpu_torch.models import seq_transformer as tst
from ddp_tpu_torch.parallel.ddp import TrainState
from ddp_tpu_torch.runtime.mesh import local_mesh
from ddp_tpu_torch.train import checkpoint as ck
from ddp_tpu_torch.train.config import TrainConfig
from ddp_tpu_torch.train.optim import make_optimizer
from ddp_tpu_torch.train.trainer import check_ulysses_heads
from ddp_tpu_torch.train.trainer import main as train_main

TOL, BF16_TOL = 1e-5, 2e-2
RTOL, ATOL = 1e-5, 2e-5
B, T, D_IN, CLASSES = 4, 64, 8, 10
KW = dict(num_classes=CLASSES, total_len=T, d_in=D_IN, d_model=32, depth=2,
          num_heads=2)


def _specs(strategy="ring"):
    return (jst.SeqTransformerSpec(**KW, strategy=strategy),
            tst.SeqTransformerSpec(**KW, strategy=strategy))


def _state(seed=0):
    """The port's seeded init, its LayerNorms and biases moved off their
    init values (a zero bias or unit scale hides a transposed or dropped
    parameter) → (JAX tree, port state dict)."""
    _, spec = _specs()
    state = tst.init_seq_transformer(spec, seed=seed)
    rng = np.random.default_rng(seed + 100)
    for k, v in state.items():
        if v.ndim == 1:
            state[k] = (v + rng.uniform(-0.5, 0.5, v.shape)).astype(np.float32)
    tree = seq_transformer_params_to_jax(state)
    return tree, seq_transformer_params_from_jax(tree)


def _inputs(n=B, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, T, D_IN)).astype(np.float32),
            rng.integers(0, CLASSES, n).astype(np.int32))


def _mesh():
    return make_mesh(MeshSpec(data=1, seq=1), devices=jax.devices()[:1])


def _scale_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _norm_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _assert_grads(port_grads, jax_grads, tol, err=_scale_err):
    got = flatten_tree(seq_transformer_params_to_jax(port_grads))
    want = flatten_tree(jax.tree.map(np.asarray, jax_grads))
    assert sorted(got) == sorted(want)
    for k in want:
        assert err(got[k], want[k]) <= tol, (k, err(got[k], want[k]))


def test_param_tree_matches_jax_init():
    """The port's state dict maps onto JAX's init tree, leaf for leaf and
    shape for shape, and back without a change."""
    jspec, spec = _specs()
    jtree = jax.tree.map(np.asarray, jst.init_seq_transformer(jspec, seed=0))
    tree = seq_transformer_params_to_jax(tst.init_seq_transformer(spec))
    assert ({k: v.shape for k, v in flatten_tree(jtree).items()}
            == {k: v.shape for k, v in flatten_tree(tree).items()})
    back = seq_transformer_params_to_jax(seq_transformer_params_from_jax(tree))
    for k, v in flatten_tree(tree).items():
        np.testing.assert_array_equal(flatten_tree(back)[k], v)


def test_dense_forward_and_gradients_equal_jax():
    """``dense_apply``'s fp32 logits and the cross-entropy's gradients
    (``jax.grad``) within 1e-5 of each tensor's scale."""
    jspec, spec = _specs()
    tree, state = _state()
    x, y = _inputs()
    want = np.asarray(jst.dense_apply(jspec, tree, jnp.asarray(x)))
    got = tst.dense_apply(spec, state, torch.from_numpy(x)).numpy()
    assert _scale_err(got, want) <= TOL

    def jloss(p):
        logits = jst.dense_apply(jspec, p, jnp.asarray(x))
        return -jnp.mean(jax.nn.log_softmax(logits)[jnp.arange(B), y])

    jgrads = jax.jit(jax.grad(jloss))(tree)
    from ddp_tpu_torch.ops.attention import best_attention

    model = tst.build_model(spec, state, "cpu", attention_fn=best_attention())
    torch.nn.functional.cross_entropy(
        model(torch.from_numpy(x)), torch.from_numpy(y).long()).backward()
    _assert_grads({n: p.grad for n, p in model.named_parameters()}, jgrads,
                  TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("strategy", ["ring", "ulysses"])
def test_seq_parallel_apply_and_grads_at_world_1_equal_jax(strategy, dtype):
    """JAX's ``make_seq_parallel_apply`` on a one-device mesh (ring: the
    hop-0 block with its lse; Ulysses: the identity all-to-alls and the
    size dispatch) against the port's model with the same strategy:
    logits and gradients, fp32 within 1e-5 and the bf16 mixed-precision
    forward (bf16 blocks, fp32 master weights) within 2e-2."""
    jspec, spec = _specs(strategy)
    tree, state = _state(seed=2)
    x, y = _inputs(seed=3)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    tol = TOL if dtype == "float32" else BF16_TOL
    apply = jst.make_seq_parallel_apply(jspec, _mesh(), compute_dtype=jdt)

    def jloss(p):
        logits = apply(p, jnp.asarray(x)).astype(jnp.float32)
        return -jnp.mean(jax.nn.log_softmax(logits)[jnp.arange(B), y]), logits

    (_, want), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        tree)
    model = tst.build_model(spec, state, "cpu")
    logits = model(torch.from_numpy(x), compute_dtype=tdt)
    assert logits.dtype == torch.float32
    assert _scale_err(logits.detach().numpy(), np.asarray(want)) <= tol
    torch.nn.functional.cross_entropy(
        logits, torch.from_numpy(y).long()).backward()
    _assert_grads({n: p.grad for n, p in model.named_parameters()}, jgrads,
                  tol, _scale_err if dtype == "float32" else _norm_err)


@pytest.mark.parametrize(
    "opt_kw,accum,smoothing,dtype",
    [
        (dict(name="sgd", lr=0.05, momentum=0.9), 2, 0.1, "float32"),
        (dict(name="sgd", lr=0.05, weight_decay=1e-2), 1, 0.0, "float32"),
        (dict(name="sgd", lr=0.05), 1, 0.1, "bfloat16"),
    ],
    ids=["momentum-accum2-smoothing", "sgd-wd", "bf16-smoothing"],
)
def test_train_steps_equal_jax_make_seq_parallel_train_step(
        opt_kw, accum, smoothing, dtype):
    """Steps of JAX's ``make_seq_parallel_train_step`` on a one-device
    mesh against the port's ``TrainState`` and step: loss, accuracy and
    grad norm per step, the parameters after (fp32, three steps: rtol
    1e-5 / atol 2e-5; bf16 compute, two SGD steps: rtol 2e-2 / atol 1e-3,
    test_torch_train.py's)."""
    jspec, spec = _specs()
    tree, state = _state(seed=4)
    tx = jax_make_optimizer(**opt_kw)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    mesh = _mesh()
    jstate = jst.replicated_train_state(tree, tx, mesh)
    jstep = jst.make_seq_parallel_train_step(
        jspec, tx, mesh, donate=False, compute_dtype=jdt,
        grad_accum_steps=accum, label_smoothing=smoothing)
    one = local_mesh()
    model = tst.build_model(spec, state, "cpu", mesh=one)
    tstate = TrainState(0, model, make_optimizer(model.parameters(), **opt_kw))
    tstep = tst.make_seq_parallel_train_step(
        tstate, one, compute_dtype=getattr(torch, dtype),
        grad_accum_steps=accum, label_smoothing=smoothing)
    rtol, atol = (RTOL, ATOL) if dtype == "float32" else (BF16_TOL, 1e-3)
    steps = 3 if dtype == "float32" else 2
    for s in range(steps):
        x, y = _inputs(seed=10 + s)
        jstate, jm = jstep(jstate, jnp.asarray(x), jnp.asarray(y))
        tm = tstep(torch.from_numpy(x), torch.from_numpy(y))
        np.testing.assert_allclose(float(tm.loss), float(jm.loss), rtol=rtol)
        np.testing.assert_allclose(float(tm.grad_norm), float(jm.grad_norm),
                                   rtol=rtol)
        np.testing.assert_allclose(float(tm.accuracy), float(jm.accuracy),
                                   atol=1e-6)
    assert tstate.step == steps
    got = flatten_tree(seq_transformer_params_to_jax(model.state_dict()))
    want = flatten_tree(jax.tree.map(np.asarray, jstate.params))
    for k in want:
        assert float(np.abs(got[k] - want[k]).max()) <= atol, k


def test_eval_step_equals_jax_weighted_sums():
    """The weighted eval step returns JAX's ``(correct, loss_sum)``; the
    padding rows weighted 0 count nothing."""
    jspec, spec = _specs()
    tree, state = _state(seed=5)
    x, y = _inputs(seed=6)
    w = np.array([1, 1, 1, 0], np.float32)
    jeval = jst.make_seq_parallel_eval_step(jspec, _mesh())
    jc, jl = jeval(tree, {}, jnp.asarray(x), jnp.asarray(y), jnp.asarray(w))
    one = local_mesh()
    step = tst.make_seq_parallel_eval_step(
        tst.build_model(spec, state, "cpu", mesh=one), one)
    tc, tl = step(*(torch.from_numpy(a) for a in (x, y, w)))
    assert float(tc) == float(jc)
    np.testing.assert_allclose(float(tl), float(jl), rtol=RTOL)


@pytest.mark.parametrize("num,total_len,d_in,classes,seed",
                         [(16, 64, 8, 10, 0), (5, 33, 3, 4, 7)])
def test_synthetic_sequences_equal_jax(num, total_len, d_in, classes, seed):
    """``data/sequences.synthetic`` gives JAX's arrays bit for bit (the
    fixed template generator 0xC1A55 included)."""
    kw = dict(total_len=total_len, d_in=d_in, num_classes=classes, seed=seed)
    want = jseq.synthetic(num, **kw)
    got = tseq.synthetic(num, **kw)
    assert got.images.dtype == np.float32 and got.labels.dtype == np.int32
    np.testing.assert_array_equal(got.images, want.images)
    np.testing.assert_array_equal(got.labels, want.labels)


def _cli(tmp_path, *extra):
    return ["--model", "long_context", "--device", "cpu", "--seq_len",
            str(T), "--seq_dim", str(D_IN), "--batch_size", "4",
            "--synthetic_size", "256", "--lr", "1e-3", "--optimizer", "adam",
            "--log_interval", "8", "--checkpoint_dir",
            str(tmp_path / "ck"), *extra]


def test_train_eval_checkpoint_resume(tmp_path, capsys):
    """``test_trainer_seq.py::test_train_eval_checkpoint_resume``'s flow
    on the port: two epochs learn the separable task (> 0.8 test
    accuracy), each epoch is checkpointed with a verified manifest, and
    ``--epochs 3`` resumes from epoch 1 and trains one epoch."""
    trainer = train_main(_cli(tmp_path, "--epochs", "2"))
    assert trainer.summary["epochs_run"] == 2
    assert trainer.summary["final_accuracy"] > 0.8
    mgr = ck.CheckpointManager(str(tmp_path / "ck"))
    assert mgr.all_epochs() == [0, 1]
    assert all(mgr.verify_epoch(e) == [] for e in (0, 1))
    again = train_main(_cli(tmp_path, "--epochs", "3"))
    assert again.summary["epochs_run"] == 1
    assert "Resumed from checkpoint epoch 1" in capsys.readouterr().out
    assert int(again.state.step) == 3 * again.steps_per_epoch


def test_ulysses_and_remat_train(tmp_path):
    """``--seq_strategy ulysses`` and ``--remat`` each train an epoch to
    a finite loss."""
    for name, extra in (("u", ("--seq_strategy", "ulysses")),
                        ("r", ("--remat",))):
        t = train_main(_cli(tmp_path / name, "--epochs", "1",
                            "--synthetic_size", "64", *extra))
        assert t.summary["epochs_run"] == 1
        assert np.isfinite(t.summary["final_loss"])


@pytest.mark.parametrize("argv,match", [
    (["--model", "simple_cnn", "--mesh_seq", "4"], "long_context"),
    (["--model", "long_context", "--mesh_seq", "4", "--seq_len", "66"],
     "divisible"),
    pytest.param(["--model", "pipe_vit", "--mesh_fsdp", "2"],
                 "needs --mesh_pipe >= 2", id="argv2-A2.5"),
    (["--model", "long_context", "--augment", "flip"], "augment"),
    (["--model", "long_context", "--fast_epoch"], "fast_epoch"),
])
def test_config_guards(argv, match):
    """The JAX trainer's guards on the sequence flags: --mesh_seq needs a
    sequence model and must divide --seq_len; the pipelined ViT's fsdp
    without --mesh_pipe gets JAX's guard (this case pinned the image
    models' --mesh_fsdp refusal until their GSPMD step came, then the
    unported pipe_vit's fsdp, and keeps its id); long_context refuses
    augment and the fast path."""
    with pytest.raises(ValueError, match=match):
        TrainConfig.from_args(argv)


@pytest.mark.parametrize("dataset,match", [("mnist", "synthetic_seq"),
                                           ("text", "causal-LM data")])
def test_trainer_refuses_other_datasets(tmp_path, dataset, match):
    """``test_explicit_image_dataset_rejected``: an image dataset, and
    the text corpus (no class labels), are refused for long_context."""
    with pytest.raises(ValueError, match=match):
        train_main(_cli(tmp_path, "--dataset", dataset, "--text_file",
                        str(tmp_path / "none.txt")))


def test_ulysses_head_check():
    """``trainer.py:91``'s rule: the local heads must divide by the seq
    world (4 heads over 8 cannot)."""
    check_ulysses_heads(4, 1, 1)
    check_ulysses_heads(4, 1, 4)
    with pytest.raises(ValueError, match="heads"):
        check_ulysses_heads(4, 1, 8)
