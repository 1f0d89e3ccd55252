"""ddp_tpu_torch training slice ≡ the JAX package's causal-LM training.

Shared weights (a JAX ``init_lm`` tree carried over by
``lm_params_from_jax``) and the same batches go through JAX's
``make_lm_train_step`` on a 1×1 ``MeshSpec(data=1, seq=1)`` mesh (as
``bench.run_lm_bench`` builds it) and through the port's step on the
CPU; losses, accuracies and gradient norms are compared per step,
gradients and updated parameters leaf by leaf in the JAX layout
(``lm_params_to_jax``). The optimizers are the chains the JAX
``make_optimizer`` builds. On the CPU the port's attention takes its
plain path (the JAX step's does too: its flash kernel is TPU-only).

Tolerances, fp32: losses and norms rtol 1e-5; gradients and parameters
atol 2e-5 — the frameworks sum in different orders. Adam divides by
√v̂, so a gradient that is zero in exact arithmetic (the K bias:
softmax ignores a per-row shift) and ~1e-9 in floating point moves its
parameter by a step of up to lr whose size is noise: those K-bias
columns are held to steps × lr instead. bf16 compute: loss and grad
norm rtol 2e-2, parameters after two SGD steps atol 1e-3 — bf16 rounds
at other places in the two frameworks (fused bias adds, GELU in fp32 vs
bf16).
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddp_tpu.data import sequences as jseq
from ddp_tpu.data import text as jtext
from ddp_tpu.models import lm as jlm
from ddp_tpu.models.seq_transformer import replicated_train_state
from ddp_tpu.runtime.mesh import MeshSpec, make_mesh
from ddp_tpu.train import fast as jfast
from ddp_tpu.train.optim import make_optimizer as jax_make_optimizer
from ddp_tpu_torch.data import sequences as tseq
from ddp_tpu_torch.data import text as ttext
from ddp_tpu_torch.interop.jax_params import (
    flatten_tree,
    lm_params_from_jax,
    lm_params_to_jax,
)
from ddp_tpu_torch.models.lm import (
    CausalLM,
    LMSpec,
    init_lm_state,
    make_lm_eval_step,
    make_lm_train_step,
    next_token_loss,
)
from ddp_tpu_torch.train import fast as tfast
from ddp_tpu_torch.train.optim import make_optimizer

RTOL = 1e-5
ATOL = 2e-5
BF16_RTOL = 2e-2
BF16_PARAM_ATOL = 1e-3
REPO = Path(__file__).resolve().parent.parent
B, T, V = 4, 16, 32


H, DH = 4, 8


def _setup(num_kv_heads=0, seed=0, heads=H, head_dim=DH):
    """(JAX spec, JAX params, 1×1 mesh, port model on the CPU): seeded
    numpy weights in the JAX tree layout, carried into the port by
    ``lm_params_from_jax``."""
    jspec = jlm.LMSpec(vocab_size=V, total_len=T, d_model=heads * head_dim,
                       depth=2, num_heads=heads, num_kv_heads=num_kv_heads)
    spec = LMSpec(vocab_size=V, total_len=T, d_model=heads * head_dim,
                  depth=2, num_heads=heads, num_kv_heads=num_kv_heads)
    params = lm_params_to_jax(init_lm_state(spec, seed=seed))
    spec2, state = lm_params_from_jax(params, num_heads=heads)
    assert spec2 == spec
    model = CausalLM.from_state(spec, state, "cpu", trainable=True)
    mesh = make_mesh(MeshSpec(data=1, seq=1), devices=jax.devices()[:1])
    return jspec, params, mesh, model


def _k_bias_columns(num_kv_heads):
    """Columns of the fused qkv bias that feed K: their gradient is zero
    in exact arithmetic (softmax ignores a per-row shift of the logits),
    so Adam moves them by noise-sized, lr-bounded steps."""
    kv = num_kv_heads or H
    g = H // kv
    cols = np.zeros((kv, g + 2, DH), bool)  # MHA: [H, (q|k|v), Dh]
    cols[:, g] = True  # GQA: [H_kv, (q·G | k | v), Dh]
    return cols.reshape(-1)


def _batches(n, seed=1, batch=B):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, V, (batch, T)).astype(np.int32) for _ in range(n)]


def _assert_trees_close(port_state, jax_tree, atol, *, k_bias=None):
    """Leaf by leaf; ``k_bias=(num_kv_heads, bound)`` holds the K columns
    of the qkv biases to ``bound`` instead (see ``_k_bias_columns``)."""
    got = flatten_tree(lm_params_to_jax(port_state))
    want = flatten_tree(jax.tree.map(np.asarray, jax_tree))
    assert sorted(got) == sorted(want)
    for key in want:
        tol = np.full(want[key].shape, atol, np.float32)
        if k_bias is not None and key.endswith("attn/qkv/bias"):
            tol[_k_bias_columns(k_bias[0])] = k_bias[1]
        assert (np.abs(got[key] - want[key]) <= tol).all(), (
            key, float(np.abs(got[key] - want[key]).max()))


def _run_both(opt_kw, *, steps=3, num_kv_heads=0, jax_dtype=jnp.float32,
              torch_dtype=torch.float32, grad_accum_steps=1,
              label_smoothing=0.0, heads=H, head_dim=DH):
    jspec, params, mesh, model = _setup(num_kv_heads, heads=heads,
                                        head_dim=head_dim)
    tx = jax_make_optimizer(**opt_kw)
    jstate = replicated_train_state(params, tx, mesh)
    jstep = jlm.make_lm_train_step(
        jspec, tx, mesh, donate=False, compute_dtype=jax_dtype,
        grad_accum_steps=grad_accum_steps, label_smoothing=label_smoothing,
    )
    opt = make_optimizer(model.parameters(), **opt_kw)
    tstep = make_lm_train_step(
        model, opt, compute_dtype=torch_dtype,
        grad_accum_steps=grad_accum_steps, label_smoothing=label_smoothing,
    )
    rows = []
    for toks in _batches(steps):
        jstate, jm = jstep(jstate, jnp.asarray(toks))
        tm = tstep(torch.from_numpy(toks))
        rows.append((tm, jm))
    return model, jstate, rows


@pytest.mark.parametrize("num_kv_heads", [0, 2], ids=["mha", "gqa"])
def test_fp32_gradients_match_jax(num_kv_heads):
    """The training forward's next-token loss gradients ≡ JAX's
    ``dense_lm_apply`` gradients, leaf by leaf in the JAX layout."""
    jspec, params, mesh, model = _setup(num_kv_heads)
    toks = _batches(1)[0]
    _, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jlm.next_token_loss(jlm.dense_lm_apply(jspec, p, toks), toks)
    ))(params)
    logits = model.train_forward(torch.from_numpy(toks))
    next_token_loss(logits, torch.from_numpy(toks)).backward()
    _assert_trees_close(
        {n: p.grad for n, p in model.named_parameters()}, jgrads, ATOL)


@pytest.mark.parametrize("num_kv_heads", [0, 2], ids=["mha", "gqa"])
def test_adam_fp32_steps_match_jax(num_kv_heads):
    """Adam, fp32, 3 steps: per-step loss/accuracy/grad_norm and the
    final parameters, leaf by leaf."""
    opt_kw = dict(name="adam", lr=1e-3)
    model, jstate, rows = _run_both(opt_kw, num_kv_heads=num_kv_heads)
    for tm, jm in rows:
        np.testing.assert_allclose(float(tm.loss), float(jm.loss), rtol=RTOL)
        np.testing.assert_allclose(float(tm.accuracy), float(jm.accuracy),
                                   atol=1e-6)
        np.testing.assert_allclose(float(tm.grad_norm), float(jm.grad_norm),
                                   rtol=RTOL)
    _assert_trees_close(model.state_dict(), jstate.params, ATOL,
                        k_bias=(num_kv_heads, 3 * 1e-3))


@pytest.mark.parametrize(
    "opt_kw,accum,smoothing",
    [
        (dict(name="adam", lr=1e-3), 2, 0.0),
        (dict(name="adam", lr=1e-3), 1, 0.1),
        (dict(name="sgd", lr=0.1, momentum=0.9, weight_decay=1e-2), 1, 0.0),
        (dict(name="adamw", lr=1e-3, weight_decay=1e-2), 1, 0.0),
        (dict(name="sgd", lr=0.1, grad_clip_norm=0.5), 1, 0.0),
        (dict(name="adam", lr=1e-3, grad_clip_norm=0.5), 2, 0.1),
    ],
    ids=["accum2", "smoothing", "sgd-momentum-wd", "adamw", "sgd-clip",
         "adam-clip-accum-smoothing"],
)
def test_step_options_match_jax(opt_kw, accum, smoothing):
    """grad_accum_steps (strided microbatches), label smoothing, sgd with
    momentum and weight decay, adamw and the global-norm clip, each
    against the optax chain the JAX ``make_optimizer`` builds."""
    model, jstate, rows = _run_both(
        opt_kw, steps=2, grad_accum_steps=accum, label_smoothing=smoothing)
    for tm, jm in rows:
        np.testing.assert_allclose(float(tm.loss), float(jm.loss), rtol=RTOL)
        np.testing.assert_allclose(float(tm.grad_norm), float(jm.grad_norm),
                                   rtol=RTOL)
        np.testing.assert_allclose(float(tm.accuracy), float(jm.accuracy),
                                   atol=1e-6)
    _assert_trees_close(model.state_dict(), jstate.params, ATOL,
                        k_bias=(0, 2 * opt_kw["lr"]))


def test_step_at_a_head_dim_the_kernels_do_not_take_matches_jax():
    """Head dim 24, which B1-B3 do not take (on the card the step's
    attention takes the plain block there, ops/flash.route): one fp32
    SGD step ≡ JAX's (loss, grad norm, parameters), as the head-dim-8
    steps above are pinned."""
    model, jstate, rows = _run_both(dict(name="sgd", lr=0.1), steps=1,
                                    heads=2, head_dim=24)
    [(tm, jm)] = rows
    np.testing.assert_allclose(float(tm.loss), float(jm.loss), rtol=RTOL)
    np.testing.assert_allclose(float(tm.grad_norm), float(jm.grad_norm),
                               rtol=RTOL)
    _assert_trees_close(model.state_dict(), jstate.params, ATOL)


def test_bf16_compute_matches_jax():
    """bf16 compute over fp32 masters: the masters stay fp32, the loss
    and grad norm agree within the bf16 tolerance, and the parameters
    after two SGD steps (update = lr·g, so they show the gradients'
    difference, where Adam's normalised step would hide it) agree to
    BF16_PARAM_ATOL."""
    model, jstate, rows = _run_both(
        dict(name="sgd", lr=0.1), steps=2, jax_dtype=jnp.bfloat16,
        torch_dtype=torch.bfloat16)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    for tm, jm in rows:
        np.testing.assert_allclose(float(tm.loss), float(jm.loss),
                                   rtol=BF16_RTOL)
        np.testing.assert_allclose(float(tm.grad_norm), float(jm.grad_norm),
                                   rtol=BF16_RTOL)
    _assert_trees_close(model.state_dict(), jstate.params, BF16_PARAM_ATOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_eval_step_matches_jax(dtype):
    """Weighted Σ per-sequence accuracy and mean loss (a zero-weight
    padding row included) ≡ ``make_lm_eval_step``."""
    jspec, params, mesh, model = _setup()
    toks = _batches(1, seed=5)[0]
    w = np.asarray([1, 1, 0.5, 0], np.float32)
    jeval = jlm.make_lm_eval_step(jspec, mesh, compute_dtype=jnp.dtype(dtype))
    ja, jl = jeval(params, None, jnp.asarray(toks), jnp.zeros(B, jnp.int32),
                   jnp.asarray(w))
    ta, tl = make_lm_eval_step(model, compute_dtype=getattr(torch, dtype))(
        torch.from_numpy(toks), torch.from_numpy(w))
    rtol = RTOL if dtype == "float32" else BF16_RTOL
    np.testing.assert_allclose(float(tl), float(jl), rtol=rtol)
    np.testing.assert_allclose(float(ta), float(ja), atol=1e-6 if
                               dtype == "float32" else 0.07)


def test_epoch_runner_fed_jax_plan_matches_jax_runner():
    """Two epochs of the epoch runner fed JAX's permutation plan
    (``jax.random.permutation(key(seed + epoch), n)``) ≡
    ``make_lm_epoch_runner``, step for step, then in the final
    parameters; the tail that does not fill a batch is dropped."""
    jspec, params, mesh, model = _setup()
    seed, n = 3, 10
    data = _batches(1, seed=7, batch=n)[0]
    opt_kw = dict(name="sgd", lr=0.1, momentum=0.9)
    tx = jax_make_optimizer(**opt_kw)
    jrun = jfast.make_lm_epoch_runner(
        jspec, tx, mesh, jfast.device_put_replicated(data, mesh), B,
        seed=seed, donate=False)
    jstate = replicated_train_state(params, tx, mesh)
    opt = make_optimizer(model.parameters(), **opt_kw)
    plan = lambda e: np.asarray(  # noqa: E731
        jax.random.permutation(jax.random.key(seed + e), n))
    trun = tfast.make_lm_epoch_runner(model, opt, torch.from_numpy(data), B,
                                      seed=seed, permutation=plan)
    assert trun.steps_per_epoch == jrun.steps_per_epoch == 2
    for epoch in range(2):
        jstate, jm = jrun(jstate, epoch)
        tm = trun(epoch)
        for f in ("loss", "accuracy", "grad_norm"):
            np.testing.assert_allclose(
                getattr(tm, f).numpy(), np.asarray(getattr(jm, f)),
                rtol=RTOL, atol=1e-6, err_msg=f)
        assert len(trun.step_seconds()) == 2
    _assert_trees_close(model.state_dict(), jstate.params, ATOL)


def test_default_permutation_is_seeded_by_epoch():
    plan = tfast.default_permutation(50, seed=4)
    a, b = plan(0), plan(1)
    assert torch.equal(a, tfast.default_permutation(50, seed=4)(0))
    assert not torch.equal(a, b)
    assert sorted(a.tolist()) == list(range(50))


@pytest.mark.parametrize("seed", [0, 1, 17])
def test_synthetic_tokens_equal_jax(seed):
    for vocab, length in ((64, 32), (8192, 2048)):
        got = tseq.synthetic_tokens(6, total_len=length, vocab_size=vocab,
                                    seed=seed)
        want = jseq.synthetic_tokens(6, total_len=length, vocab_size=vocab,
                                     seed=seed)
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)


def test_byte_text_loader_equals_jax(tmp_path):
    """The byte-level branch: the same (train, test) arrays; an
    out-of-vocabulary byte is refused. A BPE vocabulary (tests/
    test_torch_bpe.py pins that branch) gives JAX's splits too."""
    rng = np.random.default_rng(9)
    path = tmp_path / "corpus.bin"
    rng.integers(0, 100, 1234).astype(np.uint8).tofile(path)
    for vocab in (256, 100):
        got = ttext.load_text_corpus(str(path), 32, vocab_size=vocab)
        want = jtext.load_text_corpus(str(path), 32, vocab_size=vocab)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.images, w.images)
            np.testing.assert_array_equal(g.labels, w.labels)
    for loader in (ttext.load_text_corpus, jtext.load_text_corpus):
        with pytest.raises(ValueError, match="byte 99"):
            loader(str(path), 32, vocab_size=64)
    got = ttext.load_text_corpus(str(path), 32, vocab_size=512,
                                 tokenizer_path=str(tmp_path / "t.json"))
    want = jtext.load_text_corpus(str(path), 32, vocab_size=512,
                                  tokenizer_path=str(tmp_path / "j.json"))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.images, w.images)


def test_params_to_jax_inverts_from_jax():
    _, params, _, model = _setup(num_kv_heads=2)
    back = flatten_tree(lm_params_to_jax(model.state_dict()))
    want = flatten_tree(params)
    assert sorted(back) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(back[k], want[k])


CLI = [sys.executable, "-m", "ddp_tpu_torch.train", "--device", "cpu"]


def test_train_cli_on_cpu_prints_final_accuracy(tmp_path):
    """``python -m ddp_tpu_torch.train --device cpu`` at a tiny size runs
    its epochs and prints final_accuracy=."""
    res = subprocess.run(
        CLI + ["--model", "causal_lm", "--synthetic_size", "16",
               "--seq_len", "16", "--vocab_size", "32", "--model_dim",
               "32", "--num_heads", "4", "--batch_size", "8",
               "--epochs", "2", "--optimizer", "adam", "--lr", "3e-3",
               "--checkpoint_dir", str(tmp_path)],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    lines = res.stdout.strip().splitlines()
    assert lines[-1].startswith("final_accuracy=")
    assert sum(line.startswith("epoch ") for line in lines) == 2


def test_train_cli_refuses_other_models():
    """The CLI refuses what the port does not train, naming why: the
    pipelined ViT alone and with --mesh_fsdp but no --mesh_pipe (JAX's
    guard: it needs --mesh_pipe >= 2) and under --zero1 (JAX's: the pipe
    family composes with the data axis and not zero1; the image models
    take --mesh_fsdp and --zero1 on JAX's GSPMD step, tests/
    test_torch_spmd_cli.py). --mesh_seq 2 and --mesh_fsdp 2 are taken by
    the sequence models (over a world they tile); --mesh_seq is refused
    for the image models."""
    for argv, why in (
            (["--model", "pipe_vit"], "needs --mesh_pipe >= 2"),
            (["--model", "pipe_vit", "--mesh_fsdp", "2"],
             "needs --mesh_pipe >= 2"),
            (["--model", "pipe_vit", "--mesh_pipe", "2", "--spawn", "2",
              "--zero1"], "not expert/seq/zero1")):
        bad = subprocess.run(CLI + argv, cwd=REPO,
                             capture_output=True, text=True, timeout=120)
        assert bad.returncode != 0 and why in bad.stderr
    from ddp_tpu_torch.train.config import TrainConfig

    for model in ("long_context", "causal_lm"):
        config = TrainConfig.from_args(["--model", model, "--mesh_seq", "2",
                                        "--spawn", "2"])
        assert config.mesh_seq == 2
        config = TrainConfig.from_args(["--model", model, "--mesh_fsdp",
                                        "2", "--spawn", "2"])
        assert config.mesh_fsdp == 2
    with pytest.raises(ValueError, match="only the sequence models"):
        TrainConfig.from_args(["--model", "simple_cnn", "--mesh_seq", "2",
                               "--spawn", "2"])
