"""The expert-routed causal LM in ddp_tpu_torch ≡ the JAX package's, on
the CPU.

A seeded numpy tree in the JAX layout (every 2nd of 4 blocks routed to 4
experts, top-2, GQA with 2 KV heads; biases random too) goes to JAX as it
is and to the port through ``lm_params_from_jax``. Compared:

- the forward: ``CausalLM.forward`` (the no-capacity serving form)
  against ``dense_lm_apply`` where capacity drops nothing (cf · top_k /
  E = 1), and ``train_forward``'s logits and aux (the mean over routed
  blocks) against JAX's capacity forward at top_k 2 and at top_k 1 with
  raw gates, where it drops;
- serving: the greedy stream of JAX's ``prefill`` + ``decode_step`` and
  of its ``ServeEngine`` (fixed-lane fp32 and int8, paged, γ 3
  speculative with the first two blocks as the draft) against the port's
  engines, token for token;
- training: two SGD steps of ``make_lm_train_step`` against JAX's (the
  loss includes 0.01 × aux), loss, accuracy and grad norm per step and
  every parameter after; the gradients leaf by leaf; one bf16 step;
- weights across (``lm_params_from_jax`` ↔ ``lm_params_to_jax``, a
  malformed ``moe`` subtree), checkpoints (the sidecar both ways,
  ``derive_spec_with_sidecar`` against JAX's, ``restore_for_inference``
  and the streaming restore, ``spec_skew`` on a dense → MoE reload), the
  CLI's refusals, and ``python -m ddp_tpu_torch.serve`` from an MoE
  checkpoint and from a JAX MoE ``.npz``.

Tolerances: logits 1e-4 (whole-model fp32, cross-framework sums), aux
rtol 1e-5; the step as tests/test_torch_train.py (rtol 1e-5, atol
2e-5; bf16 loss and grad norm rtol 2e-2). Greedy streams are compared
token for token; every compared token's top-2 logit gap clears 1e-4
(test_torch_serve's ``_assert_gaps``), and no token of the compared
forwards has top-2 gates within 1e-6 (counted: none at these seeds).
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddp_tpu.models import generate as jgen
from ddp_tpu.models import lm as jlm
from ddp_tpu.models.lm import LMSpec as JSpec
from ddp_tpu.models.seq_transformer import replicated_train_state
from ddp_tpu.runtime.mesh import MeshSpec, make_mesh
from ddp_tpu.serve.engine import ServeEngine as JEngine
from ddp_tpu.train import checkpoint as jck
from ddp_tpu.train.optim import make_optimizer as jax_make_optimizer
from ddp_tpu_torch.interop.jax_params import (
    flatten_tree,
    lm_params_from_jax,
    lm_params_to_jax,
)
from ddp_tpu_torch.models.lm import (
    CausalLM,
    LMSpec,
    derive_lm_spec,
    make_lm_train_step,
    truncated_draft,
)
from ddp_tpu_torch.models import lm as tlm
from ddp_tpu_torch.models.moe import is_moe_block, moe_mlp
from ddp_tpu_torch.serve import lifecycle as lc
from ddp_tpu_torch.serve.engine import COMPLETE, ServeEngine
from ddp_tpu_torch.train import checkpoint as ck
from ddp_tpu_torch.train.config import TrainConfig
from ddp_tpu_torch.train.optim import make_optimizer
from ddp_tpu_torch.train.trainer import main as train_main
from test_torch_generate import numpy_lm_tree
from test_torch_paged import _jax_tree
from test_torch_serve import _assert_gaps
from test_torch_spec import _serve, _serve_main_once

LOGITS_ATOL = 1e-4
AUX_RTOL = 1e-5
RTOL, ATOL = 1e-5, 2e-5
BF16_RTOL = 2e-2
NEAR_TIE = 1e-6
SPEC = JSpec(vocab_size=40, total_len=32, d_model=32, depth=4, num_heads=4,
             num_kv_heads=2, num_experts=4, moe_every=2)
PROMPTS = [[(5 * n + i) % SPEC.vocab_size for i in range(n)]
           for n in (1, 4, 7, 9, 12)]
NEW = 6
KNOBS = dict(slots=2, prefill_len=16, prefill_chunk=8, min_bucket=4)


def numpy_moe_tree(jspec: JSpec, seed: int = 0) -> dict:
    """numpy_lm_tree's dense tree, each routed block's MLP replaced by a
    random ``moe`` subtree (router, expert kernels and biases)."""
    tree = numpy_lm_tree(jspec, seed)
    rng = np.random.default_rng(seed + 1000)
    d, F = jspec.d_model, jspec.d_model * jspec.mlp_ratio
    E = jspec.num_experts

    def nrm(shape, std):
        return (rng.standard_normal(shape) * std).astype(np.float32)

    for i in range(jspec.depth):
        if is_moe_block(i, E, jspec.moe_every):
            blk = tree[f"block{i + 1}"]
            del blk["mlp1"], blk["mlp2"]
            blk["moe"] = {
                "router": {"kernel": nrm((d, E), 1.0), "bias": nrm((E,), 0.3)},
                "wi": nrm((E, d, F), d ** -0.5), "bi": nrm((E, 1, F), 0.1),
                "wo": nrm((E, F, d), F ** -0.5), "bo": nrm((E, 1, d), 0.1)}
    return tree


@functools.lru_cache(maxsize=None)
def pair(jspec: JSpec = SPEC, seed: int = 0):
    """(JAX params, port model) over the same numpy weights."""
    tree = numpy_moe_tree(jspec, seed)
    spec, state = lm_params_from_jax(tree, num_heads=jspec.num_heads)
    spec = spec._replace(moe_top_k=jspec.moe_top_k,
                         moe_normalize_gates=jspec.moe_normalize_gates)
    return _jax_tree(tree), CausalLM.from_state(spec, state, "cpu")


def _tokens(b=3, seed=1, t=SPEC.total_len):
    return np.random.default_rng(seed).integers(
        0, SPEC.vocab_size, (b, t)).astype(np.int32)


def _jax_forward(jspec, params, toks):
    """JAX's capacity forward → (logits, mean aux over routed blocks)."""
    logits, v = jlm._dense_lm(jspec).apply(
        {"params": params}, jnp.asarray(toks), mutable=["losses"])
    leaves = jax.tree.leaves(v["losses"])
    return np.asarray(logits), float(sum(leaves) / len(leaves))


def _near_ties(model, toks) -> int:
    """Tokens whose top-2 (or 2nd/3rd) gates lie within NEAR_TIE, at the
    input of every routed block of the port's serving forward."""
    count, x = 0, {}
    hooks = [blk.moe.register_forward_pre_hook(
        lambda m, a, _i=i: x.__setitem__(_i, a[0]))
        for i, blk in enumerate(model.blocks) if hasattr(blk, "moe")]
    with torch.no_grad():
        model(torch.tensor(toks))
        for i, h in x.items():
            blk = model.blocks[i].moe
            g = torch.softmax(blk.router(h.reshape(-1, h.shape[-1])), -1)
            top = torch.sort(g, -1, descending=True).values
            count += int(((top[:, 0] - top[:, 1]) < NEAR_TIE).sum()
                         + ((top[:, 1] - top[:, 2]) < NEAR_TIE).sum())
    for h in hooks:
        h.remove()
    return count


def test_forward_equals_dense_lm_apply():
    """The serving form over the whole sequence equals JAX's forward:
    at cf 2, top-2 of 4 experts the capacity is n, so nothing drops."""
    params, model = pair()
    toks = _tokens()
    assert _near_ties(model, toks) == 0
    want = np.asarray(jlm.dense_lm_apply(SPEC, params, jnp.asarray(toks)))
    with torch.no_grad():
        got = model(torch.tensor(toks)).numpy()
    np.testing.assert_allclose(got, want, atol=LOGITS_ATOL, rtol=0)


@pytest.mark.parametrize("routing", [dict(moe_top_k=2),
                                     dict(moe_top_k=1,
                                          moe_normalize_gates=False)],
                         ids=["top2", "top1_raw"])
def test_train_forward_and_aux_equal_jax(routing, monkeypatch):
    """Capacity routing over this forward's B·T tokens: logits and the
    mean aux. Top-1 at cf 2 of 4 experts has capacity n/2 and drops."""
    jspec = SPEC._replace(**routing)
    params, model = pair(jspec)
    toks = _tokens(b=4, seed=2)
    want, want_aux = _jax_forward(jspec, params, toks)
    kept = []

    def spy(*a, **kw):
        out = moe_mlp(*a, **kw)
        kept.append(float(out[2].kept.float().mean()))
        return out

    monkeypatch.setattr(tlm, "moe_mlp", spy)
    with torch.no_grad():
        got, aux = model.train_forward(torch.tensor(toks), return_aux=True)
    assert len(kept) == 2
    assert (min(kept) < 1.0) == (jspec.moe_top_k == 1), kept
    np.testing.assert_allclose(got.numpy(), want, atol=LOGITS_ATOL, rtol=0)
    np.testing.assert_allclose(float(aux), want_aux, rtol=AUX_RTOL)


def test_prefill_and_decode_step_greedy_equals_the_engine():
    """JAX's whole-batch reference (``prefill``, then ``decode_step``)
    greedy against the port's fixed-lane engine."""
    params, model = pair()
    prompt = PROMPTS[3]
    decode = jax.jit(functools.partial(jgen.decode_step, SPEC))
    logits, cache = jgen.prefill(SPEC, params, jnp.asarray([prompt]))
    want = []
    for _ in range(NEW):
        tok = int(jnp.argmax(logits[0]))
        want.append(tok)
        logits, cache = decode(params, cache, jnp.asarray([tok], jnp.int32))
    got = _serve(ServeEngine(model, **KNOBS), [(prompt, NEW, {})])[0]
    assert got == want
    _assert_gaps(model, prompt, got)


@pytest.mark.parametrize("kind", ["fp32", "int8", "paged"])
def test_engine_streams_equal_jax(kind):
    """Staggered admission over bucket edges (buckets {4, 8}, chunk 8):
    the port's engine against JAX's on the same weights."""
    params, model = pair()
    knobs = dict(KNOBS, kv_dtype="int8" if kind == "int8" else "fp32",
                 page_size=8 if kind == "paged" else 0)
    cases = [(p, NEW, {}) for p in PROMPTS]
    want = _serve(JEngine(SPEC, params, decode_attn="reference", **knobs),
                  cases, step_between=True)
    got = _serve(ServeEngine(model, **knobs), cases, step_between=True)
    assert got == want
    for p, toks in zip(PROMPTS, got):
        _assert_gaps(model, p, toks)


def test_speculative_streams_equal_jax_and_the_plain_engine():
    """γ 3 with the target's first two blocks (block 2 routed) as the
    draft: the port's streams equal JAX's speculative engine's and the
    port's plain engine's."""
    params, model = pair()
    dspec = SPEC._replace(depth=2)
    dparams = {k: v for k, v in params.items()
               if k not in ("block3", "block4")}
    draft = truncated_draft(model, 2)
    assert hasattr(draft.block2, "moe")
    cases = [(p, NEW, {}) for p in PROMPTS]
    want = _serve(JEngine(SPEC, params, draft_spec=dspec, draft_params=dparams,
                          spec_tokens=3, decode_attn="reference", **KNOBS),
                  cases, step_between=True)
    eng = ServeEngine(model, spec_tokens=3, draft_model=draft, **KNOBS)
    got = _serve(eng, cases, step_between=True)
    assert got == want
    assert got == _serve(ServeEngine(model, **KNOBS), cases,
                         step_between=True)
    assert eng.spec_acceptance_rate() is not None


def _train_pair(jspec=SPEC):
    params, _ = pair(jspec)
    np_params = jax.tree.map(np.asarray, params)
    spec, state = lm_params_from_jax(np_params, num_heads=jspec.num_heads)
    spec = spec._replace(moe_top_k=jspec.moe_top_k,
                         moe_normalize_gates=jspec.moe_normalize_gates)
    model = CausalLM.from_state(spec, state, "cpu", trainable=True)
    mesh = make_mesh(MeshSpec(data=1, seq=1), devices=jax.devices()[:1])
    return params, model, mesh


ROUTINGS = [dict(moe_top_k=2), dict(moe_top_k=1, moe_normalize_gates=False)]


@pytest.mark.parametrize("routing", ROUTINGS, ids=["top2", "top1_raw"])
def test_sgd_steps_equal_jax(routing):
    """Two SGD steps (lr 0.05): loss (aux included), accuracy and grad
    norm per step, then every parameter. Top-1 drops past capacity."""
    jspec = SPEC._replace(**routing)
    params, model, mesh = _train_pair(jspec)
    tx = jax_make_optimizer(name="sgd", lr=0.05)
    jstate = replicated_train_state(params, tx, mesh)
    jstep = jlm.make_lm_train_step(jspec, tx, mesh, donate=False)
    tstep = make_lm_train_step(model, make_optimizer(model.parameters(), "sgd",
                                                     lr=0.05))
    for seed in (3, 4):
        toks = _tokens(b=4, seed=seed)
        jstate, jm = jstep(jstate, jnp.asarray(toks))
        tm = tstep(torch.tensor(toks))
        np.testing.assert_allclose(
            [float(tm.loss), float(tm.accuracy), float(tm.grad_norm)],
            [float(jm.loss), float(jm.accuracy), float(jm.grad_norm)],
            rtol=RTOL)
    got = flatten_tree(lm_params_to_jax(model.state_dict()))
    want = flatten_tree(jax.tree.map(np.asarray, jstate.params))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=ATOL, rtol=0,
                                   err_msg=k)


def test_loss_with_aux_and_every_gradient_equal_jax():
    """One step's loss, CE + 0.01 · mean aux, and its gradient leaf by
    leaf against jax.grad of the same objective (``lm.py:633-636``)."""
    params, model, _ = pair()[0], *_train_pair()[1:]
    toks = _tokens(b=4, seed=5)

    def objective(p):
        logits, v = jlm._dense_lm(SPEC).apply(
            {"params": p}, jnp.asarray(toks), mutable=["losses"])
        leaves = jax.tree.leaves(v["losses"])
        return (jlm.next_token_loss(logits, jnp.asarray(toks))
                + SPEC.aux_loss_weight * sum(leaves) / len(leaves))

    want, grads = jax.jit(jax.value_and_grad(objective))(params)
    step = make_lm_train_step(model, make_optimizer(model.parameters(), "sgd",
                                                    lr=0.0))
    m = step(torch.tensor(toks))
    np.testing.assert_allclose(float(m.loss), float(want), rtol=RTOL)
    got = flatten_tree(lm_params_to_jax(
        {n: p.grad for n, p in model.named_parameters()}))
    want_g = flatten_tree(jax.tree.map(np.asarray, grads))
    for k in want_g:
        np.testing.assert_allclose(got[k], want_g[k], atol=ATOL, rtol=0,
                                   err_msg=k)
    assert any("/moe/router/" in k for k in want_g)


def test_bf16_step_equals_jax():
    """bf16 compute (the router in fp32 over bf16-rounded weights, the
    experts and the combine in bf16): loss and grad norm."""
    params, model, mesh = _train_pair()
    tx = jax_make_optimizer(name="sgd", lr=0.05)
    jstep = jlm.make_lm_train_step(SPEC, tx, mesh, donate=False,
                                   compute_dtype=jnp.bfloat16)
    toks = _tokens(b=4, seed=6)
    _, jm = jstep(replicated_train_state(params, tx, mesh), jnp.asarray(toks))
    tm = make_lm_train_step(
        model, make_optimizer(model.parameters(), "sgd", lr=0.05),
        compute_dtype=torch.bfloat16)(torch.tensor(toks))
    np.testing.assert_allclose([float(tm.loss), float(tm.grad_norm)],
                               [float(jm.loss), float(jm.grad_norm)],
                               rtol=BF16_RTOL)


# ---- weights, checkpoints and the CLI -------------------------------------


def test_params_round_trip_and_malformed_moe():
    tree = numpy_moe_tree(SPEC)
    spec, state = lm_params_from_jax(tree, num_heads=4)
    assert (spec.num_experts, spec.moe_every, spec.mlp_ratio) == (4, 2, 4)
    back = flatten_tree(lm_params_to_jax(state))
    want = flatten_tree(tree)
    assert sorted(back) == sorted(want)
    assert all(np.array_equal(back[k], want[k]) for k in want)
    assert lm_params_from_jax(want, num_heads=4)[0] == spec  # flat keys
    bad = dict(tree, block2=dict(tree["block2"], moe=dict(
        tree["block2"]["moe"], wi=np.zeros((4, 32)))))
    with pytest.raises(ValueError, match="moe"):
        lm_params_from_jax(bad, num_heads=4)


def test_derive_lm_spec_reads_the_routing_from_the_shapes():
    """num_experts, moe_every and the expert width from the shapes; the
    sidecar adds top-k and gate normalisation; a sidecar that routes
    other blocks raises and names both."""
    _, state = lm_params_from_jax(numpy_moe_tree(SPEC), num_heads=4)
    spec = derive_lm_spec(state, num_heads=4, moe_top_k=1,
                          moe_normalize_gates=False, strategy="ring")
    assert (spec.num_experts, spec.moe_every, spec.moe_top_k,
            spec.moe_normalize_gates) == (4, 2, 1, False)
    every1 = numpy_moe_tree(SPEC._replace(moe_every=1))
    assert lm_params_from_jax(every1, num_heads=4)[0].moe_every == 1
    with pytest.raises(ValueError, match=r"num_experts 8.*num_experts 4"):
        derive_lm_spec(state, num_heads=4, num_experts=8)
    with pytest.raises(ValueError, match=r"routed blocks \[3\].*\[2, 4\]"):
        derive_lm_spec(state, num_heads=4, num_experts=4, moe_every=3)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_sidecar_round_trip_and_derive_equal_jax(tmp_path, writer):
    """An MoE sidecar (top-1, raw gates) written by either package: the
    spec the port derives from it and the shapes equals JAX's."""
    jspec = SPEC._replace(moe_top_k=1, moe_normalize_gates=False)
    tree = numpy_moe_tree(jspec)
    spec, state = lm_params_from_jax(tree, num_heads=4)
    spec = spec._replace(moe_top_k=1, moe_normalize_gates=False)
    if writer == "port":
        ck.save_lm_spec(str(tmp_path), spec)
    else:
        jck.save_lm_spec(str(tmp_path), jspec)
    assert ck.load_lm_spec_fields(str(tmp_path)) == spec._asdict()
    got = ck.derive_spec_with_sidecar(str(tmp_path), state,
                                      num_heads_fallback=1)
    want = jck.derive_spec_with_sidecar(str(tmp_path), tree,
                                        num_heads_fallback=1)
    assert got == spec
    assert got._asdict() == {f: getattr(want, f) for f in LMSpec._fields}


def _moe_args(ckdir, epochs, *extra):
    return ["--model", "causal_lm", "--device", "cpu", "--synthetic_size",
            "16", "--seq_len", "16", "--vocab_size", "40", "--model_dim",
            "32", "--model_depth", "4", "--num_kv_heads", "2",
            "--moe_experts", "4", "--batch_size", "8", "--optimizer", "adam",
            "--lr", "3e-3", "--checkpoint_dir", str(ckdir), "--epochs",
            str(epochs), *extra]


@pytest.fixture(scope="module")
def moe_ckpt(tmp_path_factory):
    """An MoE-LM checkpoint of ``python -m ddp_tpu_torch.train``."""
    d = tmp_path_factory.mktemp("moe_ckpt")
    trainer = train_main(_moe_args(d, 2, "--moe_top_k", "1"))
    return str(d), trainer


def test_cli_trains_the_moe_lm_and_restores_it(moe_ckpt):
    """Two epochs with the MoE sidecar; restore_for_inference and the
    streaming restore give the trainer's parameters bit for bit."""
    d, trainer = moe_ckpt
    side = json.loads(open(f"{d}/{ck.LM_SPEC_FILENAME}").read())
    assert (side["num_experts"], side["moe_every"], side["moe_top_k"],
            side["moe_normalize_gates"]) == (4, 2, 1, True)
    assert all(np.isfinite(h["train_loss"]) for h in trainer.history)
    want = trainer.model.state_dict()
    state, epoch = ck.CheckpointManager(d).restore_for_inference()
    assert epoch == 1 and set(state) == set(want)
    assert all(torch.equal(state[k], want[k]) for k in want)
    assert ck.derive_spec_with_sidecar(d, state, num_heads_fallback=1) \
        == trainer.spec
    streaming = lc.StreamingRestore(d, device="cpu", first_blocks=1)
    assert streaming.spec == trainer.spec
    streaming.start()
    full = streaming.wait(60)
    assert all(torch.equal(full[k], want[k]) for k in want)


def test_dense_to_moe_reload_is_spec_skew(moe_ckpt):
    d, trainer = moe_ckpt
    dense = trainer.spec._replace(num_experts=0)
    with pytest.raises(lc.ReloadRejected) as e:
        lc.verify_reload_target(d, current_spec=dense)
    assert e.value.reason == lc.REASON_SPEC_SKEW
    assert "num_experts: 4" in e.value.detail
    assert lc.verify_reload_target(d, current_spec=trainer.spec).epoch == 1


def test_serve_cli_from_the_moe_checkpoint(moe_ckpt):
    """``python -m ddp_tpu_torch.serve --checkpoint_dir`` (main(), in
    this thread) with --page_size 4: the reply equals an in-process
    fixed-lane engine's stream on the restored weights."""
    d, trainer = moe_ckpt
    line, out = _serve_main_once(["--checkpoint_dir", d, "--page_size", "4"])
    assert line["spec"]["num_experts"] == 4 and line["spec"]["moe_top_k"] == 1
    assert out["reply"]["status"] == COMPLETE
    model = CausalLM.from_state(trainer.spec, trainer.model.state_dict(),
                                "cpu")
    assert out["reply"]["tokens"] == _serve(
        ServeEngine(model, slots=4, prefill_len=8), [([1, 2, 3], 5, {})])[0]


def test_serve_cli_from_a_jax_moe_npz(tmp_path):
    np.savez(tmp_path / "moe.npz", **flatten_tree(numpy_moe_tree(SPEC)))
    line, out = _serve_main_once(["--params_npz", str(tmp_path / "moe.npz"),
                                  "--num_heads", "4"])
    assert line["spec"]["num_experts"] == 4
    _, model = pair()
    assert out["reply"]["tokens"] == _serve(
        ServeEngine(model, slots=4, prefill_len=16), [([1, 2, 3], 5, {})])[0]


@pytest.mark.parametrize("argv,match", [
    (["--model", "vit_micro", "--moe_experts", "4"], "vit_moe_tiny"),
    (["--model", "causal_lm", "--moe_experts", "4", "--moe_every", "0"],
     "--moe_every must be >= 1"),
], ids=["image_model", "moe_every_0"])
def test_cli_refusals(argv, match):
    with pytest.raises(ValueError, match=match):
        TrainConfig.from_args(argv)
