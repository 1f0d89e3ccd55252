"""The parameter EMA of ddp_tpu_torch (``train/optim``), on the CPU.

- The recurrence ``ema = decay·ema + (1 − decay)·p`` over the
  post-update parameters equals the JAX package's ``param_ema`` on the
  same parameters and updates (SGD and Adam) within 1e-7 (the port
  computes it in XLA's order, so on this CPU the bits agree).
- A decay outside (0, 1) raises, as in JAX.
- The twins of ``tests/test_optim_extras.py``'s resume tests: an EMA
  switched on since the checkpoint is grafted from the restored
  parameters; switched off, the restore fails naming ``--ema_decay``;
  evaluation runs on the EMA and the EMA survives a checkpoint round
  trip bit for bit.
- ``--reset_opt_state`` keeps the weights and starts the optimizer
  (count, moments, EMA) fresh.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ddp_tpu.train.optim import ema_params as jax_ema_params
from ddp_tpu.train.optim import param_ema as jax_param_ema
from ddp_tpu_torch.runtime import dist
from ddp_tpu_torch.train.optim import EmaState, ema_params, make_optimizer, param_ema
from ddp_tpu_torch.train.trainer import main as train_main

CNN = ["--device", "cpu", "--synthetic_data", "--synthetic_size", "256",
       "--batch_size", "32", "--log_interval", "8", "--eval_every", "0"]


@pytest.mark.parametrize("name,decay", [("sgd", 0.9), ("adam", 0.99),
                                        ("sgd", 0.5), ("adam", 0.999)])
def test_recurrence_equals_jax_param_ema(name, decay):
    """JAX's chain (the update rule, then ``param_ema``) walks the
    parameters; the port's ``EmaState`` follows the same post-update
    parameters. The port's own optimizer carries the same recurrence over
    its own parameters (held in fp64)."""
    rng = np.random.default_rng(0)
    shapes = [(7, 5), (5,), (3, 4, 2)]
    init = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in shapes]
             for _ in range(6)]
    jtx = optax.chain(optax.sgd(0.1) if name == "sgd" else optax.adam(1e-2),
                      jax_param_ema(decay))
    jp = {str(i): jnp.asarray(a) for i, a in enumerate(init)}
    jstate = jtx.init(jp)
    update = jax.jit(jtx.update)  # as inside JAX's compiled train step
    ema = param_ema([torch.from_numpy(a) for a in init], decay)
    params = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in init]
    opt = make_optimizer(params, name, lr=0.1 if name == "sgd" else 1e-2,
                         ema_decay=decay)
    want64 = [p.detach().double() for p in params]
    for g in grads:
        updates, jstate = update({str(i): jnp.asarray(a)
                                  for i, a in enumerate(g)}, jstate, jp)
        jp = optax.apply_updates(jp, updates)
        ema.update([torch.from_numpy(np.array(jp[str(i)]))
                    for i in range(len(shapes))])
        for p, a in zip(params, g):
            p.grad = torch.from_numpy(a)
        opt.step()
        want64 = [decay * e + (1 - decay) * p.detach().double()
                  for e, p in zip(want64, params)]
    want = jax_ema_params(jstate)
    for i, e in enumerate(ema.ema):
        np.testing.assert_allclose(e.numpy(), np.asarray(want[str(i)]),
                                   rtol=1e-7, atol=1e-7)
    for e, w in zip(ema_params(opt), want64):
        np.testing.assert_allclose(e.double().numpy(), w.numpy(), rtol=1e-6,
                                   atol=1e-7)
    # The EMA lags the parameters it follows.
    assert not torch.allclose(ema_params(opt)[0], params[0])


def test_bad_decay_raises_and_no_ema_by_default():
    p = [torch.nn.Parameter(torch.ones(2))]
    for bad in (0.0, 1.0, -0.1, 1.5):
        with pytest.raises(ValueError, match="decay"):
            param_ema(p, bad)
        with pytest.raises(ValueError, match="decay"):
            jax_param_ema(bad)
    assert ema_params(make_optimizer(p, "sgd")) is None
    state = param_ema(p, 0.9)
    assert isinstance(state, EmaState)
    assert state.ema[0] is not p[0] and torch.equal(state.ema[0], p[0])


def _ema_equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(ema_params(a),
                                                 ema_params(b)))


def test_resume_with_ema_enabled_grafts_from_params(tmp_path):
    base = CNN + ["--checkpoint_dir", str(tmp_path / "ck")]
    t1 = train_main(base + ["--epochs", "1"])
    saved = [p.detach().clone() for p in t1.optimizer.params]
    t2 = train_main(base + ["--epochs", "1", "--ema_decay", "0.9"])
    assert t2.summary["epochs_run"] == 0  # already done, nothing trained
    for e, p in zip(ema_params(t2.optimizer), saved):
        assert torch.equal(e, p)
    t3 = train_main(base + ["--epochs", "2", "--ema_decay", "0.9"])
    assert t3.summary["epochs_run"] == 1  # the grafted state trains
    assert not torch.equal(ema_params(t3.optimizer)[0], saved[0])


def test_resume_with_ema_disabled_fails_clearly(tmp_path):
    base = CNN + ["--checkpoint_dir", str(tmp_path / "ck")]
    train_main(base + ["--epochs", "1", "--ema_decay", "0.9"])
    with pytest.raises(RuntimeError, match="ema_decay"):
        train_main(base + ["--epochs", "2"])


def test_ema_drives_eval_and_survives_the_checkpoint(tmp_path):
    args = CNN + ["--checkpoint_dir", str(tmp_path / "ck"), "--epochs", "1",
                  "--ema_decay", "0.5", "--eval_every", "1"]
    t = train_main(args)
    assert np.isfinite(t.summary["final_accuracy"])
    raw = t.optimizer.params[0]
    assert not torch.allclose(raw, ema_params(t.optimizer)[0])
    # Evaluation reads the EMA, and leaves the raw weights as they were
    # (the eval step sums over the world: a one-rank group again).
    before = [p.detach().clone() for p in t.optimizer.params]
    dist.setup(device="cpu")
    try:
        with t._ema_weights():
            want = t.evaluate_raw()
        assert t.evaluate() == want
        assert t.evaluate(use_ema=False) != want
    finally:
        dist.cleanup()
    assert all(torch.equal(a, b) for a, b in zip(before, t.optimizer.params))
    again = train_main(args)  # restores epoch 0, trains nothing
    assert again.summary["epochs_run"] == 0
    assert _ema_equal(t.optimizer, again.optimizer)
    assert again.summary["final_accuracy"] == want[0]


def test_reset_opt_state_keeps_weights_and_starts_fresh(tmp_path):
    base = CNN + ["--checkpoint_dir", str(tmp_path / "ck")]
    t1 = train_main(base + ["--epochs", "1", "--momentum", "0.9"])
    weights = {k: v.clone() for k, v in t1.state.model.state_dict().items()}
    # A changed recipe (adam) cannot restore the momentum state...
    with pytest.raises(RuntimeError, match="reset_opt_state"):
        train_main(base + ["--epochs", "1", "--optimizer", "adam"])
    # ...and with --reset_opt_state restores the weights alone.
    t2 = train_main(base + ["--epochs", "1", "--optimizer", "adam",
                            "--reset_opt_state", "--ema_decay", "0.9"])
    assert t2.summary["epochs_run"] == 0
    for k, v in t2.state.model.state_dict().items():
        assert torch.equal(v, weights[k]), k
    opt = t2.optimizer.state_dict()
    assert opt["count"] == 0
    assert all(float(m.abs().sum()) == 0 for m in opt["mu"] + opt["nu"])
    for e, p in zip(ema_params(t2.optimizer), t2.optimizer.params):
        assert torch.equal(e, p)  # the EMA starts from the restored weights
