"""``--remat`` in the port: activation checkpointing of each residual or
encoder block leaves the training step unchanged, on the CPU.

One SGD-momentum step of a model built with ``remat=True`` against the
same model without it, from the same weights on the same batch:
the loss, every gradient and (for ResNet) BatchNorm's running statistics
bit for bit — the statistics advance once a step, not again in the
backward's recompute. ResNet-50 at width 8 with the ImageNet stem, the
ViT micro and the MoE-ViT micro. The trainer builds the model with
``--remat`` and refuses it where JAX refuses it.
"""

import numpy as np
import pytest
import torch

from ddp_tpu_torch.models import get_model
from ddp_tpu_torch.models.resnet import BatchNorm
from ddp_tpu_torch.parallel.ddp import TrainState, make_train_step
from ddp_tpu_torch.train.config import TrainConfig
from ddp_tpu_torch.train.optim import make_optimizer
from ddp_tpu_torch.train.trainer import main as train_main

CASES = {  # name → (registry name, extra kwargs, side, classes)
    "resnet50_w8": ("resnet50", {"width": 8}, 32, 10),
    "vit_micro": ("vit_micro", {}, 28, 10),
    "vit_moe_micro": ("vit_moe_micro", {}, 28, 10),
}


def _step(name, remat, x, y):
    reg, kw, side, classes = CASES[name]
    model = get_model(reg, num_classes=classes, side=side, in_channels=3,
                      remat=remat, **kw)
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in model.init_state(3).items()})
    if reg.startswith("resnet"):  # live BN scales, so every branch counts
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.weight.data.uniform_(0.5, 1.5, generator=torch.Generator()
                                       .manual_seed(m.weight.numel()))
    opt = make_optimizer(model.parameters(), "sgd", lr=0.05, momentum=0.9)
    state = TrainState(0, model, opt)
    metrics = make_train_step(state, reduce=lambda t: t)(x, y)
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    bufs = {n: b.clone() for n, b in model.named_buffers()}
    return metrics, grads, bufs, model


@pytest.mark.parametrize("name", sorted(CASES))
def test_remat_step_equals_plain_step(name):
    _, _, side, classes = CASES[name]
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(0, 256, (8, side, side, 3),
                                      dtype=np.uint8))
    y = torch.from_numpy(rng.integers(0, classes, 8).astype(np.int32))
    m0, g0, b0, plain = _step(name, False, x, y)
    m1, g1, b1, remat = _step(name, True, x, y)
    assert remat.remat and not plain.remat
    assert torch.equal(m0.loss, m1.loss)
    assert torch.equal(m0.grad_norm, m1.grad_norm)
    assert g0.keys() == g1.keys()
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k
    for k in b0:  # BatchNorm's running statistics: advanced once
        assert torch.equal(b0[k], b1[k]), k
    for (k, p), q in zip(plain.state_dict().items(),
                         remat.state_dict().values()):
        assert torch.equal(p, q), k  # the updated weights


def test_running_stats_move_once_per_step():
    """Twice the update would be momentum² on the old statistics; the
    remat step's buffers equal one fold of the batch statistics."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.integers(0, 256, (4, 32, 32, 3), dtype=np.uint8))
    y = torch.from_numpy(rng.integers(0, 10, 4).astype(np.int32))
    _, _, bufs, model = _step("resnet50_w8", True, x, y)
    assert not any(m.recomputing for m in model.modules()
                   if isinstance(m, BatchNorm))
    mean = bufs["stem_bn.running_mean"]
    assert not torch.equal(mean, torch.zeros_like(mean))
    _, _, plain, _ = _step("resnet50_w8", False, x, y)
    assert torch.equal(mean, plain["stem_bn.running_mean"])


def test_eval_and_no_grad_skip_the_checkpoint(monkeypatch):
    import ddp_tpu_torch.models.remat as remat_mod

    calls = []
    real = remat_mod.checkpoint
    monkeypatch.setattr(remat_mod, "checkpoint",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    model = get_model("vit_micro", num_classes=10, side=28, in_channels=3,
                      remat=True)
    x = torch.zeros(2, 3, 28, 28)
    model.eval()
    model(x)
    model.train()
    with torch.no_grad():
        model(x)
    assert calls == []
    model(x)
    assert len(calls) == len(model.block_names)


def test_trainer_builds_with_remat_and_refuses_simple_cnn(tmp_path):
    t = train_main(["--device", "cpu", "--model", "vit_micro", "--dataset",
                    "mnist", "--synthetic_data", "--synthetic_size", "64",
                    "--batch_size", "16", "--epochs", "1", "--remat",
                    "--eval_every", "0", "--checkpoint_dir",
                    str(tmp_path / "v")])
    assert t.state.model.remat and np.isfinite(t.summary["final_loss"])
    # ``ddp_tpu/train/trainer.py:768-771``'s message.
    with pytest.raises(ValueError, match=r"--remat is not supported by "
                       r"model 'simple_cnn' \(no block stack to "
                       r"rematerialize\)"):
        TrainConfig.from_args(["--model", "simple_cnn", "--remat"])
