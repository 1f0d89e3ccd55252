"""Reference-format (``.pt``) checkpoints for SimpleCNN
(``ddp_tpu/interop/torch_checkpoint.py``).

The reference saves ``{"epoch", "model": state_dict, "optimizer":
opt_state_dict}`` with ``torch.save`` every epoch, keys ``net.0.*`` /
``net.2.*`` (the two convs of its ``nn.Sequential``) and ``fl.*`` (the
linear head). The port's ``models/cnn.SimpleCNN`` has the same names and
the same NCHW layout (its flatten is the reference's), so an import is a
check of keys and shapes and the ``module.`` prefix that a DDP-wrapped
``state_dict()`` adds, not a re-gather: the imported network computes
the same function on the same images.

The optimizer state is not carried over: the reference runs
momentum-less SGD, whose state dict is empty. An import starts a fresh
optimizer; the epoch and the parameters carry over.
"""

from __future__ import annotations

from typing import Any, Mapping

import torch

REFERENCE_KEYS = ("net.0.weight", "net.0.bias", "net.2.weight", "net.2.bias",
                  "fl.weight", "fl.bias")


def strip_ddp_prefix(state_dict: Mapping[str, Any]) -> dict[str, Any]:
    """Drop the ``module.`` prefix a DDP-wrapped ``state_dict()`` adds
    (the reference saves unwrapped and re-prefixes on load: both forms
    occur)."""
    return {(k[len("module."):] if k.startswith("module.") else k): v
            for k, v in state_dict.items()}


def check_reference_state(state_dict: Mapping[str, Any]) -> dict:
    """The reference SimpleCNN's six tensors, as float32 CPU tensors, with
    shapes that fit one another (conv1 → conv2 → a square flatten → the
    head); raises KeyError / ValueError naming what does not."""
    sd = strip_ddp_prefix(state_dict)
    missing = sorted(set(REFERENCE_KEYS) - sd.keys())
    if missing:
        raise KeyError(
            f"not a reference SimpleCNN state_dict: missing {missing}")
    sd = {k: torch.as_tensor(sd[k]).detach().to("cpu", torch.float32)
          for k in REFERENCE_KEYS}
    w1, w2, fl = sd["net.0.weight"], sd["net.2.weight"], sd["fl.weight"]
    problems = []
    if w1.dim() != 4 or w2.dim() != 4 or fl.dim() != 2:
        problems.append("conv weights must be OIHW, the head [out, in]")
    else:
        if w2.shape[1] != w1.shape[0]:
            problems.append(f"conv2 takes {w2.shape[1]} channels, conv1 "
                            f"gives {w1.shape[0]}")
        hw, rem = divmod(fl.shape[1], w2.shape[0])
        if rem or round(hw ** 0.5) ** 2 != hw:
            problems.append(f"fl.weight width {fl.shape[1]} is not conv2's "
                            f"{w2.shape[0]} channels over a square")
        for k, n in (("net.0.bias", w1.shape[0]), ("net.2.bias", w2.shape[0]),
                     ("fl.bias", fl.shape[0])):
            if tuple(sd[k].shape) != (n,):
                problems.append(f"{k} has shape {tuple(sd[k].shape)}, "
                                f"not ({n},)")
    if problems:
        raise ValueError("reference SimpleCNN state_dict: "
                         + "; ".join(problems))
    return sd


def import_torch_checkpoint(path: str) -> tuple[dict, int]:
    """A reference ``epoch_N.pt`` → ``(state_dict, epoch)``, the state
    dict in the port's SimpleCNN names. ``weights_only=True``: a
    checkpoint file is data, not code."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(ckpt, dict) or "model" not in ckpt:
        raise ValueError(
            f"{path}: expected the reference's {{epoch, model, optimizer}} "
            "checkpoint layout")
    return check_reference_state(ckpt["model"]), int(ckpt.get("epoch", 0))


def export_torch_checkpoint(path: str, model, epoch: int, *, lr: float = 0.01,
                            momentum: float = 0.0) -> None:
    """Write ``{epoch, model, optimizer}`` as the reference does: the
    model's state dict (CPU copies) and the optimizer entry of its
    momentum-less SGD — an empty ``state`` and one param group listing
    the six tensors. Pass the run's ``lr`` / ``momentum`` so the file
    does not misstate its recipe."""
    state_dict = {k: v.detach().cpu().clone()
                  for k, v in model.state_dict().items()}
    torch.save({
        "epoch": int(epoch),
        "model": state_dict,
        "optimizer": {"state": {}, "param_groups": [{
            "lr": lr, "momentum": momentum,
            "params": list(range(len(state_dict))),
        }]},
    }, path)
