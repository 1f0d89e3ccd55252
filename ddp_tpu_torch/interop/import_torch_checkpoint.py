"""Migrate a reference ``epoch_N.pt`` into the port's checkpoints (the
counterpart of ``scripts/import_torch_checkpoint.py``):

    python -m ddp_tpu_torch.interop.import_torch_checkpoint \\
        --pt checkpoints_torch/epoch_1.pt --checkpoint_dir ./checkpoints
    python -m ddp_tpu_torch.train --epochs 10    # resumes at epoch 2

writes epoch N of ``--checkpoint_dir`` (the port's layout, with its
manifest) from the file's weights and a fresh optimizer of the given
recipe, so ``python -m ddp_tpu_torch.train`` resumes at epoch N + 1. An
existing epoch N is never overwritten. Runs on the CPU: nothing of it
needs a card.
"""

from __future__ import annotations

import argparse

from ddp_tpu_torch.interop.torch_checkpoint import import_torch_checkpoint
from ddp_tpu_torch.models import get_model
from ddp_tpu_torch.parallel.ddp import TrainState
from ddp_tpu_torch.train.checkpoint import CheckpointManager
from ddp_tpu_torch.train.optim import make_optimizer


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m ddp_tpu_torch.interop.import_torch_checkpoint",
        description=__doc__.split("\n\n")[0])
    p.add_argument("--pt", required=True, help="reference .pt checkpoint file")
    p.add_argument("--checkpoint_dir", default="./checkpoints")
    p.add_argument("--optimizer", default="sgd",
                   choices=("sgd", "adam", "adamw"))
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--momentum", type=float, default=0.0)
    args = p.parse_args(argv)

    state_dict, epoch = import_torch_checkpoint(args.pt)
    model = get_model("simple_cnn", num_classes=10, side=28, in_channels=1)
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    got = {k: tuple(v.shape) for k, v in state_dict.items()}
    if got != want:  # shape-check against a fresh init before writing
        raise ValueError(f"shape mismatch: expected {want}, got {got}")
    model.load_state_dict(state_dict)
    state = TrainState(step=0, model=model, optimizer=make_optimizer(
        model.parameters(), args.optimizer, lr=args.lr,
        momentum=args.momentum))
    if not CheckpointManager(args.checkpoint_dir).save(epoch, state):
        raise SystemExit(f"epoch {epoch} already exists in "
                         f"{args.checkpoint_dir} — refusing to overwrite")
    print(f"Imported {args.pt} (epoch {epoch}) → {args.checkpoint_dir}; "
          f"python -m ddp_tpu_torch.train will resume at epoch {epoch + 1}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
