"""Flags of ``python -m ddp_tpu_torch.train`` (the image-model and
causal-LM subset of ``ddp_tpu/train/config.py``, under the JAX names and
defaults)."""

from __future__ import annotations

import argparse
import dataclasses

from ddp_tpu_torch.models import IMAGE_MODELS

MODELS = IMAGE_MODELS + ("causal_lm",)
# JAX-package models the port does not train yet, by name prefix, with the
# ROADMAP item that brings them: the long-context classifier (A2.4) and
# the pipelined ViT (A4).
UNPORTED = {"long_context": "A2.4", "pipe_vit": "A4"}
IMAGE_DATASETS = ("mnist", "fashion_mnist", "kmnist", "uci_digits",
                  "cifar10", "cifar100")
SEQ_DATASETS = ("synthetic_seq", "text")


@dataclasses.dataclass
class TrainConfig:
    model: str = "simple_cnn"
    # "auto": mnist for the image models, synthetic_seq for causal_lm.
    dataset: str = "auto"
    data_root: str = "./data"
    synthetic_data: bool = False  # image models: the offline synthetic split
    text_file: str | None = None
    # Image models: the synthetic train split (None → the dataset's size;
    # test n // 6, CIFAR n // 5). causal_lm: sequences (None → 2048).
    synthetic_size: int | None = None
    seq_len: int = 2048
    vocab_size: int = 256
    model_dim: int | None = None  # None → 64
    model_depth: int | None = None  # None → 2 (causal_lm), the model's own
    num_heads: int = 4
    num_kv_heads: int = 0  # 0 → MHA
    # causal_lm: route every --moe_every-th block's MLP to this many
    # experts (0 = dense), top --moe_top_k each, gates renormalised unless
    # --moe_raw_gates (``ddp_tpu/train/config.py:103-116``). The image
    # family has its own models: vit_moe_tiny, vit_moe_micro.
    moe_experts: int = 0
    moe_every: int = 2
    moe_top_k: int = 2
    moe_raw_gates: bool = False
    batch_size: int = 32  # per rank (data shard)
    epochs: int = 10
    optimizer: str = "sgd"  # sgd | adam | adamw
    lr: float = 0.01
    momentum: float = 0.0
    weight_decay: float = 0.0
    warmup_steps: int = 0
    decay_steps: int = 0  # >0: warmup + cosine decay over this many steps
    lr_milestones: str = ""  # "3000,6000": lr ×= lr_decay_factor at each
    lr_decay_factor: float = 0.1
    grad_clip_norm: float = 0.0
    label_smoothing: float = 0.0
    augment: str = "none"  # image models, on the device: crop_flip | flip | shift
    grad_accum_steps: int = 1
    compute_dtype: str = "float32"  # float32 | bfloat16
    seed: int = 0
    # Checkpoints, every model (causal_lm adds the lm_spec.json sidecar).
    checkpoint_dir: str = "./checkpoints"
    max_checkpoints: int | None = None  # None = keep all
    resume_epoch: int | None = None  # rewind: later epochs are deleted
    # Image models only: evaluation, logging, the fast path, the ranks.
    eval_every: int = 1  # epochs between test-split evals (0 = only final)
    log_interval: int = 100
    fast_epoch: bool = False  # dataset on the device, one host read an epoch
    spawn: int = 1  # >1: N local ranks through torch.multiprocessing
    backend: str | None = None  # None: nccl on CUDA, gloo on the CPU
    device: str | None = None  # None → the GPU; "cpu" only when asked

    @classmethod
    def parser(cls) -> argparse.ArgumentParser:
        p = argparse.ArgumentParser(
            prog="python -m ddp_tpu_torch.train",
            description="Train an image model (SimpleCNN, ResNet, ViT) "
            "data-parallel, or the causal LM on one GPU (the PyTorch/CUDA "
            "port of train.py).",
        )
        choices = {
            "optimizer": ("sgd", "adam", "adamw"),
            "compute_dtype": ("float32", "bfloat16"),
            "dataset": ("auto",) + IMAGE_DATASETS + SEQ_DATASETS,
            "backend": ("nccl", "gloo"),
            "augment": ("none", "crop_flip", "flip", "shift"),
        }
        for f in dataclasses.fields(cls):
            kw = {"default": f.default}
            if f.type == "bool":
                kw["action"] = "store_true"
            elif f.name in choices:
                kw["choices"] = choices[f.name]
            elif f.type in ("int", "int | None"):
                kw["type"] = int
            elif f.type == "float":
                kw["type"] = float
            p.add_argument(f"--{f.name}", **kw)
        return p

    @classmethod
    def from_args(cls, argv=None) -> "TrainConfig":
        config = cls(**vars(cls.parser().parse_args(argv)))
        if config.model not in MODELS:
            item = next((v for k, v in UNPORTED.items()
                         if config.model.startswith(k)), None)
            raise ValueError(
                f"--model {config.model!r} is not ported: the port trains "
                f"{', '.join(MODELS)}"
                + (f"; {config.model} waits for ROADMAP {item}" if item else "")
            )
        # JAX's guards (``ddp_tpu/train/trainer.py:251-262``).
        if config.moe_experts and config.model != "causal_lm":
            raise ValueError(
                "--moe_experts routes the causal LM's MLPs: use --model "
                "causal_lm (images have --model vit_moe_tiny)"
            )
        if config.moe_experts and config.moe_every < 1:
            raise ValueError(
                f"--moe_every must be >= 1, got {config.moe_every}")
        return config

    @property
    def milestones(self) -> tuple[int, ...]:
        return tuple(int(m) for m in self.lr_milestones.split(",") if m.strip())
