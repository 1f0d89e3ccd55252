"""Flags of ``python -m ddp_tpu_torch.train`` (the SimpleCNN and causal-LM
subset of ``ddp_tpu/train/config.py``, under the JAX names and
defaults)."""

from __future__ import annotations

import argparse
import dataclasses

MODELS = ("simple_cnn", "causal_lm")
# JAX-package models the port does not train yet, by name prefix, with the
# ROADMAP item that brings them.
UNPORTED = {"resnet": "A2.2", "vit_moe": "A2.4", "vit": "A2.1",
            "long_context": "A2.4", "pipe_vit": "A4"}
IMAGE_DATASETS = ("mnist", "fashion_mnist", "kmnist", "uci_digits")
SEQ_DATASETS = ("synthetic_seq", "text")


@dataclasses.dataclass
class TrainConfig:
    model: str = "simple_cnn"
    # "auto": mnist for simple_cnn, synthetic_seq for causal_lm.
    dataset: str = "auto"
    data_root: str = "./data"
    synthetic_data: bool = False  # simple_cnn: the offline synthetic split
    text_file: str | None = None
    # simple_cnn: the synthetic train split (None → 60000; test n // 6).
    # causal_lm: sequences (None → 2048).
    synthetic_size: int | None = None
    seq_len: int = 2048
    vocab_size: int = 256
    model_dim: int | None = None  # None → 64
    model_depth: int | None = None  # None → 2
    num_heads: int = 4
    num_kv_heads: int = 0  # 0 → MHA
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
    grad_accum_steps: int = 1
    compute_dtype: str = "float32"  # float32 | bfloat16
    seed: int = 0
    # simple_cnn only: checkpoints, evaluation, logging, the fast path,
    # and the ranks.
    checkpoint_dir: str = "./checkpoints"
    max_checkpoints: int | None = None  # None = keep all
    resume_epoch: int | None = None  # rewind: later epochs are deleted
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
            description="Train SimpleCNN data-parallel, or the causal LM on "
            "one GPU (the PyTorch/CUDA port of train.py).",
        )
        choices = {
            "optimizer": ("sgd", "adam", "adamw"),
            "compute_dtype": ("float32", "bfloat16"),
            "dataset": ("auto",) + IMAGE_DATASETS + SEQ_DATASETS,
            "backend": ("nccl", "gloo"),
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
                f"{' and '.join(MODELS)}"
                + (f"; {config.model} waits for ROADMAP {item}" if item else "")
            )
        return config

    @property
    def milestones(self) -> tuple[int, ...]:
        return tuple(int(m) for m in self.lr_milestones.split(",") if m.strip())
