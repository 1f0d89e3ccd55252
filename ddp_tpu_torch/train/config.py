"""Flags of ``python -m ddp_tpu_torch.train`` (the causal-LM subset of
``ddp_tpu/train/config.py``, under the JAX names and defaults)."""

from __future__ import annotations

import argparse
import dataclasses


@dataclasses.dataclass
class TrainConfig:
    model: str = "causal_lm"
    dataset: str = "synthetic_seq"  # synthetic_seq | text
    text_file: str | None = None
    synthetic_size: int | None = None  # None → 2048 sequences
    seq_len: int = 2048
    vocab_size: int = 256
    model_dim: int | None = None  # None → 64
    model_depth: int | None = None  # None → 2
    num_heads: int = 4
    num_kv_heads: int = 0  # 0 → MHA
    batch_size: int = 32
    epochs: int = 10
    optimizer: str = "sgd"  # sgd | adam | adamw
    lr: float = 0.01
    momentum: float = 0.0
    weight_decay: float = 0.0
    grad_clip_norm: float = 0.0
    label_smoothing: float = 0.0
    grad_accum_steps: int = 1
    compute_dtype: str = "float32"  # float32 | bfloat16
    seed: int = 0
    device: str | None = None  # None → the GPU; "cpu" only when asked

    @classmethod
    def parser(cls) -> argparse.ArgumentParser:
        p = argparse.ArgumentParser(
            prog="python -m ddp_tpu_torch.train",
            description="Train the causal LM on one GPU (the PyTorch/CUDA "
            "port of train.py --model causal_lm).",
        )
        for f in dataclasses.fields(cls):
            kw = {"default": f.default}
            if f.name == "optimizer":
                kw["choices"] = ("sgd", "adam", "adamw")
            elif f.name == "compute_dtype":
                kw["choices"] = ("float32", "bfloat16")
            elif f.name == "dataset":
                kw["choices"] = ("synthetic_seq", "text")
            elif f.type in ("int", "int | None"):
                kw["type"] = int
            elif f.type == "float":
                kw["type"] = float
            p.add_argument(f"--{f.name}", **kw)
        return p

    @classmethod
    def from_args(cls, argv=None) -> "TrainConfig":
        return cls(**vars(cls.parser().parse_args(argv)))
