"""The causal-LM trainer on one GPU (``ddp_tpu/train/trainer.py:812-966``,
causal-LM subset).

``Trainer`` builds the splits (synthetic token streams, or a byte-level
text file), the model from seeded weights (fp32 masters), the optimizer
and the epoch runner of ``train/fast.py``; ``train()`` runs the epochs,
reads the host once per epoch, evaluates on the test split every epoch
and returns a summary. :func:`main` is ``python -m
ddp_tpu_torch.train``: it prints one line per epoch and
``final_accuracy=`` as ``train.py`` does.

One card, one process: no data parallelism over ranks, no checkpoint or
resume yet (ROADMAP A8); any ``--model`` but ``causal_lm`` waits for
slice 3 (the reference trainer's main path).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ddp_tpu_torch.data import sequences
from ddp_tpu_torch.data.text import Split, load_text_corpus
from ddp_tpu_torch.device import resolve_device
from ddp_tpu_torch.models.lm import (
    CausalLM,
    LMSpec,
    init_lm_state,
    make_lm_eval_step,
)
from ddp_tpu_torch.train.config import TrainConfig
from ddp_tpu_torch.train.fast import make_lm_epoch_runner
from ddp_tpu_torch.train.optim import make_optimizer

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def build_splits(config: TrainConfig) -> tuple[Split, Split]:
    """(train, test) token splits: a train split of ``synthetic_size``
    sequences at ``seed`` and a test split of max(1, n // 6) at
    ``seed + 1`` (``trainer.py:842-858``), or the text file's."""
    if config.dataset == "text":
        if not config.text_file:
            raise ValueError("--dataset text needs --text_file PATH")
        return load_text_corpus(
            config.text_file, config.seq_len, vocab_size=config.vocab_size
        )
    if config.dataset != "synthetic_seq":
        raise ValueError(
            f"--model causal_lm trains on sequences, not {config.dataset!r}: "
            "use --dataset synthetic_seq or --dataset text"
        )
    n = config.synthetic_size or 2048

    def split(count, seed):
        toks = sequences.synthetic_tokens(
            count, total_len=config.seq_len, vocab_size=config.vocab_size,
            seed=seed,
        )
        return Split(toks, np.zeros(count, np.int32))

    return split(n, config.seed), split(max(1, n // 6), config.seed + 1)


class Trainer:
    def __init__(self, config: TrainConfig):
        if config.model != "causal_lm":
            raise ValueError(
                f"--model {config.model!r} is not ported yet: the port trains "
                "--model causal_lm; the image models and the reference "
                "trainer's main path come with slice 3"
            )
        self.config = config
        self.device = resolve_device(config.device)
        self.compute_dtype = DTYPES[config.compute_dtype]
        self.train_split, self.test_split = build_splits(config)
        self.spec = LMSpec(
            vocab_size=config.vocab_size,
            total_len=config.seq_len,
            d_model=config.model_dim or 64,
            depth=config.model_depth or 2,
            num_heads=config.num_heads,
            num_kv_heads=config.num_kv_heads,
        )
        self.model = CausalLM.from_state(
            self.spec, init_lm_state(self.spec, seed=config.seed),
            self.device, trainable=True,
        )
        self.optimizer = make_optimizer(
            self.model.parameters(), config.optimizer, lr=config.lr,
            momentum=config.momentum, weight_decay=config.weight_decay,
            grad_clip_norm=config.grad_clip_norm,
        )
        self.tokens = torch.as_tensor(self.train_split.images).to(self.device)
        self.runner = make_lm_epoch_runner(
            self.model, self.optimizer, self.tokens, config.batch_size,
            compute_dtype=self.compute_dtype, seed=config.seed,
            grad_accum_steps=config.grad_accum_steps,
            label_smoothing=config.label_smoothing,
        )
        self.eval_step = make_lm_eval_step(
            self.model, compute_dtype=self.compute_dtype
        )
        self.history: list[dict] = []

    def evaluate(self) -> tuple[float, float]:
        """Test-split (accuracy, loss): padded with wraparound to a batch
        multiple, padding weighted 0, totals divided by the split size."""
        tokens = self.test_split.images
        bs = self.config.batch_size
        n = len(tokens)
        padded = -(-n // bs) * bs
        weights = np.ones(padded, np.float32)
        weights[n:] = 0.0
        idx = np.arange(padded) % n
        acc = loss = torch.zeros((), device=self.device)
        for b in range(padded // bs):
            sel = idx[b * bs:(b + 1) * bs]
            a, l = self.eval_step(
                torch.as_tensor(tokens[sel]).to(self.device),
                torch.as_tensor(weights[b * bs:(b + 1) * bs]).to(self.device),
            )
            acc, loss = acc + a, loss + l
        return float(acc) / n, float(loss) / n

    def train(self) -> dict:
        cfg = self.config
        steps = self.runner.steps_per_epoch
        tokens_per_step = cfg.batch_size * cfg.seq_len
        for epoch in range(cfg.epochs):
            t0 = time.perf_counter()
            metrics = self.runner(epoch)
            # The epoch's one host read.
            loss, acc, gnorm = (m.float().cpu().numpy() for m in metrics[:3])
            wall = time.perf_counter() - t0
            step_s = self.runner.step_seconds()
            test_acc, test_loss = self.evaluate()
            rec = {
                "epoch": epoch + 1,
                "loss": loss.tolist(),
                "accuracy": acc.tolist(),
                "grad_norm": gnorm.tolist(),
                "train_loss": float(loss.mean()),
                "train_accuracy": float(acc.mean()),
                "test_accuracy": test_acc,
                "test_loss": test_loss,
                "epoch_seconds": wall,
                "tokens_per_s": steps * tokens_per_step / wall,
                "step_seconds": step_s,
                "step_p50_s": float(np.median(step_s)),
            }
            self.history.append(rec)
            print(
                f"epoch {epoch + 1}/{cfg.epochs}: train loss "
                f"{rec['train_loss']:.4f} acc {rec['train_accuracy']:.4f} | "
                f"test loss {test_loss:.4f} acc {test_acc:.4f} | "
                f"{rec['tokens_per_s']:.1f} tokens/s, step p50 "
                f"{rec['step_p50_s'] * 1e3:.2f} ms ({self.device})",
                flush=True,
            )
        last = self.history[-1] if self.history else None
        self.summary = {
            "epochs_run": len(self.history),
            "final_accuracy": last["test_accuracy"] if last else None,
            "final_loss": last["test_loss"] if last else None,
            "history": self.history,
        }
        return self.summary


def main(argv=None) -> Trainer:
    """``python -m ddp_tpu_torch.train [flags]`` → the trained Trainer;
    prints ``final_accuracy=`` last."""
    trainer = Trainer(TrainConfig.from_args(argv))
    summary = trainer.train()
    if summary["final_accuracy"] is not None:
        print(f"final_accuracy={summary['final_accuracy']:.4f}", flush=True)
    return trainer
