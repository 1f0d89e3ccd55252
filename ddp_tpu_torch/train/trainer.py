"""The trainers behind ``python -m ddp_tpu_torch.train``.

:class:`CNNTrainer` is ``train.py``'s main path
(``ddp_tpu/train/trainer.py:2047-3006``, the SimpleCNN subset):
MNIST-family data sharded over the ranks of ``torch.distributed``
(``data/loader``, ``data/sampler``), the data-parallel step
(``parallel/ddp``, one all-reduce a step) or the compiled-epoch runner
(``--fast_epoch``), a checkpoint with an integrity manifest every epoch,
auto-resume from ``--checkpoint_dir`` with the optimizer state, and an
evaluation on the test split every ``eval_every`` epochs. Rank 0 prints
the JAX trainer's log lines (0-based epoch tags, as the reference's
checkpoints) and ``final_accuracy=``.

:class:`LMTrainer` trains the causal LM on one card
(``trainer.py:812-966``, causal-LM subset): synthetic token streams or a
byte-level text file, fp32 master weights, the epoch runner of
``train/fast.py``, one host read per epoch and an eval every epoch; no
ranks or checkpoints yet (ROADMAP A2.4).

:func:`main` is the CLI: ``--spawn N`` starts N local ranks through
``torch.multiprocessing`` (nccl: one card each, never more ranks than
cards; ``--backend gloo`` may share cards, and is the transport of
``--device cpu``).
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from ddp_tpu_torch.data import sequences
from ddp_tpu_torch.data.loader import ShardedLoader
from ddp_tpu_torch.data.registry import NUM_CLASSES, load_dataset
from ddp_tpu_torch.data.text import Split, load_text_corpus
from ddp_tpu_torch.device import resolve_device
from ddp_tpu_torch.models.cnn import SimpleCNN, init_cnn_state
from ddp_tpu_torch.models.lm import (
    CausalLM,
    LMSpec,
    init_lm_state,
    make_lm_eval_step,
)
from ddp_tpu_torch.parallel.ddp import TrainState, make_eval_step, make_train_step
from ddp_tpu_torch.runtime import dist
from ddp_tpu_torch.train.checkpoint import CheckpointManager
from ddp_tpu_torch.train.config import IMAGE_DATASETS, TrainConfig
from ddp_tpu_torch.train.fast import (
    make_epoch_runner,
    make_lm_epoch_runner,
    run_steps,
    step_seconds,
)
from ddp_tpu_torch.train.optim import make_optimizer, make_schedule

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
    if config.dataset not in ("auto", "synthetic_seq"):
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


class LMTrainer:
    def __init__(self, config: TrainConfig):
        if config.model != "causal_lm":
            raise ValueError(f"LMTrainer trains --model causal_lm, not "
                             f"{config.model!r}")
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


class CNNTrainer:
    """SimpleCNN on an MNIST-family split, data-parallel over the ranks of
    ``ctx`` (a ``runtime/dist`` context). ``--batch_size`` is per rank;
    the global batch is batch_size × world × grad_accum_steps."""

    def __init__(self, config: TrainConfig, ctx: dist.DistContext):
        if config.model != "simple_cnn":
            raise ValueError(f"CNNTrainer trains --model simple_cnn, not "
                             f"{config.model!r}")
        self.config, self.ctx = config, ctx
        self.device = ctx.device
        self.rank, self.world = ctx.process_id, ctx.num_processes
        self.dataset = "mnist" if config.dataset == "auto" else config.dataset
        if self.dataset not in IMAGE_DATASETS:
            raise ValueError(f"--model simple_cnn trains on images, not "
                             f"{self.dataset!r}")
        self.train_split, self.test_split = load_dataset(
            self.dataset, config.data_root,
            allow_synthetic=config.synthetic_data,
            synthetic_size=config.synthetic_size,
        )
        self.compute_dtype = DTYPES[config.compute_dtype]
        self.per_shard_batch = config.batch_size
        self.global_batch_size = (config.batch_size * self.world
                                  * config.grad_accum_steps)
        side = self.train_split.images.shape[1]
        classes = NUM_CLASSES[self.dataset]
        model = SimpleCNN.from_state(
            init_cnn_state(num_classes=classes, side=side, seed=config.seed),
            self.device, num_classes=classes,
        )
        lr = make_schedule(
            config.lr, warmup_steps=config.warmup_steps,
            decay_steps=config.decay_steps, lr_milestones=config.milestones,
            lr_decay_factor=config.lr_decay_factor,
        )
        optimizer = make_optimizer(
            model.parameters(), config.optimizer, lr=lr,
            momentum=config.momentum, weight_decay=config.weight_decay,
            grad_clip_norm=config.grad_clip_norm,
        )
        self.state = TrainState(step=0, model=model, optimizer=optimizer)
        self.eval_step = make_eval_step(model, compute_dtype=self.compute_dtype)
        self.fast_runner = self.loader = None
        if config.fast_epoch:
            if config.grad_accum_steps != 1:
                raise ValueError("--fast_epoch runs no gradient accumulation "
                                 "(as in the JAX package)")
            self.fast_runner = make_epoch_runner(
                self.state,
                torch.from_numpy(self.train_split.images).to(self.device),
                torch.from_numpy(self.train_split.labels).to(self.device),
                self.global_batch_size, rank=self.rank, world=self.world,
                compute_dtype=self.compute_dtype, seed=config.seed,
                label_smoothing=config.label_smoothing,
            )
            self.steps_per_epoch = self.fast_runner.steps_per_epoch
            self.train_step = self.fast_runner.step
        else:
            self.loader = ShardedLoader(
                self.train_split.images, self.train_split.labels,
                self.global_batch_size, rank=self.rank, world=self.world,
                device=self.device, seed=config.seed,
            )
            self.steps_per_epoch = self.loader.steps_per_epoch()
            self.train_step = make_train_step(
                self.state, world=self.world,
                compute_dtype=self.compute_dtype,
                grad_accum_steps=config.grad_accum_steps,
                label_smoothing=config.label_smoothing,
            )
        self.ckpt = CheckpointManager(
            config.checkpoint_dir, max_to_keep=config.max_checkpoints,
            is_main=ctx.is_main,
        )
        self.history: list[dict] = []

    def log(self, msg: str) -> None:
        if self.ctx.is_main:
            print(msg, flush=True)

    def _restore_or_init(self) -> int:
        """The start epoch: ``--resume_epoch`` (its later epochs deleted),
        else the latest intact checkpoint + 1, else 0."""
        cfg = self.config
        if cfg.resume_epoch is not None:
            epoch = self.ckpt.restore(self.state, cfg.resume_epoch)
            stale = self.ckpt.delete_after(epoch)
            if stale:
                self.log(f"Rewind to epoch {epoch}: deleted the abandoned "
                         f"branch's checkpoints {stale}")
            self.log(f"Resumed from requested epoch {epoch}")
            return epoch + 1
        start = self.ckpt.restore_or_init(self.state)  # logs any quarantine
        if start:
            self.log(f"Resumed from checkpoint epoch {start - 1}")
        else:
            self.log("No checkpoint found — starting from scratch")
        return start

    def _train_epoch(self, epoch: int) -> dict:
        cfg = self.config
        on_gpu = self.device.type == "cuda"
        self.log(f"Starting epoch {epoch}"
                 + (" (compiled fast path)" if self.fast_runner else ""))
        t0 = time.perf_counter()
        if self.fast_runner is not None:
            metrics = self.fast_runner(epoch)
            marks = self.fast_runner.marks
        else:
            metrics, marks = run_steps(self.train_step, self.loader.epoch(epoch),
                                       on_gpu=on_gpu)
        # The epoch's one host read.
        loss, acc, gnorm = (m.float().cpu().numpy() for m in metrics[:3])
        seconds = time.perf_counter() - t0
        step_s = step_seconds(marks)
        n = len(loss)
        for b in range(0, n, cfg.log_interval):
            self.log(f"Epoch {epoch} Batch {b} Loss {loss[b]:.4f}")
        rate = n * self.global_batch_size / seconds
        self.log(f"Epoch {epoch} done: {n} batches in {seconds:.2f}s "
                 f"({rate:.0f} images/sec global)")
        return {
            "epoch": epoch,
            "loss": loss.tolist(),
            "accuracy": acc.tolist(),
            "grad_norm": gnorm.tolist(),
            "train_loss": float(loss.mean()),
            "train_accuracy": float(acc.mean()),
            "epoch_seconds": seconds,
            "images_per_s": rate,
            "images_per_s_per_card": rate / self.world,
            "step_seconds": step_s,
            "step_p50_s": float(np.median(step_s)),
        }

    def evaluate(self) -> tuple[float, float]:
        """Test-split (accuracy, loss): padded with wraparound to a global
        batch multiple, the padding weighted 0, each rank feeding its
        contiguous slice of every batch, totals over the split size."""
        images, labels = self.test_split
        local = self.per_shard_batch
        bs = local * self.world
        n = len(images)
        if n == 0:
            return float("nan"), float("nan")
        padded = -(-n // bs) * bs
        weights = np.ones(padded, np.float32)
        weights[n:] = 0.0
        idx = np.arange(padded) % n

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        acc = loss = torch.zeros((), device=self.device)
        for b in range(padded // bs):
            lo = b * bs + self.rank * local
            sel = idx[lo:lo + local]
            c, l = self.eval_step(put(images[sel]), put(labels[sel]),
                                  put(weights[lo:lo + local]))
            acc, loss = acc + c, loss + l
        return float(acc) / n, float(loss) / n

    def train(self) -> dict:
        cfg = self.config
        start = self._restore_or_init()
        last_eval = None
        for epoch in range(start, cfg.epochs):
            rec = self._train_epoch(epoch)
            self.history.append(rec)
            self.ckpt.save(epoch, self.state,
                           steps_per_epoch=self.steps_per_epoch)
            last_eval = None
            if cfg.eval_every and (epoch + 1) % cfg.eval_every == 0:
                last_eval = self.evaluate()
                rec["test_accuracy"], rec["test_loss"] = last_eval
                self.log(f"Epoch {epoch} eval: accuracy {last_eval[0]:.4f} "
                         f"loss {last_eval[1]:.4f}")
        final_acc, final_loss = last_eval or self.evaluate()
        self.log(f"Final test accuracy {final_acc:.4f} (loss {final_loss:.4f})")
        self.summary = {
            "epochs_run": len(self.history),
            "final_accuracy": final_acc,
            "final_loss": final_loss,
            "history": self.history,
        }
        return self.summary


def run_cnn(config: TrainConfig, ctx: dist.DistContext | None = None) -> CNNTrainer:
    """One rank of ``--model simple_cnn``: the process group (world 1
    unless ``ctx`` is given), training, teardown; rank 0 prints
    ``final_accuracy=`` last."""
    if ctx is None:
        ctx = dist.setup(backend=config.backend, device=config.device)
    try:
        trainer = CNNTrainer(config, ctx)
        summary = trainer.train()
    finally:
        dist.cleanup()
    if ctx.is_main:
        print(f"final_accuracy={summary['final_accuracy']:.4f}", flush=True)
    return trainer


def _spawned_worker(rank: int, world: int, argv: list, port: int) -> None:
    """Per-rank body under ``--spawn`` (``train.py:40-47``)."""
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    config = TrainConfig.from_args(argv)
    if config.device == "cpu":  # ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    run_cnn(config, dist.setup(rank, world, backend=config.backend,
                               device=config.device))


def spawn(config: TrainConfig, argv: list) -> None:
    """``--spawn N``: N local ranks through ``torch.multiprocessing``."""
    n = config.spawn
    if resolve_device(config.device).type == "cuda":
        cards = torch.cuda.device_count()
        if (config.backend or "nccl") == "nccl" and n > cards:
            raise ValueError(
                f"--spawn {n} on {cards} card(s): nccl puts one rank on each "
                "card; use fewer ranks, or --backend gloo to share cards"
            )
    import torch.multiprocessing as mp

    mp.spawn(_spawned_worker, args=(n, list(argv), dist.free_port()),
             nprocs=n, join=True)


def main(argv=None):
    """``python -m ddp_tpu_torch.train [flags]`` → the trained trainer
    (None under ``--spawn``, whose ranks run in their own processes)."""
    args = sys.argv[1:] if argv is None else list(argv)
    config = TrainConfig.from_args(args)
    if config.model == "causal_lm":
        if config.spawn > 1:
            raise ValueError("--model causal_lm trains on one card: no --spawn")
        trainer = LMTrainer(config)
        summary = trainer.train()
        if summary["final_accuracy"] is not None:
            print(f"final_accuracy={summary['final_accuracy']:.4f}", flush=True)
        return trainer
    if config.spawn > 1:
        spawn(config, args)
        return None
    return run_cnn(config)
