"""The trainers behind ``python -m ddp_tpu_torch.train``.

:class:`ImageTrainer` is the port's counterpart of the JAX package's
``Trainer`` for the image models (``ddp_tpu/train/trainer.py:2047-3006``,
the data-parallel subset), ``train.py``'s main path: SimpleCNN, ResNet
or ViT (``models.get_model``) on MNIST-family or CIFAR data sharded over
the ranks of ``torch.distributed`` (``data/loader``, ``data/sampler``;
the MoE ViTs add their blocks' load-balance losses to the loss),
the data-parallel step (``parallel/ddp``, one all-reduce a step,
BatchNorm's running statistics averaged in it, ``--augment`` on the
device) or the compiled-epoch runner (``--fast_epoch``), a checkpoint
with an integrity manifest every epoch, auto-resume from
``--checkpoint_dir`` with the optimizer state and the running
statistics, and an evaluation on the test split every ``eval_every``
epochs. Rank 0 prints the JAX trainer's log lines (0-based epoch tags, as
the reference's checkpoints) and ``final_accuracy=``.

:class:`LMTrainer` trains the causal LM, dense or expert-routed
(``--moe_experts``), on one card
(``trainer.py:812-966``, causal-LM subset): synthetic token streams or a
byte-level text file, fp32 master weights, the epoch runner of
``train/fast.py``, one host read per epoch, a checkpoint every epoch
(with the ``lm_spec.json`` sidecar that ``python -m ddp_tpu_torch.serve
--checkpoint_dir`` reads) and auto-resume with the Adam state and the
step count, as the image trainer's. It runs one rank (ROADMAP A2.4).

Both carry the fault-tolerance layer (:class:`_FaultTolerant`,
``trainer.py:1938-2523``): SIGTERM checkpoints the epoch in flight with
its ``mid_batch`` and a re-run re-enters it at that batch; ``--chaos``
drills; the step watchdog; the parameter EMA (``--ema_decay``) that
evaluation uses; ``--keep_best``; ``--reset_opt_state``; the
``--metrics_file`` stream; ``--elastic``'s global-batch contract. The
chaos trigger, the watchdog beat and the preemption check run on the
host between two dispatches and read nothing of the device.

:func:`main` is the CLI: ``--spawn N`` (and ``--max_restarts``, even
for one rank) runs the ranks under the supervisor of
``runtime/launch`` (nccl: one card each, never more ranks than cards;
``--backend gloo`` may share cards, and is the transport of ``--device
cpu``), which restarts a dead world and, under ``--elastic``, resizes
it.
"""

from __future__ import annotations

import contextlib
import logging
import os
import signal
import sys
import threading
import time

import numpy as np
import torch

from ddp_tpu_torch.data import sequences
from ddp_tpu_torch.data.augment import get_augmentation
from ddp_tpu_torch.data.loader import ShardedLoader
from ddp_tpu_torch.data.registry import NUM_CLASSES, load_dataset
from ddp_tpu_torch.data.sampler import rescale_per_shard_batch
from ddp_tpu_torch.data.text import Split, load_text_corpus
from ddp_tpu_torch.device import resolve_device
from ddp_tpu_torch.models import get_model
from ddp_tpu_torch.models.lm import (
    CausalLM,
    LMSpec,
    init_lm_state,
    make_lm_eval_step,
)
from ddp_tpu_torch.obs.recorder import build_info
from ddp_tpu_torch.parallel.ddp import TrainState, make_eval_step, make_train_step
from ddp_tpu_torch.runtime import dist, launch
from ddp_tpu_torch.runtime.chaos import ChaosEngine
from ddp_tpu_torch.runtime.consensus import agree_any
from ddp_tpu_torch.train.checkpoint import (
    CheckpointManager,
    load_elastic_contract,
    record_generation,
    save_elastic_contract,
    save_lm_spec,
)
from ddp_tpu_torch.train.config import IMAGE_DATASETS, IMAGE_MODELS, TrainConfig
from ddp_tpu_torch.train.fast import (
    make_epoch_runner,
    make_lm_epoch_runner,
    run_steps,
    step_seconds,
)
from ddp_tpu_torch.train.optim import (
    ema_params,
    lr_at,
    make_optimizer,
    make_schedule,
    param_ema,
)
from ddp_tpu_torch.utils.metrics import MetricsWriter
from ddp_tpu_torch.utils.watchdog import StepWatchdog

logger = logging.getLogger("ddp_tpu_torch")

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


def restore_or_init(ckpt: CheckpointManager, state: TrainState,
                    config: TrainConfig, log) -> int:
    """The start epoch: ``--resume_epoch`` (its later epochs deleted),
    else the latest intact checkpoint + 1, else 0; ``log`` prints rank
    0's lines."""
    if config.resume_epoch is not None:
        epoch = ckpt.restore(state, config.resume_epoch)
        stale = ckpt.delete_after(epoch)
        if stale:
            log(f"Rewind to epoch {epoch}: deleted the abandoned "
                f"branch's checkpoints {stale}")
        log(f"Resumed from requested epoch {epoch}")
        return epoch + 1
    start = ckpt.restore_or_init(state)  # logs any quarantine
    if start:
        log(f"Resumed from checkpoint epoch {start - 1}")
    else:
        log("No checkpoint found — starting from scratch")
    return start


class _FaultTolerant:
    """What both trainers share (``trainer.py:1938-2523``): the SIGTERM
    handler, the chaos engine, the step watchdog, the metrics stream, the
    parameter EMA in evaluation, the restore with ``--reset_opt_state``
    and the EMA graft, and the epoch loop with its mid-epoch preemption
    save, ``keep_best`` ranking and the records of ``--metrics_file``.

    A subclass sets ``config``, ``rank``, ``world``, ``device``,
    ``state``, ``optimizer``, ``lr_schedule``, ``ckpt``,
    ``global_batch_size``, ``per_shard_batch``, ``steps_per_epoch``,
    ``history`` and calls :meth:`_init_fault_tolerance`; it provides
    ``log``, ``evaluate_raw``, ``_before_train``, ``_step_count``,
    ``_run_epoch``, ``_epoch_record``, ``_epoch_done`` and ``_log_final``.
    """

    lm_mode = False

    def _init_fault_tolerance(self, is_main: bool) -> None:
        cfg = self.config
        self.is_main = is_main
        # Each rank arms its share of the plan; the per-rank ledger next
        # to the checkpoints makes every event fire once across restarts.
        self.chaos = ChaosEngine(
            cfg.chaos, rank=self.rank, seed=cfg.seed,
            ledger_path=os.path.join(cfg.checkpoint_dir,
                                     f"chaos_ledger.rank{self.rank}.json"),
        )
        cfg.check_robustness(has_step_events=self.chaos.has_step_events())
        if cfg.deterministic:
            torch.backends.cudnn.deterministic = True
            torch.backends.cudnn.benchmark = False
        self.watchdog = StepWatchdog(cfg.watchdog_timeout)
        self.metrics_writer = MetricsWriter(cfg.metrics_file, enabled=is_main)
        self._preempt_requested = False
        self._raw_eval_count = 0
        self._comm_bytes = None  # the per-step all-reduce payload, if any

    # ---- elastic: the recorded global batch -------------------------------

    def _honour_elastic_contract(self, shards: int) -> None:
        """``trainer.py:655-668``: at a resized world, rescale the
        per-rank batch so the recorded global batch — what a step means
        — survives."""
        cfg = self.config
        recorded = int(load_elastic_contract(cfg.checkpoint_dir)
                       .get("global_batch_size") or 0)
        if recorded and recorded != self.global_batch_size:
            per = rescale_per_shard_batch(
                recorded, shards, grad_accum_steps=cfg.grad_accum_steps)
            self.log(f"Elastic resize: preserving recorded global batch "
                     f"{recorded} over {shards} data shard(s) — per-shard "
                     f"batch {self.per_shard_batch} -> {per}")
            self.per_shard_batch, self.global_batch_size = per, recorded

    # ---- preemption -------------------------------------------------------

    def _install_preemption_handler(self):
        """SIGTERM → finish the step in flight, checkpoint, exit clean
        (``trainer.py:1938-1967``): the handler only sets a flag, read
        between steps. Returns (installed, the previous handler), which
        :meth:`train` puts back; a no-op off the main thread."""
        if threading.current_thread() is not threading.main_thread():
            return False, None

        def _on_term(signum, frame):
            logger.warning("SIGTERM received — will checkpoint at the next "
                           "step boundary and exit")
            self._preempt_requested = True

        try:
            return True, signal.signal(signal.SIGTERM, _on_term)
        except ValueError:  # not the main interpreter
            return False, None

    def _agree_preempt(self) -> bool:
        """The world's agreement on the preemption flag (``_sync_flags``,
        preempt only): a collective, reached by every rank at the same
        deterministic point."""
        pre = agree_any(self._preempt_requested, num_processes=self.world)
        self._preempt_requested = self._preempt_requested or pre
        return pre

    def _between_steps(self, step0: int, skip: int):
        """The host-only work between two dispatches of an epoch, for
        ``run_steps(between=)``: the watchdog beat and the preemption
        check after each step, then the chaos trigger of the next global
        step (``trainer.py:2603-2671``). No device read: one agreement
        at the log cadence when the world is larger than one (a
        collective, as JAX's)."""
        chaos, wd, world = self.chaos, self.watchdog, self.world
        log_every = self.config.log_interval

        def between(k: int) -> bool:
            if k:
                wd.beat()
                if world == 1:
                    if self._preempt_requested:
                        return True
                elif (skip + k - 1) % log_every == 0 and self._agree_preempt():
                    return True
            chaos.on_step(step0 + k)
            # A SIGTERM the trigger just sent stops the epoch before this
            # dispatch; the epoch's first step always runs, so a
            # preempted epoch holds at least one step.
            return bool(k) and world == 1 and self._preempt_requested

        return between

    # ---- evaluation on the EMA --------------------------------------------

    @contextlib.contextmanager
    def _ema_weights(self):
        """The parameters hold the EMA inside the block, and their own
        values again after it (copies, bit for bit)."""
        ema = ema_params(self.optimizer)
        params = self.optimizer.params
        with torch.no_grad():
            raw = [p.detach().clone() for p in params]
            torch._foreach_copy_(params, ema)
        try:
            yield
        finally:
            with torch.no_grad():
                torch._foreach_copy_(params, raw)

    def evaluate(self, *, use_ema: bool | None = None) -> tuple[float, float]:
        """Test-split (accuracy, loss) (``trainer.py:2925-2966``): with
        ``--ema_decay`` on the averaged parameters, the raw weights'
        figures logged beside them for the first two evaluations (early
        on the EMA lags and would read as a regression)."""
        if use_ema is None:
            use_ema = bool(self.config.ema_decay)
        if not use_ema:
            return self.evaluate_raw()
        if ema_params(self.optimizer) is None:
            logger.warning("evaluate(use_ema=True) but no EMA state exists "
                           "(--ema_decay off?) — evaluating RAW weights")
            return self.evaluate_raw()
        if self._raw_eval_count < 2:
            self._raw_eval_count += 1
            raw_acc, raw_loss = self.evaluate_raw()
            self.log(f"Eval with raw (non-EMA) weights: accuracy "
                     f"{raw_acc:.4f} loss {raw_loss:.4f}")
        with self._ema_weights():
            return self.evaluate_raw()

    # ---- restore ----------------------------------------------------------

    def _restore(self) -> int:
        """The start epoch (``trainer.py:2036-2190``): ``--reset_opt_state``
        restores the weights alone and starts the optimizer fresh; an
        EMA switched on since the checkpoint is grafted from the
        restored parameters; any other optimizer mismatch fails with the
        flags named."""
        cfg = self.config
        if cfg.reset_opt_state:
            return self._restore_weights_only()
        try:
            return restore_or_init(self.ckpt, self.state, cfg, self.log)
        except ValueError as e:
            opt = self.optimizer
            if cfg.ema_decay:
                # Restore the EMA-less layout, then graft a fresh EMA.
                ema, opt.ema_state = opt.ema_state, None
                try:
                    start = restore_or_init(self.ckpt, self.state, cfg,
                                            self.log)
                except ValueError:
                    start = None
                finally:
                    opt.ema_state = ema
                if start is not None:
                    self.log("Checkpoint has no EMA (written without "
                             "--ema_decay) — initializing the EMA from the "
                             "restored params")
                    opt.ema_state = param_ema(opt.params, cfg.ema_decay)
                    return start
            raise RuntimeError(
                "Checkpoint optimizer state does not match the current "
                "optimizer config — changed --optimizer / --momentum / "
                "--ema_decay / --grad_clip_norm or a schedule flag "
                "(--warmup_steps / --decay_steps / --lr_milestones; "
                "schedules add a step-count state) since it was "
                "written? Re-run with --reset_opt_state to keep the "
                "weights and start the optimizer fresh, or point "
                "--checkpoint_dir elsewhere."
            ) from e

    def _restore_weights_only(self) -> int:
        cfg = self.config
        try:
            params, epoch = self.ckpt.restore_for_inference(cfg.resume_epoch)
        except FileNotFoundError:
            return 0
        if cfg.resume_epoch is not None:
            stale = self.ckpt.delete_after(epoch)
            if stale:
                self.log(f"Rewind to epoch {epoch}: deleted the abandoned "
                         f"branch's checkpoints {stale}")
        mid = int(self.ckpt.read_partial(epoch, ("mid_batch",))
                  .get("mid_batch", 0))
        if mid > 0:
            logger.warning(
                "--reset_opt_state restored a mid-epoch artifact (epoch %d "
                "stopped at batch %d); its remaining batches are skipped and "
                "training continues at epoch %d", epoch, mid, epoch + 1)
        self.state.model.load_state_dict(params)
        self.optimizer.reset()  # count, moments; the EMA from these weights
        self.log(f"Restored epoch {epoch} weights with a FRESH optimizer "
                 "state (--reset_opt_state)")
        return epoch + 1

    def _mid_epoch_entry(self, start: int) -> tuple[int, int]:
        """(start epoch, start batch): a preemption save re-enters its
        epoch at its ``mid_batch`` when it was written under the same
        steps per epoch (``trainer.py:2316-2345``); --fast_epoch resumes
        at epoch granularity."""
        mid = self.ckpt.last_restored_mid_batch
        if self.config.fast_epoch or not mid:
            return start, 0
        spe = self.steps_per_epoch
        if self.ckpt.last_restored_spe == spe and 0 < mid < spe:
            self.log(f"Resuming mid-epoch: epoch {start - 1}, batch {mid} "
                     f"(step {int(self.state.step)})")
            return start - 1, mid
        logger.warning(
            "Checkpoint was preempted at batch %d under %s steps/epoch; "
            "current config has %d — resuming at epoch granularity",
            mid, self.ckpt.last_restored_spe, spe)
        return start, 0

    # ---- the records of --metrics_file --------------------------------------

    def _write_start_records(self, start: int) -> None:
        """The ``fallback`` records of the epochs discovery quarantined,
        then the generation's one ``run_start`` (``trainer.py:2218-2307``)."""
        if not self.is_main:
            return
        resumed = start - 1 if start > 0 else None
        for q in self.ckpt.quarantined:
            self.metrics_writer.write(
                "fallback", epoch=q["epoch"], resumed_epoch=resumed,
                quarantined_path=q["path"], problems=q["problems"][:8])
        gen = record_generation(self.config.checkpoint_dir, self.world)
        world = {"world_size": self.world, "data_shards": self.world}
        if gen["prev_world"] is not None:
            world["prev_data_shards"] = gen["prev_world"]
        self.metrics_writer.write(
            "run_start", start_epoch=start, restarts=gen["restarts"],
            global_batch_size=self.global_batch_size,
            build_info=build_info(self.device), **world)

    def _write_step_records(self, epoch, skip, step0, loss, gnorm) -> list:
        """The ``step`` records of an epoch's log cadence, written after
        its one host read (so they add no sync) → the logged losses."""
        cfg, logged = self.config, []
        for i, value in enumerate(loss):
            batch = skip + i
            if batch % cfg.log_interval:
                continue
            logged.append(float(value))
            step = step0 + i + 1
            self.metrics_writer.write(
                "step", epoch=epoch, batch=batch, step=step,
                loss=float(value),
                lr=round(lr_at(self.lr_schedule, max(0, step - 1)), 8),
                grad_norm=round(float(gnorm[i]), 6),
                **({} if self._comm_bytes is None
                   else {"comm_bytes": self._comm_bytes}))
        return logged

    def _write_epoch_record(self, epoch, n, seconds, logged) -> None:
        rate = n * self.global_batch_size / seconds if seconds else 0.0
        extra = {}
        if self.lm_mode:
            extra["tokens_per_sec"] = round(rate * self.config.seq_len, 1)
        if self._comm_bytes is not None:
            extra["comm_bytes"] = self._comm_bytes
        self.metrics_writer.write(
            "epoch", epoch=epoch, batches=n, seconds=round(seconds, 3),
            images_per_sec=round(rate, 1),
            mean_loss=float(np.mean(logged)) if logged else float("nan"),
            **extra)

    # ---- the epoch loop ---------------------------------------------------

    def train(self) -> dict:
        cfg = self.config
        self._before_train()
        if cfg.elastic and self.is_main:
            save_elastic_contract(cfg.checkpoint_dir,
                                  global_batch_size=self.global_batch_size,
                                  world_size=self.world)
        # Process-start chaos (ckpt_corrupt) fires before discovery, so
        # the quarantine fallback is what it drills.
        self.chaos.on_start(cfg.checkpoint_dir)
        start, start_batch = self._mid_epoch_entry(self._restore())
        self._write_start_records(start + (1 if start_batch else 0))
        spe = self.steps_per_epoch
        self.watchdog.start()
        self._preempt_requested = False
        installed, prev_handler = self._install_preemption_handler()
        preempted, last_eval = False, None
        try:
            for epoch in range(start, cfg.epochs):
                skip = start_batch if epoch == start else 0
                self.chaos.on_epoch(epoch)
                rec, ran = self._train_epoch(epoch, skip)
                # Agreement at the boundary: a SIGTERM after the last
                # in-loop check must stop every rank on the same side.
                pre = (self._agree_preempt() if self.world > 1
                       else self._preempt_requested)
                if pre:
                    # The incomplete epoch's state, no metrics (a
                    # metric-less save is never pruned by keep_best);
                    # ran == spe: the epoch completed → mid_batch 0.
                    self.ckpt.save(epoch, self.state, overwrite=True,
                                   steps_per_epoch=spe,
                                   mid_batch=ran if 0 < ran < spe else 0)
                    self.log(f"Preempted during epoch {epoch} at step "
                             f"{int(self.state.step)} — checkpointed; "
                             "re-run to resume")
                    preempted = True
                    break
                self.history.append(rec)
                do_eval = bool(cfg.eval_every
                               and (epoch + 1) % cfg.eval_every == 0)
                # keep_best needs the metric at save time; otherwise save
                # first, so a failing eval cannot lose the epoch.
                if cfg.keep_best and do_eval:
                    last_eval = self.evaluate()
                    metrics = {"accuracy": last_eval[0]}
                else:
                    last_eval, metrics = None, None
                saved = self.ckpt.save(epoch, self.state, steps_per_epoch=spe,
                                       metrics=metrics)
                if not saved and epoch == cfg.epochs - 1:
                    # The last epoch supersedes its own preemption artifact.
                    self.ckpt.save(epoch, self.state, overwrite=True,
                                   steps_per_epoch=spe, metrics=metrics)
                if do_eval and last_eval is None:
                    last_eval = self.evaluate()
                self.watchdog.beat()
                self._epoch_done(rec, last_eval)
            if preempted:
                final_acc = final_loss = None
            else:
                final_acc, final_loss = last_eval or self.evaluate()
        finally:
            self.watchdog.stop()
            if installed:
                signal.signal(signal.SIGTERM, prev_handler
                              if prev_handler is not None else signal.SIG_DFL)
        self.summary = {
            "epochs_run": len(self.history),
            "final_accuracy": final_acc,
            "final_loss": final_loss,
            "history": self.history,
        }
        if preempted:
            self.summary["preempted"] = True
        else:
            self._log_final(final_acc, final_loss)
            perplexity = {}
            if (self.lm_mode and np.isfinite(final_loss)
                    and np.isfinite(np.exp(final_loss))):
                perplexity["perplexity"] = round(float(np.exp(final_loss)), 4)
            self.metrics_writer.write(
                "final", accuracy=final_acc, loss=final_loss,
                epochs_run=len(self.history), **perplexity)
        self.metrics_writer.close()
        return self.summary

    def _train_epoch(self, epoch: int, skip: int) -> tuple[dict, int]:
        """One epoch from batch ``skip`` → (its history record, the
        batches of the epoch run so far, ``skip`` included)."""
        step0 = self._step_count()
        between = None if self.config.fast_epoch else \
            self._between_steps(step0, skip)
        t0 = time.perf_counter()
        metrics = self._run_epoch(epoch, skip, between)
        # The epoch's one host read.
        loss, acc, gnorm = (m.float().cpu().numpy() for m in metrics[:3])
        seconds = time.perf_counter() - t0
        self.watchdog.beat()
        logged = self._write_step_records(epoch, skip, step0, loss, gnorm)
        self._write_epoch_record(epoch, len(loss), seconds, logged)
        return self._epoch_record(epoch, skip, loss, acc, gnorm,
                                  seconds), skip + len(loss)


class LMTrainer(_FaultTolerant):
    lm_mode = True

    def __init__(self, config: TrainConfig):
        if config.model != "causal_lm":
            raise ValueError(f"LMTrainer trains --model causal_lm, not "
                             f"{config.model!r}")
        self.config = config
        self.rank, self.world = 0, 1
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
            num_experts=config.moe_experts,
            moe_every=config.moe_every,
            moe_top_k=config.moe_top_k,
            moe_normalize_gates=not config.moe_raw_gates,
        )
        self.per_shard_batch = self.global_batch_size = config.batch_size
        if config.elastic:
            self._honour_elastic_contract(1)
        self.model = CausalLM.from_state(
            self.spec, init_lm_state(self.spec, seed=config.seed),
            self.device, trainable=True,
        )
        self.lr_schedule = config.lr
        self.optimizer = make_optimizer(
            self.model.parameters(), config.optimizer, lr=config.lr,
            momentum=config.momentum, weight_decay=config.weight_decay,
            grad_clip_norm=config.grad_clip_norm, ema_decay=config.ema_decay,
        )
        self.tokens = torch.as_tensor(self.train_split.images).to(self.device)
        self.runner = make_lm_epoch_runner(
            self.model, self.optimizer, self.tokens, self.global_batch_size,
            compute_dtype=self.compute_dtype, seed=config.seed,
            grad_accum_steps=config.grad_accum_steps,
            label_smoothing=config.label_smoothing,
        )
        self.steps_per_epoch = self.runner.steps_per_epoch
        self.eval_step = make_lm_eval_step(
            self.model, compute_dtype=self.compute_dtype
        )
        self.state = TrainState(step=0, model=self.model,
                                optimizer=self.optimizer)
        self.ckpt = CheckpointManager(
            config.checkpoint_dir, max_to_keep=config.max_checkpoints,
            keep_best_metric="accuracy" if config.keep_best else None,
        )
        self.history: list[dict] = []
        self._init_fault_tolerance(is_main=True)

    def log(self, msg: str) -> None:
        print(msg, flush=True)

    def evaluate_raw(self) -> tuple[float, float]:
        """Test-split (accuracy, loss): padded with wraparound to a batch
        multiple, padding weighted 0, totals divided by the split size."""
        tokens = self.test_split.images
        bs = self.per_shard_batch
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
            self.watchdog.beat()
        return float(acc) / n, float(loss) / n

    def _before_train(self) -> None:
        # The sidecar is written here, not at construction: a trainer
        # that never trains creates no checkpoint directory.
        save_lm_spec(self.config.checkpoint_dir, self.spec)

    def _step_count(self) -> int:
        return self.optimizer.count

    def _run_epoch(self, epoch, skip, between):
        metrics = self.runner(epoch, skip, between)
        self.state.step = self.optimizer.count
        return metrics

    def _epoch_record(self, epoch, skip, loss, acc, gnorm, wall) -> dict:
        step_s = self.runner.step_seconds()
        tokens_per_step = self.global_batch_size * self.config.seq_len
        return {
            "epoch": epoch + 1,
            "loss": loss.tolist(),
            "accuracy": acc.tolist(),
            "grad_norm": gnorm.tolist(),
            "train_loss": float(loss.mean()),
            "train_accuracy": float(acc.mean()),
            "epoch_seconds": wall,
            "tokens_per_s": len(loss) * tokens_per_step / wall,
            "step_seconds": step_s,
            "step_p50_s": float(np.median(step_s)),
        }

    def _epoch_done(self, rec: dict, last_eval) -> None:
        test = ""
        if last_eval is not None:
            rec["test_accuracy"], rec["test_loss"] = last_eval
            test = f" | test loss {last_eval[1]:.4f} acc {last_eval[0]:.4f}"
        print(
            f"epoch {rec['epoch']}/{self.config.epochs}: train loss "
            f"{rec['train_loss']:.4f} acc {rec['train_accuracy']:.4f}{test} | "
            f"{rec['tokens_per_s']:.1f} tokens/s, step p50 "
            f"{rec['step_p50_s'] * 1e3:.2f} ms ({self.device})",
            flush=True,
        )

    def _log_final(self, acc, loss) -> None:
        pass


class ImageTrainer(_FaultTolerant):
    """An image model on an image split, data-parallel over the ranks of
    ``ctx`` (a ``runtime/dist`` context). ``--batch_size`` is per rank;
    the global batch is batch_size × world × grad_accum_steps (under
    ``--elastic``, the one ``elastic.json`` recorded). The dataset gives
    the classes and the input shape; ``--dataset auto`` is mnist for
    every image model, as in the JAX trainer."""

    def __init__(self, config: TrainConfig, ctx: dist.DistContext):
        if config.model not in IMAGE_MODELS:
            raise ValueError(f"ImageTrainer trains {IMAGE_MODELS}, not "
                             f"{config.model!r}")
        self.config, self.ctx = config, ctx
        self.device = ctx.device
        self.rank, self.world = ctx.process_id, ctx.num_processes
        self.dataset = "mnist" if config.dataset == "auto" else config.dataset
        if self.dataset not in IMAGE_DATASETS:
            raise ValueError(f"--model {config.model} trains on images, not "
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
        if config.elastic:
            self._honour_elastic_contract(self.world)
        _, side, _, channels = self.train_split.images.shape
        model = get_model(
            config.model, num_classes=NUM_CLASSES[self.dataset], side=side,
            in_channels=channels,
            **({"depth": config.model_depth} if config.model_depth else {}),
        )
        model.load_state_dict({k: torch.from_numpy(v) for k, v in
                               model.init_state(config.seed).items()})
        model = model.to(self.device)
        augment_fn = get_augmentation(config.augment)
        self.lr_schedule = make_schedule(
            config.lr, warmup_steps=config.warmup_steps,
            decay_steps=config.decay_steps, lr_milestones=config.milestones,
            lr_decay_factor=config.lr_decay_factor,
        )
        self.optimizer = make_optimizer(
            model.parameters(), config.optimizer, lr=self.lr_schedule,
            momentum=config.momentum, weight_decay=config.weight_decay,
            grad_clip_norm=config.grad_clip_norm, ema_decay=config.ema_decay,
        )
        self.state = TrainState(step=0, model=model, optimizer=self.optimizer)
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
                label_smoothing=config.label_smoothing, augment_fn=augment_fn,
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
                augment_fn=augment_fn, seed=config.seed, rank=self.rank,
            )
        self.ckpt = CheckpointManager(
            config.checkpoint_dir, max_to_keep=config.max_checkpoints,
            is_main=ctx.is_main,
            keep_best_metric="accuracy" if config.keep_best else None,
        )
        self.history: list[dict] = []
        self._init_fault_tolerance(is_main=ctx.is_main)
        # The full fp32 gradient ring all-reduce a step, 2·(N−1)/N of its
        # bytes (``parallel/zero.py:981``'s analytic payload).
        n = sum(p.numel() for p in self.optimizer.params)
        self._comm_bytes = int(2 * (self.world - 1) / self.world * n * 4)

    def log(self, msg: str) -> None:
        if self.ctx.is_main:
            print(msg, flush=True)

    def _before_train(self) -> None:
        pass

    def _step_count(self) -> int:
        return int(self.state.step)

    def _run_epoch(self, epoch, skip, between):
        self.log(f"Starting epoch {epoch}"
                 + (" (compiled fast path)" if self.fast_runner else ""))
        if self.fast_runner is not None:
            metrics = self.fast_runner(epoch)
            self._marks = self.fast_runner.marks
            return metrics
        metrics, self._marks = run_steps(
            self.train_step, self.loader.epoch(epoch, skip),
            on_gpu=self.device.type == "cuda", between=between)
        return metrics

    def _epoch_record(self, epoch, skip, loss, acc, gnorm, seconds) -> dict:
        step_s = step_seconds(self._marks)
        n = len(loss)
        for i in range(n):
            if (skip + i) % self.config.log_interval == 0:
                self.log(f"Epoch {epoch} Batch {skip + i} Loss {loss[i]:.4f}")
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

    def _epoch_done(self, rec: dict, last_eval) -> None:
        if last_eval is not None:
            rec["test_accuracy"], rec["test_loss"] = last_eval
            self.log(f"Epoch {rec['epoch']} eval: accuracy {last_eval[0]:.4f} "
                     f"loss {last_eval[1]:.4f}")

    def _log_final(self, acc, loss) -> None:
        self.log(f"Final test accuracy {acc:.4f} (loss {loss:.4f})")

    def evaluate_raw(self) -> tuple[float, float]:
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
            self.watchdog.beat()
        return float(acc) / n, float(loss) / n


def run_image(config: TrainConfig,
              ctx: dist.DistContext | None = None) -> ImageTrainer:
    """One rank of an image model: the process group (world 1 unless
    ``ctx`` is given), training, teardown; rank 0 prints
    ``final_accuracy=`` last (``preempted`` when SIGTERM stopped it)."""
    if ctx is None:
        ctx = dist.setup(backend=config.backend, device=config.device)
    try:
        trainer = ImageTrainer(config, ctx)
        summary = trainer.train()
    finally:
        dist.cleanup()
    if ctx.is_main:
        _print_outcome(summary)
    return trainer


def _print_outcome(summary: dict) -> None:
    if summary.get("preempted"):
        print("preempted: re-run the same command to resume", flush=True)
    else:
        print(f"final_accuracy={summary['final_accuracy']:.4f}", flush=True)


def run_lm(config: TrainConfig) -> LMTrainer:
    trainer = LMTrainer(config)
    _print_outcome(trainer.train())
    return trainer


def _spawned_worker(rank: int, world: int, argv: list) -> None:
    """Per-rank body under the supervisor (``train.py:39-46``): the
    rendezvous is in the environment (``runtime/launch``), the world is
    the generation's (an elastic relaunch may differ from --spawn)."""
    config = TrainConfig.from_args(argv)
    if config.device == "cpu":  # ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    if config.model == "causal_lm":
        run_lm(config)
        return
    run_image(config, dist.setup(rank, world, backend=config.backend,
                                 device=config.device))


def spawn(config: TrainConfig, argv: list) -> int:
    """``--spawn N`` (or ``--max_restarts``): N local ranks under the
    supervisor of ``runtime/launch`` → the restarts it consumed."""
    n = config.spawn
    if resolve_device(config.device).type == "cuda":
        cards = torch.cuda.device_count()
        if (config.backend or "nccl") == "nccl" and n > cards:
            raise ValueError(
                f"--spawn {n} on {cards} card(s): nccl puts one rank on each "
                "card; use fewer ranks, or --backend gloo to share cards"
            )
    return launch.spawn(
        _spawned_worker, n, (list(argv),),
        timeout=None,  # a training run may legitimately take hours
        max_restarts=config.max_restarts,
        restart_backoff=config.restart_backoff,
        elastic=config.elastic, min_world=config.min_world,
    )


def main(argv=None):
    """``python -m ddp_tpu_torch.train [flags]`` → the trained trainer
    (None when ranks run under the supervisor, in their own
    processes)."""
    args = sys.argv[1:] if argv is None else list(argv)
    config = TrainConfig.from_args(args)
    if config.model == "causal_lm" and config.spawn > 1:
        raise ValueError("--model causal_lm trains on one card: no --spawn")
    if config.spawn > 1 or config.max_restarts:
        spawn(config, args)
        return None
    if config.model == "causal_lm":
        return run_lm(config)
    return run_image(config)
