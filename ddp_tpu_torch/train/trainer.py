"""The trainers behind ``python -m ddp_tpu_torch.train``.

:class:`ImageTrainer` is the port's counterpart of the JAX package's
``Trainer`` for the image models (``ddp_tpu/train/trainer.py:2047-3006``,
the data-parallel subset), ``train.py``'s main path: SimpleCNN, ResNet
or ViT (``models.get_model``, ``--remat`` recomputing each block in the
backward) on MNIST-family, CIFAR or ImageNet data (224², memory-mapped
arrays or the synthetic set) sharded over the ranks of
``torch.distributed`` (``data/loader`` with the native gather pool of
``--num_workers``, ``data/sampler``, ``--no_shuffle``;
the MoE ViTs add their blocks' load-balance losses to the loss),
the data-parallel step (``parallel/ddp``, one all-reduce a step,
BatchNorm's running statistics averaged in it, ``--augment`` on the
device) or the compiled-epoch runner (``--fast_epoch``), a checkpoint
with an integrity manifest every epoch, auto-resume from
``--checkpoint_dir`` with the optimizer state and the running
statistics, and an evaluation on the test split every ``eval_every``
epochs. Rank 0 prints the JAX trainer's log lines (0-based epoch tags, as
the reference's checkpoints) and ``final_accuracy=``.

:class:`SeqTrainer` runs the long-context classifier
(``--model long_context``, ``models/seq_transformer``; ``trainer.py``'s
seq mode) through the same machinery: synthetic [N, T, seq_dim] feature
sequences (``data/sequences.synthetic``) on the loader path without the
native pool, every block's attention through
``parallel/ring.sequence_sharded_attention`` (B1–B3 on the card), and one
train and eval step (``models/seq_transformer``, strided microbatches)
for every world: without mesh axes its mesh is the data-only one.

The image models shard over a mesh too (``--mesh_model``, ``--mesh_fsdp``,
``--mesh_expert``, ``--zero1``: ``config.use_spmd``): their step is
then JAX's GSPMD step (``parallel/spmd``), each rank its data replica's
rows and its shards of the state (``spmd.shard_model``), the
checkpoints the full state.

Both sequence models shard over a mesh of the world's ranks
(``runtime/mesh``, :func:`build_mesh`): ``--mesh_seq`` (the multi-rank
ring or Ulysses), ``--mesh_model`` (Megatron blocks), ``--mesh_expert``
(the LM's experts), the data axis the rest. A rank's data replica
(data × expert) takes the strided row shards, its ``seq`` rank the
column slice of them; each model holds its rank's shards
(``parallel/tp.shard_module``), the checkpoints the full state
(``train/checkpoint.CheckpointManager(layout=)``), so a run resumes at
any other mesh.

:class:`LMTrainer` trains the causal LM, dense or expert-routed
(``--moe_experts``), data-parallel (``trainer.py:812-966``, causal-LM
subset): synthetic token streams or a text file, bytes or BPE subwords
(``--vocab_size`` > 256: the tokenizer trained on the corpus, written by
rank 0 to ``tokenizer.json`` next to the checkpoints and reused from
there), fp32 master weights, the epoch runner of ``train/fast.py`` (each
rank its strided shard of the global batch ``batch_size × world ×
grad_accum_steps``, one gradient all-reduce a step), one host read per
epoch, a checkpoint every epoch from rank 0 (with the ``lm_spec.json``
sidecar that ``python -m ddp_tpu_torch.serve --checkpoint_dir`` reads)
and auto-resume with the Adam state and the step count, as the image
trainer's.

The pipelined models (``--model pipe_lm``, ``pipe_vit``; ``--mesh_pipe``
stages, ``--pipe_schedule``) run in :class:`PipeLMTrainer` and
:class:`PipeViTTrainer`, the LM and image trainers with the pipe step
(``models/pipeline_lm``, ``models/pipeline_vit``) and its evaluation on
the mesh of the world; a data replica's pipe ranks read the same rows,
and the checkpoints hold the full stacked state.

Both carry the fault-tolerance layer (:class:`_FaultTolerant`,
``trainer.py:1938-2523``): SIGTERM checkpoints the epoch in flight with
its ``mid_batch`` and a re-run re-enters it at that batch; ``--chaos``
drills; the step watchdog; the parameter EMA (``--ema_decay``) that
evaluation uses; ``--keep_best``; ``--reset_opt_state``; the
``--metrics_file`` stream; ``--elastic``'s global-batch contract;
``--profile_dir``'s Kineto trace (the autograd profiler) of the training
loop. The chaos trigger, the watchdog beat and the preemption check run on the
host between two dispatches and read nothing of the device. Checkpoints
are saved asynchronously (``train/checkpoint.py``); the preemption save
and the end of training wait until the save is durable.

:func:`main` is the CLI: ``--spawn N`` (and ``--max_restarts``, even
for one rank) runs the ranks under the supervisor of
``runtime/launch`` (nccl: one card each, never more ranks than cards;
``--backend gloo`` may share cards, and is the transport of ``--device
cpu``), which restarts a dead world and, under ``--elastic``, resizes
it; ``--coordinator_address --num_processes --process_id`` run this
process as one rank of a multi-host world.
"""

from __future__ import annotations

import contextlib
import json
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
from ddp_tpu_torch.models.seq_transformer import (
    SeqTransformerSpec,
    init_seq_transformer,
    make_seq_parallel_eval_step,
    make_seq_parallel_train_step,
)
from ddp_tpu_torch.models.seq_transformer import build_model as build_seq_model
from ddp_tpu_torch.obs.recorder import build_info
from ddp_tpu_torch.parallel.ddp import (
    TrainState,
    make_eval_step,
    make_train_step,
    ring_all_reduce_bytes,
)
from ddp_tpu_torch.interop.jax_params import jax_leaf_order
from ddp_tpu_torch.parallel import spmd
from ddp_tpu_torch.parallel.tp import shard_module
from ddp_tpu_torch.parallel.zero import (
    ZeroOptimizer,
    build_layout,
    check_zero_mesh,
    make_zero_train_step,
    opt_bytes_per_device,
    zero_comm_bytes,
)
from ddp_tpu_torch.runtime import dist, launch
from ddp_tpu_torch.runtime.mesh import dist_mesh, mesh_sizes
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
LM_MODELS = ("causal_lm", "pipe_lm")  # the models run_lm trains


TOKENIZER_FILE = "tokenizer.json"


def build_splits(config: TrainConfig, *,
                 tokenizer_path: str | None = None) -> tuple[Split, Split]:
    """(train, test) splits of a sequence model (``trainer.py:842-858``):
    a train split of ``synthetic_size`` sequences at ``seed`` and a test
    split of max(1, n // 6) at ``seed + 1`` — token streams for the causal
    LM, labelled feature sequences for long_context — or the text file's
    (the causal LM only; a BPE vocabulary at, or saved to,
    ``tokenizer_path``)."""
    token_mode = config.model in ("causal_lm", "pipe_lm")
    if config.dataset == "text":
        if not token_mode:
            raise ValueError(
                "--dataset text is causal-LM data (bytes, no class labels): "
                "use --model causal_lm or pipe_lm")
        if not config.text_file:
            raise ValueError("--dataset text needs --text_file PATH")
        return load_text_corpus(
            config.text_file, config.seq_len, vocab_size=config.vocab_size,
            tokenizer_path=tokenizer_path,
        )
    if config.dataset not in ("auto", "synthetic_seq"):
        raise ValueError(
            f"--model {config.model} trains on sequences, not "
            f"{config.dataset!r}: use --dataset synthetic_seq, --dataset "
            "text (or leave --dataset unset)"
        )
    n = config.synthetic_size or 2048

    def split(count, seed):
        if not token_mode:
            return sequences.synthetic(
                count, total_len=config.seq_len, d_in=config.seq_dim,
                num_classes=config.num_classes or 10, seed=seed)
        toks = sequences.synthetic_tokens(
            count, total_len=config.seq_len, vocab_size=config.vocab_size,
            seed=seed,
        )
        return Split(toks, np.zeros(count, np.int32))

    return split(n, config.seed), split(max(1, n // 6), config.seed + 1)


def check_ulysses_heads(num_heads: int, mesh_model: int, mesh_seq: int):
    """Ulysses re-shards each model member's local heads over ``seq``
    (``trainer.py:91``): they must divide by ``mesh_seq``."""
    local_heads = num_heads // max(1, mesh_model)
    if local_heads % max(1, mesh_seq):
        raise ValueError(
            f"ulysses shards attention heads: {local_heads} heads per model "
            f"shard ({num_heads} total / --mesh_model {mesh_model}) not "
            f"divisible by --mesh_seq {mesh_seq}"
        )


def build_mesh(config: TrainConfig, ctx: dist.DistContext | None, *,
               always: bool = False):
    """The sequence models' mesh over ``ctx``'s world (None: one rank;
    ``runtime/mesh``). A world that only shards data gets None, or with
    ``always`` its data-only mesh (one ``LocalComm`` a group at world 1)."""
    if config.mesh_axes == 1 and not always:
        return None
    world, rank = ((1, 0) if ctx is None
                   else (ctx.num_processes, ctx.process_id))
    sizes = mesh_sizes(world, seq=config.mesh_seq, model=config.mesh_model,
                       expert=config.mesh_expert, fsdp=config.mesh_fsdp,
                       pipe=config.mesh_pipe)
    return dist_mesh(sizes, rank)


def zero_optimizer(config: TrainConfig, model, comm, lr, *, mesh=None):
    """``--parallel zero``'s optimizer over ``model``'s parameters on the
    data group ``comm`` (``parallel/zero.ZeroOptimizer``), the clip in
    its step; on a ``mesh``, the leaves sharded over ``model`` marked for
    the clip's norm."""
    layout = getattr(model, "shard_layout", None)
    check_zero_mesh({} if mesh is None else mesh.shape,
                    allow_model_axes=config.model == "causal_lm")
    return ZeroOptimizer(
        model.named_parameters(), comm, name=config.optimizer, lr=lr,
        momentum=config.momentum, weight_decay=config.weight_decay,
        grad_clip_norm=config.grad_clip_norm,
        bucket_mb=config.zero_bucket_mb,
        gather_dtype=config.zero_gather_dtype,
        model_comm=None if mesh is None else mesh.comm("model"),
        model_names={n for n in (layout.specs if layout else ())
                     if "model" in layout.axes(n)})


def zero_comm_total(config: TrainConfig, full_shapes: dict, world: int, *,
                    gspmd: bool = False) -> int:
    """``zero_comm_bytes``' total of a zero run, on the layout of the
    FULL leaves in JAX's order (``trainer.py:914-925``, ``:1322-1328``:
    the LM prices JAX's in-graph expression)."""
    names = list(full_shapes)
    shapes = [tuple(full_shapes[n]) for n in names]
    layout = build_layout([shapes[i] for i in jax_leaf_order(names, shapes)],
                          world, bucket_mb=config.zero_bucket_mb)
    return zero_comm_bytes(layout, world,
                           grad_accum_steps=config.grad_accum_steps,
                           gspmd=gspmd,
                           gather_dtype=config.zero_gather_dtype)["total"]


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
    loader = None  # the image trainer's loader path
    mesh = None  # runtime/mesh.Mesh of a sequence model sharded over ranks

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
        self.state.model.load_state_dict(self.ckpt.local(params))
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
        world = {"world_size": self.world,
                 "data_shards": getattr(self, "data_world", self.world)}
        if gen["prev_world"] is not None:
            world["prev_data_shards"] = gen["prev_world"]
        self.metrics_writer.write(
            "run_start", start_epoch=start, restarts=gen["restarts"],
            global_batch_size=self.global_batch_size,
            build_info=build_info(self.device), **world)

    def _state_bytes(self) -> dict:
        """The bytes this rank holds at rest: its parameters (shards on a
        mesh) and its optimizer state (``parallel/zero.
        opt_bytes_per_device``'s count: 1/N flat shards under zero, the
        moments of the shards under FSDP)."""
        params = sum(p.numel() * p.element_size()
                     for p in self.state.model.parameters())
        return {"params": params,
                "optimizer": opt_bytes_per_device(self.optimizer)}

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
            norm = ({} if np.isnan(gnorm[i])  # the step reports none
                    else {"grad_norm": round(float(gnorm[i]), 6)})
            self.metrics_writer.write(
                "step", epoch=epoch, batch=batch, step=step,
                loss=float(value),
                lr=round(lr_at(self.lr_schedule, max(0, step - 1)), 8),
                **norm,
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
        preempted, last_eval, finished = False, None, False
        profiler = self._start_profile()
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
                    self.ckpt.wait()  # durable before the process exits
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
            finished = True
        finally:
            try:
                if profiler is not None:
                    self._stop_profile(profiler)
                if self.loader is not None:
                    self.loader.close()  # the native pool's threads
                self.watchdog.stop()
                if installed:
                    signal.signal(signal.SIGTERM, prev_handler
                                  if prev_handler is not None
                                  else signal.SIG_DFL)
            finally:
                self._settle_save(raise_error=finished)
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

    def _settle_save(self, *, raise_error: bool) -> None:
        """Wait for the save in flight, after the loop's clean-up: the
        writer's error is raised after a clean run, and only logged after
        a failed one, whose own error it must not replace."""
        try:
            self.ckpt.wait()
        except Exception as e:
            if raise_error:
                raise
            self.log(f"The checkpoint save in flight failed too: {e}")

    def _start_profile(self):
        """``--profile_dir``: a Kineto profiler over the epoch loop,
        the window JAX traces (``trainer.py:2353-2356``), on rank 0 (on
        every rank of a sharded mesh, whose ranks run different hops, and
        of a ``--parallel zero`` world) → the running profiler, or
        None."""
        cfg = self.config
        if not (cfg.profile_dir and (self.is_main or self._sharded)):
            return None
        # The autograd profiler: the same Kineto trace (CPU ops, the
        # ``train_step`` annotations, the card's kernels) without
        # ``torch.profiler.profile.start``'s ``hasattr(torch, "_inductor")``,
        # which imports the compiler stack (~6-8 s of CPU a process on an
        # NVIDIA H100 80GB HBM3 host at 700 W; every rank of a mesh run
        # paid it).
        from torch.autograd import profiler as autograd_profiler

        profiler = autograd_profiler.profile(
            use_device="cuda" if self.device.type == "cuda" else None,
            use_kineto=True)
        profiler.__enter__()
        return profiler

    @property
    def _sharded(self) -> bool:
        """Ranks that run different work or hold different state: a
        sharded mesh, ``--parallel zero`` or ``--zero1``."""
        cfg = self.config
        return cfg.mesh_axes > 1 or cfg.zero or cfg.zero1

    def _stop_profile(self, profiler) -> None:
        """Stop the trace and write it as chrome-trace JSON; a rank of a
        sharded mesh, of a ``--parallel zero`` or of a ``--zero1`` world
        writes beside it ``state_rank<r>.json``: the bytes it holds at
        rest, and its B1-B3 launches by q's shape."""
        profiler.__exit__(None, None, None)
        cfg = self.config
        os.makedirs(cfg.profile_dir, exist_ok=True)
        path = os.path.join(cfg.profile_dir, f"trace_rank{self.rank}.json")
        profiler.export_chrome_trace(path)
        if self._sharded:
            from ddp_tpu_torch.ops.flash import flash_attention

            with open(os.path.join(cfg.profile_dir,
                                   f"state_rank{self.rank}.json"), "w") as f:
                json.dump(dict(self._state_bytes(), flash_launch_shapes=
                               flash_attention.launch_shapes), f)
        self.log(f"Profile trace written to {path}")

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

    def __init__(self, config: TrainConfig,
                 ctx: dist.DistContext | None = None):
        """``ctx`` None: one rank, no process group."""
        if config.model != "causal_lm":
            raise ValueError(f"LMTrainer trains --model causal_lm, not "
                             f"{config.model!r}")
        self.config = config
        if ctx is None:
            self.rank, self.world = 0, 1
            self.device = resolve_device(config.device)
        else:
            self.rank, self.world = ctx.process_id, ctx.num_processes
            self.device = ctx.device
        self.compute_dtype = DTYPES[config.compute_dtype]
        self.mesh = build_mesh(config, ctx, always=config.zero)
        self.data_rank, self.data_world = (
            (self.mesh.data_rank, self.mesh.data_size) if self.mesh
            else (self.rank, self.world))
        self.train_split, self.test_split = self._splits()
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
        self.per_shard_batch = config.batch_size
        self.global_batch_size = (config.batch_size * self.data_world
                                  * config.grad_accum_steps)
        if config.elastic:
            self._honour_elastic_contract(self.data_world)
        layout = None
        if config.seq_strategy == "ulysses":
            check_ulysses_heads(self.spec.num_heads, config.mesh_model,
                                config.mesh_seq)
        init = init_lm_state(self.spec, seed=config.seed)
        full_shapes = {k: v.shape for k, v in init.items()}
        if self.mesh is None:
            self.model = CausalLM.from_state(self.spec, init, self.device,
                                             trainable=True)
        else:  # this rank's shards, cut on the host
            self.model = CausalLM.from_state(self.spec, init, "cpu",
                                             trainable=True)
            layout = shard_module(self.model, self.mesh)
            self.model.to(self.device)
        self.lr_schedule = config.lr
        if config.zero:
            self.optimizer = zero_optimizer(config, self.model,
                                            self.mesh.comm("data"), config.lr,
                                            mesh=self.mesh)
        else:
            self.optimizer = make_optimizer(
                self.model.parameters(), config.optimizer, lr=config.lr,
                momentum=config.momentum, weight_decay=config.weight_decay,
                grad_clip_norm=config.grad_clip_norm,
                ema_decay=config.ema_decay,
            )
        if layout is not None and not config.zero:
            self.optimizer.norm = layout.norm
        self.tokens = torch.as_tensor(self.train_split.images).to(self.device)
        self.runner = make_lm_epoch_runner(
            self.model, self.optimizer, self.tokens, self.global_batch_size,
            compute_dtype=self.compute_dtype, seed=config.seed,
            grad_accum_steps=config.grad_accum_steps,
            label_smoothing=config.label_smoothing,
            rank=self.data_rank, world=self.data_world, mesh=self.mesh,
            strategy=config.seq_strategy,
        )
        self.steps_per_epoch = self.runner.steps_per_epoch
        self.eval_step = make_lm_eval_step(
            self.model, compute_dtype=self.compute_dtype, mesh=self.mesh,
            strategy=config.seq_strategy,
        )
        self.state = TrainState(step=0, model=self.model,
                                optimizer=self.optimizer)
        self.is_main = self.rank == 0
        self.ckpt = CheckpointManager(
            config.checkpoint_dir, max_to_keep=config.max_checkpoints,
            is_main=self.is_main,
            keep_best_metric="accuracy" if config.keep_best else None,
            layout=layout,
        )
        self.history: list[dict] = []
        self._init_fault_tolerance(is_main=self.is_main)
        if config.zero:
            self._comm_bytes = zero_comm_total(
                config, full_shapes, self.mesh.shape["data"], gspmd=True)
        elif self.world > 1 and self.mesh is None:
            self._comm_bytes = ring_all_reduce_bytes(self.optimizer.params,
                                                     self.world)

    def _splits(self) -> tuple[Split, Split]:
        """The data splits; a BPE vocabulary is trained and written by
        rank 0 (or read where it exists), and the other ranks read it
        after a barrier."""
        cfg = self.config
        path = os.path.join(cfg.checkpoint_dir, TOKENIZER_FILE)
        if self.world == 1 or self.rank == 0:
            splits = build_splits(cfg, tokenizer_path=path)
        if self.world > 1:
            dist.sync_global_devices("tokenizer")
            if self.rank:
                splits = build_splits(cfg, tokenizer_path=path)
        return splits

    def log(self, msg: str) -> None:
        if self.rank == 0:
            print(msg, flush=True)

    def evaluate_raw(self) -> tuple[float, float]:
        """Test-split (accuracy, loss): padded with wraparound to a
        global batch multiple, the padding weighted 0, each rank feeding
        its contiguous slice of every batch, totals summed over the world
        and divided by the split size."""
        tokens = self.test_split.images
        local = self.per_shard_batch
        bs = local * self.data_world
        n = len(tokens)
        padded = -(-n // bs) * bs
        weights = np.ones(padded, np.float32)
        weights[n:] = 0.0
        idx = np.arange(padded) % n
        acc = loss = torch.zeros((), device=self.device)
        for b in range(padded // bs):
            lo = b * bs + self.data_rank * local
            a, l = self.eval_step(
                torch.as_tensor(tokens[idx[lo:lo + local]]).to(self.device),
                torch.as_tensor(weights[lo:lo + local]).to(self.device),
            )
            acc, loss = acc + a, loss + l
            self.watchdog.beat()
        totals = torch.stack([acc, loss])
        if self.mesh is not None:  # each replica's sums, once
            self.mesh.comm("data", "fsdp", "expert").all_reduce_(totals)
        elif self.world > 1:
            dist.all_reduce_sum(totals)
        acc, loss = totals.tolist()
        return acc / n, loss / n

    def _before_train(self) -> None:
        # The sidecar is written here, not at construction: a trainer
        # that never trains creates no checkpoint directory.
        if self.is_main:
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
        self.log(
            f"epoch {rec['epoch']}/{self.config.epochs}: train loss "
            f"{rec['train_loss']:.4f} acc {rec['train_accuracy']:.4f}{test} | "
            f"{rec['tokens_per_s']:.1f} tokens/s, step p50 "
            f"{rec['step_p50_s'] * 1e3:.2f} ms ({self.device})")

    def _log_final(self, acc, loss) -> None:
        pass


class ImageTrainer(_FaultTolerant):
    """An image model on an image split, data-parallel over the ranks of
    ``ctx`` (a ``runtime/dist`` context). ``--batch_size`` is per rank;
    the global batch is batch_size × world × grad_accum_steps (under
    ``--elastic``, the one ``elastic.json`` recorded). The dataset gives
    the classes and the input shape; ``--dataset auto`` is mnist for
    every image model, as in the JAX trainer; ``--num_classes`` overrides
    the dataset's class count (``trainer.py:762``)."""

    # The long-context model trains on a mesh at every world (a data-only
    # one without mesh axes); the image models shard data alone.
    always_mesh = False
    num_workers = None  # None: --num_workers

    def __init__(self, config: TrainConfig, ctx: dist.DistContext):
        self.config, self.ctx = config, ctx
        self.device = ctx.device
        self.rank, self.world = ctx.process_id, ctx.num_processes
        self.use_spmd = config.use_spmd
        self.mesh = build_mesh(config, ctx,
                               always=self.always_mesh or self.use_spmd)
        self.data_rank, self.data_world = (
            (self.mesh.data_rank, self.mesh.data_size) if self.mesh
            else (self.rank, self.world))
        self.train_split, self.test_split = self._splits()
        self.compute_dtype = DTYPES[config.compute_dtype]
        self.per_shard_batch = config.batch_size
        self.global_batch_size = (config.batch_size * self.data_world
                                  * config.grad_accum_steps)
        if config.elastic:
            self._honour_elastic_contract(self.data_world)
        model = self._model()
        if self.use_spmd:
            spmd.shard_model(model, self.mesh, zero1=config.zero1)
        model = model.to(self.device)
        layout = getattr(model, "shard_layout", None)
        augment_fn = get_augmentation(config.augment)
        self.lr_schedule = make_schedule(
            config.lr, warmup_steps=config.warmup_steps,
            decay_steps=config.decay_steps, lr_milestones=config.milestones,
            lr_decay_factor=config.lr_decay_factor,
        )
        if config.zero:
            self.zero_comm = dist.world_comm(ctx)
            self.optimizer = zero_optimizer(config, model, self.zero_comm,
                                            self.lr_schedule)
        else:
            self.optimizer = make_optimizer(
                model.parameters(), config.optimizer, lr=self.lr_schedule,
                momentum=config.momentum, weight_decay=config.weight_decay,
                grad_clip_norm=config.grad_clip_norm,
                ema_decay=config.ema_decay,
                zero1_layout=layout if config.zero1 else None,
            )
        if layout is not None:
            self.optimizer.norm = layout.norm
        self.state = TrainState(step=0, model=model, optimizer=self.optimizer)
        self.eval_step = self._make_eval_step()
        self.fast_runner = self.loader = None
        if config.fast_epoch:  # config: no accumulation, no GSPMD mesh
            self.fast_runner = make_epoch_runner(
                self.state,
                torch.from_numpy(self.train_split.images).to(self.device),
                torch.from_numpy(self.train_split.labels).to(self.device),
                self.global_batch_size, rank=self.data_rank,
                world=self.data_world,
                compute_dtype=self.compute_dtype, seed=config.seed,
                label_smoothing=config.label_smoothing, augment_fn=augment_fn,
                step=(self._make_train_step(augment_fn)
                      if config.pipe_mode else None),
            )
            self.steps_per_epoch = self.fast_runner.steps_per_epoch
            self.train_step = self.fast_runner.step
        else:
            self.loader = ShardedLoader(
                self.train_split.images, self.train_split.labels,
                self.global_batch_size, rank=self.data_rank,
                world=self.data_world,
                device=self.device, seed=config.seed,
                shuffle=config.shuffle,
                num_workers=(config.num_workers if self.num_workers is None
                             else self.num_workers),
            )
            self.steps_per_epoch = self.loader.steps_per_epoch()
            self.train_step = self._make_train_step(augment_fn)
        self.ckpt = CheckpointManager(
            config.checkpoint_dir, max_to_keep=config.max_checkpoints,
            is_main=ctx.is_main,
            keep_best_metric="accuracy" if config.keep_best else None,
            layout=layout,
        )
        self.history: list[dict] = []
        self._init_fault_tolerance(is_main=ctx.is_main)
        if config.zero:
            self._comm_bytes = zero_comm_total(
                config, {n: p.shape for n, p in model.named_parameters()
                         if p.requires_grad}, self.world)
        elif config.mesh_axes == 1 and not self.use_spmd:
            self._comm_bytes = ring_all_reduce_bytes(self.optimizer.params,
                                                     self.world)

    def _make_train_step(self, augment_fn):
        """The data-parallel step of ``parallel/ddp``, under ``--parallel
        zero`` the sharded update's (``parallel/zero``), or on a GSPMD
        mesh JAX's GSPMD step (``parallel/spmd``)."""
        cfg = self.config
        if self.use_spmd:
            return spmd.make_spmd_train_step(
                self.state, self.mesh, compute_dtype=self.compute_dtype,
                grad_accum_steps=cfg.grad_accum_steps,
                label_smoothing=cfg.label_smoothing, augment_fn=augment_fn,
                seed=cfg.seed)
        if cfg.zero:
            return make_zero_train_step(
                self.state, self.zero_comm,
                compute_dtype=self.compute_dtype,
                grad_accum_steps=cfg.grad_accum_steps,
                label_smoothing=cfg.label_smoothing, augment_fn=augment_fn,
                seed=cfg.seed)
        return make_train_step(
            self.state, world=self.world, compute_dtype=self.compute_dtype,
            grad_accum_steps=cfg.grad_accum_steps,
            label_smoothing=cfg.label_smoothing, augment_fn=augment_fn,
            seed=cfg.seed, rank=self.rank)

    def _make_eval_step(self):
        if self.use_spmd:
            return spmd.make_spmd_eval_step(self.state.model, self.mesh,
                                            compute_dtype=self.compute_dtype)
        return make_eval_step(self.state.model,
                              compute_dtype=self.compute_dtype)

    def _splits(self):
        """(train, test) image splits of ``--dataset`` (auto: mnist)."""
        cfg = self.config
        if cfg.model not in IMAGE_MODELS:
            raise ValueError(f"ImageTrainer trains {IMAGE_MODELS}, not "
                             f"{cfg.model!r}")
        self.dataset = "mnist" if cfg.dataset == "auto" else cfg.dataset
        if self.dataset not in IMAGE_DATASETS:
            raise ValueError(f"--model {cfg.model} trains on images, not "
                             f"{self.dataset!r}")
        return load_dataset(self.dataset, cfg.data_root,
                            allow_synthetic=cfg.synthetic_data,
                            synthetic_size=cfg.synthetic_size)

    def _model(self):
        """The registry's model with its seeded weights, on the CPU."""
        cfg = self.config
        _, side, _, channels = self.train_split.images.shape
        self.num_classes = cfg.num_classes or NUM_CLASSES[self.dataset]
        model = get_model(
            cfg.model, num_classes=self.num_classes, side=side,
            in_channels=channels,
            **({"depth": cfg.model_depth} if cfg.model_depth else {}),
            **({"remat": True} if cfg.remat else {}),
        )
        model.load_state_dict({k: torch.from_numpy(v) for k, v in
                               model.init_state(cfg.seed).items()})
        return model

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
        bs = local * self.data_world
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
            lo = b * bs + self.data_rank * local
            sel = idx[lo:lo + local]
            c, l = self.eval_step(put(images[sel]), put(labels[sel]),
                                  put(weights[lo:lo + local]))
            acc, loss = acc + c, loss + l
            self.watchdog.beat()
        return float(acc) / n, float(loss) / n


class SeqTrainer(ImageTrainer):
    """The long-context classifier (``--model long_context``) on the image
    trainer's data-parallel machinery: synthetic feature sequences from
    ``--seq_len``, ``--seq_dim`` and ``--num_classes`` (default 10), the
    loader path without the native pool (float sequences; JAX's
    ``num_workers=0``), the model of ``models/seq_transformer`` with
    ``--seq_strategy``'s attention on the mesh of the world (data-only
    without mesh axes) and its one train and eval step, strided
    microbatches included."""

    always_mesh = True
    num_workers = 0

    def _splits(self):
        cfg = self.config
        if cfg.model != "long_context":
            raise ValueError(f"SeqTrainer trains --model long_context, not "
                             f"{cfg.model!r}")
        self.dataset = ("synthetic_seq" if cfg.dataset == "auto"
                        else cfg.dataset)
        return build_splits(cfg)

    def _model(self):
        cfg = self.config
        self.num_classes = cfg.num_classes or 10
        self.spec = SeqTransformerSpec(
            num_classes=self.num_classes, total_len=cfg.seq_len,
            d_in=cfg.seq_dim, d_model=cfg.model_dim or 64,
            depth=cfg.model_depth or 2, num_heads=cfg.num_heads,
            strategy=cfg.seq_strategy, remat=cfg.remat)
        if cfg.seq_strategy == "ulysses":
            check_ulysses_heads(self.spec.num_heads, cfg.mesh_model,
                                cfg.mesh_seq)
        return build_seq_model(self.spec,
                               init_seq_transformer(self.spec, seed=cfg.seed),
                               "cpu", mesh=self.mesh)

    def _make_train_step(self, augment_fn):
        cfg = self.config
        return make_seq_parallel_train_step(
            self.state, self.mesh, compute_dtype=self.compute_dtype,
            grad_accum_steps=cfg.grad_accum_steps,
            label_smoothing=cfg.label_smoothing)

    def _make_eval_step(self):
        return make_seq_parallel_eval_step(self.state.model, self.mesh,
                                           compute_dtype=self.compute_dtype)


def _log_bubble(log, config: TrainConfig, family: str) -> None:
    """The pipeline's start-up line with its bubble fraction, as JAX logs
    it (``trainer.py:1077-1092``, ``:1170-1197``)."""
    from ddp_tpu_torch.parallel.interleaved import schedule_interleaved
    from ddp_tpu_torch.parallel.pipeline import bubble_fraction

    S, M, V = (config.mesh_pipe, config.num_microbatches,
               config.virtual_stages)
    depth = config.model_depth or 1
    if family == "pipe_lm":
        if config.moe_experts:
            log(f"Pipelined MoE: {config.moe_experts} experts every "
                f"{config.moe_every}-th block; the GShard load-balance aux "
                "loss is not collected on the pipe path (routing + capacity "
                "dropping still apply) — use --model causal_lm for the full "
                "aux objective")
        log(f"Pipeline LM: {S} stages × {V} virtual × {depth} blocks, {M} "
            f"microbatches, {config.pipe_schedule} schedule, "
            f"tp={config.mesh_model}, bubble fraction "
            f"{bubble_fraction(S, M * V):.3f}")
    elif config.pipe_schedule == "interleaved":
        log(f"Pipeline: {S} stages × {V} virtual × {depth} blocks, {M} "
            "microbatches, interleaved schedule, bubble fraction "
            f"{schedule_interleaved(S, M, V).bubble_fraction():.3f} (plain "
            f"1F1B: {bubble_fraction(S, M):.3f})")
    else:
        log(f"Pipeline: {S} stages × {depth} blocks, {M} microbatches, "
            f"{config.pipe_schedule} schedule, bubble fraction "
            f"{bubble_fraction(S, M):.3f}")


class PipeLMTrainer(LMTrainer):
    """``--model pipe_lm`` (``trainer.py:1008-1136``): the causal LM cut
    into ``--mesh_pipe`` stages of ``--model_depth`` blocks a chunk
    (``models/pipeline_lm``) over the mesh of the world — composed with
    ``--mesh_fsdp``, ``--mesh_model``, ``--moe_experts`` (and
    ``--mesh_expert``) and ``--mesh_seq`` —, the data axis the rest; the
    LM trainer's data, epoch runner (each data replica, data × fsdp ×
    expert, its strided rows; its pipe, model and seq ranks the same
    ones), evaluation and fault tolerance, with the LR schedules; the
    checkpoints hold the full stacked state, gathered from every axis
    (its ``to_dense_lm`` is the servable ``CausalLM``), so a checkpoint
    written on one mesh restores on another."""

    def __init__(self, config: TrainConfig,
                 ctx: dist.DistContext | None = None):
        from ddp_tpu_torch.models.pipeline_lm import (
            PipeLMConfig,
            build_pipe_lm,
            init_pipe_lm,
            make_pipe_lm_eval_step,
            make_pipe_lm_train_step,
        )
        from ddp_tpu_torch.models.pipeline_vit import rank_chunks

        if config.model != "pipe_lm":
            raise ValueError(f"PipeLMTrainer trains --model pipe_lm, not "
                             f"{config.model!r}")
        self.config = config
        if ctx is None:
            self.rank, self.world = 0, 1
            self.device = resolve_device(config.device)
        else:
            self.rank, self.world = ctx.process_id, ctx.num_processes
            self.device = ctx.device
        self.compute_dtype = DTYPES[config.compute_dtype]
        self.mesh = build_mesh(config, ctx, always=True)
        self.data_rank, self.data_world = (self.mesh.data_rank,
                                           self.mesh.data_size)
        self.train_split, self.test_split = self._splits()
        interleaved = config.pipe_schedule == "interleaved"
        self.pipe_cfg = PipeLMConfig(
            vocab_size=config.vocab_size, seq_len=config.seq_len,
            d_model=config.model_dim or 64, num_heads=config.num_heads,
            num_stages=config.mesh_pipe,
            depth_per_stage=config.model_depth or 1,
            num_microbatches=config.num_microbatches, remat=config.remat,
            virtual_stages=config.virtual_stages,
            label_smoothing=config.label_smoothing,
            num_kv_heads=config.num_kv_heads, tp_size=config.mesh_model,
            num_experts=config.moe_experts, moe_every=config.moe_every,
            moe_top_k=config.moe_top_k,
            moe_normalize_gates=not config.moe_raw_gates,
            ep_size=config.mesh_expert, sp_size=config.mesh_seq,
            sp_strategy=config.seq_strategy)
        self.per_shard_batch = config.batch_size
        self.global_batch_size = config.batch_size * self.data_world
        config.check_pipe_batch(self.global_batch_size, self.data_world)
        _log_bubble(self.log, config, "pipe_lm")
        only = rank_chunks(self.pipe_cfg, self.mesh, interleaved=interleaved)
        self.model = build_pipe_lm(
            self.pipe_cfg, init_pipe_lm(self.pipe_cfg, seed=config.seed,
                                        interleaved=interleaved, only=only),
            self.mesh, self.device, interleaved=interleaved)
        layout = self.model.shard_layout
        self.lr_schedule = make_schedule(
            config.lr, warmup_steps=config.warmup_steps,
            decay_steps=config.decay_steps, lr_milestones=config.milestones,
            lr_decay_factor=config.lr_decay_factor,
        )
        self.optimizer = make_optimizer(
            self.model.parameters(), config.optimizer, lr=self.lr_schedule,
            momentum=config.momentum, weight_decay=config.weight_decay,
            grad_clip_norm=config.grad_clip_norm, ema_decay=config.ema_decay,
        )
        self.optimizer.norm = layout.norm
        self.tokens = torch.as_tensor(self.train_split.images).to(self.device)
        self.runner = make_lm_epoch_runner(
            self.model, self.optimizer, self.tokens, self.global_batch_size,
            seed=config.seed, rank=self.data_rank, world=self.data_world,
            step=make_pipe_lm_train_step(
                self.model, self.optimizer, self.mesh,
                schedule=config.pipe_schedule,
                compute_dtype=self.compute_dtype))
        self.steps_per_epoch = self.runner.steps_per_epoch
        self.eval_step = make_pipe_lm_eval_step(
            self.model, self.mesh, compute_dtype=self.compute_dtype)
        self.state = TrainState(step=0, model=self.model,
                                optimizer=self.optimizer)
        self.is_main = self.rank == 0
        self.ckpt = CheckpointManager(
            config.checkpoint_dir, max_to_keep=config.max_checkpoints,
            is_main=self.is_main,
            keep_best_metric="accuracy" if config.keep_best else None,
            layout=layout,
        )
        self.history: list[dict] = []
        self._init_fault_tolerance(is_main=self.is_main)

    def _before_train(self) -> None:
        pass  # no lm_spec.json: the stacked state is not a CausalLM's


class PipeViTTrainer(ImageTrainer):
    """``--model pipe_vit`` (``trainer.py:1137-1274``): the ViT cut into
    ``--mesh_pipe`` stages (``models/pipeline_vit``: patch ``7`` on 28²
    images, else 4; no class token), composed with ``--mesh_fsdp`` and
    ``--mesh_model``, on the image trainer's loader path or, under
    ``--fast_epoch``, its epoch runner driving the pipe step, each data
    replica (data × fsdp) its rows (its pipe and model ranks the same
    ones), ``--augment`` on stage 0, evaluation through the pipelined
    forward, checkpoints of the full stacked state."""

    always_mesh = True

    def _splits(self):
        cfg = self.config
        self.dataset = "mnist" if cfg.dataset == "auto" else cfg.dataset
        if self.dataset not in IMAGE_DATASETS:
            raise ValueError(f"--model {cfg.model} trains on images, not "
                             f"{self.dataset!r}")
        return load_dataset(self.dataset, cfg.data_root,
                            allow_synthetic=cfg.synthetic_data,
                            synthetic_size=cfg.synthetic_size)

    def _model(self):
        from ddp_tpu_torch.models.pipeline_vit import (
            PipeViTConfig,
            build_pipe_vit,
            init_pipe_vit,
            rank_chunks,
        )

        cfg = self.config
        _, side, _, channels = self.train_split.images.shape
        self.num_classes = cfg.num_classes or NUM_CLASSES[self.dataset]
        cfg.check_pipe_batch(self.global_batch_size, self.data_world)
        self.pipe_cfg = PipeViTConfig(
            num_classes=self.num_classes,
            patch_size=7 if side % 7 == 0 else 4,
            embed_dim=cfg.model_dim or 64, num_heads=cfg.num_heads,
            num_stages=cfg.mesh_pipe, depth_per_stage=cfg.model_depth or 1,
            num_microbatches=cfg.num_microbatches, remat=cfg.remat,
            virtual_stages=cfg.virtual_stages, side=side,
            in_channels=channels, tp_size=cfg.mesh_model)
        _log_bubble(self.log, cfg, "pipe_vit")
        interleaved = cfg.pipe_schedule == "interleaved"
        only = rank_chunks(self.pipe_cfg, self.mesh, interleaved=interleaved)
        return build_pipe_vit(
            self.pipe_cfg, init_pipe_vit(self.pipe_cfg, seed=cfg.seed,
                                         interleaved=interleaved, only=only),
            self.mesh, "cpu", interleaved=interleaved)

    def _make_train_step(self, augment_fn):
        from ddp_tpu_torch.models.pipeline_vit import make_pipe_vit_train_step

        cfg, state = self.config, self.state
        inner = make_pipe_vit_train_step(
            state.model, self.optimizer, self.mesh,
            schedule=cfg.pipe_schedule, compute_dtype=self.compute_dtype,
            label_smoothing=cfg.label_smoothing, augment_fn=augment_fn,
            seed=cfg.seed, step_counter=lambda: int(state.step))

        def step(images, labels):
            metrics = inner(images, labels)
            state.step += 1
            return metrics

        return step

    def _make_eval_step(self):
        from ddp_tpu_torch.models.pipeline_vit import make_pipe_vit_eval_step

        return make_pipe_vit_eval_step(self.state.model, self.mesh,
                                       compute_dtype=self.compute_dtype)


def run_image(config: TrainConfig,
              ctx: dist.DistContext | None = None) -> ImageTrainer:
    """One rank of an image model or the long-context classifier: the
    process group (world 1 unless ``ctx`` is given), training, teardown;
    rank 0 prints ``final_accuracy=`` last (``preempted`` when SIGTERM
    stopped it)."""
    if ctx is None:
        ctx = dist.setup(backend=config.backend, device=config.device)
    try:
        cls = {"long_context": SeqTrainer, "pipe_vit": PipeViTTrainer}.get(
            config.model, ImageTrainer)
        trainer = cls(config, ctx)
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


def run_lm(config: TrainConfig,
           ctx: dist.DistContext | None = None) -> LMTrainer:
    """The causal LM (or the pipelined one): one rank without a process
    group, or this rank of ``ctx``'s world (torn down after)."""
    try:
        cls = PipeLMTrainer if config.model == "pipe_lm" else LMTrainer
        trainer = cls(config, ctx)
        summary = trainer.train()
    finally:
        if ctx is not None:
            dist.cleanup()
    if trainer.is_main:
        _print_outcome(summary)
    return trainer


def _spawned_worker(rank: int, world: int, argv: list) -> None:
    """Per-rank body under the supervisor (``train.py:39-46``): the
    rendezvous is in the environment (``runtime/launch``), the world is
    the generation's (an elastic relaunch may differ from --spawn)."""
    config = TrainConfig.from_args(argv)
    # The ranks share the host's cores, on the CPU and beside a card (the
    # gloo exchanges and their host copies run on them).
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    ctx = dist.setup(rank, world, backend=config.backend,
                     device=config.device)
    if config.model in LM_MODELS:
        run_lm(config, ctx)
        return
    run_image(config, ctx)


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
    if config.spawn > 1 or config.max_restarts:
        spawn(config, args)
        return None
    run = run_lm if config.model in LM_MODELS else run_image
    world = config.multi_host()
    if world is not None:
        address, num_processes, process_id = world
        return run(config, dist.setup(
            process_id, num_processes, backend=config.backend,
            device=config.device, coordinator_address=address))
    return run(config)
