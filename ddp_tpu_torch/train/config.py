"""Flags of ``python -m ddp_tpu_torch.train`` (the image-model,
long-context and causal-LM subset of ``ddp_tpu/train/config.py``, under
the JAX names and defaults), with the JAX trainer's guards on them. The
sequence models shard over the mesh axes ``--mesh_fsdp``, ``--mesh_seq``,
``--mesh_model`` and ``--mesh_expert`` (``runtime/mesh``), the world
being their product times the data axis. ``--parallel zero``
(``parallel/zero``: ``--zero_bucket_mb``, ``--zero_gather_dtype``)
shards the weight update over the data axis of the image models and of
the causal LM (with ``--mesh_model``/``--mesh_seq`` too). The image
models' ``--mesh_fsdp``, ``--mesh_model``, ``--mesh_expert`` (in any
combination) and ``--zero1`` (on a pure data mesh) ride JAX's GSPMD step
(``parallel/spmd``; :attr:`TrainConfig.use_spmd`). The pipelined models,
``--model pipe_lm`` and ``pipe_vit``, cut over ``--mesh_pipe`` stages
under ``--pipe_schedule`` (``parallel/pipeline``), compose with
``--mesh_fsdp`` and ``--mesh_model``, and the LM with ``--moe_experts``,
``--mesh_expert`` and ``--mesh_seq``, as JAX's do; the data axis is the
rest of the world."""

from __future__ import annotations

import argparse
import dataclasses

from ddp_tpu_torch.models import IMAGE_MODELS

SEQ_MODELS = ("long_context", "causal_lm")
PIPE_MODELS = ("pipe_lm", "pipe_vit")
MODELS = IMAGE_MODELS + SEQ_MODELS + PIPE_MODELS
IMAGE_DATASETS = ("mnist", "fashion_mnist", "kmnist", "uci_digits",
                  "cifar10", "cifar100", "imagenet")
SEQ_DATASETS = ("synthetic_seq", "text")


@dataclasses.dataclass
class TrainConfig:
    model: str = "simple_cnn"
    # "auto": mnist for the image models, synthetic_seq for the sequence
    # models.
    dataset: str = "auto"
    data_root: str = "./data"
    synthetic_data: bool = False  # image models: the offline synthetic split
    text_file: str | None = None
    # Image models: the synthetic train split (None → the dataset's size;
    # test n // 6, CIFAR n // 5). causal_lm: sequences (None → 2048).
    synthetic_size: int | None = None
    no_shuffle: bool = False  # the sampler's order is the index order
    # The native C++ gather pool (``native/dataio.cpp``) of the loader
    # path, gated as JAX's: batches of at least 1 MiB and a spare core.
    num_workers: int = 2
    num_classes: int | None = None  # None: the dataset's (long_context: 10)
    seq_len: int = 2048
    seq_dim: int = 16  # long_context: input feature channels per token
    seq_strategy: str = "ring"  # the sequence models' attention: ring | ulysses
    # The sequence models' mesh (``runtime/mesh``): tokens sharded over
    # --mesh_seq ranks, Megatron tensor parallelism over --mesh_model,
    # MoE experts over --mesh_expert (a data axis too), parameters and
    # moments over --mesh_fsdp (a data axis too); the data axis is the
    # rest of the world.
    mesh_seq: int = 1
    mesh_model: int = 1
    mesh_expert: int = 1
    mesh_fsdp: int = 1
    # The weight-update strategy (``parallel/zero``): "zero" reduce-
    # scatters the gradients in --zero_bucket_mb buckets, updates 1/N
    # shards and all-gathers the parameters in --zero_gather_dtype (bf16
    # over fp32 master shards). --zero1: the image models' GSPMD step with
    # the optimizer state sharded over the data axis (parallel/spmd).
    parallel: str = "auto"  # auto | zero
    zero_bucket_mb: float = 4.0
    zero_gather_dtype: str = "fp32"  # fp32 | bf16
    zero1: bool = False
    # The pipelined models (``parallel/pipeline``): --mesh_pipe stages
    # (one a rank), --pipe_schedule gpipe | 1f1b | interleaved (with
    # --virtual_stages chunks a rank), --num_microbatches strided
    # microbatches a step; --model_depth is each chunk's depth.
    mesh_pipe: int = 1
    pipe_schedule: str = "gpipe"
    virtual_stages: int = 1
    num_microbatches: int = 4
    vocab_size: int = 256
    model_dim: int | None = None  # None → 64
    model_depth: int | None = None  # None → 2 (causal_lm), the model's own
    num_heads: int = 4
    num_kv_heads: int = 0  # 0 → MHA
    # causal_lm and pipe_lm: route every --moe_every-th block's MLP to
    # this many experts (0 = dense), top --moe_top_k each, gates
    # renormalised unless --moe_raw_gates (``ddp_tpu/train/config.py:
    # 103-116``). The image family has its own models: vit_moe_tiny,
    # vit_moe_micro.
    moe_experts: int = 0
    moe_every: int = 2
    moe_top_k: int = 2
    moe_raw_gates: bool = False
    # Recompute each residual/encoder block in the backward instead of
    # keeping its activations (resnet*, vit*, vit_moe*, long_context).
    remat: bool = False
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
    # Evaluation, logging, the fast path (not long_context), the ranks.
    eval_every: int = 1  # epochs between test-split evals (0 = only final)
    log_interval: int = 100
    fast_epoch: bool = False  # dataset on the device, one host read an epoch
    spawn: int = 1  # >1: N local ranks through torch.multiprocessing
    backend: str | None = None  # None: nccl on CUDA, gloo on the CPU
    device: str | None = None  # None → the GPU; "cpu" only when asked
    # A torch.profiler trace (CPU and CUDA activities, chrome-trace JSON)
    # of the training loop, from rank 0.
    profile_dir: str | None = None
    # Multi-host: one process a card, each started by hand with the
    # rendezvous host:port, the world and its rank (``config.py:513-515``).
    coordinator_address: str | None = None
    num_processes: int | None = None
    process_id: int | None = None
    # Fault tolerance (``ddp_tpu/train/config.py:67-270``, ROADMAP A1).
    # >0: an EMA of the parameters in the optimizer state, used by eval.
    ema_decay: float = 0.0
    # Restore only the weights; the optimizer (count, moments, EMA)
    # starts fresh: the escape hatch for a changed recipe.
    reset_opt_state: bool = False
    # Keep the --max_checkpoints best-accuracy epochs plus the latest
    # (needs --eval_every 1 and --max_checkpoints).
    keep_best: bool = False
    metrics_file: str | None = None  # JSONL records from rank 0
    # Abort (exit 124) when no step completes for this many seconds.
    watchdog_timeout: float = 0.0
    # Deterministic fault drills (runtime/chaos.py), e.g.
    # "kill:rank1@step20,stall:input@step5:2.5s,ckpt_corrupt:latest".
    chaos: str | None = None
    # The supervisor's restart loop (runtime/launch.py): a dead rank
    # reaps the world, which is relaunched and resumes. The port runs it
    # for a world of one too (--spawn 1).
    max_restarts: int = 0
    restart_backoff: float = 1.0  # seconds, doubled each restart (<= 30)
    # Elastic resize: a rank exiting SHRINK relaunches the world one
    # smaller (down to --min_world), GROW one larger; the per-rank batch
    # is rescaled to keep elastic.json's global batch.
    elastic: bool = False
    min_world: int = 1
    # cuDNN's deterministic algorithms (process-wide): a rerun or a
    # resume reproduces the run bit for bit. The card's default picks
    # faster, nondeterministic ones for some conv backward passes.
    deterministic: bool = False

    @classmethod
    def parser(cls) -> argparse.ArgumentParser:
        p = argparse.ArgumentParser(
            prog="python -m ddp_tpu_torch.train",
            description="Train an image model (SimpleCNN, ResNet, ViT), "
            "the long-context classifier, the causal LM or a pipelined "
            "model (the PyTorch/CUDA port of train.py).",
        )
        choices = {
            "optimizer": ("sgd", "adam", "adamw"),
            "compute_dtype": ("float32", "bfloat16"),
            "dataset": ("auto",) + IMAGE_DATASETS + SEQ_DATASETS,
            "backend": ("nccl", "gloo"),
            "augment": ("none", "crop_flip", "flip", "shift"),
            "seq_strategy": ("ring", "ulysses"),
            "parallel": ("auto", "zero"),
            "zero_gather_dtype": ("fp32", "bf16"),
            "pipe_schedule": ("gpipe", "1f1b", "interleaved"),
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
        if config.elastic and config.model.startswith("pipe_"):
            # ``trainer.py:627-642``'s guard, before the port's own.
            raise ValueError(
                "--elastic excludes the in-graph pipeline family: stage "
                "params rest per-device, so a resize would need stage "
                "re-placement, not a reshard. For an elastic pipeline use "
                "the MPMD runtime (python -m ddp_tpu.parallel.mpmd) — one "
                "process per stage, per-stage restart and checkpoint-sliced "
                "resume — or drop --elastic"
            )
        if config.model not in MODELS:
            raise ValueError(
                f"--model {config.model!r} is not ported: the port trains "
                f"{', '.join(MODELS)}")
        # JAX's guards (``ddp_tpu/train/trainer.py:251-291``, ``:585-599``,
        # ``:691-695``).
        if config.moe_experts and config.model not in ("causal_lm",
                                                       "pipe_lm"):
            raise ValueError(
                "--moe_experts routes the causal LM's MLPs: use "
                "--model causal_lm or pipe_lm (images have "
                "--model vit_moe_tiny)"
            )
        if config.moe_experts and config.moe_every < 1:
            raise ValueError(
                f"--moe_every must be >= 1, got {config.moe_every}")
        if (config.moe_experts and config.model == "pipe_lm"
                and (config.model_depth or 1) % config.moe_every):
            raise ValueError(
                "the pipelined MoE-LM needs --moe_every "
                f"({config.moe_every}) to divide --model_depth "
                f"({config.model_depth or 1}): stages must be "
                "structure-uniform for parameter stacking (the flat "
                "--model causal_lm expresses any pattern)"
            )
        if config.mesh_seq > 1 and config.model not in SEQ_MODELS + (
                "pipe_lm",):
            raise ValueError(
                "--mesh_seq shards tokens, which only the sequence models "
                "have: use --model long_context, causal_lm, or pipe_lm "
                "(PP×SP)"
            )
        config._check_pipe()
        if config.mesh_seq < 1:
            raise ValueError(f"--mesh_seq must be >= 1, got {config.mesh_seq}")
        if config.seq_len % config.mesh_seq:
            raise ValueError(f"--seq_len {config.seq_len} not divisible by "
                             f"--mesh_seq {config.mesh_seq}")
        config._check_zero()
        config._check_mesh()
        if config.model in SEQ_MODELS and (
                config.zero1 or config.augment != "none"
                or (config.fast_epoch and config.model != "causal_lm")):
            # ``trainer.py:585-599``.
            raise ValueError(
                f"--model {config.model} composes with data/seq/fsdp/"
                "model/expert mesh axes, accumulation, label smoothing "
                "and bf16 — but not zero1 (use --mesh_fsdp), augment"
                + ("" if config.model == "causal_lm"
                   else ", or --fast_epoch (causal_lm only)")
            )
        if config.remat and config.model == "causal_lm":
            raise ValueError(
                "--remat is ported for the image models (resnet*, vit*, "
                "vit_moe*); the causal LM trains without it")
        if config.remat and config.model == "simple_cnn":
            # ``trainer.py:768-771``'s message.
            raise ValueError(
                f"--remat is not supported by model {config.model!r} "
                "(no block stack to rematerialize)"
            )
        if config.fast_epoch and config.no_shuffle:
            raise ValueError(
                "--fast_epoch always reshuffles per epoch (on-device "
                "permutation); drop --no_shuffle"
            )
        if config.num_workers < 0:
            raise ValueError(
                f"--num_workers must be >= 0, got {config.num_workers}")
        if config.multi_host() is not None:
            if config.spawn > 1 or config.max_restarts:
                raise ValueError(
                    "--coordinator_address/--num_processes/--process_id "
                    "start one rank of a world by hand; --spawn and "
                    "--max_restarts start the ranks themselves"
                )
        # The supervisor's guards (``train.py:79-96``).
        if config.min_world != cls.min_world and not config.elastic:
            raise ValueError(
                "--min_world bounds --elastic's scale-down; add --elastic "
                "(or drop --min_world)"
            )
        if config.elastic and not 1 <= config.min_world <= config.spawn:
            raise ValueError(
                f"--min_world {config.min_world} must be in "
                f"[1, --spawn {config.spawn}]"
            )
        return config

    @property
    def mesh_axes(self) -> int:
        """The product of the axes other than ``data``."""
        return (self.mesh_seq * self.mesh_model * self.mesh_expert
                * self.mesh_fsdp * self.mesh_pipe)

    @property
    def pipe_mode(self) -> bool:
        return self.model in PIPE_MODELS

    def _check_pipe(self) -> None:
        """The pipe family's guards, with JAX's messages
        (``trainer.py:293-402``)."""
        pipe, lm = self.pipe_mode, self.model == "pipe_lm"
        if self.mesh_pipe > 1 and not pipe:
            raise ValueError(
                "--mesh_pipe cuts a model into stages, which only the "
                "pipeline family has: use --model pipe_vit or pipe_lm")
        if pipe and self.mesh_pipe < 2:
            raise ValueError(
                f"--model {self.model} needs --mesh_pipe >= 2 (a "
                "1-stage pipeline is the plain step — drop the flag)")
        if pipe and ((self.mesh_expert > 1 and not lm)
                     or (self.mesh_seq > 1 and not lm)
                     or self.zero1 or self.grad_accum_steps > 1
                     or (lm and self.augment not in (None, "none"))):
            raise ValueError(
                f"--model {self.model} composes with the data axis, "
                "fsdp (ZeRO-sharded stage params), tp (--mesh_model, "
                "PP×TP)"
                + (", expert (--mesh_expert, PP×EP), seq "
                   "(--mesh_seq, PP×SP — ulysses under 1f1b/"
                   "interleaved, ring under gpipe)"
                   if lm else ", augment")
                + ", --fast_epoch, bf16, remat, label smoothing, EMA "
                "and LR schedules — not "
                + ("" if lm else "expert/seq/")
                + "zero1, accumulation (use --num_microbatches)"
                + (", or augment" if lm else ""))
        if pipe and self.mesh_model > 1:
            self._check_tp_dims()
        if pipe and (self.num_heads < 1
                     or (self.model_dim or 64) % self.num_heads):
            raise ValueError(
                f"--num_heads {self.num_heads} must be >= 1 and "
                f"divide --model_dim {self.model_dim or 64}")
        if self.num_kv_heads and self.model == "pipe_vit":
            raise ValueError(
                "--num_kv_heads (grouped-query attention) shrinks "
                "the causal LM's generation KV cache: use --model "
                "causal_lm or pipe_lm (or drop the flag)")
        if lm and self.num_kv_heads and (
                self.num_kv_heads < 1
                or self.num_heads % self.num_kv_heads):
            raise ValueError(
                f"--num_kv_heads {self.num_kv_heads} must be >= 1 "
                f"and divide --num_heads {self.num_heads}")
        if lm and self.num_kv_heads and self.mesh_model > 1 \
                and self.num_kv_heads % self.mesh_model:
            raise ValueError(
                "GQA under TP shards whole kv groups: "
                f"--num_kv_heads {self.num_kv_heads} not "
                f"divisible by --mesh_model {self.mesh_model}")
        if pipe and self.num_microbatches < 1:
            raise ValueError(
                f"--num_microbatches must be >= 1, got "
                f"{self.num_microbatches}")
        if self.virtual_stages < 1:
            raise ValueError(
                f"--virtual_stages must be >= 1, got {self.virtual_stages}")
        if self.virtual_stages > 1 and not pipe:
            raise ValueError(
                "--virtual_stages cuts a pipelined model into chunks: "
                "use --model pipe_vit or pipe_lm (with --mesh_pipe "
                "and --pipe_schedule interleaved)")
        if self.virtual_stages > 1 and self.pipe_schedule != "interleaved":
            raise ValueError(
                "--virtual_stages places multiple model chunks per "
                "device, which only the interleaved schedule streams: "
                "add --pipe_schedule interleaved")
        if pipe and self.num_microbatches % self.mesh_pipe:
            raise ValueError(
                f"--num_microbatches {self.num_microbatches} must be "
                f"a multiple of --mesh_pipe {self.mesh_pipe} (the "
                "sharded stream rests microbatch m on device m mod S)")
        if lm:
            self._check_pipe_lm()

    def _check_pipe_lm(self) -> None:
        """The pipelined LM's compositions (``trainer.py:600-609``,
        ``:1022-1045``, and ``pipeline_lm.py:187-194``'s TP×MoE rule),
        with JAX's messages."""
        if self.mesh_expert > 1:
            if not self.moe_experts:
                raise ValueError(
                    "--mesh_expert shards MoE expert weights: give the "
                    "LM experts with --moe_experts N (or drop the axis)")
            if self.moe_experts % self.mesh_expert:
                raise ValueError(
                    f"--moe_experts {self.moe_experts} not divisible "
                    f"by --mesh_expert {self.mesh_expert}")
        hand = self.pipe_schedule != "gpipe"
        if self.moe_experts and self.mesh_model > 1 and hand:
            from ddp_tpu_torch.models.pipeline_lm import TP_MOE_HAND_SCHEDULED

            raise ValueError(TP_MOE_HAND_SCHEDULED)
        if self.mesh_seq > 1 and not self.seq_len % self.mesh_seq:
            if hand and self.seq_strategy == "ring":
                raise ValueError(
                    "PP×SP under the hand-scheduled schedules "
                    "(1f1b/interleaved) needs --seq_strategy "
                    "ulysses: ring's ppermute hops have no replica "
                    "groups and the schedules' fwd/bwd branches "
                    "diverge across pipe stages "
                    "(models/pipeline_lm.py has the full story); "
                    "ring works under --pipe_schedule gpipe")
            if self.seq_strategy == "ulysses":
                from ddp_tpu_torch.train.trainer import check_ulysses_heads

                check_ulysses_heads(self.num_heads, self.mesh_model,
                                    self.mesh_seq)

    def _check_tp_dims(self) -> None:
        """``_check_tp_dims`` (``trainer.py:104-123``): the heads and the
        4 × d MLP hidden dim split over ``model``."""
        d_model = self.model_dim or 64
        if self.num_heads % self.mesh_model:
            raise ValueError(
                f"tensor parallelism splits attention heads: "
                f"--num_heads {self.num_heads} not divisible by "
                f"--mesh_model {self.mesh_model}")
        if (d_model * 4) % self.mesh_model:
            raise ValueError(
                f"tensor parallelism splits the MLP hidden dim: "
                f"{d_model * 4} (4 × --model_dim) not divisible "
                f"by --mesh_model {self.mesh_model}")

    def check_pipe_batch(self, global_batch_size: int,
                         data_shards: int) -> None:
        """Microbatch divisibility guards of both pipe families
        (``trainer.py:1653-1669``)."""
        M = self.num_microbatches
        if global_batch_size % M:
            raise ValueError(
                f"global batch {global_batch_size} (batch_size "
                f"× data shards) not divisible by "
                f"--num_microbatches {M}")
        mb_size = global_batch_size // M
        if mb_size % data_shards:
            raise ValueError(
                f"microbatch size {mb_size} (global batch "
                f"{global_batch_size} / {M} "
                f"microbatches) not divisible by {data_shards} "
                "data shards — each microbatch shards over the data "
                "axis")

    @property
    def zero(self) -> bool:
        return self.parallel == "zero"

    @property
    def use_spmd(self) -> bool:
        """An image model on JAX's GSPMD step (``trainer.py:404-411``): any
        non-data axis above one, or ``--zero1``."""
        return self.model not in SEQ_MODELS + PIPE_MODELS and (
            self.mesh_model > 1 or self.mesh_fsdp > 1
            or self.mesh_expert > 1 or self.zero1)

    def _check_zero(self) -> None:
        """``--parallel zero``'s guards (``trainer.py:497-530``), before
        the mesh's, with JAX's messages."""
        if not self.zero:
            return
        if self.zero1 or self.mesh_fsdp > 1 or self.mesh_expert > 1:
            raise ValueError(
                "--parallel zero shards the update over the data "
                "axis; fsdp/expert meshes (and --zero1) already "
                "shard optimizer state their own way — fsdp IS "
                "ZeRO-3 — drop the axes/flag or --parallel"
            )
        if (self.mesh_model > 1 or self.mesh_seq > 1) \
                and self.model != "causal_lm":
            raise ValueError(
                "--parallel zero composes with model/seq axes on "
                "--model causal_lm only (the GSPMD expression "
                "shards buckets over data and replicates them over "
                "the model axes); this model keeps the data axis "
                "only"
            )
        if self.mesh_pipe > 1:
            raise ValueError(
                "--parallel zero composes with the data axis only "
                "(the sharded update scatters over it); drop "
                "--mesh_pipe or --parallel"
            )
        if self.model == "long_context" or self.pipe_mode:
            raise ValueError(
                f"--parallel zero covers the DDP image family and "
                f"--model causal_lm; {self.model!r} keeps its "
                "own update path"
            )
        if self.fast_epoch:
            raise ValueError(
                "--fast_epoch scans the plain DDP step; the zero "
                "strategy has its own hot loop — drop one"
            )
        from ddp_tpu_torch.parallel.zero import _resolve_gather_dtype
        from ddp_tpu_torch.train.optim import check_zero_compatible

        check_zero_compatible(self.optimizer,
                              grad_clip_norm=self.grad_clip_norm,
                              ema_decay=self.ema_decay)
        if self.zero_bucket_mb <= 0:
            raise ValueError(
                f"--zero_bucket_mb must be > 0, got {self.zero_bucket_mb}")
        _resolve_gather_dtype(self.zero_gather_dtype)

    def world_size(self) -> int:
        """The ranks this command runs: --spawn, the multi-host world, or
        one."""
        if self.spawn > 1:
            return self.spawn
        return self.num_processes or 1

    def _check_mesh(self) -> None:
        """The mesh guards (``ddp_tpu/train/trainer.py:91-122``,
        ``:349-375``, ``:600-621``) and the world's tiling."""
        for flag in ("mesh_model", "mesh_expert", "mesh_fsdp", "mesh_pipe"):
            if getattr(self, flag) < 1:
                raise ValueError(f"--{flag} must be >= 1, got "
                                 f"{getattr(self, flag)}")
        if self.zero1 and self.model not in SEQ_MODELS:
            from ddp_tpu_torch.parallel.spmd import check_zero1_mesh

            check_zero1_mesh({"model": self.mesh_model,
                              "fsdp": self.mesh_fsdp,
                              "expert": self.mesh_expert})
        if self.fast_epoch and self.model not in SEQ_MODELS and (
                self.use_spmd or self.grad_accum_steps > 1):
            # ``trainer.py:1373-1380``.
            raise ValueError(
                "--fast_epoch supports the pure-DDP step without "
                "gradient accumulation (or the causal LM / "
                "pipeline families)"
            )
        # The Megatron and expert dims of the sequence family
        # (``trainer.py:104-123``, ``:600-621``; the pipe family's are
        # checked in :meth:`_check_pipe`): JAX checks them for the pipe
        # and sequence families only; the image models' GSPMD rules
        # leave an axis off a dim it does not divide.
        if self.mesh_model > 1 and self.model in SEQ_MODELS:
            self._check_tp_dims()
            if self.num_kv_heads and self.num_kv_heads % self.mesh_model:
                raise ValueError(
                    "GQA under TP shards whole kv groups: "
                    f"--num_kv_heads {self.num_kv_heads} not "
                    f"divisible by --mesh_model {self.mesh_model}")
        if self.mesh_expert > 1 and self.model in SEQ_MODELS:
            if not self.moe_experts:
                raise ValueError(
                    "--mesh_expert shards MoE expert weights: give the "
                    "LM experts with --moe_experts N (or drop the axis)")
            if self.moe_experts % self.mesh_expert:
                raise ValueError(
                    f"--moe_experts {self.moe_experts} not divisible "
                    f"by --mesh_expert {self.mesh_expert}")
        if self.mesh_axes > 1:
            world = self.world_size()
            if world % self.mesh_axes:
                raise ValueError(
                    f"a world of {world} rank(s) does not tile --mesh_fsdp "
                    f"{self.mesh_fsdp} × --mesh_seq {self.mesh_seq} × "
                    f"--mesh_model {self.mesh_model} × --mesh_expert "
                    f"{self.mesh_expert} × --mesh_pipe {self.mesh_pipe}: "
                    f"run --spawn N with N a multiple of {self.mesh_axes} "
                    "(the data axis is the rest)")
            if self.elastic:
                raise ValueError(
                    "--elastic resizes the data axis of a data-parallel "
                    "world; with --mesh_fsdp/--mesh_seq/--mesh_model/"
                    "--mesh_expert it is not ported")

    def check_robustness(self, *, has_step_events: bool) -> None:
        """The trainer's guards on the fault-tolerance flags
        (``trainer.py:1387-1393``, ``:1469-1478``, ``:1553``);
        ``has_step_events``: the --chaos plan has a step trigger."""
        if self.keep_best and self.eval_every != 1:
            raise ValueError(
                "--keep_best ranks checkpoints by eval accuracy, so "
                "every epoch needs one: set --eval_every 1"
            )
        if self.keep_best and self.max_checkpoints is None:
            raise ValueError(
                "--keep_best retains the --max_checkpoints best epochs; "
                "without --max_checkpoints it would keep everything — "
                "set --max_checkpoints N (or drop --keep_best)"
            )
        if self.fast_epoch and self.watchdog_timeout > 0:
            raise ValueError(
                "--fast_epoch runs a whole epoch as one dispatch with no "
                "per-step progress beats, so a step-scale "
                "--watchdog_timeout would kill healthy runs; drop one of "
                "the two flags"
            )
        if self.fast_epoch and has_step_events:
            raise ValueError(
                "--chaos step-triggered events need the per-step loop, "
                "but --fast_epoch runs a whole epoch as ONE dispatch — "
                "use epoch-triggered events (…@epochN) or drop "
                "--fast_epoch"
            )

    def multi_host(self) -> tuple[str, int, int] | None:
        """(rendezvous host:port, world, rank) of the multi-host flags, or
        None when none is given; raises for a missing or inconsistent
        value (``runtime/dist.multi_host_world``)."""
        from ddp_tpu_torch.runtime.dist import multi_host_world

        return multi_host_world(self.coordinator_address,
                                self.num_processes, self.process_id)

    @property
    def shuffle(self) -> bool:
        return not self.no_shuffle

    @property
    def milestones(self) -> tuple[int, ...]:
        return tuple(int(m) for m in self.lr_milestones.split(",") if m.strip())
