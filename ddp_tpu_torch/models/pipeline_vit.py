"""Pipeline-parallel ViT (``ddp_tpu/models/pipeline_vit.py``): the patch
embedding in stage 0, ``depth_per_stage`` encoder blocks a stage (a
chunk; v chunks a stage interleaved), the norm and head in stage S−1.

The full state, as JAX's ``PipeViTParams`` lays it out: ``embed.proj``
(the patch conv) and ``embed.pos_embed`` (no class token: T = (H/p)²),
``stages.blockN.*`` stacked [S, …] or [v, S, …] (the port's
``models/vit.EncoderBlock`` leaves, ``interop/jax_params`` maps them to
Flax's), and ``head.ln`` and ``head.head`` (LayerNorm, the token mean,
an fp32 Dense). :class:`PipeViT` is one pipe rank's part of it: the
embedding and the head (on every rank, as JAX replicates them) and its
chunks.

Compositions (``pipeline_vit.py:46-197``): ``tp_size`` cuts each block
Megatron-style over the ``model`` axis (the port's ``EncoderBlock`` with
its ``tp`` communicator: f and g place the cross-member sums in the
derived and in the hand-scheduled backward alike), and ``--mesh_fsdp``
rests the stage leaves sharded (``parallel/pipe_common``); an ``expert``
axis is refused, as JAX's ``_reject_expert_mesh`` does (the pipelined
ViT has no routed blocks). :class:`StageBlocks` also builds the routed
chunks of the pipelined MoE-LM (``models/pipeline_lm``).

Attention is ``ops/attention.best_attention()``: B1–B3 on the card. The
input is rounded to the compute dtype (``_preprocess``) and the model
runs in fp32 on it, as the JAX module does: its Flax layers take no
dtype, so a bf16 input meets fp32 parameters and promotes (the patch
conv in full fp32: cuDNN's TF32 off, ``parallel/common.precision``).
Training augmentation draws the global batch's rows as world 1 does
(``data/augment``, ``start=``), on stage 0, which alone reads images.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ddp_tpu_torch.models.moe import MoEEncoderBlock, is_moe_block, moe_init
from ddp_tpu_torch.models.remat import remat_block
from ddp_tpu_torch.models.vit import LN_EPS, EncoderBlock
from ddp_tpu_torch.parallel.common import _preprocess, precision, xent
from ddp_tpu_torch.parallel.pipe_common import (
    ENDS_AXES,
    PipeLayout,
    microbatches,
    stage_specs,
)
from ddp_tpu_torch.parallel.pipeline import StageFns

# The routed blocks' capacity factor (JAX's ``MoEEncoderBlock`` default:
# the pipe family takes no flag for it).
MOE_CAPACITY_FACTOR = 2.0


class PipeViTConfig(NamedTuple):
    """``pipeline_vit.py:61``'s fields, plus the input's ``side`` and
    ``in_channels``."""

    num_classes: int = 10
    patch_size: int = 4
    embed_dim: int = 64
    num_heads: int = 4
    mlp_ratio: int = 4
    num_stages: int = 4
    depth_per_stage: int = 1
    num_microbatches: int = 4
    remat: bool = False
    virtual_stages: int = 1
    side: int = 28
    in_channels: int = 1
    # Megatron TP over the ``model`` axis inside each stage (PP×TP).
    tp_size: int = 1

    @property
    def tokens(self) -> int:
        return (self.side // self.patch_size) ** 2


class PatchEmbed(nn.Module):
    """The VALID stride-p patch conv → [B, (h w), d] + the position table
    (no class token)."""

    def __init__(self, cfg: PipeViTConfig):
        super().__init__()
        p, d = cfg.patch_size, cfg.embed_dim
        self.patch_size = p
        self.proj = nn.Conv2d(cfg.in_channels, d, p, stride=p)
        self.pos_embed = nn.Parameter(torch.zeros(1, cfg.tokens, d))

    def forward(self, x):
        x = F.conv2d(x.float(), self.proj.weight, self.proj.bias,
                     stride=self.patch_size)
        return x.flatten(2).transpose(1, 2) + self.pos_embed


class StageBlocks(nn.Module):
    """One chunk: ``depth`` pre-LN encoder blocks, ``block1``…, shape-
    preserving; ``remat`` recomputes each in the backward.

    ``num_experts`` > 0: every ``moe_every``-th block of the chunk routes
    its MLP (``models/moe.MoEEncoderBlock``, top ``moe_top_k``, capacity
    :data:`MOE_CAPACITY_FACTOR` over the tokens of the forward: per
    microbatch); its aux loss is not collected, as on JAX's pipe path.
    ``tp``: the ``model`` communicator (Megatron blocks, the attention of
    a routed block too, whose experts stay whole over ``model``); ``ep``:
    the ``expert`` communicator (a routed block's E/ep experts, the
    all-to-all inside the stage). The module is built at full width; the
    rank's shards replace the cut leaves (``pipe_common.PipeLayout``)."""

    def __init__(self, depth: int, dim: int, num_heads: int, mlp_dim: int, *,
                 num_kv_heads: int = 0, attention_fn=None,
                 remat: bool = False, num_experts: int = 0,
                 moe_every: int = 2, moe_top_k: int = 2,
                 moe_normalize_gates: bool = True, tp=None, ep=None):
        super().__init__()
        self.remat = remat
        self.names = [f"block{i + 1}" for i in range(depth)]
        for i, name in enumerate(self.names):
            if is_moe_block(i, num_experts, moe_every):
                block = MoEEncoderBlock(
                    dim, num_heads, mlp_dim, num_experts, top_k=moe_top_k,
                    capacity_factor=MOE_CAPACITY_FACTOR,
                    normalize_gates=moe_normalize_gates,
                    num_kv_heads=num_kv_heads, attention_fn=attention_fn)
                block.moe.ep = ep
            else:
                block = EncoderBlock(dim, num_heads, mlp_dim,
                                     num_kv_heads=num_kv_heads,
                                     attention_fn=attention_fn)
                block.tp = tp
            block.attn.tp = tp
            self.add_module(name, block)

    def forward(self, x, dt):
        remat = self.remat and torch.is_grad_enabled()
        for name in self.names:
            block = getattr(self, name)
            x = remat_block(block, x, dt) if remat else block(x, dt)
            if isinstance(x, tuple):  # a routed block: (x, aux)
                x = x[0]
        return x


class PipeHead(nn.Module):
    """LayerNorm (fp32) → the token mean → an fp32 Dense."""

    def __init__(self, cfg: PipeViTConfig):
        super().__init__()
        self.ln = nn.LayerNorm(cfg.embed_dim)
        self.head = nn.Linear(cfg.embed_dim, cfg.num_classes)

    def forward(self, x):
        x = F.layer_norm(x.float(), self.ln.normalized_shape,
                         self.ln.weight, self.ln.bias, LN_EPS)
        return F.linear(x.mean(dim=1), self.head.weight, self.head.bias)


def _stage(cfg: PipeViTConfig, mesh=None) -> StageBlocks:
    tp = mesh.comm("model") if mesh is not None and cfg.tp_size > 1 \
        else None
    return StageBlocks(cfg.depth_per_stage, cfg.embed_dim, cfg.num_heads,
                       cfg.embed_dim * cfg.mlp_ratio, remat=cfg.remat, tp=tp)


def _normal(rng, shape, std):
    return (rng.standard_normal(shape, dtype=np.float32)
            * np.float32(std)).astype(np.float32)


def init_module(module: nn.Module, rng) -> dict[str, np.ndarray]:
    """Seeded numpy weights of ``module``'s parameters: Dense and conv
    kernels LeCun-normal N(0, 1/fan_in), biases 0, LayerNorm scale 1, a
    position table N(0, 0.02²) (the scales of the Flax initialisers); a
    routed MLP's as ``models/moe.moe_init`` draws them."""
    out = {}
    for name, t in module.state_dict().items():
        shape = tuple(t.shape)
        if ".moe." in name:
            continue
        if name.endswith("pos_embed"):
            out[name] = _normal(rng, shape, 0.02)
        elif len(shape) >= 2:
            out[name] = _normal(rng, shape, int(np.prod(shape[1:])) ** -0.5)
        elif name.endswith("weight"):
            out[name] = np.ones(shape, np.float32)
        else:
            out[name] = np.zeros(shape, np.float32)
    for name, sub in module.named_modules():
        if isinstance(sub, MoEEncoderBlock):
            E, d, f = sub.moe.wi.shape
            moe_init(out, f"{name}.moe.", rng, dim=d, mlp_dim=f,
                     num_experts=E)
    return {k: out[k] for k in module.state_dict()}


def init_stages(stage: nn.Module, cfg, *, seed: int, interleaved: bool,
                only=None) -> dict[str, np.ndarray]:
    """The stacked chunks of the full state: chunk c seeded (seed, 1 + c),
    as JAX folds ``1 + c`` into its key, stacked [S, …] or [v, S, …] with
    chunk c = k·S + d at [k, d] (``interleaved``). ``only``: the chunks to
    draw (a rank's, at start-up); the others stay zero."""
    C = cfg.num_stages * (cfg.virtual_stages if interleaved else 1)
    lead = ((cfg.virtual_stages, cfg.num_stages) if interleaved
            else (cfg.num_stages,))
    out = {}
    for c in range(C):
        if only is not None and c not in only:
            continue
        for name, t in init_module(stage, np.random.default_rng(
                [seed, 1 + c])).items():
            if name not in out:
                out[name] = np.zeros((C, *t.shape), np.float32)
            out[name][c] = t
    return {f"stages.{name}": t.reshape(*lead, *t.shape[1:])
            for name, t in out.items()}


def init_pipe_vit(cfg: PipeViTConfig, *, seed: int = 0,
                  interleaved: bool = False, only=None
                  ) -> dict[str, np.ndarray]:
    """The full state: the ends from (seed, 0), the chunks by
    :func:`init_stages` (``only`` of them drawn)."""
    ends = np.random.default_rng([seed, 0])
    state = {f"embed.{k}": v for k, v in init_module(PatchEmbed(cfg),
                                                     ends).items()}
    state.update({f"head.{k}": v for k, v in init_module(PipeHead(cfg),
                                                         ends).items()})
    state.update(init_stages(_stage(cfg), cfg, seed=seed,
                             interleaved=interleaved, only=only))
    return state


def rank_chunks(cfg, mesh, *, interleaved: bool) -> set[int]:
    """The global chunks pipe rank ``mesh.coords["pipe"]`` holds."""
    from ddp_tpu_torch.parallel.interleaved import chunk_of

    d, S = mesh.coords["pipe"], cfg.num_stages
    V = cfg.virtual_stages if interleaved else 1
    return {chunk_of(k, d, S, V) if interleaved else d for k in range(V)}


def chunk_states(state: dict) -> list[dict]:
    """A full state's chunks in chunk order (c = k·S + d for [v, S, …])."""
    stages = {k[len("stages."):]: v for k, v in state.items()
              if k.startswith("stages.")}
    lead = 2 if min(v.ndim for v in stages.values()) == 3 else 1
    C = int(np.prod(next(iter(stages.values())).shape[:lead]))
    return [{k: v.reshape(C, *v.shape[lead:])[c] for k, v in stages.items()}
            for c in range(C)]


def _as_tensors(d: dict, device=None) -> dict:
    return {k: (v if torch.is_tensor(v) else torch.from_numpy(np.array(v)))
            .to(device) for k, v in d.items()}


def place_shards(model: nn.Module, cfg, state: dict, mesh, *, interleaved,
                 tp: int = 1, ep: int = 1) -> PipeLayout:
    """Make ``model`` (built at full width) this rank's part of the full
    ``state``: each parameter's data its piece (the pipe rank's chunks,
    cut by :func:`~ddp_tpu_torch.parallel.pipe_common.stage_specs` on
    ``mesh``), in place; its layout is left in ``model.shard_layout``."""
    specs = stage_specs({k: np.shape(v) for k, v in state.items()}, mesh,
                        lead=2 if interleaved else 1, tp=tp, ep=ep)
    layout = PipeLayout(
        [n for n, _ in model.named_parameters()],
        num_stages=cfg.num_stages, virtual_stages=cfg.virtual_stages,
        interleaved=interleaved, comm=mesh.comm("pipe"),
        rank=mesh.coords["pipe"], specs=specs, mesh=mesh)
    local = _as_tensors(layout.shard(state))
    named = dict(model.named_parameters())
    if set(local) != set(named):
        odd = sorted(set(local) ^ set(named))
        raise ValueError(f"the state's leaves {odd} do not match the model's")
    with torch.no_grad():  # copies: the caller's arrays stay its own
        for n, p in named.items():
            p.data = local[n].to(p.dtype).clone()
    model.shard_layout = layout
    return layout


@torch.no_grad()
def sequential_apply(cfg: PipeViTConfig, state: dict, images):
    """The reference forward without the pipeline (``pipeline_vit.py:264``
    and ``:305``, either layout): images [B, C, H, W] float → fp32
    logits."""
    dev = images.device
    embed, head = PatchEmbed(cfg).to(dev), PipeHead(cfg).to(dev)
    embed.load_state_dict(_as_tensors(
        {k[6:]: v for k, v in state.items() if k.startswith("embed.")}, dev))
    head.load_state_dict(_as_tensors(
        {k[5:]: v for k, v in state.items() if k.startswith("head.")}, dev))
    x = embed(images)
    stage = _stage(cfg._replace(remat=False)).to(dev)
    for chunk in chunk_states(state):
        stage.load_state_dict(_as_tensors(chunk, dev))
        x = stage(x, torch.float32)
    return head(x)


class PipeViT(nn.Module):
    """Pipe rank ``rank``'s part of the model: ``embed``, ``head`` and
    its ``chunks`` (local chunk k = global chunk k·S + d), their blocks
    Megatron blocks over ``mesh``'s ``model`` group under ``tp_size``."""

    def __init__(self, cfg: PipeViTConfig, rank: int, *,
                 interleaved: bool = False, mesh=None):
        super().__init__()
        self.cfg, self.rank, self.interleaved = cfg, rank, interleaved
        self.embed, self.head = PatchEmbed(cfg), PipeHead(cfg)
        v = cfg.virtual_stages if interleaved else 1
        self.chunks = nn.ModuleList(_stage(cfg, mesh) for _ in range(v))

    @property
    def device(self) -> torch.device:
        return self.head.head.weight.device

    def layout(self, comm) -> PipeLayout:
        return PipeLayout(
            [n for n, _ in self.named_parameters()],
            num_stages=self.cfg.num_stages,
            virtual_stages=self.cfg.virtual_stages,
            interleaved=self.interleaved, comm=comm, rank=self.rank)

    def fns(self, *, label_smoothing: float = 0.0) -> StageFns:
        def loss(logits, labels):
            logits = logits.float()
            return (xent(logits, labels, label_smoothing).sum(),
                    (logits.argmax(-1) == labels.long()).sum().float())

        return StageFns(
            stage=lambda k, x: self.chunks[k](x, torch.float32),
            first=self.embed, last=self.head, loss=loss)


def reject_expert_mesh(mesh) -> None:
    """JAX's ``_reject_expert_mesh`` (``pipeline_vit.py:46``)."""
    if mesh.shape.get("expert", 1) > 1:
        raise ValueError(
            "the pipelined ViT takes no expert mesh axis (it has no "
            "MoE blocks); PP×EP is the pipelined MoE-LM's — "
            "models/pipeline_lm.py")


def build_pipe_vit(cfg: PipeViTConfig, state: dict, mesh, device, *,
                   interleaved: bool = False) -> PipeViT:
    """This rank's :class:`PipeViT` on ``device`` from a full ``state``
    (its chunks cut by the ``model`` and ``fsdp`` specs), its
    ``shard_layout`` the :class:`PipeLayout` over ``mesh``."""
    reject_expert_mesh(mesh)
    if cfg.tp_size != mesh.shape["model"]:
        raise ValueError(f"cfg.tp_size {cfg.tp_size} != the mesh's model "
                         f"axis {mesh.shape['model']}")
    model = PipeViT(cfg, mesh.coords["pipe"], interleaved=interleaved,
                    mesh=mesh)
    place_shards(model, cfg, state, mesh, interleaved=interleaved,
                 tp=cfg.tp_size)
    return model.to(device)


def make_pipe_vit_train_step(model: PipeViT, optimizer, mesh, *,
                             schedule: str = "gpipe",
                             compute_dtype=torch.float32,
                             label_smoothing: float = 0.0, augment_fn=None,
                             seed: int = 0, step_counter=None):
    """``step(images, labels) -> StepMetrics`` (``pipeline_vit.py:391``,
    ``:460``, ``:633``): this data replica's uint8 rows, scaled and
    rounded to ``compute_dtype`` (``augment_fn`` on stage 0, drawing the
    global batch's rows), cut into the strided microbatches, through the
    ``schedule``; the loss is the global batch's mean, the accuracy its
    top-1; no grad_norm, as JAX's step reports none. ``step_counter()``
    gives the step for the augmentation key (the optimizer's count by
    default)."""
    from ddp_tpu_torch.data.augment import step_key
    from ddp_tpu_torch.parallel.pipeline import make_pipe_step

    reject_expert_mesh(mesh)

    cfg = model.cfg
    M = cfg.num_microbatches
    first = mesh.coords["pipe"] == 0
    count = step_counter or (lambda: optimizer.count)

    def split(images, labels):
        x = images
        if first:
            x = _preprocess(images, compute_dtype)
            if augment_fn is not None:
                key = step_key(seed, count(), 0)
                x = augment_fn(key, x, start=mesh.data_rank * x.shape[0])
        return microbatches(x, M), microbatches(labels, M)

    act = (cfg.tokens, cfg.embed_dim)
    inner = make_pipe_step(
        model, optimizer, mesh, fns=model.fns(label_smoothing=label_smoothing),
        schedule=schedule, num_microbatches=M, split=split,
        act_shape=lambda inputs: (inputs[0].shape[0], *act),
        act_dtype=torch.float32, denom=lambda images, labels:
        images.shape[0] * mesh.data_size, report_grad_norm=False)

    def step(images, labels):
        with precision(torch.float32):  # the patch conv in full fp32
            return inner(images, labels)

    return step


def make_pipe_vit_eval_step(model: PipeViT, mesh, *,
                            compute_dtype=torch.float32):
    """``step(images, labels, weights) -> (Σ w·correct, Σ w·loss)`` over
    the pipe and batch ranks: the pipelined forward of this replica's rows,
    one microbatch after another through the chunks (the JAX trainer's
    ``make_pipe_vit_apply`` / ``sequential_apply_interleaved`` eval)."""
    from ddp_tpu_torch.parallel.pipeline import pipeline_forward

    fns = model.fns()
    both = mesh.comm(*ENDS_AXES)

    @torch.no_grad()
    def step(images, labels, weights):
        M = model.cfg.num_microbatches
        if images.shape[0] % M:
            M = 1
        x = _preprocess(images, compute_dtype)
        lab, w = microbatches(labels, M), microbatches(weights.float(), M)
        sums = torch.zeros(2, device=model.device)

        def on_output(m, logits):
            logits = logits.float()
            sums[0] += ((logits.argmax(-1) == lab[m].long()).float()
                        * w[m]).sum()
            sums[1] += (xent(logits, lab[m]) * w[m]).sum()

        with precision(torch.float32), \
                model.shard_layout.gathered(model, grad=False):
            pipeline_forward(fns, mesh.comm("pipe"), microbatches(x, M),
                             act_shape=(x.shape[0] // M, model.cfg.tokens,
                                        model.cfg.embed_dim),
                             act_dtype=torch.float32, device=model.device,
                             virtual_stages=len(model.chunks),
                             on_output=on_output)
        both.all_reduce_(sums)
        return sums[0], sums[1]

    return step
