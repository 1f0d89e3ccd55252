"""Pipeline-parallel causal LM (``ddp_tpu/models/pipeline_lm.py``): the
transformer LM cut through the same schedules as the ViT.

Stage 0 runs the token and position embedding (the front), each stage
``depth_per_stage`` pre-LN causal encoder blocks a chunk (the port's
``models/vit.EncoderBlock``, as JAX's ``StageBlocks`` uses ViT's, with a
causal ``best_attention``: B1–B3 on the card), and stage S−1 the final
LayerNorm, the TIED embedding-transpose head and the next-token loss.
The full state, JAX's ``PipeLMParams``: ``front.embed`` [V, d] and
``front.pos_embed`` [1, T, d], ``stages.blockN.*`` [S, …] or [v, S, …],
``back.ln``.

The tied embedding lives once, in the front, on every pipe rank (JAX
replicates it); its gradient is the SUM of stage 0's lookup part and
stage S−1's head part, which the step's sum over ``pipe`` makes
(``pipeline_lm.py:15-19``), so every pipe rank ends the step with the
same front. Under ``compute_dtype`` every parameter is cast per use and
the fp32 masters take the gradients, as JAX casts its parameters per step
(``_cast_params`` :537); the port sums the microbatches' gradients in
fp32, where JAX's hand-scheduled steps sum them in the compute dtype.
:func:`to_dense_lm` turns the state into the port's ``CausalLM`` state
(train pipelined, serve dense), routed blocks included.

The compositions (``pipeline_lm.py:59-132``), each over its mesh axis:

- ``tp_size``: Megatron column/row inside each stage's blocks over
  ``model`` (``parallel/tp``'s f and g: the cross-member sums of the
  derived GPipe backward and of the rebuilt 1F1B chunk alike). GQA
  shards whole kv groups.
- ``num_experts``: every ``moe_every``-th block of a chunk routed (the
  same positions in every chunk), capacity per microbatch; the
  load-balance aux loss is not collected on the pipe path. ``ep_size``:
  a stage's E/ep experts a rank, the expert all-to-all inside the stage;
  ``expert`` is a batch axis. Under ``tp_size`` GPipe alone, as JAX.
- ``sp_size``: each microbatch's tokens sharded over ``seq``, the stage
  attention ``parallel/ring.sequence_sharded_attention`` (``sp_strategy``
  ring under GPipe only, Ulysses under every schedule), stage 0 offsetting
  its position table by the shard, the last stage's loss on its local
  logits against the whole token row (:func:`next_token_sums` with an
  ``offset``).
- ``--mesh_fsdp``: the stage leaves rest sharded (``parallel/
  pipe_common``), gathered once a step and reduce-scattered back.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ddp_tpu_torch.models.lm import LN_EPS, LMSpec, _per_token_nll
from ddp_tpu_torch.models.pipeline_vit import (
    StageBlocks,
    _as_tensors,
    chunk_states,
    init_stages,
    place_shards,
)
from ddp_tpu_torch.ops.attention import best_attention
from ddp_tpu_torch.parallel.pipe_common import PipeLayout, microbatches
from ddp_tpu_torch.parallel.pipeline import StageFns

# A deliberate fault for the controls: "untied_head" leaves the head's
# part out of the tied embedding's gradient; "no_pos_offset" gives every
# seq shard the position table's first rows.
FAULT: str | None = None


class PipeLMConfig(NamedTuple):
    """``pipeline_lm.py:59``'s fields (``attention_fn`` aside)."""

    vocab_size: int
    seq_len: int
    d_model: int = 64
    num_heads: int = 4
    mlp_ratio: int = 4
    num_stages: int = 4
    depth_per_stage: int = 1
    num_microbatches: int = 4
    remat: bool = False
    virtual_stages: int = 1
    label_smoothing: float = 0.0
    num_kv_heads: int = 0
    tp_size: int = 1
    num_experts: int = 0
    moe_every: int = 2
    moe_top_k: int = 2
    moe_normalize_gates: bool = True
    ep_size: int = 1
    sp_size: int = 1
    sp_strategy: str = "ring"  # ring | ulysses


# JAX's refusal of routed stages under TP on the hand-scheduled schedules
# (``pipeline_lm.py:187-194``; ``train/config`` raises it too).
TP_MOE_HAND_SCHEDULED = (
    "the pipelined MoE-LM composes with tp under the GPipe schedule only: "
    "the hand-scheduled kernels' in-island vjp needs Megatron f/g plumbing "
    "that does not extend into routed blocks — use --pipe_schedule gpipe "
    "(or the flat --model causal_lm)")


def check_config(cfg: PipeLMConfig, *, schedule: str = "gpipe") -> None:
    """JAX's rules of the compositions (``_stage_module`` :173 and
    ``_make_handsched_lm_step`` :607-631), with JAX's messages."""
    hand = schedule != "gpipe"
    if cfg.num_experts:
        if cfg.tp_size > 1 and hand:
            raise ValueError(TP_MOE_HAND_SCHEDULED)
        if cfg.depth_per_stage % cfg.moe_every:
            raise ValueError(
                f"depth_per_stage {cfg.depth_per_stage} must be a "
                f"multiple of moe_every {cfg.moe_every} (stages must "
                "be structure-uniform for parameter stacking)")
        if cfg.num_experts % cfg.ep_size:
            raise ValueError(
                f"num_experts {cfg.num_experts} not divisible by "
                f"ep_size {cfg.ep_size}")
    elif cfg.ep_size > 1:
        raise ValueError("ep_size > 1 needs num_experts > 0")
    if cfg.sp_size > 1 and cfg.seq_len % cfg.sp_size:
        raise ValueError(
            f"seq_len {cfg.seq_len} not divisible by sp_size "
            f"{cfg.sp_size}")
    if cfg.sp_size > 1 and cfg.sp_strategy == "ring" and hand:
        raise ValueError(
            "ring attention does not compose with the hand-scheduled "
            "pipeline schedules (1f1b/interleaved): its ppermute hops "
            "have no replica groups, and the schedules' fwd/bwd "
            "branches diverge across pipe stages — use "
            "sp_strategy='ulysses' here, or the GPipe schedule "
            "(unconditional stage body) for ring")


def _check_mesh(cfg: PipeLMConfig, mesh) -> None:
    """The config's axis sizes and the mesh's must agree (``_check_sp_mesh``
    :394, for ``seq``; ``model`` and ``expert`` alike)."""
    for field, axis in (("sp_size", "seq"), ("tp_size", "model"),
                        ("ep_size", "expert")):
        if getattr(cfg, field) != mesh.shape[axis]:
            raise ValueError(
                f"cfg.{field} {getattr(cfg, field)} != mesh {axis} axis "
                f"{mesh.shape[axis]} — set PipeLMConfig.{field} to the "
                f"mesh's {axis} size")


class Front(nn.Module):
    """Token + position embedding (``_first_fn``), in the compute dtype;
    a ``seq`` shard's tokens take the table's rows at their ``offset``
    (``_make_first_fn`` :215)."""

    def __init__(self, cfg: PipeLMConfig):
        super().__init__()
        self.embed = nn.Parameter(torch.zeros(cfg.vocab_size, cfg.d_model))
        self.pos_embed = nn.Parameter(torch.zeros(1, cfg.seq_len, cfg.d_model))

    def forward(self, tokens, dt, offset: int = 0):
        T = tokens.shape[1]
        if FAULT == "no_pos_offset":
            offset = 0
        return (self.embed.to(dt)[tokens.long()]
                + self.pos_embed.to(dt)[:, offset:offset + T])


class Back(nn.Module):
    """The final LayerNorm (fp32) and the tied head (``_make_last_fn``):
    fp32 logits against the embedding cast to the compute dtype."""

    def __init__(self, cfg: PipeLMConfig):
        super().__init__()
        self.ln = nn.LayerNorm(cfg.d_model)

    def forward(self, x, embed, dt):
        x = F.layer_norm(x.float(), self.ln.normalized_shape,
                         self.ln.weight.to(dt).float(),
                         self.ln.bias.to(dt).float(), LN_EPS)
        if FAULT == "untied_head":
            embed = embed.detach()
        return x @ embed.to(dt).float().T


def _attention(cfg: PipeLMConfig, mesh):
    """The stage attention: causal ``best_attention``, or over a ``seq``
    axis the token-sharded ring or Ulysses (``_attn`` :148)."""
    if cfg.sp_size <= 1 or mesh is None:
        return best_attention(causal=True)
    from ddp_tpu_torch.parallel.ring import sequence_sharded_attention

    seq = mesh.comm("seq")

    def attn(q, k, v):
        return sequence_sharded_attention(q, k, v, strategy=cfg.sp_strategy,
                                          causal=True, comm=seq)

    return attn


def _stage(cfg: PipeLMConfig, mesh=None) -> StageBlocks:
    """A chunk's blocks (``_stage_module`` :173): at full width, over
    ``mesh``'s ``model``, ``expert`` and ``seq`` groups where the config
    composes them (none without a mesh: the init and the sequential
    forward)."""
    def comm(size, axis):
        return mesh.comm(axis) if mesh is not None and size > 1 else None

    return StageBlocks(cfg.depth_per_stage, cfg.d_model, cfg.num_heads,
                       cfg.d_model * cfg.mlp_ratio,
                       num_kv_heads=cfg.num_kv_heads,
                       attention_fn=_attention(cfg, mesh),
                       remat=cfg.remat, num_experts=cfg.num_experts,
                       moe_every=cfg.moe_every, moe_top_k=cfg.moe_top_k,
                       moe_normalize_gates=cfg.moe_normalize_gates,
                       tp=comm(cfg.tp_size, "model"),
                       ep=comm(cfg.ep_size, "expert"))


def init_pipe_lm(cfg: PipeLMConfig, *, seed: int = 0,
                 interleaved: bool = False, only=None
                 ) -> dict[str, np.ndarray]:
    """The full state (``pipeline_lm.py:265``): the embeddings N(0, 0.02²)
    and the final LN from (seed, 0); the chunks by ``pipeline_vit.
    init_stages`` (a routed block's ``moe`` leaves among them; ``only``
    of them drawn)."""
    check_config(cfg)
    ends = np.random.default_rng([seed, 0])
    f32 = np.float32
    d = cfg.d_model
    state = {
        "front.embed": (ends.standard_normal((cfg.vocab_size, d), dtype=f32)
                        * f32(0.02)),
        "front.pos_embed": (ends.standard_normal((1, cfg.seq_len, d),
                                                 dtype=f32) * f32(0.02)),
        "back.ln.weight": np.ones(d, f32),
        "back.ln.bias": np.zeros(d, f32),
    }
    state.update(init_stages(_stage(cfg), cfg, seed=seed,
                             interleaved=interleaved, only=only))
    return state


@torch.no_grad()
def sequential_apply(cfg: PipeLMConfig, state: dict, tokens,
                     compute_dtype=torch.float32):
    """The reference forward without the pipeline (``pipeline_lm.py:300``;
    either layout): tokens [B, T] → fp32 logits [B, T, V]."""
    dev = tokens.device
    front, back = Front(cfg).to(dev), Back(cfg).to(dev)
    front.load_state_dict(_as_tensors(
        {k[6:]: v for k, v in state.items() if k.startswith("front.")}, dev))
    back.load_state_dict(_as_tensors(
        {k[5:]: v for k, v in state.items() if k.startswith("back.")}, dev))
    x = front(tokens, compute_dtype)
    stage = _stage(cfg._replace(remat=False)).to(dev)
    for chunk in chunk_states(state):
        stage.load_state_dict(_as_tensors(chunk, dev))
        x = stage(x, compute_dtype)
    return back(x, front.embed, compute_dtype)


def to_dense_lm(cfg: PipeLMConfig, state: dict) -> tuple[LMSpec, dict]:
    """The full pipe state → (LMSpec, the port's ``CausalLM`` state dict)
    (``pipeline_lm.py:814``): chunk c's block j becomes dense block
    c·depth_per_stage + j + 1, [v, S] layouts flattened chunk-major; a
    routed block keeps its ``moe`` leaves, and the spec its routing."""
    chunks = chunk_states(state)
    dense = {"embed": state["front.embed"],
             "pos_embed": state["front.pos_embed"],
             "ln_final.weight": state["back.ln.weight"],
             "ln_final.bias": state["back.ln.bias"]}
    for c, chunk in enumerate(chunks):
        for name, t in chunk.items():
            blk, rest = name.split(".", 1)
            j = int(blk[len("block"):]) - 1
            dense[f"block{c * cfg.depth_per_stage + j + 1}.{rest}"] = t
    spec = LMSpec(vocab_size=cfg.vocab_size, total_len=cfg.seq_len,
                  d_model=cfg.d_model, depth=len(chunks) * cfg.depth_per_stage,
                  num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
                  num_experts=cfg.num_experts, moe_every=cfg.moe_every,
                  moe_top_k=cfg.moe_top_k,
                  moe_normalize_gates=cfg.moe_normalize_gates,
                  mlp_ratio=cfg.mlp_ratio)
    return spec, dense


def _shard_targets(logits, tokens, offset: int):
    """A ``seq`` shard's targets and their mask: local position p of the
    shard at ``offset`` predicts token offset + p + 1 of the whole row;
    the row's last position has none (``sp_loss_fn`` :359)."""
    t_local, T = logits.shape[1], tokens.shape[1]
    padded = F.pad(tokens.long(), (0, 1))
    targets = padded[:, offset + 1:offset + 1 + t_local]
    valid = ((offset + torch.arange(t_local, device=logits.device))
             < T - 1).float()
    return targets, valid


def next_token_sums(logits, tokens, label_smoothing: float = 0.0,
                    offset: int | None = None):
    """(Σ next-token loss, Σ correct) of a microbatch's fp32 logits over
    its B·(T−1) targets (``_loss_fn_factory`` :324); with ``offset``, of
    a ``seq`` shard's logits against the whole rows ``tokens``."""
    if offset is not None:
        targets, valid = _shard_targets(logits, tokens, offset)
        logits32 = logits.float()
        per_tok = _per_token_nll(logits32, targets, label_smoothing) * valid
        correct = ((logits32.argmax(-1) == targets).float() * valid).sum()
        return per_tok.sum(), correct
    logits32 = logits[:, :-1].float()
    targets = tokens[:, 1:].long()
    per_tok = _per_token_nll(logits32, targets, label_smoothing)
    correct = (logits32.argmax(-1) == targets).sum().float()
    return per_tok.sum(), correct


class PipeLM(nn.Module):
    """Pipe rank ``rank``'s part of the LM: ``front`` and ``back`` (on
    every rank) and its ``chunks``, composed over ``mesh``'s groups as
    the config asks."""

    def __init__(self, cfg: PipeLMConfig, rank: int, *,
                 interleaved: bool = False, mesh=None):
        super().__init__()
        self.cfg, self.rank, self.interleaved = cfg, rank, interleaved
        self.front, self.back = Front(cfg), Back(cfg)
        v = cfg.virtual_stages if interleaved else 1
        self.chunks = nn.ModuleList(_stage(cfg, mesh) for _ in range(v))
        seq = mesh.comm("seq") if mesh is not None else None
        self.seq_rank = seq.rank if seq is not None else 0

    @property
    def device(self) -> torch.device:
        return self.front.embed.device

    def layout(self, comm) -> PipeLayout:
        return PipeLayout(
            [n for n, _ in self.named_parameters()],
            num_stages=self.cfg.num_stages,
            virtual_stages=self.cfg.virtual_stages,
            interleaved=self.interleaved, comm=comm, rank=self.rank)

    def offset(self, t_local: int) -> int | None:
        """The first token of this rank's ``seq`` shard of ``t_local``
        tokens (None without a ``seq`` axis)."""
        return self.seq_rank * t_local if self.cfg.sp_size > 1 else None

    def fns(self, dt) -> StageFns:
        smoothing = self.cfg.label_smoothing
        return StageFns(
            stage=lambda k, x: self.chunks[k](x, dt),
            first=lambda tokens: self.front(
                tokens, dt, self.offset(tokens.shape[1]) or 0),
            last=lambda y: self.back(y, self.front.embed, dt),
            loss=lambda logits, tokens: next_token_sums(
                logits, tokens, smoothing, self.offset(logits.shape[1])))


def build_pipe_lm(cfg: PipeLMConfig, state: dict, mesh, device, *,
                  interleaved: bool = False) -> PipeLM:
    """This rank's :class:`PipeLM` on ``device`` from a full ``state``
    (its chunks cut by the ``model``, ``expert`` and ``fsdp`` specs), its
    ``shard_layout`` the :class:`PipeLayout` over ``mesh``."""
    check_config(cfg)
    _check_mesh(cfg, mesh)
    model = PipeLM(cfg, mesh.coords["pipe"], interleaved=interleaved,
                   mesh=mesh)
    place_shards(model, cfg, state, mesh, interleaved=interleaved,
                 tp=cfg.tp_size, ep=cfg.ep_size)
    return model.to(device)


def make_pipe_lm_train_step(model: PipeLM, optimizer, mesh, *,
                            schedule: str = "gpipe",
                            compute_dtype=torch.float32):
    """``step(tokens) -> StepMetrics`` (``pipeline_lm.py:493``, ``:724``,
    ``:747``): this data replica's rows [b, T], cut into the strided
    microbatches (a ``seq`` rank's inputs their columns, its labels the
    whole rows: ``_specs`` :408), through the ``schedule``; the loss and
    accuracy over the global batch's B·(T−1) targets, the grad norm the
    whole model's."""
    from ddp_tpu_torch.parallel.pipeline import make_pipe_step

    cfg = model.cfg
    check_config(cfg, schedule=schedule)
    M = cfg.num_microbatches

    def split(tokens):
        mbs = microbatches(tokens, M)
        if cfg.sp_size > 1:
            return [mesh.seq_shard(mb) for mb in mbs], mbs
        return mbs, mbs

    return make_pipe_step(
        model, optimizer, mesh, fns=model.fns(compute_dtype),
        schedule=schedule, num_microbatches=M, split=split,
        act_shape=lambda inputs: (inputs[0].shape[0], inputs[0].shape[1],
                                  cfg.d_model),
        act_dtype=compute_dtype,
        denom=lambda tokens: (tokens.shape[0] * mesh.data_size
                              * (tokens.shape[1] - 1)),
        report_grad_norm=True)


def make_pipe_lm_eval_step(model: PipeLM, mesh, *,
                           compute_dtype=torch.float32):
    """``step(tokens, weights) -> (Σ w·per-sequence accuracy, Σ w·per-
    sequence mean loss)`` of this data replica's rows, summed over
    ``pipe`` and ``seq`` (``pipeline_lm.py:858``: the forward without
    label smoothing), through the pipelined forward (a ``seq`` rank's
    columns; each sequence's means are sums of its shards' parts)."""
    from ddp_tpu_torch.parallel.pipeline import pipeline_forward

    fns = model.fns(compute_dtype)
    pipe, both = mesh.comm("pipe"), mesh.comm("pipe", "seq")
    sp = model.cfg.sp_size > 1

    @torch.no_grad()
    def step(tokens, weights):
        M = model.cfg.num_microbatches
        if tokens.shape[0] % M:
            M = 1
        toks, w = microbatches(tokens, M), microbatches(weights.float(), M)
        inputs = [mesh.seq_shard(t) for t in toks] if sp else toks
        sums = torch.zeros(2, device=model.device)
        T = tokens.shape[1]

        def on_output(m, logits):
            off = model.offset(logits.shape[1])
            if off is None:
                logits32 = logits[:, :-1].float()
                targets = toks[m][:, 1:].long()
                valid = torch.ones(T - 1, device=logits.device)
            else:
                logits32 = logits.float()
                targets, valid = _shard_targets(logits, toks[m], off)
            per_tok = _per_token_nll(logits32, targets, 0.0) * valid
            hits = (logits32.argmax(-1) == targets).float() * valid
            sums[0] += (hits.sum(1) / (T - 1) * w[m]).sum()
            sums[1] += (per_tok.sum(1) / (T - 1) * w[m]).sum()

        with model.shard_layout.gathered(model, grad=False):
            pipeline_forward(fns, pipe, inputs,
                             act_shape=(tokens.shape[0] // M,
                                        inputs[0].shape[1],
                                        model.cfg.d_model),
                             act_dtype=compute_dtype, device=model.device,
                             virtual_stages=len(model.chunks),
                             on_output=on_output)
        both.all_reduce_(sums)
        return sums[0], sums[1]

    return step
