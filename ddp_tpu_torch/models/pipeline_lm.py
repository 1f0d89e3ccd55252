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
(train pipelined, serve dense).
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
    init_module,
)
from ddp_tpu_torch.ops.attention import best_attention
from ddp_tpu_torch.parallel.pipe_common import (
    PipeLayout,
    microbatches,
    stack_stage_params,
)
from ddp_tpu_torch.parallel.pipeline import StageFns

# A deliberate fault for the controls: "untied_head" leaves the head's
# part out of the tied embedding's gradient.
FAULT: str | None = None


class PipeLMConfig(NamedTuple):
    """``pipeline_lm.py:59``'s fields of this slice (MoE, TP, EP and SP
    stages wait for ROADMAP A4.1b)."""

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


class Front(nn.Module):
    """Token + position embedding (``_first_fn``), in the compute dtype."""

    def __init__(self, cfg: PipeLMConfig):
        super().__init__()
        self.embed = nn.Parameter(torch.zeros(cfg.vocab_size, cfg.d_model))
        self.pos_embed = nn.Parameter(torch.zeros(1, cfg.seq_len, cfg.d_model))

    def forward(self, tokens, dt):
        T = tokens.shape[1]
        return (self.embed.to(dt)[tokens.long()]
                + self.pos_embed.to(dt)[:, :T])


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


def _stage(cfg: PipeLMConfig) -> StageBlocks:
    return StageBlocks(cfg.depth_per_stage, cfg.d_model, cfg.num_heads,
                       cfg.d_model * cfg.mlp_ratio,
                       num_kv_heads=cfg.num_kv_heads,
                       attention_fn=best_attention(causal=True),
                       remat=cfg.remat)


def init_pipe_lm(cfg: PipeLMConfig, *, seed: int = 0,
                 interleaved: bool = False) -> dict[str, np.ndarray]:
    """The full state (``pipeline_lm.py:265``): chunk c seeded (seed,
    1 + c), the embeddings N(0, 0.02²) and the final LN from (seed, 0);
    chunks stacked [S, …], or [v, S, …] with chunk c = k·S + d at [k, d]."""
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
    C = cfg.num_stages * (cfg.virtual_stages if interleaved else 1)
    chunks = [init_module(_stage(cfg), np.random.default_rng([seed, 1 + c]))
              for c in range(C)]
    for name, t in stack_stage_params(chunks).items():
        if interleaved:
            t = t.reshape(cfg.virtual_stages, cfg.num_stages, *t.shape[1:])
        state[f"stages.{name}"] = t
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
    c·depth_per_stage + j + 1, [v, S] layouts flattened chunk-major."""
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
                  mlp_ratio=cfg.mlp_ratio)
    return spec, dense


def next_token_sums(logits, tokens, label_smoothing: float = 0.0):
    """(Σ next-token loss, Σ correct) of a microbatch's fp32 logits over
    its B·(T−1) targets (``_loss_fn_factory`` :324)."""
    logits32 = logits[:, :-1].float()
    targets = tokens[:, 1:].long()
    per_tok = _per_token_nll(logits32, targets, label_smoothing)
    correct = (logits32.argmax(-1) == targets).sum().float()
    return per_tok.sum(), correct


class PipeLM(nn.Module):
    """Pipe rank ``rank``'s part of the LM: ``front`` and ``back`` (on
    every rank) and its ``chunks``."""

    def __init__(self, cfg: PipeLMConfig, rank: int, *,
                 interleaved: bool = False):
        super().__init__()
        self.cfg, self.rank, self.interleaved = cfg, rank, interleaved
        self.front, self.back = Front(cfg), Back(cfg)
        v = cfg.virtual_stages if interleaved else 1
        self.chunks = nn.ModuleList(_stage(cfg) for _ in range(v))

    @property
    def device(self) -> torch.device:
        return self.front.embed.device

    def layout(self, comm) -> PipeLayout:
        return PipeLayout(
            [n for n, _ in self.named_parameters()],
            num_stages=self.cfg.num_stages,
            virtual_stages=self.cfg.virtual_stages,
            interleaved=self.interleaved, comm=comm, rank=self.rank)

    def fns(self, dt) -> StageFns:
        smoothing = self.cfg.label_smoothing
        return StageFns(
            stage=lambda k, x: self.chunks[k](x, dt),
            first=lambda tokens: self.front(tokens, dt),
            last=lambda y: self.back(y, self.front.embed, dt),
            loss=lambda logits, tokens: next_token_sums(logits, tokens,
                                                        smoothing))


def build_pipe_lm(cfg: PipeLMConfig, state: dict, mesh, device, *,
                  interleaved: bool = False) -> PipeLM:
    """This rank's :class:`PipeLM` on ``device`` from a full ``state``,
    its ``shard_layout`` the ``pipe`` group's :class:`PipeLayout`."""
    model = PipeLM(cfg, mesh.coords["pipe"], interleaved=interleaved)
    layout = model.layout(mesh.comm("pipe"))
    model.load_state_dict(_as_tensors(layout.shard(state)))
    model = model.to(device)
    model.shard_layout = layout
    return model


def make_pipe_lm_train_step(model: PipeLM, optimizer, mesh, *,
                            schedule: str = "gpipe",
                            compute_dtype=torch.float32):
    """``step(tokens) -> StepMetrics`` (``pipeline_lm.py:493``, ``:724``,
    ``:747``): this data replica's rows [b, T], cut into the strided
    microbatches, through the ``schedule``; the loss and accuracy over
    the global batch's B·(T−1) targets, the grad norm the whole model's."""
    from ddp_tpu_torch.parallel.pipeline import make_pipe_step

    cfg = model.cfg
    M = cfg.num_microbatches

    def split(tokens):
        mbs = microbatches(tokens, M)
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
    ``pipe`` (``pipeline_lm.py:858``: the forward without label
    smoothing), through the pipelined forward."""
    from ddp_tpu_torch.parallel.pipeline import pipeline_forward

    fns = model.fns(compute_dtype)
    pipe = mesh.comm("pipe")

    @torch.no_grad()
    def step(tokens, weights):
        M = model.cfg.num_microbatches
        if tokens.shape[0] % M:
            M = 1
        toks, w = microbatches(tokens, M), microbatches(weights.float(), M)
        sums = torch.zeros(2, device=model.device)

        def on_output(m, logits):
            logits32 = logits[:, :-1].float()
            targets = toks[m][:, 1:].long()
            per_tok = _per_token_nll(logits32, targets, 0.0)
            sums[0] += ((logits32.argmax(-1) == targets).float().mean(1)
                        * w[m]).sum()
            sums[1] += (per_tok.mean(1) * w[m]).sum()

        B, T = tokens.shape
        pipeline_forward(fns, pipe, toks,
                         act_shape=(B // M, T, model.cfg.d_model),
                         act_dtype=compute_dtype, device=model.device,
                         virtual_stages=len(model.chunks),
                         on_output=on_output)
        pipe.all_reduce_(sums)
        return sums[0], sums[1]

    return step
