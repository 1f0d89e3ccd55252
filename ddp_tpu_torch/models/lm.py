"""Decoder-only causal language model, as an ``nn.Module``.

The PyTorch counterpart of ``ddp_tpu/models/lm.py``'s ``CausalLM``:
token embedding → learned position embedding → pre-LN blocks → final
LayerNorm → logits through the TIED embedding transpose. With
``num_experts`` > 0 every ``moe_every``-th block routes its MLP to
experts (``models/moe.py``; GShard top-k with capacity when training,
the no-capacity serving form in ``Block.finish``). Parameter names
follow the JAX tree (``embed``, ``pos_embed``, ``blockN.{ln1, attn.qkv,
attn.proj, ln2, mlp1, mlp2}`` or ``blockN.moe.{router, wi, bi, wo,
bo}``, ``ln_final``), so ``interop/jax_params.py`` maps a JAX tree by
transposes alone. Numerics follow Flax: LayerNorm in fp32 with eps
1e-6, tanh-approximated GELU, and the fused qkv columns head-major
``[H, 3, Dh]`` under MHA and group-major ``[H_kv, G+2, Dh]`` under GQA.

It serves (``forward``, the slot-level decode in ``models/generate``)
and trains: ``train_forward`` casts the fp32 master weights to the
compute dtype inside the forward, as ``ddp_tpu.models.lm`` does
(``lm.py:368-371``), and sends attention through
``parallel/ring.sequence_sharded_attention`` by ``--seq_strategy`` (the
ring → ``default_block_fn``: the flash kernels B1–B3 on a CUDA tensor),
as the JAX step does through ``_sharded_lm``. ``make_lm_train_step`` /
``make_lm_eval_step`` are the counterparts of the JAX steps
(``lm.py:492-712``).
``truncated_draft`` is a speculative-decoding draft made of the first
blocks of a model, sharing its tensors.

Across ranks (``runtime/mesh.Mesh``; ``_make_sharded_forward`` :341,
``_make_sharded_token_metrics`` :414, ``_make_sharded_seq_metrics``
:515): the tokens shard over ``seq`` (each rank a [B, T/n] column slice,
its positions from ``seq_rank · T_local``, attention through
``parallel/ring.sequence_sharded_attention`` — the multi-rank ring or
Ulysses); the blocks are Megatron blocks over ``model``
(``parallel/tp``: column-parallel ``attn.qkv`` and ``mlp1`` behind f,
row-parallel ``attn.proj`` and ``mlp2`` with g, the model built from its
shards); routed blocks exchange their expert buffer over ``expert``.
Each shard's last position targets the first token of the next shard (a
ring exchange) and the last global position has weight 0; each rank's
loss is its shard's sum over B_local·(T_global − 1), so the losses sum
over ``seq`` to the replica's mean, and the gradients are summed over
``seq`` and averaged over the data axes (data × expert), except over
``model``, where Megatron's f/g already made every replicated leaf's
gradient whole. Remat waits for a later slice.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ddp_tpu_torch.device import resolve_device
from ddp_tpu_torch.models.moe import PARAM_NAMES as MOE_PARAMS
from ddp_tpu_torch.models.moe import MoEMLP, is_moe_block, moe_init, moe_mlp
from ddp_tpu_torch.ops.attention import dot_product_attention
from ddp_tpu_torch.parallel.ddp import (
    StepMetrics,
    bucket_all_reduce,
    global_norm,
)
from ddp_tpu_torch.parallel.ring import sequence_sharded_attention
from ddp_tpu_torch.parallel.seq_fsdp import (
    gather_fsdp,
    has_fsdp,
    reduce_gradients,
)
from ddp_tpu_torch.parallel.tp import megatron_f, row_parallel
from ddp_tpu_torch.runtime.dist import all_reduce_sum

LN_EPS = 1e-6  # Flax's LayerNorm default (torch's is 1e-5)


class LMSpec(NamedTuple):
    """``ddp_tpu.models.lm.LMSpec`` without ``strategy`` and ``remat``
    (one rank, no remat), under JAX's names and defaults."""

    vocab_size: int
    total_len: int
    d_model: int = 64
    depth: int = 2
    num_heads: int = 4
    num_kv_heads: int = 0  # 0 → num_heads (MHA)
    mlp_ratio: int = 4
    num_experts: int = 0  # > 0: routed MLPs every moe_every-th block
    moe_every: int = 2
    moe_top_k: int = 2
    moe_normalize_gates: bool = True
    aux_loss_weight: float = 0.01  # GShard load-balance loss weight

    def routed(self, i: int) -> bool:
        """Block ``i`` (0-based) routes its MLP."""
        return is_moe_block(i, self.num_experts, self.moe_every)

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads


def derive_lm_spec(state: dict, *, num_heads: int, **overrides) -> LMSpec:
    """Recover an :class:`LMSpec` from a CausalLM state dict's shapes
    (``ddp_tpu/models/lm.py:157-204``).

    Everything but the head count and the routing knobs shows in the
    shapes: embed [V, d], pos_embed [1, L, d], the blockN count, qkv rows
    (H + 2·H_kv)·Dh, the MLP width (mlp1's rows or an expert's [E, d, F]),
    and which blocks are routed (``blockN.moe.wi``: ``num_experts`` is
    its E, ``moe_every`` the first routed block's number). Raises
    ValueError when the head count cannot explain them. ``overrides`` (an
    ``lm_spec.json`` sidecar's fields) fill only what the shapes cannot
    carry (``moe_top_k``, ``moe_normalize_gates``, ``aux_loss_weight``):
    shape-derived fields win, and fields the port's spec does not know
    (``strategy``, ``remat``) are dropped. A sidecar whose
    ``num_experts`` / ``moe_every`` route other blocks than the shapes
    do raises, naming both.
    """
    try:
        vocab_size, d_model = (int(s) for s in state["embed"].shape)
        total_len = int(state["pos_embed"].shape[1])
        qkv_rows = int(state["block1.attn.qkv.weight"].shape[0])
    except (KeyError, IndexError, AttributeError) as e:
        raise ValueError(f"not a causal-LM state (missing {e})") from None
    depth = len({k.split(".")[0] for k in state if k.startswith("block")})
    routed = [i for i in range(1, depth + 1) if f"block{i}.moe.wi" in state]
    widths = {int(state[f"block{i}.mlp1.weight"].shape[0])
              for i in range(1, depth + 1) if f"block{i}.mlp1.weight" in state}
    moe = {}
    if routed:
        E, _, F_ = (int(s) for s in state[f"block{routed[0]}.moe.wi"].shape)
        widths.add(F_)
        moe = dict(num_experts=E, moe_every=routed[0])
        if routed != list(range(routed[0], depth + 1, routed[0])):
            raise ValueError(
                f"routed blocks {routed} of {depth} follow no moe_every")
    if len(widths) != 1:
        raise ValueError(f"MLP widths {sorted(widths)} differ between blocks")
    mlp_dim = widths.pop()
    side = {k: overrides[k] for k in ("num_experts", "moe_every")
            if k in overrides}
    if side:
        E_side = int(side.get("num_experts") or 0)
        every = int(side.get("moe_every", 2))
        want = [i for i in range(1, depth + 1)
                if is_moe_block(i - 1, E_side, every)]
        if want != routed or (routed and E_side != moe["num_experts"]):
            raise ValueError(
                f"the sidecar says num_experts {E_side}, moe_every {every} "
                f"(routed blocks {want}), the state's shapes say "
                f"num_experts {moe.get('num_experts', 0)}, moe_every "
                f"{moe.get('moe_every', '-')} (routed blocks {routed})"
            )
    if d_model % num_heads:
        raise ValueError(
            f"num_heads {num_heads} does not divide d_model {d_model}"
        )
    head_dim = d_model // num_heads
    kv_heads = (qkv_rows // head_dim - num_heads) // 2
    if kv_heads < 1 or (2 * kv_heads + num_heads) * head_dim != qkv_rows:
        raise ValueError(
            f"qkv kernel has {qkv_rows} columns, which no kv-head count "
            f"explains at num_heads {num_heads} — wrong head count?"
        )
    if num_heads % kv_heads or mlp_dim % d_model:
        raise ValueError(
            f"inconsistent shapes: num_heads {num_heads}, kv heads "
            f"{kv_heads}, mlp width {mlp_dim}, d_model {d_model}"
        )
    fields = dict(
        vocab_size=vocab_size,
        total_len=total_len,
        d_model=d_model,
        depth=depth,
        num_heads=num_heads,
        num_kv_heads=0 if kv_heads == num_heads else kv_heads,
        mlp_ratio=mlp_dim // d_model,
        **moe,
    )
    fields.update((k, v) for k, v in overrides.items()
                  if k in LMSpec._fields and k not in fields)
    return LMSpec(**fields)


def split_qkv(qkv, H: int, H_kv: int, Dh: int):
    """Fused projection [B, T, (H + 2·H_kv)·Dh] → q [B, T, H, Dh] and
    k/v [B, T, H_kv, Dh], in the JAX package's column order."""
    B, T = qkv.shape[:2]
    if H_kv != H:
        # GQA, GROUP-MAJOR: [kv-group: q·G | k | v] × H_kv.
        G = H // H_kv
        qkv = qkv.reshape(B, T, H_kv, G + 2, Dh)
        return (
            qkv[..., :G, :].reshape(B, T, H, Dh),
            qkv[..., G, :],
            qkv[..., G + 1, :],
        )
    # MHA, HEAD-MAJOR: [head, (q|k|v), head_dim].
    qkv = qkv.reshape(B, T, H, 3, Dh)
    return qkv[:, :, :, 0], qkv[:, :, :, 1], qkv[:, :, :, 2]


class Attention(nn.Module):
    def __init__(self, spec: LMSpec):
        super().__init__()
        cols = (spec.num_heads + 2 * spec.kv_heads) * spec.head_dim
        self.qkv = nn.Linear(spec.d_model, cols)
        self.proj = nn.Linear(spec.d_model, spec.d_model)


class Block(nn.Module):
    """Pre-LN block. ``qkv`` and ``finish`` are its two halves — the
    counterparts of ``ddp_tpu.models.generate._block_qkv`` (:84) and
    ``_block_finish`` (:150) — shared by the dense forward, the chunked
    prefill, the decode step and the speculative verify, so the paths
    cannot drift apart numerically. A ``routed`` block holds ``moe`` (a
    :class:`~ddp_tpu_torch.models.moe.MoEMLP` with the spec's routing)
    instead of ``mlp1``/``mlp2``."""

    def __init__(self, spec: LMSpec, routed: bool = False):
        super().__init__()
        self.spec = spec
        d = spec.d_model
        self.ln1 = nn.LayerNorm(d, eps=LN_EPS)
        self.attn = Attention(spec)
        self.ln2 = nn.LayerNorm(d, eps=LN_EPS)
        if routed:
            self.moe = MoEMLP(d, d * spec.mlp_ratio, spec.num_experts,
                              top_k=spec.moe_top_k,
                              normalize_gates=spec.moe_normalize_gates)
        else:
            self.mlp1 = nn.Linear(d, d * spec.mlp_ratio)
            self.mlp2 = nn.Linear(d * spec.mlp_ratio, d)

    def qkv(self, x):
        """ln1 → fused qkv → (q [B,T,H,Dh], k/v [B,T,H_kv,Dh])."""
        s = self.spec
        return split_qkv(
            self.attn.qkv(self.ln1(x)), s.num_heads, s.kv_heads, s.head_dim
        )

    def finish(self, x, attn_vec):
        """Output projection residual + MLP residual; ``attn_vec`` is
        [B, T, d] (heads concatenated). A routed block takes the serving
        expert path, with the spec's top-k and gate normalisation."""
        x = x + self.attn.proj(attn_vec)
        if hasattr(self, "moe"):
            return x + self.moe.serve(
                self.ln2(x), top_k=self.spec.moe_top_k,
                normalize_gates=self.spec.moe_normalize_gates)
        h = F.gelu(self.mlp1(self.ln2(x)), approximate="tanh")
        return x + self.mlp2(h)


class CausalLM(nn.Module):
    """[B, T] int tokens → [B, T, vocab] fp32 logits (tied head)."""

    def __init__(self, spec: LMSpec):
        super().__init__()
        self.spec = spec
        self.embed = nn.Parameter(torch.empty(spec.vocab_size, spec.d_model))
        self.pos_embed = nn.Parameter(
            torch.empty(1, spec.total_len, spec.d_model)
        )
        for i in range(spec.depth):
            self.add_module(f"block{i + 1}", Block(spec, spec.routed(i)))
        self.ln_final = nn.LayerNorm(spec.d_model, eps=LN_EPS)

    @property
    def blocks(self) -> list[Block]:
        return [getattr(self, f"block{i + 1}") for i in range(self.spec.depth)]

    @property
    def device(self) -> torch.device:
        return self.embed.device

    @classmethod
    def from_state(
        cls, spec: LMSpec, state: dict, device=None, *, trainable: bool = False
    ) -> "CausalLM":
        """Build on ``device`` (the GPU unless ``"cpu"`` is asked for)
        from a state dict of arrays or tensors. Inference only, unless
        ``trainable``: then the fp32 weights are the master copy and
        require gradients."""
        dev = resolve_device(device)
        model = cls(spec)
        model.load_state_dict(
            {
                k: v.detach() if torch.is_tensor(v)
                else torch.as_tensor(np.array(v))
                for k, v in state.items()
            },
            strict=True,
        )
        model = model.to(dev).float()
        if trainable:
            return model.requires_grad_(True).train()
        return model.requires_grad_(False).eval()

    def head(self, x):
        """Final LayerNorm → tied-embedding logits, fp32."""
        return self.ln_final(x).float() @ self.embed.float().T

    def forward(self, tokens):
        """Full-sequence forward through ``Block.finish`` — the
        counterpart of ``ddp_tpu.models.lm.dense_lm_apply`` (for a routed
        model the no-capacity serving form: equal where training's
        capacity drops nothing)."""
        s = self.spec
        T = tokens.shape[1]
        x = self.embed[tokens.long()] + self.pos_embed[:, :T]
        G = s.num_heads // s.kv_heads
        for blk in self.blocks:
            q, k, v = blk.qkv(x)
            attn = dot_product_attention(
                q,
                k.repeat_interleave(G, dim=2),
                v.repeat_interleave(G, dim=2),
                causal=True,
            )
            x = blk.finish(x, attn.reshape(*x.shape))
        return self.head(x)

    def train_forward(self, tokens, *, compute_dtype=torch.float32,
                      block_fn=None, return_aux: bool = False, mesh=None,
                      strategy: str = "ring", params=None):
        """The training forward → [B, T, vocab] fp32 logits; with
        ``return_aux``, ``(logits, aux)``: the mean of the routed blocks'
        load-balance losses (``lm.py:377-380``; 0 for a dense model).

        Every parameter is cast to ``compute_dtype`` here, so gradients
        flow back through the cast into the fp32 masters. LayerNorms
        compute in fp32 and cast back (``vit.py:203,215``); ``ln_final``
        and the tied-head logits stay fp32 (``lm.py:129-131``). Under GQA
        K/V are repeated to H heads before attention (``vit.py:152``).
        Attention is ``parallel/ring.sequence_sharded_attention`` by
        ``strategy``; ``block_fn`` overrides the ring's block
        (``parallel.ring.default_block_fn`` by default). Routed blocks
        route the B·T tokens of this forward with capacity
        (``models/moe.moe_mlp``), their router in fp32 over the cast
        weights (``moe.py:70-72``).

        ``mesh`` (a ``runtime/mesh.Mesh`` whose model holds this rank's
        shards): ``tokens`` is this rank's [B, T/n] column slice, the
        attention runs over the ``seq`` group, the blocks over ``model``
        (Megatron f/g) and the routed MLPs over ``expert``; the logits
        are this shard's. ``params``: ``{name: tensor}`` to run in place of
        the parameters (FSDP's gathered leaves, ``parallel/seq_fsdp``).
        """
        s = self.spec
        named = (params.items() if params is not None
                 else self.named_parameters())
        p = {
            name: w if w.dtype == compute_dtype else w.to(compute_dtype)
            for name, w in named
        }
        auxes = []

        def norm(x, name):
            return F.layer_norm(
                x.float(), (s.d_model,), p[name + ".weight"].float(),
                p[name + ".bias"].float(), LN_EPS,
            )

        def dense(x, name):
            return F.linear(x, p[name + ".weight"], p[name + ".bias"])

        B, T = tokens.shape
        H, H_kv, pos0 = s.num_heads, s.kv_heads, 0
        seq = tp = ep = None
        if mesh is not None:
            seq, tp, ep = (mesh.comm(a) for a in ("seq", "model", "expert"))
            H, H_kv, pos0 = H // tp.size, H_kv // tp.size, seq.rank * T

        def row(x, name):
            return row_parallel(x, p[name + ".weight"], p[name + ".bias"],
                                tp)

        def col_in(y):
            return y if tp is None else megatron_f(y, tp)

        x = p["embed"][tokens.long()] + p["pos_embed"][:, pos0:pos0 + T]
        G = s.num_heads // s.kv_heads
        for i in range(1, s.depth + 1):
            b = f"block{i}."
            y = col_in(norm(x, b + "ln1").to(x.dtype))
            q, k, v = split_qkv(dense(y, b + "attn.qkv"), H, H_kv,
                                s.head_dim)
            if G > 1:
                k = k.repeat_interleave(G, dim=2)
                v = v.repeat_interleave(G, dim=2)
            o = sequence_sharded_attention(q, k, v, strategy=strategy,
                                           causal=True, comm=seq,
                                           block_fn=block_fn)
            x = x + row(o.reshape(B, T, H * s.head_dim), b + "attn.proj")
            y = norm(x, b + "ln2").to(x.dtype)
            if s.routed(i - 1):
                y, aux, _ = moe_mlp(
                    y, {k: p[b + "moe." + k] for k in MOE_PARAMS},
                    num_experts=s.num_experts, top_k=s.moe_top_k,
                    normalize_gates=s.moe_normalize_gates, ep=ep)
                auxes.append(aux)
                x = x + y
            else:
                h = F.gelu(dense(col_in(y), b + "mlp1"), approximate="tanh")
                x = x + row(h, b + "mlp2")
        x = norm(x, "ln_final")
        logits = x @ p["embed"].float().T
        if not return_aux:
            return logits
        aux = (sum(auxes) / len(auxes) if auxes
               else logits.new_zeros((), dtype=torch.float32))
        return logits, aux


# ---- training and evaluation steps -------------------------------------


def _per_token_nll(logits32, targets, label_smoothing: float):
    """[B, T] next-token NLL from fp32 logits (``lm.py:402``): with
    smoothing ε, against (1−ε)·one-hot + ε·uniform, from log-probs."""
    if label_smoothing:
        eps = label_smoothing
        logp = torch.log_softmax(logits32, dim=-1)
        nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
        return (1.0 - eps) * nll - (eps / logits32.shape[-1]) * logp.sum(-1)
    # Classes on the last dim of a 2-D view: the row softmax kernel, not
    # the strided "spatial" one a [B, V, T] layout would take.
    B, T, V = logits32.shape
    return F.cross_entropy(
        logits32.reshape(B * T, V), targets.reshape(B * T), reduction="none"
    ).reshape(B, T)


def _shifted_targets(tokens):
    """Position t predicts token t+1; the last position has no target
    (target 0, weight 0) → (targets [B, T] int64, mask [T] fp32)."""
    tokens = tokens.long()
    targets = torch.cat([tokens[:, 1:], torch.zeros_like(tokens[:, :1])], 1)
    # Built on the device: ``mask[-1] = 0.0`` would copy a host scalar
    # into it, a synchronizing call each time (two a training step).
    T = tokens.shape[1]
    mask = (torch.arange(T, device=tokens.device) < T - 1).float()
    return targets, mask


def next_token_loss(logits, tokens, *, label_smoothing: float = 0.0):
    """Mean causal-LM loss over the B·(T−1) targets (``lm.py:266``)."""
    targets, mask = _shifted_targets(tokens)
    per_tok = _per_token_nll(logits.float(), targets, label_smoothing)
    return (per_tok * mask).sum() / (mask.sum() * tokens.shape[0])


def make_lm_train_step(
    model: CausalLM,
    optimizer,
    *,
    compute_dtype=torch.float32,
    grad_accum_steps: int = 1,
    label_smoothing: float = 0.0,
    block_fn=None,
    world: int = 1,
    reduce=all_reduce_sum,
    mesh=None,
    strategy: str = "ring",
):
    """The causal-LM step (``lm.py:572``): ``step(tokens) ->
    StepMetrics`` updates ``model``'s parameters in place.

    ``world`` > 1: ``tokens`` is this rank's shard of the global batch;
    the gradients, the loss and the correct count go through one
    ``reduce`` (a sum over the world in place) of one flat fp32 bucket,
    and all but the count are divided by the world
    (``parallel/ddp.make_train_step``'s bucket; JAX's ``pmean`` over the
    data axis).

    ``grad_accum_steps=k`` splits the batch into k STRIDED microbatches
    (rows ``i::k``, ``lm.py:650-656``), sums their gradients and divides
    by k. Loss is the mean next-token cross-entropy, plus, for a routed
    model, ``spec.aux_loss_weight`` × the mean aux loss of its routed
    blocks, in the loss differentiated and the loss reported
    (``lm.py:633-636``); accuracy the next-token top-1, grad_norm the
    global norm of the (averaged, unclipped) gradient. Metrics stay on
    the device: no host read.

    ``mesh`` (a ``runtime/mesh.Mesh`` over more than the data axes; the
    model sharded by ``parallel/tp.shard_module``; ``world`` and
    ``reduce`` unused): ``tokens`` is this data replica's rows at full
    length, the step takes its ``seq`` columns, and one reduction
    (:func:`_reduce_gradients`) averages over the replicas; the grad
    norm is the full model's (``tp.ShardLayout.norm``). Leaves sharded
    over ``fsdp`` are gathered for the forward, their gradients
    reduce-scattered by the gather's backward (``parallel/seq_fsdp``).

    ``optimizer`` a ``parallel/zero.ZeroOptimizer`` (``--parallel
    zero``, on a mesh): the gradients are summed over ``seq``, reduce-
    scattered over ``data`` bucket by bucket and updated there
    (``zero_gspmd_update``); the loss and count are summed over data and
    ``seq``; the grad norm is the zero update's.
    """
    params = [p for p in model.parameters() if p.requires_grad]
    if not params:
        raise ValueError("the model has no trainable parameters: build it "
                         "with CausalLM.from_state(..., trainable=True)")
    spec = model.spec
    seq = None if mesh is None else mesh.comm("seq")
    n_seq = 1 if seq is None else seq.size
    layout = getattr(model, "shard_layout", None)
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    norm = global_norm if layout is None else layout.norm
    replicas = world if mesh is None else mesh.data_size
    fsdp = has_fsdp(layout)
    zero = getattr(optimizer, "scatter_grads", None) is not None

    def objective(rows):
        """This rank's loss (its shard's summed next-token loss over
        B·(T_global − 1), plus a routed model's weighted aux loss over
        n_seq: summed over ``seq`` and averaged over the data replicas,
        JAX's mean over every rank) and correct count."""
        cols = rows if mesh is None else mesh.seq_shard(rows)
        logits, aux = model.train_forward(
            cols, compute_dtype=compute_dtype, block_fn=block_fn,
            return_aux=True, mesh=mesh, strategy=strategy,
            params=gather_fsdp(model, layout, mesh) if fsdp else None)
        targets, mask = shard_targets(cols, seq)
        per_tok = _per_token_nll(logits.float(), targets, label_smoothing)
        loss = (per_tok * mask).sum() / (rows.shape[0] * (rows.shape[1] - 1))
        correct = ((logits.argmax(-1) == targets).float() * mask).sum()
        if spec.num_experts:
            loss = loss + spec.aux_loss_weight * aux / n_seq
        return loss, correct

    def step(tokens) -> StepMetrics:
        B, T = tokens.shape
        for p in params:
            p.grad = None
        k = grad_accum_steps
        if B % k:
            raise ValueError(f"batch {B} not divisible by grad_accum_steps "
                             f"{k}")
        loss = correct = 0.0
        for i in range(k):
            l_i, c_i = objective(tokens[i::k])
            l_i.backward()
            loss, correct = loss + l_i.detach(), correct + c_i
        if k > 1:
            for p in params:
                p.grad.div_(k)
        extras = [torch.as_tensor(loss / k).float(),
                  torch.as_tensor(correct).float()]
        if zero:
            shards = optimizer.scatter_grads(pre_sum=seq)
            loss, correct = mesh.comm("data", "seq").all_reduce_(
                torch.stack(extras))
            grad_norm = optimizer.apply(shards, 1.0 / replicas)
            return StepMetrics(loss=loss / replicas,
                               accuracy=correct / (B * replicas * (T - 1)),
                               grad_norm=grad_norm)
        if mesh is not None:
            loss, correct = _reduce_gradients(params, names, layout, mesh,
                                              extras)
        elif world > 1:
            _, (loss, correct) = bucket_all_reduce(params, extras, world,
                                                   reduce)
        else:
            loss, correct = extras
        grad_norm = norm([p.grad for p in params])
        optimizer.step()
        return StepMetrics(loss=loss,
                           accuracy=correct / (B * replicas * (T - 1)),
                           grad_norm=grad_norm)

    return step


def make_lm_eval_step(model: CausalLM, *, compute_dtype=torch.float32,
                      mesh=None, strategy: str = "ring"):
    """Eval over held-out tokens (``lm.py:492``): ``step(tokens,
    weights) -> (Σ w·per-sequence token accuracy, Σ w·per-sequence mean
    loss)``, device scalars; the caller divides by the split size.
    ``mesh``: ``tokens`` is this data replica's rows at full length, each
    sequence's sums are reduced over ``seq`` (``_make_sharded_seq_metrics``
    :515), and the sums are this replica's (the caller sums them over the
    data axes)."""
    seq = None if mesh is None else mesh.comm("seq")
    layout = getattr(model, "shard_layout", None)
    fsdp = has_fsdp(layout)

    @torch.no_grad()
    def step(tokens, weights):
        T_global = tokens.shape[1]
        if mesh is not None:
            tokens = mesh.seq_shard(tokens)
        logits = model.train_forward(
            tokens, compute_dtype=compute_dtype, mesh=mesh,
            strategy=strategy,
            params=gather_fsdp(model, layout, mesh) if fsdp else None)
        targets, mask = shard_targets(tokens, seq)
        logits32 = logits.float()
        per_tok = _per_token_nll(logits32, targets, 0.0)
        sums = torch.stack([
            (per_tok * mask).sum(1),
            ((logits32.argmax(-1) == targets).float() * mask).sum(1)])
        if seq is not None:
            seq.all_reduce_(sums)
        seq_loss, seq_acc = sums / (T_global - 1)
        w = weights.float()
        return (seq_acc * w).sum(), (seq_loss * w).sum()

    return step


# ---- across ranks -------------------------------------------------------


def shard_targets(tokens, seq):
    """The next-token targets of a [B, T_local] shard and their weights
    [T_local] (``lm.py:434-450``): the shard's last position targets the
    next shard's first token, passed back round the ``seq`` ring; the
    last global position has target 0 and weight 0. ``seq`` None or of
    one rank: :func:`_shifted_targets`."""
    if seq is None or seq.size == 1:
        return _shifted_targets(tokens)
    tokens = tokens.long()
    nxt = seq.shift(tokens[:, :1].contiguous(), -1)  # from rank + 1
    targets = torch.cat([tokens[:, 1:], nxt], 1)
    T = tokens.shape[1]
    last = T - 1 if seq.rank == seq.size - 1 else T
    mask = (torch.arange(T, device=tokens.device) < last).float()
    return targets, mask


def _reduce_gradients(params, names, layout, mesh, extras):
    """The step's reduction → the reduced ``extras``
    (``parallel/seq_fsdp.reduce_gradients``): every gradient summed over
    ``seq`` and the data axes and averaged over the data replicas (data ×
    fsdp × expert), never reduced over ``model`` (f/g made the
    replicated leaves' gradients whole there), and not over ``expert``
    or ``fsdp`` where the expert all-to-all or the FSDP gather's
    reduce-scatter already summed it. ``extras`` (the loss and, last,
    the count) ride the replicated leaves' bucket; all but the count are
    divided too."""
    return reduce_gradients(params, names, layout, mesh, extras)


def init_lm_state(spec: LMSpec, *, seed: int = 0) -> dict[str, np.ndarray]:
    """Seeded random weights, made with numpy, as a CausalLM state dict.

    Embeddings draw N(0, 0.02²) and linear weights N(0, 1/fan_in) (the
    scales of Flax's defaults), biases zero, LayerNorms identity; a
    routed block's experts as ``models/moe.moe_init`` draws them.
    """
    rng = np.random.default_rng(seed)
    f32 = np.float32

    def normal(shape, std):
        return (rng.standard_normal(shape, dtype=f32) * f32(std)).astype(f32)

    d, mlp = spec.d_model, spec.d_model * spec.mlp_ratio
    cols = (spec.num_heads + 2 * spec.kv_heads) * spec.head_dim
    state = {
        "embed": normal((spec.vocab_size, d), 0.02),
        "pos_embed": normal((1, spec.total_len, d), 0.02),
        "ln_final.weight": np.ones(d, f32),
        "ln_final.bias": np.zeros(d, f32),
    }
    for i in range(spec.depth):
        b = f"block{i + 1}."
        linears = [("attn.qkv", (cols, d)), ("attn.proj", (d, d))]
        if not spec.routed(i):
            linears += [("mlp1", (mlp, d)), ("mlp2", (d, mlp))]
        for name, (n_out, n_in) in linears:
            state[b + name + ".weight"] = normal((n_out, n_in), n_in**-0.5)
            state[b + name + ".bias"] = np.zeros(n_out, f32)
        if spec.routed(i):
            moe_init(state, b + "moe.", rng, dim=d, mlp_dim=mlp,
                     num_experts=spec.num_experts)
        for ln in ("ln1", "ln2"):
            state[b + ln + ".weight"] = np.ones(d, f32)
            state[b + ln + ".bias"] = np.zeros(d, f32)
    return state


def init_lm(spec: LMSpec, *, seed: int = 0, device=None) -> CausalLM:
    """A seeded random model on ``device`` (the GPU unless ``"cpu"``)."""
    return CausalLM.from_state(spec, init_lm_state(spec, seed=seed), device)


def truncated_draft(model: CausalLM, depth: int) -> CausalLM:
    """A speculative-decoding draft that shares ``model``'s weights: its
    first ``depth`` blocks with ``embed``, ``pos_embed`` and
    ``ln_final``, the same tensors (no copy). The zero-training draft of
    ``bench.py``'s speculative variants."""
    if not 1 <= depth <= model.spec.depth:
        raise ValueError(
            f"draft depth {depth} must be in 1..{model.spec.depth}"
        )
    draft = CausalLM.__new__(CausalLM)
    nn.Module.__init__(draft)
    draft.spec = model.spec._replace(depth=depth)
    draft.embed = model.embed
    draft.pos_embed = model.pos_embed
    for i in range(depth):
        draft.add_module(f"block{i + 1}", getattr(model, f"block{i + 1}"))
    draft.ln_final = model.ln_final
    return draft.train(model.training)
