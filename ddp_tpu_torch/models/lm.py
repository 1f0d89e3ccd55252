"""Decoder-only causal language model (dense), as an ``nn.Module``.

The PyTorch counterpart of ``ddp_tpu/models/lm.py``'s dense
``CausalLM``: token embedding → learned position embedding → pre-LN
blocks → final LayerNorm → logits through the TIED embedding
transpose. Parameter names follow the JAX tree (``embed``,
``pos_embed``, ``blockN.{ln1, attn.qkv, attn.proj, ln2, mlp1, mlp2}``,
``ln_final``), so ``interop/jax_params.py`` maps a JAX tree by
transposes alone. Numerics follow Flax: LayerNorm in fp32 with eps
1e-6, tanh-approximated GELU, and the fused qkv columns head-major
``[H, 3, Dh]`` under MHA and group-major ``[H_kv, G+2, Dh]`` under GQA.

It serves (``forward``, the slot-level decode in ``models/generate``)
and trains: ``train_forward`` casts the fp32 master weights to the
compute dtype inside the forward, as ``ddp_tpu.models.lm`` does
(``lm.py:368-371``), and sends attention through
``parallel/ring.ring_attention`` → ``default_block_fn`` (the flash
kernels B1–B3 on a CUDA tensor), as the JAX step does through
``_sharded_lm``. ``make_lm_train_step`` / ``make_lm_eval_step`` are the
one-rank counterparts of the JAX steps (``lm.py:492-712``).

MoE blocks, remat and tensor/expert/sequence parallelism wait for
later slices.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ddp_tpu_torch.device import resolve_device
from ddp_tpu_torch.ops.attention import dot_product_attention
from ddp_tpu_torch.parallel.ddp import StepMetrics, global_norm
from ddp_tpu_torch.parallel.ring import ring_attention

LN_EPS = 1e-6  # Flax's LayerNorm default (torch's is 1e-5)


class LMSpec(NamedTuple):
    """The dense subset of ``ddp_tpu.models.lm.LMSpec``."""

    vocab_size: int
    total_len: int
    d_model: int = 64
    depth: int = 2
    num_heads: int = 4
    num_kv_heads: int = 0  # 0 → num_heads (MHA)
    mlp_ratio: int = 4

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads


def derive_lm_spec(state: dict, *, num_heads: int) -> LMSpec:
    """Recover an :class:`LMSpec` from a CausalLM state dict's shapes.

    Everything but the head count shows in the shapes (embed [V, d],
    pos_embed [1, L, d], blockN count, qkv rows (H + 2·H_kv)·Dh, mlp1
    rows); raises ValueError when the head count cannot explain them.
    """
    try:
        vocab_size, d_model = (int(s) for s in state["embed"].shape)
        total_len = int(state["pos_embed"].shape[1])
        qkv_rows = int(state["block1.attn.qkv.weight"].shape[0])
        mlp_dim = int(state["block1.mlp1.weight"].shape[0])
    except (KeyError, IndexError, AttributeError) as e:
        raise ValueError(f"not a causal-LM state (missing {e})") from None
    depth = len({k.split(".")[0] for k in state if k.startswith("block")})
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
    return LMSpec(
        vocab_size=vocab_size,
        total_len=total_len,
        d_model=d_model,
        depth=depth,
        num_heads=num_heads,
        num_kv_heads=0 if kv_heads == num_heads else kv_heads,
        mlp_ratio=mlp_dim // d_model,
    )


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
    ``_block_finish`` (:150, dense branch) — shared by the dense
    forward, the chunked prefill and the decode step, so the three
    paths cannot drift apart numerically."""

    def __init__(self, spec: LMSpec):
        super().__init__()
        self.spec = spec
        d = spec.d_model
        self.ln1 = nn.LayerNorm(d, eps=LN_EPS)
        self.attn = Attention(spec)
        self.ln2 = nn.LayerNorm(d, eps=LN_EPS)
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
        [B, T, d] (heads concatenated)."""
        x = x + self.attn.proj(attn_vec)
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
            self.add_module(f"block{i + 1}", Block(spec))
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
        """Dense full-sequence forward — the counterpart of
        ``ddp_tpu.models.lm.dense_lm_apply``."""
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
                      block_fn=None):
        """The training forward → [B, T, vocab] fp32 logits.

        Every parameter is cast to ``compute_dtype`` here, so gradients
        flow back through the cast into the fp32 masters. LayerNorms
        compute in fp32 and cast back (``vit.py:203,215``); ``ln_final``
        and the tied-head logits stay fp32 (``lm.py:129-131``). Under GQA
        K/V are repeated to H heads before attention (``vit.py:152``).
        ``block_fn`` overrides the attention block of the one-rank ring
        (``parallel.ring.default_block_fn`` by default).
        """
        s = self.spec
        p = {
            name: w if w.dtype == compute_dtype else w.to(compute_dtype)
            for name, w in self.named_parameters()
        }

        def norm(x, name):
            return F.layer_norm(
                x.float(), (s.d_model,), p[name + ".weight"].float(),
                p[name + ".bias"].float(), LN_EPS,
            )

        def dense(x, name):
            return F.linear(x, p[name + ".weight"], p[name + ".bias"])

        B, T = tokens.shape
        x = p["embed"][tokens.long()] + p["pos_embed"][:, :T]
        G = s.num_heads // s.kv_heads
        for i in range(1, s.depth + 1):
            b = f"block{i}."
            y = norm(x, b + "ln1").to(x.dtype)
            q, k, v = split_qkv(dense(y, b + "attn.qkv"), s.num_heads,
                                s.kv_heads, s.head_dim)
            if G > 1:
                k = k.repeat_interleave(G, dim=2)
                v = v.repeat_interleave(G, dim=2)
            o = ring_attention(q, k, v, causal=True, block_fn=block_fn)
            x = x + dense(o.reshape(B, T, s.d_model), b + "attn.proj")
            y = norm(x, b + "ln2").to(x.dtype)
            h = F.gelu(dense(y, b + "mlp1"), approximate="tanh")
            x = x + dense(h, b + "mlp2")
        x = norm(x, "ln_final")
        return x @ p["embed"].float().T


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
    mask = torch.ones(tokens.shape[1], device=tokens.device)
    mask[-1] = 0.0
    return targets, mask


def next_token_loss(logits, tokens, *, label_smoothing: float = 0.0):
    """Mean causal-LM loss over the B·(T−1) targets (``lm.py:266``)."""
    targets, mask = _shifted_targets(tokens)
    per_tok = _per_token_nll(logits.float(), targets, label_smoothing)
    return (per_tok * mask).sum() / (mask.sum() * tokens.shape[0])


def _token_metrics(logits, tokens, label_smoothing: float):
    """(mean loss, correct count) over the next-token targets — the
    one-rank ``_make_sharded_token_metrics`` (``lm.py:414``)."""
    targets, mask = _shifted_targets(tokens)
    correct = ((logits.argmax(-1) == targets).float() * mask).sum()
    loss = next_token_loss(logits, tokens, label_smoothing=label_smoothing)
    return loss, correct


def make_lm_train_step(
    model: CausalLM,
    optimizer,
    *,
    compute_dtype=torch.float32,
    grad_accum_steps: int = 1,
    label_smoothing: float = 0.0,
    block_fn=None,
):
    """The one-rank causal-LM step (``lm.py:572``): ``step(tokens) ->
    StepMetrics`` updates ``model``'s parameters in place.

    ``grad_accum_steps=k`` splits the batch into k STRIDED microbatches
    (rows ``i::k``, ``lm.py:650-656``), sums their gradients and divides
    by k. Loss is the mean next-token cross-entropy, accuracy the
    next-token top-1, grad_norm the global norm of the (averaged,
    unclipped) gradient. Metrics stay on the device: no host read.
    """
    params = [p for p in model.parameters() if p.requires_grad]
    if not params:
        raise ValueError("the model has no trainable parameters: build it "
                         "with CausalLM.from_state(..., trainable=True)")

    def loss_and_correct(tokens):
        logits = model.train_forward(
            tokens, compute_dtype=compute_dtype, block_fn=block_fn
        )
        return _token_metrics(logits, tokens, label_smoothing)

    def step(tokens) -> StepMetrics:
        B, T = tokens.shape
        for p in params:
            p.grad = None
        if grad_accum_steps == 1:
            loss, correct = loss_and_correct(tokens)
            loss.backward()
            loss = loss.detach()
        else:
            if B % grad_accum_steps:
                raise ValueError(
                    f"batch {B} not divisible by grad_accum_steps "
                    f"{grad_accum_steps}"
                )
            loss = correct = 0.0
            for i in range(grad_accum_steps):
                l_i, c_i = loss_and_correct(tokens[i::grad_accum_steps])
                l_i.backward()
                loss = loss + l_i.detach()
                correct = correct + c_i
            for p in params:
                p.grad.div_(grad_accum_steps)
            loss = loss / grad_accum_steps
        grads = [p.grad for p in params]
        grad_norm = global_norm(grads)
        optimizer.step()
        return StepMetrics(
            loss=loss, accuracy=correct / (B * (T - 1)), grad_norm=grad_norm
        )

    return step


def make_lm_eval_step(model: CausalLM, *, compute_dtype=torch.float32):
    """Eval over held-out tokens (``lm.py:492``): ``step(tokens,
    weights) -> (Σ w·per-sequence token accuracy, Σ w·per-sequence mean
    loss)``, device scalars; the caller divides by the split size."""

    @torch.no_grad()
    def step(tokens, weights):
        logits = model.train_forward(tokens, compute_dtype=compute_dtype)
        targets, mask = _shifted_targets(tokens)
        logits32 = logits.float()
        per_tok = _per_token_nll(logits32, targets, 0.0)
        denom = tokens.shape[1] - 1
        seq_loss = (per_tok * mask).sum(1) / denom
        seq_acc = ((logits32.argmax(-1) == targets).float() * mask).sum(1) / denom
        w = weights.float()
        return (seq_acc * w).sum(), (seq_loss * w).sum()

    return step


def init_lm_state(spec: LMSpec, *, seed: int = 0) -> dict[str, np.ndarray]:
    """Seeded random weights, made with numpy, as a CausalLM state dict.

    Embeddings draw N(0, 0.02²) and linear weights N(0, 1/fan_in) (the
    scales of Flax's defaults), biases zero, LayerNorms identity.
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
        for name, (n_out, n_in) in (
            ("attn.qkv", (cols, d)), ("attn.proj", (d, d)),
            ("mlp1", (mlp, d)), ("mlp2", (d, mlp)),
        ):
            state[b + name + ".weight"] = normal((n_out, n_in), n_in**-0.5)
            state[b + name + ".bias"] = np.zeros(n_out, f32)
        for ln in ("ln1", "ln2"):
            state[b + ln + ".weight"] = np.ones(d, f32)
            state[b + ln + ".bias"] = np.zeros(d, f32)
    return state


def init_lm(spec: LMSpec, *, seed: int = 0, device=None) -> CausalLM:
    """A seeded random model on ``device`` (the GPU unless ``"cpu"``)."""
    return CausalLM.from_state(spec, init_lm_state(spec, seed=seed), device)
