"""Mixture-of-Experts layers and the MoE ViT (``ddp_tpu/models/moe.py``).

Routing is GShard's top-k with capacity, as the JAX ``MoEMLP`` does it
(``moe.py:31-147``): a per-token softmax router in fp32, top-k by an
iterative argmax (``torch.argmax`` returns the first maximum, as
``jnp.argmax`` does; ``torch.topk``'s order and ties are not JAX's), a
position in each expert from one cumsum over the k-major [K·n, E] masks
(first choices take the slots first), assignments past the capacity
``max(1, round(capacity_factor · n · top_k / E))`` dropped (their gate
zeroed before normalisation), and the load-balance aux loss
``E · Σ_e mean_n(gate_e) · mean_n(first-choice_e)``.

Two forms of the same function:

- ``indexed`` (the path every model runs): each kept (token, choice)
  goes to its (expert, slot) row of an [E, C, d] buffer whose empty
  slots are zero, the expert FFN runs as batched matmuls, and each token
  gathers its ≤ top_k rows back, weighted by its gates. Memory is
  O(E·C·d).
- ``onehot`` (the plain version): JAX's own einsums over the one-hot
  ``dispatch`` / ``combine`` [n, E, C] tensors. At ``run_lm_bench``'s n
  of 16384 each is 1.07 G elements, so it is the CPU tests' reference
  and ``chip_smoke.py``'s yardstick at a reduced n, never the model's
  path.

The forward returns its aux loss with its output, ``(y, aux)``, not as
module state, so that autograd sees it. Expert parallelism
(``moe.py:131-145``): given an ``expert`` communicator of ``ep`` ranks,
each holding E/ep experts (``wi``/``bi``/``wo``/``bo`` sharded on their
leading dim, the router replicated), the [E, C, d] dispatch buffer goes
through an all-to-all to [E/ep, ep·C, d] — every rank's slots for this
rank's experts, blocked by source — through the local experts' FFN, and
back by the inverse all-to-all before the combine (``parallel/tp.
all_to_all``: differentiable, its backward the inverse exchange).

:meth:`MoEMLP.serve` is the serving form, the counterpart of
``ddp_tpu/models/generate.py``'s ``_moe_mlp`` (:107-147): no capacity,
every expert's FFN on every token, combined by each token's top-k gates.
It is per token, so a decode step, a prefill chunk and a speculative
verify give a token the same answer whatever else is in the batch, and it
equals the training form wherever training dropped nothing.

Under the image family's GSPMD step (``parallel/spmd``: a ``spmd`` plan
on the module) routing is global, as XLA partitions JAX's ``MoEMLP``
over a batch sharded on the data axes (:func:`route_global`): ``n``
counts every data rank's tokens, so the capacity is
``round(cf · n_global · k / E)``; an assignment's slot is its exclusive
prefix count over all global tokens in rank order, every k=0 choice
ahead of every k=1 choice; the aux loss takes global means. A rank then
dispatches its own kept tokens (the kept ones are a prefix of its
k-major order, so its slots number at most min(C, n_local)); the
buffer goes through the ``expert`` all-to-all to the experts' owners
when the experts shard over ``expert``, the FFN's hidden dim splits over
``model`` when ``wi``/``wo`` shard over it (f before, g after, ``bi``
sliced behind f), and the inverse exchange brings it back.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ddp_tpu_torch.models import vit as _vit
from ddp_tpu_torch.parallel.tp import (
    all_to_all,
    megatron_f,
    megatron_g,
    psum,
    replicated_chunk,
)

GELU_APPROXIMATE = "tanh"  # flax.linen.gelu's default
FORMS = ("indexed", "onehot")
# State-dict names of a routed MLP's parameters, under its module prefix.
PARAM_NAMES = ("router.weight", "router.bias", "wi", "bi", "wo", "bo")


def is_moe_block(i: int, num_experts: int, moe_every: int) -> bool:
    """Block ``i`` (0-based) hosts a routed MLP iff experts are on and
    ``(i + 1) % moe_every == 0`` (``moe.py:150-155``)."""
    return bool(num_experts) and (i + 1) % moe_every == 0


def expert_capacity(n: int, num_experts: int, top_k: int,
                    capacity_factor: float) -> int:
    """Slots per expert for ``n`` tokens (``moe.py:67``; Python's round)."""
    return max(1, int(round(capacity_factor * n * top_k / num_experts)))


class Routing(NamedTuple):
    """One forward's routing decisions, [K, n] each (k-major)."""

    expert: torch.Tensor  # int64: the k-th choice's expert
    slot: torch.Tensor  # int64: its position in that expert (0 if dropped)
    kept: torch.Tensor  # bool: within capacity
    gates: torch.Tensor  # fp32 combine weights, 0 where dropped
    aux: torch.Tensor  # fp32 scalar: the load-balance loss
    capacity: int


def _choices(tokens, router_weight, router_bias, E: int, K: int):
    """The fp32 router's gates [n, E] and the iterative top-k → (gates,
    the one-hot choices [K, n, E], their gate values [K, n], their
    experts [K, n])."""
    gates = torch.softmax(
        F.linear(tokens.float(), router_weight.float(), router_bias.float()),
        dim=-1,
    )  # [n, E]
    experts = torch.arange(E, device=tokens.device)
    remaining = gates
    masks, vals, idxs = [], [], []
    for _ in range(K):
        idx = remaining.argmax(-1)
        mask = (idx[:, None] == experts).float()  # one-hot, no host read
        vals.append((remaining * mask).sum(-1))
        masks.append(mask)
        idxs.append(idx)
        remaining = remaining * (1.0 - mask)
    return gates, torch.stack(masks), torch.stack(vals), torch.stack(idxs)


def _k_major_positions(masks):
    """Each assignment's exclusive count in the k-major order of ``masks``
    [K, n, E]. The cumsum runs along the inner dim of the [E, K·n]
    transpose: a scan down the outer dim of [K·n, E] took ~5 ms a call on
    the card at run_lm_bench's width."""
    K, n, E = masks.shape
    flat = masks.reshape(K * n, E)
    return (flat.t().contiguous().cumsum(1).t() - flat).reshape(K, n, E)


def _gated(vals, in_cap, normalize_gates: bool):
    """(the kept slots' combine weights [K, n], the kept mask [K, n])."""
    kept = in_cap.sum(-1)  # [K, n] 0/1
    gate = vals * kept
    if normalize_gates:
        gate = gate / torch.clamp(gate.sum(0, keepdim=True), min=1e-9)
    return gate, kept > 0


def route(tokens, router_weight, router_bias, *, num_experts: int,
          top_k: int, capacity_factor: float,
          normalize_gates: bool) -> Routing:
    """Route ``tokens`` [n, d] (``moe.py:62-107``). The router computes
    in fp32 over the weights it is given (under bf16 training those are
    the bf16-rounded ones, as JAX's Dense promotes them)."""
    n, E = tokens.shape[0], num_experts
    C = expert_capacity(n, E, top_k, capacity_factor)
    gates, masks, vals, idxs = _choices(tokens, router_weight, router_bias,
                                        E, top_k)
    pos = _k_major_positions(masks)
    in_cap = masks * (pos < C)
    slot = (pos * in_cap).sum(-1).long()
    gate, kept = _gated(vals, in_cap, normalize_gates)
    aux = E * torch.sum(gates.mean(0) * masks[0].mean(0))
    return Routing(idxs, slot, kept, gate, aux, C)


def route_global(tokens, router_weight, router_bias, data, *,
                 num_experts: int, top_k: int, capacity_factor: float,
                 normalize_gates: bool) -> Routing:
    """:func:`route` over the global batch of the data axes' communicator
    ``data`` (this rank's ``tokens`` [n, d], every rank the same n):
    global capacity, global slot order (``moe.py:85-92`` over every
    rank's tokens in rank order) and global aux means. The returned
    ``slot`` is the assignment's row in this rank's buffer of
    ``capacity`` = min(C, n) rows a expert."""
    n, E, K = tokens.shape[0], num_experts, top_k
    dp, me = data.size, data.rank
    C = expert_capacity(n * dp, E, K, capacity_factor)
    gates, masks, vals, idxs = _choices(tokens, router_weight, router_bias,
                                        E, K)
    with torch.no_grad():
        counts = data.all_gather(masks.sum(1)[None], 0)  # [dp, K, E]
        totals = counts.sum(0)
        offset = ((totals.cumsum(0) - totals)  # the earlier choices
                  + counts[:me].sum(0))  # the earlier ranks' of this choice
    # This rank's exclusive count within each choice, placed after the
    # earlier choices and ranks: the global position.
    inner = masks.transpose(1, 2).contiguous().cumsum(-1).transpose(1, 2)
    in_cap = masks * (inner - masks + offset[:, None, :] < C)
    # The kept assignments are a prefix of this rank's k-major order, so
    # their rows in its buffer are their local k-major counts.
    slot = (_k_major_positions(masks) * in_cap).sum(-1).long()
    gate, kept = _gated(vals, in_cap, normalize_gates)
    with torch.no_grad():
        first = data.all_reduce_(masks[0].sum(0))
    aux = E * torch.sum(psum(gates.sum(0), data) / (n * dp)
                        * (first / (n * dp)))
    return Routing(idxs, slot, kept, gate, aux, min(C, n))


def _ffn(xs, w):
    """The expert FFN over [E, rows, d] → [E, rows, d] (tanh GELU)."""
    h = F.gelu(torch.matmul(xs, w["wi"]) + w["bi"], approximate=GELU_APPROXIMATE)
    return torch.matmul(h, w["wo"]) + w["bo"]


def _onehot(r: Routing, E: int):
    """JAX's one-hot tensors: ``in_cap`` [K, n, E], ``slot`` [K, n, C]."""
    dev = r.expert.device
    in_cap = (r.expert[..., None] == torch.arange(E, device=dev)
              ).float() * r.kept[..., None]
    slot = (r.slot[..., None] == torch.arange(r.capacity, device=dev)).float()
    return in_cap, slot


def _dest(r: Routing, E: int):
    """[K, n] row of each assignment in the flat [E·C (+1)] buffer: its
    (expert, slot), or the extra row E·C where it was dropped."""
    return torch.where(r.kept, r.expert * r.capacity + r.slot,
                       torch.full_like(r.expert, E * r.capacity))


def dispatch(tokens, r: Routing, num_experts: int, form: str = "indexed"):
    """``tokens`` [n, d] → the experts' input buffer [E, C, d], empty
    slots zero. ``onehot``: JAX's ``einsum("nec,nd->ecd")`` over the
    [n, E, C] dispatch tensor (``moe.py:99,131``). ``indexed``: each
    (token, k) copied into its (expert, slot) row, a dropped one into an
    extra row that is cut off, so no shape depends on the data. Its
    backward gathers each assignment's row: no two assignments share a
    kept row, so nothing accumulates (a gather into one shared zero row
    instead accumulates in its backward, serially: ~240 ms a step at
    run_lm_bench's width on the card)."""
    n, d = tokens.shape
    E, C, K = num_experts, r.capacity, r.expert.shape[0]
    if form == "onehot":
        in_cap, slot = _onehot(r, E)
        dispatch_ = torch.einsum("kne,knc->nec", in_cap, slot)
        return torch.einsum("nec,nd->ecd", dispatch_.to(tokens.dtype), tokens)
    rows = tokens.new_zeros(E * C + 1, d).index_copy(
        0, _dest(r, E).reshape(-1), tokens.repeat(K, 1))
    return rows[:E * C].view(E, C, d)


def combine(ys, r: Routing, form: str = "indexed"):
    """The experts' output [E, C, d] → [n, d], each token's rows weighted
    by its gates. ``onehot``: JAX's ``einsum("nec,ecd->nd")`` over the
    combine tensor in the compute dtype (``moe.py:100,146``).
    ``indexed``: each token's ≤ K rows gathered (``index_select``: its
    backward adds each row's gradient once), the products summed in fp32
    and rounded once to the compute dtype, as that einsum does."""
    E, C, d = ys.shape
    if form == "onehot":
        in_cap, slot = _onehot(r, E)
        comb = torch.einsum("kne,kn,knc->nec", in_cap, r.gates, slot)
        return torch.einsum("nec,ecd->nd", comb.to(ys.dtype), ys)
    rows = torch.cat([ys.reshape(E * C, d), ys.new_zeros(1, d)])
    dest = _dest(r, E)
    gates = r.gates.to(ys.dtype).float()
    out = sum(gates[k, :, None] * rows.index_select(0, dest[k]).float()
              for k in range(dest.shape[0]))
    return out.to(ys.dtype)


def moe_mlp(x, w, *, num_experts: int, top_k: int = 2,
            capacity_factor: float = 2.0, normalize_gates: bool = True,
            form: str = "indexed", ep=None):
    """The routed MLP on ``x`` [B, T, d] with weights ``w`` (the
    :data:`PARAM_NAMES`, already in the compute dtype) → ``(y [B, T, d],
    aux, routing)``. ``n`` is B·T: the tokens of this forward. ``ep``:
    the ``expert`` communicator; over more than one rank ``w``'s experts
    are this rank's E/ep and the buffer is exchanged around their FFN."""
    if form not in FORMS:
        raise ValueError(f"form {form!r} is not one of {FORMS}")
    B, T, d = x.shape
    tokens = x.reshape(B * T, d)
    r = route(tokens, w["router.weight"], w["router.bias"],
              num_experts=num_experts, top_k=top_k,
              capacity_factor=capacity_factor,
              normalize_gates=normalize_gates)
    xs = dispatch(tokens, r, num_experts, form)
    if ep is not None and ep.size > 1:
        # [E, C, d] → [E/ep, ep·C, d] and back.
        ys = all_to_all(_ffn(all_to_all(xs, ep, 0, 1), w), ep, 1, 0)
    else:
        ys = _ffn(xs, w)
    return combine(ys, r, form).reshape(B, T, d), r.aux, r


class MoEMLP(nn.Module):
    """Top-k routed expert MLP with capacity (``moe.py:31``). Parameters
    keep the Flax layout and names: ``router`` (an ``nn.Linear(d, E)``,
    its weight the Flax kernel transposed), ``wi`` [E, d, F], ``bi`` [E,
    1, F], ``wo`` [E, F, d], ``bo`` [E, 1, d]."""

    def __init__(self, dim: int, mlp_dim: int, num_experts: int, *,
                 top_k: int = 2, capacity_factor: float = 2.0,
                 normalize_gates: bool = True):
        super().__init__()
        E = num_experts
        self.num_experts, self.top_k = E, top_k
        self.capacity_factor = capacity_factor
        self.normalize_gates = normalize_gates
        self.router = nn.Linear(dim, E)
        self.wi = nn.Parameter(torch.zeros(E, dim, mlp_dim))
        self.bi = nn.Parameter(torch.zeros(E, 1, mlp_dim))
        self.wo = nn.Parameter(torch.zeros(E, mlp_dim, dim))
        self.bo = nn.Parameter(torch.zeros(E, 1, dim))
        self.spmd = None  # the GSPMD plan (parallel/spmd.MoEPlan)
        # The ``expert`` communicator of a pipe stage (PP×EP,
        # ``models/pipeline_vit.StageBlocks``): this rank's E/ep experts.
        self.ep = None

    def weights(self, dt=None) -> dict:
        """The parameters by :data:`PARAM_NAMES` (as the module reads
        them: a GSPMD step's gathered tensors where it put them), cast
        to ``dt``."""
        out = {}
        for name in PARAM_NAMES:
            p = getattr(self.router, name.split(".")[1]) \
                if name.startswith("router.") else getattr(self, name)
            out[name] = p if dt is None else p.to(dt)
        return out

    def routed(self, x, w=None, *, form: str = "indexed"):
        """:func:`moe_mlp` with this module's routing config → ``(y, aux,
        routing)``; ``w`` defaults to the module's own weights."""
        return moe_mlp(x, self.weights() if w is None else w,
                       num_experts=self.num_experts, top_k=self.top_k,
                       capacity_factor=self.capacity_factor,
                       normalize_gates=self.normalize_gates, form=form)

    def forward(self, x, dt=None):
        """→ ``(y, aux)`` with the parameters cast to ``dt`` (the compute
        dtype; default ``x``'s)."""
        if self.spmd is not None:
            y, aux, _ = self.routed_spmd(x, self.weights(dt or x.dtype))
            return y, aux
        y, aux, _ = moe_mlp(x, self.weights(dt or x.dtype),
                            num_experts=self.num_experts, top_k=self.top_k,
                            capacity_factor=self.capacity_factor,
                            normalize_gates=self.normalize_gates, ep=self.ep)
        return y, aux

    def routed_spmd(self, x, w):
        """The GSPMD form (module docstring) → ``(y, aux, routing)``."""
        plan = self.spmd
        B, T, d = x.shape
        tokens = x.reshape(B * T, d)
        r = route_global(tokens, w["router.weight"], w["router.bias"],
                         plan.data, num_experts=self.num_experts,
                         top_k=self.top_k,
                         capacity_factor=self.capacity_factor,
                         normalize_gates=self.normalize_gates)
        xs = dispatch(tokens, r, self.num_experts)
        ep = plan.ep if plan.experts_sharded else None
        if ep is not None and ep.size > 1:
            xs = all_to_all(xs, ep, 0, 1)  # [E/ep, ep·C, d]
        tp = plan.tp
        if "wi" in plan.sharded:  # the hidden dim over model
            h = torch.matmul(megatron_f(xs, tp), w["wi"]) \
                + replicated_chunk(w["bi"], tp, -1)
        else:
            h = torch.matmul(xs, w["wi"]) + w["bi"]
        h = F.gelu(h, approximate=GELU_APPROXIMATE)
        if "wo" in plan.sharded:
            ys = megatron_g(torch.matmul(h, w["wo"]), tp) + w["bo"]
        else:
            ys = torch.matmul(h, w["wo"]) + w["bo"]
        if ep is not None and ep.size > 1:
            ys = all_to_all(ys, ep, 1, 0)
        return combine(ys, r).reshape(B, T, d), r.aux, r

    def serve(self, x, *, top_k: int, normalize_gates: bool):
        """The serving form (``generate.py:107-147``): no capacity; each
        token's top-k gates by the same iterative argmax, normalised as
        asked, over a dense E-way FFN in ``x``'s dtype."""
        B, T, d = x.shape
        toks = x.reshape(B * T, d)
        gates = torch.softmax(
            F.linear(toks.float(), self.router.weight.float(),
                     self.router.bias.float()), dim=-1)  # [n, E] fp32
        experts = torch.arange(gates.shape[-1], device=x.device)
        remaining = gates
        comb = torch.zeros_like(gates)
        for _ in range(top_k):
            mask = (remaining.argmax(-1)[:, None] == experts).float()
            comb = comb + remaining * mask
            remaining = remaining * (1.0 - mask)
        if normalize_gates:
            comb = comb / torch.clamp(comb.sum(-1, keepdim=True), min=1e-9)
        dt = x.dtype
        y = _ffn(toks, {k: getattr(self, k).to(dt)
                        for k in ("wi", "bi", "wo", "bo")})  # [E, n, d]
        return torch.einsum("ne,end->nd", comb.to(dt), y).reshape(B, T, d)


def moe_init(state: dict, prefix: str, rng, *, dim: int, mlp_dim: int,
             num_experts: int) -> None:
    """Seeded numpy weights of a routed MLP into ``state`` under
    ``prefix``: Flax's scales, untruncated. ``lecun_normal`` on a 3-D
    kernel counts the expert axis as receptive field, so ``wi`` draws
    N(0, 1/(E·d)) and ``wo`` N(0, 1/(E·F)); the router (a Dense) N(0,
    1/d); biases zero."""
    f32 = np.float32
    E = num_experts

    def normal(shape, fan_in):
        return (rng.standard_normal(shape, dtype=f32)
                * f32(fan_in ** -0.5)).astype(f32)

    state[prefix + "router.weight"] = normal((E, dim), dim)
    state[prefix + "router.bias"] = np.zeros(E, f32)
    state[prefix + "wi"] = normal((E, dim, mlp_dim), E * dim)
    state[prefix + "bi"] = np.zeros((E, 1, mlp_dim), f32)
    state[prefix + "wo"] = normal((E, mlp_dim, dim), E * mlp_dim)
    state[prefix + "bo"] = np.zeros((E, 1, dim), f32)


# ---- MoE ViT ------------------------------------------------------------


class MoEEncoderBlock(nn.Module):
    """Pre-LN block whose MLP is routed (``moe.py:158``): ``x + attn(ln1
    x)``, then ``x + moe(ln2 x)`` → ``(x, aux)``."""

    def __init__(self, dim: int, num_heads: int, mlp_dim: int,
                 num_experts: int, *, top_k: int = 2,
                 capacity_factor: float = 2.0, normalize_gates: bool = True,
                 num_kv_heads: int = 0, attention_fn=None):
        super().__init__()
        self.ln1 = nn.LayerNorm(dim)
        self.attn = _vit.MultiHeadAttention(dim, num_heads,
                                            num_kv_heads=num_kv_heads,
                                            attention_fn=attention_fn)
        self.ln2 = nn.LayerNorm(dim)
        self.moe = MoEMLP(dim, mlp_dim, num_experts, top_k=top_k,
                          capacity_factor=capacity_factor,
                          normalize_gates=normalize_gates)

    def forward(self, x, dt):
        x = x + self.attn(_vit._layer_norm(self.ln1, x, dt).to(x.dtype), dt)
        y, aux = self.moe(_vit._layer_norm(self.ln2, x, dt).to(x.dtype), dt)
        return x + y, aux


class MoEViT(_vit.ViT):
    """ViT whose every ``moe_every``-th block routes its MLP to experts
    (``moe.py:218``): no cls token, mean-pooled, the other blocks dense.
    ``forward(x, compute_dtype, with_aux=True)`` also returns the sum of
    the routed blocks' aux losses (the image step adds 0.01 × that sum,
    ``parallel/common.py:103-106``)."""

    routed = True  # the image step asks for the aux loss

    def __init__(self, num_classes: int = 100, patch_size: int = 4,
                 embed_dim: int = 192, depth: int = 12, num_heads: int = 3,
                 mlp_ratio: int = 4, *, num_experts: int = 8, top_k: int = 2,
                 capacity_factor: float = 2.0, moe_every: int = 2,
                 attention_fn=None, side: int = 32, in_channels: int = 3,
                 remat: bool = False):
        super().__init__(num_classes, patch_size, embed_dim, depth,
                         num_heads, mlp_ratio, use_cls_token=False,
                         attention_fn=attention_fn, side=side,
                         in_channels=in_channels, remat=remat)
        self.num_experts, self.moe_every = num_experts, moe_every
        mlp_dim = embed_dim * mlp_ratio
        for i, name in enumerate(self.block_names):
            if is_moe_block(i, num_experts, moe_every):
                setattr(self, name, MoEEncoderBlock(
                    embed_dim, num_heads, mlp_dim, num_experts, top_k=top_k,
                    capacity_factor=capacity_factor,
                    attention_fn=attention_fn))

    def init_state(self, seed: int = 0) -> dict[str, np.ndarray]:
        """The ViT's seeded initialisation for every dense leaf, and
        :func:`moe_init`'s scales for the routed MLPs."""
        state = super().init_state(seed)
        rng = np.random.default_rng([seed, 1])
        for name in self.block_names:
            blk = getattr(self, name)
            if isinstance(blk, MoEEncoderBlock):
                E, d, F_ = blk.moe.wi.shape
                moe_init(state, f"{name}.moe.", rng, dim=d, mlp_dim=F_,
                         num_experts=E)
        return state


def MoEViTTiny(num_classes: int = 100, depth: int = 12, **kw) -> MoEViT:
    """``vit_moe_tiny`` (``moe.py:287``): d 192, 3 heads, 8 experts,
    top-2, capacity factor 2.0, every 2nd block routed; 64 tokens at
    32×32, patch 4."""
    kw.setdefault("num_experts", 8)
    return MoEViT(num_classes, embed_dim=192, depth=depth, num_heads=3, **kw)


def moe_vit_micro(num_classes: int = 10, depth: int = 2, **kw) -> MoEViT:
    """``vit_moe_micro``: patch 7, d 32, 4 heads, 4 experts, every 2nd
    block routed (``ddp_tpu/models/__init__.py:64-69``)."""
    kw.setdefault("num_experts", 4)
    return MoEViT(num_classes, patch_size=7, embed_dim=32, depth=depth,
                  num_heads=4, moe_every=2, **kw)
