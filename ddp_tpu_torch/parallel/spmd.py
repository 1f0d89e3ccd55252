"""The GSPMD step for the image family (``ddp_tpu/parallel/spmd.py``):
``--mesh_model``, ``--mesh_fsdp``, ``--mesh_expert`` and ``--zero1`` for
SimpleCNN, the ResNets, the ViTs and the MoE ViTs.

JAX's step annotates: each parameter gets a ``PartitionSpec`` from
:class:`ShardingRules`, the batch is sharded over the data axes, and XLA's
partitioner inserts the collectives, so the step computes what one
device would compute on the global batch. Eager torch writes that out,
rank by rank (``runtime/mesh``: rank r is the JAX device of index r):

- **Layout at rest** (:class:`SpmdLayout`). JAX's rules run on the JAX
  layout of every leaf (``interop/jax_params.LeafMap``: a Dense kernel
  is the port's ``weight`` transposed, a conv kernel HWIO is the port's
  OIHW permuted, SimpleCNN's head re-gathered from NCHW to NHWC order),
  and a sharded leaf is held as this rank's contiguous chunk OF THAT
  LAYOUT: the very bytes of the JAX device of its index. Replicated leaves keep the
  port's layout. Column kernels (``qkv``, ``mlp1``, ``moe/wi``) shard
  their output dim over ``model``, row kernels (``proj``, ``mlp2``,
  ``moe/wo``) their input dim; biases stay replicated; expert tensors
  shard dim 0 over ``expert``; a leaf of at least MIN_SHARD_SIZE
  elements shards its largest still-unsharded dim that divides over
  ``fsdp`` (ties to the lower JAX dim). The optimizer's buffers mirror
  their parameters, or under ``--zero1`` take :func:`zero1_spec_for` on
  ``data`` while the parameters stay whole. BatchNorm's running
  statistics are replicated.
- **The step** (:func:`make_spmd_train_step`). Each rank takes its rows
  of the global batch (sharded over data × fsdp × expert, contiguous in
  the data rank's order; ranks that differ only in ``model`` take the
  same rows); :meth:`SpmdLayout.materialize` all-gathers every ``fsdp``
  dim in fp32 (``parallel/tp.gather_sharded``: its backward is the
  reduce-scatter) and turns each leaf into the port's layout, and the
  model runs on those tensors (``parallel/seq_fsdp.swapped``). The
  blocks' GSPMD forms (:func:`prepare`) do what the partitioner does
  for them: Megatron's f/g around the ``model``-sharded kernels, the
  replicated biases sliced behind f, a gather of the qkv activations
  where the heads do not divide ``model``; BatchNorm normalises by the
  moments of the global batch (a differentiable all-reduce over the
  data axes); MoE routing is global (capacity, slot order and aux loss
  over every data rank's tokens) with each expert's FFN on its owner.
  Then each gradient is summed once over the data axes it is partial
  on (``seq_fsdp.reduce_gradients``: less ``fsdp`` after the
  reduce-scatter, less ``expert`` after the all-to-all, never over
  ``model``) and divided by the data replicas; the optimizer runs on
  the shards (``--zero1``: on its data slice of every state leaf, then
  an all-gather of the parameters, ``train/optim.Zero1Optimizer``).
- **Accumulation** (``--grad_accum_steps k``): microbatch i is the
  global rows i::k (``spmd.py:294-313``), on a rank its local rows
  i::k.

Checkpoints hold the full state in the port's layout
(:meth:`SpmdLayout.gather` / :meth:`SpmdLayout.shard`), so a run resumes
under another mesh, another strategy or the plain DDP step.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Any

import torch

from ddp_tpu_torch.data.augment import step_key
from ddp_tpu_torch.interop.jax_params import leaf_maps
from ddp_tpu_torch.parallel.common import (
    _preprocess,
    check_accum_divisible,
    precision,
    xent,
)
from ddp_tpu_torch.parallel.ddp import StepMetrics, _loss_and_correct
from ddp_tpu_torch.parallel.seq_fsdp import reduce_gradients, swapped
from ddp_tpu_torch.parallel.tp import ShardLayout, gather_sharded

MIN_SHARD_SIZE = 2**12  # leaves smaller than this stay replicated
DATA_AXES = ("data", "fsdp", "expert")


def _sizes(mesh) -> dict:
    return dict(getattr(mesh, "shape", mesh))


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Name pattern → parallel style, matched against a leaf's JAX path
    joined by "/" (``spmd.py:56-103``)."""

    column: tuple[str, ...] = ("qkv", "mlp1", "moe/wi")
    row: tuple[str, ...] = ("proj", "mlp2", "moe/wo")
    expert: tuple[str, ...] = (r"moe/(wi|wo|bi|bo)",)
    fsdp_min_size: int = MIN_SHARD_SIZE

    def spec_for(self, path: tuple[str, ...], shape: tuple[int, ...],
                 mesh) -> tuple:
        """The spec (an axis or None a dim) of the JAX leaf at ``path`` of
        JAX ``shape``."""
        sizes = _sizes(mesh)
        tp, fsdp, ep = (sizes.get(a, 1) for a in ("model", "fsdp", "expert"))
        spec: list[Any] = [None] * len(shape)
        name = "/".join(path)
        if (ep > 1 and shape and any(re.search(p, name) for p in self.expert)
                and shape[0] % ep == 0):
            spec[0] = "expert"
        if tp > 1 and len(shape) >= 2:
            if (any(re.search(p, name) for p in self.column)
                    and shape[-1] % tp == 0):
                spec[-1] = "model"
            elif (any(re.search(p, name) for p in self.row)
                  and shape[-2] % tp == 0):
                spec[-2] = "model"
        if math.prod(shape) >= self.fsdp_min_size:
            _shard_largest_dim(spec, shape, "fsdp", fsdp)
        return tuple(spec)


def _shard_largest_dim(spec: list, shape, axis: str, size: int) -> list:
    """``axis`` on the largest still-unsharded dim that divides by
    ``size`` (a stable sort: ties go to the lower dim)."""
    if size > 1:
        for i in sorted(range(len(shape)), key=lambda j: -shape[j]):
            if spec[i] is None and shape[i] % size == 0:
                spec[i] = axis
                break
    return spec


def zero1_spec_for(shape, mesh, *, min_size: int = MIN_SHARD_SIZE) -> tuple:
    """ZeRO-1's layout of a state leaf of JAX ``shape``: its largest
    fitting dim over ``data`` (``spmd.py:143-150``)."""
    spec: list = [None] * len(shape)
    if math.prod(shape) >= min_size:
        _shard_largest_dim(spec, shape, "data", _sizes(mesh).get("data", 1))
    return tuple(spec)


def check_zero1_mesh(mesh) -> None:
    """``spmd.py:153-168``: ZeRO-1 is for pure data-parallel meshes."""
    sizes = _sizes(mesh)
    bad = {a: sizes[a] for a in ("model", "fsdp", "expert")
           if sizes.get(a, 1) > 1}
    if bad:
        raise ValueError(
            f"zero1 only composes with pure data-parallel meshes; "
            f"{bad} already shard optimizer state via the rule layout "
            f"(fsdp IS ZeRO-3) — drop --zero1 or the mesh axes"
        )


def batch_spec(mesh) -> tuple:
    """The batch dim's spec (``spmd.py:188-198``): the data axes of size
    above one, or None."""
    sizes = _sizes(mesh)
    axes = tuple(a for a in ("dcn",) + DATA_AXES if sizes.get(a, 1) > 1)
    return (axes if axes else None,)


def param_specs(shapes: dict, mesh, rules: ShardingRules | None = None
                ) -> dict[str, tuple]:
    """JAX's spec of every leaf of ``shapes`` (port name → port shape):
    an axis or None per dim of the leaf's JAX layout (``spmd.py:117``)."""
    rules = rules or ShardingRules()
    return {n: rules.spec_for(m.path, m.jax_shape, mesh)
            for n, m in leaf_maps(shapes).items()}


def _pairs(spec) -> tuple:
    return tuple((d, a) for d, a in enumerate(spec or ()) if a)


class SpmdLayout(ShardLayout):
    """The GSPMD layout of a model's parameters (``names``, the trainable
    ones in parameter order) on ``mesh``: ``specs`` holds the JAX spec
    of each sharded parameter (an axis or None a dim of its JAX layout,
    where ``parallel/tp.ShardLayout``'s are ``(dim, axis)`` pairs of the
    port's), ``state_specs`` that of each sharded optimizer buffer (the
    parameter's, or under ``zero1`` its ZeRO-1 slice). A sharded leaf is
    held as the chunk of its JAX layout, not of the port's: SimpleCNN's
    head is a reshape of JAX's kernel, which no map of dims reaches.
    ``axes``, ``norm`` and the optimizer-state walk are ``ShardLayout``'s;
    ``train/checkpoint.CheckpointManager`` and ``seq_fsdp.reduce_gradients``
    use it as one."""

    def __init__(self, shapes: dict, names: list[str], mesh, *,
                 zero1: bool = False, rules: ShardingRules | None = None):
        if zero1:
            check_zero1_mesh(mesh)
        self.mesh, self.names = mesh, list(names)
        self.maps = leaf_maps({n: tuple(s) for n, s in shapes.items()})
        full = param_specs({n: shapes[n] for n in self.names}, mesh, rules)
        self.specs = {n: s for n, s in full.items() if _pairs(s)}
        if zero1:
            state = {n: zero1_spec_for(self.maps[n].jax_shape, mesh)
                     for n in self.names}
            self.state_specs = {n: s for n, s in state.items() if _pairs(s)}
        else:
            self.state_specs = self.specs

    def axes(self, name: str) -> frozenset:
        """The axes parameter ``name`` is sharded over."""
        return frozenset(a for _, a in _pairs(self.specs.get(name)))

    # ---- one leaf -----------------------------------------------------

    def shard_leaf(self, name: str, full, spec=None):
        """This rank's shard of the full port-layout ``full``: the
        contiguous chunk of its JAX layout, or ``full`` itself where
        ``spec`` (default: the parameter's) shards nothing."""
        spec = self.specs.get(name) if spec is None else spec
        if not _pairs(spec):
            return full
        t = self.maps[name].to_jax(torch.as_tensor(full))
        for d, a in _pairs(spec):
            t = t.chunk(self.mesh.shape[a], d)[self.mesh.coords[a]]
        return t.contiguous()

    def gather_leaf(self, name: str, local, spec=None) -> torch.Tensor:
        """The full port-layout leaf from every rank's ``local`` shards (a
        collective over the spec's axes, in fp32), in its dtype."""
        spec = self.specs.get(name) if spec is None else spec
        if not _pairs(spec):
            return local
        t = local.detach().float()
        for d, a in _pairs(spec):
            t = self.mesh.comm(a).all_gather(t, d)
        return self.maps[name].to_port(t).contiguous().to(local.dtype)

    # ---- a state --------------------------------------------------------

    def gather(self, local: dict, specs: dict | None = None) -> dict:
        specs = self.specs if specs is None else specs
        return {k: self.gather_leaf(k, v, specs[k]) if k in specs else v
                for k, v in local.items()}

    def shard(self, full: dict, specs: dict | None = None) -> dict:
        specs = self.specs if specs is None else specs
        return {k: self.shard_leaf(k, v, specs[k]) if k in specs else v
                for k, v in full.items()}

    def _specs_of(self, key: str) -> dict:
        """The specs of an optimizer buffer list: the EMA follows its
        parameters, the moments ``state_specs``."""
        return self.specs if key == "ema" else self.state_specs

    def gather_opt(self, opt_state: dict) -> dict:
        """An optimizer ``state_dict`` with every per-parameter buffer
        gathered to the full port layout (a collective)."""
        return self._map_opt(
            opt_state, lambda key, bufs: self.gather(bufs, self._specs_of(key)))

    def shard_opt(self, opt_state: dict) -> dict:
        return self._map_opt(
            opt_state, lambda key, bufs: self.shard(bufs, self._specs_of(key)))

    # ---- in a step --------------------------------------------------------

    def materialize(self, model) -> dict:
        """``{name: tensor}`` of every sharded parameter in the port's
        layout, its ``fsdp`` dims gathered (differentiable: the backward
        reduce-scatters), its ``model`` and ``expert`` dims this rank's."""
        out = {}
        for n, p in model.named_parameters():
            spec = self.specs.get(n)
            if spec is not None:
                out[n] = self.maps[n].to_port(
                    gather_sharded(p, _pairs(spec), self.mesh))
        return out


def shard_model(model, mesh, *, zero1: bool = False) -> SpmdLayout:
    """Make ``model`` (holding the FULL state) this rank's: each sharded
    parameter's data becomes its JAX-layout shard, in place (the
    Parameter objects stay, so an optimizer built after sees the
    shards), and the blocks take their GSPMD forms (:func:`prepare`).
    Returns the layout, also left in ``model.shard_layout``."""
    named = list(model.named_parameters())
    shapes = {n: tuple(p.shape) for n, p in named}
    layout = SpmdLayout(shapes, [n for n, p in named if p.requires_grad],
                        mesh, zero1=zero1)
    with torch.no_grad():
        for n, p in named:
            if n in layout.specs:
                p.data = layout.shard_leaf(n, p.detach())
    model.shard_layout = layout
    prepare(model, mesh, layout)
    return layout


@dataclasses.dataclass
class BlockPlan:
    """What a block's GSPMD form needs: the ``model`` communicator and
    the names of its kernels that JAX's rules shard over it (``qkv``,
    ``proj``, ``mlp1``, ``mlp2``, ``wi``, ``wo``)."""

    tp: Any
    sharded: frozenset


def prepare(model, mesh, layout: SpmdLayout) -> None:
    """Put every block of ``model`` in its GSPMD form on ``mesh``: the
    attention through ``ops/attention.gspmd_flash_attention``, the
    blocks' ``spmd`` plans, BatchNorm's ``sync`` over the data axes and
    the routed MLPs' global routing."""
    from ddp_tpu_torch.models.moe import MoEMLP
    from ddp_tpu_torch.models.resnet import BatchNorm
    from ddp_tpu_torch.models.vit import EncoderBlock, MultiHeadAttention
    from ddp_tpu_torch.ops.attention import gspmd_flash_attention

    data = mesh.comm(*DATA_AXES)
    tp = mesh.comm("model")
    attention = gspmd_flash_attention(mesh)
    for prefix, mod in model.named_modules():
        pre = prefix + "." if prefix else ""
        model_sharded = frozenset(
            n[len(pre):].removesuffix(".weight") for n in layout.specs
            if n.startswith(pre) and "model" in layout.axes(n))
        if isinstance(mod, MultiHeadAttention):
            if mod.num_kv_heads != mod.num_heads:
                raise ValueError("the GSPMD ViT block is multi-head "
                                 "attention (no grouped-query heads)")
            if mod.attention_fn is None:
                mod.attention_fn = attention
            mod.spmd = BlockPlan(tp, model_sharded)
        elif isinstance(mod, EncoderBlock):
            mod.spmd = BlockPlan(tp, model_sharded)
        elif isinstance(mod, MoEMLP):
            mod.spmd = MoEPlan(tp, model_sharded, data, mesh.comm("expert"),
                               "expert" in layout.axes(pre + "wi"))
        elif isinstance(mod, BatchNorm):
            mod.sync = data


@dataclasses.dataclass
class MoEPlan(BlockPlan):
    """A routed MLP's: the data axes' communicator (global routing), the
    ``expert`` one, and whether its experts are sharded over it."""

    data: Any = None
    ep: Any = None
    experts_sharded: bool = False


# ---- the steps ---------------------------------------------------------


def _augment_rows(augment_fn, start: int):
    """``augment_fn`` drawing rows ``start``.. of the global microbatch:
    the draws world 1 makes for these rows."""
    if augment_fn is None:
        return None
    return lambda key, x: augment_fn(key, x, start=start)


def make_spmd_train_step(
    state,
    mesh,
    *,
    compute_dtype=torch.float32,
    grad_accum_steps: int = 1,
    label_smoothing: float = 0.0,
    augment_fn=None,
    seed: int = 0,
):
    """``step(images, labels) -> StepMetrics`` (``spmd.py:246-348``):
    this rank's rows of the global batch through the model's GSPMD form
    (``state.model`` made by :func:`shard_model`), the gradients reduced
    over the data axes they are partial on, one optimizer update on the
    shards. The loss is the global batch's mean (plus the routed blocks'
    weighted aux loss, global), accuracy Σcorrect over the global batch,
    grad_norm the norm of the whole gradient. ``grad_accum_steps=k``:
    microbatch i is this rank's rows i::k. Augmentation draws each row
    as world 1 draws it (the key of step and microbatch, the row's place
    in the global microbatch)."""
    model, optimizer = state.model, state.optimizer
    layout: SpmdLayout = model.shard_layout
    named = dict(model.named_parameters())
    names = layout.names
    params = [named[n] for n in names]
    dp, drank, k = mesh.data_size, mesh.data_rank, grad_accum_steps

    def step(images, labels) -> StepMetrics:
        n = labels.shape[0]
        mb = check_accum_divisible(n, k)
        model.train()
        for p in params:
            p.grad = None
        aug = _augment_rows(augment_fn, drank * mb)
        loss = correct = 0.0
        with precision(compute_dtype):
            for i in range(k):
                x, y = (images, labels) if k == 1 else (images[i::k],
                                                        labels[i::k])
                key = augment_fn and step_key(seed, state.step, 0, i)
                with swapped(model, layout.materialize(model)):
                    l_i, c_i = _loss_and_correct(
                        model, x, y, compute_dtype, label_smoothing, aug, key)
                    l_i.backward()
                loss, correct = loss + l_i.detach(), correct + c_i
        rest = reduce_gradients(params, names, layout, mesh,
                                [loss / k, correct], accum=k)
        grad_norm = layout.norm([p.grad for p in params])
        optimizer.step()
        state.step += 1
        loss, correct = rest
        return StepMetrics(loss=loss, accuracy=correct / (n * dp),
                           grad_norm=grad_norm)

    return step


def make_spmd_eval_step(model, mesh, *, compute_dtype=torch.float32):
    """``step(images, labels, weights) -> (Σ w·correct, Σ w·loss)`` over
    the global batch (``spmd.py:351-368``): each data replica's sums
    counted once (summed over the data axes, not ``model``)."""
    layout = model.shard_layout
    data = mesh.comm(*DATA_AXES)

    @torch.no_grad()
    def step(images, labels, weights):
        model.eval()
        with precision(compute_dtype), swapped(model,
                                               layout.materialize(model)):
            logits = model(_preprocess(images, compute_dtype),
                           compute_dtype=compute_dtype).float()
        w = weights.float()
        out = torch.stack([
            ((logits.argmax(-1) == labels.long()).float() * w).sum(),
            (xent(logits, labels) * w).sum(),
        ])
        data.all_reduce_(out)
        return out[0], out[1]

    return step
