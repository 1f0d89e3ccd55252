"""Tensor and expert parallelism for the sequence models
(``ddp_tpu/parallel/tp.py``): which parameter shards over which axis,
Megatron's f/g, the differentiable collectives the models call, and the
shard/gather of a whole state.

Layout per block (``tp.py:9-31``), ``model`` axis of size ``tp``:

- ``attn.qkv`` and ``mlp1`` — COLUMN parallel: the weight's output rows
  (torch's dim 0; the JAX kernel's dim 1) and the bias shard, so each
  member holds whole heads (the fused qkv is head-major, or group-major
  under GQA: whole kv groups) and a slice of the MLP's hidden units;
- ``attn.proj`` and ``mlp2`` — ROW parallel: the weight's input columns
  (torch's dim 1; the kernel's dim 0) shard, each member's partial
  product is summed by one all-reduce, and the bias (replicated) is added
  after it;
- MoE expert weights ``moe.{wi,bi,wo,bo}`` shard their leading (expert)
  dim over ``expert``; the router stays replicated;
- everything else (LayerNorms, the embeddings, the tied head, the
  position table) is replicated over ``model`` and ``expert``;
- ``fsdp`` (``parallel/seq_fsdp``) shards the other dim of a TP or EP
  kernel where it divides, and (JAX's) dim 0 of every other leaf where
  it divides: JAX picks its dims on flax's [in, out] kernels, and
  :func:`jax_dim` maps each pick through the port's [out, in] weights,
  so a rank holds the bytes of the JAX device of its index and a leaf
  JAX leaves replicated stays replicated (the [1, L, d] position table).

The JAX package gets the gradient reductions from the ``shard_map``
transpose (``tp.py:30-40``); eager autograd writes them out. Megatron's
``f`` (identity forward, all-reduce backward, :func:`megatron_f`) sits at
the input of the column products and ``g`` (all-reduce forward, identity
backward, :func:`megatron_g`) at the output of the row products, so a
replicated leaf's gradient is already the same on every ``model`` member
and is never reduced over ``model``. :func:`psum` (all-reduce forward and
backward, ``lax.psum``'s transpose) is the long-context model's pool over
``seq``; :func:`all_to_all` is Ulysses' and the expert layer's exchange,
its backward the inverse exchange. :func:`gather_sharded` is FSDP's
all-gather of each ``fsdp`` dim in fp32, its backward the fp32
reduce-scatter (``lax.all_gather``'s transpose).

:func:`shard_params` slices a full state into one rank's shard, and
:func:`gather_params` all-gathers a rank's shards back into the full
state in fp32; :class:`ShardLayout` does both for a model's parameters
and an optimizer's buffers (the checkpoint holds the full state).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# Name suffixes of the leaves TP and EP shard, in the port's state-dict
# names (``models/lm``, ``models/vit``, ``models/moe``).
_COLUMN_WEIGHTS = ("attn.qkv.weight", "mlp1.weight")
_COLUMN_BIASES = ("attn.qkv.bias", "mlp1.bias")
_ROW_WEIGHTS = ("attn.proj.weight", "mlp2.weight")
_EXPERT = ("moe.wi", "moe.bi", "moe.wo", "moe.bo")
# A deliberate fault for the controls: "unsummed_f" leaves the all-reduce
# out of f's backward (the cross-member sum a rebuilt 1F1B chunk's
# Megatron backward owes its replicated input).
FAULT: str | None = None


def tp_size(mesh) -> int:
    return 1 if mesh is None else int(mesh.shape.get("model", 1))


def ep_size(mesh) -> int:
    return 1 if mesh is None else int(mesh.shape.get("expert", 1))


def fsdp_size(mesh) -> int:
    return 1 if mesh is None else int(mesh.shape.get("fsdp", 1))


def _check_divides(path: str, dim: int, axis: int) -> None:
    if dim % axis:
        raise ValueError(
            f"{path}: dim {dim} not divisible by the sharding axis "
            f"size {axis} (num_heads and mlp_dim must divide by "
            f"--mesh_model; num_experts by --mesh_expert)"
        )


def jax_dim(name: str, ndim: int, dim: int) -> int:
    """The dim of the JAX leaf that dim ``dim`` of the port's ``name`` is
    (and back): a Dense ``weight`` [out, in] is the kernel [in, out]
    transposed, every other leaf has JAX's layout."""
    return 1 - dim if name.endswith(".weight") and ndim == 2 else dim


def _jax_spec(name: str, shape: tuple, tp: int, ep: int, n: int) -> tuple:
    """``tp.py:133-187``'s PartitionSpec of the JAX leaf of ``shape`` (the
    JAX layout) named ``name``: an axis or None for each dim."""
    def fsdp_if(d):
        return "fsdp" if n > 1 and shape[d] > 0 and shape[d] % n == 0 \
            else None

    if ep > 1 and name.endswith(_EXPERT):
        _check_divides(name, shape[0], ep)
        # wi [E, d, mlp] / wo [E, mlp, d]: fsdp rides dim 1 where it
        # divides; biases [E, 1, f] shard the expert dim only.
        if len(shape) > 1 and shape[1] > 1 and fsdp_if(1):
            return ("expert", "fsdp")
        return ("expert",)
    if tp > 1:
        if name.endswith(_COLUMN_WEIGHTS):
            _check_divides(name, shape[1], tp)
            return (fsdp_if(0), "model")
        if name.endswith(_COLUMN_BIASES):
            _check_divides(name, shape[0], tp)
            return ("model",)
        if name.endswith(_ROW_WEIGHTS):
            _check_divides(name, shape[0], tp)
            return ("model", fsdp_if(1))
    return (fsdp_if(0),) if shape else ()


def seq_param_specs(shapes: dict, mesh) -> dict[str, tuple]:
    """``{name: ((dim, axis), ...)}`` for every sharded leaf of a state
    of ``shapes`` (name → FULL shape) on ``mesh`` (``tp.py:133-187``); a
    leaf not named is replicated. JAX's rule runs on the JAX layout of
    each leaf and its dims map back through :func:`jax_dim`, so a rank
    holds the bytes of the JAX device of its index: TP's ``model`` and
    EP's ``expert`` dims, ``fsdp`` on the other kernel dim where it
    divides, and ``fsdp`` on (JAX's) dim 0 for every other leaf where it
    divides. Raises for a dim the axis does not divide, with JAX's
    message."""
    tp, ep, n = tp_size(mesh), ep_size(mesh), fsdp_size(mesh)
    out = {}
    for name, shape in shapes.items():
        shape = tuple(shape)
        nd = len(shape)
        linear = jax_dim(name, nd, 0) == 1
        jshape = shape[::-1] if linear else shape
        pairs = tuple((jax_dim(name, nd, d), axis) for d, axis in
                      enumerate(_jax_spec(name, jshape, tp, ep, n)) if axis)
        if pairs:
            out[name] = tuple(sorted(pairs))
    return out


def shard_params(full: dict, mesh, rank: int | None = None) -> dict:
    """Rank ``rank``'s (default: the mesh's) shard of a full state:
    every sharded leaf sliced at its axes' coordinates, contiguous; the
    replicated leaves as they are."""
    coords = mesh.coords if rank is None else mesh.coords_of(rank)
    specs = seq_param_specs({k: tuple(v.shape) for k, v in full.items()},
                            mesh)
    out = {}
    for k, v in full.items():
        for dim, axis in specs.get(k, ()):
            v = torch.as_tensor(v).chunk(mesh.shape[axis], dim)[coords[axis]]
        out[k] = v.contiguous() if k in specs else v
    return out


def gather_params(local: dict, mesh, specs: dict) -> dict:
    """The full state from every rank's ``local`` shards: each sharded
    leaf all-gathered over its axes in fp32 (a collective: every rank
    calls it), cast back to its dtype; the others as they are."""
    out = {}
    for k, v in local.items():
        if k in specs:
            full = v.detach().float()
            for dim, axis in specs[k]:
                full = mesh.comm(axis).all_gather(full, dim)
            v = full.to(v.dtype)
        out[k] = v
    return out


class ShardLayout:
    """The sharding of a model's parameters on a mesh: ``names`` in
    parameter order (the optimizer's buffer order), ``specs`` the
    :func:`seq_param_specs` of their FULL shapes."""

    def __init__(self, full_shapes: dict, names: list[str], mesh):
        self.mesh, self.names = mesh, list(names)
        self.specs = seq_param_specs(full_shapes, mesh)

    def axes(self, name: str) -> frozenset:
        """The axes leaf ``name`` is sharded over."""
        return frozenset(axis for _, axis in self.specs.get(name, ()))

    def gather(self, local: dict) -> dict:
        return gather_params(local, self.mesh, self.specs)

    def shard(self, full: dict) -> dict:
        return shard_params(full, self.mesh)

    def _map_opt(self, opt_state: dict, fn) -> dict:
        """``opt_state`` with every per-parameter buffer list ``bufs``
        under ``key`` replaced by ``fn(key, {name: buffer})``'s values."""
        out = dict(opt_state)
        for key, bufs in opt_state.items():
            if isinstance(bufs, list) and len(bufs) == len(self.names):
                out[key] = list(fn(key, dict(zip(self.names, bufs)))
                                .values())
        return out

    def gather_opt(self, opt_state: dict) -> dict:
        """An optimizer ``state_dict`` with every per-parameter buffer
        list gathered (a collective)."""
        return self._map_opt(opt_state, lambda _, bufs: self.gather(bufs))

    def shard_opt(self, opt_state: dict) -> dict:
        return self._map_opt(opt_state, lambda _, bufs: self.shard(bufs))

    def norm(self, tensors) -> torch.Tensor:
        """√Σ‖g‖² of the FULL tensors from their local shards: the
        squares of the leaves sharded over the same axes summed, then
        over each of those axes; a replicated leaf's counted once."""
        parts = {}
        for name, t in zip(self.names, tensors):
            axes = self.axes(name)
            sq = t.float().pow(2).sum()
            parts[axes] = parts[axes] + sq if axes in parts else sq
        total = None
        for axes, part in parts.items():
            for axis in sorted(axes):
                part = self.mesh.comm(axis).all_reduce_(part)
            total = part if total is None else total + part
        return torch.sqrt(total)


# ---- differentiable collectives ----------------------------------------


class _F(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if FAULT == "unsummed_f":
            return g, None
        return ctx.comm.all_reduce_(g.contiguous().clone()), None


class _G(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        return comm.all_reduce_(x.contiguous().clone())

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return comm.all_reduce_(x.contiguous().clone())

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.all_reduce_(g.contiguous().clone()), None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, split_dim, concat_dim):
        ctx.args = comm, split_dim, concat_dim
        return comm.all_to_all(x, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        comm, split_dim, concat_dim = ctx.args
        return comm.all_to_all(g.contiguous(), concat_dim, split_dim), \
            None, None, None


class _GatherDim(torch.autograd.Function):
    """All-gather ``x`` along ``dim`` over ``comm``; the backward is the
    reduce-scatter of the cotangent: each member keeps its chunk of the
    sum."""

    @staticmethod
    def forward(ctx, x, comm, dim):
        ctx.args = comm, dim
        return comm.all_gather(x.contiguous(), dim)

    @staticmethod
    def backward(ctx, g):
        comm, dim = ctx.args
        moved = g.movedim(dim, 0).contiguous()
        shard = comm.reduce_scatter(moved.reshape(-1))
        return (shard.reshape(moved.shape[0] // comm.size, *moved.shape[1:])
                .movedim(0, dim)), None, None


class _GatherReplicated(torch.autograd.Function):
    """All-gather ``x`` along ``dim`` over ``comm`` into a tensor every
    member then uses alike; the backward keeps this member's chunk of
    the (already complete) cotangent. The gather rides in fp32 (gloo
    takes no bf16 gather; the round trip is exact)."""

    @staticmethod
    def forward(ctx, x, comm, dim):
        ctx.args = comm, dim
        return comm.all_gather(x.float().contiguous(), dim).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        comm, dim = ctx.args
        return g.chunk(comm.size, dim)[comm.rank].contiguous(), None, None


def gather_replicated(x, comm, dim: int):
    """``x`` sharded along ``dim`` over ``comm`` → the whole of it on
    every member, for a computation they all run alike (the GSPMD
    block's qkv where the heads do not divide ``model``)."""
    return x if comm.size == 1 else _GatherReplicated.apply(x, comm, dim)


def replicated_chunk(x, comm, dim: int):
    """This member's chunk along ``dim`` of ``x``, replicated over
    ``comm``, behind f: the backward sums the members' zero-padded
    chunk cotangents, so ``x``'s gradient is whole on every member (a
    replicated bias in front of a column-parallel product, a replicated
    activation into a row-parallel one)."""
    if comm.size == 1:
        return x
    return megatron_f(x, comm).chunk(comm.size, dim)[comm.rank]


def gather_sharded(x, pairs, mesh):
    """Inside a step: leaf ``x`` (a rank's shard, ``pairs`` its
    :func:`seq_param_specs` entry) with every ``fsdp`` dim all-gathered
    in fp32, before any cast to the compute dtype, so that its transpose
    reduces the gradient in fp32 (``tp.py:204-222``); ``model`` and
    ``expert`` dims stay local: they ARE the tensor and expert
    parallelism."""
    for dim, axis in pairs:
        if axis == "fsdp":
            x = _GatherDim.apply(x.float(), mesh.comm("fsdp"), dim)
    return x


def megatron_f(x, comm):
    """Identity forward; the backward sums the cotangent over ``comm``."""
    return x if comm.size == 1 else _F.apply(x, comm)


def megatron_g(x, comm):
    """Sum over ``comm`` forward; the backward passes the cotangent on."""
    return x if comm.size == 1 else _G.apply(x, comm)


def row_parallel(x, weight, bias, comm):
    """A row-parallel product (``RowParallelDense``, ``vit.py:36-66``):
    this rank's partial ``x·Wᵀ`` summed over ``comm`` by g, then the
    replicated bias; a plain ``F.linear`` without a group."""
    if comm is None or comm.size == 1:
        return F.linear(x, weight, bias)
    return megatron_g(F.linear(x, weight), comm) + bias


def psum(x, comm):
    """Sum over ``comm``, forward and backward (``lax.psum`` and its
    transpose)."""
    return x if comm.size == 1 else _Psum.apply(x, comm)


def all_to_all(x, comm, split_dim: int, concat_dim: int):
    """``lax.all_to_all(tiled=True)`` over ``comm``; the backward is the
    inverse exchange."""
    return x if comm.size == 1 else _AllToAll.apply(x, comm, split_dim,
                                                   concat_dim)


def shard_module(module, mesh) -> ShardLayout:
    """Make ``module`` (holding the FULL parameters) this rank's: each
    sharded parameter's data becomes its shard, in place (the Parameter
    objects stay, so an optimizer built after sees the shards). Returns
    the layout, also left in ``module.shard_layout``."""
    named = list(module.named_parameters())
    layout = ShardLayout({n: tuple(p.shape) for n, p in named},
                         [n for n, p in named if p.requires_grad], mesh)
    local = layout.shard({n: p.detach() for n, p in named})
    with torch.no_grad():
        for n, p in named:
            if n in layout.specs:
                p.data = local[n]
    module.shard_layout = layout
    return layout
