"""What both pipelined families share (``ddp_tpu/parallel/pipe_common.py``):
the strided microbatch split, and the stacked stage layout and its map
to the ranks. The batch shards over the batch axes (``data``, ``fsdp``
and ``expert``); a data replica's pipe, ``model`` and ``seq`` ranks read
the same rows (``seq`` then takes its columns).

A pipelined model is a front (stage 0's embedding), a body of C = S·v
uniform chunks of ``depth_per_stage`` encoder blocks, and a back (stage
S−1's norm and head). Its full state stacks the chunks' leaves as JAX's
does: ``stages.<leaf>`` is [S, …] (one chunk a stage) or, interleaved,
[v, S, …], chunk c = k·S + d at [k, d] — so rank d of the ``pipe`` axis
holds chunks d, d + S, …, d + (v−1)·S, its local chunk k being global
chunk k·S + d. The front and the back live on every pipe rank, as JAX
replicates them.

Each stage leaf is further cut by JAX's specs (:func:`stage_specs`,
``pipe_common.py:86-175``): Megatron's column and row dims over ``model``
(``parallel/tp``'s rules), a routed block's expert dim over ``expert``,
and ``fsdp`` on a leaf of at least :data:`FSDP_MIN_SIZE` elements (or on
the other dim of a TP or expert kernel), so that a rank holds exactly the
JAX device shard of its index. :class:`PipeLayout` maps a rank's
parameters (``front.*``, ``chunks.<k>.*``, ``back.*``) to that full state
and back, for the checkpoints, gives the optimizer the norm of the whole
model, and gathers the ``fsdp`` leaves for a step (:meth:`PipeLayout.
gathered`: once a step, before the timetable runs; their gradients are
reduce-scattered back, ``scatter_stage_grads``).
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
from torch import nn

from ddp_tpu_torch.parallel.tp import _jax_spec, jax_dim

FSDP_MIN_SIZE = 2**12  # stage leaves smaller than this stay replicated
# The axes the ends' gradients, the loss and the count sum over: pipe,
# the batch axes (``pipe_batch_axes`` :21) and ``seq``, which shards
# tokens (``pipeline_lm.py:648-657``).
ENDS_AXES = ("pipe", "data", "fsdp", "expert", "seq")


def split_microbatch_stream(x, num_microbatches: int, num_stages: int):
    """[B, …] → [M//S, S, mb, …], STRIDED: ``stream[r, s, i] = x[i·M + r·S
    + s]``, microbatch m = r·S + s taking rows ``m::M``
    (``pipe_common.py:36``)."""
    B, M, S = x.shape[0], num_microbatches, num_stages
    if B % M:
        raise ValueError(f"batch {B} not divisible by {M} microbatches")
    if M % S:
        raise ValueError(
            f"{M} microbatches not divisible by {S} pipeline stages "
            "(the sharded stream rests microbatch m on device m mod S)")
    x = x.reshape(B // M, M // S, S, *x.shape[1:])
    return x.permute(1, 2, 0, *range(3, x.dim()))


def split_microbatch_labels(y, num_microbatches: int):
    """[B, …] → [M, mb, …] with the same rows: ``labels[m, i] = y[i·M +
    m]`` (``pipe_common.py:66``)."""
    B, M = y.shape[0], num_microbatches
    if B % M:
        raise ValueError(f"batch {B} not divisible by {M} microbatches")
    return y.reshape(B // M, M, *y.shape[1:]).movedim(1, 0)


def merge_microbatch_stream(out):
    """Invert :func:`split_microbatch_stream`: [R, S, mb, …] → [B, …]."""
    B = out.shape[0] * out.shape[1] * out.shape[2]
    return out.movedim(2, 0).reshape(B, *out.shape[3:])


def microbatches(x, num_microbatches: int) -> list:
    """This rank's rows as the M strided microbatches ``x[m::M]``: a data
    rank holding a contiguous block of the global batch holds its slice
    of every global microbatch (the guard ``mb % data_shards == 0`` makes
    the block whole groups of M rows)."""
    if x.shape[0] % num_microbatches:
        raise ValueError(f"local batch {x.shape[0]} not divisible by "
                         f"{num_microbatches} microbatches")
    return [x[m::num_microbatches] for m in range(num_microbatches)]


def stack_stage_params(param_list) -> dict:
    """[{name: leaf}, …] (one per chunk, same shapes) → {name: stacked}
    (``pipeline.py:227``), numpy or torch."""
    out = {}
    for name in param_list[0]:
        leaves = [p[name] for p in param_list]
        out[name] = (torch.stack(leaves) if torch.is_tensor(leaves[0])
                     else np.stack(leaves))
    return out


def stage_specs(shapes: dict, mesh, *, lead: int, tp: int = 1,
                ep: int = 1) -> dict[str, tuple]:
    """``{leaf: ((chunk dim, axis), ...)}`` for each ``stages.<leaf>`` of
    ``shapes`` (name → the FULL stacked shape, ``lead`` stacked dims) on
    ``mesh`` (``stage_specs_megatron``, ``pipe_common.py:112``): with
    ``tp`` or ``ep`` above one, ``parallel/tp``'s rules on each leaf's own
    JAX layout (Megatron column/row dims over ``model``, the expert dim
    over ``expert``, ``fsdp`` on the other dim where it divides); every
    other leaf of at least :data:`FSDP_MIN_SIZE` elements (stacked) takes
    ``fsdp`` on its first JAX dim that ``fsdp`` divides (``stage_specs``
    :86). A chunk dim is the port's: a Dense ``weight`` is the kernel
    transposed. Leaves not named stay replicated."""
    n = int(mesh.shape.get("fsdp", 1))
    out = {}
    for key, shape in shapes.items():
        if not key.startswith("stages."):
            continue
        leaf, own = key[len("stages."):], tuple(shape)[lead:]
        nd = len(own)
        jshape = own[::-1] if jax_dim(leaf, nd, 0) == 1 else own
        spec = ()
        if tp > 1 or ep > 1:
            spec = _jax_spec(leaf, jshape, tp, ep, n)
            if not {"model", "expert"} & set(spec):
                spec = ()
        if not spec and n > 1 and math.prod(shape) >= FSDP_MIN_SIZE:
            i = next((i for i, s in enumerate(jshape) if s % n == 0), None)
            if i is not None:
                spec = (None,) * i + ("fsdp",)
        pairs = tuple(sorted((jax_dim(leaf, nd, d), axis)
                             for d, axis in enumerate(spec) if axis))
        if pairs:
            out[leaf] = pairs
    return out


class PipeLayout:
    """A pipe rank's parameters ↔ the model's full, stacked state.

    ``names``: the rank's parameter names in the optimizer's order;
    ``num_stages`` S, ``virtual_stages`` v (``interleaved``: the stacked
    lead is [v, S], else [S]); ``comm``: the ``pipe`` group's
    communicator, member d being pipe rank d; ``specs``: each stage
    leaf's cut (:func:`stage_specs`) on ``mesh`` (its coordinates pick
    the rank's piece; its groups gather them).
    """

    def __init__(self, names, *, num_stages: int, virtual_stages: int,
                 interleaved: bool, comm, rank: int, specs=None, mesh=None):
        self.names = list(names)
        self.S, self.V, self.interleaved = num_stages, virtual_stages, \
            interleaved
        self.comm, self.rank = comm, rank
        self.specs, self.mesh = dict(specs or {}), mesh

    @staticmethod
    def split(name: str):
        """``chunks.<k>.<leaf>`` → (k, leaf); any other name → (None,
        name)."""
        if name.startswith("chunks."):
            _, k, leaf = name.split(".", 2)
            return int(k), leaf
        return None, name

    def pairs(self, name: str) -> tuple:
        """The (chunk dim, axis) cuts of the rank's parameter ``name``."""
        k, leaf = self.split(name)
        return () if k is None else self.specs.get(leaf, ())

    def axes(self, name: str) -> frozenset:
        """The axes other than ``pipe`` the parameter ``name`` is cut
        over."""
        return frozenset(axis for _, axis in self.pairs(name))

    def _cut(self, t, pairs):
        for dim, axis in pairs:
            t = torch.as_tensor(t).chunk(self.mesh.shape[axis], dim)[
                self.mesh.coords[axis]]
        return t.contiguous() if pairs else t

    def gather(self, local: dict) -> dict:
        """A rank's tensors → the full state (a collective over ``pipe``
        and each leaf's axes, in one order on every rank): each chunk leaf
        all-gathered over its cuts in fp32, then stacked over the ranks,
        in host memory (a checkpoint's bytes: the card holds one gathered
        leaf at a time), the ends as they are."""
        full, chunks = {}, {}
        for name, t in local.items():
            k, leaf = self.split(name)
            if k is None:
                full[name] = t
                continue
            for dim, axis in self.pairs(name):
                t = self.mesh.comm(axis).all_gather(
                    t.detach().float().contiguous(), dim).to(t.dtype)
            chunks.setdefault(leaf, {})[k] = t
        for leaf, by_k in chunks.items():
            mine = torch.stack([by_k[k] for k in range(len(by_k))])[:, None]
            got = self.comm.all_gather(mine.contiguous(), dim=1).cpu()
            full["stages." + leaf] = got if self.interleaved else got[0]
        return full

    def shard(self, full: dict) -> dict:
        """The full state → this rank's tensors."""
        out = {}
        for name, t in full.items():
            if not name.startswith("stages."):
                out[name] = t
                continue
            leaf = name[len("stages."):]
            pairs = self.specs.get(leaf, ())
            if not self.interleaved:
                out[f"chunks.0.{leaf}"] = self._cut(t[self.rank], pairs)
                continue
            from ddp_tpu_torch.parallel.interleaved import chunk_of

            flat = t.reshape(-1, *t.shape[2:])
            for k in range(self.V):
                out[f"chunks.{k}.{leaf}"] = self._cut(
                    flat[chunk_of(k, self.rank, self.S, self.V)], pairs)
        return out

    def _map_opt(self, opt_state: dict, fn) -> dict:
        out = dict(opt_state)
        for key, bufs in opt_state.items():
            if isinstance(bufs, list) and len(bufs) == len(self.names):
                out[key] = fn(dict(zip(self.names, bufs)))
        return out

    def gather_opt(self, opt_state: dict) -> dict:
        """An optimizer ``state_dict``'s per-parameter buffers as full
        states (a collective), keyed by the full names."""
        return self._map_opt(opt_state, self.gather)

    def shard_opt(self, opt_state: dict) -> dict:
        """:meth:`gather_opt`'s output → this rank's buffer lists."""
        out = dict(opt_state)
        for key, bufs in opt_state.items():
            if isinstance(bufs, dict):
                mine = self.shard(bufs)
                out[key] = [mine[n] for n in self.names]
        return out

    def norm(self, tensors) -> torch.Tensor:
        """√Σ‖g‖² of the whole model, each element counted once: a cut
        leaf's squares summed over its axes, the stages' over ``pipe``,
        the ends' (the same on every rank) and a leaf replicated over
        ``model`` taken as they are."""
        parts, ends = {}, None
        for name, t in zip(self.names, tensors):
            sq = t.float().pow(2).sum()
            if self.split(name)[0] is None:
                ends = sq if ends is None else ends + sq
            else:
                axes = self.axes(name)
                parts[axes] = parts[axes] + sq if axes in parts else sq
        stage = None
        for axes, part in parts.items():  # in one order on every rank
            part = part.reshape(1).clone()
            for axis in sorted(axes):
                part = self.mesh.comm(axis).all_reduce_(part)
            stage = part if stage is None else stage + part
        total = self.comm.all_reduce_(stage)[0]
        return torch.sqrt(total if ends is None else total + ends)

    @contextlib.contextmanager
    def gathered(self, model: nn.Module, *, grad: bool = True):
        """Inside: each ``fsdp``-cut parameter of ``model`` replaced by
        its gather over ``fsdp`` in fp32 (``gather_stages``, once a step
        before the timetable: every microbatch and every rebuilt chunk
        reads it). Yields [(the resting shard, the gathered parameter,
        its fsdp dim)]; the shards are back in place on exit. With
        ``grad`` the gathered ones take gradients (for
        :func:`scatter_stage_grads`)."""
        swaps = []
        for name in self.names:
            dim = next((d for d, a in self.pairs(name) if a == "fsdp"), None)
            if dim is None:
                continue
            path, attr = name.rsplit(".", 1)
            module = model.get_submodule(path)
            shard = module._parameters[attr]
            full = self.mesh.comm("fsdp").all_gather(
                shard.detach().float().contiguous(), dim).to(shard.dtype)
            module._parameters[attr] = nn.Parameter(full, requires_grad=grad)
            swaps.append((module, attr, shard, dim))
        try:
            yield [(shard, module._parameters[attr], dim)
                   for module, attr, shard, dim in swaps]
        finally:
            for module, attr, shard, _ in swaps:
                module._parameters[attr] = shard


def scatter_stage_grads(swaps, comm, *, summed: bool = True) -> None:
    """Each gathered parameter's gradient (the sum over the microbatches)
    reduce-scattered over ``fsdp`` (``comm``) into its resting shard's
    ``.grad`` (``scatter_stage_grads``, ``pipe_common.py:195``). Without
    ``summed`` (a deliberate fault, for the controls) a shard takes its
    own slice of its own gradient, unsummed."""
    for shard, full, dim in swaps:
        g = full.grad if full.grad is not None else torch.zeros_like(full)
        moved = g.float().movedim(dim, 0).contiguous()
        if summed:
            mine = comm.reduce_scatter(moved.reshape(-1)).reshape(
                moved.shape[0] // comm.size, *moved.shape[1:])
        else:
            mine = moved.chunk(comm.size, 0)[comm.rank]
        shard.grad = mine.movedim(0, dim).contiguous().to(shard.dtype)
