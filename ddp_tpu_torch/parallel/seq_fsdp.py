"""FSDP (ZeRO-3 style) parameter sharding for the sequence models
(``ddp_tpu/parallel/seq_fsdp.py``): ``--mesh_fsdp N`` for ``--model
causal_lm`` and ``long_context``, alone or with ``seq``, ``model`` and
``expert``.

- At rest every leaf that ``parallel/tp.seq_param_specs`` gives an
  ``fsdp`` dim (JAX's ``fsdp_specs`` rule, dim 0 where it divides, at
  ``model`` and ``expert`` of one) lives as this rank's chunk of it, and the optimizer's
  moments, made after the shards by ``zeros_like``, shard with it: the
  parameters, the gradients and the moments all divide by the axis size.
- In a step :func:`gather_fsdp` all-gathers every ``fsdp`` dim in fp32
  (``parallel/tp.gather_sharded``, one all-gather a leaf) and the model
  runs on the full tensors; the backward of each gather is the fp32
  reduce-scatter, so each rank receives its chunk's gradient summed over
  ``fsdp``. JAX derives that half from ``all_gather``'s transpose; here
  it is the gather's ``torch.autograd.Function``.
- ``fsdp`` is a data axis (``runtime/mesh.data_axes``): the members of an
  ``fsdp`` group take different rows of the batch and see the same
  gathered weights. :func:`reduce_gradients` reduces every leaf's
  gradient exactly once over each axis on which it is partial: the data
  axes and ``seq``, less ``fsdp`` where the gather's reduce-scatter
  already summed it and less ``expert`` where the expert all-to-all did,
  never over ``model`` (Megatron's f/g made the replicated leaves
  whole), and divides it by the data replicas (data × fsdp × expert):
  the loss is a mean over the global batch.

:func:`swapped` puts the gathered tensors in place of a module's
parameters for a whole forward and backward (the long-context model's
modules read their weights as attributes, and ``--remat`` recomputes a
block in the backward); the causal LM's forward takes them as an
argument.
"""

from __future__ import annotations

import contextlib

import torch

from ddp_tpu_torch.parallel.ddp import bucket_all_reduce
from ddp_tpu_torch.parallel.tp import fsdp_size, gather_sharded

# The negative controls of the tests and of the card's smoke check: a
# deliberately wrong reduction, or None. "drop_scale" leaves an fsdp
# leaf's gradient unscaled by the fsdp axis (its reduce-scatter's 1/n
# dropped); "double" all-reduces an fsdp leaf over the data axes with
# fsdp again after its reduce-scatter.
FAULT: str | None = None


def gather_fsdp(model, layout, mesh) -> dict:
    """``{name: tensor}`` of ``model``'s parameters with every ``fsdp``
    dim gathered (differentiable); a leaf without one is the parameter
    itself."""
    return {n: gather_sharded(p, layout.specs.get(n, ()), mesh)
            for n, p in model.named_parameters()}


def has_fsdp(layout) -> bool:
    return layout is not None and any(
        "fsdp" in layout.axes(n) for n in layout.specs)


@contextlib.contextmanager
def swapped(module, tensors: dict):
    """``module`` with each parameter named in ``tensors`` read as its
    tensor until the block exits: an instance attribute shadows the
    registered parameter, which stays registered (and in its place in
    ``named_parameters()``). A forward and its backward run inside."""
    shadowed = []
    try:
        for name, t in tensors.items():
            path, _, attr = name.rpartition(".")
            mod = module.get_submodule(path)
            if mod._parameters.get(attr) is not t:
                object.__setattr__(mod, attr, t)
                shadowed.append((mod, attr))
        yield module
    finally:
        for mod, attr in shadowed:
            del mod.__dict__[attr]


def _groups(layout, names):
    """The axes each leaf's gradient is summed over: the data axes and
    ``seq``, less those its reduce-scatter or all-to-all summed."""
    base = ("data", "fsdp", "expert", "seq")
    out = []
    for n in names:
        axes = layout.axes(n) if layout is not None else frozenset()
        drop = axes & {"fsdp", "expert"}
        if FAULT == "double":
            drop = drop - {"fsdp"}
        out.append(tuple(a for a in base if a not in drop))
    return out


def reduce_gradients(params, names, layout, mesh, extras, *, accum: int = 1):
    """Sum every gradient over the axes on which it is partial and divide
    it (and ``accum``'s microbatches) by the data replicas, one bucket a
    group of axes; ``extras`` (the loss and, last, the count) ride the
    bucket of the replicated leaves, summed over the data axes and
    ``seq``, all but the count divided too → the reduced extras."""
    dp = mesh.data_size
    full = ("data", "fsdp", "expert", "seq")
    by_group: dict[tuple, list] = {full: []}
    for p, axes in zip(params, _groups(layout, names)):
        by_group.setdefault(axes, []).append(p)
    rest = None
    for axes, members in by_group.items():
        if axes == full:
            _, rest = bucket_all_reduce(members, extras, dp,
                                        mesh.comm(*axes).all_reduce_,
                                        accum=accum)
            continue
        scale = dp
        if FAULT == "drop_scale" and "fsdp" not in axes:
            scale = dp // fsdp_size(mesh)
        bucket_all_reduce(members, [members[0].new_zeros(())], scale,
                          mesh.comm(*axes).all_reduce_, accum=accum)
    return rest
