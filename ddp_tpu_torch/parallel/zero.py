"""ZeRO-style weight-update sharding on the data axis
(``ddp_tpu/parallel/zero.py``, ``--parallel zero``).

A data-parallel step ends with an all-reduce of the full gradient and N
replicas running the same update over N copies of the moments. The
sharded update removes that redundancy without touching the model math:

    reduce-scatter(grads)  →  each replica owns 1/N of every bucket
    sharded optimizer update  →  moments and update math are 1/N
    all-gather(params)     →  the replicas hold the same parameters

The parameters stay replicated at rest (stage 1; ``--mesh_fsdp`` is
stage 3, ``parallel/seq_fsdp``). Gradients pack into size-targeted
**buckets** (``--zero_bucket_mb``, :func:`build_layout`), each a flat fp32
vector padded to a multiple of the replica count, the leaves in the
order JAX flattens their tree (``interop/jax_params.jax_leaf_order``), so
the buckets, their padding and the byte estimates are JAX's on the same
model. Replica ``r`` owns elements ``[r·len/N, (r+1)·len/N)`` of every
padded bucket (``lax.psum_scatter(tiled=True)``'s block); the pad region
carries zeros end to end, so it never reaches a parameter.

:class:`ZeroOptimizer` is the update: the port's ``train/optim.Optimizer``
runs unchanged over the flat shards (its ``_foreach`` rule is
elementwise), and the global-norm clip (``--grad_clip_norm``) runs in
the step on the shards, its norm the square root of the per-shard
squared sums summed over the data group (and, for the LM's leaves
sharded over ``model``, over ``model`` too). ``gather_dtype="bf16"``
keeps fp32 **master** shards in the optimizer state and gathers the
updated shards at half width: the forward sees bf16-rounded parameters,
the update only the masters. Each bucket's reduce-scatter is dispatched
with ``async_op=True`` once the backward is done and waited before the
update (overlap with the backward itself is a later speed item);
gradient accumulation scatters each microbatch and accumulates the 1/N
shards (:func:`make_zero_train_step`).

Two users, as in JAX: :func:`make_zero_train_step`, the image family's
step (``make_zero_train_step`` :492), and the causal LM's step
(``models/lm.make_lm_train_step`` with a :class:`ZeroOptimizer`: the
buckets shard over ``data`` and replicate over ``model``/``seq``, the
``zero_gspmd_update`` :696 composition; ``seq`` is summed first and
Megatron's reductions stay as they are).

Checkpoints hold the full per-parameter moments (and, under bf16, the
full master), gathered by :meth:`ZeroOptimizer.state_dict`: a zero run
resumes at any world size, and under DDP, and a DDP run resumes under
zero. That is ``ZeroElasticReshaper``'s contract (:842-980) with the
full-state file in place of re-bucketing a saved layout.

:func:`ddp_comm_bytes`, :func:`zero_comm_bytes` and
:func:`opt_bytes_per_device` are JAX's estimates (the flat mesh: the
hierarchical ``dcn`` geometry waits for ROADMAP A4.2).
"""

from __future__ import annotations

import dataclasses

import torch

from ddp_tpu_torch.interop.jax_params import jax_leaf_order
from ddp_tpu_torch.parallel.common import check_accum_divisible, precision
from ddp_tpu_torch.parallel.ddp import StepMetrics, _loss_and_correct
from ddp_tpu_torch.data.augment import step_key
from ddp_tpu_torch.train.optim import _STATE, make_optimizer

GATHER_DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}

# The negative controls of the tests and of the card's smoke check: a
# deliberately wrong update, or None. "offset" updates the neighbour's
# shard of every bucket; "rounded" updates the bf16-rounded parameters
# in place of the fp32 master; "clip_model" sums the replicated leaves'
# squares over ``model`` too in the clip's norm.
FAULT: str | None = None


@dataclasses.dataclass(frozen=True)
class Bucket:
    """One flat fp32 reduce-scatter unit: a contiguous run of leaves,
    ``padded`` the ``total`` rounded up to a multiple of the replicas."""

    leaf_ids: tuple[int, ...]
    sizes: tuple[int, ...]
    total: int
    padded: int
    shard: int


@dataclasses.dataclass(frozen=True)
class BucketLayout:
    """Every leaf (in leaf order) assigned to a bucket."""

    buckets: tuple[Bucket, ...]
    num_leaves: int
    world: int

    @property
    def padded_total(self) -> int:
        return sum(b.padded for b in self.buckets)


def build_layout(shapes, world: int, *, bucket_mb: float = 4.0
                 ) -> BucketLayout:
    """Greedy size-targeted bucketing over leaves of ``shapes`` (in leaf
    order, :99-190): leaves pack until a bucket crosses the byte target
    (fp32 accounting); a leaf at least as large gets its own bucket."""
    if world < 1:
        raise ValueError(f"world must be >= 1, got {world}")
    if bucket_mb <= 0:
        raise ValueError(f"bucket_mb must be > 0, got {bucket_mb}")
    if not shapes:
        raise ValueError("empty parameter tree — nothing to shard")
    target = max(1, int(bucket_mb * 2**20) // 4)
    buckets: list[Bucket] = []
    ids: list[int] = []
    sizes: list[int] = []

    def close():
        if ids:
            total = sum(sizes)
            padded = -(-total // world) * world
            buckets.append(Bucket(tuple(ids), tuple(sizes), total, padded,
                                  padded // world))
            ids.clear()
            sizes.clear()

    for i, shape in enumerate(shapes):
        n = 1
        for s in shape:
            n *= int(s)
        if n >= target:
            close()
            ids.append(i)
            sizes.append(n)
            close()
            continue
        ids.append(i)
        sizes.append(n)
        if sum(sizes) >= target:
            close()
    close()
    return BucketLayout(tuple(buckets), len(shapes), world)


def check_zero_mesh(shape: dict, *, allow_model_axes: bool = False) -> None:
    """The sharded update scatters over ``data`` (:196): fsdp, expert and
    pipe already shard optimizer state their own way; ``model``/``seq``
    only with ``allow_model_axes`` (the causal LM's composition)."""
    reject = ("fsdp", "expert", "pipe")
    if not allow_model_axes:
        reject = ("model", "seq") + reject
    bad = {a: int(shape[a]) for a in reject if shape.get(a, 1) > 1}
    if bad:
        raise ValueError(
            f"--parallel zero shards the weight update over the data "
            f"axis only; {bad} already shard optimizer state their own "
            "way — drop the axes or the flag"
        )


def _resolve_gather_dtype(gather_dtype):
    """'fp32'/'bf16' or a torch dtype → (dtype, master_mode)."""
    if isinstance(gather_dtype, str):
        if gather_dtype not in GATHER_DTYPES:
            raise ValueError(
                f"gather_dtype must be one of {sorted(GATHER_DTYPES)}, "
                f"got {gather_dtype!r}"
            )
        gather_dtype = GATHER_DTYPES[gather_dtype]
    if gather_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(
            f"gather_dtype must be float32 or bfloat16, got {gather_dtype}")
    return gather_dtype, gather_dtype == torch.bfloat16


def flatten_buckets(layout: BucketLayout, leaves) -> list[torch.Tensor]:
    """Leaves (in leaf order) → one flat fp32 ``[padded]`` vector a
    bucket, the pad zeros."""
    flats = []
    for b in layout.buckets:
        parts = [leaves[i].detach().float().reshape(-1) for i in b.leaf_ids]
        if b.padded > b.total:
            parts.append(parts[0].new_zeros(b.padded - b.total))
        flats.append(torch.cat(parts))
    return flats


def unflatten_buckets(layout: BucketLayout, flats, like) -> list:
    """Flat ``[padded]`` vectors → tensors shaped and typed as ``like``
    (the pad tail dropped)."""
    out = [None] * layout.num_leaves
    for b, flat in zip(layout.buckets, flats):
        off = 0
        for i, n in zip(b.leaf_ids, b.sizes):
            out[i] = flat[off:off + n].reshape(like[i].shape).to(like[i].dtype)
            off += n
    return out


def shard_of(layout: BucketLayout, leaves, owner: int) -> list[torch.Tensor]:
    """Block ``owner`` of every bucket of ``leaves``, cut from the leaves
    it overlaps (no full flat copy)."""
    out = []
    for b in layout.buckets:
        lo, hi = owner * b.shard, (owner + 1) * b.shard
        parts, off = [], 0
        for i, n in zip(b.leaf_ids, b.sizes):
            a, z = max(lo, off), min(hi, off + n)
            if a < z:
                parts.append(leaves[i].detach().float().reshape(-1)[a - off:z - off])
            off += n
        pad = hi - max(lo, b.total)
        if pad > 0:
            parts.append(torch.zeros(pad, device=leaves[0].device))
        out.append(torch.cat(parts))
    return out


def scatter_buckets(flats, comm) -> list[torch.Tensor]:
    """Reduce-scatter every bucket over ``comm`` (raw sums: the caller
    scales), dispatched at once and waited together."""
    pending = [comm.reduce_scatter(f, async_op=True) for f in flats]
    return [p.wait() for p in pending]


def gather_buckets(shards, comm, gather_dtype=torch.float32) -> list:
    """All-gather every bucket's shard back to ``[padded]`` in
    ``gather_dtype``: a bf16 shard rides the wire as its bytes (no backend
    re-widens an integer collective, and gloo takes uint8 where it takes
    neither int16 nor every float type)."""
    out = []
    for s in shards:
        if gather_dtype == torch.float32:
            out.append(comm.all_gather(s.contiguous(), 0))
        else:
            wire = s.to(gather_dtype).view(torch.uint8)
            out.append(comm.all_gather(wire, 0).view(gather_dtype))
    return out


class ZeroOptimizer:
    """The sharded update over ``named`` parameters (``(name,
    Parameter)`` pairs, module order) on the data group ``comm``, with the
    chain of ``train/optim.make_optimizer`` (name, lr, momentum,
    weight_decay) run on the flat shards. ``grad_clip_norm`` clips in the
    step. ``model_comm`` and ``model_names``: the LM's ``model`` group and
    the leaves sharded over it (their squares are summed over it in the
    norm). The train-step interface: :meth:`scatter_grads` after each
    backward, :meth:`apply` once a step; the trainer's: ``count``,
    ``params``, ``state_dict``/``load_state_dict`` (full per-parameter
    buffers, a collective), ``reset``."""

    def __init__(self, named, comm, *, name: str = "sgd", lr=0.01,
                 momentum: float = 0.0, weight_decay: float = 0.0,
                 grad_clip_norm: float = 0.0, bucket_mb: float = 4.0,
                 gather_dtype="fp32", model_comm=None, model_names=()):
        named = [(n, p) for n, p in named if p.requires_grad]
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        self.order = jax_leaf_order(self.names,
                                    [tuple(p.shape) for p in self.params])
        self.leaves = [self.params[i] for i in self.order]
        self.comm = comm
        self.layout = build_layout([tuple(p.shape) for p in self.leaves],
                                   comm.size, bucket_mb=bucket_mb)
        self.gather_dtype, self.master_mode = _resolve_gather_dtype(
            gather_dtype)
        self.grad_clip_norm = grad_clip_norm
        self.model_comm = model_comm
        self.flat = [s.requires_grad_(True)
                     for s in shard_of(self.layout, self.leaves, self.owner)]
        self.inner = make_optimizer(self.flat, name, lr=lr,
                                    momentum=momentum,
                                    weight_decay=weight_decay)
        self._mask = None
        if model_comm is not None and model_comm.size > 1:
            marks = [torch.full(p.shape, float(n in model_names),
                                device=p.device)
                     for n, p in zip([self.names[i] for i in self.order],
                                     self.leaves)]
            self._mask = shard_of(self.layout, marks, self.owner)

    @property
    def owner(self) -> int:
        """The block of every bucket this replica owns."""
        if FAULT == "offset":
            return (self.comm.rank + 1) % self.comm.size
        return self.comm.rank

    @property
    def count(self) -> int:
        return self.inner.count

    def scatter_grads(self, acc=None, *, pre_sum=None) -> list:
        """This rank's gradients (``p.grad``, then cleared) reduce-
        scattered bucket by bucket → the summed shards, added to ``acc``
        (a microbatch's accumulation). ``pre_sum``: a group every bucket
        is first summed over (the LM's ``seq``)."""
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self.leaves]
        flats = flatten_buckets(self.layout, grads)
        for p in self.leaves:
            p.grad = None
        if pre_sum is not None and pre_sum.size > 1:
            for f in flats:
                pre_sum.all_reduce_(f)
        shards = scatter_buckets(flats, self.comm)
        return shards if acc is None else [a + s for a, s in
                                           zip(acc, shards)]

    def _norm(self, shards) -> torch.Tensor:
        """√ of the per-shard squared sums summed over the data group
        (the model-sharded elements' over ``model`` as well)."""
        sq = torch.stack([s.pow(2).sum() for s in shards]).sum()
        if self._mask is None:
            return torch.sqrt(self.comm.all_reduce_(sq.reshape(1)))[0]
        split = torch.stack([
            sum((s.pow(2) * m).sum() for s, m in zip(shards, self._mask)),
            sq])
        split[1] -= split[0]  # the replicated elements
        self.comm.all_reduce_(split)
        if FAULT == "clip_model":
            self.model_comm.all_reduce_(split)
        else:
            self.model_comm.all_reduce_(split[:1])
        return torch.sqrt(split.sum())

    @torch.no_grad()
    def apply(self, shards, scale: float) -> torch.Tensor:
        """One update from the summed gradient ``shards``: scaled to the
        mean, clipped by the global norm, the chain run on this replica's
        shards, the parameters gathered back → the global norm of the
        scaled, unclipped gradient."""
        g = [s * scale for s in shards]
        norm = self._norm(g)
        if self.grad_clip_norm:
            clip = self.grad_clip_norm
            g = [torch.where(norm < clip, x, (x / norm) * clip) for x in g]
        if not self.master_mode or FAULT == "rounded":
            # The replica's own block of the parameters (replicated: no
            # exchange); under bf16 the masters persist instead.
            for f, cur in zip(self.flat, shard_of(self.layout, self.leaves,
                                                  self.owner)):
                f.copy_(cur)
        for f, x in zip(self.flat, g):
            f.grad = x
        self.inner.step()
        gathered = gather_buckets(self.flat, self.comm, self.gather_dtype)
        for p, v in zip(self.leaves,
                        unflatten_buckets(self.layout, gathered,
                                          self.leaves)):
            p.copy_(v)
        return norm

    def last_grads(self) -> dict:
        """``{name: tensor}``: the full gradient the last :meth:`apply`
        updated with (scaled and clipped; a collective)."""
        return dict(zip(self.names,
                        self._full([f.grad for f in self.flat], copy=False)))

    # ---- checkpoints: the full per-parameter state ------------------

    def _full(self, shards, copy: bool) -> list:
        """Shards → the full tensors, one a parameter in module order."""
        flats = gather_buckets(shards, self.comm)
        leaves = unflatten_buckets(self.layout, flats, self.leaves)
        out = [None] * len(self.params)
        for i, t in zip(self.order, leaves):
            out[i] = t.detach().cpu() if copy else t.detach()
        return out

    def _shards(self, full) -> list:
        leaves = [torch.as_tensor(full[i]).to(self.flat[0].device)
                  for i in self.order]
        return shard_of(self.layout, leaves, self.owner)

    def state_dict(self, *, copy: bool = True) -> dict:
        """The train/optim.Optimizer format (count, then each buffer as
        a list over the parameters, full tensors) plus ``master`` under
        bf16: every rank gathers (a collective)."""
        out = {"count": self.inner.count}
        for k in _STATE:
            bufs = getattr(self.inner, k, None)
            out[k] = None if bufs is None else self._full(bufs, copy)
        if self.master_mode:
            out["master"] = self._full(self.flat, copy)
        return out

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Restore a full state (any world, zero's or DDP's): each buffer
        cut to this replica's shards; the masters from ``master``, or
        from the parameters restored before (a checkpoint without)."""
        for k in _STATE:
            mine, theirs = getattr(self.inner, k, None), state.get(k)
            if (mine is None) != (theirs is None):
                raise ValueError(
                    f"optimizer state {k!r} does not match this optimizer "
                    f"({self.inner.name}, momentum {self.inner.momentum}): "
                    "was it saved under another --optimizer or "
                    "--momentum?")
        for k in _STATE:
            for b, v in zip(getattr(self.inner, k, None) or [],
                            self._shards(state[k]) if state.get(k) else []):
                b.copy_(v)
        if self.master_mode:
            src = (self._shards(state["master"]) if state.get("master")
                   else shard_of(self.layout, self.leaves, self.owner))
            for f, v in zip(self.flat, src):
                f.copy_(v)
        self.inner.count = int(state["count"])

    @torch.no_grad()
    def reset(self) -> None:
        """``--reset_opt_state``: count 0, moments zero, the masters from
        the parameters."""
        self.inner.reset()
        for f, v in zip(self.flat, shard_of(self.layout, self.leaves,
                                            self.owner)):
            f.copy_(v)

    def shard_bytes(self) -> int:
        """Bytes of optimizer state this rank holds: the moment shards
        and, under bf16, the master shards."""
        bufs = [b for k in _STATE for b in getattr(self.inner, k, None) or []]
        if self.master_mode:
            bufs += self.flat
        return sum(b.numel() * b.element_size() for b in bufs)


def make_zero_train_step(state, comm, *, compute_dtype=torch.float32,
                         grad_accum_steps: int = 1,
                         label_smoothing: float = 0.0, augment_fn=None,
                         seed: int = 0):
    """The image family's zero step (:492-695): ``parallel/ddp.
    make_train_step``'s contract with the update swapped, ``all-reduce →
    update`` becoming ``reduce-scatter → 1/N update → all-gather``
    (``state.optimizer`` a :class:`ZeroOptimizer` over ``comm``, the
    world's data group). Accumulation (contiguous microbatches, as the
    DDP step) scatters each microbatch and accumulates the 1/N shards;
    the running statistics, the loss and the count ride one all-reduce.
    Metrics: the mean loss, Σcorrect / (n·world), the global norm of the
    averaged, unclipped gradient."""
    model, opt = state.model, state.optimizer
    world = comm.size
    buffers = [b for b in model.buffers() if b.is_floating_point()]
    buf_sizes = [b.numel() for b in buffers]
    n_buf = sum(buf_sizes)
    k = grad_accum_steps

    def key(micro):
        return augment_fn and step_key(seed, state.step, comm.rank, micro)

    def step(images, labels) -> StepMetrics:
        n = labels.shape[0]
        model.train()
        for p in opt.params:
            p.grad = None
        mb = check_accum_divisible(n, k)
        shards, loss, correct = None, 0.0, 0.0
        with precision(compute_dtype):
            for i in range(k):
                rows = slice(i * mb, (i + 1) * mb)
                l_i, c_i = _loss_and_correct(
                    model, images[rows], labels[rows], compute_dtype,
                    label_smoothing, augment_fn, key(i))
                l_i.backward()
                shards = opt.scatter_grads(shards)
                loss, correct = loss + l_i.detach(), correct + c_i
        rest = torch.cat([b.detach().reshape(-1) for b in buffers]
                         + [(loss / k).reshape(1), correct.reshape(1)])
        comm.all_reduce_(rest)
        rest[:-1].div_(world)
        with torch.no_grad():
            for b, v in zip(buffers, rest[:n_buf].split(buf_sizes)):
                b.copy_(v.view_as(b))
        grad_norm = opt.apply(shards, 1.0 / (world * k))
        state.step += 1
        loss, correct = rest[n_buf:]
        return StepMetrics(loss=loss, accuracy=correct / (n * world),
                           grad_norm=grad_norm)

    return step


# ---- accounting: what the strategy moves and what it holds ----------


def ddp_comm_bytes(sizes, world: int) -> dict[str, int]:
    """Per-step per-replica payload of the DDP baseline (:981), ring
    model: 2·(N−1)/N of the fp32 gradient bytes. ``sizes``: the leaves'
    element counts."""
    ar = int(2 * (world - 1) / max(1, world) * sum(sizes) * 4)
    return {"all_reduce": ar, "reduce_scatter": 0, "all_gather": 0,
            "total": ar}


def zero_comm_bytes(layout: BucketLayout, world: int, *,
                    grad_accum_steps: int = 1, gspmd: bool = False,
                    dcn: int = 1, gather_dtype="fp32") -> dict[str, int]:
    """Per-step per-replica payload of the zero strategy (:994), flat
    meshes: a reduce-scatter a bucket a microbatch ((N−1)/N of the padded
    fp32 bytes) and one all-gather in the gather dtype; ``gspmd`` prices
    JAX's in-graph LM expression (the transpose's all-reduce a microbatch
    and the all-gather). ``dcn`` > 1 waits for ROADMAP A4.2."""
    if dcn > 1:
        raise ValueError("--mesh_dcn > 1 (hierarchical zero) is not "
                         "ported: it waits for ROADMAP A4.2")
    gdtype, _ = _resolve_gather_dtype(gather_dtype)
    b4 = layout.padded_total * 4
    bg = layout.padded_total * torch.empty((), dtype=gdtype).element_size()
    k = max(1, grad_accum_steps)
    frac = (world - 1) / max(1, world)
    ar = int(2 * frac * b4) * k if gspmd else 0
    rs = 0 if gspmd else int(frac * b4) * k
    ag = int(frac * bg)
    return {"all_reduce": ar, "reduce_scatter": rs, "all_gather": ag,
            "total": ar + rs + ag}


def opt_bytes_per_device(opt) -> int:
    """The optimizer-state bytes one rank holds (:1069), in JAX's count:
    a :class:`ZeroOptimizer`'s shards, or a replicated optimizer's whole
    buffers (the moments of a sharded model's shards under FSDP), plus
    the int32 step counts optax keeps on the device (Adam's, and a
    schedule's)."""
    if isinstance(opt, ZeroOptimizer):
        moments, opt = opt.shard_bytes(), opt.inner
    else:
        moments = sum(b.numel() * b.element_size() for k in _STATE
                      for b in getattr(opt, k, None) or [])
    counts = (opt.name in ("adam", "adamw")) + callable(opt.lr)
    return moments + 4 * counts
