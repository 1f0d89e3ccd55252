"""What both pipelined families share (``ddp_tpu/parallel/pipe_common.py``):
the strided microbatch split, and the stacked stage layout and its map
to the ranks. The batch shards over the mesh's data axes
(``runtime/mesh.data_axes``: ``data`` alone, the port's pipe family
taking no fsdp or expert axis yet, ROADMAP A4.1b); a data replica's pipe
ranks read the same rows.

A pipelined model is a front (stage 0's embedding), a body of C = S·v
uniform chunks of ``depth_per_stage`` encoder blocks, and a back (stage
S−1's norm and head). Its full state stacks the chunks' leaves as JAX's
does: ``stages.<leaf>`` is [S, …] (one chunk a stage) or, interleaved,
[v, S, …], chunk c = k·S + d at [k, d] — so rank d of the ``pipe`` axis
holds chunks d, d + S, …, d + (v−1)·S, its local chunk k being global
chunk k·S + d. The front and the back live on every pipe rank, as JAX
replicates them. :class:`PipeLayout` maps a rank's parameters (``front.*``,
``chunks.<k>.*``, ``back.*``) to that full state and back, for the
checkpoints, and gives the optimizer the norm of the whole model.
"""

from __future__ import annotations

import numpy as np
import torch


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


class PipeLayout:
    """A pipe rank's parameters ↔ the model's full, stacked state.

    ``names``: the rank's parameter names in the optimizer's order;
    ``num_stages`` S, ``virtual_stages`` v (``interleaved``: the stacked
    lead is [v, S], else [S]); ``comm``: the ``pipe`` group's
    communicator, member d being pipe rank d.
    """

    def __init__(self, names, *, num_stages: int, virtual_stages: int,
                 interleaved: bool, comm, rank: int):
        self.names = list(names)
        self.S, self.V, self.interleaved = num_stages, virtual_stages, \
            interleaved
        self.comm, self.rank = comm, rank

    @staticmethod
    def split(name: str):
        """``chunks.<k>.<leaf>`` → (k, leaf); any other name → (None,
        name)."""
        if name.startswith("chunks."):
            _, k, leaf = name.split(".", 2)
            return int(k), leaf
        return None, name

    def gather(self, local: dict) -> dict:
        """A rank's tensors → the full state (a collective over ``pipe``):
        each chunk leaf stacked over the ranks, in host memory (a
        checkpoint's bytes: the card holds one gathered leaf at a time),
        the ends as they are."""
        full, chunks = {}, {}
        for name, t in local.items():
            k, leaf = self.split(name)
            if k is None:
                full[name] = t
            else:
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
            if not self.interleaved:
                out[f"chunks.0.{leaf}"] = t[self.rank]
                continue
            from ddp_tpu_torch.parallel.interleaved import chunk_of

            flat = t.reshape(-1, *t.shape[2:])
            for k in range(self.V):
                out[f"chunks.{k}.{leaf}"] = flat[
                    chunk_of(k, self.rank, self.S, self.V)]
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
        """√Σ‖g‖² of the whole model: the stages' squares summed over
        ``pipe``, the ends' (the same on every pipe rank) counted once."""
        stage = ends = None
        for name, t in zip(self.names, tensors):
            sq = t.float().pow(2).sum()
            if name.startswith("chunks."):
                stage = sq if stage is None else stage + sq
            else:
                ends = sq if ends is None else ends + sq
        total = self.comm.all_reduce_(stage.reshape(1).clone())[0]
        return torch.sqrt(total if ends is None else total + ends)
