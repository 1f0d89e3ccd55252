"""The serving engine's step programs, captured as CUDA graphs.

The port's counterpart of the ``jax.jit`` cache entries of
``ddp_tpu/serve/engine.py``. The JAX engine compiles a bounded program
set — one fused decode+sample program, one first-chunk and one
continuation-chunk program per bucket width, and with speculation the
draft's chunk programs, one draft-decode and one verify program — and
pins it: after ``warmup()`` no request mix compiles another. On the card
the same set is a set of captured CUDA graphs, which take the host's
~20 µs a launched op out of a step (a decode step is a few hundred small
kernels).

A :class:`StepProgram` is a name (a key of JAX's ``compile_counts``), a
function over engine-owned tensors that writes its results into them in
place, and nothing else: its inputs are static tensors that the engine
fills with ``copy_`` before each run, and every value a later step reads
lives in tensors allocated outside any capture. So a graph replay and an
eager call of the same function are interchangeable.

- ``prepare()``: on a CUDA program, run the function once on a side
  stream (real work: the flash-decode kernels set their shared-memory
  attribute at the first launch of a shape, which a capture must not
  meet first), then capture it with ``torch.cuda.graph`` into the
  engine's one memory pool, in ``thread_local`` error mode (a streaming
  restore may copy on another thread meanwhile), with Python's cyclic
  garbage collector off: an engine dropped earlier is a reference cycle
  (its programs' closures hold it), and collecting it frees its graphs,
  which a capture in progress must not meet. A capture that fails
  raises, naming the program; nothing falls back to eager. Elsewhere
  (the CPU, or an engine built with ``cuda_graphs=False``) it only
  registers the program.
- ``run()``: replay the graph, or call the function eagerly over the
  same buffers. A program not yet prepared is prepared at its first run,
  and on the card that preparation's side-stream call IS the run.

Launch counters follow replays. The kernel wrappers count a launch in
Python (``ops/decode.py``), and a replay runs no Python, so a program
records at capture how far each counter moved (and puts the counters
back: a capture launches nothing) and adds that much at every replay.
"""

from __future__ import annotations

import gc
import time
from typing import Callable, Optional

import torch

from ddp_tpu_torch.ops import decode as decode_ops


def _counted():
    """The wrappers whose launch counters a program carries."""
    return (decode_ops.flash_decode_attention,
            decode_ops.flash_decode_paged_attention)


def launch_counts() -> dict[str, int]:
    """Every launch counter of the decode kernels, flat: kernel name →
    launches, ``<wrapper>.plain_routed`` → calls routed to the plain
    version by shape."""
    out = {}
    for w in _counted():
        out.update(w.launches)
        out[f"{w.__name__}.plain_routed"] = w.plain_routed
    return out


def _add_counts(delta: dict[str, int]) -> None:
    for w in _counted():
        for k in w.launches:
            w.launches[k] += delta.get(k, 0)
        w.plain_routed += delta.get(f"{w.__name__}.plain_routed", 0)


class StepProgram:
    """One program of the engine's set (see the module docstring).

    ``graphs`` is true only for a program the card captures.
    ``per_replay`` holds the counter moves recorded at capture, which a
    replay adds; ``replays`` counts the replays; ``capture_s`` the
    seconds ``prepare()`` took.
    """

    def __init__(self, name: str, fn: Callable[[], None], *,
                 device: torch.device, graphs: bool, pool=None):
        self.name = name
        self.fn = fn
        self.device = device
        self.graphs = graphs
        self.pool = pool
        self.prepared = False
        self.graph = None
        self.per_replay: dict[str, int] = {}
        self.replays = 0
        self.capture_s = 0.0

    def prepare(self) -> None:
        """Make the program runnable (capture it on the card); a second
        call does nothing."""
        if self.prepared:
            return
        if self.graphs:
            self._capture()
        self.prepared = True

    def run(self) -> None:
        if not self.prepared:
            self.prepare()
            if self.graphs:
                return  # the capture's side-stream call was this run
        if self.graph is not None:
            self.graph.replay()
            self.replays += 1
            _add_counts(self.per_replay)
        else:
            self.fn()

    def _capture(self) -> None:
        t0 = time.perf_counter()
        with torch.cuda.device(self.device):
            main = torch.cuda.current_stream(self.device)
            side = torch.cuda.Stream(self.device)
            side.wait_stream(main)
            with torch.cuda.stream(side):
                self.fn()
            main.wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            before = launch_counts()
            collecting = gc.isenabled()
            gc.disable()
            try:
                with torch.cuda.graph(graph, pool=self.pool,
                                      capture_error_mode="thread_local"):
                    self.fn()
            except Exception as e:
                raise RuntimeError(
                    f"CUDA graph capture of step program {self.name!r} "
                    f"failed: {type(e).__name__}: {e}") from e
            finally:
                if collecting:
                    gc.enable()
                moved = {k: n - before[k] for k, n in launch_counts().items()}
                _add_counts({k: -n for k, n in moved.items()})
        self.per_replay = {k: n for k, n in moved.items() if n}
        self.graph = graph
        self.capture_s = time.perf_counter() - t0


class ProgramSet:
    """An engine's programs by (name, bucket width or None), all of its
    graphs in one memory pool (``torch.cuda.graph_pool_handle()``): the
    engine replays them one at a time on one stream, and every value a
    later program reads lives outside the pool, so they can share it."""

    def __init__(self, device: torch.device, *, graphs: bool):
        self.device = device
        self.graphs = bool(graphs) and device.type == "cuda"
        self.pool = torch.cuda.graph_pool_handle() if self.graphs else None
        self._programs: dict[tuple[str, Optional[int]], StepProgram] = {}

    def get(self, name: str, width: Optional[int],
            make: Callable[[], Callable[[], None]]) -> StepProgram:
        """The program ``(name, width)``, built from ``make()`` at its
        first request (not prepared: ``run()`` or ``prepare()`` does
        that)."""
        key = (name, width)
        prog = self._programs.get(key)
        if prog is None:
            prog = self._programs[key] = StepProgram(
                name, make(), device=self.device, graphs=self.graphs,
                pool=self.pool)
        return prog

    def prepared(self, name: str) -> int:
        """How many programs of ``name`` are prepared (compiled, in JAX's
        words)."""
        return sum(1 for (n, _), p in self._programs.items()
                   if n == name and p.prepared)

    def capture_seconds(self) -> float:
        return sum(p.capture_s for p in self._programs.values())

    def per_replay(self) -> dict[str, dict[str, int]]:
        """``name[:width]`` → the counter moves one replay adds (captured
        programs that launch a counted kernel)."""
        return {f"{n}{'' if w is None else f':{w}'}": dict(p.per_replay)
                for (n, w), p in self._programs.items() if p.per_replay}

    def replayed_counts(self) -> dict[str, int]:
        """Counter moves that replays made: Σ replays × per_replay."""
        out: dict[str, int] = {}
        for p in self._programs.values():
            for k, n in p.per_replay.items():
                out[k] = out.get(k, 0) + p.replays * n
        return out

    def pool_bytes(self) -> Optional[int]:
        """Bytes the graphs' pool holds on the card (0 without graphs;
        None where the allocator's snapshot does not name pools)."""
        if not self.graphs:
            return 0
        total, named = 0, False
        for seg in torch.cuda.memory_snapshot():
            pool = seg.get("segment_pool_id")
            if pool is None:
                continue
            named = True
            if tuple(pool) == tuple(self.pool):
                total += seg["total_size"]
        return total if named else None
