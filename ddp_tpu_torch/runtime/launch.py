"""The local multi-process supervisor (``ddp_tpu/runtime/launch.py``):
``torch.multiprocessing.spawn`` with restart-with-resume and elastic
resize.

Workers are module-level callables ``fn(rank, world_size, *args)`` (the
reference's ``ddp_train`` signature), resolved in the child by module
name, or by source file for functions of test modules and scripts. Each
child gets the rendezvous in its environment (``MASTER_ADDR``,
``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``) and brings
its process group up itself (``runtime/dist.setup``), with the backend
its own flags name.

Restart-with-resume (``max_restarts > 0``): when any rank dies, the
parent classifies the exit (a signal, an exception, the watchdog's
124), reaps the whole world (survivors are typically blocked in a
collective waiting for the dead peer) and relaunches every rank on a
fresh rendezvous port after a bounded exponential backoff. Recovery is
the workers' job: the trainer auto-resumes from the latest checkpoint.

Elastic supervision (``elastic=True``): a rank that exits with
``SHRINK_EXIT_CODE`` declares itself permanently gone, and the next
generation is one worker smaller, down to ``min_world``;
``GROW_EXIT_CODE`` asks for one more, capped at ``nprocs``. Resizes do
not consume ``max_restarts``. Workers re-derive everything world-shaped
on relaunch: the per-rank batch from the ``elastic.json`` global-batch
contract (``train/checkpoint.py``).
"""

from __future__ import annotations

import importlib
import importlib.util
import inspect
import logging
import multiprocessing
import os
import signal as _signal
import sys
import time
from typing import Callable, Sequence

from ddp_tpu_torch.runtime.dist import free_port
from ddp_tpu_torch.utils.watchdog import WATCHDOG_EXIT_CODE

logger = logging.getLogger("ddp_tpu_torch")

# The elastic contract between workers and the supervisor, carried in
# the one channel a dead process has: its exit code. SHRINK: this rank is
# permanently lost (relaunch one smaller); GROW: relaunch one larger.
SHRINK_EXIT_CODE = 86
GROW_EXIT_CODE = 87


def classify_exit(exitcode: int | None) -> str:
    """A dead worker's failure class: multiprocessing reports death by a
    signal as a negative code; 124 is the watchdog; 86/87 the elastic
    contract; anything else an uncaught exception."""
    if exitcode is None:
        return "unknown"
    if exitcode < 0:
        try:
            name = _signal.Signals(-exitcode).name
        except ValueError:
            name = f"signal {-exitcode}"
        return f"killed by {name}"
    if exitcode == WATCHDOG_EXIT_CODE:
        return "watchdog timeout (hang converted to exit 124)"
    if exitcode == SHRINK_EXIT_CODE:
        return "permanently lost (elastic shrink, exit 86)"
    if exitcode == GROW_EXIT_CODE:
        return "scale-up requested (elastic grow, exit 87)"
    return f"exception (exit {exitcode})"


def _resolve(src_file: str, module_name: str, qualname: str) -> Callable:
    try:
        mod = importlib.import_module(module_name)
    except ImportError:
        spec = importlib.util.spec_from_file_location(module_name, src_file)
        if spec is None or spec.loader is None:
            raise
        mod = importlib.util.module_from_spec(spec)
        sys.modules[module_name] = mod
        spec.loader.exec_module(mod)
    obj = mod
    for part in qualname.split("."):
        obj = getattr(obj, part)
    return obj


def _child_main(src_file: str, module_name: str, qualname: str, rank: int,
                world_size: int, port: int, args: tuple) -> None:
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(world_size),
                      LOCAL_RANK=str(rank))
    _resolve(src_file, module_name, qualname)(rank, world_size, *args)


def _reap_world(procs: list, grace: float) -> None:
    """SIGTERM every survivor (a healthy one checkpoints and exits),
    ``grace`` seconds to comply, then SIGKILL for ranks wedged in a
    collective whose peer is gone (a C-level wait never runs the Python
    handler). No rank outlives its world."""
    for p in procs:
        if p.is_alive():
            p.terminate()
    deadline = time.monotonic() + grace
    for p in procs:
        p.join(max(0.5, deadline - time.monotonic()))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)


def spawn(
    fn: Callable,
    nprocs: int,
    args: Sequence = (),
    *,
    timeout: float | None = 600.0,
    grace: float = 15.0,
    max_restarts: int = 0,
    restart_backoff: float = 1.0,
    elastic: bool = False,
    min_world: int = 1,
    events_out: list | None = None,
) -> int:
    """Run ``fn(rank, world_size, *args)`` in ``nprocs`` processes and
    return the restarts consumed.

    Blocks until every rank exits (``timeout`` spans all generations;
    None waits forever). The first rank to die non-zero is the culprit;
    survivors get ``grace`` seconds, then are reaped. ``max_restarts``
    relaunches a failed world (fresh port, backoff ``restart_backoff ·
    2^i`` s, capped at 30). ``elastic`` turns SHRINK/GROW exits into a
    world of ``world - shrinks + grows`` (never above ``nprocs``, below
    ``min_world`` raises) after one ``restart_backoff`` beat; a
    generation with a shrink and an unrelated crash counts as a resize
    (the crash is the reaped survivor's). ``events_out`` receives one
    dict per restart or resize.
    """
    if min_world < 1:
        raise ValueError(f"min_world must be >= 1, got {min_world}")
    if min_world > nprocs:
        raise ValueError(
            f"min_world {min_world} exceeds the launched world {nprocs}")
    src_file = os.path.abspath(inspect.getfile(fn))
    ctx = multiprocessing.get_context("spawn")
    deadline = None if timeout is None else time.monotonic() + timeout
    restarts = resizes = 0
    world = nprocs
    # A worker that exits SHRINK/GROW unconditionally would bounce the
    # supervisor forever without touching the restart budget.
    max_resizes = 2 * nprocs + 8
    while True:
        port = free_port()  # a dead generation's socket may linger
        procs = [
            ctx.Process(target=_child_main,
                        args=(src_file, fn.__module__, fn.__qualname__, rank,
                              world, port, tuple(args)),
                        daemon=False)
            for rank in range(world)
        ]
        for p in procs:
            p.start()
        bad: dict[int, int] = {}
        try:
            while True:
                exited = {r: p.exitcode for r, p in enumerate(procs)
                          if not p.is_alive()}
                bad = {r: c for r, c in exited.items() if c != 0}
                if bad:
                    # Blocked survivors get a moment to exit on their own,
                    # so the report names the failure and not a reap;
                    # re-collect after it (a staggered SHRINK must be
                    # classified as one).
                    grace_end = time.monotonic() + grace
                    for p in procs:
                        p.join(max(0.0, grace_end - time.monotonic()))
                    bad = {r: p.exitcode for r, p in enumerate(procs)
                           if not p.is_alive() and p.exitcode != 0}
                    break
                if len(exited) == world:
                    return restarts
                if deadline is not None and time.monotonic() > deadline:
                    alive = [r for r, p in enumerate(procs) if p.is_alive()]
                    raise RuntimeError(
                        f"ranks {alive} still running after {timeout}s"
                        + (f" ({restarts} restart(s))" if restarts else ""))
                time.sleep(0.2)
        finally:
            _reap_world(procs, grace)
        classified = {r: classify_exit(c) for r, c in sorted(bad.items())}
        why = "; ".join(f"rank {r}: {c}" for r, c in classified.items())
        shrinks = sorted(r for r, c in bad.items() if c == SHRINK_EXIT_CODE)
        grows = sorted(r for r, c in bad.items() if c == GROW_EXIT_CODE)
        if elastic and (shrinks or grows):
            new_world = min(nprocs, world - len(shrinks) + len(grows))
            if new_world < min_world:
                raise RuntimeError(
                    f"elastic resize would shrink the world to {new_world} "
                    f"(< min_world {min_world}): {why}")
            resizes += 1
            if resizes > max_resizes:
                raise RuntimeError(
                    f"{resizes} elastic resizes without completing — a "
                    f"worker is exiting SHRINK/GROW unconditionally "
                    f"(last: {bad})")
            backoff = max(0.0, min(30.0, restart_backoff))
            logger.warning(
                "launch: elastic %s %d -> %d workers (%s) — relaunching in "
                "%.1fs", "resize" if new_world != world else "grow capped",
                world, new_world, why, backoff)
            if events_out is not None:
                events_out.append({
                    "kind": "resize" if new_world != world else "restart",
                    "old_world": world, "new_world": new_world,
                    "shrunk_ranks": shrinks, "grew": len(grows),
                    "time": time.time(),
                })
            world = new_world
        else:
            if restarts >= max_restarts:
                raise RuntimeError(
                    f"worker failures (rank: exitcode): {bad} — {why}"
                    + (f"; {restarts}/{max_restarts} restarts exhausted"
                       if max_restarts else ""))
            backoff = min(30.0, restart_backoff * (2.0 ** restarts))
            restarts += 1
            logger.warning(
                "launch: generation failed (%s) — restart %d/%d in %.1fs",
                why, restarts, max_restarts, backoff)
            if events_out is not None:
                events_out.append({
                    "kind": "restart", "old_world": world, "new_world": world,
                    "failures": dict(bad), "time": time.time(),
                })
        if deadline is not None and time.monotonic() + backoff > deadline:
            raise RuntimeError(
                f"worker failures (rank: exitcode): {bad}; no budget left "
                f"to restart (timeout {timeout}s)")
        time.sleep(backoff)
