"""Hang detection: turn a stuck step into a crash
(``ddp_tpu/utils/watchdog.py``).

A dead rank leaves every peer blocked in the next all-reduce, and
nothing restarts the job. Recovery is fail-fast plus auto-resume (the
supervisor of ``runtime/launch.py`` relaunches, checkpoints restore),
which works only if a hang becomes a failure: a monitor thread watches
per-step beats and, when none arrives within the timeout, runs the
forensics hooks, dumps every thread's stack and ``os._exit(124)``, so
the supervisor sees a dead process instead of a silent stall.
"""

from __future__ import annotations

import logging
import os
import sys
import threading
import time
from typing import Callable

logger = logging.getLogger("ddp_tpu_torch")

WATCHDOG_EXIT_CODE = 124


def dump_all_stacks(file=None) -> None:
    """Write every thread's Python stack to ``file`` (default stderr).

    ``faulthandler`` works from any thread without the hung main
    thread's help. Never raises: the dump is evidence, the abort
    proceeds regardless.
    """
    import faulthandler

    try:
        faulthandler.dump_traceback(
            file=file if file is not None else sys.stderr, all_threads=True
        )
    except Exception:  # noqa: BLE001 — diagnostics must not block the abort
        pass


# Evidence collectors run before the abort (``os._exit`` skips atexit and
# every finally: this is their only chance). Each is isolated.
_FORENSICS: list[Callable[[], None]] = []


def register_forensics(fn: Callable[[], None]) -> Callable[[], None]:
    """Add a pre-abort evidence collector; returns ``fn``."""
    _FORENSICS.append(fn)
    return fn


def unregister_forensics(fn: Callable[[], None]) -> None:
    """Remove a collector; a missing one is ignored."""
    try:
        _FORENSICS.remove(fn)
    except ValueError:
        pass


def run_forensics() -> None:
    """Run every registered collector, isolating failures."""
    for fn in list(_FORENSICS):
        try:
            fn()
        except Exception:  # noqa: BLE001 — diagnostics must not block the abort
            pass


def _default_abort(seconds: float) -> None:
    logger.error(
        "watchdog: no training progress for %.0fs — aborting so the "
        "launcher can detect the hang and a restart can resume from "
        "the latest checkpoint", seconds,
    )
    run_forensics()
    dump_all_stacks()
    # sys.exit would raise in this thread only; a hung main thread never
    # sees it.
    os._exit(WATCHDOG_EXIT_CODE)


class StepWatchdog:
    """A monitor thread that aborts when ``beat()`` stops arriving.

    ``timeout <= 0`` disables everything (every method is a no-op), so
    callers wire it from the config unconditionally. ``beat()`` is one
    host clock read: no device work.
    """

    def __init__(self, timeout: float, *,
                 on_timeout: Callable[[float], None] = _default_abort,
                 poll_interval: float | None = None):
        self.timeout = timeout
        self._on_timeout = on_timeout
        self._poll = (poll_interval or max(0.1, min(timeout / 4, 10.0))
                      if timeout > 0 else 1.0)
        self._last = time.monotonic()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self) -> None:
        if self.timeout <= 0 or self._thread is not None:
            return
        self._last = time.monotonic()
        self._stop.clear()
        self._thread = threading.Thread(target=self._run,
                                        name="ddp-tpu-torch-watchdog",
                                        daemon=True)
        self._thread.start()

    def beat(self) -> None:
        self._last = time.monotonic()

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout=5.0)
        self._thread = None

    def __enter__(self) -> "StepWatchdog":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    def _run(self) -> None:
        while not self._stop.wait(self._poll):
            idle = time.monotonic() - self._last
            if idle > self.timeout:
                self._on_timeout(idle)
                return
