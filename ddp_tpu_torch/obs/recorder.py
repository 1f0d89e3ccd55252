"""Flight recorder: a bounded ring of records, dumped post-mortem.

A copy of ``ddp_tpu/obs/recorder.py`` (pure host code, with
``snapshot_env`` and ``build_info`` rewritten for this stack). A
SIGTERM'd or crashed server leaves stack traces but no record of what
led up to the end — the part a post-mortem actually needs. The recorder
keeps the last N records (host-side dicts, bounded deque — recording
costs one append, no device wait; the serve engine puts SLO breach
events here) plus a one-time context snapshot (build, environment
subset, configuration), and dumps the whole thing as one JSON file:

- crash-safely: temp file + ``os.replace`` (the tracer's discipline) —
  a crash mid-dump leaves the previous dump intact, never a half file;
- per rank: ``flight_rank{rank}.json`` in the configured directory;
- on shutdown of ``python -m ddp_tpu_torch.serve`` (the SIGTERM drain or
  a normal exit).

``dump()`` never raises (it IS the error path); it returns the path or
None. Non-finite floats sanitize to null like the metrics stream —
divergence is precisely when the dump gets read.
"""

from __future__ import annotations

import json
import math
import os
import platform
import sys
import time
from collections import deque
from typing import Any, Optional

FLIGHT_FILENAME = "flight_rank{rank}.json"

# Environment keys worth a post-mortem (never the whole environ: it
# can carry credentials).
_ENV_PREFIXES = ("CUDA_", "NCCL_", "TORCH_", "PYTORCH_", "DDP_TPU_")


def snapshot_env() -> dict:
    """Interpreter, torch and the relevant env vars, JSON-ready."""
    import torch

    return {
        "python": sys.version.split()[0],
        "platform": platform.platform(),
        "argv": list(sys.argv),
        "env": {
            k: v
            for k, v in sorted(os.environ.items())
            if k.startswith(_ENV_PREFIXES)
        },
        "torch": torch.__version__,
    }


def build_info(device=None) -> dict:
    """The provenance block every long-lived process should publish.

    Package version, torch and CUDA versions, the backend and platform
    of ``device`` (a ``torch.device``; default the first GPU when one is
    visible, else the CPU) and its name — stamped on ``/statusz`` and
    on the linted ``ddp_tpu_build_info`` gauge of ``/metricsz``, so a
    CPU run is never read as a card's and an aggregator scraping a
    fleet tells a version-skewed endpoint at a glance.
    """
    import torch

    import ddp_tpu_torch

    if device is None:
        device = torch.device(
            "cuda" if torch.cuda.is_available() else "cpu")
    device = torch.device(device)
    on_gpu = device.type == "cuda"
    return {
        "version": ddp_tpu_torch.__version__,
        "torch": torch.__version__,
        "cuda": torch.version.cuda or "none",
        "backend": device.type,
        "platform": "gpu" if on_gpu else "cpu",
        "device": (torch.cuda.get_device_name(device) if on_gpu
                   else platform.machine() or "cpu"),
    }


def _sanitize(obj):
    """Strict-JSON form: non-finite floats → null, keys → str."""
    if isinstance(obj, dict):
        return {str(k): _sanitize(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_sanitize(v) for v in obj]
    if isinstance(obj, float) and not math.isfinite(obj):
        return None
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    return str(obj)


class FlightRecorder:
    """Bounded ring of records + context, crash-safe JSON dump.

    ``capacity <= 0`` disables everything (record/dump are no-ops) so
    callers wire it unconditionally from config.
    """

    def __init__(
        self,
        directory: Optional[str],
        *,
        rank: int = 0,
        capacity: int = 256,
        clock=time.time,
    ):
        self.enabled = bool(directory) and capacity > 0
        self.directory = directory
        self.rank = int(rank)
        self.capacity = max(0, int(capacity))
        self.clock = clock
        self._ring: deque = deque(maxlen=max(1, self.capacity))
        self._context: dict[str, Any] = {}
        self._providers: dict[str, Any] = {}
        self._dumps = 0

    @property
    def path(self) -> Optional[str]:
        if not self.enabled:
            return None
        return os.path.join(
            self.directory, FLIGHT_FILENAME.format(rank=self.rank)
        )

    def set_context(self, **ctx) -> None:
        """Merge one-time context (config/env snapshots)."""
        if not self.enabled:
            return
        self._context.update(ctx)

    def set_provider(self, name: str, fn) -> None:
        """Register a live-state provider collected AT DUMP TIME.

        Unlike ``set_context`` (a snapshot frozen when set), a
        provider is called when the dump happens — state a post-mortem
        needs at death, not at construction, belongs here. Each
        provider runs inside its own guard; a raising provider
        contributes an error marker, never kills the dump.
        """
        if not self.enabled:
            return
        self._providers[name] = fn

    def record(self, kind: str, **fields) -> None:
        """Append one record to the ring (host dict append — cheap
        enough for every step; no device sync implied)."""
        if not self.enabled:
            return
        self._ring.append(
            {"kind": kind, "time": round(self.clock(), 3), **fields}
        )

    def dump(self, reason: str) -> Optional[str]:
        """Write the dump; never raises. → path or None."""
        if not self.enabled:
            return None
        path = self.path
        try:
            os.makedirs(self.directory, exist_ok=True)
            extras: dict[str, Any] = {}
            for name, fn in self._providers.items():
                try:
                    extras[name] = fn()
                except Exception as e:  # noqa: BLE001 — never kill a dump
                    extras[name] = {"provider_error": type(e).__name__}
            doc = _sanitize(
                {
                    "reason": reason,
                    "rank": self.rank,
                    "dumped_at": round(self.clock(), 3),
                    "dumps": self._dumps + 1,
                    "context": self._context,
                    **({"extras": extras} if extras else {}),
                    "records": list(self._ring),
                }
            )
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(doc, f)
            os.replace(tmp, path)
            self._dumps += 1
            return path
        except Exception:  # noqa: BLE001 — dump() IS the error path
            # Not just OSError: surrogate-escaped env bytes can make
            # json/f.write raise UnicodeEncodeError (a ValueError),
            # and this runs inside signal handlers and except blocks
            # where a second exception destroys the graceful exit.
            return None


def load_dump(path: str) -> dict:
    """Read a dump back (tests, tooling); plain json.load with a
    schema sanity check naming the file on violation."""
    with open(path) as f:
        doc = json.load(f)
    if not isinstance(doc, dict) or "records" not in doc or "reason" not in doc:
        raise ValueError(f"{path}: not a flight-recorder dump")
    return doc
