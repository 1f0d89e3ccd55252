"""Model lifecycle: verified hot-swap and streaming restore — the host
half of ``ddp_tpu/serve/lifecycle.py`` (the swap itself is
``serve/engine.ServeEngine.install_params``, the HTTP surface
``serve/server.py``'s ``POST /reload``):

  verify → load → drain to the barrier → swap → (roll back on failure)

:func:`verify_reload_target` runs before anything touches the serving
model: the checkpoint must carry a readable integrity manifest
(``manifest_missing``), every file must match its recorded size and
CRC-32 (``crc_mismatch``), and the spec from its parameter shapes and
``lm_spec.json`` sidecar must equal the serving spec (``spec_skew``: the
swap copies into the serving tensors in place, so a skewed state cannot
install). It reads no tensor data.

:class:`StreamingRestore` is the startup half: a background thread
copies the embedding and the first K blocks of a memory-mapped
checkpoint to the device, which opens admission (requests queue against
the paused engine), then the deep blocks; the first dispatch waits for
the whole state, installed through ``install_params``. The port has no
compile to overlap with the copy, so what it moves is the moment
admission opens, nothing else.
"""

from __future__ import annotations

import dataclasses
import os
import re
import threading
import time
from typing import Iterable, Optional

import torch

from ddp_tpu_torch.models.lm import LMSpec
from ddp_tpu_torch.train.checkpoint import (
    CheckpointManager,
    derive_spec_with_sidecar,
)

# The named reasons a reload is refused with; each leaves the serving
# model untouched.
REASON_MANIFEST_MISSING = "manifest_missing"
REASON_CRC_MISMATCH = "crc_mismatch"
REASON_SPEC_SKEW = "spec_skew"
REJECTION_REASONS = (
    REASON_MANIFEST_MISSING,
    REASON_CRC_MISMATCH,
    REASON_SPEC_SKEW,
)


class ReloadRejected(Exception):
    """Verification of a reload target failed; nothing was installed.
    ``reason`` is one of ``REJECTION_REASONS``, ``detail`` the
    evidence."""

    def __init__(self, reason: str, detail: str):
        super().__init__(f"{reason}: {detail}")
        self.reason = reason
        self.detail = detail


def model_version_token(directory: str, epoch: int) -> str:
    """``"<basename>@epoch<N>"``: the label of checkpoint directory D at
    epoch N, as /healthz, completions and serve_request records carry
    it (the artifact's name, stable across processes)."""
    base = os.path.basename(os.path.normpath(os.path.abspath(directory)))
    return f"{base}@epoch{epoch}"


@dataclasses.dataclass(frozen=True)
class ReloadTarget:
    """A verified swap target (made only by :func:`verify_reload_target`)."""

    directory: str
    epoch: int
    version: str
    spec: LMSpec


def verify_reload_target(
    directory: str,
    *,
    epoch: Optional[int] = None,
    current_spec: Optional[LMSpec] = None,
    num_heads_fallback: int = 4,
) -> ReloadTarget:
    """Manifest, then CRCs, then spec → a :class:`ReloadTarget`; raises
    :class:`ReloadRejected` with a named reason. Stricter than restore:
    a checkpoint without a manifest is refused, not read unverified."""
    mgr = CheckpointManager(directory)
    if epoch is None:
        epoch = mgr.latest_epoch()
        if epoch is None:
            raise ReloadRejected(REASON_MANIFEST_MISSING,
                                 f"no checkpoint found in {directory}")
    epoch = int(epoch)
    problems = mgr.verify_epoch(epoch)
    if problems is None:
        raise ReloadRejected(
            REASON_MANIFEST_MISSING,
            f"epoch {epoch} has no readable integrity manifest — refusing "
            "to hot-swap an unverifiable checkpoint",
        )
    if problems:
        raise ReloadRejected(REASON_CRC_MISMATCH, "; ".join(problems))
    try:
        spec = derive_spec_with_sidecar(
            directory, mgr.params_metadata(epoch),
            num_heads_fallback=num_heads_fallback,
        )
    except (KeyError, ValueError, RuntimeError) as e:
        raise ReloadRejected(REASON_SPEC_SKEW, str(e)) from None
    if current_spec is not None and spec != current_spec:
        diffs = [
            f"{f}: {getattr(spec, f)!r} != serving "
            f"{getattr(current_spec, f)!r}"
            for f in LMSpec._fields
            if getattr(spec, f) != getattr(current_spec, f)
        ]
        raise ReloadRejected(REASON_SPEC_SKEW, "; ".join(diffs))
    return ReloadTarget(
        directory=os.path.abspath(directory),
        epoch=epoch,
        version=model_version_token(directory, epoch),
        spec=spec,
    )


def load_reload_target(target: ReloadTarget) -> dict:
    """A verified target's parameters (memory-mapped, on the host); the
    serving model is not touched."""
    state, _ = CheckpointManager(target.directory).restore_for_inference(
        target.epoch)
    return state


# ---- streaming restore -------------------------------------------------

_BLOCK_RE = re.compile(r"^block(\d+)$")


def split_param_groups(
    children: Iterable[str], first_blocks: int = 1
) -> tuple[list[str], list[str]]:
    """Top-level parameter names → (admission group, deep group), in model
    order: ``embed``, ``pos_embed`` and the first ``first_blocks`` blocks
    gate admission (a prefill touches them first); the deeper blocks and
    the rest follow. Unknown names land in the deep group."""
    names = [str(c) for c in children]
    blocks = sorted((int(m.group(1)), n) for n in names
                    for m in [_BLOCK_RE.match(n)] if m)
    early = {n for _, n in blocks[: max(0, first_blocks)]}
    ordered = [n for n in ("embed", "pos_embed") if n in names]
    ordered += [n for _, n in blocks]
    ordered += sorted(n for n in names if n not in ordered)
    admission, deep = [], []
    for n in ordered:
        if n in ("embed", "pos_embed") or n in early:
            admission.append(n)
        else:
            deep.append(n)
    return admission, deep


def _child(key: str) -> str:
    """A state-dict key's top-level module: ``block3.mlp1.weight`` →
    ``block3``."""
    return key.split(".")[0]


class StreamingRestore:
    """Layer-streamed restore of a checkpoint onto ``device``.

    Construction resolves the epoch (integrity-verified discovery) and
    derives the spec from the parameter shapes and the sidecar, reading
    no tensor data. ``start()``'s thread copies the admission group to
    the device (``wait_admission`` returns: open the front door), then
    the deep group (``wait`` returns the whole state for
    ``install_params``).
    """

    def __init__(self, directory: str, *, device,
                 epoch: Optional[int] = None, first_blocks: int = 1,
                 num_heads_fallback: int = 4):
        self.directory = directory
        self.device = torch.device(device)
        self._mgr = CheckpointManager(directory)
        self.epoch = self._mgr.verified_epoch(epoch)
        self._meta = self._mgr.params_metadata(self.epoch)
        self.version = model_version_token(directory, self.epoch)
        self.spec = derive_spec_with_sidecar(
            directory, self._meta, num_heads_fallback=num_heads_fallback)
        self.admission_group, self.deep_group = split_param_groups(
            dict.fromkeys(_child(k) for k in self._meta), first_blocks)
        self._state: dict = {}
        self._error: Optional[str] = None
        self._admission_evt = threading.Event()
        self._done_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._t0: Optional[float] = None
        # Seconds from start() to each residency milestone.
        self.admission_ready_s: Optional[float] = None
        self.complete_s: Optional[float] = None

    def placeholder_state(self) -> dict:
        """Zeros of the checkpoint's shapes and dtypes: what the engine
        is built over while the real weights stream in."""
        return {k: torch.zeros(m.shape, dtype=m.dtype)
                for k, m in self._meta.items()}

    def start(self) -> "StreamingRestore":
        if self._thread is not None:
            raise RuntimeError("streaming restore already started")
        self._t0 = time.monotonic()
        self._thread = threading.Thread(target=self._run,
                                        name="stream-restore", daemon=True)
        self._thread.start()
        return self

    def _copy_group(self, host: dict, group: list[str], stream) -> None:
        names = set(group)
        with torch.cuda.stream(stream):  # a no-op for None (the CPU)
            for k, v in host.items():
                if _child(k) in names:
                    self._state[k] = v.to(self.device)
        if stream is not None:
            # Resident, not queued. The wait is on this thread's own
            # stream, never the whole device: the engine may be
            # capturing its step graphs meanwhile (warmup overlaps the
            # restore), and a device-wide synchronize would meet the
            # capture.
            stream.synchronize()

    def _run(self) -> None:
        stream = (torch.cuda.Stream(self.device)
                  if self.device.type == "cuda" else None)
        try:
            host = self._mgr.read_params(self.epoch)
            self._copy_group(host, self.admission_group, stream)
            self.admission_ready_s = round(time.monotonic() - self._t0, 4)
            self._admission_evt.set()
            self._copy_group(host, self.deep_group, stream)
            missing = sorted(set(self._meta) - set(self._state))
            if missing:
                raise RuntimeError(
                    f"streamed restore left {missing[:5]} unrestored")
            self.complete_s = round(time.monotonic() - self._t0, 4)
        except Exception as e:  # noqa: BLE001 — surfaced to the waiters
            self._error = f"{type(e).__name__}: {e}"
        finally:
            self._admission_evt.set()
            self._done_evt.set()

    def wait_admission(self, timeout: Optional[float] = None) -> bool:
        """True once the admission group is resident; raises if the
        restore failed."""
        ok = self._admission_evt.wait(timeout)
        if self._error is not None:
            raise RuntimeError(f"streaming restore failed: {self._error}")
        return ok

    def wait(self, timeout: Optional[float] = None) -> dict:
        """Block until the whole state is resident → the state dict."""
        if not self._done_evt.wait(timeout):
            raise TimeoutError(
                f"streaming restore of {self.directory} epoch {self.epoch} "
                f"did not finish in {timeout}s")
        if self._error is not None:
            raise RuntimeError(f"streaming restore failed: {self._error}")
        return self._state
