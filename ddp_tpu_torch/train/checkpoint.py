"""Per-epoch checkpoints with integrity manifests and auto-resume
(``ddp_tpu/train/checkpoint.py``).

Layout under the checkpoint directory, as the JAX package's:

- ``epoch_N/state.pt``: ``torch.save`` of ``{step, params, opt_state,
  spe, mid_batch, fmt}`` (``checkpoint.py:609-665``), written by rank 0
  into a temporary directory first; the rename to ``epoch_N`` is the
  commit point, so a crash mid-save leaves no half-written latest;
- ``epoch_N.manifest.json``: every file's size and CRC-32
  (``build_manifest``, same JSON form);
- ``quarantine.epoch-N``: a committed epoch that failed its manifest,
  renamed aside (never deleted) by discovery, which then falls back to
  the previous intact epoch.

The optimizer state is restored with the parameters (the reference
dropped it). Rank 0 verifies and quarantines; every rank reads after a
barrier. Reads use ``weights_only=True``: a checkpoint is data.
"""

from __future__ import annotations

import json
import logging
import os
import re
import shutil
import zlib

import torch

from ddp_tpu_torch.parallel.ddp import TrainState
from ddp_tpu_torch.runtime.dist import sync_global_devices

logger = logging.getLogger("ddp_tpu_torch")

CHECKPOINT_FORMAT = 3  # the JAX package's format number (``fmt``)
STATE_FILE = "state.pt"
MANIFEST_SUFFIX = ".manifest.json"
QUARANTINE_PREFIX = "quarantine."
_EPOCH_DIR = re.compile(r"epoch_(\d+)$")


def _crc32_file(path: str, chunk: int = 1 << 20) -> int:
    crc = 0
    with open(path, "rb") as f:
        while True:
            block = f.read(chunk)
            if not block:
                return crc & 0xFFFFFFFF
            crc = zlib.crc32(block, crc)


def _manifest_path(root: str, epoch: int) -> str:
    return os.path.join(root, f"epoch_{epoch}{MANIFEST_SUFFIX}")


def build_manifest(step_dir: str) -> dict:
    """Walk a committed step directory → {relpath: {size, crc32}}."""
    files: dict[str, dict] = {}
    for dirpath, _, names in os.walk(step_dir):
        for name in sorted(names):
            path = os.path.join(dirpath, name)
            rel = os.path.relpath(path, step_dir)
            files[rel] = {
                "size": os.path.getsize(path),
                "crc32": _crc32_file(path),
            }
    return {"version": 1, "files": files}


def write_manifest(root: str, epoch: int) -> str | None:
    """Manifest the committed ``epoch_<N>`` dir (atomic tmp+replace).
    Returns the manifest path, or None when the step dir is absent."""
    step_dir = os.path.join(root, f"epoch_{epoch}")
    if not os.path.isdir(step_dir):
        return None
    manifest = build_manifest(step_dir)
    path = _manifest_path(root, epoch)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(manifest, f, sort_keys=True)
    os.replace(tmp, path)
    return path


def verify_manifest(root: str, epoch: int) -> list[str] | None:
    """Check ``epoch_<N>`` against its manifest: ``None`` when no readable
    manifest exists (accepted unverified), ``[]`` when every listed file
    matches, else the problems (missing / size / checksum)."""
    path = _manifest_path(root, epoch)
    try:
        with open(path) as f:
            manifest = json.load(f)
        listed = dict(manifest["files"])
    except (OSError, ValueError, KeyError, TypeError):
        return None
    step_dir = os.path.join(root, f"epoch_{epoch}")
    problems: list[str] = []
    for rel, meta in sorted(listed.items()):
        p = os.path.join(step_dir, rel)
        try:
            size = os.path.getsize(p)
        except OSError:
            problems.append(f"{rel}: missing")
            continue
        if size != meta.get("size"):
            problems.append(
                f"{rel}: size {size} != manifest {meta.get('size')}"
            )
            continue
        if _crc32_file(p) != meta.get("crc32"):
            problems.append(f"{rel}: checksum mismatch")
    return problems


class CheckpointManager:
    """Per-epoch checkpoints with latest-intact-epoch auto-resume.

    ``max_to_keep`` keeps the newest N epochs (None: all, like the
    reference). ``is_main`` marks the one writer (rank 0).
    """

    def __init__(self, directory: str = "./checkpoints", *,
                 max_to_keep: int | None = None, is_main: bool = True):
        self._dir = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.is_main = is_main
        self.quarantined: list[dict] = []

    def all_epochs(self) -> list[int]:
        """Every committed epoch tag, ascending."""
        try:
            names = os.listdir(self._dir)
        except FileNotFoundError:
            return []
        return sorted(int(m.group(1)) for n in names
                      if (m := _EPOCH_DIR.match(n))
                      and os.path.isdir(os.path.join(self._dir, n)))

    def latest_epoch(self) -> int | None:
        epochs = self.all_epochs()
        return epochs[-1] if epochs else None

    def verify_epoch(self, epoch: int) -> list[str] | None:
        return verify_manifest(self._dir, epoch)

    def _delete_epoch(self, epoch: int) -> None:
        shutil.rmtree(os.path.join(self._dir, f"epoch_{epoch}"),
                      ignore_errors=True)
        try:
            os.remove(_manifest_path(self._dir, epoch))
        except OSError:
            pass

    def save(self, epoch: int, state: TrainState, *,
             steps_per_epoch: int = 0, mid_batch: int = 0) -> bool:
        """Write ``epoch``'s checkpoint from rank 0, then a barrier.

        An existing ``epoch_N`` is kept (a later save supersedes it), as
        the JAX manager does without ``overwrite``. Returns whether this
        rank wrote.
        """
        wrote = False
        final = os.path.join(self._dir, f"epoch_{epoch}")
        if self.is_main and not os.path.isdir(final):
            os.makedirs(self._dir, exist_ok=True)
            tmp = f"{final}.tmp-{os.getpid()}"
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            blob = {
                "step": int(state.step),
                "params": {k: v.detach().cpu()
                           for k, v in state.model.state_dict().items()},
                "opt_state": state.optimizer.state_dict(),
                "model_state": state.model_state,
                "spe": int(steps_per_epoch),
                "mid_batch": int(mid_batch),
                "fmt": CHECKPOINT_FORMAT,
            }
            path = os.path.join(tmp, STATE_FILE)
            with open(path, "wb") as f:
                torch.save(blob, f)
                f.flush()
                os.fsync(f.fileno())
            os.rename(tmp, final)  # the commit point
            write_manifest(self._dir, epoch)
            if self.max_to_keep:
                for old in self.all_epochs()[:-self.max_to_keep]:
                    self._delete_epoch(old)
            wrote = True
        sync_global_devices("ckpt_save")
        return wrote

    def quarantine_epoch(self, epoch: int, problems: list[str]) -> str | None:
        """Rename a corrupt epoch aside to ``quarantine.epoch-N`` (its
        manifest moves inside); returns the new path, or None when the
        rename failed."""
        src = os.path.join(self._dir, f"epoch_{epoch}")
        dst = os.path.join(self._dir, f"{QUARANTINE_PREFIX}epoch-{epoch}")
        n = 0
        while os.path.exists(dst):
            n += 1
            dst = os.path.join(
                self._dir, f"{QUARANTINE_PREFIX}epoch-{epoch}.{n}"
            )
        try:
            os.rename(src, dst)
        except OSError:
            dst = None
        else:
            try:
                os.replace(_manifest_path(self._dir, epoch),
                           os.path.join(dst, "ddp_tpu" + MANIFEST_SUFFIX))
            except OSError:
                pass
            logger.error(
                "Checkpoint epoch %d failed integrity verification (%s) — "
                "quarantined to %s; falling back to the previous intact "
                "checkpoint", epoch, "; ".join(problems) or "unknown", dst,
            )
        self.quarantined.append(
            {"epoch": epoch, "path": dst, "problems": list(problems)}
        )
        return dst

    def latest_intact_epoch(self) -> int | None:
        """The latest epoch that passes its manifest (manifest-less epochs
        are accepted unverified), quarantining corrupt ones on the way
        down; None when nothing usable is left. Rank 0 verifies; a barrier
        pairs every rank, which then rescans."""
        try:
            if self.is_main:
                while (epoch := self.latest_epoch()) is not None:
                    problems = self.verify_epoch(epoch)
                    if not problems:  # [] verified, or None unverifiable
                        break
                    if self.quarantine_epoch(epoch, problems) is None:
                        raise RuntimeError(
                            f"checkpoint epoch {epoch} fails integrity "
                            f"verification ({'; '.join(problems)}) and "
                            f"cannot be quarantined — is {self._dir} "
                            "writable?"
                        )
        finally:
            sync_global_devices("ckpt_integrity_verify")
        return self.latest_epoch()

    def read(self, epoch: int, device="cpu") -> dict:
        """The raw checkpoint dict of ``epoch``."""
        path = os.path.join(self._dir, f"epoch_{epoch}", STATE_FILE)
        return torch.load(path, map_location=device, weights_only=True)

    def restore(self, state: TrainState, epoch: int | None = None) -> int:
        """Load ``epoch`` (None: the latest intact one) into ``state`` in
        place — parameters, optimizer state and step count — and return
        the epoch. An explicit epoch that fails its manifest raises."""
        if epoch is None:
            epoch = self.latest_intact_epoch()
            if epoch is None:
                raise FileNotFoundError(f"no checkpoints in {self._dir}")
        else:
            problems = self.verify_epoch(epoch)
            if problems:
                raise RuntimeError(
                    f"checkpoint epoch {epoch} fails integrity "
                    f"verification: {'; '.join(problems)} — restore a "
                    "different epoch, or delete its manifest to force "
                    "an unverified read"
                )
        blob = self.read(epoch)
        state.model.load_state_dict(blob["params"])
        state.optimizer.load_state_dict(blob["opt_state"])
        state.model_state = blob.get("model_state") or {}
        state.step = int(blob["step"])
        return epoch

    def restore_or_init(self, state: TrainState) -> int:
        """The auto-resume entry: the start epoch — the latest intact
        epoch + 1 restored into ``state``, else 0 with ``state`` as it
        is."""
        try:
            epoch = self.restore(state)
        except FileNotFoundError:
            if self.quarantined:
                logger.warning(
                    "No intact checkpoint in %s (%d quarantined) — "
                    "starting from scratch", self._dir, len(self.quarantined),
                )
            return 0
        return epoch + 1

    def delete_after(self, epoch: int) -> list[int]:
        """Delete every checkpoint tagged later than ``epoch`` (the rewind
        of ``--resume_epoch``: the abandoned branch must not stay
        "latest"). Rank 0 deletes; every rank gets the list."""
        stale = [e for e in self.all_epochs() if e > epoch]
        if self.is_main:
            for e in stale:
                self._delete_epoch(e)
        sync_global_devices("ckpt_delete_after")
        return stale
