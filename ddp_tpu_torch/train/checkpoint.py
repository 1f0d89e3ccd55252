"""Per-epoch checkpoints with integrity manifests and auto-resume
(``ddp_tpu/train/checkpoint.py``).

Layout under the checkpoint directory, as the JAX package's:

- ``epoch_N/state.pt``: ``torch.save`` of ``{step, params, opt_state,
  spe, mid_batch, fmt}`` (``checkpoint.py:609-665``; ``mid_batch`` > 0
  tags an epoch preempted after that many batches; ``params`` is the
  model's ``state_dict()``, so BatchNorm's running statistics, JAX's
  ``batch_stats``, are saved and restored with it), written by rank 0
  into a temporary directory first; the rename to ``epoch_N`` is the
  commit point, so a crash mid-save leaves no half-written latest;
- ``epoch_N/metrics.json``: the metrics a save was given (the eval
  accuracy ``--keep_best`` ranks by); a save without metrics (a
  preemption's) has none and is never pruned by rank;
- ``epoch_N.manifest.json``: every file's size and CRC-32
  (``build_manifest``, same JSON form); an epoch that is pruned or
  deleted loses its manifest with it, so no manifest outlives its epoch;
- ``quarantine.epoch-N``: a committed epoch that failed its manifest,
  renamed aside (never deleted) by discovery, which then falls back to
  the previous intact epoch.

- ``lm_spec.json``: a causal LM's architecture fields beside the
  epochs (``checkpoint.py:235-292``), which serving merges over the
  spec its shapes give (:func:`derive_spec_with_sidecar`);
- ``elastic.json``: the run's global batch and first world, written
  once (``checkpoint.py:310-345``), which a resized relaunch honours;
- ``generations.json``: how many times a trainer has started on this
  directory and at what world, the ``restarts`` and
  ``prev_data_shards`` of the metrics stream's ``run_start`` record.

The optimizer state is restored with the parameters (the reference
dropped it). Rank 0 verifies and quarantines; every rank reads after a
barrier. Reads use ``weights_only=True``: a checkpoint is data.
Inference reads (:meth:`CheckpointManager.restore_for_inference`,
:meth:`~CheckpointManager.params_metadata`) map the file (``mmap=True``)
and touch only the parameters, never the optimizer's moments.
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
LM_SPEC_FILENAME = "lm_spec.json"
METRICS_FILE = "metrics.json"
ELASTIC_FILENAME = "elastic.json"
GENERATIONS_FILENAME = "generations.json"
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


def save_lm_spec(directory: str, spec) -> str:
    """Write ``spec`` (an ``LMSpec``) as JSON beside the checkpoints,
    atomically (tmp, then ``os.replace``), keys sorted."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, LM_SPEC_FILENAME)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(dict(spec._asdict()), f, indent=2, sort_keys=True)
    os.replace(tmp, path)
    return path


def load_lm_spec_fields(directory: str) -> dict:
    """The sidecar's fields that the port's ``LMSpec`` knows (the MoE
    routing fields among them); {} when the file is absent or
    unreadable."""
    from ddp_tpu_torch.models.lm import LMSpec

    try:
        with open(os.path.join(directory, LM_SPEC_FILENAME)) as f:
            fields = json.load(f)
    except (OSError, ValueError):
        return {}
    if not isinstance(fields, dict):
        return {}
    return {k: v for k, v in fields.items() if k in LMSpec._fields}


def derive_spec_with_sidecar(directory: str, state, *,
                             num_heads_fallback: int):
    """Parameter shapes + ``lm_spec.json`` → ``LMSpec``: the shapes are
    ground truth, the sidecar gives the head count (``num_heads_fallback``
    for a checkpoint without one) and the routing the shapes cannot carry
    (``moe_top_k``, ``moe_normalize_gates``). Raises ValueError when the
    state is not a causal LM's, the head count does not explain the
    shapes, or the sidecar's ``num_experts`` / ``moe_every`` route other
    blocks than the shapes do."""
    from ddp_tpu_torch.models.lm import derive_lm_spec

    sidecar = load_lm_spec_fields(directory)
    return derive_lm_spec(
        state, num_heads=sidecar.pop("num_heads", num_heads_fallback),
        **sidecar,
    )


def _write_json(path: str, obj: dict) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(obj, f)
    os.replace(tmp, path)


def _read_json(path: str) -> dict:
    try:
        with open(path) as f:
            obj = json.load(f)
    except (OSError, ValueError):
        return {}
    return obj if isinstance(obj, dict) else {}


def save_elastic_contract(directory: str, *, global_batch_size: int,
                          world_size: int) -> str | None:
    """Record the run's global-batch contract (the first generation
    only: an existing contract is never overwritten) → its path, or None
    when one existed. Flags are per rank, so a resized world would
    otherwise change what a step means: the step counter, the schedule
    and the mid-epoch markers."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, ELASTIC_FILENAME)
    if os.path.exists(path):
        return None
    _write_json(path, {"global_batch_size": int(global_batch_size),
                       "world_size": int(world_size)})
    return path


def load_elastic_contract(directory: str) -> dict:
    """The recorded contract, or {} (no contract to honour)."""
    return _read_json(os.path.join(directory, ELASTIC_FILENAME))


def record_generation(directory: str, world_size: int) -> dict:
    """Count this start of a trainer on ``directory`` (rank 0 calls it):
    → ``{"restarts": starts before this one, "prev_world": the world of
    the last start, or None}``, and the file updated."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, GENERATIONS_FILENAME)
    prev = _read_json(path)
    seen = "restarts" in prev
    out = {"restarts": int(prev["restarts"]) + 1 if seen else 0,
           "prev_world": prev.get("world_size") if seen else None}
    _write_json(path, {"restarts": out["restarts"],
                       "world_size": int(world_size)})
    return out


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
    reference). With ``keep_best_metric`` it keeps the N saves with the
    highest value of that metric (given to :meth:`save`) plus the
    latest epoch (the auto-resume anchor) plus every save without
    metrics (a preemption's) — ``checkpoint.py:357-400``'s retention;
    each pruned epoch loses its manifest with it. ``is_main`` marks the
    one writer (rank 0).

    ``last_restored_spe`` / ``last_restored_mid_batch``: what the last
    restored checkpoint recorded — the steps per epoch it was written
    under, and how many batches into its epoch the state is (0: the
    epoch completed). The trainer re-enters a preempted epoch by this
    explicit marker, never by step arithmetic.
    """

    def __init__(self, directory: str = "./checkpoints", *,
                 max_to_keep: int | None = None, is_main: bool = True,
                 keep_best_metric: str | None = None):
        self._dir = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.keep_best_metric = keep_best_metric
        self.is_main = is_main
        self.quarantined: list[dict] = []
        self.last_restored_spe: int | None = None
        self.last_restored_mid_batch = 0

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

    def saved_metrics(self, epoch: int) -> dict | None:
        """The metrics ``epoch`` was saved with, or None (a save without
        metrics)."""
        path = os.path.join(self._dir, f"epoch_{epoch}", METRICS_FILE)
        return _read_json(path) if os.path.exists(path) else None

    def _prune(self) -> None:
        epochs = self.all_epochs()
        if not epochs:
            return
        if self.keep_best_metric:
            name, seen = self.keep_best_metric, {}
            for e in epochs:
                m = self.saved_metrics(e)
                if m is not None and m.get(name) is not None:
                    seen[e] = float(m[name])
            best = sorted(seen, key=lambda e: seen[e], reverse=True)
            if self.max_to_keep is not None:
                best = best[:self.max_to_keep]
            keep = set(best) | {epochs[-1]}
            keep |= {e for e in epochs if e not in seen}  # metric-less
        elif self.max_to_keep:
            keep = set(epochs[-self.max_to_keep:])
        else:
            return
        for e in epochs:
            if e not in keep:
                self._delete_epoch(e)

    def save(self, epoch: int, state: TrainState, *, overwrite: bool = False,
             steps_per_epoch: int = 0, mid_batch: int = 0,
             metrics: dict | None = None) -> bool:
        """Write ``epoch``'s checkpoint from rank 0 → whether it was
        saved (the same answer on every rank).

        A collective: every rank calls it; barriers before (every rank
        sees the same directory) and after. Same-epoch conflicts
        (``checkpoint.py:629-639``): an existing ``epoch_N`` (a
        preemption's artifact) is kept without ``overwrite`` and the
        save is skipped — a later save supersedes it, and no crash
        window leaves the directory without a usable latest; with
        ``overwrite`` it is deleted, then saved (a crash in between
        falls back to the epoch before: recompute, never corruption).
        ``mid_batch`` > 0 marks a preempted epoch; ``metrics`` ride in
        ``metrics.json`` for ``keep_best_metric``.
        """
        final = os.path.join(self._dir, f"epoch_{epoch}")
        sync_global_devices("ckpt_save_begin")
        exists = os.path.isdir(final)
        sync_global_devices("ckpt_save_looked")  # no write before every look
        if exists and not overwrite:
            logger.info("Checkpoint for epoch %d already exists (preemption "
                        "artifact) — keeping it; a later save supersedes it",
                        epoch)
            return False
        if self.is_main:
            if exists:
                self._delete_epoch(epoch)
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
            if metrics is not None:
                _write_json(os.path.join(tmp, METRICS_FILE), dict(metrics))
            os.rename(tmp, final)  # the commit point
            write_manifest(self._dir, epoch)
            self._prune()
        sync_global_devices("ckpt_save")
        return True

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

    def read_params(self, epoch: int) -> dict:
        """``epoch``'s parameters, memory-mapped from the file: a tensor's
        bytes are read when it is used, and nothing else of the
        checkpoint (the optimizer's moments) is read at all."""
        path = os.path.join(self._dir, f"epoch_{epoch}", STATE_FILE)
        return torch.load(path, map_location="cpu", weights_only=True,
                          mmap=True)["params"]

    def params_metadata(self, epoch: int) -> dict:
        """``epoch``'s parameter shapes and dtypes as meta tensors (no
        data), read through the same map as :meth:`read_params`."""
        return {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
                for k, v in self.read_params(epoch).items()}

    def verified_epoch(self, epoch: int | None = None) -> int:
        """The epoch to read: ``None`` → the latest intact one (a corrupt
        latest is quarantined, then discovery falls back;
        FileNotFoundError when none is left); an explicit epoch that
        fails its manifest raises RuntimeError."""
        if epoch is None:
            epoch = self.latest_intact_epoch()
            if epoch is None:
                raise FileNotFoundError(f"no checkpoints in {self._dir}")
            return epoch
        problems = self.verify_epoch(epoch)
        if problems:
            raise RuntimeError(
                f"checkpoint epoch {epoch} fails integrity "
                f"verification: {'; '.join(problems)} — restore a "
                "different epoch, or delete its manifest to force "
                "an unverified read"
            )
        return epoch

    def restore_for_inference(self, epoch: int | None = None
                              ) -> tuple[dict, int]:
        """``(parameters, epoch)`` for serving (``checkpoint.py:902-930``),
        no optimizer built, the epoch as :meth:`verified_epoch` picks it.
        The parameters are :meth:`read_params`' memory-mapped tensors."""
        epoch = self.verified_epoch(epoch)
        return self.read_params(epoch), epoch

    def read_partial(self, epoch: int, keys: tuple[str, ...]) -> dict:
        """Only ``keys`` of ``epoch``'s checkpoint (``checkpoint.py:817``):
        the file is memory-mapped, so entries not asked for are never
        read (an Adam state is twice the parameters)."""
        path = os.path.join(self._dir, f"epoch_{epoch}", STATE_FILE)
        blob = torch.load(path, map_location="cpu", weights_only=True,
                          mmap=True)
        return {k: blob[k] for k in keys if k in blob}

    def restore(self, state: TrainState, epoch: int | None = None) -> int:
        """Load ``epoch`` (as :meth:`verified_epoch` picks it) into
        ``state`` in place — parameters, optimizer state and step count —
        and return the epoch; ``last_restored_spe`` /
        ``last_restored_mid_batch`` take its position markers."""
        epoch = self.verified_epoch(epoch)
        blob = self.read(epoch)
        state.model.load_state_dict(blob["params"])
        state.optimizer.load_state_dict(blob["opt_state"])
        state.model_state = blob.get("model_state") or {}
        state.step = int(blob["step"])
        self.last_restored_spe = int(blob.get("spe", 0)) or None
        if "mid_batch" in blob:
            self.last_restored_mid_batch = int(blob["mid_batch"])
        elif self.last_restored_spe:  # a checkpoint from before the marker
            self.last_restored_mid_batch = state.step % self.last_restored_spe
        else:
            self.last_restored_mid_batch = 0
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
