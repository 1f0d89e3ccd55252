"""Per-epoch checkpoints with integrity manifests and auto-resume
(``ddp_tpu/train/checkpoint.py``).

Layout under the checkpoint directory, as the JAX package's:

- ``epoch_N/state.pt``: ``torch.save`` of ``{step, params, opt_state,
  spe, mid_batch, fmt}`` (``checkpoint.py:609-665``; ``mid_batch`` > 0
  tags an epoch preempted after that many batches; ``params`` is the
  model's ``state_dict()``, so BatchNorm's running statistics, JAX's
  ``batch_stats``, are saved and restored with it; a model sharded over
  a mesh — ``layout``, ``parallel/tp.ShardLayout`` — saves its FULL
  parameters and optimizer buffers, gathered on every rank first, and
  restores by slicing its shard, so a run at any mesh restores at any
  other, as the JAX trainer does), written by rank 0
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

Saves are asynchronous by default (``checkpoint.py:367-383``,
``async_save=True``): :meth:`CheckpointManager.save` copies the state to
pinned host memory on a side stream that waits on the current one, makes
the current stream wait for that copy (on the card: the host is not
held, and no second copy of the state is made in device memory; the
loop's next kernels, which write the parameters in place, start after
it), and returns; a writer thread waits for the copy's event, then runs
``torch.save`` into the temporary directory, ``fsync``, the rename and a
directory ``fsync``, and only then writes the manifest and prunes
(``_flush_manifests``: a manifest is written for a committed epoch
only). At most one save is in flight: the next ``save`` waits for it,
and so does every read (:meth:`~CheckpointManager.restore`,
:meth:`~CheckpointManager.latest_epoch`, quarantine, discovery).
:meth:`~CheckpointManager.wait` and :meth:`~CheckpointManager.close`
block until the save is durable and raise what the writer raised; the
writer is not a daemon thread, so an interpreter that exits right after
``save`` returns finishes it first. On the CPU the snapshot is a plain
host copy. ``async_save=False`` writes before ``save`` returns.

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
import threading
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
# The save in flight of each checkpoint directory, whichever manager
# started it: a read through any manager of that directory waits for it.
_WRITERS: dict[str, threading.Thread] = {}
_WRITERS_LOCK = threading.Lock()


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


def _fsync_dir(path: str) -> None:
    """Make a rename in ``path`` durable (a no-op where directories
    cannot be opened)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _map_tensors(obj, fn):
    """``obj`` with every tensor in its dicts, lists and tuples replaced
    by ``fn(tensor)``."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, dict):
        return {k: _map_tensors(v, fn) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_map_tensors(v, fn) for v in obj)
    return obj


class _Staged:
    """A host snapshot of a checkpoint blob in the making: ``blob`` holds
    host tensors that are final once :meth:`ready` returns.

    A CUDA tensor is copied from where it lives, with no second copy on
    the card: a side stream waits for the work queued so far, copies to
    pinned host memory, and the current stream waits for that copy (on
    the card; the host goes on) before the loop's next kernel can write
    the tensor in place."""

    def __init__(self, blob: dict):
        self._event = None
        cuda = []

        def snap(t):
            t = t.detach()
            if t.device.type != "cuda":
                return t.clone()  # the CPU: the copy is the snapshot
            cuda.append(t)
            return t

        staged = _map_tensors(blob, snap)
        if cuda:
            device = cuda[0].device
            current = torch.cuda.current_stream(device)
            side = torch.cuda.Stream(device)
            side.wait_stream(current)
            hosts = {}
            with torch.cuda.stream(side):
                for t in cuda:
                    host = torch.empty(t.shape, dtype=t.dtype,
                                       pin_memory=True)
                    host.copy_(t, non_blocking=True)
                    hosts[id(t)] = host
            self._event = torch.cuda.Event()
            self._event.record(side)
            current.wait_event(self._event)
            staged = _map_tensors(staged, lambda t: hosts.get(id(t), t))
        self.blob = staged

    def ready(self) -> dict:
        """Wait for the copy to the host → the blob."""
        if self._event is not None:
            self._event.synchronize()
            self._event = None
        return self.blob


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

    ``async_save`` (default True) writes on a writer thread, as the
    module docstring says; ``in_flight`` is the epoch it is writing, or
    None. ``layout`` (a ``parallel/tp.ShardLayout``): the state is this
    rank's shard of a model on a mesh; the file holds the full one.
    """

    def __init__(self, directory: str = "./checkpoints", *,
                 max_to_keep: int | None = None, is_main: bool = True,
                 keep_best_metric: str | None = None,
                 async_save: bool = True, layout=None):
        self._dir = os.path.abspath(directory)
        self.layout = layout
        self.max_to_keep = max_to_keep
        self.keep_best_metric = keep_best_metric
        self.is_main = is_main
        self.async_save = async_save
        self.quarantined: list[dict] = []
        self.last_restored_spe: int | None = None
        self.last_restored_mid_batch = 0
        self.in_flight: int | None = None
        self._error: BaseException | None = None

    @property
    def directory(self) -> str:
        return self._dir

    def wait(self) -> None:
        """Block until the save in flight in this directory (from this
        manager or another) is durable, its manifest written and
        retention applied; raise what this manager's writer raised."""
        with _WRITERS_LOCK:
            writer = _WRITERS.get(self._dir)
        if writer is not None:
            writer.join()
            with _WRITERS_LOCK:
                if _WRITERS.get(self._dir) is writer:
                    del _WRITERS[self._dir]
        error, self._error = self._error, None
        if error is not None:
            raise RuntimeError(
                f"the checkpoint save of epoch {self.in_flight} failed: "
                f"{error}") from error
        self.in_flight = None

    def close(self) -> None:
        """:meth:`wait`; the manager may be dropped afterwards."""
        self.wait()

    def _committed_epochs(self) -> list[int]:
        try:
            names = os.listdir(self._dir)
        except FileNotFoundError:
            return []
        return sorted(int(m.group(1)) for n in names
                      if (m := _EPOCH_DIR.match(n))
                      and os.path.isdir(os.path.join(self._dir, n)))

    def all_epochs(self) -> list[int]:
        """Every committed epoch tag, ascending (after any save in
        flight)."""
        self.wait()
        return self._committed_epochs()

    def latest_epoch(self) -> int | None:
        epochs = self.all_epochs()
        return epochs[-1] if epochs else None

    def verify_epoch(self, epoch: int) -> list[str] | None:
        self.wait()
        return verify_manifest(self._dir, epoch)

    def _delete_epoch(self, epoch: int) -> None:
        shutil.rmtree(os.path.join(self._dir, f"epoch_{epoch}"),
                      ignore_errors=True)
        try:
            os.remove(_manifest_path(self._dir, epoch))
        except OSError:
            pass

    def _metrics_of(self, epoch: int) -> dict | None:
        path = os.path.join(self._dir, f"epoch_{epoch}", METRICS_FILE)
        return _read_json(path) if os.path.exists(path) else None

    def saved_metrics(self, epoch: int) -> dict | None:
        """The metrics ``epoch`` was saved with, or None (a save without
        metrics)."""
        self.wait()
        return self._metrics_of(epoch)

    def _prune(self) -> None:
        """Retention over the committed epochs (the writer runs it after
        its commit, the only save in flight)."""
        epochs = self._committed_epochs()
        if not epochs:
            return
        if self.keep_best_metric:
            name, seen = self.keep_best_metric, {}
            for e in epochs:
                m = self._metrics_of(e)
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
        sees the same directory, after rank 0's previous save committed)
        and after. Same-epoch conflicts (``checkpoint.py:629-639``): an
        existing ``epoch_N`` (a preemption's artifact) is kept without
        ``overwrite`` and the save is skipped — a later save supersedes
        it, and no crash window leaves the directory without a usable
        latest; with ``overwrite`` it is deleted, then saved (a crash in
        between falls back to the epoch before: recompute, never
        corruption). ``mid_batch`` > 0 marks a preempted epoch;
        ``metrics`` ride in ``metrics.json`` for ``keep_best_metric``.
        Under ``async_save`` it returns once the state is snapshotted;
        the writer thread does the rest.
        """
        final = os.path.join(self._dir, f"epoch_{epoch}")
        self.wait()  # at most one save in flight
        sync_global_devices("ckpt_save_begin")
        exists = os.path.isdir(final)
        sync_global_devices("ckpt_save_looked")  # no write before every look
        if exists and not overwrite:
            logger.info("Checkpoint for epoch %d already exists (preemption "
                        "artifact) — keeping it; a later save supersedes it",
                        epoch)
            return False
        params = state.model.state_dict()
        opt_state = state.optimizer.state_dict(copy=False)
        if self.layout is not None:  # collectives: every rank gathers
            params = self.layout.gather(params)
            opt_state = self.layout.gather_opt(opt_state)
        if self.is_main:
            if exists:
                self._delete_epoch(epoch)
            os.makedirs(self._dir, exist_ok=True)
            staged = _Staged({
                "step": int(state.step),
                "params": params,
                "opt_state": opt_state,
                "model_state": state.model_state,
                "spe": int(steps_per_epoch),
                "mid_batch": int(mid_batch),
                "fmt": CHECKPOINT_FORMAT,
            })
            job = (epoch, staged, None if metrics is None else dict(metrics))
            self.in_flight = epoch
            if self.async_save:
                writer = threading.Thread(
                    target=self._write_guarded, args=job,
                    name=f"ckpt-writer-epoch{epoch}")
                # Started before it is visible: another manager's wait()
                # (a rank in a thread of this process) may join it at once.
                with _WRITERS_LOCK:
                    writer.start()
                    _WRITERS[self._dir] = writer
            else:
                self._write(*job)
                self.in_flight = None
        sync_global_devices("ckpt_save")
        return True

    def _write_guarded(self, *job) -> None:
        try:
            self._write(*job)
        except BaseException as e:  # raised again by wait()
            self._error = e

    def _write(self, epoch: int, staged: _Staged, metrics) -> None:
        """The writer's work: the blob into a temporary directory, the
        rename (the commit point), then the manifest and retention."""
        final = os.path.join(self._dir, f"epoch_{epoch}")
        tmp = f"{final}.tmp-{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        self._write_files(tmp, staged.ready(), metrics)
        self._commit(tmp, final)
        write_manifest(self._dir, epoch)
        self._prune()

    @staticmethod
    def _write_files(tmp: str, blob: dict, metrics) -> None:
        with open(os.path.join(tmp, STATE_FILE), "wb") as f:
            torch.save(blob, f)
            f.flush()
            os.fsync(f.fileno())
        if metrics is not None:
            _write_json(os.path.join(tmp, METRICS_FILE), metrics)
        _fsync_dir(tmp)

    def _commit(self, tmp: str, final: str) -> None:
        os.rename(tmp, final)  # the commit point
        _fsync_dir(self._dir)

    def quarantine_epoch(self, epoch: int, problems: list[str]) -> str | None:
        """Rename a corrupt epoch aside to ``quarantine.epoch-N`` (its
        manifest moves inside); returns the new path, or None when the
        rename failed."""
        self.wait()
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
        self.wait()
        path = os.path.join(self._dir, f"epoch_{epoch}", STATE_FILE)
        return torch.load(path, map_location=device, weights_only=True)

    def read_params(self, epoch: int) -> dict:
        """``epoch``'s parameters, memory-mapped from the file: a tensor's
        bytes are read when it is used, and nothing else of the
        checkpoint (the optimizer's moments) is read at all."""
        self.wait()
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
        self.wait()
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
        state.model.load_state_dict(self.local(blob["params"]))
        opt_state = blob["opt_state"]
        if self.layout is not None:
            opt_state = self.layout.shard_opt(opt_state)
        state.optimizer.load_state_dict(opt_state)
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

    def local(self, params: dict) -> dict:
        """This rank's shard of full ``params`` (they as they are without
        a layout)."""
        return params if self.layout is None else self.layout.shard(params)

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
