"""ctypes bindings for the native (C++) data plane
(``ddp_tpu/native/__init__.py``; ``dataio.cpp`` is a copy of its source).

IDX decode, CIFAR batch decode, binary PPM/PGM decode and a threaded
batch gather (:class:`NativePrefetcher`, the C++ analogue of
``DataLoader(num_workers=N)``). The library is compiled with the system
``g++`` at first use, never at import (a plain C ABI bound with
``ctypes``), into ``_build/`` beside the source, keyed by a hash of the
source; where no toolchain is present ``available()`` is False and the
Python paths keep working.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

logger = logging.getLogger("ddp_tpu_torch")

_SRC = Path(__file__).resolve().parent / "dataio.cpp"
_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
_TRIED = False

# IDX dtype code → numpy dtype (big-endian where multi-byte, as stored).
_IDX_DTYPES = {
    0x08: np.dtype(np.uint8),
    0x09: np.dtype(np.int8),
    0x0B: np.dtype(">i2"),
    0x0C: np.dtype(">i4"),
    0x0D: np.dtype(">f4"),
    0x0E: np.dtype(">f8"),
}


def _cache_path() -> Path:
    """Where the compiled library lives, keyed by a source hash."""
    tag = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    return _SRC.parent / "_build" / f"libdataio-{tag}.so"


def _build() -> Path:
    out = _cache_path()
    if out.exists():
        return out
    out.parent.mkdir(exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=str(out.parent))
    os.close(fd)
    cmd = [
        "g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
        str(_SRC), "-o", tmp, "-lz",
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
        os.replace(tmp, out)  # atomic: concurrent builders race benignly
    except subprocess.CalledProcessError as e:
        os.unlink(tmp)
        raise RuntimeError(f"native build failed: {e.stderr}") from e
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    return out


def _load() -> ctypes.CDLL | None:
    global _LIB, _TRIED
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        try:
            lib = ctypes.CDLL(str(_build()))
        except (OSError, RuntimeError) as e:
            logger.warning("native data pipeline unavailable: %s", e)
            return None
        lib.dt_idx_read.restype = ctypes.c_int
        lib.dt_idx_read.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int64 * 8,
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.dt_free.restype = None
        lib.dt_free.argtypes = [ctypes.c_void_p]
        lib.dt_cifar_decode.restype = ctypes.c_int
        lib.dt_cifar_decode.argtypes = [
            ctypes.c_char_p,
            ctypes.c_int64,
            ctypes.c_int32,
            ctypes.c_void_p,
            ctypes.c_void_p,
        ]
        lib.dt_loader_create.restype = ctypes.c_void_p
        lib.dt_loader_create.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32,
        ]
        lib.dt_loader_start_epoch.restype = None
        lib.dt_loader_start_epoch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ]
        lib.dt_loader_next.restype = ctypes.c_int
        lib.dt_loader_next.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.dt_loader_destroy.restype = None
        lib.dt_loader_destroy.argtypes = [ctypes.c_void_p]
        lib.dt_ppm_read.restype = ctypes.c_int
        lib.dt_ppm_read.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
        ]
        _LIB = lib
        return _LIB


def available(build: bool = True) -> bool:
    """True when the native library is loaded (or loadable).

    ``build=False`` never triggers a compile: it answers True only if
    the library is already loaded or a cached build exists on disk —
    callers with a cheap Python fallback (e.g. the IDX reader) use this
    so a cold environment doesn't pay a blocking g++ run for four small
    files. The prefetcher path (which has no fallback) builds on demand.
    """
    if _LIB is not None:
        return True
    if not build:
        try:
            if not _cache_path().exists():
                return False
        except OSError:
            return False
    return _load() is not None


def read_idx(path: str | os.PathLike) -> np.ndarray:
    """Decode an IDX file (raw or gzipped) natively.

    The contract of a Python IDX parser on the decompressed bytes.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    data = ctypes.POINTER(ctypes.c_uint8)()
    length = ctypes.c_int64()
    ndim = ctypes.c_int32()
    dims = (ctypes.c_int64 * 8)()
    dtype_code = ctypes.c_int32()
    rc = lib.dt_idx_read(
        os.fspath(path).encode(), ctypes.byref(data), ctypes.byref(length),
        ctypes.byref(ndim), dims, ctypes.byref(dtype_code),
    )
    if rc != 0:
        raise ValueError(
            f"dt_idx_read({path!r}) failed: "
            f"{ {1: 'io error', 2: 'bad gzip', 3: 'bad header', 4: 'size mismatch'}.get(rc, rc) }"
        )
    try:
        dt = _IDX_DTYPES[dtype_code.value]
        flat = np.ctypeslib.as_array(data, shape=(length.value,)).view(dt)
        return flat.reshape(tuple(dims[i] for i in range(ndim.value))).copy()
    finally:
        lib.dt_free(data)


def read_ppm(path: str | os.PathLike) -> np.ndarray:
    """Decode a binary PPM (P6) / PGM (P5) file natively → [H, W, C].

    Same contract as ``ddp_tpu_torch.data.ppm.parse_ppm``, its fast
    path in the raw-image ImageNet ingest.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    data = ctypes.POINTER(ctypes.c_uint8)()
    h = ctypes.c_int32()
    w = ctypes.c_int32()
    c = ctypes.c_int32()
    rc = lib.dt_ppm_read(
        os.fspath(path).encode(), ctypes.byref(data), ctypes.byref(h),
        ctypes.byref(w), ctypes.byref(c),
    )
    if rc != 0:
        raise ValueError(
            f"dt_ppm_read({path!r}) failed: "
            f"{ {1: 'io error', 3: 'bad header', 4: 'truncated payload'}.get(rc, rc) }"
        )
    try:
        n = h.value * w.value * c.value
        flat = np.ctypeslib.as_array(data, shape=(n,))
        return flat.reshape(h.value, w.value, c.value).copy()
    finally:
        lib.dt_free(data)


def cifar_decode(raw: bytes, label_bytes: int) -> tuple[np.ndarray, np.ndarray]:
    """Decode a CIFAR binary batch natively (CHW→HWC transpose in C++).

    The contract of a CIFAR record parser on the raw member bytes.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    record = label_bytes + 3072
    if label_bytes not in (1, 2) or not raw or len(raw) % record:
        raise ValueError(
            f"malformed CIFAR batch: {len(raw)} bytes, record {record}"
        )
    n = len(raw) // record
    # Caller-allocated outputs (dt_loader_next convention): C++ fills
    # the numpy buffers directly, no malloc/copy/free round-trip.
    images = np.empty((n, 32, 32, 3), np.uint8)
    labels = np.empty((n,), np.int32)
    rc = lib.dt_cifar_decode(
        raw, len(raw), label_bytes,
        images.ctypes.data, labels.ctypes.data,
    )
    if rc != 0:
        raise ValueError(f"dt_cifar_decode failed: code {rc}")
    return images, labels


class NativePrefetcher:
    """Threaded batch assembly over a memory-resident dataset.

    The native analogue of ``DataLoader(num_workers=N, pin_memory=True)``
    (reference data.py:21-25): C++ workers gather sample rows into a ring
    of staging buffers ahead of the training loop. The *index plan* for
    each epoch comes from the caller (the ShardSampler), so shuffle
    determinism and DistributedSampler parity stay in one place.
    """

    def __init__(
        self,
        images: np.ndarray,
        labels: np.ndarray,
        batch_size: int,
        *,
        num_workers: int = 2,
        queue_depth: int = 8,
    ):
        lib = _load()
        if lib is None:
            raise RuntimeError("native library unavailable")
        if images.dtype != np.uint8:
            raise TypeError(f"images must be uint8, got {images.dtype}")
        if len(images) != len(labels):
            raise ValueError("image/label count mismatch")
        # Keep contiguous owned references alive for the C++ side.
        self._images = np.ascontiguousarray(images)
        self._labels = np.ascontiguousarray(labels, dtype=np.int32)
        self._item_shape = self._images.shape[1:]
        self._item_bytes = int(np.prod(self._item_shape)) if self._item_shape else 1
        self.batch_size = int(batch_size)
        self._lib = lib
        self._handle = lib.dt_loader_create(
            self._images.ctypes.data, self._labels.ctypes.data,
            len(self._images), self._item_bytes, self.batch_size,
            int(num_workers), int(queue_depth),
        )
        if not self._handle:
            raise RuntimeError("dt_loader_create failed")
        self._draining = False

    def epoch(self, indices: np.ndarray, out=None):
        """Yield ``(images, labels)`` batches for the given index plan.

        ``out(b) -> (images, labels)``, when given, names the arrays that
        batch ``b`` is gathered into (contiguous uint8 [batch, *item] and
        int32 [batch], e.g. views of pinned host buffers); by default
        each batch gets new arrays."""
        if self._handle is None:
            raise RuntimeError("prefetcher closed")
        if self._draining:
            raise RuntimeError("previous epoch not fully drained")
        idx = np.ascontiguousarray(indices, dtype=np.int64)
        if idx.size and (idx.min() < 0 or idx.max() >= len(self._images)):
            raise IndexError("index plan out of range")
        self._lib.dt_loader_start_epoch(self._handle, idx.ctypes.data, idx.size)
        self._draining = True
        try:
            n_batches = idx.size // self.batch_size
            for b in range(n_batches):
                if out is None:
                    img = np.empty((self.batch_size, *self._item_shape),
                                   np.uint8)
                    lbl = np.empty((self.batch_size,), np.int32)
                else:
                    img, lbl = out(b)
                    self._check_out(img, lbl)
                rc = self._lib.dt_loader_next(
                    self._handle, img.ctypes.data, lbl.ctypes.data
                )
                if rc != 1:
                    raise RuntimeError(
                        f"dt_loader_next ended the epoch at batch {b} of "
                        f"{n_batches}")
                yield img, lbl
        finally:
            # If the consumer abandoned the epoch mid-way, drain the
            # remaining batches so workers quiesce and the next
            # start_epoch is safe. close() may already have destroyed
            # the handle (generator GC'd after Trainer.close()).
            if self._handle is not None:
                scratch_i = np.empty(
                    (self.batch_size, *self._item_shape), np.uint8
                )
                scratch_l = np.empty((self.batch_size,), np.int32)
                while self._lib.dt_loader_next(
                    self._handle, scratch_i.ctypes.data, scratch_l.ctypes.data
                ):
                    pass
            self._draining = False

    def _check_out(self, img: np.ndarray, lbl: np.ndarray) -> None:
        """The native side writes through raw pointers: shapes, dtypes
        and layouts must be exactly the batch's."""
        want = (self.batch_size, *self._item_shape)
        if (img.dtype != np.uint8 or img.shape != want
                or not img.flags.c_contiguous or not img.flags.writeable):
            raise ValueError(f"batch images must be writable contiguous "
                             f"uint8 {want}, got {img.dtype} {img.shape}")
        if (lbl.dtype != np.int32 or lbl.shape != (self.batch_size,)
                or not lbl.flags.c_contiguous or not lbl.flags.writeable):
            raise ValueError(f"batch labels must be writable contiguous "
                             f"int32 [{self.batch_size}], got {lbl.dtype} "
                             f"{lbl.shape}")

    def close(self) -> None:
        if self._handle is not None:
            self._lib.dt_loader_destroy(self._handle)
            self._handle = None

    def __del__(self):  # best-effort; close() is the real API
        try:
            self.close()
        except Exception:
            pass
