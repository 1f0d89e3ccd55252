"""ddp_tpu_torch's native data plane ≡ the JAX package's, on the CPU.

``ddp_tpu_torch/native/dataio.cpp`` is a copy of the JAX package's
source, bound by the port's own ctypes module (built with ``g++`` at
first use). The cases are ``tests/test_native.py``'s, each held against
the JAX binding and the Python decoders: IDX decode, CIFAR decode, PPM
decode, the threaded gather (batch for batch, a ring smaller than the
epoch, an abandoned epoch, index validation), plus the port's own
gather into caller buffers (the loader's pinned ring). All comparisons
are exact: this is integer data.
"""

import gzip
import struct

import numpy as np
import pytest

from ddp_tpu import native as jnative
from ddp_tpu_torch import native
from ddp_tpu_torch.data import cifar as tcifar
from ddp_tpu_torch.data.mnist import parse_idx
from ddp_tpu_torch.data.ppm import parse_ppm


def _idx_bytes(arr: np.ndarray, dtype_code: int) -> bytes:
    header = struct.pack(
        f">BBBB{arr.ndim}I", 0, 0, dtype_code, arr.ndim, *arr.shape
    )
    return header + arr.tobytes()


def test_library_builds_into_the_port_tree():
    assert native.available()
    path = native._cache_path()
    assert path.exists() and path.parent.name == "_build"
    assert path.parent.parent.name == "native"
    assert "ddp_tpu_torch" in path.parts


@pytest.mark.parametrize("compress", [False, True])
def test_read_idx_equals_jax_and_python(tmp_path, compress):
    rng = np.random.default_rng(0)
    arr = rng.integers(0, 256, size=(17, 5, 4), dtype=np.uint8)
    raw = _idx_bytes(arr, 0x08)
    path = tmp_path / ("a.idx.gz" if compress else "a.idx")
    path.write_bytes(gzip.compress(raw) if compress else raw)
    out = native.read_idx(path)
    np.testing.assert_array_equal(out, arr)
    np.testing.assert_array_equal(out, parse_idx(raw))
    np.testing.assert_array_equal(out, jnative.read_idx(path))


def test_read_idx_int32_big_endian(tmp_path):
    arr = np.arange(-5, 7, dtype=">i4").reshape(3, 4)
    path = tmp_path / "b.idx"
    path.write_bytes(_idx_bytes(arr, 0x0C))
    out = native.read_idx(path)
    assert out.dtype == np.dtype(">i4") == jnative.read_idx(path).dtype
    np.testing.assert_array_equal(out.astype(np.int32), arr.astype(np.int32))


@pytest.mark.parametrize("case,match", [
    ("missing", "io error"), ("bad", "bad header"), ("trunc", "size mismatch"),
])
def test_read_idx_errors_equal_jax(tmp_path, case, match):
    path = tmp_path / f"{case}.idx"
    if case == "bad":
        path.write_bytes(b"\x01\x02\x03\x04")
    elif case == "trunc":
        path.write_bytes(_idx_bytes(np.zeros((4, 3), np.uint8), 0x08)[:-5])
    with pytest.raises(ValueError, match=match):
        native.read_idx(path)
    with pytest.raises(ValueError, match=match):
        jnative.read_idx(path)


def _cifar_bytes(n, label_bytes, seed=0):
    rng = np.random.default_rng(seed)
    recs = []
    for _ in range(n):
        labels = rng.integers(0, 100, size=label_bytes, dtype=np.uint8)
        planes = rng.integers(0, 256, size=3072, dtype=np.uint8)
        recs.append(labels.tobytes() + planes.tobytes())
    return b"".join(recs)


@pytest.mark.parametrize("name,label_bytes", [("cifar10", 1), ("cifar100", 2)])
def test_cifar_decode_equals_jax_and_python(name, label_bytes):
    raw = _cifar_bytes(7, label_bytes)
    images, labels = native.cifar_decode(raw, label_bytes)
    want = tcifar.parse_records(raw, name=name)
    jimages, jlabels = jnative.cifar_decode(raw, label_bytes)
    np.testing.assert_array_equal(images, want.images)
    np.testing.assert_array_equal(labels, want.labels)
    np.testing.assert_array_equal(images, jimages)
    np.testing.assert_array_equal(labels, jlabels)
    assert images.flags["C_CONTIGUOUS"]


def test_cifar_decode_rejects_malformed():
    with pytest.raises(ValueError):
        native.cifar_decode(b"\x00" * 100, 1)
    with pytest.raises(ValueError):
        native.cifar_decode(_cifar_bytes(2, 1), 3)


@pytest.mark.parametrize("magic,channels", [(b"P6", 3), (b"P5", 1)])
def test_read_ppm_equals_jax_and_python(tmp_path, magic, channels):
    rng = np.random.default_rng(6)
    img = rng.integers(0, 256, size=(5, 7, channels), dtype=np.uint8)
    raw = magic + b"\n# a comment\n7 5\n255\n" + img.tobytes()
    path = tmp_path / "x.ppm"
    path.write_bytes(raw)
    out = native.read_ppm(path)
    np.testing.assert_array_equal(out, img)
    np.testing.assert_array_equal(out, parse_ppm(raw))
    np.testing.assert_array_equal(out, jnative.read_ppm(path))


def _gathers(images, labels, batch, workers, idx_list, **kw):
    """(port batches, JAX batches) for each plan of ``idx_list``."""
    out = []
    for mod in (native, jnative):
        pf = mod.NativePrefetcher(images, labels, batch_size=batch,
                                  num_workers=workers, **kw)
        try:
            out.append([[(i.copy(), l.copy()) for i, l in pf.epoch(idx)]
                        for idx in idx_list])
        finally:
            pf.close()
    return out


def test_prefetcher_equals_python_gather_and_jax():
    rng = np.random.default_rng(1)
    n, item = 257, (7, 3)
    images = rng.integers(0, 256, size=(n, *item), dtype=np.uint8)
    labels = rng.integers(0, 10, size=n).astype(np.int32)
    plans = [np.random.default_rng(e).permutation(n) for e in range(3)]
    port, jax_ = _gathers(images, labels, 16, 3, plans)
    for idx, got, want in zip(plans, port, jax_):
        assert len(got) == len(want) == n // 16
        for b, ((img, lbl), (jimg, jlbl)) in enumerate(zip(got, want)):
            sel = idx[b * 16:(b + 1) * 16]
            np.testing.assert_array_equal(img, images[sel])
            np.testing.assert_array_equal(lbl, labels[sel])
            np.testing.assert_array_equal(img, jimg)
            np.testing.assert_array_equal(lbl, jlbl)


def test_prefetcher_many_batches_small_ring():
    """More batches than ring slots forces slot reuse and ordering."""
    rng = np.random.default_rng(2)
    images = rng.integers(0, 256, size=(4096, 12), dtype=np.uint8)
    labels = np.arange(4096, dtype=np.int32) % 10
    pf = native.NativePrefetcher(images, labels, batch_size=32,
                                 num_workers=4, queue_depth=3)
    try:
        idx = rng.permutation(4096)
        total = 0
        for b, (img, lbl) in enumerate(pf.epoch(idx)):
            sel = idx[b * 32:(b + 1) * 32]
            np.testing.assert_array_equal(img, images[sel])
            np.testing.assert_array_equal(lbl, labels[sel])
            total += 1
        assert total == 128
    finally:
        pf.close()


def test_prefetcher_abandoned_epoch_recovers():
    rng = np.random.default_rng(3)
    images = rng.integers(0, 256, size=(640, 4), dtype=np.uint8)
    labels = np.zeros(640, np.int32)
    pf = native.NativePrefetcher(images, labels, batch_size=32, num_workers=2)
    try:
        it = pf.epoch(np.arange(640))
        next(it)
        it.close()  # abandoned mid-epoch: the drain quiesces the workers
        idx = rng.permutation(640)
        got = list(pf.epoch(idx))
        assert len(got) == 20
        np.testing.assert_array_equal(got[0][0], images[idx[:32]])
    finally:
        pf.close()


def test_prefetcher_index_validation():
    images = np.zeros((8, 2), np.uint8)
    labels = np.zeros(8, np.int32)
    pf = native.NativePrefetcher(images, labels, batch_size=4, num_workers=1)
    try:
        with pytest.raises(IndexError):
            next(pf.epoch(np.array([0, 1, 2, 99])))
    finally:
        pf.close()


def test_prefetcher_gathers_into_caller_buffers():
    """``epoch(idx, out=)`` fills the arrays it names (the loader's
    pinned ring): the same bytes, in the very buffers, which a wrong
    shape or dtype is refused before any native write."""
    rng = np.random.default_rng(4)
    images = rng.integers(0, 256, size=(96, 6, 5, 3), dtype=np.uint8)
    labels = rng.integers(0, 10, size=96).astype(np.int32)
    ring = [(np.empty((16, 6, 5, 3), np.uint8), np.empty(16, np.int32))
            for _ in range(2)]
    pf = native.NativePrefetcher(images, labels, batch_size=16,
                                 num_workers=2)
    try:
        idx = rng.permutation(96)
        for b, (img, lbl) in enumerate(pf.epoch(idx, out=lambda b: ring[b % 2])):
            assert img is ring[b % 2][0] and lbl is ring[b % 2][1]
            np.testing.assert_array_equal(img, images[idx[b * 16:][:16]])
            np.testing.assert_array_equal(lbl, labels[idx[b * 16:][:16]])
        bad = (np.empty((16, 6, 5, 3), np.int16), np.empty(16, np.int32))
        with pytest.raises(ValueError, match="uint8"):
            next(pf.epoch(idx, out=lambda b: bad))
        short = (np.empty((16, 6, 5, 3), np.uint8), np.empty(8, np.int32))
        with pytest.raises(ValueError, match="int32"):
            next(pf.epoch(idx, out=lambda b: short))
    finally:
        pf.close()
