"""ddp_tpu_torch's PPM decode and ImageNet preprocessing ≡ the JAX
package's, on the CPU.

``data/ppm.py`` against ``ddp_tpu/data/ppm.py`` (parse, errors, resize,
crop, the decode recipe), and ``python -m
ddp_tpu_torch.data.preprocess_imagenet`` against
``scripts/preprocess_imagenet.py`` on an ImageFolder tree of PPM/PGM
files written here: every output file byte for byte, and the same
refusals.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from ddp_tpu.data import ppm as jppm
from ddp_tpu_torch.data import ppm, preprocess_imagenet

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _ppm_bytes(img: np.ndarray, comment: bool = False) -> bytes:
    magic = b"P6" if img.shape[2] == 3 else b"P5"
    h, w = img.shape[:2]
    note = b"# made by a test\n" if comment else b""
    return magic + b"\n" + note + f"{w} {h}\n255\n".encode() + img.tobytes()


@pytest.mark.parametrize("channels,comment", [(3, False), (1, True),
                                              (3, True)])
def test_parse_equals_jax(channels, comment):
    img = np.random.default_rng(0).integers(0, 256, (9, 13, channels),
                                            dtype=np.uint8)
    raw = _ppm_bytes(img, comment)
    got = ppm.parse_ppm(raw)
    assert np.array_equal(got, img)
    assert np.array_equal(got, jppm.parse_ppm(raw))
    assert got.flags.writeable


@pytest.mark.parametrize("raw", [
    b"JPEG", b"P6\n2 2\n255\n" + b"\x00" * 5, b"P6\n2 2 \n65535\n" + b"\0" * 24,
    b"P6\n2 x\n255\n", b"P6\n2 2\n255",
])
def test_parse_errors_equal_jax(raw):
    with pytest.raises(ValueError) as got:
        ppm.parse_ppm(raw)
    with pytest.raises(ValueError) as want:
        jppm.parse_ppm(raw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("shape,out", [((40, 48, 3), (36, 43)),
                                       ((17, 9, 1), (30, 20)),
                                       ((64, 64, 3), (32, 32))])
def test_resize_and_crop_equal_jax(shape, out):
    img = np.random.default_rng(1).integers(0, 256, shape, dtype=np.uint8)
    got = ppm.resize_bilinear(img, *out)
    assert np.array_equal(got, jppm.resize_bilinear(img, *out))
    assert np.array_equal(ppm.center_crop(got, 16),
                          jppm.center_crop(got, 16))


@pytest.mark.parametrize("shape", [(40, 56, 3), (50, 30, 1)])
def test_decode_resized_equals_jax(tmp_path, shape):
    img = np.random.default_rng(2).integers(0, 256, shape, dtype=np.uint8)
    path = tmp_path / "x.ppm"
    path.write_bytes(_ppm_bytes(img))
    got = ppm.decode_resized(str(path), 36, 32)
    assert got.shape == (32, 32, 3)
    assert np.array_equal(got, jppm.decode_resized(str(path), 36, 32))


def _tree(root, classes, per_class, *, val=True, seed=3):
    rng = np.random.default_rng(seed)
    for split, n in (("train", per_class), ("val", 2)):
        if split == "val" and not val:
            continue
        for c, cls in enumerate(classes):
            d = root / split / cls
            d.mkdir(parents=True)
            for i in range(n):
                ch = 1 if (i + c) % 3 == 0 else 3
                h, w = rng.integers(30, 60, 2)
                img = rng.integers(0, 256, (h, w, ch), dtype=np.uint8)
                ext = ".pgm" if ch == 1 else ".ppm"
                (d / f"img{i}{ext}").write_bytes(_ppm_bytes(img))


def _run_jax(argv):
    """scripts/preprocess_imagenet.py, as a user runs it."""
    res = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts",
                                      "preprocess_imagenet.py"), *argv],
        capture_output=True, text=True, timeout=120,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    return res


def test_preprocess_outputs_equal_the_script_byte_for_byte(tmp_path):
    src = tmp_path / "src"
    _tree(src, ["n02", "n01", "n03"], per_class=3)
    argv = ["--src", str(src), "--size", "24", "--resize", "28",
            "--workers", "1"]
    res = _run_jax(argv + ["--out", str(tmp_path / "jax")])
    assert res.returncode == 0, res.stderr[-2000:]
    assert preprocess_imagenet.main(argv + ["--out",
                                            str(tmp_path / "port")]) == 0
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) == [
        "imagenet_classes.json", "imagenet_test_images.npy",
        "imagenet_test_labels.npy", "imagenet_train_images.npy",
        "imagenet_train_labels.npy"]
    for name in names:
        assert ((tmp_path / "jax" / name).read_bytes()
                == (tmp_path / "port" / name).read_bytes()), name
    images = np.load(tmp_path / "port" / "imagenet_train_images.npy")
    assert images.shape == (9, 24, 24, 3)


@pytest.mark.parametrize("case,match", [
    ("no_train", "no train/ split"), ("both", "BOTH val/ and test/"),
    ("unknown", "not present in the train split"), ("empty", "no images"),
])
def test_preprocess_refusals_equal_the_script(tmp_path, case, match):
    src = tmp_path / "src"
    if case == "no_train":
        src.mkdir()
    else:
        _tree(src, ["a", "b"], per_class=1, val=case != "empty")
    if case == "both":
        (src / "test" / "a").mkdir(parents=True)
    elif case == "unknown":
        (src / "val" / "zzz").mkdir()
    elif case == "empty":
        (src / "val" / "a").mkdir(parents=True)
    argv = ["--src", str(src), "--out", str(tmp_path / "out"),
            "--workers", "1"]
    with pytest.raises(SystemExit, match=match):
        preprocess_imagenet.main(argv)
    res = _run_jax(argv)
    assert res.returncode != 0 and match in res.stderr
