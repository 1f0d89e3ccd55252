"""Raw-image decode with numpy alone (``ddp_tpu/data/ppm.py``): binary
PPM (P6, RGB) and PGM (P5, grayscale), the zero-dependency interchange
formats every image tool writes (``convert x.jpg x.ppm``), with the
bilinear resize and centre crop that preprocessing applies.

``read_ppm`` takes the native reader (``native/dataio.cpp``
``dt_ppm_read``) when its library is already built, else
:func:`parse_ppm`; both give the same array.
"""

from __future__ import annotations

import numpy as np


def parse_ppm(raw: bytes) -> np.ndarray:
    """Binary PPM (P6) / PGM (P5) bytes → uint8 [H, W, C].

    Header: magic, then width, height and maxval separated by whitespace
    and ``#`` comments, then ONE whitespace byte, then the payload.
    maxval must fit a byte (the 16-bit variant is refused).
    """
    if len(raw) < 2 or raw[:1] != b"P" or raw[1:2] not in (b"5", b"6"):
        raise ValueError("not a binary PPM/PGM (magic P5/P6)")
    channels = 3 if raw[1:2] == b"6" else 1
    pos = 2
    fields = []
    while len(fields) < 3:
        while pos < len(raw) and raw[pos:pos + 1].isspace():
            pos += 1
        if pos < len(raw) and raw[pos:pos + 1] == b"#":
            while pos < len(raw) and raw[pos:pos + 1] != b"\n":
                pos += 1
            continue
        start = pos
        while pos < len(raw) and raw[pos:pos + 1].isdigit():
            pos += 1
        if start == pos:
            raise ValueError("malformed PPM header")
        fields.append(int(raw[start:pos]))
    if pos >= len(raw) or not raw[pos:pos + 1].isspace():
        raise ValueError("malformed PPM header (no payload separator)")
    pos += 1
    w, h, maxval = fields
    if w <= 0 or h <= 0 or not 0 < maxval <= 255:
        raise ValueError(f"unsupported PPM dims/maxval {fields}")
    n = h * w * channels
    payload = raw[pos:pos + n]
    if len(payload) < n:
        raise ValueError(f"truncated PPM payload: {len(payload)} < {n}")
    # copy(): a writable array, as the native reader returns.
    return np.frombuffer(payload, np.uint8).reshape(h, w, channels).copy()


def read_ppm(path: str) -> np.ndarray:
    """A PPM/PGM file → uint8 [H, W, C]; the native reader when its
    library is built (it never compiles here), else :func:`parse_ppm`."""
    from ddp_tpu_torch import native

    if native.available(build=False):
        try:
            return native.read_ppm(path)
        except (RuntimeError, ValueError):
            pass  # the Python parser says what is wrong with the file
    with open(path, "rb") as f:
        return parse_ppm(f.read())


def resize_bilinear(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """uint8 [H, W, C] → uint8 [out_h, out_w, C], bilinear, pixel-centre
    aligned."""
    h, w = img.shape[:2]
    y = np.clip((np.arange(out_h) + 0.5) * h / out_h - 0.5, 0, h - 1)
    x = np.clip((np.arange(out_w) + 0.5) * w / out_w - 0.5, 0, w - 1)
    y0 = np.floor(y).astype(np.int64)
    x0 = np.floor(x).astype(np.int64)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    wy = (y - y0).astype(np.float32)[:, None, None]
    wx = (x - x0).astype(np.float32)[None, :, None]
    f = img.astype(np.float32)
    top = f[y0][:, x0] * (1 - wx) + f[y0][:, x1] * wx
    bot = f[y1][:, x0] * (1 - wx) + f[y1][:, x1] * wx
    out = top * (1 - wy) + bot * wy
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def center_crop(img: np.ndarray, size: int) -> np.ndarray:
    h, w = img.shape[:2]
    top, left = (h - size) // 2, (w - size) // 2
    return img[top:top + size, left:left + size]


def decode_resized(path: str, resize: int, size: int) -> np.ndarray:
    """PPM/PGM file → [size, size, 3] uint8: the shorter side to
    ``resize``, then a centre crop of ``size`` (the PIL path's recipe)."""
    img = read_ppm(path)
    if img.shape[2] == 1:  # grayscale → RGB
        img = np.repeat(img, 3, axis=2)
    h, w = img.shape[:2]
    scale = resize / min(w, h)
    img = resize_bilinear(
        img, max(size, round(h * scale)), max(size, round(w * scale))
    )
    return center_crop(img, size)
