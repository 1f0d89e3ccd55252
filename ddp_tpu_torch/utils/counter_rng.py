"""A counter-based generator in integer ops: the same bits on any device.

The JAX package draws from threefry keys (``fold_in``), which torch
cannot reproduce. Where the port needs seeded randomness that is
deterministic across a resume and independent across lanes or ranks
(sampling in ``models/generate``, augmentation in ``data/augment``), it
hashes (key, counter) with :func:`mix32`, on uint32 values held in int64
tensors, or on Python ints.
"""

from __future__ import annotations

M32 = 0xFFFFFFFF


def _mul32(x, c: int):
    """(x · c) mod 2³² for int64 tensors holding uint32 values, with no
    int64 overflow (the product is formed from 16-bit halves)."""
    lo = x & 0xFFFF
    hi = x >> 16
    return (lo * c + ((hi * (c & 0xFFFF)) << 16)) & M32


def mix32(x):
    """A 32-bit integer hash (Wellons' lowbias32), a bijection on
    uint32 values held in int64 tensors (or Python ints)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def fold(*words: int) -> int:
    """A 32-bit key from integers, each folded in after the last."""
    key = 0x9E3779B9
    for w in words:
        key = mix32(key ^ (int(w) & M32))
    return key
