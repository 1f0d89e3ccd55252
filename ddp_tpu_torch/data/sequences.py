"""Synthetic token streams for causal-LM training (offline, deterministic).

A numpy copy of ``ddp_tpu/data/sequences.py:synthetic_tokens``: the same
seed gives the same array in both packages.
"""

from __future__ import annotations

import numpy as np


def synthetic_tokens(
    num: int,
    *,
    total_len: int = 2048,
    vocab_size: int = 64,
    seed: int = 0,
) -> np.ndarray:
    """Arithmetic progressions ``(start + stride·t) mod V`` with a
    per-sample start and stride from {1, 2, 3, 5, 7}: after two tokens
    the continuation is determined, so a working LM drives next-token
    accuracy toward 1 (and a causal mask that peeks shows as instant
    perfection). Returns ``[num, total_len]`` int32."""
    rng = np.random.default_rng(seed)
    strides = np.asarray([1, 2, 3, 5, 7])
    start = rng.integers(0, vocab_size, size=(num, 1))
    stride = strides[rng.integers(0, len(strides), size=(num, 1))]
    t = np.arange(total_len)[None, :]
    return ((start + stride * t) % vocab_size).astype(np.int32)
