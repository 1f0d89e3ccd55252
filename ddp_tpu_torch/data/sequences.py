"""Synthetic sequence data (offline, deterministic): the long-context
classifier's feature sequences and the causal LM's token streams.

A numpy copy of ``ddp_tpu/data/sequences.py``: the same seed gives the
same arrays in both packages.
"""

from __future__ import annotations

import numpy as np

from ddp_tpu_torch.data.text import Split

# The class templates' generator, fixed apart from the split seed: train
# and test agree on what a class looks like.
TEMPLATE_SEED = 0xC1A55


def synthetic(
    num: int,
    *,
    total_len: int = 2048,
    d_in: int = 16,
    num_classes: int = 10,
    seed: int = 0,
) -> Split:
    """``num`` sequences of ``[total_len, d_in]`` float32 features and
    their int32 labels: class c is a sine of frequency c + 1 (a random
    phase a sample) projected on the class's channel mix, plus half the
    class's channel bias (so a mean-pooling head learns something within
    a short run) and N(0, 0.3²) noise."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0.0, 1.0, total_len, dtype=np.float32)
    template_rng = np.random.default_rng(TEMPLATE_SEED)
    mixes = template_rng.normal(size=(num_classes, d_in)).astype(np.float32)
    biases = template_rng.normal(size=(num_classes, d_in)).astype(np.float32)
    labels = rng.integers(0, num_classes, size=num).astype(np.int32)
    waves = np.sin(
        2.0 * np.pi * (labels[:, None] + 1.0) * t[None, :]
        + rng.uniform(0, 2 * np.pi, size=(num, 1)).astype(np.float32)
    ).astype(np.float32)  # [N, T]
    x = waves[:, :, None] * mixes[labels][:, None, :]  # [N, T, d]
    x += 0.5 * biases[labels][:, None, :]
    x += rng.normal(0.0, 0.3, size=x.shape).astype(np.float32)
    return Split(x.astype(np.float32), labels)


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
