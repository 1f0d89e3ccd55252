"""A text file as byte-level causal-LM data.

A numpy copy of the byte-level branch of ``ddp_tpu/data/text.py``
(vocab ≤ 256, raw bytes as tokens). The BPE branch (vocab > 256) is not
ported yet; it raises here.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class Split(NamedTuple):
    """One split of [N, seq_len] int32 token sequences; labels are zeros
    (the LM's targets are the shifted tokens themselves)."""

    images: np.ndarray
    labels: np.ndarray


def load_text_corpus(
    path: str,
    seq_len: int,
    *,
    vocab_size: int = 256,
    test_fraction: float = 0.1,
) -> tuple[Split, Split]:
    """File of bytes → (train, test) Splits, chunked into non-overlapping
    ``seq_len`` sequences and cut by sequence index (the test tail never
    leaks into a training window)."""
    if vocab_size > 256:
        raise ValueError(
            f"--vocab_size {vocab_size} > 256 needs the BPE tokenizer, which "
            "the port does not have yet; use --vocab_size 256 or less"
        )
    data = np.fromfile(path, dtype=np.uint8)
    if vocab_size < 256:
        hi = int(data.max())
        if hi >= vocab_size:
            raise ValueError(
                f"{path} contains byte {hi} ≥ --vocab_size {vocab_size}; "
                "use --vocab_size 256 for arbitrary files"
            )
    n_seq = len(data) // seq_len
    if n_seq < 2:
        raise ValueError(
            f"{path}: {len(data)} tokens yield {n_seq} sequences of "
            f"length {seq_len}; need at least 2 (shrink --seq_len?)"
        )
    tokens = (
        np.asarray(data[: n_seq * seq_len])
        .reshape(n_seq, seq_len)
        .astype(np.int32)
    )
    n_test = max(1, int(n_seq * test_fraction))
    n_train = n_seq - n_test
    mk = lambda t: Split(t, np.zeros(len(t), np.int32))  # noqa: E731
    return mk(tokens[:n_train]), mk(tokens[n_train:])
