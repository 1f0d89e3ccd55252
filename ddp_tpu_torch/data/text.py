"""A text file as causal-LM data, byte-level or BPE subwords.

A numpy copy of ``ddp_tpu/data/text.py``: ``vocab_size`` ≤ 256 takes
raw bytes as tokens; above, a BPE tokenizer (``data/bpe.py``) trained on
the leading train fraction of the byte stream (the test tail never
shapes the vocabulary), or the one already at ``tokenizer_path``.
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
    tokenizer_path: str | None = None,
) -> tuple[Split, Split]:
    """File of text → (train, test) Splits, chunked into non-overlapping
    ``seq_len`` sequences and cut by sequence index (the test tail never
    leaks into a training window). ``vocab_size > 256``: BPE ids, the
    tokenizer reused from ``tokenizer_path`` when it exists, else trained
    and saved there."""
    data = np.fromfile(path, dtype=np.uint8)
    if vocab_size > 256:
        from ddp_tpu_torch.data.bpe import load_or_train

        n_train_bytes = len(data) - max(1, int(len(data) * test_fraction))
        tok = load_or_train(tokenizer_path, data[:n_train_bytes].tobytes(),
                            vocab_size)
        data = tok.encode(data.tobytes())
    elif vocab_size < 256:
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
    if n_train < 1:
        raise ValueError(f"{path}: corpus too small to split ({n_seq} seqs)")
    mk = lambda t: Split(t, np.zeros(len(t), np.int32))  # noqa: E731
    return mk(tokens[:n_train]), mk(tokens[n_train:])
