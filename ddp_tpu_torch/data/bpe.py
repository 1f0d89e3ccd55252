"""A byte-pair-encoding tokenizer trained on the corpus itself
(``ddp_tpu/data/bpe.py``, a numpy copy).

Training starts from the 256 byte ids and repeatedly merges the most
frequent adjacent pair into a new id until ``vocab_size`` ids exist (or
no pair occurs twice); ties go to the smallest packed pair, so the same
bytes always give the same merges. Encoding replays the merges in
training order over the whole id stream; decoding expands each id
through a byte table built from the merges. The ``tokenizer.json`` a
trainer writes next to its checkpoints has the JAX package's format and
bytes: either package loads the other's.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

import numpy as np

FORMAT = "ddp_tpu-bpe-v1"


def _merge_pass(ids: np.ndarray, a: int, b: int, new_id: int) -> np.ndarray:
    """One full pass: every non-overlapping (a, b) → new_id, left to
    right (in a run ``aaa`` of a pair (a, a) the first pair merges)."""
    if len(ids) < 2:
        return ids
    idx = np.flatnonzero((ids[:-1] == a) & (ids[1:] == b))
    if len(idx) == 0:
        return ids
    if a == b:
        keep, last = [], -2
        for i in idx.tolist():
            if i > last + 1:
                keep.append(i)
                last = i
        idx = np.asarray(keep, dtype=idx.dtype)
    out = ids.copy()
    out[idx] = new_id
    return np.delete(out, idx + 1)


@dataclass(frozen=True)
class BPETokenizer:
    """``merges[k] = (a, b)`` mints id ``256 + k``."""

    merges: tuple[tuple[int, int], ...]

    @property
    def vocab_size(self) -> int:
        return 256 + len(self.merges)

    def encode(self, text: str | bytes) -> np.ndarray:
        data = text.encode("utf-8") if isinstance(text, str) else text
        ids = np.frombuffer(data, dtype=np.uint8).astype(np.int32)
        for k, (a, b) in enumerate(self.merges):
            ids = _merge_pass(ids, a, b, 256 + k)
        return ids

    def decode_bytes(self, ids) -> bytes:
        """An id the vocabulary never minted (a model may embed more rows
        than training produced) decodes to U+FFFD."""
        table = self._byte_table()
        unk = "�".encode()
        return b"".join(
            table[i] if 0 <= i < len(table) else unk
            for i in (int(t) for t in np.asarray(ids).ravel())
        )

    def decode(self, ids) -> str:
        return self.decode_bytes(ids).decode("utf-8", errors="replace")

    def _byte_table(self) -> list[bytes]:
        table = [bytes([i]) for i in range(256)]
        for a, b in self.merges:
            table.append(table[a] + table[b])
        return table

    def save(self, path: str) -> None:
        """Atomically, through a per-process temporary file: every rank
        of a world may train the same merges and save them at once."""
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            json.dump({"format": FORMAT,
                       "merges": [list(m) for m in self.merges]}, f)
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str) -> "BPETokenizer":
        with open(path) as f:
            obj = json.load(f)
        if obj.get("format") != FORMAT:
            raise ValueError(f"{path}: not a ddp_tpu BPE tokenizer file")
        return cls(merges=tuple((int(a), int(b)) for a, b in obj["merges"]))


def train_bpe(data: bytes, vocab_size: int) -> BPETokenizer:
    """Learn ``vocab_size - 256`` merges from a byte corpus; fewer when no
    adjacent pair occurs twice any more (check ``vocab_size``)."""
    if vocab_size < 257:
        raise ValueError(f"vocab_size {vocab_size} adds no merges (≤ 256)")
    ids = np.frombuffer(data, dtype=np.uint8).astype(np.int32)
    merges: list[tuple[int, int]] = []
    for new_id in range(256, vocab_size):
        if len(ids) < 2:
            break
        packed = (ids[:-1].astype(np.int64) << 32) | ids[1:].astype(np.int64)
        vals, counts = np.unique(packed, return_counts=True)
        top = int(counts.max())
        if top < 2:
            break
        best = int(vals[np.flatnonzero(counts == top)[0]])
        a, b = best >> 32, best & 0xFFFFFFFF
        merges.append((int(a), int(b)))
        ids = _merge_pass(ids, int(a), int(b), new_id)
    return BPETokenizer(merges=tuple(merges))


def load_or_train(path: str | None, data: bytes,
                  vocab_size: int) -> BPETokenizer:
    """The tokenizer at ``path`` when it exists (it is part of the model:
    a retrained vocabulary would remap every id), refused if it holds
    more ids than ``vocab_size``; else one trained on ``data`` and saved
    there."""
    if path and os.path.exists(path):
        tok = BPETokenizer.load(path)
        if tok.vocab_size > vocab_size:
            raise ValueError(
                f"{path} holds {tok.vocab_size} token ids but --vocab_size "
                f"is {vocab_size}; pass --vocab_size >= {tok.vocab_size} or "
                "remove the file to retrain"
            )
        return tok
    tok = train_bpe(data, vocab_size)
    if path:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tok.save(path)
    return tok
