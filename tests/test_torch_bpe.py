"""ddp_tpu_torch's BPE tokenizer and text splits ≡ the JAX package's.

The same corpus through ``ddp_tpu.data.bpe`` and the port's numpy copy:
the same merges, the same ids, the same ``tokenizer.json`` bytes, each
package loading the other's file; the self-overlap case (``aaaa``); the
reuse of a saved tokenizer and the refusal of one larger than
``--vocab_size``; ``load_text_corpus``'s BPE splits at ``vocab_size`` 512;
and the causal-LM trainer writing ``tokenizer.json`` next to its
checkpoints and reusing it on resume. Everything is exact: integer ids
and bytes.
"""

import numpy as np
import pytest

from ddp_tpu.data import bpe as jbpe
from ddp_tpu.data import text as jtext
from ddp_tpu_torch.data import bpe as tbpe
from ddp_tpu_torch.data import text as ttext
from ddp_tpu_torch.train.trainer import main as train_main


def _corpus(seed=0, words=600) -> bytes:
    """Seeded text from a small word list (repeats make merges), with
    UTF-8 multibyte characters and runs of one letter."""
    rng = np.random.default_rng(seed)
    vocab = ["the", "model", "trains", "tokens", "aaaa", "bbb", "über",
             "naïve", "attention", "sequence", "kernel", "zzzzzz", "données"]
    return " ".join(vocab[i] for i in rng.integers(0, len(vocab), words)
                    ).encode("utf-8")


@pytest.mark.parametrize("vocab_size,seed", [(300, 0), (400, 1), (1024, 2)])
def test_merges_ids_and_json_bytes_equal_jax(tmp_path, vocab_size, seed):
    """train_bpe's merges, encode's ids and the saved file's bytes are
    JAX's; decode inverts encode; with more ids asked than the corpus can
    merge, both stop at the same point."""
    data = _corpus(seed)
    want = jbpe.train_bpe(data, vocab_size)
    got = tbpe.train_bpe(data, vocab_size)
    assert got.merges == want.merges
    assert got.vocab_size == want.vocab_size <= vocab_size
    np.testing.assert_array_equal(got.encode(data), want.encode(data))
    assert got.decode(got.encode(data)) == data.decode("utf-8")
    got.save(str(tmp_path / "t.json"))
    want.save(str(tmp_path / "j.json"))
    assert (tmp_path / "t.json").read_bytes() == (tmp_path / "j.json"
                                                  ).read_bytes()


def test_files_load_across_packages(tmp_path):
    """A tokenizer saved by either package loads in the other with the
    same merges; a file of another format is refused by both."""
    data = _corpus(3)
    jbpe.train_bpe(data, 320).save(str(tmp_path / "j.json"))
    tbpe.train_bpe(data, 320).save(str(tmp_path / "t.json"))
    assert (tbpe.BPETokenizer.load(str(tmp_path / "j.json")).merges
            == jbpe.BPETokenizer.load(str(tmp_path / "t.json")).merges)
    (tmp_path / "bad.json").write_text('{"format": "other", "merges": []}')
    for mod in (tbpe, jbpe):
        with pytest.raises(ValueError, match="not a ddp_tpu BPE"):
            mod.BPETokenizer.load(str(tmp_path / "bad.json"))


@pytest.mark.parametrize("text", [b"aaaa", b"aaaaa", b"abababab", b"aaabaaab"])
def test_self_overlap_merges_left_to_right(text):
    """A pair (a, a) in a run merges greedily from the left, as JAX's:
    ``aaaa`` → two ids, ``aaaaa`` → two and a byte."""
    for vocab in (257, 258, 260):
        want = jbpe.train_bpe(text, vocab)
        got = tbpe.train_bpe(text, vocab)
        assert got.merges == want.merges
        np.testing.assert_array_equal(got.encode(text), want.encode(text))
    ids = tbpe._merge_pass(np.frombuffer(b"aaaaa", np.uint8).astype(np.int32),
                           97, 97, 256)
    assert ids.tolist() == [256, 256, 97]


def test_unminted_ids_decode_to_replacement():
    tok = tbpe.train_bpe(_corpus(4), 300)
    assert tok.decode([tok.vocab_size + 5]) == "�"
    assert tok.decode_bytes([tok.vocab_size]) == jbpe.train_bpe(
        _corpus(4), 300).decode_bytes([tok.vocab_size])


def test_load_or_train_reuses_and_refuses(tmp_path):
    """An existing file wins over retraining (even on other bytes); one
    holding more ids than asked is refused; too small a vocabulary to
    merge is refused, as JAX's."""
    path = str(tmp_path / "sub" / "tokenizer.json")
    first = tbpe.load_or_train(path, _corpus(5), 300)
    again = tbpe.load_or_train(path, _corpus(6), 300)
    assert again.merges == first.merges
    with pytest.raises(ValueError, match="--vocab_size"):
        tbpe.load_or_train(path, _corpus(5), 290)
    for mod in (tbpe, jbpe):
        with pytest.raises(ValueError, match="adds no merges"):
            mod.train_bpe(b"abc", 256)


@pytest.mark.parametrize("seq_len", [16, 37])
def test_text_splits_equal_jax_at_vocab_512(tmp_path, seq_len):
    """``load_text_corpus`` at ``vocab_size`` 512: the same (train, test)
    token arrays as JAX's, the vocabulary trained on the leading train
    fraction of the bytes and written to ``tokenizer_path`` with JAX's
    bytes."""
    path = tmp_path / "corpus.txt"
    path.write_bytes(_corpus(7, words=2000))
    tp, jp = str(tmp_path / "t.json"), str(tmp_path / "j.json")
    got = ttext.load_text_corpus(str(path), seq_len, vocab_size=512,
                                 tokenizer_path=tp)
    want = jtext.load_text_corpus(str(path), seq_len, vocab_size=512,
                                  tokenizer_path=jp)
    for g, w in zip(got, want):
        assert g.images.dtype == np.int32
        np.testing.assert_array_equal(g.images, w.images)
        np.testing.assert_array_equal(g.labels, w.labels)
    assert (tmp_path / "t.json").read_bytes() == (tmp_path / "j.json"
                                                  ).read_bytes()


def test_lm_trainer_writes_and_reuses_tokenizer(tmp_path, capsys):
    """``--dataset text --vocab_size 300``: the trainer writes
    ``tokenizer.json`` next to its checkpoints with the bytes JAX's
    loader writes for the same file, and the resumed run reads it back
    unchanged (a retrained vocabulary would remap every id)."""
    corpus = tmp_path / "corpus.txt"
    corpus.write_bytes(_corpus(8, words=1500))
    ckdir = tmp_path / "ck"

    def run(epochs):
        return train_main([
            "--model", "causal_lm", "--device", "cpu", "--dataset", "text",
            "--text_file", str(corpus), "--vocab_size", "300", "--seq_len",
            "32", "--model_dim", "32", "--batch_size", "8", "--epochs",
            str(epochs), "--optimizer", "adam", "--lr", "3e-3",
            "--checkpoint_dir", str(ckdir)])

    first = run(1)
    written = (ckdir / "tokenizer.json").read_bytes()
    jtext.load_text_corpus(str(corpus), 32, vocab_size=300,
                           tokenizer_path=str(tmp_path / "j.json"))
    assert written == (tmp_path / "j.json").read_bytes()
    mtime = (ckdir / "tokenizer.json").stat().st_mtime_ns
    second = run(2)
    assert "Resumed from checkpoint epoch 0" in capsys.readouterr().out
    assert (ckdir / "tokenizer.json").stat().st_mtime_ns == mtime
    np.testing.assert_array_equal(second.train_split.images,
                                  first.train_split.images)
    assert len(second.history) == 1
