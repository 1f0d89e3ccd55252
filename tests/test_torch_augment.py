"""ddp_tpu_torch's augmentation ≡ the JAX package's, on the CPU.

JAX draws offsets and flips from threefry keys, which torch cannot
reproduce, so each augmentation is held in two halves:

- the apply, given JAX's own draws (replayed here from the same key as
  ``ddp_tpu/data/augment.py`` splits it), must equal JAX's result bit
  for bit, in fp32 and bf16: a crop and a flip only move values;
- the port's draw (a counter-based hash of (seed, step, rank,
  microbatch)) must be deterministic in its key, differ across ranks and
  steps, and fit its law: offsets uniform on [0, 2·pad] (each value, and
  each (row, column) pair), flips Bernoulli(1/2), by chi-square at
  p = 0.001 (critical values from scipy).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from ddp_tpu.data import augment as jaug
from ddp_tpu_torch.data import augment as taug

B, H, W, C = 6, 32, 32, 3
DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _images(dname, seed=0):
    x = np.random.default_rng(seed).random((B, H, W, C), dtype=np.float32)
    jdt, tdt = DTYPES[dname]
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt).permute(0, 3, 1, 2)


def _as_numpy(t):
    return t.permute(0, 2, 3, 1).float().numpy()


@pytest.mark.parametrize("dname", list(DTYPES))
@pytest.mark.parametrize("seed", [0, 5])
def test_crop_flip_apply_is_bitwise_jax(dname, seed):
    jx, tx = _images(dname, seed)
    rng = jax.random.key(seed)
    want = jaug.random_crop_flip(rng, jx)
    r_off, r_flip = jax.random.split(rng)
    offsets = jax.random.randint(r_off, (B, 2), 0, 9)
    flips = jax.random.bernoulli(r_flip, 0.5, (B,))
    got = taug.crop(tx, torch.tensor(np.asarray(offsets)).long(), 4,
                    torch.tensor(np.asarray(flips)))
    assert got.dtype == tx.dtype and got.shape == tx.shape
    np.testing.assert_array_equal(_as_numpy(got),
                                  np.asarray(want, np.float32))


@pytest.mark.parametrize("dname", list(DTYPES))
def test_shift_and_flip_apply_are_bitwise_jax(dname):
    jx, tx = _images(dname, 1)
    rng = jax.random.key(3)
    offsets = jax.random.randint(rng, (B, 2), 0, 5)
    got = taug.crop(tx, torch.tensor(np.asarray(offsets)).long(), 2)
    np.testing.assert_array_equal(
        _as_numpy(got), np.asarray(jaug.random_shift(rng, jx), np.float32))
    flips = jax.random.bernoulli(rng, 0.5, (B,))
    got = taug.flip(tx, torch.tensor(np.asarray(flips)))
    np.testing.assert_array_equal(
        _as_numpy(got), np.asarray(jaug.random_flip(rng, jx), np.float32))


def test_names_are_jax_registry_names():
    assert sorted(taug.AUGMENTATIONS) == sorted(jaug.AUGMENTATIONS)
    assert taug.get_augmentation("none") is None
    assert taug.get_augmentation(None) is None
    with pytest.raises(KeyError):
        taug.get_augmentation("cutout")
    _, tx = _images("fp32")
    for name in taug.AUGMENTATIONS:
        out = taug.get_augmentation(name)(taug.step_key(0, 0, 0), tx)
        assert out.shape == tx.shape and out.dtype == tx.dtype


def test_draws_are_deterministic_and_differ_across_ranks_and_steps():
    n, pad = 256, 4

    def draw(seed, step, rank, micro=0):
        key = taug.step_key(seed, step, rank, micro)
        return (taug.draw_offsets(key, n, pad, "cpu"),
                taug.draw_flips(key, n, "cpu"))

    a = draw(0, 3, 0)
    for x, y in zip(a, draw(0, 3, 0)):
        assert torch.equal(x, y)
    for other in (draw(0, 3, 1), draw(0, 4, 0), draw(1, 3, 0),
                  draw(0, 3, 0, micro=1)):
        # Two independent draws agree on about 1/9 of the offsets and 1/2
        # of the flips.
        assert float((other[0] == a[0]).float().mean()) < 0.3
        assert float((other[1] == a[1]).float().mean()) < 0.7
    assert a[0].dtype == torch.int64 and a[1].dtype == torch.bool


@pytest.mark.parametrize("pad", [2, 4])
def test_draws_fit_their_laws(pad):
    """Offsets over 64 steps × 2 ranks × 128 images: each coordinate
    uniform on 2·pad + 1 values, each (row, column) pair uniform on their
    square; flips Bernoulli(1/2). Chi-square at p = 0.001."""
    k = 2 * pad + 1
    offs, flips = [], []
    for step in range(64):
        for rank in range(2):
            key = taug.step_key(7, step, rank)
            offs.append(taug.draw_offsets(key, 128, pad, "cpu"))
            flips.append(taug.draw_flips(key, 128, "cpu"))
    offs = torch.cat(offs).numpy()
    flips = torch.cat(flips).numpy()
    assert offs.min() == 0 and offs.max() == 2 * pad

    def chi2(counts):
        counts = np.asarray(counts, np.float64)
        expect = counts.sum() / counts.size
        stat = float(((counts - expect) ** 2 / expect).sum())
        return stat, float(stats.chi2.ppf(0.999, counts.size - 1))

    for axis in (0, 1):
        stat, crit = chi2(np.bincount(offs[:, axis], minlength=k))
        assert stat < crit, (axis, stat, crit)
    stat, crit = chi2(np.bincount(offs[:, 0] * k + offs[:, 1], minlength=k * k))
    assert stat < crit, ("pairs", stat, crit)
    stat, crit = chi2(np.bincount(flips.astype(np.int64), minlength=2))
    assert stat < crit, ("flips", stat, crit)
    # The control: a draw that never reaches the top offset fails.
    stat, crit = chi2(np.bincount(np.minimum(offs[:, 0], 2 * pad - 1),
                                  minlength=k))
    assert stat > crit
