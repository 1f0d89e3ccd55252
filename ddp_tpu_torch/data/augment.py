"""On-device train-time augmentation (``ddp_tpu/data/augment.py``).

Runs inside the train step on the device, after the uint8 → float
scaling (``parallel/common._preprocess``), on NCHW batches: the host
pipeline stays a uint8 gather and nothing new crosses the bus.

Each JAX function draws from a threefry key and applies in one; torch
cannot give threefry's bits, so each is split here into a *draw* and an
*apply*:

- the apply (:func:`crop`, :func:`flip`) takes the offsets and flips and
  is a pure gather, bitwise JAX's ``dynamic_slice`` crop of the
  zero-padded batch and ``[:, :, ::-1]`` flip given the same offsets;
- the draw (:func:`draw_offsets`, :func:`draw_flips`) hashes (key, image
  index) with the counter-based generator of ``utils/counter_rng``, in
  integer ops on the device, from a key folded from (seed, step, rank,
  microbatch) by :func:`step_key`: deterministic across a resume,
  different across ranks and steps.

``get_augmentation(name)`` → ``fn(key, images) -> images`` or None.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ddp_tpu_torch.utils.counter_rng import fold, mix32

# The JAX step draws its augmentation from fold_in(rng, 7919).
AUGMENT_STREAM = 7919
_OFFSETS, _FLIPS = 1, 2  # sub-streams of one augmentation key


def step_key(seed: int, step: int, rank: int, micro: int = 0) -> int:
    """The augmentation key of one microbatch of one rank's step."""
    return fold(seed, step, rank, micro, AUGMENT_STREAM)


def _bits(key: int, n: int, device, start: int = 0) -> torch.Tensor:
    """Uniform uint32 values (in int64) ``start``..``start + n`` of
    ``key``'s stream."""
    ctr = mix32(torch.arange(start, start + n, device=device,
                             dtype=torch.int64))
    return mix32(mix32(ctr ^ key) ^ key)


def draw_offsets(key: int, n: int, pad: int, device,
                 start: int = 0) -> torch.Tensor:
    """[n, 2] int64 crop offsets (row, column), each uniform on
    [0, 2·pad] (``jax.random.randint(rng, (B, 2), 0, 2 * pad + 1)``), of
    images ``start``.. of the batch the key draws for."""
    h = _bits(fold(key, _OFFSETS), 2 * n, device, 2 * start)
    return ((h * (2 * pad + 1)) >> 32).view(n, 2)


def draw_flips(key: int, n: int, device, start: int = 0) -> torch.Tensor:
    """[n] bool, each True with probability 1/2
    (``jax.random.bernoulli(rng, 0.5, (B,))``), of images ``start``.."""
    return (_bits(fold(key, _FLIPS), n, device, start) >> 31) == 1


def crop(images: torch.Tensor, offsets: torch.Tensor, pad: int,
         flips: torch.Tensor | None = None) -> torch.Tensor:
    """Zero-pad [B, C, H, W] by ``pad``, crop each image back to H × W at
    its ``offsets`` [B, 2], and mirror the crop of each image whose
    ``flips`` [B] is True: one gather."""
    B, C, H, W = images.shape
    dev = images.device
    padded = F.pad(images, (pad, pad, pad, pad))
    rows = offsets[:, :1] + torch.arange(H, device=dev)  # [B, H]
    cols = offsets[:, 1:] + torch.arange(W, device=dev)  # [B, W]
    if flips is not None:
        cols = torch.where(flips[:, None], cols.flip(-1), cols)
    b = torch.arange(B, device=dev)[:, None, None, None]
    c = torch.arange(C, device=dev)[None, :, None, None]
    return padded[b, c, rows[:, None, :, None], cols[:, None, None, :]]


def flip(images: torch.Tensor, flips: torch.Tensor) -> torch.Tensor:
    """Mirror each image of [B, C, H, W] whose ``flips`` [B] is True."""
    return torch.where(flips[:, None, None, None], images.flip(-1), images)


def random_shift(key: int, images: torch.Tensor, *, pad: int = 2,
                 start: int = 0):
    """Random translation by up to ``pad`` pixels (zero fill), no flip.
    ``start``: the place of ``images`` in the batch the key draws for
    (a GSPMD rank's rows of the global batch)."""
    return crop(images, draw_offsets(key, images.shape[0], pad, images.device,
                                     start), pad)


def random_crop_flip(key: int, images: torch.Tensor, *, pad: int = 4,
                     start: int = 0):
    """Zero-pad by ``pad``, random-crop back, random horizontal flip
    (torchvision's ``RandomCrop(padding=4)`` + ``RandomHorizontalFlip``)."""
    n, dev = images.shape[0], images.device
    return crop(images, draw_offsets(key, n, pad, dev, start), pad,
                draw_flips(key, n, dev, start))


def random_flip(key: int, images: torch.Tensor, *, start: int = 0):
    """Horizontal flip only."""
    return flip(images, draw_flips(key, images.shape[0], images.device,
                                   start))


AUGMENTATIONS = {
    "crop_flip": random_crop_flip,
    "flip": random_flip,
    "shift": random_shift,
}


def get_augmentation(name: str | None):
    """name → fn(key, images) or None. Raises on unknown names."""
    if name is None or name == "none":
        return None
    if name not in AUGMENTATIONS:
        raise KeyError(
            f"unknown augmentation {name!r}; have {sorted(AUGMENTATIONS)}"
        )
    return AUGMENTATIONS[name]
