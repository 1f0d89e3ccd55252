"""Convert an ImageFolder tree into the trainer's memory-mapped arrays
(``scripts/preprocess_imagenet.py``'s CLI, the same output bytes).

One-time preprocessing for ``--dataset imagenet`` (data/imagenet.py):
decoding is a preprocessing concern, not a training-loop one; the layout
the loader wants is contiguous uint8 NHWC arrays, memory-mapped so its
gather touches pages on demand.

Input layout (torchvision's ImageFolder convention):

    root/
      train/<wnid_or_class_name>/*.{jpg,jpeg,png,...}
      val/<wnid_or_class_name>/*.{jpg,jpeg,png,...}   (or test/, not both)

Output (into --out, read by data/imagenet.py):

    imagenet_train_images.npy   [N, S, S, 3] uint8
    imagenet_train_labels.npy   [N] int32
    imagenet_test_images.npy / imagenet_test_labels.npy
    imagenet_classes.json       class name → label index

Label indices come from ONE global mapping (sorted train class
directories, ImageFolder's order); a val/test class absent from it is an
error, never a silent re-indexing. Each image's short side is resized to
``--resize``, then the centre ``--size`` square is cropped (the standard
eval transform; the training-time crop and flip run on the device,
data/augment.py). PPM/PGM files decode with numpy alone (data/ppm.py);
other formats need PIL. Decoding fans out over ``--workers`` processes,
each writing its rows into the shared memmap; outputs are written under
temporary names and renamed only on success, so a crash never leaves a
half-written array for the loader.

Usage:
    python -m ddp_tpu_torch.data.preprocess_imagenet --src /data/imagenet \
        --out ./data
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import sys

import numpy as np

from ddp_tpu_torch.data.ppm import decode_resized

_EXTS = {".jpg", ".jpeg", ".png", ".bmp", ".webp", ".ppm", ".pgm"}


def class_dirs(split_dir: str) -> list[str]:
    return sorted(
        d
        for d in os.listdir(split_dir)
        if os.path.isdir(os.path.join(split_dir, d))
    )


def list_split(
    split_dir: str, class_to_idx: dict[str, int]
) -> list[tuple[str, int]]:
    classes = class_dirs(split_dir)
    unknown = sorted(set(classes) - set(class_to_idx))
    if unknown:
        raise SystemExit(
            f"{split_dir}: classes {unknown[:5]}{'…' if len(unknown) > 5 else ''} "
            f"not present in the train split — labels would be garbage"
        )
    samples = []
    for cls in classes:
        cls_dir = os.path.join(split_dir, cls)
        for fname in sorted(os.listdir(cls_dir)):
            if os.path.splitext(fname)[1].lower() in _EXTS:
                samples.append((os.path.join(cls_dir, fname), class_to_idx[cls]))
    return samples


def decode(path: str, resize: int, size: int) -> np.ndarray:
    # PPM/PGM decode needs nothing beyond numpy (data/ppm.py, with the
    # native reader when its library is built); PIL takes the
    # compressed formats.
    if path.lower().endswith((".ppm", ".pgm")):
        return decode_resized(path, resize, size)
    from PIL import Image

    with Image.open(path) as im:
        im = im.convert("RGB")
        w, h = im.size
        scale = resize / min(w, h)
        im = im.resize(
            (max(size, round(w * scale)), max(size, round(h * scale))),
            Image.BILINEAR,
        )
        w, h = im.size
        left, top = (w - size) // 2, (h - size) // 2
        im = im.crop((left, top, left + size, top + size))
        return np.asarray(im, np.uint8)


_POOL_STATE: tuple = ()


def _pool_init(img_path: str, resize: int, size: int) -> None:
    global _POOL_STATE
    _POOL_STATE = (
        np.lib.format.open_memmap(img_path, mode="r+"),
        resize,
        size,
    )


def _pool_decode(job: tuple[int, str]) -> int:
    i, path = job
    mm, resize, size = _POOL_STATE
    mm[i] = decode(path, resize, size)
    return i


def convert_split(
    samples: list[tuple[str, int]],
    out_root: str,
    out_split: str,
    *,
    resize: int,
    size: int,
    workers: int,
) -> None:
    img_path = os.path.join(out_root, f"imagenet_{out_split}_images.npy")
    lbl_path = os.path.join(out_root, f"imagenet_{out_split}_labels.npy")
    tmp_img, tmp_lbl = img_path + ".part", lbl_path + ".part.npy"
    try:
        # open_memmap streams to disk: peak memory is one image, not N.
        mm = np.lib.format.open_memmap(
            tmp_img, mode="w+", dtype=np.uint8,
            shape=(len(samples), size, size, 3),
        )
        del mm  # flush the header so workers can open r+
        jobs = [(i, path) for i, (path, _) in enumerate(samples)]
        if workers > 1:
            with multiprocessing.get_context("spawn").Pool(
                workers, initializer=_pool_init,
                initargs=(tmp_img, resize, size),
            ) as pool:
                for n, _ in enumerate(
                    pool.imap_unordered(_pool_decode, jobs, chunksize=64)
                ):
                    if n and n % 10_000 == 0:
                        print(f"  {out_split}: {n}/{len(jobs)}", file=sys.stderr)
        else:
            _pool_init(tmp_img, resize, size)
            for n, job in enumerate(jobs):
                _pool_decode(job)
                if n and n % 10_000 == 0:
                    print(f"  {out_split}: {n}/{len(jobs)}", file=sys.stderr)
        np.save(tmp_lbl.removesuffix(".npy"), np.asarray(
            [label for _, label in samples], np.int32
        ))
        # Atomic publish: the loader can never see a half-decoded array.
        os.replace(tmp_img, img_path)
        os.replace(tmp_lbl, lbl_path)
    except BaseException:
        for t in (tmp_img, tmp_lbl):
            if os.path.exists(t):
                os.unlink(t)
        raise


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--src", required=True, help="ImageFolder root")
    p.add_argument("--out", required=True, help="trainer --data_root")
    p.add_argument("--size", type=int, default=224, help="crop side")
    p.add_argument("--resize", type=int, default=256, help="short side")
    p.add_argument(
        "--workers", type=int, default=os.cpu_count() or 1,
        help="decode processes",
    )
    args = p.parse_args(argv)

    train_dir = os.path.join(args.src, "train")
    if not os.path.isdir(train_dir):
        raise SystemExit(f"no train/ split under {args.src}")
    val_dir = os.path.join(args.src, "val")
    test_dir = os.path.join(args.src, "test")
    if os.path.isdir(val_dir) and os.path.isdir(test_dir):
        raise SystemExit(
            f"{args.src} has BOTH val/ and test/ — they would map to the "
            f"same imagenet_test_* output; keep (or point --src at) one"
        )
    eval_dir = val_dir if os.path.isdir(val_dir) else (
        test_dir if os.path.isdir(test_dir) else None
    )

    class_to_idx = {c: i for i, c in enumerate(class_dirs(train_dir))}
    if not class_to_idx:
        raise SystemExit(f"no class directories under {train_dir}")
    os.makedirs(args.out, exist_ok=True)

    for split_dir, out_split in (
        (train_dir, "train"),
        *(((eval_dir, "test"),) if eval_dir else ()),
    ):
        samples = list_split(split_dir, class_to_idx)
        if not samples:
            raise SystemExit(f"no images found under {split_dir}")
        convert_split(
            samples, args.out, out_split,
            resize=args.resize, size=args.size, workers=args.workers,
        )
        print(f"{os.path.basename(split_dir)} → imagenet_{out_split}_*: "
              f"{len(samples)} images")

    with open(os.path.join(args.out, "imagenet_classes.json"), "w") as f:
        json.dump(class_to_idx, f, indent=0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
