"""Training data pipelines (image patch loading without TF): a copy of
compression_tpu/util/datasets.py, numpy only.

The reference models train from TFDS (clic/kodak); here training data
comes from a local directory or glob of images (PNG/JPEG through PIL,
imported only for them, .npy always) or synthetic noise for smoke runs.
Nothing is downloaded.
"""

from __future__ import annotations

import os
from typing import Iterator, Optional

import numpy as np

__all__ = ["image_patch_iterator", "load_image", "save_image"]


def load_image(path: str) -> np.ndarray:
    """Loads an image file as uint8 [H, W, 3]."""
    if path.endswith(".npy"):
        arr = np.load(path)
    else:
        try:
            from PIL import Image
        except ImportError as e:
            raise ImportError(
                "PIL is required for non-.npy images") from e
        arr = np.asarray(Image.open(path).convert("RGB"))
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, axis=-1)
    return arr.astype(np.uint8)


def save_image(path: str, arr: np.ndarray):
    """Saves a uint8 [H, W, 3] image."""
    if path.endswith(".npy"):
        np.save(path, arr)
        return
    from PIL import Image
    Image.fromarray(arr).save(path)


def image_patch_iterator(
        directory: Optional[str], batch_size: int, patchsize: int,
        seed: int = 0) -> Iterator[np.ndarray]:
    """Yields float32 [B, P, P, 3] batches of random crops.

    With directory=None, yields random noise (smoke training).
    """
    rng = np.random.RandomState(seed)
    if directory is None:
        while True:
            yield rng.randint(
                0, 256, (batch_size, patchsize, patchsize, 3)).astype(
                    np.float32)

    exts = (".png", ".jpg", ".jpeg", ".npy")
    if os.path.isdir(directory):
        paths = sorted(
            os.path.join(directory, f) for f in os.listdir(directory)
            if f.lower().endswith(exts))
    else:
        # Glob pattern (the reference's --train_glob semantics,
        # e.g. 'images/*.png').
        import glob as _glob

        paths = sorted(
            p for p in _glob.glob(directory) if p.lower().endswith(exts))
    if not paths:
        raise ValueError(f"No images found in {directory}")
    images = []
    for p in paths:
        img = load_image(p)
        if img.shape[0] >= patchsize and img.shape[1] >= patchsize:
            images.append(img)
    if not images:
        raise ValueError(
            f"No images in {directory} are at least {patchsize} px")
    while True:
        batch = np.zeros((batch_size, patchsize, patchsize, 3), np.float32)
        for b in range(batch_size):
            img = images[rng.randint(len(images))]
            i = rng.randint(img.shape[0] - patchsize + 1)
            j = rng.randint(img.shape[1] - patchsize + 1)
            batch[b] = img[i : i + patchsize, j : j + patchsize]
        yield batch
