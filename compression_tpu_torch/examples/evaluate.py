"""RD evaluation: bpp / PSNR / MS-SSIM of a trained codec over an image set
(PyTorch counterpart of examples/evaluate.py).

The analog of the reference's published results pipeline
(results/image_compression/*): evaluates a registered model (a checkpoint
directory of the ``tfci`` registry, as a model's ``train`` subcommand
writes it) over a directory (e.g. Kodak) through its classic .tfci
container, and prints per-image and aggregate numbers that can be compared
against BASELINE.md's RD anchors.  MS-SSIM is NaN for an image too small
for its five scales.  Runs on the card unless ``--device cpu`` is given.

Usage:
  python -m compression_tpu_torch.examples.evaluate --model_path registry \\
      --model bls2017 --images /path/to/kodak [--out results.csv] \\
      [--device cpu]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from compression_tpu_torch.models import tfci as tfci_lib
from compression_tpu_torch.util import datasets, metrics
from compression_tpu_torch.util.device import resolve_device


def main(argv=None):
    """Returns the rows (image name, bpp, PSNR, MS-SSIM)."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--model_path", default="registry")
    parser.add_argument("--model", required=True)
    parser.add_argument("--images", required=True)
    parser.add_argument("--out", default=None)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    codec = tfci_lib._load_codec(args.model_path, args.model, device)
    exts = (".png", ".jpg", ".jpeg", ".npy")
    paths = sorted(
        os.path.join(args.images, f) for f in os.listdir(args.images)
        if f.lower().endswith(exts))
    if not paths:
        raise SystemExit(f"no images in {args.images}")

    rows = []
    for path in paths:
        img = datasets.load_image(path)
        container = codec.compress(img)
        rec = codec.decompress(container)
        bpp = len(container) * 8 / (img.shape[0] * img.shape[1])
        a, b = img.astype(np.float32), rec.astype(np.float32)
        p = float(metrics.psnr(a, b, device=device))
        try:
            ms = float(metrics.msssim(a[None], b[None], device=device))
        except metrics.ImageTooSmallError:
            ms = float("nan")
        rows.append((os.path.basename(path), bpp, p, ms))
        print(f"{rows[-1][0]}: {bpp:.4f} bpp  {p:.2f} dB  "
              f"MS-SSIM {ms:.4f}", flush=True)

    bpps = np.asarray([r[1] for r in rows])
    psnrs = np.asarray([r[2] for r in rows])
    mss = np.asarray([r[3] for r in rows])
    print(f"\naggregate ({len(rows)} images): "
          f"{bpps.mean():.4f} bpp  {psnrs.mean():.2f} dB  "
          f"MS-SSIM {np.nanmean(mss):.4f}")

    if args.out:
        with open(args.out, "w") as f:
            f.write("image,bpp,psnr,msssim\n")
            for name, bpp, p, ms in rows:
                f.write(f"{name},{bpp:.6f},{p:.4f},{ms:.6f}\n")
        print(f"wrote {args.out}")
    return rows


if __name__ == "__main__":
    main()
