"""End-to-end RD validation without a dataset (PyTorch counterpart of
examples/train_synthetic.py): train bls2017 on synthetic 1/f-spectrum
textures and measure rate-distortion points through the real compress /
decompress path.

The source is a reproducible stand-in for the reference's "train on your
own images" flow (reference models/bls2017.py train_glob): Gaussian random
fields with a power-law amplitude spectrum (|F| ~ 1/f^alpha), the classic
natural-image statistics model.  The script

  1. trains BLS2017 at one or more lambda values (``bls2017.train``, Adam
     on the card),
  2. builds the range-coding tables (``BLS2017Codec``),
  3. compresses + decompresses held-out samples of the same source,
  4. prints bpp / PSNR per lambda, then checks that rate and PSNR both
     rise from the first lambda to the last (exit code 1 if not).

Runs on the card unless ``--device cpu`` is given.

Usage:
  python -m compression_tpu_torch.examples.train_synthetic \\
      [--steps 400] [--lmbdas 0.003,0.03] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def make_texture_source(patchsize, alpha=1.2, seed=0):
    """Yields batches of 1/f^alpha Gaussian random-field RGB patches."""
    rng = np.random.RandomState(seed)
    fy = np.fft.fftfreq(patchsize)[:, None]
    fx = np.fft.fftfreq(patchsize)[None, :]
    f = np.sqrt(fy * fy + fx * fx)
    f[0, 0] = 1.0
    amp = 1.0 / f**alpha

    def sample(n):
        phases = rng.uniform(0, 2 * np.pi, (n, 3, patchsize, patchsize))
        spec = amp[None, None] * np.exp(1j * phases)
        img = np.fft.ifft2(spec, axes=(-2, -1)).real
        img = img - img.min(axis=(-2, -1), keepdims=True)
        img = img / (img.max(axis=(-2, -1), keepdims=True) + 1e-9)
        return np.transpose(img * 255.0, (0, 2, 3, 1)).astype(np.float32)

    return sample


def batch_iter(sample, batch_size):
    while True:
        yield sample(batch_size)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=400)
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--patchsize", type=int, default=128)
    parser.add_argument("--num_filters", type=int, default=64)
    parser.add_argument("--lmbdas", default="0.003,0.03")
    parser.add_argument("--eval_images", type=int, default=4)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    from compression_tpu_torch.models import bls2017
    from compression_tpu_torch.util import metrics
    from compression_tpu_torch.util.device import resolve_device

    device = resolve_device(args.device)
    sample = make_texture_source(args.patchsize, seed=args.seed)
    eval_imgs = make_texture_source(
        args.patchsize, seed=args.seed + 1)(args.eval_images)
    eval_u8 = np.clip(np.round(eval_imgs), 0, 255).astype(np.uint8)

    results = []
    for lmbda in [float(s) for s in args.lmbdas.split(",")]:
        print(f"=== lambda {lmbda}: training {args.steps} steps ===",
              flush=True)
        model = bls2017.train(
            lmbda=lmbda, num_filters=args.num_filters,
            batch_size=args.batch_size, patchsize=args.patchsize,
            steps=args.steps, data_iter=batch_iter(sample, args.batch_size),
            seed=args.seed, log_every=max(args.steps // 4, 1),
            device=device)
        codec = bls2017.BLS2017Codec(model, device=device)

        bpps, psnrs = [], []
        for img in eval_u8:
            container = codec.compress(img)
            rec = codec.decompress(container)
            bpps.append(len(container) * 8 / (img.shape[0] * img.shape[1]))
            psnrs.append(float(metrics.psnr(
                img.astype(np.float32), rec.astype(np.float32),
                device=device)))
        bpp, p = float(np.mean(bpps)), float(np.mean(psnrs))
        results.append((lmbda, bpp, p))
        print(f"lambda {lmbda}: {bpp:.4f} bpp  {p:.2f} dB "
              f"({args.eval_images} held-out textures)", flush=True)

    print("\nRD summary (bpp should rise and PSNR rise with lambda):")
    for lmbda, bpp, p in results:
        print(f"  lambda {lmbda:<8g} {bpp:7.4f} bpp  {p:6.2f} dB")
    if len(results) >= 2:
        lo, hi = results[0], results[-1]
        ok = hi[1] > lo[1] and hi[2] > lo[2]
        print(f"monotone RD tradeoff: {'OK' if ok else 'VIOLATED'}")
        if not ok:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
