"""Images from a seed: 1/f^alpha Gaussian random fields, one per colour
channel, stretched to 0..255 (the synthetic source of the repository's
train_synthetic example, made on the device for H x W images)."""

from __future__ import annotations

import math

import torch


def pool(count, height, width, seed, device, alpha=1.2, chunk=8):
    """uint8 [count, height, width, 3] on ``device``; the same seed gives
    the same images on the same device."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    fy = torch.fft.fftfreq(height, device=device)[:, None]
    fx = torch.fft.fftfreq(width, device=device)[None, :]
    f = torch.sqrt(fy * fy + fx * fx)
    f[0, 0] = 1.0
    amp = 1.0 / f**alpha
    out = []
    for start in range(0, count, chunk):
        n = min(chunk, count - start)
        phases = torch.rand((n, 3, height, width), generator=gen,
                            device=device) * (2 * math.pi)
        img = torch.fft.ifft2(torch.polar(amp.expand_as(phases), phases)).real
        img = img - img.amin(dim=(-2, -1), keepdim=True)
        img = img / (img.amax(dim=(-2, -1), keepdim=True) + 1e-9)
        img = torch.clamp(torch.round(img * 255.0), 0, 255).to(torch.uint8)
        out.append(img.permute(0, 2, 3, 1))
    return torch.cat(out).contiguous()
