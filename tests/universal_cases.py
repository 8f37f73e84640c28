"""The universal entropy models of chip_smoke.py's ``universal`` phase,
shared with tests/test_torch_universal.py and tests/test_torch_cuda.py
(chip_smoke.py loads this file by path).  numpy and the port only.

Two models at the size of bmshj2018's y for a batch of 512x512 images
(8 x 32 x 32 x 192, coding_rank 3: one stream per image):
``batched_model`` over a per-channel NoisyNormal (192 channels x 15
dither levels = 2880 table rows), ``indexed_model`` over NoisyNormal on
bmshj2018's 64 scales from 0.11 to 256 (64 x 15 = 960 rows, the widest
~1481 entries).  ``latents`` draws y inside the tables' supports (no
escape: the coder takes K1) or stretched past them (escapes: K6')."""

import numpy as np

LEVELS = 15
CHANNELS = 192
NUM_SCALES, SCALE_MIN, SCALE_MAX = 64, 0.11, 256.0
# Without escapes the standard deviations are clipped to +-CLIP, inside the
# supports (the tails at 2**-8 lie past +-2.6); with escapes they are left
# unclipped and stretched by STRETCH (~2% of the symbols escape).
CLIP, STRETCH = 2.0, 1.25


def channel_params(channels=CHANNELS, seed=0):
    """(loc, scale) float32 [channels] of the batched model's prior."""
    rng = np.random.RandomState(seed)
    loc = rng.uniform(-1.0, 1.0, channels).astype(np.float32)
    scale = np.exp(rng.uniform(np.log(0.2), np.log(8.0), channels)).astype(
        np.float32)
    return loc, scale


def scale_constants():
    """(offset, factor) of bmshj2018's scale table: scale(i) =
    exp(offset + factor * i), Python floats as both packages compute
    them."""
    offset = float(np.log(SCALE_MIN))
    factor = (float(np.log(SCALE_MAX)) - float(np.log(SCALE_MIN))) / (
        NUM_SCALES - 1.0)
    return offset, factor


def batched_model(device, channels=CHANNELS):
    import torch
    from compression_tpu_torch.distributions.uniform_noise import NoisyNormal
    from compression_tpu_torch.entropy_models.universal import (
        UniversalBatchedEntropyModel)
    loc, scale = channel_params(channels)
    return UniversalBatchedEntropyModel(
        NoisyNormal(loc=torch.tensor(loc), scale=torch.tensor(scale)),
        coding_rank=3, compression=True, device=device)


def indexed_model(device):
    import torch
    from compression_tpu_torch.distributions.uniform_noise import NoisyNormal
    from compression_tpu_torch.entropy_models.universal import (
        UniversalIndexedEntropyModel)
    offset, factor = scale_constants()
    return UniversalIndexedEntropyModel(
        NoisyNormal, (NUM_SCALES,),
        {"loc": lambda _: 0.0,
         "scale": lambda i: torch.exp(offset + factor * i[..., 0])},
        coding_rank=3, compression=True, device=device)


def latents(shape, escapes, seed=1, channels=CHANNELS):
    """(y float32 ``shape`` for the batched model, y and scale indexes
    float32 ``shape + (1,)`` for the indexed one), within the supports,
    or stretched past them when ``escapes``."""
    rng = np.random.RandomState(seed)
    z = rng.normal(0, 1, shape)
    z = z * STRETCH if escapes else np.clip(z, -CLIP, CLIP)
    loc, scale = channel_params(channels)
    y_batched = (loc + scale * z).astype(np.float32)
    indexes = rng.uniform(0, NUM_SCALES - 1, shape).astype(np.float32)
    offset, factor = scale_constants()
    y_indexed = (z * np.exp(offset + factor * np.floor(indexes))).astype(
        np.float32)
    return y_batched, y_indexed, indexes[..., None]
