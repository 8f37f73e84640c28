"""Faults planted under a run's timed path, to see ``correct`` come out
false (``calibrate.py`` on the chip, ``tests/test_portbench_faults.py`` on
the CPU):

* ``container``: a byte of each container flipped where compress
  produces it;
* ``image``: a band of each decoded image zeroed where decompress
  produces it;
* ``half_batch``: the batch entries answer only the first half of the
  images they are given;
* ``frozen``: a training step that leaves the weights unchanged;
* ``half_step``: a training step that takes the mean over the first half
  of its batch only.
"""

from __future__ import annotations

import contextlib
from unittest import mock


def _flip(blob):
    blob = bytearray(blob)
    blob[len(blob) // 3] ^= 0x5A
    return bytes(blob)


def _band(image):
    image = image.copy()
    image[: image.shape[0] // 8] = 0
    return image


@contextlib.contextmanager
def planted(name):
    import torch

    from compression_tpu_torch.models import bls2017, bmshj2018

    codec = bmshj2018.BMSHJ2018Codec
    patches = []
    if name == "container":
        for entry in ("compress", "compress_native"):
            original = getattr(codec, entry)
            patches.append(mock.patch.object(
                codec, entry,
                lambda self, x, _f=original: _flip(_f(self, x))))
        many = codec.compress_native_many
        patches.append(mock.patch.object(
            codec, "compress_native_many",
            lambda self, xs: [_flip(c) for c in many(self, xs)]))
    elif name == "image":
        one = codec.decompress
        many = codec.decompress_native_many
        patches.append(mock.patch.object(
            codec, "decompress", lambda self, c: _band(one(self, c))))
        patches.append(mock.patch.object(
            codec, "decompress_native_many",
            lambda self, cs: [_band(x) for x in many(self, cs)]))
    elif name == "half_batch":
        many = codec.decompress_native_many
        patches.append(mock.patch.object(
            codec, "decompress_native_many",
            lambda self, cs: many(self, cs[: max(len(cs) // 2, 1)])))
    elif name == "frozen":
        patches.append(mock.patch.object(torch.optim.Adam, "step",
                                         lambda self, closure=None: None))
    elif name == "half_step":
        backward = bls2017.rd_backward

        def half(model, batch, generator=None, u=None):
            n = max(batch.shape[0] // 2, 1)
            return backward(model, batch[:n], generator=generator,
                            u=None if u is None else tuple(t[:n] for t in u))

        patches.append(mock.patch.object(bls2017, "rd_backward", half))
    else:
        raise ValueError(f"unknown fault {name!r}")
    with contextlib.ExitStack() as stack:
        for p in patches:
            stack.enter_context(p)
        yield
