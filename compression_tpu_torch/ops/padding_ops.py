"""Padding helpers for DSP-correct "same" convolutions (a copy of
compression_tpu/ops/padding_ops.py; counterpart of the reference's
python/ops/padding_ops.py:22-51).
"""

from __future__ import annotations

__all__ = ["same_padding_for_kernel"]


def same_padding_for_kernel(shape, corr, strides_up=None):
    """Pre-padding amounts for a centered 'same' convolution/correlation.

    Args:
      shape: spatial kernel shape (no channel dims).
      corr: True for cross-correlation, False for convolution.
      strides_up: upsampling strides (use (1,)*rank for downsampling).

    Returns:
      List of (pad_begin, pad_end) per spatial dimension.
    """
    rank = len(shape)
    if strides_up is None:
        strides_up = rank * (1,)
    if corr:
        padding = [(s // 2, (s - 1) // 2) for s in shape]
    else:
        padding = [((s - 1) // 2, s // 2) for s in shape]
    return [
        ((padding[i][0] - 1) // strides_up[i] + 1,
         (padding[i][1] - 1) // strides_up[i] + 1)
        for i in range(rank)
    ]
