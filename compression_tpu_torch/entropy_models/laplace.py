"""Laplace entropy model (PyTorch counterpart of
compression_tpu/entropy_models/laplace.py): an L1 penalty and a run-length
code with Rice- or gamma-coded parts.

The penalty ``l1 * sum(|x|)`` encourages a symmetric Laplace distribution,
which the run-length code with Rice-coded magnitudes compresses well.
``__call__``, ``penalty`` and ``quantize`` run on the tensor's device;
``compress`` is host code and refuses a CUDA tensor; ``decompress`` returns
the tensor on ``device``.
"""

from __future__ import annotations

import torch

from compression_tpu_torch.ops import round_ops
from compression_tpu_torch.ops import run_length
from compression_tpu_torch.util.device import code_units, decoded_tensor

__all__ = ["LaplaceEntropyModel"]


class LaplaceEntropyModel:
    """Entropy model for Laplace distributed random variables."""

    def __init__(self, coding_rank, l1=0.01, run_length_code=-1,
                 magnitude_code=0, use_run_length_for_non_zeros=False,
                 bottleneck_dtype=torch.float32):
        self._coding_rank = int(coding_rank)
        if self.coding_rank < 0:
            raise ValueError("`coding_rank` must be at least 0.")
        self._l1 = float(l1)
        if self._l1 <= 0:
            raise ValueError("`l1` must be greater than 0.")
        self._run_length_code = int(run_length_code)
        self._magnitude_code = int(magnitude_code)
        self._use_run_length_for_non_zeros = bool(use_run_length_for_non_zeros)
        self._bottleneck_dtype = bottleneck_dtype

    @property
    def l1(self):
        return self._l1

    @property
    def run_length_code(self):
        return self._run_length_code

    @property
    def magnitude_code(self):
        return self._magnitude_code

    @property
    def use_run_length_for_non_zeros(self):
        return self._use_run_length_for_non_zeros

    @property
    def bottleneck_dtype(self):
        return self._bottleneck_dtype

    @property
    def coding_rank(self):
        return self._coding_rank

    def _cast(self, bottleneck):
        return torch.as_tensor(bottleneck).to(self.bottleneck_dtype)

    def _codes(self):
        return (self.run_length_code, self.magnitude_code,
                self.use_run_length_for_non_zeros)

    def __call__(self, bottleneck):
        bottleneck = self._cast(bottleneck)
        return self.quantize(bottleneck), self.penalty(bottleneck)

    def penalty(self, bottleneck):
        magnitude = torch.abs(self._cast(bottleneck))
        if self.coding_rank:
            magnitude = torch.sum(
                magnitude, dim=tuple(range(-self.coding_rank, 0)))
        return self.l1 * magnitude

    def quantize(self, bottleneck):
        return round_ops.round_st(self._cast(bottleneck))

    def compress(self, bottleneck) -> list[bytes]:
        """One run-length string a coding unit (host code)."""
        return [run_length.run_length_encode(row, *self._codes())
                for row in code_units(bottleneck, self.coding_rank,
                                      "LaplaceEntropyModel.compress")]

    def decompress(self, strings, code_shape, device="cuda"):
        """Inverse of compress: [len(strings), *code_shape] on ``device``."""
        code_shape = tuple(int(s) for s in code_shape)
        return decoded_tensor(
            [run_length.run_length_decode(s, code_shape, *self._codes())
             for s in strings], self.bottleneck_dtype, device)
