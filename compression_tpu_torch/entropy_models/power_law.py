"""Power-law entropy model (PyTorch counterpart of
compression_tpu/entropy_models/power_law.py): table-free, run-length gamma
coded.

The training penalty is ``log((|x| + alpha) / alpha)`` (the code length of
an Elias gamma code up to a constant), and compression applies the
run-length gamma code to each coding unit.  ``__call__``, ``penalty`` and
``quantize`` run on the tensor's device.  ``compress`` is host code (numpy
arrays or CPU tensors in, one string a unit out) and refuses a CUDA tensor;
``decompress`` returns the tensor on ``device``.
"""

from __future__ import annotations

import torch

from compression_tpu_torch.ops import round_ops
from compression_tpu_torch.ops import run_length
from compression_tpu_torch.util.device import code_units, decoded_tensor

__all__ = ["PowerLawEntropyModel"]


class PowerLawEntropyModel:
    """Entropy model for power-law distributed random variables."""

    def __init__(self, coding_rank, alpha=1e-2,
                 bottleneck_dtype=torch.float32):
        self._coding_rank = int(coding_rank)
        if self.coding_rank < 0:
            raise ValueError("`coding_rank` must be at least 0.")
        self._alpha = float(alpha)
        if self._alpha <= 0:
            raise ValueError("`alpha` must be greater than 0.")
        self._bottleneck_dtype = bottleneck_dtype

    @property
    def alpha(self):
        return self._alpha

    @property
    def bottleneck_dtype(self):
        return self._bottleneck_dtype

    @property
    def coding_rank(self):
        return self._coding_rank

    def _cast(self, bottleneck):
        return torch.as_tensor(bottleneck).to(self.bottleneck_dtype)

    def __call__(self, bottleneck):
        bottleneck = self._cast(bottleneck)
        return self.quantize(bottleneck), self.penalty(bottleneck)

    def penalty(self, bottleneck):
        bottleneck = self._cast(bottleneck)
        # A 0-d tensor on the device: a true division on the card too.
        alpha = torch.tensor(self.alpha, dtype=bottleneck.dtype,
                             device=bottleneck.device)
        penalty = torch.log((torch.abs(bottleneck) + alpha) / alpha)
        if not self.coding_rank:
            return penalty
        return torch.sum(penalty, dim=tuple(range(-self.coding_rank, 0)))

    def quantize(self, bottleneck):
        return round_ops.round_st(self._cast(bottleneck))

    def compress(self, bottleneck) -> list[bytes]:
        """One run-length-gamma string a coding unit (host code)."""
        return [run_length.run_length_gamma_encode(row) for row in code_units(
            bottleneck, self.coding_rank, "PowerLawEntropyModel.compress")]

    def decompress(self, strings, code_shape, device="cuda"):
        """Inverse of compress: [len(strings), *code_shape] on ``device``."""
        code_shape = tuple(int(s) for s in code_shape)
        return decoded_tensor(
            [run_length.run_length_gamma_decode(s, code_shape)
             for s in strings], self.bottleneck_dtype, device)
