"""Base class for continuous entropy models (PyTorch counterpart of
compression_tpu/entropy_models/continuous_base.py).

Key invariant carried over from the reference (continuous_base.py:176-184):
CDF tables are built ONCE and shared -- never re-derived on the decoder
side -- because float nondeterminism between sender and receiver would make
the range decode diverge.  Table construction samples the prior's PMF on the
CPU (as the reference pins it there) and quantizes rows to integer CDFs with
the native quantizer; the result is the same table whatever device the
model codes on.
"""

from __future__ import annotations

import math
import warnings

import numpy as np
import torch

from compression_tpu_torch.codec import cuda_coder
from compression_tpu_torch.codec import tables
from compression_tpu_torch.codec import torch_coder
from compression_tpu_torch.distributions import helpers
from compression_tpu_torch.distributions import uniform_noise
from compression_tpu_torch.util.device import resolve_device

__all__ = ["ContinuousEntropyModelBase", "compress_budgeted"]


class ContinuousEntropyModelBase:
    """Shared machinery: table build, serialization, device table."""

    def __init__(self, coding_rank=None, compression=False,
                 expected_grads=False, tail_mass=2**-8,
                 laplace_tail_mass=0.0, device="cuda"):
        self._prior = None
        self._coding_rank = int(coding_rank)
        self._compression = bool(compression)
        self._expected_grads = bool(expected_grads)
        self._tail_mass = float(tail_mass)
        self._laplace_tail_mass = float(laplace_tail_mass)
        self.device = resolve_device(device)
        self.bottleneck_dtype = torch.float32
        self._cdf = None
        self._cdf_offset = None
        self._device_table = None
        self._row_offset = None
        if self.coding_rank < 0:
            raise ValueError("`coding_rank` must be at least 0.")
        if not 0 < self.tail_mass < 1:
            raise ValueError("`tail_mass` must be between 0 and 1.")

    def _check_compression(self):
        if not self.compression:
            raise RuntimeError(
                "For range coding, the entropy model must be instantiated "
                "with `compression=True`.")

    @property
    def prior(self):
        if self._prior is None:
            raise RuntimeError(
                "This entropy model doesn't hold a reference to its prior "
                "distribution.")
        return self._prior

    @property
    def cdf(self):
        """Ragged CDF table (reference wire format), numpy int32."""
        self._check_compression()
        return self._cdf

    @property
    def cdf_offset(self):
        self._check_compression()
        return self._cdf_offset

    @property
    def expected_grads(self):
        """Training noise with the analytically expected gradient
        (``ops.math_ops.perturb_and_apply``)."""
        return self._expected_grads

    @property
    def coding_rank(self):
        return self._coding_rank

    @property
    def compression(self):
        return self._compression

    @property
    def tail_mass(self):
        return self._tail_mass

    @property
    def laplace_tail_mass(self):
        """Weight of the unit NoisyLaplace mixed into the likelihood
        (``_log_prob``); 0 leaves the prior's log_prob as it is."""
        return self._laplace_tail_mass

    @property
    def device_table(self) -> torch_coder.DeviceCdfTable:
        """Dense CDF table on the model's device (built once, cached)."""
        self._check_compression()
        if self._device_table is None:
            self._device_table = torch_coder.DeviceCdfTable(
                tables.parse_ragged_cdf(self._cdf), self.device)
        return self._device_table

    def _init_compression(self, cdf, cdf_offset):
        if (cdf is None) != (cdf_offset is None):
            raise ValueError("Provide both `cdf` and `cdf_offset`.")
        self._cdf = np.asarray(cdf, np.int32)
        self._cdf_offset = np.asarray(cdf_offset, np.int32)
        self._device_table = None
        self._row_offset = None

    def _row_offsets(self):
        """cdf_offset as an int32 tensor on the model's device (cached)."""
        if self._row_offset is None:
            self._row_offset = torch.as_tensor(self.cdf_offset,
                                               device=self.device)
        return self._row_offset

    def _build_tables(self, prior, precision, offset=None):
        """Computes the ragged CDF table + offsets from the prior.

        Mirrors reference continuous_base.py:217-296: tails -> integer
        supports -> PMF sampling on a [max_length, batch] grid -> per-row
        overflow mass -> greedy integer CDF quantization -> ragged concat
        with a leading ``-precision`` marker per row (negative = overflow
        coding enabled).  ``prior`` and ``offset`` must live on the CPU.
        """
        precision = int(precision)
        if offset is None:
            offset = torch.zeros((), dtype=self.bottleneck_dtype)
        with torch.no_grad():
            lower = helpers.lower_tail(prior, self.tail_mass)
            upper = helpers.upper_tail(prior, self.tail_mass)
            minima = torch.floor(lower - offset).to(torch.int32)
            maxima = torch.ceil(upper - offset).to(torch.int32)
            pmf_start = minima.to(self.bottleneck_dtype) + offset
            pmf_length = maxima - minima + 1
            max_length = int(pmf_length.max())
            if max_length > 2048:
                warnings.warn(
                    f"Very wide PMF with {max_length} elements may lead to "
                    "out of memory issues. Consider priors with smaller "
                    "variance, or increasing `tail_mass`.")
            samples = torch.arange(max_length, dtype=self.bottleneck_dtype)
            samples = samples.reshape((-1,) + (1,) * pmf_length.ndim)
            pmf = prior.prob(samples + pmf_start)
        pmf_shape = tuple(pmf.shape[1:])
        num_pmfs = int(np.prod(pmf_shape)) if pmf_shape else 1

        pmf = np.asarray(pmf.reshape(max_length, num_pmfs).T.numpy(),
                         np.float64)
        pmf_length = np.broadcast_to(
            pmf_length.numpy(), pmf_shape).reshape(num_pmfs)
        cdf_offset = np.broadcast_to(
            minima.numpy(), pmf_shape).reshape(num_pmfs)

        # Host-side greedy quantization per row, rows concatenated in the
        # ragged wire format.
        parts = []
        for i in range(num_pmfs):
            p = pmf[i, : pmf_length[i]].astype(np.float32)
            ovf = max(1.0 - p.sum(), 0.0)
            p = np.concatenate([p, [np.float32(ovf)]])
            c = tables.pmf_to_quantized_cdf(p, precision)
            parts.append(np.asarray([-precision], np.int32))
            parts.append(c)
        cdf = np.concatenate(parts) if parts else np.zeros(0, np.int32)
        return cdf, cdf_offset.astype(np.int32)

    def _log_prob(self, prior, bottleneck_perturbed):
        """prior.log_prob, mixed with a unit NoisyLaplace of weight
        ``laplace_tail_mass`` when it is set (reference
        continuous_base.py's laplace_tail_mass): a floor under the
        likelihood of outliers."""
        ltm = self.laplace_tail_mass
        if not ltm:
            return prior.log_prob(bottleneck_perturbed)
        kw = dict(dtype=bottleneck_perturbed.dtype,
                  device=bottleneck_perturbed.device)
        laplace_prior = uniform_noise.NoisyLaplace(
            loc=torch.zeros((), **kw), scale=torch.ones((), **kw))
        probs = prior.prob(bottleneck_perturbed)
        probs = ((1 - ltm) * probs
                 + ltm * laplace_prior.prob(bottleneck_perturbed))
        return torch.where(
            probs < 1e-10,
            torch.log(torch.tensor(max(ltm, 1e-30), **kw))
            + laplace_prior.log_prob(bottleneck_perturbed),
            torch.log(torch.clamp_min(probs, 1e-10)))

    def get_config(self):
        """The model's configuration (counterpart of the JAX package's
        get_config); the tables come with get_weights."""
        if not self.compression:
            raise RuntimeError(
                "Serializing entropy models with `compression=False` is not "
                "supported.")
        return dict(
            coding_rank=self.coding_rank,
            compression=True,
            stateless=False,
            expected_grads=self.expected_grads,
            tail_mass=self.tail_mass,
            cdf_shapes=(int(self.cdf.shape[0]),
                        int(self.cdf_offset.shape[0])),
            laplace_tail_mass=float(self.laplace_tail_mass))

    def get_weights(self):
        return [np.asarray(self.cdf), np.asarray(self.cdf_offset)]

    def set_weights(self, weights):
        if len(weights) != 2:
            raise ValueError("Expected [cdf, cdf_offset].")
        self._init_compression(weights[0], weights[1])

    def _bits(self, log_probs):
        """Bits summed over the coding rank."""
        axes = tuple(range(-self.coding_rank, 0)) if self.coding_rank else ()
        return torch.sum(log_probs, dim=axes) / -math.log(2.0)


def compress_budgeted(symbols, indexes, table, max_gamma_bits,
                       escape_budget):
    """Shared body of the entropy models' compress_device: (bytes [S, L],
    lengths [S], ok) for symbols / indexes int32 [S, N]."""
    n = symbols.shape[1]
    if table.any_overflow:
        slots = 2 * int(max_gamma_bits) + 3
        num_steps = -(-(n + int(escape_budget) * slots) // 64) * 64
        _, meta = table.indexed_arrays()
        _, escape, gamma, _ = cuda_coder.interval_counts(
            symbols, indexes, meta)
        # The JAX package's (loose) float estimate of the intervals.
        count = torch.where(
            escape,
            3 + 2 * torch.ceil(torch.log2(
                gamma.to(torch.float32) + 1)).to(torch.int64), 1)
        ok = (count.sum(1).max() <= num_steps) & (
            torch.where(escape, gamma, 0).max() < (1 << int(max_gamma_bits)))
    else:
        slots = 1
        num_steps = -(-max(n, 1) // 64) * 64
        ok = torch.ones((), dtype=torch.bool, device=symbols.device)
    out_size = -(-(2 * num_steps + 2) // 4) * 4
    buf, lengths = torch_coder.encode_streams_budgeted(
        symbols, indexes, table, slots, num_steps, out_size)
    return buf, lengths, ok
