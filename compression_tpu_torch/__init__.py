"""PyTorch/CUDA port of compression_tpu (learned data compression).

The JAX package ``compression_tpu`` is the reference; this package carries
it to PyTorch: the bit-exact range coder with its kernels hand-written in
CUDA C++ for Hopper (``codec/csrc``), the distributions and entropy models,
the GDN and SignalConv layers, and the models (bls2017, bmshj2018, ms2020,
HiFiC, lvac and the toy sources) with their containers, command lines and
training steps.  It never imports JAX or the JAX package.

The top-level names mirror the JAX package's (its ``jax_coder`` is
``torch_coder`` here).  They are imported on first use, so that
``import compression_tpu_torch`` loads no coder module and builds nothing.
"""

from __future__ import annotations

import importlib

__version__ = "0.1.0"

_MODULES = {
    "torch_coder": "codec.torch_coder",
    "legacy": "codec.legacy",
    "reference": "codec.reference",
    "stream": "codec.stream",
    "tables": "codec.tables",
}

_NAMES = {
    # Codec core.
    "DeviceCdfTable": "codec.torch_coder",
    "decode_streams": "codec.torch_coder",
    "encode_streams": "codec.torch_coder",
    "CdfTable": "codec.tables",
    "pmf_to_quantized_cdf": "codec.tables",
    # Distributions.
    "Categorical": "distributions.base",
    "Distribution": "distributions.base",
    "Laplace": "distributions.base",
    "Logistic": "distributions.base",
    "MixtureSameFamily": "distributions.base",
    "Normal": "distributions.base",
    "DeepFactorized": "distributions.deep_factorized",
    "NoisyDeepFactorized": "distributions.deep_factorized",
    "UniformNoiseAdapter": "distributions.uniform_noise",
    "NoisyLaplace": "distributions.uniform_noise",
    "NoisyLogistic": "distributions.uniform_noise",
    "NoisyLogisticMixture": "distributions.uniform_noise",
    "NoisyMixtureSameFamily": "distributions.uniform_noise",
    "NoisyNormal": "distributions.uniform_noise",
    "NoisyNormalMixture": "distributions.uniform_noise",
    "MonotonicAdapter": "distributions.round_adapters",
    "NoisyRoundAdapter": "distributions.round_adapters",
    "NoisyRoundedDeepFactorized": "distributions.round_adapters",
    "NoisyRoundedNormal": "distributions.round_adapters",
    "NoisySoftRoundAdapter": "distributions.round_adapters",
    "NoisySoftRoundedDeepFactorized": "distributions.round_adapters",
    "NoisySoftRoundedNormal": "distributions.round_adapters",
    "RoundAdapter": "distributions.round_adapters",
    "SoftRoundAdapter": "distributions.round_adapters",
    "estimate_tails": "distributions.helpers",
    "lower_tail": "distributions.helpers",
    "quantization_offset": "distributions.helpers",
    "upper_tail": "distributions.helpers",
    # Entropy models.
    "ContinuousBatchedEntropyModel": "entropy_models.continuous_batched",
    "ContinuousEntropyModelBase": "entropy_models.continuous_base",
    "ContinuousIndexedEntropyModel": "entropy_models.continuous_indexed",
    "LocationScaleIndexedEntropyModel": "entropy_models.continuous_indexed",
    "LaplaceEntropyModel": "entropy_models.laplace",
    "PowerLawEntropyModel": "entropy_models.power_law",
    "UniversalBatchedEntropyModel": "entropy_models.universal",
    "UniversalIndexedEntropyModel": "entropy_models.universal",
    # Layers.
    "GDN": "layers.gdn",
    "SignalConv1D": "layers.signal_conv",
    "SignalConv2D": "layers.signal_conv",
    "SignalConv3D": "layers.signal_conv",
    "signal_conv": "layers.signal_conv",
    "SoftRound": "layers.soft_round",
    "SoftRoundConditionalMean": "layers.soft_round",
    "identity_initializer": "layers.initializers",
    # Ops.
    "lower_bound": "ops.math_ops",
    "upper_bound": "ops.math_ops",
    "perturb_and_apply": "ops.math_ops",
    "round_st": "ops.round_ops",
    "soft_round": "ops.round_ops",
    "soft_round_conditional_mean": "ops.round_ops",
    "soft_round_inverse": "ops.round_ops",
    "same_padding_for_kernel": "ops.padding_ops",
    "stochastic_round": "ops.quantization",
    "run_length_decode": "ops.run_length",
    "run_length_encode": "ops.run_length",
    "run_length_gamma_decode": "ops.run_length",
    "run_length_gamma_encode": "ops.run_length",
    # Util.
    "PackedTensors": "util.packed_tensors",
}

__all__ = sorted(_MODULES) + sorted(_NAMES) + ["__version__"]


def __getattr__(name):
    if name in _MODULES:
        value = importlib.import_module(f"{__name__}.{_MODULES[name]}")
    elif name in _NAMES:
        module = importlib.import_module(f"{__name__}.{_NAMES[name]}")
        value = getattr(module, name)
    else:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))
