"""The port's SignalConv2D, GDN/IGDN and parameter reparameterizations
against the JAX layers with converted parameters.

Tolerance rtol 1e-5 / atol 1e-5: float32 convolutions sum in another order
in XLA and in PyTorch's CPU kernels."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from compression_tpu.layers import GDN as JaxGDN
from compression_tpu.layers import SignalConv2D as JaxSignalConv2D
from compression_tpu.layers import parameters as jax_parameters
from compression_tpu_torch.layers import parameters
from compression_tpu_torch.layers.gdn import GDN
from compression_tpu_torch.layers.signal_conv import SignalConv2D

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


def _nchw(x):
    return torch.as_tensor(np.asarray(x)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


# (support, corr, strides_down, strides_up, in, out, height, width)
CONV_CASES = {
    "corr9_down4": (9, True, 4, 1, 3, 8, 19, 13),
    "corr5_down2": (5, True, 2, 1, 8, 6, 9, 10),
    "conv5_up2": (5, False, 1, 2, 6, 8, 5, 4),
    "conv9_up4": (9, False, 1, 4, 8, 3, 3, 5),
}


@pytest.mark.parametrize("name", sorted(CONV_CASES))
def test_signal_conv_matches_jax(name):
    k, corr, down, up, cin, cout, h, w = CONV_CASES[name]
    rng = np.random.RandomState(sorted(CONV_CASES).index(name))
    x = rng.normal(0, 1, (2, h, w, cin)).astype(np.float32)
    layer = JaxSignalConv2D(filters=cout, kernel_support=k, corr=corr,
                            strides_down=down, strides_up=up,
                            padding="same_zeros", use_bias=True)
    params = layer.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = jax.tree_util.tree_map(np.asarray, params)
    params["params"]["bias"] = rng.normal(0, 0.5, cout).astype(np.float32)
    ref = np.asarray(layer.apply(params, jnp.asarray(x)))

    mine = SignalConv2D(cin, cout, k, corr=corr, strides_down=down,
                        strides_up=up, use_bias=True)
    mine.load_state_dict({
        "kernel_rdft": torch.tensor(params["params"]["kernel_rdft"]),
        "bias": torch.tensor(params["params"]["bias"])})
    out = _nhwc(mine(_nchw(x)))
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, **TOL)


def test_signal_conv_rejects_unported_modes():
    with pytest.raises(NotImplementedError):
        SignalConv2D(3, 4, 5, corr=True, strides_up=2)
    with pytest.raises(NotImplementedError):
        SignalConv2D(3, 4, 5, corr=False, strides_down=2)


@pytest.mark.parametrize("inverse", [False, True])
def test_gdn_matches_jax(inverse):
    rng = np.random.RandomState(int(inverse))
    c = 6
    x = rng.normal(0, 2, (2, 5, 7, c)).astype(np.float32)
    layer = JaxGDN(inverse=inverse)
    params = jax.tree_util.tree_map(
        np.asarray, layer.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    p = params["params"]
    p["reparam_beta"] = (p["reparam_beta"] + rng.uniform(0, 0.5, c)).astype(
        np.float32)
    p["reparam_gamma"] = (p["reparam_gamma"] + rng.uniform(
        0, 0.3, (c, c))).astype(np.float32)
    ref = np.asarray(layer.apply(params, jnp.asarray(x)))
    mine = GDN(c, inverse=inverse)
    mine.load_state_dict({k: torch.tensor(v) for k, v in p.items()})
    np.testing.assert_allclose(_nhwc(mine(_nchw(x))), ref, **TOL)


@pytest.mark.parametrize("support", [5, 9])
def test_rdft_round_trip_matches_jax(support):
    rng = np.random.RandomState(support)
    kernel = rng.normal(0, 1, (support, support, 3, 4)).astype(np.float32)
    real, imag = parameters.rdft_init(torch.as_tensor(kernel))
    j_real, j_imag = jax_parameters.rdft_init(jnp.asarray(kernel))
    np.testing.assert_allclose(real.numpy(), np.asarray(j_real), **TOL)
    np.testing.assert_allclose(imag.numpy(), np.asarray(j_imag), **TOL)
    back = parameters.rdft_to_kernel(real, imag, (support, support))
    np.testing.assert_allclose(
        back.numpy(), np.asarray(jax_parameters.rdft_to_kernel(
            j_real, j_imag, (support, support))), **TOL)
    np.testing.assert_allclose(back.numpy(), kernel, **TOL)


def test_gdn_param_round_trip_matches_jax():
    v = np.asarray([0.0, 1e-7, 0.1, 1.0, 3.0], np.float32)
    mine = parameters.gdn_param_value(
        parameters.gdn_param_init(torch.as_tensor(v)), minimum=1e-6)
    ref = jax_parameters.gdn_param_value(
        jax_parameters.gdn_param_init(jnp.asarray(v)), minimum=1e-6)
    np.testing.assert_allclose(mine.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-9)
