"""The port's signal convolutions (functional and SignalConv1D / 2D / 3D),
GDN / IGDN, the parameter reparameterizations, the identity initializer and
the same-padding helper against the JAX package with carried parameters.

Tolerances: the image models' layers rtol 1e-5 / atol 1e-5 (float32
convolutions sum in another order in XLA and in PyTorch's CPU kernels).
``signal_conv`` runs every case of the JAX package's
TestSignalConvReferenceMatrix (tests/test_layers.py) twice: on its integer
inputs, within atol 1e-3 as there, and on random float inputs with
several channels, within 1e-5 of the largest output.  GDN within 1e-5 of
the largest output."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from compression_tpu.layers import GDN as JaxGDN
from compression_tpu.layers import SignalConv1D as JaxSignalConv1D
from compression_tpu.layers import SignalConv2D as JaxSignalConv2D
from compression_tpu.layers import SignalConv3D as JaxSignalConv3D
from compression_tpu.layers import parameters as jax_parameters
from compression_tpu.layers.initializers import (
    identity_initializer as jax_identity_initializer)
from compression_tpu.layers.signal_conv import signal_conv as jax_signal_conv
from compression_tpu.ops import padding_ops as jax_padding_ops
from compression_tpu_torch.layers import parameters
from compression_tpu_torch.layers.gdn import GDN
from compression_tpu_torch.layers.initializers import identity_initializer
from compression_tpu_torch.layers.signal_conv import (
    SignalConv1D, SignalConv2D, SignalConv3D, signal_conv)
from compression_tpu_torch.ops import padding_ops

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
                        strides_up=up, padding="same_zeros", use_bias=True)
    mine.load_state_dict({
        "kernel_rdft": torch.tensor(params["params"]["kernel_rdft"]),
        "bias": torch.tensor(params["params"]["bias"])})
    out = _nhwc(mine(_nchw(x)))
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, **TOL)


def test_signal_conv_rejects_unported_modes():
    """Padding modes and kernel forms neither package has are refused."""
    with pytest.raises(ValueError):
        SignalConv2D(3, 4, 5, corr=True, strides_up=2, padding="same_circular")
    with pytest.raises(ValueError):
        SignalConv2D(3, 4, 5, corr=False, strides_down=2,
                     kernel_parameter="fft")
    with pytest.raises(ValueError):
        signal_conv(torch.zeros(1, 1, 8), torch.zeros(3, 1, 1),
                    padding="same_circular")


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


# -- signal_conv, general ----------------------------------------------------
def _matrix_cases():
    """Every case of tests/test_layers.py::TestSignalConvReferenceMatrix as
    (name, rank, shape, support, corr, strides_down, strides_up, padding,
    extra_pad_end, separable filters or 0, identity kernel)."""
    cases = []
    for corr in (True, False):
        for sd, su, extra in ((2, 3, True), (3, 2, True), (2, 2, False),
                              (5, 3, True), (2, 3, False)):
            for k in (1, 2, 3, 7):
                cases.append((f"1d_rational-{corr}-{sd}-{su}-{extra}-{k}", 1,
                              (13,), (k,), corr, (sd,), (su,), "valid",
                              extra, 0, False))
    for corr in (True, False):
        for sd, su in (((3, 5), (1, 1)), ((1, 1), (4, 3)),
                       ((2, 2), (3, 2))):
            for ks in ((5, 2), (2, 3), (3, 3)):
                cases.append((f"2d_anisotropic-{corr}-{sd}-{su}-{ks}", 2,
                              (10, 9), ks, corr, sd, su, "valid", True, 0,
                              False))
    for corr in (True, False):
        for sd, su in (((1, 1, 1), (1, 1, 1)), ((2, 1, 2), (1, 1, 1)),
                       ((1, 1, 1), (2, 2, 1))):
            cases.append((f"3d_valid-{corr}-{sd}-{su}", 3, (6, 5, 7),
                          (3, 2, 3), corr, sd, su, "valid", True, 0, False))
    for rank in (1, 2):
        for padding in ("same_zeros", "same_reflect"):
            for corr in (True, False):
                for sd, su, extra in ((1, 1, True), (1, 2, False),
                                      (1, 3, True), (2, 1, True),
                                      (5, 1, True), (2, 3, True)):
                    for k in (1, 2, 3, 7):
                        cases.append((
                            f"same_identity-{rank}-{padding}-{corr}-{sd}-"
                            f"{su}-{extra}-{k}", rank,
                            (12,) if rank == 1 else (8, 9), (k,) * rank,
                            corr, (sd,) * rank, (su,) * rank, padding, extra,
                            0, True))
    for rank in (1, 2):
        for filters in (1, 2):
            for su in (1, 2):
                cases.append((f"separable-{rank}-{filters}-{su}", rank,
                              (9,) if rank == 1 else (7, 6), (3,) * rank,
                              True, (1,) * rank, (su,) * rank, "valid", True,
                              filters, False))
    return cases


MATRIX = _matrix_cases()


def _conv_inputs(case, kind):
    """(x [1, *shape, cin] NHWC-style, kernel [*support, kin, kout]) numpy:
    the JAX test's integer inputs, or random floats with more channels."""
    name, rank, shape, support, _, _, _, _, _, filters, identity = case
    rng = np.random.RandomState(MATRIX.index(case))
    channels = 2 if filters else 1
    if kind == "float":
        channels = 2 if filters else 3
        x = rng.normal(0, 1, (2,) + shape + (channels,))
        cout = filters * channels if filters else 4
        kernel = rng.normal(0, 1, support + (
            1 if filters else channels, cout))
    elif identity:
        x = np.arange(np.prod(shape)).reshape((1,) + shape + (1,)) + 1.0
        kernel = np.asarray(jax_identity_initializer()(
            None, support + (1, 1)))
    else:
        x = rng.randint(0, 32, (1,) + shape + (channels,))
        kernel = rng.randint(0, 16, support + (
            1 if filters else channels, channels * filters if filters
            else 1))
    return x.astype(np.float32), kernel.astype(np.float32)


def _channels_first(x):
    return torch.as_tensor(np.moveaxis(x, -1, 1).copy())


@pytest.mark.parametrize("kind", ["integer", "float"])
@pytest.mark.parametrize("case", MATRIX, ids=[c[0] for c in MATRIX])
def test_signal_conv_matrix_matches_jax(case, kind):
    _, _, _, _, corr, sd, su, padding, extra, filters, _ = case
    x, kernel = _conv_inputs(case, kind)
    kw = dict(corr=corr, strides_down=sd, strides_up=su, padding=padding,
              extra_pad_end=extra, channel_separable=bool(filters))
    want = np.asarray(jax_signal_conv(jnp.asarray(x), jnp.asarray(kernel),
                                      **kw))
    got = signal_conv(_channels_first(x), torch.as_tensor(kernel), **kw)
    got = np.moveaxis(got.numpy(), 1, -1)
    assert got.shape == want.shape
    if kind == "integer":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    else:
        scale = max(float(np.abs(want).max()), 1e-30)
        assert np.abs(got - want).max() <= 1e-5 * scale


def _old_same_zeros(layer, x):
    """SignalConv2D's forward before the general form (its two lowerings
    for square supports and equal strides), spelled out here."""
    k = layer.support[0]
    kernel = layer.kernel_value()
    if layer.corr:
        before = k // 2
        after = k - 1 - before
        x = torch.nn.functional.pad(x, (before, after, before, after))
        return torch.nn.functional.conv2d(
            x, kernel.permute(3, 2, 0, 1), layer.bias,
            stride=layer.strides_down[0])
    u = layer.strides_up[0]
    p = k - 1 - (k - 1) // 2
    return torch.nn.functional.conv_transpose2d(
        x, kernel.permute(2, 3, 0, 1), layer.bias, stride=u, padding=p,
        output_padding=u - 1)


@pytest.mark.parametrize("name", sorted(CONV_CASES))
def test_same_zeros_2d_route_bit_identical(name):
    """The image models' layers give bit for bit what they gave before
    SignalConv was generalized."""
    k, corr, down, up, cin, cout, h, w = CONV_CASES[name]
    gen = torch.Generator().manual_seed(3)
    layer = SignalConv2D(cin, cout, k, corr=corr, strides_down=down,
                         strides_up=up, padding="same_zeros", use_bias=True,
                         generator=gen)
    with torch.no_grad():
        layer.bias.normal_(generator=gen)
    x = torch.randn((2, cin, h, w), generator=gen)
    assert torch.equal(layer(x), _old_same_zeros(layer, x))


# (rank, kernel_parameter, support, corr, down, up, padding, separable)
MODULE_CASES = {
    "1d_rdft_corr_down4": (1, "rdft", 9, True, 4, 1, "same_zeros", False),
    "1d_rdft_conv_up4": (1, "rdft", 9, False, 1, 4, "same_zeros", False),
    "1d_variable_rational": (1, "variable", 5, False, 2, 3, "valid", False),
    "1d_variable_reflect_separable": (1, "variable", 4, True, 2, 1,
                                      "same_reflect", True),
    "3d_rdft_corr_down2": (3, "rdft", 3, True, 2, 1, "same_zeros", False),
    "3d_rdft_reflect_up2": (3, "rdft", (3, 2, 3), False, 1, 2,
                            "same_reflect", False),
    "3d_variable_valid": (3, "variable", 3, True, (2, 1, 1), 1, "valid",
                          False),
    "3d_variable_separable": (3, "variable", 2, False, 1, (1, 2, 2),
                              "same_zeros", True),
}


@pytest.mark.parametrize("name", sorted(MODULE_CASES))
def test_signal_conv_module_matches_jax(name):
    """SignalConv1D / SignalConv3D with the JAX module's kernel and bias
    carried over (params_from_jax style), in both kernel forms."""
    rank, param, k, corr, down, up, padding, separable = MODULE_CASES[name]
    rng = np.random.RandomState(sorted(MODULE_CASES).index(name))
    cin, filters = 3, 2
    shape = (19,) if rank == 1 else (7, 6, 5)
    x = rng.normal(0, 1, (2,) + shape + (cin,)).astype(np.float32)
    jax_cls = JaxSignalConv1D if rank == 1 else JaxSignalConv3D
    kw = dict(kernel_support=k, corr=corr, strides_down=down,
              strides_up=up, padding=padding, channel_separable=separable,
              use_bias=True)
    layer = jax_cls(filters=filters, kernel_parameter=param, **kw)
    params = jax.tree_util.tree_map(
        np.asarray, layer.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    p = params["params"]
    p["bias"] = rng.normal(0, 0.5, p["bias"].shape).astype(np.float32)
    want = np.asarray(layer.apply(params, jnp.asarray(x)))
    cls = SignalConv1D if rank == 1 else SignalConv3D
    mine = cls(cin, filters, kernel_parameter=param, **kw)
    mine.load_state_dict({key: torch.tensor(v) for key, v in p.items()})
    got = np.moveaxis(mine(_channels_first(x)).detach().numpy(), 1, -1)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("shape", [(5,), (8,), (5, 3), (3, 4, 5), (2, 3, 3)],
                         ids=lambda s: "x".join(map(str, s)))
def test_rdft_general_rank_matches_jax(shape):
    rng = np.random.RandomState(len(shape))
    kernel = rng.normal(0, 1, shape + (2, 3)).astype(np.float32)
    real, imag = parameters.rdft_init(torch.as_tensor(kernel))
    j_real, j_imag = jax_parameters.rdft_init(jnp.asarray(kernel))
    np.testing.assert_allclose(real.numpy(), np.asarray(j_real), **TOL)
    np.testing.assert_allclose(imag.numpy(), np.asarray(j_imag), **TOL)
    back = parameters.rdft_to_kernel(real, imag, shape)
    np.testing.assert_allclose(back.numpy(), kernel, **TOL)
    with pytest.raises(ValueError):
        parameters.rdft_init(torch.zeros(3, 2))


@pytest.mark.parametrize("shape", [(5, 3, 3), (3, 3, 2, 4), (3, 1, 3, 2, 2)],
                         ids=lambda s: "x".join(map(str, s)))
def test_identity_initializer_matches_jax(shape):
    got = identity_initializer(1.5)(shape)
    want = np.asarray(jax_identity_initializer(1.5)(None, shape))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError):
        identity_initializer()((3, 3))


def test_same_padding_for_kernel_matches_jax():
    for shape in ((1,), (4,), (5, 2), (3, 4, 7)):
        for corr in (True, False):
            for up in (None, (2,) * len(shape), (3,) * len(shape)):
                assert (padding_ops.same_padding_for_kernel(shape, corr, up)
                        == jax_padding_ops.same_padding_for_kernel(
                            shape, corr, up))


# -- GDN, general ------------------------------------------------------------
GDN_CASES = [(alpha, epsilon, rank)
             for alpha in (1.0, 2.0, 1.5, None)
             for epsilon in (1.0, 0.5, 0.7, None)
             for rank in (1, 2, 3)]


@pytest.mark.parametrize(
    "alpha,epsilon,rank", GDN_CASES,
    ids=[f"a{a}-e{e}-r{r}" for a, e, r in GDN_CASES])
def test_gdn_general_matches_jax(alpha, epsilon, rank):
    """Each (alpha, epsilon, rank) with one of the four (rectify, inverse)
    pairs, in turn, against flax's GDN with carried parameters."""
    i = GDN_CASES.index((alpha, epsilon, rank))
    rectify, inverse = ((False, False), (True, False), (False, True),
                        (True, True))[i % 4]
    rng = np.random.RandomState(i)
    c = 4
    shape = (2,) + (9, 6, 5)[:rank] + (c,)
    x = rng.normal(0, 2, shape).astype(np.float32)
    layer = JaxGDN(inverse=inverse, rectify=rectify, alpha=alpha,
                   epsilon=epsilon)
    params = jax.tree_util.tree_map(
        np.asarray, layer.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    p = params["params"]
    for key in p:
        p[key] = (p[key] + rng.uniform(0, 0.3, p[key].shape)).astype(
            np.float32)
    want = np.asarray(layer.apply(params, jnp.asarray(x)))
    mine = GDN(c, inverse=inverse, rectify=rectify, alpha=alpha,
               epsilon=epsilon)
    mine.load_state_dict({k: torch.tensor(v) for k, v in p.items()})
    got = np.moveaxis(mine(_channels_first(x)).detach().numpy(), 1, -1)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_gdn_trainable_exponents_gradients_match_jax():
    rng = np.random.RandomState(5)
    c = 3
    x = rng.normal(0, 2, (2, 7, c)).astype(np.float32)
    layer = JaxGDN(alpha=None, epsilon=None)
    params = jax.tree_util.tree_map(
        np.asarray, layer.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    p = params["params"]
    for key in p:
        p[key] = (p[key] + rng.uniform(0, 0.3, p[key].shape)).astype(
            np.float32)
    want = jax.grad(lambda q: jnp.sum(
        layer.apply({"params": q}, jnp.asarray(x)) ** 2))(p)
    mine = GDN(c, alpha=None, epsilon=None)
    mine.load_state_dict({k: torch.tensor(v) for k, v in p.items()})
    torch.sum(mine(_channels_first(x)) ** 2).backward()
    for key, g in want.items():
        g = np.asarray(g)
        got = getattr(mine, key).grad.numpy()
        assert np.abs(got - g).max() <= 1e-4 * np.abs(g).max(), key
