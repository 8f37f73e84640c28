"""The port's bls2017 serving path end to end against the JAX package, at
num_filters=16 with parameters from a JAX BLS2017Model.init, on a 64x64
and an odd-size image: the native container and the classic .tfci one."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from compression_tpu.models import bls2017 as jax_bls2017
from compression_tpu.models import native_format as jax_native_format
from compression_tpu.codec import jax_coder
from compression_tpu_torch.codec import torch_coder
from compression_tpu_torch.models import bls2017
from compression_tpu_torch.models import native_format
from compression_tpu_torch.util.packed_tensors import PackedTensors

torch.set_num_threads(1)

NUM_FILTERS = 16
SHAPES = {"64x64": (64, 64, 3), "odd_61x47": (61, 47, 3)}


@pytest.fixture(scope="module")
def codecs():
    jm = jax_bls2017.BLS2017Model(lmbda=0.01, num_filters=NUM_FILTERS)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
                     training=False)
    jc = jax_bls2017.BLS2017Codec(jm, params)
    model = bls2017.BLS2017Model(num_filters=NUM_FILTERS)
    model.load_state_dict(bls2017.params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    own = bls2017.BLS2017Codec(model, device="cpu")
    carried = bls2017.BLS2017Codec(model, device="cpu",
                                   tables=jc.em.get_weights())
    return jc, own, carried


def _image(name):
    return np.random.RandomState(sorted(SHAPES).index(name)).randint(
        0, 256, SHAPES[name]).astype(np.uint8)


def _jax_y(jc, x):
    return np.asarray(jc._analysis(jc.params, jnp.asarray(x)[None]))


def _port_native(codec, x, y):
    """The port's native container of the latent ``y`` of image ``x``."""
    y_out = codec.em.compress_sidecar_device(native_format.to_streams(y))
    return codec._container((y_out, tuple(y.shape[1:]), x.shape[:2]))


def _jax_y_hat(jc, container):
    """JAX decode of a native container to the latent y_hat."""
    packed = PackedTensors(container)
    strings, _, y_shape, esc_flat, esc_val = packed.unpack(
        ["bytes", np.int32, np.int32, np.int32, np.int32])
    buf, lens = jax_coder.from_bytes_list(strings)
    h, w = int(y_shape[0]), int(y_shape[1])
    k = jax_native_format.split_factor_from_streams(len(strings), h)
    rows = jc.em.decompress_sidecar(
        buf, lens, (1, w // k), esc_flat.reshape(-1, 2), esc_val)
    return np.asarray(rows).reshape(1, h, w, NUM_FILTERS)


def test_own_tables_equal_jax(codecs):
    jc, own, _ = codecs
    np.testing.assert_array_equal(own.em.cdf, np.asarray(jc.em.cdf))
    np.testing.assert_array_equal(own.em.cdf_offset,
                                  np.asarray(jc.em.cdf_offset))


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_analysis_matches_jax(codecs, name):
    jc, own, _ = codecs
    x = _image(name)
    with torch.no_grad():
        y = own._analysis(own._upload(x)).numpy()
    np.testing.assert_allclose(y, _jax_y(jc, x), rtol=0, atol=1e-4)


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_container_from_same_latent_is_byte_identical(codecs, name):
    jc, _, carried = codecs
    x = _image(name)
    y = torch.as_tensor(_jax_y(jc, x))
    with torch.no_grad():
        mine = _port_native(carried, x, y)
    assert mine == jc._compress_native_host(x)


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_cross_decode(codecs, name):
    """Each package decodes the other's container to the same y_hat."""
    jc, _, carried = codecs
    x = _image(name)
    # Scaled to twice the table width, the latent has values past the
    # table range on both sides: escapes travel in the sidecar.
    y = _jax_y(jc, x)
    y = torch.as_tensor(2.0 * carried.em.device_table.max_len * y
                        / np.abs(y).max())
    with torch.no_grad():
        mine = _port_native(carried, x, y)
        from_jax_bytes, ok, _ = carried._decode_latent(
            carried._unpack(mine))
    assert bool(ok.all())
    assert len(PackedTensors(mine).unpack_raw()[4]) > 0
    expect = carried.em.quantize(y).numpy()
    np.testing.assert_array_equal(from_jax_bytes.numpy(), expect)
    np.testing.assert_array_equal(_jax_y_hat(jc, mine), expect)
    native = jc._compress_native_host(x)
    with torch.no_grad():
        y_hat, ok, _ = carried._decode_latent(carried._unpack(native))
    np.testing.assert_array_equal(y_hat.numpy(), _jax_y_hat(jc, native))


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_round_trip_equals_reconstruct(codecs, name):
    _, own, _ = codecs
    x = _image(name)
    container = own.compress_native(x)
    out = own.decompress(container)
    assert out.shape == x.shape and out.dtype == np.uint8
    np.testing.assert_array_equal(out, own.reconstruct(x))
    assert torch_coder.DISPATCH_LOG["encode"] == "plain-indexed"
    assert torch_coder.DISPATCH_LOG["decode_sidecar"] == "plain-indexed"


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_pixels_across_packages(codecs, name):
    jc, _, carried = codecs
    x = _image(name)
    container = jc._compress_native_host(x)
    mine = carried.decompress(container).astype(np.int32)
    ref = np.asarray(jc.decompress(container)).astype(np.int32)
    assert mine.shape == ref.shape == x.shape
    assert np.abs(mine - ref).max() <= 1


def test_many_equal_single(codecs):
    _, own, _ = codecs
    images = [_image(n) for n in sorted(SHAPES)] + [_image("64x64")[::-1]]
    many = own.compress_native_many(images)
    assert many == [own.compress_native(x) for x in images]
    for out, c in zip(own.decompress_native_many(many), many):
        np.testing.assert_array_equal(out, own.decompress(c))


CORRUPTIONS = {
    "extra_bytes": lambda s: s + b"\x12\x34",
    "all_ff": lambda s: b"\xff" * max(len(s), 4),
    "half": lambda s: s[: len(s) // 2],
    "zeroed": lambda s: b"\x00" * len(s),
    "drop_last": lambda s: s[:-1],
}


def _corrupt(container, kind):
    packed = PackedTensors(container)
    strings, x_shape, y_shape, pairs, vals = packed.unpack_raw()
    out = PackedTensors()
    out.model = packed.model
    out.pack([[CORRUPTIONS[kind](s) for s in strings],
              x_shape.astype(np.int32), y_shape.astype(np.int32),
              pairs.astype(np.int32), vals.astype(np.int32)])
    return out.string


def _raises(fn):
    try:
        fn()
    except ValueError:
        return True
    return False


@pytest.mark.parametrize("kind", sorted(CORRUPTIONS))
def test_corrupt_container_same_verdict(codecs, kind):
    """The sanity check is the reference's weak one, so only some
    corruptions are caught -- but the two packages catch the same ones,
    and streams with unread trailing bytes always raise ValueError."""
    jc, _, carried = codecs
    bad = _corrupt(jc._compress_native_host(_image("64x64")), kind)
    mine = _raises(lambda: carried.decompress(bad))
    assert mine == _raises(lambda: jc.decompress(bad))
    if kind == "extra_bytes":
        assert mine


def test_hostile_escape_positions_raise(codecs):
    jc, _, carried = codecs
    packed = PackedTensors(jc._compress_native_host(_image("64x64")))
    strings, x_shape, y_shape, _, _ = packed.unpack_raw()
    out = PackedTensors()
    out.model = packed.model
    out.pack([strings, x_shape.astype(np.int32), y_shape.astype(np.int32),
              np.asarray([0, 10 ** 6], np.int32), np.asarray([5], np.int32)])
    with pytest.raises(ValueError):
        carried.decompress(out.string)


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_classic_round_trip_equals_reconstruct(codecs, name):
    """decompress(compress(x)) == reconstruct(x) on the classic container,
    whose latent decodes to the same y_hat as the native container's."""
    _, own, _ = codecs
    x = _image(name)
    container = own.compress(x)
    assert PackedTensors(container).num_tensors == 3
    assert torch_coder.DISPATCH_LOG["encode"] in ("plain-gamma",
                                                  "plain-indexed")
    out = own.decompress(container)
    assert torch_coder.DISPATCH_LOG["decode"] == "plain-gamma"
    assert out.shape == x.shape and out.dtype == np.uint8
    np.testing.assert_array_equal(out, own.reconstruct(x))
    with torch.no_grad():
        classic, ok, hw = own._decode_latent(own._unpack(container))
        native, _, _ = own._decode_latent(own._unpack(
            own.compress_native(x)))
    assert bool(ok.all()) and hw == x.shape[:2]
    assert torch.equal(classic, native)


def _classic_strings(container):
    return PackedTensors(container).unpack(["bytes", np.int32, np.int32])


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_classic_container_cross_decode(codecs, name):
    """From the same latent (scaled past the table on both sides, so
    escapes are coded in-stream), the two packages write the same strings
    and each decodes the other's classic container to y_hat."""
    jc, _, carried = codecs
    x = _image(name)
    y = _jax_y(jc, x)
    y = 2.0 * carried.em.device_table.max_len * y / np.abs(y).max()
    strings = carried.em.compress_to_strings(torch.as_tensor(y))
    assert torch_coder.DISPATCH_LOG["encode"] == "plain-gamma"
    assert strings == jc.em.compress_to_strings(jnp.asarray(y))
    packed = PackedTensors()
    packed.model = "bls2017"
    packed.pack([strings, np.asarray(x.shape[:2], np.int32),
                 np.asarray(y.shape[1:3], np.int32)])
    expect = carried.em.quantize(torch.as_tensor(y)).numpy()
    with torch.no_grad():
        y_hat, ok, _ = carried._decode_latent(carried._unpack(packed.string))
    assert bool(ok.all())
    np.testing.assert_array_equal(y_hat.numpy(), expect)
    np.testing.assert_array_equal(
        np.asarray(jc.em.decompress(strings, tuple(y.shape[1:3]))), expect)
    # The JAX package's own classic container, from its own latent.
    ref = jc.compress(x)
    y_ref = jc.em.decompress(_classic_strings(ref)[0], y.shape[1:3])
    with torch.no_grad():
        y_hat, ok, _ = carried._decode_latent(carried._unpack(ref))
    np.testing.assert_array_equal(y_hat.numpy(), np.asarray(y_ref))


def test_classic_many_equal_single(codecs):
    """decompress_native_many takes classic and native containers mixed."""
    _, own, _ = codecs
    images = [_image(n) for n in sorted(SHAPES)]
    mixed = [own.compress(images[0]), own.compress_native(images[1]),
             own.compress(images[1])]
    for out, c in zip(own.decompress_native_many(mixed), mixed):
        np.testing.assert_array_equal(out, own.decompress(c))


@pytest.mark.parametrize("kind", sorted(CORRUPTIONS))
def test_corrupt_classic_container_same_verdict(codecs, kind):
    """As for the native container: the two packages reject the same
    corrupted classic containers, and unread trailing bytes always
    raise ValueError."""
    jc, _, carried = codecs
    strings, x_shape, y_shape = _classic_strings(jc.compress(
        _image("64x64")))
    out = PackedTensors()
    out.model = "bls2017"
    out.pack([[CORRUPTIONS[kind](s) for s in strings], x_shape, y_shape])
    mine = _raises(lambda: carried.decompress(out.string))
    assert mine == _raises(lambda: jc.decompress(out.string))
    if kind == "extra_bytes":
        assert mine


def test_model_eval_forward_matches_jax(codecs):
    jc, own, _ = codecs
    x = _image("64x64")[None].astype(np.float32)
    ref = jc.model.apply(jc.params, jnp.asarray(x), training=False)
    with torch.no_grad():
        mine = own.model(torch.as_tensor(x))
    for a, b in zip(mine, ref):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-4)


def test_default_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        bls2017.BLS2017Codec(bls2017.BLS2017Model(num_filters=4))
