"""The port's bmshj2018 serving path end to end against the JAX package and
the reference's golden fixtures: at num_filters=16 with parameters from a
JAX BMSHJ2018Model.init on a 64x64 and an odd-size image, on
golden_bmshj.npz (24 filters, the reference's trained-for-a-moment weights)
and on golden_bmshj_full.npz (192 filters, synthesized weights).

Tolerances: latents within 5e-5 of the JAX package's (3e-4 of the
reference's at 192 filters, the JAX tests' own bound), eval bpp / mse within
1e-5 relative; tables, containers, strings and decoded latents exact.
Decoded pixels are exact too, except where the float image lies within 2e-4
of a rounding boundary: there the packages' float error (up to 1e-4) decides
the rounding, and the test reports the pixel.
"""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from compression_tpu.models import bmshj2018 as jax_bmshj
from compression_tpu_torch.codec import torch_coder
from compression_tpu_torch.models import bmshj2018
from compression_tpu_torch.util.packed_tensors import PackedTensors

torch.set_num_threads(1)

NUM_FILTERS = 16
SHAPES = {"64x64": (64, 64, 3), "odd_61x47": (61, 47, 3)}
GOLD_DIR = os.path.join(os.path.dirname(__file__), "golden")
BOUNDARY = 2e-4


@pytest.fixture(scope="module")
def codecs():
    jm = jax_bmshj.BMSHJ2018Model(num_filters=NUM_FILTERS)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
                     training=False)
    jc = jax_bmshj.BMSHJ2018Codec(jm, params)
    model = bmshj2018.BMSHJ2018Model(num_filters=NUM_FILTERS)
    model.load_state_dict(bmshj2018.params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    own = bmshj2018.BMSHJ2018Codec(model, device="cpu")
    carried = bmshj2018.BMSHJ2018Codec(
        model, device="cpu",
        tables=(jc.em.get_weights(), jc.side_em.get_weights()))
    return jc, own, carried, params


def _image(name):
    return np.random.RandomState(sorted(SHAPES).index(name)).randint(
        0, 256, SHAPES[name]).astype(np.uint8)


def _jax_latents(jc, x, scale=None):
    """JAX (y, z, indexes); ``scale`` stretches y past the table range."""
    y, z = jc._encode(jc.params, jnp.asarray(x)[None])
    indexes = jc._hyper_decode(jc.params, jc.side_em.quantize(z))
    indexes = indexes[:, : y.shape[1], : y.shape[2], :]
    y, z, indexes = np.asarray(y), np.asarray(z), np.asarray(indexes)
    if scale is not None:
        y = (scale * y / np.abs(y).max()).astype(np.float32)
        z = (scale * z / np.abs(z).max()).astype(np.float32)
    return y, z, indexes


def _jax_classic(jc, x, y, z, indexes):
    """The JAX package's classic container of given latents."""
    packed = jax_bmshj.PackedTensors()
    packed.model = jc.MODEL_ID
    packed.pack([jc.em.compress_to_strings(y, indexes),
                 jc.side_em.compress_to_strings(z),
                 np.asarray(x.shape[:2], np.int32),
                 np.asarray(y.shape[1:-1], np.int32),
                 np.asarray(z.shape[1:-1], np.int32)])
    return packed.string


def _jax_native(jc, x, y, z, indexes):
    """The JAX package's native container of given latents (the layout of
    its _compress_native_host)."""
    from compression_tpu.codec import jax_coder
    from compression_tpu.models import native_format as nf
    z_buf, z_len, z_ep, z_ev = jc.side_em.compress_sidecar(nf.to_streams(z))
    y_buf, y_len, y_ep, y_ev = jc.em.compress_sidecar(
        nf.to_streams(y), nf.to_streams(indexes))
    packed = jax_bmshj.PackedTensors()
    packed.model = jc.MODEL_ID
    packed.pack([jax_coder.to_bytes_list(y_buf, y_len),
                 jax_coder.to_bytes_list(z_buf, z_len),
                 np.asarray(x.shape[:2], np.int32),
                 np.asarray(y.shape[1:-1], np.int32),
                 np.asarray(z.shape[1:-1], np.int32),
                 y_ep.ravel().astype(np.int32), y_ev.astype(np.int32),
                 z_ep.ravel().astype(np.int32), z_ev.astype(np.int32)])
    return packed.string


def _port_classic(codec, x, y, z, indexes):
    packed = PackedTensors()
    packed.model = codec.MODEL_ID
    packed.pack([codec.em.compress_to_strings(torch.tensor(y),
                                              torch.tensor(indexes)),
                 codec.side_em.compress_to_strings(torch.tensor(z)),
                 np.asarray(x.shape[:2], np.int32),
                 np.asarray(y.shape[1:-1], np.int32),
                 np.asarray(z.shape[1:-1], np.int32)])
    return packed.string


def _port_native(codec, x, y, z, indexes):
    from compression_tpu_torch.models import native_format as nf
    y_t, z_t, i_t = (torch.tensor(a) for a in (y, z, indexes))
    y_out = codec.em.compress_sidecar_device(nf.to_streams(y_t),
                                             nf.to_streams(i_t))
    z_out = codec.side_em.compress_sidecar_device(nf.to_streams(z_t))
    return codec._container((y_out, tuple(y.shape[1:]), z_out,
                             tuple(z.shape[1:]), tuple(x.shape[:2])))


def test_own_tables_equal_jax(codecs):
    jc, own, _, _ = codecs
    for mine, ref in ((own.em, jc.em), (own.side_em, jc.side_em)):
        np.testing.assert_array_equal(mine.cdf, np.asarray(ref.cdf))
        np.testing.assert_array_equal(mine.cdf_offset,
                                      np.asarray(ref.cdf_offset))
    assert own.latent_depth == jc.latent_depth == NUM_FILTERS


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_latents_match_jax(codecs, name):
    jc, own, _, _ = codecs
    x = _image(name)
    y, z, indexes = _jax_latents(jc, x)
    with torch.no_grad():
        my, mz, mi, _ = own._encode(own._upload(x))
    np.testing.assert_allclose(my.numpy(), y, rtol=0, atol=5e-5)
    np.testing.assert_allclose(mz.numpy(), z, rtol=0, atol=5e-5)
    assert tuple(mi.shape) == indexes.shape  # cropped to y
    np.testing.assert_allclose(mi.numpy(), indexes, rtol=0, atol=5e-4)


def test_model_eval_forward_matches_jax(codecs):
    jc, own, _, params = codecs
    x = _image("64x64")
    ref = jc.model.apply(params, jnp.asarray(x, jnp.float32)[None],
                         training=False)
    with torch.no_grad():
        mine = own.model(torch.as_tensor(x)[None])
    for a, b in zip(mine, ref):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-5)
    # Training mode needs a noise source (a generator or u).
    with pytest.raises(ValueError):
        own.model(torch.as_tensor(x)[None], training=True)


@pytest.mark.parametrize("scale", [None, 3000.0])
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_containers_from_same_latents_are_byte_identical(codecs, name,
                                                         scale):
    """Both containers, fed the JAX package's (y, z, indexes): equal bytes;
    with the latents stretched past the tables the escapes travel in the
    streams (classic) or the sidecar (native)."""
    jc, _, carried, _ = codecs
    x = _image(name)
    y, z, indexes = _jax_latents(jc, x, scale)
    with torch.no_grad():
        classic = _port_classic(carried, x, y, z, indexes)
        native = _port_native(carried, x, y, z, indexes)
    assert classic == _jax_classic(jc, x, y, z, indexes)
    assert native == _jax_native(jc, x, y, z, indexes)
    if scale is not None:
        raw = PackedTensors(native).unpack_raw()
        assert len(raw[5]) > 0 and len(raw[7]) > 0


@pytest.mark.parametrize("kind", ["classic", "native"])
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_cross_decode(codecs, name, kind):
    """Each package decodes the other's container.  The decoded latent is
    compared (exactly), not the pixels: the scale indexes pass through the
    hyper synthesis of the decoding package, so the latents are stretched
    only mildly to keep every index well inside its row."""
    jc, _, carried, _ = codecs
    x = _image(name)
    y, z, indexes = _jax_latents(jc, x)
    make_j, make_p = (_jax_classic, _port_classic) if kind == "classic" \
        else (_jax_native, _port_native)
    with torch.no_grad():
        mine = make_p(carried, x, y, z, indexes)
        theirs = make_j(jc, x, y, z, indexes)
        assert mine == theirs
        y_hat, ok, x_hw = carried._decode_latent(carried._unpack(theirs))
    assert bool(ok.all()) and x_hw == x.shape[:2]
    # The port's hyper synthesis must reproduce the row ids the encoder
    # used, or the y stream would not decode to round(y).
    np.testing.assert_array_equal(y_hat.numpy(), np.round(y))
    # The JAX package decodes the port's bytes to the port's pixels up to
    # the float error of the two synthesis transforms.
    with torch.no_grad():
        px = carried.decompress(mine)
    jx = jc.decompress(mine)
    assert px.shape == jx.shape == x.shape
    assert np.abs(px.astype(int) - jx.astype(int)).max() <= 1


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_round_trips_equal_reconstruct(codecs, name):
    _, own, _, _ = codecs
    x = _image(name)
    expect = own.reconstruct(x)
    assert expect.shape == x.shape and expect.dtype == np.uint8
    classic, native = own.compress(x), own.compress_native(x)
    assert torch_coder.DISPATCH_LOG["encode"] == "plain-indexed"
    assert PackedTensors(classic).num_tensors == 5
    assert PackedTensors(native).num_tensors == 9
    np.testing.assert_array_equal(own.decompress(classic), expect)
    np.testing.assert_array_equal(own.decompress(native), expect)


def test_many_equal_single(codecs):
    _, own, _, _ = codecs
    images = [_image(n) for n in sorted(SHAPES)] + [_image("64x64")[:40]]
    singles = [own.compress_native(x) for x in images]
    assert own.compress_native_many(images) == singles
    mixed = singles + [own.compress(images[1])]
    outs = own.decompress_native_many(mixed)
    for out, c in zip(outs, mixed):
        np.testing.assert_array_equal(out, own.decompress(c))


CORRUPTIONS = {
    "extra_bytes": lambda s: s + b"\x12\x34",
    "all_ff": lambda s: b"\xff" * max(len(s), 4),
    "half": lambda s: s[: len(s) // 2],
    "zeroed": lambda s: b"\x00" * len(s),
    "drop_last": lambda s: s[:-1],
}


def _corrupt(container, kind, tensor):
    """Applies a corruption to every string of tensor 0 (y) or 1 (z)."""
    packed = PackedTensors(container)
    raw = packed.unpack_raw()
    raw[tensor] = [CORRUPTIONS[kind](s) for s in raw[tensor]]
    out = PackedTensors()
    out.model = packed.model
    out.pack([t if isinstance(t, list) else t.astype(np.int32) for t in raw])
    return out.string


def _raises(fn):
    try:
        fn()
    except ValueError:
        return True
    return False


@pytest.mark.parametrize("kind", sorted(CORRUPTIONS))
@pytest.mark.parametrize("container", ["classic", "native"])
def test_corrupt_container_same_verdict(codecs, container, kind):
    """The sanity check is the reference's weak one, so only some
    corruptions of the y streams are caught -- but the two packages catch
    the same ones, and unread trailing bytes, in the y or the z streams,
    always raise ValueError."""
    jc, _, carried, _ = codecs
    x = _image("64x64")
    y, z, indexes = _jax_latents(jc, x)
    make = _jax_classic if container == "classic" else _jax_native
    good = make(jc, x, y, z, indexes)
    bad = _corrupt(good, kind, 0)
    mine = _raises(lambda: carried.decompress(bad))
    assert mine == _raises(lambda: jc.decompress(bad))
    if kind == "extra_bytes":
        assert mine
        assert _raises(lambda: carried.decompress(_corrupt(good, kind, 1)))


@pytest.mark.parametrize("kind", ["wrong_model", "wrong_tensor_count"])
def test_foreign_container_raises(codecs, kind):
    _, own, _, _ = codecs
    packed = PackedTensors(own.compress(_image("64x64")))
    if kind == "wrong_model":
        packed.model = "bls2017"
        bad = packed.string
    else:
        out = PackedTensors()
        out.model = own.MODEL_ID
        out.pack(packed.unpack_raw()[:3])
        bad = out.string
    with pytest.raises(ValueError):
        own.decompress(bad)


def test_hostile_escape_positions_raise(codecs):
    _, own, _, _ = codecs
    packed = PackedTensors(own.compress_native(_image("64x64")))
    tensors = packed.unpack(["bytes", "bytes"] + [np.int32] * 7)
    tensors[5] = np.asarray([10 ** 6, 0], np.int32)
    tensors[6] = np.asarray([7], np.int32)
    bad = PackedTensors()
    bad.model = own.MODEL_ID
    bad.pack(tensors)
    with pytest.raises(ValueError):
        own.decompress(bad.string)


# -- golden fixtures ---------------------------------------------------------
def _strings(gold, prefix):
    nb = gold[f"{prefix}_nbytes"]
    buf = gold[f"{prefix}_bytes"].tobytes()
    out, off = [], 0
    for n in nb:
        out.append(buf[off:off + int(n)])
        off += int(n)
    return out


def _assert_pixels(codec, container, expect):
    """decompress == expect, except at pixels whose float value lies within
    BOUNDARY of a rounding boundary (reported by the assertion message of a
    failure, and counted by the return value)."""
    with torch.no_grad():
        y_hat, ok, x_hw = codec._decode_latent(codec._unpack(container))
        x_float = codec.model.decode(y_hat)[0, : x_hw[0], : x_hw[1]].numpy()
        out = codec.decompress(container)
    assert bool(ok.all())
    off = np.argwhere(out != expect)
    for p in off:
        p = tuple(p)
        margin = abs(x_float[p] - np.floor(x_float[p]) - 0.5)
        assert margin < BOUNDARY and abs(int(out[p]) - int(expect[p])) == 1, \
            f"pixel {p}: {out[p]} vs {expect[p]}, float {x_float[p]}"
    return len(off)


@pytest.fixture(scope="module")
def gold_small():
    gold = dict(np.load(os.path.join(GOLD_DIR, "golden_bmshj.npz")))
    model = bmshj2018.BMSHJ2018Model(num_filters=int(gold["num_filters"]),
                                     num_scales=int(gold["num_scales"]))
    model.load_state_dict(bmshj2018.params_from_tf(gold))
    return gold, bmshj2018.BMSHJ2018Codec(model, device="cpu")


def test_golden_tables_and_latents(gold_small):
    gold, codec = gold_small
    np.testing.assert_array_equal(codec.em.cdf, gold["cdf_y"])
    np.testing.assert_array_equal(codec.em.cdf_offset, gold["cdf_offset_y"])
    np.testing.assert_array_equal(codec.side_em.cdf, gold["cdf_z"])
    np.testing.assert_array_equal(codec.side_em.cdf_offset,
                                  gold["cdf_offset_z"])
    np.testing.assert_allclose(codec.side_em.quantization_offset.numpy(),
                               gold["qoffset_z"], atol=1e-4)
    with torch.no_grad():
        y, z, _, _ = codec._encode(torch.as_tensor(gold["x_test"]))
    np.testing.assert_allclose(y.numpy(), gold["y"], atol=3e-4)
    np.testing.assert_allclose(z.numpy(), gold["z"], atol=3e-4)


def test_golden_strings(gold_small):
    """compress(x_test) writes the reference's y and z strings; so do the
    entropy models fed the golden latents."""
    gold, codec = gold_small
    strings, side, x_shape, y_shape, z_shape = PackedTensors(
        codec.compress(gold["x_test"])).unpack(
            ["bytes", "bytes", np.int32, np.int32, np.int32])
    assert strings == _strings(gold, "y")
    assert side == _strings(gold, "z")
    assert tuple(x_shape) == gold["x_test"].shape[:2]
    assert tuple(y_shape) == gold["y"].shape[1:3]
    assert tuple(z_shape) == gold["z"].shape[1:3]
    with torch.no_grad():
        z = torch.tensor(gold["z"])
        assert codec.side_em.compress_to_strings(z) == _strings(gold, "z")
        indexes, _ = codec._y_params(codec.side_em.quantize(z),
                                     gold["y"].shape[1:3])
        assert codec.em.compress_to_strings(
            torch.tensor(gold["y"]), indexes) == _strings(gold, "y")


def test_golden_container_decodes(gold_small):
    """The reference's container decodes to its uint8 image.  One pixel,
    (24, 31, 1), has the float value 179.50005 here and 179.49998 in the
    JAX package (4.6e-5 from the boundary, inside the packages' float
    difference of 9.2e-5), so it may round the other way."""
    gold, codec = gold_small
    off = _assert_pixels(codec, gold["container"].tobytes(),
                         gold["x_hat_uint8"])
    assert off <= 1
    native = codec.compress_native(gold["x_test"])
    assert _assert_pixels(codec, native, gold["x_hat_uint8"]) <= 1
    np.testing.assert_array_equal(codec.decompress(native),
                                  codec.reconstruct(gold["x_test"]))


@pytest.fixture(scope="module")
def gold_full():
    """golden_bmshj_full.npz at 192 filters, its weights regenerated from
    tests/golden/synth_weights.py (numpy and hashlib only) and checked
    against the fixture's digests."""
    gold = dict(np.load(os.path.join(GOLD_DIR, "golden_bmshj_full.npz")))
    spec = importlib.util.spec_from_file_location(
        "synth_weights", os.path.join(GOLD_DIR, "synth_weights.py"))
    synth = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(synth)
    manifest = json.loads(gold["manifest"].tobytes().decode())
    tf_vars = {}
    for name, (shape, digest) in manifest.items():
        tf_vars[name] = synth.synth(name, shape)
        assert synth.digest(tf_vars[name]) == digest, name
    model = bmshj2018.BMSHJ2018Model(num_filters=int(gold["num_filters"]),
                                     num_scales=int(gold["num_scales"]))
    model.load_state_dict(bmshj2018.params_from_tf(tf_vars))
    return gold, bmshj2018.BMSHJ2018Codec(model, device="cpu")


def test_full_width_tables_exact(gold_full):
    gold, codec = gold_full
    assert codec.model.num_filters == 192
    np.testing.assert_array_equal(codec.em.cdf, gold["cdf_y"])
    np.testing.assert_array_equal(codec.em.cdf_offset, gold["cdf_offset_y"])
    np.testing.assert_array_equal(codec.side_em.cdf, gold["cdf_z"])
    np.testing.assert_array_equal(codec.side_em.cdf_offset,
                                  gold["cdf_offset_z"])


def test_full_width_latents_strings_and_container(gold_full):
    gold, codec = gold_full
    with torch.no_grad():
        y, z, _, _ = codec._encode(torch.as_tensor(gold["x_test"]))
    np.testing.assert_allclose(y.numpy(), gold["y"], atol=3e-4)
    np.testing.assert_allclose(z.numpy(), gold["z"], atol=3e-4)
    strings, side, *_ = PackedTensors(codec.compress(gold["x_test"])).unpack(
        ["bytes", "bytes", np.int32, np.int32, np.int32])
    assert strings == _strings(gold, "y")
    assert side == _strings(gold, "z")
    assert _assert_pixels(codec, gold["container"].tobytes(),
                          gold["x_hat_uint8"]) <= 2


def test_params_from_tf_accepts_plain_names(gold_small):
    gold, codec = gold_small
    plain = {k[len("var__"):].replace("__", "/"): v for k, v in gold.items()
             if k.startswith("var__")}
    state = bmshj2018.params_from_tf(plain)
    ref = codec.model.state_dict()
    assert sorted(state) == sorted(ref)
    for key, value in state.items():
        np.testing.assert_array_equal(value.numpy(), ref[key].cpu().numpy())


def test_seeded_init_is_reproducible():
    a = bmshj2018.BMSHJ2018Model(num_filters=8, seed=3).state_dict()
    b = bmshj2018.BMSHJ2018Model(num_filters=8, seed=3).state_dict()
    c = bmshj2018.BMSHJ2018Model(num_filters=8, seed=4).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert any(not torch.equal(a[k], c[k]) for k in a)
    assert "hyper_synthesis.layer_0.kernel" in a
    assert "hyper_analysis.layer_2.bias" not in a


def test_bmshj2018_default_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device resolves")
    model = bmshj2018.BMSHJ2018Model(num_filters=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bmshj2018.BMSHJ2018Codec(model)
