"""The port's bls2017 against the briefly trained reference model of
tests/golden/golden_model.npz (TF weights, latents, tables, strings, the
reference .tfci container and its uint8 reconstruction), with the weights
loaded two ways: tools/port_tf_weights.port_bls2017 then params_from_jax,
and params_from_tf.  The interop contract, as tests/test_golden_model.py
holds the JAX package to it: byte-identical strings, and the reference
container decoding to the reference's exact uint8 image."""

import os
import sys

import jax
import numpy as np
import pytest
import torch

from compression_tpu.models import bls2017 as jax_bls2017
from compression_tpu_torch.codec import torch_coder
from compression_tpu_torch.models import bls2017
from compression_tpu_torch.util.packed_tensors import PackedTensors

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from tools.port_tf_weights import port_bls2017  # noqa: E402

torch.set_num_threads(1)

FIXTURE = os.path.join(os.path.dirname(__file__), "golden",
                       "golden_model.npz")
LOADERS = ["params_from_jax", "params_from_tf"]


@pytest.fixture(scope="module")
def gold():
    return dict(np.load(FIXTURE))


def _tf_vars(gold):
    return {k[len("var__"):].replace("__", "/"): v
            for k, v in gold.items() if k.startswith("var__")}


@pytest.fixture(scope="module")
def states(gold):
    jax_params = jax.tree_util.tree_map(np.asarray,
                                        port_bls2017(_tf_vars(gold)))
    return {"params_from_jax": bls2017.params_from_jax(jax_params),
            "params_from_tf": bls2017.params_from_tf(gold)}


@pytest.fixture(scope="module")
def codecs(gold, states):
    out = {}
    for name, state in states.items():
        model = bls2017.BLS2017Model(num_filters=int(gold["num_filters"]))
        model.load_state_dict(state)
        out[name] = bls2017.BLS2017Codec(model, device="cpu")
    return out


def _ref_strings(gold):
    buf, out, off = gold["strings_bytes"].tobytes(), [], 0
    for n in gold["strings_nbytes"]:
        out.append(buf[off: off + int(n)])
        off += int(n)
    return out


def test_loaders_agree(gold, states):
    """params_from_tf gives the state of port_bls2017 + params_from_jax,
    from the npz's keys and from TF's own names alike."""
    a, b = states["params_from_jax"], states["params_from_tf"]
    assert a.keys() == b.keys()
    for key in a:
        assert torch.equal(a[key], b[key]), key
    c = bls2017.params_from_tf(_tf_vars(gold))
    assert all(torch.equal(c[key], b[key]) for key in b)


@pytest.mark.parametrize("loader", LOADERS)
def test_tables_and_latents(gold, codecs, loader):
    """Own tables equal the reference's exactly; the quantization offset
    within 2e-4 and the latents within 5e-5, the JAX package's own
    tolerances (tests/test_golden_model.py)."""
    codec = codecs[loader]
    np.testing.assert_array_equal(codec.em.cdf, gold["cdf"])
    np.testing.assert_array_equal(codec.em.cdf_offset, gold["cdf_offset"])
    np.testing.assert_allclose(codec.em.quantization_offset.numpy(),
                               gold["qoffset"], rtol=0, atol=2e-4)
    with torch.no_grad():
        y = codec._analysis(codec._upload(gold["x_test"])).numpy()
    np.testing.assert_allclose(y, gold["y"], rtol=0, atol=5e-5)


@pytest.mark.parametrize("loader", LOADERS)
def test_strings_from_golden_y(gold, codecs, loader):
    strings = codecs[loader].em.compress_to_strings(
        torch.as_tensor(gold["y"]))
    assert strings == _ref_strings(gold)


@pytest.mark.parametrize("loader", LOADERS)
def test_compress_strings_byte_identical(gold, codecs, loader):
    """compress(x_test) writes the reference's strings and shapes."""
    packed = PackedTensors(codecs[loader].compress(gold["x_test"]))
    strings, x_shape, y_shape = packed.unpack(["bytes", np.int32, np.int32])
    ref = PackedTensors(gold["container"].tobytes())
    rs, rx, ry = ref.unpack(["bytes", np.int32, np.int32])
    assert packed.model == ref.model == "bls2017"
    assert strings == rs == _ref_strings(gold)
    np.testing.assert_array_equal(x_shape, rx)
    np.testing.assert_array_equal(y_shape, ry)


@pytest.mark.parametrize("loader", LOADERS)
def test_decode_reference_container(gold, codecs, loader):
    """The reference's .tfci container decodes to its exact uint8
    reconstruction, through the in-stream-gamma decode."""
    x_hat = codecs[loader].decompress(gold["container"].tobytes())
    assert torch_coder.DISPATCH_LOG["decode"] == "plain-gamma"
    np.testing.assert_array_equal(x_hat, gold["x_hat_uint8"])


def test_classic_containers_cross_decode(gold, codecs):
    """The JAX package, given the same weights, decodes the port's classic
    container from the golden latent, and the port decodes the JAX
    package's, both to the reference's uint8 image."""
    codec = codecs["params_from_tf"]
    jm = jax_bls2017.BLS2017Model(num_filters=int(gold["num_filters"]))
    jc = jax_bls2017.BLS2017Codec(jm, port_bls2017(_tf_vars(gold)))
    packed = PackedTensors()
    packed.model = "bls2017"
    packed.pack([codec.em.compress_to_strings(torch.as_tensor(gold["y"])),
                 np.asarray(gold["x_test"].shape[:2], np.int32),
                 np.asarray(gold["y"].shape[1:3], np.int32)])
    np.testing.assert_array_equal(np.asarray(jc.decompress(packed.string)),
                                  gold["x_hat_uint8"])
    np.testing.assert_array_equal(codec.decompress(jc.compress(
        gold["x_test"])), gold["x_hat_uint8"])


@pytest.mark.parametrize("loader", LOADERS)
def test_synthesis_float_margin(gold, codecs, loader):
    """The exact uint8 match above rests on a float margin: the reference's
    x_hat_float has its closest value 1.03e-4 from a rounding boundary, and
    the port's synthesis of the reference y_hat stays within 1e-4 of it in
    float32 on the CPU (9.2e-5 measured)."""
    margin = np.abs(np.abs(gold["x_hat_float"] % 1.0) - 0.5).min()
    assert margin > 1e-4
    with torch.no_grad():
        x_hat = codecs[loader].model.synthesis(torch.as_tensor(gold["y_hat"]))
    np.testing.assert_allclose(x_hat[0, :64, :64].numpy(),
                               gold["x_hat_float"], rtol=0, atol=1e-4)
