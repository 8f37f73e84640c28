"""The port's ms2020 serving path against the JAX package and the
reference's golden fixtures, on the CPU (``device="cpu"``).

(a) Two configurations with parameters from a JAX ``MS2020Model.init``
carried over by ``params_from_jax``: the JAX tests' tiny model
(tests/test_ms2020.py), and a compact one whose output layers are
stretched (analysis, hyper analysis, hyper syntheses and slice
predictors scaled up) so that z is non-zero, mu and sigma span the scale
table and the latents escape the tables.  (b) golden_ms2020.npz (the
reference's briefly trained weights at compact widths) and (c)
golden_ms2020_full.npz (the published widths, 192 filters, latent 320,
10 slices; weights regenerated by tests/golden/synth_weights.py), both
through ``params_from_tf``.

Tolerances: latents and the slice loop's sub-graphs (hyper decode, mu,
sigma, LRP) within 2e-5 of the JAX package's on the same inputs, times
the output's largest magnitude where that exceeds 1 (the stretched
layers scale the float error with the values); against the goldens the
JAX tests' own bounds (y within 2e-5 and z within 5e-5 of the reference's,
both within 3e-4 at the published widths).  Tables, strings, containers,
quantized symbols and decoded latents are exact.  A decoded pixel may
differ from the JAX package's by one only where the two float images
round differently: the float images agree within 2e-6 of their largest
magnitude (the stretched model drives them to ~4e4 before the clamp), and
within 2e-4 in the tiny model.  Byte comparisons across the packages feed
both the same y, mu and sigma: a one-ulp difference in mu can move a
rounding and the coder with it.

The full-width fixture's classic container holds one stream of 768
symbols for z and one of 2048 for each slice, which the kernels' plain
versions code in ~25 s on the CPU.
"""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from compression_tpu.models import ms2020 as jax_ms2020
from compression_tpu.models import native_format as jax_nf
from compression_tpu_torch.codec import torch_coder
from compression_tpu_torch.models import ms2020
from compression_tpu_torch.models import native_format
from compression_tpu_torch.util.packed_tensors import PackedTensors

torch.set_num_threads(1)

GOLD_DIR = os.path.join(os.path.dirname(__file__), "golden")
ATOL = 2e-5

CONFIGS = {
    # tests/test_ms2020.py's tiny_model().
    "tiny": dict(lmbda=0.01, num_filters=8, latent_depth=8,
                 hyperprior_depth=4, num_slices=4, max_support_slices=2,
                 num_scales=8, scale_min=0.11, scale_max=32.0),
    "compact": dict(num_filters=16, latent_depth=20, hyperprior_depth=8,
                    num_slices=5, max_support_slices=3, num_scales=16,
                    ha_widths=(24, 16), hs_widths=(12, 16, 20),
                    slice_widths=(16, 12)),
}
# Output layers scaled in the compact configuration: (part, factor).
STRETCH = [("analysis", 40.0), ("hyper_analysis", 10.0),
           ("hyper_synthesis_mean", 4.0), ("hyper_synthesis_scale", 4.0)]
SLICE_STRETCH = {"cc_mean": 8.0, "cc_scale": 20.0, "lrp": 1.0}
SHAPES = {"64x64": (64, 64, 3), "80x72": (80, 72, 3)}


def _stretch(params, cfg):
    """Scales the last layer of each transform of a numpy param tree."""
    tree = params["params"]

    def scale(part, factor):
        last = sorted(k for k in tree[part] if k.startswith("layer_"))[-1]
        tree[part][last] = {k: v * np.float32(factor)
                            for k, v in tree[part][last].items()}

    for part, factor in STRETCH:
        scale(part, factor)
    for i in range(cfg["num_slices"]):
        for group, factor in SLICE_STRETCH.items():
            scale(f"{group}_{i}", factor)
    return params


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def pair(request):
    """(JAX codec, the port's codec on its own tables, JAX params)."""
    cfg = CONFIGS[request.param]
    jm = jax_ms2020.MS2020Model(**cfg)
    # One compiled init: the eager one dispatches op by op (~3x longer).
    params = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda key, x: jm.init(key, x, training=False))(
            jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))))
    if request.param == "compact":
        params = _stretch(params, cfg)
    model = ms2020.MS2020Model(**cfg)
    model.load_state_dict(ms2020.params_from_jax(params))
    return (jax_ms2020.MS2020Codec(jm, params),
            ms2020.MS2020Codec(model, device="cpu"), params)


def _image(name):
    return np.random.RandomState(sorted(SHAPES).index(name)).randint(
        0, 256, SHAPES[name]).astype(np.uint8)


def _assert_close(mine, ref):
    """Within ATOL times the largest magnitude of ``ref`` (at least 1)."""
    ref = np.asarray(ref)
    tol = ATOL * max(1.0, float(np.abs(ref).max(initial=0.0)))
    np.testing.assert_allclose(np.asarray(mine), ref, rtol=0, atol=tol)


def _jax_loop(jc, x):
    """The JAX package's y, z, z_hat, hyper outputs and per-slice
    (y_slice, mu, sigma, mean_support, y_hat_slice, lrp), quantizing."""
    params = jc.params
    y, z = jc._encode(params, jnp.asarray(x)[None])
    z_hat = jc.em_z.quantize(z)
    scales, means = jc._hyper_decode(params, z_hat)
    y_hw = tuple(int(s) for s in y.shape[1:3])
    hats, slices = [], []
    for i, y_slice in enumerate(jnp.split(y, jc.model.num_slices, axis=-1)):
        support = tuple(hats[: jc.model.max_support_slices])
        mu, sigma, mean_support = jc._slice_params(
            params, i, means, scales, support, y_hw)
        y_hat = jc.em_y.quantize(y_slice, mu)
        lrp = jc._lrp(params, i, mean_support, y_hat)
        slices.append(tuple(np.asarray(a) for a in (
            y_slice, mu, sigma, mean_support, y_hat, lrp)) + (support,))
        hats.append(y_hat + lrp)
    return (np.asarray(y), np.asarray(z), np.asarray(z_hat),
            np.asarray(scales), np.asarray(means), slices)


# -- (a) against the JAX package -------------------------------------------------
def test_tables_equal_jax(pair):
    jc, pc, _ = pair
    for mine, ref in ((pc.em_y, jc.em_y), (pc.em_z, jc.em_z)):
        np.testing.assert_array_equal(mine.cdf, np.asarray(ref.cdf))
        np.testing.assert_array_equal(mine.cdf_offset,
                                      np.asarray(ref.cdf_offset))
    assert pc.em_z.quantization_offset is None


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_subgraphs_match_jax(pair, name):
    """encode, hyper_decode, slice_params and lrp, each on the JAX
    package's inputs, within ATOL of its outputs."""
    jc, pc, _ = pair
    x = _image(name)
    y, z, z_hat, scales, means, slices = _jax_loop(jc, x)
    m = pc.model
    with torch.no_grad():
        my, mz = pc._encode(pc._upload(x))
        ms, mm = m.hyper_decode(torch.tensor(z_hat))
    for mine, ref in ((my, y), (mz, z), (ms, scales), (mm, means)):
        _assert_close(mine, ref)
    y_hw = y.shape[1:3]
    for i, (_, mu, sigma, mean_support, y_hat, lrp, support) in enumerate(
            slices):
        with torch.no_grad():
            m_mu, m_sigma, m_support = m.slice_params(
                i, torch.tensor(means), torch.tensor(scales),
                [torch.tensor(np.asarray(s)) for s in support], y_hw)
            m_lrp = m.lrp(i, torch.tensor(mean_support), torch.tensor(y_hat))
        for mine, ref in ((m_mu, mu), (m_sigma, sigma),
                          (m_support, mean_support), (m_lrp, lrp)):
            assert mine.shape == ref.shape
            _assert_close(mine, ref)


@pytest.mark.parametrize("scale", [1.0, 6.0])
def test_entropy_model_bytes_equal_jax(pair, scale):
    """Both packages' entropy models fed the same z and, slice by slice,
    the same y, mu and sigma: equal reference-format strings and equal
    native (sidecar) streams and escapes; scale 6 pushes the latents past
    the tables."""
    jc, pc, _ = pair
    y, z, _, _, _, slices = _jax_loop(jc, _image("64x64"))
    z = scale * z
    assert pc.em_z.compress_to_strings(torch.tensor(z)) == \
        jc.em_z.compress_to_strings(jnp.asarray(z))
    zb, zl, zi, zv = jc.em_z.compress_sidecar(jax_nf.to_streams(z))
    mine = pc.em_z.compress_sidecar_device(
        native_format.to_streams(torch.tensor(z)))
    _assert_sidecar_equal(mine, (zb, zl, zi, zv), z.shape)
    escapes = 0
    for y_slice, mu, sigma, *_ in slices:
        y_slice = scale * y_slice
        t = [torch.tensor(a) for a in (y_slice, sigma, mu)]
        ref = jc.em_y.compress_to_strings(*(jnp.asarray(a) for a in (
            y_slice, sigma)), loc=jnp.asarray(mu))
        assert pc.em_y.compress_to_strings(t[0], t[1], loc=t[2]) == ref
        rows = [jax_nf.to_streams(a) for a in (y_slice, sigma, mu)]
        jb, jl, ji, jv = jc.em_y.compress_sidecar(rows[0], rows[1],
                                                  loc=rows[2])
        mine = pc.em_y.compress_sidecar_device(
            *(native_format.to_streams(a) for a in t[:2]),
            loc=native_format.to_streams(t[2]))
        _assert_sidecar_equal(mine, (jb, jl, ji, jv), y_slice.shape)
        escapes += len(jv)
    assert escapes > 0 or scale == 1.0


def _assert_sidecar_equal(mine, ref, shape):
    """Port (buf, lens, flat esc_idx, esc_val) against JAX (buf, lens,
    (stream, element) pairs, values)."""
    buf, lens, esc_idx, esc_val = (np.asarray(a) for a in mine)
    jb, jl, jp, jv = (np.asarray(a) for a in ref)
    np.testing.assert_array_equal(lens.reshape(-1), jl.reshape(-1))
    assert torch_coder.to_bytes_list(buf.reshape(len(jl.reshape(-1)), -1),
                                     lens.reshape(-1)) == \
        torch_coder.to_bytes_list(jb.reshape(len(jl.reshape(-1)), -1),
                                  jl.reshape(-1))
    _, h, w, c = shape
    n = (w // native_format.split_factor(w, c)) * c
    pairs, vals = native_format.esc_to_pairs(esc_idx, esc_val, n)
    np.testing.assert_array_equal(pairs, jp.reshape(-1, 2))
    np.testing.assert_array_equal(vals, jv)


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_round_trips_equal_reconstruct(pair, name):
    """decompress(compress(x)) and decompress(compress_native(x)) equal
    reconstruct(x) exactly (80x72 is no multiple of 64)."""
    _, pc, _ = pair
    x = _image(name)
    expect = pc.reconstruct(x)
    assert expect.shape == x.shape and expect.dtype == np.uint8
    classic, native = pc.compress(x), pc.compress_native(x)
    ns = pc.model.num_slices
    assert PackedTensors(classic).num_tensors == 4 + ns
    assert PackedTensors(native).num_tensors == 6 + 3 * ns
    assert PackedTensors(native).model == "ms2020"
    np.testing.assert_array_equal(pc.decompress(classic), expect)
    assert torch_coder.DISPATCH_LOG["decode"] == "plain-gamma"
    np.testing.assert_array_equal(pc.decompress(native), expect)
    assert torch_coder.DISPATCH_LOG["decode_sidecar"] == "plain-indexed"


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_reconstruct_matches_jax(pair, name):
    """The port's reconstruct against the JAX package's: every slice's
    quantized symbols round(y - mu) equal, the float images within 2e-6 of
    their largest magnitude (2e-4 where that is at most 100), and a pixel
    differs only by one, where the two float images round differently."""
    jc, pc, _ = pair
    x = _image(name)
    y, _, _, _, _, slices = _jax_loop(jc, x)
    ref_hat = np.concatenate([s[4] + s[5] for s in slices], axis=-1)
    ref_float = np.asarray(jc._decode(jc.params, jnp.asarray(ref_hat)))[
        0, : x.shape[0], : x.shape[1]]
    symbols = []
    with torch.no_grad():
        my, mz = pc._encode(pc._upload(x))
        y_slices = pc._slices(my)

        def code(i, mu, sigma):
            symbols.append(torch.round(y_slices[i] - mu).numpy())
            return pc.em_y.quantize(y_slices[i], mu)

        y_hat = pc.model.slice_loop(pc.em_z.quantize(mz),
                                    tuple(my.shape[1:3]), code)
        x_float = pc.model.decode(y_hat)[0, : x.shape[0], : x.shape[1]]
    for mine, (y_slice, mu, *_) in zip(symbols, slices):
        np.testing.assert_array_equal(mine, np.round(y_slice - mu))
    x_float = x_float.numpy()
    scale = float(np.abs(ref_float).max())
    tol = 2e-4 if scale <= 100 else 2e-6 * scale
    np.testing.assert_allclose(x_float, ref_float, rtol=0, atol=tol)
    out, ref = pc.reconstruct(x), jc.reconstruct(x)
    off = out != ref
    np.testing.assert_array_equal(
        off, np.clip(np.round(x_float), 0, 255) != np.clip(
            np.round(ref_float), 0, 255))
    assert np.abs(out.astype(int) - ref.astype(int)).max(initial=0) <= 1


def test_many_equal_single(pair):
    _, pc, _ = pair
    images = [_image(n) for n in sorted(SHAPES)] + [_image("64x64")[:48]]
    singles = [pc.compress_native(x) for x in images]
    assert pc.compress_native_many(images) == singles
    mixed = singles + [pc.compress(images[0])]
    for out, c in zip(pc.decompress_native_many(mixed), mixed):
        np.testing.assert_array_equal(out, pc.decompress(c))


def _rewrite(container, tensor, edit):
    packed = PackedTensors(container)
    raw = packed.unpack_raw()
    raw[tensor] = edit(raw[tensor])
    out = PackedTensors()
    out.model = packed.model
    out.pack([t if isinstance(t, list) else t.astype(np.int32)
              for t in raw])
    return out.string


@pytest.mark.parametrize("part", ["z", "slice_0", "slice_last"])
@pytest.mark.parametrize("kind", ["classic", "native"])
def test_corrupt_stream_raises(pair, kind, part):
    """Unread trailing bytes in z's or a slice's streams fail the sanity
    check."""
    _, pc, _ = pair
    x = _image("64x64")
    ns = pc.model.num_slices
    if kind == "classic":
        container = pc.compress(x)
        tensor = {"z": 3, "slice_0": 4, "slice_last": 3 + ns}[part]
    else:
        container = pc.compress_native(x)
        tensor = {"z": 3, "slice_0": 6, "slice_last": 3 + 3 * ns}[part]
    bad = _rewrite(container, tensor,
                   lambda strs: [s + b"\x12\x34" for s in strs])
    with pytest.raises(ValueError, match="Sanity"):
        pc.decompress(bad)


@pytest.mark.parametrize("kind", ["wrong_model", "wrong_tensor_count",
                                  "hostile_escape", "two_streams"])
def test_foreign_container_raises(pair, kind):
    _, pc, _ = pair
    x = _image("64x64")
    if kind == "wrong_model":
        packed = PackedTensors(pc.compress(x))
        packed.model = "bmshj2018"
        bad = packed.string
    elif kind == "wrong_tensor_count":
        packed = PackedTensors(pc.compress(x))
        out = PackedTensors()
        out.model = pc.MODEL_ID
        out.pack(packed.unpack_raw()[:5])
        bad = out.string
    elif kind == "hostile_escape":
        bad = _rewrite(pc.compress_native(x), 7,
                       lambda _: np.asarray([10 ** 6, 0], np.int32))
        bad = _rewrite(bad, 8, lambda _: np.asarray([7], np.int32))
    else:
        bad = _rewrite(pc.compress(x), 4, lambda strs: strs * 2)
    with pytest.raises(ValueError):
        pc.decompress(bad)


def test_carried_tables(pair):
    """Tables carried from the JAX entropy models code the same."""
    jc, pc, _ = pair
    carried = ms2020.MS2020Codec(
        pc.model, device="cpu",
        tables=(jc.em_y.get_weights(), jc.em_z.get_weights()))
    x = _image("64x64")
    assert carried.compress_native(x) == pc.compress_native(x)


# -- (b), (c) the reference's goldens ------------------------------------------
def _strings(gold, prefix):
    nb = gold[f"{prefix}_nbytes"]
    buf = gold[f"{prefix}_bytes"].tobytes()
    out, off = [], 0
    for n in nb:
        out.append(buf[off:off + int(n)])
        off += int(n)
    return out


def _golden_model(gold, tf_vars):
    model = ms2020.MS2020Model(
        num_filters=int(gold["num_filters"]),
        latent_depth=int(gold["latent_depth"]),
        hyperprior_depth=int(gold["hyperprior_depth"]),
        num_slices=int(gold["num_slices"]),
        max_support_slices=int(gold["max_support_slices"]),
        num_scales=int(gold["num_scales"]),
        ha_widths=tuple(int(w) for w in gold["ha_widths"]),
        hs_widths=tuple(int(w) for w in gold["hs_widths"]),
        slice_widths=tuple(int(w) for w in gold["slice_widths"]))
    model.load_state_dict(ms2020.params_from_tf(tf_vars))
    return ms2020.MS2020Codec(model, device="cpu")


def _synthesized(gold):
    """golden_ms2020_full.npz's weights, regenerated from their names by
    tests/golden/synth_weights.py and checked against its digests."""
    spec = importlib.util.spec_from_file_location(
        "synth_weights", os.path.join(GOLD_DIR, "synth_weights.py"))
    synth = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(synth)
    manifest = json.loads(gold["manifest"].tobytes().decode())
    tf_vars = {}
    for name, (shape, digest) in manifest.items():
        tf_vars[name] = synth.synth(name, shape)
        assert synth.digest(tf_vars[name]) == digest, name
    return tf_vars


@pytest.fixture(scope="module", params=["golden_ms2020.npz",
                                        "golden_ms2020_full.npz"])
def golden(request):
    """(fixture, its codec, latent tolerance)."""
    gold = dict(np.load(os.path.join(GOLD_DIR, request.param)))
    full = "manifest" in gold
    codec = _golden_model(gold, _synthesized(gold) if full else gold)
    return gold, codec, (3e-4, 3e-4) if full else (ATOL, 5e-5)


def test_golden_latents(golden):
    gold, codec, (tol_y, tol_z) = golden
    with torch.no_grad():
        y, z = codec._encode(codec._upload(gold["x_test"]))
    np.testing.assert_allclose(y.numpy(), gold["y"], rtol=0, atol=tol_y)
    np.testing.assert_allclose(z.numpy(), gold["z"], rtol=0, atol=tol_z)


def test_golden_tables_exact(golden):
    gold, codec, _ = golden
    np.testing.assert_array_equal(codec.em_y.cdf, gold["cdf_y"])
    np.testing.assert_array_equal(codec.em_y.cdf_offset, gold["cdf_offset_y"])
    np.testing.assert_array_equal(codec.em_z.cdf, gold["cdf_z"])
    np.testing.assert_array_equal(codec.em_z.cdf_offset, gold["cdf_offset_z"])


def test_golden_strings(golden):
    """compress writes the reference's z string and per-slice y strings
    through the slice loop."""
    gold, codec, _ = golden
    ns = int(gold["num_slices"])
    fields = PackedTensors(codec.compress(gold["x_test"])).unpack(
        [np.int32] * 3 + ["bytes"] * (1 + ns))
    assert tuple(fields[0]) == gold["x_test"].shape[:2]
    assert tuple(fields[1]) == gold["y"].shape[1:3]
    assert tuple(fields[2]) == gold["z"].shape[1:3]
    assert fields[3] == _strings(gold, "z")
    assert [f[0] for f in fields[4:]] == _strings(gold, "y")


def test_golden_container_decodes(golden):
    gold, codec, _ = golden
    x_hat = codec.decompress(gold["container"].tobytes())
    np.testing.assert_array_equal(x_hat, gold["x_hat_uint8"])


def test_golden_native_container(golden):
    """The native container decodes to the reference's image too, and
    equals reconstruct."""
    gold, codec, _ = golden
    native = codec.compress_native(gold["x_test"])
    x_hat = codec.decompress(native)
    np.testing.assert_array_equal(x_hat, gold["x_hat_uint8"])
    np.testing.assert_array_equal(x_hat, codec.reconstruct(gold["x_test"]))


def test_golden_full_is_published_width(golden):
    gold, codec, _ = golden
    m = codec.model
    if "manifest" not in gold:
        assert m.num_slices == int(gold["num_slices"])
        return
    assert (m.num_filters, m.latent_depth, m.hyperprior_depth, m.num_slices,
            m.max_support_slices, m.num_scales) == (192, 320, 192, 10, 5, 64)
    manifest = json.loads(gold["manifest"].tobytes().decode())
    count = sum(int(np.prod(s)) for s, _ in manifest.values())
    assert sum(p.numel() for p in m.parameters()) == count
    assert count > 90_000_000


def test_params_from_tf_accepts_plain_names():
    gold = dict(np.load(os.path.join(GOLD_DIR, "golden_ms2020.npz")))
    plain = {k[len("var__"):].replace("__", "/"): v for k, v in gold.items()
             if k.startswith("var__")}
    a, b = ms2020.params_from_tf(plain), ms2020.params_from_tf(gold)
    assert sorted(a) == sorted(b)
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_seeded_init_is_reproducible():
    cfg = CONFIGS["compact"]
    a = ms2020.MS2020Model(**cfg, seed=3).state_dict()
    b = ms2020.MS2020Model(**cfg, seed=3).state_dict()
    c = ms2020.MS2020Model(**cfg, seed=4).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert any(not torch.equal(a[k], c[k]) for k in a)
    assert "cc_mean_4.layer_0.kernel" in a
    assert a["lrp_4.layer_0.kernel"].shape == (5, 5, 20 + 4 * 3 + 4, 16)
    assert "hyper_analysis.layer_2.bias" not in a


def test_ms2020_default_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device resolves")
    model = ms2020.MS2020Model(**CONFIGS["tiny"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ms2020.MS2020Codec(model)
