"""The port's HiFiC serving path against the JAX package, on the CPU
(``device="cpu"``).

Two configurations with parameters from a JAX ``HiFiCModel.init`` carried
over by ``params_from_jax``: the JAX tests' tiny model (tests/test_hific.py,
two downsamplings), and a compact one at the published depth (four
downsamplings, two residual blocks) whose output layers are stretched
(the encoder's bottleneck conv, the hyper analysis and both hyper
syntheses scaled up) so that z is non-zero, the scale indexes span the
table and the latents escape it.  Images of 64x64 and 72x88; at 72x88 the
stride-2 convolutions of the compact encoder see odd inputs (9, 5), and
its hyper analysis 5x6.

Tolerances: flax's Conv and ConvTranspose against the port's within 1e-5
of the output's largest magnitude; ChannelNorm and its input gradient
within 1e-5; the latents and the sub-graphs (encode, hyper_decode,
scale_indexes, decode) within 2e-5 of the JAX package's on the same
inputs, times the output's largest magnitude where that exceeds 1 (the
stretched layers scale the float error with the values).  Tables,
strings, containers and decoded latents are exact; byte comparisons
across the packages feed both the same y, scale indexes and means (a
one-ulp difference in a mean can move a rounding and the coder with it).
A reconstructed pixel may differ from the JAX package's by one only where
the two float images round differently.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
import flax.linen as fnn

from compression_tpu.models import hific as jax_hific
from compression_tpu.models import native_format as jax_nf
from compression_tpu_torch.codec import torch_coder
from compression_tpu_torch.models import hific
from compression_tpu_torch.models import native_format
from compression_tpu_torch.util.packed_tensors import PackedTensors

torch.set_num_threads(1)

ATOL = 2e-5

CONFIGS = {
    # tests/test_hific.py's tiny_cfg().
    "tiny": dict(num_down=2, num_filters_base=4, num_filters_bottleneck=8,
                 num_residual_blocks=2, hyper_filters=4),
    "compact": dict(num_down=4, num_filters_base=4,
                    num_filters_bottleneck=12, num_residual_blocks=2,
                    hyper_filters=8),
}
# Output layers scaled in the compact configuration: (part, factor).
STRETCH = [("encoder", 40.0), ("hyper_analysis", 10.0),
           ("hyper_synthesis_mean", 4.0), ("hyper_synthesis_scale", 20.0)]
SHAPES = {"64x64": (64, 64, 3), "72x88": (72, 88, 3)}


def _stretch(params, cfg):
    tree = params["params"]
    last = {"encoder": f"Conv_{cfg['num_down'] + 1}"}
    for part, factor in STRETCH:
        layer = last.get(part, "layer_2")
        tree[part][layer] = {k: v * np.float32(factor)
                             for k, v in tree[part][layer].items()}
    return params


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def pair(request):
    """(JAX codec, the port's codec on its own tables, JAX params)."""
    cfg = CONFIGS[request.param]
    jm = jax_hific.HiFiCModel(cfg=jax_hific.HiFiCConfig(**cfg))
    # One compiled init: the eager one dispatches op by op.
    params = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda key, x: jm.init(key, x, training=False))(
            jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))))
    if request.param == "compact":
        params = _stretch(params, cfg)
    model = hific.HiFiCModel(hific.HiFiCConfig(**cfg))
    model.load_state_dict(hific.params_from_jax(params))
    return (jax_hific.HiFiCCodec(jm, params),
            hific.HiFiCCodec(model, device="cpu"), params)


def _image(name):
    return np.random.RandomState(sorted(SHAPES).index(name)).randint(
        0, 256, SHAPES[name]).astype(np.uint8)


def _assert_close(mine, ref, atol=ATOL):
    """Within ``atol`` times the largest magnitude of ``ref`` (at least
    1)."""
    ref = np.asarray(ref)
    tol = atol * max(1.0, float(np.abs(ref).max(initial=0.0)))
    np.testing.assert_allclose(np.asarray(mine), ref, rtol=0, atol=tol)


def _jax_latents(jc, x):
    """The JAX package's y, z, z_hat, raw scales and means (cropped to y),
    scale indexes."""
    y, z = jc._encode(jc.params, jnp.asarray(x)[None])
    z_hat = jc.em_z.quantize(z)
    raw, means = jc._hyper_decode(jc.params, z_hat)
    h, w = y.shape[1:3]
    raw, means = raw[:, :h, :w], means[:, :h, :w]
    indexes = jc._scale_idx(jc.params, raw)
    return tuple(np.asarray(a) for a in (y, z, z_hat, raw, means, indexes))


# -- the layers ---------------------------------------------------------------
@pytest.mark.parametrize("n", [(6, 8), (9, 5), (16, 16)])
@pytest.mark.parametrize("kernel,stride", [(3, 2), (3, 1), (7, 1), (4, 2)])
def test_conv_matches_flax(n, kernel, stride):
    """hific.Conv (flax's "SAME" split, HWIO kernel) against nn.Conv with
    the same kernel and bias, on even and odd axes."""
    rng = np.random.RandomState(0)
    x = rng.normal(0, 1, (2,) + n + (5,)).astype(np.float32)
    kern = rng.normal(0, 1, (kernel, kernel, 5, 3)).astype(np.float32)
    bias = rng.normal(0, 1, (3,)).astype(np.float32)
    ref = fnn.Conv(3, (kernel, kernel), strides=(stride, stride),
                   padding="SAME").apply(
        {"params": {"kernel": kern, "bias": bias}}, jnp.asarray(x))
    conv = hific.Conv(5, 3, kernel, stride)
    conv.load_state_dict({"kernel": torch.tensor(kern),
                          "bias": torch.tensor(bias)})
    with torch.no_grad():
        out = conv(torch.tensor(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert out.shape == ref.shape
    _assert_close(out, ref, 1e-5)


def test_same_pads_is_asymmetric_on_even_axes():
    assert hific.same_pads(8, 3, 2) == (0, 1)
    assert hific.same_pads(9, 3, 2) == (1, 1)
    assert hific.same_pads(8, 7, 1) == (3, 3)
    assert hific.same_pads(1, 3, 2) == (1, 1)


@pytest.mark.parametrize("n", [(3, 4), (5, 5), (1, 2)])
def test_conv_transpose_matches_flax(n):
    """hific.ConvTranspose against nn.ConvTranspose((3, 3), strides 2,
    "SAME") with the same kernel and bias: an output twice the input."""
    rng = np.random.RandomState(1)
    x = rng.normal(0, 1, (2,) + n + (6,)).astype(np.float32)
    kern = rng.normal(0, 1, (3, 3, 6, 4)).astype(np.float32)
    bias = rng.normal(0, 1, (4,)).astype(np.float32)
    ref = fnn.ConvTranspose(4, (3, 3), strides=(2, 2), padding="SAME").apply(
        {"params": {"kernel": kern, "bias": bias}}, jnp.asarray(x))
    conv = hific.ConvTranspose(6, 4, 3, 2)
    conv.load_state_dict({"kernel": torch.tensor(kern),
                          "bias": torch.tensor(bias)})
    with torch.no_grad():
        out = conv(torch.tensor(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert out.shape == ref.shape == (2, 2 * n[0], 2 * n[1], 4)
    _assert_close(out, ref, 1e-5)


def test_channel_norm_matches_jax():
    """Values and the input's gradient (the mean inside the variance
    carries none) within 1e-5 of the JAX package's ChannelNorm."""
    rng = np.random.RandomState(2)
    x = rng.normal(1, 3, (2, 5, 6, 7)).astype(np.float32)
    gamma = rng.normal(1, 0.5, (7,)).astype(np.float32)
    beta = rng.normal(0, 0.5, (7,)).astype(np.float32)
    w = rng.normal(0, 1, x.shape).astype(np.float32)
    variables = {"params": {"gamma": gamma, "beta": beta}}

    def jax_loss(v):
        return jnp.sum(w * jax_hific.ChannelNorm().apply(variables, v))

    ref_out = jax_hific.ChannelNorm().apply(variables, jnp.asarray(x))
    ref_grad = jax.grad(jax_loss)(jnp.asarray(x))
    norm = hific.ChannelNorm(7)
    norm.load_state_dict({"gamma": torch.tensor(gamma),
                          "beta": torch.tensor(beta)})
    tx = torch.tensor(x).permute(0, 3, 1, 2).requires_grad_()
    out = norm(tx)
    torch.sum(torch.tensor(w).permute(0, 3, 1, 2) * out).backward()
    _assert_close(out.detach().permute(0, 2, 3, 1), ref_out, 1e-5)
    _assert_close(tx.grad.permute(0, 2, 3, 1), ref_grad, 1e-5)


def _grads(module, x, w, fn):
    """fn(x)'s value and the gradients of sum(w * fn(x)) by the input and
    by ``module``'s kernel and bias."""
    module.zero_grad()
    xi = x.clone().requires_grad_()
    out = fn(xi)
    torch.sum(w * out).backward()
    return out.detach(), xi.grad, module.kernel.grad.clone(), \
        module.bias.grad.clone()


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("grid", [(4, 6), (5, 3)])
@pytest.mark.parametrize("cin", [960, 220])
def test_trunk_gemm_matches_conv(cin, grid, batch):
    """Conv.gemm (the generator trunk's path: NHWC patches times the HWIO
    kernel) against Conv.forward at the published widths (960 -> 960 in
    the blocks, 220 -> 960 in Conv_0), on even and odd grids: the output
    and the gradients of input, kernel and bias within 1e-5 of their
    largest magnitude."""
    torch.manual_seed(cin + grid[0] + batch)
    conv = hific.Conv(cin, 960, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        conv.bias.normal_()
    x = torch.randn((batch,) + grid + (cin,))
    w = torch.randn((batch,) + grid + (960,))
    before = hific.GEMM_CONVS
    mine = _grads(conv, x, w, conv.gemm)
    assert hific.GEMM_CONVS - before == 1
    ref = _grads(conv, x, w, lambda xi: conv(xi.permute(0, 3, 1, 2)).permute(
        0, 2, 3, 1))
    assert mine[0].shape == (batch,) + grid + (960,)
    for got, want in zip(mine, ref):
        _assert_close(got, want, 1e-5)


@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("grid", [(4, 6), (5, 3)])
@pytest.mark.parametrize("cin,cout", [(960, 480), (480, 240), (240, 120),
                                      (120, 60)])
def test_upsampling_overlap_add_matches_conv_transpose(cin, cout, grid,
                                                        batch):
    """ConvTranspose (the generator's upsampling path: one matrix product
    and F.fold's overlap-add) against torch's transposed convolution of the
    flipped kernel, its first 2 H x 2 W outputs kept, at the published
    widths on even and odd grids: the output and the gradients of input,
    kernel and bias within 1e-5 of their largest magnitude; one count of
    GEMM_UPSAMPLES a call."""
    torch.manual_seed(cin + grid[0] + batch)
    conv = hific.ConvTranspose(cin, cout, 3, 2,
                               generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        conv.bias.normal_()
    x = torch.randn((batch, cin) + grid)
    w = torch.randn((batch, cout, 2 * grid[0], 2 * grid[1]))

    def oracle(xi):
        out = torch.nn.functional.conv_transpose2d(
            xi, conv.kernel.flip(0, 1).permute(2, 3, 0, 1), conv.bias,
            stride=2)
        return out[:, :, : 2 * grid[0], : 2 * grid[1]]

    before = hific.GEMM_UPSAMPLES
    mine = _grads(conv, x, w, conv)
    assert hific.GEMM_UPSAMPLES - before == 1
    ref = _grads(conv, x, w, oracle)
    assert mine[0].shape == ref[0].shape == w.shape
    for got, want in zip(mine, ref):
        _assert_close(got, want, 1e-5)


@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("grid", [(8, 12), (9, 5)])
def test_tail_overlap_add_matches_conv(grid, batch):
    """Conv.overlap_add (the generator's 7x7 tail, 60 -> 3, as a stride-1
    transposed convolution of the same kernel) against Conv.forward: the
    output and the gradients of input, kernel and bias within 1e-5 of
    their largest magnitude; one count of GEMM_UPSAMPLES a call."""
    torch.manual_seed(grid[0] + batch)
    conv = hific.Conv(60, 3, 7, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        conv.bias.normal_()
    x = torch.randn((batch, 60) + grid)
    w = torch.randn((batch, 3) + grid)
    before = hific.GEMM_UPSAMPLES
    mine = _grads(conv, x, w, conv.overlap_add)
    assert hific.GEMM_UPSAMPLES - before == 1
    ref = _grads(conv, x, w, conv)
    assert mine[0].shape == ref[0].shape == w.shape
    for got, want in zip(mine, ref):
        _assert_close(got, want, 1e-5)


def test_channel_norm_nhwc_equals_nchw():
    """ChannelNorm over the last axis (the trunk's NHWC) against the NCHW
    form: values and the input's gradient."""
    rng = np.random.RandomState(3)
    x = torch.tensor(rng.normal(1, 3, (2, 5, 6, 7)).astype(np.float32))
    w = torch.tensor(rng.normal(0, 1, x.shape).astype(np.float32))
    norm = hific.ChannelNorm(7)
    with torch.no_grad():
        norm.gamma.normal_()
        norm.beta.normal_()
    a = x.clone().requires_grad_()
    out = norm(a, dim=-1)
    torch.sum(w * out).backward()
    b = x.clone().permute(0, 3, 1, 2).requires_grad_()
    ref = norm(b)
    torch.sum(w.permute(0, 3, 1, 2) * ref).backward()
    _assert_close(out.detach(), ref.detach().permute(0, 2, 3, 1), 1e-6)
    _assert_close(a.grad, b.grad.permute(0, 2, 3, 1), 1e-6)


def test_params_from_jax_names_every_parameter_at_full_width():
    """The flax tree of get_config("hific") maps onto the port's model
    name for name and shape: ~182.7M parameters, nothing cut."""
    cfg = jax_hific.get_config("hific")
    shapes = jax.eval_shape(
        lambda: jax_hific.HiFiCModel(cfg=cfg).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
            training=False))
    tree = jax.tree_util.tree_map(
        lambda s: np.zeros((0,), np.float32), shapes)
    flat = {}

    def walk(prefix, node):
        for key, value in node.items():
            if hasattr(value, "items"):
                walk(f"{prefix}{key}.", value)
            elif isinstance(value, (list, tuple)):
                for i, leaf in enumerate(value):
                    flat[f"hyperprior_{key}.{i}"] = leaf
            else:
                flat[prefix + key] = value

    walk("", shapes["params"])
    want = {k: tuple(v.shape) for k, v in flat.items()}
    assert set(hific.params_from_jax(tree)) == set(want)
    model = hific.HiFiCModel(hific.get_config("hific"))
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert got == want
    count = sum(int(np.prod(s)) for s in got.values())
    assert count == 182_705_743
    assert model.latent_depth == 220


def test_configs_equal_jax():
    assert hific.valid_configs() == jax_hific.valid_configs()
    for name in hific.valid_configs():
        assert tuple(hific.get_config(name)) == tuple(
            jax_hific.get_config(name))
    with pytest.raises(ValueError):
        hific.get_config("nope")


# -- against the JAX package -------------------------------------------------
def test_tables_equal_jax(pair):
    jc, pc, _ = pair
    for mine, ref in ((pc.em, jc.em_y), (pc.side_em, jc.em_z)):
        np.testing.assert_array_equal(mine.cdf, np.asarray(ref.cdf))
        np.testing.assert_array_equal(mine.cdf_offset,
                                      np.asarray(ref.cdf_offset))
    # z's offset comes from the prior (offset heuristic on).
    np.testing.assert_array_equal(
        pc.side_em.quantization_offset.numpy(),
        np.asarray(jc.em_z.quantization_offset))


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_subgraphs_match_jax(pair, name):
    """encode, hyper_decode, scale_indexes and decode, each on the JAX
    package's inputs, within ATOL of its outputs."""
    jc, pc, _ = pair
    x = _image(name)
    y, z, z_hat, raw, means, indexes = _jax_latents(jc, x)
    m = pc.model
    with torch.no_grad():
        my, mz = m.encode(torch.as_tensor(x)[None])
        m_raw, m_means = m.hyper_decode(torch.tensor(z_hat))
        h, w = y.shape[1:3]
        m_idx = m.scale_indexes(torch.tensor(raw))
        m_x = m.decode(torch.tensor(y))
    ref_x = np.asarray(jc._decode(jc.params, jnp.asarray(y)))
    for mine, ref in ((my, y), (mz, z), (m_raw[:, :h, :w], raw),
                      (m_means[:, :h, :w], means), (m_idx, indexes),
                      (m_x, ref_x)):
        assert mine.shape == ref.shape
        _assert_close(mine, ref)
    if pc.model.cfg.num_down == 4:  # the stretched model
        assert np.abs(np.round(z)).max() > 0
        # Clipped to the table's ends: 0 and 63 (63.000004 in float32).
        assert indexes.min() == 0 and indexes.max() >= 63


@pytest.mark.parametrize("scale", [1.0, 6.0])
def test_entropy_model_bytes_equal_jax(pair, scale):
    """Both packages' entropy models fed the same z, and the same y, scale
    indexes and means: equal reference-format strings and equal native
    (sidecar) streams and escapes; scale 6 pushes the latents past the
    tables."""
    jc, pc, _ = pair
    y, z, _, _, means, indexes = _jax_latents(jc, _image("72x88"))
    y, z = scale * y, scale * z
    assert pc.side_em.compress_to_strings(torch.tensor(z)) == \
        jc.em_z.compress_to_strings(jnp.asarray(z))
    zb, zl, zi, zv = jc.em_z.compress_sidecar(jax_nf.to_streams(z))
    _assert_sidecar_equal(pc.side_em.compress_sidecar_device(
        native_format.to_streams(torch.tensor(z))), (zb, zl, zi, zv),
        z.shape)
    t = [torch.tensor(a) for a in (y, indexes, means)]
    assert pc.em.compress_to_strings(t[0], t[1], loc=t[2]) == \
        jc.em_y.compress_to_strings(jnp.asarray(y), jnp.asarray(indexes),
                                    loc=jnp.asarray(means))
    rows = [jax_nf.to_streams(a) for a in (y, indexes, means)]
    jb, jl, ji, jv = jc.em_y.compress_sidecar(rows[0], rows[1], loc=rows[2])
    _assert_sidecar_equal(pc.em.compress_sidecar_device(
        *(native_format.to_streams(a) for a in t[:2]),
        loc=native_format.to_streams(t[2])), (jb, jl, ji, jv), y.shape)
    if pc.model.cfg.num_down == 4 or scale > 1:
        assert len(jv) > 0


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
def test_containers_equal_jax_on_shared_latents(pair, name, monkeypatch):
    """Both codecs given the same y, z, scale indexes and means (the JAX
    package's) write byte-identical classic and native containers, and
    each decodes the other's to the same image."""
    jc, pc, _ = pair
    x = _image(name)
    y, z, _, _, means, indexes = _jax_latents(jc, x)
    monkeypatch.setattr(jc, "_encode", lambda p, xx: (jnp.asarray(y),
                                                      jnp.asarray(z)))
    monkeypatch.setattr(jc, "_params_for", lambda z_hat, y_shape: (
        jnp.asarray(indexes), jnp.asarray(means)))
    monkeypatch.setattr(pc, "_encode", lambda xx: tuple(
        torch.tensor(a) for a in (y, z, indexes, means)))
    classic, native = pc.compress(x), pc.compress_native(x)
    assert classic == jc.compress(x)
    assert native == jc.compress_native(x)
    assert PackedTensors(classic).num_tensors == 5
    assert PackedTensors(native).num_tensors == 9
    assert PackedTensors(native).model == "hific"


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_round_trips_equal_reconstruct(pair, name):
    """decompress(compress(x)) and decompress(compress_native(x)) equal
    reconstruct(x) exactly, through the kernels' plain versions."""
    _, pc, _ = pair
    x = _image(name)
    expect = pc.reconstruct(x)
    assert expect.shape == x.shape and expect.dtype == np.uint8
    np.testing.assert_array_equal(pc.decompress(pc.compress(x)), expect)
    assert torch_coder.DISPATCH_LOG["decode"] == "plain-gamma"
    np.testing.assert_array_equal(pc.decompress(pc.compress_native(x)),
                                  expect)
    assert torch_coder.DISPATCH_LOG["decode_sidecar"] == "plain-indexed"


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_reconstruct_matches_jax(pair, name):
    """The port's reconstruct against the JAX package's: the quantized
    symbols round(y - mean) equal, and a pixel differs only by one, where
    the two float images round differently."""
    jc, pc, _ = pair
    x = _image(name)
    y, _, _, _, means, _ = _jax_latents(jc, x)
    with torch.no_grad():
        my, _, _, m_means = pc._encode(pc._upload(x))
        np.testing.assert_array_equal(torch.round(my - m_means).numpy(),
                                      np.round(y - means))
        x_float = pc.model.decode(pc.em.quantize(my, m_means))[
            0, : x.shape[0], : x.shape[1]].numpy()
    ref_float = np.asarray(jc._decode(jc.params, jnp.asarray(
        np.round(y - means) + means)))[0, : x.shape[0], : x.shape[1]]
    _assert_close(x_float, ref_float)
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


# The JAX tests' tiny widths at the published depth: nine residual blocks,
# so the trunk is 19 convolutions as in get_config("hific").
DEEP = dict(CONFIGS["tiny"], num_residual_blocks=9)


@pytest.fixture(scope="module")
def deep_codec():
    model = hific.HiFiCModel(hific.HiFiCConfig(**DEEP), seed=5)
    return hific.HiFiCCodec(model, device="cpu")


def _entry(pc, entry):
    """A call of the codec's ``entry`` on 32x48 images, and the number of
    images it codes."""
    images = [np.random.RandomState(i).randint(0, 256, (32, 48, 3)).astype(
        np.uint8) for i in range(8)]
    call = {
        "compress": lambda: pc.compress(images[0]),
        "compress_native": lambda: pc.compress_native(images[0]),
        "compress_native_many": lambda: pc.compress_native_many(images),
        "decompress": lambda: pc.decompress(pc.compress_native(images[0])),
        "decompress_native_many": lambda: pc.decompress_native_many(
            [pc.compress_native(x) for x in images]),
        "reconstruct": lambda: pc.reconstruct(images[0]),
    }[entry]
    return call, {"compress_native_many": 8,
                  "decompress_native_many": 8}.get(entry, 1)


@pytest.mark.parametrize("entry,per_image", [
    ("compress", 0), ("compress_native", 0), ("compress_native_many", 0),
    ("decompress", 19), ("decompress_native_many", 19),
    ("reconstruct", 19)])
def test_gemm_convs_count_trunk_convolutions(deep_codec, entry, per_image):
    """GEMM_CONVS counts the trunk's 19 convolutions an image synthesized
    (8 images through decompress_native_many: 152) and none a compress:
    the encoder and the hyperprior keep their own convolutions."""
    call, count = _entry(deep_codec, entry)
    before = hific.GEMM_CONVS
    call()
    assert hific.GEMM_CONVS - before == per_image * count


@pytest.fixture(scope="module")
def compact_codec():
    model = hific.HiFiCModel(hific.HiFiCConfig(**CONFIGS["compact"]), seed=5)
    return hific.HiFiCCodec(model, device="cpu")


@pytest.mark.parametrize("entry,per_image", [
    ("compress", 0), ("compress_native", 0), ("compress_native_many", 0),
    ("decompress", 5), ("decompress_native_many", 5),
    ("reconstruct", 5)])
def test_gemm_upsamples_count_the_upsampling_stack(compact_codec, entry,
                                                   per_image):
    """GEMM_UPSAMPLES counts the generator's four transposed convolutions
    and its 7x7 tail an image synthesized at the published depth (8 images
    through decompress_native_many: 40) and none a compress."""
    call, count = _entry(compact_codec, entry)
    before = hific.GEMM_UPSAMPLES
    call()
    assert hific.GEMM_UPSAMPLES - before == per_image * count


@pytest.mark.parametrize("kind", ["native", "classic"])
def test_decompress_repeats_exactly(compact_codec, kind):
    """Two decompresses of one container give the same uint8 image, and it
    equals reconstruct: the upsampling stack's overlap-add sums in a fixed
    order."""
    pc = compact_codec
    image = np.random.RandomState(11).randint(0, 256, (48, 64, 3)).astype(
        np.uint8)
    container = {"native": pc.compress_native,
                 "classic": pc.compress}[kind](image)
    first, second = pc.decompress(container), pc.decompress(container)
    assert first.dtype == np.uint8 and first.shape == image.shape
    np.testing.assert_array_equal(first, second)
    np.testing.assert_array_equal(first, pc.reconstruct(image))


def test_decoder_state_dict_keeps_flax_names_and_shapes():
    """The trunk's own path keeps the Decoder's parameters: names and HWIO
    shapes equal the flax decoder's at the published depth."""
    cfg = jax_hific.HiFiCConfig(**DEEP)
    shapes = jax.eval_shape(
        lambda: jax_hific.HiFiCModel(cfg=cfg).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
            training=False))["params"]["decoder"]
    want = {}

    def walk(prefix, node):
        for key, value in node.items():
            if hasattr(value, "items"):
                walk(f"{prefix}{key}.", value)
            else:
                want[prefix + key] = tuple(value.shape)

    walk("", shapes)
    decoder = hific.Decoder(hific.HiFiCConfig(**DEEP))
    got = {k: tuple(v.shape) for k, v in decoder.state_dict().items()}
    assert got == want
    assert got["block_8.Conv_1.kernel"] == (3, 3, 16, 16)
    assert got["Conv_0.kernel"] == (3, 3, 8, 16)


def _rewrite(container, tensor, edit):
    packed = PackedTensors(container)
    raw = packed.unpack_raw()
    raw[tensor] = edit(raw[tensor])
    out = PackedTensors()
    out.model = packed.model
    out.pack([t if isinstance(t, list) else t.astype(np.int32)
              for t in raw])
    return out.string


@pytest.mark.parametrize("part", ["y", "z"])
@pytest.mark.parametrize("kind", ["classic", "native"])
def test_corrupt_stream_raises(pair, kind, part):
    """Unread trailing bytes in y's or z's streams fail the sanity
    check."""
    _, pc, _ = pair
    x = _image("64x64")
    container = pc.compress(x) if kind == "classic" else \
        pc.compress_native(x)
    bad = _rewrite(container, {"y": 0, "z": 1}[part],
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
        out.pack(packed.unpack_raw()[:4])
        bad = out.string
    elif kind == "hostile_escape":
        bad = _rewrite(pc.compress_native(x), 5,
                       lambda _: np.asarray([10 ** 6, 0], np.int32))
        bad = _rewrite(bad, 6, lambda _: np.asarray([7], np.int32))
    else:
        bad = _rewrite(pc.compress(x), 0, lambda strs: strs * 2)
    with pytest.raises(ValueError):
        pc.decompress(bad)


def test_carried_tables(pair):
    """Tables carried from the JAX entropy models code the same."""
    jc, pc, _ = pair
    carried = hific.HiFiCCodec(
        pc.model, device="cpu",
        tables=(jc.em_y.get_weights(), jc.em_z.get_weights()))
    x = _image("72x88")
    assert carried.compress_native(x) == pc.compress_native(x)
    assert carried.compress(x) == pc.compress(x)


def test_seeded_init_is_reproducible():
    cfg = hific.HiFiCConfig(**CONFIGS["compact"])
    a = hific.HiFiCModel(cfg, seed=3).state_dict()
    b = hific.HiFiCModel(cfg, seed=3).state_dict()
    c = hific.HiFiCModel(cfg, seed=4).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert any(not torch.equal(a[k], c[k]) for k in a)
    assert a["decoder.ConvTranspose_3.kernel"].shape == (3, 3, 8, 4)
    assert a["decoder.block_1.ChannelNorm_1.gamma"].shape == (64,)


def test_hific_default_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device resolves")
    model = hific.HiFiCModel(hific.HiFiCConfig(**CONFIGS["tiny"]))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        hific.HiFiCCodec(model)
