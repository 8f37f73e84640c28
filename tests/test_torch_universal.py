"""The universal entropy models (``entropy_models/universal.py``) and the
Philox dither (``util/philox.py``) against the JAX package and the TF
reference's goldens, on the CPU.

- Philox: raw words and ``stateless_uniform_int32`` bit for bit equal to
  the JAX package's on several shapes, ranges and seeds.
- golden_em.npz (written by the TF reference): the tables of ``unb``
  (UniversalBatched over NoisyNormal), ``uni`` (UniversalIndexed over
  NoisyNormal) and ``ci2`` (ContinuousIndexed over NoisyLogistic) are
  identical; compress gives the golden bytes, decompress of the golden
  bytes the golden values (exactly; ``uni`` within 1e-5, as the JAX
  package's test has it); eval bits within 1e-4 relative.
- The training ``__call__`` against JAX with shared noise ``u`` (values
  exact, bits and the gradient within 1e-5 relative), eval mode, and
  ``laplace_tail_mass > 0``; ``get_config``.
- The card phase's models (tests/universal_cases.py: 2880 and 960 table
  rows): tables equal to JAX's but for a few rows one count apart (the
  erf / erfc of torch and XLA differ in the last bits); at 2 streams of
  3072 symbols on the CPU plain path, with and without escapes, the bytes
  of JAX's compress on the same tables, the front end's route K6'
  (escapes) or K1, the round trip equal to the dithered quantization.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from compression_tpu import distributions as jd
from compression_tpu.entropy_models import universal as jax_universal
from compression_tpu.util import philox as jax_philox
from compression_tpu_torch.codec import torch_coder
from compression_tpu_torch.distributions import uniform_noise as pd
from compression_tpu_torch.entropy_models.continuous_indexed import (
    ContinuousIndexedEntropyModel)
from compression_tpu_torch.entropy_models.universal import (
    UniversalBatchedEntropyModel, UniversalIndexedEntropyModel)
from compression_tpu_torch.util import philox

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(HERE, "golden", "golden_em.npz")


def _cases():
    spec = importlib.util.spec_from_file_location(
        "universal_cases", os.path.join(HERE, "universal_cases.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


cases = _cases()


# -- Philox -------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(), (1,), (3,), (4,), (5, 7), (2, 3, 5),
                                   (8, 32, 32, 192)])
@pytest.mark.parametrize("bounds", [(0, 15), (0, 2), (-7, 1000),
                                    (0, 2 ** 31 - 1)])
def test_philox_uniform_int32_equal_jax(shape, bounds):
    for seed in ((1234, 1234), (0, 0), (-1, 2 ** 40 + 3)):
        mine = philox.stateless_uniform_int32(shape, seed, *bounds)
        ref = jax_philox.stateless_uniform_int32(shape, seed, *bounds)
        assert mine.dtype == np.int32 and mine.shape == tuple(shape)
        np.testing.assert_array_equal(mine, ref)


def test_philox_raw_rounds_equal_jax():
    rng = np.random.RandomState(0)
    counter = [rng.randint(0, 2 ** 32, 1000, dtype=np.uint64).astype(
        np.uint32) for _ in range(4)]
    key = (np.uint32(0xDEADBEEF), np.uint32(0x12345678))
    for mine, ref in zip(philox.philox_4x32_10(counter, key),
                         jax_philox.philox_4x32_10(counter, key)):
        assert mine.dtype == np.uint32
        np.testing.assert_array_equal(mine, ref)


def test_dither_cached_per_shape_and_device():
    from compression_tpu_torch.entropy_models import universal
    a = universal._dither((3, 4), 15, "cpu")
    assert universal._dither([3, 4], 15, torch.device("cpu")) is a
    np.testing.assert_array_equal(a.numpy(), jax_universal._offset_indexes_np(
        (3, 4), 15))


# -- goldens ------------------------------------------------------------------
@pytest.fixture(scope="module")
def gold():
    return dict(np.load(FIXTURE))


def _strings(gold, prefix):
    nbytes, buf = gold[f"{prefix}__nbytes"], gold[f"{prefix}__bytes"]
    out, off = [], 0
    for n in nbytes:
        out.append(buf[off:off + int(n)].tobytes())
        off += int(n)
    return out


def _golden_em(gold, prefix):
    if prefix == "unb":
        return UniversalBatchedEntropyModel(
            pd.NoisyNormal(loc=torch.tensor(gold["unb__loc"]),
                           scale=torch.tensor(gold["unb__scales"])),
            coding_rank=3, compression=True, device="cpu")
    if prefix == "uni":
        return UniversalIndexedEntropyModel(
            pd.NoisyNormal, tuple(gold["uni__index_ranges"]),
            {"loc": lambda i: (i[..., 0] - 1.0) / 2.,
             "scale": lambda i: torch.exp(i[..., 1] - 1.5)},
            coding_rank=2, compression=True, device="cpu")
    return ContinuousIndexedEntropyModel(
        pd.NoisyLogistic, tuple(gold["ci2__index_ranges"]),
        {"loc": lambda i: (i[..., 0] - 1.5) / 2.,
         "scale": lambda i: torch.exp(i[..., 1] - 2.)},
        coding_rank=2, compression=True, device="cpu")


@pytest.mark.parametrize("prefix", ["unb", "uni", "ci2"])
def test_golden_tables(gold, prefix):
    em = _golden_em(gold, prefix)
    np.testing.assert_array_equal(em.cdf, gold[f"{prefix}__cdf"])
    np.testing.assert_array_equal(em.cdf_offset, gold[f"{prefix}__cdf_offset"])


@pytest.mark.parametrize("prefix", ["unb", "uni", "ci2"])
def test_golden_bytes_both_ways(gold, prefix):
    em = _golden_em(gold, prefix)
    x = torch.tensor(gold[f"{prefix}__x"])
    strings = _strings(gold, prefix)
    if prefix == "unb":
        assert em.compress_to_strings(x) == strings
        xhat = em.decompress(strings, (4, 6))
    else:
        idx = torch.tensor(gold[f"{prefix}__indexes"])
        assert em.compress_to_strings(x, idx) == strings
        xhat = em.decompress(strings, idx)
    if prefix == "uni":
        np.testing.assert_allclose(xhat.numpy(), gold["uni__xhat"],
                                   atol=1e-5)
    else:
        np.testing.assert_array_equal(xhat.numpy(), gold[f"{prefix}__xhat"])


@pytest.mark.parametrize("prefix", ["uni", "ci2"])
def test_golden_eval_bits(gold, prefix):
    em = _golden_em(gold, prefix)
    _, bits = em(torch.tensor(gold[f"{prefix}__x"]),
                 torch.tensor(gold[f"{prefix}__indexes"]), training=False)
    np.testing.assert_allclose(bits.numpy(), gold[f"{prefix}__bits"],
                               rtol=1e-4)


# -- __call__ against JAX -----------------------------------------------------
def _pair(kind, ltm=0.0):
    """(JAX model, port model, bottleneck, indexes or None)."""
    rng = np.random.RandomState(7)
    if kind == "batched":
        loc, scale = cases.channel_params(5)
        jem = jax_universal.UniversalBatchedEntropyModel(
            jd.NoisyNormal(loc=jnp.asarray(loc), scale=jnp.asarray(scale)),
            coding_rank=2, compression=True, laplace_tail_mass=ltm)
        pem = UniversalBatchedEntropyModel(
            pd.NoisyNormal(loc=torch.tensor(loc), scale=torch.tensor(scale)),
            coding_rank=2, compression=True, laplace_tail_mass=ltm,
            device="cpu")
        x = (rng.normal(0, 3, (3, 6, 5)) + loc).astype(np.float32)
        return jem, pem, x, None
    fns = {"loc": lambda i: (i[..., 0] - 1.0) / 2.,
           "scale": lambda i: jnp.exp(i[..., 1] - 1.5)}
    pfns = {"loc": lambda i: (i[..., 0] - 1.0) / 2.,
            "scale": lambda i: torch.exp(i[..., 1] - 1.5)}
    jem = jax_universal.UniversalIndexedEntropyModel(
        jd.NoisyNormal, (3, 5), fns, coding_rank=2, compression=True,
        laplace_tail_mass=ltm)
    pem = UniversalIndexedEntropyModel(
        pd.NoisyNormal, (3, 5), pfns, coding_rank=2, compression=True,
        laplace_tail_mass=ltm, device="cpu")
    x = rng.normal(0, 4, (2, 7, 9)).astype(np.float32)
    idx = np.stack([rng.uniform(-0.5, 2.5, (2, 7, 9)),
                    rng.uniform(0, 4.5, (2, 7, 9))], -1).astype(np.float32)
    return jem, pem, x, idx


def _call(em, x, idx, **kw):
    return em(x, **kw) if idx is None else em(x, idx, **kw)


@pytest.mark.parametrize("ltm", [0.0, 1e-3])
@pytest.mark.parametrize("kind", ["batched", "indexed"])
def test_training_call_equals_jax(kind, ltm):
    """Shared noise u: the perturbed values exactly, the bits within 1e-5
    relative, and d(bits)/dx (the expected gradient) within 1e-4."""
    import jax
    jem, pem, x, idx = _pair(kind, ltm)
    u = np.random.RandomState(9).uniform(-0.5, 0.5, x.shape).astype(
        np.float32)
    jidx = None if idx is None else jnp.asarray(idx)
    jy, jbits = _call(jem, jnp.asarray(x), jidx, training=True,
                      u=jnp.asarray(u))
    jgrad = jax.grad(lambda v: jnp.sum(_call(
        jem, v, jidx, training=True, u=jnp.asarray(u))[1]))(jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    py, pbits = _call(pem, xt, None if idx is None else torch.tensor(idx),
                      training=True, u=torch.tensor(u))
    (pgrad,) = torch.autograd.grad(pbits.sum(), xt)
    np.testing.assert_array_equal(py.detach().numpy(), np.asarray(jy))
    np.testing.assert_allclose(pbits.detach().numpy(), np.asarray(jbits),
                               rtol=1e-5)
    np.testing.assert_allclose(pgrad.numpy(), np.asarray(jgrad), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("ltm", [0.0, 1e-3])
@pytest.mark.parametrize("kind", ["batched", "indexed"])
def test_eval_call_and_bytes_equal_jax(kind, ltm):
    """Eval mode: the dithered quantization exactly, the bits within 1e-5
    relative; compress gives JAX's bytes, decompress the quantization."""
    jem, pem, x, idx = _pair(kind, ltm)
    jidx = None if idx is None else jnp.asarray(idx)
    pidx = None if idx is None else torch.tensor(idx)
    jy, jbits = _call(jem, jnp.asarray(x), jidx, training=False)
    py, pbits = _call(pem, torch.tensor(x), pidx, training=False)
    np.testing.assert_array_equal(py.numpy(), np.asarray(jy))
    np.testing.assert_allclose(pbits.numpy(), np.asarray(jbits), rtol=1e-5)
    strings = (pem.compress_to_strings(torch.tensor(x)) if idx is None
               else pem.compress_to_strings(torch.tensor(x), pidx))
    ref = (jem.compress_to_strings(jnp.asarray(x)) if idx is None
           else jem.compress_to_strings(jnp.asarray(x), jidx))
    assert strings == ref
    if idx is None:
        out = pem.decompress(strings, x.shape[1:-1])
    else:
        out = pem.decompress(strings, pidx)
    np.testing.assert_array_equal(out.numpy(), py.numpy())
    assert pem.get_config() == jem.get_config()


def test_padded_buffer_round_trip():
    """compress's padded buffer and lengths decode as the strings do."""
    _, pem, x, _ = _pair("batched")
    buf, lengths = pem.compress(torch.tensor(x))
    assert buf.shape[0] == lengths.shape[0] == 3
    out = pem.decompress(buf, x.shape[1:-1], lengths=lengths)
    np.testing.assert_array_equal(
        out.numpy(), pem(torch.tensor(x), training=False)[0].numpy())


def _verdict(fn):
    try:
        return np.asarray(fn())
    except ValueError as e:
        return str(e)


@pytest.mark.parametrize("corrupt", ["truncated", "flipped", "appended"])
def test_corrupt_stream_same_verdict_as_jax(corrupt):
    """A damaged stream: the port raises where JAX raises (the sanity
    check), else decodes the values JAX decodes."""
    jem, pem, x, _ = _pair("batched")
    strings = pem.compress_to_strings(torch.tensor(x))
    s0 = strings[0]
    bad = {"truncated": s0[:2], "flipped": bytes(b ^ 0x5A for b in s0),
           "appended": s0 + b"\xff" * 9}[corrupt]
    bad = [bad] + strings[1:]
    mine = _verdict(lambda: pem.decompress(bad, x.shape[1:-1]).numpy())
    ref = _verdict(lambda: jem.decompress(bad, x.shape[1:-1]))
    if isinstance(ref, str):
        assert mine == ref
    else:
        np.testing.assert_array_equal(mine, ref)


# -- the card phase's models, at a few streams --------------------------------
@pytest.fixture(scope="module")
def card_models():
    """{kind: (port model, JAX model coding with the port's tables, JAX's
    own tables)} of tests/universal_cases.py."""
    loc, scale = cases.channel_params()
    offset, factor = cases.scale_constants()
    jb = jax_universal.UniversalBatchedEntropyModel(
        jd.NoisyNormal(loc=jnp.asarray(loc), scale=jnp.asarray(scale)),
        coding_rank=3, compression=True)
    ji = jax_universal.UniversalIndexedEntropyModel(
        jd.NoisyNormal, (cases.NUM_SCALES,),
        {"loc": lambda _: 0.0,
         "scale": lambda i: jnp.exp(offset + factor * i[..., 0])},
        coding_rank=3, compression=True)
    out = {}
    for kind, pem, jem in (("batched", cases.batched_model("cpu"), jb),
                           ("indexed", cases.indexed_model("cpu"), ji)):
        own = [np.asarray(w) for w in jem.get_weights()]
        jem.set_weights(pem.get_weights())
        out[kind] = (pem, jem, own)
    return out


@pytest.mark.parametrize("kind", ["batched", "indexed"])
def test_card_tables_against_jax(card_models, kind):
    """2880 and 960 rows.  The offsets and row lengths are JAX's; a few
    rows (2 of 2880, 4 of 960) differ from JAX's by one count moved
    between neighbouring entries: the greedy quantizer breaks ties on
    pmf values that differ in the last bits, where torch's erf / erfc
    are not XLA's (ROADMAP §3).  Every row equal, or within one count at
    each entry, and at most 1% of the rows differing."""
    from compression_tpu_torch.codec import tables
    pem, _, (jcdf, jcdf_offset) = card_models[kind]
    rows = {"batched": cases.CHANNELS, "indexed": cases.NUM_SCALES}[kind]
    assert pem.device_table.num_rows == cases.LEVELS * rows
    np.testing.assert_array_equal(pem.cdf_offset, jcdf_offset)
    mine, ref = tables.parse_ragged_cdf(pem.cdf), tables.parse_ragged_cdf(
        jcdf)
    np.testing.assert_array_equal(mine.length, ref.length)
    np.testing.assert_array_equal(mine.precision, ref.precision)
    gap = np.abs(mine.cdf.astype(np.int64) - ref.cdf).max(axis=1)
    assert gap.max() <= 1
    assert np.count_nonzero(gap) <= 0.01 * mine.num_rows


@pytest.mark.parametrize("escapes", [False, True])
@pytest.mark.parametrize("kind", ["batched", "indexed"])
def test_card_shapes_bytes_equal_jax(card_models, kind, escapes):
    """2 streams of 4 x 4 x 192 on the port's tables: the bytes of JAX's
    compress (its dither, symbols and coder) on the same tables, the
    route the card takes (K6' with escapes, K1 without), the round trip
    equal to the dithered quantization."""
    pem, jem, _ = card_models[kind]
    y_b, y_i, idx = cases.latents((2, 4, 4, cases.CHANNELS), escapes)
    torch_coder.DISPATCH_LOG.clear()
    if kind == "batched":
        mine = pem.compress_to_strings(torch.tensor(y_b))
        ref = jem.compress_to_strings(jnp.asarray(y_b))
        out = pem.decompress(mine, (4, 4))
        expect = pem(torch.tensor(y_b), training=False)[0]
    else:
        mine = pem.compress_to_strings(torch.tensor(y_i), torch.tensor(idx))
        ref = jem.compress_to_strings(jnp.asarray(y_i), jnp.asarray(idx))
        out = pem.decompress(mine, torch.tensor(idx))
        expect = pem(torch.tensor(y_i), torch.tensor(idx), training=False)[0]
    assert torch_coder.DISPATCH_LOG["encode"] == (
        "plain-gamma" if escapes else "plain-indexed")
    assert torch_coder.DISPATCH_LOG["decode"] == "plain-gamma"
    assert len(mine) == 2 and mine == ref
    np.testing.assert_array_equal(out.numpy(), expect.numpy())
