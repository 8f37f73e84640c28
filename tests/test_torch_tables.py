"""compression_tpu_torch's copies of the framework-free table and container
code against the JAX package's originals (byte- and value-identical)."""

import os

import numpy as np
import pytest
import torch

from compression_tpu.codec import tables as jax_tables
from compression_tpu.util import packed_tensors as jax_packed
from compression_tpu_torch.codec import tables
from compression_tpu_torch.util import packed_tensors

torch.set_num_threads(1)

GOLDEN_OPS = os.path.join(os.path.dirname(__file__), "golden", "golden_ops.npz")


@pytest.mark.parametrize("seed", range(6))
def test_pmf_to_quantized_cdf_matches_jax(seed):
    rng = np.random.RandomState(seed)
    for _ in range(20):
        precision = int(rng.randint(1, 17))
        size = int(rng.randint(2, min(2 ** precision, 300) + 1))
        pmf = rng.dirichlet(np.full(size, rng.choice([0.1, 1.0, 10.0])))
        if rng.rand() < 0.3:
            pmf[rng.randint(size)] = 0.0
        np.testing.assert_array_equal(
            tables.pmf_to_quantized_cdf(pmf, precision),
            jax_tables.pmf_to_quantized_cdf(pmf, precision))


def test_pmf_to_quantized_cdf_matches_golden_ops():
    gold = np.load(GOLDEN_OPS)
    for i in range(int(gold["pmf_num_cases"])):
        got = tables.pmf_to_quantized_cdf(
            gold[f"pmf{i}__pmf"], int(gold[f"pmf{i}__precision"]))
        np.testing.assert_array_equal(got, gold[f"pmf{i}__cdf"])


def test_pmf_to_quantized_cdf_rejects_bad_input():
    with pytest.raises(ValueError):
        tables.pmf_to_quantized_cdf(np.asarray([0.5, -0.1]), 8)
    with pytest.raises(ValueError):
        tables.pmf_to_quantized_cdf(np.asarray([0.5, 0.5]), 17)


@pytest.mark.parametrize("overflow", [False, True])
def test_ragged_round_trip_matches_jax(overflow):
    rng = np.random.RandomState(3)
    cdfs, precs = [], []
    for _ in range(7):
        prec = int(rng.randint(4, 16))
        pmf = rng.dirichlet(np.ones(int(rng.randint(2, 20))))
        cdfs.append(jax_tables.pmf_to_quantized_cdf(pmf, prec))
        precs.append(prec)
    ovfs = [overflow] * len(cdfs)
    ragged = tables.build_ragged_cdf(cdfs, precs, ovfs)
    np.testing.assert_array_equal(
        ragged, jax_tables.build_ragged_cdf(cdfs, precs, ovfs))
    mine, ref = tables.parse_ragged_cdf(ragged), jax_tables.parse_ragged_cdf(
        ragged)
    for field in ("cdf", "length", "precision", "overflow"):
        np.testing.assert_array_equal(getattr(mine, field),
                                      getattr(ref, field))


def test_parse_ragged_cdf_rejects_bad_rows():
    with pytest.raises(ValueError):
        tables.parse_ragged_cdf(np.asarray([8, 0, 300, 200, 256], np.int32))
    with pytest.raises(ValueError):
        tables.parse_ragged_cdf(np.asarray([8, 1, 256], np.int32))


@pytest.mark.parametrize("tensors", [
    [[b"ab", b"", b"\x00\xff" * 40], np.asarray([3, 4], np.int32),
     np.asarray([-7, 2 ** 40], np.int64)],
    [np.asarray([1.5, -2.25], np.float32), [b"x" * 300]],
    [[], np.zeros(0, np.int32)],
])
def test_packed_tensors_bytes_match_jax(tensors):
    mine, ref = packed_tensors.PackedTensors(), jax_packed.PackedTensors()
    for p in (mine, ref):
        p.model = "bls2017"
        p.pack(tensors)
    assert mine.string == ref.string
    back = packed_tensors.PackedTensors(ref.string)
    assert back.model == "bls2017"
    assert back.num_tensors == len(tensors)
    for got, want in zip(back.unpack_raw(), ref.unpack_raw()):
        if isinstance(want, list):
            assert got == want
        else:
            np.testing.assert_array_equal(got, want)
