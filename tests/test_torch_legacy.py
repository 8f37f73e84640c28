"""The port's legacy range coding ops (codec/legacy.py) and its Y4M reader
(datasets/y4m.py) against the JAX package, on the CPU.

Exact: the legacy ops' bytes and decoded values equal JAX's on the cases
of tests/test_legacy_ops.py, rejections included; the Y4M frames equal
JAX's on files written here."""

import os

import numpy as np
import pytest

from compression_tpu.codec import legacy as jax_legacy
from compression_tpu.datasets import y4m as jax_y4m
from compression_tpu_torch.codec import legacy, tables
from compression_tpu_torch.datasets import y4m


def _shared_cdf_case(precision):
    rng = np.random.RandomState(precision)
    cdf = tables.pmf_to_quantized_cdf(rng.dirichlet(np.ones(16)), precision)
    return rng.randint(0, 16, size=(5, 7)), cdf.reshape(1, 1, -1), precision


def _broadcast_case():
    rng = np.random.RandomState(0)
    cdfs = np.stack([
        tables.pmf_to_quantized_cdf(rng.dirichlet(np.ones(8)), 10)
        for _ in range(3)])
    return rng.randint(0, 8, size=(20, 3)), cdfs.reshape(1, 3, -1), 10


RANGE_CASES = {f"shared_p{p}": (lambda p=p: _shared_cdf_case(p))
               for p in (8, 12, 16)}
RANGE_CASES["broadcast_axis"] = _broadcast_case


@pytest.mark.parametrize("name", sorted(RANGE_CASES))
def test_range_coding_matches_jax(name):
    data, cdf, precision = RANGE_CASES[name]()
    code = legacy.range_encode(data, cdf, precision)
    assert code == jax_legacy.range_encode(data, cdf, precision)
    out = legacy.range_decode(code, data.shape, cdf, precision)
    assert out.dtype == np.int16
    np.testing.assert_array_equal(out, data)
    np.testing.assert_array_equal(
        out, jax_legacy.range_decode(code, data.shape, cdf, precision))


def _unbounded_case(overflow_width):
    rng = np.random.RandomState(overflow_width)
    cdf = np.zeros((4, 11), np.int64)
    offset = rng.randint(-5, 5, size=4)
    for r in range(4):
        cdf[r] = tables.pmf_to_quantized_cdf(rng.dirichlet(np.ones(10)), 12)
    index = rng.randint(0, 4, size=200)
    data = np.round(rng.laplace(0, 12, size=200)).astype(np.int64)
    return data, index, cdf, np.full(4, 11), offset, 12, overflow_width


def _in_range_case():
    rng = np.random.RandomState(9)
    cdf = tables.pmf_to_quantized_cdf(np.ones(6) / 6, 8).reshape(1, -1)
    return (rng.randint(-2, 2, size=50), np.zeros(50, np.int64), cdf,
            np.asarray([7]), np.asarray([-2]), 8, 4)


UNBOUNDED_CASES = {f"overflow_width{w}": (lambda w=w: _unbounded_case(w))
                   for w in (1, 2, 4)}
UNBOUNDED_CASES["in_range"] = _in_range_case


@pytest.mark.parametrize("name", sorted(UNBOUNDED_CASES))
def test_unbounded_index_range_coding_matches_jax(name):
    data, index, *args = UNBOUNDED_CASES[name]()
    code = legacy.unbounded_index_range_encode(data, index, *args)
    assert code == jax_legacy.unbounded_index_range_encode(
        data, index, *args)
    out = legacy.unbounded_index_range_decode(code, index, *args)
    np.testing.assert_array_equal(out, data)
    np.testing.assert_array_equal(
        out, jax_legacy.unbounded_index_range_decode(code, index, *args))


REJECTIONS = {
    "shapes": (lambda m: m.range_encode(
        np.zeros((2, 3)), np.array([[0, 1, 4]]).reshape(3, 3)[:2], 2),
        None),
    "nondecreasing_encode": (lambda m: m.range_encode(
        np.zeros((1,), np.int32), np.array([[0, 5, 3, 16]]), 4),
        "nondecreasing"),
    "nondecreasing_decode": (lambda m: m.range_decode(
        b"\x00", (1,), np.array([[0, 5, 3, 16]]), 4), "nondecreasing"),
    "exceeds_precision": (lambda m: m.range_encode(
        np.zeros((1,), np.int32), np.array([[0, 10, 20]]), 4), "exceed"),
    "nonzero_start": (lambda m: m.range_decode(
        b"\x00", (1,), np.array([[1, 8, 16]]), 4), "start at 0"),
    "index_out_of_range": (lambda m: m.unbounded_index_range_encode(
        np.zeros(2, np.int32), np.array([0, 5]), np.array([[0, 8, 16, 16]]),
        np.array([4]), np.array([0]), 4, 2), "index out of range"),
    "value_out_of_range": (lambda m: m.range_encode(
        np.array([3]), np.array([[0, 8, 16]]), 4), "out of range"),
}


@pytest.mark.parametrize("name", sorted(REJECTIONS))
def test_rejections_match_jax(name):
    call, match = REJECTIONS[name]
    for module in (legacy, jax_legacy):
        with pytest.raises(ValueError, match=match):
            call(module)


def test_debug_level_zero_skips_validation():
    cdf = np.array([[0, 8, 16]])
    data = np.zeros((3,), np.int32)
    code = legacy.range_encode(data, cdf, 4, debug_level=0)
    assert code == jax_legacy.range_encode(data, cdf, 4, debug_level=0)
    np.testing.assert_array_equal(
        legacy.range_decode(code, (3,), cdf, 4, debug_level=0), data)


# -- Y4M ---------------------------------------------------------------------
def _write_y4m(path, frames, chroma):
    h, w = frames[0][0].shape[:2]
    with open(path, "wb") as f:
        f.write(f"YUV4MPEG2 W{w} H{h} F25:1 Ip A1:1 C{chroma}\n".encode())
        for planes in frames:
            f.write(b"FRAME\n")
            for plane in planes:
                f.write(plane.tobytes())


def _frames(rng, n, luma, chroma):
    return [(rng.randint(0, 256, luma, np.uint8),
             rng.randint(0, 256, chroma, np.uint8),
             rng.randint(0, 256, chroma, np.uint8)) for _ in range(n)]


Y4M_CASES = {
    "420jpeg": [("420jpeg", 3, (4, 6), (2, 3))],
    "420": [("420", 2, (6, 8), (3, 4))],
    "444_multifile": [("444", 2, (2, 2), (2, 2)), ("444", 1, (2, 2), (2, 2))],
    "mixed_multifile": [("420", 1, (4, 4), (2, 2)),
                        ("444", 2, (3, 5), (3, 5))],
}


@pytest.mark.parametrize("name", sorted(Y4M_CASES))
def test_y4m_frames_match_jax(name, tmp_path):
    rng = np.random.RandomState(sorted(Y4M_CASES).index(name))
    paths, expect = [], []
    for i, (chroma, n, luma, cshape) in enumerate(Y4M_CASES[name]):
        frames = _frames(rng, n, luma, cshape)
        paths.append(os.path.join(tmp_path, f"{i}.y4m"))
        _write_y4m(paths[-1], frames, chroma)
        expect += frames
    got = list(y4m.Y4MDataset(paths))
    want = list(jax_y4m.y4m_frames(paths))
    assert len(got) == len(want) == len(expect)
    for (y, cbcr), (jy, jcbcr), (ey, ecb, ecr) in zip(got, want, expect):
        assert y.dtype == cbcr.dtype == np.uint8
        np.testing.assert_array_equal(y, jy)
        np.testing.assert_array_equal(cbcr, jcbcr)
        np.testing.assert_array_equal(y[..., 0], ey)
        np.testing.assert_array_equal(cbcr[..., 0], ecb)
        np.testing.assert_array_equal(cbcr[..., 1], ecr)
    assert [f[0].shape for f in y4m.y4m_frames(paths[0])] == [
        f[0].shape for f in jax_y4m.y4m_frames(paths[0])]


@pytest.mark.parametrize("header", [b"YUV4MPEG2 W3 H2 C420",
                                    b"YUV4MPEG2 W4 H3 C420jpeg",
                                    b"YUV4MPEG2 W4 H4 C411",
                                    b"YUV4MPEG2 W4 H4 C420 It",
                                    b"YUV4MPEG W4 H4 C420"])
def test_y4m_rejects_what_jax_rejects(header, tmp_path):
    path = os.path.join(tmp_path, "bad.y4m")
    with open(path, "wb") as f:
        f.write(header + b"\n")
    for module in (y4m, jax_y4m):
        with pytest.raises(ValueError):
            list(module.y4m_frames([path]))
