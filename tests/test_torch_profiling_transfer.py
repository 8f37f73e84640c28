"""The port's util/profiling.py, util/transfer.py and util/compile_cache.py
against the JAX package's, on the CPU.

* profiling: the same ``summary()`` structure (names, keys, counts, the
  rounding) as JAX's PhaseTimer for the same calls, ``phase`` /
  ``global_summary``, ``block_on``, and ``trace`` writing a Chrome trace
  (JAX's host tracer levels 2 and 3 map to torch.profiler's settings, 0
  and 1 raise).
* transfer: ``pack_host`` bytes equal to JAX's ``pack_host``, and
  ``pack_device`` equal to JAX's ``pack_jit``, for u8 (odd sizes), i32,
  u32 and bool; both unpacks round-trip, across the two sides too; the
  unsupported dtypes raise TypeError.
* compile_cache: ``enable(tmp)`` sends a host library's build into
  ``tmp``; ``enable()`` restores the default.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compression_tpu.util import profiling as jax_profiling
from compression_tpu.util import transfer as jax_transfer
from compression_tpu_torch import native
from compression_tpu_torch.util import compile_cache, profiling, transfer


# -- profiling -----------------------------------------------------------------
def _drive(timer):
    for name in ("encode", "decode", "encode"):
        with timer(name):
            pass
    with timer("compute", block_on={"a": [torch.ones(2)], "b": 3}):
        pass


def test_phase_timer_summary_matches_jax():
    jt, pt = jax_profiling.PhaseTimer(), profiling.PhaseTimer()
    _drive(jt)
    _drive(pt)
    want, got = jt.summary(), pt.summary()
    assert list(got) == list(want) == ["compute", "decode", "encode"]
    for name in want:
        assert set(got[name]) == set(want[name])
        assert got[name]["count"] == want[name]["count"]
        assert got[name]["total_s"] == round(pt.totals[name], 6)
        assert got[name]["mean_ms"] == round(
            1e3 * pt.totals[name] / pt.counts[name], 3)
    assert json.loads(pt.report()) == got


def test_global_phase():
    before = profiling.global_summary().get("t_phase", {"count": 0})["count"]
    with profiling.phase("t_phase"):
        pass
    assert profiling.global_summary()["t_phase"]["count"] == before + 1


@pytest.mark.parametrize("level", [None, 2, 3])
def test_trace_writes_a_chrome_trace(tmp_path, level):
    with profiling.trace(str(tmp_path / "t"), host_tracer_level=level):
        torch.ones(64).add_(1).sum()
    with open(tmp_path / "t" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("add" in e.get("name", "") for e in events)


@pytest.mark.parametrize("level", [0, 1, 4])
def test_trace_refuses_levels_without_a_counterpart(tmp_path, level):
    with pytest.raises(ValueError, match="host_tracer_level"):
        with profiling.trace(str(tmp_path), host_tracer_level=level):
            pass


# -- transfer ------------------------------------------------------------------
def _arrays(seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, (3,)).astype(np.uint8),
            rng.randint(-2**31, 2**31 - 1, (2, 5)).astype(np.int32),
            rng.randint(0, 2**32 - 1, (7,), dtype=np.uint64).astype(
                np.uint32),
            rng.randint(0, 2, (3, 3)).astype(bool),
            rng.randint(0, 256, (5, 7)).astype(np.uint8),
            np.asarray(rng.randint(-100, 100), np.int32),
            rng.randint(0, 256, (1,)).astype(np.uint8)]


@pytest.mark.parametrize("seed", [0, 1])
def test_pack_host_equals_jax(seed):
    arrays = _arrays(seed)
    flat = transfer.pack_host(arrays)
    np.testing.assert_array_equal(flat, jax_transfer.pack_host(arrays))
    spec = transfer.pack_spec(arrays)
    assert spec == jax_transfer.pack_spec(arrays)
    for got, want in zip(transfer.unpack_host(flat, spec), arrays):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


_TORCH_DTYPES = {np.dtype(np.uint8): torch.uint8,
                 np.dtype(np.int32): torch.int32,
                 np.dtype(np.uint32): torch.uint32,
                 np.dtype(np.bool_): torch.bool}


@pytest.mark.parametrize("seed", [0, 1])
def test_pack_device_equals_jax_pack_jit(seed):
    arrays = _arrays(seed)
    flat = transfer.pack_device([torch.from_numpy(np.array(a))
                                 for a in arrays])
    assert flat.dtype == torch.int32
    np.testing.assert_array_equal(
        flat.numpy(), np.asarray(jax_transfer.pack_jit(
            [jnp.asarray(a) for a in arrays])))
    spec = transfer.pack_spec(arrays)
    tensors = [torch.from_numpy(np.array(a)) for a in arrays]
    assert transfer.pack_spec(tensors) == spec
    for got, want in zip(transfer.unpack_device(flat, spec), arrays):
        assert got.dtype == _TORCH_DTYPES[np.dtype(want.dtype)]
        np.testing.assert_array_equal(got.numpy(), want)
    # The two sides' layouts are one: each unpacks the other's vector.
    for got, want in zip(transfer.unpack_host(flat.numpy(), spec), arrays):
        np.testing.assert_array_equal(got, want)


def test_empty_packs():
    assert transfer.pack_host([]).shape == (0,)
    assert transfer.pack_device([]).shape == (0,)


@pytest.mark.parametrize("dtype", [np.float32, np.int64, np.int16])
def test_unsupported_dtypes_raise(dtype):
    a = np.zeros(3, dtype)
    for fn in (transfer.pack_spec, transfer.pack_host,
               jax_transfer.pack_spec, jax_transfer.pack_host):
        with pytest.raises(TypeError, match="Unsupported pack dtype"):
            fn([a])
    with pytest.raises(TypeError, match="Unsupported pack dtype"):
        transfer.pack_device([torch.from_numpy(a)])
    with pytest.raises(TypeError, match="Unsupported pack dtype"):
        transfer.pack_spec([torch.from_numpy(a)])


# -- compile_cache -------------------------------------------------------------
def test_enable_moves_the_build_directory(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", native.BUILD_DIR)
    monkeypatch.setattr(native, "_HOST_CODECS_LIB", None)
    compile_cache.enable(str(tmp_path))
    assert native.BUILD_DIR == str(tmp_path)
    native.get_host_codecs_lib()
    assert os.path.exists(tmp_path / "host_codecs.so")
    compile_cache.enable()
    assert native.BUILD_DIR == compile_cache.DEFAULT
    assert os.path.samefile(os.path.dirname(compile_cache.DEFAULT),
                            os.path.dirname(os.path.dirname(native.__file__)))
