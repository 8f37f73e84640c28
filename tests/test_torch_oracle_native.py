"""The JAX package's native libraries, built once per checkout before any
test of any xdist worker runs.

The JAX package, which the port's tests hold it against, builds its three
shared objects (`_pmf_quantizer.so`, `_range_coder.so`, `_host_codecs.so`)
in place on first use, without a lock, and caches None when loading fails
(`compression_tpu/native/__init__.py`).  Under `pytest -n 6` on a fresh
checkout the workers race to write the same file; a worker that loads a
half-written one keeps None for its whole life and falls back to the
stable-sort Python quantizer, whose tie-breaks differ from libstdc++'s
std::sort: every table that worker builds then differs from the TF
goldens.  So, when pytest imports this module -- which every worker does
while collecting, before xdist hands out the first test -- it takes an
exclusive lock on a file in the system temp directory and loads the three
libraries under it, through the JAX package's own code: the first worker
builds them, the others wait and load whole files.  This lives in a test
module because tests/conftest.py only registers markers; the JAX package
itself stays as it is.  Nothing here raises at import: a failure is
recorded and the tests below report it.

One load comes before this module: tests/test_host_codec.py, which sorts
earlier, calls host.available() when it is imported, so the range coder's
build still races there.  Under the lock this module reloads what such a
race left None in the process (rebuilding a torn file), so that every
later caller gets the library; the skip that test_host_codec.py decided
at its import stays as it was decided.
"""

import fcntl
import hashlib
import os
import shutil
import tempfile

import numpy as np
import pytest

# (loader, its "tried" flag, its cached library, the file it builds).
LOADERS = (("get_pmf_lib", "_PMF_TRIED", "_PMF_LIB", "_pmf_quantizer.so"),
           ("get_range_coder_lib", "_RC_TRIED", "_RC_LIB", "_range_coder.so"),
           ("get_lib", "_TRIED", "_LIB", "_host_codecs.so"))
FIXTURE = os.path.join(os.path.dirname(__file__), "golden", "golden_em.npz")


def _load(native, where, loader, tried, cached, built):
    """One library under the lock.  A None the JAX package cached before
    this module was imported comes from an unlocked race
    (tests/test_host_codec.py calls host.available() when it is imported,
    before any test_torch_ module): load again, and if the file on disk
    is a torn write, build it anew."""
    if getattr(native, tried) and getattr(native, cached) is None:
        setattr(native, tried, False)
    lib = getattr(native, loader)()
    path = os.path.join(where, built)
    if lib is None and os.path.exists(path):
        os.remove(path)
        setattr(native, tried, False)
        lib = getattr(native, loader)()
    return lib


def _load_under_lock():
    """{loader: library or None}, {stage: error text}; never raises."""
    libs, errors = {}, {}
    try:
        from compression_tpu import native
        where = os.path.dirname(os.path.abspath(native.__file__))
        name = "ctpu_native_%s.lock" % hashlib.sha1(
            where.encode()).hexdigest()[:16]
        with open(os.path.join(tempfile.gettempdir(), name), "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            try:
                for loader, *state in LOADERS:
                    try:
                        libs[loader] = _load(native, where, loader, *state)
                    except Exception as e:  # recorded, never raised here
                        errors[loader] = repr(e)
            finally:
                fcntl.flock(lock, fcntl.LOCK_UN)
    except Exception as e:  # recorded, never raised here
        errors["lock"] = repr(e)
    return libs, errors


LIBS, ERRORS = _load_under_lock()
needs_gxx = pytest.mark.skipif(
    shutil.which("g++") is None and shutil.which("c++") is None,
    reason="no C++ compiler: the JAX package cannot build its libraries")
needs_cc = pytest.mark.skipif(
    not any(shutil.which(c) for c in ("cc", "gcc", "clang")),
    reason="no C compiler: the JAX package cannot build _host_codecs.so")


def test_guard_ran_without_error():
    assert ERRORS == {}


@needs_gxx
@pytest.mark.parametrize("loader", ["get_pmf_lib", "get_range_coder_lib"])
def test_cxx_library_loaded(loader):
    """Loaded under the lock, and the JAX package caches the same object."""
    from compression_tpu import native
    assert LIBS.get(loader) is not None
    assert getattr(native, loader)() is LIBS[loader]


@needs_cc
def test_host_codecs_loaded():
    from compression_tpu import native
    assert LIBS.get("get_lib") is not None
    assert native.get_lib() is LIBS["get_lib"]


@pytest.fixture(scope="module")
def gold():
    return dict(np.load(FIXTURE))


@needs_gxx
def test_lsi_tables_equal_golden(gold):
    """A table built in this process equals the TF reference's: the
    location-scale indexed model of golden_em.npz (64 scales)."""
    import jax.numpy as jnp
    from compression_tpu import distributions as dist
    from compression_tpu.entropy_models import (
        LocationScaleIndexedEntropyModel)
    offset = float(gold["lsi__scale_fn_offset"])
    factor = float(gold["lsi__scale_fn_factor"])
    em = LocationScaleIndexedEntropyModel(
        dist.NoisyNormal, int(gold["lsi__num_scales"]),
        lambda i: jnp.exp(offset + factor * jnp.asarray(i, jnp.float32)),
        coding_rank=1, compression=True)
    np.testing.assert_array_equal(np.asarray(em.cdf), gold["lsi__cdf"])
    np.testing.assert_array_equal(np.asarray(em.cdf_offset),
                                  gold["lsi__cdf_offset"])


@needs_gxx
def test_uni_tables_equal_golden(gold):
    """The same for the universal indexed model (15 dither levels x a 3 x 5
    index grid)."""
    import jax.numpy as jnp
    from compression_tpu import distributions as dist
    from compression_tpu.entropy_models import UniversalIndexedEntropyModel
    em = UniversalIndexedEntropyModel(
        dist.NoisyNormal, tuple(gold["uni__index_ranges"]),
        {"loc": lambda i: (i[..., 0] - 1.0) / 2.,
         "scale": lambda i: jnp.exp(i[..., 1] - 1.5)},
        coding_rank=2, compression=True)
    np.testing.assert_array_equal(np.asarray(em.cdf), gold["uni__cdf"])
    np.testing.assert_array_equal(np.asarray(em.cdf_offset),
                                  gold["uni__cdf_offset"])
