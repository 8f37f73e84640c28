"""On-demand native builds: the C++ PMF quantizer, the host range coder,
the host run-length codecs and the CUDA kernels.

Every shared object is compiled from the sources in this package at first
use into ``compression_tpu_torch/_build/`` (git-ignored) and loaded with
ctypes.  A build writes to a per-process temporary name and renames it into
place, so concurrent test workers never load a half-written library.  A
failed build raises: nothing here falls back to another implementation.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(PACKAGE_DIR, "_build")

_LOCK = threading.Lock()
_PMF_LIB = None
_RC_LIB = None
_HOST_CODECS_LIB = None


def stale(out: str, src: str) -> bool:
    return not os.path.exists(out) or (
        os.path.getmtime(out) < os.path.getmtime(src))


def start_build(cmd: list, out: str):
    """Starts ``cmd -o <tmp>`` in the background; pass the result to
    finish_build.  Several builds started together run in parallel."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.Popen(
        list(cmd) + ["-o", tmp], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def finish_build(build, timeout: float = 600) -> None:
    """Waits for a start_build process and moves its output into place."""
    proc, tmp, out = build
    log, _ = proc.communicate(timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(
            f"build of {os.path.basename(out)} failed "
            f"({' '.join(proc.args)}):\n{log}")
    os.replace(tmp, out)


def _build_native(source: str, what: str, compilers, flags) -> str:
    """Builds native/<source> into _build/<stem>.so with the first of
    ``compilers`` found, when the library is missing or older than its
    source; returns its path."""
    src = os.path.join(os.path.dirname(__file__), source)
    out = os.path.join(BUILD_DIR, os.path.splitext(source)[0] + ".so")
    if stale(out, src):
        cc = next(filter(None, map(shutil.which, compilers)), None)
        if cc is None:
            raise RuntimeError(
                f"{' / '.join(compilers)} not found: {what} "
                f"(native/{source}) cannot be built, and it has no "
                "fallback.")
        finish_build(start_build(
            [cc, "-O2", "-shared", "-fPIC", *flags, src], out), timeout=120)
    return out


def _build_cxx(name: str, what: str, flags=()) -> str:
    """native/<name>.cc with g++ (C++17)."""
    return _build_native(f"{name}.cc", what, ("g++",),
                         ("-std=c++17", *flags))


def _build_pmf() -> ctypes.CDLL:
    # Must be libstdc++'s std::sort: equal-key order is the contract.
    lib = ctypes.CDLL(_build_cxx("pmf_quantizer", "the PMF quantizer"))
    lib.pmf_to_quantized_cdf.restype = ctypes.c_int
    lib.pmf_to_quantized_cdf.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_long, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32)]
    return lib


def get_pmf_lib() -> ctypes.CDLL:
    """Returns the native PMF quantizer, building it on first use."""
    global _PMF_LIB
    with _LOCK:
        if _PMF_LIB is None:
            _PMF_LIB = _build_pmf()
    return _PMF_LIB


def _build_range_coder() -> ctypes.CDLL:
    lib = ctypes.CDLL(_build_cxx("range_coder", "the host range coder",
                                 flags=("-pthread",)))
    c_i32p = ctypes.POINTER(ctypes.c_int32)
    c_u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.ctpu_encode_streams.restype = ctypes.c_int
    lib.ctpu_encode_streams.argtypes = [
        c_i32p, c_i32p, ctypes.c_int64, ctypes.c_int64,
        c_i32p, c_i32p, c_i32p, c_u8p, ctypes.c_int64, ctypes.c_int64,
        c_u8p, ctypes.c_int64, c_i32p, ctypes.c_int]
    lib.ctpu_decode_streams.restype = ctypes.c_int
    lib.ctpu_decode_streams.argtypes = [
        c_u8p, c_i32p, ctypes.c_int64, c_i32p,
        ctypes.c_int64, ctypes.c_int64,
        c_i32p, c_i32p, c_i32p, c_u8p, ctypes.c_int64, ctypes.c_int64,
        c_i32p, c_u8p, ctypes.c_int]
    return lib


def get_range_coder_lib() -> ctypes.CDLL:
    """Returns the host range coder (native/range_coder.cc), building it on
    first use; raises when it cannot be built."""
    global _RC_LIB
    with _LOCK:
        if _RC_LIB is None:
            _RC_LIB = _build_range_coder()
    return _RC_LIB


def _build_host_codecs() -> ctypes.CDLL:
    out = _build_native("host_codecs.c", "the run-length codecs",
                        ("cc", "gcc", "clang"), ())
    lib = ctypes.CDLL(out)
    c_i32p = ctypes.POINTER(ctypes.c_int32)
    c_u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.rlg_encode.restype = ctypes.c_long
    lib.rlg_encode.argtypes = [c_i32p, ctypes.c_long, c_u8p, ctypes.c_long]
    lib.rlg_decode.restype = ctypes.c_long
    lib.rlg_decode.argtypes = [c_u8p, ctypes.c_long, c_i32p, ctypes.c_long]
    lib.rl_encode.restype = ctypes.c_long
    lib.rl_encode.argtypes = [
        c_i32p, ctypes.c_long, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        c_u8p, ctypes.c_long]
    lib.rl_decode.restype = ctypes.c_long
    lib.rl_decode.argtypes = [
        c_u8p, ctypes.c_long, c_i32p, ctypes.c_long, ctypes.c_int,
        ctypes.c_int, ctypes.c_int]
    return lib


def get_host_codecs_lib() -> ctypes.CDLL:
    """Returns the run-length codecs (native/host_codecs.c), building them
    with the C compiler on first use; raises when they cannot be built."""
    global _HOST_CODECS_LIB
    with _LOCK:
        if _HOST_CODECS_LIB is None:
            _HOST_CODECS_LIB = _build_host_codecs()
    return _HOST_CODECS_LIB
