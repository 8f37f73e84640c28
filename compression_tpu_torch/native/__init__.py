"""On-demand native builds: the C++ PMF quantizer and the CUDA kernels.

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


def _build_pmf() -> ctypes.CDLL:
    src = os.path.join(os.path.dirname(__file__), "pmf_quantizer.cc")
    out = os.path.join(BUILD_DIR, "pmf_quantizer.so")
    if stale(out, src):
        # Must be libstdc++'s std::sort: equal-key order is the contract.
        cxx = shutil.which("g++")
        if cxx is None:
            raise RuntimeError(
                "g++ not found: the PMF quantizer (native/pmf_quantizer.cc) "
                "cannot be built, and table construction has no fallback.")
        finish_build(start_build(
            [cxx, "-O2", "-std=c++17", "-shared", "-fPIC", src], out),
            timeout=120)
    lib = ctypes.CDLL(out)
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
