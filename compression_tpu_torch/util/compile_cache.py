"""Where the port's native builds are kept (PyTorch counterpart of
compression_tpu/util/compile_cache.py).

The JAX package points XLA's persistent compilation cache at a directory,
so that a process replays compiled programs from disk.  The port compiles
its CUDA kernels (nvcc) and host libraries (g++, cc) into one build
directory, ``native.BUILD_DIR`` (``compression_tpu_torch/_build/`` by
default), and rebuilds a library only when it is missing or older than its
source: that directory already is the persistent cache.  ``enable`` points
it elsewhere.
"""

from __future__ import annotations

import os

from compression_tpu_torch import native

__all__ = ["DEFAULT", "enable"]

DEFAULT = os.path.join(native.PACKAGE_DIR, "_build")


def enable(path: str | None = None):
    """Builds, and loads, the port's native libraries from ``path`` from
    now on (``DEFAULT`` when None; created at the first build).

    Builds are cached per file by their sources' times, so JAX's
    ``min_compile_secs`` has no counterpart and is not taken.  Libraries
    already loaded in this process stay loaded.  Safe to call multiple
    times.
    """
    native.BUILD_DIR = path or DEFAULT
