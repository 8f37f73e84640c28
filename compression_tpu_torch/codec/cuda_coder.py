"""The range coder's hand-written CUDA kernels, their wrappers and plain
PyTorch versions (counterpart of compression_tpu/codec/pallas_coder.py).

Nine kernels from three sources in ``csrc/``; the coders run one thread per
coder stream over one copy of the encoder recurrence and one of the
decoder's (the two indexed decoders K2 and K3', the micro-op scan and the
two symbol encoders K1 and K6' also one warp per stream, see below), the
pair lookup four elements per thread:

* ``encode_indexed`` (K1) replaces ``pallas_coder.encode_indexed_device``
  with its fused chunk post-pass: a CDF row per element, escapes coded as
  the bare marker (the native container's sidecar format).  Like K3' it
  has two kernels, picked by the stream count alone: launches of at most
  ``WARP_ENCODE_MAX_STREAMS`` streams take the warp-per-stream kernel,
  which runs the micro-op scan's chain on the symbols' CDF intervals,
  larger ones the thread-per-stream kernel.  ``encode_indexed_warp`` /
  ``encode_indexed_thread`` run one variant whatever the shape;
  ``encode_indexed_warp_plain`` mirrors the warp kernel on the CPU.
* ``decode_indexed`` (K2) replaces
  ``pallas_coder.decode_indexed_pallas(in_stream_gamma=False)``.  Like
  K3' it has two kernels, picked by the stream count alone: launches of at
  most ``WARP_DECODE_MAX_STREAMS`` streams (every native container's) take
  the warp-per-stream kernel, K3''s with the escape's decode compiled out,
  larger ones the thread-per-stream kernel.  ``decode_indexed_warp`` /
  ``decode_indexed_thread`` run one variant whatever the shape;
  ``decode_indexed_warp_plain`` mirrors the warp kernel's search on the
  CPU.
* ``encode_single_row`` (K4') replaces
  ``pallas_coder.encode_single_row_device``: one shared row, no overflow.
  One thread per stream on the warp scan's 32-bit chain, symbols and
  packed operands loaded ahead of it, bytes stored 16 at a time;
  ``encode_single_row_chain_plain`` mirrors it on the CPU.
* ``decode_single_row`` (K5') replaces ``pallas_coder.decode_scan_pallas_v2``.
  One thread per stream; a symbol is one load from a slot table laid out
  by threshold (``single_row_slots``, kept by
  ``DeviceCdfTable.single_row_slots``); ``decode_single_row_slot_plain``
  mirrors it on the CPU.
* ``encode_gamma`` (K6') replaces ``pallas_coder.encode_scan_pallas`` over
  the micro-ops of ``jax_coder.micro_ops_from_symbols``: escapes followed
  in the stream by their Elias-gamma magnitude and sign (the reference
  .tfci format).  Two kernels, as K1's (``encode_gamma_warp`` /
  ``encode_gamma_thread``; ``encode_gamma_warp_plain`` on the CPU): the
  warp kernel expands an escape in place into its precision-1 steps.
* ``decode_gamma`` (K3') replaces
  ``pallas_coder.decode_indexed_pallas(in_stream_gamma=True)``.  It has two
  kernels for the one function.  A coder stream is a serial chain, so a
  launch of few streams (a classic .tfci container is one stream per
  latent) leaves a thread-per-stream kernel on a single lane of the card:
  launches of at most ``WARP_DECODE_MAX_STREAMS`` streams take the
  warp-per-stream kernel, in which the 32 lanes find a symbol with one
  round of independent probes over the table in the 16-bit layout of
  ``warp_table``; larger launches keep the thread-per-stream kernel.
  ``decode_gamma_warp`` / ``decode_gamma_thread`` run one variant whatever
  the shape (for tests and measurements).

* ``encode_scan`` (K6, micro-op mode) is ``pallas_coder.encode_scan_pallas``
  as the JAX package calls it: it reads precomputed micro-ops ``(lower,
  upper, prec, mask)`` [T, S] and writes the streams' bytes.  Like K3' it
  has two kernels, picked by the stream count alone: launches of at most
  ``WARP_ENCODE_MAX_STREAMS`` streams take the warp-per-stream kernel (the
  32 lanes carry one stream's chain together, in 32-bit arithmetic, and
  store its bytes 64 at a time), larger ones the thread-per-stream kernel.
  ``encode_scan_warp`` / ``encode_scan_thread`` run one variant whatever
  the shape; ``encode_scan_warp_plain`` mirrors the warp kernel's
  arithmetic and emission on the CPU, for the tests.
* ``pair_lookup`` (K7') replaces ``pallas_coder.pair_lookup_pallas``:
  ``(flat[i], flat[i + 1])`` for flat table indices, the encoder prep of
  ``gamma_micro_ops``.
* ``decode_single_row_bucketed`` (K8') replaces
  ``pallas_coder.decode_scan_pallas`` (v1): the single-row decode with the
  two-level bucketed search, a second decoder independent of K5'.  One
  thread per stream on K5''s byte ring and threshold, then 32-bit counts
  over the buckets and the window.

K1, K4', K6' and the micro-op mode are in ``csrc/encode_indexed.cu``; K2,
K5', K3' and K8' in ``csrc/decode_indexed.cu``; K7' in
``csrc/pair_lookup.cu``.

Each wrapper checks its inputs, allocates the outputs with ``torch.empty``
and then runs the plain version when the tensors lie on the CPU, or
launches the kernel on the current CUDA stream (and adds one to
``LAUNCHES[name]``) when they lie on a CUDA device.  There is no fallback
between the two: a CUDA tensor reaches the kernel or an exception.
``LAUNCHES_WARP[name]`` counts those of the launches of K1, K2, K3', K6'
and K6's micro-op mode that took the warp-per-stream kernel.

The kernels are compiled by ``nvcc`` for ``sm_90a`` at first use (or by
``build()``), one process per source started together, into the package's
git-ignored ``_build/`` directory, and bound with ctypes through a plain C
interface that returns ``cudaGetLastError()``.

The coder kernels take the table in the padded dense layout of
``tables.CdfTable`` (int32 ``cdf[num_rows, max_len]``, rows padded with
their terminal value) plus an int32 ``meta[num_rows, 3]`` of (escape marker
``length - 2``, precision, overflow flag) per row; the single-row kernels
take a table of one row, K5' also its slot table, K8' that row in 16-entry
buckets (``bucketize_row``).

The plain versions of the coders are vectorized over streams and take one
step per coded interval; a step never waits for the device, so that on a
CUDA device a long run is replayed from a CUDA graph (``_run_steps``).
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import threading

import torch
import torch.nn.functional as F

from compression_tpu_torch import native
from compression_tpu_torch.util import profiling

__all__ = [
    "LAUNCHES",
    "build",
    "encode_indexed",
    "encode_indexed_warp",
    "encode_indexed_thread",
    "decode_indexed",
    "decode_indexed_warp",
    "decode_indexed_thread",
    "encode_single_row",
    "decode_single_row",
    "encode_gamma",
    "encode_gamma_warp",
    "encode_gamma_thread",
    "decode_gamma",
    "decode_gamma_warp",
    "decode_gamma_thread",
    "encode_scan",
    "encode_scan_warp",
    "encode_scan_thread",
    "pair_lookup",
    "decode_single_row_bucketed",
    "encode_indexed_plain",
    "encode_indexed_warp_plain",
    "decode_indexed_plain",
    "decode_indexed_warp_plain",
    "encode_single_row_plain",
    "encode_single_row_chain_plain",
    "decode_single_row_plain",
    "decode_single_row_slot_plain",
    "single_row_slots",
    "single_row_threshold_plain",
    "encode_gamma_plain",
    "encode_gamma_warp_plain",
    "decode_gamma_plain",
    "decode_gamma_warp_plain",
    "warp_table",
    "warp_search_plain",
    "encode_scan_plain",
    "encode_scan_warp_plain",
    "pair_lookup_plain",
    "decode_single_row_bucketed_plain",
    "bucketize_row",
    "interval_counts",
    "gamma_micro_ops",
]

#: Kernel launches per wrapper since the counts were last reset.
LAUNCHES = {"encode_indexed": 0, "decode_indexed": 0,
            "encode_single_row": 0, "decode_single_row": 0,
            "encode_gamma": 0, "decode_gamma": 0,
            "encode_scan": 0, "pair_lookup": 0,
            "decode_single_row_bucketed": 0}

#: Of ``LAUNCHES[name]`` for the five functions that have two kernels, the
#: launches of the warp-per-stream kernel.
LAUNCHES_WARP = {"decode_indexed": 0, "decode_gamma": 0, "encode_scan": 0,
                 "encode_gamma": 0, "encode_indexed": 0}

#: K2 and K3' launches of at most this many streams take their
#: warp-per-stream kernels, larger ones their thread-per-stream kernels.
#: Measured on an NVIDIA H100 80GB HBM3 (700 W) by chip_smoke.py, streams x
#: 512 symbols on 64 Gaussian overflow rows, warp / thread ms.  K3': 1 x 512
#: 0.114 / 0.520, 1024 0.130 / 0.682, 4096 0.302 / 0.684, 8192 0.546 /
#: 0.974, 16384 1.05 / 1.94, 24576 1.56 / 0.852, 32768 2.05 / 0.856, 65536
#: 3.99 / 1.68; one stream of 131072 symbols 18.9 / 83.4.  K2: 1 0.094 /
#: 0.482, 256 0.095 / 0.589, 1024 0.105 / 0.597, 4096 0.324 / 0.597, 8192
#: 0.640 / 0.883, 16384 1.22 / 1.77, 16896 1.22 / 0.720, 32768 2.35 /
#: 0.769, 65536 4.64 / 1.51.  Both warp kernels lead up to 16384 streams;
#: from 16896 on the thread kernels run 128-thread blocks, fill the card
#: and lead.
WARP_DECODE_MAX_STREAMS = 16384

#: K6 micro-op, K6' and K1 launches of at most this many streams take
#: their warp-per-stream kernels, larger ones their thread-per-stream
#: kernels.  Measured on an NVIDIA H100 80GB HBM3 (700 W) by chip_smoke.py,
#: warp / thread ms.  The micro-op scan, streams x 590 steps of the Gaussian
#: regime: 1 0.079 / 0.120, 1024 0.070 / 0.344, 4096 0.171 / 0.481, 8192
#: 0.320 / 0.655, 16384 0.611 / 0.751, 24576 0.888 / 0.884, 32768 1.18 /
#: 0.960, 65536 2.31 / 1.48; bmshj2018's y scan, 198848 steps x 1, 10.28 /
#: 36.1.  K6' and K1, streams x 512 symbols of the same regime (the first
#: of two rounds): 1 0.051 / 0.180 and 0.047 / 0.164, 1024 0.074 / 0.333
#: and 0.059 / 0.247, 8192 0.489 / 0.515 and 0.419 / 0.430, 12288 0.716 /
#: 0.961 and 0.624 / 0.822, 16384 0.947 / 0.974 and 0.828 / 0.831, 16896
#: 0.972 / 0.476 and 0.850 / 0.420, 65536 3.65 / 1.29 and 3.23 / 1.25; one
#: stream of 131072 symbols (bls2017's classic latent) 7.00 / 33.0 and
#: 6.87 / 29.3.  Every warp kernel leads or draws up to 16384 streams; from
#: 16896 on the thread kernels run 128-thread blocks, fill the card and
#: lead (a thread kernel steps 32 streams with the instructions a warp
#: kernel spends on one).
WARP_ENCODE_MAX_STREAMS = 16384

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_M32 = 0xFFFFFFFF
_LOCK = threading.Lock()
_LIBS: dict = {}
#: The device's SM count, read once by ``build()`` (the pair lookup's grid
#: is capped at a few blocks per SM).
_DEVICE = {"sm_count": 0}

_vp, _i64, _int = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_ENCODE_ARGS = [_vp, _vp, _i64, _i64, _vp, _vp, _int, _int, _vp, _i64, _vp,
                _vp]
_DECODE_ARGS = [_vp, _i64, _vp, _vp, _i64, _i64, _vp, _vp, _int, _int, _vp,
                _vp, _vp]
_DECODE_WARP_ARGS = [_vp, _i64, _vp, _vp, _i64, _i64, _vp, _i64, _int,
                     _int, _vp, _vp, _vp]
_ARGTYPES = {
    "ctpu_encode_indexed": _ENCODE_ARGS,
    "ctpu_encode_gamma": _ENCODE_ARGS,
    "ctpu_encode_indexed_warp": _ENCODE_ARGS,
    "ctpu_encode_gamma_warp": _ENCODE_ARGS,
    "ctpu_encode_single_row": [_vp, _i64, _i64, _vp, _vp, _int, _vp, _i64,
                               _vp, _vp],
    "ctpu_decode_indexed": _DECODE_ARGS,
    "ctpu_decode_gamma": _DECODE_ARGS,
    "ctpu_decode_single_row": [_vp, _i64, _vp, _i64, _i64, _vp, _i64, _int,
                               _int, _vp, _vp, _vp],
    "ctpu_encode_scan": [_vp, _vp, _vp, _vp, _i64, _i64, _vp, _i64, _vp,
                         _vp],
    "ctpu_encode_scan_warp": [_vp, _vp, _vp, _vp, _i64, _i64, _vp, _i64,
                              _vp, _vp],
    "ctpu_decode_gamma_warp": _DECODE_WARP_ARGS,
    "ctpu_decode_indexed_warp": _DECODE_WARP_ARGS,
    "ctpu_pair_lookup": [_vp, _i64, _vp, _i64, _vp, _vp, _int, _vp],
    "ctpu_decode_single_row_bucketed": [_vp, _i64, _vp, _i64, _i64, _vp, _vp,
                                        _int, _int, _int, _vp, _vp, _vp],
}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built.")


def build() -> dict:
    """Builds (if stale) and loads every kernel library; returns them by
    source name.  One nvcc per source, all started together."""
    with _LOCK:
        sources = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))
        outs = {os.path.splitext(os.path.basename(s))[0]:
                (s, os.path.join(native.BUILD_DIR,
                                 os.path.basename(s)[:-3] + ".so"))
                for s in sources}
        stale = [(src, out) for src, out in outs.values()
                 if native.stale(out, src)]
        if stale:
            nvcc = _nvcc()
            builds = [native.start_build([nvcc] + NVCC_FLAGS + [src], out)
                      for src, out in stale]
            for b in builds:
                native.finish_build(b)
        for name, (_, out) in outs.items():
            if name not in _LIBS:
                lib = ctypes.CDLL(out)
                for fn, argtypes in _ARGTYPES.items():
                    if hasattr(lib, fn):
                        getattr(lib, fn).argtypes = argtypes
                        getattr(lib, fn).restype = ctypes.c_int
                _LIBS[name] = lib
        if not _DEVICE["sm_count"]:
            _DEVICE["sm_count"] = torch.cuda.get_device_properties(
                torch.cuda.current_device()).multi_processor_count
        return dict(_LIBS)


def _lib(name):
    lib = _LIBS.get(name)
    return lib if lib is not None else build()[name]


def _check(name, t, dtype, ndim, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor")
    if t.dtype != dtype or t.ndim != ndim:
        raise ValueError(
            f"{name} must be {dtype} of rank {ndim}, got {t.dtype} "
            f"rank {t.ndim}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_table(cdf, meta, device, single_row=False):
    _check("cdf", cdf, torch.int32, 2, device)
    _check("meta", meta, torch.int32, 2, device)
    if meta.shape != (cdf.shape[0], 3) or cdf.shape[1] < 2:
        raise ValueError(
            f"table shapes cdf {tuple(cdf.shape)} / meta {tuple(meta.shape)}")
    if single_row and cdf.shape[0] != 1:
        raise ValueError(f"a single-row kernel got {cdf.shape[0]} rows")


def _device_kind(device):
    if device.type == "cpu":
        return "cpu"
    if device.type == "cuda":
        return "cuda"
    raise ValueError(f"unsupported device {device}")


def _launch(name, fn, *args):
    """Calls the C entry point ``fn`` of kernel ``name`` on the current
    stream of the device of the first tensor argument."""
    device = args[0].device
    c_args = [a.data_ptr() if isinstance(a, torch.Tensor) else a
              for a in args]
    with profiling.span("coder", f"launch.{name}", "dispatch"):
        if device.index == torch.cuda.current_device():
            rc = fn(*c_args, torch.cuda.current_stream().cuda_stream)
        else:
            with torch.cuda.device(device):
                rc = fn(*c_args,
                        torch.cuda.current_stream(device).cuda_stream)
    LAUNCHES[name] += 1
    if rc != 0:
        raise RuntimeError(f"{name} kernel failed: CUDA error {rc}")


# -----------------------------------------------------------------------------
# Encoders: K1, K4', K6'
# -----------------------------------------------------------------------------
def _encode(name, symbols, indexes, cdf, meta, out_size, plain, warp=False):
    """Checks, allocates and runs an encoder; ``warp`` picks the
    warp-per-stream kernel of K1 or K6'."""
    device = symbols.device
    _check("symbols", symbols, torch.int32, 2, device)
    single = indexes is None
    if not single:
        _check("indexes", indexes, torch.int32, 2, device)
        if indexes.shape != symbols.shape:
            raise ValueError("symbols and indexes must have the same shape")
    _check_table(cdf, meta, device, single_row=single)
    num_streams, n = symbols.shape
    if out_size < 2 * n + 2:
        raise ValueError(f"out_size {out_size} < 2 * {n} + 2")
    out = torch.empty((num_streams, out_size), dtype=torch.uint8,
                      device=device)
    lengths = torch.empty((num_streams,), dtype=torch.int32, device=device)
    if _device_kind(device) == "cpu":
        if single:
            plain(symbols, cdf, meta, out, lengths)
        else:
            plain(symbols, indexes, cdf, meta, out, lengths)
        return out, lengths
    fn = getattr(_lib("encode_indexed"),
                 "ctpu_" + name + ("_warp" if warp else ""))
    if single:
        _launch(name, fn, symbols, num_streams, n, cdf, meta, cdf.shape[1],
                out, out_size, lengths)
    else:
        _launch(name, fn, symbols, indexes, num_streams, n, cdf, meta,
                cdf.shape[0], cdf.shape[1], out, out_size, lengths)
    if warp:
        LAUNCHES_WARP[name] += 1
    return out, lengths


def _takes_warp(symbols):
    return symbols.ndim == 2 and symbols.shape[0] <= WARP_ENCODE_MAX_STREAMS


def encode_indexed(symbols, indexes, cdf, meta, out_size: int):
    """K1: range-encodes every stream with a CDF row per element, escapes
    as the bare marker (sidecar format).

    Args:
      symbols: int32 [S, N]; out-of-range values map to the escape marker
        on overflow rows and are clipped on bounded rows.
      indexes: int32 [S, N] CDF row per element.
      cdf, meta: the table (see module docstring); every row a valid CDF
        (strictly increasing from 0 to 2^precision, as every
        ``tables.CdfTable`` row is) at precision 1 ... 16.
      out_size: bytes per output row, >= 2 * N + 2.

    Returns:
      (bytes uint8 [S, out_size] zero past each length, lengths int32 [S]).

    The number of streams alone picks the kernel: at most
    ``WARP_ENCODE_MAX_STREAMS`` take ``encode_indexed_warp``, more take
    ``encode_indexed_thread``.  The warp kernel's 32-bit chain is exact
    where every coded interval is valid (``0 <= lower < upper <=
    2^precision``), which the table's contract above gives; nothing checks
    it, so that the encode never waits for the card.
    """
    if _takes_warp(symbols):
        return encode_indexed_warp(symbols, indexes, cdf, meta, out_size)
    return encode_indexed_thread(symbols, indexes, cdf, meta, out_size)


def encode_indexed_thread(symbols, indexes, cdf, meta, out_size: int):
    """K1 by its thread-per-stream kernel (arguments and result as
    ``encode_indexed``); on the CPU ``encode_indexed_plain``."""
    return _encode("encode_indexed", symbols, indexes, cdf, meta, out_size,
                   encode_indexed_plain)


def encode_indexed_warp(symbols, indexes, cdf, meta, out_size: int):
    """K1 by its warp-per-stream kernel (arguments and result as
    ``encode_indexed``); on the CPU ``encode_indexed_plain``."""
    return _encode("encode_indexed", symbols, indexes, cdf, meta, out_size,
                   encode_indexed_plain, warp=True)


def encode_single_row(symbols, cdf, meta, out_size: int):
    """K4': range-encodes every stream with the table's one row; symbols
    are clipped to [0, length - 2].  cdf [1, L] / meta [1, 3]; other
    arguments and the result as for ``encode_indexed``.  On the CPU
    ``encode_single_row_chain_plain``, the kernel's arithmetic."""
    return _encode("encode_single_row", symbols, None, cdf, meta, out_size,
                   encode_single_row_chain_plain)


def encode_gamma(symbols, indexes, cdf, meta, out_size: int):
    """K6': the reference format's encode.  As ``encode_indexed``, but an
    escape on an overflow row is followed by its Elias-gamma magnitude and
    sign, each bit at precision 1.

    ``out_size`` must hold 2 * T + 2 bytes, T the most coded intervals of
    any stream (``interval_counts(...).sum(1).max()``); the kernels never
    write past a row, but a shorter row may cut a stream: its bytes are
    then undefined and its length is past the row.  The table's contract
    and the choice of kernel are those of ``encode_indexed``
    (``encode_gamma_warp`` up to ``WARP_ENCODE_MAX_STREAMS`` streams, else
    ``encode_gamma_thread``); every Elias-gamma step is a valid interval
    too.
    """
    if _takes_warp(symbols):
        return encode_gamma_warp(symbols, indexes, cdf, meta, out_size)
    return encode_gamma_thread(symbols, indexes, cdf, meta, out_size)


def encode_gamma_thread(symbols, indexes, cdf, meta, out_size: int):
    """K6' by its thread-per-stream kernel (arguments and result as
    ``encode_gamma``); on the CPU ``encode_gamma_plain``."""
    return _encode("encode_gamma", symbols, indexes, cdf, meta, out_size,
                   encode_gamma_plain)


def encode_gamma_warp(symbols, indexes, cdf, meta, out_size: int):
    """K6' by its warp-per-stream kernel (arguments and result as
    ``encode_gamma``); on the CPU ``encode_gamma_plain``."""
    return _encode("encode_gamma", symbols, indexes, cdf, meta, out_size,
                   encode_gamma_plain, warp=True)


def interval_counts(symbols, indexes, meta):
    """Coded intervals per element in the reference format (int64 [S, N]):
    1, or 3 + 2 * floor(log2 g) for an escape with Elias-gamma magnitude g,
    as jax_coder.encode_streams budgets them.  Also returns (escape bool,
    g int64, nbits int64), each [S, N]."""
    rows = indexes.long().clamp(0, meta.shape[0] - 1)
    v = symbols.long()
    maxs, _, ovf_r = meta.long().unbind(1)
    mv = maxs[rows]
    ovf = ovf_r[rows] != 0
    sign = ovf & (v < 0)
    over = ovf & ~sign & (v >= mv)
    escape = sign | over
    g = torch.where(sign, -v, torch.where(over, v - mv + 1, 1)) & _M32
    nbits = _floor_log2(g.clamp(min=1))
    return torch.where(escape, 3 + 2 * nbits, 1), escape, g, nbits


def _floor_log2(x):
    """Exact floor(log2(x)) for int64 1 <= x < 2^32."""
    n = torch.zeros_like(x)
    for s in (16, 8, 4, 2, 1):
        m = x >= (1 << s)
        n = n + m.long() * s
        x = torch.where(m, x >> s, x)
    return n


def _main_intervals(symbols, rows, cdf, meta, bounded):
    """(lower, upper, precision) int64 [S, N] of each element's symbol or
    escape marker; ``bounded`` clips every row as a bounded one."""
    max_len = cdf.shape[1]
    flat = cdf.reshape(-1).long()
    maxs, prec_r, ovf_r = meta.long().unbind(1)
    v = symbols.long()
    mx = maxs[rows]
    ovf = torch.zeros_like(v, dtype=torch.bool) if bounded else \
        ovf_r[rows] != 0
    vq = torch.where(v < 0, torch.where(ovf, mx, 0), torch.minimum(v, mx))
    pos = rows * max_len + vq
    return flat[pos], flat[pos + 1], prec_r[rows]


def encode_indexed_plain(symbols, indexes, cdf, meta, out, lengths):
    """Plain PyTorch version of K1 (writes out, lengths)."""
    rows = indexes.long().clamp(0, cdf.shape[0] - 1)
    lo, hi, prec = _main_intervals(symbols, rows, cdf, meta, bounded=False)
    _encode_plain(lo.t(), hi.t(), prec.t(), None, out, lengths)


def encode_single_row_plain(symbols, cdf, meta, out, lengths):
    """Plain PyTorch version of K4' (writes out, lengths): the reference
    recurrence."""
    rows = torch.zeros_like(symbols, dtype=torch.int64)
    lo, hi, prec = _main_intervals(symbols, rows, cdf, meta, bounded=True)
    _encode_plain(lo.t(), hi.t(), prec.t(), None, out, lengths)


def _chain_serves_row(cdf, meta):
    """Whether K4''s 32-bit chain serves the row: precision 1 ... 16, the
    marker within the row, and every symbol's interval valid (0 <= lower <
    upper <= 2^precision, so no symbol of probability zero).  The kernel
    decides the same on the card; here it costs a copy to the host."""
    row = cdf[0].long()
    marker, prec = int(meta[0, 0]), int(meta[0, 1])
    if not (1 <= prec <= 16 and 0 <= marker <= row.shape[0] - 2):
        return False
    lo, hi = row[:-1], row[1:]
    return bool(((lo >= 0) & (lo < hi) & (hi <= 1 << prec)).all())


def encode_single_row_chain_plain(symbols, cdf, meta, out, lengths):
    """Plain mirror of K4''s kernel (writes out, lengths): each symbol's
    interval packed at precision 16 (``scan_op``) and the recurrence on the
    32-bit chain (``_encode_plain`` with ``ops``); a row the chain does not
    serve (``_chain_serves_row``) takes the reference recurrence, as the
    kernel does.  The same bytes as ``encode_single_row_plain``."""
    if not _chain_serves_row(cdf, meta):
        encode_single_row_plain(symbols, cdf, meta, out, lengths)
        return
    rows = torch.zeros_like(symbols, dtype=torch.int64)
    ops = scan_op(*_main_intervals(symbols, rows, cdf, meta, bounded=True))
    _encode_plain(None, None, None, None, out, lengths, ops=ops.t())


def encode_gamma_plain(symbols, indexes, cdf, meta, out, lengths):
    """Plain PyTorch version of K6' (writes out, lengths): the micro-op
    expansion of ``gamma_micro_ops`` run through the plain recurrence."""
    encode_scan_plain(*gamma_micro_ops(symbols, indexes, cdf, meta), out,
                      lengths)


def gamma_micro_ops(symbols, indexes, cdf, meta, num_steps=None, slots=None,
                    lookup=None):
    """Torch port of jax_coder.micro_ops_from_symbols: every element's
    coded intervals, compacted per stream.

    Args:
      symbols, indexes: int32 [S, N].
      cdf, meta: the table.
      num_steps: scan length T (default: the most intervals of any stream,
        which costs a copy to the host).  Intervals past T are dropped.
      slots: micro-op slots K per element (default: the most any element
        needs, which costs a copy to the host).  With ``slots=1`` escapes
        are coded as the bare marker; an escape that needs more than K
        slots is cut after K (the caller's ``ok`` flag reports it).  With
        both given, nothing is copied to the host.
      lookup: the pair lookup, ``pair_lookup_plain`` (default) or
        ``pair_lookup`` (K7' on CUDA tensors).

    Returns:
      (lower, upper, precision int32, mask bool), each [T, S]; padding
      steps are (0, 1, 1, False) as in the JAX package.
    """
    lookup = pair_lookup_plain if lookup is None else lookup
    dev = symbols.device
    num_streams, n = symbols.shape
    max_len = cdf.shape[1]
    flat = cdf.reshape(-1)
    rows = indexes.long().clamp(0, cdf.shape[0] - 1)
    maxs, prec_r, ovf_r = meta.long().unbind(1)
    v = symbols.long()
    if slots is None or num_steps is None:
        count = interval_counts(symbols, indexes, meta)[0]
        if slots is None:
            slots = int(count.max()) if count.numel() else 1
        if num_steps is None:
            num_steps = int(count.sum(1).max()) if count.numel() else 0
    slots, num_steps = int(slots), int(num_steps)

    def table_index(v, rows):
        # Escape map: marker on overflow rows, clip on bounded rows.
        mx = maxs[rows]
        vq = torch.where(v < 0, torch.where(ovf_r[rows] != 0, mx, 0),
                         torch.minimum(v, mx))
        return (rows * max_len + vq).to(torch.int32).contiguous()

    if slots == 1:
        # One interval per element: work in the scan's [N, S] layout and
        # pad the step axis (identity compaction).
        if num_steps < n:
            raise ValueError(f"num_steps {num_steps} < {n} elements")
        rows_t = rows.t()
        c_lo, c_hi = lookup(flat, table_index(v.t(), rows_t))
        pad = (0, 0, 0, num_steps - n)
        mask = torch.ones((n, num_streams), dtype=torch.bool, device=dev)
        return (F.pad(c_lo, pad, value=0), F.pad(c_hi, pad, value=1),
                F.pad(prec_r[rows_t].to(torch.int32), pad, value=1),
                F.pad(mask, pad, value=False))

    count, escape, g, nbits = interval_counts(symbols, indexes, meta)
    c_lo, c_hi = lookup(flat, table_index(v, rows))
    # Slot k of an element: 0 its symbol or marker; for an escape then
    # k <= nb unary zeros, the nb + 1 bits of g from the top one down, and
    # the sign.
    k = torch.arange(slots, device=dev)[None, None, :]
    nb = nbits[..., None]
    bit = (g[..., None] >> (2 * nb + 1 - k).clamp(0, 31)) & 1
    sgn = (escape & (v < 0)).long()[..., None]
    tail = torch.where(k <= nb, 0, torch.where(k <= 2 * nb + 1, bit, sgn))
    main = k == 0
    lower = torch.where(main, c_lo.long()[..., None], tail)
    upper = torch.where(main, c_hi.long()[..., None], tail + 1)
    prec = torch.where(main, prec_r[rows][..., None], 1)
    # Compact: slot k of element j lands at the stream's running interval
    # count; inactive slots and those past T park in an extra column.
    pos = (count.cumsum(1) - count)[..., None] + k
    keep = (k < count[..., None]) & (pos < num_steps)
    pos = torch.where(keep, pos, num_steps)
    target = (torch.arange(num_streams, device=dev)[:, None, None]
              * (num_steps + 1) + pos).reshape(-1)

    def scatter(vals, fill, dtype):
        out = torch.full((num_streams * (num_steps + 1),), fill, dtype=dtype,
                         device=dev)
        out[target] = vals.reshape(-1).to(dtype)
        return out.reshape(num_streams, num_steps + 1)[:, :num_steps].t()

    return (scatter(lower, 0, torch.int32), scatter(upper, 1, torch.int32),
            scatter(prec, 1, torch.int32),
            scatter(keep.expand(pos.shape), False, torch.bool))


def pair_lookup(flat, idx):
    """K7': ``(flat[idx], flat[idx + 1])`` for flat table indices.

    Args:
      flat: int32 [K] the CDF table flattened (``cdf.reshape(-1)``), K >= 2.
      idx: int32 [R, C] indices in [0, K - 2].

    Returns:
      (c_lo, c_hi) int32 [R, C].  On the CPU an index outside [0, K - 2]
      raises ValueError; the kernel clamps it into that range (it checks
      nothing, so a bad index gives a wrong pair, never a read outside the
      table).
    """
    device = flat.device
    _check("flat", flat, torch.int32, 1, device)
    _check("idx", idx, torch.int32, 2, device)
    if flat.shape[0] < 2:
        raise ValueError("the flat table needs at least two entries")
    if _device_kind(device) == "cpu":
        if idx.numel() and (int(idx.min()) < 0
                            or int(idx.max()) > flat.shape[0] - 2):
            raise ValueError("table index outside [0, K - 2]")
        return pair_lookup_plain(flat, idx)
    # Two allocations: one of [2, R, C] and its two views was measured
    # slower on the host, and leaves the second output unaligned where the
    # count is no multiple of four.
    c_lo, c_hi = torch.empty_like(idx), torch.empty_like(idx)
    _launch("pair_lookup", _lib("pair_lookup").ctpu_pair_lookup, flat,
            flat.shape[0], idx, idx.numel(), c_lo, c_hi,
            8 * _DEVICE["sm_count"])
    return c_lo, c_hi


def pair_lookup_plain(flat, idx):
    """Plain PyTorch version of K7' (indices clamped as the kernel's)."""
    i = idx.long().clamp(0, flat.shape[0] - 2)
    return flat[i], flat[i + 1]


def encode_scan(lower, upper, prec, mask, out_size: int):
    """K6 in its micro-op mode: runs the encoder recurrence over
    precomputed intervals (the output of ``gamma_micro_ops``).

    Args:
      lower, upper, prec: int32 [T, S] (the uint32 values of the JAX
        package; they stay below 2^17).
      mask: bool [T, S]; False steps code nothing.
      out_size: bytes per output row, >= 2 * T + 2.

    Returns:
      (bytes uint8 [S, out_size] zero past each length, lengths int32 [S]).

    The number of streams alone picks the kernel: at most
    ``WARP_ENCODE_MAX_STREAMS`` take ``encode_scan_warp``, more take
    ``encode_scan_thread``.

    Every coded step must hold a valid interval, ``0 <= lower < upper <=
    2^prec`` with ``1 <= prec <= 16``, as the reference ``RangeEncoder``
    requires (it checks this only in debug builds); every micro-op of a CDF
    table and of an Elias-gamma bit does.  The bytes of a stream with any
    other coded step are undefined, and the two kernels may differ on them
    (the warp kernel's 32-bit arithmetic is exact on valid intervals only).
    Nothing checks this, so that the scan never waits for the card.
    """
    if lower.ndim == 2 and lower.shape[1] <= WARP_ENCODE_MAX_STREAMS:
        return encode_scan_warp(lower, upper, prec, mask, out_size)
    return encode_scan_thread(lower, upper, prec, mask, out_size)


def encode_scan_thread(lower, upper, prec, mask, out_size: int):
    """K6's micro-op mode by its thread-per-stream kernel (arguments and
    result as ``encode_scan``); on the CPU ``encode_scan_plain``."""
    return _encode_scan(lower, upper, prec, mask, out_size, False)


def encode_scan_warp(lower, upper, prec, mask, out_size: int):
    """K6's micro-op mode by its warp-per-stream kernel (arguments and
    result as ``encode_scan``); on the CPU ``encode_scan_plain``."""
    return _encode_scan(lower, upper, prec, mask, out_size, True)


def _encode_scan(lower, upper, prec, mask, out_size, warp):
    device = lower.device
    for name, t in (("lower", lower), ("upper", upper), ("prec", prec)):
        _check(name, t, torch.int32, 2, device)
    _check("mask", mask, torch.bool, 2, device)
    if not (lower.shape == upper.shape == prec.shape == mask.shape):
        raise ValueError("lower, upper, prec and mask must share a shape")
    num_steps, num_streams = lower.shape
    if out_size < 2 * num_steps + 2:
        raise ValueError(f"out_size {out_size} < 2 * {num_steps} + 2")
    out = torch.empty((num_streams, out_size), dtype=torch.uint8,
                      device=device)
    lengths = torch.empty((num_streams,), dtype=torch.int32, device=device)
    if _device_kind(device) == "cpu":
        encode_scan_plain(lower, upper, prec, mask, out, lengths)
        return out, lengths
    lib = _lib("encode_indexed")
    fn = lib.ctpu_encode_scan_warp if warp else lib.ctpu_encode_scan
    _launch("encode_scan", fn, lower, upper, prec, mask, num_steps,
            num_streams, out, out_size, lengths)
    if warp:
        LAUNCHES_WARP["encode_scan"] += 1
    return out, lengths


def encode_scan_plain(lower, upper, prec, mask, out, lengths):
    """Plain PyTorch version of the micro-op mode (writes out, lengths)."""
    _encode_plain(lower.long(), upper.long(), prec.long(), mask, out, lengths)


def encode_scan_warp_plain(lower, upper, prec, mask, out, lengths):
    """Plain mirror of K6's warp-per-stream micro-op kernel (writes out,
    lengths): the same bytes as ``encode_scan_plain``, by the kernel's own
    steps, for the tests.  Per stream and window of 32 steps: the mask's
    ballot and the search that hands lane i the i-th coded step, the
    operands packed at precision 16, the 32-bit chain, the predicated
    step, the chunks held one a lane and stored 32 at a time (fill runs
    through the same window); then Finalize.  Python
    integers with explicit 32-bit masks; slow, and meant for small inputs.
    The coded steps' intervals must be valid (``0 <= lower < upper <=
    2^prec``, ``1 <= prec <= 16``)."""
    lo_all, hi_all, pr_all = (t.cpu().numpy().astype("int64")
                              for t in (lower, upper, prec))
    m_all = mask.cpu().numpy()
    num_steps, num_streams = lo_all.shape
    width = out.shape[1]
    rows = torch.zeros((num_streams, width), dtype=torch.uint8)
    lens = torch.zeros((num_streams,), dtype=torch.int32)
    for s in range(num_streams):
        row = bytearray(width)
        enc = _WarpScanMirror(row)
        for w in range(-(-num_steps // _LANES)):
            steps = range(_LANES * w, min(_LANES * w + _LANES, num_steps))
            bits = sum(1 << (t - _LANES * w) for t in steps if m_all[t, s])
            n = bin(bits).count("1")
            for i in range(n):
                t = _LANES * w + _nth_set_bit(bits, i)
                enc.step(scan_op(int(lo_all[t, s]), int(hi_all[t, s]),
                                 int(pr_all[t, s])))
                # A full window drains after each half, a partial one after
                # each pair of steps.
                if n == _LANES:
                    if i % 16 == 15:
                        enc.drain()
                elif i % 2 == 1 or i == n - 1:
                    enc.drain()
        lens[s] = enc.finish()
        if width:
            rows[s] = torch.frombuffer(row, dtype=torch.uint8)
    out.copy_(rows.to(out.device))
    lengths.copy_(lens.to(lengths.device))


def encode_gamma_warp_plain(symbols, indexes, cdf, meta, out, lengths):
    """Plain mirror of K6''s warp-per-stream kernel (writes out, lengths):
    the same bytes as ``encode_gamma_plain``, by the kernel's own steps, for
    the tests.  Per stream and window of 32 symbols: each symbol's CDF
    interval packed at precision 16 (``scan_op``) and the ballot of the
    window's escapes; a window of 32 symbols without an escape is the
    micro-op scan's full window (drained after each half); any other window
    (escapes, or the stream's last, partial one) codes symbol by symbol,
    each escape followed in place by its 2 nbits + 2 precision-1 steps
    (drained after every two) and every symbol by a drain; then Finalize.
    A row shorter than ``encode_gamma`` asks for cuts a stream as the
    kernel does: before a window with escapes after which the stream's
    symbols and the Elias-gamma steps counted so far could pass the row
    (two bytes a step and two), the stream is finalized and its length set
    to the row's width plus one.  Python integers; slow, and meant for
    small inputs.  Rows must be valid CDFs at precision 1 ... 16
    (``encode_indexed``'s contract)."""
    _encode_symbols_warp_plain(symbols, indexes, cdf, meta, out, lengths,
                               gamma=True)


def encode_indexed_warp_plain(symbols, indexes, cdf, meta, out, lengths):
    """Plain mirror of K1's warp-per-stream kernel (writes out, lengths):
    ``encode_gamma_warp_plain``'s steps without the Elias-gamma ones (an
    escape is the bare marker), for the tests."""
    _encode_symbols_warp_plain(symbols, indexes, cdf, meta, out, lengths,
                               gamma=False)


def _encode_symbols_warp_plain(symbols, indexes, cdf, meta, out, lengths,
                               gamma):
    symbols, indexes, cdf, meta = (t.cpu() for t in (symbols, indexes, cdf,
                                                     meta))
    rows = indexes.long().clamp(0, cdf.shape[0] - 1)
    ops = scan_op(*_main_intervals(symbols, rows, cdf, meta,
                                   bounded=False)).tolist()
    _, escape, g, _ = interval_counts(symbols, indexes, meta)
    escape = (escape & gamma).tolist()
    g, neg = g.tolist(), (symbols < 0).tolist()
    num_streams, n = symbols.shape
    width = out.shape[1]
    out_rows = torch.zeros((num_streams, width), dtype=torch.uint8)
    lens = torch.zeros((num_streams,), dtype=torch.int32)
    for s in range(num_streams):
        row = bytearray(width)
        enc = _WarpScanMirror(row)
        extra, cut = 0, False
        for start in range(0, n, _LANES):
            window = range(start, min(start + _LANES, n))
            escapes = [j for j in window if escape[s][j]]
            if len(window) == _LANES and not escapes:
                for i, j in enumerate(window):
                    enc.step(ops[s][j])
                    if i % 16 == 15:
                        enc.drain()
                continue
            extra += sum(2 * g[s][j].bit_length() for j in escapes)
            if 2 * (n + extra) + 2 > width:
                cut = True
                break
            for j in window:
                enc.step(ops[s][j])
                if escape[s][j]:
                    _gamma_steps(enc, g[s][j], int(neg[s][j]))
                enc.drain()
        lens[s] = enc.finish()
        if cut:
            lens[s] = width + 1
        if width:
            out_rows[s] = torch.frombuffer(row, dtype=torch.uint8)
    out.copy_(out_rows.to(out.device))
    lengths.copy_(lens.to(lengths.device))


def _gamma_steps(enc, g, neg):
    """encode_indexed.cu's gamma_steps: OverflowEncode's 2 nbits + 2 steps
    at precision 1 (nbits zeros, the bits of g from the top one down, the
    sign), drained after every two."""
    nbits = g.bit_length() - 1
    for k in range(2 * nbits + 2):
        bit = 0 if k < nbits else (
            (g >> (2 * nbits - k)) & 1 if k <= 2 * nbits else neg)
        enc.step(scan_op(bit, bit + 1, 1))
        if k % 2 == 1:
            enc.drain()


def scan_op(lower, upper, prec):
    """The warp scan's packed operands of one coded step: lower and upper
    scaled to precision 16, ``lower' | (upper' - 1) << 16``."""
    sh = 16 - prec
    return ((lower << sh) & 0xFFFF) | ((((upper << sh) - 1) & 0xFFFF) << 16)


def scan_chain32(base, sm1, op):
    """One step of the warp scan's 32-bit chain (encode_indexed.cu
    scan_step) on Python integers: returns (new base before the
    renormalization, new size - 1 before it, carry out of 2^32,
    straddles 2^32, renormalizes, base after it, size - 1 after it)."""
    lo, hi = op & 0xFFFF, (op >> 16) + 1
    a = ((sm1 * lo + lo) >> 16) & _M32
    b = ((sm1 * hi + hi) >> 16) & _M32
    nb = (base + a) & _M32
    ns = (b - 1 - a) & _M32
    renorm = ns < 0x10000
    sb = (nb << 16) & _M32 if renorm else nb
    ss = ((ns << 16) | 0xFFFF) & _M32 if renorm else ns
    return nb, ns, nb < a, nb + ns > _M32, renorm, sb, ss


def _nth_set_bit(bits, i):
    """The kernel's search: the largest position with exactly ``i`` set
    bits of ``bits`` below it, by halving steps over population counts."""
    src = 0
    for step in (16, 8, 4, 2, 1):
        if bin(bits & ((1 << (src + step)) - 1)).count("1") <= i:
            src += step
    return src


class _WarpScanMirror:
    """One stream's state in encode_indexed.cu's warp chain (ScanState) and
    the kernel's functions that change it: scan_step, the window of held
    chunks (hold, store_window, drain), fill_run and scan_finish."""

    def __init__(self, row):
        self.row = row
        self.base, self.sm1, self.pend, self.fill = 0, _M32, 0, 0
        self.held = []  # the chunks held in the lanes, in order
        self.pos = 0

    def _store(self, count):
        """The first ``count`` held chunks, high byte first, after pos."""
        for i, chunk in enumerate(self.held[:count]):
            self.row[self.pos + 2 * i] = chunk >> 8
            self.row[self.pos + 2 * i + 1] = chunk & 0xFF
        self.pos += 2 * count
        del self.held[:count]

    def store_window(self):
        """The first 32 held chunks, stored as 64 bytes."""
        self._store(_LANES)

    def drain(self):
        # The kernel holds at most 64 chunks, two in each lane, and the
        # count grows only between drains.
        assert len(self.held) <= 2 * _LANES
        if len(self.held) >= _LANES:
            self.store_window()

    def _fill_run(self, chunk):
        """fill_run: the deferred fill run through the window."""
        self.drain()
        while self.fill:
            n = min(self.fill, _LANES - len(self.held))
            self.held += [chunk] * n
            self.fill -= n
            self.drain()

    def step(self, op):
        """scan_step, predicated as the kernel's: in the delayed-carry
        state the interval still straddles 2^32 (a renormalization defers
        one more fill chunk) or resolves (the deferred chunk, +1 where base
        carried out of 2^32, and its fill run); then a renormalization
        outside a straddle holds its top chunk, or defers it where the
        shifted interval straddles 2^32."""
        nb, _, up, straddle, renorm, sb, ss = scan_chain32(self.base,
                                                           self.sm1, op)
        in_delay = self.pend != 0
        assert in_delay or not straddle  # a valid interval narrows inside
        resolved = in_delay and not straddle
        if resolved:
            self.held.append(self.pend if up else self.pend - 1)
            if self.fill:
                self._fill_run(0 if up else 0xFFFF)
        top = nb >> 16
        amb = renorm and not straddle and sb + ss > _M32
        if renorm and not straddle and not amb:
            self.held.append(top)
        self.fill += int(straddle and renorm)
        self.pend = self.pend if straddle else (top + 1 if amb else 0)
        self.base, self.sm1 = sb, ss

    def finish(self):
        """scan_finish: the held chunks, Finalize; returns the length (the
        row is zero past it already)."""
        self.drain()
        self._store(len(self.held))
        n = self.pos
        tail = []
        if self.pend:
            tail = [(self.pend >> 8) & 0xFF] + (
                [self.pend & 0xFF] if self.pend & 0xFF else [])
        elif self.base:
            upper = (self.base + self.sm1) & _M32
            mid24 = ((self.base - 1) >> 24) + 1
            if mid24 <= upper >> 24:
                tail = [mid24 & 0xFF]
            else:
                mid16 = ((self.base - 1) >> 16) + 1
                tail = [(mid16 >> 8) & 0xFF] + (
                    [mid16 & 0xFF] if mid16 & 0xFF else [])
        for i, byte in enumerate(tail):
            self.row[n + i] = byte
        return n + len(tail)


#: Steps that ``_run_steps`` captures into one CUDA graph.
_GRAPH_STEPS = 32


def _run_steps(step, num_steps, device, done=None):
    """Runs ``step(t)`` for t = 0 .. num_steps - 1, t an int64 [1] tensor on
    ``device`` that advances in place.

    ``step`` must keep its state in tensors that it updates in place and
    must never wait for the device.  A long run on a CUDA device then goes
    through a CUDA graph of ``_GRAPH_STEPS`` steps, replayed: the same
    PyTorch operations, launched without one trip through Python each.
    With ``done`` (a function returning a bool tensor) ``num_steps`` is an
    upper bound: the run ends once ``done()`` holds, which is looked at
    between chunks of steps, so ``step`` must do nothing once it holds.
    """
    t = torch.zeros(1, dtype=torch.int64, device=device)

    def advance(k):
        for _ in range(k):
            step(t)
            t.add_(1)

    n = int(num_steps)
    graph, chunk = None, 1
    if device.type == "cuda" and n >= 4 * _GRAPH_STEPS:
        chunk = _GRAPH_STEPS
        # The steps that do not fill a chunk, and one chunk that every
        # operation of a step has run in before the capture.
        with torch.cuda.device(device):
            advance(n % chunk + chunk)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                advance(chunk)
        n -= n % chunk + chunk
    for i in range(n // chunk):
        if done is not None and i % 8 == 0 and bool(done()):
            break
        if graph is None:
            advance(1)
        else:
            graph.replay()


def _encode_plain(lower, upper, prec, mask, out, lengths, ops=None):
    """The encoder recurrence over [T, S] intervals (writes out, lengths).

    Vectorized over streams, one step per interval, in int64 with explicit
    32-bit masks; ``mask`` (bool [T, S] or None) marks the steps that code.
    With ``ops`` (int64 [T, S], ``scan_op``'s packed operands of valid
    intervals) in place of lower, upper and prec, a step's interval ends
    come from the 32-bit chain of the warp scan and of K4': (size - 1) * c
    + c over 2^16, c scaled to precision 16.
    Every renormalization reserves its two output bytes at once; a
    delayed-carry group keeps its reserved bytes at zero (the "carry up"
    fill) and has them turned to 0xFF when it resolves down, which yields
    the reference RangeEncoder's bytes.  A step never waits for the device
    (``_run_steps``): a write that a stream does not make lands in two
    spare columns, and the runs to turn to 0xFF are marked at their ends
    and filled in after the last step.
    """
    dev = out.device
    num_streams, width = out.shape
    sid = torch.arange(num_streams, device=dev)
    cols = torch.arange(width, device=dev)
    work = torch.zeros((num_streams, width + 2), dtype=torch.uint8,
                       device=dev)
    # +1 where a run of 0xFF starts and -1 where it ends; the last column
    # takes the marks of the streams that have no run in a step.
    marks = torch.zeros((num_streams, width + 1), dtype=torch.int32,
                        device=dev)
    one = torch.ones((num_streams, 1), dtype=torch.int32, device=dev)

    def put16(m, pos, val):
        p = torch.where(m, pos, width)[:, None]
        work.scatter_(1, p, ((val >> 8) & 0xFF).to(torch.uint8)[:, None])
        work.scatter_(1, p + 1, (val & 0xFF).to(torch.uint8)[:, None])

    z = torch.zeros(num_streams, dtype=torch.int64, device=dev)
    base, sm1, delay, ptr, pend = (z.clone(), z + _M32, z.clone(), z.clone(),
                                   z.clone())

    def step(t):
        if ops is None:
            c_lo = lower.index_select(0, t)[0]
            c_hi = upper.index_select(0, t)[0]
            p = prec.index_select(0, t)[0]
            size = sm1 + 1
            a = (size * c_lo) >> p
            b = ((size * c_hi) >> p) - 1
        else:
            op = ops.index_select(0, t)[0]
            lo16, hi16 = op & 0xFFFF, (op >> 16) + 1
            a = ((sm1 * lo16 + lo16) >> 16) & _M32
            b = (((sm1 * hi16 + hi16) >> 16) & _M32) - 1
        nb = (base + a) & _M32
        up = nb < a
        ns = (b - a) & _M32
        straddle = nb + ns > _M32
        renorm = (ns >> 16) == 0
        # Straddle resolved: the pending chunk becomes delay (carry up) or
        # delay - 1 with its fill bytes turned to 0xFF (carry down).
        res = ~straddle & (delay != 0)
        new_base = torch.where(renorm, (nb << 16) & _M32, nb)
        new_sm1 = torch.where(renorm, ((ns << 16) | 0xFFFF) & _M32, ns)
        if mask is not None:
            m = mask.index_select(0, t)[0]
            renorm = renorm & m
            res = res & m
            new_base = torch.where(m, new_base, base)
            new_sm1 = torch.where(m, new_sm1, sm1)
        put16(res, pend, torch.where(up, delay, delay - 1))
        down = res & ~up & (ptr > pend + 2)
        marks.scatter_add_(1, torch.where(down, pend + 2, width)[:, None],
                           one)
        marks.scatter_add_(1, torch.where(down, ptr, width)[:, None], -one)
        emit = renorm & ~straddle
        ambiguous = emit & (new_base + new_sm1 > _M32)
        top = nb >> 16
        put16(emit & ~ambiguous, ptr, top)
        delay.copy_(torch.where(ambiguous, top + 1,
                                torch.where(res, 0, delay)))
        pend.copy_(torch.where(ambiguous, ptr, pend))
        ptr.add_(2 * renorm.long())
        base.copy_(new_base)
        sm1.copy_(new_sm1)

    _run_steps(step, (lower if ops is None else ops).shape[0], dev)
    out.copy_(torch.where(
        marks[:, :width].cumsum(1, dtype=torch.int32) > 0,
        torch.full_like(out, 0xFF), work[:, :width]))

    # RangeEncoder::Finalize.
    in_delay = delay != 0
    r = sid[in_delay]
    out[r, pend[in_delay]] = ((delay[in_delay] >> 8) & 0xFF).to(torch.uint8)
    two = in_delay & ((delay & 0xFF) != 0)
    out[sid[two], pend[two] + 1] = (delay[two] & 0xFF).to(torch.uint8)
    fin = ~in_delay & (base != 0)
    upper_end = (base + sm1) & _M32
    mid24 = ((base - 1) >> 24) + 1
    use24 = fin & (mid24 <= (upper_end >> 24))
    mid16 = ((base - 1) >> 16) + 1
    use16 = fin & ~use24
    b0 = torch.where(use24, mid24, mid16 >> 8) & 0xFF
    out[sid[fin], ptr[fin]] = b0[fin].to(torch.uint8)
    two16 = use16 & ((mid16 & 0xFF) != 0)
    out[sid[two16], ptr[two16] + 1] = (mid16[two16] & 0xFF).to(torch.uint8)
    count = torch.where(fin, torch.where(two16, 2, 1), 0)
    lens = torch.where(in_delay, pend + torch.where(two, 2, 1), ptr + count)
    lengths.copy_(lens.to(torch.int32))
    out.masked_fill_(cols[None, :] >= lens[:, None], 0)


# -----------------------------------------------------------------------------
# Decoders: K2, K5', K3'
# -----------------------------------------------------------------------------
def _decode(name, buf, byte_lens, indexes, num_elements, cdf, meta, plain,
            layout=None, slots=None):
    """Checks, allocates and runs a decoder; with ``layout`` (the table as
    ``warp_table`` gives it) the warp-per-stream kernel of K2 or K3'; with
    ``slots`` (``single_row_slots``) K5'."""
    device = buf.device
    _check("buf", buf, torch.uint8, 2, device)
    _check("byte_lens", byte_lens, torch.int32, 1, device)
    single = indexes is None
    if not single:
        _check("indexes", indexes, torch.int32, 2, device)
        num_elements = indexes.shape[1]
        if indexes.shape[0] != buf.shape[0]:
            raise ValueError("buf and indexes disagree on streams")
    _check_table(cdf, meta, device, single_row=single)
    if layout is not None:
        _check("layout", layout, torch.int16, 1, device)
    if slots is not None:
        _check_slots(slots, cdf.shape[1], device)
    num_streams, n = buf.shape[0], int(num_elements)
    if byte_lens.shape[0] != num_streams:
        raise ValueError("buf and byte_lens disagree on streams")
    symbols = torch.empty((num_streams, n), dtype=torch.int32, device=device)
    sanity = torch.empty((num_streams,), dtype=torch.bool, device=device)
    if _device_kind(device) == "cpu":
        if single:
            plain(buf, byte_lens, cdf, meta, symbols, sanity, slots)
        elif layout is None:
            plain(buf, byte_lens, indexes, cdf, meta, symbols, sanity)
        else:
            plain(buf, byte_lens, indexes, cdf, meta, symbols, sanity, layout)
        return symbols, sanity
    if layout is not None:
        fn = getattr(_lib("decode_indexed"), f"ctpu_{name}_warp")
        _launch(name, fn, buf, buf.shape[1], byte_lens, indexes, num_streams,
                n, layout, layout.numel(), cdf.shape[0], cdf.shape[1],
                symbols, sanity)
        LAUNCHES_WARP[name] += 1
        return symbols, sanity
    fn = getattr(_lib("decode_indexed"), "ctpu_" + name)
    if single:
        table, precision = slots
        _launch(name, fn, buf, buf.shape[1], byte_lens, num_streams, n, table,
                table.numel(), precision, cdf.shape[1], symbols, sanity)
    else:
        _launch(name, fn, buf, buf.shape[1], byte_lens, indexes, num_streams,
                n, cdf, meta, cdf.shape[0], cdf.shape[1], symbols, sanity)
    return symbols, sanity


def _takes_warp_decode(buf):
    return buf.ndim == 2 and buf.shape[0] <= WARP_DECODE_MAX_STREAMS


def decode_indexed(buf, byte_lens, indexes, cdf, meta, layout=None):
    """K2: range-decodes every stream with a CDF row per element (sidecar
    format).

    Args:
      buf: uint8 [S, W] stream bytes; bytes past byte_lens[s] read as zero.
      byte_lens: int32 [S].
      indexes: int32 [S, N] CDF row per element.
      cdf, meta: the table (see module docstring); row precision <= 16,
        every row reaching 2^precision (as every ``tables.CdfTable`` row
        does).
      layout: ``warp_table(cdf, meta)`` where the caller keeps it
        (``DeviceCdfTable.warp_arrays``); without it the warp variant lays
        the table out on every call.

    Returns:
      (symbols int32 [S, N] with escapes as the marker length - 2,
       sanity bool [S]).

    The number of streams alone picks the kernel: at most
    ``WARP_DECODE_MAX_STREAMS`` take ``decode_indexed_warp``, more take
    ``decode_indexed_thread``.
    """
    if _takes_warp_decode(buf):
        return decode_indexed_warp(buf, byte_lens, indexes, cdf, meta, layout)
    return decode_indexed_thread(buf, byte_lens, indexes, cdf, meta)


def decode_indexed_thread(buf, byte_lens, indexes, cdf, meta):
    """K2 by its thread-per-stream kernel (arguments and result as
    ``decode_indexed``); on the CPU ``decode_indexed_plain``."""
    return _decode("decode_indexed", buf, byte_lens, indexes, None, cdf,
                   meta, decode_indexed_plain)


def decode_indexed_warp(buf, byte_lens, indexes, cdf, meta, layout=None):
    """K2 by its warp-per-stream kernel (arguments and result as
    ``decode_indexed``); on the CPU ``decode_indexed_warp_plain``, the
    plain decoder over the kernel's table layout and search."""
    if layout is None:
        _check_table(cdf, meta, cdf.device)
        layout = warp_table(cdf, meta)
    return _decode("decode_indexed", buf, byte_lens, indexes, None, cdf,
                   meta, decode_indexed_warp_plain, layout)


def decode_single_row(buf, byte_lens, num_elements, cdf, meta, slots=None):
    """K5': range-decodes ``num_elements`` symbols per stream with the
    table's one row (cdf [1, L] / meta [1, 3], no overflow; precision 1 ...
    16); otherwise as ``decode_indexed``.

    ``slots`` is ``single_row_slots(cdf, meta, precision)`` where the caller
    keeps it (``DeviceCdfTable.single_row_slots``); without it the call
    builds it, which copies the precision to the host.  On the CPU
    ``decode_single_row_slot_plain``, the kernel's search."""
    if slots is None:
        _check_table(cdf, meta, cdf.device, single_row=True)
        slots = single_row_slots(cdf, meta)
    return _decode("decode_single_row", buf, byte_lens, None, num_elements,
                   cdf, meta, decode_single_row_slot_plain, slots=slots)


#: Up to this precision a slot of ``single_row_slots`` holds the symbol and
#: its interval, above it the count alone (decode_indexed.cu).
SLOT_PAIR_MAX_PRECISION = 14


def _slot_units(precision, max_len):
    """int32 units of ``single_row_slots``' table, as decode_indexed.cu's
    slot_units."""
    slots = (1 << precision) + 2
    units = 2 * slots if precision <= SLOT_PAIR_MAX_PRECISION else \
        slots // 2 + max_len + 1
    return -(-units // 4) * 4


def _check_slots(slots, max_len, device):
    table, precision = slots
    _check("slots", table, torch.int32, 1, device)
    if table.numel() != _slot_units(int(precision), max_len):
        raise ValueError(f"slot table of {table.numel()} units for a row of "
                         f"{max_len} entries at precision {precision}")


def single_row_slots(cdf, meta, precision=None):
    """K5''s slot table of a one-row table (cdf int32 [1, L], meta [1, 3]):
    ``(table int32 [units], precision)``.

    For t in [0, 2^precision + 1], the count of entries k in [1, L) below t
    (``cdf[k] < t``): the decoder's count of entries with ``size * cdf[k] <
    lower_bound`` is the slot of t = ceil(lower_bound / size), capped at
    2^precision + 1 (every entry below it).  Up to precision
    ``SLOT_PAIR_MAX_PRECISION`` slot t is two int32, the symbol min(count,
    L - 2) and ``c_lo | (c_hi - 1) << 16`` with c_lo = cdf[count] and c_hi =
    cdf[count + 1] (65536 past the row); above it, a uint16 count (capped at
    65535; the kernel takes slot 2^precision + 1's as L - 1), then the row
    as int32 followed by 65536.  Zeros pad the table to a multiple of four
    units.  ``precision`` defaults to meta's, which costs a copy to the
    host; nothing else is copied.  Rows must be non-decreasing, and at
    precision 15 and 16 hold at most 65537 entries.
    """
    if precision is None:
        precision = int(meta[0, 1])
    precision, max_len = int(precision), cdf.shape[1]
    if not 1 <= precision <= 16:
        raise ValueError(f"precision {precision} outside 1 ... 16")
    if precision > SLOT_PAIR_MAX_PRECISION and max_len > 65537:
        raise ValueError(f"a row of {max_len} entries at precision "
                         f"{precision}: counts past 16 bits")
    row = cdf[0].long()
    t = torch.arange((1 << precision) + 2, device=cdf.device)
    count = torch.searchsorted(row[1:].contiguous(), t)
    if precision <= SLOT_PAIR_MAX_PRECISION:
        c_hi = torch.where(count + 1 < max_len,
                           row[(count + 1).clamp(max=max_len - 1)], 65536)
        pair = row[count] | ((c_hi - 1) << 16)
        pair = torch.where(pair >= 1 << 31, pair - (1 << 32), pair)
        table = torch.stack([count.clamp(max=max_len - 2), pair], 1)
        table = table.reshape(-1).to(torch.int32)
    else:
        counts = count.clamp(max=65535)
        counts = torch.where(counts >= 1 << 15, counts - (1 << 16), counts)
        table = torch.cat([
            counts.to(torch.int16).view(torch.int32),
            row.to(torch.int32), row.new_full((1,), 65536).to(torch.int32)])
    units = _slot_units(precision, max_len)
    return F.pad(table, (0, units - table.numel())), precision


def single_row_threshold_plain(offset, sm1, precision):
    """K5''s slot index t for decoder states (int64 [S] offsets value - base
    and sizes - 1, 32-bit values), K8''s threshold too: ceil((offset + 1)
    2^precision / (sm1 + 1)), capped at 2^precision + 1, as the kernels find
    it -- an f32 quotient (theirs a product with rcp.approx's reciprocal,
    within 2 ulp of this one), rounded up, then moved by one where an exact
    product shows it off."""
    scale = float(1 << precision)
    fo = offset.to(torch.float32) + 1
    fs = sm1.to(torch.float32) + 1
    q = torch.clamp(fo * scale / fs, max=scale + 2)
    t0 = torch.ceil(q).long()
    lb = (offset + 1) << precision
    up = (sm1 * t0 + t0 < lb).long()
    down = (sm1 * (t0 - 1) + (t0 - 1) >= lb).long()
    return (t0 + up - down).clamp(max=(1 << precision) + 1)


class _SlotSearch:
    """(symbol, c_lo, c_hi) int64 [S] of slot indices t, read from
    ``single_row_slots``' table as K5' reads it."""

    def __init__(self, slots, max_len):
        table, self.precision = slots
        self.tmax = (1 << self.precision) + 1
        self.max_len = max_len
        if self.precision <= SLOT_PAIR_MAX_PRECISION:
            self.pairs = table[: 2 * (self.tmax + 1)].long().reshape(-1, 2)
        else:
            half = (self.tmax + 1) // 2
            self.counts = table[:half].contiguous().view(torch.int16).long() \
                & 0xFFFF
            self.row = table[half: half + max_len + 1].long()

    def __call__(self, t):
        if self.precision <= SLOT_PAIR_MAX_PRECISION:
            sym, pair = self.pairs[t].unbind(1)
            pair = pair & _M32
            return sym, pair & 0xFFFF, (pair >> 16) + 1
        count = torch.where(t == self.tmax, self.max_len - 1, self.counts[t])
        return (count.clamp(max=self.max_len - 2), self.row[count],
                self.row[count + 1])


def decode_single_row_slot_plain(buf, byte_lens, cdf, meta, symbols, sanity,
                                 slots=None):
    """Plain mirror of K5''s kernel (writes symbols, sanity): each symbol
    found by ``single_row_threshold_plain`` and one look into
    ``single_row_slots``' table (default: built from cdf, meta), the
    interval update of ``_PlainDecoder``.  The same symbols and flags as
    ``decode_single_row_plain``."""
    slots = single_row_slots(cdf, meta) if slots is None else slots
    search = _SlotSearch(slots, cdf.shape[1])
    prec = search.precision
    dec = _PlainDecoder(buf, byte_lens)

    def step(t):
        size = dec.sm1 + 1
        sym, c_lo, c_hi = search(single_row_threshold_plain(
            (dec.value - dec.base) & _M32, dec.sm1, prec))
        dec.refine(((size * c_lo) >> prec) & _M32,
                   (((size * c_hi) >> prec) - 1) & _M32)
        symbols.index_copy_(1, t, sym.to(torch.int32)[:, None])

    _run_steps(step, symbols.shape[1], buf.device)
    sanity.copy_(dec.sane(byte_lens))


def decode_gamma(buf, byte_lens, indexes, cdf, meta, layout=None):
    """K3': the reference format's decode.  As ``decode_indexed``, but the
    marker on an overflow row is followed by the escape's Elias-gamma
    magnitude and sign, and the symbol comes back as the escaped value.

    The number of streams alone picks the kernel: at most
    ``WARP_DECODE_MAX_STREAMS`` take ``decode_gamma_warp``, more take
    ``decode_gamma_thread``.  ``layout`` is ``warp_table(cdf, meta)`` where
    the caller keeps it (``DeviceCdfTable.warp_arrays``); without it the
    warp variant lays the table out on every call."""
    if _takes_warp_decode(buf):
        return decode_gamma_warp(buf, byte_lens, indexes, cdf, meta, layout)
    return decode_gamma_thread(buf, byte_lens, indexes, cdf, meta)


def decode_gamma_thread(buf, byte_lens, indexes, cdf, meta):
    """K3' by its thread-per-stream kernel (arguments and result as
    ``decode_gamma``); on the CPU ``decode_gamma_plain``."""
    return _decode("decode_gamma", buf, byte_lens, indexes, None, cdf, meta,
                   decode_gamma_plain)


def decode_gamma_warp(buf, byte_lens, indexes, cdf, meta, layout=None):
    """K3' by its warp-per-stream kernel (arguments and result as
    ``decode_gamma``); on the CPU ``decode_gamma_warp_plain``, the plain
    decoder over the kernel's table layout and search."""
    if layout is None:
        _check_table(cdf, meta, cdf.device)
        layout = warp_table(cdf, meta)
    return _decode("decode_gamma", buf, byte_lens, indexes, None, cdf, meta,
                   decode_gamma_warp_plain, layout)


#: Entries that one round of the warp's probes covers, and the most rounds
#: of the one-level search (rows of up to 1 + 4 * 32 entries).
_LANES = 32
_DIRECT_BUCKETS = 4


def _warp_geometry(max_len):
    """(buckets, row_len, stride) of ``warp_table``'s records, in 16-bit
    units, as decode_indexed.cu's warp_layout."""
    buckets = max(-(-(max_len - 1) // _LANES), _DIRECT_BUCKETS)
    row_len = 2 + _LANES * buckets
    return buckets, row_len, -(-(8 + buckets + row_len) // 8) * 8


def warp_table(cdf, meta):
    """The table in the 16-bit layout of the warp-per-stream decode: int16
    [num_rows * stride], one record per row, each starting 16-byte aligned:

    * four int32 (as eight units): the escape marker ``length - 2`` (-1 on
      a row without overflow), the precision, ``top`` and ``limit``
      (below);
    * ``buckets = max(4, ceil((L - 1) / 32))`` coarse entries, those at
      indices 32, 64, ..., which end the buckets of 32 that the two-level
      search counts first;
    * ``2 + 32 * buckets`` entries: the row padded with its last (terminal)
      value; then zeros up to a multiple of 8 units.

    Entries are stored as ``min(value, 2^precision - 1)``, which changes
    only a row's terminal entries, so that 65536, the terminal value at
    precision 16, needs no 17th bit.  ``limit`` is the index before the
    row's first terminal entry (``max_len - 1`` for a row that holds none)
    and caps the count of entries below the threshold: no terminal entry is
    below it in any state the decoder can reach, and a stored terminal
    tests below only where all entries before it do.  The interval's upper
    end at the cap is ``top``: the terminal value, or 65536 where the count
    ran off a row without one.  Rows are taken as non-decreasing.  Nothing
    is copied to the host.
    """
    num_rows, max_len = cdf.shape
    buckets, row_len, stride = _warp_geometry(max_len)
    rows = cdf.long()
    rows = torch.cat(
        [rows, rows[:, -1:].expand(num_rows, row_len - max_len)], 1)
    marker, prec, overflow = meta.long().unbind(1)
    terminal = 1 << prec
    terminal_at = ((rows == terminal[:, None]).cumsum(1) == 0).sum(1)
    limit = terminal_at.clamp(max=max_len) - 1
    top = torch.where(limit + 1 == terminal_at, terminal, 65536)
    meta4 = torch.stack(
        [torch.where(overflow != 0, marker, -1), prec, top, limit], 1).to(
            torch.int32).contiguous()
    stored = torch.minimum(rows, terminal[:, None] - 1)
    stored = torch.where(stored >= 32768, stored - 65536, stored).to(
        torch.int16)
    records = torch.cat([meta4.view(torch.int16),
                         stored[:, _LANES::_LANES][:, :buckets], stored], 1)
    return F.pad(records, (0, stride - records.shape[1])).reshape(-1)


class _WarpSearch:
    """The warp kernel's symbol search over ``warp_table``'s layout,
    vectorized over streams: the probes of the 32 lanes are a trailing axis
    of 32, a ballot and population count its sum."""

    def __init__(self, layout, num_rows, max_len):
        buckets, row_len, stride = _warp_geometry(max_len)
        if layout.shape != (num_rows * stride,):
            raise ValueError(f"layout of {tuple(layout.shape)} units for a "
                             f"{num_rows} x {max_len} table, not "
                             f"{num_rows * stride}")
        records = layout.reshape(num_rows, stride)
        self.buckets = buckets
        self.meta = records[:, :8].contiguous().view(torch.int32).long()
        self.coarse = records[:, 8: 8 + buckets].long() & 0xFFFF
        self.tab = records[:, 8 + buckets: 8 + buckets + row_len].long() \
            & 0xFFFF
        self.lanes = torch.arange(_LANES, device=layout.device)

    def __call__(self, row, size, lower_bound):
        """(count, c_lo, c_hi) int64 [S] for rows ``row`` [S]."""
        prec, top, limit = self.meta[row, 1:].unbind(1)
        # lower_bound is (offset + 1) << precision; the kernel tests
        # (size * entry) >> precision <= offset.
        offset = (lower_bound >> prec) - 1
        rows2 = row[:, None]

        def below(table, pos):
            """bool [S, 32]: the stored entries ``table[row, pos]`` against
            the threshold."""
            return (size[:, None] * table[rows2, pos]) >> prec[:, None] \
                <= offset[:, None]

        buckets, lanes = self.buckets, self.lanes
        if buckets == _DIRECT_BUCKETS:
            count = torch.zeros_like(row)
            for r in range(buckets):
                count = count + below(
                    self.tab, (1 + lanes + _LANES * r)[None, :]).sum(1)
        else:
            full = torch.zeros_like(row)
            for r in range(-(-buckets // _LANES)):
                j = (lanes + _LANES * r)[None, :]
                full = full + (below(self.coarse, j.clamp(max=buckets - 1))
                               & (j < buckets)).sum(1)
            b = full.clamp(max=buckets - 1)
            count = _LANES * b + below(
                self.tab, _LANES * b[:, None] + 1 + lanes[None, :]).sum(1)
        count = torch.minimum(count, limit)
        c_hi = torch.where(count == limit, top, self.tab[row, count + 1])
        return count, self.tab[row, count], c_hi


def warp_search_plain(layout, num_rows, max_len, row, size, lower_bound):
    """Plain version of the warp kernel's symbol search.

    Args:
      layout: ``warp_table(cdf, meta)`` of a ``num_rows`` x ``max_len``
        table.
      row: int64 [S] table row per stream (in range).
      size, lower_bound: int64 [S], the decoder's range size and
        ``(value - base + 1) << precision``.

    Returns:
      (count, c_lo, c_hi) int64 [S]: the entries k in [1, max_len) with
      ``size * cdf[k] < lower_bound``, counted by lane-strided probes (one
      level for rows of up to 129 entries, else every 32nd entry first and
      then the bucket found) and capped at the row's ``limit``, and the
      interval ``cdf[count]``, ``cdf[count + 1]`` from the 16-bit form
      (``top`` at the cap).
    """
    return _WarpSearch(layout, num_rows, max_len)(row, size, lower_bound)


def bucketize_row(row):
    """(bucket_last int32 [nb], win17 int32 [nb, 17]) of one CDF row (int32
    [L], padded with its terminal value), as jax_coder._bucketize_row:
    16-entry buckets, and per bucket the last entry of the bucket before
    (0 for the first) followed by its 16 entries."""
    pad = (-row.shape[0]) % 16
    buckets = torch.cat([row, row[-1:].expand(pad)]).reshape(-1, 16)
    bucket_last = buckets[:, -1]
    prev_last = torch.cat([torch.zeros_like(bucket_last[:1]),
                           bucket_last[:-1]])
    return (bucket_last.contiguous(),
            torch.cat([prev_last[:, None], buckets], 1).contiguous())


def decode_single_row_bucketed(buf, byte_lens, num_elements, bucket_last,
                               win17, max_pv: int, precision: int):
    """K8': as ``decode_single_row`` (one row, no overflow), by the
    two-level bucketed search of pallas_coder.decode_scan_pallas (v1) and
    with its sanity rule.  A second single-row decoder, independent of
    K5', for cross-checks; it returns K5''s symbols on every valid
    stream.

    The row comes in the v1 kernel's form, which
    ``DeviceCdfTable.bucketed_arrays`` keeps: ``bucket_last`` int32 [nb],
    ``win17`` int32 [nb, 17] (see ``bucketize_row``) of a non-decreasing
    row whose entries are at most 2^precision, ``max_pv`` the row's padded
    length less one, and its ``precision``.
    """
    device = buf.device
    _check("buf", buf, torch.uint8, 2, device)
    _check("byte_lens", byte_lens, torch.int32, 1, device)
    _check("bucket_last", bucket_last, torch.int32, 1, device)
    _check("win17", win17, torch.int32, 2, device)
    num_buckets = bucket_last.shape[0]
    if num_buckets < 1 or win17.shape != (num_buckets, 17):
        raise ValueError("win17 must be [len(bucket_last), 17]")
    max_pv, precision = int(max_pv), int(precision)
    if not (1 <= precision <= 16 and 1 <= max_pv < 16 * num_buckets + 1):
        raise ValueError(f"precision {precision} or max_pv {max_pv} outside "
                         "the row's range")
    num_streams, n = buf.shape[0], int(num_elements)
    if byte_lens.shape[0] != num_streams:
        raise ValueError("buf and byte_lens disagree on streams")
    symbols = torch.empty((num_streams, n), dtype=torch.int32, device=device)
    sanity = torch.empty((num_streams,), dtype=torch.bool, device=device)
    if _device_kind(device) == "cpu":
        decode_single_row_bucketed_plain(buf, byte_lens, bucket_last, win17,
                                         max_pv, precision, symbols, sanity)
        return symbols, sanity
    _launch("decode_single_row_bucketed",
            _lib("decode_indexed").ctpu_decode_single_row_bucketed, buf,
            buf.shape[1], byte_lens, num_streams, n, bucket_last, win17,
            num_buckets, max_pv, precision, symbols, sanity)
    return symbols, sanity


def _bucketed_search_exact(size, lower_bound, bucket_last, win17, max_pv):
    """The v1 kernel body's search for decoder states (int64 [S] sizes and
    lower bounds (value - base + 1) 2^precision), each test an exact
    product size * c < lower_bound: (symbol, c_lo, c_hi) int64 [S], the
    interval the largest window entry below and the smallest one not
    below (at most 2^16)."""
    bucket_last, win17 = bucket_last.long(), win17.long()
    num_buckets = bucket_last.shape[0]
    full = size[:, None] * bucket_last[None, :] < lower_bound[:, None]
    nfull = full.sum(1)
    win = win17[nfull.clamp(max=num_buckets - 1)]
    below = size[:, None] * win < lower_bound[:, None]
    fine = below[:, 1:].sum(1)
    pv = (16 * nfull + fine).clamp(max=max_pv)
    c_lo = torch.where(below, win, 0).amax(1)
    c_hi = torch.where(below, 1 << 17, win).amin(1).clamp(max=1 << 16)
    return pv - 1, c_lo, c_hi


def decode_single_row_bucketed_plain(buf, byte_lens, bucket_last, win17,
                                     max_pv, precision, symbols, sanity):
    """Plain PyTorch version of K8' (writes symbols, sanity): the steps of
    the v1 kernel body, with the threshold test as an exact product
    (``_bucketed_search_exact``)."""
    prec, max_pv = int(precision), int(max_pv)
    dec = _PlainDecoder(buf, byte_lens)

    def step(t):
        size = dec.sm1 + 1
        lower_bound = (((dec.value - dec.base) & _M32) + 1) << prec
        sym, c_lo, c_hi = _bucketed_search_exact(
            size, lower_bound, bucket_last, win17, max_pv)
        dec.refine(((size * c_lo) >> prec) & _M32,
                   (((size * c_hi) >> prec) - 1) & _M32)
        symbols.index_copy_(1, t, sym.to(torch.int32)[:, None])

    _run_steps(step, symbols.shape[1], buf.device)
    sanity.copy_(dec.sane(byte_lens))


def decode_indexed_plain(buf, byte_lens, indexes, cdf, meta, symbols,
                         sanity):
    """Plain PyTorch version of K2 (writes symbols, sanity)."""
    _decode_plain(buf, byte_lens, indexes, cdf, meta, symbols, sanity, False)


def decode_indexed_warp_plain(buf, byte_lens, indexes, cdf, meta, symbols,
                              sanity, layout=None):
    """Plain PyTorch version of K2's warp-per-stream kernel (writes symbols,
    sanity): ``decode_indexed_plain`` with the symbol found by
    ``warp_search_plain`` over ``layout`` (default ``warp_table(cdf,
    meta)``)."""
    layout = warp_table(cdf, meta) if layout is None else layout
    _decode_plain(buf, byte_lens, indexes, cdf, meta, symbols, sanity, False,
                  _WarpSearch(layout, *cdf.shape))


def decode_single_row_plain(buf, byte_lens, cdf, meta, symbols, sanity):
    """Plain PyTorch version of K5' (writes symbols, sanity): the count
    over the whole row."""
    _decode_plain(buf, byte_lens, None, cdf, meta, symbols, sanity, False)


def decode_gamma_plain(buf, byte_lens, indexes, cdf, meta, symbols, sanity):
    """Plain PyTorch version of K3' (writes symbols, sanity)."""
    _decode_plain(buf, byte_lens, indexes, cdf, meta, symbols, sanity, True)


def decode_gamma_warp_plain(buf, byte_lens, indexes, cdf, meta, symbols,
                            sanity, layout=None):
    """Plain PyTorch version of K3''s warp-per-stream kernel (writes
    symbols, sanity): ``decode_gamma_plain`` with the symbol found by
    ``warp_search_plain`` over ``layout`` (default ``warp_table(cdf,
    meta)``)."""
    layout = warp_table(cdf, meta) if layout is None else layout
    _decode_plain(buf, byte_lens, indexes, cdf, meta, symbols, sanity, True,
                  _WarpSearch(layout, *cdf.shape))


class _PlainDecoder:
    """RangeDecoder state of every stream, vectorized over streams in int64
    with explicit 32-bit masks, updated in place and without a wait for the
    device (``_run_steps``)."""

    def __init__(self, buf, byte_lens):
        dev = buf.device
        num_streams, width = buf.shape
        self.width = width
        # Zero past each stream's end, and two zero bytes after the buffer
        # that every read beyond it lands on.
        cols = torch.arange(width, device=dev)
        self.data = torch.zeros((num_streams, width + 2), dtype=torch.int64,
                                device=dev)
        self.data[:, :width] = torch.where(
            cols[None, :] < byte_lens.long()[:, None], buf.long(), 0)
        z = torch.zeros(num_streams, dtype=torch.int64, device=dev)
        self.base, self.sm1 = z.clone(), z + _M32
        self.value = (self._chunk(z) << 16) | self._chunk(z + 1)
        self.chunks_read = z + 2

    def _chunk(self, k):
        p = (2 * k).clamp(max=self.width)[:, None]
        return (self.data.gather(1, p)[:, 0] << 8) | self.data.gather(
            1, p + 1)[:, 0]

    def refine(self, a, b, mask=None):
        nb = (self.base + a) & _M32
        ns = (b - a) & _M32
        renorm = (ns >> 16) == 0
        new_base = torch.where(renorm, (nb << 16) & _M32, nb)
        new_sm1 = torch.where(renorm, ((ns << 16) | 0xFFFF) & _M32, ns)
        if mask is not None:
            renorm = renorm & mask
            new_base = torch.where(mask, new_base, self.base)
            new_sm1 = torch.where(mask, new_sm1, self.sm1)
        self.base.copy_(new_base)
        self.sm1.copy_(new_sm1)
        self.value.copy_(torch.where(
            renorm, ((self.value << 16) | self._chunk(self.chunks_read))
            & _M32, self.value))
        self.chunks_read.add_(renorm.long())

    def symbol(self, search, max_len, prec, mask=None):
        """Symbol search on the streams in ``mask`` (default all);
        ``search(size, lower_bound)`` gives (count, c_lo, c_hi) in rows of
        ``max_len`` entries.  Returns the count of entries below the
        threshold, clipped to max_len - 2, as jax_coder.decode_core
        resolves it."""
        size = self.sm1 + 1
        lower_bound = (((self.value - self.base) & _M32) + 1) << prec
        count, c_lo, c_hi = search(size, lower_bound)
        self.refine(((size * c_lo) >> prec) & _M32,
                    (((size * c_hi) >> prec) - 1) & _M32, mask)
        return count.clamp(max=max_len - 2)

    def bit(self, mask):
        """decode_core's _decode_binary on the streams in ``mask``."""
        size = self.sm1 + 1
        lower_bound = (((self.value - self.base) & _M32) + 1) << 1
        b = (size < lower_bound).long()
        self.refine(((size * b) >> 1) & _M32,
                    (((size * (b + 1)) >> 1) - 1) & _M32, mask)
        return b

    def sane(self, byte_lens):
        """RangeDecoder::Finalize's check and "stream fully consumed"."""
        base, sm1, value = self.base, self.sm1, self.value
        upper = (base + sm1) & _M32
        bm1 = (base - 1) & _M32
        shift = torch.where((bm1 >> 24) < (upper >> 24), 24, 16)
        mid = (bm1 >> shift) + 1
        ok = torch.where((base == 0) | (upper < base), value == 0,
                         ((mid << shift) & _M32) == value)
        return ok & (2 * self.chunks_read >= byte_lens.long())


def _dense_search(rows, size, lower_bound):
    """(count, c_lo, c_hi) in padded dense rows [S, L]: the count of
    entries k >= 1 with size * rows[k] < lower_bound, and the interval at
    it (65536 past the row)."""
    max_len = rows.shape[1]
    count = (size[:, None] * rows[:, 1:] < lower_bound[:, None]).sum(1)
    c_lo = rows.gather(1, count[:, None])[:, 0]
    c_hi = torch.where(
        count + 1 < max_len,
        rows.gather(1, (count + 1).clamp(max=max_len - 1)[:, None])[:, 0],
        65536)
    return count, c_lo, c_hi


def _decode_plain(buf, byte_lens, indexes, cdf, meta, symbols, sanity,
                  gamma, warp_search=None):
    """Decodes symbols [S, N]; ``indexes=None`` reads row 0 throughout;
    ``gamma`` selects in-stream Elias-gamma escapes (else escapes come back
    as the marker); ``warp_search`` (a ``_WarpSearch``) replaces the search
    in the dense rows."""
    num_streams, n = symbols.shape
    num_rows, max_len = cdf.shape
    dev = buf.device
    cdf64 = cdf.long()
    maxs, prec_r, ovf_r = meta.long().unbind(1)
    dec = _PlainDecoder(buf, byte_lens)
    z = torch.zeros(num_streams, dtype=torch.int64, device=dev)

    def row_at(elem):
        if indexes is None:
            return z
        return indexes.gather(1, elem[:, None])[:, 0].long().clamp(
            0, num_rows - 1)

    def search_in(row):
        if warp_search is not None:
            return lambda size, lb: warp_search(row, size, lb)
        return lambda size, lb: _dense_search(cdf64[row], size, lb)

    if not gamma:
        def step(t):
            row = row_at(t.expand(num_streams))
            sym = dec.symbol(search_in(row), max_len, prec_r[row])
            symbols.index_copy_(1, t, sym.to(torch.int32)[:, None])

        _run_steps(step, n, dev)
        sanity.copy_(dec.sane(byte_lens))
        return

    # One coded interval per step and stream: the stream's element ``elem``
    # is in phase 0 (its symbol or escape marker), 1 (the unary zeros of
    # OverflowDecode), 2 (the bits of the magnitude below its top one) or 3
    # (the sign).  Streams run apart, since an escape takes its stream
    # 2 + 2 * zeros more intervals; a stream past its last element does
    # nothing.  The decoded values go to a buffer with one spare column,
    # which takes the writes of the streams that finish no element.
    elem, phase, zeros, left, mag = (z.clone() for _ in range(5))
    work = torch.zeros((num_streams, n + 1), dtype=torch.int32, device=dev)

    def step(_):
        active = elem < n
        at = elem.clamp(max=n - 1)
        row = row_at(at)
        mv = maxs[row]
        in_sym = active & (phase == 0)
        sym = dec.symbol(search_in(row), max_len, prec_r[row], in_sym)
        esc = in_sym & (ovf_r[row] != 0) & (sym == mv)
        b = dec.bit(active & (phase != 0))
        unary = active & (phase == 1)
        bits = active & (phase == 2)
        sign = active & (phase == 3)
        new_zeros = zeros + (unary & (b == 0)).long()
        # The zeros end at the first one bit, or after 31 of them.
        top = unary & ((b == 1) | (new_zeros >= 31))
        new_left = torch.where(top, new_zeros,
                               torch.where(bits, left - 1, left))
        new_mag = torch.where(
            top, torch.ones_like(mag) << new_zeros,
            torch.where(bits, mag | (b << (left - 1).clamp(min=0)), mag))
        value = torch.where(b == 1, -mag, mag + mv - 1) & _M32
        value = torch.where(value >= 2 ** 31, value - 2 ** 32, value)
        finished = (in_sym & ~esc) | sign
        work.scatter_(1, torch.where(finished, at, n)[:, None],
                      torch.where(sign, value, sym).to(torch.int32)[:, None])
        phase.copy_(torch.where(
            esc, 1, torch.where(
                top | bits, torch.where(new_left > 0, 2, 3),
                torch.where(sign, 0, phase))))
        zeros.copy_(torch.where(esc, 0, new_zeros))
        left.copy_(new_left)
        mag.copy_(new_mag)
        elem.add_(finished.long())

    _run_steps(step, 64 * n, dev, done=lambda: (elem >= n).all())
    symbols.copy_(work[:, :n])
    sanity.copy_(dec.sane(byte_lens))
