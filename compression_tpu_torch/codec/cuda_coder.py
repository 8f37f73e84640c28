"""The range coder's hand-written CUDA kernels, their wrappers and plain
PyTorch versions (counterpart of compression_tpu/codec/pallas_coder.py).

Six kernels, all one thread per coder stream, from two templated sources in
``csrc/`` (one copy of the encoder recurrence, one of the decoder's):

* ``encode_indexed`` (K1) replaces ``pallas_coder.encode_indexed_device``
  with its fused chunk post-pass: a CDF row per element, escapes coded as
  the bare marker (the native container's sidecar format).
* ``decode_indexed`` (K2) replaces
  ``pallas_coder.decode_indexed_pallas(in_stream_gamma=False)``.
* ``encode_single_row`` (K4') replaces
  ``pallas_coder.encode_single_row_device``: one shared row, no overflow.
* ``decode_single_row`` (K5') replaces ``pallas_coder.decode_scan_pallas_v2``.
* ``encode_gamma`` (K6') replaces ``pallas_coder.encode_scan_pallas`` over
  the micro-ops of ``jax_coder.micro_ops_from_symbols``: escapes followed
  in the stream by their Elias-gamma magnitude and sign (the reference
  .tfci format).
* ``decode_gamma`` (K3') replaces
  ``pallas_coder.decode_indexed_pallas(in_stream_gamma=True)``.

K1, K4' and K6' are in ``csrc/encode_indexed.cu``; K2, K5' and K3' in
``csrc/decode_indexed.cu``.

Each wrapper checks its inputs, allocates the outputs with ``torch.empty``
and then runs the plain version when the tensors lie on the CPU, or
launches the kernel on the current CUDA stream (and adds one to
``LAUNCHES[name]``) when they lie on a CUDA device.  There is no fallback
between the two: a CUDA tensor reaches the kernel or an exception.

The kernels are compiled by ``nvcc`` for ``sm_90a`` at first use (or by
``build()``), one process per source started together, into the package's
git-ignored ``_build/`` directory, and bound with ctypes through a plain C
interface that returns ``cudaGetLastError()``.

All kernels take the table in the padded dense layout of
``tables.CdfTable`` (int32 ``cdf[num_rows, max_len]``, rows padded with
their terminal value) plus an int32 ``meta[num_rows, 3]`` of (escape marker
``length - 2``, precision, overflow flag) per row; the single-row kernels
take a table of one row.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import threading

import torch

from compression_tpu_torch import native

__all__ = [
    "LAUNCHES",
    "build",
    "encode_indexed",
    "decode_indexed",
    "encode_single_row",
    "decode_single_row",
    "encode_gamma",
    "decode_gamma",
    "encode_indexed_plain",
    "decode_indexed_plain",
    "encode_single_row_plain",
    "decode_single_row_plain",
    "encode_gamma_plain",
    "decode_gamma_plain",
    "interval_counts",
    "gamma_micro_ops",
]

#: Kernel launches per wrapper since the counts were last reset.
LAUNCHES = {"encode_indexed": 0, "decode_indexed": 0,
            "encode_single_row": 0, "decode_single_row": 0,
            "encode_gamma": 0, "decode_gamma": 0}

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_M32 = 0xFFFFFFFF
_LOCK = threading.Lock()
_LIBS: dict = {}

_vp, _i64, _int = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_ENCODE_ARGS = [_vp, _vp, _i64, _i64, _vp, _vp, _int, _int, _vp, _i64, _vp,
                _vp]
_DECODE_ARGS = [_vp, _i64, _vp, _vp, _i64, _i64, _vp, _vp, _int, _int, _vp,
                _vp, _vp]
_ARGTYPES = {
    "ctpu_encode_indexed": _ENCODE_ARGS,
    "ctpu_encode_gamma": _ENCODE_ARGS,
    "ctpu_encode_single_row": [_vp, _i64, _i64, _vp, _vp, _int, _vp, _i64,
                               _vp, _vp],
    "ctpu_decode_indexed": _DECODE_ARGS,
    "ctpu_decode_gamma": _DECODE_ARGS,
    "ctpu_decode_single_row": [_vp, _i64, _vp, _i64, _i64, _vp, _vp, _int,
                               _vp, _vp, _vp],
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
    with torch.cuda.device(device):
        c_args = [a.data_ptr() if isinstance(a, torch.Tensor) else a
                  for a in args]
        rc = fn(*c_args, torch.cuda.current_stream(device).cuda_stream)
    LAUNCHES[name] += 1
    if rc != 0:
        raise RuntimeError(f"{name} kernel failed: CUDA error {rc}")


# -----------------------------------------------------------------------------
# Encoders: K1, K4', K6'
# -----------------------------------------------------------------------------
def _encode(name, symbols, indexes, cdf, meta, out_size, plain):
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
    fn = getattr(_lib("encode_indexed"), "ctpu_" + name)
    if single:
        _launch(name, fn, symbols, num_streams, n, cdf, meta, cdf.shape[1],
                out, out_size, lengths)
    else:
        _launch(name, fn, symbols, indexes, num_streams, n, cdf, meta,
                cdf.shape[0], cdf.shape[1], out, out_size, lengths)
    return out, lengths


def encode_indexed(symbols, indexes, cdf, meta, out_size: int):
    """K1: range-encodes every stream with a CDF row per element, escapes
    as the bare marker (sidecar format).

    Args:
      symbols: int32 [S, N]; out-of-range values map to the escape marker
        on overflow rows and are clipped on bounded rows.
      indexes: int32 [S, N] CDF row per element.
      cdf, meta: the table (see module docstring); row precision <= 16.
      out_size: bytes per output row, >= 2 * N + 2.

    Returns:
      (bytes uint8 [S, out_size] zero past each length, lengths int32 [S]).
    """
    return _encode("encode_indexed", symbols, indexes, cdf, meta, out_size,
                   encode_indexed_plain)


def encode_single_row(symbols, cdf, meta, out_size: int):
    """K4': range-encodes every stream with the table's one row; symbols
    are clipped to [0, length - 2].  cdf [1, L] / meta [1, 3]; other
    arguments and the result as for ``encode_indexed``."""
    return _encode("encode_single_row", symbols, None, cdf, meta, out_size,
                   encode_single_row_plain)


def encode_gamma(symbols, indexes, cdf, meta, out_size: int):
    """K6': the reference format's encode.  As ``encode_indexed``, but an
    escape on an overflow row is followed by its Elias-gamma magnitude and
    sign, each bit at precision 1.

    ``out_size`` must hold 2 * T + 2 bytes, T the most coded intervals of
    any stream (``interval_counts(...).sum(1).max()``); the kernel never
    writes past a row, but a shorter row would cut the stream.
    """
    return _encode("encode_gamma", symbols, indexes, cdf, meta, out_size,
                   encode_gamma_plain)


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
    """Plain PyTorch version of K4' (writes out, lengths)."""
    rows = torch.zeros_like(symbols, dtype=torch.int64)
    lo, hi, prec = _main_intervals(symbols, rows, cdf, meta, bounded=True)
    _encode_plain(lo.t(), hi.t(), prec.t(), None, out, lengths)


def encode_gamma_plain(symbols, indexes, cdf, meta, out, lengths):
    """Plain PyTorch version of K6' (writes out, lengths): the micro-op
    expansion of ``gamma_micro_ops`` run through the plain recurrence."""
    _encode_plain(*gamma_micro_ops(symbols, indexes, cdf, meta), out,
                  lengths)


def gamma_micro_ops(symbols, indexes, cdf, meta, num_steps=None):
    """Torch port of jax_coder.micro_ops_from_symbols: every element's
    coded intervals, compacted per stream.

    Args:
      symbols, indexes: int32 [S, N].
      cdf, meta: the table.
      num_steps: scan length T (default: the most intervals of any stream).

    Returns:
      (lower, upper, precision int64, mask bool), each [T, S]; padding
      steps are (0, 1, 1, False) as in the JAX package.
    """
    dev = symbols.device
    num_streams, n = symbols.shape
    rows = indexes.long().clamp(0, cdf.shape[0] - 1)
    count, escape, g, nbits = interval_counts(symbols, indexes, meta)
    c_lo, c_hi, prec_r = _main_intervals(symbols, rows, cdf, meta,
                                         bounded=False)
    if num_steps is None:
        num_steps = int(count.sum(1).max()) if count.numel() else 0
    shape = (num_streams, num_steps)
    lower = torch.zeros(shape, dtype=torch.int64, device=dev)
    upper = torch.ones(shape, dtype=torch.int64, device=dev)
    prec = torch.ones(shape, dtype=torch.int64, device=dev)
    mask = torch.zeros(shape, dtype=torch.bool, device=dev)
    offsets = count.cumsum(1) - count
    sid = torch.arange(num_streams, device=dev)[:, None].expand(-1, n)
    lower[sid, offsets] = c_lo
    upper[sid, offsets] = c_hi
    prec[sid, offsets] = prec_r
    mask[sid, offsets] = True
    es, ej = torch.nonzero(escape, as_tuple=True)
    if es.numel():
        # Slot k >= 1 of an escape: k <= nb unary zeros, then the nb + 1
        # bits of g from the top one down, then the sign.
        k = torch.arange(1, int(count.max()), device=dev)[None, :]
        nb = nbits[es, ej][:, None]
        ge = g[es, ej][:, None]
        sgn = (symbols[es, ej] < 0).long()[:, None]
        bit = (ge >> (2 * nb + 1 - k).clamp(0, 31)) & 1
        lo = torch.where(k <= nb, 0,
                         torch.where(k <= 2 * nb + 1, bit, sgn))
        active = k < count[es, ej][:, None]
        pos = (offsets[es, ej][:, None] + k)[active]
        rs = es[:, None].expand(-1, k.shape[1])[active]
        lower[rs, pos] = lo[active]
        upper[rs, pos] = lo[active] + 1
        mask[rs, pos] = True
    return lower.t(), upper.t(), prec.t(), mask.t()


def _encode_plain(lower, upper, prec, mask, out, lengths):
    """The encoder recurrence over [T, S] intervals (writes out, lengths).

    Vectorized over streams, one Python step per interval, in int64 with
    explicit 32-bit masks; ``mask`` (bool [T, S] or None) marks the steps
    that code.  Every renormalization reserves its two output bytes at
    once; a delayed-carry group keeps its reserved bytes at zero (the
    "carry up" fill) and rewrites them to 0xFF when it resolves down, which
    yields the reference RangeEncoder's bytes.
    """
    dev = out.device
    num_streams = out.shape[0]
    sid = torch.arange(num_streams, device=dev)
    cols = torch.arange(out.shape[1], device=dev)
    out.zero_()

    def put16(m, pos, val):
        r = sid[m]
        out[r, pos[m]] = ((val[m] >> 8) & 0xFF).to(torch.uint8)
        out[r, pos[m] + 1] = (val[m] & 0xFF).to(torch.uint8)

    z = torch.zeros(num_streams, dtype=torch.int64, device=dev)
    base, sm1, delay, ptr, pend = z, z + _M32, z, z, z
    for t in range(lower.shape[0]):
        c_lo, c_hi, p = lower[t], upper[t], prec[t]
        size = sm1 + 1
        a = (size * c_lo) >> p
        b = ((size * c_hi) >> p) - 1
        nb = (base + a) & _M32
        up = nb < a
        ns = (b - a) & _M32
        straddle = nb + ns > _M32
        renorm = (ns >> 16) == 0
        # Straddle resolved: the pending chunk becomes delay (carry up) or
        # delay - 1 with its fill bytes turned to 0xFF (carry down).
        res = ~straddle & (delay != 0)
        if mask is not None:
            renorm = renorm & mask[t]
            res = res & mask[t]
        if bool(res.any()):
            put16(res, pend, torch.where(up, delay, delay - 1))
            down = res & ~up & (ptr > pend + 2)
            if bool(down.any()):
                r = sid[down]
                fill = (cols >= pend[down, None] + 2) & (
                    cols < ptr[down, None])
                out[r] = torch.where(fill, torch.full_like(out[r], 0xFF),
                                     out[r])
            delay = torch.where(res, 0, delay)
        top = nb >> 16
        new_base = torch.where(renorm, (nb << 16) & _M32, nb)
        new_sm1 = torch.where(renorm, ((ns << 16) | 0xFFFF) & _M32, ns)
        if mask is None:
            base, sm1 = new_base, new_sm1
        else:
            base = torch.where(mask[t], new_base, base)
            sm1 = torch.where(mask[t], new_sm1, sm1)
        emit = renorm & ~straddle
        ambiguous = emit & (base + sm1 > _M32)
        put16(emit & ~ambiguous, ptr, top)
        delay = torch.where(ambiguous, top + 1, delay)
        pend = torch.where(ambiguous, ptr, pend)
        ptr = ptr + 2 * renorm.long()

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
def _decode(name, buf, byte_lens, indexes, num_elements, cdf, meta, plain):
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
    num_streams, n = buf.shape[0], int(num_elements)
    if byte_lens.shape[0] != num_streams:
        raise ValueError("buf and byte_lens disagree on streams")
    symbols = torch.empty((num_streams, n), dtype=torch.int32, device=device)
    sanity = torch.empty((num_streams,), dtype=torch.bool, device=device)
    if _device_kind(device) == "cpu":
        if single:
            plain(buf, byte_lens, cdf, meta, symbols, sanity)
        else:
            plain(buf, byte_lens, indexes, cdf, meta, symbols, sanity)
        return symbols, sanity
    fn = getattr(_lib("decode_indexed"), "ctpu_" + name)
    if single:
        _launch(name, fn, buf, buf.shape[1], byte_lens, num_streams, n, cdf,
                meta, cdf.shape[1], symbols, sanity)
    else:
        _launch(name, fn, buf, buf.shape[1], byte_lens, indexes, num_streams,
                n, cdf, meta, cdf.shape[0], cdf.shape[1], symbols, sanity)
    return symbols, sanity


def decode_indexed(buf, byte_lens, indexes, cdf, meta):
    """K2: range-decodes every stream with a CDF row per element (sidecar
    format).

    Args:
      buf: uint8 [S, W] stream bytes; bytes past byte_lens[s] read as zero.
      byte_lens: int32 [S].
      indexes: int32 [S, N] CDF row per element.
      cdf, meta: the table (see module docstring); row precision <= 16.

    Returns:
      (symbols int32 [S, N] with escapes as the marker length - 2,
       sanity bool [S]).
    """
    return _decode("decode_indexed", buf, byte_lens, indexes, None, cdf,
                   meta, decode_indexed_plain)


def decode_single_row(buf, byte_lens, num_elements, cdf, meta):
    """K5': range-decodes ``num_elements`` symbols per stream with the
    table's one row (cdf [1, L] / meta [1, 3], no overflow); otherwise as
    ``decode_indexed``."""
    return _decode("decode_single_row", buf, byte_lens, None, num_elements,
                   cdf, meta, decode_single_row_plain)


def decode_gamma(buf, byte_lens, indexes, cdf, meta):
    """K3': the reference format's decode.  As ``decode_indexed``, but the
    marker on an overflow row is followed by the escape's Elias-gamma
    magnitude and sign, and the symbol comes back as the escaped value."""
    return _decode("decode_gamma", buf, byte_lens, indexes, None, cdf, meta,
                   decode_gamma_plain)


def decode_indexed_plain(buf, byte_lens, indexes, cdf, meta, symbols,
                         sanity):
    """Plain PyTorch version of K2 (writes symbols, sanity)."""
    _decode_plain(buf, byte_lens, indexes, cdf, meta, symbols, sanity, False)


def decode_single_row_plain(buf, byte_lens, cdf, meta, symbols, sanity):
    """Plain PyTorch version of K5' (writes symbols, sanity)."""
    _decode_plain(buf, byte_lens, None, cdf, meta, symbols, sanity, False)


def decode_gamma_plain(buf, byte_lens, indexes, cdf, meta, symbols, sanity):
    """Plain PyTorch version of K3' (writes symbols, sanity)."""
    _decode_plain(buf, byte_lens, indexes, cdf, meta, symbols, sanity, True)


class _PlainDecoder:
    """RangeDecoder state of every stream, vectorized over streams in int64
    with explicit 32-bit masks."""

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
        self.base, self.sm1 = z, z + _M32
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
        self.base, self.sm1 = new_base, new_sm1
        self.value = torch.where(
            renorm, ((self.value << 16) | self._chunk(self.chunks_read))
            & _M32, self.value)
        self.chunks_read = self.chunks_read + renorm.long()

    def symbol(self, rows, prec):
        """Symbol search in rows [S, L] (padded dense rows); returns the
        count of entries below the threshold, clipped to L - 2, as
        jax_coder.decode_core resolves it."""
        max_len = rows.shape[1]
        size = self.sm1 + 1
        lower_bound = (((self.value - self.base) & _M32) + 1) << prec
        count = (size[:, None] * rows[:, 1:] < lower_bound[:, None]).sum(1)
        c_lo = rows.gather(1, count[:, None])[:, 0]
        c_hi = torch.where(
            count + 1 < max_len,
            rows.gather(1, (count + 1).clamp(max=max_len - 1)[:, None])[:, 0],
            65536)
        self.refine(((size * c_lo) >> prec) & _M32,
                    (((size * c_hi) >> prec) - 1) & _M32)
        return count.clamp(max=max_len - 2)

    def bit(self, mask):
        """decode_core's _decode_binary on the streams in ``mask``."""
        size = self.sm1 + 1
        lower_bound = (((self.value - self.base) & _M32) + 1) << 1
        b = (size < lower_bound).long()
        self.refine(((size * b) >> 1) & _M32,
                    (((size * (b + 1)) >> 1) - 1) & _M32, mask)
        return b

    def gamma(self, esc, mv):
        """OverflowDecode on the streams in ``esc``: the escaped values
        (int64, already wrapped to int32 range)."""
        n = torch.zeros_like(mv)
        act = esc
        while bool(act.any()):
            zero = self.bit(act) == 0
            n = n + (act & zero).long()
            act = act & zero & (n < 31)
        g = torch.where(esc, torch.ones_like(n) << n, 0)
        k = torch.where(esc, n, 0)
        while bool((k > 0).any()):
            act = k > 0
            g = torch.where(act, g | (self.bit(act) << (k - 1).clamp(min=0)),
                            g)
            k = k - act.long()
        sign = self.bit(esc)
        value = torch.where(sign == 1, -g, g + mv - 1) & _M32
        return torch.where(value >= 2 ** 31, value - 2 ** 32, value)

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


def _decode_plain(buf, byte_lens, indexes, cdf, meta, symbols, sanity,
                  gamma):
    """Decodes symbols [S, N]; ``indexes=None`` reads row 0 throughout;
    ``gamma`` selects in-stream Elias-gamma escapes (else escapes come back
    as the marker)."""
    num_streams, n = symbols.shape
    num_rows = cdf.shape[0]
    cdf64 = cdf.long()
    maxs, prec_r, ovf_r = meta.long().unbind(1)
    dec = _PlainDecoder(buf, byte_lens)
    for t in range(n):
        if indexes is None:
            row = torch.zeros(num_streams, dtype=torch.int64,
                              device=buf.device)
        else:
            row = indexes[:, t].long().clamp(0, num_rows - 1)
        sym = dec.symbol(cdf64[row], prec_r[row])
        if gamma:
            esc = (ovf_r[row] != 0) & (sym == maxs[row])
            if bool(esc.any()):
                sym = torch.where(esc, dec.gamma(esc, maxs[row]), sym)
        symbols[:, t] = sym.to(torch.int32)
    sanity.copy_(dec.sane(byte_lens))
