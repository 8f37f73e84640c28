"""The range coder's hand-written CUDA kernels, their wrappers and plain
PyTorch versions (counterpart of compression_tpu/codec/pallas_coder.py).

Two kernels, both one thread per coder stream (sources in ``csrc/``):

* ``encode_indexed`` (K1, ``csrc/encode_indexed.cu``) replaces
  ``pallas_coder.encode_indexed_device`` with its fused chunk post-pass.
* ``decode_indexed`` (K2, ``csrc/decode_indexed.cu``) replaces
  ``pallas_coder.decode_indexed_pallas(in_stream_gamma=False)``.

Each wrapper checks its inputs, allocates the outputs with ``torch.empty``
and then runs the plain version when the tensors lie on the CPU, or
launches the kernel on the current CUDA stream (and adds one to
``LAUNCHES[name]``) when they lie on a CUDA device.  There is no fallback
between the two: a CUDA tensor reaches the kernel or an exception.

The kernels are compiled by ``nvcc`` for ``sm_90a`` at first use (or by
``build()``), one process per source started together, into the package's
git-ignored ``_build/`` directory, and bound with ctypes through a plain C
interface that returns ``cudaGetLastError()``.

Both kernels take the table in the padded dense layout of
``tables.CdfTable`` (int32 ``cdf[num_rows, max_len]``, rows padded with
their terminal value) plus an int32 ``meta[num_rows, 3]`` of
(escape marker ``length - 2``, precision, overflow flag) per row.
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
    "encode_indexed_plain",
    "decode_indexed_plain",
]

#: Kernel launches per wrapper since the counts were last reset.
LAUNCHES = {"encode_indexed": 0, "decode_indexed": 0}

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_M32 = 0xFFFFFFFF
_LOCK = threading.Lock()
_LIBS: dict = {}

_vp, _i64, _int = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_ARGTYPES = {
    "ctpu_encode_indexed": [_vp, _vp, _i64, _i64, _vp, _vp, _int, _int,
                            _vp, _i64, _vp, _vp],
    "ctpu_decode_indexed": [_vp, _i64, _vp, _vp, _i64, _i64, _vp, _vp,
                            _int, _int, _vp, _vp, _vp],
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


def _check_table(cdf, meta, device):
    _check("cdf", cdf, torch.int32, 2, device)
    _check("meta", meta, torch.int32, 2, device)
    if meta.shape != (cdf.shape[0], 3) or cdf.shape[1] < 2:
        raise ValueError(
            f"table shapes cdf {tuple(cdf.shape)} / meta {tuple(meta.shape)}")


def _device_kind(device):
    if device.type == "cpu":
        return "cpu"
    if device.type == "cuda":
        return "cuda"
    raise ValueError(f"unsupported device {device}")


# -----------------------------------------------------------------------------
# K1: indexed range encode
# -----------------------------------------------------------------------------
def encode_indexed(symbols, indexes, cdf, meta, out_size: int):
    """Range-encodes every stream with a CDF row per element.

    Args:
      symbols: int32 [S, N]; out-of-range values map to the escape marker
        on overflow rows and are clipped on bounded rows.
      indexes: int32 [S, N] CDF row per element.
      cdf, meta: the table (see module docstring); row precision <= 16.
      out_size: bytes per output row, >= 2 * N + 2.

    Returns:
      (bytes uint8 [S, out_size] zero past each length, lengths int32 [S]).
    """
    device = symbols.device
    _check("symbols", symbols, torch.int32, 2, device)
    _check("indexes", indexes, torch.int32, 2, device)
    _check_table(cdf, meta, device)
    num_streams, n = symbols.shape
    if indexes.shape != symbols.shape:
        raise ValueError("symbols and indexes must have the same shape")
    if out_size < 2 * n + 2:
        raise ValueError(f"out_size {out_size} < 2 * {n} + 2")
    out = torch.empty((num_streams, out_size), dtype=torch.uint8,
                      device=device)
    lengths = torch.empty((num_streams,), dtype=torch.int32, device=device)
    if _device_kind(device) == "cpu":
        encode_indexed_plain(symbols, indexes, cdf, meta, out, lengths)
        return out, lengths
    with torch.cuda.device(device):
        rc = _lib("encode_indexed").ctpu_encode_indexed(
            symbols.data_ptr(), indexes.data_ptr(), num_streams, n,
            cdf.data_ptr(), meta.data_ptr(), cdf.shape[0], cdf.shape[1],
            out.data_ptr(), out_size, lengths.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream)
    LAUNCHES["encode_indexed"] += 1
    if rc != 0:
        raise RuntimeError(f"encode_indexed kernel failed: CUDA error {rc}")
    return out, lengths


def encode_indexed_plain(symbols, indexes, cdf, meta, out, lengths):
    """Plain PyTorch version of the encode kernel (writes out, lengths).

    Vectorized over streams, one Python step per symbol, in int64 with
    explicit 32-bit masks.  Every renormalization reserves its two output
    bytes at once; a delayed-carry group keeps its reserved bytes at zero
    (the "carry up" fill) and rewrites them to 0xFF when it resolves down,
    which yields the reference RangeEncoder's bytes.
    """
    dev = symbols.device
    num_streams, n = symbols.shape
    num_rows, max_len = cdf.shape
    flat = cdf.reshape(-1).long()
    maxs, prec_r, ovf_r = meta.long().unbind(1)
    ovf_r = ovf_r != 0
    sid = torch.arange(num_streams, device=dev)
    cols = torch.arange(out.shape[1], device=dev)
    out.zero_()

    def put16(mask, pos, val):
        r = sid[mask]
        out[r, pos[mask]] = ((val[mask] >> 8) & 0xFF).to(torch.uint8)
        out[r, pos[mask] + 1] = (val[mask] & 0xFF).to(torch.uint8)

    # Escape map and table reads for every step at once (they do not
    # depend on the coder state); the loop runs only the recurrence.
    rows = indexes.long().clamp(0, num_rows - 1).t().contiguous()
    v = symbols.long().t()
    mx = maxs[rows]
    vq = torch.where(v < 0, torch.where(ovf_r[rows], mx, 0),
                     torch.minimum(v, mx))
    lo_all = flat[rows * max_len + vq]
    hi_all = flat[rows * max_len + vq + 1]
    prec_all = prec_r[rows]

    z = torch.zeros(num_streams, dtype=torch.int64, device=dev)
    base, sm1, delay, ptr, pend = z, z + _M32, z, z, z
    for t in range(n):
        c_lo, c_hi, p = lo_all[t], hi_all[t], prec_all[t]
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
        base = torch.where(renorm, (nb << 16) & _M32, nb)
        sm1 = torch.where(renorm, ((ns << 16) | 0xFFFF) & _M32, ns)
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
    upper = (base + sm1) & _M32
    mid24 = ((base - 1) >> 24) + 1
    use24 = fin & (mid24 <= (upper >> 24))
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
# K2: indexed sidecar range decode
# -----------------------------------------------------------------------------
def decode_indexed(buf, byte_lens, indexes, cdf, meta):
    """Range-decodes every stream with a CDF row per element (sidecar mode).

    Args:
      buf: uint8 [S, W] stream bytes; bytes past byte_lens[s] read as zero.
      byte_lens: int32 [S].
      indexes: int32 [S, N] CDF row per element.
      cdf, meta: the table (see module docstring); row precision <= 16.

    Returns:
      (symbols int32 [S, N] with escapes as the marker length - 2,
       sanity bool [S]).
    """
    device = buf.device
    _check("buf", buf, torch.uint8, 2, device)
    _check("byte_lens", byte_lens, torch.int32, 1, device)
    _check("indexes", indexes, torch.int32, 2, device)
    _check_table(cdf, meta, device)
    num_streams, n = indexes.shape
    if buf.shape[0] != num_streams or byte_lens.shape[0] != num_streams:
        raise ValueError("buf, byte_lens and indexes disagree on streams")
    symbols = torch.empty((num_streams, n), dtype=torch.int32, device=device)
    sanity = torch.empty((num_streams,), dtype=torch.bool, device=device)
    if _device_kind(device) == "cpu":
        decode_indexed_plain(buf, byte_lens, indexes, cdf, meta, symbols,
                             sanity)
        return symbols, sanity
    with torch.cuda.device(device):
        rc = _lib("decode_indexed").ctpu_decode_indexed(
            buf.data_ptr(), buf.shape[1], byte_lens.data_ptr(),
            indexes.data_ptr(), num_streams, n, cdf.data_ptr(),
            meta.data_ptr(), cdf.shape[0], cdf.shape[1], symbols.data_ptr(),
            sanity.data_ptr(), torch.cuda.current_stream(device).cuda_stream)
    LAUNCHES["decode_indexed"] += 1
    if rc != 0:
        raise RuntimeError(f"decode_indexed kernel failed: CUDA error {rc}")
    return symbols, sanity


def decode_indexed_plain(buf, byte_lens, indexes, cdf, meta, symbols,
                         sanity):
    """Plain PyTorch version of the decode kernel (writes symbols, sanity).

    The symbol search counts the row entries below the threshold in the
    padded table, as jax_coder.decode_core does, so corrupt streams decode
    to the same symbols and flags.
    """
    dev = buf.device
    num_streams, n = indexes.shape
    num_rows, max_len = cdf.shape
    lens = byte_lens.long()
    width = buf.shape[1]
    # Zero past each stream's end, plus room for every chunk a decode can
    # read (two at start, at most one per symbol).
    data = torch.zeros((num_streams, max(width, 2 * n + 4) + 2),
                       dtype=torch.int64, device=dev)
    cols = torch.arange(width, device=dev)
    data[:, :width] = torch.where(cols[None, :] < lens[:, None], buf.long(), 0)
    cdf64 = cdf.long()
    prec_r = meta[:, 1].long()

    def chunk(k):
        p = (2 * k)[:, None]
        return (data.gather(1, p)[:, 0] << 8) | data.gather(1, p + 1)[:, 0]

    z = torch.zeros(num_streams, dtype=torch.int64, device=dev)
    base, sm1 = z, z + _M32
    value = (chunk(z) << 16) | chunk(z + 1)
    chunks_read = z + 2
    for t in range(n):
        row = indexes[:, t].long().clamp(0, num_rows - 1)
        p = prec_r[row]
        size = sm1 + 1
        lower_bound = (((value - base) & _M32) + 1) << p
        rows = cdf64[row]
        count = (size[:, None] * rows[:, 1:] < lower_bound[:, None]).sum(1)
        c_lo = rows.gather(1, count[:, None])[:, 0]
        c_hi = torch.where(
            count + 1 < max_len,
            rows.gather(1, (count + 1).clamp(max=max_len - 1)[:, None])[:, 0],
            65536)
        symbols[:, t] = count.clamp(max=max_len - 2).to(torch.int32)
        a = ((size * c_lo) >> p) & _M32
        b = (((size * c_hi) >> p) - 1) & _M32
        nb = (base + a) & _M32
        ns = (b - a) & _M32
        renorm = (ns >> 16) == 0
        base = torch.where(renorm, (nb << 16) & _M32, nb)
        sm1 = torch.where(renorm, ((ns << 16) | 0xFFFF) & _M32, ns)
        value = torch.where(
            renorm, ((value << 16) | chunk(chunks_read)) & _M32, value)
        chunks_read = chunks_read + renorm.long()

    upper = (base + sm1) & _M32
    bm1 = (base - 1) & _M32
    shift = torch.where((bm1 >> 24) < (upper >> 24), 24, 16)
    mid = (bm1 >> shift) + 1
    ok = torch.where((base == 0) | (upper < base), value == 0,
                     ((mid << shift) & _M32) == value)
    sanity.copy_(ok & (2 * chunks_read >= lens))
