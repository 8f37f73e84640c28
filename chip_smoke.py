#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (compression_tpu_torch) on one GPU.

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases, one JSON line each (any failure exits non-zero):
  1. card: nvidia-smi name and power limit, torch/CUDA versions, TF32 flags;
  2. build: nvcc builds every kernel under compression_tpu_torch/codec/csrc;
  3. kernels: each of the six kernels against its plain PyTorch version on
     the card, all results identical --
     K1/K2 (indexed sidecar) at the native path's shapes, on a stress shape,
     on every golden case of tests/golden/golden.npz (bytes equal the
     reference coder's) and on corrupted streams;
     K4'/K5' (single row) at the coder micro-bench's regime (32768 streams x
     512 symbols of a zipf row at precision 12), on every golden case and
     on corrupted streams;
     K6'/K3' (in-stream gamma) at the classic container's shape (one stream
     of a 512x512 image's latent), on 8192 x 512 of a 64-row Gaussian
     overflow table with escapes at rate 2^-8, on one 8192-symbol stream,
     on escapes of every size up to the INT32 extremes and on corrupted
     streams;
  4. main paths, each with the launch counts reset just before it and read
     just after: (a) bls2017 at num_filters=128 (seeded init, its own
     tables) on a 512x512 and a 768x512 image through compress_native /
     decompress / reconstruct / compress_native_many /
     decompress_native_many; (b) the same images through the classic
     .tfci container, compress / decompress, and a latent scaled past the
     table through the entropy model's compress / decompress; (c) the coder
     front end, encode_streams / decode_streams, at the micro-bench regime;
  5. reference: the CPU codec writes the same containers on a small image,
     and the reference's golden_model.npz .tfci container decodes on the
     card to its exact uint8 image;
  6. times: kernels and plain versions at the main paths' shapes (CUDA
     events), their bounds, and end-to-end ms per image of both containers.

The line before the last two is {"kernels": [...]}, then the card's name and
power limit, and the last line is {"ok": true, "device": {...}}.  Nothing of
JAX is imported: on the card the port is compared only with itself and with
the reference's golden bytes.
"""

import json
import math
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
# Published H100 SXM peaks (NVIDIA data sheet): HBM rate, and the float32
# rate outside the tensor cores, used as the rate of the scalar integer
# ALU work the coder kernels do.
PEAK_BYTES_PER_S = 3.35e12
PEAK_SCALAR_OPS_PER_S = 67e12

# The run's sizes: bls2017 at its published width, a 512x512 image
# (256 streams x 512 symbols native, one stream of 131072 classic) and a
# Kodak-size 768x512 one (512 x 384 native, 196608 classic).
DEVICE = "cuda:0"
NUM_FILTERS = 128
IMAGES = {"512x512": (512, 512, 3), "768x512": (512, 768, 3)}
STRESS_SHAPE = (8192, 512)
# The coder micro-bench regime (bench.py): one zipf row, alpha 1.2 over 256
# symbols, precision 12.
SINGLE_ROW_SHAPE = (32768, 512)
# The indexed in-stream regime (bench.py bench_indexed) and one long stream.
GAMMA_SHAPE = (8192, 512)
LONG_STREAM = (1, 8192)
# (kernel name, source, TPU kernel it replaces)
KERNELS = [
    ("encode_indexed", "encode_indexed.cu", "pallas_coder.py:1819"),
    ("decode_indexed", "decode_indexed.cu", "pallas_coder.py:1259"),
    ("decode_gamma", "decode_indexed.cu", "pallas_coder.py:1259"),
    ("encode_single_row", "encode_indexed.cu", "pallas_coder.py:1542"),
    ("decode_single_row", "decode_indexed.cu", "pallas_coder.py:637"),
    ("encode_gamma", "encode_indexed.cu", "pallas_coder.py:134"),
]


def log(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters, warm=True):
    """Mean ms per call of fn over iters calls, by CUDA events."""
    import torch
    if warm:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def mixed_table(rng, num_rows, prec_lo, prec_hi, overflow):
    """Random ragged table: rows of 2..60 symbols at precisions in
    [prec_lo, prec_hi], with the given overflow flags."""
    from compression_tpu_torch.codec import tables
    cdfs, precs, ovfs = [], [], []
    for r in range(num_rows):
        prec = int(rng.randint(prec_lo, prec_hi + 1))
        if r == 0:
            prec = prec_hi
        alpha = int(rng.randint(2, 61))
        pmf = rng.dirichlet(np.full(alpha, 0.5))
        cdfs.append(tables.pmf_to_quantized_cdf(pmf, prec))
        precs.append(prec)
        ovfs.append(bool(overflow[r]))
    return tables.parse_ragged_cdf(
        tables.build_ragged_cdf(cdfs, precs, ovfs))


def zipf_table():
    """bench.py's workload table: zipf alpha 1.2 over 256 symbols at
    precision 12, one row, no overflow; returns (table, pmf)."""
    from compression_tpu_torch.codec import tables
    pmf = 1.0 / (1 + np.arange(256)) ** 1.2
    pmf /= pmf.sum()
    return tables.parse_ragged_cdf(tables.build_ragged_cdf(
        [tables.pmf_to_quantized_cdf(pmf, 12)], [12], [False])), pmf


def gaussian_table():
    """bench.py's indexed regime: 64 NoisyNormal rows spanning
    exp(linspace(log .11, log 256)) at precision 12 with overflow escapes;
    returns (table, scales)."""
    from compression_tpu_torch.codec import tables
    log_min, log_max = np.log(0.11), np.log(256.0)
    scales = np.exp(log_min + (log_max - log_min) * np.arange(64) / 63.0)
    rows = []
    for s in scales:
        half = int(min(np.ceil(4 * s) + 2, 192))
        x = np.arange(-half, half + 1)
        hi = np.asarray([0.5 * (1 + math.erf((v + 0.5) / (s * math.sqrt(2))))
                         for v in x])
        lo = np.asarray([0.5 * (1 + math.erf((v - 0.5) / (s * math.sqrt(2))))
                         for v in x])
        pmf = np.maximum(hi - lo, 1e-12)
        rows.append(pmf / pmf.sum() * (1 - 2 ** -8))
    cdfs = [tables.pmf_to_quantized_cdf(np.asarray(p, np.float32), 12)
            for p in rows]
    return tables.parse_ragged_cdf(tables.build_ragged_cdf(
        cdfs, [12] * 64, [True] * 64)), scales


#: Largest |kernel - plain| seen per kernel over every comparison.
MAX_ABS_ERR = {name: 0 for name, _, _ in KERNELS}


def _err(*pairs):
    return max((int((a.long() - b.long()).abs().max()) if a.numel() else 0)
               for a, b in pairs)


def _plain_ms(fn):
    """Runs a plain version once and returns its ms (CUDA events)."""
    return cuda_ms(fn, 1, warm=False)


def check_encode(name, kernel, plain, args, out_size):
    """Runs an encode kernel and its plain version on the same inputs;
    returns (bytes, lengths, identical, plain ms)."""
    import torch
    out_k, len_k = kernel(*args, out_size)
    torch.cuda.synchronize()
    out_p, len_p = torch.empty_like(out_k), torch.empty_like(len_k)
    ms = _plain_ms(lambda: plain(*args, out_p, len_p))
    same = bool(torch.equal(out_k, out_p) and torch.equal(len_k, len_p))
    MAX_ABS_ERR[name] = max(MAX_ABS_ERR[name],
                            _err((out_k, out_p), (len_k, len_p)))
    return out_k, len_k, same, ms


def check_decode(name, kernel, plain, args):
    """Runs a decode kernel and its plain version on the same inputs;
    returns (symbols, sanity, identical, plain ms)."""
    import torch
    sym_k, san_k = kernel(*args)
    torch.cuda.synchronize()
    sym_p, san_p = torch.empty_like(sym_k), torch.empty_like(san_k)
    ms = _plain_ms(lambda: plain(*args, sym_p, san_p))
    same = bool(torch.equal(sym_k, sym_p) and torch.equal(san_k, san_p))
    MAX_ABS_ERR[name] = max(MAX_ABS_ERR[name],
                            _err((sym_k, sym_p), (san_k, san_p)))
    return sym_k, san_k, same, ms


def compare_kernels(name, table, symbols, indexes, out_size, fails):
    """K1 and K2 against their plain versions on one input; returns the
    kernel's (bytes, lengths)."""
    from compression_tpu_torch.codec import cuda_coder as cc
    cdf, meta = table.indexed_arrays()
    out_k, len_k, enc_ok, _ = check_encode(
        "encode_indexed", cc.encode_indexed, cc.encode_indexed_plain,
        (symbols, indexes, cdf, meta), out_size)
    _, san_k, dec_ok, _ = check_decode(
        "decode_indexed", cc.decode_indexed, cc.decode_indexed_plain,
        (out_k, len_k, indexes, cdf, meta))
    log("kernels", case=name, streams=int(symbols.shape[0]),
        symbols=int(symbols.shape[1]), rows=int(cdf.shape[0]),
        max_precision=int(meta[:, 1].max()), encode_identical=enc_ok,
        decode_identical=dec_ok, sanity_all=bool(san_k.all()))
    if not (enc_ok and dec_ok and bool(san_k.all())):
        fails.append(name)
    return out_k, len_k


def compare_single_row(name, table, symbols, fails, expect=None):
    """K4' and K5' against their plain versions; returns (bytes, lengths,
    plain encode ms, plain decode ms)."""
    import torch
    from compression_tpu_torch.codec import cuda_coder as cc, torch_coder
    cdf, meta = table.indexed_arrays()
    n = int(symbols.shape[1])
    out_k, len_k, enc_ok, enc_ms = check_encode(
        "encode_single_row", cc.encode_single_row, cc.encode_single_row_plain,
        (symbols, cdf, meta), torch_coder.stream_out_size(n))
    sym_k, san_k, dec_ok, dec_ms = check_decode(
        "decode_single_row",
        lambda b, ln, c, m: cc.decode_single_row(b, ln, n, c, m),
        cc.decode_single_row_plain, (out_k, len_k, cdf, meta))
    exact = bool(torch.equal(sym_k, symbols if expect is None else expect))
    log("kernels", case=name, streams=int(symbols.shape[0]), symbols=n,
        rows=1, max_precision=int(meta[0, 1]), encode_identical=enc_ok,
        decode_identical=dec_ok, sanity_all=bool(san_k.all()),
        round_trip=exact)
    if not (enc_ok and dec_ok and exact and bool(san_k.all())):
        fails.append(name)
    return out_k, len_k, enc_ms, dec_ms


def compare_gamma(name, table, symbols, indexes, fails, round_trip=True):
    """K6' and K3' against their plain versions; returns (bytes, lengths,
    coded intervals, plain encode ms, plain decode ms)."""
    import torch
    from compression_tpu_torch.codec import cuda_coder as cc, torch_coder
    cdf, meta = table.indexed_arrays()
    counts, escape, _, _ = cc.interval_counts(symbols, indexes, meta)
    intervals = int(counts.sum())
    out_size = torch_coder.stream_out_size(int(counts.sum(1).max()))
    out_k, len_k, enc_ok, enc_ms = check_encode(
        "encode_gamma", cc.encode_gamma, cc.encode_gamma_plain,
        (symbols, indexes, cdf, meta), out_size)
    sym_k, san_k, dec_ok, dec_ms = check_decode(
        "decode_gamma", cc.decode_gamma, cc.decode_gamma_plain,
        (out_k, len_k, indexes, cdf, meta))
    exact = bool(torch.equal(sym_k, symbols)) if round_trip else None
    log("kernels", case=name, streams=int(symbols.shape[0]),
        symbols=int(symbols.shape[1]), rows=int(cdf.shape[0]),
        escapes=int(escape.sum()), coded_intervals=intervals,
        encode_identical=enc_ok, decode_identical=dec_ok,
        sanity_all=bool(san_k.all()), round_trip=exact)
    if not (enc_ok and dec_ok and exact is not False
            and (bool(san_k.all()) or not round_trip)):
        fails.append(name)
    return out_k, len_k, intervals, enc_ms, dec_ms


def golden_cases(table_cls, device, fails):
    """Every golden.npz case through K1/K2 (on an indexed table) and K4'/K5'
    (on its single row): kernel bytes == reference bytes == plain."""
    import torch
    from compression_tpu_torch.codec import tables, torch_coder
    gold = np.load(os.path.join(REPO, "tests", "golden", "golden.npz"))
    names = sorted({k.rsplit("__", 1)[0] for k in gold.files
                    if k.endswith("__cdf")})
    bad = []
    for name in names:
        data = gold[f"{name}__data"].astype(np.int32)
        prec = int(gold[f"{name}__precision"])
        table = table_cls(tables.parse_ragged_cdf(tables.build_ragged_cdf(
            [gold[f"{name}__cdf"]], [prec], [False])), device)
        sym = torch.as_tensor(data[None], device=device)
        idx = torch.zeros_like(sym)
        out_size = torch_coder.stream_out_size(sym.shape[1])
        ref = gold[f"{name}__bytes"].tobytes()
        fails_here = []
        out, lens = compare_kernels(f"golden/{name}", table, sym, idx,
                                    out_size, fails_here)
        got = out[0, : int(lens[0])].cpu().numpy().tobytes()
        dec, san = torch_coder.decode_dispatch(out, lens, sym.shape[1], table,
                                               idx)
        out1, lens1, _, _ = compare_single_row(
            f"golden/{name}/single_row", table, sym, fails_here)
        got1 = out1[0, : int(lens1[0])].cpu().numpy().tobytes()
        if fails_here or got != ref or got1 != ref \
                or not torch.equal(dec, sym) or not bool(san.all()):
            bad.append(name)
    log("golden", cases=len(names), kernels=["encode_indexed",
                                             "decode_indexed",
                                             "encode_single_row",
                                             "decode_single_row"],
        mismatched=bad)
    fails.extend(f"golden/{b}" for b in bad)


def corruptions(buf, lens, seed):
    """Truncated, bit-flipped, random and empty versions of the streams,
    zero past each length as in a real container."""
    import torch
    gen = torch.Generator(device=buf.device).manual_seed(seed)
    cases = {
        "truncated": (buf, torch.clamp(lens // 2, min=0)),
        "bitflip": (buf ^ (torch.rand(buf.shape, generator=gen,
                                      device=buf.device) < 0.002).to(
                                          torch.uint8) * 16, lens),
        "random": (torch.randint(0, 256, buf.shape, generator=gen,
                                 device=buf.device, dtype=torch.uint8), lens),
        "empty": (torch.zeros_like(buf), torch.zeros_like(lens)),
    }
    out = {}
    for name, (b, ln) in cases.items():
        cols = torch.arange(b.shape[1], device=b.device)
        b = torch.where(cols[None, :] < ln[:, None].long(), b, 0).to(
            torch.uint8).contiguous()
        out[name] = (b, ln.contiguous())
    return out


def corrupt_cases(label, kernel, plain, buf, lens, extra, seed, fails):
    """Sanity flags and symbols of a decode kernel equal its plain
    version's on corrupted streams; ``extra`` are the arguments after
    (buf, lens)."""
    detected = {}
    for name, (b, ln) in corruptions(buf, lens, seed).items():
        _, san_k, same, _ = check_decode(label, kernel, plain,
                                         (b, ln) + extra)
        if not same:
            fails.append(f"corrupt/{label}/{name}")
        detected[name] = int((~san_k).sum())
    log("corrupt", kernel=label, streams=int(buf.shape[0]), flagged=detected,
        identical=not any(f.startswith(f"corrupt/{label}/") for f in fails))


def _table_bytes(cdf, meta):
    return cdf.numel() * 4 + meta.numel() * 4


def encode_bound(num_streams, n, cdf, meta, out_size, intervals=None,
                 with_indexes=True):
    """Least time (ms) for an encode kernel: each input read once (symbols,
    indexes when it takes them, the table), each output written once,
    against ~12 scalar operations per coded interval (two 64-bit products,
    two shifts, four adds, three compares, the escape select); intervals
    counts this run's escapes' gamma bits."""
    nbytes = ((2 if with_indexes else 1) * num_streams * n * 4
              + _table_bytes(cdf, meta) + num_streams * out_size
              + num_streams * 4)
    ops = 12 * (num_streams * n if intervals is None else intervals)
    return _bound(nbytes, ops)


def decode_bound(lens, n, cdf, meta, gamma_bits=0, with_indexes=True):
    """Least time (ms) for a decode kernel: input bytes actually present
    (the streams' lengths), indexes and table read once, symbols and flags
    written once; ~2 operations per binary-search probe plus ~10 for the
    update per symbol, ~12 per gamma bit this run's data holds."""
    s = lens.shape[0]
    nbytes = (int(lens.sum()) + s * 4 + (s * n * 4 if with_indexes else 0)
              + _table_bytes(cdf, meta) + s * n * 4 + s)
    probes = math.ceil(math.log2(max(cdf.shape[1] - 1, 2)))
    ops = (2 * probes + 10) * s * n + 12 * gamma_bits
    return _bound(nbytes, ops)


def _bound(nbytes, ops):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_SCALAR_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations")


def reset_counts():
    from compression_tpu_torch.codec import cuda_coder, torch_coder
    for k in cuda_coder.LAUNCHES:
        cuda_coder.LAUNCHES[k] = 0
    torch_coder.DISPATCH_LOG.clear()


def read_counts(keys):
    import torch
    from compression_tpu_torch.codec import cuda_coder, torch_coder
    torch.cuda.synchronize()
    return (dict(cuda_coder.LAUNCHES),
            {k: torch_coder.DISPATCH_LOG.get(k) for k in keys})


def e2e_times(compress, decompress, img, runs=10):
    """Median and max ms of compress and decompress (host clock around work
    that ends in a synchronize), after one warm-up."""
    import torch
    decompress(compress(img))  # warm
    comp, dec = [], []
    for _ in range(runs):
        t0 = time.perf_counter()
        container = compress(img)
        torch.cuda.synchronize()
        comp.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        decompress(container)
        torch.cuda.synchronize()
        dec.append((time.perf_counter() - t0) * 1e3)
    return {"compress_ms_median": float(np.median(comp)),
            "compress_ms_max": max(comp),
            "decompress_ms_median": float(np.median(dec)),
            "decompress_ms_max": max(dec), "runs": runs,
            "container_bytes": len(container)}


def main():
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: torch is missing: {e}", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(REPO, "compression_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository (the "
              "compression_tpu_torch package is missing)", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from compression_tpu_torch.codec import cuda_coder as cc
    from compression_tpu_torch.codec import torch_coder
    from compression_tpu_torch.models import bls2017, native_format
    from compression_tpu_torch.util.packed_tensors import PackedTensors

    t_start = time.time()
    device = torch.device(DEVICE)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = nvidia_smi_line()
    log("card", nvidia_smi=smi, name=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda,
        cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
        matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32)

    t0 = time.time()
    libs = cc.build()
    log("build", seconds=round(time.time() - t0, 3), libraries=sorted(libs))

    fails = []
    # The codec first: its entropy model gives the main path's table.
    t0 = time.time()
    model = bls2017.BLS2017Model(num_filters=NUM_FILTERS, seed=0)
    codec = bls2017.BLS2017Codec(model, device=device)
    table = codec.em.device_table
    cdf, meta = table.indexed_arrays()
    log("codec", num_filters=NUM_FILTERS, seconds=round(time.time() - t0, 3),
        table_rows=table.num_rows, table_max_len=table.max_len,
        precision=int(table.max_precision), any_overflow=table.any_overflow)

    rng = np.random.RandomState(0)
    images = {name: rng.randint(0, 256, shape).astype(np.uint8)
              for name, shape in IMAGES.items()}
    first = next(iter(IMAGES))
    extra = [rng.randint(0, 256, IMAGES[first]).astype(np.uint8)
             for _ in range(2)]

    # Phase 3: kernels against their plain versions.
    # K1/K2 at the native path's shapes, with and without escapes.
    main_inputs = {}
    with torch.no_grad():
        for name, img in images.items():
            y = codec._analysis(codec._upload(img))
            symbols, _, row_ids = codec.em._symbols_from_bottleneck(
                native_format.to_streams(y))
            idx = row_ids.to(torch.int32)[None].expand_as(symbols).contiguous()
            out_size = torch_coder.stream_out_size(symbols.shape[1])
            escapes = int(((symbols < 0) | (symbols >= (
                table.length[row_ids] - 2)[None])).sum())
            log("main_shape", image=name, streams=int(symbols.shape[0]),
                symbols=int(symbols.shape[1]), escapes=escapes)
            buf, lens = compare_kernels(f"main/{name}", table, symbols, idx,
                                        out_size, fails)
            main_inputs[name] = (symbols, idx, out_size, buf, lens)
            # The same shape with ~2% of the symbols pushed out of range
            # on either side (escapes on the table's overflow rows).
            gen = torch.Generator(device=device).manual_seed(3)
            pick = torch.rand(symbols.shape, generator=gen, device=device)
            marker = (table.length[row_ids] - 2)[None]
            esc = torch.where(pick < 0.01, -3 - symbols.abs(), symbols)
            esc = torch.where(pick > 0.99, marker + 5, esc)
            compare_kernels(f"main/{name}+escapes", table,
                            esc.to(torch.int32).contiguous(), idx, out_size,
                            fails)
    srng = np.random.RandomState(1)
    for label, (lo, hi) in {"stress/p8-16": (8, 16),
                            "stress/p8-15": (8, 15)}.items():
        st = torch_coder.DeviceCdfTable(mixed_table(
            srng, 96, lo, hi, srng.rand(96) < 0.5), device)
        s, n = STRESS_SHAPE
        idx = torch.as_tensor(srng.randint(0, st.num_rows, (s, n)),
                              dtype=torch.int32, device=device)
        marker = st.length.long()[idx.long()] - 2
        sym = (torch.rand((s, n), device=device) * (marker + 3).float()
               ).long() - 1
        sym = sym.to(torch.int32).contiguous()
        compare_kernels(label, st, sym, idx,
                        torch_coder.stream_out_size(n), fails)
        stress_input = (sym, idx, st, torch_coder.stream_out_size(n))
    symbols, idx, _, buf, lens = main_inputs[first]
    corrupt_cases("decode_indexed", cc.decode_indexed, cc.decode_indexed_plain,
                  buf, lens, (idx, cdf, meta), 5, fails)

    # K4'/K5' at the micro-bench regime, and corrupted streams.
    ztab, zpmf = zipf_table()
    ztable = torch_coder.DeviceCdfTable(ztab, device)
    zcdf, zmeta = ztable.indexed_arrays()
    zsym = torch.as_tensor(np.random.RandomState(0).choice(
        256, size=SINGLE_ROW_SHAPE, p=zpmf).astype(np.int32), device=device)
    zbuf, zlens, k4_plain, k5_plain = compare_single_row(
        "single_row/zipf", ztable, zsym, fails)
    n_z = SINGLE_ROW_SHAPE[1]
    clipped = zsym.clone()
    clipped[:64, :3] = torch.tensor([-7, 300, 2 ** 31 - 1], dtype=torch.int32)
    compare_single_row("single_row/clip", ztable, clipped[:64].contiguous(),
                       fails, expect=clipped[:64].clamp(0, 255))
    corrupt_cases("decode_single_row",
                  lambda b, ln, c, m: cc.decode_single_row(b, ln, n_z, c, m),
                  cc.decode_single_row_plain, zbuf[:4096].contiguous(),
                  zlens[:4096].contiguous(), (zcdf, zmeta), 6, fails)
    golden_cases(torch_coder.DeviceCdfTable, device, fails)

    # K6'/K3': the bench's indexed regime with escapes at rate 2^-8, one
    # long stream, escapes of every size, corrupted streams, and the
    # classic container's one stream of the 512x512 latent.
    gtab, scales = gaussian_table()
    gtable = torch_coder.DeviceCdfTable(gtab, device)
    gcdf, gmeta = gtable.indexed_arrays()
    grng = np.random.RandomState(2)
    s, n = GAMMA_SHAPE
    gidx = grng.randint(0, 64, (s, n)).astype(np.int32)
    max_sym = gtab.length[gidx] - 2
    gsym = np.minimum(np.round(np.abs(grng.normal(0, 1, (s, n)))
                               * scales[gidx] * 0.25), max_sym).astype(
                                   np.int32)
    esc_mask = grng.rand(s, n) < 2.0 ** -8
    gsym[esc_mask] = max_sym[esc_mask] + grng.randint(1, 40, esc_mask.sum())
    gsym_t = torch.as_tensor(gsym, device=device)
    gidx_t = torch.as_tensor(gidx, device=device)
    gbuf, glens, _, _, _ = compare_gamma("gamma/gaussian", gtable, gsym_t,
                                         gidx_t, fails)
    lsym = gsym_t[:16].reshape(LONG_STREAM).contiguous()
    lidx = gidx_t[:16].reshape(LONG_STREAM).contiguous()
    lbuf, llens, _, _, _ = compare_gamma("gamma/long_stream", gtable, lsym,
                                         lidx, fails)
    edge = gsym_t[:64, :64].clone()
    edge_vals = [-2 ** 31, 2 ** 31 - 1, 2 ** 20, -2 ** 20, 2 ** 30 + 7,
                 -(2 ** 31 - 1), 2 ** 24, -1]
    for i, v in enumerate(edge_vals):
        edge[i, 5] = v
        edge[i + 8, 7] = v
    # INT32_MIN (and +2^31-ish magnitudes past 31 gamma bits) do not
    # round-trip in the reference format: compare with the plain version
    # only; the other values round-trip.
    compare_gamma("gamma/extremes", gtable, edge.contiguous(),
                  gidx_t[:64, :64].contiguous(), fails, round_trip=False)
    safe = edge[[i for i in range(64) if i not in (0, 8)]].contiguous()
    safe_idx = gidx_t[:64, :64][[i for i in range(64)
                                 if i not in (0, 8)]].contiguous()
    compare_gamma("gamma/large_magnitudes", gtable, safe, safe_idx, fails)
    corrupt_cases("decode_gamma", cc.decode_gamma, cc.decode_gamma_plain,
                  gbuf[:2048].contiguous(), glens[:2048].contiguous(),
                  (gidx_t[:2048].contiguous(), gcdf, gmeta), 7, fails)
    with torch.no_grad():
        y = codec._analysis(codec._upload(images[first]))
        csym, _, crow = codec.em._symbols_from_bottleneck(y)
    cidx = crow.to(torch.int32)[None].expand_as(csym).contiguous()
    cbuf, clens, c_intervals, k6_plain, k3_plain = compare_gamma(
        f"gamma/classic_{first}", table, csym, cidx, fails)

    # Phase 4a: the native container (PR 1's main path).
    reset_counts()
    main_ok = True
    for name, img in images.items():
        container = codec.compress_native(img)
        x_hat = codec.decompress(container)
        recon = codec.reconstruct(img)
        exact = bool(np.array_equal(x_hat, recon))
        main_ok &= exact and x_hat.shape == img.shape and (
            x_hat.dtype == np.uint8)
        log("main_path", image=name, container_bytes=len(container),
            bits_per_pixel=8 * len(container) / (img.shape[0] * img.shape[1]),
            decompress_equals_reconstruct=exact, shape=list(x_hat.shape))
    batch = list(images.values()) + extra
    many = codec.compress_native_many(batch)
    single = [codec.compress_native(x) for x in batch]
    dec_many = codec.decompress_native_many(many)
    many_ok = many == single and all(
        np.array_equal(a, codec.decompress(c)) for a, c in zip(dec_many, many))
    native_launches, paths = read_counts(("encode", "decode_sidecar"))
    log("main_path_many", images=len(batch), containers_equal=many_ok,
        launches=native_launches, dispatch=paths)
    if not (main_ok and many_ok and native_launches["encode_indexed"] > 0
            and native_launches["decode_indexed"] > 0
            and set(paths.values()) == {"cuda-indexed"}):
        fails.append("main_path")

    # Escapes through the native container: a latent scaled to twice the
    # table's width codes its tails in the sidecar and decodes to its
    # quantization.
    with torch.no_grad():
        y = codec._analysis(codec._upload(images[first]))
        scale = 2.0 * table.max_len / float(y.abs().max())
        y_wide = scale * y
        cont = codec._container(codec._encode_latent(y_wide),
                                IMAGES[first][:2])
        y_hat, sanity, _ = codec._decode_latent(codec._unpack(cont))
        esc_ok = bool(torch.equal(y_hat, codec.em.quantize(y_wide))
                      and sanity.all())
        n_esc = len(codec._unpack(cont).unpack(
            ["bytes", np.int32, np.int32, np.int32, np.int32])[4])
    log("main_path_escapes", image=first, latent_scale=scale, escapes=n_esc,
        decode_equals_quantize=esc_ok)
    if not esc_ok or n_esc == 0:
        fails.append("main_path_escapes")

    # Phase 4b: the classic .tfci container, and the entropy model's
    # reference format on a latent scaled past the table (many escapes).
    with torch.no_grad():
        native_latents = {
            name: codec._decode_latent(codec._unpack(
                codec.compress_native(img)))[0]
            for name, img in images.items()}
    reset_counts()
    classic_ok, n_compress, n_decompress = True, 0, 0
    classic = {}
    for name, img in images.items():
        container = codec.compress(img)
        n_compress += 1
        x_hat = codec.decompress(container)
        n_decompress += 1
        with torch.no_grad():
            y_c, ok_c, _ = codec._decode_latent(codec._unpack(container))
            n_decompress += 1
        exact = bool(np.array_equal(x_hat, codec.reconstruct(img)))
        same_latent = bool(torch.equal(y_c, native_latents[name])
                           and ok_c.all())
        classic_ok &= exact and same_latent and x_hat.shape == img.shape
        classic[name] = container
        log("classic_path", image=name, container_bytes=len(container),
            bits_per_pixel=8 * len(container) / (img.shape[0] * img.shape[1]),
            decompress_equals_reconstruct=exact,
            latent_equals_native=same_latent)
    containers = list(classic.values())
    classic_many = codec.decompress_native_many(containers)
    many_ok = all(np.array_equal(a, codec.decompress(c))
                  for a, c in zip(classic_many, containers))
    n_decompress += 2 * len(containers)
    with torch.no_grad():
        buf_w, lens_w = codec.em.compress(y_wide)
        n_compress += 1
        y_back = codec.em.decompress(buf_w, (y_wide.shape[1],
                                             y_wide.shape[2]), lens_w)
        n_decompress += 1
    wide_ok = bool(torch.equal(y_back, codec.em.quantize(y_wide)))
    classic_launches, classic_paths = read_counts(("encode", "decode"))
    log("classic_path_escapes", image=first, latent_scale=scale,
        decode_equals_quantize=wide_ok, many_equal_single=many_ok,
        classic_compress_calls=n_compress,
        classic_decompress_calls=n_decompress, launches=classic_launches,
        dispatch=classic_paths)
    # One encode launch per classic compress (K6' when the latent has
    # escapes, K1 when it has none) and one K3' launch per decode.
    if not (classic_ok and many_ok and wide_ok
            and classic_launches["encode_gamma"] > 0
            and classic_launches["encode_gamma"]
            + classic_launches["encode_indexed"] == n_compress
            and classic_launches["decode_gamma"] == n_decompress
            and classic_launches["decode_indexed"] == 0
            and all(p.startswith("cuda-") for p in classic_paths.values())):
        fails.append("classic_path")

    # Phase 4c: the coder front end at the micro-bench regime.
    reset_counts()
    fbuf, flens = torch_coder.encode_streams(zsym, ztable)
    fsym, fok = torch_coder.decode_streams(fbuf, flens, n_z, ztable)
    front_launches, front_paths = read_counts(("encode", "decode"))
    front_ok = bool(torch.equal(fsym, zsym) and fok.all()
                    and torch.equal(fbuf, zbuf))
    log("coder_front_end", shape=list(SINGLE_ROW_SHAPE), round_trip=front_ok,
        launches=front_launches, dispatch=front_paths)
    if not (front_ok and front_launches["encode_single_row"] == 1
            and front_launches["decode_single_row"] == 1
            and set(front_paths.values()) == {"cuda-single"}):
        fails.append("coder_front_end")

    # Phase 5: reference on a small input -- the CPU codec (plain coder)
    # given the same latent and tables writes the same containers.
    small = rng.randint(0, 256, (64, 96, 3)).astype(np.uint8)
    cpu_codec = bls2017.BLS2017Codec(
        bls2017.BLS2017Model(num_filters=NUM_FILTERS, seed=0), device="cpu",
        tables=codec.em.get_weights())
    with torch.no_grad():
        y = codec._analysis(codec._upload(small))
        c_gpu = codec._container(codec._encode_latent(y), small.shape[:2])
        c_cpu = cpu_codec._container(cpu_codec._encode_latent(y.cpu()),
                                     small.shape[:2])
        y_gpu = codec._decode_latent(codec._unpack(c_cpu))[0]
        y_cpu = cpu_codec._decode_latent(cpu_codec._unpack(c_gpu))[0]
        s_gpu = codec.em.compress_to_strings(3.0 * y)
        s_cpu = cpu_codec.em.compress_to_strings(3.0 * y.cpu())
    small_ok = c_gpu == c_cpu and torch.equal(y_gpu.cpu(), y_cpu) and bool(
        torch.isfinite(y_cpu).all()) and s_gpu == s_cpu
    log("reference_small", image="64x96", containers_identical=c_gpu == c_cpu,
        cross_decode_identical=bool(torch.equal(y_gpu.cpu(), y_cpu)),
        classic_strings_identical=s_gpu == s_cpu)
    if not small_ok:
        fails.append("reference_small")

    # The reference's trained model: its .tfci container decodes on the
    # card to its exact uint8 image, and its latent codes to its strings.
    gold = dict(np.load(os.path.join(REPO, "tests", "golden",
                                     "golden_model.npz")))
    gmodel = bls2017.BLS2017Model(num_filters=int(gold["num_filters"]))
    gmodel.load_state_dict(bls2017.params_from_tf(gold))
    gcodec = bls2017.BLS2017Codec(gmodel, device=device)
    x_hat = gcodec.decompress(gold["container"].tobytes())
    strings = gcodec.em.compress_to_strings(torch.as_tensor(gold["y"]))
    own = PackedTensors(gcodec.compress(gold["x_test"])).unpack(
        ["bytes", np.int32, np.int32])[0]
    ref = gold["strings_bytes"].tobytes()
    golden_ok = {
        "tables_equal": bool(np.array_equal(gcodec.em.cdf, gold["cdf"])),
        "container_decodes_exactly": bool(np.array_equal(
            x_hat, gold["x_hat_uint8"])),
        "pixels_off": int((x_hat != gold["x_hat_uint8"]).sum()),
        "strings_from_y_equal": strings == [ref],
        "strings_from_image_equal": own == [ref]}
    log("golden_model", **golden_ok)
    if not all(v for k, v in golden_ok.items() if k != "pixels_off"):
        fails.append("golden_model")

    # Phase 6: times at the main paths' shapes.
    saved = dict(cc.LAUNCHES)
    symbols, idx, out_size, buf, lens = main_inputs[first]
    out_p = torch.empty_like(buf)
    len_p = torch.empty_like(lens)
    sym_p = torch.empty_like(symbols)
    san_p = torch.empty((symbols.shape[0],), dtype=torch.bool, device=device)
    ms = {
        "encode_indexed": cuda_ms(lambda: cc.encode_indexed(
            symbols, idx, cdf, meta, out_size), 50),
        "decode_indexed": cuda_ms(lambda: cc.decode_indexed(
            buf, lens, idx, cdf, meta), 50),
        "encode_single_row": cuda_ms(lambda: cc.encode_single_row(
            zsym, zcdf, zmeta, zbuf.shape[1]), 20),
        "decode_single_row": cuda_ms(lambda: cc.decode_single_row(
            zbuf, zlens, n_z, zcdf, zmeta), 20),
        "encode_gamma": cuda_ms(lambda: cc.encode_gamma(
            csym, cidx, cdf, meta, cbuf.shape[1]), 5),
        "decode_gamma": cuda_ms(lambda: cc.decode_gamma(
            cbuf, clens, cidx, cdf, meta), 5),
    }
    plain_ms = {
        "encode_indexed": cuda_ms(lambda: cc.encode_indexed_plain(
            symbols, idx, cdf, meta, out_p, len_p), 3),
        "decode_indexed": cuda_ms(lambda: cc.decode_indexed_plain(
            buf, lens, idx, cdf, meta, sym_p, san_p), 3),
        "encode_single_row": k4_plain, "decode_single_row": k5_plain,
        "encode_gamma": k6_plain, "decode_gamma": k3_plain,
    }
    bounds = {
        "encode_indexed": encode_bound(*symbols.shape, cdf, meta, out_size),
        "decode_indexed": decode_bound(lens, symbols.shape[1], cdf, meta),
        "encode_single_row": encode_bound(*zsym.shape, zcdf, zmeta,
                                          zbuf.shape[1], with_indexes=False),
        "decode_single_row": decode_bound(zlens, n_z, zcdf, zmeta,
                                          with_indexes=False),
        "encode_gamma": encode_bound(*csym.shape, cdf, meta, cbuf.shape[1],
                                     intervals=c_intervals),
        "decode_gamma": decode_bound(clens, csym.shape[1], cdf, meta,
                                     gamma_bits=c_intervals - csym.numel()),
    }
    shapes = {
        "encode_indexed": list(symbols.shape),
        "decode_indexed": list(symbols.shape),
        "encode_single_row": list(zsym.shape),
        "decode_single_row": list(zsym.shape),
        "encode_gamma": list(csym.shape), "decode_gamma": list(csym.shape)}
    # The kernels' time as streams grow, and in the other regimes.
    st_sym, st_idx, st_table, st_out_size = stress_input
    st_cdf, st_meta = st_table.indexed_arrays()
    st_buf, st_lens = cc.encode_indexed(st_sym, st_idx, st_cdf, st_meta,
                                        st_out_size)
    def at(name, t):
        return f"{name}@{t.shape[0]}x{t.shape[1]}"
    z256, zb256, zl256 = zsym[:256], zbuf[:256], zlens[:256]
    # K6' and K3' on the input the classic main path gave K6': the latent
    # scaled past the table, one stream with many escapes.
    with torch.no_grad():
        wsym, _, wrow = codec.em._symbols_from_bottleneck(y_wide)
    widx = wrow.to(torch.int32)[None].expand_as(wsym).contiguous()
    wcounts, wesc, _, _ = cc.interval_counts(wsym, widx, meta)
    wbuf, wlens = cc.encode_gamma(wsym, widx, cdf, meta,
                                  torch_coder.stream_out_size(
                                      int(wcounts.sum(1).max())))
    other_ms = {
        at("encode_indexed", st_sym): cuda_ms(lambda: cc.encode_indexed(
            st_sym, st_idx, st_cdf, st_meta, st_out_size), 10),
        at("decode_indexed", st_sym): cuda_ms(lambda: cc.decode_indexed(
            st_buf, st_lens, st_idx, st_cdf, st_meta), 10),
        at("encode_gamma", gsym_t): cuda_ms(lambda: cc.encode_gamma(
            gsym_t, gidx_t, gcdf, gmeta, gbuf.shape[1]), 10),
        at("decode_gamma", gsym_t): cuda_ms(lambda: cc.decode_gamma(
            gbuf, glens, gidx_t, gcdf, gmeta), 10),
        at("encode_gamma", lsym): cuda_ms(lambda: cc.encode_gamma(
            lsym, lidx, gcdf, gmeta, lbuf.shape[1]), 10),
        at("decode_gamma", lsym): cuda_ms(lambda: cc.decode_gamma(
            lbuf, llens, lidx, gcdf, gmeta), 10),
        at("encode_gamma", wsym) + "+escapes": cuda_ms(
            lambda: cc.encode_gamma(wsym, widx, cdf, meta, wbuf.shape[1]), 5),
        at("decode_gamma", wsym) + "+escapes": cuda_ms(
            lambda: cc.decode_gamma(wbuf, wlens, widx, cdf, meta), 5),
        at("encode_single_row", z256): cuda_ms(lambda: cc.encode_single_row(
            z256, zcdf, zmeta, zbuf.shape[1]), 20),
        at("decode_single_row", z256): cuda_ms(lambda: cc.decode_single_row(
            zb256, zl256, n_z, zcdf, zmeta), 20),
    }
    e2e_ms = {}
    for name, img in images.items():
        e2e_ms[f"native/{name}"] = e2e_times(codec.compress_native,
                                             codec.decompress, img)
        e2e_ms[f"classic/{name}"] = e2e_times(codec.compress,
                                              codec.decompress, img)
    cc.LAUNCHES.update(saved)
    log("times", kernel_ms=ms, plain_ms=plain_ms, shapes=shapes,
        bound_ms={k: v[0] for k, v in bounds.items()},
        other_kernel_ms=other_ms,
        scaled_latent={"escapes": int(wesc.sum()),
                       "coded_intervals": int(wcounts.sum())},
        end_to_end=e2e_ms, card=smi)

    launches = {k: native_launches[k] + classic_launches[k]
                + front_launches[k] for k in cc.LAUNCHES}
    kernels = [
        {"name": name, "route": "cuda",
         "source": f"compression_tpu_torch/codec/csrc/{source}",
         "replaces": f"compression_tpu/codec/{replaces}",
         "launches": launches[name], "max_abs_err": MAX_ABS_ERR[name],
         "ms": ms[name], "plain_ms": plain_ms[name],
         "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
         "library_ms": None}
        for name, source, replaces in KERNELS]
    if fails:
        log("failed", cases=fails, max_abs_err=MAX_ABS_ERR)
        return 1
    log("done", seconds=round(time.time() - t_start, 3))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
