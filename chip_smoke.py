#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (compression_tpu_torch) on one GPU.

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases, one JSON line each (any failure exits non-zero):
  1. card: nvidia-smi name and power limit, torch/CUDA versions, TF32 flags;
  2. build: nvcc builds every kernel under compression_tpu_torch/codec/csrc;
  3. kernels: each of the nine kernels against its plain PyTorch version on
     the card, all results identical --
     K1/K2 (indexed sidecar) at the shapes both models' native containers
     and bmshj2018's classic z stream give them, on a stress shape, on
     every golden case of tests/golden/golden.npz (bytes equal the
     reference coder's) and on corrupted streams;
     K4'/K5' (single row) at the coder micro-bench's regime (32768 streams x
     512 symbols of a zipf row at precision 12), on every golden case and
     on corrupted streams;
     K6'/K3' (in-stream gamma) on the classic containers' one stream of a
     512x512 image's latent (bls2017: 1 x 131072 on its 128-row table;
     bmshj2018: y, 1 x 196608 on its 64-row table with the escapes the
     seeded model gives it, and z, 1 x 12288), on 8192 x 512 of a 64-row
     Gaussian overflow table with escapes at rate 2^-8, on one 8192-symbol
     stream, on escapes of every size up to the INT32 extremes, on
     corrupted streams, on streams of 0, 1, 2, 3 and 1031 bytes in a buffer
     of odd width (also from a view one byte into its storage), on a table
     at precision 16 and on a stream count on either side of the wrapper's
     dispatch constant.  K3' has two kernels, one thread and one warp per
     stream: in every one of these cases the plain version runs once and
     the wrapper's choice and both kernels are held against that result;
     K7' (pair lookup) and K6 in its micro-op mode on what compress_device
     gives them for those y and z latents and for the y latent with 40
     planted escapes (1 x 196608 indices and 198848 x 1 micro-ops for y),
     K7' also at 512 x 32768 indices into
     both of bmshj2018's tables and at 1, 3, 5, 196608 and 196609 indices,
     aligned and 4 bytes into their storage, with the one PyTorch call
     that computes the same, flat[idx] and flat[idx + 1], timed beside it,
     and the micro-op mode also against K6''s bytes at 8192 x 512 with
     escapes at 2^-8.  The micro-op mode has two kernels, one thread and
     one warp per stream: in every one of its cases (those above, every
     golden case as micro-ops in rows of even and odd width, random valid
     micro-ops with masked steps anywhere and rows at odd addresses,
     delayed-carry groups whose fill run outlasts the warp kernel's
     32-chunk window in both directions, and a stream count on either side
     of the wrapper's dispatch constant) the plain recurrence runs once
     and the wrapper's choice and both kernels are held against it;
     K8' (bucketed single-row decode) against its plain version and against
     K5' at 32768 x 512, on every golden case and on corrupted streams;
  4. main paths, each with the launch counts reset just before it and read
     just after: (a) bls2017 at num_filters=128 (seeded init, its own
     tables) on a 512x512 and a 768x512 image through compress_native /
     decompress / reconstruct / compress_native_many /
     decompress_native_many; (b) the same images through the classic
     .tfci container, compress / decompress, and a latent scaled past the
     table through the entropy model's compress / decompress; (c) the coder
     front end, encode_streams / decode_streams, and the second single-row
     decoder on the same streams, at the micro-bench regime; (d) bmshj2018 at
     num_filters=192 (seeded init, its own tables, nothing cut) on the same
     two image sizes through both containers, the *_many calls and
     reconstruct, and on latents scaled past the tables; (e) compress_device
     / decompress_device of both of its entropy models on the 512x512
     image's latents under the default budget (y as the seeded model
     gives it; shrunk free of escapes with 40 large ones planted; and the
     seeded one with 200 large ones on top, which the budget must report
     as too many), with no copy to the host before the result is asked
     for;
  5. reference: the CPU codecs write the same containers on a small image;
     the reference's golden_model.npz .tfci container decodes on the card to
     its exact uint8 image; golden_bmshj.npz (24 filters) and
     golden_bmshj_full.npz (192 filters, weights regenerated by
     tests/golden/synth_weights.py) decode on the card to their uint8
     images, code their golden latents to the reference's strings, and the
     tables built here equal theirs;
  6. times: kernels and plain versions at the main paths' shapes (CUDA
     events), their bounds, and end-to-end ms per image of both containers
     of both models; both kernels of K3' at the classic containers' three
     stream shapes beside the byte bound and the serial chain's floor, and
     from 1 to 65536 streams of 512 symbols (what the dispatch constant
     rests on); both kernels of the micro-op mode on compress_device's y
     and z scans beside the byte bound and the chain's floor, and from 1
     to 65536 streams of 590 steps; K7' and its library call by events
     around a loop and replayed from a CUDA graph.

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
# bmshj2018 at the reference's published width, and K7''s shape.
BMSHJ_FILTERS = 192
PAIR_LOOKUP_SHAPE = (512, 32768)
# compress_device's default budget: 64 escapes of 2 * 16 + 3 slots each.
ESCAPE_BUDGET = 64
MICRO_SLOTS = 2 * 16 + 3
# A rounded pixel may differ from a golden image only where the float image
# lies this close to a rounding boundary (the float error of the transforms
# between two implementations reaches 1e-4).
PIXEL_BOUNDARY = 2e-4
# Dependent register operations a step of the warp-per-stream micro-op
# scan takes from one size - 1 to the next in the compiled kernel
# (scan_floor_ms).
SCAN_CHAIN_OPS = 6
# (kernel name, source, TPU kernel it replaces)
KERNELS = [
    ("encode_indexed", "encode_indexed.cu", "pallas_coder.py:1819"),
    ("decode_indexed", "decode_indexed.cu", "pallas_coder.py:1259"),
    ("decode_gamma", "decode_indexed.cu", "pallas_coder.py:1259"),
    ("encode_single_row", "encode_indexed.cu", "pallas_coder.py:1542"),
    ("decode_single_row", "decode_indexed.cu", "pallas_coder.py:637"),
    ("encode_gamma", "encode_indexed.cu", "pallas_coder.py:134"),
    ("encode_scan", "encode_indexed.cu", "pallas_coder.py:134"),
    ("pair_lookup", "pair_lookup.cu", "pallas_coder.py:1924"),
    ("decode_single_row_bucketed", "decode_indexed.cu", "pallas_coder.py:319"),
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


def graph_ms(fn, launches=20, replays=10):
    """Mean ms per call of fn with ``launches`` calls captured into a CUDA
    graph and the graph replayed: the device's time for the call, without
    the host's time to enqueue it."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (launches * replays)


def sm_clock_mhz():
    """The card's highest SM clock, as nvidia-smi gives it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True)
    return float(out.stdout.strip().splitlines()[0])


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


def check_decode(name, kernel, plain, args, variants=()):
    """Runs a decode kernel and its plain version on the same inputs, the
    plain version once; ``variants`` are further kernels of the same
    function held against that one result.  Returns (symbols, sanity,
    all identical, plain ms)."""
    import torch
    sym_k, san_k = kernel(*args)
    torch.cuda.synchronize()
    sym_p, san_p = torch.empty_like(sym_k), torch.empty_like(san_k)
    ms = _plain_ms(lambda: plain(*args, sym_p, san_p))
    same = True
    for run in (lambda *a: (sym_k, san_k),) + tuple(variants):
        sym_v, san_v = run(*args)
        torch.cuda.synchronize()
        same &= bool(torch.equal(sym_v, sym_p) and torch.equal(san_v, san_p))
        MAX_ABS_ERR[name] = max(MAX_ABS_ERR[name],
                                _err((sym_v, sym_p), (san_v, san_p)))
    return sym_k, san_k, same, ms


def check_scan(label, ops, out_size, fails, expect_warp=None):
    """K6's micro-op mode on one input: the plain recurrence once, and the
    wrapper's choice and both of its kernels (warp and thread per stream)
    held against that result.  ``expect_warp`` (True or False) checks the
    wrapper's choice.  Returns (bytes, lengths, identical, plain ms)."""
    import torch
    from compression_tpu_torch.codec import cuda_coder as cc
    warp_before = cc.LAUNCHES_WARP["encode_scan"]
    out_k, len_k = cc.encode_scan(*ops, out_size)
    took_warp = cc.LAUNCHES_WARP["encode_scan"] == warp_before + 1
    torch.cuda.synchronize()
    out_p, len_p = torch.empty_like(out_k), torch.empty_like(len_k)
    ms = _plain_ms(lambda: cc.encode_scan_plain(*ops, out_p, len_p))
    same = True
    for run in (lambda: (out_k, len_k),
                lambda: cc.encode_scan_warp(*ops, out_size),
                lambda: cc.encode_scan_thread(*ops, out_size)):
        out_v, len_v = run()
        torch.cuda.synchronize()
        same &= bool(torch.equal(out_v, out_p) and torch.equal(len_v, len_p))
        MAX_ABS_ERR["encode_scan"] = max(
            MAX_ABS_ERR["encode_scan"], _err((out_v, out_p), (len_v, len_p)))
    if expect_warp is not None and took_warp != expect_warp:
        same = False
    log("kernels", case=label, steps=int(ops[0].shape[0]),
        streams=int(ops[0].shape[1]), out_size=out_size,
        coded=int(ops[3].sum()), wrapper_took="warp" if took_warp
        else "thread", identical_wrapper_and_both_kernels=same)
    if not same:
        fails.append(label)
    return out_k, len_k, same, ms


def scan_cases():
    """tests/scan_cases.py (numpy and the port only), loaded by path: the
    random and the constructed micro-op inputs the tests use too."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "scan_cases", os.path.join(REPO, "tests", "scan_cases.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def gamma_variants(table):
    """K3' by the wrapper's own choice, and both of its kernels whatever
    the shape; arguments (buf, lens, indexes, cdf, meta)."""
    from compression_tpu_torch.codec import cuda_coder as cc
    layout = table.warp_arrays()
    return (lambda *a: cc.decode_gamma(*a, layout),
            (lambda *a: cc.decode_gamma_warp(*a, layout),
             cc.decode_gamma_thread))


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
    # K8', the second single-row decoder: its plain version, and K5'.
    sym_b, san_b, buck_ok, buck_ms = check_decode(
        "decode_single_row_bucketed",
        lambda b, ln, *row: cc.decode_single_row_bucketed(b, ln, n, *row),
        cc.decode_single_row_bucketed_plain,
        (out_k, len_k) + table.bucketed_arrays())
    agree = bool(torch.equal(sym_b, sym_k) and torch.equal(san_b, san_k))
    log("kernels", case=name, streams=int(symbols.shape[0]), symbols=n,
        rows=1, max_precision=int(meta[0, 1]), encode_identical=enc_ok,
        decode_identical=dec_ok, sanity_all=bool(san_k.all()),
        round_trip=exact, bucketed_identical=buck_ok,
        bucketed_equals_single_row=agree)
    if not (enc_ok and dec_ok and exact and bool(san_k.all()) and buck_ok
            and agree):
        fails.append(name)
    return out_k, len_k, enc_ms, dec_ms, buck_ms


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
    chosen, both = gamma_variants(table)
    sym_k, san_k, dec_ok, dec_ms = check_decode(
        "decode_gamma", chosen, cc.decode_gamma_plain,
        (out_k, len_k, indexes, cdf, meta), both)
    exact = bool(torch.equal(sym_k, symbols)) if round_trip else None
    log("kernels", case=name, streams=int(symbols.shape[0]),
        symbols=int(symbols.shape[1]), rows=int(cdf.shape[0]),
        escapes=int(escape.sum()), coded_intervals=intervals,
        encode_identical=enc_ok, decode_identical_both_variants=dec_ok,
        sanity_all=bool(san_k.all()), round_trip=exact)
    if not (enc_ok and dec_ok and exact is not False
            and (bool(san_k.all()) or not round_trip)):
        fails.append(name)
    return out_k, len_k, intervals, enc_ms, dec_ms


def compare_micro(name, table, symbols, indexes, escape_budget, fails):
    """K7' and K6's micro-op mode against their plain versions on what
    compress_device gives them for these symbols: the expansion's table
    indices, and its micro-ops at the budget's scan length.  Also holds
    the micro-op mode's bytes against K6''s on the same symbols.  Returns
    (K7' inputs, micro-ops, bytes, lengths, plain scan ms)."""
    import torch
    from compression_tpu_torch.codec import cuda_coder as cc
    cdf, meta = table.indexed_arrays()
    n = int(symbols.shape[1])
    # The scan length and row width of continuous_base.compress_budgeted.
    num_steps = -(-(n + escape_budget * MICRO_SLOTS) // 64) * 64
    out_size = -(-(2 * num_steps + 2) // 4) * 4
    seen = []

    def lookup(flat, idx):
        seen.append((flat, idx))
        return cc.pair_lookup(flat, idx)

    ops = tuple(t.contiguous() for t in cc.gamma_micro_ops(
        symbols, indexes, cdf, meta, num_steps, MICRO_SLOTS, lookup=lookup))
    flat, idx = seen[0]
    lo_k, hi_k = cc.pair_lookup(flat, idx)
    lo_p, hi_p = cc.pair_lookup_plain(flat, idx)
    pair_ok = bool(torch.equal(lo_k, lo_p) and torch.equal(hi_k, hi_p))
    MAX_ABS_ERR["pair_lookup"] = max(
        MAX_ABS_ERR["pair_lookup"], _err((lo_k, lo_p), (hi_k, hi_p)))
    buf, lens, scan_ok, scan_ms = check_scan(f"{name}/scan", ops, out_size,
                                             fails, expect_warp=True)
    gbuf, glens = cc.encode_gamma(symbols, indexes, cdf, meta, out_size)
    fits = bool((cc.interval_counts(symbols, indexes, meta)[0].sum(1)
                 <= num_steps).all())
    same = bool(torch.equal(buf, gbuf) and torch.equal(lens, glens))
    log("kernels", case=name, pair_lookup_shape=list(idx.shape),
        table_bytes=int(flat.numel() * 4), micro_ops=list(ops[0].shape),
        coded=int(ops[3].sum()), budget_holds=fits,
        pair_lookup_identical=pair_ok, encode_scan_identical=scan_ok,
        equals_encode_gamma=same)
    if not (pair_ok and scan_ok and fits and same):
        fails.append(name)
    return (flat, idx), ops, buf, lens, scan_ms


def golden_cases(table_cls, device, fails):
    """Every golden.npz case through K1/K2 (on an indexed table) and K4'/K5'
    (on its single row): kernel bytes == reference bytes == plain."""
    import torch
    from compression_tpu_torch.codec import cuda_coder, tables, torch_coder
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
        out1, lens1, _, _, _ = compare_single_row(
            f"golden/{name}/single_row", table, sym, fails_here)
        got1 = out1[0, : int(lens1[0])].cpu().numpy().tobytes()
        # The same symbols as micro-ops through K6's micro-op mode, in a
        # row of even and of odd width.
        cdf_g, meta_g = table.indexed_arrays()
        micro = tuple(t.contiguous() for t in cuda_coder.gamma_micro_ops(
            sym, idx, cdf_g, meta_g, sym.shape[1], 1))
        got2 = []
        for width in (out_size, out_size + 1):
            sbuf, slens, _, _ = check_scan(
                f"golden/{name}/micro_ops/{width}", micro, width, fails_here)
            got2.append(sbuf[0, : int(slens[0])].cpu().numpy().tobytes())
        if fails_here or got != ref or got1 != ref or got2 != [ref, ref] \
                or not torch.equal(dec, sym) or not bool(san.all()):
            bad.append(name)
    log("golden", cases=len(names), kernels=["encode_indexed",
                                             "decode_indexed",
                                             "encode_single_row",
                                             "decode_single_row",
                                             "decode_single_row_bucketed",
                                             "encode_scan"],
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


def corrupt_cases(label, kernel, plain, buf, lens, extra, seed, fails,
                  variants=()):
    """Sanity flags and symbols of a decode kernel (and of its
    ``variants``) equal its plain version's on corrupted streams;
    ``extra`` are the arguments after (buf, lens)."""
    detected = {}
    for name, (b, ln) in corruptions(buf, lens, seed).items():
        _, san_k, same, _ = check_decode(label, kernel, plain,
                                         (b, ln) + extra, variants)
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


def scan_bound(ops, out_size):
    """Least time (ms) for K6's micro-op mode over ``ops`` [T, S]: three
    int32 arrays and a byte mask read once, each stream's bytes and length
    written once; ~12 operations per coded step."""
    steps, streams = ops[0].shape
    return _bound(steps * streams * 13 + streams * (out_size + 4),
                  12 * int(ops[3].sum()))


def _bound(nbytes, ops):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_SCALAR_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations")


def reset_counts():
    from compression_tpu_torch.codec import cuda_coder, torch_coder
    for counts in (cuda_coder.LAUNCHES, cuda_coder.LAUNCHES_WARP):
        for k in counts:
            counts[k] = 0
    torch_coder.DISPATCH_LOG.clear()


def read_counts(keys):
    """(launches per kernel, with those of K3' and of K6's micro-op mode
    that took the warp-per-stream kernel under "decode_gamma/warp" and
    "encode_scan/warp"; dispatch routes of ``keys``)."""
    import torch
    from compression_tpu_torch.codec import cuda_coder, torch_coder
    torch.cuda.synchronize()
    launches = dict(cuda_coder.LAUNCHES)
    launches["decode_gamma/warp"] = cuda_coder.LAUNCHES_WARP["decode_gamma"]
    launches["encode_scan/warp"] = cuda_coder.LAUNCHES_WARP["encode_scan"]
    return launches, {k: torch_coder.DISPATCH_LOG.get(k) for k in keys}


def warp_floor_ms(intervals, max_len, clock_mhz):
    """The serial chain's own floor for the warp-per-stream K3' (ms): one
    coded interval cannot start before the one before it has narrowed the
    range, so a stream takes at least intervals x (the dependent
    operations of one step x their latency), whatever else the card
    does.  Reckoned from the compiled kernel (cuobjdump -sass): the chain of
    a step runs through 15 register-to-register operations (multiply-add
    wide, funnel shift, compare, vote, population count, two adds, min,
    address, then multiply-add wide, funnel shift, two adds, mask, select)
    and one shared-memory load, a row of more than 129 entries through 7
    more and a second load (the bucket's probes).  Taken at 4 clocks a
    register operation and 23 a shared-memory load, the architecture's
    nominal latencies (not measured here), at the card's highest SM
    clock."""
    clocks = 15 * 4 + 23 + (7 * 4 + 23 if max_len > 129 else 0)
    return intervals * clocks / (clock_mhz * 1e3)


def scan_floor_ms(coded_steps, clock_mhz):
    """The serial chain's own floor for the warp-per-stream micro-op scan
    (ms): coded steps x the dependent operations of one step in the
    compiled kernel (cuobjdump -sass) x their latency, at the card's
    highest SM clock.  The chain from one step's size - 1 to the next runs
    through SCAN_CHAIN_OPS register operations (wide multiply-add, funnel
    shift, complement, add, compare, select), taken at 4 clocks each, the
    architecture's nominal latency (not measured here)."""
    return coded_steps * SCAN_CHAIN_OPS * 4 / (clock_mhz * 1e3)


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


def pixels_off(codec, container, expect):
    """(pixels that differ from ``expect``, pixels that differ although
    the float image is not within PIXEL_BOUNDARY of a rounding boundary,
    the least distance of any pixel from a boundary)."""
    import torch
    with torch.no_grad():
        y_hat, _, x_hw = codec._decode_latent(codec._unpack(container))
        x_float = codec.model.decode(y_hat)[0, : x_hw[0], : x_hw[1]]
        x_float = x_float.cpu().numpy()
    out = codec.decompress(container)
    margin = np.abs(x_float - np.floor(x_float) - 0.5)
    off = out != expect
    unexplained = off & ((margin >= PIXEL_BOUNDARY) | (
        np.abs(out.astype(int) - expect.astype(int)) > 1))
    return int(off.sum()), int(unexplained.sum()), float(margin.min())


def golden_strings(gold, prefix):
    sizes = gold[f"{prefix}_nbytes"]
    buf = gold[f"{prefix}_bytes"].tobytes()
    out, off = [], 0
    for n in sizes:
        out.append(buf[off:off + int(n)])
        off += int(n)
    return out


def synthesized_weights(gold):
    """The weights of a full-width golden fixture, regenerated from their
    names by tests/golden/synth_weights.py (numpy and hashlib only, loaded
    by path) and checked against the fixture's digests."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "synth_weights", os.path.join(REPO, "tests", "golden",
                                      "synth_weights.py"))
    synth = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(synth)
    manifest = json.loads(gold["manifest"].tobytes().decode())
    tf_vars = {}
    for name, (shape, digest) in manifest.items():
        tf_vars[name] = synth.synth(name, shape)
        if synth.digest(tf_vars[name]) != digest:
            raise RuntimeError(f"synthesized weight drifted: {name}")
    return tf_vars


def golden_bmshj(fixture, weights, device, fails):
    """A bmshj2018 golden fixture on the card: tables built here equal the
    reference's, the golden latents code to its strings, compress writes
    them too, and its container decodes to its uint8 image (a pixel may
    differ only within PIXEL_BOUNDARY of a rounding boundary)."""
    import torch
    from compression_tpu_torch.models import bmshj2018
    from compression_tpu_torch.util.packed_tensors import PackedTensors
    gold = dict(np.load(os.path.join(REPO, "tests", "golden", fixture)))
    model = bmshj2018.BMSHJ2018Model(num_filters=int(gold["num_filters"]),
                                     num_scales=int(gold["num_scales"]))
    model.load_state_dict(bmshj2018.params_from_tf(weights(gold)))
    codec = bmshj2018.BMSHJ2018Codec(model, device=device)
    with torch.no_grad():
        z = torch.as_tensor(gold["z"], device=device)
        y = torch.as_tensor(gold["y"], device=device)
        indexes = codec._indexes(codec.side_em.quantize(z), y.shape[1:3])
        from_latents = (codec.em.compress_to_strings(y, indexes),
                        codec.side_em.compress_to_strings(z))
        my, mz, _ = codec._encode(codec._upload(gold["x_test"]))
    own = PackedTensors(codec.compress(gold["x_test"])).unpack(
        ["bytes", "bytes", np.int32, np.int32, np.int32])[:2]
    ref = (golden_strings(gold, "y"), golden_strings(gold, "z"))
    off, unexplained, margin = pixels_off(
        codec, gold["container"].tobytes(), gold["x_hat_uint8"])
    result = {
        "tables_equal": bool(
            np.array_equal(codec.em.cdf, gold["cdf_y"])
            and np.array_equal(codec.em.cdf_offset, gold["cdf_offset_y"])
            and np.array_equal(codec.side_em.cdf, gold["cdf_z"])
            and np.array_equal(codec.side_em.cdf_offset,
                               gold["cdf_offset_z"])),
        "latents_max_abs_err": max(
            float((my.cpu() - torch.as_tensor(gold["y"])).abs().max()),
            float((mz.cpu() - torch.as_tensor(gold["z"])).abs().max())),
        "strings_from_latents_equal": from_latents == ref,
        "strings_from_image_equal": tuple(own) == ref,
        "pixels_off": off, "pixels_off_unexplained": unexplained,
        "least_distance_from_boundary": margin}
    log("golden_bmshj", fixture=fixture,
        num_filters=int(gold["num_filters"]), **result)
    if not (result["tables_equal"] and result["strings_from_latents_equal"]
            and result["strings_from_image_equal"] and unexplained == 0
            and result["latents_max_abs_err"] < 3e-4):
        fails.append(f"golden_bmshj/{fixture}")


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
    from compression_tpu_torch.models import bls2017, bmshj2018, native_format
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
    zbuf, zlens, k4_plain, k5_plain, k8_plain = compare_single_row(
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
    corrupt_cases("decode_single_row_bucketed",
                  lambda b, ln, *row: cc.decode_single_row_bucketed(
                      b, ln, n_z, *row),
                  cc.decode_single_row_bucketed_plain,
                  zbuf[:4096].contiguous(), zlens[:4096].contiguous(),
                  ztable.bucketed_arrays(), 6, fails)
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
    g_chosen, g_both = gamma_variants(gtable)
    corrupt_cases("decode_gamma", g_chosen, cc.decode_gamma_plain,
                  gbuf[:2048].contiguous(), glens[:2048].contiguous(),
                  (gidx_t[:2048].contiguous(), gcdf, gmeta), 7, fails, g_both)
    # Both kernels of K3' where the stream's bytes end early or lie oddly:
    # lengths 0, 1, 2, 3 and the whole of an odd width (most rows start
    # unaligned, 1031 bytes span three windows of the warp kernel's ring)
    # in a buffer of noise, decoded far past each end; then the same from
    # a view that starts one byte into its storage.
    ogen = torch.Generator(device=device).manual_seed(11)
    onoise = torch.randint(0, 256, (40 * 1031 + 1,), generator=ogen,
                           device=device, dtype=torch.uint8)
    olens = torch.tensor([0, 1, 2, 3, 1031] * 8, dtype=torch.int32,
                         device=device)
    oidx = gidx_t[:40, :].repeat(1, 2)[:, :700].contiguous()
    odd_ok = True
    for view in (onoise[:-1], onoise[1:]):
        _, _, same, _ = check_decode(
            "decode_gamma", g_chosen, cc.decode_gamma_plain,
            (view.view(40, 1031), olens, oidx, gcdf, gmeta), g_both)
        odd_ok &= same
    log("kernels", case="gamma/short_and_odd", streams=40, width=1031,
        byte_lens=[0, 1, 2, 3, 1031], symbols=700,
        decode_identical_both_variants=odd_ok)
    if not odd_ok:
        fails.append("gamma/short_and_odd")
    # Overflow rows at precision 16 (terminal 65536), escapes included.
    p16 = torch_coder.DeviceCdfTable(mixed_table(
        np.random.RandomState(12), 48, 16, 16, [True] * 48), device)
    pidx = torch.as_tensor(grng.randint(0, 48, (512, 256)), dtype=torch.int32,
                           device=device)
    psym = torch.as_tensor(
        np.round(grng.laplace(0, 12, (512, 256))).astype(np.int32),
        device=device)
    compare_gamma("gamma/precision16", p16, psym, pidx, fails)
    # A stream count on either side of the wrapper's dispatch constant:
    # the larger launch takes the thread-per-stream kernel.
    edge = cc.WARP_DECODE_MAX_STREAMS
    reps = -(-(edge + 1) // gsym_t.shape[0])
    esym = gsym_t[:, :64].repeat(reps, 1)[: edge + 1].contiguous()
    eidx = gidx_t[:, :64].repeat(reps, 1)[: edge + 1].contiguous()
    took = {}
    for streams in (edge, edge + 1):
        reset_counts()
        compare_gamma(f"gamma/dispatch_{streams}", gtable,
                      esym[:streams].contiguous(),
                      eidx[:streams].contiguous(), fails)
        counts, _ = read_counts(())
        # The wrapper's own choice, then each kernel once.
        took[streams] = "warp" if counts["decode_gamma/warp"] == 2 else \
            "thread"
        if counts["decode_gamma"] != 3:
            fails.append(f"gamma/dispatch_{streams}/launches")
    log("kernels", case="gamma/dispatch", warp_decode_max_streams=edge,
        took=took)
    if took != {edge: "warp", edge + 1: "thread"}:
        fails.append("gamma/dispatch")
    with torch.no_grad():
        y = codec._analysis(codec._upload(images[first]))
        csym, _, crow = codec.em._symbols_from_bottleneck(y)
    cidx = crow.to(torch.int32)[None].expand_as(csym).contiguous()
    cbuf, clens, c_intervals, k6_plain, k3_plain = compare_gamma(
        f"gamma/classic_{first}", table, csym, cidx, fails)

    # The bmshj2018 codec at full width: its tables give K7' its shapes.
    t0 = time.time()
    hcodec = bmshj2018.BMSHJ2018Codec(
        bmshj2018.BMSHJ2018Model(num_filters=BMSHJ_FILTERS, seed=0),
        device=device)
    ytable, htable = hcodec.em.device_table, hcodec.side_em.device_table
    log("codec", model="bmshj2018", num_filters=BMSHJ_FILTERS,
        seconds=round(time.time() - t0, 3),
        y_table=[ytable.num_rows, ytable.max_len],
        z_table=[htable.num_rows, htable.max_len],
        latent_depth=hcodec.latent_depth)

    # The kernels at the shapes bmshj2018's main path gives them for the
    # first image: K1/K2 on the native containers' y and z streams; K1,
    # K6' and K3' on the classic container's one y and one z stream (an
    # escape-free latent is encoded by K1, one with escapes by K6', both
    # are decoded by K3'); K7' and the micro-op mode on what
    # compress_device expands those streams into.
    ycdf, ymeta = ytable.indexed_arrays()
    with torch.no_grad():
        hy, hz, hidx = hcodec._encode(hcodec._upload(images[first]))
        ysym, yidx1, _ = hcodec.em._symbols(hy, hidx)
        zsym1, _, zrow = hcodec.side_em._symbols_from_bottleneck(hz)
        zidx1 = zrow.to(torch.int32)[None].expand_as(zsym1).contiguous()
        ysym_n, yidx_n, _ = hcodec.em._symbols(
            native_format.to_streams(hy), native_format.to_streams(hidx))
        zsym_n, _, zrow_n = hcodec.side_em._symbols_from_bottleneck(
            native_format.to_streams(hz))
        zidx_n = zrow_n.to(torch.int32)[None].expand_as(zsym_n).contiguous()
    y_counts, y_escape, _, _ = cc.interval_counts(ysym, yidx1, ymeta)
    y_natural = int(y_escape.sum())
    log("main_shape", model="bmshj2018", image=first,
        y_native=list(ysym_n.shape), z_native=list(zsym_n.shape),
        y_classic=list(ysym.shape), z_classic=list(zsym1.shape),
        y_escapes=y_natural,
        z_escapes=int(cc.interval_counts(
            zsym1, zidx1, htable.indexed_arrays()[1])[1].sum()))
    for label, tab, sym_c, idx_c in (
            ("bmshj2018/y_native", ytable, ysym_n, yidx_n),
            ("bmshj2018/z_native", htable, zsym_n, zidx_n),
            ("bmshj2018/z_classic", htable, zsym1, zidx1)):
        compare_kernels(label, tab, sym_c.contiguous(), idx_c.contiguous(),
                        torch_coder.stream_out_size(sym_c.shape[1]), fails)
    ybuf1, ylens1, _, k6_plain_y, k3_plain_y = compare_gamma(
        "gamma/bmshj2018/y_classic", ytable, ysym.contiguous(),
        yidx1.contiguous(), fails)
    compare_gamma("gamma/bmshj2018/z_classic", htable, zsym1.contiguous(),
                  zidx1, fails)
    ypair, yops, ysbuf, yslens, scan_plain_y = compare_micro(
        "micro/bmshj2018/y", ytable, ysym.contiguous(), yidx1.contiguous(),
        ESCAPE_BUDGET, fails)
    _, zops, zsbuf, _, _ = compare_micro(
        "micro/bmshj2018/z", htable, zsym1.contiguous(), zidx1,
        ESCAPE_BUDGET, fails)

    # K7' at 512 x 32768 indices into the y table and the z table.
    pair_inputs = {}
    prng = np.random.RandomState(4)
    for label, tab in (("y_table", ytable), ("z_table", htable)):
        flat = tab.indexed_arrays()[0].reshape(-1)
        rows = prng.randint(0, tab.num_rows, PAIR_LOOKUP_SHAPE)
        vq = prng.randint(0, 1 << 30, PAIR_LOOKUP_SHAPE) % (
            np.asarray(tab.host.length)[rows] - 1)
        pidx2 = torch.as_tensor((rows * tab.max_len + vq).astype(np.int32),
                                device=device)
        lo_k, hi_k = cc.pair_lookup(flat, pidx2)
        lo_p, hi_p = cc.pair_lookup_plain(flat, pidx2)
        same = bool(torch.equal(lo_k, lo_p) and torch.equal(hi_k, hi_p))
        MAX_ABS_ERR["pair_lookup"] = max(
            MAX_ABS_ERR["pair_lookup"], _err((lo_k, lo_p), (hi_k, hi_p)))
        log("kernels", case=f"pair_lookup/{label}",
            shape=list(PAIR_LOOKUP_SHAPE), table_bytes=int(flat.numel() * 4),
            identical=same)
        if not same:
            fails.append(f"pair_lookup/{label}")
        pair_inputs[label] = (flat, pidx2)

    # K7' where the count is no multiple of four (a scalar tail) and on
    # indices that start 4 bytes into their storage (no 16-byte loads).
    yflat_t = ytable.indexed_arrays()[0].reshape(-1)
    odd_counts = {}
    for count in (1, 3, 5, 196608, 196609):
        store = torch.as_tensor(
            prng.randint(0, yflat_t.numel() - 1, count + 1).astype(np.int32),
            device=device)
        same = True
        for view in (store[:count], store[1:]):
            lo_k, hi_k = cc.pair_lookup(yflat_t, view.view(1, count))
            lo_p, hi_p = cc.pair_lookup_plain(yflat_t, view.view(1, count))
            same &= bool(torch.equal(lo_k, lo_p) and torch.equal(hi_k, hi_p))
            MAX_ABS_ERR["pair_lookup"] = max(
                MAX_ABS_ERR["pair_lookup"], _err((lo_k, lo_p), (hi_k, hi_p)))
        odd_counts[count] = same
    log("kernels", case="pair_lookup/element_counts", identical=odd_counts,
        views=["aligned", "4 bytes into the storage"])
    if not all(odd_counts.values()):
        fails.append("pair_lookup/element_counts")

    # K6 in its micro-op mode: the expansion of the Gaussian regime's data,
    # scanned by the kernel, against the plain recurrence and K6''s bytes.
    gops = cc.gamma_micro_ops(gsym_t, gidx_t, gcdf, gmeta)
    gops = tuple(t.contiguous() for t in gops)
    sbuf, slens, scan_ok, scan_plain = check_scan(
        "encode_scan/gaussian/variants", gops, gbuf.shape[1], fails)
    scan_same = bool(torch.equal(sbuf, gbuf) and torch.equal(slens, glens))
    log("kernels", case="encode_scan/gaussian", steps=int(gops[0].shape[0]),
        streams=int(gops[0].shape[1]), coded=int(gops[3].sum()),
        identical=scan_ok, equals_encode_gamma=scan_same)
    if not (scan_ok and scan_same):
        fails.append("encode_scan/gaussian")
    # Both kernels of the micro-op mode on masked steps anywhere, rows of
    # odd width (most start at an odd address), delayed-carry groups whose
    # fill run outlasts the warp kernel's window in both directions, and a
    # stream count on either side of the dispatch constant.
    mrng = np.random.RandomState(13)
    cases = scan_cases()
    for label, (steps, streams, share, pad) in {
            "holes": (4096, 3, 0.6, 0), "holes_odd_rows": (4096, 5, 0.9, 1),
            "sparse": (2000, 2, 0.05, 3), "windows": (97, 7, 0.5, 1),
            "empty": (0, 3, 1.0, 1)}.items():
        rops = cases.as_tensors(cases.valid_micro_ops(
            mrng, steps, streams, share), device)
        check_scan(f"encode_scan/{label}", rops, 2 * steps + 2 + pad, fails)
    # Every coded step at a limit of the valid range (encode_scan's
    # contract ends there).
    check_scan("encode_scan/interval_limits", cases.as_tensors(
        cases.limit_micro_ops(mrng, 4096, 3), device), 2 * 4096 + 3, fails)
    for direction in ("up", "down"):
        for fill_chunks in (33, 100):
            lops = cases.as_tensors(cases.long_carry_ops(
                direction, fill_chunks, fill_chunks, tail=300)[0], device)
            lbuf_s, llen_s, _, _ = check_scan(
                f"encode_scan/carry_{direction}_{fill_chunks}", lops,
                2 * lops[0].shape[0] + 3, fails)
            run = (b"\x00\x00" if direction == "up" else b"\xff\xff") * \
                fill_chunks
            if run not in lbuf_s[0, : int(llen_s[0])].cpu().numpy().tobytes():
                fails.append(f"encode_scan/carry_{direction}_{fill_chunks}")
    edge = cc.WARP_ENCODE_MAX_STREAMS
    reps = -(-(edge + 1) // gops[0].shape[1])
    eops = tuple(t[:64].repeat(1, reps)[:, : edge + 1] for t in gops)
    for streams in (edge, edge + 1):
        check_scan(f"encode_scan/dispatch_{streams}",
                   tuple(t[:, :streams].contiguous() for t in eops),
                   2 * 64 + 2, fails, expect_warp=streams == edge)

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
            and classic_launches["decode_gamma/warp"] == n_decompress
            and classic_launches["decode_indexed"] == 0
            and all(p.startswith("cuda-") for p in classic_paths.values())):
        fails.append("classic_path")

    # Phase 4c: the coder front end at the micro-bench regime.
    reset_counts()
    fbuf, flens = torch_coder.encode_streams(zsym, ztable)
    fsym, fok = torch_coder.decode_streams(fbuf, flens, n_z, ztable)
    # The second, independent single-row decoder on the same streams.
    bsym, bok = cc.decode_single_row_bucketed(fbuf, flens, n_z,
                                              *ztable.bucketed_arrays())
    front_launches, front_paths = read_counts(("encode", "decode"))
    front_ok = bool(torch.equal(fsym, zsym) and fok.all()
                    and torch.equal(fbuf, zbuf) and torch.equal(bsym, fsym)
                    and torch.equal(bok, fok))
    log("coder_front_end", shape=list(SINGLE_ROW_SHAPE), round_trip=front_ok,
        launches=front_launches, dispatch=front_paths)
    if not (front_ok and front_launches["encode_single_row"] == 1
            and front_launches["decode_single_row"] == 1
            and front_launches["decode_single_row_bucketed"] == 1
            and set(front_paths.values()) == {"cuda-single"}):
        fails.append("coder_front_end")

    # Phase 4d: bmshj2018 at full width through both containers.
    # Predicted launches per image: native compress 2 x K1 (y and z),
    # native decompress 2 x K2, classic compress 2 encodes (K1 for a latent
    # without escapes, else K6'), classic decompress 2 x K3'.
    reset_counts()
    hyper_ok = True
    calls = {"native_compress": 0, "native_decompress": 0,
             "classic_compress": 0, "classic_decompress": 0}
    for name, img in images.items():
        native = hcodec.compress_native(img)
        classic_c = hcodec.compress(img)
        recon = hcodec.reconstruct(img)
        from_native = hcodec.decompress(native)
        from_classic = hcodec.decompress(classic_c)
        calls["native_compress"] += 1
        calls["classic_compress"] += 1
        calls["native_decompress"] += 1
        calls["classic_decompress"] += 1
        exact = bool(np.array_equal(from_native, recon)
                     and np.array_equal(from_classic, recon))
        hyper_ok &= exact and recon.shape == img.shape and (
            recon.dtype == np.uint8) and (
                PackedTensors(native).num_tensors == 9) and (
                    PackedTensors(classic_c).num_tensors == 5)
        pixels = img.shape[0] * img.shape[1]
        log("bmshj2018_path", image=name, native_bytes=len(native),
            classic_bytes=len(classic_c),
            native_bits_per_pixel=8 * len(native) / pixels,
            classic_bits_per_pixel=8 * len(classic_c) / pixels,
            decompress_equals_reconstruct=exact, shape=list(recon.shape))
    hmany = hcodec.compress_native_many(batch)
    calls["native_compress"] += len(batch)
    hsingle = [hcodec.compress_native(x) for x in batch]
    calls["native_compress"] += len(batch)
    mixed = hmany + [hcodec.compress(batch[1])]
    calls["classic_compress"] += 1
    hdec = hcodec.decompress_native_many(mixed)
    hmany_ok = hmany == hsingle and all(
        np.array_equal(a, hcodec.decompress(c)) for a, c in zip(hdec, mixed))
    calls["native_decompress"] += 2 * len(hmany)
    calls["classic_decompress"] += 2
    hyper_launches, hyper_paths = read_counts(
        ("encode", "decode", "decode_sidecar"))
    expect = {
        "encode_indexed+encode_gamma": 2 * (calls["native_compress"]
                                            + calls["classic_compress"]),
        "decode_indexed": 2 * calls["native_decompress"],
        "decode_gamma": 2 * calls["classic_decompress"]}
    got = {
        "encode_indexed+encode_gamma": hyper_launches["encode_indexed"]
        + hyper_launches["encode_gamma"],
        "decode_indexed": hyper_launches["decode_indexed"],
        "decode_gamma": hyper_launches["decode_gamma"]}
    # Every classic stream is one stream a launch: the warp kernel's.
    hyper_ok &= hyper_launches["decode_gamma/warp"] == \
        hyper_launches["decode_gamma"]
    log("bmshj2018_many", images=len(batch), containers_equal=hmany_ok,
        calls=calls, launches=hyper_launches, expected=expect,
        dispatch=hyper_paths)
    if not (hyper_ok and hmany_ok and got == expect
            and all(p.startswith("cuda-") for p in hyper_paths.values())):
        fails.append("bmshj2018_path")

    # Latents scaled past the tables: escapes in the streams (classic) and
    # in the sidecar (native); both decode to the quantized latents.
    with torch.no_grad():
        hy_wide = hy * (2.0 * ytable.max_len / float(hy.abs().max()))
        hz_wide = hz * (4.0 * htable.max_len / float(hz.abs().max()))
        y_strings = hcodec.em.compress_to_strings(hy_wide, hidx)
        y_route = torch_coder.DISPATCH_LOG["encode"]
        z_strings = hcodec.side_em.compress_to_strings(hz_wide)
        y_back = hcodec.em.decompress(y_strings, hidx)
        z_back = hcodec.side_em.decompress(z_strings, tuple(hz.shape[1:3]))
        y_side = hcodec.em.compress_sidecar_device(
            native_format.to_streams(hy_wide), native_format.to_streams(hidx))
        y_rows, y_sane = hcodec.em.decompress_sidecar_device(
            y_side[0], y_side[1], native_format.to_streams(hidx), y_side[2],
            y_side[3])
    wide_hyper_ok = bool(
        torch.equal(y_back, hcodec.em.quantize(hy_wide))
        and torch.equal(z_back, hcodec.side_em.quantize(hz_wide))
        and torch.equal(y_rows.reshape(hy.shape),
                        hcodec.em.quantize(hy_wide)) and y_sane.all())
    log("bmshj2018_escapes", image=first, y_escapes=int(y_side[2].numel()),
        y_encode_route=y_route, y_stream_bytes=len(y_strings[0]),
        z_stream_bytes=len(z_strings[0]),
        decode_equals_quantize=wide_hyper_ok)
    if not (wide_hyper_ok and y_side[2].numel() > 0
            and y_route == "cuda-gamma"):
        fails.append("bmshj2018_escapes")

    # Phase 4e: compress_device / decompress_device of both entropy models
    # on the first image's latents, under the default budget.  Three y
    # latents: the seeded model's own (it has escapes, and they fit); the
    # same shrunk until it has none, with 40 values pushed far past its
    # rows; and the seeded one with 200 such values on top, whose intervals
    # outnumber the scan's steps, so that ``ok`` must come back False.
    # Predicted launches per compress_device: 1 x K7' + 1 x K6 micro-op
    # mode, by its warp-per-stream kernel (one stream); per
    # decompress_device 1 x K3'.
    with torch.no_grad():
        shrink = 1.0
        while int(cc.interval_counts(*hcodec.em._symbols(
                hy * shrink, hidx)[:2], ymeta)[1].sum()):
            shrink *= 0.5
        pos = torch.as_tensor(prng.choice(hy.numel(), 200, replace=False),
                              device=device)
        far = torch.as_tensor(
            prng.choice([-1.0, 1.0], 200) * prng.randint(2000, 60000, 200),
            dtype=torch.float32, device=device)

        def planted(latent, count):
            flat = latent.reshape(-1).clone()
            flat[pos[:count]] = far[:count]
            return flat.reshape(hy.shape)

        hy_esc, hy_over = planted(hy * shrink, 40), planted(hy, 200)
        psym, pidx, _ = hcodec.em._symbols(hy_esc, hidx)
    compare_micro("micro/bmshj2018/y_planted", ytable, psym.contiguous(),
                  pidx.contiguous(), ESCAPE_BUDGET, fails)
    with torch.no_grad():
        over_intervals = int(cc.interval_counts(*hcodec.em._symbols(
            hy_over, hidx)[:2], ymeta)[0].sum())
        scan_steps = -(-(ysym.shape[1] + ESCAPE_BUDGET * MICRO_SLOTS)
                       // 64) * 64
        ref_y = hcodec.em.compress(hy, hidx)
        ref_planted = hcodec.em.compress(hy_esc, hidx)
        ref_z = hcodec.side_em.compress(hz)
        # Once outside the check, so that tables and offsets are on the
        # card; then again with every wait for the card made an error.
        hcodec.em.compress_device(hy_esc, hidx)
        hcodec.side_em.compress_device(hz)
        reset_counts()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            dev_y = hcodec.em.compress_device(hy, hidx,
                                              escape_budget=ESCAPE_BUDGET)
            route_y = torch_coder.DISPATCH_LOG["encode"]
            dev_planted = hcodec.em.compress_device(
                hy_esc, hidx, escape_budget=ESCAPE_BUDGET)
            dev_over = hcodec.em.compress_device(
                hy_over, hidx, escape_budget=ESCAPE_BUDGET)
            dev_z = hcodec.side_em.compress_device(
                hz, escape_budget=ESCAPE_BUDGET)
            back_y, sane_y = hcodec.em.decompress_device(
                dev_y[0].reshape(1, -1), dev_y[1].reshape(1), hidx)
            back_planted, sane_planted = hcodec.em.decompress_device(
                dev_planted[0].reshape(1, -1), dev_planted[1].reshape(1),
                hidx)
            back_z, sane_z = hcodec.side_em.decompress_device(
                dev_z[0].reshape(1, -1), dev_z[1].reshape(1),
                tuple(hz.shape[1:3]))
        finally:
            torch.cuda.set_sync_debug_mode("default")
    device_launches, device_paths = read_counts(("encode", "decode"))

    def same_stream(dev, ref):
        n = int(ref[1].reshape(-1)[0])
        return bool(torch.equal(dev[1].reshape(-1), ref[1].reshape(-1))
                    and torch.equal(dev[0].reshape(-1)[:n],
                                    ref[0].reshape(-1)[:n])
                    and not dev[0].reshape(-1)[n:].any())

    device_ok = {
        "ok_y": bool(dev_y[2]), "ok_planted": bool(dev_planted[2]),
        "ok_z": bool(dev_z[2]),
        "over_budget_reported": over_intervals > scan_steps
        and not bool(dev_over[2]),
        "y_bytes_equal_compress": same_stream(dev_y, ref_y),
        "planted_bytes_equal_compress": same_stream(dev_planted,
                                                    ref_planted),
        "z_bytes_equal_compress": same_stream(dev_z, ref_z),
        "y_round_trip": bool(torch.equal(back_y, hcodec.em.quantize(hy))
                             and sane_y.all()),
        "planted_round_trip": bool(
            torch.equal(back_planted, hcodec.em.quantize(hy_esc))
            and sane_planted.all()),
        "z_round_trip": bool(torch.equal(back_z.reshape(hz.shape),
                                         hcodec.side_em.quantize(hz))
                             and sane_z.all()),
        "no_wait_for_the_card": True}
    log("compress_device", y_shape=list(hy.shape), z_shape=list(hz.shape),
        escape_budget=ESCAPE_BUDGET, scan_steps=scan_steps,
        y_escapes=y_natural, y_intervals=int(y_counts.sum()),
        planted_escapes=40, planted_latent_shrunk_by=shrink,
        over_budget_planted=200, over_budget_intervals=over_intervals,
        y_stream_bytes=int(dev_y[1].reshape(-1)[0]),
        planted_stream_bytes=int(dev_planted[1].reshape(-1)[0]),
        z_stream_bytes=int(dev_z[1].reshape(-1)[0]), route=route_y,
        launches=device_launches, dispatch=device_paths, **device_ok)
    if not (all(device_ok.values()) and route_y == "cuda-micro"
            and y_natural > 0
            and device_launches["pair_lookup"] == 4
            and device_launches["encode_scan"] == 4
            and device_launches["encode_scan/warp"] == 4
            and device_launches["decode_gamma"] == 3
            and device_launches["decode_gamma/warp"] == 3
            and device_launches["encode_gamma"] == 0):
        fails.append("compress_device")

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

    # bmshj2018: the CPU codec (plain coder) writes the same containers
    # from the same latents, and the golden fixtures.
    hcpu = bmshj2018.BMSHJ2018Codec(
        bmshj2018.BMSHJ2018Model(num_filters=BMSHJ_FILTERS, seed=0),
        device="cpu",
        tables=(hcodec.em.get_weights(), hcodec.side_em.get_weights()))
    with torch.no_grad():
        sy, sz, sidx = hcodec._encode(hcodec._upload(small))
        sy = sy * 3.0  # some escapes
        on_card = (hcodec.em.compress_to_strings(sy, sidx),
                   hcodec.side_em.compress_to_strings(sz),
                   hcodec.em.compress_sidecar_device(sy, sidx),
                   hcodec.em.compress_device(sy, sidx))
        on_cpu = (hcpu.em.compress_to_strings(sy.cpu(), sidx.cpu()),
                  hcpu.side_em.compress_to_strings(sz.cpu()),
                  hcpu.em.compress_sidecar_device(sy.cpu(), sidx.cpu()),
                  hcpu.em.compress_device(sy.cpu(), sidx.cpu()))
    small_hyper = {
        "classic_strings_identical": on_card[:2] == on_cpu[:2],
        "sidecar_identical": all(torch.equal(a.cpu(), b) for a, b in zip(
            on_card[2], on_cpu[2])),
        "compress_device_identical": all(
            torch.equal(a.cpu(), b) for a, b in zip(on_card[3], on_cpu[3]))}
    log("reference_small_bmshj2018", image="64x96", **small_hyper)
    if not all(small_hyper.values()):
        fails.append("reference_small_bmshj2018")
    golden_bmshj("golden_bmshj.npz", lambda gold: gold, device, fails)
    golden_bmshj("golden_bmshj_full.npz", synthesized_weights, device, fails)

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
            cbuf, clens, cidx, cdf, meta, table.warp_arrays()), 5),
        "encode_scan": cuda_ms(lambda: cc.encode_scan(
            *yops, ysbuf.shape[1]), 5),
        "pair_lookup": cuda_ms(lambda: cc.pair_lookup(*ypair), 50),
        "decode_single_row_bucketed": cuda_ms(
            lambda: cc.decode_single_row_bucketed(
                zbuf, zlens, n_z, *ztable.bucketed_arrays()), 20),
    }
    def at(name, t):
        return f"{name}@{t.shape[0]}x{t.shape[1]}"
    yflat, yidx2 = pair_inputs["y_table"]
    yidx_long, ypair_long = yidx2.long(), ypair[1].long()
    # The one PyTorch call that computes K7''s function: two gathers.
    library_ms = {name: None for name, _, _ in KERNELS}
    library_ms["pair_lookup"] = cuda_ms(
        lambda: (ypair[0][ypair_long], ypair[0][ypair_long + 1]), 50)
    # K7' and that call by both timings, in turns: events around a loop of
    # calls (the host's time to enqueue a call counts where it is the
    # longer), and the same calls replayed from a CUDA graph (the device's
    # time alone).
    pair_cases = {
        at("pair_lookup", ypair[1]): (
            lambda: cc.pair_lookup(*ypair),
            lambda: (ypair[0][ypair_long], ypair[0][ypair_long + 1])),
        at("pair_lookup", yidx2): (
            lambda: cc.pair_lookup(yflat, yidx2),
            lambda: (yflat[yidx_long], yflat[yidx_long + 1]))}
    pair_ms = {}
    for label, (kernel_call, library_call) in pair_cases.items():
        rounds = [(cuda_ms(kernel_call, 50), cuda_ms(library_call, 50),
                   graph_ms(kernel_call), graph_ms(library_call))
                  for _ in range(2)]
        pair_ms[label] = {
            "kernel_ms_events": [r[0] for r in rounds],
            "library_ms_events": [r[1] for r in rounds],
            "kernel_ms_graph": [r[2] for r in rounds],
            "library_ms_graph": [r[3] for r in rounds]}
    # K3': both kernels at the classic containers' three shapes, beside the
    # byte bound and the serial chain's floor; and as streams grow, which
    # is what the wrapper's dispatch constant rests on.
    clock = sm_clock_mhz()
    zcdf_h, zmeta_h = htable.indexed_arrays()
    zbuf1, zlens1 = cc.encode_gamma(
        zsym1.contiguous(), zidx1, zcdf_h, zmeta_h,
        torch_coder.stream_out_size(int(cc.interval_counts(
            zsym1, zidx1, zmeta_h)[0].sum(1).max())))
    gamma_shapes = {
        "bls2017_y": (table, cbuf, clens, cidx, c_intervals),
        "bmshj2018_y": (ytable, ybuf1, ylens1, yidx1.contiguous(),
                        int(y_counts.sum())),
        "bmshj2018_z": (htable, zbuf1, zlens1, zidx1, int(
            cc.interval_counts(zsym1, zidx1, zmeta_h)[0].sum()))}
    gamma_ms = {}
    for label, (tab, b, ln, ix, intervals) in gamma_shapes.items():
        t_cdf, t_meta = tab.indexed_arrays()
        layout = tab.warp_arrays()
        n = int(ix.shape[1])
        warp_call = lambda: cc.decode_gamma_warp(b, ln, ix, t_cdf, t_meta,
                                                 layout)
        thread_call = lambda: cc.decode_gamma_thread(b, ln, ix, t_cdf, t_meta)
        gamma_ms[f"{label}@1x{n}"] = {
            "thread_ms": [cuda_ms(thread_call, 3)],
            "warp_ms": [cuda_ms(warp_call, 5), cuda_ms(warp_call, 5)],
            "coded_intervals": intervals,
            "layout_bytes": int(2 * layout.numel()),
            "bound_ms": decode_bound(ln, n, t_cdf, t_meta,
                                     gamma_bits=intervals - n)[0],
            "chain_floor_ms": warp_floor_ms(intervals, tab.max_len, clock)}
        gamma_ms[f"{label}@1x{n}"]["thread_ms"].append(
            cuda_ms(thread_call, 3))
    gamma_sweep = {}
    g_layout = gtable.warp_arrays()
    for streams in (1, 2, 32, 256, 1024, 4096, 8192, 16384, 24576, 32768,
                    65536):
        reps = -(-streams // gbuf.shape[0])
        sb = gbuf.repeat(reps, 1)[:streams].contiguous()
        sl = glens.repeat(reps)[:streams].contiguous()
        si = gidx_t.repeat(reps, 1)[:streams].contiguous()
        warp_call = lambda: cc.decode_gamma_warp(sb, sl, si, gcdf, gmeta,
                                                 g_layout)
        thread_call = lambda: cc.decode_gamma_thread(sb, sl, si, gcdf, gmeta)
        rounds = [(cuda_ms(warp_call, 10), cuda_ms(thread_call, 10))
                  for _ in range(2)]
        gamma_sweep[f"{streams}x{si.shape[1]}"] = {
            "warp_ms": [r[0] for r in rounds],
            "thread_ms": [r[1] for r in rounds]}
        del sb, sl, si
    # K6's micro-op mode: both kernels on compress_device's y and z scans
    # beside the byte bound and the serial chain's floor; and as streams
    # grow (590 steps of the Gaussian regime a stream), which is what the
    # dispatch constant rests on.
    scan_ms = {}
    for label, (s_ops, width) in {
            "bmshj2018_y": (yops, ysbuf.shape[1]),
            "bmshj2018_z": (zops, zsbuf.shape[1])}.items():
        coded_l = int(s_ops[3].sum())
        warp_call = lambda: cc.encode_scan_warp(*s_ops, width)
        thread_call = lambda: cc.encode_scan_thread(*s_ops, width)
        rounds = [(cuda_ms(warp_call, 5), cuda_ms(thread_call, 3))
                  for _ in range(2)]
        scan_ms[at(label, s_ops[0])] = {
            "warp_ms": [r[0] for r in rounds],
            "thread_ms": [r[1] for r in rounds],
            "coded_steps": coded_l,
            "bound_ms": scan_bound(s_ops, width)[0],
            "chain_floor_ms": scan_floor_ms(coded_l, clock)}
    scan_sweep = {}
    gout = gbuf.shape[1]
    for streams in (1, 2, 32, 256, 1024, 4096, 8192, 16384, 24576, 32768,
                    65536):
        reps = -(-streams // gops[0].shape[1])
        sw_ops = tuple(t.repeat(1, reps)[:, :streams].contiguous()
                       for t in gops)
        rounds = [(cuda_ms(lambda: cc.encode_scan_warp(*sw_ops, gout), 10),
                   cuda_ms(lambda: cc.encode_scan_thread(*sw_ops, gout), 10))
                  for _ in range(2)]
        scan_sweep[f"{streams}x{gops[0].shape[0]}"] = {
            "warp_ms": [r[0] for r in rounds],
            "thread_ms": [r[1] for r in rounds]}
        del sw_ops
    plain_ms = {
        "encode_indexed": cuda_ms(lambda: cc.encode_indexed_plain(
            symbols, idx, cdf, meta, out_p, len_p), 3),
        "decode_indexed": cuda_ms(lambda: cc.decode_indexed_plain(
            buf, lens, idx, cdf, meta, sym_p, san_p), 3),
        "encode_single_row": k4_plain, "decode_single_row": k5_plain,
        "encode_gamma": k6_plain, "decode_gamma": k3_plain,
        "encode_scan": scan_plain_y,
        "pair_lookup": cuda_ms(lambda: cc.pair_lookup_plain(*ypair), 50),
        "decode_single_row_bucketed": k8_plain,
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
        "encode_scan": scan_bound(yops, ysbuf.shape[1]),
        # Pair lookup: index read, pair written, table read once; an index
        # clamp, two address computations and two loads per element.
        "pair_lookup": _bound(ypair[1].numel() * 12 + ypair[0].numel() * 4,
                              6 * ypair[1].numel()),
        # Bucketed search: a compare per bucket and per window entry.
        "decode_single_row_bucketed": _bound(
            int(zlens.sum()) + zlens.numel() * 4 + _table_bytes(zcdf, zmeta)
            + zsym.numel() * 4 + zsym.shape[0],
            (2 * (-(-zcdf.shape[1] // 16) + 17) + 10) * zsym.numel()),
    }
    shapes = {
        "encode_indexed": list(symbols.shape),
        "decode_indexed": list(symbols.shape),
        "encode_single_row": list(zsym.shape),
        "decode_single_row": list(zsym.shape),
        "encode_gamma": list(csym.shape), "decode_gamma": list(csym.shape),
        "encode_scan": list(yops[0].shape),
        "pair_lookup": list(ypair[1].shape),
        "decode_single_row_bucketed": list(zsym.shape)}
    # The kernels' time as streams grow, and in the other regimes.
    st_sym, st_idx, st_table, st_out_size = stress_input
    st_cdf, st_meta = st_table.indexed_arrays()
    st_buf, st_lens = cc.encode_indexed(st_sym, st_idx, st_cdf, st_meta,
                                        st_out_size)
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
    zflat, zidx2 = pair_inputs["z_table"]
    ysym_c, yidx_c = ysym.contiguous(), yidx1.contiguous()
    other_ms = {
        at("encode_gamma", ysym) + "/bmshj2018_y": cuda_ms(
            lambda: cc.encode_gamma(ysym_c, yidx_c, ycdf, ymeta,
                                    ybuf1.shape[1]), 5),
        at("decode_gamma", ysym) + "/bmshj2018_y": cuda_ms(
            lambda: cc.decode_gamma(ybuf1, ylens1, yidx_c, ycdf, ymeta,
                                    ytable.warp_arrays()), 5),
        at("encode_scan", gops[0]): cuda_ms(lambda: cc.encode_scan(
            *gops, gbuf.shape[1]), 10),
        at("pair_lookup", yidx2) + "/y_table": cuda_ms(
            lambda: cc.pair_lookup(yflat, yidx2), 20),
        at("pair_lookup", zidx2) + "/z_table": cuda_ms(
            lambda: cc.pair_lookup(zflat, zidx2), 20),
        at("pair_lookup_plain", yidx2) + "/y_table": cuda_ms(
            lambda: cc.pair_lookup_plain(yflat, yidx2), 20),
        at("pair_lookup_library", yidx2) + "/y_table": cuda_ms(
            lambda: (yflat[yidx_long], yflat[yidx_long + 1]), 20),
        at("decode_single_row_bucketed", z256): cuda_ms(
            lambda: cc.decode_single_row_bucketed(
                zb256, zl256, n_z, *ztable.bucketed_arrays()), 20),
        at("encode_indexed", st_sym): cuda_ms(lambda: cc.encode_indexed(
            st_sym, st_idx, st_cdf, st_meta, st_out_size), 10),
        at("decode_indexed", st_sym): cuda_ms(lambda: cc.decode_indexed(
            st_buf, st_lens, st_idx, st_cdf, st_meta), 10),
        at("encode_gamma", gsym_t): cuda_ms(lambda: cc.encode_gamma(
            gsym_t, gidx_t, gcdf, gmeta, gbuf.shape[1]), 10),
        at("decode_gamma", gsym_t): cuda_ms(lambda: cc.decode_gamma(
            gbuf, glens, gidx_t, gcdf, gmeta, gtable.warp_arrays()), 10),
        at("encode_gamma", lsym): cuda_ms(lambda: cc.encode_gamma(
            lsym, lidx, gcdf, gmeta, lbuf.shape[1]), 10),
        at("decode_gamma", lsym): cuda_ms(lambda: cc.decode_gamma(
            lbuf, llens, lidx, gcdf, gmeta, gtable.warp_arrays()), 10),
        at("encode_gamma", wsym) + "+escapes": cuda_ms(
            lambda: cc.encode_gamma(wsym, widx, cdf, meta, wbuf.shape[1]), 5),
        at("decode_gamma", wsym) + "+escapes": cuda_ms(
            lambda: cc.decode_gamma(wbuf, wlens, widx, cdf, meta,
                                    table.warp_arrays()), 5),
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
        e2e_ms[f"bmshj2018/native/{name}"] = e2e_times(
            hcodec.compress_native, hcodec.decompress, img)
        e2e_ms[f"bmshj2018/classic/{name}"] = e2e_times(
            hcodec.compress, hcodec.decompress, img)
    # compress_device / decompress_device of the y model (host clock around
    # work that ends in a synchronize): the seeded latent, and the shrunk
    # one with 40 planted escapes.
    for label, latent in (("seeded_y", hy), ("planted_y", hy_esc)):
        dev_times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.no_grad():
                out = hcodec.em.compress_device(latent, hidx)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            with torch.no_grad():
                hcodec.em.decompress_device(out[0].reshape(1, -1),
                                            out[1].reshape(1), hidx)
            torch.cuda.synchronize()
            dev_times.append(((t1 - t0) * 1e3,
                              (time.perf_counter() - t1) * 1e3))
        e2e_ms[f"bmshj2018/{label}/compress_device_ms_median"] = float(
            np.median([t[0] for t in dev_times]))
        e2e_ms[f"bmshj2018/{label}/decompress_device_ms_median"] = float(
            np.median([t[1] for t in dev_times]))
    cc.LAUNCHES.update(saved)
    log("times", kernel_ms=ms, plain_ms=plain_ms, library_ms=library_ms,
        shapes=shapes,
        other_plain_ms={
            at("encode_gamma", ysym) + "/bmshj2018_y": k6_plain_y,
            at("decode_gamma", ysym) + "/bmshj2018_y": k3_plain_y,
            at("encode_scan", gops[0]): scan_plain},
        bound_ms={k: v[0] for k, v in bounds.items()},
        other_kernel_ms=other_ms,
        scaled_latent={"escapes": int(wesc.sum()),
                       "coded_intervals": int(wcounts.sum())},
        pair_lookup_ms=pair_ms, decode_gamma_variants_ms=gamma_ms,
        decode_gamma_streams_ms=gamma_sweep,
        warp_decode_max_streams=cc.WARP_DECODE_MAX_STREAMS,
        encode_scan_variants_ms=scan_ms, encode_scan_streams_ms=scan_sweep,
        warp_encode_max_streams=cc.WARP_ENCODE_MAX_STREAMS,
        sm_clock_mhz=clock, end_to_end=e2e_ms, card=smi)

    launches = {k: native_launches[k] + classic_launches[k]
                + front_launches[k] + hyper_launches[k] + device_launches[k]
                for k in cc.LAUNCHES}
    for name, count in launches.items():
        if count == 0:
            fails.append(f"no_launch_on_a_main_path/{name}")
    kernels = [
        {"name": name, "route": "cuda",
         "source": f"compression_tpu_torch/codec/csrc/{source}",
         "replaces": f"compression_tpu/codec/{replaces}",
         "launches": launches[name], "max_abs_err": MAX_ABS_ERR[name],
         "ms": ms[name], "plain_ms": plain_ms[name],
         "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
         "library_ms": library_ms[name], "shape": shapes[name]}
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
