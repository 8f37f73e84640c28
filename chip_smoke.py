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
     512 symbols of a zipf row at precision 12; K5' with the table's slot
     table), K4' also into rows of odd width and K5' on a buffer of odd
     width, the same symbols on the row at precision 16 (K5''s 128 KB table
     of counts), on every golden case and on corrupted streams;
     K6'/K3' (in-stream gamma) on the classic containers' one stream of a
     512x512 image's latent (bls2017: 1 x 131072 on its 128-row table;
     bmshj2018: y, 1 x 196608 on its 64-row table with the escapes the
     seeded model gives it, and z, 1 x 12288), on 8192 x 512 of a 64-row
     Gaussian overflow table with escapes at rate 2^-8, on one 8192-symbol
     stream, on escapes of every size up to the INT32 extremes, on
     corrupted streams, on streams of 0, 1, 2, 3 and 1031 bytes in a buffer
     of odd width (also from a view one byte into its storage), on a table
     at precision 16 and on a stream count on either side of the wrapper's
     dispatch constant.  K1, K2, K3' and K6' have two kernels each, one
     thread and one warp per stream: in every one of their cases the plain
     version runs once and the wrapper's choice and both kernels are held
     against that result, and the wrapper's choice is logged (K2's must
     follow the dispatch constant, also at a stream count on either side of
     it); K1 and K6' also on
     tests/symbol_cases.py's inputs (escapes in lane 0 and 31 of a window,
     several in one, in the last partial window, g = 2^31 back to back,
     streams of 0 to 400 symbols, bounded rows at precision 1 to 16) in
     rows of even and odd width, and at a stream count on either side of
     their dispatch constant;
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
     K5' at 32768 x 512, on every golden case and on corrupted streams, and
     with K4'/K5' on zipf rows at precision 16 of 64 and 94 buckets (4096 x
     512; K8' counts buckets from registers up to 64, above by binary
     search);
  4. main paths, each with the launch counts reset just before it and read
     just after, every K1, K2, K3' and K6' launch of (a), (b), (d), (f) and
     (h) expected on the warp-per-stream kernel: (a) bls2017 at
     num_filters=128 (seeded init, its own tables) on a 512x512 and a
     768x512 image through
     compress_native / decompress / reconstruct / compress_native_many /
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
     for; (f) ms2020 at its published width (192 filters, latent 320, 10
     slices, 64 scales; seeded init, its own tables, nothing cut) on the
     same images through both containers, the *_many calls and
     reconstruct: one K1 launch for z and one for the ten slices stacked
     per native compress, one K2 launch for z and one a slice per native
     decompress, the classic container's two encodes (z, then the ten
     slices stacked) on the warp kernels of K1 / K6' and its eleven
     one-stream K3' calls; then K1 at the native stacked slices' launch
     (640 x 512 at 512x512) and on z, K2 at one slice's (64 x 512, on the
     container's own bytes), and K6' / K3' at the classic stacked slices'
     launch (10 x 32768 at 512x512; K6''s bytes the classic container's
     slice fields), against their plain versions and timed
     beside the byte bound and the chain's floor; both ms2020 goldens on
     the card (golden_ms2020_full.npz also against the CPU: native
     container and reconstruction of its 128x128 image), and e2e ms of
     both containers; (g) the classic containers of the three models on
     the card, with e2e ms, and the host C coder against the card's
     reference-format wrappers on 1, 16, 64 and 255 streams of 8192
     symbols of bmshj2018's y stream, in both directions; (h) HiFiC at
     get_config("hific") (4 downsamplings, base 60, bottleneck 220, 9
     residual blocks, hyper 320; seeded init, its own tables, nothing
     cut: ~182.7M parameters) on the same images through both
     containers, the *_many calls and reconstruct (each native container
     decompressed twice to the same image, with num_down + 1 upsampling
     GEMMs a decompress): two K1 launches per native compress (y, z) and
     two K2 per native decompress, two encodes per classic compress (K1 or
     K6') and two K3' per classic decompress, all on the warp kernels; then K1 and K2 at the native launches (y
     512 x 440 and z 64 x 320 at 512x512) against their plain versions on
     the codec's inputs and the container's bytes, timed from a CUDA
     graph beside the byte bound and the chain's floor; the classic y
     (1 x 225280 at 512x512) and z streams against the host C coder in
     both directions; e2e ms of both containers, with K3''s share of the
     classic decompress;
  5. reference: the CPU codecs write the same containers on a small image;
     the reference's golden_model.npz .tfci container decodes on the card to
     its exact uint8 image; golden_bmshj.npz (24 filters) and
     golden_bmshj_full.npz (192 filters, weights regenerated by
     tests/golden/synth_weights.py) decode on the card to their uint8
     images, code their golden latents to the reference's strings, and the
     tables built here equal theirs;
  6. host_coder: the port's host C coder (codec/host.py) encodes the
     classic streams (bls2017's 1 x 131072, bmshj2018's y 1 x 196608 and
     z 1 x 12288), the native 256 x 512 (indexed mode) and the micro-bench
     32768 x 512 (channel mode, one row) to the bytes of the
     reference-format wrappers on the card (torch_coder.encode_streams)
     and decodes them to the card's symbols and sanity flags; its median
     ms of 5 (the host's CPU model and thread count beside it) and the
     card wrappers' ms;
  7. train: bls2017 at 128 filters, bmshj2018 at 192 filters / 64
     scales and ms2020 at MS2020_CONFIG, batch 8 of 256x256, one fixed
     seeded batch: one step on the
     card and one on the CPU from the same parameters, batch and noise
     with TF32 off (loss, bpp, mse and every gradient's largest error over
     its largest magnitude, at most 1e-3, with the CPU taking the card's
     relu decisions; the error with its own decisions, and how many
     elements it decides otherwise, beside it), then 30 Adam steps at 1e-3
     (ms2020 at 1e-4, the reference CLI's default) on the card, whose loss
     must fall, with the median step ms of steps
     4-30 by CUDA events around a synchronized step;
  7t. tfci: the generic command line at each model's CLI defaults on the
     512x512 image: bls2017, bmshj2018 and ms2020 trained 2 steps by their
     own main into a registry, HiFiC through phase 7h's checkpoint; each
     container of ``tfci compress`` equals the loaded codec's compress and
     ``tfci decompress`` gives its reconstruct (one encode and one K3' a
     latent, warp); a --target_bpp search over three bmshj2018 variants
     picks the one the rule names; ms of each subcommand;
  7u. universal: UniversalBatchedEntropyModel (2880 table rows) and
     UniversalIndexedEntropyModel (960 rows) of tests/universal_cases.py
     at 8 x 32 x 32 x 192 (8 streams of 196608 symbols), without and with
     escapes (K1, K6'; K3' to decode): bytes equal to the host C coder's,
     the round trip equal to the dithered quantization; median compress
     and decompress ms of 10, the tables' rows and bytes;
  7s. small models: signal_conv at ranks 1-3 in every padding mode (rational
     strides, channel-separable) and GDN with general exponents, card
     against CPU within 1e-4; lvac at 64 filters, batch 8 of 1024 samples,
     and the toy sources (NTC deep and gmm-3, VECVQ) at batch 512 on the
     sawbridge: one step's gradients card against CPU within 1e-3, then 30
     steps on the card (median step ms, the loss finite and falling), NTC's
     codebook against the CPU's; the stochastic round of 2^20 elements from
     given bits equal to the CPU's, with its ms; PowerLaw and Laplace
     penalty and quantization card against CPU, compress of lvac's latent
     on the host (bytes of the Python plain version, round trip, host ms),
     compress of the CUDA tensor refused; no coder kernel launched;
  7p. parallel: parallel/ on the card's mesh (every card on the data
     axis; one here): the sidecar codec on 4 images of 512x512 (1024 x
     512, 200 escapes planted) and BatchCodec on bench.py's two regimes
     (K6' / K3' with escapes, K4' / K5' on the zipf row), bytes identical
     to the unsharded calls and the round trips; sharded_encode through
     the micro-op closure (K7', the micro-op scan); the timer's phases and
     the unsharded calls' ms; then tests/torch_parallel_worker.py spawned
     at world size 1 on NCCL (table broadcast, byte gather, DP and DP x TP
     steps of bls2017 at 128 filters identical to make_train_step's) and
     as two gloo ranks sharing the card (the DP step's gradients within
     1e-3, its metrics within 1e-4 of one process's; step ms);
  7x. examples: the example scripts through their mains on the card:
     train_synthetic at its defaults (bls2017 at 64 filters, 2 lambdas x
     400 steps) must run to its end with its RD summary and a verdict its
     exit code follows (RD points, the verdict, seconds, and the model's
     step ms on its texture batches); evaluate over a
     registry written by bls2017's train (2 steps) and seeded .npy images,
     rows equal to the port's metrics on the decoded images, MS-SSIM NaN
     for the image below 176 pixels; pod_compress on a mesh of one card
     and of every card, identical bytes, its rates and phases;
  8. times: kernels and plain versions at the main paths' shapes (CUDA
     events; K4', K5' and K8' from CUDA graphs), their bounds, and end-to-end ms per image of the native
     containers of both models (the classic ones' are phase 4g's); both
     kernels of K3' at the classic containers' three
     stream shapes beside the byte bound and the serial chain's floor, and
     from 1 to 65536 streams of 512 symbols (what the dispatch constant
     rests on); both kernels of the micro-op mode on compress_device's y
     and z scans beside the byte bound and the chain's floor, and from 1
     to 65536 streams of 590 steps; both kernels of K6' and K1 at the
     classic streams and the native launches beside the byte bound and the
     chain's floor (K1's native launches also from a CUDA graph), and from
     1 to 65536 streams of 512 symbols; K2's wrapper and both kernels at
     both models' native launches of both images, on the buffers
     decompress gives them, by events and from a CUDA graph, beside the
     byte bound and the chain's floor, and both kernels from 1 to 65536
     streams of 512 symbols; K7' and its library call by events around a loop and
     replayed from a CUDA graph; K4', K5' and K8' from a CUDA graph at the
     micro-bench regime at precision 12 and 16 beside the byte bound and
     the chains' floors, and K4' and K5' from 1 to 65536 streams of 512
     symbols.

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
# Zipf rows at precision 16 whose padded lengths make 64 and 94 buckets of
# 16 (K8''s two bucket counts), decoded at this shape.
WIDE_ROW_ALPHABETS = (1020, 1500)
WIDE_ROW_SHAPE = (4096, 512)
# The indexed in-stream regime (bench.py bench_indexed) and one long stream.
GAMMA_SHAPE = (8192, 512)
LONG_STREAM = (1, 8192)
# bmshj2018 at the reference's published width, and K7''s shape.
BMSHJ_FILTERS = 192
PAIR_LOOKUP_SHAPE = (512, 32768)
# Stream counts of the dispatch sweeps (K3', the micro-op scan, K1 and K6').
SWEEP_STREAMS = (1, 2, 32, 256, 1024, 4096, 8192, 12288, 16384, 16896, 24576,
                 32768, 65536)
# The train phase's batch: 8 patches of 256x256 (tests/test_bls2017.py's
# step at the models' published widths).
TRAIN_BATCH = (8, 256, 256, 3)
# compress_device's default budget: 64 escapes of 2 * 16 + 3 slots each.
ESCAPE_BUDGET = 64
MICRO_SLOTS = 2 * 16 + 3
# A rounded pixel may differ from a golden image only where the float image
# lies this close to a rounding boundary (the float error of the transforms
# between two implementations reaches 1e-4).
PIXEL_BOUNDARY = 2e-4
# Dependent register operations a step of the warp-per-stream chain (the
# micro-op scan's, which K1's and K6''s warp kernels share) takes from one
# size - 1 to the next in the compiled kernel (scan_floor_ms).
SCAN_CHAIN_OPS = 6
# ms2020 at the reference CLI's widths (compression_tpu/models/ms2020.py
# main()), nothing cut: ~100M parameters.
MS2020_CONFIG = dict(num_filters=192, latent_depth=320, hyperprior_depth=192,
                     num_slices=10, max_support_slices=5, num_scales=64)
# HiFiC's GAN training: the JAX package's train defaults (batch 2 of
# 256x256, Adam at 1e-4, one d step a g step), 12 steps on the card.
HIFIC_TRAIN_BATCH = (2, 256, 256, 3)
HIFIC_TRAIN_STEPS = 12
HIFIC_TRAIN_LR = 1e-4
# Stream counts at which the host C coder is timed against the card's
# reference-format wrappers (below the JAX package's host-route cap of 256),
# and symbols a stream (cut from bmshj2018's y stream).
# Phase 7u: bmshj2018's y for a batch of 8 images of 512x512.
UNIVERSAL_SHAPE = (8, 32, 32, 192)
CAP_STREAMS = (1, 16, 64, 255)
CAP_SYMBOLS = 8192
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


def zipf_table(precision=12, alphabet=256):
    """bench.py's workload table: zipf alpha 1.2 over 256 symbols (or
    ``alphabet``) at precision 12 (or ``precision``), one row, no overflow;
    returns (table, pmf)."""
    from compression_tpu_torch.codec import tables
    pmf = 1.0 / (1 + np.arange(alphabet)) ** 1.2
    pmf /= pmf.sum()
    return tables.parse_ragged_cdf(tables.build_ragged_cdf(
        [tables.pmf_to_quantized_cdf(pmf, precision)], [precision],
        [False])), pmf


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


def check_variants(name, args, out_size, expect=None):
    """An encoder with two kernels (K1, K6' or K6's micro-op mode:
    ``name``) on one input: the plain version once, and the wrapper's
    choice and both of its kernels (warp and thread per stream) held
    against that result.  ``expect`` (bytes, lengths) stands for the plain
    run where another kernel's result, already held against its own plain
    version, is the same function's (plain ms None).  Returns (bytes,
    lengths, identical, plain ms, "warp" or "thread": the wrapper's
    choice)."""
    import torch
    from compression_tpu_torch.codec import cuda_coder as cc
    warp_before = cc.LAUNCHES_WARP[name]
    out_k, len_k = getattr(cc, name)(*args, out_size)
    took = "warp" if cc.LAUNCHES_WARP[name] == warp_before + 1 else "thread"
    torch.cuda.synchronize()
    if expect is None:
        out_p, len_p = torch.empty_like(out_k), torch.empty_like(len_k)
        ms = _plain_ms(lambda: getattr(cc, name + "_plain")(*args, out_p,
                                                            len_p))
    else:
        (out_p, len_p), ms = expect, None
    same = True
    for run in (lambda: (out_k, len_k),
                lambda: getattr(cc, name + "_warp")(*args, out_size),
                lambda: getattr(cc, name + "_thread")(*args, out_size)):
        out_v, len_v = run()
        torch.cuda.synchronize()
        same &= bool(torch.equal(out_v, out_p) and torch.equal(len_v, len_p))
        MAX_ABS_ERR[name] = max(MAX_ABS_ERR[name],
                                _err((out_v, out_p), (len_v, len_p)))
    return out_k, len_k, same, ms, took


def check_scan(label, ops, out_size, fails, expect_warp=None):
    """K6's micro-op mode on one input (``check_variants``); ``expect_warp``
    (True or False) checks the wrapper's choice.  Returns (bytes, lengths,
    identical, plain ms)."""
    out_k, len_k, same, ms, took = check_variants("encode_scan", ops,
                                                  out_size)
    if expect_warp is not None and (took == "warp") != expect_warp:
        same = False
    log("kernels", case=label, steps=int(ops[0].shape[0]),
        streams=int(ops[0].shape[1]), out_size=out_size,
        coded=int(ops[3].sum()), wrapper_took=took,
        identical_wrapper_and_both_kernels=same)
    if not same:
        fails.append(label)
    return out_k, len_k, same, ms


def tests_module(name):
    """tests/<name>.py (numpy and the port only), loaded by path: the
    inputs the tests use too (scan_cases: random and constructed micro-ops;
    symbol_cases: symbols for K1 and K6')."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "tests", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def decode_variants(name, table, took=None):
    """A decoder with two kernels (K2 or K3': ``name``) by the wrapper's
    own choice, and both of its kernels whatever the shape; arguments
    (buf, lens, indexes, cdf, meta).  The wrapper's choice of each call
    ("warp" or "thread") is appended to ``took``."""
    from compression_tpu_torch.codec import cuda_coder as cc
    layout = table.warp_arrays()

    def chosen(*a):
        before = cc.LAUNCHES_WARP[name]
        out = getattr(cc, name)(*a, layout)
        if took is not None:
            took.append("warp" if cc.LAUNCHES_WARP[name] > before
                        else "thread")
        return out

    return (chosen, (lambda *a: getattr(cc, name + "_warp")(*a, layout),
                     getattr(cc, name + "_thread")))


def decode_choice_ok(took, streams):
    """The wrapper's choices follow the stream count and the dispatch
    constant."""
    from compression_tpu_torch.codec import cuda_coder as cc
    want = "warp" if streams <= cc.WARP_DECODE_MAX_STREAMS else "thread"
    return bool(took) and set(took) == {want}


def compare_kernels(name, table, symbols, indexes, out_size, fails,
                    expect_warp=None):
    """K1 and K2 against their plain versions on one input, each by its
    wrapper's choice and both of its kernels; ``expect_warp`` checks K1's
    wrapper's choice, K2's must follow WARP_DECODE_MAX_STREAMS.  Returns
    K1's (bytes, lengths)."""
    from compression_tpu_torch.codec import cuda_coder as cc
    cdf, meta = table.indexed_arrays()
    out_k, len_k, enc_ok, _, took = check_variants(
        "encode_indexed", (symbols, indexes, cdf, meta), out_size)
    dec_took = []
    chosen, both = decode_variants("decode_indexed", table, dec_took)
    _, san_k, dec_ok, _ = check_decode(
        "decode_indexed", chosen, cc.decode_indexed_plain,
        (out_k, len_k, indexes, cdf, meta), both)
    choice_ok = decode_choice_ok(dec_took, int(symbols.shape[0]))
    log("kernels", case=name, streams=int(symbols.shape[0]),
        symbols=int(symbols.shape[1]), rows=int(cdf.shape[0]),
        max_precision=int(meta[:, 1].max()),
        encode_identical_wrapper_and_both_kernels=enc_ok,
        encode_wrapper_took=took,
        decode_identical_wrapper_and_both_kernels=dec_ok,
        decode_wrapper_took=dec_took[0], sanity_all=bool(san_k.all()))
    if not (enc_ok and dec_ok and choice_ok and bool(san_k.all())) or (
            expect_warp is not None and (took == "warp") != expect_warp):
        fails.append(name)
    return out_k, len_k


def compare_single_row(name, table, symbols, fails, expect=None):
    """K4' and K5' against their plain versions, K5' with the table's
    cached slot table; K4' also into rows of odd width and K5' on those
    bytes in a buffer of odd width (every other row at an odd address).
    Returns (bytes, lengths, plain encode ms, plain decode ms, plain K8'
    ms)."""
    import torch
    from compression_tpu_torch.codec import cuda_coder as cc, torch_coder
    cdf, meta = table.indexed_arrays()
    slots = table.single_row_slots()
    n = int(symbols.shape[1])
    out_size = torch_coder.stream_out_size(n)
    decode = lambda b, ln, c, m: cc.decode_single_row(b, ln, n, c, m, slots)
    out_k, len_k, enc_ok, enc_ms = check_encode(
        "encode_single_row", cc.encode_single_row, cc.encode_single_row_plain,
        (symbols, cdf, meta), out_size)
    sym_k, san_k, dec_ok, dec_ms = check_decode(
        "decode_single_row", decode, cc.decode_single_row_plain,
        (out_k, len_k, cdf, meta))
    exact = bool(torch.equal(sym_k, symbols if expect is None else expect))
    # Rows of odd width: K4''s rows, and K5''s buffer, at odd addresses.
    odd_k, odd_len, odd_enc_ok, _ = check_encode(
        "encode_single_row", cc.encode_single_row, cc.encode_single_row_plain,
        (symbols, cdf, meta), out_size + 1)
    odd_buf = torch.zeros((out_k.shape[0], out_size + 1), dtype=torch.uint8,
                          device=out_k.device)
    odd_buf[:, :out_size] = out_k
    odd_sym, _, odd_dec_ok, _ = check_decode(
        "decode_single_row", decode, cc.decode_single_row_plain,
        (odd_buf, len_k, cdf, meta))
    odd_ok = bool(odd_enc_ok and odd_dec_ok and torch.equal(odd_sym, sym_k)
                  and torch.equal(odd_k[:, :out_size], out_k)
                  and torch.equal(odd_len, len_k))
    # K8', the second single-row decoder: its plain version, and K5'.
    sym_b, san_b, buck_ok, buck_ms = check_decode(
        "decode_single_row_bucketed",
        lambda b, ln, *row: cc.decode_single_row_bucketed(b, ln, n, *row),
        cc.decode_single_row_bucketed_plain,
        (out_k, len_k) + table.bucketed_arrays())
    agree = bool(torch.equal(sym_b, sym_k) and torch.equal(san_b, san_k))
    log("kernels", case=name, streams=int(symbols.shape[0]), symbols=n,
        rows=1, max_precision=int(meta[0, 1]),
        slot_table_bytes=int(4 * slots[0].numel()), encode_identical=enc_ok,
        decode_identical=dec_ok, odd_width_identical=odd_ok,
        sanity_all=bool(san_k.all()), round_trip=exact,
        bucketed_identical=buck_ok, bucketed_equals_single_row=agree)
    if not (enc_ok and dec_ok and odd_ok and exact and bool(san_k.all())
            and buck_ok and agree):
        fails.append(name)
    return out_k, len_k, enc_ms, dec_ms, buck_ms


def compare_gamma(name, table, symbols, indexes, fails, round_trip=True,
                  expect_warp=None):
    """K6' and K3' against their plain versions, each by its wrapper's
    choice and both of its kernels; ``expect_warp`` checks K6''s wrapper's
    choice.  Returns (bytes, lengths, coded intervals, plain encode ms,
    plain decode ms)."""
    import torch
    from compression_tpu_torch.codec import cuda_coder as cc, torch_coder
    cdf, meta = table.indexed_arrays()
    counts, escape, _, _ = cc.interval_counts(symbols, indexes, meta)
    intervals = int(counts.sum())
    out_size = torch_coder.stream_out_size(int(counts.sum(1).max()))
    out_k, len_k, enc_ok, enc_ms, took = check_variants(
        "encode_gamma", (symbols, indexes, cdf, meta), out_size)
    chosen, both = decode_variants("decode_gamma", table)
    sym_k, san_k, dec_ok, dec_ms = check_decode(
        "decode_gamma", chosen, cc.decode_gamma_plain,
        (out_k, len_k, indexes, cdf, meta), both)
    exact = bool(torch.equal(sym_k, symbols)) if round_trip else None
    log("kernels", case=name, streams=int(symbols.shape[0]),
        symbols=int(symbols.shape[1]), rows=int(cdf.shape[0]),
        escapes=int(escape.sum()), coded_intervals=intervals,
        encode_identical_wrapper_and_both_kernels=enc_ok,
        encode_wrapper_took=took, decode_identical_both_variants=dec_ok,
        sanity_all=bool(san_k.all()), round_trip=exact)
    if not (enc_ok and dec_ok and exact is not False
            and (bool(san_k.all()) or not round_trip)) or (
                expect_warp is not None and (took == "warp") != expect_warp):
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
    """(launches per kernel, with those of K1, K2, K3', K6' and K6's
    micro-op mode that took the warp-per-stream kernel under "<name>/warp";
    dispatch routes of ``keys``)."""
    import torch
    from compression_tpu_torch.codec import cuda_coder, torch_coder
    torch.cuda.synchronize()
    launches = dict(cuda_coder.LAUNCHES)
    for name, count in cuda_coder.LAUNCHES_WARP.items():
        launches[f"{name}/warp"] = count
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


def slot_floor_ms(symbols, precision, clock_mhz):
    """The serial chain's own floor for K5' (ms): symbols x the dependent
    operations of one symbol in the compiled kernel (cuobjdump -sass) x
    their latency, at the card's highest SM clock.  From one size - 1 to
    the next the chain runs through 21 register operations (select, float
    conversion and add, reciprocal, multiply, min, rounding conversion,
    wide multiply-add, two compares, three selects, min, address; after
    the slot's load: mask, wide multiply-add, funnel shift, complement,
    add, test) and one shared-memory load; above precision 14 through 23
    and two loads (the count, then the row).  Taken at 4 clocks a register
    operation and 23 a shared-memory load, the architecture's nominal
    latencies (not measured here)."""
    clocks = 21 * 4 + 23 if precision <= 14 else 23 * 4 + 2 * 23
    return symbols * clocks / (clock_mhz * 1e3)


def bucketed_floor_ms(symbols, num_buckets, clock_mhz):
    """The serial chain's own floor for K8' (ms) on a row of at most 64
    buckets (the bucket count from registers): symbols x the dependent
    operations of one symbol in the compiled kernel (cuobjdump -sass of
    decode_bucketed_kernel<5>, the zipf row's 17 buckets in 5 quads) x
    their latency, at the card's highest SM clock.  From one size - 1 to
    the next the chain runs through 13 register operations for the
    threshold (float conversion and add, reciprocal, multiply, min,
    rounding conversion, wide multiply-add, two compares, three selects
    and adds, min), q + 5 for the bucket count over q quads (difference,
    shift, q - 1 shift-adds of the longest partial sum, two adds, min,
    address), the window's shared load, 8 for its count (difference,
    shift, three shift-adds, two adds, address), the interval's shared
    load and 6 for the update (wide multiply-add, funnel shift,
    complement, add, test, select).  Taken at 4 clocks a register
    operation and 23 a shared-memory load, the architecture's nominal
    latencies (not measured here)."""
    quads = -(-num_buckets // 4)
    clocks = (13 + quads + 5 + 8 + 6) * 4 + 2 * 23
    return symbols * clocks / (clock_mhz * 1e3)


def scan_floor_ms(coded_steps, clock_mhz):
    """The serial chain's own floor for the warp-per-stream micro-op scan
    (ms): coded steps x the dependent operations of one step in the
    compiled kernel (cuobjdump -sass) x their latency, at the card's
    highest SM clock.  The chain from one step's size - 1 to the next runs
    through SCAN_CHAIN_OPS register operations (wide multiply-add, funnel
    shift, complement, add, compare, select), taken at 4 clocks each, the
    architecture's nominal latency (not measured here)."""
    return coded_steps * SCAN_CHAIN_OPS * 4 / (clock_mhz * 1e3)


def host_ms(fn, runs=5):
    """Median ms of fn (host clock around the call and a synchronize),
    after one warm-up."""
    import torch
    fn()
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


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


def bls_native(codec, y, x_hw):
    """bls2017's native container of the latent ``y`` of an image of
    ``x_hw``: the codec's own encode and pack, from a given latent."""
    from compression_tpu_torch.models import native_format

    out = codec.em.compress_sidecar_device(native_format.to_streams(y))
    return codec._container((out, tuple(y.shape[1:]), tuple(x_hw)))


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
        indexes, _ = codec._y_params(codec.side_em.quantize(z), y.shape[1:3])
        from_latents = (codec.em.compress_to_strings(y, indexes),
                        codec.side_em.compress_to_strings(z))
        my, mz, _, _ = codec._encode(codec._upload(gold["x_test"]))
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


def host_coder_phase(cases, fails):
    """codec.host against torch_coder.encode_streams / decode_streams on
    the card: identical bytes, symbols and sanity flags; the host's median
    ms of 5 and the card wrappers' ms (CUDA events)."""
    from compression_tpu_torch.codec import host, torch_coder
    # The first processor's entries (a sandbox may say "unknown" for the
    # model name; family and model still name the part).
    info = {}
    for line in open("/proc/cpuinfo"):
        key, _, value = line.partition(":")
        if not key.strip():
            break
        info.setdefault(key.strip(), value.strip())
    cpu_model = {k: info.get(k) for k in ("vendor_id", "cpu family", "model",
                                          "model name", "cpu MHz")}
    for label, (sym, idx, tab) in cases.items():
        s, n = sym.shape
        buf, lens = torch_coder.encode_streams(sym, tab, idx)
        out, sane = torch_coder.decode_streams(buf, lens, n, tab, idx)
        routes = {k: torch_coder.DISPATCH_LOG.get(k)
                  for k in ("encode", "decode")}
        sym_np = sym.cpu().numpy()
        idx_np = None if idx is None else idx.cpu().numpy()
        card_strings = torch_coder.to_bytes_list(buf.cpu().numpy(),
                                                 lens.cpu().numpy())
        enc_ms, dec_ms = [], []
        for _ in range(5):
            t0 = time.perf_counter()
            strings = host.encode_streams(sym_np, tab.host, idx_np)
            t1 = time.perf_counter()
            h_out, h_sane = host.decode_streams(strings, n, tab.host, idx_np)
            dec_ms.append((time.perf_counter() - t1) * 1e3)
            enc_ms.append((t1 - t0) * 1e3)
        same = {
            "bytes_identical": strings == card_strings,
            "symbols_identical": bool(np.array_equal(h_out,
                                                     out.cpu().numpy())),
            "sanity_identical": bool(np.array_equal(h_sane,
                                                    sane.cpu().numpy())),
            "round_trip": bool(np.array_equal(h_out, sym_np)
                               and h_sane.all())}
        log("host_coder", case=label, shape=[s, n],
            mode="channel" if idx is None else "indexed",
            coded_bytes=int(sum(map(len, strings))),
            host_encode_ms_median=float(np.median(enc_ms)),
            host_decode_ms_median=float(np.median(dec_ms)),
            host_encode_ms=enc_ms, host_decode_ms=dec_ms,
            host_threads=host._num_threads(s), host_cpu=cpu_model,
            host_cpu_count=os.cpu_count(),
            card_encode_ms=cuda_ms(
                lambda: torch_coder.encode_streams(sym, tab, idx), 5),
            card_decode_ms=cuda_ms(
                lambda: torch_coder.decode_streams(buf, lens, n, tab, idx), 5),
            card_routes=routes, **same)
        if not all(same.values()):
            fails.append(f"host_coder/{label}")


def train_phase(device, fails, steps=30):
    """One step of each model on the card against the CPU (same
    parameters, batch and noise, TF32 off; the CPU once on its own and once
    with the card's relu decisions, SharedKinks), then ``steps`` Adam steps
    on the card, timed by CUDA events around each synchronized step."""
    import torch
    from compression_tpu_torch.models import bls2017, bmshj2018, ms2020
    from compression_tpu_torch.util.kinks import SharedKinks
    makers = {
        "bls2017": lambda: bls2017.BLS2017Model(num_filters=NUM_FILTERS,
                                                seed=0),
        "bmshj2018": lambda: bmshj2018.BMSHJ2018Model(
            num_filters=BMSHJ_FILTERS, num_scales=64, seed=0),
        "ms2020": lambda: ms2020.MS2020Model(**MS2020_CONFIG, seed=0)}
    # The module whose relus SharedKinks shares (bls2017 has none).
    kink_modules = {"bls2017": bmshj2018, "bmshj2018": bmshj2018,
                    "ms2020": ms2020}
    # Adam's rate for the card steps: ms2020 at the reference CLI's
    # default; at 1e-3 its loss spikes on this init and batch and need not
    # fall in 30 steps (PERF.md §6).
    rates = {"bls2017": 1e-3, "bmshj2018": 1e-3, "ms2020": 1e-4}
    batch = np.random.RandomState(1).randint(
        0, 256, TRAIN_BATCH).astype(np.float32)
    x_cpu = torch.as_tensor(batch)
    x_card = x_cpu.to(device)

    def one_step(model, x, u):
        model.zero_grad()
        t0 = time.perf_counter()
        loss, bpp, mse = model(x, training=True,
                               u=u[0] if len(u) == 1 else tuple(u))
        loss.backward()
        if x.device.type == "cuda":
            torch.cuda.synchronize()
        return {"metrics": [t.item() for t in (loss, bpp, mse)],
                "grads": {k: p.grad.detach().cpu()
                          for k, p in model.named_parameters()},
                "ms": (time.perf_counter() - t0) * 1e3}

    def max_grad_err(found):
        """The largest error of a gradient over its largest magnitude (the
        error itself where the CPU's gradient is all zero), and where."""
        err = {}
        for k, g in found["grads"].items():
            scale = float(g.abs().max())
            err[k] = float((card_step["grads"][k] - g).abs().max()) / (
                scale if scale > 0 else 1.0)
        worst = max(err, key=err.get)
        return err[worst], worst

    for name, make in makers.items():
        cpu = make()
        card = make().to(device)
        card.load_state_dict(cpu.state_dict())
        gen = torch.Generator(device=device).manual_seed(7)
        with torch.no_grad():
            if name == "bls2017":
                shapes = [card.analysis(x_card).shape]
            else:
                y, z = card.encode(x_card)
                shapes = [z.shape, y.shape]
                if name == "ms2020":  # z, then each slice
                    shapes = shapes[:1] + [y.shape[:-1] + (
                        card.slice_depth,)] * card.num_slices
            u_card = [torch.empty(sh, device=device).uniform_(
                -0.5, 0.5, generator=gen) for sh in shapes]
        u_cpu = [t.cpu() for t in u_card]
        kinks = SharedKinks()
        with kinks.sharing(kink_modules[name]):
            card_step = one_step(card, x_card, u_card)
            kinks.replay = list(kinks.masks)
            shared_step = one_step(cpu, x_cpu, u_cpu)
        cpu_step = one_step(cpu, x_cpu, u_cpu)
        err, worst = max_grad_err(shared_step)
        err_own, worst_own = max_grad_err(cpu_step)
        metric_err = [abs(a - b) / abs(b) for a, b in zip(
            card_step["metrics"], cpu_step["metrics"])]
        # 30 steps on the card from the same start, one fixed batch.
        step = bls2017.make_train_step(
            card, torch.optim.Adam(card.parameters(), lr=rates[name]))
        losses, step_ms = [], []
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        for _ in range(steps):
            torch.cuda.synchronize()
            start.record()
            metrics = step(x_card, generator=gen)
            end.record()
            torch.cuda.synchronize()
            step_ms.append(start.elapsed_time(end))
            losses.append(float(metrics["loss"]))
        ok = {"grads_within_1e-3": err <= 1e-3,
              "metrics_within_1e-3": max(metric_err) <= 1e-3,
              "loss_fell": losses[-1] < losses[0],
              "finite": bool(np.isfinite(losses).all())}
        log("train", model=name, num_filters=card.num_filters,
            batch=list(TRAIN_BATCH), learning_rate=rates[name],
            tf32_cudnn=torch.backends.cudnn.allow_tf32,
            tf32_matmul=torch.backends.cuda.matmul.allow_tf32,
            cudnn_deterministic=torch.backends.cudnn.deterministic,
            cudnn_benchmark=torch.backends.cudnn.benchmark,
            card_loss_bpp_mse=card_step["metrics"],
            cpu_loss_bpp_mse=cpu_step["metrics"],
            metric_rel_err=metric_err, parameters=len(cpu_step["grads"]),
            max_grad_err=err, max_grad_err_param=worst,
            relu_decisions_shared=len(kinks.masks),
            relu_elements_the_cpu_decided_otherwise=kinks.flips["relu"],
            max_grad_err_own_decisions=err_own,
            max_grad_err_own_decisions_param=worst_own,
            cpu_step_ms=cpu_step["ms"], first_card_step_ms=card_step["ms"],
            losses=losses, step_ms=step_ms,
            step_ms_median_4_to_30=float(np.median(step_ms[3:])), **ok)
        if not all(ok.values()):
            fails.append(f"train/{name}")
        del cpu, card, step
        torch.cuda.empty_cache()


def hific_train_phase(device, img, smi, fails, steps=HIFIC_TRAIN_STEPS,
                      registry_hook=None):
    """Phase 7h: HiFiC's GAN training at get_config("hific") with the
    hific-width discriminator and LPIPS on random_lpips_weights(0), batch
    HIFIC_TRAIN_BATCH.  (a) One g step and one d step on the card against
    the CPU from the same parameters, batch and noise, TF32 off, the CPU
    taking the card's decisions at the kinks (SharedKinks over hific, lpips
    and round_st; its own decisions beside): metrics within 1e-3 relative,
    every gradient within 1e-3 of its largest magnitude, the
    discriminator's u and sigma after the d step within 1e-5 (the d step
    starts on both from the card's generator after its g step).  (b)
    ``steps`` g+d steps on the card at HIFIC_TRAIN_LR: finite losses, the
    median g- and d-step ms of steps 3-``steps`` by CUDA events, the flops
    of a step by torch's flop counter.  (c) The trained generator served:
    HiFiCCodec's native and classic containers of ``img`` decode to
    reconstruct(img).  (d) hific.main: train 2 steps at batch 1 of 256x256,
    then compress and decompress ``img`` as .npy through the checkpoint;
    the output equals the loaded codec's reconstruct.  The checkpoint is
    written as ``<tmp>/hific``, a tfci registry: ``registry_hook(tmp)``
    runs there, after (d)'s counts are read, before the directory goes.
    Returns the launch counts of (c) and (d)."""
    import copy
    import tempfile

    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from compression_tpu_torch.models import hific, lpips
    from compression_tpu_torch.ops import round_ops
    from compression_tpu_torch.util.kinks import SharedKinks
    cfg = hific.get_config("hific")
    t0 = time.time()
    template = hific.HiFiCModel(cfg, seed=0)
    disc_template = hific.Discriminator(template.latent_depth, seed=0)
    batch = np.random.RandomState(1).randint(
        0, 256, HIFIC_TRAIN_BATCH).astype(np.float32)

    def fresh(dev):
        model = copy.deepcopy(template).to(dev)
        disc = copy.deepcopy(disc_template).to(dev)
        g_step, d_step = hific.make_train_steps(
            model, disc, torch.optim.Adam(model.parameters(),
                                          lr=HIFIC_TRAIN_LR),
            torch.optim.Adam(disc.parameters(), lr=HIFIC_TRAIN_LR))
        return model, disc, g_step, d_step

    with torch.no_grad():
        y, z = template.encode(torch.as_tensor(batch[:1]))
    shapes = [(HIFIC_TRAIN_BATCH[0],) + tuple(t.shape[1:]) for t in (z, y)]
    gen = torch.Generator(device=device).manual_seed(7)
    u_card = [tuple(torch.empty(sh, device=device).uniform_(
        -0.5, 0.5, generator=gen) for sh in shapes) for _ in range(2)]
    u_cpu = [tuple(t.cpu() for t in u) for u in u_card]

    def sync(dev):
        if torch.device(dev).type == "cuda":
            torch.cuda.synchronize()

    def parity_run(dev, u, after_g=None):
        """One g step, then (from ``after_g``'s generator state when
        given) one d step; metrics, gradients, the disc's state, the
        generator's state after the g step and the ms of each step."""
        model, disc, g_step, d_step = fresh(dev)
        x = torch.as_tensor(batch, device=dev)
        t1 = time.perf_counter()
        g = g_step(x, 0, u=u[0])
        sync(dev)
        t2 = time.perf_counter()
        grads = {k: p.grad.detach().cpu() for k, p in
                 model.named_parameters()}
        state = {k: v.detach().cpu().clone() for k, v in
                 model.state_dict().items()}
        if after_g is not None:
            model.load_state_dict(after_g)
        t3 = time.perf_counter()
        d = d_step(x, u=u[1])
        sync(dev)
        t4 = time.perf_counter()
        grads.update({f"disc.{k}": p.grad.detach().cpu()
                      for k, p in disc.named_parameters()})
        out = {"metrics": {k: float(v) for k, v in {**g, **d}.items()},
               "grads": grads, "state_after_g": state,
               "disc_state": {k: b.cpu() for k, b in disc.named_buffers()},
               "g_ms": (t2 - t1) * 1e3, "d_ms": (t4 - t3) * 1e3}
        del model, disc
        return out

    kinks = SharedKinks()
    with kinks.sharing(hific, lpips, round_ops=round_ops):
        card = parity_run(device, u_card)
        decisions = len(kinks.masks)
        kinks.replay = list(kinks.masks)
        shared = parity_run("cpu", u_cpu, card["state_after_g"])
        left_over = len(kinks.replay)
    kinks.masks, kinks.replay = [], None
    own = parity_run("cpu", u_cpu, card["state_after_g"])

    def grad_err(found):
        err = {}
        for k, g in found["grads"].items():
            scale = float(g.abs().max())
            err[k] = float((card["grads"][k] - g).abs().max()) / (
                scale if scale > 0 else 1.0)
        worst = max(err, key=err.get)
        return err[worst], worst

    def metric_err(found):
        return {k: abs(card["metrics"][k] - v) / abs(v)
                for k, v in found["metrics"].items()}

    err, worst = grad_err(shared)
    err_own, worst_own = grad_err(own)
    m_err, m_err_own = metric_err(shared), metric_err(own)
    state_err = max(float((card["disc_state"][k] - v).abs().max())
                    for k, v in shared["disc_state"].items())
    parity = {"grads_within_1e-3": err <= 1e-3,
              "metrics_within_1e-3": max(m_err.values()) <= 1e-3,
              "disc_state_within_1e-5": state_err <= 1e-5,
              "every_decision_replayed": left_over == 0}
    log("hific_train", part="parity", config="hific",
        parameters=sum(p.numel() for p in template.parameters()),
        disc_parameters=sum(p.numel() for p in disc_template.parameters()),
        batch=list(HIFIC_TRAIN_BATCH), lpips="random_lpips_weights(0)",
        tf32_cudnn=torch.backends.cudnn.allow_tf32,
        tf32_matmul=torch.backends.cuda.matmul.allow_tf32,
        card_metrics=card["metrics"], cpu_metrics=shared["metrics"],
        metric_rel_err=m_err, metric_rel_err_own_decisions=m_err_own,
        max_grad_err=err, max_grad_err_param=worst,
        max_grad_err_own_decisions=err_own,
        max_grad_err_own_decisions_param=worst_own,
        disc_state_max_abs_err=state_err, decisions_shared=decisions,
        elements_the_cpu_decided_otherwise=kinks.flips,
        cpu_g_step_ms=shared["g_ms"], cpu_d_step_ms=shared["d_ms"],
        first_card_g_step_ms=card["g_ms"], first_card_d_step_ms=card["d_ms"],
        setup_seconds=round(time.time() - t0, 3), **parity)
    if not all(parity.values()):
        fails.append("hific_train/parity")
    del card, shared, own

    # (b) steps g+d steps on the card; the flops of the first.
    model, disc, g_step, d_step = fresh(device)
    x = torch.as_tensor(batch, device=device)
    events = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    losses, g_ms, d_ms, flops = [], [], [], {}
    for i in range(steps):
        torch.cuda.synchronize()
        if i == 0:  # counted, not timed
            metrics = {}
            for name, fn in (("g", lambda: g_step(x, i, generator=gen)),
                             ("d", lambda: d_step(x, generator=gen))):
                counter = FlopCounterMode(display=False)
                with counter:
                    metrics.update(fn())
                flops[name] = counter.get_total_flops()
        else:
            events[0].record()
            metrics = g_step(x, i, generator=gen)
            events[1].record()
            metrics.update(d_step(x, generator=gen))
            events[2].record()
            torch.cuda.synchronize()
            g_ms.append(events[0].elapsed_time(events[1]))
            d_ms.append(events[1].elapsed_time(events[2]))
        losses.append({k: float(v) for k, v in metrics.items()})
    g_med, d_med = float(np.median(g_ms[1:])), float(np.median(d_ms[1:]))
    finite = bool(all(np.isfinite(list(m.values())).all() for m in losses))
    log("hific_train", part="steps", steps=steps,
        learning_rate=HIFIC_TRAIN_LR, losses=losses, g_step_ms=g_ms,
        d_step_ms=d_ms, g_step_ms_median_3_to_12=g_med,
        d_step_ms_median_3_to_12=d_med,
        g_step_gflop=flops["g"] / 1e9, d_step_gflop=flops["d"] / 1e9,
        g_step_tflop_per_s=flops["g"] / g_med / 1e9,
        d_step_tflop_per_s=flops["d"] / d_med / 1e9,
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
        finite=finite, card=smi)
    if not finite:
        fails.append("hific_train/steps")
    del disc, g_step, d_step

    # (c) and (d): the trained generator served, and the command line.
    reset_counts()
    with torch.no_grad():
        codec = hific.HiFiCCodec(model, device=device)
        native = codec.compress_native(img)
        classic = codec.compress(img)
        recon = codec.reconstruct(img)
        served = {
            "native_equals_reconstruct": bool(np.array_equal(
                codec.decompress(native), recon)),
            "classic_equals_reconstruct": bool(np.array_equal(
                codec.decompress(classic), recon))}
    del codec, model
    torch.cuda.empty_cache()
    t1 = time.time()
    with tempfile.TemporaryDirectory(dir=REPO) as tmp:
        ckpt = os.path.join(tmp, "hific")
        src = os.path.join(tmp, "img.npy")
        out = os.path.join(tmp, "out.npy")
        np.save(src, img)
        hific.main(["train", "--model_path", ckpt, "--num_steps", "2",
                    "--batchsize", "1", "--patchsize", "256"])
        hific.main(["compress", "--model_path", ckpt, src])
        hific.main(["decompress", "--model_path", ckpt, src + ".tfci", out])
        # Read before the check's own compress, which no path needs.
        launches, routes = read_counts(("encode", "decode",
                                        "decode_sidecar"))
        from compression_tpu_torch.util import checkpoint
        payload, _ = checkpoint.load_checkpoint(ckpt)
        loaded = hific.HiFiCModel(cfg)
        loaded.load_state_dict(payload["params"])
        codec = hific.HiFiCCodec(loaded, device=device)
        with open(src + ".tfci", "rb") as f:
            container = f.read()
        cli = {"cli_decompress_equals_reconstruct": bool(np.array_equal(
                   np.load(out), codec.reconstruct(img))),
               "cli_container_equals_compress":
                   container == codec.compress(img)}
        del codec, loaded, payload
        torch.cuda.empty_cache()
        if registry_hook is not None:
            registry_hook(tmp)
    # Served: native 2 K1 + classic 2 encodes (K1 or K6'), 2 K2, 2 K3';
    # the command line: 2 encodes and 2 K3'.
    encodes = launches["encode_indexed"] + launches["encode_gamma"]
    counted = {"encodes": encodes == 6,
               "decode_indexed": launches["decode_indexed"] == 2,
               "decode_gamma": launches["decode_gamma"] == 4,
               "all_warp": all(launches[f"{k}/warp"] == launches[k] for k in (
                   "encode_indexed", "encode_gamma", "decode_indexed",
                   "decode_gamma"))}
    ok = {**served, **cli, **counted}
    log("hific_train", part="serve_and_cli", image=list(img.shape),
        native_bytes=len(native), classic_bytes=len(classic),
        cli_container_bytes=len(container), launches=launches, routes=routes,
        cli_seconds=round(time.time() - t1, 3), **ok)
    if not all(ok.values()):
        fails.append("hific_train/serve_and_cli")
    torch.cuda.empty_cache()
    return launches


def classic_phase(codecs, images, sweep, fails):
    """Phase 4g: each codec's classic compress / decompress on each image
    on the card: the container decodes to reconstruct(x), every call takes
    a kernel's route ("cuda-gamma" or "cuda-indexed"), and e2e ms.  Then
    the host C coder against the card's reference-format wrappers at a few
    streams: ``sweep`` = (symbols [1, N], indexes, table) of one classic
    stream, cut into streams of CAP_SYMBOLS symbols and tiled to
    CAP_STREAMS streams, encoded and decoded by both: identical bytes,
    symbols and flags, and the median ms of each (host clock, the copies
    included)."""
    import torch
    from compression_tpu_torch.codec import host, torch_coder
    for model, codec in codecs.items():
        for name, img in images.items():
            with torch.no_grad():
                container = codec.compress(img)
                routes = [torch_coder.DISPATCH_LOG.get("encode")]
                x_hat = codec.decompress(container)
                routes.append(torch_coder.DISPATCH_LOG.get("decode"))
                exact = bool(np.array_equal(x_hat, codec.reconstruct(img)))
                times = e2e_times(codec.compress, codec.decompress, img)
            log("classic", model=model, image=name,
                decompress_equals_reconstruct=exact, routes=routes,
                e2e=times)
            if not (exact and all(r in ("cuda-gamma", "cuda-indexed")
                                  for r in routes)):
                fails.append(f"classic/{model}/{name}")
    sym, idx, table = sweep
    n = CAP_SYMBOLS
    base_sym = sym.reshape(-1, n)
    base_idx = idx.reshape(-1, n)
    for streams in CAP_STREAMS:
        reps = -(-streams // base_sym.shape[0])
        s_sym = base_sym.repeat(reps, 1)[:streams].contiguous()
        s_idx = base_idx.repeat(reps, 1)[:streams].contiguous()
        buf, lens = torch_coder.encode_streams(s_sym, table, s_idx)
        routes = [torch_coder.DISPATCH_LOG["encode"]]
        dec, ok = torch_coder.decode_streams(buf, lens, n, table, s_idx)
        routes.append(torch_coder.DISPATCH_LOG["decode"])
        strings = torch_coder.to_bytes_list(buf.cpu().numpy(),
                                            lens.cpu().numpy())

        def host_encode():
            return host.encode_streams(s_sym.cpu().numpy(), table.host,
                                       s_idx.cpu().numpy())

        def host_decode():
            return host.decode_streams(strings, n, table.host,
                                       s_idx.cpu().numpy())

        h_dec, h_ok = host_decode()
        same = (host_encode() == strings
                and np.array_equal(h_dec, dec.cpu().numpy())
                and np.array_equal(h_ok, ok.cpu().numpy())
                and torch.equal(dec, s_sym) and bool(ok.all()))
        log("host_vs_card", streams=streams, symbols=n,
            coded_bytes=int(lens.sum()), identical=same, card_routes=routes,
            host_encode_ms=host_ms(host_encode),
            card_encode_ms=host_ms(lambda: torch_coder.encode_streams(
                s_sym, table, s_idx)),
            host_decode_ms=host_ms(host_decode),
            card_decode_ms=host_ms(lambda: torch_coder.decode_streams(
                buf, lens, n, table, s_idx)))
        if not (same and all(r.startswith("cuda-") for r in routes)):
            fails.append(f"host_vs_card/{streams}")


def ms2020_inputs(codec, img):
    """What ms2020's compresses hand the coder for one image, from the
    codec's own slice loop: the native compress's stacked slices' (symbols,
    indexes) [10 * h * k, n] and z's, then the classic compress's one
    encode of the stacked slices [10, h * w * 32]."""
    import torch
    from compression_tpu_torch.models import native_format
    with torch.no_grad():
        y, z = codec._encode(codec._upload(img))
        y_slices, mus, sigmas = codec._compress_slices(y, z)

        def stacked(parts):
            return torch.cat([native_format.to_streams(t) for t in parts])

        sym, idx, _ = codec.em_y._symbols(stacked(y_slices) - stacked(mus),
                                          stacked(sigmas))
        zsym, _, zrow = codec.em_z._symbols_from_bottleneck(
            native_format.to_streams(z))
        csym, cidx, _ = codec.em_y._symbols(
            torch.cat(y_slices) - torch.cat(mus), torch.cat(sigmas))
    zidx = zrow.to(torch.int32)[None].expand_as(zsym).contiguous()
    return (sym.contiguous(), idx.contiguous(), zsym, zidx,
            csym.contiguous(), cidx.contiguous())


def golden_ms2020(fixture, weights, device, fails, cpu_check=False):
    """An ms2020 golden fixture on the card: tables built here equal the
    reference's, compress writes its z and slice strings, its container
    and the native one decode to its uint8 image (a pixel may differ only
    within PIXEL_BOUNDARY of a rounding boundary).  With ``cpu_check`` the
    same model on the CPU writes the same native container and the same
    reconstruction of the fixture's image."""
    import torch
    from compression_tpu_torch.models import ms2020
    from compression_tpu_torch.util.packed_tensors import PackedTensors
    gold = dict(np.load(os.path.join(REPO, "tests", "golden", fixture)))
    state = ms2020.params_from_tf(weights(gold))

    def build(dev):
        model = ms2020.MS2020Model(
            num_filters=int(gold["num_filters"]),
            latent_depth=int(gold["latent_depth"]),
            hyperprior_depth=int(gold["hyperprior_depth"]),
            num_slices=int(gold["num_slices"]),
            max_support_slices=int(gold["max_support_slices"]),
            num_scales=int(gold["num_scales"]),
            ha_widths=tuple(int(w) for w in gold["ha_widths"]),
            hs_widths=tuple(int(w) for w in gold["hs_widths"]),
            slice_widths=tuple(int(w) for w in gold["slice_widths"]))
        model.load_state_dict(state)
        return ms2020.MS2020Codec(model, device=dev)

    codec = build(device)
    ns = int(gold["num_slices"])
    with torch.no_grad():
        my, mz = codec._encode(codec._upload(gold["x_test"]))
    fields = PackedTensors(codec.compress(gold["x_test"])).unpack(
        [np.int32] * 3 + ["bytes"] * (1 + ns))
    native = codec.compress_native(gold["x_test"])
    off, unexplained, margin = pixels_off(
        codec, gold["container"].tobytes(), gold["x_hat_uint8"])
    n_off, n_unexplained, _ = pixels_off(codec, native, gold["x_hat_uint8"])
    result = {
        "tables_equal": bool(
            np.array_equal(codec.em_y.cdf, gold["cdf_y"])
            and np.array_equal(codec.em_y.cdf_offset, gold["cdf_offset_y"])
            and np.array_equal(codec.em_z.cdf, gold["cdf_z"])
            and np.array_equal(codec.em_z.cdf_offset, gold["cdf_offset_z"])),
        "latents_max_abs_err": max(
            float((my.cpu() - torch.as_tensor(gold["y"])).abs().max()),
            float((mz.cpu() - torch.as_tensor(gold["z"])).abs().max())),
        "z_string_equal": fields[3] == golden_strings(gold, "z"),
        "slice_strings_equal": [f[0] for f in fields[4:]]
        == golden_strings(gold, "y"),
        "pixels_off": off, "pixels_off_unexplained": unexplained,
        "native_pixels_off": n_off,
        "native_pixels_off_unexplained": n_unexplained,
        "least_distance_from_boundary": margin}
    ok = (result["tables_equal"] and result["z_string_equal"]
          and result["slice_strings_equal"] and unexplained == 0
          and n_unexplained == 0 and result["latents_max_abs_err"] < 3e-4)
    if cpu_check:
        cpu = build("cpu")
        t0 = time.time()
        cpu_native = cpu.compress_native(gold["x_test"])
        cpu_recon = cpu.reconstruct(gold["x_test"])
        c_off, c_unexplained, _ = pixels_off(codec, cpu_native, cpu_recon)
        result.update(
            cpu_seconds=round(time.time() - t0, 3),
            cpu_native_container_identical=cpu_native == native,
            card_decodes_cpu_container_pixels_off=c_off,
            card_decodes_cpu_container_pixels_off_unexplained=c_unexplained,
            reconstruct_pixels_off=int((cpu_recon != codec.reconstruct(
                gold["x_test"])).sum()))
        ok &= c_unexplained == 0
    log("golden_ms2020", fixture=fixture,
        num_filters=int(gold["num_filters"]), num_slices=ns, **result)
    if not ok:
        fails.append(f"golden_ms2020/{fixture}")


def ms2020_phase(device, images, batch, smi, fails):
    """Phase 4f: ms2020 at its published width (seeded init, its own
    tables, nothing cut) through both containers, the *_many calls and
    reconstruct on the card, with the launch counts reset just before and
    read just after; then K1 at the native stacked slices' launch, K2 at
    one slice's and K6' / K3' at the classic stacked slices' launch against
    their plain versions on what the codec gives them (K1's and K6''s
    bytes the containers'),
    their times beside the byte bound and the chain's floor, the goldens,
    and e2e ms.  Returns the main path's launch counts."""
    import torch
    from compression_tpu_torch.codec import cuda_coder as cc
    from compression_tpu_torch.codec import torch_coder
    from compression_tpu_torch.models import ms2020
    from compression_tpu_torch.util.packed_tensors import PackedTensors
    t0 = time.time()
    codec = ms2020.MS2020Codec(ms2020.MS2020Model(**MS2020_CONFIG, seed=0),
                               device=device)
    m = codec.model
    ytab, ztab = codec.em_y.device_table, codec.em_z.device_table
    log("codec", model="ms2020", seconds=round(time.time() - t0, 3),
        parameters=sum(p.numel() for p in m.parameters()),
        num_filters=m.num_filters, latent_depth=m.latent_depth,
        hyperprior_depth=m.hyperprior_depth, num_slices=m.num_slices,
        max_support_slices=m.max_support_slices,
        y_table=[ytab.num_rows, ytab.max_len],
        z_table=[ztab.num_rows, ztab.max_len])
    ns = m.num_slices

    # The main path.  Predicted launches: native compress 2 x K1 (z, then
    # the 10 slices stacked), native decompress 1 + 10 x K2; classic
    # compress 2 encodes (z, then the 10 slices stacked after the slice
    # loop), each K1 (no escape) or K6', and classic decompress 11
    # one-stream K3' calls, all on the warp kernels.
    reset_counts()
    calls = {"native_compress": 0, "native_decompress": 0,
             "classic_compress": 0, "classic_decompress": 0}
    path_ok, routes = True, {}
    with torch.no_grad():
        for name, img in images.items():
            native = codec.compress_native(img)
            routes["native_encode"] = torch_coder.DISPATCH_LOG["encode"]
            classic = codec.compress(img)
            routes["classic_encode"] = torch_coder.DISPATCH_LOG["encode"]
            recon = codec.reconstruct(img)
            from_native = codec.decompress(native)
            routes["native_decode"] = torch_coder.DISPATCH_LOG[
                "decode_sidecar"]
            from_classic = codec.decompress(classic)
            routes["classic_decode"] = torch_coder.DISPATCH_LOG["decode"]
            for key in calls:
                calls[key] += 1
            exact = bool(np.array_equal(from_native, recon)
                         and np.array_equal(from_classic, recon))
            path_ok &= exact and recon.shape == img.shape and (
                PackedTensors(native).num_tensors == 6 + 3 * ns) and (
                    PackedTensors(classic).num_tensors == 4 + ns)
            pixels = img.shape[0] * img.shape[1]
            log("ms2020_path", image=name, native_bytes=len(native),
                classic_bytes=len(classic),
                native_bits_per_pixel=8 * len(native) / pixels,
                classic_bits_per_pixel=8 * len(classic) / pixels,
                decompress_equals_reconstruct=exact, shape=list(recon.shape))
        many = codec.compress_native_many(batch)
        single = [codec.compress_native(x) for x in batch]
        calls["native_compress"] += 2 * len(batch)
        mixed = many + [codec.compress(batch[1])]
        calls["classic_compress"] += 1
        outs = codec.decompress_native_many(mixed)
        many_ok = many == single and all(
            np.array_equal(a, codec.decompress(c))
            for a, c in zip(outs, mixed))
        calls["native_decompress"] += 2 * len(many)
        calls["classic_decompress"] += 2
    launches, _ = read_counts(())
    expect = {"encode": 2 * calls["native_compress"]
              + 2 * calls["classic_compress"],
              "decode_indexed": (1 + ns) * calls["native_decompress"],
              "decode_gamma": (1 + ns) * calls["classic_decompress"]}
    got = {"encode": launches["encode_indexed"] + launches["encode_gamma"],
           "decode_indexed": launches["decode_indexed"],
           "decode_gamma": launches["decode_gamma"]}
    warp_ok = all(launches[f"{k}/warp"] == launches[k]
                  for k in ("encode_indexed", "encode_gamma",
                            "decode_indexed", "decode_gamma")) and (
        launches["encode_indexed"] >= 2 * calls["native_compress"])
    log("ms2020_many", images=len(batch), containers_equal=many_ok,
        calls=calls, launches=launches, expected=expect, routes=routes)
    if not (path_ok and many_ok and got == expect and warp_ok
            and routes["native_encode"] == "cuda-indexed"
            and routes["classic_encode"] in ("cuda-gamma", "cuda-indexed")
            and routes["native_decode"] == "cuda-indexed"
            and routes["classic_decode"] == "cuda-gamma"):
        fails.append("ms2020_path")

    # K1 at the stacked slices' launch and on z, K2 at one slice's launch,
    # K6' and K3' at the classic compress's stacked launch, against their
    # plain versions on what the codec gives them; K1's and K6''s bytes are
    # the containers'.
    clock = sm_clock_mhz()
    ycdf, ymeta = ytab.indexed_arrays()
    kernel_ms = {}
    for name, img in images.items():
        sym, idx, zsym, zidx, csym, cidx = ms2020_inputs(codec, img)
        c_buf_k, c_len_k, c_intervals, k6_plain, _ = compare_gamma(
            f"ms2020/y_classic_stacked/{name}", ytab, csym, cidx, fails,
            expect_warp=True)
        classic_fields = PackedTensors(codec.compress(img)).unpack(
            [np.int32] * 3 + ["bytes"] * (1 + ns))
        classic_ok = [f[0] for f in classic_fields[4:]] == (
            torch_coder.to_bytes_list(c_buf_k.cpu().numpy(),
                                      c_len_k.cpu().numpy()))
        log("kernels", case=f"ms2020/y_classic_stacked/{name}",
            streams=int(csym.shape[0]), symbols=int(csym.shape[1]),
            k6_bytes_equal_container=classic_ok)
        if not classic_ok:
            fails.append(f"ms2020/y_classic_stacked/{name}/container")
        c_out_size = int(c_buf_k.shape[1])
        k6 = lambda: cc.encode_gamma(csym, cidx, ycdf, ymeta, c_out_size)
        out_size = torch_coder.stream_out_size(sym.shape[1])
        buf, lens = compare_kernels(f"ms2020/y_slices/{name}", ytab, sym, idx,
                                    out_size, fails, expect_warp=True)
        compare_kernels(f"ms2020/z/{name}", ztab, zsym, zidx,
                        torch_coder.stream_out_size(zsym.shape[1]), fails,
                        expect_warp=True)
        native = codec.compress_native(img)
        fields = PackedTensors(native).unpack(
            [np.int32] * 3 + ["bytes", np.int32, np.int32] * (1 + ns))
        slice_strings = [fields[6 + 3 * i] for i in range(ns)]
        container_ok = sum(slice_strings, []) == torch_coder.to_bytes_list(
            buf.cpu().numpy(), lens.cpu().numpy())
        s_y = len(slice_strings[0])
        c_buf, c_lens = (torch.as_tensor(a, device=device)
                         for a in torch_coder.from_bytes_list(
                             slice_strings[0]))
        idx0 = idx[:s_y].contiguous()
        took = []
        chosen, both = decode_variants("decode_indexed", ytab, took)
        _, san, dec_ok, k2_plain = check_decode(
            "decode_indexed", chosen, cc.decode_indexed_plain,
            (c_buf, c_lens, idx0, ycdf, ymeta), both)
        log("kernels", case=f"ms2020/one_slice/{name}", streams=s_y,
            symbols=int(sym.shape[1]), container_width=int(c_buf.shape[1]),
            k1_bytes_equal_container=container_ok,
            decode_identical_wrapper_and_both_kernels=dec_ok,
            decode_wrapper_took=took[0], sanity_all=bool(san.all()))
        if not (container_ok and dec_ok and bool(san.all())
                and took[0] == "warp"):
            fails.append(f"ms2020/one_slice/{name}")
        n = int(sym.shape[1])
        out_p, len_p = torch.empty_like(buf), torch.empty_like(lens)
        k1 = lambda: cc.encode_indexed(sym, idx, ycdf, ymeta, out_size)
        k2 = lambda: cc.decode_indexed(c_buf, c_lens, idx0, ycdf, ymeta,
                                       ytab.warp_arrays())
        kernel_ms[name] = {
            f"encode_indexed@{sym.shape[0]}x{n}": {
                "ms_events": [cuda_ms(k1, 20) for _ in range(2)],
                "ms_graph": [graph_ms(k1) for _ in range(2)],
                "plain_ms": cuda_ms(lambda: cc.encode_indexed_plain(
                    sym, idx, ycdf, ymeta, out_p, len_p), 1, warm=False),
                "bound_ms": encode_bound(*sym.shape, ycdf, ymeta,
                                         out_size)[0],
                "chain_floor_ms": scan_floor_ms(n, clock)},
            f"decode_indexed@{s_y}x{n}": {
                "ms_events": [cuda_ms(k2, 20) for _ in range(2)],
                "ms_graph": [graph_ms(k2) for _ in range(2)],
                "plain_ms": k2_plain,
                "bound_ms": decode_bound(c_lens, n, ycdf, ymeta)[0],
                "chain_floor_ms": warp_floor_ms(n, ytab.max_len, clock)},
            f"encode_gamma@{csym.shape[0]}x{csym.shape[1]}": {
                "ms_events": [cuda_ms(k6, 20) for _ in range(2)],
                "ms_graph": [graph_ms(k6) for _ in range(2)],
                "plain_ms": k6_plain,
                "bound_ms": encode_bound(*csym.shape, ycdf, ymeta,
                                         c_out_size, c_intervals)[0],
                "chain_floor_ms": scan_floor_ms(int(cc.interval_counts(
                    csym, cidx, ymeta)[0].sum(1).max()), clock)}}
    golden_ms2020("golden_ms2020.npz", lambda gold: gold, device, fails)
    golden_ms2020("golden_ms2020_full.npz", synthesized_weights, device,
                  fails, cpu_check=True)
    e2e = {}
    for name, img in images.items():
        e2e[f"ms2020/native/{name}"] = e2e_times(codec.compress_native,
                                                 codec.decompress, img)
        e2e[f"ms2020/classic/{name}"] = e2e_times(codec.compress,
                                                  codec.decompress, img)
    log("ms2020_times", kernel_ms=kernel_ms, end_to_end=e2e,
        sm_clock_mhz=clock, card=smi)
    return launches, codec


def hific_inputs(codec, img):
    """What HiFiC's codec hands the coder for one image, y about the
    means: the native launches' (symbols, indexes) of y [h * k, n] and of
    z, and the classic streams' [1, N]."""
    import torch
    from compression_tpu_torch.models import native_format
    with torch.no_grad():
        y, z, idx, means = codec._encode(codec._upload(img))
        out = {}
        for kind, to in (("native", native_format.to_streams),
                         ("classic", lambda t: t)):
            ysym, yidx, _ = codec.em._symbols(to(y - means), to(idx))
            zsym, _, zrow = codec.side_em._symbols_from_bottleneck(to(z))
            zidx = zrow.to(torch.int32)[None].expand_as(zsym)
            out[kind] = tuple(t.contiguous() for t in (ysym, yidx, zsym,
                                                       zidx))
    return out


def hific_phase(device, images, batch, smi, fails):
    """Phase 4h: HiFiC at get_config("hific") (seeded init, its own
    tables, nothing cut) through both containers, the *_many calls and
    reconstruct on the card, with the launch counts reset just before and
    read just after (each native container decompressed twice: the images
    equal, and ``hific.GEMM_UPSAMPLES`` counts ``num_down`` + 1 a
    decompress); then K1 and K2 at the native launches of y and z against
    their plain versions on what the codec gives them (K1's bytes the
    container's, K2 on the container's own bytes), timed from a CUDA graph
    beside the byte bound and the chain's floor; the classic y and z
    streams against the host C coder in both directions; e2e ms of both
    containers with K3''s share of the classic decompress.  Returns the
    main path's launch counts."""
    import torch
    from compression_tpu_torch.codec import cuda_coder as cc
    from compression_tpu_torch.codec import host, torch_coder
    from compression_tpu_torch.models import hific
    from compression_tpu_torch.util.packed_tensors import PackedTensors
    t0 = time.time()
    codec = hific.HiFiCCodec(hific.HiFiCModel(hific.get_config("hific"),
                                              seed=0), device=device)
    m = codec.model
    ytab, ztab = codec.em.device_table, codec.side_em.device_table
    log("codec", model="hific", seconds=round(time.time() - t0, 3),
        parameters=sum(p.numel() for p in m.parameters()),
        config={k: getattr(m.cfg, k) for k in (
            "num_down", "num_filters_base", "num_filters_bottleneck",
            "num_residual_blocks", "hyper_filters")},
        y_table=[ytab.num_rows, ytab.max_len],
        z_table=[ztab.num_rows, ztab.max_len])

    # The main path.  Predicted launches: native compress 2 x K1 (y, z),
    # native decompress 2 x K2 (z, then y); classic compress 2 encodes (K1
    # or K6'), classic decompress 2 x K3'; all on the warp kernels.
    reset_counts()
    calls = {"native_compress": 0, "native_decompress": 0,
             "classic_compress": 0, "classic_decompress": 0}
    path_ok, routes = True, {}
    with torch.no_grad():
        for name, img in images.items():
            native = codec.compress_native(img)
            routes["native_encode"] = torch_coder.DISPATCH_LOG["encode"]
            classic = codec.compress(img)
            routes["classic_encode"] = torch_coder.DISPATCH_LOG["encode"]
            recon = codec.reconstruct(img)
            upsamples = hific.GEMM_UPSAMPLES
            from_native = codec.decompress(native)
            upsamples = hific.GEMM_UPSAMPLES - upsamples
            routes["native_decode"] = torch_coder.DISPATCH_LOG[
                "decode_sidecar"]
            again = codec.decompress(native)
            from_classic = codec.decompress(classic)
            routes["classic_decode"] = torch_coder.DISPATCH_LOG["decode"]
            for key in calls:
                calls[key] += 1
            calls["native_decompress"] += 1
            repeat = bool(np.array_equal(again, from_native))
            exact = bool(np.array_equal(from_native, recon)
                         and np.array_equal(from_classic, recon))
            path_ok &= exact and repeat and recon.shape == img.shape and (
                PackedTensors(native).num_tensors == 9) and (
                    PackedTensors(classic).num_tensors == 5) and (
                        upsamples == m.cfg.num_down + 1)
            pixels = img.shape[0] * img.shape[1]
            log("hific_path", image=name, native_bytes=len(native),
                classic_bytes=len(classic),
                native_bits_per_pixel=8 * len(native) / pixels,
                classic_bits_per_pixel=8 * len(classic) / pixels,
                decompress_equals_reconstruct=exact,
                decompress_repeats_exactly=repeat,
                gemm_upsamples_a_decompress=upsamples, shape=list(recon.shape))
        many = codec.compress_native_many(batch)
        single = [codec.compress_native(x) for x in batch]
        calls["native_compress"] += 2 * len(batch)
        mixed = many + [codec.compress(batch[1])]
        calls["classic_compress"] += 1
        outs = codec.decompress_native_many(mixed)
        many_ok = many == single and all(
            np.array_equal(a, codec.decompress(c))
            for a, c in zip(outs, mixed))
        calls["native_decompress"] += 2 * len(many)
        calls["classic_decompress"] += 2
    launches, _ = read_counts(())
    expect = {"encode": 2 * (calls["native_compress"]
                             + calls["classic_compress"]),
              "decode_indexed": 2 * calls["native_decompress"],
              "decode_gamma": 2 * calls["classic_decompress"]}
    got = {"encode": launches["encode_indexed"] + launches["encode_gamma"],
           "decode_indexed": launches["decode_indexed"],
           "decode_gamma": launches["decode_gamma"]}
    warp_ok = all(launches[f"{k}/warp"] == launches[k]
                  for k in ("encode_indexed", "encode_gamma",
                            "decode_indexed", "decode_gamma")) and (
        launches["encode_indexed"] >= 2 * calls["native_compress"])
    log("hific_many", images=len(batch), containers_equal=many_ok,
        calls=calls, launches=launches, expected=expect, routes=routes)
    if not (path_ok and many_ok and got == expect and warp_ok
            and routes["native_encode"] == "cuda-indexed"
            and routes["classic_encode"] in ("cuda-gamma", "cuda-indexed")
            and routes["native_decode"] == "cuda-indexed"
            and routes["classic_decode"] == "cuda-gamma"):
        fails.append("hific_path")

    # K1 and K2 at the native launches against their plain versions; the
    # classic streams against the host C coder.
    clock = sm_clock_mhz()
    kernel_ms, host_check, k3_ms = {}, {}, {}
    for name, img in images.items():
        inputs = hific_inputs(codec, img)
        native = PackedTensors(codec.compress_native(img)).unpack(
            ["bytes", "bytes", np.int32, np.int32, np.int32,
             np.int32, np.int32, np.int32, np.int32])
        classic = PackedTensors(codec.compress(img)).unpack(
            ["bytes", "bytes", np.int32, np.int32, np.int32])
        ysym, yidx, zsym, zidx = inputs["native"]
        for part, tab, sym, idx, strings in (
                ("y", ytab, ysym, yidx, native[0]),
                ("z", ztab, zsym, zidx, native[1])):
            cdf, meta = tab.indexed_arrays()
            n = int(sym.shape[1])
            out_size = torch_coder.stream_out_size(n)
            buf, lens = compare_kernels(f"hific/{part}_native/{name}", tab,
                                        sym, idx, out_size, fails,
                                        expect_warp=True)
            container_ok = strings == torch_coder.to_bytes_list(
                buf.cpu().numpy(), lens.cpu().numpy())
            c_buf, c_lens = (torch.as_tensor(a, device=device)
                             for a in torch_coder.from_bytes_list(strings))
            took = []
            chosen, both = decode_variants("decode_indexed", tab, took)
            _, san, dec_ok, k2_plain = check_decode(
                "decode_indexed", chosen, cc.decode_indexed_plain,
                (c_buf, c_lens, idx, cdf, meta), both)
            log("kernels", case=f"hific/{part}_container/{name}",
                streams=int(sym.shape[0]), symbols=n,
                container_width=int(c_buf.shape[1]),
                k1_bytes_equal_container=container_ok,
                decode_identical_wrapper_and_both_kernels=dec_ok,
                decode_wrapper_took=took[0], sanity_all=bool(san.all()))
            if not (container_ok and dec_ok and bool(san.all())
                    and took[0] == "warp"):
                fails.append(f"hific/{part}_container/{name}")
            out_p, len_p = torch.empty_like(buf), torch.empty_like(lens)
            k1 = lambda: cc.encode_indexed(sym, idx, cdf, meta, out_size)
            k2 = lambda: cc.decode_indexed(c_buf, c_lens, idx, cdf, meta,
                                           tab.warp_arrays())
            kernel_ms[f"{part}/{name}"] = {
                f"encode_indexed@{sym.shape[0]}x{n}": {
                    "ms_graph": [graph_ms(k1) for _ in range(2)],
                    "plain_ms": cuda_ms(lambda: cc.encode_indexed_plain(
                        sym, idx, cdf, meta, out_p, len_p), 1, warm=False),
                    "bound_ms": encode_bound(*sym.shape, cdf, meta,
                                             out_size)[0],
                    "chain_floor_ms": scan_floor_ms(n, clock)},
                f"decode_indexed@{sym.shape[0]}x{n}": {
                    "ms_graph": [graph_ms(k2) for _ in range(2)],
                    "plain_ms": k2_plain,
                    "bound_ms": decode_bound(c_lens, n, cdf, meta)[0],
                    "chain_floor_ms": warp_floor_ms(n, tab.max_len, clock)}}
        # The classic streams: the host C coder writes the container's
        # bytes from the same symbols and indexes and decodes them to the
        # card's symbols; K3' on them, timed by events.  y scaled by 6
        # escapes the table: the card's encode (K6') against the host's.
        csym, cidx, czsym, czidx = inputs["classic"]
        with torch.no_grad():
            y, _, idx_c, means = codec._encode(codec._upload(img))
            ssym, sidx, _ = codec.em._symbols(6.0 * (y - means), idx_c)
            buf6, lens6 = torch_coder.encode_streams(ssym, ytab, sidx)
            scaled = torch_coder.to_bytes_list(buf6.cpu().numpy(),
                                               lens6.cpu().numpy())
            scaled_route = torch_coder.DISPATCH_LOG["encode"]
        for part, tab, sym, idx, strings in (
                ("y", ytab, csym, cidx, classic[0]),
                ("z", ztab, czsym, czidx, classic[1]),
                ("y_scaled", ytab, ssym, sidx, scaled)):
            n = int(sym.shape[1])
            c_buf, c_lens = (torch.as_tensor(a, device=device)
                             for a in torch_coder.from_bytes_list(strings))
            card_out, card_ok = torch_coder.decode_streams(c_buf, c_lens, n,
                                                           tab, idx)
            route = torch_coder.DISPATCH_LOG["decode"]
            sym_np, idx_np = sym.cpu().numpy(), idx.cpu().numpy()
            t0 = time.perf_counter()
            h_strings = host.encode_streams(sym_np, tab.host, idx_np)
            t1 = time.perf_counter()
            h_out, h_ok = host.decode_streams(strings, n, tab.host, idx_np)
            t2 = time.perf_counter()
            escapes = int(cc.interval_counts(sym, idx, tab.indexed_arrays()[1]
                                             )[1].sum())
            same = {"host_bytes_equal_container": h_strings == strings,
                    "host_symbols_equal_card": bool(np.array_equal(
                        h_out, card_out.cpu().numpy())),
                    "host_sanity_equal_card": bool(np.array_equal(
                        h_ok, card_ok.cpu().numpy())),
                    "round_trip": bool(np.array_equal(h_out, sym_np)
                                       and h_ok.all())}
            if part == "y_scaled":  # K6' on the card
                same["escapes_encoded_by_k6"] = escapes > 0 and (
                    scaled_route == "cuda-gamma")
            cdf, meta = tab.indexed_arrays()
            k3_ms[f"{part}/{name}"] = cuda_ms(lambda: cc.decode_gamma(
                c_buf, c_lens, idx, cdf, meta, tab.warp_arrays()), 3)
            host_check[f"{part}/{name}"] = dict(
                symbols=n, escapes=escapes, coded_bytes=len(strings[0]),
                card_decode_route=route,
                host_encode_ms=(t1 - t0) * 1e3,
                host_decode_ms=(t2 - t1) * 1e3,
                k3_ms=k3_ms[f"{part}/{name}"], **same)
            if not (all(same.values()) and route == "cuda-gamma"):
                fails.append(f"hific/{part}_classic_host/{name}")
    # The transforms alone (CUDA events), with their float operations as
    # torch's flop counter counts them.
    from torch.utils.flop_counter import FlopCounterMode
    transforms = {}
    for name, img in images.items():
        with torch.no_grad():
            x = codec._upload(img).to(torch.float32)[None]
            y, z, _, means = codec._encode(codec._upload(img))
            y_hat = codec.em.quantize(y, means)
            z_hat = codec.side_em.quantize(z)
            for label, fn in (("encode", lambda: m.encode(x)),
                              ("hyper_decode", lambda: m.hyper_decode(z_hat)),
                              ("decode", lambda: m.decode(y_hat))):
                counter = FlopCounterMode(display=False)
                with counter:
                    fn()
                ms = cuda_ms(fn, 5)
                flops = counter.get_total_flops()
                transforms[f"{label}/{name}"] = {
                    "ms": ms, "gflop": flops / 1e9,
                    "tflop_per_s": flops / ms / 1e9}
    e2e = {}
    for name, img in images.items():
        e2e[f"hific/native/{name}"] = e2e_times(codec.compress_native,
                                                codec.decompress, img)
        classic = e2e_times(codec.compress, codec.decompress, img)
        classic["k3_share_of_decompress"] = (
            k3_ms[f"y/{name}"] + k3_ms[f"z/{name}"]) / classic[
                "decompress_ms_median"]
        e2e[f"hific/classic/{name}"] = classic
    log("hific_times", kernel_ms=kernel_ms, classic_host=host_check,
        transforms=transforms, end_to_end=e2e, sm_clock_mhz=clock, card=smi)
    del codec
    torch.cuda.empty_cache()
    return launches


def tfci_round_trip(root, name, img):
    """``tfci.main compress`` then ``decompress`` of ``img`` (as .npy)
    through the registry ``root`` on the card.  The container must equal
    the loaded codec's compress, the decoded image its reconstruct, with
    one K3' a latent and one encode (K1 or K6') a latent (ms2020's ten
    slices stacked in one), all warp.  Returns (the
    log's fields, the launch counts of the two subcommands)."""
    import torch
    from compression_tpu_torch.models import tfci
    src = os.path.join(root, "img.npy")
    np.save(src, img)
    out = os.path.join(root, f"{name}.tfci")
    dec = os.path.join(root, f"{name}.npy")
    reset_counts()
    ms = {}
    for sub, argv in (("compress", ["compress", name, src, out]),
                      ("decompress", ["decompress", out, dec])):
        t0 = time.perf_counter()
        tfci.main(["--model_path", root, *argv])
        torch.cuda.synchronize()
        ms[f"{sub}_ms"] = (time.perf_counter() - t0) * 1e3
    launches, routes = read_counts(("encode", "decode"))
    codec = tfci._load_codec(root, name, torch.device(DEVICE))
    with open(out, "rb") as f:
        container = f.read()
    latents = {"bls2017": 1, "bmshj2018": 2, "hific": 2, "ms2020": 11}[name]
    coder_encodes = {"bls2017": 1, "bmshj2018": 2, "hific": 2,
                     "ms2020": 2}[name]
    encodes = launches["encode_indexed"] + launches["encode_gamma"]
    ok = {"container_equals_compress": container == codec.compress(img),
          "decoded_equals_reconstruct": bool(np.array_equal(
              np.load(dec), codec.reconstruct(img))),
          "launches_ok": encodes == coder_encodes
          and launches["decode_gamma"] == latents,
          "all_warp": all(launches[f"{k}/warp"] == launches[k] for k in (
              "encode_indexed", "encode_gamma", "decode_gamma"))}
    del codec
    torch.cuda.empty_cache()
    fields = dict(model=name, container_bytes=len(container),
                  latents=latents, launches=launches, routes=routes, **ms,
                  **ok)
    return fields, launches


def tfci_phase(device, img, smi, fails, hific_result):
    """Phase 7t: the generic command line (models/tfci.py, models/cli.py)
    at each model's CLI defaults on ``img``.  ``<model>.main(["train",
    "--steps", "2"])`` writes bls2017 (128 filters), bmshj2018 (128, 64
    scales) and ms2020 (192, latent 320, hyper 192, 10 slices) into a
    registry under a temporary directory; each then round-trips through
    ``tfci.main compress`` / ``decompress`` (``tfci_round_trip``; HiFiC's
    ran inside phase 7h's directory, ``hific_result``).  A --target_bpp
    search over three bmshj2018 variants (the trained weights with the
    last analysis layer scaled by 0.5, 2 and 8) must pick the second,
    whose rate the target lies just above.  Returns the launch counts of
    the round trips and the search."""
    import tempfile

    import torch
    from compression_tpu_torch.models import bls2017, bmshj2018, ms2020, tfci
    from compression_tpu_torch.util import checkpoint

    total = {k: hific_result["launch_counts"][k]
             for k in hific_result["launch_counts"]}
    results = [hific_result["fields"]]
    with tempfile.TemporaryDirectory(dir=REPO) as root:
        for name, module in (("bls2017", bls2017), ("bmshj2018", bmshj2018),
                             ("ms2020", ms2020)):
            t0 = time.perf_counter()
            module.main(["train", "--model_path", os.path.join(root, name),
                         "--steps", "2"])
            train_s = time.perf_counter() - t0
            fields, launches = tfci_round_trip(root, name, img)
            results.append(dict(fields, train_seconds=train_s))
            for k in total:
                total[k] += launches[k]
        # --target_bpp over three variants of the trained bmshj2018.
        payload, config = checkpoint.load_checkpoint(
            os.path.join(root, "bmshj2018"))
        vroot = os.path.join(root, "variants")
        containers = []
        for i, factor in enumerate((0.5, 2.0, 8.0)):
            params = dict(payload["params"])
            key = "analysis.layer_3.kernel_rdft"
            params[key] = params[key] * factor
            path = os.path.join(vroot, f"bmshj2018-{i + 1}")
            checkpoint.save_checkpoint(path, params, config=config)
            codec = tfci._load_codec(vroot, f"bmshj2018-{i + 1}",
                                     torch.device(DEVICE))
            containers.append(codec.compress(img))
            del codec
        pixels = img.shape[0] * img.shape[1]
        rates = [len(c) * 8 / pixels for c in containers]
        target = (rates[1] + rates[2]) / 2
        src, out = os.path.join(root, "img.npy"), os.path.join(root, "s.tfci")
        reset_counts()
        t0 = time.perf_counter()
        tfci.main(["--model_path", vroot, "compress", "--target_bpp",
                   str(target), "bmshj2018", src, out])
        torch.cuda.synchronize()
        search_ms = (time.perf_counter() - t0) * 1e3
        launches, _ = read_counts(())
        for k in total:
            total[k] += launches[k]
        with open(out, "rb") as f:
            picked = f.read()
        search = {"rates_bpp": rates, "target_bpp": target,
                  "rates_rise": rates == sorted(rates)
                  and len(set(rates)) == 3,
                  "picked_variant": [i + 1 for i, c in enumerate(containers)
                                     if c == picked],
                  "search_ms": search_ms, "launches": launches}
    search["ok"] = search["rates_rise"] and search["picked_variant"] == [2]
    for fields in results:
        log("tfci", card=smi, **fields)
        if not all(fields[k] for k in (
                "container_equals_compress", "decoded_equals_reconstruct",
                "launches_ok", "all_warp")):
            fails.append(f"tfci/{fields['model']}")
    log("tfci", part="target_bpp", card=smi, **search)
    if not search["ok"]:
        fails.append("tfci/target_bpp")
    torch.cuda.empty_cache()
    return total


def universal_phase(device, smi, fails, shape=UNIVERSAL_SHAPE, runs=10):
    """Phase 7u: the universal entropy models (entropy_models/universal.py)
    at the size of bmshj2018's y for a batch of 512x512 images, ``shape``
    with coding_rank 3 (one stream an image): tests/universal_cases.py's
    UniversalBatchedEntropyModel over a per-channel NoisyNormal (192
    channels x 15 dither levels = 2880 rows) and UniversalIndexedEntropyModel
    over NoisyNormal on bmshj2018's 64 scales (960 rows), each on latents
    inside the tables' supports (no escape: K1) and past them (K6').  The
    bytes must equal the host C coder's (codec/host.py) on the same
    symbols and rows, the host's decode give the symbols back, and
    decompress(compress(x)) equal the dithered quantization; one encode
    and one K3' a call, warp.  The median compress and decompress ms of
    ``runs`` after a warm-up, on the host clock around work that ends in
    torch.cuda.synchronize().  Returns the launch counts of the first
    compress and decompress of each case."""
    import torch
    from compression_tpu_torch.codec import cuda_coder as cc
    from compression_tpu_torch.codec import host, torch_coder

    cases = tests_module("universal_cases")
    total = None
    models = {"batched": cases.batched_model(device),
              "indexed": cases.indexed_model(device)}
    for kind, em in models.items():
        table = em.device_table
        cdf, meta = table.indexed_arrays()
        encode_table = 4 * (cdf.numel() + meta.numel())
        decode_table = 2 * table.warp_arrays().numel()
        for escapes in (False, True):
            y_b, y_i, idx = cases.latents(shape, escapes)
            if kind == "batched":
                x = torch.tensor(y_b, device=device)
                args, bshape = (), shape[1:-1]
            else:
                x = torch.tensor(y_i, device=device)
                args = (torch.tensor(idx, device=device),)
                bshape = args[0]

            def compress():
                return em.compress(x, *args)

            def decompress(buf, lens):
                return em.decompress(buf, bshape, lengths=lens)

            reset_counts()
            buf, lens = compress()
            out = decompress(buf, lens)
            launches, routes = read_counts(("encode", "decode"))
            # The dithered quantization, by the eval-mode call on the CPU
            # (the batched model's prior lives there, with its tables).
            expect = em(x.cpu(), *[a.cpu() for a in args],
                        training=False)[0]
            symbols, rows, _ = em._symbols(x, *args)
            sym_np, rows_np = symbols.cpu().numpy(), rows.cpu().numpy()
            card = torch_coder.to_bytes_list(buf.cpu().numpy(),
                                             lens.cpu().numpy())
            t0 = time.perf_counter()
            mine = host.encode_streams(sym_np, table.host, rows_np)
            host_encode_ms = (time.perf_counter() - t0) * 1e3
            back, sanity = host.decode_streams(mine, sym_np.shape[1],
                                               table.host, rows_np)
            times = []
            for i in range(runs + 1):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                b, ln = compress()
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                decompress(b, ln)
                torch.cuda.synchronize()
                if i:
                    times.append((t1 - t0, time.perf_counter() - t1))
            esc = int(escape_count(symbols, rows, meta))
            took = "encode_gamma" if escapes else "encode_indexed"
            # The two kernels alone, by events, on this call's inputs.
            sym_c, rows_c = symbols.contiguous(), rows.contiguous()
            kernel_ms = {
                took: cuda_ms(lambda: getattr(cc, took)(
                    sym_c, rows_c, cdf, meta, buf.shape[-1]), 3),
                "decode_gamma": cuda_ms(lambda: cc.decode_gamma(
                    buf, lens, rows_c, cdf, meta, table.warp_arrays()), 3)}
            ok = {"bytes_equal_host": card == mine,
                  "host_decodes_symbols": bool(
                      np.array_equal(back, sym_np) and sanity.all()),
                  "round_trip_equals_quantize": bool(torch.equal(
                      out.cpu(), expect)),
                  "escapes_as_asked": (esc > 0) == escapes,
                  "kernels_ok": launches[took] == 1
                  and launches[f"{took}/warp"] == 1
                  and launches["decode_gamma"] == 1
                  and launches["decode_gamma/warp"] == 1
                  and launches["encode_indexed"] + launches["encode_gamma"]
                  == 1}
            log("universal", model=kind, escapes=escapes, card=smi,
                shape=list(shape), streams=int(symbols.shape[0]),
                symbols=int(symbols.shape[1]), escaped_symbols=esc,
                table_rows=table.num_rows, table_max_len=table.max_len,
                encode_table_bytes=encode_table,
                encode_table_in_shared_memory=encode_table <= 200 * 1024,
                decode_table_bytes=decode_table,
                decode_table_in_shared_memory=decode_table
                + 8 * 1024 <= 227 * 1024,
                container_bytes=int(lens.sum()),
                compress_ms_median=float(np.median([t[0] for t in times]))
                * 1e3,
                decompress_ms_median=float(np.median([t[1] for t in times]))
                * 1e3,
                host_encode_ms=host_encode_ms, encode_kernel=took,
                kernel_ms=kernel_ms, launches=launches, routes=routes, **ok)
            if not all(ok.values()):
                fails.append(f"universal/{kind}/escapes={escapes}")
            if total is None:
                total = dict(launches)
            else:
                for k in total:
                    total[k] += launches[k]
            del buf, lens, out, expect, symbols, rows
    del models
    torch.cuda.empty_cache()
    return total


LVAC_FILTERS, LVAC_BATCH, LVAC_FRAME = 64, 8, 1024
TOY_POINTS, TOY_LATENT, TOY_BATCH, TOY_CODEBOOK = 1024, 10, 512, 64
STOCHASTIC_ROUND_SIZE = 1 << 20


def _grad_errors(card, cpu):
    """Largest |card - cpu| of each parameter's gradient over the CPU's
    largest magnitude (the error itself where that is 0): (worst, name)."""
    errs = {}
    cpu_grads = dict(cpu.named_parameters())
    for name, p in card.named_parameters():
        g_card = p.grad.detach().cpu() if p.grad is not None else None
        g_cpu = cpu_grads[name].grad
        if g_card is None and g_cpu is None:
            continue
        g_card = g_cpu * 0 if g_card is None else g_card
        g_cpu = g_card * 0 if g_cpu is None else g_cpu
        scale = float(g_cpu.abs().max())
        errs[name] = float((g_card - g_cpu).abs().max()) / (
            scale if scale > 0 else 1.0)
    worst = max(errs, key=errs.get)
    return errs[worst], worst


def _steps_on_card(step, batches, steps):
    """``steps`` synchronized train steps timed by CUDA events: (losses,
    step ms)."""
    import torch
    losses, step_ms = [], []
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for i in range(steps):
        batch = batches(i)
        torch.cuda.synchronize()
        start.record()
        metrics = step(batch)
        end.record()
        torch.cuda.synchronize()
        step_ms.append(start.elapsed_time(end))
        losses.append(float(metrics["loss"]))
    return losses, step_ms


def small_models_phase(device, smi, fails, steps=30):
    """Phase 7s: the general layers, lvac, the toy sources, the stochastic
    round and the table-free entropy models on the card against the CPU
    (TF32 off):

      * signal_conv at ranks 1-3 in every padding mode, with rational
        strides and channel-separable kernels, and GDN with general and
        trainable exponents: the card's outputs within 1e-4 of the CPU's
        largest output on the same inputs;
      * lvac at its published width (64 filters, batch 8 of 1024-sample
        frames): one train step's gradients from the same weights, batch
        and noise within 1e-3 of the CPU's, then ``steps`` Adam steps at
        train()'s 1e-4 on fresh sine_batches batches, as train() feeds
        them, whose loss must be finite and fall (the mean of the last 5
        below that of the first 5); the median step ms of steps 4-30 by
        CUDA events;
      * the toy sources at train_ntc's defaults (batch 512, hidden 100,
        Adam 1e-3) on the sawbridge at 1024 index points with 10 latent
        dimensions: NTC with the deep prior and with gmm-3, and VECVQ with
        64 codewords; one step against the CPU as above, then ``steps`` on
        the card on fresh batches, the loss finite and falling; NTC's
        quantize_codebook on the card against the CPU's;
      * the stochastic round of 1M elements from given 32-bit draws: the
        card's integers equal the CPU's; its ms by CUDA events;
      * PowerLaw and Laplace: penalty (within 1e-6 relative: the card sums
        in another order) and quantization (exactly) on the card against
        the CPU; compress of lvac's latent on the host round-trips, with
        the bytes of the Python plain version; its host ms; compress of the
        CUDA tensor raises.

    No coder kernel lies on these paths: the launch counts are reset
    before the phase and must read 0 after it."""
    import torch
    from compression_tpu_torch.entropy_models.laplace import (
        LaplaceEntropyModel)
    from compression_tpu_torch.entropy_models.power_law import (
        PowerLawEntropyModel)
    from compression_tpu_torch.layers.gdn import GDN
    from compression_tpu_torch.layers.signal_conv import signal_conv
    from compression_tpu_torch.models import lvac
    from compression_tpu_torch.models import toy_sources as ts
    from compression_tpu_torch.ops import quantization
    from compression_tpu_torch.ops import run_length

    reset_counts()
    flags = dict(card=smi, tf32_cudnn=torch.backends.cudnn.allow_tf32,
                 tf32_matmul=torch.backends.cuda.matmul.allow_tf32)
    rng = np.random.RandomState(15)

    # Layers.
    conv_cases = []
    shapes = {1: (2, 8, 256), 2: (2, 8, 32, 31), 3: (2, 4, 9, 12, 11)}
    for rank in (1, 2, 3):
        for padding in ("valid", "same_zeros", "same_reflect"):
            for corr, down, up, separable in ((True, 2, 1, False),
                                              (False, 1, 2, False),
                                              (True, 2, 3, False),
                                              (False, 3, 2, True)):
                conv_cases.append((rank, padding, corr, down, up, separable))
    conv_err = 0.0
    for rank, padding, corr, down, up, separable in conv_cases:
        x = torch.tensor(rng.normal(0, 1, shapes[rank]), dtype=torch.float32)
        cin = x.shape[1]
        kshape = (5, 4, 3)[:rank] + ((1, cin * 2) if separable else (cin, 6))
        k = torch.tensor(rng.normal(0, 1, kshape), dtype=torch.float32)
        kw = dict(corr=corr, strides_down=down, strides_up=up,
                  padding=padding, channel_separable=separable)
        want = signal_conv(x, k, **kw)
        got = signal_conv(x.to(device), k.to(device), **kw).cpu()
        conv_err = max(conv_err, float((got - want).abs().max())
                       / float(want.abs().max()))
    gdn_err = 0.0
    gdn_cases = [(alpha, eps, rank)
                 for alpha, eps in ((1.5, 0.7), (None, None), (2.0, 0.5),
                                    (1.0, 1.0))
                 for rank in (1, 2, 3)]
    for alpha, eps, rank in gdn_cases:
        layer = GDN(8, inverse=rank == 2, rectify=rank == 3, alpha=alpha,
                    epsilon=eps)
        with torch.no_grad():
            for p in layer.parameters():
                p.add_(torch.tensor(rng.uniform(0, 0.3, tuple(p.shape)),
                                    dtype=torch.float32))
        x = torch.tensor(rng.normal(0, 2, (2, 8) + (17, 9, 5)[:rank]),
                         dtype=torch.float32)
        want = layer(x).detach()
        got = layer.to(device)(x.to(device)).detach().cpu()
        gdn_err = max(gdn_err, float((got - want).abs().max())
                      / float(want.abs().max()))
    ok = {"signal_conv_within_1e-4": conv_err <= 1e-4,
          "gdn_within_1e-4": gdn_err <= 1e-4}
    log("layers", signal_conv_cases=len(conv_cases),
        signal_conv_max_rel_err=conv_err, gdn_cases=len(gdn_cases),
        gdn_max_rel_err=gdn_err, **flags, **ok)
    if not all(ok.values()):
        fails.append("small_models/layers")

    # lvac at its published width.
    cpu = lvac.LVACModel(num_filters=LVAC_FILTERS, seed=0)
    card = lvac.LVACModel(num_filters=LVAC_FILTERS, seed=0).to(device)
    batch = next(lvac.sine_batches(LVAC_BATCH, LVAC_FRAME, 1))
    gen = torch.Generator(device=device).manual_seed(7)
    u = torch.empty((LVAC_BATCH, LVAC_FRAME // 16, LVAC_FILTERS),
                    device=device).uniform_(-0.5, 0.5, generator=gen)
    x_card = torch.tensor(batch, device=device)
    card_metrics = [t.item() for t in card(x_card, u=u)]
    card(x_card, u=u)[0].backward()
    cpu(torch.tensor(batch), u=u.cpu())[0].backward()
    cpu_metrics = [t.item() for t in cpu(torch.tensor(batch), u=u.cpu())]
    grad_err, worst = _grad_errors(card, cpu)
    card.zero_grad()
    step = lvac.make_train_step(
        card, torch.optim.Adam(card.parameters(), lr=1e-4))
    # train()'s traffic: a fresh sine_batches batch each step, on the card.
    frames = lvac.sine_batches(LVAC_BATCH, LVAC_FRAME, 2)
    losses, step_ms = _steps_on_card(
        lambda batch_: step(batch_, generator=gen),
        lambda i: torch.as_tensor(next(frames), device=device), steps)
    metric_err = max(abs(a - b) / abs(b)
                     for a, b in zip(card_metrics, cpu_metrics))
    with torch.no_grad():
        latent = card.analysis(x_card)
    ok = {"grads_within_1e-3": grad_err <= 1e-3,
          "metrics_within_1e-3": metric_err <= 1e-3,
          "finite": bool(np.isfinite(losses).all()),
          "loss_fell": float(np.mean(losses[-5:]))
          < float(np.mean(losses[:5]))}
    log("lvac", num_filters=LVAC_FILTERS, batch=[LVAC_BATCH, LVAC_FRAME, 1],
        learning_rate=1e-4, parameters=sum(p.numel()
                                           for p in card.parameters()),
        card_loss_bps_mse=card_metrics, cpu_loss_bps_mse=cpu_metrics,
        metric_rel_err=metric_err, max_grad_err=grad_err,
        max_grad_err_param=worst, losses=losses, step_ms=step_ms,
        step_ms_median_4_to_30=float(np.median(step_ms[3:])), **flags, **ok)
    if not all(ok.values()):
        fails.append("small_models/lvac")
    del cpu, card, step

    # The toy sources at train_ntc's defaults.
    points = torch.linspace(0, 1, TOY_POINTS + 1)[:-1]
    points_card = points.to(device)
    makers = {
        "ntc_deep": lambda: ts.NTCModel(TOY_POINTS, TOY_LATENT, seed=0),
        "ntc_gmm-3": lambda: ts.NTCModel(TOY_POINTS, TOY_LATENT,
                                         prior_type="gmm-3", seed=0),
        "vecvq": lambda: ts.VECVQModel(TOY_POINTS, TOY_CODEBOOK, seed=0)}
    for name, make in makers.items():
        cpu = make()
        card = make().to(device)
        gen = torch.Generator(device=device).manual_seed(3)
        x_card = ts.sawbridge_sample(TOY_BATCH, points_card, generator=gen)
        u = (torch.empty((TOY_BATCH, TOY_LATENT), device=device).uniform_(
            -0.5, 0.5, generator=gen),) * 2
        card_metrics = [t.item() for t in card(x_card, u=u)]
        card(x_card, u=u)[0].backward()
        u_cpu = tuple(t.cpu() for t in u)
        cpu_metrics = [t.item() for t in cpu(x_card.cpu(), u=u_cpu)]
        cpu(x_card.cpu(), u=u_cpu)[0].backward()
        grad_err, worst = _grad_errors(card, cpu)
        metric_err = max(abs(a - b) / max(abs(b), 1e-30)
                         for a, b in zip(card_metrics, cpu_metrics))
        codebook = {}
        if name != "vecvq":
            got = card.quantize_codebook(x_card)
            want = cpu.quantize_codebook(x_card.cpu())
            codebook = {
                "codebook_size": int(got[0].shape[0]),
                "codebook_indexes_equal": bool(torch.equal(
                    got[2].cpu(), want[2])),
                "codebook_within_1e-4": got[0].shape == want[0].shape
                and bool(torch.allclose(got[0].cpu(), want[0], rtol=1e-4,
                                        atol=1e-4))
                and bool(torch.allclose(got[1].cpu(), want[1], rtol=1e-4,
                                        atol=1e-4))}
        card.zero_grad()
        step = ts.make_ntc_train_step(
            card, torch.optim.Adam(card.parameters(), lr=1e-3))
        losses, step_ms = _steps_on_card(
            lambda batch_: step(batch_, generator=gen),
            lambda i: ts.sawbridge_sample(TOY_BATCH, points_card,
                                          generator=gen), steps)
        ok = {"grads_within_1e-3": grad_err <= 1e-3,
              "metrics_within_1e-3": metric_err <= 1e-3,
              "finite": bool(np.isfinite(losses).all()),
              "loss_fell": float(np.mean(losses[-5:]))
              < float(np.mean(losses[:5])),
              **{k: v for k, v in codebook.items() if k != "codebook_size"}}
        log("toy_sources", model=name, source="sawbridge",
            index_points=TOY_POINTS, latent=TOY_LATENT, batch=TOY_BATCH,
            learning_rate=1e-3,
            parameters=sum(p.numel() for p in card.parameters()),
            card_loss_rate_distortion=card_metrics,
            cpu_loss_rate_distortion=cpu_metrics, metric_rel_err=metric_err,
            max_grad_err=grad_err, max_grad_err_param=worst, losses=losses,
            step_ms=step_ms,
            step_ms_median_4_to_30=float(np.median(step_ms[3:])),
            codebook_size=codebook.get("codebook_size"), **flags, **ok)
        if not all(ok.values()):
            fails.append(f"small_models/{name}")
        del cpu, card, step

    # The stochastic round from given bits.
    x = torch.tensor(rng.normal(0, 10, STOCHASTIC_ROUND_SIZE),
                     dtype=torch.float32)
    bits = torch.randint(0, 2 ** 32, x.shape,
                         generator=torch.Generator().manual_seed(5),
                         dtype=torch.int64)
    want = quantization._stochastic_round_bits(x, 0.3, bits)
    x_card, bits_card = x.to(device), bits.to(device)
    got = quantization._stochastic_round_bits(x_card, 0.3, bits_card)
    drawn = quantization.stochastic_round(
        x_card, 0.3, torch.Generator(device=device).manual_seed(5))
    ok = {"equal_to_cpu": bool(torch.equal(got.cpu(), want)),
          "drawn_within_one_step": bool(
              ((drawn.cpu() - torch.floor(x / 0.3)).abs() <= 1).all())}
    log("stochastic_round", elements=STOCHASTIC_ROUND_SIZE,
        ms_from_bits=cuda_ms(lambda: quantization._stochastic_round_bits(
            x_card, 0.3, bits_card), 20),
        ms_with_draw=cuda_ms(lambda: quantization.stochastic_round(
            x_card, 0.3, gen), 20), **flags, **ok)
    if not all(ok.values()):
        fails.append("small_models/stochastic_round")

    # PowerLaw and Laplace on lvac's latent.
    latent_cpu = latent.cpu()
    for em in (PowerLawEntropyModel(coding_rank=2),
               LaplaceEntropyModel(coding_rank=2, run_length_code=0,
                                   magnitude_code=1,
                                   use_run_length_for_non_zeros=True)):
        name = type(em).__name__
        q_card, pen_card = em(latent)
        q_cpu, pen_cpu = em(latent_cpu)
        strings = em.compress(latent_cpu)
        if name == "PowerLawEntropyModel":
            plain = [run_length.plain_run_length_gamma_encode(r)
                     for r in np.round(latent_cpu.numpy()).astype(
                         np.int32).reshape(LVAC_BATCH, -1)]
        else:
            plain = [run_length.plain_run_length_encode(r, 0, 1, True)
                     for r in np.round(latent_cpu.numpy()).astype(
                         np.int32).reshape(LVAC_BATCH, -1)]
        back = em.decompress(strings, latent.shape[1:], device=device)
        try:
            em.compress(latent)
            refused = False
        except ValueError:
            refused = True
        ok = {"quantize_equal": bool(torch.equal(q_card.cpu(), q_cpu)),
              "penalty_within_1e-6": bool(torch.allclose(
                  pen_card.cpu(), pen_cpu, rtol=1e-6, atol=0)),
              "bytes_equal_plain": strings == plain,
              "round_trip": bool(torch.equal(back, torch.round(latent))),
              "refuses_cuda_tensor": refused}
        log("entropy_models", model=name, latent=list(latent.shape),
            bytes=sum(len(b) for b in strings),
            nonzero=int((torch.round(latent_cpu) != 0).sum()),
            compress_host_ms=host_ms(lambda: em.compress(latent_cpu)),
            decompress_host_ms=host_ms(lambda: em.decompress(
                strings, latent.shape[1:], device=device)),
            penalty_ms=cuda_ms(lambda: em.penalty(latent), 20),
            **flags, **ok)
        if not all(ok.values()):
            fails.append(f"small_models/{name}")

    launches, _ = read_counts(())
    log("small_models_launches", launches=launches,
        none_launched=not any(launches.values()))
    if any(launches.values()):
        fails.append("small_models/launched_a_coder_kernel")
    torch.cuda.empty_cache()


# Phase 7p: 4 images of 512x512 through the sidecar codec (1024 streams).
PARALLEL_IMAGES = 4
PARALLEL_RUNS = 3
PARALLEL_SPAWN_TIMEOUT = 300


def _median_ms(fn, runs=PARALLEL_RUNS):
    """Median ms of ``runs`` calls after a warm-up, on the host clock
    around work that ends in torch.cuda.synchronize()."""
    import torch
    fn()
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def _phase_ms(timer):
    return {name: entry["mean_ms"] for name, entry in timer.summary().items()}


def parallel_phase(device, codec, regimes, smi, fails):
    """Phase 7p: parallel/ on the card.

    Coding on an in-process mesh of every card (``make_mesh`` without a
    process group): SidecarBatchCodec with the bls2017 codec's EM (128
    rows, 2^-8 tail mass) on the y rows of ``images`` (1024 streams x 512
    symbols at 512x512) with 200 escapes planted: bytes, lengths and the
    sidecar identical to the unsharded ``compress_sidecar_device``, the
    decode equal to ``quantize``; BatchCodec on bench.py's two regimes
    (``regimes``: 8192 x 512 on 64 Gaussian rows with escapes at 2^-8,
    given indexes: K6' / K3'; 32768 x 512 on the zipf row in channel
    mode: K4' / K5'), bytes identical to ``encode_streams`` and the round
    trip; ``sharded_encode`` of the Gaussian regime through the micro-op
    closure (K7', the micro-op scan), its streams those of
    ``encode_streams``.  The launch counts are read just after these
    calls; the timer's phases and the unsharded calls' ms (numpy in and
    out, as the codecs take them) follow.

    Then two spawns of tests/torch_parallel_worker.py, each under a time
    limit: world size 1 on NCCL (the table broadcast, the byte gather,
    data_parallel_train_step and dp_tp_train_step of bls2017 at 128
    filters, batch 8 of 256x256, TF32 off, noise given: the first step's
    gradients and metrics and the parameters after two steps identical to
    make_train_step's), and two gloo ranks sharing the card (the DP step
    on 4 + 4 of the same batch with sliced noise: the first step's
    gradients within 1e-3 of their largest magnitude, as phase 7 holds
    the card to the CPU, and its metrics within 1e-4 of the single
    process's; the parameters after two steps are logged against the
    largest change, and are no gate: Adam's normalized step turns the
    float noise of a gradient near zero into up to a whole step).  The
    median step ms of each.  Returns the launch counts."""
    import tempfile

    import torch
    from compression_tpu_torch.codec import torch_coder
    from compression_tpu_torch.models import native_format
    from compression_tpu_torch.parallel import (
        BatchCodec, SidecarBatchCodec, make_mesh, sharded_encode)

    t_phase = time.time()
    worker = tests_module("torch_parallel_worker")
    cards = torch.cuda.device_count() if device.type == "cuda" else 1
    mesh = make_mesh(cards, data_axis=cards, device=device.type)
    em = codec.em
    rng = np.random.RandomState(12)
    images = [rng.randint(0, 256, IMAGES["512x512"]).astype(np.uint8)
              for _ in range(PARALLEL_IMAGES)]
    with torch.no_grad():
        rows = torch.cat([native_format.to_streams(codec._analysis(
            codec._upload(img))) for img in images]).cpu().numpy()
    flat = rows.reshape(-1)
    planted = rng.choice(flat.size, 200, replace=False)
    flat[planted] = rng.choice([-1, 1], 200) * rng.uniform(300, 3000, 200)
    (gsym, gidx, gtab), (zsym, ztab) = regimes
    gtable = torch_coder.DeviceCdfTable(gtab, device)
    slots = MICRO_SLOTS
    num_steps = -(-(gsym.shape[1] + ESCAPE_BUDGET * slots) // 64) * 64
    out_size = -(-(2 * num_steps + 2) // 4) * 4

    def micro_encode(s, i):
        ops = torch_coder.micro_ops_from_symbols(s, i, gtable, slots,
                                                 num_steps)
        return torch_coder.encode_core(*ops, out_size)

    sidecar = SidecarBatchCodec(em, mesh)
    gauss = BatchCodec(gtab, mesh)
    zipf = BatchCodec(ztab, mesh)
    reset_counts()
    side_out = sidecar.encode(rows)
    side_back = sidecar.decode(side_out[0], side_out[1], rows.shape[1:-1],
                               side_out[2], side_out[3])
    g_out = gauss.encode(gsym, gidx)
    g_back = gauss.decode(*g_out, gsym.shape[1], gidx)
    z_out = zipf.encode(zsym)
    z_back = zipf.decode(*z_out, zsym.shape[1])
    m_out = sharded_encode(mesh, micro_encode, gsym, gidx)
    launches, routes = read_counts(("encode", "decode", "decode_sidecar"))

    # The unsharded calls the sharded ones are held against.
    def unsharded_sidecar():
        out = em.compress_sidecar_device(torch.as_tensor(rows, device=device))
        return [t.cpu().numpy() for t in out]

    def unsharded(symbols, table, indexes=None):
        out = torch_coder.encode_streams(
            torch.as_tensor(symbols, device=device), table,
            None if indexes is None else torch.as_tensor(indexes,
                                                         device=device))
        return [t.cpu().numpy() for t in out]

    with torch.no_grad():
        want_side = unsharded_sidecar()
        want_rows = em.quantize(torch.as_tensor(rows, device=device)).cpu()
    ztable = zipf.table(device)
    want_g = unsharded(gsym, gtable, gidx)
    want_z = unsharded(zsym, ztable)
    n_side = int(np.prod(rows.shape[1:]))
    ok = {
        "sidecar_identical": all(np.array_equal(a, b) for a, b in zip(
            side_out, [want_side[0].reshape(rows.shape[0], -1)]
            + want_side[1:])),
        "sidecar_escapes_found": int(side_out[2].size) >= 200,
        "sidecar_decode_equals_quantize": bool(
            np.array_equal(side_back[0], want_rows.numpy())
            and side_back[1].all()),
        "gaussian_identical": all(np.array_equal(a, b)
                                  for a, b in zip(g_out, want_g)),
        "gaussian_round_trip": bool(np.array_equal(g_back[0], gsym)
                                    and g_back[1].all()),
        "zipf_identical": all(np.array_equal(a, b)
                              for a, b in zip(z_out, want_z)),
        "zipf_round_trip": bool(np.array_equal(z_back[0], zsym)
                                and z_back[1].all()),
        "micro_streams_identical": torch_coder.to_bytes_list(*m_out)
        == torch_coder.to_bytes_list(*want_g),
        "routes_on_the_card": routes == {
            "encode": "cuda-micro", "decode": "cuda-single",
            "decode_sidecar": "cuda-indexed"},
        "kernels_launched": all(launches[k] > 0 for k in (
            "encode_indexed", "decode_indexed", "encode_gamma",
            "decode_gamma", "encode_single_row", "decode_single_row",
            "encode_scan", "pair_lookup"))}
    ms = {
        "sidecar_encode": _median_ms(lambda: sidecar.encode(rows)),
        "sidecar_encode_unsharded": _median_ms(unsharded_sidecar),
        "gaussian_encode": _median_ms(lambda: gauss.encode(gsym, gidx)),
        "gaussian_encode_unsharded": _median_ms(
            lambda: unsharded(gsym, gtable, gidx)),
        "zipf_encode": _median_ms(lambda: zipf.encode(zsym)),
        "zipf_encode_unsharded": _median_ms(lambda: unsharded(zsym, ztable)),
        "micro_sharded_encode": _median_ms(
            lambda: sharded_encode(mesh, micro_encode, gsym, gidx)),
        "micro_encode_unsharded": _median_ms(lambda: [
            t.cpu().numpy() for t in micro_encode(
                torch.as_tensor(gsym, device=device),
                torch.as_tensor(gidx, device=device))])}
    log("parallel_coding", card=smi, mesh=mesh.shape,
        sidecar_shape=list(rows.shape), sidecar_escapes=int(side_out[2].size),
        gaussian_shape=list(gsym.shape), zipf_shape=list(zsym.shape),
        micro_steps=num_steps, launches=launches, routes=routes, ms=ms,
        sidecar_timer_ms=_phase_ms(sidecar.timer),
        gaussian_timer_ms=_phase_ms(gauss.timer),
        zipf_timer_ms=_phase_ms(zipf.timer), **ok)
    if not all(ok.values()):
        fails.append("parallel/coding")
    del want_side, want_rows, rows
    torch.cuda.empty_cache()

    # Multi-process on the card.
    with tempfile.TemporaryDirectory(dir=REPO) as tmp:
        runs = {}
        for scenario, world in (("card_nccl", 1), ("card_gloo", 2)):
            t0 = time.time()
            results = worker.spawn(scenario, world, None, tmp,
                                   PARALLEL_SPAWN_TIMEOUT)
            seconds = time.time() - t0
            done = all(rc == 0 for rc, _ in results)
            reports = []
            for r in range(world if done else 0):
                with open(os.path.join(tmp, f"rank{r}.json")) as f:
                    reports.append(json.load(f))
            runs[scenario] = (done, reports)
            if not done:
                log("parallel_spawn_failed", scenario=scenario,
                    exit_codes=[rc for rc, _ in results],
                    tails=[out[-3000:] for _, out in results])
                fails.append(f"parallel/{scenario}")
            else:
                log("parallel_spawn", scenario=scenario, world=world,
                    seconds=seconds, card=smi, reports=reports)
        if all(done for done, _ in runs.values()):
            nccl = runs["card_nccl"][1][0]
            gloo = runs["card_gloo"][1]
            start = torch.load(os.path.join(tmp, "start.pt"))
            single = torch.load(os.path.join(tmp, "single.pt"))
            two = torch.load(os.path.join(tmp, "gloo.pt"))
            grad_err = max(float((two["grad"][k] - g).abs().max()
                                 / g.abs().max())
                           for k, g in single["grad"].items())
            metric_err = max(abs(two["metrics"][k] - v) / abs(v)
                             for k, v in single["metrics"].items())
            change = max(float((p - start[k]).abs().max())
                         for k, p in single["params"].items())
            off = {k: (two["params"][k] - p).abs()
                   for k, p in single["params"].items()}
            param_err = max(float(d.max()) for d in off.values())
            over = sum(int((d > 1e-3 * change).sum()) for d in off.values())
            timed = slice(worker.PARITY_STEPS, None)
            ok = {"nccl_backend": nccl["backend"] == "nccl"
                  and nccl["world"] == 1,
                  "tables_broadcast": nccl["tables_equal"],
                  "gather_bytes": nccl["gather_equal"],
                  "data_parallel_identical": nccl["data_parallel_identical"],
                  "dp_tp_identical": nccl["dp_tp_identical"],
                  "gloo_two_ranks": all(r["backend"] == "gloo"
                                        and r["world"] == 2 for r in gloo),
                  "gloo_gradients_within_1e-3": grad_err <= 1e-3,
                  "gloo_metrics_within_1e-4": metric_err <= 1e-4}
            log("parallel_train", card=smi, filters=worker.CARD_FILTERS,
                batch=list(worker.CARD_BATCH),
                parity_steps=worker.PARITY_STEPS,
                gloo_max_grad_err=grad_err, gloo_metric_rel_err=metric_err,
                largest_parameter_change=change,
                gloo_max_param_err=param_err,
                gloo_param_err_over_change=param_err / change,
                gloo_params_over_a_thousandth_of_change=over,
                parameters=sum(d.numel() for d in off.values()),
                step_ms_median={
                    **{k: float(np.median(v[timed]))
                       for k, v in nccl["step_ms"].items()},
                    **{f"gloo_rank{r}": float(np.median(g["step_ms"][timed]))
                       for r, g in enumerate(gloo)}},
                tp_leaves=nccl["tp_leaves"], **ok)
            if not all(ok.values()):
                fails.append("parallel/train")
    log("parallel", seconds=time.time() - t_phase)
    return launches


# Phase 7x: images that evaluate reads (seeded, as .npy: the card's machine
# has no PIL), the last one too small for MS-SSIM's five scales; steps of
# the texture model timed apart from train_synthetic's own run.
EXAMPLE_IMAGES = {"a.npy": (512, 512, 3), "b.npy": (176, 192, 3),
                  "c.npy": (64, 80, 3)}
EXAMPLE_TRAIN_STEPS = 30
# train_synthetic's defaults, for its model's steps timed apart.
EXAMPLE_TRAIN = dict(batch_size=8, patchsize=128, num_filters=64)


def _run_main(main, argv):
    """(return value, stdout text, seconds) of an example's main."""
    import contextlib
    import io
    import torch
    text = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(text):
        rc = main(argv)
    torch.cuda.synchronize()
    return rc, text.getvalue(), time.perf_counter() - t0


def examples_phase(device, smi, fails):
    """Phase 7x: the port's example scripts on the card, each through its
    ``main`` as ``python -m compression_tpu_torch.examples.<name>`` runs it.

    ``train_synthetic`` at its defaults (bls2017 at 64 filters, 2 lambdas x
    400 steps of batch 8 of 128x128 textures, 4 held-out textures through
    the classic container) must run to its end with both RD points finite,
    the summary and its verdict, whose exit code it must follow; the
    verdict is logged and not gated on (at these defaults the two lambdas
    land within noise of each other).  Its training must move and use its
    lambda: every loss it logs equals bpp + lambda * mse of the same line
    within 1e-4 relative, and each lambda's last logged loss is below its
    first.  EXAMPLE_TRAIN_STEPS steps of the same model on its texture
    batches are timed apart by CUDA events (median of steps 4-30: the
    run's own steps include the host's FFTs), and their loss must fall
    (the mean of the last 5 below that of the first 5).
    ``evaluate`` over a registry that bls2017's own ``train`` writes (CLI
    defaults, 2 steps, as phase 7t) and EXAMPLE_IMAGES: one row an image,
    each bpp 8 * len(compress(img)) / pixels, each PSNR and MS-SSIM that of
    the port's metrics on the decoded image, MS-SSIM NaN for the image
    below 176 pixels only, the CSV of ``--out``; one encode and one K3' an
    image.  ``pod_compress`` on a mesh of one card and on one of every card
    (4 x 256 rows of 512 symbols, two outliers): identical bytes across the
    two (on a host of one card both meshes are that card, and the check is
    logged as vacuous), its rates and phases from the record of ``--out``.
    Returns the launch counts of the three."""
    import ast
    import tempfile

    import torch
    from compression_tpu_torch.codec import cuda_coder
    from compression_tpu_torch.examples import (evaluate, pod_compress,
                                                train_synthetic)
    from compression_tpu_torch.models import bls2017, tfci
    from compression_tpu_torch.util import metrics

    t_phase = time.time()
    total = {k: 0 for k in cuda_coder.LAUNCHES}

    reset_counts()
    rc, text, seconds = _run_main(train_synthetic.main,
                                  ["--device", device.type])
    launches, _ = read_counts(())
    points = [line.split() for line in text.splitlines()
              if line.startswith("  lambda ")]
    rd = [{"lambda": float(p[1]), "bpp": float(p[2]), "psnr_db": float(p[4])}
          for p in points]
    verdict = [line.split(": ")[1] for line in text.splitlines()
               if line.startswith("monotone RD tradeoff: ")]
    # The losses each lambda's training logs ({"loss", "bpp", "mse"}).
    logged, lmbda = {}, None
    for line in text.splitlines():
        if line.startswith("=== lambda "):
            lmbda = float(line.split()[2].rstrip(":"))
            logged[lmbda] = []
        elif line.startswith("{'loss'") and lmbda is not None:
            logged[lmbda].append(ast.literal_eval(line))
    uses_lambda = all(
        abs(m["loss"] - (m["bpp"] + lm * m["mse"])) <= 1e-4 * abs(m["loss"])
        for lm, ms in logged.items() for m in ms)
    training_fell = {lm: len(ms) >= 2 and ms[-1]["loss"] < ms[0]["loss"]
                     for lm, ms in logged.items()}
    # The script's own verdict is logged, not gated on: at its defaults the
    # two lambdas land within noise of each other (PERF.md §6).  The
    # run must end with both RD points finite, the summary and a verdict
    # that its exit code follows, its training lowering the loss it logs.
    ok = (len(rd) == 2 and "RD summary" in text and len(verdict) == 1
          and rc == {"OK": 0, "VIOLATED": 1}.get(verdict[0])
          and all(math.isfinite(p["bpp"]) and math.isfinite(p["psnr_db"])
                  for p in rd)
          and len(logged) == 2 and uses_lambda
          and all(training_fell.values()))
    # The same model's steps on the script's batches, timed apart.
    args = EXAMPLE_TRAIN
    sample = train_synthetic.make_texture_source(args["patchsize"], seed=0)
    batches = [sample(args["batch_size"])
               for _ in range(EXAMPLE_TRAIN_STEPS)]
    model = bls2017.BLS2017Model(lmbda=0.003,
                                 num_filters=args["num_filters"]).to(device)
    step = bls2017.make_train_step(
        model, torch.optim.Adam(model.parameters(), lr=1e-4))
    gen = torch.Generator(device=device).manual_seed(0)
    losses, step_ms = _steps_on_card(
        lambda b: step(b, generator=gen), lambda i: batches[i],
        EXAMPLE_TRAIN_STEPS)
    del model, step
    steps_fell = (bool(np.isfinite(losses).all())
                  and float(np.mean(losses[-5:]))
                  < float(np.mean(losses[:5])))
    ok = ok and steps_fell
    log("examples", example="train_synthetic", card=smi, rc=rc,
        seconds=seconds, rd=rd, verdict=verdict, ok=ok, launches=launches,
        logged_losses={str(lm): [m["loss"] for m in ms]
                       for lm, ms in logged.items()},
        uses_lambda=uses_lambda,
        training_fell={str(lm): v for lm, v in training_fell.items()},
        train_step_ms_median=float(np.median(step_ms[3:])),
        timed_loss_first5=float(np.mean(losses[:5])),
        timed_loss_last5=float(np.mean(losses[-5:])),
        timed_loss_fell=steps_fell, **args)
    if not ok:
        fails.append("examples/train_synthetic")
    for k in total:
        total[k] += launches[k]

    with tempfile.TemporaryDirectory(dir=REPO) as root:
        bls2017.main(["train", "--model_path",
                      os.path.join(root, "registry", "bls2017"),
                      "--steps", "2", "--device", device.type])
        img_dir = os.path.join(root, "images")
        os.makedirs(img_dir)
        rng = np.random.RandomState(17)
        images = {}
        for name, shape in EXAMPLE_IMAGES.items():
            images[name] = rng.randint(0, 256, shape).astype(np.uint8)
            np.save(os.path.join(img_dir, name), images[name])
        csv = os.path.join(root, "rd.csv")
        reset_counts()
        rows, text, seconds = _run_main(evaluate.main, [
            "--model_path", os.path.join(root, "registry"), "--model",
            "bls2017", "--images", img_dir, "--out", csv,
            "--device", device.type])
        launches, _ = read_counts(())
        codec = tfci._load_codec(os.path.join(root, "registry"), "bls2017",
                                 device)
        checks = []
        for name, bpp, psnr, msssim in rows:
            img = images[name]
            container = codec.compress(img)
            rec = codec.decompress(container).astype(np.float32)
            a = img.astype(np.float32)
            small = min(img.shape[:2]) < 176
            checks.append(
                bpp == 8 * len(container) / (img.shape[0] * img.shape[1])
                and psnr == float(metrics.psnr(a, rec, device=device))
                and (math.isnan(msssim) if small else msssim == float(
                    metrics.msssim(a[None], rec[None], device=device))))
        with open(csv) as f:
            csv_lines = f.read().splitlines()
        del codec
        encodes = launches["encode_indexed"] + launches["encode_gamma"]
        ok = (sorted(r[0] for r in rows) == sorted(EXAMPLE_IMAGES)
              and all(checks) and len(csv_lines) == len(rows) + 1
              and encodes == len(rows)
              and launches["decode_gamma"] == len(rows))
        log("examples", example="evaluate", card=smi, seconds=seconds,
            rows=[{"image": r[0], "bpp": r[1], "psnr_db": r[2],
                   "msssim": r[3]} for r in rows], rows_ok=checks,
            launches=launches, ok=ok)
        if not ok:
            fails.append("examples/evaluate")
        for k in total:
            total[k] += launches[k]

        record_path = os.path.join(root, "pod.json")
        reset_counts()
        rc, text, seconds = _run_main(
            pod_compress.main, ["--device", device.type, "--out",
                                record_path])
        launches, _ = read_counts(())
        with open(record_path) as f:
            record = json.load(f)
        same = "container bytes identical across device counts: True" in text
        ok = (rc == 0 and same
              and record["bytes_deterministic_across_device_counts"]
              and launches["encode_indexed"] > 0
              and launches["decode_indexed"] > 0)
        # One card: both meshes are that card, and equal bytes show
        # nothing of device counts (tests/test_torch_examples.py checks
        # them on a CPU mesh of 2).
        bytes_check = ("vacuous: one device" if record["devices"] == 1
                       else "across device counts")
        log("examples", example="pod_compress", card=smi, seconds=seconds,
            rc=rc, record=record, bytes_check=bytes_check,
            launches=launches, ok=ok)
        if not ok:
            fails.append("examples/pod_compress")
        for k in total:
            total[k] += launches[k]
    log("examples", part="phase", seconds=round(time.time() - t_phase, 3))
    torch.cuda.empty_cache()
    return total


def escape_count(symbols, rows, meta):
    """How many symbols fall outside their row's range (escapes)."""
    from compression_tpu_torch.codec import cuda_coder
    return cuda_coder.interval_counts(symbols.contiguous(),
                                      rows.to(symbols.dtype).contiguous(),
                                      meta)[1].sum()


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
    i_chosen, i_both = decode_variants("decode_indexed", table)
    corrupt_cases("decode_indexed", i_chosen, cc.decode_indexed_plain,
                  buf, lens, (idx, cdf, meta), 5, fails, i_both)

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
    # The same symbols on the row at precision 16: K5''s 128 KB table of
    # counts, and the pair read from the row.
    ztable16 = torch_coder.DeviceCdfTable(zipf_table(16)[0], device)
    compare_single_row("single_row/zipf_p16", ztable16, zsym, fails)
    # Wide rows at precision 16: 64 buckets (K8''s count from registers at
    # its limit) and 94 (its binary search in shared memory).
    for alphabet in WIDE_ROW_ALPHABETS:
        wtab, wpmf = zipf_table(16, alphabet)
        wsym_row = torch.as_tensor(np.random.RandomState(alphabet).choice(
            alphabet, size=WIDE_ROW_SHAPE, p=wpmf).astype(np.int32),
            device=device)
        compare_single_row(f"single_row/wide{alphabet}_p16",
                           torch_coder.DeviceCdfTable(wtab, device),
                           wsym_row, fails)
    z_slots = ztable.single_row_slots()
    corrupt_cases("decode_single_row",
                  lambda b, ln, c, m: cc.decode_single_row(b, ln, n_z, c, m,
                                                           z_slots),
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
    g_chosen, g_both = decode_variants("decode_gamma", gtable)
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
    # The classic compress codes an escape-free latent by K1 on this one
    # stream: its wrapper and both kernels.  Without an escape K1's format
    # and K6''s code the same intervals in rows of the same size, so K6''s
    # bytes, held against its plain version just above, stand for K1's.
    ccdf, cmeta = table.indexed_arrays()
    c_escapes = int(cc.interval_counts(csym, cidx, cmeta)[1].sum())
    _, _, k1_ok, _, k1_took = check_variants(
        "encode_indexed", (csym, cidx, ccdf, cmeta), cbuf.shape[1],
        expect=(cbuf, clens) if c_escapes == 0 else None)
    log("kernels", case=f"indexed/classic_{first}",
        streams=int(csym.shape[0]), symbols=int(csym.shape[1]),
        escapes=c_escapes, held_against="encode_gamma" if c_escapes == 0
        else "encode_indexed_plain",
        encode_identical_wrapper_and_both_kernels=k1_ok,
        encode_wrapper_took=k1_took)
    if not k1_ok or k1_took != "warp":
        fails.append(f"indexed/classic_{first}")

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
        hy, hz, hidx, _ = hcodec._encode(hcodec._upload(images[first]))
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
    cases = tests_module("scan_cases")
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

    # K1 and K6' (the wrapper and both kernels) on tests/symbol_cases.py's
    # inputs -- escapes in lane 0 and 31, several in a window, in the last
    # partial window, negative, g = 2^31 back to back; streams of 0 to 400
    # symbols; bounded rows at precision 1 to 16 -- in rows of even and odd
    # width (most odd rows start at an odd address).
    from compression_tpu_torch.codec import tables as port_tables
    sym_cases = tests_module("symbol_cases")
    sym_bad = []
    for label in sorted(sym_cases.SYMBOL_CASES):
        ragged, s_np, i_np = sym_cases.symbol_case(label)
        st = torch_coder.DeviceCdfTable(port_tables.parse_ragged_cdf(ragged),
                                        device)
        s_t = torch.as_tensor(s_np, device=device)
        i_t = torch.as_tensor(i_np, device=device)
        s_cdf, s_meta = st.indexed_arrays()
        steps = int(cc.interval_counts(s_t, i_t, s_meta)[0].sum(1).max()) \
            if s_t.numel() else 0
        for pad in (0, 1):
            for name, width in (("encode_gamma", 2 * steps + 2 + pad),
                                ("encode_indexed",
                                 2 * s_t.shape[1] + 2 + pad)):
                _, _, same, _, took = check_variants(
                    name, (s_t, i_t, s_cdf, s_meta), width)
                if not same or took != "warp":
                    sym_bad.append(f"{label}/{name}/{width}")
    log("kernels", case="symbol_cases", cases=sorted(sym_cases.SYMBOL_CASES),
        widths=["even", "odd"], kernels=["encode_gamma", "encode_indexed"],
        mismatched_or_thread=sym_bad)
    fails.extend(f"symbol_cases/{b}" for b in sym_bad)
    # K1 and K6' at a stream count on either side of their dispatch
    # constant: the larger launch takes the thread-per-stream kernel.
    edge = cc.WARP_ENCODE_MAX_STREAMS
    reps = -(-(edge + 1) // gsym_t.shape[0])
    esym = gsym_t[:, :64].repeat(reps, 1)[: edge + 1]
    eidx = gidx_t[:, :64].repeat(reps, 1)[: edge + 1]
    for streams in (edge, edge + 1):
        part = esym[:streams].contiguous(), eidx[:streams].contiguous()
        compare_kernels(f"encode_indexed/dispatch_{streams}", gtable, *part,
                        torch_coder.stream_out_size(64), fails,
                        expect_warp=streams == edge)
        compare_gamma(f"encode_gamma/dispatch_{streams}", gtable, *part,
                      fails, expect_warp=streams == edge)

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
    # Every K1 and K2 launch of the native path (256-1024 streams) takes
    # the warp-per-stream kernel.
    if not (main_ok and many_ok and native_launches["encode_indexed"] > 0
            and native_launches["encode_indexed/warp"]
            == native_launches["encode_indexed"]
            and native_launches["decode_indexed"] > 0
            and native_launches["decode_indexed/warp"]
            == native_launches["decode_indexed"]
            and set(paths.values()) == {"cuda-indexed"}):
        fails.append("main_path")

    # Escapes through the native container: a latent scaled to twice the
    # table's width codes its tails in the sidecar and decodes to its
    # quantization.
    with torch.no_grad():
        y = codec._analysis(codec._upload(images[first]))
        scale = 2.0 * table.max_len / float(y.abs().max())
        y_wide = scale * y
        cont = bls_native(codec, y_wide, IMAGES[first][:2])
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
    # escapes, K1 when it has none) and one K3' launch per decode, each
    # one stream: the warp-per-stream kernels.
    if not (classic_ok and many_ok and wide_ok
            and classic_launches["encode_gamma"] > 0
            and classic_launches["encode_gamma/warp"]
            == classic_launches["encode_gamma"]
            and classic_launches["encode_indexed/warp"]
            == classic_launches["encode_indexed"]
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
    # decode_streams hands K5' the table's cached slot table (the kernel
    # takes no other form of the row).
    front_slots = ztable.kernel_tables.get("single_row")
    front_ok &= front_slots is not None and front_slots[1] == 12
    log("coder_front_end", shape=list(SINGLE_ROW_SHAPE), round_trip=front_ok,
        slot_table_bytes=int(4 * front_slots[0].numel()) if front_slots
        else None, launches=front_launches, dispatch=front_paths)
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
    # Every classic stream is one stream a launch, and a native launch of
    # K1 or K2 holds 32-2048 streams: the warp kernels'.
    for name in ("decode_gamma", "encode_gamma", "encode_indexed",
                 "decode_indexed"):
        hyper_ok &= hyper_launches[f"{name}/warp"] == hyper_launches[name]
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

    # Phase 4f: ms2020 at its published width (launch counts of its own,
    # kernel checks and times at its shapes, its goldens, e2e ms).
    ms_launches, mcodec = ms2020_phase(device, images, batch, smi, fails)

    # Phase 4g: the classic containers of the three models, and the host C
    # coder against the card's wrappers at a few streams.
    classic_phase({"bls2017": codec, "bmshj2018": hcodec, "ms2020": mcodec},
                images, (ysym.contiguous(), yidx1.contiguous(), ytable),
                fails)
    del mcodec
    torch.cuda.empty_cache()

    # Phase 4h: HiFiC at the published hific width (launch counts of its
    # own, K1 and K2 at its native launches, the classic streams against
    # the host C coder, e2e ms).
    hific_launches = hific_phase(device, images, batch, smi, fails)

    # Phase 5: reference on a small input -- the CPU codec (plain coder)
    # given the same latent and tables writes the same containers.
    small = rng.randint(0, 256, (64, 96, 3)).astype(np.uint8)
    cpu_codec = bls2017.BLS2017Codec(
        bls2017.BLS2017Model(num_filters=NUM_FILTERS, seed=0), device="cpu",
        tables=codec.em.get_weights())
    with torch.no_grad():
        y = codec._analysis(codec._upload(small))
        c_gpu = bls_native(codec, y, small.shape[:2])
        c_cpu = bls_native(cpu_codec, y.cpu(), small.shape[:2])
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
        sy, sz, sidx, _ = hcodec._encode(hcodec._upload(small))
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

    # Phase 6: the host C coder against the reference-format wrappers on
    # the card, on the main paths' streams.
    host_coder_phase({
        "bls2017_y_classic": (csym, cidx, table),
        "bmshj2018_y_classic": (ysym.contiguous(), yidx1.contiguous(),
                                ytable),
        "bmshj2018_z_classic": (zsym1.contiguous(), zidx1, htable),
        "bls2017_native": (main_inputs[first][0], main_inputs[first][1],
                           table),
        "micro_bench": (zsym, None, ztable)}, fails)

    # Phase 7: a train step of both models on the card against the CPU,
    # then 30 steps on the card.
    train_phase(device, fails)
    # Phase 7h: HiFiC's GAN training, then its weights served and its
    # command line.
    hific_tfci = {}

    def hific_registry(root):
        fields, counts = tfci_round_trip(root, "hific", images[first])
        hific_tfci.update(fields=fields, launch_counts=counts)

    hific_train_launches = hific_train_phase(device, images[first], smi,
                                             fails,
                                             registry_hook=hific_registry)
    # Phase 7t: the generic command line; phase 7u: the universal models.
    tfci_launches = tfci_phase(device, images[first], smi, fails, hific_tfci)
    universal_launches = universal_phase(device, smi, fails)
    # Phase 7s: the layers, lvac, the toy sources, the stochastic round and
    # the PowerLaw / Laplace entropy models.
    small_models_phase(device, smi, fails)
    # Phase 7p: parallel/ -- sharded coding on the card's mesh, then DP and
    # DP x TP steps in processes of their own.
    parallel_launches = parallel_phase(
        device, codec, ((gsym, gidx, gtab), (zsym.cpu().numpy(), ztab)), smi,
        fails)
    # Phase 7x: the example scripts (train_synthetic, evaluate,
    # pod_compress).
    example_launches = examples_phase(device, smi, fails)

    # Phase 8: times at the main paths' shapes.
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
            buf, lens, idx, cdf, meta, table.warp_arrays()), 50),
        # The single-row pair from a CUDA graph (the device's time).
        "encode_single_row": graph_ms(lambda: cc.encode_single_row(
            zsym, zcdf, zmeta, zbuf.shape[1])),
        "decode_single_row": graph_ms(lambda: cc.decode_single_row(
            zbuf, zlens, n_z, zcdf, zmeta, z_slots)),
        "encode_gamma": cuda_ms(lambda: cc.encode_gamma(
            csym, cidx, cdf, meta, cbuf.shape[1]), 5),
        "decode_gamma": cuda_ms(lambda: cc.decode_gamma(
            cbuf, clens, cidx, cdf, meta, table.warp_arrays()), 5),
        "encode_scan": cuda_ms(lambda: cc.encode_scan(
            *yops, ysbuf.shape[1]), 5),
        "pair_lookup": cuda_ms(lambda: cc.pair_lookup(*ypair), 50),
        # K8' from a CUDA graph too, beside K5'.
        "decode_single_row_bucketed": graph_ms(
            lambda: cc.decode_single_row_bucketed(
                zbuf, zlens, n_z, *ztable.bucketed_arrays())),
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
    for streams in SWEEP_STREAMS:
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
    # K2: the wrapper and both kernels at the native main paths' launches,
    # on the buffers decompress gives them (from_bytes_list of the
    # container's strings: rows as wide as the longest stream), by events
    # around a loop of calls and replayed from a CUDA graph; beside the
    # byte bound and the serial chain's floor (the streams of a launch run
    # side by side: one stream's symbols).  Then as streams grow, 512
    # symbols of the Gaussian regime a stream, which is what the dispatch
    # constant rests on.
    indexed_shapes = {f"bls2017/{img_name}": (table, n_sym, n_idx, n_buf,
                                              n_lens)
                      for img_name, (n_sym, n_idx, _, n_buf, n_lens)
                      in main_inputs.items()}
    with torch.no_grad():
        for img_name, img in images.items():
            iy, iz, iidx, _ = hcodec._encode(hcodec._upload(img))
            isym, iidx_n, _ = hcodec.em._symbols(
                native_format.to_streams(iy), native_format.to_streams(iidx))
            zsym_i, _, zrow_i = hcodec.side_em._symbols_from_bottleneck(
                native_format.to_streams(iz))
            zidx_i = zrow_i.to(torch.int32)[None].expand_as(zsym_i)
            for part, tab, i_sym, i_idx in (
                    ("y", ytable, isym, iidx_n), ("z", htable, zsym_i, zidx_i)):
                i_sym, i_idx = i_sym.contiguous(), i_idx.contiguous()
                i_cdf, i_meta = tab.indexed_arrays()
                i_buf, i_lens = cc.encode_indexed(
                    i_sym, i_idx, i_cdf, i_meta,
                    torch_coder.stream_out_size(i_sym.shape[1]))
                indexed_shapes[f"bmshj2018_{part}/{img_name}"] = (
                    tab, i_sym, i_idx, i_buf, i_lens)
    indexed_ms = {}
    for label, (tab, i_sym, i_idx, i_buf, i_lens) in indexed_shapes.items():
        i_cdf, i_meta = tab.indexed_arrays()
        layout = tab.warp_arrays()
        strings = torch_coder.to_bytes_list(i_buf.cpu().numpy(),
                                            i_lens.cpu().numpy())
        c_buf, c_lens = (torch.as_tensor(a, device=device)
                         for a in torch_coder.from_bytes_list(strings))
        n = int(i_sym.shape[1])
        calls = {
            "wrapper": lambda: cc.decode_indexed(c_buf, c_lens, i_idx, i_cdf,
                                                 i_meta, layout),
            "warp": lambda: cc.decode_indexed_warp(c_buf, c_lens, i_idx,
                                                   i_cdf, i_meta, layout),
            "thread": lambda: cc.decode_indexed_thread(c_buf, c_lens, i_idx,
                                                       i_cdf, i_meta)}
        row = {"container_width": int(c_buf.shape[1]),
               "bound_ms": decode_bound(c_lens, n, i_cdf, i_meta)[0],
               "chain_floor_ms": warp_floor_ms(n, tab.max_len, clock)}
        for name, call in calls.items():
            row[f"{name}_ms_events"] = [cuda_ms(call, 20) for _ in range(2)]
            row[f"{name}_ms_graph"] = [graph_ms(call) for _ in range(2)]
        indexed_ms[at(label, i_sym)] = row
    kbuf, klens = cc.encode_indexed(gsym_t, gidx_t, gcdf, gmeta,
                                    torch_coder.stream_out_size(gsym_t.shape[1]))
    indexed_sweep = {}
    for streams in SWEEP_STREAMS:
        reps = -(-streams // kbuf.shape[0])
        sb = kbuf.repeat(reps, 1)[:streams].contiguous()
        sl = klens.repeat(reps)[:streams].contiguous()
        si = gidx_t.repeat(reps, 1)[:streams].contiguous()
        warp_call = lambda: cc.decode_indexed_warp(sb, sl, si, gcdf, gmeta,
                                                   g_layout)
        thread_call = lambda: cc.decode_indexed_thread(sb, sl, si, gcdf,
                                                       gmeta)
        rounds = [(cuda_ms(warp_call, 10), cuda_ms(thread_call, 10))
                  for _ in range(2)]
        indexed_sweep[f"{streams}x{si.shape[1]}"] = {
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
    for streams in SWEEP_STREAMS:
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
    # K6' and K1: both kernels at the main paths' shapes beside the byte
    # bound and the chain's floor (the longest stream's coded steps: the
    # streams of a launch run side by side); and as streams grow (the
    # Gaussian regime, 512 symbols a stream), which is what the dispatch
    # constant rests on.
    symbol_shapes = {
        "encode_gamma/bls2017_y": (csym, cidx, table, cbuf.shape[1]),
        # The classic compress of a latent without escapes takes K1.
        "encode_indexed/bls2017_y": (csym, cidx, table, cbuf.shape[1]),
        "encode_gamma/bmshj2018_y": (ysym.contiguous(), yidx1.contiguous(),
                                     ytable, ybuf1.shape[1]),
        "encode_gamma/bmshj2018_z": (zsym1.contiguous(), zidx1, htable,
                                     zbuf1.shape[1])}
    for img_name, (n_sym, n_idx, n_out, _, _) in main_inputs.items():
        symbol_shapes[f"encode_indexed/bls2017_native_{img_name}"] = (
            n_sym, n_idx, table, n_out)
    symbol_shapes["encode_indexed/bmshj2018_y_native"] = (
        ysym_n.contiguous(), yidx_n.contiguous(), ytable,
        torch_coder.stream_out_size(ysym_n.shape[1]))
    symbol_ms = {}
    for label, (s_sym, s_idx, s_tab, width) in symbol_shapes.items():
        name = label.split("/")[0]
        s_cdf, s_meta = s_tab.indexed_arrays()
        s_counts = cc.interval_counts(s_sym, s_idx, s_meta)[0]
        if name == "encode_indexed":
            s_counts = torch.ones_like(s_counts)
        warp_call = lambda: getattr(cc, name + "_warp")(
            s_sym, s_idx, s_cdf, s_meta, width)
        thread_call = lambda: getattr(cc, name + "_thread")(
            s_sym, s_idx, s_cdf, s_meta, width)
        iters = 5 if s_sym.shape[0] == 1 else 20
        rounds = [(cuda_ms(warp_call, iters), cuda_ms(thread_call, iters))
                  for _ in range(2)]
        symbol_ms[at(label, s_sym)] = {
            "warp_ms": [r[0] for r in rounds],
            "thread_ms": [r[1] for r in rounds],
            # A native launch takes ~0.05 ms: the events above time the
            # host's enqueueing of wrapper calls, a CUDA graph the card.
            **({"warp_ms_graph": [graph_ms(warp_call) for _ in range(2)],
                "thread_ms_graph": [graph_ms(thread_call) for _ in range(2)]}
               if s_sym.shape[0] > 1 else {}),
            "coded_steps": int(s_counts.sum()),
            "bound_ms": encode_bound(*s_sym.shape, s_cdf, s_meta, width,
                                     intervals=int(s_counts.sum()))[0],
            "chain_floor_ms": scan_floor_ms(int(s_counts.sum(1).max()),
                                            clock)}
    symbol_sweep = {}
    for streams in SWEEP_STREAMS:
        reps = -(-streams // gsym_t.shape[0])
        sw_sym = gsym_t.repeat(reps, 1)[:streams].contiguous()
        sw_idx = gidx_t.repeat(reps, 1)[:streams].contiguous()
        row = {}
        for name, width in (("encode_gamma", gbuf.shape[1]),
                            ("encode_indexed",
                             torch_coder.stream_out_size(sw_sym.shape[1]))):
            rounds = [(cuda_ms(lambda: getattr(cc, name + "_warp")(
                sw_sym, sw_idx, gcdf, gmeta, width), 10),
                       cuda_ms(lambda: getattr(cc, name + "_thread")(
                           sw_sym, sw_idx, gcdf, gmeta, width), 10))
                      for _ in range(2)]
            row[name] = {"warp_ms": [r[0] for r in rounds],
                         "thread_ms": [r[1] for r in rounds]}
        symbol_sweep[f"{streams}x{sw_sym.shape[1]}"] = row
        del sw_sym, sw_idx
    # K4' and K5' at the micro-bench regime and on its row at precision 16,
    # beside the byte bound and the chain's floor (one stream's symbols:
    # the streams run side by side), and as streams grow; from CUDA graphs.
    single_ms = {}
    for label, (s_tab, s_sym) in {
            "zipf_p12": (ztable, zsym),
            "zipf_p16": (ztable16, zsym)}.items():
        s_cdf, s_meta = s_tab.indexed_arrays()
        s_slots = s_tab.single_row_slots()
        s_buf, s_lens = cc.encode_single_row(s_sym, s_cdf, s_meta,
                                             zbuf.shape[1])
        s_row = s_tab.bucketed_arrays()
        single_ms[at(label, s_sym)] = {
            "encode_ms_graph": [graph_ms(lambda: cc.encode_single_row(
                s_sym, s_cdf, s_meta, zbuf.shape[1])) for _ in range(2)],
            "decode_ms_graph": [graph_ms(lambda: cc.decode_single_row(
                s_buf, s_lens, n_z, s_cdf, s_meta, s_slots))
                for _ in range(2)],
            "slot_table_bytes": int(4 * s_slots[0].numel()),
            "encode_bound_ms": encode_bound(*s_sym.shape, s_cdf, s_meta,
                                            zbuf.shape[1],
                                            with_indexes=False)[0],
            "decode_bound_ms": decode_bound(s_lens, n_z, s_cdf, s_meta,
                                            with_indexes=False)[0],
            "encode_chain_floor_ms": scan_floor_ms(n_z, clock),
            "decode_chain_floor_ms": slot_floor_ms(n_z, s_slots[1], clock),
            "bucketed_ms_graph": [graph_ms(
                lambda: cc.decode_single_row_bucketed(
                    s_buf, s_lens, n_z, *s_row)) for _ in range(2)],
            "buckets": int(s_row[0].shape[0]),
            "bucketed_floor_ms": bucketed_floor_ms(
                n_z, int(s_row[0].shape[0]), clock)}
    single_sweep = {}
    for streams in SWEEP_STREAMS:
        reps = -(-streams // zsym.shape[0])
        sw_sym = zsym.repeat(reps, 1)[:streams].contiguous()
        sw_buf = zbuf.repeat(reps, 1)[:streams].contiguous()
        sw_lens = zlens.repeat(reps)[:streams].contiguous()
        single_sweep[f"{streams}x{n_z}"] = {
            "encode_ms_graph": [graph_ms(lambda: cc.encode_single_row(
                sw_sym, zcdf, zmeta, zbuf.shape[1])) for _ in range(2)],
            "decode_ms_graph": [graph_ms(lambda: cc.decode_single_row(
                sw_buf, sw_lens, n_z, zcdf, zmeta, z_slots))
                for _ in range(2)]}
        del sw_sym, sw_buf, sw_lens
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
            zb256, zl256, n_z, zcdf, zmeta, z_slots), 20),
    }
    e2e_ms = {}
    for name, img in images.items():
        # The classic containers' e2e ms are phase 4g's.
        e2e_ms[f"native/{name}"] = e2e_times(codec.compress_native,
                                             codec.decompress, img)
        e2e_ms[f"bmshj2018/native/{name}"] = e2e_times(
            hcodec.compress_native, hcodec.decompress, img)
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
        decode_indexed_variants_ms=indexed_ms,
        decode_indexed_streams_ms=indexed_sweep,
        warp_decode_max_streams=cc.WARP_DECODE_MAX_STREAMS,
        encode_scan_variants_ms=scan_ms, encode_scan_streams_ms=scan_sweep,
        warp_encode_max_streams=cc.WARP_ENCODE_MAX_STREAMS,
        encode_symbols_variants_ms=symbol_ms,
        encode_symbols_streams_ms=symbol_sweep,
        single_row_variants_ms=single_ms, single_row_streams_ms=single_sweep,
        sm_clock_mhz=clock, end_to_end=e2e_ms, card=smi)

    launches = {k: native_launches[k] + classic_launches[k]
                + front_launches[k] + hyper_launches[k] + device_launches[k]
                + ms_launches[k] + hific_launches[k]
                + hific_train_launches[k] + tfci_launches[k]
                + universal_launches[k] + parallel_launches[k]
                + example_launches[k]
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
