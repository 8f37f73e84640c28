#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (compression_tpu_torch) on one GPU.

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases, one line each (any failure exits non-zero):
  1. card: nvidia-smi name and power limit, torch/CUDA versions, TF32 flags;
  2. build: nvcc builds every kernel under compression_tpu_torch/codec/csrc;
  3. kernels: each kernel against its plain PyTorch version on the card, at
     the main-path shapes, on a stress shape, on every golden case of
     tests/golden/golden.npz (bytes equal the reference coder's) and on
     corrupted streams -- all results must be identical;
  4. main path: bls2017 at num_filters=128 (seeded init, its own tables) on
     a 512x512 and a 768x512 image through compress_native / decompress /
     reconstruct / compress_native_many / decompress_native_many, with the
     launch counts reset just before and read just after;
  5. times: kernels and plain versions at the main-path shapes (CUDA
     events), their bounds, and end-to-end ms per image.

The line before the last two is {"kernels": [...]}, then the card's name and
power limit, and the last line is {"ok": true, "device": {...}}.  Nothing of
JAX is imported: on the card the port is compared only with itself and with
the reference coder's golden bytes.
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
# (256 streams x 512 symbols) and a Kodak-size 768x512 one (512 x 384).
DEVICE = "cuda:0"
NUM_FILTERS = 128
IMAGES = {"512x512": (512, 512, 3), "768x512": (512, 768, 3)}
STRESS_SHAPE = (8192, 512)


def log(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters):
    """Mean ms per call of fn over iters calls, by CUDA events."""
    import torch
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


#: Largest |kernel - plain| seen per kernel over every comparison.
MAX_ABS_ERR = {"encode_indexed": 0, "decode_indexed": 0}


def _err(*pairs):
    return max((int((a.long() - b.long()).abs().max()) if a.numel() else 0)
               for a, b in pairs)


def compare_kernels(name, table, symbols, indexes, out_size, fails):
    """K1 and K2 against their plain versions on one input; returns the
    kernel's (bytes, lengths)."""
    import torch
    from compression_tpu_torch.codec import cuda_coder
    cdf, meta = table.indexed_arrays()
    out_k, len_k = cuda_coder.encode_indexed(
        symbols, indexes, cdf, meta, out_size)
    torch.cuda.synchronize()
    out_p = torch.empty_like(out_k)
    len_p = torch.empty_like(len_k)
    cuda_coder.encode_indexed_plain(symbols, indexes, cdf, meta, out_p,
                                    len_p)
    enc_ok = bool(torch.equal(out_k, out_p) and torch.equal(len_k, len_p))
    MAX_ABS_ERR["encode_indexed"] = max(MAX_ABS_ERR["encode_indexed"], _err(
        (out_k, out_p), (len_k, len_p)))
    sym_k, san_k = cuda_coder.decode_indexed(out_k, len_k, indexes, cdf, meta)
    torch.cuda.synchronize()
    sym_p = torch.empty_like(sym_k)
    san_p = torch.empty_like(san_k)
    cuda_coder.decode_indexed_plain(out_k, len_k, indexes, cdf, meta, sym_p,
                                    san_p)
    dec_ok = bool(torch.equal(sym_k, sym_p) and torch.equal(san_k, san_p))
    MAX_ABS_ERR["decode_indexed"] = max(MAX_ABS_ERR["decode_indexed"], _err(
        (sym_k, sym_p), (san_k, san_p)))
    log("kernels", case=name, streams=int(symbols.shape[0]),
        symbols=int(symbols.shape[1]), rows=int(cdf.shape[0]),
        max_precision=int(meta[:, 1].max()), encode_identical=enc_ok,
        decode_identical=dec_ok, sanity_all=bool(san_k.all()))
    if not (enc_ok and dec_ok and bool(san_k.all())):
        fails.append(name)
    return out_k, len_k


def golden_cases(table_cls, device, fails):
    """Every golden.npz case: kernel bytes == reference bytes == plain."""
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
        out_size = torch_coder.sidecar_out_size(sym.shape[1])
        fails_here = []
        out, lens = compare_kernels(f"golden/{name}", table, sym, idx,
                                    out_size, fails_here)
        ref = gold[f"{name}__bytes"].tobytes()
        got = out[0, : int(lens[0])].cpu().numpy().tobytes()
        dec, san = torch_coder.decode_dispatch(out, lens, sym.shape[1], table,
                                               idx)
        if fails_here or got != ref or not torch.equal(dec, sym) \
                or not bool(san.all()):
            bad.append(name)
    log("golden", cases=len(names), mismatched=bad)
    fails.extend(f"golden/{b}" for b in bad)


def corrupt_cases(table, buf, lens, indexes, fails):
    """Sanity flags and symbols of K2 equal the plain version's on
    truncated, bit-flipped, random and empty streams."""
    import torch
    from compression_tpu_torch.codec import cuda_coder
    cdf, meta = table.indexed_arrays()
    gen = torch.Generator(device=buf.device).manual_seed(5)
    cases = {
        "truncated": (buf, torch.clamp(lens // 2, min=0)),
        "bitflip": (buf ^ (torch.rand(buf.shape, generator=gen,
                                      device=buf.device) < 0.002).to(
                                          torch.uint8) * 16, lens),
        "random": (torch.randint(0, 256, buf.shape, generator=gen,
                                 device=buf.device, dtype=torch.uint8), lens),
        "empty": (torch.zeros_like(buf), torch.zeros_like(lens)),
    }
    detected = {}
    for name, (b, ln) in cases.items():
        # Bytes past a truncated length are zero in a real container.
        cols = torch.arange(b.shape[1], device=b.device)
        b = torch.where(cols[None, :] < ln[:, None].long(), b, 0).to(
            torch.uint8).contiguous()
        sym_k, san_k = cuda_coder.decode_indexed(b, ln.contiguous(), indexes,
                                                 cdf, meta)
        torch.cuda.synchronize()
        sym_p = torch.empty_like(sym_k)
        san_p = torch.empty_like(san_k)
        cuda_coder.decode_indexed_plain(b, ln.contiguous(), indexes, cdf,
                                        meta, sym_p, san_p)
        if not (torch.equal(sym_k, sym_p) and torch.equal(san_k, san_p)):
            fails.append(f"corrupt/{name}")
        MAX_ABS_ERR["decode_indexed"] = max(
            MAX_ABS_ERR["decode_indexed"],
            _err((sym_k, sym_p), (san_k, san_p)))
        detected[name] = int((~san_k).sum())
    log("corrupt", streams=int(buf.shape[0]), flagged=detected,
        identical=not any(f.startswith("corrupt/") for f in fails))


def encode_bound(symbols, cdf, meta, out_size):
    """Least time (ms) for K1: each input read once, each output written
    once, against ~12 scalar operations per symbol (two 64-bit products,
    two shifts, four adds, three compares, the escape select)."""
    s, n = symbols.shape
    nbytes = (2 * s * n * 4 + cdf.numel() * 4 + meta.numel() * 4
              + s * out_size + s * 4)
    ops = 12 * s * n
    return _bound(nbytes, ops)


def decode_bound(buf, lens, indexes, cdf, meta):
    """Least time (ms) for K2: input bytes actually present (the streams'
    lengths), indexes and table read once, symbols and flags written once;
    ~2 operations per binary-search probe plus ~10 for the update."""
    s, n = indexes.shape
    nbytes = (int(lens.sum()) + s * 4 + s * n * 4 + cdf.numel() * 4
              + meta.numel() * 4 + s * n * 4 + s)
    probes = math.ceil(math.log2(max(cdf.shape[1] - 1, 2)))
    ops = (2 * probes + 10) * s * n
    return _bound(nbytes, ops)


def _bound(nbytes, ops):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_SCALAR_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations")


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
    from compression_tpu_torch.codec import cuda_coder, torch_coder
    from compression_tpu_torch.models import bls2017, native_format

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
    libs = cuda_coder.build()
    log("build", seconds=round(time.time() - t0, 3), libraries=sorted(libs))

    fails = []
    # The codec first: its entropy model gives the main-path table.
    t0 = time.time()
    model = bls2017.BLS2017Model(num_filters=NUM_FILTERS, seed=0)
    codec = bls2017.BLS2017Codec(model, device=device)
    table = codec.em.device_table
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
    main_inputs = {}
    with torch.no_grad():
        for name, img in images.items():
            y = codec._analysis(codec._upload(img))
            symbols, _, row_ids = codec.em._symbols_from_bottleneck(
                native_format.to_streams(y))
            idx = row_ids.to(torch.int32)[None].expand_as(symbols).contiguous()
            out_size = torch_coder.sidecar_out_size(symbols.shape[1])
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
                        torch_coder.sidecar_out_size(n), fails)
        stress_input = (sym, idx, st, torch_coder.sidecar_out_size(n))
    golden_cases(torch_coder.DeviceCdfTable, device, fails)
    symbols, idx, _, buf, lens = main_inputs[first]
    corrupt_cases(table, buf, lens, idx, fails)

    # Phase 4: the main path, with launch counts from this run only.
    for k in cuda_coder.LAUNCHES:
        cuda_coder.LAUNCHES[k] = 0
    torch_coder.DISPATCH_LOG.clear()
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
    torch.cuda.synchronize()
    launches = dict(cuda_coder.LAUNCHES)
    paths = {k: torch_coder.DISPATCH_LOG.get(k)
             for k in ("encode", "decode_sidecar")}
    log("main_path_many", images=len(batch), containers_equal=many_ok,
        launches=launches, dispatch=paths)
    if not (main_ok and many_ok and all(v > 0 for v in launches.values())
            and set(paths.values()) == {"cuda-indexed"}):
        fails.append("main_path")

    # Escapes through the codec: a latent scaled to twice the table's width
    # codes its tails in the sidecar and decodes to its quantization.
    with torch.no_grad():
        y = codec._analysis(codec._upload(images[first]))
        scale = 2.0 * table.max_len / float(y.abs().max())
        y = scale * y
        cont = codec._container(codec._encode_latent(y), IMAGES[first][:2])
        y_hat, sanity, _ = codec._decode_latent(codec._unpack(cont))
        esc_ok = bool(torch.equal(y_hat, codec.em.quantize(y))
                      and sanity.all())
        n_esc = len(codec._unpack(cont).unpack(
            ["bytes", np.int32, np.int32, np.int32, np.int32])[4])
    log("main_path_escapes", image=first, latent_scale=scale, escapes=n_esc,
        decode_equals_quantize=esc_ok)
    if not esc_ok or n_esc == 0:
        fails.append("main_path_escapes")

    # Reference on a small input: the CPU codec (plain coder) given the
    # same latent and tables writes the same container.
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
    small_ok = c_gpu == c_cpu and torch.equal(y_gpu.cpu(), y_cpu) and bool(
        torch.isfinite(y_cpu).all())
    log("reference_small", image="64x96", containers_identical=c_gpu == c_cpu,
        cross_decode_identical=bool(torch.equal(y_gpu.cpu(), y_cpu)))
    if not small_ok:
        fails.append("reference_small")

    # Phase 5: times at the main-path shape (the first image).
    cdf, meta = table.indexed_arrays()
    symbols, idx, out_size, buf, lens = main_inputs[first]
    saved = dict(cuda_coder.LAUNCHES)
    out_p = torch.empty_like(buf)
    len_p = torch.empty_like(lens)
    sym_p = torch.empty_like(symbols)
    san_p = torch.empty((symbols.shape[0],), dtype=torch.bool, device=device)
    k1_ms = cuda_ms(lambda: cuda_coder.encode_indexed(
        symbols, idx, cdf, meta, out_size), 50)
    k1_plain = cuda_ms(lambda: cuda_coder.encode_indexed_plain(
        symbols, idx, cdf, meta, out_p, len_p), 3)
    k2_ms = cuda_ms(lambda: cuda_coder.decode_indexed(
        buf, lens, idx, cdf, meta), 50)
    k2_plain = cuda_ms(lambda: cuda_coder.decode_indexed_plain(
        buf, lens, idx, cdf, meta, sym_p, san_p), 3)
    k1_bound, k1_by = encode_bound(symbols, cdf, meta, out_size)
    k2_bound, k2_by = decode_bound(buf, lens, idx, cdf, meta)
    e2e_ms = {}
    for name, img in images.items():
        codec.compress_native(img)  # warm
        comp, dec = [], []
        for _ in range(10):
            t0 = time.perf_counter()
            container = codec.compress_native(img)
            torch.cuda.synchronize()
            comp.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            codec.decompress(container)
            torch.cuda.synchronize()
            dec.append((time.perf_counter() - t0) * 1e3)
        e2e_ms[name] = {"compress_ms_median": float(np.median(comp)),
                        "compress_ms_max": max(comp),
                        "decompress_ms_median": float(np.median(dec)),
                        "decompress_ms_max": max(dec), "runs": 10}
    # The kernels' time as streams grow: the stress shape, 32x the streams.
    st_sym, st_idx, st_table, st_out_size = stress_input
    st_cdf, st_meta = st_table.indexed_arrays()
    st_buf, st_lens = cuda_coder.encode_indexed(st_sym, st_idx, st_cdf,
                                                st_meta, st_out_size)
    stress_ms = {
        "encode_indexed": cuda_ms(lambda: cuda_coder.encode_indexed(
            st_sym, st_idx, st_cdf, st_meta, st_out_size), 10),
        "decode_indexed": cuda_ms(lambda: cuda_coder.decode_indexed(
            st_buf, st_lens, st_idx, st_cdf, st_meta), 10)}
    cuda_coder.LAUNCHES.update(saved)
    log("times", shape=[int(symbols.shape[0]), int(symbols.shape[1])],
        kernel_ms={"encode_indexed": k1_ms, "decode_indexed": k2_ms},
        plain_ms={"encode_indexed": k1_plain, "decode_indexed": k2_plain},
        stress_shape=list(st_sym.shape), stress_kernel_ms=stress_ms,
        end_to_end=e2e_ms, card=smi)

    kernels = [
        {"name": "encode_indexed", "route": "cuda",
         "source": "compression_tpu_torch/codec/csrc/encode_indexed.cu",
         "replaces": "compression_tpu/codec/pallas_coder.py:1819",
         "launches": launches["encode_indexed"],
         "max_abs_err": MAX_ABS_ERR["encode_indexed"],
         "ms": k1_ms, "plain_ms": k1_plain, "bound_ms": k1_bound,
         "bound_by": k1_by, "library_ms": None},
        {"name": "decode_indexed", "route": "cuda",
         "source": "compression_tpu_torch/codec/csrc/decode_indexed.cu",
         "replaces": "compression_tpu/codec/pallas_coder.py:1259",
         "launches": launches["decode_indexed"],
         "max_abs_err": MAX_ABS_ERR["decode_indexed"],
         "ms": k2_ms, "plain_ms": k2_plain, "bound_ms": k2_bound,
         "bound_by": k2_by, "library_ms": None},
    ]
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
