#!/usr/bin/env python3
"""The single-row pair, K4' (encode_single_row) and K5' (decode_single_row),
timed from CUDA graphs.

Prints one JSON line each for:
  * ``sweep``: both wrappers at 1 ... 65536 streams of 512 symbols of
    chip_smoke.py's zipf row (alpha 1.2 over 256 symbols at precision 12),
    the coder micro-bench regime, from a CUDA graph (chip_smoke.graph_ms,
    two rounds);
  * ``precision16``: the same at 32768 x 512 on the zipf row at precision 16
    (K5''s 128 KB table of counts);
  * ``geometry`` (with ``--geometry``): both kernels rebuilt with 32, 64,
    128 and 256 threads a block (the constants kSingleRowThreads in
    codec/csrc/decode_indexed.cu and kEncodeRowThreads in encode_indexed.cu
    rewritten in copies under the package's build directory, one nvcc each,
    all started together) and timed at 32768 x 512, after checking that
    their bytes and symbols equal the wrappers';
then the card's name and power limit.  Before timing, the wrappers' results
at 32768 x 512 are held against the plain versions.  The script runs on
any checkout that has chip_smoke.py and the port (also one from before the
slot table, whose decode_single_row takes no ``slots``), so that two trees
can be timed in turns on one card:

    python3 tools/single_row_sweep.py [--geometry]
"""

import argparse
import ctypes
import inspect
import json
import os
import re
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

THREADS = (32, 64, 128, 256)
CONSTANTS = {"decode_indexed": "kSingleRowThreads",
             "encode_indexed": "kEncodeRowThreads"}


def zipf_table(precision, device):
    from compression_tpu_torch.codec import tables, torch_coder
    pmf = 1.0 / (1 + np.arange(256)) ** 1.2
    pmf /= pmf.sum()
    return torch_coder.DeviceCdfTable(tables.parse_ragged_cdf(
        tables.build_ragged_cdf([tables.pmf_to_quantized_cdf(pmf, precision)],
                                [precision], [False])), device), pmf


def calls(table, sym):
    """(encode call, decode call, bytes, lengths) on these symbols by the
    wrappers, the table's cached slot table passed where the tree has it."""
    import torch
    from compression_tpu_torch.codec import cuda_coder as cc, torch_coder
    cdf, meta = table.indexed_arrays()
    n = int(sym.shape[1])
    width = torch_coder.stream_out_size(n)
    extra = ((table.single_row_slots(),)
             if "slots" in inspect.signature(cc.decode_single_row).parameters
             else ())
    buf, lens = cc.encode_single_row(sym, cdf, meta, width)
    torch.cuda.synchronize()
    return (lambda: cc.encode_single_row(sym, cdf, meta, width),
            lambda: cc.decode_single_row(buf, lens, n, cdf, meta, *extra),
            buf, lens)


def build_geometry():
    """{threads: (encode fn, decode fn)} of both sources at each count."""
    from compression_tpu_torch import native
    from compression_tpu_torch.codec import cuda_coder as cc
    out_dir = os.path.join(native.BUILD_DIR, "single_row_threads")
    os.makedirs(out_dir, exist_ok=True)
    builds = {}
    for name, constant in CONSTANTS.items():
        with open(os.path.join(cc.CSRC_DIR, name + ".cu")) as f:
            source = f.read()
        pattern = rf"constexpr int {constant} = \d+;"
        if len(re.findall(pattern, source)) != 1:
            raise RuntimeError(f"{constant} is not in {name}.cu")
        for threads in THREADS:
            src = os.path.join(out_dir, f"{name}_t{threads}.cu")
            with open(src, "w") as f:
                f.write(re.sub(pattern,
                               f"constexpr int {constant} = {threads};",
                               source))
            builds[name, threads] = native.start_build(
                [cc._nvcc()] + cc.NVCC_FLAGS + [src], src[:-3] + ".so")
    fns = {}
    for (name, threads), b in builds.items():
        native.finish_build(b)
        entry = "ctpu_" + name.split("_")[0] + "_single_row"
        fn = getattr(ctypes.CDLL(b[2]), entry)
        fn.argtypes = cc._ARGTYPES[entry]
        fn.restype = ctypes.c_int
        fns.setdefault(threads, {})[name] = fn
    return fns


def geometry_rows(table, sym, buf, lens):
    import torch
    import chip_smoke
    from compression_tpu_torch.codec import cuda_coder as cc, torch_coder
    cdf, meta = table.indexed_arrays()
    slots, precision = table.single_row_slots()
    streams, n = (int(d) for d in sym.shape)
    width = torch_coder.stream_out_size(n)
    want_sym, want_ok = cc.decode_single_row(buf, lens, n, cdf, meta,
                                             (slots, precision))
    row = {"shape": [streams, n]}
    for threads, fns in build_geometry().items():
        out = torch.empty_like(buf)
        out_len = torch.empty_like(lens)
        dsym = torch.empty_like(want_sym)
        dok = torch.empty_like(want_ok)
        stream = lambda: torch.cuda.current_stream().cuda_stream

        def enc():
            rc = fns["encode_indexed"](
                sym.data_ptr(), streams, n, cdf.data_ptr(), meta.data_ptr(),
                cdf.shape[1], out.data_ptr(), width, out_len.data_ptr(),
                stream())
            if rc != 0:
                raise RuntimeError(f"{threads} threads: CUDA error {rc}")

        def dec():
            rc = fns["decode_indexed"](
                buf.data_ptr(), buf.shape[1], lens.data_ptr(), streams, n,
                slots.data_ptr(), slots.numel(), precision, cdf.shape[1],
                dsym.data_ptr(), dok.data_ptr(), stream())
            if rc != 0:
                raise RuntimeError(f"{threads} threads: CUDA error {rc}")

        enc()
        dec()
        torch.cuda.synchronize()
        if not (torch.equal(out, buf) and torch.equal(out_len, lens)
                and torch.equal(dsym, want_sym) and torch.equal(dok, want_ok)):
            raise RuntimeError(f"{threads} threads a block differ from the "
                               "wrappers")
        row[f"t{threads}_encode_ms_graph"] = [chip_smoke.graph_ms(enc)
                                              for _ in range(2)]
        row[f"t{threads}_decode_ms_graph"] = [chip_smoke.graph_ms(dec)
                                              for _ in range(2)]
    return row


def main():
    import torch
    import chip_smoke
    from compression_tpu_torch.codec import cuda_coder as cc
    parser = argparse.ArgumentParser()
    parser.add_argument("--geometry", action="store_true")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("single_row_sweep: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    cc.build()
    device = torch.device("cuda")
    streams, n = chip_smoke.SINGLE_ROW_SHAPE
    for precision in (12, 16):
        table, pmf = zipf_table(precision, device)
        sym = torch.as_tensor(np.random.RandomState(0).choice(
            256, size=(streams, n), p=pmf).astype(np.int32), device=device)
        enc, dec, buf, lens = calls(table, sym)
        cdf, meta = table.indexed_arrays()
        ref_buf, ref_lens = torch.empty_like(buf), torch.empty_like(lens)
        cc.encode_single_row_plain(sym, cdf, meta, ref_buf, ref_lens)
        dsym, dok = dec()
        if not (torch.equal(buf, ref_buf) and torch.equal(lens, ref_lens)
                and torch.equal(dsym, sym) and bool(dok.all())):
            raise RuntimeError(f"precision {precision}: the kernels differ "
                               "from the plain version")
        if precision == 16:
            print(json.dumps({"precision16": [streams, n],
                              "encode_ms_graph": [chip_smoke.graph_ms(enc)
                                                  for _ in range(2)],
                              "decode_ms_graph": [chip_smoke.graph_ms(dec)
                                                  for _ in range(2)]}),
                  flush=True)
            continue
        for count in chip_smoke.SWEEP_STREAMS:
            reps = -(-count // streams)
            s_sym = sym.repeat(reps, 1)[:count].contiguous()
            s_enc, s_dec, _, _ = calls(table, s_sym)
            print(json.dumps({"sweep": [count, n],
                              "encode_ms_graph": [chip_smoke.graph_ms(s_enc)
                                                  for _ in range(2)],
                              "decode_ms_graph": [chip_smoke.graph_ms(s_dec)
                                                  for _ in range(2)]}),
                  flush=True)
        if args.geometry:
            print(json.dumps({"geometry": geometry_rows(table, sym, buf,
                                                        lens)}), flush=True)
    print(chip_smoke.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
