#!/usr/bin/env python3
"""K8' (decode_single_row_bucketed) beside K5' (decode_single_row) at the
coder micro-bench's 32768 streams x 512 symbols, timed from CUDA graphs.

Two rows: chip_smoke.py's zipf row (alpha 1.2 over 256 symbols at
precision 12: 17 buckets of 16 entries) and a wide one (alpha 1.2 over 1020
symbols at precision 16: 64 buckets).  Prints one JSON line each for:
  * ``check``: per row, K8' against its plain version (exact products) and
    against K5' on the valid streams, which must decode to the symbols, and
    on four corrupted copies of their first 4096 (chip_smoke.corruptions);
  * ``time``: per row, K8' and K5' from a CUDA graph (chip_smoke.graph_ms,
    two rounds each, in turns);
  * ``variants`` (with ``--variants``): decode_indexed.cu rebuilt with
    kLinearMaxBuckets at 0 (every row binary-searches its bucket-last
    values in shared memory) and at 64 (rows of up to 64 buckets count them
    from registers), one nvcc each, both started together; each checked
    against the wrapper's symbols and flags and timed per row;
  * ``build`` (with ``--sass DIR``): nvcc -Xptxas -v of decode_indexed.cu
    (registers and spills per kernel) and its cuobjdump -sass, written to
    DIR/decode_indexed.ptxas.txt and DIR/decode_indexed.sass;
then the card's name and power limit.  The wrapper's signature is the same
on a checkout from before K8''s redesign, so copy the script into a parent
checkout to time both trees in turns on one card:

    python3 tools/bucketed_decode_probe.py [--variants] [--sass DIR]
"""

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

ROWS = {"zipf_p12": (256, 12), "wide_p16": (1020, 16)}
VARIANTS = (0, 64)
CORRUPT_STREAMS = 4096


def zipf_row(alphabet, precision, device):
    from compression_tpu_torch.codec import tables, torch_coder
    pmf = 1.0 / (1 + np.arange(alphabet)) ** 1.2
    pmf /= pmf.sum()
    return torch_coder.DeviceCdfTable(tables.parse_ragged_cdf(
        tables.build_ragged_cdf([tables.pmf_to_quantized_cdf(pmf, precision)],
                                [precision], [False])), device), pmf


def build_variants():
    """{linear max buckets: ctypes entry} of decode_indexed.cu rebuilt with
    kLinearMaxBuckets at each of VARIANTS."""
    from compression_tpu_torch import native
    from compression_tpu_torch.codec import cuda_coder as cc
    out_dir = os.path.join(native.BUILD_DIR, "bucketed_variants")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(cc.CSRC_DIR, "decode_indexed.cu")) as f:
        source = f.read()
    pattern = r"constexpr int kLinearMaxBuckets = \d+;"
    if len(re.findall(pattern, source)) != 1:
        raise RuntimeError("kLinearMaxBuckets is not in decode_indexed.cu")
    builds = {}
    for linear in VARIANTS:
        src = os.path.join(out_dir, f"decode_indexed_l{linear}.cu")
        with open(src, "w") as f:
            f.write(re.sub(pattern,
                           f"constexpr int kLinearMaxBuckets = {linear};",
                           source))
        builds[linear] = native.start_build(
            [cc._nvcc()] + cc.NVCC_FLAGS + [src], src[:-3] + ".so")
    fns = {}
    entry = "ctpu_decode_single_row_bucketed"
    for linear, b in builds.items():
        native.finish_build(b)
        fn = getattr(ctypes.CDLL(b[2]), entry)
        fn.argtypes = cc._ARGTYPES[entry]
        fn.restype = ctypes.c_int
        fns[linear] = fn
    return fns


def variant_call(fn, buf, lens, n, row):
    """A closure launching ``fn`` (ctpu_decode_single_row_bucketed of one
    build) on the current stream; returns it and its outputs."""
    import torch
    blast, win17, max_pv, precision = row
    sym = torch.empty((buf.shape[0], n), dtype=torch.int32, device=buf.device)
    ok = torch.empty((buf.shape[0],), dtype=torch.bool, device=buf.device)

    def call():
        rc = fn(buf.data_ptr(), buf.shape[1], lens.data_ptr(), buf.shape[0],
                n, blast.data_ptr(), win17.data_ptr(), blast.shape[0], max_pv,
                precision, sym.data_ptr(), ok.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"CUDA error {rc}")
    return call, sym, ok


def dump_build(out_dir):
    """nvcc -Xptxas -v and cuobjdump -sass of decode_indexed.cu."""
    from compression_tpu_torch import native
    from compression_tpu_torch.codec import cuda_coder as cc
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(native.BUILD_DIR, "decode_indexed_ptxas.so")
    ptxas = subprocess.run(
        [cc._nvcc()] + cc.NVCC_FLAGS + ["-Xptxas", "-v",
                                        os.path.join(cc.CSRC_DIR,
                                                     "decode_indexed.cu"),
                                        "-o", lib],
        capture_output=True, text=True, timeout=600, check=True)
    with open(os.path.join(out_dir, "decode_indexed.ptxas.txt"), "w") as f:
        f.write(ptxas.stdout + ptxas.stderr)
    cuobjdump = os.path.join(os.path.dirname(cc._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                          text=True, timeout=600, check=True)
    with open(os.path.join(out_dir, "decode_indexed.sass"), "w") as f:
        f.write(sass.stdout)
    bucketed = [line for line in (ptxas.stdout + ptxas.stderr).splitlines()
                if "bucketed" in line or "Used" in line]
    return {"ptxas_lines": len(bucketed), "sass_bytes": len(sass.stdout)}


def main():
    import torch
    import chip_smoke
    from compression_tpu_torch.codec import cuda_coder as cc, torch_coder
    parser = argparse.ArgumentParser()
    parser.add_argument("--variants", action="store_true")
    parser.add_argument("--sass", default=None)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("bucketed_decode_probe: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    cc.build()
    device = torch.device("cuda")
    streams, n = chip_smoke.SINGLE_ROW_SHAPE
    fns = build_variants() if args.variants else {}
    failed = False
    for label, (alphabet, precision) in ROWS.items():
        table, pmf = zipf_row(alphabet, precision, device)
        cdf, meta = table.indexed_arrays()
        slots = table.single_row_slots()
        row = table.bucketed_arrays()
        sym = torch.as_tensor(np.random.RandomState(0).choice(
            alphabet, size=(streams, n), p=pmf).astype(np.int32),
            device=device)
        buf, lens = cc.encode_single_row(sym, cdf, meta,
                                         torch_coder.stream_out_size(n))
        k8 = lambda b, ln: cc.decode_single_row_bucketed(b, ln, n, *row)
        k5 = lambda b, ln: cc.decode_single_row(b, ln, n, cdf, meta, slots)
        checks = {}
        cases = {"valid": (buf, lens)}
        cases.update(chip_smoke.corruptions(
            buf[:CORRUPT_STREAMS].contiguous(),
            lens[:CORRUPT_STREAMS].contiguous(), 6))
        for case, (b, ln) in cases.items():
            out, ok = k8(b, ln)
            ref, ref_ok = torch.empty_like(out), torch.empty_like(ok)
            cc.decode_single_row_bucketed_plain(b, ln, *row, ref, ref_ok)
            out5, ok5 = k5(b, ln)
            same = bool(torch.equal(out, ref) and torch.equal(ok, ref_ok))
            agree = bool(torch.equal(out, out5) and torch.equal(ok, ok5))
            entry = {"plain": same, "k5": agree,
                     "flagged": int((~ok).sum())}
            if case == "valid":
                entry["round_trip"] = bool(torch.equal(out, sym)
                                           and ok.all())
                same &= entry["round_trip"] and agree
            for linear, fn in fns.items():
                call, vsym, vok = variant_call(fn, b, ln, n, row)
                call()
                torch.cuda.synchronize()
                entry[f"linear{linear}"] = bool(torch.equal(vsym, out)
                                                and torch.equal(vok, ok))
                same &= entry[f"linear{linear}"]
            checks[case] = entry
            failed |= not same
        print(json.dumps({"check": label, "buckets": int(row[0].shape[0]),
                          "max_len": int(cdf.shape[1]),
                          "precision": precision, **checks}), flush=True)
        times = {"k8_ms_graph": [], "k5_ms_graph": []}
        for _ in range(2):
            times["k8_ms_graph"].append(chip_smoke.graph_ms(
                lambda: k8(buf, lens)))
            times["k5_ms_graph"].append(chip_smoke.graph_ms(
                lambda: k5(buf, lens)))
        for linear, fn in fns.items():
            call, _, _ = variant_call(fn, buf, lens, n, row)
            times[f"linear{linear}_ms_graph"] = [chip_smoke.graph_ms(call)
                                                 for _ in range(2)]
        print(json.dumps({"time": label, "shape": [streams, n], **times}),
              flush=True)
    if args.sass:
        print(json.dumps({"build": dump_build(args.sass)}), flush=True)
    print(chip_smoke.nvidia_smi_line(), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
