#!/usr/bin/env python3
"""K2's warp-per-stream kernel at 2, 4 and 8 warps a block.

The warps a block of K2's warp kernel are a constant of its source
(``kIndexedWarpsPerBlock`` in ``codec/csrc/decode_indexed.cu``).  This
script builds the source once for each count (the constant rewritten in a
copy under the package's build directory, one nvcc each, all started
together), records the K2 launches of ``decompress`` of a native container
for bls2017 and bmshj2018 at chip_smoke.py's widths, seed and images, and
replays each launch on each build from a CUDA graph (``chip_smoke.graph_ms``,
two rounds), after checking that its symbols and sanity equal
``cuda_coder.decode_indexed_warp``'s.  Prints one JSON line a launch and
the card's name and power limit.  Run on a machine with an NVIDIA GPU, from
the root of a checkout:

    python3 tools/indexed_warp_geometry.py
"""

import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

WARPS = (2, 4, 8)
CONSTANT = "constexpr int kIndexedWarpsPerBlock = 4;"


def build_variants():
    """{warps: ctypes library} of decode_indexed.cu at each count."""
    import ctypes
    from compression_tpu_torch import native
    from compression_tpu_torch.codec import cuda_coder as cc
    with open(os.path.join(cc.CSRC_DIR, "decode_indexed.cu")) as f:
        source = f.read()
    if source.count(CONSTANT) != 1:
        raise RuntimeError(f"{CONSTANT!r} is not in decode_indexed.cu")
    out_dir = os.path.join(native.BUILD_DIR, "indexed_warps")
    os.makedirs(out_dir, exist_ok=True)
    builds = {}
    for warps in WARPS:
        src = os.path.join(out_dir, f"decode_indexed_w{warps}.cu")
        with open(src, "w") as f:
            f.write(source.replace(
                CONSTANT, f"constexpr int kIndexedWarpsPerBlock = {warps};"))
        builds[warps] = native.start_build(
            [cc._nvcc()] + cc.NVCC_FLAGS + [src], src[:-3] + ".so")
    libs = {}
    for warps, b in builds.items():
        native.finish_build(b)
        lib = ctypes.CDLL(b[2])
        fn = lib.ctpu_decode_indexed_warp
        fn.argtypes = cc._ARGTYPES["ctpu_decode_indexed_warp"]
        fn.restype = ctypes.c_int
        libs[warps] = fn
    return libs


def record_launches():
    """[(label, args of decode_indexed)] of every K2 launch of a native
    decompress, both models, both images."""
    import torch
    import chip_smoke
    from compression_tpu_torch.codec import cuda_coder as cc
    from compression_tpu_torch.models import bls2017, bmshj2018
    launches = []
    wrapped = cc.decode_indexed

    def recorder(*args):
        launches.append((label, tuple(
            a.clone() if isinstance(a, torch.Tensor) else a for a in args)))
        return wrapped(*args)

    codecs = {
        "bls2017": bls2017.BLS2017Codec(bls2017.BLS2017Model(
            num_filters=chip_smoke.NUM_FILTERS, seed=0), device="cuda"),
        "bmshj2018": bmshj2018.BMSHJ2018Codec(bmshj2018.BMSHJ2018Model(
            num_filters=chip_smoke.BMSHJ_FILTERS, seed=0), device="cuda")}
    for model_name, codec in codecs.items():
        for img_name, shape in chip_smoke.IMAGES.items():
            img = np.random.RandomState(0).randint(
                0, 256, shape).astype(np.uint8)
            container = codec.compress_native(img)
            label = f"{model_name}/{img_name}"
            cc.decode_indexed = recorder
            try:
                codec.decompress(container)
            finally:
                cc.decode_indexed = wrapped
    return launches


def main():
    import torch
    import chip_smoke
    from compression_tpu_torch.codec import cuda_coder as cc
    if not torch.cuda.is_available():
        print("indexed_warp_geometry: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    libs = build_variants()
    for label, (buf, lens, idx, cdf, meta, layout) in record_launches():
        want, want_ok = cc.decode_indexed_warp(buf, lens, idx, cdf, meta,
                                               layout)
        streams, n = idx.shape
        row = {"launch": label, "shape": [int(streams), int(n)],
               "container_width": int(buf.shape[1])}
        for warps, fn in libs.items():
            out = torch.empty_like(want)
            ok = torch.empty_like(want_ok)

            def call():
                rc = fn(buf.data_ptr(), buf.shape[1], lens.data_ptr(),
                        idx.data_ptr(), streams, n, layout.data_ptr(),
                        layout.numel(), cdf.shape[0], cdf.shape[1],
                        out.data_ptr(), ok.data_ptr(),
                        torch.cuda.current_stream().cuda_stream)
                if rc != 0:
                    raise RuntimeError(f"{warps} warps: CUDA error {rc}")

            call()
            torch.cuda.synchronize()
            if not (torch.equal(out, want) and torch.equal(ok, want_ok)):
                raise RuntimeError(f"{label}: {warps} warps a block differ "
                                   "from decode_indexed_warp")
            row[f"w{warps}_ms_graph"] = [chip_smoke.graph_ms(call)
                                         for _ in range(2)]
        print(json.dumps(row), flush=True)
    print(chip_smoke.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
