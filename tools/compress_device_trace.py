#!/usr/bin/env python3
"""Where the time of ``compress_device`` goes, by torch.profiler.

Runs ``LocationScaleIndexedEntropyModel.compress_device`` of bmshj2018's y
at chip_smoke.py's width, seed and first image, a few times after warm-up:
first on the host clock alone (work ending in a synchronize), then under
torch.profiler.  Prints one JSON line: the host-clock ms per call, the
device time per call of every kernel and copy the trace shows (name,
launches and ms per call), their sum (the card's busy time: one stream, so
nothing overlaps), the host-clock ms less that sum, and the host operators
with the most self time per call.  Run on a machine with an NVIDIA GPU,
from the root of a checkout (copy the file into another checkout to trace
that one):

    python3 tools/compress_device_trace.py
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

RUNS = 5


def _device_us(event):
    """Device time of a kernel, copy or memset; 0 for a host event (an
    operator's own entry repeats its kernels' time)."""
    from torch.autograd import DeviceType
    if event.device_type == DeviceType.CPU:
        return 0.0
    return event.self_device_time_total


def main(device="cuda", num_filters=None, shape=None):
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from compression_tpu_torch.models import bmshj2018

    first = next(iter(chip_smoke.IMAGES))
    codec = bmshj2018.BMSHJ2018Codec(bmshj2018.BMSHJ2018Model(
        num_filters=num_filters or chip_smoke.BMSHJ_FILTERS, seed=0),
        device=device)
    img = np.random.RandomState(0).randint(
        0, 256, shape or chip_smoke.IMAGES[first]).astype(np.uint8)
    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    with torch.no_grad():
        y, _, idx, _ = codec._encode(codec._upload(img))

        def run():
            codec.em.compress_device(y, idx)

        for _ in range(2):
            run()
        wall_ms = []
        for _ in range(RUNS):
            sync()
            t0 = time.perf_counter()
            run()
            sync()
            wall_ms.append((time.perf_counter() - t0) * 1e3)
        activities = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if on_card else [])
        with profile(activities=activities) as prof:
            for _ in range(RUNS):
                run()
            sync()
    averages = prof.key_averages()
    device = sorted(
        ({"name": e.key[:80], "launches": e.count / RUNS,
          "ms": _device_us(e) / RUNS / 1e3}
         for e in averages if _device_us(e) > 0), key=lambda r: -r["ms"])
    host = sorted(
        ({"name": e.key[:80], "calls": e.count / RUNS,
          "self_ms": e.self_cpu_time_total / RUNS / 1e3}
         for e in averages), key=lambda r: -r["self_ms"])[:15]
    busy = sum(r["ms"] for r in device)
    print(json.dumps({
        "call": f"bmshj2018 y compress_device, {first}, seed 0",
        "wall_ms": wall_ms, "wall_ms_median": float(np.median(wall_ms)),
        "device_ms_per_call": busy,
        "idle_ms_per_call": float(np.median(wall_ms)) - busy,
        "device": device, "host_self": host,
        "card": chip_smoke.nvidia_smi_line() if on_card else None}))


if __name__ == "__main__":
    main()
