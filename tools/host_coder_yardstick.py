#!/usr/bin/env python3
"""The host C coder as a yardstick for the port's micro-op scan.

Codes the y stream of bmshj2018 at chip_smoke.py's width, seed and first
image (one stream of 196608 symbols on the 64-row scale table) with the JAX
package's native host coder (``compression_tpu.codec.host.encode_streams``)
on one host thread, checks its bytes against the port's, and times it.
chip_smoke.py times the port's scan kernels on the same stream.  Run on a
machine with an NVIDIA GPU, from the root of a checkout:

    python3 tools/host_coder_yardstick.py

The JAX package's ``__init__`` imports JAX; only its framework-free host
coder is needed here, so the package is entered without running it.  The
port itself never imports the JAX package.  Prints one JSON line.
"""

import importlib
import json
import os
import platform
import sys
import time
import types

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def host_coder():
    """compression_tpu.codec.host and .tables, without the package's
    __init__ (which imports JAX)."""
    for name in ("compression_tpu", "compression_tpu.codec"):
        if name not in sys.modules:
            pkg = types.ModuleType(name)
            pkg.__path__ = [os.path.join(REPO, *name.split("."))]
            sys.modules[name] = pkg
    host = importlib.import_module("compression_tpu.codec.host")
    tables = importlib.import_module("compression_tpu.codec.tables")
    if not host.available():
        raise RuntimeError("the host C coder did not build: no yardstick")
    return host, tables


def cpu_name():
    """The machine and /proc/cpuinfo's vendor and model name fields."""
    fields = {}
    with open("/proc/cpuinfo") as f:
        for line in f:
            key, _, value = line.partition(":")
            fields.setdefault(key.strip(), value.strip())
    return " / ".join([platform.machine()] + [
        fields.get(k, "unknown") for k in ("vendor_id", "model name")])


def main():
    import torch
    import chip_smoke
    from compression_tpu_torch.models import bmshj2018

    host, jax_tables = host_coder()
    codec = bmshj2018.BMSHJ2018Codec(
        bmshj2018.BMSHJ2018Model(num_filters=chip_smoke.BMSHJ_FILTERS, seed=0),
        device="cuda")
    first = next(iter(chip_smoke.IMAGES))
    img = np.random.RandomState(0).randint(
        0, 256, chip_smoke.IMAGES[first]).astype(np.uint8)
    with torch.no_grad():
        y, _, idx, _ = codec._encode(codec._upload(img))
        sym, rows, _ = codec.em._symbols(y, idx)
        port_bytes, port_len = codec.em.compress(y, idx)
    t = codec.em.device_table.host
    table = jax_tables.CdfTable(np.asarray(t.cdf), np.asarray(t.length),
                                np.asarray(t.precision),
                                np.asarray(t.overflow))
    values = sym.cpu().numpy().astype(np.int32)
    index = rows.cpu().numpy().astype(np.int32)
    stream = host.encode_streams(values, table, index, num_threads=1)[0]
    port = port_bytes.reshape(-1)[: int(port_len.reshape(-1)[0])]
    host_ms = []
    for _ in range(7):
        t0 = time.perf_counter()
        host.encode_streams(values, table, index, num_threads=1)
        host_ms.append((time.perf_counter() - t0) * 1e3)
    print(json.dumps({
        "stream": f"bmshj2018 y, {first}, "
                  f"{chip_smoke.BMSHJ_FILTERS} filters, seed 0",
        "symbols": int(values.shape[1]), "host_bytes": len(stream),
        "host_bytes_equal_port": stream == port.cpu().numpy().tobytes(),
        "host_ms_one_thread": host_ms,
        "host_ms_median": float(np.median(host_ms)),
        "host_msym_per_s": values.shape[1] / np.median(host_ms) / 1e3,
        "host_cpu": cpu_name(),
        "card": chip_smoke.nvidia_smi_line()}))


if __name__ == "__main__":
    main()
