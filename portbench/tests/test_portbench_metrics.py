"""The per-layer readers on hand-made traces."""

from __future__ import annotations

import numpy as np
import pytest

from portbench import counts
from portbench import harness
from portbench import trace as trace_lib

from compression_tpu_torch.util.packed_tensors import PackedTensors

K3 = "void (anonymous namespace)::decode_symbols_warp_kernel<2, true, false>(x)"


def _container(y_len, z_len):
    packed = PackedTensors()
    packed.model = "bmshj2018"
    packed.pack([[b"\1" * y_len], [b"\2" * z_len],
                 np.asarray((64, 64), np.int32), np.asarray((4, 4), np.int32),
                 np.asarray((1, 1), np.int32)])
    return packed.string


def _observed(launches_per_request):
    spans, kernels, t = [], [], 0.0
    for n in launches_per_request:
        spans.append((t, t + 1.0))
        for i in range(n):
            kernels.append((K3, t + 0.1 + 0.2 * i, t + 0.2 + 0.2 * i))
        t += 2.0
    busy = trace_lib.union((s, e) for _, s, e in kernels)
    summary = dict(spans={"decompress": spans}, kernels=kernels, busy=busy,
                   busy_s=sum(e - s for s, e in busy), window_s=t)
    return dict(trace=summary, latent_depths=(8, 4),
                tables={"y": (640, 100), "z": (40, 10)},
                traced_containers=[_container(300, 20)] * len(spans))


def test_k3_roofline_by_hand():
    read = harness.load_metric_reader("k3_roofline")
    least = (counts.least_seconds(*counts.decode_cost(20, 4, 40, 10, True))
             + counts.least_seconds(*counts.decode_cost(300, 128, 640, 100,
                                                        True)))
    # Two launches of 0.1 s a request.
    assert read(_observed([2, 2])) == pytest.approx(100 * least / 0.2)
    # A request whose records the profiler dropped is left out ...
    assert read(_observed([2, 1, 2])) == pytest.approx(100 * least / 0.2)
    # ... unless most are.
    assert read(_observed([1, 1, 2])) is None


def test_device_idle_share_by_hand():
    read = harness.load_metric_reader("device_idle_pct.decompress")
    # Each 1 s span holds 0.2 s of kernels.
    assert read(_observed([2, 2])) == pytest.approx(80.0)
    assert harness.load_metric_reader("device_idle_pct.train")(
        _observed([2, 2])) == pytest.approx(100 * (1 - 0.4 / 4.0))


def test_mfu_by_hand():
    read = harness.load_metric_reader("mfu_pct.decompress")
    observed = dict(flops=dict(hyper_synthesis=1e12, synthesis=5.7e12),
                    decompress_ms=[100.0, 100.0])
    assert read(observed) == pytest.approx(100 * 6.7e12 * 2 / (0.2 * 67e12))
