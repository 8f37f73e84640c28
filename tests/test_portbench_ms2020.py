"""ms2020 as a benchmark configuration (portbench's ``ms2020.tfci-kodak``),
on the CPU at a tiny size with the configuration's seeded weights: the
plain reference (portbench/reference/ms2020.py) against MS2020Model's
sub-graphs, the slice-by-slice judge (reference/check_slices.py) on the
port's classic containers, on planted faults and on the TF32 control, the
classic container against one coded a slice at a time inside the slice
loop, the model's spans and ``SLICE_CODER_CALLS``, the new readers on
hand-made summaries, and a tiny traced run of the cell."""

from unittest import mock

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from compression_tpu_torch.codec import tables as port_tables
from compression_tpu_torch.codec import torch_coder
from compression_tpu_torch.models import ms2020
from compression_tpu_torch.util import profiling
from portbench import faults
from portbench import harness
from portbench import textures
from portbench import weights as weights_lib
from portbench.configs import ms2020 as ms2020_config
from portbench.reference import check_slices
from portbench.reference import container as container_lib
from portbench.reference import ms2020 as ref
from portbench.reference import ops as ops_lib

torch.set_num_threads(1)

CPU = torch.device("cpu")
CELL = "ms2020.tfci-kodak"
TINY = dict(num_filters=8, latent_depth=20, hyperprior_depth=8,
            num_slices=5, max_support_slices=3,
            hyper_analysis_widths=[20, 16], hyper_synthesis_widths=[8, 16, 20],
            slice_widths=[14, 8])
SIZE = 64
# The window's start on the spans' clock (ns); summaries count seconds
# from it.
W0 = 1_700_000_000_000_000_000
MS = 1_000_000


@pytest.fixture(scope="module")
def cell():
    c = harness.resolve(CELL)
    c.config = dict(c.config, **TINY)
    c.traffic = dict(c.traffic, pool=2, height=SIZE, width=SIZE, warmup=1,
                     check=1)
    return c


@pytest.fixture(scope="module")
def setup(cell):
    """(weights, codec, images, classic containers, decoded images)."""
    w = weights_lib.make(ms2020_config.spec(cell.config), 31, CPU)
    codec = ms2020_config.codec(cell.config, w, CPU)
    images = list(textures.pool(2, SIZE, SIZE, 32, CPU).numpy())
    containers = [codec.compress(x) for x in images]
    decoded = [codec.decompress(c) for c in containers]
    return w, codec, images, containers, decoded


def _nchw(t):
    return t.permute(0, 3, 1, 2)


def _graphs(setup):
    """{name: (the port's, the reference's)} of every sub-graph on the
    first image, the reference fed the port's inputs."""
    w, codec, images, _, _ = setup
    model = codec.model
    ops = ops_lib.Ops()
    x = torch.as_tensor(images[0])[None]
    with torch.no_grad():
        y, z = model.encode(x.to(torch.float32))
        z_hat = torch.round(z)
        scales, means = model.hyper_decode(z_hat)
        y_hw = tuple(y.shape[1:3])
        m, c = ref.hyper_synthesis(ops, w, _nchw(z_hat), y_hw)
        out = dict(analysis=(_nchw(y), ref.analysis(ops, w, x)),
                   hyper_analysis=(_nchw(z), ref.hyper_analysis(ops, w,
                                                                _nchw(y))),
                   hyper_synthesis=(torch.cat([_nchw(means), _nchw(scales)]),
                                    torch.cat([m, c])))
        params, lrps, rows, decoded = [], [], [], []
        slices = torch.split(y, model.slice_depth, dim=-1)
        for i in range(model.num_slices):
            mu, sigma, support = model.slice_params(
                i, means, scales, model.support(decoded), y_hw)
            r_mu, r_sigma, r_support = ref.slice_params(
                ops, w, i, m, c, [_nchw(d) for d in decoded])
            params.append((torch.cat([_nchw(mu), _nchw(sigma)], 1),
                           torch.cat([r_mu, r_sigma], 1)))
            y_hat = codec.em_y.quantize(slices[i], mu)
            lrps.append((_nchw(model.lrp(i, support, y_hat)),
                         ref.lrp(ops, w, i, r_support, _nchw(y_hat))))
            rows.append((codec.em_y._prepare(sigma)[0].reshape(-1),
                         ref.scale_index(_nchw(sigma), model.num_scales)
                         .permute(0, 2, 3, 1).reshape(-1)))
            decoded.append(y_hat + model.lrp(i, support, y_hat))
        y_hat = torch.cat(decoded, dim=-1)
        out.update(
            slice_params=tuple(torch.cat(p) for p in zip(*params)),
            lrp=tuple(torch.cat(p) for p in zip(*lrps)),
            scale_index=tuple(torch.cat(p).to(torch.int64)
                              for p in zip(*rows)),
            synthesis=(_nchw(model.decode(y_hat)),
                       ref.synthesis(ops, w, _nchw(y_hat))))
    return out


@pytest.mark.parametrize("graph", ["analysis", "hyper_analysis",
                                   "hyper_synthesis", "slice_params", "lrp",
                                   "scale_index", "synthesis"])
def test_reference_sub_graph_equals_the_models(setup, graph):
    port, reference = _graphs(setup)[graph]
    assert port.shape == reference.shape
    if graph == "scale_index":
        assert torch.equal(port, reference)
    else:
        # Both in float32 from the same weights; they differ only in the
        # order of the sums (zero insertion and a correlation against the
        # program's transposed convolutions): a few ulps of the largest
        # value.
        scale = float(reference.abs().max())
        torch.testing.assert_close(port, reference, rtol=0,
                                   atol=1e-5 * max(scale, 1.0))


def test_flop_counts_match_torchs_counter_on_the_programs_convolutions(
        cell, setup):
    """``configs/ms2020.flops`` against torch's counter of the program's
    convolutions (GDN's channel mixing is one): the analysis and hyper
    analysis, the slice loop (both hyper syntheses and the 30 predictors,
    counted as ``hyper_synthesis``) and the synthesis."""
    from torch.utils.flop_counter import FlopCounterMode

    model = setup[1].model
    f = ms2020_config.flops(cell.config, SIZE, 2 * SIZE)
    x = textures.pool(1, SIZE, 2 * SIZE, 33, CPU).to(torch.float32)

    def conv_flop(fn, *args):
        with torch.no_grad(), FlopCounterMode(display=False) as counter:
            out = fn(*args)
        return out, sum(v for op, v in counter.get_flop_counts()[
            "Global"].items() if "convolution" in str(op))

    (y, z), flop = conv_flop(model.encode, x)
    assert flop == f["analysis"] + f["hyper_analysis"]
    slices = torch.split(y, model.slice_depth, dim=-1)
    y_hat, flop = conv_flop(
        model.slice_loop, torch.round(z), tuple(y.shape[1:3]),
        lambda i, mu, sigma: torch.round(slices[i] - mu) + mu)
    assert flop == f["hyper_synthesis"]
    _, flop = conv_flop(model.decode, y_hat)
    assert flop == f["synthesis"]


def _dense_rows(cdf):
    d = port_tables.parse_ragged_cdf(cdf)
    return [list(d.cdf[r, : d.length[r]]) for r in range(d.num_rows)]


def test_slice_tables_equal_the_programs(cell, setup):
    w, codec, _, _, _ = setup
    tables = check_slices.SliceTables(cell.config, w)
    assert _dense_rows(codec.em_y.cdf) == tables.y.rows
    assert _dense_rows(codec.em_z.cdf) == tables.z.rows
    assert list(codec.em_y.cdf_offset) == tables.y.offsets
    assert list(codec.em_z.cdf_offset) == tables.z.offsets


def _judge(cell, w, image, container, decoded):
    tables = check_slices.SliceTables(cell.config, w)
    return check_slices.judge(ref, cell.config, w, tables, image, container,
                              decoded, CPU)


def test_the_programs_containers_judge_clean(cell, setup):
    w, _, images, containers, decoded = setup
    for x, c, d in zip(images, containers, decoded):
        model_id, tensors = container_lib.read(c)
        assert model_id == "ms2020" and len(tensors) == 4 + 5
        numbers = _judge(cell, w, x, c, d)
        assert numbers["latent_mismatch"] == 0, numbers
        assert numbers["broken_streams"] == 0, numbers
        assert numbers["pixel_mismatch"] <= cell.limits["pixel_mismatch"]


class _TF32Convolutions(torch.overrides.TorchFunctionMode):
    """Every convolution with its operands rounded to TF32's mantissa: what
    cuDNN computes with TF32 on, on a CPU that has no TF32."""

    CONVS = {torch.conv2d, torch.conv_transpose2d,
             torch.nn.functional.conv2d, torch.nn.functional.conv_transpose2d}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in self.CONVS:
            args = tuple(ops_lib.round_to_tf32(a) if i < 2 else a
                         for i, a in enumerate(args))
        return func(*args, **(kwargs or {}))


def _plant(codec, fault):
    """The fault's patches of the program, as a context manager."""
    cls = ms2020.MS2020Codec
    if fault == "container":
        compress = cls.compress
        return mock.patch.object(
            cls, "compress", lambda self, x: faults._flip(compress(self, x)))
    if fault == "image":
        decompress = cls.decompress
        return mock.patch.object(
            cls, "decompress",
            lambda self, c: faults._band(decompress(self, c)))
    if fault == "no_lrp":
        decompress = cls.decompress

        def without_lrp(self, c):
            with mock.patch.object(
                    ms2020.MS2020Model, "lrp",
                    lambda model, i, support, y: torch.zeros_like(y)):
                return decompress(self, c)

        return mock.patch.object(cls, "decompress", without_lrp)
    if fault == "support":
        support = ms2020.MS2020Model.support
        return mock.patch.object(
            ms2020.MS2020Model, "support",
            lambda model, decoded: support(model, decoded)[::-1])
    assert fault == "tf32_synthesis"
    synthesis = cls._synthesis_u8

    def tf32(self, y_hat):
        with _TF32Convolutions():
            return synthesis(self, y_hat)

    return mock.patch.object(cls, "_synthesis_u8", tf32)


@pytest.mark.parametrize("fault", ["container", "image", "no_lrp", "support",
                                   "tf32_synthesis"])
def test_a_planted_fault_comes_out_over_a_limit(cell, setup, fault):
    w, codec, images, _, _ = setup
    x = images[0]
    with _plant(codec, fault):
        c = codec.compress(x)
        try:
            d = codec.decompress(c)
        except ValueError:  # the sanity check caught it; judge garbage
            d = np.zeros_like(x)
    numbers = _judge(cell, w, x, c, d)
    assert any(numbers[k] > v for k, v in cell.limits.items()), numbers


def test_the_control_fails_a_limit(cell, setup):
    w, _, images, _, _ = setup
    tables = check_slices.SliceTables(cell.config, w)
    numbers = check_slices.control(ref, cell.config, w, tables, images[0],
                                   CPU)
    assert any(numbers[k] > cell.limits[k] for k in numbers), numbers


# -- the classic compress's stacked y encode ---------------------------------
def _per_slice_container(codec, x):
    """The classic container coded a slice at a time: one
    ``em_y.compress_to_strings`` a slice, inside the slice loop, as the
    codec did before it stacked the slices into one encode after the loop.
    Returns (container, the route each slice's encode took)."""
    with torch.no_grad():
        y, z = codec._encode(codec._upload(x))
        z_strings = codec.em_z.compress_to_strings(z)
        y_slices = codec._slices(y)
        y_strings, routes = [], []

        def code(i, mu, sigma):
            y_strings.append(codec.em_y.compress_to_strings(
                y_slices[i], sigma, loc=mu))
            routes.append(torch_coder.DISPATCH_LOG["encode"])
            return codec.em_y.quantize(y_slices[i], mu)

        y_hw = tuple(int(s) for s in y.shape[1:3])
        codec.model.slice_loop(codec.em_z.quantize(z), y_hw, code)
    container = codec._pack(
        [np.asarray(x.shape[:2], np.int32), np.asarray(y_hw, np.int32),
         np.asarray(tuple(z.shape[1:3]), np.int32), z_strings] + y_strings)
    return container, routes


def _escape_in_last_slice(codec):
    """Patches the codec's analysis so that one element of the last slice
    lies far past the y table's rows: that slice alone escapes (no slice's
    mu or sigma depends on the last one)."""
    encode = ms2020.MS2020Codec._encode
    depth = codec.model.slice_depth
    i = codec.model.num_slices - 1

    def planted(self, x):
        y, z = encode(self, x)
        y = y.clone()
        y[0, 1, 2, i * depth + 3] += 4000.0
        return y, z

    return mock.patch.object(ms2020.MS2020Codec, "_encode", planted)


@pytest.mark.parametrize("case", ["image0", "image1", "escape_in_last_slice"])
def test_classic_container_equals_the_per_slice_one(setup, case):
    """The stacked encode's container is byte for byte the one coded a
    slice at a time.  With an escape in one slice only, that slice alone
    takes the in-stream-gamma route (K6' on the card) and the others the
    indexed one (K1), while the stacked encode takes gamma for all: an
    escape-free stream's bytes are the same on both routes."""
    _, codec, images, containers, _ = setup
    k = 1 if case == "image1" else 0
    x = images[k]
    if case != "escape_in_last_slice":
        expected, routes = _per_slice_container(codec, x)
        assert codec.compress(x) == containers[k] == expected
        assert routes == ["plain-indexed"] * codec.model.num_slices
        assert torch_coder.DISPATCH_LOG["encode"] == "plain-indexed"
        return
    with _escape_in_last_slice(codec):
        expected, routes = _per_slice_container(codec, x)
        container = codec.compress(x)
        assert torch_coder.DISPATCH_LOG["encode"] == "plain-gamma"
        assert np.array_equal(codec.decompress(container),
                              codec.reconstruct(x))
    assert routes == ["plain-indexed"] * (codec.model.num_slices - 1) + [
        "plain-gamma"]
    assert container == expected


# -- the model's spans and its slice coder counter --------------------------
ENTRIES = {"compress": 0, "decompress": 5, "compress_native": 0,
           "decompress_native": 5, "compress_native_many": 0,
           "decompress_native_many": 10, "reconstruct": 0}


def _call(codec, images, entry):
    x, x2 = images
    if entry == "compress":
        return lambda: codec.compress(x)
    if entry == "decompress":
        c = codec.compress(x)
        return lambda: codec.decompress(c)
    if entry == "compress_native":
        return lambda: codec.compress_native(x)
    if entry == "decompress_native":
        c = codec.compress_native(x)
        return lambda: codec.decompress(c)
    if entry == "compress_native_many":
        return lambda: codec.compress_native_many([x, x2])
    if entry == "decompress_native_many":
        cs = codec.compress_native_many([x, x2])
        return lambda: codec.decompress_native_many(cs)
    return lambda: codec.reconstruct(x)


@pytest.mark.parametrize("entry", list(ENTRIES))
def test_spans_and_slice_coder_calls(setup, entry):
    _, codec, images, _, _ = setup
    fn = _call(codec, images, entry)
    before = ms2020.SLICE_CODER_CALLS
    profiling.clear_spans()
    fn()
    assert profiling.spans() == []
    assert ms2020.SLICE_CODER_CALLS - before == ENTRIES[entry]
    with profile(activities=[ProfilerActivity.CPU]):
        fn()
    records = profiling.spans()
    labels = [r.label for r in records]
    images_run = 2 if entry.endswith("_many") else 1
    ns = codec.model.num_slices
    assert labels.count("ctpu.slices.loop") == images_run
    assert labels.count("ctpu.slices.params") == ns * images_run
    assert labels.count("ctpu.slices.lrp") == ns * images_run
    assert labels.count("ctpu.transforms.hyper_synthesis") == images_run
    by_id = {r.id: r for r in records}
    for r in records:
        assert r.start_ns <= r.end_ns
        if r.parent is not None:
            p = by_id[r.parent]
            assert p.start_ns <= r.start_ns <= r.end_ns <= p.end_ns
        if r.name in ("params", "lrp"):
            assert by_id[r.parent].label == "ctpu.slices.loop"
            assert r.kind == "dispatch"
    if entry == "reconstruct":
        assert not any(r.layer == "entropy" for r in records)
        return
    root = records[0]
    name = {"decompress_native": "decompress"}.get(entry, entry)
    assert root.label == f"ctpu.codec.{name}"
    coder_y = [r for r in records if r.name in ("encode.y", "decode.y")]
    if ENTRIES[entry]:
        # One coder span a slice, inside the slice loop.
        assert len(coder_y) == ENTRIES[entry]
        assert all(by_id[r.parent].label == "ctpu.slices.loop"
                   for r in coder_y)
    else:
        # A compress codes y in one call after the loop.
        assert len(coder_y) == images_run
        for r in coder_y:
            while r.parent is not None:
                r = by_id[r.parent]
                assert r.label != "ctpu.slices.loop"
    if entry == "compress":
        # z's encode and the stacked slices' encode each wait once for the
        # route and once for the fetch, whatever the number of slices.
        waits = [r.name for r in records if r.kind == "wait"]
        assert waits.count("route") == waits.count("fetch") == 2
    if entry.endswith("_many"):
        assert labels.count("ctpu.codec.image") == 2
    else:
        assert {r.request for r in records} == {root.request} != {None}
    assert any(r.kind == "wait" for r in records)


@pytest.mark.parametrize("num_slices", [2, 4])
def test_classic_compress_waits_do_not_grow_with_the_slices(cell, setup,
                                                            num_slices):
    """At 2 and 4 slices as at the cell's 5: two route and two fetch waits a
    classic compress (z's encode and the stacked slices'), no coder call
    inside the loop, and the container equals the per-slice one."""
    config = dict(cell.config, num_slices=num_slices)
    codec = ms2020_config.codec(
        config, weights_lib.make(ms2020_config.spec(config), 31, CPU), CPU)
    x = setup[2][0]
    before = ms2020.SLICE_CODER_CALLS
    profiling.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        container = codec.compress(x)
    assert ms2020.SLICE_CODER_CALLS == before
    waits = [r.name for r in profiling.spans() if r.kind == "wait"]
    assert waits.count("route") == waits.count("fetch") == 2
    assert container == _per_slice_container(codec, x)[0]


# -- the new readers on hand-made records and summaries ---------------------
class Records:
    """Hand-made span records; times in ms from the window's start."""

    def __init__(self):
        self.records = []
        self.stack = []

    def span(self, label, start, end, kind="host", children=()):
        layer, name = label.split(".", 1)
        parent = self.stack[-1] if self.stack else None
        r = profiling.SpanRecord(len(self.records), parent, None, layer, name,
                                 kind, W0 + round(start * MS),
                                 W0 + round(end * MS))
        self.records.append(r)
        self.stack.append(r.id)
        for child in children:
            self.span(*child)
        self.stack.pop()
        return r


def _summary(harness_spans, busy=(), kernels=()):
    from portbench import trace as trace_lib

    busy = trace_lib.union(busy)
    return dict(spans=harness_spans, busy=busy, kernels=list(kernels),
                busy_s=sum(e - s for s, e in busy), window_s=10.0)


def _read(name, records, observed, monkeypatch):
    monkeypatch.setattr(profiling, "spans", lambda: list(records))
    return harness.load_metric_reader(name)(observed)


@pytest.mark.parametrize("direction", ["compress", "decompress"])
def test_slice_idle_ms_is_the_loops_time_off_the_card(monkeypatch,
                                                      direction):
    rec = Records()
    for t in (100, 200):
        rec.span(f"codec.{direction}", t, t + 20, children=[
            ("transforms.analysis", t, t + 2, "dispatch"),
            ("slices.loop", t + 2, t + 12, "host", [
                ("slices.params", t + 2, t + 3, "dispatch"),
                ("slices.lrp", t + 11, t + 12, "dispatch")])])
    harness_spans = {direction: [(0.1, 0.12), (0.2, 0.22)]}
    # Loops at 102-112 and 202-212 ms; the card busy 104-110 in the first
    # and 190-300 (all of it) in the second: 4 ms idle in all.
    observed = dict(trace=_summary(harness_spans,
                                   [(0.104, 0.110), (0.19, 0.3)]))
    name = f"slice_idle_ms.{direction}"
    assert _read(name, rec.records, observed, monkeypatch) == \
        pytest.approx(4.0 / 2)
    # The other direction's requests are not read.
    other = "decompress" if direction == "compress" else "compress"
    assert _read(f"slice_idle_ms.{other}", rec.records, observed,
                 monkeypatch) is None
    # A program without the slice loop's span: nothing to read.
    plain = [r for r in rec.records if r.layer != "slices"]
    assert _read(name, plain, observed, monkeypatch) is None
    monkeypatch.delattr(profiling, "spans")
    assert harness.load_metric_reader(name)(observed) is None


K3_NAME = "void decode_symbols_warp_kernel<2, false>(DecodeArgs)"


def test_k3_floor_pct_reads_the_floor_over_the_launches(setup):
    from portbench import counts

    _, codec, _, containers, _ = setup
    blob = containers[0]
    ns = codec.model.num_slices
    # Two requests, 1 + ns launches of 0.1 ms each inside each.
    kernels = []
    for a in (0.1, 0.2):
        kernels += [(K3_NAME, a + 0.001 * k, a + 0.001 * k + 1e-4)
                    for k in range(1 + ns)]
    kernels.append(("void other_kernel()", 0.1, 0.1001))
    summary = _summary({"decompress": [(0.1, 0.15), (0.2, 0.25)]},
                       kernels=kernels)
    observed = dict(trace=summary, traced_containers=[blob, blob],
                    latent_depths=(20, 8),
                    tables={"y": (1000, 200), "z": (100, 40)})
    read = harness.load_metric_reader("k3_floor_pct.slices")
    _, t = container_lib.read(blob)
    (hy, wy), (hz, wz) = t[1], t[2]
    clock = 1980.0
    floor = (counts.warp_floor_ms(hz * wz * 8, 40, clock)
             + ns * counts.warp_floor_ms(hy * wy * 4, 200, clock))
    assert read(observed) == pytest.approx(
        100.0 * floor / ((1 + ns) * 1e-4 * 1e3))
    # The first request's launches one too few in the trace: half the
    # requests remain, not most.
    summary["kernels"] = kernels[1:]
    assert read(observed) is None
    assert read(dict(observed, trace=None)) is None
    assert read(dict(observed, traced_containers=[])) is None


# -- tiny runs of the new cells -----------------------------------------------
def _run(c, trace):
    ctx = harness.Context(cell=c, device=CPU, seed=2**33 + 11, seconds=0.2,
                          trace=trace, t0=harness.clock())
    outcome = c.loop.run(ctx)
    line, _ = harness.result_line(c, outcome, ctx.setup_s, trace,
                                  {"platform": "cpu"})
    return line, outcome


def test_a_traced_tiny_run_of_the_slice_cell(cell):
    profiling.clear_spans()
    line, outcome = _run(cell, trace=True)
    assert outcome.attempted > 0 and line["correct"], line["checks"]
    metrics = line["metrics"]
    for name in ("slice_idle_ms.compress", "slice_idle_ms.decompress",
                 "host_waits.compress", "host_waits.decompress",
                 "container_ms.compress", "container_ms.decompress",
                 "mfu_pct.compress", "mfu_pct.decompress"):
        assert metrics[name]["value"] > 0, name
    # No kernel runs on the CPU: the K3' reader finds nothing.
    assert "k3_floor_pct.slices" not in metrics
