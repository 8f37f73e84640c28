"""The program's spans (util/profiling.py ``span`` / ``wait``) on the CPU:
nothing is recorded while the profiler is off; under ``torch.profiler``
every codec entry point and the train step record the span tree of their
path (names, kinds, parent links, request ids, waits), each span encloses
the profiler's event of the same name, and the bounded list counts what it
drops.

The codecs are bls2017 (no side model: its trees lack z's and the hyper
synthesis's nodes) and bmshj2018 at 16 filters and HiFiC at
test_torch_hific.py's tiny configuration, on seeded weights and their own
CPU tables.  The
coder's ``coder.launch.*`` spans sit in the CUDA launch path, which the CPU
does not reach (tests/test_torch_cuda.py holds them on the card).
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from compression_tpu_torch.models import bls2017
from compression_tpu_torch.models import bmshj2018
from compression_tpu_torch.models import hific
from compression_tpu_torch.util import profiling

torch.set_num_threads(1)

IMAGE = (64, 64, 3)
ENTRIES = ("compress", "decompress_classic", "compress_native",
           "decompress_native", "compress_native_many",
           "decompress_native_many")
KINDS = {"transforms": "dispatch", "train": "dispatch", "wait": "wait"}


@pytest.fixture(scope="module", params=["bls2017", "bmshj2018", "hific"])
def codec(request):
    if request.param == "bls2017":
        model = bls2017.BLS2017Model(num_filters=16)
        return bls2017.BLS2017Codec(model, device="cpu")
    if request.param == "bmshj2018":
        model = bmshj2018.BMSHJ2018Model(num_filters=16)
        return bmshj2018.BMSHJ2018Codec(model, device="cpu")
    cfg = hific.HiFiCConfig(num_down=2, num_filters_base=4,
                            num_filters_bottleneck=8, num_residual_blocks=2,
                            hyper_filters=4)
    return hific.HiFiCCodec(hific.HiFiCModel(cfg), device="cpu")


def _images(n=1):
    return [np.random.RandomState(i).randint(0, 256, IMAGE).astype(np.uint8)
            for i in range(n)]


def _call(codec, entry):
    """Runs ``entry``; returns what the traced call needs ready-made."""
    x, x2 = _images(2)
    if entry == "compress":
        return lambda: codec.compress(x)
    if entry == "compress_native":
        return lambda: codec.compress_native(x)
    if entry == "compress_native_many":
        return lambda: codec.compress_native_many([x, x2])
    if entry == "decompress_classic":
        c = codec.compress(x)
        return lambda: codec.decompress(c)
    if entry == "decompress_native":
        c = codec.compress_native(x)
        return lambda: codec.decompress(c)
    cs = codec.compress_native_many([x, x2])
    return lambda: codec.decompress_native_many(cs)


def _traced(fn):
    profiling.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return profiling.spans(), prof


def _tree(records):
    """[(label, [children...])] of the roots, from the parent links."""
    nodes = {r.id: (r.label, []) for r in records}
    roots = []
    for r in records:
        (roots if r.parent is None else nodes[r.parent][1]).append(
            nodes[r.id])
    return roots


def _node(label, *children):
    return ("ctpu." + label, list(children))


def _waits(*names):
    return [_node("wait." + n) for n in names]


def _expected(codec, entry):
    """The span tree ``entry`` reaches on the CPU; a codec without a side
    model (no ``side_em``) has no z or hyper-synthesis nodes."""
    side = hasattr(codec, "side_em")

    def z(*nodes):
        return list(nodes) if side else []

    y_esc = codec.em.device_table.any_overflow
    z_esc = side and codec.side_em.device_table.any_overflow
    finish = _node("codec.finish", *_waits("sanity", "fetch"))
    hyper = z(_node("transforms.hyper_synthesis"))
    front = [_node("codec.upload"), _node("transforms.analysis"), *hyper]
    if entry == "compress":
        def encode(latent, esc):
            return _node(f"entropy.encode.{latent}",
                         *_waits(*["route"] * esc),
                         _node("container.pack", *_waits("fetch")))
        return [_node("codec.compress", *front, *z(encode("z", z_esc)),
                      encode("y", y_esc), _node("container.pack"))]
    native_encode = [
        _node("entropy.encode.y", *_waits(*["escapes"] * y_esc)),
        *z(_node("entropy.encode.z", *_waits(*["escapes"] * z_esc)))]
    pack = _node("container.pack", *_waits("fetch", *z("fetch")))
    if entry == "compress_native":
        return [_node("codec.compress_native", *front, *native_encode, pack)]
    if entry == "compress_native_many":
        image = _node("codec.image", *front, *native_encode)
        return [_node("codec.compress_native_many", image, image, pack,
                      pack)]
    if entry == "decompress_classic":
        upload = _node("container.parse", *_waits("upload"))
        return [_node("codec.decompress", _node("container.parse"),
                      _node("container.parse"),
                      *z(upload, _node("entropy.decode.z"), *hyper), upload,
                      _node("entropy.decode.y"), _node("transforms.synthesis"),
                      finish)]
    decode = [_node("container.parse"),
              _node("container.parse", *_waits("upload", *z("upload"))),
              *z(_node("entropy.decode.z"), *hyper),
              _node("entropy.decode.y"), _node("transforms.synthesis")]
    if entry == "decompress_native":
        return [_node("codec.decompress", *decode, finish)]
    image = _node("codec.image", *decode)
    return [_node("codec.decompress_native_many", image, image, finish,
                  finish)]


def _count_waits(tree):
    return sum((label.startswith("ctpu.wait.")) + _count_waits(children)
               for label, children in tree)


@pytest.mark.parametrize("entry", ENTRIES)
def test_nothing_recorded_without_a_profiler(codec, entry):
    fn = _call(codec, entry)
    profiling.clear_spans()
    fn()
    assert profiling.spans() == []
    with profiling.span("codec", "compress", request=True) as request:
        assert request is None
    assert profiling.spans() == []


@pytest.mark.parametrize("entry", ENTRIES)
def test_entry_records_its_span_tree(codec, entry):
    records, _ = _traced(_call(codec, entry))
    expected = _expected(codec, entry)
    assert _tree(records) == expected
    waits = [r for r in records if r.kind == "wait"]
    assert len(waits) == _count_waits(expected) > 0
    for r in records:
        assert r.kind == KINDS.get(r.layer, "host"), r
        assert r.start_ns <= r.end_ns
        if r.parent is not None:
            parent = next(p for p in records if p.id == r.parent)
            assert parent.start_ns <= r.start_ns <= r.end_ns <= parent.end_ns
    by_id = {r.id: r for r in records}
    root = records[0]
    if entry.endswith("_many"):
        # Each image is a request of its own, resumed by its second phase
        # (the container's pack, or the finish).
        assert root.request is None
        children = [by_id[r.id] for r in records if r.parent == root.id]
        images = [r for r in children if r.name == "image"]
        assert len(images) == 2
        assert len({r.request for r in images}) == 2
        assert [r.request for r in children if r.name != "image"] == \
            [r.request for r in images]
        for r in records[1:]:
            top = r
            while top.parent != root.id:
                top = by_id[top.parent]
            assert r.request == top.request is not None
    else:
        assert root.request is not None
        assert {r.request for r in records} == {root.request}


def test_requests_get_ids_of_their_own(codec):
    x, = _images()
    records, _ = _traced(lambda: codec.decompress(codec.compress(x)))
    roots = [r for r in records if r.parent is None]
    assert [r.name for r in roots] == ["compress", "decompress"]
    assert roots[0].request != roots[1].request
    for r in records:
        top = r
        while top.parent is not None:
            top = next(p for p in records if p.id == top.parent)
        assert r.request == top.request


@pytest.mark.parametrize("entry", ENTRIES)
def test_spans_enclose_the_profiler_events(codec, entry):
    """The recorder's clock (time.time_ns) is the profiler's: each span's
    record_function event lies within its record."""
    records, prof = _traced(_call(codec, entry))
    events = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("ctpu."):
            start = e.start_ns()
            events.setdefault(e.name(), []).append(
                (start, start + e.duration_ns()))
    labels = {r.label for r in records}
    assert labels == set(events)
    for label in labels:
        spans = sorted((r.start_ns, r.end_ns) for r in records
                       if r.label == label)
        found = sorted(events[label])
        assert len(spans) == len(found)
        for (s0, s1), (e0, e1) in zip(spans, found):
            assert s0 <= e0 and e1 <= s1, (label, s0, e0, e1, s1)


@pytest.mark.parametrize("batch", ["tensor", "numpy"])
def test_train_step_span_tree(batch):
    model = bmshj2018.BMSHJ2018Model(num_filters=8)
    step = bmshj2018.make_train_step(
        model, torch.optim.Adam(model.parameters(), lr=1e-4))
    x = np.random.RandomState(0).randint(0, 256, (2, 64, 64, 3)).astype(
        np.float32)
    if batch == "tensor":
        x = torch.from_numpy(x)
    gen = torch.Generator().manual_seed(0)
    step(x, generator=gen)
    records, prof = _traced(lambda: step(x, generator=gen))
    upload = _waits("upload") if batch == "numpy" else []
    assert _tree(records) == [_node(
        "train.step", *upload, _node("train.forward"),
        _node("train.backward"), _node("train.optimizer"))]
    assert len({r.request for r in records}) == 1
    assert records[0].request is not None
    assert [r.kind for r in records[1:]] == \
        ["wait"] * len(upload) + ["dispatch"] * 3


def test_bounded_list_counts_what_it_drops(codec, monkeypatch):
    fn = _call(codec, "compress")
    whole, _ = _traced(fn)
    monkeypatch.setattr(profiling, "MAX_SPANS", 5)
    kept, _ = _traced(fn)
    assert len(kept) == 5
    assert profiling.dropped_spans() == len(whole) - 5
    assert [r.label for r in kept] == [r.label for r in whole[:5]]
    assert [r.parent is None for r in kept] == \
        [r.parent is None for r in whole[:5]]
    profiling.clear_spans()
    assert profiling.spans() == [] and profiling.dropped_spans() == 0
