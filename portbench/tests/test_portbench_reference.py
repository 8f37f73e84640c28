"""The plain reference against the program at tiny sizes on the CPU: the
tables bit for bit, the transforms, the plain decoder on the program's
containers, and three training steps; and the yardstick's counts."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench import counts
from portbench import textures
from portbench import weights as weights_lib
from portbench.reference import bmshj2018 as ref_bmshj
from portbench.reference import check_codec
from portbench.reference import check_train
from portbench.reference import coder
from portbench.reference import hific as ref_hific
from portbench.reference import ops as ops_lib
from portbench.reference import tables as ref_tables
from portbench.tests.conftest import tiny_cell

from compression_tpu_torch.codec import tables as port_tables
from compression_tpu_torch.distributions import deep_factorized
from compression_tpu_torch.distributions import uniform_noise
from compression_tpu_torch.entropy_models.continuous_batched import (
    ContinuousBatchedEntropyModel)
from compression_tpu_torch.entropy_models.continuous_indexed import (
    LocationScaleIndexedEntropyModel)
from compression_tpu_torch.models.bmshj2018 import make_scale_fn

CPU = torch.device("cpu")


def _pmfs(seed):
    rng = np.random.default_rng(seed)
    for trial in range(120):
        n = int(rng.integers(2, 200))
        kind = trial % 4
        if kind == 0:
            p = rng.random(n)
        elif kind == 1:  # runs of equal masses: ties in the repair queue
            p = np.repeat(rng.random(max(n // 8, 1)), 8)[:n]
        elif kind == 2:
            p = np.ones(n)
            p[rng.integers(n)] = 50
        else:
            x = np.arange(n) - n / 2
            p = np.exp(-x * x / (2 * (n / 6) ** 2))
        prec = int(rng.integers(9, 17))
        yield (p / p.sum()).astype(np.float32), prec


@pytest.mark.parametrize("seed", [0, 1])
def test_quantizer_equals_tfc_order_of_repairs(seed):
    for pmf, prec in _pmfs(seed):
        assert np.array_equal(ref_tables.quantize_pmf(pmf, prec),
                              port_tables.pmf_to_quantized_cdf(pmf, prec))


def test_std_sort_matches_a_stable_sort_on_distinct_keys():
    rng = np.random.default_rng(3)
    for n in (1, 2, 16, 17, 100, 1000):
        keys = list(rng.permutation(n))
        seq = list(range(n))
        ref_tables.std_sort(seq, lambda a, b: keys[a] < keys[b])
        assert seq == sorted(range(n), key=lambda i: keys[i])


def _dense_rows(cdf):
    d = port_tables.parse_ragged_cdf(cdf)
    return [list(d.cdf[r, : d.length[r]]) for r in range(d.num_rows)]


def test_scale_table_equals_the_programs():
    ref = ref_tables.scale_table(0.11, 256.0, 64, 12)
    em = LocationScaleIndexedEntropyModel(
        uniform_noise.NoisyNormal, 64, make_scale_fn(0.11, 256.0, 64),
        coding_rank=3, compression=True, device="cpu")
    assert _dense_rows(em.cdf) == ref.rows
    assert list(em.cdf_offset) == ref.offsets


@pytest.mark.parametrize("seed", [0, 1])
def test_hyperprior_table_equals_the_programs(seed):
    g = torch.Generator().manual_seed(seed)
    params = deep_factorized.DeepFactorized.init_params((24,), generator=g)
    params["factors"] = [torch.randn(f.shape, generator=g) * 0.3
                         for f in params["factors"]]
    prior = deep_factorized.NoisyDeepFactorized(params=params,
                                                batch_shape=(24,))
    em = ContinuousBatchedEntropyModel(prior=prior, coding_rank=3,
                                       compression=True, device="cpu")
    ref, offset = ref_tables.hyperprior_table(params, 12)
    assert _dense_rows(em.cdf) == ref.rows
    assert list(em.cdf_offset) == ref.offsets
    assert torch.equal(em._quantization_offset, offset)


@pytest.mark.parametrize("cell,ref", [("bmshj2018.tfci-kodak", ref_bmshj),
                                      ("hific.native-kodak", ref_hific)])
def test_transforms_agree_with_the_programs(cell, ref):
    c = tiny_cell(cell)
    w = weights_lib.make(c.config_module.spec(c.config), 5, CPU)
    model = c.config_module.model(c.config, w, CPU)
    x = textures.pool(2, 128, 192, 6, CPU)
    ops = ops_lib.Ops()
    with torch.no_grad():
        y_p, z_p = model.encode(x.to(torch.float32))
        y_r = ref.analysis(ops, w, x)
        z_r = ref.hyper_analysis(ops, w, y_r)
        x_p = model.decode(torch.round(y_p))
        x_r = ref.synthesis(ops, w, torch.round(y_p).permute(0, 3, 1, 2))
    for p, r in ((y_p, y_r), (z_p, z_r), (x_p, x_r)):
        r = r.permute(0, 2, 3, 1)
        assert p.shape == r.shape
        assert float((p - r).abs().max()) <= 1e-4 * float(r.abs().max())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_decoder_resolves_nearby_ambiguous_rows(seed):
    """Pairs of ambiguous elements two apart, the first's nominal row the
    sender's and the second's not: choosing the first row needs the second
    resolved as well (a HiFiC container decoded wrongly so).  Small scales,
    whose neighbouring rows differ by a hair, and a pair at the stream's
    end, where the wrong row goes wrong only once or twice."""
    table = ref_tables.scale_table(0.11, 256.0, 64, 12)
    em = LocationScaleIndexedEntropyModel(
        uniform_noise.NoisyNormal, 64, make_scale_fn(0.11, 256.0, 64),
        coding_rank=3, compression=True, device="cpu")
    rng = np.random.default_rng(seed)
    n = 3000
    k = rng.integers(1, 30, n)
    index = (k + rng.uniform(0.2, 0.8, n)).astype(np.float32)
    nominal = np.floor(index).astype(np.int64)
    alternatives = {}
    for j in [n - 5, *rng.choice(n - 8, 40, replace=False)]:
        for e, sender_below in ((j, False), (j + 2, True)):
            index[e] = k[e] - 1e-4 if sender_below else k[e] + 1e-4
            nominal[e] = k[e]
            alternatives[int(e)] = int(k[e]) - 1
    scale = 0.11 * np.exp(index / 63 * np.log(256 / 0.11))
    y = np.round(rng.normal(0, scale)).astype(np.float32)
    strings = em.compress_to_strings(torch.tensor(y).reshape(1, 1, 1, n),
                                     torch.tensor(index).reshape(1, 1, 1, n))
    expected = [int(v) for v in y]
    values, ok, _ = coder.decode_stream(
        strings[0], table, [int(r) for r in nominal], expected, alternatives)
    assert ok
    assert values == expected


@pytest.mark.parametrize("cell", ["bmshj2018.tfci-kodak",
                                  "hific.native-kodak"])
def test_plain_decoder_reads_the_programs_containers(cell):
    c = tiny_cell(cell)
    w = weights_lib.make(c.config_module.spec(c.config), 7, CPU)
    codec = c.config_module.codec(c.config, w, CPU)
    tables = check_codec.CodecTables(c.config, w)
    image = textures.pool(1, 128, 192, 8, CPU)[0].numpy()
    for compress in (codec.compress, codec.compress_native):
        container = compress(image)
        numbers = check_codec.judge(c.reference, c.config, w, tables, image,
                                    container, codec.decompress(container),
                                    CPU)
        assert numbers["broken_streams"] == 0
        assert numbers["latent_mismatch"] <= 1e-3
        assert numbers["pixel_mismatch"] <= 1e-3


def test_three_train_steps_agree_with_the_programs():
    c = tiny_cell("bmshj2018.train-b8")
    w = weights_lib.make(c.config_module.spec(c.config), 9, CPU)
    model = c.config_module.model(c.config, w, CPU)
    opt = torch.optim.Adam(model.parameters(), lr=1e-4)
    step = c.config_module.train_step(model, opt)
    gen = torch.Generator().manual_seed(10)
    x = textures.pool(6, 64, 64, 11, CPU)
    shapes = c.config_module.latent_shapes(c.config, 2, 64, 64)
    batches = [x[2 * i: 2 * i + 2] for i in range(3)]
    noises = [tuple(torch.rand(s, generator=gen) - 0.5 for s in shapes)
              for _ in range(3)]
    params = dict(model.named_parameters())
    metrics, first = [], None
    for b, u in zip(batches, noises):
        out = step(b, u=u)
        metrics.append(tuple(float(out[k]) for k in ("loss", "bpp", "mse")))
        if first is None:
            first = {k: float(opt.state[p]["exp_avg"].norm() / 0.1)
                     for k, p in params.items() if p in opt.state}
    change = {k: float((p.detach() - w[k]).norm())
              for k, p in params.items()}
    ref = check_train.reference_steps(c.reference, c.config, w, batches,
                                      noises, 1e-4)
    gaps = check_train.gaps((metrics, first, change), ref)
    assert gaps["loss_gap"] < 1e-5
    assert gaps["grad_gap"] < 1e-4
    assert gaps["update_gap"] < 1e-3


@pytest.mark.parametrize("cell", ["bmshj2018.tfci-kodak",
                                  "hific.native-kodak"])
def test_flop_counts_match_torchs_counter_on_the_programs_convolutions(cell):
    from torch.utils.flop_counter import FlopCounterMode

    c = tiny_cell(cell)
    w = weights_lib.make(c.config_module.spec(c.config), 12, CPU)
    model = c.config_module.model(c.config, w, CPU)
    f = c.config_module.flops(c.config, 128, 192)
    x = textures.pool(1, 128, 192, 13, CPU).to(torch.float32)

    def conv_flop(fn, *args):
        with FlopCounterMode(display=False) as counter:
            fn(*args)
        return sum(v for op, v in counter.get_flop_counts()["Global"].items()
                   if "convolution" in str(op))

    y, z = model.encode(x)
    hyper = model.hyper_decode(torch.round(z))
    assert conv_flop(lambda v: model.encode(v), x) \
        == f["analysis"] + f["hyper_analysis"]
    assert conv_flop(model.hyper_decode, torch.round(z)) \
        == f["hyper_synthesis"]
    assert conv_flop(model.decode, torch.round(y)) == f["synthesis"]
    del hyper


def test_k3_bytes_by_hand():
    """One stream of 1000 bytes carrying 4096 symbols, a table of 64 rows
    of 1481 entries: the stream, its length, the indexes and symbols (4
    bytes each), the table's entries (4 bytes each) and a flag."""
    nbytes, ops = counts.decode_cost(1000, 4096, 64 * 1481, 1481, True)
    assert nbytes == 1000 + 4 + 4096 * 4 + 64 * 1481 * 4 + 4096 * 4 + 1
    # ceil(log2(1480)) = 11 probes of 2 operations, 10 for the update.
    assert ops == (2 * 11 + 10) * 4096
    assert counts.least_seconds(nbytes, ops) == nbytes / 3.35e12
