"""Inputs and weights repeat exactly for a seed and change with it."""

from __future__ import annotations

import itertools

import torch

from portbench import textures
from portbench import weights as weights_lib
from portbench.loops import _codec, train_loop
from portbench.tests.conftest import tiny_cell

CPU = torch.device("cpu")
SEED = 2**31 + 5


def test_texture_pool_repeats_for_a_seed():
    a = textures.pool(3, 64, 96, SEED, CPU)
    b = textures.pool(3, 64, 96, SEED, CPU)
    c = textures.pool(3, 64, 96, SEED + 1, CPU)
    assert a.dtype == torch.uint8 and a.shape == (3, 64, 96, 3)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert int(a.min()) == 0 and int(a.max()) == 255


def test_weights_repeat_for_a_seed():
    cell = tiny_cell("hific.native-kodak")
    spec = cell.config_module.spec(cell.config)
    a = weights_lib.make(spec, SEED, CPU)
    b = weights_lib.make(spec, SEED, CPU)
    c = weights_lib.make(spec, SEED + 1, CPU)
    assert a.keys() == b.keys() == set(spec)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["decoder.Conv_0.kernel"],
                           c["decoder.Conv_0.kernel"])


def test_request_order_and_crops_repeat_for_a_seed():
    def picks(seed, count):
        return list(itertools.islice(_codec.order(seed, 24), count))

    assert picks(SEED, 100) == picks(SEED, 100)
    assert picks(SEED, 100) != picks(SEED + 1, 100)
    assert sorted(picks(SEED, 24)) == list(range(24))
    cell = tiny_cell("bmshj2018.train-b8")
    pool = textures.pool(3, 128, 128, SEED, CPU)

    def crops(seed):
        ctx = type("Ctx", (), dict(cell=cell, seed=seed, device=CPU))
        feed = train_loop.Feed(ctx, pool)
        return [feed() for _ in range(3)]

    a, b, c = crops(SEED), crops(SEED), crops(SEED + 1)
    for (xa, ua), (xb, ub) in zip(a, b):
        assert torch.equal(xa, xb)
        assert all(torch.equal(p, q) for p, q in zip(ua, ub))
    assert not torch.equal(a[0][0], c[0][0])
    assert len({bytes(x.numpy()) for x, _ in a}) == 3
