"""Runs of tiny cells on the CPU with the timed path broken underneath
(``faults.py``) come out not correct; sound runs come out correct; and
the control (the reference in TF32) fails one of each cell's numbers."""

from __future__ import annotations

import pytest
import torch

from portbench import faults
from portbench import textures
from portbench import weights as weights_lib
from portbench.reference import check_codec
from portbench.reference import check_train
from portbench.tests.conftest import run_tiny, tiny_cell

CODEC_FAULTS = [("bmshj2018.tfci-kodak", "container"),
                ("bmshj2018.tfci-kodak", "image"),
                ("hific.native-kodak", "container"),
                ("hific.native-kodak", "image"),
                ("hific.native-batch8", "container"),
                ("hific.native-batch8", "image"),
                ("hific.native-batch8", "half_batch")]
TRAIN_FAULTS = [("bmshj2018.train-b8", "frozen"),
                ("bmshj2018.train-b8", "half_step")]


@pytest.mark.parametrize("cell", ["bmshj2018.tfci-kodak",
                                  "hific.native-kodak",
                                  "hific.native-batch8",
                                  "bmshj2018.train-b8"])
def test_a_sound_run_is_correct(cell):
    line, outcome = run_tiny(cell)
    assert outcome.attempted > 0
    assert line["correct"], line["checks"]


@pytest.mark.parametrize("cell,fault", CODEC_FAULTS + TRAIN_FAULTS)
def test_a_broken_run_is_not_correct(cell, fault):
    with faults.planted(fault):
        line, _ = run_tiny(cell)
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("cell", ["bmshj2018.tfci-kodak",
                                  "hific.native-kodak"])
def test_the_control_fails_a_codec_cells_numbers(cell):
    c = tiny_cell(cell)
    cpu = torch.device("cpu")
    w = weights_lib.make(c.config_module.spec(c.config), 21, cpu)
    tables = check_codec.CodecTables(c.config, w)
    image = textures.pool(1, 128, 192, 22, cpu)[0].numpy()
    numbers = check_codec.control(c.reference, c.config, w, tables, image,
                                  cpu)
    assert any(numbers[k] > c.limits[k] for k in numbers), numbers


def test_the_control_fails_the_train_cells_numbers():
    c = tiny_cell("bmshj2018.train-b8")
    cpu = torch.device("cpu")
    w = weights_lib.make(c.config_module.spec(c.config), 23, cpu)
    x = textures.pool(6, 64, 64, 24, cpu)
    gen = torch.Generator().manual_seed(25)
    shapes = c.config_module.latent_shapes(c.config, 2, 64, 64)
    batches = [x[2 * i: 2 * i + 2] for i in range(3)]
    noises = [tuple(torch.rand(s, generator=gen) - 0.5 for s in shapes)
              for _ in range(3)]
    args = (c.reference, c.config, w, batches, noises, 1e-4)
    gaps = check_train.gaps(check_train.reference_steps(*args, tf32=True),
                            check_train.reference_steps(*args))
    assert any(gaps[k] > c.limits[k] for k in c.limits), gaps
