"""util/kinks.SharedKinks on the CPU: ``sharing`` stands in for ``F`` and
``round_st`` and restores them, and a replay takes the recorded decisions
at every kink (relu, leaky relu, max-pool, rounding).  A replay on the
recorded inputs gives the same values exactly and the same gradients within
1e-6 (a replayed relu's backward is a product where relu's is a select)."""

import types

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from compression_tpu_torch.models import hific, lpips
from compression_tpu_torch.ops import round_ops
from compression_tpu_torch.util.kinks import SharedKinks


def _step(m, x):
    """A function through every kind of kink, as the models call them."""
    h = m.F.relu(x)
    h = m.F.leaky_relu(x - h.mean(), 0.2) + h
    h = m.F.max_pool2d(h.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
    return round_ops.round_st(h * 3.0, offset=torch.full_like(h, 0.25))


def _input(seed, shape=(2, 6, 8, 3)):
    x = np.random.RandomState(seed).normal(0, 1, shape).astype(np.float32)
    return torch.tensor(x, requires_grad=True)


def test_sharing_restores_after_an_error():
    kinks = SharedKinks()
    before = round_ops.round_st
    with pytest.raises(ValueError):
        with kinks.sharing(hific, lpips, round_ops=round_ops):
            assert hific.F is kinks and lpips.F is kinks
            assert round_ops.round_st == kinks.round_st
            raise ValueError
    assert hific.F is F and lpips.F is F and round_ops.round_st is before


def test_replay_on_the_recorded_inputs_is_exact():
    m = types.SimpleNamespace(F=F)
    x = _input(0)
    want = _step(m, x)
    (want_grad,) = torch.autograd.grad(want.sum() * 1.5, x)
    kinks = SharedKinks()
    with kinks.sharing(m, round_ops=round_ops):
        recorded = _step(m, x)
        assert len(kinks.masks) == 4
        kinks.replay = list(kinks.masks)
        x2 = x.detach().clone().requires_grad_(True)
        got = _step(m, x2)
        (got_grad,) = torch.autograd.grad(got.sum() * 1.5, x2)
    assert not kinks.replay
    assert kinks.flips == {"relu": 0, "leaky_relu": 0, "max_pool2d": 0,
                           "round": 0}
    assert torch.equal(recorded, want) and torch.equal(got, want)
    np.testing.assert_allclose(got_grad.numpy(), want_grad.numpy(),
                               rtol=1e-6, atol=1e-6)


def test_replay_takes_the_recorded_decisions():
    """A relu replayed on other inputs keeps the recorded mask, and the
    flips count the elements decided otherwise."""
    m = types.SimpleNamespace(F=F)
    x = _input(1)
    kinks = SharedKinks()
    with kinks.sharing(m):
        m.F.relu(x)
        m.F.leaky_relu(x, 0.2)
        kinks.replay = list(kinks.masks)
        y = -x.detach()
        relu = m.F.relu(y)
        leaky = m.F.leaky_relu(y, 0.2)
    mask = x.detach() > 0
    assert torch.equal(relu, y * mask)
    assert torch.equal(leaky, y * torch.where(mask, 1.0, 0.2))
    assert kinks.flips["relu"] == kinks.flips["leaky_relu"] == int(
        ((y > 0) != mask).sum())
