"""The port's stochastic rounding (ops/quantization.py) and its xoshiro256+
stream (util/xoshiro.py) against the JAX package and the reference's golden
cases, on the CPU.

Exact throughout: the reference form is bit for bit the compiled reference
kernel's (tests/golden/golden_quant.npz, the cases
tests/test_misc_ops.py::test_golden_cases reads) and JAX's; the device form,
given the 32-bit draws JAX's takes from ``jax.random.bits``, returns JAX's
integers."""

import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from compression_tpu.ops import quantization as jax_quantization
from compression_tpu.util import xoshiro as jax_xoshiro
from compression_tpu_torch.ops import quantization
from compression_tpu_torch.util import xoshiro

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "golden_quant.npz")


def _golden_cases():
    gold = dict(np.load(GOLDEN))
    return gold, [n.decode() for n in gold["cases"]]


@pytest.mark.parametrize("name", _golden_cases()[1])
def test_reference_golden_bit_exact(name):
    gold, _ = _golden_cases()
    x = gold[f"{name}__x"]
    dt = bytes(gold[f"{name}__dtype"]).decode()
    step = float(gold[f"{name}__step"])
    seed = gold[f"{name}__seed"]
    if dt == "bf16":
        mine_in, jax_in = torch.tensor(x).to(torch.bfloat16), jnp.asarray(
            x, jnp.bfloat16)
    elif dt == "f16":
        mine_in = jax_in = x.astype(np.float16)
    else:
        mine_in = jax_in = x
    got = quantization.stochastic_round_reference(mine_in, step, seed)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, gold[f"{name}__out"])
    np.testing.assert_array_equal(
        got, jax_quantization.stochastic_round_reference(jax_in, step, seed))


@pytest.mark.parametrize("seeds", [[0], [42], [7, -3], [2**31 - 1, 5, 9]])
def test_xoshiro_stream_matches_jax(seeds):
    np.testing.assert_array_equal(xoshiro.seed_seq_generate(seeds, 8),
                                  jax_xoshiro.seed_seq_generate(seeds, 8))
    assert xoshiro.state_from_seed(seeds) == jax_xoshiro.state_from_seed(
        seeds)
    np.testing.assert_array_equal(xoshiro.uniform24_stream(seeds, 257),
                                  jax_xoshiro.uniform24_stream(seeds, 257))


@pytest.mark.parametrize("step", [1.0, 0.5, 0.1, 3.0])
def test_device_form_equals_jax_on_its_bits(step):
    rng = np.random.RandomState(int(step * 10))
    x = (rng.normal(0, 4, (3, 257)) * 1.0).astype(np.float32)
    key = jax.random.PRNGKey(int(step * 10))
    want = np.asarray(jax_quantization.stochastic_round(x, step, key))
    bits = np.asarray(jax.random.bits(key, x.shape, jnp.uint32))
    got = quantization._stochastic_round_bits(
        torch.tensor(x), step, torch.tensor(bits.astype(np.int64)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_device_form_integral_inputs_deterministic():
    x = torch.tensor([2.0, -4.0, 0.0, 7.0])
    for seed in range(4):
        gen = torch.Generator().manual_seed(seed)
        assert quantization.stochastic_round(x, 1.0, gen).tolist() == [
            2, -4, 0, 7]


def test_device_form_distribution_and_seed():
    x = torch.full((20000,), 1.25)
    out = quantization.stochastic_round(
        x, 0.5, torch.Generator().manual_seed(0))
    assert set(out.unique().tolist()) == {2, 3}
    assert abs(float(out.float().mean()) - 2.5) < 0.02
    again = quantization.stochastic_round(
        x, 0.5, torch.Generator().manual_seed(0))
    assert torch.equal(out, again)


def test_reference_rejects_empty_seed_and_card_tensors(monkeypatch):
    with pytest.raises(ValueError):
        quantization.stochastic_round_reference(np.ones(4, np.float32), 1.0,
                                                [])
    x = torch.ones(4)
    monkeypatch.setattr(torch.Tensor, "device",
                        property(lambda self: torch.device("cuda", 0)))
    with pytest.raises(ValueError, match=r"\.cpu\(\)"):
        quantization.stochastic_round_reference(x, 1.0, [1])
