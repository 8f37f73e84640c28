"""The port's run-length codes (ops/run_length.py, its C library
native/host_codecs.c) and the PowerLaw and Laplace entropy models against
the JAX package, on the CPU.

Bytes are compared exactly: the port's C bytes against JAX's and against
the port's own Python plain version, across the modes of
tests/test_run_length.py.  The models' penalty, quantization and gradient
within 1e-6 of JAX's."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from compression_tpu.entropy_models import LaplaceEntropyModel as JaxLaplace
from compression_tpu.entropy_models import PowerLawEntropyModel as JaxPowerLaw
from compression_tpu.ops import run_length as jax_rl
from compression_tpu_torch import native
from compression_tpu_torch.entropy_models.laplace import LaplaceEntropyModel
from compression_tpu_torch.entropy_models.power_law import (
    PowerLawEntropyModel)
from compression_tpu_torch.ops import run_length as rl

INT32_MIN, INT32_MAX = -(2**31), 2**31 - 1


def _sparse(seed, size, low, high, zeros):
    rng = np.random.RandomState(seed)
    data = rng.randint(low, high, size=size)
    data[rng.rand(size) < zeros] = 0
    return data.astype(np.int32)


DATA = {
    "golden": np.asarray([-6, 3, 0, 0], np.int32),
    "random0": _sparse(0, 500, -50, 50, 0.8),
    "random1": _sparse(1, 300, -30, 30, 0.7),
    "dense": _sparse(2, 200, -1000, 1000, 0.0),
    "one_zero": np.zeros(1, np.int32),
    "zeros": np.zeros(10, np.int32),
    "single": np.asarray([5], np.int32),
    "single_negative": np.asarray([-5], np.int32),
    "alternating": np.asarray([1, -1, 1, -1], np.int32),
    "ramp": np.arange(-5, 6, dtype=np.int32),
    "leading": np.asarray([0, 0, 5, 0, 0], np.int32),
    "trailing": np.asarray([7, 0, 0], np.int32),
    "zeros_first": np.asarray([0, 0, -7], np.int32),
    "no_zeros": np.asarray([1, 2, 3], np.int32),
    "extremes": np.asarray([INT32_MIN, 0, INT32_MAX, -1, 0, 0, 1],
                           np.int32),
}
# (run_length_code, magnitude_code, use_run_length_for_non_zeros): the
# modes of tests/test_run_length.py.
MODES = [(-1, -1, False), (0, -1, False), (-1, 2, False), (1, 1, False),
         (-1, -1, True), (0, 0, True), (2, 3, True), (0, 2, True),
         (1, -1, True)]


def _mode_cases():
    cases = []
    for name, data in DATA.items():
        for mode in MODES:
            if name == "extremes" and mode[1] >= 0 and mode[1] < 20:
                # A Rice magnitude of 2^31 >> k takes 2^31 >> k bits:
                # cover the extremes with gamma magnitudes and k = 20.
                continue
            cases.append((name, mode))
        if name == "extremes":
            cases.append((name, (1, 20, True)))
    return cases


@pytest.mark.parametrize("name", sorted(DATA))
def test_gamma_code_matches_jax(name):
    data = DATA[name]
    code = rl.run_length_gamma_encode(data)
    assert code == jax_rl.run_length_gamma_encode(data)
    assert code == rl.plain_run_length_gamma_encode(data)
    if name == "golden":
        assert code == bytes([0b11010001, 0b01101101])
    want = data.copy()
    want[want == INT32_MIN] += 1
    for decode in (rl.run_length_gamma_decode,
                   rl.plain_run_length_gamma_decode):
        np.testing.assert_array_equal(decode(code, data.shape), want)


@pytest.mark.parametrize("name,mode", _mode_cases(),
                         ids=[f"{n}-{m[0]}_{m[1]}_{int(m[2])}"
                              for n, m in _mode_cases()])
def test_run_length_code_matches_jax(name, mode):
    data = DATA[name]
    code = rl.run_length_encode(data, *mode)
    assert code == jax_rl.run_length_encode(data, *mode)
    assert code == rl.plain_run_length_encode(data, *mode)
    want = data.copy()
    if mode[1] < 0:
        want[want == INT32_MIN] += 1
    for decode in (rl.run_length_decode, rl.plain_run_length_decode):
        np.testing.assert_array_equal(decode(code, data.shape, *mode), want)


def test_bit_coder_round_trips():
    w = rl.BitWriter()
    pattern = [(1, 1), (3, 5), (8, 0xAB), (16, 0x1234), (1, 0), (5, 17)]
    for count, bits in pattern:
        w.write_bits(count, bits)
    for v in (1, 2, 3, 7, 8, 100, 2**20, 2**30):
        w.write_gamma(v)
    for v in (0, 1, 5, 63, 1000):
        w.write_rice(v, 3)
    data = w.get_data()
    jw = jax_rl.BitWriter()
    for count, bits in pattern:
        jw.write_bits(count, bits)
    for v in (1, 2, 3, 7, 8, 100, 2**20, 2**30):
        jw.write_gamma(v)
    for v in (0, 1, 5, 63, 1000):
        jw.write_rice(v, 3)
    assert data == jw.get_data()
    r = rl.BitReader(data)
    assert [r.read_bits(c) for c, _ in pattern] == [b for _, b in pattern]
    assert [r.read_gamma() for _ in range(8)] == [
        1, 2, 3, 7, 8, 100, 2**20, 2**30]
    assert [r.read_rice(3) for _ in range(5)] == [0, 1, 5, 63, 1000]
    with pytest.raises(ValueError):
        rl.BitReader(b"\x01").read_bits(9)


def test_decoders_reject_truncated_codes():
    code = rl.run_length_encode(DATA["random0"], 0, 1, True)
    for decode in (rl.run_length_decode, rl.plain_run_length_decode):
        with pytest.raises(ValueError):
            decode(code[: len(code) // 2], (500,), 0, 1, True)
    code = rl.run_length_gamma_encode(DATA["random0"])
    for decode in (rl.run_length_gamma_decode,
                   rl.plain_run_length_gamma_decode):
        with pytest.raises(ValueError):
            decode(code, (400,))


def test_library_raises_without_a_compiler(monkeypatch, tmp_path):
    """No C compiler, then one that fails: the build raises, and nothing
    falls back."""
    monkeypatch.setattr(native, "_HOST_CODECS_LIB", None)
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="cc / gcc / clang not found"):
        rl.run_length_gamma_encode(DATA["golden"])
    monkeypatch.setattr(native.shutil, "which", lambda name: "false")
    with pytest.raises(RuntimeError, match="build of host_codecs.so failed"):
        rl.run_length_decode(b"", (1,))


# -- PowerLaw and Laplace ------------------------------------------------------
def _latent(seed, shape, scale):
    rng = np.random.RandomState(seed)
    return (rng.laplace(0, scale, shape) + rng.uniform(-.5, .5, shape)
            ).astype(np.float32)


LAPLACE_MODES = [(-1, 0, False), (0, 1, True), (-1, -1, False),
                 (2, 3, True), (1, -1, True)]
MODELS = ([("power_law", rank, None) for rank in (0, 1, 2)]
          + [("laplace", rank, mode) for rank in (0, 1, 2)
             for mode in LAPLACE_MODES])


def _models(kind, rank, mode):
    if kind == "power_law":
        return (PowerLawEntropyModel(rank, alpha=0.05),
                JaxPowerLaw(rank, alpha=0.05))
    kw = dict(l1=0.02, run_length_code=mode[0], magnitude_code=mode[1],
              use_run_length_for_non_zeros=mode[2])
    return LaplaceEntropyModel(rank, **kw), JaxLaplace(rank, **kw)


@pytest.mark.parametrize(
    "kind,rank,mode", MODELS,
    ids=[f"{k}-rank{r}" + (f"-{m[0]}_{m[1]}_{int(m[2])}" if m else "")
         for k, r, m in MODELS])
def test_entropy_model_matches_jax(kind, rank, mode):
    mine, ref = _models(kind, rank, mode)
    x = _latent(rank, (3, 4, 6), 3.0)
    q, penalty = mine(torch.tensor(x))
    jq, jpenalty = ref(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(penalty.numpy(), np.asarray(jpenalty),
                               rtol=1e-6, atol=1e-6)
    t = torch.tensor(x, requires_grad=True)
    torch.sum(mine.penalty(t) ** 2).backward()
    want = jax.grad(lambda v: jnp.sum(ref.penalty(v) ** 2))(jnp.asarray(x))
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    t = torch.tensor(x, requires_grad=True)
    torch.sum(mine.quantize(t) * 2).backward()
    assert torch.equal(t.grad, torch.full_like(t, 2.0))

    strings = mine.compress(x)
    assert strings == ref.compress(x)
    assert strings == mine.compress(torch.tensor(x))
    code_shape = x.shape[x.ndim - rank:]
    back = mine.decompress(strings, code_shape, device="cpu")
    assert back.dtype == torch.float32 and back.device.type == "cpu"
    np.testing.assert_array_equal(back.numpy().reshape(x.shape), np.round(x))


def test_entropy_models_refuse_card_tensors(monkeypatch):
    x = torch.ones(2, 3)
    monkeypatch.setattr(torch.Tensor, "device",
                        property(lambda self: torch.device("cuda", 0)))
    for em in (PowerLawEntropyModel(1), LaplaceEntropyModel(1)):
        with pytest.raises(ValueError, match=r"\.cpu\(\)"):
            em.compress(x)


def test_decompress_defaults_to_the_card():
    em = PowerLawEntropyModel(1)
    strings = em.compress(np.ones((2, 3), np.float32))
    if torch.cuda.is_available():
        assert em.decompress(strings, (3,)).is_cuda
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            em.decompress(strings, (3,))


def test_entropy_models_reject_bad_arguments():
    for bad in (dict(coding_rank=-1), dict(coding_rank=1, alpha=0.0)):
        with pytest.raises(ValueError):
            PowerLawEntropyModel(**bad)
    for bad in (dict(coding_rank=-1), dict(coding_rank=1, l1=0.0)):
        with pytest.raises(ValueError):
            LaplaceEntropyModel(**bad)
