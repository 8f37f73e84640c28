"""Philox4x32-10 counter-based RNG, bit-exact with TF stateless RNG ops (a
copy of compression_tpu/util/philox.py, numpy only).

The universal-quantization entropy models (reference universal.py:30-41)
derive their shared dither from ``tf.random.stateless_uniform(shape,
seed=(1234, 1234), minval=0, maxval=L, dtype=int32)``.  That op is the
Philox4x32-10 generator (reference of the algorithm: Salmon et al., "Parallel
random numbers: as easy as 1, 2, 3", SC'11) with TensorFlow's specific seed
scramble (tensorflow/core/kernels/stateless_random_ops.cc, GenerateKey) and
its int32 uniform mapping ``lo + (u32 % range)``
(tensorflow/core/lib/random/random_distributions.h,
UniformDistribution<..., int32>).

This module reproduces that stream exactly, in vectorized numpy with
integer arithmetic only (the 32-bit multiply-high is a u64 product), so a
decoder built on the port produces the same dither levels as one built on
the reference or on the JAX package.

Being counter-based, the whole array is generated in one vectorized pass
(10 rounds of u32 multiplies over ceil(n/4) lanes) -- no sequential state.
"""

from __future__ import annotations

import numpy as np

__all__ = ["stateless_uniform_int32", "philox_4x32_10"]

# Philox 4x32 round constants.
_M0 = np.uint64(0xD2511F53)
_M1 = np.uint64(0xCD9E8D57)
_W0 = np.uint32(0x9E3779B9)
_W1 = np.uint32(0xBB67AE85)
# TF's fixed initial key for the seed scramble (stateless_random_ops.cc).
_SCRAMBLE_KEY = (np.uint32(0x3EC8F720), np.uint32(0x02461E29))

_MASK32 = np.uint64(0xFFFFFFFF)


def _mulhilo(a, b):
    """(hi, lo) 32-bit halves of the 64-bit product a*b (u32 inputs)."""
    p = a.astype(np.uint64) * np.uint64(b)
    return (p >> np.uint64(32)).astype(np.uint32), (p & _MASK32).astype(
        np.uint32)


def philox_4x32_10(counter, key):
    """One Philox4x32-10 block per lane.

    Args:
      counter: tuple/list of four u32 numpy arrays (lanes), c0..c3.
      key: tuple of two u32 scalars or arrays, k0, k1.

    Returns:
      Four u32 arrays: the generator output for each lane's counter.
    """
    c0, c1, c2, c3 = (np.asarray(c, np.uint32) for c in counter)
    k0 = np.uint32(key[0]) + np.zeros_like(c0)
    k1 = np.uint32(key[1]) + np.zeros_like(c0)
    for r in range(10):
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = (hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0)
        if r != 9:
            k0 = k0 + _W0
            k1 = k1 + _W1
    return c0, c1, c2, c3


def _generate_key(seed0, seed1):
    """TF GenerateKey: scramble two int seeds into (key, counter) state.

    Key = first two words of Philox over the raw seeds with a fixed key;
    counter = (0, 0, mix2, mix3).
    """
    s0 = np.uint64(np.int64(seed0)) & np.uint64(0xFFFFFFFFFFFFFFFF)
    s1 = np.uint64(np.int64(seed1)) & np.uint64(0xFFFFFFFFFFFFFFFF)
    counter = (
        np.uint32(s0 & _MASK32),
        np.uint32(s0 >> np.uint64(32)),
        np.uint32(s1 & _MASK32),
        np.uint32(s1 >> np.uint64(32)),
    )
    mix = philox_4x32_10([np.asarray([c]) for c in counter], _SCRAMBLE_KEY)
    key = (np.uint32(mix[0][0]), np.uint32(mix[1][0]))
    counter = (np.uint32(0), np.uint32(0), np.uint32(mix[2][0]),
               np.uint32(mix[3][0]))
    return key, counter


def _raw_u32(n, seed):
    """First ``n`` u32 outputs of the TF stateless Philox stream."""
    key, base = _generate_key(seed[0], seed[1])
    groups = (n + 3) // 4
    # 128-bit counter increments: counter word 0 is the low word.
    g = np.arange(groups, dtype=np.uint64)
    c0 = (np.uint64(base[0]) + g)
    carry0 = (c0 >> np.uint64(32)).astype(np.uint64)
    c1 = np.uint64(base[1]) + carry0
    carry1 = (c1 >> np.uint64(32)).astype(np.uint64)
    c2 = np.uint64(base[2]) + carry1
    carry2 = (c2 >> np.uint64(32)).astype(np.uint64)
    c3 = np.uint64(base[3]) + carry2
    counter = [
        (c & _MASK32).astype(np.uint32) for c in (c0, c1, c2, c3)]
    out = philox_4x32_10(counter, key)
    # Group g fills outputs [4g, 4g+4): interleave the four words.
    flat = np.stack(out, axis=1).reshape(-1)
    return flat[:n]


def stateless_uniform_int32(shape, seed, minval, maxval):
    """Bit-exact ``tf.random.stateless_uniform(dtype=int32)``.

    Maps each raw u32 as ``minval + (u % (maxval - minval))`` — TF's
    UniformDistribution<int32> (modulo bias and all).
    """
    shape = tuple(int(s) for s in shape)
    n = int(np.prod(shape)) if shape else 1
    lo = np.int64(minval)
    rng = np.uint32(np.int64(maxval) - lo)
    u = _raw_u32(n, seed)
    vals = (lo + (u % rng).astype(np.int64)).astype(np.int32)
    return vals.reshape(shape)
