"""xoshiro256+ PRNG with std::seed_seq seeding — the exact random stream
of the reference StochasticRound CPU kernel.

The reference seeds four 64-bit xoshiro256+ state words from the int32
`seed` input through C++ `std::seed_seq::generate` (reference
cc/kernels/quantization_kernels.cc:68-81) and draws one 24-bit uniform
per element from the top bits of each output (`:83-95`).  Reproducing
that stream bit for bit makes seeded stochastic rounding reproducible
across this implementation and the reference, which a generic PRNG
cannot do.

The generator is sequential by construction; this module evaluates it
with Python-integer arithmetic (exact mod-2^64), fast enough for
host-side parity work.  A copy of compression_tpu/util/xoshiro.py; the
device path is ``ops/quantization.stochastic_round``.
"""

from __future__ import annotations

import numpy as np

__all__ = ["seed_seq_generate", "state_from_seed", "xoshiro256plus",
           "uniform24_stream"]

_M32 = 0xFFFFFFFF
_M64 = 0xFFFFFFFFFFFFFFFF


def seed_seq_generate(seeds, n_words):
    """C++ std::seed_seq(seeds...).generate() of `n_words` uint32 words.

    Exact transcription of the algorithm specified in [rand.util.seedseq]
    (the same on every conforming C++ standard library).
    """
    v = [int(s) & _M32 for s in seeds]
    n = int(n_words)
    if n == 0:
        return np.zeros(0, np.uint32)
    w = [0x8B8B8B8B] * n
    s = len(v)
    if n >= 623:
        t = 11
    elif n >= 68:
        t = 7
    elif n >= 39:
        t = 5
    elif n >= 7:
        t = 3
    else:
        t = (n - 1) // 2
    p = (n - t) // 2
    q = p + t
    m = max(s + 1, n)

    def T(x):
        return (x ^ (x >> 27)) & _M32

    for k in range(m):
        r1 = (1664525 * T(w[k % n] ^ w[(k + p) % n] ^ w[(k - 1) % n])) & _M32
        if k == 0:
            r2 = (r1 + s) & _M32
        elif k <= s:
            r2 = (r1 + k % n + v[k - 1]) & _M32
        else:
            r2 = (r1 + k % n) & _M32
        w[(k + p) % n] = (w[(k + p) % n] + r1) & _M32
        w[(k + q) % n] = (w[(k + q) % n] + r2) & _M32
        w[k % n] = r2
    for k in range(m, m + n):
        r3 = (1566083941
              * T((w[k % n] + w[(k + p) % n] + w[(k - 1) % n]) & _M32)) & _M32
        r4 = (r3 - (k % n)) & _M32
        w[(k + p) % n] ^= r3
        w[(k + q) % n] ^= r4
        w[k % n] = r4
    return np.asarray(w, np.uint32)


def state_from_seed(seeds):
    """Reference kernel's state setup: 8 seed_seq words reinterpreted as
    four little-endian uint64 state words."""
    words = seed_seq_generate(seeds, 8)
    state = []
    for i in range(4):
        state.append(int(words[2 * i]) | (int(words[2 * i + 1]) << 32))
    return state


def xoshiro256plus(state, n):
    """Draws `n` uint64 outputs; returns (outputs, final_state).

    state: list of four ints (mutated copy returned, not in place).
    """
    s0, s1, s2, s3 = (int(x) & _M64 for x in state)
    out = np.empty(n, np.uint64)
    for i in range(n):
        out[i] = (s0 + s3) & _M64
        t = (s1 << 17) & _M64
        s2 ^= s0
        s3 ^= s1
        s1 ^= s2
        s0 ^= s3
        s2 ^= t
        s3 = ((s3 << 45) | (s3 >> 19)) & _M64
    return out, [s0, s1, s2, s3]


def uniform24_stream(seeds, n):
    """The reference kernel's uniform stream: (x >> 40) * 2^-24 in [0,1)."""
    state = state_from_seed(seeds)
    raw, _ = xoshiro256plus(state, n)
    return ((raw >> np.uint64(40)).astype(np.float32)
            * np.float32(2.0 ** -24))
