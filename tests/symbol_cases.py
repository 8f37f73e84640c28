"""Symbol inputs for the symbol encoders K1 and K6' (``encode_indexed``,
``encode_gamma``) and their warp-per-stream kernels, shared by
tests/test_torch_symbol_warp.py, tests/test_torch_cuda.py and chip_smoke.py
(which loads this file by path).  numpy and the port's table builder only.

Each case is (ragged table, symbols int32 [S, N], indexes int32 [S, N]);
the ragged arrays (``tables.build_ragged_cdf``) parse into the port's and
the JAX package's tables alike.  Escapes sit where the warp kernel's paths
meet: lane 0 and lane 31 of a window, several in one window, the stream's
last, partial window, negative ones and the largest magnitudes (g = 2^31,
65 coded steps for one symbol)."""

import math

import numpy as np

INT32_MIN, INT32_MAX = -2 ** 31, 2 ** 31 - 1


def gaussian_ragged(num_rows=8, precision=12):
    """A small Gaussian overflow table: NoisyNormal-like rows for scales
    exp(linspace(log 0.5, log 40)), tail mass 2^-8 (bench.py's indexed
    regime at a small size)."""
    from compression_tpu_torch.codec import tables
    scales = np.exp(np.linspace(np.log(0.5), np.log(40.0), num_rows))
    cdfs = []
    for s in scales:
        half = int(min(np.ceil(4 * s) + 2, 160))
        x = np.arange(-half, half + 1)
        cdf = np.asarray([0.5 * (1 + math.erf(v / (s * math.sqrt(2))))
                          for v in np.concatenate([x - 0.5, x[-1:] + 0.5])])
        pmf = np.maximum(np.diff(cdf), 1e-12)
        cdfs.append(tables.pmf_to_quantized_cdf(
            pmf / pmf.sum() * (1 - 2 ** -8), precision))
    return tables.build_ragged_cdf(cdfs, [precision] * num_rows,
                                   [True] * num_rows)


def mixed_ragged(rng, overflows, precs):
    """Random rows of 2..30 symbols (fewer at low precision) with the given
    overflow flags and precisions."""
    from compression_tpu_torch.codec import tables
    cdfs = []
    for prec in precs:
        alphabet = int(rng.randint(2, max(3, min(31, 2 ** prec))))
        cdfs.append(tables.pmf_to_quantized_cdf(
            rng.dirichlet(np.ones(alphabet)), prec))
    return tables.build_ragged_cdf(cdfs, list(precs), list(overflows))


def _in_range(rng, ragged, streams, n):
    """Symbols inside their rows' ranges (below the marker), rows at
    random; returns (symbols, indexes, each element's marker)."""
    from compression_tpu_torch.codec import tables
    length = np.asarray(tables.parse_ragged_cdf(ragged).length)
    idx = rng.randint(0, len(length), (streams, n))
    sym = (rng.rand(streams, n) * (length[idx] - 2)).astype(np.int64)
    return sym, idx, length[idx] - 2


def _placements(rng):
    """Seven streams of 100 symbols (three full windows and one of four),
    escapes planted where the warp kernel's paths meet."""
    ragged = gaussian_ragged()
    sym, idx, marker = _in_range(rng, ragged, 7, 100)
    over = marker + 1  # the first value past an overflow row's range
    for j in (0, 32):  # lane 0
        sym[0, j] = over[0, j]
    for j in (31, 63):  # lane 31
        sym[1, j] = over[1, j] + 3
    for j in (96, 98, 99):  # the last, partial window
        sym[2, j] = over[2, j] + 700
    for j in (40, 41, 45, 60, 63, 71):  # several in one window
        sym[3, j] = over[3, j] + j
    sym[4, 5], sym[4, 50], sym[4, 51] = -3, -1000, -1  # negative
    # The largest magnitudes: g = 2^31 (INT32_MIN), 2^31 - marker (INT32_MAX)
    # and 2^31 - 1.
    for j, v in ((10, INT32_MIN), (20, INT32_MAX), (30, -INT32_MAX),
                 (33, 2 ** 30), (99, INT32_MIN)):
        sym[5, j] = v
    return ragged, sym, idx  # stream 6 has no escape


def _random_escapes(rng, ragged, streams, n, rate=1 / 16):
    sym, idx, marker = _in_range(rng, ragged, streams, n)
    esc = rng.rand(streams, n) < rate
    big = marker + 1 + rng.randint(0, 5000, (streams, n))
    neg = -1 - rng.randint(0, 5000, (streams, n))
    sym = np.where(esc, np.where(rng.rand(streams, n) < 0.5, big, neg), sym)
    return ragged, sym, idx


def symbol_case(name):
    """(ragged, symbols int32 [S, N], indexes int32 [S, N]) of SYMBOL_CASES'
    case ``name``."""
    rng = np.random.RandomState(sorted(SYMBOL_CASES).index(name))
    kind, n = SYMBOL_CASES[name]
    if kind == "placements":
        ragged, sym, idx = _placements(rng)
    elif kind == "gaussian":
        ragged, sym, idx = _random_escapes(rng, gaussian_ragged(), 3, n)
    elif kind == "mixed":
        # Overflow and bounded rows at precisions 1 ... 16: values past a
        # bounded row's range are clipped, on an overflow row escaped.
        overflows = [True, False, True, False, True, True]
        ragged = mixed_ragged(rng, overflows, [16, 1, 2, 9, 13, 16])
        _, sym, idx = _random_escapes(rng, ragged, 4, n, rate=0.1)
    elif kind == "all_escapes":
        # Every symbol escapes: the largest magnitudes (65 steps each)
        # back to back, then small negative and positive ones.
        ragged = gaussian_ragged()
        sym, idx, marker = _in_range(rng, ragged, 3, n)
        sym[0] = np.where(np.arange(n) % 2, INT32_MIN, INT32_MAX)
        sym[1] = -1 - np.arange(n)
        sym[2] = marker[2] + 1 + np.arange(n)
    else:  # precision 16 throughout
        ragged = mixed_ragged(rng, [True] * 4, [16] * 4)
        _, sym, idx = _random_escapes(rng, ragged, 3, n, rate=0.02)
    return (ragged, np.asarray(sym, np.int64).astype(np.int32),
            np.asarray(idx, np.int32))


def short_row_case(name):
    """symbol_case(name)'s streams, each between two escape-free streams
    (its own values moved into their rows' ranges), as one launch: a row
    sized for the symbols alone (2 N + 2 bytes) is too short for the
    escaping streams' Elias-gamma steps, and the streams beside one that
    is cut must come out whole.  Returns (ragged, symbols, indexes)."""
    from compression_tpu_torch.codec import tables
    ragged, sym, idx = symbol_case(name)
    marker = np.asarray(tables.parse_ragged_cdf(ragged).length)[idx] - 2
    clean = np.clip(sym, 0, marker - 1).astype(np.int32)
    order = [clean[0]] + [r for s in range(len(sym))
                          for r in (sym[s], clean[(s + 1) % len(sym)])]
    rows = [idx[0]] + [r for s in range(len(sym))
                       for r in (idx[s], idx[(s + 1) % len(sym)])]
    return ragged, np.stack(order), np.stack(rows)


# name -> (kind, symbols a stream)
SYMBOL_CASES = {
    "placements": ("placements", 100),
    "all_escapes": ("all_escapes", 70),
    "length_0": ("gaussian", 0),
    "length_1": ("gaussian", 1),
    "length_31": ("gaussian", 31),
    "length_32": ("gaussian", 32),
    "length_33": ("gaussian", 33),
    "length_65": ("gaussian", 65),
    "mixed_rows": ("mixed", 90),
    "precision_16": ("p16", 400),
}
