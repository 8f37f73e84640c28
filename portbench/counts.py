"""The yardstick's arithmetic: published peaks, the operations of the
transforms from their published shapes, the bytes and operations a coder
kernel needs, and the coder chains' floors.

Counts follow the work the configuration states, whatever implements it:
a convolution counts 2 x in x out x k x k per output position, a
transposed (upsampling) one per input position, GDN's channel mixing 2 x
C x C per position; element-wise work and the kernels' RDFT
reparameterization are not counted.
"""

from __future__ import annotations

import math

# Published H100 SXM peaks (NVIDIA's data sheet, dense): HBM bandwidth, and
# the float32 rate outside the tensor cores, which the configurations'
# float32 (TF32 off) convolutions run at, and which the coder kernels'
# scalar integer work is counted against.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOP_PER_S = 67e12
PEAK_SCALAR_OPS_PER_S = 67e12


def conv(cin, cout, k, positions):
    """Flop of a k x k convolution over ``positions`` output positions (or
    input positions, for a transposed one)."""
    return 2 * cin * cout * k * k * positions


def mix(c, positions):
    """Flop of GDN's C x C channel mixing."""
    return 2 * c * c * positions


def least_seconds(nbytes, ops):
    """The least time a kernel can take: the larger of its bytes over the
    memory bandwidth and its operations over the scalar rate."""
    return max(nbytes / PEAK_BYTES_PER_S, ops / PEAK_SCALAR_OPS_PER_S)


def decode_cost(stream_bytes, n, table_entries, max_len, with_indexes):
    """(bytes, operations) of decoding one stream of ``n`` symbols: the
    stream, its length, the indexes (when the kernel takes them) and the
    table read once, the symbols and the sanity flag written once; ~2
    operations per binary-search probe and ~10 for the update a symbol."""
    nbytes = (stream_bytes + 4 + (4 * n if with_indexes else 0)
              + 4 * table_entries + 4 * n + 1)
    probes = math.ceil(math.log2(max(max_len - 1, 2)))
    return nbytes, (2 * probes + 10) * n


def encode_cost(stream_bytes, n, table_entries, with_indexes):
    """(bytes, operations) of encoding one stream of ``n`` symbols: the
    symbols, the indexes (when the kernel takes them) and the table read
    once, the stream and its length written once; ~12 operations a coded
    interval (two 64-bit products, two shifts, four adds, three compares,
    the escape select)."""
    nbytes = (4 * n + (4 * n if with_indexes else 0) + 4 * table_entries
              + stream_bytes + 4)
    return nbytes, 12 * n


# The coder chains' floors (ms): symbols x the dependent operations of one
# step in the compiled kernels (cuobjdump -sass) x their nominal latencies,
# 4 clocks a register operation and 23 a shared-memory load, at the card's
# highest SM clock.  Not measured; kept for the chain-floor metrics.
def warp_floor_ms(intervals, max_len, clock_mhz):
    """K3' (warp per stream): 15 register operations and one shared load a
    coded interval, 7 more and a second load for rows over 129 entries."""
    clocks = 15 * 4 + 23 + (7 * 4 + 23 if max_len > 129 else 0)
    return intervals * clocks / (clock_mhz * 1e3)


def slot_floor_ms(symbols, precision, clock_mhz):
    """K5': 21 register operations and one shared load a symbol; above
    precision 14, 23 and two loads."""
    clocks = 21 * 4 + 23 if precision <= 14 else 23 * 4 + 2 * 23
    return symbols * clocks / (clock_mhz * 1e3)


def bucketed_floor_ms(symbols, num_buckets, clock_mhz):
    """K8' on a row of at most 64 buckets: 13 + q + 5 + 8 + 6 register
    operations over q quads of buckets and two shared loads a symbol."""
    quads = -(-num_buckets // 4)
    clocks = (13 + quads + 5 + 8 + 6) * 4 + 2 * 23
    return symbols * clocks / (clock_mhz * 1e3)


SCAN_CHAIN_OPS = 6


def scan_floor_ms(coded_steps, clock_mhz):
    """The micro-op scan (warp per stream): SCAN_CHAIN_OPS register
    operations a coded step."""
    return coded_steps * SCAN_CHAIN_OPS * 4 / (clock_mhz * 1e3)
