"""Stream layout of the native (sidecar) container (PyTorch counterpart of
compression_tpu/models/native_format.py).

A latent [1, H, W, C] splits into H*k independent coder streams of
(W/k)*C symbols, k the smallest power of two dividing W with
(W/k)*C <= MAX_ELEMS.  k is a pure function of (W, C); decoders derive it
from the container's stream count instead, so containers of any split
policy stay decodable.
"""

import numpy as np

MAX_ELEMS = 512


def split_factor(w: int, c: int, max_elems: int = MAX_ELEMS) -> int:
    """Number of column blocks per row (power of 2 dividing w)."""
    k = 1
    while (w // k) * c > max_elems and w % (2 * k) == 0:
        k *= 2
    return k


def split_factor_from_streams(num_streams: int, h: int) -> int:
    """Split factor a container was actually written with."""
    k, rem = divmod(int(num_streams), int(h))
    if rem or k < 1:
        raise ValueError(
            f"Native container stream count {num_streams} is not a "
            f"positive multiple of the latent height {h}.")
    return k


def to_streams(lat):
    """[1, H, W, C] -> [H*k, 1, W//k, C] coder streams."""
    _, h, w, c = lat.shape
    k = split_factor(int(w), int(c))
    return lat[0].reshape(h * k, 1, w // k, c)


def from_streams(rows, h: int, w: int, c: int):
    """[H*k, 1, W//k, C] decoded rows -> [1, H, W, C]."""
    return rows.reshape(1, h, w, c)


def esc_to_pairs(esc_idx, esc_val, num_elements: int):
    """Flat escape positions/values -> container (pairs [K, 2], vals [K])
    int32, (stream, element) in ascending order as the host sidecar path
    writes them."""
    idx = np.asarray(esc_idx, np.int64)
    pairs = np.stack([idx // int(num_elements), idx % int(num_elements)],
                     axis=1).astype(np.int32)
    return pairs, np.asarray(esc_val, np.int32)
