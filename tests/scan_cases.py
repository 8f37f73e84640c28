"""Micro-op inputs for the micro-op encode scan (K6's micro-op mode), shared
by tests/test_torch_scan_warp.py, tests/test_torch_cuda.py and
chip_smoke.py (which loads this file by path).  numpy only, plus the port's
mirror of the warp kernel's state to steer the constructed carry cases."""

import numpy as np


def valid_micro_ops(rng, num_steps, num_streams, coded=1.0, precs=(1, 17)):
    """Random valid micro-ops [T, S] as int64 arrays (0 <= lower < upper <=
    2^prec) and a bool mask, a step coded with probability ``coded``;
    about half of the masked steps hold noise in lower."""
    prec = rng.randint(*precs, (num_steps, num_streams))
    span = 1 << prec
    lower = (rng.rand(num_steps, num_streams) * span).astype(np.int64)
    width = 1 + (rng.rand(num_steps, num_streams) ** 3
                 * (span - lower)).astype(np.int64)
    upper = np.minimum(lower + width, span)
    mask = rng.rand(num_steps, num_streams) < coded
    noise = rng.rand(num_steps, num_streams) < 0.5
    lower = np.where(~mask & noise, rng.randint(0, 1 << 17, lower.shape),
                     lower)
    return lower, upper, prec, mask


def limit_micro_ops(rng, num_steps, num_streams):
    """Coded micro-ops [T, S] at the limits of the valid range: at
    precision 1, 2, 15 or 16, the whole range [0, 2^prec), its first entry
    [0, 1) or its last [2^prec - 1, 2^prec), in seeded order."""
    prec = rng.choice([1, 2, 15, 16], (num_steps, num_streams))
    span = 1 << prec
    kind = rng.randint(0, 3, (num_steps, num_streams))
    lower = np.where(kind == 2, span - 1, 0)
    upper = np.where(kind == 1, 1, span)
    return lower, upper, prec, np.ones((num_steps, num_streams), bool)


def as_tensors(ops, device="cpu"):
    """Micro-ops as the scan's arguments: int32 lower, upper and prec and a
    bool mask, on ``device``."""
    import torch
    return tuple(torch.as_tensor(np.asarray(x, np.int32), device=device)
                 for x in ops[:3]) + (
                     torch.as_tensor(np.asarray(ops[3], bool), device=device),)


class _Discard:
    """A row that drops what is written to it."""

    def __setitem__(self, index, value):
        pass


def long_carry_ops(direction, fill_chunks, seed, tail=50):
    """Micro-ops of one stream at precision 16 that open a delayed-carry
    group, keep the interval straddling 2^32 through ``fill_chunks``
    renormalizations, then resolve it up (the base carries out of 2^32:
    0x00 fill) or down (0xFF fill), then code ``tail`` random steps.
    Returns ((lower, upper, prec, mask) [T, 1], the fill run's length)."""
    from compression_tpu_torch.codec import cuda_coder
    rng = np.random.RandomState(seed)
    state = cuda_coder._WarpScanMirror(_Discard())  # its state alone
    pairs = []

    def code(lo, hi):
        state.step(cuda_coder.scan_op(lo, hi, 16))
        pairs.append((lo, hi))

    while not state.pend:  # random steps until a group opens
        lo = int(rng.randint(0, 65535))
        code(lo, int(min(65536, lo + rng.randint(1, 3000))))
    while state.fill < fill_chunks:
        # The narrowest interval that keeps 2^32 inside: x is its offset
        # from base, and c the last entry with (size * c) >> 16 below it.
        x = (1 << 32) - state.base
        c = max(0, -(-(x << 16) // (state.sm1 + 1)) - 1)
        for lo, hi in ((c, c + 1), (c, c + 2), (max(c - 1, 0), c + 2)):
            if hi <= 65536 and cuda_coder.scan_chain32(
                    state.base, state.sm1, cuda_coder.scan_op(lo, hi, 16))[3]:
                break
        code(lo, hi)
        assert state.pend
    run = state.fill
    code(*((65535, 65536) if direction == "up" else (0, 1)))
    for _ in range(tail):
        lo = int(rng.randint(0, 65535))
        code(lo, int(min(65536, lo + rng.randint(1, 5000))))
    lower, upper = (np.asarray(v, np.int64)[:, None] for v in zip(*pairs))
    return (lower, upper, np.full_like(lower, 16),
            np.ones(lower.shape, bool)), run
