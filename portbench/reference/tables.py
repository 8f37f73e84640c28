"""The range coder's CDF tables, worked out again from the priors.

A range decoder needs the encoder's table bit for bit, so this follows
TFC's table build (python/entropy_models/continuous_base.py): tails ->
integer supports -> the prior's mass at each integer, in float32 -> an
overflow bin -> TFC's greedy integer quantization
(cc/kernels/pmf_to_cdf_kernels.cc).  The quantizer seeds its repair queue
with libstdc++'s unstable ``std::sort``, whose order of equal keys decides
which of two equally cheap symbols is adjusted first; ``std_sort`` below
is that algorithm (introsort, median of three, a final insertion sort),
so equal keys come out in the same order.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference import distributions

TAIL_MASS = 2.0**-8

_THRESHOLD = 16


def std_sort(seq, less):
    """Sorts the list ``seq`` in place as libstdc++'s std::sort does."""
    n = len(seq)
    if n < 2:
        return
    _introsort_loop(seq, 0, n, 2 * int(math.floor(math.log2(n))), less)
    if n > _THRESHOLD:
        _insertion_sort(seq, 0, _THRESHOLD, less)
        for i in range(_THRESHOLD, n):
            _unguarded_linear_insert(seq, i, less)
    else:
        _insertion_sort(seq, 0, n, less)


def _introsort_loop(seq, first, last, depth, less):
    while last - first > _THRESHOLD:
        if depth == 0:
            _heap_sort(seq, first, last, less)
            return
        depth -= 1
        mid = first + (last - first) // 2
        _move_median_to_first(seq, first, first + 1, mid, last - 1, less)
        cut = _unguarded_partition(seq, first + 1, last, first, less)
        _introsort_loop(seq, cut, last, depth, less)
        last = cut


def _move_median_to_first(seq, result, a, b, c, less):
    if less(seq[a], seq[b]):
        if less(seq[b], seq[c]):
            pick = b
        elif less(seq[a], seq[c]):
            pick = c
        else:
            pick = a
    elif less(seq[a], seq[c]):
        pick = a
    elif less(seq[b], seq[c]):
        pick = c
    else:
        pick = b
    seq[result], seq[pick] = seq[pick], seq[result]


def _unguarded_partition(seq, first, last, pivot, less):
    while True:
        while less(seq[first], seq[pivot]):
            first += 1
        last -= 1
        while less(seq[pivot], seq[last]):
            last -= 1
        if not first < last:
            return first
        seq[first], seq[last] = seq[last], seq[first]
        first += 1


def _insertion_sort(seq, first, last, less):
    for i in range(first + 1, last):
        if less(seq[i], seq[first]):
            val = seq[i]
            seq[first + 1: i + 1] = seq[first: i]
            seq[first] = val
        else:
            _unguarded_linear_insert(seq, i, less)


def _unguarded_linear_insert(seq, last, less):
    val = seq[last]
    nxt = last - 1
    while less(val, seq[nxt]):
        seq[last] = seq[nxt]
        last = nxt
        nxt -= 1
    seq[last] = val


def _adjust_heap(seq, first, hole, length, value, less):
    top = hole
    child = hole
    while child < (length - 1) // 2:
        child = 2 * (child + 1)
        if less(seq[first + child], seq[first + child - 1]):
            child -= 1
        seq[first + hole] = seq[first + child]
        hole = child
    if (length & 1) == 0 and child == (length - 2) // 2:
        child = 2 * (child + 1)
        seq[first + hole] = seq[first + child - 1]
        hole = child - 1
    parent = (hole - 1) // 2
    while hole > top and less(seq[first + parent], value):
        seq[first + hole] = seq[first + parent]
        hole = parent
        parent = (hole - 1) // 2
    seq[first + hole] = value


def _heap_sort(seq, first, last, less):
    """std::__partial_sort(first, last, last): make_heap, then sort_heap."""
    length = last - first
    if length >= 2:
        parent = (length - 2) // 2
        while True:
            _adjust_heap(seq, first, parent, length, seq[first + parent],
                         less)
            if parent == 0:
                break
            parent -= 1
    while last - first > 1:
        last -= 1
        value = seq[last]
        seq[last] = seq[first]
        _adjust_heap(seq, first, 0, last - first, value, less)


def _penalty(value, mass):
    if value <= 1:
        return math.inf
    return mass * (math.log2(value) - math.log2(value - 1))


def _gain(value, mass):
    if value < 1:
        return -math.inf
    return mass * (math.log2(value + 1) - math.log2(value))


def quantize_pmf(pmf, precision):
    """TFC's PmfToQuantizedCdf: each mass rounded to the nearest count
    (at least 1), then the sum repaired to 2**precision one count at a
    time, always on the symbol whose change costs the least entropy (or
    gains the most), which then moves behind every key it no longer
    strictly beats.  Returns the CDF (len(pmf) + 1 ints)."""
    pmf = np.asarray(pmf, np.float32)
    normalizer = 1 << precision
    value = [max(int(np.rint(p * np.float32(normalizer))), 1) for p in pmf]
    mass = [float(p) for p in pmf]
    total = sum(value)
    if total != normalizer:
        steal = total > normalizer
        fn = _penalty if steal else _gain
        key = np.array([fn(v, m) for v, m in zip(value, mass)])
        order = list(range(len(value)))
        if steal:
            std_sort(order, lambda a, b: key[a] < key[b])
        else:
            std_sort(order, lambda a, b: key[a] > key[b])
        order = np.asarray(order)
        for _ in range(abs(total - normalizer)):
            head = int(order[0])
            if steal and value[head] <= 1:
                raise ValueError("cannot steal below a count of 1")
            value[head] += -1 if steal else 1
            key[head] = fn(value[head], mass[head])
            rest = key[order[1:]]
            beaten = (key[head] < rest) if steal else (key[head] > rest)
            stop = 1 + (int(np.argmax(beaten)) if beaten.any()
                        else len(rest))
            order[: stop - 1] = order[1: stop]
            order[stop - 1] = head
    return np.concatenate([[0], np.cumsum(value)]).astype(np.int64)


class Table:
    """CDF rows (lists of ints), each row's offset (the value of symbol 0)
    and precision; every row codes overflow (escape, then Elias gamma)."""

    def __init__(self, rows, offsets, precision):
        self.rows = [list(map(int, r)) for r in rows]
        self.offsets = [int(o) for o in offsets]
        self.precision = int(precision)


def _quantized_rows(prob_fn, lower, upper, offset, precision):
    minima = torch.floor(lower - offset).to(torch.int32)
    maxima = torch.ceil(upper - offset).to(torch.int32)
    pmf_start = minima.to(torch.float32) + offset
    pmf_length = maxima - minima + 1
    max_length = int(pmf_length.max())
    samples = torch.arange(max_length, dtype=torch.float32).reshape(-1, 1)
    with torch.no_grad():
        pmf = prob_fn(samples + pmf_start)
    num = int(pmf_length.numel())
    pmf = np.asarray(pmf.reshape(max_length, num).T.numpy(), np.float64)
    lengths = pmf_length.numpy().reshape(num)
    rows = []
    for i in range(num):
        p = pmf[i, : lengths[i]].astype(np.float32)
        overflow = max(1.0 - p.sum(), 0.0)
        p = np.concatenate([p, [np.float32(overflow)]])
        rows.append(quantize_pmf(p, precision))
    return Table(rows, minima.numpy().reshape(num), precision)


def scale_table(scale_min, scale_max, num_scales, precision):
    """The y model's table: one row per scale index, a zero-mean
    NoisyNormal of that scale; support from the normal's quantiles."""
    index = torch.arange(num_scales, dtype=torch.int32).to(torch.float32)
    scale = distributions.scale_table(scale_min, scale_max, num_scales,
                                      index)
    lower = distributions.normal_quantile(scale, TAIL_MASS / 2)
    upper = distributions.normal_quantile(scale, 1 - TAIL_MASS / 2)
    return _quantized_rows(
        lambda y: distributions.noisy_normal_prob(y, scale), lower, upper,
        torch.zeros((), dtype=torch.float32), precision)


def hyperprior_table(params, precision):
    """(table, quantization offset [C] float32) of the z model: one row
    per channel of the NoisyDeepFactorized prior, sampled at integers
    shifted by the median's offset."""
    prior = distributions.DeepFactorized(
        {k: [t.detach().float().cpu() for t in v] for k, v in params.items()})
    offset = prior.quantization_offset()
    lower, upper = prior.tails(TAIL_MASS)
    table = _quantized_rows(prior.noisy_prob, lower, upper, offset,
                            precision)
    return table, offset
