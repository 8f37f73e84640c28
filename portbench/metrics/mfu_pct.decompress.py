"""The decompress requests' share of the card's float32 peak (host
clock): the published flop of the hyper synthesis and synthesis (``counts``,
at the cell's image size) of every decompress of the untraced window, over
their summed time times 67 Tflop/s, in %."""

from portbench import counts


def read(observed):
    f = observed["flops"]
    flop = f["hyper_synthesis"] + f["synthesis"]
    seconds = sum(observed["decompress_ms"]) / 1e3
    n = len(observed["decompress_ms"])
    if not n:
        return None
    return 100.0 * flop * n / (seconds * counts.PEAK_FP32_FLOP_PER_S)
