"""The compress requests' share of the card's float32 peak (host clock):
the published flop of the analysis, hyper analysis and hyper synthesis
(``counts``, at the cell's image size) of every compress of the untraced
window, over their summed time times 67 Tflop/s, in %."""

from portbench import counts


def read(observed):
    f = observed["flops"]
    flop = f["analysis"] + f["hyper_analysis"] + f["hyper_synthesis"]
    seconds = sum(observed["compress_ms"]) / 1e3
    n = len(observed["compress_ms"])
    if not n:
        return None
    return 100.0 * flop * n / (seconds * counts.PEAK_FP32_FLOP_PER_S)
