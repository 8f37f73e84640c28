"""The batch round trips' share of the card's float32 peak (host clock):
the published flop of every transform of a round trip (compress:
analysis, hyper analysis, hyper synthesis; decompress: hyper synthesis,
synthesis) for every image of the untraced window, over the window times
67 Tflop/s, in %."""

from portbench import counts


def read(observed):
    if not observed["images"]:
        return None
    f = observed["flops"]
    flop = (f["analysis"] + f["hyper_analysis"] + 2 * f["hyper_synthesis"]
            + f["synthesis"])
    return 100.0 * flop * observed["images"] / (
        observed["window_s"] * counts.PEAK_FP32_FLOP_PER_S)
