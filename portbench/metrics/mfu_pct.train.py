"""The training steps' share of the card's float32 peak (host clock):
three times the forward's published flop (``counts``, at the batch and
crop of the cell) for every step of the untraced window, over the window
times 67 Tflop/s, in %."""

from portbench import counts


def read(observed):
    return 100.0 * observed["step_flops"] * observed["steps"] / (
        observed["window_s"] * counts.PEAK_FP32_FLOP_PER_S)
