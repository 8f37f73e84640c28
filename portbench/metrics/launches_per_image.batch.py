"""Kernels the card ran per image in the traced window (device trace):
every kernel event the profiler saw, over the images whose round trip
ran in the window."""


def read(observed):
    summary = observed.get("trace")
    images = observed.get("traced_images")
    if not summary or not images:
        return None
    kernels = [n for n, _, _ in summary["kernels"]
               if not n.startswith("Memcpy") and not n.startswith("Memset")]
    return len(kernels) / images
