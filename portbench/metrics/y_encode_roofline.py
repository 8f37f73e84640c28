"""The share of its roofline of the kernel that encoded y in the compress
requests (device trace): K6' where y has escapes, K1 where it has none.
Each compress encodes z, then y; the least time of y's encode
(``counts.encode_cost`` of its stream, symbols, indexes and table) over
the device time of the second encode launch of each request, in %.  A
request whose encodes the trace did not record as two (the profiler can
drop records) is left out, and the metric is read only where most
requests remain."""

from portbench import counts
from portbench.metrics import _trace
from portbench.reference import container


def read(observed):
    summary = observed.get("trace")
    if not summary:
        return None
    launches = _trace.per_span(summary, "compress", _trace.ENCODE)
    pairs = _trace.whole(observed["traced_containers"], launches, 2)
    if not pairs:
        return None
    cy, _ = observed["latent_depths"]
    entries, _ = observed["tables"]["y"]
    least = busy = 0.0
    for blob, kernels in pairs:
        _, t = container.read(blob)
        if len(t) != 5:
            return None
        n = t[3][0] * t[3][1] * cy
        least += counts.least_seconds(*counts.encode_cost(
            sum(len(s) for s in t[0]), n, entries, True))
        s, e = kernels[1]
        busy += e - s
    return 100.0 * least / busy
