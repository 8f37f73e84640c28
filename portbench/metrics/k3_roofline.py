"""K3''s share of its roofline over the decompress requests (device
trace): the least time its work needs (``counts.decode_cost`` of the z and
y streams of each traced container, the tables read once) over the device
time of its launches, in %.  Each request launches K3' once for z and
once for y; a request whose launches the trace did not record as two
(the profiler can drop records) is left out, and the metric is read only
where most requests remain."""

from portbench import counts
from portbench.metrics import _trace
from portbench.reference import container


def read(observed):
    summary = observed.get("trace")
    if not summary:
        return None
    launches = _trace.per_span(summary, "decompress", _trace.K3)
    pairs = _trace.whole(observed["traced_containers"], launches, 2)
    if not pairs:
        return None
    cy, cz = observed["latent_depths"]
    tables = observed["tables"]
    least = busy = 0.0
    for blob, kernels in pairs:
        _, t = container.read(blob)
        if len(t) != 5:
            return None
        for stream, shape, depth, table in ((t[1], t[4], cz, "z"),
                                            (t[0], t[3], cy, "y")):
            n = shape[0] * shape[1] * depth
            entries, max_len = tables[table]
            least += counts.least_seconds(*counts.decode_cost(
                len(stream[0]), n, entries, max_len, True))
        busy += sum(e - s for s, e in kernels)
    return 100.0 * least / busy
