"""K3''s share of its chain floor over the decompress requests of a
classic container with one stream a slice (device trace), in %: the
floor (``counts.warp_floor_ms``) of z's stream and of each slice's, with
the symbols taken as the coded intervals (a lower bound: an escape codes
more than one) at CLOCK_MHZ, over the summed device time of the
container's K3' launches.  Each request launches K3' once for z and once
a slice; a request whose launches the trace did not record as that many
(the profiler can drop records) is left out, and the metric is read only
where most requests remain."""

from portbench import counts
from portbench.metrics import _trace
from portbench.reference import container

# The H100 SXM's highest SM clock (MHz; nvidia-smi's clocks.max.sm), the
# clock at which ``counts``' chain floors are stated.
CLOCK_MHZ = 1980.0


def read(observed):
    summary = observed.get("trace")
    blobs = observed.get("traced_containers")
    if not summary or not blobs:
        return None
    num_tensors = len(container.read(blobs[0])[1])
    streams = num_tensors - 3
    if streams < 2:
        return None
    launches = _trace.per_span(summary, "decompress", _trace.K3)
    pairs = _trace.whole(blobs, launches, streams)
    if not pairs:
        return None
    cy, cz = observed["latent_depths"]
    depth = cy // (streams - 1)
    (_, z_len), (_, y_len) = observed["tables"]["z"], observed["tables"]["y"]
    floor_ms = busy_ms = 0.0
    for blob, kernels in pairs:
        _, t = container.read(blob)
        if len(t) != num_tensors:
            return None
        (hy, wy), (hz, wz) = t[1], t[2]
        floor_ms += counts.warp_floor_ms(hz * wz * cz, z_len, CLOCK_MHZ)
        floor_ms += (streams - 1) * counts.warp_floor_ms(
            hy * wy * depth, y_len, CLOCK_MHZ)
        busy_ms += sum(e - s for s, e in kernels) * 1e3
    return 100.0 * floor_ms / busy_ms
