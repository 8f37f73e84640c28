"""Milliseconds per decompress request of the program's `container.*` spans,
less their `wait` children: building or parsing the container on the host
(program spans, host clock, in the traced window)."""

from portbench.metrics import _spans


def read(observed):
    return _spans.container_ms(observed, "decompress")
