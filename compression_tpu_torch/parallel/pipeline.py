"""Batch compression sharded over the devices of a mesh (PyTorch
counterpart of compression_tpu/parallel/pipeline.py).

The streams are split over the data axis of an in-process mesh
(``sharding.make_mesh`` without a process group): shard i holds streams
``[i c, (i + 1) c)`` with ``c = ceil(S / data)``, and the last shards may
be shorter or empty.  Each shard is coded on its device by the port's own
front end, with the table replicated there once; launches on different
cards overlap, as kernel launches are asynchronous.  The per-stream
buffers gather back in stream order, so the bytes equal an unsharded
call's for any device count.  Across processes, code each rank's streams
and gather them with ``multihost.gather_bytes``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from compression_tpu_torch.codec import torch_coder
from compression_tpu_torch.parallel import sharding
from compression_tpu_torch.util import profiling

__all__ = ["BatchCodec", "SidecarBatchCodec"]


def _default_mesh(device) -> sharding.Mesh:
    """Every local device of ``device``'s kind along the data axis."""
    device = torch.device(device)
    n = torch.cuda.device_count() if device.type == "cuda" else 1
    return sharding.make_mesh(n, data_axis=n, device=device)


def _spans(num_streams: int, mesh: sharding.Mesh):
    """(device, start, stop) of each non-empty data shard."""
    n_data = mesh.shape["data"]
    chunk = -(-num_streams // n_data)
    return [(mesh.devices[i, 0], i * chunk, min((i + 1) * chunk,
                                                num_streams))
            for i in range(n_data) if i * chunk < num_streams]


def _numpy(x, dtype=None):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype)


class BatchCodec:
    """Sharded reference-format encode / decode over a device mesh.

    Each data shard runs ``torch_coder.encode_streams`` /
    ``decode_streams`` on its device, so escapes on overflow rows are
    coded in the stream (Elias gamma) as an unsharded call codes them.
    This differs from the JAX package's BatchCodec, which takes every
    batch as escape-free (one micro-op slot a symbol) and so writes wrong
    streams for a batch with escapes.  JAX's ``max_symbols_per_stream``
    argument, which it never reads, is not taken.
    """

    def __init__(self, table, mesh: Optional[sharding.Mesh] = None):
        """``table``: a ``tables.CdfTable`` or a ``DeviceCdfTable``;
        ``mesh``: an in-process mesh (every card on the data axis when
        None, or the CPU for a table that lies there)."""
        if isinstance(table, torch_coder.DeviceCdfTable):
            self._tables = {table.device: table}
            self.host = table.host
            default = table.device
        else:
            self._tables = {}
            self.host = table
            default = "cuda"
        self.mesh = mesh if mesh is not None else _default_mesh(default)
        sharding.check_in_process(self.mesh, "BatchCodec")
        self.timer = profiling.PhaseTimer()

    def table(self, device) -> torch_coder.DeviceCdfTable:
        """The table replicated on ``device`` (made once, kept)."""
        if device not in self._tables:
            self._tables[device] = torch_coder.DeviceCdfTable(self.host,
                                                              device)
        return self._tables[device]

    def encode(self, symbols, indexes=None):
        """Encodes int32 [S, N] symbols sharded across the mesh.

        ``indexes``: int32 [S, N] CDF rows, or None for channel mode
        (element j on row ``j % num_rows``; a one-row table then takes the
        single-row kernel).  Returns numpy (bytes [S, L] uint8, lengths [S]
        int32) in stream order: the arrays an unsharded
        ``torch_coder.encode_streams`` gives.
        """
        symbols = _numpy(symbols, np.int32)
        indexes = None if indexes is None else _numpy(indexes, np.int32)
        spans = _spans(symbols.shape[0], self.mesh)
        with self.timer("encode"):
            with self.timer("encode_put"):
                args = [(torch.as_tensor(symbols[a:b], device=d),
                         None if indexes is None else
                         torch.as_tensor(indexes[a:b], device=d),
                         self.table(d)) for d, a, b in spans]
                profiling.block_until_ready([a[:2] for a in args])
            with self.timer("encode_compute"):
                outs = [torch_coder.encode_streams(s, t, indexes=i)
                        for s, i, t in args]
                profiling.block_until_ready(outs)
            with self.timer("encode_gather"):
                buf, lengths = sharding.gather_shards(outs)
        return buf, lengths

    def decode(self, buf, lengths, num_elements, indexes=None):
        """Decodes stream buffers [S, L] uint8 (zero past each length)
        sharded across the mesh.  Returns numpy (symbols int32 [S,
        num_elements], sanity bool [S])."""
        buf = _numpy(buf, np.uint8)
        lengths = _numpy(lengths, np.int32)
        indexes = None if indexes is None else _numpy(indexes, np.int32)
        spans = _spans(buf.shape[0], self.mesh)
        with self.timer("decode"):
            with self.timer("decode_put"):
                args = [(torch.as_tensor(buf[a:b], device=d),
                         torch.as_tensor(lengths[a:b], device=d),
                         None if indexes is None else
                         torch.as_tensor(indexes[a:b], device=d),
                         self.table(d)) for d, a, b in spans]
                profiling.block_until_ready([a[:3] for a in args])
            with self.timer("decode_compute"):
                outs = [torch_coder.decode_streams(
                    b, n, int(num_elements), t, indexes=i)
                    for b, n, i, t in args]
                profiling.block_until_ready(outs)
            with self.timer("decode_gather"):
                symbols = sharding.concat([o[0].cpu().numpy() for o in outs])
                sanity = sharding.concat([o[1].cpu().numpy() for o in outs])
        return symbols, sanity


class SidecarBatchCodec:
    """The native containers' sidecar coder sharded over a device mesh.

    Each data shard runs the entropy model's own
    ``compress_sidecar_device`` / ``decompress_sidecar_device`` on its
    device (a copy of the model there, ``em.to``), with no collective; the
    host merges each shard's escape positions into global flat positions
    (the shard's first stream times the symbols a stream, plus the local
    position).  Streams are independent, so the bytes and the sidecar
    equal an unsharded call's for any device count.

    The sidecar is the port's own shape: the exact escape count, ascending
    int64 positions, no budget.  The JAX package pads it to a multiple of
    ``ESC_BUCKET`` and returns a count and an ``ok`` flag because its
    sidecar has a static size; none of the three is taken here, and
    neither is ``encode``'s ``escape_budget``.
    """

    def __init__(self, em, mesh: Optional[sharding.Mesh] = None):
        """``em``: a ContinuousBatchedEntropyModel with compression on;
        ``mesh``: an in-process mesh (every card of the model's kind on
        the data axis when None)."""
        self.em = em
        self.mesh = mesh if mesh is not None else _default_mesh(em.device)
        sharding.check_in_process(self.mesh, "SidecarBatchCodec")
        self.timer = profiling.PhaseTimer()
        self._ems = {}

    def _em(self, device):
        if device not in self._ems:
            self._ems[device] = self.em.to(device)
        return self._ems[device]

    def encode(self, rows):
        """Encodes bottleneck rows [S, *broadcast, *prior] sharded over the
        mesh.

        Returns numpy (bytes [S, L] uint8, lengths [S] int32, esc_idx int64
        [K] ascending flat positions over [S, N], esc_val int32 [K]), as
        ``compress_sidecar_device`` of the whole batch gives them.
        """
        rows = _numpy(rows, np.float32)
        n = int(np.prod(rows.shape[1:]))
        spans = _spans(rows.shape[0], self.mesh)
        with self.timer("encode"):
            with self.timer("encode_put"):
                parts = [torch.as_tensor(rows[a:b], device=d)
                         for d, a, b in spans]
                profiling.block_until_ready(parts)
            with self.timer("encode_compute"):
                outs = [self._em(d).compress_sidecar_device(x)
                        for (d, _, _), x in zip(spans, parts)]
                profiling.block_until_ready(outs)
            with self.timer("encode_gather"):
                buf, lengths = sharding.gather_shards(
                    [(o[0].reshape(o[0].shape[0], -1), o[1]) for o in outs])
                esc_idx = sharding.concat(
                    [o[2].cpu().numpy() + a * n
                     for (_, a, _), o in zip(spans, outs)])
                esc_val = sharding.concat([o[3].cpu().numpy() for o in outs])
        return buf, lengths, esc_idx, esc_val

    def decode(self, buf, lengths, broadcast_shape, esc_idx, esc_val):
        """Decodes stream buffers sharded over the mesh.

        ``esc_idx`` / ``esc_val`` are ``encode``'s global flat positions
        and values (a position outside the streams raises ValueError); the
        host splits them per shard, so that each device applies only its
        own.  Returns numpy (rows float32 [S, *broadcast,
        *prior], sanity bool [S]).
        """
        buf = _numpy(buf, np.uint8)
        lengths = _numpy(lengths, np.int32)
        esc_idx = _numpy(esc_idx, np.int64).reshape(-1)
        esc_val = _numpy(esc_val, np.int32).reshape(-1)
        broadcast_shape = tuple(int(s) for s in broadcast_shape)
        n = int(np.prod(broadcast_shape)) * int(np.prod(self.em.prior_shape))
        if esc_idx.size and (esc_idx.min() < 0
                             or esc_idx.max() >= buf.shape[0] * n):
            raise ValueError("escape position outside the stream grid")
        spans = _spans(buf.shape[0], self.mesh)
        with self.timer("decode"):
            with self.timer("decode_put"):
                args = []
                for d, a, b in spans:
                    mine = (esc_idx >= a * n) & (esc_idx < b * n)
                    args.append((
                        torch.as_tensor(buf[a:b], device=d),
                        torch.as_tensor(lengths[a:b], device=d),
                        torch.as_tensor(esc_idx[mine] - a * n, device=d),
                        torch.as_tensor(esc_val[mine], device=d)))
                profiling.block_until_ready(args)
            with self.timer("decode_compute"):
                outs = [self._em(d).decompress_sidecar_device(
                    b, ln, broadcast_shape, ei, ev)
                    for (d, _, _), (b, ln, ei, ev) in zip(spans, args)]
                profiling.block_until_ready(outs)
            with self.timer("decode_gather"):
                out = sharding.concat([o[0].cpu().numpy() for o in outs])
                sanity = sharding.concat([o[1].cpu().numpy() for o in outs])
        return out, sanity
