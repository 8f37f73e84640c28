"""Multi-process support over ``torch.distributed`` (PyTorch counterpart of
compression_tpu/parallel/multihost.py).

JAX is single-controller: one process drives every device it sees, and
``jax.distributed`` stretches that across hosts.  torch is
multi-controller: one process a card, joined in a process group (NCCL
between cards, gloo between CPU processes).  ``initialize`` makes that
group; ``build_tables_replicated`` builds the range-coding tables on rank 0
only and broadcasts them, so that float nondeterminism between processes
can never make two ranks disagree on a table; ``gather_bytes`` gathers
per-stream byte buffers in rank order, which is stream order when streams
are split rank-major.

Start a multi-card run with ``torchrun --nproc_per_node=N script.py`` and
call ``initialize(coordinator, N, rank)`` (or
``torch.distributed.init_process_group`` directly) before
``sharding.make_mesh``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from compression_tpu_torch.util.device import resolve_device

__all__ = ["initialize", "build_tables_replicated", "gather_bytes"]


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, device="cuda",
               timeout=None):
    """Joins the process group (a no-op for one process or fewer).

    Args:
      coordinator_address: "host:port" of rank 0's rendezvous.
      num_processes: the world size.
      process_id: this process's rank.
      device: "cuda" (NCCL, after ``torch.cuda.set_device`` to card
        ``process_id % torch.cuda.device_count()``) or "cpu" (gloo).
      timeout: ``datetime.timedelta`` for the rendezvous and every
        collective (torch's default when None).
    """
    if num_processes is None or num_processes <= 1:
        return
    device = resolve_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(int(process_id) % torch.cuda.device_count())
        backend = "nccl"
    else:
        backend = "gloo"
    kwargs = {} if timeout is None else {"timeout": timeout}
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes), rank=int(process_id), **kwargs)


def comm_device() -> torch.device:
    """Where a collective's tensors must lie: this rank's card under NCCL,
    the CPU under gloo (whose CUDA support covers only broadcast and
    all-reduce)."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def build_tables_replicated(build_fn):
    """Builds range-coding tables on rank 0 and broadcasts them.

    Args:
      build_fn: () -> (cdf ragged int32, cdf_offset int32); called on rank
        0 only.

    Returns:
      (cdf, cdf_offset) as numpy int32, identical on every rank.  Without
      a process group, ``build_fn()``'s result.
    """
    if not dist.is_initialized():
        cdf, cdf_offset = build_fn()
        return np.asarray(cdf, np.int32), np.asarray(cdf_offset, np.int32)
    device = comm_device()
    if dist.get_rank() == 0:
        arrays = [np.asarray(a, np.int32).reshape(-1) for a in build_fn()]
        shapes = torch.tensor([a.size for a in arrays], dtype=torch.int64,
                              device=device)
    else:
        shapes = torch.zeros(2, dtype=torch.int64, device=device)
    dist.broadcast(shapes, src=0)
    out = []
    for i, size in enumerate(shapes.tolist()):
        t = torch.as_tensor(arrays[i], device=device) if dist.get_rank() == 0 \
            else torch.zeros(size, dtype=torch.int32, device=device)
        dist.broadcast(t, src=0)
        out.append(t.cpu().numpy())
    return out[0], out[1]


def _to_numpy(x, dtype):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype)


def gather_bytes(buf_local, lengths_local):
    """Gathers per-stream byte buffers from all ranks in rank order.

    Streams split rank-major come back in global stream order, so the
    container bytes equal one process's.  The ranks may hold different
    stream counts and widths (the reference-format encode sizes its buffer
    from the data): the counts and widths are gathered first, each buffer
    is padded with zeros to the widest and the largest count, and the
    padding is cut off again.  Bytes past a stream's length read as zero,
    so the padded width is safe.

    Takes numpy arrays or tensors; returns numpy (buf uint8 [S, L],
    lengths int32 [S]).  Without a process group, the local arrays.
    """
    buf = _to_numpy(buf_local, np.uint8)
    lengths = _to_numpy(lengths_local, np.int32).reshape(-1)
    if not dist.is_initialized():
        return buf, lengths
    device = comm_device()
    size = dist.get_world_size()
    meta = torch.tensor(buf.shape, dtype=torch.int64, device=device)
    metas = [torch.empty_like(meta) for _ in range(size)]
    dist.all_gather(metas, meta)
    shapes = [tuple(m.tolist()) for m in metas]
    rows = max(s[0] for s in shapes)
    padded = np.zeros((rows, max(s[1] for s in shapes)), np.uint8)
    padded[: buf.shape[0], : buf.shape[1]] = buf
    padded_lens = np.zeros(rows, np.int32)
    padded_lens[: lengths.shape[0]] = lengths
    out = []
    for local in (padded, padded_lens):
        t = torch.as_tensor(local, device=device)
        gathered = [torch.empty_like(t) for _ in range(size)]
        dist.all_gather(gathered, t)
        out.append(np.concatenate([g.cpu().numpy()[: s[0]]
                                   for g, s in zip(gathered, shapes)]))
    return out[0], out[1]
