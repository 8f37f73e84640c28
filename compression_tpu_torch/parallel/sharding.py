"""Multi-device parallelism for training and coding (PyTorch counterpart of
compression_tpu/parallel/sharding.py).

JAX shards one program over a (data, model) device mesh from one process.
torch runs one process a card, so the port has two kinds of mesh, both with
JAX's axis names and factorization (``make_mesh``):

* a **process mesh**, made under an initialized ``torch.distributed``
  process group: rank r sits at ``[r // model, r % model]`` on its own
  device, with sub-groups along the data and the model axis.  The train
  steps run on it: ``data_parallel_train_step`` averages the gradients
  over the data group before the optimizer steps; ``dp_tp_train_step``
  also keeps JAX's tensor-parallel leaves (``tp_shardings_like``) and
  their optimizer state as slices along the model axis.
* an **in-process mesh**, made without a process group: local devices
  (``cuda:0 ... cuda:n-1``, or n CPU entries for the tests).  Coding runs
  on it: ``sharded_encode`` and the codecs of ``parallel.pipeline`` code
  each data shard of the streams on its device (kernel launches are
  asynchronous, so the cards overlap) and gather the shards back in
  stream order.  Streams are independent, so the bytes equal one
  device's for any device count.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from compression_tpu_torch.models import bls2017
from compression_tpu_torch.ops import math_ops
from compression_tpu_torch.parallel import multihost
from compression_tpu_torch.util.device import resolve_device

__all__ = [
    "Mesh",
    "make_mesh",
    "shard_batch",
    "replicate",
    "data_parallel_train_step",
    "tp_shardings_like",
    "dp_tp_train_step",
    "sharded_encode",
]


class Mesh:
    """A grid of devices with named axes (JAX's ``Mesh``, as ``make_mesh``
    builds it).

    Attributes:
      devices: object array of ``torch.device``, one entry a mesh position.
      axis_names: ("data", "model") from ``make_mesh``.
      shape: {axis name: size}, as ``mesh.shape`` is in JAX.
      ranks: int array of the ranks at each position (process meshes), or
        None (in-process meshes).
      group: the world group of a process mesh, else None.
      data_group, model_group: this rank's sub-groups along each axis
        (process meshes), else None.
    """

    def __init__(self, devices, axis_names=("data", "model"), ranks=None,
                 data_group=None, model_group=None):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.ranks = ranks
        self.data_group = data_group
        self.model_group = model_group

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def distributed(self) -> bool:
        return self.ranks is not None

    @property
    def group(self):
        return dist.group.WORLD if self.distributed else None

    @property
    def coords(self) -> tuple:
        """This rank's (data, model) position on a process mesh."""
        rank = dist.get_rank()
        return rank // self.shape["model"], rank % self.shape["model"]

    @property
    def local_device(self) -> torch.device:
        """This rank's device on a process mesh."""
        return self.devices[self.coords]

    def __repr__(self):
        kind = "process" if self.distributed else "in-process"
        return f"Mesh({kind}, {self.shape})"


def _factor(n: int, data_axis: Optional[int]):
    if data_axis is None:
        model = 2 if n % 2 == 0 and n >= 4 else 1
        data_axis = n // model
    model = n // data_axis
    if data_axis * model != n:
        raise ValueError(f"Cannot factor {n} devices into mesh.")
    return data_axis, model


def make_mesh(n_devices: Optional[int] = None,
              data_axis: Optional[int] = None, device="cuda") -> Mesh:
    """Creates a (data, model) mesh.

    The model axis is 2 when the device count n is even and at least 4,
    else 1, unless ``data_axis`` fixes the data axis (which must divide n).

    Under an initialized process group the mesh spans the world (n is the
    world size; ``n_devices`` may only repeat it): rank r at
    ``[r // model, r % model]``, on card ``r % torch.cuda.device_count()``
    with ``device="cuda"``, else on the CPU, and every rank makes the data
    and model sub-groups.  Without one, n local entries: ``cuda:0`` to
    ``cuda:n-1`` (n defaults to every card), or n CPU entries with
    ``device="cpu"`` (n defaults to 1).
    """
    device = resolve_device(device)
    if dist.is_initialized():
        n = dist.get_world_size()
        if n_devices not in (None, n):
            raise ValueError(
                f"a process mesh spans the world of {n} ranks, not "
                f"{n_devices}")
    elif n_devices is not None:
        n = int(n_devices)
    else:
        n = torch.cuda.device_count() if device.type == "cuda" else 1
    if device.type == "cuda" and not dist.is_initialized() \
            and n > torch.cuda.device_count():
        raise ValueError(f"{n} devices asked for, "
                         f"{torch.cuda.device_count()} cards present")
    data, model = _factor(n, data_axis)

    def entry(i):
        if device.type == "cuda":
            count = torch.cuda.device_count()
            return torch.device("cuda", i % count if dist.is_initialized()
                                else i)
        return torch.device("cpu")

    devices = np.empty((data, model), dtype=object)
    for i in range(n):
        devices[i // model, i % model] = entry(i)
    if not dist.is_initialized():
        return Mesh(devices)
    ranks = np.arange(n).reshape(data, model)
    rank = dist.get_rank()
    groups = {}
    # Every rank creates every group, in the same order.
    for axis, lines in (("data", ranks.T), ("model", ranks)):
        for line in lines:
            group = dist.new_group([int(r) for r in line])
            if rank in line:
                groups[axis] = group
    return Mesh(devices, ranks=ranks, data_group=groups["data"],
                model_group=groups["model"])


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _data_chunk(mesh: Mesh, x) -> int:
    size = mesh.shape["data"]
    if x.shape[0] % size:
        raise ValueError(
            f"leading axis of {x.shape[0]} does not divide over the data "
            f"axis of {size}")
    return x.shape[0] // size


def shard_batch(mesh: Mesh, batch):
    """Splits the leading axis of every leaf (tensor or numpy array) over
    the data axis, which must divide it.

    In-process mesh: each leaf becomes a list of its chunks, chunk i on
    data device i.  Process mesh: each leaf becomes this rank's chunk, on
    this rank's device.
    """
    def split(x):
        x = torch.as_tensor(x)
        chunk = _data_chunk(mesh, x)
        if mesh.distributed:
            i = mesh.coords[0]
            return x[i * chunk:(i + 1) * chunk].to(mesh.local_device)
        return [x[i * chunk:(i + 1) * chunk].to(mesh.devices[i, 0])
                for i in range(mesh.shape["data"])]

    return _tree_map(split, batch)


def replicate(mesh: Mesh, tree):
    """Replicates every leaf (tensor or numpy array) over the mesh.

    In-process mesh: each leaf becomes a list of copies, one a mesh
    position in row-major order.  Process mesh: rank 0's value is
    broadcast to every rank (all ranks pass leaves of the same shapes and
    dtypes) and lands on this rank's device.
    """
    def copy(x):
        x = torch.as_tensor(x)
        if not mesh.distributed:
            return [x.to(d) for d in mesh.devices.flat]
        t = x.to(multihost.comm_device(), copy=True).contiguous()
        dist.broadcast(t, src=0)
        return t.to(mesh.local_device)

    return _tree_map(copy, tree)


def check_in_process(mesh: Mesh, what: str):
    if mesh.distributed:
        raise ValueError(
            f"{what} shards streams over an in-process mesh; across "
            "processes, code each rank's streams and gather them with "
            "multihost.gather_bytes")


def _processes_only(mesh: Mesh, what: str):
    if not mesh.distributed and mesh.devices.size > 1:
        raise ValueError(
            f"{what} needs a process mesh: torch's data and tensor "
            "parallelism run one process a card (torchrun, then "
            "multihost.initialize and make_mesh)")


def gather_shards(outputs):
    """Concatenates per-shard (bytes [s, L_i], lengths [s]) in shard order
    into numpy (bytes [S, max L_i] zero-padded, lengths [S]); one shard's
    arrays are returned as they come."""
    bufs = [b.cpu().numpy() for b, _ in outputs]
    lengths = concat([n.cpu().numpy().reshape(-1) for _, n in outputs])
    width = max(b.shape[1] for b in bufs)
    if all(b.shape[1] == width for b in bufs):
        return concat(bufs), lengths.astype(np.int32, copy=False)
    buf = np.zeros((sum(b.shape[0] for b in bufs), width), np.uint8)
    row = 0
    for b in bufs:
        buf[row:row + b.shape[0], : b.shape[1]] = b
        row += b.shape[0]
    return buf, lengths.astype(np.int32, copy=False)


def concat(parts):
    """np.concatenate, without the copy for a single part."""
    return parts[0] if len(parts) == 1 else np.concatenate(parts)


def sharded_encode(mesh: Mesh, encode_fn, symbols, indexes):
    """Runs an encode over streams sharded across the data axis.

    Args:
      mesh: in-process device mesh.
      encode_fn: (symbols [s, N], indexes [s, N]) -> (bytes [s, L],
        lengths [s]), called once a data shard with that shard's tensors
        on its device (e.g. a closure over micro_ops_from_symbols +
        encode_core, or over encode_streams; a table it closes over must
        lie on that device).
      symbols, indexes: int32 [S, N]; S must divide by the data axis size.

    Returns:
      numpy (byte buffer [S, L] uint8, lengths [S] int32) in stream order,
      the shards' buffers zero-padded to the widest.
    """
    check_in_process(mesh, "sharded_encode")
    sym = shard_batch(mesh, symbols)
    idx = shard_batch(mesh, indexes)
    return gather_shards([encode_fn(s, i) for s, i in zip(sym, idx)])


def _average(tensors, group, size):
    """Averages ``tensors`` in place over ``group`` with one all-reduce."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    flat /= size
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()


def _global_backward(mesh: Mesh, model: nn.Module, batch, generator, u):
    """``bls2017.rd_backward`` on this rank's shard, then the gradients and
    the metrics averaged over the data group: the global batch's.  The
    gradient a parameter's bound gate receives is averaged before the gate
    (``math_ops.parameter_gradient_reduction``), as the gate of one
    process's step sees the global batch's gradient."""
    if not mesh.distributed:
        return bls2017.rd_backward(model, batch, generator=generator, u=u)
    group, size = mesh.data_group, mesh.shape["data"]

    def mean(grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=group)
        return grad / size

    with math_ops.parameter_gradient_reduction(mean):
        metrics = bls2017.rd_backward(model, batch, generator=generator, u=u)
    grads = []
    for p in model.parameters():
        if p.requires_grad:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            grads.append(p.grad)
    names = ("loss", "bpp", "mse")
    stacked = torch.stack([metrics[k] for k in names])
    _average(grads + [stacked], group, size)
    return dict(zip(names, stacked))


def data_parallel_train_step(mesh: Mesh, model: nn.Module,
                             optimizer: torch.optim.Optimizer):
    """Data-parallel rate-distortion step over a process mesh.

    Returns ``step(batch, generator=None, u=None)`` with
    ``bls2017.make_train_step``'s contract (BLS2017Model, BMSHJ2018Model,
    MS2020Model): each rank passes its own shard of the global batch
    (``shard_batch``); the gradients are averaged over the data group
    before ``optimizer.step()``, so the replicas stay equal; the metrics
    returned are the global batch's (the ranks' average).  Ranks must start
    from the same parameters (the same seed, or ``replicate``).

    Noise: with ``u`` given as this rank's slice of the global batch's
    noise, the step equals one process's step on the global batch with
    the global ``u``.  With a ``generator`` each rank draws its own noise,
    which cannot equal one process's draw for the global batch.

    An in-process mesh of more than one device raises: torch's data
    parallelism runs one process a card.
    """
    _processes_only(mesh, "data_parallel_train_step")

    def step(batch, generator=None, u=None):
        optimizer.zero_grad(set_to_none=True)
        metrics = _global_backward(mesh, model, batch, generator, u)
        optimizer.step()
        return metrics

    return step


def tp_shardings_like(mesh, named_params) -> dict:
    """Tensor-parallel layout of each parameter, JAX's rule on the port's
    parameters (which keep JAX's HWIO ``kernel`` and rank-5 ``kernel_rdft``
    layouts, so the same leaves qualify).

    A rank-4 tensor whose last dim divides by the model axis size (and is
    at least that size) is sharded along its last dim; every other tensor
    replicates, and so does everything on a mesh without a "model" axis or
    with a model axis of 1.

    Args:
      mesh: anything with a ``shape`` dict of axis sizes.
      named_params: (name, tensor) pairs or a {name: tensor} dict, e.g.
        ``model.named_parameters()``.

    Returns:
      {name: spec}: ``(None, None, None, "model")`` for a sharded tensor,
      ``()`` for a replicated one (``tuple(PartitionSpec)`` in JAX).
    """
    model = int(dict(mesh.shape).get("model", 1))

    def spec(x):
        shape = tuple(x.shape)
        if (model > 1 and len(shape) == 4
                and shape[-1] % model == 0 and shape[-1] >= model):
            return (None, None, None, "model")
        return ()

    return {name: spec(x) for name, x in dict(named_params).items()}


def dp_tp_train_step(mesh: Mesh, model: nn.Module,
                     optimizer: torch.optim.Optimizer):
    """Data parallelism over the batch axis plus tensor parallelism over
    the conv output channels, on a process mesh.

    The parameters ``tp_shardings_like`` shards, and their optimizer state
    (Adam's ``exp_avg`` / ``exp_avg_sq``), are kept as this rank's slices
    along the last dim across steps; every other parameter replicates.  A
    step gathers nothing for the forward (the model holds the full
    tensors, gathered after each step), averages the full gradients over
    the data group, keeps this rank's slice of each sharded gradient,
    steps the optimizer on the slices and all-gathers them over the model
    group into the model.  So the sharded parameters' optimizer state is
    split over the model axis, while the weights themselves stay whole on
    each rank for the forward.

    Ranks must start from the same parameters.  ``step(batch,
    generator=None, u=None)`` is ``data_parallel_train_step``'s (the same
    noise rules; ranks of one data row pass the same shard).

    Returns:
      (step, model, optimizer): the optimizer, which must not have stepped
      yet, is replaced by a new one of the same class and options over the
      replicated parameters and the slices.  ``step.shards`` maps the
      sharded parameters' names to their slices.
    """
    _processes_only(mesh, "dp_tp_train_step")
    if optimizer.state:
        raise ValueError("dp_tp_train_step takes an optimizer that has not "
                         "stepped yet: its state is made sharded")
    specs = tp_shardings_like(mesh, model.named_parameters())
    size = int(mesh.shape.get("model", 1))
    j = mesh.coords[1] if mesh.distributed else 0
    shards, slice_of = {}, {}
    for name, p in model.named_parameters():
        if specs[name]:
            k = p.shape[-1] // size
            shards[name] = nn.Parameter(
                p.detach()[..., j * k:(j + 1) * k].clone())
            slice_of[id(p)] = shards[name]
    groups = [{**group, "params": [slice_of.get(id(p), p)
                                   for p in group["params"]]}
              for group in optimizer.param_groups]
    sharded_opt = type(optimizer)(groups, **optimizer.defaults)
    full = dict(model.named_parameters())

    def gather():
        for name, s in shards.items():
            parts = [torch.empty_like(s) for _ in range(size)]
            dist.all_gather(parts, s.detach(), group=mesh.model_group)
            with torch.no_grad():
                full[name].copy_(torch.cat(parts, dim=-1))

    def step(batch, generator=None, u=None):
        sharded_opt.zero_grad(set_to_none=True)
        metrics = _global_backward(mesh, model, batch, generator, u)
        for name, s in shards.items():
            k = s.shape[-1]
            s.grad = full[name].grad[..., j * k:(j + 1) * k].contiguous()
        sharded_opt.step()
        gather()
        return metrics

    step.shards = shards
    return step, model, sharded_opt
