"""One rank of a multi-process run of the port's parallel modules, and the
launcher that runs a world of them (no JAX: the tests hold the results
against the JAX package in the parent process, and chip_smoke.py runs the
card scenarios).

Usage: torch_parallel_worker.py <scenario> <world> <rank> <port> <in.npz>
<out_dir>; each rank writes <out_dir>/rank<r>.npz (card scenarios:
rank<r>.json, and the .pt files named below).

Scenarios:
  coding  (gloo, CPU) tables built on rank 0 only and broadcast, the
          reference-format streams of each rank's shard gathered in rank
          order (equal shards, then unequal counts and widths), the
          sidecar coder of the native containers, bls2017 data-parallel
          steps with the noise given;
  dptp    (gloo, CPU) bmshj2018 data x tensor-parallel steps on a (2, 2)
          mesh, the noise given;
  card_nccl  (NCCL, world size 1, on the card) the table broadcast, the
          byte gather and the DP and DP x TP steps of bls2017 against
          make_train_step: the first step's gradients and metrics and the
          parameters after PARITY_STEPS compared for identity; writes
          start.pt and single.pt (make_train_step's);
  card_gloo  (gloo, two ranks sharing the card) the DP step on 4 + 4
          images; rank 0 writes gloo.pt.  Both time every step.
"""

import datetime
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
TIMEOUT = datetime.timedelta(seconds=60)

# The card scenarios: bls2017 at its published width, the train phase's
# batch of 8 patches of 256x256, Adam at 1e-3.
CARD_FILTERS = 128
CARD_BATCH = (8, 256, 256, 3)
PARITY_STEPS = 2
TIMED_STEPS = 10


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(scenario, world, in_path, out_dir, timeout):
    """Runs ``world`` ranks of ``scenario`` to their end or ``timeout``
    seconds, whichever is first; kills any rank still running then.
    Returns [(exit code or None if killed, output)] by rank."""
    port = free_port()
    env = dict(os.environ, PYTHONPATH=os.path.dirname(HERE))
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), scenario, str(world),
         str(rank), str(port), in_path or "", out_dir],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(world)]
    deadline = time.monotonic() + timeout
    results = []
    try:
        for p in procs:
            try:
                out, _ = p.communicate(
                    timeout=max(deadline - time.monotonic(), 0.1))
                results.append((p.returncode, out))
            except subprocess.TimeoutExpired:
                p.kill()
                out, _ = p.communicate()
                results.append((None, out))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return results


def _ragged(overflow):
    """The zipf-like one-row table of tests/multihost_worker.py."""
    from compression_tpu_torch.codec import tables
    pmf = 1.0 / (1 + np.arange(16)) ** 1.3
    pmf /= pmf.sum()
    cdf = tables.pmf_to_quantized_cdf(pmf, 10)
    return (tables.build_ragged_cdf([cdf], [10], [overflow]),
            np.zeros(1, np.int32))


def _boom():
    raise AssertionError("build_fn must only run on rank 0")


def _replicated(rank, build_fn):
    from compression_tpu_torch.parallel import multihost
    return multihost.build_tables_replicated(build_fn if rank == 0 else _boom)


def coding(world, rank, inputs):
    import torch
    import torch.distributed as dist

    from compression_tpu_torch.codec import tables, torch_coder
    from compression_tpu_torch.distributions import deep_factorized
    from compression_tpu_torch.entropy_models.continuous_batched import (
        ContinuousBatchedEntropyModel)
    from compression_tpu_torch.models import bls2017
    from compression_tpu_torch.parallel import multihost, sharding

    out = {}
    # Tables on rank 0 only; 8 x 32 streams split rank-major.
    ragged, _ = _replicated(rank, lambda: _ragged(False))
    table = torch_coder.DeviceCdfTable(tables.parse_ragged_cdf(ragged), "cpu")
    symbols = np.random.RandomState(0).randint(0, 16, (8, 32)).astype(
        np.int32)
    per = symbols.shape[0] // world
    buf, lens = torch_coder.encode_streams(
        torch.as_tensor(symbols[rank * per:(rank + 1) * per]), table)
    out["buf"], out["lengths"] = multihost.gather_bytes(buf, lens)
    out["ragged"], out["symbols"] = ragged, symbols

    # Unequal shards: 5 streams with escapes on rank 0 (longer streams, a
    # wider buffer), 3 without on rank 1, on the table with overflow.
    ragged_o, _ = _replicated(rank, lambda: _ragged(True))
    table_o = torch_coder.DeviceCdfTable(tables.parse_ragged_cdf(ragged_o),
                                         "cpu")
    wide = np.random.RandomState(1).randint(0, 14, (8, 32)).astype(np.int32)
    wide[0, 3], wide[2, 30], wide[4, 0] = 5000, -70000, 17
    cut = 5
    part = wide[:cut] if rank == 0 else wide[cut:]
    buf, lens = torch_coder.encode_streams(torch.as_tensor(part), table_o)
    out["local_width"] = np.int64(buf.shape[1])
    out["wide_buf"], out["wide_lengths"] = multihost.gather_bytes(buf, lens)
    out["wide_ragged"], out["wide_symbols"] = ragged_o, wide

    # The sidecar coder: EM tables on rank 0 only.
    def build_em_tables():
        gen = torch.Generator().manual_seed(3)
        prior = deep_factorized.NoisyDeepFactorized(
            params=deep_factorized.DeepFactorized.init_params(
                (4,), generator=gen), batch_shape=(4,))
        em0 = ContinuousBatchedEntropyModel(
            prior=prior, coding_rank=3, compression=True,
            offset_heuristic=False, device="cpu")
        return em0.get_weights()

    em_cdf, em_off = _replicated(rank, build_em_tables)
    em = ContinuousBatchedEntropyModel(
        prior_shape=(4,), cdf=em_cdf, cdf_offset=em_off, coding_rank=3,
        compression=True, offset_heuristic=False, device="cpu")
    rows = np.random.RandomState(11).normal(0, 2, (8, 1, 8, 4)).astype(
        np.float32)
    rows[0, 0, 0, 0] = 300.0
    n_elem = 8 * 4
    per = rows.shape[0] // world
    sbuf, slens, ei, ev = em.compress_sidecar_device(
        torch.as_tensor(rows[rank * per:(rank + 1) * per]))
    out["sidecar_buf"], out["sidecar_lens"] = multihost.gather_bytes(
        sbuf.reshape(per, -1), slens)
    found = [None] * world
    dist.all_gather_object(found, (ei.numpy(), ev.numpy()))
    out["sidecar_esc_pos"] = np.concatenate(
        [i + r * per * n_elem for r, (i, _) in enumerate(found)])
    out["sidecar_esc_val"] = np.concatenate([v for _, v in found])
    out["sidecar_rows"], out["em_cdf"], out["em_off"] = rows, em_cdf, em_off

    # bls2017 DP steps from the given parameters, with this rank's slice of
    # the given noise.
    mesh = sharding.make_mesh(device="cpu")
    model = bls2017.BLS2017Model(num_filters=int(inputs["num_filters"]))
    model.load_state_dict({k[len("param/"):]: torch.as_tensor(v)
                           for k, v in inputs.items()
                           if k.startswith("param/")})
    step = sharding.data_parallel_train_step(
        mesh, model, torch.optim.Adam(model.parameters(),
                                      lr=float(inputs["lr"])))
    batch = sharding.shard_batch(mesh, inputs["batch"])
    for i in range(int(inputs["steps"])):
        metrics = step(batch, u=sharding.shard_batch(mesh, inputs[f"u{i}"]))
    out.update({f"param/{k}": v.numpy()
                for k, v in model.state_dict().items()})
    out.update({f"metric/{k}": v.numpy() for k, v in metrics.items()})
    return out


def dptp(world, rank, inputs):
    import torch

    from compression_tpu_torch.models import bmshj2018
    from compression_tpu_torch.parallel import sharding

    mesh = sharding.make_mesh(device="cpu")
    assert mesh.shape == {"data": 2, "model": 2}, mesh.shape
    model = bmshj2018.BMSHJ2018Model(num_filters=int(inputs["num_filters"]),
                                     num_scales=int(inputs["num_scales"]))
    model.load_state_dict({k[len("param/"):]: torch.as_tensor(v)
                           for k, v in inputs.items()
                           if k.startswith("param/")})
    step, model, optimizer = sharding.dp_tp_train_step(
        mesh, model, torch.optim.Adam(model.parameters(),
                                      lr=float(inputs["lr"])))
    batch = sharding.shard_batch(mesh, inputs["batch"])
    for i in range(int(inputs["steps"])):
        u = sharding.shard_batch(mesh, (inputs[f"u{i}_z"], inputs[f"u{i}_y"]))
        metrics = step(batch, u=u)
        if i == 0:  # the first step's gradients, averaged over the data axis
            out = {f"grad/{k}": p.grad.numpy()
                   for k, p in model.named_parameters()}
    out.update({f"param/{k}": v.numpy()
                for k, v in model.state_dict().items()})
    out.update({f"metric/{k}": v.numpy() for k, v in metrics.items()})
    out["coords"] = np.asarray(mesh.coords)
    for name, s in step.shards.items():
        state = optimizer.state[s]
        out[f"shard/{name}"] = s.detach().numpy()
        out[f"exp_avg/{name}"] = state["exp_avg"].numpy()
        out[f"exp_avg_sq/{name}"] = state["exp_avg_sq"].numpy()
    out["in_optimizer"] = np.asarray(
        [any(p is s for g in optimizer.param_groups for p in g["params"])
         for s in step.shards.values()])
    return out


def _card_setup():
    """bls2017 at CARD_FILTERS from seed 0, the batch and each step's
    noise for the global batch, drawn on the CPU from seeds, TF32 off."""
    import torch
    from compression_tpu_torch.models import bls2017

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    model = bls2017.BLS2017Model(num_filters=CARD_FILTERS, seed=0)
    batch = np.random.RandomState(1).randint(0, 256, CARD_BATCH).astype(
        np.float32)
    latent = (CARD_BATCH[0], CARD_BATCH[1] // 16, CARD_BATCH[2] // 16,
              CARD_FILTERS)
    noise = [torch.rand(latent, generator=torch.Generator().manual_seed(
        100 + i)) - 0.5 for i in range(PARITY_STEPS + TIMED_STEPS)]
    return model, batch, noise


def _card_run(step, model, batch, noise, save_as=None):
    """Steps on ``noise``, each timed by CUDA events around a synchronized
    step.  Keeps the first step's gradients and metrics and the parameters
    after PARITY_STEPS, and writes them to <out_dir>/<save_as>.pt when
    asked.  Returns (the ms of every step, what it kept)."""
    import torch
    times, kept = [], {}
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for i, u in enumerate(noise):
        torch.cuda.synchronize()
        start.record()
        metrics = step(batch, u=u)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
        if i == 0:
            kept["grad"] = {k: p.grad.detach().cpu().clone()
                            for k, p in model.named_parameters()}
            kept["metrics"] = {k: float(v) for k, v in metrics.items()}
        if i + 1 == PARITY_STEPS:
            kept["params"] = {k: v.detach().cpu().clone()
                              for k, v in model.state_dict().items()}
    if save_as:
        torch.save(kept, os.path.join(OUT_DIR, f"{save_as}.pt"))
    return times, kept


def card_nccl(world, rank, inputs):
    import copy

    import torch
    import torch.distributed as dist

    from compression_tpu_torch.codec import tables, torch_coder
    from compression_tpu_torch.models import bls2017
    from compression_tpu_torch.parallel import multihost, sharding

    device = torch.device("cuda", 0)
    report = {"backend": dist.get_backend(), "world": dist.get_world_size()}
    ragged, off = _replicated(rank, lambda: _ragged(True))
    report["tables_equal"] = bool(np.array_equal(ragged, _ragged(True)[0])
                                  and np.array_equal(off, np.zeros(1)))
    table = torch_coder.DeviceCdfTable(tables.parse_ragged_cdf(ragged),
                                       device)
    symbols = torch.as_tensor(np.random.RandomState(0).randint(
        0, 16, (256, 512)).astype(np.int32), device=device)
    buf, lens = torch_coder.encode_streams(symbols, table)
    gbuf, glens = multihost.gather_bytes(buf, lens)
    report["gather_equal"] = bool(
        np.array_equal(gbuf, buf.cpu().numpy())
        and np.array_equal(glens, lens.cpu().numpy()))

    mesh = sharding.make_mesh(device="cuda")
    report["mesh"] = mesh.shape
    model, batch, noise = _card_setup()
    start = copy.deepcopy(model.state_dict())
    torch.save(start, os.path.join(OUT_DIR, "start.pt"))
    batch = torch.as_tensor(batch, device=device)
    noise = [u.to(device) for u in noise]
    kept, step_ms = {}, {}
    for kind in ("make_train_step", "data_parallel", "dp_tp"):
        model.load_state_dict(start)
        model.to(device)
        optimizer = torch.optim.Adam(model.parameters(), lr=1e-3)
        if kind == "make_train_step":
            step = bls2017.make_train_step(model, optimizer)
        elif kind == "data_parallel":
            step = sharding.data_parallel_train_step(mesh, model, optimizer)
        else:
            step, model, optimizer = sharding.dp_tp_train_step(
                mesh, model, optimizer)
            report["tp_leaves"] = sorted(step.shards)
        step_ms[kind], kept[kind] = _card_run(
            step, model, batch, noise,
            "single" if kind == "make_train_step" else None)
    want = kept["make_train_step"]
    for kind in ("data_parallel", "dp_tp"):
        report[f"{kind}_identical"] = want["metrics"] == kept[kind][
            "metrics"] and all(
                torch.equal(kept[kind][part][k], v)
                for part in ("grad", "params") for k, v in want[part].items())
    report["step_ms"] = step_ms
    return report


def card_gloo(world, rank, inputs):
    import torch
    import torch.distributed as dist

    from compression_tpu_torch.parallel import sharding

    mesh = sharding.make_mesh(device="cuda")
    model, batch, noise = _card_setup()
    model.to(mesh.local_device)
    step = sharding.data_parallel_train_step(
        mesh, model, torch.optim.Adam(model.parameters(), lr=1e-3))
    step_ms, _ = _card_run(step, model, sharding.shard_batch(mesh, batch),
                           [sharding.shard_batch(mesh, u) for u in noise],
                           "gloo" if rank == 0 else None)
    return {"backend": dist.get_backend(), "world": dist.get_world_size(),
            "mesh": mesh.shape, "device": str(mesh.local_device),
            "step_ms": step_ms}


SCENARIOS = {"coding": coding, "dptp": dptp, "card_nccl": card_nccl,
             "card_gloo": card_gloo}
OUT_DIR = None


def main():
    global OUT_DIR
    scenario, world, rank, port, in_path, OUT_DIR = sys.argv[1:7]
    world, rank = int(world), int(rank)

    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    from compression_tpu_torch.parallel import multihost

    address = f"localhost:{port}"
    if scenario.startswith("card"):
        backend = "nccl" if scenario == "card_nccl" else "gloo"
        dist.init_process_group(backend, init_method=f"tcp://{address}",
                                world_size=world, rank=rank, timeout=TIMEOUT)
    else:
        multihost.initialize(address, world, rank, device="cpu",
                             timeout=TIMEOUT)
    inputs = dict(np.load(in_path)) if in_path else {}
    try:
        result = SCENARIOS[scenario](world, rank, inputs)
        if scenario.startswith("card"):
            with open(os.path.join(OUT_DIR, f"rank{rank}.json"), "w") as f:
                json.dump(result, f)
        else:
            np.savez(os.path.join(OUT_DIR, f"rank{rank}.npz"), **result)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    print(f"rank {rank} done", flush=True)


if __name__ == "__main__":
    main()
