"""Batch compression sharded over every card (PyTorch counterpart of
examples/pod_compress.py).

Compresses a batch of images' latent rows with the native containers'
sidecar coder (``compress_sidecar_device`` / ``decompress_sidecar_device``
of the entropy model, through ``parallel.SidecarBatchCodec``), the coder
streams sharded over an in-process mesh at the native stream geometry
(models/native_format.py: rows of <= 512 symbols): bls2017's latent of a
512x512 image, 32x32x128, in k = 8 row blocks, 256 streams of 512 symbols
an image, with two planted outliers that ride the escape sidecar.  It runs
on a mesh of one device and on one of every device, and reports the rates,
whether the bytes are identical across the two, and the put / compute /
gather phases of each (``PhaseTimer``).  The record is written to
``--out`` only when it is given.

Runs on the card (every card of the host) unless ``--device cpu`` is
given; ``--num_devices`` sets the size of the second mesh (on the CPU, in-
process entries of one host, whose rates say nothing of scaling).

Usage:
  python -m compression_tpu_torch.examples.pod_compress [--out record.json]
      [--device cpu --num_devices 2]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

# The batch and bls2017's latent depth, as the JAX script has them.
NUM_IMAGES = 4
CHANNELS = 128


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--num_devices", type=int, default=None)
    parser.add_argument("--out", default=None)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    from compression_tpu_torch.codec import torch_coder
    from compression_tpu_torch.distributions import (deep_factorized,
                                                     uniform_noise)
    from compression_tpu_torch.entropy_models.continuous_batched import (
        ContinuousBatchedEntropyModel)
    from compression_tpu_torch.parallel import SidecarBatchCodec, make_mesh
    from compression_tpu_torch.util.device import resolve_device

    device = resolve_device(args.device)
    cuda = device.type == "cuda"
    n_all = args.num_devices or (torch.cuda.device_count() if cuda else 1)
    kind = torch.cuda.get_device_name(0) if cuda else "cpu"

    # bls2017-like latent geometry at 512x512: y = 32x32x128, split into
    # k=8 row blocks -> 256 streams of n = 4*128 = 512 symbols per image.
    h, w, c, k = 32, 32, CHANNELS, 8
    rows_per_image = h * k
    wb = w // k

    prior = uniform_noise.UniformNoiseAdapter(
        deep_factorized.DeepFactorized(
            params=deep_factorized.DeepFactorized.init_params(
                (c,), generator=torch.Generator().manual_seed(2)),
            batch_shape=(c,)))
    em = ContinuousBatchedEntropyModel(
        prior=prior, coding_rank=3, compression=True, device=device)

    rng = np.random.RandomState(0)
    rows = rng.normal(0, 2, size=(NUM_IMAGES * rows_per_image, 1, wb,
                                  c)).astype(np.float32)
    rows[0, 0, 0, 0] = 500.0  # outliers ride the escape sidecar
    rows[7, 0, 1, 3] = -400.0
    n = wb * c
    expect = em.quantize(torch.as_tensor(rows, device=device)).cpu().numpy()

    print(f"devices: {n_all} x {kind}")

    results = {}
    phases = {}
    outs = []
    for ndev in [1, n_all]:
        mesh = make_mesh(ndev, data_axis=ndev, device=device.type)
        codec = SidecarBatchCodec(em, mesh)
        codec.encode(rows[: max(ndev, 1)])  # warm up
        codec.timer.totals.clear()
        codec.timer.counts.clear()
        t0 = time.perf_counter()
        buf, lengths, esc_idx, esc_val = codec.encode(rows)
        t_enc = time.perf_counter() - t0
        assert esc_idx.size >= 2
        codec.decode(buf[: max(ndev, 1)], lengths[: max(ndev, 1)],
                     (1, wb), esc_idx[esc_idx < max(ndev, 1) * n],
                     esc_val[esc_idx < max(ndev, 1) * n])  # warm up
        t0 = time.perf_counter()
        decoded, sanity = codec.decode(
            buf, lengths, (1, wb), esc_idx, esc_val)
        t_dec = time.perf_counter() - t0
        assert sanity.all()
        assert np.array_equal(decoded, expect)
        total = rows.shape[0] * n
        results[ndev] = (total / t_enc, total / t_dec)
        outs.append(torch_coder.to_bytes_list(buf, lengths))
        # Per-phase decomposition: compute (the part that scales with
        # devices) against put / gather (host <-> device copies, the
        # ceiling of the scaling).
        summ = codec.timer.summary()
        phases[ndev] = {
            kk: summ[kk]["mean_ms"] for kk in sorted(summ) if "_" in kk}
        for op in ("encode", "decode"):
            tot = sum(v for kk, v in phases[ndev].items()
                      if kk.startswith(op + "_"))
            if tot > 0:
                phases[ndev][f"{op}_compute_fraction"] = round(
                    phases[ndev].get(f"{op}_compute", 0.0) / tot, 4)
        print(f"{ndev} device(s): encode {total/t_enc/1e6:.2f} M sym/s, "
              f"decode {total/t_dec/1e6:.2f} M sym/s  phases={phases[ndev]}")

    # Byte determinism across device counts (the DP contract).
    same = outs[0] == outs[-1]
    print(f"container bytes identical across device counts: {same}")

    n1, nN = 1, n_all
    record = {
        "devices": nN,
        "device_kind": kind,
        # In-process CPU entries share one host: throughput cannot scale
        # there, only byte determinism is meaningful.
        "virtual_mesh": not cuda,
        "coder_path": "sidecar (compress/decompress_sidecar_device, "
                      f"native stream geometry n={n}, escapes present)",
        "encode_sym_per_s": {str(kk): round(v[0], 1)
                             for kk, v in results.items()},
        "decode_sym_per_s": {str(kk): round(v[1], 1)
                             for kk, v in results.items()},
        "scaling_efficiency_encode": round(
            results[nN][0] / (results[n1][0] * nN), 4),
        "scaling_efficiency_decode": round(
            results[nN][1] / (results[n1][1] * nN), 4),
        "bytes_deterministic_across_device_counts": bool(same),
        "phase_decomposition_ms": {str(kk): v for kk, v in phases.items()},
    }
    print(json.dumps(record))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
        print(f"wrote {args.out}")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
