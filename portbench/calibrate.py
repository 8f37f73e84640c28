"""Readings that the limits of ``correct`` are set from, on the chip, at a
cell's own sizes (the benchmark's runs do not run this):

* ``program``: the numbers a run compares, for each of ``--seeds``, each
  seed's run with a short window (``--seconds``);
* ``control``: the same numbers of the reference computed in TF32 put in
  the program's place, for each of ``--control-seeds``;
* ``fault:<name>``: a run whose timed path is broken underneath
  (``faults.py``), for each of ``--control-seeds``.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        --control-seeds 4,5,6 --seconds 3

Prints one JSON line per reading.
"""

import argparse
import itertools
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def _control_codec(cell, ctx):
    from portbench import textures
    from portbench import weights as weights_lib
    from portbench.loops import _codec
    from portbench.reference import check_codec

    _codec.precision(cell.config)
    w = weights_lib.make(cell.config_module.spec(cell.config),
                         weights_lib.sub_seed(ctx.seed, _codec.WEIGHTS),
                         ctx.device)
    tr = cell.traffic
    pool = textures.pool(tr["pool"], tr["height"], tr["width"],
                         weights_lib.sub_seed(ctx.seed, _codec.IMAGES),
                         ctx.device).cpu().numpy()
    tables = check_codec.CodecTables(cell.config, w)
    worst = {}
    for i in itertools.islice(_codec.order(ctx.seed, len(pool)),
                              tr["check"]):
        numbers = check_codec.control(cell.reference, cell.config, w, tables,
                                      pool[i], ctx.device)
        for k, v in numbers.items():
            worst[k] = max(worst.get(k, v), v)
    return worst


def _control_train(cell, ctx):
    import torch

    from portbench import textures
    from portbench import weights as weights_lib
    from portbench.loops import _codec, train_loop
    from portbench.reference import check_train

    tr = cell.traffic
    _codec.precision(cell.config)
    w = weights_lib.make(cell.config_module.spec(cell.config),
                         weights_lib.sub_seed(ctx.seed, _codec.WEIGHTS),
                         ctx.device)
    pool = textures.pool(tr["pool"], tr["height"], tr["width"],
                         weights_lib.sub_seed(ctx.seed, _codec.IMAGES),
                         ctx.device)
    feed = train_loop.Feed(ctx, pool)
    fed = [feed() for _ in range(check_train.STEPS)]
    args = (cell.reference, cell.config, w, [b for b, _ in fed],
            [u for _, u in fed], tr["lr"])
    low = check_train.reference_steps(*args, tf32=True)
    high = check_train.reference_steps(*args)
    del pool
    torch.cuda.empty_cache()
    return check_train.gaps(low, high)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", default="")
    parser.add_argument("--control-seeds", default="")
    parser.add_argument("--faults", default="")
    parser.add_argument("--seconds", type=float, default=3.0)
    args = parser.parse_args(argv)
    import torch

    from portbench import faults, harness

    cell = harness.resolve(args.workload)
    device = torch.device("cuda:0")

    def ctx_for(seed):
        return harness.Context(cell=cell, device=device, seed=seed,
                               seconds=args.seconds, trace=False,
                               t0=harness.clock())

    def emit(kind, seed, numbers, started):
        print(json.dumps(dict(kind=kind, seed=seed, seconds=round(
            harness.clock() - started, 1), **numbers)), flush=True)

    for seed in (int(s) for s in args.seeds.split(",") if s):
        started = harness.clock()
        out = cell.loop.run(ctx_for(seed))
        emit("program", seed, out.checks, started)
    for seed in (int(s) for s in args.control_seeds.split(",") if s):
        started = harness.clock()
        control = (_control_train if cell.traffic["loop"] == "train_loop"
                   else _control_codec)
        emit("control", seed, control(cell, ctx_for(seed)), started)
        for name in (f for f in args.faults.split(",") if f):
            started = harness.clock()
            with faults.planted(name):
                out = cell.loop.run(ctx_for(seed))
            emit(f"fault:{name}", seed, dict(out.checks, failed=out.failed),
                 started)
    return 0


if __name__ == "__main__":
    sys.exit(main())
