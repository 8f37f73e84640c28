"""Runs one cell of the benchmark once and prints its result as the last
line of standard output.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

``--trace 0`` measures the cell's end-to-end metrics; ``--trace 1`` its
per-layer metrics (an untraced window as long, then a traced one of at most
ten seconds).  Exits non-zero, and prints no result, without enough CUDA
devices or if JAX or the JAX package was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    from portbench import harness

    return harness.run(args, T0)


if __name__ == "__main__":
    sys.exit(main())
