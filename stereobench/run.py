"""Run one cell of the benchmark on the card and print its result line.

    python3 stereobench/run.py --workload kitti2015.stream --seed 7 \\
        --seconds 10 --trace 0

Loads the cell's configuration and traffic (``BENCHMARK.json`` names
them), makes its inputs from ``--seed`` on the card, warms up every shape
the cell uses (``setup_s``, from process start), measures for
``--seconds``, checks what the timed path produced against the plain
reference, and prints one JSON object as the last line of standard
output: with ``--trace 0`` the cell's end-to-end metrics, with ``--trace
1`` its per-layer metrics from a traced stretch of the window.  Without
a CUDA card, or with fewer than the cell asks for, it prints no result
and exits with 2.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# Run as a script: the package's parent, the checkout's root, goes first
# on the path in place of this file's own directory.
_HERE = Path(__file__).resolve().parent
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != _HERE]
sys.path.insert(0, str(_HERE.parent))


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    from stereobench import harness

    cell = harness.resolve(harness.load_manifest(), args.workload)
    try:
        device = harness.card(cell.chips)
    except SystemExit as e:
        print(e, file=sys.stderr)
        return 2
    try:
        result = harness.execute(cell, args.seed, args.seconds,
                                 bool(args.trace), device, STARTED)
    except SystemExit as e:
        print(e, file=sys.stderr)
        return 3
    harness.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
