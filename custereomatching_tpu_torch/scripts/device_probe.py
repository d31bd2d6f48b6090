"""Card health probe: is the CUDA card delivering its normal throughput?

    python -m custereomatching_tpu_torch.scripts.device_probe \\
        [--floor-tflops 200] [--max-slowdown 2.0] [--sass]

The counterpart of ``scripts/device_probe.py``.  Two criteria, in order:

1. A bf16 4096^3 ``torch.matmul`` (a plain product outside any kernel, as
   the JAX probe's ``a @ a``), timed with CUDA events.  It runs first, so
   it finds a hung card cheaply, and below ``--floor-tflops`` (about a
   quarter of what an H100 sustains) the window is catastrophic.
2. The K10a ``madd`` rate, measured by the bound model's own probe
   (``utils/kernel_model.py``), against the rate cached for this card in
   ``build/rates/hopper_rates.json``: the health criterion, since the
   port's kernels are priced in the probes' classes.  Slower than
   ``--max-slowdown`` times the cached rate (or, with no cached rate,
   than ``--abs-madd-ps``) is degraded.  A probe that fails to build or
   launch raises: nothing falls back to the matmul alone.

``--sass`` also prints, from the built kernel library (``cuobjdump
-sass``), the instruction counts of each probe kernel (FFMA, LDS, MUFU,
BAR, ...), to check that the compiler kept the probes' work.

Exit codes: 0 healthy; 1 degraded, or no card.
"""

from __future__ import annotations

import argparse
import re
import subprocess
import sys
from collections import Counter
from pathlib import Path
from typing import Dict, List

import torch

# Opcodes counted by --sass, and the probe kernels they are counted in.
SASS_OPS = ("FFMA", "FADD", "FMUL", "LDS", "STS", "LDG", "STG", "MUFU", "BAR")
PROBE_KERNELS = ("op_probe_kernel", "box_probe_kernel", "hbm_read_kernel",
                 "hbm_write_kernel")


def probe_matmul(size: int, iters: int) -> float:
    """TFLOP/s of a bf16 ``size``^3 matmul on the card."""
    from custereomatching_tpu_torch.utils.timer import benchmark

    a = torch.ones((size, size), dtype=torch.bfloat16, device="cuda")
    t = benchmark(torch.matmul, a, a, warmup=2, iters=iters, chain=4)
    return 2 * size ** 3 / t["median_s"] / 1e12


def probe_madd():
    """(measured madd seconds an element, the cached one or None)."""
    from custereomatching_tpu_torch.utils.kernel_model import (
        _run_rate,
        measure_vpu_rates,
    )

    cached = measure_vpu_rates(measure_if_missing=False)
    return _run_rate("madd"), (cached or {}).get("madd")


def sass_counts(sass: str) -> Dict[str, Counter]:
    """Opcode counts of each function in ``cuobjdump -sass`` output."""
    counts: Dict[str, Counter] = {}
    current = None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            current = counts.setdefault(m.group(1), Counter())
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9]+)",
                     line)
        if m and current is not None:
            current[m.group(1)] += 1
    return counts


def print_sass() -> None:
    from custereomatching_tpu_torch.ops import _build

    lib = _build.build()
    tool = Path(_build.nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    for name, ops in sorted(sass_counts(sass).items()):
        if any(k in name for k in PROBE_KERNELS):
            shown = ", ".join(f"{op} {ops[op]}" for op in SASS_OPS
                              if ops[op])
            print(f"sass: {name}: {sum(ops.values())} instructions; {shown}")


def main(argv: List[str] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--floor-tflops", type=float, default=200.0,
                    help="bf16 matmul rate below which the window is "
                    "catastrophic")
    ap.add_argument("--max-slowdown", type=float, default=2.0,
                    help="the most the madd probe may be slower than the "
                    "cached rate")
    ap.add_argument("--abs-madd-ps", type=float, default=0.1,
                    help="madd limit (ps an element) when no rate is cached")
    ap.add_argument("--size", type=int, default=4096)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--sass", action="store_true",
                    help="print the probe kernels' SASS instruction counts")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("DEVICE-PROBE: no CUDA card", file=sys.stderr)
        return 1
    from custereomatching_tpu_torch.utils.profiling import card_line

    print(f"device: {card_line()}")
    if args.sass:
        print_sass()
    tflops = probe_matmul(args.size, args.iters)
    print(f"matmul {args.size}^3 bf16: {tflops:.1f} TFLOP/s "
          f"(floor {args.floor_tflops:.0f})")
    if tflops < args.floor_tflops:
        print(f"DEVICE-PROBE DEGRADED (matmul below {args.floor_tflops:.0f} "
              f"TFLOP/s: catastrophic window)")
        return 1

    madd, ref = probe_madd()
    if ref is not None:
        limit = ref * args.max_slowdown
        rel = f"{madd / ref:.3f}x the cached {ref * 1e12:.5f}"
    else:
        limit = args.abs_madd_ps * 1e-12
        rel = "no cached rate"
    print(f"madd: {madd * 1e12:.5f} ps an element, {2 / madd / 1e12:.2f} "
          f"TFLOP/s ({rel}; limit {limit * 1e12:.5f})")
    ok = madd <= limit
    print("DEVICE-PROBE", "HEALTHY" if ok else
          "DEGRADED (madd below its normal rate)")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
