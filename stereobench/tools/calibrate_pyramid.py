"""The readings that a pyramid cell's limits are set from, in one process.

    python3 stereobench/tools/calibrate_pyramid.py \\
        --workload middlebury2014.pyramid --seeds 12 --seconds 2 \\
        --control 3 --faults 3 --out chiprun_out/x.jsonl

As ``tools/calibrate.py`` for the other cells: for each of ``--seeds``
seeds it runs the cell as ``run.py`` does (a short window) and keeps
every number compared, whose largest is a limit's lower reading; for the
first ``--control`` seeds it judges the control (the reference pyramid in
bfloat16 on the seed's first frame, ``checks_pyramid.control_sample``);
for the first ``--faults`` seeds it runs the cell again with each of
:data:`FAULTS` planted under the timed path.  One JSON line a reading
goes to ``--out`` and standard output, and a summary line a number at
the end.

The faults of a pyramid cell:

  * ``unwarped``: the warp gives shift 0 everywhere (the fine level
    searches the band at the frame's own columns);
  * ``off_by_level``: the shift one pyramid factor f too large;
  * ``altered``: ``faults.altered``, a soft-disparity pixel moved by half
    a pixel at each level's maps.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import torch  # noqa: E402

from stereobench import checks_pyramid, faults, harness  # noqa: E402
from stereobench.tools.calibrate import STEP  # noqa: E402
from stereobench.traffic import generator  # noqa: E402


def _warp_fault(move):
    """Patch the pyramid's warp so that its shift is ``move(self,
    shift)``, the projector warped by that."""
    from custereomatching_tpu_torch.models import pyramid

    def make(original):
        def warp(self, projector, coarse_soft):
            shift, _ = original(self, projector, coarse_soft)
            shift = move(self, shift)
            W = projector.shape[-1]
            return shift, pyramid._warp_projector(projector, shift, -W, W)
        return warp

    return faults._patched(pyramid.PyramidStereoMatcher, "warp", make)


def unwarped():
    return _warp_fault(lambda self, shift: torch.zeros_like(shift))


def off_by_level():
    return _warp_fault(lambda self, shift: shift + self.downsample)


FAULTS = {"unwarped": unwarped, "off_by_level": off_by_level,
          "altered": faults.altered}


def control(cell, seed, device):
    """The control's checks of one seed, on the first frame the cell
    makes."""
    cfg = cell.config
    H, W = int(cfg["height"]), int(cfg["width"])
    B = int(cfg["frames_per_call"])
    sc = generator.scenes(seed, int(cell.traffic["distinct_batches"]) * B,
                          H, W, cfg["scene"], device)
    sample = checks_pyramid.control_sample(sc.camera[:B], sc.projector[:B],
                                           cfg)
    return checks_pyramid.judge([sample], cfg, cell.limits)


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--base", type=int, default=2_000_000_011)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--faults", type=int, default=0)
    p.add_argument("--out", default=None)
    args = p.parse_args()
    cell = harness.resolve(harness.load_manifest(), args.workload)
    device = harness.card(cell.chips)
    out = open(args.out, "a") if args.out else None
    readings = {}

    def note(kind, seed, found, extra=None):
        line = {"workload": cell.name, "kind": kind, "seed": seed,
                "checks": found, **(extra or {})}
        text = json.dumps(line)
        print(text, flush=True)
        if out:
            out.write(text + "\n")
            out.flush()
        for name, c in found.items():
            readings.setdefault((kind, name), []).append(c["value"])

    for i in range(args.seeds):
        seed = args.base + i * STEP
        res = harness.execute(cell, seed, args.seconds, False, device,
                              time.perf_counter())
        note("program", seed, res["checks"],
             {"correct": res["correct"], "metrics": res["metrics"]})
        if i < args.control:
            note("control", seed, control(cell, seed, device))
        if i < args.faults:
            for name, fault in FAULTS.items():
                with fault():
                    res = harness.execute(cell, seed, args.seconds, False,
                                          device, time.perf_counter())
                note(f"fault:{name}", seed, res["checks"],
                     {"correct": res["correct"]})
        torch.cuda.empty_cache()
    for (kind, name), values in sorted(readings.items()):
        text = json.dumps({"summary": kind, "number": name,
                           "max": max(values), "min": min(values),
                           "n": len(values)})
        print(text)
        if out:
            out.write(text + "\n")
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
