"""The readings that the limits of a cell are set from, in one process.

    python3 stereobench/tools/calibrate.py --workload kitti2015.train \\
        --seeds 12 --seconds 2 --control 3 --faults 3 --out chiprun_out/x.jsonl

For each of ``--seeds`` seeds it runs the cell as ``run.py`` does (a
short window) and keeps every number compared: the program's readings,
whose largest is a limit's lower reading.  For the first ``--control``
seeds it puts the control in the program's place (the reference in
bfloat16, on the same inputs: for a map cell the first batch, for a train cell its own first steps from the same start)
and judges it the same way; for the first ``--faults`` seeds it runs the
cell again with each fault of ``faults.py`` that the cell can have
planted under the timed path.  The smallest of those is an upper
reading.  One JSON line a reading goes to ``--out`` and standard output,
and a summary line a number at the end.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import torch  # noqa: E402

from stereobench import checks, faults, harness  # noqa: E402
from stereobench.traffic import generator  # noqa: E402

STEP = 1_000_003 * 2_147


def control(cell, seed, device):
    """The control's checks of one seed, on the inputs the cell makes."""
    cfg, mix = cell.config, cell.traffic
    H, W = int(cfg["height"]), int(cfg["width"])
    B = int(cfg["frames_per_call"])
    if mix["loop"] == "train":
        sc = generator.scenes(seed, B, H, W, cfg["scene"], device)
        camera0 = sc.camera + generator.perturbation(
            seed, sc.camera.shape, float(mix["start_noise"]), device)
        lr = float(mix["learning_rate"])
        recs = checks.control_train(camera0, sc.projector, sc.disparity, cfg,
                                    lr, int(mix["first_steps"]))
        return checks.judge_train(recs, [], sc.projector, sc.disparity, cfg,
                                  lr, cell.limits)
    sc = generator.scenes(seed, int(mix["distinct_batches"]) * B, H, W,
                          cfg["scene"], device)
    cam, proj = sc.camera[:B], sc.projector[:B]
    maps = checks.control_maps(cam, proj, cfg)
    gaps = checks.judge_maps([{"maps": maps, "camera": cam,
                               "projector": proj}], cfg)
    return checks.map_checks(gaps, cell.limits)


def applicable(cell):
    if cell.traffic["loop"] != "train":
        return ["altered"]
    names = ["unchanged", "ascent", "altered"]
    if int(cell.config["frames_per_call"]) >= 2:
        names.append("half_batch")
    return names


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
                "checks": found}
        if extra:
            line.update(extra)
        text = json.dumps(line)
        print(text, flush=True)
        if out:
            out.write(text + "\n")
            out.flush()
        for name, c in found.items():
            readings.setdefault((kind, name), []).append(
                c["value"])

    for i in range(args.seeds):
        seed = args.base + i * STEP
        res = harness.execute(cell, seed, args.seconds, False, device,
                              time.perf_counter())
        note("program", seed, res["checks"],
             {"correct": res["correct"], "metrics": res["metrics"]})
        if i < args.control:
            note("control", seed, control(cell, seed, device))
        if i < args.faults:
            for name in applicable(cell):
                with faults.FAULTS[name]():
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
