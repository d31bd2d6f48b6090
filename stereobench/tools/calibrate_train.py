"""The readings that the limits of a train cell on the ``volume_free`` or
``volume`` loop are set from, in one process.

    python3 stereobench/tools/calibrate_train.py \\
        --workload middlebury2014_train.volume_free --seeds 12 --seconds 2 \\
        --control 3 --faults 3 --out calib.jsonl

``tools/calibrate.py`` itself (the same options and lines), with its
control and its list of faults for these loops: the control is the
reference's own first steps from the same start in bfloat16 (for
``volume_free`` in row bands, :func:`checks_volume_free.control`, judged
by :func:`checks_volume_free.judge`; for ``volume`` whole frames,
:func:`checks.control_train`), and every fault of ``faults.py`` reaches
the step (:func:`applicable`).
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from stereobench import checks, checks_volume_free  # noqa: E402
from stereobench.tools import calibrate  # noqa: E402
from stereobench.traffic import generator  # noqa: E402

# The loops whose cells this tool calibrates.
LOOPS = ("volume_free", "volume")


def control(cell, seed, device):
    """The control's checks of one seed, from the cell's own start."""
    cfg, mix = cell.config, cell.traffic
    B = int(cfg["frames_per_call"])
    sc = generator.scenes(seed, B, int(cfg["height"]), int(cfg["width"]),
                          cfg["scene"], device)
    camera0 = sc.camera + generator.perturbation(
        seed, sc.camera.shape, float(mix["start_noise"]), device)
    lr, steps = float(mix["learning_rate"]), int(mix["first_steps"])
    if mix["loop"] == "volume_free":
        recs = checks_volume_free.control(camera0, sc.projector,
                                          sc.disparity, cfg, lr, seed, steps)
        return checks_volume_free.judge(recs, [], sc.projector,
                                        sc.disparity, cfg, lr, cell.limits,
                                        seed)
    recs = checks.control_train(camera0, sc.projector, sc.disparity, cfg, lr,
                                steps)
    return checks.judge_train(recs, [], sc.projector, sc.disparity, cfg, lr,
                              cell.limits)


def applicable(cell):
    """The faults of ``faults.py`` that reach the cell's step: every one
    goes through ``make_train_step``."""
    names = ["unchanged", "ascent", "altered"]
    if int(cell.config["frames_per_call"]) >= 2:
        names.append("half_batch")
    return names


def route() -> None:
    """Send ``tools/calibrate.py``'s ``control`` and ``applicable`` here
    for the cells whose loop is one of :data:`LOOPS`."""
    def routed(own, added):
        def choose(cell, *args):
            return (added if cell.traffic["loop"] in LOOPS else own)(cell,
                                                                     *args)
        return choose

    calibrate.control = routed(calibrate.control, control)
    calibrate.applicable = routed(calibrate.applicable, applicable)


if __name__ == "__main__":
    route()
    sys.exit(calibrate.main())
