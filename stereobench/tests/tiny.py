"""Tiny CPU versions of the cells, for the tests: the same files, with
the sizes cut so that the port's plain versions run in a second."""

from __future__ import annotations

import time

import torch

from stereobench import harness

SCENE = {"dot_density": 0.08, "dot_sigma": 0.8, "noise": 0.01}
SIZES = {
    "kitti2015": dict(height=20, width=40, num_disparities=8, kernel_size=5,
                      frames_per_call=2,
                      scene=dict(SCENE, d_min=1.0, d_max=6.0)),
    "speckle_verify": dict(height=16, width=24, kernel_size=5,
                           scene=dict(SCENE, d_min=1.0, d_max=4.0)),
}
CPU = torch.device("cpu")


def manifest() -> dict:
    return harness.load_manifest()


def cell(workload: str) -> harness.Cell:
    c = harness.resolve(manifest(), workload)
    config = dict(c.config, **SIZES[c.config["name"]])
    mix = dict(c.traffic)
    for key in ("check_within", "trace_from"):
        mix[key] = min(mix[key], 6)
    for key in ("trace_calls", "trace_requests", "trace_steps"):
        if key in mix:
            mix[key] = 3
    if "check_requests" in mix:
        mix["check_requests"] = 3
    return c._replace(config=config, traffic=mix)


def execute(workload: str, seed: int = 2 ** 31 + 7, trace: bool = False):
    return harness.execute(cell(workload), seed, 0.2, trace, CPU,
                           time.perf_counter())


WORKLOADS = [w["name"] for w in manifest()["workloads"]]
