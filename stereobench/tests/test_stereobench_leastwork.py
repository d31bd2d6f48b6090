"""The frozen least-work counts equal the port's ``utils/profiling.py``
counts, and count no intermediate."""

import pytest

from custereomatching_tpu_torch.utils import profiling
from stereobench import harness, leastwork


@pytest.mark.parametrize("k", [1, 3, 15, 31, 127])
def test_per_entry_counts_are_the_ports(k):
    assert leastwork.cost_flops(k) == profiling.cost_flops(k)
    assert leastwork.vjp_flops(k) == profiling.vjp_flops(k)
    assert leastwork.HEAD_FLOPS == profiling.HEAD_FLOPS
    assert leastwork.COTANGENT_FLOPS == profiling.COTANGENT_FLOPS


def test_peaks_are_the_ports():
    for name, spec in profiling.DEVICE_SPECS.items():
        assert leastwork.peaks(name) == {"flops": spec["fp32_flops"],
                                         "bytes": spec["hbm_bw"]}


def banded(H, W, D, k):
    return {"height": H, "width": W, "num_disparities": D, "kernel_size": k}


@pytest.mark.parametrize("B,H,W,D,k", [(4, 375, 1242, 192, 15),
                                       (1, 64, 96, 16, 5)])
def test_maps_are_k3s_least_work(B, H, W, D, k):
    w = leastwork.maps(banded(H, W, D, k), B)
    ms, _ = profiling.banded_bounds(B, H, W, D, k)["K3"]
    assert 1e3 * w.seconds(leastwork.PEAKS["NVIDIA H100 80GB HBM3"]) \
        == pytest.approx(ms, rel=1e-12)


@pytest.mark.parametrize("B,H,W,D,k", [(4, 375, 1242, 192, 15),
                                       (2, 40, 60, 9, 7)])
def test_train_step_is_k3w_and_k4_with_the_residual_counted_once(B, H, W, D,
                                                                  k):
    n = B * H * W * (D + 1)
    px = B * H * W
    k3 = (profiling.cost_flops(k) + profiling.HEAD_FLOPS) * n
    # K4's count reads r back from the saved cost (3 operations an entry);
    # the step's function computed r once, in the forward.
    k4 = (3 + profiling.vjp_flops(k) + profiling.COTANGENT_FLOPS) * n
    w = leastwork.train_step(banded(H, W, D, k), B)
    assert w.flops == k3 + k4 - 3 * n + (leastwork.LOSS_FLOPS
                                         + leastwork.ADAM_FLOPS) * px


def test_allpairs_counts_an_entry_a_projector_column():
    cfg = {"height": 330, "width": 422, "num_disparities": None,
           "kernel_size": 15}
    w = leastwork.maps(cfg, 1)
    ms, _ = profiling.allpairs_bound(1, 330, 422, 15)
    n = 330 * 422 * 422
    assert w.flops == (profiling.cost_flops(15) + profiling.HEAD_FLOPS) * n
    # K8's bound writes the volume; the maps' function does not.
    assert w.bytes == 6 * 4 * 330 * 422 < 4 * n


@pytest.mark.parametrize("what", ["maps", "train_step"])
def test_no_intermediate_is_counted(what):
    fn = getattr(leastwork, what)
    a = fn(banded(30, 50, 8, 5), 2)
    b = fn(banded(30, 50, 120, 5), 2)
    assert a.bytes == b.bytes          # the volume is never read or written
    assert b.flops > a.flops


def test_every_cell_has_its_least_work():
    manifest = harness.load_manifest()
    for w in manifest["workloads"]:
        cell = harness.resolve(manifest, w["name"])
        fn = (leastwork.train_step if cell.traffic["loop"] == "train"
              else leastwork.maps)
        work = fn(cell.config, int(cell.config.get("frames_per_call", 1)))
        assert work.flops > 0 and work.bytes > 0
