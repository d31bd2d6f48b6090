"""CPU tests of the port's measurement scripts: the Chrome-trace reading
behind ``device_profile``'s busy time and idle share, the edits
``kernel_variants`` makes to the kernels' sources and the outputs it holds
bit for bit, and both scripts' refusal to run without a card."""

import pytest
import torch

from custereomatching_tpu_torch.scripts import device_profile as dp
from custereomatching_tpu_torch.scripts import kernel_variants as kv
from custereomatching_tpu_torch.utils import kernel_model as km


def _event(name, ts, dur, cat="kernel", ph="X"):
    return {"name": name, "ts": ts, "dur": dur, "cat": cat, "ph": ph}


def test_device_intervals_keep_device_events_only():
    events = [
        _event("k", 10.0, 5.0),
        _event("memcpy", 20.0, 2.0, cat="gpu_memcpy"),
        _event("memset", 30.0, 1.0, cat="gpu_memset"),
        _event("aten::add", 0.0, 100.0, cat="cpu_op"),
        _event("cudaLaunchKernel", 9.0, 1.0, cat="cuda_runtime"),
        {"name": "flow", "ph": "s", "cat": "kernel", "ts": 1.0},
    ]
    assert dp.device_intervals(events) == [
        ("k", 10.0, 15.0), ("memcpy", 20.0, 22.0), ("memset", 30.0, 31.0)]


@pytest.mark.parametrize("intervals, busy", [
    ([], 0.0),
    ([("a", 0.0, 4.0)], 4.0),
    ([("a", 0.0, 4.0), ("b", 6.0, 7.0)], 5.0),
    # overlapping (two streams) counts once
    ([("a", 0.0, 4.0), ("b", 2.0, 6.0)], 6.0),
    # nested, and out of order
    ([("b", 1.0, 2.0), ("a", 0.0, 4.0), ("c", 3.0, 3.5)], 4.0),
])
def test_busy_is_the_union_of_intervals(intervals, busy):
    assert dp.busy_us(intervals) == pytest.approx(busy)


def test_per_name_sums_largest_first():
    sums = dp.per_name_us([("a", 0.0, 1.0), ("b", 0.0, 3.0),
                           ("a", 5.0, 6.5)])
    assert list(sums) == ["b", "a"]
    assert sums == pytest.approx({"b": 3.0, "a": 2.5})


def test_main_needs_a_mode_and_a_card(capsys):
    assert dp.main([]) == 2
    assert dp.main(["nonsense"]) == 2
    if not dp.torch.cuda.is_available():
        assert dp.main(["train"]) == 1
        assert "no CUDA device" in capsys.readouterr().err


@pytest.mark.parametrize("name", sorted(kv.VARIANTS))
def test_kernel_variants_edit_the_current_source(name, tmp_path):
    """Every variant's edits find their text once in its source
    (camera_grad.cuh, K7's zncc_banded_proj_bwd.cu for a ``k7_`` name, K8's
    zncc_allpairs.cu for a ``k8_`` name, K9a's layout.cu for a ``k9_``
    name, K10c's rate_probes.cu for a ``k10`` name) and change it; the
    copy holds the whole package, so its kernels
    build on their own; a variant that keeps the values changes no
    arithmetic of the cut kind (no phase skipped on ``d0 < 0``, ``k < 0``
    or ``R < 0``, no load replaced)."""
    rel = kv.source_of(name)
    assert rel == {"k7_": kv.K7_SOURCE, "k8_": kv.K8_SOURCE,
                   "k9_": kv.K9_SOURCE,
                   "k10": kv.K10_SOURCE}.get(name[:3], kv.SOURCE)
    source = (kv.ROOT / kv.PACKAGE / rel).read_text()
    edited = kv.edit_source(source, name)
    assert edited != source
    assert not any(mark in source for mark in kv.CUT_MARKS)
    keeps, _ = kv.VARIANTS[name]
    passes = {kv.K8_SOURCE: "row_products",
              kv.K9_SOURCE: "dst[r] = row[r];",
              kv.K10_SOURCE: "vol[x] = static_cast<float>(x / plane);"}.get(
                  rel, "grad_rows(xbuf, ybuf, gs, k, np);")
    assert keeps == (not any(mark in edited for mark in kv.CUT_MARKS)
                     and passes in edited)
    tree = kv.make_variant(name, tmp_path)
    assert (tree / kv.PACKAGE / rel).read_text() == edited
    assert (tree / kv.PACKAGE / "ops" / "_build.py").is_file()


def test_kernel_variants_hold_k1_k4_k6_and_k7():
    """The outputs ``--against`` compares bit for bit: K1's and K8's
    volumes, K9a's parity copy of K1's and K2's, K4's, K5's, K6's and K7's
    gradients at every case, K10b's sums and K10c's volume at the
    probes' ragged shapes, and the large-k route's ten outputs, each of
    its shape and finite (on the CPU the wrappers' plain versions give
    them); its cases hold k = 15 and each k a backward kernel's first
    version stopped at (K5 27, K4 47, K6 81, K7 93)."""
    assert {k for *_, k in kv.CASES} >= {15, 27, 47, 81, 93}
    cases = ((16, 48, 6, 3), (44, 40, 5, 5))
    routes, ap_routes = ((12, 40, 5, 129),), ((6, 20, 145),)
    got = kv.kernel_outputs(cases, "cpu", routes, ap_routes)
    assert sorted(got) == sorted(
        [f"{name} {H}x{W} D={D} k={k}" for H, W, D, k in cases
         for name in ("K1", "K2", "K4", "K5", "K6", "K7", "K9a")]
        + [f"K8 {min(H, 40)}x{W} k={k}" for H, W, _, k in cases]
        + [f"K10{p} {P}x{H}x{W}" for P, H, W in km.HBM_EDGE_SHAPES
           for p in "bc"]
        + [f"{name} {H}x{W} D={D} k={k}" for H, W, D, k in routes
           for name in kv.ROUTES]
        + [f"K8L {H}x{W} k={k}" for H, W, k in ap_routes])
    for P, H, W in km.HBM_EDGE_SHAPES:
        assert tuple(got[f"K10b {P}x{H}x{W}"].shape) == (H, W)
        assert torch.equal(got[f"K10c {P}x{H}x{W}"],
                           torch.arange(P, dtype=torch.float32).view(
                               P, 1, 1).expand(P, H, W))
    for H, W, D, k in cases:
        tag = f"{H}x{W} D={D} k={k}"
        assert tuple(got[f"K1 {tag}"].shape) == (1, H, W, D + 1)
        assert torch.equal(got[f"K9a {tag}"], got[f"K1 {tag}"])
        for name in ("K2", "K4", "K5", "K6", "K7"):
            assert tuple(got[f"{name} {tag}"].shape) == (1, H, W)
        rows = min(H, 40)
        assert tuple(got[f"K8 {rows}x{W} k={k}"].shape) == (1, rows, W, W)
    # K2 reads K1's volume as the cost; K6 recomputes it: the same
    # gradient.
    for H, W, D, k in cases:
        tag = f"{H}x{W} D={D} k={k}"
        torch.testing.assert_close(got[f"K2 {tag}"], got[f"K6 {tag}"],
                                   rtol=1e-5, atol=1e-9)
    assert all(bool(torch.isfinite(v).all()) for v in got.values())


def test_kernel_variants_hold_the_large_k_routes():
    """The route outputs ``--against`` holds bit for bit: at KITTI with k =
    129 (K8L at 330x422 with k = 145) and at 40x130 with k = 131 and 255,
    each route through ``ops/cuda_large_k.py``'s functions; on the CPU
    (the steps' plain forms) each has its shape, K1L is the plain banded
    volume, K3wL's and K3mL's maps are K3L's with am, s and t, and K3wL's
    volume is K1L's."""
    from custereomatching_tpu_torch.data import make_stereo_pair
    from custereomatching_tpu_torch.ops.zncc import forward_banded

    assert (375, 1242, 192, 129) in kv.ROUTE_CASES
    assert {k for *_, k in kv.ROUTE_CASES} == {129, 131, 255}
    assert (330, 422, 145) in kv.AP_ROUTE_CASES
    assert {k for *_, k in kv.AP_ROUTE_CASES} == {145, 131, 255}
    H, W, D, k = 12, 40, 5, 131
    got = kv.route_outputs(((H, W, D, k),), ((6, 20, 131),), "cpu")
    out = {key.split()[0]: v for key, v in got.items()}
    assert sorted(out) == sorted(kv.ROUTES + ("K8L",))
    cam, proj, _ = make_stereo_pair(H, W, d_min=4.0, d_max=D, seed=8)
    vol = forward_banded(torch.from_numpy(cam[None]),
                         torch.from_numpy(proj[None]), D, k, 1e-8)
    torch.testing.assert_close(out["K1L"], vol.permute(0, 3, 1, 2),
                               rtol=1e-5, atol=1e-6)
    px = H * W
    assert tuple(out["K3L"].shape) == (4, 1, H, W)
    assert out["K3wL"].numel() == 7 * px + (D + 1) * px
    assert torch.equal(out["K3wL"][:4 * px], out["K3L"].flatten())
    assert torch.equal(out["K3mL"], out["K3wL"][:7 * px])
    assert torch.equal(out["K3wL"][7 * px:], out["K1L"].flatten())
    for name in ("K2L", "K6L", "K4L", "K5L", "K7L"):
        assert tuple(out[name].shape) == (1, H, W)
    assert tuple(out["K8L"].shape) == (1, 6, 20, 20)
    assert all(bool(torch.isfinite(v).all()) for v in out.values())


def test_kernel_variants_refuse_unknown_names_and_need_a_card(capsys):
    with pytest.raises(SystemExit):
        kv.main(["p7"])
    assert "unknown variants" in capsys.readouterr().err
    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the path without one")
    assert kv.main([]) == 1
    assert kv.main(["--ab", "build/parent", "--rounds", "2"]) == 1


def test_make_capture_regenerates_the_checked_in_pair(tmp_path, capsys):
    """``make_capture --out DIR`` renders the pair of ``examples/data``:
    each PNG decodes to the checked-in file's samples and the disparity is
    the checked-in ``.npy`` byte for byte; without ``--out`` it refuses,
    so the checked-in pair is never overwritten."""
    from pathlib import Path

    import numpy as np

    from custereomatching_tpu_torch.data.io import decode_png_gray
    from custereomatching_tpu_torch.scripts import make_capture

    data = Path(kv.ROOT) / "examples" / "data"
    assert make_capture.main(["--out", str(tmp_path)]) == 0
    assert "wrote capture pair" in capsys.readouterr().out
    for name in ("capture_camera.png", "capture_projector.png"):
        got = decode_png_gray(str(tmp_path / name))
        want = decode_png_gray(str(data / name))
        assert got.shape == want.shape == (330, 422)
        np.testing.assert_array_equal(got, want)
    assert ((tmp_path / "capture_disparity.npy").read_bytes()
            == (data / "capture_disparity.npy").read_bytes())
    with pytest.raises(SystemExit):
        make_capture.main([])
