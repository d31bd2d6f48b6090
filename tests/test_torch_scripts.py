"""CPU tests of the port's measurement scripts: the Chrome-trace reading
behind ``device_profile``'s busy time and idle share, the edits
``kernel_variants`` makes to the kernels' sources, and both scripts'
refusal to run without a card."""

import pytest
import torch

from custereomatching_tpu_torch.scripts import device_profile as dp
from custereomatching_tpu_torch.scripts import kernel_variants as kv


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
    """Every variant's edits find their text once in camera_grad.cuh and
    change it; the copy holds the whole package, so its kernels build on
    their own; a variant that keeps the values changes no arithmetic of
    the cut kind (no phase skipped on ``d0 < 0``)."""
    source = (kv.ROOT / kv.PACKAGE / kv.SOURCE).read_text()
    edited = kv.edit_source(source, name)
    assert edited != source
    keeps, _ = kv.VARIANTS[name]
    assert keeps == ("d0 < 0" not in edited
                     and "ex2 + 0.25f" not in edited
                     and "grad_rows(xbuf, ybuf, gs, k, np);" in edited)
    tree = kv.make_variant(name, tmp_path)
    assert (tree / kv.PACKAGE / kv.SOURCE).read_text() == edited
    assert (tree / kv.PACKAGE / "ops" / "_build.py").is_file()


def test_kernel_variants_refuse_unknown_names_and_need_a_card(capsys):
    with pytest.raises(SystemExit):
        kv.main(["p7"])
    assert "unknown variants" in capsys.readouterr().err
    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the path without one")
    assert kv.main([]) == 1
