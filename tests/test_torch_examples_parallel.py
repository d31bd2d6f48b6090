"""PyTorch port: the parallel examples (``examples/scaling.py``,
``examples/pipeline_stages.py``) at a tiny size on 2 spawned gloo ranks,
as tests/test_examples_smoke.py runs the JAX package's on virtual
devices."""

import pytest

from custereomatching_tpu_torch.examples import pipeline_stages, scaling


def test_scaling_script_strong_mode(capsys):
    scaling.main(["--device", "cpu", "--ranks", "2", "--height", "16",
                  "--width", "64", "--disparities", "8", "--kernel-size",
                  "5", "--pipeline", "volume", "--strong",
                  "--halo-breakdown"])
    out = capsys.readouterr().out
    assert "overhead" in out and "halo exchange alone" in out
    for mesh in ("1x1", "2x1", "1x2"):
        assert mesh in out


def test_pipeline_stages_script(capsys):
    pipeline_stages.main(["--device", "cpu", "--ranks", "2", "--stages",
                          "2", "--frames", "4", "--height", "24",
                          "--width", "48", "-D", "7", "--kernel-size", "5"])
    out = capsys.readouterr().out
    assert "2 pipeline stages over 2 ranks" in out
    assert "PIPELINE-STAGES PASS" in out


@pytest.mark.parametrize("script", [scaling, pipeline_stages])
def test_ranks_need_the_cpu(script):
    """Spawned ranks are gloo ranks: on cards the examples run under
    torchrun instead."""
    with pytest.raises(ValueError, match="--device cpu"):
        script.main(["--ranks", "2"])


def test_mesh_check_script(capsys):
    """The multi-rank check on 2 gloo ranks at a tiny size: every mesh of
    2 ranks and the 2-stage pipeline pass."""
    from custereomatching_tpu_torch.scripts import mesh_check

    rc = mesh_check.main(["--device", "cpu", "--ranks", "2", "--frames",
                          "2", "--height", "16", "--width", "40", "-D", "6",
                          "--stage-disparities", "5", "-k", "3"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "FAIL" not in out
    for what in ("mesh 2x1: sharded volume (K1) bit-equal",
                 "mesh 1x2: halo_exchange delivers the global rows",
                 "mesh 1x2: camera gradient through K3w + K4",
                 "pipeline S=2: full-range K3 maps"):
        assert f"PASS {what}" in out
