"""PyTorch port: config parity with the JAX package, backend resolution,
and the port's independence from jax."""

import dataclasses
import subprocess
import sys

import pytest
import torch

from custereomatching_tpu.config import StereoConfig as JaxStereoConfig
from custereomatching_tpu_torch.config import StereoConfig, config_from_jax


@pytest.mark.parametrize("bad", [
    dict(kernel_size=4),
    dict(kernel_size=-3),
    dict(kernel_size=0),
    dict(num_disparities=-1),
    dict(precision="float64"),
    dict(pipeline_blocks=(32,)),
    dict(pipeline_blocks=(32, 0)),
    dict(trainable_bwd_block_rows=0),
    dict(trainable_bwd_block_rows=1.5),
])
def test_validation_matches_jax(bad):
    with pytest.raises(ValueError):
        JaxStereoConfig(**bad)
    with pytest.raises(ValueError):
        StereoConfig(**bad)


def test_fields_and_defaults_match_jax():
    jax_fields = {f.name: f.default for f in dataclasses.fields(
        JaxStereoConfig)}
    port_fields = {f.name: f.default for f in dataclasses.fields(
        StereoConfig)}
    assert jax_fields == port_fields


@pytest.mark.parametrize("jax_backend,port_backend", [
    ("auto", "auto"), ("xla", "torch"), ("pallas_interpret", "torch"),
    ("pallas", "cuda"),
])
def test_config_from_jax(jax_backend, port_backend):
    jcfg = JaxStereoConfig(kernel_size=7, num_disparities=12,
                           softargmax_beta=40.0, cost_threshold=0.5,
                           pipeline_blocks=[16, 8], backend=jax_backend)
    cfg = config_from_jax(dataclasses.asdict(jcfg))
    assert cfg.backend == port_backend
    assert cfg.pipeline_blocks == (16, 8)
    assert (cfg.kernel_size, cfg.num_disparities, cfg.softargmax_beta,
            cfg.cost_threshold) == (7, 12, 40.0, 0.5)
    assert cfg.volume_shape(5, 9) == jcfg.volume_shape(5, 9)
    assert cfg.pad == jcfg.pad


def test_backend_resolution():
    cpu = torch.device("cpu")
    assert StereoConfig().resolved_backend(cpu) == "torch"
    assert StereoConfig().resolved_backend(torch.device("cuda")) == "cuda"
    assert StereoConfig(backend="torch").resolved_backend(cpu) == "torch"
    with pytest.raises(ValueError, match="CUDA tensors"):
        StereoConfig(backend="cuda").resolved_backend(cpu)
    with pytest.raises(ValueError):
        StereoConfig(backend="xla")


def test_port_imports_no_jax():
    code = ("import sys, custereomatching_tpu_torch, "
            "custereomatching_tpu_torch.data; "
            "import custereomatching_tpu_torch.models.engine; "
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'custereomatching_tpu.'))"
            " or m == 'custereomatching_tpu'); "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
