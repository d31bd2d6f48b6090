"""PyTorch port: config parity with the JAX package, backend resolution,
and the port's independence from jax."""

import dataclasses
import subprocess
import sys

import pytest
import torch

from custereomatching_tpu.config import MeshConfig as JaxMeshConfig
from custereomatching_tpu.config import StereoConfig as JaxStereoConfig
from custereomatching_tpu_torch.config import (
    MeshConfig,
    StereoConfig,
    config_from_jax,
)


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


@pytest.mark.parametrize("data,space", [(1, 1), (2, 1), (1, 4), (2, 2)])
def test_mesh_config_from_jax(data, space):
    """A JAX MeshConfig's fields give the port's MeshConfig, field for
    field, with the same shape and device count."""
    jcfg = JaxMeshConfig(data=data, space=space)
    cfg = config_from_jax(dataclasses.asdict(jcfg))
    assert isinstance(cfg, MeshConfig)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert (cfg.shape, cfg.num_devices, cfg.axis_names) == (
        jcfg.shape, jcfg.num_devices, jcfg.axis_names)
    assert ({f.name: f.default for f in dataclasses.fields(MeshConfig)}
            == {f.name: f.default for f in dataclasses.fields(
                JaxMeshConfig)})


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
            "import custereomatching_tpu_torch.models.engine, "
            "custereomatching_tpu_torch.models.optimize, "
            "custereomatching_tpu_torch.utils.metrics, "
            "custereomatching_tpu_torch.examples.train, "
            "custereomatching_tpu_torch.examples.scaling, "
            "custereomatching_tpu_torch.examples.pipeline_stages, "
            "custereomatching_tpu_torch.parallel.pipeline, "
            "custereomatching_tpu_torch.scripts.device_profile, "
            "custereomatching_tpu_torch.native, "
            "custereomatching_tpu_torch.data.io, "
            "custereomatching_tpu_torch.data.kitti, "
            "custereomatching_tpu_torch.ops.golden, "
            "custereomatching_tpu_torch.examples.real_capture, "
            "custereomatching_tpu_torch.examples.kitti_eval, "
            "custereomatching_tpu_torch.examples.serve, "
            "custereomatching_tpu_torch.examples.video_depth, "
            "custereomatching_tpu_torch.examples.demo; "
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'custereomatching_tpu.'))"
            " or m == 'custereomatching_tpu'); "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


# Names of the JAX package's top level the port leaves out, each with its
# reason.  None: the port exports every one.
JAX_ONLY = {}


def test_top_level_covers_jax():
    """Every name of the JAX package's top-level ``__all__`` is in the
    port's (a submodule name: the port has that submodule), apart from
    ``JAX_ONLY``; and ``ops.golden`` is exported as in JAX."""
    import importlib
    import types

    import custereomatching_tpu as jax_pkg
    import custereomatching_tpu_torch as pkg

    missing = []
    for name in jax_pkg.__all__:
        if name in JAX_ONLY:
            continue
        if isinstance(getattr(jax_pkg, name), types.ModuleType):
            importlib.import_module(f"custereomatching_tpu_torch.{name}")
        elif name not in pkg.__all__ or not hasattr(pkg, name):
            missing.append(name)
    assert not missing, f"JAX top-level names the port lacks: {missing}"
    from custereomatching_tpu_torch import ops

    assert "golden" in ops.__all__ and ops.golden.__name__ == (
        "custereomatching_tpu_torch.ops.golden")
