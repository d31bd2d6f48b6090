"""PyTorch port: the plain banded ZNCC volume and the K1 wrapper's CPU
path, held against the JAX package (Pallas kernel in interpret mode, the
XLA op, and its box filter)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from custereomatching_tpu.ops import zncc as jax_zncc
from custereomatching_tpu.ops.pallas_zncc import pallas_cost_volume_banded
from custereomatching_tpu_torch.ops import (
    _build,
    _CudaStereoMatching,
    stereo_matching,
)
from custereomatching_tpu_torch.ops.cuda_zncc import cost_volume_banded_cuda
from custereomatching_tpu_torch.ops.zncc import box2d, forward_banded


def _pair(seed, *shape):
    rng = np.random.default_rng(seed)
    return (rng.random(shape, dtype=np.float32),
            rng.random(shape, dtype=np.float32))


@pytest.mark.parametrize("shape", [
    # (H, W, D, k, block_rows, block_disparities) of test_pallas_zncc.py
    (24, 150, 10, 5, 8, 4),
    (17, 100, 3, 3, 8, 104),
    (12, 260, 140, 7, 16, 64),
    (9, 40, 0, 5, 8, 8),
])
def test_forward_banded_matches_pallas_interpret(shape):
    H, W, D, K, hb, dtb = shape
    cam, proj = _pair(0, H, W)
    want = np.asarray(pallas_cost_volume_banded(
        jnp.asarray(cam), jnp.asarray(proj), D, K, block_rows=hb,
        block_disparities=dtb, interpret=True))
    got = forward_banded(torch.from_numpy(cam)[None],
                         torch.from_numpy(proj)[None], D, K)[0]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("k,shape", [(3, (7, 11)), (5, (9, 6, 4)),
                                     (1, (4, 5))])
def test_box2d_matches_jax(k, shape):
    x = np.random.default_rng(k).standard_normal(shape).astype(np.float32)
    want = np.asarray(jax_zncc.box2d(jnp.asarray(x), k))
    got = box2d(torch.from_numpy(x), k).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("k", [1, 3])
def test_public_op_matches_xla_op(k):
    """k = 1 is accepted on the plain path, as in the JAX XLA op."""
    H, W, D = 10, 30, 4
    cam, proj = _pair(1, H, W)
    want = np.asarray(jax_zncc.stereo_matching(
        jnp.asarray(cam), jnp.asarray(proj), D, k))
    got = stereo_matching(torch.from_numpy(cam), torch.from_numpy(proj), D,
                          k)
    assert got.shape == (H, W, D + 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    batched = stereo_matching(torch.from_numpy(cam)[None],
                              torch.from_numpy(proj)[None], D, k)
    torch.testing.assert_close(batched[0], got, rtol=0, atol=0)


def test_public_op_camera_gradient_matches_jax():
    """The CPU op is differentiable in the camera only (projector
    detached), and its camera gradient is the JAX op's."""
    H, W, D, K = 12, 40, 5, 5
    cam, proj = _pair(2, H, W)
    g = np.random.default_rng(3).standard_normal(
        (H, W, D + 1)).astype(np.float32)

    want = np.asarray(jax.grad(lambda c: jnp.sum(jax_zncc.stereo_matching(
        c, jnp.asarray(proj), D, K) * g))(jnp.asarray(cam)))

    cam_t = torch.from_numpy(cam).requires_grad_(True)
    proj_t = torch.from_numpy(proj).requires_grad_(True)
    (stereo_matching(cam_t, proj_t, D, K) * torch.from_numpy(g)).sum() \
        .backward()
    np.testing.assert_allclose(cam_t.grad.numpy(), want, rtol=1e-3,
                               atol=1e-4)
    assert proj_t.grad is None


def test_allpairs_not_ported():
    cam, proj = _pair(4, 6, 8)
    with pytest.raises(NotImplementedError, match="ROADMAP item 9"):
        stereo_matching(torch.from_numpy(cam), torch.from_numpy(proj), None,
                        3)


def test_kernel_wrapper_cpu_takes_plain_version():
    B, H, W, D, K = 2, 9, 21, 3, 3
    cam, proj = _pair(5, B, H, W)
    cam_t, proj_t = torch.from_numpy(cam), torch.from_numpy(proj)
    launches = cost_volume_banded_cuda.launches
    calls = forward_banded.calls
    got = cost_volume_banded_cuda(cam_t, proj_t, D, K)
    assert forward_banded.calls == calls + 1
    assert cost_volume_banded_cuda.launches == launches
    torch.testing.assert_close(got, forward_banded(cam_t, proj_t, D, K),
                               rtol=0, atol=0)


@pytest.mark.parametrize("bad", [
    dict(kernel_size=1),                      # the kernel path needs k >= 3
    dict(kernel_size=4),
    dict(num_disparities=-1),
    dict(dtype=torch.float64),
    dict(shape=(5, 7)),                       # the wrapper takes [B, H, W]
])
def test_kernel_wrapper_rejects(bad):
    shape = bad.get("shape", (1, 5, 7))
    x = torch.zeros(shape, dtype=bad.get("dtype", torch.float32))
    with pytest.raises(ValueError):
        cost_volume_banded_cuda(x, x, bad.get("num_disparities", 2),
                                bad.get("kernel_size", 3))


def test_cuda_op_backward_not_ported():
    with pytest.raises(NotImplementedError, match="training slice"):
        _CudaStereoMatching.backward(None, torch.zeros(1))


def test_library_name_tracks_sources_and_flags(monkeypatch):
    lib = _build.library_path()
    assert lib.parent == _build.BUILD_DIR
    assert {s.name for s in _build.sources()} >= {
        "common.cuh", "zncc_banded.cu", "fused_pipeline.cu"}
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-G",))
    assert _build.library_path() != lib


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc()


def test_failed_build_raises_with_compiler_output(monkeypatch, tmp_path):
    """A refused build raises with nvcc's output; nothing falls back."""
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: no sm_90a here' >&2\nexit 2\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    with pytest.raises(RuntimeError, match="no sm_90a here"):
        _build.build()
    assert not list((tmp_path / "kernels").glob("*.so"))
