"""PyTorch port: the plain banded ZNCC volume and the K1 wrapper's CPU
path, held against the JAX package (Pallas kernel in interpret mode, the
XLA op, and its box filter)."""

from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from custereomatching_tpu.ops import zncc as jax_zncc
from custereomatching_tpu.ops.pallas_zncc import pallas_cost_volume_banded
from custereomatching_tpu_torch.ops import _build, stereo_matching
from custereomatching_tpu_torch.ops.cuda_zncc import cost_volume_banded_cuda
from custereomatching_tpu_torch.ops.zncc import box2d, forward_banded
from custereomatching_tpu_torch.utils.profiling import COUNTS


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
    """The CPU op is differentiable in the camera only (the projector gets
    no gradient), and its camera gradient is the JAX op's."""
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
    """The all-pairs op that was once missing: ``num_disparities=None``
    gives the JAX XLA op's ``[H, W, W]`` volume (forward tolerance)."""
    cam, proj = _pair(4, 6, 8)
    want = np.asarray(jax_zncc.stereo_matching(jnp.asarray(cam),
                                               jnp.asarray(proj), None, 3))
    got = stereo_matching(torch.from_numpy(cam), torch.from_numpy(proj), None,
                          3)
    assert got.shape == (6, 8, 8)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


def test_kernel_wrapper_cpu_takes_plain_version():
    B, H, W, D, K = 2, 9, 21, 3, 3
    cam, proj = _pair(5, B, H, W)
    cam_t, proj_t = torch.from_numpy(cam), torch.from_numpy(proj)
    before = COUNTS.copy()
    got = cost_volume_banded_cuda(cam_t, proj_t, D, K)
    assert COUNTS - before == Counter({"plain.forward_banded": 1})
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


def test_library_name_tracks_sources_and_flags(monkeypatch):
    lib = _build.library_path()
    assert lib.parent == _build.BUILD_DIR
    assert {s.name for s in _build.sources()} >= {
        "common.cuh", "camera_grad.cuh", "zncc_banded.cu",
        "zncc_banded_bwd.cu", "fused_pipeline.cu", "fused_pipeline_bwd.cu",
        "zncc_banded_proj_bwd.cu", "zncc_allpairs.cu"}
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
