"""PyTorch port: the plain fused-pipeline twin and the K3 wrapper's CPU
path, held against the JAX fused Pallas kernel in interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from custereomatching_tpu.ops import pallas_pipeline as jax_pipeline
from custereomatching_tpu_torch.ops.cuda_pipeline import (
    PipelineMaps,
    stereo_pipeline_cuda,
    stereo_pipeline_reference,
    unnormalized_head,
)


@pytest.mark.parametrize("shape", [
    # (H, W, D, k, block_rows, block_disparities, beta)
    (24, 150, 10, 5, 8, 4, 50.0),     # test_pallas_zncc.py shapes
    (16, 100, 37, 7, 16, 16, 50.0),
    (16, 100, 37, 7, 16, 16, 80.0),   # rescaled head: 80 + ln(37*38) > 85
])
def test_reference_matches_fused_pallas_interpret(shape):
    H, W, D, K, hb, dtb, beta = shape
    rng = np.random.default_rng(7)
    cam = rng.random((H, W), dtype=np.float32)
    proj = rng.random((H, W), dtype=np.float32)
    want = jax_pipeline.pallas_stereo_pipeline(
        jnp.asarray(cam), jnp.asarray(proj), D, K, 1e-8, beta, 0.6, hb, dtb,
        True)
    got = stereo_pipeline_reference(torch.from_numpy(cam)[None],
                                    torch.from_numpy(proj)[None], D, K,
                                    1e-8, beta, 0.6)
    np.testing.assert_array_equal(got.disparity[0].numpy(),
                                  np.asarray(want.disparity))
    np.testing.assert_array_equal(got.mask[0].numpy(), np.asarray(want.mask))
    np.testing.assert_allclose(got.confidence[0].numpy(),
                               np.asarray(want.confidence),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.soft_disparity[0].numpy(),
                               np.asarray(want.soft_disparity),
                               rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("beta,D", [(50.0, 192), (50.0, 0), (80.0, 37),
                                    (75.0, 64), (20.0, 1000)])
def test_head_gate_matches_jax(beta, D):
    assert unnormalized_head(beta, D) == jax_pipeline._unnormalized_head(
        beta, D)


def test_pipeline_maps_fields_match_jax():
    assert PipelineMaps._fields == jax_pipeline.PipelineMaps._fields


def test_kernel_wrapper_cpu_takes_plain_version():
    rng = np.random.default_rng(9)
    cam = torch.from_numpy(rng.random((2, 12, 40), dtype=np.float32))
    proj = torch.from_numpy(rng.random((2, 12, 40), dtype=np.float32))
    launches = stereo_pipeline_cuda.launches
    calls = stereo_pipeline_reference.calls
    got = stereo_pipeline_cuda(cam, proj, 5, 5)
    assert stereo_pipeline_reference.calls == calls + 1
    assert stereo_pipeline_cuda.launches == launches
    want = stereo_pipeline_reference(cam, proj, 5, 5)
    for g, w in zip(got, want):
        assert g.shape == (2, 12, 40)
        torch.testing.assert_close(g, w, rtol=0, atol=0)
