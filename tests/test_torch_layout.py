"""PyTorch port: the layout conversions K9a / K9b (``ops/layout.py``) held
against the JAX package's ``plane_major_to_parity`` and
``parity_to_plane_major`` (interpret mode).  The JAX kernels crop or fill
the TPU's padded ``[ndt, h_pad, wo]`` extents; the port's volumes are
exact, so its results are compared with the JAX ones over the real
planes, rows and columns, bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from custereomatching_tpu.ops.pallas_layout import (
    parity_to_plane_major as jax_to_plane_major,
    plane_major_to_parity as jax_to_parity,
)
from custereomatching_tpu_torch.ops.layout import (
    parity_to_plane_major,
    parity_to_plane_major_reference,
    plane_major_to_parity,
    plane_major_to_parity_reference,
)

# tests/test_pallas_layout.py's shapes: (ndt, h_pad, wo, H, W, D).
SHAPES = [
    (16, 48, 256, 37, 130, 10),
    (8, 16, 128, 16, 64, 7),
    (24, 96, 384, 96, 384, 20),
]


@pytest.mark.parametrize("shape", SHAPES)
def test_plane_major_to_parity_matches_jax(shape):
    """Garbage in the JAX padding; the port takes the exact volume."""
    ndt, h_pad, wo, H, W, D = shape
    rng = np.random.default_rng(ndt + H)
    padded = rng.random((ndt, h_pad, wo), dtype=np.float32)
    want = np.asarray(jax_to_parity(jnp.asarray(padded), H, W, D, 16, 256,
                                    True, "mxu"))
    vol = np.ascontiguousarray(padded[:D + 1, :H, :W])
    calls = plane_major_to_parity_reference.calls
    got = plane_major_to_parity(torch.from_numpy(vol))
    assert plane_major_to_parity_reference.calls == calls + 1
    assert got.shape == (H, W, D + 1) and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)
    batched = plane_major_to_parity(torch.from_numpy(np.stack([vol, vol])))
    np.testing.assert_array_equal(batched.numpy(), np.stack([want, want]))


@pytest.mark.parametrize("shape", SHAPES)
def test_parity_to_plane_major_matches_jax(shape):
    ndt, h_pad, wo, H, W, D = shape
    rng = np.random.default_rng(ndt + W)
    g = rng.random((H, W, D + 1), dtype=np.float32)
    want = np.asarray(jax_to_plane_major(jnp.asarray(g), ndt, h_pad, wo, D,
                                         16, 256, True, "mxu"))
    calls = parity_to_plane_major_reference.calls
    got = parity_to_plane_major(torch.from_numpy(g)[None])
    assert parity_to_plane_major_reference.calls == calls + 1
    assert got.shape == (1, D + 1, H, W) and got.is_contiguous()
    np.testing.assert_array_equal(got[0].numpy(), want[:D + 1, :H, :W])
    # The JAX padding the port has no counterpart of is zeros.
    assert not want[D + 1:].any() and not want[:, H:].any()
    assert not want[:, :, W:].any()


def test_layout_round_trip_and_checks():
    vol = torch.rand(2, 5, 7, 9)
    assert torch.equal(parity_to_plane_major(plane_major_to_parity(vol)), vol)
    assert plane_major_to_parity.launches == 0       # plain on the CPU
    with pytest.raises(ValueError, match="float32"):
        plane_major_to_parity(vol.double())
    with pytest.raises(ValueError, match="3-d or 4-d"):
        parity_to_plane_major(torch.zeros(4, 5))
