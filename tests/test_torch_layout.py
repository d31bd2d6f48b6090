"""PyTorch port: the layout conversions K9a / K9b (``ops/layout.py``) held
against the JAX package's ``plane_major_to_parity`` and
``parity_to_plane_major`` (interpret mode).  The JAX kernels crop or fill
the TPU's padded ``[ndt, h_pad, wo]`` extents; the port's volumes are
exact, so its results are compared with the JAX ones over the real
planes, rows and columns, bit for bit.  K9a's block geometry
(``csrc/layout.cu``) is mirrored in ``utils/kernel_model.py``; its
index walk is replayed here in numpy."""

import re
from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from custereomatching_tpu.ops.pallas_layout import (
    parity_to_plane_major as jax_to_plane_major,
    plane_major_to_parity as jax_to_parity,
)
from custereomatching_tpu_torch.ops import _build
from custereomatching_tpu_torch.ops.layout import (
    parity_to_plane_major,
    plane_major_to_parity,
)
from custereomatching_tpu_torch.utils import kernel_model as km
from custereomatching_tpu_torch.utils.profiling import COUNTS

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
    before = COUNTS.copy()
    got = plane_major_to_parity(torch.from_numpy(vol))
    assert COUNTS - before == Counter(
        {"plain.plane_major_to_parity_reference": 1})
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
    before = COUNTS.copy()
    got = parity_to_plane_major(torch.from_numpy(g)[None])
    assert COUNTS - before == Counter(
        {"plain.parity_to_plane_major_reference": 1})
    assert got.shape == (1, D + 1, H, W) and got.is_contiguous()
    np.testing.assert_array_equal(got[0].numpy(), want[:D + 1, :H, :W])
    # The JAX padding the port has no counterpart of is zeros.
    assert not want[D + 1:].any() and not want[:, H:].any()
    assert not want[:, :, W:].any()


def test_layout_round_trip_and_checks():
    vol = torch.rand(2, 5, 7, 9)
    before = COUNTS.copy()
    assert torch.equal(parity_to_plane_major(plane_major_to_parity(vol)), vol)
    assert COUNTS - before == Counter(                # plain on the CPU
        {"plain.plane_major_to_parity_reference": 1,
         "plain.parity_to_plane_major_reference": 1})
    with pytest.raises(ValueError, match="float32"):
        plane_major_to_parity(vol.double())
    with pytest.raises(ValueError, match="3-d or 4-d"):
        parity_to_plane_major(torch.zeros(4, 5))


def test_k9a_geometry_mirrors_the_source():
    """K9a's constants are csrc/layout.cu's; its planes go in near-equal
    chunks of at most PARITY_CHUNK (one chunk at KITTI's 193; eight of
    226 at D = 1800, sixteen of 251 at D = 4000), each chunk's rows at an
    odd stride, so a warp's 32 pixels of one plane hit 32 banks; with one
    chunk a block's output span, PARITY_PIXELS (D+1) floats from
    c0 (D+1), starts 256-byte aligned; every block fits 48 KB or the
    227 KB it may opt into."""
    text = (_build.CSRC / "layout.cu").read_text()
    consts = {n: int(re.search(rf"constexpr int {n} = (\d+);", text)[1])
              for n in ("kParityPixels", "kParityThreads", "kParityChunk")}
    assert (consts["kParityPixels"], consts["kParityThreads"],
            consts["kParityChunk"]) == (km.PARITY_PIXELS, km.PARITY_THREADS,
                                        km.PARITY_CHUNK)
    assert "launch_to_parity(vol, out, B, planes, pixels," in text
    assert "launch_transpose(g, out, B, pixels, planes," in text
    assert km.parity_chunks(193) == (1, 193, 193)
    assert km.parity_block_floats(192) == 64 * 193 == 12352
    assert km.parity_chunks(1801) == (8, 226, 227)
    assert km.parity_chunks(4001) == (16, 251, 251)
    for R in list(range(1, 600)) + [1801, 4001]:
        chunks, planes, stride = km.parity_chunks(R)
        assert planes <= km.PARITY_CHUNK and stride % 2 == 1
        assert (chunks - 1) * planes < R <= chunks * planes
        assert km.PARITY_PIXELS * stride * 4 <= 232448
        if chunks == 1:
            assert (km.PARITY_PIXELS * R * 4) % 256 == 0


def _to_parity_walk(vol: np.ndarray) -> np.ndarray:
    """K9a's index walk (``to_parity_kernel``) in numpy: each block's
    staged rows filled by its read loop, then written by its warps, at the
    source's strides."""
    B, R, H, W = vol.shape
    C = H * W
    src = vol.reshape(B, R * C)
    out = np.full(B * C * R, np.nan, np.float32)
    chunks, planes, stride = km.parity_chunks(R)
    runs = -(-C // km.PARITY_PIXELS)
    per_pass = km.PARITY_THREADS // km.PARITY_PIXELS
    for b in range(B):
        for block in range(runs * chunks):
            run, chunk = divmod(block, chunks)
            c0, r0 = run * km.PARITY_PIXELS, chunk * planes
            rn, cn = min(planes, R - r0), min(km.PARITY_PIXELS, C - c0)
            stage = np.full(km.PARITY_PIXELS * stride, np.nan, np.float32)
            for t in range(km.PARITY_THREADS):
                c = t % km.PARITY_PIXELS
                if c >= cn:
                    continue
                for r in range(t // km.PARITY_PIXELS, rn, per_pass):
                    stage[c * stride + r] = src[b, (r0 + r) * C + c0 + c]
            for p in range(cn):
                dst = b * R * C + (c0 + p) * R + r0
                out[dst:dst + rn] = stage[p * stride:p * stride + rn]
    return out.reshape(B, H, W, R)


@pytest.mark.parametrize("shape", [(1, 193, 3, 30), (2, 7, 5, 13),
                                   (1, 1, 2, 70), (1, 300, 1, 66),
                                   (2, 257, 1, 5)])
def test_k9a_walk_is_the_transpose(shape):
    """K9a's walk writes every output element once, from its input
    element: one chunk (R = 193, 7, 1) and several (300, 257), pixel runs
    whole and ragged (H W not a multiple of 64, nor of 4), two frames."""
    vol = np.random.default_rng(sum(shape)).random(shape, dtype=np.float32)
    np.testing.assert_array_equal(_to_parity_walk(vol),
                                  np.transpose(vol, (0, 2, 3, 1)))
