"""PyTorch port: pipeline parallelism over disparity-range stages
(``parallel/pipeline.py``), held against the JAX package.

The counterpart of tests/test_pipeline_parallel.py, case by case and at
its shapes and tolerances: the chunk states merged on one process, the
merge's tie rule, the stage pipeline at S = 2 and 4 on spawned gloo ranks
(one spawn of 4 ranks) against JAX's ``pipelined_video_maps`` on its
virtual CPU devices, the tiling check, the refusal of an NCCL group bound
to its card, and the stage op's counted cost.
"""

import concurrent.futures

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from custereomatching_tpu.config import StereoConfig as JaxStereoConfig
from custereomatching_tpu.models import StereoMatcher as JaxStereoMatcher
from custereomatching_tpu.parallel import pipeline as jax_pipeline
from custereomatching_tpu_torch.config import StereoConfig
from custereomatching_tpu_torch.models import StereoMatcher
from custereomatching_tpu_torch.parallel import spawn_ranks
from custereomatching_tpu_torch.parallel.pipeline import (
    HeadState,
    chunk_state,
    empty_state,
    finalize_state,
    merge_states,
    shift_right,
)
from custereomatching_tpu_torch.utils import kernel_model as km
from tests import torch_parallel_ranks as ranks

BACKENDS = ["xla", "pallas_interpret"]


def _video(T=5, H=20, W=36, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(size=(T, H, W)).astype(np.float32),
            rng.uniform(size=(T, H, W)).astype(np.float32))


CAMS, PROJS = _video(T=5)


@pytest.fixture(scope="module")
def runs():
    """The 4 ranks' pipelines at S = 2 and 4 and JAX's, for each backend,
    computed together."""
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        torch_runs = pool.submit(spawn_ranks, ranks.pipeline_suite, 4,
                                 (CAMS, PROJS, 7, 5))
        ref = {}
        for S in (2, 4):
            for backend in BACKENDS:
                cfg = JaxStereoConfig(kernel_size=5, num_disparities=7,
                                      backend=backend)
                got = jax_pipeline.pipelined_video_maps(
                    jnp.asarray(CAMS), jnp.asarray(PROJS), cfg,
                    jax_pipeline.stage_mesh(S))
                ref[S, backend] = [np.asarray(m) for m in got]
        return torch_runs.result(), ref


def _assert_maps(got, want, soft_rtol=1e-4, soft_atol=1e-5):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=soft_rtol,
                               atol=soft_atol)
    np.testing.assert_allclose(got[2], want[2])


@pytest.mark.parametrize("backend", BACKENDS)
def test_chunk_merge_equals_full_range(backend):
    """Merging per-chunk head states == JAX's merged chunks and the
    full-range head (no mesh)."""
    cam, proj = CAMS[0], PROJS[0]
    D, k, S = 7, 5, 4
    chunk = (D + 1) // S
    jcfg = JaxStereoConfig(kernel_size=k, num_disparities=D, backend=backend)
    cfg = StereoConfig(kernel_size=k, num_disparities=D)
    state = empty_state(cam.shape)
    jstate = jax_pipeline.empty_state(cam.shape)
    for s in range(S):
        state = merge_states(state, chunk_state(
            torch.from_numpy(cam), torch.from_numpy(proj), s * chunk, chunk,
            cfg))
        jstate = jax_pipeline.merge_states(jstate, jax_pipeline.chunk_state(
            jnp.asarray(cam), jnp.asarray(proj), s * chunk, chunk, jcfg))
    got = finalize_state(state, cfg)
    want = jax_pipeline.finalize_state(jstate, jcfg)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5)
    np.testing.assert_array_equal(got.disparity.numpy(),
                                  np.asarray(want.disparity))
    full = JaxStereoMatcher(JaxStereoConfig(
        kernel_size=k, num_disparities=D, backend="xla"))(
            jnp.asarray(cam[None]), jnp.asarray(proj[None]))
    np.testing.assert_array_equal(got.disparity.numpy(),
                                  np.asarray(full.disparity[0]))
    np.testing.assert_allclose(got.soft_disparity.numpy(),
                               np.asarray(full.soft_disparity[0]),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got.confidence.numpy(),
                               np.asarray(full.confidence[0]),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("off", [0, 3, 9, 10, 14])
def test_shift_right_matches_jax_past_the_width(off):
    """The projector shift of a stage, at offsets up to past the image's
    width, where every column reads the zero fill as in JAX's."""
    img = np.random.default_rng(off).uniform(size=(3, 10)).astype(np.float32)
    np.testing.assert_array_equal(
        shift_right(torch.from_numpy(img), off).numpy(),
        np.asarray(jax_pipeline._shift_right(jnp.asarray(img), off)))


def test_chunk_state_matches_jax_at_an_offset_past_the_width():
    """A chunk whose planes all lie past the padded image (JAX's
    ``chunk_state`` takes any offset): every projector window reads
    zeros."""
    cam, proj = CAMS[1], PROJS[1]
    D, k, chunk, off = 7, 5, 2, 50
    got = chunk_state(torch.from_numpy(cam), torch.from_numpy(proj), off,
                      chunk, StereoConfig(kernel_size=k, num_disparities=D))
    want = jax_pipeline.chunk_state(
        jnp.asarray(cam), jnp.asarray(proj), off, chunk,
        JaxStereoConfig(kernel_size=k, num_disparities=D, backend="xla"))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5)


def test_merge_tie_breaks_to_lower_disparity():
    """First-max semantics: equal maxima resolve to the LOW chunk, as in
    JAX's merge."""
    shape = (2, 2)

    def states(lib, full, ones):
        low = HeadState(m=full(shape, 5.0), am=full(shape, 3.0),
                        s=ones(shape), t=full(shape, 3.0))
        high = HeadState(m=full(shape, 5.0), am=full(shape, 9.0),
                         s=ones(shape), t=full(shape, 9.0))
        return lib.merge_states(low, high)

    merged = states(__import__(merge_states.__module__, fromlist=["_"]),
                    torch.full, torch.ones)
    jmerged = states(jax_pipeline, jnp.full, jnp.ones)
    np.testing.assert_array_equal(merged.am.numpy(), 3.0)
    np.testing.assert_allclose(merged.s.numpy(), 2.0)
    for g, w in zip(merged, jmerged):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("S,backend", [(2, "xla"), (4, "xla"),
                                       (2, "pallas_interpret"),
                                       (4, "pallas_interpret")])
def test_pipelined_video_matches_single_device(runs, S, backend):
    """The stage pipeline on S gloo ranks against JAX's on S virtual
    devices and the single-device matchers (torch's bit for bit in the
    hard maps)."""
    results, ref = runs
    got = results[0][S]
    for r in results[1:S]:                       # every stage returns it
        for a, b in zip(r[S], got):
            np.testing.assert_array_equal(a, b)
    _assert_maps(got, ref[S, backend])
    cfg = StereoConfig(kernel_size=5, num_disparities=7)
    want = StereoMatcher(cfg)(torch.from_numpy(CAMS),
                              torch.from_numpy(PROJS))
    _assert_maps(got, [m.numpy() for m in (want.disparity,
                                           want.soft_disparity, want.mask)])


def test_pipelined_requires_exact_tiling(runs):
    results, _ = runs
    assert "divide evenly" in results[0]["tiling"]


@pytest.mark.parametrize("backend,bound,raises", [
    ("nccl", torch.device("cuda", 0), True), ("nccl", None, False),
    ("gloo", torch.device("cpu"), False)])
def test_stage_handoff_needs_a_lazy_nccl_group(monkeypatch, backend, bound,
                                               raises):
    """The stage hand-off refuses an NCCL group bound to its card (where
    its sends hung) and takes a lazily initialised one or gloo."""
    from custereomatching_tpu_torch.parallel import pipeline

    class Group:
        bound_device_id = bound

    monkeypatch.setattr(pipeline.dist, "get_backend", lambda group: backend)
    if raises:
        with pytest.raises(RuntimeError, match="without device_id"):
            pipeline._require_lazy_nccl(Group())
    else:
        pipeline._require_lazy_nccl(Group())


@pytest.mark.parametrize("S,beta", [(2, 50.0), (4, 50.0), (4, 80.0)])
def test_stage_op_cost_counts_k3m_and_the_glue(S, beta):
    """stage_op_cost = K3m at chunk - 1 disparities over the padded width,
    plus one pass a glue op (and the rescale under the unnormalized
    head)."""
    H, W, D, k = 384, 1280, 191, 15
    chunk = (D + 1) // S
    Wp = W + (D + 1) - chunk
    c = km.stage_op_cost(H, W, D, S, k, beta)
    k3m = km.fused_forward_cost(H, Wp, chunk - 1, k, residuals=True)
    px = H * W
    unnorm = beta + np.log(chunk * max(chunk - 1, 1)) <= 85.0
    assert unnorm == (beta == 50.0)
    assert c["madd"] == k3m["madd"] + 4 * px + (3 * px if unnorm else 0)
    assert c["exp"] == k3m["exp"] + (px if unnorm else 0)
    for cls in ("smem", "rsqrt", "boxadd"):
        assert c[cls] == k3m[cls]
    r = 2 * px + H * Wp + 5 * px + (6 * px if unnorm else 0)
    w = 3 * H * Wp + 4 * px + (4 * px if unnorm else 0)
    assert c.bytes_r == k3m.bytes_r + 4 * r
    assert c.bytes_w == k3m.bytes_w + 4 * w
    assert c.bytes == c.bytes_r + c.bytes_w
