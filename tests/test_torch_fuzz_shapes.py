"""PyTorch port: randomized-shape sweep, the counterpart of
``tests/test_fuzz_shapes.py``.

Fixed shape lists miss margins.  ``utils/shape_sweep.py`` draws seeded
``(B, H, W, D, k)`` cases (the same every run; ``chip_smoke.py``'s
``fuzz`` phase holds the kernels to their plain versions on the card at
the same cases): the JAX sweep's own space, and the margins the plain op
takes that no fixed shape has (D >= W, D = 0, H < k, all-pairs with
k // 2 > W, batches of 2 and 3, k = 1).  Each case runs through the
port on the CPU and through the JAX package on the same numpy inputs
(the JAX ops take ``[H, W]`` pairs, so a batch runs frame by frame):

a. the volume, banded or all-pairs, against JAX's ``zncc.stereo_matching``
   (rtol 1e-4 / atol 1e-5) and the float64 brute force
   ``tests/np_oracle.py::zncc_brute`` (rtol 5e-4 / atol 5e-5, the JAX
   sweep's); at k = 1 every entry within rtol 1e-4 of eps / sqrt(eps), as
   ``tests/test_zncc_op.py::test_kernel_size_one`` holds it;
b. the camera gradient under a seeded normal cotangent against
   ``jax.grad`` of the JAX op and against the golden oracle's
   ``zncc_camera_grad``;
c. both gradients of ``stereo_matching_with_proj_grad`` against
   ``jax.grad`` of JAX's and against the golden oracle's camera and
   projector gradients;
d. ``StereoMatcher.forward``, ``disparity_maps`` and
   ``trainable_disparity_maps``, with and without ``grad_projector``,
   against JAX's ``StereoMatcher(backend="xla")``: hard disparity equal
   but where the mask flips or the top two costs lie within the forward
   tolerance, mask equal but where the confidence lies within 1e-5 of the
   threshold, soft disparity (where the masks agree) and confidence rtol
   1e-3 / atol 1e-3 (the JAX pipeline sweep's), and the gradients of a
   seeded weighted sum of soft disparity and confidence (weights zero at
   those flips and ties, where the loss is not smooth);
e. the plain fused pipeline against JAX's ``pallas_stereo_pipeline`` in
   interpret mode, at three cases, as ``test_fused_pipeline_random_shapes``;
f. refusals on ``[H, W]`` pairs: where the JAX op raises the port raises
   ``ValueError``, and where it returns the port returns its values.

The golden oracle of b and c is the port's copy (``ops/golden.py``, a
direct patch sum under torch autograd), which
``tests/test_torch_golden.py`` holds to JAX's: JAX's own compiles k^2
slices and their transposes for each shape, 1-14 s a case here (k = 3 to
29), several times this file's whole budget.

Gradients (b-d) are scaled by the largest |expected| entry and held at
rtol 1e-3 / atol 5e-5, the JAX sweep's.  k = 1 is left out of b-e, as
the JAX sweep leaves it out.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from custereomatching_tpu.config import StereoConfig as JaxStereoConfig
from custereomatching_tpu.models import StereoMatcher as JaxStereoMatcher
from custereomatching_tpu.ops import zncc as jax_zncc
from custereomatching_tpu.ops.pallas_pipeline import pallas_stereo_pipeline
from custereomatching_tpu_torch import StereoConfig, StereoMatcher
from custereomatching_tpu_torch.ops import (
    golden,
    stereo_matching,
    stereo_matching_with_proj_grad,
    stereo_pipeline_reference,
)
from custereomatching_tpu_torch.ops.zncc import EPSILON as EPS
from custereomatching_tpu_torch.utils.shape_sweep import (
    case_cotangent,
    case_pair,
    sweep_cases,
)
from tests.np_oracle import zncc_brute

CASES = sweep_cases()
GRAD_CASES = [c for c in CASES if c.k > 1]
PIPELINE_CASES = [c for c in CASES if c.tag == "jax"][:3]

FWD_TOL = dict(rtol=1e-4, atol=1e-5)         # tests/test_pallas_zncc.py:47
ORACLE_TOL = dict(rtol=5e-4, atol=5e-5)      # tests/test_fuzz_shapes.py:45
GRAD_TOL = dict(rtol=1e-3, atol=5e-5)        # tests/test_fuzz_shapes.py:68
MAP_TOL = dict(rtol=1e-3, atol=1e-3)         # tests/test_fuzz_shapes.py:107
THRESHOLD, BETA = 0.6, 50.0


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _scaled_close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    scale = np.abs(want).max() + 1e-6
    np.testing.assert_allclose(got / scale, want / scale, **GRAD_TOL,
                               err_msg=what)


@functools.partial(jax.jit, static_argnums=(3, 4))
def _jax_camera_grad(cam, proj, g, D, k):
    return jax.grad(lambda c: jnp.sum(
        jax_zncc.stereo_matching(c, proj, D, k) * g))(cam)


@functools.partial(jax.jit, static_argnums=(3, 4))
def _jax_both_grads(cam, proj, g, D, k):
    return jax.grad(lambda c, p: jnp.sum(
        jax_zncc.stereo_matching_with_proj_grad(c, p, D, k) * g),
        argnums=(0, 1))(cam, proj)


@pytest.mark.parametrize("case", CASES, ids=str)
def test_volume_matches_jax_and_oracle(case):
    cam, proj = case_pair(case)
    got = stereo_matching(*_t(cam, proj), case.D, case.k).numpy()
    assert got.shape == (case.B, case.H, case.W, case.planes)
    single = stereo_matching(*_t(cam[0], proj[0]), case.D, case.k)
    np.testing.assert_array_equal(single.numpy(), got[0])
    if case.k == 1:
        np.testing.assert_allclose(got, EPS / np.sqrt(EPS), rtol=1e-4)
        return
    for b in range(case.B):
        want = jax_zncc.stereo_matching(jnp.asarray(cam[b]),
                                        jnp.asarray(proj[b]), case.D, case.k)
        np.testing.assert_allclose(got[b], np.asarray(want), **FWD_TOL,
                                   err_msg=f"JAX op, frame {b}")
        np.testing.assert_allclose(
            got[b], zncc_brute(cam[b], proj[b], case.k, case.D),
            **ORACLE_TOL, err_msg=f"float64 oracle, frame {b}")


@pytest.mark.parametrize("case", GRAD_CASES, ids=str)
def test_camera_grad_matches_jax_and_golden(case):
    cam, proj = case_pair(case)
    g = case_cotangent(case)
    c, p, gt = _t(cam, proj, g)
    c.requires_grad_(True)
    p.requires_grad_(True)
    (stereo_matching(c, p, case.D, case.k) * gt).sum().backward()
    assert p.grad is None
    for b in range(case.B):
        args = [jnp.asarray(a[b]) for a in (cam, proj, g)]
        _scaled_close(c.grad[b], _jax_camera_grad(*args, case.D, case.k),
                      f"jax.grad, frame {b}")
        _scaled_close(c.grad[b], golden.zncc_camera_grad(
            *_t(cam[b], proj[b], g[b]), case.D, case.k), f"golden, frame {b}")


@pytest.mark.parametrize("case", GRAD_CASES, ids=str)
def test_both_grads_match_jax_and_golden(case):
    cam, proj = case_pair(case)
    g = case_cotangent(case)
    c, p, gt = _t(cam, proj, g)
    c.requires_grad_(True)
    p.requires_grad_(True)
    (stereo_matching_with_proj_grad(c, p, case.D, case.k) * gt).sum() \
        .backward()
    for b in range(case.B):
        args = [jnp.asarray(a[b]) for a in (cam, proj, g)]
        want_c, want_p = _jax_both_grads(*args, case.D, case.k)
        _scaled_close(c.grad[b], want_c, f"camera, jax.grad, frame {b}")
        _scaled_close(p.grad[b], want_p, f"projector, jax.grad, frame {b}")
        frame = _t(cam[b], proj[b], g[b])
        _scaled_close(c.grad[b], golden.zncc_camera_grad(
            *frame, case.D, case.k), f"camera, golden, frame {b}")
        _scaled_close(p.grad[b], golden.zncc_projector_grad(
            *frame, case.D, case.k), f"projector, golden, frame {b}")


@functools.partial(jax.jit, static_argnums=(4,))
def _jax_model_paths(cam, proj, ws, wc, cfg):
    """JAX's forward, disparity_maps and trainable_disparity_maps, and the
    gradients of ``sum(ws soft + wc conf)`` through the two differentiable
    ones, in both images."""
    model = JaxStereoMatcher(cfg)

    def loss(fn):
        def weighted(c, p):
            out = fn(c, p)
            return (jnp.sum(ws * out.soft_disparity + wc * out.confidence),
                    out)
        return jax.value_and_grad(weighted, argnums=(0, 1), has_aux=True)

    (_, fwd), fwd_grads = loss(model)(cam, proj)
    (_, train), train_grads = loss(model.trainable_disparity_maps)(cam, proj)
    return fwd, fwd_grads, model.disparity_maps(cam, proj), train, \
        train_grads


def _loss_weights(case, cost):
    """Seeded weights of the soft disparity and the confidence, zero where
    the head is not smooth in the inputs at the forward tolerance: the
    mask's threshold (soft disparity is masked) and top-two ties (the
    confidence's gradient follows the argmax)."""
    rng = np.random.default_rng(case.seed + 2)
    ws, wc = (rng.standard_normal((case.B, case.H, case.W)).astype(
        np.float32) for _ in range(2))
    conf, tie = _conf_and_ties(cost)
    ws[np.abs(conf - THRESHOLD) <= 1e-5] = 0.0
    wc[tie] = 0.0
    return ws, wc


def _conf_and_ties(cost):
    """Per-pixel max of a ``[..., L]`` volume, and where its top two lie
    within the forward tolerance."""
    top = -np.sort(-cost, axis=-1)
    if cost.shape[-1] < 2:
        return top[..., 0], np.zeros(top.shape[:-1], bool)
    return top[..., 0], top[..., 0] - top[..., 1] <= (
        FWD_TOL["atol"] + FWD_TOL["rtol"] * np.abs(top[..., 0]))


def _hold_maps(got, want, cost, what):
    """The port's maps against JAX's (both with ``disparity``,
    ``soft_disparity``, ``mask``, ``confidence``); ``cost`` is JAX's volume."""
    got = {n: getattr(got, n).detach().numpy() for n in
           ("disparity", "soft_disparity", "mask", "confidence")}
    want = {n: np.asarray(getattr(want, n)) for n in got}
    _, tie = _conf_and_ties(cost)
    np.testing.assert_allclose(got["confidence"], want["confidence"],
                               **MAP_TOL, err_msg=f"{what}: confidence")
    flips = got["mask"] != want["mask"]
    assert (np.abs(want["confidence"] - THRESHOLD)[flips] <= 1e-5).all(), \
        f"{what}: mask flipped away from the threshold"
    differ = got["disparity"] != want["disparity"]
    assert not (differ & ~flips & ~tie).any(), \
        f"{what}: hard disparity off a top-two tie"
    np.testing.assert_allclose(got["soft_disparity"][~flips],
                               want["soft_disparity"][~flips], **MAP_TOL,
                               err_msg=f"{what}: soft disparity")


@pytest.mark.parametrize("grad_projector", [False, True])
@pytest.mark.parametrize("case", GRAD_CASES, ids=str)
def test_model_paths_match_jax(case, grad_projector):
    cam, proj = case_pair(case)
    kw = dict(kernel_size=case.k, num_disparities=case.D,
              grad_projector=grad_projector)
    model = StereoMatcher(StereoConfig(backend="torch", **kw))
    plain = stereo_matching(*_t(cam, proj), case.D, case.k).numpy()
    ws, wc = _loss_weights(case, plain)
    fwd, fwd_grads, maps, train, train_grads = _jax_model_paths(
        jnp.asarray(cam), jnp.asarray(proj), jnp.asarray(ws),
        jnp.asarray(wc), JaxStereoConfig(backend="xla", **kw))
    cost = np.asarray(fwd.cost_volume)
    wst, wct = _t(ws, wc)

    def run(fn, want, want_grads, what):
        c, p = _t(cam, proj)
        c.requires_grad_(True)
        p.requires_grad_(True)
        out = fn(c, p)
        _hold_maps(out, want, cost, what)
        (wst * out.soft_disparity + wct * out.confidence).sum().backward()
        _scaled_close(c.grad, want_grads[0], f"{what}: camera gradient")
        if grad_projector:
            _scaled_close(p.grad, want_grads[1],
                          f"{what}: projector gradient")
        else:
            assert p.grad is None, f"{what}: projector gradient"
        return out

    out = run(model, fwd, fwd_grads, "forward")
    np.testing.assert_allclose(out.cost_volume.detach().numpy(), cost,
                               **FWD_TOL, err_msg="forward: volume")
    run(model.trainable_disparity_maps, train, train_grads,
        "trainable_disparity_maps")
    with torch.no_grad():
        _hold_maps(model.disparity_maps(*_t(cam, proj)), maps, cost,
                   "disparity_maps")


@pytest.mark.parametrize("case", PIPELINE_CASES, ids=str)
def test_plain_pipeline_matches_pallas_interpret(case):
    cam, proj = case_pair(case)
    rng = np.random.default_rng(case.seed + 3)
    hb, dtb = int(rng.choice([8, 16, 24])), int(rng.choice([4, 8, 16]))
    got = stereo_pipeline_reference(*_t(cam, proj), case.D, case.k, EPS,
                                    BETA, THRESHOLD)
    want = pallas_stereo_pipeline(jnp.asarray(cam[0]), jnp.asarray(proj[0]),
                                  case.D, case.k, EPS, BETA, THRESHOLD, hb,
                                  dtb, True)
    want = jax.tree_util.tree_map(lambda x: x[None], want)
    cost = np.asarray(jax_zncc.stereo_matching(
        jnp.asarray(cam[0]), jnp.asarray(proj[0]), case.D, case.k))[None]
    _hold_maps(got, want, cost, f"pipeline (blocks {hb}, {dtb})")


# [H, W] pairs: (camera shape, projector shape, D, k).  The first five the
# JAX op refuses; the rest it takes.
REFUSALS = [((8, 10), (8, 11), 3, 3), ((8, 10), (9, 10), None, 3),
            ((8, 10), (8, 10), 3, 4), ((8, 10), (8, 10), None, 0),
            ((8, 10), (8, 10), 3, -1), ((8, 10), (8, 10), -1, 3)]
ACCEPTED = [((3, 4), (3, 4), 0, 1), ((2, 5), (2, 5), 9, 7),
            ((4, 2), (4, 2), None, 11), ((1, 1), (1, 1), 0, 3),
            ((1, 1), (1, 1), None, 3)]


@pytest.mark.parametrize("shapes", REFUSALS + ACCEPTED, ids=str)
def test_refusals_agree_with_jax(shapes):
    cam_shape, proj_shape, D, k = shapes
    rng = np.random.default_rng(sum(cam_shape) + 10 * k)
    cam = rng.random(cam_shape, dtype=np.float32)
    proj = rng.random(proj_shape, dtype=np.float32)
    try:
        want = np.asarray(jax_zncc.stereo_matching(jnp.asarray(cam),
                                                   jnp.asarray(proj), D, k))
    except ValueError:
        assert shapes in REFUSALS
        with pytest.raises(ValueError):
            stereo_matching(*_t(cam, proj), D, k)
        return
    assert shapes in ACCEPTED
    got = stereo_matching(*_t(cam, proj), D, k).numpy()
    assert got.shape == want.shape
    if k == 1:
        np.testing.assert_allclose(got, EPS / np.sqrt(EPS), rtol=1e-4)
    else:
        np.testing.assert_allclose(got, want, **FWD_TOL)
