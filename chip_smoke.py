#!/usr/bin/env python3
"""On-card smoke test of the PyTorch / CUDA port: the serving path, the
training path, the all-pairs path, the projector-gradient path, the
volume-free training path, the plane-major path, the camera VJP
without the cost residual, the bound model's rate probes, the large-k
route, the left-right serving path, the pyramid, the failsafe layer, the
parallel layer, the data layer, the golden oracle, the data-driven
examples, the tile tuner, the rounds kernels at every tile and the
bench.

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and nvcc;
imports nothing of JAX.  Phases, each printing its lines:

1. environment: Python, torch, CUDA and nvcc versions, the card;
2. build: every kernel from ``custereomatching_tpu_torch/csrc``, one nvcc
   per source, in parallel;
3. K1 (banded volume) against its plain PyTorch version on the card, at
   the small shapes, KITTI, k = 3, 31, 47 and 127, and a D whose projector
   tile is staged in chunks (D = 1800 at k = 15, past the first version's
   D <= 1739);
4. K3 (fused pipeline) against its plain version, both head branches,
   also at shapes on the edges of its register blocking (H not a multiple
   of 16, W not of 64, D + 1 not of the planes a round, k = 3 to 27);
5. the serving path, counted (what ``profiling.COUNTS`` gains across
   it): ``entry()``, a batched ``StereoMatcher`` forward and a
   ``StereoEngine`` serving 8 KITTI-size frames; exactly the launches of
   ``PATH_LAUNCHES`` must run, and no plain version;
6. K2 (camera VJP) against the plain closed form, the same random
   cotangent fed to both, at the small shapes, entry()'s shape, KITTI and
   k = 31, 47 and 127 (rounds of 8, 4 and 1 planes; at k = 127 the
   combine filters its three maps one at a time);
7. K3w (training forward): its volume against the plain volume, its four
   maps bit-equal to K3's, its argmax, s and t against the plain head;
   and at beta = 1 its volume bit-equal to K1's on the same pair (K1 is
   the same rounds kernel without the head);
8. K4 (trainable backward) against its plain twin on the same residuals,
   and the whole trainable pipeline (K3w + K4) against its plain twin,
   both head branches, KITTI speckle, the edge shapes of phase 4 and
   k = 31 and 47 (planes a round falling to 4 and 1);
9. the training path, counted: ``entry()``'s soft disparity
   backpropagated to the camera (K1 + K2), then ``optimize_camera`` for 5
   Adam steps at KITTI size (K3w + K4); exactly the launches of
   ``PATH_LAUNCHES`` must run, and no plain version, and the losses must
   be finite and falling; then, outside
   the counted run, entry()'s camera gradient against the plain VJP fed
   the same head cotangent;
10. K8 (all-pairs volume) against its plain version at the JAX suite's
    shapes, a batch, the 330x422 verify shape at k = 3, 15 and 129, a
    width that is no multiple of the block tile and 375x1242 (the wide y
    extent); K8b (its camera VJP) against the plain closed form; K8h and
    K8hb (the volume head and its VJP) against the plain head and its
    autograd, on K8's volume at 330x422, K1's at KITTI and random volumes
    with exact ties (three row tiles, 16-byte loads, a band past one
    tile), the hard map, mask and confidence bit-equal, then both timed
    at 330x422 beside the plain head and their bounds by bytes;
11. K7 (projector VJP) against the plain closed form on the same cost and
    cotangent, at the JAX suite's shapes, a batch, the edge shapes of phase
    4, k = 47 and 93 (the largest k its combine kernel stages the three
    maps together at) and KITTI;
12. the all-pairs path, counted: the default ``StereoMatcher``
    (all-pairs) forward, head and backward of a mean soft-disparity loss
    at 330x422, k=15; K8, K8h, K8hb and K8b must run once and the plain
    forward never, and the camera gradient must match the plain node's
    (plain volume and plain VJP);
13. the projector-gradient path, counted: the banded KITTI model
    with ``grad_projector=True``, forward, head and backward; K1, K2, K7,
    K8h and K8hb must run once each, and both gradients must match the plain
    closed forms fed the same head cotangent;
14. K6 (camera VJP recomputing the cost) through both entries (the
    plane-major cotangent, and the parity one staged by K9b) against the
    plain closed form on the same cotangent, at the small shapes, the
    edge shapes of phase 4, k = 31 and 47, a D whose projector tile is
    staged in chunks, and KITTI, and bit-equal to K2 (with the cost
    residual) at the last two;
15. K9a and K9b (layout conversions) bit-equal to ``permute().contiguous()``,
    at the small shapes, KITTI, two frames, an H W that is not a multiple
    of 4 and D = 1800 (K9a's planes in chunks);
16. K3m (volume-free training forward): its four maps bit-equal to K3's,
    its argmax, s and t bit-equal to K3w's, no volume;
17. K5 (volume-free trainable backward) against its plain twin on the same
    residual maps, and against K4 on K3w's, both head branches, KITTI and
    three (D, k) whose projector tile is staged in chunks (k up to 27, the
    largest its halo kernel takes) and the edge shapes of phase 4 (printed
    whether bit-equal to K4 at KITTI);
17b. K4, K5, K6 and K7 past the k their first versions took (K4 49, K5 29,
    K6 83, K7 95) and at k = 127, at an edge shape and at KITTI, against
    their plain versions: K4 reading its constants from their maps, K5 and
    K6 on the chunked route (K1's costs a slab of 8 planes at a time), K6
    bit-equal to K2 on K1's volume and K5 bit-equal to K4 on it
    (required), K5 against K4 on K3w's residuals (printed); K5's peak
    device memory at k = 127 beside k = 15's, less than one volume;
18. the volume-free training path, counted: 5 Adam steps at KITTI
    of ``optimize_camera``'s loss through
    ``stereo_pipeline_trainable(save_volume=False)``; K3m and K5 once a
    step, K3w, K4 and every plain twin never, losses finite and falling;
    then the K5 gradient against the K4 one, and each mode's peak device
    memory and host-clock step time;
19. the plane-major path at KITTI, counted: ``stereo_matching_hdw``
    + ``extract_disparity_hdw`` and the backward of a mean soft-disparity
    loss; K1 and K2 once each, the volume K1's buffer as it is; its camera
    gradient against the parity path's (``StereoMatcher.__call__``) and
    both host-clock step times;
20. the camera VJP without the cost residual at KITTI, counted: K1's
    plane-major volume, K9a to parity, the head's cotangent (K8h, K8hb),
    K9b and K6; each once, the gradient against the plain closed form; then the
    step's host-clock time;
21. K10a (the op-class rate probe, every mode, a small launch and its
    measuring size) against its plain twin within rtol 1e-5, K10b (HBM
    read) within rtol 1e-5 and K10c (HBM write) bit-equal, at KITTI's
    volume and at ragged shapes whose rows and planes lie off 16-byte
    boundaries (``kernel_model.HBM_EDGE_SHAPES``; K10b also from a volume
    4 bytes off one);
22. the bound-model path, counted: ``measure_vpu_rates(force=True)``
    (K10a in every mode and K10b and K10c in each of its three rounds,
    the plain twins never) and the card health probe
    (``scripts/device_probe.py``, which must pass); each rate printed
    beside the data sheet;
23. device times of every kernel, its plain version and the one PyTorch
    call that computes the same function where there is one (K9a/b,
    K10b/c): K8 at 330x422, K10a at its madd timing size, the others at
    KITTI size; beside each its bound, the larger of its bytes over
    3.35 TB/s and the least operations its function needs (window sums
    taken separably) over 67 TFLOP/s (``utils/profiling.py``), and its
    model bound, its counted work priced at the rates of phase 22
    (``utils/kernel_model.py``), which no kernel may beat; K1-K9a beside
    their times before their redesigns (``MS_BEFORE``); then K4, K5, K6
    and K7 at KITTI with k = 127, each beside its bound and model.

24. K8 at k = 1 (JAX's gate is odd k >= 1) against its plain version at
    the JAX suite's all-pairs shapes and 330x422; then, counted, the
    all-pairs matcher at k = 1 forward and backward: K8 once, the plain
    volume never, the camera gradient against the plain node's;
25. the large-k route (``csrc/large_k.cu``, ``ops/cuda_large_k.py``) at
    an edge shape, a batch and the large-k path's 40x130 (D = 24): K1, K3
    (both head branches), K3w, K3m, K2,
    K6, K5 at k = 129 and 131, K7 at 129 and its ValueError at 131, K8 at
    145 and 147, K4 on its own rounds at 129 and 131 and on the route at
    187 (and the route called at 129), against their plain versions; K3w's
    volume bit-equal to K1's, K3w's and K3m's maps to K3's, K6 to K2 and K5
    to K4's route on K1's volume;
26. the large-k path, counted, through the entry points at k = 129
    (and K4's route at 187, all-pairs at 145): every route and every one
    of its kernels runs, no plain twin;
26b. the route choice pinned against the launchers: for every kernel and
    D = 0, 24, 192, its own blocks run at the last k before the route and
    its launcher refuses the first k on it (the choice switched off); at
    every tile of the rounds kernels (8, 16 and 32 rows), the launchers'
    planes a round and chunk (queried, nothing launched) equal the model's
    at every odd k to 255, and K1, the K3 family and K4 at 8 and 32 rows
    run their own blocks at the last k before that tile's route and are
    refused at its first;
27. each route timed at KITTI with k = 129 (K8 at 330x422, k = 145)
    beside its plain version, bound and model (K4 also on its own rounds)
    and its time before the window sums' redesign (``MS_BEFORE``), and its
    output there held against its plain version's; then
    ``device_profile large_k``: each route's device time by kernel (the
    window sums' share), and the route against K2, K4, K5, K6 and K7 on
    their own blocks at KITTI with k = 63, 95 and 127;
28. the left-right serving path: ``StereoEngine(lr_check=True,
    retries=2)`` healthy, then, counted, warm-up and 8 KITTI frames:
    K3 twice a frame, no plain twin, every frame's maps bit-equal to two
    direct K3 calls composed with the plain mask, some confident pixels
    masked, coverage, EPE and the per-frame median;
29. the pyramid, counted: ``PyramidStereoMatcher`` at KITTI (k =
    15, D = 192) on the JAX bench's scene, K3 twice a call and the glue
    kernels K11p, K11w and K11c once, each level's
    K3 maps against the plain pipeline on that level's inputs, EPE <=
    0.30 px and coverage >= 0.97 printed beside the JAX package's values,
    and the time a call; then the glue at Middlebury 2014's 2880x1988
    (D = 289, f = 4, r = 12) on the pipeline's own maps, counted: K11w
    and K11c bit-equal to the plain glue, K11p within rtol 1e-6 of
    ``_avg_pool``, each timed beside its bound by bytes and the plain
    stage;
30. the failsafe layer: an injected allocation failure retried and
    served, an injected sticky error (700) raised at once, and
    ``device_healthcheck()`` true;
31. the unsharded calls the parallel phases are held to, at the engine's
    KITTI bucket (384x1280, B = 2, k = 15, D = 192), against their plain
    versions on the same pairs: K1's volume, K3's maps, K2's camera
    gradient of the mean soft disparity (the plain VJP fed the same head
    cotangent), K3w + K4's maps and camera gradient (as in phase 8), and
    K3's maps at D = 191 over the stage pipeline's 4 frames;
32. the parallel layer at one rank on the same pairs:
    ``initialize_multihost()`` gives an NCCL world of one; counted,
    ``sharded_cost_volume`` and ``sharded_apply`` on a 1 x 1 mesh (K1; K2
    behind a mean soft-disparity loss), ``sharded_disparity_maps`` (K3)
    and with ``trainable=True`` (K3w + K4), ``optimize_camera`` with the
    mesh for 5 Adam steps (K1 + K2 a step) and ``pipelined_video_maps`` on
    a one-stage mesh (4 frames, D = 191: K3m a frame); exactly these
    launches run, no plain version runs, every forward output is
    bit-equal to the unsharded call (``sharded_apply``'s maps to the
    parallel layer's head, the plain one, on K1's unsharded volume; the
    one-card model runs K8h there, whose hard map, mask and confidence
    it matches bit for bit and soft map within rtol 1e-4 / atol 1e-3
    px), the gradients within rtol 1e-3 / atol 1e-6 (``sharded_apply``'s
    also against the one-card model's, K8hb + K2), the losses finite and
    falling; the host-clock time of
    ``sharded_disparity_maps`` against ``StereoMatcher.disparity_maps``;
    the process group destroyed;
33. the sharded compute on one card, on the same pairs: at ``space`` = 2
    and 4 the per-shard functions of ``parallel/sharded.py`` on the
    halo-extended blocks the exchange delivers (zeros past the true
    borders), stitched:
    K1's volume and K3's maps bit-equal to the unsharded calls, the camera
    gradient through K1 + K2 and through K3w + K4 (halo slabs added back
    in the exchange's backward order) within rtol 1e-3 / atol 1e-6; at
    S = 2 and 4 stages the K3m chunk states (``parallel/pipeline.py``)
    merged in stage order at beta = 50, 75 (the full range normalized, the
    stages not) and 80: disparity and mask equal to the full-range K3's,
    soft disparity and confidence within rtol 1e-4 / atol 1e-5, and the
    merged maps against the plain pipeline as in phase 4; the stage
    op timed (CUDA events) beside ``stage_op_cost``'s model;
34. the data layer: which image decoders the machine has; the native
    library (``native/custereo_io.cpp``, g++) built where libpng's header
    is found (required there; where it is not, which decoder reads PNGs
    instead); the capture PNGs decoded by each decoder present, the numpy
    decoder bit-equal to the native one and its samples to OpenCV's; the
    capture's ground truth loaded; 8- and 16-bit PNGs written by
    ``kitti._write_png_gray`` read back as exactly u8 / 255 and u16 / 256;
    the native ``FrameLoader`` delivering 8 frames in path order where
    the library is built;
35. the torch golden oracle (``ops.golden``, a direct patch sum) on the
    card at 24x40 (k = 5) and 37x61 (k = 15), D = 8: K1's and K8's
    volumes against it within rtol 1e-4 / atol 1e-5, K2's and K7's VJPs
    within rtol 1e-3 / atol 1e-6 (mean-loss-scaled cotangents), and the
    plain versions against it too;
35b. the randomized-shape sweep (``fuzz``): the seeded cases of
    ``utils/shape_sweep.py``, which ``tests/test_torch_fuzz_shapes.py``
    holds against the JAX package on the CPU (the JAX sweep's space; D >=
    W, D = 0, H < k, all-pairs with k // 2 > W, batches of 2 and 3, k =
    1), each kernel that takes a case's k against its plain version at
    the tolerances of its own phase: K1, K3w (volume), K3 (maps, ties and
    threshold flips explained), K3w and K3m (maps bit-equal to K3's, K3m's
    am/s/t to K3w's), K2, K6 (both entries), K4, K5 and K7 (mean-loss-
    scaled cotangents; rtol 1e-3 / atol 1e-6 where the plain twin holds
    that bound against its float64 run, else every pixel within
    max(atol + rtol |float64|, 2 |twin - float64|) of the float64 run),
    K9a and K9b (bit-equal) and K8; the CUDA all-pairs op's camera
    gradient (K8, then the closed form on the card) against the plain
    node's and the golden oracle's; at
    k = 1 every banded kernel must refuse the case by its kernel-size
    gate, as JAX's Pallas kernels do.  One line a kernel: its cases and
    largest error (folded into the ``kernels`` line's errors);
36. the data-driven examples at real size, each in process through its
    ``main(argv)``, counted: ``real_capture``
    (330x422, D = 48, k = 15, must pass), ``kitti_eval`` on a 4-frame
    375x1242 KITTI-2015 split written by ``kitti.write_fixture`` (D = 192,
    must pass at ``--max-epe 3.0``), ``serve`` (8 frames, ``retries=2``,
    ``SERVE: OK``), ``video_depth`` (16 frames at 375x1242, D = 192) and
    ``demo`` (375x1242, D = 192, ``--save-png`` decoded back); each
    launches K3 and no plain version, and one frame's maps are held
    against the plain pipeline on the same inputs (hard disparity and
    mask equal except at top-two ties, counted, or a mask within 1e-5 of
    the threshold; soft disparity rtol 1e-4 / atol 1e-5 where the masks
    agree); each example's own numbers printed beside the card;
37. the tile tuner (``ops/tuning.py``) from an empty cache file: K3, K1
    and K4 at KITTI and K3 at serve's bucket (384x512, D = 48, k = 15);
    every candidate it measured bit-equal to the default tile's output
    (K1's volume, K3's maps, at K3's tiles also K3w's and K3m's maps and
    residuals, K4's gradient) and held against the plain version, its
    model and measured ms printed;
    each winner beside the default's ms, then from the disk cache (nothing
    measured) against the plain version; ``StereoEngine(autotune=True)``
    (maps bit-equal to the untuned engine's and held against the plain
    pipeline) and ``serve --autotune`` on the card;
38. the tiled path, counted at each tile: at 8 and 32 rows a
    ``StereoMatcher`` configured with that tile serves a KITTI pair (K3)
    and takes a training step (K3w + K4), the volume-free trainable
    pipeline runs forward (K3m) and K1 writes the volume, each bit-equal
    to the default tile's and held against its plain version on the same
    inputs (K1's volume as phase 3, the K3 family's maps as phase 4, K4's
    gradient as phase 8: the errors of the ``kernels`` line's tiled
    entries); every tiled kernel launched, no plain version; then each
    timed at KITTI beside its default tile;
39. the bench: ``python -m custereomatching_tpu_torch.bench`` in a
    subprocess at KITTI (its own preflight and every measurement of the
    JAX bench); it must exit 0 with one stdout line, the JSON summary,
    on the card (``platform`` ``gpu``), the headline above 0 and
    ``vs_baseline`` in (0, 1.05], every secondary measurement present
    and finite, every hard-disparity pixel that differs from the plain
    path a top-two tie, and the pyramid's EPE <= 0.30 px and coverage
    >= 0.97; its headline and secondaries printed.

At its end the script writes the record the bench reads
(``build/smoke/chip_smoke.json``: pass or fail, the card, the time, the
digest of the kernel sources).

The last three lines are the kernel summary (JSON), the card's name and
power limit as ``nvidia-smi`` reports them, and the result line
``{"ok": true, "device": {...}}``.  Any failed check raises, so the
script exits non-zero and prints no result; so does a machine without a
card.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from collections import Counter

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from custereomatching_tpu_torch import StereoConfig, StereoEngine, StereoMatcher
from custereomatching_tpu_torch import bench, native
from custereomatching_tpu_torch.config import MeshConfig
from custereomatching_tpu_torch.data import io as data_io
from custereomatching_tpu_torch.data import kitti, make_stereo_pair
from custereomatching_tpu_torch.examples import (
    demo,
    kitti_eval,
    real_capture,
    serve,
    video_depth,
)
from custereomatching_tpu_torch.models import PyramidStereoMatcher
from custereomatching_tpu_torch.models.pyramid import (
    _avg_pool,
    _compose,
    _shift_and_warp,
)
from custereomatching_tpu_torch.models import (
    StereoOutput,
    adam,
    entry,
    init_state,
    make_train_step,
    optimize_camera,
)
from custereomatching_tpu_torch.ops import (
    _build,
    cuda_zncc,
    extract_disparity_hdw,
    golden,
    stereo_matching,
    stereo_matching_hdw,
    stereo_matching_torch,
    tuning,
)
from custereomatching_tpu_torch.ops import cuda_large_k as lk
from custereomatching_tpu_torch.ops import cuda_pyramid
from custereomatching_tpu_torch.ops.consistency import lr_consistency_mask
from custereomatching_tpu_torch.ops.cuda_pipeline import (
    HeadResiduals,
    PipelineMaps,
    fused_pipeline_bwd_cuda,
    fused_pipeline_bwd_reference,
    fused_pipeline_train_cuda,
    fused_pipeline_train_reference,
    head_residuals,
    stereo_pipeline_cuda,
    stereo_pipeline_reference,
    stereo_pipeline_trainable,
    stereo_pipeline_trainable_reference,
    unnormalized_head,
)
from custereomatching_tpu_torch.ops import cuda_head
from custereomatching_tpu_torch.ops.cuda_allpairs import (
    allpairs_volume_and_stats,
    camera_grad_allpairs_cuda,
    cost_volume_allpairs_cuda,
)
from custereomatching_tpu_torch.ops.cuda_head import extract_disparity_cuda
from custereomatching_tpu_torch.ops.cuda_zncc import (
    K7_MAX_KERNEL_SIZE,
    camera_grad_banded_cuda,
    camera_grad_banded_parity_cuda,
    cost_volume_banded_cuda,
    projector_grad_banded_cuda,
)
from custereomatching_tpu_torch.ops.layout import (
    parity_to_plane_major,
    parity_to_plane_major_reference,
    plane_major_to_parity,
    plane_major_to_parity_reference,
)
from custereomatching_tpu_torch.ops.disparity import extract_disparity
from custereomatching_tpu_torch.ops.zncc import (
    box2d,
    camera_grad_allpairs,
    camera_grad_banded,
    forward_allpairs,
    forward_banded,
    projector_grad_banded,
)
from custereomatching_tpu_torch.parallel import (
    initialize_multihost,
    make_mesh,
    pipelined_video_maps,
    shard_batch,
    sharded_cost_volume,
    sharded_disparity_maps,
    stage_mesh,
)
from custereomatching_tpu_torch.parallel.pipeline import (
    chunk_state,
    finalize_state,
    merge_states,
)
from custereomatching_tpu_torch.parallel.sharded import (
    local_cost_volume,
    local_disparity_maps,
)
from custereomatching_tpu_torch.scripts import device_probe, device_profile
from custereomatching_tpu_torch.utils import (
    benchmark,
    device_healthcheck,
    disparity_metrics,
    fence,
    with_retries,
)
from custereomatching_tpu_torch.utils import kernel_model as km
from custereomatching_tpu_torch.utils.profiling import (
    COUNTS,
    PEAK_BYTES,
    PEAK_FLOPS,
    allpairs_bound,
    banded_bounds,
    bound,
    card_line,
)
from custereomatching_tpu_torch.utils.shape_sweep import (
    case_cotangent,
    case_pair,
    sweep_cases,
)

EPS = 1e-8
THRESHOLD = 0.6
# (B, H, W, D, k): the JAX suite's kernel shapes, a batch, and KITTI.
SHAPES = [(1, 24, 150, 10, 5), (1, 17, 100, 3, 3), (1, 12, 260, 140, 7),
          (1, 9, 40, 0, 5), (2, 16, 48, 6, 5)]
KITTI = (375, 1242, 192, 15)
# entry()'s shape (B, H, W, D, k): where the training path runs K2.
ENTRY = (1, 96, 160, 64, 15)
BUCKET = (384, 1280)
# Served frames: a slanted plane spanning most of the 0..192 band.
D_MIN, D_MAX = 4.0, 184.0
N_FRAMES = 8
# Training path: Adam steps of optimize_camera from a camera with this much
# Gaussian noise; then more steps, timed on the host clock.
TRAIN_STEPS, TRAIN_LR, TRAIN_NOISE, TIMED_STEPS = 5, 1e-3, 0.05, 10
# All-pairs (B, H, W, k): the JAX suite's kernel shapes
# (tests/test_pallas_allpairs.py:28-31) and a batch; then the reference's
# verify shape, where the all-pairs path runs, and KITTI's width.
AP_SHAPES = [(1, 24, 60, 5), (1, 16, 150, 15), (1, 13, 40, 7),
             (1, 9, 129, 3), (2, 16, 48, 5)]
VERIFY = (330, 422, 15)
AP_WIDE = (1, 375, 1242, 15)
# K7 (B, H, W, D, k): the JAX suite's shapes (tests/test_pallas_bwd.py:
# 277-281) and a batch; KITTI is added in the phase.
K7_SHAPES = [(1, 16, 24, 5, 3), (1, 24, 150, 10, 5), (1, 40, 96, 12, 15),
             (2, 16, 48, 6, 5)]
# K7 at k = 47 and 93, the largest k its combine kernel stages its three
# maps together at (its rounds fall to 2 planes at k = 93).
K7_LARGE_K = [(1, 40, 130, 24, 47), (1, 40, 130, 24, 93)]
# Gradient checks: the JAX suite's elementwise tolerance
# (tests/test_pallas_bwd.py:89) at the small shapes, and a bound on
# ||got - want|| / ||want|| everywhere (KITTI included).
GRAD_RTOL, GRAD_ATOL, GRAD_NORM_REL = 1e-3, 1e-6, 1e-4
# K10a's modes, and the iterations of its timed madd launch (at the
# measuring launch's blocks): short enough for the plain twin's
# 4 x iters elementwise calls.
K10A_MODES = ("madd", "smem", "exp", "rsqrt", "boxadd")
K10A_TIMED_ITERS = 1024
# Device ms of the kernels before their redesigns (at KITTI; K8 at
# 330x422): K1-K7 on K1's first per-plane pass, K8 summing every output's
# k^2 products, K9a on K9b's tiled transpose; the large-k routes (KITTI, k
# = 129; K8L 330x422, k = 145) on window sums of k loads an output through
# L1 and L2 (NVIDIA H100 80GB HBM3 at 700.00 W; PERF.md gives the runs).
MS_BEFORE = {"K3": 1.4419, "K3w": 1.5533, "K3m": 1.4334, "K5": 5.4410,
             "K4": 2.3372, "K6": 4.0753, "K1": 1.4628, "K7": 2.3561,
             "K2": 2.2018, "K8": 1.2642, "K9a": 0.6646,
             "K1L": 13.7711, "K3L": 14.2021, "K3wL": 14.1912,
             "K3mL": 14.3279, "K2L": 13.7273, "K6L": 27.0129,
             "K4L": 13.7239, "K5L": 27.3019, "K7L": 14.3231,
             "K8L": 12.8701}


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def uniform_pair(seed: int, B: int, H: int, W: int):
    rng = np.random.default_rng(seed)
    cam = rng.random((B, H, W), dtype=np.float32)
    proj = rng.random((B, H, W), dtype=np.float32)
    return torch.from_numpy(cam).cuda(), torch.from_numpy(proj).cuda()


def speckle_frames(n: int, seed: int):
    """``n`` KITTI-size synthetic pairs and their true disparity."""
    H, W, _, _ = KITTI
    pairs = [make_stereo_pair(H, W, d_min=D_MIN, d_max=D_MAX, seed=seed + i)
             for i in range(n)]
    return [np.stack(x) for x in zip(*pairs)]


def phase_env() -> str:
    nvcc = subprocess.run([_build.nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"env: python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}, nvcc '{nvcc.splitlines()[-1]}'")
    card = card_line()
    print(f"env: card {card}; torch sees {torch.cuda.device_count()} "
          f"({torch.cuda.get_device_name(0)})")
    return card


def phase_build() -> None:
    t0 = time.perf_counter()
    lib = _build.build()
    _build.kernels()
    print(f"build: {lib.name} in {time.perf_counter() - t0:.1f} s")
    log = lib.with_suffix(".log")
    if log.is_file():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"build: {line.strip()}")
        for unit, name, regs, st, ld in rounds_registers(log.read_text()):
            print(f"build: rounds kernel {unit}: {name}: {regs} registers, "
                  f"spill stores {st} B, spill loads {ld} B")


def compare_volume(got, want, label: str, kernel: str = "K1",
                   quiet: bool = False) -> float:
    """A volume against its plain version within rtol 1e-4 / atol 1e-5;
    prints its line (``quiet``: only where the check fails) and returns
    max abs."""
    torch.cuda.synchronize()
    require(bool(torch.isfinite(got).all()),
            f"{label}: non-finite {kernel} output")
    diff = (got - want).abs()
    bad = int((diff > 1e-5 + 1e-4 * want.abs()).sum())
    big = want.abs() > 1e-3
    max_rel = float((diff[big] / want.abs()[big]).max()) if big.any() else 0.
    max_abs = float(diff.max())
    if not quiet or bad:
        print(f"{kernel} {label}: max_abs {max_abs:.3e} max_rel "
              f"{max_rel:.3e} outside rtol 1e-4/atol 1e-5: {bad}")
    require(bad == 0, f"{kernel} {label} within rtol 1e-4 / atol 1e-5")
    return max_abs


# K1 at k up to 127 (the largest its block takes: one plane a round and a
# one-plane projector chunk at k = 127), and at D = 1800, k = 15, where its
# projector tile is staged in chunks (the first version took D <= 1739).
K1_LARGE_K = [(1, 40, 200, 24, k) for k in (3, 31, 47, 127)]
K1_CHUNKED = (1, 16, 2100, 1800, 15)


def phase_k1() -> float:
    err = 0.0
    shapes = SHAPES + [(2,) + KITTI] + K1_LARGE_K + [K1_CHUNKED]
    for i, (B, H, W, D, k) in enumerate(shapes):
        cam, proj = uniform_pair(i, B, H, W)
        got = cost_volume_banded_cuda(cam, proj, D, k, EPS)
        want = forward_banded(cam, proj, D, k, EPS)
        err = max(err, compare_volume(
            got, want, f"B={B} H={H} W={W} D={D} k={k} (round/chunk "
            f"{km.fused_round(k, D)})"))
        del got, want
        torch.cuda.empty_cache()
    return err


def compare_maps(got, want, cost, threshold: float, exact: bool,
                 label: str, quiet: bool = False) -> float:
    """K3 maps against the plain pipeline.  ``exact``: disparity and mask
    must match bit for bit.  Otherwise a mask may flip only within 1e-5 of
    the threshold (at most 1e-4 of the pixels) and a disparity may differ
    only where the mask flips or the top two costs lie within 1e-5.
    ``quiet``: no line where every check holds (a failed one raises with
    its label)."""
    torch.cuda.synchronize()
    for name in got._fields:
        require(bool(torch.isfinite(getattr(got, name)).all()),
                f"{label}: non-finite {name}")
    conf_err = (got.confidence - want.confidence).abs()
    require(bool((conf_err <= 1e-5 + 1e-5 * want.confidence.abs()).all()),
            f"{label}: confidence within rtol 1e-5 / atol 1e-5")
    flips = got.mask != want.mask
    same = ~flips
    soft_err = (got.soft_disparity - want.soft_disparity).abs()[same]
    require(bool((soft_err <= 1e-3 + 1e-3 * want.soft_disparity.abs()[same])
                 .all()), f"{label}: soft disparity within rtol/atol 1e-3")
    differ = got.disparity != want.disparity
    n_flip, n_differ = int(flips.sum()), int(differ.sum())
    if exact:
        require(n_flip == 0 and n_differ == 0,
                f"{label}: mask and disparity exact")
        n_tie = 0
    else:
        near = (want.confidence - threshold).abs() <= 1e-5
        require(n_flip <= 1e-4 * flips.numel(),
                f"{label}: mask flips {n_flip} within 1e-4 of the pixels")
        require(bool(near[flips].all()),
                f"{label}: every mask flip within 1e-5 of the threshold")
        tie = top2_ties(cost)
        unexplained = differ & ~flips & ~tie
        n_tie = int((differ & ~flips & tie).sum())
        require(not bool(unexplained.any()),
                f"{label}: {int(unexplained.sum())} disparity mismatches "
                f"without a mask flip or a top-two tie")
    if not quiet:
        soft_max = float(soft_err.max()) if soft_err.numel() else 0.
        print(f"K3 {label}: conf max_abs {float(conf_err.max()):.3e}, soft "
              f"max_abs {soft_max:.3e}, mask flips {n_flip}, disparity "
              f"mismatches {n_differ} (top-two ties {n_tie})")
    return float(conf_err.max())


# Shapes on the edges of the register-blocked pass of K3 and K5 (B, H, W,
# D, k), beta: H not a multiple of 16 and W not of 64; D + 1 not a
# multiple of the planes a round; k = 3 (every pass below its blocking),
# 11 (K5's cross-term rows pass below it) and 27 (K5's largest).
EDGE = [((1, 37, 200, 24, 3), 50.0), ((1, 33, 140, 19, 11), 80.0),
        ((1, 40, 130, 30, 27), 50.0)]


# K4 and K6 at k where their rounds fall to fewer planes (4 at k = 31, 1
# for K4 at k = 47, the largest k its block takes), K5 refusing both.
LARGE_K = [((1, 40, 130, 24, 31), 50.0), ((1, 40, 130, 24, 47), 50.0)]


def edge_label(B: int, H: int, W: int, D: int, k: int, beta: float) -> str:
    """The shape, with K3's, K5's, K4's and K6's (planes a round, planes
    a projector staging) on an H100."""
    k5 = (km.halo_round(k, D) if km.halo_fits(k, D)
          else f"chunked, slabs of {km.COST_CHUNK}")
    return (f"edge B={B} H={H} W={W} D={D} k={k} beta={beta} (K3 round/chunk "
            f"{km.fused_round(k, D)}, K5 round/chunk {k5}, K4 "
            f"{km.grad_round(k, D, True, False)}, K6 "
            f"{km.grad_round(k, D, False, True)})")


def phase_k3() -> float:
    err = 0.0
    cases = ([(s, 50.0) for s in SHAPES] + [((1, 16, 100, 37, 7), 80.0)]
             + EDGE)
    for i, ((B, H, W, D, k), beta) in enumerate(cases):
        cam, proj = uniform_pair(100 + i, B, H, W)
        got = stereo_pipeline_cuda(cam, proj, D, k, EPS, beta, THRESHOLD)
        want = stereo_pipeline_reference(cam, proj, D, k, EPS, beta,
                                         THRESHOLD)
        err = max(err, compare_maps(
            got, want, None, THRESHOLD, True,
            f"B={B} H={H} W={W} D={D} k={k} beta={beta}"))
    H, W, D, k = KITTI
    cams, projs, _ = speckle_frames(1, seed=7)
    cam, proj = torch.from_numpy(cams).cuda(), torch.from_numpy(projs).cuda()
    got = stereo_pipeline_cuda(cam, proj, D, k, EPS, 50.0, THRESHOLD)
    want = stereo_pipeline_reference(cam, proj, D, k, EPS, 50.0, THRESHOLD)
    cost = forward_banded(cam, proj, D, k, EPS)
    err = max(err, compare_maps(got, want, cost, THRESHOLD, False,
                                f"speckle B=1 H={H} W={W} D={D} k={k} "
                                f"beta=50.0"))
    return err


OTHER_TILES = tuple(th for th in km.TILE_ROWS if th != km.K_TILE_H)
TILE_KERNEL_KEYS = ("K1", "K3", "K3w", "K3m", "K4")
# What each counted path runs (``COUNTS`` since just before it): exactly
# these launches and no plain twin.  The bound model's path measures in
# rounds, so it runs at least these, and nothing else.
PATH_LAUNCHES = {
    "serve": Counter({"K1": 2, "K8h": 2, "K3": 1 + N_FRAMES}),
    "train": Counter({"K1": 1, "K8h": 1, "K8hb": 1, "K2": 1,
                      "K3w": TRAIN_STEPS, "K4": TRAIN_STEPS}),
    "allpairs": Counter({"K8": 1, "K8h": 1, "K8hb": 1, "K8b": 1}),
    "grad_projector": Counter({"K1": 1, "K8h": 1, "K8hb": 1, "K2": 1,
                               "K7": 1}),
    "volume_free": Counter({"K3m": TRAIN_STEPS, "K5": TRAIN_STEPS}),
    "plane_major": Counter({"K1": 1, "K2": 1}),
    "no_residual": Counter({"K1": 1, "K9a": 1, "K8h": 1, "K8hb": 1,
                            "K9b": 1, "K6": 1}),
    "bound_model": Counter({"K10a": 3 * len(K10A_MODES), "K10b": 3,
                            "K10c": 3,
                            **{f"K10a.{m}": 3 for m in K10A_MODES}}),
    "allpairs_k1": Counter({"K8": 1, "K8h": 1, "K8hb": 1, "K8b": 1}),
    "lr": Counter({"K3": 2 * (1 + N_FRAMES)}),
    "pyramid": Counter({"K3": 2, "K11p": 1, "K11w": 1, "K11c": 1}),
}


def launched(before: Counter) -> Counter:
    """What ran since ``before``, a copy of ``COUNTS``: kernel launches by
    name, plain twins' calls (``plain.<function>``) and the large-k
    route's calls (``route.<K>``)."""
    return COUNTS - before


def plain_calls(ran: Counter) -> Counter:
    return Counter({n: c for n, c in ran.items() if n.startswith("plain.")})


def require_launched(what: str, before: Counter, want: Counter,
                     at_least: bool = False) -> Counter:
    """What ran since ``before``, printed and held to ``want``: exactly,
    or (``at_least``) at least as often and nothing else.  Returns it."""
    ran = launched(before)
    print(f"{what}: launched {dict(sorted(ran.items()))}")
    ok = (ran >= want and ran.keys() == want.keys()) if at_least \
        else ran == want
    require(ok, f"{what}: launched {'at least ' if at_least else ''}"
            f"{dict(sorted(want.items()))} and nothing else, got "
            f"{dict(sorted(ran.items()))}")
    return ran


def phase_main_path() -> dict:
    H, W, D, k = KITTI
    cfg = StereoConfig(kernel_size=k, num_disparities=D)
    batch = speckle_frames(2, seed=20)
    frames = speckle_frames(N_FRAMES, seed=40)
    engine = StereoEngine(cfg, buckets=[BUCKET], device="cuda")

    before = COUNTS.copy()
    with torch.no_grad():
        forward, args = entry("cuda")
        soft = fence(forward(*args))
        out = fence(StereoMatcher(cfg)(torch.from_numpy(batch[0]).cuda(),
                                       torch.from_numpy(batch[1]).cuda()))
    engine.warmup()
    served, latency = [], []
    for cam, proj in zip(frames[0], frames[1]):
        t0 = time.perf_counter()
        served.append(engine.infer(cam, proj))
        latency.append(time.perf_counter() - t0)
    # K1 and K8h once per volume call, K3 once per warm-up and served
    # frame.
    counts = require_launched("main path", before, PATH_LAUNCHES["serve"])

    require(tuple(soft.shape) == (1, 96, 160)
            and bool(torch.isfinite(soft).all()), "entry() output")
    require(tuple(out.cost_volume.shape) == (2, H, W, D + 1)
            and bool(torch.isfinite(out.cost_volume).all())
            and bool(torch.isfinite(out.soft_disparity).all()),
            "StereoMatcher forward output")
    fwd_mask = out.mask.bool().cpu().numpy()
    fwd_epe = float(np.abs(out.soft_disparity.cpu().numpy()
                           - batch[2])[fwd_mask].mean())
    print(f"main path: entry() soft disparity {tuple(soft.shape)} finite; "
          f"forward [2, {H}, {W}] coverage {fwd_mask.mean():.4f} "
          f"EPE {fwd_epe:.4f} px")

    mask = np.stack([m.mask for m in served]).astype(bool)
    soft_d = np.stack([m.soft_disparity for m in served])
    require(soft_d.shape == (N_FRAMES, H, W) and np.isfinite(soft_d).all(),
            "served maps")
    coverage = float(mask.mean())
    epe = float(np.abs(soft_d - frames[2])[mask].mean())
    bad1 = float((np.abs(soft_d - frames[2])[mask] > 1.0).mean())
    print(f"main path: engine served {N_FRAMES} frames {H}x{W} in bucket "
          f"{BUCKET}: coverage {coverage:.4f}, EPE {epe:.4f} px, "
          f">1px {bad1:.4f} on confident pixels; host latency median "
          f"{1e3 * float(np.median(latency)):.3f} ms")
    require(coverage > 0.5 and epe < 1.0, "engine accuracy")

    # Zero-padding to the bucket is exact: same maps as the unpadded frame.
    direct = stereo_pipeline_cuda(torch.from_numpy(frames[0][:1]).cuda(),
                                  torch.from_numpy(frames[1][:1]).cuda(),
                                  D, k, cfg.epsilon, cfg.softargmax_beta,
                                  cfg.cost_threshold)
    for name in direct._fields:
        require(np.array_equal(getattr(direct, name)[0].cpu().numpy(),
                               getattr(served[0], name)),
                f"engine {name} equals the unpadded K3 output")
    print("main path: engine output equals unpadded K3 output bit for bit")
    return counts


def top2_ties(cost_hwd: torch.Tensor) -> torch.Tensor:
    """Pixels whose two largest costs lie within 1e-5 ([B, H, W] bool)."""
    if cost_hwd.shape[-1] < 2:
        return torch.zeros(cost_hwd.shape[:-1], dtype=torch.bool,
                           device=cost_hwd.device)
    top2 = torch.topk(cost_hwd, 2, dim=-1).values
    return (top2[..., 0] - top2[..., 1]) <= 1e-5


def compare_grad(got, want, label: str, elementwise: bool,
                 keep=None, quiet: bool = False) -> float:
    """A camera gradient against its plain twin over the pixels in
    ``keep``: ||got - want|| / ||want|| <= GRAD_NORM_REL always, and with
    ``elementwise`` every pixel within rtol GRAD_RTOL / atol GRAD_ATOL.
    Prints max abs, max rel (over |want| > 1e-3 max |want|), the norm
    ratio and GRAD_ATOL / max |want| (how loose the atol is at this
    gradient's scale; ``quiet``: only where a check fails); returns max
    abs."""
    torch.cuda.synchronize()
    require(bool(torch.isfinite(got).all()), f"{label}: non-finite gradient")
    if keep is not None:
        got, want = got[keep], want[keep]
    diff = (got - want).abs()
    scale = want.abs()
    big = scale > 1e-3 * scale.max()
    max_abs = float(diff.max())
    max_rel = float((diff[big] / scale[big]).max()) if big.any() else 0.
    norm_rel = float(diff.norm() / want.norm())
    bad = int((diff > GRAD_ATOL + GRAD_RTOL * scale).sum())
    if not quiet or norm_rel > GRAD_NORM_REL or (elementwise and bad):
        print(f"{label}: max_abs {max_abs:.3e} max_rel {max_rel:.3e} "
              f"norm_rel {norm_rel:.3e} outside rtol {GRAD_RTOL}/atol "
              f"{GRAD_ATOL}: {bad} of {diff.numel()}; atol/max|want| "
              f"{GRAD_ATOL / float(scale.max()):.3e}")
    require(norm_rel <= GRAD_NORM_REL,
            f"{label}: norm-relative error within {GRAD_NORM_REL}")
    if elementwise:
        require(bad == 0, f"{label}: within rtol {GRAD_RTOL} / atol "
                          f"{GRAD_ATOL}")
    return max_abs


# K2 at larger k: rounds of 8, 4 and 1 planes; at k = 127 its combine
# kernel box-filters the three maps one at a time (the three tiles
# together fit up to k = 93).
K2_LARGE_K = [(1, 40, 200, 24, k) for k in (31, 47, 127)]


def phase_k2() -> float:
    err = 0.0
    shapes = SHAPES + [ENTRY, (1,) + KITTI] + K2_LARGE_K
    for i, (B, H, W, D, k) in enumerate(shapes):
        cam, proj = uniform_pair(200 + i, B, H, W)
        # A random cotangent at the scale of a mean loss over the frame's
        # pixels (1 / (H W)), the regime of the JAX suite's tolerance.
        g = torch.randn((B, D + 1, H, W), device="cuda",
                        generator=torch.Generator("cuda").manual_seed(i))
        g *= 1.0 / (H * W)
        cost = cost_volume_banded_cuda(cam, proj, D, k, EPS)
        got = camera_grad_banded_cuda(cam, proj, cost.permute(0, 3, 1, 2), g,
                                      D, k, EPS)
        want = camera_grad_banded(cam, proj, g.permute(0, 2, 3, 1), D, k,
                                  EPS)
        kitti = (H, W, D, k) == KITTI
        err = max(err, compare_grad(
            got, want, f"K2 B={B} H={H} W={W} D={D} k={k} (round "
            f"{km.grad_round(k, D, False, False)[0]})",
            elementwise=not kitti))
        del g, cost, got, want
    return err


def train_cases():
    """(label, camera, projector, D, k, beta): the small shapes, the
    rescaled head, and KITTI speckle; then the edge shapes."""
    cases = []
    for i, ((B, H, W, D, k), beta) in enumerate(
            [(s, 50.0) for s in SHAPES] + [((1, 16, 100, 37, 7), 80.0)]):
        cam, proj = uniform_pair(300 + i, B, H, W)
        cases.append((f"B={B} H={H} W={W} D={D} k={k} beta={beta}", cam,
                      proj, D, k, beta))
    H, W, D, k = KITTI
    cams, projs, _ = speckle_frames(1, seed=7)
    cases.append((f"speckle B=1 H={H} W={W} D={D} k={k} beta=50.0",
                  torch.from_numpy(cams).cuda(),
                  torch.from_numpy(projs).cuda(), D, k, 50.0))
    for j, ((B, H, W, D, k), beta) in enumerate(EDGE):
        cam, proj = uniform_pair(320 + j, B, H, W)
        cases.append((edge_label(B, H, W, D, k, beta), cam, proj, D, k,
                      beta))
    return cases


def phase_k3w() -> float:
    err = 0.0
    for label, cam, proj, D, k, beta in train_cases():
        maps, res = fused_pipeline_train_cuda(cam, proj, D, k, EPS, beta,
                                              THRESHOLD)
        serving = stereo_pipeline_cuda(cam, proj, D, k, EPS, beta, THRESHOLD)
        want = forward_banded(cam, proj, D, k, EPS)
        err = max(err, compare_volume(res.volume.permute(0, 2, 3, 1), want,
                                      f"volume {label}", kernel="K3w"))
        for name in maps._fields:
            require(torch.equal(getattr(maps, name),
                                getattr(serving, name)),
                    f"K3w {label}: {name} bit-equal to K3's")
        am, _, s, t = head_residuals(want, D, beta)
        tie = top2_ties(want)
        am_differ = res.am != am
        require(not bool((am_differ & ~tie).any()),
                f"K3w {label}: argmax differs only at top-two ties")
        # s and t do not depend on which index is the argmax, so every
        # pixel is compared, ties included.  s within rtol 1e-3; t within
        # rtol 1e-3 plus atol 1e-3 s, i.e. |dt| <= 1e-3 (t + s).  |dt| / s
        # alone cannot hold: t = sum_d d w_d carries the planes' rounding,
        # amplified by beta in w_d, at the scale of t / s (the soft
        # disparity, up to D); printed for the record.
        dt = (res.t - t).abs()
        s_max = float(((res.s - s).abs() / s).max())
        t_max = float((dt / (t + s)).max())
        ts_max = float((dt / s).max())
        require(s_max <= 1e-3 and t_max <= 1e-3,
                f"K3w {label}: s within rtol 1e-3, t within 1e-3 (t + s)")
        print(f"K3w {label}: maps bit-equal to K3; argmax mismatches "
              f"{int(am_differ.sum())} (top-two ties {int(tie.sum())}); "
              f"|ds|/s max {s_max:.3e}, |dt|/(t+s) max {t_max:.3e}, "
              f"|dt|/s max {ts_max:.3e}")
        del maps, res, serving, want

    # At beta = 1 K3w's volume is K1's on the same pair: K1 is the same
    # rounds kernel without the head.
    H, W, D, k = KITTI
    cams, projs, _ = speckle_frames(1, seed=7)
    cam, proj = torch.from_numpy(cams).cuda(), torch.from_numpy(projs).cuda()
    vol = fused_pipeline_train_cuda(cam, proj, D, k, EPS, 1.0,
                                    THRESHOLD)[1].volume.permute(0, 2, 3, 1)
    want = cost_volume_banded_cuda(cam, proj, D, k, EPS)
    label = f"beta=1 against K1, speckle B=1 H={H} W={W} D={D} k={k}"
    err = max(err, compare_volume(vol, want, label, kernel="K3w"))
    same = torch.equal(vol, want)
    print(f"K3w {label}: bit-equal to K1: {same}")
    require(same, f"K3w {label}: bit-equal to K1")
    del vol, want
    return err


def cotangents(seed: int, B: int, H: int, W: int):
    """Random soft and confidence cotangents at the scale of a mean
    loss's (1 / (H W))."""
    gen = torch.Generator("cuda").manual_seed(seed)
    scale = 1.0 / (H * W)
    return (torch.randn((B, H, W), device="cuda", generator=gen) * scale,
            torch.randn((B, H, W), device="cuda", generator=gen) * scale)


def phase_k4() -> float:
    err = 0.0
    large = []
    for j, ((B, H, W, D, k), beta) in enumerate(LARGE_K):
        cam, proj = uniform_pair(340 + j, B, H, W)
        large.append((edge_label(B, H, W, D, k, beta), cam, proj, D, k,
                      beta))
    for i, (label, cam, proj, D, k, beta) in enumerate(train_cases()
                                                       + large):
        B, H, W = cam.shape
        kitti = (H, W, D, k) == KITTI
        gs, gc = cotangents(400 + i, B, H, W)
        # K4 and its plain twin on the same residuals (K3w's).
        res = fused_pipeline_train_cuda(cam, proj, D, k, EPS, beta,
                                        THRESHOLD)[1]
        got = fused_pipeline_bwd_cuda(cam, proj, res, gs, gc, D, k, EPS,
                                      beta)
        want = fused_pipeline_bwd_reference(cam, proj, res, gs, gc, D, k,
                                            EPS, beta)
        err = max(err, compare_grad(got, want, f"K4 {label}",
                                    elementwise=not kitti))
        del res, got, want

        hold_trainable(cam, proj, D, k, beta,
                       lambda out: ((out.soft_disparity * gs).sum()
                                    + (out.confidence * gc).sum()),
                       label, elementwise=not kitti)
    return err


def plain_trainable(cam, proj, D: int, k: int, beta: float,
                    loss_of) -> dict:
    """The plain trainable pipeline on the loss ``loss_of(maps)``: its
    camera gradient and maps, the plain volume's top-two ties and the
    plain head's argmax, which :func:`hold_against_plain` holds a kernel
    run against."""
    c = cam.clone().requires_grad_(True)
    out = stereo_pipeline_trainable_reference(c, proj, D, k, EPS, beta,
                                              THRESHOLD)
    grad = torch.autograd.grad(loss_of(out), c)[0]
    cost = forward_banded(cam, proj, D, k, EPS)
    plain = {"grad": grad, "maps": type(out)(*(m.detach() for m in out)),
             "tie": top2_ties(cost), "am": head_residuals(cost, D, beta)[0]}
    del cost
    return plain


def hold_against_plain(grad, maps, am, plain: dict, k: int, label: str,
                       elementwise: bool) -> float:
    """A trainable pipeline's (K3w + K4) camera gradient, maps and argmax
    against :func:`plain_trainable`'s: the two forwards may disagree on
    the argmax only at top-two ties and on the mask only within 1e-5 of
    the threshold; the gradient is compared outside the k x k
    neighbourhoods of such pixels.  Returns the gradient's max abs
    error."""
    flips = maps.mask != plain["maps"].mask
    differ = am != plain["am"]
    conf_p = plain["maps"].confidence
    require(bool(((conf_p - THRESHOLD).abs() <= 1e-5)[flips].all()),
            f"K3w+K4 {label}: every mask flip within 1e-5 of the "
            f"threshold")
    require(not bool((differ & ~plain["tie"]).any()),
            f"K3w+K4 {label}: argmax differs only at top-two ties")
    odd = (flips | differ).to(grad.dtype)
    keep = box2d(odd, k, dim=1) == 0
    print(f"K3w+K4 {label}: argmax mismatches {int(differ.sum())}, mask "
          f"flips {int(flips.sum())}; gradient compared on "
          f"{int(keep.sum())} of {keep.numel()} pixels")
    return compare_grad(grad, plain["grad"], f"K3w+K4 {label}",
                        elementwise=elementwise, keep=keep)


def hold_trainable(cam, proj, D: int, k: int, beta: float, loss_of,
                   label: str, elementwise: bool):
    """The whole trainable pipeline (K3w + K4) against its plain twin on
    the loss ``loss_of(maps)`` (:func:`hold_against_plain`).  Returns the
    kernels' camera gradient and maps."""
    c = cam.clone().requires_grad_(True)
    out = stereo_pipeline_trainable(c, proj, D, k, EPS, beta, THRESHOLD)
    grad = torch.autograd.grad(loss_of(out), c)[0]
    out = type(out)(*(m.detach() for m in out))
    plain = plain_trainable(cam, proj, D, k, beta, loss_of)
    am = fused_pipeline_train_cuda(cam, proj, D, k, EPS, beta,
                                   THRESHOLD)[1].am
    hold_against_plain(grad, out, am, plain, k, label, elementwise)
    del plain
    return grad, out


def phase_train_path() -> dict:
    H, W, D, k = KITTI
    model = StereoMatcher(StereoConfig(kernel_size=k, num_disparities=D))
    cams, projs, _ = speckle_frames(1, seed=60)
    true_cam = torch.from_numpy(cams).cuda()
    proj = torch.from_numpy(projs).cuda()
    with torch.no_grad():
        target = model.disparity_maps(true_cam, proj).soft_disparity
    noise = np.random.default_rng(61).standard_normal(cams.shape)
    camera0 = true_cam + torch.from_numpy(
        (TRAIN_NOISE * noise).astype(np.float32)).cuda()
    forward, (cam_e, proj_e) = entry("cuda")
    require(tuple(cam_e.shape) == ENTRY[:3], f"entry() inputs {ENTRY[:3]}")
    cam_e = cam_e.clone().requires_grad_(True)
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    before = COUNTS.copy()
    # A mean loss, as disparity_loss is.
    forward(cam_e, proj_e).mean().backward()
    camera, losses = optimize_camera(model, camera0, proj, target,
                                     learning_rate=TRAIN_LR,
                                     num_steps=TRAIN_STEPS)
    torch.cuda.synchronize()
    # entry() forward and backward: K1, K8h, K8hb and K2 once each; K3w
    # and K4 once per step; no K3 (serving).
    counts = require_launched("train path", before, PATH_LAUNCHES["train"])
    require(cam_e.grad is not None
            and tuple(cam_e.grad.shape) == ENTRY[:3]
            and bool(torch.isfinite(cam_e.grad).all()),
            "entry() camera gradient")

    # K2 as the path ran it, outside the counted window: entry()'s camera
    # gradient against the plain closed-form VJP fed the same cotangent,
    # the head's gradient (K8h, K8hb, as the path's) on K1's volume.
    _, _, _, De, ke = ENTRY
    cfg_e = StereoConfig(kernel_size=ke, num_disparities=De)
    cam_d = cam_e.detach()
    cost = cost_volume_banded_cuda(cam_d, proj_e, De, ke, cfg_e.epsilon)
    cost = cost.detach().requires_grad_(True)
    soft = StereoMatcher(cfg_e).disparity(cost).soft_disparity
    (g,) = torch.autograd.grad(soft.mean(), cost)
    want = camera_grad_banded(cam_d, proj_e, g, De, ke, cfg_e.epsilon)
    compare_grad(cam_e.grad, want, "train path: entry() camera gradient "
                 "against the plain VJP on its head cotangent",
                 elementwise=True)
    del cost, soft, g, want
    losses = losses.cpu().tolist()
    print(f"train path: entry() camera gradient {tuple(cam_e.grad.shape)} "
          f"finite, norm {float(cam_e.grad.norm()):.6e}; optimize_camera "
          f"{TRAIN_STEPS} steps at {H}x{W} D={D} k={k} lr={TRAIN_LR}: "
          f"losses {losses}")
    require(all(np.isfinite(losses)), "every loss finite")
    require(losses[-1] < losses[0], "the last loss below the first")
    require(bool(torch.isfinite(camera).all()), "optimised camera finite")

    # Host-clock time of a whole step (K3w, loss, K4, Adam), synchronised.
    state = init_state(camera0, adam(TRAIN_LR))
    step = make_train_step(model)
    times = []
    for _ in range(TIMED_STEPS):
        t0 = time.perf_counter()
        state, metrics = step(state, proj, target)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    step_ms = 1e3 * float(np.median(times[1:]))
    print(f"train path: step host-clock median {step_ms:.3f} ms over "
          f"{TIMED_STEPS - 1} steps (first dropped); peak device memory "
          f"of the path {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    counts["step_ms"] = step_ms
    return counts


# K8 at the verify shape's height: k = 3 and 129 (the largest the JAX
# op's shapes reach), and a width that is no multiple of the block tile.
AP_EXTRA = [(1, 330, 422, 3), (1, 330, 422, 129), (1, 330, 401, 15)]


def phase_k8() -> float:
    err = 0.0
    shapes = AP_SHAPES + [(1,) + VERIFY] + AP_EXTRA + [AP_WIDE]
    for i, (B, H, W, k) in enumerate(shapes):
        cam, proj = uniform_pair(500 + i, B, H, W)
        got = cost_volume_allpairs_cuda(cam, proj, k, EPS)
        want = forward_allpairs(cam, proj, k, EPS)
        require(tuple(got.shape) == (B, H, W, W), f"K8 shape {(B, H, W, W)}")
        err = max(err, compare_volume(got, want, f"B={B} H={H} W={W} k={k}",
                                      kernel="K8"))
        del got, want
        torch.cuda.empty_cache()
    return err


# K8b (B, H, W, k): the JAX suite's all-pairs shapes and a batch, the
# verify shape, k = 1, a batch of 3, windows wider than the image (k // 2
# > W), K8's large-k route (k = 145) and a combine past its block (k =
# 201: the large-k route's combine).
K8B_SHAPES = AP_SHAPES + [(1,) + VERIFY, (1, 330, 422, 1), (3, 40, 90, 7),
                          (2, 20, 6, 31), (1, 9, 5, 13), (1, 330, 422, 145),
                          (1, 40, 130, 201)]


def phase_k8b() -> float:
    """K8b against the plain closed form ``camera_grad_allpairs`` on the
    card, both on K8's volume (its statistics K8b's) and a random
    cotangent at a mean loss's scale, held as the other VJPs are
    (rtol/atol per pixel at the smaller shapes, the norm everywhere); at
    k = 1 both are exactly zero.  One launch a call; from k = 145 the
    volume takes the large-k route."""
    err = 0.0
    for i, (B, H, W, k) in enumerate(K8B_SHAPES):
        label = (f"K8b B={B} H={H} W={W} k={k} (first tap, taps "
                 f"{km.allpairs_grad_taps(W, k)})")
        cam, proj = uniform_pair(560 + i, B, H, W)
        before = COUNTS.copy()
        cost, stats = allpairs_volume_and_stats(cam, proj, k, EPS)
        require(launched(before)["route.K8"] == (k >= 145),
                f"{label}: the volume's route")
        g = torch.randn((B, H, W, W), device="cuda",
                        generator=torch.Generator("cuda").manual_seed(i))
        g *= 1.0 / (H * W)
        before = COUNTS.copy()
        got = camera_grad_allpairs_cuda(cam, proj, g, cost, stats, k, EPS)
        require(launched(before)["K8b"] == 1, f"{label}: one launch")
        want = camera_grad_allpairs(cam, proj, g, cost, k, EPS)
        if k == 1:
            torch.cuda.synchronize()
            require(torch.equal(got, want) and not bool(got.any()),
                    f"{label}: exactly zero, as the plain version")
            print(f"{label}: exactly zero, as the plain version")
        else:
            err = max(err, compare_grad(got, want, label,
                                        elementwise=B * H * W * W <= 20e6))
        del cost, stats, g, got, want
        torch.cuda.empty_cache()
    return err


# K8h's soft map against the plain head's: the head's rtol, and an atol
# for the cancellation in w - corr all-pairs (corr's rounding in the
# order of the sums, a few ulp of L: 1.5e-4 px at L = 422).
HEAD_SOFT_RTOL, HEAD_SOFT_ATOL = 1e-4, 1e-3
# K8h / K8hb (B, H, W, D or None for all-pairs): the verify shape (8-byte
# loads), all-pairs at KITTI's width (three row tiles), KITTI's band (L =
# 193: 4-byte loads), L = 64 (16-byte loads) and a band past one tile.
K8H_SHAPES = [(1, 330, 422, None), (1, 40, 1242, None), (1, 375, 1242, 192),
              (2, 40, 300, 63), (1, 20, 700, 599)]


def head_grad_plain(cost, D: int, g_soft, g_conf):
    """The plain head's cost cotangent through autograd."""
    leaf = cost.detach().clone().requires_grad_(True)
    r = extract_disparity(leaf, D, THRESHOLD, 50.0)
    return torch.autograd.grad((r.soft_disparity, r.confidence), leaf,
                               (g_soft, g_conf))[0]


def phase_volume_head(card: str) -> dict:
    """K8h and K8hb against the plain head on the card: on K8's volume at
    the verify shape, K1's at KITTI and random volumes in [-1, 1] with
    exact ties (the maximum repeated at a later index); the hard map, the
    mask and the confidence bit-equal, the soft map within rtol 1e-4 /
    atol 1e-3 px (the atol: w - corr cancels all-pairs),
    the cost cotangent of a mean loss's scale held as the camera VJPs'
    (``compare_grad``); one launch of each a call.  Then both timed at
    330x422, B = 1, beside the plain head's forward and its autograd
    backward and their bounds by bytes.  Returns {key: (max abs error of
    the soft map and cotangent, kernel ms, plain ms, (bound ms, by))}."""
    err = {"K8h": 0.0, "K8hb": 0.0}
    for i, (B, H, W, D) in enumerate(K8H_SHAPES):
        label = f"B={B} H={H} W={W} " + ("all-pairs" if D is None
                                          else f"D={D}")
        if (H, W, D) == VERIFY[:2] + (None,):
            cost = cost_volume_allpairs_cuda(
                *uniform_pair(1700 + i, B, H, W), VERIFY[2], EPS)
        elif (H, W, D) == KITTI[:3]:
            cost = cost_volume_banded_cuda(
                *uniform_pair(1700 + i, B, H, W), D, KITTI[3], EPS)
        else:
            L = W if D is None else D + 1
            gen = torch.Generator("cuda").manual_seed(i)
            cost = torch.rand((B, H, W, L), device="cuda",
                              generator=gen) * 2 - 1
            rows = cost.view(-1, L)[::3]
            top = rows.amax(-1) + 0.05
            rows[:, L // 3] = top
            rows[:, L // 2] = top
        before = COUNTS.copy()
        leaf = cost.detach().clone().requires_grad_(True)
        got = extract_disparity_cuda(leaf, D, THRESHOLD, 50.0)
        want = extract_disparity(cost, D, THRESHOLD, 50.0)
        torch.cuda.synchronize()
        for name in ("disparity", "mask", "confidence"):
            require(torch.equal(getattr(got, name), getattr(want, name)),
                    f"K8h {label}: {name} bit-equal to the plain head's")
        soft_err = float((got.soft_disparity - want.soft_disparity)
                         .abs().max())
        require(torch.allclose(got.soft_disparity, want.soft_disparity,
                               rtol=HEAD_SOFT_RTOL, atol=HEAD_SOFT_ATOL),
                f"K8h {label}: soft map within rtol {HEAD_SOFT_RTOL} / atol "
                f"{HEAD_SOFT_ATOL} px")
        gen = torch.Generator("cuda").manual_seed(100 + i)
        n = got.confidence.numel()
        g_soft, g_conf = (torch.randn(got.confidence.shape, device="cuda",
                                      generator=gen) / n for _ in range(2))
        (grad,) = torch.autograd.grad((got.soft_disparity, got.confidence),
                                      leaf, (g_soft, g_conf))
        require_launched(f"K8h {label}", before,
                         Counter({"K8h": 1, "K8hb": 1}))
        grad_err = compare_grad(grad, head_grad_plain(cost, D, g_soft,
                                                      g_conf),
                                f"K8hb {label}", elementwise=True)
        ties = int((cost == want.confidence[..., None]).sum(-1).gt(1)
                   .sum())
        print(f"K8h {label}: hard map, mask and confidence bit-equal; soft "
              f"max_abs {soft_err:.3e}; {ties} pixels with a tied maximum")
        err["K8h"] = max(err["K8h"], soft_err)
        err["K8hb"] = max(err["K8hb"], grad_err)
        del cost, leaf, got, want, grad, g_soft, g_conf
        torch.cuda.empty_cache()

    # Times at the verify shape, on K8's volume.
    H, W, k = VERIFY
    cam, proj = uniform_pair(1, 1, H, W)
    with torch.no_grad():
        cost = cost_volume_allpairs_cuda(cam, proj, k, EPS)
        maps, resid = cuda_head._head_forward(cost, None, THRESHOLD, 50.0,
                                              False)
    g_soft = torch.randn((1, H, W), device="cuda",
                         generator=torch.Generator("cuda").manual_seed(1))
    g_soft *= 1.0 / (H * W)
    leaf = cost.clone().requires_grad_(True)
    plain = extract_disparity(leaf, None, THRESHOLD, 50.0)
    entries, pixels = cost.numel(), H * W
    fwd = interleaved(
        "K8h", cuda_head._head_forward,
        extract_disparity, (cost, None, THRESHOLD, 50.0, False),
        (cost, None, THRESHOLD, 50.0), f"{H}x{W} all-pairs", card)
    bwd = interleaved(
        "K8hb", cuda_head._head_vjp,
        lambda: torch.autograd.grad(plain.soft_disparity, leaf, g_soft,
                                    retain_graph=True),
        (cost, maps.confidence, resid, g_soft, None, True, THRESHOLD, 50.0,
         False), (), f"{H}x{W} all-pairs", card)
    # Bytes: K8h reads the volume and writes four maps and three
    # residuals; K8hb reads the volume, the confidence, the residuals and
    # the cotangent and writes the volume's cotangent.
    out = {"K8h": (err["K8h"], fwd[0], fwd[1],
                   bound(0, 4 * (entries + 7 * pixels))),
           "K8hb": (err["K8hb"], bwd[0], bwd[1],
                    bound(0, 4 * (2 * entries + 5 * pixels)))}
    for name, (e, ms, plain_ms, (b_ms, by)) in out.items():
        print(f"bound: {name} {b_ms:.4f} ms by {by}; the kernel takes "
              f"{ms:.4f} ms, {ms / b_ms:.2f} times its bound; the plain "
              f"head {plain_ms:.4f} ms ({card})")
    del cam, proj, cost, maps, resid, g_soft, leaf, plain
    torch.cuda.empty_cache()
    return out


def phase_k7() -> float:
    err = 0.0
    shapes = (K7_SHAPES + [shape for shape, _ in EDGE] + K7_LARGE_K
              + [(1,) + KITTI])
    for i, (B, H, W, D, k) in enumerate(shapes):
        cam, proj = uniform_pair(600 + i, B, H, W)
        # A random cotangent at a mean loss's scale, as phase_k2's.
        g = torch.randn((B, D + 1, H, W), device="cuda",
                        generator=torch.Generator("cuda").manual_seed(i))
        g *= 1.0 / (H * W)
        cost = cost_volume_banded_cuda(cam, proj, D, k, EPS)
        got = projector_grad_banded_cuda(cam, proj, cost.permute(0, 3, 1, 2),
                                         g, D, k, EPS)
        want = projector_grad_banded(cam, proj, cost, g.permute(0, 2, 3, 1),
                                     D, k, EPS)
        kitti = (H, W, D, k) == KITTI
        err = max(err, compare_grad(
            got, want, f"K7 B={B} H={H} W={W} D={D} k={k} (planes a round "
            f"{km.grad_round(k, D, False, False)[0]})",
            elementwise=not kitti))
        del g, cost, got, want
    return err


def phase_allpairs_path() -> dict:
    H, W, k = VERIFY
    model = StereoMatcher(StereoConfig(kernel_size=k, backend="cuda"))
    require(model.config.num_disparities is None,
            "the default config is all-pairs")
    cam_np, proj_np, truth = make_stereo_pair(H, W, d_min=2.0, d_max=12.0,
                                              noise=0.01, seed=0)
    cam = torch.from_numpy(cam_np[None]).cuda().requires_grad_(True)
    proj = torch.from_numpy(proj_np[None]).cuda()
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    before = COUNTS.copy()
    t0 = time.perf_counter()
    out = model(cam, proj)
    out.soft_disparity.mean().backward()
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0)
    # K8, K8b and the head's K8h and K8hb once each.
    counts = require_launched("all-pairs path", before,
                              PATH_LAUNCHES["allpairs"])
    require(tuple(out.cost_volume.shape) == (1, H, W, W)
            and bool(torch.isfinite(out.cost_volume).all())
            and bool(torch.isfinite(out.soft_disparity).all()),
            "all-pairs forward output")
    require(cam.grad is not None and tuple(cam.grad.shape) == (1, H, W),
            "all-pairs camera gradient")
    mask = out.mask[0].bool().cpu().numpy()
    soft = out.soft_disparity[0].detach().cpu().numpy()
    coverage = float(mask.mean())
    epe = float(np.abs(soft - truth)[mask].mean())
    print(f"all-pairs path: {H}x{W} k={k} forward + head + backward "
          f"{step_ms:.3f} ms host clock (first call); coverage "
          f"{coverage:.4f}, EPE {epe:.4f} px on confident pixels; peak "
          f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
          f"GiB")
    require(coverage > 0.5 and epe < 1.0, "all-pairs accuracy")
    del out

    # The plain node (plain volume, plain VJP) on the same inputs, outside
    # the counted run.
    cam_p = cam.detach().clone().requires_grad_(True)
    plain = StereoMatcher(StereoConfig(kernel_size=k, backend="torch"))
    plain(cam_p, proj).soft_disparity.mean().backward()
    compare_grad(cam.grad, cam_p.grad, f"all-pairs path: camera gradient "
                 f"against the plain node at {H}x{W} k={k}",
                 elementwise=True)
    counts["step_ms"] = step_ms
    return counts


def phase_grad_projector_path() -> dict:
    H, W, D, k = KITTI
    model = StereoMatcher(StereoConfig(kernel_size=k, num_disparities=D,
                                       grad_projector=True))
    cams, projs, _ = speckle_frames(1, seed=80)
    cam = torch.from_numpy(cams).cuda().requires_grad_(True)
    proj = torch.from_numpy(projs).cuda().requires_grad_(True)
    torch.cuda.synchronize()

    before = COUNTS.copy()
    model(cam, proj).soft_disparity.mean().backward()
    torch.cuda.synchronize()
    # K1, K2, K7 and the head's K8h and K8hb once each.
    counts = require_launched("grad_projector path", before,
                              PATH_LAUNCHES["grad_projector"])
    for name, grad in (("camera", cam.grad), ("projector", proj.grad)):
        require(grad is not None and tuple(grad.shape) == (1, H, W)
                and bool(torch.isfinite(grad).all()),
                f"grad_projector path: {name} gradient")

    # Both gradients against the plain closed forms fed the same head
    # cotangent, the head's gradient (K8h, K8hb, as the path's) on K1's
    # volume.
    cam_d, proj_d = cam.detach(), proj.detach()
    cost = cost_volume_banded_cuda(cam_d, proj_d, D, k, EPS)
    cost = cost.detach().requires_grad_(True)
    (g,) = torch.autograd.grad(model.disparity(cost).soft_disparity.mean(),
                               cost)
    want_c = camera_grad_banded(cam_d, proj_d, g, D, k, EPS)
    want_p = projector_grad_banded(cam_d, proj_d, cost.detach(), g, D, k,
                                   EPS)
    compare_grad(cam.grad, want_c, "grad_projector path: camera gradient "
                 "against the plain VJP on its head cotangent",
                 elementwise=False)
    compare_grad(proj.grad, want_p, "grad_projector path: projector "
                 "gradient against the plain VJP on its head cotangent",
                 elementwise=False)
    del cost, g, want_c, want_p

    # Each backward kernel runs only for an input that needs its gradient.
    B, He, We, De, ke = ENTRY
    cam_e, proj_e = uniform_pair(81, B, He, We)
    proj_e.requires_grad_(True)
    small = StereoMatcher(StereoConfig(kernel_size=ke, num_disparities=De,
                                       grad_projector=True))
    before = COUNTS.copy()
    small(cam_e, proj_e).soft_disparity.mean().backward()
    require_launched("grad_projector path: projector-only gradient", before,
                     Counter({"K1": 1, "K8h": 1, "K8hb": 1, "K7": 1}))
    print("grad_projector path: a projector-only gradient launches K7 and "
          "not K2")
    return counts


def mean_loss_cotangent(seed: int, B: int, H: int, W: int, D: int):
    """A random plane-major cotangent at a mean loss's scale (1 / (H W)),
    the regime of the JAX suite's gradient tolerance."""
    g = torch.randn((B, D + 1, H, W), device="cuda",
                    generator=torch.Generator("cuda").manual_seed(seed))
    return g * (1.0 / (H * W))


# Past the card's shared memory the recompute stages the projector tile in
# chunks of planes: K6 at k=15 beyond D = 734 (camera_grad.cuh), K5 at
# k=15 beyond D = 567 and at k=25 beyond D ~ 97 (fused_pipeline_bwd.cu).
# (B, H, W, D, k); W > D, so the planes of every chunk reach into the
# image.
K6_CHUNKED = (1, 16, 1800, 1600, 15)
K5_CHUNKED = [((1, 32, 800, 600, 15), 50.0), ((1, 40, 400, 192, 25), 50.0),
              ((1, 40, 300, 64, 27), 80.0)]


def phase_k6() -> float:
    err = 0.0
    shapes = (SHAPES + [shape for shape, _ in EDGE + LARGE_K]
              + [K6_CHUNKED, (1,) + KITTI])
    for i, (B, H, W, D, k) in enumerate(shapes):
        cam, proj = uniform_pair(700 + i, B, H, W)
        g = mean_loss_cotangent(700 + i, B, H, W, D)
        g_parity = g.permute(0, 2, 3, 1).contiguous()
        want = camera_grad_banded(cam, proj, g_parity, D, k, EPS)
        kitti = (H, W, D, k) == KITTI
        label = (f"B={B} H={H} W={W} D={D} k={k} (round/chunk "
                 f"{km.grad_round(k, D, False, True)})")
        got = camera_grad_banded_cuda(cam, proj, None, g, D, k, EPS)
        err = max(err, compare_grad(got, want, f"K6 plane-major {label}",
                                    elementwise=not kitti))
        got_p = camera_grad_banded_parity_cuda(cam, proj, g_parity, D, k,
                                               EPS)
        err = max(err, compare_grad(got_p, want, f"K6 parity (K9b + K6) "
                                    f"{label}", elementwise=not kitti))
        # K9b's staging is exact, so both entries run K6 on one cotangent.
        require(torch.equal(got_p, got), f"K6 {label}: both entries equal")
        if kitti or (B, H, W, D, k) == K6_CHUNKED:
            cost = cost_volume_banded_cuda(cam, proj, D, k, EPS)
            with_cost = camera_grad_banded_cuda(
                cam, proj, cost.permute(0, 3, 1, 2), g, D, k, EPS)
            compare_grad(got, with_cost, f"K6 against K2 (cost residual) "
                         f"{label}", elementwise=False)
            same = torch.equal(got, with_cost)
            print(f"K6 {label}: bit-equal to K2: {same}")
            require(same, f"K6 {label} bit-equal to K2")
            del cost, with_cost
        del g, g_parity, want, got, got_p
    return err


# K9 besides the small shapes and KITTI: two frames at an H W that is not
# a multiple of 4 (3,333 pixels), and D = 1800, whose planes K9a stages
# in eight chunks of 226.
K9_EXTRA = [(2, 33, 101, 30, 0), (1, 40, 130, 1800, 0)]


def phase_k9() -> float:
    for i, (B, H, W, D, _) in enumerate(SHAPES + [(1,) + KITTI] + K9_EXTRA):
        vol = torch.randn((B, D + 1, H, W), device="cuda",
                          generator=torch.Generator("cuda").manual_seed(i))
        label = (f"B={B} H={H} W={W} D={D} (K9a planes in "
                 f"{km.parity_chunks(D + 1)[0]} chunks)")
        parity = plane_major_to_parity(vol)
        require(torch.equal(parity, vol.permute(0, 2, 3, 1).contiguous()),
                f"K9a {label}: bit-equal to permute().contiguous()")
        back = parity_to_plane_major(parity)
        require(torch.equal(back, vol), f"K9b {label}: bit-equal to "
                f"permute().contiguous()")
        # One frame without the batch axis.
        require(torch.equal(plane_major_to_parity(vol[0]), parity[0])
                and torch.equal(parity_to_plane_major(parity[0]), vol[0]),
                f"K9a/b {label}: an unbatched frame")
        print(f"K9a/b {label}: bit-equal to permute().contiguous() both "
              f"ways, batched and unbatched")
        del vol, parity, back
    return 0.0


def phase_k3m() -> float:
    err = 0.0
    for label, cam, proj, D, k, beta in train_cases():
        maps, res = fused_pipeline_train_cuda(cam, proj, D, k, EPS, beta,
                                              THRESHOLD, save_volume=False)
        serving = stereo_pipeline_cuda(cam, proj, D, k, EPS, beta, THRESHOLD)
        res_w = fused_pipeline_train_cuda(cam, proj, D, k, EPS, beta,
                                          THRESHOLD)[1]
        require(res.volume is None, f"K3m {label}: no volume")
        for name in maps._fields:
            require(torch.equal(getattr(maps, name), getattr(serving, name)),
                    f"K3m {label}: {name} bit-equal to K3's")
        for name in ("am", "s", "t"):
            require(torch.equal(getattr(res, name), getattr(res_w, name)),
                    f"K3m {label}: {name} bit-equal to K3w's")
        # The confidence against the plain volume's maximum.
        conf = forward_banded(cam, proj, D, k, EPS).amax(-1)
        e = float((maps.confidence - conf).abs().max())
        require(e <= 1e-5, f"K3m {label}: confidence within 1e-5 of the "
                           f"plain volume's max")
        err = max(err, e)
        print(f"K3m {label}: maps bit-equal to K3, am/s/t bit-equal to "
              f"K3w; confidence max_abs {e:.3e} against the plain volume")
        del maps, res, serving, res_w, conf
    return err


def phase_k5() -> float:
    err = 0.0
    chunked = []
    for j, ((B, H, W, D, k), beta) in enumerate(K5_CHUNKED):
        cam, proj = uniform_pair(850 + j, B, H, W)
        chunked.append((f"chunked B={B} H={H} W={W} D={D} k={k} "
                        f"beta={beta}", cam, proj, D, k, beta))
    for i, (label, cam, proj, D, k, beta) in enumerate(train_cases()
                                                       + chunked):
        B, H, W = cam.shape
        kitti = (H, W, D, k) == KITTI
        gs, gc = cotangents(800 + i, B, H, W)
        # K5 and its plain twin on the same residual maps (K3m's).
        res = fused_pipeline_train_cuda(cam, proj, D, k, EPS, beta,
                                        THRESHOLD, save_volume=False)[1]
        got = fused_pipeline_bwd_cuda(cam, proj, res, gs, gc, D, k, EPS,
                                      beta)
        want = fused_pipeline_bwd_reference(cam, proj, res, gs, gc, D, k,
                                            EPS, beta)
        err = max(err, compare_grad(got, want, f"K5 {label}",
                                    elementwise=not kitti))
        # K4 on K3w's residuals: the same maps, the cost read, not
        # recomputed.
        res_w = fused_pipeline_train_cuda(cam, proj, D, k, EPS, beta,
                                          THRESHOLD)[1]
        with_cost = fused_pipeline_bwd_cuda(cam, proj, res_w, gs, gc, D, k,
                                            EPS, beta)
        compare_grad(got, with_cost, f"K5 against K4 {label}",
                     elementwise=False)
        if kitti:
            print(f"K5 {label}: bit-equal to K4: "
                  f"{torch.equal(got, with_cost)}")
        del res, got, want, res_w, with_cost
    return err


# K4, K5, K6 and K7 one k past the limit of their first versions (K4 47,
# K5 27, K6 81, K7 93) and at k = 127, each at this edge shape (H not a
# multiple of 16, W not of 64, D + 1 not of a slab) and at KITTI.
PAST_LIMITS = {"K4": (49, 127), "K5": (29, 127), "K6": (83, 127),
               "K7": (95, 127)}
PAST_LIMITS_EDGE = (1, 37, 200, 20)


def k5_peak_bytes(cam, proj, res, gs, gc, D: int, k: int) -> int:
    """Device memory K5's call allocates at its peak, beyond what was
    allocated before it."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fused_pipeline_bwd_cuda(cam, proj, res, gs, gc, D, k, EPS, 50.0)
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def phase_past_limits() -> dict:
    """K4, K5, K6 and K7 at the k of PAST_LIMITS, against their plain
    versions; K6 bit-equal to K2 and K5 to K4 on K1's volume."""
    errs = {name: 0.0 for name in PAST_LIMITS}
    B0, H0, W0, D0 = PAST_LIMITS_EDGE
    edge = uniform_pair(870, B0, H0, W0)
    cams, projs, _ = speckle_frames(1, seed=7)
    kitti = (torch.from_numpy(cams).cuda(), torch.from_numpy(projs).cuda())
    for name, ks in PAST_LIMITS.items():
        for k in ks:
            for (cam, proj), D in ((edge, D0), (kitti, KITTI[2])):
                B, H, W = cam.shape
                at_kitti = (H, W, D, k) == KITTI[:3] + (k,)
                consts = ("staged" if km.k4_staged(k, D)
                          else "from their maps")
                label = (f"{name} B={B} H={H} W={W} D={D} k={k} (K4 "
                         f"constants {consts}, K5 slab "
                         f"{km.cost_slab_planes('K5', k, D)}, K6 slab "
                         f"{km.cost_slab_planes('K6', k, D)} planes)")
                gs, gc = cotangents(880 + k, B, H, W)
                g = mean_loss_cotangent(880 + k, B, H, W, D)
                cost = cost_volume_banded_cuda(cam, proj, D, k, EPS)
                if name == "K4":
                    res = fused_pipeline_train_cuda(cam, proj, D, k, EPS,
                                                    50.0, THRESHOLD)[1]
                    got = fused_pipeline_bwd_cuda(cam, proj, res, gs, gc, D,
                                                  k, EPS, 50.0)
                    want = fused_pipeline_bwd_reference(cam, proj, res, gs,
                                                        gc, D, k, EPS, 50.0)
                elif name == "K5":
                    res = fused_pipeline_train_cuda(
                        cam, proj, D, k, EPS, 50.0, THRESHOLD,
                        save_volume=False)[1]
                    got = fused_pipeline_bwd_cuda(cam, proj, res, gs, gc, D,
                                                  k, EPS, 50.0)
                    want = fused_pipeline_bwd_reference(cam, proj, res, gs,
                                                        gc, D, k, EPS, 50.0)
                    # K4 on K1's volume: the same costs, read.
                    on_k1 = fused_pipeline_bwd_cuda(
                        cam, proj, HeadResiduals(*res[:5],
                                                 cost.permute(0, 3, 1, 2)),
                        gs, gc, D, k, EPS, 50.0)
                    same = torch.equal(got, on_k1)
                    print(f"{label}: bit-equal to K4 on K1's volume: {same}")
                    require(same, f"{label}: bit-equal to K4 on K1's volume")
                    res_w = fused_pipeline_train_cuda(cam, proj, D, k, EPS,
                                                      50.0, THRESHOLD)[1]
                    with_cost = fused_pipeline_bwd_cuda(cam, proj, res_w, gs,
                                                        gc, D, k, EPS, 50.0)
                    compare_grad(got, with_cost, f"{label}: against K4 on "
                                 f"K3w's residuals", elementwise=False)
                    print(f"{label}: bit-equal to K4 on K3w's residuals: "
                          f"{torch.equal(got, with_cost)}")
                    del on_k1, res_w, with_cost
                elif name == "K6":
                    got = camera_grad_banded_cuda(cam, proj, None, g, D, k,
                                                  EPS)
                    want = camera_grad_banded(cam, proj,
                                              g.permute(0, 2, 3, 1), D, k,
                                              EPS)
                    with_cost = camera_grad_banded_cuda(
                        cam, proj, cost.permute(0, 3, 1, 2), g, D, k, EPS)
                    same = torch.equal(got, with_cost)
                    print(f"{label}: bit-equal to K2 on K1's volume: {same}")
                    require(same, f"{label}: bit-equal to K2")
                    del with_cost
                else:
                    got = projector_grad_banded_cuda(
                        cam, proj, cost.permute(0, 3, 1, 2), g, D, k, EPS)
                    want = projector_grad_banded(cam, proj, cost,
                                                 g.permute(0, 2, 3, 1), D, k,
                                                 EPS)
                errs[name] = max(errs[name], compare_grad(
                    got, want, label, elementwise=not at_kitti))
                del cost, got, want, g
                torch.cuda.empty_cache()

    # K5's peak device memory at KITTI, k = 15 (its halo kernel) and
    # k = 127 (the chunked route): no [D + 1, H, W] volume either way.
    H, W, D, _ = KITTI
    cam, proj = kitti
    gs, gc = cotangents(890, 1, H, W)
    volume = 4 * (D + 1) * H * W
    peaks = {}
    for k in (15, 127):
        res = fused_pipeline_train_cuda(cam, proj, D, k, EPS, 50.0, THRESHOLD,
                                        save_volume=False)[1]
        peaks[k] = k5_peak_bytes(cam, proj, res, gs, gc, D, k)
        del res
    print(f"K5 peak device memory of its call at {H}x{W} D={D}: k=15 "
          f"{peaks[15] / 2**20:.1f} MiB, k=127 {peaks[127] / 2**20:.1f} MiB "
          f"(one volume is {volume / 2**20:.1f} MiB)")
    require(peaks[127] < volume, "K5 at k = 127 holds no whole volume")
    return errs


def adam_steps(camera0, loss_of, steps: int):
    """``steps`` Adam steps of ``loss_of(camera)`` from ``camera0``, each
    synchronised: (losses, host-clock seconds a step, peak device memory
    of a step above what was allocated before it)."""
    state = init_state(camera0, adam(TRAIN_LR))
    losses, times, peaks = [], [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        state.optimizer.zero_grad(set_to_none=True)
        loss = loss_of(state.camera)
        loss.backward()
        state.optimizer.step()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        peaks.append(torch.cuda.max_memory_allocated() - base)
        losses.append(float(loss.detach()))
    return losses, times, max(peaks)


def phase_volume_free_path() -> dict:
    H, W, D, k = KITTI
    cfg = StereoConfig(kernel_size=k, num_disparities=D)
    cams, projs, _ = speckle_frames(1, seed=60)
    true_cam = torch.from_numpy(cams).cuda()
    proj = torch.from_numpy(projs).cuda()
    with torch.no_grad():
        target = StereoMatcher(cfg).disparity_maps(true_cam,
                                                   proj).soft_disparity
    noise = np.random.default_rng(61).standard_normal(cams.shape)
    camera0 = true_cam + torch.from_numpy(
        (TRAIN_NOISE * noise).astype(np.float32)).cuda()

    def loss_fn(save_volume: bool):
        # optimize_camera's loss (disparity_loss): the soft disparity's
        # mean squared error against the target.
        def loss_of(camera):
            maps = stereo_pipeline_trainable(
                camera, proj, D, k, cfg.epsilon, cfg.softargmax_beta,
                cfg.cost_threshold, save_volume=save_volume)
            err = maps.soft_disparity - target
            return torch.mean(err * err)
        return loss_of

    torch.cuda.synchronize()
    before = COUNTS.copy()
    losses, _, _ = adam_steps(camera0, loss_fn(False), TRAIN_STEPS)
    # K3m and K5 once per step; no K3, K3w or K4.
    counts = require_launched("volume-free path", before,
                              PATH_LAUNCHES["volume_free"])
    print(f"volume-free path: {TRAIN_STEPS} Adam steps at {H}x{W} D={D} "
          f"k={k} lr={TRAIN_LR}: losses {losses}")
    require(all(np.isfinite(losses)), "every loss finite")
    require(losses[-1] < losses[0], "the last loss below the first")

    # Outside the counted run: the K5 gradient against the K4 one on the
    # same inputs (K3m's maps are K3w's bit for bit).
    grads = []
    for save_volume in (False, True):
        c = camera0.clone().requires_grad_(True)
        loss_fn(save_volume)(c).backward()
        grads.append(c.grad)
    compare_grad(grads[0], grads[1], "volume-free path: K5 camera gradient "
                 "against the save_volume (K4) gradient", elementwise=False)
    del grads

    # Host-clock step time and peak device memory of a step, each mode
    # timed in turns (free, saved, saved, free), the first step dropped.
    steps = {False: [], True: []}
    peak = {False: 0, True: 0}
    for save_volume in (False, True, True, False):
        _, times, p = adam_steps(camera0, loss_fn(save_volume),
                                 TIMED_STEPS)
        steps[save_volume] += times[1:]
        peak[save_volume] = max(peak[save_volume], p)
    step_ms = {s: 1e3 * float(np.median(t)) for s, t in steps.items()}
    print(f"volume-free path: step host-clock median {step_ms[False]:.3f} "
          f"ms (K3m + K5) against {step_ms[True]:.3f} ms (K3w + K4); peak "
          f"device memory of a step {peak[False] / 2**20:.1f} MiB against "
          f"{peak[True] / 2**20:.1f} MiB, "
          f"{(peak[True] - peak[False]) / 2**20:.1f} MiB less (one volume "
          f"is {4 * (D + 1) * H * W / 2**20:.1f} MiB)")
    require(peak[False] < peak[True], "the volume-free step holds less")
    counts.update(step_ms=step_ms[False], saved_step_ms=step_ms[True])
    return counts


def phase_plane_major_path() -> dict:
    H, W, D, k = KITTI
    cfg = StereoConfig(kernel_size=k, num_disparities=D)
    model = StereoMatcher(cfg)
    cams, projs, _ = speckle_frames(1, seed=90)
    cam0 = torch.from_numpy(cams).cuda()
    proj = torch.from_numpy(projs).cuda()

    def plane_major(camera):
        vol = stereo_matching_hdw(camera, proj, D, k, cfg.epsilon)
        r = extract_disparity_hdw(vol, D, H, W, cfg.cost_threshold,
                                  cfg.softargmax_beta)
        r.soft_disparity.mean().backward()
        return vol

    def parity(camera):
        out = model(camera, proj)
        out.soft_disparity.mean().backward()
        return out.cost_volume

    torch.cuda.synchronize()
    before = COUNTS.copy()
    cam = cam0.clone().requires_grad_(True)
    vol = plane_major(cam)
    torch.cuda.synchronize()
    # K1 and K2 once each; no K6, K7 or layout kernel.
    counts = require_launched("plane-major path", before,
                              PATH_LAUNCHES["plane_major"])
    require(tuple(vol.shape) == (1, D + 1, H, W)
            and bool(torch.isfinite(vol).all()), "plane-major volume")
    require(vol.is_contiguous(), "the plane-major volume is K1's buffer")
    del vol

    cam_p = cam0.clone().requires_grad_(True)
    parity(cam_p)
    compare_grad(cam.grad, cam_p.grad, "plane-major path: camera gradient "
                 "against the parity path's (StereoMatcher.__call__)",
                 elementwise=False)

    # Host-clock step time of both paths, in turns (parity, plane-major,
    # plane-major, parity), the first step of each turn dropped.
    times = {"parity": [], "plane_major": []}
    for name in ("parity", "plane_major", "plane_major", "parity"):
        run = plane_major if name == "plane_major" else parity
        for i in range(TIMED_STEPS):
            c = cam0.clone().requires_grad_(True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(c)
            torch.cuda.synchronize()
            if i:
                times[name].append(time.perf_counter() - t0)
    ms = {name: 1e3 * float(np.median(t)) for name, t in times.items()}
    print(f"plane-major path: step (forward, head, backward) host-clock "
          f"median {ms['plane_major']:.3f} ms against the parity path's "
          f"{ms['parity']:.3f} ms at {H}x{W} D={D} k={k}")
    counts.update(step_ms=ms["plane_major"], parity_step_ms=ms["parity"])
    return counts


def phase_no_residual_path() -> dict:
    """The camera VJP when the forward volume is not kept: K1's volume,
    K9a to the parity layout, the head and its cotangent (K8h, K8hb),
    then the restaged K6 entry (K9b, K6)."""
    H, W, D, k = KITTI
    cfg = StereoConfig(kernel_size=k, num_disparities=D)
    cams, projs, _ = speckle_frames(1, seed=100)
    cam, proj = torch.from_numpy(cams).cuda(), torch.from_numpy(projs).cuda()
    torch.cuda.synchronize()

    def step():
        with torch.no_grad():
            parity_vol = plane_major_to_parity(
                stereo_matching_hdw(cam, proj, D, k, cfg.epsilon))
        parity_vol.requires_grad_(True)
        soft = StereoMatcher(cfg).disparity(parity_vol).soft_disparity
        (g,) = torch.autograd.grad(soft.mean(), parity_vol)
        del parity_vol, soft
        return g, camera_grad_banded_parity_cuda(cam, proj, g, D, k,
                                                 cfg.epsilon)

    before = COUNTS.copy()
    g, grad = step()
    torch.cuda.synchronize()
    # K1, K9a, K8h, K8hb, K9b and K6 once each; no K2 without the cost
    # residual.
    counts = require_launched("no-residual VJP path", before,
                              PATH_LAUNCHES["no_residual"])
    require(tuple(grad.shape) == (1, H, W)
            and bool(torch.isfinite(grad).all()), "camera gradient")
    want = camera_grad_banded(cam, proj, g, D, k, cfg.epsilon)
    compare_grad(grad, want, "no-residual VJP path: camera gradient against "
                 "the plain VJP on its head cotangent", elementwise=False)
    del g, grad, want

    # Host-clock time of the whole step, synchronised, the first dropped.
    times = []
    for _ in range(TIMED_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    counts["step_ms"] = 1e3 * float(np.median(times[1:]))
    print(f"no-residual VJP path: step (K1, K9a, K8h, K8hb, K9b, K6) "
          f"host-clock median {counts['step_ms']:.3f} ms at {H}x{W} D={D} "
          f"k={k}")
    return counts


def compare_probe(got, want, rtol: float, label: str) -> float:
    """A K10 probe's output against its plain twin within ``rtol`` (0:
    bit-equal); returns max abs."""
    torch.cuda.synchronize()
    require(bool(torch.isfinite(got).all()), f"{label}: non-finite output")
    diff = (got - want).abs()
    max_rel = float((diff / want.abs().clamp_min(1e-30)).max())
    print(f"{label}: max_abs {float(diff.max()):.3e} max_rel {max_rel:.3e} "
          f"(rtol {rtol})")
    require(torch.equal(got, want) if rtol == 0 else max_rel <= rtol,
            f"{label}: " + ("bit-equal to its plain twin" if rtol == 0
                            else f"within rtol {rtol} of its plain twin"))
    return float(diff.max())


def phase_k10() -> dict:
    """K10a in every mode, at a small launch and at its measuring size;
    K10b and K10c at KITTI's volume; each against its plain twin."""
    err = {"K10a": 0.0}
    for mode in K10A_MODES:
        for blocks, iters in ((2, 16), km.rate_probe_size(mode)):
            got = km.rate_probe(mode, iters, blocks)
            want = km.rate_probe_reference(mode, iters, blocks,
                                           km.rate_probe_cols(mode), "cuda")
            err["K10a"] = max(err["K10a"], compare_probe(
                got, want, 1e-5, f"K10a {mode} blocks={blocks} "
                f"iters={iters} (value {float(got[0, 0]):.7f})"))
            require(bool((got == got[0, 0]).all()),
                    f"K10a {mode}: every chain holds one value")
            del got, want
    err["K10b"] = err["K10c"] = 0.0
    gen = torch.Generator("cuda").manual_seed(10)
    for P, H, W in (km.HBM_SHAPE,) + km.HBM_EDGE_SHAPES:
        # A volume that starts 4 bytes off a 16-byte boundary, then one
        # that starts on it (torch's allocation).
        flat = torch.rand(P * H * W + 1, device="cuda", generator=gen)
        for off in (1, 0):
            vol = flat[off:off + P * H * W].view(P, H, W)
            err["K10b"] = max(err["K10b"], compare_probe(
                km.hbm_read_probe(vol), km.hbm_read_reference(vol), 1e-5,
                f"K10b plane sums of [{P}, {H}, {W}], {4 * off} bytes off "
                f"a 16-byte boundary"))
        del flat, vol
        err["K10c"] = max(err["K10c"], compare_probe(
            km.hbm_write_probe(P, H, W),
            km.hbm_write_reference(P, H, W, "cuda"), 0,
            f"K10c out[d, h, w] = d over [{P}, {H}, {W}]"))
    torch.cuda.empty_cache()
    return err


def phase_bound_model(card: str):
    """The bound model's path, counted: every rate measured anew
    into the rates cache, then the card health probe against it.
    Returns (what it launched, rates)."""
    torch.cuda.synchronize()
    before = COUNTS.copy()
    t0 = time.perf_counter()
    rates = km.measure_vpu_rates(force=True, cache_path=str(km.CACHE_PATH))
    seconds = time.perf_counter() - t0
    rc = device_probe.main([])
    # K10a in every mode, K10b and K10c in each of three rounds.
    counts = require_launched("bound model", before,
                              PATH_LAUNCHES["bound_model"], at_least=True)
    require(rc == 0, "device_probe finds the card healthy")
    print(f"bound model: rates measured in {seconds:.1f} s into "
          f"{km.CACHE_PATH.relative_to(km.CACHE_PATH.parents[2])}: "
          f"{json.dumps(rates)}")
    per_s = {m: 1.0 / rates[m] for m in rates}
    print(f"rate: madd {2 * per_s['madd'] / 1e12:.3f} TFLOP/s (data sheet "
          f"{PEAK_FLOPS / 1e12:.0f}); hbm_r3d {per_s['hbm_r3d'] / 1e12:.3f} "
          f"and hbm_w3d {per_s['hbm_w3d'] / 1e12:.3f} TB/s (data sheet "
          f"{PEAK_BYTES / 1e12:.2f}); t3d {per_s['t3d'] / 1e12:.3f} and "
          f"dus3d {per_s['dus3d'] / 1e12:.3f} TB/s read and written; smem "
          f"{per_s['smem'] / 1e12:.3f} T loads/s; boxadd "
          f"{per_s['boxadd'] / 1e12:.3f} T pass loads/s; exp "
          f"{per_s['exp'] / 1e12:.3f} and rsqrt {per_s['rsqrt'] / 1e12:.3f} "
          f"T results/s ({card})")
    return counts, rates


def timed(label: str, fn, *args) -> float:
    ms = 1e3 * benchmark(fn, *args, warmup=2, iters=10, chain=3)["median_s"]
    print(f"time: {label} median {ms:.4f} ms")
    return ms


def interleaved(name: str, kernel, plain, kargs, pargs, where: str,
                card: str, library=None):
    """(kernel ms, plain ms, library ms or None), timed plain, library,
    kernel, kernel, library, plain; ``library`` is one PyTorch call that
    computes the kernel's function, taking ``pargs``."""
    order = ["plain", "library", "kernel", "kernel", "library", "plain"]
    calls = {"kernel": (kernel, kargs), "plain": (plain, pargs),
             "library": (library, pargs)}
    samples = {"kernel": [], "plain": [], "library": []}
    with torch.no_grad():
        for what in order:
            fn, args = calls[what]
            if fn is not None:
                samples[what].append(timed(f"{name} {what}", fn, *args))
    ms = tuple(sum(s) / len(s) if s else None
               for s in (samples["kernel"], samples["plain"],
                         samples["library"]))
    lib = f", library {ms[2]:.4f} ms" if library is not None else ""
    print(f"time: {name} at {where}: kernel {ms[0]:.4f} ms, plain "
          f"{ms[1]:.4f} ms{lib} ({card})")
    return ms


def model_costs() -> dict:
    """Each kernel's counted work (``utils/kernel_model.py``) at the size
    phase_times runs it."""
    H, W, D, k = KITTI
    Hv, Wv, kv = VERIFY
    blocks = km.rate_probe_size("madd")[0]
    return {
        "K8": km.allpairs_forward_cost(Hv, Wv, kv),
        "K8b": km.allpairs_grad_cost(Hv, Wv, kv),
        "K1": km.volume_forward_cost(H, W, D, k),
        "K3": km.fused_forward_cost(H, W, D, k),
        "K2": km.volume_backward_cost(H, W, D, k),
        "K7": km.projector_backward_cost(H, W, D, k),
        "K3w": km.fused_forward_cost(H, W, D, k, write_volume=True),
        "K4": km.fused_backward_c_cost(H, W, D, k),
        "K6": km.volume_backward_cost(H, W, D, k, with_cost=False),
        "K3m": km.fused_forward_cost(H, W, D, k, residuals=True),
        "K5": km.fused_backward_cost(H, W, D, k),
        "K9a": km.to_parity_cost(H, W, D),
        "K9b": km.transpose_volume_cost(H, W, D),
        "K10a": km.rate_probe_cost("madd", blocks, K10A_TIMED_ITERS),
        "K10b": km.hbm_read_probe_cost(*km.HBM_SHAPE),
        "K10c": km.hbm_write_probe_cost(*km.HBM_SHAPE),
    }


def model_bound(cost, rates: dict):
    """(ms, what bounds it, {class: ms, "memory": ms}): ``cost`` priced at
    the measured ``rates``, bound by the class that takes the longest or
    by ``memory``."""
    b = km.kernel_bound(cost, rates)
    by = (max(b["by_class"], key=b["by_class"].get)
          if b["bound_by"] == "compute" else "memory")
    parts = {m: 1e3 * t for m, t in b["by_class"].items()}
    parts["memory"] = 1e3 * b["t_memory_s"]
    return 1e3 * b["bound_s"], by, parts


def phase_times(card: str, rates: dict) -> dict:
    """Times and bounds of every kernel: {key: (kernel ms, plain ms,
    library ms or None, (bound ms, bound by), (model ms, model by))}."""
    # K8 at the all-pairs path's shape.
    Hv, Wv, kv = VERIFY
    acam, aproj = uniform_pair(1, 1, Hv, Wv)
    ap = (acam, aproj, kv, EPS)
    times = {"K8": interleaved("K8", cost_volume_allpairs_cuda,
                               forward_allpairs, ap, ap,
                               f"{Hv}x{Wv} k={kv}", card)
             + (allpairs_bound(1, Hv, Wv, kv),)}
    # K8b on K8's volume, its bound the VJP's mandatory traffic.
    with torch.no_grad():
        acost, astats = allpairs_volume_and_stats(acam, aproj, kv, EPS)
    ag = torch.randn((1, Hv, Wv, Wv), device="cuda",
                     generator=torch.Generator("cuda").manual_seed(1))
    ag *= 1.0 / (Hv * Wv)
    times["K8b"] = interleaved(
        "K8b", camera_grad_allpairs_cuda, camera_grad_allpairs,
        (acam, aproj, ag, acost, astats, kv, EPS),
        (acam, aproj, ag, acost, kv, EPS), f"{Hv}x{Wv} k={kv}", card) + (
        bound(0, km.allpairs_backward_cost(Hv, Wv, kv).bytes),)
    del acam, aproj, ap, acost, astats, ag
    torch.cuda.empty_cache()

    H, W, D, k = KITTI
    cam, proj = uniform_pair(0, 1, H, W)
    cams, projs, _ = speckle_frames(1, seed=7)
    scam, sproj = torch.from_numpy(cams).cuda(), torch.from_numpy(projs).cuda()
    vol = (cam, proj, D, k, EPS)
    pipe = (scam, sproj, D, k, EPS, 50.0, THRESHOLD)
    with torch.no_grad():
        cost = cost_volume_banded_cuda(cam, proj, D, k, EPS)
        g = torch.randn((1, D + 1, H, W), device="cuda",
                        generator=torch.Generator("cuda").manual_seed(0))
        res = fused_pipeline_train_cuda(*pipe)[1]
        res_m = fused_pipeline_train_cuda(*pipe, False)[1]
        g_parity = g.permute(0, 2, 3, 1).contiguous()
    gs, gc = cotangents(1, 1, H, W)
    k2_args = (cam, proj, cost.permute(0, 3, 1, 2), g, D, k, EPS)
    plain_vjp = (cam, proj, g.permute(0, 2, 3, 1), D, k, EPS)
    bwd = (scam, sproj, res, gs, gc, D, k, EPS, 50.0)
    bwd_free = (scam, sproj, res_m, gs, gc, D, k, EPS, 50.0)
    cases = (
        ("K1", cost_volume_banded_cuda, forward_banded, vol, vol, None),
        ("K3", stereo_pipeline_cuda, stereo_pipeline_reference, pipe, pipe,
         None),
        ("K2", camera_grad_banded_cuda, camera_grad_banded, k2_args,
         plain_vjp, None),
        ("K7", projector_grad_banded_cuda, projector_grad_banded, k2_args,
         (cam, proj, cost) + plain_vjp[2:], None),
        ("K3w", fused_pipeline_train_cuda, fused_pipeline_train_reference,
         pipe, pipe, None),
        ("K4", fused_pipeline_bwd_cuda, fused_pipeline_bwd_reference, bwd,
         bwd, None),
        ("K6", camera_grad_banded_cuda, camera_grad_banded,
         (cam, proj, None, g, D, k, EPS), plain_vjp, None),
        ("K3m", fused_pipeline_train_cuda, fused_pipeline_train_reference,
         pipe + (False,), pipe + (False,), None),
        ("K5", fused_pipeline_bwd_cuda, fused_pipeline_bwd_reference,
         bwd_free, bwd_free, None),
        ("K9a", plane_major_to_parity, plane_major_to_parity_reference,
         (g,), (g,), lambda v: v.permute(0, 2, 3, 1).contiguous()),
        ("K9b", parity_to_plane_major, parity_to_plane_major_reference,
         (g_parity,), (g_parity,),
         lambda v: v.permute(0, 3, 1, 2).contiguous()),
    )
    bounds = banded_bounds(1, H, W, D, k)
    for name, kernel, plain, kargs, pargs, library in cases:
        times[name] = interleaved(name, kernel, plain, kargs, pargs,
                                  f"KITTI {H}x{W} D={D} k={k}", card,
                                  library) + (bounds[name],)
    del cases, vol, pipe, cam, proj, scam, sproj, cost, g, res, res_m
    del g_parity, k2_args, plain_vjp, bwd, bwd_free
    torch.cuda.empty_cache()

    # The probes: K10a's madd chains (an FMA is two operations), K10b and
    # K10c at KITTI's volume (K10b adds each entry once).
    blocks = km.rate_probe_size("madd")[0]
    cols, it = km.rate_probe_cols("madd"), K10A_TIMED_ITERS
    times["K10a"] = interleaved(
        "K10a", km.rate_probe, km.rate_probe_reference,
        ("madd", it, blocks, "cuda"), ("madd", it, blocks, cols, "cuda"),
        f"madd {blocks} blocks x {it} iterations", card) + (
        bound(2 * blocks * cols * it, 4 * blocks * cols),)
    P, Hp, Wp = km.HBM_SHAPE
    n = P * Hp * Wp
    probe_vol = torch.rand(km.HBM_SHAPE, device="cuda",
                           generator=torch.Generator("cuda").manual_seed(11))
    times["K10b"] = interleaved(
        "K10b", km.hbm_read_probe, km.hbm_read_reference, (probe_vol,),
        (probe_vol,), f"[{P}, {Hp}, {Wp}]", card,
        lambda v: v.sum(0)) + (bound(n, 4 * (n + Hp * Wp)),)
    del probe_vol
    times["K10c"] = interleaved(
        "K10c", km.hbm_write_probe, km.hbm_write_reference,
        (P, Hp, Wp, "cuda"), (P, Hp, Wp, "cuda"), f"[{P}, {Hp}, {Wp}]",
        card, lambda P, H, W, device: torch.arange(
            P, dtype=torch.float32, device=device).view(P, 1, 1).expand(
            P, H, W).contiguous()) + (bound(0, 4 * n),)
    torch.cuda.empty_cache()

    costs = model_costs()
    for name in times:
        m_ms, m_by, parts = model_bound(costs[name], rates)
        times[name] += ((m_ms, m_by),)
        ms, (b_ms, by) = times[name][0], times[name][3]
        shown = ", ".join(f"{m} {t:.4f}" for m, t in parts.items())
        print(f"bound: {name} {b_ms:.4f} ms by {by}, model {m_ms:.4f} ms by "
              f"{m_by} ({shown}); the kernel takes {ms / b_ms:.2f} times its "
              f"bound and {ms / m_ms:.3f} times its model ({card})")
        if not name.startswith("K10"):
            require(m_ms <= ms, f"{name}: its model bound ({m_ms:.4f} ms) "
                    f"within its time ({ms:.4f} ms)")
    print_before(times, card)
    return times


def print_before(times: dict, card: str) -> None:
    """Each kernel of ``times`` beside its ``MS_BEFORE`` time."""
    for name, before in MS_BEFORE.items():
        if name in times:
            ms = times[name][0]
            print(f"time: {name} ms {ms:.4f} ms_before {before:.4f} "
                  f"({before / ms:.2f} times faster; {card})")


def phase_large_k_times(card: str, rates: dict) -> dict:
    """K4, K5, K6 and K7 at KITTI with k = 127 (the routes of
    PAST_LIMITS): {name: (ms, (bound ms, by), (model ms, by))}, each
    printed; no kernel may beat its model."""
    H, W, D, _ = KITTI
    k = 127
    cams, projs, _ = speckle_frames(1, seed=7)
    cam, proj = torch.from_numpy(cams).cuda(), torch.from_numpy(projs).cuda()
    gs, gc = cotangents(1, 1, H, W)
    g = mean_loss_cotangent(0, 1, H, W, D)
    with torch.no_grad():
        cost = cost_volume_banded_cuda(cam, proj, D, k, EPS)
        res = fused_pipeline_train_cuda(cam, proj, D, k, EPS, 50.0,
                                        THRESHOLD)[1]
        res_m = fused_pipeline_train_cuda(cam, proj, D, k, EPS, 50.0,
                                          THRESHOLD, save_volume=False)[1]
    cases = {
        "K4": (fused_pipeline_bwd_cuda,
               (cam, proj, res, gs, gc, D, k, EPS, 50.0),
               km.fused_backward_c_cost(H, W, D, k)),
        "K5": (fused_pipeline_bwd_cuda,
               (cam, proj, res_m, gs, gc, D, k, EPS, 50.0),
               km.fused_backward_cost(H, W, D, k)),
        "K6": (camera_grad_banded_cuda, (cam, proj, None, g, D, k, EPS),
               km.volume_backward_cost(H, W, D, k, with_cost=False)),
        "K7": (projector_grad_banded_cuda,
               (cam, proj, cost.permute(0, 3, 1, 2), g, D, k, EPS),
               km.projector_backward_cost(H, W, D, k)),
    }
    bounds = banded_bounds(1, H, W, D, k)
    out = {}
    with torch.no_grad():
        for name, (fn, args, cost_count) in cases.items():
            ms = timed(f"{name} KITTI k={k}", fn, *args)
            m_ms, m_by, _ = model_bound(cost_count, rates)
            b_ms, by = bounds[name]
            print(f"large k: {name} at KITTI {H}x{W} D={D} k={k}: "
                  f"{ms:.4f} ms, bound {b_ms:.4f} ms by {by}, model "
                  f"{m_ms:.4f} ms by {m_by} ({ms / b_ms:.2f} times its "
                  f"bound, {ms / m_ms:.3f} times its model; {card})")
            require(m_ms <= ms, f"{name} k={k}: its model bound "
                    f"({m_ms:.4f} ms) within its time ({ms:.4f} ms)")
            out[name] = (ms, (b_ms, by), (m_ms, m_by))
    del cases, cost, res, res_m, g
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# K8 at k = 1, the large-k route, the left-right serving path, the pyramid
# and the failsafe layer
# ---------------------------------------------------------------------------

# K8 at k = 1: the JAX suite's all-pairs shapes and the verify shape.
AP_K1 = [(B, H, W, 1) for B, H, W, _ in AP_SHAPES] + [(1, 330, 422, 1)]


def phase_k8_k1() -> float:
    err = 0.0
    for i, (B, H, W, k) in enumerate(AP_K1):
        cam, proj = uniform_pair(1500 + i, B, H, W)
        got = cost_volume_allpairs_cuda(cam, proj, k, EPS)
        want = forward_allpairs(cam, proj, k, EPS)
        err = max(err, compare_volume(got, want, f"B={B} H={H} W={W} k={k}",
                                      kernel="K8"))
        del got, want
    torch.cuda.empty_cache()
    return err


def phase_allpairs_k1_path() -> dict:
    """The default all-pairs matcher at k = 1, counted: forward,
    head (K8h) and backward of a mean soft-disparity loss at 330x422; K8
    once, the plain volume never; the camera gradient against the plain
    node's."""
    H, W, _ = VERIFY
    model = StereoMatcher(StereoConfig(kernel_size=1, backend="cuda"))
    cam0, proj = uniform_pair(1510, 1, H, W)
    cam = cam0.clone().requires_grad_(True)
    torch.cuda.synchronize()
    before = COUNTS.copy()
    out = model(cam, proj)
    out.soft_disparity.mean().backward()
    torch.cuda.synchronize()
    # K8, K8b, K8h and K8hb once each; the plain volume unused at k = 1.
    counts = require_launched("all-pairs k=1 path", before,
                              PATH_LAUNCHES["allpairs_k1"])
    want = forward_allpairs(cam0, proj, 1, EPS)
    compare_volume(out.cost_volume.detach(), want,
                   f"all-pairs k=1 path: volume at {H}x{W}", kernel="K8")
    cam_p = cam0.clone().requires_grad_(True)
    StereoMatcher(StereoConfig(kernel_size=1, backend="torch"))(
        cam_p, proj).soft_disparity.mean().backward()
    # At k = 1 the centred values vanish (E2 = 0, and A1 - box(GRMU) = 0),
    # so the closed-form gradient is zero up to rounding on both sides
    # (K8b's is exactly zero).
    diff = float((cam.grad - cam_p.grad).abs().max())
    print(f"all-pairs k=1 path: camera gradient max |got| "
          f"{float(cam.grad.abs().max()):.3e}, max |plain| "
          f"{float(cam_p.grad.abs().max()):.3e}, max |got - plain| "
          f"{diff:.3e}")
    require(bool(torch.isfinite(cam.grad).all())
            and diff <= GRAD_ATOL + GRAD_RTOL * float(
                cam_p.grad.abs().max()),
            f"all-pairs k=1 path: camera gradient within rtol {GRAD_RTOL} "
            f"/ atol {GRAD_ATOL} of the plain node's")
    del out, want
    torch.cuda.empty_cache()
    return counts


# The routes of the large-k path: key and the base kernel it stands in
# for, whose name its calls count under (``route.<base>``).
LARGE_ROUTES = {f"{base}L": base for base in ("K1", "K3", "K3w", "K3m",
                                              "K2", "K6", "K4", "K5", "K7",
                                              "K8")}
# (B, H, W, D) of the large-k checks: an edge shape, a batch, and the
# shape of the large-k path (phase 26).
LK_SHAPES = [(1, 37, 200, 20), (2, 24, 150, 10), (1, 40, 130, 24)]
LK_K = (129, 131)
# K8 past its strip (B, H, W, k).
LK_AP = [(1, 40, 130, 145), (2, 24, 100, 147)]
# K4's own route takes k <= 185; the large-k route from 187.
K4_LARGE_K = 187


def _head(res, gs, gc, beta, D):
    return (res.am, res.mask, res.confidence, res.s, res.t, gs, gc, beta,
            unnormalized_head(beta, D))


def phase_large_k() -> dict:
    """Every kernel past its blocks (k = 129 and 131; K7 at 129, its
    ValueError at 131; K8 at 145 and 147; K4's route at 187) against its
    plain version on the card: volumes rtol 1e-4 / atol 1e-5, K3's maps
    as phase 4, gradients rtol 1e-3 / atol 1e-6 and norm-relative 1e-4.
    K3w's volume is K1's bit for bit, K3w's and K3m's maps K3's, K3m's
    am/s/t K3w's; K6 is K2 on K1's volume and K5 the large-k route of K4
    on it, bit for bit.  Returns each route's max abs error."""
    errs = dict.fromkeys(LARGE_ROUTES, 0.0)
    errs["K4"] = 0.0
    for i, (B, H, W, D) in enumerate(LK_SHAPES):
        for k in LK_K:
            label = f"B={B} H={H} W={W} D={D} k={k}"
            require(all(km.large_k_route(n, k, D) for n in
                        ("K1", "K3", "K2", "K5", "K6", "K7")),
                    f"{label}: the large-k route is taken")
            cam, proj = uniform_pair(1600 + i + k, B, H, W)
            vol = cost_volume_banded_cuda(cam, proj, D, k, EPS)
            want = forward_banded(cam, proj, D, k, EPS)
            errs["K1L"] = max(errs["K1L"], compare_volume(
                vol, want, f"{label} large-k route", kernel="K1"))
            for beta in (50.0, 80.0):
                got = stereo_pipeline_cuda(cam, proj, D, k, EPS, beta,
                                           THRESHOLD)
                ref = stereo_pipeline_reference(cam, proj, D, k, EPS, beta,
                                                THRESHOLD)
                errs["K3L"] = max(errs["K3L"], compare_maps(
                    got, ref, want, THRESHOLD, False,
                    f"{label} beta={beta} large-k route"))
                maps, res = fused_pipeline_train_cuda(cam, proj, D, k, EPS,
                                                      beta, THRESHOLD)
                maps_m, res_m = fused_pipeline_train_cuda(
                    cam, proj, D, k, EPS, beta, THRESHOLD, save_volume=False)
                require(torch.equal(res.volume.permute(0, 2, 3, 1), vol),
                        f"K3w {label}: volume bit-equal to K1's")
                for name in got._fields:
                    require(torch.equal(getattr(maps, name),
                                        getattr(got, name))
                            and torch.equal(getattr(maps_m, name),
                                            getattr(got, name)),
                            f"K3w/K3m {label}: {name} bit-equal to K3's")
                for name in ("am", "s", "t"):
                    require(torch.equal(getattr(res, name),
                                        getattr(res_m, name)),
                            f"K3m {label}: {name} bit-equal to K3w's")
                am, _, s, t = head_residuals(want, D, beta)
                tie = top2_ties(want)
                require(not bool(((res.am != am) & ~tie).any()),
                        f"K3w {label}: argmax differs only at top-two ties")
                s_err = float(((res.s - s).abs() / s).max())
                t_err = float(((res.t - t).abs() / (t + s)).max())
                require(s_err <= 1e-3 and t_err <= 1e-3,
                        f"K3w {label}: s within rtol 1e-3, t within 1e-3 "
                        f"(t + s)")
                print(f"K3w/K3m {label} beta={beta} large-k route: maps "
                      f"bit-equal to K3's, volume to K1's; |ds|/s "
                      f"{s_err:.3e}, |dt|/(t+s) {t_err:.3e}")
                errs["K3wL"] = max(errs["K3wL"], errs["K3L"])
                errs["K3mL"] = max(errs["K3mL"], errs["K3L"])
            g = mean_loss_cotangent(1620 + k, B, H, W, D)
            pm = vol.permute(0, 3, 1, 2)
            k2 = camera_grad_banded_cuda(cam, proj, pm, g, D, k, EPS)
            k6 = camera_grad_banded_cuda(cam, proj, None, g, D, k, EPS)
            plain = camera_grad_banded(cam, proj, g.permute(0, 2, 3, 1), D,
                                       k, EPS)
            errs["K2L"] = max(errs["K2L"], compare_grad(
                k2, plain, f"K2 {label} large-k route", elementwise=True))
            errs["K6L"] = max(errs["K6L"], compare_grad(
                k6, plain, f"K6 {label} large-k route", elementwise=True))
            require(torch.equal(k6, k2), f"K6 {label}: bit-equal to K2 on "
                    f"K1's volume")
            gs, gc = cotangents(1630 + k, B, H, W)
            res = fused_pipeline_train_cuda(cam, proj, D, k, EPS, 50.0,
                                            THRESHOLD)[1]
            res_m = fused_pipeline_train_cuda(cam, proj, D, k, EPS, 50.0,
                                              THRESHOLD, save_volume=False)[1]
            want4 = fused_pipeline_bwd_reference(cam, proj, res, gs, gc, D,
                                                 k, EPS, 50.0)
            k4 = fused_pipeline_bwd_cuda(cam, proj, res, gs, gc, D, k, EPS,
                                         50.0)
            errs["K4"] = max(errs["K4"], compare_grad(
                k4, want4, f"K4 {label} (its rounds, constants from their "
                f"maps)", elementwise=True))
            k4l = lk.camera_grad_large(cam, proj, res.volume, None, D, k, EPS,
                                       head=_head(res, gs, gc, 50.0, D))
            errs["K4L"] = max(errs["K4L"], compare_grad(
                k4l, want4, f"K4 {label} large-k route (called)",
                elementwise=True))
            k5 = fused_pipeline_bwd_cuda(cam, proj, res_m, gs, gc, D, k, EPS,
                                         50.0)
            want5 = fused_pipeline_bwd_reference(cam, proj, res_m, gs, gc, D,
                                                 k, EPS, 50.0)
            errs["K5L"] = max(errs["K5L"], compare_grad(
                k5, want5, f"K5 {label} large-k route", elementwise=True))
            on_k1 = lk.camera_grad_large(cam, proj, pm, None, D, k, EPS,
                                         head=_head(res_m, gs, gc, 50.0, D))
            require(torch.equal(k5, on_k1), f"K5 {label}: bit-equal to the "
                    f"large-k route of K4 on K1's volume")
            if k <= K7_MAX_KERNEL_SIZE:
                k7 = projector_grad_banded_cuda(cam, proj, pm, g, D, k, EPS)
                want7 = projector_grad_banded(cam, proj, want,
                                              g.permute(0, 2, 3, 1), D, k,
                                              EPS)
                errs["K7L"] = max(errs["K7L"], compare_grad(
                    k7, want7, f"K7 {label} large-k route",
                    elementwise=True))
            else:
                torch.cuda.synchronize()
                before = COUNTS.copy()
                try:
                    projector_grad_banded_cuda(cam, proj, pm, g, D, k, EPS)
                    raised = False
                except ValueError as exc:
                    raised = "lane-aligned" in str(exc)
                require(raised and COUNTS == before,
                        f"K7 {label}: ValueError before any launch")
                print(f"K7 {label}: ValueError before any launch, as JAX's "
                      f"_proj_bwd_kernel")
            del vol, want, g, pm, k2, k6, plain, res, res_m, k4, k4l, k5
            torch.cuda.empty_cache()
    # K4's own large-k route, through the wrapper, where its rounds stop.
    B, H, W, D = LK_SHAPES[0]
    k = K4_LARGE_K
    cam, proj = uniform_pair(1690, B, H, W)
    gs, gc = cotangents(1691, B, H, W)
    require(km.large_k_route("K4", k, D), f"K4 takes the route at k={k}")
    res = fused_pipeline_train_cuda(cam, proj, D, k, EPS, 50.0, THRESHOLD)[1]
    got = fused_pipeline_bwd_cuda(cam, proj, res, gs, gc, D, k, EPS, 50.0)
    want = fused_pipeline_bwd_reference(cam, proj, res, gs, gc, D, k, EPS,
                                        50.0)
    errs["K4L"] = max(errs["K4L"], compare_grad(
        got, want, f"K4 B={B} H={H} W={W} D={D} k={k} large-k route",
        elementwise=True))
    for i, (B, H, W, k) in enumerate(LK_AP):
        cam, proj = uniform_pair(1700 + i, B, H, W)
        got = cost_volume_allpairs_cuda(cam, proj, k, EPS)
        want = forward_allpairs(cam, proj, k, EPS)
        errs["K8L"] = max(errs["K8L"], compare_volume(
            got, want, f"B={B} H={H} W={W} k={k} large-k route",
            kernel="K8"))
        del got, want
    torch.cuda.empty_cache()
    return errs


def phase_large_k_path() -> dict:
    """The large-k path, counted, through the entry points at
    k = 129 (40x130, D = 24): the matcher's forward and backward (K1 and
    K2 on the route), ``disparity_maps`` (K3), ``trainable_disparity_maps``
    (K3w on the route, K4 on its own rounds), the volume-free trainable
    pipeline (K3m, K5), ``grad_projector`` (K1, K2, K7), the parity VJP
    without the cost (K9b, K6); K4's route at k = 187; the all-pairs
    matcher at k = 145 (K8).  Every route runs, no plain twin does."""
    B, H, W, D = 1, 40, 130, 24
    k = LK_K[0]
    cam0, proj = uniform_pair(1750, B, H, W)
    cfg = StereoConfig(kernel_size=k, num_disparities=D)
    g_par = mean_loss_cotangent(1751, B, H, W, D).permute(0, 2, 3, 1)
    g_par = g_par.contiguous()
    torch.cuda.synchronize()
    before = COUNTS.copy()
    cam = cam0.clone().requires_grad_(True)
    StereoMatcher(cfg)(cam, proj).soft_disparity.mean().backward()
    with torch.no_grad():
        served = StereoMatcher(cfg).disparity_maps(cam0, proj)
    cam = cam0.clone().requires_grad_(True)
    t = StereoMatcher(cfg).trainable_disparity_maps(cam, proj)
    (t.soft_disparity.mean() + t.confidence.mean()).backward()
    cam = cam0.clone().requires_grad_(True)
    t = stereo_pipeline_trainable(cam, proj, D, k, EPS, 50.0, THRESHOLD,
                                  save_volume=False)
    (t.soft_disparity.mean() + t.confidence.mean()).backward()
    cam = cam0.clone().requires_grad_(True)
    pr = proj.clone().requires_grad_(True)
    StereoMatcher(dataclasses.replace(cfg, grad_projector=True))(
        cam, pr).soft_disparity.mean().backward()
    k6 = camera_grad_banded_parity_cuda(cam0, proj, g_par, D, k, EPS)
    cam = cam0.clone().requires_grad_(True)
    t = stereo_pipeline_trainable(cam, proj, D, K4_LARGE_K, EPS, 50.0,
                                  THRESHOLD)
    (t.soft_disparity.mean() + t.confidence.mean()).backward()
    cam = cam0.clone().requires_grad_(True)
    ap = StereoMatcher(StereoConfig(kernel_size=LK_AP[0][3]))(cam, proj)
    ap.soft_disparity.mean().backward()
    torch.cuda.synchronize()
    counts = launched(before)
    print(f"large-k path: launched {dict(sorted(counts.items()))}")
    for key, base in LARGE_ROUTES.items():
        require(counts[f"route.{base}"] >= 1,
                f"{key} ran on the large-k path")
    for entry in _build.SIGNATURES:
        if entry.startswith("custereo_lk_"):
            step = entry[len("custereo_lk_"):]
            require(counts[f"large_k.{step}"] >= 1,
                    f"the route's {step} kernel launched")
    require(counts["K4"] == 1 and counts["K9b"] == 1,
            "K4's own rounds at k=129 and K9b ran once")
    require(not plain_calls(counts), "plain twins unused on the large-k path")
    require(bool(torch.isfinite(served.soft_disparity).all())
            and bool(torch.isfinite(k6).all())
            and bool(torch.isfinite(cam.grad).all())
            and bool(torch.isfinite(pr.grad).all()),
            "large-k path outputs finite")
    torch.cuda.empty_cache()
    return counts


# The route choice pinned against the launchers: (B, H, W) and the D it
# is asked at.
PIN_SHAPE = (1, 20, 150)
PIN_D = (0, 24, 192)
CONFIG_REFUSALS = (1, 9)  # cudaErrorInvalidValue, ...InvalidConfiguration


def _pin_call(kernel: str, cam, proj, D: int, k: int,
              tile_rows: int = km.K_TILE_H):
    """``kernel``'s wrapper at (D, k), its inputs made first (outside the
    call): returns a function of no arguments that makes the call (K1, the
    K3 family and K4 at a tile of ``tile_rows`` rows, their own planes)."""
    B, H, W = cam.shape
    gen = torch.Generator("cuda").manual_seed(k + D)
    vol = torch.rand((B, D + 1, H, W), device="cuda", generator=gen)
    g = torch.rand((B, D + 1, H, W), device="cuda", generator=gen)
    pipe = (cam, proj, D, k, EPS, 50.0, THRESHOLD)
    if kernel in ("K4", "K5"):
        res = fused_pipeline_train_cuda(*pipe, save_volume=kernel == "K4")[1]
        gs, gc = cotangents(1950 + k, B, H, W)
        return lambda: fused_pipeline_bwd_cuda(cam, proj, res, gs, gc, D, k,
                                               EPS, 50.0, tile_rows)
    return {
        "K1": lambda: cost_volume_banded_cuda(cam, proj, D, k, EPS,
                                              tile_rows),
        "K3": lambda: stereo_pipeline_cuda(*pipe, tile_rows),
        "K3w": lambda: fused_pipeline_train_cuda(*pipe, True, tile_rows),
        "K3m": lambda: fused_pipeline_train_cuda(*pipe, False, tile_rows),
        "K2": lambda: camera_grad_banded_cuda(cam, proj, vol, g, D, k, EPS),
        "K6": lambda: camera_grad_banded_cuda(cam, proj, None, g, D, k, EPS),
        "K7": lambda: projector_grad_banded_cuda(cam, proj, vol, g, D, k,
                                                 EPS),
        "K8": lambda: cost_volume_allpairs_cuda(cam, proj, k, EPS),
    }[kernel]


def phase_route_pin(card: str) -> None:
    """The wrappers' route choice (``kernel_model.large_k_route`` at the
    card's opt-in budget, ``cuda_zncc.smem_floats``) against the C
    launchers, which size their blocks themselves: for every kernel and
    D in ``PIN_D``, at the last k before the route the wrapper launches
    the kernel's own blocks and they run; at the first k on the route the
    launcher, called with the route choice switched off, refuses its
    blocks (CUDA error 1 or 9) and launches nothing.  At every tile: the
    launchers' planes a round and chunk (``custereo_fused_rounds``,
    ``custereo_head_rounds``, which launch nothing) equal the model's
    (``fused_round``, ``grad_round``, ``k4_staged``) at every odd k to
    255, D in ``PIN_D`` and 1800 and several planes a round; and K1, the
    K3 family and K4 at the tiles other than the default take their own
    blocks at the last k before that tile's route and are refused at its
    first, as above."""
    from unittest import mock

    from custereomatching_tpu_torch.ops import cuda_allpairs, cuda_pipeline
    from custereomatching_tpu_torch.ops import cuda_zncc

    cam, proj = uniform_pair(1940, *PIN_SHAPE)
    budget = cuda_zncc.smem_floats(cam.device)
    print(f"route pin: opt-in shared memory {4 * budget} bytes a block "
          f"({budget} floats; the model's H100 default "
          f"{km.SMEM_OPTIN_BYTES}; {card})")
    for kernel in km.LARGE_K_KERNELS:
        own, route = kernel, f"route.{kernel}"
        for D in (PIN_D if kernel != "K8" else (0,)):
            first = next(k for k in range(3, 257, 2)
                         if km.large_k_route(kernel, k, D, budget))
            for k in (first - 2, first):
                call = _pin_call(kernel, cam, proj, D, k)
                torch.cuda.synchronize()
                before = (COUNTS[own], COUNTS[route])
                label = f"{kernel} D={D} k={k}"
                if k < first:
                    out = call()
                    torch.cuda.synchronize()
                    require((COUNTS[own], COUNTS[route])
                            == (before[0] + 1, before[1]),
                            f"route pin {label}: its own blocks launched")
                    del out
                    continue
                with contextlib.ExitStack() as stack:
                    for mod in (cuda_zncc, cuda_pipeline, cuda_allpairs):
                        stack.enter_context(mock.patch.object(
                            mod, "large_k_route", lambda *a, **kw: False))
                    try:
                        call()
                        code = 0
                    except RuntimeError as exc:
                        found = re.search(r"CUDA error (\d+)", str(exc))
                        code = int(found.group(1)) if found else -1
                torch.cuda.synchronize()
                require(code in CONFIG_REFUSALS
                        and (COUNTS[own], COUNTS[route]) == before,
                        f"route pin {label}: the launcher refuses its own "
                        f"blocks (CUDA error {code})")
            print(f"route pin {kernel} D={D}: own blocks run at k={first - 2}"
                  f", the launcher refuses k={first} (the route's first)")
    pin_tiles(card, cam, proj, budget)
    torch.cuda.empty_cache()


def pin_tiles(card: str, cam, proj, budget: int) -> None:
    """phase_route_pin at every tile: the launchers' rounds against the
    model's, and the tiled kernels' route choice."""
    from unittest import mock

    from custereomatching_tpu_torch.ops import cuda_pipeline

    lib = _build.kernels()
    out = (ctypes.c_int * 3)()
    n = 0
    for th in km.TILE_ROWS:
        for k in range(3, 257, 2):
            for D in PIN_D + (1800,):
                for planes in (0, 1, 7, 13, 40):
                    code = lib.custereo_fused_rounds(k, D, th, planes, out)
                    got = (out[0], out[1]) if code == 0 else (0, 0)
                    require(got == km.fused_round(k, D, budget, th, planes),
                            f"route pin: K1/K3 rounds at tile {th}, k={k}, "
                            f"D={D}, planes {planes}: launcher {got}, model "
                            f"{km.fused_round(k, D, budget, th, planes)}")
                code = lib.custereo_head_rounds(k, D, th, out)
                got = tuple(out) if code == 0 else (0, 0, 0)
                staged = km.k4_staged(k, D, budget, th)
                g = km.grad_round(k, D, True, False, staged, budget, th)
                want = (*g, int(staged)) if g[0] else (0, 0, 0)
                require(got == want, f"route pin: K4 rounds at tile {th}, "
                        f"k={k}, D={D}: launcher {got}, model {want}")
                n += 1
    print(f"route pin: the launchers' rounds equal the model's at {n} (tile, "
          f"k, D) cases, K1/K3 at 5 planes a round each ({card})")
    for kernel in TILE_KERNEL_KEYS:
        for th in OTHER_TILES:
            for D in PIN_D:
                first = next(k for k in range(3, 257, 2)
                             if km.large_k_route(kernel, k, D, budget, th))
                for k in (first - 2, first):
                    call = _pin_call(kernel, cam, proj, D, k, th)
                    torch.cuda.synchronize()
                    before = COUNTS[kernel]
                    label = f"{kernel} tile {th} D={D} k={k}"
                    if k < first:
                        result = call()
                        torch.cuda.synchronize()
                        require(COUNTS[kernel] == before + 1,
                                f"route pin {label}: its own blocks launched")
                        del result
                        continue
                    with contextlib.ExitStack() as stack:
                        for mod in (cuda_zncc, cuda_pipeline):
                            stack.enter_context(mock.patch.object(
                                mod, "large_k_route",
                                lambda *a, **kw: False))
                        try:
                            call()
                            code = 0
                        except RuntimeError as exc:
                            found = re.search(r"CUDA error (\d+)", str(exc))
                            code = int(found.group(1)) if found else -1
                    torch.cuda.synchronize()
                    require(code in CONFIG_REFUSALS
                            and COUNTS[kernel] == before,
                            f"route pin {label}: the launcher refuses its "
                            f"own blocks (CUDA error {code})")
                print(f"route pin {kernel} tile {th} D={D}: own blocks run "
                      f"at k={first - 2}, the launcher refuses k={first}")


def lk_interleaved(name: str, kernel, plain, kargs, pargs, where: str,
                   card: str):
    """(route ms, plain ms, route output, plain output): one warm call
    each, then three timed calls of the route, one of the plain version,
    CUDA events, route first and last; then one more call of each, whose
    outputs the caller compares."""
    with torch.no_grad():
        a = 1e3 * benchmark(kernel, *kargs, warmup=1, iters=3,
                            chain=1)["median_s"]
        p = 1e3 * benchmark(plain, *pargs, warmup=1, iters=1,
                            chain=1)["median_s"]
        b = 1e3 * benchmark(kernel, *kargs, warmup=0, iters=3,
                            chain=1)["median_s"]
        got, want = kernel(*kargs), plain(*pargs)
    ms = (a + b) / 2
    print(f"time: {name} at {where}: large-k route {ms:.4f} ms ({a:.4f}, "
          f"{b:.4f}), plain {p:.4f} ms ({card})")
    return ms, p, got, want


def compare_route(key: str, got, want, cost, label: str) -> float:
    """A route's output against its plain version's on the same inputs, at
    the tolerances the phases above hold their kernels to at KITTI:
    volumes rtol 1e-4 / atol 1e-5; K3's maps as phase 4 (mask flips
    within 1e-5 of the threshold, disparities apart only there or at
    top-two ties of ``cost``, the plain volume); K3w's and K3m's argmax
    apart only at those ties, s and t within 1e-3, K3w's volume as K1's;
    gradients norm-relative 1e-4.  Returns the max abs error."""
    base = LARGE_ROUTES[key]
    label = f"{label} large-k route"
    if base in ("K1", "K8"):
        return compare_volume(got, want, label, kernel=key)
    if base == "K3":
        return compare_maps(got, want, cost, THRESHOLD, False, label)
    if base in ("K3w", "K3m"):
        (maps, res), (maps_p, res_p) = got, want
        err = compare_maps(maps, maps_p, cost, THRESHOLD, False, label)
        require(not bool(((res.am != res_p.am) & ~top2_ties(cost)).any()),
                f"{key} {label}: argmax differs only at top-two ties")
        s_err = float(((res.s - res_p.s).abs() / res_p.s).max())
        t_err = float(((res.t - res_p.t).abs() / (res_p.t + res_p.s)).max())
        require(s_err <= 1e-3 and t_err <= 1e-3,
                f"{key} {label}: s within rtol 1e-3, t within 1e-3 (t + s)")
        print(f"{key} {label}: |ds|/s {s_err:.3e}, |dt|/(t+s) {t_err:.3e}")
        if base == "K3w":
            err = max(err, compare_volume(res.volume.permute(0, 2, 3, 1),
                                          cost, label, kernel=key))
        return err
    return compare_grad(got, want, f"{key} {label}", elementwise=False)


def phase_large_k_route_times(card: str, rates: dict):
    """Each route timed at KITTI (375x1242, D = 192, k = 129; K8 at
    330x422, k = 145) beside its plain version, its bound (least work of
    the function at the data sheet's peaks) and its model
    (``kernel_model.large_k_cost`` at this run's rates), which it may not
    beat, and its output held against the plain version's
    (:func:`compare_route`); K4's own rounds at k = 129 too.  ({key: (ms,
    plain ms, None, (bound ms, by), (model ms, by))}, {key: max abs
    error})."""
    out, errs = {}, {}
    Hv, Wv, _ = VERIFY
    kv = LK_AP[0][3]
    acam, aproj = uniform_pair(1800, 1, Hv, Wv)
    ms, p, got, want = lk_interleaved(
        "K8L", cost_volume_allpairs_cuda, forward_allpairs,
        (acam, aproj, kv, EPS), (acam, aproj, kv, EPS), f"{Hv}x{Wv} k={kv}",
        card)
    errs["K8L"] = compare_route("K8L", got, want, None,
                                f"B=1 H={Hv} W={Wv} k={kv}")
    out["K8L"] = (ms, p, None, allpairs_bound(1, Hv, Wv, kv),
                  model_bound(km.large_k_cost("K8", Hv, Wv, 0, kv),
                              rates)[:2])
    del acam, aproj, got, want
    torch.cuda.empty_cache()

    H, W, D, _ = KITTI
    k = LK_K[0]
    cams, projs, _ = speckle_frames(1, seed=7)
    cam, proj = torch.from_numpy(cams).cuda(), torch.from_numpy(projs).cuda()
    g = mean_loss_cotangent(1801, 1, H, W, D)
    gs, gc = cotangents(1802, 1, H, W)
    with torch.no_grad():
        vol = cost_volume_banded_cuda(cam, proj, D, k, EPS)
        plain_vol = forward_banded(cam, proj, D, k, EPS)
        res = fused_pipeline_train_cuda(cam, proj, D, k, EPS, 50.0,
                                        THRESHOLD)[1]
        res_m = fused_pipeline_train_cuda(cam, proj, D, k, EPS, 50.0,
                                          THRESHOLD, save_volume=False)[1]
    pm = vol.permute(0, 3, 1, 2)
    g_hwd = g.permute(0, 2, 3, 1)
    pipe = (cam, proj, D, k, EPS, 50.0, THRESHOLD)
    head = _head(res, gs, gc, 50.0, D)
    cases = {
        "K1L": (cost_volume_banded_cuda, forward_banded,
                (cam, proj, D, k, EPS), (cam, proj, D, k, EPS)),
        "K3L": (stereo_pipeline_cuda, stereo_pipeline_reference, pipe, pipe),
        "K3wL": (fused_pipeline_train_cuda, fused_pipeline_train_reference,
                 pipe, pipe),
        "K3mL": (fused_pipeline_train_cuda, fused_pipeline_train_reference,
                 pipe + (False,), pipe + (False,)),
        "K2L": (camera_grad_banded_cuda, camera_grad_banded,
                (cam, proj, pm, g, D, k, EPS), (cam, proj, g_hwd, D, k, EPS)),
        "K6L": (camera_grad_banded_cuda, camera_grad_banded,
                (cam, proj, None, g, D, k, EPS),
                (cam, proj, g_hwd, D, k, EPS)),
        "K4L": (lambda *a: lk.camera_grad_large(*a, head=head),
                fused_pipeline_bwd_reference,
                (cam, proj, res.volume, None, D, k, EPS),
                (cam, proj, res, gs, gc, D, k, EPS, 50.0)),
        "K5L": (fused_pipeline_bwd_cuda, fused_pipeline_bwd_reference,
                (cam, proj, res_m, gs, gc, D, k, EPS, 50.0),
                (cam, proj, res_m, gs, gc, D, k, EPS, 50.0)),
        "K7L": (projector_grad_banded_cuda, projector_grad_banded,
                (cam, proj, pm, g, D, k, EPS),
                (cam, proj, vol, g_hwd, D, k, EPS)),
    }
    bounds = banded_bounds(1, H, W, D, k)
    where = f"KITTI {H}x{W} D={D} k={k}"
    for key, (kernel, plain, kargs, pargs) in cases.items():
        base = LARGE_ROUTES[key]
        ms, p, got, want = lk_interleaved(key, kernel, plain, kargs, pargs,
                                          where, card)
        errs[key] = compare_route(key, got, want, plain_vol, where)
        out[key] = (ms, p, None, bounds[base],
                    model_bound(km.large_k_cost(base, H, W, D, k), rates)[:2])
        del got, want
        torch.cuda.empty_cache()
    with torch.no_grad():
        k4_ms = timed(f"K4 (its rounds, constants from their maps) KITTI "
                      f"k={k}", fused_pipeline_bwd_cuda, cam, proj, res, gs,
                      gc, D, k, EPS, 50.0)
    m4, by4, _ = model_bound(km.fused_backward_c_cost(H, W, D, k), rates)
    b4, bb4 = bounds["K4"]
    print(f"large k: K4 at KITTI {H}x{W} D={D} k={k} on its own rounds: "
          f"{k4_ms:.4f} ms, bound {b4:.4f} ms by {bb4}, model {m4:.4f} ms by "
          f"{by4} ({card})")
    require(m4 <= k4_ms, f"K4 k={k}: its model within its time")
    for key, (ms, p, _, (b_ms, by), (m_ms, m_by)) in out.items():
        print(f"large k: {key} route {ms:.4f} ms, plain {p:.4f} ms, bound "
              f"{b_ms:.4f} ms by {by}, model {m_ms:.4f} ms by {m_by} "
              f"({ms / b_ms:.1f} times its bound, {ms / m_ms:.2f} times its "
              f"model; {card})")
        require(m_ms <= ms, f"{key}: its model bound ({m_ms:.4f} ms) within "
                f"its time ({ms:.4f} ms)")
    print_before(out, card)
    del cases, vol, plain_vol, res, res_m, pm, g, g_hwd, head
    torch.cuda.empty_cache()
    return out, errs


# The left-right serving path: KITTI speckle frames in a 384x1280 bucket.
LR_RETRIES = 2


def phase_lr_engine(card: str) -> dict:
    """``StereoEngine(lr_check=True, retries=2)`` on the card: healthy(),
    then, counted, warm-up and 8 KITTI frames; K3 twice a frame (and
    twice for the warm-up), no plain twin; every frame's maps equal, bit
    for bit, two direct K3 calls (the pair, the flipped pair flipped
    back) composed with the plain ``lr_consistency_mask``; the check
    removes some confident pixels; coverage and EPE printed, and the
    per-frame median."""
    H, W, D, k = KITTI
    cfg = StereoConfig(kernel_size=k, num_disparities=D)
    engine = StereoEngine(cfg, buckets=[BUCKET], lr_check=True,
                          retries=LR_RETRIES, device="cuda")
    require(engine.healthy(), "engine.healthy() on the card")
    frames = speckle_frames(N_FRAMES, seed=40)
    before = COUNTS.copy()
    engine.warmup()
    served, latency = [], []
    for cam, proj in zip(frames[0], frames[1]):
        t0 = time.perf_counter()
        served.append(engine.infer(cam, proj))
        latency.append(time.perf_counter() - t0)
    # K3 twice per warm-up and served frame.
    counts = require_launched("lr engine", before, PATH_LAUNCHES["lr"])

    args = (D, k, cfg.epsilon, cfg.softargmax_beta, cfg.cost_threshold)
    removed = []
    for i, maps in enumerate(served):
        cam = torch.from_numpy(frames[0][i:i + 1]).cuda()
        proj = torch.from_numpy(frames[1][i:i + 1]).cuda()
        left = stereo_pipeline_cuda(cam, proj, *args)
        right = stereo_pipeline_cuda(proj.flip(-1), cam.flip(-1), *args)
        lr = lr_consistency_mask(left.soft_disparity,
                                 right.soft_disparity.flip(-1), D)
        composed = (left.disparity * lr, left.soft_disparity * lr,
                    left.mask * lr, left.confidence)
        for name, want in zip(maps._fields, composed):
            require(np.array_equal(getattr(maps, name),
                                   want[0].cpu().numpy()),
                    f"lr engine frame {i}: {name} equals two direct K3 calls "
                    f"composed with the mask")
        removed.append(float(((left.mask > 0) & (lr == 0)).float().mean()))
    require(min(removed) > 0,
            "the left-right check masks some confident pixels of every frame")
    mask = np.stack([m.mask for m in served]).astype(bool)
    soft = np.stack([m.soft_disparity for m in served])
    coverage = float(mask.mean())
    epe = float(np.abs(soft - frames[2])[mask].mean())
    median = 1e3 * float(np.median(latency))
    print(f"lr engine: {N_FRAMES} frames {H}x{W} in bucket {BUCKET}, "
          f"retries={LR_RETRIES}: every frame's maps bit-equal to two direct "
          f"K3 calls and the plain mask; the check removed "
          f"{min(removed):.4f}-{max(removed):.4f} of a frame's pixels from "
          f"its confident set; coverage {coverage:.4f}, EPE "
          f"{epe:.4f} px on consistent pixels; host latency median "
          f"{median:.3f} ms a frame ({card})")
    require(coverage > 0.5 and epe < 1.0, "lr engine accuracy")
    counts["median_ms"] = median
    return counts


# The pyramid's scene (the JAX bench.py:204-210 scene) and the JAX
# package's values on it (BENCH_r04.json: values, not speeds).
PYRAMID_JAX = {"epe": 0.2379, "bad3": 0.0016, "coverage": 0.9834}
PYRAMID_CALLS = 5


def phase_pyramid(card: str) -> dict:
    """``PyramidStereoMatcher(StereoConfig(kernel_size=15,
    num_disparities=192))`` on the bench scene (375x1242, d 4..40, noise
    0.01, seed 0), counted: K3 twice a call (coarse, fine) and K11p,
    K11w and K11c once, no plain twin; each level's K3 maps against the
    plain pipeline on the
    same inputs (as phase 4 at KITTI), the call bit-equal to the levels
    composed; EPE, bad3 and coverage beside the JAX package's; EPE <=
    0.30 px and coverage >= 0.97; the host-clock time a call."""
    H, W, D, k = KITTI
    pyr = PyramidStereoMatcher(StereoConfig(kernel_size=k,
                                            num_disparities=D))
    cam_np, proj_np, truth = make_stereo_pair(H, W, d_min=4.0, d_max=40.0,
                                              noise=0.01, seed=0)
    cam = torch.from_numpy(cam_np[None]).cuda()
    proj = torch.from_numpy(proj_np[None]).cuda()
    torch.cuda.synchronize()
    before = COUNTS.copy()
    with torch.no_grad():
        maps = fence(pyr(cam, proj))
    # K3 twice a pyramid call, and each glue kernel once.
    counts = require_launched("pyramid", before, PATH_LAUNCHES["pyramid"])
    # Each level's K3 call against the plain pipeline on the same inputs
    # (the pooled pair; the camera and the projector warped by the
    # coarse K3 maps), and the call bit-equal to the levels composed.
    def level(cfg, camera, projector, name):
        args = (cfg.num_disparities, k, cfg.epsilon, cfg.softargmax_beta,
                cfg.cost_threshold)
        got = stereo_pipeline_cuda(camera, projector, *args)
        compare_maps(got, stereo_pipeline_reference(camera, projector, *args),
                     forward_banded(camera, projector, *args[:3]),
                     cfg.cost_threshold, False,
                     f"pyramid {name} level {tuple(camera.shape)} "
                     f"D={cfg.num_disparities}")
        return got

    with torch.no_grad():
        coarse = level(pyr._coarse.config, *pyr.coarse_pair(cam, proj),
                       "coarse")
        shift, proj_w = pyr.warp(proj, coarse.soft_disparity)
        fine = level(pyr._fine.config, cam, proj_w, "fine")
        composed = pyr.compose(fine, shift)
    for name in maps._fields:
        require(torch.equal(getattr(maps, name), getattr(composed, name)),
                f"pyramid {name} equals its two K3 levels composed")
    m = disparity_metrics(maps.soft_disparity[0],
                          torch.from_numpy(truth).cuda(), maps.mask[0])
    times = []
    with torch.no_grad():
        for _ in range(PYRAMID_CALLS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fence(pyr(cam, proj))
            times.append(time.perf_counter() - t0)
    median = 1e3 * float(np.median(times))
    print(f"pyramid: {H}x{W} D={D} k={k} (downsample {pyr.downsample}, "
          f"residual {pyr.residual}): EPE {m['epe']:.4f} px (JAX "
          f"{PYRAMID_JAX['epe']}), bad3 {m['bad3']:.4f} (JAX "
          f"{PYRAMID_JAX['bad3']}), coverage {m['coverage']:.4f} (JAX "
          f"{PYRAMID_JAX['coverage']}); host clock median "
          f"{median:.3f} ms a call over {PYRAMID_CALLS} ({card})")
    require(m["epe"] <= 0.30 and m["coverage"] >= 0.97,
            "pyramid accuracy: EPE <= 0.30 px and coverage >= 0.97")
    counts.update(m)
    counts["median_ms"] = median
    return counts


# Middlebury 2014 at full resolution (H, W, D, k), as the benchmark's
# middlebury2014 configuration, and its pyramid (f, r).
MIDDLEBURY = (1988, 2880, 289, 15)
MIDDLEBURY_PYRAMID = (4, 12)


def bit_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def phase_pyramid_glue(card: str) -> dict:
    """K11p, K11w and K11c against the plain glue at Middlebury 2014's
    2880x1988 (D = 289, f = 4, r = 12), on a speckle scene of disparities
    30-260, each stage fed the pipeline's own values (the pooled pair to
    the coarse K3, its soft map to the warp, the fine K3's maps on the
    warped pair to the composition), counted: K11w's shift and warped
    projector and K11c's maps bit-equal to the plain glue's, the
    confidence passed through, K11p within rtol 1e-6 of ``_avg_pool`` (of
    the blocks' mean magnitude).  Then each kernel and its plain stage
    timed in turns (``interleaved``) beside the kernel's bound by bytes.
    Returns {key: (max abs error, kernel ms, plain ms, (bound ms, by))}."""
    H, W, D, k = MIDDLEBURY
    f, r = MIDDLEBURY_PYRAMID
    pyr = PyramidStereoMatcher(StereoConfig(kernel_size=k,
                                            num_disparities=D),
                               downsample=f, residual=r)
    cam_np, proj_np, _ = make_stereo_pair(H, W, d_min=30.0, d_max=260.0,
                                          noise=0.01, seed=27)
    # Contiguous, as the matcher's inputs are: a strided pair would time
    # the wrappers' copies with the kernels.
    cam, proj = (torch.from_numpy(np.ascontiguousarray(x[None])).cuda()
                 for x in (cam_np, proj_np))
    torch.cuda.synchronize()
    before = COUNTS.copy()
    with torch.no_grad():
        pooled = cuda_pyramid.pool_pair(cam, proj, f)
        soft = pyr._coarse.disparity_maps(*pooled).soft_disparity
        shift, proj_w = cuda_pyramid.shift_and_warp(proj, soft, f, r, D)
        fine = pyr._fine.disparity_maps(cam, proj_w)
        maps = cuda_pyramid.compose(fine, shift, r)
    torch.cuda.synchronize()
    require_launched("pyramid glue", before, PATH_LAUNCHES["pyramid"])

    def plain_pool(camera, projector, f):
        return _avg_pool(camera, f), _avg_pool(projector, f)

    # The scene's noise makes some blocks' means near 0, where any two
    # orders of the sum differ relatively by far more than 1e-6: rtol 1e-6
    # is taken of the block's mean magnitude (of the mean itself where the
    # image is nonnegative).
    pool_err = 0.0
    for got, want, img in zip(pooled, plain_pool(cam, proj, f),
                              (cam, proj)):
        gap = (got - want).abs()
        pool_err = max(pool_err, float(gap.max()))
        require(bool((gap <= 1e-6 * _avg_pool(img.abs(), f)).all()),
                "K11p within rtol 1e-6 of _avg_pool, of the blocks' mean "
                "magnitude")
    for name, got, want in zip(("shift", "warped projector"),
                               (shift, proj_w),
                               _shift_and_warp(proj, soft, f, r, D)):
        require(bit_equal(got, want), f"K11w {name} bit-equal to the plain "
                f"warp's")
    for name, got, want in zip(maps._fields, maps,
                               _compose(fine, shift, r)):
        require(bit_equal(got, want), f"K11c {name} bit-equal to the plain "
                f"compose's")
    require(maps.confidence is fine.confidence,
            "K11c passes the confidence through")
    print(f"pyramid glue {H}x{W} D={D} f={f} r={r}: K11w and K11c bit-equal "
          f"to the plain glue, K11p max abs {pool_err:.3e}; shift in "
          f"[{float(shift.min()):.0f}, {float(shift.max()):.0f}], "
          f"{float((shift == -r).float().mean()):.4f} at -r, "
          f"{float((shift == D).float().mean()):.4f} at D")

    px, cpx = H * W, -(-H // f) * -(-W // f)
    stages = {
        # Bytes: K11p reads both images and writes both pooled; K11w reads
        # the projector and the coarse soft map and writes the shift and
        # the warped projector; K11c reads three maps and the shift and
        # writes three maps.
        "K11p": (cuda_pyramid.pool_pair, plain_pool, (cam, proj, f),
                 4 * (2 * px + 2 * cpx), pool_err),
        "K11w": (cuda_pyramid.shift_and_warp, _shift_and_warp,
                 (proj, soft, f, r, D), 4 * (3 * px + cpx), 0.0),
        "K11c": (cuda_pyramid.compose, _compose, (fine, shift, r),
                 4 * 7 * px, 0.0),
    }
    out = {}
    for key, (kernel, plain, args, nbytes, err) in stages.items():
        ms, plain_ms, _ = interleaved(key, kernel, plain, args, args,
                                      f"{H}x{W}", card)
        b_ms, by = bound(0, nbytes)
        print(f"time: {key} at {H}x{W}: bound {b_ms:.4f} ms by {by} "
              f"({nbytes / 1e6:.1f} MB), the kernel {ms / b_ms:.2f} times "
              f"its bound ({card})")
        out[key] = (err, ms, plain_ms, (b_ms, by))
    del cam, proj, pooled, soft, shift, proj_w, fine, maps
    torch.cuda.empty_cache()
    return out


def phase_failsafe() -> None:
    """An injected allocation failure (CUDA error 2) is retried and the
    frame served through K3; an injected sticky error (700) is raised on
    the first try; ``device_healthcheck()`` is true on the card."""
    B, H, W, D, k = SHAPES[0]
    cam, proj = uniform_pair(1900, B, H, W)
    state = {"fail": 1, "calls": 0, "code": 2}

    def flaky():
        state["calls"] += 1
        if state["fail"]:
            state["fail"] -= 1
            raise RuntimeError(f"K3 fused pipeline launch: CUDA error "
                               f"{state['code']} (injected)")
        return stereo_pipeline_cuda(cam, proj, D, k, EPS, 50.0, THRESHOLD)

    before = COUNTS.copy()
    maps = with_retries(flaky, retries=2, backoff_s=0.01)()
    require(state["calls"] == 2 and launched(before) == Counter({"K3": 1})
            and bool(torch.isfinite(maps.confidence).all()),
            "an allocation failure is retried and served")
    state.update(fail=1, calls=0, code=700)
    try:
        with_retries(flaky, retries=2, backoff_s=0.01)()
        raised = False
    except RuntimeError as exc:
        raised = "CUDA error 700" in str(exc)
    require(raised and state["calls"] == 1,
            "a sticky error (700) is raised at once, not retried")
    require(device_healthcheck() is True, "device_healthcheck() on the card")
    print("failsafe: allocation failure (2) retried and served; sticky "
          "error (700) raised at once; device_healthcheck() true")


# The parallel layer's phases: the engine's KITTI bucket (H divides by 2
# and 4, so row shards are equal), two frames, k = 15; the sharded paths
# at D = 192, the stage pipeline at D = 191 (192 planes split into 2 or 4
# stages) over 4 frames.
PAR_B, PAR_K, PAR_D, PIPE_D, PIPE_T = 2, 15, 192, 191, 4
PAR_SPACES, PIPE_STAGES = (2, 4), (2, 4)
# Stage-merge betas: at 50 every head is unnormalized; at 75 the full
# range's (192 planes) is normalized and the stages' (96 or 48) are not;
# at 80 all are normalized.
PIPE_BETAS = (50.0, 75.0, 80.0)
PIPE_RTOL, PIPE_ATOL = 1e-4, 1e-5


def bucket_pairs(n: int, seed: int):
    """``n`` speckle pairs at the KITTI bucket (384 x 1280) on the card."""
    H, W = BUCKET
    pairs = [make_stereo_pair(H, W, d_min=D_MIN, d_max=D_MAX, seed=seed + i)
             for i in range(n)]
    cams, projs, truth = (np.stack(x) for x in zip(*pairs))
    return (torch.from_numpy(cams).cuda(), torch.from_numpy(projs).cuda(),
            truth)


def host_ms(fn, reps: int = 10) -> float:
    """Median host-clock ms of ``fn()``, the card synchronised, after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return 1e3 * float(np.median(times))


def phase_parallel_unsharded() -> dict:
    """The unsharded calls the parallel phases hold the sharded paths to,
    on the bucket pairs, each held against its plain version on the same
    inputs: K1's volume (rtol 1e-4 / atol 1e-5), K3's maps (as phase 4's
    KITTI case, ties and threshold flips explained), K2's camera gradient
    of the mean soft disparity against the plain VJP fed the same head
    cotangent (the head the parallel layer runs on each block: the plain
    ``extract_disparity``, so ``out`` is K1's volume under it), K3w +
    K4's maps and camera gradient against the plain trainable pipeline
    (as phase 8's KITTI case), and K3's maps at the stage pipeline's D
    over its frames.  Returns the pairs and the unsharded results, with
    the one-card model's maps (K1, K8h) and camera gradient (K8hb, K2)
    as ``model_out`` and ``grad_m``."""
    H, W = BUCKET
    B, k, D = PAR_B, PAR_K, PAR_D
    cfg = StereoConfig(kernel_size=k, num_disparities=D)
    model = StereoMatcher(cfg)
    eps, beta, thr = cfg.epsilon, cfg.softargmax_beta, cfg.cost_threshold
    cam, proj, _ = bucket_pairs(B, seed=80)
    vcams, vprojs, _ = bucket_pairs(PIPE_T, seed=90)
    label = f"bucket B={B} H={H} W={W} D={D} k={k}"
    with torch.no_grad():
        cv = model.cost_volume(cam, proj)
        out = StereoOutput(cv, *extract_disparity(cv, D, thr, beta))
        model_out = model(cam, proj)
        maps = model.disparity_maps(cam, proj)
        pipe = stereo_pipeline_cuda(vcams, vprojs, PIPE_D, k, eps, beta, thr)
        cost = forward_banded(cam, proj, D, k, eps)
    err = compare_volume(cv, cost, label)
    compare_maps(maps, stereo_pipeline_reference(cam, proj, D, k, eps, beta,
                                                 thr),
                 cost, thr, False, label)
    del cost

    cam_u = cam.clone().requires_grad_(True)
    extract_disparity(model.cost_volume(cam_u, proj), D, thr,
                      beta).soft_disparity.mean().backward()
    cam_m = cam.clone().requires_grad_(True)
    model(cam_m, proj).soft_disparity.mean().backward()
    c = cv.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(
        extract_disparity(c, D, thr, beta).soft_disparity.mean(), c)
    compare_grad(cam_u.grad, camera_grad_banded(cam, proj, g, D, k, eps),
                 f"K2 {label}: camera gradient of the mean soft disparity "
                 f"against the plain VJP on its head cotangent",
                 elementwise=False)
    del c, g
    grad_t, tmaps = hold_trainable(
        cam, proj, D, k, beta, lambda m: m.soft_disparity.mean(),
        f"{label} (mean soft disparity)", elementwise=False)

    plabel = f"bucket B={PIPE_T} H={H} W={W} D={PIPE_D} k={k}"
    with torch.no_grad():
        pcost = forward_banded(vcams, vprojs, PIPE_D, k, eps)
        compare_maps(pipe, stereo_pipeline_reference(
            vcams, vprojs, PIPE_D, k, eps, beta, thr), pcost, thr, False,
            plabel)
    del pcost
    torch.cuda.synchronize()
    return {"cam": cam, "proj": proj, "vcams": vcams, "vprojs": vprojs,
            "cv": cv, "out": out, "maps": maps, "pipe": pipe,
            "grad_u": cam_u.grad, "grad_t": grad_t, "tmaps": tmaps,
            "model_out": model_out, "grad_m": cam_m.grad,
            "err": err}


def phase_parallel_one_rank(card: str, ref: dict) -> dict:
    """The parallel layer end to end at one rank: an NCCL world of one, a
    1 x 1 mesh and a one-stage pipeline, counted around the paths,
    every result held against ``ref`` (:func:`phase_parallel_unsharded`).
    Returns what it launched."""
    H, W = BUCKET
    B, k, D = PAR_B, PAR_K, PAR_D
    cfg = StereoConfig(kernel_size=k, num_disparities=D)
    model = StereoMatcher(cfg)
    cam, proj, vcams, vprojs = (ref[n] for n in ("cam", "proj", "vcams",
                                                   "vprojs"))
    cfg_p = StereoConfig(kernel_size=k, num_disparities=PIPE_D)
    noise = np.random.default_rng(81).standard_normal(tuple(cam.shape))
    camera0 = cam + torch.from_numpy(
        (TRAIN_NOISE * noise).astype(np.float32)).cuda()
    want_cv, want_out, want_maps, want_pipe, want_tmaps = (
        ref[n] for n in ("cv", "out", "maps", "pipe", "tmaps"))
    target = want_maps.soft_disparity

    initialize_multihost()
    require(dist.get_world_size() == 1 and dist.get_backend() == "nccl",
            "initialize_multihost() in a lone process: an NCCL world of one")
    mesh = make_mesh(MeshConfig(1, 1))
    stages = stage_mesh(1)
    print(f"parallel one rank: world {dist.get_world_size()} "
          f"({dist.get_backend()}), mesh {mesh}, stages {stages}")

    before = COUNTS.copy()
    with torch.no_grad():
        cv = sharded_cost_volume(cam, proj, cfg, mesh)            # K1
    cam_s, proj_s = shard_batch((cam, proj), mesh)
    cam_s.requires_grad_(True)
    out = model.sharded_apply(cam_s, proj_s, mesh)                # K1
    out.soft_disparity.mean().backward()                          # K2
    with torch.no_grad():
        maps = sharded_disparity_maps(cam, proj, cfg, mesh)       # K3
    cam_s2 = shard_batch(cam, mesh).requires_grad_(True)
    tmaps = sharded_disparity_maps(cam_s2, proj_s, cfg, mesh,
                                   trainable=True)               # K3w
    tmaps.soft_disparity.mean().backward()                        # K4
    camera, losses = optimize_camera(
        model, camera0, proj, target, learning_rate=TRAIN_LR,
        num_steps=TRAIN_STEPS, mesh=mesh)                         # K1, K2
    with torch.no_grad():
        piped = pipelined_video_maps(vcams, vprojs, cfg_p, stages)  # K3m
    torch.cuda.synchronize()
    counts = require_launched(
        "parallel one rank", before,
        Counter({"K1": 2 + TRAIN_STEPS, "K2": 1 + TRAIN_STEPS, "K3": 1,
                 "K3w": 1, "K4": 1, "K3m": PIPE_T}))

    def full(a):
        return a.full_tensor() if hasattr(a, "full_tensor") else a

    def same(a, b, what, of="the unsharded call"):
        require(torch.equal(full(a), b), f"parallel one rank: {what} "
                f"bit-equal to {of}")

    same(cv, want_cv, "sharded_cost_volume")
    for name in ("cost_volume", "disparity", "soft_disparity", "mask",
                 "confidence"):
        same(getattr(out, name), getattr(want_out, name),
             f"sharded_apply {name}",
             "the parallel layer's head (plain) on the unsharded volume")
    # The one-card model runs K8h where the parallel layer runs the plain
    # head on each block: max and first argmax are exact, the soft map
    # differs by the order of the sums.
    want_m = ref["model_out"]
    for name in ("disparity", "mask", "confidence"):
        same(getattr(out, name), getattr(want_m, name),
             f"sharded_apply {name}", "the one-card model's (K8h)")
    require(torch.allclose(full(out.soft_disparity), want_m.soft_disparity,
                           rtol=HEAD_SOFT_RTOL, atol=HEAD_SOFT_ATOL),
            f"parallel one rank: sharded_apply soft_disparity within rtol "
            f"{HEAD_SOFT_RTOL} / atol {HEAD_SOFT_ATOL} px of the one-card "
            f"model's (K8h)")
    for name in maps._fields:
        same(getattr(maps, name), getattr(want_maps, name),
             f"sharded_disparity_maps {name}")
        same(getattr(tmaps, name), getattr(want_tmaps, name),
             f"sharded_disparity_maps(trainable) {name}")
    grad_u, grad_t = ref["grad_u"], ref["grad_t"]
    err = compare_grad(cam_s.grad.full_tensor(), grad_u,
                       "parallel one rank: sharded_apply camera gradient "
                       "(K2) against the unsharded", elementwise=True)
    err = max(err, compare_grad(
        cam_s.grad.full_tensor(), ref["grad_m"], "parallel one rank: "
        "sharded_apply camera gradient (plain head, K2) against the "
        "one-card model's (K8hb, K2)", elementwise=True))
    err = max(err, compare_grad(
        cam_s2.grad.full_tensor(), grad_t, "parallel one rank: trainable "
        "sharded camera gradient (K3w + K4) against the unsharded",
        elementwise=True))
    print(f"parallel one rank: gradients bit-equal: K2 "
          f"{torch.equal(cam_s.grad.full_tensor(), grad_u)}, K4 "
          f"{torch.equal(cam_s2.grad.full_tensor(), grad_t)}")
    for name in ("disparity", "mask"):
        require(torch.equal(getattr(piped, name), getattr(want_pipe, name)),
                f"one-stage pipeline {name} equals the full-range K3's")
    for name in ("soft_disparity", "confidence"):
        require(torch.allclose(getattr(piped, name), getattr(want_pipe, name),
                               rtol=PIPE_RTOL, atol=PIPE_ATOL),
                f"one-stage pipeline {name} within rtol {PIPE_RTOL} / atol "
                f"{PIPE_ATOL} of the full-range K3's")
    losses = losses.cpu().tolist()
    print(f"parallel one rank: optimize_camera(mesh 1x1) {TRAIN_STEPS} "
          f"steps at {B}x{H}x{W} D={D} k={k}: losses {losses}")
    require(all(np.isfinite(losses)), "mesh losses finite")
    require(losses[-1] < losses[0], "mesh: the last loss below the first")
    require(bool(torch.isfinite(camera).all()), "mesh camera finite")

    # Host clock, synchronised: the sharded fused pipeline at 1 x 1 against
    # the matcher's, on the same pair, in turns.
    with torch.no_grad():
        ms = {"sharded": [], "unsharded": []}
        for what in ("unsharded", "sharded", "sharded", "unsharded"):
            fn = ((lambda: sharded_disparity_maps(cam_s, proj_s, cfg, mesh))
                  if what == "sharded"
                  else (lambda: model.disparity_maps(cam, proj)))
            ms[what].append(host_ms(fn))
    sh, un = (float(np.mean(ms[w])) for w in ("sharded", "unsharded"))
    print(f"time: sharded_disparity_maps at mesh 1x1 {sh:.4f} ms against "
          f"StereoMatcher.disparity_maps {un:.4f} ms (host clock, "
          f"synchronised, median of 10 in turns; {B}x{H}x{W} D={D} k={k}; "
          f"{card})")
    counts["sharded_ms"], counts["unsharded_ms"] = sh, un
    dist.destroy_process_group()
    require(not dist.is_initialized(), "process group destroyed")
    counts["grad_err"] = err
    return counts


def halo_blocks(x: torch.Tensor, space: int, halo: int):
    """Each row shard's block as ``halo_exchange`` delivers it: the
    shard's rows and ``halo`` rows of each neighbour, zeros past the true
    borders."""
    h = x.shape[1] // space
    xp = F.pad(x, (0, 0, halo, halo))
    return [xp[:, s * h:s * h + h + 2 * halo] for s in range(space)]


def stitch_grads(grads, halo: int) -> torch.Tensor:
    """The camera gradient of the extended blocks' gradients: each shard's
    own rows, then the slab its upper neighbour's bottom halo received
    added onto its top rows and the slab its lower neighbour's top halo
    received onto its bottom rows, in ``halo_exchange``'s backward order."""
    n = len(grads)
    h = grads[0].shape[1] - 2 * halo
    out = []
    for s, g in enumerate(grads):
        own = g[:, halo:halo + h].clone()
        if s > 0:
            own[:, :halo] += grads[s - 1][:, halo + h:]
        if s + 1 < n:
            own[:, h - halo:] += grads[s + 1][:, :halo]
        out.append(own)
    return torch.cat(out, dim=1)


def stage_op_times(cam, proj, S: int, chunk: int, cfg, rates: dict,
                   card: str):
    """The last stage's op (``chunk_state``, CUDA events) and K3m alone on
    the same padded, shifted pair, beside their models: (op ms, K3m ms,
    op model ms)."""
    H, W = cam.shape
    Wp = W + PIPE_D + 1 - chunk
    off = (S - 1) * chunk
    ms = 1e3 * benchmark(chunk_state, cam, proj, off, chunk, cfg, warmup=2,
                         iters=10, chain=3)["median_s"]
    cam_p = F.pad(cam, (0, Wp - W))[None]
    proj_sh = F.pad(F.pad(proj, (0, Wp - W))[..., :Wp - off], (off, 0))[None]
    k3m = 1e3 * benchmark(
        fused_pipeline_train_cuda, cam_p, proj_sh, chunk - 1,
        cfg.kernel_size, cfg.epsilon, cfg.softargmax_beta,
        cfg.cost_threshold, False, warmup=2, iters=10, chain=3)["median_s"]
    model_ms, model_by, _ = model_bound(
        km.stage_op_cost(H, W, PIPE_D, S, cfg.kernel_size,
                         cfg.softargmax_beta), rates)
    k3m_model, _, _ = model_bound(km.fused_forward_cost(
        H, Wp, chunk - 1, cfg.kernel_size, residuals=True), rates)
    print(f"time: K3m stage op (chunk_state) at S={S}: {chunk} planes over "
          f"{H}x{Wp}: {ms:.4f} ms, of it K3m alone {k3m:.4f} ms (CUDA "
          f"events); stage_op_cost model {model_ms:.4f} ms ({model_by}), "
          f"K3m's {k3m_model:.4f} ms ({card})")
    return ms, k3m, model_ms


def phase_parallel_compute(card: str, rates: dict, ref: dict) -> dict:
    """Each shard's compute at space = 2 and 4 and each stage's at S = 2
    and 4, on one card: the per-shard functions of ``parallel/sharded.py``
    on the blocks the halo exchange delivers, held against ``ref``'s
    unsharded results (:func:`phase_parallel_unsharded`, which holds them
    against the plain versions), and the stage op of
    ``parallel/pipeline.py`` merged in stage order, held against the
    full-range K3 and the plain pipeline.  Returns the K3m stage op's
    times."""
    H, W = BUCKET
    B, k, D = PAR_B, PAR_K, PAR_D
    cfg = StereoConfig(kernel_size=k, num_disparities=D)
    halo = cfg.pad
    cam, proj = ref["cam"], ref["proj"]
    n_px = B * H * W
    want_cv, want_maps = ref["cv"], ref["maps"]
    err = 0.0
    for space in PAR_SPACES:
        cams = halo_blocks(cam, space, halo)
        projs = halo_blocks(proj, space, halo)
        with torch.no_grad():
            cv = torch.cat([local_cost_volume(c, p, cfg, halo)
                            for c, p in zip(cams, projs)], dim=1)
            require(torch.equal(cv, want_cv),
                    f"space={space}: stitched K1 volume bit-equal to the "
                    f"unsharded call")
            del cv
            maps = [local_disparity_maps(c, p, cfg, halo)
                    for c, p in zip(cams, projs)]
            for i, name in enumerate(want_maps._fields):
                got = torch.cat([m[i] for m in maps], dim=1)
                require(torch.equal(got, getattr(want_maps, name)),
                        f"space={space}: stitched K3 {name} bit-equal to "
                        f"the unsharded call")
        # K1 + K2 and K3w + K4 on each extended block, the loss the global
        # mean soft disparity.
        for trainable in (False, True):
            grads = []
            for c, p in zip(cams, projs):
                c = c.clone().requires_grad_(True)
                if trainable:
                    soft = local_disparity_maps(c, p, cfg, halo,
                                                trainable=True).soft_disparity
                else:
                    soft = extract_disparity(
                        local_cost_volume(c, p, cfg, halo), D,
                        cfg.cost_threshold,
                        cfg.softargmax_beta).soft_disparity
                (soft.sum() / n_px).backward()
                grads.append(c.grad)
            want = ref["grad_t"] if trainable else ref["grad_u"]
            err = max(err, compare_grad(
                stitch_grads(grads, halo), want,
                f"space={space}: stitched camera gradient through "
                f"{'K3w + K4' if trainable else 'K1 + K2'} against the "
                f"unsharded", elementwise=True))
        print(f"parallel compute: space={space}: K1 volume and K3 maps "
              f"stitched from {space} halo-extended blocks of "
              f"{H // space}+{2 * halo} rows bit-equal to the unsharded "
              f"calls ({B}x{H}x{W} D={D} k={k})")

    # The stage pipeline: S chunk states from K3m merged in stage order,
    # held against the full-range K3 and the plain pipeline.
    times = {}
    with torch.no_grad():
        pcost = forward_banded(cam, proj, PIPE_D, k, cfg.epsilon)
    for beta in PIPE_BETAS:
        cfg_p = StereoConfig(kernel_size=k, num_disparities=PIPE_D,
                             softargmax_beta=beta)
        with torch.no_grad():
            full = stereo_pipeline_cuda(cam, proj, PIPE_D, k, cfg.epsilon,
                                        beta, cfg.cost_threshold)
            plain = stereo_pipeline_reference(cam, proj, PIPE_D, k,
                                              cfg.epsilon, beta,
                                              cfg.cost_threshold)
            for S in PIPE_STAGES:
                chunk = (PIPE_D + 1) // S
                frames = []
                for b in range(B):
                    state = None
                    for s in range(S):
                        part = chunk_state(cam[b], proj[b], s * chunk, chunk,
                                           cfg_p)
                        state = (part if state is None
                                 else merge_states(state, part))
                    frames.append(finalize_state(state, cfg_p))
                got = [torch.stack(m) for m in zip(*frames)]
                compare_maps(type(full)(*got), plain, pcost,
                             cfg.cost_threshold, False,
                             f"S={S} beta={beta} merged K3m stages against "
                             f"the plain pipeline, B={B} H={H} W={W} "
                             f"D={PIPE_D} k={k}")
                for name in ("disparity", "mask"):
                    i = full._fields.index(name)
                    require(torch.equal(got[i], getattr(full, name)),
                            f"S={S} beta={beta}: merged {name} equals the "
                            f"full-range K3's")
                errs = []
                for name in ("soft_disparity", "confidence"):
                    i = full._fields.index(name)
                    w = getattr(full, name)
                    require(torch.allclose(got[i], w, rtol=PIPE_RTOL,
                                           atol=PIPE_ATOL),
                            f"S={S} beta={beta}: merged {name} within rtol "
                            f"{PIPE_RTOL} / atol {PIPE_ATOL}")
                    errs.append(float((got[i] - w).abs().max()))
                print(f"parallel compute: S={S} beta={beta} (full range "
                      f"{'un' if unnormalized_head(beta, PIPE_D) else ''}"
                      f"normalized, stages "
                      f"{'un' if unnormalized_head(beta, chunk - 1) else ''}"
                      f"normalized): disparity and mask equal, soft max_abs "
                      f"{errs[0]:.3e}, confidence max_abs {errs[1]:.3e}")
                if beta == cfg.softargmax_beta:
                    times[S] = stage_op_times(cam[0], proj[0], S, chunk,
                                              cfg_p, rates, card)
    del pcost
    return {"grad_err": err, "stage_ms": times}


def png_headers() -> bool:
    """Whether ``g++`` finds libpng's header here (the native library
    needs it)."""
    try:
        proc = subprocess.run(["g++", "-x", "c++", "-fsyntax-only", "-"],
                              input="#include <png.h>\n", capture_output=True,
                              text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return False
    return proc.returncode == 0


DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples",
                    "data")
LOADER_FRAMES = 8


def phase_data(tmp: str) -> dict:
    """The data layer on this machine: which decoders it has; the native
    library built where libpng's header is found (required there); the
    capture PNGs decoded by every decoder present, bit-equal where the
    arithmetic is the same (the numpy decoder and the native one, raw
    samples of the numpy decoder and OpenCV); the capture's ground truth
    loaded; 8- and 16-bit PNGs written by ``kitti._write_png_gray`` read
    back as exactly u8 / 255 and u16 / 256; the native ``FrameLoader``
    delivering 8 frames in path order where the library is built."""
    png_h = png_headers()
    built = native.build(verbose=True) and native.native_available()
    decoders = data_io.image_decoders()
    print(f"data: decoders here {list(decoders)}; png.h "
          f"{'found' if png_h else 'missing'}; native library "
          f"{'built at ' + str(native.library_path()) if built else 'not built'}")
    require(built or not png_h,
            "the native library builds where libpng's header is found")
    if not built:
        print(f"data: no native library (libpng's headers are not installed "
              f"here): PNGs decode with {decoders[0]} "
              f"(load_image_gray's chain: native, cv2, PIL, numpy)")
    for which in ("camera", "projector"):
        path = os.path.join(DATA, f"capture_{which}.png")
        img = data_io.load_image_gray(path)
        ours = data_io.decode_png_gray(path)
        require(img.shape == ours.shape == (330, 422)
                and img.dtype == np.float32, f"{path} decodes to 330x422")
        raw = data_io.decode_png(path)
        if built:
            require(np.array_equal(native.decode_png_gray(path), ours),
                    f"{path}: numpy decoder bit-equal to the native one")
        if "cv2" in decoders:
            import cv2
            require(np.array_equal(cv2.imread(path, cv2.IMREAD_UNCHANGED),
                                   raw[:, :, 0]),
                    f"{path}: numpy decoder's samples equal OpenCV's")
        require(float(np.abs(img - ours).max()) <= 1e-6 * float(ours.max()),
                f"{path}: load_image_gray ({decoders[0]}) within 1 ulp of "
                f"the numpy decoder")
    truth_path = os.path.join(DATA, "capture_disparity.npy")
    truth = native.load_npy_f32(truth_path) if built else np.load(truth_path)
    require(truth.shape == (330, 422) and np.isfinite(truth).all(),
            "capture_disparity.npy loads")
    rng = np.random.default_rng(0)
    u8 = rng.integers(0, 256, size=(37, 61), dtype=np.uint8)
    u16 = rng.integers(0, 65536, size=(37, 61)).astype(np.uint16)
    p8, p16 = os.path.join(tmp, "u8.png"), os.path.join(tmp, "u16.png")
    kitti._write_png_gray(p8, u8, 8)
    kitti.save_kitti_disparity(p16, u16.astype(np.float32) / 256.0)
    inv255 = np.float32(1.0) / np.float32(255.0)
    # libpng's and the numpy decoder's ``* (1/255)``; OpenCV's and PIL's
    # paths divide by 255.
    want8 = (u8.astype(np.float32) * inv255
             if decoders[0] in ("native", "numpy")
             else u8.astype(np.float32) / 255.0)
    require(np.array_equal(data_io.load_image_gray(p8), want8),
            f"8-bit PNG round trip through {decoders[0]}: exactly u8 / 255")
    require(np.array_equal(data_io.decode_png_gray(p8),
                           u8.astype(np.float32) * inv255),
            "8-bit PNG round trip through the numpy decoder")
    disp, valid = kitti.load_kitti_disparity(p16)
    require(np.array_equal(disp, u16.astype(np.float32) / 256.0)
            and np.array_equal(valid, u16 > 0),
            "16-bit PNG round trip: exactly u16 / 256")
    require(np.array_equal(data_io.decode_png_u16(p16), u16),
            "16-bit PNG round trip through the numpy decoder")
    print(f"data: capture pair and ground truth decoded; 8- and 16-bit PNG "
          f"round trips exact ({decoders[0]} and numpy)")
    if not built:
        print("data: FrameLoader not run: it is the native library's "
              "decode pool, not built here")
        return {"native": False, "decoder": decoders[0]}
    paths = []
    for i in range(LOADER_FRAMES):
        img = rng.integers(0, 256, size=(48, 64), dtype=np.uint8)
        img[0, 0] = i
        paths.append(os.path.join(tmp, f"frame{i}.png"))
        kitti._write_png_gray(paths[-1], img, 8)
    with native.FrameLoader(paths, capacity=2, threads=4) as frames:
        order = [int(round(f[0, 0] * 255.0)) for f in frames]
    require(order == list(range(LOADER_FRAMES)),
            f"FrameLoader delivers {LOADER_FRAMES} frames in order: {order}")
    print(f"data: FrameLoader delivered {LOADER_FRAMES} frames in path order "
          f"(4 threads, window 2)")
    return {"native": True, "decoder": "native"}


# The golden oracle's shapes (H, W, D, k): small, since it materialises
# [H, W, D+1, k^2] patches.
GOLDEN_SHAPES = [(24, 40, 8, 5), (37, 61, 8, 15)]


def phase_golden() -> dict:
    """The torch golden oracle (``ops.golden``, a direct patch sum) run on
    the card against K1's and K8's volumes (rtol 1e-4 / atol 1e-5) and
    K2's and K7's VJPs (rtol 1e-3 / atol 1e-6, mean-loss-scaled
    cotangents), and against the plain versions on the same inputs."""
    errs = {"K1": 0.0, "K8": 0.0, "K2": 0.0, "K7": 0.0}
    for i, (H, W, D, k) in enumerate(GOLDEN_SHAPES):
        cam, proj = uniform_pair(900 + i, 1, H, W)
        label = f"golden H={H} W={W} D={D} k={k}"
        vol = golden.zncc_cost_volume(cam[0], proj[0], D, k)
        ap = golden.zncc_cost_volume(cam[0], proj[0], None, k)
        cost = cost_volume_banded_cuda(cam, proj, D, k, EPS)
        errs["K1"] = max(errs["K1"], compare_volume(cost[0], vol, label))
        errs["K8"] = max(errs["K8"], compare_volume(
            cost_volume_allpairs_cuda(cam, proj, k, EPS)[0], ap, label,
            "K8"))
        compare_volume(forward_banded(cam, proj, D, k, EPS)[0], vol,
                       label, "plain banded")
        compare_volume(forward_allpairs(cam, proj, k, EPS)[0], ap, label,
                       "plain all-pairs")
        g = torch.randn((1, D + 1, H, W), device="cuda",
                        generator=torch.Generator("cuda").manual_seed(i))
        g *= 1.0 / (H * W)
        g_hwd = g.permute(0, 2, 3, 1)
        want_cam = golden.zncc_camera_grad(cam[0], proj[0], g_hwd[0], D, k)
        want_proj = golden.zncc_projector_grad(cam[0], proj[0], g_hwd[0], D,
                                               k)
        vol_pm = cost.permute(0, 3, 1, 2)
        errs["K2"] = max(errs["K2"], compare_grad(
            camera_grad_banded_cuda(cam, proj, vol_pm, g, D, k, EPS)[0],
            want_cam, f"K2 {label}", elementwise=True))
        errs["K7"] = max(errs["K7"], compare_grad(
            projector_grad_banded_cuda(cam, proj, vol_pm, g, D, k, EPS)[0],
            want_proj, f"K7 {label}", elementwise=True))
        compare_grad(camera_grad_banded(cam, proj, g_hwd, D, k, EPS)[0],
                     want_cam, f"plain camera VJP {label}", elementwise=True)
        compare_grad(projector_grad_banded(cam, proj, forward_banded(
            cam, proj, D, k, EPS), g_hwd, D, k, EPS)[0], want_proj,
            f"plain projector VJP {label}", elementwise=True)
    print(f"golden: max abs against the oracle {errs}")
    return errs


# The kernels the sweep holds, in the order of its summary lines; the
# banded ones take odd k >= 3 (their gate refuses k = 1, as JAX's Pallas
# kernels do), K8 every odd k.
FUZZ_KERNELS = ("K1", "K3", "K3w", "K3m", "K2", "K6", "K4", "K5", "K7",
                "K9a", "K9b", "K8")
# Where fp32 cannot hold the elementwise bound, a gradient kernel may miss
# float64 at a pixel by at most this many times its plain twin's miss.
FUZZ_TWIN_FACTOR = 2.0


def fuzz_grad(got, want, want64, label: str) -> tuple:
    """A gradient kernel against its plain twin at a sweep case, quietly
    (a line only where the fallback tier applies or a check fails):
    ||got - want|| / ||want|| <= GRAD_NORM_REL always, and a bound at
    every pixel.  Where fp32 can hold rtol GRAD_RTOL / atol GRAD_ATOL,
    i.e. the plain twin lies within it of its float64 run (``want64``,
    the same function on the inputs in float64), every pixel within it
    of the twin.  Elsewhere (at small windows and a sharp head, k = 3,
    beta = 80, the gradient reaches ~1 at a mean loss's cotangent, atol
    1e-6 is no longer felt, and a pixel where the terms cancel moves by
    more than 1e-3 of itself under fp32 rounding) every pixel within
    max(GRAD_ATOL + GRAD_RTOL |want64|, FUZZ_TWIN_FACTOR |want - want64|)
    of float64: the kernel may miss float64 by at most that much more
    than its twin does at that pixel.  Returns the max abs error against
    the twin and whether the twin held the bound everywhere."""
    want64 = want64.to(want.dtype)
    tol = GRAD_ATOL + GRAD_RTOL * want64.abs()
    twin = (want - want64).abs()
    fp32 = int((twin > tol).sum())
    if fp32:
        over = float(((got - want64).abs()
                      / torch.maximum(tol, FUZZ_TWIN_FACTOR * twin)).max())
        print(f"{label}: plain twin outside rtol {GRAD_RTOL} / atol "
              f"{GRAD_ATOL} of float64 at {fp32} pixel(s); kernel against "
              f"float64: max_abs {float((got - want64).abs().max()):.3e}, "
              f"plain twin {float(twin.max()):.3e}; largest share of the "
              f"per-pixel bound max(atol + rtol |float64|, "
              f"{FUZZ_TWIN_FACTOR} |twin - float64|) used: {over:.3f}")
        require(over <= 1.0, f"{label}: every pixel within the per-pixel "
                             f"bound of float64")
    return compare_grad(got, want, label, elementwise=fp32 == 0,
                        quiet=True), fp32 == 0


def fuzz_gate(cam, proj, D: int, k: int, beta: float, gated: dict) -> None:
    """At k below the kernels' gate every banded wrapper must refuse the
    case with its own ``ValueError``, before any launch."""
    B, H, W = cam.shape
    g = torch.zeros((B, D + 1, H, W), device=cam.device)
    maps = torch.zeros((B, H, W), device=cam.device)
    res = HeadResiduals(*(maps,) * 5, volume=None)
    calls = {
        "K1": lambda: cost_volume_banded_cuda(cam, proj, D, k, EPS),
        "K3": lambda: stereo_pipeline_cuda(cam, proj, D, k, EPS, beta,
                                           THRESHOLD),
        "K3w": lambda: fused_pipeline_train_cuda(cam, proj, D, k, EPS, beta,
                                                 THRESHOLD),
        "K3m": lambda: fused_pipeline_train_cuda(
            cam, proj, D, k, EPS, beta, THRESHOLD, save_volume=False),
        "K2": lambda: camera_grad_banded_cuda(cam, proj, g, g, D, k, EPS),
        "K6": lambda: camera_grad_banded_cuda(cam, proj, None, g, D, k, EPS),
        "K4": lambda: fused_pipeline_bwd_cuda(
            cam, proj, res._replace(volume=g), maps, maps, D, k, EPS, beta),
        "K5": lambda: fused_pipeline_bwd_cuda(cam, proj, res, maps, maps, D,
                                              k, EPS, beta),
        "K7": lambda: projector_grad_banded_cuda(cam, proj, g, g, D, k, EPS),
    }
    before = COUNTS.copy()
    for key, call in calls.items():
        try:
            call()
        except ValueError as e:
            require("kernel_size" in str(e), f"{key} refused k = {k} by its "
                    f"kernel-size gate, not by another check ({e})")
            gated[key] = gated.get(key, 0) + 1
            continue
        require(False, f"{key} refuses k = {k} (its gate is odd k >= "
                       f"{cuda_zncc.MIN_KERNEL_SIZE})")
    require(COUNTS == before, f"no launch at k = {k}")


def fuzz_banded(i: int, case, cam, proj, note) -> None:
    """Every banded kernel at one sweep case against its plain version,
    at the tolerances of its own phase: K1's and K3w's volumes as phase 3,
    K3's maps as phase 4 (ties and threshold flips explained), K3w's and
    K3m's maps bit-equal to K3's and K3m's am/s/t to K3w's, and K2, K6
    (both entries), K4, K5 and K7 with mean-loss-scaled cotangents in the
    tiers of :func:`fuzz_grad`."""
    B, H, W, D, k = case.B, case.H, case.W, case.D, case.k
    beta = 50.0 if i % 2 == 0 else 80.0
    label = f"fuzz {case} beta={beta}"
    plain = forward_banded(cam, proj, D, k, EPS)
    cost = cost_volume_banded_cuda(cam, proj, D, k, EPS)
    note("K1", compare_volume(cost, plain, label, quiet=True))

    maps = stereo_pipeline_cuda(cam, proj, D, k, EPS, beta, THRESHOLD)
    note("K3", compare_maps(maps, stereo_pipeline_reference(
        cam, proj, D, k, EPS, beta, THRESHOLD), plain, THRESHOLD, False,
        label, quiet=True))
    maps_w, res_w = fused_pipeline_train_cuda(cam, proj, D, k, EPS, beta,
                                              THRESHOLD)
    note("K3w", compare_volume(res_w.volume.permute(0, 2, 3, 1), plain,
                               label, kernel="K3w", quiet=True))
    maps_m, res_m = fused_pipeline_train_cuda(cam, proj, D, k, EPS, beta,
                                              THRESHOLD, save_volume=False)
    for key, m in (("K3w", maps_w), ("K3m", maps_m)):
        for name in maps._fields:
            require(torch.equal(getattr(m, name), getattr(maps, name)),
                    f"{key} {label}: {name} bit-equal to K3's")
    for name in ("am", "s", "t"):
        require(torch.equal(getattr(res_m, name), getattr(res_w, name)),
                f"K3m {label}: {name} bit-equal to K3w's")
    e = float((maps_m.confidence - plain.amax(-1)).abs().max())
    require(e <= 1e-5, f"K3m {label}: confidence within 1e-5 of the plain "
                       f"volume's max")
    note("K3m", e)

    g = mean_loss_cotangent(1000 + i, B, H, W, D)
    g_parity = g.permute(0, 2, 3, 1).contiguous()
    vol = cost.permute(0, 3, 1, 2)
    c64, p64, g64 = cam.double(), proj.double(), g_parity.double()
    want = camera_grad_banded(cam, proj, g_parity, D, k, EPS)
    want64 = camera_grad_banded(c64, p64, g64, D, k, EPS)
    note("K2", *fuzz_grad(camera_grad_banded_cuda(
        cam, proj, vol, g, D, k, EPS), want, want64, f"K2 {label}"))
    note("K6", *fuzz_grad(camera_grad_banded_cuda(
        cam, proj, None, g, D, k, EPS), want, want64, f"K6 {label}"))
    note("K6", *fuzz_grad(camera_grad_banded_parity_cuda(
        cam, proj, g_parity, D, k, EPS), want, want64,
        f"K6 parity {label}"), case=False)
    note("K7", *fuzz_grad(
        projector_grad_banded_cuda(cam, proj, vol, g, D, k, EPS),
        projector_grad_banded(cam, proj, plain, g_parity, D, k, EPS),
        projector_grad_banded(c64, p64, forward_banded(c64, p64, D, k, EPS),
                              g64, D, k, EPS), f"K7 {label}"))
    gs, gc = cotangents(1000 + i, B, H, W)
    for key, res in (("K4", res_w), ("K5", res_m)):
        res64 = HeadResiduals(*(m.double() for m in res[:5]), volume=None)
        note(key, *fuzz_grad(
            fused_pipeline_bwd_cuda(cam, proj, res, gs, gc, D, k, EPS, beta),
            fused_pipeline_bwd_reference(cam, proj, res, gs, gc, D, k, EPS,
                                         beta),
            fused_pipeline_bwd_reference(c64, p64, res64, gs.double(),
                                         gc.double(), D, k, EPS, beta),
            f"{key} {label}"))


def fuzz_layout(i: int, case, note) -> None:
    """K9a and K9b at the case's volume, bit-equal to
    ``permute().contiguous()``."""
    vol = torch.from_numpy(np.random.default_rng(1000 + i).standard_normal(
        (case.B, case.D + 1, case.H, case.W), dtype=np.float32)).cuda()
    parity = plane_major_to_parity(vol)
    require(torch.equal(parity, vol.permute(0, 2, 3, 1).contiguous()),
            f"K9a fuzz {case}: bit-equal to permute().contiguous()")
    require(torch.equal(parity_to_plane_major(parity), vol),
            f"K9b fuzz {case}: bit-equal to permute().contiguous()")
    note("K9a", 0.0)
    note("K9b", 0.0)


def fuzz_allpairs(case, cam, proj, note) -> None:
    """K8 at one sweep case against its plain version; beyond k = 1, the
    CUDA all-pairs op's camera gradient (K8's volume, then K8b) against
    the plain node's and
    the golden oracle's with a mean-loss-scaled cotangent, in the tiers
    of :func:`fuzz_grad` (the plain node in float64 says where fp32 can
    hold the elementwise bound)."""
    B, H, W, k = case.B, case.H, case.W, case.k
    label = f"fuzz {case}"
    note("K8", compare_volume(cost_volume_allpairs_cuda(cam, proj, k, EPS),
                              forward_allpairs(cam, proj, k, EPS), label,
                              kernel="K8", quiet=True))
    if k == 1:
        return
    g = torch.from_numpy(case_cotangent(case)).cuda() * (1.0 / (H * W))
    grads = []
    for op, x, gx in ((stereo_matching, cam, g),
                      (stereo_matching_torch, cam, g),
                      (stereo_matching_torch, cam.double(), g.double())):
        c = x.clone().requires_grad_(True)
        (op(c, proj.to(x.dtype), None, k) * gx).sum().backward()
        grads.append(c.grad)
    got, plain, plain64 = grads
    note("allpairs_vjp", *fuzz_grad(got, plain, plain64, f"all-pairs VJP "
                                    f"{label} against the plain node"))
    for b in range(B):
        note("allpairs_vjp", *fuzz_grad(
            got[b], golden.zncc_camera_grad(cam[b], proj[b], g[b], None, k,
                                            EPS), plain64[b],
            f"all-pairs VJP {label} frame {b} against the golden oracle"),
            case=False)


def phase_fuzz() -> dict:
    """The randomized-shape sweep on the card: the cases of
    ``utils/shape_sweep.py`` (which ``tests/test_torch_fuzz_shapes.py``
    holds against the JAX package on the CPU), each kernel that takes a
    case's k against its plain version; at k = 1 the banded kernels'
    gate must refuse the case.  One line a kernel: its cases and largest
    error.  A case prints its own line only where a gradient check falls
    back to its float64 tier or a check fails."""
    t0 = time.perf_counter()
    cases = sweep_cases()
    errs, runs, gated, fallback = {}, {}, {}, {}

    def note(key: str, err: float, elementwise: bool = True,
             case: bool = True) -> None:
        """Record a check of ``key``; ``case``: the first at this case."""
        errs[key] = max(errs.get(key, 0.0), err)
        runs[key] = runs.get(key, 0) + case
        fallback[key] = fallback.get(key, 0) + (not elementwise)

    for i, case in enumerate(cases):
        cam, proj = (torch.from_numpy(a).cuda() for a in case_pair(case))
        if case.D is None:
            fuzz_allpairs(case, cam, proj, note)
            continue
        fuzz_layout(i, case, note)
        if case.k < cuda_zncc.MIN_KERNEL_SIZE:
            fuzz_gate(cam, proj, case.D, case.k, 50.0, gated)
        else:
            fuzz_banded(i, case, cam, proj, note)
    torch.cuda.synchronize()
    for key in FUZZ_KERNELS + ("allpairs_vjp",):
        gate = (f"; refused k = 1 by its gate in {gated[key]} case(s), as "
                f"JAX's Pallas kernels do" if key in gated else "")
        tier = (f"; {fallback[key]} gradient check(s) held to the "
                f"per-pixel bound against float64 (fp32 misses the "
                f"elementwise bound there)" if fallback.get(key) else "")
        print(f"fuzz {key}: {runs.get(key, 0)} case(s), max_abs "
              f"{errs.get(key, 0.0):.3e}{gate}{tier}")
        require(runs.get(key, 0) >= 1, f"fuzz: {key} ran at a drawn case")
    print(f"fuzz: allpairs_vjp is the CUDA all-pairs op's camera gradient "
          f"(K8, then K8b) against the plain node "
          f"and the golden oracle; {len(cases)} cases in "
          f"{time.perf_counter() - t0:.1f} s")
    errs.pop("allpairs_vjp", None)
    return errs


def hold_example(name: str, maps, cam, proj, D: int, k: int) -> dict:
    """An example's maps of one frame against the plain pipeline on the
    same inputs: hard disparity and mask equal except at top-two ties
    (counted) or, for the mask, within 1e-5 of the threshold; soft
    disparity rtol 1e-4 / atol 1e-5 where the masks agree."""
    c = torch.from_numpy(np.ascontiguousarray(cam)).cuda()[None]
    p = torch.from_numpy(np.ascontiguousarray(proj)).cuda()[None]
    want = stereo_pipeline_reference(c, p, D, k, EPS, 50.0, THRESHOLD)
    got = {f: torch.from_numpy(np.asarray(getattr(maps, f)).reshape(
        c.shape)).cuda() for f in want._fields}
    tie = top2_ties(forward_banded(c, p, D, k, EPS))
    flips = got["mask"] != want.mask
    near = (want.confidence - THRESHOLD).abs() <= 1e-5
    require(bool(near[flips].all()),
            f"{name}: every mask flip within 1e-5 of the threshold")
    differ = got["disparity"] != want.disparity
    unexplained = differ & ~tie & ~flips
    require(not bool(unexplained.any()),
            f"{name}: {int(unexplained.sum())} disparity mismatches off a "
            f"top-two tie")
    same = ~flips
    soft_err = (got["soft_disparity"] - want.soft_disparity).abs()[same]
    bad = int((soft_err > 1e-5 + 1e-4 * want.soft_disparity.abs()[same])
              .sum())
    conf_err = float((got["confidence"] - want.confidence).abs().max())
    n_tie, n_flip = int((differ & tie).sum()), int(flips.sum())
    print(f"examples: {name} against the plain pipeline: disparity "
          f"mismatches {int(differ.sum())} (top-two ties {n_tie}), mask "
          f"flips {n_flip}, soft max_abs {float(soft_err.max()):.3e} "
          f"(outside rtol 1e-4/atol 1e-5: {bad}), conf max_abs "
          f"{conf_err:.3e}")
    require(bad == 0, f"{name}: soft disparity within rtol 1e-4 / atol 1e-5")
    return {"ties": n_tie, "flips": n_flip}


def run_example(name: str, module, argv, card: str):
    """``module.main(argv)`` in process, counted: it
    must return 0, launch K3 and never the plain pipeline."""
    rec = {}
    before = COUNTS.copy()
    t0 = time.perf_counter()
    rc = module.main(argv, rec)
    seconds = time.perf_counter() - t0
    counts = launched(before)
    print(f"examples: {name} {' '.join(argv)} -> rc {rc} in {seconds:.2f} s; "
          f"K3 launches {counts['K3']}, plain pipeline calls "
          f"{counts['plain.stereo_pipeline_reference']} ({card})")
    require(rc == 0, f"{name} exits 0")
    require(counts["K3"] >= 1, f"{name} launched K3")
    require(not plain_calls(counts), f"{name}: no plain version ran")
    return rec, counts


def phase_examples(card: str, tmp: str) -> dict:
    """The five data-driven examples at real size through their
    ``main(argv)``: real_capture (330x422, D = 48, k = 15), kitti_eval on
    a 4-frame 375x1242 split at D = 192, serve (8 frames, retries=2),
    video_depth (16 frames, 375x1242, D = 192) and demo (375x1242,
    D = 192, its PNG decoded back); each launches K3 and no plain
    version, and one frame's maps are held against the plain pipeline."""
    out = {}
    rec, out["real_capture"] = run_example(
        "real_capture", real_capture,
        ["--num-disparities", "48", "--kernel-size", "15"], card)
    m = rec["metrics"]
    print(f"examples: real_capture EPE {m['epe']:.4f} px, bad3 "
          f"{m['bad3']:.4f}, coverage {m['coverage']:.4f} ({rec['decoder']} "
          f"decoder; {card})")
    hold_example("real_capture", rec["maps"], rec["camera"],
                 rec["projector"], 48, 15)

    root = os.path.join(tmp, "kitti")
    kitti.write_fixture(root, num_frames=4, height=375, width=1242,
                        max_disparity=40)
    rec, out["kitti_eval"] = run_example(
        "kitti_eval", kitti_eval,
        ["--root", root, "--num-disparities", "192", "--max-epe", "3.0",
         "--save-dir", os.path.join(tmp, "kitti_pred")], card)
    agg = rec["aggregate"]
    print(f"examples: kitti_eval 4 frames 375x1242 D=192: EPE "
          f"{agg['epe']:.4f} px, bad3 {agg['bad3']:.6f}, valid coverage "
          f"{agg['valid_coverage']:.4f} ({card})")
    hold_example("kitti_eval", rec["maps"][0], *rec["inputs"][0], 192, 15)

    rec, out["serve"] = run_example(
        "serve", serve, ["--loops", "8", "--retries", "2"], card)
    lat = rec["latency_ms"]
    print(f"examples: serve 8 frames 330x422 in bucket {rec['bucket']}, "
          f"D=48: p50 {np.percentile(lat, 50):.3f} ms, p95 "
          f"{np.percentile(lat, 95):.3f} ms a frame, {rec['fps']:.1f} "
          f"frames/s incl. host decoding ({rec['source']}; {card})")
    require(len(rec["maps"]) == 8, "serve served 8 frames")
    hold_example("serve", rec["maps"][0], rec["camera"], rec["projector"],
                 48, 15)

    rec, out["video_depth"] = run_example("video_depth", video_depth, [],
                                          card)
    require(out["video_depth"]["K3"] >= 17,
            "video_depth: K3 once a frame and once to warm up")
    require(np.isfinite(rec["depth"]).all(), "video_depth: finite depth")
    print(f"examples: video_depth 16 frames 375x1242 D=192: "
          f"{rec['rate']:.1f} depth maps/s, EPE {rec['metrics']['epe']:.4f} "
          f"px, coverage {rec['metrics']['coverage']:.4f} ({card})")
    hold_example("video_depth", rec["maps"], rec["camera"], rec["projector"],
                 192, 15)

    png = os.path.join(tmp, "demo_disparity.png")
    rec, out["demo"] = run_example("demo", demo, ["--save-png", png], card)
    back = data_io.load_image_gray(png)
    want = np.clip(rec["maps"].disparity[0] / 192 * 255.0, 0, 255).astype(
        np.uint8)
    require(np.array_equal(data_io.decode_png_u16(png), want)
            and back.shape == (375, 1242),
            "demo --save-png decodes back to its disparity map")
    print(f"examples: demo 375x1242 D=192: latency {rec['latency_ms']:.4f} "
          f"ms device time (CUDA events), EPE {rec['metrics']['epe']:.4f} "
          f"px, coverage {rec['metrics']['coverage']:.4f}; --save-png "
          f"decoded back ({card})")
    hold_example("demo", rec["maps"], rec["camera"], rec["projector"], 192,
                 15)
    return out


# ---------------------------------------------------------------------------
# The tile tuner (ops/tuning.py) and the tiled rounds kernels
# ---------------------------------------------------------------------------

# The tuned shapes: (kind, H, W, D, k); KITTI for K3, K1 and K4, and
# serve's bucket (the 330 x 422 capture rounded up to 64 x 128) for K3.
TUNE_CASES = (("pipeline",) + KITTI, ("volume",) + KITTI,
              ("trainable_bwd",) + KITTI, ("pipeline", 384, 512, 48, 15))
def rounds_registers(lib_log: str) -> list:
    """Registers and spill bytes of every instantiation of the rounds
    kernels of K1, the K3 family and K4 in the build's ptxas report:
    [(translation unit, demangled kernel, registers, spill stores, spill
    loads)], names demangled by ``c++filt`` where the machine has it."""
    rows, entry = [], None
    for line in lib_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1)
            continue
        if entry is None or not re.search(
                r"_(fused_pipeline|fused_pipeline_tile\d+|zncc_banded|"
                r"fused_pipeline_bwd|fused_pipeline_bwd_tile\d+)_cu_",
                entry) or not re.search(
                    r"fused_pipeline_kernel|camera_grad_rounds_kernel",
                    entry):
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            unit = re.search(r"_([a-z_]+\d*)_cu_", entry).group(1)
            rows.append([unit, entry, None, int(m.group(1)),
                         int(m.group(2))])
        m = re.search(r"Used (\d+) registers", line)
        if m and rows and rows[-1][1] == entry and rows[-1][2] is None:
            rows[-1][2] = int(m.group(1))
            entry = None
    try:
        names = subprocess.run(
            ["c++filt"], input="\n".join(r[1] for r in rows),
            capture_output=True, text=True, check=True).stdout.splitlines()
    except (OSError, subprocess.CalledProcessError):
        names = [r[1] for r in rows]
    for r, name in zip(rows, names):
        name = name.replace("custereo::(anonymous namespace)::", "")
        r[1] = name[:name.rfind(">(") + 1] if ">(" in name else name
    return [tuple(r) for r in rows]


def tune_outputs(kind: str, cam, proj, D: int, k: int, blocks, res=None,
                 cot=None):
    """``kind``'s kernel at ``blocks`` on one pair: K1's volume, K3's four
    maps, or K4's gradient on ``res`` and the cotangents ``cot``."""
    rows, planes = blocks
    if kind == "volume":
        return cost_volume_banded_cuda(cam, proj, D, k, EPS, rows, planes)
    if kind == "pipeline":
        return torch.stack(stereo_pipeline_cuda(cam, proj, D, k, EPS, 50.0,
                                                THRESHOLD, rows, planes))
    return fused_pipeline_bwd_cuda(cam, proj, res, *cot, D, k, EPS, 50.0,
                                   rows)


def train_outputs(cam, proj, D: int, k: int, blocks) -> list:
    """K3w's and K3m's outputs at ``blocks``: K3w's four maps, its am, s,
    t and volume, and K3m's four maps and am, s, t."""
    out = []
    for save_volume in (True, False):
        maps, res = fused_pipeline_train_cuda(cam, proj, D, k, EPS, 50.0,
                                              THRESHOLD, save_volume,
                                              *blocks)
        out += [*maps, res.am, res.s, res.t]
        if save_volume:
            out.append(res.volume)
    return out


def hold_plain(kind: str, got, cam, proj, D: int, k: int, res, cot,
               label: str) -> float:
    """A tile's output against the plain version at the tolerances of
    phases 3, 4 and 8 (PERF.md section 2)."""
    if kind == "volume":
        return compare_volume(got, forward_banded(cam, proj, D, k, EPS),
                              label)
    if kind == "pipeline":
        want = stereo_pipeline_reference(cam, proj, D, k, EPS, 50.0,
                                         THRESHOLD)
        return compare_maps(PipelineMaps(*got.unbind(0)), want,
                            forward_banded(cam, proj, D, k, EPS), THRESHOLD,
                            False, label)
    want = fused_pipeline_bwd_reference(cam, proj, res, *cot, D, k, EPS,
                                        50.0)
    return compare_grad(got, want, label, elementwise=False)


def tune_case(card: str, rates: dict, budget: int, log: dict, kind: str,
              H: int, W: int, D: int, k: int) -> dict:
    """One of ``TUNE_CASES`` through the tuner (its timings in ``log``,
    :func:`recording_tuner`), as :func:`phase_tuning` says."""
    case = (kind, H, W, D, k)
    cands = tuning.candidate_blocks(kind, H, W, D, k, budget)
    ranked = tuning._rank_candidates(kind, cands, H, W, D, k)
    default = cands[0]
    require(default in tuning._measured(ranked, default, 6),
            f"tuning {case}: the default tile is measured")
    require(default[0] == km.K_TILE_H,
            f"tuning {case}: the default tile leads the candidates")
    tune = {"pipeline": tuning.autotune_pipeline_blocks,
            "volume": tuning.autotune_volume_blocks,
            "trainable_bwd": tuning.autotune_trainable_bwd_blocks}[kind]
    t0 = time.perf_counter()
    winner = tune(H, W, D, k)
    seconds = time.perf_counter() - t0
    key = next(key for key in log if key[:5] == case)
    measured = {b: 1e3 * s for b, s in log[key]}
    if kind == "trainable_bwd":
        winner = next(b for b in measured if b[0] == winner)
    model = {b: tuning.model_ms(kind, b, H, W, D, k, rates)
             for b in cands}
    print(f"tuning {case}: {len(cands)} candidates {cands}, model order "
          f"{ranked}; measured the top {len(measured)} in {seconds:.2f} s "
          f"({card})")
    cam, proj = uniform_pair(1700 + H, 1, H, W)
    res = cot = None
    if kind == "trainable_bwd":
        res = fused_pipeline_train_cuda(cam, proj, D, k, EPS, 50.0,
                                        THRESHOLD)[1]
        cot = cotangents(1701, 1, H, W)
    ref = tune_outputs(kind, cam, proj, D, k, default, res, cot)
    train_ref = (train_outputs(cam, proj, D, k, default)
                 if kind == "pipeline" else [])
    for b in measured:
        got = tune_outputs(kind, cam, proj, D, k, b, res, cot)
        require(torch.equal(got, ref),
                f"tuning {case}: tile {b} bit-equal to the default "
                f"tile {default}")
        if train_ref:
            # K3w's and K3m's residuals at the same tile.
            require(all(torch.equal(g, w) for g, w in zip(
                train_outputs(cam, proj, D, k, b), train_ref)),
                f"tuning {case}: K3w and K3m at tile {b} bit-equal to "
                f"the default tile")
        hold_plain(kind, got, cam, proj, D, k, res, cot,
                   f"tuned {kind} tile {b} {H}x{W} D={D} k={k}")
        print(f"tuning {case}: tile {b} model {model[b]:.4f} ms, "
              f"measured {measured[b]:.4f} ms, bit-equal to the default "
              f"tile ({card})")
        del got
    if default not in measured:
        measured_default = 1e3 * tuning._slope_time(
            lambda: tune_outputs(kind, cam, proj, D, k, default, res,
                                 cot))
    else:
        measured_default = measured[default]
    print(f"tuning {case}: winner {winner} {measured[winner]:.4f} ms "
          f"(model {model[winner]:.4f}), default {default} "
          f"{measured_default:.4f} ms (model {model[default]:.4f}): "
          f"{measured_default / measured[winner]:.3f} times the winner's "
          f"time ({card})")
    # Re-run from the disk cache: a new process's view, nothing
    # measured.
    tuning._CACHE.clear()
    n = sum(map(len, log.values()))
    again = tune(H, W, D, k)
    require(sum(map(len, log.values())) == n and again == (
        winner[0] if kind == "trainable_bwd" else winner),
        f"tuning {case}: the winner comes back from the disk cache")
    got = tune_outputs(kind, cam, proj, D, k, winner, res, cot)
    require(torch.equal(got, ref), f"tuning {case}: cached winner "
            f"{winner} bit-equal to the default tile")
    hold_plain(kind, got, cam, proj, D, k, res, cot,
               f"cached winner {kind} {winner} {H}x{W} D={D} k={k}")
    del cam, proj, res, cot, ref, got, train_ref
    torch.cuda.empty_cache()
    return {"measured": measured, "winner": winner,
            "default": (default, measured_default), "model": model}


@contextlib.contextmanager
def recording_tuner():
    """Records what ``ops.tuning`` times while the context is open:
    yields {key: [(blocks, seconds a call)]} of every ``_tune`` call, its
    ``build`` wrapped so each timed call carries its blocks to the
    wrapped ``_slope_time`` (a disk or in-process cache hit adds
    nothing)."""
    from unittest import mock

    log = {}
    tune, slope = tuning._tune, tuning._slope_time

    def recording_tune(key, candidates, build, measure_top, probe=True):
        timed = log.setdefault(key, [])

        def tagged(rows, planes):
            fn = build(rows, planes)

            def call():
                return fn()

            call.record = lambda t: timed.append(((rows, planes), t))
            return call

        return tune(key, candidates, tagged, measure_top, probe)

    def recording_slope(fn, *args, **kwargs):
        t = slope(fn, *args, **kwargs)
        getattr(fn, "record", lambda t: None)(t)
        return t

    with mock.patch.object(tuning, "_tune", recording_tune), \
            mock.patch.object(tuning, "_slope_time", recording_slope):
        yield log


def phase_tuning(card: str, rates: dict) -> dict:
    """The tuner from an empty cache (``CUSTEREO_TUNE_CACHE`` at a temp
    file) at ``TUNE_CASES``: every candidate it measured
    bit-equal to the default tile's output and held against the plain
    version, its model and measured ms printed; the winner beside the
    default's ms (measured here if the tuner did not), re-run from the disk
    cache with nothing measured, against the plain version; then
    ``StereoEngine(autotune=True)`` and ``serve --autotune`` on the card,
    their maps bit-equal to the untuned engine's.  Returns {(kind, H, W,
    D, k): {"measured": {blocks: ms}, "winner": blocks, "default": (blocks,
    ms), "model": {blocks: ms}}}."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    os.unlink(path)
    os.environ["CUSTEREO_TUNE_CACHE"] = path
    tuning._CACHE.clear()
    budget = cuda_zncc.smem_floats(torch.device("cuda"))
    out = {}
    t_all = time.perf_counter()
    with recording_tuner() as log:
        for case in TUNE_CASES:
            out[case] = tune_case(card, rates, budget, log, *case)
    disk = json.loads(open(path).read())
    print(f"tuning: {len(disk)} winners on disk in "
          f"{time.perf_counter() - t_all:.1f} s: {disk}")
    require(len(disk) == len(TUNE_CASES), "tuning: a disk entry a case")

    # The engine and serve with autotune, on the card.
    H, W = 330, 422
    D, k = 48, 15
    cfg = StereoConfig(kernel_size=k, num_disparities=D)
    tuned = StereoEngine(cfg, buckets=[(384, 512)], autotune=True,
                         device="cuda")
    plain = StereoEngine(cfg, buckets=[(384, 512)], device="cuda")
    tuned.warmup()
    require(tuned.autotune and (384, 512) in tuned.tuned_tiles,
            "StereoEngine(autotune=True) tuned its bucket")
    frames = speckle_frames(2, seed=41)
    for cam, proj in zip(frames[0], frames[1]):
        cam, proj = cam[:H, :W], proj[:H, :W]
        got, want = tuned.infer(cam, proj), plain.infer(cam, proj)
        for name in got._fields:
            require(np.array_equal(getattr(got, name), getattr(want, name)),
                    f"tuned engine: {name} bit-equal to the untuned engine")
        hold_example("tuned engine", got, cam, proj, D, k)
    print(f"tuning: StereoEngine(autotune=True) bucket (384, 512): tile "
          f"{tuned.tuned_tiles[(384, 512)]}, maps bit-equal to the untuned "
          f"engine's ({card})")
    rec = {}
    rc = serve.main(["--autotune", "--loops", "2"], rec)
    require(rc == 0, "serve --autotune exits 0")
    hold_example("serve --autotune", rec["maps"][0], rec["camera"],
                 rec["projector"], D, k)
    os.environ.pop("CUSTEREO_TUNE_CACHE")
    os.unlink(path)
    return out


def phase_tiled_path(card: str) -> tuple:
    """The tiles other than the default through the entry points: for
    each, counted, a ``StereoMatcher`` whose config sets
    ``pipeline_blocks`` (that tile at its own planes) and
    ``trainable_bwd_block_rows`` serves a KITTI pair (K3) and takes a
    training step's forward and backward (K3w + K4), the volume-free
    trainable pipeline at that tile runs forward (K3m), and K1 writes the
    volume at that tile; every tiled kernel launched, no plain version
    run, every output bit-equal to the default tile's and held against
    its plain version on the same inputs (K1's and K3w's volumes as phase
    3, the K3 family's maps as phase 4, K4's gradient as phase 8).
    Returns
    ({"k1t8": launches, ...}, {"K1t8": max abs error, ...})."""
    H, W, D, k = KITTI
    cam, proj = uniform_pair(1800, 1, H, W)
    target = torch.rand((1, H, W), device="cuda",
                        generator=torch.Generator("cuda").manual_seed(1801))
    base = StereoConfig(kernel_size=k, num_disparities=D)

    def loss_of(out):
        return ((out.soft_disparity - target) ** 2).mean()

    def run(cfg, tile):
        model = StereoMatcher(cfg)
        maps = model.disparity_maps(cam, proj)
        c = cam.clone().requires_grad_(True)
        out = model.trainable_disparity_maps(c, proj)
        loss_of(out).backward()
        free = stereo_pipeline_trainable(cam, proj, D, k, EPS, 50.0,
                                         THRESHOLD, False, *tile)
        vol = cost_volume_banded_cuda(cam, proj, D, k, EPS, *tile)
        return (torch.stack(maps), torch.stack(out).detach(), c.grad,
                torch.stack(free), vol)

    want = run(base, (km.K_TILE_H, 0))
    plain = plain_trainable(cam, proj, D, k, 50.0, loss_of)
    plain_vol = forward_banded(cam, proj, D, k, EPS)
    plain_maps = stereo_pipeline_reference(cam, proj, D, k, EPS, 50.0,
                                           THRESHOLD)
    counts, errs = {}, {}
    for th in OTHER_TILES:
        tile = (th, km.round_planes(k, D, None, th))
        cfg = dataclasses.replace(base, pipeline_blocks=tile,
                                  trainable_bwd_block_rows=th)
        before = COUNTS.copy()
        got = run(cfg, tile)
        seen = launched(before)
        print(f"tiled path: tile {tile}: launched "
              f"{dict(sorted(seen.items()))}")
        require(not plain_calls(seen),
                f"tiled path {tile}: no plain version ran")
        for key in TILE_KERNEL_KEYS:
            counts[f"{key.lower()}t{th}"] = seen[key]
            require(seen[key] >= 1,
                    f"tiled path: {key} launched at {th} rows")
        for name, g, w in zip(("K3 maps", "K3w maps", "K4 gradient",
                               "K3m maps", "K1 volume"), got, want):
            require(torch.equal(g, w), f"tiled path {tile}: {name} "
                    f"bit-equal to the default tile's")
        k3, k3w, grad, k3m, vol = got
        label = f"tile {tile} H={H} W={W} D={D} k={k}"
        errs[f"K1t{th}"] = compare_volume(vol, plain_vol, label)
        errs[f"K3t{th}"] = compare_maps(PipelineMaps(*k3), plain_maps,
                                        plain_vol, THRESHOLD, False,
                                        f"{label} (K3)")
        # K3w's volume at the tile (its residual), and its maps.
        res = fused_pipeline_train_cuda(cam, proj, D, k, EPS, 50.0,
                                        THRESHOLD, True, *tile)[1]
        errs[f"K3wt{th}"] = max(
            compare_volume(res.volume.permute(0, 2, 3, 1), plain_vol,
                           f"volume {label}", kernel="K3w"),
            compare_maps(PipelineMaps(*k3w), plain_maps, plain_vol,
                         THRESHOLD, False, f"{label} (K3w)"))
        errs[f"K3mt{th}"] = compare_maps(PipelineMaps(*k3m), plain_maps,
                                         plain_vol, THRESHOLD, False,
                                         f"{label} (K3m)")
        errs[f"K4t{th}"] = hold_against_plain(
            grad, PipelineMaps(*k3w), res.am, plain, k, label, False)
        print(f"tiled path: tile {tile} (K4 {th} rows) at KITTI: K3, K3w, "
              f"K4, K3m and K1 bit-equal to the default tile and held "
              f"against their plain versions ({card})")
        del got, res
    del want, plain, plain_vol, plain_maps
    torch.cuda.empty_cache()
    return counts, errs


def tile_times(card: str, tuned: dict, times: dict, rates: dict) -> dict:
    """Each tiled kernel at KITTI at its tile's best measured planes (the
    tuner's, else the tile's own): {key: (ms, plain ms, library ms,
    (bound ms, by), (model ms, by))}, the plain version's and the bound
    those of the default tile's kernel (the same function) in this
    run."""
    H, W, D, k = KITTI
    cam, proj = uniform_pair(0, 1, H, W)
    cams, projs, _ = speckle_frames(1, seed=7)
    scam, sproj = torch.from_numpy(cams).cuda(), torch.from_numpy(projs).cuda()
    pipe = (scam, sproj, D, k, EPS, 50.0, THRESHOLD)
    res = fused_pipeline_train_cuda(*pipe)[1]
    gs, gc = cotangents(1, 1, H, W)
    out = {}

    def planes_at(kind, th):
        measured = tuned[(kind,) + KITTI]["measured"]
        at = {b: ms for b, ms in measured.items() if b[0] == th}
        if at:
            return min(at, key=at.get)[1]
        return km.round_planes(k, D, None, th)

    for th in OTHER_TILES:
        p3, p1 = planes_at("pipeline", th), planes_at("volume", th)
        cases = (
            ("K1", lambda: cost_volume_banded_cuda(cam, proj, D, k, EPS, th,
                                                   p1),
             km.volume_forward_cost(H, W, D, k, th, p1)),
            ("K3", lambda: stereo_pipeline_cuda(*pipe, th, p3),
             km.fused_forward_cost(H, W, D, k, tile_rows=th, planes=p3)),
            ("K3w", lambda: fused_pipeline_train_cuda(*pipe, True, th, p3),
             km.fused_forward_cost(H, W, D, k, True, tile_rows=th,
                                   planes=p3)),
            ("K3m", lambda: fused_pipeline_train_cuda(*pipe, False, th, p3),
             km.fused_forward_cost(H, W, D, k, residuals=True, tile_rows=th,
                                   planes=p3)),
            ("K4", lambda: fused_pipeline_bwd_cuda(*pipe[:2], res, gs, gc, D,
                                                   k, EPS, 50.0, th),
             km.fused_backward_c_cost(H, W, D, k, th)))
        for key, fn, cost in cases:
            ms = timed(f"{key} at {th} rows", fn)
            m_ms, m_by, _ = model_bound(cost, rates)
            _, plain_ms, library_ms, bound_, _ = times[key]
            print(f"time: {key} at tile {th} rows at KITTI: {ms:.4f} ms, "
                  f"the default tile {times[key][0]:.4f} ms, bound "
                  f"{bound_[0]:.4f} ms, model {m_ms:.4f} ms ({card})")
            require(m_ms <= ms, f"{key} at {th} rows: its model bound "
                    f"({m_ms:.4f} ms) within its time ({ms:.4f} ms)")
            out[f"{key}t{th}"] = (ms, plain_ms, library_ms, bound_,
                                  (m_ms, m_by))
    del cam, proj, scam, sproj, res
    torch.cuda.empty_cache()
    return out


BENCH_TIMEOUT_S = 420


def phase_bench(card: str) -> dict:
    """``python -m custereomatching_tpu_torch.bench`` at KITTI in a
    subprocess from this checkout: exit 0, one stdout line, the summary on
    the card, the headline and ``vs_baseline`` in (0, 1.05], every
    secondary measurement present and finite (the decoder's name aside),
    the parity check's differing pixels all top-two ties, the pyramid's
    accuracy within PERF.md's limits."""
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m",
                        "custereomatching_tpu_torch.bench"],
                       cwd=os.path.dirname(os.path.abspath(__file__)),
                       capture_output=True, text=True,
                       timeout=BENCH_TIMEOUT_S)
    seconds = time.perf_counter() - t0
    for line in r.stderr.splitlines():
        print(f"bench: {line}")
    require(r.returncode == 0, f"bench exit 0 (got {r.returncode})")
    lines = r.stdout.splitlines()
    require(len(lines) == 1, f"bench stdout one line (got {len(lines)})")
    summary = json.loads(lines[0])
    sec = summary["secondary"]
    print(f"bench: headline {summary['metric']} {summary['value']:.3f} "
          f"{summary['unit']}, vs_baseline {summary['vs_baseline']:.4f}, "
          f"device {summary['device']}; {seconds:.1f} s ({card})")
    print(f"bench: secondary {json.dumps(sec)}")
    require(summary["device"]["platform"] == "gpu"
            and summary["device"]["name"] == torch.cuda.get_device_name(0),
            "bench ran on the card")
    require(summary["value"] > 0 and 0 < summary["vs_baseline"] <= 1.05,
            "bench headline > 0 and vs_baseline in (0, 1.05]")
    require(all(isinstance(v, (int, float)) and np.isfinite(v)
                for name, v in sec.items() if name != "e2e_decoder"),
            "every bench secondary measurement present and finite")
    require(sec["parity_differing_pixels"]
            == sec["parity_differing_top2_ties"],
            "every hard-disparity pixel differing from the plain path a "
            "top-two tie")
    require(sec["pyramid_epe_px"] <= 0.30 and sec["pyramid_coverage"] >= 0.97,
            "bench pyramid accuracy: EPE <= 0.30 px and coverage >= 0.97")
    return summary


LARGE_KERNELS = (
    # name, key, replaces
    ("large_k_banded_volume", "K1L",
     "custereomatching_tpu/ops/pallas_zncc.py:156"),
    ("large_k_fused_pipeline", "K3L",
     "custereomatching_tpu/ops/pallas_pipeline.py:120"),
    ("large_k_fused_pipeline_train", "K3wL",
     "custereomatching_tpu/ops/pallas_pipeline.py:120"),
    ("large_k_fused_pipeline_train_maps", "K3mL",
     "custereomatching_tpu/ops/pallas_pipeline.py:120"),
    ("large_k_camera_vjp", "K2L",
     "custereomatching_tpu/ops/pallas_zncc_bwd.py:54"),
    ("large_k_camera_vjp_recompute", "K6L",
     "custereomatching_tpu/ops/pallas_zncc_bwd.py:54"),
    ("large_k_fused_pipeline_bwd", "K4L",
     "custereomatching_tpu/ops/pallas_pipeline.py:803"),
    ("large_k_fused_pipeline_bwd_recompute", "K5L",
     "custereomatching_tpu/ops/pallas_pipeline.py:510"),
    ("large_k_projector_vjp", "K7L",
     "custereomatching_tpu/ops/pallas_zncc_bwd.py:607"),
    ("large_k_allpairs_volume", "K8L",
     "custereomatching_tpu/ops/pallas_allpairs.py:60"),
)


KERNELS = (
    # name, key, source, replaces, the path whose launches count it
    ("zncc_banded_volume", "K1", "custereomatching_tpu_torch/csrc/"
     "zncc_banded.cu", "custereomatching_tpu/ops/pallas_zncc.py:156",
     "serve"),
    ("fused_pipeline", "K3", "custereomatching_tpu_torch/csrc/"
     "fused_pipeline.cu", "custereomatching_tpu/ops/pallas_pipeline.py:120",
     "serve"),
    ("zncc_banded_camera_vjp", "K2", "custereomatching_tpu_torch/csrc/"
     "zncc_banded_bwd.cu",
     "custereomatching_tpu/ops/pallas_zncc_bwd.py:54", "train"),
    ("fused_pipeline_train", "K3w", "custereomatching_tpu_torch/csrc/"
     "fused_pipeline.cu", "custereomatching_tpu/ops/pallas_pipeline.py:120",
     "train"),
    ("fused_pipeline_bwd", "K4", "custereomatching_tpu_torch/csrc/"
     "fused_pipeline_bwd.cu",
     "custereomatching_tpu/ops/pallas_pipeline.py:803", "train"),
    ("zncc_allpairs_volume", "K8", "custereomatching_tpu_torch/csrc/"
     "zncc_allpairs.cu", "custereomatching_tpu/ops/pallas_allpairs.py:60",
     "allpairs"),
    ("zncc_banded_projector_vjp", "K7", "custereomatching_tpu_torch/csrc/"
     "zncc_banded_proj_bwd.cu",
     "custereomatching_tpu/ops/pallas_zncc_bwd.py:607", "grad_projector"),
    ("zncc_banded_camera_vjp_recompute", "K6",
     "custereomatching_tpu_torch/csrc/zncc_banded_bwd.cu",
     "custereomatching_tpu/ops/pallas_zncc_bwd.py:54", "no_residual"),
    ("fused_pipeline_train_maps", "K3m", "custereomatching_tpu_torch/csrc/"
     "fused_pipeline.cu", "custereomatching_tpu/ops/pallas_pipeline.py:120",
     "volume_free"),
    ("fused_pipeline_bwd_recompute", "K5", "custereomatching_tpu_torch/csrc/"
     "fused_pipeline_bwd.cu",
     "custereomatching_tpu/ops/pallas_pipeline.py:510", "volume_free"),
    ("plane_major_to_parity", "K9a",
     "custereomatching_tpu_torch/csrc/layout.cu",
     "custereomatching_tpu/ops/pallas_layout.py:53", "no_residual"),
    ("parity_to_plane_major", "K9b",
     "custereomatching_tpu_torch/csrc/layout.cu",
     "custereomatching_tpu/ops/pallas_layout.py:161", "no_residual"),
    ("rate_probe", "K10a", "custereomatching_tpu_torch/csrc/rate_probes.cu",
     "custereomatching_tpu/utils/kernel_model.py:83", "bound_model"),
    ("hbm_read_probe", "K10b",
     "custereomatching_tpu_torch/csrc/rate_probes.cu",
     "custereomatching_tpu/utils/kernel_model.py:228", "bound_model"),
    ("hbm_write_probe", "K10c",
     "custereomatching_tpu_torch/csrc/rate_probes.cu",
     "custereomatching_tpu/utils/kernel_model.py:269", "bound_model"),
)


# The rounds kernels' instantiations at the tiles other than the default
# (name, key, source, replaces): their launches are the tiled path's.
TILE_KERNELS = tuple(
    (f"{name}_tile{th}", f"{key}t{th}",
     f"custereomatching_tpu_torch/csrc/{unit}{th}.cu", replaces)
    for th in OTHER_TILES
    for name, key, unit, replaces in (
        ("zncc_banded_volume", "K1", "fused_pipeline_tile",
         "custereomatching_tpu/ops/pallas_zncc.py:156"),
        ("fused_pipeline", "K3", "fused_pipeline_tile",
         "custereomatching_tpu/ops/pallas_pipeline.py:120"),
        ("fused_pipeline_train", "K3w", "fused_pipeline_tile",
         "custereomatching_tpu/ops/pallas_pipeline.py:120"),
        ("fused_pipeline_train_maps", "K3m", "fused_pipeline_tile",
         "custereomatching_tpu/ops/pallas_pipeline.py:120"),
        ("fused_pipeline_bwd", "K4", "fused_pipeline_bwd_tile",
         "custereomatching_tpu/ops/pallas_pipeline.py:803")))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    card = phase_env()
    phase_build()
    errs = {"K1": phase_k1(), "K3": phase_k3()}
    counts = {"serve": phase_main_path()}
    errs["K2"] = phase_k2()
    errs["K3w"] = phase_k3w()
    errs["K4"] = phase_k4()
    counts["train"] = phase_train_path()
    errs["K8"] = phase_k8()
    errs["K8b"] = phase_k8b()
    head = phase_volume_head(card)
    errs["K7"] = phase_k7()
    counts["allpairs"] = phase_allpairs_path()
    counts["grad_projector"] = phase_grad_projector_path()
    errs["K6"] = phase_k6()
    errs["K9a"] = errs["K9b"] = phase_k9()
    errs["K3m"] = phase_k3m()
    errs["K5"] = phase_k5()
    for name, err in phase_past_limits().items():
        errs[name] = max(errs[name], err)
    counts["volume_free"] = phase_volume_free_path()
    counts["plane_major"] = phase_plane_major_path()
    counts["no_residual"] = phase_no_residual_path()
    errs.update(phase_k10())
    counts["bound_model"], rates = phase_bound_model(card)
    times = phase_times(card, rates)
    phase_large_k_times(card, rates)
    errs["K8"] = max(errs["K8"], phase_k8_k1())
    counts["allpairs_k1"] = phase_allpairs_k1_path()
    for key, err in phase_large_k().items():
        errs[key] = max(errs.get(key, 0.0), err)
    counts["large_k"] = phase_large_k_path()
    phase_route_pin(card)
    lk_times, lk_errs = phase_large_k_route_times(card, rates)
    times.update(lk_times)
    device_profile.mode_large_k()
    for key, err in lk_errs.items():
        errs[key] = max(errs.get(key, 0.0), err)
    counts["lr"] = phase_lr_engine(card)
    counts["pyramid"] = phase_pyramid(card)
    glue = phase_pyramid_glue(card)
    phase_failsafe()
    ref = phase_parallel_unsharded()
    counts["parallel"] = phase_parallel_one_rank(card, ref)
    phase_parallel_compute(card, rates, ref)
    del ref
    with tempfile.TemporaryDirectory() as tmp:
        phase_data(tmp)
        for key, err in phase_golden().items():
            errs[key] = max(errs[key], err)
        for key, err in phase_fuzz().items():
            errs[key] = max(errs[key], err)
        phase_examples(card, tmp)
    tuned = phase_tuning(card, rates)
    counts["tiled"], tile_errs = phase_tiled_path(card)
    errs.update(tile_errs)
    times.update(tile_times(card, tuned, times, rates))
    phase_bench(card)

    kernels = []
    for name, key, source, replaces, path in KERNELS:
        ms, plain_ms, library_ms, (bound_ms, bound_by), (model_ms, model_by) \
            = times[key]
        launches = counts[path][key]
        require(launches >= 1, f"{key} launched on its path ({path})")
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": errs[key], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "model_ms": model_ms,
            "model_by": model_by})
    for name, key, replaces in LARGE_KERNELS:
        ms, plain_ms, library_ms, (bound_ms, bound_by), (model_ms, model_by) \
            = times[key]
        launches = counts["large_k"][f"route.{LARGE_ROUTES[key]}"]
        require(launches >= 1, f"{key} launched on the large-k path")
        kernels.append({
            "name": name, "route": "cuda",
            "source": "custereomatching_tpu_torch/csrc/large_k.cu",
            "replaces": replaces, "launches": launches,
            "max_abs_err": errs[key], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "model_ms": model_ms,
            "model_by": model_by})
    for name, key, source, replaces in TILE_KERNELS:
        ms, plain_ms, library_ms, (bound_ms, bound_by), (model_ms, model_by) \
            = times[key]
        launches = counts["tiled"][key.lower()]
        require(launches >= 1, f"{key} launched on the tiled path")
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": errs[key], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms,
            "model_ms": model_ms, "model_by": model_by})
    # K8b ports no TPU kernel (the JAX package leaves the all-pairs camera
    # VJP to XLA), so it has a record of its own beside the table's.
    ms, plain_ms, _, (bound_ms, bound_by), (model_ms, model_by) = \
        times["K8b"]
    require(counts["allpairs"]["K8b"] == 1, "K8b launched on its path")
    print(json.dumps({"k8b": {
        "name": "zncc_allpairs_camera_vjp", "route": "cuda",
        "source": "custereomatching_tpu_torch/csrc/zncc_allpairs_bwd.cu",
        "replaces": None, "launches": counts["allpairs"]["K8b"],
        "max_abs_err": errs["K8b"], "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "model_ms": model_ms,
        "model_by": model_by}}))
    # K8h and K8hb port no TPU kernel either (the JAX package leaves the
    # head to XLA).
    for key, (err, ms, plain_ms, (bound_ms, bound_by)) in head.items():
        require(counts["allpairs"][key] == 1, f"{key} launched on its path")
        print(json.dumps({key.lower(): {
            "name": {"K8h": "volume_head",
                     "K8hb": "volume_head_vjp"}[key], "route": "cuda",
            "source": "custereomatching_tpu_torch/csrc/volume_head.cu",
            "replaces": None, "launches": counts["allpairs"][key],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}}))
    # K11p, K11w and K11c port no TPU kernel either (the JAX package
    # leaves the pyramid's glue to XLA).
    for key, (err, ms, plain_ms, (bound_ms, bound_by)) in glue.items():
        require(counts["pyramid"][key] == 1, f"{key} launched on its path")
        print(json.dumps({key.lower(): {
            "name": {"K11p": "pyramid_pool", "K11w": "pyramid_warp",
                     "K11c": "pyramid_compose"}[key], "route": "cuda",
            "source": "custereomatching_tpu_torch/csrc/pyramid_glue.cu",
            "replaces": None, "launches": counts["pyramid"][key],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}}))
    bench.write_smoke_record(True, card)
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:
        # Only a run on the card has a record to write.
        if torch.cuda.is_available():
            bench.write_smoke_record(False, card_line())
        raise
