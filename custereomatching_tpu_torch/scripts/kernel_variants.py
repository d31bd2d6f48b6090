"""Copies of the port's kernels with one edit each, checked against this
tree bit for bit and timed against it on one CUDA card.

    python -m custereomatching_tpu_torch.scripts.kernel_variants \\
        [--against DIR]... NAME...
    python -m custereomatching_tpu_torch.scripts.kernel_variants \\
        --ab DIR [--rounds N]

Each NAME of ``VARIANTS`` is a copy of the package under
``build/variants/NAME`` with one edit of ``csrc/camera_grad.cuh`` (the
rounds kernel of K2, K4 and K6), for a ``k7_`` name of
``csrc/zncc_banded_proj_bwd.cu`` (K7's), for a ``k8_`` name of
``csrc/zncc_allpairs.cu``, for a ``k9_`` name of ``csrc/layout.cu``
(K9a's) or for a ``k10`` name of ``csrc/rate_probes.cu`` (K10b's and
K10c's): another round size, the ring's entries split in half rounds,
K8's rows in run-time loops, K9a's block shape, K10c's blocks
interleaved over the volume, or one phase cut (timing
only: the values are then wrong).  Each tree runs in its own process, with ``PYTHONPATH``
at it:

1. K1's and K8's volumes, K9a's parity copy of K1's, and K2's, K4's,
   K5's, K6's and K7's gradients on fixed inputs (KITTI and small shapes at k = 3, 27, 31, 47, 81 and
   93; K8 at the same k on the images' first rows), K10b's sums and
   K10c's volume at ``kernel_model.HBM_EDGE_SHAPES``, and the outputs of
   the large-k route's ten routes (``ops/cuda_large_k.py``: K1L-K7L at
   KITTI with k = 129 and at 40x130 with k = 131 and 255, K8L at 330x422
   with k = 145 and at 40x130 with k = 131 and 255), compared bit for
   bit with this tree's: every variant that keeps the values, and every
   ``--against`` tree (another checkout, e.g. the parent commit's ``git
   archive``), on the outputs both trees give (a tree whose kernel refuses
   a k gives none there);
2. ``device_profile kernels`` (K1-K10c device ms) for this tree and
   every variant in turns, then in the reverse order.

With ``--ab DIR`` it instead times every kernel of ``device_profile
kernels`` and every route of ``device_profile large_k`` in one process
on the same inputs, through this tree's wrappers, on this tree's kernel
library and on the one DIR's sources build (their C interface must be
this tree's; DIR may also name a variant, whose copy is made first), the
two back to back for each kernel and which goes first alternating from
round to round; it
prints each kernel's medians, their ratio and the rounds each side won.
Between processes the same kernel's time moves by a few percent; this
comparison does not pay for that.

Needs a CUDA card and nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import shutil
import subprocess
import sys
from pathlib import Path
from typing import Dict, List, Tuple

ROOT = Path(__file__).resolve().parents[2]
PACKAGE = "custereomatching_tpu_torch"
SOURCE = "csrc/camera_grad.cuh"
K7_SOURCE = "csrc/zncc_banded_proj_bwd.cu"
K8_SOURCE = "csrc/zncc_allpairs.cu"
K9_SOURCE = "csrc/layout.cu"
K10_SOURCE = "csrc/rate_probes.cu"
CASES = ((375, 1242, 192, 15), (40, 130, 24, 31), (40, 130, 24, 47),
         (37, 200, 24, 3), (40, 130, 24, 27), (40, 130, 24, 81),
         (40, 130, 24, 93), (40, 130, 24, 127))
# The large-k route's outputs (H, W, D, k): K1L-K7L; K8L (H, W, k).
ROUTE_CASES = ((375, 1242, 192, 129), (40, 130, 24, 131), (40, 130, 24, 255))
AP_ROUTE_CASES = ((330, 422, 145), (40, 130, 131), (40, 130, 255))
ROUTES = ("K1L", "K3L", "K3wL", "K3mL", "K2L", "K6L", "K4L", "K5L", "K7L")
ROUTE_EPS, ROUTE_BETA, ROUTE_THRESHOLD = 1e-8, 50.0, 0.6

_ROUND = "  for (int planes = kGradPlanes; planes >= 1; planes /= 2) {\n"
_ASSERT = ('  static_assert(kGradPlanes == 8, "the planes a round instantiated '
           'below");\n')
_CASE_1 = ("    case 1:\n"
           "      return launch_rounds<Source, kRecompute, kSlab, 1>(")
_CENTRE = ("    if (valid) {\n"
           "      const auto e = src.entry(maps, halo, centre, o);")
_RING = "    for (int q = threadIdx.x; q < ring; q += kThreads) {"


def _start(planes: int, *extra: int) -> List[Tuple[str, str]]:
    """Rounds of ``planes`` (halving from there), instantiating ``extra``
    besides the source's 8, 4, 2, 1."""
    cases = "".join(
        f"    case {p}:\n"
        f"      return launch_rounds<Source, kRecompute, kSlab, {p}>(\n"
        f"          src, camera, projector, cam_s, cam_e2, proj_s, proj_e2, "
        f"a1, bm,\n"
        f"          grmu, B, H, W, D, k, round.chunk, d_lo, d_hi, eps, "
        f"stream, tile);\n" for p in extra)
    edits = [(_ROUND, _ROUND.replace("kGradPlanes", str(planes)))]
    if extra:
        edits += [(_ASSERT, ""), (_CASE_1, cases + _CASE_1)]
    return edits


_RING_LOOP = """    // gr_d at the ring's entries.
    for (int q = threadIdx.x; q < ring; q += kThreads) {
      const int i = ring_entry<TH>(q, p, hc);
      const int rr = i / hc, cc = i - rr * hc;
      const int y = h0 - p + rr, xx = w0 - p + cc;
      float* ey = ybuf + rr * x.ys + cc;
      if (!(y >= 0 && y < H && xx >= 0 && xx < W)) {
#pragma unroll
        for (int j = 0; j < P; ++j) ey[j * x.ysz] = 0.f;
        continue;
      }
      const size_t px = static_cast<size_t>(y) * W + xx;
      const auto e = src.entry(maps, halo, i, frame + px);
      const float ex2 =
          Source::kStaged ? ex2_t[i] : __ldg(cam_e2 + frame + px);
      const size_t srow = (static_cast<size_t>(b) * H + y) * stats_w + D + xx;
      float ey2[P], v[P];
#pragma unroll
      for (int j = 0; j < P; ++j) {
        const int d = min(d0 + j, end);
        ey2[j] = __ldg(proj_e2 + srow - d);
        v[j] = __ldg(vol_b + (d - vol_first) * plane + px);
      }
#pragma unroll
      for (int j = 0; j < P; ++j) {
        const float ri = rsqrtf(ex2 * ey2[j] + eps);
        ey[j * x.ysz] =
            src.cotangent(e, v[j], static_cast<float>(d0 + j)) * ri;
      }
    }
"""

_RING_HALVES = """    // gr_d at the ring's entries, half a round an item.
    constexpr int kHalf = (P + 1) / 2;
    for (int it = threadIdx.x; it < 2 * ring; it += kThreads) {
      const int q = it >> 1, j0 = (it & 1) * kHalf;
      const int i = ring_entry<TH>(q, p, hc);
      const int rr = i / hc, cc = i - rr * hc;
      const int y = h0 - p + rr, xx = w0 - p + cc;
      float* ey = ybuf + rr * x.ys + cc;
      if (!(y >= 0 && y < H && xx >= 0 && xx < W)) {
#pragma unroll
        for (int jj = 0; jj < kHalf; ++jj)
          if (j0 + jj < P) ey[(j0 + jj) * x.ysz] = 0.f;
        continue;
      }
      const size_t px = static_cast<size_t>(y) * W + xx;
      const auto e = src.entry(maps, halo, i, frame + px);
      const float ex2 =
          Source::kStaged ? ex2_t[i] : __ldg(cam_e2 + frame + px);
      const size_t srow = (static_cast<size_t>(b) * H + y) * stats_w + D + xx;
      float ey2[kHalf], v[kHalf];
#pragma unroll
      for (int jj = 0; jj < kHalf; ++jj) {
        const int d = min(d0 + j0 + jj, end);
        ey2[jj] = __ldg(proj_e2 + srow - d);
        v[jj] = __ldg(vol_b + (d - vol_first) * plane + px);
      }
#pragma unroll
      for (int jj = 0; jj < kHalf; ++jj) {
        const float ri = rsqrtf(ex2 * ey2[jj] + eps);
        if (j0 + jj < P)
          ey[(j0 + jj) * x.ysz] =
              src.cotangent(e, v[jj], static_cast<float>(d0 + j0 + jj)) * ri;
      }
    }
"""

_K7_ROUND = "grad_round(k, D, 1, false, budget).planes"

_K8_SWEEP = """  window_sweep(acc, k, row_products, [](PairTile& s, const PairTile& r) {
#pragma unroll
    for (int a = 0; a < kApXPerThread; ++a)
#pragma unroll
      for (int c = 0; c < kApYPerThread; ++c) s.v[a][c] += r.v[a][c];
  });
"""
# K8's rows in run-time loops: one row's code, its taps predicated (the
# window sweep's order: row i adds to the outputs n with 0 <= i - n < k).
_K8_FEED = """  const auto feed = [&](int i, bool every) {
    const PairTile r = row_products(i);
#pragma unroll
    for (int n = 0; n < kApRows; ++n) {
      const int t = i - n;
      if (every || (t >= 0 && t < k))
#pragma unroll
        for (int a = 0; a < kApXPerThread; ++a)
#pragma unroll
          for (int c = 0; c < kApYPerThread; ++c)
            acc[n].v[a][c] += r.v[a][c];
    }
  };
"""
_K8_ROWS_LOOP = _K8_FEED + """  for (int i = 0; i < kApRows - 1 + k; ++i) feed(i, false);
"""
# The same in three loops: the first kApRows - 1 rows and the rows from k
# on predicated, the rows between (which feed every output) not.
_K8_ROWS_THREE = _K8_FEED + """  int i = 0;
  for (; i < min(kApRows - 1, k); ++i) feed(i, false);
  for (; i < k; ++i) feed(i, true);
  for (; i < kApRows - 1 + k; ++i) feed(i, false);
"""
_K8_STORE = ("        if (y < W) {\n"
             "          const float sum =")
# K8's grid with the strips fastest and the y tiles slowest (its first
# order): the blocks that write one row of the volume run far apart.
_K8_BLOCK = ("  const int b = blockIdx.z / strips, h0 = (blockIdx.z - b * strips) "
             "* kApRows;\n"
             "  const int x0 = blockIdx.y * kApTileX, y0 = blockIdx.x * "
             "kApTileY;")
_K8_GRID = """  const dim3 grid((W + kApTileY - 1) / kApTileY,
                  (W + kApTileX - 1) / kApTileX,
                  B * ((H + kApRows - 1) / kApRows));"""
_K8_GRID_STRIPS_FIRST = [
    (_K8_BLOCK, _K8_BLOCK.replace("blockIdx.x", "blockIdx.w").replace(
        "blockIdx.z", "blockIdx.x").replace("blockIdx.w", "blockIdx.z")),
    (_K8_GRID, """  const dim3 grid(B * ((H + kApRows - 1) / kApRows),
                  (W + kApTileX - 1) / kApTileX,
                  (W + kApTileY - 1) / kApTileY);""")]
_K8_NORM = "#pragma unroll 1\n  for (int n = 0; n < kApRows; ++n) {"
_K8_SUM = "          const float exy = sum - sx * sy[c] / k2;"
_K9_STORE = "    for (int r = lane; r < rn; r += 32) dst[r] = row[r];"
_K7_CENTRE = ("    if (valid) {\n"
              "      const float ey2 = ey2_t[centre];")
# K10c's quads in chunks of 4 kWriteThreads, chunk c to block c mod grid
# (csrc/rate_probes.cu): the blocks store side by side, one front moving
# through the volume, where the shipped kernel gives each block a span.
_K10C_SPAN = ("  long long q = blockIdx.x * per + threadIdx.x;\n"
              "  if (q >= q_end) return;\n")
_K10C_SPAN_STEP = "  for (; q < q_end; q += kWriteThreads) {\n"
_K10C_CHUNK = ("  long long q = blockIdx.x * 4LL * kWriteThreads + threadIdx.x;\n"
               "  if (q >= quads) return;\n")
_K10C_CHUNK_STEP = ("  for (; q < quads; q += (q / kWriteThreads + 1) % 4\n"
                    "                               ? kWriteThreads\n"
                    "                               : (4LL * gridDim.x - 3) *\n"
                    "                                     kWriteThreads) {\n")

# name -> (whether the values stay the source's, edits (old, new) of the
# source that source_of names)
VARIANTS: Dict[str, Tuple[bool, List[Tuple[str, str]]]] = {
    "p4": (True, _start(4)),
    "p10": (True, _start(10, 10, 5)),
    "p12": (True, _start(12, 12, 6, 3)),
    "ring_halves": (True, [(_RING_LOOP, _RING_HALVES)]),
    "cut_entries": (False, [
        (_CENTRE, _CENTRE.replace("if (valid)", "if (valid && d0 < 0)")),
        (_RING, _RING.replace("q < ring;", "q < ring && d0 < 0;"))]),
    "cut_entry_loads": (False, [
        ("""        ey2[j] = __ldg(proj_e2 + stats_row - d);
        sy[j] = __ldg(proj_s + stats_row - d);
        v[j] = __ldg(vol_b + (d - vol_first) * plane + (o - frame));""",
         """        ey2[j] = ex2 + 0.25f * d;
        sy[j] = ex2 * d;
        v[j] = 0.001f * d - ex2;"""),
        ("""        ey2[j] = __ldg(proj_e2 + srow - d);
        v[j] = __ldg(vol_b + (d - vol_first) * plane + px);""",
         """        ey2[j] = ex2 + 0.25f * d;
        v[j] = 0.001f * d - ex2;""")]),
    "cut_passes": (False, [
        ("    grad_rows(xbuf, ybuf, gs, k, np);\n", ""),
        ("    grad_column_sums(ybuf, xbuf, gs, k, np);\n", "")]),
    "cut_a1": (False, [
        ("    if (valid) {\n      const float* box = ybuf + r * x.bs + c;",
         "    if (valid && d0 < 0) {\n"
         "      const float* box = ybuf + r * x.bs + c;")]),
    "k7_p4": (True, [(_K7_ROUND, f"min(4, {_K7_ROUND})")]),
    "k7_cut_entries": (False, [
        (_K7_CENTRE, _K7_CENTRE.replace("if (valid)", "if (valid && d0 < 0)")),
        (_RING, _RING.replace("q < ring;", "q < ring && d0 < 0;"))]),
    "k7_cut_cost": (False, [
        ("        cv[j] = __ldg(c_b + d * plane + px);",
         "        cv[j] = e2[j] + 0.25f * d;")]),
    "k7_cut_passes": (False, [
        ("    grad_rows(xbuf, ybuf, gs, k, np);\n", ""),
        ("    grad_column_sums(ybuf, xbuf, gs, k, np);\n", "")]),
    "k7_cut_a1": (False, [
        ("    if (valid && xc >= 0) {",
         "    if (valid && xc >= 0 && d0 < 0) {")]),
    "k8_rows8": (True, [("constexpr int kApRows = 16;",
                         "constexpr int kApRows = 8;")]),
    "k8_rows_loop": (True, [(_K8_SWEEP, _K8_ROWS_LOOP)]),
    "k8_rows_three": (True, [(_K8_SWEEP, _K8_ROWS_THREE)]),
    "k8_cut_rows": (False, [(_K8_SWEEP, "  if (k < 0)\n" + _K8_SWEEP)]),
    "k8_grid_strips_first": (True, _K8_GRID_STRIPS_FIRST),
    "k8_norm_unroll2": (True, [(_K8_NORM, _K8_NORM.replace("unroll 1",
                                                          "unroll 2"))]),
    "k8_cut_norm": (False, [
        (_K8_SUM, _K8_SUM + "\n          orow[y] = sum + 0.25f;\n"
         "          continue;")]),
    "k8_cut_store": (False, [
        (_K8_STORE, _K8_STORE.replace("if (y < W)", "if (y < W && k < 0)"))]),
    "k9_pixels32": (True, [("constexpr int kParityPixels = 64;",
                            "constexpr int kParityPixels = 32;")]),
    "k9_threads256": (True, [("constexpr int kParityThreads = 512;",
                              "constexpr int kParityThreads = 256;")]),
    "k9_chunk128": (True, [("constexpr int kParityChunk = 256;",
                            "constexpr int kParityChunk = 128;")]),
    "k9_cut_load": (False, [
        ("      stage[c * stride + r] = __ldg(src + static_cast<size_t>(r) "
         "* C);", "      stage[c * stride + r] = r + 0.25f;")]),
    "k9_cut_store": (False, [
        (_K9_STORE, _K9_STORE.replace("r < rn;", "r < rn && R < 0;"))]),
    "k10c_interleaved": (True, [(_K10C_SPAN, _K10C_CHUNK),
                                (_K10C_SPAN_STEP, _K10C_CHUNK_STEP)]),
    "k10b_cut_sum": (False, [("      if (d0 + j < P) {",
                              "      if (d0 + j < P && d0 < 0) {")]),
}
# What a cut variant's edits leave in the source: its values are wrong.
CUT_MARKS = ("d0 < 0", "+ 0.25f", "k < 0", "R < 0")


def source_of(name: str) -> str:
    """The source, under the package, that variant ``name`` edits."""
    return {"k7_": K7_SOURCE, "k8_": K8_SOURCE, "k9_": K9_SOURCE,
            "k10": K10_SOURCE}.get(name[:3], SOURCE)


def edit_source(text: str, name: str) -> str:
    """``text`` (the source :func:`source_of` names) with variant
    ``name``'s edits; each edit's text must occur once."""
    for old, new in VARIANTS[name][1]:
        if text.count(old) != 1:
            raise ValueError(f"variant {name}: the edited text occurs "
                             f"{text.count(old)} times in {source_of(name)}")
        text = text.replace(old, new)
    return text


def make_variant(name: str, dest: Path) -> Path:
    """A copy of this tree's package under ``dest / name`` with ``name``'s
    edit; returns the directory to put on ``PYTHONPATH``."""
    tree = dest / name
    shutil.rmtree(tree, ignore_errors=True)
    shutil.copytree(ROOT / PACKAGE, tree / PACKAGE,
                    ignore=shutil.ignore_patterns("__pycache__"))
    path = tree / PACKAGE / source_of(name)
    path.write_text(edit_source(path.read_text(), name))
    return tree


def _flat(out) -> "torch.Tensor":
    """A route's output as one tensor: a tuple's tensors (None left out)
    flattened and joined."""
    import torch

    if isinstance(out, torch.Tensor):
        return out
    return torch.cat([t.flatten() for t in out if t is not None])


def route_inputs(H: int, W: int, D: int, k: int, device: str = "cuda",
                 seed: int = 8) -> Dict:
    """Fixed inputs of the large-k route at (H, W, D, k): a stereo pair
    ``cam``, ``proj`` ``[1, H, W]``, a random ``cost`` volume of its range
    and ``cotangent`` (plane-major), the head cotangents ``gsoft`` and
    ``gconf``, K3w's and K3m's ``residuals`` and ``residuals_m``, and the
    route's head arguments from them, ``head`` for K4L and ``head_m`` for
    K5L."""
    import torch

    from custereomatching_tpu_torch.data import make_stereo_pair
    from custereomatching_tpu_torch.ops.cuda_pipeline import (
        fused_pipeline_train_cuda,
        unnormalized_head,
    )

    cam, proj, _ = make_stereo_pair(H, W, d_min=4.0, d_max=min(D, 184.0),
                                    seed=seed)
    cam = torch.from_numpy(cam[None]).to(device)
    proj = torch.from_numpy(proj[None]).to(device)
    gen = torch.Generator(device).manual_seed(seed)
    gs = torch.randn((1, H, W), device=device, generator=gen) / (H * W)
    gc = torch.randn((1, H, W), device=device, generator=gen) / (H * W)
    g = torch.randn((1, D + 1, H, W), device=device, generator=gen) / (H * W)
    cost = torch.rand((1, D + 1, H, W), device=device, generator=gen) * 2 - 1
    unnorm = unnormalized_head(ROUTE_BETA, D)
    with torch.no_grad():
        res = fused_pipeline_train_cuda(cam, proj, D, k, ROUTE_EPS,
                                        ROUTE_BETA, ROUTE_THRESHOLD)[1]
        res_m = fused_pipeline_train_cuda(cam, proj, D, k, ROUTE_EPS,
                                          ROUTE_BETA, ROUTE_THRESHOLD,
                                          save_volume=False)[1]

    def head(r):
        return (r.am, r.mask, r.confidence, r.s, r.t, gs, gc, ROUTE_BETA,
                unnorm)

    return {"cam": cam, "proj": proj, "D": D, "k": k, "cost": cost,
            "cotangent": g, "head": head(res), "head_m": head(res_m),
            "residuals": res, "residuals_m": res_m, "gsoft": gs,
            "gconf": gc, "unnormalized": unnorm}


def route_calls(x: Dict) -> Dict:
    """{name: a call of no arguments} of the nine banded routes of
    ``ops/cuda_large_k.py`` on :func:`route_inputs`' ``x``: K1L's volume,
    K3L's four maps, K3wL's maps and volume, K3mL's maps (a tuple's
    tensors), K2L's and K7L's gradients from the random cost, K6L's with
    the cost recomputed, K4L's and K5L's from the head cotangents."""
    from custereomatching_tpu_torch.ops import cuda_large_k as lk

    cam, proj, D, k = x["cam"], x["proj"], x["D"], x["k"]
    eps, g, cost = ROUTE_EPS, x["cotangent"], x["cost"]
    pipe = (cam, proj, D, k, eps, ROUTE_BETA, ROUTE_THRESHOLD,
            x["unnormalized"])
    return {
        "K1L": lambda: lk.banded_volume_large(cam, proj, D, k, eps),
        # Without residuals the last three maps are not written.
        "K3L": lambda: lk.fused_pipeline_large(*pipe)[0][:4],
        "K3wL": lambda: lk.fused_pipeline_large(*pipe, residuals=True,
                                                volume=True),
        "K3mL": lambda: lk.fused_pipeline_large(*pipe, residuals=True),
        "K2L": lambda: lk.camera_grad_large(cam, proj, cost, g, D, k, eps),
        "K6L": lambda: lk.camera_grad_large(cam, proj, None, g, D, k, eps),
        "K4L": lambda: lk.camera_grad_large(cam, proj,
                                            x["residuals"].volume, None, D,
                                            k, eps, head=x["head"]),
        "K5L": lambda: lk.camera_grad_large(cam, proj, None, None, D, k,
                                            eps, head=x["head_m"]),
        "K7L": lambda: lk.projector_grad_large(cam, proj, cost, g, D, k,
                                               eps)}


def route_outputs(route_cases=ROUTE_CASES, ap_route_cases=AP_ROUTE_CASES,
                  device: str = "cuda") -> Dict:
    """The large-k route's outputs (:func:`route_calls`) at
    ``route_cases`` (H, W, D, k) and K8L's volume at ``ap_route_cases``
    (H, W, k), from fixed inputs, on the CPU; a CPU ``device`` takes the
    steps' plain forms."""
    import torch

    from custereomatching_tpu_torch.ops import cuda_large_k as lk

    outs = {}
    for H, W, D, k in route_cases:
        calls = route_calls(route_inputs(H, W, D, k, device))
        for name in ROUTES:
            with torch.no_grad():
                outs[f"{name} {H}x{W} D={D} k={k}"] = _flat(
                    calls[name]()).cpu()
        del calls
    for H, W, k in ap_route_cases:
        gen = torch.Generator(device).manual_seed(2)
        acam, aproj = torch.rand((2, 1, H, W), device=device, generator=gen)
        with torch.no_grad():
            vol = lk.allpairs_volume_large(acam, aproj, k, ROUTE_EPS)
            # A tree from before K8b returns the volume without its
            # statistics.
            outs[f"K8L {H}x{W} k={k}"] = (
                vol[0] if isinstance(vol, tuple) else vol).cpu()
    return outs


def kernel_outputs(cases=CASES, device: str = "cuda",
                   route_cases=ROUTE_CASES,
                   ap_route_cases=AP_ROUTE_CASES) -> Dict:
    """K1's volume and K2's, K4's, K5's, K6's and K7's gradients at
    ``cases`` (H, W, D, k) from fixed inputs, K8's volume at
    (min(H, 40), W, k), K10b's sums (of a volume 4 bytes off a 16-byte
    boundary) and K10c's volume at ``kernel_model.HBM_EDGE_SHAPES``, and
    the large-k route's (:func:`route_outputs`), on the CPU tensors of
    ``device`` (a CPU device takes the wrappers' plain versions); a kernel
    whose wrapper refuses a case gives no output there."""
    import torch

    from custereomatching_tpu_torch.utils import kernel_model as km

    from custereomatching_tpu_torch.data import make_stereo_pair
    from custereomatching_tpu_torch.ops.cuda_allpairs import (
        cost_volume_allpairs_cuda,
    )
    from custereomatching_tpu_torch.ops.cuda_pipeline import (
        fused_pipeline_bwd_cuda,
        fused_pipeline_train_cuda,
    )
    from custereomatching_tpu_torch.ops.cuda_zncc import (
        camera_grad_banded_cuda,
        cost_volume_banded_cuda,
        projector_grad_banded_cuda,
    )
    from custereomatching_tpu_torch.ops.layout import plane_major_to_parity

    outs = {}
    for H, W, D, k in cases:
        cam, proj, _ = make_stereo_pair(H, W, d_min=4.0, d_max=min(D, 184.0),
                                        seed=7)
        cam = torch.from_numpy(cam[None]).to(device)
        proj = torch.from_numpy(proj[None]).to(device)
        gen = torch.Generator(device).manual_seed(0)
        gs = torch.randn((1, H, W), device=device, generator=gen) / (H * W)
        gc = torch.randn((1, H, W), device=device, generator=gen) / (H * W)
        g = torch.randn((1, D + 1, H, W), device=device,
                        generator=gen) / (H * W)
        # K7 reads the cost as data: a fixed volume of its range, not K1's.
        cost = torch.rand((1, D + 1, H, W), device=device,
                          generator=gen) * 2 - 1
        tag = f"{H}x{W} D={D} k={k}"

        def keep(name, fn, *args):
            try:
                outs[f"{name} {tag}"] = fn(*args).cpu()
            except (RuntimeError, ValueError) as e:
                print(f"kernel_outputs: {name} {tag} refused: {e}")

        res = fused_pipeline_train_cuda(cam, proj, D, k, 1e-8, 50.0, 0.6)[1]
        keep("K4", fused_pipeline_bwd_cuda, cam, proj, res, gs, gc, D, k,
             1e-8, 50.0)
        res_m = fused_pipeline_train_cuda(cam, proj, D, k, 1e-8, 50.0, 0.6,
                                          save_volume=False)[1]
        keep("K5", fused_pipeline_bwd_cuda, cam, proj, res_m, gs, gc, D, k,
             1e-8, 50.0)
        keep("K6", camera_grad_banded_cuda, cam, proj, None, g, D, k, 1e-8)
        volume = cost_volume_banded_cuda(cam, proj, D, k, 1e-8)
        outs[f"K1 {tag}"] = volume.cpu()
        outs[f"K9a {tag}"] = plane_major_to_parity(
            volume.permute(0, 3, 1, 2)).cpu()
        keep("K2", camera_grad_banded_cuda, cam, proj,
             volume.permute(0, 3, 1, 2), g, D, k, 1e-8)
        keep("K7", projector_grad_banded_cuda, cam, proj, cost, g, D, k,
             1e-8)
        # K8 on a band of the rows: KITTI's whole [H, W, W] is 2.3 GB.
        rows = min(H, 40)
        outs[f"K8 {rows}x{W} k={k}"] = cost_volume_allpairs_cuda(
            cam[:, :rows], proj[:, :rows], k, 1e-8).cpu()
        del res, res_m, volume
    for P, H, W in km.HBM_EDGE_SHAPES:
        gen = torch.Generator(device).manual_seed(P)
        flat = torch.rand(P * H * W + 1, device=device, generator=gen)
        outs[f"K10b {P}x{H}x{W}"] = km.hbm_read_probe(
            flat[1:].view(P, H, W)).cpu()
        outs[f"K10c {P}x{H}x{W}"] = km.hbm_write_probe(P, H, W, device).cpu()
    outs.update(route_outputs(route_cases, ap_route_cases, device))
    return outs


def save_grads(out: str) -> None:
    """:func:`kernel_outputs` on the card at ``CASES``, saved."""
    import torch

    torch.save(kernel_outputs(), out)


def _run(tree: Path, *args: str) -> str:
    env = dict(os.environ, PYTHONPATH=str(tree))
    out = subprocess.run([sys.executable, *args], env=env, check=True,
                         capture_output=True, text=True, cwd=ROOT)
    return out.stdout


def library_of(tree: Path) -> ctypes.CDLL:
    """The kernel library ``tree``'s own ``ops/_build.py`` builds from its
    sources, loaded with this tree's entry-point types."""
    from custereomatching_tpu_torch.ops import _build

    out = subprocess.run(
        [sys.executable, "-c", "from custereomatching_tpu_torch.ops import "
         "_build; print(_build.build())"],
        env=dict(os.environ, PYTHONPATH=str(tree)), cwd=tree, check=True,
        capture_output=True, text=True).stdout
    return _build.load(Path(out.split()[-1]))


def ab_times(other: Path, rounds: int) -> Dict[str, Dict[str, List[float]]]:
    """{kernel: {"this": ms..., "other": ms...}}: ``device_profile``'s
    kernel cases and large-k routes on this tree's library and on
    ``other``'s, ``rounds`` rounds, the two back to back for each kernel,
    ``other`` first in even rounds."""
    import torch

    from custereomatching_tpu_torch.ops import _build
    from custereomatching_tpu_torch.scripts import device_profile
    from custereomatching_tpu_torch.utils import benchmark

    libs = {"this": _build.kernels(), "other": library_of(other)}
    cases = device_profile.kernel_cases() + device_profile.large_k_cases()
    times = {name: {"this": [], "other": []} for name, _, _ in cases}
    ours = _build.kernels
    try:
        for r in range(rounds):
            order = ("other", "this") if r % 2 == 0 else ("this", "other")
            for name, fn, args in cases:
                for side in order:
                    _build.kernels = lambda lib=libs[side]: lib
                    with torch.no_grad():
                        times[name][side].append(1e3 * benchmark(
                            fn, *args, warmup=2, iters=10,
                            chain=3)["median_s"])
    finally:
        _build.kernels = ours
    return times


def main(argv: List[str]) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("names", nargs="*",
                        help=f"variants: {', '.join(VARIANTS)}")
    parser.add_argument("--against", action="append", default=[],
                        help="another checkout to compare bit for bit")
    parser.add_argument("--ab", help="another checkout to time against in "
                        "one process")
    parser.add_argument("--rounds", type=int, default=10,
                        help="rounds of --ab (default 10)")
    parser.add_argument("--save-grads", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    unknown = [n for n in args.names if n not in VARIANTS]
    if unknown:
        parser.error(f"unknown variants {unknown}; known: {list(VARIANTS)}")
    if args.save_grads:
        save_grads(args.save_grads)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device", file=sys.stderr)
        return 1
    if args.ab:
        other = (make_variant(args.ab, ROOT / "build" / "variants")
                 if args.ab in VARIANTS else Path(args.ab).resolve())
        for name, t in ab_times(other, args.rounds).items():
            mine, theirs = (sorted(t[side])[len(t[side]) // 2]
                            for side in ("this", "other"))
            wins = sum(a < b for a, b in zip(t["this"], t["other"]))
            print(f"ab: {name} {other.name} {theirs:.4f} ms, this "
                  f"{mine:.4f} ms, this / {other.name} {mine / theirs:.4f},"
                  f" this faster in {wins} of {args.rounds} rounds; this "
                  f"{' '.join(f'{v:.4f}' for v in t['this'])}; "
                  f"{other.name} {' '.join(f'{v:.4f}' for v in t['other'])}")
        return 0
    dest = ROOT / "build" / "variants"
    trees = {name: make_variant(name, dest) for name in args.names}
    me = Path(__file__).resolve()
    dest.mkdir(parents=True, exist_ok=True)
    _run(ROOT, str(me), "--save-grads", str(dest / "this.pt"))
    want = torch.load(dest / "this.pt")
    checks = [(name, tree) for name, tree in trees.items()
              if VARIANTS[name][0]] + [(a, Path(a).resolve())
                                       for a in args.against]
    for name, tree in checks:
        out = dest / f"{Path(name).name}.pt"
        _run(tree, str(me), "--save-grads", str(out))
        got = torch.load(out)
        same = {key: torch.equal(got[key], want[key]) for key in want
                if key in got}
        print(f"bit-equal to this tree: {name}: {same}; this tree's only: "
              f"{sorted(set(want) - set(got))}")
    profile = ROOT / PACKAGE / "scripts" / "device_profile.py"
    order = [("this", ROOT)] + list(trees.items())
    for name, tree in order + order[::-1]:
        line = [ln for ln in _run(tree, str(profile), "kernels").splitlines()
                if ln.startswith("kernels:")][0]
        print(f"{name}: {line.split(': ', 2)[-1]}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
