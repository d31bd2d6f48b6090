"""Copies of the port's kernels with one edit each, checked against this
tree bit for bit and timed against it on one CUDA card.

    python -m custereomatching_tpu_torch.scripts.kernel_variants \\
        [--against DIR]... NAME...

Each NAME of ``VARIANTS`` is a copy of the package under
``build/variants/NAME`` with one edit of ``csrc/camera_grad.cuh``: another
round size of the rounds kernel (K4, K6), the ring's entries split in half
rounds, or one phase of the rounds kernel cut (timing only: the values
are then wrong).  Each tree runs in its own process, with ``PYTHONPATH``
at it:

1. K4's and K6's gradients on fixed inputs (KITTI and three small shapes,
   k = 3, 31 and 47), compared bit for bit with this tree's: every
   variant that keeps the values, and every ``--against`` tree (another
   checkout, e.g. the parent commit's ``git archive``);
2. ``device_profile kernels`` (K1-K7 device ms at KITTI) for this tree and
   every variant in turns, then in the reverse order.

Needs a CUDA card and nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
from pathlib import Path
from typing import Dict, List, Tuple

ROOT = Path(__file__).resolve().parents[2]
PACKAGE = "custereomatching_tpu_torch"
SOURCE = "csrc/camera_grad.cuh"
CASES = ((375, 1242, 192, 15), (40, 130, 24, 31), (40, 130, 24, 47),
         (37, 200, 24, 3))

_ROUND = "  for (int planes = kGradPlanes; planes >= 1; planes /= 2) {\n"
_ASSERT = ('  static_assert(kGradPlanes == 8, "the planes a round instantiated '
           'below");\n')
_CASE_1 = ("    case 1:\n"
           "      e = launch_rounds<Source, kRecompute, 1>(")
_CENTRE = ("    if (valid) {\n"
           "      const auto e = src.entry(maps, halo, centre);")
_RING = "    for (int q = threadIdx.x; q < ring; q += kThreads) {"


def _start(planes: int, *extra: int) -> List[Tuple[str, str]]:
    """Rounds of ``planes`` (halving from there), instantiating ``extra``
    besides the source's 8, 4, 2, 1."""
    cases = "".join(
        f"    case {p}:\n"
        f"      e = launch_rounds<Source, kRecompute, {p}>(\n"
        f"          src, camera, projector, cam_s, cam_e2, proj_s, proj_e2, "
        f"a1, bm,\n"
        f"          grmu, B, H, W, D, k, round.chunk, eps, stream);\n"
        f"      break;\n" for p in extra)
    edits = [(_ROUND, _ROUND.replace("kGradPlanes", str(planes)))]
    if extra:
        edits += [(_ASSERT, ""), (_CASE_1, cases + _CASE_1)]
    return edits


_RING_LOOP = """    // gr_d at the ring's entries.
    for (int q = threadIdx.x; q < ring; q += kThreads) {
      const int i = ring_entry(q, p, hc);
      const int rr = i / hc, cc = i - rr * hc;
      const int y = h0 - p + rr, xx = w0 - p + cc;
      float* ey = ybuf + rr * x.ys + cc;
      if (!(y >= 0 && y < H && xx >= 0 && xx < W)) {
#pragma unroll
        for (int j = 0; j < P; ++j) ey[j * x.ysz] = 0.f;
        continue;
      }
      const auto e = src.entry(maps, halo, i);
      const float ex2 = ex2_t[i];
      const size_t px = static_cast<size_t>(y) * W + xx;
      const size_t srow = (static_cast<size_t>(b) * H + y) * stats_w + D + xx;
      float ey2[P], v[P];
#pragma unroll
      for (int j = 0; j < P; ++j) {
        const int d = min(d0 + j, D);
        ey2[j] = __ldg(proj_e2 + srow - d);
        v[j] = __ldg(vol_b + d * plane + px);
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
      const int i = ring_entry(q, p, hc);
      const int rr = i / hc, cc = i - rr * hc;
      const int y = h0 - p + rr, xx = w0 - p + cc;
      float* ey = ybuf + rr * x.ys + cc;
      if (!(y >= 0 && y < H && xx >= 0 && xx < W)) {
#pragma unroll
        for (int jj = 0; jj < kHalf; ++jj)
          if (j0 + jj < P) ey[(j0 + jj) * x.ysz] = 0.f;
        continue;
      }
      const auto e = src.entry(maps, halo, i);
      const float ex2 = ex2_t[i];
      const size_t px = static_cast<size_t>(y) * W + xx;
      const size_t srow = (static_cast<size_t>(b) * H + y) * stats_w + D + xx;
      float ey2[kHalf], v[kHalf];
#pragma unroll
      for (int jj = 0; jj < kHalf; ++jj) {
        const int d = min(d0 + j0 + jj, D);
        ey2[jj] = __ldg(proj_e2 + srow - d);
        v[jj] = __ldg(vol_b + d * plane + px);
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

# name -> (whether the values stay the source's, edits (old, new) of SOURCE)
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
        v[j] = __ldg(vol_b + d * plane + (o - frame));""",
         """        ey2[j] = ex2 + 0.25f * d;
        sy[j] = ex2 * d;
        v[j] = 0.001f * d - ex2;"""),
        ("""        ey2[j] = __ldg(proj_e2 + srow - d);
        v[j] = __ldg(vol_b + d * plane + px);""",
         """        ey2[j] = ex2 + 0.25f * d;
        v[j] = 0.001f * d - ex2;""")]),
    "cut_passes": (False, [
        ("    grad_rows(xbuf, ybuf, gs, k, np);\n", ""),
        ("    grad_column_sums(ybuf, xbuf, gs, k, np);\n", "")]),
    "cut_a1": (False, [
        ("    if (valid) {\n      const float* box = ybuf + r * x.bs + c;",
         "    if (valid && d0 < 0) {\n"
         "      const float* box = ybuf + r * x.bs + c;")]),
}


def edit_source(text: str, name: str) -> str:
    """``text`` (camera_grad.cuh) with variant ``name``'s edits; each edit's
    text must occur once."""
    for old, new in VARIANTS[name][1]:
        if text.count(old) != 1:
            raise ValueError(f"variant {name}: the edited text occurs "
                             f"{text.count(old)} times in {SOURCE}")
        text = text.replace(old, new)
    return text


def make_variant(name: str, dest: Path) -> Path:
    """A copy of this tree's package under ``dest / name`` with ``name``'s
    edit; returns the directory to put on ``PYTHONPATH``."""
    tree = dest / name
    shutil.rmtree(tree, ignore_errors=True)
    shutil.copytree(ROOT / PACKAGE, tree / PACKAGE,
                    ignore=shutil.ignore_patterns("__pycache__"))
    path = tree / PACKAGE / SOURCE
    path.write_text(edit_source(path.read_text(), name))
    return tree


def save_grads(out: str) -> None:
    """K4's and K6's gradients at ``CASES`` from fixed inputs, saved."""
    import torch

    from custereomatching_tpu_torch.data import make_stereo_pair
    from custereomatching_tpu_torch.ops.cuda_pipeline import (
        fused_pipeline_bwd_cuda,
        fused_pipeline_train_cuda,
    )
    from custereomatching_tpu_torch.ops.cuda_zncc import (
        camera_grad_banded_cuda,
    )

    grads = {}
    for H, W, D, k in CASES:
        cam, proj, _ = make_stereo_pair(H, W, d_min=4.0, d_max=min(D, 184.0),
                                        seed=7)
        cam = torch.from_numpy(cam[None]).cuda()
        proj = torch.from_numpy(proj[None]).cuda()
        gen = torch.Generator("cuda").manual_seed(0)
        gs = torch.randn((1, H, W), device="cuda", generator=gen) / (H * W)
        gc = torch.randn((1, H, W), device="cuda", generator=gen) / (H * W)
        g = torch.randn((1, D + 1, H, W), device="cuda",
                        generator=gen) / (H * W)
        res = fused_pipeline_train_cuda(cam, proj, D, k, 1e-8, 50.0, 0.6)[1]
        grads[f"K4 {H}x{W} D={D} k={k}"] = fused_pipeline_bwd_cuda(
            cam, proj, res, gs, gc, D, k, 1e-8, 50.0).cpu()
        grads[f"K6 {H}x{W} D={D} k={k}"] = camera_grad_banded_cuda(
            cam, proj, None, g, D, k, 1e-8).cpu()
    torch.save(grads, out)


def _run(tree: Path, *args: str) -> str:
    env = dict(os.environ, PYTHONPATH=str(tree))
    out = subprocess.run([sys.executable, *args], env=env, check=True,
                         capture_output=True, text=True, cwd=ROOT)
    return out.stdout


def main(argv: List[str]) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("names", nargs="*",
                        help=f"variants: {', '.join(VARIANTS)}")
    parser.add_argument("--against", action="append", default=[],
                        help="another checkout to compare bit for bit")
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
        same = {key: torch.equal(got[key], want[key]) for key in want}
        print(f"bit-equal to this tree: {name}: {same}")
    profile = ROOT / PACKAGE / "scripts" / "device_profile.py"
    order = [("this", ROOT)] + list(trees.items())
    for name, tree in order + order[::-1]:
        line = [ln for ln in _run(tree, str(profile), "kernels").splitlines()
                if ln.startswith("kernels:")][0]
        print(f"{name}: {line.split(': ', 2)[-1]}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
