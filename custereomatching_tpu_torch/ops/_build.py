"""Build and load the port's hand-written CUDA kernels.

The sources in ``custereomatching_tpu_torch/csrc/`` have a plain C
interface.  ``nvcc`` compiles each ``.cu`` for ``sm_90a`` in its own
process, all started together, and links the objects into one shared
library under ``build/kernels/`` at the repository root, named by a hash
of the sources and flags (so an edit rebuilds it); ``ctypes`` loads it.
Nothing includes PyTorch's headers, which keeps a build to seconds.

Every pointer and the stream go to the library as ``ctypes.c_void_p``:
without ``argtypes`` ctypes would pass 64-bit pointers as 32-bit ints.
A failed build raises with nvcc's output; nothing falls back.

Every call of an entry point that launches a kernel goes through
:func:`launch`, which names the launch in the profiler's trace and counts
it in ``profiling.COUNTS``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import List, Optional

import torch

from custereomatching_tpu_torch.utils import profiling

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-Xptxas=-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong

# C entry point -> argument types; every entry returns cudaGetLastError().
SIGNATURES = {
    # camera, projector, cam_s, cam_e2, proj_s, proj_e2, out,
    # B, H, W, D, k, eps, stream, tile_rows, planes
    "custereo_banded_volume": [_P] * 7 + [_I] * 5 + [_F, _P, _I, _I],
    # camera, projector, cam_s, cam_e2, proj_s, proj_e2,
    # disparity, soft, mask, conf, B, H, W, D, k, eps, beta, threshold,
    # unnormalized, stream, tile_rows, planes
    "custereo_fused_pipeline": [_P] * 10 + [_I] * 5 + [_F] * 3
    + [_I, _P, _I, _I],
    # ... as above, with volume, am, s, t after conf
    "custereo_fused_pipeline_train": [_P] * 14 + [_I] * 5 + [_F] * 3
    + [_I, _P, _I, _I],
    # ... as above, without the volume
    "custereo_fused_pipeline_train_maps": [_P] * 13 + [_I] * 5 + [_F] * 3
    + [_I, _P, _I, _I],
    # The launchers' rounds, queried: k, D, tile_rows, planes, out[2] (K1,
    # K3); k, D, tile_rows, out[3] (K4)
    "custereo_fused_rounds": [_I] * 4 + [_P],
    "custereo_head_rounds": [_I] * 3 + [_P],
    # camera, projector, cam_s, cam_e2, proj_s, proj_e2, cost, cotangent,
    # a1, bm, grmu, grad, B, H, W, D, k, eps, stream
    "custereo_camera_grad": [_P] * 12 + [_I] * 5 + [_F, _P],
    # ... as above, without the cost, and after the stream the slab of
    # K1's costs its chunked route fills (null where it does not run)
    "custereo_camera_grad_recompute": [_P] * 11 + [_I] * 5 + [_F, _P, _P],
    # camera, projector, cam_s, cam_e2, proj_s, proj_e2, cost, am, mask,
    # conf, s, t, gsoft, gconf, a1, bm, grmu, grad, B, H, W, D, k, eps,
    # beta, unnormalized, stream, tile_rows
    "custereo_fused_pipeline_bwd": [_P] * 18 + [_I] * 5 + [_F] * 2
    + [_I, _P, _I],
    # ... as above, without the cost, and after the stream the slab of
    # K1's costs its chunked route fills (null where it does not run)
    "custereo_fused_pipeline_bwd_recompute": [_P] * 17 + [_I] * 5
    + [_F] * 2 + [_I, _P, _P],
    # camera, projector, cam_s, cam_e2, proj_s, proj_e2, cost, cotangent,
    # a1p, z2, z3, grad, B, H, W, D, k, eps, stream
    "custereo_projector_grad": [_P] * 12 + [_I] * 5 + [_F, _P],
    # camera, projector, cam_s, cam_e2, proj_s, proj_e2, out, B, H, W, k,
    # eps, stream
    "custereo_allpairs_volume": [_P] * 7 + [_I] * 4 + [_F, _P],
    # cotangent, cost, camera, projector, cam_s, cam_e2, proj_s, proj_e2,
    # e, a1, bm, grmu, grad (or null), B, H, W, k, j_lo, taps, eps, stream
    "custereo_allpairs_grad": [_P] * 13 + [_I] * 6 + [_F, _P],
    # cost, disparity, soft, mask, conf, resid, pixels, frame, W, L, beta,
    # threshold, all_pairs, plane_major, stream
    "custereo_volume_head": [_P] * 6 + [_L] * 2 + [_I] * 2 + [_F] * 2
    + [_I, _I, _P],
    # cost, conf, resid, g_soft (or null), g_conf (or null), g_cost,
    # pixels, frame, L, beta, threshold, all_pairs, plane_major, stream
    "custereo_volume_head_grad": [_P] * 6 + [_L] * 2 + [_I] + [_F] * 2
    + [_I, _I, _P],
    # in, out, B, planes, pixels, stream
    "custereo_plane_major_to_parity": [_P] * 2 + [_I] * 3 + [_P],
    "custereo_parity_to_plane_major": [_P] * 2 + [_I] * 3 + [_P],
    # mode, out, blocks, iters, a0, zero, fill, stream
    "custereo_rate_probe": [_I, _P, _I, _I] + [_F] * 3 + [_P],
    # vol, out, P, H, W, stream
    "custereo_hbm_read_probe": [_P] * 2 + [_I] * 3 + [_P],
    # vol, P, H, W, stream
    "custereo_hbm_write_probe": [_P] + [_I] * 3 + [_P],
    # The large-k route (large_k.cu), one launch an entry.
    # x, out, N, H, W, k, axis, stream
    "custereo_lk_box_axis": [_P, _P, _L] + [_I] * 4 + [_P],
    # img, out, N, H, W, left, stream
    "custereo_lk_pad_square": [_P, _P, _L] + [_I] * 3 + [_P],
    # s, s2, n, k2, stream
    "custereo_lk_moments_finish": [_P, _P, _L, _F, _P],
    # cam, proj, out, B, H, W, d_lo, P, stream
    "custereo_lk_band_products": [_P] * 3 + [_I] * 5 + [_P],
    # sxy, cam_s, cam_e2, proj_s, proj_e2, out, out_planes, out_lo, B, H,
    # W, D, d_lo, P, k2, eps, stream
    "custereo_lk_band_cost": [_P] * 6 + [_I] * 8 + [_F] * 2 + [_P],
    # cost, cost_planes, cost_lo, state, disparity, soft, mask, conf, am,
    # s, t, B, H, W, d_lo, P, beta, threshold, unnormalized, first, last,
    # stream
    "custereo_lk_online_head": [_P, _I, _I] + [_P] * 8 + [_I] * 5
    + [_F] * 2 + [_I] * 3 + [_P],
    # cost, cost_planes, cost_lo, g_vol, am, mask, conf, s, t, gsoft,
    # gconf, cam_e2, proj_s, proj_e2, gr, bm, grmu, B, H, W, D, d_lo, P,
    # k2, eps, beta, unnormalized, first, stream
    "custereo_lk_grad_fields": [_P, _I, _I] + [_P] * 14 + [_I] * 6
    + [_F] * 3 + [_I] * 2 + [_P],
    # box, proj, a1, B, H, W, d_lo, P, first, stream
    "custereo_lk_grad_a1": [_P] * 3 + [_I] * 6 + [_P],
    # bm, grmu, cam_s, stack, n, k2, stream
    "custereo_lk_grad_stack": [_P] * 4 + [_L, _F, _P],
    # a1, boxes, cam, grad, n, stream
    "custereo_lk_grad_combine": [_P] * 4 + [_L, _P],
    # cost, g, cam_s, cam_e2, proj_e2e, gr, z2, z3, B, H, W, D, p, d_lo,
    # P, k2, eps, first, stream
    "custereo_lk_proj_fields": [_P] * 8 + [_I] * 7 + [_F] * 2 + [_I, _P],
    # box, cam, a1p, B, H, W, p, d_lo, P, first, stream
    "custereo_lk_proj_a1": [_P] * 3 + [_I] * 7 + [_P],
    # z2, z3, proj_se, stack, n, k2, stream
    "custereo_lk_proj_stack": [_P] * 4 + [_L, _F, _P],
    # a1p, boxes, proj, grad, B, H, W, p, stream
    "custereo_lk_proj_combine": [_P] * 4 + [_I] * 4 + [_P],
    # cam, proj, out, B, H, W, k, stream
    "custereo_lk_row_products": [_P] * 3 + [_I] * 4 + [_P],
    # a, cam_s, cam_e2, proj_s, proj_e2, out, B, H, W, k2, eps, stream
    "custereo_lk_allpairs_cost": [_P] * 6 + [_I] * 3 + [_F] * 2 + [_P],
}


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    """Where the library for the current sources and flags is built."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libcustereo_{digest.hexdigest()[:16]}.so"


def nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``/usr/local/cuda``'s,
    or the first on ``PATH``."""
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                           "(set CUDA_HOME or put nvcc on PATH)")
    return found


def build() -> Path:
    """Compile the kernels unless the library for these sources exists.

    Each ``.cu`` compiles in its own ``nvcc`` process, all at once; the
    objects are then linked.  The compilers' report (``-Xptxas=-v``:
    registers, shared memory and spills of each kernel) is kept beside the
    library as ``.log``."""
    lib = library_path()
    if lib.is_file():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{lib.stem}.{os.getpid()}"
    jobs = []
    for src in sources():
        if src.suffix != ".cu":
            continue
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((cmd, obj, proc))
    tmp = lib.with_name(f"{tag}.tmp.so")
    try:
        log = []
        for cmd, _, proc in jobs:
            log.append(proc.communicate()[0])
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed with code {proc.returncode}:\n"
                    f"{' '.join(cmd)}\n{log[-1]}")
        cmd = [nvcc(), *ARCH_FLAGS, "-shared", "-o", str(tmp),
               *(str(obj) for _, obj, _ in jobs)]
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              check=False)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed with code {proc.returncode}:\n"
                f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        lib.with_suffix(".log").write_text("".join(log))
        # Atomic publish: a concurrent build never loads a partial library.
        os.replace(tmp, lib)
    finally:
        for _, obj, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            obj.unlink(missing_ok=True)
        tmp.unlink(missing_ok=True)
    return lib


def load(path: Path) -> ctypes.CDLL:
    """A built kernel library, its entry points typed.  An entry point the
    library lacks (one built from another checkout's sources, as
    ``scripts/kernel_variants.py --ab`` loads) stays missing: calling it
    raises ``AttributeError``."""
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name, None)
        if fn is None:
            continue
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.custereo_error_string.argtypes = [ctypes.c_int]
    lib.custereo_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def kernels() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    return load(build())


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(device: torch.device) -> ctypes.c_void_p:
    """The current stream of ``device`` (the current device where it has
    no index), as the C entry points take it: torch's raw-stream call, a
    microsecond where a ``Stream`` object takes several."""
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    return ctypes.c_void_p(torch._C._cuda_getCurrentRawStream(index))


def launch(kernel: str, entry: str, *args,
           what: Optional[str] = None) -> None:
    """Call the C entry point ``entry`` with ``args`` inside the span
    ``custereo.kernel.<kernel>`` (``kernel``: K1 ... K10c and K8b, or
    ``large_k.<step>`` for a step of the large-k route), and raise as
    :func:`check` does, the error named by ``what`` (default ``<kernel>
    launch``); a launch that passes adds 1 to ``profiling.COUNTS[kernel]``.
    The ctypes call leaves no event of its own in a profile, so this span
    is what names the launch, and the host time before it, there."""
    with profiling.span(f"custereo.kernel.{kernel}"):
        code = getattr(kernels(), entry)(*args)
    check(code, what or f"{kernel} launch")
    profiling.COUNTS[kernel] += 1


def check(code: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        msg = kernels().custereo_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
