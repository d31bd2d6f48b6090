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
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import List

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-Xptxas=-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# C entry point -> argument types; every entry returns cudaGetLastError().
SIGNATURES = {
    # camera, projector, cam_s, cam_e2, proj_s, proj_e2, out,
    # B, H, W, D, k, eps, stream
    "custereo_banded_volume": [_P] * 7 + [_I] * 5 + [_F, _P],
    # camera, projector, cam_s, cam_e2, proj_s, proj_e2,
    # disparity, soft, mask, conf, B, H, W, D, k, eps, beta, threshold,
    # unnormalized, stream
    "custereo_fused_pipeline": [_P] * 10 + [_I] * 5 + [_F] * 3 + [_I, _P],
    # ... as above, with volume, am, s, t after conf
    "custereo_fused_pipeline_train": [_P] * 14 + [_I] * 5 + [_F] * 3
    + [_I, _P],
    # ... as above, without the volume
    "custereo_fused_pipeline_train_maps": [_P] * 13 + [_I] * 5 + [_F] * 3
    + [_I, _P],
    # camera, projector, cam_s, cam_e2, proj_s, proj_e2, cost, cotangent,
    # a1, bm, grmu, grad, B, H, W, D, k, eps, stream
    "custereo_camera_grad": [_P] * 12 + [_I] * 5 + [_F, _P],
    # ... as above, without the cost
    "custereo_camera_grad_recompute": [_P] * 11 + [_I] * 5 + [_F, _P],
    # camera, projector, cam_s, cam_e2, proj_s, proj_e2, cost, am, mask,
    # conf, s, t, gsoft, gconf, a1, bm, grmu, grad, B, H, W, D, k, eps,
    # beta, unnormalized, stream
    "custereo_fused_pipeline_bwd": [_P] * 18 + [_I] * 5 + [_F] * 2
    + [_I, _P],
    # ... as above, without the cost
    "custereo_fused_pipeline_bwd_recompute": [_P] * 17 + [_I] * 5
    + [_F] * 2 + [_I, _P],
    # camera, projector, cam_s, cam_e2, proj_s, proj_e2, cost, cotangent,
    # a1p, z2, z3, grad, B, H, W, D, k, eps, stream
    "custereo_projector_grad": [_P] * 12 + [_I] * 5 + [_F, _P],
    # camera, projector, cam_s, cam_e2, proj_s, proj_e2, out, B, H, W, k,
    # eps, stream
    "custereo_allpairs_volume": [_P] * 7 + [_I] * 4 + [_F, _P],
    # in, out, B, planes, pixels, stream
    "custereo_plane_major_to_parity": [_P] * 2 + [_I] * 3 + [_P],
    "custereo_parity_to_plane_major": [_P] * 2 + [_I] * 3 + [_P],
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


@functools.cache
def kernels() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.custereo_error_string.argtypes = [ctypes.c_int]
    lib.custereo_error_string.restype = ctypes.c_char_p
    return lib


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def check(code: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        msg = kernels().custereo_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
