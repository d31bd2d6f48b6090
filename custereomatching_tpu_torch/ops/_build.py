"""Build and load the port's hand-written CUDA kernels.

The sources in ``custereomatching_tpu_torch/csrc/`` have a plain C
interface.  ``nvcc`` compiles them for ``sm_90a`` into one shared library
under ``build/kernels/`` at the repository root, named by a hash of the
sources and flags (so an edit rebuilds it), and ``ctypes`` loads it.
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

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

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

    The compiler's report (``-Xptxas=-v``: registers, shared memory and
    spills of each kernel) is kept beside the library as ``.log``."""
    lib = library_path()
    if lib.is_file():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(s) for s in sources() if s.suffix == ".cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed with code {proc.returncode}:\n{' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}")
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    # Atomic publish: a concurrent build never loads a partial library.
    os.replace(tmp, lib)
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


def check(code: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        msg = kernels().custereo_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
