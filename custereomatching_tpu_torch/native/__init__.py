"""Native C++ host runtime: PNG decode, .npy parsing, preprocessing and a
prefetching frame loader.

The port's copy of ``custereomatching_tpu/native``: ``custereo_io.cpp`` is
the same source byte for byte, with the same C ABI
(``cst_abi_version() == 4``), bound with ctypes.  It runs on the host, so
the port needs it as the JAX package does: it decodes camera frames while
the card computes.

The library links libpng and zlib.  ``g++`` builds it on first use into
``build/native/`` at the repository root, named by a hash of the source and
flags, written under a temporary name and moved into place, so two
processes that build at once never load a partial library and the package
tree stays as it is checked in.  Where it cannot be built (no ``g++``, or
no libpng headers), :func:`native_available` is False and every entry point
returns ``None``; ``data.io`` then decodes with OpenCV, PIL or its own
numpy decoder.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import sys
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parent / "custereo_io.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")
LIBS = ("-lpng", "-lz")
ABI_VERSION = 4


def library_path() -> Path:
    """Where the library for this source and these flags is built."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS + LIBS).encode())
    return BUILD_DIR / f"libcustereo_io.{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> bool:
    """Compile the library unless it exists.  Returns True on success;
    with ``verbose`` the compiler's output of a failed build goes to
    stderr."""
    lib = library_path()
    if lib.is_file():
        return True
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
    cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE), *LIBS]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        if verbose:
            print(f"native build failed: {e}", file=sys.stderr)
        tmp.unlink(missing_ok=True)
        return False
    if res.returncode != 0:
        if verbose:
            print(res.stderr, file=sys.stderr)
        tmp.unlink(missing_ok=True)
        return False
    os.replace(tmp, lib)
    return True


@functools.cache
def _load() -> Optional[ctypes.CDLL]:
    if not build():
        return None
    try:
        lib = ctypes.CDLL(str(library_path()))
    except OSError:
        return None

    lib.cst_decode_png_gray.restype = ctypes.c_int
    lib.cst_decode_png_gray.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32)]
    lib.cst_decode_png_u16.restype = ctypes.c_int
    lib.cst_decode_png_u16.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32)]
    lib.cst_load_npy_f32.restype = ctypes.c_int
    lib.cst_load_npy_f32.argtypes = [
        ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32)]
    lib.cst_u8_to_f32_gray.restype = None
    lib.cst_u8_to_f32_gray.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_void_p]
    lib.cst_pad_image_f32.restype = None
    lib.cst_pad_image_f32.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64]
    lib.cst_loader_open.restype = ctypes.c_void_p
    lib.cst_loader_open.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32]
    lib.cst_loader_next.restype = ctypes.c_int
    lib.cst_loader_next.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32)]
    lib.cst_loader_skip.restype = ctypes.c_int
    lib.cst_loader_skip.argtypes = [ctypes.c_void_p]
    lib.cst_loader_close.restype = None
    lib.cst_loader_close.argtypes = [ctypes.c_void_p]
    lib.cst_abi_version.restype = ctypes.c_int
    if lib.cst_abi_version() != ABI_VERSION:
        return None
    return lib


def native_available() -> bool:
    """True if the native library is loaded (building it if needed)."""
    return _load() is not None


def decode_png_gray(path: str, channel: int = 0) -> Optional[np.ndarray]:
    """Decode a PNG to float32 [H, W] in [0, 1] (16-bit samples keep their
    high byte, as libpng's ``png_set_strip_16``); None if unavailable."""
    lib = _load()
    if lib is None:
        return None
    h = ctypes.c_int32()
    w = ctypes.c_int32()
    rc = lib.cst_decode_png_gray(os.fsencode(path), channel, None, 0,
                                 ctypes.byref(h), ctypes.byref(w))
    if rc != 0:
        return None
    out = np.empty((h.value, w.value), np.float32)
    rc = lib.cst_decode_png_gray(
        os.fsencode(path), channel, out.ctypes.data_as(ctypes.c_void_p),
        out.size, ctypes.byref(h), ctypes.byref(w))
    return out if rc == 0 else None


def decode_png_u16(path: str, channel: int = 0) -> Optional[np.ndarray]:
    """Decode a PNG's raw samples to uint16 [H, W] (no normalization) —
    the KITTI ground-truth disparity convention; None if unavailable."""
    lib = _load()
    if lib is None:
        return None
    h = ctypes.c_int32()
    w = ctypes.c_int32()
    rc = lib.cst_decode_png_u16(os.fsencode(path), channel, None, 0,
                                ctypes.byref(h), ctypes.byref(w))
    if rc != 0:
        return None
    out = np.empty((h.value, w.value), np.uint16)
    rc = lib.cst_decode_png_u16(
        os.fsencode(path), channel, out.ctypes.data_as(ctypes.c_void_p),
        out.size, ctypes.byref(h), ctypes.byref(w))
    return out if rc == 0 else None


def load_npy_f32(path: str) -> Optional[np.ndarray]:
    """Load a C-contiguous float32 .npy; None if unavailable/unsupported."""
    lib = _load()
    if lib is None:
        return None
    shape = (ctypes.c_int64 * 4)()
    ndim = ctypes.c_int32()
    rc = lib.cst_load_npy_f32(os.fsencode(path), None, 0, shape,
                              ctypes.byref(ndim))
    if rc != 0:
        return None
    dims = tuple(shape[i] for i in range(ndim.value))
    out = np.empty(dims, np.float32)
    rc = lib.cst_load_npy_f32(
        os.fsencode(path), out.ctypes.data_as(ctypes.c_void_p), out.size,
        shape, ctypes.byref(ndim))
    return out if rc == 0 else None


def u8_to_f32_gray(img: np.ndarray, channel: int = 0) -> Optional[np.ndarray]:
    """Normalize a uint8 [H, W] or [H, W, C] image to float32 [H, W]."""
    lib = _load()
    if lib is None:
        return None
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim == 2:
        h, w, c = img.shape[0], img.shape[1], 1
    elif img.ndim == 3:
        h, w, c = img.shape
    else:
        raise ValueError(f"expected [H, W] or [H, W, C], got {img.shape}")
    out = np.empty((h, w), np.float32)
    lib.cst_u8_to_f32_gray(img.ctypes.data_as(ctypes.c_void_p), h, w, c,
                           channel, out.ctypes.data_as(ctypes.c_void_p))
    return out


def pad_image_f32(img: np.ndarray, dst_h: int, dst_w: int, off_r: int,
                  off_c: int) -> Optional[np.ndarray]:
    """Zero-pad ``img`` into a [dst_h, dst_w] buffer at (off_r, off_c)."""
    lib = _load()
    if lib is None:
        return None
    img = np.ascontiguousarray(img, np.float32)
    if img.ndim != 2:
        raise ValueError(f"expected [H, W], got {img.shape}")
    h, w = img.shape
    if (min(off_r, off_c) < 0 or off_r + h > dst_h or off_c + w > dst_w):
        raise ValueError(f"[{h}, {w}] at ({off_r}, {off_c}) does not fit "
                         f"[{dst_h}, {dst_w}]")
    out = np.empty((dst_h, dst_w), np.float32)
    lib.cst_pad_image_f32(img.ctypes.data_as(ctypes.c_void_p), h, w,
                          out.ctypes.data_as(ctypes.c_void_p),
                          dst_h, dst_w, off_r, off_c)
    return out


class FrameLoader:
    """Prefetching PNG frame loader backed by a native decode pool.

    Decodes ahead on ``threads`` worker threads (``<= 0``: one a core, at
    most 8) into a bounded window of ``capacity`` frames while the card
    computes, and delivers the frames in path order.  A frame that does
    not decode raises ``IOError`` at its place and is skipped, so a caller
    that catches it goes on with the next.

    Example::

        with FrameLoader(paths) as frames:
            for frame in frames:          # float32 [H, W] in [0, 1]
                maps = engine.infer(frame, projector)
    """

    def __init__(self, paths, channel: int = 0, capacity: int = 16,
                 threads: int = 0):
        lib = _load()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self._paths = [os.fspath(p) for p in paths]
        # Kept alive for the loader's life: the C side copies the strings
        # at open, but the array must outlive that call.
        self._arr = (ctypes.c_char_p * len(self._paths))(
            *[os.fsencode(p) for p in self._paths])
        self._handle = lib.cst_loader_open(self._arr, len(self._paths),
                                           channel, capacity, threads)
        self._consumed = 0

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        if self._handle is None:
            raise StopIteration
        h = ctypes.c_int32()
        w = ctypes.c_int32()
        rc = self._lib.cst_loader_next(self._handle, None, 0,
                                       ctypes.byref(h), ctypes.byref(w))
        if rc == 0:
            raise StopIteration
        if rc < 0:
            # Skip the bad frame so iteration goes on past it.
            self._lib.cst_loader_skip(self._handle)
            path = self._paths[min(self._consumed, len(self._paths) - 1)]
            self._consumed += 1
            raise IOError(f"native decode failed (rc={rc}) for {path}")
        out = np.empty((h.value, w.value), np.float32)
        rc = self._lib.cst_loader_next(
            self._handle, out.ctypes.data_as(ctypes.c_void_p), out.size,
            ctypes.byref(h), ctypes.byref(w))
        if rc != 1:
            # The front frame was not consumed by the read: skip it, or a
            # caller that keeps iterating would read it forever.
            self._lib.cst_loader_skip(self._handle)
            self._consumed += 1
            raise IOError(
                f"native loader read failed (rc={rc}); frame skipped")
        self._consumed += 1
        return out

    def close(self) -> None:
        if self._handle is not None:
            self._lib.cst_loader_close(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        # Stops the decode threads of a loader that was never closed.
        if getattr(self, "_handle", None) is not None:
            self.close()


__all__ = ["FrameLoader", "build", "decode_png_gray", "decode_png_u16",
           "library_path", "load_npy_f32", "native_available",
           "pad_image_f32", "u8_to_f32_gray"]
