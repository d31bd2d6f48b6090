"""Image / array IO for stereo pairs (numpy only).

The port's copy of ``custereomatching_tpu/data/io.py``.  Images load as
``[H, W]`` float32 in [0, 1], channel 0 of colour inputs, the reference's
convention (``/ 255``).  PNG decoding tries the native libpng decoder
(:mod:`custereomatching_tpu_torch.native`), then OpenCV, then PIL, then
:func:`decode_png`, a decoder written in numpy and Python's ``zlib`` for
machines that have none of those (libpng's headers are missing on some,
so the native library cannot be built there).  ``decode_png`` gives the
native decoder's values bit for bit: 8-bit samples ``* (1/255)``, 16-bit
samples by their high byte, as libpng's ``png_set_strip_16``.
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional, Tuple

import numpy as np

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# Samples a pixel, by PNG colour type: gray, RGB, gray + alpha, RGBA.
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
# (x0, y0, dx, dy) of the seven Adam7 passes.
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
# The native decoder's scale, ``1.0f / 255.0f`` (custereo_io.cpp).
_INV255 = np.float32(1.0) / np.float32(255.0)


def _unfilter(data: memoryview, height: int, row_bytes: int,
              bpp: int) -> np.ndarray:
    """Undo the per-row PNG filters of one (sub)image: ``[height,
    row_bytes]`` uint8.  Sub and Up are vectorised; Average and Paeth
    depend on the byte to their left, so they run byte by byte."""
    out = np.zeros((height, row_bytes), np.uint8)
    prev = np.zeros(row_bytes, np.uint8)
    stride = row_bytes + 1
    if len(data) < height * stride:
        raise ValueError("PNG image data is truncated")
    for y in range(height):
        ftype = data[y * stride]
        line = np.frombuffer(data[y * stride + 1:(y + 1) * stride], np.uint8)
        if ftype == 0:
            row = line.copy()
        elif ftype == 1:
            # x[i] = line[i] + x[i - bpp]: a running sum of each byte lane.
            sums = np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint32)
            row = (sums & 0xFF).astype(np.uint8).reshape(-1)
        elif ftype == 2:
            row = line + prev
        elif ftype in (3, 4):
            cur = bytearray(line.tobytes())
            up = prev.tobytes()
            for i in range(row_bytes):
                a = cur[i - bpp] if i >= bpp else 0
                b = up[i]
                if ftype == 3:
                    cur[i] = (cur[i] + ((a + b) >> 1)) & 0xFF
                    continue
                c = up[i - bpp] if i >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[i] = (cur[i] + pred) & 0xFF
            row = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"unknown PNG filter type {ftype}")
        out[y] = row
        prev = out[y]
    return out


def _samples(rows: np.ndarray, width: int, channels: int,
             depth: int) -> np.ndarray:
    """Unfiltered rows to ``[h, width, channels]`` samples (big-endian
    16-bit samples to native uint16)."""
    if depth == 16:
        rows = rows.reshape(rows.shape[0], -1).view(">u2").astype(np.uint16)
    return rows.reshape(rows.shape[0], width, channels)


def decode_png(path: str) -> np.ndarray:
    """Decode a PNG with numpy and ``zlib``: ``[H, W, C]`` raw samples,
    uint8 for 8-bit images and uint16 for 16-bit ones.

    Covers 8- and 16-bit gray, gray + alpha, RGB and RGBA, interlaced
    (Adam7) or not: every kind of PNG this repository reads and writes.
    Palette images and bit depths below 8 raise ``ValueError``.
    """
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(blob):
        (length,) = struct.unpack(">I", blob[pos:pos + 4])
        tag = blob[pos + 4:pos + 8]
        body = blob[pos + 8:pos + 8 + length]
        if len(body) != length:
            raise ValueError(f"{path}: truncated {tag!r} chunk")
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
        pos += 12 + length
    if header is None or not idat:
        raise ValueError(f"{path}: no IHDR or IDAT chunk")
    width, height, depth, color, _, _, interlace = header
    if color not in _CHANNELS or depth not in (8, 16):
        raise ValueError(f"{path}: unsupported PNG (colour type {color}, "
                         f"bit depth {depth}); the numpy decoder reads 8- "
                         f"and 16-bit gray, gray + alpha, RGB and RGBA")
    channels = _CHANNELS[color]
    bpp = channels * depth // 8
    data = memoryview(zlib.decompress(b"".join(idat)))
    dtype = np.uint16 if depth == 16 else np.uint8
    if not interlace:
        rows = _unfilter(data, height, width * bpp, bpp)
        return _samples(rows, width, channels, depth)
    out = np.zeros((height, width, channels), dtype)
    offset = 0
    for x0, y0, dx, dy in _ADAM7:
        w = (width - x0 + dx - 1) // dx if width > x0 else 0
        h = (height - y0 + dy - 1) // dy if height > y0 else 0
        if w == 0 or h == 0:
            continue
        rows = _unfilter(data[offset:], h, w * bpp, bpp)
        out[y0::dy, x0::dx] = _samples(rows, w, channels, depth)
        offset += h * (w * bpp + 1)
    return out


def decode_png_gray(path: str, channel: int = 0) -> np.ndarray:
    """:func:`decode_png` to float32 ``[H, W]`` in [0, 1], bit-equal to
    the native ``decode_png_gray``: channel ``channel`` (0 where out of
    range), 16-bit samples by their high byte, ``* (1/255)``."""
    raw = decode_png(path)
    c = channel if 0 <= channel < raw.shape[2] else 0
    samples = raw[:, :, c]
    if samples.dtype == np.uint16:
        samples = samples >> 8
    return samples.astype(np.float32) * _INV255


def decode_png_u16(path: str, channel: int = 0) -> np.ndarray:
    """:func:`decode_png`'s raw samples as uint16 ``[H, W]``, bit-equal to
    the native ``decode_png_u16`` (the KITTI disparity convention)."""
    raw = decode_png(path)
    c = channel if 0 <= channel < raw.shape[2] else 0
    return raw[:, :, c].astype(np.uint16)


def load_image_gray(path: str, *, channel: Optional[int] = 0) -> np.ndarray:
    """Load an image as a [H, W] float32 array in [0, 1].

    Mirrors the reference's loading convention: ``/ 255`` normalization
    and channel 0 of colour inputs.  Tries the native decoder first
    (PNG), then OpenCV, then PIL, then :func:`decode_png_gray` (PNG).
    """
    c = channel if channel is not None else 0
    png = path.lower().endswith(".png")
    if png:
        from custereomatching_tpu_torch import native

        if native.native_available():
            img = native.decode_png_gray(path, c)
            if img is not None:
                return img
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        if img is None:
            raise FileNotFoundError(path)
        arr = np.asarray(img)
        if arr.ndim == 3:
            # cv2 loads BGR; the reference takes channel 0 of its RGB
            # load — for gray speckle data any single channel matches.
            arr = arr[:, :, c]
        return arr.astype(np.float32) / 255.0
    try:
        from PIL import Image
    except ImportError:
        Image = None
    if Image is not None:
        with Image.open(path) as im:
            arr = np.asarray(im)
        if arr.ndim == 3:
            arr = arr[:, :, c]
        return arr.astype(np.float32) / 255.0
    if png:
        return decode_png_gray(path, c)
    raise ImportError(f"{path}: no decoder for this file (OpenCV and PIL "
                      f"are not installed; the numpy decoder reads PNG)")


def image_decoders() -> Tuple[str, ...]:
    """The decoders :func:`load_image_gray` can use here, in its order."""
    from custereomatching_tpu_torch import native

    found = []
    if native.native_available():
        found.append("native")
    for name, module in (("cv2", "cv2"), ("PIL", "PIL.Image")):
        try:
            __import__(module)
        except ImportError:
            continue
        found.append(name)
    found.append("numpy")
    return tuple(found)


def load_stereo_pair_npy(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Load a stereo pair from a ``.npy``/``.npz`` file.

    Accepts either an ``.npz`` with ``camera``/``projector`` arrays or a
    single ``.npy`` of shape ``[2, H, W]``.
    """
    if path.endswith(".npz"):
        with np.load(path) as data:
            return (data["camera"].astype(np.float32),
                    data["projector"].astype(np.float32))
    arr = np.load(path)
    if arr.ndim != 3 or arr.shape[0] != 2:
        raise ValueError(
            f"expected [2, H, W] array in {path}, got {arr.shape}")
    return arr[0].astype(np.float32), arr[1].astype(np.float32)


def save_stereo_pair_npz(path: str, camera: np.ndarray,
                         projector: np.ndarray,
                         disparity: Optional[np.ndarray] = None) -> None:
    """Save a (generated) stereo pair, optionally with ground truth."""
    arrays = {"camera": camera, "projector": projector}
    if disparity is not None:
        arrays["disparity"] = disparity
    np.savez(path, **arrays)


def save_disparity_png(path: str, disparity: np.ndarray,
                       max_disparity: Optional[float] = None) -> None:
    """Write a disparity map as an 8-bit PNG, scaled so ``max_disparity``
    (default: the map's maximum) is 255.  Writes with OpenCV, else PIL,
    else the numpy PNG writer of :mod:`.kitti` (where the JAX package
    raises ``ImportError``)."""
    d = np.asarray(disparity, np.float32)
    scale = float(max_disparity) if max_disparity else max(float(d.max()), 1e-6)
    img = np.clip(d / scale * 255.0, 0, 255).astype(np.uint8)
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        if not cv2.imwrite(path, img):
            raise OSError(f"cv2.imwrite could not write {path}")
        return
    try:
        from PIL import Image
    except ImportError:
        from custereomatching_tpu_torch.data.kitti import _write_png_gray

        _write_png_gray(path, img, 8)
        return
    Image.fromarray(img).save(path)


__all__ = ["decode_png", "decode_png_gray", "decode_png_u16",
           "image_decoders", "load_image_gray", "load_stereo_pair_npy",
           "save_disparity_png", "save_stereo_pair_npz"]
