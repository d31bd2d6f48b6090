"""PyTorch port: the data layer (``native``, ``data.io``, ``data.kitti``)
held against the JAX package's on the same files, and against PIL.

The port builds its own copy of the native library (``build/native/``);
its decoders, ``.npy`` loader, preprocessing and ``FrameLoader`` must give
the JAX package's values bit for bit, and so must the numpy PNG decoder
that ends the port's decoder chain.  The KITTI path (layouts, frames, the
uint16/256 ground truth, the fixture writer) is bit-equal to JAX's too.
"""

import os
import struct
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest

from custereomatching_tpu import native as jax_native
from custereomatching_tpu.data import io as jax_io
from custereomatching_tpu.data import kitti as jax_kitti
from custereomatching_tpu_torch import native
from custereomatching_tpu_torch.data import io, kitti
from custereomatching_tpu_torch.data import (
    load_stereo_pair_npy,
    make_stereo_pair,
    save_stereo_pair_npz,
)

REPO = Path(__file__).resolve().parents[1]
FIXTURE = str(REPO / "tests" / "data" / "kitti_fixture")
REPO_PNGS = sorted(str(p.relative_to(REPO)) for p in [
    *(REPO / "examples" / "data").glob("*.png"),
    *(REPO / "tests" / "data" / "kitti_fixture").rglob("*.png")])


@pytest.fixture(scope="module")
def libs():
    """Both native libraries.  The tests need libpng's headers, so the
    port's library must build wherever they run."""
    assert native.native_available(), "the port's native library builds"
    if not jax_native.native_available():
        pytest.skip("the JAX package's native library does not build here")


def _chunk(tag, data):
    body = tag + data
    return struct.pack(">I", len(data)) + body + struct.pack(
        ">I", zlib.crc32(body) & 0xFFFFFFFF)


def _filter_row(line, prev, bpp, ftype):
    """Apply PNG filter ``ftype`` to one row of bytes."""
    x = line.astype(np.int64)
    b = prev.astype(np.int64)
    a = np.concatenate([np.zeros(bpp, np.int64), x[:-bpp]])
    c = np.concatenate([np.zeros(bpp, np.int64), b[:-bpp]])
    if ftype == 0:
        pred = np.zeros_like(x)
    elif ftype == 1:
        pred = a
    elif ftype == 2:
        pred = b
    elif ftype == 3:
        pred = (a + b) >> 1
    else:
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    return ((x - pred) & 0xFF).astype(np.uint8)


def _write_png(path, img, ftypes=(0,), interlace=False):
    """A PNG of ``img`` ([H, W] or [H, W, C], uint8 or uint16) with rows
    filtered in turn by ``ftypes``, Adam7-interlaced if asked (PIL writes
    neither forced filters nor interlaced files)."""
    img = img if img.ndim == 3 else img[:, :, None]
    h, w, ch = img.shape
    depth = 16 if img.dtype == np.uint16 else 8
    color = {1: 0, 2: 4, 3: 2, 4: 6}[ch]
    bpp = ch * depth // 8
    passes = ([(0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
               (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2)] if interlace
              else [(0, 0, 1, 1)])
    raw, n = bytearray(), 0
    for x0, y0, dx, dy in passes:
        sub = img[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        rows = sub.astype(">u2" if depth == 16 else np.uint8)
        prev = np.zeros(sub.shape[1] * bpp, np.uint8)
        for row in rows:
            line = np.frombuffer(row.tobytes(), np.uint8)
            ftype = ftypes[n % len(ftypes)]
            n += 1
            raw.append(ftype)
            raw.extend(_filter_row(line, prev, bpp, ftype).tobytes())
            prev = line
    ihdr = struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, int(interlace))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
                + _chunk(b"IDAT", zlib.compress(bytes(raw)))
                + _chunk(b"IEND", b""))


def _image(rng, h, w, channels, depth):
    top = 65536 if depth == 16 else 256
    shape = (h, w) if channels == 1 else (h, w, channels)
    return rng.integers(0, top, size=shape).astype(
        np.uint16 if depth == 16 else np.uint8)


def _decoders_agree(path, channels, want_gray, want_u16):
    """The port's native decoders, JAX's and the numpy decoder give the
    same values, and those are ``want``, for every channel."""
    for c in range(channels):
        gray = [native.decode_png_gray(path, c),
                jax_native.decode_png_gray(path, c),
                io.decode_png_gray(path, c)]
        u16 = [native.decode_png_u16(path, c),
               jax_native.decode_png_u16(path, c),
               io.decode_png_u16(path, c)]
        for g in gray:
            assert g.dtype == np.float32
            np.testing.assert_array_equal(g, want_gray(c))
        for u in u16:
            assert u.dtype == np.uint16
            np.testing.assert_array_equal(u, want_u16(c))


def _expected(img):
    """libpng's values: 8-bit samples / 255 (as ``* (1.0f / 255.0f)``),
    16-bit ones by their high byte; raw samples as uint16."""
    img = img if img.ndim == 3 else img[:, :, None]
    inv = np.float32(1.0) / np.float32(255.0)

    def gray(c):
        s = img[:, :, c]
        s = s >> 8 if s.dtype == np.uint16 else s
        return s.astype(np.float32) * inv

    return gray, lambda c: img[:, :, c].astype(np.uint16)


@pytest.mark.parametrize("channels,depth", [
    (1, 8), (1, 16), (2, 8), (3, 8), (4, 8), (3, 16), (4, 16)])
@pytest.mark.parametrize("ftypes,interlace", [
    ((0,), False), ((1,), False), ((2,), False), ((3,), False),
    ((4,), False), ((0, 1, 2, 3, 4), False), ((0,), True),
    ((4, 3, 2, 1), True)])
def test_png_kinds_decode_bit_equal(libs, tmp_path, channels, depth, ftypes,
                                    interlace):
    """Every filter type, Adam7, 8 and 16 bits, gray to RGBA: the port's
    native decoders, JAX's and the numpy decoder agree bit for bit."""
    rng = np.random.default_rng(channels * 100 + depth + 7 * len(ftypes))
    img = _image(rng, 23, 31, channels, depth)
    path = str(tmp_path / "img.png")
    _write_png(path, img, ftypes, interlace)
    _decoders_agree(path, channels, *_expected(img))


@pytest.mark.parametrize("mode,channels", [
    ("L", 1), ("LA", 2), ("RGB", 3), ("RGBA", 4), ("I;16", 1)])
def test_pil_written_png_bit_equal(libs, tmp_path, mode, channels):
    """PIL's writer (its own filter choices): decoders agree with PIL's
    own reading of the file."""
    Image = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(len(mode) + channels)
    depth = 16 if mode == "I;16" else 8
    img = _image(rng, 37, 53, channels, depth)
    path = str(tmp_path / "pil.png")
    pil = Image.fromarray(img)
    assert pil.mode == mode
    pil.save(path)
    with Image.open(path) as im:
        np.testing.assert_array_equal(np.asarray(im), img)
    _decoders_agree(path, channels, *_expected(img))


@pytest.mark.parametrize("path", REPO_PNGS)
def test_repo_pngs_bit_equal(libs, path):
    """Every PNG the repository holds: the numpy decoder, the port's
    native decoder and JAX's agree, and ``load_image_gray`` equals JAX's."""
    path = str(REPO / path)
    want = jax_native.decode_png_gray(path)
    np.testing.assert_array_equal(native.decode_png_gray(path), want)
    np.testing.assert_array_equal(io.decode_png_gray(path), want)
    np.testing.assert_array_equal(io.decode_png_u16(path),
                                  jax_native.decode_png_u16(path))
    np.testing.assert_array_equal(io.load_image_gray(path),
                                  jax_io.load_image_gray(path))


@pytest.mark.parametrize("missing", ["native", "native+cv2",
                                     "native+cv2+PIL"])
@pytest.mark.parametrize("name", ["capture_camera.png", "kitti_left"])
def test_load_image_gray_chain(libs, monkeypatch, missing, name):
    """With the native library, then OpenCV, then PIL taken away,
    ``load_image_gray`` decodes with the next and gives JAX's values on
    8-bit files (the numpy decoder bit-equal to the native one)."""
    path = str(REPO / "examples" / "data" / name if name.endswith(".png")
               else Path(FIXTURE) / "training" / "image_2" / "000000_10.png")
    want = jax_io.load_image_gray(path)
    monkeypatch.setattr(native, "native_available", lambda: False)
    hidden = {"native+cv2": ["cv2"], "native+cv2+PIL": ["cv2", "PIL"]}
    for mod in hidden.get(missing, []):
        monkeypatch.setitem(sys.modules, mod, None)
        if mod == "PIL":
            monkeypatch.setitem(sys.modules, "PIL.Image", None)
    got = io.load_image_gray(path)
    assert got.dtype == np.float32 and got.shape == want.shape
    if missing == "native+cv2+PIL":
        np.testing.assert_array_equal(got, want)
        assert io.image_decoders() == ("numpy",)
    else:
        # OpenCV and PIL divide by 255 where libpng multiplies by 1/255.
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_numpy_decoder_refuses_what_it_cannot_read(tmp_path):
    bad = tmp_path / "bad.png"
    bad.write_bytes(b"not a png at all")
    with pytest.raises(ValueError, match="not a PNG"):
        io.decode_png(str(bad))
    pal = tmp_path / "pal.png"
    ihdr = struct.pack(">IIBBBBB", 4, 4, 8, 3, 0, 0, 0)
    pal.write_bytes(b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
                    + _chunk(b"IDAT", zlib.compress(b"\0" * 20))
                    + _chunk(b"IEND", b""))
    with pytest.raises(ValueError, match="unsupported PNG"):
        io.decode_png(str(pal))


def test_native_npy_and_preprocessing_equal_jax(libs, tmp_path):
    rng = np.random.default_rng(0)
    for shape in [(5, 7, 9), (3,), (2, 3, 4, 5), (330, 422)]:
        arr = rng.random(shape).astype(np.float32)
        path = str(tmp_path / "a.npy")
        np.save(path, arr)
        got = native.load_npy_f32(path)
        assert got.shape == arr.shape and np.array_equal(got, arr)
        np.testing.assert_array_equal(got, jax_native.load_npy_f32(path))
    for shape, channel in [((11, 13), 0), ((11, 13, 3), 2), ((9, 5, 4), 1),
                           ((9, 5, 3), 7)]:
        u8 = rng.integers(0, 256, size=shape).astype(np.uint8)
        got = native.u8_to_f32_gray(u8, channel)
        np.testing.assert_array_equal(got,
                                      jax_native.u8_to_f32_gray(u8, channel))
        np.testing.assert_allclose(got, (u8 if u8.ndim == 2 else u8[
            :, :, channel if channel < shape[2] else 0]) / 255.0, atol=1e-7)
    a = rng.random((5, 7)).astype(np.float32)
    pad = native.pad_image_f32(a, 10, 16, 2, 3)
    np.testing.assert_array_equal(pad, jax_native.pad_image_f32(a, 10, 16,
                                                                2, 3))
    assert np.array_equal(pad[2:7, 3:10], a)
    mask = np.ones((10, 16), bool)
    mask[2:7, 3:10] = False
    assert (pad[mask] == 0).all()
    with pytest.raises(ValueError, match="does not fit"):
        native.pad_image_f32(a, 6, 16, 2, 3)


def _write_npy_with_header(path, header, payload=b""):
    body = header.encode()
    pad = (64 - (10 + len(body) + 1) % 64) % 64
    body += b" " * pad + b"\n"
    with open(path, "wb") as f:
        f.write(b"\x93NUMPY\x01\x00")
        f.write(struct.pack("<H", len(body)))
        f.write(body)
        f.write(payload)


@pytest.mark.parametrize("header", [
    "{'descr': '<f4', 'fortran_order': False, 'shape': (-3, 4), }",
    "{'descr': '<f4', 'fortran_order': False, 'shape': (2, 2, 2, 2, 2), }",
    "{'descr': '<f4', 'fortran_order': False, "
    "'shape': (4611686018427387904, 8), }",
    "{'descr': '<f8', 'fortran_order': False, 'shape': (2, 2), }",
    "{'descr': '<f4', 'fortran_order': True, 'shape': (2, 2), }",
    "{'descr': '<f4', 'fortran_order': False, 'shape': (64, 64), }",
])
def test_native_npy_rejects_hostile_headers(libs, tmp_path, header):
    """Negative, overflowing, >4-dim, non-f4, Fortran-order or truncated
    arrays give None, as in JAX's library, and are never over-read."""
    path = str(tmp_path / "h.npy")
    _write_npy_with_header(path, header, b"\0" * 128)
    assert native.load_npy_f32(path) is None
    assert jax_native.load_npy_f32(path) is None


def _frames(tmp_path, n, shape=(16, 24), seed=7, prefix="f"):
    Image = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(seed)
    paths, want = [], []
    for i in range(n):
        img = rng.integers(0, 256, size=(shape[0] + i % 3, shape[1]),
                           dtype=np.uint8)
        img[0, 0] = i
        p = str(tmp_path / f"{prefix}{i:02d}.png")
        Image.fromarray(img).save(p)
        paths.append(p)
        want.append(img)
    return paths, want


@pytest.mark.parametrize("threads,capacity", [(1, 2), (4, 4), (8, 2),
                                              (3, 16), (0, 4)])
def test_frame_loader_order_equals_jax(libs, tmp_path, threads, capacity):
    """The decode pool delivers frames in path order, each equal to a
    direct decode and to JAX's loader's frame."""
    paths, want = _frames(tmp_path, 24)
    with native.FrameLoader(paths, capacity=capacity,
                            threads=threads) as frames:
        got = list(frames)
    with jax_native.FrameLoader(paths, capacity=capacity,
                                threads=threads) as frames:
        ref = list(frames)
    assert len(got) == len(ref) == 24
    for g, r, w, p in zip(got, ref, want, paths):
        np.testing.assert_array_equal(g, r)
        np.testing.assert_array_equal(g, native.decode_png_gray(p))
        assert int(round(g[0, 0] * 255.0)) == int(w[0, 0])


@pytest.mark.parametrize("threads", [1, 4])
def test_frame_loader_bad_frame(libs, tmp_path, threads):
    """A corrupt frame raises IOError at its place; iteration goes on."""
    paths, _ = _frames(tmp_path, 8, seed=5)
    with open(paths[3], "wb") as f:
        f.write(b"corrupt")
    frames = native.FrameLoader(paths, capacity=3, threads=threads)
    got, err_at, pos = [], None, 0
    while True:
        try:
            got.append(int(round(next(frames)[0, 0] * 255.0)))
        except StopIteration:
            break
        except IOError:
            err_at = pos
        pos += 1
    frames.close()
    assert err_at == 3
    assert got == [0, 1, 2, 4, 5, 6, 7]
    with pytest.raises(StopIteration):
        next(frames)


def test_npz_and_npy_pairs(tmp_path):
    cam, proj, disp = make_stereo_pair(16, 24)
    path = str(tmp_path / "pair.npz")
    save_stereo_pair_npz(path, cam, proj, disp)
    c2, p2 = load_stereo_pair_npy(path)
    np.testing.assert_array_equal(c2, cam)
    np.testing.assert_array_equal(p2, proj)
    jc, jp = jax_io.load_stereo_pair_npy(path)
    np.testing.assert_array_equal(c2, jc)
    np.testing.assert_array_equal(p2, jp)
    npy = str(tmp_path / "pair.npy")
    np.save(npy, np.stack([cam, proj]))
    c3, p3 = load_stereo_pair_npy(npy)
    np.testing.assert_array_equal(c3, cam)
    np.testing.assert_array_equal(p3, proj)
    np.save(npy, cam)
    with pytest.raises(ValueError, match=r"expected \[2, H, W\]"):
        load_stereo_pair_npy(npy)


@pytest.mark.parametrize("missing", [(), ("cv2",), ("cv2", "PIL")])
def test_save_disparity_png(tmp_path, monkeypatch, missing):
    """Each writer (OpenCV, PIL, then the numpy writer, where JAX's
    raises) writes the same 8-bit PNG values."""
    for mod in missing:
        monkeypatch.setitem(sys.modules, mod, None)
        if mod == "PIL":
            monkeypatch.setitem(sys.modules, "PIL.Image", None)
    rng = np.random.default_rng(3)
    d = (rng.random((19, 27)) * 40).astype(np.float32)
    path = str(tmp_path / "d.png")
    io.save_disparity_png(path, d, max_disparity=48)
    want = np.clip(d / 48.0 * 255.0, 0, 255).astype(np.uint8)
    np.testing.assert_array_equal(io.decode_png_u16(path), want)


# -- KITTI ---------------------------------------------------------------


def test_kitti_disparity_roundtrip_exact(tmp_path):
    """Encode → decode is exact at the uint16/256 grid, 0 = invalid, and
    the file is byte-equal to JAX's."""
    rng = np.random.default_rng(0)
    d = np.round(rng.uniform(0, 80, size=(13, 29)) * 256) / 256
    d[0, :5] = 0.0
    path, jpath = str(tmp_path / "disp.png"), str(tmp_path / "jdisp.png")
    kitti.save_kitti_disparity(path, d)
    jax_kitti.save_kitti_disparity(jpath, d)
    assert Path(path).read_bytes() == Path(jpath).read_bytes()
    got, valid = kitti.load_kitti_disparity(path)
    np.testing.assert_array_equal(got, d.astype(np.float32))
    np.testing.assert_array_equal(valid, d > 0)


@pytest.mark.parametrize("missing", ["native", "native+cv2"])
def test_kitti_disparity_decoder_chain(tmp_path, monkeypatch, missing):
    """Without the native library (then without OpenCV) the ground truth
    decodes to the same values through the next decoder."""
    rng = np.random.default_rng(1)
    raw = rng.integers(0, 65536, size=(17, 23)).astype(np.uint16)
    path = str(tmp_path / "u16.png")
    kitti._write_png_gray(path, raw, 16)
    monkeypatch.setattr(native, "native_available", lambda: False)
    if missing == "native+cv2":
        monkeypatch.setitem(sys.modules, "cv2", None)
    got, valid = kitti.load_kitti_disparity(path)
    np.testing.assert_array_equal(got, raw.astype(np.float32) / 256.0)
    np.testing.assert_array_equal(valid, raw > 0)


def test_kitti_fixture_layout_and_frames_equal_jax():
    assert kitti.detect_layout(FIXTURE) == jax_kitti.detect_layout(FIXTURE)
    ld, rd, gd = kitti.detect_layout(FIXTURE)
    assert ld.endswith("image_2") and rd.endswith("image_3")
    assert gd.endswith("disp_occ_0")
    ids = kitti.list_frames(FIXTURE)
    assert ids == jax_kitti.list_frames(FIXTURE) == ["000000_10",
                                                     "000001_10"]
    for fid in ids:
        fr, jfr = kitti.load_frame(FIXTURE, fid), jax_kitti.load_frame(
            FIXTURE, fid)
        assert fr.frame_id == jfr.frame_id == fid
        for name in ("camera", "projector", "gt_disparity", "gt_valid"):
            np.testing.assert_array_equal(getattr(fr, name),
                                          getattr(jfr, name))
        assert fr.camera.dtype == np.float32
        assert 0.0 <= fr.camera.min() and fr.camera.max() <= 1.0
        assert fr.gt_valid.all()
        assert 2.0 <= fr.gt_disparity.max() <= 16.0


@pytest.mark.parametrize("left,right,gt", [
    ("colored_0", "colored_1", "disp_occ"),
    ("image_0", "image_1", "disp_noc"),
    ("image_2", "image_3", "disp_noc_0"),
    ("image_0", "image_1", None),
])
def test_kitti_layouts_equal_jax(tmp_path, left, right, gt):
    """The 2012 directory names (and a split without ground truth) load
    as in JAX; the fixture writer's files are byte-equal to JAX's."""
    ids = kitti.write_fixture(str(tmp_path / "p"), num_frames=1, height=24,
                              width=48, max_disparity=6, seed=7)
    jids = jax_kitti.write_fixture(str(tmp_path / "j"), num_frames=1,
                                   height=24, width=48, max_disparity=6,
                                   seed=7)
    assert ids == jids
    for sub in ("image_2", "image_3", "disp_occ_0"):
        for fid in ids:
            rel = Path("training") / sub / f"{fid}.png"
            assert ((tmp_path / "p" / rel).read_bytes()
                    == (tmp_path / "j" / rel).read_bytes())
    base = tmp_path / "p" / "training"
    os.rename(base / "image_2", base / left)
    os.rename(base / "image_3", base / right)
    if gt is None:
        os.remove(base / "disp_occ_0" / f"{ids[0]}.png")
        os.rmdir(base / "disp_occ_0")
    else:
        os.rename(base / "disp_occ_0", base / gt)
    root = str(tmp_path / "p")
    assert kitti.detect_layout(root) == jax_kitti.detect_layout(root)
    fr, jfr = kitti.load_frame(root, ids[0]), jax_kitti.load_frame(
        root, ids[0])
    assert fr.camera.shape == (24, 48)
    np.testing.assert_array_equal(fr.camera, jfr.camera)
    np.testing.assert_array_equal(fr.projector, jfr.projector)
    if gt is None:
        assert fr.gt_disparity is None and jfr.gt_disparity is None
    else:
        np.testing.assert_array_equal(fr.gt_disparity, jfr.gt_disparity)


def test_kitti_no_layout_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="no KITTI layout"):
        kitti.detect_layout(str(tmp_path))
