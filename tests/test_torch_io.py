"""The port's image files and area resize (`imgproc.imread_gray`,
`imwrite_png`, `resize_area`, `rectangle`) against OpenCV, on the CPU.

`cv2` is imported here only; the port never imports it. Every comparison
is exact: the decoders and the resize give OpenCV's bytes.
"""
import struct
import zlib

import cv2
import numpy as np
import pytest

from image_matching_tpu_torch import imgproc

FILTERS = ("NONE", "SUB", "UP", "AVG", "PAETH")


def _images(rng, h=37, w=53):
    """Random and smooth content (the smooth one makes libpng pick other
    filters than the random one)."""
    smooth = (np.add.outer(np.arange(h) * 3, np.arange(w) * 2) % 256).astype(np.uint8)
    return {"random": rng.integers(0, 256, (h, w), dtype=np.uint8), "smooth": smooth}


def _colour(img, rng, alpha):
    planes = [img, np.roll(img, 5, 1), 255 - img]
    if alpha:
        planes.append(rng.integers(0, 256, img.shape, dtype=np.uint8))
    return np.stack(planes, -1)


def _filter_types(path):
    """The filter byte of every row of a non-interlaced 8-bit PNG."""
    data = open(path, "rb").read()
    chunks = list(imgproc._png_chunks(data, path))
    w, h, _, ctype, *_ = struct.unpack(">IIBBBBB", chunks[0][1])
    raw = zlib.decompress(b"".join(b for k, b in chunks if k == b"IDAT"))
    stride = 1 + w * imgproc._PNG_CHANNELS[ctype]
    return set(raw[::stride][:h])


@pytest.mark.parametrize("channels", ["gray", "bgr", "bgra"])
def test_imread_gray_equals_cv2_on_png(tmp_path, channels):
    rng = np.random.default_rng(0)
    seen = set()
    for name, img in _images(rng).items():
        im = img if channels == "gray" else _colour(img, rng, channels == "bgra")
        for flt in FILTERS + ("ALL",):
            path = str(tmp_path / f"{name}_{flt}.png")
            flag = cv2.IMWRITE_PNG_ALL_FILTERS if flt == "ALL" else getattr(cv2, f"IMWRITE_PNG_FILTER_{flt}")
            cv2.imwrite(path, im, [cv2.IMWRITE_PNG_FILTER, flag])
            seen |= _filter_types(path)
            got = imgproc.imread_gray(path)
            assert got.dtype == np.uint8 and got.shape == img.shape
            np.testing.assert_array_equal(got, cv2.imread(path, cv2.IMREAD_GRAYSCALE), err_msg=f"{name} {flt}")
    assert seen == {0, 1, 2, 3, 4}


def _chunk(kind, body):
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def _png(w, h, ctype, rows, extra=b"", interlace=0):
    raw = b"".join(b"\x00" + r.tobytes() for r in rows)
    return (imgproc.PNG_SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, interlace)) + extra
            + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b""))


def test_imread_gray_equals_cv2_on_palette_and_gray_alpha_png(tmp_path):
    rng = np.random.default_rng(1)
    palette = rng.integers(0, 256, (200, 3), dtype=np.uint8)
    palette[:20] = palette[:20, :1]  # some gray entries
    idx = rng.integers(0, 200, (21, 33), dtype=np.uint8)
    files = {
        "palette": _png(33, 21, 3, idx, _chunk(b"PLTE", palette.tobytes())),
        "palette_trns": _png(33, 21, 3, idx, _chunk(b"PLTE", palette.tobytes()) + _chunk(b"tRNS", bytes(range(200)))),
        "gray_alpha": _png(33, 21, 4, rng.integers(0, 256, (21, 33, 2), dtype=np.uint8)),
        "gray_gama": _png(33, 21, 0, idx, _chunk(b"gAMA", struct.pack(">I", 45455))),
        "rgb_gama_1": _png(33, 21, 2, palette[idx], _chunk(b"gAMA", struct.pack(">I", 100000))),
    }
    for name, data in files.items():
        path = tmp_path / f"{name}.png"
        path.write_bytes(data)
        np.testing.assert_array_equal(imgproc.imread_gray(str(path)), cv2.imread(str(path), cv2.IMREAD_GRAYSCALE),
                                      err_msg=name)


def test_imread_gray_equals_cv2_on_pgm_and_ppm(tmp_path):
    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, (19, 27), dtype=np.uint8)
    cv2.imwrite(str(tmp_path / "a.pgm"), img)
    cv2.imwrite(str(tmp_path / "a.ppm"), _colour(img, rng, False))
    (tmp_path / "b.pgm").write_bytes(b"P5\n# a comment\n27 19\n# another\n200\n" + (img // 2).tobytes())
    for name in ("a.pgm", "a.ppm", "b.pgm"):
        path = str(tmp_path / name)
        np.testing.assert_array_equal(imgproc.imread_gray(path), cv2.imread(path, cv2.IMREAD_GRAYSCALE), err_msg=name)


def test_unreadable_files_raise_naming_the_formats(tmp_path):
    img = np.random.default_rng(3).integers(0, 256, (16, 16), dtype=np.uint8)
    cv2.imwrite(str(tmp_path / "a.tif"), img, [cv2.IMWRITE_TIFF_COMPRESSION, 5])  # LZW: not read
    cv2.imwrite(str(tmp_path / "b.png"), img.astype(np.uint16) * 257)
    (tmp_path / "c.png").write_bytes(_png(16, 16, 0, img, interlace=1))
    (tmp_path / "d.png").write_bytes(_png(16, 16, 2, np.dstack([img] * 3), _chunk(b"sRGB", b"\x00")))
    (tmp_path / "e.pgm").write_bytes(b"P2\n16 16\n255\n" + b" 0" * 256)
    damaged = bytearray(_png(16, 16, 0, img))
    damaged[40] ^= 0xFF
    (tmp_path / "f.png").write_bytes(bytes(damaged))
    for name in ("a.tif", "b.png", "c.png", "d.png", "e.pgm", "f.png"):
        with pytest.raises(ValueError, match="reads 8-bit PNG .* binary PGM / PPM"):
            imgproc.imread_gray(str(tmp_path / name))
    with pytest.raises(FileNotFoundError):
        imgproc.imread_gray(str(tmp_path / "missing.png"))


@pytest.mark.parametrize("shape", [(37, 53), (37, 53, 3)])
def test_imwrite_png_reads_back_through_cv2(tmp_path, shape):
    img = np.random.default_rng(4).integers(0, 256, shape, dtype=np.uint8)
    imgproc.imwrite_png(str(tmp_path / "a.png"), img)
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "a.png"), cv2.IMREAD_UNCHANGED), img)
    gray = img if img.ndim == 2 else cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
    assert np.abs(imgproc.imread_gray(str(tmp_path / "a.png")).astype(int) - gray).max() <= 1
    with pytest.raises(ValueError):
        imgproc.imwrite_png(str(tmp_path / "b.png"), img.astype(np.float32))


@pytest.mark.parametrize("scale", [0.25, 0.125, 0.5, 1 / 3, 0.3])
def test_resize_area_equals_cv2_at_scales(scale):
    rng = np.random.default_rng(5)
    for h, w in ((96, 128), (97, 131), (50, 35), (480, 640)):
        for img in _images(rng, h, w).values():
            ref = cv2.resize(img, None, fx=scale, fy=scale, interpolation=cv2.INTER_AREA)
            got = imgproc.resize_area(img, scale=scale)
            assert got.dtype == np.uint8
            np.testing.assert_array_equal(got, ref, err_msg=f"{(h, w)} x {scale}")


@pytest.mark.parametrize("src,dst", [((480, 640), (240, 320)), ((300, 500), (240, 320)), ((1920, 2560), (480, 640)),
                                     ((97, 131), (30, 61)), ((64, 64), (64, 32)), ((50, 70), (50, 70))])
def test_resize_area_equals_cv2_at_sizes(src, dst):
    img = np.random.default_rng(6).integers(0, 256, src, dtype=np.uint8)
    np.testing.assert_array_equal(imgproc.resize_area(img, size=dst),
                                  cv2.resize(img, dst[::-1], interpolation=cv2.INTER_AREA))


def test_resize_area_shrinks_only():
    img = np.zeros((10, 10), np.uint8)
    with pytest.raises(ValueError, match="shrinks only"):
        imgproc.resize_area(img, size=(20, 10))
    with pytest.raises(ValueError):
        imgproc.resize_area(img.astype(np.float32), scale=0.5)


def test_rectangle_equals_cv2():
    rng = np.random.default_rng(7)
    for _ in range(50):
        p0, p1 = (tuple(int(v) for v in rng.integers(-10, 70, 2)) for _ in range(2))
        a, b = np.zeros((48, 64), np.float32), np.zeros((48, 64), np.float32)
        cv2.rectangle(a, p0, p1, 0.7, -1)
        imgproc.rectangle(b, p0, p1, 0.7)
        np.testing.assert_array_equal(a, b, err_msg=str((p0, p1)))
