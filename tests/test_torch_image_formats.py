"""`imgproc.imread_gray` on JPEG, BMP and TIFF files (and through it
`data/datasets._load_gray` and the CLIs that read image directories)
against `cv2.imread(path, IMREAD_GRAYSCALE)` and the JAX package's
`_load_gray`, on files that cv2 writes here.

Tolerance: none. Every file is decoded to cv2's exact bytes (measured: 0
grey levels apart for every variant): JPEG through libjpeg's gray output
(the C++ loader at the frame's own size), BMP and TIFF in numpy with
OpenCV's gray arithmetic. A variant outside `imgproc.READS` raises a
`ValueError` that names it.
"""
import struct
from pathlib import Path

import cv2
import numpy as np
import pytest

from image_matching_tpu.data import datasets as jdatasets
from image_matching_tpu_torch import imgproc
from image_matching_tpu_torch.cli import export_pseudo, match_pair, sequence, traditional, train_superpoint
from image_matching_tpu_torch.data import datasets

from test_torch_features import one_torch_thread  # noqa: F401  (autouse: one torch thread in this module)
from test_torch_native_loader import textured

WEIGHTS = str(Path(__file__).resolve().parents[1] / "weights")
JPEG, BMP, TIFF = ".jpg", ".bmp", ".tif"
VARIANTS = {  # name: (colour, extension, cv2.imwrite parameters)
    "jpeg baseline gray": (False, JPEG, [cv2.IMWRITE_JPEG_QUALITY, 90]),
    "jpeg baseline colour": (True, JPEG, [cv2.IMWRITE_JPEG_QUALITY, 75]),
    "jpeg progressive gray": (False, JPEG, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1]),
    "jpeg progressive colour": (True, JPEG, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1]),
    "bmp 8-bit palette": (False, BMP, []),
    "bmp 24-bit": (True, BMP, []),
    "bmp 32-bit bitfields": ("alpha", BMP, []),
    "tiff gray uncompressed": (False, TIFF, [cv2.IMWRITE_TIFF_COMPRESSION, 1]),
    "tiff rgb uncompressed": (True, TIFF, [cv2.IMWRITE_TIFF_COMPRESSION, 1]),
    "tiff gray deflate": (False, TIFF, [cv2.IMWRITE_TIFF_COMPRESSION, 8]),
    "tiff rgb deflate": (True, TIFF, [cv2.IMWRITE_TIFF_COMPRESSION, 8]),
}


def _image(colour, seed, h=61, w=83):
    if colour == "alpha":
        return np.dstack([textured(seed, h, w, True), textured(seed + 1, h, w)])
    return textured(seed, h, w, bool(colour))


def _bmp_header_edit(path, **fields):
    """Rewrite BITMAPINFOHEADER fields of a BMP file in place (height,
    compression), rows reordered when the height turns negative."""
    data = bytearray(open(path, "rb").read())
    offset = struct.unpack("<I", data[10:14])[0]
    w, h, _, bpp, comp = struct.unpack("<iiHHI", data[18:34])
    if fields.get("top_down"):
        stride = (w * bpp + 31) // 32 * 4
        rows = [data[offset + r * stride:offset + (r + 1) * stride] for r in range(h)]
        data[offset:offset + h * stride] = b"".join(rows[::-1])
        data[22:26] = struct.pack("<i", -h)
    if "compression" in fields:
        data[30:34] = struct.pack("<I", fields["compression"])
    open(path, "wb").write(bytes(data))


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_imread_gray_equals_cv2(tmp_path, name):
    colour, ext, params = VARIANTS[name]
    path = str(tmp_path / f"f{ext}")
    assert cv2.imwrite(path, _image(colour, 3), params)
    paths = [path]
    if name == "bmp 24-bit":  # the same file stored top-down
        paths.append(str(tmp_path / "td.bmp"))
        cv2.imwrite(paths[-1], _image(colour, 3))
        _bmp_header_edit(paths[-1], top_down=True)
    if name == "bmp 32-bit bitfields":  # and as BI_RGB, whose gray OpenCV rounds in fixed point
        paths.append(str(tmp_path / "rgb.bmp"))
        cv2.imwrite(paths[-1], _image(colour, 3))
        _bmp_header_edit(paths[-1], compression=0)
    for p in paths:
        want = cv2.imread(p, cv2.IMREAD_GRAYSCALE)
        got = imgproc.imread_gray(p)
        assert got.dtype == np.uint8 and got.shape == want.shape == (61, 83), p
        np.testing.assert_array_equal(got, want, err_msg=p)
        for resize in (None, (30, 41), (20, 27)):  # an integer and two other factors
            np.testing.assert_array_equal(datasets._load_gray(p, resize), jdatasets._load_gray(p, resize), err_msg=p)


def test_unsupported_variants_raise_and_name_themselves(tmp_path):
    img = _image(True, 4)
    cases = {"LZW": ("lzw.tif", [cv2.IMWRITE_TIFF_COMPRESSION, 5], img),
             "16 bits": ("deep.tif", [cv2.IMWRITE_TIFF_COMPRESSION, 1], img.astype(np.uint16) * 257)}
    for what, (name, params, data) in cases.items():
        cv2.imwrite(str(tmp_path / name), data, params)
        with pytest.raises(ValueError, match=what.split()[0]):
            imgproc.imread_gray(str(tmp_path / name))
    cv2.imwrite(str(tmp_path / "rle.bmp"), img[..., 0])
    _bmp_header_edit(str(tmp_path / "rle.bmp"), compression=1)
    with pytest.raises(ValueError, match="RLE8"):
        imgproc.imread_gray(str(tmp_path / "rle.bmp"))
    # a JPEG that OpenCV would rotate (EXIF orientation 6): an APP1 segment after SOI
    cv2.imwrite(str(tmp_path / "a.jpg"), img)
    tiff = b"II*\0" + struct.pack("<I", 8) + struct.pack("<H", 1) + struct.pack("<HHIHH", 0x0112, 3, 1, 6, 0) + b"\0" * 4
    app1 = b"Exif\0\0" + tiff
    data = open(tmp_path / "a.jpg", "rb").read()
    (tmp_path / "rot.jpg").write_bytes(data[:2] + b"\xff\xe1" + struct.pack(">H", len(app1) + 2) + app1 + data[2:])
    with pytest.raises(ValueError, match="EXIF orientation 6"):
        imgproc.imread_gray(str(tmp_path / "rot.jpg"))
    (tmp_path / "cut.jpg").write_bytes(data[:20])
    with pytest.raises(ValueError, match="JPEG without a frame header"):
        imgproc.imread_gray(str(tmp_path / "cut.jpg"))
    assert {"jpg", "jpeg", "bmp", "tif", "tiff", "png", "ppm"} == {e[1:] for e in datasets.IMAGE_EXTS}


def _jpeg_dirs(root):
    """A template and 2 shifted sources, 2 train / 2 val files, 4 frames of
    a drifting camera: all JPEG."""
    big = textured(7, 300, 380)
    for d in ("src", "data/train", "data/val", "frames"):
        (root / d).mkdir(parents=True)
    cv2.imwrite(str(root / "template.jpg"), big[20:260, 20:340], [cv2.IMWRITE_JPEG_QUALITY, 95])
    for i, (dy, dx) in enumerate(((4, 6), (10, 3))):
        cv2.imwrite(str(root / "src" / f"s{i}.jpg"), big[20 + dy:260 + dy, 20 + dx:340 + dx])
    for i in range(4):
        cv2.imwrite(str(root / "data" / ("train", "val")[i // 2] / f"im_{i}.jpeg"), textured(20 + i, 96, 128))
    for i in range(4):
        cv2.imwrite(str(root / "frames" / f"{i:02d}.jpg"), big[2 * i:128 + 2 * i, 3 * i:128 + 3 * i])


def test_the_clis_read_a_jpeg_directory(tmp_path):
    _jpeg_dirs(tmp_path)
    common = ["--template", str(tmp_path / "template.jpg"), "--source_dir", str(tmp_path / "src"), "--device", "cpu"]
    recs = match_pair.main([*common, "--out", str(tmp_path / "mp"), "--resize_scale", "0.5", "--sp_checkpoint",
                            f"{WEIGHTS}/sp_photo.npz", "--max_keypoints", "256"])
    assert len(recs) == 2 and all(np.isfinite(np.asarray(r["transform"], float)).all() for r in recs)
    recs = traditional.main([*common, "--out", str(tmp_path / "tr"), "--method", "orb"])
    assert len(recs) == 2
    traj = sequence.main(["--device", "cpu", "--frames_dir", str(tmp_path / "frames"), "--strides", "1",
                          "--method", "orb", "--out", str(tmp_path / "t.json")])
    assert len(traj["frames"]) == 4 and traj["valid_edges"] >= 1
    size = ["--height", "48", "--width", "64"]
    for task in ("train", "val"):
        out = export_pseudo.main(["--device", "cpu", "--data_root", str(tmp_path / "data"), "--out",
                                  str(tmp_path / "labels"), "--task", task, "--checkpoint", f"{WEIGHTS}/sp_synth.npz",
                                  "--num_homographies", "2", "--batch_size", "2", *size])
        assert len(out["written"]) == 2
    run = train_superpoint.main(["--device", "cpu", "--data_root", str(tmp_path / "data"), "--labels",
                                 str(tmp_path / "labels"), "--batch_size", "2", "--descriptor_dim", "32",
                                 "--train_iter", "1", "--tensorboard_interval", "1", "--validation_interval", "1",
                                 "--save_interval", "1", "--run_dir", str(tmp_path / "sp"), *size])
    assert run["state"].step == 1 and np.isfinite(run["history"][0]["loss"])
