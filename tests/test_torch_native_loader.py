"""The port's binding of the C++ image loader (`native_imloader.py`,
`data/native_loader.py`,
`ALLSSDataset.batches(native=True)`, `train_superpoint --native_loader`)
against the JAX package's binding of the same source, on the CPU.

Both build `native/imloader/imloader.cpp`: the port with its own g++ line
into `build/imloader/`, the JAX package through its own Makefile, here
pointed at a copy of the source in a temporary directory (its module's
`_NATIVE_DIR`), so nothing is written into `native/`. Everything is held
exactly: decoded pixels, batches and indices at one thread, batches per
index at four (the workers push in the order they finish), a broken
file's zero image and masked labels. Against the host decoder
(`_load_gray`, OpenCV's arithmetic): JPEG and gray PNG files equal at
their own size, and within half a grey level at a factor of 2 (the loader
keeps its bins' mean in float32); colour PNG files are turned gray by
libpng's own weights, up to 19 grey levels from OpenCV's.
"""
import os
import shutil
from pathlib import Path

import cv2
import numpy as np
import pytest

from image_matching_tpu.data import datasets as jdatasets
from image_matching_tpu.data import native_loader as jnative
from image_matching_tpu_torch.cli import train_superpoint as train_cli
from image_matching_tpu_torch import native_imloader
from image_matching_tpu_torch.data import datasets, native_loader

from test_torch_features import one_torch_thread  # noqa: F401  (autouse: one torch thread in this module)

ROOT = Path(__file__).resolve().parents[1]
H, W = 48, 64  # every file is 96x128: the loader's integer factor 2


def textured(seed: int, h: int = 2 * H, w: int = 2 * W, colour: bool = False) -> np.ndarray:
    """A seeded uint8 image with structure at several scales."""
    rng = np.random.default_rng(seed)
    chans = []
    for _ in range(3 if colour else 1):
        img = sum(cv2.resize(rng.uniform(0, 1, (h // s, w // s)).astype(np.float32), (w, h),
                             interpolation=cv2.INTER_CUBIC) * (s / 8) for s in (2, 4, 8, 16))
        chans.append(img)
    img = np.stack(chans, -1) if colour else chans[0]
    img = (img - img.min()) / (img.max() - img.min())
    return np.clip(img * 255, 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    """The JAX package's binding, built by its Makefile in a copy of `native/imloader/`."""
    copy = tmp_path_factory.mktemp("imloader")
    for name in ("Makefile", "imloader.cpp"):
        shutil.copy(ROOT / "native" / "imloader" / name, copy / name)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "_NATIVE_DIR", copy)
        mp.setattr(jnative, "_LIB", None)
        mp.setattr(jnative, "_LIB_ERR", None)
        assert jnative.native_available()
        yield jnative


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """root/train: PNG and JPEG files, gray and colour, and one broken PNG;
    labels/train: their pseudo-label points."""
    root = tmp_path_factory.mktemp("data")
    (root / "data" / "train").mkdir(parents=True)
    (root / "labels" / "train").mkdir(parents=True)
    rng = np.random.default_rng(0)
    for i in range(7):
        img = textured(i, colour=i % 3 == 1)
        ext, params = ((".jpg", [cv2.IMWRITE_JPEG_QUALITY, 85]), (".png", []))[i % 2]
        if i == 4:
            params = [cv2.IMWRITE_JPEG_PROGRESSIVE, 1]
            ext = ".jpg"
        cv2.imwrite(str(root / "data" / "train" / f"im_{i}{ext}"), img, params)
    (root / "data" / "train" / "im_7.png").write_bytes(b"\x89PNG\r\n\x1a\n" + b"\0" * 40)  # broken
    for task, n in (("train", 8), ("val", 2)):
        (root / "labels" / task).mkdir(parents=True, exist_ok=True)
        for i in range(n):
            if task == "val":
                (root / "data" / "val").mkdir(exist_ok=True)
                cv2.imwrite(str(root / "data" / "val" / f"im_{i}.jpg"), textured(10 + i))
            pts = np.concatenate([rng.uniform(0, [W, H], (5 + i, 2)), rng.uniform(0, 1, (5 + i, 1))], 1)
            np.savez(root / "labels" / task / f"im_{i}.npz", pts=pts.astype(np.float32))
    return root


def _paths(files):
    return datasets._list_images(str(files / "data" / "train"))


def test_library_builds_under_build_and_fails_loudly(monkeypatch, tmp_path):
    assert native_imloader.native_available()
    lib = native_imloader.library_path()
    assert lib.exists() and lib.parent == ROOT / "build" / "imloader"
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native_imloader, "SOURCE", bad)
    monkeypatch.setattr(native_imloader, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native_imloader, "_lib", None)
    monkeypatch.setattr(native_imloader, "_error", None)
    with pytest.raises(RuntimeError, match="bad.cpp"):
        native_imloader.load_library()
    assert not native_imloader.native_available()
    for decode in (native_imloader.decode_image, native_loader.decode_image):
        with pytest.raises(RuntimeError, match="failed"):
            decode(str(bad), 4, 4)


def test_decode_image_equals_the_jax_binding(files, jax_native):
    for path in _paths(files)[:-1]:
        for size in ((2 * H, 2 * W), (H, W), (37, 50)):
            got, want = native_loader.decode_image(path, *size), jax_native.decode_image(path, *size)
            assert got.dtype == want.dtype == np.float32 and got.shape == (*size, 1)
            np.testing.assert_array_equal(got, want)
        if "im_1." in path:  # colour PNG: libpng's own gray weights, not OpenCV's (measured 19 / 255 apart)
            continue
        # at its own size the host decoder's image; at a factor of 2 INTER_AREA's
        # bins, whose mean the loader keeps in float32 where OpenCV rounds it to a byte
        np.testing.assert_array_equal(native_loader.decode_image(path, 2 * H, 2 * W), datasets._load_gray(path))
        np.testing.assert_allclose(native_loader.decode_image(path, H, W), datasets._load_gray(path, (H, W)),
                                   rtol=0, atol=0.5 / 255 + 1e-7)
    with pytest.raises(IOError, match="native decode failed"):
        native_loader.decode_image(_paths(files)[-1], H, W)


@pytest.mark.parametrize("loop", [False, True], ids=["drain", "loop"])
def test_loader_batches_equal_the_jax_loader(files, jax_native, loop):
    paths = _paths(files)
    kw = dict(n_threads=1, loop=loop, seed=3)
    ours, theirs = native_loader.NativeImageLoader(paths, H, W, **kw), jax_native.NativeImageLoader(paths, H, W, **kw)
    try:
        for _ in range(5 if loop else 3):  # 8 files: a drain is 3 + 3 + 2
            (a, ia), (b, ib) = ours.next_batch(3), theirs.next_batch(3)
            np.testing.assert_array_equal(ia, ib)
            np.testing.assert_array_equal(a, b)
            assert len(ia) == (3 if loop or len(a) == 3 else 2) and (a[ia == -8] == 0).all()
        if not loop:
            assert len(ours.next_batch(3)[0]) == 0 and len(theirs.next_batch(3)[0]) == 0
            assert [len(b["image"]) for b in native_loader.NativeImageLoader(paths, H, W, **kw).batches(3)] == [3, 3, 2]
    finally:
        ours.close()
        theirs.close()
    # four threads: the order is the workers', each image is its index's
    drained = {}
    for b in native_loader.NativeImageLoader(paths, H, W, n_threads=4, loop=False, seed=3).batches(3):
        drained.update({int(i): img for i, img in zip(b["indices"], b["image"])})
    assert sorted(drained) == [-8] + list(range(7))
    for i, img in drained.items():
        want = np.zeros((H, W, 1), np.float32) if i < 0 else jax_native.decode_image(paths[i], H, W)
        np.testing.assert_array_equal(img, want)


def test_native_dataset_batches_equal_the_jax_ones(files, jax_native):
    root, labels = str(files / "data"), str(files / "labels")
    ours = datasets.ALLSSDataset(root, "train", labels, resize=(H, W), max_points=16)
    theirs = jdatasets.ALLSSDataset(root, "train", labels, resize=(H, W), max_points=16)
    got, want = ours.batches(3, seed=5, native=True, n_threads=1), theirs.batches(3, seed=5, native=True, n_threads=1)
    broken = 0
    for _ in range(6):  # past a reshuffle
        a, b = next(got), next(want)
        assert set(a) == set(b) == {"image", "points", "points_mask", "names"} and a["names"] == b["names"]
        for k in ("image", "points", "points_mask"):
            np.testing.assert_array_equal(a[k], b[k])
        dead = ~a["points_mask"].any(1)
        broken += int(dead.sum())
        assert (a["image"][dead] == 0).all()
    assert broken >= 1  # the broken file came by, its slot masked
    got.close()
    want.close()


def test_train_superpoint_native_loader_runs(files, tmp_path):
    out = train_cli.main(["--device", "cpu", "--batch_size", "2", "--height", str(H), "--width", str(W),
                          "--descriptor_dim", "32", "--data_root", str(files / "data"), "--labels",
                          str(files / "labels"), "--native_loader", "--train_iter", "2", "--tensorboard_interval", "1",
                          "--validation_interval", "100", "--save_interval", "100", "--run_dir", str(tmp_path / "r")])
    assert out["state"].step == 2 and all(np.isfinite(r["loss"]) for r in out["logged"])


def test_split_smaller_than_a_batch_raises(tmp_path):
    os.makedirs(tmp_path / "train")
    cv2.imwrite(str(tmp_path / "train" / "a.png"), textured(0))
    ds = datasets.ALLSSDataset(str(tmp_path), "train", resize=(H, W))
    with pytest.raises(ValueError, match="1 image files, fewer than batch_size 2"):
        next(ds.batches(2))
    assert next(ds.batches(2, drop_last=False))["image"].shape == (1, H, W, 1)
    os.makedirs(tmp_path / "val")
    empty = datasets.ALLSSDataset(str(tmp_path), "val", resize=(H, W))
    for native in (False, True):
        with pytest.raises(ValueError, match="0 image files"):
            next(empty.batches(1, drop_last=False, native=native))
