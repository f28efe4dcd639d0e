"""Host-side datasets: file listing, decode, resize — the counterpart of
`image_matching_tpu/data/datasets.py`, in numpy.

Images are read by `imgproc.imread_gray` and shrunk by
`imgproc.resize_area`, which give what `cv2.imread(IMREAD_GRAYSCALE)` and
`cv2.resize(INTER_AREA)` give, for the formats of `imgproc.READS`.
`SyntheticShapesDataset` draws with `imgproc`'s rasterisers and the same
`np.random.default_rng` calls in the same order as the JAX package's, so a
seed gives the same points and images. `ALLSSDataset.batches(native=True)`
decodes through the repository's threaded C++ loader
(`data/native_loader.py`), as the JAX package's does.
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import Iterator, List, Optional, Tuple

import numpy as np

from image_matching_tpu_torch import imgproc

IMAGE_EXTS = {".png", ".jpg", ".jpeg", ".bmp", ".ppm", ".tif", ".tiff"}


def _load_gray(path: str, resize: Optional[Tuple[int, int]] = None,
               resize_scale: Optional[float] = None) -> np.ndarray:
    """Image file -> float32 grayscale (H, W, 1) in [0, 1], shrunk to
    `resize` (h, w) or by `resize_scale`."""
    img = imgproc.imread_gray(str(path))
    if resize is not None:
        img = imgproc.resize_area(img, size=tuple(resize))
    elif resize_scale is not None and resize_scale != 1.0:
        img = imgproc.resize_area(img, scale=resize_scale)
    return (img.astype(np.float32) / 255.0)[..., None]


def _list_images(directory: str) -> List[str]:
    return [os.path.join(directory, f) for f in sorted(os.listdir(directory)) if Path(f).suffix.lower() in IMAGE_EXTS]


def pad_points(pts: np.ndarray, capacity: int) -> Tuple[np.ndarray, np.ndarray]:
    """(N, 2) float points -> ((K, 2), (K,)) padded array + validity mask."""
    out = np.zeros((capacity, 2), np.float32)
    mask = np.zeros((capacity,), bool)
    n = min(len(pts), capacity)
    if n:
        out[:n] = pts[:n]
        mask[:n] = True
    return out, mask


class ALLSSDataset:
    """Images (+ optional .npz pseudo-label points) under root/{train,val},
    resized to `resize` (h, w), grayscale [0, 1]; labels are `.npz` files
    holding `pts` rows (x, y[, score]), padded to `max_points`."""

    def __init__(self, root: str, task: str = "train", labels_dir: Optional[str] = None,
                 resize: Tuple[int, int] = (480, 640), max_points: int = 1200):
        self.root = os.path.join(root, task)
        self.files = _list_images(self.root)
        self.labels_dir = os.path.join(labels_dir, task) if labels_dir else None
        self.resize = resize
        self.max_points = max_points

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, idx: int) -> dict:
        path = self.files[idx]
        sample = {"image": _load_gray(path, resize=self.resize), "name": Path(path).stem}
        if self.labels_dir:
            sample["points"], sample["points_mask"] = self._load_points(idx)
        return sample

    def _load_points(self, idx: int):
        pts = np.load(os.path.join(self.labels_dir, Path(self.files[idx]).stem + ".npz"))["pts"]
        return pad_points(pts[:, :2].astype(np.float32), self.max_points)

    def batches(self, batch_size: int, shuffle: bool = True, seed: int = 0, drop_last: bool = True,
                native: bool = False, n_threads: int = 4) -> Iterator[dict]:
        """Endless batches, reshuffled each pass by `default_rng(seed)`.
        With `native=True` the C++ loader decodes and resizes the images on
        `n_threads` threads (PNG and JPEG only; its truncating area bins
        equal `_load_gray`'s resize at integer factors only) and reshuffles
        with its own `mt19937(seed)`; labels are still read per index, a
        file that does not decode keeps its zero image and masks its points
        out, and `names` come with the batch, as in the JAX package. A
        split with no file, or (with `drop_last`) fewer files than
        `batch_size`, raises a `ValueError`: it would yield no batch."""
        if not self.files or (drop_last and not native and len(self) < batch_size):
            raise ValueError(f"{self.root}: {len(self)} image files, fewer than batch_size {batch_size}; "
                             "a batch needs that many")
        if native:
            yield from self._native_batches(batch_size, seed, drop_last, n_threads)
            return
        order = np.arange(len(self))
        rng = np.random.default_rng(seed)
        while True:
            if shuffle:
                rng.shuffle(order)
            for start in range(0, len(order) - (batch_size - 1 if drop_last else 0), batch_size):
                idxs = order[start:start + batch_size]
                samples = [self[i] for i in idxs]
                batch = {k: np.stack([s[k] for s in samples]) for k in samples[0] if k != "name"}
                batch["names"] = [s["name"] for s in samples]
                yield batch


    def _native_batches(self, batch_size: int, seed: int, drop_last: bool, n_threads: int) -> Iterator[dict]:
        from image_matching_tpu_torch.data.native_loader import NativeImageLoader

        loader = NativeImageLoader(self.files, self.resize[0], self.resize[1], n_threads=n_threads, loop=True,
                                   seed=seed)
        try:
            while True:
                images, idxs = loader.next_batch(batch_size)
                if len(images) < batch_size and drop_last:
                    continue
                ok = idxs >= 0
                idxs = np.where(ok, idxs, 0)
                batch = {"image": images}
                if self.labels_dir:
                    pts = [self._load_points(int(i)) for i in idxs]
                    batch["points"] = np.stack([p[0] for p in pts])
                    batch["points_mask"] = np.stack([p[1] & o for p, o in zip(pts, ok)])
                batch["names"] = [Path(self.files[int(i)]).stem for i in idxs]
                yield batch
        finally:
            loader.close()


class SSHIDataset:
    """Template-vs-source pairs: one template image and a directory of
    source images, all grayscale, shrunk by `resize_scale`."""

    def __init__(self, template_path: str, source_dir: str, resize_scale: float = 1.0):
        self.template_path = template_path
        self.files = _list_images(source_dir)
        self.resize_scale = resize_scale
        self._template = _load_gray(template_path, resize_scale=resize_scale)

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, idx: int) -> dict:
        path = self.files[idx]
        return {
            "source_orig": _load_gray(path),
            "source": _load_gray(path, resize_scale=self.resize_scale),
            "template": self._template,
            "name": Path(path).stem,
        }


class SyntheticShapesDataset:
    """Random polygons / lines / checkerboards with exact corner GT."""

    def __init__(self, height: int = 240, width: int = 320, max_points: int = 64, seed: int = 0):
        self.h, self.w = height, width
        self.max_points = max_points
        self.rng = np.random.default_rng(seed)

    def sample(self) -> dict:
        h, w, rng = self.h, self.w, self.rng
        img = np.full((h, w), rng.uniform(0.0, 0.3), np.float32)
        pts: List[Tuple[float, float]] = []
        margin = max(4, min(h, w) // 8)
        kind = rng.integers(0, 3)
        if kind == 0:  # random convex-ish polygons
            for _ in range(rng.integers(1, 4)):
                n = int(rng.integers(3, 7))
                cx = rng.uniform(margin, w - margin)
                cy = rng.uniform(margin, h - margin)
                rmax = min(h, w) * 0.2
                radii = rng.uniform(rmax * 0.3, rmax, n)
                angles = np.sort(rng.uniform(0, 2 * np.pi, n))
                poly = np.stack([cx + radii * np.cos(angles), cy + radii * np.sin(angles)], -1)
                imgproc.fill_poly(img, poly.astype(np.int32), rng.uniform(0.4, 1.0))
                pts.extend([tuple(p) for p in poly])
        elif kind == 1:  # line segments
            for _ in range(rng.integers(2, 8)):
                p0 = rng.uniform([margin, margin], [w - margin, h - margin])
                p1 = rng.uniform([margin, margin], [w - margin, h - margin])
                imgproc.line(img, tuple(p0.astype(int)), tuple(p1.astype(int)), float(rng.uniform(0.4, 1.0)), 2)
                pts.extend([tuple(p0), tuple(p1)])
        else:  # checkerboard patch
            rows, cols = rng.integers(3, 6, 2)
            cell = max(4, int(rng.uniform(min(h, w) / 16, min(h, w) / 8)))
            x0 = int(rng.integers(margin, max(margin + 1, w - cols * cell - margin)))
            y0 = int(rng.integers(margin, max(margin + 1, h - rows * cell - margin)))
            for r in range(rows):
                for c in range(cols):
                    if (r + c) % 2 == 0:
                        imgproc.rectangle(img, (x0 + c * cell, y0 + r * cell),
                                          (x0 + (c + 1) * cell, y0 + (r + 1) * cell), float(rng.uniform(0.6, 1.0)))
            for r in range(rows + 1):
                for c in range(cols + 1):
                    pts.append((x0 + c * cell, y0 + r * cell))
        pts_arr = np.asarray([p for p in pts if 0 <= p[0] < w and 0 <= p[1] < h], np.float32).reshape(-1, 2)
        xy, mask = pad_points(pts_arr, self.max_points)
        return {"image": img[..., None], "points": xy, "points_mask": mask}

    def batches(self, batch_size: int) -> Iterator[dict]:
        while True:
            samples = [self.sample() for _ in range(batch_size)]
            yield {k: np.stack([s[k] for s in samples]) for k in samples[0]}


DATASET_REGISTRY = {
    "ALLSS": ALLSSDataset,
    "SSHI": SSHIDataset,
    "synthetic_shapes": SyntheticShapesDataset,
}


def get_dataset(name: str, **kwargs):
    return DATASET_REGISTRY[name](**kwargs)
