"""The repository's threaded C++ image loader as a Python class — the
counterpart of `image_matching_tpu/data/native_loader.py`: `decode_image`,
`NativeImageLoader` and `native_available`.

The library (`native_imloader.py` binds and builds it) is a thread pool
that decodes PNG or JPEG files and fills a bounded prefetch queue that
Python drains a batch at a time.
"""
from __future__ import annotations

import ctypes
from typing import Iterator, List, Sequence, Tuple

import numpy as np

from image_matching_tpu_torch.native_imloader import float_ptr, decode_image, load_library, native_available


class NativeImageLoader:
    """Threaded prefetching loader over a list of image files.

    `next_batch(n)` returns (images (n, H, W, 1) float32, indices (n,)
    int32) in the order the workers finish (with `n_threads > 1` that
    order depends on their timing); a file that does not decode gives zeros
    and the index -(i + 1). `loop=True` reshuffles forever (training),
    `loop=False` drains the files once; the first order is a `mt19937`
    shuffle from `seed`."""

    def __init__(self, paths: Sequence[str], height: int, width: int, n_threads: int = 4,
                 queue_capacity: int = 32, loop: bool = True, seed: int = 0):
        if not paths:
            raise ValueError("NativeImageLoader: no image files")
        self._lib = load_library()
        self._paths: List[str] = [str(p) for p in paths]
        arr = (ctypes.c_char_p * len(self._paths))(*[p.encode() for p in self._paths])
        self.height, self.width = height, width
        self._handle = self._lib.iml_create(arr, len(self._paths), height, width, n_threads, queue_capacity,
                                            int(loop), seed)
        if not self._handle:
            raise RuntimeError("iml_create failed")

    def next_batch(self, batch_size: int) -> Tuple[np.ndarray, np.ndarray]:
        images = np.empty((batch_size, self.height, self.width), np.float32)
        indices = np.empty((batch_size,), np.int32)
        n = self._lib.iml_next_batch(self._handle, float_ptr(images),
                                     indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), batch_size)
        return images[:n][..., None], indices[:n]

    def batches(self, batch_size: int) -> Iterator[dict]:
        """{"image", "indices"} batches until the files are drained (the last
        one may be short; with `loop=True`, never)."""
        while True:
            images, idx = self.next_batch(batch_size)
            if len(images) == 0:
                return
            yield {"image": images, "indices": idx}

    def close(self) -> None:
        if getattr(self, "_handle", None):
            self._lib.iml_destroy(self._handle)
            self._handle = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass


__all__ = ["NativeImageLoader", "decode_image", "native_available"]
