"""Write the seeded image files of `tests/data/images/` with OpenCV, each
beside `<stem>.npy`, the uint8 pixels `cv2.imread(path, IMREAD_GRAYSCALE)`
gives: baseline and progressive JPEG (gray and colour, 240x320), a 24-bit
BMP and a Deflate TIFF (colour, 96x128). `chip_smoke.py` decodes them on
the card's machine, which has no OpenCV to write them.

    python scripts/make_test_images.py [out_dir]
"""
import sys
from pathlib import Path

import cv2
import numpy as np


def textured(seed: int, h: int, w: int, colour: bool) -> np.ndarray:
    """A seeded uint8 image with structure at several scales."""
    rng = np.random.default_rng(seed)
    chans = [sum(cv2.resize(rng.uniform(0, 1, (h // s, w // s)).astype(np.float32), (w, h),
                            interpolation=cv2.INTER_CUBIC) * (s / 8) for s in (2, 4, 8, 16))
             for _ in range(3 if colour else 1)]
    img = np.stack(chans, -1) if colour else chans[0]
    img = (img - img.min()) / (img.max() - img.min())
    return np.clip(img * 255, 0, 255).astype(np.uint8)


FILES = {  # stem.ext: (seed, colour, height, width, cv2.imwrite parameters)
    "baseline_gray.jpg": (1, False, 240, 320, [cv2.IMWRITE_JPEG_QUALITY, 90]),
    "baseline_colour.jpg": (2, True, 240, 320, [cv2.IMWRITE_JPEG_QUALITY, 90]),
    "progressive_gray.jpg": (3, False, 240, 320, [cv2.IMWRITE_JPEG_QUALITY, 90, cv2.IMWRITE_JPEG_PROGRESSIVE, 1]),
    "progressive_colour.jpg": (4, True, 240, 320, [cv2.IMWRITE_JPEG_QUALITY, 90, cv2.IMWRITE_JPEG_PROGRESSIVE, 1]),
    "colour_24bit.bmp": (5, True, 96, 128, []),
    "deflate_rgb.tif": (6, True, 96, 128, [cv2.IMWRITE_TIFF_COMPRESSION, 8]),
}


def main(out=Path(__file__).resolve().parents[1] / "tests" / "data" / "images"):
    out = Path(out)
    out.mkdir(parents=True, exist_ok=True)
    for name, (seed, colour, h, w, params) in FILES.items():
        path = out / name
        assert cv2.imwrite(str(path), textured(seed, h, w, colour), params)
        np.save(out / f"{path.stem}.npy", cv2.imread(str(path), cv2.IMREAD_GRAYSCALE))
        print(path, path.stat().st_size, "bytes")


if __name__ == "__main__":
    main(*sys.argv[1:])
