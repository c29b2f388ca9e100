"""Text image format used by the reference's notebooks and unbuilt tests:
'W\\nH\\npixel pixel ...' grayscale (image/ImageInput.ipynb writes it,
fhe_image.h:155-189 read_image parses it, tests/dct.cpp consumes it).
The port's own copy of ``fhetpu/io/textimage.py``; only ``image_to_gray``
needs PIL, imported when it is called."""

from __future__ import annotations

import numpy as np


def write_text_image(path: str, gray: np.ndarray):
    h, w = gray.shape
    with open(path, "w") as f:
        f.write(f"{w}\n{h}\n")
        f.write(" ".join(str(float(v)) for v in gray.reshape(-1)))
        f.write("\n")


def read_text_image(path: str):
    """-> (image float64 [H, W], w, h); reference read_image semantics."""
    with open(path) as f:
        tokens = f.read().split()
    w, h = int(float(tokens[0])), int(float(tokens[1]))
    vals = np.array([float(t) for t in tokens[2 : 2 + w * h]], dtype=np.float64)
    return vals.reshape(h, w), w, h


def image_to_gray(rgb: np.ndarray, size=None) -> np.ndarray:
    """ImageInput.ipynb equivalent: resize + grayscale via PIL."""
    from PIL import Image

    im = Image.fromarray(rgb).convert("L")
    if size is not None:
        im = im.resize(size)
    return np.asarray(im, dtype=np.float64)
