"""Image ingest/output + 8x8 block utilities (SURVEY.md C7/C13 equivalents).

The port's own copy of ``fhetpu/io/images.py`` (tests hold the two equal).
PIL is imported only inside the functions that read or write image files:
the GPU machine has no PIL, and the block utilities need none.

Replaces the reference's stb_image loading (client_jpeg.cpp:76), OpenCV PNG
save (fhe_resize.h:100-117), and split_image_eight_block (fhe_image.h:108-124)
with PIL + vectorized numpy.  Like the reference, images are assumed to have
dimensions divisible by 8 for the JPEG path (no padding).
"""

from __future__ import annotations

import numpy as np


def load_rgb(path: str) -> np.ndarray:
    """uint8 [H, W, 3] (stbi_load(..., 3) equivalent)."""
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"), dtype=np.uint8)


def save_rgb(path: str, arr: np.ndarray):
    from PIL import Image

    Image.fromarray(arr.astype(np.uint8), mode="RGB").save(path)


def decode_jpeg_bytes(data: bytes) -> np.ndarray:
    import io as _io

    from PIL import Image

    return np.asarray(Image.open(_io.BytesIO(data)).convert("RGB"), dtype=np.uint8)


def split_blocks(channel: np.ndarray) -> np.ndarray:
    """[H, W] -> [nblocks, 64] in the reference's row-major block order
    (blocks scan left-to-right, top-to-bottom; within a block row-major)."""
    h, w = channel.shape
    assert h % 8 == 0 and w % 8 == 0, "image dims must be divisible by 8"
    return (
        channel.reshape(h // 8, 8, w // 8, 8)
        .transpose(0, 2, 1, 3)
        .reshape(-1, 64)
    )


def rms_error(a: np.ndarray, b: np.ndarray) -> float:
    """RMS over all interleaved samples (fhe_image.h:508-521 semantics)."""
    d = a.astype(np.int64) - b.astype(np.int64)
    return float(np.sqrt(np.mean(d.astype(np.float64) ** 2)))
