"""XV thumbnails decoded as PIL 12.1's ``XVThumbImagePlugin`` decodes them.

``decode_xvthumb_image(data)`` returns ``(pixels, "P", palette)``:
``np.asarray(PIL.Image.open(BytesIO(data)))`` and the fixed 3-3-2 palette
((256, 3) uint8: red ``r * 255 // 7``, green ``g * 255 // 7``, blue
``b * 255 // 3`` of index ``r << 5 | g << 2 | b``).  After the ``P7 332``
line and any lines that start with ``#``, the first other line holds the
width and height; raw rows of indices follow it.  A cut file keeps its
whole rows, the others 0, as PIL reads it under the JAX package's
``LOAD_TRUNCATED_IMAGES``.
"""

import numpy as np

from ifseg_torch.data.png import check_pixels, whole_rows

SIGNATURE = b"P7 332"
_R, _G, _B = np.meshgrid(np.arange(8), np.arange(8), np.arange(4), indexing="ij")
PALETTE = np.stack([_R * 255 // 7, _G * 255 // 7, _B * 255 // 3], -1).reshape(256, 3).astype(
    np.uint8)


def decode_xvthumb_image(data: bytes):
    """(pixels, "P", palette) of an XV thumbnail (see the module docstring)."""
    data = bytes(data)
    if not data.startswith(SIGNATURE):
        raise ValueError("not an XV thumbnail")
    end = data.find(b"\n", 6)
    pos = len(data) if end < 0 else end + 1
    while True:
        if pos >= len(data):
            raise ValueError("truncated XV thumbnail: no size line")
        end = data.find(b"\n", pos)
        line, pos = data[pos:len(data) if end < 0 else end + 1], len(data) if end < 0 else end + 1
        if line[0] != ord("#"):
            break
    try:
        width, height = (int(v) for v in line.strip().split(maxsplit=2)[:2])
    except ValueError:
        raise ValueError(f"XV thumbnail size line {line!r} is not two numbers") from None
    if width <= 0 or height <= 0:
        raise ValueError(f"XV thumbnail of {width} x {height} pixels")
    check_pixels(width, height, "XVThumb")
    return whole_rows(data[pos:], width, height, 1)[:, :, 0], "P", PALETTE
