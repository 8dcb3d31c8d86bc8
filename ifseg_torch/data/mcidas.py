"""McIdas area files decoded as PIL 12.1's ``McIdasImagePlugin`` decodes
them.

``decode_mcidas_image(data)`` returns ``(pixels, mode, None)``:
``np.asarray(PIL.Image.open(BytesIO(data)))`` and PIL's mode.  The 256-byte
area descriptor is 64 big-endian int32 words ``w[1..64]``: ``w[11]`` bytes a
sample pick "L" (1), "I;16B" (2, a big-endian uint16 array) or "I" (4, the
big-endian words as int32; ``McIdasImagePlugin.py:51-57``), ``w[10]`` x
``w[9]`` is the size, and the rows, each ``w[15] + w[10] * w[11] * w[14]``
bytes after the one before (the first ``w[10] * w[11]`` of them the
samples), start at ``w[34] + w[15]``.  A cut file keeps its whole rows,
the others 0, as PIL reads it under the JAX package's
``LOAD_TRUNCATED_IMAGES``; a stride shorter than a row leaves the image 0.
"""

import struct

import numpy as np

from ifseg_torch.data.png import check_pixels, strided_rows

SIGNATURE = b"\x00\x00\x00\x00\x00\x00\x00\x04"
_MODES = {1: ("L", np.uint8), 2: ("I;16B", ">u2"), 4: ("I", ">i4")}


def mcidas_header(data: bytes):
    """The descriptor's words (index 1 to 64) as PIL's ``_open`` reads them,
    None where it does not take the file."""
    if len(data) < 256 or not data.startswith(SIGNATURE):
        return None
    w = (0,) + struct.unpack_from(">64i", data)
    if w[11] not in _MODES or w[10] <= 0 or w[9] <= 0:
        return None
    return w


def decode_mcidas_image(data: bytes):
    """(pixels, PIL's mode, None) of a McIdas area file (see the module
    docstring)."""
    data = bytes(data)
    w = mcidas_header(data)
    if w is None:
        raise ValueError("not a McIdas area file PIL opens")
    width, height, size = w[10], w[9], w[11]
    check_pixels(width, height, "McIdas")
    offset, stride = w[34] + w[15], w[15] + width * size * w[14]
    if offset < 0:
        raise ValueError(f"McIdas data offset {offset} is before the file's start")
    rows = strided_rows(data[offset:], height, width * size, stride)[0]
    mode, dtype = _MODES[size]
    pixels = rows.view(dtype).reshape(height, width)
    return (pixels.astype(np.int32) if mode == "I" else pixels), mode, None
