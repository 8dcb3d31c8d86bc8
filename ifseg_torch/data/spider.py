"""SPIDER images decoded as PIL 12.1's ``SpiderImagePlugin`` decodes them.

``decode_spider_image(data)`` returns ``(pixels, "F", None)``:
``np.asarray(PIL.Image.open(BytesIO(data)))``, (h, w) float32.  The header
is 27 float32 words ``h[1..27]``, read big-endian first and little-endian
where that is no SPIDER header (PIL's byte-order test): ``h[1]``, ``h[2]``,
``h[5]``, ``h[12]``, ``h[13]``, ``h[22]`` and ``h[23]`` whole numbers,
``h[5]`` (the form) one of 1, 3, -11, -12, -21, -22 and the header's bytes
``h[22]`` equal to ``h[13] * h[23]``.  PIL opens form 1 only, a 2D image of
``h[12]`` x ``h[2]`` float32 pixels in the header's byte order at
``h[22]`` (the first image of a stack, ``h[24] > 0``, at twice that).  A
cut file keeps its whole rows, the others 0, as PIL reads it under the JAX
package's ``LOAD_TRUNCATED_IMAGES``.
"""

import math
import struct

import numpy as np

from ifseg_torch.data.png import check_pixels, whole_rows

_FORMS = (1, 3, -11, -12, -21, -22)


def _is_int(f: float) -> bool:
    return math.isfinite(f) and f == int(f)


def _header_bytes(t) -> int:
    """``isSpiderHeader``: the header's bytes, 0 where it is none."""
    h = (99,) + t
    if not all(_is_int(h[i]) for i in (1, 2, 5, 12, 13, 22, 23)):
        return 0
    if int(h[5]) not in _FORMS:
        return 0
    labbyt = int(h[22])
    return labbyt if labbyt == int(h[13]) * int(h[23]) else 0


def spider_header(data: bytes):
    """(width, height, byte order, offset of the pixels) as PIL's ``_open``
    reads them, None where it does not take the file (the next format may);
    ValueError where it raises."""
    if len(data) < 108:
        return None
    for order in (">", "<"):
        t = struct.unpack_from(f"{order}27f", data)
        length = _header_bytes(t)
        if length:
            break
    else:
        return None
    h = (99,) + t
    if int(h[5]) != 1:
        return None
    width, height = int(h[12]), int(h[2])
    try:
        stack, number = int(h[24]), int(h[27])
    except (ValueError, OverflowError):
        raise ValueError("SPIDER stack fields are not numbers") from None
    if stack == 0 and number == 0:
        offset = length
    elif stack > 0 and number == 0:
        offset = 2 * length
    elif stack == 0 and number > 0:
        raise ValueError("SPIDER image of a stack opened alone (PIL fails on it too)")
    else:
        return None
    if width <= 0 or height <= 0:
        return None
    return width, height, order, offset


def decode_spider_image(data: bytes):
    """(pixels, "F", None) of a SPIDER file (see the module docstring)."""
    data = bytes(data)
    head = spider_header(data)
    if head is None:
        raise ValueError("not a SPIDER image PIL opens")
    width, height, order, offset = head
    check_pixels(width, height, "SPIDER")
    if offset < 0:
        raise ValueError(f"SPIDER data offset {offset} is before the file's start")
    rows = whole_rows(data[offset:], width, height, 4)
    return rows.view(f"{order}f4").reshape(height, width).astype(np.float32), "F", None
