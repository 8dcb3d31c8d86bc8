"""GIMP brushes (GBR) decoded as PIL 12.1's ``GbrImagePlugin`` decodes them.

``decode_gbr_image(data)`` returns ``(pixels, mode, None)``:
``np.asarray(PIL.Image.open(BytesIO(data)))`` and PIL's mode.  The
big-endian header (its size, at least 20; version 1 or 2; width; height;
bytes a pixel, 1 for "L" or 4 for "RGBA"; version 2: ``GIMP`` and the
spacing) and a comment fill ``header size`` bytes, and the pixels follow
raw.  PIL reads them with ``frombytes``, so a file with too few pixel bytes
raises whatever ``LOAD_TRUNCATED_IMAGES`` says, and so does this.
"""

import struct

import numpy as np

from ifseg_torch.data.png import check_pixels


def gbr_header(data: bytes):
    """(width, height, bytes a pixel, offset of the pixels) as PIL's
    ``_open`` reads them, None where it does not take the file (the next
    format may)."""
    if len(data) < 20:
        return None
    size, version, width, height, depth = struct.unpack_from(">5I", data)
    if size < 20 or version not in (1, 2) or not width or not height or depth not in (1, 4):
        return None
    if version == 2 and (len(data) < 28 or data[20:24] != b"GIMP"):
        return None
    start = 20 if version == 1 else 28
    # a negative comment length reads the rest of the file, leaving no pixels
    return width, height, depth, size if size >= start else len(data)


def decode_gbr_image(data: bytes):
    """(pixels, PIL's mode, None) of a GBR file (see the module docstring)."""
    data = bytes(data)
    head = gbr_header(data)
    if head is None:
        raise ValueError("not a GIMP brush PIL opens")
    width, height, depth, offset = head
    check_pixels(width, height, "GBR")
    need = width * height * depth
    if len(data) - offset < need:
        raise ValueError("truncated GBR: too few pixel bytes")
    pixels = np.frombuffer(data, np.uint8, count=need, offset=offset).copy()
    if depth == 1:
        return pixels.reshape(height, width), "L", None
    return pixels.reshape(height, width, 4), "RGBA", None
