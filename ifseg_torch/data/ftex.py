"""FTEX textures (Independence War 2's ``.ftc`` / ``.ftu``) decoded as PIL
12.1's ``FtexImagePlugin`` decodes them.

``decode_ftex_image(data)`` returns ``(pixels, mode, None)``:
``np.asarray(PIL.Image.open(BytesIO(data)))`` and PIL's mode.  The header
(little-endian: magic, version, width, height, mipmap count, format count,
which must be 1, then the format and the offset of its first mipmap) names
one mipmap of ``size`` bytes at that offset: format 0 is DXT1, "RGBA", its
4 x 4 blocks decoded by ``csrc/rle_decode.cpp``'s ``bcn`` as DDS's BC1;
format 1 is raw RGB rows, "RGB".  A cut mipmap keeps its whole blocks or
rows, the rest 0, as PIL reads it under the JAX package's
``LOAD_TRUNCATED_IMAGES``.
"""

import struct

import numpy as np

from ifseg_torch.data import dds
from ifseg_torch.data.png import check_pixels, whole_rows

SIGNATURE = b"FTEX"


def decode_ftex_image(data: bytes):
    """(pixels, PIL's mode, None) of an FTEX file (see the module docstring)."""
    data = bytes(data)
    if data[:4] != SIGNATURE or len(data) < 32:
        raise ValueError("not an FTEX file, or its header is cut off")
    width, height, _, formats, kind, where = struct.unpack_from("<6i", data, 8)
    if formats != 1:
        raise ValueError(f"FTEX file of {formats} formats (PIL reads one)")
    if width <= 0 or height <= 0:
        raise ValueError(f"FTEX image of {width} x {height} pixels")
    check_pixels(width, height, "FTEX")
    if where < 0 or len(data) < where + 4:
        raise ValueError("truncated FTEX: the mipmap's size is cut off")
    size = struct.unpack_from("<i", data, where)[0]
    body = data[where + 4:] if size < 0 else data[where + 4:where + 4 + size]
    if kind == 1:
        return whole_rows(body, width, height, 3), "RGB", None
    if kind != 0:
        raise ValueError(f"FTEX texture format {kind} is not one PIL reads")
    rgba = np.zeros((height, width, 4), np.uint8)
    dds._bcn()(body, len(body), rgba.ctypes.data, width, height, 1)
    return rgba, "RGBA", None
