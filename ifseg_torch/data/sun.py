"""Sun raster files decoded as PIL 12.1's ``SunImagePlugin`` decodes them,
with numpy and one host C++ loop.

``decode_sun_image(data)`` returns ``(pixels, mode, palette)``:
``np.asarray(PIL.Image.open(BytesIO(data)))``, PIL's mode and, for "P", the
colour map ((n, 3) uint8, the file's planar red, green and blue thirds).
The 32-byte big-endian header's depth picks the layout
(``SunImagePlugin.py:71-103``): 1 bit "1" (a set bit black), 4 bits "L"
(each sample x 17), 8 bits "L", or "P" (4 or 8 bits, the sample an index)
where the file has a colour map, which may hold at most 1,024 bytes (PIL
raises on a map beside any other depth); 24
and 32 bits "RGB" from RGB or RGBX (type 3) or BGR or BGRX samples (the
other types).  Types 0, 1, 3, 4 and 5 are raw rows padded to 16 bits; type
2 is byte-encoded (``csrc/rle_decode.cpp``, ``sun_rle``: 0x80 0 a literal
0x80, 0x80 n v n + 1 bytes v, running on across rows, which are not padded
there, as in PIL).  A cut file keeps its whole rows, the others 0, as PIL
reads it under the JAX package's ``LOAD_TRUNCATED_IMAGES``.
"""

import ctypes
import struct
from functools import lru_cache

import numpy as np

from ifseg_torch.data.png import check_pixels, strided_rows, unpack_bits
from ifseg_torch.ops import build

SOURCE = "rle_decode"
SIGNATURE = b"\x59\xa6\x6a\x95"


@lru_cache(maxsize=None)
def _rle():
    fn = build.load(SOURCE).sun_rle
    fn.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
                   ctypes.c_int64]
    fn.restype = ctypes.c_int64
    return fn


def sun_header(data: bytes):
    """(width, height, depth, type, offset, colour map or None) as PIL's
    ``_open`` reads them, None where it does not take the file, ValueError
    where it raises."""
    if len(data) < 32 or data[:4] != SIGNATURE:
        return None
    width, height, depth, _, kind, map_type, map_length = struct.unpack_from(">7I", data, 4)
    if depth not in (1, 4, 8, 24, 32):
        return None
    colours = None
    if map_length:
        if map_length > 1024 or map_type != 1:
            return None
        table = data[32:32 + map_length]
        n = len(table) // 3
        colours = np.frombuffer(table, np.uint8, count=3 * n).reshape(3, n).T.copy()
    if kind not in (0, 1, 2, 3, 4, 5) or not width or not height:
        return None
    return width, height, depth, kind, 32 + map_length, colours


def decode_sun_image(data: bytes):
    """(pixels, PIL's mode, palette or None) of a Sun raster file (see the
    module docstring)."""
    data = bytes(data)
    head = sun_header(data)
    if head is None:
        raise ValueError("not a Sun raster file PIL opens")
    width, height, depth, kind, offset, colours = head
    check_pixels(width, height, "SUN")
    if colours is not None and depth not in (4, 8):
        raise ValueError(f"SUN colour map on a {depth}-bit image: PIL's load puts a palette "
                         f"on an image of no palette mode and raises")
    body = data[offset:]
    row_bytes = (width * depth + 7) // 8
    if kind == 2:
        rows = np.zeros((height, row_bytes), np.uint8)
        whole = _rle()(body, len(body), rows.ctypes.data, height, row_bytes)
    else:
        rows, whole = strided_rows(body, height, row_bytes, (width * depth + 15) // 16 * 2)
    if depth == 1:  # "1;I": a clear bit is white; the rows not decoded stay black
        pixels = unpack_bits(rows, 1, width) == 0
        pixels[whole:] = False
        return pixels, "1", None
    palette = depth <= 8 and colours is not None
    if depth == 4:
        samples = unpack_bits(rows, 4, width)
        return (samples, "P", colours) if palette else (samples * np.uint8(17), "L", None)
    if depth == 8:
        return (rows[:, :width], "P", colours) if palette else (rows[:, :width], "L", None)
    px = rows.reshape(height, width, depth // 8)[:, :, :3]
    return np.ascontiguousarray(px if kind == 3 else px[:, :, ::-1]), "RGB", None
