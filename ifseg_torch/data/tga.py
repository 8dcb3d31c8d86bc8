"""Targa (TGA) files decoded as PIL 12.1's ``TgaImagePlugin`` decodes them,
and an RGB image encoded as its ``save`` encodes it, with numpy and one host
C++ loop.

``decode_tga_image(data)`` returns ``(pixels, mode, palette)``:
``np.asarray(PIL.Image.open(BytesIO(data)))``, PIL's mode and, for mode "P",
the colour map as (n, 3) uint8 RGB ((n, 4) RGBA for a 16-bit map), its first
``start`` entries the zero bytes PIL puts there.  TGA has no signature: ``tga_header`` gives the
header only where PIL's ``_open`` takes it (a colour map type of 0 or 1, a
size above 0, a depth of 1, 8, 16, 24 or 32, an image type of 1-3 or 9-11, a
map depth of 16, 24 or 32).  Image types and depths:

  1, 9   8 bits   "P" with a colour map, "L" without
  2, 10  16 bits  "RGBA", 5-5-5 scaled by 255 / 31, the top bit a clear alpha
         24 bits  "RGB" from BGR;  32 bits  "RGBA" from BGRA
  3, 11  1 bit    "1";  8 bits  "L";  16 bits  "LA"

A colour map of 32-bit entries, or of more than 256 with its first index,
raises, as PIL's palette does.
Rows are bottom-up unless the descriptor's bit 5 is set, right to left where
bit 4 is.  Types 9-11 are run-length coded (``csrc/rle_decode.cpp``,
``tga_rle``; a literal packet runs on across rows, a run packet that
passes its row's end ends the image).  A cut file keeps its whole
rows, the others 0, as PIL reads it under the JAX package's
``LOAD_TRUNCATED_IMAGES``; a layout PIL opens but has no unpacker for
raises ``ValueError``, as PIL's load fails.

``encode_tga(arr)`` writes what ``Image.fromarray(arr).save(f, "TGA")``
writes for an (h, w, 3) uint8 RGB array: uncompressed BGR rows, bottom-up,
and the TGA 2.0 footer.
"""

import ctypes
import struct
from functools import lru_cache

import numpy as np

from ifseg_torch.data.png import check_pixels, unpack_bits
from ifseg_torch.ops import build

SOURCE = "rle_decode"
EXTENSIONS = (".tga", ".icb", ".vda", ".vst")
# (image type & 7, depth) -> PIL's raw mode
_RAW_MODES = {(1, 8): "P", (3, 1): "1", (3, 8): "L", (3, 16): "LA", (2, 16): "BGRA;15Z",
              (2, 24): "BGR", (2, 32): "BGRA"}
_MAP_BYTES = {16: 2, 24: 3, 32: 4}
_FOOTER = b"\0" * 8 + b"TRUEVISION-XFILE.\0"


@lru_cache(maxsize=None)
def _rle():
    fn = build.load(SOURCE).tga_rle
    fn.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
                   ctypes.c_int64, ctypes.c_int64]
    fn.restype = ctypes.c_int64
    return fn


def load():
    """Build (if need be) and load the RLE loops now, not at the first decode."""
    _rle()


def tga_header(data: bytes):
    """(mode, raw mode or None, width, height, depth, top-down, flip, RLE,
    palette (n, 3 or 4) or None, pixel offset) where PIL's ``_open`` takes
    the file as TGA, else None."""
    if len(data) < 18:
        return None
    id_len, map_type, kind = data[0], data[1], data[2]
    width, height = struct.unpack_from("<HH", data, 12)
    depth, flags = data[16], data[17]
    if map_type not in (0, 1) or width <= 0 or height <= 0 or depth not in (1, 8, 16, 24, 32):
        return None
    if kind in (3, 11):
        mode = {1: "1", 16: "LA"}.get(depth, "L")
    elif kind in (1, 9):
        mode = "P" if map_type else "L"
    elif kind in (2, 10):
        mode = "RGB" if depth == 24 else "RGBA"
    else:
        return None
    pos = 18 + id_len
    palette = None
    if map_type:
        start, size, map_depth = struct.unpack_from("<HHB", data, 3)
        if map_depth not in _MAP_BYTES:
            return None
        entry = _MAP_BYTES[map_depth]
        table = data[pos:pos + entry * size]
        pos += len(table)
        table = bytes(entry * start) + table  # PIL's padding before the first index
        count = len(table) // entry
        palette = _pixels(np.frombuffer(table[:count * entry], np.uint8).reshape(1, -1),
                          {2: "BGRA;15Z", 3: "BGR", 4: "BGRA"}[entry],
                          count)[0, :, :4 if entry == 2 else 3].copy()
    raw = _RAW_MODES.get((kind & 7, depth))
    return (mode, raw, width, height, depth, bool(flags & 0x20), flags & 0x30 in (0x10, 0x30),
            bool(kind & 8), palette, pos)


def _pixels(rows: np.ndarray, raw: str, width: int) -> np.ndarray:
    """(h, row bytes) uint8 rows as PIL's unpacker ``raw`` gives the pixels."""
    h = rows.shape[0]
    if raw == "1":
        return unpack_bits(rows, 1, width).astype(bool)
    if raw in ("P", "L"):
        return np.ascontiguousarray(rows[:, :width])
    if raw == "BGRA;15Z":
        v = rows[:, :2 * width].reshape(h, width, 2).astype(np.int32)
        v = v[:, :, 0] | v[:, :, 1] << 8
        out = np.empty((h, width, 4), np.uint8)
        for c, shift in enumerate((10, 5, 0)):
            out[:, :, c] = ((v >> shift) & 31) * 255 // 31
        out[:, :, 3] = np.where(v & 0x8000, 0, 255)
        return out
    n = {"LA": 2, "BGR": 3, "BGRA": 4}[raw]
    px = rows[:, :n * width].reshape(h, width, n)
    if raw == "LA":
        return px
    out = np.empty_like(px)
    out[:, :, :3] = px[:, :, 2::-1]
    out[:, :, 3:] = px[:, :, 3:]
    return out


def decode_tga_image(data: bytes):
    """(pixels, PIL's mode, palette or None) of a TGA file (see the module
    docstring)."""
    data = bytes(data)
    head = tga_header(data)
    if head is None:
        raise ValueError("not a TGA file")
    mode, raw, width, height, depth, top_down, flip, rle, palette, pos = head
    check_pixels(width, height, "TGA")
    if raw is None or (mode, raw) == ("L", "P"):
        raise ValueError(f"TGA image type {data[2]} at {depth} bits has no decoder in PIL")
    if palette is not None and (palette.shape[1] == 3 and data[7] == 32 or len(palette) > 256):
        raise ValueError("TGA colour map of 32-bit or more than 256 entries: PIL refuses it")
    stride = (width * depth + 7) // 8
    body = data[pos:]
    rows = np.zeros((height, stride), np.uint8)
    if rle:
        whole = _rle()(body, len(body), rows.ctypes.data, height, stride, depth // 8)
    else:
        whole = min(height, len(body) // stride)
        rows[:whole] = np.frombuffer(body, np.uint8, count=whole * stride).reshape(whole, stride)
    pixels = _pixels(rows, raw, width)
    pixels[whole:] = 0
    if not top_down:
        pixels = pixels[::-1]
    if flip:
        pixels = pixels[:, ::-1]
    pixels = np.ascontiguousarray(pixels)
    if mode == "P":
        return pixels, "P", palette
    return pixels, mode, None


def encode_tga(arr: np.ndarray) -> bytes:
    """The bytes of PIL's ``Image.fromarray(arr).save(buf, "TGA")`` for an
    (h, w, 3) uint8 RGB array."""
    if arr.dtype != np.uint8 or arr.ndim != 3 or arr.shape[2] != 3:
        raise ValueError(f"encode_tga takes (h, w, 3) uint8, not {arr.shape} {arr.dtype}")
    h, w = arr.shape[:2]
    head = struct.pack("<BBBHHBHHHHBB", 0, 0, 2, 0, 0, 0, 0, 0, w, h, 24, 0)
    return head + np.ascontiguousarray(arr[::-1, :, ::-1]).tobytes() + _FOOTER
