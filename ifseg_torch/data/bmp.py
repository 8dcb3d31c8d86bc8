"""BMP decoding and encoding equal to PIL's, with numpy and one host C++ loop.

``decode_bmp_image(data)`` returns ``(pixels, mode, palette)`` as PIL 12.1's
``BmpImagePlugin`` gives them: ``np.asarray(PIL.Image.open(BytesIO(data)))``,
PIL's mode name and, for mode "P", the palette as (n, 3) uint8 RGB (n the
header's colour count, else 2 ** bits).  Headers: core (12 bytes), info
(40), V2/V3 (52, 56), OS/2 v2 (64), V4 (108) and V5 (124); depths 1, 4, 8,
16, 24 and 32; ``BI_RGB``, ``BI_BITFIELDS`` (the masks PIL takes) and RLE8 /
RLE4; rows bottom-up, or top-down where the height is negative.  The modes:

  1, 4, 8 bits   "P" (indices), or "1" / "L" where the palette is black and
                 white / the gray ramp 0, 1, 2, ..., which PIL drops
  16 bits        "RGB" from 5-5-5 (or 5-6-5 bitfields), each field scaled
                 by 255 / 31 (63) with the division rounding down
  24 bits        "RGB"
  32 bits        "RGB" (the fourth byte dropped), or "RGBA" for bitfields
                 with an alpha mask

A cut file keeps the whole rows read before the cut (the others 0), as PIL
reads it under the JAX package's ``ImageFile.LOAD_TRUNCATED_IMAGES``; a cut
or short RLE stream raises, as PIL's RLE decoder does ("not enough image
data"), and so do a cut header and what PIL refuses (other depths, JPEG or
PNG compression, other bitfield layouts).  The RLE streams are decoded by
``csrc/bmp_rle.cpp``, built with the host C++ compiler at the first decode
(``ops/build.py``; a failed build raises).  ``encode_bmp(arr)`` writes the
bytes of PIL's ``save`` for an (h, w, 3) uint8 RGB array (``header=False``:
its DIB save, the same without the file header).  ``decode_dib_file`` reads
such a DIB file, as PIL's ``DibImageFile`` does.
"""

import ctypes
import struct
from functools import lru_cache

import numpy as np

from ifseg_torch.data.png import check_pixels, unpack_bits, words16
from ifseg_torch.ops import build

SOURCE = "bmp_rle"
SIGNATURE = b"BM"
_HEADERS = (12, 40, 52, 56, 64, 108, 124)
_RAW, _RLE8, _RLE4, _BITFIELDS = 0, 1, 2, 3
# PIL's bitfield layouts: (bits, masks) -> raw mode
_MASK_MODES = {
    (32, (0xFF0000, 0xFF00, 0xFF, 0x0)): "BGRX",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0x0)): "XBGR",
    (32, (0xFF000000, 0xFF00, 0xFF, 0x0)): "BGXR",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0xFF)): "ABGR",
    (32, (0xFF, 0xFF00, 0xFF0000, 0xFF000000)): "RGBA",
    (32, (0xFF0000, 0xFF00, 0xFF, 0xFF000000)): "BGRA",
    (32, (0xFF000000, 0xFF00, 0xFF, 0xFF0000)): "BGAR",
    (32, (0x0, 0x0, 0x0, 0x0)): "BGRA",
    (24, (0xFF0000, 0xFF00, 0xFF)): "BGR",
    (16, (0xF800, 0x7E0, 0x1F)): "BGR;16",
    (16, (0x7C00, 0x3E0, 0x1F)): "BGR;15",
}
# raw mode -> (bits a pixel, the bytes' order of R, G, B[, A]) for the byte modes
_BYTE_MODES = {"BGR": (24, (2, 1, 0)), "BGRX": (32, (2, 1, 0)), "XBGR": (32, (3, 2, 1)),
               "BGXR": (32, (3, 1, 0)), "ABGR": (32, (3, 2, 1, 0)), "RGBA": (32, (0, 1, 2, 3)),
               "BGRA": (32, (2, 1, 0, 3)), "BGAR": (32, (3, 1, 0, 2))}
_DEFAULT_MODES = {1: ("P", "P;1"), 4: ("P", "P;4"), 8: ("P", "P"), 16: ("RGB", "BGR;15"),
                  24: ("RGB", "BGR"), 32: ("RGB", "BGRX")}
# the bits a pixel each raw mode unpacks
_RAW_BITS = {"1": 1, "L": 8, "P;1": 1, "P;4": 4, "P": 8, "BGR;15": 16, "BGR;16": 16,
             **{m: b for m, (b, _) in _BYTE_MODES.items()}}


def _u32(b: bytes, at: int) -> int:
    return struct.unpack_from("<I", b, at)[0]


def _header(data: bytes):
    """(mode, raw mode, width, height, bits, top-down, compression, palette
    bytes or None, palette entry size, pixel data offset), as PIL's
    ``_bitmap`` reads them."""
    if len(data) < 18:
        raise ValueError("truncated BMP: the file header is cut off")
    return _info(data, 14, _u32(data, 10))


def _info(data: bytes, at: int, offset: int, header: int = 0):
    """``_header``'s tuple from the info header at ``at``: a BMP file's at 14
    with the file header's pixel ``offset``; a bare bitmap's (an icon's or a
    cursor's entry) with offset 0, its pixels after its palette.  ``header``
    is PIL's argument of that name: a cursor's entry at 22 reads 32-bit pixels
    with their alpha."""
    if len(data) < at + 4:
        raise ValueError("truncated BMP: the info header is cut off")
    size = _u32(data, at)
    if size not in _HEADERS:
        raise ValueError(f"BMP header size {size} is not one PIL reads")
    head = data[at + 4:at + size]
    if len(head) < size - 4:
        raise ValueError("truncated BMP: the info header is cut off")
    pos = at + size
    if size == 12:
        width, height, _, bits = struct.unpack_from("<HHHH", head)
        compression, colors, pad, top_down = _RAW, 0, 3, False
    else:
        top_down = head[7] == 0xFF
        width = _u32(head, 0)
        height = 2 ** 32 - _u32(head, 4) if top_down else _u32(head, 4)
        bits = struct.unpack_from("<H", head, 10)[0]
        compression = _u32(head, 12)
        colors = _u32(head, 28)
        pad = 4
    if width <= 0 or height <= 0:  # PIL's ImageFile identifies no such image
        raise ValueError(f"broken BMP: size {width} x {height}")
    colors = colors or (1 << bits)
    if offset == 14 + size and bits <= 8:
        offset += 4 * colors
    if bits not in _DEFAULT_MODES:
        raise ValueError(f"BMP pixel depth {bits} is not one PIL reads (1, 4, 8, 16, 24, 32)")
    mode, raw = _DEFAULT_MODES[bits]
    if compression == _BITFIELDS:
        if len(head) >= 48:
            masks = struct.unpack_from("<IIII" if len(head) >= 52 else "<III", head, 36)
        else:
            if len(data) < pos + 12:
                raise ValueError("truncated BMP: the bitfield masks are cut off")
            masks = struct.unpack_from("<III", data, pos)
            pos += 12
        masks = tuple(masks) + (0,) * (4 - len(masks))
        key = (bits, masks if bits == 32 else masks[:3])
        if key not in _MASK_MODES:
            raise ValueError(f"BMP bitfields {tuple(hex(m) for m in key[1])} at {bits} bits "
                             f"are not a layout PIL reads")
        raw = _MASK_MODES[key]
        if bits == 32 and "A" in raw:
            mode = "RGBA"
    elif compression == _RAW and bits == 32 and header == 22:
        mode, raw = "RGBA", "BGRA"
    elif compression not in (_RAW, _RLE8, _RLE4):
        name = {4: "JPEG", 5: "PNG"}.get(compression, str(compression))
        raise ValueError(f"BMP compression {name} is not supported (PIL reads RGB, bitfields, "
                         f"RLE8 and RLE4)")
    palette = None
    if mode == "P":
        if not 0 < colors <= 65536:
            raise ValueError(f"BMP palette size {colors} is not one PIL reads")
        palette = data[pos:pos + pad * colors]
        pos += len(palette)
        ramp = (0, 255) if colors == 2 else range(colors)
        if all(palette[i * pad:i * pad + 3] == bytes([v]) * 3 for i, v in enumerate(ramp)):
            mode = raw = "1" if colors == 2 else "L"
            palette = None
    # an offset of 0: the pixels follow what was read
    return mode, raw, width, height, bits, top_down, compression, palette, pad, offset or pos


@lru_cache(maxsize=None)
def _rle_decoder():
    fn = build.load(SOURCE).bmp_rle
    fn.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
    fn.restype = ctypes.c_int64
    return fn


def load():
    """Build (if need be) and load the RLE decoder now, not at the first decode."""
    _rle_decoder()


def _unpack(rows: np.ndarray, raw: str, width: int) -> np.ndarray:
    """(h, row bytes) uint8 rows as PIL's unpacker ``raw`` gives the pixels."""
    h = rows.shape[0]
    if raw in ("1", "P;1", "P;4"):
        samples = unpack_bits(rows, 4 if raw == "P;4" else 1, width)
        return samples.astype(bool) if raw == "1" else samples
    if raw in ("L", "P"):
        return np.ascontiguousarray(rows[:, :width])
    if raw in ("BGR;15", "BGR;16"):
        v = words16(rows, width, "<u2").astype(np.int32)
        if raw == "BGR;15":
            rgb = ((v >> 10) & 31) * 255 // 31, ((v >> 5) & 31) * 255 // 31, (v & 31) * 255 // 31
        else:
            rgb = ((v >> 11) & 31) * 255 // 31, ((v >> 5) & 63) * 255 // 63, (v & 31) * 255 // 31
        return np.stack(rgb, axis=2).astype(np.uint8)
    bits, order = _BYTE_MODES[raw]
    px = rows[:, :width * bits // 8].reshape(h, width, bits // 8)
    return np.ascontiguousarray(px[:, :, list(order)])


def _rle(data: bytes, pos: int, width: int, height: int, rle4: bool) -> np.ndarray:
    """PIL's ``BmpRleDecoder`` (``csrc/bmp_rle.cpp``): the (height, width)
    indices in file order."""
    out = np.zeros((height, width), np.uint8)
    got = _rle_decoder()(data, len(data), pos, width, height, int(rle4), out.ctypes.data)
    if got < 0:
        raise ValueError("truncated BMP: an RLE delta is cut off")
    if got < width * height:
        raise ValueError("broken BMP: not enough image data in the RLE stream")
    return out


def decode_bmp_image(data: bytes):
    """(pixels, PIL's mode, palette or None) of a BMP file (see the module
    docstring)."""
    data = bytes(data)
    if data[:2] != SIGNATURE:
        raise ValueError("not a BMP file")
    return _decode(data, _header(data))


def is_dib(data: bytes) -> bool:
    """PIL's ``_dib_accept``: the file starts with an info header's size."""
    return len(data) >= 4 and _u32(data, 0) in _HEADERS


def decode_dib_file(data: bytes):
    """(pixels, PIL's mode, palette or None) of a DIB file: a bitmap without
    the 14-byte file header, its pixels right after its palette."""
    data = bytes(data)
    return _decode(data, _info(data, 0, 0))


def decode_dib_image(data: bytes, at: int, header: int = 0, cursor: bool = False):
    """(pixels, PIL's mode, palette or None, pixel data offset) of the bare
    bitmap whose info header starts at ``at``, as PIL reads an icon's or a
    cursor's entry: the height halved (the second half is the entry's AND
    mask), the pixels right after the palette.  PIL checks an icon's size
    before the halving and a cursor's (``cursor``) after it."""
    data = bytes(data)
    info = _info(data, at, 0, header)
    info = info[:3] + (info[3] // 2,) + info[4:]
    if cursor and not info[3]:  # a cursor's own size, after the halving, is checked
        raise ValueError("broken CUR: a bitmap one row high")
    check_pixels(info[2], info[3] * (1 if cursor else 2), "BMP")
    return _decode(data, info) + (info[-1],)


def _decode(data: bytes, info):
    mode, raw, width, height, depth, top_down, compression, palette, pad, offset = info
    if compression in (_RLE8, _RLE4):
        if mode == "1":
            raise ValueError("broken BMP: an RLE bitmap with a black-and-white palette")
        pixels = _rle(data, offset, width, height, compression == _RLE4)
    else:
        bits = _RAW_BITS[raw]
        row = (width * bits + 7) // 8
        stride = ((width * depth + 31) >> 3) & ~3
        channels = {"RGB": 3, "RGBA": 4}.get(mode)
        dtype = bool if mode == "1" else np.uint8
        pixels = np.zeros((height, width, channels) if channels else (height, width), dtype)
        if stride >= row and height and width:
            body = data[offset:] if offset < len(data) else b""
            # the whole rows read (the last one needs no padding)
            whole = min(height, (len(body) + stride - row) // stride)
            if whole > 0:
                buf = np.frombuffer(body[:whole * stride].ljust(whole * stride, b"\0"), np.uint8)
                rows = _unpack(buf.reshape(whole, stride), raw, width)
                pixels[:whole] = rows
    if not top_down:
        pixels = pixels[::-1]
    pixels = np.ascontiguousarray(pixels)
    if palette is not None:
        table = np.frombuffer(palette[:len(palette) // pad * pad], np.uint8).reshape(-1, pad)
        return pixels, "P", np.ascontiguousarray(table[:, 2::-1])
    return pixels, mode, None


def encode_bmp(arr: np.ndarray, header: bool = True) -> bytes:
    """The bytes of PIL's ``Image.fromarray(arr).save(buf, "BMP")`` for an
    (h, w, 3) uint8 RGB array: an info header, 24 bits, bottom-up rows; with
    ``header=False`` those of its "DIB" save, without the file header."""
    if arr.dtype != np.uint8 or arr.ndim != 3 or arr.shape[2] != 3:
        raise ValueError(f"encode_bmp takes (h, w, 3) uint8, not {arr.shape} {arr.dtype}")
    h, w = arr.shape[:2]
    stride = (w * 3 + 3) & ~3
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :3 * w] = arr[::-1, :, ::-1].reshape(h, 3 * w)
    image = stride * h
    ppm = int(96 * 39.3701 + 0.5)
    offset = 14 + 40
    info = struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, image, ppm, ppm, 0, 0)
    if not header:
        return info + rows.tobytes()
    return SIGNATURE + struct.pack("<III", offset + image, 0, offset) + info + rows.tobytes()
