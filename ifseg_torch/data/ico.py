"""Windows icons (ICO) and cursors (CUR) decoded as PIL 12.1's
``IcoImagePlugin`` and ``CurImagePlugin`` decode them, with numpy.

``decode_ico_image(data)`` and ``decode_cur_image(data)`` return
``(pixels, mode, palette)``: ``np.asarray(PIL.Image.open(BytesIO(data)))``,
PIL's mode and, for a palette image, its palette ((n, 3) uint8 RGB).

An icon: the directory's entries (a width or height byte of 0 means 256;
the colour depth is the bit count, else ``ceil(log2(colours))``, else 256)
sorted by colour depth and then, stably, by area, largest first; entry 0 is
decoded.  A PNG entry is the PNG file from its offset on (``data/png.py``),
in its own mode (a palette's tRNS alpha is not kept: PIL's icon does not
carry it).  A bitmap entry (``data/bmp.py:decode_dib_image``) is its info
header and pixels with the height halved; then, as in PIL:

  - an entry whose directory bit count is 32 takes its alpha from every
    fourth byte of the pixels, rows bottom-up;
  - any other takes it from the AND mask, one bit a pixel, rows padded to 32
    bits and bottom-up, read from ``offset + size - mask bytes`` with the
    directory's offset and size; a set bit is transparent (alpha 0);

and the image becomes "RGBA" with that alpha.  A mask cut short (the JAX
package's ``LOAD_TRUNCATED_IMAGES``) gives no alpha: the bitmap in its own
mode.  A cut bitmap keeps its whole rows, as a BMP file does.

A cursor: the entry kept is the first, replaced by any later one strictly
wider and taller than it; its bitmap is read at its offset with the height
halved and no mask (a 32-bit entry at offset 22 reads as "RGBA", others with
the fourth byte dropped).

Whatever PIL refuses (no entry, a cut directory, a cut header) raises
``ValueError``.
"""

import math
import struct

import numpy as np

from ifseg_torch.data import bmp, png

ICO_SIGNATURE = b"\x00\x00\x01\x00"
CUR_SIGNATURE = b"\x00\x00\x02\x00"


def _directory(data: bytes):
    """[(width, height, colour depth, bit count, size, offset)] of an icon's
    entries in PIL's order."""
    count = struct.unpack_from("<H", data, 4)[0]
    if len(data) < 6 + 16 * count:
        raise ValueError("truncated ICO: the directory is cut off")
    entries = []
    for i in range(count):
        s = data[6 + 16 * i:22 + 16 * i]
        width, height, colours = s[0] or 256, s[1] or 256, s[2]
        bits, size, offset = struct.unpack_from("<HII", s, 6)
        depth = bits or (colours != 0 and math.ceil(math.log(colours, 2))) or 256
        entries.append((width, height, depth, bits, size, offset))
    if not entries:
        raise ValueError("broken ICO: the directory has no entry")
    entries.sort(key=lambda e: e[2])
    entries.sort(key=lambda e: e[0] * e[1], reverse=True)
    return entries


def _mask(data: bytes, at: int, count: int, rows: int, row_bytes: int, need: int):
    """(rows, row_bytes) uint8 of ``data[at:at + count]`` bottom-up, or None
    where the bytes are fewer than ``need``, what PIL's reader of the mask
    needs (the last row of a padded one without its padding)."""
    if at < 0:
        raise ValueError("broken ICO: the AND mask starts before the file")
    body = data[at:at + count]
    if len(body) < need:
        return None
    body = body[:rows * row_bytes].ljust(rows * row_bytes, b"\0")
    return np.frombuffer(body, np.uint8).reshape(rows, row_bytes)[::-1]


def decode_ico_image(data: bytes):
    """(pixels, PIL's mode, palette or None) of an ICO file (see the module
    docstring)."""
    data = bytes(data)
    if data[:4] != ICO_SIGNATURE or len(data) < 6:
        raise ValueError("not an ICO file")
    _, _, _, bits, size, offset = _directory(data)[0]
    if data[offset:offset + 8] == png.SIGNATURE:
        pixels, mode, palette = png.decode_png_image(data[offset:])
        png.check_pixels(pixels.shape[1], pixels.shape[0], "ICO")
        return pixels, mode, None if palette is None else np.ascontiguousarray(palette[:, :3])
    pixels, mode, palette, at = bmp.decode_dib_image(data, offset)
    h, w = pixels.shape[:2]
    if bits == 32:
        alpha = _mask(data[at:at + w * h * 4][3::4], 0, w * h, h, w, w * h)
    else:
        padded = (w + 31) // 32 * 32
        count = padded * h // 8
        need = (h - 1) * padded // 8 + (w + 7) // 8 if h else 0
        mask = _mask(data, offset + size - count, count, h, padded // 8, need)
        alpha = None if mask is None else np.where(png.unpack_bits(mask, 1, w) != 0, 0, 255)
    if alpha is None:
        return pixels, mode, palette
    rgba = np.empty((h, w, 4), np.uint8)
    rgba[:, :, :3] = png.to_rgb(pixels, palette, mode)
    rgba[:, :, 3] = alpha
    return rgba, "RGBA", None


def decode_cur_image(data: bytes):
    """(pixels, PIL's mode, palette or None) of a CUR file (see the module
    docstring)."""
    data = bytes(data)
    if data[:4] != CUR_SIGNATURE or len(data) < 6:
        raise ValueError("not a CUR file")
    count = struct.unpack_from("<H", data, 4)[0]
    pos, kept = 6, b""
    for _ in range(count):
        s = data[pos:pos + 16]
        pos += len(s)
        if not kept:
            kept = s
            continue
        # PIL's test, ``s[0] > m[0] and s[1] > m[1]``, where a cut entry fails
        if not s or (s[0] > kept[0] and min(len(s), len(kept)) < 2):
            raise ValueError("truncated CUR: the directory is cut off")
        if s[0] > kept[0] and s[1] > kept[1]:
            kept = s
    if not kept:
        raise ValueError("broken CUR: no cursor in the directory")
    if len(kept) < 16:
        raise ValueError("truncated CUR: the directory is cut off")
    header = struct.unpack_from("<I", kept, 12)[0]
    pixels, mode, palette, _ = bmp.decode_dib_image(data, header or pos, header, cursor=True)
    return pixels, mode, palette
