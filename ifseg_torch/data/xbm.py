"""X11 bitmaps (XBM) decoded as PIL 12.1's ``XbmImagePlugin`` and its C
decoder (``XbmDecode.c``) decode them, with the standard library's ``re``
and numpy.

``decode_xbm_image(data)`` returns ``(pixels, "1", None)``:
``np.asarray(PIL.Image.open(BytesIO(data)))``, (h, w) bool.  The first 512
bytes must match PIL's header pattern (``#define ..._width``, ``_height``,
an optional hot spot, then ``_bits[]``); after it every ``x`` and the two
bytes after it are one byte of the image (a byte that is not a hex digit
counts 0), rows of (w + 7) // 8 bytes, the first pixel in the low bit, a
set bit white.  A file cut short keeps its whole rows, the others 0, as PIL
reads it under the JAX package's ``LOAD_TRUNCATED_IMAGES``.
"""

import re

import numpy as np

from ifseg_torch.data.png import check_pixels

_HEAD = re.compile(
    rb"\s*#define[ \t]+.*_width[ \t]+(?P<width>[0-9]+)[\r\n]+"
    rb"#define[ \t]+.*_height[ \t]+(?P<height>[0-9]+)[\r\n]+"
    rb"(?P<hotspot>"
    rb"#define[ \t]+[^_]*_x_hot[ \t]+(?P<xhot>[0-9]+)[\r\n]+"
    rb"#define[ \t]+[^_]*_y_hot[ \t]+(?P<yhot>[0-9]+)[\r\n]+"
    rb")?"
    rb"[\000-\377]*_bits\[]")
_BYTE = re.compile(rb"x(.)(.)", re.DOTALL)
# XbmDecode.c's HEX: the value of a hex digit, 0 for any other byte
_HEX = np.zeros(256, np.uint8)
for _i, _c in enumerate(b"0123456789abcdef"):
    _HEX[_c] = _i
    _HEX[bytes([_c]).upper()[0]] = _i


def xbm_header(data: bytes):
    """(width, height, offset of the bits) as PIL's ``_open`` reads them,
    None where its pattern does not match."""
    m = _HEAD.match(bytes(data[:512]))
    if not m:
        return None
    return int(m.group("width")), int(m.group("height")), m.end()


def is_xbm(data: bytes) -> bool:
    """PIL opens the file as XBM: its header and a size."""
    head = xbm_header(data)
    return head is not None and 0 not in head[:2]


def decode_xbm_image(data: bytes):
    """(pixels, "1", None) of an XBM file (see the module docstring)."""
    data = bytes(data)
    if not is_xbm(data):
        raise ValueError("not an XBM file PIL opens")
    width, height, start = xbm_header(data)
    check_pixels(width, height, "XBM")
    row_bytes = (width + 7) // 8
    digits = np.frombuffer(b"".join(m.group(1) + m.group(2) for m in
                                    _BYTE.finditer(data, start)), np.uint8).reshape(-1, 2)
    values = _HEX[digits[:, 0]] << 4 | _HEX[digits[:, 1]]
    whole = min(height, len(values) // row_bytes)
    rows = np.zeros((height, row_bytes), np.uint8)
    rows[:whole] = values[:whole * row_bytes].reshape(whole, row_bytes)
    bits = np.unpackbits(rows, axis=1, bitorder="little")[:, :width]
    return bits != 0, "1", None
