"""FITS files decoded as PIL 12.1's ``FitsImagePlugin`` decodes them, with
numpy and the standard library's ``gzip``.

``decode_fits_image(data)`` returns ``(pixels, mode, None)``:
``np.asarray(PIL.Image.open(BytesIO(data)))`` and PIL's mode.  The 80-byte
cards are read as PIL's ``_open`` reads them: the first must be ``SIMPLE =
T``; every header's keys go into one table, each header's ``END`` moves to
the next 2,880-byte block, and the first header with an image (NAXIS > 0;
NAXIS 1 is 1 wide) names it.  BITPIX picks the mode, and PIL reads the
samples in the mode's own little-endian raw layout, not FITS's big-endian
one: 8 "L", 16 "I;16" (uint16), 32 "I" (int32), -32 and -64 "F" (float32,
4 bytes a sample either way); the rows are stored bottom-up.  A
``BINTABLE`` extension with ``ZIMAGE = T`` and ``ZCMPTYPE = 'GZIP_1'`` is
PIL's ``fits_gzip`` decoder: everything after the table is one gzip stream
(``gzip.decompress``, which PIL calls), each sample the low ZBITPIX / 8
bytes (at most 4) of a 4-byte word, read in the mode's layout, the rows in
reverse order; ZBITPIX -32 and -64 give no samples and raise, as in PIL.
A cut raw file keeps its whole rows (the bottom ones), the others 0, as
PIL reads it under the JAX package's ``LOAD_TRUNCATED_IMAGES``; a cut gzip
stream raises.
"""

import gzip
import math
import zlib

import numpy as np

from ifseg_torch.data.png import check_pixels, whole_rows

SIGNATURE = b"SIMPLE"
# BITPIX -> (PIL's mode, the raw layout it reads)
_MODES = {8: ("L", "u1"), 16: ("I;16", "<u2"), 32: ("I", "<i4"), -32: ("F", "<f4"),
          -64: ("F", "<f4")}


def _size(headers, prefix: bytes):
    naxis = int(headers[prefix + b"NAXIS"])
    if naxis == 0:
        return None
    if naxis == 1:
        return 1, int(headers[prefix + b"NAXIS1"])
    return int(headers[prefix + b"NAXIS1"]), int(headers[prefix + b"NAXIS2"])


def _image(headers):
    """(gzip, (width, height), BITPIX, offset after the header) of the
    headers' image, None for a header without one."""
    offset, prefix, packed = 0, b"", False
    if (headers.get(b"XTENSION") == b"'BINTABLE'" and headers.get(b"ZIMAGE") == b"T"
            and headers[b"ZCMPTYPE"] == b"'GZIP_1  '"):
        table = _size(headers, b"") or (0, 0)
        offset = table[0] * table[1] * (int(headers[b"BITPIX"]) // 8)
        prefix, packed = b"Z", True
    size = _size(headers, prefix)
    if not size:
        return None
    return packed, size, int(headers[prefix + b"BITPIX"]), offset


def fits_header(data: bytes):
    """(gzip, (width, height), BITPIX, offset of the data) as PIL's ``_open``
    reads them; ValueError where PIL's open fails."""
    headers, in_header, image, pos = {}, False, None, 0
    try:
        while True:
            card = data[pos:pos + 80]
            pos += len(card)
            if not card:
                raise ValueError("truncated FITS file")
            keyword = card[:8].strip()
            if keyword in (b"SIMPLE", b"XTENSION"):
                in_header = True
            elif headers and not in_header:
                break
            elif keyword == b"END":
                pos = math.ceil(pos / 2880) * 2880
                if not image:
                    image = _image(headers)
                in_header = False
                continue
            if image:
                continue
            value = card[8:].split(b"/")[0].strip()
            if value.startswith(b"="):
                value = value[1:].strip()
            if not headers and (not keyword.startswith(SIGNATURE) or value != b"T"):
                raise ValueError("not a FITS file")
            headers[keyword] = value
    except (KeyError, ValueError) as e:
        raise ValueError(f"FITS header PIL cannot read: {e}") from None
    if not image:
        raise ValueError("FITS file without image data")
    packed, size, bitpix, offset = image
    return packed, size, bitpix, offset + pos - 80


def decode_fits_image(data: bytes):
    """(pixels, PIL's mode, None) of a FITS file (see the module docstring)."""
    data = bytes(data)
    if not data.startswith(SIGNATURE):
        raise ValueError("not a FITS file")
    packed, (width, height), bitpix, offset = fits_header(data)
    if bitpix not in _MODES or width <= 0 or height <= 0:
        raise ValueError(f"FITS image of BITPIX {bitpix} and {width} x {height} pixels")
    check_pixels(width, height, "FITS")
    if offset < 0:
        raise ValueError(f"FITS data offset {offset} is before the file's start")
    mode, layout = _MODES[bitpix]
    size = np.dtype(layout).itemsize
    if not packed:
        rows = whole_rows(data[offset:], width * size, height, 1)[::-1, :, 0]
        return rows.view(layout).reshape(height, width).astype(layout.lstrip('<')), mode, None
    try:
        value = gzip.decompress(data[offset:])
    except (OSError, EOFError, ValueError, zlib.error) as e:  # BadGzipFile is an OSError
        raise ValueError(f"FITS GZIP_1 data PIL cannot inflate: {e}") from None
    keep = min(bitpix // 8, 4)
    if keep <= 0 or len(value) < 4 * width * height:
        raise ValueError("FITS GZIP_1 data gives too few samples")
    words = np.frombuffer(value, np.uint8, count=4 * width * height).reshape(height, width, 4)
    samples = np.ascontiguousarray(words[::-1, :, 4 - keep:])
    return samples.view(layout).reshape(height, width).astype(layout.lstrip('<')), mode, None
