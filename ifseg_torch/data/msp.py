"""Windows Paint (MSP) files decoded as PIL 12.1's ``MspImagePlugin``
decodes them, with numpy.

``decode_msp_image(data)`` returns ``(pixels, "1", None)``:
``np.asarray(PIL.Image.open(BytesIO(data)))``, (h, w) bool.  The 32-byte
header's sixteen little-endian words must XOR to 0.  Version 1 ("DanM") is
raw rows of (w + 7) // 8 bytes, the first pixel in the high bit, a set bit
white; a cut file keeps its whole rows, the others 0, as PIL reads it under
the JAX package's ``LOAD_TRUNCATED_IMAGES``.  Version 2 ("LinS") is PIL's
Python decoder: a map of each row's encoded length, then each row's runs (0
n v: n bytes v; n > 0: n literal bytes), a row of length 0 white; the bytes
all rows give, in order, are the image's rows whatever each row's count.
A row map or a row cut short, a run cut short and too few bytes in all
raise, as in PIL.
"""

import struct

import numpy as np

from ifseg_torch.data.png import check_pixels, unpack_bits, whole_rows

SIGNATURES = (b"DanM", b"LinS")


def msp_size(data: bytes):
    """(width, height) as PIL's ``_open`` reads them, None where it does not
    take the file."""
    if len(data) < 32 or data[:4] not in SIGNATURES:
        return None
    words = struct.unpack_from("<16H", data)
    check = 0
    for word in words:
        check ^= word
    if check:
        return None
    return words[2], words[3]


def is_msp(data: bytes) -> bool:
    """PIL opens the file as MSP: its signature, checksum and a size."""
    size = msp_size(data)
    return size is not None and 0 not in size


def _rle_rows(data: bytes, width: int, height: int) -> bytes:
    row_bytes = (width + 7) // 8
    if len(data) < 32 + 2 * height:
        raise ValueError("truncated MSP: the row map is cut off")
    lengths = struct.unpack_from(f"<{height}H", data, 32)
    out, pos = [], 32 + 2 * height
    for y, length in enumerate(lengths):
        if not length:
            out.append(b"\xff" * row_bytes)
            continue
        row = data[pos:pos + length]
        pos += length
        if len(row) != length:
            raise ValueError(f"truncated MSP: row {y} is cut off")
        i = 0
        while i < length:
            count = row[i]
            i += 1
            if count == 0:
                if length - i < 2:
                    raise ValueError(f"corrupted MSP: a run of row {y} is cut off")
                out.append(row[i + 1:i + 2] * row[i])
                i += 2
            else:
                out.append(row[i:i + count])
                i += count
    return b"".join(out)


def decode_msp_image(data: bytes):
    """(pixels, "1", None) of an MSP file (see the module docstring)."""
    data = bytes(data)
    if not is_msp(data):
        raise ValueError("not an MSP file PIL opens (signature, checksum or size)")
    width, height = msp_size(data)
    check_pixels(width, height, "MSP")
    row_bytes = (width + 7) // 8
    if data[:4] == b"DanM":
        rows = whole_rows(data[32:], row_bytes, height, 1)[:, :, 0]
    else:
        body = _rle_rows(data, width, height)
        if len(body) < row_bytes * height:
            raise ValueError("truncated MSP: the rows give too few bytes")
        rows = np.frombuffer(body, np.uint8, count=row_bytes * height).reshape(height, row_bytes)
    return unpack_bits(rows, 1, width) != 0, "1", None
