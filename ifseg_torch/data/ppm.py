"""Netpbm files (PBM, PGM, PPM and PFM) decoded as PIL 12.1's ``PpmImagePlugin``
decodes them, and encoded as its ``save`` encodes them, with numpy.

``decode_ppm_image(data)`` returns ``(pixels, mode, palette)``:
``np.asarray(PIL.Image.open(BytesIO(data)))``, PIL's mode and, for PIL's own
"PyP" files, the palette PIL gives them (none: (0, 3) uint8).  The magic
numbers and their modes:

  P1, P4   "1"  plain (ASCII 0 and 1, 1 is black) and raw (bits, 1 is black)
  P2, P5   "L"  plain and raw grey; a maxval above 255 makes the mode "I"
  P3, P6   "RGB"  plain and raw
  Pf       "F"  grey floats, little-endian where the scale is negative,
                big-endian where it is positive, rows bottom-up
  P0CMYK, PyCMYK  "CMYK";  PyRGBA  "RGBA";  PyP  "P"  (PIL's extensions)

The header is PIL's: up to six bytes of magic, then tokens of at most ten
bytes split by whitespace, a ``#`` ending a token's bytes up to the next CR
or LF and the token going on after it; the pixels start one byte after the
last token.  Raw samples at maxval 255 are copied (a cut file keeps its whole
rows, the others 0, as PIL reads it under the JAX package's
``LOAD_TRUNCATED_IMAGES``); at maxval 65535 a raw grey file is read as
big-endian 16-bit into "I"; any other maxval rescales each sample to
``min(top, round(v / maxval * top))`` (top 65535 for "I", else 255, Python's
rounding, half to even) and, as in PIL, a cut file raises.  The plain formats
follow ``PpmPlainDecoder``: blocks of 1 MiB with their comments removed,
tokens of at most ten bytes, values above maxval or below 0 refused, a file
with fewer values than pixels refused.

``encode_ppm(arr)`` writes what PIL's ``save`` writes for an (h, w, 3) uint8
RGB array, a P6 file, whatever the extension (.pbm, .pgm, .ppm, .pnm, .pfm).
"""

import math

import numpy as np

from ifseg_torch.data.png import check_pixels, unpack_bits

MODES = {b"P1": "1", b"P2": "L", b"P3": "RGB", b"P4": "1", b"P5": "L", b"P6": "RGB",
         b"P0CMYK": "CMYK", b"Pf": "F", b"PyP": "P", b"PyRGBA": "RGBA", b"PyCMYK": "CMYK"}
_WHITESPACE = b"\x20\x09\x0a\x0b\x0c\x0d"
_BANDS = {"1": 1, "L": 1, "I": 1, "F": 1, "P": 1, "RGB": 3, "RGBA": 4, "CMYK": 4}
_BLOCK = 1024 * 1024  # PIL's ImageFile.SAFEBLOCK, the plain decoder's read size
_MAX_TOKEN = 10


def is_ppm(data: bytes) -> bool:
    """PIL's ``_accept``: "P" and one of 0-6, f, y."""
    return len(data) >= 2 and data[:1] == b"P" and data[1] in b"0123456fy"


def _token(data: bytes, pos: int):
    """(token, position after it) as PIL's ``_read_token`` reads it."""
    token = b""
    while len(token) <= _MAX_TOKEN:
        c = data[pos:pos + 1]
        pos += len(c)
        if not c:
            break
        if c in _WHITESPACE:
            if not token:
                continue
            break
        if c == b"#":  # the rest of the line, up to CR, LF or the end
            ends = [i for i in (data.find(b"\r", pos), data.find(b"\n", pos)) if i >= 0]
            pos = min(ends) + 1 if ends else len(data)
            continue
        token += c
    if not token:
        raise ValueError("broken Netpbm file: the header ends early")
    if len(token) > _MAX_TOKEN:
        raise ValueError(f"broken Netpbm file: header token too long ({token!r})")
    return token, pos


def _header(data: bytes):
    """(magic, mode, width, height, maxval or the PFM scale, pixel offset)."""
    magic, pos = b"", 0
    for _ in range(6):
        c = data[pos:pos + 1]
        pos += len(c)
        if not c or c in _WHITESPACE:
            break
        magic += c
    if magic not in MODES:
        raise ValueError(f"Netpbm magic {magic!r} is not one PIL reads")
    mode = MODES[magic]
    w, pos = _token(data, pos)
    h, pos = _token(data, pos)
    width, height = int(w), int(h)
    if width <= 0 or height <= 0:  # PIL's ImageFile identifies no such image
        raise ValueError(f"broken Netpbm file: size {width} x {height}")
    if mode == "1":
        return magic, mode, width, height, None, pos
    value, pos = _token(data, pos)
    if mode == "F":
        scale = float(value)
        if scale == 0.0 or not math.isfinite(scale):
            raise ValueError("broken PFM file: the scale must be finite and non-zero")
        return magic, mode, width, height, scale, pos
    maxval = int(value)
    if not 0 < maxval < 65536:
        raise ValueError(f"broken Netpbm file: maxval {maxval} is not in 1..65535")
    if maxval > 255 and mode == "L":
        mode = "I"
    return magic, mode, width, height, maxval, pos


def _raw_rows(body: bytes, height: int, row: int) -> np.ndarray:
    """(rows read whole, row) uint8 of the rows the raw decoder takes."""
    whole = min(height, len(body) // row)
    return np.frombuffer(body, np.uint8, count=whole * row).reshape(whole, row)


def _raw(body: bytes, mode: str, width: int, height: int, scale) -> np.ndarray:
    """PIL's raw decoder: the whole rows in ``body``, the others 0."""
    if mode == "1":  # "1;I": a set bit is black
        rows = _raw_rows(body, height, (width + 7) // 8)
        out = np.zeros((height, width), bool)
        if len(rows):
            out[:len(rows)] = unpack_bits(rows, 1, width) == 0
        return out
    if mode == "F":  # "F;32F" / "F;32BF", bottom-up
        rows = _raw_rows(body, height, 4 * width)
        out = np.zeros((height, width), np.float32)
        order = "<f4" if scale < 0 else ">f4"
        out[height - len(rows):] = rows.copy().view(order)[::-1].astype(np.float32)
        return out
    if mode == "I":  # "I;16B" at maxval 65535
        rows = _raw_rows(body, height, 2 * width)
        out = np.zeros((height, width), np.int32)
        out[:len(rows)] = rows.copy().view(">u2")
        return out
    bands = _BANDS[mode]
    rows = _raw_rows(body, height, bands * width)
    out = np.zeros((height, width, bands) if bands > 1 else (height, width), np.uint8)
    out[:len(rows)] = rows.reshape((len(rows), width, bands) if bands > 1 else (len(rows), width))
    return out


def _samples(values: np.ndarray, mode: str, width: int, height: int) -> np.ndarray:
    """The decoded samples as PIL's ``set_as_raw`` lays them out."""
    bands = _BANDS[mode]
    if len(values) < width * height * bands:
        raise ValueError("broken Netpbm file: not enough image data")
    dtype = np.int32 if mode == "I" else np.uint8
    values = values[:width * height * bands].astype(dtype)
    return values.reshape((height, width, bands) if bands > 1 else (height, width))


def _scaled(body: bytes, mode: str, width: int, height: int, maxval: int) -> np.ndarray:
    """PIL's ``PpmDecoder``: 1 or 2 bytes a sample, rescaled to 0..top."""
    size = 1 if maxval < 256 else 2
    bands = _BANDS[mode]
    top = 65535 if mode == "I" else 255
    count = min(len(body) // (size * bands), width * height) * bands
    v = np.frombuffer(body, np.uint8 if size == 1 else ">u2", count=count).astype(np.float64)
    return _samples(np.minimum(top, np.rint(v / maxval * top)), mode, width, height)


def _comment_end(block: bytes, start: int = 0) -> int:
    a, b = block.find(b"\n", start), block.find(b"\r", start)
    return min(a, b) if a * b > 0 else max(a, b)


class _Plain:
    """PIL's ``PpmPlainDecoder`` over the bytes from the pixel offset on."""

    def __init__(self, body: bytes):
        self.body, self.pos, self.comment_spans = body, 0, False

    def block(self) -> bytes:
        b = self.body[self.pos:self.pos + _BLOCK]
        self.pos += len(b)
        return b

    def ignore_comments(self, block: bytes) -> bytes:
        if self.comment_spans:
            while block:
                end = _comment_end(block)
                if end != -1:
                    block = block[end + 1:]
                    break
                block = self.block()
        self.comment_spans = False
        while True:
            start = block.find(b"#")
            if start == -1:
                break
            end = _comment_end(block, start)
            if end != -1:
                block = block[:start] + block[end + 1:]
            else:
                block = block[:start]
                self.comment_spans = True
                break
        return block

    def bitonal(self, total: int) -> np.ndarray:
        data = b""
        while len(data) != total:
            block = self.block()
            if not block:
                break
            tokens = b"".join(self.ignore_comments(block).split())
            bad = tokens.translate(None, b"01")
            if bad:
                raise ValueError(f"broken PBM file: token {bad[:1]!r} is not 0 or 1")
            data = (data + tokens)[:total]
        return np.frombuffer(data, np.uint8) == ord("0")

    def values(self, total: int, maxval: int, top: int) -> np.ndarray:
        out = []
        half = b""
        while len(out) != total:
            block = self.block()
            if not block:
                if not half:
                    break
                block = b" "  # flush the token cut at the last block's end
            block = self.ignore_comments(block)
            if half:
                block, half = half + block, b""
            tokens = block.split()
            if block and not block[-1:].isspace():
                half = tokens.pop()
                if len(half) > _MAX_TOKEN:
                    raise ValueError(f"broken Netpbm file: token too long ({half[:11]!r})")
            for token in tokens:
                if len(token) > _MAX_TOKEN:
                    raise ValueError(f"broken Netpbm file: token too long ({token[:11]!r})")
                value = int(token)
                if value < 0 or value > maxval:
                    raise ValueError(f"broken Netpbm file: sample {value} is not in 0..{maxval}")
                out.append(round(value / maxval * top))
                if len(out) == total:
                    break
        return np.asarray(out, np.int64)


def decode_ppm_image(data: bytes):
    """(pixels, PIL's mode, palette or None) of a Netpbm file (see the module
    docstring)."""
    data = bytes(data)
    if not is_ppm(data):
        raise ValueError("not a Netpbm file")
    magic, mode, width, height, value, pos = _header(data)
    check_pixels(width, height, "Netpbm")
    body = data[pos:]
    if magic in (b"P1", b"P2", b"P3"):
        plain = _Plain(body)
        if mode == "1":
            bits = plain.bitonal(width * height)
            if len(bits) < width * height:
                raise ValueError("broken PBM file: not enough image data")
            pixels = bits.reshape(height, width)
        else:
            top = 65535 if mode == "I" else 255
            total = width * height * _BANDS[mode]
            pixels = _samples(plain.values(total, value, top), mode, width, height)
    elif mode in ("1", "F") or value == 255 or (value == 65535 and mode == "I"):
        pixels = _raw(body, mode, width, height, value)
    else:
        pixels = _scaled(body, mode, width, height, value)
    return pixels, mode, np.zeros((0, 3), np.uint8) if mode == "P" else None


def encode_ppm(arr: np.ndarray) -> bytes:
    """The bytes of PIL's ``Image.fromarray(arr).save(path)`` for an (h, w, 3)
    uint8 RGB array and a Netpbm extension: P6, maxval 255."""
    if arr.dtype != np.uint8 or arr.ndim != 3 or arr.shape[2] != 3:
        raise ValueError(f"encode_ppm takes (h, w, 3) uint8, not {arr.shape} {arr.dtype}")
    h, w = arr.shape[:2]
    return b"P6\n%d %d\n255\n" % (w, h) + np.ascontiguousarray(arr).tobytes()
