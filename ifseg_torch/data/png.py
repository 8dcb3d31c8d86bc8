"""PNG decoding and encoding with the standard library, numpy and one host
C++ loop.

``decode_png(data)`` returns what ``np.asarray(PIL.Image.open(BytesIO(data)))``
returns for the PNG files a segmentation TSV holds, bit for bit, so the
port's data pipeline depends on no image library:

  colour type 0, gray        -> (h, w) uint8; at bit depth 1, PIL's mode "1":
                                (h, w) bool; at depths 2 and 4 the samples
                                scaled to 0..255 (x 0x55, x 0x11), as PIL does
  colour type 2, RGB         -> (h, w, 3) uint8
  colour type 3, palette     -> (h, w) uint8 palette INDICES (PIL is not asked
                                to convert, and neither is this)
  colour type 4, gray+alpha  -> (h, w, 2) uint8
  colour type 6, RGBA        -> (h, w, 4) uint8

at bit depths 1, 2, 4 and 8 for types 0 and 3, and 8 for the others.
Interlaced (Adam7) and 16-bit files raise ``ValueError``.

``decode_png_rgb(data)`` returns what
``np.asarray(PIL.Image.open(BytesIO(data)).convert("RGB"))`` returns for the
same files: (h, w, 3) uint8, gray replicated to the three channels (1-bit
samples as 0 or 255), palette indices looked up in the PLTE chunk (an index
past its end reads black, as PIL pads the palette), alpha dropped.
``encode_png(arr)`` writes an 8-bit gray (h, w) or RGB (h, w, 3) image.

The chunks are parsed and their CRCs checked here, the image data inflated
with ``zlib`` (which releases the interpreter lock), and the per-row filters
undone by ``csrc/png_unfilter.cpp``: Average and Paeth depend on the pixel to
their left once it is reconstructed, a sequential loop.  That source is built
with the host C++ compiler at the first decode (``ops/build.py``), never when
this module is imported; a failed build raises.
"""

import ctypes
import struct
import zlib
from functools import lru_cache

import numpy as np

from ifseg_torch.ops import build

SOURCE = "png_unfilter"
SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> (samples a pixel, bit depths taken)
_COLOUR_TYPES = {0: (1, (1, 2, 4, 8)), 2: (3, (8,)), 3: (1, (1, 2, 4, 8)), 4: (2, (8,)),
                 6: (4, (8,))}


@lru_cache(maxsize=None)
def _unfilter():
    fn = build.load(SOURCE).png_unfilter
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_int64]
    fn.restype = ctypes.c_int64
    return fn


def _chunks(data: bytes):
    """(type, body) of every chunk up to IEND, CRCs checked."""
    pos = 8
    while pos < len(data):
        if pos + 8 > len(data):
            raise ValueError("truncated PNG: a chunk header is cut off")
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        end = pos + 12 + length
        if end > len(data):
            raise ValueError(f"truncated PNG: chunk {ctype!r} is cut off")
        body = data[pos + 8:end - 4]
        (crc,) = struct.unpack(">I", data[end - 4:end])
        if zlib.crc32(ctype + body) != crc:
            raise ValueError(f"broken PNG: CRC mismatch in chunk {ctype!r}")
        yield ctype, body
        if ctype == b"IEND":
            return
        pos = end
    raise ValueError("truncated PNG: no IEND chunk")


def decode_png(data: bytes) -> np.ndarray:
    """The pixels of the PNG file ``data``, as ``np.asarray(PIL.Image.open)``
    gives them (see the module docstring)."""
    return _decode(data)[0]


def decode_png_rgb(data: bytes) -> np.ndarray:
    """The pixels of the PNG file ``data`` as (h, w, 3) uint8 RGB, as
    ``np.asarray(PIL.Image.open(...).convert("RGB"))`` gives them."""
    pixels, colour, palette = _decode(data)
    if colour == 3:
        if palette is None:
            raise ValueError("broken PNG: a palette image without a PLTE chunk")
        table = np.zeros((256, 3), np.uint8)
        entries = np.frombuffer(palette, np.uint8)[: len(palette) // 3 * 3].reshape(-1, 3)
        table[: min(len(entries), 256)] = entries[:256]
        return table[pixels]
    if pixels.dtype == bool:
        pixels = pixels.astype(np.uint8) * np.uint8(255)
    if pixels.ndim == 2:
        return np.repeat(pixels[:, :, None], 3, axis=2)
    if pixels.shape[2] == 2:  # gray + alpha
        return np.repeat(pixels[:, :, :1], 3, axis=2)
    return np.ascontiguousarray(pixels[:, :, :3])


def encode_png(arr: np.ndarray) -> bytes:
    """A PNG file of the uint8 image ``arr``: (h, w) gray or (h, w, 3) RGB,
    8 bits a sample, no filter, zlib level 6."""
    if arr.dtype != np.uint8 or not (arr.ndim == 2 or (arr.ndim == 3 and arr.shape[2] == 3)):
        raise ValueError(f"encode_png takes (h, w) or (h, w, 3) uint8, not {arr.shape} {arr.dtype}")
    h, w = arr.shape[:2]
    colour = 0 if arr.ndim == 2 else 2
    rows = np.ascontiguousarray(arr).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)  # filter type 0

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    return (SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)) + chunk(b"IEND", b""))


def _decode(data: bytes):
    """(pixels as ``decode_png`` returns them, colour type, PLTE body or None)."""
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file (bad signature)")
    header, idat, palette = None, [], None
    for ctype, body in _chunks(data):
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"PLTE":
            palette = body
    if header is None:
        raise ValueError("broken PNG: no IHDR chunk")
    w, h, depth, colour, _, _, interlace = header
    if colour not in _COLOUR_TYPES:
        raise ValueError(f"PNG colour type {colour} is not a valid one")
    if depth == 16:
        raise ValueError("16-bit PNG files are not supported")
    if interlace:
        raise ValueError("interlaced (Adam7) PNG files are not supported")
    channels, depths = _COLOUR_TYPES[colour]
    if depth not in depths:
        raise ValueError(f"PNG colour type {colour} at bit depth {depth} is not valid")

    stride = (w * channels * depth + 7) // 8
    raw = zlib.decompress(b"".join(idat))
    if len(raw) < h * (stride + 1):
        raise ValueError(f"truncated PNG: {len(raw)} bytes of image data, {h * (stride + 1)} needed")
    src = np.frombuffer(raw, np.uint8, count=h * (stride + 1))
    out = np.empty((h, stride), np.uint8)
    bad = _unfilter()(src.ctypes.data, out.ctypes.data, h, stride,
                      max(channels * depth // 8, 1))
    if bad:
        raise ValueError(f"broken PNG: row {bad - 1} has filter type {src[(bad - 1) * (stride + 1)]}")

    if depth == 8:
        return (out.reshape(h, w, channels) if channels > 1 else out.reshape(h, w)), colour, palette
    # 1, 2 or 4 bits a sample, one channel, the first sample in the high bits
    per_byte = 8 // depth
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    samples = ((out[:, :, None] >> shifts) & ((1 << depth) - 1)).reshape(h, stride * per_byte)
    samples = np.ascontiguousarray(samples[:, :w])
    if colour == 3:
        return samples, colour, palette
    if depth == 1:
        return samples.astype(bool), colour, palette
    return samples * np.uint8(0x55 if depth == 2 else 0x11), colour, palette
