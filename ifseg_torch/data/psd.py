"""Photoshop files (PSD) decoded as PIL 12.1's ``PsdImagePlugin`` decodes
them: the merged image, with numpy and one host C++ loop.

``decode_psd_image(data)`` returns ``(pixels, mode, palette)``:
``np.asarray(PIL.Image.open(BytesIO(data)))``, PIL's mode and, for mode "P",
the palette ((256, 3) uint8 from a colour-mode block of 768 bytes, else
(0, 3): PIL's image has none).  The modes, by Photoshop's colour mode and
bit depth (only 1 and 8 bits; 16- and 32-bit files, and PSB files, raise,
as PIL cannot open them):

  bitmap 1 bit  "1" (a set bit white, as PIL's raw "1" reads it)
  grey, bitmap 8 bits, multichannel, duotone   "L"
  indexed       "P"
  RGB           "RGB", or "RGBA" where the file has exactly four channels
  CMYK          "CMYK", each channel inverted
  Lab           "LAB" (the L byte as it is, a and b with their top bit
                flipped, as PIL's a and b bands hold them; their rows a cut
                file lacks 128, PIL's blank Lab)

The header, the colour-mode block, the image resources (walked as PIL walks
them, each name and body padded to an even length; 1039 is the ICC profile,
which PIL keeps beside the image) and the layer and mask section (only its
length is read: PIL does not read layers to load the image) come before the
merged image: a compression word, then the channels the mode needs one after
the other, planar, raw or PackBits (behind a table of each row's byte
count).  Each channel is decoded from its offset on to the end of the file,
as PIL's tile decoder reads it: a channel's rows may run into the next
one's bytes; a cut file keeps each channel's whole rows, the others 0 (the
JAX package's ``LOAD_TRUNCATED_IMAGES``).  PackBits is PIL's decoder
(``csrc/tiff_decode.cpp:packbits_rows``, built with the host C++ compiler at
the first decode): a run past a row's end is cut there.  Other compressions
(ZIP) leave PIL nothing to load and raise.
"""

import ctypes
import struct
from functools import lru_cache

import numpy as np

from ifseg_torch.data.png import check_pixels, unpack_bits
from ifseg_torch.ops import build

SOURCE = "tiff_decode"
SIGNATURE = b"8BPS"
# (Photoshop colour mode, bits) -> (PIL's mode, channels it needs)
MODES = {(0, 1): ("1", 1), (0, 8): ("L", 1), (1, 8): ("L", 1), (2, 8): ("P", 1),
         (3, 8): ("RGB", 3), (4, 8): ("CMYK", 4), (7, 8): ("L", 1), (8, 8): ("L", 1),
         (9, 8): ("LAB", 3)}
_COLOUR_MODES = {0: "bitmap", 1: "grey", 2: "indexed", 3: "RGB", 4: "CMYK", 7: "multichannel",
                 8: "duotone", 9: "Lab"}


@lru_cache(maxsize=None)
def _packbits():
    fn = build.load(SOURCE).packbits_rows
    fn.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
                   ctypes.c_int64]
    fn.restype = ctypes.c_int64
    return fn


def load():
    """Build (if need be) and load the PackBits decoder now."""
    _packbits()


class _File:
    """PIL's file reads over bytes: a read past the end is short, a seek
    may pass the end."""

    def __init__(self, data: bytes):
        self.data, self.pos = data, 0

    def read(self, n: int) -> bytes:
        b = self.data[self.pos:self.pos + n]
        self.pos += len(b)
        return b

    def u(self, n: int) -> int:
        b = self.read(n)
        if len(b) < n:
            raise ValueError("truncated PSD: the file ends inside its header blocks")
        return int.from_bytes(b, "big")


def _header(f: _File):
    """(mode, channels, width, height, palette or None) after PIL's ``_open``
    up to the merged image, ``f`` left at its compression word."""
    s = f.read(26)
    if len(s) < 26 or s[:4] != SIGNATURE or struct.unpack_from(">H", s, 4)[0] != 1:
        raise ValueError("not a PSD file (or a PSB file, which PIL does not read)")
    psd_channels, height, width, bits, colour = struct.unpack_from(">HIIHH", s, 12)
    if (colour, bits) not in MODES:
        name = _COLOUR_MODES.get(colour, str(colour))
        raise ValueError(f"PSD {name} at {bits} bits is not supported (PIL reads 8-bit files "
                         f"and 1-bit bitmaps)")
    if not width or not height:  # PIL's ImageFile identifies no such image
        raise ValueError(f"broken PSD: size {width} x {height}")
    mode, channels = MODES[(colour, bits)]
    if channels > psd_channels:
        raise ValueError(f"broken PSD: mode {mode} needs {channels} channels, not {psd_channels}")
    if mode == "RGB" and psd_channels == 4:
        mode, channels = "RGBA", 4
    palette = None
    size = f.u(4)
    if size:
        block = f.read(size)
        if mode == "P" and size == 768:
            palette = np.frombuffer(block.ljust(768, b"\0"), np.uint8).reshape(3, 256).T.copy()
    size = f.u(4)  # image resources
    if size:
        end = f.pos + size
        while f.pos < end:
            f.read(4)  # signature
            f.u(2)  # id
            name = f.read(f.u(1))
            if not len(name) & 1:
                f.read(1)
            body = f.read(f.u(4))
            if len(body) & 1:
                f.read(1)
    size = f.u(4)  # layer and mask information
    if size:
        end = f.pos + size
        f.u(4)
        f.pos = end
    return mode, channels, width, height, palette


def _channel_offsets(f: _File, compression: int, channels: int, height: int, plane: int):
    offset = f.pos
    if compression == 0:
        return [offset + c * plane for c in range(channels)]
    counts = f.read(2 * channels * height)
    if len(counts) < 2 * channels * height:
        raise ValueError("truncated PSD: the table of row byte counts is cut off")
    rows = np.frombuffer(counts, ">u2").astype(np.int64).reshape(channels, height).sum(axis=1)
    return list(f.pos + np.concatenate([[0], np.cumsum(rows)[:-1]]))


def decode_psd_image(data: bytes):
    """(pixels, PIL's mode, palette or None) of a PSD file (see the module
    docstring)."""
    data = bytes(data)
    f = _File(data)
    mode, channels, width, height, palette = _header(f)
    check_pixels(width, height, "PSD")
    compression = f.u(2)
    if compression not in (0, 1):
        raise ValueError(f"PSD compression {compression} is not supported (PIL reads raw and "
                         f"PackBits image data)")
    row = (width + 7) // 8 if mode == "1" else width
    offsets = _channel_offsets(f, compression, channels, height, width * height)
    planes = np.zeros((channels, height, row), np.uint8)
    whole = np.zeros(channels, np.int64)
    for c, at in enumerate(offsets):
        body = data[at:] if at < len(data) else b""
        if compression == 0:
            whole[c] = min(height, len(body) // row)
            rows = np.frombuffer(body, np.uint8, count=whole[c] * row)
            planes[c, :whole[c]] = rows.reshape(-1, row)
        else:
            whole[c] = _packbits()(body, len(body), planes[c].ctypes.data, height, row)
            planes[c, whole[c]:] = 0
    if mode == "1":
        return unpack_bits(planes[0], 1, width).astype(bool), mode, None
    if mode == "CMYK":  # PIL's "C;I" etc.: each decoded row inverted, the rest 0
        for c in range(channels):
            planes[c, :whole[c]] = 255 - planes[c, :whole[c]]
    if mode == "LAB":  # PIL's a and b bands hold the value + 128: rows not decoded 128
        planes[1:3] ^= 0x80
    if channels == 1:
        pixels = planes[0]
    else:
        pixels = np.ascontiguousarray(planes.transpose(1, 2, 0))
    if mode == "P":
        return pixels, mode, np.zeros((0, 3), np.uint8) if palette is None else palette
    return pixels, mode, None
