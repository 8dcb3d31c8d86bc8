"""PCX files, and the first PCX frame of a DCX file, decoded as PIL 12.1's
``PcxImagePlugin`` and ``DcxImagePlugin`` decode them, and an RGB image
encoded as its PCX ``save`` encodes it, with numpy and one host C++ loop.

``decode_pcx_image(data)`` and ``decode_dcx_image(data)`` return
``(pixels, mode, palette)``: ``np.asarray(PIL.Image.open(BytesIO(data)))``,
PIL's mode and, for mode "P", the palette ((n, 3) uint8 RGB).  The 128-byte
header (byte 0 is 10, version 0, 2, 3 or 5) gives the window, bits a pixel
and planes:

  1 bit, 1 plane       "1", a set bit white
  1 bit, 2 or 4 planes "P", bit planes, the header's 16-colour palette
  8 bits, 1 plane      version 5: "L", or "P" where the file's last 769
                       bytes are 12 and a palette that is not the grey ramp
  8 bits, 3 planes     version 5: "RGB", planar rows

Any other layout raises, as in PIL.  Rows hold ``planes x stride`` bytes,
the stride being ``ceil(width x bits / 8)``, rounded up to even where the
header says another; the run-length bytes (``csrc/rle_decode.cpp``,
``pcx_rle``) fill them, a run cut at its row's end, and PIL's move of a
padded row's planes next to each other is kept.  A cut
file keeps its whole rows, the others 0, as PIL reads it under the JAX
package's ``LOAD_TRUNCATED_IMAGES``.  A DCX file is a table of offsets; its
first frame is read (the palette test of an 8-bit frame reads the end of the
DCX file, as PIL's does).

``encode_pcx(arr)`` writes what ``Image.fromarray(arr).save(f, "PCX")``
writes for an (h, w, 3) uint8 RGB array: version 5, three planes, each
plane's runs of a row padded to an even length.
"""

import ctypes
import struct
from functools import lru_cache

import numpy as np

from ifseg_torch.data.png import check_pixels
from ifseg_torch.ops import build

SOURCE = "rle_decode"
DCX_SIGNATURE = b"\xb1\x68\xde\x3a"


def is_pcx(data: bytes) -> bool:
    """PIL's ``_accept``: 10, then a version of 0, 2, 3 or 5."""
    return len(data) >= 2 and data[0] == 10 and data[1] in (0, 2, 3, 5)


@lru_cache(maxsize=None)
def _lib():
    lib = build.load(SOURCE)
    lib.pcx_rle.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
                            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64]
    lib.pcx_rle.restype = ctypes.c_int64
    lib.pcx_encode.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                               ctypes.c_int64, ctypes.c_void_p]
    lib.pcx_encode.restype = ctypes.c_int64
    return lib


def load():
    """Build (if need be) and load the RLE loops now, not at the first decode."""
    _lib()


def _bit_planes(rows: np.ndarray, planes: int, width: int) -> np.ndarray:
    """PIL's ``P;2L`` / ``P;4L`` unpackers: plane i of each row (moved by
    ``pcx_rle`` to i * ceil(width / 8)) adds 2^i where its bit is set."""
    step = (width + 7) // 8
    out = np.zeros((rows.shape[0], width), np.uint8)
    for i in range(planes):
        bits = np.unpackbits(rows[:, i * step:(i + 1) * step], axis=1)[:, :width]
        out |= bits << i
    return out


def _decode(data: bytes, at: int, whole_file: bytes):
    """(pixels, mode, palette) of the PCX image at ``at``."""
    s = data[at:at + 68]
    if len(s) < 68 or not is_pcx(s):
        raise ValueError("truncated PCX: the header is cut off" if is_pcx(s) else "not a PCX file")
    xmin, ymin, xmax, ymax = struct.unpack_from("<HHHH", s, 4)
    width, height = xmax + 1 - xmin, ymax + 1 - ymin
    if width <= 0 or height <= 0:
        raise ValueError(f"broken PCX: window {xmin},{ymin} to {xmax},{ymax}")
    version, bits, planes = s[1], s[3], s[65]
    given = struct.unpack_from("<H", s, 66)[0]
    palette = None
    if bits == 1 and planes == 1:
        mode = "1"
    elif bits == 1 and planes in (2, 4):
        mode = "P"
        palette = np.frombuffer(s[16:64], np.uint8).reshape(16, 3).copy()
    elif version == 5 and bits == 8 and planes == 1:
        mode = "L"
        tail = whole_file[-769:]
        grey = bytes(np.repeat(np.arange(256, dtype=np.uint8), 3))
        if len(tail) == 769 and tail[0] == 12 and tail[1:] != grey:
            mode = "P"
            palette = np.frombuffer(tail[1:], np.uint8).reshape(256, 3).copy()
    elif version == 5 and bits == 8 and planes == 3:
        mode = "RGB"
    else:
        raise ValueError(f"PCX layout of version {version}, {bits} bits and {planes} planes "
                         f"is not one PIL reads")
    check_pixels(width, height, "PCX")
    stride = (width * bits + 7) // 8
    if given != stride:
        stride += stride % 2
    row_bytes = planes * stride
    unpacked = {"1": 1, "P": 1 if bits == 1 else 8, "L": 8, "RGB": 24}[mode] * (
        planes if mode == "P" and bits == 1 else 1)
    rows = np.zeros((height, row_bytes), np.uint8)
    body = data[at + 128:]
    whole = 0
    if (width * unpacked + 7) // 8 <= row_bytes:  # else PIL's decoder refuses: all 0
        whole = _lib().pcx_rle(body, len(body), rows.ctypes.data, height, row_bytes, width,
                               unpacked)
    rows[whole:] = 0
    if mode == "1":
        pixels = np.unpackbits(rows, axis=1)[:, :width].astype(bool)
    elif mode == "RGB":
        pixels = rows[:, :3 * width].reshape(height, 3, width).transpose(0, 2, 1)
    elif bits == 1:
        pixels = _bit_planes(rows, planes, width)
    else:
        pixels = rows[:, :width]
    return np.ascontiguousarray(pixels), mode, palette


def decode_pcx_image(data: bytes):
    """(pixels, PIL's mode, palette or None) of a PCX file (see the module
    docstring)."""
    data = bytes(data)
    return _decode(data, 0, data)


def decode_dcx_image(data: bytes):
    """(pixels, PIL's mode, palette or None) of a DCX file's first frame."""
    data = bytes(data)
    if data[:4] != DCX_SIGNATURE:
        raise ValueError("not a DCX file")
    if len(data) < 8:
        raise ValueError("truncated DCX: the table of frames is cut off")
    first = struct.unpack_from("<I", data, 4)[0]
    if not first:
        raise ValueError("broken DCX: no frame")
    return _decode(data, first, data)


def encode_pcx(arr: np.ndarray) -> bytes:
    """The bytes of PIL's ``Image.fromarray(arr).save(buf, "PCX")`` for an
    (h, w, 3) uint8 RGB array."""
    if arr.dtype != np.uint8 or arr.ndim != 3 or arr.shape[2] != 3:
        raise ValueError(f"encode_pcx takes (h, w, 3) uint8, not {arr.shape} {arr.dtype}")
    h, w = arr.shape[:2]
    stride = w + w % 2
    head = (struct.pack("<BBBBHHHHHH", 10, 5, 1, 8, 0, 0, w - 1, h - 1, 100, 100)
            + b"\0" * 24 + b"\xff" * 24 + struct.pack("<BBHHHH", 0, 3, stride, 1, w, h)
            + b"\0" * 54)
    planes = np.ascontiguousarray(arr.transpose(0, 2, 1))
    out = np.empty(2 * h * 3 * (w + 1), np.uint8)
    n = _lib().pcx_encode(planes.ctypes.data, h, 3, w, w % 2, out.ctypes.data)
    return head + out[:n].tobytes()
