"""QOI files decoded as PIL 12.1's ``QoiImagePlugin`` decodes them, and an RGB
image encoded as its ``save`` encodes it, with one host C++ loop each
(``csrc/rle_decode.cpp``, ``qoi_decode`` and ``qoi_encode``: the op stream
is serial).

``decode_qoi_image(data)`` returns ``(pixels, mode, None)``:
``np.asarray(PIL.Image.open(BytesIO(data)))`` and PIL's mode, "RGB" where the
header's channel byte is 3 and "RGBA" for any other.  The ops are PIL's
decoder's: its index table starts empty (an unset entry reads (0, 0, 0, 0)),
a run leaves the table as it is, and a stream that ends before the last
pixel raises, as PIL's decoder does.

``encode_qoi(arr)`` writes what ``Image.fromarray(arr).save(f, "QOI")``
writes for an (h, w, 3) uint8 RGB array (colour space byte 1, PIL's index
table starting with entry 0 set to (0, 0, 0, 0)).
"""

import ctypes
import struct
from functools import lru_cache

import numpy as np

from ifseg_torch.data.png import check_pixels
from ifseg_torch.ops import build

SOURCE = "rle_decode"
SIGNATURE = b"qoif"


@lru_cache(maxsize=None)
def _lib():
    lib = build.load(SOURCE)
    lib.qoi_decode.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
                               ctypes.c_int64]
    lib.qoi_decode.restype = ctypes.c_int64
    lib.qoi_encode.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
    lib.qoi_encode.restype = ctypes.c_int64
    return lib


def load():
    """Build (if need be) and load the op loops now, not at the first decode."""
    _lib()


def decode_qoi_image(data: bytes):
    """(pixels, PIL's mode, None) of a QOI file (see the module docstring)."""
    data = bytes(data)
    if data[:4] != SIGNATURE:
        raise ValueError("not a QOI file")
    if len(data) < 14:
        raise ValueError("truncated QOI: the header is cut off")
    width, height, channels = struct.unpack_from(">IIB", data, 4)
    check_pixels(width, height, "QOI")
    mode = "RGB" if channels == 3 else "RGBA"
    bands = len(mode)
    pixels = np.empty((height, width, bands), np.uint8)
    if _lib().qoi_decode(data[14:], len(data) - 14, pixels.ctypes.data, width * height, bands):
        raise ValueError("truncated QOI: the op stream ends before the last pixel")
    return pixels, mode, None


def encode_qoi(arr: np.ndarray) -> bytes:
    """The bytes of PIL's ``Image.fromarray(arr).save(buf, "QOI")`` for an
    (h, w, 3) uint8 RGB array."""
    if arr.dtype != np.uint8 or arr.ndim != 3 or arr.shape[2] != 3:
        raise ValueError(f"encode_qoi takes (h, w, 3) uint8, not {arr.shape} {arr.dtype}")
    h, w = arr.shape[:2]
    src = np.ascontiguousarray(arr)
    out = np.empty(4 * h * w + 8, np.uint8)
    n = _lib().qoi_encode(src.ctypes.data, h * w, out.ctypes.data)
    return SIGNATURE + struct.pack(">IIBB", w, h, 3, 1) + out[:n].tobytes()
