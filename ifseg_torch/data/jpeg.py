"""JPEG decoding and encoding equal to PIL's, with no image library.

``decode_jpeg(data)`` returns what ``np.asarray(PIL.Image.open(BytesIO(data)))``
returns, bit for bit: (h, w) uint8 for a 1-component file, (h, w, 3) uint8
RGB for a 3-component one, baseline, extended or progressive, with restart
intervals, as the libjpeg-turbo that PIL links decodes it with its default
settings (the accurate integer IDCT, fancy upsampling); a cut file as PIL
decodes it under the JAX package's ``ImageFile.LOAD_TRUNCATED_IMAGES =
True`` (a file cut before the end of its first scan header raises, as
there).  Arithmetic-coded, lossless, hierarchical and 12-bit files, DNL,
4-component (CMYK/YCCK) files and progressive files that libjpeg-turbo
would block-smooth (their scans leave coefficients unrefined, a cut file's
too) raise ``ValueError``.  EXIF orientation is not applied, as
``Image.open`` does not apply it.

``encode_jpeg(arr, quality=75, subsampling=None)`` returns the bytes of
``PIL.Image.fromarray(arr).save(buf, "JPEG", quality=quality,
subsampling=subsampling)`` for an (h, w) or (h, w, 3) uint8 array: a JFIF
baseline file with the standard Huffman tables, 4:2:0 for RGB by default.

The codecs are ``csrc/jpeg_decode.cpp`` and ``csrc/jpeg_encode.cpp``, built
with the host C++ compiler at their first call (``ops/build.py``), never when
this module is imported; a failed build raises.
"""

import ctypes
from functools import lru_cache

import numpy as np

from ifseg_torch.ops import build

DECODER, ENCODER = "jpeg_decode", "jpeg_encode"
SIGNATURE = b"\xff\xd8\xff"
# PIL's names of the encoder's chroma subsampling: (h, v) of the first component
SUBSAMPLING = {0: (1, 1), 1: (2, 1), 2: (2, 2), "4:4:4": (1, 1), "4:2:2": (2, 1),
               "4:2:0": (2, 2)}
_ERR = 256


@lru_cache(maxsize=None)
def _decoder():
    lib = build.load(DECODER)
    lib.jpeg_header.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p,
                                ctypes.c_char_p, ctypes.c_int64]
    lib.jpeg_decode.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p,
                                ctypes.c_char_p, ctypes.c_int64]
    lib.jpeg_header.restype = lib.jpeg_decode.restype = ctypes.c_int64
    return lib


@lru_cache(maxsize=None)
def _encoder():
    lib = build.load(ENCODER)
    lib.jpeg_encode.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                                ctypes.POINTER(ctypes.c_void_p), ctypes.c_char_p, ctypes.c_int64]
    lib.jpeg_encode.restype = ctypes.c_int64
    lib.jpeg_free.argtypes = [ctypes.c_void_p]
    lib.jpeg_free.restype = None
    return lib


def load():
    """Build (if need be) and load both codecs now, not at their first call."""
    _decoder()
    _encoder()


def decode_jpeg(data: bytes) -> np.ndarray:
    """The pixels of the JPEG file ``data``, as ``np.asarray(PIL.Image.open)``
    gives them (see the module docstring)."""
    data = bytes(data)
    lib = _decoder()
    info = np.zeros(3, np.int64)
    err = ctypes.create_string_buffer(_ERR)
    if lib.jpeg_header(data, len(data), info.ctypes.data, err, _ERR):
        raise ValueError(err.value.decode())
    h, w, c = (int(v) for v in info)
    out = np.empty((h, w, c) if c > 1 else (h, w), np.uint8)
    if lib.jpeg_decode(data, len(data), out.ctypes.data, err, _ERR):
        raise ValueError(err.value.decode())
    return out


def encode_jpeg(arr: np.ndarray, quality: int = 75, subsampling=None) -> bytes:
    """The bytes PIL writes for ``Image.fromarray(arr).save(buf, "JPEG",
    quality=quality, subsampling=subsampling)``: ``arr`` (h, w) gray or
    (h, w, 3) RGB uint8, ``subsampling`` None (4:2:0, and 1 x 1 for gray),
    0/"4:4:4", 1/"4:2:2" or 2/"4:2:0"."""
    if arr.dtype != np.uint8 or not (arr.ndim == 2 or (arr.ndim == 3 and arr.shape[2] == 3)):
        raise ValueError(f"encode_jpeg takes (h, w) or (h, w, 3) uint8, not {arr.shape} {arr.dtype}")
    h, w = arr.shape[:2]
    if not (0 < h <= 65535 and 0 < w <= 65535):
        raise ValueError(f"a JPEG image is 1 to 65,535 pixels a side, not {h} x {w}")
    if subsampling is None:
        hs, vs = (1, 1) if arr.ndim == 2 else (2, 2)
    elif subsampling in SUBSAMPLING:
        hs, vs = SUBSAMPLING[subsampling]
    else:
        raise ValueError(f"subsampling={subsampling!r}: take None, 0, 1, 2, '4:4:4', '4:2:2' "
                         f"or '4:2:0'")
    pixels = np.ascontiguousarray(arr)
    lib = _encoder()
    ptr = ctypes.c_void_p()
    err = ctypes.create_string_buffer(_ERR)
    size = lib.jpeg_encode(pixels.ctypes.data, h, w, 1 if arr.ndim == 2 else 3, int(quality),
                           hs, vs, ctypes.byref(ptr), err, _ERR)
    if size < 0:
        raise ValueError(err.value.decode())
    try:
        return ctypes.string_at(ptr, size)
    finally:
        lib.jpeg_free(ptr)
