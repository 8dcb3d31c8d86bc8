"""SGI image files decoded as PIL 12.1's ``SgiImagePlugin`` decodes them, and
an RGB image encoded as its ``save`` encodes it, with numpy and one host C++
loop.

``decode_sgi_image(data)`` returns ``(pixels, mode, palette)``:
``np.asarray(PIL.Image.open(BytesIO(data)))``, PIL's mode and None.  The
magic number 474 starts the 512-byte header; (bytes a sample, dimension,
channels) picks the mode: 1, 2 or 3 dimensions with 1 channel "L", 3 with 3
"RGB", 3 with 4 "RGBA"; any other layout raises, as in PIL.  A 16-bit image
(2 bytes a sample) arrives in the same modes, each sample's high byte, as
PIL's ``L;16B`` unpackers give it.  Rows are bottom-up, channels planar.

Raw files keep, for each channel, the whole rows the file holds, the others
0 (PIL's raw decoder under the JAX package's ``LOAD_TRUNCATED_IMAGES``); a
raw 16-bit file cut short raises, as PIL's ``SGI16`` decoder does.  RLE
files (``csrc/rle_decode.cpp``, ``sgi_rle``) follow ``SgiRleDecode.c``: each
row of each channel at the offset and with the length of the file's tables,
the row buffer carried over between rows, the image ending at the first bad
row (rows after it 0) or, where the tables do not fit the file, all 0.

``encode_sgi(arr, name)`` writes what ``Image.fromarray(arr).save(path)``
writes to a ``.bw``, ``.rgb``, ``.rgba`` or ``.sgi`` file named ``name`` for
an (h, w, 3) uint8 RGB array: raw, 8 bits, the name's stem in the header.
"""

import ctypes
import os
import struct
from functools import lru_cache

import numpy as np

from ifseg_torch.data.png import check_pixels
from ifseg_torch.ops import build

SOURCE = "rle_decode"
EXTENSIONS = (".bw", ".rgb", ".rgba", ".sgi")
# (bytes a sample, dimension, channels) -> PIL's mode
_MODES = {(1, 1, 1): "L", (1, 2, 1): "L", (2, 1, 1): "L", (2, 2, 1): "L", (1, 3, 3): "RGB",
          (2, 3, 3): "RGB", (1, 3, 4): "RGBA", (2, 3, 4): "RGBA"}


def is_sgi(data: bytes) -> bool:
    """PIL's ``_accept``: the big-endian magic number 474."""
    return data[:2] == b"\x01\xda"


@lru_cache(maxsize=None)
def _rle():
    fn = build.load(SOURCE).sgi_rle
    fn.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
                   ctypes.c_int64, ctypes.c_int64, ctypes.c_int64]
    fn.restype = ctypes.c_int64
    return fn


def load():
    """Build (if need be) and load the RLE loop now, not at the first decode."""
    _rle()


def decode_sgi_image(data: bytes):
    """(pixels, PIL's mode, None) of an SGI file (see the module docstring)."""
    data = bytes(data)
    if not is_sgi(data):
        raise ValueError("not an SGI file")
    if len(data) < 12:
        raise ValueError("truncated SGI: the header is cut off")
    compression, bpc = data[2], data[3]
    dimension, width, height, bands = struct.unpack_from(">HHHH", data, 4)
    mode = _MODES.get((bpc, dimension, bands))
    if mode is None:
        raise ValueError(f"SGI layout of {bpc} bytes a sample, dimension {dimension} and "
                         f"{bands} channels is not one PIL reads")
    if compression not in (0, 1):
        raise ValueError(f"SGI compression {compression} is not one PIL reads")
    check_pixels(width, height, "SGI")
    body = data[512:]
    if compression == 1:
        words = np.zeros((height, width * bands * bpc), np.uint8)
        got = _rle()(body, len(body), words.ctypes.data, width, height, bands, bpc)
        words[max(got, 0):] = 0
        # the rows in file order, interleaved; a 16-bit sample's high byte
        pixels = words.reshape(height, width, bands, bpc)[::-1, :, :, 0]
        return np.ascontiguousarray(pixels[:, :, 0] if mode == "L" else pixels), mode, None
    page = width * height * bpc
    if bpc == 2 and len(body) < bands * page:
        raise ValueError("truncated SGI: not enough image data")
    planes = np.zeros((bands, height, width), np.uint8)
    stride = width * bpc
    for c in range(bands):
        chunk = body[c * page:(c + 1) * page]
        whole = min(height, len(chunk) // stride) if stride else 0
        rows = np.frombuffer(chunk, np.uint8, count=whole * stride).reshape(whole, width, bpc)
        planes[c, :whole] = rows[:, :, 0]
    pixels = planes[:, ::-1].transpose(1, 2, 0)
    return np.ascontiguousarray(pixels[:, :, 0] if mode == "L" else pixels), mode, None


def encode_sgi(arr: np.ndarray, name: str = "") -> bytes:
    """The bytes of PIL's ``Image.fromarray(arr).save(path)`` for an (h, w, 3)
    uint8 RGB array and an SGI ``path`` whose file name is ``name``."""
    if arr.dtype != np.uint8 or arr.ndim != 3 or arr.shape[2] != 3:
        raise ValueError(f"encode_sgi takes (h, w, 3) uint8, not {arr.shape} {arr.dtype}")
    h, w = arr.shape[:2]
    stem = os.path.splitext(os.path.basename(name))[0].encode("ascii", "ignore")
    head = struct.pack(">hBBHHHHll4s79ssl404s", 474, 0, 1, 3, w, h, 3, 0, 255, b"", stem, b"",
                       0, b"")
    return head + np.ascontiguousarray(arr[::-1].transpose(2, 0, 1)).tobytes()
