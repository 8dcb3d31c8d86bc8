"""DirectDraw Surface (DDS) files decoded as PIL 12.1's ``DdsImagePlugin``
decodes them, and an RGB image encoded as its ``save`` encodes it, with
numpy and one host C++ loop.

``decode_dds_image(data)`` returns ``(pixels, mode, palette)``:
``np.asarray(PIL.Image.open(BytesIO(data)))``, PIL's mode and, for mode "P",
the palette ((256, 4) uint8 RGBA).  The 124-byte header's pixel format picks
the layout, in PIL's order:

  RGB flag        "RGB", or "RGBA" with the alpha flag: each pixel's
                  ``bits / 8`` little-endian bytes split by the header's
                  masks, each field ``int(field / mask_max * 255)``
  LUMINANCE flag  "L" at 8 bits, "LA" at 16 with the alpha flag
  PALETTEINDEXED8 "P", a 1,024-byte RGBA palette before the indices
  FOURCC          DXT1 / BC1, DXT3 / BC2, DXT5 / BC3 "RGBA"; BC4U / ATI1
                  "L"; BC5U / ATI2 and BC5S "RGB"; and through a DX10
                  header the same (BC1-BC5 typeless or unorm, BC5 snorm),
                  BC6H unsigned and signed (DXGI 95, 96) "RGB", BC7
                  typeless, unorm and unorm sRGB (97-99; the sRGB variant
                  the same pixels, PIL only sets its gamma) "RGBA", and
                  R8G8B8A8 "RGBA"

The 4 x 4 blocks are decoded by ``csrc/rle_decode.cpp`` (``bcn``) as
``BcnDecode.c`` decodes them: BC7's 8 modes (a block of no mode opaque
black) with their partitions, anchors, p-bits, rotations and index
selection; BC6H's 14 modes with their delta end points (not sign-extended
again after the delta, as in PIL), a truncating interpolation and each half
float clamped to 0..1 and truncated to 8 bits, its 4 reserved modes black.
What PIL refuses (BC6H typeless, BC4 signed, the sRGB BC1-BC3 codes, ...)
raises ``ValueError``.  A cut
file keeps, as PIL reads it under the JAX package's
``LOAD_TRUNCATED_IMAGES``, its whole rows (raw layouts), its whole blocks
(block layouts) or the bytes it holds, the rest read as 0 (the RGB flag's
masks).

``encode_dds(arr)`` writes what ``Image.fromarray(arr).save(f, "DDS")``
writes for an (h, w, 3) uint8 RGB array: uncompressed 24-bit BGR.
"""

import ctypes
import struct
from functools import lru_cache

import numpy as np

from ifseg_torch.data.png import check_pixels, whole_rows
from ifseg_torch.ops import build

SOURCE = "rle_decode"
SIGNATURE = b"DDS "
_ALPHAPIXELS, _FOURCC, _PAL8, _RGB, _LUMINANCE = 0x1, 0x4, 0x20, 0x40, 0x20000
# FOURCC -> (PIL's mode, the bcn kind: 1-5 BC1-BC5, -5 BC5 signed, 6 and -6 BC6H
# unsigned and signed, 7 BC7)
_FOURCCS = {b"DXT1": ("RGBA", 1), b"DXT3": ("RGBA", 2), b"DXT5": ("RGBA", 3),
            b"BC4U": ("L", 4), b"ATI1": ("L", 4), b"BC5S": ("RGB", -5), b"BC5U": ("RGB", 5),
            b"ATI2": ("RGB", 5)}
# DX10's DXGI format -> (mode, kind; 0 for raw RGBA)
_DXGI = {70: ("RGBA", 1), 71: ("RGBA", 1), 73: ("RGBA", 2), 74: ("RGBA", 2), 76: ("RGBA", 3),
         77: ("RGBA", 3), 79: ("L", 4), 80: ("L", 4), 82: ("RGB", 5), 83: ("RGB", 5),
         84: ("RGB", -5), 95: ("RGB", 6), 96: ("RGB", -6), 97: ("RGBA", 7), 98: ("RGBA", 7),
         99: ("RGBA", 7), 27: ("RGBA", 0), 28: ("RGBA", 0), 29: ("RGBA", 0)}


@lru_cache(maxsize=None)
def _bcn():
    fn = build.load(SOURCE).bcn
    fn.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
                   ctypes.c_int64, ctypes.c_int64]
    fn.restype = ctypes.c_int64
    return fn


def load():
    """Build (if need be) and load the block loop now, not at the first decode."""
    _bcn()


def _masked(body: bytes, width: int, height: int, bits: int, masks) -> np.ndarray:
    """``DdsRgbDecoder``: (h, w, len(masks)) uint8 of ``bits / 8``-byte
    little-endian pixels, the bytes past the end read as 0."""
    size = bits // 8
    n = width * height
    raw = np.frombuffer(body[:n * size].ljust(n * size, b"\0"), np.uint8).reshape(n, size)
    values = None
    out = np.zeros((n, len(masks)), np.uint8)
    for c, mask in enumerate(masks):
        if not mask:
            continue
        shift = (mask & -mask).bit_length() - 1
        top = mask >> shift
        if top == 255 and shift % 8 == 0 and shift // 8 < size:  # a whole byte: itself
            out[:, c] = raw[:, shift // 8]
            continue
        if values is None:
            values = np.zeros(n, np.uint64)
            for i in range(min(size, 4)):  # the 32-bit masks see the low four bytes
                values |= raw[:, i].astype(np.uint64) << np.uint64(8 * i)
        field = (values & np.uint64(mask)) >> np.uint64(shift)
        if top < 1 << 16:  # a table of the float rule over the field's values
            table = ((np.arange(top + 1, dtype=np.float64) / top) * 255).astype(np.uint8)
            out[:, c] = table[field.astype(np.int64)]
        else:
            out[:, c] = ((field.astype(np.float64) / top) * 255).astype(np.int64)
    return out.reshape(height, width, len(masks))


def decode_dds_image(data: bytes):
    """(pixels, PIL's mode, palette or None) of a DDS file (see the module
    docstring)."""
    data = bytes(data)
    if data[:4] != SIGNATURE:
        raise ValueError("not a DDS file")
    if len(data) < 128:
        raise ValueError("truncated DDS: the header is cut off")
    size = struct.unpack_from("<I", data, 4)[0]
    if size != 124:
        raise ValueError(f"DDS header size {size} is not 124")
    height, width = struct.unpack_from("<II", data, 12)
    pf_flags, fourcc, bits = struct.unpack_from("<I4sI", data, 80)
    check_pixels(width, height, "DDS")
    pos, palette = 128, None
    if pf_flags & _RGB:
        count = 4 if pf_flags & _ALPHAPIXELS else 3
        masks = struct.unpack_from(f"<{count}I", data, 92)
        pixels = _masked(data[pos:], width, height, bits, masks)
        return pixels, "RGBA" if count == 4 else "RGB", None
    if pf_flags & _LUMINANCE:
        if bits == 8:
            return whole_rows(data[pos:], width, height, 1)[:, :, 0], "L", None
        if bits == 16 and pf_flags & _ALPHAPIXELS:
            return whole_rows(data[pos:], width, height, 2), "LA", None
        raise ValueError(f"DDS luminance at {bits} bits is not one PIL reads")
    if pf_flags & _PAL8:
        table = data[pos:pos + 1024]
        pos += len(table)
        palette = np.frombuffer(table[:len(table) // 4 * 4], np.uint8).reshape(-1, 4).copy()
        return whole_rows(data[pos:], width, height, 1)[:, :, 0], "P", palette
    if not pf_flags & _FOURCC:
        raise ValueError(f"DDS pixel format flags {pf_flags:#x} are not ones PIL reads")
    if fourcc == b"DX10":
        if len(data) < 132:
            raise ValueError("truncated DDS: the DX10 header is cut off")
        dxgi = struct.unpack_from("<I", data, 128)[0]
        pos = 148
        if dxgi not in _DXGI:
            raise ValueError(f"DDS DXGI format {dxgi} is not one PIL reads")
        mode, kind = _DXGI[dxgi]
        if not kind:
            return whole_rows(data[pos:], width, height, 4), mode, None
    elif fourcc in _FOURCCS:
        mode, kind = _FOURCCS[fourcc]
    else:
        raise ValueError(f"DDS pixel format {fourcc!r} is not one PIL reads")
    rgba = np.zeros((height, width, 4), np.uint8)
    body = data[pos:]
    _bcn()(body, len(body), rgba.ctypes.data, width, height, kind)
    pixels = {"L": rgba[:, :, 0], "RGB": rgba[:, :, :3], "RGBA": rgba}[mode]
    return np.ascontiguousarray(pixels), mode, None


def encode_dds(arr: np.ndarray) -> bytes:
    """The bytes of PIL's ``Image.fromarray(arr).save(buf, "DDS")`` for an
    (h, w, 3) uint8 RGB array."""
    if arr.dtype != np.uint8 or arr.ndim != 3 or arr.shape[2] != 3:
        raise ValueError(f"encode_dds takes (h, w, 3) uint8, not {arr.shape} {arr.dtype}")
    h, w = arr.shape[:2]
    head = (SIGNATURE + struct.pack("<7I", 124, 0x100F, h, w, 3 * w, 0, 0) + b"\0" * 44
            + struct.pack("<4I", 32, _RGB, 0, 24) + struct.pack("<4I", 0xFF0000, 0xFF00, 0xFF, 0)
            + struct.pack("<5I", 0x1000, 0, 0, 0, 0))
    return head + np.ascontiguousarray(arr[:, :, ::-1]).tobytes()
