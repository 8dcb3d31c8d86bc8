"""TIFF decoding and encoding equal to PIL's, with no image library.

``decode_tiff_image(data)`` returns ``(pixels, mode, palette)`` of the first
page as PIL 12.1 gives it: ``np.asarray(PIL.Image.open(BytesIO(data)))``,
PIL's mode name and, for "P" and "PA", the colour map as (2 ** bits, 3)
uint8 RGB (the high byte of each 16-bit entry).  Both byte orders, strips and
tiles, planar configurations 1 and 2; compression none, PackBits, LZW and
Deflate / Adobe Deflate; predictor 1 and 2 (horizontal differencing);
photometric 0 (min-is-white), 1, 2 (RGB), 3 (palette) and 5 (CMYK) at the
bit depths and extra samples PIL's ``OPEN_INFO`` table maps (1, 2, 4, 8 and
16 bits; "1", "L", "I;16", "I;16B", "LA", "RGB", "RGBA", "P", "PA",
"CMYK").  Anything else raises ``ValueError`` naming its compression,
photometric or layout (JPEG-in-TIFF, CCITT, floating point, ...).

PIL reads an uncompressed file with its own raw decoder, a compressed one
through libtiff, and so does this: uncompressed rows are read from each
strip's or tile's offset while the file lasts (the rows a cut file lacks are
0, as under the JAX package's ``ImageFile.LOAD_TRUNCATED_IMAGES``; the
layers of a planar-2 file take PIL's per-band raw modes, the first letter of
its raw mode each); a compressed strip or tile is read by its byte count and
must inflate whole, or the file raises, as libtiff's read error makes PIL
raise under that flag too.  LZW and PackBits are decoded by
``csrc/tiff_decode.cpp``, built with the host C++ compiler at the first
decode (``ops/build.py``; a failed build raises), Deflate by ``zlib``.

``encode_tiff(arr)`` writes the bytes of PIL's ``save`` for an (h, w, 3)
uint8 RGB array: little-endian, one uncompressed strip.
"""

import ctypes
import struct
import zlib
from functools import lru_cache

import numpy as np

from ifseg_torch.data.png import unpack_bits, words16
from ifseg_torch.ops import build

SOURCE = "tiff_decode"
SIGNATURES = (b"II*\x00", b"MM\x00*")
_NAMES = {1: "none", 2: "CCITT RLE", 3: "CCITT Group 3", 4: "CCITT Group 4", 5: "LZW",
          6: "old-style JPEG", 7: "JPEG", 8: "Adobe Deflate", 32771: "CCITT RLEW",
          32773: "PackBits", 32809: "ThunderScan", 32946: "Deflate", 34676: "SGILog",
          34677: "SGILog24", 34925: "LZMA", 50000: "Zstd", 50001: "WebP"}
_PHOTOMETRIC = {0: "min-is-white", 1: "min-is-black", 2: "RGB", 3: "palette", 4: "mask",
                5: "CMYK", 6: "YCbCr", 8: "CIELab"}
# (byte order, photometric, sample format, fill order, bits, extra samples) ->
# (mode, raw mode): the part of PIL's TiffImagePlugin.OPEN_INFO this reads
_OPEN_INFO = {}
for _bo in ("II", "MM"):
    for _fo, _r in ((1, ""), (2, "R")):
        _OPEN_INFO.update({
            (_bo, 0, (1,), _fo, (1,), ()): ("1", "1;I" + _r),
            (_bo, 1, (1,), _fo, (1,), ()): ("1", "1" + (";R" if _r else "")),
            (_bo, 0, (1,), _fo, (2,), ()): ("L", "L;2I" + _r),
            (_bo, 1, (1,), _fo, (2,), ()): ("L", "L;2" + _r),
            (_bo, 0, (1,), _fo, (4,), ()): ("L", "L;4I" + _r),
            (_bo, 1, (1,), _fo, (4,), ()): ("L", "L;4" + _r),
            (_bo, 0, (1,), _fo, (8,), ()): ("L", "L;I" + _r),
            (_bo, 1, (1,), _fo, (8,), ()): ("L", "L" + (";R" if _r else "")),
            (_bo, 2, (1,), _fo, (8, 8, 8), ()): ("RGB", "RGB" + (";R" if _r else "")),
            (_bo, 3, (1,), _fo, (1,), ()): ("P", "P;1" + _r),
            (_bo, 3, (1,), _fo, (2,), ()): ("P", "P;2" + _r),
            (_bo, 3, (1,), _fo, (4,), ()): ("P", "P;4" + _r),
        })
    _OPEN_INFO.update({
        (_bo, 1, (2,), 1, (8,), ()): ("L", "L"),
        (_bo, 1, (1,), 1, (8, 8), (2,)): ("LA", "LA"),
        (_bo, 2, (1,), 1, (8, 8, 8, 8), ()): ("RGBA", "RGBA"),
        (_bo, 2, (1,), 1, (8, 8, 8, 8), (0,)): ("RGB", "RGBX"),
        (_bo, 2, (1,), 1, (8, 8, 8, 8, 8), (0, 0)): ("RGB", "RGBXX"),
        (_bo, 2, (1,), 1, (8, 8, 8, 8, 8, 8), (0, 0, 0)): ("RGB", "RGBXXX"),
        (_bo, 2, (1,), 1, (8, 8, 8, 8), (1,)): ("RGBA", "RGBa"),
        (_bo, 2, (1,), 1, (8, 8, 8, 8, 8), (1, 0)): ("RGBA", "RGBaX"),
        (_bo, 2, (1,), 1, (8, 8, 8, 8, 8, 8), (1, 0, 0)): ("RGBA", "RGBaXX"),
        (_bo, 2, (1,), 1, (8, 8, 8, 8), (2,)): ("RGBA", "RGBA"),
        (_bo, 2, (1,), 1, (8, 8, 8, 8, 8), (2, 0)): ("RGBA", "RGBAX"),
        (_bo, 2, (1,), 1, (8, 8, 8, 8, 8, 8), (2, 0, 0)): ("RGBA", "RGBAXX"),
        (_bo, 2, (1,), 1, (8, 8, 8, 8), (999,)): ("RGBA", "RGBA"),
        (_bo, 3, (1,), 1, (8,), ()): ("P", "P"),
        (_bo, 3, (1,), 1, (8, 8), (0,)): ("P", "PX"),
        (_bo, 3, (1,), 1, (8, 8), (2,)): ("PA", "PA"),
        (_bo, 3, (1,), 2, (8,), ()): ("P", "P;R"),
        (_bo, 5, (1,), 1, (8, 8, 8, 8), ()): ("CMYK", "CMYK"),
        (_bo, 5, (1,), 1, (8, 8, 8, 8, 8), (0,)): ("CMYK", "CMYKX"),
        (_bo, 5, (1,), 1, (8, 8, 8, 8, 8, 8), (0, 0)): ("CMYK", "CMYKXX"),
        (_bo, 6, (1,), 1, (8,), ()): ("L", "L"),
    })
    _e = "L" if _bo == "II" else "B"
    _OPEN_INFO.update({
        (_bo, 2, (1,), 1, (16, 16, 16), ()): ("RGB", f"RGB;16{_e}"),
        (_bo, 2, (1,), 1, (16, 16, 16, 16), ()): ("RGBA", f"RGBA;16{_e}"),
        (_bo, 2, (1,), 1, (16, 16, 16, 16), (0,)): ("RGB", f"RGBX;16{_e}"),
        (_bo, 2, (1,), 1, (16, 16, 16, 16), (1,)): ("RGBA", f"RGBa;16{_e}"),
        (_bo, 2, (1,), 1, (16, 16, 16, 16), (2,)): ("RGBA", f"RGBA;16{_e}"),
        (_bo, 5, (1,), 1, (16, 16, 16, 16), ()): ("CMYK", f"CMYK;16{_e}"),
    })
_OPEN_INFO.update({
    ("II", 0, (1,), 1, (16,), ()): ("I;16", "I;16"),
    ("II", 1, (1,), 1, (16,), ()): ("I;16", "I;16"),
    ("MM", 1, (1,), 1, (16,), ()): ("I;16B", "I;16B"),
    ("II", 1, (1,), 2, (16,), ()): ("I;16", "I;16R"),
})
# the tag numbers read, and their defaults
_TAGS = dict(width=256, height=257, bits=258, compression=259, photometric=262, fill=266,
             strips=273, orientation=274, spp=277, rows=278, strip_counts=279, planar=284,
             predictor=317, colormap=320, tile_w=322, tile_h=323, tiles=324, tile_counts=325,
             extra=338, sample_format=339)
# IFD field types: (struct code, size)
_TYPES = {1: ("B", 1), 2: ("B", 1), 3: ("H", 2), 4: ("I", 4), 5: ("II", 8), 6: ("b", 1),
          7: ("B", 1), 8: ("h", 2), 9: ("i", 4), 10: ("ii", 8), 11: ("f", 4), 12: ("d", 8),
          13: ("I", 4), 16: ("Q", 8), 17: ("q", 8), 18: ("Q", 8)}


@lru_cache(maxsize=None)
def _codecs():
    lib = build.load(SOURCE)
    for fn in (lib.tiff_lzw, lib.tiff_packbits):
        fn.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64]
        fn.restype = ctypes.c_int64
    return lib


def load():
    """Build (if need be) and load the LZW and PackBits decoders now."""
    _codecs()


def _ifd(data: bytes):
    """{tag: tuple of values} of the first IFD, and the byte order."""
    if len(data) < 8 or data[:4] not in SIGNATURES:
        raise ValueError("not a TIFF file" if data[:4] not in SIGNATURES
                         else "truncated TIFF: the header is cut off")
    e = "<" if data[:2] == b"II" else ">"
    (at,) = struct.unpack_from(e + "I", data, 4)
    if at + 2 > len(data):
        raise ValueError("truncated TIFF: the first IFD is cut off")
    (count,) = struct.unpack_from(e + "H", data, at)
    if at + 2 + 12 * count > len(data):
        raise ValueError("truncated TIFF: the first IFD is cut off")
    tags = {}
    for i in range(count):
        tag, typ, n, _ = struct.unpack_from(e + "HHI4s", data, at + 2 + 12 * i)
        if typ not in _TYPES:
            continue  # PIL skips a field of an unknown type
        code, size = _TYPES[typ]
        where = at + 2 + 12 * i + 8
        if size * n > 4:
            (where,) = struct.unpack_from(e + "I", data, where)
            if where + size * n > len(data):
                continue  # PIL drops a field whose values lie past the end
        vals = struct.unpack_from(e + code * n, data, where)
        if typ == 2:
            vals = (bytes(vals).split(b"\0")[0],)
        tags[tag] = vals
    return tags, data[:2].decode()


def _tag(tags, name, default=None):
    return tags.get(_TAGS[name], default)


def _one(tags, name, default=None):
    v = _tag(tags, name)
    return v[0] if v else default


_REVERSED = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)


def _reverse_bits(b: np.ndarray) -> np.ndarray:
    """Each byte with its bits in the other order (fill order 2)."""
    return _REVERSED[b]


def _unpack(rows: np.ndarray, raw: str, width: int):
    """(h, row bytes) uint8 rows as PIL's unpacker ``raw`` gives the pixels."""
    h = rows.shape[0]
    if raw.endswith("R") and not raw.startswith("I;16"):
        rows = _reverse_bits(rows)
        raw = raw[:-1].rstrip(";")
    if raw.startswith(("1", "L;2", "L;4", "P;1", "P;2", "P;4")):
        depth = 1 if raw[0] == "1" else int(raw[2])
        s = unpack_bits(rows, depth, width)
        if raw[0] == "1":
            return s.astype(bool) if raw == "1" else s == 0
        if raw[0] == "L":
            s = s * np.uint8(0x55 if depth == 2 else 0x11)
            return np.ascontiguousarray(255 - s if raw.endswith("I") else s)
        return s
    if raw in ("L", "L;I", "P"):
        s = rows[:, :width]
        return np.ascontiguousarray(255 - s if raw == "L;I" else s)
    if raw.startswith("I;16"):
        s = words16(rows, width, "<u2" if raw == "I;16" else ">u2")
        if raw == "I;16R":  # PIL reverses the bits of each byte, then reads LE
            s = words16(_reverse_bits(rows), width, "<u2")
        return np.ascontiguousarray(s.astype(np.uint16) if raw != "I;16B" else s)
    base, _, wide = raw.partition(";16")
    n = len(base)
    if wide:  # 16 bits a sample: PIL keeps the high byte
        v = words16(rows, n * width, "<u2" if wide == "L" else ">u2")
        s = (v.reshape(h, width, n) >> 8).astype(np.uint8)
    else:
        s = rows[:, :n * width].reshape(h, width, n)
    keep = [i for i, c in enumerate(base) if c != "X"]
    s = np.ascontiguousarray(s[:, :, keep])
    if "a" in base:  # premultiplied alpha: PIL's unpackRGBa
        a = s[:, :, 3:4].astype(np.int64)
        rgb = s[:, :, :3].astype(np.int64)
        scaled = np.minimum(rgb * 255 // np.maximum(a, 1), 255)
        un = np.where(a == 0, 0, np.where(a == 255, rgb, scaled))
        s = np.concatenate([un, a], axis=2).astype(np.uint8)
    return s


def _layout(tags, order: str):
    """(mode, raw mode, width, height, bits, planar, compression, predictor)."""
    compression = _one(tags, "compression", 1)
    if compression not in (1, 5, 8, 32773, 32946):
        raise ValueError(f"TIFF compression {_NAMES.get(compression, compression)} is not "
                         f"supported (none, PackBits, LZW and Deflate only)")
    photo = _one(tags, "photometric", 0)
    if photo not in (0, 1, 2, 3, 5):
        raise ValueError(f"TIFF photometric {_PHOTOMETRIC.get(photo, photo)} is not supported "
                         f"(min-is-white, min-is-black, RGB, palette and CMYK only)")
    if _one(tags, "orientation", 1) in (5, 6, 7, 8):
        raise ValueError("TIFF files with a transposing orientation are not supported")
    width, height = _one(tags, "width"), _one(tags, "height")
    if width is None or height is None:
        raise ValueError("broken TIFF: missing dimensions")
    sample_format = tuple(_tag(tags, "sample_format", (1,)))
    if len(sample_format) > 1 and max(sample_format) == min(sample_format) == 1:
        sample_format = (1,)
    if 3 in sample_format:
        raise ValueError("floating-point TIFF files are not supported")
    bits = tuple(_tag(tags, "bits", (1,)))
    extra = tuple(_tag(tags, "extra", ()))
    spp = _one(tags, "spp", 1)
    if spp < len(bits):
        bits = bits[:spp]
    elif spp > len(bits) and len(bits) == 1:
        bits = bits * spp
    if len(bits) != spp:
        raise ValueError("broken TIFF: unknown data organization")
    fill = _one(tags, "fill", 1)
    key = (order, photo, sample_format, fill, bits, extra)
    if key not in _OPEN_INFO:
        raise ValueError(f"TIFF {_PHOTOMETRIC.get(photo, photo)} at {bits} bits, sample format "
                         f"{sample_format}, extra samples {extra} is not a layout PIL reads")
    mode, raw = _OPEN_INFO[key]
    predictor = _one(tags, "predictor", 1)
    if compression != 1:
        if fill == 2:  # libtiff undoes the fill order: PIL takes the order-1 raw mode
            mode, raw = _OPEN_INFO[key[:3] + (1,) + key[4:]]
    # libtiff applies a predictor to LZW and Deflate data only; PIL's raw
    # decoder and libtiff's PackBits codec ignore the tag
    if compression in (5, 8, 32946):
        if predictor not in (1, 2):
            raise ValueError(f"TIFF predictor {predictor} is not supported (1 and 2 only)")
        if predictor == 2 and bits[0] not in (8, 16):
            raise ValueError(f"TIFF horizontal differencing at {bits[0]} bits is not supported")
    else:
        predictor = 1
    return (mode, raw, width, height, bits, _one(tags, "planar", 1), compression, predictor,
            fill)


def _decompress(lib, compression: int, raw: bytes, need: int) -> bytes:
    if compression in (8, 32946):
        try:
            out = zlib.decompressobj().decompress(raw, need)
        except zlib.error as e:
            raise ValueError(f"broken TIFF: Deflate data ({e})") from None
    else:
        buf = ctypes.create_string_buffer(need)
        fn = lib.tiff_lzw if compression == 5 else lib.tiff_packbits
        got = fn(raw, len(raw), buf, need)
        if got < 0:
            raise ValueError(f"broken TIFF: {_NAMES[compression]} data")
        out = buf.raw[:got]
    if len(out) < need:
        raise ValueError(f"truncated TIFF: {_NAMES[compression]} data ends early")
    return out


def _undo_predictor(block: np.ndarray, bits: int, samples: int, order: str) -> np.ndarray:
    """Horizontal differencing undone on (rows, row bytes) of file-order data."""
    if bits == 8:
        h, n = block.shape
        v = block[:, : n // samples * samples].reshape(h, -1, samples)
        out = block.copy()
        out[:, : v.shape[1] * samples] = np.cumsum(v, axis=1, dtype=np.uint8).reshape(h, -1)
        return out
    dt = "<u2" if order == "II" else ">u2"
    h, n = block.shape
    v = block[:, : n // (2 * samples) * 2 * samples].copy().view(dt).reshape(h, -1, samples)
    acc = np.cumsum(v.astype(np.uint64), axis=1) & 0xFFFF
    out = block.copy()
    out[:, : v.shape[1] * samples * 2] = acc.astype(dt).reshape(h, -1).view(np.uint8)
    return out


def decode_tiff_image(data: bytes):
    """(pixels, PIL's mode, palette or None) of the first page (see the
    module docstring)."""
    data = bytes(data)
    tags, order = _ifd(data)
    mode, raw, width, height, bits, planar, compression, predictor, fill = _layout(tags, order)
    tiled = _TAGS["tiles"] in tags
    if tiled:
        offsets, counts = _tag(tags, "tiles"), _tag(tags, "tile_counts", ())
        tw, th = _one(tags, "tile_w"), _one(tags, "tile_h")
        if not tw or not th:
            raise ValueError("broken TIFF: invalid tile dimensions")
    elif _TAGS["strips"] in tags:
        offsets, counts = _tag(tags, "strips"), _tag(tags, "strip_counts", ())
        tw, th = width, _one(tags, "rows", height)
    else:
        raise ValueError("broken TIFF: no strips or tiles")
    layers = len(bits) if planar == 2 else 1
    layer_bits = bits[0] if planar == 2 else sum(bits)
    channels = {"LA": 2, "PA": 2, "RGB": 3, "RGBA": 4, "CMYK": 4}.get(mode)
    dtype = {"1": bool, "I;16": np.uint16, "I;16B": np.dtype(">u2")}.get(mode, np.uint8)
    pixels = np.zeros((height, width, channels) if channels else (height, width), dtype)
    # the tiles in PIL's order: across, down, then layer by layer
    places = [(layer, y, x) for layer in range(layers) for y in range(0, height, th)
              for x in range(0, width, tw)]
    if compression == 1 and tw == width and th == height and planar != 2:  # one strip
        places, offsets = places[-1:], offsets[-1:]
    lib = _codecs() if compression in (5, 32773) else None
    for i, (layer, y, x) in enumerate(places):
        if i >= len(offsets):
            break
        x1, y1 = min(x + tw, width), min(y + th, height)
        row_bytes = (tw * layer_bits + 7) // 8  # in the file (a tile's whole width)
        use = ((x1 - x) * layer_bits + 7) // 8  # unpacked
        if compression == 1:
            body = data[offsets[i]:] if offsets[i] < len(data) else b""
            rows = (len(body) - use + row_bytes) // row_bytes if len(body) >= use else 0
            rows = min(rows, y1 - y)
            if rows <= 0:
                continue
            block = np.frombuffer(body[:rows * row_bytes].ljust(rows * row_bytes, b"\0"),
                                  np.uint8).reshape(rows, row_bytes)
        else:
            strip_rows = th if tiled else min(th, height - y)
            need = strip_rows * row_bytes
            count = counts[i] if i < len(counts) else 0
            chunk = data[offsets[i]:offsets[i] + count]
            if len(chunk) < count:
                raise ValueError("truncated TIFF: a strip or tile is cut off")
            if fill == 2:
                chunk = _reverse_bits(np.frombuffer(chunk, np.uint8)).tobytes()
            block = np.frombuffer(_decompress(lib, compression, chunk, need), np.uint8)
            block = block.reshape(strip_rows, row_bytes)
            if predictor == 2:
                block = _undo_predictor(block, bits[0], 1 if planar == 2 else len(bits), order)
            rows = y1 - y
            block = block[:rows]
        if planar == 2 and (layers > 1 or compression == 1):
            px = _band(block[:, :use], raw, layer, x1 - x)
            if pixels.ndim == 3:
                pixels[y:y + rows, x:x1, layer] = px
            else:
                pixels[y:y + rows, x:x1] = px
        else:
            pixels[y:y + rows, x:x1] = _unpack(block[:, :use], raw, x1 - x)
    if mode in ("P", "PA"):
        cmap = np.asarray(_tag(tags, "colormap", ()), np.int64)
        if not len(cmap) or len(cmap) % 3:
            raise ValueError("broken TIFF: a palette image without a colour map")
        table = (cmap // 256).astype(np.uint8).reshape(3, -1).T
        return pixels, mode, np.ascontiguousarray(table)
    return pixels, mode, None


def _band(block: np.ndarray, raw: str, layer: int, width: int):
    """One layer of a planar-2 file with several layers, or of an
    uncompressed one: PIL's band raw mode, the raw mode's letter at the
    layer (so "L;I" reads as "L"), 8 bits a sample."""
    letter = raw[layer] if layer < len(raw) else "?"
    if letter == "1":
        return _unpack(block, "1", width)
    if letter in "RGBACMYKLP" and len(block) and block.shape[1] >= width:
        return block[:, :width]
    raise ValueError(f"TIFF planar configuration 2 with PIL raw mode {raw} is not supported")


def encode_tiff(arr: np.ndarray) -> bytes:
    """The bytes of PIL's ``Image.fromarray(arr).save(buf, "TIFF")`` for an
    (h, w, 3) uint8 RGB array."""
    if arr.dtype != np.uint8 or arr.ndim != 3 or arr.shape[2] != 3:
        raise ValueError(f"encode_tiff takes (h, w, 3) uint8, not {arr.shape} {arr.dtype}")
    h, w = arr.shape[:2]
    # one strip at 140: the header (8), the IFD (2 + 10 x 12 + 4), BitsPerSample (6)
    entries = ((256, 4, w), (257, 4, h), (258, 3, None), (259, 3, 1), (262, 3, 2), (273, 4, 140),
               (277, 3, 3), (278, 4, h), (279, 4, 3 * w * h), (284, 3, 1))
    ifd = struct.pack("<H", len(entries))
    for tag, typ, value in entries:
        if value is None:  # BitsPerSample (8, 8, 8): 6 bytes after the IFD
            ifd += struct.pack("<HHII", tag, typ, 3, 8 + 2 + 12 * len(entries) + 4)
        elif typ == 3:
            ifd += struct.pack("<HHIHH", tag, typ, 1, value, 0)
        else:
            ifd += struct.pack("<HHII", tag, typ, 1, value)
    head = b"II*\x00" + struct.pack("<I", 8) + ifd + struct.pack("<IHHH", 0, 8, 8, 8)
    return head + np.ascontiguousarray(arr).tobytes()
