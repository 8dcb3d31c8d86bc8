"""PNG decoding and encoding with the standard library, numpy and one host
C++ loop.

``decode_png(data)`` returns what ``np.asarray(PIL.Image.open(BytesIO(data)))``
returns, bit for bit, for every PNG file, interlaced (Adam7) or not, a cut
one, or one with a row whose filter byte is not 0-4, as PIL reads it under
the JAX package's ``LOAD_TRUNCATED_IMAGES`` (``_chunks``; the rows not
inflated whole are 0, and so are the bad row and every row after it, in
its Adam7 pass and the later passes), so the port's data
pipeline depends on no image library:

  colour type 0, gray        -> (h, w) uint8 (PIL's mode "L"); at bit depth 1,
                                mode "1": (h, w) bool; at depths 2 and 4 the
                                samples scaled to 0..255 (x 0x55, x 0x11); at
                                depth 16, mode "I;16": (h, w) uint16
  colour type 2, RGB         -> (h, w, 3) uint8 (at depth 16, the high bytes)
  colour type 3, palette     -> (h, w) uint8 palette INDICES (PIL is not asked
                                to convert, and neither is this)
  colour type 4, gray+alpha  -> (h, w, 2) uint8 ("LA"); at depth 16, PIL's
                                "RGBA": (h, w, 4) gray, gray, gray, alpha, the
                                high bytes
  colour type 6, RGBA        -> (h, w, 4) uint8 (at depth 16, the high bytes)

``decode_png_rgb(data)`` returns what
``np.asarray(PIL.Image.open(BytesIO(data)).convert("RGB"))`` returns for the
same files: (h, w, 3) uint8, gray replicated to the three channels (1-bit
samples as 0 or 255, 16-bit ones clipped to 255 as PIL clips "I;16"), palette
indices looked up in the PLTE chunk (an index past its end reads black, as
PIL pads the palette), alpha dropped.  ``decode_png_image(data)`` returns the
pixels with PIL's mode name and, for a palette file, the palette ((n, 3)
uint8, or (n, 4) with the tRNS alpha).  ``encode_png(arr, mode, palette)``
writes a file in any of those modes: "1", "L", "P" (PLTE, and tRNS where the
palette has alpha), "I;16", "LA", "RGB" and "RGBA".

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
_COLOUR_TYPES = {0: (1, (1, 2, 4, 8, 16)), 2: (3, (8, 16)), 3: (1, (1, 2, 4, 8)),
                 4: (2, (8, 16)), 6: (4, (8, 16))}
# Adam7: (x0, y0, dx, dy) of the seven passes
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))
# encode_png's modes: (colour type, bit depth, samples a pixel)
_MODES = {"1": (0, 1, 1), "L": (0, 8, 1), "P": (3, 8, 1), "I;16": (0, 16, 1),
          "I;16B": (0, 16, 1), "I": (0, 16, 1), "LA": (4, 8, 2), "RGB": (2, 8, 3),
          "RGBA": (6, 8, 4)}


@lru_cache(maxsize=None)
def _lib():
    lib = build.load(SOURCE)
    lib.png_unfilter.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                                 ctypes.c_int64, ctypes.c_int64]
    lib.png_unfilter.restype = ctypes.c_int64
    lib.cmyk_to_rgb.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
    lib.cmyk_to_rgb.restype = None
    lib.lab_to_rgb.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                               ctypes.c_void_p, ctypes.c_int64]
    lib.lab_to_rgb.restype = None
    return lib


def load():
    """Build (if need be) and load the unfilter loop now, not at the first decode."""
    _lib()


def _chunks(data: bytes):
    """(type, body) of the chunks that PIL reads for the pixels, with the JAX
    package's ``ImageFile.LOAD_TRUNCATED_IMAGES = True``: the chunks before
    the image data (a cut one raises; the CRCs of the critical ones are
    checked, PIL skips the ancillary ones' under that flag), then the run of
    IDAT chunks, which PIL reads without their CRCs and which a cut file may
    end anywhere.  What follows holds no pixels; it is walked as PIL's
    ``load_end`` walks it, reading no CRC, up to IEND: there, and where the
    run of IDATs ends, a header cut after its length field raises unless that
    length is 0 (PIL reads a chunk of a type it cannot name), a whole header
    whose body is cut raises, and a header cut inside its length field ends
    the file quietly.  An IEND before any IDAT raises, as PIL's load does."""
    pos = 8
    stage = 0  # 0 before the image data, 1 in its run of IDATs, 2 after it
    while True:
        head = data[pos:pos + 8]
        if len(head) < 8:
            if stage and (len(head) < 4 or struct.unpack(">I", head[:4])[0] == 0):
                return
            raise ValueError("truncated PNG: a chunk header is cut off" if head
                             else "truncated PNG: no image data")
        length, ctype = struct.unpack(">I4s", head)
        end = pos + 12 + length
        if ctype == b"IDAT" and stage < 2:
            stage = 1
            yield ctype, data[pos + 8:min(end - 4, len(data))]
        elif ctype == b"IEND" and stage:
            return
        elif stage:
            stage = 2
            if end - 4 > len(data):
                raise ValueError(f"truncated PNG: chunk {ctype!r} is cut off")
        else:
            if end > len(data):
                raise ValueError(f"truncated PNG: chunk {ctype!r} is cut off")
            body = data[pos + 8:end - 4]
            (crc,) = struct.unpack(">I", data[end - 4:end])
            if not ctype[0] & 0x20 and zlib.crc32(ctype + body) != crc:
                raise ValueError(f"broken PNG: CRC mismatch in chunk {ctype!r}")
            if ctype == b"IEND":  # PIL has no tile: "cannot load this image"
                raise ValueError("broken PNG: IEND before any image data")
            yield ctype, body
        pos = end


def decode_png(data: bytes) -> np.ndarray:
    """The pixels of the PNG file ``data``, as ``np.asarray(PIL.Image.open)``
    gives them (see the module docstring)."""
    return _decode(data)[0]


def decode_png_image(data: bytes):
    """(pixels as ``decode_png`` gives them, PIL's mode, palette): the palette
    of a palette file as (n, 3) uint8 RGB, (n, 4) RGBA where a tRNS chunk
    gives alpha (entries past its end opaque); None for the other modes."""
    pixels, colour, palette, trns = _decode(data)
    if colour == 3:
        return pixels, "P", _palette_table(palette, trns)
    return pixels, _mode_of(pixels), None


def _mode_of(arr: np.ndarray):
    """PIL's mode for an array of a non-palette image, None if it has none."""
    if arr.ndim == 2:
        return {np.dtype(bool): "1", np.dtype(np.uint16): "I;16"}.get(arr.dtype, "L")
    return {2: "LA", 3: "RGB", 4: "RGBA"}.get(arr.shape[2]) if arr.ndim == 3 else None


def decode_png_rgb(data: bytes) -> np.ndarray:
    """The pixels of the PNG file ``data`` as (h, w, 3) uint8 RGB, as
    ``np.asarray(PIL.Image.open(...).convert("RGB"))`` gives them."""
    pixels, colour, palette, _ = _decode(data)
    return to_rgb(pixels, _palette_table(palette, None) if colour == 3 else None)


def to_rgb(pixels: np.ndarray, palette=None, mode=None) -> np.ndarray:
    """Decoded pixels as PIL's ``convert("RGB")`` gives them: palette indices
    ("P", or "PA" with its alpha) where ``palette``, an (n, 3) or (n, 4)
    table, is given, an index past its end black; for ``mode`` "CMYK" (an
    (h, w, 4) array) Pillow's ``cmyk2rgb``; for "LAB" LittleCMS's transform
    to sRGB (``data/lab.py``); for "YCbCr" Pillow's tables (``data/im.py``);
    otherwise as the array's shape and dtype say
    (gray, gray + alpha, RGB, RGBA, 1-bit, 16-bit, "I" int32 clipped to
    0..255, "F" float32 through PIL's ``f2l``: 0 at or below 0 and for NaN,
    255 at or above 255, truncated between)."""
    if mode == "LAB":
        from ifseg_torch.data.lab import lab_to_rgb  # lab.py loads this module's library

        return lab_to_rgb(pixels)
    if mode == "YCbCr":
        from ifseg_torch.data.im import ycbcr_to_rgb

        return ycbcr_to_rgb(pixels)
    if palette is not None:
        table = np.zeros((256, 3), np.uint8)
        entries = np.asarray(palette, np.uint8)[:256, :3]
        table[: len(entries)] = entries
        return np.take(table, pixels if pixels.ndim == 2 else pixels[:, :, 0], axis=0)
    if mode == "CMYK":  # Convert.c cmyk2rgb, in csrc/png_unfilter.cpp
        src = np.ascontiguousarray(pixels, np.uint8)
        out = np.empty(src.shape[:2] + (3,), np.uint8)
        _lib().cmyk_to_rgb(src.ctypes.data, out.ctypes.data, src.shape[0] * src.shape[1])
        return out
    if pixels.dtype == bool:
        pixels = pixels.astype(np.uint8) * np.uint8(255)
    elif pixels.dtype.kind == "u" and pixels.dtype.itemsize == 2:  # "I;16": PIL clips to 255
        pixels = np.minimum(pixels, 255).astype(np.uint8)
    elif pixels.dtype.kind == "i":  # "I"
        pixels = np.clip(pixels, 0, 255).astype(np.uint8)
    elif pixels.dtype.kind == "f":  # "F", Convert.c f2l
        v = np.nan_to_num(pixels.astype(np.float32), nan=0.0)
        pixels = np.clip(v, 0, 255).astype(np.uint8)
    if pixels.ndim == 2:
        return np.repeat(pixels[:, :, None], 3, axis=2)
    if pixels.shape[2] == 2:  # gray + alpha
        return np.repeat(pixels[:, :, :1], 3, axis=2)
    return np.ascontiguousarray(pixels[:, :, :3])


def encode_png(arr: np.ndarray, mode: str = None, palette=None) -> bytes:
    """A PNG file of ``arr`` in PIL's ``mode``: "1" ((h, w) bool), "L" and
    "P" ((h, w) uint8; "P" writes ``palette``, (n, 3) or (n, 4) uint8, as PLTE
    and its alpha as tRNS; an empty palette as 256 black entries, as PIL
    writes an image with none), "I;16" ((h, w) uint16; "I;16B" big-endian),
    "I" ((h, w) int32, 16 bits clipped to 0..65535, as PIL writes it), "LA",
    "RGB" and "RGBA" ((h, w, 2/3/4) uint8).  Other modes ("F", "LAB",
    "CMYK") raise, as PIL's PNG writer does.  ``mode`` defaults to what the
    array's shape and dtype say ("P" where a palette is given).  No filter,
    zlib level 6."""
    arr = np.asarray(arr)
    if mode is None:
        mode = "P" if palette is not None else _mode_of(arr)
    if mode not in _MODES:
        raise ValueError(f"encode_png takes modes {sorted(_MODES)}, not {mode} "
                         f"({arr.shape} {arr.dtype})")
    colour, depth, channels = _MODES[mode]
    if mode == "I":  # int32, written as PIL writes it: 16 bits, clipped to 0..65535
        if arr.dtype != np.int32 or arr.ndim != 2:
            raise ValueError(f"encode_png mode I takes (h, w) int32, not {arr.shape} {arr.dtype}")
        arr = np.clip(arr, 0, 65535).astype(np.uint16)
    wide = np.dtype(">u2") if mode == "I;16B" else np.dtype(np.uint16)
    want_dtype = {1: bool, 8: np.uint8, 16: wide}[depth]
    shape_ok = arr.ndim == 2 if channels == 1 else (arr.ndim == 3 and arr.shape[2] == channels)
    if not shape_ok or arr.dtype != want_dtype:
        raise ValueError(f"encode_png mode {mode} takes {channels}-channel "
                         f"{np.dtype(want_dtype)}, not {arr.shape} {arr.dtype}")
    h, w = arr.shape[:2]
    if depth == 1:
        rows = np.packbits(arr, axis=1)
    elif depth == 16:
        rows = np.ascontiguousarray(arr.astype(">u2")).view(np.uint8).reshape(h, -1)
    else:
        rows = np.ascontiguousarray(arr).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)  # filter type 0

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    extra = b""
    if mode == "P":
        if palette is None:
            raise ValueError("encode_png mode P needs a palette")
        table = np.asarray(palette, np.uint8)
        if table.shape == (0, 3):
            table = np.zeros((256, 3), np.uint8)
        if table.ndim != 2 or table.shape[1] not in (3, 4) or not 0 < len(table) <= 256:
            raise ValueError(f"a palette is (n, 3) or (n, 4) uint8 with n <= 256, not {table.shape}")
        extra = chunk(b"PLTE", np.ascontiguousarray(table[:, :3]).tobytes())
        if table.shape[1] == 4:
            alpha = table[:, 3]
            opaque = np.nonzero(alpha != 255)[0]
            if len(opaque):
                extra += chunk(b"tRNS", alpha[: opaque[-1] + 1].tobytes())
    return (SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0, 0))
            + extra + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)) + chunk(b"IEND", b""))


def _palette_table(palette, trns):
    if palette is None:
        raise ValueError("broken PNG: a palette image without a PLTE chunk")
    rgb = np.frombuffer(palette, np.uint8)[: len(palette) // 3 * 3].reshape(-1, 3)
    if trns is None:
        return rgb.copy()
    alpha = np.full(len(rgb), 255, np.uint8)
    t = np.frombuffer(trns, np.uint8)[: len(rgb)]
    alpha[: len(t)] = t
    return np.concatenate([rgb, alpha[:, None]], axis=1)


def _unfiltered(src: np.ndarray, h: int, stride: int, bpp: int):
    """((h, stride) bytes of one (sub-)image whose h filtered rows are
    ``src``, the count of rows before the first whose filter byte is not
    0-4).  That row and those after it are 0: PIL's decoder stops there and,
    under the JAX package's ``LOAD_TRUNCATED_IMAGES``, keeps the rows it
    wrote."""
    out = np.empty((h, stride), np.uint8)
    bad = _lib().png_unfilter(src.ctypes.data, out.ctypes.data, h, stride, bpp)
    if not bad:
        return out, h
    out[bad - 1:] = 0
    return out, bad - 1


def _samples(rows: np.ndarray, w: int, channels: int, depth: int) -> np.ndarray:
    """(h, w, channels) samples of unfiltered rows: uint8, uint16 at depth 16."""
    h = rows.shape[0]
    if depth == 8:
        return rows[:, : w * channels].reshape(h, w, channels)
    if depth == 16:
        return words16(rows, w * channels, ">u2").astype(np.uint16).reshape(h, w, channels)
    return unpack_bits(rows, depth, w)[:, :, None]


def check_pixels(width: int, height: int, what: str):
    """PIL's decompression bomb check: ValueError for an image of more than
    twice ``Image.MAX_IMAGE_PIXELS`` (89,478,485) pixels, which PIL refuses."""
    if max(1, width) * max(1, height) > 2 * 89478485:
        raise ValueError(f"{what} image of {width} x {height} pixels is larger than PIL opens")


def whole_rows(body: bytes, width: int, height: int, bands: int) -> np.ndarray:
    """PIL's raw decoder under ``LOAD_TRUNCATED_IMAGES``: (height, width,
    bands) uint8 of the whole rows of ``width * bands`` bytes that ``body``
    holds, in file order, the others 0."""
    stride = width * bands
    whole = min(height, len(body) // stride) if stride else 0
    out = np.zeros((height, width, bands), np.uint8)
    out[:whole] = np.frombuffer(body, np.uint8, count=whole * stride).reshape(whole, width, bands)
    return out


def strided_rows(body: bytes, height: int, row_bytes: int, stride: int = 0):
    """PIL's raw decoder (``RawDecode.c``) with a line stride, under
    ``LOAD_TRUNCATED_IMAGES``: ((height, row_bytes) uint8, the count of
    rows decoded) of the rows of
    ``row_bytes`` bytes, each ``stride`` bytes after the one before
    (``row_bytes`` where it is 0), that ``body`` holds whole, in file order,
    the others 0; all 0 for a stride shorter than a row, the decoder's
    configuration error that the flag leaves unraised."""
    out = np.zeros((height, row_bytes), np.uint8)
    step = stride or row_bytes
    if step < row_bytes or not row_bytes:
        return out, 0
    whole = min(height, (len(body) - row_bytes) // step + 1 if len(body) >= row_bytes else 0)
    if whole:
        src = np.frombuffer(body, np.uint8, count=min(len(body), whole * step))
        out[:whole] = np.lib.stride_tricks.as_strided(src, (whole, row_bytes), (step, 1))
    return out, whole


def words16(rows: np.ndarray, count: int, order: str) -> np.ndarray:
    """(h, count) 16-bit words of the first 2 * count bytes of each of the
    (h, row bytes) rows, in ``order`` ("<u2" or ">u2")."""
    return np.ascontiguousarray(rows[:, :2 * count]).view(order)


def unpack_bits(rows: np.ndarray, depth: int, width: int) -> np.ndarray:
    """(h, width) uint8 samples of (h, row bytes) rows packed at ``depth`` =
    1, 2 or 4 bits a sample, the first sample in the high bits."""
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    samples = ((rows[:, :, None] >> shifts) & ((1 << depth) - 1)).reshape(rows.shape[0], -1)
    return np.ascontiguousarray(samples[:, :width])


def _inflate(stream: bytes, rows) -> bytes:
    """The bytes of the rows (of the sizes ``rows``) that PIL's zlib decoder
    inflates from ``stream``: one row an ``inflate`` call, made only while
    input is left (``ZipDecode.c`` loops while ``avail_in > 0``, so what
    zlib holds back once a cut stream's last byte is in is lost), up to the
    call that meets an error (a broken code, a wrong checksum after the
    last row), whose row is lost with the rest.  A whole stream without an
    error is inflated in one call."""
    inflater = zlib.decompressobj()
    try:
        whole = inflater.decompress(stream, sum(rows))
        if inflater.eof:
            return whole
    except zlib.error:
        pass
    inflater, out, pos, pending = zlib.decompressobj(), [], 0, b""
    for size in rows:
        row = b""
        while len(row) < size:
            if not pending and pos < len(stream):  # the input in pieces: no quadratic copies
                pending, pos = stream[pos:pos + 65536], pos + 65536
            if not pending:  # no input left: PIL calls inflate no more
                break
            try:
                part = inflater.decompress(pending, size - len(row))
            except zlib.error:
                return b"".join(out)
            if not part and inflater.unconsumed_tail == pending:
                break
            pending = inflater.unconsumed_tail
            row += part
        if len(row) < size:
            break
        out.append(row)
    return b"".join(out)


def _decode(data: bytes):
    """(pixels as ``decode_png`` returns them, colour type, PLTE body or None,
    tRNS body or None)."""
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file (bad signature)")
    header, idat, palette, trns = None, [], None, None
    for ctype, body in _chunks(data):
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"PLTE":
            palette = body
        elif ctype == b"tRNS":
            trns = body
    if header is None:
        raise ValueError("broken PNG: no IHDR chunk")
    w, h, depth, colour, _, _, interlace = header
    if colour not in _COLOUR_TYPES:
        raise ValueError(f"PNG colour type {colour} is not a valid one")
    channels, depths = _COLOUR_TYPES[colour]
    if depth not in depths:
        raise ValueError(f"PNG colour type {colour} at bit depth {depth} is not valid")
    if interlace not in (0, 1):
        raise ValueError(f"PNG interlace method {interlace} is not a valid one")
    bpp = max(channels * depth // 8, 1)
    passes = _ADAM7 if interlace else ((0, 0, 1, 1),)
    sizes = [(-(-(h - y0) // dy), -(-(w - x0) // dx)) for x0, y0, dx, dy in passes]
    strides = [(pw * channels * depth + 7) // 8 for _, pw in sizes]
    need = sum(ph * (s + 1) for (ph, pw), s in zip(sizes, strides) if ph and pw)
    # a cut or broken file inflates to fewer bytes: the rows it lacks stay 0, as
    # in PIL's image under LOAD_TRUNCATED_IMAGES
    raw = _inflate(b"".join(idat), [stride + 1 for (ph, pw), stride in zip(sizes, strides)
                                    if ph and pw for _ in range(ph)])
    kept, at = 0, 0  # the bytes of the rows inflated whole
    for (ph, pw), stride in zip(sizes, strides):
        if ph and pw:
            kept = at + min(ph, (len(raw) - at) // (stride + 1)) * (stride + 1) if len(raw) > at else kept
            at += ph * (stride + 1)
    src = np.zeros(need, np.uint8)
    src[:kept] = np.frombuffer(raw, np.uint8, count=kept)
    dtype = np.uint16 if depth == 16 else np.uint8
    samples = np.empty((h, w, channels), dtype) if interlace else None
    at = 0
    for (x0, y0, dx, dy), (ph, pw), stride in zip(passes, sizes, strides):
        if not ph or not pw:
            continue
        rows, good = _unfiltered(src[at:at + ph * (stride + 1)], ph, stride, bpp)
        at += ph * (stride + 1)
        if good < ph:  # a bad filter byte: the later passes stay 0
            src[at:] = 0
        if interlace:
            samples[y0::dy, x0::dx] = _samples(rows, pw, channels, depth)
        else:
            samples = _samples(rows, pw, channels, depth)
    return _as_pil(samples, colour, depth), colour, palette, trns


def _as_pil(samples: np.ndarray, colour: int, depth: int) -> np.ndarray:
    """(h, w, channels) samples as ``np.asarray`` of PIL's image gives them."""
    if depth == 16:
        if colour == 0:
            return np.ascontiguousarray(samples[:, :, 0])
        high = (samples >> 8).astype(np.uint8)
        if colour == 4:  # PIL opens 16-bit gray + alpha as RGBA
            return np.ascontiguousarray(high[:, :, [0, 0, 0, 1]])
        return np.ascontiguousarray(high)
    if samples.shape[2] > 1:
        return np.ascontiguousarray(samples)
    samples = np.ascontiguousarray(samples[:, :, 0])
    if depth == 8 or colour == 3:
        return samples
    if depth == 1:
        return samples.astype(bool)
    return samples * np.uint8(0x55 if depth == 2 else 0x11)
