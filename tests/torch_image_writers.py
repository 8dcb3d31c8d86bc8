"""Image files written by hand, for the layouts PIL's writers do not make:
GIF frames with local palettes, transparency, offsets, interlacing and an
LZW stream that fills its table without a clear code; BMP files with every
header, RLE8 / RLE4 and bitfields; TIFF files in both byte orders with
strips or tiles, planar configurations 1 and 2, PackBits / LZW / Deflate and
the horizontal predictor; a YCCK JPEG; WebP files with the encoder settings
PIL's ``save`` does not expose (``webp_encode``, through the libwebp that
PIL's wheel bundles), animations with offset frames and rewritten alpha
filters; JP2 header boxes rewritten (a ``pclr`` palette, colour spaces),
codestreams cut into tile-parts or given another precision.  Used by ``tests/test_torch_*``, by ``tools/make_image_fixtures.py``
and by ``chip_smoke.py`` phase 14e (numpy only, but ``webp_encode``: the
card's machine runs them without PIL); PIL is what the tests hold them
against.
"""

import ctypes
import functools
import gzip
import io
import struct
import zlib
from pathlib import Path

import numpy as np

# ------------------------------------------------------------------ GIF


def gif_lzw(indices, bits: int, clear_every: int = 4096) -> bytes:
    """GIF LZW codes (LSB first) of ``indices`` at minimum code size ``bits``.
    ``clear_every=None`` never sends a clear code after the first: the table
    fills to 4,096 entries and the codes stay 12 bits wide."""
    clear, end = 1 << bits, (1 << bits) + 1
    out, acc, nacc = bytearray(), 0, 0

    def put(code, width):
        nonlocal acc, nacc
        acc |= code << nacc
        nacc += width
        while nacc >= 8:
            out.append(acc & 255)
            acc >>= 8
            nacc -= 8

    width = bits + 1
    table = {(i,): i for i in range(clear)}
    nxt = end + 1
    put(clear, width)
    seq = ()
    for v in (int(x) for x in np.asarray(indices).reshape(-1)):
        cand = seq + (v,)
        if cand in table:
            seq = cand
            continue
        put(table[seq], width)
        if nxt < 4096:
            table[cand] = nxt
            nxt += 1
            if nxt > (1 << width) and width < 12:
                width += 1
        elif clear_every is not None:
            put(clear, width)
            table = {(i,): i for i in range(clear)}
            nxt, width = end + 1, bits + 1
        seq = (v,)
    if seq:
        put(table[seq], width)
        if nxt < 4096:
            nxt += 1
            if nxt > (1 << width) and width < 12:
                width += 1
    put(end, width)
    if nacc:
        out.append(acc & 255)
    return bytes(out)


def _sub_blocks(data: bytes) -> bytes:
    return b"".join(bytes([len(data[i:i + 255])]) + data[i:i + 255]
                    for i in range(0, len(data), 255)) + b"\0"


def gif_file(frames, screen, global_palette=None, version=b"GIF89a", comment=None, loop=None,
             junk=b"") -> bytes:
    """A GIF file.  ``frames``: dicts with ``indices`` (h, w), optional ``x``,
    ``y``, ``palette`` (local, (2**k, 3)), ``interlace``, ``transparency``,
    ``bits`` (LZW minimum code size) and ``clear_every``."""
    w, h = screen
    flags = 0
    pal = b""
    if global_palette is not None:
        k = int(np.log2(len(global_palette)))
        flags = 0x80 | (k - 1)
        pal = np.asarray(global_palette, np.uint8).tobytes()
    out = bytearray(version + struct.pack("<HHBBB", w, h, flags, 0, 0) + pal)
    if loop is not None:
        out += b"!\xff\x0bNETSCAPE2.0" + b"\x03\x01" + struct.pack("<H", loop) + b"\0"
    if comment is not None:
        out += b"!\xfe" + _sub_blocks(comment)
    out += junk
    for f in frames:
        idx = np.asarray(f["indices"], np.uint8)
        fh, fw = idx.shape
        t = f.get("transparency")
        out += b"!\xf9\x04" + struct.pack("<BHB", 1 if t is not None else 0, 10, t or 0) + b"\0"
        fflags = 0
        local = b""
        if f.get("palette") is not None:
            k = int(np.log2(len(f["palette"])))
            fflags |= 0x80 | (k - 1)
            local = np.asarray(f["palette"], np.uint8).tobytes()
        rows = idx
        if f.get("interlace"):
            fflags |= 0x40
            order = [*range(0, fh, 8), *range(4, fh, 8), *range(2, fh, 4), *range(1, fh, 2)]
            rows = idx[order]
        out += b"," + struct.pack("<HHHHB", f.get("x", 0), f.get("y", 0), fw, fh, fflags) + local
        bits = f.get("bits", 8)
        out += bytes([bits]) + _sub_blocks(gif_lzw(rows, bits, f.get("clear_every", 4096)))
    return bytes(out + b";")


# ------------------------------------------------------------------ BMP


def _rle8(rows) -> bytes:
    out = bytearray()
    for row in rows:
        i, n = 0, len(row)
        while i < n:
            j = i
            while j < n and j - i < 255 and row[j] == row[i]:
                j += 1
            if j - i >= 3 or n - i < 3:
                out += bytes([j - i, row[i]])
                i = j
            else:  # an absolute run of up to 255 bytes, padded to a word
                k = min(n - i, 255)
                out += bytes([0, k]) + bytes(row[i:i + k]) + (b"\0" if k % 2 else b"")
                i += k
        out += b"\0\0"
    return bytes(out + b"\0\1")


def _rle4(rows) -> bytes:
    """RLE4: absolute runs of an even count of at least 4 pixels where the
    pixels vary, runs of alternating pixel pairs elsewhere."""
    out = bytearray()
    for row in rows:
        i, n = 0, len(row)
        while i < n:
            j = i + 1
            while j < n and j - i < 255 and row[j] == row[i + (j - i) % 2]:
                j += 1
            if j - i < 4 and n - i >= 4:
                k = min((n - i) // 2 * 2, 252)
                pix = row[i:i + k]
                packed = bytes((pix[a] << 4) | pix[a + 1] for a in range(0, k, 2))
                out += bytes([0, k]) + packed + (b"\0" if len(packed) % 2 else b"")
                i += k
                continue
            out += bytes([j - i, (row[i] << 4) | (row[i + 1] if i + 1 < n else 0)])
            i = j
        out += b"\0\0"
    return bytes(out + b"\0\1")


def bmp_file(pixels, bits: int, header: int = 40, palette=None, compression: int = 0,
             masks=None, top_down: bool = False, colors_used: int = 0) -> bytes:
    """A BMP file of ``pixels``: (h, w) indices for 1/4/8 bits with
    ``palette`` (n, 3) RGB, (h, w, 3) RGB at 16 (5-5-5, or ``masks``) / 24 /
    32 bits, (h, w, 4) RGBA at 32 bits with alpha ``masks``."""
    px = np.asarray(pixels)
    h, w = px.shape[:2]
    order = px if top_down else px[::-1]
    if compression in (1, 2):
        body = (_rle8 if compression == 1 else _rle4)([list(map(int, r)) for r in order])
    else:
        stride = ((w * bits + 31) >> 3) & ~3
        if bits in (1, 4, 8):
            per = 8 // bits
            pad = np.zeros((h, -(-w // per) * per), np.uint8)
            pad[:, :w] = order
            packed = np.zeros((h, pad.shape[1] // per), np.uint8)
            for k in range(per):
                packed |= (pad[:, k::per] << (8 - bits * (k + 1))).astype(np.uint8)
            raw = packed
        elif bits == 16:
            r, g, b = (order[:, :, c].astype(np.uint32) for c in range(3))
            if masks == (0xF800, 0x7E0, 0x1F):
                v = ((r >> 3) << 11) | ((g >> 2) << 5) | (b >> 3)
            else:
                v = ((r >> 3) << 10) | ((g >> 3) << 5) | (b >> 3)
            raw = v.astype("<u2").view(np.uint8).reshape(h, -1)
        elif bits == 24:
            raw = order[:, :, ::-1].reshape(h, -1)
        else:
            m = masks or (0xFF0000, 0xFF00, 0xFF, 0)
            v = np.zeros((h, w), np.uint64)
            for c, mask in enumerate(m):
                if mask and c < px.shape[2]:
                    shift = (mask & -mask).bit_length() - 1
                    v |= order[:, :, c].astype(np.uint64) << np.uint64(shift)
            raw = v.astype("<u4").view(np.uint8).reshape(h, -1)
        rows = np.zeros((h, stride), np.uint8)
        rows[:, :raw.shape[1]] = raw
        body = rows.tobytes()
    pal = b""
    if palette is not None:
        p = np.asarray(palette, np.uint8)[:, ::-1]
        if header != 12:
            p = np.concatenate([p, np.zeros((len(p), 1), np.uint8)], axis=1)
        pal = p.tobytes()
    if header == 12:
        info = struct.pack("<IHHHH", 12, w, h, 1, bits)
        extra = b""
    else:
        height = (2 ** 32 - h) if top_down else h
        info = struct.pack("<IiIHHIIiiII", header, w, height, 1, bits, compression, len(body),
                           2835, 2835, colors_used, 0)
        extra = b""
        if compression == 3:
            m = tuple(masks) + (0,) * (4 - len(masks))
            if header == 40:
                extra = struct.pack("<III", *m[:3])
            else:
                info += struct.pack("<IIII", *m)
        if header > len(info):
            info += bytes(header - len(info))
        info = info[:header]
    offset = 14 + len(info) + len(extra) + len(pal)
    return (b"BM" + struct.pack("<IHHI", offset + len(body), 0, 0, offset) + info + extra + pal
            + body)


# ------------------------------------------------------------------ TIFF


def tiff_lzw(data: bytes) -> bytes:
    """TIFF LZW (MSB first, early change) of ``data``, one clear code at the
    start and another whenever the table fills."""
    out, acc, nacc = bytearray(), 0, 0

    def put(code, width):
        nonlocal acc, nacc
        acc = (acc << width) | code
        nacc += width
        while nacc >= 8:
            out.append((acc >> (nacc - 8)) & 255)
            nacc -= 8
        acc &= (1 << nacc) - 1

    width, table, nxt = 9, {bytes([i]): i for i in range(256)}, 258
    put(256, width)
    seq = b""
    for v in data:
        cand = seq + bytes([v])
        if cand in table:
            seq = cand
            continue
        put(table[seq], width)
        table[cand] = nxt
        nxt += 1
        if nxt >= (1 << width) and width < 12:
            width += 1
        if nxt >= 4094:
            put(256, width)
            width, table, nxt = 9, {bytes([i]): i for i in range(256)}, 258
        seq = bytes([v])
    if seq:
        put(table[seq], width)
        nxt += 1
        if nxt >= (1 << width) and width < 12:
            width += 1
    put(257, width)
    if nacc:
        out.append((acc << (8 - nacc)) & 255)
    return bytes(out)


def tiff_lzw_literals(data: bytes, run: int = 250) -> bytes:
    """TIFF LZW of ``data`` in one 9-bit code a byte: a clear code before each
    ``run`` bytes keeps the table below its first width change.  The
    decoder's most codes a byte, written by numpy at any size."""
    v = np.zeros(-(-len(data) // run) * run, np.uint16)
    v[:len(data)] = np.frombuffer(data, np.uint8)
    codes = np.full((len(v) // run, run + 1), 256, np.uint16)
    codes[:, 1:] = v.reshape(-1, run)
    codes = np.append(codes.reshape(-1)[:len(data) + len(codes)], 257)
    bits = (codes[:, None] >> np.arange(8, -1, -1, dtype=np.uint16)) & 1
    return np.packbits(bits.astype(np.uint8).reshape(-1)).tobytes()


def packbits(data: bytes) -> bytes:
    out, i, n = bytearray(), 0, len(data)
    while i < n:
        j = i
        while j < n and j - i < 128 and data[j] == data[i]:
            j += 1
        if j - i >= 2:
            out += bytes([(257 - (j - i)) & 255, data[i]])
            i = j
            continue
        j = i + 1
        while j < n and j - i < 128 and not (j + 1 < n and data[j] == data[j + 1]):
            j += 1
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


def _predict(block: np.ndarray, bits: int, samples: int, order: str) -> np.ndarray:
    """Horizontal differencing of (rows, row bytes) file-order data."""
    h, n = block.shape
    if bits == 8:
        v = block.reshape(h, -1, samples).astype(np.int16)
        d = np.diff(v, axis=1, prepend=0)
        d[:, 0] = v[:, 0]
        return (d & 255).astype(np.uint8).reshape(h, n)
    dt = "<u2" if order == "II" else ">u2"
    v = block.copy().view(dt).reshape(h, -1, samples).astype(np.int64)
    d = np.diff(v, axis=1, prepend=0)
    d[:, 0] = v[:, 0]
    return (d & 0xFFFF).astype(dt).reshape(h, -1).view(np.uint8)


def tiff_file(samples, bits, photometric: int, order: str = "II", compression: int = 1,
              predictor: int = 1, planar: int = 1, rows_per_strip=None, tile=None, extra=(),
              colormap=None, fill: int = 1, sample_format=None, lzw_literals: bool = False) -> bytes:
    """A one-page TIFF of ``samples`` ((h, w) or (h, w, spp) integers at
    ``bits`` per sample, 1 to 16): strips of ``rows_per_strip`` rows or tiles
    of ``tile`` = (width, length); LZW by ``tiff_lzw_literals`` where
    ``lzw_literals``."""
    e = "<" if order == "II" else ">"
    s = np.asarray(samples)
    if s.ndim == 2:
        s = s[:, :, None]
    h, w, spp = s.shape
    dt = np.dtype(e + "u2") if bits == 16 else np.uint8

    def pack_rows(block):  # (rows, width, n) samples -> (rows, row bytes)
        r, cw, n = block.shape
        if bits == 16:
            return block.astype(dt).reshape(r, -1).view(np.uint8)
        if bits == 8:
            return block.astype(np.uint8).reshape(r, -1)
        flat = block.reshape(r, -1).astype(np.uint8)
        per = 8 // bits
        padded = np.zeros((r, -(-flat.shape[1] // per) * per), np.uint8)
        padded[:, :flat.shape[1]] = flat
        out = np.zeros((r, padded.shape[1] // per), np.uint8)
        for k in range(per):
            out |= (padded[:, k::per] << (8 - bits * (k + 1))).astype(np.uint8)
        return out

    tw, th = tile if tile else (w, rows_per_strip or h)
    planes = [s[:, :, i:i + 1] for i in range(spp)] if planar == 2 else [s]
    chunks = []
    for plane in planes:
        for y in range(0, h, th):
            for x in range(0, w, tw):
                if tile:
                    block = np.zeros((th, tw, plane.shape[2]), plane.dtype)
                    part = plane[y:y + th, x:x + tw]
                    block[:part.shape[0], :part.shape[1]] = part
                else:
                    block = plane[y:y + th]
                rows = pack_rows(block)
                if predictor == 2:
                    rows = _predict(rows, bits, plane.shape[2], order)
                raw = rows.tobytes()
                if compression == 5:
                    raw = (tiff_lzw_literals if lzw_literals else tiff_lzw)(raw)
                elif compression in (8, 32946):
                    raw = zlib.compress(raw, 6)
                elif compression == 32773:
                    raw = packbits(raw)
                if fill == 2:  # the stored bytes, compressed or not, bit-reversed
                    rev = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)
                    raw = rev[np.frombuffer(raw, np.uint8)].tobytes()
                chunks.append(raw)
    bps = (bits,) * spp
    entries = [(256, 4, (w,)), (257, 4, (h,)), (258, 3, bps), (259, 3, (compression,)),
               (262, 3, (photometric,)), (277, 3, (spp,)), (284, 3, (planar,))]
    if fill != 1:
        entries.append((266, 3, (fill,)))
    if predictor != 1:
        entries.append((317, 3, (predictor,)))
    if colormap is not None:
        cm = np.asarray(colormap, np.uint16)
        entries.append((320, 3, tuple(int(v) for v in cm.T.reshape(-1))))
    if extra:
        entries.append((338, 3, tuple(extra)))
    if sample_format is not None:
        entries.append((339, 3, tuple(sample_format)))
    data_at = 8
    blob = b"".join(chunks)
    offsets = np.cumsum([0] + [len(c) for c in chunks[:-1]]) + data_at
    counts = [len(c) for c in chunks]
    if tile:
        entries += [(322, 3, (tw,)), (323, 3, (th,)), (324, 4, tuple(offsets)), (325, 4, tuple(counts))]
    else:
        entries += [(273, 4, tuple(offsets)), (278, 4, (th,)), (279, 4, tuple(counts))]
    entries.sort()
    ifd_at = data_at + len(blob) + (len(blob) % 2)
    ifd_size = 2 + 12 * len(entries) + 4
    after = ifd_at + ifd_size
    ifd, tail = struct.pack(e + "H", len(entries)), b""
    for tag, typ, vals in entries:
        code = "H" if typ == 3 else "I"
        body = struct.pack(e + code * len(vals), *(int(v) for v in vals))
        if len(body) <= 4:
            ifd += struct.pack(e + "HHI", tag, typ, len(vals)) + body.ljust(4, b"\0")
        else:
            ifd += struct.pack(e + "HHII", tag, typ, len(vals), after + len(tail))
            tail += body + (b"\0" if len(body) % 2 else b"")
    head = (b"II*\0" if order == "II" else b"MM\0*") + struct.pack(e + "I", ifd_at)
    return head + blob + b"\0" * (len(blob) % 2) + ifd + struct.pack(e + "I", 0) + tail


# ------------------------------------------------------------------ JPEG


def ycck_jpeg(cmyk_jpeg: bytes) -> bytes:
    """A YCCK file: the Adobe marker of PIL's CMYK JPEG set to transform 2,
    so its four components are read as Y, Cb, Cr and K."""
    at = cmyk_jpeg.index(b"\xff\xee")
    out = bytearray(cmyk_jpeg)
    assert out[at + 4:at + 9] == b"Adobe"
    out[at + 4 + 11] = 2
    return bytes(out)


def without_adobe(jpeg: bytes) -> bytes:
    """The file with its Adobe APP14 segment taken out."""
    at = jpeg.index(b"\xff\xee")
    n = (jpeg[at + 2] << 8) | jpeg[at + 3]
    return jpeg[:at] + jpeg[at + 2 + n:]


def pil_save(img, fmt: str, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, fmt, **kw)
    return buf.getvalue()


# ------------------------------------------------------------------- WebP

class _WebPConfig(ctypes.Structure):
    _fields_ = [(n, ctypes.c_float if n in ("quality", "target_PSNR") else ctypes.c_int) for n in (
        "lossless quality method image_hint target_size target_PSNR segments sns_strength "
        "filter_strength filter_sharpness filter_type autofilter alpha_compression "
        "alpha_filtering alpha_quality pass_ show_compressed preprocessing partitions "
        "partition_limit emulate_jpeg_size thread_level low_memory near_lossless exact "
        "use_delta_palette use_sharp_yuv qmin qmax").split()] + [("_spare", ctypes.c_uint8 * 256)]


class _WebPPicture(ctypes.Structure):
    _fields_ = [("use_argb", ctypes.c_int), ("colorspace", ctypes.c_int),
                ("width", ctypes.c_int), ("height", ctypes.c_int),
                ("y", ctypes.c_void_p), ("u", ctypes.c_void_p), ("v", ctypes.c_void_p),
                ("y_stride", ctypes.c_int), ("uv_stride", ctypes.c_int),
                ("a", ctypes.c_void_p), ("a_stride", ctypes.c_int), ("pad1", ctypes.c_uint32 * 2),
                ("argb", ctypes.c_void_p), ("argb_stride", ctypes.c_int),
                ("pad2", ctypes.c_uint32 * 3), ("writer", ctypes.c_void_p),
                ("custom_ptr", ctypes.c_void_p), ("extra_info_type", ctypes.c_int),
                ("extra_info", ctypes.c_void_p), ("stats", ctypes.c_void_p),
                ("error_code", ctypes.c_int), ("progress_hook", ctypes.c_void_p),
                ("user_data", ctypes.c_void_p), ("pad3", ctypes.c_uint32 * 3),
                ("pad4", ctypes.c_void_p), ("pad5", ctypes.c_void_p),
                ("pad6", ctypes.c_uint32 * 8), ("memory_", ctypes.c_void_p),
                ("memory_argb_", ctypes.c_void_p), ("pad7", ctypes.c_void_p * 2),
                ("_spare", ctypes.c_uint8 * 256)]


class _WebPMemoryWriter(ctypes.Structure):
    _fields_ = [("mem", ctypes.c_void_p), ("size", ctypes.c_size_t),
                ("max_size", ctypes.c_size_t), ("pad", ctypes.c_uint32 * 1)]


@functools.lru_cache(maxsize=None)
def _libwebp():
    """The libwebp that PIL's wheel bundles (test and tool code only; the
    port loads no codec library)."""
    import PIL
    from PIL import _webp  # noqa: F401  (loads the libraries libwebp needs)
    libs = Path(PIL.__file__).resolve().parents[1] / "pillow.libs"
    path = next(iter(sorted(libs.glob("libwebp-*.so*"))))
    return ctypes.CDLL(str(path))


_ENCODER_ABI = 0x020F


def webp_encode(pixels, **config) -> bytes:
    """A WebP file of an (h, w, 3) RGB or (h, w, 4) RGBA uint8 array through
    libwebp's ``WebPEncode`` with the given ``WebPConfig`` fields (on top of
    the default preset at ``quality``), which PIL's ``save`` does not expose:
    ``segments``, ``partitions``, ``filter_type``, ``filter_sharpness``,
    ``alpha_compression``, ``alpha_filtering`` ..."""
    lib = _libwebp()
    arr = np.ascontiguousarray(pixels, np.uint8)
    h, w, c = arr.shape
    cfg = _WebPConfig()
    assert lib.WebPConfigInitInternal(ctypes.byref(cfg), 0, ctypes.c_float(
        config.pop("quality", 75.0)), _ENCODER_ABI)
    for key, value in config.items():
        setattr(cfg, "pass_" if key == "pass" else key, value)
    assert lib.WebPValidateConfig(ctypes.byref(cfg)), config
    pic = _WebPPicture()
    assert lib.WebPPictureInitInternal(ctypes.byref(pic), _ENCODER_ABI)
    pic.width, pic.height, pic.use_argb = w, h, int(cfg.lossless)
    importer = lib.WebPPictureImportRGBA if c == 4 else lib.WebPPictureImportRGB
    assert importer(ctypes.byref(pic), arr.ctypes.data_as(ctypes.c_void_p), w * c)
    out = _WebPMemoryWriter()
    lib.WebPMemoryWriterInit(ctypes.byref(out))
    pic.writer = ctypes.cast(lib.WebPMemoryWrite, ctypes.c_void_p)
    pic.custom_ptr = ctypes.cast(ctypes.byref(out), ctypes.c_void_p)
    try:
        assert lib.WebPEncode(ctypes.byref(cfg), ctypes.byref(pic)), pic.error_code
        return ctypes.string_at(out.mem, out.size)
    finally:
        lib.WebPPictureFree(ctypes.byref(pic))
        lib.WebPMemoryWriterClear(ctypes.byref(out))


def riff_chunks(data: bytes):
    """(fourcc, payload) of each top-level chunk of a RIFF WebP file."""
    pos, out = 12, []
    while pos + 8 <= len(data):
        size = struct.unpack("<I", data[pos + 4:pos + 8])[0]
        out.append((data[pos:pos + 4], data[pos + 8:pos + 8 + size]))
        pos += 8 + size + (size & 1)
    return out


def riff_file(chunks) -> bytes:
    """A RIFF WebP file of (fourcc, payload) chunks, each padded to even."""
    body = b"".join(t + struct.pack("<I", len(p)) + p + b"\0" * (len(p) & 1) for t, p in chunks)
    return b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WEBP" + body


def vp8x_chunk(width: int, height: int, flags: int) -> tuple:
    return b"VP8X", bytes([flags, 0, 0, 0]) + (width - 1).to_bytes(3, "little") + \
        (height - 1).to_bytes(3, "little")


def webp_animation(frames, canvas, alpha: bool, background=(255, 255, 255, 255)) -> bytes:
    """An animated WebP file: each frame (still WebP file, x, y) placed at
    (x, y) (even) on a ``canvas`` = (width, height), its image chunks (ALPH
    and VP8, or VP8L) in an ANMF chunk."""
    chunks = [vp8x_chunk(*canvas, 0x02 | (0x10 if alpha else 0)),
              (b"ANIM", bytes(background) + b"\0\0")]
    for still, x, y in frames:
        parts = [(t, p) for t, p in riff_chunks(still) if t in (b"ALPH", b"VP8 ", b"VP8L")]
        tag, payload = parts[-1]
        if tag == b"VP8L":
            bits = int.from_bytes(payload[1:5], "little")
            w, h = (bits & 0x3FFF) + 1, ((bits >> 14) & 0x3FFF) + 1
        else:
            w, h = (int.from_bytes(payload[6:8], "little") & 0x3FFF,
                    int.from_bytes(payload[8:10], "little") & 0x3FFF)
        body = b"".join(t + struct.pack("<I", len(p)) + p + b"\0" * (len(p) & 1) for t, p in parts)
        header = b"".join(v.to_bytes(3, "little") for v in (x // 2, y // 2, w - 1, h - 1, 100))
        chunks.append((b"ANMF", header + b"\0" + body))
    return riff_file(chunks)


def with_alpha_filter(data: bytes, filter_method: int) -> bytes:
    """The file with the filter bits of its ALPH header byte set to
    ``filter_method`` (its alpha data unchanged: the decoder then unfilters
    what was not filtered)."""
    chunks = [(t, bytes([(p[0] & ~0x0C) | (filter_method << 2)]) + p[1:] if t == b"ALPH" else p)
              for t, p in riff_chunks(data)]
    return riff_file(chunks)


# ------------------------------------------------------------- JPEG 2000

def jp2_boxes(data: bytes, start: int = 0, end: int = None):
    """[(type, payload)] of the boxes from ``start`` (a JP2 file: 12, after
    its signature box) to ``end``; a box of length 0 runs to the end."""
    end = len(data) if end is None else end
    out, pos = [], start
    while pos + 8 <= end:
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        length = length or end - pos
        out.append((kind, data[pos + 8:pos + length]))
        pos += length
    return out


def jp2_box(kind: bytes, payload: bytes) -> bytes:
    return struct.pack(">I4s", len(payload) + 8, kind) + payload


def jp2_rewrite_header(jp2: bytes, rewrite) -> bytes:
    """A JP2 file whose ``jp2h`` sub-boxes are ``rewrite([(type, payload)])``."""
    out = jp2[:12]
    for kind, payload in jp2_boxes(jp2, 12):
        if kind == b"jp2h":
            payload = b"".join(jp2_box(k, p) for k, p in rewrite(jp2_boxes(payload)))
        out += jp2_box(kind, payload)
    return out


def jp2_palette(jp2: bytes, palette, colour: int = 16) -> bytes:
    """A one- or two-component JP2 file with a ``pclr`` box of ``palette``
    ((n, channels) uint8, 8-bit entries) and a ``colr`` box of enumerated
    space ``colour`` (16: sRGB)."""
    palette = np.asarray(palette, np.uint8)
    pclr = struct.pack(">HB", *palette.shape) + bytes([7] * palette.shape[1]) + palette.tobytes()
    colr = b"\x01\x00\x00" + struct.pack(">I", colour)
    return jp2_rewrite_header(jp2, lambda boxes: [(k, colr if k == b"colr" else p)
                                                  for k, p in boxes] + [(b"pclr", pclr)])


def j2k_tile_parts(codestream: bytes, parts: int, count: bool = True) -> bytes:
    """The codestream with each tile's one tile-part cut into ``parts``
    tile-parts at even shares of its data (TNsot = ``parts``, or 0 with
    ``count=False``: a reader then learns each tile's end from the EOC)."""
    pos = codestream.index(b"\xff\x90")
    out = bytearray(codestream[:pos])
    while codestream[pos:pos + 2] == b"\xff\x90":
        isot, psot = struct.unpack(">HI", codestream[pos + 4:pos + 10])
        sod = codestream.index(b"\xff\x93", pos + 12) + 2
        header, data = codestream[pos + 12:sod], codestream[sod:pos + psot]
        cuts = [len(data) * k // parts for k in range(parts + 1)]
        for k in range(parts):
            chunk = (header if k == 0 else b"\xff\x93") + data[cuts[k]:cuts[k + 1]]
            out += struct.pack(">HHHIBB", 0xFF90, 10, isot, 12 + len(chunk), k,
                               parts if count else 0) + chunk
        pos += psot
    return bytes(out + codestream[pos:])


def j2k_precision(codestream: bytes, bits: int) -> bytes:
    """The codestream with every component's SIZ precision set to ``bits``
    (its sign kept): the same coefficients, another DC shift and range."""
    out = bytearray(codestream)
    count = struct.unpack(">H", out[40:42])[0]
    for c in range(count):
        out[42 + 3 * c] = (out[42 + 3 * c] & 0x80) | (bits - 1)
    return bytes(out)


# ------------------------------------------------------------- ICO and CUR


def dib(pixels, bits: int, palette=None, and_mask=None, header: int = 40, compression: int = 0,
        masks=None) -> bytes:
    """An icon's or a cursor's bitmap entry: ``bmp_file``'s info header,
    palette and pixels with the height doubled, then the AND mask (``and_mask``,
    (h, w) bool, True transparent: one bit a pixel, rows bottom-up, padded to
    32 bits; none where ``and_mask`` is None)."""
    px = np.asarray(pixels)
    h, w = px.shape[:2]
    body = bmp_file(px, bits, header, palette, compression, masks)[14:]
    if header == 12:
        body = body[:6] + struct.pack("<H", 2 * h) + body[8:]
    else:
        body = body[:8] + struct.pack("<i", 2 * h) + body[12:]
    if and_mask is None:
        return body
    padded = np.zeros((h, (w + 31) // 32 * 32), np.uint8)
    padded[:, :w] = np.asarray(and_mask, bool)[::-1]
    return body + np.packbits(padded, axis=1).tobytes()


def ico_file(entries, kind: int = 1) -> bytes:
    """An ICO (``kind`` 1) or CUR (2) file of ``entries``: each (the entry's
    bytes, a PNG file or a ``dib``; its directory fields: ``width`` and
    ``height`` (256 written as 0), and optionally ``colours``, ``planes``,
    ``bits`` (a cursor's hotspot in those two), ``size`` and ``offset``)."""
    directory, body = b"", b""
    start = 6 + 16 * len(entries)
    for data, d in entries:
        directory += struct.pack("<BBBBHHII", d["width"] % 256, d["height"] % 256,
                                 d.get("colours", 0), 0, d.get("planes", 1), d.get("bits", 32),
                                 d.get("size", len(data)), d.get("offset", start + len(body)))
        body += data
    return struct.pack("<HHH", 0, kind, len(entries)) + directory + body


# --------------------------------------------------------------------- PSD


def _pascal(name: bytes, align: int) -> bytes:
    s = bytes([len(name)]) + name
    return s + bytes(-len(s) % align)


def psd_layer_section(planes) -> bytes:
    """A layer and mask section holding one layer of ``planes`` ((c, h, w)
    uint8, channel ids 0, 1, ...), raw, named "layer 1"."""
    c, h, w = np.asarray(planes).shape
    extra = struct.pack(">II", 0, 0) + _pascal(b"layer 1", 4)
    record = struct.pack(">iiiiH", 0, 0, h, w, c)
    for i in range(c):
        record += struct.pack(">hI", i, 2 + h * w)
    record += b"8BIMnorm" + bytes([255, 0, 0, 0]) + struct.pack(">I", len(extra)) + extra
    data = b"".join(struct.pack(">H", 0) + np.asarray(p, np.uint8).tobytes() for p in planes)
    info = struct.pack(">h", 1) + record + data
    info += bytes(len(info) % 2)
    body = struct.pack(">I", len(info)) + info + struct.pack(">I", 0)
    return struct.pack(">I", len(body)) + body


def psd_file(planes, colour_mode: int, bits: int = 8, compression: int = 0, palette=None,
             resources=(), layers: bytes = None) -> bytes:
    """A PSD file of ``planes``: (c, h, w) uint8 channels (at ``bits`` 1, (1,
    h, w) bool, True a set bit), every channel in the file (extra ones past
    what the colour mode needs too); ``colour_mode`` Photoshop's (0 bitmap,
    1 grey, 2 indexed, 3 RGB, 4 CMYK, 7 multichannel, 8 duotone, 9 Lab);
    ``compression`` 0 raw or 1 PackBits (each row on its own, behind the
    table of byte counts); ``palette`` (256, 3) for indexed files (written as
    the colour-mode block, R, G, B planes); ``resources`` (id, name, data);
    ``layers`` a layer and mask section (``psd_layer_section``; none where
    None)."""
    planes = np.asarray(planes)
    c, h, w = planes.shape
    rows = (np.packbits(planes.astype(bool), axis=2) if bits == 1
            else planes.astype(np.uint8))
    head = b"8BPS" + struct.pack(">H6xHIIHH", 1, c, h, w, bits, colour_mode)
    mode_data = b"" if palette is None else np.asarray(palette, np.uint8).T.tobytes()
    res = b""
    for rid, name, data in resources:
        res += b"8BIM" + struct.pack(">H", rid) + _pascal(name, 2) + struct.pack(">I", len(data))
        res += data + bytes(len(data) % 2)
    if compression == 0:
        image = struct.pack(">H", 0) + rows.tobytes()
    else:
        packed = [packbits(r.tobytes()) for ch in rows for r in ch]
        image = (struct.pack(">H", 1) + b"".join(struct.pack(">H", len(p)) for p in packed)
                 + b"".join(packed))
    return (head + struct.pack(">I", len(mode_data)) + mode_data + struct.pack(">I", len(res))
            + res + (layers if layers is not None else struct.pack(">I", 0)) + image)


# ------------------------------------------------------------------ Netpbm


def netpbm_file(magic: bytes, pixels, maxval: int = 255, scale: float = -1.0,
                comment: bytes = None, per_line: int = 12) -> bytes:
    """A Netpbm file: ``magic`` b"P1" to b"P6", b"Pf" or PIL's b"P0CMYK",
    b"PyP", b"PyRGBA", b"PyCMYK".  ``pixels``: (h, w) bool for P1 / P4 (True
    black, written 1), else (h, w[, bands]) samples up to ``maxval`` (two
    bytes big-endian above 255), float32 for Pf (rows bottom-up,
    little-endian where ``scale`` is negative).  The plain formats write
    ``per_line`` samples a line; ``comment`` goes in a ``#`` line after the
    magic."""
    px = np.asarray(pixels)
    h, w = px.shape[:2]
    head = magic + b"\n" + (b"# " + comment + b"\n" if comment else b"") + b"%d %d\n" % (w, h)
    if magic in (b"P1", b"P4"):
        if magic == b"P4":
            return head + np.packbits(px.astype(bool), axis=1).tobytes()
        bits = px.astype(np.uint8).reshape(-1)
        lines = [b"".join(b"%d" % v for v in bits[i:i + 35]) for i in range(0, len(bits), 35)]
        return head + b"\n".join(lines) + b"\n"
    if magic == b"Pf":
        order = "<f4" if scale < 0 else ">f4"
        return head + b"%r\n" % scale + px[::-1].astype(order).tobytes()
    head += b"%d\n" % maxval
    flat = px.reshape(-1)
    if magic in (b"P2", b"P3"):
        lines = [b" ".join(b"%d" % v for v in flat[i:i + per_line])
                 for i in range(0, len(flat), per_line)]
        return head + b"\n".join(lines) + b"\n"
    return head + flat.astype(np.uint8 if maxval < 256 else ">u2").tobytes()


# ------------------------------------------- TGA, SGI, PCX, DCX, IM, DDS, QOI

def _runs(units, limit: int, min_run: int = 2):
    """[(True, unit, count) for a run of one repeated unit | (False, [units])
    for literals], greedily, each at most ``limit`` units long."""
    out, i, n = [], 0, len(units)
    while i < n:
        j = i + 1
        while j < n and j - i < limit and units[j] == units[i]:
            j += 1
        if j - i >= min_run:
            out.append((True, units[i], j - i))
            i = j
            continue
        lit = [units[i]]
        i += 1
        while i < n and len(lit) < limit and not (i + 1 < n and units[i + 1] == units[i]):
            lit.append(units[i])
            i += 1
        out.append((False, lit, len(lit)))
    return out


def tga_rle(pixels: bytes, bpp: int, row: int = None) -> bytes:
    """TGA run-length packets (at most 128 pixels) of the pixel bytes, each
    ``bpp`` bytes; packets cross rows unless ``row`` (pixels a row) is given."""
    units = [pixels[i:i + bpp] for i in range(0, len(pixels), bpp)]
    groups = [units] if row is None else [units[i:i + row] for i in range(0, len(units), row)]
    out = bytearray()
    for group in groups:
        for run, value, count in _runs(group, 128):
            if run:
                out += bytes([0x80 | (count - 1)]) + value
            else:
                out += bytes([count - 1]) + b"".join(value)
    return bytes(out)


def tga_file(body: bytes, width: int, height: int, kind: int, depth: int, flags: int = 0,
             id_section: bytes = b"", colour_map: bytes = None, map_start: int = 0,
             map_depth: int = 24, footer: bool = True) -> bytes:
    """A TGA file: ``body`` the pixel bytes as stored (RLE packets for kinds
    9-11), an optional colour map of ``map_depth``-bit entries."""
    entry = {16: 2, 24: 3, 32: 4}.get(map_depth, 3)
    count = len(colour_map) // entry if colour_map is not None else 0
    head = struct.pack("<BBBHHBHHHHBB", len(id_section), int(colour_map is not None), kind,
                       map_start, count, map_depth if colour_map is not None else 0, 0, 0,
                       width, height, depth, flags)
    tail = b"\0" * 8 + b"TRUEVISION-XFILE.\0" if footer else b""
    return head + id_section + (colour_map or b"") + body + tail


def sgi_rle_row(samples, bpc: int) -> bytes:
    """One SGI RLE row: (count | 0x80) then literals, or count then the value,
    counts up to 127, ending in a 0 packet; 16-bit words big-endian."""
    word = (lambda v: bytes([v])) if bpc == 1 else (lambda v: struct.pack(">H", v))
    out = bytearray()
    for run, value, count in _runs([int(v) for v in samples], 127, min_run=3):
        if run:
            out += word(count) + word(value)
        else:
            out += word(0x80 | count) + b"".join(word(v) for v in value)
    return bytes(out + word(0))


def sgi_file(planes, rle: bool = False, name: bytes = b"", dimension: int = None) -> bytes:
    """An SGI file of (z, h, w) samples (uint8, or uint16 for 2 bytes a
    sample), rows bottom-up, raw or with PIL's RLE tables."""
    planes = np.asarray(planes)
    z, h, w = planes.shape
    bpc = 2 if planes.dtype == np.uint16 else 1
    dimension = dimension or (3 if z > 1 else (1 if h == 1 else 2))
    head = struct.pack(">hBBHHHHll4s79ssl404s", 474, int(rle), bpc, dimension, w, h, z, 0,
                       255 if bpc == 1 else 65535, b"", name, b"", 0, b"")
    rows = planes[:, ::-1]
    if not rle:
        return head + rows.astype(">u2" if bpc == 2 else np.uint8).tobytes()
    starts, lengths, body = [], [], bytearray()
    at = 512 + 8 * z * h
    for c in range(z):
        for y in range(h):
            packed = sgi_rle_row(rows[c, y], bpc)
            starts.append(at + len(body))
            lengths.append(len(packed))
            body += packed
    return head + struct.pack(f">{z * h}I", *starts) + struct.pack(f">{z * h}I", *lengths) + body


def pcx_rle(rows, limit: int = 63, across: bool = False) -> bytes:
    """PCX run-length bytes of (h, row bytes) rows: runs of 2+ bytes, or of
    one byte of 0xC0 or more, as 0xC0 | n and the byte; runs stop at each
    row's end unless ``across``."""
    rows = np.asarray(rows, np.uint8)
    groups = [rows.reshape(-1)] if across else list(rows)
    out = bytearray()
    for group in groups:
        values = group.tolist()
        i = 0
        while i < len(values):
            j = i + 1
            while j < len(values) and j - i < limit and values[j] == values[i]:
                j += 1
            if j - i > 1 or values[i] >= 0xC0:
                out += bytes([0xC0 | (j - i), values[i]])
            else:
                out.append(values[i])
            i = j
    return bytes(out)


def pcx_file(body: bytes, width: int, height: int, bits: int, planes: int, stride: int,
             version: int = 5, header_palette: bytes = b"\0" * 48, palette: bytes = None) -> bytes:
    """A PCX file: ``body`` the run-length rows, an optional 256-entry
    palette after a 12 byte at the end."""
    head = (struct.pack("<BBBBHHHHHH", 10, version, 1, bits, 0, 0, width - 1, height - 1, 72, 72)
            + header_palette[:48].ljust(48, b"\0") + struct.pack("<BBHHHH", 0, planes, stride, 1,
                                                                 width, height) + b"\0" * 54)
    return head + body + (b"\x0c" + palette if palette is not None else b"")


def dcx_file(frames) -> bytes:
    """A DCX container of PCX files."""
    offsets, at = [], 4 + 4 * (len(frames) + 1)
    for f in frames:
        offsets.append(at)
        at += len(f)
    return struct.pack(f"<I{len(frames) + 1}I", 0x3ADE68B1, *offsets, 0) + b"".join(frames)


def im_file(lines, body: bytes, lut: bytes = None, newline: bytes = b"\r\n") -> bytes:
    """An IM file: header ``lines`` ("Key: value"), padded with NULs to 511
    bytes and a 0x1A, an optional 768-byte LUT, then ``body``."""
    head = b"".join(line + newline for line in lines)
    return head + b"\0" * max(0, 511 - len(head)) + b"\x1a" + (lut or b"") + body


def dds_file(width: int, height: int, body: bytes, pf_flags: int, fourcc: bytes = b"\0" * 4,
             bits: int = 0, masks=(0, 0, 0, 0), dxgi: int = None, palette: bytes = b"") -> bytes:
    """A DDS file: the 124-byte header with the pixel format given, a DX10
    header where ``dxgi`` is given, a palette for PALETTEINDEXED8."""
    head = (b"DDS " + struct.pack("<7I", 124, 0x1007, height, width, 0, 0, 0) + b"\0" * 44
            + struct.pack("<II4sI4I", 32, pf_flags, fourcc, bits, *masks)
            + struct.pack("<5I", 0x1000, 0, 0, 0, 0))
    if dxgi is not None:
        head += struct.pack("<5I", dxgi, 3, 0, 0, 1)
    return head + palette + body


def qoi_file(pixels, channels: int = None, colorspace: int = 0) -> bytes:
    """A QOI file of (h, w, 3 or 4) uint8 pixels, as the format's reference
    encoder writes it: every op, the index table starting empty."""
    px = np.asarray(pixels, np.uint8)
    h, w, bands = px.shape
    flat = px.reshape(-1, bands).tolist()
    out = bytearray(b"qoif" + struct.pack(">IIBB", w, h, channels or bands, colorspace))
    seen, prev, run = [None] * 64, (0, 0, 0, 255), 0
    for i, p in enumerate(flat):
        p = tuple(p) + ((255,) if bands == 3 else ())
        if p == prev:
            run += 1
            if run == 62 or i == len(flat) - 1:
                out.append(0xC0 | (run - 1))
                run = 0
            continue
        if run:
            out.append(0xC0 | (run - 1))
            run = 0
        h_ = (p[0] * 3 + p[1] * 5 + p[2] * 7 + p[3] * 11) % 64
        if seen[h_] == p:
            out.append(h_)
        else:
            seen[h_] = p
            d = [((p[k] - prev[k] + 128) & 255) - 128 for k in range(3)]
            if p[3] != prev[3]:
                out += bytes([0xFF, *p])
            elif all(-2 <= v < 2 for v in d):
                out.append(0x40 | (d[0] + 2) << 4 | (d[1] + 2) << 2 | (d[2] + 2))
            elif -32 <= d[1] < 32 and -8 <= d[0] - d[1] < 8 and -8 <= d[2] - d[1] < 8:
                out += bytes([0x80 | (d[1] + 32), (d[0] - d[1] + 8) << 4 | (d[2] - d[1] + 8)])
            else:
                out += bytes([0xFE, *p[:3]])
        prev = p
    return bytes(out + b"\0" * 7 + b"\x01")


def bc1_blocks(colours, indices) -> bytes:
    """BC1 (DXT1) blocks of two 5-6-5 ``colours`` ((n, 2) uint16) and indices
    0 or 1 ((n, 16) bits, the block's pixels in row order): each pixel is one
    of its block's two colours exactly, whatever their order."""
    colours = np.asarray(colours, np.uint16)
    idx = np.asarray(indices, np.uint32)
    lut = (idx << (2 * np.arange(16, dtype=np.uint32))).sum(axis=1).astype("<u4")
    blocks = np.zeros((len(colours), 8), np.uint8)
    blocks[:, :4] = colours.astype("<u2").view(np.uint8).reshape(-1, 4)
    blocks[:, 4:] = lut.view(np.uint8).reshape(-1, 4)
    return blocks.tobytes()


def expand_565(v) -> np.ndarray:
    """(..., 3) uint8 RGB of 5-6-5 values, as BcnDecode.c expands them."""
    v = np.asarray(v, np.uint16)
    r, g, b = (v >> 11) & 31, (v >> 5) & 63, v & 31
    return np.stack([r << 3 | r >> 2, g << 2 | g >> 4, b << 3 | b >> 2], -1).astype(np.uint8)


# --------------------------------------------------- BC6H and BC7 DDS blocks

# the BC6H header layouts of the format's description, one a mode in the
# order of the mode bits ("00", "01", "00010" ... "11110", "00011" ...
# "01111"), without the mode and partition bits: rN gN bN the red, green and
# blue of end point N, [hi:lo] bits listed low first, [10:15] bit 15 first
BC6H_MODE_BITS = (0b00, 0b01, 0b00010, 0b00110, 0b01010, 0b01110, 0b10010, 0b10110, 0b11010,
                  0b11110, 0b00011, 0b00111, 0b01011, 0b01111)
BC6H_RESERVED = (0b10011, 0b10111, 0b11011, 0b11111)
BC6H_LAYOUTS = (
    "g2[4] b2[4] b3[4] r0[9:0] g0[9:0] b0[9:0] r1[4:0] g3[4] g2[3:0] g1[4:0] b3[0] g3[3:0] "
    "b1[4:0] b3[1] b2[3:0] r2[4:0] b3[2] r3[4:0] b3[3]",
    "g2[5] g3[4] g3[5] r0[6:0] b3[0] b3[1] b2[4] g0[6:0] b2[5] b3[2] g2[4] b0[6:0] b3[3] b3[5] "
    "b3[4] r1[5:0] g2[3:0] g1[5:0] g3[3:0] b1[5:0] b2[3:0] r2[5:0] r3[5:0]",
    "r0[9:0] g0[9:0] b0[9:0] r1[4:0] r0[10] g2[3:0] g1[3:0] g0[10] b3[0] g3[3:0] b1[3:0] b0[10] "
    "b3[1] b2[3:0] r2[4:0] b3[2] r3[4:0] b3[3]",
    "r0[9:0] g0[9:0] b0[9:0] r1[3:0] r0[10] g3[4] g2[3:0] g1[4:0] g0[10] g3[3:0] b1[3:0] b0[10] "
    "b3[1] b2[3:0] r2[3:0] b3[0] b3[2] r3[3:0] g2[4] b3[3]",
    "r0[9:0] g0[9:0] b0[9:0] r1[3:0] r0[10] b2[4] g2[3:0] g1[3:0] g0[10] b3[0] g3[3:0] b1[4:0] "
    "b0[10] b2[3:0] r2[3:0] b3[1] b3[2] r3[3:0] b3[4] b3[3]",
    "r0[8:0] b2[4] g0[8:0] g2[4] b0[8:0] b3[4] r1[4:0] g3[4] g2[3:0] g1[4:0] b3[0] g3[3:0] "
    "b1[4:0] b3[1] b2[3:0] r2[4:0] b3[2] r3[4:0] b3[3]",
    "r0[7:0] g3[4] b2[4] g0[7:0] b3[2] g2[4] b0[7:0] b3[3] b3[4] r1[5:0] g2[3:0] g1[4:0] b3[0] "
    "g3[3:0] b1[4:0] b3[1] b2[3:0] r2[5:0] r3[5:0]",
    "r0[7:0] b3[0] b2[4] g0[7:0] g2[5] g2[4] b0[7:0] g3[5] b3[4] r1[4:0] g3[4] g2[3:0] g1[5:0] "
    "g3[3:0] b1[4:0] b3[1] b2[3:0] r2[4:0] b3[2] r3[4:0] b3[3]",
    "r0[7:0] b3[1] b2[4] g0[7:0] b2[5] g2[4] b0[7:0] b3[5] b3[4] r1[4:0] g3[4] g2[3:0] g1[4:0] "
    "b3[0] g3[3:0] b1[5:0] b2[3:0] r2[4:0] b3[2] r3[4:0] b3[3]",
    "r0[5:0] g3[4] b3[0] b3[1] b2[4] g0[5:0] g2[5] b2[5] b3[2] g2[4] b0[5:0] g3[5] b3[3] b3[5] "
    "b3[4] r1[5:0] g2[3:0] g1[5:0] g3[3:0] b1[5:0] b2[3:0] r2[5:0] r3[5:0]",
    "r0[9:0] g0[9:0] b0[9:0] r1[9:0] g1[9:0] b1[9:0]",
    "r0[9:0] g0[9:0] b0[9:0] r1[8:0] r0[10] g1[8:0] g0[10] b1[8:0] b0[10]",
    "r0[9:0] g0[9:0] b0[9:0] r1[7:0] r0[10:11] g1[7:0] g0[10:11] b1[7:0] b0[10:11]",
    "r0[9:0] g0[9:0] b0[9:0] r1[3:0] r0[10:15] g1[3:0] g0[10:15] b1[3:0] b0[10:15]",
)
# (base end point bits, delta bits of r, g, b; 0 where the end points are not deltas)
BC6H_PRECISION = ((10, 5, 5, 5), (7, 6, 6, 6), (11, 5, 4, 4), (11, 4, 5, 4), (11, 4, 4, 5),
                  (9, 5, 5, 5), (8, 6, 5, 5), (8, 5, 6, 5), (8, 5, 5, 6), (6, 0, 0, 0),
                  (10, 0, 0, 0), (11, 9, 9, 9), (12, 8, 8, 8), (16, 4, 4, 4))


def _bc6h_bits(layout: str):
    """[(end point value 0-11, bit)] of a layout, in stream order."""
    out = []
    for token in layout.split():
        channel, point = "rgb".index(token[0]), int(token[1])
        hi, _, lo = token[3:-1].partition(":")
        hi, lo = int(hi), int(lo or hi)
        bits = range(lo, hi + 1) if hi >= lo else range(lo, hi - 1, -1)
        out += [(3 * point + channel, b) for b in bits]
    return out


def bc6h_blocks(mode: int, count: int, rng, signed: bool = False) -> np.ndarray:
    """(count, 16) uint8 BC6H blocks of mode ``mode`` (0-13, see
    ``BC6H_MODE_BITS``) whose end points mostly decode to half floats in
    (1/255, 1) (above 0 where ``signed``): each base end point's top bits
    01 (signed: 001), the deltas small, the partition and index bits random;
    ``mode`` 14-17 gives the reserved modes' blocks of random bits."""
    blocks = rng.integers(0, 256, (count, 16), dtype=np.uint8)
    if mode >= 14:
        blocks[:, 0] = (blocks[:, 0] & 0xE0) | BC6H_RESERVED[mode - 14]
        return blocks
    mode_bits = 2 if mode < 2 else 5
    base, *deltas = BC6H_PRECISION[mode]
    top = 1 << (base - (3 if signed else 2))
    values = np.empty((count, 12), np.int64)
    values[:, :3] = top | rng.integers(0, top, (count, 3))
    for e in range(3, 12):
        width = deltas[e % 3]
        if width:  # a small signed delta in ``width`` bits
            span = min(1 << (width - 1), max(2, 1 << (base - 4)))
            values[:, e] = rng.integers(-span, span, count) & ((1 << width) - 1)
        else:
            values[:, e] = top | rng.integers(0, top, count)
    bits = np.unpackbits(blocks, axis=1, bitorder="little")
    bits[:, :mode_bits] = (BC6H_MODE_BITS[mode] >> np.arange(mode_bits)) & 1
    for i, (field, bit) in enumerate(_bc6h_bits(BC6H_LAYOUTS[mode])):
        bits[:, mode_bits + i] = (values[:, field] >> bit) & 1
    return np.packbits(bits, axis=1, bitorder="little")


def bc7_blocks(mode: int, count: int, rng) -> np.ndarray:
    """(count, 16) uint8 BC7 blocks of mode ``mode`` (0-7; 8: byte 0 is 0,
    no mode), the other bits random."""
    blocks = rng.integers(0, 256, (count, 16), dtype=np.uint8)
    blocks[:, 0] = 0 if mode == 8 else (blocks[:, 0] & ((0xFF << (mode + 1)) & 0xFF)) | (1 << mode)
    return blocks


# ---------------------------- FTEX, BLP, ICNS and the small raster formats

def ftex_file(width: int, height: int, body: bytes, kind: int, size: int = None,
              formats: int = 1) -> bytes:
    """An FTEX file of one format (0 DXT1, 1 raw RGB): its one mipmap right
    after the 32-byte header, ``size`` its length field (``len(body)``)."""
    head = b"FTEX" + struct.pack("<7i", 1, width, height, 1, formats, kind, 32)
    return head + struct.pack("<i", len(body) if size is None else size) + body


def blp1_file(width: int, height: int, mipmap: bytes, compression: int = 1, alpha: int = 0,
              encoding: int = 5, palette: bytes = None, jpeg_header: bytes = b"") -> bytes:
    """A BLP1 file: palette (compression 1: 256 BGRA entries, then the
    indices) or JPEG (compression 0: the shared header, then the mipmap)."""
    head = b"BLP1" + struct.pack("<iIIIiI", compression, alpha, width, height, encoding, 0)
    if compression == 0:
        extra = struct.pack("<I", len(jpeg_header)) + jpeg_header
    else:
        extra = palette if palette is not None else bytes(1024)
    start = 28 + 128 + len(extra)
    table = struct.pack("<16I", start, *[0] * 15) + struct.pack("<16I", len(mipmap), *[0] * 15)
    return head + table + extra + mipmap


def blp2_file(width: int, height: int, mipmap: bytes, encoding: int = 1, alpha: int = 0,
              alpha_encoding: int = 0, palette: bytes = None) -> bytes:
    """A BLP2 file: palette (encoding 1) or DXT (encoding 2; alpha encoding
    0 DXT1, 1 DXT3, 7 DXT5), the mipmap after the 1,024-byte palette."""
    head = b"BLP2" + struct.pack("<ibbbbII", 1, encoding, alpha, alpha_encoding, 0, width,
                                 height)
    table = struct.pack("<16I", 20 + 128 + 1024, *[0] * 15)
    table += struct.pack("<16I", len(mipmap), *[0] * 15)
    return head + table + (palette if palette is not None else bytes(1024)) + mipmap


def icns_rle(plane: bytes) -> bytes:
    """One ICNS run-length plane: runs of 3-130 bytes as ``run + 125`` and
    the byte, literals of 1-128 bytes as ``count - 1`` and the bytes."""
    out = bytearray()
    for run, value, count in _runs(list(plane), 128, min_run=3):
        if run:
            while count:
                k = min(count, 130)
                if k < 3:
                    out += bytes([k - 1]) + bytes([value] * k)
                else:
                    out += bytes([k + 125, value])
                count -= k
        else:
            out += bytes([count - 1]) + bytes(value)
    return bytes(out)


def icns_file(blocks) -> bytes:
    """An ICNS file of (type, payload) blocks."""
    body = b"".join(kind + struct.pack(">I", len(payload) + 8) + payload
                    for kind, payload in blocks)
    return b"icns" + struct.pack(">I", len(body) + 8) + body


def sun_rle(data: bytes) -> bytes:
    """A Sun raster byte-encoded stream: runs of 3-256 bytes (and any byte
    0x80) as 0x80, count - 1, value; 0x80 alone as 0x80 0."""
    out = bytearray()
    for run, value, count in _runs(list(data), 256, min_run=3):
        if run:
            out += bytes([0x80, count - 1, value])
        else:
            for v in value:
                out += b"\x80\x00" if v == 0x80 else bytes([v])
    return bytes(out)


def sun_file(width: int, height: int, depth: int, body: bytes, kind: int = 1,
             colours: bytes = b"", map_type: int = 1) -> bytes:
    """A Sun raster file: the 32-byte header, a colour map (planar R, G, B)
    and ``body``."""
    head = struct.pack(">8I", 0x59A66A95, width, height, depth, len(body), kind,
                       map_type if colours else 0, len(colours))
    return head + colours + body


def msp_file(rows, width: int, height: int) -> bytes:
    """A version 2 (run-length) MSP file of (h, (w + 7) // 8) bit rows."""
    lines = []
    for row in np.asarray(rows, np.uint8):
        out = bytearray()
        for run, value, count in _runs(list(row), 255, min_run=3):
            out += bytes([0, count, value]) if run else bytes([count]) + bytes(value)
        lines.append(bytes(out))
    words = [0x694C, 0x536E, width, height, 1, 1, 1, 1, width, height, 0, 0, 0, 0, 0, 0]
    check = 0
    for word in words:
        check ^= word
    words[12] = check
    return (struct.pack("<16H", *words) + struct.pack(f"<{height}H", *map(len, lines))
            + b"".join(lines))


def xbm_file(bits) -> bytes:
    """An X11 bitmap of (h, w) bool ``bits`` (the first pixel in a byte's
    low bit), as PIL's writer lays it out."""
    bits = np.asarray(bits, bool)
    h, w = bits.shape
    rows = np.packbits(bits, axis=1, bitorder="little").reshape(-1)
    body = ",".join(f"0x{v:02x}" for v in rows)
    return (f"#define im_width {w}\n#define im_height {h}\nstatic char im_bits[] = {{\n"
            f"{body}\n}};\n").encode()


def xpm_file(indices, colours, chars: int = 1, transparent: bool = False) -> bytes:
    """An XPM file of (h, w) ``indices`` into ``colours`` ((n, 3) uint8),
    each colour a key of ``chars`` characters; ``transparent`` adds a None
    colour no pixel uses."""
    alphabet = "".join(chr(c) for c in range(35, 127) if chr(c) not in '"\\')
    keys = []
    for i in range(len(colours) + int(transparent)):
        key, j = "", i
        for _ in range(chars):
            key, j = alphabet[j % len(alphabet)] + key, j // len(alphabet)
        keys.append(key)
    h, w = np.shape(indices)
    lines = ["/* XPM */", "static char *image[] = {", f'"{w} {h} {len(keys)} {chars}",']
    lines += [f'"{keys[i]} c #{r:02x}{g:02x}{b:02x}",' for i, (r, g, b) in enumerate(colours)]
    if transparent:
        lines.append(f'"{keys[-1]} c None",')
    lines.append("/* pixels */")
    lines += ['"' + "".join(keys[i] for i in row) + '",' for row in np.asarray(indices)]
    return ("\n".join(lines) + "\n};\n").encode()


def gbr_file(pixels, version: int = 2, comment: bytes = b"brush") -> bytes:
    """A GIMP brush of (h, w) grey or (h, w, 4) RGBA uint8 ``pixels``."""
    px = np.asarray(pixels, np.uint8)
    h, w = px.shape[:2]
    depth = 1 if px.ndim == 2 else 4
    extra = b"" if version == 1 else b"GIMP" + struct.pack(">I", 25)
    size = 20 + len(extra) + len(comment) + 1
    return (struct.pack(">5I", size, version, w, h, depth) + extra + comment + b"\0"
            + px.tobytes())


def pixar_file(rgb) -> bytes:
    """A PIXAR file of (h, w, 3) uint8 RGB (layout (14, 2))."""
    px = np.asarray(rgb, np.uint8)
    head = bytearray(1024)
    head[:4] = b"\x80\xe8\x00\x00"
    struct.pack_into("<HHHHHH", head, 416, px.shape[0], px.shape[1], 0, 0, 14, 2)
    return bytes(head) + px.tobytes()


def xvthumb_file(indices) -> bytes:
    """An XV thumbnail of (h, w) uint8 3-3-2 indices, with comment lines."""
    h, w = np.shape(indices)
    head = b"P7 332\n#XVVERSION:Version 2.28\n#BUILTIN:STRUCT\n#END_OF_COMMENTS\n"
    return head + b"%d %d 255\n" % (w, h) + np.asarray(indices, np.uint8).tobytes()


def mcidas_file(samples, size: int, prefix: int = 4) -> bytes:
    """A McIdas area of (h, w) samples of ``size`` bytes (1, 2 or 4,
    big-endian), each line after ``prefix`` bytes of its own."""
    px = np.asarray(samples)
    h, w = px.shape
    words = [0] * 64
    words[1], words[8], words[9], words[10], words[13], words[14], words[33] = (
        4, h, w, size, 1, prefix, 256)
    lines = np.zeros((h, prefix + w * size), np.uint8)
    lines[:, :prefix] = 0xAB
    lines[:, prefix:] = px.astype({1: "u1", 2: ">u2", 4: ">i4"}[size]).view(np.uint8).reshape(h, -1)
    return struct.pack(">64i", *words) + lines.tobytes()[prefix:]


def imt_file(grey, comment: bytes = b"*IM Tools image") -> bytes:
    """An IMT file of (h, w) uint8 grey pixels."""
    h, w = np.shape(grey)
    head = comment + b"\nwidth %d\nheight %d\npixel n8\n\x0c" % (w, h)
    return head + np.asarray(grey, np.uint8).tobytes()


def spider_file(values, order: str = ">") -> bytes:
    """A SPIDER 2D image of (h, w) float32 ``values`` in byte order ``order``."""
    px = np.asarray(values, np.float32)
    h, w = px.shape
    record = 4 * w
    records = -(-1024 // record)
    head = np.zeros(records * record // 4, np.float32)
    for i, v in ((0, 1), (1, h), (2, h), (4, 1), (11, w), (12, records),
                 (21, records * record), (22, record)):
        head[i] = v
    return head.astype(f"{order}f4").tobytes() + px.astype(f"{order}f4").tobytes()


def _fits_cards(cards) -> bytes:
    text = b"".join((key.ljust(8) + (b"= " + value.rjust(20) if value is not None else b"")
                     ).ljust(80) for key, value in cards) + b"END".ljust(80)
    return text.ljust(-(-len(text) // 2880) * 2880, b" ")


def fits_file(values, bitpix: int, pad: bool = True) -> bytes:
    """A FITS file of (h, w) ``values`` at ``bitpix`` (8, 16, 32, -32, -64),
    big-endian rows bottom-up, as the format stores them."""
    px = np.asarray(values)
    h, w = px.shape
    layout = {8: "u1", 16: ">i2", 32: ">i4", -32: ">f4", -64: ">f8"}[bitpix]
    head = _fits_cards([(b"SIMPLE", b"T"), (b"BITPIX", b"%d" % bitpix), (b"NAXIS", b"2"),
                        (b"NAXIS1", b"%d" % w), (b"NAXIS2", b"%d" % h)])
    body = px[::-1].astype(layout).tobytes()
    return head + (body.ljust(-(-len(body) // 2880) * 2880, b"\0") if pad else body)


def fits_gzip_file(values, zbitpix: int, pad: bool = False) -> bytes:
    """A tile-compressed FITS file (``ZCMPTYPE = 'GZIP_1'``) of (h, w)
    ``values``: an empty primary header, a one-row binary table and its
    heap, one gzip stream of big-endian 4-byte words (unpadded: PIL reads
    the heap to the file's end, and padding after it fails there)."""
    px = np.asarray(values)
    h, w = px.shape
    heap = gzip.compress(px.astype(">i4").tobytes(), mtime=0)
    primary = _fits_cards([(b"SIMPLE", b"T"), (b"BITPIX", b"8"), (b"NAXIS", b"0"),
                           (b"EXTEND", b"T")])
    ext = _fits_cards([(b"XTENSION", b"'BINTABLE'"), (b"BITPIX", b"8"), (b"NAXIS", b"2"),
                       (b"NAXIS1", b"8"), (b"NAXIS2", b"1"), (b"PCOUNT", b"%d" % len(heap)),
                       (b"GCOUNT", b"1"), (b"TFIELDS", b"1"), (b"ZIMAGE", b"T"),
                       (b"ZBITPIX", b"%d" % zbitpix), (b"ZNAXIS", b"2"), (b"ZNAXIS1", b"%d" % w),
                       (b"ZNAXIS2", b"%d" % h), (b"ZCMPTYPE", b"'GZIP_1  '")])
    body = struct.pack(">ii", len(heap), 0) + heap
    return primary + ext + (body.ljust(-(-len(body) // 2880) * 2880, b"\0") if pad else body)


def raw_format_files():
    """{name: file bytes}: small TGA, SGI, QOI, PCX, DCX, IM, DDS and DIB
    files of every layout the port's readers take (raw and run-length, the
    DDS block formats, each BC6H and BC7 mode, 16-bit SGI), a PFM row, and
    FTEX, BLP, ICNS, SUN, MSP, XBM, XPM, GBR, PIXAR, XVThumb, McIdas, IMT,
    SPIDER and FITS files, from seeded arrays; numpy only (``chip_smoke.py`` phase 14e decodes them on the card's machine and
    holds them to ``torch_writer_digests.json``, which
    ``tests/test_torch_writer_digests.py`` recomputes with PIL)."""
    rng = np.random.default_rng(2121)
    h, w = 13, 19
    px = np.repeat(rng.integers(0, 256, (h, w // 3 + 1, 4), dtype=np.uint8), 3, axis=1)[:, :w]
    px[4:7, 5:] = px[4, 5]
    rgb, grey = px[:, :, :3], px[:, :, 0]
    bgr = np.ascontiguousarray(rgb[:, :, ::-1])
    bgra = np.ascontiguousarray(px[:, :, [2, 1, 0, 3]])
    v16 = (rgb[:, :, 0].astype(np.uint16) >> 3 << 10 | rgb[:, :, 1].astype(np.uint16) >> 3 << 5
           | rgb[:, :, 2] >> 3 | (grey.astype(np.uint16) & 0x80) << 8)
    planes = np.moveaxis(px, 2, 0)
    pal = rng.integers(0, 256, (256, 3), dtype=np.uint8)
    idx = (grey >> 2).astype(np.uint8)
    blocks = ((w + 3) // 4) * ((h + 3) // 4)
    out = {
        "tga_rgb_raw.tga": tga_file(bgr[::-1].tobytes(), w, h, 2, 24),
        "tga_rgba_raw_flipped.tga": tga_file(bgra[:, ::-1].tobytes(), w, h, 2, 32, 0x38),
        "tga_rgb_rle_rows.tga": tga_file(tga_rle(bgr.tobytes(), 3, w), w, h, 10, 24, 0x20),
        "tga_rgba_rle_literals.tga": tga_file(tga_rle(bgra.tobytes(), 4, None), w, h, 10, 32, 0x28),
        "tga_mapped_rle_15bit.tga": tga_file(tga_rle(idx.tobytes(), 1, w), w, h, 9, 8, 0x20,
                                             colour_map=rng.integers(0, 256, 128, np.uint8
                                                                     ).tobytes(), map_start=2,
                                             map_depth=16),
        "tga_grey_raw.tga": tga_file(grey[::-1].tobytes(), w, h, 3, 8),
        "tga_la_rle.tga": tga_file(tga_rle(px[:, :, :2].tobytes(), 2, w), w, h, 11, 16, 0x20),
        "tga_15bit_raw.tga": tga_file(v16.astype("<u2")[::-1].tobytes(), w, h, 2, 16),
        "tga_1bit_raw.tga": tga_file(np.packbits(grey > 99, axis=1)[::-1].tobytes(), w, h, 3, 1),
        "sgi_grey_raw.bw": sgi_file(grey[None]),
        "sgi_rgb_16bit_raw.rgb": sgi_file(planes[:3].astype(np.uint16) * 257 + 3),
        "sgi_rgba_rle.rgba": sgi_file(planes, rle=True),
        "sgi_rgb_16bit_rle.sgi": sgi_file(planes[:3].astype(np.uint16) * 251, rle=True),
        "qoi_rgb.qoi": qoi_file(rgb),
        "qoi_rgba.qoi": qoi_file(px),
        "pcx_rgb.pcx": pcx_file(pcx_rle(np.pad(np.moveaxis(rgb, 2, 1), ((0, 0), (0, 0), (0, 1)))
                                        .reshape(h, -1)), w, h, 8, 3, w + 1),
        "pcx_palette.pcx": pcx_file(pcx_rle(np.pad(idx, ((0, 0), (0, 1)))), w, h, 8, 1, w + 1,
                                    palette=pal.tobytes()),
        "pcx_16_colours.pcx": pcx_file(pcx_rle(np.concatenate(
            [np.packbits((grey >> (4 + k)) & 1, axis=1) for k in range(4)], axis=1)), w, h, 1, 4,
            (w + 7) // 8, 3, header_palette=pal[:16].tobytes()),
        "pcx_1bit.pcx": pcx_file(pcx_rle(np.packbits(grey > 99, axis=1)), w, h, 1, 1,
                                 (w + 7) // 8, 2),
        "dcx_rgb.dcx": dcx_file([pcx_file(pcx_rle(np.moveaxis(rgb[:, :18], 2, 1).reshape(h, -1)),
                                          18, h, 8, 3, 18)]),
        "im_rgb.im": im_file([b"Image type: RGB image", b"Image size (x*y): %d*%d" % (w, h)],
                             np.moveaxis(rgb[::-1], 2, 1).tobytes()),
        "im_grey.im": im_file([b"Image type: Greyscale image", b"Image size (x*y): %d*%d" % (w, h)],
                              grey[::-1].tobytes()),
        "im_palette.im": im_file([b"Image type: Greyscale image",
                                  b"Image size (x*y): %d*%d" % (w, h), b"Lut: 1"],
                                 idx[::-1].tobytes(), lut=pal.T.tobytes()),
        "im_float.im": im_file([b"Image type: L 32F image", b"Image size (x*y): %d*%d" % (w, h)],
                               (grey[::-1].astype("<f4") / 3 - 7).tobytes()),
        "im_12bit.im": im_file([b"Image type: L*12 image", b"Image size (x*y): %d*%d" % (w, h)],
                               rng.integers(0, 256, h * w * 2, dtype=np.uint8).tobytes()),
        "im_16bit.im": im_file([b"Image type: L 16 image", b"Image size (x*y): %d*%d" % (w, h)],
                               (grey[::-1].astype("<u2") * 257).tobytes()),
        "im_ycbcr.im": im_file([b"Image type: YCC image", b"Image size (x*y): %d*%d" % (w, h)],
                               np.moveaxis(rgb[::-1], 2, 1).tobytes()),
        "im_planes.im": im_file([b"Image type: RGB3 image", b"Image size (x*y): %d*%d" % (w, h)],
                                np.moveaxis(rgb[::-1], 2, 0)[[1, 0, 2]].tobytes()),
        "dds_565.dds": dds_file(w, h, (v16 & 0x7FFF).astype("<u2").tobytes(), 0x40, bits=16,
                                masks=(0xF800, 0x7E0, 0x1F, 0)),
        "dds_bgra.dds": dds_file(w, h, bgra.tobytes(), 0x41, bits=32,
                                 masks=(0xFF0000, 0xFF00, 0xFF, 0xFF000000)),
        "dds_luminance.dds": dds_file(w, h, grey.tobytes(), 0x20000, bits=8),
        "dds_luminance_alpha.dds": dds_file(w, h, px[:, :, :2].tobytes(), 0x20001, bits=16),
        "dds_palette.dds": dds_file(w, h, idx.tobytes(), 0x20, bits=8,
                                    palette=rng.integers(0, 256, 1024, np.uint8).tobytes()),
        "dds_rgba_dx10.dds": dds_file(w, h, px.tobytes(), 0x4, b"DX10", dxgi=28),
        "pfm_row.pfm": netpbm_file(b"Pf", (grey.astype(np.float32) * 1.7 - 25).astype(np.float32)),
        "dib_rgb.dib": bmp_file(rgb, 24)[14:],
        "dib_palette.dib": bmp_file(idx, 8, palette=pal)[14:],
    }
    for name, fourcc, dxgi, size in (("dxt1", b"DXT1", None, 8), ("dxt3", b"DXT3", None, 16),
                                     ("dxt5", b"DXT5", None, 16), ("bc4", b"BC4U", None, 8),
                                     ("bc5", b"BC5U", None, 16), ("bc5_signed", b"BC5S", None, 16),
                                     ("bc1_dx10", b"DX10", 71, 8), ("bc3_dx10", b"DX10", 77, 16)):
        body = rng.integers(0, 256, blocks * size, dtype=np.uint8).tobytes()
        out[f"dds_{name}.dds"] = dds_file(w, h, body, 0x4, fourcc, dxgi=dxgi)
    # BC6H (unsigned and signed) and BC7, one file a mode
    for mode in range(14):
        for signed in (False, True):
            body = bc6h_blocks(mode, blocks, rng, signed).tobytes()
            out[f"dds_bc6h{'s' if signed else ''}_mode{mode:02d}.dds"] = dds_file(
                w, h, body, 0x4, b"DX10", dxgi=96 if signed else 95)
    for mode in range(8):
        out[f"dds_bc7_mode{mode}.dds"] = dds_file(w, h, bc7_blocks(mode, blocks, rng).tobytes(),
                                                  0x4, b"DX10", dxgi=98)
    # FTEX, BLP, ICNS and the small raster formats
    palette = rng.integers(0, 256, 1024, dtype=np.uint8).tobytes()
    dxt = {k: rng.integers(0, 256, blocks * k, dtype=np.uint8).tobytes() for k in (8, 16)}
    icon = np.repeat(np.repeat(px[:4, :4], 4, 0), 4, 1)
    planes = b"".join(icns_rle(np.ascontiguousarray(icon[:, :, c]).tobytes()) for c in range(3))
    sun_rows = np.pad(bgr.reshape(h, -1), ((0, 0), (0, 1)))
    bits = grey > 99
    out.update({
        "ftex_dxt1.ftu": ftex_file(w, h, dxt[8], 0),
        "ftex_rgb.ftc": ftex_file(w, h, rgb.tobytes(), 1),
        "blp1_palette.blp": blp1_file(w, h, idx.tobytes(), 1, 8, 5, palette),
        "blp2_dxt1.blp": blp2_file(w, h, dxt[8], 2, 1, 0),
        "blp2_dxt3.blp": blp2_file(w, h, dxt[16], 2, 8, 1),
        "blp2_dxt5.blp": blp2_file(w, h, dxt[16], 2, 8, 7),
        "blp2_palette.blp": blp2_file(w, h, idx.tobytes(), 1, 0, 0, palette),
        "icns_rle_mask.icns": icns_file([(b"is32", planes), (b"s8mk", icon[:, :, 3].tobytes())]),
        "icns_rle_rgb.icns": icns_file([(b"is32", planes)]),
        "sun_raw.ras": sun_file(w, h, 24, sun_rows.tobytes()),
        "sun_rle.ras": sun_file(w, h, 8, sun_rle(idx.tobytes()), 2, palette[:300]),
        "msp_v2.msp": msp_file(np.packbits(bits, axis=1), w, h),
        "xbm.xbm": xbm_file(bits),
        "xpm.xpm": xpm_file(idx % 9, pal[:9], 1),
        "gbr_v2.gbr": gbr_file(px),
        "pixar.pxr": pixar_file(rgb),
        "xvthumb.xv": xvthumb_file(idx),
        "mcidas_8bit.area": mcidas_file(grey, 1),
        "mcidas_16bit.area": mcidas_file(grey.astype(np.uint16) * 257, 2),
        "mcidas_32bit.area": mcidas_file(grey.astype(np.int64) * 3 - 1, 4),
        "imt.imt": imt_file(grey),
        "spider.spi": spider_file(grey.astype(np.float32) / 3 - 7),
        "fits_8bit.fits": fits_file(grey, 8),
        "fits_float.fits": fits_file(grey / 3 - 7, -32),
        "fits_gzip.fits": fits_gzip_file(grey.astype(np.int64) * 99, 16),
    })
    return out


def _block_corners(rgb, h: int, w: int):
    """(bh, bw, c) the first pixel of each 4 x 4 block of ``rgb`` (edge
    blocks padded)."""
    bh, bw = -(-h // 4), -(-w // 4)
    return np.pad(rgb, ((0, 4 * bh - h), (0, 4 * bw - w), (0, 0)), mode="edge")[::4, ::4]


def _blocks_to_image(block_px, h: int, w: int):
    """(h, w, c) of (bh * bw, 16, c) block pixels, the blocks past the edge cut."""
    bh, bw = -(-h // 4), -(-w // 4)
    c = block_px.shape[-1]
    return block_px.reshape(bh, bw, 4, 4, c).transpose(0, 2, 1, 3, 4).reshape(
        4 * bh, 4 * bw, c)[:h, :w]


def bc6h_half_bytes(x10) -> np.ndarray:
    """uint8 of an unsigned BC6H mode 10 end point's 10-bit values,
    interpolated with weight 0: the format's unquantization, its 31 / 64
    to a half float, then clamped to 0..1 and truncated to 8 bits in
    float32, as PIL converts them."""
    x = np.asarray(x10, np.int64)
    unq = np.where(x == 0, 0, np.where(x == 1023, 0xFFFF, ((x << 15) + 0x4000) >> 9))
    f = (unq * 31 // 64).astype(np.uint16).view(np.float16).astype(np.float32)
    return (np.clip(f, 0, 1) * np.float32(255)).astype(np.uint8)


def full_size_block_files(rgb):
    """{name: (file bytes, (pixels, mode) the port must decode, the RGB)}:
    DDS BC7 and BC6H, BLP2 DXT5 and FITS (BITPIX -32) files of (h, w, 3)
    uint8 ``rgb``, written in numpy at full size; each decodes to an array
    known without a decoder: BC7 mode 6 blocks of two 8-bit colours (each
    channel's low bit the end point's p-bit) at weights 0 and 64, BC6H mode
    10 blocks of one colour (``bc6h_half_bytes``), BLP2 DXT5 blocks of two
    5-6-5 colours widened by shifts (PIL's Python) and two alphas, sheared
    where the width is not a multiple of 4 as PIL reads them, and FITS
    float32 samples stored in the little-endian bytes PIL reads them in."""
    h, w = rgb.shape[:2]
    bh, bw = -(-h // 4), -(-w // 4)
    n = bh * bw
    corner = _block_corners(rgb, h, w).reshape(n, 3).astype(np.int64)
    left = (np.arange(16) % 4) < 2  # a block's left half the first colour
    # BC7 mode 6: bit 6 of byte 0, then R0 R1 G0 G1 B0 B1 A0 A1 (7 bits), P0 P1,
    # the indices (pixel 0 of 3 bits): 0 or 15
    e0 = np.concatenate([corner & ~1, np.full((n, 1), 254)], 1)
    e1 = np.concatenate([(corner ^ 0x21) | 1, np.full((n, 1), 255)], 1)
    bits = np.zeros((n, 128), np.uint8)
    bits[:, 6] = 1
    at = 7
    for c in range(4):
        for e in (e0, e1):
            bits[:, at:at + 7] = (e[:, c:c + 1] >> (1 + np.arange(7))) & 1
            at += 7
    bits[:, at], bits[:, at + 1] = 0, 1
    at += 2
    bits[:, at + 3:] = ((np.where(left[1:], 0, 15)[:, None] >> np.arange(4)) & 1).reshape(-1)
    bc7 = np.packbits(bits, axis=1, bitorder="little")
    bc7_px = _blocks_to_image(np.where(left[None, :, None], e0[:, None, :], e1[:, None, :]),
                              h, w).astype(np.uint8)
    # BC6H mode 10 ("00011"): three 10-bit end point 0 values, every index 0
    x10 = 256 + corner * 239 // 255
    bits = np.zeros((n, 128), np.uint8)
    bits[:, :5] = [1, 1, 0, 0, 0]
    for c in range(3):
        bits[:, 5 + 10 * c:15 + 10 * c] = (x10[:, c:c + 1] >> np.arange(10)) & 1
    bc6 = np.packbits(bits, axis=1, bitorder="little")
    bc6_px = _blocks_to_image(np.repeat(bc6h_half_bytes(x10)[:, None, :], 16, 1), h, w)
    # BLP2 DXT5: a0 a1, alpha codes 0 / 1, then DXT1's c0 c1 and codes 0 / 1
    c565 = (corner[:, 0] >> 3 << 11) | (corner[:, 1] >> 2 << 5) | (corner[:, 2] >> 3)
    c565b = c565 ^ 0x0821
    blocks = np.zeros((n, 16), np.uint8)
    blocks[:, 0], blocks[:, 1] = 250, 120
    codes = np.where(left, 0, 1)
    alpha = (codes << (3 * np.arange(16))).sum()
    blocks[:, 2:8] = np.frombuffer(int(alpha).to_bytes(6, "little"), np.uint8)
    blocks[:, 8:12] = np.stack([c565, c565b], 1).astype("<u2").view(np.uint8).reshape(n, 4)
    blocks[:, 12:16] = np.frombuffer(int((codes << (2 * np.arange(16))).sum()).to_bytes(
        4, "little"), np.uint8)

    def widen(c):
        return np.stack([(c >> 11 & 31) << 3, (c >> 5 & 63) << 2, (c & 31) << 3], -1)

    dxt_px = np.where(left[None, :, None],
                      np.concatenate([widen(c565), np.full((n, 1), 250)], 1)[:, None, :],
                      np.concatenate([widen(c565b), np.full((n, 1), 120)], 1)[:, None, :])
    # PIL reads the rows of the blocks' padded width as rows of the image's
    dxt_px = _blocks_to_image(dxt_px, 4 * bh, 4 * bw).astype(np.uint8).reshape(-1)[:h * w * 4]
    dxt_px = dxt_px.reshape(h, w, 4)
    # FITS -32: grey + 0.25 as float32, little-endian as PIL reads BITPIX -32
    values = rgb[:, :, 1].astype(np.float32) + np.float32(0.25)
    head = _fits_cards([(b"SIMPLE", b"T"), (b"BITPIX", b"-32"), (b"NAXIS", b"2"),
                        (b"NAXIS1", b"%d" % w), (b"NAXIS2", b"%d" % h)])
    fits = head + values[::-1].astype("<f4").tobytes()
    grey = np.repeat(rgb[:, :, 1:2], 3, axis=2)
    return {f"dds_bc7_{h}x{w}.dds": (dds_file(w, h, bc7.tobytes(), 0x4, b"DX10", dxgi=98),
                                     (bc7_px, "RGBA"), bc7_px[:, :, :3]),
            f"dds_bc6h_{h}x{w}.dds": (dds_file(w, h, bc6.tobytes(), 0x4, b"DX10", dxgi=95),
                                      (bc6_px, "RGB"), bc6_px),
            f"blp2_dxt5_{h}x{w}.blp": (blp2_file(w, h, blocks.tobytes(), 2, 8, 7),
                                       (dxt_px, "RGBA"), dxt_px[:, :, :3]),
            f"fits_float_{h}x{w}.fits": (fits, (values, "F"), grey)}


def full_size_raw_files(rgb):
    """{name: (file bytes, (pixels, mode) the port must decode, the RGB)}:
    TGA (run-length), SGI (run-length), IM, DDS (BC1 and uncompressed) files
    of (h, w, 3) uint8 ``rgb`` whose rows come in pairs of equal pixels (w
    even), written in numpy at full size; each decodes to exactly the array
    it was written from (BC1: ``rgb`` made of two 5-6-5 colours a block
    first, the blocks past the edge cut)."""
    h, w = rgb.shape[:2]
    pairs = rgb[:, ::2]
    if w % 2 or (rgb != np.repeat(pairs, 2, axis=1)).any():
        raise ValueError("full_size_raw_files takes rows of pairs of equal pixels")
    # TGA: one run packet a pair, rows top-down
    packets = np.concatenate([np.full(pairs.shape[:2] + (1,), 0x81, np.uint8),
                              pairs[:, :, ::-1]], axis=2)
    tga = tga_file(packets.tobytes(), w, h, 10, 24, 0x20)
    # SGI: each row of each channel as runs of 2, then the end marker; rows bottom-up
    planes = np.moveaxis(pairs[::-1], 2, 0)  # (3, h, w / 2)
    rows = np.concatenate([np.stack([np.full_like(planes, 2), planes], 3).reshape(3, h, -1),
                           np.zeros((3, h, 1), np.uint8)], axis=2)
    length = rows.shape[2]
    starts = 512 + 8 * 3 * h + length * np.arange(3 * h)
    head = struct.pack(">hBBHHHHll4s79ssl404s", 474, 1, 1, 3, w, h, 3, 0, 255, b"", b"", b"", 0,
                       b"")
    sgi = (head + starts.astype(">u4").tobytes() + np.full(3 * h, length, ">u4").tobytes()
           + rows.tobytes())
    im = im_file([b"Image type: RGB image", b"Image size (x*y): %d*%d" % (w, h)],
                 np.ascontiguousarray(np.moveaxis(rgb[::-1], 2, 1)).tobytes())
    # BC1: each 4 x 4 block of its first pixel's 5-6-5 colour and a neighbour
    # of it, the left half of the block one and the right half the other
    bh, bw = -(-h // 4), -(-w // 4)
    corner = np.pad(rgb, ((0, 4 * bh - h), (0, 4 * bw - w), (0, 0)), mode="edge")[::4, ::4]
    c565 = ((corner[:, :, 0].astype(np.uint16) >> 3) << 11
            | (corner[:, :, 1].astype(np.uint16) >> 2) << 5 | corner[:, :, 2] >> 3)
    colours = np.stack([c565, c565 ^ 0x0821], -1).reshape(-1, 2)
    indices = np.tile(np.tile([0, 0, 1, 1], 4), (bh * bw, 1))
    block_px = expand_565(colours)[np.arange(bh * bw)[:, None], indices]  # (n, 16, 3)
    bc1_rgb = block_px.reshape(bh, bw, 4, 4, 3).transpose(0, 2, 1, 3, 4).reshape(
        4 * bh, 4 * bw, 3)[:h, :w]
    bc1 = dds_file(w, h, bc1_blocks(colours, indices), 0x4, b"DXT1")
    dds = dds_file(w, h, np.ascontiguousarray(rgb[:, :, ::-1]).tobytes(), 0x40, bits=24,
                   masks=(0xFF0000, 0xFF00, 0xFF, 0))
    rgba = np.dstack([bc1_rgb, np.full((h, w), 255, np.uint8)])
    return {f"tga_rle_{h}x{w}.tga": (tga, (rgb, "RGB"), rgb),
            f"sgi_rle_{h}x{w}.sgi": (sgi, (rgb, "RGB"), rgb),
            f"im_rgb_{h}x{w}.im": (im, (rgb, "RGB"), rgb),
            f"dds_bc1_{h}x{w}.dds": (bc1, (rgba, "RGBA"), bc1_rgb),
            f"dds_bgr_{h}x{w}.dds": (dds, (rgb, "RGB"), rgb)}
