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
