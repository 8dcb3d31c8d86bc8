"""Blizzard mipmaps (BLP1 and BLP2) decoded as PIL 12.1's
``BlpImagePlugin`` decodes them, with numpy and the port's JPEG decoder.

``decode_blp_image(data)`` returns ``(pixels, mode, None)``:
``np.asarray(PIL.Image.open(BytesIO(data)))``, "RGBA" where the header's
alpha field is set and "RGB" otherwise.  The first mipmap is decoded as
PIL's Python decoders decode it:

  BLP1 JPEG (compression 0)   the shared header joined to the mipmap's
                              bytes and read by ``data/jpeg.py``; a CMYK
                              stream as PIL's CMYK, the RGB stored as raw
                              "BGR", so red and blue swap, opaque in an
                              "RGBA" image (``BlpImagePlugin.py:366-383``);
                              a YCCK stream, which PIL's raw "CMYK" reads
                              otherwise, raises
  BLP1 palette (encodings 4, 5),
  BLP2 palette (encoding 1)   256 BGRA entries, then one index a pixel
                              (BLP1: right after the palette; BLP2: at the
                              mipmap's offset), ``length`` of them read
  BLP2 DXT1, DXT3, DXT5       PIL's own Python formulas
  (encoding 2; alpha           (``decode_dxt1``, ``decode_dxt3``,
  encoding 0, 1, 7)            ``decode_dxt5``): 5-6-5 colours widened by
                              shifts alone, thirds ``(2 * c0 + c1) // 3``,
                              not DDS's BC1-BC3 (``bcn``), whose colours
                              replicate their high bits; each block row as
                              four rows of the blocks' padded width, the
                              bytes then read as the image's rows

The pixels come from a byte stream PIL reads as raw rows of the image's
width, so a stream of another width (a JPEG of another size, a DXT image
whose width is not a multiple of 4) shears as in PIL, and one too short
raises.  A cut file raises as PIL's ``_safe_read`` raises.
"""

import struct

import numpy as np

from ifseg_torch.data import jpeg
from ifseg_torch.data.png import check_pixels, to_rgb

SIGNATURES = (b"BLP1", b"BLP2")


def is_blp(data: bytes) -> bool:
    """PIL opens the file as BLP: its signature, a whole header and a size."""
    if data[:4] not in SIGNATURES or len(data) < (28 if data[:4] == b"BLP1" else 20):
        return False
    return 0 not in struct.unpack_from("<II", data, 12)


def _read(data: bytes, pos: int, size: int) -> bytes:
    """``ImageFile._safe_read``: ``size`` bytes at ``pos``, or raise."""
    if size <= 0:
        return b""
    chunk = data[pos:pos + size]
    if len(chunk) < size:
        raise ValueError("truncated BLP file")
    return chunk


def _unpack_565(c: np.ndarray):
    c = c.astype(np.int32)
    return np.stack([((c >> 11) & 0x1F) << 3, ((c >> 5) & 0x3F) << 2, (c & 0x1F) << 3], -1)


def _dxt_colours(blocks: np.ndarray, three_colour: bool):
    """(n, 16, 4) RGBA of the colour halves (n, 8) of DXT blocks by PIL's
    formulas; ``three_colour`` lets c0 <= c1 pick DXT1's 3-colour mode."""
    c0 = blocks[:, 0].astype(np.int32) | blocks[:, 1].astype(np.int32) << 8
    c1 = blocks[:, 2].astype(np.int32) | blocks[:, 3].astype(np.int32) << 8
    bits = blocks[:, 4:8].copy().view("<u4")[:, 0].astype(np.int64)
    e0, e1 = _unpack_565(c0), _unpack_565(c1)
    table = np.zeros((len(blocks), 4, 4), np.int32)
    table[:, 0, :3], table[:, 1, :3] = e0, e1
    table[:, 2, :3] = (2 * e0 + e1) // 3
    table[:, 3, :3] = (2 * e1 + e0) // 3
    table[:, :, 3] = 255
    if three_colour:
        low = c0 <= c1
        table[low, 2, :3] = (e0[low] + e1[low]) // 2
        table[low, 3] = 0
    codes = (bits[:, None] >> (2 * np.arange(16))) & 3
    return np.take_along_axis(table, codes[:, :, None], 1)


def _dxt(body: bytes, kind: int, bw: int, bh: int, alpha: bool) -> np.ndarray:
    """(4 * bh, 4 * bw, bands) uint8 of PIL's BLP2 DXT decoders."""
    size = 8 if kind == 0 else 16
    blocks = np.frombuffer(body, np.uint8, count=bw * bh * size).reshape(-1, size)
    if kind == 0:
        px = _dxt_colours(blocks, True)
        if not alpha:
            px = px[:, :, :3]
    else:
        px = _dxt_colours(blocks[:, 8:], False)
        n = np.arange(16)
        if kind == 1:
            nibbles = (blocks[:, n // 2] >> (4 * (n % 2))) & 0xF
            px[:, :, 3] = nibbles.astype(np.int32) * 17
        else:
            a0, a1 = blocks[:, 0].astype(np.int32), blocks[:, 1].astype(np.int32)
            code2 = blocks[:, 2].astype(np.int64) | blocks[:, 3].astype(np.int64) << 8
            code1 = (blocks[:, 4].astype(np.int64) | blocks[:, 5].astype(np.int64) << 8
                     | blocks[:, 6].astype(np.int64) << 16 | blocks[:, 7].astype(np.int64) << 24)
            at = 3 * n
            code = np.where(at <= 12, (code2[:, None] >> np.minimum(at, 12)) & 7,
                            np.where(at == 15, (code2[:, None] >> 15) | ((code1[:, None] << 1) & 6),
                                     (code1[:, None] >> np.maximum(at - 16, 0)) & 7))
            a0, a1 = a0[:, None], a1[:, None]
            seven = ((8 - code) * a0 + (code - 1) * a1) // 7
            five = ((6 - code) * a0 + (code - 1) * a1) // 5
            value = np.where(a0 > a1, seven, np.where(code == 6, 0, np.where(code == 7, 255, five)))
            px[:, :, 3] = np.where(code == 0, a0, np.where(code == 1, a1, value))
    bands = px.shape[2]
    return (px.reshape(bh, bw, 4, 4, bands).transpose(0, 2, 1, 3, 4)
            .reshape(4 * bh, 4 * bw, bands).astype(np.uint8))


def _as_raw(stream: bytes, width: int, height: int, bands: int) -> np.ndarray:
    """``set_as_raw``: the stream's first rows of the image's width, or raise."""
    need = width * height * bands
    if len(stream) < need:
        raise ValueError("BLP stream holds too few pixels (not enough image data)")
    return np.frombuffer(stream, np.uint8, count=need).reshape(height, width, bands).copy()


def _palette(data: bytes, pos: int) -> np.ndarray:
    """(256, 4) uint8 RGBA of the 256 BGRA entries at ``pos``."""
    return np.frombuffer(_read(data, pos, 1024), np.uint8).reshape(256, 4)[:, [2, 1, 0, 3]]


def _adobe_transform(stream: bytes):
    """The transform byte of a JPEG's Adobe APP14 segment before its first
    scan, None without one."""
    pos = 2
    while pos + 4 <= len(stream) and stream[pos] == 0xFF:
        marker = stream[pos + 1]
        size = struct.unpack_from(">H", stream, pos + 2)[0]
        if marker == 0xDA:
            break
        body = stream[pos + 4:pos + 2 + size]
        if marker == 0xEE and body.startswith(b"Adobe") and len(body) >= 12:
            return body[11]
        pos += 2 + size
    return None


def _jpeg(data: bytes, pos: int, offset: int, length: int) -> np.ndarray:
    """BLP1's JPEG mipmap as PIL's ``_decode_jpeg_stream`` stores it: the
    RGB of the joined stream, red and blue swapped."""
    head_size = struct.unpack("<I", _read(data, pos, 4))[0]
    head = _read(data, pos + 4, head_size)
    pos += 4 + head_size
    pos += len(_read(data, pos, offset - pos))
    stream = head + _read(data, pos, length)
    if _adobe_transform(stream) == 2:
        raise ValueError("BLP1 JPEG of YCCK samples is not supported (PIL reads it with the "
                         "raw CMYK unpacker, which the port does not copy)")
    pixels = jpeg.decode_jpeg(stream)
    rgb = to_rgb(pixels, mode="CMYK" if pixels.ndim == 3 and pixels.shape[2] == 4 else None)
    return np.ascontiguousarray(rgb[:, :, ::-1])


def decode_blp_image(data: bytes):
    """(pixels, PIL's mode, None) of a BLP file (see the module docstring)."""
    data = bytes(data)
    magic = data[:4]
    if not is_blp(data):
        raise ValueError("not a BLP file PIL opens (signature, header or size)")
    compression = struct.unpack_from("<i", data, 4)[0]
    if magic == b"BLP1":
        alpha = struct.unpack_from("<I", data, 8)[0] != 0
        width, height, encoding = struct.unpack_from("<IIi", data, 12)
        pos = 28
    else:
        encoding, alpha_flag, alpha_encoding = struct.unpack_from("<bbb", data, 8)
        alpha = alpha_flag != 0
        width, height = struct.unpack_from("<II", data, 12)
        pos = 20
    mode = "RGBA" if alpha else "RGB"
    check_pixels(width, height, "BLP")
    offsets = struct.unpack("<16I", _read(data, pos, 64))
    lengths = struct.unpack("<16I", _read(data, pos + 64, 64))
    pos += 128
    bands = len(mode)
    if magic == b"BLP1" and compression == 0:
        bgr = _jpeg(data, pos, offsets[0], lengths[0])
        check_pixels(bgr.shape[1], bgr.shape[0], "BLP's JPEG")
        pixels = _as_raw(bgr.tobytes(), width, height, 3)
        if alpha:  # "BGR" into "RGBA": opaque
            pixels = np.dstack([pixels, np.full((height, width), 255, np.uint8)])
        return pixels, mode, None
    if compression != 1:
        raise ValueError(f"BLP compression {compression} is not one PIL reads")
    if magic == b"BLP1" and encoding not in (4, 5):
        raise ValueError(f"BLP1 encoding {encoding} is not one PIL reads")
    palette = _palette(data, pos)
    pos += 1024
    if magic == b"BLP2":
        pos = offsets[0]
    if magic == b"BLP1" or encoding == 1:
        index = np.frombuffer(_read(data, pos, lengths[0]), np.uint8)
        return _as_raw(palette[index, :bands].tobytes(), width, height, bands), mode, None
    if encoding != 2:
        raise ValueError(f"BLP2 encoding {encoding} is not one PIL reads")
    kinds = {0: 0, 1: 1, 7: 2}
    if alpha_encoding not in kinds:
        raise ValueError(f"BLP2 alpha encoding {alpha_encoding} is not one PIL reads")
    kind = kinds[alpha_encoding]
    bw, bh = (width + 3) // 4, (height + 3) // 4
    body = _read(data, pos, bw * bh * (8 if kind == 0 else 16))
    stream = _dxt(body, kind, bw, bh, alpha).tobytes()
    return _as_raw(stream, width, height, bands), mode, None
