"""Apple icon files (ICNS) decoded as PIL 12.1's ``IcnsImagePlugin`` decodes
them, with numpy, ``data/png.py`` and ``data/jpeg2000.py``.

``decode_icns_image(data)`` returns ``(pixels, mode, palette)``:
``np.asarray(PIL.Image.open(BytesIO(data)))``, PIL's mode and a PNG entry's
palette.  The big-endian blocks (type, length) up to the header's file
size are indexed by type, a later block of a type replacing an earlier one;
PIL's ``bestsize`` is the largest (width, height, scale) with a block, and
``getimage`` reads that size's types in PIL's order:

  ic07-ic14, icp4-icp6  a PNG (``data/png.py``, read from the block's start
                        to the PNG's own end, in its own mode) or a JPEG
                        2000 stream (``data/jpeg2000.py``, the block's
                        bytes, converted to "RGBA"); the first of the size
                        is the image, whose size must be one of the sizes
                        the file has at some scale, as PIL's ``size``
                        setter asks
  it32, ih32, il32,     24-bit colour, raw where the block holds exactly
  is32                  three planes, else three run-length planes (a byte
                        of 128 or more: ``byte - 125`` copies of the next
                        byte; less: ``byte + 1`` literal bytes), read on
                        past the block's end; "RGB"
  t8mk, h8mk, l8mk,     the 8-bit alpha of the colour above: "RGBA"
  s8mk

What PIL refuses raises ``ValueError``: a plane that runs out or over, a
mask or raw planes cut short, an entry neither PNG nor JPEG 2000, an
it32 block whose first four bytes are not 0.  A JPEG 2000 entry of a mode
other than L, LA, RGB, RGBA or P raises too.
"""

import struct

import numpy as np

from ifseg_torch.data import jpeg2000, png
from ifseg_torch.data.png import check_pixels

SIGNATURE = b"icns"
_PNG, _RLE, _RLE_T, _MASK = "png", "rle", "rle32t", "mask"
# PIL's IcnsFile.SIZES: (width, height, scale) -> the block types and readers, in order
SIZES = {
    (512, 512, 2): [(b"ic10", _PNG)],
    (512, 512, 1): [(b"ic09", _PNG)],
    (256, 256, 2): [(b"ic14", _PNG)],
    (256, 256, 1): [(b"ic08", _PNG)],
    (128, 128, 2): [(b"ic13", _PNG)],
    (128, 128, 1): [(b"ic07", _PNG), (b"it32", _RLE_T), (b"t8mk", _MASK)],
    (64, 64, 1): [(b"icp6", _PNG)],
    (32, 32, 2): [(b"ic12", _PNG)],
    (48, 48, 1): [(b"ih32", _RLE), (b"h8mk", _MASK)],
    (32, 32, 1): [(b"icp5", _PNG), (b"il32", _RLE), (b"l8mk", _MASK)],
    (16, 16, 2): [(b"ic11", _PNG)],
    (16, 16, 1): [(b"icp4", _PNG), (b"is32", _RLE), (b"s8mk", _MASK)],
}
_J2K = (b"\xff\x4f\xff\x51", b"\x0d\x0a\x87\x0a")


def icns_blocks(data: bytes):
    """{type: (start, length)} as PIL's ``IcnsFile`` indexes them; ValueError
    where its open fails."""
    if len(data) < 8 or data[:4] != SIGNATURE:
        raise ValueError("not an ICNS file")
    filesize = struct.unpack_from(">I", data, 4)[0]
    blocks, i = {}, 8
    while i < filesize:
        if len(data) < i + 8:
            raise ValueError("truncated ICNS: a block header is cut off")
        kind, size = struct.unpack_from(">4sI", data, i)
        if size <= 0:
            raise ValueError("invalid ICNS block header")
        blocks[kind] = (i + 8, size - 8)
        i += size
    return blocks


def _rle_planes(data: bytes, start: int, count: int) -> np.ndarray:
    """(3, count) uint8: ``read_32``'s three run-length planes from ``start``."""
    planes, pos = [], start
    for band in range(3):
        parts, left = [], count
        while left > 0:
            if pos >= len(data):
                break
            byte = data[pos]
            pos += 1
            if byte & 0x80:
                run = byte - 125
                parts.append(data[pos:pos + 1] * run)
                pos += 1
            else:
                run = byte + 1
                parts.append(data[pos:pos + run])
                pos += run
            left -= run
        if left != 0:
            raise ValueError(f"ICNS plane {band} runs {'out' if left > 0 else 'over'}")
        plane = b"".join(parts)
        if len(plane) < count:
            raise ValueError("ICNS plane cut short")
        planes.append(np.frombuffer(plane, np.uint8, count=count))
    return np.stack(planes)


def _rgba(pixels: np.ndarray, mode: str, palette) -> np.ndarray:
    """PIL's ``convert("RGBA")`` of a JPEG 2000 entry's pixels."""
    if mode == "RGBA":
        return pixels
    h, w = pixels.shape[:2]
    out = np.full((h, w, 4), 255, np.uint8)
    if mode == "P" and palette is not None:
        table = np.zeros((256, 4), np.uint8)
        table[:, 3] = 255
        entries = np.asarray(palette, np.uint8)[:256]
        table[:len(entries), :entries.shape[1]] = entries
        return table[pixels]
    if mode == "L":
        out[:, :, :3] = pixels[:, :, None]
    elif mode == "LA":
        out[:, :, :3] = pixels[:, :, :1]
        out[:, :, 3] = pixels[:, :, 1]
    elif mode == "RGB":
        out[:, :, :3] = pixels
    else:
        raise ValueError(f"ICNS JPEG 2000 entry of mode {mode} is not supported (L, LA, RGB, "
                         f"RGBA and P only)")
    return out


def _entry(data: bytes, start: int, length: int):
    sig = data[start:start + 12]
    if sig.startswith(png.SIGNATURE):
        return png.decode_png_image(data[start:])
    if sig.startswith(_J2K) or sig == jpeg2000.JP2_SIGNATURE:
        pixels, mode, palette = jpeg2000.decode_jpeg2000_image(data[start:start + length])
        return _rgba(pixels, mode, palette), "RGBA", None
    raise ValueError("ICNS entry neither PNG nor JPEG 2000 (PIL reads no other)")


def _icon(data: bytes):
    """(pixels, PIL's mode, palette or None, the fourth byte of an "RGB"
    image's four-byte pixels in PIL's memory) of an ICNS file."""
    blocks = icns_blocks(data)
    sizes = [size for size, kinds in SIZES.items() if any(k in blocks for k, _ in kinds)]
    if not sizes:
        raise ValueError("ICNS file without a 32-bit icon")
    best = max(sizes)
    width, height = best[0] * best[2], best[1] * best[2]
    count = width * height
    channels = {}
    for kind, reader in SIZES[best]:
        if kind not in blocks:
            continue
        start, length = blocks[kind]
        if reader == _PNG:
            channels["RGBA"] = _entry(data, start, length)
        elif reader == _MASK:
            mask = data[start:start + count]
            if len(mask) < count:
                raise ValueError("ICNS mask cut short")
            channels["A"] = np.frombuffer(mask, np.uint8).reshape(height, width)
        else:
            if reader == _RLE_T:
                if data[start:start + 4] != b"\0\0\0\0":
                    raise ValueError("ICNS it32 block without its four zero bytes")
                start, length = start + 4, length - 4
            if length == 3 * count:
                raw = data[start:start + length]
                if len(raw) < length:
                    raise ValueError("ICNS raw planes cut short")
                rgb, pad = np.frombuffer(raw, np.uint8).reshape(height, width, 3), 255
            else:
                rgb = _rle_planes(data, start, count).reshape(3, height, width).transpose(1, 2, 0)
                pad = 0
            channels["RGB"] = rgb, pad
    if "RGBA" in channels:
        pixels, mode, palette = channels["RGBA"]
        h, w = pixels.shape[:2]
        if not any((s[0] * s[2]) // w == (s[1] * s[2]) / h for s in sizes):
            raise ValueError(f"ICNS entry of {w} x {h} is none of the file's sizes")
        check_pixels(w, h, "ICNS")
        return np.ascontiguousarray(pixels), mode, palette, 255  # PNG's unpackers: X 255
    if "RGB" not in channels:
        raise ValueError("ICNS mask without its colour planes")
    rgb, pad = channels["RGB"]
    if "A" in channels:
        return np.dstack([rgb, channels["A"]]), "RGBA", None, None
    return np.ascontiguousarray(rgb), "RGB", None, pad


def decode_icns_image(data: bytes):
    """(pixels, PIL's mode, palette or None) of an ICNS file as
    ``np.asarray(PIL.Image.open(...))`` gives them: PIL packs the loaded
    image in the mode ``_open`` gave it, "RGBA", so an "RGB" image comes as
    its four-byte pixels' memory read as three-byte ones, and any other mode
    but "RGBA" raises, as there (see the module docstring)."""
    pixels, mode, palette, pad = _icon(bytes(data))
    if mode == "RGB":
        h, w = pixels.shape[:2]
        memory = np.dstack([pixels, np.full((h, w), pad, np.uint8)])
        return memory.reshape(-1)[:3 * h * w].reshape(h, w, 3), mode, palette
    if mode != "RGBA":
        raise ValueError(f"ICNS image of mode {mode}: PIL's np.asarray finds no packer from "
                         f"{mode} to RGBA and raises")
    return pixels, mode, palette


def load_icns_image(data: bytes):
    """(pixels, PIL's mode, palette or None) of the image PIL's ``load``
    holds, the true pixels of any mode."""
    return _icon(bytes(data))[:3]


def decode_icns_rgb(data: bytes) -> np.ndarray:
    """(h, w, 3) uint8: PIL's ``convert("RGB")`` of an ICNS file (loaded
    first, so the true colours of any mode)."""
    pixels, mode, palette = load_icns_image(data)
    return png.to_rgb(pixels, palette, mode)
