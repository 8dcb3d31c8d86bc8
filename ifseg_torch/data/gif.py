"""GIF decoding equal to PIL's, with no image library.

``decode_gif_image(data)`` returns ``(pixels, mode, palette)`` of the first
frame as PIL 12.1 gives it: ``np.asarray(PIL.Image.open(BytesIO(data)))``,
an (h, w) uint8 array of palette indices (mode "P") or of gray levels (mode
"L": a frame without a palette, or whose palette is the identity ramp
0, 1, 2, ... that PIL drops), PIL's mode name, and for "P" the frame's
palette (its local one, else the global one) as (2 ** bits, 3) uint8 RGB,
(2 ** bits, 4) with alpha 0 at a transparency index of the graphic control
extension.  The canvas is the logical screen, grown to hold the frame; the
pixels outside the frame are the transparency index, else 0.  An animated
file gives its first frame.  ``decode_gif_rgb(data)`` returns
``np.asarray(PIL.Image.open(BytesIO(data)).convert("RGB"))``: the indices
looked up in the frame's palette (the transparency index keeps its colour,
an index past the palette's end reads black), and, where a local ramp made
the frame "L" while the file has a global palette, in that one, as PIL
converts such a frame.

The file's blocks are walked here as PIL's ``GifImagePlugin`` walks them
(unknown bytes between blocks are skipped; a file cut before the frame's
image data raises, as ``Image.open`` does); the LZW data is decoded by
``csrc/gif_decode.cpp``, which PIL's ``GifDecode.c`` matches, over the
frame's whole sub-blocks from its first one to the end of the file (PIL's
decoder reads them so, past a zero-length one): a cut file keeps the pixels
decoded before its last whole sub-block, as PIL does under the JAX package's
``ImageFile.LOAD_TRUNCATED_IMAGES``.  The source is built with the host C++
compiler at the first decode (``ops/build.py``); a failed build raises.
"""

import ctypes
import struct
from functools import lru_cache

import numpy as np

from ifseg_torch.ops import build

SOURCE = "gif_decode"
SIGNATURES = (b"GIF87a", b"GIF89a")


@lru_cache(maxsize=None)
def _lzw():
    fn = build.load(SOURCE).gif_lzw
    fn.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
                   ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64]
    fn.restype = ctypes.c_int64
    return fn


def load():
    """Build (if need be) and load the LZW decoder now, not at the first decode."""
    _lzw()


class _Reader:
    """PIL's file reads: short at the end of the data, never raising."""

    def __init__(self, data: bytes, pos: int):
        self.data, self.pos = data, pos

    def read(self, n: int) -> bytes:
        out = self.data[self.pos:self.pos + n]
        self.pos += len(out)
        return out

    def block(self):
        """GifImageFile.data: one sub-block, None at a zero length or the end."""
        s = self.read(1)
        return self.read(s[0]) if s and s[0] else None


def _palette_needed(p: bytes) -> bool:
    """GifImageFile._is_palette_needed: anything but the ramp i, i, i."""
    if len(p) % 3:
        raise ValueError("truncated GIF: a palette is cut off")
    return any(not (i // 3 == p[i] == p[i + 1] == p[i + 2]) for i in range(0, len(p), 3))


def _frame(data: bytes):
    """The first frame's header as PIL's ``_open`` reads it: (size, frame
    extent, interlace, frame palette bytes or None, global palette bytes or
    None, transparency, LZW bits, offset of its image data)."""
    if len(data) < 13 or data[:6] not in SIGNATURES:
        raise ValueError("not a GIF file" if data[:6] not in SIGNATURES
                         else "truncated GIF: the screen descriptor is cut off")
    width, height, flags = struct.unpack("<HHB", data[6:11])
    fp = _Reader(data, 13)
    global_palette = None
    if flags & 128:
        p = fp.read(3 << ((flags & 7) + 1))
        if _palette_needed(p):
            global_palette = p
    transparency, palette = None, None
    s = fp.read(1)
    while True:
        if not s:
            s = fp.read(1)
        if not s or s == b";":
            raise ValueError("broken GIF: no image in the first frame")
        if s == b"!":
            label = fp.read(1)
            block = fp.block()
            if label and label[0] == 249 and block is not None:
                if len(block) < 3 or (block[0] & 1 and len(block) < 4):
                    raise ValueError("broken GIF: a graphic control extension is cut short")
                if block[0] & 1:
                    transparency = block[3]
            elif label and label[0] == 254:
                while block:
                    block = fp.block()
                s = b""
                continue
            elif (label and label[0] == 255 and block is not None
                  and block.startswith(b"NETSCAPE2.0")):
                fp.block()
            while fp.block():
                pass
        elif s == b",":
            desc = fp.read(9)
            if len(desc) < 9:
                raise ValueError("truncated GIF: an image descriptor is cut off")
            x0, y0, fw, fh, fflags = struct.unpack("<HHHHB", desc)
            if fflags & 128:
                p = fp.read(3 << ((fflags & 7) + 1))
                palette = p if _palette_needed(p) else False
            bits = fp.read(1)
            if not bits:
                raise ValueError("truncated GIF: the image data is cut off")
            frame_palette = palette if palette is not None else global_palette
            size = (max(width, x0 + fw), max(height, y0 + fh))
            return (size, (x0, y0, fw, fh), bool(fflags & 64), frame_palette or None,
                    global_palette, transparency, bits[0], fp.pos)
        s = b""


def _sub_blocks(data: bytes, pos: int) -> bytes:
    """The joined whole sub-blocks from ``pos`` to the end of the file."""
    parts = []
    while pos < len(data):
        n = data[pos]
        if pos + 1 + n > len(data):
            break
        parts.append(data[pos + 1:pos + 1 + n])
        pos += 1 + n
    return b"".join(parts)


def decode_gif_image(data: bytes):
    """(pixels, PIL's mode, palette or None) of the first frame (see the
    module docstring)."""
    return _decode(data)[:3]


def decode_gif_rgb(data: bytes) -> np.ndarray:
    """The first frame as (h, w, 3) uint8 RGB, as PIL's ``convert("RGB")``
    gives it."""
    pixels, _, _, rgb_palette = _decode(data)
    table = np.zeros((256, 3), np.uint8)
    if rgb_palette is None:
        table[:] = np.arange(256, dtype=np.uint8)[:, None]
    else:
        entries = np.frombuffer(rgb_palette, np.uint8).reshape(-1, 3)[:256]
        table[:len(entries)] = entries
    return np.take(table, pixels, axis=0)


def _decode(data: bytes):
    """(pixels, mode, palette table or None, the palette bytes PIL converts
    to RGB with or None)."""
    data = bytes(data)
    (w, h), (x0, y0, fw, fh), interlace, palette, global_palette, transparency, bits, pos = \
        _frame(data)
    if bits > 12:
        raise ValueError(f"broken GIF: LZW minimum code size {bits} (PIL takes 0 to 12)")
    canvas = np.full((h, w), 0 if transparency is None else transparency, np.uint8)
    if fw and fh:
        lzw = _sub_blocks(data, pos)
        view = canvas[y0:, x0:]
        _lzw()(lzw, len(lzw), bits, view.ctypes.data, w, fw, fh, int(interlace))
    if palette is None:  # PIL's "L" frame keeps the global palette, if any, for convert
        return canvas, "L", None, global_palette
    table = np.frombuffer(palette, np.uint8).reshape(-1, 3)
    if transparency is not None:
        alpha = np.full((len(table), 1), 255, np.uint8)
        if transparency < len(table):
            alpha[transparency] = 0
        table = np.concatenate([table, alpha], axis=1)
    return canvas, "P", table.copy(), palette
