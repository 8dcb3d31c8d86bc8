"""JPEG 2000 decoding equal to PIL's, with no image library.

PIL 12.1 opens a JPEG 2000 file (a JP2 file or a raw codestream) in its
Python plugin and decodes it through OpenJPEG 2.5.4, tile by tile, at
``reduce = 0`` with every quality layer.  ``decode_jpeg2000_image(data)``
returns ``(pixels, mode, palette)`` as ``np.asarray(PIL.Image.open(...))``,
its mode and its palette give them, and ``decode_jpeg2000_rgb(data)`` the
``convert("RGB")`` of it.

  - The mode is the plugin's.  A raw codestream's comes from SIZ: one
    component "L" (or "I;16" above 8 bits), two "LA", three "RGB", four
    "RGBA".  A JP2 file's comes from its ``ihdr`` box (one component "L",
    or "I;16" where the box's depth byte masked with 0x7F is above 8; then
    "LA", "RGB", "RGBA"), a ``colr`` box of enumerated space 12 on 4
    components makes it "CMYK", and a ``pclr`` palette of at most 8-bit
    entries on "L" or "LA" makes it "P" or "PA" with that palette (each new
    colour once, as ``ImagePalette.getcolor`` adds them).
  - The pixels are OpenJPEG's component planes as PIL unpacks them: shifted
    to 8 bits (16 for "I;16") from the component's precision, with
    half of the dropped step added where the precision is higher, and
    offset by half the range where the component is signed, in the unsigned
    arithmetic of PIL's unpackers.  A palette image keeps its indices.
  - A file that is cut or broken decodes as the JAX package's PIL decodes it
    under ``LOAD_TRUNCATED_IMAGES``: the tiles OpenJPEG finished before its
    first error, zeros elsewhere (all zeros where the main header or
    OpenJPEG's JP2 checks already fail, or where PIL has no unpacker for the
    mode, colour space and component count, as for a grey ``colr`` on RGB;
    no ``colr``, an ICC profile or an unknown space read as unspecified).
    What PIL's plugin refuses when it opens the file (a short SIZ or box
    header, more than 4 components, an empty image) raises ``ValueError``.

The codestream is decoded by ``csrc/jpeg2000_decode.cpp``, which also raises
(``ValueError`` naming the feature) on what PIL's encoder cannot write and
the port therefore does not read: code-block style flags, SOP and EPH
markers, RGN, POC, PPM and PPT, HTJ2K, Part 2, subsampled components,
precisions above 16 bits.  JP2's sYCC space is refused here where PIL
would convert it (RGB and RGBA of 3 or 4 components).  ``pclr``, ``cmap``
and ``cdef`` are only checked, as PIL's tile reader applies none.  Built
with the host C++ compiler at the first decode (``ops/build.py``; a failed
build raises).
"""

import ctypes
import struct
from functools import lru_cache

import numpy as np

from ifseg_torch.data import png
from ifseg_torch.ops import build

SOURCE = "jpeg2000_decode"
JP2_SIGNATURE = b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a"
CODESTREAM_SIGNATURE = b"\xff\x4f\xff\x51"
MAX_IMAGE_PIXELS = 2 * (1024 * 1024 * 1024 // 4 // 3)  # PIL's DecompressionBombError

# OpenJPEG's colour spaces by a colr box's enumerated space (none, an ICC
# profile or another number: unspecified, which PIL reads by the component
# count), and the (mode, space, components) PIL unpacks
_UNSPECIFIED, _SRGB, _GRAY, _SYCC, _CMYK = "unspecified", "sRGB", "gray", "sYCC", "CMYK"
_ENUMCS = {16: _SRGB, 17: _GRAY, 18: _SYCC, 24: "eYCC", 12: _CMYK}
_UNPACKERS = {
    ("L", _GRAY, 1), ("P", _SRGB, 1), ("PA", _SRGB, 2), ("I;16", _GRAY, 1), ("LA", _GRAY, 2),
    ("RGB", _GRAY, 1), ("RGB", _GRAY, 2), ("RGB", _SRGB, 3), ("RGB", _SRGB, 4),
    ("RGBA", _GRAY, 1), ("RGBA", _GRAY, 2), ("RGBA", _SRGB, 3), ("RGBA", _GRAY, 4),
    ("RGBA", _SRGB, 4),
    ("CMYK", _CMYK, 4),
}


def is_jpeg2000(data: bytes) -> bool:
    return data[:4] == CODESTREAM_SIGNATURE or data[:12] == JP2_SIGNATURE


@lru_cache(maxsize=None)
def _codec():
    lib = build.load(SOURCE)
    i64, ptr, buf = ctypes.c_int64, ctypes.c_void_p, ctypes.c_char_p
    lib.jpeg2000_info.argtypes = [buf, i64, ptr, buf, i64]
    lib.jpeg2000_decode.argtypes = [buf, i64, ptr, ptr, i64, i64, i64, buf, i64]
    lib.jpeg2000_info.restype = lib.jpeg2000_decode.restype = i64
    return lib


def load():
    """Build (if need be) and load the decoder now, not at the first decode."""
    _codec()


class _Refused(ValueError):
    def __init__(self, why: str):
        super().__init__(f"JPEG 2000 file refused: {why}")


# ------------------------------------------------------------ PIL's plugin

class _Boxes:
    """PIL's ``BoxReader``: a box reader that raises where PIL's does."""

    def __init__(self, data: bytes, start: int = 0, length: int = -1):
        self.data, self.pos = data, start
        self.base, self.length = start, length
        self.remaining = -1

    def _can_read(self, n: int) -> bool:
        if self.length >= 0 and self.pos - self.base + n > self.length:
            return False
        return n <= self.remaining if self.remaining >= 0 else True

    def read(self, n: int) -> bytes:
        if not self._can_read(n):
            raise _Refused("not enough data in a JP2 header box")
        out = self.data[self.pos:self.pos + n]
        if len(out) < n:
            raise _Refused(f"a JP2 box is cut ({len(out)} of {n} bytes)")
        self.pos += n
        if self.remaining > 0:
            self.remaining -= n
        return out

    def fields(self, fmt: str):
        return struct.unpack(fmt, self.read(struct.calcsize(fmt)))

    def sub(self) -> "_Boxes":
        size = self.remaining
        start = self.pos
        self.read(size)
        return _Boxes(self.data, start, size)

    def has_next(self) -> bool:
        if self.length >= 0:
            return self.pos - self.base + self.remaining < self.length
        return True

    def next_type(self) -> bytes:
        if self.remaining > 0:
            self.pos += self.remaining
        self.remaining = -1
        lbox, tbox = self.fields(">I4s")
        hlen = 8
        if lbox == 1:
            lbox, hlen = self.fields(">Q")[0], 16
        if lbox < hlen or not self._can_read(lbox - hlen):
            raise _Refused("invalid JP2 box length")
        self.remaining = lbox - hlen
        return tbox


def _jp2_header(data: bytes):
    """PIL's ``_parse_jp2_header``: (size, mode, palette, the offset after
    the ``jp2h`` box), after the signature."""
    boxes = _Boxes(data, 12)
    header = None
    while boxes.has_next():
        if boxes.next_type() == b"jp2h":
            header = boxes.sub()
            break
    size = mode = nc = None
    palette = None
    while header.has_next():
        tbox = header.next_type()
        if tbox == b"ihdr":
            height, width, nc, bpc = header.fields(">IIHB")
            size = (width, height)
            if nc == 1 and (bpc & 0x7F) > 8:
                mode = "I;16"
            elif nc in (1, 2, 3, 4):
                mode = {1: "L", 2: "LA", 3: "RGB", 4: "RGBA"}[nc]
        elif tbox == b"colr" and nc == 4:
            meth, _, _, enumcs = header.fields(">BBBI")
            if meth == 1 and enumcs == 12:
                mode = "CMYK"
        elif tbox == b"pclr" and mode in ("L", "LA"):
            ne, npc = header.fields(">HB")
            depths = header.fields(">" + "B" * npc)
            if max(depths, default=0) <= 8:
                colors = []
                for _ in range(ne):
                    color = header.fields(">" + "B" * npc)
                    if color not in colors and len(colors) < 256:
                        colors.append(color)
                palette = np.array(colors, np.uint8).reshape(-1, npc)
                mode = "P" if mode == "L" else "PA"
        elif tbox == b"res ":
            res = header.sub()
            while res.has_next():
                if res.next_type() == b"resc":
                    res.fields(">HHHHBB")
                    break
    if size is None or mode is None:
        raise _Refused("malformed JP2 header")
    return size, mode, palette, boxes.pos


def _codestream_header(data: bytes, start: int):
    """PIL's ``_parse_codestream`` after the 4-byte signature: (size, mode)."""
    hdr = data[start:start + 2]
    if len(hdr) < 2:
        raise _Refused("SIZ cut")
    lsiz = struct.unpack(">H", hdr)[0]
    siz = hdr + data[start + 2:start + lsiz]
    if len(siz) < 38:
        raise _Refused("SIZ cut")
    _, _, xsiz, ysiz, xosiz, yosiz, _, _, _, _, csiz = struct.unpack_from(">HHIIIIIIIIH", siz)
    if csiz == 1:
        if len(siz) < 39:
            raise _Refused("SIZ cut")
        mode = "I;16" if (siz[38] & 0x7F) + 1 > 8 else "L"
    elif csiz in (2, 3, 4):
        mode = {2: "LA", 3: "RGB", 4: "RGBA"}[csiz]
    else:
        raise _Refused(f"{csiz} components (PIL reads 1 to 4)")
    return (xsiz - xosiz, ysiz - yosiz), mode, start + lsiz


def _skip_markers(data: bytes, pos: int) -> None:
    """PIL's ``_parse_comment``, for its failures: a marker cut in its bytes."""
    while True:
        marker = data[pos:pos + 2]
        pos += 2
        if not marker:
            return
        if len(marker) < 2:
            raise _Refused("a marker cut after its first byte")
        if marker[1] in (0x90, 0xD9):
            return
        hdr = data[pos:pos + 2]
        pos += 2
        if len(hdr) < 2:
            raise _Refused("a marker segment's length is cut")
        length = struct.unpack(">H", hdr)[0]
        if marker[1] == 0x64:
            return
        pos += length - 2


# --------------------------------------------------------------- OpenJPEG

def _jp2_codestream(data: bytes):
    """(codestream, colour space, ``ihdr`` (width, height)) as OpenJPEG's JP2
    reader (opj_jp2_read_header_procedure) finds them: the signature box, the
    ``ftyp`` box second, the ``jp2h`` box and its ``ihdr``, ``colr``, ``bpcc``,
    ``pclr``, ``cmap`` and ``cdef`` boxes with its checks, then everything
    after the ``jp2c`` box's header; None for the codestream where it fails."""
    pos, state = 12, "signature"
    colour, ihdr = _UNSPECIFIED, None
    while pos + 8 <= len(data):
        lbox, tbox = struct.unpack(">I4s", data[pos:pos + 8])
        hlen = 8
        if lbox == 0:
            lbox = len(data) - pos
        elif lbox == 1:
            if pos + 16 > len(data) or data[pos + 8:pos + 12] != b"\0\0\0\0":
                break
            lbox, hlen = struct.unpack(">I", data[pos + 12:pos + 16])[0], 16
        if tbox == b"jp2c":
            return (data[pos + hlen:] if state == "header" else None), colour, ihdr
        if lbox < hlen:
            return None, colour, ihdr
        body = data[pos + hlen:pos + lbox]
        if tbox == b"ftyp":
            if state != "signature" or len(body) < 8 or (len(body) - 8) % 4:
                return None, colour, ihdr
            state = "file type"
        elif tbox == b"jp2h":
            if state == "signature" or len(body) < lbox - hlen:
                return None, colour, ihdr
            header = _jp2h_boxes(body)
            if header is None:
                return None, colour, ihdr
            colour, ihdr = header
            state = "header"
        elif state == "signature":
            return None, colour, ihdr  # the second box must be ftyp
        pos += lbox
    return None, colour, ihdr


def _jp2h_boxes(body: bytes):
    """OpenJPEG's checks of the boxes of ``jp2h``: (colour space, ihdr size),
    or None where it fails."""
    colour, ihdr, ncomp = _UNSPECIFIED, None, 0
    has_colr = has_pclr = has_cmap = has_cdef = False
    pclr_channels = 0
    pos = 0
    while pos < len(body):
        if len(body) - pos < 8:
            return None
        lbox, tbox = struct.unpack(">I4s", body[pos:pos + 8])
        hlen = 8
        if lbox == 1:
            if len(body) - pos < 16 or body[pos + 8:pos + 12] != b"\0\0\0\0":
                return None
            lbox, hlen = struct.unpack(">I", body[pos + 12:pos + 16])[0], 16
        if lbox == 0 or lbox < hlen or lbox > len(body) - pos:
            return None
        box = body[pos + hlen:pos + lbox]
        if tbox == b"ihdr" and ihdr is None:
            if len(box) != 14:
                return None
            height, width, ncomp = struct.unpack(">IIH", box[:10])
            if not 1 <= ncomp <= 16384:
                return None
            ihdr = (width, height)
        elif tbox == b"colr" and not has_colr:
            if len(box) < 3:
                return None
            if box[0] == 1:
                if len(box) < 7:
                    return None
                colour = _ENUMCS.get(struct.unpack(">I", box[3:7])[0], _UNSPECIFIED)
                has_colr = True
            elif box[0] == 2:
                has_colr = True
        elif tbox == b"bpcc":
            if len(box) != ncomp:
                return None
        elif tbox == b"pclr":
            if has_pclr or len(box) < 3:
                return None
            entries, pclr_channels = struct.unpack(">HB", box[:3])
            if not 1 <= entries <= 1024 or pclr_channels == 0 or len(box) < 3 + pclr_channels:
                return None
            sizes = [min(((b & 0x7F) + 8) >> 3, 4) for b in box[3:3 + pclr_channels]]
            if len(box) < 3 + pclr_channels + entries * sum(sizes):
                return None
            has_pclr = True
        elif tbox == b"cmap":
            if not has_pclr or has_cmap or len(box) < 4 * pclr_channels:
                return None
            has_cmap = True
        elif tbox == b"cdef":
            if has_cdef or len(box) < 2:
                return None
            count = struct.unpack(">H", box[:2])[0]
            if count == 0 or len(box) < 2 + 6 * count:
                return None
            has_cdef = True
        pos += lbox
    if ihdr is None:
        return None
    return colour, ihdr


def _decode_codestream(cs: bytes, width: int, height: int, ncomp: int, ihdr=None):
    """(planes (ncomp, height, width) int32, the (height, width) mask of the
    tiles decoded, [(precision, signed)] or None where the header fails).
    OpenJPEG fails a JP2 file whose (first) ``ihdr`` size is not the codestream's."""
    lib = _codec()
    info = np.zeros(5 + 2 * 4, np.int64)
    err = ctypes.create_string_buffer(256)
    code = lib.jpeg2000_info(cs, len(cs), info.ctypes.data, err, len(err))
    if code == -2:
        raise _Refused(err.value.decode())
    planes = np.zeros((max(ncomp, 1), height, width), np.int32)
    written = np.zeros((height, width), np.uint8)
    if code:
        return planes, written, None
    comps = [(int(info[5 + 2 * c]), int(info[6 + 2 * c])) for c in range(min(int(info[4]), 4))]
    if len(comps) != ncomp or (ihdr and (info[2] - info[0], info[3] - info[1]) != ihdr):
        return planes, written, None
    code = lib.jpeg2000_decode(cs, len(cs), planes.ctypes.data, written.ctypes.data, width,
                               height, ncomp, err, len(err))
    if code == -2:
        raise _Refused(err.value.decode())
    return planes, written, comps


def _unpack(plane: np.ndarray, prec: int, signed: int, bits: int) -> np.ndarray:
    """PIL's ``j2ku_*`` unpack of one component to ``bits`` (8 or 16)."""
    dtype = np.uint8 if bits == 8 else np.uint16
    if prec == bits and not signed:  # the samples are already in range
        return plane.astype(dtype)
    csiz = (prec + 7) >> 3
    csiz = 4 if csiz == 3 else csiz
    word = plane.astype(np.int64) & ((1 << (8 * csiz)) - 1)  # OpenJPEG's bytes, read unsigned
    shift = bits - prec
    offset = (1 << (prec - 1)) if signed else 0
    if shift < 0:
        offset += 1 << (-shift - 1)
        out = (word + offset) >> -shift
    else:
        out = (word + offset) << shift
    return (out & ((1 << bits) - 1)).astype(dtype)


def decode_jpeg2000_image(data: bytes):
    """(pixels, PIL's mode, palette or None) of a JP2 file or a raw codestream."""
    data = bytes(data)
    palette = None
    if data[:4] == CODESTREAM_SIGNATURE:
        size, mode, after = _codestream_header(data, 4)
        _skip_markers(data, after)
        cs, colour, ihdr = data, _UNSPECIFIED, None
    elif data[:12] == JP2_SIGNATURE:
        size, mode, palette, after = _jp2_header(data)
        if data[after:after + 12].endswith(b"jp2c" + CODESTREAM_SIGNATURE):
            hdr = data[after + 12:after + 14]
            if len(hdr) < 2:
                raise _Refused("SIZ cut")
            _skip_markers(data, after + 12 + struct.unpack(">H", hdr)[0])
        cs, colour, ihdr = _jp2_codestream(data)
    else:
        raise ValueError("not a JPEG 2000 file")
    width, height = size
    if width <= 0 or height <= 0:
        raise _Refused(f"an image of {width} x {height}")
    if width * height > MAX_IMAGE_PIXELS:
        raise _Refused(f"an image of {width} x {height} (PIL's decompression bomb limit)")
    channels = {"L": 1, "P": 1, "I;16": 1, "LA": 2, "PA": 2, "RGB": 3, "RGBA": 4, "CMYK": 4}[mode]
    bits = 16 if mode == "I;16" else 8
    out = np.zeros((height, width, channels), np.uint16 if bits == 16 else np.uint8)
    if cs is not None:
        ncomp = _siz_components(cs)
        space = colour
        if space == _UNSPECIFIED:
            space = _GRAY if ncomp in (1, 2) else _SRGB
        if space == _SYCC and mode in ("RGB", "RGBA") and ncomp in (3, 4):
            raise _Refused("the sYCC colour space")
        if ncomp and (mode, space, ncomp) in _UNPACKERS:
            planes, written, comps = _decode_codestream(cs, width, height, ncomp, ihdr)
            if comps is not None:
                _unpack_into(out, mode, planes, comps, bits)
                if not written.all():
                    out[written == 0] = 0
    pixels = out[:, :, 0] if channels == 1 else out
    return np.ascontiguousarray(pixels), mode, palette


def _siz_components(cs: bytes) -> int:
    if len(cs) < 42 or cs[:4] != CODESTREAM_SIGNATURE:
        return 0
    return struct.unpack(">H", cs[40:42])[0]


def _unpack_into(out, mode, planes, comps, bits):
    """PIL's unpacker for (mode, components) into ``out`` (h, w, channels)."""
    n = len(comps)
    if mode in ("L", "P", "I;16"):
        out[:, :, 0] = _unpack(planes[0], *comps[0], bits)
    elif mode in ("LA", "PA"):
        out[:, :, 0] = _unpack(planes[0], *comps[0], 8)
        out[:, :, 1] = _unpack(planes[1], *comps[1], 8)
    elif n <= 2:  # gray into RGB / RGBA
        gray = _unpack(planes[0], *comps[0], 8)
        out[:, :, :3] = gray[:, :, None]
        if mode == "RGBA":
            out[:, :, 3] = _unpack(planes[1], *comps[1], 8) if n == 2 else 255
    else:
        for c in range(3):
            out[:, :, c] = _unpack(planes[c], *comps[c], 8)
        if out.shape[2] == 4:
            out[:, :, 3] = _unpack(planes[3], *comps[3], 8) if n == 4 else 255


def decode_jpeg2000_rgb(data: bytes) -> np.ndarray:
    """(h, w, 3) uint8, as PIL's ``convert("RGB")`` gives it."""
    pixels, mode, palette = decode_jpeg2000_image(data)
    return png.to_rgb(pixels, palette, mode)
