"""WebP decoding equal to PIL's, with no image library.

PIL 12.1 opens every WebP file through libwebp's ``WebPAnimDecoder``:
``decode_webp_image(data)`` returns ``(pixels, mode, None)`` as
``np.asarray(PIL.Image.open(BytesIO(data)))`` and its mode give them, and
``decode_webp_rgb(data)`` the ``convert("RGB")`` of it.

  - The mode is "RGBA" where libwebp's ``WebPGetFeatures`` of the whole
    file says it has alpha, and "RGB" otherwise, whatever the pixels' alpha:
    an animation's ``VP8X`` alpha flag; a still ``VP8L`` image's alpha hint
    (with or without ``VP8X``); a still lossy image's ``VP8X`` flag or an
    ``ALPH`` chunk before its image (which the decoder then drops when the
    flag is not set).
  - The pixels are the first frame's, decoded into a canvas of the ``VP8X``
    size (a simple file's: the image's) that starts all zero (RGBA 0, 0, 0,
    0), at its offset (2 X, 2 Y) for an animation frame; the background
    colour of ``ANIM`` is not used, as libwebp leaves it to the caller.

The container is read here as ``WebPGetFeatures`` and libwebp's demuxer
read it (``WebPAnimDecoder`` takes a file only if both do), and refused
(``ValueError`` naming WebP) wherever either refuses: a file shorter than its
RIFF size says, or with fewer than 8 bytes left that make no chunk (a cut
file decodes to nothing, unlike a cut PNG or JPEG); chunks too large for
what is left; a first chunk other than ``VP8 ``, ``VP8L`` and ``VP8X``; a
``VP8X`` chunk of other than 10 bytes, with a flag libwebp does not know, or whose
canvas does not hold every frame (a still image must fill it exactly); an
``ALPH`` chunk before a ``VP8L`` one or after the image; image chunks whose
headers libwebp's ``WebPGetFeatures`` rejects.  Trailing bytes after the
RIFF size are ignored; ``ICCP``, ``EXIF``, ``XMP `` and unknown chunks are
skipped; a still image's ``ALPH`` is dropped when ``VP8X`` has no alpha flag.

The image data is decoded by ``csrc/webp_vp8_decode.cpp`` (lossy ``VP8 ``
key frames) and ``csrc/webp_vp8l_decode.cpp`` (lossless ``VP8L`` and the
alpha planes of ``ALPH`` chunks, raw or lossless, with their unfilters), each
given its chunk's payload and pad byte as libwebp is.  Both sources are
built with the host C++ compiler at the first decode (``ops/build.py``; a
failed build raises).
"""

import ctypes
import struct
from functools import lru_cache

import numpy as np

from ifseg_torch.ops import build

SOURCES = ("webp_vp8_decode", "webp_vp8l_decode")
MAX_CHUNK_PAYLOAD = 0xFFFFFFFF - 8 - 1
MAX_IMAGE_AREA = 1 << 32
ALPHA_FLAG, ANIMATION_FLAG, ALL_VALID_FLAGS = 0x10, 0x02, 0x3E
_ERRORS = {-1: "a bitstream error", -2: "the data ends early", -3: "an unsupported frame"}


def is_webp(data: bytes) -> bool:
    return data[:4] == b"RIFF" and data[8:12] == b"WEBP"


@lru_cache(maxsize=None)
def _codecs():
    vp8, vp8l = (build.load(s) for s in SOURCES)
    i64, ptr = ctypes.c_int64, ctypes.c_void_p
    for fn, args in ((vp8.webp_vp8_info, [ctypes.c_char_p, i64, i64]),
                     (vp8.webp_vp8_decode, [ctypes.c_char_p, i64, i64, i64, ptr, i64]),
                     (vp8l.webp_vp8l_decode, [ctypes.c_char_p, i64, i64, i64, ptr]),
                     (vp8l.webp_alpha_decode, [ctypes.c_char_p, i64, i64, i64, ptr])):
        fn.argtypes, fn.restype = args, i64
    return vp8, vp8l


def load():
    """Build (if need be) and load both decoders now, not at the first decode."""
    _codecs()


class _Refused(ValueError):
    def __init__(self, why: str):
        super().__init__(f"broken WebP file: {why}")


def _vp8l_info(payload: bytes):
    """VP8LGetInfo: (width, height, alpha hint) of a VP8L payload."""
    if len(payload) < 5 or payload[0] != 0x2F or payload[4] >> 5:
        raise _Refused("a VP8L header libwebp refuses")
    bits = int.from_bytes(payload[1:5], "little")
    return (bits & 0x3FFF) + 1, ((bits >> 14) & 0x3FFF) + 1, bool((bits >> 28) & 1)


def _features(data: bytes, start: int, size: int):
    """WebPGetFeatures of the image chunk at ``start`` (header + ``size``
    bytes of payload available): (width, height)."""
    tag = data[start:start + 4]
    declared = struct.unpack("<I", data[start + 4:start + 8])[0]
    payload = data[start + 8:start + 8 + size]
    if tag == b"VP8L":
        return _vp8l_info(payload)[:2]
    info = _codecs()[0].webp_vp8_info(payload, len(payload), declared)
    if info < 0:
        raise _Refused("a VP8 frame header libwebp refuses")
    return info >> 16, info & 0xFFFF


def _has_alpha(data: bytes) -> bool:
    """WebPGetFeatures of the whole file: its ``has_alpha``.  Raises where
    that fails, and where the data runs out (there it may pass, but the
    demuxer refuses every such file)."""
    n, pos, riff_size = len(data), 0, 0
    if n >= 12 and data[:4] == b"RIFF":
        size = struct.unpack("<I", data[4:8])[0]
        if size < 12 or size > MAX_CHUNK_PAYLOAD:
            raise _Refused(f"RIFF size {size}")
        riff_size, pos = size, 12
    found_vp8x, flags = data[pos:pos + 4] == b"VP8X", 0
    if found_vp8x:
        if struct.unpack("<I", data[pos + 4:pos + 8])[0] != 10 or n - pos < 18:
            raise _Refused("a VP8X chunk of other than 10 bytes")
        flags = struct.unpack("<I", data[pos + 8:pos + 12])[0]
        canvas = (1 + int.from_bytes(data[pos + 12:pos + 15], "little"),
                  1 + int.from_bytes(data[pos + 15:pos + 18], "little"))
        if canvas[0] * canvas[1] >= MAX_IMAGE_AREA:
            raise _Refused("canvas too large")
        pos += 18
        if flags & ANIMATION_FLAG:
            return bool(flags & ALPHA_FLAG)
    alpha_chunk = False
    if riff_size and found_vp8x:  # ParseOptionalChunks, up to the image chunk
        total = 4 + 8 + 10
        while n - pos >= 8 and data[pos:pos + 4] not in (b"VP8 ", b"VP8L"):
            disk = (8 + struct.unpack("<I", data[pos + 4:pos + 8])[0] + 1) & ~1
            total += disk
            if total > riff_size or n - pos < disk:
                raise _Refused("chunks past the RIFF size")
            alpha_chunk |= data[pos:pos + 4] == b"ALPH"
            pos += disk
    tag = data[pos:pos + 4]
    if n - pos < 8 or tag not in (b"VP8 ", b"VP8L"):
        raise _Refused(f"chunk {tag!r} where the image belongs")
    size = struct.unpack("<I", data[pos + 4:pos + 8])[0]
    if riff_size >= 12 and size + 12 > riff_size:
        raise _Refused("image chunk larger than the RIFF size")
    if tag == b"VP8L":
        w, h, has_alpha = _vp8l_info(data[pos + 8:])
    else:
        info = _codecs()[0].webp_vp8_info(data[pos + 8:], n - pos - 8, size)
        if info < 0:
            raise _Refused("a VP8 frame header libwebp refuses")
        w, h, has_alpha = info >> 16, info & 0xFFFF, bool(flags & ALPHA_FLAG)
    if found_vp8x and (w, h) != canvas:
        raise _Refused("the image does not fill the canvas")
    return has_alpha or alpha_chunk


class _Frame:
    def __init__(self, x: int = 0, y: int = 0):
        self.x, self.y = x, y
        self.width = self.height = 0
        self.alpha = None  # offset of the ALPH chunk
        self.image = None  # (offset, size) of the VP8 / VP8L chunk


class _Demux:
    """libwebp's WebPDemux on a whole file (no partial data)."""

    def __init__(self, data: bytes):
        if len(data) < 20:
            raise _Refused("shorter than its headers")
        riff_size = struct.unpack("<I", data[4:8])[0]
        if riff_size < 8 or riff_size > MAX_CHUNK_PAYLOAD:
            raise _Refused(f"RIFF size {riff_size}")
        self.riff_end = riff_size + 8
        if len(data) < self.riff_end:
            raise _Refused(f"cut: {len(data)} of {self.riff_end} bytes")
        self.data = data[:self.riff_end]
        self.pos = 12
        self.flags = 0
        self.canvas = None  # a simple file's is its image's
        self.frames = []
        first = self.data[12:16]
        if first in (b"VP8 ", b"VP8L"):
            self._single()
        elif first == b"VP8X":
            self._vp8x()
            self._valid_extended()
        else:
            raise _Refused(f"first chunk {first!r}")

    def _left(self) -> int:
        return self.riff_end - self.pos

    def _u32(self) -> int:
        v = struct.unpack("<I", self.data[self.pos:self.pos + 4])[0]
        self.pos += 4
        return v

    def _u24(self) -> int:
        v = int.from_bytes(self.data[self.pos:self.pos + 3], "little")
        self.pos += 3
        return v

    def _store_frame(self, frame: _Frame, min_size: int) -> None:
        """StoreFrame: the ALPH and image chunks of one frame."""
        if self._left() < 8 or self._left() < min_size:
            raise _Refused("a frame is cut off")
        alpha_chunks = image_chunks = 0
        while True:
            start = self.pos
            fourcc = self.data[start:start + 4]
            self.pos += 4
            size = self._u32()
            if size > MAX_CHUNK_PAYLOAD:
                raise _Refused("a chunk size")
            padded = size + (size & 1)
            available = min(padded, self._left())
            if padded > self._left():
                raise _Refused(f"chunk {fourcc!r} runs past the RIFF size")
            if fourcc == b"VP8L" and alpha_chunks:
                raise _Refused("ALPH before VP8L")
            if fourcc == b"ALPH" and alpha_chunks == 0:
                alpha_chunks = 1
                frame.alpha = start
                self.pos += available
            elif fourcc in (b"VP8 ", b"VP8L") and image_chunks == 0:
                frame.width, frame.height = _features(self.data, start, available)
                image_chunks = 1
                frame.image = (start, 8 + available)
                self.pos += available
            else:
                self.pos = start
                return
            if self.pos == self.riff_end:
                return
            if self._left() < 8:
                raise _Refused("bytes after the last chunk make no chunk")

    def _add(self, frame: _Frame) -> None:
        if self.frames and self.frames[-1].image is None:
            raise _Refused("a frame after an incomplete one")
        self.frames.append(frame)

    def _single(self) -> None:
        """ParseSingleImage (a simple file's first chunk is its image)."""
        if self.frames:
            raise _Refused("a second image")
        frame = _Frame()
        self._store_frame(frame, 0)
        if not self.flags & ALPHA_FLAG:
            frame.alpha = None
        if self.canvas is None:
            self.canvas = (frame.width, frame.height)
        self._add(frame)

    def _vp8x(self) -> None:
        """ParseVP8X and ParseVP8XChunks."""
        self.pos += 4
        size = self._u32()
        if size > MAX_CHUNK_PAYLOAD or size < 10:
            raise _Refused(f"VP8X size {size}")
        size += size & 1
        if size > self._left():
            raise _Refused("VP8X runs past the RIFF size")
        self.flags = self.data[self.pos]
        self.pos += 4
        self.canvas = (1 + self._u24(), 1 + self._u24())  # before _single reads it
        if self.canvas[0] * self.canvas[1] >= MAX_IMAGE_AREA:
            raise _Refused("canvas too large")
        self.pos += size - 10
        if self._left() < 8:
            raise _Refused("no chunk after VP8X")
        is_animation = bool(self.flags & ANIMATION_FLAG)
        anim_chunks = 0
        while True:
            start = self.pos
            fourcc = self.data[start:start + 4]
            self.pos += 4
            size = self._u32()
            if size > MAX_CHUNK_PAYLOAD:
                raise _Refused("a chunk size")
            padded = size + (size & 1)
            if padded > self._left():
                raise _Refused(f"chunk {fourcc!r} runs past the RIFF size")
            if fourcc == b"VP8X":
                raise _Refused("a second VP8X")
            if fourcc in (b"ALPH", b"VP8 ", b"VP8L"):
                if anim_chunks or is_animation:
                    raise _Refused("an image outside ANMF in an animation")
                self.pos = start
                self._single()
            elif fourcc == b"ANIM" and anim_chunks == 0:
                if padded < 6:
                    raise _Refused("ANIM too short")
                anim_chunks = 1
                self.pos += padded
            elif fourcc == b"ANMF":
                if not anim_chunks:
                    raise _Refused("ANMF before ANIM")
                self._anmf(padded, is_animation)
            else:  # ICCP, EXIF, XMP, a second ANIM, unknown
                self.pos += padded
            if self.pos == self.riff_end:
                return
            if self._left() < 8:
                raise _Refused("bytes after the last chunk make no chunk")

    def _anmf(self, chunk_size: int, is_animation: bool) -> None:
        """ParseAnimationFrame."""
        if chunk_size < 16:
            raise _Refused("ANMF too short")
        frame = _Frame(2 * self._u24(), 2 * self._u24())
        if (1 + self._u24()) * (1 + self._u24()) >= MAX_IMAGE_AREA:
            raise _Refused("frame too large")
        self.pos += 4  # duration, flags
        start = self.pos
        self._store_frame(frame, chunk_size - 16)
        if self.pos - start > chunk_size - 16:
            raise _Refused("ANMF payload overrun")
        if is_animation and (frame.alpha is not None or frame.image is not None):
            self._add(frame)

    def _valid_extended(self) -> None:
        """IsValidExtendedFormat."""
        is_animation = bool(self.flags & ANIMATION_FLAG)
        cw, ch = self.canvas
        if not self.frames or self.flags & ~ALL_VALID_FLAGS:
            raise _Refused("no frame, or unknown VP8X flags")
        for f in self.frames:
            if f.image is None:
                raise _Refused("a frame without image data")
            if f.alpha is not None and f.alpha > f.image[0]:
                raise _Refused("ALPH after the image")
            if not is_animation:
                if f.x or f.y or (f.width, f.height) != (cw, ch):
                    raise _Refused("the image does not fill the canvas")
            elif f.x + f.width > cw or f.y + f.height > ch:
                raise _Refused("a frame outside the canvas")


def _check(code: int, what: str) -> None:
    if code:
        raise _Refused(f"{what}: {_ERRORS.get(code, code)}")


def _decode(data: bytes):
    """(canvas RGBA (h, w, 4) uint8, PIL's mode)."""
    data = bytes(data)
    has_alpha = _has_alpha(data)
    dmux = _Demux(data)
    cw, ch = dmux.canvas
    frame = dmux.frames[0]
    vp8, vp8l = _codecs()
    canvas = np.zeros((ch, cw, 4), np.uint8)
    d = dmux.data
    w, h = frame.width, frame.height
    img_start, img_size = frame.image
    payload = d[img_start + 8:img_start + img_size]  # with its pad byte, as libwebp is given it
    declared = struct.unpack("<I", d[img_start + 4:img_start + 8])[0]
    if declared > len(payload):
        raise _Refused("image chunk cut")
    view = canvas[frame.y:frame.y + h, frame.x:frame.x + w]
    if d[img_start:img_start + 4] == b"VP8L":
        argb = np.empty(w * h, np.uint32)
        _check(vp8l.webp_vp8l_decode(payload, len(payload), w, h, argb.ctypes.data), "VP8L")
        argb = argb.reshape(h, w)
        for i, shift in enumerate((16, 8, 0, 24)):
            view[:, :, i] = (argb >> shift) & 0xFF
    else:
        rgba = np.empty((h, w, 4), np.uint8)
        _check(vp8.webp_vp8_decode(payload, len(payload), w, h, rgba.ctypes.data, w * 4), "VP8")
        if frame.alpha is not None:
            a_start = frame.alpha
            a_size = struct.unpack("<I", d[a_start + 4:a_start + 8])[0]
            alpha = d[a_start + 8:a_start + 8 + a_size]
            plane = np.empty((h, w), np.uint8)
            _check(vp8l.webp_alpha_decode(alpha, len(alpha), w, h, plane.ctypes.data), "ALPH")
            rgba[:, :, 3] = plane
        view[:] = rgba
    return canvas, "RGBA" if has_alpha else "RGB"


def decode_webp_image(data: bytes):
    """(pixels, PIL's mode, None) of the first frame (see the module docstring)."""
    canvas, mode = _decode(data)
    return (canvas if mode == "RGBA" else np.ascontiguousarray(canvas[:, :, :3])), mode, None


def decode_webp_rgb(data: bytes) -> np.ndarray:
    """The first frame as (h, w, 3) uint8 RGB, as PIL's ``convert("RGB")``
    gives it (the alpha dropped)."""
    return np.ascontiguousarray(_decode(data)[0][:, :, :3])
