"""Image files by their signature, decoded as PIL 12.1 decodes them: PNG
(``data/png.py``), JPEG (``data/jpeg.py``), GIF (``data/gif.py``), BMP
(``data/bmp.py``), TIFF (``data/tiff.py``), WebP (``data/webp.py``) and
JPEG 2000, JP2 files and raw codestreams (``data/jpeg2000.py``).

``decode_image(data)`` returns ``(pixels, mode, palette)``: the pixels as
``np.asarray(PIL.Image.open(BytesIO(data)))`` gives them, PIL's mode name
("1", "L", "P", "I;16", "I;16B", "LA", "PA", "RGB", "RGBA" or "CMYK") and,
for a palette image, its palette ((n, 3) uint8 RGB, or (n, 4) with the
alpha of a PNG's tRNS chunk or a GIF's transparency index).
``decode_image_rgb(data)`` returns
``np.asarray(PIL.Image.open(BytesIO(data)).convert("RGB"))``.  ICO, PSD,
JBIG2 and BigTIFF files, and anything else, raise ``ValueError`` naming the
format.  ``image_digest`` is the SHA-256 that
``tests/torch_image_files/digests.json`` holds of PIL's arrays.
"""

import hashlib

import numpy as np

from ifseg_torch.data import bmp, gif, jpeg, jpeg2000, png, tiff, webp

# the leading bytes of the formats PIL reads that the port does not
_OTHER_FORMATS = ((b"\x00\x00\x01\x00", "ICO"), (b"8BPS", "PSD"), (b"\x97JB2", "JBIG2"),
                  (b"II+\x00", "BigTIFF"), (b"MM\x00+", "BigTIFF"))
_READ = ("PNG", "JPEG", "GIF", "BMP", "TIFF", "WebP", "JPEG 2000")


def image_format(data: bytes) -> str:
    """"PNG", "JPEG", "GIF", "BMP", "TIFF", "WebP" or "JPEG 2000" from the
    file's signature; ValueError for anything else."""
    if data[:8] == png.SIGNATURE:
        return "PNG"
    if data[:3] == jpeg.SIGNATURE:
        return "JPEG"
    if data[:6] in gif.SIGNATURES:
        return "GIF"
    if data[:2] == bmp.SIGNATURE:
        return "BMP"
    if data[:4] in tiff.SIGNATURES:
        return "TIFF"
    if webp.is_webp(data):
        return "WebP"
    if jpeg2000.is_jpeg2000(data):
        return "JPEG 2000"
    name = next((n for sig, n in _OTHER_FORMATS if data.startswith(sig)), None)
    if name:
        raise ValueError(f"{name} files are not supported ({', '.join(_READ[:-1])} and "
                         f"{_READ[-1]} only)")
    raise ValueError(f"not a {', '.join(_READ[:-1])} or {_READ[-1]} file (it starts with "
                     f"{bytes(data[:8])!r})")


def decode_image(data: bytes):
    """(pixels, PIL's mode, palette or None) of an image file."""
    fmt = image_format(data)
    if fmt == "PNG":
        return png.decode_png_image(data)
    if fmt == "GIF":
        return gif.decode_gif_image(data)
    if fmt == "BMP":
        return bmp.decode_bmp_image(data)
    if fmt == "TIFF":
        return tiff.decode_tiff_image(data)
    if fmt == "WebP":
        return webp.decode_webp_image(data)
    if fmt == "JPEG 2000":
        return jpeg2000.decode_jpeg2000_image(data)
    pixels = jpeg.decode_jpeg(data)
    return pixels, {1: "L", 3: "RGB", 4: "CMYK"}[pixels.shape[2] if pixels.ndim == 3 else 1], None


def decode_image_rgb(data: bytes) -> np.ndarray:
    """(h, w, 3) uint8 RGB of an image file, as PIL's
    ``Image.open(...).convert("RGB")`` gives it."""
    fmt = image_format(data)
    if fmt == "PNG":
        return png.decode_png_rgb(data)
    if fmt == "GIF":
        return gif.decode_gif_rgb(data)
    if fmt == "WebP":
        return webp.decode_webp_rgb(data)
    if fmt == "JPEG 2000":
        return jpeg2000.decode_jpeg2000_rgb(data)
    pixels, mode, palette = decode_image(data)
    return png.to_rgb(pixels, palette, mode)


def load():
    """Build (if need be) and load every host codec now, not at its first
    file: the parent of a worker pool calls it so that the workers only load."""
    for codec in (png, jpeg, gif, bmp, tiff, webp, jpeg2000):
        codec.load()


def image_digest(arr: np.ndarray) -> str:
    """SHA-256 of an image array's bytes; a bool (mode "1") array as 0 and 1
    (PIL's array of such an image holds 0 and 255 in its bool bytes)."""
    arr = np.ascontiguousarray(arr != 0 if arr.dtype == bool else arr)
    return hashlib.sha256(arr.tobytes()).hexdigest()
