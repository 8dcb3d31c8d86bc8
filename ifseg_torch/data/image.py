"""Image files by their signature: PNG (``data/png.py``) and JPEG
(``data/jpeg.py``), decoded as PIL decodes them.

``decode_image(data)`` returns ``(pixels, mode, palette)``: the pixels as
``np.asarray(PIL.Image.open(BytesIO(data)))`` gives them, PIL's mode name
("1", "L", "P", "I;16", "LA", "RGB" or "RGBA") and, for a palette PNG, its
palette (see ``png.decode_png_image``).  ``decode_image_rgb(data)`` returns
``np.asarray(PIL.Image.open(BytesIO(data)).convert("RGB"))``.  Any other
format raises ``ValueError`` naming it.
"""

import numpy as np

from ifseg_torch.data import jpeg, png

# the leading bytes of the formats PIL reads that the port does not
_OTHER_FORMATS = ((b"GIF87a", "GIF"), (b"GIF89a", "GIF"), (b"BM", "BMP"), (b"II*\x00", "TIFF"),
                  (b"MM\x00*", "TIFF"), (b"\x00\x00\x01\x00", "ICO"), (b"8BPS", "PSD"),
                  (b"\x97JB2", "JBIG2"), (b"\x00\x00\x00\x0cjP  ", "JPEG 2000"),
                  (b"\xff\x4f\xff\x51", "JPEG 2000"))


def image_format(data: bytes) -> str:
    """"PNG" or "JPEG" from the file's signature; ValueError for anything else."""
    if data[:8] == png.SIGNATURE:
        return "PNG"
    if data[:3] == jpeg.SIGNATURE:
        return "JPEG"
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        name = "WebP"
    else:
        name = next((n for sig, n in _OTHER_FORMATS if data.startswith(sig)), None)
    if name:
        raise ValueError(f"{name} files are not supported (PNG and JPEG only)")
    raise ValueError(f"not a PNG or JPEG file (it starts with {bytes(data[:8])!r})")


def decode_image(data: bytes):
    """(pixels, PIL's mode, palette or None) of a PNG or JPEG file."""
    if image_format(data) == "PNG":
        return png.decode_png_image(data)
    pixels = jpeg.decode_jpeg(data)
    return pixels, ("L" if pixels.ndim == 2 else "RGB"), None


def decode_image_rgb(data: bytes) -> np.ndarray:
    """(h, w, 3) uint8 RGB of a PNG or JPEG file, as PIL's
    ``Image.open(...).convert("RGB")`` gives it."""
    if image_format(data) == "PNG":
        return png.decode_png_rgb(data)
    return png.to_rgb(jpeg.decode_jpeg(data))
