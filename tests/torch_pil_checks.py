"""Checks of the port's image readers against PIL 12.1, shared by the tests
of the formats the port reads through ``ifseg_torch.data.image``: every
tolerance 0, under the JAX package's ``ImageFile.LOAD_TRUNCATED_IMAGES``
(the tests set it).

``same_as_pil(data)`` holds ``decode_image`` to PIL's mode, ``np.asarray``
(dtype and shape too) and palette (``getpalette`` in the palette's own mode,
RGB or RGBA) and ``decode_image_rgb`` to ``convert("RGB")``;
``as_pil_or_raise(data)`` does that where PIL opens the file and otherwise
asks for a ``ValueError``; ``cuts_and_flips`` runs it over every cut of a
file and over seeded byte flips.
"""

import io

import numpy as np
import pytest
from PIL import Image

from ifseg_torch.data.image import decode_image, decode_image_rgb


def pil_view(data: bytes):
    """(pixels, mode, palette or None, RGB, format) as PIL gives them."""
    im = Image.open(io.BytesIO(data))
    pixels = np.asarray(im)
    palette = None
    if im.mode in ("P", "PA") and im.palette is not None:
        width = len(im.palette.mode)
        palette = np.array(im.getpalette(im.palette.mode), np.uint8).reshape(-1, width)
    return pixels, im.mode, palette, np.asarray(im.convert("RGB")), im.format


def same_as_pil(data: bytes, fmt: str = None):
    want, mode, palette, rgb, pil_format = pil_view(data)
    if fmt is not None:
        assert pil_format == fmt
    got, got_mode, got_palette = decode_image(data)
    assert got_mode == mode
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    if palette is not None:
        np.testing.assert_array_equal(got_palette[:len(palette)], palette)
    elif got_palette is not None:
        assert len(got_palette) == 0  # a palette image without one
    got_rgb = decode_image_rgb(data)
    assert got_rgb.dtype == np.uint8
    np.testing.assert_array_equal(got_rgb, rgb)


def as_pil_or_raise(data: bytes) -> str:
    try:
        pil_view(data)
    except Exception:  # what PIL raises under the flag
        with pytest.raises(ValueError):
            decode_image(data)
        return "raised"
    same_as_pil(data)
    return "decoded"


def cuts_and_flips(data: bytes, flips: int = 60, head: int = None, seed: int = 0):
    """(decoded, raised) counts over every cut of ``data`` and ``flips``
    random byte flips (in the first ``head`` bytes where given), each as PIL
    decodes it or raising where PIL raises; flips that make an image of more
    than a million pixels are skipped."""
    seen = [as_pil_or_raise(data[:cut]) for cut in range(len(data) + 1)]
    rng = np.random.default_rng(seed)
    for _ in range(flips):
        flipped = bytearray(data)
        at = int(rng.integers(0, min(len(data), head or len(data))))
        flipped[at] ^= int(rng.integers(1, 256))
        try:
            width, height = Image.open(io.BytesIO(bytes(flipped))).size
            if width * height > 1 << 20:
                continue
        except Exception:
            pass
        seen.append(as_pil_or_raise(bytes(flipped)))
    return seen.count("decoded"), seen.count("raised")
