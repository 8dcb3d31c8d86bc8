"""``ifseg_torch.data.image`` (PNG or JPEG by signature) and ``encode_png``'s
modes against PIL, exactly:

  - ``decode_image`` gives ``np.asarray(Image.open(...))``, PIL's mode and, for
    a palette file, PIL's palette (with the tRNS alpha), for PNG files in
    every mode PIL writes and for gray and RGB JPEG files;
  - ``decode_image_rgb`` gives ``np.asarray(Image.open(...).convert("RGB"))``
    for the same files, 16-bit and interlaced PNG files included;
  - GIF, BMP, TIFF and WebP files decode as PIL decodes them, and a file of
    no image format raises ``ValueError`` naming the formats read;
  - ``encode_png`` writes each mode ("1", "L", "P" with PLTE and tRNS, "I;16",
    "LA", "RGB", "RGBA") so that PIL reads back the same mode, pixels and
    palette.
"""

import io

import numpy as np
import pytest
from PIL import Image, features

from ifseg_torch.data.image import decode_image, decode_image_rgb
from ifseg_torch.data.png import decode_png_image, encode_png

from test_torch_png import _png_by_hand
import torch_port_utils  # noqa: F401,E402  (pins torch's threads under xdist)


def _save(img: Image.Image, fmt: str, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, fmt, **kw)
    return buf.getvalue()


def _images(seed: int = 0):
    """(name, PIL image) in every mode a PNG keeps, at an odd size."""
    rng = np.random.default_rng(seed)
    h, w = 13, 22
    rgba = rng.integers(0, 256, size=(h, w, 4), dtype=np.uint8)
    pal = Image.frombytes("P", (w, h), rng.integers(0, 40, size=(h, w), dtype=np.uint8).tobytes())
    pal.putpalette(rng.integers(0, 256, size=120).tolist())
    pal_alpha = pal.copy()
    pal_alpha.info["transparency"] = bytes(rng.integers(0, 256, size=17, dtype=np.uint8))
    return [("1", Image.fromarray(rgba[:, :, 0] > 127)), ("L", Image.fromarray(rgba[:, :, 0])),
            ("P", pal), ("P+tRNS", pal_alpha),
            ("I;16", Image.fromarray(rng.integers(0, 1 << 16, size=(h, w)).astype(np.uint16))),
            ("LA", Image.fromarray(rgba[:, :, :2], "LA")), ("RGB", Image.fromarray(rgba[:, :, :3])),
            ("RGBA", Image.fromarray(rgba))]


def _pil_palette(img: Image.Image):
    """PIL's palette of a "P" image as (n, 3), or (n, 4) with its tRNS alpha."""
    rgb = np.frombuffer(img.palette.tobytes(), np.uint8).reshape(-1, 3)
    trns = img.info.get("transparency")
    if trns is None:
        return rgb
    alpha = np.full(len(rgb), 255, np.uint8)
    alpha[: len(trns)] = np.frombuffer(trns, np.uint8)
    return np.concatenate([rgb, alpha[:, None]], axis=1)


@pytest.mark.parametrize("name,img", _images(), ids=[n for n, _ in _images()])
def test_png_modes(name, img):
    data = _save(img, "PNG")
    pil = Image.open(io.BytesIO(data))
    pixels, mode, palette = decode_image(data)
    want = np.asarray(pil)
    assert mode == pil.mode and pixels.dtype == want.dtype
    np.testing.assert_array_equal(pixels, want)
    if mode == "P":
        np.testing.assert_array_equal(palette, _pil_palette(pil))
    else:
        assert palette is None
    np.testing.assert_array_equal(decode_image_rgb(data), np.asarray(pil.convert("RGB")))


@pytest.mark.parametrize("name,img", _images(1), ids=[n for n, _ in _images(1)])
def test_encode_png_keeps_each_mode(name, img):
    pixels, mode, palette = decode_png_image(_save(img, "PNG"))
    back = Image.open(io.BytesIO(encode_png(pixels, mode, palette)))
    assert back.mode == img.mode
    np.testing.assert_array_equal(np.asarray(back), np.asarray(img))
    if mode == "P":
        np.testing.assert_array_equal(_pil_palette(back)[: len(palette)], palette)
    # the mode is also read off the array where no palette asks for "P"
    if mode not in ("P", "LA"):
        assert Image.open(io.BytesIO(encode_png(pixels))).mode == img.mode


@pytest.mark.parametrize("mode", ["L", "RGB"])
@pytest.mark.parametrize("subsampling", [0, 2])
def test_jpeg_files(mode, subsampling):
    rng = np.random.default_rng(len(mode))
    arr = rng.integers(0, 256, size=(19, 31, 3), dtype=np.uint8)
    img = Image.fromarray(arr[:, :, 0] if mode == "L" else arr)
    data = _save(img, "JPEG", subsampling=subsampling)
    pil = Image.open(io.BytesIO(data))
    pixels, got_mode, palette = decode_image(data)
    assert got_mode == pil.mode == mode and palette is None
    np.testing.assert_array_equal(pixels, np.asarray(pil))
    np.testing.assert_array_equal(decode_image_rgb(data), np.asarray(pil.convert("RGB")))


@pytest.mark.parametrize("colour,depth,interlace", [(0, 16, 0), (2, 16, 1), (4, 16, 0),
                                                    (6, 16, 1), (3, 4, 1), (0, 1, 1)])
def test_rgb_of_16_bit_and_interlaced_pngs(colour, depth, interlace):
    from test_torch_png import CHANNELS, _palette_chunk

    rng = np.random.default_rng(colour + depth)
    samples = rng.integers(0, 1 << depth, size=(11, 14, CHANNELS[colour]))
    extra = _palette_chunk(1 << depth, 1) if colour == 3 else b""
    data = _png_by_hand(samples, colour, depth, interlace, extra=extra)
    want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    np.testing.assert_array_equal(decode_image_rgb(data), want)


OTHER_FORMATS = (["GIF", "BMP", "TIFF"] + (["WEBP"] if features.check("webp") else [])
                 + (["JPEG2000"] if features.check("jpg_2000") else []) + ["ICO", "PPM"])


@pytest.mark.parametrize("fmt", OTHER_FORMATS)
def test_other_formats_raise_naming_them(fmt):
    """GIF, BMP, TIFF, WebP, JPEG 2000, ICO and Netpbm files decode as PIL
    decodes them (mode, pixels and RGB; every variant in
    ``tests/test_torch_image_files.py``, ``tests/test_torch_webp.py``,
    ``tests/test_torch_jpeg2000.py``, ``tests/test_torch_ico.py`` and
    ``tests/test_torch_netpbm.py``); a file of no image format raises naming
    the formats read."""
    data = _save(Image.fromarray(np.arange(48, dtype=np.uint8).reshape(4, 4, 3)), fmt,
                 **({"sizes": [(4, 4)]} if fmt == "ICO" else {}))
    pil = Image.open(io.BytesIO(data))
    pixels, mode, _ = decode_image(data)
    assert mode == pil.mode
    np.testing.assert_array_equal(pixels, np.asarray(pil))
    np.testing.assert_array_equal(decode_image_rgb(data), np.asarray(pil.convert("RGB")))
    with pytest.raises(ValueError, match="not a PNG, JPEG, GIF, BMP, TIFF, WebP, JPEG 2000, ICO, "
                                         "CUR, Netpbm or PSD file"):
        decode_image(b"plain text, no image")
