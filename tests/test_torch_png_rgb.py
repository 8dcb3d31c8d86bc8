"""The serving surface's host codecs against PIL, what the JAX package's
``cli/serve.py`` and ``cli/infer.py`` use, bit for bit:

  - ``decode_png_rgb`` against ``np.asarray(Image.open(...).convert("RGB"))``
    for every colour type and bit depth ``decode_png`` takes (files PIL
    writes, and ``chip_smoke.py``'s writer with every row filter), palettes
    shorter than their indices included;
  - ``pil_resize`` against ``Image.resize`` with ``BILINEAR`` and ``NEAREST``,
    gray and RGB, over sizes that shrink and grow each axis;
  - ``encode_png``'s files decoded by PIL (byte equality with PIL's encoder
    is not asked for);
  - ``normalize_image`` against the JAX package's.
"""

import io
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

import chip_smoke
from ifseg_torch.data.png import decode_png, decode_png_rgb, encode_png
from ifseg_torch.data.transforms import normalize_image, pil_resize
from ifseg_tpu.data.transforms import normalize_image as jax_normalize_image
import torch_port_utils  # noqa: F401,E402  (pins torch's threads under xdist)

SIZES = [(1, 1), (3, 5), (17, 33), (64, 100)]


def _pil_rgb(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def _same(data: bytes):
    got, want = decode_png_rgb(data), _pil_rgb(data)
    assert got.dtype == np.uint8 and got.shape == want.shape == want.shape[:2] + (3,)
    np.testing.assert_array_equal(got, want)


def _save(img: Image.Image, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, format="PNG", **kw)
    return buf.getvalue()


@pytest.mark.parametrize("size", SIZES, ids=[f"{h}x{w}" for h, w in SIZES])
@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA", "LA", "1"])
def test_pil_written_modes(size, mode):
    c = {"L": 1, "RGB": 3, "RGBA": 4, "LA": 2, "1": 1}[mode]
    arr = np.random.default_rng(c).integers(0, 256, size=size + (c,), dtype=np.uint8)
    img = Image.fromarray(arr[..., 0] > 127 if mode == "1" else arr[..., 0] if c == 1 else arr)
    assert img.mode == mode
    _same(_save(img))


@pytest.mark.parametrize("size", SIZES, ids=[f"{h}x{w}" for h, w in SIZES])
@pytest.mark.parametrize("bits", [1, 2, 4, 8])
def test_palette_files_are_looked_up(size, bits):
    rng = np.random.default_rng(bits)
    idx = rng.integers(0, 1 << bits, size=size).astype(np.uint8)
    img = Image.frombytes("P", (size[1], size[0]), idx.tobytes())
    img.putpalette(rng.integers(0, 256, size=3 * (1 << bits)).tolist())
    data = _save(img, bits=bits)
    assert data[24] == bits  # IHDR's bit depth
    _same(data)


def _with_plte(data: bytes, palette: bytes) -> bytes:
    """``data`` with its PLTE chunk's body replaced by ``palette``."""
    at = data.index(b"PLTE") - 4
    (length,) = struct.unpack(">I", data[at:at + 4])
    body = b"PLTE" + palette
    chunk = struct.pack(">I", len(palette)) + body + struct.pack(">I", zlib.crc32(body))
    return data[:at] + chunk + data[at + 12 + length:]


def test_indices_past_a_short_palette_read_black():
    idx = np.arange(16, dtype=np.uint8).reshape(4, 4)
    data = _with_plte(chip_smoke.png_bytes(idx, 3, 4), bytes([10, 20, 30, 40, 50, 60]))
    _same(data)
    assert decode_png_rgb(data)[3, 3].tolist() == [0, 0, 0]


@pytest.mark.parametrize("colour,depth", [(0, 8), (2, 8), (3, 8), (6, 8), (0, 1), (0, 2),
                                          (0, 4), (3, 1), (3, 2), (3, 4)])
def test_every_filter_type_by_hand(colour, depth):
    rng = np.random.default_rng(colour * 10 + depth)
    c = {0: 1, 2: 3, 3: 1, 6: 4}[colour]
    arr = rng.integers(0, 1 << depth, size=(11, 13, c)).astype(np.uint8)
    _same(chip_smoke.png_bytes(arr[..., 0] if c == 1 else arr, colour, depth))


def test_a_palette_file_without_plte_raises():
    idx = np.zeros((2, 2), np.uint8)
    data = chip_smoke.png_bytes(idx, 3, 8)
    at = data.index(b"PLTE") - 4
    (length,) = struct.unpack(">I", data[at:at + 4])
    with pytest.raises(ValueError, match="PLTE"):
        decode_png_rgb(data[:at] + data[at + 12 + length:])


def test_a_jpeg_file_raises():
    with open(chip_smoke.REPO / "assets" / "cat_dog.jpeg", "rb") as fp:
        data = fp.read()
    with pytest.raises(ValueError, match="not a PNG file"):
        decode_png_rgb(data)


# (h, w) -> (out_h, out_w): each axis kept, shrunk (below and above 2x) and grown
RESIZES = [((30, 40), (32, 32)), ((480, 640), (512, 512)), ((97, 61), (97, 200)),
           ((97, 61), (20, 61)), ((5, 300), (64, 7)), ((1, 1), (9, 4)), ((64, 64), (64, 64)),
           ((33, 17), (1, 1)), ((200, 150), (67, 51))]


@pytest.mark.parametrize("nearest", [False, True], ids=["bilinear", "nearest"])
@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("shapes", RESIZES, ids=[f"{a}-{b}" for a, b in RESIZES])
def test_pil_resize_equals_pil(shapes, channels, nearest):
    (h, w), (oh, ow) = shapes
    rng = np.random.default_rng(h * w)
    img = rng.integers(0, 256, size=(h, w, channels), dtype=np.uint8)
    img = img[..., 0] if channels == 1 else img
    want = np.asarray(Image.fromarray(img).resize(
        (ow, oh), Image.NEAREST if nearest else Image.BILINEAR))
    got = pil_resize(img, (oh, ow), nearest=nearest)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_pil_resize_takes_uint8_only():
    with pytest.raises(TypeError):
        pil_resize(np.zeros((4, 4), np.float32), (2, 2))


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("size", [(1, 1), (7, 3), (64, 90)])
def test_encode_png_round_trip(size, channels):
    rng = np.random.default_rng(channels)
    arr = rng.integers(0, 256, size=size + (channels,), dtype=np.uint8)
    arr = arr[..., 0] if channels == 1 else arr
    data = encode_png(arr)
    img = Image.open(io.BytesIO(data))
    assert img.mode == ("L" if channels == 1 else "RGB")
    np.testing.assert_array_equal(np.asarray(img), arr)
    np.testing.assert_array_equal(decode_png(data), arr)


def test_encode_png_refuses_other_images():
    for arr in (np.zeros((2, 2, 5), np.uint8), np.zeros((2, 2), np.int32),
                np.zeros((2, 2, 3), np.uint16), np.zeros((2, 2, 1), np.uint8)):
        with pytest.raises(ValueError):
            encode_png(arr)


def test_normalize_image_equals_jax():
    img = np.random.default_rng(0).integers(0, 256, size=(9, 7, 3), dtype=np.uint8)
    for mean, std in (((0.5,) * 3, (0.5,) * 3), ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))):
        got = normalize_image(img, mean, std)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, jax_normalize_image(img, mean, std))
