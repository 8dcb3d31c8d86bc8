"""Photoshop files (PSD) through ``ifseg_torch.data.image`` against PIL 12.1's
``PsdImagePlugin``, exactly (every tolerance 0), under the JAX package's
``LOAD_TRUNCATED_IMAGES``; PIL has no PSD writer, so the files come from
``torch_image_writers.psd_file``:

  - every row of PIL's ``MODES`` (bitmap at 1 bit, grey, bitmap at 8 bits,
    indexed with and without its 768-byte palette, RGB, CMYK, multichannel,
    duotone, Lab), raw and PackBits, with the channel counts around each
    (RGB with four channels reads as RGBA, with five as RGB; the extra
    channels' rows in the byte-count table PIL does not read), image
    resources (an ICC profile, names of odd and even lengths, odd bodies)
    and a layer section;
  - ``decode_image_rgb`` gives PIL's ``convert("RGB")``: a Lab file's through
    LittleCMS (``data/lab.py``), held here against PIL for every one of the
    2 ** 24 Lab values;
  - PackBits streams PIL's decoder reads its own way: runs and literals past
    a row's end (cut there), no-ops, rows whose byte counts are wrong;
  - every cut and seeded byte flips: PIL's pixels, or ``ValueError`` where
    PIL raises; what PIL refuses (16-bit files, PSB, ZIP compression, too few
    channels) raises naming it.
"""

import io
import struct

import numpy as np
import pytest
from PIL import Image, ImageFile

import torch_image_writers as W
from ifseg_torch.data.image import decode_image, image_format
from ifseg_torch.data.lab import lab_to_rgb
from test_torch_image_files import _pil, _same
import torch_port_utils  # noqa: F401,E402  (pins torch's threads under xdist)

# colour mode -> (name, channels the mode needs)
_COLOUR = {0: ("bitmap", 1), 1: ("grey", 1), 2: ("indexed", 1), 3: ("RGB", 3), 4: ("CMYK", 4),
           7: ("multichannel", 1), 8: ("duotone", 1), 9: ("Lab", 3)}
_RESOURCES = [(1005, b"", bytes(16)), (1039, b"icc", bytes(range(33))),
              (1060, b"xmp", b"<x:xmpmeta/>"), (4000, b"odd name", b"12345")]


@pytest.fixture(autouse=True)
def _truncated_images(monkeypatch):
    monkeypatch.setattr(ImageFile, "LOAD_TRUNCATED_IMAGES", True)  # the JAX package's setting


def _planes(c: int, h: int = 13, w: int = 17, seed: int = 0):
    """(c, h, w) uint8 with runs (PackBits has something to pack) and noise."""
    rng = np.random.default_rng(seed)
    runs = np.repeat(rng.integers(0, 256, (c, h, w // 4 + 1), dtype=np.uint8), 4, axis=2)[:, :, :w]
    noise = rng.integers(0, 256, (c, h, w), dtype=np.uint8)
    return np.where(rng.random((c, h, w)) < 0.5, runs, noise)


def _as_pil_or_raise(data: bytes) -> str:
    try:
        _pil(data)
    except Exception:  # what PIL raises under the flag
        with pytest.raises(ValueError):
            decode_image(data)
        return "raised"
    _same(data)
    return "decoded"


# ---------------------------------------------------------------- each mode

@pytest.mark.parametrize("compression", [0, 1], ids=["raw", "packbits"])
@pytest.mark.parametrize("colour,extra", [(c, e) for c in (1, 2, 3, 4, 7, 8, 9) for e in (0, 1, 2)])
def test_each_mode_equals_pil(colour, extra, compression):
    channels = _COLOUR[colour][1] + extra
    palette = np.random.default_rng(colour).integers(0, 256, (256, 3)) if colour == 2 else None
    data = W.psd_file(_planes(channels, seed=colour), colour, 8, compression, palette=palette,
                      resources=_RESOURCES)
    assert image_format(data) == "PSD"
    _same(data)


@pytest.mark.parametrize("compression", [0, 1], ids=["raw", "packbits"])
@pytest.mark.parametrize("size", [(1, 1), (13, 17), (5, 64)])
def test_bitmaps_equal_pil(size, compression):
    _same(W.psd_file(_planes(1, *size)[:, :, :] > 127, 0, 1, compression))


def test_indexed_without_a_palette_equals_pil():
    """A colour-mode block not of 768 bytes gives PIL's image no palette:
    every index converts to black."""
    for block in (None, np.zeros((100, 3), np.uint8)):
        data = W.psd_file(_planes(1), 2, 8, 1)
        if block is not None:  # a block of 300 bytes
            data = data[:26] + struct.pack(">I", 300) + bytes(300) + data[30:]
        _same(data)


@pytest.mark.parametrize("compression", [0, 1], ids=["raw", "packbits"])
def test_a_layer_section_is_skipped_as_pil_skips_it(compression):
    planes = _planes(4, seed=9)
    layers = W.psd_layer_section(planes[:3, :6, :5])
    _same(W.psd_file(planes, 3, 8, compression, resources=_RESOURCES, layers=layers))


def test_lab_to_rgb_is_littlecms_for_every_value():
    v = np.arange(256, dtype=np.uint8)
    lab = np.stack(np.meshgrid(v, v, v, indexing="ij"), -1).reshape(4096, 4096, 3)
    want = np.asarray(Image.fromarray(lab, "LAB").convert("RGB"))
    np.testing.assert_array_equal(lab_to_rgb(lab), want)


# ---------------------------------------------------------------- PackBits

def _packbits_file(rows, h: int = 3, w: int = 6) -> bytes:
    """A grey PSD of w x h whose rows are the PackBits bytes ``rows`` (their
    byte counts as written)."""
    head = b"8BPS" + struct.pack(">H6xHIIHH", 1, 1, h, w, 8, 1) + bytes(12)
    return (head + struct.pack(">H", 1) + b"".join(struct.pack(">H", len(r)) for r in rows)
            + b"".join(rows))


_STREAMS = {
    "run-past-the-row": [bytes([0xF9, 7]), bytes([0xFB, 8]), bytes([0xFB, 9])],
    "literal-past-the-row": [bytes([7]) + bytes(range(1, 9)), bytes([5]) + bytes(6),
                             bytes([0xFB, 3])],
    "no-ops": [bytes([0x80, 0xFB, 4, 0x80]), bytes([0x80, 0x80, 5, 1, 2, 3, 4, 5, 6]),
               bytes([0xFB, 5])],
    "a-row-in-two-ops": [bytes([0xFE, 1, 2, 7, 8, 9]), bytes([0xFB, 2]), bytes([0xFB, 3])],
    "counts-too-small": [bytes([0xFB, 1]), bytes([0xFB]), bytes([2, 3]), bytes([0xFB, 4])],
    "stream-ends-early": [bytes([0xFB, 1]), bytes([0xFD, 2])],
    "cut-literal": [bytes([0xFB, 1]), bytes([5, 1, 2])],
}


@pytest.mark.parametrize("name", list(_STREAMS))
def test_packbits_streams_decode_as_pil(name):
    _same(_packbits_file(_STREAMS[name]))


# ------------------------------------------------------------ refused files

_REFUSED = {
    "16-bit": (W.psd_file(_planes(3), 3, 16), "PSD RGB at 16 bits"),
    "32-bit": (W.psd_file(_planes(1), 1, 32), "PSD grey at 32 bits"),
    "psb": (b"8BPS\x00\x02" + W.psd_file(_planes(3), 3)[6:], "not a PSD file"),
    "zip": (W.psd_file(_planes(3), 3)[:-(13 * 17 * 3 + 2)] + b"\x00\x02" + bytes(100),
            "PSD compression 2"),
    "too-few-channels": (W.psd_file(_planes(2), 3), "needs 3 channels"),
    "zero-size": (W.psd_file(np.zeros((1, 0, 4), np.uint8), 1), "size"),
    "cut-header": (W.psd_file(_planes(1), 1)[:20], "not a PSD file"),
}


@pytest.mark.parametrize("name", list(_REFUSED))
def test_what_pil_refuses_raises_naming_it(name):
    data, message = _REFUSED[name]
    with pytest.raises(Exception):
        _pil(data)
    with pytest.raises(ValueError, match=message):
        decode_image(data)


# ----------------------------------------------------------- cuts and flips

def _cut_files():
    planes = _planes(4, 7, 9, seed=11)
    return {
        "rgb-packbits": W.psd_file(planes[:3], 3, 8, 1, resources=_RESOURCES[:2]),
        "cmyk-raw": W.psd_file(planes, 4, 8, 0),
        "lab-packbits": W.psd_file(planes[:3], 9, 8, 1),
        "indexed-raw": W.psd_file(planes[:1], 2, 8, 0,
                                  palette=np.random.default_rng(1).integers(0, 256, (256, 3))),
        "bitmap-packbits": W.psd_file(planes[:1] > 127, 0, 1, 1),
    }


@pytest.mark.parametrize("name", list(_cut_files()))
def test_every_cut_decodes_as_pil(name):
    data = _cut_files()[name]
    seen = [_as_pil_or_raise(data[:cut]) for cut in range(len(data) + 1)]
    assert seen.count("raised") >= 20 and seen.count("decoded") >= 20


@pytest.mark.parametrize("name", list(_cut_files()))
def test_byte_flips_decode_as_pil_or_raise(name):
    data = _cut_files()[name]
    rng = np.random.default_rng(len(data))
    for _ in range(100):
        flipped = bytearray(data)
        flipped[int(rng.integers(0, len(data)))] ^= int(rng.integers(1, 256))
        try:  # a flipped size field can make an image of hundreds of MB: not here
            width, height = Image.open(io.BytesIO(bytes(flipped))).size
            if width * height > 1 << 20:
                continue
        except Exception:
            pass
        _as_pil_or_raise(bytes(flipped))
