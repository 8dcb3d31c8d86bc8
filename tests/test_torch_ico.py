"""Windows icons (ICO) and cursors (CUR) through ``ifseg_torch.data.image``
against PIL 12.1's ``IcoImagePlugin`` and ``CurImagePlugin``, exactly (every
tolerance 0), under the JAX package's ``LOAD_TRUNCATED_IMAGES``:

  - the icons PIL's writer makes, PNG and bitmap entries, of modes 1, L, P,
    RGB and RGBA at several sizes;
  - bitmap entries by hand (``torch_image_writers.dib``) at 1, 4, 8, 16, 24
    and 32 bits with AND masks, the core and V4 headers, bitfields with
    alpha, RLE8, a directory bit count of 32 over a 24-bit bitmap;
  - which entry PIL loads: sorted by colour depth (the bit count, else the
    colour count, else 256) and then by area, a size byte of 0 read as 256,
    PNG entries among bitmap ones, an entry whose image is not the size the
    directory says, a palette PNG entry with tRNS (its alpha not kept);
  - cursors: the first entry, or a later one strictly wider and taller, a
    32-bit bitmap at offset 22 (RGBA) and elsewhere (RGB), no AND mask;
  - every cut of icons and cursors and seeded byte flips: PIL's pixels, or
    ``ValueError`` where PIL raises; what PIL refuses (no entry, a cut
    directory, a bitmap of zero size) raises.
"""

import io

import numpy as np
import pytest
from PIL import Image, ImageFile

import torch_image_writers as W
from ifseg_torch.data.image import decode_image, image_format
from test_torch_image_files import _pil, _same
import torch_port_utils  # noqa: F401,E402  (pins torch's threads under xdist)

pytestmark = pytest.mark.filterwarnings("ignore:Image was not the expected size")


@pytest.fixture(autouse=True)
def _truncated_images(monkeypatch):
    monkeypatch.setattr(ImageFile, "LOAD_TRUNCATED_IMAGES", True)  # the JAX package's setting


def _rgba(h: int, w: int, seed: int = 0):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 4), dtype=np.uint8)


def _png(arr, mode=None, **kw) -> bytes:
    return W.pil_save(Image.fromarray(arr, mode), "PNG", **kw)


def _as_pil_or_raise(data: bytes) -> str:
    try:
        _pil(data)
    except Exception:  # what PIL raises under the flag
        with pytest.raises(ValueError):
            decode_image(data)
        return "raised"
    _same(data)
    return "decoded"


# -------------------------------------------------------- what PIL's save writes

@pytest.mark.parametrize("fmt", ["png", "bmp"])
@pytest.mark.parametrize("mode", ["1", "L", "P", "RGB", "RGBA"])
def test_pils_own_icons_equal_pil(mode, fmt):
    px = _rgba(32, 32, seed=len(mode))
    im = {"1": Image.fromarray(px[:, :, 0] > 127), "L": Image.fromarray(px[:, :, 0]),
          "P": Image.fromarray(px[:, :, :3]).quantize(20), "RGB": Image.fromarray(px[:, :, :3]),
          "RGBA": Image.fromarray(px, "RGBA")}[mode]
    data = W.pil_save(im, "ICO", sizes=[(32, 32), (16, 16), (8, 8)], bitmap_format=fmt)
    assert image_format(data) == "ICO"
    _same(data)


# ------------------------------------------------------------- bitmap entries

def _bitmap_icons():
    px = _rgba(13, 17, seed=1)
    mask = px[:, :, 3] > 140
    pal = _rgba(256, 1, seed=2)[:, 0, :3]
    files = {}
    for bits in (1, 4, 8):
        idx = px[:, :, 0].astype(int) % (1 << bits)
        for header in (12, 40):
            files[f"{bits}bit-h{header}"] = W.ico_file(
                [(W.dib(idx, bits, pal[:1 << bits], mask, header), dict(width=17, height=13,
                                                                        bits=bits))])
    for bits in (16, 24, 32):
        files[f"{bits}bit"] = W.ico_file([(W.dib(px[:, :, :3], bits, None, mask),
                                           dict(width=17, height=13, bits=bits))])
    files["32bit-alpha-bitfields-v4"] = W.ico_file([(W.dib(
        px, 32, None, mask, 108, 3, (0xFF0000, 0xFF00, 0xFF, 0xFF000000)),
        dict(width=17, height=13, bits=32))])
    files["24bit-under-a-32-bit-entry"] = W.ico_file(
        [(W.dib(px[:, :, :3], 24, None, mask), dict(width=17, height=13, bits=32))])
    files["8bit-rle8"] = W.ico_file([(W.dib(px[:, :, 0] // 16 * 16, 8, pal, mask, compression=1),
                                      dict(width=17, height=13, bits=8))])
    files["gray-ramp-dropped"] = W.ico_file([(W.dib(
        px[:, :, 0], 8, np.repeat(np.arange(256)[:, None], 3, 1), mask), dict(width=17, height=13))])
    files["no-mask-bytes"] = W.ico_file([(W.dib(px[:, :, :3], 24), dict(width=17, height=13,
                                                                         bits=24))])
    files["mask-past-the-end"] = W.ico_file([(W.dib(px[:, :, :3], 24, None, mask),
                                              dict(width=17, height=13, bits=24, size=4000))])
    files["wide-mask-rows"] = W.ico_file([(W.dib(_rgba(5, 40)[:, :, :3], 24, None,
                                                 _rgba(5, 40)[:, :, 3] > 99),
                                           dict(width=40, height=5, bits=24))])
    return files


@pytest.mark.parametrize("name", list(_bitmap_icons()))
def test_bitmap_entries_equal_pil(name):
    _same(_bitmap_icons()[name])


# ---------------------------------------------------------- which entry loads

def _directories():
    px = _rgba(40, 40, seed=3)
    mask = px[:, :, 3] > 99
    pal = _rgba(16, 1, seed=4)[:, 0, :3]
    small = W.dib(px[:8, :8, :3], 24, None, mask[:8, :8])
    return {
        "largest-area-first": W.ico_file([
            (small, dict(width=8, height=8, bits=24)),
            (W.dib(px[:20, :30, :3], 24, None, mask[:20, :30]), dict(width=30, height=20, bits=24)),
            (_png(px[:16, :16]), dict(width=16, height=16))]),
        "deepest-of-equal-areas-last": W.ico_file([
            (W.dib(px[:16, :16, 0] % 16, 4, pal, mask[:16, :16]), dict(width=16, height=16,
                                                                      bits=4)),
            (_png(px[:16, :16]), dict(width=16, height=16, bits=32)),
            (W.dib(px[:16, :16, :3], 24, None, mask[:16, :16]), dict(width=16, height=16,
                                                                    bits=24))]),
        "colour-count-depth": W.ico_file([
            (W.dib(px[:16, :16, 0] % 16, 4, pal, mask[:16, :16]), dict(width=16, height=16,
                                                                      bits=0, colours=16)),
            (W.dib(px[:16, :16, 0] % 2, 1, pal[:2], mask[:16, :16]), dict(width=16, height=16,
                                                                         bits=0, colours=1)),
            (W.dib(px[:16, :16, :3], 24, None, mask[:16, :16]), dict(width=16, height=16, bits=0))]),
        "size-zero-is-256": W.ico_file([
            (_png(np.tile(px[:32, :32], (8, 8, 1))), dict(width=256, height=256)),
            (_png(px), dict(width=40, height=40))]),
        "not-the-size-the-directory-says": W.ico_file([(_png(px[:11, :19]),
                                                       dict(width=64, height=64))]),
        "bitmap-not-the-directory-size": W.ico_file([(W.dib(px[:9, :5, :3], 24, None, mask[:9, :5]),
                                                     dict(width=64, height=64, bits=24))]),
        "palette-png-with-trns": W.ico_file([(W.pil_save(Image.fromarray(px[:, :, :3]).quantize(9),
                                                         "PNG", transparency=3),
                                              dict(width=40, height=40))]),
        "grey-alpha-png": W.ico_file([(_png(px[:, :, :2], "LA"), dict(width=40, height=40))]),
        "sixteen-bit-png": W.ico_file([(_png(px[:, :, 0].astype(np.uint16) * 257),
                                        dict(width=40, height=40))]),
    }


@pytest.mark.parametrize("name", list(_directories()))
def test_the_entry_pil_loads_equals_pil(name):
    _same(_directories()[name])


# ------------------------------------------------------------------ cursors

def _cursors():
    px = _rgba(13, 17, seed=5)
    mask = px[:, :, 3] > 120
    pal = _rgba(16, 1, seed=6)[:, 0, :3]
    entry = lambda w, h, **kw: dict(width=w, height=h, planes=3, bits=4, **kw)  # noqa: E731
    return {
        "24bit": W.ico_file([(W.dib(px[:, :, :3], 24, None, mask), entry(17, 13))], kind=2),
        "32bit-at-22": W.ico_file([(W.dib(px, 32, None, mask), entry(17, 13))], kind=2),
        "32bit-elsewhere": W.ico_file([(W.dib(px[:4, :4, 0] % 16, 4, pal, mask[:4, :4]),
                                        entry(4, 4)),
                                       (W.dib(px, 32, None, mask), entry(17, 13))], kind=2),
        "strictly-larger-wins": W.ico_file([
            (W.dib(px[:4, :9, :3], 24, None, mask[:4, :9]), entry(9, 4)),
            (W.dib(px[:6, :6, 0] % 16, 4, pal, mask[:6, :6]), entry(6, 6)),
            (W.dib(px[:8, :10, 0] % 16, 4, pal, mask[:8, :10]), entry(10, 8)),
            (W.dib(px[:8, :12, :3], 24, None, mask[:8, :12]), entry(12, 8))], kind=2),
        "1bit": W.ico_file([(W.dib(px[:, :, 0] > 99, 1, pal[:2], mask), entry(17, 13))], kind=2),
        "8bit": W.ico_file([(W.dib(px[:, :, 0], 8, _rgba(256, 1)[:, 0, :3], mask), entry(17, 13))],
                           kind=2),
    }


@pytest.mark.parametrize("name", list(_cursors()))
def test_cursors_equal_pil(name):
    data = _cursors()[name]
    assert image_format(data) == "CUR"
    _same(data)


# ----------------------------------------------------------- cuts and flips

def _cut_files():
    px = _rgba(9, 11, seed=7)
    mask = px[:, :, 3] > 99
    pal = _rgba(16, 1, seed=8)[:, 0, :3]
    return {
        "ico-24bit": W.ico_file([(W.dib(px[:, :, :3], 24, None, mask), dict(width=11, height=9,
                                                                            bits=24))]),
        "ico-32bit": W.ico_file([(W.dib(px, 32, None, mask), dict(width=11, height=9, bits=32))]),
        "ico-4bit": W.ico_file([(W.dib(px[:, :, 0] % 16, 4, pal, mask), dict(width=11, height=9,
                                                                             bits=4))]),
        "ico-png": W.ico_file([(_png(px), dict(width=11, height=9))]),
        "cur-24bit": W.ico_file([(W.dib(px[:, :, :3], 24, None, mask), dict(width=11, height=9))],
                                kind=2),
    }


@pytest.mark.parametrize("name", list(_cut_files()))
def test_every_cut_decodes_as_pil(name):
    data = _cut_files()[name]
    seen = [_as_pil_or_raise(data[:cut]) for cut in range(len(data) + 1)]
    assert seen.count("raised") >= 20 and seen.count("decoded") >= 1


@pytest.mark.parametrize("name", list(_cut_files()))
def test_byte_flips_decode_as_pil_or_raise(name):
    data = _cut_files()[name]
    # a PNG entry's flips in its directory entry and IHDR: its image data is
    # the PNG decoder's (tests/test_torch_png.py)
    span = 22 + 33 if name == "ico-png" else len(data)
    rng = np.random.default_rng(len(data))
    for _ in range(100):
        flipped = bytearray(data)
        flipped[int(rng.integers(0, span))] ^= int(rng.integers(1, 256))
        try:  # a flipped size field can make an image of hundreds of MB: not here
            width, height = Image.open(io.BytesIO(bytes(flipped))).size
            if width * height > 1 << 20:
                continue
        except Exception:
            pass
        _as_pil_or_raise(bytes(flipped))


_REFUSED = {
    "no-entry": b"\x00\x00\x01\x00\x00\x00",
    "cut-directory": b"\x00\x00\x01\x00\x02\x00" + bytes(20),
    "no-cursor": b"\x00\x00\x02\x00\x00\x00",
    "cursor-one-row-high": W.ico_file([(W.dib(np.zeros((1, 4, 3), np.uint8), 24)
                                        [:8] + b"\x01\x00\x00\x00" + W.dib(np.zeros((1, 4, 3),
                                                                                   np.uint8), 24)[12:],
                                        dict(width=4, height=1))], kind=2),
}


@pytest.mark.parametrize("name", list(_REFUSED))
def test_what_pil_refuses_raises(name):
    data = _REFUSED[name]
    with pytest.raises(Exception):
        _pil(data)
    with pytest.raises(ValueError):
        decode_image(data)
