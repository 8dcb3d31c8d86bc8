"""The small raster formats PIL 12.1 reads in Python (SUN, MSP, XBM, XPM,
GBR, PIXAR, XVThumb, McIdas, IMT, SPIDER, FITS) through
``ifseg_torch.data.image`` against PIL, exactly (every tolerance 0), under
the JAX package's ``LOAD_TRUNCATED_IMAGES``:

  - every layout each reader takes, from ``torch_image_writers`` and, where
    PIL writes the format (MSP version 1, XBM, SPIDER), from PIL, at sizes
    whose rows need padding;
  - every cut and seeded byte flips: PIL's pixels, or ``ValueError`` where
    PIL raises; what PIL refuses raises.
"""

import numpy as np
import pytest
from PIL import Image, ImageFile

import torch_image_writers as W
from ifseg_torch.data.image import image_format
from torch_pil_checks import as_pil_or_raise, cuts_and_flips, same_as_pil
import torch_port_utils  # noqa: F401,E402  (pins torch's threads under xdist)


@pytest.fixture(autouse=True)
def _truncated_images(monkeypatch):
    monkeypatch.setattr(ImageFile, "LOAD_TRUNCATED_IMAGES", True)  # the JAX package's setting


_SIZES = [(1, 1), (5, 7), (13, 19), (8, 16)]


def _px(seed, h, w, c=None):
    shape = (h, w) if c is None else (h, w, c)
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _sun(h, w, depth, kind, colours=b""):
    stride = (w * depth + 15) // 16 * 2
    body = _px(depth + kind, h, stride)
    if kind == 2:  # byte-encoded: rows of (w * depth + 7) // 8 bytes, runs across them
        flat = np.repeat(body[:, :(w * depth + 7) // 8].reshape(-1)[::3], 3)
        flat[::17] = 0x80
        return W.sun_file(w, h, depth, W.sun_rle(flat.tobytes()), 2, colours)
    return W.sun_file(w, h, depth, body.tobytes(), kind, colours)


_SUN = {f"{d}-bit-type-{k}{'-map' if m else ''}": (d, k, m) for d, k, m in
        [(1, 1, False), (1, 2, False), (4, 1, False), (4, 1, True), (8, 0, False),
         (8, 1, True), (8, 2, False), (8, 2, True), (24, 1, False), (24, 3, False),
         (24, 2, False), (32, 1, False), (32, 3, False), (32, 2, False), (24, 4, False)]}


@pytest.mark.parametrize("name", list(_SUN))
def test_sun_layouts_equal_pil(name):
    depth, kind, with_map = _SUN[name]
    for h, w in [(1, 3)] + _SIZES[1:]:  # 1 x 1 may be a GIMP brush (test_torch_pil_readers_cli)
        colours = _px(h * w, 1, 3 * 37).tobytes() if with_map else b""
        data = _sun(h, w, depth, kind, colours)
        assert image_format(data) == "SUN"
        same_as_pil(data, "SUN")


def test_msp_equals_pil():
    for h, w in _SIZES:
        bits = _px(h * w, h, w) > 128
        same_as_pil(W.pil_save(Image.fromarray(bits), "MSP"), "MSP")
        rows = np.packbits(np.repeat(bits[:, ::4], 4, 1)[:, :w], axis=1)
        rows[::3] = 0xFF  # runs
        same_as_pil(W.msp_file(rows, w, h), "MSP")
        empty = W.msp_file(rows, w, h)
        empty = empty[:32] + bytes(2 * h) + empty[32 + 2 * h:]  # every row length 0: white
        same_as_pil(empty, "MSP")


def test_xbm_equals_pil():
    for h, w in _SIZES:
        bits = _px(h + w, h, w) > 100
        same_as_pil(W.pil_save(Image.fromarray(bits), "XBM"), "XBM")
        same_as_pil(W.pil_save(Image.fromarray(bits), "XBM", hotspot=(1, 2)), "XBM")
    text = (b"#define a_width 9\n#define a_height 2\nstatic char a_bits[] = {\n"
            b"0xF1, 0xzz, 0X3c,0x0g,\n0x1\n};")  # non-digits count 0, short values end it
    same_as_pil(text, "XBM")


@pytest.mark.parametrize("colours,chars,transparent", [(7, 1, False), (40, 2, True),
                                                       (256, 2, False), (300, 2, False)])
def test_xpm_equals_pil(colours, chars, transparent):
    rng = np.random.default_rng(colours)
    for h, w in _SIZES:
        idx = rng.integers(0, colours, (h, w))
        data = W.xpm_file(idx, rng.integers(0, 256, (colours, 3)), chars, transparent)
        same_as_pil(data, "XPM")


@pytest.mark.parametrize("version,bands", [(1, 1), (2, 1), (2, 4)])
def test_gbr_equals_pil(version, bands):
    for h, w in _SIZES:
        same_as_pil(W.gbr_file(_px(w, h, w, None if bands == 1 else 4), version), "GBR")


def test_pixar_and_xvthumb_equal_pil():
    for h, w in _SIZES:
        same_as_pil(W.pixar_file(_px(h, h, w, 3)), "PIXAR")
        same_as_pil(W.xvthumb_file(_px(w, h, w)), "XVThumb")


@pytest.mark.parametrize("size,prefix", [(1, 0), (1, 4), (2, 4), (4, 8)])
def test_mcidas_equals_pil(size, prefix):
    for h, w in _SIZES:
        values = np.random.default_rng(h * w).integers(-2 ** 31, 2 ** 31, (h, w))
        values = values & ((1 << 8 * size) - 1) if size < 4 else values
        data = W.mcidas_file(values, size, prefix)
        assert image_format(data) == "MCIDAS"
        same_as_pil(data, "MCIDAS")


def test_imt_equals_pil():
    for h, w in _SIZES:
        same_as_pil(W.imt_file(_px(h, h, w)), "IMT")
        same_as_pil(W.imt_file(_px(w, h, w), comment=b"*a\n*b"), "IMT")


@pytest.mark.parametrize("order", [">", "<", "pil"])
def test_spider_equals_pil(order):
    for h, w in _SIZES:
        values = (_px(w, h, w).astype(np.float32) - 99.5) / 7
        data = (W.pil_save(Image.fromarray(values), "SPIDER") if order == "pil"
                else W.spider_file(values, order))
        same_as_pil(data, "SPIDER")


@pytest.mark.parametrize("bitpix", [8, 16, 32, -32, -64])
def test_fits_equals_pil(bitpix):
    for h, w in _SIZES:
        v = _px(bitpix & 0xFF, h, w).astype(np.float64)
        values = {8: v, 16: v * 129 - 9999, 32: v * 8e6 - 1e9, -32: v / 3 - 20,
                  -64: v / 7 - 1}[bitpix]
        same_as_pil(W.fits_file(values, bitpix), "FITS")
        same_as_pil(W.fits_file(values, bitpix, pad=False), "FITS")


@pytest.mark.parametrize("zbitpix", [8, 16, 32])
def test_fits_gzip_equals_pil(zbitpix):
    for h, w in _SIZES:
        v = _px(zbitpix, h, w).astype(np.int64)
        values = {8: v, 16: v * 129 - 9999, 32: v * 8000000 - 10 ** 9}[zbitpix]
        for pad in (False, True):  # gzip.decompress skips the zeros after the stream
            data = W.fits_gzip_file(values, zbitpix, pad=pad)
            assert image_format(data) == "FITS"
            if h * w == 1 and not pad:  # data of less than a card: the offset is off
                assert as_pil_or_raise(data) == "raised"
            else:
                same_as_pil(data, "FITS")


def _refused():
    grey = _px(1, 6, 7)
    return {
        "sun-depth-16": W.sun_file(7, 6, 16, bytes(100)),
        "sun-type-6": W.sun_file(7, 6, 8, grey.tobytes(), 6),
        "sun-map-type-2": W.sun_file(7, 6, 8, grey.tobytes(), 1, bytes(30), 2),
        "sun-rgb-with-map": _sun(6, 7, 24, 1, bytes(30)),  # PIL's putpalette on "RGB"
        "sun-1-bit-with-map": _sun(6, 7, 1, 1, bytes(30)),
        "msp-checksum": W.msp_file(grey[:, :1], 7, 6)[:30] + b"\1\0",
        "msp-row-map-cut": W.msp_file(grey[:, :1], 7, 6)[:40],
        "xpm-no-c": b'/* XPM */\n"2 1 1 1",\n"a s #000000",\n"aa"\n',
        "xpm-bad-colour": b'/* XPM */\n"2 1 1 1",\n"a c red",\n"aa"\n',
        "xpm-transparent-pixel": W.xpm_file(grey % 3, grey[0, :2, None].repeat(3, 1), 1, True)
        .replace(b'"#', b'"%'),
        "gbr-cut": W.gbr_file(grey)[:-1],
        "gbr-depth-2": W.gbr_file(grey)[:16] + (2).to_bytes(4, "big") + W.gbr_file(grey)[20:],
        "pixar-layout": W.pixar_file(grey[:, :, None].repeat(3, 2))[:424] + b"\1\0"
        + W.pixar_file(grey[:, :, None].repeat(3, 2))[426:],
        "xvthumb-no-size": b"P7 332\n#c\n",
        "mcidas-bytes-3": W.mcidas_file(grey, 1)[:40] + (3).to_bytes(4, "big")
        + W.mcidas_file(grey, 1)[44:],
        "imt-no-pixel-line": b"width 4\nheight 2\n\x0c" + bytes(8),
        "imt-bad-width": b"width x\nheight 2\npixel n8\n\x0c" + bytes(8),
        "spider-form-3": W.spider_file(grey.astype(np.float32))[:16] + np.float32(3).byteswap()
        .tobytes() + W.spider_file(grey.astype(np.float32))[20:],
        "fits-no-end": b"SIMPLE  =                    T".ljust(80) + b"NAXIS   = 2".ljust(80),
        "fits-bitpix-64": W.fits_file(grey, 8).replace(b"BITPIX  =                    8",
                                                       b"BITPIX  =                   64"),
        "fits-gzip-float": W.fits_gzip_file(grey, -32),
        "fits-gzip-garbage": W.fits_gzip_file(grey, 16) + b"x",
    }


@pytest.mark.parametrize("name", list(_refused()))
def test_what_pil_refuses_raises(name):
    assert as_pil_or_raise(_refused()[name]) == "raised"


def _cut_files():
    grey, rgb = _px(2, 6, 7), _px(3, 6, 7, 3)
    return {
        "sun-raw": _sun(6, 7, 24, 1), "sun-rle": _sun(6, 7, 8, 2), "sun-1-bit": _sun(6, 9, 1, 1),
        "msp-1": W.pil_save(Image.fromarray(grey > 99), "MSP"),
        "msp-2": W.msp_file(np.packbits(np.repeat(grey[:, ::3] > 99, 3, 1)[:, :7], axis=1), 7, 6),
        "xbm": W.pil_save(Image.fromarray(grey > 99), "XBM"),
        "xpm": W.xpm_file(grey % 5, rgb[0, :5], 1),
        "gbr": W.gbr_file(np.dstack([rgb, grey])),
        "pixar": W.pixar_file(rgb), "xvthumb": W.xvthumb_file(grey),
        "mcidas": W.mcidas_file(grey.astype(np.int64) * 999, 2),
        "imt": W.imt_file(grey), "spider": W.spider_file(grey / 3, "<"),
        "fits": W.fits_file(grey.astype(np.int64) * 999, 16, pad=False),
        "fits-gzip": W.fits_gzip_file(grey, 8),
    }


@pytest.mark.parametrize("name", list(_cut_files()))
def test_every_cut_and_byte_flips_decode_as_pil(name):
    data = _cut_files()[name]
    head = {"pixar": 430, "spider": 120, "fits": 480, "fits-gzip": 5800}.get(name)
    decoded, raised = cuts_and_flips(data, flips=60, head=head, seed=len(name))
    assert decoded >= 1 and decoded + raised >= len(data)
