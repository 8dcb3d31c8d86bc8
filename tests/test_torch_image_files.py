"""The image files PIL opens beyond PNG and plain JPEG, through
``ifseg_torch.data.image`` against PIL 12.1, exactly (every tolerance 0):

  - ``decode_image`` gives ``np.asarray(Image.open(...))``, PIL's mode and
    palette (with a GIF's transparency index as alpha 0), and
    ``decode_image_rgb`` gives ``np.asarray(Image.open(...).convert("RGB"))``,
    for GIF (global / local / no palette, the gray ramp PIL drops,
    interlaced, offset and growing frames, a transparency index, a full LZW
    table with no clear code, animations), BMP (every header, 1 to 32 bits,
    RLE8 / RLE4, bitfields, top-down rows), TIFF (both byte orders, strips and
    tiles, planar 1 and 2, none / PackBits / LZW / Deflate, predictor 2,
    photometric 0, 1, 2, 3 and 5 with alpha extra samples, 1, 4, 8 and 16
    bits) and CMYK / YCCK JPEG files, from seeded arrays through PIL's
    writers and ``torch_image_writers``;
  - every cut of GIF, BMP and TIFF files decodes as PIL decodes it under the
    JAX package's ``ImageFile.LOAD_TRUNCATED_IMAGES`` or raises where PIL
    raises (CMYK JPEG cuts: ``tests/test_torch_cut_files.py``);
  - the formats and layouts PIL refuses, and those the port leaves for later
    (JPEG-in-TIFF, floating-point TIFF, and each format of PIL's ``Image.ID``
    with a signature that the port does not read: QOI, SGI, DDS, ICNS, PCX,
    FITS, XPM, ...), raise ``ValueError`` naming them; WebP, JPEG 2000, ICO
    and PSD files, which the port once refused, decode as PIL decodes them
    (``test_torch_webp.py``, ``test_torch_jpeg2000.py``, ``test_torch_ico.py``,
    ``test_torch_psd.py``, ``test_torch_netpbm.py``);
  - ``encode_bmp`` and ``encode_tiff`` write the bytes of PIL's ``save``;
  - ``tests/torch_image_files/digests.json`` holds PIL's mode, shape and
    digests of every committed fixture (``chip_smoke.py`` phase 14e checks
    the port's decodes on the card's machine, which has no PIL, against it).
"""

import hashlib
import io
import json
import struct
from functools import lru_cache
from pathlib import Path

import numpy as np
import pytest
from PIL import Image, ImageFile

import torch_image_writers as W
from ifseg_torch.data.bmp import encode_bmp
from ifseg_torch.data.image import decode_image, decode_image_rgb, image_digest
from ifseg_torch.data.png import to_rgb
from ifseg_torch.data.tiff import encode_tiff
import torch_port_utils  # noqa: F401,E402  (pins torch's threads under xdist)

FIXTURES = Path(__file__).parent / "torch_image_files"


def _pil(data: bytes):
    """(pixels, mode, palette, RGB) as PIL gives them."""
    im = Image.open(io.BytesIO(data))
    pixels = np.asarray(im)
    palette = None
    if im.mode in ("P", "PA"):
        palette = np.array(im.getpalette(), np.uint8).reshape(-1, 3)
        t = im.info.get("transparency")
        if isinstance(t, int):
            alpha = np.full((len(palette), 1), 255, np.uint8)
            alpha[t] = 0
            palette = np.concatenate([palette, alpha], axis=1)
    return pixels, im.mode, palette, np.asarray(im.convert("RGB"))


def _same(data: bytes):
    want, mode, palette, rgb = _pil(data)
    got, got_mode, got_palette = decode_image(data)
    assert got_mode == mode
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    if palette is None:
        assert got_palette is None
    else:
        np.testing.assert_array_equal(got_palette, palette)
    got_rgb = decode_image_rgb(data)
    assert got_rgb.dtype == np.uint8
    np.testing.assert_array_equal(got_rgb, rgb)


def _rng(name: str):
    return np.random.default_rng(int(hashlib.sha256(name.encode()).hexdigest()[:8], 16))


def _smooth(rng, h, w, c=3):
    """A photograph's smooth regions and grain (compresses as photos do)."""
    base = rng.integers(0, 255, (h // 6 + 2, w // 6 + 2, c)).astype(np.float64)
    ys = np.linspace(0, base.shape[0] - 1.01, h).astype(int)
    xs = np.linspace(0, base.shape[1] - 1.01, w).astype(int)
    img = np.clip(base[ys][:, xs] + rng.normal(0, 6, (h, w, c)), 0, 255).astype(np.uint8)
    return img if c > 1 else img[:, :, 0]


# ---------------------------------------------------------------------- GIF

@lru_cache(maxsize=None)
def _gifs():
    r = _rng("gif")
    rgb = _smooth(r, 37, 41)
    pal16 = r.integers(0, 256, (16, 3))
    idx16 = r.integers(0, 16, (19, 23))
    ramp = np.repeat(np.arange(256)[:, None], 3, axis=1)
    frames = [dict(indices=idx16, bits=4),
              dict(indices=r.integers(0, 16, (6, 7)), bits=4, x=2, y=3, palette=pal16[::-1])]
    return {
        "pil-rgb-interlaced": W.pil_save(Image.fromarray(rgb), "GIF"),
        "pil-rgb": W.pil_save(Image.fromarray(rgb), "GIF", interlace=0),
        "pil-gray": W.pil_save(Image.fromarray(rgb[:, :, 0]), "GIF"),
        "pil-small": W.pil_save(Image.fromarray(rgb[:5, :6]).quantize(5), "GIF"),
        "pil-animated": W.pil_save(Image.fromarray(rgb).quantize(16), "GIF", save_all=True,
                                   append_images=[Image.fromarray(rgb[::-1]).quantize(16)]),
        "global-2bit": W.gif_file([dict(indices=r.integers(0, 4, (19, 23)), bits=2)], (23, 19),
                                  global_palette=pal16[:4]),
        "local-interlaced": W.gif_file([dict(indices=idx16, bits=4, palette=pal16, interlace=1)],
                                       (23, 19), global_palette=pal16[:2]),
        "transparency-offset": W.gif_file([dict(indices=idx16, bits=4, transparency=5, x=4, y=2)],
                                          (30, 25), global_palette=pal16),
        "frame-grows-screen": W.gif_file([dict(indices=idx16, bits=4, x=6, y=5)], (10, 8),
                                         global_palette=pal16),
        "no-palette": W.gif_file([dict(indices=idx16, bits=4)], (23, 19)),
        "gray-ramp-dropped": W.gif_file([dict(indices=r.integers(0, 256, (9, 9)))], (9, 9),
                                        global_palette=ramp),
        "local-ramp-global-palette": W.gif_file(
            [dict(indices=r.integers(0, 256, (9, 9)), palette=ramp)], (9, 9),
            global_palette=r.integers(0, 256, (256, 3))),
        "full-table-no-clear": W.gif_file(
            [dict(indices=r.integers(0, 256, (70, 90)), clear_every=None)], (90, 70),
            global_palette=r.integers(0, 256, (256, 3))),
        "full-table-cleared": W.gif_file(
            [dict(indices=r.integers(0, 256, (70, 90)))], (90, 70),
            global_palette=r.integers(0, 256, (256, 3))),
        "animated-comment-loop": W.gif_file(frames, (14, 12), global_palette=pal16, loop=0,
                                            comment=b"x" * 300, junk=b"\x01\x02"),
    }


@pytest.mark.parametrize("name", list(_gifs()))
def test_gif_equals_pil(name):
    _same(_gifs()[name])


# ---------------------------------------------------------------------- BMP

@lru_cache(maxsize=None)
def _bmps():
    r = _rng("bmp")
    files = {}
    rgb = _smooth(r, 11, 19)
    for mode, arr in (("1", r.integers(0, 2, (13, 21)).astype(bool)), ("L", rgb[:, :, 0]),
                      ("RGB", rgb), ("RGBA", np.dstack([rgb, rgb[:, :, 0]]))):
        files[f"pil-{mode}"] = W.pil_save(Image.fromarray(arr), "BMP")
    files["pil-P"] = W.pil_save(Image.fromarray(rgb).quantize(50), "BMP")
    for header in (12, 40, 52, 56, 64, 108, 124):
        for bits in (1, 4, 8):
            pal = r.integers(0, 256, (1 << bits, 3))
            idx = r.integers(0, 1 << bits, (11, 19))
            files[f"h{header}-{bits}bit"] = W.bmp_file(idx, bits, header, pal)
        for bits in (16, 24, 32):
            files[f"h{header}-{bits}bit-rgb"] = W.bmp_file(rgb, bits, header)
    runs = np.repeat(r.integers(0, 256, (11, 5)), 4, axis=1)[:, :19]
    runs[:, 10:] = r.integers(0, 256, (11, 9))
    pal = r.integers(0, 256, (256, 3))
    files["rle8"] = W.bmp_file(runs, 8, 40, pal, compression=1)
    files["rle8-top-down-v5"] = W.bmp_file(runs, 8, 124, pal, compression=1, top_down=True)
    files["rle4"] = W.bmp_file(runs % 16, 4, 40, pal[:16], compression=2)
    files["top-down-24bit"] = W.bmp_file(rgb, 24, 40, top_down=True)
    files["gray-ramp-dropped"] = W.bmp_file(r.integers(0, 256, (6, 9)), 8, 40,
                                            np.repeat(np.arange(256)[:, None], 3, axis=1))
    files["black-white-dropped"] = W.bmp_file(r.integers(0, 2, (6, 9)), 1, 40,
                                              [[0, 0, 0], [255, 255, 255]])
    files["seven-colours"] = W.bmp_file(r.integers(0, 9, (6, 9)), 8, 40, pal[:7], colors_used=7)
    rgba = np.dstack([rgb, r.integers(0, 256, rgb.shape[:2], dtype=np.uint8)])
    for name, bits, header, masks in (
            ("565", 16, 40, (0xF800, 0x7E0, 0x1F)), ("555", 16, 56, (0x7C00, 0x3E0, 0x1F)),
            ("bgr-24", 24, 40, (0xFF0000, 0xFF00, 0xFF)), ("bgrx", 32, 108, (0xFF0000, 0xFF00, 0xFF, 0)),
            ("bgra-v5", 32, 124, (0xFF0000, 0xFF00, 0xFF, 0xFF000000)),
            ("rgba-v4", 32, 108, (0xFF, 0xFF00, 0xFF0000, 0xFF000000)),
            ("abgr", 32, 56, (0xFF000000, 0xFF0000, 0xFF00, 0xFF)),
            ("xbgr", 32, 40, (0xFF000000, 0xFF0000, 0xFF00))):
        files[f"bitfields-{name}"] = W.bmp_file(rgba if len(masks) == 4 and masks[3] else rgb,
                                                bits, header, compression=3, masks=masks)
    return files


@pytest.mark.parametrize("name", list(_bmps()))
def test_bmp_equals_pil(name):
    _same(_bmps()[name])


def _rle_bmp(body: bytes, bits: int, gap: int = 0, w: int = 10, h: int = 4) -> bytes:
    """An RLE8 (bits 8) or RLE4 (bits 4) BMP of ``body`` as it stands, ``gap``
    bytes after the palette."""
    pal = _rng(f"rle{bits}").integers(0, 256, (1 << bits, 4), dtype=np.uint8).tobytes()
    info = struct.pack("<IiiHHIIiiII", 40, w, h, 1, bits, 1 if bits == 8 else 2, len(body), 0, 0,
                       0, 0)
    offset = 14 + len(info) + len(pal) + gap
    return (b"BM" + struct.pack("<IHHI", offset + len(body), 0, 0, offset) + info + pal
            + bytes(gap) + body)


# RLE streams no writer makes, each (bits, body, gap): deltas (PIL skips two
# bytes before the two it uses), runs past the row's end (clipped until the
# end of line), absolute runs of odd counts (RLE4 reads count // 2 bytes)
# and at odd file offsets (the word alignment is the file's), a stream that
# ends early, a delta cut off
_EOL, _END = b"\0\0", b"\0\1"
_RLE_STREAMS = {
    "rle8-delta": (8, bytes([3, 7, 0, 2, 9, 9, 2, 1, 4, 5]) + (_EOL + bytes([10, 1])) * 2 + _END,
                   0),
    "rle8-run-past-the-row": (8, bytes([15, 9, 0, 0, 25, 3, 0, 0, 12, 4, 0, 0, 10, 6, 0, 1]), 0),
    "rle8-odd-absolute": (8, (bytes([0, 3, 1, 2, 3, 0, 0, 5, 4, 5, 6, 7, 8, 0, 2, 9]) + _EOL) * 4
                          + _END, 0),
    "rle8-absolute-at-odd-offsets": (8, (bytes([0, 3, 1, 2, 3, 7, 7]) + _EOL) * 4 + _END, 1),
    "rle4-odd-absolute": (4, bytes([0, 5, 0x12, 0x34, 0x56, 0, 3, 0x78, 0, 0]) * 4 + _END, 0),
    "rle4-delta-and-runs": (4, bytes([7, 0xAB, 0, 2, 0, 0, 3, 2, 0, 0, 20, 0xCD, 0, 1]), 0),
    "rle8-short": (8, bytes([10, 1, 0, 0, 4, 2, 0, 1]), 0),
    "rle8-delta-cut": (8, bytes([10, 1, 0, 2, 9, 9, 3]), 0),
}


@pytest.mark.parametrize("name", list(_RLE_STREAMS))
def test_hand_written_rle_streams_decode_as_pil(name):
    bits, body, gap = _RLE_STREAMS[name]
    data = _rle_bmp(body, bits, gap)
    if name in ("rle8-short", "rle8-delta-cut"):
        with pytest.raises(Exception):
            _pil(data)
        with pytest.raises(ValueError, match="RLE"):
            decode_image(data)
        return
    _same(data)


# --------------------------------------------------------------------- TIFF

@lru_cache(maxsize=None)
def _tiffs():
    r = _rng("tiff")
    files = {}
    rgb = _smooth(r, 21, 37)
    for mode, arr in (("1", r.integers(0, 2, (13, 21)).astype(bool)), ("L", rgb[:, :, 0]),
                      ("RGB", rgb), ("RGBA", np.dstack([rgb, rgb[:, :, 1]])),
                      ("LA", rgb[:, :, :2]), ("CMYK", np.dstack([rgb, rgb[:, :, 2]])),
                      ("I;16", r.integers(0, 65536, (9, 13)).astype(np.uint16))):
        im = Image.fromarray(arr, mode if mode in ("LA", "CMYK") else None)
        for comp in ("raw", "tiff_lzw", "tiff_adobe_deflate", "packbits"):
            files[f"pil-{mode}-{comp}"] = W.pil_save(im, "TIFF", compression=comp)
    files["pil-P"] = W.pil_save(Image.fromarray(rgb).quantize(40), "TIFF")
    files["pil-P-deflate"] = W.pil_save(Image.fromarray(rgb).quantize(40), "TIFF",
                                        compression="tiff_deflate")
    rgba = np.dstack([rgb, r.integers(0, 256, rgb.shape[:2], dtype=np.uint8)])
    cmap = r.integers(0, 65536, (256, 3))
    layouts = {"strips": dict(rows_per_strip=4), "tiles": dict(tile=(16, 16)),
               "planar": dict(planar=2, rows_per_strip=5), "planar-tiles": dict(planar=2, tile=(16, 32))}
    for order in ("II", "MM"):
        for comp, name in ((1, "none"), (5, "lzw"), (8, "adobe-deflate"), (32946, "deflate"),
                           (32773, "packbits")):
            for lay, kw in layouts.items():
                pred = 2 if comp in (5, 8) else 1
                files[f"{order}-{name}-{lay}-rgb"] = W.tiff_file(rgb, 8, 2, order, comp, pred, **kw)
                files[f"{order}-{name}-{lay}-rgba"] = W.tiff_file(rgba, 8, 2, order, comp, pred,
                                                                  extra=(2,), **kw)
            files[f"{order}-{name}-cmyk"] = W.tiff_file(rgba, 8, 5, order, comp, 1, rows_per_strip=7)
            files[f"{order}-{name}-16bit"] = W.tiff_file(r.integers(0, 65536, (21, 37)), 16, 1, order,
                                                         comp, 2 if comp == 5 else 1, tile=(16, 16))
        files[f"{order}-min-is-white"] = W.tiff_file(rgb[:, :, 0], 8, 0, order, 5, 2)
        files[f"{order}-1bit-min-is-white"] = W.tiff_file(rgb[:, :, 0] > 127, 1, 0, order, 32773)
        files[f"{order}-1bit-fill-order-2"] = W.tiff_file(rgb[:, :, 0] > 127, 1, 1, order, 5, fill=2)
        files[f"{order}-palette"] = W.tiff_file(rgb[:, :, 0], 8, 3, order, 8, colormap=cmap)
        files[f"{order}-palette-4bit"] = W.tiff_file(rgb[:, :, 0] % 16, 4, 3, order, 1,
                                                     colormap=cmap[:16], tile=(16, 16))
        files[f"{order}-gray-4bit"] = W.tiff_file(rgb[:, :, 0] % 16, 4, 1, order, 5)
        files[f"{order}-lzw-literals"] = W.tiff_file(rgb, 8, 2, order, 5, 2, rows_per_strip=4,
                                                     lzw_literals=True)
        files[f"{order}-la"] = W.tiff_file(rgb[:, :, :2], 8, 1, order, 8, 2, extra=(2,))
        files[f"{order}-premultiplied"] = W.tiff_file(rgba, 8, 2, order, 1, extra=(1,))
        files[f"{order}-rgb-16bit"] = W.tiff_file(r.integers(0, 65536, (21, 37, 3)), 16, 2, order, 8)
    return files


@pytest.mark.parametrize("name", list(_tiffs()))
def test_tiff_equals_pil(name):
    _same(_tiffs()[name])


# ---------------------------------------------------------------- CMYK JPEG

@lru_cache(maxsize=None)
def _cmyk_jpegs():
    r = _rng("cmyk")
    files = {}
    for h, w in ((1, 1), (17, 33), (40, 48), (64, 97)):
        cmyk = np.dstack([_smooth(r, h, w), _smooth(r, h, w, 1)])
        for tag, kw in (("", {}), ("-progressive", {"progressive": True}),
                        ("-q95-444", {"quality": 95, "subsampling": 0})):
            data = W.pil_save(Image.fromarray(cmyk, "CMYK"), "JPEG", **kw)
            files[f"cmyk-{h}x{w}{tag}"] = data
            files[f"ycck-{h}x{w}{tag}"] = W.ycck_jpeg(data)
        files[f"no-adobe-{h}x{w}"] = W.without_adobe(data)
        adobe1 = bytearray(data)
        adobe1[data.index(b"\xff\xee") + 15] = 1  # an unknown transform: YCCK, as libjpeg assumes
        files[f"adobe-transform-1-{h}x{w}"] = bytes(adobe1)
    return files


@pytest.mark.parametrize("name", list(_cmyk_jpegs()))
def test_cmyk_jpeg_equals_pil(name):
    _same(_cmyk_jpegs()[name])


def test_cmyk_to_rgb_is_pillows():
    """Pillow 12.1: ``Image.new("CMYK", ..., (10, 20, 30, 40)).convert("RGB")``
    is (207, 198, 190); every CMYK value against PIL's conversion."""
    np.testing.assert_array_equal(to_rgb(np.array([[[10, 20, 30, 40]]], np.uint8), mode="CMYK"),
                                  [[[207, 198, 190]]])
    v = np.arange(256, dtype=np.uint8)
    grid = np.stack(np.meshgrid(v, v, indexing="ij"), axis=-1).reshape(256, 256, 2)
    cmyk = np.concatenate([grid, grid[:, :, ::-1]], axis=2)
    want = np.asarray(Image.fromarray(cmyk, "CMYK").convert("RGB"))
    np.testing.assert_array_equal(to_rgb(cmyk, mode="CMYK"), want)


# --------------------------------------------------------------- cut files

@lru_cache(maxsize=None)
def _cut_files():
    r = _rng("cuts")
    rgb = _smooth(r, 23, 31)
    return {
        "gif": W.pil_save(Image.fromarray(rgb), "GIF", interlace=0),
        "gif-interlaced": W.pil_save(Image.fromarray(np.repeat(rgb, 2, axis=0)), "GIF"),
        "gif-local-transparency": W.gif_file(
            [dict(indices=r.integers(0, 16, (17, 19)), bits=4, palette=r.integers(0, 256, (16, 3)),
                  transparency=3, x=2, y=1)], (25, 20), comment=b"c" * 300),
        "bmp": W.pil_save(Image.fromarray(rgb), "BMP"),
        "bmp-rle8": W.bmp_file(np.repeat(r.integers(0, 50, (9, 8)), 3, axis=1), 8, 40,
                               r.integers(0, 256, (256, 3)), compression=1),
        "tiff": W.pil_save(Image.fromarray(rgb), "TIFF"),
        "tiff-lzw": W.pil_save(Image.fromarray(rgb), "TIFF", compression="tiff_lzw"),
    }


@pytest.mark.parametrize("name", list(_cut_files()))
def test_every_cut_decodes_as_pil(name, monkeypatch):
    monkeypatch.setattr(ImageFile, "LOAD_TRUNCATED_IMAGES", True)  # the JAX package's setting
    data = _cut_files()[name]
    decoded = raised = 0
    for cut in range(len(data) + 1):
        try:
            want = _pil(data[:cut])
        except Exception:  # what PIL raises under the flag
            with pytest.raises(ValueError):
                decode_image(data[:cut])
            raised += 1
            continue
        got, mode, _ = decode_image(data[:cut])
        assert mode == want[1] and got.dtype == want[0].dtype, (name, cut)
        assert np.array_equal(got, want[0]), (name, cut)
        assert np.array_equal(decode_image_rgb(data[:cut]), want[3]), (name, cut)
        decoded += 1
    assert decoded >= 1 and raised >= 10
    if name not in ("tiff-lzw", "bmp-rle8"):  # PIL raises on a cut strip or RLE stream
        assert decoded > len(data) // 3


# ---------------------------------------------------------- refused files

def _refused():
    r = _rng("refused")
    rgb = _smooth(r, 8, 8)
    jpeg_tiff = W.pil_save(Image.fromarray(rgb), "TIFF", compression="jpeg")
    float_tiff = W.pil_save(Image.fromarray(rgb[:, :, 0].astype(np.float32)), "TIFF")
    return [
        ("webp", W.pil_save(Image.fromarray(rgb), "WEBP"), None),  # read since WebP was ported
        ("ico", W.pil_save(Image.fromarray(rgb), "ICO", sizes=[(8, 8)]), None),  # read since ported
        ("jpeg2000", W.pil_save(Image.fromarray(rgb), "JPEG2000"), None),  # read since ported
        ("psd", b"8BPS\x00\x01" + bytes(40), "PSD bitmap at 0 bits is not supported"),
        ("jpeg-in-tiff", jpeg_tiff, "TIFF compression JPEG is not supported"),
        ("float-tiff", float_tiff, "floating-point TIFF"),
        ("ycbcr-tiff", W.tiff_file(rgb, 8, 6), "TIFF photometric YCbCr is not supported"),
        ("ccitt-tiff", W.pil_save(Image.fromarray(rgb[:, :, 0] > 99), "TIFF", compression="group4"),
         "TIFF compression CCITT Group 4 is not supported"),
        ("bmp-png", W.bmp_file(rgb, 24, 40)[:30] + b"\x05\0\0\0" + W.bmp_file(rgb, 24, 40)[34:],
         "BMP compression PNG is not supported"),
        ("bmp-2bit", W.bmp_file(rgb, 24, 40)[:28] + b"\x02\0" + W.bmp_file(rgb, 24, 40)[30:],
         "BMP pixel depth 2"),
        ("gif-no-image", b"GIF89a\x01\0\x01\0\0\0\0;", "no image"),
        ("text", b"plain text, no image",
         "not a PNG, JPEG, GIF, BMP, TIFF, WebP, JPEG 2000, ICO, CUR, Netpbm or PSD file"),
    ]


@pytest.mark.parametrize("case", _refused(), ids=[c[0] for c in _refused()])
def test_refused_files_raise_naming_why(case):
    name, data, message = case
    if message is None:  # a format the port reads now: PIL's pixels
        _same(data)
        return
    if name not in ("webp", "ico", "jpeg2000", "psd", "jpeg-in-tiff", "float-tiff", "ycbcr-tiff",
                    "ccitt-tiff", "text"):
        with pytest.raises(Exception):  # PIL refuses these too
            np.asarray(Image.open(io.BytesIO(data)))
    with pytest.raises(ValueError, match=message):
        decode_image(data)
    with pytest.raises(ValueError, match=message):
        decode_image_rgb(data)


def _other_formats():
    """(name, file, the format the message names) of each format PIL opens
    that the port refuses: PIL's writer's file where it has one, else the
    signature PIL's plugin accepts."""
    r = _rng("others")
    rgb = _smooth(r, 8, 8)
    im = Image.fromarray(rgb)
    return [
        ("qoi", W.pil_save(im, "QOI"), "QOI"),
        ("sgi", W.pil_save(im, "SGI"), "SGI"),
        ("dds", W.pil_save(im, "DDS"), "DDS"),
        ("icns", W.pil_save(im.resize((16, 16)), "ICNS"), "ICNS"),
        ("pcx", W.pil_save(im, "PCX"), "PCX"),
        ("dcx", b"\xb1\x68\xde\x3a" + bytes(16), "DCX"),
        ("fits", b"SIMPLE  =                    T" + b" " * 50, "FITS"),
        ("xpm", b"/* XPM */\nstatic char *x[] = {\n", "XPM"),
        ("xbm", W.pil_save(im.convert("1"), "XBM"), "XBM"),
        ("blp", W.pil_save(im.quantize(16), "BLP"), "BLP"),
        ("ftex", b"FTEX" + bytes(20), "FTEX"),
        ("msp", W.pil_save(im.convert("1"), "MSP"), "MSP"),
        ("sun", b"\x59\xa6\x6a\x95" + bytes(28), "SUN"),
        ("pixar", b"\x80\xe8\x00\x00" + bytes(20), "PIXAR"),
        ("xvthumb", b"P7 332\n#XVVERSION\n", "XVThumb"),
        ("mcidas", b"\x00" * 7 + b"\x04" + bytes(24), "McIdas"),
        ("eps", W.pil_save(im, "EPS"), "EPS"),
        ("wmf", b"\xd7\xcd\xc6\x9a\x00\x00" + bytes(20), "WMF"),
        ("hdf5", b"\x89HDF\r\n\x1a\n" + bytes(8), "HDF5"),
        ("bigtiff", b"II+\x00\x08\x00\x00\x00" + bytes(16), "BigTIFF"),
    ]


@pytest.mark.parametrize("case", _other_formats(), ids=[c[0] for c in _other_formats()])
def test_other_pil_formats_raise_naming_them(case):
    """A format PIL opens that the port does not read: ``ValueError`` naming
    it, not "not a PNG, ... file"."""
    name, data, fmt = case
    with pytest.raises(ValueError, match=f"^{fmt}.* files are not supported"):
        decode_image(data)
    with pytest.raises(ValueError, match=f"^{fmt}"):
        decode_image_rgb(data)


# ------------------------------------------------------------------ writers

@pytest.mark.parametrize("h,w", [(1, 1), (3, 5), (13, 22), (64, 65), (300, 71)])
def test_bmp_and_tiff_writers_are_pils_save(h, w):
    rgb = _rng(f"writer{h}x{w}").integers(0, 256, (h, w, 3), dtype=np.uint8)
    assert encode_bmp(rgb) == W.pil_save(Image.fromarray(rgb), "BMP")
    assert encode_tiff(rgb) == W.pil_save(Image.fromarray(rgb), "TIFF")


# ----------------------------------------------------------------- fixtures

def test_fixture_digests_are_pils(monkeypatch):
    """Every committed fixture: PIL's mode, shape and SHA-256 of the pixels
    and of the RGB conversion as ``digests.json`` records them (under the
    JAX package's ``LOAD_TRUNCATED_IMAGES``: one file is cut), and the
    port's decode equal to PIL's."""
    monkeypatch.setattr(ImageFile, "LOAD_TRUNCATED_IMAGES", True)
    table = json.loads((FIXTURES / "digests.json").read_text())
    files = sorted(p.name for p in FIXTURES.iterdir() if p.name != "digests.json")
    assert files == sorted(table)
    assert sum((FIXTURES / f).stat().st_size for f in files) < 512 * 1024
    for name in files:
        data = (FIXTURES / name).read_bytes()
        pixels, mode, _, rgb = _pil(data)
        entry = table[name]
        assert entry["mode"] == mode and tuple(entry["shape"]) == pixels.shape, name
        assert entry["pixels"] == image_digest(pixels) and entry["rgb"] == image_digest(rgb), name
        _same(data)


def test_the_fixtures_cover_every_psd_mode_and_netpbm_magic():
    """At least one fixture a row of PIL's ``PsdImagePlugin.MODES`` and of
    ``PpmImagePlugin.MODES``, and ICO files with PNG and bitmap entries, and
    CUR files: what ``chip_smoke.py`` phase 14e holds the port to on the
    card's machine."""
    from PIL import PpmImagePlugin, PsdImagePlugin

    names = sorted(p.name for p in FIXTURES.iterdir() if p.name != "digests.json")
    psd = {struct.unpack(">HH", (FIXTURES / n).read_bytes()[22:26])[::-1]
           for n in names if n.endswith(".psd")}
    assert psd == set(PsdImagePlugin.MODES)
    magics = set()
    for n in names:
        data = (FIXTURES / n).read_bytes()
        if n.endswith((".pbm", ".pgm", ".ppm", ".pnm", ".pfm")):
            magics.add(data.split(maxsplit=1)[0])
    assert magics == set(PpmImagePlugin.MODES)
    icons = [(FIXTURES / n).read_bytes() for n in names if n.endswith(".ico")]
    assert any(b"\x89PNG" in d for d in icons) and any(b"\x89PNG" not in d for d in icons)
    assert sum(n.endswith(".cur") for n in names) >= 2
