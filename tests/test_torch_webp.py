"""WebP files through ``ifseg_torch.data.image`` against PIL 12.1 (libwebp
1.6), exactly (every tolerance 0):

  - every WebP fixture of ``tests/torch_image_files/`` (lossy at several
    sizes, qualities and methods and at 1,024 x 1,366; one and four segments,
    four token partitions, the simple and the normal filter, sharpness > 0;
    lossless palettes of 2, 4, 16 and 256 colours, with and without a colour
    cache, ``exact`` RGBA; lossy + alpha, raw with each filter 0 to 3 and
    lossless; ``VP8X`` with ICCP / EXIF / XMP; RGB and RGBA animations and a
    first frame smaller than its canvas): ``decode_image`` gives PIL's mode
    and ``np.asarray``, ``decode_image_rgb`` its ``convert("RGB")``;
  - lossy and lossless files of odd sizes written by PIL at a spread of
    qualities and methods, and lossy ones with the encoder settings PIL's
    writer does not expose (``torch_image_writers.webp_encode``);
  - cuts at a seeded sample of lengths: every one raises ``ValueError``, as
    PIL raises on each;
  - byte flips in a small lossy, lossless and lossy + alpha file
    (``hypothesis``): where PIL decodes, the port gives PIL's pixels, where
    PIL raises, the port raises ``ValueError``, and the process never
    crashes (the decoders check every read).
"""

import io
import json
from pathlib import Path

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from PIL import Image

import torch_image_writers as W
from ifseg_torch.data.image import decode_image, decode_image_rgb, image_digest, image_format
import torch_port_utils  # noqa: F401,E402  (pins torch's threads under xdist)

FIXTURES = Path(__file__).parent / "torch_image_files"
WEBP_FIXTURES = sorted(p.name for p in FIXTURES.glob("*.webp"))


def _pil(data: bytes):
    im = Image.open(io.BytesIO(data))
    return np.asarray(im), im.mode, np.asarray(im.convert("RGB"))


def _same(data: bytes):
    pixels, mode, rgb = _pil(data)
    got, got_mode, palette = decode_image(data)
    assert image_format(data) == "WebP"
    assert got_mode == mode and palette is None
    assert got.dtype == pixels.dtype and got.shape == pixels.shape
    np.testing.assert_array_equal(got, pixels)
    np.testing.assert_array_equal(decode_image_rgb(data), rgb)


def _smooth(seed: int, h: int, w: int, c: int = 3):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h // 6 + 2, w // 6 + 2, c)).astype(np.int16)
    img = np.repeat(np.repeat(base, 6, 0), 6, 1)[:h, :w] + rng.integers(-12, 12, (h, w, c))
    return np.clip(img, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("name", WEBP_FIXTURES)
def test_fixture_equals_pil(name):
    data = (FIXTURES / name).read_bytes()
    _same(data)
    entry = json.loads((FIXTURES / "digests.json").read_text())[name]
    pixels, mode, _ = decode_image(data)
    assert entry["mode"] == mode and tuple(entry["shape"]) == pixels.shape
    assert entry["pixels"] == image_digest(pixels)
    assert entry["rgb"] == image_digest(decode_image_rgb(data))


@pytest.mark.parametrize("h,w", [(1, 1), (9, 17), (37, 45), (16, 16), (33, 2)])
@pytest.mark.parametrize("quality,method", [(0, 0), (50, 2), (90, 4), (100, 6)])
def test_lossy_sizes_and_qualities_equal_pil(h, w, quality, method):
    img = Image.fromarray(_smooth(h * 100 + w, h, w))
    _same(W.pil_save(img, "WEBP", quality=quality, method=method))


@pytest.mark.parametrize("h,w", [(1, 1), (9, 17), (37, 45), (3, 70)])
@pytest.mark.parametrize("mode,kw", [("RGB", dict(method=0)), ("RGB", dict(method=6, quality=100)),
                                     ("RGBA", dict(exact=True)), ("RGBA", dict(quality=0))])
def test_lossless_equals_pil(h, w, mode, kw):
    img = Image.fromarray(_smooth(h + w, h, w, len(mode)), mode)
    _same(W.pil_save(img, "WEBP", lossless=True, **kw))


@pytest.mark.parametrize("config", [
    dict(segments=1, filter_type=0, filter_strength=100),
    dict(segments=2, filter_type=1, filter_sharpness=7, filter_strength=100),
    dict(segments=4, partitions=3, method=0, quality=30),
    dict(segments=3, partitions=1, method=1, filter_type=0, filter_sharpness=2),
    dict(filter_strength=0),
    dict(alpha_compression=1, alpha_filtering=1, quality=90),
    dict(alpha_compression=0, quality=20),
], ids=["simple", "sharpness-7", "8-partitions", "2-partitions-simple", "no-filter",
        "alpha-fast-filter", "alpha-raw"])
def test_encoder_settings_equal_pil(config):
    channels = 4 if "alpha_compression" in config else 3
    _same(W.webp_encode(_smooth(len(config), 70, 90, channels), **config))


def _cut_bases():
    rgba = _smooth(5, 30, 41, 4)
    return {
        "lossy": W.pil_save(Image.fromarray(rgba[:, :, :3]), "WEBP", quality=60),
        "lossless": W.pil_save(Image.fromarray(rgba, "RGBA"), "WEBP", lossless=True),
        "alpha": W.pil_save(Image.fromarray(rgba, "RGBA"), "WEBP", quality=60),
        "animated": W.pil_save(Image.fromarray(rgba[:, :, :3]), "WEBP", save_all=True,
                               append_images=[Image.fromarray(rgba[::-1, :, :3])]),
    }


@pytest.mark.parametrize("kind", ["lossy", "lossless", "alpha", "animated"])
def test_cut_files_raise_as_pil(kind):
    data = _cut_bases()[kind]
    rng = np.random.default_rng(len(data))
    cuts = sorted(set(rng.integers(1, len(data), 24).tolist()) | {len(data) - 3, len(data) // 2})
    for n in cuts:
        with pytest.raises(Exception):
            np.asarray(Image.open(io.BytesIO(data[:n])))
        with pytest.raises(ValueError, match="WebP"):
            decode_image(data[:n])


def _flip_bases():
    rgba = _smooth(7, 12, 19, 4)
    return {
        "lossy": W.pil_save(Image.fromarray(rgba[:, :, :3]), "WEBP", quality=50),
        "lossless": W.pil_save(Image.fromarray(rgba, "RGBA"), "WEBP", lossless=True),
        "alpha": W.webp_encode(rgba, quality=50, alpha_compression=1, alpha_filtering=2),
    }


_BASES = _flip_bases()


@settings(max_examples=400, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(st.sampled_from(sorted(_BASES)), st.lists(st.tuples(st.integers(0, 4095), st.integers(1, 255)),
                                                  min_size=1, max_size=3))
def test_byte_flips_decode_as_pil_or_raise(kind, flips):
    data = bytearray(_BASES[kind])
    for pos, xor in flips:
        data[pos % len(data)] ^= xor
    data = bytes(data)
    try:
        pixels, mode, rgb = _pil(data)
    except Exception:
        with pytest.raises(ValueError):
            decode_image(data)
        return
    got, got_mode, _ = decode_image(data)
    assert got_mode == mode
    np.testing.assert_array_equal(got, pixels)
    np.testing.assert_array_equal(decode_image_rgb(data), rgb)


def _crafted():
    """Containers PIL's writer does not make, each held to PIL (decoded or refused)."""
    rgba = _smooth(11, 14, 22, 4)
    lossy = dict(W.riff_chunks(W.webp_encode(rgba, quality=60, alpha_compression=0)))
    lossless_rgb = dict(W.riff_chunks(W.pil_save(Image.fromarray(rgba[:, :, :3]), "WEBP",
                                                 lossless=True)))
    vp8, alph, vp8l = lossy[b"VP8 "], lossy[b"ALPH"], lossless_rgb[b"VP8L"]
    x = W.vp8x_chunk(22, 14, 0x10)
    plain = W.riff_file([(b"VP8 ", vp8)])
    anim = [W.vp8x_chunk(30, 20, 0x12), (b"ANIM", bytes(6))]

    def anmf(x0, y0, *chunks):
        body = b"".join(t + len(p).to_bytes(4, "little") + p + b"\0" * (len(p) & 1)
                        for t, p in chunks)
        return b"ANMF", b"".join(v.to_bytes(3, "little") for v in (x0 // 2, y0 // 2, 21, 13, 9)) \
            + b"\0" + body

    return {
        "vp8x-alpha-flag-alph": W.riff_file([x, (b"ALPH", alph), (b"VP8 ", vp8)]),
        "vp8x-no-flag-alph": W.riff_file([W.vp8x_chunk(22, 14, 0), (b"ALPH", alph), (b"VP8 ", vp8)]),
        "vp8x-alpha-flag-vp8l-without-hint": W.riff_file([x, (b"VP8L", vp8l)]),
        "vp8x-12-bytes": W.riff_file([(b"VP8X", x[1] + b"\0\0"), (b"VP8 ", vp8)]),
        "vp8x-unknown-flag": W.riff_file([W.vp8x_chunk(22, 14, 0x11), (b"VP8 ", vp8)]),
        "vp8x-wrong-canvas": W.riff_file([W.vp8x_chunk(24, 14, 0), (b"VP8 ", vp8)]),
        "vp8x-chunks-after-image": W.riff_file([W.vp8x_chunk(22, 14, 0x08), (b"VP8 ", vp8),
                                                (b"EXIF", b"abc"), (b"ZZZZ", b"12345")]),
        "alph-after-image": W.riff_file([x, (b"VP8 ", vp8), (b"ALPH", alph)]),
        "alph-before-vp8l": W.riff_file([x, (b"ALPH", alph), (b"VP8L", vp8l)]),
        "two-images": W.riff_file([(b"VP8 ", vp8), (b"VP8 ", vp8)]),
        "trailing-bytes-past-riff": plain + b"\1\2\3",
        "trailing-bytes-in-riff": plain[:4] + (len(plain) - 5).to_bytes(4, "little")
        + plain[8:] + b"\0\0\0\0\0",
        "alph-bad-header": W.riff_file([x, (b"ALPH", bytes([0x41]) + alph[1:]), (b"VP8 ", vp8)]),
        "alph-short-raw": W.riff_file([x, (b"ALPH", alph[:100]), (b"VP8 ", vp8)]),
        "anim-offset-frame": W.riff_file(anim + [anmf(6, 4, (b"ALPH", alph), (b"VP8 ", vp8))]),
        "anim-frame-outside": W.riff_file(anim + [anmf(10, 8, (b"VP8 ", vp8))]),
        "anim-no-anim-chunk": W.riff_file(anim[:1] + [anmf(0, 0, (b"VP8 ", vp8))]),
        "anim-flag-without-frames": W.riff_file(anim),
        "anim-lossless-frames": W.riff_file(anim + [anmf(2, 2, (b"VP8L", vp8l)),
                                                    anmf(0, 0, (b"VP8 ", vp8))]),
    }


@pytest.mark.parametrize("name", sorted(_crafted()))
def test_crafted_containers_decode_or_raise_as_pil(name):
    data = _crafted()[name]
    try:
        _pil(data)
    except Exception:
        with pytest.raises(ValueError, match="WebP"):
            decode_image(data)
        return
    _same(data)
