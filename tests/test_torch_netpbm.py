"""Netpbm files (PBM, PGM, PPM, PFM and PIL's own P0CMYK / Py*) through
``ifseg_torch.data.image`` against PIL 12.1's ``PpmImagePlugin``, exactly
(every tolerance 0), under the JAX package's ``LOAD_TRUNCATED_IMAGES``:

  - ``decode_image`` gives PIL's mode, ``np.asarray`` and palette and
    ``decode_image_rgb`` its ``convert("RGB")``: every magic number, raw and
    plain, at maxvals 1 to 65535 (the rescaled ones, the 16-bit "I", the
    raw copies), PFM in both byte orders, the files PIL's writer makes of
    modes 1, L, I, I;16, F, RGB and RGBA;
  - headers as PIL tokenizes them (comments inside and between tokens, CR,
    tabs), plain data with comments, a plain file larger than PIL's 1 MiB
    read block;
  - what PIL refuses raises ``ValueError``: samples above maxval or
    negative, a bad PBM token, too few samples, a maxval out of 1..65535, a
    token too long, a zero or infinite PFM scale, colour PFM ("PF") and PAM;
  - every cut of raw and rescaled files and seeded byte flips: PIL's pixels,
    or ``ValueError`` where PIL raises;
  - ``encode_ppm`` writes the bytes PIL's ``save`` writes for each Netpbm
    extension.
"""

import io

import numpy as np
import pytest
from PIL import Image, ImageFile

import torch_image_writers as W
from ifseg_torch.data.image import decode_image, image_format
from ifseg_torch.data.ppm import encode_ppm
from test_torch_image_files import _pil, _same
import torch_port_utils  # noqa: F401,E402  (pins torch's threads under xdist)


@pytest.fixture(autouse=True)
def _truncated_images(monkeypatch):
    monkeypatch.setattr(ImageFile, "LOAD_TRUNCATED_IMAGES", True)  # the JAX package's setting


def _image(h: int = 13, w: int = 17, seed: int = 0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (h, w, 4), dtype=np.uint8)


def _as_pil_or_raise(data: bytes) -> str:
    try:
        _pil(data)
    except Exception:  # what PIL raises under the flag
        with pytest.raises(ValueError):
            decode_image(data)
        return "raised"
    _same(data)
    return "decoded"


# ------------------------------------------------------- what PIL's save writes

@pytest.mark.parametrize("mode", ["1", "L", "I", "I;16", "F", "RGB", "RGBA"])
@pytest.mark.parametrize("size", [(1, 1), (13, 17), (8, 40)])
def test_pils_own_files_equal_pil(mode, size):
    px = _image(*size)
    arr = {"1": px[:, :, 0] > 100, "L": px[:, :, 0], "RGB": px[:, :, :3], "RGBA": px,
           "I": px[:, :, 0].astype(np.int32) * 257 - 70, "I;16": px[:, :, 0].astype(np.uint16) * 199,
           "F": px[:, :, 0].astype(np.float32) * 1.37 - 40}[mode]
    data = W.pil_save(Image.fromarray(arr, mode if mode == "RGBA" else None), "PPM")
    assert image_format(data) == "Netpbm"
    _same(data)


# ----------------------------------------------------------- every magic number

_MAXVALS = (1, 15, 100, 255, 256, 1000, 65535)


@pytest.mark.parametrize("maxval", _MAXVALS)
@pytest.mark.parametrize("magic", [b"P2", b"P3", b"P5", b"P6", b"P0CMYK", b"PyP", b"PyRGBA",
                                   b"PyCMYK"])
def test_each_magic_and_maxval_equals_pil(magic, maxval):
    px = _image(seed=maxval)
    arr = {b"P2": px[:, :, 0], b"P5": px[:, :, 0], b"P3": px[:, :, :3], b"P6": px[:, :, :3],
           b"PyP": px[:, :, 0]}.get(magic, px).astype(np.int64) * maxval // 255
    _same(W.netpbm_file(magic, arr, maxval=maxval, comment=b"made by hand"))


@pytest.mark.parametrize("magic", [b"P1", b"P4"])
@pytest.mark.parametrize("size", [(1, 1), (5, 9), (13, 17), (3, 64)])
def test_bitmaps_equal_pil(magic, size):
    _same(W.netpbm_file(magic, _image(*size)[:, :, 0] > 127))


@pytest.mark.parametrize("scale", [-1.0, -0.25, 1.0, 3.5])
def test_pfm_byte_orders_equal_pil(scale):
    px = _image(9, 11)[:, :, 0].astype(np.float32) / 7 - 3
    px[0, 0], px[1, 1] = np.inf, np.nan
    _same(W.netpbm_file(b"Pf", px, scale=scale))


def test_samples_above_maxval_in_raw_files_are_clipped_as_pil():
    """The raw decoder's samples are not checked against maxval: PIL clips
    each rescaled one to the top."""
    px = _image()[:, :, 0]
    for magic, maxval in ((b"P5", 100), (b"P6", 300), (b"P5", 1000)):
        arr = px if magic == b"P5" else np.dstack([px] * 3)
        body = arr.astype(np.uint8 if maxval < 256 else ">u2").tobytes()
        _same(magic + b"\n17 13\n%d\n" % maxval + body)


# ----------------------------------------------------------- headers and data

_HEADERS = {
    "comments-between-tokens": b"P5\n# one\n17 # two\n13\n# three\n255\n",
    "comment-inside-a-token": b"P5 1#c\n7 13 255\n",
    "comment-then-space": b"P5 17#c\n 13 255\n",
    "cr-and-tabs": b"P5\r17\t13\x0b255\x0c",
    "comment-to-cr": b"P5 17 13 #x\r255\n",
    "leading-zeros-and-plus": b"P5 +017 0013 00255\n",
    "underscore-digits": b"P5 1_7 13 255\n",
    "long-magic": b"P0CMYK 17 13 255\n",
}


@pytest.mark.parametrize("name", list(_HEADERS))
def test_headers_tokenize_as_pil(name):
    head = _HEADERS[name]
    bands = 4 if head.startswith(b"P0CMYK") else 1
    _same(head + _image().reshape(-1)[:13 * 17 * bands].tobytes() + b"trailing")


_PLAIN = {
    "comments-in-data": b"P2 4 2 255\n1 2 # three\n3 4\n# a line\n5 6 7 8\n",
    "comment-at-the-end": b"P2 2 2 9\n1 2 3 4 # no newline",
    "cr-comments": b"P3 2 1 255\n1 2 3\r# c\r4 5 6\n",
    "pbm-without-spaces": b"P1\n5 3\n10101\n01010 1 1 1 0 0\n",
    "pbm-comments": b"P1 3 2 # c\n1 0 # d\r1 0 1 1\n",
    "extra-samples": b"P2 2 2 255 1 2 3 4 5 6 7 x",
    "sixteen-bit-plain": b"P2 3 1 65535 0 32768 65535\n",
    "maxval-one": b"P3 2 1 1 0 1 0 1 1 1",
}


@pytest.mark.parametrize("name", list(_PLAIN))
def test_plain_files_equal_pil(name):
    _same(_PLAIN[name])


def test_a_plain_file_larger_than_a_read_block_equals_pil():
    """PIL reads plain files in blocks of 1 MiB; a token and a comment may
    cross a block's end."""
    px = _image(300, 320, seed=3)[:, :, :3].astype(np.int64) * 1000 // 255
    data = W.netpbm_file(b"P3", px, maxval=1000, per_line=7)
    data = data.replace(b"\n", b" # note\n", 2000)
    assert len(data) > 1 << 20
    _same(data)


_REFUSED = {
    "sample-above-maxval": b"P2 2 1 10 5 11",
    "negative-sample": b"P2 2 1 10 5 -1",
    "bad-pbm-token": b"P1 2 1 0 2",
    "too-few-samples": b"P3 2 2 255 1 2 3 4 5 6",
    "too-few-bits": b"P1 4 4 1 0 1",
    "maxval-zero": b"P5 2 2 0 abcd",
    "maxval-65536": b"P5 2 2 65536 abcdefgh",
    "token-too-long": b"P5 123456789012 2 255 ab",
    "plain-token-too-long": b"P2 2 1 255 1 000000000001",
    "header-ends": b"P6 17",
    "scale-zero": b"Pf 1 1 0.0 abcd",
    "scale-inf": b"Pf 1 1 inf abcd",
    "scale-nan": b"Pf 1 1 nan abcd",
    "colour-pfm": b"PF 1 1 -1.0 abcdabcdabcd",
    "pam": b"P7\nWIDTH 1\nHEIGHT 1\nDEPTH 1\nMAXVAL 255\nTUPLTYPE GRAYSCALE\nENDHDR\nx",
    "rescaled-cut": b"P5 4 4 100 abcdefgh",
    "sixteen-bit-cut": b"P5 2 2 1000 abc",
}


@pytest.mark.parametrize("name", list(_REFUSED))
def test_what_pil_refuses_raises(name):
    data = _REFUSED[name]
    with pytest.raises(Exception):
        _pil(data)
    with pytest.raises(ValueError):
        decode_image(data)


# ------------------------------------------------------------- cuts and flips

def _cut_files():
    px = _image(11, 14, seed=5)
    return {
        "P5": W.netpbm_file(b"P5", px[:, :, 0]),
        "P6": W.netpbm_file(b"P6", px[:, :, :3]),
        "P4": W.netpbm_file(b"P4", px[:, :, 0] > 99),
        "P5-65535": W.netpbm_file(b"P5", px[:, :, 0].astype(np.int64) * 257, maxval=65535),
        "P6-1000": W.netpbm_file(b"P6", px[:, :, :3].astype(np.int64) * 3, maxval=1000),
        "Pf": W.netpbm_file(b"Pf", px[:, :, 0].astype(np.float32) / 3, scale=-1.0),
        "P2": W.netpbm_file(b"P2", px[:4, :, 0]),
        "P1": W.netpbm_file(b"P1", px[:4, :, 0] > 99),
    }


@pytest.mark.parametrize("name", list(_cut_files()))
def test_every_cut_decodes_as_pil(name):
    data = _cut_files()[name]
    seen = [_as_pil_or_raise(data[:cut]) for cut in range(len(data) + 1)]
    assert seen.count("raised") >= 5
    if name in ("P5", "P6", "P4", "P5-65535", "Pf"):  # raw: a cut keeps its whole rows
        assert seen.count("decoded") > len(data) // 2


@pytest.mark.parametrize("name", ["P5", "P6-1000", "P2", "P1"])
def test_byte_flips_decode_as_pil_or_raise(name):
    data = _cut_files()[name]
    rng = np.random.default_rng(len(data))
    for _ in range(150):
        flipped = bytearray(data)
        flipped[int(rng.integers(0, min(len(data), 40)))] ^= int(rng.integers(1, 256))
        try:  # a flipped size field can make an image of hundreds of MB: not here
            width, height = Image.open(io.BytesIO(bytes(flipped))).size
            if width * height > 1 << 20:
                continue
        except Exception:
            pass
        _as_pil_or_raise(bytes(flipped))


# ------------------------------------------------------------------ writer

@pytest.mark.parametrize("ext", [".pbm", ".pgm", ".ppm", ".pnm", ".pfm"])
@pytest.mark.parametrize("h,w", [(1, 1), (13, 22), (64, 65)])
def test_encode_ppm_is_pils_save(ext, h, w, tmp_path):
    rgb = _image(h, w, seed=h * w)[:, :, :3]
    path = tmp_path / f"x{ext}"
    Image.fromarray(rgb).save(path)
    assert encode_ppm(rgb) == path.read_bytes()
