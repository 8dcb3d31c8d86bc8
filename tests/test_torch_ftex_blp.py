"""FTEX and BLP files through ``ifseg_torch.data.image`` against PIL 12.1's
``FtexImagePlugin`` and ``BlpImagePlugin``, exactly (every tolerance 0),
under the JAX package's ``LOAD_TRUNCATED_IMAGES``:

  - FTEX format 0 (DXT1 through ``bcn``, as DDS's BC1) and 1 (raw RGB), at
    sizes that are and are not multiples of 4, a negative mipmap size;
  - BLP1 palette (encodings 4 and 5, with and without alpha), BLP1 JPEG
    (the shared header joined to the data; RGB, grey and CMYK streams with
    and without Adobe's marker; stored as "BGR"; with alpha), BLP2 palette
    and BLP2 DXT1 / DXT3 / DXT5 with and without alpha, PIL's own BLP1 and
    BLP2 files;
  - BLP2's DXT decode is PIL's Python, not DDS's BC1: the same block gives
    other pixels through the two;
  - every cut and seeded byte flips: PIL's pixels, or ``ValueError`` where
    PIL raises; what PIL refuses raises.
"""

import io

import numpy as np
import pytest
from PIL import Image, ImageFile

import torch_image_writers as W
from ifseg_torch.data.image import decode_image, image_format
from torch_pil_checks import as_pil_or_raise, cuts_and_flips, same_as_pil
import torch_port_utils  # noqa: F401,E402  (pins torch's threads under xdist)


@pytest.fixture(autouse=True)
def _truncated_images(monkeypatch):
    monkeypatch.setattr(ImageFile, "LOAD_TRUNCATED_IMAGES", True)  # the JAX package's setting


_SIZES = [(1, 1), (4, 4), (5, 7), (13, 17), (8, 12)]


def _blocks(rng, w, h, size):
    return rng.integers(0, 256, ((w + 3) // 4) * ((h + 3) // 4) * size, dtype=np.uint8).tobytes()


@pytest.mark.parametrize("kind", [0, 1])
def test_ftex_equals_pil(kind):
    rng = np.random.default_rng(kind)
    for h, w in _SIZES:
        body = _blocks(rng, w, h, 8) if kind == 0 else rng.integers(
            0, 256, h * w * 3, dtype=np.uint8).tobytes()
        data = W.ftex_file(w, h, body, kind)
        assert image_format(data) == "FTEX"
        same_as_pil(data, "FTEX")
    same_as_pil(W.ftex_file(7, 5, body, kind, size=-1), "FTEX")  # the rest of the file


def _palette(rng):
    return rng.integers(0, 256, 1024, dtype=np.uint8).tobytes()


@pytest.mark.parametrize("encoding,alpha", [(4, 0), (5, 0), (5, 8)])
def test_blp1_palette_equals_pil(encoding, alpha):
    rng = np.random.default_rng(encoding + alpha)
    for h, w in _SIZES:
        idx = rng.integers(0, 256, h * w, dtype=np.uint8).tobytes()
        data = W.blp1_file(w, h, idx, 1, alpha, encoding, _palette(rng))
        assert image_format(data) == "BLP"
        same_as_pil(data, "BLP")


def _jpegs(rng):
    px = rng.integers(0, 256, (21, 30, 4), dtype=np.uint8)
    px = np.repeat(np.repeat(px[::3, ::3], 3, 0), 3, 1)[:21, :30]
    cmyk = W.pil_save(Image.fromarray(px, "CMYK"), "JPEG")
    return {"rgb": W.pil_save(Image.fromarray(px[:, :, :3]), "JPEG"),
            "grey": W.pil_save(Image.fromarray(px[:, :, 0]), "JPEG"),
            "cmyk": cmyk, "cmyk-no-adobe": W.without_adobe(cmyk),
            "progressive": W.pil_save(Image.fromarray(px[:, :, :3]), "JPEG", progressive=True)}


@pytest.mark.parametrize("name", ["rgb", "grey", "cmyk", "cmyk-no-adobe", "progressive"])
@pytest.mark.parametrize("alpha", [0, 1])
def test_blp1_jpeg_equals_pil(name, alpha):
    jpeg = _jpegs(np.random.default_rng(3))[name]
    for split, (w, h) in ((200, (30, 21)), (len(jpeg) // 2, (29, 20)), (2, (30, 21))):
        data = W.blp1_file(w, h, jpeg[split:], 0, alpha, 0, jpeg_header=jpeg[:split])
        same_as_pil(data, "BLP")
    # a JPEG smaller than the header's size: too few pixels, as PIL raises
    assert as_pil_or_raise(W.blp1_file(31, 21, jpeg[200:], 0, 0, 0, jpeg_header=jpeg[:200])
                           ) == "raised"


@pytest.mark.parametrize("alpha", [0, 8])
def test_blp2_palette_equals_pil(alpha):
    rng = np.random.default_rng(alpha)
    for h, w in _SIZES:
        idx = rng.integers(0, 256, h * w, dtype=np.uint8).tobytes()
        same_as_pil(W.blp2_file(w, h, idx, 1, alpha, 0, _palette(rng)), "BLP")


@pytest.mark.parametrize("alpha", [0, 1, 8])
@pytest.mark.parametrize("alpha_encoding,size", [(0, 8), (1, 16), (7, 16)],
                         ids=["dxt1", "dxt3", "dxt5"])
def test_blp2_dxt_equals_pil(alpha_encoding, size, alpha):
    rng = np.random.default_rng(alpha_encoding * 10 + alpha)
    for h, w in _SIZES + [(16, 32)]:
        blocks = np.frombuffer(_blocks(rng, w, h, size), np.uint8).reshape(-1, size).copy()
        at = 0 if size == 8 else 8
        blocks[::2, at:at + 4] = blocks[::2, [at + 2, at + 3, at, at + 1]]  # both orders
        same_as_pil(W.blp2_file(w, h, blocks.tobytes(), 2, alpha, alpha_encoding), "BLP")


@pytest.mark.parametrize("version", ["BLP1", "BLP2"])
def test_pils_own_blp_files_equal_pil(version):
    px = np.random.default_rng(5).integers(0, 256, (17, 23, 3), dtype=np.uint8)
    same_as_pil(W.pil_save(Image.fromarray(px).quantize(60), "BLP", blp_version=version), "BLP")


def test_blp2_dxt1_is_not_dds_bc1():
    """One DXT1 block through BLP2 (PIL's Python: colours widened by shifts,
    ``(2 * c0 + c1) // 3``) and through DDS (``BcnDecode.c``: the high bits
    replicated): other pixels, each path PIL's."""
    block = bytes([0x3F, 0xF8, 0xE0, 0x07, 0xE4, 0x1B, 0x4E, 0xB1])
    blp = W.blp2_file(4, 4, block, 2, 8, 0)
    dds = W.dds_file(4, 4, block, 0x4, b"DXT1")
    same_as_pil(blp, "BLP")
    same_as_pil(dds, "DDS")
    a, b = decode_image(blp)[0], decode_image(dds)[0]
    assert a.shape == b.shape and (a != b).any()
    assert (np.asarray(a[:, :, :3], np.int32) <= b[:, :, :3]).all()  # shifts alone: lower
    rng = np.random.default_rng(11)
    blocks = rng.integers(0, 256, (300, 8), dtype=np.uint8)
    bad = sum((decode_image(W.blp2_file(4, 4, bl.tobytes(), 2, 8, 0))[0]
               != decode_image(W.dds_file(4, 4, bl.tobytes(), 0x4, b"DXT1"))[0]).any()
              for bl in blocks)
    assert bad == 300


def _refused():
    rng = np.random.default_rng(2)
    idx = rng.integers(0, 256, 35, dtype=np.uint8).tobytes()
    cmyk = _jpegs(rng)["cmyk"]
    return {
        "ftex-format-2": W.ftex_file(4, 4, bytes(8), 2),
        "ftex-two-formats": W.ftex_file(4, 4, bytes(8), 0, formats=2),
        "blp1-encoding-3": W.blp1_file(7, 5, idx, 1, 0, 3),
        "blp1-compression-2": W.blp1_file(7, 5, idx, 2, 0, 5),
        "blp2-encoding-3": W.blp2_file(7, 5, idx, 3),
        "blp2-alpha-encoding-8": W.blp2_file(4, 4, bytes(16), 2, 8, 8),
        "blp2-too-few-indices": W.blp2_file(7, 5, idx[:30], 1),
        "blp1-ycck": W.blp1_file(30, 21, W.ycck_jpeg(cmyk)[200:], 0, 0, 0,
                                 jpeg_header=W.ycck_jpeg(cmyk)[:200]),
    }


@pytest.mark.parametrize("name", list(_refused()))
def test_what_is_refused_raises(name):
    data = _refused()[name]
    if name == "blp1-ycck":  # PIL reads it; the port names what it does not copy
        Image.open(io.BytesIO(data)).load()
        with pytest.raises(ValueError, match="YCCK"):
            decode_image(data)
        return
    assert as_pil_or_raise(data) == "raised"


def _cut_files():
    rng = np.random.default_rng(4)
    jpeg = _jpegs(rng)["rgb"]
    return {"ftex-dxt1": (W.ftex_file(10, 9, _blocks(rng, 10, 9, 8), 0), None),
            "ftex-rgb": (W.ftex_file(7, 6, bytes(range(126)), 1), None),
            "blp1-palette": (W.blp1_file(7, 6, bytes(range(42)), 1, 1, 5, _palette(rng)), None),
            "blp1-jpeg": (W.blp1_file(30, 21, jpeg[200:], 0, 0, 0, jpeg_header=jpeg[:200]),
                          160),
            "blp2-dxt5": (W.blp2_file(9, 6, _blocks(rng, 9, 6, 16), 2, 8, 7), None),
            "blp2-palette": (W.blp2_file(7, 6, bytes(range(42)), 1, 8, 0, _palette(rng)), None)}


@pytest.mark.parametrize("name", list(_cut_files()))
def test_every_cut_and_byte_flips_decode_as_pil(name):
    data, head = _cut_files()[name]
    decoded, raised = cuts_and_flips(data, flips=60, head=head, seed=len(name))
    assert decoded > 10 and raised >= 20
