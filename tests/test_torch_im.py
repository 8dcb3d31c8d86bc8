"""IM files through ``ifseg_torch.data.image`` against PIL 12.1's
``ImImagePlugin``, exactly (every tolerance 0), under the JAX package's
``LOAD_TRUNCATED_IMAGES``:

  - every image type of PIL's ``OPEN`` table (those PIL cannot load raise
    ``ValueError``), without a LUT, with a grey one and with a colour one
    (an "L" or "P" image becomes "P", an "LA" one "PA"), at several sizes,
    from ``torch_image_writers.im_file`` and PIL's writer; the 2- to 31-bit
    "L*n" types through PIL's bit decoder;
  - headers as PIL parses them (the defaults, comments, CR LF or LF, a key
    with no known tag, sizes with "*" or ",", trailing blanks, a line
    longer than 100 bytes, a key starting with a digit, a size that is not
    a number);
  - YCbCr converted to RGB as Pillow's tables do, over all 2^24 values;
  - every cut and seeded byte flips: PIL's pixels, or ``ValueError`` where
    PIL raises;
  - ``encode_im`` writes the bytes of PIL's ``save``, the file's name in the
    header.
"""

import numpy as np
import pytest
from PIL import Image, ImageFile, ImImagePlugin

import torch_image_writers as W
from ifseg_torch.data.im import OPEN, encode_im, ycbcr_to_rgb
from ifseg_torch.data.image import image_format
from torch_pil_checks import as_pil_or_raise, cuts_and_flips, pil_view, same_as_pil
import torch_port_utils  # noqa: F401,E402  (pins torch's threads under xdist)


@pytest.fixture(autouse=True)
def _truncated_images(monkeypatch):
    monkeypatch.setattr(ImageFile, "LOAD_TRUNCATED_IMAGES", True)  # the JAX package's setting


_GREY_LUT = bytes(np.tile(np.arange(255, -1, -1, dtype=np.uint8), 3))


def _file(kind: str, h: int, w: int, lut: str = None, seed: int = 0) -> bytes:
    rng = np.random.default_rng(seed)
    table = {None: None, "grey": _GREY_LUT,
             "colour": rng.integers(0, 256, 768, dtype=np.uint8).tobytes()}[lut]
    lines = [b"Image type: " + kind.encode(), b"Image size (x*y): %d*%d" % (w, h)]
    return W.im_file(lines + ([b"Lut: 1"] if table else []),
                     rng.integers(0, 256, h * w * 16, dtype=np.uint8).tobytes(), lut=table)


def test_the_table_is_pils():
    assert OPEN == ImImagePlugin.OPEN


@pytest.mark.parametrize("lut", [None, "grey", "colour"])
@pytest.mark.parametrize("kind", sorted(OPEN))
def test_each_image_type_equals_pil(kind, lut):
    for h, w in [(1, 1), (2, 3), (13, 17)]:
        data = _file(kind, h, w, lut, seed=h * w)
        assert as_pil_or_raise(data) == ("raised" if kind in ("RLB image", "RYB image")
                                         or (kind == "PA image" and lut != "colour")
                                         else "decoded")


@pytest.mark.parametrize("mode", ["1", "L", "LA", "P", "PA", "I", "I;16", "I;16B", "F", "RGB",
                                  "RGBA", "CMYK", "YCbCr"])
def test_pils_own_files_equal_pil(mode, tmp_path):
    px = np.random.default_rng(1).integers(0, 256, (9, 14, 4), dtype=np.uint8)
    img = {"1": Image.fromarray(px[:, :, 0] > 99), "L": Image.fromarray(px[:, :, 0]),
           "LA": Image.fromarray(px[:, :, :2], "LA"),
           "P": Image.fromarray(px[:, :, :3]).quantize(40),
           "PA": Image.fromarray(px[:, :, :3]).quantize(40).convert("PA"),
           "I": Image.fromarray(px[:, :, 0].astype(np.int32) * 70000 - 9),
           "I;16": Image.fromarray(px[:, :, 0].astype(np.uint16) * 250),
           "I;16B": Image.fromarray(px[:, :, 0].astype(">u2") * 250),
           "F": Image.fromarray(px[:, :, 0].astype(np.float32) / 7 - 3),
           "RGB": Image.fromarray(px[:, :, :3]), "RGBA": Image.fromarray(px, "RGBA"),
           "CMYK": Image.fromarray(px, "CMYK"), "YCbCr": Image.fromarray(px[:, :, :3], "YCbCr")}
    path = tmp_path / "x.im"
    img[mode].save(path)
    data = path.read_bytes()
    assert image_format(data) == "IM"
    same_as_pil(data, "IM")


_HEADERS = {
    "defaults": ([b"Name: only a name"], b"\n"),
    "comments": ([b"Image size (x*y): 3*2", b"Comment: a", b"Comment: b"], b"\r\n"),
    "unknown-key-and-a-tag": ([b"image size: 3*2", b"Name: q"], b"\r\n"),
    "comma-size": ([b"Image size (x*y): 3,2"], b"\n"),
    "trailing-blanks": ([b"Image size (x*y): 3*2  ", b"Image type: L 16 image"], b"\n"),
    "unknown-type": ([b"Image type: RGB image  "], b"\n"),
    "no-known-tag": ([b"Width: 3", b"Height: 2"], b"\n"),
    "long-line": ([b"Name: " + b"x" * 120], b"\n"),
    "digit-key": ([b"9Name: x"], b"\n"),
    "three-sizes": ([b"Image size (x*y): 3*2*4"], b"\n"),
    "float-size": ([b"Image size (x*y): 3.5*2"], b"\n"),
    "word-size": ([b"Image size (x*y): a*2"], b"\n"),
    "frames": ([b"File size (no of images): 2", b"Image size (x*y): 3*2"], b"\n"),
}


@pytest.mark.parametrize("name", list(_HEADERS))
def test_headers_parse_as_pil(name):
    lines, newline = _HEADERS[name]
    as_pil_or_raise(W.im_file(lines, bytes(range(256)) * 1100, newline=newline))


def test_ycbcr_converts_as_pillow_over_every_value():
    grid = np.stack(np.meshgrid(np.arange(256), np.arange(256), np.arange(256), indexing="ij"),
                    -1).astype(np.uint8).reshape(4096, 4096, 3)
    want = np.asarray(Image.fromarray(grid, "YCbCr").convert("RGB"))
    np.testing.assert_array_equal(ycbcr_to_rgb(grid), want)


@pytest.mark.parametrize("kind,lut", [("RGB image", None), ("L*12 image", None),
                                      ("L 32F image", None), ("Greyscale image", "colour"),
                                      ("RGB3 image", None), ("B4 image", None)])
def test_every_cut_and_byte_flips_decode_as_pil(kind, lut):
    data = _file(kind, 7, 9, lut)
    body = len(data) - 7 * 9 * 16 + 7 * 9 * 4  # the image and a little of what follows
    decoded, raised = cuts_and_flips(data[:body], flips=60, head=120, seed=len(kind))
    assert decoded > 100 and raised > 5


@pytest.mark.parametrize("name", ["x.im", "a" * 100 + ".im", "b.IM", "overlay"])
@pytest.mark.parametrize("h,w", [(1, 1), (13, 22), (64, 65)])
def test_encode_im_is_pils_save(name, h, w, tmp_path):
    rgb = np.random.default_rng(h * w).integers(0, 256, (h, w, 3), dtype=np.uint8)
    Image.fromarray(rgb).save(tmp_path / name, "IM")
    data = encode_im(rgb, name)
    assert data == (tmp_path / name).read_bytes()
    assert pil_view(data)[1] == "RGB"
