"""``tests/torch_writer_digests.json``, which ``chip_smoke.py`` phase 14e
holds the port to on the card's machine (no PIL, no cv2 there): recomputed
with PIL and cv2 (``tools/make_writer_digests.py``), and the port's decodes
equal to it here:

  - the small TGA, SGI, QOI, PCX, DCX, IM, DDS (each BC6H and BC7 mode
    too), DIB, FTEX, BLP, ICNS, SUN, MSP, XBM, XPM, GBR, PIXAR, XVThumb,
    McIdas, IMT, SPIDER and FITS files and the PFM row of
    ``torch_image_writers.raw_format_files()``: PIL's format, mode, shape
    and digests of the pixels and the RGB;
  - the JPEGs whose dequantized coefficients pass 16 bits
    (``chip_smoke.overflow_jpegs()``): the port's default IDCT gives PIL's
    SIMD digest, its C IDCT PIL's digest under ``JSIMD_FORCENONE=1``
    (ROADMAP C.15);
  - the PFM row's float32 resizes (``chip_smoke.pfm_resizes``): cv2's
    digests (ROADMAP C.16).
"""

import json
import sys
from pathlib import Path

import pytest

import chip_smoke
import torch_image_writers as W
from ifseg_torch.data import image
from ifseg_torch.data.jpeg import decode_jpeg, idct_variant
import torch_port_utils  # noqa: F401,E402  (pins torch's threads under xdist)

REPO = Path(__file__).resolve().parents[1]
TABLE = json.loads(chip_smoke.WRITER_DIGESTS.read_text())


def test_the_table_is_pils_and_cv2s():
    sys.path.insert(0, str(REPO / "tools"))
    import make_writer_digests

    assert make_writer_digests.digests() == TABLE


@pytest.mark.parametrize("name", sorted(TABLE["files"]))
def test_the_port_decodes_each_file_to_its_digests(name):
    data = W.raw_format_files()[name]
    want = TABLE["files"][name]
    pixels, mode, _ = image.decode_image(data)
    assert image.image_format(data).replace("Netpbm", "PPM") == want["format"]
    assert (mode, list(pixels.shape)) == (want["mode"], want["shape"])
    assert image.image_digest(pixels) == want["pixels"]
    assert image.image_digest(image.decode_image_rgb(data)) == want["rgb"]


@pytest.mark.parametrize("name", sorted(TABLE["jpeg_overflow"]))
def test_overflowing_jpegs_decode_to_each_idcts_digest(name):
    data = chip_smoke.overflow_jpegs()[name]
    want = TABLE["jpeg_overflow"][name]
    was = idct_variant()
    try:
        assert image.image_digest(decode_jpeg(data)) == want["simd"]
        idct_variant("c")
        assert image.image_digest(decode_jpeg(data)) == want["c"]
    finally:
        idct_variant(was)


def test_the_pfm_row_resizes_to_cv2s_digests():
    got = chip_smoke.pfm_resizes(W.raw_format_files()["pfm_row.pfm"])
    assert {k: image.image_digest(v) for k, v in got.items()} == TABLE["pfm_resize"]
