"""PCX and DCX files through ``ifseg_torch.data.image`` against PIL 12.1's
``PcxImagePlugin`` and ``DcxImagePlugin``, exactly (every tolerance 0),
under the JAX package's ``LOAD_TRUNCATED_IMAGES``:

  - 1 bit on 1, 2 and 4 planes, 8 bits on 1 plane (grey, or a palette at
    the file's end) and on 3 planes, at odd and even widths, with the
    header's stride as computed or another (PIL then pads it to even and
    moves the planes of each row together), runs kept in their rows or
    running on across them (PIL cuts them at the row's end), from
    ``torch_image_writers.pcx_file`` and PIL's writer; the first frame of a
    DCX file of them;
  - the layouts PIL refuses raise ``ValueError``;
  - every cut and seeded byte flips: PIL's pixels, or ``ValueError`` where
    PIL raises;
  - ``encode_pcx`` writes the bytes of PIL's ``save`` (a row of one byte a
    plane loses its last plane, as in PIL's encoder).
"""

import numpy as np
import pytest
from PIL import Image, ImageFile

import torch_image_writers as W
from ifseg_torch.data.image import image_format
from ifseg_torch.data.pcx import encode_pcx
from torch_pil_checks import as_pil_or_raise, cuts_and_flips, same_as_pil
import torch_port_utils  # noqa: F401,E402  (pins torch's threads under xdist)


@pytest.fixture(autouse=True)
def _truncated_images(monkeypatch):
    monkeypatch.setattr(ImageFile, "LOAD_TRUNCATED_IMAGES", True)  # the JAX package's setting


_GREY = bytes(np.repeat(np.arange(256, dtype=np.uint8), 3))


def _file(bits, planes, h, w, pad, across, palette=None, version=5, seed=0):
    rng = np.random.default_rng(seed)
    stride = (w * bits + 7) // 8
    row = stride + (stride % 2 if pad else 0)
    rows = rng.integers(0, 256, (h, planes * row), dtype=np.uint8)
    rows[:, 1:4] = rows[:, 1:2]
    rows[:, 6:] = rows[:, 6:7] & 0xF0
    data = W.pcx_file(W.pcx_rle(rows, across=across), w, h, bits, planes, stride + pad, version,
                      header_palette=rng.integers(0, 256, 48, dtype=np.uint8).tobytes(),
                      palette=palette)
    return data + (bytes(800) if (bits, planes, palette) == (8, 1, None) else b"")


_LAYOUTS = [(1, 1), (1, 2), (1, 4), (8, 1), (8, 3)]


@pytest.mark.parametrize("across", [False, True], ids=["in-rows", "across-rows"])
@pytest.mark.parametrize("pad", [0, 1], ids=["stride", "other-stride"])
@pytest.mark.parametrize("bits,planes", _LAYOUTS, ids=[f"{b}x{p}" for b, p in _LAYOUTS])
def test_each_layout_equals_pil(bits, planes, pad, across):
    for h, w in [(1, 1), (3, 3), (5, 7), (4, 16), (6, 40)]:
        data = _file(bits, planes, h, w, pad, across, seed=h * w)
        assert image_format(data) == "PCX"
        same_as_pil(data, "PCX")


@pytest.mark.parametrize("palette", ["grey", "colour"])
def test_8_bit_palettes_equal_pil(palette):
    table = _GREY if palette == "grey" else bytes(range(256)) * 3
    same_as_pil(_file(8, 1, 9, 13, 0, False, palette=table), "PCX")


@pytest.mark.parametrize("mode", ["1", "L", "P", "RGB"])
@pytest.mark.parametrize("w", [1, 2, 9, 64])
def test_pils_own_files_equal_pil(mode, w):
    px = np.random.default_rng(w).integers(0, 256, (7, w, 3), dtype=np.uint8)
    img = {"1": Image.fromarray(px[:, :, 0] > 99), "L": Image.fromarray(px[:, :, 0]),
           "P": Image.fromarray(px).quantize(20), "RGB": Image.fromarray(px)}[mode]
    same_as_pil(W.pil_save(img, "PCX"), "PCX")


@pytest.mark.parametrize("bits,planes", _LAYOUTS, ids=[f"{b}x{p}" for b, p in _LAYOUTS])
def test_the_first_frame_of_a_dcx_file_equals_pil(bits, planes):
    frames = [_file(bits, planes, 5, 9, 0, False, seed=s) for s in (1, 2)]
    data = W.dcx_file(frames)
    assert image_format(data) == "DCX"
    same_as_pil(data, "DCX")


_REFUSED = {
    "2-bit": _file(2, 1, 3, 4, 0, False),
    "8-bit-2-planes": _file(8, 2, 3, 4, 0, False),
    "version-2-8-bit": _file(8, 1, 3, 4, 0, False, version=2),
    "1-bit-3-planes": _file(1, 3, 3, 4, 0, False),
    "empty-window": b"\x0a\x05\x01\x08\x09\x00" + _file(8, 3, 3, 4, 0, False)[6:],
    "dcx-without-frames": W.dcx_file([]),
}


@pytest.mark.parametrize("name", list(_REFUSED))
def test_what_pil_refuses_raises(name):
    assert as_pil_or_raise(_REFUSED[name]) == "raised"


@pytest.mark.parametrize("bits,planes", _LAYOUTS, ids=[f"{b}x{p}" for b, p in _LAYOUTS])
def test_every_cut_and_byte_flips_decode_as_pil(bits, planes):
    data = _file(bits, planes, 6, 11, 1, True, seed=bits * planes)
    decoded, raised = cuts_and_flips(data[:900], flips=60, head=130, seed=planes)
    assert decoded > 40 and raised >= 68  # a header cut short is no PCX file


@pytest.mark.parametrize("h,w", [(1, 1), (1, 2), (13, 22), (64, 65), (3, 200)])
def test_encode_pcx_is_pils_save(h, w, tmp_path):
    rgb = np.random.default_rng(h * w).integers(0, 256, (h, w, 3), dtype=np.uint8)
    rgb[:, 5:140] = 200  # runs longer than 63
    path = tmp_path / "x.pcx"
    Image.fromarray(rgb).save(path)
    assert encode_pcx(rgb) == path.read_bytes()
