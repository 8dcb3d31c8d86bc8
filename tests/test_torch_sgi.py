"""SGI files through ``ifseg_torch.data.image`` against PIL 12.1's
``SgiImagePlugin``, exactly (every tolerance 0), under the JAX package's
``LOAD_TRUNCATED_IMAGES``:

  - 1, 3 and 4 channels at 8 and 16 bits (PIL's 8-bit modes, each 16-bit
    sample's high byte), raw and run-length coded, from
    ``torch_image_writers.sgi_file`` and PIL's writer, dimensions 1 to 3;
  - run-length rows PIL's decoder takes in its own way: a row that stops
    short keeps the last row's samples, a length that runs out on a live
    packet ends the image, an overrun ends it, a table that does not fit
    leaves it 0, a length of 2^31 or more is no packet;
  - what PIL refuses (2 channels, 3 bytes a sample, a cut 16-bit raw file)
    raises ``ValueError``;
  - every cut and seeded byte flips: PIL's pixels, or ``ValueError`` where
    PIL raises;
  - ``encode_sgi`` writes the bytes of PIL's ``save`` for each SGI extension,
    the file's name in the header.
"""

import struct

import numpy as np
import pytest
from PIL import Image, ImageFile

import torch_image_writers as W
from ifseg_torch.data.image import image_format
from ifseg_torch.data.sgi import EXTENSIONS, encode_sgi
from torch_pil_checks import as_pil_or_raise, cuts_and_flips, same_as_pil
import torch_port_utils  # noqa: F401,E402  (pins torch's threads under xdist)


@pytest.fixture(autouse=True)
def _truncated_images(monkeypatch):
    monkeypatch.setattr(ImageFile, "LOAD_TRUNCATED_IMAGES", True)  # the JAX package's setting


def _planes(z: int, h: int, w: int, bpc: int, seed: int):
    rng = np.random.default_rng(seed)
    planes = rng.integers(0, 256 if bpc == 1 else 65536, (z, h, w))
    planes[:, :, 2:6] = planes[:, :, 2:3]  # runs
    return planes.astype(np.uint8 if bpc == 1 else np.uint16)


@pytest.mark.parametrize("rle", [False, True], ids=["raw", "rle"])
@pytest.mark.parametrize("bpc", [1, 2])
@pytest.mark.parametrize("z", [1, 3, 4])
def test_each_layout_equals_pil(z, bpc, rle):
    for h, w in [(1, 1), (1, 9), (5, 7), (13, 17), (3, 200)]:
        data = W.sgi_file(_planes(z, h, w, bpc, seed=h * w), rle=rle)
        assert image_format(data) == "SGI"
        same_as_pil(data, "SGI")


@pytest.mark.parametrize("dimension", [1, 2])
def test_grey_dimensions_equal_pil(dimension):
    same_as_pil(W.sgi_file(_planes(1, 4, 6, 1, 2), dimension=dimension), "SGI")


@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA"])
@pytest.mark.parametrize("bpc", [1, 2])
def test_pils_own_files_equal_pil(mode, bpc):
    px = np.random.default_rng(4).integers(0, 256, (11, 23, 4), dtype=np.uint8)
    img = Image.fromarray(px[:, :, :len(mode)] if mode != "L" else px[:, :, 0], mode)
    same_as_pil(W.pil_save(img, "SGI", bpc=bpc), "SGI")


def _rle_file(rows, bpc=1, lengths=None, z=1, h=None, w=4):
    """An SGI RLE file of hand-made rows (one channel), the tables' lengths
    overridable."""
    h = h or len(rows)
    starts, at = [], 512 + 8 * z * h
    for r in rows:
        starts.append(at)
        at += len(r)
    lengths = lengths or [len(r) for r in rows]
    head = struct.pack(">hBBHHHHll4s79ssl404s", 474, 1, bpc, 2, w, h, z, 0, 255, b"", b"", b"",
                       0, b"")
    return (head + struct.pack(f">{h}I", *starts) + struct.pack(f">{h}I", *lengths)
            + b"".join(rows))


_ROWS = {
    "short-row-keeps-the-last": [bytes([0x84, 1, 2, 3, 4, 0]), bytes([0x82, 9, 8, 0])],
    "no-end-marker": [bytes([0x84, 1, 2, 3, 4]), bytes([0x84, 5, 6, 7, 8, 0])],
    "overrun": [bytes([0x84, 1, 2, 3, 4, 0]), bytes([0x85, 1, 2, 3, 4, 5, 0])],
    "run-packets": [bytes([0x02, 7, 0x02, 9, 0]), bytes([0x04, 3, 0])],
    "zero-length": [bytes([0x84, 1, 2, 3, 4, 0]), bytes([0x84, 5, 6, 7, 8, 0])],
}


@pytest.mark.parametrize("name", list(_ROWS))
def test_rle_rows_decode_as_pil(name):
    lengths = [6, 0] if name == "zero-length" else None
    same_as_pil(_rle_file(_ROWS[name], lengths=lengths), "SGI")


def test_a_huge_row_length_is_no_packet():
    rows = [bytes([0x84, 1, 2, 3, 4, 0]), bytes([0x84, 5, 6, 7, 8, 0])]
    same_as_pil(_rle_file(rows, lengths=[6, 0x80000006]), "SGI")


_REFUSED = {
    "two-channels": W.sgi_file(_planes(2, 3, 4, 1, 1)),
    "three-bytes-a-sample": b"\x01\xda\x00\x03" + W.sgi_file(_planes(1, 3, 4, 1, 1))[4:],
    "cut-16-bit-raw": W.sgi_file(_planes(3, 5, 6, 2, 1))[:600],
}


@pytest.mark.parametrize("name", list(_REFUSED))
def test_what_pil_refuses_raises(name):
    assert as_pil_or_raise(_REFUSED[name]) == "raised"


def _cut_files():
    return {"raw-rgb": W.sgi_file(_planes(3, 6, 7, 1, 5)),
            "rle-rgba": W.sgi_file(_planes(4, 6, 7, 1, 6), rle=True),
            "rle-16-bit-grey": W.sgi_file(_planes(1, 6, 7, 2, 7), rle=True)}


@pytest.mark.parametrize("name", list(_cut_files()))
def test_every_cut_and_byte_flips_decode_as_pil(name):
    data = _cut_files()[name]
    decoded, raised = cuts_and_flips(data, flips=80, seed=len(name))
    assert decoded > 80 and raised >= 2


@pytest.mark.parametrize("ext", EXTENSIONS)
@pytest.mark.parametrize("h,w", [(1, 1), (13, 22), (64, 65)])
def test_encode_sgi_is_pils_save(ext, h, w, tmp_path):
    rgb = np.random.default_rng(h * w).integers(0, 256, (h, w, 3), dtype=np.uint8)
    name = "overlay-" + "x" * (h + w) + ext
    Image.fromarray(rgb).save(tmp_path / name)
    assert encode_sgi(rgb, name) == (tmp_path / name).read_bytes()
