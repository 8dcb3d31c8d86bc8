"""TGA files through ``ifseg_torch.data.image`` against PIL 12.1's
``TgaImagePlugin``, exactly (every tolerance 0), under the JAX package's
``LOAD_TRUNCATED_IMAGES``:

  - every image type PIL opens (colour-mapped, true-colour, grey; raw and
    run-length) at every depth, in the four orientations, with an ID
    section and colour maps of 16 and 24 bits (a first index above 0), from
    ``torch_image_writers.tga_file``, and the files PIL's writer makes;
  - run-length packets: literals that run on across rows, runs that stop at
    a row's end, and a run that passes it (PIL ends the image there);
  - what PIL opens but refuses to load (a 32-bit colour map, more than 256
    entries, a grey type-1 image, 8-bit true colour) raises ``ValueError``;
  - every cut and seeded byte flips: PIL's pixels, or ``ValueError`` where
    PIL raises;
  - a raw RGB file, whose first four bytes are the cursor signature, is
    read as TGA, as PIL goes on to TGA when its cursor reader fails;
  - ``encode_tga`` writes the bytes of PIL's ``save`` for each TGA extension.
"""

import numpy as np
import pytest
from PIL import Image, ImageFile

import torch_image_writers as W
from ifseg_torch.data.image import image_format
from ifseg_torch.data.tga import EXTENSIONS, encode_tga
from torch_pil_checks import as_pil_or_raise, cuts_and_flips, same_as_pil
import torch_port_utils  # noqa: F401,E402  (pins torch's threads under xdist)


@pytest.fixture(autouse=True)
def _truncated_images(monkeypatch):
    monkeypatch.setattr(ImageFile, "LOAD_TRUNCATED_IMAGES", True)  # the JAX package's setting


def _body(kind: int, depth: int, h: int, w: int, rle: bool, seed: int, per_row: bool = False):
    """Pixel bytes with runs, raw or as run-length packets."""
    rng = np.random.default_rng(seed)
    bpp = max(1, depth // 8)
    stride = (w * depth + 7) // 8
    if not rle:
        return rng.integers(0, 256, h * stride, dtype=np.uint8).tobytes()
    px = rng.integers(0, 256, (h * w, bpp), dtype=np.uint8)
    px[1::3] = px[::3][:len(px[1::3])]
    px[len(px) // 2:len(px) // 2 + 5] = px[0]
    return W.tga_rle(px.tobytes(), bpp, w if per_row else None)


_LAYOUTS = [(1, 8), (2, 16), (2, 24), (2, 32), (3, 1), (3, 8), (3, 16)]


@pytest.mark.parametrize("flags", [0x00, 0x10, 0x20, 0x30])
@pytest.mark.parametrize("rle", [False, True], ids=["raw", "rle"])
@pytest.mark.parametrize("kind,depth", _LAYOUTS, ids=[f"{k}-{d}" for k, d in _LAYOUTS])
def test_each_layout_and_orientation_equals_pil(kind, depth, rle, flags):
    for i, (h, w) in enumerate([(1, 1), (5, 7), (13, 17)]):
        body = _body(kind, depth, h, w, rle, seed=h * w + flags, per_row=i == 2)
        cmap = bytes(range(0, 240, 3)) if kind == 1 else None
        data = W.tga_file(body, w, h, kind | (8 if rle else 0), depth, flags,
                          id_section=b"an id" if i == 1 else b"", colour_map=cmap, map_start=i)
        assert image_format(data) == "TGA"
        same_as_pil(data, "TGA")


@pytest.mark.parametrize("map_depth", [16, 24])
@pytest.mark.parametrize("start,size", [(0, 1), (0, 256), (3, 200), (255, 1)])
def test_colour_maps_equal_pil(map_depth, start, size):
    entry = map_depth // 8
    cmap = np.random.default_rng(size).integers(0, 256, size * entry, dtype=np.uint8).tobytes()
    body = np.arange(70, dtype=np.uint8).tobytes()
    same_as_pil(W.tga_file(body, 10, 7, 1, 8, 0x20, colour_map=cmap, map_start=start,
                           map_depth=map_depth), "TGA")


@pytest.mark.parametrize("mode", ["1", "L", "LA", "P", "RGB", "RGBA"])
@pytest.mark.parametrize("rle", [False, True], ids=["raw", "rle"])
def test_pils_own_files_equal_pil(mode, rle):
    px = np.random.default_rng(3).integers(0, 256, (23, 31, 4), dtype=np.uint8)
    px[5:9] = px[5, 0]
    img = {"1": Image.fromarray(px[:, :, 0] > 99), "L": Image.fromarray(px[:, :, 0]),
           "LA": Image.fromarray(px[:, :, :2], "LA"),
           "P": Image.fromarray(px[:, :, :3]).quantize(40),
           "RGB": Image.fromarray(px[:, :, :3]), "RGBA": Image.fromarray(px, "RGBA")}[mode]
    same_as_pil(W.pil_save(img, "TGA", rle=rle), "TGA")


_PACKETS = {
    "literal-across-rows": bytes([5, 1, 2, 3, 4, 5, 6, 5, 7, 8, 9, 10, 11, 12]),
    "literal-of-three-rows": bytes([11]) + bytes(range(1, 13)),
    "run-to-the-row-end": bytes([0x83, 9, 0x83, 7, 0x83, 5]),
    "run-across-a-row": bytes([0x81, 9, 0x85, 7, 0x83, 5]),
    "run-after-a-whole-row": bytes([0x83, 9, 0x85, 7, 0x81, 5]),
    "short-stream": bytes([0x83, 9, 2, 1]),
}


@pytest.mark.parametrize("name", list(_PACKETS))
def test_run_length_packets_equal_pil(name):
    same_as_pil(W.tga_file(_PACKETS[name], 4, 3, 11, 8, 0x20), "TGA")


_REFUSED = {
    "32-bit-map": W.tga_file(bytes(4), 2, 2, 1, 8, 0, colour_map=bytes(16), map_depth=32),
    "257-entries": W.tga_file(bytes(4), 2, 2, 1, 8, 0, colour_map=bytes(3 * 257)),
    "map-past-256": W.tga_file(bytes(4), 2, 2, 1, 8, 0, colour_map=bytes(3 * 250), map_start=10),
    "grey-type-1": W.tga_file(bytes(4), 2, 2, 1, 8, 0),
    "8-bit-true-colour": W.tga_file(bytes(4), 2, 2, 2, 8, 0),
    "15-bit-map-type-9": W.tga_file(bytes(8), 2, 2, 9, 16, 0, colour_map=bytes(6)),
}


@pytest.mark.parametrize("name", list(_REFUSED))
def test_what_pil_refuses_raises(name):
    assert as_pil_or_raise(_REFUSED[name]) == "raised"


def _cut_files():
    return {
        "raw-rgb": W.tga_file(_body(2, 24, 9, 11, False, 1), 11, 9, 2, 24),
        "rle-rgba-top-down": W.tga_file(_body(2, 32, 9, 11, True, 2), 11, 9, 10, 32, 0x28),
        "rle-mapped": W.tga_file(_body(1, 8, 9, 11, True, 3, per_row=True), 11, 9, 9, 8, 0x30,
                                 colour_map=bytes(range(60)), map_depth=24),
        "raw-15-bit": W.tga_file(_body(2, 16, 6, 7, False, 4), 7, 6, 2, 16, 0x10),
    }


@pytest.mark.parametrize("name", list(_cut_files()))
def test_every_cut_and_byte_flips_decode_as_pil(name):
    decoded, raised = cuts_and_flips(_cut_files()[name], head=40, seed=len(name))
    assert decoded > 100 and raised >= 18  # a header cut short is no TGA file


def test_a_cursor_signature_is_read_as_tga():
    data = encode_tga(np.full((3, 4, 3), 7, np.uint8))
    assert data[:4] == b"\x00\x00\x02\x00"  # the cursor signature, with no cursor
    assert image_format(data) == "TGA"
    same_as_pil(data, "TGA")


@pytest.mark.parametrize("ext", EXTENSIONS)
@pytest.mark.parametrize("h,w", [(1, 1), (13, 22), (64, 65)])
def test_encode_tga_is_pils_save(ext, h, w, tmp_path):
    rgb = np.random.default_rng(h * w).integers(0, 256, (h, w, 3), dtype=np.uint8)
    path = tmp_path / f"x{ext}"
    Image.fromarray(rgb).save(path)
    assert encode_tga(rgb) == path.read_bytes()
