"""DDS files through ``ifseg_torch.data.image`` against PIL 12.1's
``DdsImagePlugin``, exactly (every tolerance 0), under the JAX package's
``LOAD_TRUNCATED_IMAGES``:

  - the block formats BC1-BC5 under every FOURCC and DXGI code PIL takes
    (DXT1/3/5, BC4U, ATI1, BC5U, BC5S, ATI2; BC1-BC5 typeless and unorm,
    BC5 snorm), from random blocks (every block is a valid one) and from
    PIL's encoder, at sizes that are and are not multiples of 4;
  - the uncompressed layouts: the RGB flag's masks (8 to 48 bits, 5-6-5,
    5-5-5-1, 10-10-10-2, masks of 0), luminance and luminance-alpha, an
    RGBA palette, DX10 R8G8B8A8;
  - BC6H and BC7 files decode as PIL decodes them (their modes one by one:
    ``tests/test_torch_bc6h_bc7.py``); what PIL refuses raises
    ``ValueError``;
  - every cut and seeded byte flips: PIL's pixels, or ``ValueError`` where
    PIL raises;
  - ``encode_dds`` writes the bytes of PIL's ``save``.
"""

import io

import numpy as np
import pytest
from PIL import Image, ImageFile

import torch_image_writers as W
from ifseg_torch.data.dds import encode_dds
from ifseg_torch.data.image import image_format
from torch_pil_checks import as_pil_or_raise, cuts_and_flips, same_as_pil
import torch_port_utils  # noqa: F401,E402  (pins torch's threads under xdist)


@pytest.fixture(autouse=True)
def _truncated_images(monkeypatch):
    monkeypatch.setattr(ImageFile, "LOAD_TRUNCATED_IMAGES", True)  # the JAX package's setting


_FOURCC, _RGB, _LUMINANCE, _PAL8, _ALPHA = 0x4, 0x40, 0x20000, 0x20, 0x1
_SIZES = [(1, 1), (4, 4), (5, 7), (13, 17), (8, 12)]
# (FOURCC, DXGI code or None, bytes a block)
_BLOCKS = [(b"DXT1", None, 8), (b"DXT3", None, 16), (b"DXT5", None, 16), (b"BC4U", None, 8),
           (b"ATI1", None, 8), (b"BC5U", None, 16), (b"BC5S", None, 16), (b"ATI2", None, 16),
           (b"DX10", 70, 8), (b"DX10", 71, 8), (b"DX10", 73, 16), (b"DX10", 74, 16),
           (b"DX10", 76, 16), (b"DX10", 77, 16), (b"DX10", 79, 8), (b"DX10", 80, 8),
           (b"DX10", 82, 16), (b"DX10", 83, 16), (b"DX10", 84, 16)]


def _blocks(fourcc: bytes, dxgi, size: int, h: int, w: int, seed: int) -> bytes:
    count = ((w + 3) // 4) * ((h + 3) // 4)
    body = np.random.default_rng(seed).integers(0, 256, (count, size), dtype=np.uint8)
    body[::2, :4] = body[::2, [2, 3, 0, 1]]  # both orders of the end points
    return W.dds_file(w, h, body.tobytes(), _FOURCC, fourcc, dxgi=dxgi)


@pytest.mark.parametrize("fourcc,dxgi,size", _BLOCKS,
                         ids=[f"{f.decode()}-{d}" for f, d, _ in _BLOCKS])
def test_block_formats_equal_pil(fourcc, dxgi, size):
    for i, (h, w) in enumerate(_SIZES):
        data = _blocks(fourcc, dxgi, size, h, w, seed=i)
        assert image_format(data) == "DDS"
        same_as_pil(data, "DDS")


@pytest.mark.parametrize("pixel_format", ["DXT1", "DXT3", "DXT5", "BC2", "BC3", "BC5"])
def test_pils_encoded_blocks_equal_pil(pixel_format):
    for h, w in _SIZES:
        px = np.random.default_rng(h * w).integers(0, 256, (h, w, 4), dtype=np.uint8)
        img = Image.fromarray(px[:, :, :3]) if pixel_format == "BC5" else Image.fromarray(px)
        same_as_pil(W.pil_save(img, "DDS", pixel_format=pixel_format), "DDS")


_MASKS = {
    "bgr-24": (24, (0xFF0000, 0xFF00, 0xFF, 0), _RGB),
    "bgra-32": (32, (0xFF0000, 0xFF00, 0xFF, 0xFF000000), _RGB | _ALPHA),
    "rgbx-32": (32, (0xFF, 0xFF00, 0xFF0000, 0), _RGB),
    "565": (16, (0xF800, 0x7E0, 0x1F, 0), _RGB),
    "5551": (16, (0x7C00, 0x3E0, 0x1F, 0x8000), _RGB | _ALPHA),
    "10-10-10-2": (32, (0x3FF, 0xFFC00, 0x3FF00000, 0xC0000000), _RGB | _ALPHA),
    "332": (8, (0xE0, 0x1C, 0x3, 0), _RGB),
    "48-bit": (48, (0xFFFF, 0xFFFF0000, 0, 0), _RGB),
    "zero-masks": (32, (0, 0xFF00, 0, 0), _RGB | _ALPHA),
}


@pytest.mark.parametrize("name", list(_MASKS))
def test_rgb_masks_equal_pil(name):
    bits, masks, flags = _MASKS[name]
    for h, w in _SIZES:
        body = np.random.default_rng(h + w).integers(0, 256, h * w * bits // 8, dtype=np.uint8)
        same_as_pil(W.dds_file(w, h, body.tobytes(), flags, bits=bits, masks=masks), "DDS")


@pytest.mark.parametrize("kind", ["L", "LA", "P", "RGBA-dx10"])
def test_uncompressed_layouts_equal_pil(kind):
    rng = np.random.default_rng(len(kind))
    for h, w in _SIZES:
        body = rng.integers(0, 256, h * w * 4, dtype=np.uint8).tobytes()
        data = {"L": lambda: W.dds_file(w, h, body, _LUMINANCE, bits=8),
                "LA": lambda: W.dds_file(w, h, body, _LUMINANCE | _ALPHA, bits=16),
                "P": lambda: W.dds_file(w, h, body, _PAL8, bits=8, palette=rng.integers(
                    0, 256, 1024, dtype=np.uint8).tobytes()),
                "RGBA-dx10": lambda: W.dds_file(w, h, body, _FOURCC, b"DX10", dxgi=28)}[kind]()
        same_as_pil(data, "DDS")


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA"])
def test_pils_own_uncompressed_files_equal_pil(mode):
    px = np.random.default_rng(2).integers(0, 256, (9, 14, 4), dtype=np.uint8)
    img = Image.fromarray(px[:, :, 0] if mode == "L" else px[:, :, :len(mode)], mode)
    same_as_pil(W.pil_save(img, "DDS"), "DDS")


@pytest.mark.parametrize("dxgi,name", [(95, "BC6H"), (96, "BC6H"), (97, "BC7"), (98, "BC7"),
                                       (99, "BC7")])
def test_bc6h_and_bc7_raise_naming_them(dxgi, name):
    """Once refused by name, BC6H and BC7 blocks now decode as PIL's."""
    data = _blocks(b"DX10", dxgi, 16, 8, 8, seed=dxgi)
    assert Image.open(io.BytesIO(data)).pixel_format.startswith(name)
    same_as_pil(data, "DDS")


_REFUSED = {
    "bc4-signed": _blocks(b"BC4S", None, 8, 4, 4, 0),
    "bc1-srgb": _blocks(b"DX10", 72, 8, 4, 4, 0),
    "other-fourcc": _blocks(b"ABCD", None, 8, 4, 4, 0),
    "luminance-24": W.dds_file(2, 2, bytes(12), _LUMINANCE, bits=24),
    "no-format-flags": W.dds_file(2, 2, bytes(12), 0),
    "header-size": b"DDS " + (100).to_bytes(4, "little") + W.dds_file(2, 2, bytes(12), _RGB)[8:],
}


@pytest.mark.parametrize("name", list(_REFUSED))
def test_what_pil_refuses_raises(name):
    assert as_pil_or_raise(_REFUSED[name]) == "raised"


def _cut_files():
    return {"dxt1": _blocks(b"DXT1", None, 8, 9, 10, 1),
            "bc3-dx10": _blocks(b"DX10", 77, 16, 9, 10, 2),
            "bgr-24": W.dds_file(7, 6, bytes(range(126)), _RGB, bits=24,
                                 masks=(0xFF0000, 0xFF00, 0xFF, 0)),
            "palette": W.dds_file(7, 6, bytes(range(42)), _PAL8, bits=8, palette=bytes(1024))}


@pytest.mark.parametrize("name", list(_cut_files()))
def test_every_cut_and_byte_flips_decode_as_pil(name):
    decoded, raised = cuts_and_flips(_cut_files()[name], flips=60, head=150, seed=len(name))
    assert decoded > 20 and raised >= 128  # a header cut short is no DDS file


@pytest.mark.parametrize("h,w", [(1, 1), (13, 22), (64, 65)])
def test_encode_dds_is_pils_save(h, w, tmp_path):
    rgb = np.random.default_rng(h * w).integers(0, 256, (h, w, 3), dtype=np.uint8)
    path = tmp_path / "x.dds"
    Image.fromarray(rgb).save(path)
    assert encode_dds(rgb) == path.read_bytes()
