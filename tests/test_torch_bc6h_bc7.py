"""DDS's BC6H and BC7 blocks through ``ifseg_torch.data.image`` against PIL
12.1's ``BcnDecode.c``, exactly (every tolerance 0), under the JAX
package's ``LOAD_TRUNCATED_IMAGES``:

  - BC7 (DXGI 98), each of its 8 modes: 2,000 seeded blocks of random bits
    with the mode's bit set, and blocks whose byte 0 is 0 (no mode);
  - BC6H unsigned (DXGI 95) and signed (96), each of its 14 modes: 2,000
    seeded blocks whose end points mostly decode to half floats strictly
    between 0 and 1 (``torch_image_writers.bc6h_blocks``), so that the
    float to 8-bit step is exercised rather than clamped (most pixels
    strictly between 0 and 255, asserted), then 500 blocks of random bits
    (negative and out-of-range end points, clamps), and the reserved modes;
  - BC7 typeless (97) and sRGB (98, 99) give the same pixels; sizes that
    are not multiples of 4; files cut mid-block keep their whole blocks.
"""

import io

import numpy as np
import pytest
from PIL import Image, ImageFile

import torch_image_writers as W
from ifseg_torch.data.image import decode_image, image_format
from torch_pil_checks import as_pil_or_raise, same_as_pil
import torch_port_utils  # noqa: F401,E402  (pins torch's threads under xdist)


@pytest.fixture(autouse=True)
def _truncated_images(monkeypatch):
    monkeypatch.setattr(ImageFile, "LOAD_TRUNCATED_IMAGES", True)  # the JAX package's setting


def _dds(blocks: np.ndarray, dxgi: int, w: int, h: int) -> bytes:
    return W.dds_file(w, h, np.ascontiguousarray(blocks).tobytes(), 0x4, b"DX10", dxgi=dxgi)


def _equal_by_block(blocks: np.ndarray, dxgi: int):
    """PIL's and the port's pixels of ``blocks`` laid out 40 blocks a row:
    the count of blocks that differ, and PIL's pixels."""
    n = len(blocks)
    data = _dds(blocks, dxgi, 160, 4 * (n // 40))
    assert image_format(data) == "DDS"
    want = np.asarray(Image.open(io.BytesIO(data)))
    got, mode, _ = decode_image(data)
    assert mode == Image.open(io.BytesIO(data)).mode and got.shape == want.shape
    bad = (got != want).reshape(n // 40, 4, 40, 4, -1).any(axis=(1, 3, 4))
    return int(bad.sum()), want


@pytest.mark.parametrize("mode", range(8))
def test_bc7_mode_equals_pil(mode):
    blocks = W.bc7_blocks(mode, 2000, np.random.default_rng(700 + mode))
    bad, want = _equal_by_block(blocks, 98)
    assert bad == 0
    assert want.shape[2] == 4


def test_bc7_block_without_a_mode_equals_pil():
    bad, want = _equal_by_block(W.bc7_blocks(8, 40, np.random.default_rng(7)), 98)
    assert bad == 0 and (want == [0, 0, 0, 255]).all()


@pytest.mark.parametrize("signed", [False, True], ids=["uf16", "sf16"])
@pytest.mark.parametrize("mode", range(14))
def test_bc6h_mode_equals_pil(mode, signed):
    dxgi = 96 if signed else 95
    rng = np.random.default_rng(600 + 20 * signed + mode)
    bad, want = _equal_by_block(W.bc6h_blocks(mode, 2000, rng, signed), dxgi)
    assert bad == 0
    assert ((want > 0) & (want < 255)).mean() > 0.8  # the half floats' 8 bits, not clamps
    # random bits: negative and large end points, the clamps
    blocks = rng.integers(0, 256, (520, 16), dtype=np.uint8)
    code, bits = W.BC6H_MODE_BITS[mode], 2 if mode < 2 else 5
    blocks[:, 0] = (blocks[:, 0] & (0xFF << bits & 0xFF)) | code
    assert _equal_by_block(blocks, dxgi)[0] == 0


@pytest.mark.parametrize("dxgi", [95, 96])
@pytest.mark.parametrize("reserved", range(4))
def test_bc6h_reserved_modes_equal_pil(reserved, dxgi):
    bad, want = _equal_by_block(W.bc6h_blocks(14 + reserved, 40, np.random.default_rng(9)),
                                dxgi)
    assert bad == 0 and not want.any()


@pytest.mark.parametrize("dxgi", [97, 98, 99])
@pytest.mark.parametrize("h,w", [(1, 1), (5, 7), (13, 17), (8, 12)])
def test_bc7_variants_and_odd_sizes_equal_pil(dxgi, h, w):
    n = ((w + 3) // 4) * ((h + 3) // 4)
    rng = np.random.default_rng(h * w)
    blocks = np.concatenate([W.bc7_blocks(m, n, rng) for m in range(8)])[rng.permutation(8 * n)]
    data = _dds(blocks[:n], dxgi, w, h)
    same_as_pil(data, "DDS")
    assert (decode_image(data)[0] == decode_image(_dds(blocks[:n], 98, w, h))[0]).all()


@pytest.mark.parametrize("dxgi", [95, 96])
@pytest.mark.parametrize("h,w", [(1, 1), (5, 7), (13, 17)])
def test_bc6h_odd_sizes_equal_pil(dxgi, h, w):
    n = ((w + 3) // 4) * ((h + 3) // 4)
    rng = np.random.default_rng(h + w)
    blocks = np.concatenate([W.bc6h_blocks(m, n, rng, dxgi == 96) for m in range(14)])
    same_as_pil(_dds(blocks[rng.permutation(14 * n)[:n]], dxgi, w, h), "DDS")


@pytest.mark.parametrize("dxgi", [95, 96, 98])
def test_cuts_keep_whole_blocks_as_pil(dxgi):
    """Every cut inside the blocks of a 9 x 10 file (whole blocks kept,
    the rest 0) and every cut of its headers (raise where PIL raises)."""
    rng = np.random.default_rng(dxgi)
    blocks = (np.concatenate([W.bc7_blocks(m, 2, rng) for m in range(6)]) if dxgi == 98 else
              np.concatenate([W.bc6h_blocks(m, 1, rng, dxgi == 96) for m in range(12)]))[:9]
    data = _dds(blocks, dxgi, 10, 9)
    seen = [as_pil_or_raise(data[:cut]) for cut in range(len(data) + 1)]
    assert seen[148:] == ["decoded"] * (len(data) - 147) and seen.count("raised") >= 128


@pytest.mark.parametrize("h,w", [(13, 19), (32, 45)])
def test_full_size_block_writers_decode_as_pil(h, w):
    """``torch_image_writers.full_size_block_files`` (what ``chip_smoke.py``
    writes at 1,024 x 1,366 on the card's machine, which has no PIL): each
    file's pixels and RGB as written are PIL's, and the port's."""
    rgb = np.random.default_rng(h * w).integers(0, 256, (h, w, 3), dtype=np.uint8)
    for name, (data, (pixels, mode), want_rgb) in W.full_size_block_files(rgb).items():
        im = Image.open(io.BytesIO(data))
        assert im.mode == mode, name
        np.testing.assert_array_equal(np.asarray(im), pixels, err_msg=name)
        np.testing.assert_array_equal(np.asarray(im.convert("RGB")), want_rgb, err_msg=name)
        same_as_pil(data)
