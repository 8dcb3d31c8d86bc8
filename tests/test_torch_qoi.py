"""QOI files through ``ifseg_torch.data.image`` against PIL 12.1's
``QoiImagePlugin``, exactly (every tolerance 0), under the JAX package's
``LOAD_TRUNCATED_IMAGES``:

  - RGB and RGBA images through every op (RGB, RGBA, index, diff, luma,
    run), from ``torch_image_writers.qoi_file`` (the format's reference
    encoder, whose index table starts empty) and PIL's writer; a header
    channel count other than 3 or 4 (PIL reads "RGBA");
  - an index op into an entry never set (PIL reads (0, 0, 0, 0)), a run
    past the last pixel, trailing bytes;
  - every cut and seeded byte flips: PIL's pixels, or ``ValueError`` where
    PIL raises (a stream that ends early);
  - ``encode_qoi`` writes the bytes of PIL's ``save``.
"""

import numpy as np
import pytest
from PIL import Image, ImageFile

import torch_image_writers as W
from ifseg_torch.data.image import image_format
from ifseg_torch.data.qoi import encode_qoi
from torch_pil_checks import as_pil_or_raise, cuts_and_flips, same_as_pil
import torch_port_utils  # noqa: F401,E402  (pins torch's threads under xdist)


@pytest.fixture(autouse=True)
def _truncated_images(monkeypatch):
    monkeypatch.setattr(ImageFile, "LOAD_TRUNCATED_IMAGES", True)  # the JAX package's setting


def _pixels(h: int, w: int, bands: int, seed: int):
    """Random pixels, small steps (diff and luma ops), runs, repeats (index
    ops) and, with alpha, alpha changes (RGBA ops)."""
    rng = np.random.default_rng(seed)
    px = rng.integers(0, 256, (h, w, bands), dtype=np.uint8)
    if w > 4:
        px[:, 4:] = px[:, 4:5] + rng.integers(-2, 2, (h, w - 4, bands)).astype(np.uint8)
        px[:, 1::5] = px[:, 0:1]
    px[h // 2:] = px[0, 0]
    if bands == 4:
        px[::3, ::2, 3] = 255
    return px


@pytest.mark.parametrize("writer", ["reference", "pil"])
@pytest.mark.parametrize("bands", [3, 4])
@pytest.mark.parametrize("h,w", [(1, 1), (5, 7), (13, 17), (40, 90)])
def test_every_op_equals_pil(h, w, bands, writer):
    px = _pixels(h, w, bands, seed=h * w + bands)
    data = W.qoi_file(px) if writer == "reference" else W.pil_save(Image.fromarray(px), "QOI")
    assert image_format(data) == "QOI"
    same_as_pil(data, "QOI")


@pytest.mark.parametrize("channels", [0, 1, 2, 5, 255])
def test_other_channel_counts_read_as_rgba(channels):
    same_as_pil(W.qoi_file(_pixels(6, 7, 4, channels), channels=channels), "QOI")


_STREAMS = {
    "index-never-set": b"\x05\x3f" + b"\xc3" * 3,
    "run-past-the-end": b"\xfe\x01\x02\x03\xfd\xfd",
    "trailing-bytes": b"\xfe\x01\x02\x03\xc8" + bytes(30),
    "rgba-then-diff": b"\xff\x10\x20\x30\x40\x7f\x40\x95\x88\xc5",
}


@pytest.mark.parametrize("name", list(_STREAMS))
def test_op_streams_decode_as_pil(name):
    head = b"qoif" + (3).to_bytes(4, "big") + (3).to_bytes(4, "big") + bytes([4, 0])
    assert as_pil_or_raise(head + _STREAMS[name] + b"\0" * 7 + b"\1") == "decoded"


@pytest.mark.parametrize("bands", [3, 4])
def test_every_cut_and_byte_flips_decode_as_pil(bands):
    data = W.qoi_file(_pixels(7, 9, bands, 11 * bands))
    decoded, raised = cuts_and_flips(data, flips=120, seed=bands)
    assert decoded > 10 and raised > 20  # a stream cut before its last pixel raises


@pytest.mark.parametrize("h,w", [(1, 1), (13, 22), (64, 65), (30, 300)])
def test_encode_qoi_is_pils_save(h, w, tmp_path):
    rgb = _pixels(h, w, 3, h + w)
    rgb[0, 0] = 0
    path = tmp_path / "x.qoi"
    Image.fromarray(rgb).save(path)
    assert encode_qoi(rgb) == path.read_bytes()
