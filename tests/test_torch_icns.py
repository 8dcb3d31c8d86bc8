"""ICNS files through ``ifseg_torch.data.image`` against PIL 12.1's
``IcnsImagePlugin``, exactly (every tolerance 0), under the JAX package's
``LOAD_TRUNCATED_IMAGES``:

  - PIL's own files (PNG entries of every size up to 1,024, RGBA and RGB)
    and hand-made ones: PNG entries of other modes, JPEG 2000 entries
    (codestream and JP2, converted to "RGBA"), legacy it32 / ih32 / il32 /
    is32 run-length and raw planes with and without their t8mk / h8mk /
    l8mk / s8mk masks, PIL's choice of the largest size;
  - ``np.asarray`` of PIL's ICNS image packs it in the mode ``_open``
    gave (RGBA): an "RGB" image comes as its four-byte pixels' memory read
    as three-byte ones, and the other modes raise, while ``convert("RGB")``
    is the true colours;
  - every cut and seeded byte flips: PIL's pixels, or ``ValueError`` where
    PIL raises.
"""

import io

import numpy as np
import pytest
from PIL import Image, ImageFile

import torch_image_writers as W
from ifseg_torch.data.image import decode_image, decode_image_rgb, image_format
from torch_pil_checks import as_pil_or_raise, cuts_and_flips, same_as_pil
import torch_port_utils  # noqa: F401,E402  (pins torch's threads under xdist)


@pytest.fixture(autouse=True)
def _truncated_images(monkeypatch):
    monkeypatch.setattr(ImageFile, "LOAD_TRUNCATED_IMAGES", True)  # the JAX package's setting


def _smooth(rng, n, c=4):
    base = rng.integers(0, 256, (n // 4 + 1, n // 4 + 1, c), dtype=np.uint8)
    return np.repeat(np.repeat(base, 4, 0), 4, 1)[:n, :n]


def _planes(rgb, rle=True):
    if not rle:
        return np.ascontiguousarray(rgb).tobytes()
    return b"".join(W.icns_rle(np.ascontiguousarray(rgb[:, :, c]).tobytes()) for c in range(3))


@pytest.mark.parametrize("mode", ["RGBA", "RGB"])
def test_pils_own_files_equal_pil(mode):
    img = Image.fromarray(_smooth(np.random.default_rng(1), 64)).convert(mode)
    data = W.pil_save(img, "ICNS")
    assert image_format(data) == "ICNS"
    same_as_pil(data, "ICNS")


_LEGACY = {"it32": (128, b"t8mk"), "ih32": (48, b"h8mk"), "il32": (32, b"l8mk"),
           "is32": (16, b"s8mk")}


@pytest.mark.parametrize("kind", list(_LEGACY))
@pytest.mark.parametrize("rle", [True, False], ids=["rle", "raw"])
@pytest.mark.parametrize("mask", [True, False], ids=["mask", "no-mask"])
def test_legacy_planes_equal_pil(kind, rle, mask):
    n, mask_kind = _LEGACY[kind]
    px = _smooth(np.random.default_rng(n), n)
    payload = (b"\0\0\0\0" if kind == "it32" else b"") + _planes(px[:, :, :3], rle)
    blocks = [(kind.encode(), payload)] + ([(mask_kind, px[:, :, 3].tobytes())] if mask else [])
    data = W.icns_file(blocks)
    same_as_pil(data, "ICNS")
    if not mask:  # the true colours only through convert("RGB")
        assert (decode_image_rgb(data) == px[:, :, :3]).all()
        assert not (decode_image(data)[0] == px[:, :, :3]).all()


@pytest.mark.parametrize("mode", ["RGBA", "RGB", "LA", "L", "P", "1"])
def test_png_entries_of_each_mode(mode):
    """An "RGBA" or "RGB" entry decodes as PIL's array; the other modes
    raise in ``np.asarray`` there and here, their RGB PIL's."""
    img = Image.fromarray(_smooth(np.random.default_rng(2), 32)).convert(mode)
    data = W.icns_file([(b"ic12", W.pil_save(img, "PNG")), (b"is32", _planes(
        _smooth(np.random.default_rng(3), 16)))])
    assert as_pil_or_raise(data) == ("decoded" if mode in ("RGBA", "RGB") else "raised")
    rgb = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    assert (decode_image_rgb(data) == rgb).all()


@pytest.mark.parametrize("form", ["j2k", "jp2"])
@pytest.mark.parametrize("mode", ["RGBA", "RGB", "L"])
def test_jpeg2000_entries_equal_pil(form, mode):
    img = Image.fromarray(_smooth(np.random.default_rng(4), 64)).convert(mode)
    entry = W.pil_save(img, "JPEG2000", no_jp2=form == "j2k", irreversible=False)
    same_as_pil(W.icns_file([(b"icp6", entry)]), "ICNS")


def test_the_largest_size_is_read_as_pil():
    rng = np.random.default_rng(5)
    small, big = _smooth(rng, 16), _smooth(rng, 48)
    for blocks in ([(b"is32", _planes(small)), (b"ih32", _planes(big)), (b"h8mk",
                    big[:, :, 3].tobytes())],
                   [(b"ih32", _planes(big)), (b"ic11", W.pil_save(Image.fromarray(
                       _smooth(rng, 32)), "PNG"))],
                   [(b"is32", _planes(small)), (b"is32", _planes(small[::-1]))]):
        same_as_pil(W.icns_file(blocks), "ICNS")


def _refused():
    rng = np.random.default_rng(6)
    px = _smooth(rng, 16)
    return {
        "plane-overrun": W.icns_file([(b"is32", bytes([130, 1]) * 100)]),
        "plane-short": W.icns_file([(b"is32", _planes(px)[:-20])]),
        "it32-signature": W.icns_file([(b"it32", b"\1\0\0\0" + _planes(_smooth(rng, 128)))]),
        "entry-neither": W.icns_file([(b"ic07", b"GIF89a" + bytes(40))]),
        "png-of-no-size": W.icns_file([(b"ic07", W.pil_save(Image.fromarray(px[:10, :15]),
                                                            "PNG"))]),
        "no-icon": W.icns_file([(b"TOC ", bytes(8))]),
        "block-of-0": b"icns" + (40).to_bytes(4, "big") + b"is32" + bytes(4) + bytes(24),
    }


@pytest.mark.parametrize("name", list(_refused()))
def test_what_pil_refuses_raises(name):
    assert as_pil_or_raise(_refused()[name]) == "raised"


def _cut_files():
    rng = np.random.default_rng(7)
    px = _smooth(rng, 16)
    return {"rle-mask": W.icns_file([(b"is32", _planes(px)), (b"s8mk", px[:, :, 3].tobytes())]),
            "png": W.icns_file([(b"icp4", W.pil_save(Image.fromarray(px), "PNG"))]),
            "raw": W.icns_file([(b"is32", _planes(px[:, :, :3], False))])}


@pytest.mark.parametrize("name", list(_cut_files()))
def test_every_cut_and_byte_flips_decode_as_pil(name):
    decoded, raised = cuts_and_flips(_cut_files()[name], flips=80, seed=len(name))
    assert raised >= 20 and decoded >= 1
