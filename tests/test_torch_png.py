"""``ifseg_torch.data.png.decode_png`` against ``np.asarray(PIL.Image.open)``,
what the JAX package's data pipeline decodes with: bit for bit, dtype and
shape included, for files PIL writes in every mode a segmentation TSV holds,
for files whose rows use every PNG filter type (``chip_smoke.py``'s writer),
and for the rows of ``tests/utils.py:make_seg_tsv``.  Interlaced and 16-bit
files, and broken ones, raise.
"""

import base64
import io
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

import chip_smoke
from ifseg_torch.data.png import decode_png
from utils import make_seg_tsv

SIZES = [(1, 1), (1, 9), (7, 1), (3, 5), (17, 33), (64, 100), (120, 161)]


def _pil(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)))


def _same(data: bytes):
    got, want = decode_png(data), _pil(data)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _save(img: Image.Image, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, format="PNG", **kw)
    return buf.getvalue()


def _smooth(rng, h, w, c):
    """A ramp plus noise: rows PIL's encoder filters with Sub, Up, Average or
    Paeth, where noise alone gets None."""
    ramp = np.cumsum(rng.integers(0, 4, size=(h, w, c)), axis=1) + np.arange(h)[:, None, None]
    return (ramp % 256).astype(np.uint8)


@pytest.mark.parametrize("size", SIZES, ids=[f"{h}x{w}" for h, w in SIZES])
@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA", "LA", "1"])
def test_pil_written_modes(size, mode):
    c = {"L": 1, "RGB": 3, "RGBA": 4, "LA": 2, "1": 1}[mode]
    rng = np.random.default_rng(SIZES.index(size) * 10 + c)
    h, w = size
    for arr in (rng.integers(0, 256, size=(h, w, c), dtype=np.uint8), _smooth(rng, h, w, c)):
        img = Image.fromarray(arr[..., 0] > 127 if mode == "1" else arr[..., 0] if c == 1 else arr)
        assert img.mode == mode
        _same(_save(img))
        _same(_save(img, optimize=True))


@pytest.mark.parametrize("size", SIZES, ids=[f"{h}x{w}" for h, w in SIZES])
@pytest.mark.parametrize("bits", [1, 2, 4, 8])
def test_pil_written_palette_files_give_raw_indices(size, bits):
    rng = np.random.default_rng(bits * 1000 + size[0])
    idx = rng.integers(0, 1 << bits, size=size).astype(np.uint8)
    img = Image.frombytes("P", (size[1], size[0]), idx.tobytes())
    img.putpalette([v % 256 for v in range(3 * (1 << bits))])
    data = _save(img, bits=bits)
    assert data[24] == bits  # IHDR's bit depth
    _same(data)
    np.testing.assert_array_equal(decode_png(data), idx)


@pytest.mark.parametrize("colour,depth", [(0, 8), (2, 8), (3, 8), (6, 8), (0, 1), (0, 2),
                                          (0, 4), (3, 1), (3, 2), (3, 4)])
@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,), (0, 1, 2, 3, 4)],
                         ids=["none", "sub", "up", "average", "paeth", "all"])
def test_every_filter_type_by_hand(colour, depth, filters):
    rng = np.random.default_rng(colour * 10 + depth)
    c = {0: 1, 2: 3, 3: 1, 6: 4}[colour]
    h, w = 11, 13
    arr = (_smooth(rng, h, w, c).astype(np.int32) % (1 << depth)).astype(np.uint8)
    arr = arr[..., 0] if c == 1 else arr
    data = chip_smoke.png_bytes(arr, colour, depth, filters)
    _same(data)


def test_chip_smoke_rows(tmp_path):
    """The first rows chip_smoke.py's validate phase writes (every colour
    type, palette labels at 1, 2 and 4 bits, all filter types)."""
    for image, label, _ in chip_smoke.valid_rows(rows=7):
        _same(image)
        _same(label)


def test_make_seg_tsv_rows(tmp_path):
    path = make_seg_tsv(str(tmp_path / "d.tsv"), rows=3, num_seg=3, size=(40, 56), seed=2)
    for line in open(path):
        image, label, _ = line.rstrip("\n").split("\t")
        for b64 in (image, label):
            _same(base64.urlsafe_b64decode(b64))


def _with_header(data: bytes, **fields) -> bytes:
    """``data`` with IHDR fields replaced (and its CRC fixed)."""
    w, h, depth, colour, comp, filt, interlace = struct.unpack(">IIBBBBB", data[16:29])
    vals = {**dict(depth=depth, colour=colour, interlace=interlace), **fields}
    body = struct.pack(">IIBBBBB", w, h, vals["depth"], vals["colour"], comp, filt,
                       vals["interlace"])
    return data[:16] + body + struct.pack(">I", zlib.crc32(b"IHDR" + body)) + data[33:]


def test_interlaced_and_16_bit_files_raise():
    img = Image.fromarray(np.arange(64, dtype=np.uint16).reshape(8, 8) * 1000)
    data = _save(img)
    assert data[24] == 16
    with pytest.raises(ValueError, match="16-bit"):
        decode_png(data)
    plain = _save(Image.fromarray(np.zeros((8, 8), np.uint8)))
    with pytest.raises(ValueError, match="interlaced"):
        decode_png(_with_header(plain, interlace=1))


def test_broken_files_raise():
    good = _save(Image.fromarray(np.zeros((4, 4, 3), np.uint8)))
    with pytest.raises(ValueError, match="signature"):
        decode_png(b"GIF89a" + good[6:])
    with pytest.raises(ValueError, match="CRC"):
        decode_png(good[:30] + bytes([good[30] ^ 1]) + good[31:])
    with pytest.raises(ValueError, match="truncated"):
        decode_png(good[:-20])
    # a filter byte of 7 in row 0
    arr = np.zeros((2, 3), np.uint8)
    data = chip_smoke.png_bytes(arr, 0)
    raw = bytearray(zlib.decompress(data[41:41 + struct.unpack(">I", data[33:37])[0]]))
    raw[0] = 7
    idat = zlib.compress(bytes(raw))
    bad = (data[:33] + struct.pack(">I", len(idat)) + b"IDAT" + idat
           + struct.pack(">I", zlib.crc32(b"IDAT" + idat)) + data[-12:])
    with pytest.raises(ValueError, match="row 0 has filter type 7"):
        decode_png(bad)


def test_a_failed_build_raises(tmp_path, monkeypatch):
    """Nothing takes the place of the C++ unfilter: a compiler that fails
    makes the load raise."""
    from ifseg_torch.ops import build

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "_LIBS", {})
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="build failed for png_unfilter"):
        build.load("png_unfilter")
    assert not list(tmp_path.glob("*.so"))
