"""``ifseg_torch.data.png.decode_png`` against ``np.asarray(PIL.Image.open)``,
what the JAX package's data pipeline decodes with: bit for bit, dtype and
shape included, for files PIL writes in every mode a segmentation TSV holds,
for files whose rows use every PNG filter type (``chip_smoke.py``'s writer),
for Adam7-interlaced and 16-bit files written by hand, and for the rows of
``tests/utils.py:make_seg_tsv``.  Broken files raise.
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


# Adam7: (x0, y0, dx, dy) of the seven passes (PNG specification section 8.2)
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _filtered(samples: np.ndarray, depth: int, bpp: int, seed: int) -> bytes:
    """The rows of (h, w, c) samples packed at ``depth`` bits (16-bit ones
    big-endian), each with a filter type drawn from ``seed``."""
    h = samples.shape[0]
    if depth == 16:
        rows = samples.astype(">u2").view(np.uint8).reshape(h, -1)
    elif depth == 8:
        rows = samples.reshape(h, -1).astype(np.uint8)
    else:
        flat = samples.reshape(h, -1)
        per = 8 // depth
        flat = np.pad(flat, ((0, 0), (0, (-flat.shape[1]) % per))).reshape(h, -1, per)
        shifts = np.arange(8 - depth, -1, -depth)
        rows = (flat.astype(np.int64) << shifts).sum(-1).astype(np.uint8)
    kinds = np.random.default_rng(seed).integers(0, 5, size=h)
    raw = rows.astype(np.int32)
    out, prev = [], np.zeros(raw.shape[1], np.int32)
    for kind, row in zip(kinds, raw):
        left = np.concatenate([np.zeros(bpp, np.int32), row[:-bpp]])[: len(row)]
        corner = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])[: len(row)]
        p = left + prev - corner
        pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - corner)
        paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, corner))
        pred = (np.zeros_like(row), left, prev, (left + prev) >> 1, paeth)[kind]
        out.append(bytes([kind]) + ((row - pred) & 0xFF).astype(np.uint8).tobytes())
        prev = row
    return b"".join(out)


def _png_by_hand(samples: np.ndarray, colour: int, depth: int, interlace: int, seed: int = 0,
                 extra: bytes = b"") -> bytes:
    """A PNG file of (h, w, c) samples, Adam7-interlaced if ``interlace``,
    with ``extra`` chunks (PLTE, tRNS) before the image data."""
    h, w, c = samples.shape
    bpp = max(c * depth // 8, 1)
    if interlace:
        body = b"".join(_filtered(samples[y0::dy, x0::dx], depth, bpp, seed + i)
                        for i, (x0, y0, dx, dy) in enumerate(ADAM7)
                        if samples[y0::dy, x0::dx].size)
    else:
        body = _filtered(samples, depth, bpp, seed)

    def chunk(kind: bytes, data: bytes) -> bytes:
        return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))

    head = chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0, interlace))
    return (b"\x89PNG\r\n\x1a\n" + head + extra + chunk(b"IDAT", zlib.compress(body))
            + chunk(b"IEND", b""))


def _palette_chunk(entries: int, seed: int) -> bytes:
    body = np.random.default_rng(seed).integers(0, 256, 3 * entries).astype(np.uint8).tobytes()
    return struct.pack(">I", len(body)) + b"PLTE" + body + struct.pack(">I", zlib.crc32(b"PLTE" + body))


@pytest.mark.parametrize("size", [(1, 1), (2, 3), (5, 7), (8, 8), (9, 17), (13, 4)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("colour,depth", [(0, 1), (0, 2), (0, 4), (0, 8), (2, 8), (3, 1), (3, 2),
                                          (3, 4), (3, 8), (4, 8), (6, 8)])
def test_interlaced_files(size, colour, depth):
    """Adam7 files (PIL reads them, it does not write them), every colour
    type and bit depth, sizes that leave passes empty."""
    rng = np.random.default_rng(colour * 100 + depth * 10 + size[0])
    samples = rng.integers(0, 1 << depth, size=size + (CHANNELS[colour],))
    extra = _palette_chunk(1 << depth, depth) if colour == 3 else b""
    _same(_png_by_hand(samples, colour, depth, 1, seed=size[1], extra=extra))


@pytest.mark.parametrize("interlace", [0, 1], ids=["plain", "adam7"])
@pytest.mark.parametrize("colour", [0, 2, 4, 6], ids=["gray", "rgb", "gray_alpha", "rgba"])
@pytest.mark.parametrize("size", [(1, 1), (6, 9), (17, 12)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_16_bit_files(size, colour, interlace):
    """16-bit files: gray as PIL's "I;16" (uint16), the other colour types as
    PIL's 8-bit modes of the samples' high bytes (gray + alpha as "RGBA")."""
    rng = np.random.default_rng(colour * 10 + interlace)
    samples = rng.integers(0, 1 << 16, size=size + (CHANNELS[colour],))
    data = _png_by_hand(samples, colour, 16, interlace, seed=colour)
    _same(data)
    if colour == 0:
        assert decode_png(data).dtype == np.uint16


def test_16_bit_files_pil_writes():
    img = Image.fromarray(np.arange(64, dtype=np.uint16).reshape(8, 8) * 1000)
    data = _save(img)
    assert data[24] == 16 and img.mode == "I;16"
    _same(data)


def test_broken_files_raise():
    good = _save(Image.fromarray(np.zeros((4, 4, 3), np.uint8)))
    with pytest.raises(ValueError, match="signature"):
        decode_png(b"GIF89a" + good[6:])
    with pytest.raises(ValueError, match="CRC"):
        decode_png(good[:30] + bytes([good[30] ^ 1]) + good[31:])
    # cut before the image data (inside IHDR): PIL refuses it too, even under
    # LOAD_TRUNCATED_IMAGES; a file cut later decodes (tests/test_torch_truncated.py)
    with pytest.raises(ValueError, match="truncated"):
        decode_png(good[:30])
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
