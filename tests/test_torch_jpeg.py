"""``ifseg_torch.data.jpeg`` against PIL (libjpeg-turbo), exactly.

``decode_jpeg`` equals ``np.asarray(PIL.Image.open(...))`` bit for bit, dtype
and shape included, and ``encode_jpeg`` writes the bytes of
``Image.fromarray(arr).save(buf, "JPEG", quality=q, subsampling=s)``, on a
sweep of PIL-written files: sizes from 1 x 1 to 120 x 161 with odd sides,
gray and RGB at 4:4:4, 4:2:2 and 4:2:0, qualities 1, 50, 75, 95 and 100,
baseline and progressive, with and without restart intervals; on random
files under hypothesis; on ``assets/cat_dog.jpeg`` (progressive, 4:4:4).
Every tolerance here is zero.  The refused files (arithmetic coding, 12-bit,
lossless, CMYK, truncated, progressive files libjpeg-turbo would smooth)
raise ``ValueError`` naming what they are.  The digests ``chip_smoke.py``
phase 14 pins are recomputed with PIL.
"""

import hashlib
import io
import itertools

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from PIL import Image, ImageFile

import chip_smoke
from ifseg_torch.data.jpeg import decode_jpeg, encode_jpeg

SIZES = [(1, 1), (3, 5), (8, 8), (9, 17), (16, 16), (17, 33), (31, 2), (2, 31), (40, 41),
         (64, 65), (120, 161)]
QUALITIES = (1, 50, 75, 95, 100)
# (mode, PIL's subsampling): gray, then RGB at 4:4:4, 4:2:2 and 4:2:0
KINDS = [("L", 0), ("RGB", 0), ("RGB", 1), ("RGB", 2)]


def _pixels(h, w, mode, seed):
    """A photograph's smooth regions and grain: a coarse random grid
    enlarged, plus normal noise."""
    rng = np.random.default_rng(seed)
    c = 1 if mode == "L" else 3
    base = rng.integers(0, 255, (h // 5 + 2, w // 5 + 2, c)).astype(np.float64)
    ys = np.linspace(0, base.shape[0] - 1.01, h).astype(int)
    xs = np.linspace(0, base.shape[1] - 1.01, w).astype(int)
    img = np.clip(base[ys][:, xs] + rng.normal(0, 12, (h, w, c)), 0, 255).astype(np.uint8)
    return img[:, :, 0] if c == 1 else img


def _pil_jpeg(arr, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _pil(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)))


def _same(data: bytes):
    got, want = decode_jpeg(data), _pil(data)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", KINDS, ids=lambda k: f"{k[0]}-{k[1]}")
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_decode_equals_pil(size, kind):
    mode, sub = kind
    arr = _pixels(*size, mode, seed=size[0] * 1000 + size[1])
    for q, progressive, restart in itertools.product(QUALITIES, (False, True), (0, 2)):
        kw = dict(quality=q, subsampling=sub, progressive=progressive)
        if restart:
            kw["restart_marker_blocks"] = restart
        _same(_pil_jpeg(arr, **kw))


@pytest.mark.parametrize("subsampling", [None, 0, 1, 2, "4:4:4", "4:2:2", "4:2:0"])
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_encode_equals_pil(size, subsampling):
    kw = {} if subsampling is None else dict(subsampling=subsampling)
    for mode in ("L", "RGB"):
        arr = _pixels(*size, mode, seed=size[0] * 7 + size[1])
        for q in QUALITIES:
            assert encode_jpeg(arr, q, subsampling) == _pil_jpeg(arr, quality=q, **kw)
    # PIL's default quality is 75
    assert encode_jpeg(arr) == _pil_jpeg(arr)


@settings(max_examples=60, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(h=st.integers(1, 70), w=st.integers(1, 70), mode=st.sampled_from(["L", "RGB"]),
       sub=st.sampled_from([0, 1, 2]), q=st.integers(1, 100), progressive=st.booleans(),
       restart=st.sampled_from([0, 1, 3]), seed=st.integers(0, 2**31 - 1))
def test_random_files(h, w, mode, sub, q, progressive, restart, seed):
    arr = _pixels(h, w, mode, seed)
    want = _pil_jpeg(arr, quality=q, subsampling=sub)
    assert encode_jpeg(arr, q, sub) == want
    _same(want)
    kw = dict(quality=q, subsampling=sub, progressive=progressive)
    if restart:
        kw["restart_marker_blocks"] = restart
    _same(_pil_jpeg(arr, **kw))


def test_cat_dog_is_progressive_444_and_decodes_as_pil():
    data = (chip_smoke.REPO / "assets" / "cat_dog.jpeg").read_bytes()
    img = Image.open(io.BytesIO(data))
    assert img.info.get("progressive") and img.size == (1440, 560)
    _same(data)


@pytest.mark.parametrize("rows", [1, 3])
def test_restart_intervals_in_rows(rows):
    arr = _pixels(45, 70, "RGB", seed=rows)
    for sub in (0, 1, 2):
        _same(_pil_jpeg(arr, subsampling=sub, restart_marker_rows=rows))


def test_adobe_rgb_files_are_not_converted():
    """``keep_rgb`` writes RGB components under an Adobe marker with
    transform 0 and no JFIF marker: libjpeg-turbo outputs them unconverted."""
    data = _pil_jpeg(_pixels(21, 34, "RGB", seed=3), keep_rgb=True, subsampling=0)
    assert b"Adobe" in data and b"JFIF" not in data[:40]
    _same(data)


def test_markers_that_are_skipped():
    """COM and APPn segments (EXIF orientation is not applied), fill bytes
    before a marker, and a file with no DHT (the standard tables)."""
    arr = _pixels(19, 26, "RGB", seed=4)
    exif = Image.Exif()
    exif[0x0112] = 6  # orientation: rotate 90
    data = _pil_jpeg(arr, comment=b"a comment", exif=exif.tobytes())
    assert decode_jpeg(data).shape == (19, 26, 3)
    _same(data)
    sof = data.index(b"\xff\xc0")
    _same(data[:sof] + b"\xff\xff\xff" + data[sof:])
    no_dht, pos = bytearray(data[:2]), 2
    while True:  # drop every DHT segment
        marker = data[pos + 1]
        length = int.from_bytes(data[pos + 2:pos + 4], "big")
        if marker != 0xC4:
            no_dht += data[pos:pos + 2 + length]
        pos += 2 + length
        if marker == 0xDA:
            no_dht += data[pos:]
            break
    assert b"\xff\xc4" not in bytes(no_dht)[:200]
    _same(bytes(no_dht))


def _with_sof(data: bytes, marker: int = None, precision: int = None) -> bytes:
    at = data.index(b"\xff\xc0")
    out = bytearray(data)
    if marker is not None:
        out[at + 1] = marker
    if precision is not None:
        out[at + 4] = precision
    return bytes(out)


def test_refused_files_raise(monkeypatch):
    # the JAX package's setting (its dataset module sets it): the port decodes
    # as PIL does under it, and refuses only what PIL refuses under it too
    monkeypatch.setattr(ImageFile, "LOAD_TRUNCATED_IMAGES", True)
    arr = _pixels(24, 30, "RGB", seed=5)
    data = _pil_jpeg(arr)
    with pytest.raises(ValueError, match="arithmetic"):
        decode_jpeg(_with_sof(data, marker=0xC9))
    with pytest.raises(ValueError, match="lossless"):
        decode_jpeg(_with_sof(data, marker=0xC3))
    with pytest.raises(ValueError, match="12-bit"):
        decode_jpeg(_with_sof(data, precision=12))
    cmyk = io.BytesIO()
    Image.fromarray(np.dstack([arr, arr[:, :, :1]]), "CMYK").save(cmyk, "JPEG")
    assert Image.open(cmyk).mode == "CMYK"
    with pytest.raises(ValueError, match="CMYK"):
        decode_jpeg(cmyk.getvalue())
    # cut inside the header, before the first scan's header ends: PIL raises
    # even under the flag (a cut further on decodes: tests/test_torch_truncated.py)
    first_scan = data.index(b"\xff\xda")
    for cut in (first_scan // 2, first_scan + 6):
        with pytest.raises(OSError, match="(?i)truncated|cannot identify"):
            _pil(data[:cut])
        with pytest.raises(ValueError, match="truncated"):
            decode_jpeg(data[:cut])
    with pytest.raises(ValueError, match="not a JPEG"):
        decode_jpeg(b"\x89PNG\r\n\x1a\n" + data[8:])
    with pytest.raises(ValueError, match="DNL"):
        decode_jpeg(data.replace(b"\xff\xc0\x00\x11\x08\x00\x18", b"\xff\xc0\x00\x11\x08\x00\x00"))


def test_unrefined_progressive_files_raise():
    """PIL's progressive files refine every coefficient to bit 0; drop the
    scans after the first two and libjpeg-turbo would block-smooth the
    coefficients left coarse, which this decoder refuses."""
    data = _pil_jpeg(_pixels(40, 48, "RGB", seed=6), progressive=True)
    scans = [i for i in range(len(data) - 1) if data[i:i + 2] == b"\xff\xda"]
    assert len(scans) >= 6
    cut = data[:scans[2]] + b"\xff\xd9"
    assert _pil(cut).shape == (40, 48, 3)
    with pytest.raises(ValueError, match="unrefined"):
        decode_jpeg(cut)


def test_encode_rejects_other_arrays():
    with pytest.raises(ValueError, match="uint8"):
        encode_jpeg(np.zeros((4, 4, 4), np.uint8))
    with pytest.raises(ValueError, match="uint8"):
        encode_jpeg(np.zeros((4, 4), np.float32))
    with pytest.raises(ValueError, match="subsampling"):
        encode_jpeg(np.zeros((4, 4, 3), np.uint8), subsampling="4:1:1")


def _reciprocal(divisor):
    """libjpeg-turbo's jcdctmgr.c compute_reciprocal at 16 bits, as
    ``csrc/jpeg_encode.cpp`` holds it."""
    b = int(divisor).bit_length() - 1
    r = 16 + b
    fq, fr = divmod(1 << r, divisor)
    c = divisor // 2
    if fr == 0:
        fq, r = fq >> 1, r - 1
    elif fr <= divisor // 2:
        c += 1
    else:
        fq += 1
    return fq, c, r


def test_reciprocal_quantizer_is_a_rounding_division():
    """For every divisor a baseline table gives (8 x 1..255) and every DCT
    output magnitude the integer FDCT of 8-bit samples reaches (< 2^14),
    multiplying by the reciprocal equals dividing with halves rounded up."""
    x = np.arange(1 << 14, dtype=np.int64)
    for q in range(1, 256):
        d = 8 * q
        fq, c, r = _reciprocal(d)
        np.testing.assert_array_equal(((x + c) * fq) >> r, (x + d // 2) // d)


# the originals of chip_smoke.py phase 14, pinned from PIL
def test_phase_14_digests_are_pils():
    for spec, (file_sha, pixels_sha) in zip(chip_smoke.JPEG_CASES, chip_smoke.JPEG_DIGESTS):
        arr = chip_smoke.jpeg_original(spec)
        data = _pil_jpeg(arr, quality=spec[3], subsampling=spec[4])
        assert hashlib.sha256(data).hexdigest()[:16] == file_sha, spec
        assert chip_smoke.row_digest(_pil(data)) == pixels_sha, spec
    cat_dog = (chip_smoke.REPO / "assets" / "cat_dog.jpeg").read_bytes()
    assert hashlib.sha256(cat_dog).hexdigest()[:16] == chip_smoke.CAT_DOG_DIGESTS[0]
    assert chip_smoke.row_digest(_pil(cat_dog)) == chip_smoke.CAT_DOG_DIGESTS[1]
