"""JPEG 2000 files (JP2 and raw codestreams) through ``ifseg_torch.data.image``
against PIL 12.1 (OpenJPEG 2.5.4), exactly (every tolerance 0): ``decode_image``
gives PIL's mode, palette and ``np.asarray``, ``decode_image_rgb`` its
``convert("RGB")``, under the JAX package's ``LOAD_TRUNCATED_IMAGES``.

  - files PIL's writer makes here, at small sizes: each mode it writes (L,
    LA, RGB, RGBA, I;16, CMYK) as JP2 and as a raw codestream, with the 5/3
    and the 9/7 wavelet; the five progressions, tiles with image and tile
    offsets, precincts, code-block sizes, 1 to 6 resolutions, quality layers
    by rate and by PSNR, PLT markers, ``mct`` 0 and 1, signed components; odd
    sizes down to 1 x 1;
  - every JPEG 2000 fixture of ``tests/torch_image_files/`` (among them the
    1,024 x 1,366 pair that ``chip_smoke.py`` phase 14e times, a palette
    file, tile-parts with and without their count, 4-, 9-, 12-bit and signed
    precisions, a cut and a byte-flipped file);
  - JP2 header boxes written by hand (no ``colr`` box, an ICC profile, an
    unknown or a mismatched colour space, two ``colr`` boxes, palettes of 3
    and 4 channels on "L" and "LA", ``cmap`` and ``cdef`` boxes, an ``ihdr``
    that is not the codestream's size, a misplaced codestream box; every
    mode ``ihdr`` declares by every colour space around codestreams of 1 to
    4 components), each as PIL decodes it, which for some is an all-zero
    image;
  - every cut of three small files, and seeded byte flips of them: PIL's
    pixels, or ``ValueError`` where PIL raises, or a ``ValueError`` naming a
    feature the port refuses (below) where a flip makes one;
  - the features PIL's encoder cannot write raise ``ValueError`` naming them:
    code-block style flags, SOP and EPH markers, RGN, POC, PPM, PPT, HTJ2K,
    Part 2, subsampled components, precisions above 16 bits, sYCC.
"""

import io
import struct
from pathlib import Path

import numpy as np
import pytest
from PIL import Image, ImageFile

import torch_image_writers as W
from ifseg_torch.data.image import decode_image, decode_image_rgb, image_format
import torch_port_utils  # noqa: F401,E402  (pins torch's threads under xdist)

FIXTURES = Path(__file__).parent / "torch_image_files"
J2K_FIXTURES = sorted(p.name for p in FIXTURES.glob("j*") if p.suffix in (".jp2", ".j2k"))
REFUSED = "JPEG 2000 file refused"


@pytest.fixture(autouse=True)
def _truncated_images(monkeypatch):
    monkeypatch.setattr(ImageFile, "LOAD_TRUNCATED_IMAGES", True)  # the JAX package's setting


def _pil(data: bytes):
    im = Image.open(io.BytesIO(data))
    pixels = np.asarray(im)
    palette = None
    if im.mode in ("P", "PA"):
        palette = np.array(im.getpalette(), np.uint8).reshape(-1, 3)
    return pixels, im.mode, palette, np.asarray(im.convert("RGB"))


def _same(data: bytes):
    pixels, mode, palette, rgb = _pil(data)
    got, got_mode, got_palette = decode_image(data)
    assert image_format(data) == "JPEG 2000"
    assert got_mode == mode
    assert got.dtype == pixels.dtype and got.shape == pixels.shape
    np.testing.assert_array_equal(got, pixels)
    if palette is None:
        assert got_palette is None
    else:
        np.testing.assert_array_equal(got_palette[:, :3], palette[:len(got_palette)])
    np.testing.assert_array_equal(decode_image_rgb(data), rgb)
    return got


def _smooth(seed: int, h: int, w: int, c: int = 3):
    y, x = np.mgrid[0:h, 0:w]
    rng = np.random.default_rng(seed)
    planes = [128 + 90 * np.sin(x / 5 + k) * np.cos(y / 4 - k) + rng.normal(0, 5, (h, w))
              for k in range(c)]
    img = np.clip(np.stack(planes, -1), 0, 255).astype(np.uint8)
    return img if c > 1 else img[:, :, 0]


def _save(arr, mode=None, **kw) -> bytes:
    return W.pil_save(Image.fromarray(arr, mode), "JPEG2000", **kw)


def _mode_image(mode: str, h: int = 23, w: int = 31, seed: int = 0):
    if mode == "I;16":
        return (_smooth(seed, h, w, 1).astype(np.uint16) * 257
                + np.random.default_rng(seed).integers(0, 257, (h, w))).astype(np.uint16)
    channels = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4, "CMYK": 4}[mode]
    return _smooth(seed, h, w, channels)


# ----------------------------------------------------- what PIL's writer makes

@pytest.mark.parametrize("irreversible", [False, True], ids=["5-3", "9-7"])
@pytest.mark.parametrize("jp2", [True, False], ids=["jp2", "j2k"])
@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "I;16", "CMYK"])
def test_each_mode_equals_pil(mode, jp2, irreversible):
    arr = _mode_image(mode)
    _same(_save(arr, None if mode == "RGB" else mode, no_jp2=not jp2, irreversible=irreversible))
    if mode in ("RGB", "RGBA"):
        _same(_save(arr, None if mode == "RGB" else mode, no_jp2=not jp2,
                    irreversible=irreversible, mct=1, signed=True))


OPTIONS = {
    **{f"{p}-precincts": dict(progression=p, precinct_size=(16, 16), codeblock_size=(8, 8),
                              num_resolutions=3) for p in ("LRCP", "RLCP", "RPCL", "PCRL", "CPRL")},
    **{f"{p}-tiles": dict(progression=p, tile_size=(16, 20), offset=(5, 3), tile_offset=(2, 1))
       for p in ("LRCP", "RPCL", "CPRL")},
    **{f"resolutions-{n}": dict(num_resolutions=n, tile_size=(64, 64)) for n in range(1, 7)},
    "codeblocks-4x4": dict(codeblock_size=(4, 4)),
    "codeblocks-64x16": dict(codeblock_size=(64, 16)),
    "codeblocks-16x64": dict(codeblock_size=(16, 64)),
    "precincts-per-resolution": dict(precinct_size=(32, 32), num_resolutions=4),
    "layers-rates": dict(quality_mode="rates", quality_layers=[60, 20, 5]),
    "layers-db": dict(quality_mode="dB", quality_layers=[25, 32, 45]),
    "layers-rates-rpcl": dict(quality_mode="rates", quality_layers=[30, 8],
                              progression="RPCL", precinct_size=(16, 16)),
    "plt": dict(plt=True, tile_size=(32, 32)),
    "mct-0": dict(mct=0),
    "mct-1-signed": dict(mct=1, signed=True),
    "odd-offsets-one-tile": dict(offset=(7, 11), tile_size=(64, 64), num_resolutions=5),
    "tile-offset": dict(offset=(9, 6), tile_offset=(4, 2), tile_size=(12, 10)),
}


@pytest.mark.parametrize("irreversible", [False, True], ids=["5-3", "9-7"])
@pytest.mark.parametrize("name", sorted(OPTIONS))
def test_encoder_options_equal_pil(name, irreversible):
    arr = _smooth(1, 40, 53)
    _same(_save(arr, no_jp2=True, irreversible=irreversible, **OPTIONS[name]))


SIZES = [(1, 1), (1, 7), (9, 1), (2, 3), (3, 2), (5, 5), (17, 9), (33, 65), (64, 1)]


@pytest.mark.parametrize("h,w", SIZES)
def test_odd_sizes_equal_pil(h, w):
    arr = _smooth(2, h, w)
    _same(_save(arr, no_jp2=True))
    _same(_save(arr, no_jp2=True, irreversible=True, num_resolutions=1))
    if h > 1 and w > 1:  # OpenJPEG's encoder cannot offset a 1-pixel line
        _same(_save(arr, no_jp2=True, offset=(1, 1), tile_size=(w + 1, h + 1)))


@pytest.mark.parametrize("name", J2K_FIXTURES)
def test_fixture_equals_pil(name):
    _same((FIXTURES / name).read_bytes())


def test_the_fixtures_cover_the_cases_the_card_times():
    assert {"jp2_rgb_reversible_1024x1366.jp2", "jp2_rgb_irreversible_1024x1366.jp2",
            "jp2_palette.jp2", "j2k_tile_parts.j2k", "j2k_cut_tiles.j2k"} <= set(J2K_FIXTURES)
    assert len(J2K_FIXTURES) >= 20


# --------------------------------------------------------- JP2 boxes by hand

def _colr(enumcs: int, meth: int = 1) -> bytes:
    return bytes([meth, 0, 0]) + struct.pack(">I", enumcs)


def _with(boxes, kind, payload=None, drop=False):
    """The jp2h boxes with ``kind`` replaced (or dropped), or appended."""
    if drop:
        return [b for b in boxes if b[0] != kind]
    if any(b[0] == kind for b in boxes):
        return [(k, payload if k == kind else p) for k, p in boxes]
    return boxes + [(kind, payload)]


def _ihdr(boxes, width, height):
    out = []
    for k, p in boxes:
        if k == b"ihdr":
            p = struct.pack(">II", height, width) + p[8:]
        out.append((k, p))
    return out


HEADERS = {
    "no-colr": lambda b: _with(b, b"colr", drop=True),
    "icc-profile": lambda b: _with(b, b"colr", b"\x02\x00\x00" + bytes(range(40))),
    "unknown-space": lambda b: _with(b, b"colr", _colr(99)),
    "gray-space-on-rgb": lambda b: _with(b, b"colr", _colr(17)),
    "method-3-ignored": lambda b: _with(b, b"colr", _colr(16, 3)),
    "two-colr": lambda b: b + [(b"colr", _colr(17))],
    "cdef": lambda b: b + [(b"cdef", struct.pack(">H3H3H3H", 3, 0, 0, 1, 1, 0, 2, 2, 0, 3))],
    "bad-cdef": lambda b: b + [(b"cdef", b"\x00\x00")],
    "cmap-without-pclr": lambda b: b + [(b"cmap", bytes(12))],
    "bpcc-wrong-size": lambda b: b + [(b"bpcc", b"\x07")],
    "ihdr-not-siz": lambda b: _ihdr(b, 30, 24),
    "ihdr-bad-length": lambda b: [(k, p + b"\0" if k == b"ihdr" else p) for k, p in b],
    "unknown-box": lambda b: b + [(b"xyzw", bytes(9))],
}


@pytest.mark.parametrize("name", sorted(HEADERS))
def test_jp2_header_boxes_decode_as_pil(name):
    data = W.jp2_rewrite_header(_save(_smooth(3, 24, 29)), HEADERS[name])
    _same(data)


@pytest.mark.parametrize("case", ["L", "LA", "L-rgba-palette", "L-gray-space", "L-repeated-colour"])
def test_jp2_palettes_decode_as_pil(case):
    rng = np.random.default_rng(4)
    mode = "LA" if case == "LA" else "L"
    arr = _mode_image(mode, 21, 26, seed=4)
    idx = arr // 32 if mode == "L" else np.dstack([arr[..., 0] // 32, arr[..., 1]])
    palette = rng.integers(0, 256, (8, 4 if case == "L-rgba-palette" else 3))
    if case == "L-repeated-colour":
        palette[5] = palette[2]
    data = W.jp2_palette(_save(idx, mode), palette, 17 if case == "L-gray-space" else 16)
    _same(data)


def _codestream_of(components: int) -> bytes:
    arr = _smooth(10, 12, 15, 4)
    mode = {1: "L", 2: "LA", 3: "RGB", 4: "RGBA"}[components]
    return _save(arr[..., 0] if components == 1 else arr[..., :components],
                 None if components in (1, 3) else mode)


@pytest.mark.parametrize("space", [None, 16, 17, 12, 24, 99, 18])
@pytest.mark.parametrize("declared", [1, 2, 3, 4])
@pytest.mark.parametrize("components", [1, 2, 3, 4])
def test_unpackers_by_mode_space_and_components_as_pil(components, declared, space):
    """A JP2 file whose ``ihdr`` declares ``declared`` components (PIL's mode)
    around a codestream of ``components``, its ``colr`` space ``space`` (None:
    no box; 99: unknown): PIL's unpacker for the three, or its all-zero image
    where it has none; sYCC, which PIL converts, is refused where it would."""
    def header(boxes):
        out = []
        for kind, payload in boxes:
            if kind == b"ihdr":
                payload = payload[:8] + struct.pack(">H", declared) + payload[10:]
            if kind == b"colr":
                if space is None:
                    continue
                payload = _colr(space)
            if kind != b"cdef":
                out.append((kind, payload))
        return out

    data = W.jp2_rewrite_header(_codestream_of(components), header)
    if space == 18 and declared >= 3 and components >= 3:
        with pytest.raises(ValueError, match="sYCC"):
            decode_image(data)
        return
    _same(data)


def test_box_order_and_codestream_box_as_openjpeg_reads_them():
    data = _save(_smooth(5, 20, 22))
    boxes = W.jp2_boxes(data, 12)
    kinds = [k for k, _ in boxes]
    assert kinds == [b"ftyp", b"jp2h", b"jp2c"]
    ftyp, jp2h, jp2c = (W.jp2_box(k, p) for k, p in boxes)
    sig = data[:12]
    for variant in (sig + jp2h + ftyp + jp2c,  # ftyp not second: OpenJPEG fails, all zeros
                    sig + ftyp + jp2c + jp2h,  # the codestream before its header
                    sig + ftyp + jp2h + W.jp2_box(b"free", bytes(5)) + jp2c,
                    sig + ftyp + jp2h + struct.pack(">I4s", 0, b"jp2c") + boxes[2][1]):
        _same(variant)


def test_nine_bit_modes_follow_pils_plugin():
    """A raw codestream above 8 bits opens as "I;16"; a JP2 file opens as "L"
    up to 9 bits, by its ``ihdr`` depth byte (masked with 0x7F, above 8)."""
    arr = _smooth(6, 19, 23, 1)
    raw = W.j2k_precision(_save(arr, no_jp2=True), 9)
    assert _same(raw).dtype == np.uint16
    jp2 = _save(arr)
    boxes = W.jp2_boxes(jp2, 12)
    cs = W.j2k_precision(boxes[2][1], 9)
    header = W.jp2_rewrite_header(jp2, lambda b: [(k, p[:10] + b"\x08" + p[11:] if k == b"ihdr"
                                                   else p) for k, p in b])
    nine = header[:len(header) - len(boxes[2][1])] + cs
    assert _same(nine).dtype == np.uint8


# ------------------------------------------------------- cut and broken files

def _small_files():
    arr = _smooth(7, 20, 26)
    return {
        "tiles": _save(arr, no_jp2=True, tile_size=(8, 8)),
        "layers-jp2": _save(arr, quality_layers=[30, 10, 3], quality_mode="rates",
                            irreversible=True),
        "precincts-gray": _save(arr[:, :, 0], no_jp2=True, precinct_size=(8, 8),
                                codeblock_size=(4, 4), num_resolutions=3, progression="PCRL"),
    }


def _as_pil_or_raise(data: bytes):
    """The port decodes ``data`` as PIL does; where PIL raises, so does the
    port.  Returns "decoded" or "raised"."""
    try:
        want = _pil(data)
    except Exception:  # what PIL raises under the flag
        with pytest.raises(ValueError):
            decode_image(data)
        return "raised"
    got, mode, _ = decode_image(data)
    assert mode == want[1] and got.dtype == want[0].dtype and got.shape == want[0].shape
    np.testing.assert_array_equal(got, want[0])
    np.testing.assert_array_equal(decode_image_rgb(data), want[3])
    return "decoded"


@pytest.mark.parametrize("name", ["tiles", "layers-jp2", "precincts-gray"])
def test_every_cut_decodes_as_pil(name):
    data = _small_files()[name]
    seen = [_as_pil_or_raise(data[:cut]) for cut in range(len(data) + 1)]
    assert seen.count("raised") >= 10 and seen.count("decoded") > len(data) // 2


@pytest.mark.parametrize("name", ["tiles", "layers-jp2", "precincts-gray"])
def test_byte_flips_decode_as_pil_or_refuse(name):
    """Seeded single-byte flips: PIL's pixels, or both raise, or the port
    refuses a feature the flip made (a subsampling, style flag, Rsiz bit)."""
    data = _small_files()[name]
    rng = np.random.default_rng(len(data))
    refused = 0
    for _ in range(120):
        flipped = bytearray(data)
        flipped[int(rng.integers(0, len(data)))] ^= int(rng.integers(1, 256))
        try:  # a flipped size field can make an image of hundreds of MB: not here
            width, height = Image.open(io.BytesIO(bytes(flipped))).size
            if width * height > 1 << 20:
                continue
        except Exception:
            pass
        try:
            _as_pil_or_raise(bytes(flipped))
        except (ValueError, AssertionError):
            with pytest.raises(ValueError, match=REFUSED):
                decode_image(bytes(flipped))
            refused += 1
    assert refused <= 20


# ------------------------------------------------------------ refused files

def _segment(marker: int, payload: bytes) -> bytes:
    return struct.pack(">HH", marker, len(payload) + 2) + payload


def _main_header_insert(codestream: bytes, segment: bytes) -> bytes:
    """``segment`` put just before the first SOT."""
    at = codestream.index(b"\xff\x90")
    return codestream[:at] + segment + codestream[at:]


def _patch(codestream: bytes, marker: bytes, offset: int, value: int, mask: int = 0xFF) -> bytes:
    out = bytearray(codestream)
    at = codestream.index(marker) + offset
    out[at] = (out[at] & ~mask & 0xFF) | value
    return bytes(out)


def _refused_cases():
    cs = _save(_smooth(8, 16, 18), no_jp2=True)
    cs_gray = _save(_smooth(8, 16, 18, 1), no_jp2=True)
    at_sot = cs.index(b"\xff\x90")
    tile_header = lambda seg: cs[:at_sot + 12] + seg + cs[at_sot + 12:]
    # a tile-part header segment lengthens the tile-part: its Psot with it
    ppt = _segment(0xFF61, b"\x00" + bytes(4))
    with_ppt = bytearray(tile_header(ppt))
    psot = struct.unpack(">I", with_ppt[at_sot + 6:at_sot + 10])[0] + len(ppt)
    with_ppt[at_sot + 6:at_sot + 10] = struct.pack(">I", psot)
    return {
        "style flags": (_patch(cs, b"\xff\x52", 12, 0x01), "code-block style flags"),
        "SOP markers": (_patch(cs, b"\xff\x52", 4, 0x02), "SOP markers"),
        "EPH markers": (_patch(cs, b"\xff\x52", 4, 0x04), "EPH markers"),
        "RGN": (_main_header_insert(cs, _segment(0xFF5E, b"\x00\x00\x02")), "RGN"),
        "POC": (_main_header_insert(cs, _segment(0xFF5F, bytes([0, 0, 0, 1, 6, 3, 0]))), "POC"),
        "PPM": (_main_header_insert(cs, _segment(0xFF60, b"\x00" + bytes(4))), "PPM"),
        "PPT": (bytes(with_ppt), "PPT"),
        "HTJ2K": (_patch(cs, b"\xff\x51", 4, 0x40), "HTJ2K"),
        "CAP": (_main_header_insert(cs, _segment(0xFF50, bytes(6))), "HTJ2K"),
        "Part 2": (_patch(cs, b"\xff\x51", 4, 0x80), "Part 2"),
        "subsampling": (_patch(cs, b"\xff\x51", 41, 2), "subsampled components"),
        "24 bits": (W.j2k_precision(cs_gray, 24), "precisions above 16 bits"),
        "sYCC": (W.jp2_rewrite_header(_save(_smooth(8, 16, 18)),
                                      lambda b: _with(b, b"colr", _colr(18))), "sYCC"),
    }


@pytest.mark.parametrize("name", sorted(_refused_cases()))
def test_refused_features_raise_naming_them(name):
    data, why = _refused_cases()[name]
    with pytest.raises(ValueError, match=f"{REFUSED}: .*{why}"):
        decode_image(data)
    with pytest.raises(ValueError, match=why):
        decode_image_rgb(data)


def test_more_than_four_components_raise_as_pil():
    cs = bytearray(_save(_smooth(9, 8, 8, 4), "RGBA", no_jp2=True))
    cs[40:42] = struct.pack(">H", 5)  # Csiz: PIL's plugin finds no mode
    with pytest.raises(Exception):
        Image.open(io.BytesIO(bytes(cs)))
    with pytest.raises(ValueError, match="5 components"):
        decode_image(bytes(cs))
