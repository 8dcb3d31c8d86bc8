"""Image files as the JAX package reads them: any format PIL opens in a TSV
row, and cut files under its ``ImageFile.LOAD_TRUNCATED_IMAGES = True``.

- TSV rows whose image is a JPEG (RGB and gray) go through the port's
  ``SegmentationDataset`` as through the JAX package's: training examples
  and evaluation samples equal, byte for byte.
- Every cut of PNG files (PIL's modes, Adam7, 16-bit, several IDATs and a
  chunk after them) decodes to PIL's pixels under the flag, and raises
  exactly where PIL raises.
- Every cut of JPEG files (baseline 4:2:0 / 4:4:4, gray, restart intervals,
  progressive) raises exactly where PIL raises and otherwise decodes to
  PIL's pixels with each IDCT libjpeg-turbo has, bit for bit at every cut:
  its SIMD one, which PIL runs by default (the port's default too,
  ``data/jpeg.py:idct_variant``), its SSE2 one (``JSIMD_FORCESSE2=1``) and its
  C one (``JSIMD_FORCENONE=1``), PIL run in a process of its own with the
  switch and the port set to the same variant.  The SIMD IDCT computes in 16
  bits; where a cut leaves a block of coefficients that overflow them (the
  zero bits read past the cut), it differs from the C IDCT inside that
  block, and only there (ROADMAP C.15: 190 of these files' 11,248 decodable
  cuts).
- A cut progressive file, whose missing refinements libjpeg-turbo
  block-smooths (the rows past the cut with the previous scan's
  precision), decodes to the smoothed pixels, and the cuts that give PIL's
  all-zero image (inside a marker segment after the first scan) give it.
- CMYK and progressive YCCK files decode at every cut as the others do.
"""

import base64
import io
import os
import struct
import subprocess
import sys
import zlib

import numpy as np
import pytest
from PIL import Image, ImageFile

from ifseg_torch.config import from_flags as torch_flags
from ifseg_torch.data.jpeg import decode_jpeg, idct_variant
from ifseg_torch.data.png import decode_png
from ifseg_torch.tasks.segmentation import SegmentationTask as TorchTask
from ifseg_tpu.config import from_flags as jax_flags
from ifseg_tpu.tasks.segmentation import SegmentationTask as JaxTask

from test_torch_png import _png_by_hand
from torch_image_writers import ycck_jpeg
from utils import png_b64
import torch_port_utils  # noqa: F401,E402  (pins torch's threads under xdist)


@pytest.fixture(autouse=True)
def _truncated_images(monkeypatch):
    monkeypatch.setattr(ImageFile, "LOAD_TRUNCATED_IMAGES", True)  # the JAX package's setting


def _pixels(h, w, seed, gray=False):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    a = np.dstack([x * 255 // max(w - 1, 1), y * 255 // max(h - 1, 1), (x + y) * 3 % 256])
    a = np.clip(a + rng.integers(-20, 20, a.shape), 0, 255).astype(np.uint8)
    return a[:, :, 0] if gray else a


def _save(arr, fmt, **kw) -> bytes:
    buf = io.BytesIO()
    mode = "CMYK" if arr.ndim == 3 and arr.shape[2] == 4 else None
    Image.fromarray(arr, mode).save(buf, fmt, **kw)
    return buf.getvalue()


def _pil(data):
    try:
        return np.asarray(Image.open(io.BytesIO(data)))
    except Exception:  # what PIL raises under the flag
        return None


def _port(decode, data):
    try:
        return decode(data)
    except ValueError as e:
        return str(e)


# ------------------------------------------------------------------- C.7

def _jpeg_tsv(path, rows=4):
    rng = np.random.default_rng(5)
    with open(path, "w") as fp:
        for i in range(rows):
            h, w = (int(v) for v in rng.integers(70, 160, 2))
            img = _pixels(h, w, i, gray=i == 3)
            jpeg = _save(img, "JPEG", quality=int(rng.integers(60, 96)),
                         **({"progressive": True} if i == 2 else {}))
            seg = np.zeros((h, w), np.uint8)
            seg[h // 4:, : w // 2] = 1 + i % 3
            seg[: h // 3, w // 2:] = 2
            fp.write(f"{base64.urlsafe_b64encode(jpeg).decode()}\t{png_b64(seg)}\t{i}\n")
    return path


def _datasets(tsv, bpe_dir, split):
    argv = [f"{tsv},{tsv}", "--num-seg-tokens=3", "--category-list=cat, dog, grass",
            "--patch-image-size=64", "--orig-patch-image-size=64", f"--bpe-dir={bpe_dir}"]
    tasks = [T.setup_task(f(argv)) for T, f in ((TorchTask, torch_flags), (JaxTask, jax_flags))]
    return [t.load_dataset(split) for t in tasks]


def test_jpeg_rows_train_examples_equal_jax(tmp_path, bpe_dir):
    got_ds, want_ds = _datasets(_jpeg_tsv(str(tmp_path / "j.tsv")), bpe_dir, "train")
    for i in range(len(want_ds)):
        ga, gb = np.random.default_rng((3, i)), np.random.default_rng((3, i))
        got, want = got_ds.get_train_example(i, ga), want_ds.get_train_example(i, gb)
        assert got.keys() == want.keys()
        for k in want:
            if k == "id":
                assert got[k] == want[k]
            else:
                assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
        assert ga.bit_generator.state == gb.bit_generator.state


def test_jpeg_rows_eval_samples_equal_jax(tmp_path, bpe_dir):
    got_ds, want_ds = _datasets(_jpeg_tsv(str(tmp_path / "j.tsv")), bpe_dir, "valid")
    for i in range(len(want_ds)):
        got, want = got_ds.get_eval_sample(i), want_ds.get_eval_sample(i)
        for f in ("source", "patch_image", "target", "patch_mask"):
            a, b = getattr(got, f, None), getattr(want, f, None)
            if b is None:
                continue
            assert a.dtype == b.dtype and np.array_equal(a, b), f
        assert got.ori_shape == want.ori_shape and got.id == want.id


# ------------------------------------------------------------------- C.8 PNG

def _png_chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def _split_idat(data: bytes, parts: int, tail: bytes = b"") -> bytes:
    """The file with its IDAT split into ``parts`` chunks and ``tail`` chunks
    before IEND."""
    at = data.index(b"IDAT") - 4
    n = struct.unpack(">I", data[at:at + 4])[0]
    body = data[at + 8:at + 8 + n]
    cuts = np.linspace(0, n, parts + 1).astype(int)
    idats = b"".join(_png_chunk(b"IDAT", body[a:b]) for a, b in zip(cuts[:-1], cuts[1:]))
    return data[:at] + idats + tail + data[at + 12 + n:]


def _png_files():
    rng = np.random.default_rng(0)
    rgb = rng.integers(0, 256, (20, 17, 3), dtype=np.uint8)
    files = {
        "rgb": _save(rgb, "PNG"),
        "gray-4bit": _save((rng.integers(0, 16, (9, 13)) * 17).astype(np.uint8), "PNG", bits=4),
        "bilevel": _save(rng.integers(0, 2, (10, 21)).astype(bool), "PNG"),
        "adam7": _png_by_hand(rng.integers(0, 256, (13, 11, 3)), 2, 8, 1, seed=1),
        "adam7-16bit-gray": _png_by_hand(rng.integers(0, 65536, (9, 10, 1)), 0, 16, 1, seed=2),
        "three-idats-text": _split_idat(_save(rgb, "PNG"), 3,
                                        _png_chunk(b"tEXt", b"key\x00some text")),
    }
    buf = io.BytesIO()
    Image.fromarray(rgb).convert("P", palette=Image.ADAPTIVE, colors=7).save(buf, "PNG")
    return dict(files, palette=buf.getvalue())


@pytest.mark.parametrize("name", ["rgb", "gray-4bit", "palette", "bilevel", "adam7",
                                  "adam7-16bit-gray", "three-idats-text"])
def test_every_cut_png_decodes_as_pil(name):
    data = _png_files()[name]
    decoded = raised = 0
    for cut in range(len(data) + 1):
        want, got = _pil(data[:cut]), _port(decode_png, data[:cut])
        if want is None:
            assert isinstance(got, str), (name, cut, got)  # a ValueError
            raised += 1
            continue
        assert not isinstance(got, str), (name, cut, got)
        assert got.dtype == want.dtype and np.array_equal(got, want), (name, cut)
        decoded += 1
    assert decoded > len(data) // 2 and raised > 30


# ------------------------------------------------------------------- C.8 JPEG

def _jpeg_files():
    return {
        "baseline": _save(_pixels(64, 96, 0), "JPEG", quality=75),
        "baseline-444": _save(_pixels(37, 45, 1), "JPEG", quality=90, subsampling=0),
        "gray": _save(_pixels(40, 56, 2, gray=True), "JPEG", quality=75),
        "restart-blocks": _save(_pixels(64, 96, 3), "JPEG", quality=75, restart_marker_blocks=2),
        "restart-rows": _save(_pixels(48, 40, 4), "JPEG", quality=60, restart_marker_rows=1),
        "progressive": _save(_pixels(64, 96, 5), "JPEG", quality=75, progressive=True),
        "progressive-gray": _save(_pixels(40, 56, 6, gray=True), "JPEG", quality=75,
                                  progressive=True),
        "cmyk": _save(np.dstack([_pixels(40, 56, 7), _pixels(40, 56, 8, gray=True)]), "JPEG",
                      quality=80),
        "progressive-ycck": ycck_jpeg(_save(np.dstack([_pixels(32, 48, 9), _pixels(32, 48, 10,
                                                                                  gray=True)]),
                                            "JPEG", quality=75, progressive=True)),
    }


_C_IDCT = """
import io, json, sys
import numpy as np
from PIL import Image, ImageFile
ImageFile.LOAD_TRUNCATED_IMAGES = True
data = open(sys.argv[1], "rb").read()
out = {}
for cut in range(len(data) + 1):
    try:
        out[cut] = np.asarray(Image.open(io.BytesIO(data[:cut])))
    except Exception:
        pass
np.savez(sys.argv[2], **{str(k): v for k, v in out.items()})
"""


def _pil_c_idct(data: bytes, tmp_path, switch: str = "JSIMD_FORCENONE") -> dict:
    """PIL's pixels at every cut with libjpeg-turbo's C IDCT (its SIMD off by
    its own environment switch, which it reads once, so in a process of its
    own), or with the IDCT another ``switch`` picks; the cuts PIL refuses are
    absent."""
    src, dst = tmp_path / "f.jpg", tmp_path / f"pil-{switch}.npz"
    src.write_bytes(data)
    env = dict(os.environ, **{switch: "1"})
    subprocess.run([sys.executable, "-c", _C_IDCT, str(src), str(dst)], env=env, check=True,
                   timeout=300)
    with np.load(dst) as z:
        return {int(k): z[k] for k in z.files}


@pytest.fixture
def idct():
    """Set the port's IDCT variant for a test, and restore it after."""
    was = idct_variant()
    yield idct_variant
    idct_variant(was)


@pytest.mark.parametrize("name", list(_jpeg_files()))
def test_every_cut_jpeg_decodes_as_libjpeg_turbo(name, tmp_path, idct):
    data = _jpeg_files()[name]
    c_idct = _pil_c_idct(data, tmp_path)
    sse2 = _pil_c_idct(data, tmp_path, "JSIMD_FORCESSE2")
    counts = dict(equal=0, raised=0, simd=0, black=0, smoothed=0, smoothed_simd=0)
    last_scan = data.rindex(b"\xff\xda")
    assert idct() in ("sse2", "avx2")  # libjpeg-turbo's pick on an x86-64 CPU
    for cut in range(len(data) + 1):
        want, got = _pil(data[:cut]), _port(decode_jpeg, data[:cut])
        if want is None:
            assert isinstance(got, str), (name, cut, got)  # a ValueError
            assert cut not in c_idct and cut not in sse2
            counts["raised"] += 1
            continue
        assert not isinstance(got, str), (name, cut, got)
        assert got.dtype == want.dtype and np.array_equal(got, want), (name, cut)
        # a cut before the last scan of PIL's progressive file leaves coefficients
        # unrefined: libjpeg-turbo block-smooths it
        smoothed = "progressive" in name and cut <= last_scan
        counts["smoothed" if smoothed else "equal"] += 1
        counts["black"] += not got.any()
        if not np.array_equal(want, c_idct[cut]):  # libjpeg-turbo's SIMD against its C IDCT
            rows, cols = np.nonzero((want != c_idct[cut]).reshape(got.shape[0], got.shape[1],
                                                                  -1).any(-1))
            # within one MCU, and the fancy upsampler's pixel on each side of it
            assert np.ptp(rows) <= 17 and np.ptp(cols) <= 17, (name, cut)
            counts["smoothed_simd" if smoothed else "simd"] += 1
    for variant, table in (("c", c_idct), ("sse2", sse2)):
        idct(variant)
        for cut, pixels in table.items():
            assert np.array_equal(decode_jpeg(data[:cut]), pixels), (name, variant, cut)
    first_scan_end = data.index(b"\xff\xda") + 2 + struct.unpack(">H", data[
        data.index(b"\xff\xda") + 2:data.index(b"\xff\xda") + 4])[0]
    assert counts["raised"] == first_scan_end  # every cut before the first scan's header ends
    assert counts["equal"] > 100
    # the cuts where the C IDCT differs from the SIMD one: 0.4-2.1 % with PIL 12.1
    assert counts["simd"] <= 0.05 * counts["equal"]
    if "progressive" in name:
        # the smoothed cuts: 0 % (gray, YCCK) and 9.0 % (RGB) differ from the C IDCT in PIL 12.1
        assert counts["smoothed"] > 100 and counts["smoothed_simd"] <= 0.1 * counts["smoothed"]
        assert counts["black"] > 0
    else:
        assert counts["smoothed"] == counts["black"] == 0


def test_a_cut_progressive_file_is_smoothed_as_pil(tmp_path, idct):
    """Cut inside its third scan, PIL's progressive file has its DC and the
    first AC scans, and no refinement: libjpeg-turbo block-smooths it, the
    rows the cut scan reached with that scan's precision and the rows past
    it with the precision before it; the port's pixels are PIL's, with
    libjpeg-turbo's default (SIMD) IDCT and, set to it, with its C IDCT,
    which differs only inside the block the cut leaves with garbage
    coefficients."""
    data = _jpeg_files()["progressive"]
    scans = [i for i in range(len(data) - 1) if data[i:i + 2] == b"\xff\xda"]
    cut = data[:(scans[2] + scans[3]) // 2]
    want = _pil(cut)
    assert want.shape == (64, 96, 3)
    np.testing.assert_array_equal(decode_jpeg(cut), want)
    idct("c")
    got = decode_jpeg(cut)
    np.testing.assert_array_equal(got, _pil_c_idct(cut, tmp_path)[len(cut)])
    rows, cols = np.nonzero((got != want).any(-1))
    assert len(rows) == 0 or (np.ptp(rows) <= 17 and np.ptp(cols) <= 17)
