"""TGA, SGI, QOI, PCX, DCX, IM, DDS and headerless DIB files, and PNG rows
with a bad filter byte, through the port's entry points against the JAX
package's, which read them with PIL, on the CPU at a tiny width:

  - TSV rows of each format (raw and run-length TGA, colour-mapped TGA, RLE
    and 16-bit SGI, RGB and RGBA QOI, RGB and palette PCX, DCX, IM in RGB,
    L, a colour LUT's P, YCbCr and F, DDS BC1, BC3 and uncompressed, DIB):
    the port's ``SegmentationDataset`` gives the JAX package's decoded rows,
    evaluation samples and training examples, byte for byte;
  - ``cli.convert_dataset`` over such originals gives the JAX CLI's rows;
  - ``cli.train`` on the rows of each format trains as on the same images
    as PNG rows (equal losses and validation areas);
  - ``cli.infer`` on a TGA file with ``--output=*.tga`` writes the JAX CLI's
    bytes; on a PNG it writes every extension the port names
    (``.jfif .jpe .mpo .apng .dib .tga .icb .vda .vst .bw .rgb .rgba .sgi
    .qoi .pcx .im .dds``) as PIL's ``save`` writes the same overlay, and the
    port reads each back as PIL does;
  - a PNG row whose filter byte is 7 (plain, Adam7, inside an ICO) decodes as
    PIL reads it under ``LOAD_TRUNCATED_IMAGES`` (ROADMAP C.14), in the
    dataset too.
"""

import base64
import io
import struct
import zlib

import numpy as np
import pytest
from PIL import Image, ImageFile

import ifseg_torch.cli.infer as tinfer
import ifseg_torch.cli.train as ttrain
import ifseg_tpu.cli.convert_dataset as jconvert
import ifseg_tpu.cli.infer as jinfer
import ifseg_tpu.config as jconfig
import torch_image_writers as W
from ifseg_torch.cli import convert_dataset as tconvert
from ifseg_torch.config import from_flags as torch_flags
from ifseg_torch.config import model_config_for_arch as torch_model_config
from ifseg_torch.data.image import decode_image
from ifseg_torch.utils import metrics as tmetrics

from test_torch_cut_files import _datasets
from test_torch_image_cli import _pil_row, _rows_tsv
from test_torch_infer import _argv, _pixels, _tiny, checkpoint  # noqa: F401  (the fixture)
from test_torch_train_cli import _argv as _train_argv
from test_torch_train_cli import _capture
from torch_pil_checks import same_as_pil
from torch_port_utils import JAX_ONLY, passed_tmp  # noqa: F401  (the fixture)


@pytest.fixture(autouse=True)
def _truncated_images(monkeypatch):
    monkeypatch.setattr(ImageFile, "LOAD_TRUNCATED_IMAGES", True)  # the JAX package's setting


def _smooth(rng, h, w, c=3):
    base = rng.integers(0, 256, (h // 6 + 2, w // 6 + 2, c)).astype(np.uint8)
    return np.repeat(np.repeat(base, 6, 0), 6, 1)[:h, :w]


def _originals(seed: int = 21):
    """(extension, file bytes) of each new format, smooth pixels of odd sizes."""
    rng = np.random.default_rng(seed)
    a, b = _smooth(rng, 70, 93, 4), _smooth(rng, 61, 77, 4)
    tga_rle = W.tga_rle(np.ascontiguousarray(a[:, :, [2, 1, 0, 3]]).tobytes(), 4, 93)
    planes16 = np.moveaxis(b[:, :, :3].astype(np.uint16) * 257, 2, 0)
    bc = rng.integers(0, 256, (18 * 24, 16), dtype=np.uint8).tobytes()
    im_lines = [b"Image type: L 32F image", b"Image size (x*y): 77*61"]
    return [
        (".tga", W.pil_save(Image.fromarray(a[:, :, :3]), "TGA")),
        (".tga", W.tga_file(tga_rle, 93, 70, 10, 32, 0x28)),
        (".tga", W.pil_save(Image.fromarray(b[:, :, :3]).quantize(50), "TGA", rle=True)),
        (".sgi", W.sgi_file(np.moveaxis(a[:, :, :3], 2, 0), rle=True)),
        (".rgba", W.sgi_file(np.concatenate([planes16, planes16[:1]]))),
        (".qoi", W.pil_save(Image.fromarray(b[:, :, :3]), "QOI")),
        (".qoi", W.qoi_file(a)),
        (".pcx", W.pil_save(Image.fromarray(a[:, :, :3]), "PCX")),
        (".pcx", W.pil_save(Image.fromarray(b[:, :, :3]).quantize(30), "PCX")),
        (".dcx", W.dcx_file([W.pil_save(Image.fromarray(b[:, :, :3]), "PCX")])),
        (".im", W.pil_save(Image.fromarray(a[:, :, :3]), "IM")),
        (".im", W.pil_save(Image.fromarray(b[:, :, 0]), "IM")),
        (".im", W.pil_save(Image.fromarray(b[:, :, :3]).quantize(40), "IM")),
        (".im", W.pil_save(Image.fromarray(a[:, :, :3], "YCbCr"), "IM")),
        (".im", W.im_file(im_lines, (b[:, :, 0].astype("<f4") * 1.5 - 9)[::-1].tobytes())),
        (".dds", W.pil_save(Image.fromarray(a), "DDS", pixel_format="DXT1")),
        (".dds", W.dds_file(93, 70, bc, 0x4, b"DXT5")),
        (".dds", W.pil_save(Image.fromarray(b[:, :, :3]), "DDS")),
        (".dib", W.pil_save(Image.fromarray(a[:, :, :3]), "DIB")),
    ]


def test_raw_format_dataset_rows_equal_jax(tmp_path, bpe_dir):
    originals = _originals()
    for _, data in originals:
        same_as_pil(data)
    tsv = _rows_tsv(tmp_path / "rows.tsv", originals)
    got_ds, want_ds = _datasets(tsv, bpe_dir, "valid")
    for i in range(len(want_ds)):
        got_row, want_row = got_ds._decode_row(i), want_ds._decode_row(i)
        for a, b in zip(got_row[:2], want_row[:2]):
            assert a.dtype == b.dtype and np.array_equal(a, b), i
        got, want = got_ds.get_eval_sample(i), want_ds.get_eval_sample(i)
        for f in ("patch_image", "ori_semantic_seg"):
            a, b = getattr(got, f), getattr(want, f)
            assert a.dtype == b.dtype and np.array_equal(a, b), (i, f)
    got_ds, want_ds = _datasets(tsv, bpe_dir, "train")
    for i in range(len(want_ds)):
        want = want_ds.get_train_example(i, np.random.default_rng((9, i)))
        got = got_ds.get_train_example(i, np.random.default_rng((9, i)))
        for k in want:
            if k != "id":
                assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), (i, k)


def test_raw_format_convert_rows_equal_jax(tmp_path):
    """``cli.convert_dataset`` over the originals PIL's PNG writer takes (not
    YCbCr or F): each row's image in its PNG mode, as the JAX CLI writes it."""
    images, labels = tmp_path / "images", tmp_path / "annotations"
    images.mkdir()
    labels.mkdir()
    originals = [o for o in _originals() if decode_image(o[1])[1] not in ("YCbCr", "F")]
    exts = sorted({ext for ext, _ in originals})
    for i, (ext, data) in enumerate(originals):
        (images / f"img_{i:02d}{ext}").write_bytes(data)
        h, w = decode_image(data)[0].shape[:2]
        Image.fromarray((np.arange(h * w) % 151).astype(np.uint8).reshape(h, w)).save(
            labels / f"img_{i:02d}.png")
    args = ["--mode=ade", f"--images={images}", f"--annotations={labels}", "--workers=2",
            f"--image-exts={','.join(exts)}"]
    jconvert.main(args + [f"--output={tmp_path / 'jax.tsv'}"])
    assert tconvert.main(args + [f"--output={tmp_path / 'torch.tsv'}"]) == len(originals)
    want = [r.rstrip("\n").split("\t") for r in open(tmp_path / "jax.tsv")]
    got = [r.rstrip("\n").split("\t") for r in open(tmp_path / "torch.tsv")]
    assert [r[2:] for r in got] == [r[2:] for r in want] and len(got) == len(originals)
    for g, w in zip(got, want):
        for col in (0, 1):
            a, b = _pil_row(g[col]), _pil_row(w[col])
            assert a[1] == b[1] and a[0].dtype == b[0].dtype and np.array_equal(a[0], b[0]), g[2]
            assert a[2] == b[2] and a[3] == b[3], g[2]


def test_raw_format_rows_train_as_their_png_twins(passed_tmp, monkeypatch):
    """One epoch of ``cli.train`` (64 px, 2 rows a batch, fp32, no dropout)
    over rows of every new format, and over the same images as PNG rows:
    the same losses and validation areas."""
    originals = [o for o in _originals() if decode_image(o[1])[1] != "F"][:8]
    tsv = _rows_tsv(passed_tmp / "raw.tsv", originals)
    twins = []
    for line in open(tsv):
        img_b64, seg_b64, uid = line.rstrip("\n").split("\t")
        pixels = decode_image(base64.urlsafe_b64decode(img_b64))[0]
        # the PNG twin holds what the dataset reads of the row: its array (a
        # palette image's indices), without a fourth channel
        buf = io.BytesIO()
        Image.fromarray(np.ascontiguousarray(pixels[:, :, :3] if pixels.ndim == 3 else pixels)
                        ).save(buf, "PNG")
        twins.append(f"{base64.urlsafe_b64encode(buf.getvalue()).decode()}\t{seg_b64}\t{uid}\n")
    twin = passed_tmp / "png.tsv"
    twin.write_text("".join(twins))
    tail = ["--max-epoch=1", "--dtype=float32", "--dropout=0.0", "--encoder-drop-path-rate=0.0",
            "--decoder-drop-path-rate=0.0", "--seed=3"]
    runs = []
    for name, data in (("raw", tsv), ("png", str(twin))):
        with monkeypatch.context() as patch:
            seen = _capture(patch, ttrain, tmetrics)
            argv = _train_argv(f"{data},{data}", passed_tmp / name, 64, *tail)
            assert ttrain.main(torch_flags(argv), device="cpu")["num_updates"] == 4
        runs.append(seen)
    assert runs[0]["loss"] == runs[1]["loss"] and len(runs[0]["loss"]) == 1
    for k, v in runs[0]["valid"][0].items():
        assert np.array_equal(v, runs[1]["valid"][0][k]), k


_WRITTEN = (".jfif", ".jpe", ".mpo", ".apng", ".dib", ".tga", ".icb", ".vda", ".vst", ".bw",
            ".rgb", ".rgba", ".sgi", ".qoi", ".pcx", ".im", ".dds")


def test_infer_on_a_tga_writes_tga_as_jax(checkpoint, bpe_dir, tmp_path, monkeypatch):
    """``cli.infer --output=*.tga`` on a run-length TGA file (no CRF, fp32):
    the overlay's bytes equal the JAX CLI's (PIL's ``save``), the masks
    equal."""
    monkeypatch.setenv("IFSEG_JIT_CACHE", "")
    monkeypatch.setattr(jconfig, "model_config_for_arch",
                        _tiny(jconfig.model_config_for_arch, dtype="float32", **JAX_ONLY))
    monkeypatch.setattr(tinfer, "model_config_for_arch",
                        _tiny(torch_model_config, dtype="float32"))
    image = tmp_path / "in.tga"
    image.write_bytes(_originals()[1][1])
    jout, tout = str(tmp_path / "jax.tga"), str(tmp_path / "torch.tga")
    jinfer.main(_argv(str(image), checkpoint, bpe_dir, jout)[:-1] + ["--crf-iters=0"])
    result = tinfer.main(_argv(str(image), checkpoint, bpe_dir, tout)[:-1]
                         + ["--crf-iters=0", "--device=cpu"])
    assert open(tout, "rb").read() == open(jout, "rb").read()
    np.testing.assert_array_equal(_pixels(result["mask"]), _pixels(str(tmp_path / "jax_mask.png")))


def test_infer_writes_every_new_extension_as_pil(checkpoint, bpe_dir, tmp_path, monkeypatch):
    monkeypatch.setattr(tinfer, "model_config_for_arch",
                        _tiny(torch_model_config, dtype="float32"))
    image = tmp_path / "in.qoi"
    image.write_bytes(_originals()[5][1])
    base = ["--crf-iters=0", "--resnet-iters=0", "--device=cpu"]
    png = str(tmp_path / "overlay.png")
    tinfer.main(_argv(str(image), checkpoint, bpe_dir, png)[:-1] + base)
    overlay = _pixels(png)
    for ext in _WRITTEN:
        out = tmp_path / f"overlay-{ext[1:]}{ext}"
        tinfer.main(_argv(str(image), checkpoint, bpe_dir, str(out))[:-1] + base)
        want = tmp_path / f"pil-{ext[1:]}{ext}"
        Image.fromarray(overlay).save(want)
        got = out.read_bytes()
        if ext == ".apng":  # PNG bytes of the port's own writer: PIL's pixels
            np.testing.assert_array_equal(_pixels(str(out)), overlay)
        else:  # IM and SGI headers hold the file's name: each side's own
            assert got == tinfer.encode_overlay(overlay, str(out)), ext
            assert tinfer.encode_overlay(overlay, str(want)) == want.read_bytes(), ext
        same_as_pil(got)


def _bad_filter_png(arr: np.ndarray, row: int, interlace: int = 0) -> bytes:
    """A grey PNG written by hand whose ``row``-th filtered row (in file
    order) has filter byte 7."""
    h, w = arr.shape
    if interlace:
        passes = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4),
                  (1, 0, 2, 2), (0, 1, 1, 2))
        lines = [sub for x0, y0, dx, dy in passes for sub in arr[y0::dy, x0::dx] if sub.size]
    else:
        lines = list(arr)
    raw = b"".join(bytes([7 if i == row else 0]) + line.tobytes() for i, line in enumerate(lines))

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))
    head = struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, interlace)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", head) + chunk(b"IDAT", zlib.compress(raw))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("interlace", [0, 1], ids=["plain", "adam7"])
@pytest.mark.parametrize("row", [0, 2, 5, 11])
def test_a_bad_filter_byte_keeps_the_rows_before_it(row, interlace, tmp_path, bpe_dir):
    arr = (np.arange(13 * 14).reshape(13, 14) * 7 % 251).astype(np.uint8)
    data = _bad_filter_png(arr, row, interlace)
    same_as_pil(data, "PNG")
    same_as_pil(W.ico_file([(data, dict(width=14, height=13))]), "ICO")
    if row == 5:
        tsv = _rows_tsv(tmp_path / "bad.tsv", [(".png", data)])
        got_ds, want_ds = _datasets(tsv, bpe_dir, "valid")
        for a, b in zip(got_ds._decode_row(0)[:2], want_ds._decode_row(0)[:2]):
            assert a.dtype == b.dtype and np.array_equal(a, b)
