"""GIF, BMP, TIFF, CMYK JPEG, WebP, JPEG 2000, ICO, CUR, PSD and Netpbm files
through the port's entry points against the JAX package's, which read them
with PIL, on the CPU at a tiny width:

  - TSV rows whose images are GIF (palette and gray), BMP (24-bit and
    palette), TIFF (LZW RGB, 16-bit grey, CMYK), CMYK / YCCK JPEG, WebP
    (lossy, lossless RGBA) and JPEG 2000 (JP2 RGB, RGBA and palette, a raw
    grey codestream) files: the
    port's ``SegmentationDataset`` gives the JAX package's training examples
    and evaluation samples, byte for byte (a 4-channel row's first three
    channels, flipped to BGR, as the JAX ``_decode_row`` takes them);
  - ``cli.convert_dataset`` over GIF, BMP, TIFF, WebP and JPEG 2000 originals
    (a 16-bit one and big-endian tiles too;
    ``--image-exts=.gif,.bmp,.tif,.webp,.jp2,.j2k``): the same
    rows as the JAX CLI's, each
    row's image decoded by PIL and by the port to the same array, mode and
    palette (a GIF's transparency index kept as its tRNS chunk);
  - ``cli.infer`` on a CMYK JPEG file with ``--output=*.bmp`` and
    ``--output=*.tif`` (no CRF, fp32): the BMP overlay's bytes equal the JAX
    CLI's (PIL's ``save``), the TIFF overlay's equal PIL's ``save`` of that
    overlay, the masks equal; on a lossy WebP file with alpha and on a raw
    JPEG 2000 codestream: the overlay's and the mask's pixels equal the JAX
    CLI's; on a PSD file with ``--output=*.ppm``: the overlay's bytes equal
    the JAX CLI's, the masks equal;
  - ICO, CUR, PSD and Netpbm rows and originals: the dataset's rows and the
    converted rows equal the JAX package's; a 16-bit PGM row raises in both
    at cv2's resize; a PFM row's evaluation sample and training examples
    equal the JAX dataset's (cv2's float32 resize and HSV); a PFM, Lab or
    CMYK original fails both converters.
"""

import base64
import io

import numpy as np
import pytest
from PIL import Image

import ifseg_torch.cli.infer as tinfer
import ifseg_tpu.cli.convert_dataset as jconvert
import ifseg_tpu.cli.infer as jinfer
import ifseg_tpu.config as jconfig
import torch_image_writers as W
from ifseg_torch.cli import convert_dataset as tconvert
from ifseg_torch.config import model_config_for_arch as torch_model_config
from ifseg_torch.data.image import decode_image

from test_torch_cut_files import _datasets
from test_torch_infer import _argv, _pixels, _tiny, checkpoint  # noqa: F401  (the fixture)
from torch_port_utils import JAX_ONLY
from utils import png_b64


def _originals(seed: int = 7):
    """(extension, file bytes) of each format, smooth pixels of odd sizes."""
    rng = np.random.default_rng(seed)

    def smooth(h, w):
        base = rng.integers(0, 256, (h // 6 + 2, w // 6 + 2, 3)).astype(np.uint8)
        return np.repeat(np.repeat(base, 6, 0), 6, 1)[:h, :w]

    a, b, c = smooth(70, 93), smooth(81, 64), smooth(66, 101)
    return [
        (".gif", W.pil_save(Image.fromarray(a), "GIF")),
        (".gif", W.gif_file([dict(indices=rng.integers(0, 16, (50, 77)), bits=4,
                                  palette=rng.integers(0, 256, (16, 3)), transparency=2,
                                  interlace=1)], (77, 50))),
        (".gif", W.pil_save(Image.fromarray(b[:, :, 0]), "GIF")),
        (".bmp", W.pil_save(Image.fromarray(b), "BMP")),
        (".bmp", W.pil_save(Image.fromarray(c).quantize(30), "BMP")),
        (".tif", W.pil_save(Image.fromarray(c), "TIFF", compression="tiff_lzw")),
        (".tif", W.pil_save(Image.fromarray(a[:, :, 1].astype(np.uint16) * 250), "TIFF")),
        (".tif", W.pil_save(Image.fromarray(np.dstack([b, b[:, :, 0]]), "CMYK"), "TIFF")),
        (".jpg", W.ycck_jpeg(W.pil_save(Image.fromarray(np.dstack([c, c[:, :, 2]]), "CMYK"),
                                        "JPEG"))),
        (".jpg", W.pil_save(Image.fromarray(np.dstack([a, a[:, :, 0]]), "CMYK"), "JPEG",
                            progressive=True)),
    ]


def _webp_originals(seed: int = 9):
    """(".webp", file bytes): lossy RGB, lossless RGBA, lossy with alpha."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (14, 17, 4)).astype(np.uint8)
    rgba = np.repeat(np.repeat(base, 5, 0), 5, 1)[:67, :83]
    return [
        (".webp", W.pil_save(Image.fromarray(rgba[:, :, :3]), "WEBP", quality=75)),
        (".webp", W.pil_save(Image.fromarray(rgba[:61], "RGBA"), "WEBP", lossless=True)),
        (".webp", W.pil_save(Image.fromarray(rgba[:, :71], "RGBA"), "WEBP", quality=60)),
    ]


def _jpeg2000_originals(seed: int = 10):
    """(".jp2" or ".j2k", file bytes): JP2 RGB (5/3), RGBA in tiles at an
    offset and a palette, a raw grey codestream (9/7, two layers)."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (13, 16, 4)).astype(np.uint8)
    rgba = np.repeat(np.repeat(base, 6, 0), 6, 1)[:71, :89]
    palette = W.jp2_palette(W.pil_save(Image.fromarray(rgba[:58, :77, 0] // 16), "JPEG2000"),
                            rng.integers(0, 256, (16, 3)))
    return [
        (".jp2", W.pil_save(Image.fromarray(rgba[:, :, :3]), "JPEG2000")),
        (".jp2", W.pil_save(Image.fromarray(rgba[:64], "RGBA"), "JPEG2000", tile_size=(32, 32),
                            offset=(3, 5))),
        (".jp2", palette),
        (".j2k", W.pil_save(Image.fromarray(rgba[:, :80, 1]), "JPEG2000", no_jp2=True,
                            irreversible=True, quality_layers=[20, 5])),
    ]


def _icon_psd_netpbm_originals(seed: int = 11):
    """(extension, file bytes): ICO (bitmap entry with an AND mask, PNG
    entries), CUR, PSD (PackBits RGB, CMYK, indexed, Lab, a 1-bit bitmap),
    Netpbm (P6, P5, a 16-bit P5, P4, PIL's PyP without a palette)."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (13, 16, 4)).astype(np.uint8)
    px = np.repeat(np.repeat(base, 6, 0), 6, 1)[:73, :91]
    mask = px[:, :, 3] > 99
    planes = np.moveaxis(px, 2, 0)
    pal = rng.integers(0, 256, (256, 3))
    return [
        (".ico", W.ico_file([(W.dib(px[:, :, :3], 24, None, mask), dict(width=91, height=73,
                                                                        bits=24))])),
        (".ico", W.pil_save(Image.fromarray(px, "RGBA"), "ICO", sizes=[(64, 64), (32, 32)])),
        (".cur", W.ico_file([(W.dib(px[:60, :70, 0], 8, pal, mask[:60, :70]),
                              dict(width=70, height=60))], kind=2)),
        (".psd", W.psd_file(planes[:3], 3, 8, 1)),
        (".psd", W.psd_file(planes, 4, 8, 0)),
        (".psd", W.psd_file(planes[:1], 2, 8, 1, palette=pal)),
        (".psd", W.psd_file(planes[:3, :70, :80], 9, 8, 1)),
        (".psd", W.psd_file(planes[:1] > 127, 0, 1, 1)),
        (".ppm", W.netpbm_file(b"P6", px[:, :, :3])),
        (".pgm", W.netpbm_file(b"P5", px[:, :, 0])),
        (".pgm", W.netpbm_file(b"P5", px[:, :, 1].astype(int) * 250, maxval=65535)),
        (".pbm", W.netpbm_file(b"P4", px[:, :, 2] > 127)),
        (".pnm", W.netpbm_file(b"PyP", px[:, :, 0])),
    ]


def _tsv(path):
    """The originals as TSV rows, the 16-bit grey TIFF, the WebP and the
    JPEG 2000 files among them."""
    rng = np.random.default_rng(8)
    with open(path, "w") as fp:
        for i, (_, data) in enumerate(_originals() + _webp_originals() + _jpeg2000_originals()):
            h, w = decode_image(data)[0].shape[:2]
            seg = rng.integers(0, 4, (h // 8 + 1, w // 8 + 1)).astype(np.uint8)
            seg = np.repeat(np.repeat(seg, 8, 0), 8, 1)[:h, :w]
            fp.write(f"{base64.urlsafe_b64encode(data).decode()}\t{png_b64(seg)}\t{i}\n")
    return str(path)


def test_dataset_rows_equal_jax(tmp_path, bpe_dir):
    tsv = _tsv(tmp_path / "rows.tsv")
    got_ds, want_ds = _datasets(tsv, bpe_dir, "valid")
    for i in range(len(want_ds)):
        got_row, want_row = got_ds._decode_row(i), want_ds._decode_row(i)
        for a, b in zip(got_row[:2], want_row[:2]):
            assert a.dtype == b.dtype and np.array_equal(a, b), i
        got, want = got_ds.get_eval_sample(i), want_ds.get_eval_sample(i)
        for f in ("source", "patch_image", "target", "patch_mask"):
            a, b = getattr(got, f, None), getattr(want, f, None)
            if b is not None:
                assert a.dtype == b.dtype and np.array_equal(a, b), (i, f)
    got_ds, want_ds = _datasets(tsv, bpe_dir, "train")
    for i in range(len(want_ds)):
        ga, gb = np.random.default_rng((4, i)), np.random.default_rng((4, i))
        try:
            want = want_ds.get_train_example(i, gb)
        except Exception:  # cv2 refuses the HSV draw on a row still uint16
            with pytest.raises(ValueError, match="uint16"):
                got_ds.get_train_example(i, ga)
            continue
        got = got_ds.get_train_example(i, ga)
        for k in want:
            if k != "id":
                assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), (i, k)


def _pil_row(b64: str):
    im = Image.open(io.BytesIO(base64.urlsafe_b64decode(b64)))
    return np.asarray(im), im.mode, im.getpalette(), im.info.get("transparency")


def test_convert_dataset_rows_equal_jax(tmp_path):
    images, labels = tmp_path / "images", tmp_path / "annotations"
    images.mkdir()
    labels.mkdir()
    # a CMYK original fails both CLIs (tests/test_torch_convert_dataset.py)
    originals = [o for o in _originals()[:7]] + [(".tif", W.tiff_file(
        np.random.default_rng(9).integers(0, 256, (33, 47, 3)), 8, 2, "MM", 8, 2, tile=(16, 16)))
    ] + _webp_originals() + _jpeg2000_originals()
    for i, (ext, data) in enumerate(originals):
        (images / f"img_{i:02d}{ext}").write_bytes(data)
        h, w = decode_image(data)[0].shape[:2]
        Image.fromarray((np.arange(h * w) % 151).astype(np.uint8).reshape(h, w)).save(
            labels / f"img_{i:02d}.png")
    args = ["--mode=ade", f"--images={images}", f"--annotations={labels}", "--workers=2",
            "--image-exts=.gif,.bmp,.tif,.webp,.jp2,.j2k"]
    jconvert.main(args + [f"--output={tmp_path / 'jax.tsv'}"])
    assert tconvert.main(args + [f"--output={tmp_path / 'torch.tsv'}"]) == len(originals)
    want = [r.rstrip("\n").split("\t") for r in open(tmp_path / "jax.tsv")]
    got = [r.rstrip("\n").split("\t") for r in open(tmp_path / "torch.tsv")]
    assert [r[2:] for r in got] == [r[2:] for r in want] and len(got) == len(originals)
    for g, w in zip(got, want):
        for col in (0, 1):
            a, b = _pil_row(g[col]), _pil_row(w[col])
            assert a[1] == b[1] and a[0].dtype == b[0].dtype and np.array_equal(a[0], b[0]), g[2]
            assert a[2] == b[2] and a[3] == b[3], g[2]  # palette and transparency
            port = decode_image(base64.urlsafe_b64decode(g[col]))[0]
            assert np.array_equal(port, a[0]), g[2]


def test_infer_on_a_cmyk_jpeg_writes_bmp_and_tiff_as_jax(checkpoint, bpe_dir, tmp_path,
                                                          monkeypatch):
    monkeypatch.setenv("IFSEG_JIT_CACHE", "")
    monkeypatch.setattr(jconfig, "model_config_for_arch",
                        _tiny(jconfig.model_config_for_arch, dtype="float32", **JAX_ONLY))
    monkeypatch.setattr(tinfer, "model_config_for_arch",
                        _tiny(torch_model_config, dtype="float32"))
    image = tmp_path / "cmyk.jpg"
    image.write_bytes(_originals()[-1][1])
    assert Image.open(image).mode == "CMYK"
    jout = str(tmp_path / "jax.bmp")
    jinfer.main(_argv(str(image), checkpoint, bpe_dir, jout)[:-1] + ["--crf-iters=0"])
    want = open(jout, "rb").read()
    overlay = np.asarray(Image.open(jout))
    for ext in (".bmp", ".tif"):
        tout = str(tmp_path / f"torch{ext}")
        result = tinfer.main(_argv(str(image), checkpoint, bpe_dir, tout)[:-1]
                             + ["--crf-iters=0", "--device=cpu"])
        got = open(tout, "rb").read()
        assert got == (want if ext == ".bmp" else W.pil_save(Image.fromarray(overlay), "TIFF"))
        np.testing.assert_array_equal(_pixels(result["mask"]),
                                      _pixels(str(tmp_path / "jax_mask.png")))
    assert sum(result["areas"].values()) == overlay.shape[0] * overlay.shape[1]


def test_infer_on_a_webp_with_alpha_as_jax(checkpoint, bpe_dir, tmp_path, monkeypatch):
    monkeypatch.setenv("IFSEG_JIT_CACHE", "")
    monkeypatch.setattr(jconfig, "model_config_for_arch",
                        _tiny(jconfig.model_config_for_arch, dtype="float32", **JAX_ONLY))
    monkeypatch.setattr(tinfer, "model_config_for_arch",
                        _tiny(torch_model_config, dtype="float32"))
    image = tmp_path / "alpha.webp"
    image.write_bytes(_webp_originals()[2][1])
    assert Image.open(image).mode == "RGBA"
    jout, tout = str(tmp_path / "jax.png"), str(tmp_path / "torch.png")
    jinfer.main(_argv(str(image), checkpoint, bpe_dir, jout)[:-1] + ["--crf-iters=0"])
    result = tinfer.main(_argv(str(image), checkpoint, bpe_dir, tout)[:-1]
                         + ["--crf-iters=0", "--device=cpu"])
    np.testing.assert_array_equal(_pixels(tout), _pixels(jout))
    np.testing.assert_array_equal(_pixels(result["mask"]), _pixels(str(tmp_path / "jax_mask.png")))


def test_infer_on_a_jpeg2000_codestream_as_jax(checkpoint, bpe_dir, tmp_path, monkeypatch):
    monkeypatch.setenv("IFSEG_JIT_CACHE", "")
    monkeypatch.setattr(jconfig, "model_config_for_arch",
                        _tiny(jconfig.model_config_for_arch, dtype="float32", **JAX_ONLY))
    monkeypatch.setattr(tinfer, "model_config_for_arch",
                        _tiny(torch_model_config, dtype="float32"))
    image = tmp_path / "grey.j2k"
    image.write_bytes(_jpeg2000_originals()[3][1])
    assert Image.open(image).format == "JPEG2000"
    jout, tout = str(tmp_path / "jax.png"), str(tmp_path / "torch.png")
    jinfer.main(_argv(str(image), checkpoint, bpe_dir, jout)[:-1] + ["--crf-iters=0"])
    result = tinfer.main(_argv(str(image), checkpoint, bpe_dir, tout)[:-1]
                         + ["--crf-iters=0", "--device=cpu"])
    np.testing.assert_array_equal(_pixels(tout), _pixels(jout))
    np.testing.assert_array_equal(_pixels(result["mask"]), _pixels(str(tmp_path / "jax_mask.png")))


@pytest.mark.parametrize("ext", [".gif", ".bmp", ".tif", ".jpg", ".webp", ".jp2", ".j2k", ".ico",
                                 ".cur", ".psd", ".ppm", ".pgm", ".pbm", ".pnm"])
def test_serve_and_infer_read_each_format(ext):
    """The daemon's and the CLI's reader (``decode_image_rgb``) on each
    format: PIL's ``convert("RGB")``."""
    from ifseg_torch.data.image import decode_image_rgb

    for e, data in (_originals() + _webp_originals() + _jpeg2000_originals()
                    + _icon_psd_netpbm_originals()):
        if e == ext:
            want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
            np.testing.assert_array_equal(decode_image_rgb(data), want)


def _rows_tsv(path, originals):
    rng = np.random.default_rng(12)
    with open(path, "w") as fp:
        for i, (_, data) in enumerate(originals):
            h, w = decode_image(data)[0].shape[:2]
            seg = rng.integers(0, 4, (h // 8 + 1, w // 8 + 1)).astype(np.uint8)
            seg = np.repeat(np.repeat(seg, 8, 0), 8, 1)[:h, :w]
            fp.write(f"{base64.urlsafe_b64encode(data).decode()}\t{png_b64(seg)}\t{i}\n")
    return str(path)


def test_icon_psd_netpbm_dataset_rows_equal_jax(tmp_path, bpe_dir):
    """ICO, CUR, PSD (a CMYK row's first three channels, a Lab row's L, a and
    b bytes) and Netpbm rows: the JAX package's decoded rows, evaluation
    samples and training examples; a 16-bit PGM row ("I", int32) and the
    1-bit rows (bool), which cv2 refuses to resize, raise in both."""
    originals = _icon_psd_netpbm_originals()
    tsv = _rows_tsv(tmp_path / "rows.tsv", originals)
    refused = [i for i, (_, data) in enumerate(originals) if decode_image(data)[1] in ("I", "1")]
    got_ds, want_ds = _datasets(tsv, bpe_dir, "valid")
    for i in range(len(want_ds)):
        got_row, want_row = got_ds._decode_row(i), want_ds._decode_row(i)
        for a, b in zip(got_row[:2], want_row[:2]):
            assert a.dtype == b.dtype and np.array_equal(a, b), i
        if i in refused:  # cv2 refuses the dtype
            with pytest.raises(Exception):
                want_ds.get_eval_sample(i)
            with pytest.raises(TypeError, match="int32|bool"):
                got_ds.get_eval_sample(i)
            continue
        got, want = got_ds.get_eval_sample(i), want_ds.get_eval_sample(i)
        for f in ("patch_image", "ori_semantic_seg"):
            a, b = getattr(got, f), getattr(want, f)
            assert a.dtype == b.dtype and np.array_equal(a, b), (i, f)
    assert len(refused) == 3
    got_ds, want_ds = _datasets(tsv, bpe_dir, "train")
    for i in range(len(want_ds)):
        ga, gb = np.random.default_rng((5, i)), np.random.default_rng((5, i))
        if i in refused:
            with pytest.raises(Exception):
                want_ds.get_train_example(i, gb)
            with pytest.raises(TypeError, match="int32|bool"):
                got_ds.get_train_example(i, ga)
            continue
        want = want_ds.get_train_example(i, gb)
        got = got_ds.get_train_example(i, ga)
        for k in want:
            if k != "id":
                assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), (i, k)


def test_a_pfm_row_decodes_as_jax_and_its_float_resize_is_refused(tmp_path, bpe_dir):
    """A PFM row ("F", float32) decodes to the JAX package's row, and its
    evaluation sample and training examples, through cv2's float32 resize
    (IPP's) and float32 HSV jitter, equal the JAX dataset's bit for bit:
    the float32 resize the port once refused (ROADMAP C.16), every draw of
    ``PhotoMetricDistortion`` over 40 generators (a float32 image stays
    float32 until a brightness or contrast draw makes it uint8)."""
    px = np.random.default_rng(13).random((37, 45)).astype(np.float32) * 300 - 20
    tsv = _rows_tsv(tmp_path / "pfm.tsv", [(".pfm", W.netpbm_file(b"Pf", px))])
    got_ds, want_ds = _datasets(tsv, bpe_dir, "valid")
    got_row, want_row = got_ds._decode_row(0), want_ds._decode_row(0)
    for a, b in zip(got_row[:2], want_row[:2]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    got, want = got_ds.get_eval_sample(0), want_ds.get_eval_sample(0)
    assert want.patch_image.dtype == np.float32
    for f in ("patch_image", "ori_semantic_seg"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    got_ds, want_ds = _datasets(tsv, bpe_dir, "train")
    dtypes = set()
    for seed in range(40):
        want = want_ds.get_train_example(0, np.random.default_rng((5, seed)))
        got = got_ds.get_train_example(0, np.random.default_rng((5, seed)))
        dtypes.add(want["patch_image"].dtype)
        for k in want:
            if k != "id":
                assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), (seed, k)
    assert dtypes == {np.dtype(np.float32), np.dtype(np.uint8)}


def test_icon_psd_netpbm_convert_rows_equal_jax(tmp_path):
    """``cli.convert_dataset`` over ICO, CUR, PSD and Netpbm originals: each
    row's image in the mode PIL's PNG writer keeps (RGBA, P, "1", a 16-bit
    PGM's "I" as 16 bits, a palette image without a palette as 256 black
    entries), as the JAX CLI writes it."""
    images, labels = tmp_path / "images", tmp_path / "annotations"
    images.mkdir()
    labels.mkdir()
    originals = [o for o in _icon_psd_netpbm_originals()
                 if decode_image(o[1])[1] not in ("CMYK", "LAB")]
    for i, (ext, data) in enumerate(originals):
        (images / f"img_{i:02d}{ext}").write_bytes(data)
        h, w = decode_image(data)[0].shape[:2]
        Image.fromarray((np.arange(h * w) % 151).astype(np.uint8).reshape(h, w)).save(
            labels / f"img_{i:02d}.png")
    args = ["--mode=ade", f"--images={images}", f"--annotations={labels}", "--workers=2",
            "--image-exts=.ico,.cur,.psd,.ppm,.pgm,.pbm,.pnm"]
    jconvert.main(args + [f"--output={tmp_path / 'jax.tsv'}"])
    assert tconvert.main(args + [f"--output={tmp_path / 'torch.tsv'}"]) == len(originals)
    want = [r.rstrip("\n").split("\t") for r in open(tmp_path / "jax.tsv")]
    got = [r.rstrip("\n").split("\t") for r in open(tmp_path / "torch.tsv")]
    assert [r[2:] for r in got] == [r[2:] for r in want] and len(got) == len(originals)
    for g, w in zip(got, want):
        for col in (0, 1):
            a, b = _pil_row(g[col]), _pil_row(w[col])
            assert a[1] == b[1] and a[0].dtype == b[0].dtype and np.array_equal(a[0], b[0]), g[2]
            assert a[2] == b[2] and a[3] == b[3], g[2]  # palette and transparency
            port = decode_image(base64.urlsafe_b64decode(g[col]))[0]
            assert np.array_equal(port, a[0]), g[2]


@pytest.mark.parametrize("mode,data", [
    ("F", W.netpbm_file(b"Pf", np.ones((8, 9), np.float32))),
    ("LAB", W.psd_file(np.full((3, 8, 9), 100, np.uint8), 9)),
    ("CMYK", W.psd_file(np.full((4, 8, 9), 100, np.uint8), 4))], ids=["pfm", "lab-psd", "cmyk-psd"])
def test_an_original_png_cannot_hold_fails_both_converts(tmp_path, mode, data):
    images, labels = tmp_path / "images", tmp_path / "annotations"
    images.mkdir()
    labels.mkdir()
    (images / "a.img").write_bytes(data)
    Image.fromarray(np.zeros((8, 9), np.uint8)).save(labels / "a.png")
    args = ["--mode=ade", f"--images={images}", f"--annotations={labels}", "--workers=1",
            "--image-exts=.img"]
    with pytest.raises(OSError, match=mode):
        jconvert.main(args + [f"--output={tmp_path / 'jax.tsv'}"])
    with pytest.raises(ValueError, match=mode):
        tconvert.main(args + [f"--output={tmp_path / 'torch.tsv'}"])
    assert not (tmp_path / "jax.tsv").exists() and not (tmp_path / "torch.tsv").exists()


def test_infer_on_a_psd_writes_ppm_as_jax(checkpoint, bpe_dir, tmp_path, monkeypatch):
    """``cli.infer --output=*.ppm`` on a PackBits PSD file (no CRF, fp32): the
    overlay's bytes equal the JAX CLI's (PIL's P6), the masks equal."""
    monkeypatch.setenv("IFSEG_JIT_CACHE", "")
    monkeypatch.setattr(jconfig, "model_config_for_arch",
                        _tiny(jconfig.model_config_for_arch, dtype="float32", **JAX_ONLY))
    monkeypatch.setattr(tinfer, "model_config_for_arch",
                        _tiny(torch_model_config, dtype="float32"))
    image = tmp_path / "rgb.psd"
    image.write_bytes(_icon_psd_netpbm_originals()[3][1])
    assert Image.open(image).format == "PSD"
    jout, tout = str(tmp_path / "jax.ppm"), str(tmp_path / "torch.ppm")
    jinfer.main(_argv(str(image), checkpoint, bpe_dir, jout)[:-1] + ["--crf-iters=0"])
    result = tinfer.main(_argv(str(image), checkpoint, bpe_dir, tout)[:-1]
                         + ["--crf-iters=0", "--device=cpu"])
    assert open(tout, "rb").read() == open(jout, "rb").read()
    np.testing.assert_array_equal(_pixels(result["mask"]), _pixels(str(tmp_path / "jax_mask.png")))
