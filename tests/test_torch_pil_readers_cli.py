"""DDS's BC6H and BC7 blocks, FTEX, BLP, ICNS and PIL's small raster
readers (SUN, MSP, XBM, XPM, GBR, PIXAR, XVThumb, McIdas, IMT, SPIDER,
FITS) through the port's entry points against the JAX package's, which
read them with PIL, on the CPU at a tiny width:

  - TSV rows of each format: the port's ``SegmentationDataset`` gives the
    JAX package's decoded rows (an ICNS "RGB" row as PIL's array packs it),
    evaluation samples and training examples, byte for byte; a row whose
    mode cv2 refuses to resize ("1", "I") raises in both, and so does a
    16-bit row's HSV draw;
  - ``cli.convert_dataset`` over such originals gives the JAX CLI's rows;
  - ``cli.train`` on rows of the formats trains as on the same images as
    PNG rows (equal losses and validation areas);
  - ``cli.infer`` on a file of each format writes the JAX CLI's overlay and
    mask; the daemon's request path (``SegService._preprocess``) gives the
    JAX daemon's network input for each;
  - the dispatch: files that more than one of PIL's plugins could take are
    named as PIL names them, or refused where PIL refuses them, and
    ``_OTHER_FORMATS`` names exactly what PIL 12.1 opens and the port does
    not read.
"""

import base64
import io
import subprocess
import sys
import types

import numpy as np
import pytest
from PIL import Image, ImageFile

import ifseg_torch.cli.infer as tinfer
import ifseg_torch.cli.train as ttrain
import ifseg_tpu.cli.convert_dataset as jconvert
import ifseg_tpu.cli.infer as jinfer
import ifseg_tpu.cli.serve as jserve
import ifseg_tpu.config as jconfig
import torch_image_writers as W
from ifseg_torch.cli import convert_dataset as tconvert
from ifseg_torch.cli import serve as tserve
from ifseg_torch.config import from_flags as torch_flags
from ifseg_torch.config import model_config_for_arch as torch_model_config
from ifseg_torch.data import image as timage
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


def _originals(seed: int = 22):
    """(extension, file bytes, name) of each new format and layout, smooth
    pixels of odd sizes."""
    rng = np.random.default_rng(seed)
    a, b = _smooth(rng, 70, 93, 4), _smooth(rng, 61, 77, 4)
    g = a[:, :, 0]
    n = 18 * 24
    bc7 = np.concatenate([W.bc7_blocks(m, n // 8, rng) for m in range(8)])
    bc6 = np.concatenate([W.bc6h_blocks(m, n // 12 + 1, rng) for m in range(12)])[:n]
    bc6s = np.concatenate([W.bc6h_blocks(m, n // 12 + 1, rng, True) for m in range(12)])[:n]
    dxt5 = rng.integers(0, 256, 24 * 18 * 16, dtype=np.uint8).tobytes()
    jpeg = W.pil_save(Image.fromarray(b[:, :, :3]), "JPEG")
    pal = rng.integers(0, 256, 1024, dtype=np.uint8).tobytes()
    sun_rows = np.pad(a[:, :, :3].reshape(70, -1)[:, ::-1], ((0, 0), (0, 1)))
    icns_rgb = _smooth(rng, 48, 48)
    planes = b"".join(W.icns_rle(np.ascontiguousarray(icns_rgb[:, :, c]).tobytes())
                      for c in range(3))
    return [
        (".dds", W.dds_file(93, 70, bc7.tobytes(), 0x4, b"DX10", dxgi=98), "bc7"),
        (".dds", W.dds_file(93, 70, bc6.tobytes(), 0x4, b"DX10", dxgi=95), "bc6h"),
        (".dds", W.dds_file(93, 70, bc6s.tobytes(), 0x4, b"DX10", dxgi=96), "bc6h-signed"),
        (".ftc", W.ftex_file(77, 61, b[:, :, :3].tobytes(), 1), "ftex-rgb"),
        (".ftu", W.ftex_file(93, 70, rng.integers(0, 256, n * 8, dtype=np.uint8).tobytes(), 0),
         "ftex-dxt1"),
        (".blp", W.blp1_file(93, 70, g.tobytes(), 1, 0, 5, pal), "blp1-palette"),
        (".blp", W.blp1_file(77, 61, jpeg[300:], 0, 0, 0, jpeg_header=jpeg[:300]), "blp1-jpeg"),
        (".blp", W.blp2_file(93, 70, dxt5, 2, 8, 7), "blp2-dxt5"),
        (".blp", W.blp2_file(93, 70, g.tobytes(), 1, 0, 0, pal), "blp2-palette"),
        (".icns", W.icns_file([(b"icp6", W.pil_save(Image.fromarray(_smooth(rng, 64, 64, 4)),
                                                    "PNG"))]), "icns-png"),
        (".icns", W.icns_file([(b"ih32", planes)]), "icns-legacy-rgb"),
        (".ras", W.sun_file(93, 70, 24, W.sun_rle(sun_rows[:, :-1].tobytes()), 2), "sun-rle"),
        (".ras", W.sun_file(93, 70, 8, np.pad(g, ((0, 0), (0, 1))).tobytes(), 1,
                            pal[:768]), "sun-palette"),
        (".msp", W.msp_file(np.packbits(g > 99, axis=1), 93, 70), "msp"),
        (".xbm", W.pil_save(Image.fromarray(b[:, :, 0] > 99), "XBM"), "xbm"),
        (".xpm", W.xpm_file(g // 40, a[0, :7, :3], 1), "xpm"),
        (".gbr", W.gbr_file(b), "gbr"),
        (".pxr", W.pixar_file(a[:, :, :3]), "pixar"),
        (".xv", W.xvthumb_file(g), "xvthumb"),
        (".area", W.mcidas_file(g, 1), "mcidas-8"),
        (".area", W.mcidas_file(b[:, :, 0].astype(np.uint16) * 257, 2), "mcidas-16"),
        (".area", W.mcidas_file(g.astype(np.int64) * 3, 4), "mcidas-32"),
        (".imt", W.imt_file(b[:, :, 1]), "imt"),
        (".spi", W.spider_file(g.astype(np.float32) / 2 + 0.25), "spider"),
        (".fits", W.fits_file(g, 8), "fits-8"),
        (".fits", W.fits_file(b[:, :, 0].astype(np.int64) * 300, 16), "fits-16"),
        (".fits", W.fits_file(g.astype(np.int64) * 2 - 40, 32), "fits-32"),
        (".fits", W.fits_file(b[:, :, 2] / 1.5 + 0.5, -32), "fits-float"),
        (".fits", W.fits_gzip_file(g, 8), "fits-gzip"),
    ]


def test_every_original_is_pils():
    for _, data, name in _originals():
        same_as_pil(data)
        assert timage.image_format(data) == Image.open(io.BytesIO(data)).format, name


def _pairs(originals):
    return [(ext, data) for ext, data, _ in originals]


def test_dataset_rows_equal_jax(tmp_path, bpe_dir):
    """Rows, evaluation samples and training examples; where the JAX
    dataset raises on a row (cv2 refuses "1" and "I" rows), the port raises
    too (cv2 refuses "1" and "I" rows, and the HSV draw on a 16-bit one)."""
    originals = _originals()
    tsv = _rows_tsv(tmp_path / "rows.tsv", _pairs(originals))
    raised = []
    for split in ("valid", "train"):
        got_ds, want_ds = _datasets(tsv, bpe_dir, split)
        for i, (_, _, name) in enumerate(originals):
            got_row, want_row = got_ds._decode_row(i), want_ds._decode_row(i)
            for a, b in zip(got_row[:2], want_row[:2]):
                assert a.dtype == b.dtype and np.array_equal(a, b), name
            ga, gb = np.random.default_rng((5, i)), np.random.default_rng((5, i))
            get = ((lambda ds, r: ds.get_eval_sample(i)) if split == "valid"
                   else (lambda ds, r: ds.get_train_example(i, r)))
            try:
                want = get(want_ds, gb)
            except Exception:
                with pytest.raises(Exception):
                    get(got_ds, ga)
                raised.append((split, name))
                continue
            got = get(got_ds, ga)
            fields = (("patch_image", "ori_semantic_seg") if split == "valid"
                      else [k for k in want if k != "id"])
            for f in fields:
                x = getattr(got, f) if split == "valid" else got[f]
                y = getattr(want, f) if split == "valid" else want[f]
                assert x.dtype == y.dtype and np.array_equal(x, y), (split, name, f)
    modes = {name: decode_image(data)[1] for _, data, name in originals}
    # cv2 refuses to resize "1" and "I" rows, and the HSV draw on a row still uint16
    assert {n for n, m in modes.items() if m in ("1", "I")} <= {name for _, name in raised}
    assert {modes[name] for _, name in raised} <= {"1", "I", "I;16", "I;16B"}
    assert {"F", "I;16", "I;16B", "P", "RGBA", "L"} <= set(modes.values())


def test_convert_rows_equal_jax(tmp_path):
    """``cli.convert_dataset`` over the originals PIL's PNG writer takes:
    each row's image in its PNG mode, as the JAX CLI writes it."""
    images, labels = tmp_path / "images", tmp_path / "annotations"
    images.mkdir()
    labels.mkdir()
    originals = [(e, d) for e, d, _ in _originals()
                 if decode_image(d)[1] in ("1", "L", "P", "RGB", "RGBA", "I;16")]
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
    assert [r[2:] for r in got] == [r[2:] for r in want] and len(got) == len(originals) > 15
    for g, w in zip(got, want):
        for col in (0, 1):
            a, b = _pil_row(g[col]), _pil_row(w[col])
            assert a[1] == b[1] and a[0].dtype == b[0].dtype and np.array_equal(a[0], b[0]), g[2]
            assert a[2] == b[2] and a[3] == b[3], g[2]


def test_rows_train_as_their_png_twins(passed_tmp, monkeypatch):
    """One epoch of ``cli.train`` (64 px, 2 rows a batch, fp32, no dropout)
    over rows of eight of the formats, and over the same images as PNG
    rows: the same losses and validation areas."""
    keep = ("bc7", "bc6h-signed", "blp2-dxt5", "icns-png", "sun-rle", "xpm", "gbr", "fits-gzip")
    originals = [(e, d) for e, d, name in _originals() if name in keep]
    tsv = _rows_tsv(passed_tmp / "raw.tsv", originals)
    twins = []
    for line in open(tsv):
        img_b64, seg_b64, uid = line.rstrip("\n").split("\t")
        pixels = decode_image(base64.urlsafe_b64decode(img_b64))[0]
        buf = io.BytesIO()
        Image.fromarray(np.ascontiguousarray(pixels[:, :, :3] if pixels.ndim == 3 else pixels)
                        ).save(buf, "PNG")
        twins.append(f"{base64.urlsafe_b64encode(buf.getvalue()).decode()}\t{seg_b64}\t{uid}\n")
    twin = passed_tmp / "png.tsv"
    twin.write_text("".join(twins))
    tail = ["--max-epoch=1", "--dtype=float32", "--dropout=0.0", "--encoder-drop-path-rate=0.0",
            "--decoder-drop-path-rate=0.0", "--seed=4"]
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


def test_infer_on_each_format_writes_jax_overlay(checkpoint, bpe_dir, tmp_path, monkeypatch):
    """``cli.infer`` (no CRF, no label propagation, fp32) on one file of each
    new format: the overlay and the mask the JAX CLI writes for the same
    file."""
    monkeypatch.setenv("IFSEG_JIT_CACHE", "")
    monkeypatch.setattr(jconfig, "model_config_for_arch",
                        _tiny(jconfig.model_config_for_arch, dtype="float32", **JAX_ONLY))
    monkeypatch.setattr(tinfer, "model_config_for_arch",
                        _tiny(torch_model_config, dtype="float32"))
    seen = set()
    for ext, data, name in _originals():
        fmt = timage.image_format(data)
        if fmt in seen and name not in ("bc6h", "bc6h-signed"):
            continue
        seen.add(fmt)
        image = tmp_path / f"in-{name}{ext}"
        image.write_bytes(data)
        jout, tout = str(tmp_path / f"jax-{name}.png"), str(tmp_path / f"torch-{name}.png")
        # no label propagation: an icon's 2 x 2 grid has fewer cells than its top k
        tail = ["--crf-iters=0", "--resnet-iters=0"]
        jinfer.main(_argv(str(image), checkpoint, bpe_dir, jout)[:-1] + tail)
        result = tinfer.main(_argv(str(image), checkpoint, bpe_dir, tout)[:-1]
                             + tail + ["--device=cpu"])
        np.testing.assert_array_equal(_pixels(tout), _pixels(jout), err_msg=name)
        np.testing.assert_array_equal(_pixels(result["mask"]),
                                      _pixels(str(tmp_path / f"jax-{name}_mask.png")))
    assert len(seen) == 15


def test_serve_request_path_equals_jax(bpe_dir):
    """The daemon's reader and network input (``SegService._preprocess``)
    on a body of each format: the JAX daemon's."""
    for _, data, name in _originals():
        svc = types.SimpleNamespace(size=32)
        got, orig = tserve.SegService._preprocess(svc, data)
        want, want_orig = jserve.SegService._preprocess(svc, data)
        assert orig == want_orig, name
        assert got.dtype == want.dtype and np.array_equal(got, want), name


# ------------------------------------------------------------------ dispatch

def _ambiguous():
    """(name, file) that more than one of PIL's plugins looks at."""
    grey = np.random.default_rng(1).integers(0, 256, (6, 7), dtype=np.uint8)
    sun_1x1 = W.sun_file(1, 1, 24, bytes(4))  # its width is a GIMP brush's version
    spider = W.spider_file(grey.astype(np.float32) / 3)
    imt_then_spider = b"width 7\nheight 6\n" + spider[17:]  # IMT's header but no "pixel n8"
    mcidas = W.mcidas_file(grey, 1)
    return [
        ("gbr-like-sun", sun_1x1),
        ("gbr-v2-without-magic", W.gbr_file(grey, 2).replace(b"GIMP", b"PMIG")),
        ("gbr-zero-width", W.gbr_file(grey[:, :0])),
        ("spider", spider),
        ("imt-header-spider-body", imt_then_spider),
        ("imt", W.imt_file(grey)),
        ("imt-no-form-feed", b"width 7\nheight 6\npixel n8\n" + grey.tobytes()),
        ("mcidas", mcidas),
        ("mcidas-bytes-3-as-tga", mcidas[:40] + (3).to_bytes(4, "big") + mcidas[44:]),
        ("tga-after-failed-pixar", W.pixar_file(grey[:, :, None].repeat(3, 2))[:424]
         + b"\x00\x00"),
        ("msp-bad-checksum", W.msp_file(np.packbits(grey > 9, axis=1), 7, 6)[:24] + b"\1\0"
         + W.msp_file(np.packbits(grey > 9, axis=1), 7, 6)[26:]),
    ]


@pytest.mark.parametrize("name", [n for n, _ in _ambiguous()])
def test_dispatch_names_what_pil_names(name):
    data = dict(_ambiguous())[name]
    try:
        im = Image.open(io.BytesIO(data))
        fmt = im.format
        np.asarray(im)
    except Exception:
        with pytest.raises(ValueError):
            decode_image(data)
        return
    got = timage.image_format(data)
    assert {"Netpbm": "PPM", "JPEG 2000": "JPEG2000"}.get(got, got).upper() == fmt.upper()
    same_as_pil(data, fmt)


def test_other_formats_are_what_pil_opens_and_the_port_does_not():
    """PIL's ``Image.ID`` as ``Image.init`` registers the plugins in a fresh
    interpreter (a process's earlier imports change its order)."""
    ids = subprocess.run([sys.executable, "-c", "from PIL import Image; Image.init(); "
                          "print(' '.join(Image.ID))"], capture_output=True, text=True,
                         check=True).stdout.split()
    read = {"Netpbm": "PPM", "JPEG 2000": "JPEG2000"}
    ported = {read.get(n, n).upper() for n in timage._READ}
    others = {n.split(" ")[0].split("/")[0].upper() for n in timage._OTHER_FORMATS}
    # IPTC has no signature; JBIG2 and BigTIFF are no plugin of PIL's; WMF's
    # entry names EMF too
    assert set(ids) - ported - {"IPTC"} == others - {"JBIG2", "BIGTIFF"}
    assert ported <= set(ids)
    order = [n for n in ids if n in ported]
    assert [read.get(n, n).upper() for n in timage._READ] == order


@pytest.mark.parametrize("ext", sorted(tinfer.REFUSED))
def test_infer_refuses_the_new_extensions_naming_why(ext, tmp_path):
    """``--output`` of a format the port reads but does not write raises
    before the model loads, and PIL cannot write the overlay there either
    (no writer, or one that refuses RGB), but for ICNS, whose thumbnail
    encoder the port lacks."""
    with pytest.raises(ValueError, match=f"reads \\{ext} files but does not write them"):
        tinfer.writer_extension(f"overlay{ext}")
    Image.init()
    fmt = Image.EXTENSION[ext]
    overlay = Image.fromarray(np.zeros((8, 8, 3), np.uint8))
    if ext == ".icns":
        overlay.save(tmp_path / f"o{ext}")  # PIL's thumbnails
        return
    if fmt in Image.SAVE:
        with pytest.raises((OSError, ValueError)):
            overlay.save(tmp_path / f"o{ext}")
    else:
        assert "writer" in tinfer.REFUSED[ext]
