"""``ifseg_torch.cli.convert_dataset`` against ``ifseg_tpu.cli.convert_dataset``
in all four modes, over a directory of originals made from a seed: JPEG
files (gray, RGB at 4:2:0 and 4:4:4, progressive) and PNG files (RGB, gray,
palette, RGBA, gray + alpha, 16-bit gray), label PNGs with every raw value
the maps touch, and one annotation without an image.

Held exactly: the same rows in the same order with the same ids and line
ids; each row's image and label decoded by PIL (what the JAX package's
reader does) and by ``decode_png`` (the port's reader) are the same arrays
for both TSVs.  The PNG bytes themselves are not compared (another zlib
stream).  A CMYK original makes both CLIs fail.  The label maps are the JAX
module's, entry for entry.
"""

import base64
import io

import numpy as np
import pytest
from PIL import Image

import ifseg_tpu.cli.convert_dataset as jconvert
from ifseg_torch.cli import convert_dataset as tconvert
from ifseg_torch.data.png import decode_png
import torch_port_utils  # noqa: F401,E402  (pins torch's threads under xdist)

MODES = ["ade", "coco_fine", "coco_unseen", "generic"]


def _save(img: Image.Image, path, **kw):
    img.save(path, **kw)


@pytest.fixture(scope="module")
def originals(tmp_path_factory):
    root = tmp_path_factory.mktemp("originals")
    images, labels = root / "images", root / "annotations"
    images.mkdir()
    labels.mkdir()
    rng = np.random.default_rng(0)
    shapes = [(37, 52), (64, 48), (20, 33), (41, 41), (30, 70), (25, 19), (48, 64), (33, 40),
              (17, 26), (50, 37)]
    for i, (h, w) in enumerate(shapes):
        rgb = rng.integers(0, 256, size=(h // 4 + 1, w // 4 + 1, 3), dtype=np.uint8)
        rgb = np.repeat(np.repeat(rgb, 4, 0), 4, 1)[:h, :w]
        stem = f"img_{i:03d}"
        kind = i % 10
        if kind == 0:
            _save(Image.fromarray(rgb), images / f"{stem}.jpg", quality=90)
        elif kind == 1:
            _save(Image.fromarray(rgb[:, :, 0]), images / f"{stem}.jpg")
        elif kind == 2:
            _save(Image.fromarray(rgb), images / f"{stem}.jpeg", subsampling=0, progressive=True)
        elif kind == 3:
            _save(Image.fromarray(rgb), images / f"{stem}.png")
        elif kind == 4:
            _save(Image.fromarray(rgb[:, :, 1]), images / f"{stem}.png")
        elif kind == 5:
            pal = Image.fromarray(rgb).convert("P", palette=Image.ADAPTIVE, colors=12)
            _save(pal, images / f"{stem}.png")
        elif kind == 6:
            rgba = np.dstack([rgb, rng.integers(0, 256, size=(h, w), dtype=np.uint8)])
            _save(Image.fromarray(rgba), images / f"{stem}.png")
        elif kind == 7:
            _save(Image.fromarray(rgb[:, :, :2], "LA"), images / f"{stem}.png")
        elif kind == 8:
            _save(Image.fromarray(rgb[:, :, 0].astype(np.uint16) * 257), images / f"{stem}.png")
        # kind 9: no image, the annotation gives no row
        raw = rng.integers(0, 256, size=(h // 8 + 1, w // 8 + 1)).astype(np.uint8)
        raw[0, 0], raw[-1, -1] = 150, 255
        raw = np.repeat(np.repeat(raw, 8, 0), 8, 1)[:h, :w]
        _save(Image.fromarray(raw), labels / f"{stem}.png")
    return images, labels


def _rows(path):
    return [line.rstrip("\n").split("\t") for line in open(path)]


def _both_readers(b64: str):
    data = base64.urlsafe_b64decode(b64)
    via_pil, via_port = np.asarray(Image.open(io.BytesIO(data))), decode_png(data)
    assert via_pil.dtype == via_port.dtype
    np.testing.assert_array_equal(via_pil, via_port)
    return via_port


@pytest.mark.parametrize("mode", MODES)
def test_rows_decode_as_the_jax_clis(mode, originals, tmp_path):
    images, labels = originals
    args = [f"--mode={mode}", f"--images={images}", f"--annotations={labels}", "--workers=2"]
    jax_out, torch_out = tmp_path / "jax.tsv", tmp_path / "torch.tsv"
    jconvert.main(args + [f"--output={jax_out}"])
    assert tconvert.main(args + [f"--output={torch_out}"]) == 9
    want, got = _rows(jax_out), _rows(torch_out)
    assert [r[2:] for r in got] == [r[2:] for r in want]
    assert [r[3] for r in got] == [str(i) for i in (1, 2, 3, 4, 5, 6, 7, 8, 9)]
    for g, w in zip(got, want):
        for col in (0, 1):
            a, b = _both_readers(g[col]), _both_readers(w[col])
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_a_cmyk_original_fails_both(tmp_path):
    images, labels = tmp_path / "images", tmp_path / "annotations"
    images.mkdir()
    labels.mkdir()
    cmyk = np.random.default_rng(1).integers(0, 256, size=(16, 24, 4), dtype=np.uint8)
    Image.fromarray(cmyk, "CMYK").save(images / "a.jpg")
    Image.fromarray(np.zeros((16, 24), np.uint8)).save(labels / "a.png")
    args = ["--mode=ade", f"--images={images}", f"--annotations={labels}", "--workers=1"]
    with pytest.raises(OSError, match="CMYK"):
        jconvert.main(args + [f"--output={tmp_path / 'jax.tsv'}"])
    with pytest.raises(ValueError, match="CMYK"):
        tconvert.main(args + [f"--output={tmp_path / 'torch.tsv'}"])
    assert not (tmp_path / "jax.tsv").exists() and not (tmp_path / "torch.tsv").exists()


@pytest.mark.parametrize("mode", MODES)
def test_label_maps_are_the_jax_ones(mode):
    assert tconvert.MAPS[mode]() == jconvert.MAPS[mode]()


def _no_compiler():
    """A worker's initializer: any process it starts raises."""
    import subprocess

    def refuse(*args, **kwargs):
        raise AssertionError("a worker started a process (a compiler)")

    subprocess.Popen = refuse


def test_workers_only_load_the_codecs_the_parent_built(tmp_path, originals, monkeypatch):
    """The parent builds and loads the codecs before the pool starts; the
    pool is a spawn one, whose workers may start no process (no compiler)
    and still convert every row."""
    import multiprocessing

    from ifseg_torch.data import jpeg, png

    images, labels = originals
    methods = []

    class Context:
        def Pool(self, n):
            assert jpeg._decoder.cache_info().currsize == 1
            assert png._lib.cache_info().currsize == 1
            return multiprocessing.get_context(methods[-1]).Pool(n, initializer=_no_compiler)

    monkeypatch.setattr(tconvert, "get_context", lambda method: methods.append(method) or Context())
    rows = tconvert.main(["--mode=generic", f"--images={images}", f"--annotations={labels}",
                          "--workers=2", f"--output={tmp_path / 'a.tsv'}"])
    assert methods == ["spawn"] and rows == 9


def test_phase_14_rows_are_the_jax_clis(tmp_path):
    """chip_smoke.py phase 14's originals (PIL's JPEG files, which the port's
    encoder writes byte for byte, and the label PNGs), through both CLIs:
    every row decodes to the digests the script pins."""
    import chip_smoke

    images, labels = tmp_path / "images", tmp_path / "annotations"
    images.mkdir()
    labels.mkdir()
    for i, spec in enumerate(chip_smoke.JPEG_CASES):
        _save(Image.fromarray(chip_smoke.jpeg_original(spec)), images / f"ade_{i:03d}.jpg",
              quality=spec[3], subsampling=spec[4])
        _save(Image.fromarray(chip_smoke.jpeg_label(spec)), labels / f"ade_{i:03d}.png")
    args = ["--mode=ade", f"--images={images}", f"--annotations={labels}", "--workers=4"]
    jconvert.main(args + [f"--output={tmp_path / 'jax.tsv'}"])
    tconvert.main(args + [f"--output={tmp_path / 'torch.tsv'}"])
    want = [(d[1], lab) for d, lab in zip(chip_smoke.JPEG_DIGESTS, chip_smoke.JPEG_LABEL_DIGESTS)]
    for name in ("jax.tsv", "torch.tsv"):
        rows = _rows(tmp_path / name)
        assert [r[2] for r in rows] == [f"ade_{i:03d}" for i in range(len(want))]
        got = [tuple(chip_smoke.row_digest(_both_readers(r[c])) for c in (0, 1)) for r in rows]
        assert got == want, name
