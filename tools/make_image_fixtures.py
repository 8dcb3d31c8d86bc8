"""Write the image files of ``tests/torch_image_files/`` and their
``digests.json``: for each file, PIL's mode, the shape of
``np.asarray(Image.open(...))`` and the SHA-256 of those pixels and of
``np.asarray(Image.open(...).convert("RGB"))`` (``ifseg_torch.data.image.image_digest``).

``chip_smoke.py`` phase 14e decodes every file with the port and holds it to
these digests on the card's machine, where the port reads no PIL;
``tests/test_torch_image_files.py::test_fixture_digests_are_pils`` recomputes
them with PIL.  The files come from seeded arrays through PIL's writers and
``tests/torch_image_writers.py``: GIF (interlaced, local palette with a
transparency index, a full LZW table without a clear code, an animation, the
gray ramp), BMP (core header, RLE4, RLE8, 5-6-5 bitfields, 24-bit, 32-bit
BGRA in a V5 header, 1-bit top-down), TIFF (uncompressed, LZW with the
predictor big-endian, Deflate tiles, PackBits planar, 1-bit, 16-bit,
palette, CMYK) and JPEG (CMYK, YCCK, CMYK without the Adobe marker, a
progressive file whose later scans are dropped, a cut progressive YCCK file
that libjpeg-turbo block-smooths, a CMYK file of 1,024 x 1,366).  Needs PIL; run from the repository root:

  python tools/make_image_fixtures.py
"""

import io
import json
import sys
from pathlib import Path

import numpy as np
from PIL import Image, ImageFile

REPO = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(REPO), str(REPO / "tests")]
import torch_image_writers as W  # noqa: E402
from ifseg_torch.data.image import image_digest  # noqa: E402

OUT = REPO / "tests" / "torch_image_files"


def _smooth(rng, h, w, c=3):
    base = rng.integers(0, 255, (h // 8 + 2, w // 8 + 2, c)).astype(np.float64)
    ys = np.linspace(0, base.shape[0] - 1.01, h)
    xs = np.linspace(0, base.shape[1] - 1.01, w)
    y0, x0 = ys.astype(int), xs.astype(int)
    fy, fx = (ys - y0)[:, None, None], (xs - x0)[None, :, None]
    img = (base[y0][:, x0] * (1 - fy) * (1 - fx) + base[y0 + 1][:, x0] * fy * (1 - fx)
           + base[y0][:, x0 + 1] * (1 - fy) * fx + base[y0 + 1][:, x0 + 1] * fy * fx)
    img = np.clip(img + rng.normal(0, 4, img.shape), 0, 255).astype(np.uint8)
    return img if c > 1 else img[:, :, 0]


def files():
    rng = np.random.default_rng(16)
    big = _smooth(rng, 192, 256)
    mid = _smooth(rng, 120, 160)
    small = _smooth(rng, 37, 45)
    cmyk_big = np.dstack([big, _smooth(rng, 192, 256, 1)])
    pal16 = rng.integers(0, 256, (16, 3))
    out = {}
    # GIF
    out["gif_pil_interlaced_256x192.gif"] = W.pil_save(Image.fromarray(big), "GIF")
    out["gif_local_palette_transparency.gif"] = W.gif_file(
        [dict(indices=rng.integers(0, 16, (29, 33)), bits=4, palette=pal16, transparency=6, x=3,
              y=2, interlace=1)], (40, 36), global_palette=pal16[::-1])
    out["gif_full_table_no_clear.gif"] = W.gif_file(
        [dict(indices=rng.integers(0, 256, (60, 90)), clear_every=None)], (90, 60),
        global_palette=rng.integers(0, 256, (256, 3)))
    out["gif_animated.gif"] = W.pil_save(Image.fromarray(small).quantize(32), "GIF", save_all=True,
                                         append_images=[Image.fromarray(small[::-1]).quantize(32)])
    out["gif_gray_ramp.gif"] = W.pil_save(Image.fromarray(small[:, :, 0]), "GIF")
    # BMP
    out["bmp_core_8bit.bmp"] = W.bmp_file(rng.integers(0, 256, (21, 30)), 8, 12,
                                          rng.integers(0, 256, (256, 3)))
    runs = np.repeat(rng.integers(0, 16, (40, 12)), 5, axis=1)[:, :57]
    runs[:, 40:] = rng.integers(0, 16, (40, 17))
    out["bmp_rle4.bmp"] = W.bmp_file(runs, 4, 40, pal16, compression=2)
    out["bmp_rle8.bmp"] = W.bmp_file(runs * 13, 8, 40, rng.integers(0, 256, (256, 3)),
                                     compression=1)
    out["bmp_bitfields_565.bmp"] = W.bmp_file(small, 16, 40, compression=3,
                                              masks=(0xF800, 0x7E0, 0x1F))
    out["bmp_pil_24bit_160x120.bmp"] = W.pil_save(Image.fromarray(mid), "BMP")
    out["bmp_bgra_v5.bmp"] = W.bmp_file(np.dstack([small, small[:, :, 0]]), 32, 124, compression=3,
                                        masks=(0xFF0000, 0xFF00, 0xFF, 0xFF000000))
    out["bmp_1bit_top_down.bmp"] = W.bmp_file(small[:, :, 0] > 120, 1, 40, [[10, 20, 30], [250, 0, 9]],
                                              top_down=True)
    # TIFF
    out["tiff_pil_rgb_160x120.tif"] = W.pil_save(Image.fromarray(mid), "TIFF")
    out["tiff_lzw_predictor_big_endian.tif"] = W.tiff_file(small, 8, 2, "MM", 5, 2, rows_per_strip=8)
    out["tiff_deflate_tiles.tif"] = W.tiff_file(np.dstack([small, small[:, :, 1]]), 8, 2, "II", 8, 2,
                                                tile=(16, 16), extra=(2,))
    out["tiff_packbits_planar.tif"] = W.tiff_file(small, 8, 2, "II", 32773, planar=2,
                                                  rows_per_strip=10)
    out["tiff_1bit_min_is_white.tif"] = W.tiff_file(small[:, :, 0] > 99, 1, 0, "II", 32773)
    out["tiff_16bit_gray.tif"] = W.pil_save(
        Image.fromarray(small[:, :, 0].astype(np.uint16) * 257), "TIFF", compression="tiff_lzw")
    out["tiff_palette.tif"] = W.pil_save(Image.fromarray(small).quantize(40), "TIFF",
                                         compression="tiff_adobe_deflate")
    out["tiff_cmyk.tif"] = W.pil_save(Image.fromarray(np.dstack([small, small[:, :, 2]]), "CMYK"),
                                      "TIFF", compression="packbits")
    # JPEG
    cmyk = W.pil_save(Image.fromarray(cmyk_big, "CMYK"), "JPEG", quality=80)
    out["jpeg_cmyk_256x192.jpg"] = cmyk
    out["jpeg_ycck.jpg"] = W.ycck_jpeg(W.pil_save(Image.fromarray(np.dstack([small, small[:, :, 0]]),
                                                                  "CMYK"), "JPEG"))
    out["jpeg_cmyk_no_adobe.jpg"] = W.without_adobe(
        W.pil_save(Image.fromarray(np.dstack([small, small[:, :, 1]]), "CMYK"), "JPEG"))
    prog = W.pil_save(Image.fromarray(big), "JPEG", quality=85, progressive=True)
    scans = [i for i in range(len(prog) - 1) if prog[i:i + 2] == b"\xff\xda"]
    out["jpeg_progressive_smoothed_256x192.jpg"] = prog[:scans[3]] + b"\xff\xd9"
    ycck_prog = W.ycck_jpeg(W.pil_save(Image.fromarray(np.dstack([mid, mid[:, :, 0]]), "CMYK"),
                                       "JPEG", progressive=True))
    scans = [i for i in range(len(ycck_prog) - 1) if ycck_prog[i:i + 2] == b"\xff\xda"]
    out["jpeg_ycck_progressive_cut.jpg"] = ycck_prog[:(scans[4] + scans[5]) // 2]
    # one file at the largest size the JAX CLIs' originals take (phase 14's
    # 1,024 x 1,366): flat blocks of 32 pixels and grain of 0..3, as phase
    # 14's JPEG originals
    blocks = np.random.default_rng(1366)
    full = np.repeat(np.repeat(blocks.integers(0, 252, (33, 44, 4)), 32, 0), 32, 1)[:1024, :1366]
    full = (full + blocks.integers(0, 4, full.shape)).astype(np.uint8)
    out["jpeg_cmyk_1024x1366.jpg"] = W.pil_save(Image.fromarray(full, "CMYK"), "JPEG")
    return out


def main():
    ImageFile.LOAD_TRUNCATED_IMAGES = True  # the JAX package's setting: the cut file decodes
    OUT.mkdir(exist_ok=True)
    table = {}
    for name, data in sorted(files().items()):
        (OUT / name).write_bytes(data)
        im = Image.open(io.BytesIO(data))
        pixels = np.asarray(im)
        table[name] = {"mode": im.mode, "shape": list(pixels.shape),
                       "pixels": image_digest(pixels),
                       "rgb": image_digest(np.asarray(im.convert("RGB")))}
    (OUT / "digests.json").write_text(json.dumps(table, indent=1, sort_keys=True) + "\n")
    total = sum(len(d) for d in files().values())
    print(f"wrote {len(table)} files, {total} bytes, to {OUT}")


if __name__ == "__main__":
    main()
