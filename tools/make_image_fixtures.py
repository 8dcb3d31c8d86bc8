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
that libjpeg-turbo block-smooths, a CMYK file of 1,024 x 1,366) and WebP
(lossy at several sizes, qualities and methods, one of 1,024 x 1,366; one
and four segments, four token partitions, the simple and the normal loop
filter, sharpness 5; lossless palettes of 2, 4, 16 and 256 colours (the
last two and the 1,024 x 1,366 file with a colour cache, the others without),
an ``exact`` RGBA file; lossy + alpha with a raw ``ALPH`` chunk whose filter byte is set to
each of 0 to 3, and with a lossless one; ``VP8X`` with ICCP / EXIF / XMP;
RGB and RGBA animations and a crafted one whose first frame is smaller
than the canvas, at an offset) and JPEG 2000 (JP2 and raw codestreams: each
mode PIL's writer takes, both wavelets, the five progressions, tiles at
offsets, precincts, code-blocks, quality layers by rate and PSNR, PLT; by
hand around PIL's codestreams a ``pclr`` palette, tile-parts with and
without their count, 4-, 12-bit and signed precisions, a cut and a flipped
byte; a 5/3 and a 9/7 file of 1,024 x 1,366) and, small, ICO (PIL's PNG
entries; bitmap entries at 1 to 32 bits with AND masks), CUR, PSD (each row
of PIL's ``MODES``, raw and PackBits, an ICC resource, a layer section) and
Netpbm (each magic number of PIL's table, plain and raw, maxvals 100, 1000
and 65535, PFM in both byte orders).  The WebP files PIL's ``save``
cannot make come from ``torch_image_writers.webp_encode`` (the libwebp PIL
bundles).
Needs PIL; run from the repository root:

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


def _smooth(rng, h, w, c=3, noise=4):
    base = rng.integers(0, 255, (h // 8 + 2, w // 8 + 2, c)).astype(np.float64)
    ys = np.linspace(0, base.shape[0] - 1.01, h)
    xs = np.linspace(0, base.shape[1] - 1.01, w)
    y0, x0 = ys.astype(int), xs.astype(int)
    fy, fx = (ys - y0)[:, None, None], (xs - x0)[None, :, None]
    img = (base[y0][:, x0] * (1 - fy) * (1 - fx) + base[y0 + 1][:, x0] * fy * (1 - fx)
           + base[y0][:, x0 + 1] * (1 - fy) * fx + base[y0 + 1][:, x0 + 1] * fy * fx)
    img = np.clip(img + rng.normal(0, noise, img.shape), 0, 255).astype(np.uint8)
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
    out.update(webp_files())
    out.update(jpeg2000_files())
    out.update(icon_psd_netpbm_files())
    return out


def webp_files():
    rng = np.random.default_rng(17)
    small = _smooth(rng, 37, 45)
    mid = _smooth(rng, 80, 96)
    big = _smooth(rng, 192, 256)
    rgba = np.dstack([small, _smooth(rng, 37, 45, 1)])
    out = {}
    # lossy, through PIL's writer
    out["webp_lossy_1x1.webp"] = W.pil_save(Image.fromarray(small[:1, :1]), "WEBP", quality=80)
    out["webp_lossy_17x9_q10_m0.webp"] = W.pil_save(Image.fromarray(small[:9, :17]), "WEBP",
                                                    quality=10, method=0)
    out["webp_lossy_45x37_q95_m6.webp"] = W.pil_save(Image.fromarray(small), "WEBP", quality=95,
                                                     method=6)
    out["webp_lossy_256x192.webp"] = W.pil_save(Image.fromarray(big), "WEBP")
    # the encoder settings PIL's writer does not expose
    out["webp_lossy_4_segments_4_partitions_sharpness_5.webp"] = W.webp_encode(
        mid, quality=60, method=0, segments=4, partitions=2, filter_type=1, filter_strength=80,
        filter_sharpness=5)
    out["webp_lossy_1_segment_simple_filter.webp"] = W.webp_encode(
        mid, quality=40, segments=1, filter_type=0, filter_strength=70)
    # lossless: palettes (pixel bundling at <= 2, 4 and 16 colours), exact RGBA
    for colours in (2, 4, 16, 256):
        im = Image.fromarray(mid).quantize(colours).convert("RGB")
        out[f"webp_lossless_palette_{colours}.webp"] = W.pil_save(im, "WEBP", lossless=True)
    out["webp_lossless_rgba_exact.webp"] = W.pil_save(
        Image.fromarray(rgba, "RGBA"), "WEBP", lossless=True, exact=True)
    out["webp_lossless_rgb_no_cache.webp"] = W.pil_save(Image.fromarray(small), "WEBP",
                                                        lossless=True, quality=0, method=0)
    # lossy + alpha: raw ALPH with each filter byte, and lossless ALPH
    raw = W.webp_encode(rgba, quality=70, alpha_compression=0, alpha_filtering=0)
    for f in range(4):
        out[f"webp_alpha_raw_filter_{f}.webp"] = W.with_alpha_filter(raw, f)
    out["webp_alpha_lossless.webp"] = W.webp_encode(rgba, quality=70, alpha_compression=1,
                                                    alpha_filtering=2)
    out["webp_vp8x_iccp_exif_xmp.webp"] = W.pil_save(
        Image.fromarray(small), "WEBP", quality=70, icc_profile=bytes(range(48)),
        exif=b"Exif\x00\x00" + bytes(20), xmp=b"<x:xmpmeta/>")
    # animations: PIL's writer, and a first frame smaller than the canvas
    frames = [Image.fromarray(small), Image.fromarray(small[::-1])]
    out["webp_animated_rgb.webp"] = W.pil_save(frames[0], "WEBP", save_all=True,
                                               append_images=frames[1:], quality=60)
    frames = [Image.fromarray(rgba, "RGBA"), Image.fromarray(rgba[:, ::-1], "RGBA")]
    out["webp_animated_rgba.webp"] = W.pil_save(frames[0], "WEBP", save_all=True,
                                                append_images=frames[1:], quality=60)
    first = W.pil_save(Image.fromarray(small[:20, :30]), "WEBP", quality=60)
    second = W.pil_save(Image.fromarray(small), "WEBP", quality=60)
    out["webp_animated_offset_frame.webp"] = W.webp_animation(
        [(first, 6, 10), (second, 0, 0)], (64, 48), alpha=False)
    # the largest size the JAX CLIs' originals take, lossy and lossless
    blocks = np.random.default_rng(1367)
    full = np.repeat(np.repeat(blocks.integers(0, 252, (33, 44, 3)), 32, 0), 32, 1)[:1024, :1366]
    ramp = (np.arange(1366)[None, :, None] // 6 + np.arange(1024)[:, None, None] // 8) % 40
    full = (full // 2 + ramp).astype(np.uint8)
    out["webp_lossy_1024x1366.webp"] = W.pil_save(Image.fromarray(full), "WEBP", quality=70)
    out["webp_lossless_1024x1366.webp"] = W.pil_save(Image.fromarray(full), "WEBP", lossless=True)
    return out


def jpeg2000_files():
    rng = np.random.default_rng(19)
    small = _smooth(rng, 37, 45, noise=1)
    mid = _smooth(rng, 30, 40, noise=1)
    gray16 = (_smooth(rng, 33, 29, 1).astype(np.uint16) * 257 + rng.integers(0, 257, (33, 29)))
    def jp2(arr, mode=None, **kw):
        return W.pil_save(Image.fromarray(arr, mode), "JPEG2000", **kw)

    def j2k(arr, mode=None, **kw):
        return jp2(arr, mode, no_jp2=True, **kw)

    out = {}
    # each mode PIL's writer takes, JP2 and raw codestreams, both wavelets
    out["j2k_l_45x37.j2k"] = j2k(small[:, :, 0])
    out["jp2_la_irreversible.jp2"] = jp2(small[:, :, :2], "LA", irreversible=True)
    out["jp2_rgba_tiles_offsets.jp2"] = jp2(np.dstack([small, small[:, :, 0]]), "RGBA",
                                            tile_size=(16, 16), offset=(5, 3), tile_offset=(2, 1))
    out["jp2_i16_29x33.jp2"] = jp2(gray16.astype(np.uint16), "I;16")
    out["jp2_cmyk_irreversible.jp2"] = jp2(np.dstack([small, small[:, :, 1]]), "CMYK",
                                           irreversible=True)
    out["j2k_rgb_irreversible_mct_17x9.j2k"] = j2k(small[:9, :17], irreversible=True, mct=1)
    out["j2k_rgb_1x1.j2k"] = j2k(small[:1, :1])
    # progressions, precincts, code-blocks, layers, resolutions, PLT, signed
    out["j2k_rgb_rpcl_precincts.j2k"] = j2k(mid, progression="RPCL", precinct_size=(16, 16),
                                            codeblock_size=(8, 8), num_resolutions=4)
    out["j2k_rgb_pcrl_layers_db.j2k"] = j2k(mid, progression="PCRL", quality_mode="dB",
                                            quality_layers=[28, 34, 40], irreversible=True)
    out["j2k_rgb_cprl_plt.j2k"] = j2k(mid, progression="CPRL", plt=True, tile_size=(24, 20))
    out["j2k_rgb_rlcp_signed_rates.j2k"] = j2k(mid, progression="RLCP", signed=True,
                                               quality_layers=[40, 10], quality_mode="rates")
    out["j2k_rgb_one_resolution_no_mct.j2k"] = j2k(mid, num_resolutions=1, mct=0)
    # written by hand around PIL's codestreams: a palette (pclr), tile-parts
    # with and without their count, other precisions, a cut and a flipped byte
    out["jp2_palette.jp2"] = W.jp2_palette(jp2(small[:, :, 0] // 16), rng.integers(0, 256, (16, 3)))
    tiled = j2k(mid, tile_size=(16, 12))
    out["j2k_tile_parts.j2k"] = W.j2k_tile_parts(tiled, 3)
    out["j2k_tile_parts_no_count.j2k"] = W.j2k_tile_parts(tiled, 2, count=False)
    out["j2k_12bit.j2k"] = W.j2k_precision(j2k(small[:, :, 0]), 12)
    out["j2k_4bit_signed.j2k"] = W.j2k_precision(j2k(small[:, :, 0], signed=True), 4)
    out["j2k_cut_tiles.j2k"] = tiled[:len(tiled) * 3 // 5]
    flipped = bytearray(tiled)
    flipped[len(tiled) // 2] ^= 0x5A
    out["j2k_flipped_byte.j2k"] = bytes(flipped)
    # the largest size the JAX CLIs' originals take, each wavelet, cut to a rate
    blocks = np.random.default_rng(1368)
    full = np.repeat(np.repeat(blocks.integers(0, 252, (33, 44, 3)), 32, 0), 32, 1)[:1024, :1366]
    ramp = (np.arange(1366)[None, :, None] // 6 + np.arange(1024)[:, None, None] // 8) % 40
    full = (full // 2 + ramp).astype(np.uint8)
    out["jp2_rgb_reversible_1024x1366.jp2"] = jp2(full, quality_layers=[400])
    out["jp2_rgb_irreversible_1024x1366.jp2"] = jp2(full, irreversible=True,
                                                    quality_layers=[800, 400])
    return out


def icon_psd_netpbm_files():
    """Small files (the fixtures' budget is 512 KiB): ICO and CUR, PSD in each
    row of PIL's ``MODES``, Netpbm in each magic number of PIL's table."""
    rng = np.random.default_rng(20)
    small = _smooth(rng, 9, 11)
    mask = _smooth(rng, 9, 11, 1) > 128
    pal = rng.integers(0, 256, (256, 3))
    planes = np.moveaxis(np.dstack([small, _smooth(rng, 9, 11, 1)]), 2, 0)  # 4 channels
    out = {}
    # ICO: PIL's writer (PNG entries of three sizes), bitmap entries by hand
    # at 1, 4, 8, 24 and 32 bits with AND masks; CUR
    out["ico_pil_png_sizes.ico"] = W.pil_save(Image.fromarray(np.dstack([small, small[:, :, 0]]),
                                                              "RGBA"), "ICO", sizes=[(9, 9), (4, 4)])
    out["ico_dib_1_4_8_24_bits.ico"] = W.ico_file(
        [(W.dib(small[:, :, 0] > 99, 1, pal[:2], mask), dict(width=11, height=9, bits=1)),
         (W.dib(small[:, :, 1] % 16, 4, pal[:16], mask), dict(width=11, height=9, bits=4)),
         (W.dib(small[:, :, 2], 8, pal, mask), dict(width=11, height=9, bits=8)),
         (W.dib(small, 24, None, mask), dict(width=11, height=9, bits=24))])
    out["ico_dib_32bit_alpha.ico"] = W.ico_file(
        [(W.dib(np.dstack([small, small[:, :, 1]]), 32, None, mask),
          dict(width=11, height=9, bits=32))])
    out["cur_24bit.cur"] = W.ico_file([(W.dib(small, 24, None, mask), dict(width=11, height=9))],
                                      kind=2)
    out["cur_32bit_bgra.cur"] = W.ico_file(
        [(W.dib(np.dstack([small, small[:, :, 2]]), 32, None, mask), dict(width=11, height=9))],
        kind=2)
    # PSD: each row of MODES, raw (0) and PackBits (1), resources, a layer
    resources = [(1039, b"icc", bytes(range(24))), (1005, b"res", bytes(16))]
    for name, plane_set, colour, bits, comp, kw in (
            ("bitmap_1bit_rle", planes[:1] > 128, 0, 1, 1, {}),
            ("bitmap_8bit", planes[:1], 0, 8, 0, {}),
            ("grey_rle_icc", planes[:1], 1, 8, 1, dict(resources=resources)),
            ("indexed", planes[:1], 2, 8, 0, dict(palette=pal)),
            ("rgb_rle", planes[:3], 3, 8, 1, {}),
            ("rgba_layer", planes, 3, 8, 0, dict(layers=W.psd_layer_section(planes[:3, :4, :5]))),
            ("cmyk_rle", planes, 4, 8, 1, {}),
            ("multichannel", planes[:3], 7, 8, 0, {}),
            ("duotone_rle", planes[:1], 8, 8, 1, {}),
            ("lab_rle", planes[:3], 9, 8, 1, {})):
        out[f"psd_{name}.psd"] = W.psd_file(plane_set, colour, bits, comp, **kw)
    # Netpbm: each magic number, PIL's writer where it has one
    grey, rgba = small[:, :, 0], np.dstack([small, small[:, :, 1]])
    out["pbm_plain.pbm"] = W.netpbm_file(b"P1", grey > 120)
    out["pgm_plain_maxval_1000.pgm"] = W.netpbm_file(b"P2", grey.astype(int) * 3, maxval=1000)
    out["ppm_plain.ppm"] = W.netpbm_file(b"P3", small, comment=b"plain")
    out["pbm_pil.pbm"] = W.pil_save(Image.fromarray(grey > 120), "PPM")
    out["pgm_pil.pgm"] = W.pil_save(Image.fromarray(grey), "PPM")
    out["pgm_16bit_pil.pgm"] = W.pil_save(Image.fromarray(grey.astype(np.uint16) * 257), "PPM")
    out["ppm_pil.ppm"] = W.pil_save(Image.fromarray(small), "PPM")
    out["ppm_maxval_100.ppm"] = W.netpbm_file(b"P6", small.astype(int) * 100 // 255, maxval=100)
    out["pfm_pil.pfm"] = W.pil_save(Image.fromarray(grey.astype(np.float32) / 3 - 9), "PPM")
    out["pfm_big_endian.pfm"] = W.netpbm_file(b"Pf", grey.astype(np.float32) / 7, scale=2.0)
    out["netpbm_p0cmyk.pnm"] = W.netpbm_file(b"P0CMYK", rgba)
    out["netpbm_pyp.pnm"] = W.netpbm_file(b"PyP", grey)
    out["netpbm_pyrgba.pnm"] = W.netpbm_file(b"PyRGBA", rgba)
    out["netpbm_pycmyk.pnm"] = W.netpbm_file(b"PyCMYK", rgba)
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
