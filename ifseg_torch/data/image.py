"""Image files decoded as PIL 12.1 decodes them: PNG (``data/png.py``), JPEG
(``data/jpeg.py``), GIF (``data/gif.py``), BMP and a headerless DIB
(``data/bmp.py``), TIFF (``data/tiff.py``), WebP (``data/webp.py``), JPEG
2000, JP2 files and raw codestreams (``data/jpeg2000.py``), ICO and CUR
(``data/ico.py``), Netpbm, PBM, PGM, PPM and PFM (``data/ppm.py``), PSD
(``data/psd.py``), TGA (``data/tga.py``), SGI (``data/sgi.py``), QOI
(``data/qoi.py``), PCX and DCX (``data/pcx.py``), IM (``data/im.py``), DDS
with BC1-BC7 blocks (``data/dds.py``), FTEX (``data/ftex.py``), BLP1 and
BLP2 (``data/blp.py``), ICNS (``data/icns.py``), SUN (``data/sun.py``), MSP
(``data/msp.py``), XBM (``data/xbm.py``), XPM (``data/xpm.py``), GBR
(``data/gbr.py``), PIXAR (``data/pixar.py``), XVThumb (``data/xvthumb.py``),
McIdas (``data/mcidas.py``), IMT (``data/imt.py``), SPIDER
(``data/spider.py``) and FITS (``data/fits.py``).  The formats are tried in
the order of PIL's ``Image.ID`` (``_ORDER``); those with no signature or a
weak one (GBR, IM, IMT, McIdas, MSP, PIXAR, SPIDER, SUN, TGA, XBM) are named
only once their header parses as PIL's ``_open`` parses it, so a file that
fails one plugin's ``_open`` falls through to the next, as in PIL.

``decode_image(data)`` returns ``(pixels, mode, palette)``: the pixels as
``np.asarray(PIL.Image.open(BytesIO(data)))`` gives them, PIL's mode name
("1", "L", "P", "I", "I;16", "I;16L", "I;16B", "F", "LA", "PA", "RGB",
"RGBA", "CMYK", "YCbCr" or "LAB") and, for a palette image, its palette
((n, 3) uint8 RGB, or (n, 4) with the alpha of a PNG's tRNS chunk, a GIF's
transparency index or a DDS or TGA colour map; (0, 3) where PIL's image has
none).  ``decode_image_rgb(data)`` returns
``np.asarray(PIL.Image.open(BytesIO(data)).convert("RGB"))``, and
``load_image(data)`` the image PIL's ``load`` holds (``decode_image``'s but
for ICNS, whose array PIL packs in another mode).  The formats PIL opens
that the port does not (``_OTHER_FORMATS``: AVIF, FLI, PCD; EPS, WMF and
EMF, which need a program beside PIL; the BUFR, GRIB, HDF5 and MPEG stubs,
JBIG2 and BigTIFF, which PIL cannot load either) and anything else raise
``ValueError`` naming the format.  ``image_digest`` is the SHA-256 that
``tests/torch_image_files/digests.json`` holds of PIL's arrays.
"""

import hashlib

import numpy as np

from ifseg_torch.data import (blp, bmp, dds, fits, ftex, gbr, gif, icns, ico, im, imt, jpeg,
                              jpeg2000, mcidas, msp, pcx, pixar, png, ppm, psd, qoi, sgi, spider,
                              sun, tga, tiff, webp, xbm, xpm, xvthumb)

# PIL 12.1's Image.ID, in its order: (name, the test that PIL takes the file
# as that format, True where the port reads it).  A format without a
# signature or with a weak one (GBR, IM, IMT, McIdas, SPIDER, TGA, ...) is
# named only once its header parses as PIL's ``_open`` parses it, so a file
# that fails one plugin's ``_open`` falls through to the next, as in PIL;
# where that ``_open`` raises, so does the test.  The formats the port does
# not read are named by the signature of their ``_accept``; the ones that
# need a program beside PIL (EPS: Ghostscript; WMF and EMF: Windows) or that
# PIL cannot load either (the BUFR, GRIB, HDF5 and MPEG stubs, JBIG2) say so
_ORDER = (
    ("AVIF", lambda d: d[4:8] == b"ftyp" and d[8:12] in (b"avif", b"avis", b"mif1", b"msf1"),
     False),
    ("BLP", blp.is_blp, True),
    ("BMP", lambda d: d[:2] == bmp.SIGNATURE, True),
    ("DIB", bmp.is_dib, True),
    ("BUFR (PIL cannot load it either)", lambda d: d.startswith((b"BUFR", b"ZCZC")), False),
    ("CUR", lambda d: ico.cur_entry(d) is not None, True),
    ("PCX", pcx.is_pcx, True),
    ("DCX", lambda d: d[:4] == pcx.DCX_SIGNATURE, True),
    ("DDS", lambda d: d[:4] == dds.SIGNATURE, True),
    ("EPS (PIL reads it through Ghostscript)",
     lambda d: d.startswith(b"%!PS") or d.startswith(b"\xc5\xd0\xd3\xc6"), False),
    ("FITS", lambda d: d.startswith(fits.SIGNATURE), True),
    ("FLI", lambda d: len(d) >= 16 and d[4:6] in (b"\x11\xaf", b"\x12\xaf")
     and d[14:16] in (b"\x00\x00", b"\x03\x00"), False),
    ("FTEX", lambda d: d[:4] == ftex.SIGNATURE, True),
    ("GBR", lambda d: gbr.gbr_header(d) is not None, True),
    ("GIF", lambda d: d[:6] in gif.SIGNATURES, True),
    ("GRIB (PIL cannot load it either)", lambda d: d.startswith(b"GRIB") and d[7:8] == b"\x01",
     False),
    ("HDF5 (PIL cannot load it either)", lambda d: d.startswith(b"\x89HDF\r\n\x1a\n"), False),
    ("PNG", lambda d: d[:8] == png.SIGNATURE, True),
    ("JPEG 2000", jpeg2000.is_jpeg2000, True),
    ("ICNS", lambda d: d[:4] == icns.SIGNATURE, True),
    ("ICO", lambda d: d[:4] == ico.ICO_SIGNATURE, True),
    ("IM", lambda d: im.im_header(d) is not None, True),
    ("IMT", lambda d: imt.imt_header(d) is not None, True),
    ("JPEG", lambda d: d[:3] == jpeg.SIGNATURE, True),
    ("MCIDAS", lambda d: mcidas.mcidas_header(d) is not None, True),
    ("MPEG (PIL cannot load it either)", lambda d: d.startswith(b"\x00\x00\x01\xb3"), False),
    ("TIFF", lambda d: d[:4] in tiff.SIGNATURES, True),
    ("MSP", msp.is_msp, True),
    ("PCD", lambda d: d[2048:2055] == b"PCD_IPI", False),
    ("PIXAR", lambda d: pixar.pixar_size(d) is not None, True),
    ("Netpbm", ppm.is_ppm, True),
    ("PSD", lambda d: d[:4] == psd.SIGNATURE, True),
    ("QOI", lambda d: d[:4] == qoi.SIGNATURE, True),
    ("SGI", sgi.is_sgi, True),
    ("SPIDER", lambda d: spider.spider_header(d) is not None, True),
    ("SUN", lambda d: sun.sun_header(d) is not None, True),
    ("TGA", lambda d: tga.tga_header(d) is not None, True),
    ("WebP", webp.is_webp, True),
    ("WMF/EMF (PIL reads it only on Windows)",
     lambda d: d.startswith((b"\xd7\xcd\xc6\x9a\x00\x00", b"\x01\x00\x00\x00")), False),
    ("XBM", xbm.is_xbm, True),
    ("XPM", lambda d: d.startswith(xpm.SIGNATURE), True),
    ("XVThumb", lambda d: d.startswith(xvthumb.SIGNATURE), True),
    # not in Image.ID: what PIL identifies no plugin for
    ("JBIG2 (PIL cannot read it either)", lambda d: d.startswith(b"\x97JB2"), False),
    ("BigTIFF", lambda d: d[:4] in (b"II+\x00", b"MM\x00+"), False),
)
# the formats the port reads, in that order
_READ = tuple(name for name, _, reads in _ORDER if reads)
# what PIL opens that the port does not: FLI, PCD, AVIF and the rest above
_OTHER_FORMATS = tuple(name for name, _, reads in _ORDER if not reads)
_DECODERS = {"PNG": png.decode_png_image, "GIF": gif.decode_gif_image,
             "BMP": bmp.decode_bmp_image, "DIB": bmp.decode_dib_file,
             "TIFF": tiff.decode_tiff_image, "WebP": webp.decode_webp_image,
             "JPEG 2000": jpeg2000.decode_jpeg2000_image, "CUR": ico.decode_cur_image,
             "ICO": ico.decode_ico_image, "Netpbm": ppm.decode_ppm_image,
             "PSD": psd.decode_psd_image, "TGA": tga.decode_tga_image,
             "SGI": sgi.decode_sgi_image, "QOI": qoi.decode_qoi_image,
             "PCX": pcx.decode_pcx_image, "DCX": pcx.decode_dcx_image,
             "IM": im.decode_im_image, "DDS": dds.decode_dds_image,
             "BLP": blp.decode_blp_image, "FITS": fits.decode_fits_image,
             "FTEX": ftex.decode_ftex_image, "GBR": gbr.decode_gbr_image,
             "ICNS": icns.decode_icns_image, "IMT": imt.decode_imt_image,
             "MCIDAS": mcidas.decode_mcidas_image, "MSP": msp.decode_msp_image,
             "PIXAR": pixar.decode_pixar_image, "SPIDER": spider.decode_spider_image,
             "SUN": sun.decode_sun_image, "XBM": xbm.decode_xbm_image,
             "XPM": xpm.decode_xpm_image, "XVThumb": xvthumb.decode_xvthumb_image}


def image_format(data: bytes) -> str:
    """The name of the format PIL would open the file as, of those the port
    reads (``_READ``); ValueError for anything else."""
    data = bytes(data)
    for name, accept, reads in _ORDER:
        if accept(data):
            if reads:
                return name
            raise ValueError(f"{name} files are not supported ({', '.join(_READ[:-1])} and "
                             f"{_READ[-1]} only)")
    raise ValueError(f"not a {', '.join(_READ[:-1])} or {_READ[-1]} file (it starts with "
                     f"{bytes(data[:8])!r})")


def decode_image(data: bytes):
    """(pixels, PIL's mode, palette or None) of an image file."""
    fmt = image_format(data)
    if fmt in _DECODERS:
        return _DECODERS[fmt](data)
    pixels = jpeg.decode_jpeg(data)
    return pixels, {1: "L", 3: "RGB", 4: "CMYK"}[pixels.shape[2] if pixels.ndim == 3 else 1], None


def load_image(data: bytes):
    """(pixels, PIL's mode, palette or None) of the image PIL's ``load``
    holds, which ``save`` writes: ``decode_image``'s, but for an ICNS file,
    whose ``np.asarray`` PIL packs in the mode ``_open`` gave (see
    ``data/icns.py``)."""
    if image_format(data) == "ICNS":
        return icns.load_icns_image(data)
    return decode_image(data)


def decode_image_rgb(data: bytes) -> np.ndarray:
    """(h, w, 3) uint8 RGB of an image file, as PIL's
    ``Image.open(...).convert("RGB")`` gives it."""
    fmt = image_format(data)
    if fmt == "PNG":
        return png.decode_png_rgb(data)
    if fmt == "GIF":
        return gif.decode_gif_rgb(data)
    if fmt == "WebP":
        return webp.decode_webp_rgb(data)
    if fmt == "JPEG 2000":
        return jpeg2000.decode_jpeg2000_rgb(data)
    if fmt == "ICNS":
        return icns.decode_icns_rgb(data)
    pixels, mode, palette = decode_image(data)
    return png.to_rgb(pixels, palette, mode)


def load():
    """Build (if need be) and load every host codec now, not at its first
    file: the parent of a worker pool calls it so that the workers only load."""
    for codec in (png, jpeg, gif, bmp, tiff, webp, jpeg2000, psd, tga):
        codec.load()


def image_digest(arr: np.ndarray) -> str:
    """SHA-256 of an image array's bytes; a bool (mode "1") array as 0 and 1
    (PIL's array of such an image holds 0 and 255 in its bool bytes)."""
    arr = np.ascontiguousarray(arr != 0 if arr.dtype == bool else arr)
    return hashlib.sha256(arr.tobytes()).hexdigest()
