"""Image files by their signature, decoded as PIL 12.1 decodes them: PNG
(``data/png.py``), JPEG (``data/jpeg.py``), GIF (``data/gif.py``), BMP
(``data/bmp.py``), TIFF (``data/tiff.py``), WebP (``data/webp.py``),
JPEG 2000, JP2 files and raw codestreams (``data/jpeg2000.py``), ICO and
CUR (``data/ico.py``), Netpbm, PBM, PGM, PPM and PFM (``data/ppm.py``) and
PSD (``data/psd.py``).  The signatures are tried in the order of PIL's
``Image.ID`` where two could meet: CUR and ICO before Netpbm, Netpbm before
PSD.

``decode_image(data)`` returns ``(pixels, mode, palette)``: the pixels as
``np.asarray(PIL.Image.open(BytesIO(data)))`` gives them, PIL's mode name
("1", "L", "P", "I", "I;16", "I;16B", "F", "LA", "PA", "RGB", "RGBA",
"CMYK" or "LAB") and, for a palette image, its palette ((n, 3) uint8 RGB,
or (n, 4) with the alpha of a PNG's tRNS chunk or a GIF's transparency
index; (0, 3) where PIL's image has none).  ``decode_image_rgb(data)``
returns ``np.asarray(PIL.Image.open(BytesIO(data)).convert("RGB"))``.  The
formats PIL reads that the port does not (``_OTHER_FORMATS``: QOI, SGI,
DDS, ICNS, PCX, FITS, XPM, ...) and anything else raise ``ValueError``
naming the format.  ``image_digest`` is the SHA-256 that
``tests/torch_image_files/digests.json`` holds of PIL's arrays.
"""

import hashlib

import numpy as np

from ifseg_torch.data import bmp, gif, ico, jpeg, jpeg2000, png, ppm, psd, tiff, webp

# the formats PIL 12.1 opens (or identifies) that the port does not, by the
# test of each plugin's ``_accept``; the ones that need a program beside PIL
# (EPS: Ghostscript; WMF and EMF: Windows) or that PIL cannot load either
# (the BUFR, GRIB, HDF5 and MPEG stubs, JBIG2) say so
_OTHER_FORMATS = (
    (lambda d: d.startswith(b"qoif"), "QOI"),
    (lambda d: d[:2] == b"\x01\xda", "SGI"),
    (lambda d: d.startswith(b"DDS "), "DDS"),
    (lambda d: d.startswith(b"icns"), "ICNS"),
    (lambda d: len(d) >= 2 and d[0] == 10 and d[1] in (0, 2, 3, 5), "PCX"),
    (lambda d: d.startswith(b"\xb1\x68\xde\x3a"), "DCX"),
    (lambda d: d.startswith(b"SIMPLE"), "FITS"),
    (lambda d: d.startswith(b"/* XPM */"), "XPM"),
    (lambda d: d[:512].lstrip().startswith(b"#define"), "XBM"),
    (lambda d: d.startswith((b"BLP1", b"BLP2")), "BLP"),
    (lambda d: d.startswith(b"FTEX"), "FTEX"),
    (lambda d: d.startswith((b"DanM", b"LinS")), "MSP"),
    (lambda d: d.startswith(b"\x59\xa6\x6a\x95"), "SUN"),
    (lambda d: d.startswith(b"\x80\xe8\x00\x00"), "PIXAR"),
    (lambda d: d.startswith(b"P7 332"), "XVThumb"),
    (lambda d: d.startswith(b"\x00\x00\x00\x00\x00\x00\x00\x04"), "McIdas"),
    (lambda d: len(d) >= 16 and d[4:6] in (b"\x11\xaf", b"\x12\xaf")
     and d[14:16] in (b"\x00\x00", b"\x03\x00"), "FLI"),
    (lambda d: len(d) >= 8 and int.from_bytes(d[:4], "big") >= 20
     and int.from_bytes(d[4:8], "big") in (1, 2), "GBR"),
    (lambda d: d[4:8] == b"ftyp" and d[8:12] in (b"avif", b"avis", b"mif1", b"msf1"), "AVIF"),
    (lambda d: d[2048:2055] == b"PCD_IPI", "PCD"),
    (lambda d: d.startswith(b"%!PS") or d.startswith(b"\xc5\xd0\xd3\xc6"),
     "EPS (PIL reads it through Ghostscript)"),
    (lambda d: d.startswith((b"\xd7\xcd\xc6\x9a\x00\x00", b"\x01\x00\x00\x00")),
     "WMF/EMF (PIL reads it only on Windows)"),
    (lambda d: d.startswith((b"BUFR", b"ZCZC")), "BUFR (PIL cannot load it either)"),
    (lambda d: d.startswith(b"GRIB") and d[7:8] == b"\x01", "GRIB (PIL cannot load it either)"),
    (lambda d: d.startswith(b"\x89HDF\r\n\x1a\n"), "HDF5 (PIL cannot load it either)"),
    (lambda d: d.startswith(b"\x00\x00\x01\xb3"), "MPEG (PIL cannot load it either)"),
    (lambda d: d.startswith(b"\x97JB2"), "JBIG2 (PIL cannot read it either)"),
    (lambda d: d[:4] in (b"II+\x00", b"MM\x00+"), "BigTIFF"),
)
_READ = ("PNG", "JPEG", "GIF", "BMP", "TIFF", "WebP", "JPEG 2000", "ICO", "CUR", "Netpbm",
         "PSD")
_DECODERS = {"PNG": png.decode_png_image, "GIF": gif.decode_gif_image,
             "BMP": bmp.decode_bmp_image, "TIFF": tiff.decode_tiff_image,
             "WebP": webp.decode_webp_image, "JPEG 2000": jpeg2000.decode_jpeg2000_image,
             "CUR": ico.decode_cur_image, "ICO": ico.decode_ico_image,
             "Netpbm": ppm.decode_ppm_image, "PSD": psd.decode_psd_image}


def image_format(data: bytes) -> str:
    """"PNG", "JPEG", "GIF", "BMP", "TIFF", "WebP", "JPEG 2000", "CUR",
    "ICO", "Netpbm" or "PSD" from the file's signature; ValueError for
    anything else."""
    if data[:8] == png.SIGNATURE:
        return "PNG"
    if data[:3] == jpeg.SIGNATURE:
        return "JPEG"
    if data[:6] in gif.SIGNATURES:
        return "GIF"
    if data[:2] == bmp.SIGNATURE:
        return "BMP"
    if data[:4] in tiff.SIGNATURES:
        return "TIFF"
    if webp.is_webp(data):
        return "WebP"
    if jpeg2000.is_jpeg2000(data):
        return "JPEG 2000"
    if data[:4] == ico.CUR_SIGNATURE:
        return "CUR"
    if data[:4] == ico.ICO_SIGNATURE:
        return "ICO"
    if ppm.is_ppm(data):
        return "Netpbm"
    if data[:4] == psd.SIGNATURE:
        return "PSD"
    name = next((n for accept, n in _OTHER_FORMATS if accept(bytes(data[:2056]))), None)
    if name:
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
    pixels, mode, palette = decode_image(data)
    return png.to_rgb(pixels, palette, mode)


def load():
    """Build (if need be) and load every host codec now, not at its first
    file: the parent of a worker pool calls it so that the workers only load."""
    for codec in (png, jpeg, gif, bmp, tiff, webp, jpeg2000, psd):
        codec.load()


def image_digest(arr: np.ndarray) -> str:
    """SHA-256 of an image array's bytes; a bool (mode "1") array as 0 and 1
    (PIL's array of such an image holds 0 and 255 in its bool bytes)."""
    arr = np.ascontiguousarray(arr != 0 if arr.dtype == bool else arr)
    return hashlib.sha256(arr.tobytes()).hexdigest()
