"""IFUNC Image Memory (IM) files decoded as PIL 12.1's ``ImImagePlugin``
decodes them, and an RGB image encoded as its ``save`` encodes it, with
numpy and one host C++ loop.

``decode_im_image(data)`` returns ``(pixels, mode, palette)``:
``np.asarray(PIL.Image.open(BytesIO(data)))``, PIL's mode and, for mode "P",
the palette ((n, 3) uint8 RGB).  IM has no signature: ``im_header`` gives
the header only where PIL's ``_open`` takes it: a newline in the first 100
bytes, then lines of at most 100 bytes, each ``Key: value`` (a key starting
with a letter), up to a NUL, a 0x1A or the end, at least one of PIL's nine
keys among them, and a 0x1A after them.  The image type picks PIL's mode and
raw mode from its ``OPEN`` table (the default "L", 512 x 512); every type
whose raw mode PIL has decodes:

  1, L, P (2 and 4 bits), RGB (planar lines, interleaved, or three planes
  green, red, blue), LA, RGBA, RGBX, CMYK and YCbCr (planar lines), I
  (32-bit), I;16, I;16L, I;16B, and F from 8, 16 or 32 bits (signed or
  not), from float32 and from 2 to 31 bits (``csrc/rle_decode.cpp``,
  ``im_bits``, PIL's ``BitDecode.c``, which keeps a cut row's first values).

Rows are bottom-up.  A ``Lut`` key reads a 768-byte table after the header:
one that is not grey makes an "L" or "P" image "P" and an "LA" or "PA" one
"PA", with it (planar) as the palette; a "P" image without one has an empty
palette (black, as PIL converts it).  A cut
file keeps its whole rows, the others 0, as PIL reads it under the JAX
package's ``LOAD_TRUNCATED_IMAGES``.  The types PIL names but cannot load
(RLB, RYB, PA without a colour table) raise ``ValueError``, as PIL's load
fails.  ``to_rgb``
converts YCbCr as Pillow's ``ImagingConvertYCbCr2RGB`` does (``ycbcr_to_rgb``).

``encode_im(arr, name)`` writes what ``Image.fromarray(arr).save(path)``
writes to a ``.im`` file named ``name`` for an (h, w, 3) uint8 RGB array.
"""

import ctypes
import os
import re
from functools import lru_cache

import numpy as np

from ifseg_torch.data.png import check_pixels, unpack_bits, whole_rows
from ifseg_torch.ops import build

SOURCE = "rle_decode"
_TAGS = ("Comment", "Date", "Digitalization equipment", "File size (no of images)", "Lut",
         "Name", "Scale (x,y)", "Image size (x*y)", "Image type")
_SPLIT = re.compile(rb"^([A-Za-z][^:]*):[ \t]*(.*)[ \t]*$")
# PIL's OPEN table: image type -> (mode, raw mode), built as PIL builds it
OPEN = {"0 1 image": ("1", "1"), "L 1 image": ("1", "1"), "Greyscale image": ("L", "L"),
        "Grayscale image": ("L", "L"), "RGB image": ("RGB", "RGB;L"),
        "RLB image": ("RGB", "RLB"), "RYB image": ("RGB", "RLB"), "B1 image": ("1", "1"),
        "B2 image": ("P", "P;2"), "B4 image": ("P", "P;4"), "X 24 image": ("RGB", "RGB"),
        "L 32 S image": ("I", "I;32"), "L 32 F image": ("F", "F;32"),
        "RGB3 image": ("RGB", "RGB;T"), "RYB3 image": ("RGB", "RYB;T"),
        "LA image": ("LA", "LA;L"), "PA image": ("LA", "PA;L"),
        "RGBA image": ("RGBA", "RGBA;L"), "RGBX image": ("RGB", "RGBX;L"),
        "CMYK image": ("CMYK", "CMYK;L"), "YCC image": ("YCbCr", "YCbCr;L")}
for _i in ("8", "8S", "16", "16S", "32", "32F"):
    OPEN[f"L {_i} image"] = OPEN[f"L*{_i} image"] = ("F", f"F;{_i}")
for _i in ("16", "16L", "16B"):
    OPEN[f"L {_i} image"] = OPEN[f"L*{_i} image"] = (f"I;{_i}", f"I;{_i}")
OPEN["L 32S image"] = OPEN["L*32S image"] = ("I", "I;32S")
for _j in range(2, 33):
    OPEN[f"L*{_j} image"] = ("F", f"F;{_j}")
# raw mode -> numpy dtype of one sample, for the one-band modes
_SAMPLES = {"I;32": "<i4", "I;32S": "<i4", "F;8": "u1", "F;8S": "i1", "F;16": "<u2",
            "F;16S": "<i2", "F;32": "<u4", "F;32F": "<f4", "I;16": "<u2", "I;16L": "<u2",
            "I;16B": ">u2", "L": "u1"}
# mode -> the dtype of PIL's array
_DTYPES = {"I": np.int32, "F": np.float32, "I;16": np.uint16, "I;16L": np.uint16,
           "I;16B": np.dtype(">u2"), "L": np.uint8}
# planar-line raw modes: (bands written, bands kept)
_PLANAR = {"RGB;L": (3, 3), "LA;L": (2, 2), "PA;L": (2, 2), "RGBA;L": (4, 4), "RGBX;L": (4, 3),
           "CMYK;L": (4, 4), "YCbCr;L": (3, 3)}


@lru_cache(maxsize=None)
def _bits():
    fn = build.load(SOURCE).im_bits
    fn.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
                   ctypes.c_int64, ctypes.c_int64]
    fn.restype = ctypes.c_int64
    return fn


def load():
    """Build (if need be) and load the bit loop now, not at the first decode."""
    _bits()


def _number(s: str):
    try:
        return int(s)
    except ValueError:
        return float(s)


def im_header(data: bytes):
    """(mode, raw mode, (width, height), palette or None, pixel offset) where
    PIL's ``_open`` takes the file as IM, else None.  A size or count that is
    not a number raises ``ValueError``, as PIL's does."""
    if b"\n" not in data[:100]:
        return None
    info = {"Image type": "L", "Image size (x*y)": (512, 512)}
    raw, tags, pos, s = "L", 0, 0, b""
    while True:
        s = data[pos:pos + 1]
        pos += len(s)
        if s == b"\r":
            continue
        if not s or s in (b"\0", b"\x1a"):
            break
        end = data.find(b"\n", pos)
        end = len(data) if end < 0 else end + 1
        s, pos = s + data[pos:end], end
        if len(s) > 100:
            return None
        s = s[:-2] if s.endswith(b"\r\n") else s[:-1] if s.endswith(b"\n") else s
        m = _SPLIT.match(s)
        if not m:
            return None
        k, v = (g.decode("latin-1", "replace") for g in m.group(1, 2))
        if k in ("File size (no of images)", "Scale (x,y)", "Image size (x*y)"):
            v = tuple(_number(x) for x in v.replace("*", ",").split(","))
            v = v[0] if len(v) == 1 else v
        elif k == "Image type" and v in OPEN:
            v, raw = OPEN[v]
        info[k] = v
        tags += k in _TAGS
    if not tags:
        return None
    while s and not s.startswith(b"\x1a"):
        s = data[pos:pos + 1]
        pos += len(s)
    if not s:
        return None
    mode, size, palette = info["Image type"], info["Image size (x*y)"], None
    if "Lut" in info:
        lut = data[pos:pos + 768]
        pos += len(lut)
        grey = True
        for i in range(256):  # PIL's test, which reads past a cut table's end only where it must
            if i + 256 >= len(lut) or lut[i] == lut[i + 256] and i + 512 >= len(lut):
                return None
            grey = grey and lut[i] == lut[i + 256] == lut[i + 512]
        if not grey and mode in ("L", "P", "LA", "PA"):
            mode, raw = ("P", "P") if mode in ("L", "P") else ("PA", "PA;L")
            n = len(lut) // 3  # a cut table: PIL's RGB;L unpacker over its thirds
            palette = np.frombuffer(lut[:3 * n], np.uint8).reshape(3, n).T.copy()
    return mode, raw, size, palette, pos


def decode_im_image(data: bytes):
    """(pixels, PIL's mode, palette or None) of an IM file (see the module
    docstring)."""
    data = bytes(data)
    head = im_header(data)
    if head is None:
        raise ValueError("not an IM file")
    mode, raw, size, palette, pos = head
    if not (isinstance(size, tuple) and len(size) == 2 and all(isinstance(v, int) for v in size)):
        raise ValueError(f"broken IM: image size {size!r}")
    width, height = size
    if width < 0 or height < 0 or mode not in (*_DTYPES, "1", "P", "PA", "RGB", "LA", "RGBA",
                                              "CMYK", "YCbCr") or raw == "RLB" or (
                                                  mode, raw) == ("LA", "PA;L"):
        raise ValueError(f"IM image type {mode!r} (raw mode {raw}) is not one PIL loads")
    check_pixels(width, height, "IM")
    body = data[pos:]
    if raw.startswith("F;") and raw[2:].isdigit() and int(raw[2:]) not in (8, 16, 32):
        out = np.zeros((height, width), np.float32)  # PIL writes a cut row's first values too
        _bits()(body, len(body), out.ctypes.data, width, height, int(raw[2:]))
        return np.ascontiguousarray(out[::-1]), mode, None
    if raw in ("RGB;T", "RYB;T"):  # three planes: green, red, blue
        page = width * height
        out = np.zeros((height, width, 3), np.uint8)
        for c, band in enumerate((1, 0, 2)):
            out[:, :, band] = whole_rows(body[c * page:(c + 1) * page], width, height, 1)[:, :, 0]
        return np.ascontiguousarray(out[::-1]), mode, None
    if raw in ("1", "P;2", "P;4"):
        depth = {"1": 1, "P;2": 2, "P;4": 4}[raw]
        stride = (width * depth + 7) // 8
        rows = whole_rows(body, stride, height, 1)[:, :, 0]
        px = unpack_bits(rows, depth, width) if width else np.zeros((height, 0), np.uint8)
        if raw == "1":
            return np.ascontiguousarray(px.astype(bool)[::-1]), mode, None
        return np.ascontiguousarray(px[::-1]), mode, np.zeros((0, 3), np.uint8)
    if raw in _PLANAR:
        written, kept = _PLANAR[raw]
        px = whole_rows(body, width * written, height, 1).reshape(height, written, width)
        return np.ascontiguousarray(px[::-1, :kept].transpose(0, 2, 1)), mode, palette
    if raw == "RGB":
        return np.ascontiguousarray(whole_rows(body, width, height, 3)[::-1]), mode, None
    if raw == "P":
        palette = np.zeros((0, 3), np.uint8) if palette is None else palette
        return np.ascontiguousarray(whole_rows(body, width, height, 1)[::-1, :, 0]), mode, palette
    sample = np.dtype(_SAMPLES[raw])
    rows = whole_rows(body, width * sample.itemsize, height, 1)[::-1, :, 0]
    values = np.ascontiguousarray(rows).view(sample)
    return values.astype(_DTYPES[mode]), mode, None


def ycbcr_to_rgb(pixels: np.ndarray) -> np.ndarray:
    """(h, w, 3) uint8 YCbCr as PIL's ``convert("RGB")`` gives it: Pillow's
    table-driven ``ImagingConvertYCbCr2RGB`` (tables recovered from its
    output over every Y, Cb and Cr)."""
    y, cb, cr = (pixels[:, :, i].astype(np.int32) for i in range(3))
    rgb = (y + _R_CR[cr], y + ((_G_CB[cb] + _G_CR[cr]) >> 6), y + _B_CB[cb])
    return np.stack([np.clip(c, 0, 255) for c in rgb], axis=2).astype(np.uint8)


def encode_im(arr: np.ndarray, name: str = "") -> bytes:
    """The bytes of PIL's ``Image.fromarray(arr).save(path)`` for an (h, w, 3)
    uint8 RGB array and an IM ``path`` whose file name is ``name``."""
    if arr.dtype != np.uint8 or arr.ndim != 3 or arr.shape[2] != 3:
        raise ValueError(f"encode_im takes (h, w, 3) uint8, not {arr.shape} {arr.dtype}")
    h, w = arr.shape[:2]
    head = "Image type: RGB image\r\n"
    if name:
        stem, ext = os.path.splitext(os.path.basename(name))
        head += f"Name: {stem[:92 - len(ext)]}{ext}\r\n"
    head += f"Image size (x*y): {w}*{h}\r\nFile size (no of images): 1\r\n"
    head = head.encode("ascii")
    head += b"\0" * (511 - len(head)) + b"\x1a"
    return head + np.ascontiguousarray(arr[::-1].transpose(0, 2, 1)).tobytes()


# Pillow's YCbCr -> RGB offsets: red by Cr, blue by Cb, and green's two
# terms, summed and shifted right by 6
_R_CR = np.array([
    -180, -179, -177, -176, -174, -173, -172, -170, -169, -167, -166, -165, -163, -162, -160, -159,
    -158, -156, -155, -153, -152, -150, -149, -148, -146, -145, -143, -142, -141, -139, -138, -136,
    -135, -134, -132, -131, -129, -128, -127, -125, -124, -122, -121, -120, -118, -117, -115, -114,
    -113, -111, -110, -108, -107, -106, -104, -103, -101, -100, -99, -97, -96, -94, -93, -92, -90,
    -89, -87, -86, -85, -83, -82, -80, -79, -78, -76, -75, -73, -72, -71, -69, -68, -66, -65, -64,
    -62, -61, -59, -58, -57, -55, -54, -52, -51, -50, -48, -47, -45, -44, -43, -41, -40, -38, -37,
    -36, -34, -33, -31, -30, -29, -27, -26, -24, -23, -22, -20, -19, -17, -16, -14, -13, -12, -10,
    -9, -7, -6, -5, -3, -2, 0, 1, 2, 4, 5, 7, 8, 9, 11, 12, 14, 15, 16, 18, 19, 21, 22, 23, 25, 26,
    28, 29, 30, 32, 33, 35, 36, 37, 39, 40, 42, 43, 44, 46, 47, 49, 50, 51, 53, 54, 56, 57, 58, 60,
    61, 63, 64, 65, 67, 68, 70, 71, 72, 74, 75, 77, 78, 79, 81, 82, 84, 85, 86, 88, 89, 91, 92, 93,
    95, 96, 98, 99, 100, 102, 103, 105, 106, 107, 109, 110, 112, 113, 114, 116, 117, 119, 120, 121,
    123, 124, 126, 127, 128, 130, 131, 133, 134, 136, 137, 138, 140, 141, 143, 144, 145, 147, 148,
    150, 151, 152, 154, 155, 157, 158, 159, 161, 162, 164, 165, 166, 168, 169, 171, 172, 173, 175,
    176, 178
], np.int32)
_B_CB = np.array([
    -227, -226, -224, -222, -220, -218, -217, -215, -213, -211, -210, -208, -206, -204, -202, -201,
    -199, -197, -195, -194, -192, -190, -188, -187, -185, -183, -181, -179, -178, -176, -174, -172,
    -171, -169, -167, -165, -164, -162, -160, -158, -156, -155, -153, -151, -149, -148, -146, -144,
    -142, -140, -139, -137, -135, -133, -132, -130, -128, -126, -125, -123, -121, -119, -117, -116,
    -114, -112, -110, -109, -107, -105, -103, -101, -100, -98, -96, -94, -93, -91, -89, -87, -86,
    -84, -82, -80, -78, -77, -75, -73, -71, -70, -68, -66, -64, -62, -61, -59, -57, -55, -54, -52,
    -50, -48, -47, -45, -43, -41, -39, -38, -36, -34, -32, -31, -29, -27, -25, -24, -22, -20, -18,
    -16, -15, -13, -11, -9, -8, -6, -4, -2, 0, 1, 3, 5, 7, 8, 10, 12, 14, 15, 17, 19, 21, 23, 24,
    26, 28, 30, 31, 33, 35, 37, 38, 40, 42, 44, 46, 47, 49, 51, 53, 54, 56, 58, 60, 62, 63, 65, 67,
    69, 70, 72, 74, 76, 77, 79, 81, 83, 85, 86, 88, 90, 92, 93, 95, 97, 99, 101, 102, 104, 106,
    108, 109, 111, 113, 115, 116, 118, 120, 122, 124, 125, 127, 129, 131, 132, 134, 136, 138, 139,
    141, 143, 145, 147, 148, 150, 152, 154, 155, 157, 159, 161, 163, 164, 166, 168, 170, 171, 173,
    175, 177, 178, 180, 182, 184, 186, 187, 189, 191, 193, 194, 196, 198, 200, 202, 203, 205, 207,
    209, 210, 212, 214, 216, 217, 219, 221, 223, 225
], np.int32)
_G_CB = np.array([
    -2963, -2973, -3019, -3027, -3073, -3083, -3093, -3137, -3147, -3159, -3201, -3213, -3223,
    -3266, -3279, -3287, -3332, -3343, -3352, -3398, -3407, -3418, -3462, -3472, -3483, -3526,
    -3538, -3547, -3593, -3603, -3612, -3659, -3667, -3678, -3723, -3732, -3777, -3787, -3798,
    -3841, -3852, -3863, -3905, -3918, -3927, -3971, -3983, -3991, -4037, -4047, -4057, -4102,
    -4111, -4123, -4166, -4177, -4187, -4231, -4243, -4251, -4297, -4307, -4316, -4363, -4371,
    -4382, -4427, -4436, -4481, -4491, -4503, -4545, -4557, -4567, -4610, -4623, -4631, -4676,
    -4687, -4696, -4742, -4751, -4762, -4806, -4816, -4827, -4870, -4882, -4891, -4936, -4947,
    -4955, -5002, -5011, -5021, -5067, -5075, -5121, -5131, -5141, -5185, -5195, -5207, -5249,
    -5261, -5271, -5314, -5327, -5335, -5381, -5391, -5401, -5446, -5455, -5467, -5510, -5521,
    -5531, -5575, -5587, -5595, -5641, -5651, -5660, -5707, -5715, -5726, -5771, -5780, -5825,
    -5835, -5845, -5889, -5899, -5911, -5953, -5965, -5975, -6018, -6031, -6039, -6084, -6095,
    -6104, -6150, -6159, -6170, -6214, -6224, -6235, -6279, -6291, -6299, -6345, -6355, -6364,
    -6411, -6419, -6430, -6475, -6484, -6529, -6539, -6550, -6593, -6604, -6615, -6657, -6670,
    -6679, -6723, -6735, -6743, -6789, -6799, -6809, -6854, -6863, -6875, -6918, -6929, -6939,
    -6983, -6995, -7003, -7049, -7059, -7068, -7115, -7123, -7169, -7179, -7189, -7233, -7243,
    -7255, -7297, -7309, -7319, -7362, -7375, -7383, -7428, -7439, -7448, -7494, -7503, -7514,
    -7558, -7568, -7579, -7622, -7634, -7643, -7688, -7699, -7707, -7754, -7763, -7773, -7819,
    -7827, -7873, -7883, -7893, -7937, -7947, -7959, -8001, -8014, -8023, -8067, -8079, -8087,
    -8133, -8143, -8153, -8198, -8207, -8219, -8262, -8273, -8283, -8327, -8339, -8347, -8393,
    -8403, -8412, -8459, -8467, -8478, -8523, -8532, -8577, -8587
], np.int32)
_G_CR = np.array([
    11649, 11595, 11539, 11483, 11462, 11407, 11351, 11329, 11275, 11219, 11163, 11142, 11087,
    11031, 11009, 10955, 10899, 10843, 10823, 10767, 10711, 10689, 10635, 10579, 10523, 10503,
    10447, 10391, 10369, 10315, 10259, 10203, 10183, 10127, 10071, 10050, 9995, 9939, 9883, 9863,
    9807, 9751, 9730, 9675, 9619, 9564, 9543, 9487, 9431, 9410, 9355, 9299, 9244, 9223, 9167, 9111,
    9090, 9035, 8979, 8924, 8903, 8847, 8792, 8770, 8715, 8659, 8604, 8583, 8527, 8472, 8450, 8395,
    8339, 8284, 8263, 8207, 8152, 8130, 8075, 8020, 7964, 7943, 7887, 7832, 7810, 7755, 7700, 7644,
    7623, 7567, 7512, 7490, 7435, 7380, 7324, 7303, 7248, 7192, 7170, 7115, 7060, 7004, 6983, 6928,
    6872, 6850, 6796, 6740, 6684, 6663, 6608, 6552, 6530, 6476, 6420, 6364, 6343, 6288, 6232, 6210,
    6156, 6100, 6044, 6024, 5968, 5912, 5890, 5836, 5780, 5725, 5705, 5649, 5593, 5571, 5517, 5461,
    5405, 5385, 5329, 5273, 5252, 5197, 5141, 5085, 5065, 5009, 4953, 4932, 4877, 4821, 4765, 4745,
    4689, 4633, 4612, 4557, 4501, 4446, 4425, 4369, 4313, 4292, 4237, 4181, 4126, 4105, 4049, 3994,
    3972, 3917, 3861, 3806, 3785, 3729, 3674, 3652, 3597, 3541, 3486, 3465, 3409, 3354, 3332, 3277,
    3222, 3166, 3145, 3089, 3034, 3012, 2957, 2902, 2846, 2825, 2769, 2714, 2692, 2637, 2582, 2526,
    2505, 2450, 2394, 2372, 2317, 2262, 2206, 2185, 2130, 2074, 2052, 1997, 1942, 1886, 1865, 1810,
    1754, 1732, 1678, 1622, 1566, 1545, 1490, 1434, 1412, 1358, 1302, 1246, 1226, 1170, 1114, 1092,
    1038, 982, 926, 906, 850, 794, 772, 718, 662, 606, 586, 530, 474, 453, 398, 342, 286, 266, 210,
    154, 133, 78, 22, 0
], np.int32)
