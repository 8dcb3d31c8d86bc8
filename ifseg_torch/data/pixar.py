"""PIXAR raster images decoded as PIL 12.1's ``PixarImagePlugin`` decodes
them.

``decode_pixar_image(data)`` returns ``(pixels, "RGB", None)``:
``np.asarray(PIL.Image.open(BytesIO(data)))``.  The 512-byte header's
little-endian words at 418 and 416 are the width and height and those at
424 and 426 the layout, which must be (14, 2) ("RGB"; PIL takes no other);
raw RGB rows start at 1,024.  A cut file keeps its whole rows, the others
0, as PIL reads it under the JAX package's ``LOAD_TRUNCATED_IMAGES``.
"""

import struct

from ifseg_torch.data.png import check_pixels, whole_rows

SIGNATURE = b"\x80\xe8\x00\x00"


def pixar_size(data: bytes):
    """(width, height) as PIL's ``_open`` reads them, None where it does not
    take the file."""
    if len(data) < 428 or data[:4] != SIGNATURE:  # PIL reads the header's first 428 bytes
        return None
    height, width = struct.unpack_from("<HH", data, 416)
    if struct.unpack_from("<HH", data, 424) != (14, 2) or not width or not height:
        return None
    return width, height


def decode_pixar_image(data: bytes):
    """(pixels, "RGB", None) of a PIXAR file (see the module docstring)."""
    data = bytes(data)
    size = pixar_size(data)
    if size is None:
        raise ValueError("not a PIXAR file PIL opens")
    check_pixels(*size, "PIXAR")
    return whole_rows(data[1024:], size[0], size[1], 3), "RGB", None
