"""IM Tools (IMT) files decoded as PIL 12.1's ``ImtImagePlugin`` decodes
them, with the standard library's ``re``.

``decode_imt_image(data)`` returns ``(pixels, "L", None)``:
``np.asarray(PIL.Image.open(BytesIO(data)))``.  The header is lines of
``key value`` (``width``, ``height``, and ``pixel n8`` for "L"; lines that
start with ``*`` are comments), read as PIL's ``_open`` reads them: a line
of one byte or of more than 100, or one that is no ``key value``, ends it,
and a form feed starts the raw rows.  PIL takes the file only with mode "L"
and a size, and has no pixels without the form feed.  A cut file keeps its
whole rows, the others 0, as PIL reads it under the JAX package's
``LOAD_TRUNCATED_IMAGES``.
"""

import io
import re

from ifseg_torch.data.png import check_pixels, whole_rows

_FIELD = re.compile(rb"([a-z]*) ([^ \r\n]*)")


def imt_header(data: bytes):
    """(width, height, offset of the pixels or None) as PIL's ``_open`` reads
    them, None where it does not take the file (the next format may); a
    width or height that is no number raises, as in PIL."""
    fp = io.BytesIO(data)
    buffer = fp.read(100)
    if b"\n" not in buffer:
        return None
    xsize = ysize = 0
    size, mode, offset = (0, 0), "", None
    while True:
        if buffer:
            s, buffer = buffer[:1], buffer[1:]
        else:
            s = fp.read(1)
        if not s:
            break
        if s == b"\x0c":
            offset = fp.tell() - len(buffer)
            break
        if b"\n" not in buffer:
            buffer += fp.read(100)
        lines = buffer.split(b"\n")
        s += lines.pop(0)
        buffer = b"\n".join(lines)
        if len(s) == 1 or len(s) > 100:
            break
        if s[0] == ord(b"*"):
            continue
        m = _FIELD.match(s)
        if not m:
            break
        k, v = m.group(1, 2)
        try:
            if k == b"width":
                xsize = int(v)
                size = xsize, ysize
            elif k == b"height":
                ysize = int(v)
                size = xsize, ysize
        except ValueError:
            raise ValueError(f"IMT {k.decode()} {v!r} is not a number") from None
        if k == b"pixel" and v == b"n8":
            mode = "L"
    if mode != "L" or size[0] <= 0 or size[1] <= 0:
        return None
    return size[0], size[1], offset


def decode_imt_image(data: bytes):
    """(pixels, "L", None) of an IMT file (see the module docstring)."""
    data = bytes(data)
    head = imt_header(data)
    if head is None:
        raise ValueError("not an IMT file PIL opens")
    width, height, offset = head
    check_pixels(width, height, "IMT")
    if offset is None:
        raise ValueError("IMT file without a form feed: PIL has no pixels to load")
    return whole_rows(data[offset:], width, height, 1)[:, :, 0], "L", None
