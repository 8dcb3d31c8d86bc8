"""X11 pixmaps (XPM) decoded as PIL 12.1's ``XpmImagePlugin`` decodes them,
with the standard library's ``re`` and numpy.

``decode_xpm_image(data)`` returns ``(pixels, mode, palette)``:
``np.asarray(PIL.Image.open(BytesIO(data)))``, PIL's mode and, for "P", the
palette ((n, 3) uint8).  After ``/* XPM */`` the first line that starts
with ``"width height colours chars`` opens the colour lines, one a colour:
its ``chars``-byte key, then the value of its ``c`` entry, ``#rrggbb``
(hex, any length, the low 24 bits taken) or ``None`` (transparent, no
palette entry).  Up to 256 colours the image is "P", each pixel the index
of its key among the palette's keys (XpmImagePlugin.py:97-100); with more
it is "RGB".  The pixel lines are read as PIL's decoder reads them: each
line's text between its first and last double quote, cut into keys, until
the image is full, a first ``/* pixels */`` line skipped.  A key that is not
a colour's, a colour PIL cannot read and too few pixels raise, as in PIL
(a cut file too).
"""

import re

import numpy as np

from ifseg_torch.data.png import check_pixels

SIGNATURE = b"/* XPM */"
_HEAD = re.compile(b'"([0-9]*) ([0-9]*) ([0-9]*) ([0-9]*)')


def _lines(data: bytes, pos: int):
    """The lines of ``data`` from ``pos`` as ``readline`` returns them, with
    the position after each."""
    while pos < len(data):
        end = data.find(b"\n", pos)
        end = len(data) if end < 0 else end + 1
        yield data[pos:end], end
        pos = end


def xpm_header(data: bytes):
    """(width, height, colours, chars a key, {key: RGB bytes}, offset of the
    pixel lines) as PIL's ``_open`` reads them; ValueError where PIL's open
    fails."""
    lines = _lines(data, 9)
    for line, pos in lines:
        m = _HEAD.match(line)
        if m:
            break
    else:
        raise ValueError("broken XPM file: no header line")
    try:
        width, height, count, chars = (int(g) for g in m.groups())
    except ValueError:
        raise ValueError("broken XPM file: an empty number in its header") from None
    palette = {}
    for _ in range(count):
        line, pos = next(lines, (b"", pos))
        line = line.rstrip()
        key = line[1:chars + 1]
        words = line[chars + 1:-2].split()
        for i in range(0, len(words), 2):
            if words[i] == b"c":
                if i + 1 >= len(words):
                    raise ValueError("broken XPM file: a colour without its value")
                value = words[i + 1]
                if value.startswith(b"#"):
                    rgb = int(value[1:], 16)
                    palette[key] = bytes(((rgb >> 16) & 255, (rgb >> 8) & 255, rgb & 255))
                elif value != b"None":
                    raise ValueError(f"cannot read the XPM colour {value!r}")
                break
        else:
            raise ValueError("cannot read this XPM file: a colour line without a c entry")
    return width, height, count, chars, palette, pos


def decode_xpm_image(data: bytes):
    """(pixels, PIL's mode, palette or None) of an XPM file (see the module
    docstring)."""
    data = bytes(data)
    if not data.startswith(SIGNATURE):
        raise ValueError("not an XPM file")
    width, height, count, chars, palette, pos = xpm_header(data)
    if not width or not height:
        raise ValueError(f"XPM image of {width} x {height} pixels")
    check_pixels(width, height, "XPM")
    if not chars:
        raise ValueError("XPM keys of 0 characters")
    want, seen_header, got = width * height, False, []
    for line, _ in _lines(data, pos):
        if len(got) >= want:
            break
        if line.rstrip() == b"/* pixels */" and not seen_header:
            seen_header = True
            continue
        text = b'"'.join(line.split(b'"')[1:-1])
        got += [text[i:i + chars] for i in range(0, len(text), chars)]
    try:
        if count > 256:
            px = b"".join(palette[k] for k in got)
        else:
            index = {k: i for i, k in enumerate(palette)}
            px = bytes(index[k] for k in got)
    except KeyError:
        raise ValueError("XPM pixel of a key that is no colour's") from None
    if len(got) < want:
        raise ValueError("truncated XPM: too few pixels")
    if count > 256:
        return np.frombuffer(px, np.uint8, count=3 * want).reshape(height, width, 3).copy(), "RGB", None
    table = np.frombuffer(b"".join(palette.values()), np.uint8).reshape(-1, 3)
    return np.frombuffer(px, np.uint8, count=want).reshape(height, width).copy(), "P", table
