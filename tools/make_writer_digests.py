"""Write ``tests/torch_writer_digests.json``: what PIL and cv2 give for the
files ``chip_smoke.py`` phase 14e writes at run time, which the card's
machine (no PIL, no cv2) holds the port to:

  - ``files``: for each of ``tests/torch_image_writers.raw_format_files()``
    (TGA, SGI, QOI, PCX, DCX, IM, DDS with every BC6H and BC7 mode, DIB, a
    PFM row, FTEX, BLP, ICNS, SUN, MSP, XBM, XPM, GBR, PIXAR, XVThumb,
    McIdas, IMT, SPIDER and FITS, numpy only), PIL's
    format and mode, the shape of ``np.asarray(Image.open(...))`` and the
    SHA-256 of those pixels and of ``convert("RGB")``;
  - ``jpeg_overflow``: for each of ``chip_smoke.overflow_jpegs()`` (the
    port's encoder, quantization tables of 255), the SHA-256 of PIL's pixels
    with libjpeg-turbo's default SIMD IDCT and with its C one
    (``JSIMD_FORCENONE=1``, in a process of its own);
  - ``pfm_resize``: the SHA-256 of ``cv2.resize`` (linear) of the PFM row
    as the dataset holds it, at each of ``chip_smoke.PFM_RESIZES``.

``tests/test_torch_writer_digests.py`` recomputes them.  Needs PIL and cv2;
run from the repository root:

  python tools/make_writer_digests.py
"""

import io
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tests"))

_PIL_PIXELS = """
import io, sys, numpy as np
from PIL import Image, ImageFile
ImageFile.LOAD_TRUNCATED_IMAGES = True
sys.stdout.buffer.write(np.ascontiguousarray(np.asarray(Image.open(sys.stdin.buffer))).tobytes())
"""


def digests():
    import cv2
    from PIL import Image, ImageFile

    import chip_smoke
    import torch_image_writers as W
    from ifseg_torch.data.image import decode_image, image_digest

    ImageFile.LOAD_TRUNCATED_IMAGES = True
    files = {}
    for name, data in sorted(W.raw_format_files().items()):
        im = Image.open(io.BytesIO(data))
        pixels = np.asarray(im)
        files[name] = dict(format=im.format, mode=im.mode, shape=list(pixels.shape),
                           pixels=image_digest(pixels),
                           rgb=image_digest(np.asarray(im.convert("RGB"))))
    jpegs = {}
    env = dict(os.environ, JSIMD_FORCENONE="1")
    for name, data in sorted(chip_smoke.overflow_jpegs().items()):
        simd = np.asarray(Image.open(io.BytesIO(data)))
        c_bytes = subprocess.run([sys.executable, "-c", _PIL_PIXELS], input=data, env=env,
                                 capture_output=True, check=True).stdout
        c_idct = np.frombuffer(c_bytes, np.uint8).reshape(simd.shape)
        jpegs[name] = dict(shape=list(simd.shape), simd=image_digest(simd), c=image_digest(c_idct))
    grey = decode_image(W.raw_format_files()["pfm_row.pfm"])[0]
    bgr = np.repeat(grey[:, :, None], 3, axis=2)
    resized = {f"{h}x{w}": image_digest(cv2.resize(bgr, (w, h), interpolation=cv2.INTER_LINEAR))
               for h, w in chip_smoke.PFM_RESIZES}
    return dict(files=files, jpeg_overflow=jpegs, pfm_resize=resized)


def main():
    out = REPO / "tests" / "torch_writer_digests.json"
    out.write_text(json.dumps(digests(), indent=1, sort_keys=True) + "\n")
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
