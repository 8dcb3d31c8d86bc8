"""Host time of the port's row codecs beside PIL's and cv2's, on the same rows.

    python3 tools/time_host_codecs.py [--passes N] [--out FILE]

Builds the 24 TSV rows of ``chip_smoke.py``'s phase 11 (its own PNG writer,
seed 0) and decodes each row two ways, as an evaluation row is decoded:

  * the port's: ``ifseg_torch.data.png.decode_png`` and
    ``ifseg_torch.data.transforms.resize_image`` (numpy, zlib and the C++
    unfilter built at first use);
  * the libraries the JAX package uses: ``np.asarray(PIL.Image.open(...))``
    and ``cv2.resize(..., INTER_LINEAR)``.

It first checks that both give the same bytes on every row, then prints the
mean milliseconds a row of base64 + decode of the image, of its keep-ratio
resize and of base64 + decode of the label, for each way on one thread; the
rows a second of the whole row (image and label) on 1, 4 and 8 threads; and
one JSON line with all of it.  It needs PIL and cv2 (the port does not), and
runs on the host alone.
"""

import argparse
import base64
import io
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import cv2
import numpy as np
from PIL import Image

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402  (its TSV rows)
from ifseg_torch.data.png import decode_png  # noqa: E402
from ifseg_torch.data.transforms import imrescale_size, resize_image  # noqa: E402

SCALE = (2048, 512)  # the keep-ratio box of --patch-image-size=512
THREADS = (1, 4, 8)


def to_bgr(arr):
    if arr.ndim < 3:
        arr = np.repeat(arr[:, :, None], 3, axis=2)
    elif arr.shape[2] == 4:
        arr = arr[:, :, :3]
    return np.ascontiguousarray(arr[:, :, ::-1])


def port_decode(b64):
    return decode_png(base64.urlsafe_b64decode(b64))


def library_decode(b64):
    return np.asarray(Image.open(io.BytesIO(base64.urlsafe_b64decode(b64))))


def port_resize(img):
    return resize_image(img, imrescale_size(*img.shape[:2], SCALE))


def library_resize(img):
    h, w = imrescale_size(*img.shape[:2], SCALE)
    return cv2.resize(img, (w, h), interpolation=cv2.INTER_LINEAR)


WAYS = {"port": (port_decode, port_resize), "pil_cv2": (library_decode, library_resize)}


def whole_row(way, row):
    decode, resize = WAYS[way]
    return resize(to_bgr(decode(row[0]))), decode(row[1])


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--passes", type=int, default=5, help="timed passes over the rows")
    ap.add_argument("--out", default=None, help="also write the JSON line to this file")
    args = ap.parse_args()
    try:
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=60).stdout.strip()
    except FileNotFoundError:
        card = ""
    card = card.splitlines()[0] if card else "no card"
    rows = [(base64.urlsafe_b64encode(img), base64.urlsafe_b64encode(lab))
            for img, lab, _ in chip_smoke.valid_rows()]

    for i, row in enumerate(rows):  # also builds the unfilter
        (pi, pl), (li, ll) = whole_row("port", row), whole_row("pil_cv2", row)
        if not (np.array_equal(pi, li) and np.array_equal(pl, ll)):
            raise SystemExit(f"time_host_codecs: row {i}: the port's bytes differ from PIL/cv2's")

    ms = {}
    for way, (decode, resize) in WAYS.items():
        parts = {"image_decode": 0.0, "image_resize": 0.0, "label_decode": 0.0}
        for _ in range(args.passes):
            for row in rows:
                t0 = time.perf_counter()
                img = to_bgr(decode(row[0]))
                t1 = time.perf_counter()
                resize(img)
                t2 = time.perf_counter()
                decode(row[1])
                t3 = time.perf_counter()
                parts["image_decode"] += t1 - t0
                parts["image_resize"] += t2 - t1
                parts["label_decode"] += t3 - t2
        n = args.passes * len(rows)
        ms[way] = {k: v * 1e3 / n for k, v in parts.items()}
        ms[way]["row"] = sum(ms[way].values())
        print(f"{way}: {ms[way]['row']:.3f} ms a row on one thread (image decode "
              f"{ms[way]['image_decode']:.3f}, resize {ms[way]['image_resize']:.3f}, label decode "
              f"{ms[way]['label_decode']:.3f}); host of the machine with {card}", flush=True)

    rate = {}
    for way in WAYS:
        rate[way] = {}
        for t in THREADS:
            with ThreadPoolExecutor(t) as pool:
                list(pool.map(lambda r: whole_row(way, r), rows))
                t0 = time.perf_counter()
                for _ in range(args.passes):
                    list(pool.map(lambda r: whole_row(way, r), rows))
                rate[way][t] = args.passes * len(rows) / (time.perf_counter() - t0)
        print(f"{way}: rows a second on {', '.join(map(str, THREADS))} threads: "
              f"{', '.join(f'{rate[way][t]:.1f}' for t in THREADS)}", flush=True)

    line = json.dumps({"card_line": card, "cpus": os.cpu_count(), "rows": len(rows),
                       "passes": args.passes, "ms_per_row": ms, "rows_per_s": rate})
    if args.out:
        Path(args.out).write_text(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
