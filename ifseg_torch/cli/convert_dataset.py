"""Dataset conversion: image + annotation directories -> IFSeg TSVs.

The port of the JAX package's ``cli/convert_dataset.py`` (the CLI stand-in for
the reference's conversion notebooks
convert_segmentation_{ade,coco,coco_unseen_split}.ipynb), with the port's own
codecs in place of PIL (``data/image.py``): each TSV row is
``base64(PNG image) \t base64(label PNG) \t id \t line_id`` with the label
values shifted so 0 = ignore and v = class v-1 (the loader's inverse shift,
data/mm_data/segmentation_dataset.py:230-234).  The image is kept in its mode
(a JPEG original as its L or RGB pixels, a PNG one as its own mode and
palette), as PIL's ``save`` keeps it; the label is written as an 8-bit gray
PNG after the 256-entry lookup.  The PNG bytes differ from PIL's (another
zlib stream, no filters), what both packages' readers decode from each row
does not.

Modes (label remaps taken verbatim from the notebooks):
  ade          ADEChallengeData2016 layout: raw values 0..149 -> class+1,
               150 -> 0 (ade nb cell 1)
  coco_fine    COCO-Stuff: raw ids with gaps -> compact 171 classes + 1,
               255/unlabeled -> 0 (coco nb cell 1)
  coco_unseen  the 15-category unseen split carved out of coco_fine
               (coco_unseen nb cell 2)
  generic      raw 0..C-1 classes + 255 ignore -> class+1, 255 -> 0

Usage:
  python -m ifseg_torch.cli.convert_dataset --mode=ade \\
      --images=ADEChallengeData2016/images/validation \\
      --annotations=ADEChallengeData2016/annotations/validation \\
      --output=dataset/ade/validation.tsv

Rows are converted by ``--workers`` processes (a ``multiprocessing`` pool of
the ``spawn`` context: a caller may hold threads, and ``fork`` is unsafe
there) and written sorted by line id; an annotation without an image gives
no row.  The parent builds the codecs' libraries before the pool starts, so
the workers only load them.
"""

import argparse
import base64
import logging
import os
from multiprocessing import get_context
from pathlib import Path

import numpy as np

from ifseg_torch.data import jpeg, png
from ifseg_torch.data.image import decode_image

logger = logging.getLogger(__name__)

# COCO-Stuff raw id -> compact fine id, +1 shift applied, unmapped/255 -> 0
# — convert_segmentation_coco.ipynb cell 1 (raw keys with gaps at
# 11,25,28,29,44,65,67,68,70,82,90)


def _build_coco_fine_map():
    raw_keys = (
        list(range(0, 11)) + list(range(12, 25)) + [26, 27]
        + list(range(30, 44)) + list(range(45, 65)) + [66, 69]
        + list(range(71, 82)) + list(range(83, 90)) + list(range(91, 182))
    )
    assert len(raw_keys) == 171, len(raw_keys)
    full = {k: 0 for k in range(256)}
    for compact, raw in enumerate(raw_keys):
        full[raw] = compact + 1  # +1 shift: 0 reserved for ignore
    full[255] = 0
    return full


COCO_FINE_MAP = _build_coco_fine_map()

# shifted fine id -> unseen split id (keys are the *shifted* fine values the
# map is applied to) — convert_segmentation_coco_unseen_split.ipynb cell 2
COCO_UNSEEN_FINE_IDS = {
    30: 1, 37: 2, 89: 3, 52: 4, 77: 5, 29: 6, 24: 7, 20: 8, 138: 9,
    161: 10, 158: 11, 113: 12, 137: 13, 95: 14, 134: 15,
}


def ade_map():
    m = {k: k + 1 for k in range(150)}
    m[150] = 0
    full = {k: 0 for k in range(256)}
    full.update(m)
    return full


def generic_map():
    m = {k: k + 1 for k in range(255)}
    m[255] = 0
    return m


def unseen_map():
    # compose: raw coco -> shifted fine -> unseen (nb applies the unseen remap
    # to the already-shifted fine map; non-unseen shifted ids -> 0)
    return {
        raw: COCO_UNSEEN_FINE_IDS.get(fine, 0)
        for raw, fine in COCO_FINE_MAP.items()
    }


MAPS = {
    "ade": ade_map,
    "coco_fine": lambda: COCO_FINE_MAP,
    "coco_unseen": unseen_map,
    "generic": generic_map,
}


def _b64_png(pixels, mode=None, palette=None) -> str:
    return base64.b64encode(png.encode_png(pixels, mode, palette)).decode()


def convert_row(args):
    """One TSV row, or None where no image of the annotation's stem exists."""
    line_id, seg_path, image_dir, image_exts, mapping = args
    stem = Path(seg_path).stem
    img_path = None
    for ext in image_exts:
        cand = os.path.join(image_dir, stem + ext)
        if os.path.exists(cand):
            img_path = cand
            break
    if img_path is None:
        return None
    with open(img_path, "rb") as fp:
        image = decode_image(fp.read())
    with open(seg_path, "rb") as fp:
        seg = decode_image(fp.read())[0].copy()
    lut = np.zeros(256, np.uint8)
    for k, v in mapping.items():
        if 0 <= k < 256:
            lut[k] = v
    seg = lut[seg]
    return "\t".join([_b64_png(*image), _b64_png(seg), stem, str(line_id)])


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--mode", choices=sorted(MAPS), required=True)
    p.add_argument("--images", required=True)
    p.add_argument("--annotations", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--workers", type=int, default=16)
    p.add_argument("--image-exts", default=".jpg,.jpeg,.png")
    args = p.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    mapping = MAPS[args.mode]()
    exts = args.image_exts.split(",")
    seg_files = sorted(Path(args.annotations).glob("*.png"))
    tasks = [
        (i + 1, str(f), args.images, exts, mapping) for i, f in enumerate(seg_files)
    ]
    logger.info("%d annotation files", len(tasks))
    os.makedirs(os.path.dirname(os.path.abspath(args.output)), exist_ok=True)
    # build the codecs here, once: the workers only load them
    jpeg.load()
    png.load()
    with get_context("spawn").Pool(args.workers) as pool:
        rows = [r for r in pool.imap(convert_row, tasks, chunksize=8) if r]
    rows.sort(key=lambda x: int(x.rsplit("\t", 1)[-1]))
    with open(args.output, "w") as fp:
        fp.write("\n".join(rows) + "\n")
    logger.info("wrote %d rows to %s", len(rows), args.output)
    return len(rows)


if __name__ == "__main__":
    main()
