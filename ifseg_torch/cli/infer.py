"""Single-image segmentation inference and visualisation.

The port of the JAX package's ``cli/infer.py``, the command-line stand-in for
the reference's visualize_segmentation_web.ipynb: load a checkpoint with the
given categories, keep-ratio resize, one full forward, optional ResNet label
propagation (top-k 5 x 25 iterations in the notebook), bilinear upsampling
to the original resolution, an optional dense CRF, the argmax, and a
colour-map overlay written to disk.  On the card unless ``--device=cpu`` is
given:

  python -m ifseg_torch.cli.infer --image=photo.jpg \\
      --checkpoint=checkpoints/checkpoint_best \\
      --category-list='cat, dog' --arch=segofa_base \\
      --output=overlay.png [--crf-iters=10] [--crf-backend=device|cpp] \\
      [--resnet-iters=25] [--device=cpu]

``--crf-backend=device`` (the default; ``jax`` in the JAX package) runs the
mean field on the model's device (``ops/crf_device.py``), ``cpp`` on the host
(``ops/crf.py``).  The checkpoint is a ``.pt`` file or a checkpoint
directory of ``cli.train`` (``checkpoint/convert.py:load_model``).  The image
is any file ``data/image.py`` reads (PNG, JPEG, GIF, BMP, DIB, TIFF, WebP,
JPEG 2000, ICO, CUR, Netpbm, PSD, TGA, SGI, QOI, PCX, DCX, IM, DDS with
BC1-BC7 blocks, FTEX, BLP, ICNS, SUN, MSP, XBM, XPM, GBR, PIXAR, XVThumb,
McIdas, IMT, SPIDER, FITS); the
overlay is written in the format ``--output``'s extension names, with the
bytes PIL's ``save`` writes (``WRITERS``): PNG for ``*.png``/``*.apng``, JPEG
for ``*.jpg``/``*.jpeg``/``*.jfif``/``*.jpe``/``*.mpo``
(``data/jpeg.py:encode_jpeg``), BMP for ``*.bmp`` and the same without its
file header for ``*.dib`` (``data/bmp.py``), uncompressed TIFF for
``*.tif``/``*.tiff`` (``data/tiff.py``), a P6 file for ``*.pbm``, ``*.pgm``,
``*.ppm``, ``*.pnm`` and ``*.pfm`` (``data/ppm.py``: PIL writes an RGB image
as P6 whatever the Netpbm extension), raw TGA for ``*.tga``/``*.icb``/
``*.vda``/``*.vst``, raw SGI for ``*.bw``/``*.rgb``/``*.rgba``/``*.sgi``,
QOI, run-length PCX, IM and uncompressed DDS (``data/{tga,sgi,qoi,pcx,im,
dds}.py``; IM and SGI headers hold the file's name); the mask beside it is
always a PNG file.  The extensions of the other formats the port reads
(``REFUSED``) raise before the model loads, naming why: ``.icns`` needs
PIL's thumbnail encoder, PIL's ``.blp``, ``.msp`` and ``.xbm`` writers fail
on an RGB image too, and PIL writes none of the rest.
"""

import argparse
import functools
import logging
import os
import sys
import time
from typing import List, Optional

import numpy as np
import torch

from ifseg_torch.checkpoint.convert import load_model
from ifseg_torch.config import Config, model_config_for_arch
from ifseg_torch.data.bmp import encode_bmp
from ifseg_torch.data.dds import encode_dds
from ifseg_torch.data.im import encode_im
from ifseg_torch.data.image import decode_image_rgb
from ifseg_torch.data.jpeg import encode_jpeg
from ifseg_torch.data.pcx import encode_pcx
from ifseg_torch.data.png import encode_png
from ifseg_torch.data.ppm import encode_ppm
from ifseg_torch.data.qoi import encode_qoi
from ifseg_torch.data.segmentation_dataset import prompt_tokens
from ifseg_torch.data.sgi import EXTENSIONS as SGI_EXTENSIONS, encode_sgi
from ifseg_torch.data.tga import EXTENSIONS as TGA_EXTENSIONS, encode_tga
from ifseg_torch.data.tiff import encode_tiff
from ifseg_torch.data.transforms import KeepRatioResize, normalize_image
from ifseg_torch.eval.evaluator import masked_label_propagation
from ifseg_torch.ops.crf import dense_crf
from ifseg_torch.ops.crf_device import dense_crf_device
from ifseg_torch.ops.resize import bilinear_matrix

logger = logging.getLogger(__name__)

# the overlay's writer by the extension of --output, as PIL picks its format
WRITERS = {".png": encode_png, ".jpg": encode_jpeg, ".jpeg": encode_jpeg, ".bmp": encode_bmp,
           ".tif": encode_tiff, ".tiff": encode_tiff,
           **{ext: encode_ppm for ext in (".pbm", ".pgm", ".ppm", ".pnm", ".pfm")},
           # another name for bytes of the writers above
           ".apng": encode_png, ".jfif": encode_jpeg, ".jpe": encode_jpeg, ".mpo": encode_jpeg,
           ".dib": functools.partial(encode_bmp, header=False),
           **{ext: encode_tga for ext in TGA_EXTENSIONS},
           **{ext: encode_sgi for ext in SGI_EXTENSIONS},
           ".qoi": encode_qoi, ".pcx": encode_pcx, ".im": encode_im, ".dds": encode_dds}
# the writers whose header holds the file's name, as PIL's IM and SGI ones do
NAMED = (".im",) + SGI_EXTENSIONS
# extensions of formats the port reads but does not write, and why
REFUSED = {
    ".icns": "PIL writes ICNS as PNG thumbnails of the image resized to every icon size, an "
             "encoder the port does not have (ROADMAP A.11.6)",
    ".blp": "PIL's BLP writer takes palette (P) images only and fails on the RGB overlay too",
    ".msp": "PIL's MSP writer takes 1-bit images only and fails on the RGB overlay too",
    ".xbm": "PIL's XBM writer takes 1-bit images only and fails on the RGB overlay too",
    **{ext: "PIL has no writer for it either" for ext in
       (".ftc", ".ftu", ".ras", ".gbr", ".fit", ".fits", ".pxr", ".xpm")},
}


def writer_extension(path: str) -> str:
    """``path``'s extension, lower case, where ``WRITERS`` has a writer for
    it; ValueError otherwise."""
    ext = os.path.splitext(path)[1].lower()
    if ext in REFUSED:
        raise ValueError(f"--output={path}: the port reads {ext} files but does not write them: "
                         f"{REFUSED[ext]}")
    if ext not in WRITERS:
        raise ValueError(f"--output={path}: {ext or 'no extension'} is not a format this CLI "
                         f"writes (name it {', '.join('*' + e for e in WRITERS)})")
    return ext


def encode_overlay(overlay: np.ndarray, path: str) -> bytes:
    """The bytes ``Image.fromarray(overlay).save(path)`` writes: the writer
    of ``path``'s extension."""
    ext = writer_extension(path)
    if ext in NAMED:
        return WRITERS[ext](overlay, os.path.basename(path))
    return WRITERS[ext](overlay)


def _colormap(n):
    """A qualitative colour map (the Pascal VOC bit shuffle)."""
    cmap = np.zeros((n, 3), np.uint8)
    for i in range(n):
        r = g = b = 0
        c = i
        for j in range(8):
            r |= ((c >> 0) & 1) << (7 - j)
            g |= ((c >> 1) & 1) << (7 - j)
            b |= ((c >> 2) & 1) << (7 - j)
            c >>= 3
        cmap[i] = (r, g, b)
    return cmap


def main(argv: Optional[List[str]] = None) -> dict:
    """Run the CLI; returns the paths written, the class areas and the host
    milliseconds of each stage (the device's stages end in a synchronize)."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--image", required=True)
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--category-list", required=True)
    p.add_argument("--arch", default="segofa_base")
    p.add_argument("--output", default="overlay.png")
    p.add_argument("--bpe-dir", default="assets/BPE")
    p.add_argument("--patch-image-size", type=int, default=512)
    p.add_argument("--resnet-iters", type=int, default=25)
    p.add_argument("--resnet-topk", type=int, default=5)
    p.add_argument("--crf-iters", type=int, default=10)
    p.add_argument("--crf-backend", default="device", choices=("device", "cpp"),
                   help="the permutohedral mean field on the model's device (device) "
                        "or the ctypes C++ lattice on the host (cpp)")
    p.add_argument("--alpha", type=float, default=0.5, help="overlay opacity")
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO, stream=sys.stdout)

    device = torch.device(args.device or "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("infer: no CUDA device (pass --device=cpu to run on the CPU)")
    writer_extension(args.output)  # an unknown extension fails before the model loads
    categories = [c.strip() for c in args.category_list.split(",") if c.strip()]
    num_seg = len(categories)
    cfg = Config()
    cfg = cfg.replace(model=model_config_for_arch(
        args.arch, num_seg_tokens=num_seg, patch_image_size=args.patch_image_size,
        orig_patch_image_size=args.patch_image_size))
    src = torch.from_numpy(prompt_tokens(args.bpe_dir, categories, cfg.task.prompt_prefix))
    model = load_model(args.checkpoint, cfg.model).to(device).eval()

    ms = {}
    clock = [time.perf_counter()]

    def lap(name):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        now = time.perf_counter()
        ms[name] = (now - clock[0]) * 1e3
        clock[0] = now

    with open(args.image, "rb") as fp:
        rgb = decode_image_rgb(fp.read())
    bgr = rgb[:, :, ::-1].copy()
    H, W = rgb.shape[:2]
    lap("decode")
    img_resized = KeepRatioResize((args.patch_image_size * 4, args.patch_image_size))(bgr)
    net_in = normalize_image(img_resized[:, :, ::-1], (0.5,) * 3, (0.5,) * 3)[None]
    lap("resize")

    with torch.inference_mode():
        logits, extra = model(src_tokens=src.to(device),
                              patch_images=torch.from_numpy(net_in).to(device),
                              bos_tokens=torch.zeros(1, 1, dtype=torch.long, device=device))
        resnet_feats = extra["encoder_returns"]["image_embed_before_proj"]
        hp = -(-img_resized.shape[0] // 16)
        wp = -(-img_resized.shape[1] // 16)
        hw = hp * wp
        probs = torch.softmax(logits[:, :hw].float(), dim=-1)
        lap("forward")
        if args.resnet_iters > 0:
            probs = masked_label_propagation(
                probs, resnet_feats, torch.ones(hw, dtype=torch.bool, device=device),
                args.resnet_topk, args.resnet_iters)
        probs = probs.cpu().numpy().reshape(hp, wp, num_seg)
        lap("label_propagation")

    # bilinear upsample to the original resolution (host; one image)
    up = np.einsum("Hk,kwc->Hwc", bilinear_matrix(hp, H), probs)
    up = np.einsum("Wk,hkc->hWc", bilinear_matrix(wp, W), up)
    lap("upsample")

    if args.crf_iters > 0:
        if args.crf_backend == "device":
            up = dense_crf_device(torch.from_numpy(bgr).to(device, torch.float32),
                                  torch.from_numpy(up).to(device, torch.float32),
                                  n_iter=args.crf_iters).cpu().numpy()
        else:
            up = dense_crf(bgr, up.astype(np.float32), n_iter=args.crf_iters)
        lap("crf")

    seg = up.argmax(-1).astype(np.int32)
    cmap = _colormap(max(num_seg, 8))
    overlay = (args.alpha * cmap[seg % len(cmap)] + (1 - args.alpha) * rgb).astype(np.uint8)
    with open(args.output, "wb") as fp:
        fp.write(encode_overlay(overlay, args.output))
    seg_path = os.path.splitext(args.output)[0] + "_mask.png"
    with open(seg_path, "wb") as fp:
        fp.write(encode_png(cmap[seg % len(cmap)]))
    lap("write")
    areas = {categories[i]: int((seg == i).sum()) for i in np.unique(seg)}
    logger.info("classes present: %s", areas)
    logger.info("wrote %s and %s", args.output, seg_path)
    return {"output": args.output, "mask": seg_path, "areas": areas, "ms": ms}


if __name__ == "__main__":
    main()
