"""Segmentation serving daemon: dynamic batching over the SegServer fast path.

The port of the JAX package's ``cli/serve.py``: every batch-independent bias
pack is precomputed once at start (``eval/serving.py``), a background worker
collects requests into zero-padded batches of one fixed size, and each
request gets back its class-id mask as PNG or its class areas as JSON.  On
the card unless ``--device=cpu`` is given:

  python -m ifseg_torch.cli.serve --checkpoint=ofa_base.pt \\
      --category-list='cat, dog' --port=8321 [--max-batch=8] \\
      [--batch-timeout-ms=5] [--quantize=int8] [--device=cpu]

  POST /segment            body = a PNG, JPEG, GIF, BMP, TIFF, WebP, JPEG 2000,
                           ICO, CUR, Netpbm or PSD file (any other format, or
                           a file PIL refuses: 400)
                           ?format=png (default; the class-id mask at the
                           model grid, resized to the input's size) | json
                           (areas)
  GET  /healthz            liveness and warm-up state
  GET  /stats              request and batch counters

The request's pixels are decoded and resized as the JAX package's PIL calls
do (``data/image.py:decode_image_rgb``, ``data/transforms.py:pil_resize``),
so the network's input is the JAX daemon's bit for bit.  Where that daemon
takes any format PIL reads, this one takes PNG, JPEG, GIF, BMP, TIFF, WebP,
JPEG 2000, ICO, CUR, Netpbm and PSD files (ROADMAP A.11 lists the rest).
"""

import argparse
import json
import logging
import queue
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional

import numpy as np
import torch

from ifseg_torch.checkpoint.convert import load_model
from ifseg_torch.config import Config, model_config_for_arch
from ifseg_torch.data.image import decode_image_rgb
from ifseg_torch.data.png import encode_png
from ifseg_torch.data.segmentation_dataset import prompt_tokens
from ifseg_torch.data.transforms import pil_resize
from ifseg_torch.eval.serving import SegServer
from ifseg_torch.models.segofa import SegOFA

logger = logging.getLogger(__name__)


class SegService:
    """Owns the server (model, bias pack, cast or int8 weights) and the
    batching worker."""

    def __init__(self, cfg: Config, model: SegOFA, categories: List[str], src_tokens: np.ndarray,
                 max_batch: int = 8, batch_timeout_ms: float = 5.0, quantize: str = "none",
                 device=None):
        self.cfg = cfg
        self.categories = categories
        self.max_batch = max_batch
        self.batch_timeout = batch_timeout_ms / 1e3
        self.size = cfg.model.patch_image_size
        self.grid = self.size // 16
        self.server = SegServer(model, src_len=src_tokens.shape[1], device=device,
                                quantize=quantize)
        if quantize == "int8":
            r = self.server.quant_report
            logger.info("int8 weight-only serving: %d tensors quantized (%d kept), "
                        "%.0f MB -> %.0f MB", r["quantized"], r["kept"],
                        r["bytes_fp32"] / 1e6, r["bytes_quant"] / 1e6)
        dev = self.server.device
        self.src = torch.as_tensor(src_tokens, device=dev).expand(max_batch, -1).contiguous()
        self._bos = torch.zeros(max_batch, 1, dtype=torch.long, device=dev)
        self._q = queue.Queue()
        self.stats = {"requests": 0, "batches": 0, "batched_requests": 0}
        self.ready = False
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._worker.start()

    def forward(self, images: np.ndarray) -> np.ndarray:
        """Class ids (max_batch, grid²) of a (max_batch, size, size, 3) fp32
        batch: the served forward and an argmax over the grid cells."""
        logits = self.server(self.src, torch.from_numpy(images), self._bos)
        hw = self.grid * self.grid
        return logits[:, :hw].float().argmax(dim=-1).cpu().numpy()

    def warmup(self):
        self.forward(np.zeros((self.max_batch, self.size, self.size, 3), np.float32))
        self.ready = True
        logger.info("warmed up the serving forward (batch=%d, %dpx)", self.max_batch, self.size)

    def _preprocess(self, data: bytes):
        # the network consumes RGB (training normalizes RGB after the
        # BGR-ordered augmentations flip back)
        rgb = decode_image_rgb(data)
        h0, w0 = rgb.shape[:2]
        rgb = pil_resize(rgb, (self.size, self.size)).astype(np.float32) / 255.0
        return (rgb - 0.5) / 0.5, (h0, w0)

    def submit(self, data: bytes, timeout: float = 120.0):
        """Blocking: preprocess, enqueue, wait for the batch worker ->
        (class ids (grid, grid), (h, w) of the original)."""
        net_in, orig = self._preprocess(data)
        ev = threading.Event()
        slot = {"img": net_in, "ev": ev, "mask": None, "error": None}
        self._q.put(slot)
        if not ev.wait(timeout):
            raise RuntimeError("segmentation worker timed out")
        if slot["error"] is not None:
            raise RuntimeError(f"segmentation worker failed: {slot['error']}")
        return slot["mask"], orig

    def close(self, timeout: float = 30.0):
        """Stop the worker once the requests queued before this call are answered."""
        self._q.put(None)
        self._worker.join(timeout)

    def _loop(self):
        while True:
            first = self._q.get()
            if first is None:
                return
            batch = [first]
            deadline = time.monotonic() + self.batch_timeout
            stop = False
            while len(batch) < self.max_batch:
                rest = deadline - time.monotonic()
                if rest <= 0:
                    break
                try:
                    slot = self._q.get(timeout=rest)
                except queue.Empty:
                    break
                if slot is None:
                    stop = True
                    break
                batch.append(slot)
            n = len(batch)
            try:
                imgs = np.zeros((self.max_batch, self.size, self.size, 3), np.float32)
                for i, slot in enumerate(batch):
                    imgs[i] = slot["img"]
                out = self.forward(imgs)
                for i, slot in enumerate(batch):
                    slot["mask"] = out[i].reshape(self.grid, self.grid).astype(np.int32)
            except Exception as e:  # a device failure fails the batch, not the worker:
                # its requests get a 500 instead of a wedge
                logger.exception("batched forward failed")
                for slot in batch:
                    slot["error"] = repr(e)
                self.stats["errors"] = self.stats.get("errors", 0) + n
            finally:
                for slot in batch:
                    slot["ev"].set()
            self.stats["requests"] += n
            self.stats["batches"] += 1
            self.stats["batched_requests"] += n if n > 1 else 0
            if stop:
                return


def _make_handler(svc: SegService):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            logger.debug(fmt, *args)

        def _send(self, code, body, ctype="application/json"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path.startswith("/healthz"):
                body = json.dumps({"ok": True, "ready": svc.ready}).encode()
                self._send(200 if svc.ready else 503, body)
            elif self.path.startswith("/stats"):
                self._send(200, json.dumps(svc.stats).encode())
            else:
                self._send(404, b'{"error": "not found"}')

        def do_POST(self):
            if not self.path.startswith("/segment"):
                self._send(404, b'{"error": "not found"}')
                return
            length = int(self.headers.get("Content-Length", 0))
            data = self.rfile.read(length)
            try:
                mask, (h0, w0) = svc.submit(data)
            except RuntimeError as e:  # worker or device failure
                self._send(500, json.dumps({"error": str(e)[:200]}).encode())
                return
            except Exception as e:  # neither PNG nor JPEG, a broken file, ...
                self._send(400, json.dumps({"error": str(e)[:200]}).encode())
                return
            if "format=json" in self.path:
                areas = {
                    svc.categories[int(c)]: int((mask == c).sum())
                    for c in np.unique(mask)
                    if int(c) < len(svc.categories)
                }
                self._send(200, json.dumps({"areas": areas, "grid": mask.shape[0]}).encode())
            else:
                up = pil_resize(mask.astype(np.uint8), (h0, w0), nearest=True)
                self._send(200, encode_png(up), ctype="image/png")

    return Handler


def build_service(args_list: Optional[List[str]] = None, model: Optional[SegOFA] = None):
    """(args, service) from the CLI flags; ``model`` may be given (tests),
    else it is loaded from ``--checkpoint`` (a ``.pt`` file or a checkpoint
    directory of ``cli.train``) or, without one, drawn at random from seed 0."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--checkpoint", default="")
    p.add_argument("--category-list", required=True)
    p.add_argument("--arch", default="segofa_base")
    p.add_argument("--bpe-dir", default="assets/BPE")
    p.add_argument("--patch-image-size", type=int, default=512)
    p.add_argument("--port", type=int, default=8321)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--batch-timeout-ms", type=float, default=5.0)
    p.add_argument(
        "--quantize", default="none", choices=["none", "int8"],
        help="int8: weight-only quantization (per-channel scales); the "
        "transformer's linears stay int8 on the device and dequantize inside "
        "each forward",
    )
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = p.parse_args(args_list)

    device = torch.device(args.device or "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("serve: no CUDA device (pass --device=cpu to run on the CPU)")
    categories = [c.strip() for c in args.category_list.split(",") if c.strip()]
    num_seg = len(categories)
    cfg = Config()
    cfg = cfg.replace(model=model_config_for_arch(
        args.arch, num_seg_tokens=num_seg, patch_image_size=args.patch_image_size,
        orig_patch_image_size=args.patch_image_size))
    cfg.task.num_seg_tokens = num_seg
    cfg.task.category_list = args.category_list
    cfg.task.bpe_dir = args.bpe_dir
    src = prompt_tokens(args.bpe_dir, categories, cfg.task.prompt_prefix)

    if model is None:
        if args.checkpoint:
            model = load_model(args.checkpoint, cfg.model)
        else:
            model = SegOFA(cfg.model).init(torch.Generator().manual_seed(0))
            logger.warning("no --checkpoint: serving randomly initialized weights")

    svc = SegService(cfg, model, categories, src, max_batch=args.max_batch,
                     batch_timeout_ms=args.batch_timeout_ms, quantize=args.quantize,
                     device=device)
    return args, svc


def main(argv: Optional[List[str]] = None):
    logging.basicConfig(level=logging.INFO, stream=sys.stdout)
    args, svc = build_service(argv)
    svc.warmup()
    httpd = ThreadingHTTPServer((args.host, args.port), _make_handler(svc))
    logger.info("serving on http://%s:%d", args.host, args.port)
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()
        svc.close()


if __name__ == "__main__":
    main()
