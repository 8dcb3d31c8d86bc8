#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (an H100 is the target).

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when it fails:
  1. the card: name and power limit (nvidia-smi), torch and CUDA versions;
  2. build every kernel with nvcc and the host C++ sources of the PNG
     decoder, the JPEG decoder and encoder, the GIF, BMP (RLE), TIFF, WebP
     and JPEG 2000 decoders, the run-length loops of TGA, SGI, PCX, QOI, IM
     and DDS, the dense CRF and the experts' auction with c++ (one process
     per source, all at once), with each kernel instantiation's
     registers, spill and stack from the ``-Xptxas -v`` summary, and the
     HGMMA count and shared memory of the three wgmma attention libraries at
     both head dims;
  3. each kernel against its plain PyTorch version, with its time, the plain
     version's, one PyTorch library call's (timed only here, never used by
     the port) and the bound: the attention forward without stats at the
     serving shapes (batch 32) and at the three sites of an evaluation group
     of 8 at the (512, 768) bucket (decoder self-attention causal WITH a key
     mask), then the forward with stats, the di pre-pass, the dq + dbias
     kernel and the dk + dv kernel at the training shapes (batch 16; the
     backward kernels also without dbias and without a bias), plus a small
     ragged case with an fp32 bias, one without a bias, and the edges of the
     kernels' tiles (Lq and Lk of 1, 63 to 65, 127 to 129 and 257, causal
     with Lk > Lq, a padded key tile, row-padded bias storage), checked but
     not timed, the backward kernels on dense and on row-padded biases at
     every case, the forward also at phase 11's validate sites (215 text
     tokens) and at phase 13's (the daemon's batch of 8 at 512 x 512 with
     215 tokens; cli.infer's batch-1 forwards over 32 x 43 cells with 215
     and 17 tokens, and over phase 14's 32 x 83 with 17), checked; the
     host time of a launch's tensor-map encodes; the LayerNorm kernel at
     every (rows, width, dtype) that a served batch-32 forward, an
     evaluation group of 8 at the (512, 768) bucket (with 32 and with 215
     text tokens) and a monitoring forward at batch 16 give it (the fp32
     position LayerNorms included), timed, and that phase 13's two paths and
     phase 14's cli.infer give it, checked, a ragged row count, a
     narrow and the widest width, and its autograd Function's forward +
     backward beside ``F.layer_norm``'s;
  4. the serving path at full OFA-Base 512px width, random weights from seed
     0: ``SegServer`` on the card answers batches of 1, 8 and 32; the launch
     counts of the kernels (and the forward's bias routes) are set to 0 just
     before and read just after;
  5. the card's bf16 logits against the port's fp32 forward on the CPU, on
     the same weights and a batch-2 input;
  6. the training path at full width: ``Trainer`` on the card takes image-
     free steps at batch 16 on artificial grids (15 classes, ``src_len``
     32), first without and then with the monitoring forward; launch counts
     set to 0 before and read after, every forward launch's bias fetched by
     TMA and no bias copied by the backward; loss, gnorm, counters, moved and
     frozen parameters checked;
  7. one loss + backward of the image-free loss at batch 2 on the card
     (bf16, kernels) against the CPU (fp32, plain versions), same weights,
     dropout off: loss, global gradient norm, and the cosine between the two
     gradients of a handful of tensors;
  8. the native-resolution evaluation path at full width (150 classes,
     label propagation top-3 x 25 iterations): ``Evaluator.eval_dataset`` on
     the card over fabricated uint8 samples in two groups, one of 8 rows of
     different pixel shapes inside the (512, 768) bucket and one at
     (512, 512); launch counts set to 0 before and read after, every bias
     fetched by TMA; areas, loss and grouping checked; ms per group with and
     without label propagation, peak memory of groups of 4, 32 and 64;
  9. the padded forward against the exact-shape forward on the card, and the
     card's evaluation output against the port's fp32 CPU ``Evaluator`` on
     the same weights and one group of two rows;
 10. SegOFA-Huge (24 + 12 layers, width 1,280, 16 heads: head dim 80, FFN
     5,120, ResNet-152 stem) at full width and depth, weights from seed 0
     built on the card, after its kernels were held against their plain
     versions in phase 3 (``[3 huge]``: K1, K1-stats, di, K2, K3 at head dim
     80 and K4 at width 5,120, at its serving, evaluation and training
     shapes): ``SegServer`` at batch 8; ``Trainer`` image-free steps at batch
     16; ``Evaluator`` on the trainer's model, one group of 8 uint8 rows at
     the (512, 768) bucket, the trainer's parameters still fp32 after it;
     launch counts set to 0 before each path and read after; then, at a
     reduced depth (2 + 2 layers) and full width, the card's logits and
     gradients against the CPU's;
 11. validation from TSV rows to mIoU: a TSV of 24 rows written by the
     script's own PNG writer (colour types 0, 2, 3, 6, palette labels at 1,
     2 and 4 bits, all five row filters; original shapes that take every
     branch of the keep-ratio resize), an ofa_base.pt-shaped checkpoint
     fabricated on the card; the decoded and resized rows against SHA-256
     digests of what PIL and cv2 give; the loaded weights against the file
     and the seed-0 init; ``ifseg_torch.cli.validate.main`` with the ADE
     flags of run_scripts/IFSeg/ade.sh and common.sh (150 classes, label
     propagation top-3 x 25, groups of 8) on the card, launch counts set to 0
     before and read after; host ms a row (image, label), each group's host
     packing, forward wall time and the card's busy time in it (a profiler
     trace), peak memory, img/s; the per-group logs of that run, on the
     group cheapest for the CPU, against the fp32 CPU ``Evaluator``;
 12. the training CLI: ``ifseg_torch.cli.train.main`` on the card with the
     flags of run_scripts/IFSeg/common.sh + ade.sh (OFA-Base, 150 classes,
     batch 16, the monitoring forward, the erf gelu, cosine LR, the freeze and
     drop-path flags, 8 row threads), phase 11's fabricated ofa_base.pt, phase
     11's TSV to validate and, twice over (48 rows: 3 steps an epoch), to
     train: 2 epochs with launch counts set to 0 before and read after, the
     manifest and the checkpoints on disk checked; one step traced by the
     profiler; one thread's ms a training row (decode and each augmentation);
     a run to epoch 3 without the reset flags (6 updates restored) stopped by
     --max-update=7 (a mid-epoch checkpoint with the cursor, no epoch save),
     and one resumed from that cursor, every restored state held to the files
     bit for bit; the image-free fast path (no training row decoded); the
     first epoch on one thread (--num-workers=0); s/step, data_wait, save and
     resume ms, checkpoint bytes, validation img/s and mIoU, peak memory;
 13. the serving surface at OFA-Base full width and depth, phase 11's
     fabricated checkpoint: ``ifseg_torch.cli.serve`` (150 ADE classes,
     batches of 8, a 5 ms window) over HTTP on localhost, 32 PNG requests of
     480 x 640 to 1,024 x 1,366 from 1 and from 8 clients, every answer (mask
     PNG or JSON areas) held to ``forward_served`` on the padded batch that
     held its image, a malformed GIF body (one PIL refuses) refused with 400;
     requests/s, latency p50 and
     p99, mean batch size, host ms a request against card ms a batch, K1 and
     K4 launches a batch; int8 ``SegServer`` beside bf16 at batches 8 and 32
     (report, resident bytes, ms/forward, argmax agreement, logit error);
     ``ifseg_torch.cli.infer`` on a 512 x 683 PNG (150 classes) and a 1,024 x
     1,366 one (cat, dog), each with the device and the host CRF (10
     iterations), under PyTorch's default TF32 settings: stage ms, the device
     CRF's set-up and ms an iteration, peak memory, K1 and K4 launches, the
     outputs decoded, the card's device CRF against the CPU's on a crop, the
     card's probabilities before label propagation and before the CRF
     against the port's fp32 ``cli.infer`` on the CPU (first image); launch
     counts set to 0 before each path and read after;
 14. the files of the JAX CLIs, OFA-Base at full width and depth, phase 11's
     fabricated checkpoint: (a) the port's JPEG encoder writes 16 originals
     of 480 x 640 to 1,024 x 1,366 (RGB at 4:2:0, 4:2:2 and 4:4:4, gray;
     qualities 75 and 95) and its decoder reads them back, each file and its
     pixels held to the SHA-256 digests of PIL's bytes and PIL's pixels, and
     assets/cat_dog.jpeg (progressive) too; host ms a file for encode and
     decode at each size beside PNG's decode of the same pixels; (b)
     ``python -m ifseg_torch.cli.convert_dataset --mode=ade`` over them and
     label PNGs made from the seed, every row held to pinned digests, then
     ``cli.validate.main`` on the card with the ADE flags over the TSV it
     wrote (launch counts set to 0 before and read after), its cheapest
     group against the fp32 CPU ``Evaluator``; (e) every file of
     tests/torch_image_files/ (GIF, BMP, TIFF, CMYK / YCCK and block-smoothed
     progressive JPEG) decoded on the host, its mode, shape and the SHA-256
     of its pixels and of its RGB held to PIL's (digests.json), then GIF,
     BMP (RLE8, RLE4, 24 bits) and TIFF (raw, LZW, Deflate, CMYK) files of
     1,024 x 1,366 written on the host, each held to the arrays it was
     written from, and the full-size CMYK, YCCK and cut progressive JPEG
     files; the small TGA, SGI, QOI, PCX, DCX, IM, DDS (every BC6H and BC7
     mode too), DIB, FTEX, BLP, ICNS, SUN, MSP, XBM, XPM, GBR, PIXAR,
     XVThumb, McIdas, IMT, SPIDER and FITS files and a PFM row that
     tests/torch_image_writers.py writes (numpy only) against PIL's digests
     (tests/torch_writer_digests.json), JPEGs whose coefficients pass 16 bits
     against PIL's with the IDCT the host selects (ROADMAP C.15), the PFM
     row's float32 resizes against cv2's (C.16), and TGA, SGI, QOI, PCX, IM,
     DDS (BC1, BC6H, BC7, uncompressed), BLP2 DXT5 and FITS files of 1,024 x
     1,366 against the arrays they were written from; host ms a file by
     format and size, the
     full-size ones beside an RGB JPEG's decode and the resize to 512 x 512;
     (c) phase 13's daemon
     with 12 of the JPEG files and (e)'s full-size GIF, RLE8 BMP, LZW TIFF
     and CMYK JPEG files, each beside a PNG file of the same pixels (32
     requests), from 1 and
     from 8 clients, each answer equal to its PNG twin's and
     to a row of the batch that held it; (d) ``cli.infer`` on
     assets/cat_dog.jpeg with ``--output=*.jpg``, and on (e)'s CMYK JPEG with
     ``--output=*.bmp`` and ``--output=*.tif`` (no CRF), each overlay's bytes
     held to the port's writer (``encode_jpeg``, ``encode_bmp``,
     ``encode_tiff``) of the overlay, stage ms, K1 and K4 launches; an RGBA
     JP2, and (e)'s full-size BC7 DDS and FITS files, each beside its PNG
     twin, to ``.tga`` overlays equal byte for byte and read back;
 15. the rest of the training stack: (a) OFA-Base ``Trainer`` steps at batch
     16 with dropout and drop-path 0.1, from the same seed, weights and
     batches, with the layers not checkpointed, under save-attn and under
     full: s/step, peak memory, the attention kernels' launches a step (the
     forward with stats twice under full), the first step's loss bit-equal,
     its gradient norm within 1e-3, the dropout generator's state equal; (b)
     SegOFA-Huge at batch 32 under ``--remat-policy=auto``, which the JAX
     package's bytes model resolves to save-attn on the card: the estimate,
     the card's memory and the decision, s/step and peak memory, and the
     estimate at batch 16 beside phase 10's measured peak; (c) one update of
     every optimizer (adam, adafactor, lamb, sgd, nag, adagrad, adadelta,
     adamax, composite) on OFA-Base's trainable parameters, the card's fp32
     update against the CPU's within 1e-5, ms a step; (d)
     ``cli.train.main`` with the recipe's flags and reduce_lr_on_plateau,
     composite groups (decoder Adam, the rest LAMB) and save-attn
     checkpointing: 2 epochs of 2 steps with launch counts, the lr scale
     against the plateau controller, a resume to epoch 3 with every restored
     part (optimizer groups, lr scale, plateau, generator) held to the files
     bit for bit, and a 1-step run on the same restore file with three of
     each side's six layers kept (``--encoder/decoder-layers-to-keep``);
 16. the model's option paths and generation, OFA-Base at full width and
     depth, random weights from the seed: (a) prefix tuning (encoder and
     decoder prompts, P 100) at batch 16 with the layers not checkpointed:
     s/step and peak memory beside phase 15a's unprompted row, 1,843,200
     trainable parameters, only the prompt tables moving, the four attention
     kernels 18 times a step with every bias by TMA and no backward copy;
     once more with the prompts' projection; the card against the CPU at
     batch 2 (phase 7's checks, the prompt tables' gradient cosines); (b)
     one step each with adapters, BitFit and gelu_poly (trainable tensors,
     which moved, s/step), then ``cli.train.main`` for 2 steps with --bitfit
     and with --encoder-prompt; (c) the prompt-tuned model: the
     ``Evaluator`` launches K1 at P + L keys in both self-attentions, and
     ``SegServer`` answers as the same weights without the prompt encoders
     (the JAX package's served path applies no prefix); (d) generation,
     batch 2 x beam 5, 150 classes: the KV-cached generator over 256
     tokens and the uncached one (``decode_ar``, K1 and K4 counted) over
     32, ms a generated token; ``decode_ar``'s logits against ``ar_step``'s
     at each of 258 positions; the cached generator on the card against
     the CPU (fp32 both) over 64 tokens; an ensemble of two weight sets (and
     of one twice, equal to the model alone); a trie-constrained run.  Phase 3
     also checks K1 at ``decode_ar``'s sites and phase 3t times the four
     kernels at the prefix-tuned self-attentions (P + L keys);
 17. multi-process training and evaluation, OFA-Base at full width and
     depth, phase 15a's configuration without dropout from one seeded start
     (weights of the seed, Adam moments drawn from it): (a) one process over
     NCCL (world size 1) under data parallelism, FSDP, ZeRO-1 and tensor
     parallelism, 2 + 5 steps at batch 16 each against the unwrapped
     trainer's (loss, gnorm, the parameter updates' cosines), s/step and peak
     memory beside phase 15a's off row, the collectives' ms a step (a
     profiler trace); (b) two processes sharing the card over gloo (NCCL
     takes one rank a card), the fixed table of what that carries, each
     strategy at degree 2 on 8 + 8 rows against one process's step on the 16,
     ``check_grad_norms`` and ``check_param_sync`` true, every bias by TMA,
     tensor parallelism with the monitoring forward (its split FFN
     LayerNorm's rows gathered for K4) against one process's, s/step, peak
     memory and the host ms in gloo's collectives a step
     (``parallel.comm.TRAFFIC``); in (a) and (b), with the start state on
     the host, each strategy's peak above the card's bytes before its
     build and above the step's start, the most whole FSDP bytes alive at
     once, the all-gathers and reduce-scatters a step with their bytes, and
     the script's predicted saving of FSDP's per-unit gathering, FSDP's
     peak at degree 2 below DDP's by at least half of it; (c) ``cli.train
     --num-processes=2 --fsdp=2`` on phase 11's rows with the recipe's flags
     (2 steps, a validation, a checkpoint written by rank 0 alone), the
     checkpoint restored into one process equal to the files, and
     ``cli.validate`` on two processes against one, one row a forward: the
     same mIoU (the two CLIs' runs and the one-process validation side by
     side);
 18. the model axis's programs, two processes sharing the card over gloo
     from 17b's start: the GPipe pipeline (``--pipeline-parallel=2``) at 2
     and 4 microbatches and ring attention (``--context-parallel=2``), each
     against one process's step on the 16 rows (17b's tolerances; the
     pipeline at 2 and the ring also with the monitoring forward), and the
     BASE experts (``--moe-experts=2 --moe-freq=2``) with Sinkhorn and with
     the auction: one expert layer on the step's activations against the
     dense loop, every expert at exactly its capacity, the auction's score
     at least Sinkhorn's, the experts moving; s/step, peak memory, the
     collectives' calls, bytes and host ms a step, the kernels' launches
     a rank;
 19. the training run's surface, OFA-Base at full width and depth, phase
     11's fabricated checkpoint and rows: (a) ``cli.train`` with the recipe's
     flags for 2 updates with ``--tensorboard-logdir`` under
     ``utils/profiling.py``'s ``profile_to``: the Chrome trace holds one
     ``train_step-{i}`` span an update with the forward with stats, di, the
     dq + dbias and the dk + dv kernels each launched 18 times inside it;
     the event file, read back by the script's own reader (the TFRecord
     framing and both CRC-32Cs, the Event, Summary and Value fields), holds
     exactly the logged stats; (b) that run's state written in the layout
     ``tools/orbax_to_torch.py`` writes (no ``generator.pt`` and no
     ``plateau.pt``, the extra file as the JAX CLI writes it, the manifest
     taken over) and ``cli.train`` resumed from it at the saved epoch and
     update, every restored part equal to the files and the trainer's
     generator equal to a card generator seeded with seed + step; (c) ``LightConv`` and ``DynamicConv``
     at width 768 over 1,025 tokens (kernel 3 with 4 heads, kernel 31 with
     16, causal and not): forward and backward in fp32 and bf16 on the card
     against the CPU's fp32 on 2 rows, ms a call at batch 16, and
     ``DummySegTask()`` with no device making its batches on the card;
     launch counts set to 0 before (a) and (b) and read after;
 20. one JSON line listing every kernel, the nvidia-smi line, and the last
     line ``{"ok": true, "device": {...}}``.

It imports nothing of JAX and nothing of the JAX package ``ifseg_tpu``.
"""

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent

# H100 SXM data-sheet peaks (dense bf16 tensor cores; HBM3), at 700 W
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12  # outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12

ATTN_TOL = 2e-2  # kernel (bf16 P in the P·V product, bf16 output) vs fp32 plain
LSE_TOL = 1e-3  # row logsumexp, fp32 on both sides
DI_TOL = 1e-3  # di: fp32 sums of 64 products of bf16 values, relative to max |ref|
# dq, dk, dv, dbias: the kernels round p and ds to bf16 before the last
# products and write bf16, the plain version computes in fp32 from the same
# bf16 inputs: max |Δ| relative to max |ref|
GRAD_REL_TOL = 2e-2
LOGIT_REL_TOL = 5e-2  # card bf16 forward vs CPU fp32 forward, ||Δ|| / ||ref||
# training, card bf16 vs CPU fp32 (phase 7)
TRAIN_LOSS_REL_TOL = 2e-2
TRAIN_GNORM_REL_TOL = 2e-2
TRAIN_COSINE_MIN = 0.99
# LayerNorm kernel vs its plain version on the same inputs: a bf16 output is
# the fp32 value rounded once on both sides, and the fp32 values differ in
# their last bits (other summation order, rsqrt), so the two lie at most one
# bf16 step apart (2^-7 of the value at most); an fp32 output differs by
# those last bits, 1e-5 absolute
LN_BF16_ULPS = 1
LN_FP32_TOL = 1e-5
# evaluation, card bf16 vs CPU fp32 (phase 9): the share of pixels whose
# argmax differs (random weights have small margins: the served forward's
# per-cell agreement is 0.98) and the relative error of the mean nll
EVAL_PIXEL_SHARE_TOL = 5e-2
EVAL_NLL_REL_TOL = 2e-2
SEED = 0
SRC_LEN = 32
VALID_SRC_LEN = 215  # phase 11: bos + the ADE prompt and 150 class names + 'unknown' + eos
EVAL_CLASSES = 150
TRAIN_BATCH = 16
TRAIN_CLASSES = 15
HUGE_SERVE_BATCH = 8
# the reference recipe's batch (run_scripts/IFSeg/common.sh); it fits without
# activation checkpointing (64 GiB at its peak)
HUGE_TRAIN_BATCH = 16
HUGE_CHECK_LAYERS = 2  # encoder and decoder layers of the CPU comparisons at Huge's width
# phase 16: prefix tuning's P (the config's default length) on both sides,
# the generator's batch and beam, its lengths: the cached generator at 256
# tokens (up to 1,022, the longest the token relative bias covers, runs the
# same code; 256 keeps the run inside its time), the uncached one at 32, and
# the card-against-CPU comparison (fp32 both) at 64
PROMPT_LEN = 100
GEN_BATCH, GEN_BEAM = 2, 5
GEN_MAX_LEN, GEN_RECOMPUTE_LEN, GEN_COMPARE_LEN = 256, 32, 32
AR_LOGIT_REL_TOL = 5e-2  # decode_ar (bf16, kernels) against ar_step (fp32), ||Δ|| / ||ref||
GEN_SCORE_REL_TOL = 1e-3  # the cached generator's scores, card fp32 against CPU fp32

# The two configurations the run drives: their attention heads and head dim,
# widths and depths (ifseg_torch/config.py)
BASE = dict(name="OFA-Base", arch="segofa_base", heads=12, head_dim=64, width=768, ffn=3072,
            enc_layers=6, dec_layers=6)
HUGE = dict(name="SegOFA-Huge", arch="segofa_huge", heads=16, head_dim=80, width=1280, ffn=5120,
            enc_layers=24, dec_layers=12)


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str):
    print(msg, flush=True)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` in ms, by CUDA events after warm-up."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cuda_ms_queued(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` in ms for a kernel shorter than its own
    launch costs the host: the launches are queued behind about 20 ms of
    matrix products, so the card runs them back to back and the events
    bracket device time alone."""
    for _ in range(warmup):
        fn()
    a = torch.ones(8192, 8192, dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for _ in range(16):
        torch.matmul(a, a)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_busy_ms(fn) -> float:
    """Device time of one ``fn()`` in ms: the summed durations of the kernels
    and copies a ``torch.profiler`` trace of it records (one stream, so they
    do not overlap); the host's gaps between them are not counted."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    us = 0.0
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) == torch.autograd.DeviceType.CUDA:
            t = getattr(ev, "self_device_time_total", None)
            us += t if t is not None else getattr(ev, "self_cuda_time_total", 0.0)
    if us <= 0.0:
        fail("the profiler recorded no device time")
    return us / 1e3


# ---------------------------------------------------------------- phase 1

def phase_card() -> str:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs an NVIDIA GPU")
    if not (REPO / "ifseg_torch" / "csrc").is_dir():
        fail(f"no ifseg_torch/ package beside {Path(__file__).name}: run it from a checkout")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    log(f"[1] card: {card}")
    log(f"[1] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    # parity phases compare fp32 products: no TF32 in matmuls or cuDNN convs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


# ---------------------------------------------------------------- phase 2

def phase_build():
    from ifseg_torch.data import bmp, gif, jpeg, jpeg2000, png, tga, tiff, webp
    from ifseg_torch.ops import balanced_assignment, build, crf
    from ifseg_torch.ops import flash_attention as fa
    from ifseg_torch.ops import layer_norm as ln

    # the CUDA sources and the host C++ sources of the PNG decoder, the JPEG
    # codec, the GIF, BMP, TIFF, WebP (VP8, VP8L) and JPEG 2000 decoders, the
    # run-length loops of TGA, SGI, PCX, QOI, IM and DDS, the dense CRF and the
    # experts' auction, all at once
    host_sources = (png.SOURCE, jpeg.DECODER, jpeg.ENCODER, gif.SOURCE, bmp.SOURCE, tiff.SOURCE,
                    *webp.SOURCES, jpeg2000.SOURCE, tga.SOURCE, crf.SOURCE,
                    balanced_assignment.SOURCE)
    t0 = time.perf_counter()
    results = build.build([*fa.KERNELS, ln.KERNEL, *host_sources])
    log(f"[2] built {sorted(results)} in {time.perf_counter() - t0:.1f} s")
    summary = {}
    for res in results.values():
        compiler = "c++" if res.name in host_sources else "nvcc"
        log(f"[2] {res.name}: {res.path.name}, {compiler} {res.seconds:.1f} s")
        shown = set()
        for line in res.log.splitlines():  # warnings, once each
            text = line.strip()
            if ("error" in text.lower() or "warning" in text.lower()) and text not in shown:
                shown.add(text)
                log(f"[2]   {text}")
        summary[res.name] = ptxas_summary(res.log)
        for row in summary[res.name]:  # every instantiation's registers, spill, stack
            log(f"[2]   {row['name']}: {row.get('registers')} registers, spill stores "
                f"{row.get('spill_stores')} / loads {row.get('spill_loads')} bytes, stack "
                f"{row.get('stack')} bytes, {row['c7519']} C7519 notes (warpgroup.arrive "
                f"injected)")
    # the attention kernels' products must run on the warpgroup tensor-core
    # path: (library, kernel name, instantiations: bias dtype x variant x head dim)
    for lib, kernel, n in ((fa.KERNEL, "attn_bias_fwd_kernel", 8),
                           (fa.KERNEL_BWD_DQ, "attn_bias_bwd_dq_kernel", 8),
                           (fa.KERNEL_BWD_DKV, "attn_bias_bwd_dkv_kernel", 4)):
        hgmma = {k: c for k, c in sass_counts(results[lib].path, "HGMMA").items() if kernel in k}
        smem = ", ".join(f"D={d}: {fa.smem_bytes(lib, False, d)} bytes with a bf16 bias, "
                         f"{fa.smem_bytes(lib, True, d)} with an fp32 bias" for d in fa.HEAD_DIMS)
        log(f"[2] {lib}: HGMMA operations per instantiation (cuobjdump -sass): "
            f"{sorted(hgmma.values())} over {len(hgmma)} kernels; one CTA of 384 threads an SM, "
            f"dynamic shared memory {smem} (of 232,448)")
        if len(hgmma) != n or min(hgmma.values()) < 1:
            fail(f"{lib}: the SASS shows no HGMMA in some instantiation: {hgmma}")
    return summary


def _template_args(s: str):
    """The template arguments at the start of ``s``, an Itanium-mangled
    argument list after its ``I``: bf16, fp32, bools and ints."""
    out, i = [], 0
    while i < len(s) and s[i] != "E":
        if s.startswith("13__nv_bfloat16", i):
            out.append("bf16")
            i += len("13__nv_bfloat16")
        elif s[i] == "f":
            out.append("fp32")
            i += 1
        elif s.startswith("Lb", i) or s.startswith("Li", i):
            j = s.index("E", i)
            out.append({"Lb1": "true", "Lb0": "false"}.get(s[i:j], s[i + 2:j]))
            i = j + 1
        elif s[i] == "S":  # a substitution: the one class type these kernels name
            out.append("bf16")
            i = s.index("_", i) + 1
        else:
            break
    return out


def ptxas_summary(log_text: str):
    """One dict per kernel instantiation of an ``nvcc -Xptxas -v`` log: its
    name with template arguments, registers, spill stores and loads, stack."""
    import re

    def short(mangled):
        k = re.search(r"\d+([a-z_]+_kernel)I(.*)", mangled)
        return mangled if k is None else f"{k.group(1)}<{', '.join(_template_args(k.group(2)))}>"

    rows, notes = [], {}
    for line in log_text.splitlines():
        m = re.search(r"\(C7519\).* in function '([^']+)'", line)
        if m:  # ptxas serialised wgmma around registers it could not prove untouched
            notes[short(m.group(1))] = notes.get(short(m.group(1)), 0) + 1
            continue
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            rows.append(dict(name=short(m.group(1))))
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and rows:
            rows[-1].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                            spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and rows:
            rows[-1]["registers"] = int(m.group(1))
    for row in rows:
        row["c7519"] = notes.get(row["name"], 0)
    return rows


def sass_counts(library: Path, opcode: str):
    """Occurrences of ``opcode`` in each kernel of a built library, from
    ``cuobjdump -sass`` (the toolkit's, beside nvcc)."""
    import shutil

    from ifseg_torch.ops import build

    tool = Path(build._nvcc()).with_name("cuobjdump")
    tool = str(tool) if tool.exists() else shutil.which("cuobjdump")
    if tool is None:
        fail("cuobjdump not found beside nvcc or on PATH")
    sass = subprocess.run([tool, "-sass", str(library)], capture_output=True, text=True,
                          timeout=300)
    if sass.returncode != 0:
        fail(f"cuobjdump failed: {sass.stderr.strip()[:500]}")
    counts, name = {}, None
    for line in sass.stdout.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            counts[name] = 0
        elif name is not None and opcode in line:
            counts[name] += 1
    return counts


# ---------------------------------------------------------------- phase 3

def attn_sites(spec):
    """The three attention sites of the served forward of ``spec`` at 512px,
    src_len 32: (name, Lq, Lk, causal, key-padding mask, sites per forward)."""
    enc, dec = spec["enc_layers"], spec["dec_layers"]
    return [
        ("encoder self", 1024 + SRC_LEN, 1024 + SRC_LEN, False, True, enc),
        ("decoder self", 1 + 1024, 1 + 1024, True, False, dec),
        ("decoder cross", 1 + 1024, 1024 + SRC_LEN, False, True, dec),
    ]


SITES = attn_sites(BASE)


# The three attention sites of an evaluation group at the (512, 768) bucket:
# a padded grid of 32 x 48 cells of which 32 x 43 are valid, so the padded
# cells are masked as keys at every site, and decoder self-attention is causal
# with a key mask; (name, Lq, Lk, causal, sites per group forward).
EVAL_GRID = (32, 48, 32, 43)  # padded (Hp, Wp), valid (hp, wp)
EVAL_ROWS = 8


def eval_sites(spec):
    enc, dec = spec["enc_layers"], spec["dec_layers"]
    return [
        ("eval encoder self", 32 * 48 + SRC_LEN, 32 * 48 + SRC_LEN, False, enc),
        ("eval decoder self", 1 + 32 * 48, 1 + 32 * 48, True, dec),
        ("eval decoder cross", 1 + 32 * 48, 32 * 48 + SRC_LEN, False, dec),
    ]


EVAL_SITES = eval_sites(BASE)


def validate_sites(spec):
    """The two sites of a phase 11 group of 8 at the (512, 768) bucket whose
    key length the 215-token ADE prompt changes."""
    enc, dec = spec["enc_layers"], spec["dec_layers"]
    return [
        ("validate encoder self", 32 * 48 + VALID_SRC_LEN, 32 * 48 + VALID_SRC_LEN, False, enc),
        ("validate decoder cross", 1 + 32 * 48, 32 * 48 + VALID_SRC_LEN, False, dec),
    ]


def decode_ar_sites():
    """K1's sites in ``Decoder.decode_ar`` over t generated tokens (phase
    16d's batch 2 x beam 5): causal self-attention at Lq = Lk = t and
    cross-attention at Lq = t over the encoder's 1,024 + 32 keys, its text
    rows padded; t = 34 is the uncached generator's (32 tokens, BOS, EOS),
    the others the tile edges it would reach at other lengths.
    (name, B, Lq, Lk, causal, key mask)."""
    b = GEN_BATCH * GEN_BEAM
    t_gen = GEN_RECOMPUTE_LEN + 2
    return ([(f"decode_ar self t={t}", b, t, t, True, False) for t in (1, 2, 17, t_gen, 64)]
            + [(f"decode_ar cross t={t}", b, t, 1024 + SRC_LEN, False, True)
               for t in (1, 17, t_gen)])


def eval_key_mask(b, lk):
    """Key-padding mask of an evaluation site: the padded grid cells, behind
    the BOS slot in decoder self-attention (Lk odd), before the prompt in the
    other two, whose last row's prompt ends in padding."""
    gh, gw, hp, wp = EVAL_GRID
    cell = torch.arange(gh * gw, device="cuda")
    grid_pad = ~((cell // gw < hp) & (cell % gw < wp))
    mask = torch.zeros(b, lk, dtype=torch.bool, device="cuda")
    if lk == 1 + gh * gw:
        mask[:, 1:] = grid_pad
    else:
        mask[:, : gh * gw] = grid_pad
        mask[-1, lk - 5:] = True
    return mask


def visible_pairs(lq, lk, causal):
    if not causal:
        return lq * lk
    return int(np.minimum(np.arange(lq) + (lk - lq) + 1, lk).sum())


def attention_work(b, h, lq, lk, d, causal, bias_bytes, masked, kind="fwd"):
    """(flops, bytes) the function needs.  Each product is 2·B·H·pairs·D flops
    over the visible (q, k) pairs: the forward does 2, dq + dbias 3, dk + dv
    4.  Bytes: each input read once, each output written once (bf16 operands,
    fp32 lse and di, the bias in its dtype, the mask in bytes)."""
    products = {"fwd": 2, "stats": 2, "dq": 3, "dkv": 4}[kind]
    flops = products * 2 * b * h * visible_pairs(lq, lk, causal) * d
    row, stat, bias = 2 * h * d, 4 * b * h * lq, h * lq * lk * bias_bytes
    nbytes = {
        "fwd": b * (2 * lq + 2 * lk) * row + bias,  # q, k, v in; out
        "stats": b * (2 * lq + 2 * lk) * row + bias + stat,  # + lse out
        "dq": b * (3 * lq + 2 * lk) * row + 2 * bias + 2 * stat,  # q k v do lse di bias; dq dbias
        "dkv": b * (2 * lq + 4 * lk) * row + bias + 2 * stat,  # q k v do lse di bias; dk dv
    }[kind]
    if masked:
        nbytes += b * lk
    return flops, nbytes


def bound_ms(flops, nbytes, peak_flops=PEAK_BF16_FLOPS):
    t_ops = flops / peak_flops * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


# Edges of the forward kernel's 128-row query tile, its 128-key stages and the
# two ways it stages the bias (by TMA where the rows are 16-byte aligned, else
# by threads), checked against the plain version but not timed:
# (name, B, Lq, Lk, causal, key mask, bias dtype or None, bias rows padded).
# Mask "tile" pads a whole key tile (keys 128..255) and the last row's tail.
EDGE_CASES = [
    ("edge 1x1 causal", 2, 1, 1, True, False, torch.bfloat16, False),
    ("edge 1x257", 1, 1, 257, False, True, torch.bfloat16, False),
    ("edge 63x64 causal", 2, 63, 64, True, True, torch.bfloat16, False),
    ("edge 64x63", 2, 64, 63, False, True, torch.float32, False),
    ("edge 65x129 causal", 2, 65, 129, True, True, torch.bfloat16, False),
    ("edge 127x128 no bias", 2, 127, 128, False, True, None, False),
    ("edge 128x127", 2, 128, 127, False, False, torch.bfloat16, True),
    ("edge 128x128 causal fp32 bias", 2, 128, 128, True, False, torch.float32, False),
    ("edge 129x65 fp32 bias", 2, 129, 65, False, True, torch.float32, False),
    ("edge 129x257 causal, padded key tile", 2, 129, 257, True, "tile", torch.bfloat16, False),
    ("edge 257x257 causal, padded key tile, padded bias rows", 2, 257, 257, True, "tile",
     torch.bfloat16, True),
    ("edge 257x1", 2, 257, 1, False, False, torch.bfloat16, False),
    ("edge 64x257 batch 1, padded key tile", 1, 64, 257, False, "tile", torch.bfloat16, False),
]


def site_inputs(b, h, lq, lk, causal, masked, bias_dtype, seed, head_dim=64):
    g = torch.Generator(device="cuda").manual_seed(seed)
    e = h * head_dim

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * scale

    q = rnd(b, lq, e, scale=0.3).bfloat16()
    k = rnd(b, lk, e, scale=0.3).bfloat16()
    v = rnd(b, lk, e).bfloat16()
    bias = rnd(h, lq, lk).to(bias_dtype)
    mask = None
    if masked == "eval":
        mask = eval_key_mask(b, lk)
    elif masked == "clear":
        mask = torch.zeros(b, lk, dtype=torch.bool, device="cuda")
    elif masked:  # the text rows of the last sample end in padding, as in serving
        mask = torch.zeros(b, lk, dtype=torch.bool, device="cuda")
        mask[-1, max(lk - 7, 1):] = True
        if masked == "tile":
            mask[:, 128:256] = True
    return q, k, v, bias, mask


def sdpa_ms(q, k, v, bias, mask, causal, h, iters):
    """One ``scaled_dot_product_attention`` call on the same inputs, the bias,
    causal and padding masks folded into one additive ``attn_mask``."""
    import torch.nn.functional as F
    from ifseg_torch.ops.flash_attention import NEG_INF

    b, lq, e = q.shape
    lk = k.shape[1]
    add = bias.to(torch.bfloat16)[None]
    if causal:
        keep = torch.ones(lq, lk, dtype=torch.bool, device=q.device).tril(lk - lq)
        add = add.masked_fill(~keep, NEG_INF)
    if mask is not None:
        add = add.masked_fill(mask[:, None, None, :], NEG_INF)
    qh, kh, vh = (x.view(b, -1, h, e // h).transpose(1, 2) for x in (q, k, v))
    call = lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=add, scale=1.0)
    ms = cuda_ms(call, iters)
    del add
    return ms


def phase_kernels(spec=BASE, batch=32, tag="[3]"):
    """K1 of ``spec``'s head dim against its plain version at the served
    sites (``batch``), the sites of an evaluation group of 8, a ragged case
    and the tile edges; timed at the first two."""
    from ifseg_torch.ops import flash_attention as fa

    h, d = spec["heads"], spec["head_dim"]
    prefix = "" if spec is BASE else "huge "
    rows = []
    # every bias of the main paths comes in row-padded storage (the decoder's
    # 1,025 or 1,537 keys a row become a pitch of 1,032 or 1,544)
    cases = [(prefix + name, batch, lq, lk, causal, masked, torch.bfloat16, True, n, 0, 0)
             for name, lq, lk, causal, masked, n in attn_sites(spec)]
    # a small ragged shape with an fp32 bias, checked but not timed
    cases.append((prefix + "ragged check", 3, 77, 130, True, True, torch.float32, False, 0, 0, 0))
    # the evaluation group's sites; a validate group of phase 11 shares its
    # decoder self-attention and has 215 text tokens in the other two
    cases += [(prefix + name, EVAL_ROWS, lq, lk, causal, "eval", torch.bfloat16, True, 0, n,
               n if spec is BASE and causal else 0)
              for name, lq, lk, causal, n in eval_sites(spec)]
    if spec is BASE:
        cases += [(name, EVAL_ROWS, lq, lk, causal, "eval", torch.bfloat16, True, 0, 0, n)
                  for name, lq, lk, causal, n in validate_sites(spec)]
        # the (512, 512) bucket's group of 4 with 215 text tokens, checked
        cells = 32 * 32
        cases += [(name, 4, lq, lk, causal, True, torch.bfloat16, True, 0, 0, 0) for name, lq, lk, causal in (
            ("validate (512, 512) encoder self", cells + VALID_SRC_LEN, cells + VALID_SRC_LEN, False),
            ("validate (512, 512) decoder self", 1 + cells, 1 + cells, True),
            ("validate (512, 512) decoder cross", 1 + cells, cells + VALID_SRC_LEN, False))]
        # phase 13's two paths, checked: the daemon's batches and cli.infer's
        # batch-1 forwards, no key padded (an all-False mask where the model
        # passes one)
        cases += [(name, b, lq, lk, causal, "clear" if masked else False, torch.bfloat16, True,
                   0, 0, 0) for name, b, lq, lk, causal, masked in surface_sites()]
        # phase 16d's autoregressive decode, checked
        cases += [(name, b, lq, lk, causal, masked, torch.bfloat16, True, 0, 0, 0)
                  for name, b, lq, lk, causal, masked in decode_ar_sites()]
    cases += [(prefix + name, *case, 0, 0, 0) for name, *case in EDGE_CASES]
    for i, (name, b, lq, lk, causal, masked, bias_dtype, padded, per_fwd,
            per_group, per_valid) in enumerate(cases):
        q, k, v, bias, mask = site_inputs(b, h, lq, lk, causal, masked,
                                          bias_dtype or torch.bfloat16, seed=i, head_dim=d)
        bias = None if bias_dtype is None else fa.row_padded(bias) if padded else bias
        out = fa.flash_attention_bias_packed_infer(q, k, v, bias, mask, causal, h)
        torch.cuda.synchronize()
        want = fa.attention_bias_reference(q.float(), k.float(), v.float(),
                                           None if bias is None else bias.float(), mask, causal, h)
        err = (out.float() - want).abs().max().item()
        finite = bool(torch.isfinite(out).all())
        del want, out
        log(f"{tag} {name}: B={b} H={h} D={d} Lq={lq} Lk={lk} causal={causal} mask={masked} "
            f"bias={None if bias is None else str(bias_dtype).split('.')[-1]} "
            f"pitch={None if bias is None else bias.stride(1)}: max_abs_err={err:.3e}")
        if not finite or not err <= ATTN_TOL:
            fail(f"kernel disagrees with its plain version at {name}: {err} > {ATTN_TOL}")
        row = dict(site=name, B=b, H=h, D=d, Lq=lq, Lk=lk, causal=causal, per_forward=per_fwd,
                   per_eval_group=per_group, per_validate_group=per_valid, max_abs_err=err)
        if per_fwd or per_group or per_valid:
            flops, nbytes = attention_work(b, h, lq, lk, d, causal,
                                           bias.element_size(), bool(masked))
            row["bound_ms"], row["bound_by"] = bound_ms(flops, nbytes)
            row["gflop"], row["mb"] = flops / 1e9, nbytes / 1e6
            row["kernel_ms"] = cuda_ms(
                lambda: fa.flash_attention_bias_packed_infer(q, k, v, bias, mask, causal, h), 20)
            row["plain_ms"] = cuda_ms(
                lambda: fa.attention_bias_reference(q, k, v, bias, mask, causal, h), 3, warmup=1)
            try:
                row["library_ms"] = sdpa_ms(q, k, v, bias, mask, causal, h, 10)
            except RuntimeError as exc:  # the yardstick only; the port never calls it
                log(f"{tag}   scaled_dot_product_attention failed: {exc}")
                row["library_ms"] = None
            row["share_of_bound"] = row["bound_ms"] / row["kernel_ms"]
            # what the host pays per launch to encode the call's TMA tensor maps
            row["encode_host_us"] = fa.tensor_map_encode_us(q, k, v, bias, h)
            log(f"{tag}   kernel_ms={row['kernel_ms']:.4f} plain_ms={row['plain_ms']:.4f} "
                f"library_ms={row['library_ms']} bound_ms={row['bound_ms']:.4f} "
                f"({row['bound_by']}; {row['gflop']:.1f} GFLOP, {row['mb']:.1f} MB) "
                f"share_of_bound={row['share_of_bound']:.3f} "
                f"tensor-map encodes {row['encode_host_us']:.2f} us of host time a launch")
        rows.append(row)
        del q, k, v, bias, mask
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------- phase 3, LayerNorm kernel

def ln_launches_per_forward(model, position_lns: bool) -> int:
    """LayerNorm sites one no-gradient forward runs, from the module list:
    every LayerNorm but the decoder's ``pos_ln`` (autoregressive path only),
    and without the three position LayerNorms where the biases are
    precomputed (serving)."""
    from ifseg_torch.models.layers import LayerNorm

    names = [n for n, m in model.named_modules() if isinstance(m, LayerNorm)]
    skip = {"decoder.pos_ln"}
    if not position_lns:
        skip |= {"encoder.pos_ln", "encoder.image_pos_ln", "decoder.seg_pos_ln"}
    return len([n for n in names if n not in skip])


def within_bf16_step(got, want) -> bool:
    """Every element of bf16 ``got`` within one bf16 step of ``want``: a step
    is at most 2^-7 of the value, plus the fp32 tolerance for values near 0,
    where a last-bit difference before rounding spans many tiny steps."""
    diff = (got.float() - want.float()).abs()
    return bool((diff <= want.float().abs() * 2.0 ** -7 * LN_BF16_ULPS + LN_FP32_TOL).all())


def ln_sites(batch: int, cells: int, position_lns: bool, spec=BASE, src_len: int = SRC_LEN):
    """The LayerNorm sites of one no-gradient forward of ``spec`` over a grid
    of ``cells`` image tokens and ``src_len`` text tokens: (name, rows, width, input dtype,
    output dtype, sites per forward).  The two embedding LayerNorms, then per
    layer three (encoder) or five (decoder) of the model's width (768 for
    OFA-Base, 1,280 for Huge) and the ffn_layernorm of the FFN's (3,072;
    5,120), then the final one; where the biases are built in the forward
    (evaluation, monitoring), the three fp32 position LayerNorms, once per
    forward whatever the batch."""
    bf16, fp32 = torch.bfloat16, torch.float32
    enc, dec = cells + src_len, 1 + cells
    w, f, n_enc, n_dec = spec["width"], spec["ffn"], spec["enc_layers"], spec["dec_layers"]
    sites = [
        ("patch embedding", batch * cells, w, bf16, bf16, 1),
        ("text embedding", batch * src_len, w, bf16, bf16, 1),
        ("encoder layers + final", batch * enc, w, bf16, bf16, n_enc * 3 + 1),
        ("encoder ffn", batch * enc, f, bf16, bf16, n_enc),
        ("decoder embedding + layers + final", batch * dec, w, bf16, bf16, 1 + n_dec * 5 + 1),
        ("decoder ffn", batch * dec, f, bf16, bf16, n_dec),
    ]
    if position_lns:
        sites += [
            ("text positions", src_len, w, fp32, fp32, 1),
            ("image positions", cells, w, fp32, fp32, 1),
            ("seg positions", dec, w, fp32, fp32, 1),
        ]
    return sites


# The main paths that launch the LayerNorm kernel: the served batch-32 forward
# at 512px (biases precomputed), an evaluation group of EVAL_ROWS rows on the
# padded grid of the (512, 768) bucket, the trainer's monitoring forward at
# batch TRAIN_BATCH, and a validate group (phase 11) at that bucket; keyed by
# the count's name in a site's row.
LN_PATHS = {
    "per_forward": ("served", ln_sites(32, 1024, False)),
    "per_eval_group": ("eval", ln_sites(EVAL_ROWS, EVAL_GRID[0] * EVAL_GRID[1], True)),
    "per_monitor_forward": ("monitor", ln_sites(TRAIN_BATCH, 1024, True)),
    # phase 11's group of 8 at the same bucket, with the 215-token ADE prompt
    "per_validate_group": ("validate", ln_sites(EVAL_ROWS, EVAL_GRID[0] * EVAL_GRID[1], True,
                                                src_len=VALID_SRC_LEN)),
}
# SegOFA-Huge's two: a served batch of HUGE_SERVE_BATCH and an evaluation
# group of EVAL_ROWS at the (512, 768) bucket
HUGE_LN_PATHS = {
    "per_forward": ("huge served", ln_sites(HUGE_SERVE_BATCH, 1024, False, HUGE)),
    "per_eval_group": ("huge eval", ln_sites(EVAL_ROWS, EVAL_GRID[0] * EVAL_GRID[1], True, HUGE)),
}


def ln_sites_per_pass(per_key: str, paths=LN_PATHS) -> int:
    return sum(n for *_, n in paths[per_key][1])


def phase_layer_norm(paths=LN_PATHS, tag="[3n]"):
    """K4 against its plain version at every site of ``paths``, timed, and at
    a few widths and row counts of its own, checked; for OFA-Base also its
    autograd Function at a training site."""
    import torch.nn.functional as F
    from ifseg_torch.ops import layer_norm as ln

    gen = torch.Generator(device="cuda").manual_seed(7)
    bf16, fp32 = torch.bfloat16, torch.float32
    cases = [(f"{path} {name}", n, d, in_dt, out_dt, per_key, per)
             for per_key, (path, sites) in paths.items()
             for name, n, d, in_dt, out_dt, per in sites]
    if paths is LN_PATHS:
        # phase 13's two paths, checked: the daemon's batches, cli.infer's forwards
        cases += [(f"{path} {name}", n, d, in_dt, out_dt, None, 0)
                  for path, sites in surface_ln_paths() for name, n, d, in_dt, out_dt, _ in sites]
        # phase 16d's autoregressive decode, checked: the uncached generator's
        # steps (batch 2 x beam 5 over 34 tokens) and the 1,024-token recompute
        # of two best beams
        cases += [(f"decode_ar {b}x{t} {name}", rows, d, in_dt, out_dt, None, 0)
                  for b, t in ((GEN_BATCH * GEN_BEAM, GEN_RECOMPUTE_LEN + 2), (GEN_BATCH, 1024))
                  for name, rows, d, in_dt, out_dt in (
                      ("embedding + layers + final", b * t, BASE["width"], bf16, bf16),
                      ("ffn", b * t, BASE["ffn"], bf16, bf16),
                      ("text positions", t, BASE["width"], fp32, fp32))]
        cases += [
            ("ragged row count", 1001, 768, bf16, bf16, None, 0),
            ("narrow width", 77, 32, fp32, bf16, None, 0),
            ("widest of a warp a row", 333, 4096, bf16, fp32, None, 0),
        ]
    else:  # the CTA-per-row kernel beyond Huge's 5,120, up to its widest
        cases += [
            ("just above a warp a row", 33, 4104, bf16, fp32, None, 0),
            ("width 8,192", 129, 8192, fp32, fp32, None, 0),
            ("widest", 31, ln.MAX_WIDTH, bf16, bf16, None, 0),
        ]
    rows = []
    for name, n, d, in_dt, out_dt, per_key, per in cases:
        x = (torch.randn(n, d, generator=gen, device="cuda") * 3 + 1).to(in_dt)
        scale = torch.randn(d, generator=gen, device="cuda") * 0.2 + 1
        bias = torch.randn(d, generator=gen, device="cuda") * 0.1
        got = ln.fused_layer_norm(x, scale, bias, 1e-5, out_dt)
        torch.cuda.synchronize()
        want = ln.layer_norm_reference(x, scale, bias, 1e-5, out_dt)
        err = (got.float() - want.float()).abs().max().item()
        if got.dtype != out_dt or not bool(torch.isfinite(got).all()):
            fail(f"layer_norm kernel output at {name}: {got.dtype}, finite={bool(torch.isfinite(got).all())}")
        if out_dt == bf16:
            ok = within_bf16_step(got, want)
            held = f"limit {LN_BF16_ULPS} bf16 step (2^-7 relative) + {LN_FP32_TOL}"
        else:
            ok, held = err <= LN_FP32_TOL, f"limit {LN_FP32_TOL}"
        log(f"{tag} {name}: {n} x {d} {str(in_dt).split('.')[-1]} -> {str(out_dt).split('.')[-1]}"
            f" ({'a CTA' if d > ln.WARP_MAX_WIDTH else 'a warp'} a row): max_abs_err={err:.3e}, {held}")
        if not ok:
            fail(f"layer_norm kernel disagrees with its plain version at {name}: {err}, {held}")
        row = dict(site=name, rows=n, width=d, max_abs_err=err, **{k: 0 for k in paths})
        if per_key:
            row[per_key] = per
            # x read once and y written once (scale and bias are 6 to 25 KB)
            nbytes = n * d * (x.element_size() + got.element_size()) + 2 * 4 * d
            flops = 8 * n * d
            row["bound_ms"], row["bound_by"] = bound_ms(flops, nbytes, PEAK_FP32_FLOPS)
            row["gflop"], row["mb"], row["peak_flops"] = flops / 1e9, nbytes / 1e6, PEAK_FP32_FLOPS
            # queued behind other work: one launch costs the host more than the card
            row["kernel_ms"] = cuda_ms_queued(
                lambda: ln.fused_layer_norm(x, scale, bias, 1e-5, out_dt), 50)
            row["plain_ms"] = cuda_ms_queued(
                lambda: ln.layer_norm_reference(x, scale, bias, 1e-5, out_dt), 5)
            # the library call: one F.layer_norm in the input's dtype (never called by the port)
            sb, bb = scale.to(in_dt), bias.to(in_dt)
            row["library_ms"] = cuda_ms_queued(lambda: F.layer_norm(x, (d,), sb, bb, 1e-5), 50)
            # what the module ran at this site before: cast, fp32 F.layer_norm, cast
            row["three_pass_ms"] = cuda_ms_queued(
                lambda: F.layer_norm(x.float(), (d,), scale, bias, 1e-5).to(out_dt), 20)
            row["share_of_bound"] = row["bound_ms"] / row["kernel_ms"]
            log(f"{tag}   kernel_ms={row['kernel_ms']:.4f} plain_ms={row['plain_ms']:.4f} "
                f"library_ms={row['library_ms']:.4f} three_pass_ms={row['three_pass_ms']:.4f} "
                f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']}; {row['mb']:.1f} MB) "
                f"share_of_bound={row['share_of_bound']:.3f}")
        rows.append(row)
        del x, got, want
    for per_key, (path, _) in paths.items():
        timed = [r for r in rows if r.get(per_key)]
        log(f"{tag} {path} forward, {sum(r[per_key] for r in timed)} sites: kernel "
            f"{sum(r['kernel_ms'] * r[per_key] for r in timed):.3f} ms, cast + fp32 F.layer_norm + "
            f"cast {sum(r['three_pass_ms'] * r[per_key] for r in timed):.3f} ms, bound "
            f"{sum(r['bound_ms'] * r[per_key] for r in timed):.3f} ms")
    # a width the kernel does not take raises; nothing falls back
    for d in ((100,) if paths is LN_PATHS else (ln.MAX_WIDTH + 8,)):
        try:
            ln.fused_layer_norm(torch.zeros(4, d, device="cuda"), torch.ones(d, device="cuda"),
                                torch.zeros(d, device="cuda"))
        except ValueError as exc:
            log(f"{tag} width {d} on a CUDA tensor raises: {exc}")
        else:
            fail(f"layer_norm on a CUDA tensor of width {d} did not raise")
    if paths is not LN_PATHS:
        return rows, None

    # the autograd Function (kernel forward, plain backward) beside the route
    # the module takes when a gradient flows, at one training site (16 x 1,056 rows)
    n, d = TRAIN_BATCH * (1024 + SRC_LEN), 768
    x = (torch.randn(n, d, generator=gen, device="cuda") * 3 + 1).bfloat16().requires_grad_(True)
    scale = (torch.randn(d, generator=gen, device="cuda") * 0.2 + 1).requires_grad_(True)
    bias = (torch.randn(d, generator=gen, device="cuda") * 0.1).requires_grad_(True)
    g = torch.randn(n, d, generator=gen, device="cuda").bfloat16()

    def fwd_bwd(fn):
        def run():
            y = fn()
            return torch.autograd.grad(y, (x, scale, bias), g)
        return run

    fused = fwd_bwd(lambda: ln.fused_layer_norm(x, scale, bias, 1e-5, bf16))
    stock = fwd_bwd(lambda: F.layer_norm(x.float(), (d,), scale, bias, 1e-5).to(bf16))
    errs = [rel_err(a, b)[0] for a, b in zip(fused(), stock())]
    train = dict(rows=n, width=d, function_fwd_bwd_ms=cuda_ms(fused, 10),
                 f_layer_norm_fwd_bwd_ms=cuda_ms(stock, 10), grad_rel_err=max(errs))
    log(f"[3n] forward + backward at {n} x {d} bf16: the Function (kernel forward, plain "
        f"backward) {train['function_fwd_bwd_ms']:.4f} ms, F.layer_norm in fp32 with its casts "
        f"{train['f_layer_norm_fwd_bwd_ms']:.4f} ms; gradients agree to {max(errs):.3e} "
        f"of the largest value")
    if not max(errs) <= GRAD_REL_TOL:
        fail(f"layer_norm Function gradients differ from F.layer_norm's: {errs}")
    return rows, train


# ---------------------------------------------------------------- phases 4, 5

def base_config(dtype: str):
    from ifseg_torch.config import model_config_for_arch

    return model_config_for_arch("segofa_base", patch_image_size=512,
                                 orig_patch_image_size=512, num_seg_tokens=150, dtype=dtype)


def requests(batch: int, seed: int, size: int = 512):
    """(src_tokens, images, bos) of one request batch; the last sample's
    prompt ends in padding, so the key-padding mask is live."""
    rng = np.random.default_rng(seed)
    src = rng.integers(4, 50000, size=(batch, SRC_LEN)).astype(np.int64)
    src[-1, SRC_LEN - 5:] = 1  # PAD
    img = rng.normal(size=(batch, size, size, 3)).astype(np.float32)
    bos = np.zeros((batch, 1), np.int64)
    return torch.from_numpy(src), torch.from_numpy(img), torch.from_numpy(bos)


def phase_serve(card: str):
    from ifseg_torch.eval.serving import SegServer
    from ifseg_torch.models.segofa import SegOFA
    from ifseg_torch.ops import flash_attention as fa
    from ifseg_torch.ops import layer_norm as ln

    cfg = base_config("bfloat16")
    t0 = time.perf_counter()
    model = SegOFA(cfg).init(torch.Generator().manual_seed(SEED))
    weights = {k: v.clone() for k, v in model.state_dict().items()}
    n_params = sum(p.numel() for p in model.parameters())
    torch.cuda.reset_peak_memory_stats()
    server = SegServer(model, src_len=SRC_LEN)  # the card, by default
    torch.cuda.synchronize()
    log(f"[4] OFA-Base 512px, {n_params / 1e6:.1f}M params, seed {SEED}: "
        f"init + SegServer set-up {time.perf_counter() - t0:.1f} s")
    hw = (cfg.patch_image_size // 16) ** 2
    per_forward = sum(n for *_, n in SITES)
    ln_per_forward = ln_launches_per_forward(model, position_lns=False)
    if ln_per_forward != ln_sites_per_pass("per_forward"):
        fail(f"{ln_per_forward} LayerNorm sites in the served forward, "
             f"{ln_sites_per_pass('per_forward')} held against the plain version")

    fa.reset_launches()
    ln.reset_launches()
    forwards = 0
    for i, batch in enumerate((1, 8, 32)):
        t1 = time.perf_counter()
        logits = server(*requests(batch, seed=100 + i))
        torch.cuda.synchronize()
        forwards += 1
        log(f"[4] batch {batch}: logits {tuple(logits.shape)} {logits.dtype} in "
            f"{(time.perf_counter() - t1) * 1e3:.1f} ms")
        if tuple(logits.shape) != (batch, 1 + hw, cfg.num_seg_tokens):
            fail(f"logits shape {tuple(logits.shape)}")
        if not bool(torch.isfinite(logits).all()):
            fail(f"non-finite logits at batch {batch}")
    inputs = [x.to(server.device) for x in requests(32, seed=200)]
    steps = 3
    server(*inputs)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(steps):
        server(*inputs)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t1) / steps
    forwards += 1 + steps
    launches = fa.LAUNCHES
    routes = fa.bias_route_counts()
    log(f"[4] kernel launches {launches} over {forwards} forwards "
        f"(expected {per_forward} x {forwards} = {per_forward * forwards}); bias routes {routes}")
    if launches != per_forward * forwards:
        fail("the serving path did not launch the attention kernel at every site")
    if routes["fwd_bias_threads"] or routes["fwd_bias_tma"] != launches:
        fail(f"the serving path staged a bias by threads: {routes}")
    ln_launches = ln.LAUNCHES
    log(f"[4] layer_norm kernel launches {ln_launches} (expected {ln_per_forward} x {forwards} "
        f"= {ln_per_forward * forwards})")
    if ln_launches != ln_per_forward * forwards:
        fail("the serving path did not launch the layer_norm kernel at every LayerNorm")
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    log(f"[4] steady state, batch 32: {dt * 1e3:.1f} ms/forward, {32 / dt:.2f} img/s, "
        f"max_memory_allocated {peak_gb:.2f} GiB, on {card}")
    serve = dict(img_per_s=32 / dt, ms_per_forward=dt * 1e3, max_memory_gib=peak_gb,
                 launches=launches, ln_launches=ln_launches, forwards=forwards,
                 bias_routes=routes)
    return server, weights, serve


def phase_cpu_reference(server, weights):
    from ifseg_torch.eval.serving import SegServer
    from ifseg_torch.models.segofa import SegOFA

    src, img, bos = requests(2, seed=300)
    card = server(src, img, bos).float().cpu()
    ref_model = SegOFA(base_config("float32"))
    ref_model.load_state_dict(weights, strict=True)
    t0 = time.perf_counter()
    ref = SegServer(ref_model, src_len=SRC_LEN, device="cpu")(src, img, bos)
    rel = ((card - ref).norm() / ref.norm()).item()
    agree = (card.argmax(-1) == ref.argmax(-1)).float().mean().item()
    log(f"[5] card bf16 vs CPU fp32, batch 2 ({time.perf_counter() - t0:.1f} s on the CPU): "
        f"relative logit error {rel:.3e}, per-cell argmax agreement {agree:.4f}")
    if not rel <= LOGIT_REL_TOL:
        fail(f"card logits differ from the CPU forward: {rel} > {LOGIT_REL_TOL}")
    return dict(rel_err=rel, argmax_agreement=agree)


# ---------------------------------------------------------------- phase 3, training kernels

def sdpa_train_ms(q, k, v, bias, mask, causal, h, iters):
    """(forward ms, backward ms) of ``scaled_dot_product_attention`` on the
    same inputs with the bias as a gradient-requiring additive ``attn_mask``
    (causal and padding masks folded in).  Its one backward call computes dq,
    dk, dv and dbias together, the work of both backward kernels."""
    import torch.nn.functional as F
    from ifseg_torch.ops.flash_attention import NEG_INF

    b, lq, e = q.shape
    lk = k.shape[1]
    bias_leaf = bias.detach().clone().requires_grad_(True)
    fill = torch.zeros(1, 1, lq, lk, dtype=bias.dtype, device=q.device)
    if causal:
        keep = torch.ones(lq, lk, dtype=torch.bool, device=q.device).tril(lk - lq)
        fill = fill.masked_fill(~keep, NEG_INF)
    if mask is not None:
        fill = fill + torch.zeros(b, 1, 1, lk, dtype=bias.dtype, device=q.device).masked_fill(
            mask[:, None, None, :], NEG_INF)
    leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
    qh, kh, vh = (x.view(b, -1, h, e // h).transpose(1, 2) for x in leaves)
    g = torch.ones(b, h, lq, e // h, dtype=q.dtype, device=q.device)

    def forward():
        return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=bias_leaf[None] + fill,
                                              scale=1.0)

    fwd = cuda_ms(forward, iters)
    out = forward()
    bwd = cuda_ms(lambda: torch.autograd.grad(out, leaves + [bias_leaf], g, retain_graph=True),
                  iters)
    return fwd, bwd


def rel_err(got, want):
    """max |got − want| / max |want|, and the absolute maximum."""
    diff = (got.float() - want.float()).abs().max().item()
    return diff / max(want.float().abs().max().item(), 1e-30), diff


def phase_train_kernels(spec=BASE, batch=TRAIN_BATCH, tag="[3t]", checks_only=False):
    """Forward with stats, di, dq + dbias and dk + dv of ``spec``'s head dim
    against their plain versions at the training shapes (``batch``), timed,
    a ragged case, one without a bias and the tile edges; rows keyed by
    kernel.  ``checks_only``: the training shapes alone, checked, not timed."""
    from ifseg_torch.ops import flash_attention as fa

    h, d = spec["heads"], spec["head_dim"]
    prefix = "" if spec is BASE else "huge "
    rows = {"stats": [], "di": [], "dq": [], "dkv": []}
    # (name, B, Lq, Lk, causal, key mask, bias dtype, calls a step, calls a
    # prefix-tuned step): prefix tuning (phase 16a) prepends P keys to both
    # self-attentions and leaves the cross-attention as it is
    cases = [(prefix + name, batch, lq, lk, causal, masked, torch.bfloat16,
              0 if checks_only else n, 0 if checks_only or spec is not BASE or "cross" not in name
              else n)
             for name, lq, lk, causal, masked, n in attn_sites(spec)]
    if checks_only:
        return _train_kernel_cases(cases, rows, fa, h, d, tag)
    cases.append((prefix + "ragged check", 3, 77, 130, True, True, torch.float32, 0, 0))
    cases.append((prefix + "no-bias check", 2, 70, 70, False, False, None, 0, 0))
    # the kernels' tile edges, with more than one key (with one, every
    # gradient but dv is 0)
    cases += [(prefix + name, b, lq, lk, causal, masked, bias_dtype, 0, 0)
              for name, b, lq, lk, causal, masked, bias_dtype, _ in EDGE_CASES if lk > 1]
    if spec is BASE:  # the two self-attentions of a prefix-tuned step, Lk = P + L
        cases += [(f"prefix {name}", batch, lq, lk + PROMPT_LEN, causal, masked, torch.bfloat16,
                   0, n) for name, lq, lk, causal, masked, n in attn_sites(spec)
                  if "self" in name]
    return _train_kernel_cases(cases, rows, fa, h, d, tag)


def _train_kernel_cases(cases, rows, fa, h, d, tag):
    """The checks of ``phase_train_kernels`` over ``cases``; a case with
    launches a step or a prefix-tuned step (its last two fields) is timed too."""
    for i, (name, b, lq, lk, causal, masked, bias_dtype, per_step, per_prefix) in enumerate(cases):
        q, k, v, dense, mask = site_inputs(b, h, lq, lk, causal, masked,
                                           bias_dtype or torch.bfloat16, seed=10 + i, head_dim=d)
        # the bias as the training path hands it over: rows 16-byte aligned,
        # row-padded where Lk does not make them so
        bias = None if bias_dtype is None else fa.row_padded(dense)
        g = torch.randn(q.shape, generator=torch.Generator(device="cuda").manual_seed(50 + i),
                        device="cuda").bfloat16()
        f32 = lambda x: None if x is None else x.float()
        args = (q, k, v, bias, mask, causal)
        want_out, want_lse = fa.attention_bias_stats_reference(
            f32(q), f32(k), f32(v), f32(bias), mask, causal, h)
        out, lse = fa._launch(*args, h, with_stats=True)
        di = fa._launch_di(g, out, h)
        fa._check_backward(q, g, out, lse, h)
        dq, dbias = fa._launch_dq(*args, g, lse, di, h)
        dk, dv = fa._launch_dkv(*args, g, lse, di, h)
        torch.cuda.synchronize()
        # the plain backward on the kernel's own saved (out, lse), in fp32
        ref_args = (f32(q), f32(k), f32(v), f32(bias), mask, causal, f32(g), f32(out), lse, h)
        want_dq, want_dbias = fa.attention_bias_dq_dbias_reference(*ref_args)
        want_dk, want_dv = fa.attention_bias_dkv_reference(*ref_args)
        want_di = fa.attention_di_reference(g, out, h)
        errs = {
            "out": (out.float() - want_out).abs().max().item(),
            "lse": (lse - want_lse).abs().max().item(),
            "di": rel_err(di, want_di), "dq": rel_err(dq, want_dq),
            "dk": rel_err(dk, want_dk), "dv": rel_err(dv, want_dv),
        }
        if bias is not None:
            errs["dbias"] = rel_err(dbias, want_dbias)
            # the backward on the other layout of the same bias, through the
            # route the autograd Function takes: the dense bias (row-padded
            # there by a copy where its rows are not 16-byte aligned) or, where
            # the path's bias is dense, a copy in row-padded storage
            other = pitched(dense) if bias is dense else dense
            copies = fa.BWD_BIAS_COPIES
            o_dq, o_dk, o_dv, o_dbias = fa._launch_backward(q, k, v, other, mask, causal, g, out,
                                                            lse, h)
            torch.cuda.synchronize()
            if fa.BWD_BIAS_COPIES - copies != int(not fa.tma_rows(other)):
                fail(f"the backward copied a bias {fa.BWD_BIAS_COPIES - copies} times at {name}")
            layout = "pitched" if other is not dense else "dense"
            for n, got, want in (("dq", o_dq, want_dq), ("dk", o_dk, want_dk),
                                 ("dv", o_dv, want_dv), ("dbias", o_dbias, want_dbias)):
                errs[f"{n} {layout}"] = rel_err(got, want)
            del o_dq, o_dk, o_dv, o_dbias
        # the public entry and its autograd backward, on leaves, against the same
        # plain versions: saved tensors, g, need_dbias and the gradient slots
        leaves = [None if x is None else x.detach().clone().requires_grad_(True)
                  for x in (q, k, v, bias)]
        pub_out, pub_lse = fa.flash_attention_bias_packed_stats(*leaves, mask, causal, h)
        pub_out.backward(g)
        torch.cuda.synchronize()
        if pub_lse.requires_grad or not (torch.equal(pub_out, out) and torch.equal(pub_lse, lse)):
            fail(f"flash_attention_bias_packed_stats differs from its kernel's launch at {name}")
        wants = dict(dq=want_dq, dk=want_dk, dv=want_dv, dbias=want_dbias)
        for n, leaf in zip(("dq", "dk", "dv", "dbias"), leaves):
            if leaf is not None:
                errs["autograd " + n] = rel_err(leaf.grad, wants[n])
        del leaves, pub_out, pub_lse, wants
        del want_out, want_lse, want_dq, want_dbias, want_dk, want_dv, want_di, ref_args
        torch.cuda.empty_cache()
        log(f"{tag} {name}: B={b} H={h} D={d} Lq={lq} Lk={lk} causal={causal} mask={masked} "
            f"bias={None if bias is None else str(bias.dtype).split('.')[-1]} "
            f"pitch={None if bias is None else bias.stride(1)}: "
            f"out abs {errs['out']:.3e}, lse abs {errs['lse']:.3e}, "
            + ", ".join(f"{n} rel {errs[n][0]:.3e}" for n in errs if n not in ("out", "lse")))
        if not errs["out"] <= ATTN_TOL:
            fail(f"stats forward output disagrees at {name}: {errs['out']} > {ATTN_TOL}")
        if not errs["lse"] <= LSE_TOL:
            fail(f"stats forward lse disagrees at {name}: {errs['lse']} > {LSE_TOL}")
        if not errs["di"][0] <= DI_TOL:
            fail(f"di disagrees at {name}: {errs['di'][0]} > {DI_TOL}")
        for n in [m for m in errs if m not in ("out", "lse", "di")]:
            if not errs[n][0] <= GRAD_REL_TOL:
                fail(f"{n} disagrees with its plain version at {name}: {errs[n][0]} > {GRAD_REL_TOL}")
        for x in (out, lse, di, dq, dk, dv) + (() if dbias is None else (dbias,)):
            if not bool(torch.isfinite(x).all()):
                fail(f"non-finite kernel output at {name}")
        base = dict(site=name, B=b, H=h, D=d, Lq=lq, Lk=lk, causal=causal, per_step=per_step,
                    per_prefix_step=per_prefix)
        rows["stats"].append(dict(base, max_abs_err=max(errs["out"], errs["lse"])))
        rows["di"].append(dict(base, max_abs_err=errs["di"][1], max_rel_err=errs["di"][0]))
        kq = [e for n, e in errs.items() if n.startswith(("dq", "dbias"))]
        kkv = [e for n, e in errs.items() if n.startswith(("dk", "dv"))]
        rows["dq"].append(dict(base, max_abs_err=max(e[1] for e in kq),
                               max_rel_err=max(e[0] for e in kq)))
        rows["dkv"].append(dict(base, max_abs_err=max(e[1] for e in kkv),
                                max_rel_err=max(e[0] for e in kkv)))
        if per_step or per_prefix:
            bb = bias.element_size()
            timed = {
                "stats": (lambda: fa._launch(*args, h, with_stats=True),
                          lambda: fa.attention_bias_stats_reference(*args, h)),
                "dq": (lambda: fa._launch_dq(*args, g, lse, di, h),
                       lambda: fa.attention_bias_dq_dbias_reference(*args, g, out, lse, h)),
                "dkv": (lambda: fa._launch_dkv(*args, g, lse, di, h),
                        lambda: fa.attention_bias_dkv_reference(*args, g, out, lse, h)),
                "di": (lambda: fa._launch_di(g, out, h),
                       lambda: fa.attention_di_reference(g, out, h)),
            }
            try:
                lib_fwd, lib_bwd = sdpa_train_ms(q, k, v, bias, mask, causal, h, 5)
            except RuntimeError as exc:  # the yardstick only; the port never calls it
                log(f"{tag}   scaled_dot_product_attention with a bias gradient failed: {exc}")
                lib_fwd = lib_bwd = None
            # di in one library call (timed here, used nowhere in the port); its
            # result is bf16 where the kernel's is fp32
            gh, oh = g.view(b, lq, h, -1), out.view(b, lq, h, -1)
            lib_di = cuda_ms_queued(lambda: torch.einsum("blhd,blhd->bhl", gh, oh), 10)
            torch.cuda.empty_cache()
            for kind, (kernel_fn, plain_fn) in timed.items():
                row = rows[kind][-1]
                if kind == "di":  # bytes only: do and out read, di written
                    flops, nbytes = 2 * q.numel(), 2 * 2 * q.numel() + 4 * di.numel()
                else:
                    flops, nbytes = attention_work(b, h, lq, lk, d, causal, bb, masked, kind)
                row["bound_ms"], row["bound_by"] = bound_ms(flops, nbytes)
                row["gflop"], row["mb"] = flops / 1e9, nbytes / 1e6
                # di takes less card time than its launch costs the host: queued
                row["kernel_ms"] = (cuda_ms_queued(kernel_fn, 50) if kind == "di"
                                    else cuda_ms(kernel_fn, 10))
                row["plain_ms"] = cuda_ms(plain_fn, 2, warmup=1)
                torch.cuda.empty_cache()
                # the library's one backward does the work of dq + dbias and dk + dv together
                row["library_ms"] = dict(stats=lib_fwd, dq=lib_bwd, dkv=lib_bwd, di=lib_di)[kind]
                row["share_of_bound"] = row["bound_ms"] / row["kernel_ms"]
                log(f"{tag}   {kind}: kernel_ms={row['kernel_ms']:.4f} plain_ms={row['plain_ms']:.4f} "
                    f"library_ms={row['library_ms']} bound_ms={row['bound_ms']:.4f} "
                    f"({row['bound_by']}; {row['gflop']:.1f} GFLOP, {row['mb']:.1f} MB) "
                    f"share_of_bound={row['share_of_bound']:.3f}")
            # what the dbias sum and the bias cost the backward kernels
            rows["dq"][-1]["no_dbias_ms"] = cuda_ms(
                lambda: fa._launch_dq(*args, g, lse, di, h, need_dbias=False), 10)
            no_bias = (q, k, v, None, mask, causal, g, lse, di, h)
            rows["dq"][-1]["no_bias_ms"] = cuda_ms(lambda: fa._launch_dq(*no_bias), 10)
            rows["dkv"][-1]["no_bias_ms"] = cuda_ms(lambda: fa._launch_dkv(*no_bias), 10)
            log(f"{tag}   dq without dbias {rows['dq'][-1]['no_dbias_ms']:.4f} ms, without a bias "
                f"{rows['dq'][-1]['no_bias_ms']:.4f}; dkv without a bias "
                f"{rows['dkv'][-1]['no_bias_ms']:.4f}")
        del q, k, v, bias, dense, mask, g, out, lse, di, dq, dk, dv, dbias, args
        torch.cuda.empty_cache()
    return rows


def pitched(bias):
    """``bias`` (H, Lq, Lk) copied into storage whose rows are 8 to 15
    elements longer than Lk, a multiple of 8, as the [..., :Lk] view."""
    lk = bias.shape[-1]
    store = torch.zeros(*bias.shape[:-1], -(-lk // 8) * 8 + 8, dtype=bias.dtype,
                        device=bias.device)
    store[..., :lk] = bias
    return store[..., :lk]


# ---------------------------------------------------------------- phases 6, 7

def train_config(dtype: str, monitor: bool, dropout: bool = True, arch: str = "segofa_base",
                 batch: int = TRAIN_BATCH, **model_overrides):
    """The reference image-free configuration (run_scripts/IFSeg/common.sh +
    coco_unseen.sh): OFA-Base (or ``arch``) 512px, 15 seg classes, dropout
    and drop-path 0.1, clip-norm 1, Adam (0.9, 0.999) eps 1e-8, wd 0.1,
    cosine LR 5e-5; ``batch`` rows a step, which the Trainer's "auto"
    checkpointing decision reads."""
    from ifseg_torch.config import Config, model_config_for_arch

    rates = {} if dropout else dict(dropout=0.0, encoder_drop_path_rate=0.0,
                                    decoder_drop_path_rate=0.0)
    cfg = Config(model=model_config_for_arch(
        arch, patch_image_size=512, orig_patch_image_size=512,
        num_seg_tokens=TRAIN_CLASSES, dtype=dtype, **rates, **model_overrides))
    cfg.optimization.seed = SEED
    cfg.optimization.batch_size = batch
    cfg.criterion.monitor_real_batch = monitor
    return cfg


def class_table(seed: int):
    """Random category-word token ids for the classes plus 'unknown'."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(4, 50000, size=(TRAIN_CLASSES + 1, 3)).astype(np.int64)
    lengths = rng.integers(1, 4, size=(TRAIN_CLASSES + 1,)).astype(np.int64)
    return tokens, lengths


def train_batch(rng, batch: int, real: bool):
    """An image-free batch of artificial grids; with ``real`` also a uint8
    image and labels for the monitoring forward."""
    from ifseg_torch.data.artificial import artificial_batch

    src = rng.integers(4, 50000, size=SRC_LEN)
    out = artificial_batch(rng, batch, 512, TRAIN_CLASSES, src)
    if real:
        out["patch_images"] = rng.integers(0, 256, size=(batch, 512, 512, 3), dtype=np.uint8)
        out["target"] = rng.integers(0, TRAIN_CLASSES + 1, size=(batch, 512, 512)).astype(np.uint8)
        out["downsampled_target"] = rng.integers(
            0, TRAIN_CLASSES + 1, size=(batch, 1024)).astype(np.int64)
    return out


def take_steps(trainer, rng, steps: int, batch: int, real: bool):
    """(logs, seconds) of ``steps`` training steps, each ended by a synchronize."""
    logs, times = [], []
    for _ in range(steps):
        data = train_batch(rng, batch, real)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = trainer.train_step(data)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
        logs.append({k: float(v) for k, v in out.items()
                     if not isinstance(v, torch.Tensor) or v.dim() == 0})
    return logs, times


def phase_train(card: str):
    from ifseg_torch.ops import flash_attention as fa
    from ifseg_torch.ops import layer_norm as ln
    from ifseg_torch.train.trainer import Trainer

    per_pass = sum(n for *_, n in SITES)
    tokens, lengths = class_table(SEED)
    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(train_config("bfloat16", monitor=False), tokens, lengths,
                      total_num_updates=100).init_state()  # the card, by default
    torch.cuda.synchronize()
    n_train = sum(p.numel() for p in trainer.optimizer.params)
    log(f"[6] Trainer, OFA-Base 512px, batch {TRAIN_BATCH}, {TRAIN_CLASSES} classes, "
        f"{n_train / 1e6:.1f}M trainable params, seed {SEED}: set-up {time.perf_counter() - t0:.1f} s")
    start = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}

    def run(steps, real):
        return take_steps(trainer, rng, steps, TRAIN_BATCH, real)

    fa.reset_launches()
    ln.reset_launches()
    warm_steps, timed_steps, monitor_steps = 2, 5, 3
    logs, times = run(warm_steps + timed_steps, real=False)
    trainer.cfg.criterion.monitor_real_batch = True
    mon_logs, mon_times = run(monitor_steps, real=True)
    counts = fa.launch_counts()
    routes = fa.bias_route_counts()
    steps = warm_steps + timed_steps + monitor_steps
    for i, lg in enumerate(logs + mon_logs):
        log(f"[6] step {i}: loss {lg['loss']:.4f} gnorm {lg['gnorm']:.4f} lr {lg['lr']:.3e} "
            f"n_nonfinite {lg['n_nonfinite']:.0f}"
            + (f" seg_loss {lg['seg_loss']:.4f}" if "seg_loss" in lg else ""))
        if not (np.isfinite(lg["loss"]) and np.isfinite(lg["gnorm"])) or lg["n_nonfinite"] != 0:
            fail(f"training step {i}: non-finite loss or gradient norm")
    if "seg_loss" not in mon_logs[-1] or not np.isfinite(mon_logs[-1]["seg_loss"]):
        fail("the monitoring forward gave no finite seg_loss")
    want = dict(stats=per_pass * steps, bwd_di=per_pass * steps, bwd_dq=per_pass * steps,
                bwd_dkv=per_pass * steps, infer=per_pass * monitor_steps)
    log(f"[6] kernel launches over {steps} steps ({monitor_steps} with monitoring): {counts}; "
        f"expected {want}")
    if counts != want:
        fail("the training path did not launch every attention kernel at every site")
    log(f"[6] bias routes: {routes} (every forward launch by TMA, no bias copied by the backward)")
    if routes != dict(fwd_bias_tma=counts["stats"] + counts["infer"], fwd_bias_threads=0,
                      bwd_bias_copies=0):
        fail(f"the training path staged a bias by threads or copied one: {routes}")
    # LayerNorm: the kernel where no gradient is needed (the monitoring
    # forward, biases built in the graph), F.layer_norm in the training forward
    ln_per_monitor = ln_launches_per_forward(trainer.model, position_lns=True)
    if ln_per_monitor != ln_sites_per_pass("per_monitor_forward"):
        fail(f"{ln_per_monitor} LayerNorm sites in a monitoring forward, "
             f"{ln_sites_per_pass('per_monitor_forward')} held against the plain version")
    ln_want = ln_per_monitor * monitor_steps
    log(f"[6] layer_norm kernel launches {ln.LAUNCHES}, all from the {monitor_steps} monitoring "
        f"forwards (expected {ln_want})")
    if ln.LAUNCHES != ln_want:
        fail("the monitoring forward did not launch the layer_norm kernel at every LayerNorm")
    if trainer.get_num_updates() != steps:
        fail(f"step counter {trainer.get_num_updates()} after {steps} steps")
    moved = frozen = 0
    for name, p in trainer.model.named_parameters():
        if trainer.mask[name]:
            moved += int(not torch.equal(p, start[name]))
        else:
            frozen += 1
            if not torch.equal(p, start[name]):
                fail(f"frozen parameter {name} changed")
    n_trainable = sum(trainer.mask.values())
    if moved < 0.95 * n_trainable:  # zero-initialised biases that get no gradient stay at 0
        fail(f"only {moved} of {n_trainable} trainable tensors moved")
    for name in ("encoder.embed_tokens.weight", "decoder.seg_embed_tokens.weight",
                 "encoder.embed_images.conv1.weight"):
        if trainer.mask[name]:
            fail(f"{name} should be frozen")
    s_step = float(np.mean(times[warm_steps:]))
    s_mon = float(np.mean(mon_times[1:])) if len(mon_times) > 1 else float(mon_times[0])
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    log(f"[6] {moved}/{n_trainable} trainable tensors moved, {frozen} frozen tensors bit-identical")
    log(f"[6] steady state, batch {TRAIN_BATCH}: {s_step:.4f} s/step image-free "
        f"(steps: {', '.join(f'{t:.3f}' for t in times)}), {s_mon:.4f} s/step with the "
        f"monitoring forward, max_memory_allocated {peak_gb:.2f} GiB, on {card}")
    del trainer, start
    torch.cuda.empty_cache()
    return dict(s_per_step=s_step, s_per_step_monitor=s_mon, max_memory_gib=peak_gb,
                launches=counts, bias_routes=routes, ln_launches=ln.LAUNCHES, steps=steps,
                monitor_steps=monitor_steps, final_loss=mon_logs[-1]["loss"])


GRAD_TENSORS = (
    "encoder.token_rel_pos_table_list.0.weight",
    "encoder.image_rel_pos_table_list.0.weight",
    "decoder.seg_rel_pos_table_list.0.weight",
    "decoder.cross_pos_q_linear.weight",
    "decoder.cross_pos_k_linear.weight",
    "encoder.pos_q_linear.weight",
    "encoder.layers.0.self_attn.q_proj.weight",
    "decoder.layers.5.encoder_attn.v_proj.weight",
    "decoder.layers.5.fc2.weight",
)


def phase_train_gradients(arch="segofa_base", grad_tensors=GRAD_TENSORS, tag="[7]",
                          **model_overrides):
    """Image-free loss + backward at batch 2: the card (bf16, kernels) against
    the CPU (fp32, plain versions), same weights and batch, dropout off (the
    prompt encoders' fixed 0.2 included, where ``model_overrides`` asks for
    them)."""
    from ifseg_torch.models.layers import PromptEncoder
    from ifseg_torch.train.trainer import Trainer

    tokens, lengths = class_table(SEED)
    batch = train_batch(np.random.default_rng(400), 2, real=False)

    def loss_and_grads(dtype, device, weights):
        tr = Trainer(train_config(dtype, monitor=False, dropout=False, arch=arch,
                                  **model_overrides), tokens, lengths,
                     total_num_updates=100, device=device).init_state(weights)
        tr.model.train()
        for m in tr.model.modules():
            if isinstance(m, PromptEncoder):
                m.dropout.rate = 0.0
        loss = tr._loss_fn(tr.prepare_batch(batch))
        loss.backward()
        grads = {n: p.grad.detach().float().cpu() for n, p in tr.model.named_parameters()
                 if p.grad is not None}
        weights = {k: v.detach().cpu().clone() for k, v in tr.model.state_dict().items()}
        return float(loss.detach()), grads, weights

    t0 = time.perf_counter()
    card_loss, card_grads, weights = loss_and_grads("bfloat16", None, None)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    cpu_loss, cpu_grads, _ = loss_and_grads("float32", "cpu", weights)
    t2 = time.perf_counter()
    norm = lambda gs: float(torch.sqrt(sum((g.double() ** 2).sum() for g in gs.values())))
    loss_rel = abs(card_loss - cpu_loss) / abs(cpu_loss)
    gn_card, gn_cpu = norm(card_grads), norm(cpu_grads)
    gn_rel = abs(gn_card - gn_cpu) / gn_cpu
    depth = (f", {model_overrides['encoder_layers']} + {model_overrides['decoder_layers']} layers "
             "(reduced depth), full width" if "encoder_layers" in model_overrides else "")
    log(f"{tag} {arch} image-free loss + backward, batch 2{depth}: card {t1 - t0:.1f} s, "
        f"CPU {t2 - t1:.1f} s; "
        f"loss {card_loss:.5f} vs {cpu_loss:.5f} (rel {loss_rel:.3e}), "
        f"gnorm {gn_card:.5f} vs {gn_cpu:.5f} (rel {gn_rel:.3e})")
    cosines = {}
    for name in grad_tensors:
        a, b = card_grads[name].flatten().double(), cpu_grads[name].flatten().double()
        cosines[name] = float(a @ b / (a.norm() * b.norm()))
        log(f"{tag}   cosine {cosines[name]:.5f}  |g| card {float(a.norm()):.3e} "
            f"cpu {float(b.norm()):.3e}  {name}")
    if not loss_rel <= TRAIN_LOSS_REL_TOL:
        fail(f"card loss differs from the CPU loss: {loss_rel} > {TRAIN_LOSS_REL_TOL}")
    if not gn_rel <= TRAIN_GNORM_REL_TOL:
        fail(f"card gradient norm differs from the CPU's: {gn_rel} > {TRAIN_GNORM_REL_TOL}")
    low = {n: c for n, c in cosines.items() if not c >= TRAIN_COSINE_MIN}
    if low:
        fail(f"gradient cosine below {TRAIN_COSINE_MIN}: {low}")
    return dict(loss_rel_err=loss_rel, gnorm_rel_err=gn_rel, min_cosine=min(cosines.values()),
                cosines=cosines)


# ---------------------------------------------------------------- phases 8, 9

def eval_config(dtype: str, model_cfg=None):
    """OFA-Base, 150 classes (or ``model_cfg``), the evaluation settings of
    run_scripts/IFSeg/common.sh: label propagation top-3, 25 iterations."""
    from ifseg_torch.config import Config

    cfg = Config(model=base_config(dtype) if model_cfg is None else model_cfg)
    cfg.criterion.resnet_topk = 3
    cfg.criterion.resnet_iters = 25
    return cfg


# (image (h, w), original (H, W)): eight keep-ratio shapes that differ in
# pixels, share the ceil-16 extents (32, 43) and the (512, 768) buckets of
# image and target; then four at (512, 512)
EVAL_SHAPES_WIDE = [
    ((512, 683), (480, 640)), ((512, 680), (450, 600)), ((512, 675), (512, 683)),
    ((512, 683), (427, 640)), ((512, 678), (500, 667)), ((512, 673), (468, 624)),
    ((512, 682), (512, 680)), ((512, 681), (400, 534)),
]
EVAL_SHAPES_SQUARE = [((512, 512), (512, 512)), ((512, 512), (500, 500)),
                      ((512, 512), (480, 480)), ((512, 512), (375, 500))]


def eval_samples(shapes, seed: int, classes: int = EVAL_CLASSES):
    """Fabricated uint8 ``EvalSample``s; a tenth of the target is 'unknown'."""
    from ifseg_torch.data.segmentation_dataset import EvalSample

    rng = np.random.default_rng(seed)
    src = rng.integers(4, 50000, size=SRC_LEN).astype(np.int32)
    src[SRC_LEN - 5:] = 1  # PAD
    samples = []
    for i, ((h, w), (H, W)) in enumerate(shapes):
        seg = rng.integers(0, classes, size=(H, W)).astype(np.int32)
        seg[rng.random((H, W)) < 0.1] = classes
        samples.append(EvalSample(
            patch_image=rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8), src_tokens=src,
            bos_token=np.zeros((1,), np.int32), ori_semantic_seg=seg, ori_shape=(H, W, 3), id=i))
    return samples


class ListDataset:
    def __init__(self, samples):
        self.samples = samples

    def __len__(self):
        return len(self.samples)

    def get_eval_sample(self, i):
        return self.samples[i]


AREA_KEYS = ("area_intersect", "area_pred_label", "area_label", "area_union")


def phase_eval(card: str, weights):
    from ifseg_torch.eval.evaluator import Evaluator
    from ifseg_torch.models.segofa import SegOFA
    from ifseg_torch.ops import flash_attention as fa
    from ifseg_torch.ops import layer_norm as ln

    cfg = eval_config("bfloat16")
    model = SegOFA(cfg.model)
    model.load_state_dict(weights, strict=True)
    # the model on the card in fp32, as a trainer holds it; the evaluator runs
    # a bf16 copy of what serving casts and shares the rest
    evaluator = Evaluator(cfg, model.to("cuda"))  # the card, by default
    log(f"[8] Evaluator, OFA-Base, {EVAL_CLASSES} classes, label propagation top-"
        f"{cfg.criterion.resnet_topk} x {cfg.criterion.resnet_iters}; memory budget "
        f"{evaluator.mem_budget / 2**30:.1f} GiB, at most "
        f"{evaluator._max_group_rows(512, 768)} rows a group at the (512, 768) bucket")
    wide, square = eval_samples(EVAL_SHAPES_WIDE, 500), eval_samples(EVAL_SHAPES_SQUARE, 501)
    samples = wide + square
    per_group = sum(n for *_, n in EVAL_SITES)
    ln_per_group = ln_launches_per_forward(evaluator.model, position_lns=True)
    if ln_per_group != ln_sites_per_pass("per_eval_group"):
        fail(f"{ln_per_group} LayerNorm sites in an evaluation forward, "
             f"{ln_sites_per_pass('per_eval_group')} held against the plain version")

    fa.reset_launches()
    ln.reset_launches()
    stats = {}
    t0 = time.perf_counter()
    logs = evaluator.eval_dataset(ListDataset(samples), batch_size=8, stats_out=stats)
    dt = time.perf_counter() - t0
    counts, ln_launches, routes = fa.launch_counts(), ln.LAUNCHES, fa.bias_route_counts()
    groups = len(logs)
    log(f"[8] eval_dataset: {len(samples)} samples in groups {stats['group_sizes']} "
        f"({dt:.2f} s, first run); attention launches {counts}, layer_norm launches {ln_launches} "
        f"(expected {per_group} and {ln_per_group} a group); bias routes {routes}")
    if routes != dict(fwd_bias_tma=counts["infer"], fwd_bias_threads=0, bwd_bias_copies=0):
        fail(f"the evaluation path staged a bias by threads: {routes}")
    if stats["group_sizes"] != [len(wide), len(square)]:
        fail(f"groups {stats['group_sizes']}, expected {[len(wide), len(square)]}")
    if sum(stats["buckets"].values()) != len(samples) or len(stats["buckets"]) != 2:
        fail(f"bucket counts {stats['buckets']}")
    if counts != dict(infer=per_group * groups, stats=0, bwd_di=0, bwd_dq=0, bwd_dkv=0):
        fail("the evaluation path did not launch the attention kernel at every site")
    if ln_launches != ln_per_group * groups:
        fail("the evaluation path did not launch the layer_norm kernel at every LayerNorm")
    for out, group in zip(logs, (wide, square)):
        n_valid = sum(int((s.ori_semantic_seg != EVAL_CLASSES).sum()) for s in group)
        if not np.isfinite(out["nll_loss"]) or out["nll_cnt"] != n_valid:
            fail(f"nll_loss {out['nll_loss']}, nll_cnt {out['nll_cnt']} vs {n_valid} valid pixels")
        for suffix in ("", "_resnet_postprocess"):
            ai, al, au = (out[f"area_{k}{suffix}"] for k in ("intersect", "label", "union"))
            if ai.shape != (EVAL_CLASSES,) or al.sum() != n_valid or not (ai <= au).all():
                fail(f"areas{suffix}: label sum {al.sum()} vs {n_valid} valid pixels")
        log(f"[8]   group of {len(group)}: nll_loss {out['nll_loss']:.4f}, {n_valid} valid pixels, "
            f"pixel accuracy {out['area_intersect'].sum() / n_valid:.4f} "
            f"(with label propagation {out['area_intersect_resnet_postprocess'].sum() / n_valid:.4f})")

    def group_seconds(group, iters=3):
        evaluator._run_group(group)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(iters):
            evaluator._run_group(group)
        torch.cuda.synchronize()
        return (time.perf_counter() - t1) / iters

    result = dict(groups=stats["group_sizes"], launches=counts["infer"], ln_launches=ln_launches,
                  bias_routes=routes, first_run_s=dt)
    for name, group in (("(512, 768)", wide), ("(512, 512)", square)):
        with_lp = group_seconds(group)
        cfg.criterion.resnet_iters = 0
        without = group_seconds(group)
        cfg.criterion.resnet_iters = 25
        log(f"[8] bucket {name}, group of {len(group)}: {with_lp * 1e3:.1f} ms a group, "
            f"{len(group) / with_lp:.2f} img/s; without label propagation "
            f"{without * 1e3:.1f} ms, {len(group) / without:.2f} img/s, on {card}")
        result[name] = dict(rows=len(group), ms_per_group=with_lp * 1e3,
                            img_per_s=len(group) / with_lp, ms_per_group_no_lp=without * 1e3,
                            img_per_s_no_lp=len(group) / without)

    result["refresh"] = refresh_timing(evaluator, "[8]", card)

    # peak memory of a group, above what is held between groups: the terms
    # of Evaluator._max_group_rows
    from ifseg_torch.eval import evaluator as ev

    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    peaks = {}
    for rows in (4, 32, 64):
        torch.cuda.reset_peak_memory_stats()
        evaluator._run_group((wide * 8)[:rows])
        torch.cuda.synchronize()
        peaks[rows] = torch.cuda.max_memory_allocated() - held
    # a small group peaks while the once-per-group bias chains are built (the
    # fixed term), a large one in the upsample, which grows by the row
    per_row = (peaks[64] - peaks[32]) / 32
    fixed = peaks[4]
    ltok = 32 * 48 + 64
    m = cfg.model
    log(f"[8] peak memory above the {held / 2**30:.2f} GiB held: {peaks[4] / 2**30:.3f} GiB at 4 rows, "
        f"{peaks[32] / 2**30:.3f} GiB at 32, {peaks[64] / 2**30:.3f} GiB at 64 -> "
        f"{per_row / 2**20:.1f} MiB a row, {fixed / 2**30:.3f} GiB fixed "
        f"= {per_row / (ltok * m.encoder_embed_dim * 4):.1f} activation buffers a row, "
        f"{fixed / (m.encoder_attention_heads * ltok ** 2 * 4):.1f} bias buffers "
        f"(evaluator.py states {ev.ROW_ACT_BUFFERS} and {ev.FIXED_BIAS_BUFFERS}), on {card}")
    result["memory"] = dict(held_gib=held / 2**30, peak4_gib=peaks[4] / 2**30,
                            peak32_gib=peaks[32] / 2**30, peak64_gib=peaks[64] / 2**30,
                            per_row_mib=per_row / 2**20,
                            fixed_gib=fixed / 2**30,
                            row_act_buffers=per_row / (ltok * m.encoder_embed_dim * 4),
                            fixed_bias_buffers=fixed / (m.encoder_attention_heads * ltok ** 2 * 4))
    return evaluator, wide, result


def refresh_timing(evaluator, tag, card, iters=3):
    """Host ms of ``Evaluator.refresh_weights`` (the cast copy of the given
    model's weights that ``eval_dataset`` takes first), ending in a
    synchronize, and what it copies."""
    evaluator.refresh_weights()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        evaluator.refresh_weights()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / iters * 1e3
    own = evaluator._pairs
    n = sum(t.numel() for t, _ in own)
    nbytes = sum(t.numel() * (t.element_size() + s.element_size()) for t, s in own)
    log(f"{tag} Evaluator.refresh_weights: {ms:.3f} ms for {len(own)} tensors of its own, "
        f"{n / 1e6:.1f}M values, {nbytes / 1e6:.1f} MB read and written; the given model's "
        f"parameters keep their dtype, on {card}")
    return dict(ms=ms, tensors=len(own), values=n, mb=nbytes / 1e6)


def phase_eval_reference(evaluator, wide, weights):
    """The padded forward against the exact one on the card, then the card's
    evaluation of one group of two rows against the fp32 CPU Evaluator."""
    from ifseg_torch.eval.evaluator import Evaluator
    from ifseg_torch.models.segofa import SegOFA

    # one image through SegOFA.forward at its own shape and, zero-padded into
    # its bucket, through eval_forward; both bf16 on the card, so they differ by
    # bf16 rounding along two different summation orders (other cuDNN and
    # cuBLAS shapes, static against dynamic-valid interpolation matrices)
    model, dev = evaluator.model, evaluator.device
    rng = np.random.default_rng(600)
    h, w, hb, wb = 512, 683, 512, 768
    img = torch.from_numpy(rng.normal(size=(1, h, w, 3)).astype(np.float32)).to(dev)
    padded = torch.zeros(1, hb, wb, 3, device=dev)
    padded[:, :h, :w] = img
    src = torch.from_numpy(rng.integers(4, 50000, size=(1, SRC_LEN))).to(dev)
    bos = torch.zeros(1, 1, dtype=torch.long, device=dev)
    hp, wp = -(-h // 16), -(-w // 16)
    with torch.no_grad():
        exact, _ = model(src_tokens=src, patch_images=img, bos_tokens=bos)
        got, _ = model.eval_forward(src, padded, h, w, bos)
    # output position 0 is the BOS slot's, position 1 + i the i-th grid cell's
    gh, gw = hb // 16, wb // 16
    exact = exact[0].float()
    got = torch.cat([got[0, :1], got[0, 1:].reshape(gh, gw, -1)[:hp, :wp].reshape(hp * wp, -1)])
    got = got.float()
    rel = ((got - exact).norm() / exact.norm()).item()
    agree = (got.argmax(-1) == exact.argmax(-1)).float().mean().item()
    log(f"[9] padded ({hb}, {wb}) vs exact ({h}, {w}) forward on the card, bf16: relative logit "
        f"error {rel:.3e} (limit {LOGIT_REL_TOL}), per-cell argmax agreement {agree:.4f}")
    if not rel <= LOGIT_REL_TOL:
        fail(f"the padded forward differs from the exact one: {rel} > {LOGIT_REL_TOL}")

    group = wide[:2]
    card_out = evaluator._read_back(evaluator._run_group(group))
    ref_model = SegOFA(base_config("float32"))
    ref_model.load_state_dict(weights, strict=True)
    t0 = time.perf_counter()
    reference = Evaluator(eval_config("float32"), ref_model, device="cpu")
    cpu_out = reference._read_back(reference._run_group(group))
    n_px = float(cpu_out["area_label"].sum())
    shares = {k: float(np.abs(card_out[k] - cpu_out[k]).sum() / 2 / n_px)
              for k in ("area_pred_label", "area_pred_label_resnet_postprocess")}
    nll_rel = abs(float(card_out["nll_loss"]) - float(cpu_out["nll_loss"])) / float(cpu_out["nll_loss"])
    log(f"[9] card bf16 vs CPU fp32 Evaluator, group of 2 at the (512, 768) bucket "
        f"({time.perf_counter() - t0:.1f} s on the CPU): nll_loss {float(card_out['nll_loss']):.5f} vs "
        f"{float(cpu_out['nll_loss']):.5f} (rel {nll_rel:.3e}, limit {EVAL_NLL_REL_TOL}); share of "
        f"pixels predicted otherwise {shares['area_pred_label']:.4f}, after label propagation "
        f"{shares['area_pred_label_resnet_postprocess']:.4f} (limit {EVAL_PIXEL_SHARE_TOL})")
    if not np.array_equal(card_out["area_label"], cpu_out["area_label"]):
        fail("card and CPU count different label areas")
    if not nll_rel <= EVAL_NLL_REL_TOL:
        fail(f"card nll_loss differs from the CPU's: {nll_rel} > {EVAL_NLL_REL_TOL}")
    if not max(shares.values()) <= EVAL_PIXEL_SHARE_TOL:
        fail(f"card predictions differ from the CPU's on {shares} of the pixels")
    return dict(padded_vs_exact_rel_err=rel, padded_vs_exact_argmax_agreement=agree,
                nll_rel_err=nll_rel, pixel_share_differs=shares)


# ---------------------------------------------------------------- phase 10: SegOFA-Huge

GRAD_TENSORS_HUGE = tuple(n.replace("decoder.layers.5", f"decoder.layers.{HUGE_CHECK_LAYERS - 1}")
                          for n in GRAD_TENSORS)


def huge_config(dtype: str, classes: int = EVAL_CLASSES, **overrides):
    from ifseg_torch.config import model_config_for_arch

    return model_config_for_arch("segofa_huge", patch_image_size=512, orig_patch_image_size=512,
                                 num_seg_tokens=classes, dtype=dtype, **overrides)


def build_on_card(cfg):
    """SegOFA of ``cfg`` made on the card with random weights from SEED drawn
    by a CUDA generator: no pass of the CPU over its parameters."""
    from ifseg_torch.models.segofa import SegOFA

    with torch.device("cuda"):
        model = SegOFA(cfg)
    return model.to("cuda").init(torch.Generator(device="cuda").manual_seed(SEED))


def check_huge_launches(path: str, counts, want):
    """Every attention launch of a Huge path at head dim 80, by TMA, no copy."""
    from ifseg_torch.ops import flash_attention as fa

    by_dim, routes = dict(fa.LAUNCHES_BY_HEAD_DIM), fa.bias_route_counts()
    log(f"[10] {path}: attention launches {counts} (expected {want}), by head dim {by_dim}, "
        f"bias routes {routes}")
    if counts != want:
        fail(f"the Huge {path} path did not launch every attention kernel at every site")
    if by_dim != {64: 0, 80: sum(counts.values())}:
        fail(f"the Huge {path} path launched an instantiation other than head dim 80: {by_dim}")
    if routes != dict(fwd_bias_tma=counts["infer"] + counts["stats"], fwd_bias_threads=0,
                      bwd_bias_copies=0):
        fail(f"the Huge {path} path staged a bias by threads or copied one: {routes}")
    return by_dim


def check_huge_ln(path: str, model, position_lns: bool, per_key: str, passes: int):
    """K4 at every LayerNorm of ``passes`` no-gradient forwards, the CTA-per-row
    kernel at every ffn_layernorm (5,120 wide)."""
    from ifseg_torch.ops import layer_norm as ln

    per_pass = ln_launches_per_forward(model, position_lns)
    if per_pass != ln_sites_per_pass(per_key, HUGE_LN_PATHS):
        fail(f"{per_pass} LayerNorm sites in a Huge {path} forward, "
             f"{ln_sites_per_pass(per_key, HUGE_LN_PATHS)} held against the plain version")
    wide = (HUGE["enc_layers"] + HUGE["dec_layers"]) * passes
    log(f"[10] {path}: layer_norm launches {ln.LAUNCHES} (expected {per_pass} x {passes}), "
        f"{ln.LAUNCHES_WIDE} of them a CTA a row at width {HUGE['ffn']} (expected {wide})")
    if ln.LAUNCHES != per_pass * passes or ln.LAUNCHES_WIDE != wide:
        fail(f"the Huge {path} path did not launch the layer_norm kernel at every LayerNorm")
    return dict(launches=ln.LAUNCHES, wide=ln.LAUNCHES_WIDE)


def phase_huge_serve(card: str):
    from ifseg_torch.eval.serving import SegServer
    from ifseg_torch.ops import flash_attention as fa
    from ifseg_torch.ops import layer_norm as ln

    cfg = huge_config("bfloat16")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_on_card(cfg)
    n_params = sum(p.numel() for p in model.parameters())
    server = SegServer(model, src_len=SRC_LEN)
    torch.cuda.synchronize()
    log(f"[10] SegOFA-Huge 512px, {HUGE['enc_layers']} + {HUGE['dec_layers']} layers, width "
        f"{HUGE['width']}, {HUGE['heads']} heads of {HUGE['head_dim']}, FFN {HUGE['ffn']}, "
        f"{n_params / 1e6:.1f}M params, seed {SEED} on the card: build + SegServer set-up "
        f"{time.perf_counter() - t0:.1f} s")
    per_forward = sum(n for *_, n in attn_sites(HUGE))
    fa.reset_launches()
    ln.reset_launches()
    b = HUGE_SERVE_BATCH
    inputs = [x.to(server.device) for x in requests(b, seed=700)]
    t1 = time.perf_counter()
    logits = server(*inputs)
    torch.cuda.synchronize()
    log(f"[10] serving, batch {b}: logits {tuple(logits.shape)} in "
        f"{(time.perf_counter() - t1) * 1e3:.1f} ms (first forward)")
    if tuple(logits.shape) != (b, 1 + 1024, cfg.num_seg_tokens) or not bool(
            torch.isfinite(logits).all()):
        fail(f"Huge served logits {tuple(logits.shape)}, finite {bool(torch.isfinite(logits).all())}")
    steps = 3
    server(*inputs)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(steps):
        server(*inputs)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t1) / steps
    forwards = 2 + steps
    counts = fa.launch_counts()
    zero = dict(infer=0, stats=0, bwd_di=0, bwd_dq=0, bwd_dkv=0)
    check_huge_launches("serving", counts, dict(zero, infer=per_forward * forwards))
    ln_counts = check_huge_ln("serving", model, False, "per_forward", forwards)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    log(f"[10] serving, steady state, batch {b}: {dt * 1e3:.1f} ms/forward, {b / dt:.2f} img/s, "
        f"max_memory_allocated {peak_gb:.2f} GiB, on {card}")
    del server, model, logits, inputs
    torch.cuda.empty_cache()
    return dict(batch=b, img_per_s=b / dt, ms_per_forward=dt * 1e3, max_memory_gib=peak_gb,
                launches=counts["infer"], forwards=forwards, ln_launches=ln_counts["launches"],
                ln_wide_launches=ln_counts["wide"], params_m=n_params / 1e6)


def phase_huge_logits():
    """Served logits at Huge's width and a reduced depth: the card (bf16,
    kernels) against the port's fp32 forward on the CPU, same weights."""
    from ifseg_torch.eval.serving import SegServer
    from ifseg_torch.models.segofa import SegOFA

    depth = dict(encoder_layers=HUGE_CHECK_LAYERS, decoder_layers=HUGE_CHECK_LAYERS)
    model = build_on_card(huge_config("bfloat16", **depth))
    weights = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    server = SegServer(model, src_len=SRC_LEN)
    src, img, bos = requests(2, seed=300)
    card = server(src, img, bos).float().cpu()
    ref_model = SegOFA(huge_config("float32", **depth))
    ref_model.load_state_dict(weights, strict=True)
    t0 = time.perf_counter()
    ref = SegServer(ref_model, src_len=SRC_LEN, device="cpu")(src, img, bos)
    rel = ((card - ref).norm() / ref.norm()).item()
    agree = (card.argmax(-1) == ref.argmax(-1)).float().mean().item()
    log(f"[10] card bf16 vs CPU fp32 served logits, SegOFA-Huge at {HUGE_CHECK_LAYERS} + "
        f"{HUGE_CHECK_LAYERS} layers (reduced depth), full width, batch 2 "
        f"({time.perf_counter() - t0:.1f} s on the CPU): relative logit error {rel:.3e} "
        f"(limit {LOGIT_REL_TOL}), per-cell argmax agreement {agree:.4f}")
    if not rel <= LOGIT_REL_TOL:
        fail(f"Huge card logits differ from the CPU forward: {rel} > {LOGIT_REL_TOL}")
    del server, model
    torch.cuda.empty_cache()
    return dict(rel_err=rel, argmax_agreement=agree, layers=HUGE_CHECK_LAYERS)


def phase_huge_train(card: str):
    from ifseg_torch.ops import flash_attention as fa
    from ifseg_torch.ops import layer_norm as ln
    from ifseg_torch.train.trainer import Trainer

    tokens, lengths = class_table(SEED)
    rng = np.random.default_rng(SEED + 1)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = Trainer(train_config("bfloat16", monitor=False, arch=HUGE["arch"]), tokens, lengths,
                      total_num_updates=100).init_state()  # the card, by default
    torch.cuda.synchronize()
    n_train = sum(p.numel() for p in trainer.optimizer.params)
    if trainer.cfg.model.checkpoint_activations:
        fail(f"auto checkpoints SegOFA-Huge's layers at batch {HUGE_TRAIN_BATCH}")
    log(f"[10] Trainer, SegOFA-Huge 512px, batch {HUGE_TRAIN_BATCH}, {TRAIN_CLASSES} classes, "
        f"{n_train / 1e6:.1f}M trainable params, seed {SEED}, no activation checkpointing: "
        f"set-up {time.perf_counter() - t0:.1f} s")
    start = {n: p.detach().clone() for n, p in trainer.model.named_parameters() if trainer.mask[n]}
    fa.reset_launches()
    ln.reset_launches()
    warm, timed = 2, 3
    logs, times = take_steps(trainer, rng, warm + timed, HUGE_TRAIN_BATCH, real=False)
    steps = warm + timed
    for i, lg in enumerate(logs):
        log(f"[10] training step {i}: loss {lg['loss']:.4f} gnorm {lg['gnorm']:.4f} "
            f"n_nonfinite {lg['n_nonfinite']:.0f}")
        if not (np.isfinite(lg["loss"]) and np.isfinite(lg["gnorm"])) or lg["n_nonfinite"] != 0:
            fail(f"Huge training step {i}: non-finite loss or gradient norm")
    per_pass = sum(n for *_, n in attn_sites(HUGE))
    counts = fa.launch_counts()
    want = dict(infer=0, stats=per_pass * steps, bwd_di=per_pass * steps,
                bwd_dq=per_pass * steps, bwd_dkv=per_pass * steps)
    check_huge_launches("training", counts, want)
    if ln.LAUNCHES:
        fail(f"the Huge training forward launched the layer_norm kernel {ln.LAUNCHES} times")
    moved = sum(int(not torch.equal(p, start[n])) for n, p in trainer.model.named_parameters()
                if n in start)
    if moved < 0.95 * len(start):
        fail(f"only {moved} of {len(start)} trainable Huge tensors moved")
    s_step = float(np.mean(times[warm:]))
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    log(f"[10] training, steady state, batch {HUGE_TRAIN_BATCH}: {s_step:.4f} s/step "
        f"(steps: {', '.join(f'{t:.3f}' for t in times)}), {moved}/{len(start)} trainable "
        f"tensors moved, max_memory_allocated {peak_gb:.2f} GiB, on {card}")
    del start
    return trainer, dict(batch=HUGE_TRAIN_BATCH, s_per_step=s_step, max_memory_gib=peak_gb,
                         launches=counts, steps=steps, final_loss=logs[-1]["loss"])


def phase_huge_eval(card: str, trainer):
    """An Evaluator built on the trainer's model: one group of 8 uint8 rows at
    the (512, 768) bucket (the trainer's 15 classes), its launches, its time,
    the refresh of its serving copy, and the trainer's parameters after it."""
    from ifseg_torch.eval.evaluator import Evaluator
    from ifseg_torch.ops import flash_attention as fa
    from ifseg_torch.ops import layer_norm as ln

    before = {n: (p.dtype, p.device, p.data_ptr()) for n, p in trainer.model.named_parameters()}
    cfg = eval_config("bfloat16", trainer.cfg.model)
    torch.cuda.empty_cache()  # the training steps' cached blocks: the group budget reads free memory
    t0 = time.perf_counter()
    evaluator = Evaluator(cfg, trainer.model)
    torch.cuda.synchronize()
    log(f"[10] Evaluator on the trainer's SegOFA-Huge, {TRAIN_CLASSES} classes: set-up "
        f"{time.perf_counter() - t0:.2f} s, at most {evaluator._max_group_rows(512, 768)} rows a "
        f"group at the (512, 768) bucket")
    wide = eval_samples(EVAL_SHAPES_WIDE, 800, classes=TRAIN_CLASSES)
    fa.reset_launches()
    ln.reset_launches()
    stats = {}
    logs = evaluator.eval_dataset(ListDataset(wide), batch_size=8, stats_out=stats)
    counts = fa.launch_counts()
    zero = dict(infer=0, stats=0, bwd_di=0, bwd_dq=0, bwd_dkv=0)
    check_huge_launches("evaluation", counts, dict(zero, infer=sum(n for *_, n in eval_sites(HUGE))))
    ln_counts = check_huge_ln("evaluation", evaluator.model, True, "per_eval_group", 1)
    if stats["group_sizes"] != [len(wide)]:
        fail(f"Huge evaluation groups {stats['group_sizes']}")
    out = logs[0]
    n_valid = sum(int((s.ori_semantic_seg != TRAIN_CLASSES).sum()) for s in wide)
    ai, al, au = (out[f"area_{k}"] for k in ("intersect", "label", "union"))
    if not np.isfinite(out["nll_loss"]) or out["nll_cnt"] != n_valid or al.sum() != n_valid \
            or not (ai <= au).all():
        fail(f"Huge evaluation: nll_loss {out['nll_loss']}, nll_cnt {out['nll_cnt']}, label sum "
             f"{al.sum()} vs {n_valid} valid pixels")
    after = {n: (p.dtype, p.device, p.data_ptr()) for n, p in trainer.model.named_parameters()}
    if after != before or any(dt != torch.float32 for dt, _, _ in after.values()):
        fail("the Evaluator changed the dtype, device or storage of the trainer's parameters")
    evaluator._run_group(wide)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    iters = 2
    for _ in range(iters):
        evaluator._run_group(wide)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t1) / iters
    log(f"[10] evaluation, group of {len(wide)} at the (512, 768) bucket: nll_loss "
        f"{out['nll_loss']:.4f}, {n_valid} valid pixels; {dt * 1e3:.1f} ms a group, "
        f"{len(wide) / dt:.2f} img/s, on {card}; the trainer's {len(after)} parameters are "
        f"fp32 and in place after it")
    refresh = refresh_timing(evaluator, "[10]", card)
    del evaluator
    return dict(rows=len(wide), ms_per_group=dt * 1e3, img_per_s=len(wide) / dt,
                launches=counts["infer"], ln_launches=ln_counts["launches"],
                ln_wide_launches=ln_counts["wide"], refresh=refresh,
                nll_loss=float(out["nll_loss"]))


# ---------------------------------------------------------------- phase 11: validate

# The TSV of phase 11: VALID_ROWS rows of (base64 image PNG, base64 label PNG,
# id), pixels from a numpy generator seeded with SEED.  The original shapes
# cover every branch of the keep-ratio resize into the (2048, 512) box: two
# up-scales, a down-scale, an exact 2x (cv2's area average), the equal size (a
# copy), a portrait and a square.  Images cycle through PNG colour types 2, 0,
# 3 and 6 (RGB, gray, palette, RGBA), labels through gray and palette files
# at 1, 2 and 4 bits; every PNG cycles its rows through the five filter types.
VALID_ROWS = 24
VALID_SHAPES = [(480, 640), (375, 500), (600, 800), (1024, 1366), (512, 683), (640, 480),
                (500, 500)]
IMAGE_COLOURS = (2, 0, 3, 6)
LABEL_FORMATS = ((0, 8), (3, 1), (0, 8), (3, 2), (0, 8), (3, 4))  # (colour type, bit depth)
# SHA-256 (first 16 hex digits) of every row's decoded, resized patch_image and
# of its shifted ori_semantic_seg as the JAX package's pipeline gives them (PIL
# and cv2), for seed SEED; tests/test_torch_dataset.py computes them again
# with the JAX package and holds these
VALID_DIGESTS = [
    ("0e43e4c608eae006", "4e81700b65a91492"),  # row 0
    ("6115bddee3b02e3a", "ad59739114b775eb"),  # row 1
    ("95f198f5b1d0df02", "7a15fa9c908eb783"),  # row 2
    ("bc03d2a7b8d28391", "2e1faede0b1fde41"),  # row 3
    ("ba1d70d673af1172", "ae847bec9457185f"),  # row 4
    ("62035b9ca8767a3d", "cf35064805a401ed"),  # row 5
    ("7b41aec9af4d17f8", "c1b524d6befda6b0"),  # row 6
    ("e2673db4f536365e", "a12e8bf83bcf80b6"),  # row 7
    ("1247b9b6c452e6e4", "6ff60c3c6a16970e"),  # row 8
    ("8bf0d20b364103a6", "344ea3acf334f64a"),  # row 9
    ("78f274e41c2d8b2c", "b0572f4e9b34f31f"),  # row 10
    ("d42042f5c503efb6", "66c8b19cc196dde0"),  # row 11
    ("0d67f91bbced5fe9", "0f376b4063273e3c"),  # row 12
    ("5fbd0d3156776d8a", "c24406b52df19893"),  # row 13
    ("94144d4425eb2483", "61a1eb211b11f922"),  # row 14
    ("36dc7693453c23bf", "19a40aaa95dbd9d6"),  # row 15
    ("5cdc4ab3c5433958", "6b303e4e560b5e8d"),  # row 16
    ("613573240a2c8f65", "a16ce1f24ff9f5d3"),  # row 17
    ("4e3c7421b304b3c1", "fcee5430f518d486"),  # row 18
    ("126cec7b248aaad2", "cc689b6dd6648104"),  # row 19
    ("c1e9d2ad0413920e", "ef6b956af1adddc7"),  # row 20
    ("b3430344c6fadd2c", "3e20256c1dc15c9d"),  # row 21
    ("b0d93a42c9058f3b", "41451b98ef89f250"),  # row 22
    ("f8b09ce0bd82768e", "4dc0321e02f611f5"),  # row 23
]


def png_bytes(arr, colour: int, depth: int = 8, filters=(0, 1, 2, 3, 4)) -> bytes:
    """A PNG file of ``arr`` (uint8 samples; (h, w) for colour types 0 and 3)
    written with zlib and struct alone: row y filtered with filter type
    ``filters[y % len(filters)]``, samples below 8 bits packed high bits
    first; a palette file gets a gray ramp of 2**depth entries."""
    import struct
    import zlib

    h, w = arr.shape[:2]
    channels = {0: 1, 2: 3, 3: 1, 6: 4}[colour]
    samples = np.ascontiguousarray(arr, np.uint8).reshape(h, w * channels)
    if depth < 8:
        per_byte = 8 // depth
        packed = np.pad(samples, ((0, 0), (0, (-w) % per_byte))).reshape(h, -1, per_byte)
        shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint16)
        samples = (packed.astype(np.uint16) << shifts).sum(-1).astype(np.uint8)
    bpp = max(channels * depth // 8, 1)
    raw = samples.astype(np.int16)
    zeros = np.zeros((h, bpp), np.int16)
    up = np.vstack([np.zeros_like(raw[:1]), raw[:-1]])
    left = np.hstack([zeros, raw[:, :-bpp]])
    corner = np.hstack([zeros, up[:, :-bpp]])
    p = left + up - corner
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - corner)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, corner))
    kinds = np.asarray(filters)[np.arange(h) % len(filters)]
    pred = np.stack([np.zeros_like(raw), left, up, (left + up) >> 1, paeth])[kinds, np.arange(h)]
    body = np.empty((h, raw.shape[1] + 1), np.uint8)
    body[:, 0] = kinds
    body[:, 1:] = ((raw - pred) & 0xFF).astype(np.uint8)

    def chunk(kind: bytes, data: bytes) -> bytes:
        return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))

    out = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0, 0))
    if colour == 3:
        ramp = np.linspace(0, 255, 1 << depth).astype(np.uint8)
        out += chunk(b"PLTE", np.repeat(ramp, 3).tobytes())
    return out + chunk(b"IDAT", zlib.compress(body.tobytes(), 6)) + chunk(b"IEND", b"")


def valid_rows(seed: int = SEED, rows: int = VALID_ROWS, classes: int = EVAL_CLASSES):
    """(image PNG, label PNG, id) of every TSV row.  Images are blocks of 32
    pixels plus noise, labels blocks of 64 pixels of values 0..classes (0 is
    'ignore' before the label shift), fewer where the bit depth is lower."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(rows):
        h, w = VALID_SHAPES[i % len(VALID_SHAPES)]
        colour = IMAGE_COLOURS[i % len(IMAGE_COLOURS)]
        c = {0: 1, 2: 3, 3: 1, 6: 4}[colour]
        base = rng.integers(0, 232, size=(h // 32 + 1, w // 32 + 1, c))
        img = np.repeat(np.repeat(base, 32, 0), 32, 1)[:h, :w] + rng.integers(0, 24, size=(h, w, c))
        img = img.astype(np.uint8)[..., 0] if c == 1 else img.astype(np.uint8)
        lc, ld = LABEL_FORMATS[i % len(LABEL_FORMATS)]
        lab = rng.integers(0, min(classes + 1, 1 << ld), size=(h // 64 + 1, w // 64 + 1))
        lab = np.repeat(np.repeat(lab, 64, 0), 64, 1)[:h, :w].astype(np.uint8)
        out.append((png_bytes(img, colour), png_bytes(lab, lc, ld), i))
    return out


def write_valid_tsv(path, seed: int = SEED) -> str:
    import base64

    with open(path, "w") as fp:
        for image, label, i in valid_rows(seed):
            fp.write(f"{base64.urlsafe_b64encode(image).decode()}\t"
                     f"{base64.urlsafe_b64encode(label).decode()}\t{i}\n")
    return str(path)


def row_digest(arr) -> str:
    import hashlib

    arr = np.ascontiguousarray(arr)
    return hashlib.sha256(f"{arr.dtype}{arr.shape}".encode() + arr.tobytes()).hexdigest()[:16]


def ade_argv(tsv: str, ckpt: str, dtype: str = "bfloat16"):
    """The flags of run_scripts/IFSeg/ade.sh and common.sh that evaluation
    reads (common.sh runs with PARITY=1, so the erf gelu), with
    --batch-size-valid=8 and the compute dtype."""
    import re

    text = (REPO / "run_scripts" / "IFSeg" / "ade.sh").read_text()
    cats = ade_category_list()
    n = re.search(r"export num_seg_tokens=(\d+)", text).group(1)
    return [tsv, "--selected-cols=0,1,2", f"--bpe-dir={REPO / 'assets' / 'BPE'}",
            f"--restore-file={ckpt}", "--arch=segofa_base", f"--num-seg-tokens={n}",
            f"--category-list={cats}",
            "--prompt-prefix=what is the segmentation map of the image? object:",
            "--patch-image-size=512", "--orig-patch-image-size=512", "--activation-fn=gelu",
            "--decoder-input-type=encoder_output", "--full-context-alignment=false",
            "--tie-seg-projection=true", "--resnet-topk=3", "--resnet-iters=25",
            "--batch-size-valid=8", f"--dtype={dtype}"]


def check_loaded_weights(model, ckpt: str, model_cfg):
    """Every tensor of ``model`` equals the file's where the file has one of
    its shape, the seed-0 fresh init where not, and the token embedding's
    appended row equals the seed-0 normal draw of the surgery."""
    from ifseg_torch.checkpoint.convert import _SEG_ONLY_KEYS, load_torch_checkpoint
    from ifseg_torch.models.segofa import SegOFA

    file_sd = load_torch_checkpoint(ckpt)
    fresh = SegOFA(model_cfg).init(torch.Generator().manual_seed(0)).state_dict()
    vocab, dim = model_cfg.vocab_size, model_cfg.encoder_embed_dim
    row = torch.from_numpy(np.random.default_rng(0).normal(0.0, dim ** -0.5, (1, dim))
                           .astype(np.float32))
    loaded, backfilled = [], []
    for k, v in model.state_dict().items():
        f = file_sd.get(k)
        if k in ("encoder.embed_tokens.weight", "decoder.embed_tokens.weight"):
            ok = (f.shape[0] == vocab - 1 and torch.equal(v[:-1], f) and torch.equal(v[-1:], row))
            loaded.append(k)
        elif f is not None and f.shape == v.shape:
            ok = torch.equal(v, f.to(v.dtype))
            loaded.append(k)
        else:
            ok = torch.equal(v, fresh[k])
            backfilled.append(k)
        if not ok:
            fail(f"loaded weight {k} is neither the file's nor the fresh init's")
    want = sorted(k for k in fresh if any(seg in k for seg in _SEG_ONLY_KEYS))
    if sorted(backfilled) != want:
        fail(f"backfilled {sorted(backfilled)}, expected the seg-only tensors {want}")
    return dict(loaded=len(loaded), backfilled=len(backfilled), file_tensors=len(file_sd))


def cheapest_group_against_cpu(tag: str, groups, main_logs, tsv: str, ckpt: str, model=None):
    """A counted validate run's own logs against the fp32 CPU evaluator, on
    the group cheapest for the CPU (label areas are exact on both sides, so
    they pick that group out of main's logs): nll_loss within
    EVAL_NLL_REL_TOL relative, the share of pixels predicted otherwise
    within EVAL_PIXEL_SHARE_TOL; ``model`` is loaded from ``ckpt`` if not
    given."""
    from ifseg_torch.checkpoint.convert import load_model
    from ifseg_torch.config import from_flags
    from ifseg_torch.eval.evaluator import Evaluator, group_key

    group = min(groups, key=lambda g: len(g) * (group_key(g[0])[0] * group_key(g[0])[1]
                                               + group_key(g[0])[2] * group_key(g[0])[3]))
    t0 = time.perf_counter()
    cfg = from_flags(ade_argv(tsv, ckpt, "float32"))
    if model is None:
        model = load_model(ckpt, cfg.model)
    reference = Evaluator(cfg, model, device="cpu")
    cpu_out = reference._read_back(reference._run_group(group))
    found = [lg for lg in main_logs if np.array_equal(lg["area_label"], cpu_out["area_label"])]
    if len(found) != 1:
        fail(f"{len(found)} of validate.main's {len(main_logs)} group logs count the label "
             f"areas of rows {[s.id for s in group]}; expected one")
    card_out = found[0]
    n_px = float(cpu_out["area_label"].sum())
    shares = {k: float(np.abs(card_out[k] - cpu_out[k]).sum() / 2 / n_px)
              for k in ("area_pred_label", "area_pred_label_resnet_postprocess")}
    nll_rel = (abs(float(card_out["nll_loss"]) - float(cpu_out["nll_loss"]))
               / float(cpu_out["nll_loss"]))
    log(f"{tag} validate.main's own group of the TSV's rows {[s.id for s in group]} on the card "
        f"(bf16) vs the CPU fp32 Evaluator ({time.perf_counter() - t0:.1f} s on the CPU): "
        f"nll_loss {float(card_out['nll_loss']):.5f} vs {float(cpu_out['nll_loss']):.5f} (rel "
        f"{nll_rel:.3e}, limit {EVAL_NLL_REL_TOL}); share of pixels predicted otherwise "
        f"{shares['area_pred_label']:.4f}, after label propagation "
        f"{shares['area_pred_label_resnet_postprocess']:.4f} (limit {EVAL_PIXEL_SHARE_TOL})")
    if not nll_rel <= EVAL_NLL_REL_TOL:
        fail(f"card nll_loss differs from the CPU's: {nll_rel} > {EVAL_NLL_REL_TOL}")
    if not max(shares.values()) <= EVAL_PIXEL_SHARE_TOL:
        fail(f"card predictions differ from the CPU's on {shares} of the pixels")
    return dict(nll_rel_err=nll_rel, pixel_share_differs=shares)


def phase_validate(card: str, tmp: str):
    """``ifseg_torch.cli.validate.main`` on the card over a TSV of
    VALID_ROWS rows, OFA-Base at full width and depth, the ADE flags (150
    classes, label propagation top-3 x 25), an ofa_base.pt-shaped checkpoint
    fabricated from seed SEED + 1; both written into ``tmp``, where phase 12
    reads them."""
    import base64

    from ifseg_torch.checkpoint.convert import fabricate_ofa_base_checkpoint, load_model
    from ifseg_torch.cli import validate as cli_validate
    from ifseg_torch.config import from_flags
    from ifseg_torch.data.png import decode_png
    from ifseg_torch.eval.evaluator import Evaluator, group_key
    from ifseg_torch.ops import flash_attention as fa
    from ifseg_torch.ops import layer_norm as ln
    from ifseg_torch.tasks.segmentation import SegmentationTask

    result = {}
    tsv, ckpt = f"{tmp}/validation.tsv", f"{tmp}/ofa_base.pt"
    result.update(tsv=tsv, ckpt=ckpt)
    t0 = time.perf_counter()
    write_valid_tsv(tsv)
    result["tsv_write_s"] = time.perf_counter() - t0
    cfg = from_flags(ade_argv(tsv, ckpt))
    t0 = time.perf_counter()
    fabricate_ofa_base_checkpoint(ckpt, cfg.model, seed=SEED + 1)  # built on the card
    result["fabricate_s"] = time.perf_counter() - t0
    log(f"[11] TSV of {VALID_ROWS} rows ({Path(tsv).stat().st_size / 2**20:.1f} MiB, "
        f"{result['tsv_write_s']:.1f} s), ofa_base-shaped checkpoint "
        f"({Path(ckpt).stat().st_size / 2**20:.0f} MiB, {result['fabricate_s']:.1f} s), on {card}")

    # the task: dictionary, BPE, the prompt
    t0 = time.perf_counter()
    task = SegmentationTask.setup_task(cfg)
    ds = task.load_dataset("valid")
    result["task_setup_s"] = time.perf_counter() - t0
    if len(ds.src_item) != VALID_SRC_LEN or len(ds) != VALID_ROWS:
        fail(f"prompt of {len(ds.src_item)} tokens, {len(ds)} rows; expected "
             f"{VALID_SRC_LEN}, {VALID_ROWS}")
    log(f"[11] BPE + dictionary + prompt set-up: {result['task_setup_s']:.3f} s on the host; "
        f"prompt {len(ds.src_item)} tokens; dictionary {len(task.dict)} symbols; beside {card}")

    # the host path of every row, timed by part, and its digests
    image_ms, label_ms, samples = [], [], []
    for i in range(len(ds)):
        image_b64, seg_b64, _ = ds.dataset[i]
        t0 = time.perf_counter()
        img = decode_png(base64.urlsafe_b64decode(image_b64))
        img = np.repeat(img[:, :, None], 3, axis=2) if img.ndim < 3 else img[:, :, :3]
        ds.eval_resize(np.ascontiguousarray(img[:, :, ::-1]))
        t1 = time.perf_counter()
        decode_png(base64.urlsafe_b64decode(seg_b64)).astype(np.int32)
        t2 = time.perf_counter()
        image_ms.append((t1 - t0) * 1e3)
        label_ms.append((t2 - t1) * 1e3)
        s = ds.get_eval_sample(i)
        samples.append(s)
        got = (row_digest(s.patch_image), row_digest(s.ori_semantic_seg))
        if got != VALID_DIGESTS[i]:
            fail(f"row {i}: digests {got} of the decoded row, PIL/cv2 give {VALID_DIGESTS[i]}")
    result["host_ms_per_row"] = dict(image=float(np.mean(image_ms)), label=float(np.mean(label_ms)),
                                     image_max=max(image_ms), label_max=max(label_ms))
    log(f"[11] host, one thread: base64 + PNG decode + resize {np.mean(image_ms):.2f} ms a row "
        f"for the image (max {max(image_ms):.2f}), base64 + PNG decode "
        f"{np.mean(label_ms):.2f} ms for the label (max {max(label_ms):.2f}); all "
        f"{VALID_ROWS} rows equal the PIL/cv2 digests; beside {card}")

    # the weights: read, surgery, strict load, and where each tensor came from
    t0 = time.perf_counter()
    model = load_model(ckpt, cfg.model)
    result["load_s"] = time.perf_counter() - t0
    result["weights"] = check_loaded_weights(model, ckpt, cfg.model)
    log(f"[11] checkpoint read + vocab surgery + strict load: {result['load_s']:.2f} s; "
        f"{result['weights']['loaded']} tensors from the file, {result['weights']['backfilled']} "
        f"seg-only tensors backfilled with the seed-0 init, appended vocab row = the seed-0 draw; "
        f"host time beside {card}")

    # validate, end to end, on the card
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    ln.reset_launches()
    t0 = time.perf_counter()
    main_logs = []
    vals = cli_validate.main(from_flags(ade_argv(tsv, ckpt)), logs_out=main_logs)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts, ln_launches, routes = fa.launch_counts(), ln.LAUNCHES, fa.bias_route_counts()
    peak = torch.cuda.max_memory_allocated()
    keys = {}
    for s in samples:
        keys.setdefault(group_key(s), []).append(s)
    groups = [m[j:j + 8] for m in keys.values() for j in range(0, len(m), 8)]
    k1_per, ln_per = sum(n for *_, n in EVAL_SITES), ln_sites_per_pass("per_validate_group")
    log(f"[11] validate.main: {json.dumps(vals)}")
    log(f"[11] validate.main: {dt:.2f} s, {VALID_ROWS / dt:.2f} img/s of the whole main "
        f"({VALID_ROWS / max(vals['sec'], 1e-9):.2f} img/s of its evaluation loop, "
        f"{vals['sec']} s); attention launches {counts}, layer_norm launches {ln_launches} "
        f"(expected {k1_per} and {ln_per} a group, {len(groups)} groups of "
        f"{[len(g) for g in groups]}); bias routes {routes}; peak device memory "
        f"{peak / 2**30:.2f} GiB, on {card}")
    if counts != dict(infer=k1_per * len(groups), stats=0, bwd_di=0, bwd_dq=0, bwd_dkv=0):
        fail("validate did not launch the attention kernel at every site of every group")
    if ln_launches != ln_per * len(groups):
        fail("validate did not launch the layer_norm kernel at every LayerNorm")
    if routes != dict(fwd_bias_tma=counts["infer"], fwd_bias_threads=0, bwd_bias_copies=0):
        fail(f"validate staged a bias by threads: {routes}")
    want_keys = {"loss", "nll_loss", "aAcc", "mIoU", "mAcc", "aAcc_resnet_postprocess",
                 "mIoU_resnet_postprocess", "mAcc_resnet_postprocess", "num_images", "sec"}
    if set(vals) != want_keys or vals["num_images"] != VALID_ROWS:
        fail(f"validate returned {sorted(vals)}, expected {sorted(want_keys)}")
    if not (np.isfinite(vals["loss"]) and all(0.0 <= vals[k] <= 1.0 for k in want_keys
                                              if k[1:4] in ("Acc", "IoU"))):
        fail(f"validate values out of range: {vals}")
    result.update(vals=vals, main_s=dt, img_per_s=VALID_ROWS / dt,
                  loop_img_per_s=VALID_ROWS / max(vals["sec"], 1e-9),
                  launches=counts["infer"], ln_launches=ln_launches, bias_routes=routes,
                  peak_gib=peak / 2**30, group_sizes=[len(g) for g in groups])

    # each group alone: the host's packing timed apart; the forward's wall
    # time (CUDA events around the host's launches and the card's work);
    # the card's busy time (the kernels and copies of a profiler trace)
    evaluator = Evaluator(cfg, model)
    per_group = []
    for g in groups:
        t0 = time.perf_counter()
        _, args = evaluator._pack_group(g)
        pack_ms = (time.perf_counter() - t0) * 1e3
        wall = cuda_ms(lambda: evaluator._forward_group(*args), iters=2, warmup=1)
        busy = device_busy_ms(lambda: evaluator._forward_group(*args))
        key = group_key(g[0])
        per_group.append(dict(rows=len(g), bucket=key[:4], grid=key[4:6], pack_ms=pack_ms,
                              wall_ms=wall, device_ms=busy))
        log(f"[11]   group of {len(g)}, image bucket {key[:2]}, target bucket {key[2:4]}, "
            f"grid {key[4:6]}: host packing {pack_ms:.1f} ms; forward {wall:.1f} ms of wall "
            f"time (host launches + card), the card busy {busy:.1f} ms of it "
            f"({busy / len(g):.2f} ms a row), on {card}")
    result["groups"] = per_group
    device_ms_row = sum(p["device_ms"] for p in per_group) / VALID_ROWS
    wall_ms_row = sum(p["pack_ms"] + p["wall_ms"] for p in per_group) / VALID_ROWS
    host_ms_row = result["host_ms_per_row"]["image"] + result["host_ms_per_row"]["label"]
    result["pace"] = dict(host_ms_per_row=host_ms_row, device_ms_per_row=device_ms_row,
                          consumer_wall_ms_per_row=wall_ms_row,
                          set_by="host" if host_ms_row > device_ms_row else "device")
    log(f"[11] pace: one producer thread decodes a row in {host_ms_row:.2f} ms; the consumer "
        f"packs and runs one in {wall_ms_row:.2f} ms of wall time, of which the card is busy "
        f"{device_ms_row:.2f} ms: the {result['pace']['set_by']} sets it, on {card}")

    del evaluator
    torch.cuda.empty_cache()
    result.update(cheapest_group_against_cpu("[11]", groups, main_logs, tsv, ckpt, model))
    return result


# ---------------------------------------------------------------- phase 12: the training CLI

CLI_ROWS = 48  # --epoch-row-count: 3 steps of TRAIN_BATCH rows an epoch
CLI_WORKERS = 8  # --num-workers of the counted run: one thread a core of the card's host
HOST_ROWS = 16  # training rows timed on one thread, decode and augmentations apart


def common_sh_argv(data: str, save_dir: str, restore_file: str):
    """The flags run_scripts/IFSeg/common.sh passes to the training CLI, with
    its defaults (PARITY=1: the erf gelu) and ade.sh's classes."""
    import re
    import shlex

    common = (REPO / "run_scripts" / "IFSeg" / "common.sh").read_text()
    ade = (REPO / "run_scripts" / "IFSeg" / "ade.sh").read_text()
    env = dict(re.findall(r"^(\w+)=\$\{\w+:-([^}]*)\}", common, re.M))
    env.update(activation_fn="gelu", data=data, save_path=save_dir, restore_file=restore_file,
               bpe_dir=str(REPO / "assets" / "BPE"),
               num_seg_tokens=re.search(r"export num_seg_tokens=(\d+)", ade).group(1),
               category_list=re.search(r"export category_list='([^']*)'", ade).group(1))
    call = common[common.index("python -m ifseg_tpu.cli.train"):]
    call = call[:call.index('"$@"')].replace("\\\n", " ")
    call = re.sub(r"\$\{?(\w+)\}?", lambda m: env[m.group(1)], call)
    return shlex.split(call)[3:]


RESET_FLAGS = ("--reset-optimizer", "--reset-dataloader", "--reset-meters")


def host_train_rows(ds, rows: int, seed: int):
    """One thread's ms a training row: the base64 + PNG decode, and each
    augmentation of the chain (the row's own generator, as the iterator of
    epoch 1 draws it), over the first ``rows`` rows of ``ds``."""
    parts = dict(decode=[], resize=[], crop=[], flip=[], distort=[])
    for i in range(rows):
        rng = np.random.default_rng((seed, 1, i))
        t = [time.perf_counter()]
        img, seg, _ = ds._decode_row(i)
        t.append(time.perf_counter())
        img, seg = ds.resize(img, seg, rng)
        t.append(time.perf_counter())
        img, seg = ds.crop(img, seg, rng)
        t.append(time.perf_counter())
        img, seg = ds.flip(img, seg, rng)
        t.append(time.perf_counter())
        ds.distort(img, rng)
        t.append(time.perf_counter())
        for k, a, b in zip(parts, t, t[1:]):
            parts[k].append((b - a) * 1e3)
    out = {k: float(np.mean(v)) for k, v in parts.items()}
    out["augment"] = sum(out[k] for k in ("resize", "crop", "flip", "distort"))
    out["row"] = out["decode"] + out["augment"]
    return out


def phase_train_cli(card: str, tmp: str, valid_tsv: str, ckpt_file: str, valid_groups: int):
    """``ifseg_torch.cli.train.main`` on the card with the flags of
    run_scripts/IFSeg/common.sh + ade.sh: OFA-Base at full width and depth,
    150 classes, batch 16, the monitoring forward, phase 11's fabricated
    ofa_base.pt; phase 11's TSV to validate and, twice over (48 rows, 3 steps
    an epoch), to train.  The counted run takes 2 epochs; then a run to
    epoch 3 that stops at update 7 and one that resumes from its cursor, the
    image-free fast path, and the counted run's first epoch on one thread."""
    import gc

    from ifseg_torch.checkpoint.manager import CheckpointManager
    from ifseg_torch.cli import train as cli_train
    from ifseg_torch.config import from_flags
    from ifseg_torch.data.segmentation_dataset import SegmentationDataset
    from ifseg_torch.ops import flash_attention as fa
    from ifseg_torch.ops import layer_norm as ln
    from ifseg_torch.tasks.segmentation import SegmentationTask
    from ifseg_torch.train.trainer import Trainer

    result = {}
    train_tsv = f"{tmp}/train.tsv"
    with open(valid_tsv) as src, open(train_tsv, "w") as dst:
        rows = src.readlines()
        dst.writelines((rows * -(-CLI_ROWS // len(rows)))[:CLI_ROWS])

    def flags(save_dir, *extra, resets=True):
        argv = common_sh_argv(f"{train_tsv},{valid_tsv}", save_dir, ckpt_file)
        argv = [a for a in argv if resets or a not in RESET_FLAGS]
        return from_flags(argv + [f"--epoch-row-count={CLI_ROWS}", "--batch-size-valid=8",
                                  *extra])

    # instruments: the trainer and batch of the last step (for the profiler);
    # every restore held against the files it read; rows decoded, by split
    last, restored, decoded = {}, [], {}
    step, restore, decode_row = (Trainer.train_step, cli_train.restore_training_state,
                                 SegmentationDataset._decode_row)

    def recording_step(self, batch):
        last.update(trainer=self, batch=batch)
        return step(self, batch)

    def checked_restore(cfg, trainer, ckpt):
        name = ckpt.latest()
        t0 = time.perf_counter()
        out = restore(cfg, trainer, ckpt)
        if trainer.device.type == "cuda":
            torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        if name is not None:
            saved, now = ckpt.load(name), trainer.state_dict()
            same = all(torch.equal(now["model"][k], v) for k, v in saved["model"].items())
            if "optimizer" in saved and not cfg.checkpoint.reset_optimizer:
                same &= now["step"] == saved["step"] == saved["optimizer"]["count"]
                same &= all(torch.equal(now["optimizer"][m][k], v)
                            for m in ("mu", "nu") for k, v in saved["optimizer"][m].items())
                same &= torch.equal(now["generator"], saved["generator"])
            restored.append(dict(name=name, equal=bool(same), epoch=out[0], cursor=out[1],
                                 restore_s=restore_s))
        return out

    def counting_decode(self, index):
        decoded[self.split] = decoded.get(self.split, 0) + 1
        return decode_row(self, index)

    Trainer.train_step, cli_train.restore_training_state = recording_step, checked_restore
    SegmentationDataset._decode_row = counting_decode
    try:
        # ---- the counted run: 2 epochs, the recipe's flags, 8 row threads
        save = f"{tmp}/ckpt"
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launches()
        ln.reset_launches()
        t0 = time.perf_counter()
        run = cli_train.main(flags(save, "--max-epoch=2", f"--num-workers={CLI_WORKERS}"))
        torch.cuda.synchronize()
        main_s = time.perf_counter() - t0
        counts, ln_launches, routes = fa.launch_counts(), ln.LAUNCHES, fa.bias_route_counts()
        peak = torch.cuda.max_memory_allocated()
        steps = run["num_updates"]
        busy = device_busy_ms(lambda: last["trainer"].train_step(last["batch"]))
        last.clear()
        gc.collect()
        torch.cuda.empty_cache()

        per_step = sum(n for *_, n in SITES)
        mon_ln = ln_sites_per_pass("per_monitor_forward")
        k1_group, ln_group = sum(n for *_, n in EVAL_SITES), ln_sites_per_pass("per_validate_group")
        validations = sum(e["valid"] is not None for e in run["epochs"])
        want = dict(infer=per_step * steps + k1_group * valid_groups * validations,
                    stats=per_step * steps, bwd_di=per_step * steps, bwd_dq=per_step * steps,
                    bwd_dkv=per_step * steps)
        ln_want = mon_ln * steps + ln_group * valid_groups * validations
        log(f"[12] cli.train.main, 2 epochs of {CLI_ROWS} rows at batch {TRAIN_BATCH} "
            f"({steps} updates, {validations} validations of {VALID_ROWS} rows): attention "
            f"launches {counts} (expected {want}), layer_norm launches {ln_launches} (expected "
            f"{ln_want}), bias routes {routes}, on {card}")
        if steps != 6 or validations != 2 or counts != want or ln_launches != ln_want:
            fail("the training CLI did not launch every kernel at every site of every step "
                 "and validation group")
        if routes != dict(fwd_bias_tma=counts["stats"] + counts["infer"], fwd_bias_threads=0,
                          bwd_bias_copies=0):
            fail(f"the training CLI staged a bias by threads or copied one: {routes}")
        result.update(launches=counts, ln_launches=ln_launches, bias_routes=routes)

        def check_finite(r, tag):
            for e in r["epochs"]:
                # the one epoch that trains nothing: a resume whose cursor sits at
                # the end of its first epoch (cli/train.train_epoch)
                if (e["epoch"] == r["start_epoch"] and "train" not in e
                        and r["resumed_iterations"] >= CLI_ROWS // TRAIN_BATCH):
                    losses = []
                elif "loss" not in e.get("train", {}):
                    fail(f"{tag}: epoch {e['epoch']} recorded no training loss")
                else:
                    losses = [e["train"]["loss"]]
                if e["valid"] is not None:
                    losses += [e["valid"]["loss"], e["valid"]["mIoU"]]
                if not all(np.isfinite(x) for x in losses):
                    fail(f"{tag}: epoch {e['epoch']}: a non-finite loss or metric: {losses}")

        check_finite(run, "the counted run")
        mgr = CheckpointManager(flags(save).checkpoint)
        m = mgr.manifest
        best = max(run["epochs"], key=lambda e: e["valid"]["mIoU"])["epoch"]
        want_dirs = sorted({"checkpoint_2", f"checkpoint_{best}"})
        dirs = sorted(d.name for d in Path(save).iterdir() if d.is_dir() and not d.is_symlink())
        links = {k: Path(save, k).resolve().name for k in ("checkpoint_last", "checkpoint_best")}
        log(f"[12] manifest {json.dumps(m)}; directories {dirs}; links {links}")
        if (m["last"] != "checkpoint_2" or m["best"] != f"checkpoint_{best}" or dirs != want_dirs
                or links != {"checkpoint_last": "checkpoint_2",
                             "checkpoint_best": f"checkpoint_{best}"}):
            fail(f"the manifest or the checkpoints on disk are not the expected "
                 f"{want_dirs} (last checkpoint_2, best checkpoint_{best})")
        ckpt_bytes = sum(f.stat().st_size for f in Path(save, "checkpoint_2").iterdir())
        step_s = [t for e in run["epochs"] for t in e["step_s"]]
        iter_s = [t for e in run["epochs"] for t in e["iter_s"]]
        waits = [w for e in run["epochs"] for w in e["data_wait_s"]]
        firsts = [e["data_wait_s"][0] for e in run["epochs"]]
        rest = [w for e in run["epochs"] for w in e["data_wait_s"][1:]]
        vals = [e["valid"] for e in run["epochs"]]
        result["counted"] = dict(
            main_s=main_s, loop_s_per_step_after_first=float(np.mean(iter_s[1:])), iter_s=iter_s,
            step_s=step_s,
            data_wait_ms_mean=1e3 * float(np.mean(waits)),
            data_wait_ms_first_of_epoch=[1e3 * w for w in firsts],
            data_wait_ms_rest=1e3 * float(np.mean(rest)) if rest else None,
            device_busy_ms_one_step=busy, peak_gib=peak / 2**30,
            valid_img_per_s=[VALID_ROWS / max(v["sec"], 1e-9) for v in vals],
            valid=vals, train=[e["train"] for e in run["epochs"]], saves=run["saves"],
            checkpoint_bytes=ckpt_bytes, manifest=m)
        log(f"[12] loop: {np.mean(iter_s[1:]):.4f} s/step after the first step (wall of each "
            f"iteration, the next batch's fetch and the step: {', '.join(f'{t:.3f}' for t in iter_s)}"
            f"; the steps alone {', '.join(f'{t:.3f}' for t in step_s)}); data_wait "
            f"{1e3 * np.mean(waits):.1f} ms a "
            f"batch (first of each epoch {', '.join(f'{1e3 * w:.0f}' for w in firsts)} ms, the rest "
            f"{result['counted']['data_wait_ms_rest']:.1f} ms) with {CLI_WORKERS} row threads; the "
            f"card busy {busy:.1f} ms in one monitored step (profiler); peak device memory "
            f"{peak / 2**30:.2f} GiB; main {main_s:.1f} s, on {card}")
        for e in run["epochs"]:
            log(f"[12] epoch {e['epoch']}: train {json.dumps(e['train'])}; valid "
                f"{json.dumps(e['valid'])} ({VALID_ROWS / max(e['valid']['sec'], 1e-9):.2f} img/s)")
        log(f"[12] saves {[(s['name'], round(1e3 * s['s'], 1)) for s in run['saves']]} ms; "
            f"checkpoint_2 {ckpt_bytes / 2**30:.3f} GiB on disk, on {card}")

        # ---- host ms a training row, one thread
        task = SegmentationTask.setup_task(flags(save))
        train_ds = task.load_dataset("train")
        result["host_ms_per_row"] = host_train_rows(train_ds, min(HOST_ROWS, len(train_ds)),
                                                    flags(save).optimization.seed)
        h = result["host_ms_per_row"]
        log(f"[12] host, one thread, ms a training row over {HOST_ROWS} rows: decode "
            f"{h['decode']:.2f}, resize {h['resize']:.2f}, crop {h['crop']:.2f}, flip "
            f"{h['flip']:.2f}, colour jitter {h['distort']:.2f}: {h['row']:.2f} a row, "
            f"{h['row'] * TRAIN_BATCH / 1e3:.2f} s a batch of {TRAIN_BATCH}; beside {card}")

        # ---- the producer alone (the iterator with no step to wait on): its
        # time a batch bounds the loop of a long epoch, where the 2-batch
        # buffer no longer hides it as it does in 3-step epochs
        seed, batch = flags(save).optimization.seed, flags(save).optimization.batch_size
        producer = {}
        for workers in (CLI_WORKERS, CLI_WORKERS // 2):
            task.cfg.num_workers = workers
            t0, n = time.perf_counter(), 0
            for epoch in (1, 2):
                itr = task.get_batch_iterator("train", batch, seed, epoch)
                n += sum(1 for _ in itr.next_epoch_itr())
                itr.close()
            producer[workers] = 1e3 * (time.perf_counter() - t0) / n
        result["producer_ms_per_batch"] = producer
        log(f"[12] the batch producer alone, ms a batch of {batch} over 2 epochs: "
            + ", ".join(f"{v:.1f} on {k} row threads" for k, v in producer.items())
            + f" ({h['row'] * batch:.1f} on one, from the rows above); beside {card}")

        # ---- resume: to epoch 3 (6 updates restored), stopped at update 7;
        # then on from the cursor
        restored.clear()
        third = cli_train.main(flags(save, "--max-epoch=3", "--max-update=7",
                                     f"--num-workers={CLI_WORKERS}", resets=False))
        check_finite(third, "the run stopped at update 7")
        mgr = CheckpointManager(flags(save).checkpoint)
        extra = mgr.load_extra("checkpoint_3_7")
        log(f"[12] resume to epoch 3: started at epoch {third['start_epoch']} with "
            f"{third['restored_updates']} updates restored in "
            f"{1e3 * restored[0]['restore_s']:.0f} ms (restored state equal to the files: "
            f"{restored}); stopped: {third['stop']}; manifest "
            f"last {mgr.manifest['last']}, cursor {extra.get('iterator')}")
        if (third["start_epoch"], third["restored_updates"], third["num_updates"]) != (3, 6, 7):
            fail(f"the resume started at epoch {third['start_epoch']} with "
                 f"{third['restored_updates']} updates, ended at {third['num_updates']}")
        if (mgr.manifest["last"] != "checkpoint_3_7" or Path(save, "checkpoint_3").exists()
                or extra.get("iterator") != {"epoch": 3, "iterations_in_epoch": 1,
                                             "seed": flags(save).optimization.seed}):
            fail("the stop at update 7 did not save the mid-epoch cursor (and only it)")
        cursor_restore = list(restored)
        restored.clear()
        fourth = cli_train.main(flags(save, "--max-epoch=3", f"--num-workers={CLI_WORKERS}",
                                      resets=False))
        check_finite(fourth, "the run resumed from the cursor")
        mgr = CheckpointManager(flags(save).checkpoint)
        log(f"[12] resume from the cursor: epoch {fourth['start_epoch']}, "
            f"{fourth['resumed_iterations']} of 3 batches done, {fourth['restored_updates']} "
            f"updates restored in {1e3 * restored[0]['restore_s']:.0f} ms ({restored}); "
            f"{fourth['num_updates']} updates at the end; manifest last {mgr.manifest['last']}")
        if ((fourth["start_epoch"], fourth["resumed_iterations"], fourth["restored_updates"],
             fourth["num_updates"]) != (3, 1, 7, 9) or mgr.manifest["last"] != "checkpoint_3"
                or len(fourth["epochs"][0]["step_s"]) != 2):
            fail("the resume from the cursor did not go on inside epoch 3")
        restores = cursor_restore + restored
        if [r["name"] for r in restores] != ["checkpoint_2", "checkpoint_3_7"] or not all(
                r["equal"] for r in restores):
            fail(f"a restored state differs from the checkpoint it was read from: {restores}")
        result["resume"] = dict(to_epoch_3=dict(stop=third["stop"], saves=third["saves"]),
                                from_cursor=dict(saves=fourth["saves"]),
                                restores=[dict(name=r["name"], equal=r["equal"],
                                               restore_s=r["restore_s"]) for r in restores])

        # ---- the image-free fast path: no row decoded for training
        decoded.clear()
        fast = cli_train.main(flags(f"{tmp}/fast", "--max-epoch=1", "--monitor-real-batch=false",
                                    "--validate-interval=2", "--no-save",
                                    f"--num-workers={CLI_WORKERS}"))
        check_finite(fast, "the fast path")
        fast_steps = fast["epochs"][0]["step_s"]
        log(f"[12] fast path (--monitor-real-batch=false): rows decoded {decoded}; "
            f"{np.mean(fast['epochs'][0]['iter_s'][1:]):.4f} s/step after the first (loop wall; "
            f"the steps alone {', '.join(f'{t:.3f}' for t in fast_steps)}), data_wait "
            f"{1e3 * np.mean(fast['epochs'][0]['data_wait_s']):.1f} ms a batch, on {card}")
        if decoded.get("train", 0) != 0 or fast["num_updates"] != 3:
            fail(f"the fast path decoded training rows: {decoded}")

        # ---- the counted run's first 2 batches on one thread (--num-workers=0;
        # 2 of the epoch's 3, which leaves room for phase 19)
        serial = cli_train.main(flags(f"{tmp}/serial", "--max-epoch=1", "--validate-interval=2",
                                      "--no-save", "--num-workers=0",
                                      f"--epoch-row-count={2 * TRAIN_BATCH}"))
        check_finite(serial, "the run on one thread")
        serial_steps = serial["epochs"][0]["step_s"]
        log(f"[12] --num-workers=0: {np.mean(serial['epochs'][0]['iter_s'][1:]):.4f} s/step "
            f"after the first (loop wall; the steps alone "
            f"{', '.join(f'{t:.3f}' for t in serial_steps)}), data_wait "
            f"{1e3 * np.mean(serial['epochs'][0]['data_wait_s']):.1f} ms a batch (against "
            f"{1e3 * np.mean(run['epochs'][0]['data_wait_s']):.1f} with {CLI_WORKERS} threads in "
            f"the counted run's first epoch), on {card}")
        result["fast_path"] = dict(step_s=fast_steps, iter_s=fast["epochs"][0]["iter_s"],
                                   data_wait_s=fast["epochs"][0]["data_wait_s"],
                                   decoded=dict(decoded))
        result["one_thread"] = dict(step_s=serial_steps, iter_s=serial["epochs"][0]["iter_s"],
                                    data_wait_s=serial["epochs"][0]["data_wait_s"])
    finally:
        Trainer.train_step, cli_train.restore_training_state = step, restore
        SegmentationDataset._decode_row = decode_row
    return result


# ---------------------------------------------------------------- phase 13: the serving surface

# the originals of the daemon's requests: the range of phase 11's rows,
# 480 x 640 to 1,024 x 1,366, landscape and portrait
DAEMON_SHAPES = [(480, 640), (640, 480), (600, 800), (512, 683), (768, 1024), (1024, 768),
                 (900, 1200), (1024, 1366)]
DAEMON_IMAGES = 16  # distinct PNG files, each sent DAEMON_REQUESTS / DAEMON_IMAGES times a run
DAEMON_REQUESTS = 32  # a run: each PNG file twice (13); 16 files and their PNG twins once (14c)
DAEMON_CLIENTS = 8
DAEMON_MAX_BATCH = 8
INT8_BATCHES = (8, 32)
# int8 against bf16 on the same weights: random weights leave a cell's logits
# nearly tied (the card's bf16 forward agrees with fp32 on 0.98 of the cells,
# phase 5), so int8's rounding of every large weight flips some of them; the
# JAX package's own test holds int8 serving to 0.9 of the cells and a mean
# logit error under a tenth of the logits' spread on random tiny weights
# (tests/test_quantization.py), and so does this
INT8_AGREEMENT = 0.9
INT8_LOGIT_ERR = 0.1
# cli.infer: (original (h, w), categories) of its two images
INFER_CASES = [((512, 683), "ade"), ((1024, 1366), "cat, dog")]
INFER_GRID = (32, 43)  # both keep-ratio resize to 512 x 683: ceil(512 / 16) x ceil(683 / 16) cells
CRF_ITERS = 10
CRF_CROP = (96, 128)  # the crop of the first image on which the card's device CRF meets the CPU's
# the device CRF on the card against the same function on the CPU: the splat's
# index_add_ sums by atomics in another order, and the fp32 differences of the
# last bits pass through 10 softmax iterations; probabilities within 1e-4
CRF_CARD_CPU_TOL = 1e-4


def ade_category_list() -> str:
    import re

    text = (REPO / "run_scripts" / "IFSeg" / "ade.sh").read_text()
    return re.search(r"export category_list='([^']*)'", text).group(1)


def prompt_len(cats: str) -> int:
    """Tokens of the source that the CLIs build for the categories ``cats``."""
    from ifseg_torch.config import Config
    from ifseg_torch.data.segmentation_dataset import prompt_tokens

    names = [c.strip() for c in cats.split(",") if c.strip()]
    return prompt_tokens(str(REPO / "assets" / "BPE"), names, Config().task.prompt_prefix).shape[1]


def infer_prompts():
    """(categories, prompt tokens) of each of cli.infer's cases."""
    cats = [ade_category_list() if c == "ade" else c for _, c in INFER_CASES]
    return [(c, prompt_len(c)) for c in cats]


def surface_sites():
    """The attention sites of phase 13's paths: the daemon's batch of
    DAEMON_MAX_BATCH at 512 x 512 with the 215-token ADE prompt, and
    cli.infer's batch-1 forward over the INFER_GRID cells with each case's
    prompt; (name, B, Lq, Lk, causal, key mask passed)."""
    cells, t = 32 * 32, VALID_SRC_LEN
    sites = [("daemon encoder self", DAEMON_MAX_BATCH, cells + t, cells + t, False, True),
             ("daemon decoder self", DAEMON_MAX_BATCH, 1 + cells, 1 + cells, True, False),
             ("daemon decoder cross", DAEMON_MAX_BATCH, 1 + cells, cells + t, False, True)]
    cells = INFER_GRID[0] * INFER_GRID[1]
    sites.append(("infer decoder self", 1, 1 + cells, 1 + cells, True, False))
    for _, t in infer_prompts():
        sites += [(f"infer encoder self, {t} tokens", 1, cells + t, cells + t, False, True),
                  (f"infer decoder cross, {t} tokens", 1, 1 + cells, cells + t, False, True)]
    # phase 14's cli.infer over assets/cat_dog.jpeg
    cells, t = CAT_DOG_GRID[0] * CAT_DOG_GRID[1], prompt_len(CAT_DOG_CATEGORIES)
    sites += [("infer cat_dog decoder self", 1, 1 + cells, 1 + cells, True, False),
              (f"infer cat_dog encoder self, {t} tokens", 1, cells + t, cells + t, False, True),
              (f"infer cat_dog decoder cross, {t} tokens", 1, 1 + cells, cells + t, False, True)]
    return sites


def surface_ln_paths():
    """The LayerNorm sites of phase 13's paths, as ``surface_sites``: the
    daemon's served forward (biases precomputed) and cli.infer's full forward
    (the position LayerNorms in it), (path, sites)."""
    cells = INFER_GRID[0] * INFER_GRID[1]
    cat_dog = ("infer cat_dog", ln_sites(1, CAT_DOG_GRID[0] * CAT_DOG_GRID[1], True,
                                         src_len=prompt_len(CAT_DOG_CATEGORIES)))
    return [("daemon", ln_sites(DAEMON_MAX_BATCH, 32 * 32, False, src_len=VALID_SRC_LEN))] + [
        (f"infer, {t} tokens", ln_sites(1, cells, True, src_len=t)) for _, t in infer_prompts()
    ] + [cat_dog]


def smooth_image(h: int, w: int, seed: int):
    """(h, w, 3) uint8: flat blocks of 32 pixels plus noise of 0..3, a
    photograph's flat regions and grain (noise as wide as phase 11's rows
    splits the bilateral lattice of the host CRF into one vertex a pixel)."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 252, size=(h // 32 + 1, w // 32 + 1, 3))
    img = np.repeat(np.repeat(base, 32, 0), 32, 1)[:h, :w] + rng.integers(0, 4, size=(h, w, 3))
    return img.astype(np.uint8)


def http_post(url: str, body: bytes):
    """(status, content type, body, seconds) of one POST."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, data=body, method="POST")
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            status, ctype, out = r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        status, ctype, out = e.code, e.headers.get("Content-Type"), e.read()
    return status, ctype, out, time.perf_counter() - t0


def resident_bytes(model, modules=None):
    """Bytes of the distinct tensors ``model`` (or only ``modules`` of it)
    holds on its device: parameters, buffers and the ResNet's folded
    convolutions."""
    seen, total = set(), 0
    for m in (modules if modules is not None else model.modules()):
        tensors = list(m.parameters(recurse=False)) + list(m.buffers(recurse=False))
        tensors += list(getattr(m, "folded", None) or ())
        for t in tensors:
            if t.data_ptr() not in seen:
                seen.add(t.data_ptr())
                total += t.numel() * t.element_size()
    return total


def drive_daemon(base: str, bodies, clients: int, json_every: int = 2):
    """DAEMON_REQUESTS requests from ``clients`` threads, request i sending
    ``bodies[i % len(bodies)]``; the second half of every ``json_every``
    requests asks for JSON: (answers [(request, status, type, body)], wall
    s, latencies)."""
    from concurrent.futures import ThreadPoolExecutor

    def one(i):
        fmt = "json" if i % json_every >= json_every // 2 else "png"
        status, ctype, out, dt = http_post(f"{base}/segment?format={fmt}", bodies[i % len(bodies)])
        return (i, status, ctype, out), dt

    t0 = time.perf_counter()
    with ThreadPoolExecutor(clients) as pool:
        done = list(pool.map(one, range(DAEMON_REQUESTS)))
    wall = time.perf_counter() - t0
    return [a for a, _ in done], wall, [dt for _, dt in done]


# a malformed GIF file (its graphic control extension is cut short): PIL
# refuses it, and so does the daemon, with 400
GIF_BODY = b"GIF89a\x01\x00\x01\x00\x80\x00\x00\x00\x00\x00\xff\xff\xff!\xf9\x04\x01;"


def recording_forward(svc, batches):
    """Wrap ``svc.forward`` so that every batch's (images, class ids) is
    appended to ``batches``; returns the plain forward to put back."""
    plain = svc.forward

    def recording(images):
        out = plain(images)
        batches.append((images.copy(), out.copy()))
        return out

    svc.forward = recording
    return plain


def batch_rows(svc, batches):
    """Every recorded batch again through ``forward_served`` (it must answer
    the same), then {a row's net input bytes: the class-id rows it got}."""
    from ifseg_torch.eval.serving import forward_served

    hw, server, grid_of = svc.grid * svc.grid, svc.server, {}
    with torch.inference_mode():
        for imgs, out in batches:
            logits = forward_served(server.model, server.pre, svc.src,
                                    torch.from_numpy(imgs).to(server.device), svc._bos)
            again = logits[:, :hw].float().argmax(-1).cpu().numpy()
            if not np.array_equal(again, out):
                fail("a batch's answer differs from forward_served on the same padded batch")
            for row, img in zip(out, imgs):
                grid_of.setdefault(img.tobytes(), set()).add(row.tobytes())
    return grid_of


def check_answer(svc, grid_of, net_orig, what: str, status, ctype, out, as_json: bool):
    """An answer must be the class ids (a mask PNG at the input's size, or
    JSON areas) of a batch row that held the request's net input; returns
    the decoded mask or the areas."""
    from ifseg_torch.data.png import decode_png
    from ifseg_torch.data.transforms import pil_resize

    net, (h0, w0) = net_orig
    rows = [np.frombuffer(r, np.int64).reshape(svc.grid, svc.grid)
            for r in grid_of.get(net.tobytes(), ())]
    if status != 200 or not rows:
        fail(f"{what}: status {status}, no batch held its image: {out[:200]!r}")
    names = svc.categories
    if as_json:
        got = json.loads(out)["areas"]
        ok = sum(got.values()) == svc.grid * svc.grid and any(
            got == {names[c]: int((g == c).sum()) for c in np.unique(g)} for g in rows)
    else:
        got = decode_png(out)
        ok = ctype == "image/png" and got.shape == (h0, w0) and any(
            np.array_equal(got, pil_resize(g.astype(np.uint8), (h0, w0), nearest=True))
            for g in rows)
    if not ok:
        fail(f"{what}: the answer is not the class ids of a batch that held its image")
    return got


def phase_daemon(card: str, ckpt: str):
    """``cli.serve`` on the card at OFA-Base full width and depth, 150 ADE
    classes (a 215-token prompt), phase 11's fabricated checkpoint, batches of
    DAEMON_MAX_BATCH, over HTTP from 1 and DAEMON_CLIENTS clients."""
    import threading
    from http.server import ThreadingHTTPServer

    from ifseg_torch.cli import serve as cli_serve
    from ifseg_torch.data.png import decode_png_rgb
    from ifseg_torch.data.transforms import pil_resize
    from ifseg_torch.ops import flash_attention as fa
    from ifseg_torch.ops import layer_norm as ln

    cats = ade_category_list()
    t0 = time.perf_counter()
    args, svc = cli_serve.build_service(
        [f"--checkpoint={ckpt}", f"--category-list={cats}", "--arch=segofa_base",
         "--patch-image-size=512", f"--max-batch={DAEMON_MAX_BATCH}", "--batch-timeout-ms=5",
         f"--bpe-dir={REPO / 'assets' / 'BPE'}"])
    svc.warmup()
    setup_s = time.perf_counter() - t0
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), cli_serve._make_handler(svc))
    server_thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    server_thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    result = dict(setup_s=setup_s, prompt_tokens=int(svc.src.shape[1]))
    try:
        bodies = [png_bytes(smooth_image(*DAEMON_SHAPES[i % len(DAEMON_SHAPES)], SEED + i), 2)
                  for i in range(DAEMON_IMAGES)]
        log(f"[13] cli.serve: OFA-Base 512px, {len(svc.categories)} ADE classes, a "
            f"{result['prompt_tokens']}-token prompt, batches of {DAEMON_MAX_BATCH}, "
            f"--batch-timeout-ms=5; set-up + warm-up {setup_s:.1f} s; {DAEMON_IMAGES} PNG "
            f"originals of {DAEMON_SHAPES[0]} to {DAEMON_SHAPES[-1]} "
            f"({sum(map(len, bodies)) / DAEMON_IMAGES / 2**20:.2f} MiB each on average), on {card}")

        status, _, out, _ = http_post(f"{base}/segment", GIF_BODY)
        if status != 400:
            fail(f"a malformed GIF body got {status}, not 400: {out[:200]!r}")

        batches = []
        plain_forward = recording_forward(svc, batches)
        fa.reset_launches()
        ln.reset_launches()
        before = dict(svc.stats)
        runs = {}
        for clients in (1, DAEMON_CLIENTS):
            answers, wall, lat = drive_daemon(base, bodies, clients)
            done = dict(svc.stats)
            n_batches = done["batches"] - before["batches"]
            runs[clients] = dict(
                answers=answers, requests_per_s=DAEMON_REQUESTS / wall, wall_s=wall,
                p50_ms=float(np.percentile(lat, 50) * 1e3),
                p99_ms=float(np.percentile(lat, 99) * 1e3),
                batches=n_batches, mean_batch=(done["requests"] - before["requests"]) / n_batches)
            before = done
        counts, ln_launches = fa.launch_counts(), ln.LAUNCHES
        svc.forward = plain_forward
        n_batches = sum(r["batches"] for r in runs.values())
        ln_per = ln_launches_per_forward(svc.server.model, position_lns=False)
        k1_per = sum(n for *_, n in SITES)
        log(f"[13] attention launches {counts['infer']}, layer_norm launches {ln_launches} over "
            f"{n_batches} batches ({counts['infer'] / n_batches:.1f} and "
            f"{ln_launches / n_batches:.1f} a batch; expected {k1_per} and {ln_per})")
        if counts["infer"] != k1_per * n_batches or ln_launches != ln_per * n_batches:
            fail("the daemon's batches did not launch K1 and K4 at every site")
        result["launches"], result["ln_launches"] = counts["infer"], ln_launches

        # every recorded batch again through forward_served, and every answer
        # against its row of the batch that held its image
        hw = svc.grid * svc.grid
        server = svc.server
        grid_of = batch_rows(svc, batches)
        host = dict(decode_ms=[], resize_ms=[], preprocess_ms=[])
        nets = []
        for body in bodies:
            t1 = time.perf_counter()
            rgb = decode_png_rgb(body)
            t2 = time.perf_counter()
            pil_resize(rgb, (svc.size, svc.size))
            t3 = time.perf_counter()
            nets.append(svc._preprocess(body))
            t4 = time.perf_counter()
            host["decode_ms"].append((t2 - t1) * 1e3)
            host["resize_ms"].append((t3 - t2) * 1e3)
            host["preprocess_ms"].append((t4 - t3) * 1e3)
        for clients, run in runs.items():
            for i, status, ctype, out in run["answers"]:
                check_answer(svc, grid_of, nets[i % len(nets)], f"request {i} ({clients} clients)",
                             status, ctype, out, as_json=bool(i % 2))
        result["images_answered_two_ways"] = sum(len(r) > 1 for r in grid_of.values())

        imgs = torch.zeros(DAEMON_MAX_BATCH, svc.size, svc.size, 3, device=server.device)
        card_ms = cuda_ms(lambda: server(svc.src, imgs, svc._bos), iters=10)
        host_ms = float(np.mean(host["preprocess_ms"]))
        for clients, run in runs.items():
            log(f"[13] {clients} client(s), {DAEMON_REQUESTS} requests: "
                f"{run['requests_per_s']:.2f} requests/s, latency p50 {run['p50_ms']:.1f} ms, "
                f"p99 {run['p99_ms']:.1f} ms, {run['batches']} batches, mean batch size {run['mean_batch']:.2f}, on {card}")
        log(f"[13] per request: host {host_ms:.2f} ms (PNG decode "
            f"{np.mean(host['decode_ms']):.2f} + PIL bilinear resize "
            f"{np.mean(host['resize_ms']):.2f}, one thread) against the card's {card_ms:.2f} ms "
            f"for a batch of {DAEMON_MAX_BATCH} ({card_ms / DAEMON_MAX_BATCH:.2f} a request at "
            f"full batches; {card_ms / runs[DAEMON_CLIENTS]['mean_batch']:.2f} at the concurrent "
            f"run's mean batch); every answer equals forward_served on its padded batch; "
            f"GIF -> 400; on {card}")
        for run in runs.values():
            del run["answers"]
        result.update(runs={str(c): r for c, r in runs.items()}, host_ms_per_request=host_ms,
                      host_decode_ms=float(np.mean(host["decode_ms"])),
                      host_resize_ms=float(np.mean(host["resize_ms"])),
                      card_ms_per_batch=card_ms, stats=dict(svc.stats))
        return result, svc
    finally:
        httpd.shutdown()
        httpd.server_close()
        server_thread.join(30)


def phase_int8(card: str, ckpt: str, svc):
    """``SegServer(quantize="int8")`` on the weights of the daemon's bf16
    server, beside it, at INT8_BATCHES, with the daemon's prompt."""
    from ifseg_torch.checkpoint.convert import load_model
    from ifseg_torch.eval.serving import SegServer
    from ifseg_torch.ops.quantization import Int8Linear

    bf16 = svc.server
    t0 = time.perf_counter()
    q8 = SegServer(load_model(ckpt, svc.cfg.model), src_len=svc.src.shape[1], quantize="int8")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    report = q8.quant_report
    if (report["quantized"], report["kept"]) != (208, 636):
        fail(f"int8 report {report}, the JAX package's is 208 quantized, 636 kept")
    weights = {name: dict(all=resident_bytes(s.model), linears=resident_bytes(
        s.model, s.model.serving_linears() + [m for m in s.model.modules()
                                              if isinstance(m, Int8Linear)]))
               for name, s in (("bf16", bf16), ("int8", q8))}
    result = dict(report=report, setup_s=setup_s, resident_bytes=weights, batches={})
    log(f"[13] int8 SegServer: {report['quantized']} tensors quantized, {report['kept']} kept "
        f"({report['bytes_fp32'] / 1e6:.1f} MB fp32 -> {report['bytes_quant'] / 1e6:.1f} MB); "
        f"set-up {setup_s:.1f} s; resident weights {weights['int8']['all'] / 2**20:.1f} MiB "
        f"(the served linears {weights['int8']['linears'] / 2**20:.1f}) against bf16's "
        f"{weights['bf16']['all'] / 2**20:.1f} ({weights['bf16']['linears'] / 2**20:.1f}), "
        f"on {card}")
    for b in INT8_BATCHES:
        _, img, _ = requests(b, seed=400 + b)
        img = img.to(bf16.device)
        src = svc.src[:1].expand(b, -1).contiguous()
        bos = torch.zeros(b, 1, dtype=torch.long, device=bf16.device)
        want, got = bf16(src, img, bos).float(), q8(src, img, bos).float()
        agree = (want.argmax(-1) == got.argmax(-1)).float().mean().item()
        rel = ((got - want).norm() / want.norm()).item()
        err_spread = ((got - want).abs().mean() / want.std()).item()
        ms = {name: cuda_ms(lambda s=s: s(src, img, bos), iters=5) for name, s in
              (("bf16", bf16), ("int8", q8))}
        log(f"[13] int8 batch {b}: {ms['int8']:.2f} ms/forward against bf16's {ms['bf16']:.2f}; "
            f"argmax agreement {agree:.4f}, logit error {rel:.3e} relative, mean |Δ| "
            f"{err_spread:.4f} of the spread, on {card}")
        if not agree >= INT8_AGREEMENT or not err_spread < INT8_LOGIT_ERR:
            fail(f"int8 serving at batch {b}: agreement {agree} < {INT8_AGREEMENT} or logit "
                 f"error {err_spread} >= {INT8_LOGIT_ERR} of the spread")
        result["batches"][str(b)] = dict(ms_int8=ms["int8"], ms_bf16=ms["bf16"], agreement=agree,
                                         rel_err=rel, err_over_spread=err_spread)
    del q8
    return result


def phase_infer(card: str, tmp: str, ckpt: str):
    """``cli.infer`` on the card over two PNGs, each with the device CRF and
    with the host one, CRF_ITERS iterations, under PyTorch's default TF32
    settings (what a user runs), launch counts set to 0 before the four runs
    and read after; then the first image's probabilities before label
    propagation and before the CRF against the port's fp32 ``cli.infer`` on
    the CPU."""
    from ifseg_torch.cli import infer as cli_infer
    from ifseg_torch.data.png import decode_png_rgb
    from ifseg_torch.models.segofa import SegOFA
    from ifseg_torch.ops import flash_attention as fa
    from ifseg_torch.ops import layer_norm as ln
    from ifseg_torch.ops.crf_device import dense_crf_device

    with torch.device("meta"):
        ln_per = ln_launches_per_forward(SegOFA(base_config("bfloat16")), position_lns=True)
    k1_per = sum(n for *_, n in SITES)
    hooked = dict(dense_crf_device=cli_infer.dense_crf_device,
                  masked_label_propagation=cli_infer.masked_label_propagation,
                  model_config_for_arch=cli_infer.model_config_for_arch)
    seen = {}  # the latest run's inputs of label propagation and of the device CRF

    def crf_hook(image, probs, **kw):
        seen["crf_in"] = (image, probs)
        return hooked["dense_crf_device"](image, probs, **kw)

    def lp_hook(probs, *args):
        seen["cells"] = probs
        return hooked["masked_label_propagation"](probs, *args)

    cli_infer.dense_crf_device, cli_infer.masked_label_propagation = crf_hook, lp_hook
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    # PyTorch's defaults, where phase 1 turned TF32 off everywhere
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = False, True
    runs, result = [], dict(cases=[], tf32=dict(matmul=False, cudnn=True))
    fa.reset_launches()
    ln.reset_launches()
    try:
        for n, ((h, w), cats) in enumerate(INFER_CASES):
            cats = ade_category_list() if cats == "ade" else cats
            image = f"{tmp}/infer_{h}x{w}.png"
            Path(image).write_bytes(png_bytes(smooth_image(h, w, SEED + 100 + n), 2))
            case = dict(image=(h, w), classes=len(cats.split(",")), runs={})
            argv = [f"--image={image}", f"--checkpoint={ckpt}", f"--category-list={cats}",
                    "--arch=segofa_base", f"--bpe-dir={REPO / 'assets' / 'BPE'}",
                    f"--crf-iters={CRF_ITERS}"]
            for backend in ("device", "cpp"):
                out = f"{tmp}/infer_{h}x{w}_{backend}.png"
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                got = cli_infer.main(argv + [f"--output={out}", f"--crf-backend={backend}"])
                wall = time.perf_counter() - t0
                peak = torch.cuda.max_memory_allocated() / 2**30
                for path in (got["output"], got["mask"]):
                    if decode_png_rgb(Path(path).read_bytes()).shape != (h, w, 3):
                        fail(f"cli.infer wrote {path} of another size than {(h, w)}")
                if sum(got["areas"].values()) != h * w:
                    fail(f"cli.infer's areas {got['areas']} do not cover {h} x {w}")
                runs.append(got)
                if n == 0 and backend == "device":
                    card_pre = dict(cells=seen["cells"].float().cpu(),
                                    pixels=seen["crf_in"][1].cpu(), argv=argv)
                case["runs"][backend] = dict(ms=got["ms"], wall_s=wall, peak_gib=peak,
                                             areas=got["areas"])
                log(f"[13] cli.infer {h} x {w}, {case['classes']} classes, --crf-backend="
                    f"{backend}: " + ", ".join(f"{k} {v:.1f}" for k, v in got["ms"].items())
                    + f" ms; {wall:.1f} s of wall time with the checkpoint's load; peak device "
                    f"memory {peak:.2f} GiB; on {card}")
            masks = [decode_png_rgb(Path(case_run).read_bytes()) for case_run in
                     (f"{tmp}/infer_{h}x{w}_device_mask.png", f"{tmp}/infer_{h}x{w}_cpp_mask.png")]
            case["backends_agree"] = float((masks[0] == masks[1]).all(-1).mean())

            # the device CRF alone on the run's own inputs: set-up and iterations
            img_dev, probs_dev = seen["crf_in"]
            times = {}
            for iters in (0, CRF_ITERS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                dense_crf_device(img_dev, probs_dev, n_iter=iters)
                torch.cuda.synchronize()
                times[iters] = (time.perf_counter() - t0) * 1e3
            case["crf_device_ms"] = dict(setup=times[0], total=times[CRF_ITERS],
                                         per_iteration=(times[CRF_ITERS] - times[0]) / CRF_ITERS)
            log(f"[13] device CRF on the card, {h} x {w} x {case['classes']}: lattice + norms "
                f"{times[0]:.1f} ms, {CRF_ITERS} iterations {times[CRF_ITERS]:.1f} ms in all "
                f"({case['crf_device_ms']['per_iteration']:.2f} ms an iteration); host CRF "
                f"{case['runs']['cpp']['ms']['crf']:.1f} ms; the two backends' labels agree on "
                f"{case['backends_agree']:.4f} of the pixels; on {card}")
            if n == 0:
                ch, cw = CRF_CROP
                crop_img = img_dev[:ch, :cw].contiguous()
                crop_probs = probs_dev[:ch, :cw].contiguous()
                on_card = dense_crf_device(crop_img, crop_probs, n_iter=CRF_ITERS).cpu()
                on_cpu = dense_crf_device(crop_img.cpu(), crop_probs.cpu(), n_iter=CRF_ITERS)
                err = (on_card - on_cpu).abs().max().item()
                agree = (on_card.argmax(-1) == on_cpu.argmax(-1)).float().mean().item()
                log(f"[13] device CRF, card against CPU on a {ch} x {cw} x {case['classes']} "
                    f"crop: max |Δ| {err:.3e} (tolerance {CRF_CARD_CPU_TOL}), labels agree on "
                    f"{agree:.4f}")
                if not err <= CRF_CARD_CPU_TOL:
                    fail(f"the device CRF on the card differs from the CPU's by {err}")
                case["crop_card_vs_cpu"] = dict(max_abs_err=err, label_agreement=agree)
            result["cases"].append(case)
        counts, ln_launches = fa.launch_counts(), ln.LAUNCHES
        result["cpu_reference"] = infer_cpu_reference(cli_infer, hooked, seen, card_pre, tmp)
    finally:
        for name, fn in hooked.items():
            setattr(cli_infer, name, fn)
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    log(f"[13] cli.infer: attention launches {counts['infer']}, layer_norm launches "
        f"{ln_launches} over {len(runs)} full forwards (expected {k1_per} and {ln_per} each)")
    if counts["infer"] != k1_per * len(runs) or ln_launches != ln_per * len(runs):
        fail("cli.infer's forwards did not launch K1 and K4 at every site")
    result.update(launches=counts["infer"], ln_launches=ln_launches)
    return result


def infer_cpu_reference(cli_infer, hooked, seen, card_pre, tmp: str):
    """The first image through the port's ``cli.infer`` on the CPU in fp32,
    against the card's bf16 run: the forward's cells before label propagation
    (their log-probabilities, centred over the classes, are the logits up to
    a constant a cell) within LOGIT_REL_TOL relative, as phase 5 holds the
    served logits; the share of cells and of pixels before the CRF whose
    argmax differs within EVAL_PIXEL_SHARE_TOL, as phase 9 holds the
    evaluation path's pixels (random weights leave cells nearly tied)."""
    to_fp32 = hooked["model_config_for_arch"]

    def pre_crf(image, probs, **kw):  # the CRF itself is held on the crop
        seen["crf_in"] = (image, probs)
        return probs

    cli_infer.model_config_for_arch = lambda *a, **kw: to_fp32(*a, **{**kw, "dtype": "float32"})
    cli_infer.dense_crf_device = pre_crf
    t0 = time.perf_counter()
    cli_infer.main(card_pre["argv"] + [f"--output={tmp}/infer_cpu.png", "--crf-backend=device",
                                       "--device=cpu"])
    wall = time.perf_counter() - t0

    def centred_log(p):
        lp = p.double().clamp_min(1e-30).log()
        return lp - lp.mean(-1, keepdim=True)

    want, got = centred_log(seen["cells"]), centred_log(card_pre["cells"])
    rel = ((got - want).norm() / want.norm()).item()
    cells = (seen["cells"].argmax(-1) != card_pre["cells"].argmax(-1)).double().mean().item()
    pixels = (seen["crf_in"][1].argmax(-1) != card_pre["pixels"].argmax(-1)).double().mean().item()
    log(f"[13] cli.infer on the card (bf16) against the CPU (fp32), first image: the forward's "
        f"centred log-probabilities {rel:.3e} relative (tolerance {LOGIT_REL_TOL}), argmax "
        f"differs on {cells:.4f} of the cells and on {pixels:.4f} of the pixels before the CRF "
        f"(tolerance {EVAL_PIXEL_SHARE_TOL}); the CPU run took {wall:.1f} s")
    if not rel <= LOGIT_REL_TOL or not cells <= EVAL_PIXEL_SHARE_TOL \
            or not pixels <= EVAL_PIXEL_SHARE_TOL:
        fail(f"cli.infer on the card differs from the fp32 CPU run: {rel}, {cells}, {pixels}")
    return dict(centred_log_prob_rel_err=rel, cell_argmax_differs=cells,
                pixel_argmax_differs=pixels, cpu_wall_s=wall)


def phase_serving_surface(card: str, tmp: str, ckpt: str, jpeg_files, image_files):
    """Phase 13 and phase 14's image-file paths through the same daemon and CLI."""
    daemon, svc = phase_daemon(card, ckpt)
    try:
        daemon_jpeg = phase_daemon_jpeg(card, svc, jpeg_files, image_files)
        int8 = phase_int8(card, ckpt, svc)
    finally:
        svc.close()
    del svc
    torch.cuda.empty_cache()
    infer = phase_infer(card, tmp, ckpt)
    return dict(daemon=daemon, int8=int8, infer=infer, daemon_jpeg=daemon_jpeg,
                infer_jpeg=phase_infer_jpeg(card, tmp, ckpt),
                infer_formats=phase_infer_formats(card, tmp, ckpt, image_files))


# ---------------------------------------------------------------- phase 14: the files of the JAX CLIs

# phase 14's JPEG originals, written by the port's encoder from smooth_image:
# (h, w, seed, quality, PIL's subsampling, mode); 480 x 640 to 1,024 x 1,366,
# all resized by validation into the (512, 768) bucket of phase 11's groups
JPEG_CASES = [
    (480, 640, 1400, 75, 2, "RGB"), (480, 640, 1401, 95, 0, "RGB"),
    (600, 800, 1402, 75, 1, "RGB"), (600, 800, 1403, 95, 2, "RGB"),
    (512, 683, 1404, 75, 0, "RGB"), (512, 683, 1405, 95, 1, "RGB"),
    (768, 1024, 1406, 75, 2, "RGB"), (768, 1024, 1407, 95, 0, "L"),
    (900, 1200, 1408, 75, 1, "RGB"), (900, 1200, 1409, 95, 2, "RGB"),
    (1024, 1366, 1410, 75, 0, "RGB"), (1024, 1366, 1411, 95, 1, "RGB"),
    (1024, 1366, 1412, 75, 2, "L"), (480, 640, 1413, 95, 1, "RGB"),
    (768, 1024, 1414, 95, 2, "RGB"), (600, 800, 1415, 75, 0, "RGB"),
]
# SHA-256 (first 16 hex digits) of each case's file as PIL writes it, and
# row_digest of the pixels PIL decodes from it; tests/test_torch_jpeg.py
# computes them again with PIL
JPEG_DIGESTS = [
    ("4aa5d8a7ba3f9868", "e26049951b179c73"), ("00912db9cdef1d16", "5c123cdd071d2b12"),
    ("98b666dd5baa7c06", "7a91b94164d16454"), ("e309fea2f2f3a427", "02220cf39125eb5a"),
    ("a45df708ac6b79ee", "a1a291b0242ab876"), ("0646bb3158f6e41c", "3fb9895b4921eb32"),
    ("2ac42ae7b1b0fe8a", "19b1ce1b147f1772"), ("fb7447a70b650193", "39d296458214fb0c"),
    ("1593364115deaecc", "bd7d6034a390c362"), ("c2f055e8065529f3", "1affd7f21de3648b"),
    ("566b6dac8a11724f", "b8bf56824b61e3f1"), ("555e854d3bcd193c", "3360f7abf8569b66"),
    ("7a9a925c2824b62f", "b57bee21f3f6917e"), ("a5fcbe5ca3dc5de8", "6dde157eff5cf125"),
    ("de73c0fa7174dd7a", "af03906f578ce765"), ("cb76ec086505b259", "8f08e336a51bc1ae"),
]
# the same of assets/cat_dog.jpeg (progressive, 4:4:4, 1,440 x 560)
CAT_DOG_DIGESTS = ("9a792137450c59fa", "e0dcaafcda795976")
# row_digest of each converted row's label (the ADE map applied to
# jpeg_label), as the JAX package's convert_dataset writes it and PIL reads
# it back; tests/test_torch_convert_dataset.py computes them again
JPEG_LABEL_DIGESTS = [
    "0c2fc7e21c56f597", "ad561a6db3518c8e", "47301d289042944c", "4a13d76ba839ad1d",
    "a8dd9fe2925d3836", "280b625ef61f57e7", "32bb755ad29477cd", "0936be7ff4397779",
    "51a07b5576e08a02", "cff15aad84890e54", "1702382ade074d29", "db95be2148d576d5",
    "40b17749600a0184", "532365c4d30f9b3c", "bb97b93f0510b9d9", "b9cd2283c228fa9f",
]
CONVERT_WORKERS = 4
CAT_DOG_CATEGORIES = "cat, dog"
CAT_DOG_GRID = (32, 83)  # the keep-ratio resize of 560 x 1,440 is 512 x 1,317


def jpeg_original(spec) -> np.ndarray:
    """The pixels of a JPEG_CASES entry: (h, w, 3) or, for "L", (h, w) uint8."""
    h, w, seed, _, _, mode = spec
    img = smooth_image(h, w, seed)
    return np.ascontiguousarray(img[:, :, 0]) if mode == "L" else img


def jpeg_label(spec) -> np.ndarray:
    """A raw ADE annotation for a JPEG_CASES entry: blocks of 64 pixels of
    values 0..150 (150 maps to 'ignore'), (h, w) uint8."""
    h, w, seed = spec[:3]
    rng = np.random.default_rng(seed + 50)
    lab = rng.integers(0, 151, size=(h // 64 + 1, w // 64 + 1))
    return np.repeat(np.repeat(lab, 64, 0), 64, 1)[:h, :w].astype(np.uint8)


def host_ms(fn, reps: int = 3) -> float:
    """The median of ``reps`` host times of ``fn()``, in ms."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def jpeg_files():
    """The port's JPEG encoder writes JPEG_CASES and its decoder reads them
    back, each file held to the digest of PIL's bytes and its pixels to the
    digest of PIL's; assets/cat_dog.jpeg's pixels too.  Returns [(spec,
    JPEG bytes, decoded pixels)]."""
    import hashlib

    from ifseg_torch.data.jpeg import decode_jpeg, encode_jpeg

    files = []
    for spec, (file_sha, pixels_sha) in zip(JPEG_CASES, JPEG_DIGESTS):
        data = encode_jpeg(jpeg_original(spec), spec[3], spec[4])
        if hashlib.sha256(data).hexdigest()[:16] != file_sha:
            fail(f"encode_jpeg of {spec} is not the file PIL writes ({file_sha})")
        pixels = decode_jpeg(data)
        if row_digest(pixels) != pixels_sha:
            fail(f"decode_jpeg of {spec} is not the pixels PIL decodes ({pixels_sha})")
        files.append((spec, data, pixels))
    cat_dog = (REPO / "assets" / "cat_dog.jpeg").read_bytes()
    got = (hashlib.sha256(cat_dog).hexdigest()[:16], row_digest(decode_jpeg(cat_dog)))
    if got != CAT_DOG_DIGESTS:
        fail(f"assets/cat_dog.jpeg: digests {got}, PIL's are {CAT_DOG_DIGESTS}")
    return files


def phase_codecs(card: str):
    """(a): ``jpeg_files``, then host ms a file for encode and decode at each
    size, beside the PNG decode of the same pixels, one thread.  Returns the
    timings and the files."""
    from ifseg_torch.data import jpeg, png

    t0 = time.perf_counter()
    jpeg.load()
    build_s = time.perf_counter() - t0
    files = jpeg_files()
    by_size = {}
    for spec, data, pixels in files:
        h, w, _, q, sub, _ = spec
        arr = jpeg_original(spec)
        as_png = png.encode_png(pixels)
        by_size.setdefault(f"{h}x{w}", []).append(dict(
            encode_ms=host_ms(lambda: jpeg.encode_jpeg(arr, q, sub)),
            decode_ms=host_ms(lambda: jpeg.decode_jpeg(data)),
            png_decode_ms=host_ms(lambda: png.decode_png_rgb(as_png)),
            jpeg_bytes=len(data), png_bytes=len(as_png)))
    sizes = {}
    for size, rows in by_size.items():
        sizes[size] = {k: float(np.mean([r[k] for r in rows])) for k in rows[0]}
        sizes[size]["files"] = len(rows)
        log(f"[14a] {size}, {len(rows)} files: JPEG encode {sizes[size]['encode_ms']:.2f} ms, "
            f"decode {sizes[size]['decode_ms']:.2f} ms a file ({sizes[size]['jpeg_bytes'] / 1e3:.0f} "
            f"kB) against PNG decode {sizes[size]['png_decode_ms']:.2f} ms of the same pixels "
            f"({sizes[size]['png_bytes'] / 1e3:.0f} kB); host, one thread, beside {card}")
    cat_dog = (REPO / "assets" / "cat_dog.jpeg").read_bytes()
    cat_ms = host_ms(lambda: jpeg.decode_jpeg(cat_dog))
    log(f"[14a] {len(files)} JPEG files (4:2:0, 4:2:2, 4:4:4, gray; qualities 75, 95) equal "
        f"PIL's bytes and PIL's pixels; assets/cat_dog.jpeg (progressive) decodes to PIL's "
        f"pixels in {cat_ms:.2f} ms; codecs loaded in {build_s:.2f} s; beside {card}")
    return dict(sizes=sizes, cat_dog_decode_ms=cat_ms), files


IMAGE_FILES = REPO / "tests" / "torch_image_files"
# (e)'s files at the largest size of phase 14's originals
FULL_SIZE = (1024, 1366)
# (e)'s full-size files that phase 14c sends to the daemon, one of each other format
# (WebP lossy and lossless; JPEG 2000 as a JP2 file and as a raw codestream; a
# PackBits PSD and a raw PPM)
DAEMON_FORMAT_FILES = ("gif_1024x1366.gif", "bmp_rle8_1024x1366.bmp", "tiff_lzw_1024x1366.tif",
                       "jpeg_cmyk_1024x1366.jpg", "webp_lossy_1024x1366.webp",
                       "webp_lossless_1024x1366.webp", "jp2_rgb_irreversible_1024x1366.jp2",
                       "j2k_rgb_reversible_1024x1366.j2k", "psd_rgb_rle_1024x1366.psd",
                       "ppm_p6_1024x1366.ppm")
# 14c sends this many of phase 14's JPEG files beside the files above, each
# with its PNG twin: a run stays at DAEMON_REQUESTS requests
DAEMON_JPEG_FILES = DAEMON_REQUESTS // 2 - len(DAEMON_FORMAT_FILES)
# (e)'s files that 14d gives cli.infer, each with the writer of its overlay: a
# CMYK JPEG to a BMP, a lossy WebP with a lossless alpha plane to a TIFF
INFER_FORMAT_RUNS = (("jpeg_cmyk_256x192.jpg", ".bmp"), ("webp_alpha_lossless.webp", ".tif"))
# (e)'s WebP files at FULL_SIZE, timed beside the resize and 14a's JPEG
WEBP_FULL_SIZE = ("webp_lossy_1024x1366.webp", "webp_lossless_1024x1366.webp")
# (e)'s JPEG 2000 files at FULL_SIZE (5/3 and 9/7), timed likewise
JPEG2000_FULL_SIZE = ("jp2_rgb_reversible_1024x1366.jp2", "jp2_rgb_irreversible_1024x1366.jp2")
# 14d's cli.infer run on a JPEG 2000 file, held to the run on its PNG twin
INFER_JPEG2000 = "jp2_rgba_tiles_offsets.jp2"
# (d)'s full-size files of (e) run beside their PNG twins, with what each is
INFER_TWIN_FILES = (("dds_bc7_1024x1366.dds", "DDS BC7 blocks of mode 6"),
                    ("fits_float_1024x1366.fits", "FITS BITPIX -32"))
# (e)'s full-size PSD, Netpbm and ICO files, timed to RGB beside the resize
ICON_PSD_NETPBM_FULL_SIZE = ("psd_rgb_rle_1024x1366.psd", "psd_cmyk_1024x1366.psd",
                             "ppm_p6_1024x1366.ppm", "pgm_16bit_1024x1366.pgm",
                             "ico_png_1024x1366.ico")
# (e)'s full-size TGA, SGI, QOI, PCX, IM and DDS files, timed to RGB beside the resize
RAW_FULL_SIZE = ("tga_rle_1024x1366.tga", "sgi_rle_1024x1366.sgi", "qoi_1024x1366.qoi",
                 "pcx_1024x1366.pcx", "im_rgb_1024x1366.im", "dds_bc1_1024x1366.dds",
                 "dds_bgr_1024x1366.dds")
# (e)'s full-size BC6H and BC7 DDS, BLP2 DXT5 and FITS files, timed to RGB beside the resize
BLOCK_FULL_SIZE = ("dds_bc6h_1024x1366.dds", "dds_bc7_1024x1366.dds", "blp2_dxt5_1024x1366.blp",
                   "fits_float_1024x1366.fits")
# PIL's digests of tests/torch_image_writers.raw_format_files(), of the
# overflow_jpegs() with libjpeg-turbo's SIMD and C IDCTs, and of cv2's resize
# of the PFM row (pfm_resizes()); tools/make_writer_digests.py writes them,
# tests/test_torch_writer_digests.py recomputes them
WRITER_DIGESTS = REPO / "tests" / "torch_writer_digests.json"
# cv2's linear resizes of the PFM row (float32, its grey in three channels),
# up and down
PFM_RESIZES = ((29, 41), (7, 9), (64, 57))


def overflow_jpegs():
    """{name: file}: JPEGs the port's encoder writes at quality 100 with
    every entry of their quantization tables then set to 255 (their DQT
    segments rewritten), so that dequantized coefficients pass 16 bits and
    libjpeg-turbo's SIMD IDCT saturates where its C one wraps (ROADMAP C.15):
    RGB at 4:2:0 and 4:4:4, grey, and a flat grey one."""
    from ifseg_torch.data.jpeg import encode_jpeg

    out = {}
    rgb = smooth_image(48, 64, 2115)
    for name, arr, sub in (("rgb_420", rgb, None), ("rgb_444", rgb, 0),
                           ("grey", rgb[:, :, 1], None), ("flat", np.full((16, 24), 250, np.uint8),
                                                          None)):
        data = bytearray(encode_jpeg(np.ascontiguousarray(arr), 100, sub))
        at = 2
        while data[at:at + 2] != b"\xff\xda":
            size = int.from_bytes(data[at + 2:at + 4], "big")
            if data[at:at + 2] == b"\xff\xdb":
                for table in range(at + 4, at + 2 + size, 65):
                    data[table + 1:table + 65] = b"\xff" * 64
            at += 2 + size
        out[f"jpeg_overflow_{name}.jpg"] = bytes(data)
    return out


def pfm_resizes(data: bytes):
    """{shape: the port's linear resize} of a PFM row as the dataset holds it
    (float32, its grey in three channels) at each of PFM_RESIZES."""
    from ifseg_torch.data.image import decode_image
    from ifseg_torch.data.transforms import resize_image

    grey = decode_image(data)[0]
    bgr = np.repeat(grey[:, :, None], 3, axis=2)
    return {f"{h}x{w}": resize_image(bgr, (h, w)) for h, w in PFM_RESIZES}


def cmyk_to_rgb_plain(cmyk: np.ndarray) -> np.ndarray:
    """Pillow's Convert.c ``cmyk2rgb`` in numpy (nk - nk * c / 255, rounded
    as MULDIV255): the plain version of csrc/png_unfilter.cpp's
    ``cmyk_to_rgb``."""
    nk = 255 - cmyk[:, :, 3:].astype(np.uint16)  # every step below fits 16 bits
    t = cmyk[:, :, :3] * nk + np.uint16(128)
    return (nk - (((t >> 8) + t) >> 8)).astype(np.uint8)


def full_size_files():
    """{name: (file, (pixels, mode, palette) the port must decode or None,
    the RGB it must give or None)} at FULL_SIZE, from smooth_image through
    the numpy writers of tests/torch_image_writers.py (which the tests hold
    to PIL) and the port's own: GIF (LZW), BMP (RLE8, RLE4, 24 bits), TIFF
    (uncompressed; LZW with the predictor at one code a byte, the decoder's
    most; Deflate tiles; CMYK, its RGB from ``cmyk_to_rgb_plain``); a YCCK
    file from the full-size CMYK JPEG fixture; assets/cat_dog.jpeg cut in
    half, which libjpeg-turbo block-smooths (1,440 x 560), timed, not
    checked: their pixels come from PIL only; the raw codestream of the
    full-size reversible JP2 fixture, held to the port's decode of that
    fixture (which (e) holds to PIL's digests first); PSD (RGB in PackBits,
    CMYK raw, written inverted as Photoshop stores it), Netpbm (raw P6, and
    P5 at maxval 65535, PIL's "I") and an ICO of one PNG entry (RGBA, a
    directory size of 256 that the entry's own size overrides); run-length
    TGA and SGI, IM and DDS (BC1 and uncompressed) through
    ``torch_image_writers.full_size_raw_files`` (the image's columns in
    pairs, BC1's blocks of two colours each), QOI and PCX through the port's
    writers (which the tests hold to PIL's ``save``); DDS BC7 and BC6H, BLP2
    DXT5 and FITS (BITPIX -32) through
    ``torch_image_writers.full_size_block_files``, whose pixels are known
    without a decoder."""
    sys.path.insert(0, str(REPO / "tests"))
    import torch_image_writers as W
    from ifseg_torch.data import image
    from ifseg_torch.data.bmp import encode_bmp
    from ifseg_torch.data.pcx import encode_pcx
    from ifseg_torch.data.png import encode_png
    from ifseg_torch.data.qoi import encode_qoi
    from ifseg_torch.data.tiff import encode_tiff

    h, w = FULL_SIZE
    tag = f"{h}x{w}"
    rgb = smooth_image(h, w, 1600)
    idx = (rgb[:, :, 0] >> 5 << 5) | (rgb[:, :, 1] >> 5 << 2) | (rgb[:, :, 2] >> 6)
    v = np.arange(256)
    pal = np.stack([(v >> 5) * 255 // 7, (v >> 2 & 7) * 255 // 7, (v & 3) * 85], 1).astype(np.uint8)
    idx16, pal16 = rgb[:, :, 1] >> 4, pal[::17]
    cmyk = np.dstack([rgb, rgb[:, :, 1]])
    as_rgb = (rgb, "RGB", None), rgb
    cmyk_jpeg = (IMAGE_FILES / f"jpeg_cmyk_{tag}.jpg").read_bytes()
    cat_dog = (REPO / "assets" / "cat_dog.jpeg").read_bytes()
    jp2 = (IMAGE_FILES / f"jp2_rgb_reversible_{tag}.jp2").read_bytes()
    codestream = [p for kind, p in W.jp2_boxes(jp2, 12) if kind == b"jp2c"][0]
    grey16 = rgb[:, :, 0].astype(np.int32) * 257 + rgb[:, :, 1] % 3
    rgba = np.dstack([rgb, rgb[:, :, 2]])
    raw = {name: (data, (px, mode, None), want_rgb) for name, (data, (px, mode), want_rgb)
           in W.full_size_raw_files(np.repeat(rgb[:, ::2], 2, axis=1)).items()}
    blocks = {name: (data, (px, mode, None), want_rgb) for name, (data, (px, mode), want_rgb)
              in W.full_size_block_files(rgb).items()}
    return {
        **raw,
        **blocks,
        f"qoi_{tag}.qoi": (encode_qoi(rgb), *as_rgb),
        f"pcx_{tag}.pcx": (encode_pcx(rgb), *as_rgb),
        f"psd_rgb_rle_{tag}.psd": (W.psd_file(np.moveaxis(rgb, 2, 0), 3, compression=1),
                                   *as_rgb),
        f"psd_cmyk_{tag}.psd": (W.psd_file(255 - np.moveaxis(cmyk, 2, 0), 4),
                                (cmyk, "CMYK", None), cmyk_to_rgb_plain(cmyk)),
        f"ppm_p6_{tag}.ppm": (W.netpbm_file(b"P6", rgb), *as_rgb),
        f"pgm_16bit_{tag}.pgm": (W.netpbm_file(b"P5", grey16, maxval=65535),
                                 (grey16, "I", None),
                                 np.repeat(np.minimum(grey16, 255)[:, :, None], 3, 2).astype(np.uint8)),
        f"ico_png_{tag}.ico": (W.ico_file([(encode_png(rgba), dict(width=256, height=256))]),
                               (rgba, "RGBA", None), rgb),
        f"j2k_rgb_reversible_{tag}.j2k": (codestream, image.decode_image(jp2),
                                          image.decode_image_rgb(jp2)),
        f"gif_{tag}.gif": (W.gif_file([dict(indices=idx)], (w, h), global_palette=pal),
                           (idx, "P", pal), pal[idx]),
        f"bmp_rle8_{tag}.bmp": (W.bmp_file(idx, 8, palette=pal, compression=1), (idx, "P", pal),
                                pal[idx]),
        f"bmp_rle4_{tag}.bmp": (W.bmp_file(idx16, 4, palette=pal16, compression=2),
                                (idx16, "P", pal16), pal16[idx16]),
        f"bmp_24bit_{tag}.bmp": (encode_bmp(rgb), *as_rgb),
        f"tiff_{tag}.tif": (encode_tiff(rgb), *as_rgb),
        f"tiff_lzw_{tag}.tif": (W.tiff_file(rgb, 8, 2, compression=5, predictor=2,
                                            rows_per_strip=64, lzw_literals=True), *as_rgb),
        f"tiff_deflate_tiles_{tag}.tif": (W.tiff_file(rgb, 8, 2, compression=8, predictor=2,
                                                      tile=(256, 256)), *as_rgb),
        f"tiff_cmyk_{tag}.tif": (W.tiff_file(cmyk, 8, 5, rows_per_strip=64), (cmyk, "CMYK", None),
                                 cmyk_to_rgb_plain(cmyk)),
        f"jpeg_ycck_{tag}.jpg": (W.ycck_jpeg(cmyk_jpeg), None, None),
        "jpeg_progressive_cut_560x1440.jpg": (cat_dog[:len(cat_dog) // 2], None, None),
    }


def phase_image_files(card: str, jpeg_sizes):
    """(e): every file of tests/torch_image_files/ decoded by the port on the
    host (``decode_image``, ``decode_image_rgb``), its mode, shape and the
    SHA-256 of its pixels and of its RGB held to the ones PIL gives
    (digests.json, written by tools/make_image_fixtures.py and recomputed
    with PIL by tests/test_torch_image_files.py); then ``full_size_files``,
    each held to the pixels, mode, palette and RGB it was written from; host
    ms a file (median of 3; one thread) by format and size, the full-size
    ones (and the WebP fixtures of that size) beside 14a's RGB JPEG decode at
    that size (``jpeg_sizes``) and the PIL-bilinear resize of such a file to
    OFA-Base's 512 x 512; ``cli.infer``'s Netpbm writer on a full-size
    overlay, read back.  Between the two, the small files of
    ``torch_image_writers.raw_format_files`` held to PIL's digests
    (WRITER_DIGESTS), the ``overflow_jpegs`` to PIL's with the IDCT this
    host selects, and a PFM row's float32 resizes to cv2's.  Returns the
    timings and {name: bytes} of every file."""
    from ifseg_torch.cli import infer as cli_infer
    from ifseg_torch.data import image, jpeg
    from ifseg_torch.data.image import image_digest
    from ifseg_torch.data.transforms import pil_resize

    t0 = time.perf_counter()
    image.load()
    build_s = time.perf_counter() - t0
    table = json.loads((IMAGE_FILES / "digests.json").read_text())
    files, rows = {}, []
    for name in sorted(table):
        data = (IMAGE_FILES / name).read_bytes()
        want = table[name]
        pixels, mode, _ = image.decode_image(data)
        rgb = image.decode_image_rgb(data)
        got = dict(mode=mode, shape=list(pixels.shape), pixels=image_digest(pixels),
                   rgb=image_digest(rgb))
        if got != want:
            fail(f"[14e] {name}: the port decodes {got}, PIL {want}")
        files[name] = data
        rows.append(dict(file=name, format=image.image_format(data), mode=mode,
                         size=f"{pixels.shape[0]}x{pixels.shape[1]}", bytes=len(data),
                         decode_ms=host_ms(lambda: image.decode_image(data)),
                         rgb_ms=host_ms(lambda: image.decode_image_rgb(data))))
    # the small TGA, SGI, QOI, PCX, DCX, IM, DDS (each BC6H and BC7 mode),
    # DIB, FTEX, BLP, ICNS, SUN, MSP, XBM, XPM, GBR, PIXAR, XVThumb, McIdas,
    # IMT, SPIDER and FITS files and the PFM row, written here by numpy, each
    # held to PIL's digests
    sys.path.insert(0, str(REPO / "tests"))
    import torch_image_writers as W

    writer_digests = json.loads(WRITER_DIGESTS.read_text())
    for name, data in sorted(W.raw_format_files().items()):
        want = writer_digests["files"][name]
        pixels, mode, _ = image.decode_image(data)
        got = dict(format=image.image_format(data).replace("Netpbm", "PPM"), mode=mode,
                   shape=list(pixels.shape), pixels=image_digest(pixels),
                   rgb=image_digest(image.decode_image_rgb(data)))
        if got != want:
            fail(f"[14e] {name}: the port decodes {got}, PIL {want}")
        files[name] = data
        rows.append(dict(file=name, format=got["format"], mode=mode,
                         size=f"{pixels.shape[0]}x{pixels.shape[1]}", bytes=len(data),
                         decode_ms=host_ms(lambda: image.decode_image(data)),
                         rgb_ms=host_ms(lambda: image.decode_image_rgb(data))))
    # JPEGs whose dequantized coefficients pass 16 bits: the IDCT this host's
    # libjpeg-turbo would take (ROADMAP C.15)
    variant = jpeg.idct_variant()
    overflow = overflow_jpegs()
    for name, data in overflow.items():
        want = writer_digests["jpeg_overflow"][name]["c" if variant == "c" else "simd"]
        if image_digest(jpeg.decode_jpeg(data)) != want:
            fail(f"[14e] {name}: the port's {variant} IDCT does not give PIL's pixels")
    differ = sum(v["c"] != v["simd"] for v in writer_digests["jpeg_overflow"].values())
    log(f"[14e] {len(overflow)} JPEGs whose coefficients pass 16 bits equal PIL's digests with "
        f"the IDCT this host selects: {variant} (libjpeg-turbo's choice by the CPU's features "
        f"and JSIMD_FORCE*); {differ} of them differ between the SIMD and the C IDCT")
    # a PFM row's float32 resizes (ROADMAP C.16)
    pfm = W.raw_format_files()["pfm_row.pfm"]
    resized = {k: image_digest(v) for k, v in pfm_resizes(pfm).items()}
    if resized != writer_digests["pfm_resize"]:
        fail(f"[14e] the PFM row's float32 resizes are not cv2's: {resized}")
    pfm_ms = host_ms(lambda: pfm_resizes(pfm))
    log(f"[14e] the PFM row's float32 resizes to {', '.join(resized)} equal cv2's digests "
        f"({pfm_ms:.3f} ms for the three); {len(writer_digests['files'])} small TGA, SGI, QOI, "
        f"PCX, DCX, IM, DDS, DIB and PFM files written by numpy equal PIL's digests; host of "
        f"{card}")
    new_formats = sorted({v["format"] for k, v in writer_digests["files"].items()
                          if v["format"] not in ("TGA", "SGI", "QOI", "PCX", "DCX", "IM", "DDS",
                                                 "DIB", "PPM")})
    bc = sorted(k for k in writer_digests["files"] if k.startswith(("dds_bc6h", "dds_bc7")))
    log(f"[14e] of them, {len(bc)} DDS files of every BC6H mode (UF16 and SF16) and BC7 mode, "
        f"and {sum(v['format'] in new_formats for v in writer_digests['files'].values())} "
        f"{', '.join(new_formats)} files equal PIL's digests on the host of {card}")

    t0 = time.perf_counter()
    full = full_size_files()
    write_s = time.perf_counter() - t0
    for name, (data, want, want_rgb) in full.items():
        pixels, mode, palette = image.decode_image(data)
        rgb = image.decode_image_rgb(data)
        if want is not None and not (
                mode == want[1] and np.array_equal(pixels, want[0])
                and (palette is None) == (want[2] is None)
                and (palette is None or np.array_equal(palette, want[2]))
                and np.array_equal(rgb, want_rgb)):
            fail(f"[14e] {name}: the port decodes {mode} {pixels.shape}, not the {want[1]} "
                 f"{want[0].shape} it was written from, or another palette or RGB")
        files[name] = data
        rows.append(dict(file=name, format=image.image_format(data), mode=mode,
                         size=f"{pixels.shape[0]}x{pixels.shape[1]}", bytes=len(data),
                         full_size=True, checked=want is not None,
                         decode_ms=host_ms(lambda: image.decode_image(data)),
                         rgb_ms=host_ms(lambda: image.decode_image_rgb(data))))
    for r in rows:
        log(f"[14e] {r['format']} {r['file']} ({r['mode']}, {r['size']}, {r['bytes']} bytes): "
            f"decode {r['decode_ms']:.3f} ms, to RGB {r['rgb_ms']:.3f} ms a file; host, one thread")
    by_format = {}
    for r in rows:
        by_format.setdefault(r["format"], []).append(r)
    for fmt, rs in by_format.items():
        at_full = [r for r in rs if r.get("full_size")]
        log(f"[14e] {fmt}: {len(rs) - len(at_full)} fixtures equal PIL's mode, shape, pixels "
            f"and RGB; {sum(r['checked'] for r in at_full)} full-size files equal the arrays "
            f"they were written from, {sum(not r['checked'] for r in at_full)} are timed only; "
            f"to RGB {min(r['rgb_ms'] for r in rs):.3f}-{max(r['rgb_ms'] for r in rs):.3f} ms "
            f"a file; beside {card}")
    h, w = FULL_SIZE
    big = np.asarray(full[f"bmp_24bit_{h}x{w}.bmp"][2])
    resize_ms = host_ms(lambda: pil_resize(big, (512, 512)))
    slowest = max((r for r in rows if r.get("full_size")), key=lambda r: r["rgb_ms"])
    jpeg_ms = jpeg_sizes[f"{h}x{w}"]["decode_ms"]
    log(f"[14e] at {h} x {w}: the slowest to RGB {slowest['file']} {slowest['rgb_ms']:.3f} ms, "
        f"beside an RGB JPEG's decode {jpeg_ms:.3f} ms (14a) and the PIL-bilinear resize to "
        f"512 x 512 {resize_ms:.3f} ms; {len(rows)} files in "
        f"{sum(r['bytes'] for r in rows)} bytes; codecs loaded in {build_s:.2f} s; the "
        f"full-size files written in {write_s:.2f} s")
    webp_ms = {r["file"]: r["rgb_ms"] for r in rows if r["file"] in WEBP_FULL_SIZE}
    log(f"[14e] WebP at {h} x {w} to RGB (median of 3, one thread): "
        + ", ".join(f"{n} ({len(files[n])} bytes) {ms:.3f} ms" for n, ms in webp_ms.items())
        + f", beside an RGB JPEG's decode {jpeg_ms:.3f} ms (14a) and the PIL-bilinear resize "
        f"to 512 x 512 {resize_ms:.3f} ms; host of {card}")
    j2k_ms = {r["file"]: r["rgb_ms"] for r in rows if r["file"] in JPEG2000_FULL_SIZE}
    j2k_rows = [r for r in rows if r["format"] == "JPEG 2000"]
    log(f"[14e] JPEG 2000 at {h} x {w} to RGB (median of 3, one thread): "
        + ", ".join(f"{n} ({len(files[n])} bytes) {ms:.3f} ms" for n, ms in j2k_ms.items())
        + f", beside WebP's {', '.join(f'{ms:.3f}' for ms in webp_ms.values())} ms, an RGB "
        f"JPEG's decode {jpeg_ms:.3f} ms (14a) and the PIL-bilinear resize to 512 x 512 "
        f"{resize_ms:.3f} ms; {len(j2k_rows)} JPEG 2000 files equal PIL's digests or their "
        f"JP2 twin; host of {card}")
    if len(j2k_ms) != len(JPEG2000_FULL_SIZE):
        fail(f"[14e] the JPEG 2000 files of {h} x {w} were not all decoded: {sorted(j2k_ms)}")
    new_ms = {r["file"]: r["rgb_ms"] for r in rows if r["file"] in ICON_PSD_NETPBM_FULL_SIZE}
    # cli.infer's Netpbm writer (PIL's P6 whatever the extension) on a
    # full-size overlay, read back by the port's reader
    written = {ext: cli_infer.WRITERS[ext](big) for ext in (".ppm", ".pgm", ".pnm")}
    ppm_ms = host_ms(lambda: cli_infer.WRITERS[".ppm"](big))
    back, mode, _ = image.decode_image(written[".ppm"])
    if (len(set(written.values())) != 1 or not written[".ppm"].startswith(b"P6\n%d %d\n255\n" % (w, h))
            or mode != "RGB" or not np.array_equal(back, big)):
        fail("[14e] cli.infer's Netpbm writer does not write the P6 file of its overlay")
    log(f"[14e] PSD, Netpbm and ICO at {h} x {w} to RGB (median of 3, one thread): "
        + ", ".join(f"{n} ({len(files[n])} bytes) {ms:.3f} ms" for n, ms in new_ms.items())
        + f", beside an RGB JPEG's decode {jpeg_ms:.3f} ms (14a) and the PIL-bilinear resize to "
        f"512 x 512 {resize_ms:.3f} ms; cli.infer's .ppm writer {ppm_ms:.3f} ms for that overlay, "
        f"read back equal to it; host of {card}")
    if len(new_ms) != len(ICON_PSD_NETPBM_FULL_SIZE):
        fail(f"[14e] the PSD, Netpbm and ICO files of {h} x {w} were not all decoded: "
             f"{sorted(new_ms)}")
    raw_ms = {r["file"]: r["rgb_ms"] for r in rows if r["file"] in RAW_FULL_SIZE}
    log(f"[14e] TGA, SGI, QOI, PCX, IM and DDS at {h} x {w} to RGB (median of 3, one thread), "
        f"each equal to the array it was written from: "
        + ", ".join(f"{n} ({len(files[n])} bytes) {ms:.3f} ms" for n, ms in raw_ms.items())
        + f", beside the PIL-bilinear resize to 512 x 512 {resize_ms:.3f} ms; host of {card}")
    if len(raw_ms) != len(RAW_FULL_SIZE):
        fail(f"[14e] the TGA, SGI, QOI, PCX, IM and DDS files of {h} x {w} were not all "
             f"decoded: {sorted(raw_ms)}")
    block_ms = {r["file"]: r["rgb_ms"] for r in rows if r["file"] in BLOCK_FULL_SIZE}
    log(f"[14e] BC6H and BC7 DDS, BLP2 DXT5 and FITS at {h} x {w} to RGB (median of 3, one "
        f"thread), each equal to the array it was written from: "
        + ", ".join(f"{n} ({len(files[n])} bytes) {ms:.3f} ms" for n, ms in block_ms.items())
        + f", beside the PIL-bilinear resize to 512 x 512 {resize_ms:.3f} ms; host of {card}")
    if len(block_ms) != len(BLOCK_FULL_SIZE):
        fail(f"[14e] the BC6H, BC7, BLP2 and FITS files of {h} x {w} were not all decoded: "
             f"{sorted(block_ms)}")
    return dict(files=rows, build_s=build_s, write_s=write_s, resize_ms=resize_ms,
                jpeg_decode_ms=jpeg_ms, webp_full_size_ms=webp_ms,
                jpeg2000_full_size_ms=j2k_ms, icon_psd_netpbm_full_size_ms=new_ms,
                raw_full_size_ms=raw_ms, block_full_size_ms=block_ms, idct=variant,
                pfm_resize_ms=pfm_ms, ppm_write_ms=ppm_ms), files


def phase_convert_validate(card: str, tmp: str, ckpt: str, files):
    """(b): ``python -m ifseg_torch.cli.convert_dataset --mode=ade`` over
    phase 14's JPEG originals and label PNGs made from the seed, each row
    held to the pinned digests; then ``cli.validate.main`` on the card with
    the ADE flags over the TSV it wrote, launch counts set to 0 before and
    read after, and its cheapest group against the fp32 CPU Evaluator."""
    import base64

    from ifseg_torch.cli import convert_dataset
    from ifseg_torch.cli import validate as cli_validate
    from ifseg_torch.config import from_flags
    from ifseg_torch.data.png import decode_png, encode_png
    from ifseg_torch.eval.evaluator import group_key
    from ifseg_torch.ops import flash_attention as fa
    from ifseg_torch.ops import layer_norm as ln
    from ifseg_torch.tasks.segmentation import SegmentationTask

    root = Path(tmp) / "ade_jpeg"
    images, labels, tsv = root / "images", root / "annotations", str(root / "validation.tsv")
    images.mkdir(parents=True)
    labels.mkdir()
    for i, (spec, data, _) in enumerate(files):
        (images / f"ade_{i:03d}.jpg").write_bytes(data)
        (labels / f"ade_{i:03d}.png").write_bytes(encode_png(jpeg_label(spec)))
    # one thread's cost of a row, then the CLI as a user runs it
    mapping = convert_dataset.MAPS["ade"]()
    row_ms = [host_ms(lambda i=i: convert_dataset.convert_row(
        (i + 1, str(labels / f"ade_{i:03d}.png"), str(images), [".jpg"], mapping)), reps=1)
        for i in range(len(files))]
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "ifseg_torch.cli.convert_dataset", "--mode=ade",
                           f"--images={images}", f"--annotations={labels}", f"--output={tsv}",
                           f"--workers={CONVERT_WORKERS}"], cwd=str(REPO), capture_output=True,
                          text=True, timeout=300)
    convert_s = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"cli.convert_dataset failed: {proc.stderr[-2000:]}")
    lines = Path(tsv).read_text().splitlines()
    if len(lines) != len(files):
        fail(f"cli.convert_dataset wrote {len(lines)} rows, not {len(files)}")
    for i, line in enumerate(lines):
        image_b64, label_b64, stem, line_id = line.split("\t")
        got = (row_digest(decode_png(base64.urlsafe_b64decode(image_b64))),
               row_digest(decode_png(base64.urlsafe_b64decode(label_b64))))
        want = (JPEG_DIGESTS[i][1], JPEG_LABEL_DIGESTS[i])
        if (stem, line_id) != (f"ade_{i:03d}", str(i + 1)) or got != want:
            fail(f"converted row {i} ({stem}, {line_id}): digests {got}, pinned {want}")
    result = dict(rows=len(lines), convert_s=convert_s, rows_per_s=len(lines) / convert_s,
                  row_ms_one_thread=float(np.mean(row_ms)), tsv_mib=Path(tsv).stat().st_size / 2**20)
    log(f"[14b] cli.convert_dataset --mode=ade: {len(lines)} rows from JPEG originals in "
        f"{convert_s:.2f} s with {CONVERT_WORKERS} workers ({result['rows_per_s']:.2f} rows/s, the "
        f"interpreter's start included; one thread {result['row_ms_one_thread']:.1f} ms a row: JPEG "
        f"decode, two PNG encodes, base64); {result['tsv_mib']:.1f} MiB; every row's image and "
        f"label equal the pinned digests of what the JAX package's CLI writes; host, beside {card}")

    cfg = from_flags(ade_argv(tsv, ckpt))
    ds = SegmentationTask.setup_task(cfg).load_dataset("valid")
    samples = [ds.get_eval_sample(i) for i in range(len(ds))]
    keys = {}
    for smp in samples:
        keys.setdefault(group_key(smp), []).append(smp)
    groups = [m[j:j + 8] for m in keys.values() for j in range(0, len(m), 8)]
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    fa.reset_launches()
    ln.reset_launches()
    t0 = time.perf_counter()
    main_logs = []
    vals = cli_validate.main(from_flags(ade_argv(tsv, ckpt)), logs_out=main_logs)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts, ln_launches = fa.launch_counts(), ln.LAUNCHES
    k1_per, ln_per = sum(n for *_, n in EVAL_SITES), ln_sites_per_pass("per_validate_group")
    log(f"[14b] validate.main over the converted TSV: {json.dumps(vals)}")
    log(f"[14b] validate.main: {dt:.2f} s, {len(lines) / dt:.2f} img/s of the whole main; attention "
        f"launches {counts['infer']}, layer_norm launches {ln_launches} (expected {k1_per} and "
        f"{ln_per} a group, {len(groups)} groups of {[len(g) for g in groups]}), on {card}")
    if counts != dict(infer=k1_per * len(groups), stats=0, bwd_di=0, bwd_dq=0, bwd_dkv=0) \
            or ln_launches != ln_per * len(groups):
        fail("validate over the converted TSV did not launch K1 and K4 at every site")
    if vals["num_images"] != len(lines) or not np.isfinite(vals["loss"]):
        fail(f"validate over the converted TSV returned {vals}")
    result.update(vals=vals, main_s=dt, img_per_s=len(lines) / dt, launches=counts["infer"],
                  ln_launches=ln_launches)
    result.update(cheapest_group_against_cpu("[14b]", groups, main_logs, tsv, ckpt))
    return result


def phase_daemon_jpeg(card: str, svc, files, image_files):
    """(c): the daemon of phase 13 answers JPEG, GIF, BMP, TIFF, WebP,
    JPEG 2000, PSD and PPM bodies: each run sends (e)'s DAEMON_FORMAT_FILES
    (a GIF, an RLE8 BMP, an LZW TIFF, a CMYK JPEG, a lossy and a lossless
    WebP file, a 9/7 JP2 file, a 5/3 raw codestream, a PackBits PSD and a raw
    PPM of FULL_SIZE)
    and DAEMON_JPEG_FILES of phase
    14's JPEG files, each beside a PNG file of the RGB pixels the port
    decodes from it (every other pair asks for JSON), from 1 and from
    DAEMON_CLIENTS clients; a body's net input equals its
    PNG twin's bit for bit, every answer is the class ids of a batch row
    that held its image, and each answer equals its PNG twin's."""
    import threading
    from http.server import ThreadingHTTPServer

    from ifseg_torch.cli import serve as cli_serve
    from ifseg_torch.data.image import decode_image_rgb
    from ifseg_torch.data.png import encode_png
    from ifseg_torch.data.transforms import pil_resize
    from ifseg_torch.ops import flash_attention as fa
    from ifseg_torch.ops import layer_norm as ln

    bodies, host = [], dict(jpeg_decode_ms=[], png_decode_ms=[], resize_ms=[], jpeg_preprocess_ms=[])
    for name in DAEMON_FORMAT_FILES:  # the other formats first, then the JPEG files
        bodies += [image_files[name], encode_png(decode_image_rgb(image_files[name]))]
    files = files[:DAEMON_JPEG_FILES]
    for _, data, pixels in files:
        twin = encode_png(pixels)
        bodies += [data, twin]
        host["jpeg_decode_ms"].append(host_ms(lambda: decode_image_rgb(data), reps=1))
        host["png_decode_ms"].append(host_ms(lambda: decode_image_rgb(twin), reps=1))
        rgb = decode_image_rgb(data)
        host["resize_ms"].append(host_ms(lambda: pil_resize(rgb, (svc.size, svc.size)), reps=1))
        host["jpeg_preprocess_ms"].append(host_ms(lambda: svc._preprocess(data), reps=1))
    if len(bodies) != DAEMON_REQUESTS:
        fail(f"[14c] {len(bodies)} bodies, not one a request of a run's {DAEMON_REQUESTS}")
    nets = [svc._preprocess(b) for b in bodies]
    for k in range(0, len(nets), 2):
        if nets[k][1] != nets[k + 1][1] or not np.array_equal(nets[k][0], nets[k + 1][0]):
            fail(f"body {k // 2}: the daemon's net input differs from its PNG twin's")
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), cli_serve._make_handler(svc))
    server_thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    server_thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    batches, runs = [], {}
    plain_forward = recording_forward(svc, batches)
    try:
        fa.reset_launches()
        ln.reset_launches()
        before = dict(svc.stats)
        for clients in (1, DAEMON_CLIENTS):
            answers, wall, lat = drive_daemon(base, bodies, clients, json_every=4)
            done = dict(svc.stats)
            n_batches = done["batches"] - before["batches"]
            runs[clients] = dict(answers=answers, requests_per_s=DAEMON_REQUESTS / wall, wall_s=wall,
                                 p50_ms=float(np.percentile(lat, 50) * 1e3),
                                 p99_ms=float(np.percentile(lat, 99) * 1e3), batches=n_batches,
                                 mean_batch=(done["requests"] - before["requests"]) / n_batches)
            before = done
        counts, ln_launches = fa.launch_counts(), ln.LAUNCHES
    finally:
        svc.forward = plain_forward
        httpd.shutdown()
        httpd.server_close()
        server_thread.join(30)
    n_batches = sum(r["batches"] for r in runs.values())
    k1_per = sum(n for *_, n in SITES)
    ln_per = ln_launches_per_forward(svc.server.model, position_lns=False)
    if counts["infer"] != k1_per * n_batches or ln_launches != ln_per * n_batches:
        fail("the daemon's batches of JPEG, GIF, BMP, TIFF, WebP, JPEG 2000, PSD, PPM and PNG "
             "bodies did not launch K1 and K4 at every site")
    grid_of = batch_rows(svc, batches)
    same = formats_equal = 0
    for clients, run in runs.items():
        got = {}
        for i, status, ctype, out in run["answers"]:
            got[i] = check_answer(svc, grid_of, nets[i % len(nets)], f"[14c] request {i} "
                                  f"({clients} clients)", status, ctype, out,
                                  as_json=i % 4 in (2, 3))
        for i in got:  # a request and its PNG twin's, the same format asked
            if i % 2 == 0:
                a, b = got[i], got[i + 1]
                if not (a == b if isinstance(a, dict) else np.array_equal(a, b)):
                    fail(f"[14c] request {i} ({clients} clients): the body's answer differs "
                         f"from its PNG twin's")
                same += 1
                formats_equal += i < 2 * len(DAEMON_FORMAT_FILES)
    result = dict(launches=counts["infer"], ln_launches=ln_launches, pairs_equal=same,
                  other_formats_equal=formats_equal,
                  host_ms={k: float(np.mean(v)) for k, v in host.items()},
                  images_answered_two_ways=sum(len(r) > 1 for r in grid_of.values()))
    for clients, run in runs.items():
        del run["answers"]
        log(f"[14c] {clients} client(s), {DAEMON_REQUESTS} requests, {len(files)} JPEG and "
            f"{len(DAEMON_FORMAT_FILES)} GIF / RLE8 BMP / LZW TIFF / CMYK JPEG / WebP / JPEG 2000 "
            f"/ PSD / PPM files of "
            f"{FULL_SIZE[0]} x {FULL_SIZE[1]} beside PNG twins: "
            f"{run['requests_per_s']:.2f} requests/s, latency p50 {run['p50_ms']:.1f} ms, p99 "
            f"{run['p99_ms']:.1f} ms, {run['batches']} batches, mean batch size "
            f"{run['mean_batch']:.2f}, on {card}")
    hm = result["host_ms"]
    log(f"[14c] per request, one thread: JPEG decode {hm['jpeg_decode_ms']:.2f} ms against the PNG "
        f"twin's {hm['png_decode_ms']:.2f}, PIL bilinear resize {hm['resize_ms']:.2f}, a JPEG "
        f"request's preprocess {hm['jpeg_preprocess_ms']:.2f}; K1 {counts['infer']} and K4 "
        f"{ln_launches} launches over {n_batches} batches ({k1_per} and {ln_per} a batch); "
        f"{same} answers equal their PNG twins' ({formats_equal} of them GIF, BMP, TIFF, "
        f"CMYK JPEG, WebP, JPEG 2000 (JP2 and raw), PSD and PPM); beside {card}")
    result["runs"] = {str(c): r for c, r in runs.items()}
    return result


def phase_infer_jpeg(card: str, tmp: str, ckpt: str):
    """(d): ``cli.infer`` on assets/cat_dog.jpeg with --output=*.jpg on the
    card (the device CRF, CRF_ITERS iterations, PyTorch's default TF32
    settings), launch counts set to 0 before and read after; the overlay's
    bytes against ``encode_jpeg`` of the overlay made again from the mask it
    wrote and the decoded image."""
    from ifseg_torch.cli import infer as cli_infer
    from ifseg_torch.data.jpeg import decode_jpeg, encode_jpeg
    from ifseg_torch.data.png import decode_png_rgb
    from ifseg_torch.models.segofa import SegOFA
    from ifseg_torch.ops import flash_attention as fa
    from ifseg_torch.ops import layer_norm as ln

    with torch.device("meta"):
        ln_per = ln_launches_per_forward(SegOFA(base_config("bfloat16")), position_lns=True)
    k1_per = sum(n for *_, n in SITES)
    image = REPO / "assets" / "cat_dog.jpeg"
    out = f"{tmp}/cat_dog_overlay.jpg"
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = False, True
    try:
        fa.reset_launches()
        ln.reset_launches()
        t0 = time.perf_counter()
        got = cli_infer.main([f"--image={image}", f"--checkpoint={ckpt}",
                              f"--category-list={CAT_DOG_CATEGORIES}", "--arch=segofa_base",
                              f"--bpe-dir={REPO / 'assets' / 'BPE'}", f"--crf-iters={CRF_ITERS}",
                              f"--output={out}"])
        wall = time.perf_counter() - t0
        counts, ln_launches = fa.launch_counts(), ln.LAUNCHES
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    if counts["infer"] != k1_per or ln_launches != ln_per:
        fail(f"cli.infer on cat_dog.jpeg launched K1 {counts['infer']} and K4 {ln_launches} "
             f"times, not {k1_per} and {ln_per}")
    written = Path(out).read_bytes()
    rgb = decode_jpeg(image.read_bytes())
    colours = decode_png_rgb(Path(got["mask"]).read_bytes())
    overlay = (0.5 * colours + (1 - 0.5) * rgb).astype(np.uint8)  # the CLI's --alpha=0.5
    if written != encode_jpeg(overlay) or decode_jpeg(written).shape != rgb.shape:
        fail("cli.infer's JPEG overlay is not encode_jpeg of its overlay")
    if sum(got["areas"].values()) != rgb.shape[0] * rgb.shape[1]:
        fail(f"cli.infer's areas {got['areas']} do not cover {rgb.shape[:2]}")
    log(f"[14d] cli.infer assets/cat_dog.jpeg (560 x 1,440, progressive) -> .jpg, "
        f"{CAT_DOG_CATEGORIES!r}, {CAT_DOG_GRID[0]} x {CAT_DOG_GRID[1]} cells, device CRF: "
        + ", ".join(f"{k} {v:.1f}" for k, v in got["ms"].items())
        + f" ms; {wall:.1f} s with the checkpoint's load; the overlay ({len(written) / 1e3:.0f} kB) "
        f"is encode_jpeg of the overlay; K1 {counts['infer']}, K4 {ln_launches} launches; on {card}")
    return dict(ms=got["ms"], wall_s=wall, areas=got["areas"], launches=counts["infer"],
                ln_launches=ln_launches, overlay_bytes=len(written))


def phase_infer_formats(card: str, tmp: str, ckpt: str, image_files):
    """(d), other readers and writers: ``cli.infer`` (cat, dog; no CRF) on
    (e)'s CMYK JPEG file with ``--output=*.bmp`` and on its lossy WebP file
    with a lossless alpha plane with ``--output=*.tif``
    (INFER_FORMAT_RUNS), launch counts set to 0 before each run and read
    after; each overlay's bytes against the port's writer (``encode_bmp``,
    ``encode_tiff``, the bytes PIL's ``save`` writes) of the overlay made
    again from the mask it wrote and the image decoded to RGB.  Then on
    (e)'s INFER_JPEG2000 file and on its full-size BC7 DDS and FITS files
    (INFER_TWIN_FILES, OFA-Base's full width on the card through K1 and K4),
    each beside its PNG twin: the same overlay and mask bytes."""
    from ifseg_torch.cli import infer as cli_infer
    from ifseg_torch.data.image import decode_image_rgb
    from ifseg_torch.data.png import decode_png_rgb, encode_png
    from ifseg_torch.models.segofa import SegOFA
    from ifseg_torch.ops import flash_attention as fa
    from ifseg_torch.ops import layer_norm as ln

    with torch.device("meta"):
        ln_per = ln_launches_per_forward(SegOFA(base_config("bfloat16")), position_lns=True)
    k1_per = sum(n for *_, n in SITES)
    runs = {}
    for name, ext in INFER_FORMAT_RUNS:
        image = IMAGE_FILES / name
        rgb = decode_image_rgb(image.read_bytes())
        out = f"{tmp}/{image.stem}_overlay{ext}"
        fa.reset_launches()
        ln.reset_launches()
        t0 = time.perf_counter()
        got = cli_infer.main([f"--image={image}", f"--checkpoint={ckpt}",
                              f"--category-list={CAT_DOG_CATEGORIES}", "--arch=segofa_base",
                              f"--bpe-dir={REPO / 'assets' / 'BPE'}", "--crf-iters=0",
                              f"--output={out}"])
        wall = time.perf_counter() - t0
        counts, ln_launches = fa.launch_counts(), ln.LAUNCHES
        if counts["infer"] != k1_per or ln_launches != ln_per:
            fail(f"cli.infer --output=*{ext} launched K1 {counts['infer']} and K4 {ln_launches} "
                 f"times, not {k1_per} and {ln_per}")
        written = Path(out).read_bytes()
        colours = decode_png_rgb(Path(got["mask"]).read_bytes())
        overlay = (0.5 * colours + (1 - 0.5) * rgb).astype(np.uint8)  # the CLI's --alpha=0.5
        if (written != cli_infer.encode_overlay(overlay, out)
                or decode_image_rgb(written).shape != rgb.shape):
            fail(f"cli.infer's {ext} overlay is not the port's writer of its overlay")
        runs[ext] = dict(image=name, ms=got["ms"], wall_s=wall, launches=counts["infer"],
                         ln_launches=ln_launches, overlay_bytes=len(written))
        log(f"[14d] cli.infer {name} ({rgb.shape[0]} x {rgb.shape[1]}) -> "
            f"{ext}, {CAT_DOG_CATEGORIES!r}, no CRF: "
            + ", ".join(f"{k} {v:.1f}" for k, v in got["ms"].items())
            + f" ms; {wall:.1f} s with the checkpoint's load; the overlay ({len(written)} bytes) "
            f"is the port's {ext} writer of the overlay; K1 {counts['infer']}, K4 {ln_launches} "
            f"launches; on {card}")
    # a JPEG 2000 file (RGBA JP2, tiles at an offset), then (e)'s full-size
    # BC7 DDS and FITS files (INFER_TWIN_FILES), each beside its PNG twin, the
    # PNG of the RGB the port decodes from it: the same overlay (a TGA file,
    # read back) and mask bytes
    for name, label in ((INFER_JPEG2000, "RGBA JP2 in tiles at an offset"),
                        *INFER_TWIN_FILES):
        image = Path(tmp) / name
        image.write_bytes(image_files[name])
        twin = Path(tmp) / f"{image.stem}_twin.png"
        rgb = decode_image_rgb(image.read_bytes())
        twin.write_bytes(encode_png(rgb))
        written = {}
        for src in (image, twin):
            out = f"{tmp}/{src.stem}_overlay.tga"
            fa.reset_launches()
            ln.reset_launches()
            t0 = time.perf_counter()
            got = cli_infer.main([f"--image={src}", f"--checkpoint={ckpt}",
                                  f"--category-list={CAT_DOG_CATEGORIES}", "--arch=segofa_base",
                                  f"--bpe-dir={REPO / 'assets' / 'BPE'}", "--crf-iters=0",
                                  f"--output={out}"])
            wall = time.perf_counter() - t0
            counts, ln_launches = fa.launch_counts(), ln.LAUNCHES
            if counts["infer"] != k1_per or ln_launches != ln_per:
                fail(f"cli.infer on {src.name} launched K1 {counts['infer']} and K4 "
                     f"{ln_launches} times, not {k1_per} and {ln_per}")
            written[src] = (Path(out).read_bytes(), Path(got["mask"]).read_bytes())
            if src == image:
                key = "jpeg2000" if name == INFER_JPEG2000 else image.suffix[1:]
                runs[key] = run = dict(image=image.name, ms=got["ms"], wall_s=wall,
                                       launches=counts["infer"], ln_launches=ln_launches,
                                       overlay_bytes=len(written[src][0]))
        if written[image] != written[twin]:
            fail(f"cli.infer's overlay or mask of {image.name} differs from its PNG twin's")
        overlay = (0.5 * decode_png_rgb(written[image][1]) + 0.5 * rgb).astype(np.uint8)
        if (written[image][0] != cli_infer.encode_overlay(overlay, "overlay.tga")
                or not np.array_equal(decode_image_rgb(written[image][0]), overlay)):
            fail(f"cli.infer's .tga overlay of {image.name} is not its overlay, read back")
        log(f"[14d] cli.infer {image.name} ({rgb.shape[0]} x {rgb.shape[1]}, {label}) -> .tga, "
            f"no CRF: " + ", ".join(f"{k} {v:.1f}" for k, v in run["ms"].items())
            + f" ms; the overlay ({run['overlay_bytes']} bytes, the port's TGA writer of the "
            f"overlay, read back equal to it) and the mask equal its PNG twin's byte for byte; "
            f"K1 {run['launches']}, K4 {run['ln_launches']} launches a run; on {card}")
    return runs


# ---------------------------------------------------------------- phase 15: the rest of the training stack

REMAT_WARM, REMAT_TIMED = 2, 5  # OFA-Base steps under each checkpointing policy
HUGE_REMAT_BATCH = 32  # above the recipe's 16: "auto" takes save-attn on an 80 GB card
HUGE_REMAT_WARM, HUGE_REMAT_TIMED = 1, 2
OPT_REL_TOL = 1e-5  # an optimizer's fp32 update on the card against the same on the CPU
STACK_ROWS = 32  # phase 15's CLI epochs: 2 steps of TRAIN_BATCH
# the flags phase 15 adds to the recipe's (the groups need --optimizer=composite,
# in the JAX CLI as here)
STACK_FLAGS = ("--lr-scheduler=reduce_lr_on_plateau", "--lr-patience=0",
               "--optimizer=composite", "--composite-groups=decoder/.*=adam@5e-5",
               "--composite-base=lamb", "--checkpoint-activations=true",
               "--remat-policy=save-attn")
PRUNE_FLAGS = ("--encoder-layers=3", "--decoder-layers=3", "--encoder-layers-to-keep=0,2,4",
               "--decoder-layers-to-keep=0,2,4")


def remat_run(card: str, policy, tokens, lengths):
    """OFA-Base batch-16 image-free steps (dropout and drop-path 0.1) with the
    layers checkpointed under ``policy`` (None: not checkpointed), from the
    same seed, weights and batches whatever the policy."""
    from ifseg_torch.ops import flash_attention as fa
    from ifseg_torch.train.trainer import Trainer

    cfg = train_config("bfloat16", monitor=False, checkpoint_activations=policy is not None,
                       remat_policy=policy or "full")
    trainer = Trainer(cfg, tokens, lengths, total_num_updates=100).init_state()
    rng = np.random.default_rng(SEED + 15)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    first, _ = take_steps(trainer, rng, 1, TRAIN_BATCH, real=False)
    generator = trainer.generator.get_state()
    logs, times = take_steps(trainer, rng, REMAT_WARM + REMAT_TIMED - 1, TRAIN_BATCH, real=False)
    steps = REMAT_WARM + REMAT_TIMED
    counts = fa.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    s_step = float(np.mean(times[REMAT_WARM - 1:]))
    per_step = {k: v / steps for k, v in counts.items()}
    name = policy or "off"
    log(f"[15a] OFA-Base batch {TRAIN_BATCH}, checkpointing {name}: {s_step:.4f} s/step "
        f"(steps {', '.join(f'{t:.3f}' for t in times)}), max_memory_allocated {peak:.2f} GiB, "
        f"launches a step {per_step}; first step loss {first[0]['loss']!r} gnorm "
        f"{first[0]['gnorm']!r}, on {card}")
    for lg in first + logs:
        if not (np.isfinite(lg["loss"]) and np.isfinite(lg["gnorm"])) or lg["n_nonfinite"]:
            fail(f"checkpointing {name}: a non-finite step")
    del trainer
    torch.cuda.empty_cache()
    return dict(policy=name, s_per_step=s_step, step_s=times, max_memory_gib=peak,
                launches=counts, launches_per_step=per_step, steps=steps,
                first_loss=first[0]["loss"], first_gnorm=first[0]["gnorm"],
                generator=generator)


def phase_remat(card: str, huge_peak_16: float):
    """(a) OFA-Base under off, save-attn and full; (b) SegOFA-Huge at batch 32
    under "auto"; the bytes model's estimates beside the peaks measured."""
    from ifseg_torch.ops import flash_attention as fa
    from ifseg_torch.train.trainer import Trainer, estimate_train_hbm_bytes, REMAT_AUTO_SHARE

    tokens, lengths = class_table(SEED)
    per_pass = sum(n for *_, n in SITES)
    runs = {r["policy"]: r for r in (remat_run(card, p, tokens, lengths)
                                     for p in (None, "save-attn", "full"))}
    for name, r in runs.items():
        want = dict(infer=0, stats=per_pass * (2 if name == "full" else 1), bwd_di=per_pass,
                    bwd_dq=per_pass, bwd_dkv=per_pass)
        if r["launches_per_step"] != want:
            fail(f"checkpointing {name}: launches a step {r['launches_per_step']}, expected {want}")
    off = runs["off"]
    off_generator = off["generator"]
    for name in ("save-attn", "full"):
        r = runs[name]
        if r["first_loss"] != off["first_loss"]:
            fail(f"checkpointing {name}: first loss {r['first_loss']!r} != {off['first_loss']!r}")
        if abs(r["first_gnorm"] - off["first_gnorm"]) > 1e-3 * abs(off["first_gnorm"]):
            fail(f"checkpointing {name}: first gnorm {r['first_gnorm']} against {off['first_gnorm']}")
        if not torch.equal(r["generator"], off["generator"]):
            fail(f"checkpointing {name}: the dropout generator's state differs after a step")
    log(f"[15a] first step: loss bit-equal across off, save-attn, full ({off['first_loss']!r}); "
        f"gnorm {[runs[n]['first_gnorm'] for n in runs]}; generator states equal")

    # (b) Huge at batch 32: "auto" resolved on the card by the JAX package's bytes model
    cfg = train_config("bfloat16", monitor=False, arch=HUGE["arch"], batch=HUGE_REMAT_BATCH)
    hbm = float(torch.cuda.mem_get_info()[1])
    est32 = estimate_train_hbm_bytes(cfg.model, HUGE_REMAT_BATCH, ema=cfg.task.uses_ema)
    est16 = estimate_train_hbm_bytes(cfg.model, HUGE_TRAIN_BATCH, ema=cfg.task.uses_ema)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = Trainer(cfg, tokens, lengths, total_num_updates=100)
    decision = (cfg.model.checkpoint_activations, cfg.model.remat_policy)
    log(f"[15b] SegOFA-Huge batch {HUGE_REMAT_BATCH}, --remat-policy=auto: estimate "
        f"{est32 / 1e9:.1f} GB against {REMAT_AUTO_SHARE} x {hbm / 1e9:.1f} GB (the card's "
        f"total) -> checkpoint_activations={decision[0]}, policy {decision[1]}")
    if decision != (True, "save-attn"):
        fail(f"auto resolved SegOFA-Huge at batch {HUGE_REMAT_BATCH} to {decision}")
    trainer.init_state()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED + 16)
    fa.reset_launches()
    logs, times = take_steps(trainer, rng, HUGE_REMAT_WARM + HUGE_REMAT_TIMED, HUGE_REMAT_BATCH,
                             real=False)
    counts = fa.launch_counts()
    steps = HUGE_REMAT_WARM + HUGE_REMAT_TIMED
    huge_pass = sum(n for *_, n in attn_sites(HUGE))
    want = dict(infer=0, stats=huge_pass * steps, bwd_di=huge_pass * steps,
                bwd_dq=huge_pass * steps, bwd_dkv=huge_pass * steps)
    for lg in logs:
        if not (np.isfinite(lg["loss"]) and np.isfinite(lg["gnorm"])) or lg["n_nonfinite"]:
            fail("SegOFA-Huge at batch 32: a non-finite step")
    if counts != want:
        fail(f"SegOFA-Huge at batch 32: launches {counts}, expected {want}")
    peak = torch.cuda.max_memory_allocated()
    s_step = float(np.mean(times[HUGE_REMAT_WARM:]))
    log(f"[15b] {s_step:.4f} s/step (steps {', '.join(f'{t:.3f}' for t in times)}), "
        f"max_memory_allocated {peak / 2**30:.2f} GiB of {hbm / 2**30:.2f}, launches {counts}, "
        f"set-up {setup_s:.1f} s, on {card}")
    log(f"[15b] bytes model against the peaks measured: batch {HUGE_TRAIN_BATCH} without "
        f"checkpointing {est16 / 1e9:.1f} GB estimated, {huge_peak_16 * 2**30 / 1e9:.1f} GB "
        f"measured (phase 10); batch {HUGE_REMAT_BATCH} {est32 / 1e9:.1f} GB estimated without "
        f"checkpointing, {peak / 1e9:.1f} GB measured with save-attn")
    del trainer
    torch.cuda.empty_cache()
    for r in runs.values():
        r["generator_equal"] = bool(torch.equal(r.pop("generator"), off_generator))
    return dict(ofa_base=runs, huge=dict(
        batch=HUGE_REMAT_BATCH, hbm_bytes=hbm, estimate_bytes=est32, decision=list(decision),
        s_per_step=s_step, step_s=times, max_memory_gib=peak / 2**30, launches=counts,
        steps=steps, estimate_bytes_batch16=est16, measured_gib_batch16=huge_peak_16))


def phase_optimizers(card: str):
    """One update of every optimizer, and Adam through composite groups, on
    OFA-Base's trainable parameters with a seeded gradient: the card's fp32
    update against the same on the CPU, then ms a step by CUDA events."""
    from ifseg_torch.config import OptimizationConfig
    from ifseg_torch.models.segofa import SegOFA
    from ifseg_torch.train import optim

    cfg = train_config("float32", monitor=False)
    model = SegOFA(cfg.model).init(torch.Generator().manual_seed(SEED))
    mask = optim.freeze_mask(model, cfg.model)
    paths = optim.jax_paths(model)
    named = [(n, p.detach()) for n, p in model.named_parameters() if mask[n]]
    names = [n for n, _ in named]
    gen = torch.Generator().manual_seed(SEED + 3)
    grads = [torch.randn(p.shape, generator=gen) * 1e-3 for _, p in named]
    card_grads = [g.cuda() for g in grads]
    n_params = sum(p.numel() for _, p in named)
    out = {}
    for name in optim.OPTIMIZERS:
        if name == "fused_lamb":
            continue  # lamb's other name
        opt_cfg = OptimizationConfig(optimizer=name, lr=5e-5, momentum=0.9, weight_decay=0.1,
                                     composite_base="adam",
                                     composite_groups="decoder/.*=adam@2.5e-5")

        def build(params):
            schedule = optim.build_schedule("cosine", opt_cfg.lr, 100, opt_cfg)
            if name == "composite":
                return optim.composite(params, names, paths, optim.parse_composite_groups(
                    opt_cfg.composite_groups), opt_cfg.composite_base, opt_cfg, 100)
            return optim._single_optimizer(name, params, names, schedule, opt_cfg, paths)

        cpu_opt = build([p.clone() for _, p in named])
        card_opt = build([p.cuda() for _, p in named])
        want = cpu_opt.update(grads)
        got = card_opt.update(card_grads)
        err = max(float((g.cpu() - w).abs().max() / w.abs().max().clamp(min=1e-30))
                  for g, w in zip(got, want))
        del cpu_opt, want, got
        ms = cuda_ms(lambda: card_opt.step(card_grads), 3, warmup=1)
        out[name] = dict(rel_err=err, ms=ms)
        log(f"[15c] {name}: one update on {n_params / 1e6:.1f}M trainable parameters, card "
            f"against CPU max rel. error {err:.3e} (tolerance {OPT_REL_TOL}); {ms:.3f} ms a step "
            f"(CUDA events), on {card}")
        if not err <= OPT_REL_TOL:
            fail(f"optimizer {name}: the card's update differs from the CPU's by {err}")
        del card_opt
        torch.cuda.empty_cache()
    return out


def phase_train_cli_stack(card: str, tmp: str, valid_tsv: str, ckpt_file: str):
    """``cli.train`` on the card with the recipe's flags and the rest of the
    training stack: 2 epochs of 2 steps, a resume to epoch 3 (every restored
    state held to the files), then a pruned 1-step run from the same restore
    file."""
    from ifseg_torch.checkpoint.convert import load_torch_checkpoint
    from ifseg_torch.checkpoint.manager import CheckpointManager
    from ifseg_torch.cli import train as cli_train
    from ifseg_torch.config import from_flags
    from ifseg_torch.ops import flash_attention as fa
    from ifseg_torch.ops import layer_norm as ln
    from ifseg_torch.train import optim

    train_tsv = f"{tmp}/stack_train.tsv"
    with open(valid_tsv) as src, open(train_tsv, "w") as dst:
        rows = src.readlines()
        dst.writelines((rows * -(-STACK_ROWS // len(rows)))[:STACK_ROWS])

    def flags(save_dir, *extra, resets=True):
        argv = common_sh_argv(f"{train_tsv},{valid_tsv}", save_dir, ckpt_file)
        argv = [a for a in argv if resets or a not in RESET_FLAGS]
        return from_flags(argv + [f"--epoch-row-count={STACK_ROWS}", "--batch-size-valid=8",
                                  f"--num-workers={CLI_WORKERS}", *STACK_FLAGS, *extra])

    restored, loaded = [], {}
    restore, pretrained = cli_train.restore_training_state, cli_train.maybe_restore_pretrained

    def same(a, b):
        if isinstance(a, dict):
            return isinstance(b, dict) and a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
        if torch.is_tensor(a):
            return torch.is_tensor(b) and torch.equal(a, b)
        return a == b

    def checked_restore(cfg, trainer, ckpt):
        name = ckpt.latest()
        out = restore(cfg, trainer, ckpt)
        if name is not None:
            saved, now = ckpt.load(name), trainer.state_dict()
            restored.append(dict(name=name, **{k: same(now[k], saved[k]) for k in saved}))
        return out

    def recording_pretrained(cfg, device, plan=None):
        loaded["sd"] = pretrained(cfg, device, plan)
        return loaded["sd"]

    cli_train.restore_training_state = checked_restore
    cli_train.maybe_restore_pretrained = recording_pretrained
    result = {}
    try:
        save = f"{tmp}/stack"
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launches()
        ln.reset_launches()
        cfg = flags(save, "--max-epoch=2")
        t0 = time.perf_counter()
        run = cli_train.main(cfg)
        torch.cuda.synchronize()
        main_s = time.perf_counter() - t0
        counts, ln_launches = fa.launch_counts(), ln.LAUNCHES
        steps = run["num_updates"]
        per_step = sum(n for *_, n in SITES)
        validations = sum(e["valid"] is not None for e in run["epochs"])
        want = dict(stats=per_step * steps, bwd_di=per_step * steps, bwd_dq=per_step * steps,
                    bwd_dkv=per_step * steps)
        log(f"[15d] cli.train.main, recipe + {' '.join(STACK_FLAGS)}: {steps} updates, "
            f"{validations} validations; attention launches {counts} (save-attn: expected "
            f"{want} and the monitoring and validation forwards), layer_norm launches "
            f"{ln_launches}, peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, main "
            f"{main_s:.1f} s, on {card}")
        if (steps != 4 or validations != 2 or {k: counts[k] for k in want} != want
                or counts["infer"] < per_step * steps or ln_launches < 1):
            fail("the training CLI with the stack's flags did not launch every kernel as expected")
        if not (cfg.model.checkpoint_activations and cfg.model.remat_policy == "save-attn"
                and cfg.optimization.optimizer == "composite"):
            fail(f"the stack's flags were not taken: {cfg.model}, {cfg.optimization}")
        plateau = optim.ReduceLROnPlateau(shrink=cfg.optimization.lr_shrink,
                                          patience=cfg.optimization.lr_patience, maximize=True)
        want_scales = [plateau.step(float(e["valid"]["mIoU"])) for e in run["epochs"]]
        scales = [e.get("lr_scale") for e in run["epochs"]]
        log(f"[15d] mIoU {[e['valid']['mIoU'] for e in run['epochs']]}, lr scale after each "
            f"validation {scales} (the controller's {want_scales})")
        if scales != want_scales:
            fail("the plateau scale does not follow the controller")
        result.update(launches=counts, ln_launches=ln_launches, main_s=main_s,
                      step_s=[t for e in run["epochs"] for t in e["step_s"]],
                      lr_scales=scales, valid=[e["valid"] for e in run["epochs"]])

        restored.clear()
        fa.reset_launches()
        ln.reset_launches()
        resumed = cli_train.main(flags(save, "--max-epoch=3", resets=False))
        result["resume_launches"], result["resume_ln_launches"] = fa.launch_counts(), ln.LAUNCHES
        log(f"[15d] resume to epoch 3: started at epoch {resumed['start_epoch']} with "
            f"{resumed['restored_updates']} updates; restored parts equal to the files: "
            f"{restored}; lr scale {resumed['epochs'][-1].get('lr_scale')}")
        parts = ("model", "ema", "optimizer", "step", "generator", "plateau")
        if ((resumed["start_epoch"], resumed["restored_updates"], resumed["num_updates"])
                != (3, 4, 6) or len(restored) != 1
                or not all(restored[0].get(p, p == "ema") for p in parts)):
            fail(f"the resume did not restore every part bit for bit: {restored}")
        saved = CheckpointManager(flags(save).checkpoint).load("checkpoint_3")
        result["resume"] = dict(restored=restored, optimizer_groups=sorted(
            saved["optimizer"]["groups"]), lr_scale=saved["optimizer"]["lr_scale"],
            plateau=saved["plateau"])

        # a 1-step run on the same restore file, three of each side's six layers kept
        fa.reset_launches()
        ln.reset_launches()
        pruned_cfg = flags(f"{tmp}/stack_pruned", *PRUNE_FLAGS, "--max-epoch=1", "--max-update=1")
        pruned = cli_train.main(pruned_cfg)
        result["pruned_launches"], result["pruned_ln_launches"] = fa.launch_counts(), ln.LAUNCHES
        file = load_torch_checkpoint(ckpt_file)
        kept = all(torch.equal(loaded["sd"][f"{side}.layers.{j}.fc1.weight"],
                               file[f"{side}.layers.{i}.fc1.weight"])
                   for side in ("encoder", "decoder") for j, i in enumerate((0, 2, 4)))
        n_layers = {side: len({k.split(".")[2] for k in loaded["sd"]
                               if k.startswith(f"{side}.layers.")}) for side in ("encoder", "decoder")}
        log(f"[15d] {' '.join(PRUNE_FLAGS)}: layers loaded {n_layers}, kept layers equal to the "
            f"file's 0, 2, 4: {kept}; {pruned['num_updates']} update, stop {pruned['stop']!r}, "
            f"launches {result['pruned_launches']}, on {card}")
        if not kept or n_layers != {"encoder": 3, "decoder": 3} or pruned["num_updates"] != 1:
            fail("the pruned run did not load layers 0, 2, 4 of the restore file or did not step")
        result["pruned"] = dict(layers=n_layers, kept_equal=kept, stop=pruned["stop"])
    finally:
        cli_train.restore_training_state = restore
        cli_train.maybe_restore_pretrained = pretrained
    return result


# ---------------------------------------------------------------- phase 16: the option paths and generation

def option_run(card: str, tag: str, tokens, lengths, steps: int, warm: int, **overrides):
    """OFA-Base batch-16 image-free steps with the layers not checkpointed
    (phase 15a's "off" row: dropout and drop-path 0.1, the same seed and
    batches) under the model options ``overrides``: s/step, peak memory,
    launches a step, bias routes, the trainable parameters and the tensors
    that moved."""
    from ifseg_torch.ops import flash_attention as fa
    from ifseg_torch.train.trainer import Trainer

    cfg = train_config("bfloat16", monitor=False, checkpoint_activations=False, **overrides)
    trainer = Trainer(cfg, tokens, lengths, total_num_updates=100).init_state()
    start = {n: t.detach().clone() for n, t in trainer.model.state_dict().items()}
    rng = np.random.default_rng(SEED + 15)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    logs, times = take_steps(trainer, rng, steps, TRAIN_BATCH, real=False)
    counts, routes = fa.launch_counts(), fa.bias_route_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    for lg in logs:
        if not (np.isfinite(lg["loss"]) and np.isfinite(lg["gnorm"])) or lg["n_nonfinite"]:
            fail(f"{tag}: a non-finite step")
    moved = sorted(n for n, t in trainer.model.state_dict().items() if not torch.equal(t, start[n]))
    trainable = sorted(n for n, m in trainer.mask.items() if m)
    n_trainable = sum(trainer.model.get_parameter(n).numel() for n in trainable)
    s_step = float(np.mean(times[warm:]))
    per_step = {k: v / steps for k, v in counts.items()}
    log(f"{tag} {', '.join(f'{k}={v}' for k, v in overrides.items())}: {n_trainable:,} trainable "
        f"parameters in {len(trainable)} tensors, {len(moved)} tensors moved; {s_step:.4f} s/step "
        f"(steps {', '.join(f'{t:.3f}' for t in times)}), max_memory_allocated {peak:.2f} GiB, "
        f"launches a step {per_step}, bias routes {routes}; loss {logs[-1]['loss']:.4f}, on {card}")
    per_pass = sum(n for *_, n in SITES)
    if per_step != dict(infer=0, stats=per_pass, bwd_di=per_pass, bwd_dq=per_pass,
                        bwd_dkv=per_pass):
        fail(f"{tag}: launches a step {per_step}, expected {per_pass} of each backward kernel")
    if routes != dict(fwd_bias_tma=counts["stats"], fwd_bias_threads=0, bwd_bias_copies=0):
        fail(f"{tag}: a bias staged by threads or copied by the backward: {routes}")
    if not set(moved) <= set(trainable) or not moved:
        fail(f"{tag}: frozen tensors moved: {sorted(set(moved) - set(trainable))[:8]}")
    del trainer, start
    torch.cuda.empty_cache()
    return dict(s_per_step=s_step, step_s=times, max_memory_gib=peak, launches=counts,
                launches_per_step=per_step, bias_routes=routes, trainable=trainable,
                n_trainable=n_trainable, moved=moved, steps=steps)


PROMPT_TABLES = ("encoder.encoder_prompt_encoder.embedding.weight",
                 "decoder.decoder_prompt_encoder.embedding.weight")


def phase_prefix_train(card: str, off_row):
    """(a) Prefix tuning of OFA-Base (--encoder-prompt --decoder-prompt, P
    100): steps beside phase 15a's unprompted "off" row, only the prompt
    encoders training and moving; once more with the prompts' projection;
    the card against the CPU at batch 2."""
    tokens, lengths = class_table(SEED)
    steps = REMAT_WARM + REMAT_TIMED
    plain = option_run(card, "[16a]", tokens, lengths, steps, REMAT_WARM,
                       encoder_prompt=True, decoder_prompt=True)
    want = 2 * PROMPT_LEN * BASE["enc_layers"] * 2 * BASE["width"]
    log(f"[16a] prefix tuning, P {PROMPT_LEN} a side: {plain['n_trainable']:,} trainable "
        f"parameters (expected {want:,}), moved {plain['moved']}; {plain['s_per_step']:.4f} "
        f"s/step and {plain['max_memory_gib']:.2f} GiB against phase 15a's unprompted "
        f"{off_row['s_per_step']:.4f} s/step and {off_row['max_memory_gib']:.2f} GiB")
    if plain["n_trainable"] != want or plain["trainable"] != sorted(PROMPT_TABLES):
        fail(f"prefix tuning trains {plain['trainable']} ({plain['n_trainable']:,} parameters)")
    if plain["moved"] != sorted(PROMPT_TABLES):
        fail(f"prefix tuning moved {plain['moved']}, not the two prompt tables alone")
    proj = option_run(card, "[16a projection]", tokens, lengths, 2, 1, encoder_prompt=True,
                      decoder_prompt=True, encoder_prompt_projection=True,
                      decoder_prompt_projection=True)
    if not all("_prompt_encoder." in n for n in proj["trainable"]) or proj["moved"] != proj[
            "trainable"]:
        fail(f"prefix tuning with the projection trains {proj['trainable']}, moved {proj['moved']}")
    grads = phase_train_gradients(grad_tensors=PROMPT_TABLES, tag="[16a]", encoder_prompt=True,
                                  decoder_prompt=True)
    return dict(plain=plain, projection=proj, gradients=grads, unprompted_off=dict(
        s_per_step=off_row["s_per_step"], max_memory_gib=off_row["max_memory_gib"]))


def bitfit_names(names):
    """The parameters BitFit trains: the biases of the *layer_norm LayerNorms
    and of fc1 / fc2 (train/optim.py freeze_mask)."""
    return sorted(n for n in names if n.endswith(".bias")
                  and (n.split(".")[-2].endswith("layer_norm") or n.split(".")[-2] in ("fc1", "fc2")))


def phase_options(card: str, tmp: str, valid_tsv: str, ckpt_file: str):
    """(b) One step each (timed after one) with adapters, BitFit and
    gelu_poly, then ``cli.train`` for 2 steps with --bitfit and with
    --encoder-prompt: the flags reach the trainer."""
    from ifseg_torch.cli import train as cli_train
    from ifseg_torch.config import from_flags
    from ifseg_torch.ops import flash_attention as fa
    from ifseg_torch.ops import layer_norm as ln
    from ifseg_torch.train import trainer as trainer_lib

    tokens, lengths = class_table(SEED)
    runs = {}
    for name, flags in (("adapter", dict(adapter=True)), ("bitfit", dict(bitfit=True)),
                        ("gelu_poly", dict(activation_fn="gelu_poly"))):
        r = runs[name] = option_run(card, f"[16b {name}]", tokens, lengths, 2, 1, **flags)
        adapters = [n for n in r["trainable"] if ".adapter." in n]
        if name == "adapter" and (len(adapters) != 4 * (BASE["enc_layers"] + BASE["dec_layers"])
                                  or not set(adapters) <= set(r["moved"])):
            fail(f"adapters: {len(adapters)} adapter tensors trainable, not all moved")
        if name == "bitfit" and (r["trainable"] != bitfit_names(r["trainable"])
                                 or len(r["trainable"]) != 4 * BASE["enc_layers"] + 1
                                 + 5 * BASE["dec_layers"] + 1):
            fail(f"BitFit trains {len(r['trainable'])} tensors, not the LayerNorm and FFN biases")

    train_tsv = f"{tmp}/stack_train.tsv"
    with open(valid_tsv) as src, open(train_tsv, "w") as dst:
        rows = src.readlines()
        dst.writelines((rows * -(-STACK_ROWS // len(rows)))[:STACK_ROWS])
    seen = {}
    init_state = trainer_lib.Trainer.init_state

    def recording_init(self, params=None):
        out = init_state(self, params)
        seen["trainable"] = sorted(n for n, m in self.mask.items() if m)
        seen["n"] = sum(p.numel() for p in self.optimizer.params)
        return out

    trainer_lib.Trainer.init_state = recording_init
    cli = {}
    try:
        for flag in ("--bitfit", "--encoder-prompt"):
            argv = common_sh_argv(f"{train_tsv},{valid_tsv}", f"{tmp}/opt{flag}", ckpt_file)
            cfg = from_flags(argv + [f"--epoch-row-count={STACK_ROWS}", "--max-epoch=1",
                                     "--validate-interval=2", "--no-save", flag])
            fa.reset_launches()
            ln.reset_launches()
            t0 = time.perf_counter()
            run = cli_train.main(cfg)
            torch.cuda.synchronize()
            counts = fa.launch_counts()
            cli[flag] = dict(num_updates=run["num_updates"], main_s=time.perf_counter() - t0,
                             trainable=seen["n"], launches=counts, ln_launches=ln.LAUNCHES)
            log(f"[16b] cli.train.main, recipe + {flag}: {run['num_updates']} updates, "
                f"{seen['n']:,} trainable parameters in {len(seen['trainable'])} tensors, "
                f"attention launches {counts}, layer_norm launches {ln.LAUNCHES}, "
                f"main {cli[flag]['main_s']:.1f} s, on {card}")
            if flag == "--bitfit":
                ok = cfg.model.bitfit and seen["trainable"] == bitfit_names(seen["trainable"])
            else:
                ok = (cfg.model.encoder_prompt
                      and seen["trainable"] == ["encoder.encoder_prompt_encoder.embedding.weight"]
                      and seen["n"] == PROMPT_LEN * BASE["enc_layers"] * 2 * BASE["width"])
            per_pass = sum(n for *_, n in SITES)
            if not ok or run["num_updates"] != 2 or counts["stats"] != 2 * per_pass:
                fail(f"cli.train with {flag}: the flag did not reach the trainer "
                     f"({len(seen['trainable'])} trainable tensors, {run['num_updates']} updates)")
    finally:
        trainer_lib.Trainer.init_state = init_state
    return dict(runs=runs, cli=cli)


def phase_prefix_eval_serve(card: str):
    """(c) The prompt-tuned model: the ``Evaluator`` applies the prefixes (K1
    at P + L keys); ``SegServer`` does not, and answers as the same weights
    without the prompt encoders (the JAX package's served path,
    ROADMAP.md C.4)."""
    import ifseg_torch.models.attention as attention
    from ifseg_torch.eval.evaluator import Evaluator
    from ifseg_torch.eval.serving import SegServer
    from ifseg_torch.ops import flash_attention as fa
    from ifseg_torch.ops import layer_norm as ln

    cfg = base_config("bfloat16")
    cfg.encoder_prompt = cfg.decoder_prompt = True
    model = build_on_card(cfg)
    weights = {k: v.detach().clone() for k, v in model.state_dict().items()}
    evaluator = Evaluator(eval_config("bfloat16", model.cfg), model)
    keys = []
    infer = attention.flash_attention_bias_packed_infer

    def recording(q, k, *args):
        keys.append((q.shape[1], k.shape[1]))
        return infer(q, k, *args)

    attention.flash_attention_bias_packed_infer = recording
    try:
        fa.reset_launches()
        ln.reset_launches()
        logs = evaluator.eval_dataset(ListDataset(eval_samples(EVAL_SHAPES_WIDE, 500)),
                                      batch_size=8)
        torch.cuda.synchronize()
        eval_counts, eval_ln, routes = fa.launch_counts(), ln.LAUNCHES, fa.bias_route_counts()
    finally:
        attention.flash_attention_bias_packed_infer = infer
    cells = EVAL_GRID[0] * EVAL_GRID[1]
    want = {(cells + SRC_LEN, cells + SRC_LEN + PROMPT_LEN), (1 + cells, 1 + cells + PROMPT_LEN),
            (1 + cells, cells + SRC_LEN)}
    log(f"[16c] Evaluator on the prompt-tuned model, one group of 8: (Lq, Lk) of its K1 "
        f"launches {sorted(set(keys))} (expected {sorted(want)}), attention launches "
        f"{eval_counts}, layer_norm launches {eval_ln}, bias routes {routes}; "
        f"area_intersect sum {float(np.sum(logs[0]['area_intersect']))}")
    if set(keys) != want or eval_counts["infer"] != len(keys) or routes["fwd_bias_threads"]:
        fail("the evaluator did not apply the prefixes at every self-attention")
    del evaluator

    server = SegServer(model, src_len=SRC_LEN)
    inputs = [x.to("cuda") for x in requests(8, seed=950)]
    fa.reset_launches()
    ln.reset_launches()
    got = server(*inputs)
    torch.cuda.synchronize()
    serve_counts, serve_ln = fa.launch_counts(), ln.LAUNCHES
    del server, model
    bare_cfg = base_config("bfloat16")
    bare = build_on_card(bare_cfg)
    bare.load_state_dict({k: v for k, v in weights.items() if "prompt_encoder" not in k},
                         strict=True)
    want_logits = SegServer(bare, src_len=SRC_LEN)(*inputs)
    torch.cuda.synchronize()
    same = bool(torch.equal(got, want_logits))
    diff = (got - want_logits).abs().max().item()
    log(f"[16c] SegServer on the prompt-tuned model: logits {'equal' if same else 'differ'} to "
        f"the same weights without the prompt encoders (max |Δ| {diff:.3e}): the served path "
        f"applies no prefix, as the JAX package's (ROADMAP.md C.4); launches {serve_counts}, "
        f"layer_norm {serve_ln}")
    if not same or serve_counts["infer"] != sum(n for *_, n in SITES):
        fail("the served path of a prompt-tuned model does not answer as the JAX package's")
    del bare, want_logits, got, weights
    torch.cuda.empty_cache()
    return dict(eval_keys=sorted(set(keys)), eval_launches=eval_counts, eval_ln_launches=eval_ln,
                serve_launches=serve_counts, serve_ln_launches=serve_ln, serve_equal_bare=same)


def first_divergence(card_tokens, cpu_tokens):
    diff = (card_tokens != cpu_tokens).nonzero()
    return None if len(diff) == 0 else int(diff[0, -1])


def phase_generate(card: str):
    """(d) Generation with OFA-Base (150 classes, random weights from SEED),
    batch 2 x beam 5: the KV-cached generator at GEN_MAX_LEN tokens, the uncached
    one (decode_ar) at 32, decode_ar's logits against ar_step's at every
    position, the cached generator on the card against the CPU (fp32 both),
    an ensemble and a trie-constrained run."""
    from ifseg_torch.generate.trie import ConstraintTrie
    from ifseg_torch.models.ar_cache import ar_step, init_ar_cache
    from ifseg_torch.models.segofa import SegOFA, build_generator
    from ifseg_torch.ops import flash_attention as fa
    from ifseg_torch.ops import layer_norm as ln

    cfg = base_config("bfloat16")
    model = build_on_card(cfg).eval()
    num_seg = cfg.num_seg_tokens
    src, img, _ = requests(GEN_BATCH, seed=900)
    with torch.no_grad():
        enc = model.encode_only(src.to("cuda"), img.to("cuda"))
    result = {}

    def timed_run(gen, tag, steps):
        fa.reset_launches()
        ln.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = gen(GEN_BATCH, gen.initial_cache)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = dict(fa.launch_counts(), layer_norm=ln.LAUNCHES)
        best = out.tokens[:, 0]
        log(f"[16d] {tag}: {dt:.2f} s, {dt / steps * 1e3:.3f} ms a generated token (batch "
            f"{GEN_BATCH} x beam {GEN_BEAM} a step), best scores {out.scores[:, 0].tolist()}, "
            f"launches {counts}, on {card}")
        if not bool(torch.isfinite(out.scores[:, 0]).all()):
            fail(f"{tag}: no finished hypothesis")
        return out, dict(s=dt, ms_per_token=dt / steps * 1e3, launches=counts,
                         best_scores=out.scores[:, 0].tolist())

    gen = build_generator(model, enc, beam=GEN_BEAM, max_len=GEN_MAX_LEN, min_len=GEN_MAX_LEN)
    out, result["cached"] = timed_run(gen, f"KV-cached generator, {GEN_MAX_LEN} tokens",
                                      GEN_MAX_LEN + 1)
    best = out.tokens[:, 0]
    eos_at = (best == num_seg).float().argmax(dim=1)
    if (eos_at != GEN_MAX_LEN + 1).any() or (best[:, 1:GEN_MAX_LEN + 1] >= num_seg).any():
        fail(f"the pinned generation did not give {GEN_MAX_LEN} classes then EOS")
    del gen

    gen = build_generator(model, enc, beam=GEN_BEAM, max_len=GEN_RECOMPUTE_LEN,
                          min_len=GEN_RECOMPUTE_LEN, use_kv_cache=False)
    _, result["recompute"] = timed_run(gen, f"uncached generator (decode_ar), "
                                       f"{GEN_RECOMPUTE_LEN} tokens", GEN_RECOMPUTE_LEN + 1)
    steps = GEN_RECOMPUTE_LEN + 1
    rc = result["recompute"]["launches"]
    if rc["infer"] != steps * 2 * BASE["dec_layers"] or rc["layer_norm"] != steps * (
            3 + 6 * BASE["dec_layers"]):
        fail(f"the uncached generator's decode_ar did not launch K1 and K4 at every site: {rc}")
    del gen

    # decode_ar (bf16, kernels) against ar_step (fp32) at every position of the
    # best beams (BOS, the GEN_MAX_LEN classes, EOS)
    n_pos = best.shape[1]
    with torch.no_grad():
        full = model.decoder.decode_ar(best, enc).float()
        cache = init_ar_cache(model, enc, GEN_BATCH, n_pos)
        steps_out = [ar_step(model, cache, best, t)[0] for t in range(n_pos)]
    ref = torch.stack(steps_out, dim=1)
    per_pos = ((full - ref).norm(dim=(0, 2)) / ref.norm(dim=(0, 2))).cpu()
    log(f"[16d] decode_ar (bf16, K1 + K4) against ar_step (fp32) over {n_pos:,} positions of the "
        f"best beams: ||Δ||/||ref|| max {per_pos.max().item():.3e} (at {int(per_pos.argmax())}), "
        f"mean {per_pos.mean().item():.3e}")
    result["decode_ar_vs_ar_step"] = dict(max=per_pos.max().item(), mean=per_pos.mean().item())
    if not per_pos.max().item() <= AR_LOGIT_REL_TOL:
        fail(f"decode_ar and ar_step disagree: {per_pos.max().item()} > {AR_LOGIT_REL_TOL}")
    del full, cache, steps_out, ref

    # the cached generator on the card against the same on the CPU, fp32 both
    kw = dict(beam=GEN_BEAM, max_len=GEN_COMPARE_LEN, min_len=GEN_COMPARE_LEN)
    card_out = build_generator(model, enc, **kw)
    card_out = card_out(GEN_BATCH, card_out.initial_cache)
    cpu_model = SegOFA(cfg)
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()}, strict=True)
    cpu_enc = {k: v.cpu() if torch.is_tensor(v) else v for k, v in enc.items()}
    t0 = time.perf_counter()
    cpu_gen = build_generator(cpu_model.eval(), cpu_enc, **kw)
    cpu_out = cpu_gen(GEN_BATCH, cpu_gen.initial_cache)
    cpu_s = time.perf_counter() - t0
    sc, sp = card_out.scores.cpu(), cpu_out.scores
    rel = ((sc - sp).abs() / sp.abs()).max().item()
    first = [first_divergence(card_out.tokens[b, 0].cpu(), cpu_out.tokens[b, 0])
             for b in range(GEN_BATCH)]
    log(f"[16d] KV-cached generator, {GEN_COMPARE_LEN} tokens, card against CPU (fp32 both, CPU "
        f"{cpu_s:.1f} s): scores rel {rel:.3e}, first beams "
        f"{'equal' if first == [None] * GEN_BATCH else f'differ from step {first}'}")
    for b, step in enumerate(first):
        if step is not None:  # the gap between the two tokens at the first step they differ
            prefix = card_out.tokens[b:b + 1, 0].cpu()
            c = init_ar_cache(cpu_model, {k: v[b:b + 1] if torch.is_tensor(v) and v.dim() and
                                          v.shape[0] == GEN_BATCH else v
                                          for k, v in cpu_enc.items()}, 1, GEN_COMPARE_LEN + 2)
            for t in range(step):
                lp = torch.log_softmax(ar_step(cpu_model, c, prefix, t)[0], dim=-1)
            a, z = int(prefix[0, step]), int(cpu_out.tokens[b, 0, step])
            log(f"[16d]   sentence {b}, step {step}: card chose {a}, CPU {z}; CPU log-probs "
                f"{lp[0, a].item() if a < num_seg else None} against "
                f"{lp[0, z].item() if z < num_seg else None}")
    result["card_vs_cpu"] = dict(score_rel_err=rel, first_divergence=first, cpu_s=cpu_s)
    if not rel <= GEN_SCORE_REL_TOL or first != [None] * GEN_BATCH:
        fail(f"the cached generator on the card differs from the CPU's: scores {rel}, "
             f"tokens from step {first}")
    del cpu_model, cpu_gen, cpu_out, card_out

    # an ensemble of two weight sets; and one of identical members equals the single model
    other = build_on_card(cfg).eval()
    with torch.no_grad():
        noise = torch.Generator(device=enc["encoder_out"].device).manual_seed(1)
        for p in other.parameters():
            p.add_(torch.randn(p.shape, generator=noise, device=p.device) * 0.01)
    kw = dict(beam=GEN_BEAM, max_len=GEN_RECOMPUTE_LEN, min_len=GEN_RECOMPUTE_LEN)
    single = build_generator(model, enc, **kw)
    single = single(GEN_BATCH, single.initial_cache)
    twin = build_generator([model, model], enc, **kw)
    twin = twin(GEN_BATCH, twin.initial_cache)
    ens = build_generator([model, other], enc, **kw)
    ens, result["ensemble"] = timed_run(ens, "ensemble of two weight sets (KV cache), "
                                        f"{GEN_RECOMPUTE_LEN} tokens", GEN_RECOMPUTE_LEN + 1)
    twin_ok = bool(torch.equal(twin.tokens, single.tokens)) and torch.allclose(
        twin.scores, single.scores, atol=1e-5, rtol=1e-5)
    log(f"[16d] an ensemble of one model twice {'equals' if twin_ok else 'differs from'} the "
        f"model alone")
    if not twin_ok:
        fail("an ensemble of identical members differs from the single model")
    del other, twin, single

    # constrained by a trie of class sequences (inserted as [bos] + seq + [eos])
    seqs = [[5, 6, 7], [5, 8], [9, 10, 11, 12, 13], [149, 0, 3]]
    trie = ConstraintTrie(num_seg)
    for q in seqs:
        trie.insert([0] + q + [num_seg])
    gen = build_generator(model, enc, beam=GEN_BEAM, max_len=8, min_len=1,
                          constraint_trie=trie.pack("cuda"))
    out, result["trie"] = timed_run(gen, "trie-constrained generator", 9)
    bodies = []
    for b in range(GEN_BATCH):
        for k in range(GEN_BEAM):
            if out.scores[b, k] > -1e6:
                row = out.tokens[b, k].tolist()
                bodies.append(row[1:row.index(num_seg)] if num_seg in row else row[1:])
    log(f"[16d] trie-constrained hypotheses: {bodies}")
    if not bodies or any(body not in seqs for body in bodies):
        fail("a trie-constrained hypothesis left the trie")
    del model, enc, gen
    torch.cuda.empty_cache()
    return result


# ---------------------------------------------------------------- main

def pass_totals(rows, per_key):
    """A kernel's times summed over the sites of one pass (``per_key`` calls
    each): its own, the plain version's, the bound and the library call's."""
    timed = [r for r in rows if r.get(per_key)]
    total = lambda key: sum(r[key] * r[per_key] for r in timed)
    t_ops = sum(r["gflop"] * 1e9 / r.get("peak_flops", PEAK_BF16_FLOPS) * 1e3 * r[per_key]
                for r in timed)
    t_bytes = sum(r["mb"] * 1e6 / PEAK_BYTES_PER_S * 1e3 * r[per_key] for r in timed)
    lib = None if any(r["library_ms"] is None for r in timed) else total("library_ms")
    return dict(ms=total("kernel_ms"), plain_ms=total("plain_ms"), bound_ms=total("bound_ms"),
                bound_by="operations" if t_ops >= t_bytes else "bytes", library_ms=lib,
                calls=sum(r[per_key] for r in timed))


def kernel_entry(name, source, replaces, launches, rows, unit, per_key):
    """One entry of the ``kernels`` line from a kernel's per-site rows; the
    times are those of one pass of ``unit``."""
    totals = pass_totals(rows, per_key)
    del totals["calls"]
    return dict(
        name=name, route="cuda", source=source, replaces=replaces, launches=launches,
        max_abs_err=max(r["max_abs_err"] for r in rows), **totals, unit=unit, sites=rows,
    )



# ---------------------------------------------------------------- phase 17

# (a): the steps of each strategy at degree 1, and their tolerances against
# the unwrapped trainer (bf16, the same seeded weights, moments and batches).
# DDP, FSDP and ZeRO-1 were bit-equal to it; TP, whose row-parallel products
# add their bias after the sum, read at most 2.14e-5 (loss) and 1.00e-4
# (gnorm) relative in four whole runs (calls AG-AL of PR 13's chip runs,
# H100 80GB HBM3, 700 W); the limits are about 5x those readings
PAR_WARM, PAR_TIMED = 2, 5
PAR_LOSS_TOL, PAR_GNORM_TOL, PAR_COSINE_MIN = 1e-4, 5e-4, 0.9999
# (b): one step of 8 + 8 rows against one process's step on the 16
PAR2_LOSS_TOL, PAR2_GNORM_TOL, PAR2_COSINE_MIN = 1e-3, 1e-2, 0.999
# the strategies, from the distributed config at degree 1; fsdp and tp turn
# on there only above 1, so the Trainer's switch names them
PAR_STRATEGIES = {"ddp": ({}, None), "fsdp": ({}, ("fsdp",)), "zero1": (dict(zero1=True), None),
                  "tp": ({}, ("tp",))}
# the strategies whose step is profiled for NCCL's kernels at world 1: DDP's
# and TP's all-reduces launch none there (0.000 ms in every run), so their
# profiled step (3-5 s each) is left out, which leaves room for phase 19
PAR_PROFILED = ("fsdp", "zero1")
# (b)'s fixed table: NCCL takes one rank a card ("Duplicate GPU detected"),
# so two processes sharing the card reach each other over gloo, which
# carries all-reduce, broadcast, all-gather and reduce-scatter for CUDA
# tensors on this machine (and aborts the process on a CUDA send/recv,
# which no strategy here uses): every strategy runs at degree 2
GLOO_ON_ONE_CARD = {
    "ddp": ("runs", "data 2: the gradients all-reduced"),
    "fsdp": ("runs", "fsdp 2: parameters all-gathered, gradients reduce-scattered"),
    "zero1": ("runs", "data 2 + zero1: gradients all-reduced, updated slices all-gathered"),
    "tp": ("runs", "tensor 2: activations all-reduced and all-gathered"),
}
PAR_DEGREE2 = {"ddp": dict(data_parallel=2), "fsdp": dict(fsdp=2),
               "zero1": dict(data_parallel=2, zero1=True), "tp": dict(tensor_parallel=2)}
# (b)'s strategies that also run the monitoring forward (the split FFN
# LayerNorm's gathered rows through K4), against the reference's
PAR2_MONITORED = ("tp",)
PAR_CLI_ROWS = 32  # phase 17c's training epoch: 2 steps of TRAIN_BATCH


def seeded_moments(state, gen):
    """The optimizer state ``state`` (a ``state_dict``) with count 3, first
    moments N(0, 1e-3) and second moments U(1e-4, 1e-2), drawn on the card
    from ``gen``: with the second moments above the gradients' rounding
    noise, an update is smooth in the gradient, so two runs' updates compare
    tensor by tensor (a key bias, whose gradient is zero up to rounding,
    would otherwise move by ±lr)."""
    out = {}
    for k, v in state.items():
        if k == "count":
            out[k] = 3
        elif isinstance(v, dict):
            out[k] = {}
            for n, t in v.items():
                x = torch.empty(t.shape, dtype=t.dtype, device="cuda")
                out[k][n] = (x.normal_(0, 1e-3, generator=gen) if k == "mu"
                             else x.uniform_(1e-4, 1e-2, generator=gen))
        else:
            out[k] = v
    return out


def parallel_start_state(monitor: bool = False):
    """(config, class table, whole start state on the host, the unwrapped
    trainer holding it, the card's allocated bytes before that trainer was
    built): OFA-Base 512px, phase 15a's configuration without dropout, the
    weights of the seed and seeded Adam moments; every process builds the
    same.  The start state stays on the host, so that the card holds only
    what each strategy's trainer holds."""
    from ifseg_torch.train.trainer import Trainer

    cfg = train_config("bfloat16", monitor=monitor, dropout=False)
    tokens, lengths = class_table(SEED)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    ref = Trainer(cfg, tokens, lengths, total_num_updates=100).init_state()
    moments = seeded_moments(ref.optimizer.state_dict(),
                             torch.Generator(device="cuda").manual_seed(SEED))
    state = {"model": ref.state_dict()["model"],
             "optimizer": {k: ({n: t.cpu() for n, t in v.items()} if isinstance(v, dict) else v)
                           for k, v in moments.items()}}
    del moments
    ref.load_state_dict(state)
    return cfg, tokens, lengths, state, ref, base


def fsdp_prediction(trainer, whole):
    """The script's own count of what per-unit gathering saves against a
    whole-step gather: the fp32 bytes of the parameters split over 'fsdp'
    (``whole``: the whole start weights) and of their gradients (the
    trainable ones), less those of the largest unit other than the root
    (each layer, the token embedding, the stem), which is whole at once."""
    import re

    split = [n for n, lay in trainer.layouts.items() if "fsdp" in lay.values()]
    units = {}
    for n in split:
        m = re.match(r"((encoder|decoder)\.layers\.\d+|encoder\.embed_tokens|"
                     r"encoder\.embed_images)\.", n)
        b = whole[n].numel() * 4 * (2 if trainer.mask[n] else 1)
        if m:
            units[m.group(1)] = units.get(m.group(1), 0) + b
    params = sum(whole[n].numel() * 4 for n in split)
    grads = sum(whole[n].numel() * 4 for n in split if trainer.mask[n])
    largest = max(units, key=units.get)
    return dict(split_param_gib=params / 2**30, split_grad_gib=grads / 2**30,
                largest_unit=largest, largest_unit_gib=units[largest] / 2**30,
                saving_gib=(params + grads - units[largest]) / 2**30)


def memory_start(trainer):
    """Reset the card's peak, the collectives' counts and the FSDP
    tracker's peak before a strategy's steps; the card's allocated bytes."""
    from ifseg_torch.parallel import comm

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    comm.reset_traffic()
    if getattr(trainer, "fsdp", None) is not None:
        trainer.fsdp.tracker.reset_peak()
    return torch.cuda.memory_allocated()


def memory_read(trainer, base, start, steps):
    """After a strategy's ``steps`` steps: its peak above the card's bytes
    before its trainer was built (``base``: its own parameters, optimizer
    state, activations, gradients and transients) and above the step's
    start (``start``), the most whole FSDP bytes alive at once and the
    module's bound, and the all-gathers and reduce-scatters a step with the
    bytes each rank hands to them."""
    from ifseg_torch.parallel import comm

    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    fsdp = getattr(trainer, "fsdp", None)
    coll = {k: [comm.TRAFFIC[k][0] / steps, comm.TRAFFIC[k][1] / steps / 2**30]
            if k in comm.TRAFFIC else [0.0, 0.0] for k in ("all_gather", "reduce_scatter")}
    return dict(peak_over_base_gib=(peak - base) / 2**30, peak_over_start_gib=(peak - start) / 2**30,
                whole_gib=None if fsdp is None else fsdp.tracker.peak_bytes / 2**30,
                whole_units=None if fsdp is None else fsdp.tracker.peak_units,
                whole_bound_gib=None if fsdp is None else fsdp.max_whole_bytes() / 2**30,
                collectives=coll)


def memory_text(m, prediction=None) -> str:
    """``memory_read``'s figures (and a prediction) as a log fragment."""
    whole = ("no FSDP units" if m["whole_gib"] is None else
             f"whole FSDP bytes at most {m['whole_gib']:.3f} GiB at once ({m['whole_units']} unit(s) "
             f"besides the root; the module's bound {m['whole_bound_gib']:.3f} GiB)")
    c = m["collectives"]
    text = (f"peak {m['peak_over_base_gib']:.3f} GiB above the card's bytes before the build "
            f"({m['peak_over_start_gib']:.3f} GiB above the step's start), {whole}, a step "
            f"{c['all_gather'][0]:g} all-gathers ({c['all_gather'][1]:.3f} GiB handed) and "
            f"{c['reduce_scatter'][0]:g} reduce-scatters ({c['reduce_scatter'][1]:.3f} GiB)")
    if prediction is not None:
        text += (f"; predicted saving against a whole-step gather {prediction['saving_gib']:.3f} "
                 f"GiB (split parameters {prediction['split_param_gib']:.3f} + their gradients "
                 f"{prediction['split_grad_gib']:.3f} - the largest unit, "
                 f"{prediction['largest_unit']}, {prediction['largest_unit_gib']:.3f})")
    return text


def update_cosines(before, after, want):
    """min over the moved tensors of cos(after - before, want - before), the
    tensor that gives it, and the share of all the moved entries' squared
    update that differs."""
    worst, name, num, den = 1.0, None, 0.0, 0.0
    for k, w in want.items():
        if not w.is_floating_point():
            continue
        b = before[k].cuda()
        dw, da = (w.cuda() - b).double(), (after[k].cuda() - b).double()
        if not torch.any(dw):
            continue
        cos = float(torch.dot(dw.flatten(), da.flatten()) / (dw.norm() * da.norm()).clamp(min=1e-300))
        if cos < worst:
            worst, name = cos, k
        num += float((da - dw).square().sum())
        den += float(dw.square().sum())
    return worst, name, (num / max(den, 1e-300)) ** 0.5


def collective_ms(step) -> float:
    """The card's time in NCCL's kernels during one ``step()``, in ms, from
    a profiler trace.  (Over gloo, whose collectives on CUDA tensors run on
    the host, ``parallel.comm.TRAFFIC`` counts the host seconds in them.)"""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    us = 0.0
    for ev in prof.key_averages():
        if ("nccl" in ev.key.lower()
                and getattr(ev, "device_type", None) == torch.autograd.DeviceType.CUDA):
            t = getattr(ev, "self_device_time_total", None)
            us += t if t is not None else getattr(ev, "self_cuda_time_total", 0.0)
    return us / 1e3


def whole_model(trainer):
    """The trainer's whole parameters and buffers on the card, copied (a
    collective under a mesh)."""
    return {k: v.detach().clone() for k, v in trainer.whole_state().items()}


def phase_parallel_single(card: str, off_row: dict):
    """(a) each strategy on one process over NCCL (world size 1) against the
    unwrapped trainer: the same start, 2 + 5 steps at batch 16."""
    import copy

    import torch.distributed as dist

    from ifseg_torch.config import DistributedConfig
    from ifseg_torch.ops import flash_attention as fa
    from ifseg_torch.parallel.mesh import ProcessMesh
    from ifseg_torch.train.trainer import Trainer

    t_start = time.perf_counter()
    cfg, tokens, lengths, state, unwrapped, unwrapped_base = parallel_start_state()
    rng = np.random.default_rng(SEED + 17)
    batches = [train_batch(rng, TRAIN_BATCH, real=False) for _ in range(PAR_WARM + PAR_TIMED)]
    before = state["model"]

    def run(trainer, mesh, base, profile=False):
        torch.cuda.empty_cache()
        start = memory_start(trainer)
        fa.reset_launches()
        logs, times = [], []
        for b in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = trainer.train_step(b)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            logs.append(dict(loss=float(out["loss"]), gnorm=float(out["gnorm"]),
                             skipped=float(out["n_nonfinite"])))
        counts, routes = fa.launch_counts(), fa.bias_route_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        memory = memory_read(trainer, base, start, len(batches))
        after = whole_model(trainer)
        t0 = time.perf_counter()
        coll = collective_ms(lambda: trainer.train_step(batches[-1])) if profile else None
        return dict(logs=logs, s_per_step=float(np.mean(times[PAR_WARM:])), peak_gib=peak,
                    memory=memory, launches=counts, routes=routes, collective_ms=coll,
                    profile_s=time.perf_counter() - t0), after

    ref, ref_after = run(unwrapped, None, unwrapped_base)
    del unwrapped
    torch.cuda.empty_cache()
    store = tempfile.mkdtemp()
    dist.init_process_group("nccl", init_method=f"file://{store}/pg", world_size=1, rank=0,
                            device_id=torch.device("cuda", 0))
    out = {"unwrapped": ref}
    try:
        mesh = ProcessMesh((1, 1, 1), 0, "cuda")
        for name, (dist_kw, strategies) in PAR_STRATEGIES.items():
            t0 = time.perf_counter()
            scfg = copy.deepcopy(cfg)
            scfg.distributed = DistributedConfig(**dist_kw)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            # built on the start weights (no init of its own), then the whole
            # start state cut to this rank's parts
            trainer = Trainer(scfg, tokens, lengths, total_num_updates=100, mesh=mesh,
                              strategies=strategies).init_state(state["model"])
            trainer.load_state_dict(state)
            build_s = time.perf_counter() - t0
            prediction = (fsdp_prediction(trainer, state["model"]) if trainer.fsdp is not None
                          else None)
            res, after = run(trainer, mesh, base, profile=name in PAR_PROFILED)
            res["prediction"] = prediction
            del trainer
            torch.cuda.empty_cache()
            cos, worst, diff = update_cosines(before, after, ref_after)
            loss_err = max(abs(a["loss"] - b["loss"]) / abs(b["loss"])
                           for a, b in zip(res["logs"], ref["logs"]))
            gnorm_err = max(abs(a["gnorm"] - b["gnorm"]) / abs(b["gnorm"])
                            for a, b in zip(res["logs"], ref["logs"]))
            res.update(loss_rel=loss_err, gnorm_rel=gnorm_err, min_cosine=cos,
                       min_cosine_tensor=worst, update_rel=diff, build_s=build_s,
                       wall_s=time.perf_counter() - t0)
            log(f"[17a] {name} at degree 1 (NCCL, world 1), OFA-Base batch {TRAIN_BATCH}: "
                f"{res['s_per_step']:.4f} s/step, peak {res['peak_gib']:.2f} GiB, collectives "
                + (f"{res['collective_ms']:.3f} ms a step" if res["collective_ms"] is not None
                   else "not profiled (none launch at world 1)")
                + f"; {memory_text(res['memory'], prediction)}; beside the unwrapped trainer's "
                f"{ref['s_per_step']:.4f} s/step, {ref['peak_gib']:.2f} GiB ("
                f"{memory_text(ref['memory'])}) and phase 15a's off "
                f"row {off_row['s_per_step']:.4f} s/step and {off_row['max_memory_gib']:.2f} GiB; "
                f"against the unwrapped over {len(batches)} steps: loss {loss_err:.2e} relative "
                f"(tolerance {PAR_LOSS_TOL}), gnorm {gnorm_err:.2e} (tolerance {PAR_GNORM_TOL}), "
                f"parameter updates: least cosine {cos:.7f} ({worst}; tolerance "
                f"{PAR_COSINE_MIN}), ||Δ - Δ_ref|| / ||Δ_ref|| {diff:.2e}; launches "
                f"{res['launches']}, bias routes {res['routes']}; built in {build_s:.1f} s, the "
                f"profiled step {res['profile_s']:.1f} s, {res['wall_s']:.1f} s in all; on {card}")
            if (loss_err > PAR_LOSS_TOL or gnorm_err > PAR_GNORM_TOL or cos < PAR_COSINE_MIN
                    or any(lg["skipped"] for lg in res["logs"])):
                fail(f"[17a] {name} at degree 1 departs from the unwrapped trainer")
            if res["routes"]["fwd_bias_threads"] or res["routes"]["bwd_bias_copies"]:
                fail(f"[17a] {name}: a bias not fetched by TMA")
            out[name] = res
    finally:
        dist.destroy_process_group()
    out["wall_s"] = time.perf_counter() - t_start
    log(f"[17a] {out['wall_s']:.1f} s in all")
    return out


def free_ports(n: int):
    """``n`` distinct free ports (their sockets held open together)."""
    import socket

    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def start_ranks(argv_for_rank, n: int, log_prefix: str):
    """Start ``n`` processes (``argv_for_rank(rank)``), each writing its
    output to ``{log_prefix}{rank}.log``."""
    procs = []
    for r in range(n):
        with open(f"{log_prefix}{r}.log", "w") as out:
            procs.append(subprocess.Popen([sys.executable, *argv_for_rank(r)], cwd=REPO,
                                          stdout=out, stderr=subprocess.STDOUT))
    procs_logs = [(p, f"{log_prefix}{r}.log") for r, p in enumerate(procs)]
    return procs_logs


def stop_ranks(procs_logs):
    for p, _ in procs_logs:
        if p.poll() is None:
            p.kill()
            p.wait()


def wait_ranks(procs_logs, timeout: float, tag: str):
    """Wait for the processes of ``start_ranks`` to end, all killed once
    ``timeout`` s have passed; the end of a failed one's output goes into
    the failure message."""
    end = time.monotonic() + timeout
    try:
        for p, _ in procs_logs:
            p.wait(timeout=max(end - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        stop_ranks(procs_logs)
    bad = [r for r, (p, _) in enumerate(procs_logs) if p.returncode != 0]
    if bad:
        tails = "\n".join(f"rank {r}: {Path(procs_logs[r][1]).read_text()[-2500:]}" for r in bad)
        fail(f"[17] {tag}: rank(s) {bad} failed\n{tails}")


def parallel_worker(rank: int, port: int, out_path: str):
    """(b) in one of two processes sharing the card over gloo: the reference
    one-process step on the 16 rows (rank 0), then each strategy at degree 2
    on this rank's 8 rows; the results go to ``out_path``."""
    import copy

    import torch.distributed as dist

    from ifseg_torch.config import DistributedConfig
    from ifseg_torch.ops import flash_attention as fa
    from ifseg_torch.ops import layer_norm as ln
    from ifseg_torch.parallel import comm
    from ifseg_torch.parallel.mesh import batch_rows, initialize_distributed, mesh_from_config
    from ifseg_torch.train.trainer import Trainer
    from ifseg_torch.utils.reliability import check_grad_norms, check_param_sync

    t_start = time.perf_counter()
    device = torch.device("cuda", 0)
    initialize_distributed(f"127.0.0.1:{port}", 2, rank, device, backend="gloo")
    # the reference runs the monitoring forward too, for the monitored strategies
    cfg, tokens, lengths, state, ref, _ = parallel_start_state(monitor=True)
    rng = np.random.default_rng(SEED + 171)
    batch = train_batch(rng, TRAIN_BATCH, real=True)
    timed = train_batch(rng, TRAIN_BATCH, real=True)
    before = state["model"]
    result = dict(rank=rank, strategies={}, start_s=time.perf_counter() - t_start)
    scalars = lambda logs: {k: float(v) for k, v in logs.items()
                            if isinstance(v, torch.Tensor) and v.dim() == 0}
    areas = lambda logs: {k: v.cpu().tolist() for k, v in logs.items() if k.startswith("area")}
    if rank == 0:
        logs = ref.train_step(batch)
        ref_logs, ref_areas = scalars(logs), areas(logs)
        ref_after = whole_model(ref)
    del ref
    torch.cuda.empty_cache()
    dist.barrier()
    for name, kw in PAR_DEGREE2.items():
        t0 = time.perf_counter()
        scfg = copy.deepcopy(cfg)
        scfg.distributed = DistributedConfig(**kw)
        scfg.criterion.monitor_real_batch = name in PAR2_MONITORED
        mesh = mesh_from_config(scfg.distributed, device)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        trainer = Trainer(scfg, tokens, lengths, total_num_updates=100,
                          mesh=mesh).init_state(state["model"])
        trainer.load_state_dict(state)
        build_s = time.perf_counter() - t0
        idx = batch_rows(TRAIN_BATCH, mesh)
        rows = lambda b: {k: v[idx] for k, v in b.items()}
        start = memory_start(trainer)
        fa.reset_launches()
        ln.reset_launches()
        out = trainer.train_step(rows(batch))
        res = dict(scalars(out), launches=fa.launch_counts(), routes=fa.bias_route_counts(),
                   ln_launches=ln.LAUNCHES, monitored=name in PAR2_MONITORED,
                   grad_norms_agree=check_grad_norms(float(out["gnorm"]), group=mesh.host_group),
                   params_in_sync=check_param_sync(trainer.fingerprint(), group=mesh.host_group))
        if res["monitored"]:
            res["areas"] = areas(out)
        after = whole_model(trainer)
        scfg.criterion.monitor_real_batch = False  # the timed steps are the others' steps
        comm.reset_traffic()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        trainer.train_step(rows(timed))
        torch.cuda.synchronize()
        res.update(s_per_step=time.perf_counter() - t1,
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                   collective_ms=1e3 * sum(v[2] for v in comm.TRAFFIC.values()),
                   memory=memory_read(trainer, base, start, 1), build_s=build_s,
                   prediction=(fsdp_prediction(trainer, state["model"])
                               if trainer.fsdp is not None else None))
        if rank == 0:
            cos, worst, diff = update_cosines(before, after, ref_after)
            rel = lambda k: abs(res[k] - ref_logs[k]) / abs(ref_logs[k])
            res.update(ref=ref_logs, min_cosine=cos, min_cosine_tensor=worst, update_rel=diff,
                       loss_rel=rel("loss"), gnorm_rel=rel("gnorm"))
            if res["monitored"]:
                res.update(nll_rel=rel("nll_loss"), ref_areas=ref_areas)
        del trainer, after
        torch.cuda.empty_cache()
        res["wall_s"] = time.perf_counter() - t0
        result["strategies"][name] = res
    result["wall_s"] = time.perf_counter() - t_start
    Path(out_path).write_text(json.dumps(result))
    dist.destroy_process_group()


def phase_parallel_shared(card: str):
    """(b) two processes sharing the card, the fixed table's strategies at
    degree 2, each against one process's step on the same 16 rows."""
    log("[17b] two processes on one card: NCCL takes one rank a card, so they run over gloo; "
        "the strategies it lets run at degree 2: " + "; ".join(
            f"{k}: {v[0]} ({v[1]})" for k, v in GLOO_ON_ONE_CARD.items()))
    port, = free_ports(1)
    tmp = tempfile.mkdtemp()
    outs = [f"{tmp}/rank{r}.json" for r in range(2)]
    t0 = time.perf_counter()
    wait_ranks(start_ranks(lambda r: [str(Path(__file__).resolve()), "--parallel-worker",
                                      str(r), str(port), outs[r]], 2, f"{tmp}/rank"),
               900, "shared")
    wall = time.perf_counter() - t0
    res = [json.loads(Path(o).read_text()) for o in outs]
    summary = {}
    for name in PAR_DEGREE2:
        r0, r1 = res[0]["strategies"][name], res[1]["strategies"][name]
        monitored = ""
        if r0["monitored"]:
            same = [np.array_equal(r0["areas"][k], r0["ref_areas"][k]) for k in r0["ref_areas"]]
            monitored = (f"monitoring forward: nll_loss {r0['nll_loss']!r} against "
                         f"{r0['ref']['nll_loss']!r} ({r0['nll_rel']:.2e} relative, tolerance "
                         f"{PAR2_LOSS_TOL}), {sum(same)} of {len(same)} confusion areas equal, "
                         f"rank 1's logs equal to rank 0's: {r0['areas'] == r1['areas']}, K4 "
                         f"launches a rank {r0['ln_launches']} / {r1['ln_launches']}; ")
        log(f"[17b] {name} at degree 2 (gloo, two processes on the card): loss {r0['loss']!r} "
            f"against one process's {r0['ref']['loss']!r} ({r0['loss_rel']:.2e} relative, "
            f"tolerance {PAR2_LOSS_TOL}), gnorm {r0['gnorm']!r} against {r0['ref']['gnorm']!r} "
            f"({r0['gnorm_rel']:.2e}, tolerance {PAR2_GNORM_TOL}), parameter updates: least "
            f"cosine {r0['min_cosine']:.6f} ({r0['min_cosine_tensor']}; tolerance "
            f"{PAR2_COSINE_MIN}), ||Δ - Δ_ref|| / ||Δ_ref|| {r0['update_rel']:.2e}; {monitored}"
            f"check_grad_norms {r0['grad_norms_agree']} / {r1['grad_norms_agree']}, "
            f"check_param_sync {r0['params_in_sync']} / {r1['params_in_sync']}; "
            f"{r0['s_per_step']:.4f} / {r1['s_per_step']:.4f} s/step (the step after the "
            f"compared one), peak {r0['peak_gib']:.2f} / {r1['peak_gib']:.2f} GiB, host ms in "
            f"gloo collectives a step {r0['collective_ms']:.1f} / {r1['collective_ms']:.1f} by "
            f"rank; launches a rank {r0['launches']}, bias routes {r0['routes']} / "
            f"{r1['routes']}; built in {r0['build_s']:.1f} / {r1['build_s']:.1f} s, "
            f"{r0['wall_s']:.1f} / {r1['wall_s']:.1f} s in all; on {card}")
        for r, rr in enumerate((r0, r1)):
            log(f"[17b] {name} at degree 2, rank {r}, over the compared step and the one after: "
                f"{memory_text(rr['memory'], rr['prediction'])}; on {card}")
        if (r0["loss_rel"] > PAR2_LOSS_TOL or r0["gnorm_rel"] > PAR2_GNORM_TOL
                or r0["min_cosine"] < PAR2_COSINE_MIN or r0["loss"] != r1["loss"]
                or not all(r[k] for r in (r0, r1) for k in ("grad_norms_agree", "params_in_sync"))):
            fail(f"[17b] {name} at degree 2 departs from one process")
        if any(r["routes"]["fwd_bias_threads"] or r["routes"]["bwd_bias_copies"]
               for r in (r0, r1)):
            fail(f"[17b] {name} at degree 2: a bias not fetched by TMA")
        if r0["monitored"] and (r0["nll_rel"] > PAR2_LOSS_TOL or r0["areas"] != r1["areas"]
                                or min(r0["ln_launches"], r1["ln_launches"]) < 1):
            fail(f"[17b] {name} at degree 2: the monitoring forward departs from one process's")
        summary[name] = dict(rank0=r0, rank1=r1)
    # FSDP's point: its peak (its own tensors: shards, half the moments, one
    # unit whole at a time) below DDP's (whole parameters, moments and the
    # casts its layers save) by at least half of what per-unit gathering is
    # predicted to save against a whole-step gather
    for r in ("rank0", "rank1"):
        peaks = {k: v[r]["memory"]["peak_over_base_gib"] for k, v in summary.items()}
        above = {k: v[r]["memory"]["peak_over_start_gib"] for k, v in summary.items()}
        saving = summary["fsdp"][r]["prediction"]["saving_gib"]
        gap = peaks["ddp"] - peaks["fsdp"]
        log(f"[17b] {r}: peaks above the card's bytes before each build, GiB: "
            + ", ".join(f"{k} {v:.3f}" for k, v in peaks.items())
            + "; above the step's start: " + ", ".join(f"{k} {v:.3f}" for k, v in above.items())
            + f"; FSDP below DDP by {gap:.3f} GiB ({above['ddp'] - above['fsdp']:.3f} above the "
            f"step's start), half the predicted saving {saving / 2:.3f} GiB; on {card}")
        if gap < saving / 2:
            fail(f"[17b] {r}: FSDP's peak is {gap:.3f} GiB below DDP's, less than half the "
                 f"predicted saving of per-unit gathering ({saving:.3f} GiB)")
    log(f"[17b] {wall:.1f} s for both processes (start {res[0]['start_s']:.1f} / "
        f"{res[1]['start_s']:.1f} s: the start weights and the reference trainer; then four "
        f"strategies' trainers each)")
    return dict(table=GLOO_ON_ONE_CARD, strategies=summary, wall_s=wall)


def cli_worker(kind: str, argv_json: str, out_path: str):
    """(c) in one process of a two-process CLI run: the CLI's main; its
    summary, this rank's checkpoint writes and kernel launches go to
    ``out_path``."""
    from ifseg_torch.checkpoint import manager
    from ifseg_torch.config import from_flags
    from ifseg_torch.ops import flash_attention as fa
    from ifseg_torch.ops import layer_norm as ln

    writes = []
    write_state = manager.CheckpointManager._write_state

    def recorded(self, name, state):
        writes.append(name)
        return write_state(self, name, state)

    manager.CheckpointManager._write_state = recorded
    argv = json.loads(argv_json)
    fa.reset_launches()
    ln.reset_launches()
    if kind == "train":
        from ifseg_torch.cli import train

        run = train.main(from_flags(argv), device="cuda:0", backend="gloo")
        summary = dict(num_updates=run["num_updates"], stop=run["stop"],
                       saves=[s["name"] for s in run["saves"]],
                       valid=[e["valid"] for e in run["epochs"]],
                       step_s=[e["step_s"] for e in run["epochs"]])
    else:
        from ifseg_torch.cli import validate

        logs = []
        vals = validate.main(from_flags(argv), device="cuda:0", backend="gloo", logs_out=logs)
        summary = dict(vals=vals, areas={k: np.asarray(v).tolist()
                                         for k, v in summed_areas(logs).items()})
    summary.update(writes=writes, launches=fa.launch_counts(), ln_launches=ln.LAUNCHES)
    Path(out_path).write_text(json.dumps(summary, default=float))


def summed_areas(logs):
    """The confusion areas of per-group logs, summed in fp64."""
    return {k: np.sum([np.asarray(lg[k], np.float64) for lg in logs], axis=0)
            for k in logs[0] if k.startswith("area")}


def miou(areas, suffix=""):
    """The unrounded mIoU of summed areas (nanmean of intersect / union)."""
    with np.errstate(invalid="ignore", divide="ignore"):
        return float(np.nanmean(areas["area_intersect" + suffix] / areas["area_union" + suffix]))


def phase_parallel_cli(card: str, tmp: str, valid_tsv: str, ckpt_file: str):
    """(c) ``cli.train`` and ``cli.validate`` as a user runs them with two
    processes on the card (gloo), against one process.  The two-process
    runs of both CLIs and the one-process validation share no file, so they
    run side by side: their seconds are those of a shared card and host."""
    from ifseg_torch.checkpoint.manager import CheckpointManager
    from ifseg_torch.cli import validate as cli_validate
    from ifseg_torch.config import from_flags
    from ifseg_torch.train.trainer import Trainer

    train_tsv = f"{tmp}/train17.tsv"
    with open(valid_tsv) as src, open(train_tsv, "w") as dst:
        rows = src.readlines()
        dst.writelines((rows * -(-PAR_CLI_ROWS // len(rows)))[:PAR_CLI_ROWS])
    save = f"{tmp}/ckpt17"
    base = common_sh_argv(f"{train_tsv},{valid_tsv}", save, ckpt_file)
    base = [a for a in base if a not in RESET_FLAGS] + [
        f"--epoch-row-count={PAR_CLI_ROWS}", "--max-epoch=1", "--batch-size-valid=8",
        "--fsdp=2", "--check-param-sync-interval=1"]
    # validation of phase 11's rows, one row a forward (common.sh's
    # --batch-size-valid=1), so a row's result does not depend on its group
    vargv = ade_argv(valid_tsv, ckpt_file) + ["--batch-size-valid=1"]
    ports = dict(zip(("train", "validate"), free_ports(2)))

    def start(kind, argv):
        outs = [f"{tmp}/{kind}{r}.json" for r in range(2)]
        flags = lambda r: argv + ["--num-processes=2", f"--process-id={r}",
                                  f"--coordinator-address=127.0.0.1:{ports[kind]}"]
        procs = start_ranks(lambda r: [str(Path(__file__).resolve()), "--cli-worker", kind,
                                       json.dumps(flags(r)), outs[r]], 2, f"{tmp}/{kind}")
        return outs, procs

    t0 = time.perf_counter()
    train_outs, train_procs = start("train", base)
    valid_outs, valid_procs = start("validate", vargv)
    try:
        one_logs = []
        one = cli_validate.main(from_flags(vargv), logs_out=one_logs)
        one_s = time.perf_counter() - t0
        wait_ranks(valid_procs, 900, "validate")
        two_s = time.perf_counter() - t0
        wait_ranks(train_procs, 900, "train")
        train_s = time.perf_counter() - t0
    finally:
        stop_ranks(train_procs + valid_procs)
    runs = [json.loads(Path(o).read_text()) for o in train_outs]
    vruns = [json.loads(Path(o).read_text()) for o in valid_outs]

    a, b = runs
    log(f"[17c] cli.train --num-processes=2 --fsdp=2 (gloo, both on the card), common.sh + "
        f"ade.sh flags, {PAR_CLI_ROWS} rows at batch {TRAIN_BATCH}: {a['num_updates']} / "
        f"{b['num_updates']} updates, validation {a['valid'][0]}, saves {a['saves']} written by "
        f"rank 0 ({a['writes']}) and rank 1 ({b['writes']}), step s {a['step_s']}, "
        f"{train_s:.1f} s for both processes (beside the validations below); launches by rank "
        f"{a['launches']} / {b['launches']}, layer_norm {a['ln_launches']} / "
        f"{b['ln_launches']}; on {card}")
    if not (a["num_updates"] == b["num_updates"] == PAR_CLI_ROWS // TRAIN_BATCH
            and a["writes"] and a["writes"] == a["saves"] and not b["writes"]
            and a["valid"] == b["valid"] and a["valid"][0] is not None):
        fail("[17c] the two-process cli.train run")

    # the checkpoint into one process, and back out equal to the files
    ckpt = CheckpointManager(from_flags(base).checkpoint)
    saved = ckpt.load(ckpt.latest())
    trainer = Trainer(from_flags([a for a in base if a != "--fsdp=2"]),
                      total_num_updates=100).init_state()
    trainer.load_state_dict(saved)
    now = trainer.state_dict()
    same = all(torch.equal(now["model"][k], v) for k, v in saved["model"].items())
    same &= all(torch.equal(now["optimizer"][m][k], v) for m in ("mu", "nu")
                for k, v in saved["optimizer"][m].items())
    same &= now["step"] == saved["step"] == a["num_updates"]
    del trainer
    torch.cuda.empty_cache()
    log(f"[17c] one-process resume of {ckpt.latest()}: model and Adam state equal to the files: "
        f"{same}")
    if not same:
        fail("[17c] the one-process resume differs from the two-process checkpoint")

    one_areas = summed_areas(one_logs)
    two_areas = {k: np.asarray(v) for k, v in vruns[0]["areas"].items()}
    log(f"[17c] cli.validate on phase 11's {VALID_ROWS} rows, one row a forward: two processes "
        f"{vruns[0]['vals']} ({two_s:.1f} s) against one process {dict(one)} ({one_s:.1f} s; "
        f"both beside the two-process cli.train); unrounded mIoU {miou(two_areas)!r} against "
        f"{miou(one_areas)!r}, after label propagation "
        f"{miou(two_areas, '_resnet_postprocess')!r} against "
        f"{miou(one_areas, '_resnet_postprocess')!r}; pixels counted "
        f"{one_areas['area_label'].sum():.0f}; every area equal: "
        f"{all(np.array_equal(two_areas[k], v) for k, v in one_areas.items())}; on {card}")
    for r in vruns:
        areas = {k: np.asarray(v) for k, v in r["areas"].items()}
        if (r["vals"]["num_images"] != one["num_images"] or areas.keys() != one_areas.keys()
                or not all(np.array_equal(areas[k], v) for k, v in one_areas.items())):
            fail("[17c] cli.validate on two processes: its areas and mIoU are not the "
                 "one-process ones")
    return dict(train=runs, train_s=train_s, resume_equal=bool(same), validate=vruns,
                validate_one=dict(one), validate_s=two_s, validate_one_s=one_s,
                miou=miou(one_areas), miou_two=miou(two_areas))


# ---------------------------------------------------------------- phase 18

# the model axis's programs on two processes sharing the card over gloo (as
# 17b), OFA-Base batch 16, 17b's start: the pipeline at 2 and 4 microbatches
# and the ring against one process's step on the 16 rows (17b's
# tolerances), the pipeline at 2 and the ring also with the monitoring
# forward; the experts (no one-process step to compare with) with Sinkhorn
# and with the auction, one of their layers held against the dense loop
MODEL_AXIS = {
    "pipeline_c2": dict(pipeline_parallel=2, pipeline_chunks=2),
    "pipeline_c4": dict(pipeline_parallel=2, pipeline_chunks=4),
    "context": dict(context_parallel=2),
    "moe_sinkhorn": dict(moe_experts=2, moe_freq=2),
    "moe_auction": dict(moe_experts=2, moe_freq=2, moe_assignment="auction"),
}
MODEL_AXIS_COMPARED = ("pipeline_c2", "pipeline_c4", "context")
MODEL_AXIS_MONITORED = ("pipeline_c2", "context")
MOE_CHECK_LAYER = "encoder.layers.1.moe"  # the first expert layer (moe_freq 2)
MOE_REL_TOL = 1e-3  # base_moe_layer against the dense loop, ||Δ|| / ||ref||, bf16 rows


def moe_start(state, gen):
    """17b's start state with, in each MoE layer (every moe_freq-th), the
    whole (E, ...) expert tensors in place of its dense FFN, drawn on the
    card from ``gen`` with the JAX initializers' scales."""
    from ifseg_torch.parallel.moe import init_moe_params

    kw = MODEL_AXIS["moe_sinkhorn"]
    cfg = train_config("bfloat16", monitor=False, dropout=False).model
    out = dict(state)
    for side in ("encoder", "decoder"):
        n, d, f = (getattr(cfg, f"{side}_{k}") for k in ("layers", "embed_dim", "ffn_embed_dim"))
        for i in range(kw["moe_freq"] - 1, n, kw["moe_freq"]):
            base = f"{side}.layers.{i}"
            for k in [k for k in out if k.startswith((f"{base}.fc", f"{base}.ffn_layernorm"))]:
                del out[k]
            for k, v in init_moe_params(gen, kw["moe_experts"], d, f).items():
                out[f"{base}.moe.{k}"] = v
    return out


def moe_layer_check(trainer, x):
    """One MoE layer of ``trainer`` (its weights after the step, this rank's
    expert) on the step's real activations ``x`` (the layer's input rows):
    ``base_moe_layer`` against the dense loop over the whole experts, the
    tokens each expert got in each rank's slice, and the auction's total
    score against Sinkhorn's on this rank's slice."""
    from ifseg_torch.ops.balanced_assignment import (
        balanced_assignment_auction,
        balanced_assignment_sinkhorn,
    )
    from ifseg_torch.parallel import comm
    from ifseg_torch.parallel.moe import ASSIGNMENTS, base_moe_layer, dense_reference

    plan = trainer.plan
    mod = dict(trainer.model.named_modules())[MOE_CHECK_LAYER]
    e = plan.moe_experts
    flat = x.reshape(-1, x.shape[-1])
    flat = flat[:flat.shape[0] - flat.shape[0] % (e * e)]
    params = {"centroids": mod.centroids, "wi": mod.wi, "wo": mod.wo}
    with torch.no_grad():
        got = base_moe_layer(params, flat, plan.group, plan.moe_assignment)
        whole = {k: comm.all_gather_dim(v.detach(), 0, plan.group) for k, v in params.items()}
        want = dense_reference(whole, flat, e, ASSIGNMENTS[plan.moe_assignment])
        per = flat.shape[0] // e
        counts, totals = [], {}
        for sl in range(e):
            scores = flat[sl * per:(sl + 1) * per].float() @ whole["centroids"].float().t()
            counts.append(torch.bincount(ASSIGNMENTS[plan.moe_assignment](scores),
                                         minlength=e).tolist())
            if sl == plan.index:
                rows = torch.arange(per, device=scores.device)
                for name, fn in (("sinkhorn", balanced_assignment_sinkhorn),
                                 ("auction", balanced_assignment_auction)):
                    totals[name] = float(scores[rows, fn(scores)].sum())
    rel = float((got.float() - want.float()).norm() / want.float().norm().clamp(min=1e-30))
    return dict(rel=rel, rows=int(flat.shape[0]), cap=per // e, counts=counts, totals=totals)


def model_axis_worker(rank: int, port: int, out_path: str):
    """Phase 18 in one of two processes sharing the card over gloo: the
    reference one-process step on the 16 rows (rank 0), then each program
    of MODEL_AXIS: a compared step (the counts set to 0 before, read after)
    and a timed one (the collectives' calls, bytes and host seconds); the
    results go to ``out_path``."""
    import copy

    import torch.distributed as dist

    from ifseg_torch.config import DistributedConfig
    from ifseg_torch.ops import flash_attention as fa
    from ifseg_torch.ops import layer_norm as ln
    from ifseg_torch.parallel import comm
    from ifseg_torch.parallel.mesh import batch_rows, initialize_distributed, mesh_from_config
    from ifseg_torch.train.trainer import Trainer

    t_start = time.perf_counter()
    device = torch.device("cuda", 0)
    initialize_distributed(f"127.0.0.1:{port}", 2, rank, device, backend="gloo")
    cfg, tokens, lengths, state, ref, _ = parallel_start_state(monitor=True)
    rng = np.random.default_rng(SEED + 181)
    batch = train_batch(rng, TRAIN_BATCH, real=True)
    timed = train_batch(rng, TRAIN_BATCH, real=True)
    result = dict(rank=rank, programs={}, start_s=time.perf_counter() - t_start)
    scalars = lambda logs: {k: float(v) for k, v in logs.items()
                            if isinstance(v, torch.Tensor) and v.dim() == 0}
    if rank == 0:
        ref_logs = scalars(ref.train_step(batch))
        ref_after = whole_model(ref)
    del ref
    torch.cuda.empty_cache()
    moe_state = None
    dist.barrier()
    for name, kw in MODEL_AXIS.items():
        t0 = time.perf_counter()
        scfg = copy.deepcopy(cfg)
        scfg.distributed = DistributedConfig(**kw)
        scfg.criterion.monitor_real_batch = name in MODEL_AXIS_MONITORED
        mesh = mesh_from_config(scfg.distributed, device)
        moe = name.startswith("moe")
        if moe and moe_state is None:
            moe_state = moe_start(state["model"], torch.Generator(device="cuda").manual_seed(SEED))
        trainer = Trainer(scfg, tokens, lengths, total_num_updates=100, mesh=mesh).init_state(
            moe_state if moe else state["model"])
        if moe:  # seeded moments for the experts' model too
            trainer.load_state_dict({"optimizer": seeded_moments(
                trainer.optimizer.state_dict(), torch.Generator(device="cuda").manual_seed(SEED))})
        else:
            trainer.load_state_dict(state)
        before = whole_model(trainer) if moe else state["model"]
        build_s = time.perf_counter() - t0
        idx = batch_rows(TRAIN_BATCH, mesh)
        rows = lambda b: {k: v[idx] for k, v in b.items()}
        captured = {}
        hook = (dict(trainer.model.named_modules())[MOE_CHECK_LAYER].register_forward_hook(
            lambda m, args, out: captured.setdefault("x", args[0].detach())) if moe else None)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launches()
        ln.reset_launches()
        out = trainer.train_step(rows(batch))
        res = dict(scalars(out), launches=fa.launch_counts(), routes=fa.bias_route_counts(),
                   ln_launches=ln.LAUNCHES, monitored=name in MODEL_AXIS_MONITORED)
        after = whole_model(trainer)
        if hook is not None:
            hook.remove()
            res["moe_check"] = moe_layer_check(trainer, captured["x"])
            moved = [k for k in after if ".moe." in k and not torch.equal(after[k], before[k])]
            res["experts_moved"] = len(moved)
        scfg.criterion.monitor_real_batch = False  # the timed step is the training step alone
        comm.reset_traffic()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        trainer.train_step(rows(timed))
        torch.cuda.synchronize()
        res.update(s_per_step=time.perf_counter() - t1,
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                   traffic={k: list(v) for k, v in comm.TRAFFIC.items()},
                   gloo_ms=1e3 * sum(v[2] for v in comm.TRAFFIC.values()), build_s=build_s)
        if rank == 0 and name in MODEL_AXIS_COMPARED:
            cos, worst, diff = update_cosines(before, after, ref_after)
            rel = lambda k: abs(res[k] - ref_logs[k]) / abs(ref_logs[k])
            res.update(ref=ref_logs, min_cosine=cos, min_cosine_tensor=worst, update_rel=diff,
                       loss_rel=rel("loss"), gnorm_rel=rel("gnorm"))
            if res["monitored"]:
                res["nll_rel"] = rel("nll_loss")
        del trainer, after
        torch.cuda.empty_cache()
        res["wall_s"] = time.perf_counter() - t0
        result["programs"][name] = res
    result["wall_s"] = time.perf_counter() - t_start
    Path(out_path).write_text(json.dumps(result))
    dist.destroy_process_group()


def phase_model_axis(card: str):
    """Phase 18: the model axis's programs (MODEL_AXIS) on two processes
    sharing the card over gloo, through ``Trainer.train_step``."""
    from ifseg_torch.parallel.comm import PPERMUTE_ROUTE

    log("[18] the model axis's programs on two processes sharing the card (gloo): a ppermute "
        f"as {PPERMUTE_ROUTE['gloo']}, the all-to-all as all_to_all_single")
    port, = free_ports(1)
    tmp = tempfile.mkdtemp()
    outs = [f"{tmp}/rank{r}.json" for r in range(2)]
    t0 = time.perf_counter()
    wait_ranks(start_ranks(lambda r: [str(Path(__file__).resolve()), "--model-axis-worker",
                                      str(r), str(port), outs[r]], 2, f"{tmp}/rank"),
               900, "model axis")
    wall = time.perf_counter() - t0
    res = [json.loads(Path(o).read_text()) for o in outs]
    summary = {}
    for name in MODEL_AXIS:
        r0, r1 = res[0]["programs"][name], res[1]["programs"][name]
        traffic = "; ".join(
            f"{k} {r0['traffic'][k][0]} calls, {r0['traffic'][k][1] / 2**20:.1f} MiB, "
            f"{1e3 * r0['traffic'][k][2]:.1f} ms" for k in sorted(r0["traffic"]))
        line = (f"[18] {name}: loss {r0['loss']!r} / {r1['loss']!r}, gnorm {r0['gnorm']!r}; "
                f"{r0['s_per_step']:.4f} / {r1['s_per_step']:.4f} s/step (the step after the "
                f"compared one), peak {r0['peak_gib']:.2f} / {r1['peak_gib']:.2f} GiB, host ms in "
                f"gloo a step {r0['gloo_ms']:.1f} / {r1['gloo_ms']:.1f} by rank; rank 0's "
                f"collectives a step: {traffic}; launches a rank {r0['launches']} / "
                f"{r1['launches']}, K4 {r0['ln_launches']} / {r1['ln_launches']}, bias routes "
                f"{r0['routes']}; built in {r0['build_s']:.1f} s, {r0['wall_s']:.1f} s in all")
        if name in MODEL_AXIS_COMPARED:
            line += (f"; against one process's step: loss {r0['ref']['loss']!r} "
                     f"({r0['loss_rel']:.2e} relative, tolerance {PAR2_LOSS_TOL}), gnorm "
                     f"{r0['ref']['gnorm']!r} ({r0['gnorm_rel']:.2e}, tolerance "
                     f"{PAR2_GNORM_TOL}), least update cosine {r0['min_cosine']:.6f} "
                     f"({r0['min_cosine_tensor']}; tolerance {PAR2_COSINE_MIN}), "
                     f"||Δ - Δ_ref|| / ||Δ_ref|| {r0['update_rel']:.2e}")
            if r0["monitored"]:
                line += (f", monitoring nll_loss {r0['nll_loss']!r} against "
                         f"{r0['ref']['nll_loss']!r} ({r0['nll_rel']:.2e})")
        if "moe_check" in r0:
            for rank, r in enumerate((r0, r1)):
                c = r["moe_check"]
                line += (f"; rank {rank} {MOE_CHECK_LAYER} on the step's {c['rows']} rows: "
                         f"||Δ|| / ||dense|| {c['rel']:.2e} (tolerance {MOE_REL_TOL}), tokens an "
                         f"expert by slice {c['counts']} (cap {c['cap']}), total score auction "
                         f"{c['totals']['auction']!r} / Sinkhorn {c['totals']['sinkhorn']!r}, "
                         f"expert tensors moved {r['experts_moved']}")
        log(line + f"; on {card}")
        if r0["loss"] != r1["loss"] or not np.isfinite(r0["loss"]):
            fail(f"[18] {name}: the ranks' losses differ or are not finite")
        if any(r["routes"]["fwd_bias_threads"] or r["routes"]["bwd_bias_copies"]
               for r in (r0, r1)):
            fail(f"[18] {name}: a bias not fetched by TMA")
        if name in MODEL_AXIS_COMPARED and (
                r0["loss_rel"] > PAR2_LOSS_TOL or r0["gnorm_rel"] > PAR2_GNORM_TOL
                or r0["min_cosine"] < PAR2_COSINE_MIN
                or (r0["monitored"] and r0["nll_rel"] > PAR2_LOSS_TOL)):
            fail(f"[18] {name} departs from one process's step")
        for r in (r0, r1) if "moe_check" in r0 else ():
            c = r["moe_check"]
            if (c["rel"] > MOE_REL_TOL or any(n != c["cap"] for row in c["counts"] for n in row)
                    or c["totals"]["auction"] < c["totals"]["sinkhorn"] - 1e-3 * abs(
                        c["totals"]["sinkhorn"]) or r["experts_moved"] < 6):
                fail(f"[18] {name}: the expert layer check failed: {c}, "
                     f"moved {r['experts_moved']}")
        summary[name] = dict(rank0=r0, rank1=r1)
    log(f"[18] {wall:.1f} s for both processes (start {res[0]['start_s']:.1f} / "
        f"{res[1]['start_s']:.1f} s)")
    return dict(programs=summary, wall_s=wall, ppermute_route=PPERMUTE_ROUTE["gloo"])


# ---------------------------------------------------------------- phase 19: the training run's surface

SURFACE_ROWS = 32  # phase 19's epochs: 2 steps of TRAIN_BATCH
# LightConv / DynamicConv at OFA-Base's width over the decoder's 1,025
# tokens: (kernel, heads) the JAX defaults and a wide kernel; each causal
# and not, forward and backward, bf16 and fp32, timed at the training batch
# and held to the CPU's fp32 on LIGHTCONV_CHECK_ROWS rows
LIGHTCONV_CASES = ((3, 4), (31, 16))
LIGHTCONV_TOKENS = 1025
LIGHTCONV_CHECK_ROWS = 2
# ||Δ|| / ||ref|| of the output and of each gradient against the CPU's fp32:
# the card's fp32 sums in another order; bf16 rounds the input, the kernels
# and the output (2^-8), as phase 7's gradient tolerance allows
LIGHTCONV_FP32_TOL, LIGHTCONV_BF16_TOL = 1e-5, GRAD_REL_TOL
# the four training kernels in each train_step span of a monitored batch-16 step
SPAN_KERNELS = ("stats", "bwd_di", "bwd_dq", "bwd_dkv")


def _crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), bit by bit: the script's own, for reading the
    event file the port wrote."""
    crc = 0xFFFFFFFF
    for b in data:
        crc ^= b
        for _ in range(8):
            crc = (crc >> 1) ^ (0x82F63B78 & -(crc & 1))
    return crc ^ 0xFFFFFFFF


def _masked(crc: int) -> int:
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(data: bytes, i: int):
    """(the protocol-buffer varint at ``data[i]``, the offset after it)."""
    value, shift = 0, 0
    while True:
        b = data[i]
        i += 1
        value |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return value, i


def _proto_fields(data: bytes):
    """(field number, value) of a serialized protocol buffer: varints as
    ints, fixed64 / fixed32 as raw bytes, length-delimited as bytes."""
    out, i = [], 0
    while i < len(data):
        key, i = _varint(data, i)
        field, wire = key >> 3, key & 7
        if wire == 0:
            v, i = _varint(data, i)
        elif wire in (1, 5):
            n = 8 if wire == 1 else 4
            v, i = data[i:i + n], i + n
        elif wire == 2:
            n, i = _varint(data, i)
            v, i = data[i:i + n], i + n
        else:
            fail(f"[19] event file: wire type {wire} of field {field}")
        out.append((field, v))
    return out


def read_event_file(path: str):
    """(file_version, [(tag, step, value)]) of a TensorBoard event file,
    each TFRecord's length and data CRCs checked."""
    import struct

    data = Path(path).read_bytes()
    i, version, scalars = 0, None, []
    while i < len(data):
        length = struct.unpack("<Q", data[i:i + 8])[0]
        if struct.unpack("<I", data[i + 8:i + 12])[0] != _masked(_crc32c(data[i:i + 8])):
            fail(f"[19] event file {path}: a record's length CRC is wrong")
        record = data[i + 12:i + 12 + length]
        if struct.unpack("<I", data[i + 12 + length:i + 16 + length])[0] != _masked(
                _crc32c(record)):
            fail(f"[19] event file {path}: a record's data CRC is wrong")
        i += 16 + length
        fields = dict(_proto_fields(record))  # Event: 1 wall_time, 2 step, 3 version, 5 summary
        if 3 in fields:
            version = fields[3].decode()
        for f, summary_value in _proto_fields(fields.get(5, b"")):  # Summary: 1 value
            value = dict(_proto_fields(summary_value))  # Value: 1 tag, 2 simple_value
            scalars.append((value[1].decode(), fields.get(2, 0),
                            struct.unpack("<f", value[2])[0]))
    return version, scalars


def card_generator_state(seed: int) -> torch.Tensor:
    """The state of a card's generator seeded with ``seed``."""
    return torch.Generator(device="cuda").manual_seed(seed).get_state()


def kernel_family(name: str):
    """The port's kernel a trace's kernel name is, or None: the demangled
    ``void (anonymous namespace)::attn_bias_fwd_kernel<__nv_bfloat16, true,
    64>(...)`` (its STATS argument tells K1-stats from K1), or mangled."""
    import re

    m = re.search(r"attn_bias_fwd_kernel(?:<[^,<>]+, (true|false),|I\w+?L(b[01])E)", name)
    if m:
        return "stats" if m.group(1) == "true" or m.group(2) == "b1" else "infer"
    for key, family in (("attn_bwd_di_kernel", "bwd_di"), ("attn_bias_bwd_dq_kernel", "bwd_dq"),
                        ("attn_bias_bwd_dkv_kernel", "bwd_dkv")):
        if key in name:
            return family
    if re.search(r"(?<![\w:])(?:\(anonymous namespace\)::)?layer_norm(?:_wide)?_kernel\b",
                 name.replace("at::native::", "at_native_")):
        return "layer_norm"
    return None


def spans_and_kernels(trace_dir: str):
    """From the Chrome trace ``profile_to`` wrote: each ``train_step-{i}``
    span (host) and, inside it, the port's kernels by family, each kernel
    placed by its launch on the host (its own start on the card when the
    trace has no launch event for it)."""
    traces = sorted(Path(trace_dir).glob("*.pt.trace.json"))
    if len(traces) != 1:
        fail(f"[19] profile_to wrote {len(traces)} traces to {trace_dir}")
    events = json.loads(traces[0].read_text())["traceEvents"]
    spans = [e for e in events if e.get("cat") == "user_annotation"
             and str(e.get("name", "")).startswith("train_step-")]
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in events
                 if e.get("cat") in ("cuda_runtime", "cuda_driver")
                 and "correlation" in e.get("args", {})}
    kernels = [(kernel_family(e["name"]), launch_ts.get(e.get("args", {}).get("correlation"),
                                                         e["ts"]))
               for e in events if e.get("cat") == "kernel"]
    by_span = {}
    for s in spans:
        counts = {}
        for fam, ts in kernels:
            if fam is not None and s["ts"] <= ts <= s["ts"] + s["dur"]:
                counts[fam] = counts.get(fam, 0) + 1
        by_span.setdefault(s["name"], []).append(counts)
    n_kernels = sum(1 for fam, _ in kernels if fam is not None)
    n_placed = sum(1 for e in events if e.get("cat") == "kernel"
                   and e.get("args", {}).get("correlation") in launch_ts)
    return by_span, dict(trace_mib=traces[0].stat().st_size / 2**20, events=len(events),
                         port_kernels=n_kernels, placed_by_launch=n_placed)


def phase_run_surface(card: str, tmp: str, valid_tsv: str, ckpt_file: str):
    """Phase 19 (a) and (b): ``cli.train`` with spans and the TensorBoard
    mirror under ``profile_to``, then a run resumed from a save directory of
    the layout ``tools/orbax_to_torch.py`` writes."""
    from numbers import Number

    from ifseg_torch.checkpoint.manager import CheckpointManager
    from ifseg_torch.cli import train as cli_train
    from ifseg_torch.config import from_flags
    from ifseg_torch.ops import flash_attention as fa
    from ifseg_torch.ops import layer_norm as ln
    from ifseg_torch.train.trainer import Trainer
    from ifseg_torch.utils import metrics as metrics_lib
    from ifseg_torch.utils.profiling import profile_to

    train_tsv = f"{tmp}/surface_train.tsv"
    with open(valid_tsv) as src, open(train_tsv, "w") as dst:
        rows = src.readlines()
        dst.writelines((rows * -(-SURFACE_ROWS // len(rows)))[:SURFACE_ROWS])
    tb_dir, trace_dir = f"{tmp}/surface_tb", f"{tmp}/surface_trace"

    def flags(save_dir, *extra, resets=True):
        argv = common_sh_argv(f"{train_tsv},{valid_tsv}", save_dir, ckpt_file)
        argv = [a for a in argv if resets or a not in RESET_FLAGS]
        # no validation and no save: the phase reads the steps; an EMA copy,
        # so the converter's ema.pt is in the layout
        return from_flags(argv + [f"--epoch-row-count={SURFACE_ROWS}", "--validate-interval=3",
                                  "--log-interval=1", "--no-save", "--ema-decay=0.999",
                                  f"--num-workers={CLI_WORKERS}", *extra])

    last, logged, restored = {}, [], []
    step, make_bar, restore = Trainer.train_step, cli_train.progress_bar, cli_train.restore_training_state

    def recording_step(self, batch):
        last["trainer"] = self
        return step(self, batch)

    def recording_bar(*a, **kw):
        bar = make_bar(*a, **kw)
        inner = getattr(bar, "bar", bar)
        for kind in ("log", "print"):
            def call(stats, tag=None, step=None, _f=getattr(inner, kind)):
                logged.append((tag or inner.tag or "train", step or inner.i, dict(stats)))
                return _f(stats, tag, step)
            setattr(inner, kind, call)
        return bar

    def checked_restore(cfg, trainer, ckpt):
        name = ckpt.latest()
        out = restore(cfg, trainer, ckpt)
        if name is None:
            return out
        saved, now = ckpt.load(name), trainer.state_dict()
        seed = cfg.optimization.seed + int(saved["step"])
        restored.append(dict(
            name=name, epoch=out[0], step=now["step"],
            model=all(torch.equal(now["model"][k], v) for k, v in saved["model"].items()),
            ema=saved.get("ema") is None or all(torch.equal(now["ema"][k], v)
                                                for k, v in saved["ema"].items()),
            optimizer=now["optimizer"]["count"] == saved["optimizer"]["count"] and all(
                torch.equal(now["optimizer"][m][k], v) for m in ("mu", "nu")
                for k, v in saved["optimizer"][m].items()),
            generator=torch.equal(now["generator"], card_generator_state(seed)),
            plateau="plateau" not in saved))
        return out

    Trainer.train_step, cli_train.progress_bar = recording_step, recording_bar
    cli_train.restore_training_state = checked_restore
    result = {}
    try:
        # ---- (a) 2 updates with spans and the TensorBoard mirror, under profile_to
        fa.reset_launches()
        ln.reset_launches()
        cfg = flags(f"{tmp}/surface_a", "--max-epoch=1", f"--tensorboard-logdir={tb_dir}")
        t0 = time.perf_counter()
        with profile_to(trace_dir):
            run = cli_train.main(cfg)
            torch.cuda.synchronize()
        main_s = time.perf_counter() - t0
        counts, ln_launches = fa.launch_counts(), ln.LAUNCHES
        steps = run["num_updates"]
        t0 = time.perf_counter()
        by_span, trace = spans_and_kernels(trace_dir)
        trace["read_s"] = time.perf_counter() - t0
        per_step = sum(n for *_, n in SITES)
        want_spans = [f"train_step-{i}" for i in range(steps)]
        log(f"[19a] cli.train.main, recipe + --tensorboard-logdir under profile_to: {steps} "
            f"updates in {main_s:.1f} s; attention launches {counts}, layer_norm launches "
            f"{ln_launches}; trace {trace}; spans {by_span}; on {card}")
        if steps != 2 or sorted(by_span) != want_spans or any(len(v) != 1 for v in by_span.values()):
            fail(f"[19a] the trace does not hold one train_step span an update: {sorted(by_span)}")
        for name, (inside,) in by_span.items():
            if any(inside.get(k, 0) != per_step for k in SPAN_KERNELS):
                fail(f"[19a] {name}: the training kernels did not launch {per_step} times each "
                     f"inside the span: {inside}")
        if {k: counts[k] for k in SPAN_KERNELS} != {k: per_step * steps for k in SPAN_KERNELS}:
            fail(f"[19a] the training kernels' counts {counts} are not {per_step} a step")
        events = sorted(Path(tb_dir).glob("events.out.tfevents.*"))
        if len(events) != 1:
            fail(f"[19a] {len(events)} event files in {tb_dir}")
        version, scalars = read_event_file(str(events[0]))
        want = [(f"{tag}/{k}", st, float(np.float32(v))) for tag, st, stats in logged
                for k, v in stats.items() if isinstance(v, Number)]
        log(f"[19a] event file {events[0].name}: {version}, {len(scalars)} scalars (the logged "
            f"stats give {len(want)}); first {scalars[:3]}")
        if version != "brain.Event:2" or scalars != want or len(want) < 2 * steps:
            fail("[19a] the event file's scalars are not the logged stats")
        result["spans"] = dict(launches=counts, ln_launches=ln_launches, main_s=main_s,
                               steps=steps, by_span=by_span, trace=trace,
                               scalars=len(scalars), event_file=events[0].name,
                               step_s=run["epochs"][0]["step_s"])
        trainer = last.pop("trainer")

        # ---- (b) a save directory of the converter's layout, resumed
        state = trainer.state_dict()
        del trainer
        converted = f"{tmp}/surface_converted"
        mgr = CheckpointManager(cfg.checkpoint, save_dir=converted)
        mgr.write("checkpoint_1", {
            "model": state["model"], "ema": state["ema"], "optimizer": state["optimizer"],
            "step": state["step"]})
        with open(f"{converted}/checkpoint_1.extra.json", "w") as fp:  # as the JAX CLI writes it
            json.dump({"epoch": 1, "metrics": metrics_lib.state_dict()}, fp,
                      default=lambda o: o.tolist())
        mgr.adopt_manifest({"best": None, "best_metric": None, "bests": [], "intervals": [],
                            "epochs": [{"epoch": 1, "name": "checkpoint_1"}],
                            "last": "checkpoint_1"})
        del state
        files = sorted(p.name for p in Path(converted, "checkpoint_1").iterdir())
        links = {k: Path(converted, k).resolve().name for k in ("checkpoint_last",)}
        fa.reset_launches()
        ln.reset_launches()
        t0 = time.perf_counter()
        # no pretrained file to load first: the restored state replaces the weights
        resumed = cli_train.main(flags(converted, "--max-epoch=2", "--restore-file=",
                                       resets=False))
        torch.cuda.synchronize()
        resume_s = time.perf_counter() - t0
        rcounts, rln = fa.launch_counts(), ln.LAUNCHES
        log(f"[19b] a save directory of tools/orbax_to_torch.py's layout ({files}, links "
            f"{links}): cli.train resumed at epoch {resumed['start_epoch']} with "
            f"{resumed['restored_updates']} updates restored, {resumed['num_updates']} at the "
            f"end, in {resume_s:.1f} s; restored {restored}; launches {rcounts}, layer_norm "
            f"{rln}; on {card}")
        if files != ["ema.pt", "model.pt", "optimizer.pt", "step.pt"]:
            fail(f"[19b] the converted layout holds {files}")
        if ((resumed["start_epoch"], resumed["restored_updates"], resumed["num_updates"])
                != (2, steps, 2 * steps) or len(restored) != 1
                or not all(restored[0][k] for k in ("model", "ema", "optimizer", "generator",
                                                    "plateau"))):
            fail("[19b] the resume did not start at the saved epoch and update with the saved "
                 "state and the generator seeded from the step")
        if {k: rcounts[k] for k in SPAN_KERNELS} != {k: per_step * steps for k in SPAN_KERNELS}:
            fail(f"[19b] the resumed steps' training kernels {rcounts}")
        result["converted_resume"] = dict(launches=rcounts, ln_launches=rln, main_s=resume_s,
                                          restored=restored, files=files,
                                          step_s=resumed["epochs"][0]["step_s"])
    finally:
        Trainer.train_step, cli_train.progress_bar = step, make_bar
        cli_train.restore_training_state = restore
    return result


def rel_norm_err(got, want) -> float:
    want = want.double()
    return float((got.double().cpu() - want).norm() / want.norm().clamp_min(1e-30))


def phase_lightconv(card: str):
    """Phase 19 (c): ``LightConv`` and ``DynamicConv`` at OFA-Base's width
    over 1,025 tokens: forward and backward in bf16 and fp32 on the card
    against the CPU's fp32 on the first rows (the same weights, input and
    cotangent), and ms a call at the training batch."""
    import copy

    from ifseg_torch.models.lightconv import DynamicConv, LightConv

    d, rows_all = BASE["width"], TRAIN_BATCH
    gen = torch.Generator().manual_seed(SEED)
    x_all = torch.randn(rows_all, LIGHTCONV_TOKENS, d, generator=gen)
    cot_all = torch.randn(rows_all, LIGHTCONV_TOKENS, d, generator=gen)
    out, worst = [], {"float32": 0.0, "bfloat16": 0.0}
    for kind in ("LightConv", "DynamicConv"):
        for k, h in LIGHTCONV_CASES:
            for causal in (False, True):
                mod = (LightConv(k, h, causal) if kind == "LightConv"
                       else DynamicConv(d, k, h, causal)).init(torch.Generator().manual_seed(k))
                if kind == "LightConv":  # past the near-uniform init
                    with torch.no_grad():
                        mod.weight.mul_(20.0)

                def run(m, x, cot):
                    m.zero_grad(set_to_none=True)
                    x = x.detach().requires_grad_(True)
                    y = m(x)
                    (y.float() * cot).sum().backward()
                    return y.detach(), x.grad, [p.grad for p in m.parameters()]

                rows = LIGHTCONV_CHECK_ROWS
                ref = run(mod, x_all[:rows], cot_all[:rows])
                card_mod = copy.deepcopy(mod).cuda()
                row = dict(module=kind, kernel=k, heads=h, causal=causal)
                for dtype in (torch.float32, torch.bfloat16):
                    name = str(dtype).split(".")[1]
                    x, cot = x_all.cuda().to(dtype), cot_all.cuda()
                    got = run(card_mod, x[:rows], cot[:rows])
                    errs = [rel_norm_err(got[0], ref[0]), rel_norm_err(got[1], ref[1])] + [
                        rel_norm_err(g, r) for g, r in zip(got[2], ref[2])]
                    worst[name] = max(worst[name], max(errs))
                    with torch.no_grad():
                        fwd = cuda_ms(lambda: card_mod(x), iters=5)
                    both = cuda_ms(lambda: run(card_mod, x, cot), iters=3)
                    row[name] = dict(max_rel_err=max(errs), fwd_ms=fwd, fwd_bwd_ms=both)
                    tol = LIGHTCONV_FP32_TOL if dtype == torch.float32 else LIGHTCONV_BF16_TOL
                    if max(errs) > tol or not all(torch.isfinite(t).all() for t in got[:2]):
                        fail(f"[19c] {kind} k {k} h {h} causal {causal} {name}: card against "
                             f"the CPU's fp32 {errs} (tolerance {tol})")
                out.append(row)
                log(f"[19c] {kind}, kernel {k}, {h} heads, causal {causal}, d {d}, "
                    f"{LIGHTCONV_TOKENS} tokens: fp32 {row['float32']['fwd_ms']:.3f} ms forward, "
                    f"{row['float32']['fwd_bwd_ms']:.3f} ms forward + backward, bf16 "
                    f"{row['bfloat16']['fwd_ms']:.3f} / {row['bfloat16']['fwd_bwd_ms']:.3f} ms "
                    f"at batch {rows_all}; card against the CPU's fp32 on {rows} rows: fp32 "
                    f"{row['float32']['max_rel_err']:.2e}, bf16 {row['bfloat16']['max_rel_err']:.2e}"
                    f"; on {card}")
                del card_mod
    torch.cuda.empty_cache()

    # the synthetic task of the throughput benchmark: made on the card when no
    # device is given, as Trainer, Evaluator and SegServer are
    from ifseg_torch.benchmark.dummy_seg import DummySegTask

    task = DummySegTask(train_config("bfloat16", monitor=True))
    batch = next(task.batches(1, TRAIN_BATCH))
    devices = sorted({str(t.device) for t in [task.class_tokens, *batch.values()]})
    log(f"[19c] DummySegTask() with no device: {devices}, patch_images "
        f"{tuple(batch['patch_images'].shape)}; on {card}")
    if devices != ["cuda:0"]:
        fail(f"[19c] DummySegTask() made its tensors on {devices}, not the card")
    return dict(cases=out, worst_rel_err=worst, check_rows=LIGHTCONV_CHECK_ROWS,
                batch=rows_all, tokens=LIGHTCONV_TOKENS,
                tolerance=dict(float32=LIGHTCONV_FP32_TOL, bfloat16=LIGHTCONV_BF16_TOL))


def model_axis_paths(model_axis):
    """Phase 18's launch counts by path, both ranks' summed: (the training
    kernels' paths: each program's compared step; K1's and K4's: the
    monitored programs' forwards)."""
    add = lambda runs: {k: sum(r[k] for r in runs) for k in runs[0]}
    progs = model_axis["programs"]
    train = {f"model_axis_{k}": add([v["rank0"]["launches"], v["rank1"]["launches"]])
             for k, v in progs.items()}
    monitored = [k for k, v in progs.items() if v["rank0"]["monitored"]]
    k1 = {f"model_axis_{k}_monitoring": sum(r["launches"]["infer"] for r in progs[k].values())
          for k in monitored}
    ln = {f"model_axis_{k}_monitoring": sum(r["ln_launches"] for r in progs[k].values())
          for k in monitored}
    return train, k1, ln


def parallel_paths(parallel):
    """Phase 17's launch counts by path: (the training kernels' paths: each
    strategy at degree 1 over NCCL, at degree 2 on one card over gloo with
    both ranks' counts, and the two-process cli.train; K1's paths: the
    two-process cli.train's monitoring forwards and validation, the
    two-process cli.validate, the monitored strategies' forwards at degree
    2; K4's paths: the same)."""
    add = lambda runs: {k: sum(r[k] for r in runs) for k in runs[0]}
    cli17, shared = parallel["cli"], parallel["shared"]["strategies"]
    train = {f"parallel_{k}_degree1": v["launches"] for k, v in parallel["single"].items()
             if k in PAR_STRATEGIES}
    train.update({f"parallel_{k}_degree2": add([v["rank0"]["launches"], v["rank1"]["launches"]])
                  for k, v in shared.items()})
    train["parallel_cli_train"] = add([r["launches"] for r in cli17["train"]])
    monitored = [k for k, v in shared.items() if v["rank0"]["monitored"]]
    k1 = dict(parallel_cli_train=train["parallel_cli_train"]["infer"],
              parallel_validate=sum(r["launches"]["infer"] for r in cli17["validate"]),
              **{f"parallel_{k}_monitoring_degree2": sum(r["launches"]["infer"]
                                                         for r in shared[k].values())
                 for k in monitored})
    ln = dict(parallel_cli_train=sum(r["ln_launches"] for r in cli17["train"]),
              parallel_validate=sum(r["ln_launches"] for r in cli17["validate"]),
              **{f"parallel_{k}_monitoring_degree2": sum(r["ln_launches"]
                                                         for r in shared[k].values())
                 for k in monitored})
    return train, k1, ln


PHASE_S = {}  # seconds of each group of phases, in the order they ran
_MARK = [time.perf_counter()]


def mark(tag: str) -> None:
    """Log the seconds since the previous mark as ``tag``'s."""
    now = time.perf_counter()
    PHASE_S[tag] = round(now - _MARK[0], 1)
    _MARK[0] = now
    log(f"[time] {tag}: {PHASE_S[tag]} s")


def main():
    card = phase_card()
    sys.path.insert(0, str(REPO))

    ptxas = phase_build()
    mark("1-2 card and build")
    sites = phase_kernels()
    ln_rows, ln_train = phase_layer_norm()
    train_rows = phase_train_kernels()
    # the head-dim-80 instantiations and the CTA-per-row K4 at Huge's shapes
    huge_sites = phase_kernels(HUGE, HUGE_SERVE_BATCH, "[3 huge]")
    huge_ln_rows, _ = phase_layer_norm(HUGE_LN_PATHS, "[3n huge]")
    huge_train_rows = phase_train_kernels(HUGE, HUGE_TRAIN_BATCH, "[3t huge]")
    # phase 15's SegOFA-Huge step at batch 32: its sites checked, not timed
    phase_train_kernels(HUGE, HUGE_REMAT_BATCH, f"[3t huge b{HUGE_REMAT_BATCH}]",
                        checks_only=True)
    mark("3 kernels")
    torch.cuda.empty_cache()
    server, weights, serve = phase_serve(card)
    cpu = phase_cpu_reference(server, weights)
    del server
    torch.cuda.empty_cache()
    evaluator, wide, evaluation = phase_eval(card, weights)
    evaluation.update(phase_eval_reference(evaluator, wide, weights))
    del evaluator, weights
    torch.cuda.empty_cache()
    train = phase_train(card)
    grads = phase_train_gradients()
    mark("4-9 serving, evaluation, training")

    huge = dict(serve=phase_huge_serve(card), logits=phase_huge_logits())
    trainer, huge["train"] = phase_huge_train(card)
    huge["evaluation"] = phase_huge_eval(card, trainer)
    del trainer
    torch.cuda.empty_cache()
    huge["gradients"] = phase_train_gradients(
        HUGE["arch"], GRAD_TENSORS_HUGE, "[10]", encoder_layers=HUGE_CHECK_LAYERS,
        decoder_layers=HUGE_CHECK_LAYERS)
    mark("10 SegOFA-Huge")
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        validate = phase_validate(card, tmp)
        mark("11 validate")
        torch.cuda.empty_cache()
        train_cli = phase_train_cli(card, tmp, validate["tsv"], validate["ckpt"],
                                    len(validate["group_sizes"]))
        mark("12 train CLI")
        torch.cuda.empty_cache()
        codecs, jpeg_files = phase_codecs(card)
        codecs["image_files"], image_files = phase_image_files(card, codecs["sizes"])
        surface = phase_serving_surface(card, tmp, validate["ckpt"], jpeg_files, image_files)
        torch.cuda.empty_cache()
        converted = phase_convert_validate(card, tmp, validate["ckpt"], jpeg_files)
        mark("13-14 serving surface, image files")
        torch.cuda.empty_cache()
        stack = dict(remat=phase_remat(card, huge["train"]["max_memory_gib"]))
        stack["optimizers"] = phase_optimizers(card)
        stack["train_cli"] = phase_train_cli_stack(card, tmp, validate["tsv"], validate["ckpt"])
        mark("15 training stack")
        torch.cuda.empty_cache()
        options = dict(prefix=phase_prefix_train(card, stack["remat"]["ofa_base"]["off"]))
        options["flags"] = phase_options(card, tmp, validate["tsv"], validate["ckpt"])
        mark("16a-b options")
        torch.cuda.empty_cache()
        parallel = dict(cli=phase_parallel_cli(card, tmp, validate["tsv"], validate["ckpt"]))
        mark("17c two-process CLIs")
        torch.cuda.empty_cache()
        run_surface = phase_run_surface(card, tmp, validate["tsv"], validate["ckpt"])
    torch.cuda.empty_cache()
    run_surface["lightconv"] = phase_lightconv(card)
    mark("19 the training run's surface")
    options["served"] = phase_prefix_eval_serve(card)
    options["generate"] = phase_generate(card)
    mark("16c-d prompted serving, generation")
    torch.cuda.empty_cache()
    parallel["single"] = phase_parallel_single(card, stack["remat"]["ofa_base"]["off"])
    parallel["shared"] = phase_parallel_shared(card)
    mark("17a-b strategies")
    model_axis = phase_model_axis(card)
    mark("18 model axis")

    fwd_src = "ifseg_torch/csrc/flash_attention_bias_fwd.cu"
    dq_src = "ifseg_torch/csrc/flash_attention_bias_bwd_dq.cu"
    dkv_src = "ifseg_torch/csrc/flash_attention_bias_bwd_dkv.cu"
    jax_fa = "ifseg_tpu/ops/flash_attention.py"
    step_unit = "one batch-16 training step: 6 calls at each of the three site shapes"
    counts, cli_counts = train["launches"], train_cli["launches"]
    # phase 15's training paths, each driven with the counts set to 0 before
    # and read after: OFA-Base under each checkpointing policy (full runs the
    # forward with stats again in the backward), the CLI with the stack's
    # flags, its resume and its pruned run
    remat, stack_cli = stack["remat"], stack["train_cli"]
    stack_paths = {f"remat_{name.replace('-', '_')}": r["launches"]
                   for name, r in remat["ofa_base"].items()}
    stack_paths.update(train_cli_stack=stack_cli["launches"],
                       train_cli_stack_resume=stack_cli["resume_launches"],
                       train_cli_stack_pruned=stack_cli["pruned_launches"])
    # phase 16's training paths (prefix tuning, with the projection, adapters,
    # BitFit, gelu_poly; cli.train with --bitfit and with --encoder-prompt),
    # each driven with the counts set to 0 before and read after
    flags16 = options["flags"]
    stack_paths.update(prefix_training=options["prefix"]["plain"]["launches"],
                       prefix_training_projection=options["prefix"]["projection"]["launches"],
                       **{f"{k}_training": v["launches"] for k, v in flags16["runs"].items()},
                       train_cli_bitfit=flags16["cli"]["--bitfit"]["launches"],
                       train_cli_prompt=flags16["cli"]["--encoder-prompt"]["launches"])
    # phase 17's paths, each driven with the counts set to 0 before and read after
    par_train, par_k1, par_ln = parallel_paths(parallel)
    stack_paths.update(par_train)
    # phase 18's paths (each program's compared step, both ranks), the same way
    ma_train, ma_k1, ma_ln = model_axis_paths(model_axis)
    stack_paths.update(ma_train)
    # phase 19's: cli.train under profile_to with the TensorBoard mirror, and
    # the run resumed from the converter's layout, each the same way
    stack_paths.update(train_cli_spans=run_surface["spans"]["launches"],
                       train_cli_converted_resume=run_surface["converted_resume"]["launches"])
    served16, gen16 = options["served"], options["generate"]
    # the forward without stats runs on these main paths; each was driven with
    # the counts set to 0 just before and read just after
    k1_paths = dict(serving=serve["launches"], evaluation=evaluation["launches"],
                    monitoring=counts["infer"], validate=validate["launches"],
                    train_cli=cli_counts["infer"], serve_daemon=surface["daemon"]["launches"],
                    infer=surface["infer"]["launches"],
                    serve_daemon_jpeg=surface["daemon_jpeg"]["launches"],
                    infer_jpeg=surface["infer_jpeg"]["launches"],
                    **{f"infer_cmyk_to_{ext[1:]}": r["launches"]
                       for ext, r in surface["infer_formats"].items() if ext.startswith(".")},
                    infer_jpeg2000=surface["infer_formats"]["jpeg2000"]["launches"],
                    validate_converted=converted["launches"],
                    **{k: v["infer"] for k, v in stack_paths.items() if k.startswith("train_cli")},
                    evaluation_prefix=served16["eval_launches"]["infer"],
                    serving_prompted=served16["serve_launches"]["infer"],
                    generate_recompute=gen16["recompute"]["launches"]["infer"],
                    **par_k1, **ma_k1)
    ln_paths = dict(serving=serve["ln_launches"], evaluation=evaluation["ln_launches"],
                    monitoring=train["ln_launches"], validate=validate["ln_launches"],
                    train_cli=train_cli["ln_launches"],
                    serve_daemon=surface["daemon"]["ln_launches"],
                    infer=surface["infer"]["ln_launches"],
                    serve_daemon_jpeg=surface["daemon_jpeg"]["ln_launches"],
                    infer_jpeg=surface["infer_jpeg"]["ln_launches"],
                    **{f"infer_cmyk_to_{ext[1:]}": r["ln_launches"]
                       for ext, r in surface["infer_formats"].items() if ext.startswith(".")},
                    infer_jpeg2000=surface["infer_formats"]["jpeg2000"]["ln_launches"],
                    validate_converted=converted["ln_launches"],
                    train_cli_stack=stack_cli["ln_launches"],
                    train_cli_stack_resume=stack_cli["resume_ln_launches"],
                    train_cli_stack_pruned=stack_cli["pruned_ln_launches"],
                    train_cli_bitfit=flags16["cli"]["--bitfit"]["ln_launches"],
                    train_cli_prompt=flags16["cli"]["--encoder-prompt"]["ln_launches"],
                    train_cli_spans=run_surface["spans"]["ln_launches"],
                    train_cli_converted_resume=run_surface["converted_resume"]["ln_launches"],
                    evaluation_prefix=served16["eval_ln_launches"],
                    serving_prompted=served16["serve_ln_launches"],
                    generate_recompute=gen16["recompute"]["launches"]["layer_norm"],
                    **par_ln, **ma_ln,
                    huge_serving=huge["serve"]["ln_launches"] - huge["serve"]["ln_wide_launches"],
                    huge_evaluation=(huge["evaluation"]["ln_launches"]
                                     - huge["evaluation"]["ln_wide_launches"]))
    kernels = [
        kernel_entry("flash_attention_bias_fwd", fwd_src, f"{jax_fa}:134", sum(k1_paths.values()),
                     sites, "one batch-32 forward: 6 calls at each of the three site shapes",
                     "per_forward"),
        kernel_entry("flash_attention_bias_fwd_stats", fwd_src, f"{jax_fa}:134",
                     counts["stats"] + cli_counts["stats"]
                     + sum(v["stats"] for v in stack_paths.values()), train_rows["stats"],
                     step_unit, "per_step"),
        kernel_entry("flash_attention_bwd_di", dq_src, f"{jax_fa}:484",
                     counts["bwd_di"] + cli_counts["bwd_di"]
                     + sum(v["bwd_di"] for v in stack_paths.values()), train_rows["di"],
                     step_unit, "per_step"),
        kernel_entry("flash_attention_bias_bwd_dq", dq_src, f"{jax_fa}:373",
                     counts["bwd_dq"] + cli_counts["bwd_dq"]
                     + sum(v["bwd_dq"] for v in stack_paths.values()), train_rows["dq"],
                     step_unit, "per_step"),
        kernel_entry("flash_attention_bias_bwd_dkv", dkv_src, f"{jax_fa}:420",
                     counts["bwd_dkv"] + cli_counts["bwd_dkv"]
                     + sum(v["bwd_dkv"] for v in stack_paths.values()), train_rows["dkv"],
                     step_unit, "per_step"),
        kernel_entry("layer_norm", "ifseg_torch/csrc/layer_norm.cu",
                     "ifseg_tpu/ops/layer_norm.py:43", sum(ln_paths.values()), ln_rows,
                     "one batch-32 forward: its 65 LayerNorm sites at their six (rows, width) "
                     "shapes", "per_forward"),
    ]
    kernels[0]["launches_by_path"] = k1_paths
    for entry, key, rows_key in zip(kernels[1:5], ("stats", "bwd_di", "bwd_dq", "bwd_dkv"),
                                    ("stats", "di", "dq", "dkv")):
        entry["launches_by_path"] = dict(training=counts[key], train_cli=cli_counts[key],
                                         **{k: v[key] for k, v in stack_paths.items()})
        entry["per_pass"] = {f"prefix-tuned batch-{TRAIN_BATCH} step (P {PROMPT_LEN}): 6 calls "
                             "at each self-attention's P + L keys and at the cross-attention":
                                 pass_totals(train_rows[rows_key], "per_prefix_step")}
    kernels[0]["per_pass"] = {"evaluation group of 8": pass_totals(sites, "per_eval_group"),
                              "validate group of 8, 215 text tokens":
                                  pass_totals(sites, "per_validate_group")}
    kernels[-1]["launches_by_path"] = ln_paths
    kernels[-1]["per_pass"] = {
        "evaluation group of 8": pass_totals(ln_rows, "per_eval_group"),
        "validate group of 8, 215 text tokens": pass_totals(ln_rows, "per_validate_group"),
        f"monitoring forward, batch {TRAIN_BATCH}": pass_totals(ln_rows, "per_monitor_forward"),
    }
    kernels[-1]["training_site"] = ln_train

    # the head-dim-80 instantiations and the CTA-per-row K4, from SegOFA-Huge's paths
    enc, dec = HUGE["enc_layers"], HUGE["dec_layers"]
    huge_fwd_unit = (f"one SegOFA-Huge batch-{HUGE_SERVE_BATCH} served forward: {enc}, {dec} and "
                     f"{dec} calls at the three site shapes")
    huge_step_unit = (f"one SegOFA-Huge batch-{HUGE_TRAIN_BATCH} training step: {enc}, {dec} and "
                      f"{dec} calls at the three site shapes")
    hc, hr = huge["train"]["launches"], remat["huge"]["launches"]
    k1_80_paths = dict(huge_serving=huge["serve"]["launches"],
                       huge_evaluation=huge["evaluation"]["launches"])
    wide_paths = dict(huge_serving=huge["serve"]["ln_wide_launches"],
                      huge_evaluation=huge["evaluation"]["ln_wide_launches"])
    huge_kernels = [
        kernel_entry("flash_attention_bias_fwd, head dim 80", fwd_src, f"{jax_fa}:134",
                     sum(k1_80_paths.values()), huge_sites, huge_fwd_unit, "per_forward"),
        kernel_entry("flash_attention_bias_fwd_stats, head dim 80", fwd_src, f"{jax_fa}:134",
                     hc["stats"] + hr["stats"], huge_train_rows["stats"], huge_step_unit,
                     "per_step"),
        kernel_entry("flash_attention_bwd_di, head dim 80", dq_src, f"{jax_fa}:484",
                     hc["bwd_di"] + hr["bwd_di"], huge_train_rows["di"], huge_step_unit,
                     "per_step"),
        kernel_entry("flash_attention_bias_bwd_dq, head dim 80", dq_src, f"{jax_fa}:373",
                     hc["bwd_dq"] + hr["bwd_dq"], huge_train_rows["dq"], huge_step_unit,
                     "per_step"),
        kernel_entry("flash_attention_bias_bwd_dkv, head dim 80", dkv_src, f"{jax_fa}:420",
                     hc["bwd_dkv"] + hr["bwd_dkv"], huge_train_rows["dkv"], huge_step_unit,
                     "per_step"),
        kernel_entry("layer_norm, a CTA a row (widths above 4,096)", "ifseg_torch/csrc/layer_norm.cu",
                     "ifseg_tpu/ops/layer_norm.py:43", sum(wide_paths.values()),
                     [r for r in huge_ln_rows if r["width"] > 4096],
                     f"one SegOFA-Huge batch-{HUGE_SERVE_BATCH} served forward: its {enc + dec} "
                     f"ffn_layernorm sites of width {HUGE['ffn']}", "per_forward"),
    ]
    huge_kernels[0]["launches_by_path"] = k1_80_paths
    for entry, key in zip(huge_kernels[1:5], ("stats", "bwd_di", "bwd_dq", "bwd_dkv")):
        entry["launches_by_path"] = dict(huge_training=hc[key], huge_remat_auto=hr[key])
    huge_kernels[0]["per_pass"] = {
        "SegOFA-Huge evaluation group of 8": pass_totals(huge_sites, "per_eval_group")}
    huge_kernels[-1]["launches_by_path"] = wide_paths
    huge_kernels[-1]["per_pass"] = {
        "SegOFA-Huge evaluation group of 8": pass_totals(
            [r for r in huge_ln_rows if r["width"] > 4096], "per_eval_group")}
    kernels += huge_kernels
    for entry in kernels:
        if entry["launches"] < 1 or any(n < 1 for n in entry.get("launches_by_path", {}).values()):
            fail(f"kernel {entry['name']} was never launched by a main path")
    log(json.dumps({"serve": serve, "cpu_reference": cpu, "evaluation": evaluation,
                    "train": train, "train_gradients": grads, "huge": huge, "validate": validate,
                    "train_cli": train_cli, "serving_surface": surface, "codecs": codecs,
                    "converted": converted, "training_stack": stack, "options": options,
                    "parallel": parallel, "model_axis": model_axis,
                    "run_surface": run_surface, "phase_s": PHASE_S, "ptxas": ptxas,
                    "card_line": card}))
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    # phase 17's worker processes enter here; run with no arguments, the smoke run
    if len(sys.argv) > 1 and sys.argv[1] == "--parallel-worker":
        sys.path.insert(0, str(REPO))
        parallel_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    elif len(sys.argv) > 1 and sys.argv[1] == "--model-axis-worker":
        sys.path.insert(0, str(REPO))
        model_axis_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    elif len(sys.argv) > 1 and sys.argv[1] == "--cli-worker":
        sys.path.insert(0, str(REPO))
        cli_worker(sys.argv[2], sys.argv[3], sys.argv[4])
    else:
        main()
