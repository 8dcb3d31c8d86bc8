#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (an H100 is the target).

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when it fails:
  1. the card: name and power limit (nvidia-smi), torch and CUDA versions;
  2. build every kernel with nvcc (one process per source, all at once),
     with the ``-Xptxas -v`` summary, and the HGMMA count and shared memory
     of the three wgmma attention libraries;
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
     every case; the host time of a launch's tensor-map encodes; the
     LayerNorm kernel at every (rows, width, dtype) that a served batch-32
     forward, an evaluation group of 8 at the (512, 768) bucket and a
     monitoring forward at batch 16 give it (the fp32 position LayerNorms
     included), a ragged row count, a narrow and the widest width, and its
     autograd Function's forward + backward beside ``F.layer_norm``'s;
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
 10. one JSON line listing every kernel, the nvidia-smi line, and the last
     line ``{"ok": true, "device": {...}}``.

It imports nothing of JAX and nothing of the JAX package ``ifseg_tpu``.
"""

import json
import subprocess
import sys
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
EVAL_CLASSES = 150
TRAIN_BATCH = 16
TRAIN_CLASSES = 15


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
    from ifseg_torch.ops import build
    from ifseg_torch.ops import flash_attention as fa
    from ifseg_torch.ops import layer_norm as ln

    t0 = time.perf_counter()
    results = build.build([*fa.KERNELS, ln.KERNEL])
    log(f"[2] built {sorted(results)} in {time.perf_counter() - t0:.1f} s")
    for res in results.values():
        log(f"[2] {res.name}: {res.path.name}, nvcc {res.seconds:.1f} s")
        shown = set()
        for line in res.log.splitlines():  # registers, spills, stack, warnings of every kernel
            text = line.strip()
            if ("registers" in line or "spill" in line or "error" in line.lower()
                    or "warning" in line.lower()) and text not in shown:
                shown.add(text)  # a template's instantiations repeat their lines
                log(f"[2]   {text}")
    # the attention kernels' products must run on the warpgroup tensor-core
    # path: (library, kernel name, instantiations)
    for lib, kernel, n in ((fa.KERNEL, "attn_bias_fwd_kernel", 4),
                           (fa.KERNEL_BWD_DQ, "attn_bias_bwd_dq_kernel", 4),
                           (fa.KERNEL_BWD_DKV, "attn_bias_bwd_dkv_kernel", 2)):
        hgmma = {k: c for k, c in sass_counts(results[lib].path, "HGMMA").items() if kernel in k}
        log(f"[2] {lib}: HGMMA operations per instantiation (cuobjdump -sass): "
            f"{sorted(hgmma.values())} over {len(hgmma)} kernels; one CTA of 384 threads an SM, "
            f"dynamic shared memory {fa.smem_bytes(lib, False)} bytes with a bf16 bias, "
            f"{fa.smem_bytes(lib, True)} with an fp32 bias (of 232,448)")
        if len(hgmma) != n or min(hgmma.values()) < 1:
            fail(f"{lib}: the SASS shows no HGMMA in some instantiation: {hgmma}")


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

# The three attention sites of the served forward at OFA-Base 512px,
# src_len 32: (name, Lq, Lk, causal, key-padding mask, sites per forward).
SITES = [
    ("encoder self", 1024 + SRC_LEN, 1024 + SRC_LEN, False, True, 6),
    ("decoder self", 1 + 1024, 1 + 1024, True, False, 6),
    ("decoder cross", 1 + 1024, 1024 + SRC_LEN, False, True, 6),
]


# The three attention sites of an evaluation group at the (512, 768) bucket:
# a padded grid of 32 x 48 cells of which 32 x 43 are valid, so the padded
# cells are masked as keys at every site, and decoder self-attention is causal
# with a key mask; (name, Lq, Lk, causal, sites per group forward).
EVAL_GRID = (32, 48, 32, 43)  # padded (Hp, Wp), valid (hp, wp)
EVAL_ROWS = 8
EVAL_SITES = [
    ("eval encoder self", 32 * 48 + SRC_LEN, 32 * 48 + SRC_LEN, False, 6),
    ("eval decoder self", 1 + 32 * 48, 1 + 32 * 48, True, 6),
    ("eval decoder cross", 1 + 32 * 48, 32 * 48 + SRC_LEN, False, 6),
]


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


def site_inputs(b, h, lq, lk, causal, masked, bias_dtype, seed):
    from ifseg_torch.ops.flash_attention import HEAD_DIM

    g = torch.Generator(device="cuda").manual_seed(seed)
    e = h * HEAD_DIM

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * scale

    q = rnd(b, lq, e, scale=0.3).bfloat16()
    k = rnd(b, lk, e, scale=0.3).bfloat16()
    v = rnd(b, lk, e).bfloat16()
    bias = rnd(h, lq, lk).to(bias_dtype)
    mask = None
    if masked == "eval":
        mask = eval_key_mask(b, lk)
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


def phase_kernels():
    from ifseg_torch.ops import flash_attention as fa

    h = 12
    rows = []
    # every bias of the main paths comes in row-padded storage (the decoder's
    # 1,025 or 1,537 keys a row become a pitch of 1,032 or 1,544)
    cases = [(name, 32, lq, lk, causal, masked, torch.bfloat16, True, n, 0)
             for name, lq, lk, causal, masked, n in SITES]
    # a small ragged shape with an fp32 bias, checked but not timed
    cases.append(("ragged check", 3, 77, 130, True, True, torch.float32, False, 0, 0))
    cases += [(name, EVAL_ROWS, lq, lk, causal, "eval", torch.bfloat16, True, 0, n)
              for name, lq, lk, causal, n in EVAL_SITES]
    cases += [(*case, 0, 0) for case in EDGE_CASES]
    for i, (name, b, lq, lk, causal, masked, bias_dtype, padded, per_fwd,
            per_group) in enumerate(cases):
        q, k, v, bias, mask = site_inputs(b, h, lq, lk, causal, masked,
                                          bias_dtype or torch.bfloat16, seed=i)
        bias = None if bias_dtype is None else fa.row_padded(bias) if padded else bias
        out = fa.flash_attention_bias_packed_infer(q, k, v, bias, mask, causal, h)
        torch.cuda.synchronize()
        want = fa.attention_bias_reference(q.float(), k.float(), v.float(),
                                           None if bias is None else bias.float(), mask, causal, h)
        err = (out.float() - want).abs().max().item()
        finite = bool(torch.isfinite(out).all())
        del want, out
        log(f"[3] {name}: B={b} Lq={lq} Lk={lk} causal={causal} mask={masked} "
            f"bias={None if bias is None else str(bias_dtype).split('.')[-1]} "
            f"pitch={None if bias is None else bias.stride(1)}: max_abs_err={err:.3e}")
        if not finite or not err <= ATTN_TOL:
            fail(f"kernel disagrees with its plain version at {name}: {err} > {ATTN_TOL}")
        row = dict(site=name, B=b, Lq=lq, Lk=lk, causal=causal, per_forward=per_fwd,
                   per_eval_group=per_group, max_abs_err=err)
        if per_fwd or per_group:
            flops, nbytes = attention_work(b, h, lq, lk, fa.HEAD_DIM, causal,
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
                log(f"[3]   scaled_dot_product_attention failed: {exc}")
                row["library_ms"] = None
            row["share_of_bound"] = row["bound_ms"] / row["kernel_ms"]
            # what the host pays per launch to encode the call's TMA tensor maps
            row["encode_host_us"] = fa.tensor_map_encode_us(q, k, v, bias, h)
            log(f"[3]   kernel_ms={row['kernel_ms']:.4f} plain_ms={row['plain_ms']:.4f} "
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


def ln_sites(batch: int, cells: int, position_lns: bool):
    """The LayerNorm sites of one no-gradient forward of OFA-Base over a grid
    of ``cells`` image tokens, src_len 32: (name, rows, width, input dtype,
    output dtype, sites per forward).  The two embedding LayerNorms, then per
    layer three (encoder) or five (decoder) of width 768 and the
    ffn_layernorm of width 3,072, then the final one; where the biases are
    built in the forward (evaluation, monitoring), the three fp32 position
    LayerNorms, once per forward whatever the batch."""
    bf16, fp32 = torch.bfloat16, torch.float32
    enc, dec = cells + SRC_LEN, 1 + cells
    sites = [
        ("patch embedding", batch * cells, 768, bf16, bf16, 1),
        ("text embedding", batch * SRC_LEN, 768, bf16, bf16, 1),
        ("encoder layers + final", batch * enc, 768, bf16, bf16, 6 * 3 + 1),
        ("encoder ffn", batch * enc, 3072, bf16, bf16, 6),
        ("decoder embedding + layers + final", batch * dec, 768, bf16, bf16, 1 + 6 * 5 + 1),
        ("decoder ffn", batch * dec, 3072, bf16, bf16, 6),
    ]
    if position_lns:
        sites += [
            ("text positions", SRC_LEN, 768, fp32, fp32, 1),
            ("image positions", cells, 768, fp32, fp32, 1),
            ("seg positions", dec, 768, fp32, fp32, 1),
        ]
    return sites


# The three main paths that launch the LayerNorm kernel: the served batch-32
# forward at 512px (biases precomputed), an evaluation group of EVAL_ROWS rows
# on the padded grid of the (512, 768) bucket, and the trainer's monitoring
# forward at batch TRAIN_BATCH; keyed by the count's name in a site's row.
LN_PATHS = {
    "per_forward": ("served", ln_sites(32, 1024, False)),
    "per_eval_group": ("eval", ln_sites(EVAL_ROWS, EVAL_GRID[0] * EVAL_GRID[1], True)),
    "per_monitor_forward": ("monitor", ln_sites(TRAIN_BATCH, 1024, True)),
}


def ln_sites_per_pass(per_key: str) -> int:
    return sum(n for *_, n in LN_PATHS[per_key][1])


def phase_layer_norm():
    import torch.nn.functional as F
    from ifseg_torch.ops import layer_norm as ln

    gen = torch.Generator(device="cuda").manual_seed(7)
    bf16, fp32 = torch.bfloat16, torch.float32
    cases = [(f"{path} {name}", n, d, in_dt, out_dt, per_key, per)
             for per_key, (path, sites) in LN_PATHS.items()
             for name, n, d, in_dt, out_dt, per in sites]
    cases += [
        ("ragged row count", 1001, 768, bf16, bf16, None, 0),
        ("narrow width", 77, 32, fp32, bf16, None, 0),
        ("widest", 333, 4096, bf16, fp32, None, 0),
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
        log(f"[3n] {name}: {n} x {d} {str(in_dt).split('.')[-1]} -> {str(out_dt).split('.')[-1]}: "
            f"max_abs_err={err:.3e}, {held}")
        if not ok:
            fail(f"layer_norm kernel disagrees with its plain version at {name}: {err}, {held}")
        row = dict(site=name, rows=n, width=d, max_abs_err=err, **{k: 0 for k in LN_PATHS})
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
            log(f"[3n]   kernel_ms={row['kernel_ms']:.4f} plain_ms={row['plain_ms']:.4f} "
                f"library_ms={row['library_ms']:.4f} three_pass_ms={row['three_pass_ms']:.4f} "
                f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']}; {row['mb']:.1f} MB) "
                f"share_of_bound={row['share_of_bound']:.3f}")
        rows.append(row)
        del x, got, want
    for per_key, (path, _) in LN_PATHS.items():
        timed = [r for r in rows if r[per_key]]
        log(f"[3n] {path} forward, {sum(r[per_key] for r in timed)} sites: kernel "
            f"{sum(r['kernel_ms'] * r[per_key] for r in timed):.3f} ms, cast + fp32 F.layer_norm + "
            f"cast {sum(r['three_pass_ms'] * r[per_key] for r in timed):.3f} ms, bound "
            f"{sum(r['bound_ms'] * r[per_key] for r in timed):.3f} ms")
    try:  # a width the kernel does not take raises; nothing falls back
        ln.fused_layer_norm(torch.zeros(4, 100, device="cuda"), torch.ones(100, device="cuda"),
                            torch.zeros(100, device="cuda"))
    except ValueError as exc:
        log(f"[3n] width 100 on a CUDA tensor raises: {exc}")
    else:
        fail("layer_norm on a CUDA tensor of width 100 did not raise")

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


def phase_train_kernels():
    """Forward with stats, di, dq + dbias and dk + dv against their plain
    versions at the training shapes; rows keyed by kernel."""
    from ifseg_torch.ops import flash_attention as fa

    h = 12
    rows = {"stats": [], "di": [], "dq": [], "dkv": []}
    cases = [(name, TRAIN_BATCH, lq, lk, causal, masked, torch.bfloat16, n)
             for name, lq, lk, causal, masked, n in SITES]
    cases.append(("ragged check", 3, 77, 130, True, True, torch.float32, 0))
    cases.append(("no-bias check", 2, 70, 70, False, False, None, 0))
    # the kernels' tile edges, with more than one key (with one, every
    # gradient but dv is 0)
    cases += [(name, b, lq, lk, causal, masked, bias_dtype, 0)
              for name, b, lq, lk, causal, masked, bias_dtype, _ in EDGE_CASES if lk > 1]
    for i, (name, b, lq, lk, causal, masked, bias_dtype, per_step) in enumerate(cases):
        q, k, v, dense, mask = site_inputs(b, h, lq, lk, causal, masked,
                                           bias_dtype or torch.bfloat16, seed=10 + i)
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
        log(f"[3t] {name}: B={b} Lq={lq} Lk={lk} causal={causal} mask={masked} "
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
        base = dict(site=name, B=b, Lq=lq, Lk=lk, causal=causal, per_step=per_step)
        rows["stats"].append(dict(base, max_abs_err=max(errs["out"], errs["lse"])))
        rows["di"].append(dict(base, max_abs_err=errs["di"][1], max_rel_err=errs["di"][0]))
        kq = [e for n, e in errs.items() if n.startswith(("dq", "dbias"))]
        kkv = [e for n, e in errs.items() if n.startswith(("dk", "dv"))]
        rows["dq"].append(dict(base, max_abs_err=max(e[1] for e in kq),
                               max_rel_err=max(e[0] for e in kq)))
        rows["dkv"].append(dict(base, max_abs_err=max(e[1] for e in kkv),
                                max_rel_err=max(e[0] for e in kkv)))
        if per_step:
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
                log(f"[3t]   scaled_dot_product_attention with a bias gradient failed: {exc}")
                lib_fwd = lib_bwd = None
            # di in one library call (timed here, used nowhere in the port); its
            # result is bf16 where the kernel's is fp32
            gh, oh = g.view(b, lq, h, -1), out.view(b, lq, h, -1)
            lib_di = cuda_ms(lambda: torch.einsum("blhd,blhd->bhl", gh, oh), 10)
            torch.cuda.empty_cache()
            for kind, (kernel_fn, plain_fn) in timed.items():
                row = rows[kind][-1]
                if kind == "di":  # bytes only: do and out read, di written
                    flops, nbytes = 2 * q.numel(), 2 * 2 * q.numel() + 4 * di.numel()
                else:
                    flops, nbytes = attention_work(b, h, lq, lk, fa.HEAD_DIM, causal, bb, masked,
                                                   kind)
                row["bound_ms"], row["bound_by"] = bound_ms(flops, nbytes)
                row["gflop"], row["mb"] = flops / 1e9, nbytes / 1e6
                row["kernel_ms"] = cuda_ms(kernel_fn, 10)
                row["plain_ms"] = cuda_ms(plain_fn, 2, warmup=1)
                torch.cuda.empty_cache()
                # the library's one backward does the work of dq + dbias and dk + dv together
                row["library_ms"] = dict(stats=lib_fwd, dq=lib_bwd, dkv=lib_bwd, di=lib_di)[kind]
                row["share_of_bound"] = row["bound_ms"] / row["kernel_ms"]
                log(f"[3t]   {kind}: kernel_ms={row['kernel_ms']:.4f} plain_ms={row['plain_ms']:.4f} "
                    f"library_ms={row['library_ms']} bound_ms={row['bound_ms']:.4f} "
                    f"({row['bound_by']}; {row['gflop']:.1f} GFLOP, {row['mb']:.1f} MB) "
                    f"share_of_bound={row['share_of_bound']:.3f}")
            # what the dbias sum and the bias cost the backward kernels
            rows["dq"][-1]["no_dbias_ms"] = cuda_ms(
                lambda: fa._launch_dq(*args, g, lse, di, h, need_dbias=False), 10)
            no_bias = (q, k, v, None, mask, causal, g, lse, di, h)
            rows["dq"][-1]["no_bias_ms"] = cuda_ms(lambda: fa._launch_dq(*no_bias), 10)
            rows["dkv"][-1]["no_bias_ms"] = cuda_ms(lambda: fa._launch_dkv(*no_bias), 10)
            log(f"[3t]   dq without dbias {rows['dq'][-1]['no_dbias_ms']:.4f} ms, without a bias "
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

def train_config(dtype: str, monitor: bool, dropout: bool = True):
    """The reference image-free configuration (run_scripts/IFSeg/common.sh +
    coco_unseen.sh): OFA-Base 512px, 15 seg classes, dropout and drop-path
    0.1, clip-norm 1, Adam (0.9, 0.999) eps 1e-8, wd 0.1, cosine LR 5e-5."""
    from ifseg_torch.config import Config, model_config_for_arch

    rates = {} if dropout else dict(dropout=0.0, encoder_drop_path_rate=0.0,
                                    decoder_drop_path_rate=0.0)
    cfg = Config(model=model_config_for_arch(
        "segofa_base", patch_image_size=512, orig_patch_image_size=512,
        num_seg_tokens=TRAIN_CLASSES, dtype=dtype, **rates))
    cfg.optimization.seed = SEED
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
        logs, times = [], []
        for _ in range(steps):
            batch = train_batch(rng, TRAIN_BATCH, real)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = trainer.train_step(batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t1)
            logs.append({k: float(v) for k, v in out.items()
                         if not isinstance(v, torch.Tensor) or v.dim() == 0})
        return logs, times

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


def phase_train_gradients():
    """Image-free loss + backward at batch 2: the card (bf16, kernels) against
    the CPU (fp32, plain versions), same weights and batch, dropout off."""
    from ifseg_torch.train.trainer import Trainer

    tokens, lengths = class_table(SEED)
    batch = train_batch(np.random.default_rng(400), 2, real=False)

    def loss_and_grads(dtype, device, weights):
        tr = Trainer(train_config(dtype, monitor=False, dropout=False), tokens, lengths,
                     total_num_updates=100, device=device).init_state(weights)
        tr.model.train()
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
    log(f"[7] image-free loss + backward, batch 2: card {t1 - t0:.1f} s, CPU {t2 - t1:.1f} s; "
        f"loss {card_loss:.5f} vs {cpu_loss:.5f} (rel {loss_rel:.3e}), "
        f"gnorm {gn_card:.5f} vs {gn_cpu:.5f} (rel {gn_rel:.3e})")
    cosines = {}
    for name in GRAD_TENSORS:
        a, b = card_grads[name].flatten().double(), cpu_grads[name].flatten().double()
        cosines[name] = float(a @ b / (a.norm() * b.norm()))
        log(f"[7]   cosine {cosines[name]:.5f}  |g| card {float(a.norm()):.3e} "
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

def eval_config(dtype: str):
    """OFA-Base, 150 classes, the evaluation settings of
    run_scripts/IFSeg/common.sh: label propagation top-3, 25 iterations."""
    from ifseg_torch.config import Config

    cfg = Config(model=base_config(dtype))
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


def eval_samples(shapes, seed: int):
    """Fabricated uint8 ``EvalSample``s; a tenth of the target is 'unknown'."""
    from ifseg_torch.data.segmentation_dataset import EvalSample

    rng = np.random.default_rng(seed)
    src = rng.integers(4, 50000, size=SRC_LEN).astype(np.int32)
    src[SRC_LEN - 5:] = 1  # PAD
    samples = []
    for i, ((h, w), (H, W)) in enumerate(shapes):
        seg = rng.integers(0, EVAL_CLASSES, size=(H, W)).astype(np.int32)
        seg[rng.random((H, W)) < 0.1] = EVAL_CLASSES
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
    evaluator = Evaluator(cfg, model)  # the card, by default
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


# ---------------------------------------------------------------- main

def pass_totals(rows, per_key):
    """A kernel's times summed over the sites of one pass (``per_key`` calls
    each): its own, the plain version's, the bound and the library call's."""
    timed = [r for r in rows if r[per_key]]
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


def main():
    card = phase_card()
    sys.path.insert(0, str(REPO))

    phase_build()
    sites = phase_kernels()
    ln_rows, ln_train = phase_layer_norm()
    train_rows = phase_train_kernels()
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

    fwd_src = "ifseg_torch/csrc/flash_attention_bias_fwd.cu"
    dq_src = "ifseg_torch/csrc/flash_attention_bias_bwd_dq.cu"
    dkv_src = "ifseg_torch/csrc/flash_attention_bias_bwd_dkv.cu"
    jax_fa = "ifseg_tpu/ops/flash_attention.py"
    step_unit = "one batch-16 training step: 6 calls at each of the three site shapes"
    counts = train["launches"]
    # the forward without stats runs on three main paths; each was driven with
    # the counts set to 0 just before and read just after
    k1_paths = dict(serving=serve["launches"], evaluation=evaluation["launches"],
                    monitoring=counts["infer"])
    ln_paths = dict(serving=serve["ln_launches"], evaluation=evaluation["ln_launches"],
                    monitoring=train["ln_launches"])
    kernels = [
        kernel_entry("flash_attention_bias_fwd", fwd_src, f"{jax_fa}:134", sum(k1_paths.values()),
                     sites, "one batch-32 forward: 6 calls at each of the three site shapes",
                     "per_forward"),
        kernel_entry("flash_attention_bias_fwd_stats", fwd_src, f"{jax_fa}:134", counts["stats"],
                     train_rows["stats"], step_unit, "per_step"),
        kernel_entry("flash_attention_bwd_di", dq_src, f"{jax_fa}:484", counts["bwd_di"],
                     train_rows["di"], step_unit, "per_step"),
        kernel_entry("flash_attention_bias_bwd_dq", dq_src, f"{jax_fa}:373", counts["bwd_dq"],
                     train_rows["dq"], step_unit, "per_step"),
        kernel_entry("flash_attention_bias_bwd_dkv", dkv_src, f"{jax_fa}:420", counts["bwd_dkv"],
                     train_rows["dkv"], step_unit, "per_step"),
        kernel_entry("layer_norm", "ifseg_torch/csrc/layer_norm.cu",
                     "ifseg_tpu/ops/layer_norm.py:43", sum(ln_paths.values()), ln_rows,
                     "one batch-32 forward: its 65 LayerNorm sites at their six (rows, width) "
                     "shapes", "per_forward"),
    ]
    kernels[0]["launches_by_path"] = k1_paths
    kernels[0]["per_pass"] = {"evaluation group of 8": pass_totals(sites, "per_eval_group")}
    kernels[-1]["launches_by_path"] = ln_paths
    kernels[-1]["per_pass"] = {
        "evaluation group of 8": pass_totals(ln_rows, "per_eval_group"),
        f"monitoring forward, batch {TRAIN_BATCH}": pass_totals(ln_rows, "per_monitor_forward"),
    }
    kernels[-1]["training_site"] = ln_train
    for entry in kernels:
        if entry["launches"] < 1 or any(n < 1 for n in entry.get("launches_by_path", {}).values()):
            fail(f"kernel {entry['name']} was never launched by a main path")
    log(json.dumps({"serve": serve, "cpu_reference": cpu, "evaluation": evaluation,
                    "train": train, "train_gradients": grads, "card_line": card}))
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
