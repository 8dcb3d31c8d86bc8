#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (an H100 is the target).

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when it fails:
  1. the card: name and power limit (nvidia-smi), torch and CUDA versions;
  2. build every kernel of the serving path with nvcc (one process per
     source, all at once), with the ``-Xptxas -v`` summary;
  3. each kernel against its plain PyTorch version at the shapes the serving
     path gives it, with its time, the plain version's, one PyTorch library
     call's (timed only here, never used by the port) and the bound;
  4. the serving path at full OFA-Base 512px width, random weights from seed
     0: ``SegServer`` on the card answers batches of 1, 8 and 32; the launch
     counts of the kernels are set to 0 just before and read just after;
  5. the card's bf16 logits against the port's fp32 forward on the CPU, on
     the same weights and a batch-2 input;
  6. one JSON line listing every kernel, the nvidia-smi line, and the last
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
PEAK_BYTES_PER_S = 3.35e12

ATTN_TOL = 2e-2  # kernel (bf16 P in the P·V product, bf16 output) vs fp32 plain
LOGIT_REL_TOL = 5e-2  # card bf16 forward vs CPU fp32 forward, ||Δ|| / ||ref||
SEED = 0
SRC_LEN = 32


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

    t0 = time.perf_counter()
    results = build.build([fa.KERNEL])
    log(f"[2] built {sorted(results)} in {time.perf_counter() - t0:.1f} s")
    for res in results.values():
        log(f"[2] {res.name}: {res.path.name}, nvcc {res.seconds:.1f} s")
        for line in res.log.splitlines():
            if "ptxas" in line or "error" in line.lower():
                log(f"[2]   {line.strip()}")


# ---------------------------------------------------------------- phase 3

# The three attention sites of the served forward at OFA-Base 512px,
# src_len 32: (name, Lq, Lk, causal, key-padding mask, sites per forward).
SITES = [
    ("encoder self", 1024 + SRC_LEN, 1024 + SRC_LEN, False, True, 6),
    ("decoder self", 1 + 1024, 1 + 1024, True, False, 6),
    ("decoder cross", 1 + 1024, 1024 + SRC_LEN, False, True, 6),
]


def attention_work(b, h, lq, lk, d, causal, bias_bytes, masked):
    """(flops, bytes) the function needs: the visible (q, k) pairs of the two
    products, each input read once and the output written once."""
    if causal:
        off = lk - lq
        pairs = int(np.minimum(np.arange(lq) + off + 1, lk).sum())
    else:
        pairs = lq * lk
    flops = 4 * b * h * pairs * d
    nbytes = 2 * b * (lq + 2 * lk + lq) * h * d + h * lq * lk * bias_bytes
    if masked:
        nbytes += b * lk
    return flops, nbytes


def bound_ms(flops, nbytes):
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


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
    if masked:  # the text rows of the last sample end in padding, as in serving
        mask = torch.zeros(b, lk, dtype=torch.bool, device="cuda")
        mask[-1, lk - 7:] = True
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
    cases = [(name, 32, lq, lk, causal, masked, torch.bfloat16, n)
             for name, lq, lk, causal, masked, n in SITES]
    # a small ragged shape with an fp32 bias, checked but not timed
    cases.append(("ragged check", 3, 77, 130, True, True, torch.float32, 0))
    for i, (name, b, lq, lk, causal, masked, bias_dtype, per_fwd) in enumerate(cases):
        q, k, v, bias, mask = site_inputs(b, h, lq, lk, causal, masked, bias_dtype, seed=i)
        out = fa.flash_attention_bias_packed_infer(q, k, v, bias, mask, causal, h)
        torch.cuda.synchronize()
        want = fa.attention_bias_reference(q.float(), k.float(), v.float(), bias.float(),
                                           mask, causal, h)
        err = (out.float() - want).abs().max().item()
        finite = bool(torch.isfinite(out).all())
        del want, out
        log(f"[3] {name}: B={b} Lq={lq} Lk={lk} causal={causal} mask={masked} "
            f"bias={str(bias_dtype).split('.')[-1]}: max_abs_err={err:.3e}")
        if not finite or not err <= ATTN_TOL:
            fail(f"kernel disagrees with its plain version at {name}: {err} > {ATTN_TOL}")
        row = dict(site=name, B=b, Lq=lq, Lk=lk, causal=causal, per_forward=per_fwd,
                   max_abs_err=err)
        if per_fwd:
            flops, nbytes = attention_work(b, h, lq, lk, fa.HEAD_DIM, causal,
                                           bias.element_size(), masked)
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
            log(f"[3]   kernel_ms={row['kernel_ms']:.4f} plain_ms={row['plain_ms']:.4f} "
                f"library_ms={row['library_ms']} bound_ms={row['bound_ms']:.4f} "
                f"({row['bound_by']}; {row['gflop']:.1f} GFLOP, {row['mb']:.1f} MB) "
                f"share_of_bound={row['share_of_bound']:.3f}")
        rows.append(row)
        del q, k, v, bias, mask
        torch.cuda.empty_cache()
    return rows


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

    fa.LAUNCHES = 0
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
    steps = 5
    server(*inputs)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(steps):
        server(*inputs)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t1) / steps
    forwards += 1 + steps
    launches = fa.LAUNCHES
    log(f"[4] kernel launches {launches} over {forwards} forwards "
        f"(expected {per_forward} x {forwards} = {per_forward * forwards})")
    if launches != per_forward * forwards:
        fail("the serving path did not launch the attention kernel at every site")
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    log(f"[4] steady state, batch 32: {dt * 1e3:.1f} ms/forward, {32 / dt:.2f} img/s, "
        f"max_memory_allocated {peak_gb:.2f} GiB, on {card}")
    serve = dict(img_per_s=32 / dt, ms_per_forward=dt * 1e3, max_memory_gib=peak_gb,
                 launches=launches, forwards=forwards)
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


# ---------------------------------------------------------------- main

def main():
    card = phase_card()
    sys.path.insert(0, str(REPO))
    from ifseg_torch.ops import flash_attention as fa

    phase_build()
    sites = phase_kernels()
    server, weights, serve = phase_serve(card)
    cpu = phase_cpu_reference(server, weights)

    timed = [s for s in sites if s["per_forward"]]
    per_fwd = lambda key: sum(s[key] * s["per_forward"] for s in timed)
    lib = None if any(s["library_ms"] is None for s in timed) else per_fwd("library_ms")
    t_ops = sum(s["gflop"] * 1e9 / PEAK_BF16_FLOPS * 1e3 * s["per_forward"] for s in timed)
    t_bytes = sum(s["mb"] * 1e6 / PEAK_BYTES_PER_S * 1e3 * s["per_forward"] for s in timed)
    kernel = dict(
        name=fa.KERNEL, route="cuda", source="ifseg_torch/csrc/flash_attention_bias_fwd.cu",
        replaces="ifseg_tpu/ops/flash_attention.py:134",
        launches=serve["launches"],
        max_abs_err=max(s["max_abs_err"] for s in sites),
        ms=per_fwd("kernel_ms"), plain_ms=per_fwd("plain_ms"), bound_ms=per_fwd("bound_ms"),
        bound_by="operations" if t_ops >= t_bytes else "bytes", library_ms=lib,
        unit="one batch-32 forward: 6 calls at each of the three site shapes",
        sites=sites,
    )
    log(json.dumps({"serve": serve, "cpu_reference": cpu, "card_line": card}))
    log(json.dumps({"kernels": [kernel]}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
