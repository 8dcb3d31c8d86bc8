#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (an H100 is the target).

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when it fails:
  1. the card: name and power limit (nvidia-smi), torch and CUDA versions;
  2. build every kernel with nvcc (one process per source, all at once),
     with the ``-Xptxas -v`` summary;
  3. each kernel against its plain PyTorch version, with its time, the plain
     version's, one PyTorch library call's (timed only here, never used by
     the port) and the bound: the forward without stats at the serving
     shapes (batch 32), then the forward with stats, the di pre-pass, the
     dq + dbias kernel and the dk + dv kernel at the training shapes (batch
     16), plus a small ragged case with an fp32 bias and one without a bias;
  4. the serving path at full OFA-Base 512px width, random weights from seed
     0: ``SegServer`` on the card answers batches of 1, 8 and 32; the launch
     counts of the kernels are set to 0 just before and read just after;
  5. the card's bf16 logits against the port's fp32 forward on the CPU, on
     the same weights and a batch-2 input;
  6. the training path at full width: ``Trainer`` on the card takes image-
     free steps at batch 16 on artificial grids (15 classes, ``src_len``
     32), first without and then with the monitoring forward; launch counts
     set to 0 before and read after; loss, gnorm, counters, moved and frozen
     parameters checked;
  7. one loss + backward of the image-free loss at batch 2 on the card
     (bf16, kernels) against the CPU (fp32, plain versions), same weights,
     dropout off: loss, global gradient norm, and the cosine between the two
     gradients of a handful of tensors;
  8. one JSON line listing every kernel, the nvidia-smi line, and the last
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
SEED = 0
SRC_LEN = 32
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
    results = build.build(list(fa.KERNELS))
    log(f"[2] built {sorted(results)} in {time.perf_counter() - t0:.1f} s")
    for res in results.values():
        log(f"[2] {res.name}: {res.path.name}, nvcc {res.seconds:.1f} s")
        for line in res.log.splitlines():  # registers, spills and stack of every kernel
            if "registers" in line or "spill" in line or "error" in line.lower():
                log(f"[2]   {line.strip()}")


# ---------------------------------------------------------------- phase 3

# The three attention sites of the served forward at OFA-Base 512px,
# src_len 32: (name, Lq, Lk, causal, key-padding mask, sites per forward).
SITES = [
    ("encoder self", 1024 + SRC_LEN, 1024 + SRC_LEN, False, True, 6),
    ("decoder self", 1 + 1024, 1 + 1024, True, False, 6),
    ("decoder cross", 1 + 1024, 1024 + SRC_LEN, False, True, 6),
]


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

    fa.reset_launches()
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
    for i, (name, b, lq, lk, causal, masked, bias_dtype, per_step) in enumerate(cases):
        q, k, v, bias, mask = site_inputs(b, h, lq, lk, causal, masked,
                                          bias_dtype or torch.bfloat16, seed=10 + i)
        if bias_dtype is None:
            bias = None
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
            f"bias={None if bias is None else str(bias.dtype).split('.')[-1]}: "
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
        kq = [errs[n] for n in ("dq", "dbias") if n in errs]
        rows["dq"].append(dict(base, max_abs_err=max(e[1] for e in kq),
                               max_rel_err=max(e[0] for e in kq)))
        rows["dkv"].append(dict(base, max_abs_err=max(errs["dk"][1], errs["dv"][1]),
                                max_rel_err=max(errs["dk"][0], errs["dv"][0])))
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
        del q, k, v, bias, mask, g, out, lse, di, dq, dk, dv, dbias, args
        torch.cuda.empty_cache()
    return rows


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
    warm_steps, timed_steps, monitor_steps = 1, 5, 3
    logs, times = run(warm_steps + timed_steps, real=False)
    trainer.cfg.criterion.monitor_real_batch = True
    mon_logs, mon_times = run(monitor_steps, real=True)
    counts = fa.launch_counts()
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
                launches=counts, steps=steps, monitor_steps=monitor_steps,
                final_loss=mon_logs[-1]["loss"])


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


# ---------------------------------------------------------------- main

def kernel_entry(name, source, replaces, launches, rows, unit, per_key):
    """One entry of the ``kernels`` line from a kernel's per-site rows; the
    times are summed over the sites of one pass (``per_key`` calls each)."""
    timed = [r for r in rows if r[per_key]]
    total = lambda key: sum(r[key] * r[per_key] for r in timed)
    t_ops = sum(r["gflop"] * 1e9 / PEAK_BF16_FLOPS * 1e3 * r[per_key] for r in timed)
    t_bytes = sum(r["mb"] * 1e6 / PEAK_BYTES_PER_S * 1e3 * r[per_key] for r in timed)
    lib = None if any(r["library_ms"] is None for r in timed) else total("library_ms")
    return dict(
        name=name, route="cuda", source=source, replaces=replaces, launches=launches,
        max_abs_err=max(r["max_abs_err"] for r in rows),
        ms=total("kernel_ms"), plain_ms=total("plain_ms"), bound_ms=total("bound_ms"),
        bound_by="operations" if t_ops >= t_bytes else "bytes", library_ms=lib,
        unit=unit, sites=rows,
    )


def main():
    card = phase_card()
    sys.path.insert(0, str(REPO))

    phase_build()
    sites = phase_kernels()
    train_rows = phase_train_kernels()
    server, weights, serve = phase_serve(card)
    cpu = phase_cpu_reference(server, weights)
    del server, weights
    torch.cuda.empty_cache()
    train = phase_train(card)
    grads = phase_train_gradients()

    fwd_src = "ifseg_torch/csrc/flash_attention_bias_fwd.cu"
    dq_src = "ifseg_torch/csrc/flash_attention_bias_bwd_dq.cu"
    dkv_src = "ifseg_torch/csrc/flash_attention_bias_bwd_dkv.cu"
    jax_fa = "ifseg_tpu/ops/flash_attention.py"
    step_unit = "one batch-16 training step: 6 calls at each of the three site shapes"
    counts = train["launches"]
    kernels = [
        kernel_entry("flash_attention_bias_fwd", fwd_src, f"{jax_fa}:134", serve["launches"],
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
    ]
    # the one TPU kernel not ported yet (ifseg_tpu/ops/layer_norm.py:43): its
    # bound from the shapes it would see, bytes read and written once
    for rows, width in ((32 * 1056, 768), (32 * 1056, 3072)):
        nbytes = 2 * rows * width * 2  # bf16 in, bf16 out
        log(f"[8] layer-norm kernel (not ported), rows {rows} x {width} bf16: "
            f"{nbytes / 1e6:.1f} MB, bound {nbytes / PEAK_BYTES_PER_S * 1e3:.4f} ms (bytes)")
    for entry in kernels:
        if entry["launches"] < 1:
            fail(f"kernel {entry['name']} was never launched by the main path")
    log(json.dumps({"serve": serve, "cpu_reference": cpu, "train": train,
                    "train_gradients": grads, "card_line": card}))
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
