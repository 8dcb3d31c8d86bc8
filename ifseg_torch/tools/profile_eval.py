"""Where the time of one native-resolution evaluation group goes, on the card.

    python3 -m ifseg_torch.tools.profile_eval [--out FILE] [--rows N]

Builds OFA-Base (random weights from seed 0, 150 classes, ``src_len`` 32,
label propagation top-3 x 25 iterations: the configuration ``chip_smoke.py``
evaluates), fabricates one group of uint8 samples of different pixel shapes
inside the (512, 768) bucket, and prints

  * the host time of one group through ``Evaluator._run_group``, with and
    without label propagation;
  * the two steps after the forward, upsample + areas and label
    propagation, replayed alone on the group's own inputs (CUDA events);
  * a ``torch.profiler`` trace of a few groups: device time by kernel class
    (the attention kernel K1, the LayerNorm kernel K4, cuBLAS, cuDNN, and
    the elementwise kernels, among them the stem's masks) and the device's
    busy share of the host's wall time;
  * one JSON line with all of it.

``--out`` also writes the profiler's table of the top kernels to a file.
"""

import argparse
import json
import subprocess
import time

import numpy as np
import torch

SRC_LEN = 32
CLASSES = 150
PROFILED_GROUPS = 3
# keep-ratio shapes (image, original) that share the ceil-16 extents (32, 43)
SHAPES = [((512, 683), (480, 640)), ((512, 680), (450, 600)), ((512, 675), (512, 683)),
          ((512, 683), (427, 640)), ((512, 678), (500, 667)), ((512, 673), (468, 624)),
          ((512, 682), (512, 680)), ((512, 681), (400, 534))]


def kernel_class(name: str) -> str:
    n = name.lower()
    if "attn_bias_fwd" in n:
        return "attention kernel (K1)"
    if "layer_norm_kernel" in n and "vectorized" not in n and "native" not in n:
        return "layer-norm kernel (K4)"  # PyTorch's own is at::native::vectorized_...
    if "conv" in n or "fprop" in n or "cudnn" in n or "nhwc" in n:
        return "convolutions (cuDNN)"
    if "gemm" in n or "nvjet" in n or "cublas" in n or "cutlass" in n:
        return "matrix products (cuBLAS)"
    if "layer_norm" in n:
        return "library layer norms"
    return "elementwise, casts, copies, masks, pooling"


def make_samples(rows: int, seed: int = 0):
    from ifseg_torch.data.segmentation_dataset import EvalSample

    rng = np.random.default_rng(seed)
    src = rng.integers(4, 50000, size=SRC_LEN).astype(np.int32)
    src[SRC_LEN - 5:] = 1  # PAD
    samples = []
    for i in range(rows):
        (h, w), (H, W) = SHAPES[i % len(SHAPES)]
        samples.append(EvalSample(
            patch_image=rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8), src_tokens=src,
            bos_token=np.zeros((1,), np.int32),
            ori_semantic_seg=rng.integers(0, CLASSES + 1, size=(H, W)).astype(np.int32),
            ori_shape=(H, W, 3), id=i))
    return samples


def cuda_ms(fn, iters: int = 5, warmup: int = 1) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def record_step_calls(evaluator, group):
    """The arguments of every call one group makes to the evaluator's two
    post-forward steps, keyed by step, with the functions to replay them."""
    import ifseg_torch.eval.evaluator as ev

    real = {"upsample + areas": ev._upsampled_areas_dyn,
            "label propagation": ev.masked_label_propagation}
    names = {"upsample + areas": "_upsampled_areas_dyn",
             "label propagation": "masked_label_propagation"}
    calls = {step: [] for step in real}

    def recorder(step):
        def wrapper(*args):
            calls[step].append(args)
            return real[step](*args)
        return wrapper

    for step, attr in names.items():
        setattr(ev, attr, recorder(step))
    try:
        evaluator._run_group(group)
    finally:
        for step, attr in names.items():
            setattr(ev, attr, real[step])
    return real, calls


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="file for the profiler's kernel table")
    ap.add_argument("--rows", type=int, default=8, help="rows of the group")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_eval: needs a CUDA device")

    from torch.profiler import ProfilerActivity, profile

    from ifseg_torch.config import Config, model_config_for_arch
    from ifseg_torch.eval.evaluator import Evaluator
    from ifseg_torch.models.segofa import SegOFA

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    cfg = Config(model=model_config_for_arch(
        "segofa_base", patch_image_size=512, orig_patch_image_size=512,
        num_seg_tokens=CLASSES, dtype="bfloat16"))
    cfg.criterion.resnet_topk, cfg.criterion.resnet_iters = 3, 25
    evaluator = Evaluator(cfg, SegOFA(cfg.model).init(torch.Generator().manual_seed(0)))
    group = make_samples(args.rows)

    def group_ms(iters: int = 3) -> float:
        evaluator._run_group(group)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            evaluator._run_group(group)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / iters

    ms_lp = group_ms()
    cfg.criterion.resnet_iters = 0
    ms_no_lp = group_ms()
    cfg.criterion.resnet_iters = 25
    print(f"group of {args.rows} at the (512, 768) bucket: {ms_lp:.1f} ms "
          f"({args.rows / ms_lp * 1e3:.2f} img/s), without label propagation {ms_no_lp:.1f} ms "
          f"({args.rows / ms_no_lp * 1e3:.2f} img/s), on {card}", flush=True)

    # the two post-forward steps replayed alone on the group's own inputs;
    # their kernels are elementwise and matrix-product kernels by name, so
    # these times are parts of those two classes below, not further classes
    with torch.no_grad():
        real, calls = record_step_calls(evaluator, group)
        step_ms = {step: cuda_ms(lambda: [real[step](*c) for c in calls[step]])
                   for step in real}
    for step, ms in step_ms.items():
        print(f"step {step}: {ms:.3f} ms per group ({len(calls[step])} calls, replayed alone)",
              flush=True)
    del calls

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILED_GROUPS):
            evaluator._run_group(group)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / PROFILED_GROUPS
    by_class = {}
    device_ms = 0.0
    for ev in prof.key_averages():
        t = getattr(ev, "self_device_time_total", None)
        if t is None:
            t = getattr(ev, "self_cuda_time_total", 0.0)
        if not t or getattr(ev, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        ms = t / 1e3 / PROFILED_GROUPS
        device_ms += ms
        cls = kernel_class(ev.key)
        by_class[cls] = by_class.get(cls, 0.0) + ms
    for cls, ms in sorted(by_class.items(), key=lambda kv: -kv[1]):
        print(f"device {cls}: {ms:.3f} ms per group", flush=True)
    busy = device_ms / wall_ms if wall_ms else float("nan")
    print(f"per group: wall {wall_ms:.3f} ms under the profiler, device busy {device_ms:.3f} ms, "
          f"busy share {busy:.3f} ({device_ms / ms_lp:.3f} of the unprofiled {ms_lp:.1f} ms), "
          f"on {card}", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=50))
    print(json.dumps({"card": card, "rows": args.rows, "group_ms": ms_lp,
                      "group_ms_no_label_propagation": ms_no_lp,
                      "step_ms": step_ms, "device_ms_by_class": by_class,
                      "device_ms": device_ms,
                      "wall_ms_profiled": wall_ms, "busy_share_profiled": busy,
                      "busy_share_unprofiled": device_ms / ms_lp}))


if __name__ == "__main__":
    main()
