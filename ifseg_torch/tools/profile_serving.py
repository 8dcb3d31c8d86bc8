"""Where the time of one served forward goes, on the card.

    python3 -m ifseg_torch.tools.profile_serving [--out FILE]

Builds OFA-Base at 512px (random weights from seed 0, ``src_len`` 32, the
configuration ``chip_smoke.py`` serves), serves batches of 32 and prints

  * the device time of each stage of the forward (ResNet stem, encoder
    layers, decoder layers, seg head), by CUDA events around each stage run
    alone on the same inputs;
  * the attention kernel (K1) replayed on the forward's own inputs;
  * a ``torch.profiler`` trace of a few forwards: device time by kernel
    class (the port's attention kernel, matrix products, convolutions,
    everything else) and the device's busy share of the host's wall time;
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
BATCH = 32
PROFILED_FORWARDS = 3


def cuda_ms(fn, iters: int = 5, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_class(name: str) -> str:
    n = name.lower()
    if "attn_bias_fwd" in n:
        return "attention kernel (K1)"
    if "conv" in n or "fprop" in n or "cudnn" in n or "nhwc" in n:
        return "convolutions (cuDNN)"
    if "gemm" in n or "nvjet" in n or "cublas" in n:
        return "matrix products (cuBLAS)"
    if "layer_norm_kernel" in n and "vectorized" not in n and "native" not in n:
        return "layer-norm kernel (K4)"  # PyTorch's own is at::native::vectorized_...
    if "layer_norm" in n:
        return "layer norms"
    return "elementwise, casts, copies, pooling"


def record_attention_calls(server, inputs):
    """The arguments of every attention-kernel call of one forward."""
    import ifseg_torch.models.attention as attention

    real = attention.flash_attention_bias_packed_infer
    calls = []

    def recorder(*args):
        calls.append(args)
        return real(*args)

    attention.flash_attention_bias_packed_infer = recorder
    try:
        server(*inputs)
    finally:
        attention.flash_attention_bias_packed_infer = real
    return calls


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="file for the profiler's kernel table")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_serving: needs a CUDA device")

    from ifseg_torch.config import model_config_for_arch
    from ifseg_torch.eval.serving import SegServer
    from ifseg_torch.models.segofa import SegOFA

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    cfg = model_config_for_arch("segofa_base", patch_image_size=512,
                                orig_patch_image_size=512, num_seg_tokens=150,
                                dtype="bfloat16")
    server = SegServer(SegOFA(cfg).init(torch.Generator().manual_seed(0)), src_len=SRC_LEN)
    model, pre, dev = server.model, server.pre, server.device
    b = BATCH
    rng = np.random.default_rng(0)
    src = torch.from_numpy(rng.integers(4, 50000, size=(b, SRC_LEN))).to(dev)
    src[-1, SRC_LEN - 5:] = 1  # PAD
    img = torch.from_numpy(rng.normal(size=(b, 512, 512, 3)).astype(np.float32)).to(dev)
    bos = torch.zeros(b, 1, dtype=torch.int64, device=dev)

    # stages, each on the inputs the previous one produced
    enc, dec = model.encoder, model.decoder
    with torch.inference_mode():
        enc_out = enc.encode_served(src, img, pre["enc"])
        feats = dec.layer_norm(torch.randn(b, 1025, 768, device=dev), torch.bfloat16)
        stages = {
            "forward": lambda: server(src, img, bos),
            "resnet stem": lambda: enc.embed_images(img.bfloat16()),
            "encoder (stem + 6 layers)": lambda: enc.encode_served(src, img, pre["enc"]),
            "decoder (6 layers + head)": lambda: dec.decode_served(bos, enc_out, pre["dec"]),
            "seg head": lambda: dec.output_layer(feats),
        }
        stage_ms = {name: cuda_ms(fn) for name, fn in stages.items()}
    for name, ms in stage_ms.items():
        print(f"stage {name}: {ms:.3f} ms (batch {b})", flush=True)

    # K1 on the forward's own inputs, without the rest of the forward
    from ifseg_torch.ops.flash_attention import flash_attention_bias_packed_infer as k1

    with torch.inference_mode():
        calls = record_attention_calls(server, (src, img, bos))
        k1_ms = {
            "replay of the forward's calls": cuda_ms(lambda: [k1(*c) for c in calls]),
            "encoder self call, 20 in a row": cuda_ms(lambda: k1(*calls[0]), iters=20),
            "encoder self call, 300 in a row": cuda_ms(lambda: k1(*calls[0]), iters=300),
        }
    for name, ms in k1_ms.items():
        print(f"K1 {name}: {ms:.3f} ms ({len(calls)} calls per forward)", flush=True)
    del calls

    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        server(src, img, bos)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(PROFILED_FORWARDS):
                server(src, img, bos)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / PROFILED_FORWARDS
    by_class = {}
    device_ms = 0.0
    for ev in prof.key_averages():
        t = getattr(ev, "self_device_time_total", None)
        if t is None:
            t = getattr(ev, "self_cuda_time_total", 0.0)
        if not t or getattr(ev, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        ms = t / 1e3 / PROFILED_FORWARDS
        device_ms += ms
        cls = kernel_class(ev.key)
        by_class[cls] = by_class.get(cls, 0.0) + ms
    for cls, ms in sorted(by_class.items(), key=lambda kv: -kv[1]):
        print(f"device {cls}: {ms:.3f} ms per forward", flush=True)
    # the dtype casts (aten::_to_copy / aten::copy_ run as elementwise kernels)
    for ev in prof.key_averages():
        if ev.key in ("aten::_to_copy", "aten::copy_", "aten::to"):
            t = getattr(ev, "device_time_total", None)
            if t is None:
                t = getattr(ev, "cuda_time_total", 0.0)
            print(f"op {ev.key}: {ev.count / PROFILED_FORWARDS:.0f} calls, "
                  f"{t / 1e3 / PROFILED_FORWARDS:.3f} ms per forward", flush=True)
    busy = device_ms / wall_ms if wall_ms else float("nan")
    print(f"per forward: wall {wall_ms:.3f} ms, device busy {device_ms:.3f} ms, "
          f"busy share {busy:.3f}, on {card}", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=40))
    print(json.dumps({"card": card, "batch": b, "stage_ms": stage_ms, "k1_ms": k1_ms,
                      "device_ms_by_class": by_class, "device_ms": device_ms,
                      "wall_ms": wall_ms, "busy_share": busy}))


if __name__ == "__main__":
    main()
