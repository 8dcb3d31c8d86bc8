"""Where the time of one image-free training step goes, on the card.

    python3 -m ifseg_torch.tools.profile_training [--out FILE] [--batch 16]

Builds the ``Trainer`` at the reference configuration (OFA-Base 512px, batch
16, 15 classes, ``src_len`` 32, dropout and drop-path 0.1, random weights
from seed 0, no monitoring forward: the configuration ``chip_smoke.py``
trains) and prints

  * the device time of the parts of a step, by CUDA events: model forward,
    loss, backward, and clip + optimizer + EMA;
  * the all-layer relative-position bias gather of the decoder alone
    (6 x 12 x 1025 x 1025), forward and the ``index_add_`` backward;
  * a ``torch.profiler`` trace of a few steps: device time by kernel class
    (the attention kernels one by one, matrix products, layer norms, the
    index kernels of the bias gathers, the optimizer's multi-tensor kernels,
    everything else) and the device's busy share of the host's wall time;
  * peak device memory, and one JSON line with all of it.

``--out`` also writes the profiler's table of the top kernels to a file.
"""

import argparse
import json
import subprocess
import time

import numpy as np
import torch

SRC_LEN = 32
CLASSES = 15
PROFILED_STEPS = 3


def kernel_class(name: str) -> str:
    n = name.lower()
    if "attn_bias_fwd" in n:
        return "attention forward with stats (K1)" if "true" in n else "attention forward (K1 infer)"
    if "attn_bias_bwd_dq" in n:
        return "attention backward dq + dbias (K2)"
    if "attn_bias_bwd_dkv" in n:
        return "attention backward dk + dv (K3)"
    if "attn_bwd_di" in n:
        return "attention backward di pre-pass"
    if "gemm" in n or "nvjet" in n or "cublas" in n or "cutlass" in n:
        return "matrix products (cuBLAS)"
    if "layer_norm" in n or "layernorm" in n:
        return "layer norms"
    if "index" in n or "gather" in n or "scatter" in n:
        return "index kernels (bias gathers, index_add_, embeddings)"
    if "multi_tensor" in n or "foreach" in n:
        return "optimizer (multi-tensor kernels)"
    if "conv" in n or "cudnn" in n:
        return "convolutions (cuDNN)"
    return "elementwise, casts, copies, reductions"


def events(n):
    return [torch.cuda.Event(enable_timing=True) for _ in range(n)]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="file for the profiler's kernel table")
    ap.add_argument("--batch", type=int, default=16)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_training: needs a CUDA device")

    from ifseg_torch.config import Config, model_config_for_arch
    from ifseg_torch.data.artificial import artificial_batch
    from ifseg_torch.models.encoder import stack_tables
    from ifseg_torch.models.position import gather_grid_bias_all_layers, make_image_bucket_position
    from ifseg_torch.train import optim as optim_lib
    from ifseg_torch.train.criterion import compute_imfree_loss
    from ifseg_torch.train.trainer import Trainer

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    cfg = Config(model=model_config_for_arch(
        "segofa_base", patch_image_size=512, orig_patch_image_size=512,
        num_seg_tokens=CLASSES, dtype="bfloat16"))
    cfg.optimization.seed = 0
    cfg.criterion.monitor_real_batch = False
    rng = np.random.default_rng(0)
    tokens = rng.integers(4, 50000, size=(CLASSES + 1, 3))
    lengths = rng.integers(1, 4, size=(CLASSES + 1,))
    trainer = Trainer(cfg, tokens, lengths, total_num_updates=100).init_state()
    model = trainer.model
    src = rng.integers(4, 50000, size=SRC_LEN)
    new_batch = lambda: artificial_batch(rng, args.batch, 512, CLASSES, src)

    for _ in range(2):  # warm-up: kernels loaded, allocator settled
        trainer.train_step(new_batch())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # the parts of a step, as train_step runs them
    parts = {"forward": 0.0, "loss": 0.0, "backward": 0.0, "clip + optimizer": 0.0}
    reps = 3
    for _ in range(reps):
        batch = trainer.prepare_batch(new_batch())
        model.train()
        e = events(5)
        e[0].record()
        _, extra = model(aux_grid_ids=batch["aux_grid_ids"], aux_src_tokens=batch["src_tokens"],
                         bos_tokens=batch["bos_tokens"], class_tokens=trainer.class_tokens,
                         class_lengths=trainer.class_lengths)
        e[1].record()
        loss = compute_imfree_loss(extra["aux_output"], batch["aux_target"], CLASSES, (32, 32))
        e[2].record()
        loss.backward()
        e[3].record()
        params = trainer.optimizer.params
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        optim_lib.clip_by_global_norm(grads, cfg.optimization.clip_norm)
        trainer.optimizer.step(grads)
        for p in params:
            p.grad = None
        e[4].record()
        torch.cuda.synchronize()
        for i, name in enumerate(parts):
            parts[name] += e[i].elapsed_time(e[i + 1]) / reps
        del extra, loss, grads
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    for name, ms in parts.items():
        print(f"part {name}: {ms:.3f} ms (batch {args.batch})", flush=True)
    print(f"part sum: {sum(parts.values()):.3f} ms; max_memory_allocated {peak_gib:.2f} GiB",
          flush=True)

    # the decoder's all-layer seg-bias gather alone, forward and backward
    sb = cfg.model.seg_bucket_size
    bucket = make_image_bucket_position(sb, (2 * sb - 1) * (2 * sb - 1) + 3)
    table = stack_tables(model.decoder.seg_rel_pos_table_list).detach().requires_grad_(True)
    e = events(3)
    gather = {"forward": 0.0, "backward (index_add_)": 0.0}
    for i in range(reps + 1):
        e[0].record()
        pack = gather_grid_bias_all_layers(table, bucket, (sb, sb), bos=True, dtype=torch.bfloat16)
        e[1].record()
        pack.backward(torch.ones_like(pack))
        e[2].record()
        torch.cuda.synchronize()
        if i:  # the first run warms up
            gather["forward"] += e[0].elapsed_time(e[1]) / reps
            gather["backward (index_add_)"] += e[1].elapsed_time(e[2]) / reps
        del pack
    for name, ms in gather.items():
        print(f"seg-bias gather {name}: {ms:.3f} ms", flush=True)

    from torch.profiler import ProfilerActivity, profile

    batches = [new_batch() for _ in range(PROFILED_STEPS)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for batch in batches:
            trainer.train_step(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / PROFILED_STEPS
    by_class = {}
    device_ms = 0.0
    for ev in prof.key_averages():
        t = getattr(ev, "self_device_time_total", None)
        if t is None:
            t = getattr(ev, "self_cuda_time_total", 0.0)
        if not t or getattr(ev, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        ms = t / 1e3 / PROFILED_STEPS
        device_ms += ms
        cls = kernel_class(ev.key)
        by_class[cls] = by_class.get(cls, 0.0) + ms
    for cls, ms in sorted(by_class.items(), key=lambda kv: -kv[1]):
        print(f"device {cls}: {ms:.3f} ms per step", flush=True)
    busy = device_ms / wall_ms if wall_ms else float("nan")
    print(f"per step: wall {wall_ms:.3f} ms, device busy {device_ms:.3f} ms, "
          f"busy share {busy:.3f}, on {card}", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=60))
    print(json.dumps({"card": card, "batch": args.batch, "part_ms": parts,
                      "seg_bias_gather_ms": gather, "device_ms_by_class": by_class,
                      "device_ms": device_ms, "wall_ms": wall_ms, "busy_share": busy,
                      "max_memory_gib": peak_gib}))


if __name__ == "__main__":
    main()
