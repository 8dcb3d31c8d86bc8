"""The attention forward kernel (K1) alone, on the card: what the bias costs.

    python3 -m ifseg_torch.tools.time_attention_forward

Times the kernel by CUDA events at the three attention sites of a served
batch-32 forward of OFA-Base 512px, at the decoder self-attention site of
an evaluation group of 8, and at two sites of a served batch-8 forward of
SegOFA-Huge (16 heads of 80), each with

  * its bias in row-padded storage (fetched by TMA),
  * the same bias dense (fetched by TMA where its rows are 16-byte aligned,
    else staged by the producer's threads),
  * the bias in fp32, row-padded (at head dim 80 the kernel then keeps one
    stage of its V ring, not two, for want of shared memory),
  * no bias at all,

and prints, beside each time, the bytes the call's CTAs stream out of L2 into
shared memory (Q once, K and V per key tile and query tile, the bias once per
batch row) and the rate that makes.  One JSON line at the end.
"""

import json
import subprocess

import torch

TILE_Q, TILE_K = 128, 128  # the kernel's query rows per CTA and keys per stage
# (site, batch, heads, head dim, Lq, Lk, causal)
SITES = [
    ("served encoder self", 32, 12, 64, 1056, 1056, False),
    ("served decoder self", 32, 12, 64, 1025, 1025, True),
    ("served decoder cross", 32, 12, 64, 1025, 1056, False),
    ("evaluation decoder self", 8, 12, 64, 1537, 1537, True),
    ("Huge served encoder self", 8, 16, 80, 1056, 1056, False),
    ("Huge served decoder self", 8, 16, 80, 1025, 1025, True),
]
LABELS = ("padded", "dense", "fp32", "none")


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def streamed_bytes(b, h, d, lq, lk, causal, bias_bytes) -> int:
    """Bytes that the call's CTAs fetch from L2: per 128-row query tile of one
    (batch row, head) Q once and, for every key tile it visits, 128 keys of K
    and V and, with a bias, a 128 x 128 tile of it (``bias_bytes`` an
    element, 0 without)."""
    head_row = d * 2
    total = 0
    for m0 in range(0, lq, TILE_Q):
        tiles = -(-lk // TILE_K)
        if causal:
            tiles = min(tiles, (min(m0 + TILE_Q, lq) - 1 + lk - lq) // TILE_K + 1)
        total += TILE_Q * head_row + tiles * (2 * TILE_K * head_row
                                              + TILE_Q * TILE_K * bias_bytes)
    return total * b * h


def main():
    from ifseg_torch.ops import flash_attention as fa

    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for name, b, h, d, lq, lk, causal in SITES:
        e = h * d
        q, k, v = (torch.randn(b, n, e, generator=gen, device="cuda").mul(s).bfloat16()
                   for n, s in ((lq, 0.3), (lk, 0.3), (lk, 1.0)))
        dense = torch.randn(h, lq, lk, generator=gen, device="cuda").bfloat16()
        padded = fa.row_padded(dense)
        fp32 = fa.row_padded(dense.float())
        row = dict(site=name, B=b, H=h, D=d, Lq=lq, Lk=lk, causal=causal, card=card,
                   dense_bias_by_tma=lk % 8 == 0,
                   fp32_smem_bytes=fa.smem_bytes(fa.KERNEL, True, d))
        for label, bias in zip(LABELS, (padded, dense, fp32, None)):
            ms = cuda_ms(lambda: fa.flash_attention_bias_packed_infer(
                q, k, v, bias, None, causal, h))
            gb = streamed_bytes(b, h, d, lq, lk, causal,
                                0 if bias is None else bias.element_size()) / 1e9
            row[f"{label}_ms"], row[f"{label}_l2_gb"] = ms, gb
            row[f"{label}_l2_tb_per_s"] = gb / ms
        rows.append(row)
        print(f"{name}: B={b} H={h} D={d} Lq={lq} Lk={lk} causal={causal}: "
              + "; ".join(f"bias {label} {row[label + '_ms']:.4f} ms, "
                          f"{row[label + '_l2_gb']:.3f} GB from L2, "
                          f"{row[label + '_l2_tb_per_s']:.2f} TB/s"
                          for label in LABELS), flush=True)
    print(json.dumps({"sites": rows}))


if __name__ == "__main__":
    main()
