"""The attention backward kernels (K2: dq + dbias, K3: dk + dv) alone, on the
card: what the bias and the dbias sum cost.

    python3 -m ifseg_torch.tools.time_attention_backward

Times each kernel by CUDA events at the three attention sites of a batch-16
training step of OFA-Base 512px (src_len 32), each with

  * its bias as the training path hands it over (bf16, rows 16-byte aligned:
    dense at 1,056 keys, row-padded storage at 1,025), fetched by TMA,
  * no bias at all,
  * for K2 also the bias without a gradient (``need_dbias=False``: no fp32
    workspace, no additions), so K2 with dbias minus this is what the sum
    over the batch costs, and the workspace's zeroing and rounding alone;

and prints, beside each time, the bytes the call's CTAs stream out of L2 into
shared memory (per CTA the resident tiles once and, for every tile of the
loop, the streamed operands and a bias tile) and the rate that makes.  One
JSON line at the end.

It calls the kernels through ``_launch_dq`` and ``_launch_dkv``, whose
signatures are those of the first backward kernels too: run with an older
checkout of the package first on ``PYTHONPATH`` it times that checkout's
kernels, with the bias dense (they took no other; the L2 bytes printed are
this design's, not theirs).
"""

import json
import subprocess

import torch

HEADS = 12
BATCH = 16
# (site, Lq, Lk, causal, key mask): the training step's three site shapes
SITES = [
    ("encoder self", 1056, 1056, False, True),
    ("decoder self", 1025, 1025, True, False),
    ("decoder cross", 1025, 1056, False, True),
]
K2_ROWS, K2_KEYS = 128, 64  # K2: query rows per CTA, keys per stage
K3_KEYS, K3_ROWS = 128, 64  # K3: keys per CTA, query rows per stage


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


def streamed_bytes(kernel, lq, lk, causal, with_bias) -> int:
    """Bytes the call's CTAs fetch from L2.  K2: per 128-row query tile Q and
    dO once and, for every 64-key stage it visits, K, V and a 128 x 64 bf16
    bias tile.  K3: per 128 keys K and V once and, for every 64-row query
    stage, Q, dO and a 64 x 128 bf16 bias tile."""
    head_row = 64 * 2
    total = 0
    if kernel == "dq":
        for m0 in range(0, lq, K2_ROWS):
            tiles = -(-lk // K2_KEYS)
            if causal:
                tiles = min(tiles, (min(m0 + K2_ROWS, lq) - 1 + lk - lq) // K2_KEYS + 1)
            total += 2 * K2_ROWS * head_row + tiles * (
                2 * K2_KEYS * head_row + (K2_ROWS * K2_KEYS * 2 if with_bias else 0))
    else:
        m_tiles = -(-lq // K3_ROWS)
        for n0 in range(0, lk, K3_KEYS):
            first = max(0, n0 - (lk - lq)) // K3_ROWS if causal else 0
            total += 2 * K3_KEYS * head_row + (m_tiles - first) * (
                2 * K3_ROWS * head_row + (K3_ROWS * K3_KEYS * 2 if with_bias else 0))
    return total * BATCH * HEADS


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
    for name, lq, lk, causal, masked in SITES:
        e = HEADS * fa.HEAD_DIM
        q, k, v, g = (torch.randn(BATCH, n, e, generator=gen, device="cuda").mul(s).bfloat16()
                      for n, s in ((lq, 0.3), (lk, 0.3), (lk, 1.0), (lq, 1.0)))
        bias = torch.randn(HEADS, lq, lk, generator=gen, device="cuda").bfloat16()
        if hasattr(fa, "tma_rows"):  # this package's kernels take the bias by TMA only
            bias = fa.row_padded(bias)
        mask = None
        if masked:  # the last prompt ends in padding
            mask = torch.zeros(BATCH, lk, dtype=torch.bool, device="cuda")
            mask[-1, lk - 5:] = True
        out, lse = fa._launch(q, k, v, bias, mask, causal, HEADS, with_stats=True)
        di = fa._launch_di(g, out, HEADS)
        dq = lambda b_, need: fa._launch_dq(q, k, v, b_, mask, causal, g, lse, di, HEADS,
                                            need_dbias=need)
        dkv = lambda b_: fa._launch_dkv(q, k, v, b_, mask, causal, g, lse, di, HEADS)
        lqp, lkp = (-(-n // 64) * 64 + 64 for n in (lq, lk))  # covers either kernel's padding
        ws = torch.zeros(HEADS, lqp, lkp, device="cuda")
        row = dict(site=name, B=BATCH, Lq=lq, Lk=lk, causal=causal, card=card,
                   bias_pitch=bias.stride(1),
                   dq_bias_ms=cuda_ms(lambda: dq(bias, True)),
                   dq_bias_no_dbias_ms=cuda_ms(lambda: dq(bias, False)),
                   dq_no_bias_ms=cuda_ms(lambda: dq(None, False)),
                   dkv_bias_ms=cuda_ms(lambda: dkv(bias)),
                   dkv_no_bias_ms=cuda_ms(lambda: dkv(None)),
                   workspace_zero_round_ms=cuda_ms(
                       lambda: (ws.zero_(), ws[:, :lq, :lk].to(bias.dtype).contiguous())))
        row["dbias_sum_ms"] = row["dq_bias_ms"] - row["dq_bias_no_dbias_ms"]
        for kern, label in (("dq", "dq_bias"), ("dq", "dq_no_bias"), ("dkv", "dkv_bias"),
                            ("dkv", "dkv_no_bias")):
            gb = streamed_bytes(kern, lq, lk, causal, "no_bias" not in label) / 1e9
            row[f"{label}_l2_gb"], row[f"{label}_l2_tb_per_s"] = gb, gb / row[f"{label}_ms"]
        rows.append(row)
        print(f"{name}: B={BATCH} Lq={lq} Lk={lk} causal={causal} pitch {bias.stride(1)}: "
              f"K2 {row['dq_bias_ms']:.4f} ms ({row['dq_bias_l2_gb']:.3f} GB from L2, "
              f"{row['dq_bias_l2_tb_per_s']:.2f} TB/s), without dbias "
              f"{row['dq_bias_no_dbias_ms']:.4f} (the sum: {row['dbias_sum_ms']:.4f}; workspace "
              f"zero + round {row['workspace_zero_round_ms']:.4f}), without a bias "
              f"{row['dq_no_bias_ms']:.4f}; K3 {row['dkv_bias_ms']:.4f} ms "
              f"({row['dkv_bias_l2_gb']:.3f} GB, {row['dkv_bias_l2_tb_per_s']:.2f} TB/s), "
              f"without a bias {row['dkv_no_bias_ms']:.4f}", flush=True)
        del q, k, v, g, bias, out, lse, di, ws
        torch.cuda.empty_cache()
    print(json.dumps({"sites": rows}))


if __name__ == "__main__":
    main()
