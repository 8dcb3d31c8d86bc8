"""The di pre-pass alone, on the card: di = rowsum(do ∘ out) per head.

    python3 -m ifseg_torch.tools.time_di [--against PATH ...]

Times ``flash_attention_bwd_di`` (``csrc/flash_attention_bias_bwd_dq.cu``) at
the three attention sites of an OFA-Base training step (batch 16, 12 heads
of 64) and of a SegOFA-Huge one (batch 16, 16 heads of 80), each call queued
behind matrix products so that the events bracket device time (one launch
costs the host more than the card), against its bound: do and out read
once, di written once, at 3.35 TB/s.

With ``--against PATH``, PATH is another checkout of this repository (an
older tree, or a copy with the pre-pass edited): its bwd_dq source is built
there with its own ``ops/build.py``, its di is checked against this tree's
on the same inputs, and the two are timed in turns (theirs, ours, ours,
theirs) at every site the other entry takes (a tree from before head dim 80
has an entry without the head-dim argument, and only the OFA-Base sites).
One JSON line at the end.
"""

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

PEAK_BYTES_PER_S = 3.35e12
# (site, batch, Lq, heads, head dim)
SITES = [
    ("OFA-Base encoder self", 16, 1056, 12, 64),
    ("OFA-Base decoder self", 16, 1025, 12, 64),
    ("OFA-Base decoder cross", 16, 1025, 12, 64),
    ("Huge encoder self", 16, 1056, 16, 80),
    ("Huge decoder self", 16, 1025, 16, 80),
    ("Huge decoder cross", 16, 1025, 16, 80),
]
_P, _I = ctypes.c_void_p, ctypes.c_int


def queued_ms(fn, iters: int = 50, warmup: int = 3) -> float:
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


def entry(library: Path, with_head_dim: bool):
    fn = ctypes.CDLL(str(library)).flash_attention_bwd_di
    fn.argtypes = [_P] * 3 + [_I] * (4 if with_head_dim else 3) + [_P]
    fn.restype = ctypes.c_int
    return fn


def other_entry(path: Path):
    """(entry, takes a head dim) of the di pre-pass of the checkout at ``path``."""
    name = "flash_attention_bias_bwd_dq"
    subprocess.run([sys.executable, "-c", f"from ifseg_torch.ops import build; build.build(['{name}'])"],
                   cwd=path, check=True)
    src = (path / "ifseg_torch" / "csrc" / f"{name}.cu").read_text()
    sig = re.search(r"flash_attention_bwd_di\(([^)]*)\)", src).group(1)
    with_head_dim = "int D" in sig
    library = max((path / "ifseg_torch" / "_build").glob(f"lib{name}-*.so"),
                  key=lambda p: p.stat().st_mtime)
    return entry(library, with_head_dim), with_head_dim


def call(fn, with_head_dim, g, o, di, b, h, d, lq):
    stream = torch.cuda.current_stream().cuda_stream
    dims = (b, h, d, lq) if with_head_dim else (b, h, lq)
    rc = fn(g.data_ptr(), o.data_ptr(), di.data_ptr(), *dims, stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_bwd_di launch failed: cudaError {rc}")


def main():
    from ifseg_torch.ops import build
    from ifseg_torch.ops import flash_attention as fa

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--against", type=Path, nargs="*", default=[],
                        help="other checkouts whose di pre-pass to time beside this tree's")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    ours = entry(build.build([fa.KERNEL_BWD_DQ])[fa.KERNEL_BWD_DQ].path, True)
    others = {str(p): other_entry(p.resolve()) for p in args.against}
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for name, b, lq, h, d in SITES:
        g = torch.randn(b, lq, h * d, generator=gen, device="cuda").bfloat16()
        o = torch.randn(b, lq, h * d, generator=gen, device="cuda").bfloat16()
        di = torch.empty(b, h, lq, device="cuda")
        call(ours, True, g, o, di, b, h, d, lq)
        torch.cuda.synchronize()
        err = ((di - fa.attention_di_reference(g, o, h)).abs().max()
               / fa.attention_di_reference(g, o, h).abs().max()).item()
        bound = (2 * g.numel() * 2 + di.numel() * 4) / PEAK_BYTES_PER_S * 1e3
        row = dict(site=name, B=b, Lq=lq, H=h, D=d, bound_ms=bound, rel_err=err, card=card,
                   ms=queued_ms(lambda: call(ours, True, g, o, di, b, h, d, lq)))
        line = f"{name}: B={b} Lq={lq} H={h} D={d}: {row['ms']:.4f} ms ({bound / row['ms']:.3f} " \
               f"of the bound {bound:.4f} ms), rel err {err:.1e}"
        for path, (fn, with_head_dim) in others.items():
            if d != 64 and not with_head_dim:
                continue
            theirs = torch.empty_like(di)
            call(fn, with_head_dim, g, o, theirs, b, h, d, lq)
            torch.cuda.synchronize()
            if not torch.allclose(theirs, di, rtol=1e-5, atol=1e-5):
                raise SystemExit(f"{path}: its di differs from this tree's at {name}")
            t = [queued_ms(lambda: call(fn, with_head_dim, g, o, theirs, b, h, d, lq)),
                 queued_ms(lambda: call(ours, True, g, o, di, b, h, d, lq)),
                 queued_ms(lambda: call(ours, True, g, o, di, b, h, d, lq)),
                 queued_ms(lambda: call(fn, with_head_dim, g, o, theirs, b, h, d, lq))]
            row[path] = dict(theirs_ms=[t[0], t[3]], ours_ms=[t[1], t[2]])
            line += (f"; in turns against {path}: theirs {t[0]:.4f}, {t[3]:.4f} ms "
                     f"({bound / t[0]:.3f}, {bound / t[3]:.3f}), ours {t[1]:.4f}, {t[2]:.4f} ms "
                     f"({bound / t[1]:.3f}, {bound / t[2]:.3f})")
        rows.append(row)
        print(line, flush=True)
    print(json.dumps({"sites": rows}))


if __name__ == "__main__":
    main()
