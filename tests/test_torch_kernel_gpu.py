"""The Hopper attention kernels against their plain versions, on the card.

Marked ``gpu``: they need an NVIDIA card and ``nvcc`` and skip without them
(decided inside the test).  Run them on a card with
``python -m pytest tests/test_torch_kernel_gpu.py -m gpu``.  Tolerances: the
forward output 2e-2 (the kernel rounds the probabilities to bf16 inside its
P·V product, the plain version computes in fp32 from the same bf16 inputs);
the row logsumexp 1e-3 (fp32 on both sides); dq, dk, dv and dbias 2e-2 of
the largest reference value (the kernels round p and ds to bf16 before their
last products and write bf16).
"""

import pytest
import torch

from ifseg_torch.ops import flash_attention as fa


@pytest.mark.gpu
@pytest.mark.parametrize(
    "lq,lk,causal,with_mask,bias_dtype",
    [
        (1056, 1056, False, True, torch.bfloat16),
        (1025, 1025, True, False, torch.bfloat16),
        (1025, 1056, False, True, torch.float32),
        (77, 130, True, True, torch.bfloat16),
        (5, 3, False, False, None),
    ],
)
def test_kernel_matches_plain(lq, lk, causal, with_mask, bias_dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator(device="cuda").manual_seed(0)
    b, h = 3, 4
    e = h * fa.HEAD_DIM

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * scale

    q = rnd(b, lq, e, scale=0.3).bfloat16()
    k = rnd(b, lk, e, scale=0.3).bfloat16()
    v = rnd(b, lk, e).bfloat16()
    bias = None if bias_dtype is None else rnd(h, lq, lk).to(bias_dtype)
    mask = None
    if with_mask:
        mask = torch.zeros(b, lk, dtype=torch.bool, device="cuda")
        mask[-1, lk - 9:] = True
    before = fa.LAUNCHES
    got = fa.flash_attention_bias_packed_infer(q, k, v, bias, mask, causal, h)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == before + 1
    want = fa.attention_bias_reference(
        q.float(), k.float(), v.float(), None if bias is None else bias.float(), mask, causal, h
    )
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert (got.float() - want).abs().max().item() <= 2e-2


def _rel(got, want):
    return (got.float() - want.float()).abs().max().item() / max(want.abs().max().item(), 1e-30)


@pytest.mark.gpu
@pytest.mark.parametrize(
    "b,lq,lk,causal,with_mask,bias_dtype",
    [
        (16, 1056, 1056, False, True, torch.bfloat16),   # encoder self, training shape
        (16, 1025, 1025, True, False, torch.bfloat16),   # decoder self
        (16, 1025, 1056, False, True, torch.bfloat16),   # decoder cross
        (3, 77, 130, True, True, torch.float32),         # ragged, fp32 bias
        (2, 70, 70, False, False, None),                 # no bias: no dbias
    ],
)
def test_stats_forward_and_backward_kernels_match_plain(b, lq, lk, causal, with_mask, bias_dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(1)
    h = 12 if b == 16 else 4
    e = h * fa.HEAD_DIM

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale

    q = rnd(b, lq, e, scale=0.3).bfloat16().requires_grad_(True)
    k = rnd(b, lk, e, scale=0.3).bfloat16().requires_grad_(True)
    v = rnd(b, lk, e).bfloat16().requires_grad_(True)
    bias = None if bias_dtype is None else rnd(h, lq, lk).to(bias_dtype).requires_grad_(True)
    mask = None
    if with_mask:
        mask = torch.zeros(b, lk, dtype=torch.bool, device="cuda")
        mask[-1, lk - 9:] = True
    g = rnd(b, lq, e).bfloat16()

    before = fa.launch_counts()
    out, lse = fa.flash_attention_bias_packed_stats(q, k, v, bias, mask, causal, h)
    out.backward(g)
    torch.cuda.synchronize()
    after = fa.launch_counts()
    assert {n: after[n] - before[n] for n in after} == dict(
        infer=0, stats=1, bwd_di=1, bwd_dq=1, bwd_dkv=1)

    f32 = lambda x: None if x is None else x.detach().float()
    want_out, want_lse = fa.attention_bias_stats_reference(
        f32(q), f32(k), f32(v), f32(bias), mask, causal, h)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    assert tuple(lse.shape) == (b, h, lq) and not lse.requires_grad
    assert (out.float() - want_out).abs().max().item() <= 2e-2
    assert (lse - want_lse).abs().max().item() <= 1e-3
    want = fa.attention_bias_backward_reference(
        f32(q), f32(k), f32(v), f32(bias), mask, causal, g.float(), f32(out), lse, h)
    for name, leaf, ref in zip(("dq", "dk", "dv", "dbias"), (q, k, v, bias), want):
        if leaf is None:
            assert ref is None
            continue
        assert leaf.grad.dtype == leaf.dtype and torch.isfinite(leaf.grad).all(), name
        assert _rel(leaf.grad, ref) <= 2e-2, name


@pytest.mark.gpu
def test_bias_without_grad_skips_the_dbias_workspace():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(2)
    b, h, l = 2, 4, 130
    q, k, v = (torch.randn(b, l, h * 64, generator=gen, device="cuda").bfloat16().requires_grad_(True)
               for _ in range(3))
    bias = torch.randn(h, l, l, generator=gen, device="cuda").bfloat16()
    fa.flash_attention_bias_packed(q, k, v, bias, None, True, h).float().sum().backward()
    torch.cuda.synchronize()
    assert bias.grad is None and torch.isfinite(q.grad).all()
