"""The Hopper attention kernel against its plain version, on the card.

Marked ``gpu``: it needs an NVIDIA card and ``nvcc`` and skips without them
(decided inside the test).  Run it on a card with
``python -m pytest tests/test_torch_kernel_gpu.py -m gpu``.  Tolerance 2e-2:
the kernel rounds the probabilities to bf16 inside its P·V product, the plain
version computes in fp32 from the same bf16 inputs.
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
