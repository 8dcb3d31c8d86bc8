"""The Hopper kernels against their plain versions, on the card, the
attention kernels at both head dims they are built for (64: OFA-Base; 80:
SegOFA-Huge), the LayerNorm kernel up to its widest rows.

Marked ``gpu``: they need an NVIDIA card and ``nvcc`` and skip without them
(decided inside the test).  Run them on a card with
``python -m pytest tests/test_torch_kernel_gpu.py -m gpu``.  Tolerances: the
forward output 2e-2 (the kernel rounds the probabilities to bf16 inside its
P·V product, the plain version computes in fp32 from the same bf16 inputs);
the row logsumexp 1e-3 (fp32 on both sides); dq, dk, dv and dbias 2e-2 of
the largest reference value (the kernels round p and ds to bf16 before their
last products and write bf16); the LayerNorm kernel one bf16 step for a bf16
output (the same fp32 value rounded once on both sides, the value itself
differing in its last bits) and 1e-5 for an fp32 output.
"""

import pytest
import torch

from ifseg_torch.ops import flash_attention as fa
from ifseg_torch.ops import layer_norm as ln


@pytest.mark.gpu
@pytest.mark.parametrize(
    "lq,lk,causal,with_mask,bias_dtype",
    [
        (1056, 1056, False, True, torch.bfloat16),
        (1025, 1025, True, False, torch.bfloat16),
        (1025, 1056, False, True, torch.float32),
        (77, 130, True, True, torch.bfloat16),
        (5, 3, False, False, None),
        (1537, 1537, True, "grid", torch.bfloat16),  # evaluation decoder self: causal + mask
        (203, 203, True, "grid", torch.float32),     # the same combination, ragged
        # the edges of the 128-row query tile and the 128-key stage; a bias whose
        # rows are 16-byte aligned (Lk 64, 128) goes by TMA, the others by threads
        (1, 1, True, False, torch.bfloat16),
        (1, 257, False, True, torch.bfloat16),
        (63, 64, True, True, torch.bfloat16),
        (64, 63, False, True, torch.float32),
        (65, 129, True, True, torch.bfloat16),       # causal with Lk > Lq
        (127, 128, False, True, None),
        (128, 127, False, False, torch.bfloat16),
        (128, 128, True, False, torch.float32),
        (129, 65, False, True, torch.float32),
        (129, 257, True, "tile", torch.bfloat16),    # a whole key tile padded, with causal
        (257, 257, True, "tile", "padded"),          # ... and the bias in row-padded storage
        (257, 1, False, False, torch.bfloat16),
        (1025, 1025, True, False, "padded"),         # the served decoder self-attention
        (130, 131, True, True, "offset"),            # a bias that starts 2 bytes off a 16-byte boundary
        (96, 128, False, False, "offset"),           # ... whose rows are 16-byte multiples apart
    ],
)
@pytest.mark.parametrize("head_dim", fa.HEAD_DIMS)
def test_kernel_matches_plain(lq, lk, causal, with_mask, bias_dtype, head_dim):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator(device="cuda").manual_seed(0)
    b, h = 3, 4
    e = h * head_dim

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * scale

    q = rnd(b, lq, e, scale=0.3).bfloat16()
    k = rnd(b, lk, e, scale=0.3).bfloat16()
    v = rnd(b, lk, e).bfloat16()
    if bias_dtype == "padded":
        bias = fa.row_padded(rnd(h, lq, lk).bfloat16())
        assert bias.stride(1) % 8 == 0 and bias.stride(1) > lk
    elif bias_dtype == "offset":  # a layer of a dense pack: no TMA from there, threads stage it
        bias = rnd(h * lq * lk + 1).bfloat16()[1:].view(h, lq, lk)
        assert bias.data_ptr() % 16 == 2
    else:
        bias = None if bias_dtype is None else rnd(h, lq, lk).to(bias_dtype)
    mask = None
    if with_mask == "grid":  # padded grid cells behind a BOS slot that stays valid
        mask = torch.zeros(b, lk, dtype=torch.bool, device="cuda")
        mask[:, 1:] = (torch.arange(lk - 1, device="cuda") % 48) >= 43
    elif with_mask:
        mask = torch.zeros(b, lk, dtype=torch.bool, device="cuda")
        mask[-1, max(lk - 9, 1):] = True
        if with_mask == "tile":
            mask[:, 128:256] = True
    before = fa.LAUNCHES
    got = fa.flash_attention_bias_packed_infer(q, k, v, bias, mask, causal, h)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == before + 1
    want = fa.attention_bias_reference(
        q.float(), k.float(), v.float(), None if bias is None else bias.float(), mask, causal, h
    )
    assert got.dtype == torch.bfloat16 and got.shape == want.shape and torch.isfinite(got).all()
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
        # the edges of the forward kernel's tiles (more than one key: with one,
        # every gradient but dv is exactly 0)
        (1, 1, 257, False, True, torch.bfloat16),
        (2, 63, 64, True, True, torch.bfloat16),
        (2, 65, 129, True, True, torch.bfloat16),
        (2, 128, 127, False, False, torch.bfloat16),
        (2, 129, 65, False, True, torch.float32),
        (2, 129, 257, True, "tile", torch.bfloat16),
        (2, 257, 257, True, "tile", "padded"),           # bias rows in padded storage
    ],
)
@pytest.mark.parametrize("head_dim", fa.HEAD_DIMS)
def test_stats_forward_and_backward_kernels_match_plain(b, lq, lk, causal, with_mask, bias_dtype,
                                                        head_dim):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(1)
    h = (12 if head_dim == 64 else 16) if b == 16 else 4  # OFA-Base's or Huge's heads
    e = h * head_dim

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale

    q = rnd(b, lq, e, scale=0.3).bfloat16().requires_grad_(True)
    k = rnd(b, lk, e, scale=0.3).bfloat16().requires_grad_(True)
    v = rnd(b, lk, e).bfloat16().requires_grad_(True)
    if bias_dtype == "padded":  # both passes read the view by TMA
        bias = fa.row_padded(rnd(h, lq, lk).bfloat16()).requires_grad_(True)
        assert not bias.is_contiguous()
    else:
        bias = None if bias_dtype is None else rnd(h, lq, lk).to(bias_dtype).requires_grad_(True)
    mask = None
    if with_mask:
        mask = torch.zeros(b, lk, dtype=torch.bool, device="cuda")
        mask[-1, max(lk - 9, 1):] = True
        if with_mask == "tile":
            mask[:, 128:256] = True
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
@pytest.mark.parametrize(
    "lq,lk,causal,with_mask,bias_kind,need_dbias",
    [
        # the edges of the dq kernel's 128-row CTAs and 64-key stages and of
        # the dk + dv kernel's 128-key CTAs and 64-row stages
        (1, 257, False, True, "bf16", True),
        (63, 64, True, True, "bf16", True),
        (64, 63, False, True, "fp32", True),
        (65, 129, True, True, "padded", True),
        (127, 128, True, False, "fp32", True),
        (128, 127, False, True, "bf16", True),     # dense, rows not aligned: row-padded by a copy
        (129, 65, False, True, "padded", True),
        (129, 257, True, "tile", "bf16", True),
        (257, 257, True, "tile", "padded", True),
        (257, 129, False, True, "fp32", True),
        (192, 320, True, "tile", "padded-fp32", True),
        (1025, 1025, True, False, "padded", True),  # the training decoder self-attention
        (130, 131, True, True, "bf16", False),      # a bias without a gradient: no workspace
        (257, 257, False, "tile", "padded", False),
        (129, 257, True, True, None, True),         # no bias
        (64, 64, False, False, None, True),
    ],
)
@pytest.mark.parametrize("head_dim", fa.HEAD_DIMS)
def test_backward_kernels_match_plain_at_tile_edges(lq, lk, causal, with_mask, bias_kind,
                                                    need_dbias, head_dim):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(6)
    b, h = 2, 4
    e = h * head_dim

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale

    q, k = rnd(b, lq, e, scale=0.3).bfloat16(), rnd(b, lk, e, scale=0.3).bfloat16()
    v, g = rnd(b, lk, e).bfloat16(), rnd(b, lq, e).bfloat16()
    bias = None
    if bias_kind is not None:
        dtype = torch.float32 if "fp32" in bias_kind else torch.bfloat16
        if bias_kind.startswith("padded"):  # storage rows 8 to 15 elements longer than Lk
            bias = rnd(h, lq, (lk // 8 + 2) * 8).to(dtype)[..., :lk]
            assert not bias.is_contiguous() and fa.tma_rows(bias)
        else:
            bias = rnd(h, lq, lk).to(dtype)
    mask = None
    if with_mask:
        mask = torch.zeros(b, lk, dtype=torch.bool, device="cuda")
        mask[-1, max(lk - 9, 1):] = True
        if with_mask == "tile":
            mask[:, 128:256] = True
    out, lse = fa._launch(q, k, v, bias, mask, causal, h, with_stats=True)
    before, copies = fa.launch_counts(), fa.BWD_BIAS_COPIES
    dq, dk, dv, dbias = fa._launch_backward(q, k, v, bias, mask, causal, g, out, lse, h,
                                            need_dbias=need_dbias)
    torch.cuda.synchronize()
    after = fa.launch_counts()
    assert {n: after[n] - before[n] for n in after} == dict(
        infer=0, stats=0, bwd_di=1, bwd_dq=1, bwd_dkv=1)
    assert fa.BWD_BIAS_COPIES - copies == int(bias is not None and not fa.tma_rows(bias))

    f32 = lambda x: None if x is None else x.float()
    want = fa.attention_bias_backward_reference(
        f32(q), f32(k), f32(v), f32(bias), mask, causal, f32(g), f32(out), lse, h)
    for name, got, ref, like in zip(("dq", "dk", "dv"), (dq, dk, dv), want, (q, k, v)):
        assert got.dtype == torch.bfloat16 and got.shape == like.shape, name
        assert torch.isfinite(got).all() and _rel(got, ref) <= 2e-2, name
    if bias is None or not need_dbias:
        assert dbias is None
    else:
        assert dbias.dtype == bias.dtype and tuple(dbias.shape) == (h, lq, lk)
        assert torch.isfinite(dbias).all() and _rel(dbias, want[3]) <= 2e-2


@pytest.mark.gpu
def test_backward_copies_only_a_bias_tma_cannot_take():
    """A bias in row-padded storage, or dense with 16-byte rows, goes to the
    kernels as it is; a dense bias of 1,025 keys is row-padded by one copy."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(7)
    b, h, lq = 2, 4, 70
    for lk, make, copies in ((1025, fa.row_padded, 0), (1056, lambda x: x, 0),
                             (1025, lambda x: x, 1)):
        q = torch.randn(b, lq, h * 64, generator=gen, device="cuda").bfloat16()
        k, v = (torch.randn(b, lk, h * 64, generator=gen, device="cuda").bfloat16()
                for _ in range(2))
        bias = make(torch.randn(h, lq, lk, generator=gen, device="cuda").bfloat16())
        out, lse = fa._launch(q, k, v, bias, None, True, h, with_stats=True)
        before = fa.BWD_BIAS_COPIES
        fa._launch_backward(q, k, v, bias, None, True, torch.ones_like(q), out, lse, h)
        torch.cuda.synchronize()
        assert fa.BWD_BIAS_COPIES - before == copies, lk
    with pytest.raises(ValueError, match="16-byte"):  # below the wrapper nothing copies
        fa._launch_dq(q, k, v, bias, None, True, torch.ones_like(q), lse, lse, h)


@pytest.mark.gpu
@pytest.mark.parametrize("b,lq,h,head_dim", [
    (16, 1056, 12, 64),  # the three OFA-Base training sites: encoder self,
    (16, 1025, 12, 64),  # decoder self and cross (their query rows)
    (3, 77, 16, 80),     # Huge's heads, ragged rows
    (2, 1056, 16, 80),
    (1, 5, 384, 64),     # the most heads the pre-pass takes
])
def test_di_prepass_matches_plain(b, lq, h, head_dim):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(8)
    g = torch.randn(b, lq, h * head_dim, generator=gen, device="cuda").bfloat16()
    out = torch.randn(b, lq, h * head_dim, generator=gen, device="cuda").bfloat16()
    before = fa.LAUNCHES_BWD_DI
    di = fa._launch_di(g, out, h)
    torch.cuda.synchronize()
    assert fa.LAUNCHES_BWD_DI == before + 1
    want = fa.attention_di_reference(g, out, h)  # fp32 sums of the same bf16 products
    assert di.dtype == torch.float32 and di.shape == want.shape == (b, h, lq)
    assert _rel(di, want) <= 1e-3


@pytest.mark.gpu
def test_head_dim_and_heads_the_kernels_do_not_take_raise_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x = torch.zeros(2, 70, 4 * 72, dtype=torch.bfloat16, device="cuda")
    before = fa.launch_counts()
    with pytest.raises(ValueError, match="head dims"):
        fa.flash_attention_bias_packed_infer(x, x, x, None, None, False, 4)
    g = torch.zeros(1, 3, 385 * 64, dtype=torch.bfloat16, device="cuda")
    lse = torch.zeros(1, 385, 3, device="cuda")
    with pytest.raises(ValueError, match="heads"):
        fa._check_backward(g, g, g, lse, 385)
    assert fa.launch_counts() == before


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


def _within_bf16_step(got, want):
    """One bf16 step is at most 2^-7 of the value; near 0 the fp32 tolerance."""
    diff = (got.float() - want.float()).abs()
    return bool((diff <= want.float().abs() * 2.0 ** -7 + 1e-5).all())


@pytest.mark.gpu
@pytest.mark.parametrize(
    "rows,width,in_dtype,out_dtype",
    [
        (33792, 768, torch.bfloat16, torch.bfloat16),    # a served encoder site
        (33792, 3072, torch.bfloat16, torch.bfloat16),   # ffn_layernorm
        (1056, 768, torch.float32, torch.float32),       # position embeddings
        (12544, 768, torch.bfloat16, torch.bfloat16),    # an evaluation group of 8, encoder
        (12296, 3072, torch.bfloat16, torch.bfloat16),   # ... its decoder ffn_layernorm
        (1537, 768, torch.float32, torch.float32),       # ... its seg position LayerNorm
        (1001, 768, torch.bfloat16, torch.float32),      # ragged row count
        (77, 32, torch.float32, torch.bfloat16),         # the tiny test width
        (5, 8, torch.bfloat16, torch.bfloat16),          # narrowest
        (333, 4096, torch.bfloat16, torch.bfloat16),     # widest of the warp-per-row kernel
        (64, 1000, torch.float32, torch.float32),        # tail groups predicated off
        # the CTA-per-row kernel: Huge's ffn_layernorm (8,448 rows: a served
        # batch of 8), wider rows up to the maximum, both dtypes in and out
        (8448, 5120, torch.bfloat16, torch.bfloat16),
        (77, 5120, torch.float32, torch.bfloat16),
        (75, 5120, torch.bfloat16, torch.float32),
        (73, 5120, torch.float32, torch.float32),
        (33, 4104, torch.bfloat16, torch.float32),       # just above 4,096, tail groups off
        (129, 8192, torch.float32, torch.float32),
        (65, 8192, torch.bfloat16, torch.float32),
        (63, 8192, torch.bfloat16, torch.bfloat16),
        (61, 8192, torch.float32, torch.bfloat16),
        (31, 16384, torch.bfloat16, torch.bfloat16),     # the widest
        (17, 16384, torch.float32, torch.float32),
        (19, 16384, torch.bfloat16, torch.float32),
        (21, 16384, torch.float32, torch.bfloat16),
    ],
)
def test_layer_norm_kernel_matches_plain(rows, width, in_dtype, out_dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator(device="cuda").manual_seed(3)
    x = (torch.randn(rows, width, generator=g, device="cuda") * 3 + 1).to(in_dtype)
    scale = torch.randn(width, generator=g, device="cuda") * 0.2 + 1
    bias = torch.randn(width, generator=g, device="cuda") * 0.1
    before = ln.LAUNCHES
    got = ln.fused_layer_norm(x, scale, bias, 1e-5, out_dtype)
    torch.cuda.synchronize()
    assert ln.LAUNCHES == before + 1
    want = ln.layer_norm_reference(x, scale, bias, 1e-5, out_dtype)
    assert got.dtype == out_dtype and got.shape == x.shape and torch.isfinite(got).all()
    if out_dtype == torch.bfloat16:
        assert _within_bf16_step(got, want)
    else:
        assert (got - want).abs().max().item() <= 1e-5


@pytest.mark.gpu
def test_layer_norm_kernel_takes_leading_axes_and_strided_input():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator(device="cuda").manual_seed(4)
    x = torch.randn(4, 50, 64, generator=g, device="cuda").bfloat16()
    scale, bias = torch.ones(64, device="cuda"), torch.zeros(64, device="cuda")
    view = x[:, :33]  # rows of the batch are not dense: copied once, then the kernel
    got = ln.fused_layer_norm(view, scale, bias, 1e-5, torch.float32)
    want = ln.layer_norm_reference(view, scale, bias, 1e-5, torch.float32)
    assert got.shape == (4, 33, 64) and (got - want).abs().max().item() <= 1e-5


@pytest.mark.gpu
def test_layer_norm_on_cuda_raises_on_unsupported_width():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    before = ln.LAUNCHES
    for d in (100, ln.MAX_WIDTH + 8):
        with pytest.raises(ValueError, match="width"):
            ln.fused_layer_norm(torch.zeros(4, d, device="cuda"), torch.ones(d, device="cuda"),
                                torch.zeros(d, device="cuda"))
    assert ln.LAUNCHES == before


@pytest.mark.gpu
def test_layer_norm_function_gradients_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator(device="cuda").manual_seed(5)
    x = (torch.randn(512, 768, generator=g, device="cuda") * 2).bfloat16().requires_grad_(True)
    scale = (torch.randn(768, generator=g, device="cuda") * 0.2 + 1).requires_grad_(True)
    bias = torch.zeros(768, device="cuda", requires_grad=True)
    dy = torch.randn(512, 768, generator=g, device="cuda").bfloat16()
    got = torch.autograd.grad(ln.fused_layer_norm(x, scale, bias, 1e-5, torch.bfloat16),
                              (x, scale, bias), dy)
    want = torch.autograd.grad(
        torch.nn.functional.layer_norm(x.float(), (768,), scale, bias, 1e-5).bfloat16(),
        (x, scale, bias), dy)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and _rel(a, b) <= 2e-2


@pytest.mark.gpu
def test_phase_14_codec_digests():
    """chip_smoke.py phase 14's JPEG files, written and read by the port's
    codecs on the card's machine, against the digests of PIL's bytes and
    pixels pinned in the script."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import chip_smoke

    assert len(chip_smoke.jpeg_files()) == len(chip_smoke.JPEG_CASES)
