"""The port at SegOFA-Huge's sizes, on the CPU: head dim 80 and LayerNorm
widths above 4,096, against the JAX package.

On a card those sizes take their own kernel instantiations (the attention
kernels at D = 80, the CTA-per-row LayerNorm); on the CPU the port runs the
plain versions, which are what those kernels are held against on the card.
Here the plain versions are held against the JAX package's Pallas kernels in
interpret mode, and a model of head dim 80 (the tiny arch at width 160 with
2 heads) against the JAX model.

Tolerances, those of the same checks at D = 64 and width 256: the attention
forward 2e-5 in fp32 and 2e-2 in bf16 (tests/test_torch_attention.py); the
stats forward and the backward 2e-4, a bf16 dbias one bf16 ulp
(tests/test_torch_attention_backward.py); the LayerNorm 1e-5 for an fp32
output and one bf16 ulp (2^-7 relative) for a bf16 output
(tests/test_torch_layer_norm.py); served and image-free logits 2e-4 and the
gradients 1e-3 of each tensor's norm + 1e-7 (tests/test_torch_serving.py,
tests/test_torch_train_model.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ifseg_tpu.ops.flash_attention as jfa
from ifseg_torch.checkpoint.convert import state_dict_from_jax
from ifseg_torch.eval.serving import SegServer as TorchSegServer
from ifseg_torch.ops import flash_attention as tfa
from ifseg_torch.ops import layer_norm as tln
from ifseg_torch.train.criterion import compute_imfree_loss as t_imfree
from ifseg_tpu.eval.serving import SegServer as JaxSegServer
from ifseg_tpu.ops import layer_norm as jln
from ifseg_tpu.train.criterion import compute_imfree_loss as j_imfree

from torch_port_utils import class_table, make_pair, serving_inputs, train_batch

D = 80
# the tiny arch at head dim 80: width 160, 2 heads, 2 + 2 layers, FFN 640
HEAD_DIM_80 = dict(encoder_embed_dim=160, decoder_embed_dim=160, encoder_attention_heads=2,
                   decoder_attention_heads=2, encoder_layers=2, decoder_layers=2,
                   encoder_ffn_embed_dim=640, decoder_ffn_embed_dim=640)
NUM_SEG, HW = 5, 4


@pytest.fixture(autouse=True)
def force_interpret():
    old = jfa.INTERPRET
    jfa.INTERPRET = True
    yield
    jfa.INTERPRET = old


def _inputs(b, h, lq, lk, with_mask, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, lq, h * D)).astype(np.float32) * 0.3
    k = rng.normal(size=(b, lk, h * D)).astype(np.float32) * 0.3
    v = rng.normal(size=(b, lk, h * D)).astype(np.float32)
    bias = rng.normal(size=(h, lq, lk)).astype(np.float32)
    g = rng.normal(size=(b, lq, h * D)).astype(np.float32)
    mask = None
    if with_mask:
        mask = np.zeros((b, lk), bool)
        mask[-1, lk - 5:] = True
    return q, k, v, bias, g, mask


# ragged Lq / Lk on the edges of the kernels' tiles; (lq, lk, causal, mask)
ATTN_CASES = {
    "full": (64, 64, False, False),
    "causal": (40, 72, True, False),
    "mask": (33, 70, False, True),
    "causal-mask": (65, 65, True, True),
}


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_plain_forward_matches_pallas_at_head_dim_80(case, dtype):
    lq, lk, causal, with_mask = ATTN_CASES[case]
    tdt, jdt, tol = {"fp32": (torch.float32, jnp.float32, 2e-5),
                     "bf16": (torch.bfloat16, jnp.bfloat16, 2e-2)}[dtype]
    b, h = 2, 3
    q, k, v, bias, _, mask = _inputs(b, h, lq, lk, with_mask)
    want = jfa.flash_attention_bias_packed_infer(
        *(jnp.asarray(x, jdt) for x in (q, k, v, bias)),
        None if mask is None else jnp.asarray(mask), causal, h)
    got = tfa.attention_bias_reference(
        *(torch.from_numpy(x).to(tdt) for x in (q, k, v, bias)),
        None if mask is None else torch.from_numpy(mask), causal, h)
    assert got.dtype == tdt and tuple(got.shape) == (b, lq, h * D)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("bias_dtype", ["fp32", "bf16", None])
@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_plain_stats_backward_and_di_match_pallas_at_head_dim_80(case, bias_dtype):
    lq, lk, causal, with_mask = ATTN_CASES[case]
    b, h, tol = 2, 3, 2e-4
    q, k, v, bias, g, mask = _inputs(b, h, lq, lk, with_mask, seed=1)
    jbias = {None: None, "fp32": jnp.asarray(bias),
             "bf16": jnp.asarray(bias, jnp.bfloat16)}[bias_dtype]
    tbias = {None: None, "fp32": torch.from_numpy(bias),
             "bf16": torch.from_numpy(bias).bfloat16()}[bias_dtype]
    jmask = None if mask is None else jnp.asarray(mask)
    tmask = None if mask is None else torch.from_numpy(mask)
    jq, jk, jv, jg = (jnp.asarray(x) for x in (q, k, v, g))
    tq, tk, tv, tg = (torch.from_numpy(x) for x in (q, k, v, g))

    jout, jlse = jfa.flash_attention_bias_packed_stats(jq, jk, jv, jbias, jmask, causal, h)
    jdq, jdk, jdv, jdb = jfa._flash_backward(
        jq, jk, jv, jbias, jmask, causal, jg, jout, jlse, num_heads=h)
    out, lse = tfa.attention_bias_stats_reference(tq, tk, tv, tbias, tmask, causal, h)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=tol, rtol=tol)
    np.testing.assert_allclose(
        lse.numpy(), np.asarray(jlse).transpose(0, 1, 3, 2).reshape(b, h, lq), atol=tol, rtol=tol)

    # di = rowsum(g ∘ out) per head, the JAX package's pre-pass
    want_di = np.einsum("blhd,blhd->bhl", g.reshape(b, lq, h, D),
                        np.asarray(jout).reshape(b, lq, h, D))
    di = tfa.attention_di_reference(tg, out, h)
    assert tuple(di.shape) == (b, h, lq) and di.dtype == torch.float32
    np.testing.assert_allclose(di.numpy(), want_di, atol=tol, rtol=tol)

    dq, dk, dv, db = tfa.attention_bias_backward_reference(
        tq, tk, tv, tbias, tmask, causal, tg, out, lse, h)
    for got, want in ((dq, jdq), (dk, jdk), (dv, jdv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol, rtol=tol)
    if bias_dtype is None:
        assert db is None and jdb is None
    else:
        btol = tol if bias_dtype == "fp32" else 2 ** -7
        np.testing.assert_allclose(db.float().numpy(), np.asarray(jdb.astype(jnp.float32)),
                                   atol=btol, rtol=btol)


@pytest.mark.parametrize("head_dim,ok", [(64, True), (80, True), (72, False), (96, False)])
def test_kernel_check_takes_head_dims_64_and_80_only(head_dim, ok):
    """The check every launch runs first, on CPU tensors (it is
    device-independent): 64 and 80 pass, any other head dim raises."""
    b, h, lq, lk = 2, 4, 16, 24
    q = torch.zeros(b, lq, h * head_dim, dtype=torch.bfloat16)
    k = v = torch.zeros(b, lk, h * head_dim, dtype=torch.bfloat16)
    bias = torch.zeros(h, lq, lk, dtype=torch.bfloat16)
    if ok:
        tfa._check(q, k, v, bias, None, False, h)
    else:
        with pytest.raises(ValueError, match="head dims"):
            tfa._check(q, k, v, bias, None, False, h)


def _force_pallas(monkeypatch):
    monkeypatch.setattr(jln, "_use_pallas", lambda n, d: True)
    orig = jln.pl.pallas_call

    def interp_call(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(jln.pl, "pallas_call", interp_call)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16], ids=["fp32-out", "bf16-out"])
@pytest.mark.parametrize("in_dtype", [torch.float32, torch.bfloat16], ids=["fp32-in", "bf16-in"])
@pytest.mark.parametrize("width", [5120, 8192])
def test_layer_norm_reference_matches_pallas_at_wide_rows(monkeypatch, width, in_dtype, out_dtype):
    _force_pallas(monkeypatch)
    rng = np.random.default_rng(width)
    x = (rng.normal(size=(2, 5, width)) * 3 + 1).astype(np.float32)
    scale = (rng.normal(size=(width,)) * 0.2 + 1).astype(np.float32)
    bias = (rng.normal(size=(width,)) * 0.1).astype(np.float32)
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
    want = np.asarray(jln.fused_layer_norm(
        jnp.asarray(x, jdt[in_dtype]), jnp.asarray(scale), jnp.asarray(bias), 1e-5,
        jnp.dtype(jdt[out_dtype])).astype(jnp.float32))
    got = tln.layer_norm_reference(torch.from_numpy(x).to(in_dtype), torch.from_numpy(scale),
                                   torch.from_numpy(bias), 1e-5, out_dtype)
    assert got.dtype == out_dtype and tuple(got.shape) == x.shape
    tol = 1e-5 if out_dtype == torch.float32 else 2 ** -7
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=tol)
    # and the wrapper's check takes these widths (on a card: the CTA-per-row kernel)
    tln._check(torch.from_numpy(x).to(in_dtype), torch.from_numpy(scale),
               torch.from_numpy(bias), out_dtype)


@pytest.fixture(scope="module")
def pair80():
    return make_pair(seed=0, **HEAD_DIM_80)


def test_served_logits_match_jax_at_head_dim_80(pair80):
    jmodel, params, tmodel = pair80
    assert tmodel.cfg.encoder_embed_dim // tmodel.cfg.encoder_attention_heads == D
    src, img, bos = serving_inputs(seed=1)
    want = np.asarray(JaxSegServer(jmodel, params, src_len=10)(
        jnp.asarray(src), jnp.asarray(img), jnp.asarray(bos)))
    got = TorchSegServer(tmodel, src_len=10, device="cpu")(
        torch.from_numpy(src), torch.from_numpy(img), torch.from_numpy(bos))
    assert tuple(got.shape) == (2, 1 + HW * HW, NUM_SEG)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=2e-4)


def test_imfree_forward_and_gradients_match_jax_at_head_dim_80():
    jmodel, params, tmodel = make_pair(seed=1, **HEAD_DIM_80)
    tokens, lengths = class_table(NUM_SEG)
    batch = train_batch(seed=3)
    target = batch["aux_target"]

    def jaux(p):
        _, extra = jmodel.apply(
            {"params": p}, aux_grid_ids=jnp.asarray(batch["aux_grid_ids"]),
            aux_src_tokens=jnp.asarray(batch["src_tokens"]),
            bos_tokens=jnp.asarray(batch["bos_tokens"]), class_tokens=jnp.asarray(tokens),
            class_lengths=jnp.asarray(lengths), deterministic=True)
        return extra["aux_output"]

    def jloss(p):
        return j_imfree(jaux(p), jnp.asarray(target), NUM_SEG, (HW, HW), 0.0)

    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jlogits = np.asarray(jaux(jparams))
    jl, jgrads = jax.value_and_grad(jloss)(jparams)
    want = state_dict_from_jax(jax.device_get(jgrads))

    t = lambda x: torch.from_numpy(np.asarray(x)).long()
    for p in tmodel.parameters():
        p.requires_grad_(True)
    _, extra = tmodel(aux_grid_ids=t(batch["aux_grid_ids"]), aux_src_tokens=t(batch["src_tokens"]),
                      bos_tokens=t(batch["bos_tokens"]), class_tokens=t(tokens),
                      class_lengths=t(lengths))
    logits = extra["aux_output"]
    np.testing.assert_allclose(logits.detach().numpy(), jlogits, atol=2e-4, rtol=2e-4)
    loss = t_imfree(logits, torch.from_numpy(target).long(), NUM_SEG, (HW, HW), 0.0)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=2e-5)
    checked = 0
    for name, p in tmodel.named_parameters():
        ref = want[name].numpy()
        ref_norm = np.linalg.norm(ref)
        if p.grad is None:
            assert ref_norm == 0.0, name
            continue
        err = np.linalg.norm(p.grad.numpy() - ref)
        assert err <= 1e-3 * ref_norm + 1e-7, f"{name}: {err} vs norm {ref_norm}"
        checked += ref_norm > 1e-6
    assert checked > 100
