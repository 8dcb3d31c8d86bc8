"""The port's plain attention against the JAX package's Pallas kernel.

``ifseg_torch.ops.flash_attention.attention_bias_reference`` is what the
port runs on CPU tensors and what the Hopper kernel is held against on the
card; here it is held against ``flash_attention_bias_packed_infer`` of the
JAX package, run in Pallas interpret mode on the CPU.

Tolerances: fp32 inputs 2e-5 (both sides accumulate in fp32 and differ only
in summation order); bf16 inputs 2e-2 (both round the probabilities to bf16
before the P·V product, at different points of their sums).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import ifseg_tpu.ops.flash_attention as jfa
from ifseg_torch.ops import flash_attention as tfa
import torch_port_utils  # noqa: F401,E402  (pins torch's threads under xdist)


@pytest.fixture(autouse=True)
def force_interpret():
    old = jfa.INTERPRET
    jfa.INTERPRET = True
    yield
    jfa.INTERPRET = old


def _inputs(b, h, lq, lk, d, with_mask, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, lq, h * d)).astype(np.float32) * 0.3
    k = rng.normal(size=(b, lk, h * d)).astype(np.float32) * 0.3
    v = rng.normal(size=(b, lk, h * d)).astype(np.float32)
    bias = rng.normal(size=(h, lq, lk)).astype(np.float32)
    mask = None
    if with_mask:
        mask = np.zeros((b, lk), bool)
        mask[-1, lk - 5:] = True
    return q, k, v, bias, mask


DTYPES = {
    "fp32": (torch.float32, jnp.float32, 2e-5),
    "bf16": (torch.bfloat16, jnp.bfloat16, 2e-2),
}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("lq,lk", [(64, 64), (40, 72)], ids=["square", "ragged"])
@pytest.mark.parametrize("with_mask", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_plain_matches_pallas(causal, with_mask, lq, lk, dtype):
    tdt, jdt, tol = DTYPES[dtype]
    b, h, d = 2, 2, 64
    q, k, v, bias, mask = _inputs(b, h, lq, lk, d, with_mask)

    want = jfa.flash_attention_bias_packed_infer(
        *(jnp.asarray(x, jdt) for x in (q, k, v, bias)),
        None if mask is None else jnp.asarray(mask), causal, h,
    )
    want = np.asarray(want.astype(jnp.float32))
    got = tfa.attention_bias_reference(
        *(torch.from_numpy(x).to(tdt) for x in (q, k, v, bias)),
        None if mask is None else torch.from_numpy(mask), causal, h,
    )
    assert got.dtype == tdt and tuple(got.shape) == (b, lq, h * d)
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=tol)


def test_no_bias():
    b, h, l, d = 1, 2, 48, 64
    q, k, v, _, _ = _inputs(b, h, l, l, d, False, seed=3)
    want = jfa.flash_attention_bias_packed_infer(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None, None, False, h
    )
    got = tfa.attention_bias_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), None, None, False, h
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)


def test_cpu_wrapper_takes_plain_version_and_counts_no_launch():
    q, k, v, bias, mask = _inputs(2, 2, 24, 40, 64, True, seed=1)
    args = [torch.from_numpy(x) for x in (q, k, v, bias)] + [torch.from_numpy(mask)]
    before = tfa.LAUNCHES
    got = tfa.flash_attention_bias_packed_infer(*args, True, 2)
    want = tfa.attention_bias_reference(*args, True, 2)
    assert tfa.LAUNCHES == before
    assert torch.equal(got, want)


def _bf16(*shape):
    return torch.zeros(*shape, dtype=torch.bfloat16)


@pytest.mark.parametrize(
    "case,match",
    [
        ("head_dim", "head dim"),
        ("dtype", "bfloat16"),
        ("kv_shape", "do not match"),
        ("bias_shape", "bias shape"),
        ("bias_dtype", "bias must be"),
        ("mask", "key_padding_mask"),
        ("causal_short_keys", "causal"),
        ("strided", "contiguous"),
        ("bias_strided", "row-padded"),
        ("k_alignment", "16-byte"),
    ],
)
def test_kernel_checks_refuse_what_the_kernel_does_not_take(case, match):
    """The checks run before every launch; they are device-independent."""
    b, h, lq, lk = 2, 2, 16, 24
    q, k, v = _bf16(b, lq, h * 64), _bf16(b, lk, h * 64), _bf16(b, lk, h * 64)
    bias, mask, causal = _bf16(h, lq, lk), torch.zeros(b, lk, dtype=torch.bool), False
    if case == "head_dim":
        q, k, v = _bf16(b, lq, h * 32), _bf16(b, lk, h * 32), _bf16(b, lk, h * 32)
    elif case == "dtype":
        q = q.float()
    elif case == "kv_shape":
        v = _bf16(b, lk + 1, h * 64)
    elif case == "bias_shape":
        bias = _bf16(h, lq, lk + 1)
    elif case == "bias_dtype":
        bias = bias.half()
    elif case == "mask":
        mask = mask.to(torch.uint8)
    elif case == "causal_short_keys":
        k, v, bias, mask, causal = _bf16(b, 8, h * 64), _bf16(b, 8, h * 64), None, None, True
    elif case == "strided":
        q = _bf16(b, h * 64, lq).transpose(1, 2)
    elif case == "bias_strided":
        bias = _bf16(h, lk, lq).transpose(1, 2)
    elif case == "k_alignment":  # TMA reads q, k and v from 16-byte boundaries
        k = _bf16(b * lk * h * 64 + 1)[1:].view(b, lk, h * 64)
    with pytest.raises(ValueError, match=match):
        tfa._check(q, k, v, bias, mask, causal, h)
    if case == "dtype":  # the same call with bf16 q passes the checks
        tfa._check(q.bfloat16(), k, v, bias, mask, causal, h)
