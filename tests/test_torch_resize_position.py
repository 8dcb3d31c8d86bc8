"""The padded-evaluation resize and position helpers against the JAX package's.

``bilinear_matrix_dyn`` is built on the host in numpy where JAX builds it
from traced extents inside the evaluator's jitted function; it has to agree
with that bit for bit, since a weight that differs in its last bit moves the
upsampled logits and can flip an argmax.  (Run op by op, outside ``jit``, JAX
rounds the source coordinate twice where the compiled function uses one fused
multiply-add: that form is within one fp32 ulp of the source coordinate,
which is below 64 here: 4e-6.)  The
interpolations are fp32 products on both sides: 1e-6.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ifseg_torch.models import position as tpos
from ifseg_torch.ops import resize as tresize
from ifseg_tpu.models import position as jpos
from ifseg_tpu.ops import resize as jresize

DYN_CASES = [
    # (in_size, out_pad, out_valid, in_valid)
    (4, 8, 5, None), (4, 8, 8, None), (4, 6, 3, None), (4, 6, 4, None),
    (32, 48, 43, None), (32, 32, 32, None), (32, 48, 33, None),
    (6, 128, 100, 5), (8, 192, 160, 5), (6, 64, 64, 3), (8, 128, 90, 8),
    (32, 512, 500, 32), (48, 768, 683, 43), (48, 768, 680, 43), (48, 768, 512, 32),
    (32, 512, 375, 24), (16, 256, 1, 1), (16, 256, 255, 16),
]


@pytest.mark.parametrize("jit", [False, True], ids=["eager", "jit"])
@pytest.mark.parametrize("case", DYN_CASES, ids=lambda c: "-".join(map(str, c)))
def test_bilinear_matrix_dyn_bit_for_bit(case, jit):
    in_size, out_pad, out_valid, in_valid = case
    if jit:  # the extents traced, as inside the JAX evaluator's compiled function
        fn = jax.jit(lambda ov, iv: jresize.bilinear_matrix_dyn(in_size, out_pad, ov, iv))
        want = fn(jnp.int32(out_valid), jnp.int32(in_size if in_valid is None else in_valid))
    else:
        want = jresize.bilinear_matrix_dyn(in_size, out_pad, out_valid, in_valid)
    got = tresize.bilinear_matrix_dyn(in_size, out_pad, out_valid, in_valid)
    assert got.dtype == np.float32 and got.shape == (out_pad, in_size)
    if jit:
        assert np.array_equal(got, np.asarray(want))
    else:
        np.testing.assert_allclose(got, np.asarray(want), atol=4e-6, rtol=0)
    assert not got[out_valid:].any()
    np.testing.assert_allclose(got[:out_valid].sum(1), 1.0, atol=1e-6)


def test_bilinear_matrix_dyn_full_extent_is_the_static_matrix():
    # the static matrix is computed in fp64 and rounded: one fp32 ulp of the
    # source coordinate apart
    for in_size, out in ((4, 8), (32, 48), (5, 3)):
        np.testing.assert_allclose(tresize.bilinear_matrix_dyn(in_size, out, out),
                                   tresize.bilinear_matrix(in_size, out), atol=4e-6)


@pytest.mark.parametrize("h,w,bucket", [(4, 4, 6), (3, 5, 6), (6, 8, 6), (2, 9, 4)])
def test_image_rel_bucket_direct(h, w, bucket):
    got = tpos.image_rel_bucket_direct(h, w, bucket)
    assert np.array_equal(got, jpos.image_rel_bucket_direct(h, w, bucket))
    if h <= bucket and w <= bucket:  # inside the bucket it is the table lookup
        assert np.array_equal(got, tpos.image_rp_bucket_for_grid(h, w, bucket))


@pytest.mark.parametrize("dst", [((6, 8), (5, 7)), ((4, 4), (4, 4)), ((6, 6), (3, 6))])
def test_interp_mats_match_jax(dst):
    (dh, dw), (vh, vw) = dst
    sh = sw = 4
    rng = np.random.default_rng(0)
    ah = tresize.bilinear_matrix_dyn(sh, dh, vh)
    aw = tresize.bilinear_matrix_dyn(sw, dw, vw)
    grid_bias = rng.normal(size=(3, sh * sw, sh * sw)).astype(np.float32)
    seg_bias = rng.normal(size=(3, 1 + sh * sw, 1 + sh * sw)).astype(np.float32)

    want = jpos.interp_grid_bias_mats(jnp.asarray(grid_bias), jnp.asarray(ah), jnp.asarray(aw),
                                      (sh, sw))
    got = tpos.interp_grid_bias_mats(torch.from_numpy(grid_bias), torch.from_numpy(ah),
                                     torch.from_numpy(aw), (sh, sw))
    assert tuple(got.shape) == (3, dh * dw, dh * dw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)

    want = jpos.interp_seg_bias_with_bos_mats(jnp.asarray(seg_bias), jnp.asarray(ah),
                                              jnp.asarray(aw), (sh, sw))
    got = tpos.interp_seg_bias_with_bos_mats(torch.from_numpy(seg_bias), torch.from_numpy(ah),
                                             torch.from_numpy(aw), (sh, sw))
    assert tuple(got.shape) == (3, 1 + dh * dw, 1 + dh * dw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)


def test_static_interp_still_goes_through_the_mats():
    """The static-shape interpolations are the ``_mats`` forms with the
    static matrices: the refactor changed no value."""
    rng = np.random.default_rng(1)
    bias = torch.from_numpy(rng.normal(size=(2, 16, 16)).astype(np.float32))
    want = jpos.interp_grid_bias(jnp.asarray(bias.numpy()), (4, 4), (6, 5))
    np.testing.assert_allclose(tpos.interp_grid_bias(bias, (4, 4), (6, 5)).numpy(),
                               np.asarray(want), atol=1e-6, rtol=1e-6)
    seg = torch.from_numpy(rng.normal(size=(2, 17, 17)).astype(np.float32))
    want = jpos.interp_seg_bias_with_bos(jnp.asarray(seg.numpy()), (4, 4), (6, 5))
    np.testing.assert_allclose(tpos.interp_seg_bias_with_bos(seg, (4, 4), (6, 5)).numpy(),
                               np.asarray(want), atol=1e-6, rtol=1e-6)
