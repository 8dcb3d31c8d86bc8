"""The port's position tables, bias gathers, bias interpolations and bilinear
resize against the JAX package's.

The numpy bucket tables must be identical; the tensor functions agree to
1e-5 (fp32 on both sides, summation order apart).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import ifseg_tpu.models.position as jpos
import ifseg_tpu.ops.resize as jresize
import ifseg_torch.models.position as tpos
import ifseg_torch.ops.resize as tresize
import torch_port_utils  # noqa: F401,E402  (pins torch's threads under xdist)

TOL = 1e-5


@pytest.mark.parametrize(
    "name,args",
    [
        ("make_token_bucket_position", (256,)),
        ("make_image_bucket_position", (6, jpos.image_num_rel_dis(6))),
        ("image_grid_position_ids", (3, 5, 42)),
        ("image_rp_bucket_for_grid", (4, 4, 42)),
    ],
)
def test_bucket_tables_identical(name, args):
    np.testing.assert_array_equal(getattr(tpos, name)(*args), getattr(jpos, name)(*args))


@pytest.mark.parametrize("size", [(4, 4), (4, 8), (8, 5), (32, 64)])
def test_bilinear_matrix_identical(size):
    np.testing.assert_array_equal(
        tresize.bilinear_matrix(*size), np.asarray(jresize.bilinear_matrix(*size))
    )


def test_resize_bilinear():
    x = np.random.default_rng(0).normal(size=(2, 4, 6, 3)).astype(np.float32)
    got = tresize.resize_bilinear(torch.from_numpy(x), (8, 9))
    want = jresize.resize_bilinear(jnp.asarray(x), (8, 9))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


def test_gather_rel_bias_all_layers():
    rng = np.random.default_rng(1)
    table = rng.normal(size=(3, jpos.image_num_rel_dis(42), 4)).astype(np.float32)
    rp = jpos.image_rp_bucket_for_grid(4, 4, 42)
    got = tpos.gather_rel_bias_all_layers(torch.from_numpy(table), rp)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jpos.gather_rel_bias_all_layers(jnp.asarray(table), rp))
    )
    np.testing.assert_allclose(
        got.numpy(),
        np.asarray(jpos.gather_grid_bias_all_layers(jnp.asarray(table), rp, (4, 4))),
        atol=TOL, rtol=TOL,
    )


@pytest.mark.parametrize("src,dst", [((2, 2), (4, 4)), ((4, 4), (4, 4)), ((3, 2), (5, 4))])
def test_interp_grid_bias(src, dst):
    n = src[0] * src[1]
    bias = np.random.default_rng(2).normal(size=(3, n, n)).astype(np.float32)
    got = tpos.interp_grid_bias(torch.from_numpy(bias), src, dst)
    want = jpos.interp_grid_bias(jnp.asarray(bias), src, dst)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("src,dst", [((2, 2), (4, 4)), ((4, 4), (4, 4))])
def test_interp_seg_bias_with_bos(src, dst):
    n = 1 + src[0] * src[1]
    bias = np.random.default_rng(3).normal(size=(3, n, n)).astype(np.float32)
    got = tpos.interp_seg_bias_with_bos(torch.from_numpy(bias), src, dst)
    want = jpos.interp_seg_bias_with_bos(jnp.asarray(bias), src, dst)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)
