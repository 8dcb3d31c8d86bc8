"""``ifseg_torch.ops.quantization`` against ``ifseg_tpu/ops/quantization.py``.

Scalar quantization is rounding of fp32 values by an fp32 scale on both
sides, so codes and scales must be EQUAL, for each kind of tensor in its own
layout: a linear weight (transposed in the port: a scale per row), a
convolution (out, in, kh, kw against flax's kh, kw, in, out), an embedding
(a scale per column) and the relative-position tables (one flax leaf stacked
over the layers, one tensor a layer here, a scale per head shared by all
layers).  The state-dict report must equal the JAX tree's at the tiny
widths and at OFA-Base (208 quantized, 636 kept), the latter computed from
shapes alone (the port's model on the meta device, the JAX init under
``eval_shape``).  k-means from the same first centroids gives the same
codes, and centroids to 1e-5 (fp32 products in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ifseg_torch.config import model_config_for_arch as torch_model_config
from ifseg_torch.models.segofa import SegOFA
from ifseg_torch.ops import quantization as tq
from ifseg_tpu.config import model_config_for_arch as jax_model_config
from ifseg_tpu.models.segofa import SegOFAVariables
from ifseg_tpu.ops import quantization as jq

from torch_port_utils import make_pair

WIDE = dict(encoder_embed_dim=64, encoder_ffn_embed_dim=128, decoder_embed_dim=64,
            decoder_ffn_embed_dim=128)


@pytest.fixture(scope="module")
def pair():
    """(JAX quantized tree, JAX report, port quantized dict, port report) at
    the tiny config with widths 64 (so the transformer's linears quantize)."""
    _, params, tmodel = make_pair(0, **WIDE)
    jtree, jreport = jq.quantize_tree_scalar(params)
    quantized, report = tq.quantize_state_scalar(tmodel)
    return jax.device_get(jtree), jreport, quantized, report


def _codes(node):
    return np.asarray(node["q"]), np.asarray(node["scale"])


# (port key, path in the JAX tree, numpy layout change from flax to the port)
KINDS = {
    "linear": ("encoder.layers.0.self_attn.q_proj.weight",
               ("encoder", "layers_0", "self_attn", "q_proj", "kernel"), lambda a: a.T),
    "linear_fc": ("decoder.layers.1.fc2.weight",
                  ("decoder", "layers_1", "ffn", "fc2", "kernel"), lambda a: a.T),
    "image_proj": ("encoder.image_proj.weight", ("encoder", "image_proj", "kernel"),
                   lambda a: a.T),
    "conv": ("encoder.embed_images.layer1.0.conv2.weight",
             ("encoder", "embed_images", "layer1_0", "conv2", "kernel"),
             lambda a: a.transpose(3, 2, 0, 1)),
    "embedding": ("encoder.embed_tokens.weight", ("embed_tokens", "embedding"), lambda a: a),
}


@pytest.mark.parametrize("kind", list(KINDS))
def test_codes_and_scales_equal_jax(pair, kind):
    jtree, _, quantized, _ = pair
    key, path, layout = KINDS[kind]
    node = jtree
    for p in path:
        node = node[p]
    want_q, want_s = _codes(node)
    q, scale = quantized[key]
    assert q.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), layout(want_q))
    np.testing.assert_array_equal(scale.numpy(), layout(want_s))


def test_tied_embedding_is_one_leaf(pair):
    _, _, quantized, _ = pair
    for enc, dec in zip(quantized["encoder.embed_tokens.weight"],
                        quantized["decoder.embed_tokens.weight"]):
        assert enc is dec


@pytest.mark.parametrize("side,table", [("encoder", "image_rel_pos_table"),
                                        ("decoder", "image_rel_pos_table")])
def test_rel_pos_tables_share_a_scale_per_head(pair, side, table):
    jtree, _, quantized, _ = pair
    want_q, want_s = _codes(jtree[side][table])  # (layers, buckets, heads), (1, 1, heads)
    for i in range(want_q.shape[0]):
        q, scale = quantized[f"{side}.{table}_list.{i}.weight"]
        np.testing.assert_array_equal(q.numpy(), want_q[i])
        np.testing.assert_array_equal(scale.numpy(), want_s[0])


def test_dequantize_state_equals_jax(pair):
    jtree, _, quantized, _ = pair
    back = tq.dequantize_state(quantized)
    want = np.asarray(jq.dequantize_tree(jtree)["encoder"]["layers_0"]["ffn"]["fc1"]["kernel"])
    np.testing.assert_array_equal(back["encoder.layers.0.fc1.weight"].numpy(), want.T)


@pytest.mark.parametrize("widths", [{}, WIDE], ids=["tiny", "width64"])
def test_report_equals_jax_at_the_tiny_config(widths):
    _, params, tmodel = make_pair(0, **widths)
    _, want = jq.quantize_tree_scalar(params)
    assert tq.quantize_state_scalar(tmodel)[1] == want


def test_report_equals_jax_at_ofa_base():
    kw = dict(num_seg_tokens=150, patch_image_size=512, orig_patch_image_size=512)
    shapes = jax.eval_shape(lambda k: SegOFAVariables.init(jax_model_config("segofa_base", **kw),
                                                           k)[1], jax.random.PRNGKey(0))
    want = {}

    def report(params):
        want.update(jq.quantize_tree_scalar(params)[1])
        return 0

    jax.eval_shape(report, shapes)
    with torch.device("meta"):
        model = SegOFA(torch_model_config("segofa_base", **kw))
    got = tq.quantize_state_scalar(model)[1]
    assert got == want
    assert (got["quantized"], got["kept"]) == (208, 636)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("dim", [None, (0,), (1,)], ids=["whole", "dim0", "dim1"])
def test_scalar_quantize_equals_jax(bits, dim):
    w = np.random.default_rng(bits).normal(size=(64, 32)).astype(np.float32)
    want_q, want_s = jq.scalar_quantize(jnp.asarray(w), bits, dim)
    q, s = tq.scalar_quantize(torch.from_numpy(w), bits, dim)
    np.testing.assert_array_equal(q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(s.numpy(), np.asarray(want_s))
    np.testing.assert_array_equal(tq.scalar_dequantize(q, s).numpy(),
                                  np.asarray(jq.scalar_dequantize(want_q, want_s)))


def test_fake_quant_forward_and_straight_through_gradient():
    w0 = np.asarray([[0.5, -0.3], [1.2, 0.01]], np.float32)
    w = torch.tensor(w0, requires_grad=True)
    out = tq.fake_quant(w)
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(jq.fake_quant(jnp.asarray(w0))))
    (out * 2).sum().backward()
    want = jax.grad(lambda x: jnp.sum(jq.fake_quant(x) * 2))(jnp.asarray(w0))
    np.testing.assert_array_equal(w.grad.numpy(), np.asarray(want))
    np.testing.assert_array_equal(w.grad.numpy(), 2.0)


def _clustered(seed=1):
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(16, 8))
    return (base[rng.integers(0, 16, size=512)]
            + 0.01 * rng.normal(size=(512, 8))).astype(np.float32).reshape(64, 64)


def test_kmeans_from_the_same_first_centroids_equals_jax():
    """The JAX k-means draws its first centroids inside; the test draws the
    same rows and starts the port's iterations from them.  Each drawn row
    lies in a cluster of its own, so no sample sits near a tie between two
    centroids (where fp32 products in another order could pick the other)."""
    n, k = 512, 16
    key = jax.random.PRNGKey(0)
    idx = np.asarray(jax.random.choice(key, n, shape=(k,), replace=False))
    rng = np.random.default_rng(1)
    labels = rng.integers(0, k, size=n)
    labels[idx] = np.arange(k)
    blocks = (4.0 * rng.normal(size=(k, 8))[labels]
              + 0.01 * rng.normal(size=(n, 8))).astype(np.float32)
    want_c, want_a = jax.jit(jq._kmeans, static_argnums=(1, 2))(jnp.asarray(blocks), k, 10, key)
    x = torch.from_numpy(blocks)
    cents, assign = tq._kmeans(x, x[torch.from_numpy(idx.copy())], 10)
    np.testing.assert_array_equal(assign.numpy(), np.asarray(want_a))
    np.testing.assert_allclose(cents.numpy(), np.asarray(want_c), atol=1e-5, rtol=0)


def test_kmeans_init_draws_from_the_generator():
    x = torch.arange(40.0).reshape(20, 2)
    a = tq.kmeans_init(x, 5, torch.Generator().manual_seed(3))
    b = tq.kmeans_init(x, 5, torch.Generator().manual_seed(3))
    assert torch.equal(a, b) and len(set(a[:, 0].tolist())) == 5  # no repeats when n >= k
    assert tq.kmeans_init(x, 30, torch.Generator().manual_seed(3)).shape == (30, 2)


def test_pq_reconstruction():
    w = torch.from_numpy(_clustered())
    cb, codes, shape = tq.pq_quantize(w, block_size=8, n_centroids=32, iters=10,
                                      generator=torch.Generator().manual_seed(0))
    assert cb.shape == (32, 8) and codes.dtype == torch.int32 and shape == (64, 64)
    wr = tq.pq_dequantize(cb, codes, shape)
    assert float((wr - w).norm() / w.norm()) < 0.1
    with pytest.raises(ValueError, match="multiple of block_size"):
        tq.pq_quantize(w[:, :60], block_size=8)
