"""The port's served forward against the JAX package's SegServer (CPU, fp32).

Tolerance 2e-4 (atol and rtol), the one test_serving.py holds the JAX fast
path to: both sides compute in fp32, and they differ only in summation order
and in the LayerNorm variance formula (two-pass here, E[x²]−E[x]² in flax).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ifseg_torch.eval.serving import SegServer as TorchSegServer
from ifseg_tpu.eval.serving import SegServer as JaxSegServer

from torch_port_utils import make_pair, serving_inputs, torch_tiny


@pytest.mark.parametrize(
    "orig_size", [64, 32], ids=["identity-interp", "bilinear-interp"]
)
def test_served_logits_match_jax(orig_size):
    jmodel, params, tmodel = make_pair(seed=0, orig_patch_image_size=orig_size)
    src, img, bos = serving_inputs(seed=1)

    want = np.asarray(
        JaxSegServer(jmodel, params, src_len=10)(
            jnp.asarray(src), jnp.asarray(img), jnp.asarray(bos)
        )
    )
    server = TorchSegServer(tmodel, src_len=10, device="cpu")
    got = server(torch.from_numpy(src), torch.from_numpy(img), torch.from_numpy(bos))

    assert got.dtype == torch.float32
    assert tuple(got.shape) == (2, 1 + 4 * 4, 5)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=2e-4)


def test_server_without_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tmodel = torch_tiny()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchSegServer(tmodel, src_len=10)
