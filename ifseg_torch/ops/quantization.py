"""Weight quantization: scalar int8 and iterative product quantization.

The counterpart of the JAX package's ``ops/quantization.py`` (the reference's
custom_fairseq/fairseq/quantization_utils.py and modules/quantization/{scalar,
pq}): symmetric absmax scalar quantization with per-channel scales,
fake-quant with the straight-through gradient for quantization-aware
training, and product quantization by k-means codebooks over weight
sub-vectors ("iPQ").

``quantize_state_scalar`` quantizes a model's state dict as the JAX package's
``quantize_tree_scalar`` quantizes its parameter tree: every leaf of at least
``min_size`` elements and two or more dimensions, one scale per channel of
the flax layout's LAST axis.  The port holds some of those leaves in another
layout, so the channel is found by the module that owns the tensor:

  Linear     weight (out, in)          flax kernel (in, out): a scale per row
  Conv2d     weight (out, in, kh, kw)  flax (kh, kw, in, out): a scale per row
  Embedding  weight (rows, d)          flax the same: a scale per column
  relative-position tables, one (buckets, heads) Embedding a layer, stacked
  (layers, buckets, heads) in flax: one leaf, a scale per head over all
  layers and buckets

and the report counts flax leaves: the token embedding, which the state dict
holds under an encoder and a decoder name, once; the decoder's image
position table, which the JAX model does not have (``checkpoint/convert.py``
fills it with zeros and no served path reads it), not at all.
"""

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

TIED_DUPLICATE = "decoder.embed_tokens.weight"  # the encoder's token embedding again
NOT_A_JAX_LEAF = "decoder.embed_image_positions.weight"


def scalar_quantize(w: torch.Tensor, bits: int = 8, dim=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric absmax quantization over ``dim`` (all of ``w`` when None):
    (int8 codes, or int16 above 8 bits; fp32 scale, kept dims of size 1)."""
    qmax = 2 ** (bits - 1) - 1
    if dim is None:
        scale = w.abs().amax() / qmax
    else:
        scale = w.abs().amax(dim=dim, keepdim=True) / qmax
    scale = scale.clamp(min=1e-12)
    q = torch.clamp(torch.round(w / scale), -qmax - 1, qmax)
    return q.to(torch.int8 if bits <= 8 else torch.int16), scale.float()


def scalar_dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


class _FakeQuant(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, bits):
        return scalar_dequantize(*scalar_quantize(w, bits))

    @staticmethod
    def backward(ctx, g):
        return g, None


def fake_quant(w: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """Quantize and dequantize with a straight-through gradient (scalar
    quantization-aware training, modules/quantization/scalar)."""
    return _FakeQuant.apply(w, bits)


def kmeans_init(x: torch.Tensor, k: int, generator: torch.Generator) -> torch.Tensor:
    """The first ``k`` centroids: rows of x (n, d) drawn from ``generator``,
    without replacement unless n < k."""
    n = x.shape[0]
    if n < k:
        idx = torch.randint(n, (k,), generator=generator, device=generator.device)
    else:
        idx = torch.randperm(n, generator=generator, device=generator.device)[:k]
    return x[idx.to(x.device)]


def _kmeans(x: torch.Tensor, cents: torch.Tensor, iters: int):
    """Lloyd iterations from the centroids ``cents`` (k, d) over x (n, d) ->
    (centroids (k, d), assignments (n,) int32); a cluster that goes empty
    keeps its centroid."""
    k = cents.shape[0]

    def sq_dist(c):
        return (x ** 2).sum(1, keepdim=True) - 2 * x @ c.t() + (c ** 2).sum(1)[None, :]

    for _ in range(iters):
        onehot = F.one_hot(sq_dist(cents).argmin(dim=1), k).to(x.dtype)  # (n, k)
        filled = onehot.sum(0)
        new = (onehot.t() @ x) / filled.clamp(min=1.0)[:, None]
        cents = torch.where((filled > 0)[:, None], new, cents)
    return cents, sq_dist(cents).argmin(dim=1).to(torch.int32)


def pq_quantize(w: torch.Tensor, block_size: int = 8, n_centroids: int = 256, iters: int = 15,
                generator: Optional[torch.Generator] = None):
    """Product quantization of a (out, in) weight: its rows split into
    in/block sub-vectors with one shared k-means codebook
    (modules/quantization/pq).  The first centroids come from ``generator``
    (seed 0 when None).  Returns (codebook (k, block), codes
    (out * in/block,) int32, shape)."""
    out_f, in_f = w.shape
    if in_f % block_size:
        raise ValueError(f"in_features {in_f} is not a multiple of block_size {block_size}")
    blocks = w.reshape(out_f * (in_f // block_size), block_size).float()
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    cents, codes = _kmeans(blocks, kmeans_init(blocks, n_centroids, generator), iters)
    return cents, codes, tuple(w.shape)


def pq_dequantize(codebook: torch.Tensor, codes: torch.Tensor, shape) -> torch.Tensor:
    return codebook[codes.long()].reshape(shape)


def _leaves(model: nn.Module) -> List[Tuple[List[str], Optional[tuple]]]:
    """The flax leaves of ``model``'s state dict: (state-dict keys, dims of
    the port's layout that the leaf's scale reduces over, or None for a leaf
    of fewer than two dims)."""
    kinds = {}
    for name, mod in model.named_modules():
        if isinstance(mod, nn.Linear):
            kinds[f"{name}.weight"] = (1,)
        elif isinstance(mod, nn.Conv2d):
            kinds[f"{name}.weight"] = (1, 2, 3)
        elif isinstance(mod, nn.Embedding):
            kinds[f"{name}.weight"] = (0,)
    leaves, tables = [], {}
    for key, t in model.state_dict().items():
        if key in (TIED_DUPLICATE, NOT_A_JAX_LEAF):
            continue
        if "_rel_pos_table_list." in key:
            tables.setdefault(key.split("_list.")[0], []).append(key)
            continue
        leaves.append(([key], kinds[key] if t.dim() >= 2 else None))
    for keys in tables.values():  # one stacked (layers, buckets, heads) leaf
        leaves.append((keys, (0, 1)))
    return leaves


def quantize_state_scalar(model: nn.Module, bits: int = 8, min_size: int = 4096):
    """Quantize every large leaf of ``model``'s state dict, as the JAX
    package's ``quantize_tree_scalar`` does its tree (see the module
    docstring) -> (quantized: state-dict key -> (codes, scale) for the keys
    quantized, report).  A relative-position table's layers share one scale
    tensor; the tied token embedding's two keys share one pair.  Small leaves
    (LayerNorms, biases, frozen batch-norm vectors) are not in ``quantized``:
    they stay fp32, as the reference's layer selection leaves them."""
    sd = model.state_dict()
    report = {"quantized": 0, "kept": 0, "bytes_fp32": 0, "bytes_quant": 0}
    quantized: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}
    for keys, dims in _leaves(model):
        size = sum(sd[k].numel() for k in keys)
        report["bytes_fp32"] += size * 4
        if size < min_size or dims is None:
            report["kept"] += 1
            report["bytes_quant"] += size * 4
            continue
        if len(keys) == 1:
            q, scale = scalar_quantize(sd[keys[0]], bits, dims)
            quantized[keys[0]] = (q, scale)
            if keys[0] == "encoder.embed_tokens.weight" and TIED_DUPLICATE in sd:
                quantized[TIED_DUPLICATE] = (q, scale)
        else:
            stacked = torch.stack([sd[k] for k in keys])
            q, scale = scalar_quantize(stacked, bits, dims)
            scale = scale[0]
            for i, k in enumerate(keys):
                quantized[k] = (q[i], scale)
        report["quantized"] += 1
        report["bytes_quant"] += size + scale.numel() * 4
    return quantized, report


def dequantize_state(quantized) -> Dict[str, torch.Tensor]:
    """fp32 values of every quantized key."""
    return {k: scalar_dequantize(q, scale) for k, (q, scale) in quantized.items()}


class Int8Linear(nn.Module):
    """The serving form of a quantized ``Linear``: int8 codes (out, in) and
    an fp32 scale per output row stay resident, and each call dequantizes
    them as ``(q.float() * scale).to(x.dtype)`` (the bits of the JAX
    package's fp32 dequantize followed by its ``Dense`` cast); the bias is
    cast at use."""

    def __init__(self, q: torch.Tensor, scale: torch.Tensor, bias: Optional[torch.Tensor]):
        super().__init__()
        self.register_buffer("q", q)
        self.register_buffer("scale", scale)
        self.register_buffer("bias", None if bias is None else bias.detach())

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, scalar_dequantize(self.q, self.scale).to(x.dtype), bias)
