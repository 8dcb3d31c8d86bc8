"""Dense CRF mean field on the caller's device, in PyTorch ops.

The counterpart of the JAX package's ``ops/crf_jax.py`` (no Pallas kernel
computes it there, so no CUDA kernel here either).  Everything runs where
the inputs lie: on a CUDA tensor on the card, on a CPU tensor on the CPU.

  - the spatial (Gaussian) message is exact up to a 4-sigma cut-off: two
    depthwise convolutions with a zero boundary (``spatial_filter``);
  - the bilateral (position + colour) message goes through a permutohedral
    lattice (Adams, Baek, Davis 2010): simplex elevation, rank and
    barycentric weights, one key per simplex corner, the keys deduplicated in
    lexicographic order (so the vertices are numbered as the JAX package
    numbers them), splat by ``index_add_``, d + 1 [1, 2, 1] / 2 blur passes,
    slice (``build_lattice``, ``lattice_filter``);
  - the mean field: Q <- softmax(-U + w_g filt_g(Q) + w_b filt_b(Q)) with
    symmetric normalisation and Potts compatibility, as ``csrc/densecrf.cpp``
    computes it (``dense_crf_device``).

Where the JAX package packs a key into 15-bit words and finds neighbours by a
lexicographic binary search, this packs the d coordinates of a key into one
int64 in mixed radix over the range the keys and their neighbours span (a
linear packing that keeps lexicographic order), so ``torch.unique`` numbers
the vertices and ``searchsorted`` finds the neighbours.  The filter is
linear per channel, so it runs over chunks of channels to bound memory.
"""

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

# elements of the largest (lattice slots, channels) fp32 array a filter pass
# holds at once: 1 GiB
_CHUNK_ELEMENTS = 1 << 28


def _elevate(feats: torch.Tensor) -> torch.Tensor:
    """(N, d) -> (N, d + 1) on the sum-zero hyperplane (permutohedral.h:46-68)."""
    d = feats.shape[1]
    inv_std = np.sqrt(2.0 / 3.0) * (d + 1)
    scale = np.array([1.0 / np.sqrt((i + 2) * (i + 1)) * inv_std for i in range(d)], np.float32)
    cf = feats * torch.from_numpy(scale).to(feats.device)[None, :]
    # elevated[j] = sum(cf[j:]) - j * cf[j-1] (j >= 1); elevated[0] = sum(cf)
    suffix = torch.cumsum(cf.flip(1), dim=1).flip(1)
    suffix = torch.cat([suffix, torch.zeros_like(cf[:, :1])], dim=1)
    j = torch.arange(1, d + 1, dtype=torch.float32, device=feats.device)
    return torch.cat([suffix[:, :1], suffix[:, 1:] - j[None, :] * cf], dim=1)


def build_lattice(feats: torch.Tensor):
    """The lattice plan of (N, d) fp32 features: (offsets (N, d + 1) int64,
    the vertex of each simplex corner; barycentric weights (N, d + 1); blur
    neighbours (d + 1, V, 2) int64, where index V means "missing"; V, the
    number of vertices).  Mirrors permutohedral.h ``init``."""
    n, d = feats.shape
    dev = feats.device
    elevated = _elevate(feats)

    down = 1.0 / (d + 1)
    up = float(d + 1)
    rd = torch.round(down * elevated)
    rem0 = rd * up
    ssum = rd.sum(dim=1).to(torch.int32)

    # rank[i] = #{j > i: res_i < res_j} + #{j < i: res_j >= res_i}
    res = elevated - rem0
    lt = (res[:, :, None] < res[:, None, :]).to(torch.int32)
    iu = torch.triu(torch.ones(d + 1, d + 1, dtype=torch.int32, device=dev), 1)
    rank = (lt * iu).sum(dim=2) + ((1 - lt) * iu).sum(dim=1)
    rank = rank + ssum[:, None]
    low, high = rank < 0, rank > d
    rank = torch.where(low, rank + (d + 1), torch.where(high, rank - (d + 1), rank))
    rem0 = torch.where(low, rem0 + (d + 1), torch.where(high, rem0 - (d + 1), rem0))

    # barycentric weights (permutohedral.h:104-111)
    v = (elevated - rem0) * down
    idx0 = (d - rank).long()
    bary = torch.zeros(n, d + 2, dtype=torch.float32, device=dev)
    bary.scatter_add_(1, idx0, v)
    bary.scatter_add_(1, idx0 + 1, -v)
    bary[:, 0] += 1.0 + bary[:, d + 1]
    bary = bary[:, : d + 1]

    # one key per simplex corner (permutohedral.h:114-118): (N, d + 1, d)
    r = torch.arange(d + 1, dtype=torch.int64, device=dev)[None, :, None]
    keys = rem0[:, None, :d].long() + r
    keys = keys - torch.where(rank[:, None, :d] > d - r, d + 1, 0)
    keys = keys.reshape(n * (d + 1), d)

    # mixed-radix packing over the span of the keys and their blur neighbours
    # (each coordinate moves by at most d)
    lo = keys.amin(dim=0) - d
    spans = (keys.amax(dim=0) + d - lo + 1).tolist()
    if math.prod(spans) >= 1 << 63:
        raise ValueError(f"lattice coordinates span {spans}: too wide to pack into 63 bits")
    strides = [math.prod(spans[i + 1:]) for i in range(d)]
    stride = torch.tensor(strides, dtype=torch.int64, device=dev)
    packed = ((keys - lo) * stride).sum(dim=1)
    vertices, offsets = torch.unique(packed, sorted=True, return_inverse=True)
    n_vertices = vertices.shape[0]

    # blur neighbours (permutohedral.h:136-158): along direction j,
    # n1 = key - 1 (coordinate j: + d), n2 = key + 1 (coordinate j: - d)
    blur = []
    for j in range(d + 1):
        step = -sum(strides) + (d + 1) * strides[j] if j < d else -sum(strides)
        pair = []
        for q in (vertices + step, vertices - step):
            pos = torch.searchsorted(vertices, q)
            hit = vertices[pos.clamp(max=n_vertices - 1)] == q
            pair.append(torch.where(hit & (pos < n_vertices), pos, n_vertices))
        blur.append(torch.stack(pair, dim=1))
    return offsets.reshape(n, d + 1), bary, torch.stack(blur), n_vertices


def lattice_filter(offsets, bary, blur, x: torch.Tensor) -> torch.Tensor:
    """Gaussian filtering of x (N, C) through the lattice: splat, blur, slice
    (permutohedral.h ``compute``), over chunks of channels."""
    n, dp1 = offsets.shape
    d = dp1 - 1
    n_vertices = blur.shape[1]
    alpha = 1.0 / (1.0 + 2.0 ** (-d))
    flat = offsets.reshape(-1)
    chunk = max(1, _CHUNK_ELEMENTS // (n * dp1))
    out = []
    for c0 in range(0, x.shape[1], chunk):
        xc = x[:, c0:c0 + chunk]
        c = xc.shape[1]
        values = torch.zeros(n_vertices + 1, c, dtype=torch.float32, device=x.device)
        values.index_add_(0, flat, (bary[..., None] * xc[:, None, :]).reshape(n * dp1, c))
        for j in range(dp1):
            mixed = values[:n_vertices] + 0.5 * (values[blur[j, :, 0]] + values[blur[j, :, 1]])
            values = torch.cat([mixed, values.new_zeros(1, c)])
        gathered = values[flat].reshape(n, dp1, c)
        out.append((bary[..., None] * gathered).sum(dim=1) * alpha)
    return torch.cat(out, dim=1)


@contextlib.contextmanager
def _fp32_convolutions():
    """cuDNN convolutions in full fp32 for the block: PyTorch lets them round
    their inputs to TF32 by default, 1e-3 off the filter's fp32 values."""
    allowed = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = allowed


def spatial_filter(x: torch.Tensor, h: int, w: int, sigma: float) -> torch.Tensor:
    """Separable 2-D Gaussian over x (H*W, C), exact up to a 4-sigma cut-off:
    two depthwise convolutions with a zero boundary, in fp32 whatever the
    caller's TF32 setting."""
    radius = max(int(np.ceil(4 * sigma)), 1)
    xs = np.arange(-radius, radius + 1, dtype=np.float32)
    k = torch.from_numpy(np.exp(-0.5 * (xs / sigma) ** 2)).to(x.device)
    c = x.shape[1]
    img = x.t().reshape(1, c, h, w)
    with _fp32_convolutions():
        img = F.conv2d(img, k.reshape(1, 1, -1, 1).expand(c, 1, -1, 1), padding=(radius, 0),
                       groups=c)
        img = F.conv2d(img, k.reshape(1, 1, 1, -1).expand(c, 1, 1, -1), padding=(0, radius),
                       groups=c)
    return img.reshape(c, h * w).t()


@torch.no_grad()
def dense_crf_device(
    image_bgr: torch.Tensor,  # (H, W, 3) in [0, 255], any real or uint8 dtype
    probs: torch.Tensor,  # (H, W, C) softmax probabilities
    n_iter: int = 10,
    sxy_gauss: float = 1.0,
    compat_gauss: float = 3.0,
    sxy_bilateral: float = 67.0,
    srgb_bilateral: float = 3.0,
    compat_bilateral: float = 4.0,
) -> torch.Tensor:
    """Mean-field dense CRF on ``probs``'s device (reference crf.py:11-37
    defaults) -> refined (H, W, C) fp32 probabilities.

    As ``csrc/densecrf.cpp``: unary = -log(clip(probs, 1e-5, 1)); each
    iteration Q <- softmax(-U + w_g * filt_g(Q) + w_b * filt_b(Q)) with
    symmetric normalisation (norm = 1/sqrt(filt(1)))."""
    if probs.dim() != 3:
        raise ValueError(f"probs must be (H, W, C), not {tuple(probs.shape)}")
    h, w, c = probs.shape
    if tuple(image_bgr.shape) != (h, w, 3):
        raise ValueError(f"image {tuple(image_bgr.shape)} does not match probs "
                         f"{tuple(probs.shape)}")
    dev = probs.device
    n = h * w
    p = probs.reshape(n, c).float()

    yy, xx = torch.meshgrid(torch.arange(h, device=dev), torch.arange(w, device=dev),
                            indexing="ij")
    pos = torch.stack([xx.reshape(-1), yy.reshape(-1)], dim=1).float()
    col = image_bgr.reshape(n, 3).to(device=dev, dtype=torch.float32)
    off_b, bary_b, blur_b, _ = build_lattice(
        torch.cat([pos / sxy_bilateral, col / srgb_bilateral], dim=1))

    ones = torch.ones(n, 1, dtype=torch.float32, device=dev)
    norm_b = 1.0 / torch.sqrt(lattice_filter(off_b, bary_b, blur_b, ones) + 1e-20)
    norm_g = 1.0 / torch.sqrt(spatial_filter(ones, h, w, sxy_gauss) + 1e-20)

    neg_u = torch.log(p.clamp(1e-5, 1.0))
    q = torch.softmax(neg_u, dim=-1)
    for _ in range(n_iter):
        msg_g = norm_g * spatial_filter(norm_g * q, h, w, sxy_gauss)
        msg_b = norm_b * lattice_filter(off_b, bary_b, blur_b, norm_b * q)
        q = torch.softmax(neg_u + compat_gauss * msg_g + compat_bilateral * msg_b, dim=-1)
    return q.reshape(h, w, c)
