"""No-repeat-ngram masking over static shapes (the JAX package's
``ops/ngram_block.py``; the reference's CUDA kernel
clib/cuda/ngram_repeat_block_cuda.cpp + fairseq/ngram_repeat_block.py).

Given generated prefixes, ban every token that would complete an n-gram
already present in the prefix.  The JAX package computes it as ``jnp`` code
inside its decode loop, outside any Pallas kernel, so plain PyTorch is its
port: a handful of tensor ops a step on the generator's device.
"""

import torch


def ngram_repeat_mask(tokens: torch.Tensor, step: int, ngram_size: int,
                      vocab_size: int) -> torch.Tensor:
    """tokens (N, L) generated ids (positions > step are garbage); step the
    current position (the next token is written at step + 1).  Returns
    (N, V) bool, True where the token is banned."""
    n, l = tokens.shape
    if ngram_size <= 0 or l < ngram_size:
        return torch.zeros(n, vocab_size, dtype=torch.bool, device=tokens.device)
    k = ngram_size - 1
    idx = torch.arange(l - k, device=tokens.device)
    # windows: for each start j, the k tokens [j, j+k), and the follower at j+k
    windows = torch.stack([tokens[:, idx + i] for i in range(k)], dim=-1)  # (N, L-k, k)
    followers = tokens[:, idx + k]  # (N, L-k)
    # the current suffix: the last k tokens ending at step
    suffix_pos = [min(max(step - k + 1 + i, 0), l - 1) for i in range(k)]
    suffix = tokens[:, suffix_pos]  # (N, k)
    match = (windows == suffix[:, None, :]).all(dim=-1)  # (N, L-k)
    # only windows whose follower lies inside the generated prefix
    match = match & ((idx + k) <= step)[None, :]
    banned = torch.zeros(n, vocab_size, dtype=torch.uint8, device=tokens.device)
    banned.scatter_reduce_(1, followers.clamp(0, vocab_size - 1), match.to(torch.uint8),
                           reduce="amax")
    return banned.bool()
