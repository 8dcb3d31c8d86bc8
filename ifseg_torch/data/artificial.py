"""Artificial images for image-free training (numpy, host side).

An artificial image is a random grid of category ids: a small (sh, sw) grid,
sh and sw drawn from [l, r) for ``rand_k-l-r``, nearest-resized to the token
grid (the ids whose class-name embeddings the encoder lays out as image
tokens) and to the pixel target the loss is taken against
(segmentation_dataset.py:303-321 of the reference).
"""

from typing import Dict, Optional, Tuple

import numpy as np

from ifseg_torch.ops.resize import resize_nearest_np


def parse_rand_k(artificial_image_type: str) -> Tuple[int, int]:
    """(l, r) of ``rand_k-l-r``; plain ``rand_k`` means 1, 33."""
    if not artificial_image_type.startswith("rand_k"):
        raise ValueError(f"not a rand_k artificial image type: {artificial_image_type!r}")
    pieces = artificial_image_type.split("-")
    return (int(pieces[1]), int(pieces[2])) if len(pieces) == 3 else (1, 33)


def artificial_grid(rng: np.random.Generator, patch_image_size: int, num_seg: int,
                    artificial_image_type: str = "rand_k-1-33"
                    ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """One random category grid -> (token-grid ids ((s/16)²,) int32, pixel
    target (s, s) int32); ``norand_k`` draws the token grid iid and has no
    pixel target of its own."""
    hw16 = patch_image_size // 16
    if artificial_image_type == "norand_k":
        return rng.integers(0, num_seg, size=hw16 * hw16).astype(np.int32), None
    lo, hi = parse_rand_k(artificial_image_type)
    sh, sw = rng.integers(lo, hi, size=2)
    rand = rng.integers(0, num_seg, size=(sh, sw)).astype(np.int32)
    grid_ids = resize_nearest_np(rand, (hw16, hw16)).reshape(-1)
    return grid_ids, resize_nearest_np(rand, (patch_image_size, patch_image_size))


def artificial_batch(rng: np.random.Generator, batch: int, patch_image_size: int, num_seg: int,
                     src_tokens: np.ndarray, bos: int = 0,
                     artificial_image_type: str = "rand_k-1-33") -> Dict[str, np.ndarray]:
    """An image-free training batch: ``batch`` artificial grids with the
    constant source sequence ``src_tokens`` (T,) tiled over the batch.
    Targets ride uint8 when the class ids fit, as on the reference wire."""
    grids = [artificial_grid(rng, patch_image_size, num_seg, artificial_image_type)
             for _ in range(batch)]
    tgt = np.uint8 if num_seg + 1 <= 256 else np.int32
    return {
        "src_tokens": np.tile(np.asarray(src_tokens, np.int64)[None], (batch, 1)),
        "bos_tokens": np.full((batch, 1), bos, np.int64),
        "aux_grid_ids": np.stack([g for g, _ in grids]).astype(np.int64),
        "aux_target": np.stack([t for _, t in grids]).astype(tgt),
    }
