"""What the evaluator reads of the segmentation dataset: one ragged
evaluation row and the normalization constants.

The port's copy of ``EvalSample``, ``eval_mean_std`` and the ImageNet
constants of the JAX package's ``data/segmentation_dataset.py``.  Image
decoding, the keep-ratio resize and the BPE prompt stay with the data
pipeline, which is not ported yet: a caller builds ``EvalSample`` rows from
arrays it already holds.
"""

from dataclasses import dataclass
from typing import Any, Tuple

import numpy as np

IMAGENET_DEFAULT_MEAN = (0.485, 0.456, 0.406)
IMAGENET_DEFAULT_STD = (0.229, 0.224, 0.225)


def eval_mean_std(cfg) -> Tuple[Tuple[float, ...], Tuple[float, ...]]:
    """Normalization constants of the task config ``cfg``, shared by the
    trainer's and the evaluator's on-device normalize (images ship as uint8:
    a quarter of the bytes of normalized fp32)."""
    if cfg.imagenet_default_mean_and_std:
        return IMAGENET_DEFAULT_MEAN, IMAGENET_DEFAULT_STD
    return (0.5, 0.5, 0.5), (0.5, 0.5, 0.5)


@dataclass
class EvalSample:
    """One ragged evaluation row (the evaluator does the bucketing).

    ``patch_image`` is raw uint8 RGB, keep-ratio resized; it is normalized on
    the device.  An fp32 array is taken as already normalized and passes
    through."""

    patch_image: np.ndarray  # (h, w, 3) uint8 RGB, or fp32 normalized
    src_tokens: np.ndarray  # (L,)
    bos_token: np.ndarray  # (1,)
    ori_semantic_seg: np.ndarray  # (H, W) int class ids, original resolution
    ori_shape: Any
    id: Any = None
