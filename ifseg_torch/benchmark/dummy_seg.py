"""Synthetic segmentation task for throughput benchmarking without data.

The port of the JAX package's ``benchmark/dummy_seg.py`` (parity with
custom_fairseq/fairseq/benchmark/): random batches with the keys, shapes and
dtypes of the JAX batch, as torch tensors made on an explicit device from an
explicit ``torch.Generator``, so a train step's throughput can be measured
with no IO (``Trainer.train_step`` takes them as they are).  Like
``Trainer``, ``Evaluator`` and ``SegServer`` they are made on the card unless
the caller asks for the CPU (``device="cpu"``):

    task = DummySegTask(cfg)
    for batch in task.batches(n=100, batch_size=16):
        trainer.train_step(batch)
"""

from typing import Dict, Iterator, Optional, Union

import torch

from ifseg_torch.config import Config


def dummy_seg_batch(cfg: Config, batch_size: int, generator: torch.Generator,
                    device: Optional[Union[str, torch.device]] = None,
                    src_len: int = 48) -> Dict[str, torch.Tensor]:
    """One batch: float32 ``patch_images`` (B, s, s, 3) from a normal, int32
    tokens in 4..999 and class ids in 0..num_seg-1, drawn on ``device`` (the
    card unless ``"cpu"`` is given) from ``generator`` (a generator of that
    device)."""
    device = _device(device)
    s = cfg.model.patch_image_size
    hw16 = (s // 16) ** 2
    num_seg = cfg.model.num_seg_tokens
    kw = dict(generator=generator, device=device)

    def ints(low, high, shape):
        return torch.randint(low, high, shape, dtype=torch.int32, **kw)

    return {
        "patch_images": torch.randn((batch_size, s, s, 3), dtype=torch.float32, **kw),
        "src_tokens": ints(4, 1000, (batch_size, src_len)),
        "bos_tokens": torch.zeros((batch_size, 1), dtype=torch.int32, device=device),
        "target": ints(0, num_seg, (batch_size, s, s)),
        "downsampled_target": ints(0, num_seg, (batch_size, hw16)),
        "aux_grid_ids": ints(0, num_seg, (batch_size, hw16)),
        "aux_target": ints(0, num_seg, (batch_size, s, s)),
    }


def _device(device) -> torch.device:
    """``device``, or the card for None; a card that is absent raises."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device (pass device='cpu' to run on the CPU)")
    return device


class DummySegTask:
    """A class-token table made from ``seed`` and batch ``i`` made from a
    generator seeded with ``seed + i``, all on ``device`` (the card unless
    ``"cpu"`` is given)."""

    def __init__(self, cfg: Config, src_len: int = 48,
                 device: Optional[Union[str, torch.device]] = None, seed: int = 0):
        self.cfg = cfg
        self.src_len = src_len
        self.device = _device(device)
        self.seed = seed
        num_seg = cfg.model.num_seg_tokens
        g = self.generator(seed)
        self.class_tokens = torch.randint(4, 1000, (num_seg + 1, 4), dtype=torch.int32,
                                          generator=g, device=self.device)
        self.class_lengths = torch.randint(1, 5, (num_seg + 1,), dtype=torch.int32,
                                           generator=g, device=self.device)

    def generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed)

    def batches(self, n: int, batch_size: int) -> Iterator[Dict[str, torch.Tensor]]:
        for i in range(n):
            yield dummy_seg_batch(self.cfg, batch_size, self.generator(self.seed + i),
                                  self.device, self.src_len)
