"""Trainer: the training and validation steps, gradient accumulation, EMA.

The entry points of the JAX package's ``Trainer`` (``init_state``,
``train_step``, ``valid_step``, ``get_lr``, ``get_num_updates``) on one
device, eagerly:

  - the image-free loss (artificial grid -> ``encode_artificial`` -> decoder
    -> upsampled CE), or the supervised branch on real images;
  - the monitoring forward on the real batch, in eval mode and without
    gradients, on the parameters of before the update;
  - gradient accumulation over ``update_freq`` microbatches of one batch;
  - frozen parameters take no gradient, so they stay out of the clip norm;
  - clip by the global norm, logged before clipping, in fp32;
  - a non-finite global norm skips the update entirely: parameters, Adam
    moments, EMA and the step counter stay untouched, and the event is
    counted in ``n_nonfinite``.  The decision is one read of the global norm
    per step, not one per tensor;
  - bf16 compute with fp32 parameters and moments (no loss scaling);
  - the uint8 wire for images and labels: normalised and widened here, on
    the device.

Dropout, DropPath and LayerDrop draw from one ``torch.Generator`` on the
trainer's device, so a run repeats bit-for-bit from its seed (up to the
dbias atomics of the attention backward on a card).  Meshes, shardings and
activation checkpointing of layers are not ported.
"""

from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from ifseg_torch.config import Config
from ifseg_torch.models.attention import set_generator
from ifseg_torch.models.encoder import compute_dtype
from ifseg_torch.models.segofa import SegOFA
from ifseg_torch.train import optim as optim_lib
from ifseg_torch.train.criterion import (
    _grid_from_logits,
    compute_imfree_loss,
    compute_monitor_outputs,
    init_seg_embeddings,
    upsampled_ce,
)
from ifseg_torch.train.ema import ema_init, ema_step

IMAGENET_DEFAULT_MEAN = (0.485, 0.456, 0.406)
IMAGENET_DEFAULT_STD = (0.229, 0.224, 0.225)


class Trainer:
    """Owns the model, the optimizer, the EMA copy and the step counter.

    ``device=None`` means ``"cuda"`` and raises when no card is present; the
    CPU is used only when the caller passes ``device="cpu"``."""

    def __init__(self, cfg: Config, class_tokens: Optional[np.ndarray] = None,
                 class_lengths: Optional[np.ndarray] = None, total_num_updates: int = 1,
                 generator: Optional[torch.Generator] = None,
                 device: Optional[Union[str, torch.device]] = None):
        self.cfg = cfg
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Trainer: no CUDA device (pass device='cpu' to run on the CPU)")
        as_dev = lambda x, dt: None if x is None else torch.as_tensor(
            np.asarray(x), dtype=dt, device=self.device)
        self.class_tokens = as_dev(class_tokens, torch.long)
        self.class_lengths = as_dev(class_lengths, torch.long)
        self.total_num_updates = total_num_updates
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(cfg.optimization.seed)
        self.generator = generator
        self.model: Optional[SegOFA] = None
        self.optimizer: Optional[optim_lib.FairseqAdam] = None
        self.ema: Optional[Dict[str, torch.Tensor]] = None
        self.step = 0

    # ----------------------------------------------------------------- setup

    def init_state(self, params: Optional[Dict[str, torch.Tensor]] = None) -> "Trainer":
        """Build the model (from the state dict ``params``, or random weights
        from the configured seed), the optimizer and the EMA copy."""
        cfg = self.cfg
        model = SegOFA(cfg.model)
        if params is None:
            model.init(torch.Generator().manual_seed(cfg.optimization.seed))
        else:
            model.load_state_dict(params, strict=True)
        self.model = model.to(self.device)
        set_generator(self.model, self.generator)
        if cfg.criterion.init_seg_with_text and self.class_tokens is not None:
            init_seg_embeddings(self.model, self.class_tokens, self.class_lengths,
                                cfg.model.num_seg_tokens)
        self.optimizer, self.schedule, self.mask = optim_lib.build_optimizer(
            self.model, cfg.model, cfg.optimization, self.total_num_updates
        )
        for name, p in self.model.named_parameters():
            p.requires_grad_(self.mask[name])
        if cfg.model.freeze_entire_resnet or cfg.model.freeze_resnet:
            # frozen stem: fold the batch norms into the convolutions once
            self.model.encoder.embed_images.fold(compute_dtype(cfg.model))
        self.ema = (
            ema_init(self.model, cfg.common.ema_fp32) if cfg.common.ema_decay > 0 else None
        )
        self.step = 0
        return self

    def load_optimizer_state(self, state: Dict) -> None:
        """Adam count and moments from ``state`` (``{"count", "mu", "nu"}`` by
        parameter name, e.g. ``adam_state_from_jax``); the step counter follows
        the count."""
        names = [n for n, _ in self.model.named_parameters() if self.mask[n]]
        self.optimizer.load_state(names, state)
        self.step = self.optimizer.count

    # ----------------------------------------------------------------- batch

    def _images(self, imgs):
        """uint8 RGB from the wire is normalised here; float images pass."""
        if imgs.dtype != torch.uint8:
            return imgs
        task = self.cfg.task
        mean, std = ((IMAGENET_DEFAULT_MEAN, IMAGENET_DEFAULT_STD)
                     if task.imagenet_default_mean_and_std else ((0.5,) * 3, (0.5,) * 3))
        mean = torch.tensor(mean, dtype=torch.float32, device=imgs.device)
        std = torch.tensor(std, dtype=torch.float32, device=imgs.device)
        return (imgs.float() / 255.0 - mean) / std

    @staticmethod
    def _labels(t):
        """Targets ride uint8 where the class ids fit; computed as int64."""
        return t.long()

    def prepare_batch(self, batch) -> Dict[str, torch.Tensor]:
        """A batch, a dict of numpy arrays or tensors (``patch_images``,
        ``src_tokens``, ``bos_tokens``, ``target``, ``downsampled_target``,
        ``aux_grid_ids``, ``aux_target``; what a step does not read may be
        missing or None) -> tensors on the trainer's device."""
        out = {}
        for k, v in batch.items():
            if v is None:
                continue
            v = torch.as_tensor(v).to(self.device, non_blocking=True)
            if k != "patch_images" and not v.dtype.is_floating_point:
                v = v.long()  # widened on the device, after the narrow transfer
            out[k] = v
        return out

    # ------------------------------------------------------------ train step

    def _loss_fn(self, batch):
        """Image-free training loss (seg_criterion.py:179-183)."""
        cfg = self.cfg
        hw16 = cfg.model.patch_image_size // 16
        _, extra = self.model(
            aux_grid_ids=batch["aux_grid_ids"], aux_src_tokens=batch["src_tokens"],
            bos_tokens=batch["bos_tokens"], class_tokens=self.class_tokens,
            class_lengths=self.class_lengths,
            full_context_alignment=cfg.criterion.full_context_alignment,
        )
        return compute_imfree_loss(
            extra["aux_output"], self._labels(batch["aux_target"]), cfg.model.num_seg_tokens,
            (hw16, hw16), cfg.criterion.label_smoothing,
        )

    def _loss_fn_supervised(self, batch):
        """Supervised branch: CE of the upsampled real-image logits against
        the augmented ground truth (seg_criterion.py:188-192)."""
        cfg = self.cfg
        hw16 = cfg.model.patch_image_size // 16
        logits = self._real_logits(batch)
        target = self._labels(batch["target"])
        out = upsampled_ce(_grid_from_logits(logits, (hw16, hw16)), target,
                           target != cfg.model.num_seg_tokens, cfg.criterion.label_smoothing)
        return out.loss_sum / out.count.clamp(min=1.0)

    def _real_logits(self, batch):
        logits, _ = self.model(
            src_tokens=batch["src_tokens"], patch_images=self._images(batch["patch_images"]),
            bos_tokens=batch["bos_tokens"],
            full_context_alignment=self.cfg.criterion.full_context_alignment,
        )
        return logits

    @torch.no_grad()
    def _monitor(self, batch) -> Dict[str, torch.Tensor]:
        """Inference-mode forward on the real batch, for metrics only."""
        cfg = self.cfg
        hw16 = cfg.model.patch_image_size // 16
        self.model.eval()
        return compute_monitor_outputs(
            self._real_logits(batch), self._labels(batch["target"]),
            batch["downsampled_target"], cfg.model.num_seg_tokens, (hw16, hw16),
            cfg.criterion.label_smoothing,
        )

    def train_step(self, batch) -> Dict[str, Any]:
        """One optimizer update from ``batch`` (leading axis ``update_freq`` x
        microbatch).  Returns the logs as tensors on the device."""
        cfg = self.cfg
        ufreq = max(cfg.optimization.update_freq, 1)
        unsupervised = cfg.criterion.unsupervised_segmentation
        monitoring = unsupervised and cfg.criterion.monitor_real_batch
        loss_fn = self._loss_fn if unsupervised else self._loss_fn_supervised
        batch = self.prepare_batch(batch)
        micro = [batch]
        if ufreq > 1:
            micro = [{k: v.chunk(ufreq)[i] for k, v in batch.items()} for i in range(ufreq)]

        # the monitoring pass reads the parameters of before this update
        mon = self._monitor(micro[0]) if monitoring else None

        self.model.train()
        params = self.optimizer.params
        for p in params:
            p.grad = None
        losses = []
        for mb in micro:
            loss = loss_fn(mb)
            (loss / ufreq).backward()
            losses.append(loss.detach())
        loss = torch.stack(losses).mean()
        # a trainable parameter the loss does not reach still decays
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        for p in params:
            p.grad = None

        gnorm = optim_lib.clip_by_global_norm(grads, cfg.optimization.clip_norm)
        lr = self.schedule(self.step)
        finite = bool(torch.isfinite(gnorm))  # the step's one read of the device
        if finite:
            self.optimizer.step(grads)
            if self.ema is not None:
                ema_step(self.ema, self.model, cfg.common.ema_decay)
            self.step += 1

        logs = {
            "loss": loss,
            "imfree_loss": loss if unsupervised else torch.zeros_like(loss),
            "gnorm": gnorm,
            "lr": lr,
            "n_nonfinite": 0.0 if finite else 1.0,
        }
        if not unsupervised:
            logs["seg_loss"] = loss
        if mon is not None:
            logs["seg_loss"] = mon.pop("nll_loss")
            logs["nll_loss"] = logs["seg_loss"]
            logs.update(mon)
        return logs

    # ------------------------------------------------------------ valid step

    @torch.no_grad()
    def valid_step(self, batch) -> Dict[str, torch.Tensor]:
        """Fixed-shape validation at the training resolution."""
        out = self._monitor(self.prepare_batch(batch))
        out["loss"] = out["nll_loss"]
        return out

    # --------------------------------------------------------------- get/set

    def get_lr(self) -> float:
        return self.schedule(self.step)

    def get_num_updates(self) -> int:
        return self.step
