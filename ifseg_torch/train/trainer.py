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
dbias atomics of the attention backward on a card).  ``state_dict`` /
``load_state_dict`` carry the whole training state (fp32 parameters, the
EMA copy, the optimizer's count and state by parameter name, its lr scale,
the plateau controller, the step, the generator's state), so a run that
saves and restores goes on bit for bit like one that never stopped.

Activation checkpointing of the layers (``models/layers.py run_layer``)
follows ``cfg.model.checkpoint_activations`` and ``remat_policy``; the
default "auto" is resolved here, before the model is built, by the JAX
package's bytes model and threshold (``estimate_train_hbm_bytes``,
``resolve_remat_policy``), with the device's memory in place of the TPU's.
Meshes and shardings are not ported.
"""

import copy
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from ifseg_torch.config import Config
from ifseg_torch.data.segmentation_dataset import SegBatch, eval_mean_std
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


# approximate trainable-parameter counts of the ResNet stems, for the bytes
# model below (the JAX package's numbers)
_RESNET_PARAMS = {"resnet50": 24e6, "resnet101": 43e6, "resnet152": 58e6}
# "auto" turns checkpointing off where the estimate stays under this share of
# the device's memory (the JAX package's threshold)
REMAT_AUTO_SHARE = 0.72
# the memory the JAX package assumes where a device reports none (its CPU)
DEFAULT_DEVICE_BYTES = 16e9


def estimate_train_hbm_bytes(model_cfg, per_chip_microbatch: int, ema: bool = False) -> float:
    """The JAX package's bytes model of one training step without
    checkpointing: fp32 parameters, Adam's moments and gradients (4 copies,
    5 with EMA), the two all-layer bf16 bias packs with their fp32 dbias,
    and ~13 d-wide bf16 activations a layer and token.  Unchanged, so that
    "auto" decides as the JAX package does; it was calibrated on TPU
    memory, not on this port's."""
    m = model_cfg
    d, dd = m.encoder_embed_dim, m.decoder_embed_dim
    nl_e, nl_d = m.encoder_layers, m.decoder_layers
    hw = (m.patch_image_size // 16) ** 2
    l_tok = hw + 96  # image grid + text/src tokens (+BOS, rounded up)
    n_params = (60e3 * d + _RESNET_PARAMS.get(m.resnet_type, 43e6)
                + nl_e * 12 * d * d + nl_d * 16 * dd * dd)
    fixed = n_params * 4.0 * (4 + (1 if ema else 0))
    heads = m.encoder_attention_heads
    pack = 2 * (nl_e * heads * l_tok * l_tok * 2)
    dbias = 2 * (nl_e * heads * l_tok * l_tok * 4)
    acts = (nl_e * d + nl_d * dd) * l_tok * 13 * 2 * per_chip_microbatch
    return fixed + pack + dbias + acts


def device_memory_bytes(device) -> float:
    """The device's memory: a card's total (``torch.cuda.mem_get_info``),
    else the JAX package's default for a device that reports none."""
    device = torch.device(device)
    if device.type == "cuda":
        return float(torch.cuda.mem_get_info(device)[1])
    return DEFAULT_DEVICE_BYTES


def resolve_remat_policy(cfg: Config, n_data_shards: int = 1,
                         hbm_bytes: Optional[float] = None) -> None:
    """Resolve ``cfg.model.remat_policy == "auto"`` in place, before the
    model is built, as the JAX package does: "save-attn", and checkpointing
    off where the image-free step's estimate fits under 72 % of
    ``hbm_bytes``.  The supervised branch keeps it on (it back-propagates
    through the stem, which the bytes model leaves out)."""
    m = cfg.model
    if m.remat_policy != "auto":
        return
    m.remat_policy = "save-attn"
    if not m.checkpoint_activations or not cfg.criterion.unsupervised_segmentation:
        return
    ufreq = max(cfg.optimization.update_freq, 1)
    per_chip = max(cfg.optimization.batch_size // max(n_data_shards, 1) // ufreq, 1)
    if hbm_bytes is None:
        hbm_bytes = DEFAULT_DEVICE_BYTES
    if estimate_train_hbm_bytes(m, per_chip, ema=cfg.task.uses_ema) < REMAT_AUTO_SHARE * hbm_bytes:
        m.checkpoint_activations = False


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
        resolve_remat_policy(cfg, hbm_bytes=device_memory_bytes(self.device))
        as_dev = lambda x, dt: None if x is None else torch.as_tensor(
            np.asarray(x), dtype=dt, device=self.device)
        self.class_tokens = as_dev(class_tokens, torch.long)
        self.class_lengths = as_dev(class_lengths, torch.long)
        self.total_num_updates = total_num_updates
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(cfg.optimization.seed)
        self.generator = generator
        self.model: Optional[SegOFA] = None
        self.optimizer: Optional[optim_lib.Optimizer] = None
        self.plateau: Optional[optim_lib.ReduceLROnPlateau] = None
        self.ema: Optional[Dict[str, torch.Tensor]] = None
        self._ema_model: Optional[SegOFA] = None
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
        opt = cfg.optimization
        self.plateau = (optim_lib.ReduceLROnPlateau(
            shrink=opt.lr_shrink, patience=opt.lr_patience,
            maximize=cfg.checkpoint.maximize_best_checkpoint_metric)
            if opt.lr_scheduler == "reduce_lr_on_plateau" else None)
        self._fold_frozen_stem()
        self.ema = (
            ema_init(self.model, cfg.common.ema_fp32) if cfg.common.ema_decay > 0 else None
        )
        self._ema_model = None
        self.step = 0
        return self

    def _fold_frozen_stem(self) -> None:
        """A frozen stem: fold the batch norms into the convolutions, once
        per change of its weights."""
        if self.cfg.model.freeze_entire_resnet or self.cfg.model.freeze_resnet:
            self.model.encoder.embed_images.fold(compute_dtype(self.cfg.model))

    def load_optimizer_state(self, state: Dict) -> None:
        """The optimizer's state from ``state`` (what its ``state_dict``
        gives; for Adam ``{"count", "mu", "nu"}`` by parameter name, e.g.
        ``adam_state_from_jax``); the step counter follows the count."""
        self.optimizer.load_state_dict(state)
        self.step = self.optimizer.count

    def set_lr_scale(self, scale: float) -> None:
        """Apply a plateau decision: every later update is scaled by ``scale``."""
        optim_lib.set_lr_scale(self.optimizer, scale)

    # ----------------------------------------------------------------- state

    def state_dict(self) -> Dict[str, Any]:
        """The whole training state as CPU copies: ``model`` (the model's
        state dict: fp32 parameters and buffers), ``ema`` (the EMA copy by
        parameter name, or None), ``optimizer`` (its ``state_dict``: the
        count, its state by parameter name, e.g. Adam's ``mu`` and ``nu``,
        and the lr scale), ``step``, ``generator`` (the dropout generator's
        state) and, under ``reduce_lr_on_plateau``, ``plateau`` (the
        controller's best, bad count and scale)."""
        host = lambda t: t.detach().to("cpu", copy=True)
        state = {
            "model": {k: host(v) for k, v in self.model.state_dict().items()},
            "ema": None if self.ema is None else {k: host(v) for k, v in self.ema.items()},
            "optimizer": self.optimizer.state_dict(),
            "step": self.step,
            "generator": self.generator.get_state(),
        }
        if self.plateau is not None:
            state["plateau"] = self.plateau.state_dict()
        return state

    @torch.no_grad()
    def load_state_dict(self, state: Dict[str, Any]) -> None:
        """Take the parts of a ``state_dict()`` that ``state`` holds (all, or
        e.g. only ``model`` and ``ema``), in place: the optimizer keeps its
        parameter tensors."""
        if "model" in state:
            self.model.load_state_dict(state["model"], strict=True)
            self._fold_frozen_stem()
        if state.get("ema") is not None and self.ema is not None:
            for k, v in self.ema.items():
                v.copy_(state["ema"][k])
        if "optimizer" in state:
            self.load_optimizer_state(state["optimizer"])
        if "step" in state:
            self.step = int(state["step"])
        if "generator" in state:
            self.generator.set_state(state["generator"])
        if state.get("plateau") is not None and self.plateau is not None:
            self.plateau.load_state_dict(state["plateau"])

    def eval_model(self) -> SegOFA:
        """The model whose weights validation reads: under ``--uses-ema``
        (with an EMA copy) a module of its own, built at the first call and
        holding the EMA weights as they stood then; else the training model
        itself.  ``sync_eval_weights`` brings the EMA module up to date."""
        if not (self.cfg.task.uses_ema and self.ema is not None):
            return self.model
        if self._ema_model is None:
            self._ema_model = copy.deepcopy(self.model, {id(self.generator): self.generator})
            self._ema_model.requires_grad_(False)
            self.sync_eval_weights()
        return self._ema_model

    @torch.no_grad()
    def sync_eval_weights(self) -> None:
        """Copy the current EMA weights, in place, into the module that
        ``eval_model`` returned, so that an ``Evaluator`` built on that module
        evaluates them at its next ``refresh_weights``.  Without an EMA
        module (no ``--uses-ema``), validation reads the training model and
        there is nothing to copy."""
        if self._ema_model is None:
            return
        for name, p in self._ema_model.named_parameters():
            p.copy_(self.ema[name])

    # ----------------------------------------------------------------- batch

    def _images(self, imgs):
        """uint8 RGB from the wire is normalised here; float images pass."""
        if imgs.dtype != torch.uint8:
            return imgs
        mean, std = eval_mean_std(self.cfg.task)
        mean = torch.tensor(mean, dtype=torch.float32, device=imgs.device)
        std = torch.tensor(std, dtype=torch.float32, device=imgs.device)
        return (imgs.float() / 255.0 - mean) / std

    @staticmethod
    def _labels(t):
        """Targets ride uint8 where the class ids fit; computed as int64."""
        return t.long()

    def prepare_batch(self, batch) -> Dict[str, torch.Tensor]:
        """A batch, a ``SegBatch`` or a dict of numpy arrays or tensors
        (``patch_images``, ``src_tokens``, ``bos_tokens``, ``target``,
        ``downsampled_target``, ``aux_grid_ids``, ``aux_target``; what a step
        does not read may be missing or None) -> tensors on the trainer's
        device."""
        if isinstance(batch, SegBatch):
            batch = {k: getattr(batch, k) for k in (
                "patch_images", "src_tokens", "bos_tokens", "target", "downsampled_target",
                "aux_grid_ids", "aux_target")}
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
