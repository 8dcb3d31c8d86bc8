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

Under a ``ProcessMesh`` of several processes (``parallel/``) each process
steps on its rows of the global batch (``parallel.mesh.batch_rows``): the
gradients are summed over the data x fsdp ranks, the loss of each rank is
its rows' share of the global mean (the valid cells are counted over the
global batch first), and the logs are summed back, so every rank returns
the logs of the one-process step on the whole batch.  The strategies:

  - data parallel: always, over the mesh's batch group;
  - ``fsdp``: the parameters, gradients, optimizer state and EMA split
    over the 'fsdp' group between steps (``parallel/fsdp.py``), gathered
    whole for the forward and its backward;
  - ``tp``: Megatron tensor parallelism over the 'model' group
    (``parallel/tensor.py``);
  - ``zero1``: the optimizer state split over the 'data' group: each data
    rank updates its slice of each parameter, then the slices are gathered;
  - the model axis's programs (``cfg.distributed``'s pipeline, context and
    expert fields, a ``ParallelPlan`` the model is built with): the ranks
    of a 'model' group step on the same rows.  Every parameter is whole on
    every rank of the group except the experts (one a rank, their
    gradients summed over the batch group only), and every gradient comes
    out whole on every rank (the programs' boundaries make it so), except
    that under the pipeline a layer's gradient exists on its stage alone:
    the layers' gradients are summed over the 'model' group too.

The per-tensor reductions of the optimizers and the global norm sum over
the ranks that hold parts of a tensor (``train/optim.py``, ``Sharding``), so
the step equals the one-process step on the same global batch.
``state_dict`` gathers the whole state (a collective) in the one-process
layout and ``load_state_dict`` cuts a whole state to this rank's parts, so
a checkpoint moves between layouts.  Dropout draws from a generator per
data rank (the ranks of a tensor-parallel group or of a pipeline share
one): masks differ from the one-process run's (ROADMAP.md C.3).
"""

from contextlib import nullcontext

import copy
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from ifseg_torch.config import Config
from ifseg_torch.data.segmentation_dataset import SegBatch, eval_mean_std
from ifseg_torch.models.attention import set_generator
from ifseg_torch.models.encoder import compute_dtype
from ifseg_torch.models.segofa import SegOFA
from ifseg_torch.parallel import comm
from ifseg_torch.parallel.fsdp import FullyShardedParams
from ifseg_torch.parallel.mesh import ProcessMesh
from ifseg_torch.parallel.plan import plan_from_config
from ifseg_torch.parallel.sharding import (
    gather_whole,
    local_part,
    model_layouts,
    restrict,
    shardings_for_plan,
)
from ifseg_torch.parallel.tensor import apply_tensor_parallel
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


STRATEGIES = ("fsdp", "tp", "zero1")


def configured_strategies(dist_cfg) -> set:
    """The strategies a distributed config turns on: fsdp and tp above 1,
    zero1 when set (data parallelism needs no switch)."""
    return ({"fsdp"} if dist_cfg.fsdp > 1 else set()) | (
        {"tp"} if dist_cfg.tensor_parallel > 1 else set()) | (
        {"zero1"} if dist_cfg.zero1 else set())


def rank_seed(seed: int, data_rank: int) -> int:
    """The dropout seed of a data rank: ``seed`` itself on rank 0."""
    if data_rank == 0:
        return seed
    return int(np.random.SeedSequence([seed, data_rank]).generate_state(1, np.uint64)[0] >> 1)


class Trainer:
    """Owns the model, the optimizer, the EMA copy and the step counter.

    ``device=None`` means ``"cuda"`` and raises when no card is present; the
    CPU is used only when the caller passes ``device="cpu"``.  ``mesh``
    places the trainer on a process mesh (one process without it);
    ``strategies`` (a subset of ``STRATEGIES``) defaults to what
    ``cfg.distributed`` asks for.  The config turns fsdp and tp on only
    above degree 1, as the JAX package's does, so ``strategies`` is the one
    way to run their wiring and collectives over a mesh dim of one rank
    (``chip_smoke.py``'s one-process check on the card); zero1 needs no
    such switch."""

    def __init__(self, cfg: Config, class_tokens: Optional[np.ndarray] = None,
                 class_lengths: Optional[np.ndarray] = None, total_num_updates: int = 1,
                 generator: Optional[torch.Generator] = None,
                 device: Optional[Union[str, torch.device]] = None,
                 mesh: Optional[ProcessMesh] = None, strategies=None):
        self.cfg = cfg
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Trainer: no CUDA device (pass device='cpu' to run on the CPU)")
        self.mesh = mesh if mesh is not None else ProcessMesh((1, 1, 1), 0, self.device,
                                                                join=False)
        self.plan = plan_from_config(cfg.distributed, self.mesh)
        self.strategies = set(configured_strategies(cfg.distributed) if strategies is None
                              else strategies)
        if not self.strategies <= set(STRATEGIES):
            raise ValueError(f"strategies {sorted(self.strategies)}: take from {STRATEGIES}")
        resolve_remat_policy(cfg, n_data_shards=self.mesh.size("batch"),
                             hbm_bytes=device_memory_bytes(self.device))
        as_dev = lambda x, dt: None if x is None else torch.as_tensor(
            np.asarray(x), dtype=dt, device=self.device)
        self.class_tokens = as_dev(class_tokens, torch.long)
        self.class_lengths = as_dev(class_lengths, torch.long)
        self.total_num_updates = total_num_updates
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(
                rank_seed(cfg.optimization.seed, self.mesh.index("batch")))
        self.generator = generator
        self.fsdp: Optional[FullyShardedParams] = None
        self.layouts: Dict[str, Dict[int, str]] = {}
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
        model = SegOFA(cfg.model, self.plan)
        if params is None:
            model.init(torch.Generator().manual_seed(cfg.optimization.seed))
        else:
            model.load_state_dict(params, strict=True)
        self.model = model.to(self.device)
        set_generator(self.model, self.generator)
        if cfg.criterion.init_seg_with_text and self.class_tokens is not None:
            init_seg_embeddings(self.model, self.class_tokens, self.class_lengths,
                                cfg.model.num_seg_tokens)
        self.mask = optim_lib.freeze_mask(self.model, cfg.model)
        for name, p in self.model.named_parameters():
            p.requires_grad_(self.mask[name])
        views = parts = None
        if self.parallel:
            views, parts = self._shard_model()
        self.optimizer, self.schedule, _ = optim_lib.build_optimizer(
            self.model, cfg.model, cfg.optimization, self.total_num_updates, views, parts)
        # the trainable parameters (this rank's parts), in the optimizer's order
        self._trainable = [(n, p) for n, p in self.model.named_parameters() if self.mask[n]]
        # under the pipeline a layer's gradient exists on its stage alone
        pp = self.plan is not None and self.plan.pipeline_parallel > 1
        self._stage_grads = {n for n, _ in self._trainable
                             if pp and n.startswith(("encoder.layers.", "decoder.layers."))}
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

    @property
    def parallel(self) -> bool:
        """Whether the step runs the multi-process path (a mesh of several
        processes, or a strategy asked for on a mesh of one)."""
        return self.mesh.distributed or bool(self.strategies)

    def _shard_model(self):
        """Cut the whole model to this rank's parts (TP, then FSDP) and
        return the optimizer's (views, parts): under ZeRO-1 its tensors are
        the rank's slices of the parameters."""
        mesh = self.mesh
        rules = shardings_for_plan(self.cfg.distributed, tp="tp" in self.strategies)
        axes = ({"model"} if rules else set()) | (
            {"fsdp"} if "fsdp" in self.strategies else set())
        state_axes = axes | ({"data"} if "zero1" in self.strategies else set())
        self.layouts = model_layouts(self.model, mesh.shape, axes=state_axes, model_rules=rules)
        if "tp" in self.strategies:
            apply_tensor_parallel(self.model, mesh.group("model"))
        else:
            self._cut_experts(self.model)
        if "fsdp" in self.strategies:
            dims = {n: d for n, lay in self.layouts.items() for d, a in lay.items() if a == "fsdp"}
            self.fsdp = FullyShardedParams(self.model, dims, mesh.group("fsdp"))
        views, parts = {}, {}
        for name, p in self.model.named_parameters():
            lay = self.layouts[name]
            zero = restrict(lay, ("data",))
            if zero:
                views[name] = local_part(p.data, zero, mesh)
            parts[name] = {d: optim_lib.Part(mesh.group(a), mesh.size(a), mesh.index(a))
                           for d, a in lay.items()}
        return views, parts

    @torch.no_grad()
    def _cut_experts(self, model: SegOFA) -> None:
        """Cut ``model``'s (E, ...) expert tensors to this rank's expert (the
        'model' dims of the layouts, where TP does not hold that dim)."""
        mods = dict(model.named_modules())
        for name, p in list(model.named_parameters()):
            cut = restrict(self.layouts.get(name, {}), ("model",))
            if cut:
                mname, _, pname = name.rpartition(".")
                setattr(mods[mname], pname, torch.nn.Parameter(
                    local_part(p.detach(), cut, self.mesh).clone(), requires_grad=p.requires_grad))

    def param_layout(self, name: str) -> Dict[int, str]:
        """The dims of parameter ``name`` split across ranks (TP, FSDP)."""
        return restrict(self.layouts.get(name, {}), ("model", "fsdp"))

    def _whole(self, grad: bool):
        """The block with the parameters whole (FSDP), else as they are."""
        return self.fsdp.gathered(grad) if self.fsdp is not None else nullcontext()

    def _fold_frozen_stem(self) -> None:
        """A frozen stem: fold the batch norms into the convolutions, once
        per change of its weights."""
        if self.cfg.model.freeze_entire_resnet or self.cfg.model.freeze_resnet:
            with self._whole(grad=False):
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
        controller's best, bad count and scale).  Under a mesh every tensor
        is gathered whole (a collective: every rank calls it), in the
        one-process layout; the generator is this rank's."""
        host = lambda t: t.detach().to("cpu", copy=True)
        state = {
            "model": {k: host(v) for k, v in self.whole_state().items()},
            "ema": None if self.ema is None else {
                k: host(self._whole_tensor(k, v)) for k, v in self.ema.items()},
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
        parameter tensors.  Under a mesh each whole tensor is cut to this
        rank's part; a data rank other than 0 seeds its generator from the
        step instead of taking the saved (rank 0's) state."""
        if "model" in state:
            if self.layouts:
                self._load_whole(state["model"])
            else:
                self.model.load_state_dict(state["model"], strict=True)
            self._fold_frozen_stem()
        if state.get("ema") is not None and self.ema is not None:
            for k, v in self.ema.items():
                v.copy_(local_part(state["ema"][k], self.param_layout(k), self.mesh))
        if "optimizer" in state:
            self.load_optimizer_state(state["optimizer"])
        if "step" in state:
            self.step = int(state["step"])
        if "generator" in state:
            self.generator.set_state(state["generator"])
            if self.mesh.index("batch") > 0:
                self.generator.manual_seed(rank_seed(
                    self.cfg.optimization.seed + self.step, self.mesh.index("batch")))
        if state.get("plateau") is not None and self.plateau is not None:
            self.plateau.load_state_dict(state["plateau"])

    def _whole_tensor(self, name: str, t: torch.Tensor) -> torch.Tensor:
        return gather_whole(t, self.param_layout(name), self.mesh) if self.layouts else t

    def whole_state(self) -> Dict[str, torch.Tensor]:
        """The model's state dict with every parameter whole (gathered from
        the ranks' parts under TP or FSDP: a collective)."""
        if not self.layouts:
            return self.model.state_dict()
        names = {id(p): n for n, p in self.model.named_parameters()}
        return {k: (self._whole_tensor(names[id(v)], v.detach()) if id(v) in names else v.detach())
                for k, v in self.model.state_dict(keep_vars=True).items()}

    def _load_whole(self, whole: Dict[str, torch.Tensor]) -> None:
        own = self.model.state_dict(keep_vars=True)
        if set(own) != set(whole):
            raise KeyError(f"state keys differ: missing {sorted(set(own) - set(whole))[:5]}, "
                           f"unexpected {sorted(set(whole) - set(own))[:5]}")
        names = {id(p): n for n, p in self.model.named_parameters()}
        for k, v in own.items():
            src = whole[k]
            if id(v) in names:
                src = local_part(src, self.param_layout(names[id(v)]), self.mesh)
            v.data.copy_(src)

    def fingerprint(self) -> float:
        """``utils.reliability.param_fingerprint`` of the parameters, leaf by
        leaf of the JAX tree (the per-layer tables stacked): the same on
        every rank of a synced run (a collective under TP or FSDP)."""
        from ifseg_torch.utils.reliability import param_fingerprint

        paths = optim_lib.jax_paths(self.model)
        leaves: Dict[str, list] = {}
        for name, p in self.model.named_parameters():
            leaves.setdefault(paths[name][0], []).append((name, p.detach()))
        tensors = {path: torch.stack([t for _, t in m]) if len(m) > 1 else m[0][1]
                   for path, m in leaves.items()}
        order = sorted(tensors, key=lambda k: k.split("/"))
        sharding = optim_lib.Sharding([
            {d: optim_lib.Part(self.mesh.group(a), self.mesh.size(a), self.mesh.index(a))
             for d, a in self.param_layout(leaves[k][0][0]).items()} for k in order])
        return param_fingerprint(tensors, sharding, order)

    def eval_model(self) -> SegOFA:
        """The model whose weights validation reads: under ``--uses-ema``
        (with an EMA copy) a module of its own, built at the first call and
        holding the EMA weights as they stood then; else the training model
        itself.  Under TP or FSDP, where the training model holds parts, it
        is always a whole module of its own (the counterpart of the JAX
        evaluator's ``_localize_params``), built with the trainer's plan and
        holding the rank's expert where there are experts.
        ``sync_eval_weights`` brings it up to date."""
        split = self._split
        if not split and not (self.cfg.task.uses_ema and self.ema is not None):
            return self.model
        if self._ema_model is None:
            if split:
                self._ema_model = SegOFA(self.cfg.model, self.plan).to(self.device)
                if "tp" not in self.strategies:
                    self._cut_experts(self._ema_model)
            else:
                self._ema_model = copy.deepcopy(self.model, {id(self.generator): self.generator})
            self._ema_model.requires_grad_(False)
            self.sync_eval_weights()
        return self._ema_model

    @property
    def _split(self) -> bool:
        """Whether the model holds parts that a whole evaluation model must
        gather (TP, FSDP); the experts stay one a rank in every copy."""
        return bool(self.fsdp is not None or "tp" in self.strategies)

    @torch.no_grad()
    def sync_eval_weights(self) -> None:
        """Copy the current weights (the EMA weights under ``--uses-ema``),
        whole and in place, into the module that ``eval_model`` returned,
        so that an ``Evaluator`` built on that module evaluates them at its
        next ``refresh_weights``.  Without such a module validation reads
        the training model and there is nothing to copy.  Under TP or FSDP
        this gathers: every rank calls it."""
        if self._ema_model is None:
            return
        ema = self.cfg.task.uses_ema and self.ema is not None
        if not self._split:  # a copy holding the same parts as the model
            for name, p in self._ema_model.named_parameters():
                p.copy_(self.ema[name])
            return
        src = dict(self.model.named_parameters())
        axes = ("model", "fsdp") if "tp" in self.strategies else ("fsdp",)
        for name, p in self._ema_model.named_parameters():
            t = self.ema[name] if ema else src[name].detach()
            p.copy_(gather_whole(t, restrict(self.layouts[name], axes), self.mesh))
        for name, b in self._ema_model.named_buffers():
            b.copy_(dict(self.model.named_buffers())[name])

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

    def _loss_fn(self, batch, count=None):
        """Image-free training loss (seg_criterion.py:179-183); ``count``:
        the global batch's valid cells where the rows are a share of it."""
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
            (hw16, hw16), cfg.criterion.label_smoothing, count=count,
        )

    def _loss_fn_supervised(self, batch, count=None):
        """Supervised branch: CE of the upsampled real-image logits against
        the augmented ground truth (seg_criterion.py:188-192)."""
        cfg = self.cfg
        hw16 = cfg.model.patch_image_size // 16
        logits = self._real_logits(batch)
        target = self._labels(batch["target"])
        out = upsampled_ce(_grid_from_logits(logits, (hw16, hw16)), target,
                           target != cfg.model.num_seg_tokens, cfg.criterion.label_smoothing)
        return out.loss_sum / (out.count if count is None else count).clamp(min=1.0)

    def _real_logits(self, batch):
        logits, _ = self.model(
            src_tokens=batch["src_tokens"], patch_images=self._images(batch["patch_images"]),
            bos_tokens=batch["bos_tokens"],
            full_context_alignment=self.cfg.criterion.full_context_alignment,
        )
        return logits

    @torch.no_grad()
    def _monitor(self, batch, count=None) -> Dict[str, torch.Tensor]:
        """Inference-mode forward on the real batch, for metrics only."""
        cfg = self.cfg
        hw16 = cfg.model.patch_image_size // 16
        self.model.eval()
        with self._whole(grad=False):
            logits = self._real_logits(batch)
        return compute_monitor_outputs(
            logits, self._labels(batch["target"]),
            batch["downsampled_target"], cfg.model.num_seg_tokens, (hw16, hw16),
            cfg.criterion.label_smoothing, count=count,
        )

    def _global_counts(self, micro, unsupervised: bool, monitoring: bool):
        """The valid cells of each microbatch's loss (and of the monitoring
        pass) over the global batch: this rank's counts summed over the
        batch group.  None in one process."""
        if not self.parallel:
            return None, None
        num_seg = self.cfg.model.num_seg_tokens
        key = "aux_target" if unsupervised else "target"
        counts = [(mb[key] != num_seg).sum() for mb in micro]
        if monitoring:
            counts.append((micro[0]["target"] != num_seg).sum())
        counts = comm.all_reduce(torch.stack(counts).float(), self.mesh.group("batch"))
        return list(counts[:len(micro)]), (counts[-1] if monitoring else None)

    def _reduce_grads(self, names, grads) -> None:
        """Sum the gradients over the data x fsdp ranks, in place: one
        all-reduce of the flattened gradients a group.  An FSDP shard's
        gradient was already summed over 'fsdp' by its gather's backward,
        so it is summed over 'data' only.  Under the pipeline the layers'
        gradients are then summed over 'model' (each stage holds its own
        layers')."""
        mesh = self.mesh
        if not mesh.distributed:
            return
        by_group: Dict[str, list] = {"batch": [], "data": []}
        for name, g in zip(names, grads):
            by_group["data" if "fsdp" in self.param_layout(name).values() else "batch"].append(g)
        by_group["model"] = [g for name, g in zip(names, grads) if name in self._stage_grads]
        for axis, gs in by_group.items():
            if gs:
                flat = comm.all_reduce(torch.cat([g.reshape(-1) for g in gs]), mesh.group(axis))
                offset = 0
                for g in gs:
                    g.copy_(flat[offset:offset + g.numel()].view_as(g))
                    offset += g.numel()

    def train_step(self, batch) -> Dict[str, Any]:
        """One optimizer update from ``batch`` (leading axis ``update_freq`` x
        microbatch; under a mesh, this rank's rows of the global batch, as
        ``parallel.mesh.batch_rows`` picks them).  Returns the logs (of the
        global batch) as tensors on the device."""
        cfg = self.cfg
        ufreq = max(cfg.optimization.update_freq, 1)
        unsupervised = cfg.criterion.unsupervised_segmentation
        monitoring = unsupervised and cfg.criterion.monitor_real_batch
        loss_fn = self._loss_fn if unsupervised else self._loss_fn_supervised
        batch = self.prepare_batch(batch)
        micro = [batch]
        if ufreq > 1:
            micro = [{k: v.chunk(ufreq)[i] for k, v in batch.items()} for i in range(ufreq)]
        counts, mon_count = self._global_counts(micro, unsupervised, monitoring)

        # the monitoring pass reads the parameters of before this update
        mon = self._monitor(micro[0], mon_count) if monitoring else None

        self.model.train()
        named = self._trainable
        for _, p in named:
            p.grad = None
        losses = []
        for i, mb in enumerate(micro):
            with self._whole(grad=True):
                loss = loss_fn(mb) if counts is None else loss_fn(mb, counts[i])
                (loss / ufreq).backward()
            losses.append(loss.detach())
        # a trainable parameter the loss does not reach still decays
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for _, p in named]
        for _, p in named:
            p.grad = None
        if self.parallel:
            self._reduce_grads([n for n, _ in named], grads)
            grad_sharding = optim_lib.Sharding([
                {d: optim_lib.Part(self.mesh.group(a), self.mesh.size(a), self.mesh.index(a))
                 for d, a in self.param_layout(n).items()} for n, _ in named])
        else:
            grad_sharding = None

        gnorm = optim_lib.clip_by_global_norm(grads, cfg.optimization.clip_norm, grad_sharding)
        lr = self.schedule(self.step)
        finite = bool(torch.isfinite(gnorm))  # the step's one read of the device
        if finite:
            self._apply(named, grads)
            if self.ema is not None:
                ema_step(self.ema, self.model, cfg.common.ema_decay)
            self.step += 1

        loss = torch.stack(losses)
        if mon is not None and self.parallel:
            keys = [k for k in mon if k.startswith("area")]
            flat = torch.cat([loss, mon["nll_loss"][None]] + [mon[k].reshape(-1) for k in keys])
            flat = comm.all_reduce(flat, self.mesh.group("batch"))
            loss, mon["nll_loss"] = flat[:len(losses)], flat[len(losses)]
            offset = len(losses) + 1
            for k in keys:
                n = mon[k].numel()
                mon[k] = flat[offset:offset + n].view_as(mon[k])
                offset += n
        elif self.parallel:
            loss = comm.all_reduce(loss, self.mesh.group("batch"))
        loss = loss.mean()
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

    @torch.no_grad()
    def _apply(self, named, grads) -> None:
        """The optimizer's update; under ZeRO-1 each data rank updates its
        slices and the slices are gathered back into the parameters."""
        if not self.layouts:
            self.optimizer.step(grads)
            return
        zero = [restrict(self.layouts[n], ("data",)) for n, _ in named]
        self.optimizer.step([local_part(g, z, self.mesh) for g, z in zip(grads, zero)])
        split = [(p, next(iter(z))) for (_, p), z in zip(named, zero) if z]
        if split:  # the updated slices back into every data rank's parameters, in one gather
            whole = comm.all_gather_many([local_part(p.data, {d: "data"}, self.mesh)
                                          for p, d in split], [d for _, d in split],
                                         self.mesh.group("data"))
            for (p, _), w in zip(split, whole):
                p.copy_(w)

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
