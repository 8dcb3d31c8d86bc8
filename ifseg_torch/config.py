"""Configuration of the port, and the reference-style flags that fill it.

Every field of every section of the JAX package's ``Config``, with the
same name and default, so one set of keyword arguments builds both and a
flag means the same thing in both.  Three kinds of field:

- those the port reads, as the JAX package does;
- those the JAX package parses and never reads (``decoder_type``,
  ``share_*``, ``code_*``, ``*_normalize_before``, ``resnet_drop_path_rate``,
  ``no_scale_embedding``, ``*entangle*``, ``max_src_length``,
  ``max_tgt_length``, ``valid_batch_size``, ``upscale_lprobs``,
  ``criterion_update_freq``, ``freeze_embedding_iter``, ``ignore_eos``,
  ``sentence_avg``, ``fixed_validation_seed``, ``log_file``, ``profile``):
  inert here too;
- those the JAX package honours and the port does not yet (the pipeline,
  context and expert fields of the ``distributed`` section): a non-default
  value raises, naming the ROADMAP.md item that brings them.

``from_flags`` parses the ``--flag-name=value`` strings of
``run_scripts/IFSeg/*.sh`` into a ``Config`` as the JAX package's does; a
flag that names no field of either package is ignored, as there.
"""

import dataclasses
import json
from dataclasses import dataclass, field
from typing import List, Optional, Tuple


def _str2bool(x) -> bool:
    if isinstance(x, bool):
        return x
    x = str(x).lower()
    if x == "true":
        return True
    if x == "false":
        return False
    raise ValueError(f"Unable to recognize string bool input: {x}")


@dataclass
class ModelConfig:
    """SegOFA architecture (models/segofa/segofa.py arch variants)."""

    arch: str = "segofa_base"
    encoder_embed_dim: int = 768
    encoder_ffn_embed_dim: int = 3072
    encoder_layers: int = 6
    encoder_attention_heads: int = 12
    decoder_embed_dim: int = 768
    decoder_ffn_embed_dim: int = 3072
    decoder_layers: int = 6
    decoder_attention_heads: int = 12
    resnet_type: str = "resnet101"

    # "gelu_tanh" (default), "gelu"/"gelu_exact" (erf form), "gelu_poly"
    # (ops/gelu.py) or "relu"
    activation_fn: str = "gelu_tanh"
    dropout: float = 0.1
    attention_dropout: float = 0.0
    activation_dropout: float = 0.0
    encoder_drop_path_rate: float = 0.1
    decoder_drop_path_rate: float = 0.1
    # LayerDrop: whole layers skipped iid during training
    encoder_layerdrop: float = 0.0
    decoder_layerdrop: float = 0.0
    resnet_drop_path_rate: float = 0.0  # parsed, never read (as in JAX)

    # OFA extras (all on in the IFSeg run scripts); the normalize-before,
    # code, scale-embedding and entangle flags are parsed and never read, as
    # in the JAX package (the layers are pre-LN)
    encoder_normalize_before: bool = True
    decoder_normalize_before: bool = True
    layernorm_embedding: bool = True
    patch_layernorm_embedding: bool = True
    code_layernorm_embedding: bool = True
    add_type_embedding: bool = True
    scale_attn: bool = True
    scale_fc: bool = True
    scale_heads: bool = True
    scale_resids: bool = False
    attn_scale_factor: float = 2.0
    no_scale_embedding: bool = True
    entangle_position_embedding: bool = False
    disable_entangle: bool = True

    token_bucket_size: int = 256
    image_bucket_size: int = 42
    code_image_size: int = 128
    max_source_positions: int = 1024
    max_target_positions: int = 1024

    patch_image_size: int = 512
    orig_patch_image_size: int = 512

    # adapters (models/layers.py Adapter, on the FFN output of every layer)
    # and prefix tuning (PromptEncoder: P learned key/value rows a layer,
    # prepended in self-attention); a prompt type other than "prefix" builds
    # the prompt encoder and applies nothing, as in the JAX package
    adapter: bool = False
    adapter_dim: int = 200
    encoder_prompt: bool = False
    encoder_prompt_type: str = "prefix"
    encoder_prompt_length: int = 100
    encoder_prompt_projection: bool = False
    encoder_prompt_dim: int = 0  # 0 -> 2 * encoder_embed_dim
    decoder_prompt: bool = False
    decoder_prompt_type: str = "prefix"
    decoder_prompt_length: int = 100
    decoder_prompt_projection: bool = False
    decoder_prompt_dim: int = 0

    num_seg_tokens: int = 150
    decoder_type: str = "surrogate"  # parsed, never read (as in JAX)
    decoder_input_type: str = "encoder_output"  # encoder_input | encoder_output
    tie_seg_projection: bool = True

    # freezing policy of the reference run scripts
    freeze_encoder_embedding: bool = True
    freeze_decoder_embedding: bool = True
    freeze_seg_embedding: bool = True
    freeze_entire_resnet: bool = True
    freeze_resnet: bool = False
    # BitFit: only the LayerNorm and FFN biases train; overrides every other
    # freeze rule (train/optim.py freeze_mask)
    bitfit: bool = False
    freeze_encoder_transformer: bool = False
    freeze_encoder_transformer_layers: int = 0
    # LayerDrop pruning at load: the checkpoint's layers to keep, comma
    # separated, renumbered in order (checkpoint/convert.py prune_layers)
    encoder_layers_to_keep: str = ""
    decoder_layers_to_keep: str = ""

    share_all_embeddings: bool = True  # one token embedding, always (as in JAX)
    share_decoder_input_output_embed: bool = True

    dtype: str = "bfloat16"  # compute dtype; params are always fp32
    # the fused attention kernels (ops/flash_attention.py); False takes the
    # plain softmax attention of models/attention.py on any device, as the
    # JAX flag takes its XLA path
    use_flash_attention: bool = True

    # activation checkpointing of the encoder and decoder layers: the
    # backward recomputes each layer's forward from its input.  The policy:
    # 'full' recomputes everything, the attention kernels included;
    # 'save-attn' keeps each attention's output and row logsumexp, so the
    # backward never runs the forward kernel again; 'save-attn-ffn' also keeps
    # the FFN activation.  'auto' (the default) lets the Trainer decide from
    # the JAX package's bytes model (train/trainer.py resolve_remat_policy):
    # off where the whole activation set fits the device with margin,
    # save-attn otherwise; a model built outside a Trainer takes save-attn
    checkpoint_activations: bool = True
    remat_policy: str = "auto"

    @property
    def seg_bucket_size(self) -> int:
        return self.patch_image_size // 16

    @property
    def vocab_size(self) -> int:
        """Token-embedding rows = len(dict) - num_seg_tokens
        (unify_transformer.py:400-411)."""
        base = 50264 + 1 + 8192 + 1000  # specials+dict.txt, <mask>, codes, bins
        return base + 1  # (num_seg+1 symbols added, num_seg subtracted)


_ARCH_OVERRIDES = {
    "segofa_tiny": dict(
        encoder_embed_dim=256, encoder_ffn_embed_dim=1024, encoder_layers=4,
        encoder_attention_heads=4, decoder_embed_dim=256, decoder_ffn_embed_dim=1024,
        decoder_layers=4, decoder_attention_heads=4, resnet_type="resnet50",
    ),
    "segofa_medium": dict(
        encoder_embed_dim=512, encoder_ffn_embed_dim=2048, encoder_layers=4,
        encoder_attention_heads=8, decoder_embed_dim=512, decoder_ffn_embed_dim=2048,
        decoder_layers=4, decoder_attention_heads=8, resnet_type="resnet101",
    ),
    "segofa_base": dict(
        encoder_embed_dim=768, encoder_ffn_embed_dim=3072, encoder_layers=6,
        encoder_attention_heads=12, decoder_embed_dim=768, decoder_ffn_embed_dim=3072,
        decoder_layers=6, decoder_attention_heads=12, resnet_type="resnet101",
    ),
    "segofa_large": dict(
        encoder_embed_dim=1024, encoder_ffn_embed_dim=4096, encoder_layers=12,
        encoder_attention_heads=16, decoder_embed_dim=1024, decoder_ffn_embed_dim=4096,
        decoder_layers=12, decoder_attention_heads=16, resnet_type="resnet152",
    ),
    "segofa_huge": dict(
        encoder_embed_dim=1280, encoder_ffn_embed_dim=5120, encoder_layers=24,
        encoder_attention_heads=16, decoder_embed_dim=1280, decoder_ffn_embed_dim=5120,
        decoder_layers=12, decoder_attention_heads=16, resnet_type="resnet152",
    ),
}


def model_config_for_arch(arch: str, **kwargs) -> ModelConfig:
    if arch not in _ARCH_OVERRIDES:
        raise ValueError(f"unknown arch {arch}; choose from {list(_ARCH_OVERRIDES)}")
    over = dict(_ARCH_OVERRIDES[arch])
    over.update(kwargs)
    return ModelConfig(arch=arch, **over)


@dataclass
class TaskConfig:
    """Segmentation task (tasks/mm_tasks/segmentation.py:37-98 + OFAConfig)."""

    data: str = ""  # comma-separated TSV paths; valid is last
    selected_cols: str = "0,1,2"
    bpe: str = "gpt2"  # 'gpt2' (OFA) or 'bert' (OFA-CN); ofa_task.py:169
    bpe_dir: str = "assets/BPE"
    max_src_length: int = 80  # parsed, never read (as in JAX)
    max_tgt_length: int = 20  # parsed, never read (as in JAX)
    code_dict_size: int = 8192
    num_bins: int = 1000
    patch_image_size: int = 512
    orig_patch_image_size: int = 512
    imagenet_default_mean_and_std: bool = False
    num_seg_tokens: int = 150
    category_list: str = ""
    prompt_prefix: str = "what is the segmentation map of the image? object:"
    artificial_image_type: str = "rand_k-1-33"
    epoch_row_count: int = -1
    valid_batch_size: int = 1  # parsed, never read (as in JAX)
    # validate (and so choose the best checkpoint) with the EMA weights
    uses_ema: bool = False
    # >0: threads that build the rows of a training batch (data/iterators.py)
    num_workers: int = 0
    # False: the image-free fast path; the training rows are read but never
    # decoded (cli/train sets it when no step reads the real images)
    decode_real_images: bool = True

    @property
    def categories(self) -> List[str]:
        return [x.strip() for x in self.category_list.split(",") if x.strip()]


@dataclass
class CriterionConfig:
    """Seg criterion (criterions/seg_criterion.py)."""

    label_smoothing: float = 0.0
    upscale_lprobs: bool = True  # parsed, never read (as in JAX)
    unsupervised_segmentation: bool = True
    # parsed, never read (as in JAX)
    criterion_update_freq: int = 1
    freeze_embedding_iter: int = -1
    full_context_alignment: bool = False
    init_seg_with_text: bool = True
    # the reference runs an inference-mode forward on the real batch every
    # step purely for monitoring metrics; off trains faster with identical
    # learning dynamics
    monitor_real_batch: bool = True
    # ResNet label-propagation post-process at evaluation
    # (seg_criterion.py:130-132, :195-214); resnet_iters = 0 turns it off
    resnet_topk: int = 3
    resnet_prob_temperature: float = 1.0
    resnet_iters: int = 0
    # parsed, never read (as in JAX)
    ignore_eos: bool = True
    sentence_avg: bool = False


@dataclass
class OptimizationConfig:
    lr: float = 5e-5
    # adam | adafactor | lamb | fused_lamb | sgd | nag | adagrad | adadelta |
    # adamax | composite (train/optim.py)
    optimizer: str = "adam"
    # composite: "regex=opt@lr,regex=opt@lr" over the JAX parameter paths;
    # parameters no group matches take composite_base
    composite_groups: str = ""
    composite_base: str = "adam"
    momentum: float = 0.0  # sgd / nag
    # cosine | inverse_sqrt | polynomial_decay | fixed | pass_through |
    # manual | triangular | tri_stage | reduce_lr_on_plateau
    lr_scheduler: str = "cosine"
    # reduce_lr_on_plateau: shrink factor, validations without improvement;
    # triangular: the per-cycle shrink
    lr_shrink: float = 0.1
    lr_patience: int = 0
    # manual: "epoch:lr,epoch:lr", each lr from that epoch on
    manual_lr_schedule: str = ""
    # triangular: the peak (0 -> 10 * lr) and the half period in updates
    max_lr: float = 0.0
    lr_period_updates: int = 1000
    # tri_stage: the hold after the warm-up, in updates
    hold_updates: int = 0
    warmup_ratio: float = 0.0
    warmup_updates: int = 0
    weight_decay: float = 0.1
    adam_betas: Tuple[float, float] = (0.9, 0.999)
    adam_eps: float = 1e-8
    clip_norm: float = 1.0
    update_freq: int = 1
    max_epoch: int = 20
    # stop once this many optimizer updates have run (0 = unlimited)
    max_update: int = 0
    # stop once the training wall time exceeds this many hours (0 = unlimited)
    stop_time_hours: float = 0.0
    batch_size: int = 4
    batch_size_valid: int = 1  # rows of one evaluation group at most
    fixed_validation_seed: Optional[int] = 7  # parsed, never read (as in JAX)
    seed: int = 7
    # parsed as the JAX package parses them; bf16 training uses no loss
    # scaler (train/optim.py DynamicLossScaler is kept for fp16 experiments)
    fp16: bool = False
    fp16_scale_window: int = 512
    min_loss_scale: float = 1e-4


@dataclass
class CheckpointConfig:
    save_dir: str = "checkpoints"
    restore_file: str = ""
    # start a fresh run (fresh optimizer, meters and dataloader) from these
    # weights; exclusive with the reset flags
    finetune_from_model: str = ""
    reset_optimizer: bool = False
    reset_dataloader: bool = False
    reset_meters: bool = False
    save_interval: int = 1
    # mid-epoch checkpoints every N updates (0 = off), with the iterator's
    # cursor, so a resume goes on inside the epoch
    save_interval_updates: int = 0
    validate_interval: int = 1
    keep_last_epochs: int = 1
    keep_best_checkpoints: int = 1
    # rotation of the --save-interval-updates checkpoints (-1 = keep all)
    keep_interval_updates: int = -1
    best_checkpoint_metric: str = "mIoU"
    maximize_best_checkpoint_metric: bool = True
    # end training after this many validations in a row without a better
    # best metric (0 = off)
    patience: int = 0
    no_save: bool = False
    # an absent --restore-file is fabricated with ofa_base.pt's shapes and
    # random weights, and loaded through the whole .pt loader
    dry_weights: bool = False


@dataclass
class DistributedConfig:
    """The JAX package's mesh and process layout (data, fsdp, tensor,
    pipeline, context and expert parallelism, ZeRO-1, the processes), all
    honoured (``parallel/``)."""

    data_parallel: int = -1
    tensor_parallel: int = 1
    fsdp: int = 1
    pipeline_parallel: int = 1
    pipeline_chunks: int = 0
    context_parallel: int = 1
    moe_experts: int = 0
    moe_freq: int = 2
    moe_assignment: str = "sinkhorn"
    zero1: bool = False
    coordinator_address: Optional[str] = None
    num_processes: int = 1
    process_id: int = 0


@dataclass
class CommonConfig:
    log_interval: int = 10
    log_format: str = "simple"  # simple | json
    log_file: Optional[str] = None  # parsed, never read (as in JAX)
    # parsed; a non-empty value raises (utils/progress.py, ROADMAP.md A.10)
    tensorboard_logdir: Optional[str] = None
    wandb_project: Optional[str] = None
    profile: bool = False  # parsed, never read (as in JAX)
    ema_decay: float = 0.0  # 0 disables EMA
    ema_fp32: bool = False
    # the cross-process sanitizers of the training CLI (utils/reliability.py):
    # the gradient norms compared across processes at each log, and the
    # parameter fingerprints every N updates (0 = never)
    check_grad_consistency: bool = True
    check_param_sync_interval: int = 0
    # abort after this many updates in a row skipped for a non-finite gradient
    max_consecutive_nonfinite: int = 10


@dataclass
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    task: TaskConfig = field(default_factory=TaskConfig)
    criterion: CriterionConfig = field(default_factory=CriterionConfig)
    optimization: OptimizationConfig = field(default_factory=OptimizationConfig)
    checkpoint: CheckpointConfig = field(default_factory=CheckpointConfig)
    distributed: DistributedConfig = field(default_factory=DistributedConfig)
    common: CommonConfig = field(default_factory=CommonConfig)

    def replace(self, **kwargs) -> "Config":
        return dataclasses.replace(self, **kwargs)


# flag name -> (section, field), built on first use
_FLAG_SECTIONS = None


def _flag_index():
    global _FLAG_SECTIONS
    if _FLAG_SECTIONS is None:
        idx = {}
        for section in dataclasses.fields(Config):
            sub = section.default_factory()
            for f in dataclasses.fields(sub):
                idx.setdefault(f.name, (section.name, f))
        _FLAG_SECTIONS = idx
    return _FLAG_SECTIONS


def load_config_file(path: str) -> List[str]:
    """A JSON config file holding {"flag-name": value, ...} expanded into the
    same flag strings ``from_flags`` parses."""
    with open(path) as fp:
        blob = json.load(fp)
    argv = []
    for k, v in blob.items():
        if k == "data":
            argv.append(str(v))
        else:
            argv.append(f"--{k}={v}")
    return argv


def from_flags(argv: List[str], arch: Optional[str] = None) -> Config:
    """Build a Config from reference-style ``--flag-name=value`` strings.

    A positional (non ``--``) argument is the data path, as in the reference
    CLI; ``--config=file.json`` expands a JSON flag file in place; a flag
    that names no field is ignored, as in the JAX package; a flag the port
    does not honour yet raises (see the module docstring).  ``num_seg_tokens``, ``patch_image_size``
    and ``orig_patch_image_size`` are kept equal in the model and the task
    sections, whichever section the flag filled.
    """
    expanded = []
    for tok in argv:
        if tok.startswith("--config="):
            expanded.extend(load_config_file(tok.split("=", 1)[1]))
        else:
            expanded.append(tok)
    cfg = Config()
    if arch:
        cfg = cfg.replace(model=model_config_for_arch(arch))
    overrides = {}
    for tok in expanded:
        if not tok.startswith("--"):
            overrides.setdefault("task", {})["data"] = tok
            continue
        body = tok[2:]
        if "=" in body:
            name, value = body.split("=", 1)
        else:
            name, value = body, "true"
        name = name.replace("-", "_")
        if name == "arch":
            cfg = cfg.replace(model=model_config_for_arch(value))
            continue
        idx = _flag_index()
        if name not in idx:
            continue
        section_name, f = idx[name]
        ftype = f.type
        if ftype in ("bool", bool):
            v = _str2bool(value)
        elif ftype in ("int", int):
            v = int(value)
        elif ftype in ("float", float):
            v = float(value)
        elif "Tuple" in str(ftype):
            v = tuple(json.loads(value.replace("(", "[").replace(")", "]")))
        else:
            v = value
        overrides.setdefault(section_name, {})[f.name] = v

    for section_name, values in overrides.items():
        sub = getattr(cfg, section_name)
        cfg = cfg.replace(**{section_name: dataclasses.replace(sub, **values)})

    # the leaves the reference keeps in both the model and the task section
    for leaf in ("num_seg_tokens", "patch_image_size", "orig_patch_image_size"):
        src = overrides.get("model", {}).get(leaf, overrides.get("task", {}).get(leaf))
        if src is not None:
            cfg = cfg.replace(
                model=dataclasses.replace(cfg.model, **{leaf: src}),
                task=dataclasses.replace(cfg.task, **{leaf: src}),
            )
    return cfg
