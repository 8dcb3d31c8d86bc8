"""Configuration of the port: the model, and what the training step reads.

Copies of the fields of the JAX package's ``ModelConfig``,
``CriterionConfig``, ``OptimizationConfig``, ``CommonConfig`` and
``TaskConfig`` that the served forward and the training step read, with the
same names and defaults, so one set of keyword arguments builds both.
"""

from dataclasses import dataclass, field
from typing import Tuple


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

    # "gelu_tanh" (default), "gelu"/"gelu_exact" (erf form) or "relu"
    activation_fn: str = "gelu_tanh"
    dropout: float = 0.1
    attention_dropout: float = 0.0
    activation_dropout: float = 0.0
    encoder_drop_path_rate: float = 0.1
    decoder_drop_path_rate: float = 0.1
    # LayerDrop: whole layers skipped iid during training
    encoder_layerdrop: float = 0.0
    decoder_layerdrop: float = 0.0

    layernorm_embedding: bool = True
    patch_layernorm_embedding: bool = True
    add_type_embedding: bool = True
    scale_attn: bool = True
    scale_fc: bool = True
    scale_heads: bool = True
    scale_resids: bool = False
    attn_scale_factor: float = 2.0

    token_bucket_size: int = 256
    image_bucket_size: int = 42
    max_source_positions: int = 1024
    max_target_positions: int = 1024

    patch_image_size: int = 512
    orig_patch_image_size: int = 512

    # adapters are not on the served path of this package; True raises
    adapter: bool = False

    num_seg_tokens: int = 150
    decoder_input_type: str = "encoder_output"  # encoder_input | encoder_output
    tie_seg_projection: bool = True

    # freezing policy of the reference run scripts
    freeze_encoder_embedding: bool = True
    freeze_decoder_embedding: bool = True
    freeze_seg_embedding: bool = True
    freeze_entire_resnet: bool = True
    freeze_resnet: bool = False
    freeze_encoder_transformer: bool = False
    freeze_encoder_transformer_layers: int = 0

    dtype: str = "bfloat16"  # compute dtype; params are always fp32

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
    """The segmentation task's field that the training step reads."""

    imagenet_default_mean_and_std: bool = False


@dataclass
class CriterionConfig:
    """Seg criterion (criterions/seg_criterion.py)."""

    label_smoothing: float = 0.0
    unsupervised_segmentation: bool = True
    full_context_alignment: bool = False
    init_seg_with_text: bool = True
    # the reference runs an inference-mode forward on the real batch every
    # step purely for monitoring metrics; off trains faster with identical
    # learning dynamics
    monitor_real_batch: bool = True


@dataclass
class OptimizationConfig:
    lr: float = 5e-5
    optimizer: str = "adam"  # only adam is ported
    lr_scheduler: str = "cosine"  # only cosine is ported
    warmup_ratio: float = 0.0
    warmup_updates: int = 0
    weight_decay: float = 0.1
    adam_betas: Tuple[float, float] = (0.9, 0.999)
    adam_eps: float = 1e-8
    clip_norm: float = 1.0
    update_freq: int = 1
    seed: int = 7


@dataclass
class CommonConfig:
    ema_decay: float = 0.0  # 0 disables EMA
    ema_fp32: bool = False


@dataclass
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    task: TaskConfig = field(default_factory=TaskConfig)
    criterion: CriterionConfig = field(default_factory=CriterionConfig)
    optimization: OptimizationConfig = field(default_factory=OptimizationConfig)
    common: CommonConfig = field(default_factory=CommonConfig)
