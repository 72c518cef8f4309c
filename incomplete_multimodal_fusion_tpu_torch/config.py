"""Typed configuration, field for field the JAX package's ``config.py``.

The dataclasses, their fields, defaults, ``MODEL_SIZES`` and the YAML keys
are the same as in ``incomplete_multimodal_fusion_tpu.config``, so one YAML
file drives both packages. Fields that only the JAX package reads (mesh axes,
optimizer fusion, KV-grid assembly) are kept so such a file loads here too.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    """Encoder hyper-parameters (reference multimae_crossattn.py:548-599)."""

    dim_tokens: int = 192
    depth: int = 12
    dim_head: int = 64
    heads: int = 3
    ff_mult: int = 4
    num_fusion_tokens: int = 256
    drop_path_rate: float = 0.0
    # 'crossattn' = per-layer fusion blocks (flagship; the only mode ported)
    # 'zorro' | 'lstm' | 'crossattn_v1' | 'sup' exist in the JAX package
    fusion_mode: str = "crossattn"
    # 'auto' = hand-written kernels for CUDA tensors, plain PyTorch for CPU
    # tensors; 'xla' = plain PyTorch everywhere; 'pallas' = same as 'auto'
    attn_impl: str = "auto"
    # JAX-only: how the fusion blocks assemble their KV grid. The port always
    # gathers (same values as the one-hot matmul)
    kv_assembly: str = "onehot"


@dataclass(frozen=True)
class DataConfig:
    input_size: int = 256
    patch_size: int = 16
    in_domains: Tuple[str, ...] = ("s1", "s2", "dem")
    out_domains: Tuple[str, ...] = ("s1", "s2", "dem")
    data_path: str = ""
    batch_size: int = 60  # per replica, reference pretrain_mmae.py:79

    @property
    def num_patches(self) -> int:
        n = self.input_size // self.patch_size
        return n * n


@dataclass(frozen=True)
class MaskConfig:
    """Dirichlet token-budget masking (reference multimae_crossattn.py:205-278)."""

    num_encoded_tokens: int = 384
    alphas: float = 1.0
    sample_tasks_uniformly: bool = False


@dataclass(frozen=True)
class DecoderConfig:
    """Reconstruction decoder (reference output_adapters_simple.py:33-188)."""

    dim: int = 256
    depth: int = 2
    num_heads: int = 8
    use_task_queries: bool = True
    use_xattn: bool = True
    style: str = "simple"  # 'simple' | 'full' (only 'simple' is ported)
    # run the decoder trunk once for all tasks: MultiMAE(decoder_batch_tasks=...)
    # routes the output adapters through adapters.batched_trunks (K1 over the
    # tasks' rows, K2's MLP with a task axis)
    batch_tasks: bool = False


@dataclass(frozen=True)
class OptimConfig:
    opt: str = "adamw"
    blr: float = 1e-4  # absolute lr = blr * total_batch / 256 (pretrain_mmae.py:335)
    warmup_lr: float = 1e-6
    min_lr: float = 0.0
    warmup_epochs: int = 40
    weight_decay: float = 0.05
    weight_decay_end: Optional[float] = None
    opt_betas: Tuple[float, float] = (0.9, 0.95)
    opt_eps: float = 1e-8
    clip_grad: Optional[float] = None
    skip_grad: Optional[float] = None
    task_balancer: str = "none"  # 'none' | 'uncertainty'
    balancer_lr_scale: float = 1.0
    fused_adamw: bool = True


@dataclass(frozen=True)
class TrainConfig:
    epochs: int = 800
    save_ckpt_freq: int = 20
    seed: int = 0
    output_dir: str = "./save_attention"
    contra_weight: float = 0.3  # pretrain_mmae.py:500
    loss_on_unmasked: bool = False
    compute_dtype: str = "bfloat16"  # 'float32' for parity tests
    patch_space_losses: bool = True
    use_ema: bool = False  # model EMA (reference model_ema.py, unwired there)
    ema_decay: float = 0.9999
    mesh_shape: Tuple[int, ...] = (-1,)
    mesh_axes: Tuple[str, ...] = ("data",)


@dataclass(frozen=True)
class PretrainConfig:
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    mask: MaskConfig = field(default_factory=MaskConfig)
    decoder: DecoderConfig = field(default_factory=DecoderConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    train: TrainConfig = field(default_factory=TrainConfig)


# Named model sizes (reference multimae_crossattn.py:548-599). The two
# '*_tpu' geometries re-head the reference sizes (dh 128); they are not
# checkpoint-compatible with the reference's own sizes.
MODEL_SIZES: Dict[str, ModelConfig] = {
    "tiny": ModelConfig(dim_tokens=192, depth=12, dim_head=64, heads=3),
    "base": ModelConfig(dim_tokens=768, depth=12, dim_head=64, heads=8),
    "large": ModelConfig(dim_tokens=1024, depth=24, dim_head=64, heads=8),
    "tiny_tpu": ModelConfig(dim_tokens=256, depth=12, dim_head=128, heads=2),
    "base_tpu": ModelConfig(dim_tokens=768, depth=12, dim_head=128, heads=6),
}


def _to_dict(cfg: Any) -> Any:
    if dataclasses.is_dataclass(cfg):
        return {f.name: _to_dict(getattr(cfg, f.name)) for f in dataclasses.fields(cfg)}
    if isinstance(cfg, tuple):
        return list(cfg)
    return cfg


def _from_dict(cls, d: Dict[str, Any]):
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        v = d[f.name]
        if isinstance(v, list):
            v = tuple(v)
        kwargs[f.name] = v
    return cls(**kwargs)


def to_yaml(cfg: PretrainConfig) -> str:
    import yaml

    return yaml.safe_dump(_to_dict(cfg), sort_keys=False)


def from_yaml(text: str) -> PretrainConfig:
    import yaml

    d = yaml.safe_load(text) or {}
    sub = {
        "model": ModelConfig,
        "data": DataConfig,
        "mask": MaskConfig,
        "decoder": DecoderConfig,
        "optim": OptimConfig,
        "train": TrainConfig,
    }
    kwargs = {k: _from_dict(cls, d[k]) for k, cls in sub.items() if k in d}
    return PretrainConfig(**kwargs)
