"""Typed configuration: the port's own copy of ``evoke_tpu/core/config.py``.

Every section, field name and default follows the JAX package (the port
imports nothing of ``evoke_tpu``; a parity test holds the copy to the
original). Precedence is the reference's: defaults <- YAML <- overrides <-
CLI argv, and an unknown argv key raises ``ValueError``. PyYAML is imported
only when a YAML file is given.

Fields the port does not run yet are kept so configs and argv stay
interchangeable; the code that reads them raises ``NotImplementedError``
naming its ROADMAP item (e.g. ``decode.engine=continuous``, A9).
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field, fields
from typing import Any, Dict, List, Optional


@dataclass
class ModelConfig:
    """Model dims (reference: config/finetune_config.yaml:14-66)."""

    # visual encoder
    visual_encoder: str = "resnet101"           # resnet101 (vit_b32: ROADMAP A12b)
    image_size: int = 224                        # 224 or 384
    visual_pool: str = "avg7"                    # avg7 (224 path) | mean (384 path)
    d_vf: int = 2048
    resnet_checkpoint: str = ""

    # text encoder (SciBERT-style)
    text_checkpoint: str = ""
    encoder_hidden_size: int = 768
    encoder_num_hidden_layers: int = 6
    encoder_num_heads: int = 12
    encoder_intermediate_size: int = 3072

    # fusion (BertCrossLayer co-attention over image/indication tokens)
    fusion_num_heads: int = 8
    sk_fusion_num_layers: int = 1
    fusion_intermediate_size: int = 2048

    # text decoder (R2Gen-style; cmn: ROADMAP A12b)
    text_decoder: str = "r2gen"
    d_model: int = 512
    d_ff: int = 512
    num_heads: int = 8
    num_layers: int = 3
    dropout: float = 0.0
    drop_prob_lm: float = 0.5
    logit_layers: int = 1
    use_bn: int = 0
    rm_num_slots: int = 3
    rm_num_heads: int = 8
    rm_d_model: int = 512
    topk: int = 32
    cmm_size: int = 2048
    cmm_dim: int = 512

    # projection heads / contrastive embedding
    output_dim: int = 2048
    proj_num_heads: int = 8
    fusion_wide_qkv: bool = True
    # None = dense masked fusion attention over the whole batch; an int G =
    # grouped partner-gather attention over (1+G)*T keys (models/fusion.py)
    fusion_max_partners: Optional[int] = None
    remat_visual: bool = False                   # training only (ROADMAP A10)

    is_multiview_learning: bool = True
    is_add_indication: bool = True

    dtype: str = "float32"                       # float32 | bfloat16


@dataclass
class DecodeConfig:
    """Report generation (reference: config/finetune_config.yaml:49-66).

    The port runs ``sample_method="beam_search"`` with ``group_size=1``; every
    other decode setting raises NotImplementedError (ROADMAP A12a). The
    continuous-engine fields are read by nothing yet (ROADMAP A9)."""

    sample_method: str = "beam_search"
    beam_size: int = 3
    top_k: int = 0
    top_p: float = 0.0
    length_penalty: str = ""                     # "" | "wu_X" | "avg_X"
    diversity_lambda: float = 0.5
    suppress_unk: bool = False
    temperature: float = 1.0
    group_size: int = 1
    sample_n: int = 1
    output_logsoftmax: bool = True
    decoding_constraint: bool = False
    block_trigrams: bool = True
    # 0 = auto: 1 on eval paths, 8 on the serving path (train/steps.py)
    cache_phases: int = 0
    beam_kv: str = "auto"                        # auto | reorder | ancestor
    kv_cache_dtype: str = ""                     # "" only (int8: ROADMAP A12a)
    engine: str = "batch"                        # batch (continuous: ROADMAP A9)
    slots: int = 64
    seg_steps: int = 10
    dispatch_segs: int = 4
    pack_batches: int = 4
    serve_dp: int = 0                            # 0 only (multi-GPU: ROADMAP A13)


@dataclass
class LossConfig:
    instance_temp: float = 0.5
    region_temp: float = 0.5
    pretrain_loss: str = "all"
    mul_pos_formulation: str = "soft"
    mask_local_pad: bool = True


@dataclass
class DataConfig:
    data_name: str = "mimic_cxr"
    ann_path: str = ""
    image_dir: str = ""
    tokenizer_dir: str = "config/tokenizer"
    tokenizer_model: str = "wordlevel"           # wordlevel | wordpiece
    tokenizer_type: str = "uncased"
    max_seq_len: int = 100
    align_type: str = "keywords"                 # keywords | report
    align_loss: str = "multi-level"
    batch_size: int = 32
    max_views: int = 4
    num_workers: int = 8
    prefetch: int = 2
    images_uint8: bool = True                    # ship uint8, normalise on the device
    retrieve_db_ann_path: str = ""
    retrieve_db_image_dir: str = ""
    retrieve_topk: int = 20
    retrieve_plot: int = 0


@dataclass
class OptimConfig:
    optim: str = "RAdam"
    lr_scheduler: str = "ReduceLROnPlateau"
    pt_lr: float = 5.0e-6
    ft_lr: float = 5.0e-5
    lr: float = 5.0e-5
    weight_decay: float = 1.0e-4
    amsgrad: bool = True
    step_size: int = 10
    gamma: float = 0.5
    grad_clip_value: float = 0.1
    grad_accum_steps: int = 1


@dataclass
class TrainerConfig:
    task: str = "finetune"
    epochs: int = 50
    seed: int = 9233
    result_dir: str = "results"
    version: str = "v1"
    save_period: int = 1
    early_stop: int = 10
    async_checkpoint: bool = True
    resume: str = ""
    load: str = ""
    n_devices: int = 0
    pt_monitor_mode: str = "min"
    pt_monitor_metric: str = "all_loss"
    pt_lr_monitor_metric: str = "all_loss"
    ft_monitor_mode: str = "max"
    ft_monitor_metric: str = "RCB"
    ft_lr_monitor_metric: str = "F1-Radgraph-partial"
    test_every: int = 5
    log_interval: int = 100
    profile_epoch: int = 0
    profile_dir: str = ""
    plot_heatmaps: int = 0                       # > 0: ROADMAP A12b


@dataclass
class MetricsConfig:
    chexbert_checkpoint: str = ""
    chexbert_model_checkpoint: str = ""
    chexbert_tokenizer_checkpoint: str = ""
    radgraph_checkpoint: str = ""
    bertscore_checkpoint: str = ""
    green_checkpoint: str = ""
    nli_checkpoint: str = ""
    radgraph_reward_level: str = "partial"


@dataclass
class EvokeConfig:
    model: ModelConfig = field(default_factory=ModelConfig)
    decode: DecodeConfig = field(default_factory=DecodeConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    data: DataConfig = field(default_factory=DataConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    trainer: TrainerConfig = field(default_factory=TrainerConfig)
    metrics: MetricsConfig = field(default_factory=MetricsConfig)
    vocab_size: int = 0                          # filled at run time

    @property
    def result_dir(self) -> str:
        return os.path.join(self.trainer.result_dir, self.data.data_name,
                            self.trainer.task, self.trainer.version)

    @property
    def monitor_mode(self) -> str:
        if self.trainer.task in ("pretrain", "pretrain_inference"):
            return self.trainer.pt_monitor_mode
        return self.trainer.ft_monitor_mode

    @property
    def monitor_metric(self) -> str:
        if self.trainer.task in ("pretrain", "pretrain_inference"):
            return self.trainer.pt_monitor_metric
        return self.trainer.ft_monitor_metric

    @property
    def lr_monitor_metric(self) -> str:
        if self.trainer.task in ("pretrain", "pretrain_inference"):
            return self.trainer.pt_lr_monitor_metric
        return self.trainer.ft_lr_monitor_metric

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def save(self, path: str) -> None:
        """``config.json`` of a run, byte for byte as the JAX package writes it."""
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2)


_SECTIONS = {f.name for f in fields(EvokeConfig)
             if dataclasses.is_dataclass(getattr(EvokeConfig(), f.name))}


def _apply_overrides(cfg: EvokeConfig, flat: Dict[str, Any]) -> List[str]:
    """Apply ``section.key`` or bare ``key`` overrides; returns unknown keys."""
    unknown = []
    for key, value in flat.items():
        if value is None:
            continue
        if "." in key:
            sec_name, attr = key.split(".", 1)
            sec = getattr(cfg, sec_name, None)
            if sec is not None and hasattr(sec, attr):
                setattr(sec, attr, _coerce(type(getattr(sec, attr)), value))
                continue
            unknown.append(key)
            continue
        # bare key: the first section (in declaration order) that has it
        placed = False
        if hasattr(cfg, key) and not dataclasses.is_dataclass(getattr(cfg, key)):
            setattr(cfg, key, _coerce(type(getattr(cfg, key)), value))
            placed = True
        else:
            for f in fields(cfg):
                sec = getattr(cfg, f.name)
                if dataclasses.is_dataclass(sec) and hasattr(sec, key):
                    setattr(sec, key, _coerce(type(getattr(sec, key)), value))
                    placed = True
                    break
        if not placed:
            unknown.append(key)
    return unknown


def _coerce(typ, value):
    if typ is bool and isinstance(value, str):
        return value.lower() in ("1", "true", "yes", "y", "t")
    if typ in (int, float, str) and not isinstance(value, typ):
        return typ(value)
    return value


def load_config(yaml_path: Optional[str] = None,
                overrides: Optional[Dict[str, Any]] = None,
                argv: Optional[List[str]] = None) -> EvokeConfig:
    """Build an EvokeConfig: defaults <- YAML <- overrides <- CLI argv.

    YAML may be flat or nested by section. CLI args are ``--section.key
    value``, ``--key value``, ``--key=value`` or a bare ``--flag`` (true)."""
    cfg = EvokeConfig()
    if yaml_path:
        import yaml

        with open(yaml_path) as f:
            raw = yaml.safe_load(f) or {}
        flat: Dict[str, Any] = {}
        for k, v in raw.items():
            if isinstance(v, dict) and k in _SECTIONS:
                for kk, vv in v.items():
                    flat[f"{k}.{kk}"] = vv
            else:
                flat[k] = v
        _apply_overrides(cfg, flat)
    if overrides:
        _apply_overrides(cfg, dict(overrides))
    if argv:
        flat = {}
        i = 0
        while i < len(argv):
            tok = argv[i]
            if tok.startswith("--"):
                key = tok[2:]
                if "=" in key:
                    key, val = key.split("=", 1)
                    flat[key] = val
                    i += 1
                elif i + 1 < len(argv) and not argv[i + 1].startswith("--"):
                    flat[key] = argv[i + 1]
                    i += 2
                else:
                    flat[key] = "true"
                    i += 1
            else:
                i += 1
        unknown = _apply_overrides(cfg, flat)
        if unknown:
            raise ValueError(f"Unknown config keys: {unknown}")
    return cfg
