"""The port's own copy of the configuration fields the serving slice reads.

Names and defaults follow ``evoke_tpu/core/config.py`` (``DecodeConfig`` in
full; ``ModelConfig`` only the fields the model construction reads). The port
imports nothing of ``evoke_tpu``, so these dataclasses are copies, not
re-exports; the parity tests assert the defaults still agree.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass
class ModelConfig:
    """Model dims (reference: config/finetune_config.yaml:14-66)."""

    visual_encoder: str = "resnet101"           # resnet101 (vit_b32 not ported yet)
    image_size: int = 224
    d_vf: int = 2048

    encoder_hidden_size: int = 768
    encoder_num_hidden_layers: int = 6
    encoder_num_heads: int = 12
    encoder_intermediate_size: int = 3072

    fusion_num_heads: int = 8
    sk_fusion_num_layers: int = 1
    fusion_intermediate_size: int = 2048

    text_decoder: str = "r2gen"                  # r2gen (cmn not ported yet)
    d_model: int = 512
    d_ff: int = 512
    num_heads: int = 8
    num_layers: int = 3
    dropout: float = 0.0
    drop_prob_lm: float = 0.5
    rm_num_slots: int = 3
    rm_num_heads: int = 8
    rm_d_model: int = 512

    output_dim: int = 2048
    proj_num_heads: int = 8
    fusion_wide_qkv: bool = True
    fusion_max_partners: Optional[int] = None

    is_multiview_learning: bool = True
    is_add_indication: bool = True

    dtype: str = "float32"


@dataclass
class DecodeConfig:
    """Report generation (reference: config/finetune_config.yaml:49-66).

    The port's slice runs ``sample_method="beam_search"`` with
    ``group_size=1``; every other decode setting raises NotImplementedError
    (ROADMAP A12). The continuous-engine fields are kept for the copy's
    completeness and are read by nothing yet (ROADMAP A9)."""

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
    kv_cache_dtype: str = ""                     # "" only (int8: ROADMAP A12)
    engine: str = "batch"
    slots: int = 64
    seg_steps: int = 10
    dispatch_segs: int = 4
    pack_batches: int = 4
    serve_dp: int = 0
