"""EVOKE's released FineTune checkpoint layout, fabricated from a seed.

EVOKE's ``model_best.pth`` is a ``{"state_dict": ...}`` dict of the FineTune
model's tensors (models/model_pretrain_finetune_v0425_ablation.py:23-231):

- ``visual_extractor.model.{0,1,4..7}``: torchvision ResNet-101's children in
  an ``nn.Sequential`` (conv1, bn1, layer1..layer4; modules/visual_extractor.py);
- ``text_encoder.encoder.``: an HF BertModel (embeddings, encoder.layer.{i},
  pooler);
- ``layer_norm_1`` / ``layer_norm_2`` and ``multiview_cross_attention.fc_{q,k,v,o}``
  (wide q / k / v: ``heads x d_vf`` columns; modules/utils_v0511.py:210-281);
- ``visual_head.head`` / ``text_head.head``: Conv1d(k=1) -> BN -> ReLU ->
  Conv1d(k=1) -> BN(affine=False) (utils_v0511.py:171-209);
- ``multimodal_fusion_layers.{i}`` (BertCrossLayer) and
  ``visual_self_atten_layers.{i}`` (BertLayer) in HF key names;
- ``text_decoder.``: R2Gen's EncoderDecoder (``att_embed.0``,
  ``model.encoder`` / ``model.decoder`` layers of ``linears.{0..3}``
  attention, ``sublayer.{j}.norm`` (conditional on the decoder side),
  ``feed_forward.w_{1,2}``, ``model.tgt_embed.0.lut``, ``model.rm``) and
  ``logit``.

Every BatchNorm carries its ``num_batches_tracked`` counter. The released
checkpoints cannot be fetched, so the tests and ``chip_smoke.py`` build one
with ``finetune_state_dict`` from a seed. ``evoke_to_port_key`` is a second
map from these keys to the port's, written as rewrite rules independently of
``torch_import.py``, so an import can be checked tensor by tensor.
"""

from __future__ import annotations

import re
from typing import Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

# the decoder's logit head is drawn this much wider than 1/sqrt(fan_in), so
# random weights give peaked, varied tokens instead of one repeated word
LOGIT_SCALE = 4.0


def _bn(name: str, c: int, affine: bool = True) -> Iterator[Tuple[str, Tuple[int, ...]]]:
    if affine:
        yield f"{name}.weight", (c,)
        yield f"{name}.bias", (c,)
    yield f"{name}.running_mean", (c,)
    yield f"{name}.running_var", (c,)
    yield f"{name}.num_batches_tracked", ()


def _linear(name: str, out: int, inp: int) -> Iterator[Tuple[str, Tuple[int, ...]]]:
    yield f"{name}.weight", (out, inp)
    yield f"{name}.bias", (out,)


def _ln(name: str, c: int, gamma: bool = False) -> Iterator[Tuple[str, Tuple[int, ...]]]:
    a, b = ("gamma", "beta") if gamma else ("weight", "bias")
    yield f"{name}.{a}", (c,)
    yield f"{name}.{b}", (c,)


def _hf_attention(name: str, h: int) -> Iterator[Tuple[str, Tuple[int, ...]]]:
    for p in ("query", "key", "value"):
        yield from _linear(f"{name}.self.{p}", h, h)
    yield from _linear(f"{name}.output.dense", h, h)
    yield from _ln(f"{name}.output.LayerNorm", h)


def _hf_layer(name: str, h: int, inter: int, cross: bool
              ) -> Iterator[Tuple[str, Tuple[int, ...]]]:
    yield from _hf_attention(f"{name}.attention", h)
    if cross:
        yield from _hf_attention(f"{name}.crossattention", h)
    yield from _linear(f"{name}.intermediate.dense", inter, h)
    yield from _linear(f"{name}.output.dense", h, inter)
    yield from _ln(f"{name}.output.LayerNorm", h)


def _mha(name: str, d: int) -> Iterator[Tuple[str, Tuple[int, ...]]]:
    for i in range(4):
        yield from _linear(f"{name}.linears.{i}", d, d)


def finetune_layout(vocab_size: int, *, d_vf: int = 2048, output_dim: int = 2048,
                    encoder_hidden_size: int = 768, encoder_num_layers: int = 6,
                    encoder_intermediate_size: int = 3072, max_positions: int = 512,
                    proj_num_heads: int = 8, fusion_intermediate_size: int = 3072,
                    sk_fusion_num_layers: int = 1, d_model: int = 512, d_ff: int = 512,
                    num_layers: int = 3, rm_num_slots: int = 3,
                    stage_sizes: Sequence[int] = (3, 4, 23, 3)
                    ) -> Iterator[Tuple[str, Tuple[int, ...]]]:
    """(key, shape) of every tensor of an EVOKE FineTune checkpoint, in
    module order; the arguments are ``FinetuneModel``'s (wide q / k / v)."""
    vx = "visual_extractor.model"
    yield f"{vx}.0.weight", (64, 3, 7, 7)
    yield from _bn(f"{vx}.1", 64)
    in_c = 64
    for s, n in enumerate(stage_sizes):
        feats = 64 * 2 ** s
        for i in range(n):
            p = f"{vx}.{4 + s}.{i}"
            yield f"{p}.conv1.weight", (feats, in_c if i == 0 else feats * 4, 1, 1)
            yield from _bn(f"{p}.bn1", feats)
            yield f"{p}.conv2.weight", (feats, feats, 3, 3)
            yield from _bn(f"{p}.bn2", feats)
            yield f"{p}.conv3.weight", (feats * 4, feats, 1, 1)
            yield from _bn(f"{p}.bn3", feats * 4)
            if i == 0:
                yield f"{p}.downsample.0.weight", (feats * 4, in_c, 1, 1)
                yield from _bn(f"{p}.downsample.1", feats * 4)
        in_c = feats * 4

    te, h = "text_encoder.encoder", encoder_hidden_size
    yield f"{te}.embeddings.word_embeddings.weight", (vocab_size, h)
    yield f"{te}.embeddings.position_embeddings.weight", (max_positions, h)
    yield f"{te}.embeddings.token_type_embeddings.weight", (2, h)
    yield from _ln(f"{te}.embeddings.LayerNorm", h)
    for i in range(encoder_num_layers):
        yield from _hf_layer(f"{te}.encoder.layer.{i}", h, encoder_intermediate_size, False)
    yield from _linear(f"{te}.pooler.dense", h, h)

    yield from _ln("layer_norm_1", d_vf)
    yield from _ln("layer_norm_2", d_vf)
    wide = d_vf * proj_num_heads
    for fc in ("fc_q", "fc_k", "fc_v"):
        yield from _linear(f"multiview_cross_attention.{fc}", wide, d_vf)
    yield from _linear("multiview_cross_attention.fc_o", d_vf, wide)

    for head, inp in (("visual_head", d_vf), ("text_head", h)):
        yield f"{head}.head.0.weight", (output_dim, inp, 1)
        yield f"{head}.head.0.bias", (output_dim,)
        yield from _bn(f"{head}.head.1", output_dim)
        yield f"{head}.head.3.weight", (output_dim, output_dim, 1)
        yield f"{head}.head.3.bias", (output_dim,)
        yield from _bn(f"{head}.head.4", output_dim, affine=False)

    for i in range(sk_fusion_num_layers):
        yield from _hf_layer(f"multimodal_fusion_layers.{i}", output_dim,
                             fusion_intermediate_size, True)
    for i in range(sk_fusion_num_layers):
        yield from _hf_layer(f"visual_self_atten_layers.{i}", output_dim,
                             fusion_intermediate_size, False)

    td, mem = "text_decoder", rm_num_slots * d_model
    yield from _linear(f"{td}.att_embed.0", d_model, output_dim)
    for i in range(num_layers):
        b = f"{td}.model.encoder.layers.{i}"
        yield from _mha(f"{b}.self_attn", d_model)
        yield from _linear(f"{b}.feed_forward.w_1", d_ff, d_model)
        yield from _linear(f"{b}.feed_forward.w_2", d_model, d_ff)
        for j in range(2):
            yield from _ln(f"{b}.sublayer.{j}.norm", d_model, gamma=True)
    yield from _ln(f"{td}.model.encoder.norm", d_model, gamma=True)
    for i in range(num_layers):
        b = f"{td}.model.decoder.layers.{i}"
        yield from _mha(f"{b}.self_attn", d_model)
        yield from _mha(f"{b}.src_attn", d_model)
        yield from _linear(f"{b}.feed_forward.w_1", d_ff, d_model)
        yield from _linear(f"{b}.feed_forward.w_2", d_model, d_ff)
        for j in range(3):
            n = f"{b}.sublayer.{j}.norm"
            yield from _ln(n, d_model, gamma=True)
            for mlp in ("mlp_gamma", "mlp_beta"):
                yield from _linear(f"{n}.{mlp}.0", d_model, mem)
                yield from _linear(f"{n}.{mlp}.2", d_model, d_model)
    yield from _ln(f"{td}.model.decoder.norm", d_model, gamma=True)
    yield f"{td}.model.tgt_embed.0.lut.weight", (vocab_size + 1, d_model)
    yield from _mha(f"{td}.model.rm.attn", d_model)
    yield from _linear(f"{td}.model.rm.mlp.0", d_model, d_model)
    yield from _linear(f"{td}.model.rm.mlp.2", d_model, d_model)
    yield from _linear(f"{td}.model.rm.W", 2 * d_model, d_model)
    yield from _linear(f"{td}.model.rm.U", 2 * d_model, d_model)
    yield from _linear(f"{td}.logit", vocab_size + 1, d_model)


def finetune_state_dict(seed: int, vocab_size: int, **dims) -> Dict[str, torch.Tensor]:
    """A float32 EVOKE FineTune state dict (``finetune_layout``'s keys and
    shapes) with values from ``np.random.default_rng(seed)`` in key order:
    weights ~ N(0, 1/fan_in) (the logit head ``LOGIT_SCALE`` wider), norm
    scales 1 + N(0, 0.1^2), biases and running means N(0, 0.05^2), running
    variances U(0.8, 1.2), ``num_batches_tracked`` a step count."""
    rng = np.random.default_rng(seed)
    out: Dict[str, torch.Tensor] = {}
    for key, shape in finetune_layout(vocab_size, **dims):
        leaf = key.rsplit(".", 1)[-1]
        if leaf == "num_batches_tracked":
            out[key] = torch.tensor(int(rng.integers(1, 10 ** 6)), dtype=torch.int64)
            continue
        if len(shape) >= 2:
            scale = float(np.prod(shape[1:])) ** -0.5
            if key.endswith("text_decoder.logit.weight"):
                scale *= LOGIT_SCALE
            v = rng.standard_normal(shape, np.float32) * np.float32(scale)
        elif leaf == "running_var":
            v = rng.uniform(0.8, 1.2, shape).astype(np.float32)
        elif leaf in ("weight", "gamma"):
            v = 1 + rng.standard_normal(shape, np.float32) * np.float32(0.1)
        else:
            v = rng.standard_normal(shape, np.float32) * np.float32(0.05)
        out[key] = torch.from_numpy(v)
    return out


# ---- the second map: EVOKE key -> (port key, squeeze the trailing k=1 axis) ----

_HF_TAIL = (("attention.self.query.", "attention.wq."), ("attention.self.key.", "attention.wk."),
            ("attention.self.value.", "attention.wv."),
            ("attention.output.dense.", "attention.out.Dense_0."),
            ("attention.output.LayerNorm.", "attention.out.LayerNorm_0."),
            ("intermediate.dense.", "ffn.Dense_0."),
            ("output.dense.", "ffn.BertSelfOutput_0.Dense_0."),
            ("output.LayerNorm.", "ffn.BertSelfOutput_0.LayerNorm_0."))
_LINEARS = ("wq", "wk", "wv", "wo")


def _hf_tail(tail: str) -> str:
    cross = tail.startswith("crossattention.")
    t = tail[len("cross"):] if cross else tail
    for a, b in _HF_TAIL:
        if t.startswith(a):
            return ("cross" if cross else "") + b + t[len(a):]
    raise KeyError(tail)


def _r2gen(k: str) -> str:
    m = re.fullmatch(r"att_embed\.0\.(\w+)", k)
    if m:
        return f"att_embed.{m[1]}"
    m = re.fullmatch(r"model\.(encoder|decoder)\.layers\.(\d+)\.(.*)", k)
    if m:
        side, i, rest = m[1][:3], m[2], m[3]
        m2 = re.fullmatch(r"(self_attn|src_attn)\.linears\.(\d)\.(\w+)", rest)
        if m2:
            return f"{side}_{i}.{m2[1]}.{_LINEARS[int(m2[2])]}.{m2[3]}"
        m2 = re.fullmatch(r"feed_forward\.w_([12])\.(\w+)", rest)
        if m2:
            return f"{side}_{i}.ff.Dense_{int(m2[1]) - 1}.{m2[2]}"
        m2 = re.fullmatch(r"sublayer\.(\d)\.norm\.(gamma|beta)", rest)
        if m2:
            norm = "norm" if side == "enc" else "cln"
            return f"{side}_{i}.{norm}{int(m2[1]) + 1}.{m2[2]}"
        m2 = re.fullmatch(r"sublayer\.(\d)\.norm\.(mlp_gamma|mlp_beta)\.([02])\.(\w+)", rest)
        if m2:
            return f"{side}_{i}.cln{int(m2[1]) + 1}.{m2[2]}_{int(m2[3]) // 2}.{m2[4]}"
        raise KeyError(k)
    m = re.fullmatch(r"model\.(encoder|decoder)\.norm\.(gamma|beta)", k)
    if m:
        return f"{m[1][:3]}_norm.{m[2]}"
    if k == "model.tgt_embed.0.lut.weight":
        return "tgt_embed.lut.weight"
    m = re.fullmatch(r"model\.rm\.attn\.linears\.(\d)\.(\w+)", k)
    if m:
        return f"rm.attn.{_LINEARS[int(m[1])]}.{m[2]}"
    m = re.fullmatch(r"model\.rm\.mlp\.([02])\.(\w+)", k)
    if m:
        return f"rm.mlp{int(m[1]) // 2 + 1}.{m[2]}"
    m = re.fullmatch(r"model\.rm\.([WU])\.(\w+)", k)
    if m:
        return f"rm.{m[1]}.{m[2]}"
    m = re.fullmatch(r"logit\.(\w+)", k)
    if m:
        return k
    raise KeyError(k)


def evoke_to_port_key(key: str) -> Optional[Tuple[str, bool]]:
    """The port ``FinetuneModel`` key an EVOKE FineTune key lands on, and
    whether its trailing Conv1d axis is squeezed; None for the tensors the
    port has no counterpart of (``num_batches_tracked``, BERT's pooler).
    Raises KeyError on a key outside the layout."""
    if key.endswith(".num_batches_tracked") or ".pooler." in key:
        return None
    m = re.fullmatch(r"visual_extractor\.model\.([0-9])\.(.*)", key)
    if m:
        idx, rest = int(m[1]), m[2]
        if idx in (0, 1):
            return f"visual_extractor.backbone.{('conv1', 'bn1')[idx]}.{rest}", False
        m2 = re.fullmatch(r"(\d+)\.downsample\.([01])\.(\w+)", rest)
        block = f"visual_extractor.backbone.layer{idx - 3}_{rest.split('.', 1)[0]}"
        if m2:
            return f"{block}.downsample_{('conv', 'bn')[int(m2[2])]}.{m2[3]}", False
        return f"{block}.{rest.split('.', 1)[1]}", False
    m = re.fullmatch(r"text_encoder\.encoder\.embeddings\.(.*)", key)
    if m:
        return "text_encoder.embeddings." + m[1].replace("LayerNorm.", "LayerNorm_0."), False
    m = re.fullmatch(r"text_encoder\.encoder\.encoder\.layer\.(\d+)\.(.*)", key)
    if m:
        return f"text_encoder.layer_{m[1]}.{_hf_tail(m[2])}", False
    m = re.fullmatch(r"(multimodal_fusion_layers|visual_self_atten_layers)\.(\d+)\.(.*)", key)
    if m:
        return f"{m[1]}_{m[2]}.{_hf_tail(m[3])}", False
    m = re.fullmatch(r"layer_norm_([12])\.(\w+)", key)
    if m:
        return f"fusion.layer_norm_{m[1]}.{m[2]}", False
    m = re.fullmatch(r"multiview_cross_attention\.(fc_[qkvo])\.(\w+)", key)
    if m:
        return f"fusion.cross.{m[1]}.{m[2]}", False
    m = re.fullmatch(r"(visual_head|text_head)\.head\.([0134])\.(\w+)", key)
    if m:
        part = {"0": "Dense_0", "1": "SeqBatchNorm_0.BatchNorm_0", "3": "Dense_1",
                "4": "SeqBatchNorm_1.BatchNorm_0"}[m[2]]
        return f"{m[1]}.{part}.{m[3]}", m[2] in "03" and m[3] == "weight"
    m = re.fullmatch(r"text_decoder\.(.*)", key)
    if m:
        return "text_decoder." + _r2gen(m[1]), False
    raise KeyError(key)
