"""Stage-2 finetune model, inference surface (port of evoke_tpu/models/finetune.py).

Visual encoder -> multiview fusion -> projection head (affine-free final BN)
-> BertCrossLayer co-attention over the encoded indication (or BertLayer
self-attention without one) -> R2Gen decoder over the patch tokens (1:).
Only ``decoder_kind="r2gen"`` with ``visual_encoder="resnet101"`` is ported;
the other decoders and ViT are ROADMAP A12b, training is A10.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
import torch.nn as nn

from evoke_tpu_torch.models.fusion import MultiviewFusion
from evoke_tpu_torch.models.heads import ProjectionHead
from evoke_tpu_torch.models.layers import BertCrossLayer, BertLayer, make_cross_mask
from evoke_tpu_torch.models.resnet import VisualExtractor
from evoke_tpu_torch.models.rm_decoder import RMDecoder
from evoke_tpu_torch.models.text_encoder import TextEncoder


class FinetuneModel(nn.Module):
    def __init__(self, vocab_size: int, d_vf: int = 2048, output_dim: int = 2048,
                 encoder_hidden_size: int = 768, encoder_num_layers: int = 6,
                 encoder_num_heads: int = 12, encoder_intermediate_size: int = 3072,
                 fusion_num_heads: int = 8, fusion_intermediate_size: int = 3072,
                 sk_fusion_num_layers: int = 1, proj_num_heads: int = 8,
                 fusion_wide_qkv: bool = True, fusion_max_partners: Any = None,
                 d_model: int = 512, d_ff: int = 512, num_heads: int = 8,
                 num_layers: int = 3, rm_num_slots: int = 3, rm_num_heads: int = 8,
                 rm_d_model: int = 512, max_seq_len: int = 100,
                 is_multiview_learning: bool = True, decoder_kind: str = "r2gen",
                 visual_encoder: str = "resnet101", dtype=torch.float32):
        super().__init__()
        if decoder_kind != "r2gen":
            raise NotImplementedError(
                f"decoder_kind={decoder_kind!r}: only r2gen is ported (ROADMAP A12b)")
        if visual_encoder != "resnet101":
            raise NotImplementedError(
                f"visual_encoder={visual_encoder!r}: only resnet101 is ported (ROADMAP A12b)")
        self.decoder_kind = decoder_kind
        self.d_model = d_model
        self.dtype = dtype
        self.fusion_max_partners = fusion_max_partners
        self.is_multiview_learning = is_multiview_learning
        self.visual_extractor = VisualExtractor(dtype=dtype)
        self.text_encoder = TextEncoder(vocab_size, encoder_hidden_size, encoder_num_layers,
                                        encoder_num_heads, encoder_intermediate_size,
                                        dtype=dtype)
        self.visual_head = ProjectionHead(d_vf, output_dim, output_dim, final_bn=True,
                                          dtype=dtype)
        self.text_head = ProjectionHead(encoder_hidden_size, output_dim, output_dim,
                                        final_bn=True, dtype=dtype)
        self.fusion = MultiviewFusion(d_vf, proj_num_heads, wide_qkv=fusion_wide_qkv,
                                      max_partners=fusion_max_partners, dtype=dtype)
        self.multimodal_fusion_layers, self.visual_self_atten_layers = [], []
        for i in range(sk_fusion_num_layers):
            cross = BertCrossLayer(output_dim, fusion_num_heads, fusion_intermediate_size,
                                   dtype)
            self.add_module(f"multimodal_fusion_layers_{i}", cross)
            self.multimodal_fusion_layers.append(cross)
            selfl = BertLayer(output_dim, fusion_num_heads, fusion_intermediate_size, dtype)
            self.add_module(f"visual_self_atten_layers_{i}", selfl)
            self.visual_self_atten_layers.append(selfl)
        self.text_decoder = RMDecoder(
            vocab_size=vocab_size, d_model=d_model, d_ff=d_ff, d_vf=output_dim,
            num_layers=num_layers, num_heads=num_heads, rm_num_slots=rm_num_slots,
            rm_num_heads=rm_num_heads, rm_d_model=rm_d_model, max_seq_len=max_seq_len,
            dtype=dtype)

    def encode(self, images, pid_codes, valid, n_anchor: int,
               inc_ids: Optional[torch.Tensor] = None,
               inc_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """images [B, H, W, 3] (anchors first) -> [n_anchor, 1+P, output_dim]."""
        patches, avg = self.visual_extractor(images)
        image_embed = torch.cat([avg[:, None, :], patches], dim=1)
        if self.is_multiview_learning:
            fused, _ = self.fusion(image_embed, pid_codes, valid, n_anchor)
        else:
            fused = self.fusion.norm_only(image_embed[:n_anchor])
        x = self.visual_head(fused)
        if inc_ids is not None:
            inc_feats = self.text_head(self.text_encoder(inc_ids, inc_mask))
            cross_mask = make_cross_mask(inc_mask)
            for layer in self.multimodal_fusion_layers:
                x = layer(x, inc_feats, self_mask=None, cross_mask=cross_mask)
        else:
            for layer in self.visual_self_atten_layers:
                x = layer(x, mask=None)
        return x

    def encode_for_decode(self, images, pid_codes, valid, n_anchor: int,
                          inc_ids=None, inc_mask=None):
        """-> (enc [n_anchor, P, d_model], att_mask [n_anchor, P])."""
        hidden = self.encode(images, pid_codes, valid, n_anchor, inc_ids, inc_mask)
        att_feats = hidden[:, 1:, :]
        att_mask = torch.ones(att_feats.shape[:2], dtype=torch.int32, device=hidden.device)
        return self.text_decoder.encode(att_feats, att_mask), att_mask

    def init_decode_state(self, enc, batch: int, max_len: Optional[int] = None):
        return self.text_decoder.init_decode_state(enc, batch, max_len)

    def decode_step(self, tok, pos: int, state, att_mask, return_logits: bool = False,
                    age=None, return_topk: Optional[int] = None, topk_suppress=()):
        return self.text_decoder.decode_step(tok, pos, state, att_mask,
                                             return_logits=return_logits, age=age,
                                             return_topk=return_topk,
                                             topk_suppress=topk_suppress)
