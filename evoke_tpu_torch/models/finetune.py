"""Stage-2 finetune model (port of evoke_tpu/models/finetune.py).

Visual encoder -> multiview fusion -> projection head (affine-free final BN)
-> BertCrossLayer co-attention over the encoded indication (or BertLayer
self-attention without one) -> the text decoder over the patch tokens (1:).
``forward`` is the training forward (the LM loss of teacher-forced
log-probs); ``encode_for_decode`` / ``decode_step`` are the decode surface.
``visual_encoder``: ``resnet101`` or ``vit_b32`` (``models/vit.py``);
``decoder_kind``: ``r2gen`` (``models/rm_decoder.py``), ``cmn``
(``models/cmn.py``), ``causal`` or ``bertgen`` (``models/causal_decoder.py``;
both with d_ff = max(d_ff, 4 * d_model)), as the JAX module builds them; and
the port's own ``mla_moe`` (``models/mla_moe_decoder.py``), a DeepSeek-V2 / V3
style language model whose keys come in one dict, ``mla_moe``
(``core/config.MLA_MOE_KEYS``); its hidden size becomes ``d_model``.

Dropout rates are the JAX module's: ``dropout`` in the decoder's sublayers,
``drop_prob_lm`` on its embedded image tokens, 0.1 in its relational memory,
``encoder_dropout`` in the text encoder, 0.1 in the fusion attention and the
co-attention layers.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn as nn

from evoke_tpu_torch.losses.lm import lm_loss
from evoke_tpu_torch.models.fusion import MultiviewFusion, gather_views
from evoke_tpu_torch.models.heads import ProjectionHead
from evoke_tpu_torch.models.layers import BertCrossLayer, BertLayer, make_cross_mask
from evoke_tpu_torch.models.resnet import VisualExtractor
from evoke_tpu_torch.models.rm_decoder import RMDecoder
from evoke_tpu_torch.models.text_encoder import TextEncoder

DECODER_KINDS = ("r2gen", "cmn", "causal", "bertgen", "mla_moe")
VISUAL_ENCODERS = ("resnet101", "vit_b32")


class FinetuneModel(nn.Module):
    def __init__(self, vocab_size: int, d_vf: int = 2048, output_dim: int = 2048,
                 encoder_hidden_size: int = 768, encoder_num_layers: int = 6,
                 encoder_num_heads: int = 12, encoder_intermediate_size: int = 3072,
                 fusion_num_heads: int = 8, fusion_intermediate_size: int = 3072,
                 sk_fusion_num_layers: int = 1, proj_num_heads: int = 8,
                 fusion_wide_qkv: bool = True, fusion_max_partners: Any = None,
                 d_model: int = 512, d_ff: int = 512, num_heads: int = 8,
                 num_layers: int = 3, dropout: float = 0.0, drop_prob_lm: float = 0.5,
                 rm_num_slots: int = 3, rm_num_heads: int = 8,
                 rm_d_model: int = 512, max_seq_len: int = 100,
                 is_multiview_learning: bool = True, decoder_kind: str = "r2gen",
                 visual_encoder: str = "resnet101", cmm_size: int = 2048,
                 cmm_dim: int = 512, cmn_topk: int = 32, encoder_dropout: float = 0.1,
                 remat_visual: bool = False, mla_moe: Optional[Dict[str, Any]] = None,
                 dtype=torch.float32):
        super().__init__()
        if decoder_kind not in DECODER_KINDS:
            raise ValueError(f"decoder_kind={decoder_kind!r}: one of {DECODER_KINDS}")
        if visual_encoder not in VISUAL_ENCODERS:
            raise ValueError(f"visual_encoder={visual_encoder!r}: one of {VISUAL_ENCODERS}")
        self.decoder_kind = decoder_kind
        self.d_model = d_model
        self.dtype = dtype
        self.fusion_max_partners = fusion_max_partners
        self.is_multiview_learning = is_multiview_learning
        if visual_encoder == "vit_b32":
            from evoke_tpu_torch.models.vit import ViTExtractor

            self.visual_extractor = ViTExtractor(d_vf=d_vf, dtype=dtype)
        else:
            self.visual_extractor = VisualExtractor(dtype=dtype, remat=remat_visual)
        self.text_encoder = TextEncoder(vocab_size, encoder_hidden_size, encoder_num_layers,
                                        encoder_num_heads, encoder_intermediate_size,
                                        dtype=dtype, dropout_rate=encoder_dropout)
        self.visual_head = ProjectionHead(d_vf, output_dim, output_dim, final_bn=True,
                                          dtype=dtype)
        self.text_head = ProjectionHead(encoder_hidden_size, output_dim, output_dim,
                                        final_bn=True, dtype=dtype)
        self.fusion = MultiviewFusion(d_vf, proj_num_heads, wide_qkv=fusion_wide_qkv,
                                      max_partners=fusion_max_partners, dtype=dtype,
                                      cross=is_multiview_learning)
        self.multimodal_fusion_layers, self.visual_self_atten_layers = [], []
        for i in range(sk_fusion_num_layers):
            cross = BertCrossLayer(output_dim, fusion_num_heads, fusion_intermediate_size,
                                   dtype)
            self.add_module(f"multimodal_fusion_layers_{i}", cross)
            self.multimodal_fusion_layers.append(cross)
            selfl = BertLayer(output_dim, fusion_num_heads, fusion_intermediate_size, dtype)
            self.add_module(f"visual_self_atten_layers_{i}", selfl)
            self.visual_self_atten_layers.append(selfl)
        dec = dict(vocab_size=vocab_size, d_model=d_model, d_vf=output_dim,
                   num_layers=num_layers, num_heads=num_heads, dropout_rate=dropout,
                   drop_prob_lm=drop_prob_lm, max_seq_len=max_seq_len, dtype=dtype)
        if decoder_kind == "mla_moe":
            from evoke_tpu_torch.models.mla_moe_decoder import MLAMoEDecoder

            self.text_decoder = MLAMoEDecoder(vocab_size, output_dim, max_seq_len, dtype,
                                              mla_moe)
            self.d_model = self.text_decoder.d_model
        elif decoder_kind in ("causal", "bertgen"):
            from evoke_tpu_torch.models.causal_decoder import (BertGenerationDecoder,
                                                               CausalDecoder)

            cls = BertGenerationDecoder if decoder_kind == "bertgen" else CausalDecoder
            self.text_decoder = cls(d_ff=max(d_ff, 4 * d_model), **dec)
        elif decoder_kind == "cmn":
            from evoke_tpu_torch.models.cmn import CMNDecoder

            self.text_decoder = CMNDecoder(d_ff=d_ff, cmm_size=cmm_size, cmm_dim=cmm_dim,
                                           topk=cmn_topk, **dec)
        else:
            self.text_decoder = RMDecoder(d_ff=d_ff, rm_num_slots=rm_num_slots,
                                          rm_num_heads=rm_num_heads, rm_d_model=rm_d_model,
                                          **dec)

    def encode(self, images, pid_codes, valid, n_anchor: int,
               inc_ids: Optional[torch.Tensor] = None,
               inc_mask: Optional[torch.Tensor] = None, train: bool = False,
               rng: Optional[torch.Generator] = None) -> torch.Tensor:
        """images [B, H, W, 3] (anchors first) -> [n_anchor, 1+P, output_dim].
        ``train``: BatchNorms on batch statistics; ``rng``: dropout generator
        (read only when ``train``). Under an active dp mesh
        (``core/mesh.use_mesh``) every input is this rank's block of the
        global batch's rows and the output is its anchors' (the global
        anchors' block ``mesh.rank``); the visual features are gathered at
        the fusion (``fusion.gather_views``)."""
        return self._encode(images, pid_codes, valid, n_anchor, inc_ids, inc_mask, train,
                            rng)[0]

    def _encode(self, images, pid_codes, valid, n_anchor, inc_ids, inc_mask, train, rng):
        """-> (``encode``'s output, the valid flags of its anchors)."""
        rng = rng if train else None
        patches, avg = self.visual_extractor(images, train)
        image_embed = torch.cat([avg[:, None, :], patches], dim=1)
        image_embed, pid_codes, valid, n_all, rows = gather_views(image_embed, pid_codes,
                                                                  valid, n_anchor)
        if self.is_multiview_learning:
            fused, _ = self.fusion(image_embed, pid_codes, valid, n_all, rng, rows)
        else:
            fused = self.fusion.norm_only(image_embed[rows])
        x = self.visual_head(fused, train)
        if inc_ids is not None:
            inc_feats = self.text_head(self.text_encoder(inc_ids, inc_mask, rng), train)
            cross_mask = make_cross_mask(inc_mask)
            for layer in self.multimodal_fusion_layers:
                x = layer(x, inc_feats, self_mask=None, cross_mask=cross_mask, rng=rng)
        else:
            for layer in self.visual_self_atten_layers:
                x = layer(x, mask=None, rng=rng)
        return x, valid[rows]

    def forward(self, images, report_ids, report_mask, pid_codes, valid,
                inc_ids: Optional[torch.Tensor] = None,
                inc_mask: Optional[torch.Tensor] = None, train: bool = False,
                rng: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """The training forward (finetune.py:166-177) -> {"lm", "all_loss"}.

        ``train=True`` runs the BatchNorms on batch statistics (their running
        update waits for ``layers.commit_batch_stats``); dropout acts only
        when ``rng`` (a ``torch.Generator`` on the model's device) is given,
        so ``train=True, rng=None`` is a training step without dropout.
        Under an active dp mesh the losses are this rank's shares of the
        global batch's (``losses/lm.py``)."""
        n_anchor = report_ids.shape[0]
        rng = rng if train else None
        hidden, anchor_valid = self._encode(images, pid_codes, valid, n_anchor, inc_ids,
                                            inc_mask, train, rng)
        att_feats = hidden[:, 1:, :]
        att_mask = torch.ones(att_feats.shape[:2], dtype=torch.int32, device=hidden.device)
        log_probs = self.text_decoder(att_feats, att_mask, report_ids, report_mask, rng)
        lm = lm_loss(log_probs, report_ids, report_mask, sample_mask=anchor_valid)
        return {"lm": lm, "all_loss": lm}

    def encode_for_decode(self, images, pid_codes, valid, n_anchor: int,
                          inc_ids=None, inc_mask=None):
        """-> (enc [n_anchor, P, d_model], att_mask [n_anchor, P])."""
        hidden = self.encode(images, pid_codes, valid, n_anchor, inc_ids, inc_mask)
        att_feats = hidden[:, 1:, :]
        att_mask = torch.ones(att_feats.shape[:2], dtype=torch.int32, device=hidden.device)
        return self.text_decoder.encode(att_feats, att_mask), att_mask

    def init_decode_state(self, enc, batch: int, max_len: Optional[int] = None,
                          kv_dtype: str = ""):
        """``kv_dtype="int8"``: quantized caches (the R2Gen decoder's only;
        the others raise)."""
        if kv_dtype:
            return self.text_decoder.init_decode_state(enc, batch, max_len, kv_dtype)
        return self.text_decoder.init_decode_state(enc, batch, max_len)

    def decode_step(self, tok, pos: int, state, att_mask, return_logits: bool = False,
                    age=None, return_topk: Optional[int] = None, topk_suppress=()):
        """The text decoder's step; ``age`` (ring caches) and ``return_topk``
        (the fused tail) are the R2Gen decoder's only."""
        extra = {} if age is None else {"age": age}
        if return_topk:
            extra.update(return_topk=return_topk, topk_suppress=topk_suppress)
        return self.text_decoder.decode_step(tok, pos, state, att_mask,
                                             return_logits=return_logits, **extra)
