"""Stage-1 pretraining model: multi-view contrastive alignment (port of
evoke_tpu/models/pretrain.py).

ResNet-101 -> multiview fusion -> visual projection head, and a BERT-style
text encoder -> text projection head; both heads end without the
affine-free BatchNorm. The losses (``losses/contrastive.py``): the
multi-positive image-image InfoNCE over every image of the batch on the raw
ResNet average, the global image-text alignment and the local token
alignment. ``pretrain_loss`` selects the ablation subset (all | mpc |
mpc+global | mpc+local | global+local), ``mul_pos_formulation`` the
multi-positive loss (soft | avg).

As in flax, a module exists only where the model calls it: ``pretrain_loss
"mpc"`` builds no text encoder or text head, and ``is_multiview_learning``
off builds the fusion's first LayerNorm alone.

Dropout: ``encoder_dropout`` in the text encoder and 0.1 on the fusion's
attention probabilities, drawn from ``rng`` when ``train``.

Under a dp mesh (``core/mesh.use_mesh``) the contrastive losses run on the
embeddings, study codes and flags gathered from every rank
(``parallel/collectives.make_shardmap_loss``), as GSPMD runs JAX's on the
global batch.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn as nn

from evoke_tpu_torch.core.mesh import active_mesh
from evoke_tpu_torch.losses.contrastive import (global_alignment_loss,
                                                local_token_alignment_loss,
                                                multi_positive_image_loss,
                                                multi_positive_image_loss_avg)
from evoke_tpu_torch.models.fusion import MultiviewFusion, gather_views
from evoke_tpu_torch.models.heads import ProjectionHead
from evoke_tpu_torch.models.resnet import VisualExtractor
from evoke_tpu_torch.models.text_encoder import TextEncoder
from evoke_tpu_torch.parallel.collectives import make_shardmap_loss

PRETRAIN_LOSSES = ("all", "mpc", "mpc+global", "mpc+local", "global+local")
MUL_POS_FORMULATIONS = ("soft", "avg")


class PretrainModel(nn.Module):
    def __init__(self, vocab_size: int, d_vf: int = 2048, output_dim: int = 2048,
                 encoder_hidden_size: int = 768, encoder_num_layers: int = 6,
                 encoder_num_heads: int = 12, encoder_intermediate_size: int = 3072,
                 proj_num_heads: int = 8, fusion_wide_qkv: bool = True,
                 fusion_max_partners: Any = None, instance_temp: float = 0.5,
                 region_temp: float = 0.5, is_multiview_learning: bool = True,
                 pretrain_loss: str = "all", mul_pos_formulation: str = "soft",
                 mask_local_pad: bool = True, encoder_dropout: float = 0.1,
                 remat_visual: bool = False, dtype=torch.float32):
        super().__init__()
        if pretrain_loss not in PRETRAIN_LOSSES:
            raise ValueError(f"pretrain_loss={pretrain_loss!r}: one of {PRETRAIN_LOSSES}")
        if mul_pos_formulation not in MUL_POS_FORMULATIONS:
            raise ValueError(f"mul_pos_formulation={mul_pos_formulation!r}: one of "
                             f"{MUL_POS_FORMULATIONS}")
        self.dtype = dtype
        self.instance_temp = instance_temp
        self.region_temp = region_temp
        self.is_multiview_learning = is_multiview_learning
        self.pretrain_loss = pretrain_loss
        self.mul_pos_formulation = mul_pos_formulation
        self.mask_local_pad = mask_local_pad
        self.visual_extractor = VisualExtractor(dtype=dtype, remat=remat_visual)
        if pretrain_loss != "mpc":
            self.text_encoder = TextEncoder(vocab_size, encoder_hidden_size,
                                            encoder_num_layers, encoder_num_heads,
                                            encoder_intermediate_size, dtype=dtype,
                                            dropout_rate=encoder_dropout)
            self.text_head = ProjectionHead(encoder_hidden_size, output_dim, output_dim,
                                            final_bn=False, dtype=dtype)
        self.visual_head = ProjectionHead(d_vf, output_dim, output_dim, final_bn=False,
                                          dtype=dtype)
        self.fusion = MultiviewFusion(d_vf, proj_num_heads, wide_qkv=fusion_wide_qkv,
                                      max_partners=fusion_max_partners, dtype=dtype,
                                      cross=is_multiview_learning)

    def encode_images(self, images, pid_codes, valid, n_anchor: int, train: bool = False,
                      rng: Optional[torch.Generator] = None):
        """images [B, H, W, 3] (anchors first) -> (proj [n_anchor, 1+P, out],
        raw_global [B, d_vf])."""
        return self._encode_images(images, pid_codes, valid, n_anchor, train, rng)[:2]

    def _encode_images(self, images, pid_codes, valid, n_anchor, train, rng):
        """-> (``encode_images``'s two outputs, the pid codes and valid flags
        of ``proj``'s anchors)."""
        rng = rng if train else None
        patches, avg = self.visual_extractor(images, train)
        image_embed = torch.cat([avg[:, None, :], patches], dim=1)
        image_embed, pid_codes, valid, n_all, rows = gather_views(image_embed, pid_codes,
                                                                  valid, n_anchor)
        if self.is_multiview_learning:
            fused, _ = self.fusion(image_embed, pid_codes, valid, n_all, rng, rows)
        else:
            fused = self.fusion.norm_only(image_embed[rows])
        return self.visual_head(fused, train), avg, pid_codes[rows], valid[rows]

    def encode_text(self, input_ids, attention_mask, train: bool = False,
                    rng: Optional[torch.Generator] = None):
        rng = rng if train else None
        return self.text_head(self.text_encoder(input_ids, attention_mask, rng), train)

    def forward(self, images, text_ids, text_mask, pid_codes, valid, train: bool = False,
                rng: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """images [B, H, W, 3]: n_anchor study anchors first, then the
        deduplicated auxiliary views; text_ids / text_mask [n_anchor, L];
        pid_codes / valid [B] -> {multiview_loss, instance_loss,
        sen_text_loss, all_loss}, float32 scalars. ``train``: BatchNorms on
        batch statistics (their running update waits for
        ``layers.commit_batch_stats``) and dropout from ``rng``. Under an
        active dp mesh every input is this rank's rows, each loss is computed
        on the gathered global batch, and the outputs are this rank's 1/dp
        shares (they sum to the global losses)."""
        n_anchor = text_ids.shape[0]
        proj, raw_global, anchor_pids, anchor_valid = self._encode_images(
            images, pid_codes, valid, n_anchor, train, rng)
        v_fc, v_att = proj[:, 0, :], proj[:, 1:, :]
        mesh = active_mesh()

        def global_loss(fn, *shards):
            # under a dp mesh: the loss of the gathered global batch, of which
            # this rank backpropagates its 1/dp share
            if mesh is None:
                return fn(*shards)
            return make_shardmap_loss(mesh, fn)(*shards) / mesh.dp

        zero = torch.zeros((), dtype=torch.float32, device=proj.device)
        mul_pos = zero
        if self.is_multiview_learning and self.pretrain_loss != "global+local":
            # over every image (anchors and auxiliary views), on the raw global features
            mp_fn = (multi_positive_image_loss_avg if self.mul_pos_formulation == "avg"
                     else multi_positive_image_loss)
            mul_pos = global_loss(lambda e, p, v: mp_fn(e, p, v, self.region_temp),
                                  raw_global, pid_codes, valid)
        if self.pretrain_loss == "mpc":
            return {"multiview_loss": mul_pos, "instance_loss": zero,
                    "sen_text_loss": zero, "all_loss": mul_pos}

        tproj = self.encode_text(text_ids, text_mask, train, rng)
        t_fc, t_att = tproj[:, 0, :], tproj[:, 1:, :]
        instance = local = zero
        if self.pretrain_loss in ("all", "mpc+global", "global+local"):
            instance = global_loss(
                lambda vf, tf, p, v: global_alignment_loss(vf, tf, p, v, self.instance_temp),
                v_fc, t_fc, anchor_pids, anchor_valid)
        if self.pretrain_loss in ("all", "mpc+local", "global+local"):
            if self.mask_local_pad:
                local = global_loss(lambda va, ta, tm, v: local_token_alignment_loss(
                    va, ta, tm, self.region_temp, valid=v),
                    v_att, t_att, text_mask[:, 1:], anchor_valid)
            else:
                local = global_loss(lambda va, ta, v: local_token_alignment_loss(
                    va, ta, None, self.region_temp, valid=v), v_att, t_att, anchor_valid)
        return {"multiview_loss": mul_pos, "instance_loss": instance,
                "sen_text_loss": local, "all_loss": mul_pos + instance + local}
