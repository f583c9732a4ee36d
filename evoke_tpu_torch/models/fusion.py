"""Multiview fusion (port of evoke_tpu/models/fusion.py).

Anchor i's tokens attend the gradient-stopped tokens of its same-study partner
views in the whole batch (anchors first, then auxiliary views), then residual
+ LayerNorm; anchors with no partner pass through after the first LayerNorm.
The LayerNorms are torch ``nn.LayerNorm`` semantics (biased variance, eps
1e-5). ``wide_qkv`` keeps the reference's per-head dim == d_model. In
training the attention probabilities take dropout (rate 0.1) on the dense
and grouped routes; the kernel route is inference-only, as in JAX
(fusion.py:164: ``use_pallas and not use_dropout``).

Under a dp mesh the model gathers every rank's image features first
(``models/finetune.py``): each rank then fuses its own block of anchors
(``q_rows``) against the whole gathered batch, as GSPMD partitions JAX's
global fusion.

Under tensor parallelism (``parallel/tp.py``) ``fc_q/k/v`` are column-split
along whole heads and ``fc_o`` row-split: each rank attends with its
``num_heads / mp`` heads (the kernel route calls K3 on them), and ``fc_o``
sums the ranks' products over ``mp`` and adds its bias once.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from evoke_tpu_torch.core.mesh import active_mesh
from evoke_tpu_torch.models.layers import Dense, LayerNorm, dot_attention, dropout, split_heads
from evoke_tpu_torch.ops.fusion_attention import masked_cross_view_attention
from evoke_tpu_torch.parallel.collectives import all_gather_batch


def same_study_matrix(q_pids, k_pids, q_valid, k_valid):
    """[Q], [K] codes + validity -> [Q, K] bool: same study, both valid, not self."""
    q, k = q_pids.shape[0], k_pids.shape[0]
    eq = q_pids[:, None] == k_pids[None, :]
    v = q_valid[:, None].bool() & k_valid[None, :].bool()
    self_slot = (torch.arange(q, device=q_pids.device)[:, None]
                 == torch.arange(k, device=q_pids.device)[None, :])
    return eq & v & ~self_slot


def gather_views(image_embed, pid_codes, valid, n_anchor: int):
    """The fusion's view of the batch: (image_embed, pid_codes, valid,
    n_anchor, anchor rows) of the global batch (``pid_codes[rows]`` and
    ``valid[rows]`` are then this rank's anchors').

    Without an active dp mesh these are the inputs and the first
    ``n_anchor`` rows. Under one, the inputs are this rank's rows: the
    features are gathered from every rank (with autograd: the backward keeps
    this rank's rows of the summed gradient), the study codes and flags too,
    and this rank fuses its block of the global anchors. A study's anchor and
    its auxiliary views may sit on different ranks, so the same-study mask
    crosses ranks as it crosses GSPMD's shards."""
    mesh = active_mesh()
    if mesh is None:
        return image_embed, pid_codes, valid, n_anchor, slice(0, n_anchor)
    n_all = n_anchor * mesh.dp
    return (all_gather_batch(image_embed, mesh), all_gather_batch(pid_codes, mesh),
            all_gather_batch(valid, mesh), n_all, mesh.rows(n_all))


def max_partners_in(pids, valid, n_anchor: int) -> int:
    """Host-side: the largest number of same-study partner rows any anchor has
    (serving checks a configured ``max_partners`` bound against it)."""
    pids = np.asarray(pids)
    valid = np.asarray(valid)
    best = 0
    for i in range(n_anchor):
        if not valid[i]:
            continue
        same = (pids == pids[i]) & valid
        same[i] = False
        best = max(best, int(same.sum()))
    return best


class BatchedCrossViewAttention(nn.Module):
    """Anchor tokens attend their same-study partners' tokens.

    ``max_partners=None``: dense masked attention over all B*T batch tokens;
    ``max_partners=G``: the partner rows are gathered per anchor (lowest row
    first, plus a self-row slot for partnerless anchors) and attention runs
    over (1+G)*T keys — identical whenever every anchor has <= G partners.
    ``use_pallas=True`` runs the dense form through the fusion-attention
    kernel K3 (``ops/fusion_attention.py``), also when ``max_partners`` is
    set, as the JAX module does without dropout; with dropout (an ``rng``
    and a non-zero rate) the module keeps to the plain routes, as JAX does.
    ``tp``: the mesh when the module holds this rank's heads only."""

    tp = None

    def __init__(self, d_model: int, num_heads: int = 8, wide_qkv: bool = True,
                 use_pallas: bool = False, max_partners: Any = None, dtype=torch.float32,
                 dropout_rate: float = 0.1):
        super().__init__()
        self.use_pallas = use_pallas
        self.dropout_rate = dropout_rate
        self.num_heads = num_heads
        self.dk = d_model if wide_qkv else d_model // num_heads
        self.max_partners = max_partners
        hd = num_heads * self.dk
        self.fc_q = Dense(d_model, hd, dtype)
        self.fc_k = Dense(d_model, hd, dtype)
        self.fc_v = Dense(d_model, hd, dtype)
        self.fc_o = Dense(hd, d_model, dtype)

    def split_heads_tp(self, mesh):
        split_heads(self, ("fc_q", "fc_k", "fc_v"), self.fc_o, mesh)

    def forward(self, x_q, x_kv, study_mask, rng=None, q_offset: int = 0):
        """x_q [Q, T, D] anchors; x_kv [B, T, D] whole batch; study_mask [Q, B];
        ``rng``: dropout generator of the attention probabilities;
        ``q_offset``: the batch row of x_q's first anchor (a dp rank's block
        of anchors starts there)."""
        qn, t, _ = x_q.shape
        b = x_kv.shape[0]
        h, dk = self.num_heads, self.dk
        dev = x_q.device
        kv = x_kv.detach()  # the reference detaches k/v
        q = self.fc_q(x_q).reshape(qn, t, h, dk).transpose(1, 2)      # [Q, h, T, dk]
        k = self.fc_k(kv)
        v = self.fc_v(kv)
        has_partner = study_mask.any(-1)
        use_dropout = rng is not None and self.dropout_rate > 0.0
        kernel = self.use_pallas and not use_dropout
        drop = ((lambda p: dropout(p, self.dropout_rate, rng, heads=(1, self.tp)))
                if use_dropout else None)
        q_rows = torch.arange(q_offset, q_offset + qn, device=dev)

        if self.max_partners is not None and not kernel:
            g = min(int(self.max_partners), b)
            cols = torch.arange(b, device=dev)[None, :]
            order = torch.sort(torch.where(study_mask, cols, b + cols), dim=1).values[:, :g]
            pidx = order % b
            pvalid = order < b
            slot_idx = torch.cat([q_rows[:, None], pidx], dim=1)
            slot_valid = torch.cat([~has_partner[:, None], pvalid], dim=1)
            kg = k.reshape(b, t, h, dk)[slot_idx]                          # [Q, 1+G, T, h, dk]
            vg = v.reshape(b, t, h, dk)[slot_idx]
            kg = kg.reshape(qn, (1 + g) * t, h, dk).transpose(1, 2)
            vg = vg.reshape(qn, (1 + g) * t, h, dk).transpose(1, 2)
            mask4 = slot_valid.repeat_interleave(t, dim=1)[:, None, None, :]
            out, _ = dot_attention(q, kg, vg, mask=mask4, dropout_fn=drop)
            return self.fc_o(out.transpose(1, 2).reshape(qn, t, h * dk))

        k = k.reshape(b * t, h, dk).transpose(0, 1)                       # [h, B*T, dk]
        v = v.reshape(b * t, h, dk).transpose(0, 1)
        self_mask = ((q_rows[:, None] == torch.arange(b, device=dev)[None, :])
                     & ~has_partner[:, None])
        attend = study_mask | self_mask
        if kernel:
            out = masked_cross_view_attention(q, k, v, attend, t_tokens=t)
        else:
            # the anchors' rows as one [1, h, Q*T, dk] query block: the same
            # products as q [Q, h, T, dk] against k[None], without matmul
            # copying k and v once per anchor to broadcast them
            qf = q.transpose(0, 1).reshape(1, h, qn * t, dk)
            mask = attend.repeat_interleave(t, dim=1).repeat_interleave(t, dim=0)
            # the anchors' block is dim 2 here: dropout draws along it
            drop2 = ((lambda p: dropout(p, self.dropout_rate, rng, dim=2, heads=(1, self.tp)))
                     if drop else None)
            out, _ = dot_attention(qf, k[None], v[None], mask=mask[None, None],
                                   dropout_fn=drop2)
            out = out[0].reshape(h, qn, t, dk).transpose(0, 1)
        return self.fc_o(out.transpose(1, 2).reshape(qn, t, h * dk))


class MultiviewFusion(nn.Module):
    """LN1 -> masked cross-view attention -> residual + LN2 (pass-through when no partner).

    ``cross=False`` builds LN1 alone: a model without multiview learning
    calls only ``norm_only``, and flax creates the parameters of the modules
    a model calls, no others."""

    def __init__(self, d_model: int, num_heads: int = 8, wide_qkv: bool = True,
                 max_partners: Any = None, dtype=torch.float32, dropout_rate: float = 0.1,
                 cross: bool = True):
        super().__init__()
        self.layer_norm_1 = LayerNorm(d_model, eps=1e-5, dtype=dtype)
        if cross:
            self.layer_norm_2 = LayerNorm(d_model, eps=1e-5, dtype=dtype)
            self.cross = BatchedCrossViewAttention(d_model, num_heads, wide_qkv,
                                                   max_partners=max_partners, dtype=dtype,
                                                   dropout_rate=dropout_rate)

    def forward(self, image_embed, pid_codes, valid, n_anchor: int, rng=None,
                q_rows: Optional[slice] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """image_embed [B, T, D] (anchors first); pid_codes/valid [B] ->
        (fused [n_anchor, T, D], has_partner [n_anchor]); ``rng``: dropout
        generator; ``q_rows``: fuse only this block of the anchors (a dp
        rank's), returning its rows."""
        q_rows = slice(0, n_anchor) if q_rows is None else q_rows
        study_mask = same_study_matrix(pid_codes[:n_anchor], pid_codes,
                                       valid[:n_anchor], valid)[q_rows]
        has_partner = study_mask.any(-1)
        x = self.layer_norm_1(image_embed)
        x_q = x[q_rows]
        fused = self.layer_norm_2(self.cross(x_q, x, study_mask, rng, q_rows.start) + x_q)
        return torch.where(has_partner[:, None, None], fused, x_q), has_partner

    def norm_only(self, image_embed):
        return self.layer_norm_1(image_embed)
