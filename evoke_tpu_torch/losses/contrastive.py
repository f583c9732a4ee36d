"""Multi-positive InfoNCE losses of stage-1 pretraining (port of
``evoke_tpu/losses/contrastive.py``).

- ``multi_positive_image_loss``: image-image InfoNCE where the other views of
  the same study are positives (soft targets); rows and columns are limited
  to samples with at least one partner view, the diagonal is excluded, and
  the loss is 0 when no sample has a partner.
- ``multi_positive_image_loss_avg``: the positives' logits averaged into one
  positive logit, cross-entropied against the row's negatives.
- ``global_alignment_loss``: bidirectional image-text InfoNCE with a
  same-study soft-target matrix (diagonal included).
- ``local_token_alignment_loss``: text-token -> image-patch attention, then a
  [B, T, T] word similarity cross-entropied in both directions.

Every loss computes in float32 whatever the inputs' dtype, and takes a
``valid`` mask so padded batch rows add nothing. Masked logits are -1e9.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e9


def _l2_normalize(x, eps: float = 1e-12):
    """x / max(||x||, eps) over the last axis."""
    return x / torch.clamp_min(torch.linalg.vector_norm(x, dim=-1, keepdim=True), eps)


def _soft_ce(logits, soft_targets, row_mask):
    """Mean over masked rows of -(targets * log_softmax(logits)).sum(-1)."""
    per_row = -(soft_targets * torch.log_softmax(logits, dim=-1)).sum(-1)
    rm = row_mask.float()
    return (per_row * rm).sum() / torch.clamp_min(rm.sum(), 1.0)


def _same_study(pid_codes, valid):
    v = valid.bool()
    return (pid_codes[:, None] == pid_codes[None, :]) & v[:, None] & v[None, :]


def _eye(b: int, device):
    return torch.eye(b, dtype=torch.bool, device=device)


def multi_positive_image_loss(global_image_embed, pid_codes, valid, temp: float):
    """[B, D] raw global image features; same-study partners are positives.

    Only samples with a partner take part, as rows and as softmax columns."""
    eq = _same_study(pid_codes, valid)
    eye = _eye(pid_codes.shape[0], pid_codes.device)
    labels = (eq & ~eye).float()
    has_partner = labels.sum(-1) > 0
    targets = labels / torch.clamp_min(labels.sum(-1, keepdim=True), 1.0)

    e = _l2_normalize(global_image_embed.float())
    logits = (e @ e.t()) / temp
    col_ok = has_partner[None, :] & ~eye
    logits = torch.where(col_ok, logits, NEG_INF)
    logits = logits - logits.max(dim=-1, keepdim=True).values.detach()
    return _soft_ce(logits, targets, has_partner)


def multi_positive_image_loss_avg(global_image_embed, pid_codes, valid, temp: float):
    """The averaged-positive formulation: the logits of all positives are
    averaged into one positive logit and cross-entropied against the row's
    negatives. Columns are not limited to multiview samples (one-view samples
    stay negatives)."""
    v = valid.bool()
    eq = _same_study(pid_codes, valid)
    eye = _eye(pid_codes.shape[0], pid_codes.device)
    pos = eq & ~eye
    has_partner = pos.any(-1)

    e = _l2_normalize(global_image_embed.float())
    logits = (e @ e.t()) / temp
    logits = torch.where(eye, NEG_INF, logits)
    logits = torch.where(v[None, :], logits, NEG_INF)     # padded rows are no columns
    logits = logits - logits.max(dim=-1, keepdim=True).values.detach()

    n_pos = torch.clamp_min(pos.sum(-1), 1)
    pos_logit = torch.where(pos, logits, 0.0).sum(-1) / n_pos          # [B]
    neg = torch.where(pos | eye | ~v[None, :], NEG_INF, logits)        # [B, B]
    lse = torch.logaddexp(pos_logit, torch.logsumexp(neg, dim=-1))
    per_row = lse - pos_logit
    rm = has_partner.float()
    return (per_row * rm).sum() / torch.clamp_min(rm.sum(), 1.0)


def global_alignment_loss(global_image_embed, global_text_embed, pid_codes, valid,
                          temp: float):
    """Bidirectional multi-positive InfoNCE between [B, D] image and text globals."""
    labels = _same_study(pid_codes, valid).float()        # diagonal included
    targets = labels / torch.clamp_min(labels.sum(-1, keepdim=True), 1.0)
    img = _l2_normalize(global_image_embed.float())
    txt = _l2_normalize(global_text_embed.float())
    col_ok = valid.bool()[None, :]
    sim_it = torch.where(col_ok, (img @ txt.t()) / temp, NEG_INF)
    sim_ti = torch.where(col_ok, (txt @ img.t()) / temp, NEG_INF)
    return (_soft_ce(sim_it, targets, valid) + _soft_ce(sim_ti, targets, valid)) / 2.0


def local_token_alignment_loss(local_image_embed, local_text_embed,
                               text_mask: Optional[torch.Tensor], temp: float,
                               valid: Optional[torch.Tensor] = None):
    """Token-level alignment of [B, P, D] patches and [B, T, D] text tokens.

    ``text_mask`` [B, T] (1 = real token) masks pad columns in both
    directions and pad rows; None computes over pad positions too."""
    b, t, _ = local_text_embed.shape
    img = local_image_embed.float()
    txt = local_text_embed.float()

    att_sim = torch.einsum("btd,bpd->btp", txt, img) / math.sqrt(img.shape[-1])
    att_out = torch.einsum("btp,bpd->btd", torch.softmax(att_sim, dim=-1), img)
    word_sim = torch.einsum("bqd,bkd->bqk", _l2_normalize(txt),
                            _l2_normalize(att_out)) / temp          # [B, T, T]

    if text_mask is not None:
        tm = text_mask.bool()
        word_sim = torch.where(tm[:, None, :], word_sim, NEG_INF)  # pad columns
        word_sim_t = torch.where(tm[:, None, :], word_sim.transpose(1, 2), NEG_INF)
        row_mask = tm
    else:
        word_sim_t = word_sim.transpose(1, 2)
        row_mask = torch.ones((b, t), dtype=torch.bool, device=txt.device)
    if valid is not None:
        row_mask = row_mask & valid.bool()[:, None]

    picked_q = torch.log_softmax(word_sim, dim=-1).diagonal(dim1=1, dim2=2)   # [B, T]
    picked_k = torch.log_softmax(word_sim_t, dim=-1).diagonal(dim1=1, dim2=2)
    rm = row_mask.float()
    denom = torch.clamp_min(rm.sum(), 1.0)
    loss_q = -(picked_q * rm).sum() / denom
    loss_k = -(picked_k * rm).sum() / denom
    return (loss_q + loss_k) / 2.0
