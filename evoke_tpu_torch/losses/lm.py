"""Masked language-model NLL (port of evoke_tpu/losses/lm.py)."""

from __future__ import annotations

from typing import Optional

import torch


def lm_loss(log_probs: torch.Tensor, target_ids: torch.Tensor, target_mask: torch.Tensor,
            sample_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """log_probs [B, T, V] (position i predicts token i+1), ids / mask [B, T].

    loss = -sum(logp[b, i, ids[b, i+1]] * mask[b, i+1]) / max(sum(mask[:, 1:]), 1);
    ``sample_mask`` [B] drops padding rows. The picked log-probs are gathered
    from ``log_probs`` in place: no second [B, T, V] tensor is made."""
    tgt = target_ids[:, 1:].long()
    msk = target_mask[:, 1:].float()
    if sample_mask is not None:
        msk = msk * sample_mask[:, None].float()
    lp = log_probs[:, : tgt.shape[1], :]
    picked = torch.gather(lp, -1, tgt[..., None])[..., 0]
    denom = torch.clamp(msk.sum(), min=1.0)
    return -(picked * msk).sum() / denom
