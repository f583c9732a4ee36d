"""Masked language-model NLL (port of evoke_tpu/losses/lm.py)."""

from __future__ import annotations

from typing import Optional

import torch

from evoke_tpu_torch.core.mesh import active_mesh
from evoke_tpu_torch.parallel.collectives import all_reduce_sum


def lm_loss(log_probs: torch.Tensor, target_ids: torch.Tensor, target_mask: torch.Tensor,
            sample_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """log_probs [B, T, V] (position i predicts token i+1), ids / mask [B, T].

    loss = -sum(logp[b, i, ids[b, i+1]] * mask[b, i+1]) / max(sum(mask[:, 1:]), 1);
    ``sample_mask`` [B] drops padding rows. The picked log-probs are gathered
    from ``log_probs`` in place: no second [B, T, V] tensor is made.

    Under an active dp mesh the rows are this rank's and the denominator is
    the global batch's token count (summed over ranks): the result is this
    rank's share, and the shares sum to the global loss. A mean of per-rank
    means would differ whenever ranks hold different token counts."""
    tgt = target_ids[:, 1:].long()
    msk = target_mask[:, 1:].float()
    if sample_mask is not None:
        msk = msk * sample_mask[:, None].float()
    lp = log_probs[:, : tgt.shape[1], :]
    picked = torch.gather(lp, -1, tgt[..., None])[..., 0]
    count = msk.sum()
    mesh = active_mesh()
    if mesh is not None:
        count = all_reduce_sum(count, mesh)
    denom = torch.clamp(count, min=1.0)
    return -(picked * msk).sum() / denom
