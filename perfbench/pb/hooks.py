"""Forced report lengths through the servers' load-testing hooks.

Random weights never end a report, so each study carries a target length and
the hooks force it: EOS is out of contention before the target and the only
candidate at it. The benchmark's own copy of the forcing, frozen here so that
a change to the program's copy cannot change the traffic.
"""

from __future__ import annotations

import torch

FORCE = 3e4


def force_topk(vals, idx, age_rows, tgt_rows, eos):
    """The fused tail's [N, k] candidates with each row's length forced."""
    at_end = (age_rows == tgt_rows - 1)[:, None]
    vals = torch.where((idx == eos) & ~at_end, -FORCE, vals)
    col0 = torch.arange(idx.shape[1], device=idx.device)[None, :] == 0
    vals = torch.where(at_end, torch.where(col0, FORCE, -FORCE), vals)
    return vals, torch.where(at_end & col0, eos, idx)


def batch_topk_hook(beam: int, eos: int):
    """``ReportServer(topk_hook=)``: every row of a batch is at step ``pos``;
    targets come from the batch's ``target_len`` [n_anchor]."""
    def hook(vals, idx, lse, tok, pos, batch):
        age = torch.full(vals.shape[:1], pos, device=vals.device)
        return force_topk(vals, idx, age, batch["target_len"].repeat_interleave(beam), eos)
    return hook


def engine_topk_wrapper(beam: int, eos: int):
    """``ContinuousServer(topk_wrapper=)``: per-row ages; targets arrive as
    each slot's ``aux``."""
    def wrapper(vals, idx, lse, age_rows, aux):
        return force_topk(vals, idx, age_rows, aux.repeat_interleave(beam), eos)
    return wrapper
