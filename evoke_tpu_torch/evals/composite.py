"""Aggregate scoring surface (EVOKE modules/metrics/metrics.py:87 parity): the
port's copy of ``evoke_tpu/evals/composite.py``.

``compute_all_scores(gts, res, cfg)`` = NLG metrics (always, pure Python) +
every clinical-efficacy metric whose dependency/checkpoint is configured and
available. Scorers are constructed ONCE per process and reused (the reference
re-instantiates CheXbert+RadGraph every eval epoch — metrics.py:59-70).

``device`` (default the card) is where the CheXbert labeler runs; its cache
key names the device. The other metrics run on the host as in JAX.
"""

from __future__ import annotations

import os
import sys
from typing import Dict, List, Optional, Union

from evoke_tpu_torch.evals.nlg import compute_nlg_scores

_SCORER_CACHE: Dict[str, object] = {}


def _chexbert_scorer(metrics_cfg, device):
    """The process's F1CheXbert for this checkpoint and device, built once."""
    from evoke_tpu_torch.core.device import resolve_device
    from evoke_tpu_torch.evals.chexbert import F1CheXbert

    ck = metrics_cfg.chexbert_checkpoint
    key = f"chexbert:{ck}:{resolve_device(device)}"
    if key not in _SCORER_CACHE:
        tok_dir = metrics_cfg.chexbert_tokenizer_checkpoint or os.path.dirname(ck)
        _SCORER_CACHE[key] = F1CheXbert(ck, tok_dir, device=device)
    return _SCORER_CACHE[key]


def compute_ce_scores(gts: List[str], res: List[str], metrics_cfg,
                      device="cuda") -> Dict[str, float]:
    """CheXbert + RadGraph (+BERTScore/GREEN/RadEntityNLI when configured).

    Degrades per-metric, VISIBLY: every configured-but-failed metric lands in
    the returned ``degraded_metrics`` entry, which the trainer writes into
    metrics.jsonl — a silently dropped F1-RadGraph would otherwise change what
    the RCB monitor means (round-1 weak #8)."""
    out: Dict[str, float] = {}
    degraded: List[str] = []

    def failed(name: str, exc: Exception) -> None:
        degraded.append(f"{name}: {exc}")
        print(f"[metrics] {name} failed: {exc}", file=sys.stderr)

    ck = metrics_cfg.chexbert_checkpoint
    if ck and os.path.exists(ck):
        try:
            _, _, cr, cr5 = _chexbert_scorer(metrics_cfg, device)(hyps=res, refs=gts)
            out["chexbert_5_micro_f1"] = cr5["micro avg"]["f1-score"]
            out["chexbert_all_micro_f1"] = cr["micro avg"]["f1-score"]
            out["chexbert_5_macro_f1"] = cr5["macro avg"]["f1-score"]
            out["chexbert_all_macro_f1"] = cr["macro avg"]["f1-score"]
        except Exception as e:
            failed("CheXbert", e)
    rk = metrics_cfg.radgraph_checkpoint
    if rk:
        try:
            from evoke_tpu_torch.evals.adapters import F1RadGraphAdapter
            key = f"radgraph:{rk}"
            if key not in _SCORER_CACHE:
                _SCORER_CACHE[key] = F1RadGraphAdapter(
                    rk, reward_level=metrics_cfg.radgraph_reward_level)
            mean_reward, _ = _SCORER_CACHE[key](hyps=res, refs=gts)
            out["F1-Radgraph-" + metrics_cfg.radgraph_reward_level] = mean_reward
        except Exception as e:
            failed("F1-Radgraph", e)
    bk = metrics_cfg.bertscore_checkpoint
    if bk and os.path.exists(bk):
        try:
            from evoke_tpu_torch.evals.adapters import bertscore
            out["BERTScore"] = bertscore(res, gts, bk)
        except Exception as e:
            failed("BERTScore", e)
    gk = getattr(metrics_cfg, "green_checkpoint", "")
    if gk:
        try:
            from evoke_tpu_torch.evals.adapters import GreenAdapter
            key = f"green:{gk}"
            if key not in _SCORER_CACHE:
                _SCORER_CACHE[key] = GreenAdapter(gk)
            green = _SCORER_CACHE[key].score(hyps=res, refs=gts)
            out["GREEN"] = green["green_mean"]
            out["GREEN_std"] = green["green_std"]
        except Exception as e:
            failed("GREEN", e)
    nk = getattr(metrics_cfg, "nli_checkpoint", "")
    if nk:
        try:
            from evoke_tpu_torch.evals.adapters import RadEntityNLIScorer
            key = f"radentity_nli:{nk}"
            if key not in _SCORER_CACHE:
                _SCORER_CACHE[key] = RadEntityNLIScorer(
                    nli_model_path=nk,
                    bertscore_model_path=metrics_cfg.bertscore_checkpoint or None)
            mean, _ = _SCORER_CACHE[key](res, gts)
            out["RadEntityNLI"] = mean
        except Exception as e:
            failed("RadEntityNLI", e)
    if degraded:
        out["degraded_metrics"] = "; ".join(degraded)
    return out


def compute_chexbert_details_scores(gts: List[str], res: List[str], metrics_cfg,
                                    device="cuda") -> Dict[str, list]:
    """Per-condition CheXbert table (reference metrics.py:97-115): for each of
    the 14 conditions, [prevalence% (support), precision, recall, f1]; avg rows
    keep '-' in the support column."""
    _, _, chexbert_all, _ = _chexbert_scorer(metrics_cfg, device)(hyps=res, refs=gts)
    chexbert_all = {k: v for k, v in chexbert_all.items()
                    if k not in ("weighted avg", "samples avg")}
    sample_num = chexbert_all["micro avg"]["support"]
    out: Dict[str, list] = {}
    for cond, v in chexbert_all.items():
        lead = ("-" if "avg" in cond else
                f"{round(v['support'] * 100 / sample_num, 1)} ({int(v['support'])})")
        out[cond] = [lead, round(v["precision"], 3), round(v["recall"], 3),
                     round(v["f1-score"], 3)]
    return out


def compute_b4_rg(gts: List[str], res: List[str], metrics_cfg,
                  device="cuda") -> Dict[str, str]:
    """The reference's 'B4 & RG' summary cell (metrics.py:117-142)."""
    from evoke_tpu_torch.evals.nlg import bleu

    b, _ = bleu({str(i): [g] for i, g in enumerate(gts)},
                {str(i): [r] for i, r in enumerate(res)}, 4)
    ce = compute_ce_scores(gts, res, metrics_cfg, device)
    rg = ce.get("F1-Radgraph-partial", float("nan"))
    return {"B4 & RG": f"{round(b[3], 4)} & {round(rg, 3)}"}


def compute_all_scores(gts: Union[Dict[str, List[str]], List[str]],
                       res: Union[Dict[str, List[str]], List[str]],
                       metrics_cfg=None, device="cuda") -> Dict[str, float]:
    if isinstance(gts, dict):
        gts_list = [v[0] for v in gts.values()]
        res_list = [res[k][0] for k in gts]
    else:
        gts_list, res_list = list(gts), list(res)
    out = compute_nlg_scores(gts, res)
    if metrics_cfg is not None:
        out.update(compute_ce_scores(gts_list, res_list, metrics_cfg, device))
    return out
