"""F1-CheXbert clinical-efficacy metric on the card (port of
``evoke_tpu/evals/chexbert.py``).

A BERT encoder + 14 linear heads (13 conditions x 4 classes {blank,
positive, negative, uncertain} + 'No Finding' x 2) over the CLS embedding;
per-report binary labels by the 'rrg' mapping (positive / uncertain -> 1);
micro / macro F1 over all 14 conditions and the top 5. Reports are tokenized
on the host (WordPiece), padded to a static ``[batch_size, max_len]`` shape
(the last row repeated) and labelled in batches by one labeler built once;
every batch is queued before the labels are copied back.

Weights: ``chexbert.pth`` read with ``torch.load`` ('state_dict' /
'model_state_dict' wrappers, 'module.'-prefixed ``bert.*`` HF BertModel keys
and ``linear_heads.*``); the encoder goes through the port's one BERT key
map, ``models.torch_import.import_bert_encoder``.

``classification_report`` and ``accuracy_score`` are numpy versions of
sklearn's for multilabel 0/1 matrices (the port does not depend on sklearn).
"""

from __future__ import annotations

import os
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from evoke_tpu_torch.core.device import resolve_device
from evoke_tpu_torch.data.tokenizer import WordTokenizer
from evoke_tpu_torch.models.layers import Dense
from evoke_tpu_torch.models.text_encoder import TextEncoder
from evoke_tpu_torch.models.torch_import import import_bert_encoder
from evoke_tpu_torch.params import init_params_

CONDITIONS = [
    "Enlarged Cardiomediastinum", "Cardiomegaly", "Lung Opacity", "Lung Lesion", "Edema",
    "Consolidation", "Pneumonia", "Atelectasis", "Pneumothorax", "Pleural Effusion",
    "Pleural Other", "Fracture", "Support Devices", "No Finding"]
TOP5 = ["Cardiomegaly", "Edema", "Consolidation", "Atelectasis", "Pleural Effusion"]
TOP5_INDEX = [CONDITIONS.index(c) for c in TOP5]


class ChexbertLabeler(nn.Module):
    """BERT + 14 classification heads over the CLS embedding (float32)."""

    def __init__(self, vocab_size: int = 30522, hidden_size: int = 768, num_layers: int = 12,
                 num_heads: int = 12, intermediate_size: int = 3072,
                 max_positions: int = 512):
        super().__init__()
        self.bert = TextEncoder(vocab_size, hidden_size, num_layers, num_heads,
                                intermediate_size, max_positions=max_positions)
        self.heads = []
        for i in range(14):
            head = Dense(hidden_size, 4 if i < 13 else 2)
            self.add_module(f"head_{i}", head)
            self.heads.append(head)

    def forward(self, input_ids, attention_mask):
        """-> list of 14 logits tensors ([B, 4] x13 + [B, 2])."""
        cls = self.bert(input_ids, attention_mask)[:, 0, :]
        return [head(cls) for head in self.heads]


def load_chexbert_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """``chexbert.pth`` -> a flat state dict without the 'module.' prefix."""
    blob = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(blob, Mapping) and "state_dict" in blob:
        blob = blob["state_dict"]
    if isinstance(blob, Mapping) and "model_state_dict" in blob:
        blob = blob["model_state_dict"]
    return {k.replace("module.", ""): v for k, v in blob.items() if torch.is_tensor(v)}


@torch.no_grad()
def load_chexbert_weights(model: ChexbertLabeler, state_dict: Mapping[str, torch.Tensor]
                          ) -> Dict[str, int]:
    """Copy ``bert.*`` (through ``models.torch_import.import_bert_encoder``)
    and ``linear_heads.*`` into ``model``. Returns the importer's report:
    ``loaded`` (encoder tensors copied), ``mismatched`` (encoder tensors
    skipped for their shape, e.g. another vocab) and ``missing``. Layers
    beyond the model's depth, ``pooler.*`` and ``embeddings.position_ids``
    are ignored; a head of another shape raises."""
    bert_sd = {k[len("bert."):]: v for k, v in state_dict.items() if k.startswith("bert.")}
    _, report = import_bert_encoder(bert_sd, model.bert)
    for i, head in enumerate(model.heads):
        w = state_dict.get(f"linear_heads.{i}.weight")
        if w is not None:
            head.weight.copy_(w)
            head.bias.copy_(state_dict[f"linear_heads.{i}.bias"])
    return report


def _load_wordpiece_tokenizer(tokenizer_dir: str) -> WordTokenizer:
    """Build a WordPiece tokenizer from an HF vocab.txt (bert-base-uncased layout)."""
    vocab_path = os.path.join(tokenizer_dir, "vocab.txt")
    with open(vocab_path) as f:
        vocab = {line.rstrip("\n"): i for i, line in enumerate(f)}
    tok = WordTokenizer.__new__(WordTokenizer)
    tok.model = "wordpiece"
    tok.lowercase = True
    tok.vocab = vocab
    tok.id_to_token = {i: t for t, i in vocab.items()}
    tok.unk_id = vocab["[UNK]"]
    tok.pad_id = vocab["[PAD]"]
    tok.cls_id = vocab["[CLS]"]
    tok.sep_id = vocab["[SEP]"]
    tok.bos_id = tok.cls_id
    tok.eos_id = tok.sep_id
    tok._special_ids = {tok.unk_id, tok.pad_id, tok.cls_id, tok.sep_id}
    return tok


# ---------------------------------------------------------- sklearn's numbers

def _divide(num: np.ndarray, den: np.ndarray) -> np.ndarray:
    """num / den as float64, 0 where den == 0 (sklearn's zero_division=0)."""
    den = np.asarray(den, np.float64)
    mask = den == 0
    out = np.asarray(num, np.float64) / np.where(mask, 1.0, den)
    out[mask] = 0.0
    return out


def _prf(tp: np.ndarray, pred: np.ndarray, true: np.ndarray):
    return _divide(tp, pred), _divide(tp, true), _divide(2.0 * tp, true + pred)


def classification_report(y_true, y_pred, target_names: Sequence[str]) -> Dict:
    """sklearn's ``classification_report(..., output_dict=True,
    zero_division=0)`` for multilabel 0/1 matrices [N, C]: per class and for
    the micro, macro, weighted and samples averages, ``precision``,
    ``recall``, ``f1-score`` and ``support`` (all floats), computed in
    sklearn's order of operations."""
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    if y_true.ndim != 2 or y_true.shape != y_pred.shape or y_true.shape[1] < 2:
        raise ValueError(f"expected two multilabel matrices [N, C>1], got {y_true.shape} "
                         f"and {y_pred.shape}")
    if y_true.shape[1] != len(target_names):
        raise ValueError(f"Number of classes, {y_true.shape[1]}, does not match size of "
                         f"target_names, {len(target_names)}")
    t, p = y_true != 0, y_pred != 0
    tp, pred, true = (t & p).sum(0), p.sum(0), t.sum(0)
    prec, rec, f1 = _prf(tp, pred, true)
    report: Dict[str, Dict[str, float]] = {
        name: {"precision": float(prec[i]), "recall": float(rec[i]),
               "f1-score": float(f1[i]), "support": float(true[i])}
        for i, name in enumerate(target_names)}
    support = float(np.sum(true))
    mp, mr, mf = _prf(tp.sum(keepdims=True), pred.sum(keepdims=True), true.sum(keepdims=True))
    averages = {"micro avg": (mp[0], mr[0], mf[0])}
    averages["macro avg"] = tuple(np.nanmean(x) for x in (prec, rec, f1))
    w = true if true.sum() else None               # all-zero weights: plain mean
    averages["weighted avg"] = tuple(np.average(x, weights=w) for x in (prec, rec, f1))
    s_tp, s_pred, s_true = (t & p).sum(1), p.sum(1), t.sum(1)
    averages["samples avg"] = tuple(np.nanmean(x) for x in _prf(s_tp, s_pred, s_true))
    for name, (ap, ar, af) in averages.items():
        report[name] = {"precision": float(ap), "recall": float(ar), "f1-score": float(af),
                        "support": support}
    return report


def accuracy_score(y_true, y_pred) -> float:
    """sklearn's subset accuracy for multilabel matrices: the share of rows
    whose labels all agree."""
    diff = np.count_nonzero(np.asarray(y_true) - np.asarray(y_pred), axis=1)
    return float(np.average(diff == 0))


# ------------------------------------------------------------------ the scorer

class F1CheXbert:
    """Instantiate ONCE; call on (hyps, refs) lists of report strings. The
    labeler lives on ``device`` (default the card; without CUDA it raises
    unless ``device="cpu"``)."""

    def __init__(self, chexbert_checkpoint: str, tokenizer_dir: str,
                 max_len: int = 512, batch_size: int = 64, device="cuda", **model_kw):
        self.device = resolve_device(device)
        self.tokenizer = _load_wordpiece_tokenizer(tokenizer_dir)
        self.max_len = max_len
        self.batch_size = batch_size
        with torch.device(self.device):
            self.model = ChexbertLabeler(vocab_size=len(self.tokenizer.vocab), **model_kw)
        init_params_(self.model.eval(), 0)     # what the checkpoint lacks keeps this init
        self.import_report = load_chexbert_weights(
            self.model, load_chexbert_state_dict(chexbert_checkpoint))

    def _encode(self, report: str) -> np.ndarray:
        ids = [self.tokenizer.cls_id] + self.tokenizer.encode(" ".join(report.split()))
        ids = ids[: self.max_len - 1] + [self.tokenizer.sep_id]
        out = np.full((self.max_len,), self.tokenizer.pad_id, np.int32)
        out[: len(ids)] = ids
        return out

    @torch.inference_mode()
    def label(self, reports: Sequence[str]) -> np.ndarray:
        """-> [N, 14] binary labels ('rrg' mapping: positive/uncertain -> 1)."""
        chunks = []
        for start in range(0, len(reports), self.batch_size):
            chunk = reports[start:start + self.batch_size]
            ids = np.stack([self._encode(r) for r in chunk])
            if len(chunk) < self.batch_size:  # pad to the static batch shape
                pad = np.tile(ids[-1:], (self.batch_size - len(chunk), 1))
                ids = np.concatenate([ids, pad])
            mask = (ids != self.tokenizer.pad_id).astype(np.int32)
            outs = self.model(torch.as_tensor(ids, device=self.device),
                              torch.as_tensor(mask, device=self.device))
            chunks.append(torch.stack([o.argmax(-1) for o in outs], 1)[: len(chunk)])
        cls = torch.cat(chunks).cpu().numpy()
        return ((cls == 1) | (cls == 3)).astype(np.int64)  # positive or uncertain

    def __call__(self, hyps: Sequence[str], refs: Sequence[str]):
        refs_l = self.label([r.strip() for r in refs])
        hyps_l = self.label([h.strip() for h in hyps])
        refs5, hyps5 = refs_l[:, TOP5_INDEX], hyps_l[:, TOP5_INDEX]
        accuracy = accuracy_score(refs5, hyps5)
        pe_accuracy = (np.count_nonzero(refs5 - hyps5, axis=1) == 0).astype(np.float32)
        cr = classification_report(refs_l, hyps_l, target_names=CONDITIONS)
        cr5 = classification_report(refs5, hyps5, target_names=TOP5)
        return accuracy, pe_accuracy, cr, cr5


def compute_chexbert_scores(gts: List[str], res: List[str], chexbert_checkpoint: str,
                            tokenizer_dir: Optional[str] = None,
                            device="cuda") -> Dict[str, float]:
    """The reference's compute_ce_scores CheXbert subset (metrics.py:59-90)."""
    scorer = F1CheXbert(chexbert_checkpoint,
                        tokenizer_dir or os.path.dirname(chexbert_checkpoint), device=device)
    _, _, cr, cr5 = scorer(hyps=res, refs=gts)
    return {
        "chexbert_5_micro_f1": cr5["micro avg"]["f1-score"],
        "chexbert_all_micro_f1": cr["micro avg"]["f1-score"],
        "chexbert_5_macro_f1": cr5["macro avg"]["f1-score"],
        "chexbert_all_macro_f1": cr["macro avg"]["f1-score"],
    }
