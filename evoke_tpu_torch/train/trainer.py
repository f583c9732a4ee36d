"""Evaluation loops of the ``test`` task (port of the parts of
``evoke_tpu/train/trainer.py`` that ``test`` reaches).

- ``BaseTrainer.__init__``: the result dir, ``RunLogger`` to ``{task}.log``,
  ``MetricWriter`` to ``metrics.jsonl``, ``config.json``, the monitor fields
  and ``best_recorder``; ``trainer.load`` is a partial load into the model
  (``core/checkpoint.partial_restore_from``).
- ``FinetuneTrainer.evaluate``: beam decode of a split on the eval path
  (``make_generate_step(serving=False)``: reorder caches, one cache phase,
  the unfused vocab tail), the canned line for empty outputs, the metrics and
  the ``{split}_prediction.csv`` column. Batches go through
  ``serve.generate_stream``, so the host decodes and scores a batch while the
  card runs the next.
- ``Tester.test``: ``evaluate("test")`` and its ``test_*`` record.

Training (``train``, ``trainer.resume``, optimizers, schedulers, checkpoints
of a run) is ROADMAP A10 and raises.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from evoke_tpu_torch.core.config import EvokeConfig
from evoke_tpu_torch.core.device import resolve_device
from evoke_tpu_torch.core.loggers import MetricWriter, PredictionCSV, RunLogger
from evoke_tpu_torch.data.batching import Prefetcher, device_prefetch
from evoke_tpu_torch.serve import EMPTY_REPORT, generate_stream, with_host_valid
from evoke_tpu_torch.train.steps import make_generate_step

MetricsFn = Callable[[Dict[str, List[str]], Dict[str, List[str]]], Dict[str, float]]


class BaseTrainer:
    def __init__(self, cfg: EvokeConfig, model, tokenizer,
                 logger: Optional[RunLogger] = None,
                 metrics_fn: Optional[MetricsFn] = None, device="cuda"):
        if cfg.trainer.resume:
            raise NotImplementedError(f"trainer.resume={cfg.trainer.resume!r}: resuming a "
                                      "run is ROADMAP A10")
        self.cfg = cfg
        self.model = model
        self.tokenizer = tokenizer
        self.device = resolve_device(device)
        self.result_dir = cfg.result_dir
        os.makedirs(self.result_dir, exist_ok=True)
        self.logger = logger or RunLogger(os.path.join(self.result_dir,
                                                       f"{cfg.trainer.task}.log"))
        self.metrics = MetricWriter(os.path.join(self.result_dir, "metrics.jsonl"))
        cfg.save(os.path.join(self.result_dir, "config.json"))  # run reproducibility
        self.metrics_fn = metrics_fn
        self.mnt_mode = cfg.monitor_mode
        self.mnt_metric = "val_" + cfg.monitor_metric
        self.mnt_metric_test = "test_" + cfg.monitor_metric
        self.mnt_best = np.inf if self.mnt_mode == "min" else -np.inf
        self.best_recorder = {"val": {self.mnt_metric: self.mnt_best},
                              "test": {self.mnt_metric_test: self.mnt_best}}
        if cfg.trainer.load:
            self._partial_load(cfg.trainer.load)

    def _partial_load(self, path: str) -> None:
        from evoke_tpu_torch.core.checkpoint import partial_restore_from

        report = partial_restore_from(path, self.model)
        self.logger.info(f"partial load from {path}: {report}")

    def train(self):
        raise NotImplementedError("training is ROADMAP A10")


class FinetuneTrainer(BaseTrainer):
    """Stage-2 report generation: the eval half (FTrainer parity).

    ``eval_loaders``: {split: (loader_with_indication, loader_without)},
    either may be None. ``graphs`` goes to ``make_generate_step`` (None
    captures the decode steps on the card; False runs them eagerly)."""

    def __init__(self, cfg, model, tokenizer, eval_loaders, graphs=None, **kw):
        super().__init__(cfg, model, tokenizer, **kw)
        self.eval_loaders = eval_loaders
        self.gen_inc, self.gen_noinc = (
            make_generate_step(model, tokenizer, cfg.decode, cfg.data.max_seq_len,
                               with_indication=flag, device=self.device, graphs=graphs)
            for flag in (True, False))
        self.pred_csv = {s: PredictionCSV(os.path.join(self.result_dir, f"{s}_prediction.csv"))
                         for s in ("val", "test")}
        self.stats: Dict[str, float] = {}

    def evaluate(self, split: str, epoch_label: str = "final") -> Dict[str, float]:
        """Decode ``split``, score it and write its prediction column. Fills
        ``self.stats``: ``reports``, ``decode_s`` (wall of the decode loop over
        the loaders, host work included), ``capture_s`` (the part of it spent
        capturing decode steps) and ``metrics_s``."""
        ids, gts, preds = [], [], []
        gens = (self.gen_inc, self.gen_noinc)
        capture_s = lambda: sum(loop.capture_s for g in gens for loop, _ in g.loops.values())
        captured = capture_s()
        prefetch = self.cfg.data.prefetch
        t0 = time.perf_counter()
        for loader, gen in zip(self.eval_loaders[split], gens):
            if loader is None:
                continue
            batches = device_prefetch(with_host_valid(Prefetcher(loader, prefetch)),
                                      self.device, prefetch)
            for host, seqs in generate_stream(gen, batches):
                texts = self.tokenizer.decode_batch(seqs.tolist())
                for iid, gt, pred, ok in zip(host["_image_ids"], host["_gts"], texts,
                                             host["_valid"][: len(texts)]):
                    if not ok:
                        continue
                    # the reference substitutes a canned line for empty outputs (:125)
                    ids.append(iid)
                    gts.append(gt)
                    preds.append(pred if pred.strip() else EMPTY_REPORT)
        t1 = time.perf_counter()
        metrics: Dict[str, float] = {}
        if self.metrics_fn is not None and ids:
            metrics = self.metrics_fn({i: [g] for i, g in zip(ids, gts)},
                                      {i: [p] for i, p in zip(ids, preds)})
        if ids:
            self.pred_csv[split].update(epoch_label, ids, gts, preds, metrics)
        self.stats = {
            "reports": float(len(ids)), "decode_s": t1 - t0,
            "capture_s": capture_s() - captured,
            "metrics_s": time.perf_counter() - t1}
        return metrics


class Tester(FinetuneTrainer):
    """Test-only runner (Tester parity): beam search + metrics + test_prediction.csv."""

    def test(self) -> Dict[str, float]:
        res = self.evaluate("test", epoch_label="test")
        for k, v in res.items():
            self.logger.info(f"\ttest_{k:20s}: {v}")
        self.metrics.write({"event": "test", **{f"test_{k}": v for k, v in res.items()}})
        return res
