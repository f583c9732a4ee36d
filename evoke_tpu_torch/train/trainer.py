"""Epoch loops of the pretrain, finetune and test tasks (port of
``evoke_tpu/train/trainer.py``).

- ``BaseTrainer``: the result dir, ``RunLogger`` to ``{task}.log``,
  ``MetricWriter`` to ``metrics.jsonl``, ``config.json``; the monitor metric
  with the composite monitors RC / RB / RCB, early stop, the LR scheduler on
  the lr-monitor metric, checkpoints (``current`` every ``save_period``
  epochs, ``best`` on improvement; ``core/checkpoint.py``), ``trainer.resume``
  (``auto`` starts fresh when there is no ``current`` slot yet) and
  ``trainer.load`` (a partial load), the best-record CSV and
  ``trainer.profile_epoch`` (a ``torch.profiler`` trace of that epoch).
- ``PretrainTrainer``: each epoch trains over the train loader (step
  metrics summed on the device: one host read per epoch, plus one per
  ``log_interval`` steps), then runs the eval step over val, and over test
  every ``trainer.test_every`` epochs; the monitor is ``val_all_loss``
  (mode min) and ReduceLROnPlateau reads it.
- ``FinetuneTrainer``: each epoch trains over the indication loader, then the
  no-indication loader (step metrics summed on the device: one host read per
  epoch, plus one per ``log_interval`` steps), then evaluates val and test:
  beam decode on the eval path (``make_generate_step(serving=False)``:
  reorder caches, one cache phase, the unfused vocab tail), the canned line
  for empty outputs, the metrics and the ``{split}_prediction.csv`` column.
  Batches go through ``serve.generate_stream``, so the host decodes and
  scores a batch while the card runs the next.
- ``Tester.test``: ``evaluate("test")`` and its ``test_*`` record.

A trainer without a ``TrainState`` (the test task) restores only the
model's weights from a slot.

``mesh`` (a ``core/mesh.Mesh``; the device is then the rank's): every rank
runs the trainer over the same loaders, copies its rows of each batch and
takes the mesh's train step (``train/steps.make_train_step(mesh=)``: the
global batch's step); eval steps return the global metrics and the decoded
tokens are gathered over the dp group (the ``mp`` ranks of a dp group decode
the same rows, so no study counts twice) before the metrics. With mp > 1 the
model and its state are sharded over it (``parallel/tp.shard_params_tp``,
before the optimizer is built) and checkpoints hold the full tensors
(``core/checkpoint.py``). Global rank 0 writes the logs, metrics,
predictions and checkpoints (every rank waits for a checkpoint; a restore
is read on rank 0 and broadcast). As in the JAX CLI, no CLI task passes a
mesh to a trainer.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from evoke_tpu_torch.core.checkpoint import CheckpointManager, partial_restore_from
from evoke_tpu_torch.core.config import EvokeConfig
from evoke_tpu_torch.core.device import resolve_device
from evoke_tpu_torch.core.loggers import (MetricWriter, PredictionCSV, RunLogger,
                                          append_best_record)
from evoke_tpu_torch.data.batching import Prefetcher, device_prefetch, rank_view
from evoke_tpu_torch.serve import EMPTY_REPORT, generate_stream, staged_batches
from evoke_tpu_torch.train.optim import build_scheduler, set_lr_scale
from evoke_tpu_torch.train.steps import (TrainState, make_eval_step, make_generate_step,
                                         make_train_step)

class _Silent:
    """The logger and metric writer of a rank other than 0."""

    def info(self, msg: str) -> None:
        pass

    def write(self, record) -> None:
        pass


MetricsFn = Callable[[Dict[str, List[str]], Dict[str, List[str]]], Dict[str, float]]


def _host_scalar(x) -> float:
    """The only host read of a single step's metric (tests count its calls)."""
    return float(x)


def _accumulate(sums: dict, metrics: dict) -> None:
    """Add a step's metrics into running sums on the device (no host read)."""
    for k, v in metrics.items():
        sums[k] = v + sums[k] if k in sums else v


def _epoch_means(sums: dict, n: int) -> Dict[str, float]:
    """One host read for the epoch's summed metrics (keys sorted, as JAX's
    ``device_get`` of a dict returns them)."""
    if not sums:
        return {}
    keys = sorted(sums)
    host = torch.stack([sums[k].float() for k in keys]).cpu().tolist()
    return {k: v / max(n, 1) for k, v in zip(keys, host)}


class BaseTrainer:
    def __init__(self, cfg: EvokeConfig, model, tokenizer, state: Optional[TrainState] = None,
                 logger: Optional[RunLogger] = None,
                 metrics_fn: Optional[MetricsFn] = None, device="cuda", mesh=None):
        self.cfg = cfg
        self.model = model
        self.tokenizer = tokenizer
        self.state = state
        self.mesh = mesh
        self.main = mesh is None or mesh.rank == 0
        self.device = mesh.device if mesh is not None else resolve_device(device)
        self.result_dir = cfg.result_dir
        os.makedirs(self.result_dir, exist_ok=True)
        # the other ranks log nowhere: rank 0 writes the run's files
        self.logger = logger or (RunLogger(os.path.join(self.result_dir,
                                                        f"{cfg.trainer.task}.log"))
                                 if self.main else _Silent())
        self.metrics = (MetricWriter(os.path.join(self.result_dir, "metrics.jsonl"))
                        if self.main else _Silent())
        if self.main:
            cfg.save(os.path.join(self.result_dir, "config.json"))  # run reproducibility
        async_save = cfg.trainer.async_checkpoint and mesh is None
        if cfg.trainer.async_checkpoint and not async_save:
            self.logger.info("trainer.async_checkpoint is off under the dp mesh: rank 0 "
                             "writes each checkpoint while every rank waits")
        self.ckpt = CheckpointManager(os.path.join(self.result_dir, "checkpoint"),
                                      async_save=async_save, mesh=mesh)
        self.metrics_fn = metrics_fn
        self.mnt_mode = cfg.monitor_mode
        self.mnt_metric = "val_" + cfg.monitor_metric
        self.mnt_metric_test = "test_" + cfg.monitor_metric
        self.mnt_best = np.inf if self.mnt_mode == "min" else -np.inf
        self.start_epoch = 1
        self.scheduler = build_scheduler(cfg.optim.lr_scheduler, self.mnt_mode,
                                         cfg.optim.step_size, cfg.optim.gamma)
        self.best_recorder = {"val": {self.mnt_metric: self.mnt_best},
                              "test": {self.mnt_metric_test: self.mnt_best}}
        if cfg.trainer.resume:
            self._resume(cfg.trainer.resume)
        elif cfg.trainer.load:
            self._partial_load(cfg.trainer.load)

    # ---- checkpointing ----

    def _resume(self, which: str) -> None:
        if which == "auto":
            # preemption recovery: rerun the same command; it picks up from
            # the last saved state, or starts fresh on the first run
            if not self.ckpt.exists("current"):
                self.logger.info("resume=auto: no checkpoint yet, starting fresh")
                return
            which = "current"
        name = which if which in ("current", "best") else "current"
        meta = self.ckpt.restore(name, self.state if self.state is not None else self.model)
        self.start_epoch = int(meta.get("epoch", 0)) + 1
        self.mnt_best = float(meta.get("monitor_best", self.mnt_best))
        if "scheduler" in meta and hasattr(self.scheduler, "load_state_dict"):
            self.scheduler.load_state_dict(meta["scheduler"])
        self.logger.info(f"resumed from {name}: epoch {self.start_epoch}, "
                         f"monitor_best {self.mnt_best}")

    def _partial_load(self, path: str) -> None:
        opt = self.state.opt if self.state is not None else None
        report = partial_restore_from(path, self.model, opt)
        self.logger.info(f"partial load from {path}: {report}")

    def _save(self, epoch: int, best: bool) -> None:
        meta = {"epoch": epoch, "monitor_best": float(self.mnt_best)}
        if hasattr(self.scheduler, "state_dict"):
            meta["scheduler"] = self.scheduler.state_dict()
        self.ckpt.save(("current", "best") if best else "current", self.state, meta)

    # ---- monitor ----

    def _composite(self, log: Dict[str, float]) -> None:
        m = self.cfg.monitor_metric
        comps = {"RC": ["F1-Radgraph-partial", "chexbert_all_micro_f1"],
                 "RB": ["F1-Radgraph-partial", "BLEU_4"],
                 "RCB": ["F1-Radgraph-partial", "chexbert_all_micro_f1", "BLEU_4"]}
        if m in comps and self.mnt_metric not in log:
            for split in ("val", "test"):
                keys = [f"{split}_{k}" for k in comps[m]]
                if all(k in log for k in keys):
                    log[f"{split}_{m}"] = float(sum(log[k] for k in keys))

    def _improved(self, log: Dict[str, float]) -> bool:
        if self.mnt_metric not in log:
            return False
        v = log[self.mnt_metric]
        return (v <= self.mnt_best) if self.mnt_mode == "min" else (v >= self.mnt_best)

    def _record_best(self, log: Dict[str, float]) -> None:
        if self.mnt_metric in log and self._improved(log):
            self.best_recorder["val"].update(log)
        tm = self.mnt_metric_test
        if tm in log:
            cur, best = log[tm], self.best_recorder["test"].get(tm, None)
            better = best is None or (
                cur <= best if self.mnt_mode == "min" else cur >= best)
            if better:
                self.best_recorder["test"].update(log)

    def _print_best_to_file(self) -> None:
        if not self.main:
            return
        path = os.path.join(self.result_dir,
                            f"{self.cfg.data.data_name}_{self.cfg.trainer.task}"
                            f"_results_record.csv")
        stamp = time.asctime()
        for split in ("val", "test"):
            rec = dict(self.best_recorder[split])
            rec.update({"time": stamp, "seed": self.cfg.trainer.seed,
                        "best_model_from": split, "version": self.cfg.trainer.version})
            append_best_record(path, rec)

    # ---- main loop ----

    def train(self) -> Dict[str, float]:
        if self.state is None:
            raise ValueError("train() needs a TrainState")
        not_improved = 0
        log: Dict[str, float] = {}
        for epoch in range(self.start_epoch, self.cfg.trainer.epochs + 1):
            t0 = time.time()
            log = {"epoch": epoch}
            profiler = None
            if epoch == self.cfg.trainer.profile_epoch:
                profiler = self._start_profile()
            log.update(self._train_epoch(epoch))
            if profiler is not None:
                self._stop_profile(profiler)
            self._composite(log)
            self._record_best(log)
            for k, v in log.items():
                self.logger.info(f"\t{k:24s}: {v}")
            self.metrics.write({"event": "epoch", **log, "wall_s": time.time() - t0})

            best = False
            if self.mnt_metric in log:
                if self._improved(log):
                    self.mnt_best = log[self.mnt_metric]
                    not_improved = 0
                    best = True
                else:
                    not_improved += 1
                if not_improved > self.cfg.trainer.early_stop:
                    self.logger.info(f"early stop after {self.cfg.trainer.early_stop} "
                                     f"epochs without improvement")
                    break
            lr_metric = log.get("val_" + self.cfg.lr_monitor_metric)
            set_lr_scale(self.state.opt, self.scheduler.update(epoch, lr_metric))

            if epoch % self.cfg.trainer.save_period == 0:
                self._save(epoch, best)
        self.ckpt.wait()  # drain any in-flight async save before returning
        self._print_best_to_file()
        return log

    def _start_profile(self):
        trace_dir = self.cfg.trainer.profile_dir or os.path.join(self.result_dir, "profile")
        os.makedirs(trace_dir, exist_ok=True)
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
        prof.trace_dir = trace_dir
        self.logger.info(f"torch.profiler trace -> {trace_dir}")
        return prof

    def _stop_profile(self, prof) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.stop()
        prof.export_chrome_trace(os.path.join(prof.trace_dir, "trace.json"))

    def _train_epoch(self, epoch: int) -> Dict[str, float]:
        raise NotImplementedError


class PretrainTrainer(BaseTrainer):
    """Stage-1 contrastive pretraining (PTrainer parity)."""

    def __init__(self, cfg, model, tokenizer, state, train_loader, val_loader,
                 test_loader=None, **kw):
        super().__init__(cfg, model, tokenizer, state=state, **kw)
        self.loaders = {"train": train_loader, "val": val_loader, "test": test_loader}
        self.train_step = make_train_step(model, state.opt, cfg.trainer.seed, task="pretrain",
                                          mesh=self.mesh)
        self.eval_step = make_eval_step(model, mesh=self.mesh)

    def _batches(self, loader):
        prefetch = self.cfg.data.prefetch
        return device_prefetch(Prefetcher(rank_view(loader, self.mesh), prefetch),
                               self.device, prefetch, mesh=self.mesh)

    def _run_split(self, loader) -> Dict[str, float]:
        sums, n = {}, 0
        for batch, _ in self._batches(loader):
            _accumulate(sums, self.eval_step(self.state, batch))
            n += 1
        return _epoch_means(sums, n)

    def _train_epoch(self, epoch: int) -> Dict[str, float]:
        sums, n = {}, 0
        loader = self.loaders["train"]
        loader.set_epoch(epoch - 1)
        for i, (batch, _) in enumerate(self._batches(loader)):
            metrics = self.train_step(self.state, batch)
            _accumulate(sums, metrics)
            n += 1
            if i % self.cfg.trainer.log_interval == 0:
                self.logger.info(f"epoch {epoch} step {i}: "
                                 f"all_loss {_host_scalar(metrics['all_loss']):.4f}")
        log = {f"train_{k}": v for k, v in _epoch_means(sums, n).items()}
        log.update({f"val_{k}": v for k, v in self._run_split(self.loaders["val"]).items()})
        if self.loaders["test"] is not None and epoch % self.cfg.trainer.test_every == 0:
            log.update({f"test_{k}": v
                        for k, v in self._run_split(self.loaders["test"]).items()})
        return log


class FinetuneTrainer(BaseTrainer):
    """Stage-2 report generation (FTrainer parity).

    ``train_loaders``: (loader_with_indication, loader_without), either may be
    None; ``eval_loaders``: {split: (with, without)}. ``graphs`` goes to
    ``make_generate_step`` (None captures the decode steps on the card;
    False runs them eagerly)."""

    def __init__(self, cfg, model, tokenizer, eval_loaders, state=None,
                 train_loaders=(None, None), graphs=None, **kw):
        super().__init__(cfg, model, tokenizer, state=state, **kw)
        self.train_loaders = train_loaders
        self.eval_loaders = eval_loaders
        if state is not None:
            self.step_inc, self.step_noinc = (
                make_train_step(model, state.opt, cfg.trainer.seed, with_indication=flag,
                                mesh=self.mesh)
                for flag in (True, False))
        self.gen_inc, self.gen_noinc = (
            make_generate_step(model, tokenizer, cfg.decode, cfg.data.max_seq_len,
                               with_indication=flag, device=self.device, graphs=graphs,
                               mesh=self.mesh)
            for flag in (True, False))
        self.pred_csv = {s: PredictionCSV(os.path.join(self.result_dir, f"{s}_prediction.csv"))
                         for s in ("val", "test")}
        self.stats: Dict[str, float] = {}

    def _train_epoch(self, epoch: int) -> Dict[str, float]:
        sums, n = {}, 0
        prefetch = self.cfg.data.prefetch
        for loader, step in ((self.train_loaders[0], self.step_inc),
                             (self.train_loaders[1], self.step_noinc)):
            if loader is None:
                continue
            loader.set_epoch(epoch - 1)
            batches = device_prefetch(Prefetcher(rank_view(loader, self.mesh), prefetch),
                                      self.device, prefetch, mesh=self.mesh)
            for i, (batch, _) in enumerate(batches):
                metrics = step(self.state, batch)
                _accumulate(sums, metrics)
                n += 1
                if i % self.cfg.trainer.log_interval == 0:
                    self.logger.info(f"epoch {epoch} step {i}: "
                                     f"lm {_host_scalar(metrics['lm']):.4f}")
        log = {f"train_{k}": v for k, v in _epoch_means(sums, n).items()}
        for split in ("val", "test"):
            res = self.evaluate(split, epoch_label=str(epoch))
            log.update({f"{split}_{k}": v for k, v in res.items()})
        return log

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
            batches = staged_batches(loader, self.device, prefetch, mesh=self.mesh)
            for host, seqs in generate_stream(gen, batches, mesh=self.mesh):
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
        if ids and self.main:
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
