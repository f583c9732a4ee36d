"""Pipelined report-generation serving (port of evoke_tpu/serve.py).

- ``generate_stream``: run (device_batch, host_extras) pairs through a
  generate step with up to ``depth`` results held back, syncing (copying to
  the host) on dequeue, yielding in submission order. On the card the step
  returns while the device still runs its batch's last cache phase
  (``decode/beam.BeamLoop`` reads nothing after it), so the next batch's
  encoder is queued behind it.
- ``staged_batches``: the servers' (and the eval paths') input side, from
  the loader to batches on the device.
- ``ReportServer``: model + tokenizer -> ``serve(loader)`` returning one
  record per study plus throughput and batch-latency stats. The continuous
  engine's server is ``decode/continuous.ContinuousServer``.

Spans (``core/profiling``), each with its batch's number (``batch``):
``serve`` (the call), ``serve.loader_wait``, ``serve.stage``,
``serve.read`` and ``serve.records``; ``generate.*`` and ``decode.*`` come
from the generate step and its loop.
"""

from __future__ import annotations

import itertools
import statistics
import time
from collections import deque
from typing import Any, Dict, Iterable, Iterator, List, Tuple

import numpy as np

from evoke_tpu_torch.core.device import resolve_device
from evoke_tpu_torch.core.profiling import span, spans
from evoke_tpu_torch.data.batching import (Prefetcher, device_prefetch, rank_view,
                                          stage_batch)
from evoke_tpu_torch.models.fusion import max_partners_in
from evoke_tpu_torch.parallel.collectives import all_gather_batch
from evoke_tpu_torch.train.steps import make_generate_step

# the reference substitutes a canned line for empty generations
EMPTY_REPORT = "there is no evidence of pulmonary."


def generate_stream(gen, batches: Iterable[Tuple[Dict, Dict]],
                    depth: int = 2, mesh=None) -> Iterator[Tuple[Dict, np.ndarray]]:
    """Yield ``(host_extras, seqs)`` in order, up to ``depth`` results in flight.

    Under a ``mesh`` ``gen`` returns this rank's rows; each result is
    gathered over the rank's dp group at dequeue (on the device), so every
    rank yields the global batch's ``seqs`` (the mp ranks of a dp group
    decode the same rows). All ranks issue their encoder
    gathers and these in one order: the same loader, the same depth.

    ``gen`` reuses its beam loop's buffers for every batch. What is held back
    here is each batch's ``seqs``, a tensor of its own that ``gen`` makes on
    the current stream before it returns; the next batch's copies into those
    buffers are queued on the same stream after it, so stream order alone
    keeps a held result from being overwritten.

    A batch whose host extras carry ``_batch`` (``staged_batches``) gives
    its number to the spans of its step and to its ``serve.read``."""
    def read(out, host):
        with span("serve.read", **batch_ids(host)):
            if mesh is not None:
                out = all_gather_batch(out, mesh)
            return out.cpu().numpy()

    q: deque = deque()
    for dev, host in batches:
        with spans.tag(**batch_ids(host)):
            q.append((host, gen(dev)))
        while len(q) > depth:
            h, out = q.popleft()
            yield h, read(out, h)
    while q:
        h, out = q.popleft()
        yield h, read(out, h)


def batch_ids(host) -> Dict[str, int]:
    """A staged batch's span ids (none for a batch staged elsewhere)."""
    return {"batch": host["_batch"]} if "_batch" in host else {}


def host_valid(b):
    """A loader batch with a host copy of its ``valid`` (``_valid``) beside
    the copy that goes to the device, so the host never reads it back."""
    b = dict(b)
    b["_valid"] = np.asarray(b["valid"])
    return b


def check_partners(b, max_partners) -> None:
    """Raise on a loader batch (with ``_valid``) with an anchor whose
    same-study partner views exceed ``max_partners`` (grouped fusion
    attention would silently drop them); None checks nothing."""
    if max_partners is not None:
        got = max_partners_in(b["pids"], b["_valid"], np.shape(b["ids"])[0])
        if got > max_partners:
            raise ValueError(
                f"batch has an anchor with {got} same-study partner views, above "
                f"model.fusion_max_partners={max_partners}: grouped fusion attention "
                "would silently drop views")


def staged_batches(loader, device, depth: int = 2, max_partners=None, mesh=None):
    """``data/batching.device_prefetch`` of ``loader`` (its rank's view under
    a dp ``mesh``) pulled on a ``Prefetcher`` thread ``depth`` ahead: (device
    batch, host extras) with ``_valid`` on the host. Taking a batch from the
    prefetcher is the span ``serve.loader_wait``; staging it (``host_valid``,
    ``check_partners``, pinning and issuing the copy) is ``serve.stage``. The
    host extras gain ``_batch`` (the batch's number in this pass, its spans'
    ``batch``) and ``_t_stage`` (``time.perf_counter()`` at the stage's
    start)."""
    def taken():
        prefetched = iter(Prefetcher(rank_view(loader, mesh), depth))
        for i in itertools.count():
            with span("serve.loader_wait", batch=i):
                b = next(prefetched, None)
            if b is None:
                return
            yield {**b, "_batch": i}

    def stage(b, device, mesh):
        with span("serve.stage", batch=b["_batch"]) as site:
            b = host_valid(b)
            check_partners(b, max_partners)
            dev, host = stage_batch(b, device, mesh)
            host["_t_stage"] = site.t0 / 1e9
        return dev, host

    return device_prefetch(taken(), device, depth, mesh, stage)


class ReportServer:
    """Batched, pipelined report generation over a model holding its weights.

    Loader batches are dicts of host arrays in the eval-loader layout
    (anchors first, then auxiliary views; ``ids`` gives the anchor count)
    plus host-side ``_image_ids`` and optional ``_gts``."""

    def __init__(self, model, tokenizer, decode_cfg, max_seq_len: int = 100,
                 depth: int = 2, device="cuda", graphs=None, topk_hook=None, mesh=None):
        """``graphs``: None captures the decode steps into CUDA graphs on a CUDA
        device and runs them eagerly on the CPU; False runs them eagerly on
        either (for an A/B on the card). ``topk_hook``: the load-testing hook of
        ``train/steps.make_generate_step`` on the fused tail; it reads the
        loader batches' device entries (a ``target_len`` [n_anchor], say).

        ``mesh`` (a ``core/mesh.Mesh``; the device is then the rank's): every
        rank iterates the same loader, copies its rows of each batch, encodes
        its images and decodes its anchors (K1 and K2 at its rows on a pure-dp
        mesh); the tokens are gathered over the dp group before the records
        are made, so every rank returns all records in loader order and the
        stats count global reports. With mp > 1 the model is sharded over it
        (``parallel/tp.shard_params_tp``), K1 and K2 are declined and the
        decode steps run eagerly: ``stats["captured"]`` is False."""
        self.tokenizer = tokenizer
        self.depth = depth
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else resolve_device(device)
        # grouped fusion attention truncates partners beyond its static bound;
        # serve() checks every batch host-side and fails loudly instead
        self._max_partners = getattr(model, "fusion_max_partners", None)
        self._gen = {
            flag: make_generate_step(model, tokenizer, decode_cfg, max_seq_len,
                                     with_indication=flag, serving=True,
                                     device=self.device, graphs=graphs,
                                     topk_hook=topk_hook, mesh=mesh)
            for flag in (True, False)}
        self.stats: Dict[str, float] = {}

    def serve(self, loader, with_indication: bool = False,
              prefetch: int = 2) -> List[Dict[str, Any]]:
        """Generate a report for every valid study in ``loader``; returns
        records ``{"id", "report", "gt"?}`` in loader order and fills
        ``self.stats`` (wall-clock throughput, p50 and p90 batch latency, and
        ``capture_s``: the seconds of ``wall_s`` this call spent capturing the
        decode steps of batch shapes it met for the first time). A batch's
        latency runs from the start of its ``serve.stage`` to its ``seqs`` on
        the host."""
        gen = self._gen[with_indication]
        captured_before = sum(loop.capture_s for loop, _ in gen.loops.values())
        records: List[Dict[str, Any]] = []
        latencies: List[float] = []
        with span("serve"):
            batches = staged_batches(loader, self.device, prefetch, self._max_partners,
                                     self.mesh)
            t0 = time.perf_counter()
            for host, seqs in generate_stream(gen, batches, self.depth, self.mesh):
                latencies.append(time.perf_counter() - host["_t_stage"])
                valid = host["_valid"]
                n_valid = int(np.count_nonzero(valid[:len(host["_image_ids"])]))
                with span("serve.records", studies=n_valid, **batch_ids(host)):
                    texts = self.tokenizer.decode_batch(seqs.tolist())
                    gts = host.get("_gts")
                    for i, (iid, text) in enumerate(zip(host["_image_ids"], texts)):
                        if not valid[i]:
                            continue
                        rec: Dict[str, Any] = {"id": iid,
                                               "report": text if text.strip() else EMPTY_REPORT}
                        if gts is not None:
                            rec["gt"] = gts[i]
                        records.append(rec)
            wall = time.perf_counter() - t0
        self.stats = {
            "reports": float(len(records)),
            "batches": float(len(latencies)),
            "wall_s": wall,
            "reports_per_s": len(records) / wall if wall > 0 else float("nan"),
            "batch_latency_p50_s": statistics.median(latencies) if latencies else float("nan"),
            "batch_latency_p90_s": (float(np.percentile(latencies, 90)) if latencies
                                    else float("nan")),
            "capture_s": sum(loop.capture_s for loop, _ in gen.loops.values()) - captured_before,
            "captured": gen.captured,
        }
        return records
