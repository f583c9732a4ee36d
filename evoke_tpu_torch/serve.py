"""Pipelined report-generation serving (port of evoke_tpu/serve.py).

- ``generate_stream``: run (device_batch, host_extras) pairs through a
  generate step with up to ``depth`` results held back, syncing (copying to
  the host) on dequeue, yielding in submission order. On the card the step
  returns while the device still runs its batch's last cache phase
  (``decode/beam.BeamLoop`` reads nothing after it), so the next batch's
  encoder is queued behind it.
- ``ReportServer``: model + tokenizer -> ``serve(loader)`` returning one
  record per study plus throughput and batch-latency stats.
"""

from __future__ import annotations

import statistics
import time
from collections import deque
from typing import Any, Dict, Iterable, Iterator, List, Tuple

import numpy as np

from evoke_tpu_torch.core.device import resolve_device
from evoke_tpu_torch.data.batching import Prefetcher, device_prefetch
from evoke_tpu_torch.models.fusion import max_partners_in
from evoke_tpu_torch.train.steps import make_generate_step

# the reference substitutes a canned line for empty generations
EMPTY_REPORT = "there is no evidence of pulmonary."


def generate_stream(gen, batches: Iterable[Tuple[Dict, Dict]],
                    depth: int = 2) -> Iterator[Tuple[Dict, np.ndarray]]:
    """Yield ``(host_extras, seqs)`` in order, up to ``depth`` results in flight.

    ``gen`` reuses its beam loop's buffers for every batch. What is held back
    here is each batch's ``seqs``, a tensor of its own that ``gen`` makes on
    the current stream before it returns; the next batch's copies into those
    buffers are queued on the same stream after it, so stream order alone
    keeps a held result from being overwritten."""
    q: deque = deque()
    for dev, host in batches:
        q.append((host, gen(dev)))
        while len(q) > depth:
            h, out = q.popleft()
            yield h, out.cpu().numpy()
    while q:
        h, out = q.popleft()
        yield h, out.cpu().numpy()


def with_host_valid(batches):
    """Keep a host copy of each loader batch's ``valid`` (``_valid``) beside
    the copy that goes to the device, so the host never reads it back."""
    for b in batches:
        b = dict(b)
        b["_valid"] = np.asarray(b["valid"])
        yield b


class ReportServer:
    """Batched, pipelined report generation over a model holding its weights.

    Loader batches are dicts of host arrays in the eval-loader layout
    (anchors first, then auxiliary views; ``ids`` gives the anchor count)
    plus host-side ``_image_ids`` and optional ``_gts``."""

    def __init__(self, model, tokenizer, decode_cfg, max_seq_len: int = 100,
                 depth: int = 2, device="cuda", graphs=None):
        """``graphs``: None captures the decode steps into CUDA graphs on a CUDA
        device and runs them eagerly on the CPU; False runs them eagerly on
        either (for an A/B on the card)."""
        self.tokenizer = tokenizer
        self.depth = depth
        self.device = resolve_device(device)
        # grouped fusion attention truncates partners beyond its static bound;
        # serve() checks every batch host-side and fails loudly instead
        self._max_partners = getattr(model, "fusion_max_partners", None)
        self._gen = {
            flag: make_generate_step(model, tokenizer, decode_cfg, max_seq_len,
                                     with_indication=flag, serving=True,
                                     device=self.device, graphs=graphs)
            for flag in (True, False)}
        self.stats: Dict[str, float] = {}

    def serve(self, loader, with_indication: bool = False,
              prefetch: int = 2) -> List[Dict[str, Any]]:
        """Generate a report for every valid study in ``loader``; returns
        records ``{"id", "report", "gt"?}`` in loader order and fills
        ``self.stats`` (wall-clock throughput, median batch latency, and
        ``capture_s``: the seconds of ``wall_s`` this call spent capturing the
        decode steps of batch shapes it met for the first time)."""
        gen = self._gen[with_indication]
        captured_before = sum(loop.capture_s for loop, _ in gen.loops.values())
        records: List[Dict[str, Any]] = []

        def checked(batches):
            for b in with_host_valid(batches):
                if self._max_partners is not None:
                    got = max_partners_in(b["pids"], b["valid"], np.shape(b["ids"])[0])
                    if got > self._max_partners:
                        raise ValueError(
                            f"batch has an anchor with {got} same-study partner views, "
                            f"above model.fusion_max_partners={self._max_partners}: "
                            "grouped fusion attention would silently drop views")
                yield b

        def stamped(batches):
            for dev, host in batches:
                host["_t_submit"] = time.perf_counter()
                yield dev, host

        batches = stamped(device_prefetch(checked(Prefetcher(loader, prefetch)),
                                          self.device, prefetch))
        latencies: List[float] = []
        t0 = time.perf_counter()
        for host, seqs in generate_stream(gen, batches, self.depth):
            latencies.append(time.perf_counter() - host["_t_submit"])
            texts = self.tokenizer.decode_batch(seqs.tolist())
            gts = host.get("_gts")
            valid = host["_valid"]
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
            "capture_s": sum(loop.capture_s for loop, _ in gen.loops.values()) - captured_before,
        }
        return records
