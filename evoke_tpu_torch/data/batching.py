"""Host-side prefetch for serving (the port's counterpart of the prefetchers in
evoke_tpu/data/batching.py:142-200): a background thread pulls loader batches
and ``device_prefetch`` copies them from pinned host memory to the card with
``non_blocking=True``, ``depth`` batches ahead of the consumer."""

from __future__ import annotations

import collections
import queue
import threading
from typing import List

import numpy as np
import torch


def to_device(batch, device: torch.device):
    """Split a loader batch into (device tensors, host extras): '_'-prefixed
    keys stay on the host. On the card the copy is pinned + non_blocking."""
    host = {k: v for k, v in batch.items() if k.startswith("_")}
    dev = {}
    for k, v in batch.items():
        if k.startswith("_"):
            continue
        t = torch.as_tensor(np.asarray(v))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        else:
            t = t.to(device)
        dev[k] = t
    return dev, host


def device_prefetch(batches, device: torch.device, depth: int = 2):
    """Yield (device_batch, host_extras) with up to ``depth`` copies in flight."""
    pending: "collections.deque" = collections.deque()
    for batch in batches:
        pending.append(to_device(batch, device))
        if len(pending) > depth:
            yield pending.popleft()
    while pending:
        yield pending.popleft()


class Prefetcher:
    """Background-thread prefetch of an iterable of batches."""

    def __init__(self, iterable, depth: int = 2):
        self.iterable = iterable
        self.depth = depth

    def __iter__(self):
        q: queue.Queue = queue.Queue(maxsize=self.depth)
        sentinel = object()
        err: List[BaseException] = []

        def producer():
            try:
                for item in self.iterable:
                    q.put(item)
            except BaseException as e:  # re-raised on the consumer side
                err.append(e)
            finally:
                q.put(sentinel)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is sentinel:
                t.join(timeout=10)
                if err:
                    raise err[0]
                return
            yield item
