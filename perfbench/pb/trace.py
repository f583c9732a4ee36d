"""A traced window under ``torch.profiler``, reduced to what the metrics read.

Only CUDA activity is recorded: the device's operations and the host's CUDA
calls (recording every host operator as well lengthens the host's share of
the window it measures). The window runs from the end of a device synchronization before the
traced work to the end of one after it, on the profiler's clock. The
device's busy time is the union of the intervals of the operations that ran
on it (kernels, copies, sets) inside the window: overlapping streams are
counted once.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Sequence, Tuple

import torch

SYNC = "cudaDeviceSynchronize"
NO_CALL = "host work between CUDA calls"


class Trace:
    """Device operations [(name, start_ns, end_ns)], the host's CUDA calls the
    same, and the window (start_ns, end_ns)."""

    def __init__(self, device_ops, host_ops, window):
        self.device_ops: List[Tuple[str, int, int]] = device_ops
        self.host_ops: List[Tuple[str, int, int]] = host_ops
        self.window = window
        self.intervals = self._union()

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def _union(self) -> List[Tuple[int, int]]:
        w0, w1 = self.window
        spans = sorted((max(s, w0), min(e, w1)) for _, s, e in self.device_ops
                       if e > w0 and s < w1)
        out: List[List[int]] = []
        for s, e in spans:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.intervals) / 1e9

    def kernels(self, fragments: Sequence[str]) -> Tuple[float, int]:
        """(seconds, count) of the device operations inside the window whose
        name holds one of ``fragments``."""
        w0, w1 = self.window
        hits = [(s, e) for n, s, e in self.device_ops
                if s >= w0 and e <= w1 and any(f in n for f in fragments)]
        return sum(e - s for s, e in hits) / 1e9, len(hits)

    def top_device_ops(self, n: int = 10) -> List[List]:
        w0, w1 = self.window
        total: Dict[str, int] = {}
        for name, s, e in self.device_ops:
            if s >= w0 and e <= w1:
                total[name] = total.get(name, 0) + (e - s)
        ranked = sorted(total.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:200], ns / 1e9] for name, ns in ranked]

    def idle_gaps(self, n: int = 10) -> List[List]:
        """The longest stretches of the window with nothing on the device,
        each named by the host's CUDA call running at its middle."""
        w0, w1 = self.window
        gaps, at = [], w0
        for s, e in self.intervals:
            if s > at:
                gaps.append((at, s))
            at = max(at, e)
        if w1 > at:
            gaps.append((at, w1))
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for s, e in gaps[:n]:
            mid = (s + e) // 2
            running = [(he - hs, name) for name, hs, he in self.host_ops if hs <= mid <= he]
            name = min(running)[1] if running else NO_CALL
            out.append([name[:200], (e - s) / 1e9])
        return out


def traced(fn: Callable[[], object], device) -> Tuple[object, Trace]:
    """Run ``fn`` under the profiler between two device synchronizations;
    returns its result and the window's trace. Off the card there is no
    device to record: the trace is empty and its window the host's."""
    from torch.profiler import ProfilerActivity, profile

    if torch.device(device).type != "cuda":
        t0 = time.perf_counter_ns()
        out = fn()
        return out, Trace([], [], (t0, time.perf_counter_ns()))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize(device)
        out = fn()
        torch.cuda.synchronize(device)
    device_ops, host_ops, syncs = [], [], []
    for e in prof.profiler.kineto_results.events():
        name, s = e.name(), e.start_ns()
        end = s + e.duration_ns()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            device_ops.append((name, s, end))
        else:
            host_ops.append((name, s, end))
            if name == SYNC:
                syncs.append(end)
    if len(syncs) < 2:
        raise RuntimeError(f"the profiler recorded {len(syncs)} {SYNC} calls, not the "
                           "two that bound the window")
    return out, Trace(device_ops, host_ops, (min(syncs), max(syncs)))
