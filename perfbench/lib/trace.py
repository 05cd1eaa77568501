"""The device trace of a short steady stretch, read from ``torch.profiler``.

``profile(stretch)`` runs ``stretch()`` (which ends in a synchronisation)
under the profiler, with CPU and CUDA activity, and reduces the trace to:
the stretch's length on the host clock (``window_s``); the seconds in which
some operation ran on the device (``busy_s``: the union of the device
events' intervals, kernels and copies alike); the device seconds of the
kernels whose names hold given substrings (``kernel_seconds``); and a
breakdown: the device operations that took most time, and the longest
idle gaps labelled with the host operation running at their middle.
Nothing is written to disk.
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Callable, Dict, List, Sequence, Tuple

TOP = 10
NAME_CHARS = 120


class TraceSummary:
    def __init__(self, window_s: float, device: List[Tuple[str, float, float]],
                 host: List[Tuple[str, float, float]]):
        self.window_s = window_s
        self.device = device  # (name, start_us, end_us)
        self.host = host
        merged = []
        for _, s, e in sorted(device, key=lambda ev: ev[1]):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        self.busy_s = sum(e - s for s, e in merged) / 1e6
        self._merged = merged
        self.work: list = []  # what the stretch ran, for the metric readers

    def kernel_seconds(self, substrings: Sequence[str]) -> float:
        return sum(e - s for name, s, e in self.device
                   if any(sub in name for sub in substrings)) / 1e6

    def breakdown(self) -> Dict[str, list]:
        by_name: Dict[str, float] = defaultdict(float)
        for name, s, e in self.device:
            by_name[name[:NAME_CHARS]] += (e - s) / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
        gaps = sorted(((b[0] - a[1], a[1], b[0]) for a, b in zip(self._merged, self._merged[1:])),
                      reverse=True)[:TOP]
        labelled = []
        for length, s, e in gaps:
            mid = (s + e) / 2
            running = [(hs, name) for name, hs, he in self.host if hs <= mid <= he]
            label = max(running)[1] if running else "no host operation"
            labelled.append([label[:NAME_CHARS], length / 1e6])
        return {"device_ops": [[n, t] for n, t in ops], "idle_gaps": labelled}


def profile(stretch: Callable[[], None]) -> TraceSummary:
    """Trace ``stretch()``; it must end with the device synchronised."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        stretch()
        window_s = time.perf_counter() - t0
    device, host = [], []
    for ev in prof.events():
        rec = (ev.name, ev.time_range.start, ev.time_range.end)
        (device if ev.device_type == DeviceType.CUDA else host).append(rec)
    return TraceSummary(window_s, device, host)
