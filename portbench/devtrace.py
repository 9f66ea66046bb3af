"""The card's trace over the measured window, from ``torch.profiler``.

Only the CUDA activity is recorded: the card's kernels, copies and sets,
with their start and end on the profiler's clock (nanoseconds since the
epoch).  What the host was doing in an idle gap is read from the spans of
the port's ``Tracer`` (``time.perf_counter`` seconds), mapped onto that
clock by one pair of readings taken when the window opens.
"""

from __future__ import annotations

import time
from collections import defaultdict

import numpy as np

TOP = 10  # entries of each breakdown list


class DeviceTrace:
    """Records the card from :meth:`start` to :meth:`stop`."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self.events: list = []  # (name, start_ns, end_ns) of every device event

    def start(self) -> None:
        self._prof.start()

    def stop(self) -> None:
        from torch.autograd import DeviceType

        self._prof.stop()
        self.events = [
            (ev.name(), ev.start_ns(), ev.start_ns() + ev.duration_ns())
            for ev in self._prof.profiler.kineto_results.events()
            if ev.device_type() == DeviceType.CUDA and ev.duration_ns() > 0
        ]
        self._prof = None


def clock_pair() -> tuple[float, int]:
    """(``perf_counter`` seconds, epoch nanoseconds) read together."""
    a = time.time_ns()
    p = time.perf_counter()
    b = time.time_ns()
    return p, (a + b) // 2


def is_kernel(name: str) -> bool:
    return not (name.startswith("Memcpy") or name.startswith("Memset"))


def union(intervals) -> list[tuple[int, int]]:
    out: list[list[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


class WindowTrace:
    """The card's events inside ``[t0_ns, t1_ns]`` and what they add up to."""

    def __init__(self, events, t0_ns: int, t1_ns: int):
        self.t0, self.t1 = t0_ns, t1_ns
        self.events = [(n, max(s, t0_ns), min(e, t1_ns)) for n, s, e in events
                       if e > t0_ns and s < t1_ns]
        self.busy = union((s, e) for _, s, e in self.events)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy) / 1e9

    def kernel_s(self) -> float:
        return sum(e - s for n, s, e in self.events if is_kernel(n)) / 1e9

    def count(self, prefix: str) -> int:
        return sum(1 for n, _, _ in self.events if n.startswith(prefix))

    def device_ops(self) -> list:
        by = defaultdict(int)
        for n, s, e in self.events:
            by[n] += e - s
        top = sorted(by.items(), key=lambda kv: -kv[1])[:TOP]
        return [[n, ns / 1e9] for n, ns in top]

    def gaps(self) -> list[tuple[int, int]]:
        edges = [self.t0] + [x for se in self.busy for x in se] + [self.t1]
        return [(s, e) for s, e in zip(edges[0::2], edges[1::2]) if e > s]

    def idle_gaps(self, spans, clock: tuple[float, int]) -> list:
        """Idle seconds by what the host was doing: the kind of the
        innermost span of the port's tracers open at each gap's middle
        (``harness`` outside every span), the largest ``TOP``."""
        p0, ns0 = clock
        ivs = sorted(((int(ns0 + (s.t0 - p0) * 1e9), int(ns0 + (s.t1 - p0) * 1e9), s.kind)
                      for s in spans if s.t1 is not None), key=lambda x: x[0])
        starts = np.array([s for s, _, _ in ivs], dtype=np.int64)
        by = defaultdict(int)
        for gs, ge in self.gaps():
            mid = (gs + ge) // 2
            label = "harness"
            j = int(np.searchsorted(starts, mid, side="right")) - 1
            # the innermost open span is the latest started one still open
            while j >= 0:
                s, e, kind = ivs[j]
                if e >= mid:
                    label = kind
                    break
                j -= 1
            by[label] += ge - gs
        top = sorted(by.items(), key=lambda kv: -kv[1])[:TOP]
        return [[n, ns / 1e9] for n, ns in top]
