"""The device trace of a traced run: torch.profiler's CUDA activity over a
sub-window, read from its Kineto events, and the host spans the harness
records beside it.

``Profile`` starts the profiler (CUDA activity only: recording the host's
ops as well slows the eager step it measures) and puts a marker kernel on
the stream at a known host time, so the device's timeline can be laid
over the host spans. ``read`` reduces the events to what the readers and
the result's ``breakdown`` need: the busy time (the union of every device
interval), kernel time by name, and the idle gaps, each named by the
innermost host span open at its middle.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np

MARKER = "spin_kernel"      # the kernel of torch.cuda._sleep
TOP = 10


class Profile:
    """One profiled sub-window: ``start`` and ``stop`` at tick boundaries,
    ``events`` after."""

    def __init__(self):
        self.prof = None
        self.t0 = self.t1 = None
        self.marks: List[int] = []

    def _mark(self):
        import torch
        torch.cuda.synchronize()
        self.marks.append(time.perf_counter_ns())
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()

    @staticmethod
    def warm() -> None:
        """Set-up of a traced run: the profiler's first start (its CUDA
        tracing's initialization) happens here, not in the window."""
        import torch
        p = Profile()
        p.start()
        torch.zeros(1, device="cuda").add_(1)
        p.stop()
        p.events()

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        # the tracing's first and last events are the likeliest lost: the
        # markers sit behind and before other work
        torch.zeros(1, device="cuda").add_(1)
        self._mark()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        import torch
        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self._mark()
        torch.zeros(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)

    def events(self) -> List[tuple]:
        """(name, start_ns, end_ns) of every CUDA event, start order."""
        import torch
        from torch.autograd import DeviceType
        out, names = [], {}
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() != DeviceType.CUDA or e.is_async():
                continue
            raw = e.name()
            name = names.get(raw)
            if name is None:
                name = names[raw] = torch._C._demangle(raw) \
                    if len(raw) > 1 else raw
            out.append((name, e.start_ns(), e.end_ns()))
        out.sort(key=lambda x: x[1])
        return out


def _union(intervals: np.ndarray) -> np.ndarray:
    """Merged [start, end] intervals of sorted ones."""
    merged = []
    for s, e in intervals:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return np.asarray(merged, np.float64).reshape(-1, 2)


def _short(name: str, n: int = 120) -> str:
    return name if len(name) <= n else name[:n - 3] + "..."


def read(events: List[tuple], marks: List[int], spans: List[tuple],
         window_s: float) -> Optional[dict]:
    """Busy seconds, kernel seconds by name, and the idle gaps by host
    activity of one profiled sub-window. ``marks`` are the host times (ns)
    at which the two marker kernels were launched, ``spans`` the host
    spans (name, t0_ns, t1_ns, depth). None when the trace holds no
    device activity besides the markers."""
    mk = [e for e in events if MARKER in e[0]]
    work = [e for e in events if MARKER not in e[0]]
    if len(mk) >= 2:
        # the window lies between the two markers: the ops that pad them
        # ran outside it
        work = [e for e in work if mk[0][2] <= e[1] and e[2] <= mk[-1][1]]
    if not work:
        return None
    by_name: Dict[str, float] = {}
    for name, s, e in work:
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e9
    busy = _union(np.asarray([(s, e) for _, s, e in work], np.float64))
    busy_s = float((busy[:, 1] - busy[:, 0]).sum() / 1e9)
    gaps: Dict[str, float] = {}
    offset = None
    if not mk or len(marks) < 2:
        # both markers lost with other events: the gaps are not laid over
        # the host spans
        idle = (busy[1:, 0] - busy[:-1, 1]).sum() / 1e9 if len(busy) > 1 \
            else 0.0
        gaps["not aligned (marker kernels lost)"] = float(idle)
    else:
        # host ns = device ns - offset, from a marker that survived; the
        # window runs between the markers (the device's first and last
        # work where one is lost)
        if len(mk) >= 2 or mk[0][1] < busy[0, 0]:
            offset = mk[0][1] - marks[0]
            lo = mk[0][2]
        else:
            offset = mk[0][1] - marks[1]
            lo = busy[0, 0]
        hi = mk[-1][1] if (len(mk) >= 2 or mk[0][1] >= busy[-1, 1]) \
            else busy[-1, 1]
        edges = np.concatenate([[lo], busy.ravel(), [hi]]).reshape(-1, 2)
        edges = edges[edges[:, 1] > edges[:, 0]]
        # one sweep over span opens (0), gap middles (1) and span closes
        # (2): the innermost open span at a middle is the top of the stack
        sweep = [(t0, 0, i) for i, (_, t0, _, _) in enumerate(spans)]
        sweep += [(t1, 2, i) for i, (_, _, t1, _) in enumerate(spans)]
        sweep += [((s + e) / 2 - offset, 1, i)
                  for i, (s, e) in enumerate(edges)]
        sweep.sort()
        stack: List[int] = []
        for _, kind, i in sweep:
            if kind == 0:
                stack.append(i)
            elif kind == 2:
                if i in stack:
                    stack.remove(i)
            else:
                label = spans[stack[-1]][0] if stack else "harness loop"
                s, e = edges[i]
                gaps[label] = gaps.get(label, 0.0) + float(e - s) / 1e9
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return {"busy_s": busy_s, "window_s": window_s, "by_name": by_name,
            "clock_offset_ns": offset, "markers": len(mk),
            "device_ops": [[_short(k), v] for k, v in top],
            "idle_gaps": [[k, v] for k, v in
                          sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]]}
