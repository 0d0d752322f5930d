"""A traced sub-window: ``torch.profiler`` over whole steps, reduced in
memory to a summary (device intervals by name, the window, what the host
was doing in each idle gap). Nothing is written to disk."""
from __future__ import annotations

import bisect
import dataclasses
import time
from collections import defaultdict
from typing import Callable, Dict, List, Tuple

from bench import stats

WINDOW_SPAN = "bench.window"
# longest idle gaps named by a host op; shorter ones are only summed
NAMED_GAPS = 400


@dataclasses.dataclass
class TraceSummary:
    """Device operations ``(name, start_us, end_us)`` of the traced steps,
    the steps' host-clock window, how many steps it held, the program's
    counters over them, and idle device time by the host op open."""
    ops: List[Tuple[str, float, float]]
    window_s: float
    steps: int
    counters: Dict[str, float]
    idle_by_host: Dict[str, float]

    @property
    def busy_s(self) -> float:
        return stats.union_length((s, e) for _, s, e in self.ops) / 1e6

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s

    def device_s(self, parts) -> float:
        """Summed device time of the ops whose name contains one of ``parts``."""
        return sum(e - s for n, s, e in self.ops if any(p in n for p in parts)) / 1e6

    def by_name(self) -> Dict[str, float]:
        out: Dict[str, float] = defaultdict(float)
        for n, s, e in self.ops:
            out[n] += (e - s) / 1e6
        return out

    def breakdown(self) -> Dict:
        top = sorted(self.by_name().items(), key=lambda kv: -kv[1])[:10]
        idle = sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n[:120], s] for n, s in top],
                "idle_gaps": [[n[:120], s] for n, s in idle]}


def _device_ops(events):
    from torch.autograd import DeviceType

    ops = [(ev.name, float(ev.time_range.start), float(ev.time_range.end))
           for ev in events if ev.device_type == DeviceType.CUDA
           and not ev.name.startswith("bench.")]  # the spans' device-side copies
    return sorted(ops, key=lambda o: o[1])


def traced(cell, sync: Callable[[], None]) -> TraceSummary:
    """Trace ``cell.traced_steps()`` (whole steps; it returns how many)
    twice, the device drained before and after each. The first pass traces
    the device alone, so the host runs at its own pace: the device ops, the
    window and the program's counters come from it. The second also
    traces the host's ops, which slows the host, and only names the idle
    gaps."""
    from torch.autograd import DeviceType
    from torch.autograd.profiler import record_function
    from torch.profiler import ProfilerActivity, profile, supported_activities

    # the device alone; a CPU-only build (the tests) traces the host instead
    device = [ProfilerActivity.CUDA if ProfilerActivity.CUDA in supported_activities()
              else ProfilerActivity.CPU]
    sync()
    before = cell.counters()
    with profile(activities=device) as prof:
        t0 = time.perf_counter()
        steps = cell.traced_steps()
        sync()
        window_s = time.perf_counter() - t0
    after = cell.counters()
    ops = _device_ops(prof.events())
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW_SPAN):
            cell.traced_steps()
            sync()
    events = prof.events()
    span = [ev for ev in events if ev.name == WINDOW_SPAN]
    if not span:
        raise RuntimeError("the profiler kept no window span")
    host = [(float(ev.time_range.start), float(ev.time_range.end), ev.name)
            for ev in events if ev.device_type != DeviceType.CUDA and ev.name != WINDOW_SPAN]
    lo, hi = float(span[0].time_range.start), float(span[0].time_range.end)
    return TraceSummary(ops, window_s, steps, {k: after[k] - before[k] for k in after},
                        _idle_by_host(_device_ops(events), host, lo, hi))


def _idle_by_host(ops, host, lo, hi) -> Dict[str, float]:
    """Idle device time in ``[lo, hi]`` by the innermost host op open at
    each gap's midpoint (the longest ``NAMED_GAPS`` gaps; the rest summed
    under one name)."""
    idle = stats.gaps(((s, e) for _, s, e in ops), lo, hi)
    idle.sort(key=lambda g: g[0] - g[1])
    host.sort()
    starts = [h[0] for h in host]
    out: Dict[str, float] = defaultdict(float)
    for i, (s, e) in enumerate(idle):
        if i >= NAMED_GAPS:
            out["(shorter gaps)"] += (e - s) / 1e6
            continue
        mid = 0.5 * (s + e)
        name = "(no host op)"
        j = bisect.bisect_right(starts, mid) - 1
        for k in range(j, max(j - 5000, -1), -1):
            if host[k][1] >= mid:
                name = host[k][2]
                break
        out[name] += (e - s) / 1e6
    return dict(out)
