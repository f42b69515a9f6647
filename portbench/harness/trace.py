"""The traced window: ``torch.profiler`` over the whole window, its events kept
in memory and reduced here (no trace file is written).

* busy seconds: the union of the device's activity intervals (kernels,
  copies, sets), without CUPTI's own buffer requests and without the
  host's annotations that the profiler mirrors on the device's timeline;
* device time by name: each device operation's summed duration;
* idle gaps: the device's longest idle intervals, each named by what the
  host was doing at its middle: the query's stage (from its telemetry, laid
  from the query's start) and the innermost host operator running then.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict

import numpy as np

# the order in which a streaming query spends the telemetry's stage timings
STAGES = ("stratify_s", "similarity_s", "pilot_s", "allocate_s", "execute_s", "ci_s")
QUERY_MARK = "portbench.query."
TOP = 10


@dataclasses.dataclass
class Summary:
    busy_s: float
    device_ops: list          # [[name, seconds]] longest first
    idle_gaps: list           # [[name, seconds]] longest first
    device_time: dict         # name -> seconds


def start():
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.__enter__()
    return prof


def _stage(offset_s: float, timings: dict) -> str:
    at = 0.0
    for name in STAGES:
        at += timings.get(name, 0.0)
        if offset_s < at:
            return name[:-2]
    return "between queries"


def stop(prof, records: list) -> Summary:
    from torch.autograd import DeviceType

    prof.__exit__(None, None, None)
    dev, host, marks = [], [], []
    # the raw events: building the profiler's event tree would take minutes
    for e in prof.profiler.kineto_results.events():
        a, b, name = e.start_ns() / 1e3, e.end_ns() / 1e3, e.name()
        if e.device_type() == DeviceType.CUDA:
            # the host's annotations are mirrored on the device's timeline
            # over the kernels they enclose: they are not device work
            if not (e.is_user_annotation() or name.startswith(QUERY_MARK)
                    or name == "Activity Buffer Request"):
                dev.append((a, b, name))
        elif name.startswith(QUERY_MARK):
            marks.append((a, b, int(name[len(QUERY_MARK):])))
        else:
            host.append((a, b, name))
    dev.sort()
    busy, end = 0.0, float("-inf")
    gaps = []
    by_name = defaultdict(float)
    for a, b, name in dev:
        by_name[name] += (b - a) / 1e6
        if a > end and end > float("-inf"):
            gaps.append((a - end, end, a))
        if b > end:
            busy += b - max(a, end)
            end = b
    gaps.sort(reverse=True)
    timings = {r.index: r.timings for r in records}
    hs = np.array([h[0] for h in host]) if host else np.zeros(0)
    he = np.array([h[1] for h in host]) if host else np.zeros(0)
    named = []
    for length, a, b in gaps[:TOP]:
        mid = (a + b) / 2
        stage = "between queries"
        for ma, mb, qi in marks:
            if ma <= mid <= mb:
                stage = _stage((mid - ma) / 1e6, timings.get(qi, {}))
        inside = np.nonzero((hs <= mid) & (he >= mid))[0]
        op = host[inside[np.argmax(hs[inside])]][2] if len(inside) else "python"
        named.append([f"{stage}: {op}"[:160], length / 1e6])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return Summary(busy / 1e6, [[n[:160], s] for n, s in ops], named, dict(by_name))
