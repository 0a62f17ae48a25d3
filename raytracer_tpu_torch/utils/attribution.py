"""Profiled frames put down to the program's spans: each device activity
of a torch.profiler capture, and each idle gap, goes to the span of
utils/profiling.py that launched it.

An activity (a kernel, memset or copy; not a user annotation) goes to the
CUDA runtime call that launched it, found by the activity's own
correlation id, which CUPTI gives the call and its activity alike: the
same for a torch op's kernels and for a native library's launches through
ctypes. It belongs to the innermost span whose host time holds that call
(the spans are on the profiler's host clock), under the span's path,
`rt.step/rt.bounce/...`; "(no span)" where no span holds the call, "(no
launch)" where the capture has no such call. An idle gap between
consecutive activities goes to the path of the activity after it: what
the device waited for.

    a = attribute(prof.profiler.kineto_results.events(), tracer.export(),
                  frames)
"""

from __future__ import annotations

import bisect
import dataclasses
from collections import defaultdict
from typing import Dict, List

NO_SPAN = "(no span)"
NO_LAUNCH = "(no launch)"
# CUDA launch calls (cuda*, and their cu* counterparts), one device
# activity each.
LAUNCH_CALLS = ("cudaLaunch", "cuLaunch", "cudaMemset", "cuMemset",
                "cudaMemcpy", "cuMemcpy")


@dataclasses.dataclass
class Attribution:
    frames: int
    busy_s: float  # every device activity
    device_s: Dict[str, float]  # span path -> s of the activities it launched
    idle_s: Dict[str, float]  # span path -> s of the gaps before them
    host_s: Dict[str, float]  # span name -> s of host time in its spans
    counters: Dict[str, int]  # counter -> its sum over the frames
    spans: int  # spans recorded
    no_launch_s: Dict[str, float]  # activity name -> s, launch not found

    def under(self, name: str) -> float:
        """Device s of the activities launched inside spans `name` (or
        spans under them)."""
        return sum(s for path, s in self.device_s.items()
                   if name in path.split("/"))

    @property
    def attributed_s(self) -> float:
        """Device s of the activities whose launch a span holds."""
        return sum(s for path, s in self.device_s.items()
                   if path not in (NO_SPAN, NO_LAUNCH))

    def idle_spans(self, top: int = 10) -> List[list]:
        """The `top` span paths by idle s before their activities."""
        rank = sorted(self.idle_s.items(), key=lambda kv: -kv[1])[:top]
        return [[path[:200], s] for path, s in rank]


def _paths(spans) -> List[str]:
    out = []
    for s in spans:
        p = s["parent"]
        out.append(s["name"] if p < 0 else f"{out[p]}/{s['name']}")
    return out


class _SpanIndex:
    """The innermost span holding a host time."""

    def __init__(self, spans):
        self.spans = spans
        self.paths = _paths(spans)
        self.order = sorted(range(len(spans)),
                            key=lambda i: spans[i]["start_ns"])
        self.starts = [spans[i]["start_ns"] for i in self.order]

    def path(self, t) -> str:
        k = bisect.bisect_right(self.starts, t) - 1
        # The last span to start at or before t is the innermost holding
        # it, or it ended before t and one of its ancestors holds it.
        i = self.order[k] if k >= 0 else -1
        while i >= 0:
            s = self.spans[i]
            if t <= s["end_ns"]:
                return self.paths[i]
            i = s["parent"]
        return NO_SPAN


def _is_activity(event) -> bool:
    from torch.autograd import DeviceType

    return (event.device_type() != DeviceType.CPU
            and not event.is_user_annotation())


def attribute(events, exported: dict, frames: int) -> Attribution:
    """`events`: the profiler's kineto events (profile.profiler.
    kineto_results.events()) of `frames` frames; `exported`: the export()
    of the tracer active through them."""
    spans = exported["spans"]
    index = _SpanIndex(spans)
    device, launches = [], {}
    for e in events:
        if _is_activity(e):
            device.append(e)
        elif e.name().startswith(LAUNCH_CALLS):
            launches[e.correlation_id()] = e.start_ns()
    device.sort(key=lambda e: e.start_ns())

    busy = 0.0
    device_s: Dict[str, float] = defaultdict(float)
    idle_s: Dict[str, float] = defaultdict(float)
    no_launch_s: Dict[str, float] = defaultdict(float)
    prev_end = None
    for e in device:
        s = e.duration_ns() * 1e-9
        t = launches.get(e.correlation_id())
        path = NO_LAUNCH if t is None else index.path(t)
        busy += s
        device_s[path] += s
        if path == NO_LAUNCH:
            no_launch_s[e.name()[:200]] += s
        if prev_end is not None and e.start_ns() > prev_end:
            idle_s[path] += (e.start_ns() - prev_end) * 1e-9
        prev_end = e.end_ns()
    host_s: Dict[str, float] = defaultdict(float)
    for s in spans:
        host_s[s["name"]] += (s["end_ns"] - s["start_ns"]) * 1e-9
    counters = {name: sum(by_frame.values())
                for name, by_frame in exported["counters"].items()}
    return Attribution(frames=frames, busy_s=busy, device_s=dict(device_s),
                       idle_s=dict(idle_s), host_s=dict(host_s),
                       counters=counters, spans=len(spans),
                       no_launch_s=dict(no_launch_s))
