"""The reduction of a torch.profiler trace (CPU and CUDA activities, kept
in memory) of a few frames to what the per-layer metrics read.

Device busy time is the sum of the device activities (kernels, memsets,
copies; the harness's ranges, which the profiler also lists on the
device, are not activities); the renderer runs on one stream, so they do
not overlap. Each activity goes to one layer:
  - traversal: kernels whose name holds `closest_kernel` or
    `occlusion_kernel` (K1/K2, ops/quad_traverse.py);
  - ReSTIR: the rest of what runs under the `portbench.restir_direct`
    range, found by the range's span on the device timeline (the
    profiler's GPU user annotation, which the card's torch records for
    each range);
  - shading: everything else (the wavefront integrator).
An idle gap between consecutive device activities is named by the host
op that launched the activity after it (what the device waited for), or
else by the innermost host op running at the gap's middle.
"""

from __future__ import annotations

import bisect
import dataclasses
from collections import defaultdict
from typing import Dict, List, Tuple

TRAVERSAL_KERNELS = ("closest_kernel", "occlusion_kernel")
RANGE_PREFIX = "portbench."


@dataclasses.dataclass
class Summary:
    frames: int
    wall_s: float  # host clock of the profiled frames
    busy_s: float
    trace_s: float
    restir_s: float
    shade_s: float
    restir_spans: int
    device_ops: List[Tuple[str, float]]  # top 10 by seconds
    idle_gaps: List[Tuple[str, float]]  # top 10 host ops by gap seconds


def summarize(events, frames: int, wall_s: float, restir_range: str,
              top: int = 10) -> Summary:
    """`events`: the profiler's kineto events (profile.profiler.
    kineto_results.events())."""
    from torch.autograd import DeviceType

    device, host, spans = [], [], []
    by_corr = {}
    for e in events:
        name = e.name()
        on_device = e.device_type() != DeviceType.CPU
        if on_device and name.startswith(RANGE_PREFIX):
            # A range's span on the device timeline, not an activity.
            if name == restir_range:
                spans.append((e.start_ns(), e.end_ns()))
        elif on_device:
            device.append(e)
        else:
            host.append(e)
            if e.linked_correlation_id() == 0:  # an op or a range
                by_corr[e.correlation_id()] = e
    device.sort(key=lambda e: e.start_ns())

    busy = trace = restir = 0.0
    ops: Dict[str, float] = defaultdict(float)
    for e in device:
        s = e.duration_ns() * 1e-9
        busy += s
        ops[e.name()] += s
        if any(k in e.name() for k in TRAVERSAL_KERNELS):
            trace += s
            continue
        if any(a <= e.start_ns() and e.end_ns() <= b for a, b in spans):
            restir += s

    host.sort(key=lambda e: e.start_ns())
    starts = [e.start_ns() for e in host]
    gaps: Dict[str, float] = defaultdict(float)
    for a, b in zip(device, device[1:]):
        g0, g1 = a.end_ns(), b.start_ns()
        if g1 <= g0:
            continue
        # The device waited for the host to issue `b`: the gap goes to the
        # host op that launched it, else to the innermost host op over the
        # gap's middle.
        parent = by_corr.get(b.linked_correlation_id())
        if parent is None:
            mid = (g0 + g1) // 2
            i = bisect.bisect_right(starts, mid)
            for e in host[max(0, i - 400):i]:
                if e.end_ns() >= mid and (parent is None or e.start_ns()
                                          >= parent.start_ns()):
                    parent = e
        name = "host (no op)" if parent is None else parent.name()
        gaps[name] += (g1 - g0) * 1e-9
    rank = sorted(ops.items(), key=lambda kv: -kv[1])[:top]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
    return Summary(frames=frames, wall_s=wall_s, busy_s=busy, trace_s=trace,
                   restir_s=restir, shade_s=busy - trace - restir,
                   restir_spans=len(spans),
                   device_ops=[[n[:200], s] for n, s in rank],
                   idle_gaps=[[n[:200], s] for n, s in idle])
