"""Profiling helpers (port of raytracer_tpu/utils/profiling.py): the port's
in-memory tracer, a torch.profiler trace capture, and a device sync.

`PhaseTimer` is the phase timer the multi-device render has always had:
on a mesh each rank keeps its own (`ProgressiveRenderer.timer`), and the
tile render, ReSTIR's halo exchange and the image gather are its phases,
each ended after a device sync; `totals` and `counts` sum them. Made with
`record=True` it is also the tracer: it keeps spans (name, start and end
ns, the index of the parent span, the frame of the enclosing `rt.step`
span, a few attributes) and per-frame counters in memory until `export()`
hands them over, so it records the frames it is active for and no more.

The program's spans and counters (`span`, `count`; every name starts with
`rt.`) go to the active tracer. There is none by default: `span()` then
returns one shared no-op context manager, and neither function reads a
clock, allocates a record or calls torch.profiler. `activated(tracer)`
makes a recording tracer active for a region: the renderer does it with
its `timer` for `step()`, `begin_frame()` and the bakes they run, and a
caller may do it for a whole run. Spans are recorded on the thread that
activated the tracer only (a background prebake records nothing).

Span times are on the clock of torch.profiler's host events: torch's
approximate clock, turned into Unix-epoch ns by the converter kineto
applies (`time.time_ns()` where this torch lacks it), so a profiled
device activity can be put down to the span whose time holds its launch
(utils/attribution.py). Spans enter the profiler only under
`device_trace()`, which also opens a `record_function` range for each, so
its Chrome trace shows them; a tracer activated elsewhere adds no range
and no device activity. Counters add device tensors without a kernel or
a sync: the values are kept and summed once, in `export()`.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, List, Optional

import torch

# The active tracer (a PhaseTimer) or None: tracing off.
_active = None
_NOOP = contextlib.nullcontext()

try:
    from torch._C._profiler import (
        _ApproximateClockToUnixTimeConverter,
        _get_approximate_time,
    )
except ImportError:  # a torch without the approximate clock
    _ApproximateClockToUnixTimeConverter = None
    _now = time.time_ns
else:
    _now = _get_approximate_time
_converter = None  # made with the first tracer


def _to_unix_ns(origin):
    """A function from the clock's ticks to Unix-epoch ns, linear from
    `origin` (a tick), with the scale and offset of kineto's converter."""
    if _ApproximateClockToUnixTimeConverter is None:
        return lambda t: t
    span = 10**10
    a, b = _converter.to_unix_ns(origin), _converter.to_unix_ns(origin + span)
    scale = (b - a) / span
    return lambda t: a + round((t - origin) * scale)


def span(name: str, **attrs):
    """A context manager recording span `name` with `attrs` in the active
    tracer (entered, it gives the span's attribute dict, for attributes
    known only at its end), or the shared no-op when tracing is off."""
    tracer = _active
    if tracer is None:
        return _NOOP
    return tracer.span(name, **attrs)


def count(name: str, value):
    """Add `value` (an int, or a device tensor read only at export) to the
    active tracer's counter `name` of the current frame."""
    tracer = _active
    if tracer is not None:
        tracer.count(name, value)


def counting() -> bool:
    """Whether a tracer is active, so that `count` keeps what it is given:
    a caller allocates a device counter only then."""
    return _active is not None


@contextlib.contextmanager
def _activated(tracer):
    global _active
    prev, _active = _active, tracer
    tracer.thread = threading.get_ident()
    try:
        yield tracer
    finally:
        _active = prev


def activated(tracer):
    """A context manager making `tracer` (a PhaseTimer) the active tracer
    inside it where it records; with None or a timer of phases alone it
    changes nothing (the shared no-op)."""
    if tracer is None or not tracer.record:
        return _NOOP
    return _activated(tracer)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a torch.profiler trace of the CPU and, with a card, CUDA
    activities, written to `log_dir` as a Chrome trace (TensorBoard's
    profiler plugin reads it), with the program's spans active and shown
    in it as ranges. Yields the tracer."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    tracer = PhaseTimer(annotate=True)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                log_dir)), _activated(tracer):
        yield tracer


def _first_tensor(value):
    if isinstance(value, torch.Tensor):
        return value
    if isinstance(value, dict):
        value = list(value.values())
    for item in value:
        found = _first_tensor(item)
        if found is not None:
            return found
    return None


def sync(value) -> float:
    """Wait for the device that holds `value` (a tensor, or the first tensor
    of a tuple, list or dict): torch.cuda.synchronize on a card, a readback
    on the CPU. Returns its first element."""
    leaf = _first_tensor(value)
    if leaf.is_cuda:
        torch.cuda.synchronize(leaf.device)
    return float(leaf.reshape(-1)[0])


# A span record: [name, start tick, end tick, parent index, frame, attrs].
_NAME, _START, _END, _PARENT, _FRAME, _ATTRS = range(6)


class _Span:
    __slots__ = ("tracer", "rec", "range")

    def __init__(self, tracer, rec):
        self.tracer, self.rec, self.range = tracer, rec, None

    def __enter__(self):
        tr, rec = self.tracer, self.rec
        if tr.stack:
            rec[_PARENT] = tr.stack[-1]
            if rec[_FRAME] is None:
                rec[_FRAME] = tr.spans[rec[_PARENT]][_FRAME]
        tr.stack.append(len(tr.spans))
        tr.spans.append(rec)
        if tr.annotate:
            self.range = torch.profiler.record_function(rec[_NAME])
            self.range.__enter__()
        rec[_START] = _now()
        return rec[_ATTRS]

    def __exit__(self, *exc):
        self.rec[_END] = _now()
        if self.range is not None:
            self.range.__exit__(*exc)
        self.tracer.stack.pop()
        return False


class PhaseTimer:
    """Wall time per named phase, summed over its calls (`totals`,
    `counts`, `report`); a phase given a result waits for the device before
    it ends. With `record` it is also a tracer: while active it keeps the
    program's spans and counters (module docstring) until `export()` hands
    them over; with `annotate` each span also opens a record_function
    range. A timer that does not record is never made active."""

    def __init__(self, record: bool = False, annotate: bool = False):
        global _converter
        if _converter is None and _ApproximateClockToUnixTimeConverter:
            _converter = _ApproximateClockToUnixTimeConverter()
        self.record = record or annotate
        self.annotate = annotate
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self.spans: List[list] = []
        self.stack: List[int] = []
        self.counters: Dict[tuple, list] = {}  # (frame, name) -> values
        self.thread = threading.get_ident()

    def span(self, name: str, **attrs):
        """Span `name` (see the module function); the frame is the
        `frame` attribute, else the enclosing span's."""
        if not self.record or threading.get_ident() != self.thread:
            return _NOOP
        return _Span(self, [name, 0, 0, -1, attrs.get("frame"), attrs])

    def count(self, name: str, value):
        if threading.get_ident() != self.thread:
            return
        frame = self.spans[self.stack[-1]][_FRAME] if self.stack else None
        self.counters.setdefault((frame, name), []).append(value)

    @contextlib.contextmanager
    def phase(self, name: str, result_holder: Optional[List] = None):
        t0 = time.perf_counter()
        with self.span(name):
            yield
            if result_holder:
                with self.span("rt.sync", site=name):
                    sync(result_holder[0])
        dt = time.perf_counter() - t0
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        rows = sorted(self.totals.items(), key=lambda kv: -kv[1])
        width = max((len(k) for k, _ in rows), default=1)
        return "\n".join(
            f"{k.ljust(width)}  {v * 1e3:8.1f} ms total  "
            f"({v / max(self.counts[k], 1) * 1e3:.1f} ms/call x{self.counts[k]})"
            for k, v in rows
        )

    def export(self) -> dict:
        """Hand over the spans and counters kept so far, and keep none:
        {"spans": [{"name", "start_ns", "end_ns" (Unix-epoch ns, the
        profiler's host clock), "parent" (index, -1 for none), "frame",
        "attrs"}], "counters": {name: {frame: int}}}. Call it with no span
        open. The counters' device tensors are summed on their device and
        read in one go."""
        if self.stack:
            raise RuntimeError(f"export() inside span "
                               f"{self.spans[self.stack[-1]][_NAME]}")
        rows, kept = self.spans, self.counters
        self.spans, self.counters = [], {}
        unix = _to_unix_ns(rows[0][_START]) if rows else None
        spans = [{"name": r[_NAME], "start_ns": unix(r[_START]),
                  "end_ns": unix(r[_END]), "parent": r[_PARENT],
                  "frame": r[_FRAME], "attrs": dict(r[_ATTRS])}
                 for r in rows]
        sums = {}
        for key, values in kept.items():
            ints = sum(v for v in values if not isinstance(v, torch.Tensor))
            tensors = [v.reshape(()).to(torch.int64) for v in values
                       if isinstance(v, torch.Tensor)]
            sums[key] = (ints, torch.stack(tensors).sum() if tensors
                         else None)
        by_device = {}
        for key, (_, t) in sums.items():
            if t is not None:
                by_device.setdefault(t.device, []).append((key, t))
        read = {}
        for pairs in by_device.values():
            values = torch.stack([t for _, t in pairs]).tolist()
            read.update({key: v for (key, _), v in zip(pairs, values)})
        counters: Dict[str, Dict] = {}
        for (frame, name), (ints, _) in sums.items():
            counters.setdefault(name, {})[frame] = (
                ints + read.get((frame, name), 0))
        return {"spans": spans, "counters": counters}
