"""Device time of one progressive frame of the headline workload (the
300k-triangle atrium at 1920x1080, depth 3, NEE, bench.py's camera) under
torch.profiler, by kernel and by top-level operation.

    python3 -m raytracer_tpu_torch.utils.profile_frame [--warm 2] [--top 20]
        [--accel bvh] [--restir]

Bakes the atrium, renders `--warm` frames, then profiles one frame
(CPU and CUDA activities) between two device synchronisations. Prints the
card's name, power limit and SM clock, the frame's host ms with and without the
profiler, the device's busy ms (the sum of the device activities: kernels,
memsets, copies; one stream, so they do not overlap) and idle share, the
device activities grouped by name, the top-level operations by the device
time of the kernels under them, and the traversal kernels' launches and ms
(names containing closest_kernel or occlusion_kernel: K1/K2, or K3/K4
under --accel bvh). The frame runs with the program's tracer active
(utils/profiling.py; its spans add nothing to the profile), and its device
time and idle gaps are put down to the program's spans
(utils/attribution.py): device ms by span path and under each span name
(`rt.restir_direct` is ReSTIR DI's reservoir passes, shadow rays included,
with --restir), the idle ms before each path's activities, and the host ms
of the frame's `rt.sync` reads. Needs a CUDA device; exits non-zero
without one.
"""

from __future__ import annotations

import argparse
import sys
import time
from collections import defaultdict

from raytracer_tpu_torch.lab.rays import (
    CAM_POS,
    CAM_TARGET,
    HEIGHT,
    TRIANGLES,
    WIDTH,
    card_line,
)

TRAVERSAL = ("closest_kernel", "occlusion_kernel")


def _frame_ms(renderer):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    renderer.step()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def main(argv=None):
    import torch

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--warm", type=int, default=2)
    p.add_argument("--top", type=int, default=20)
    p.add_argument("--accel", default="auto")
    p.add_argument("--restir", action="store_true")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_frame: no CUDA device")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from raytracer_tpu_torch.api import ProgressiveRenderer
    from raytracer_tpu_torch.ops.camera import Camera
    from raytracer_tpu_torch.scene.benchmark import create_benchmark_atrium
    from raytracer_tpu_torch.utils import attribution, profiling
    from raytracer_tpu_torch.utils.config import RenderConfig

    print(f"card: {card_line()}; torch {torch.__version__}", flush=True)
    cam = Camera.create(position=CAM_POS, aspect=WIDTH / HEIGHT,
                        target=CAM_TARGET)
    r = ProgressiveRenderer(
        create_benchmark_atrium(TRIANGLES), cam,
        RenderConfig(width=WIDTH, height=HEIGHT, max_depth=3,
                     accel=args.accel, use_restir=args.restir),
        device="cuda")
    for _ in range(args.warm):
        _frame_ms(r)
    plain_ms = _frame_ms(r)
    tracer = profiling.PhaseTimer(record=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with profiling.activated(tracer):
            wall_ms = _frame_ms(r)
    spans = attribution.attribute(prof.profiler.kineto_results.events(),
                                  tracer.export(), 1)

    events = prof.events()
    by_name = defaultdict(lambda: [0, 0.0])
    for e in events:
        if e.device_type == DeviceType.CUDA:
            by_name[e.name][0] += 1
            by_name[e.name][1] += e.device_time_total / 1e3
    busy = sum(ms for _, ms in by_name.values())
    print(f"accel={r.config.accel}, use_restir={args.restir}: frame "
          f"{plain_ms:.3f} ms without the "
          f"profiler, {wall_ms:.3f} ms with it; device busy {busy:.3f} ms, "
          f"idle {100 * (1 - busy / wall_ms):.1f}% of the profiled frame; "
          f"{sum(c for c, _ in by_name.values())} device activities")
    print(f"device activities by name (top {args.top}): share, ms, count")
    for name, (count, ms) in sorted(by_name.items(),
                                    key=lambda kv: -kv[1][1])[:args.top]:
        print(f"  {100 * ms / busy:5.1f}% {ms:9.3f} ms {count:5d}x "
              f"{name[:110]}")
    ops = defaultdict(lambda: [0, 0.0])
    for e in events:
        if e.device_type == DeviceType.CPU and e.cpu_parent is None:
            ops[e.name][0] += 1
            ops[e.name][1] += e.device_time_total / 1e3
    print(f"top-level operations by the device time under them (top "
          f"{args.top}): share, ms, calls")
    for name, (count, ms) in sorted(ops.items(),
                                    key=lambda kv: -kv[1][1])[:args.top]:
        if ms > 0:
            print(f"  {100 * ms / busy:5.1f}% {ms:9.3f} ms {count:5d}x "
                  f"{name[:110]}")
    for key in TRAVERSAL:
        hits = [(n, c, ms) for n, (c, ms) in by_name.items() if key in n]
        count = sum(c for _, c, _ in hits)
        ms = sum(m for _, _, m in hits)
        print(f"traversal {key}: {count} launches, {ms:.3f} ms, "
              f"{100 * ms / busy:.2f}% of the device time")
    print_spans(spans, args.top)
    return 0


def print_spans(spans, top):
    """The frame's device ms by the program's span paths and under each
    span name, the idle ms by path, and the host ms of its rt.sync reads
    (`spans`: utils/attribution.py's Attribution of the frame)."""
    busy = spans.busy_s
    print(f"device ms by program span path (top {top}; "
          f"{1e3 * spans.attributed_s:.3f} of {1e3 * busy:.3f} ms busy "
          f"attributed): share, ms")
    for path, s in sorted(spans.device_s.items(),
                          key=lambda kv: -kv[1])[:top]:
        print(f"  {100 * s / busy:5.1f}% {1e3 * s:9.3f} ms {path}")
    names = sorted({name for path in spans.device_s
                    for name in path.split("/") if name.startswith("rt.")})
    print("device ms under each program span: share, ms")
    for name in sorted(names, key=lambda n: -spans.under(n)):
        s = spans.under(name)
        print(f"  {100 * s / busy:5.1f}% {1e3 * s:9.3f} ms {name}")
    print(f"idle ms by the span path launching the next activity (top "
          f"{top}):")
    for path, s in spans.idle_spans(top):
        print(f"  {1e3 * s:9.3f} ms {path}")
    print(f"host ms in rt.sync reads: "
          f"{1e3 * spans.host_s.get('rt.sync', 0.0):.3f}")
    for name, s in sorted(spans.no_launch_s.items(), key=lambda kv: -kv[1]):
        print(f"  no launch found: {1e3 * s:9.3f} ms {name[:110]}")


if __name__ == "__main__":
    sys.exit(main())
