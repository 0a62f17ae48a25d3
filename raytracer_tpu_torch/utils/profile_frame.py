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
under --accel bvh). With --restir the frame runs ReSTIR DI, and its
reservoir passes (integrator/restir.py:restir_direct, shadow rays
included) show as one top-level operation, `restir_direct`. Needs a CUDA
device; exits non-zero without one.
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
# record_function ranges: the profiler also lists them as device
# activities spanning their kernels (and the gaps between them), so they
# are kept out of the device busy time.
SPANS = ("restir_direct",)


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
    from raytracer_tpu_torch.integrator import restir
    from raytracer_tpu_torch.ops.camera import Camera
    from raytracer_tpu_torch.scene.benchmark import create_benchmark_atrium
    from raytracer_tpu_torch.utils.config import RenderConfig

    print(f"card: {card_line()}; torch {torch.__version__}", flush=True)
    cam = Camera.create(position=CAM_POS, aspect=WIDTH / HEIGHT,
                        target=CAM_TARGET)
    r = ProgressiveRenderer(
        create_benchmark_atrium(TRIANGLES), cam,
        RenderConfig(width=WIDTH, height=HEIGHT, max_depth=3,
                     accel=args.accel, use_restir=args.restir),
        device="cuda")
    own = restir.restir_direct

    def restir_direct(*a, **kw):
        with torch.profiler.record_function(SPANS[0]):
            return own(*a, **kw)

    restir.restir_direct = restir_direct
    for _ in range(args.warm):
        _frame_ms(r)
    plain_ms = _frame_ms(r)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall_ms = _frame_ms(r)

    events = prof.events()
    by_name = defaultdict(lambda: [0, 0.0])
    for e in events:
        if e.device_type == DeviceType.CUDA and e.name not in SPANS:
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
