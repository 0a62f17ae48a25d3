"""Smoke run of the PyTorch/CUDA port (raytracer_tpu_torch) on one NVIDIA
GPU: the quickest proof that the port builds and renders on the card.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  0. Require a CUDA device; print torch/CUDA versions and the card's name
     and power limit (nvidia-smi).
  1. Build the traversal kernels (csrc/quad_traverse.cu) with nvcc.
  2. Kernels against their plain torch versions on the card, on the
     300k-triangle atrium and three 1920x1080 ray sets (primary rays,
     incoherent reflected rays, shadow rays with finite t_max and a skipped
     light object). The plain versions run on every ray (and, timed apart,
     on a strided subset of >= 65,536 rays); the gate is bit equality
     (hit, tri, t, u, v; the occlusion mask). Times the kernels (CUDA
     events, mean of 5 launches) and the plain versions (host clock, one
     run).
  3. The main path: ProgressiveRenderer on the atrium at 1920x1080, depth 3,
     NEE; 2 warm and 4 timed frames, with ms/frame, rays/frame, Mrays/s
     and peak device memory; a finite, non-black image; both kernels
     launched during the run. Then the atrium at 64x64, 2 frames, on the
     card against the CPU (the plain versions), pixel by pixel.
  4. The CLI renders a JSON scene to a PNG.

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}. The scene and all rays are generated from
fixed seeds; nothing is downloaded.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

WIDTH, HEIGHT = 1920, 1080
TARGET_TRIS = 300_000
# The camera of bench.py's headline workload.
CAM_POS, CAM_TARGET = (-16.0, 6.5, -7.5), (8.0, 3.0, 4.0)
SUBSET_MIN = 65_536
PIXEL_ATOL = 1e-4  # the slice tolerance: per pixel, except flipped pixels
MAX_FLIPPED = 0.01
KERNEL_SOURCE = "raytracer_tpu_torch/csrc/quad_traverse.cu"


def log(msg):
    print(msg, flush=True)


def nvidia_smi_line():
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if proc.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps):
    """Mean device ms of fn() over `reps` launches, after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase0():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("FAIL phase 0: torch.cuda.is_available() is False")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    log(f"device: {torch.cuda.get_device_name(0)} "
        f"(count {torch.cuda.device_count()})")
    log(f"nvidia-smi: {nvidia_smi_line()}")


def phase1():
    from raytracer_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.quad_traverse_lib()
    info = _build.build_info["libquad_traverse"]
    log(f"phase 1: built {KERNEL_SOURCE} in "
        f"{time.perf_counter() - t0:.2f} s (nvcc {info['seconds']:.2f} s)")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line or "Function" in line:
            log(f"  ptxas: {line.strip()}")


def bench_camera_ubo(device, width, height):
    import numpy as np
    import torch

    from raytracer_tpu_torch.ops.camera import Camera

    cam = Camera.create(position=CAM_POS, aspect=width / height,
                        target=CAM_TARGET)
    mats = cam.matrices()
    return cam, {k: torch.from_numpy(np.ascontiguousarray(mats[k])).to(device)
                 for k in ("inverse_view", "inverse_proj")}


def ray_sets(ds, device):
    """The three 1920x1080 ray sets: primary, incoherent reflected, shadow
    (t_max, skip_object, active mask)."""
    import numpy as np
    import torch

    from raytracer_tpu_torch.integrator.wavefront import _camera_rays
    from raytracer_tpu_torch.ops import quad_traverse as qt

    n = WIDTH * HEIGHT
    _, ubo = bench_camera_ubo(device, WIDTH, HEIGHT)
    origin, direction = _camera_rays(
        ubo["inverse_view"], ubo["inverse_proj"], WIDTH, HEIGHT,
        torch.full((n, 2), 0.5, device=device),
        torch.arange(n, device=device))
    rng = np.random.default_rng(7)
    # A bounce-like incoherent set: reflect off a pseudo-random normal
    # (tools/tpu_smoke.py's construction, from a numpy seed).
    nrm = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32))
    nrm = (nrm / nrm.norm(dim=1, keepdim=True)).to(device)
    bdir = direction - 2.0 * (direction * nrm).sum(1, keepdim=True) * nrm
    bdir = (bdir / bdir.norm(dim=1, keepdim=True)).contiguous()
    # Shadow rays from the primary hits toward random points of the
    # skylight, skipping the skylight's own object.
    hit = qt.intersect_quad(origin, direction, ds, 1e-3, 1e4)
    pos = origin + (hit.t * 0.999)[:, None] * direction
    light_obj = int(ds.light_meta_packed[0, 5])
    rows = ds.light_tri_packed[ds.light_tri_packed[:, 9] == light_obj]
    corners = torch.cat([rows[:, 0:3], rows[:, 0:3] + rows[:, 3:6],
                         rows[:, 0:3] + rows[:, 6:9]])
    lo, hi = corners.amin(0), corners.amax(0)
    u = torch.from_numpy(rng.uniform(size=(n, 3)).astype(np.float32))
    target = lo + u.to(device) * (hi - lo)
    to_l = target - pos
    dist = to_l.norm(dim=1)
    sdir = (to_l / dist.clamp_min(1e-20)[:, None]).contiguous()
    return {
        "primary": (origin, direction),
        "incoherent": (origin, bdir),
        "shadow": (pos.contiguous(), sdir, (dist * 0.999).contiguous(),
                   torch.full((n,), light_obj, dtype=torch.int32,
                              device=device), hit.hit),
    }


def phase2(ds, device):
    """Kernels vs plain versions; returns the kernels' report entries."""
    import torch

    from raytracer_tpu_torch.ops import quad_traverse as qt

    sets = ray_sets(ds, device)
    n = WIDTH * HEIGHT
    stride = max(1, n // SUBSET_MIN)
    sub = torch.arange(0, n, stride, device=device)
    assert sub.numel() >= SUBSET_MIN
    report = {}

    def plain_timed(fn, *args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    scene_args = (ds.root, ds.qmeta, ds.qnodes, ds.ptris)
    for name in ("primary", "incoherent"):
        o, d = sets[name]
        tmax = torch.full((n,), 1e4, device=device)
        got = qt.intersect_quad(o, d, ds, 1e-3, tmax)
        _, sub_ms = plain_timed(qt._intersect_quad_plain, o[sub].contiguous(),
                                d[sub].contiguous(), tmax[sub], *scene_args)
        # The full set contains the strided subset: gate on every ray.
        ref, plain_ms = plain_timed(qt._intersect_quad_plain, o, d, tmax,
                                    *scene_args)
        hit_mism = int(((got.tri >= 0) != (ref[1] >= 0)).sum())
        tri_mism = int((got.tri != ref[1]).sum())
        max_dt = float((got.t - ref[0]).abs().max())
        uv_equal = bool(torch.equal(got.u, ref[2])
                        and torch.equal(got.v, ref[3]))
        ms = cuda_ms(lambda: qt.intersect_quad(o, d, ds, 1e-3, tmax), 5)
        log(f"phase 2: closest {name}: {int((got.tri >= 0).sum())} of {n} "
            f"rays hit; all {n} rays vs plain: hit_mism {hit_mism} "
            f"tri_mism {tri_mism} max|dt| {max_dt} uv_equal {uv_equal}; "
            f"kernel {ms:.3f} ms, plain {plain_ms:.1f} ms on {n} rays, "
            f"plain {sub_ms:.1f} ms on the {sub.numel()}-ray subset")
        if hit_mism or tri_mism or max_dt != 0.0 or not uv_equal:
            raise RuntimeError(f"closest kernel != plain version ({name})")
        report[f"closest_{name}"] = dict(ms=ms, plain_ms=plain_ms,
                                         max_abs_err=max_dt)

    o, d, tmax, skip, active = sets["shadow"]
    got = qt.occlusion_quad(o, d, 1e-3, tmax, ds, skip, active_mask=active)
    tm_eff = torch.where(active, tmax, 1e-3)
    _, sub_ms = plain_timed(qt._occlusion_quad_plain, o[sub].contiguous(),
                            d[sub].contiguous(), tm_eff[sub], skip[sub],
                            *scene_args)
    ref, plain_ms = plain_timed(qt._occlusion_quad_plain, o, d, tm_eff, skip,
                                *scene_args)
    mism = int((got != ref).sum())
    ms = cuda_ms(lambda: qt.occlusion_quad(o, d, 1e-3, tmax, ds, skip,
                                           active_mask=active), 5)
    log(f"phase 2: occlusion shadow: {int(active.sum())} active, "
        f"{int(got.sum())} occluded; all {n} rays vs plain: mism {mism}; "
        f"kernel {ms:.3f} ms, plain {plain_ms:.1f} ms on {n} rays, plain "
        f"{sub_ms:.1f} ms on the {sub.numel()}-ray subset")
    if mism:
        raise RuntimeError("occlusion kernel != plain version")
    report["occlusion_shadow"] = dict(
        ms=ms, plain_ms=plain_ms,
        max_abs_err=float((got.int() - ref.int()).abs().max()))
    return report


def phase3(scene_fn, device):
    import numpy as np
    import torch

    from raytracer_tpu_torch.api import ProgressiveRenderer
    from raytracer_tpu_torch.ops import quad_traverse as qt
    from raytracer_tpu_torch.utils.config import RenderConfig

    cfg = RenderConfig(width=WIDTH, height=HEIGHT, max_depth=3)
    cam, _ = bench_camera_ubo(device, WIDTH, HEIGHT)
    t0 = time.perf_counter()
    r = ProgressiveRenderer(scene_fn(), cam, cfg, device=device)
    torch.cuda.synchronize()
    log(f"phase 3: bake {time.perf_counter() - t0:.2f} s "
        f"({r.device_scene.num_triangles} triangles, qnodes "
        f"{r.device_scene.qnodes.numel() * 4} B, ptris "
        f"{r.device_scene.ptris.numel() * 4} B)")
    torch.cuda.reset_peak_memory_stats()
    qt.reset_launch_counts()
    times, rays = [], []
    for f in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r.step()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if f >= 2:
            times.append(dt)
            rays.append(int(r.last_stats["total_rays"]))
        log(f"  frame {f} {'warm' if f < 2 else 'timed'}: {dt * 1e3:.1f} ms, "
            f"{int(r.last_stats['rays_traced'])} traced + "
            f"{int(r.last_stats['shadow_rays'])} shadow rays")
    launches = {"closest": qt.closest_launches,
                "occlusion": qt.occlusion_launches}
    ms = 1e3 * sum(times) / len(times)
    mrays = sum(rays) / sum(times) / 1e6
    peak = torch.cuda.max_memory_allocated()
    img = r.image()
    log(f"phase 3: {ms:.1f} ms/frame, {sum(rays) // len(rays)} rays/frame, "
        f"{mrays:.2f} Mrays/s, peak device memory {peak} B, kernel "
        f"launches {launches}, image mean {float(img.mean()):.5f}")
    if not np.isfinite(img).all() or not img.mean() > 0:
        raise RuntimeError("main-path image is not finite and non-black")
    if not (launches["closest"] > 0 and launches["occlusion"] > 0):
        raise RuntimeError(f"a kernel was not launched: {launches}")

    # Card vs CPU (the plain versions) at 64x64, 2 frames.
    small = {}
    for dev in (device, "cpu"):
        c, _ = bench_camera_ubo(dev, 64, 64)
        small[str(dev)] = ProgressiveRenderer(
            scene_fn(), c, RenderConfig(width=64, height=64, max_depth=3),
            device=dev).render(2)
    a, b = small[str(device)], small["cpu"]
    flipped = np.abs(a - b).max(axis=-1) > PIXEL_ATOL
    log(f"phase 3: 64x64 x2 frames card vs CPU: {int(flipped.sum())} "
        f"flipped pixels of {flipped.size}, max |diff| "
        f"{float(np.abs(a - b).max()):.3g}")
    if flipped.mean() > MAX_FLIPPED:
        raise RuntimeError("card and CPU renders differ beyond tolerance")
    return launches


CORNELL_JSON = {
    "materials": {
        "white": {"albedo": [0.73, 0.73, 0.73], "roughness": 1.0},
        "red": {"albedo": [0.65, 0.05, 0.05], "roughness": 1.0},
        "green": {"albedo": [0.12, 0.45, 0.15], "roughness": 1.0},
        "metal": {"albedo": [0.9, 0.9, 0.9], "metallic": 1.0,
                  "roughness": 0.2},
        "light": {"albedo": [1, 1, 1], "emission_color": [1, 0.9, 0.8],
                  "emission_power": 10.0},
    },
    "objects": {
        "floor": {"mesh": "Plane", "material": "white",
                  "transform": {"position": [0, -1, 0],
                                "rotation": [-90, 0, 0], "scale": [2, 2, 1]}},
        "ceiling": {"mesh": "Plane", "material": "white",
                    "transform": {"position": [0, 1, 0],
                                  "rotation": [90, 0, 0],
                                  "scale": [2, 2, 1]}},
        "back": {"mesh": "Plane", "material": "white",
                 "transform": {"position": [0, 0, 1],
                               "rotation": [0, 180, 0], "scale": [2, 2, 1]}},
        "left": {"mesh": "Plane", "material": "red",
                 "transform": {"position": [-1, 0, 0],
                               "rotation": [0, 90, 0], "scale": [2, 2, 1]}},
        "right": {"mesh": "Plane", "material": "green",
                  "transform": {"position": [1, 0, 0],
                                "rotation": [0, -90, 0], "scale": [2, 2, 1]}},
        "ball": {"mesh": "Sphere", "material": "metal",
                 "transform": {"position": [0.3, -0.6, 0.3],
                               "scale": [0.4, 0.4, 0.4]}},
        "lamp": {"mesh": "Plane", "material": "light",
                 "transform": {"position": [0, 0.99, 0],
                               "rotation": [90, 0, 0],
                               "scale": [0.6, 0.6, 1]}},
    },
}


def phase4():
    from raytracer_tpu_torch import cli
    from raytracer_tpu_torch.utils.image import read_png

    with tempfile.TemporaryDirectory() as tmp:
        scene = os.path.join(tmp, "cornell.json")
        out = os.path.join(tmp, "cornell.png")
        with open(scene, "w") as f:
            json.dump(CORNELL_JSON, f)
        t0 = time.perf_counter()
        rc = cli.main([scene, "--width", "256", "--height", "256", "--spp",
                       "8", "--out", out])
        img = read_png(out) if os.path.exists(out) else None
        log(f"phase 4: CLI rc {rc} in {time.perf_counter() - t0:.2f} s, png "
            f"{None if img is None else img.shape}, pixel std "
            f"{None if img is None else float(img.std()):.4}")
        if rc != 0 or img is None or img.shape != (256, 256, 3) \
                or not img.std() > 0:
            raise RuntimeError("the CLI did not write a non-uniform PNG")


def main():
    phase0()  # exits before importing the port when there is no card
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch

    from raytracer_tpu_torch.scene.benchmark import create_benchmark_atrium
    from raytracer_tpu_torch.scene.device_scene import bake_scene

    device = torch.device("cuda", 0)
    phase1()
    t0 = time.perf_counter()
    ds, _ = bake_scene(create_benchmark_atrium(TARGET_TRIS), leaf_size=16,
                       device=device)
    torch.cuda.synchronize()
    log(f"phase 2: atrium bake {time.perf_counter() - t0:.2f} s, "
        f"{ds.num_triangles} triangles, stack need {ds.q_stack_need}")
    k = phase2(ds, device)
    del ds
    launches = phase3(lambda: create_benchmark_atrium(TARGET_TRIS), device)
    phase4()

    kernels = [
        {"name": "quad_closest", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": "raytracer_tpu/ops/pallas_subpacket.py:329",
         "launches": launches["closest"],
         "max_abs_err": max(k["closest_primary"]["max_abs_err"],
                            k["closest_incoherent"]["max_abs_err"]),
         "ms": k["closest_incoherent"]["ms"],
         "plain_ms": k["closest_incoherent"]["plain_ms"]},
        {"name": "quad_occlusion", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": "raytracer_tpu/ops/pallas_subpacket.py:423",
         "launches": launches["occlusion"],
         "max_abs_err": k["occlusion_shadow"]["max_abs_err"],
         "ms": k["occlusion_shadow"]["ms"],
         "plain_ms": k["occlusion_shadow"]["plain_ms"]},
    ]
    log(f"kernel ms and plain_ms: one launch on {WIDTH * HEIGHT} rays")
    log(f"nvidia-smi: {nvidia_smi_line()}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
