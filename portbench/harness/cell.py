"""One run of one cell: set-up, the timed window, the traced frames, and
the comparison with the plain reference.

Set-up: the scene description from the cell's generator, its materials
drawn around their own values from the seed; the renderer (which bakes
the scene and loads the kernels from the build cache); the traffic's warm
frames. The window: one viewer in a closed loop, each frame `step()` and
then a device sync (the frame is presented), until `seconds` have passed.
With `trace`, a fixed count of the window's frames run under
torch.profiler, with the harness's ranges around the calls into the
layers; the host's per-layer readings come from the frames before them,
as the host runs later frames slower once the profiler has been on. Once
the window has closed and the peak memory has been read, the program's
outputs at the sampled pixels are copied out, the program is freed, and
the reference judges them (check.py).
"""

from __future__ import annotations

import gc
import sys
import time

import numpy as np
import torch

from harness import check, program, refrestir, scenedesc
from harness import trace as tracing

E2E = ("frame_ms", "frame_p90_ms", "peak_mem_GiB", "setup_s")


class Run:
    """What the per-layer readers (metrics/*.py) read."""

    def __init__(self):
        self.bake_s = None
        # Host ms of the window's frames (traced: those before the profile).
        self.enqueue_ms = []
        self.before_ms = []
        self.trace = None
        self.traversal_calls = []
        self.num_triangles = 0


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _log(msg):
    print(f"portbench: {msg}", file=sys.stderr, flush=True)


def settings_of(cell) -> dict:
    s = dict(cell.config["render"])
    s.update(cell.traffic["render"])
    s["width"], s["height"] = cell.config["width"], cell.config["height"]
    return s


def scene_of(cell, seed: int):
    desc = cell.build_scene(**cell.config["scene"]["args"])
    scenedesc.perturb_materials(desc, seed, cell.config["seed_varies"])
    return desc


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, control: bool = False) -> dict:
    """The result of one run (the keys of the result line, and `control`
    with the control's numbers when asked)."""
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    settings = settings_of(cell)
    camera = cell.config["camera"]
    traffic = cell.traffic
    chk = traffic["check"]
    mode = chk["mode"]
    num_pixels = settings["width"] * settings["height"]
    t_entry = time.perf_counter()
    desc = scene_of(cell, seed)
    run = Run()
    run.num_triangles = desc.num_triangles
    pixels = None
    if mode == "step":
        if traffic["warm_frames"] < 2:
            raise ValueError("a ReSTIR check follows the first two frames "
                             "from empty reservoirs: warm_frames >= 2")
        pixels = check.sample_pixels(seed, num_pixels, chk["pixels"])
    spans = program.Spans() if trace else None

    t0 = time.perf_counter()
    r = program.renderer(desc, settings, camera, dev)
    _sync(dev)
    t1 = time.perf_counter()
    run.bake_s = t1 - t0
    start_rows = chain = None
    for i in range(traffic["warm_frames"]):
        r.step()
        _sync(dev)
        if mode == "step" and i < 2:
            pix = torch.from_numpy(pixels).to(dev)
            if i == 0:
                start_rows = r.accum[pix].cpu()
            else:
                chain = {"accum": r.accum[pix].cpu()}
                chain.update({k: getattr(r.reservoir, k)[pix].cpu()
                              for k in check.CHAIN_FIELDS})
    setup_s = time.perf_counter() - t_start
    setup_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    _log(f"set-up {setup_s:.3f} s: imports {t_entry - t_start:.3f} s, "
         f"scene {t0 - t_entry:.3f} s, renderer (the bake and the CUDA "
         f"context) {run.bake_s:.3f} s, {traffic['warm_frames']} warm "
         f"frames {time.perf_counter() - t1:.3f} s; "
         f"{desc.num_triangles} triangles")

    frame_ms, skipped = [], 0
    prof_from = traffic["profile_after"]
    prof_to = prof_from + traffic["profile_frames"]
    prof, prof_wall = None, 0.0
    prev = None
    i = 0
    t_w0 = time.perf_counter()
    while True:
        if trace and i == prof_from:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if cuda:
                acts.append(ProfilerActivity.CUDA)
            prof = profile(activities=acts)
            prof.__enter__()
            spans.recording = True
        if mode == "step":
            prev = (r.accum, r.reservoir, r.frame)
        f0 = time.perf_counter()
        if not r.step():
            skipped += 1
        f1 = time.perf_counter()
        _sync(dev)
        f2 = time.perf_counter()
        frame_ms.append(1e3 * (f2 - f0))
        if trace and prof_from <= i < prof_to:
            prof_wall += f2 - f0
        elif not trace or i < prof_from:
            run.enqueue_ms.append(1e3 * (f1 - f0))
            run.before_ms.append(frame_ms[-1])
        i += 1
        if trace and i == prof_to:
            spans.recording = False
            prof.__exit__(None, None, None)
        if f2 - t_w0 >= seconds and not (trace and i < prof_to):
            break
    window_s = time.perf_counter() - t_w0
    window_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    frames = len(frame_ms)
    q = np.percentile(frame_ms, [0, 50, 90, 100])
    _log(f"window {window_s:.3f} s, {frames} frames, {r.frame} samples "
         f"accumulated; frame ms min {q[0]:.3f} median {q[1]:.3f} p90 "
         f"{q[2]:.3f} max {q[3]:.3f}; first {np.round(frame_ms[:3], 3)} "
         f"last {np.round(frame_ms[-3:], 3)}")

    if trace:
        run.traversal_calls = spans.lanes()
        spans.close()
        run.trace = tracing.summarize(
            prof.profiler.kineto_results.events(), traffic["profile_frames"],
            prof_wall, program.RESTIR_RANGE)
        del prof

    ref_cfg = check.reference_settings(settings)
    if mode == "full_history":
        total = int(r.frame)
        count = max(chk["min_pixels"], chk["lanes"] // max(total, 1))
        pixels = check.sample_pixels(seed, num_pixels, count)
        pix = torch.from_numpy(pixels).to(dev)
        state = {"frames": total, "accum": r.accum[pix].cpu()}
    else:
        pix = torch.from_numpy(pixels).to(dev)
        accum0, res0, f = prev
        read = refrestir.pixels_read(ref_cfg, pix, f)
        if control:
            read = torch.unique(torch.cat([read, refrestir.pixels_read(
                ref_cfg, pix, f, torch.bfloat16)]))
        rows = {k: getattr(res0, k)[read].cpu()
                for k in refrestir.FIELDS}
        state = {"frame": int(f), "prev_accum": accum0[pix].cpu(),
                 "accum": r.accum[pix].cpu(),
                 "light_index": r.reservoir.light_index[pix].cpu(),
                 "start": start_rows, "chain": chain, "read": read.cpu(),
                 "rows": rows}
    del r, prev
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    numbers, extra = _judge(desc, settings, camera, dev, mode, chk, pixels,
                            state, torch.float32, None)
    correct, table = check.verdict(numbers, traffic["limits"])
    _log(f"reference {time.perf_counter() - t_ref:.3f} s over "
         f"{len(pixels)} pixels")
    out = {"correct": bool(correct), "attempted": frames, "failed": skipped,
           "check": table, "setup_s": setup_s, "window_s": window_s,
           "frame_ms": frame_ms, "window_peak": window_peak,
           "memory_peak": max(setup_peak, window_peak), "run": run}
    if control:
        low, _ = _judge(desc, settings, camera, dev, mode, chk, pixels,
                        state, torch.bfloat16, extra)
        out["control"] = low
    return out


def _judge(desc, settings, camera, dev, mode, chk, pixels, state, dt,
           truth):
    """The numbers of the program's outputs in `state` against the
    reference; with dt below float32 and `truth` (the float32 reference's
    outputs), the numbers of the reference in dtype dt put in the
    program's place."""
    ref = check.Reference(desc, settings, camera, dev, dt)
    pix = torch.from_numpy(pixels).to(dev)
    if mode == "full_history":
        acc = ref.accumulation(pix, state["frames"], chk["lanes"]).float()
        if truth is None:
            mx, mean = check.gaps(state["accum"], acc)
            return {"max_gap": mx, "mean_gap": mean}, {"accum": acc}
        mx, mean = check.gaps(acc, truth["accum"])
        return {"max_gap": mx, "mean_gap": mean}, None
    read, rows = state["read"].to(dev), state["rows"]

    def prev_of(ids):
        at = torch.searchsorted(read, ids)
        out = {}
        for k, v in rows.items():
            v = v.to(dev)[at]
            out[k] = v.long() if k == "light_index" else v.to(dt)
        return out

    outs = check.step_outputs(ref, pix, dict(state, prev_of=prev_of))
    if truth is None:
        return check.step_numbers(state, outs, state["frame"]), outs
    return check.step_numbers(outs, truth, state["frame"]), None


def e2e_metrics(out) -> dict:
    ms = out["frame_ms"]
    p90 = float(np.percentile(ms, 90)) if ms else float("nan")
    return {
        "frame_ms": {"value": 1e3 * out["window_s"] / max(len(ms), 1),
                     "unit": "ms"},
        "frame_p90_ms": {"value": p90, "unit": "ms"},
        "peak_mem_GiB": {"value": out["window_peak"] / 2**30, "unit": "GiB"},
        "setup_s": {"value": out["setup_s"], "unit": "s"},
    }
