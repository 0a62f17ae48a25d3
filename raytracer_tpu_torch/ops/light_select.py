"""NEE light selection (simple.rchit:507-541): per lane, the power/dist²
weights of the first L lights, the pick through their running sum, its
selection pdf, and the emissive-hit MIS's un-skipped total and weight.

`select_lights` computes, for each lane of N, over the light rows
(center f32[L,3], power f32[L], object i32[L]):

  - w_l = power_l / max(|pos - center_l|², 0.001), summed in column order
    into `total` (the lights of the lane's own object `obj` at 0) and
    `total_all` (none skipped);
  - with a draw (`do_nee` given): where do_nee & total > 0, one
    LCG step of the seed (ops/rng.py's rnd) gives r1 = r * total, and the
    first column whose running sum reaches r1 is `selected` (`found`),
    with `pdf` = its weight / max(total, 1e-20); the seed advances only
    there. Elsewhere selected 0, found False, pdf 0 and the seed as it was;
  - with MIS (`light_index` given): `total_all`, and `w_this`, the
    un-skipped weight of light clamp(light_index, 0, L-1).

No [N, L] tensor is made. On CUDA tensors it launches the hand-written
kernel of csrc/light_select.cu (built by ops/_build.py); on CPU tensors it
runs the kernel's plain torch version below, which loops over the columns
in the same order. A CUDA tensor never takes the plain version: the launch
succeeds or the wrapper raises. Every float operation is written in the
same order in both, and the kernel is built with -fmad=false, so on the
card the kernel equals its plain version bit for bit.

The sums are the shader's sequential ones. The weights' [N, L] form this
replaces summed with torch's reduction and scanned with torch's cumsum,
which round in another order: a pick whose r1 lies within a few ulp of a
running sum may differ, and totals differ in the last bits.

Counters of the active tracer (utils/profiling.py): `light_select.lanes`,
the lanes of each call, and `light_select.drawn`, the lanes that drew (on
the card written by the kernel into an int64 allocated for the call, read
at export). Neither costs anything when tracing is off.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from raytracer_tpu_torch.ops import rng
from raytracer_tpu_torch.ops.quad_traverse import _ptr, _require, _stream
from raytracer_tpu_torch.utils import profiling

# Kernel launches, counted where the CUDA wrapper launches (never by the
# plain version), so a caller can show that a run went through the kernel.
launches = 0


def reset_launch_counts():
    global launches
    launches = 0


class LightSelection(NamedTuple):
    selected: Optional[torch.Tensor]  # i32[N] (None without a draw)
    found: Optional[torch.Tensor]  # bool[N]
    pdf: Optional[torch.Tensor]  # f32[N] the pick's selection pdf
    seed: Optional[torch.Tensor]  # i64[N] the seed after the draw
    total_all: Optional[torch.Tensor]  # f32[N] (None without MIS)
    w_this: Optional[torch.Tensor]  # f32[N]


def select_lights(pos, centers, powers, objects, obj=None, do_nee=None,
                  seed=None, light_index=None) -> LightSelection:
    """The selection of each lane of `pos` f32[N,3] over the light rows
    `centers` f32[L,3], `powers` f32[L], `objects` i32[L] (L >= 1): with
    a draw when `do_nee` bool[N] is given (and then `obj` i32[N] and
    `seed`, uint32 in i64[N]; unused otherwise), with MIS's outputs when
    `light_index` i32[N] is (module docstring). Fields not asked for are
    None."""
    num_lights = powers.shape[0]
    if num_lights < 1:
        raise ValueError("the selection needs at least one light")
    n = pos.shape[0]
    profiling.count("light_select.lanes", n)
    select = _select_cuda if pos.is_cuda else _select_plain
    out, drawn = select(pos, centers, powers, objects, obj, do_nee, seed,
                        light_index, profiling.counting())
    if drawn is not None:
        profiling.count("light_select.drawn", drawn)
    return out


def _weight(px, py, pz, center, power):
    """power / max(|p - center|², 0.001) in the kernel's order; `center`
    f32[3] or [N,3], `power` f32[] or [N]."""
    dx = px - center[..., 0]
    dy = py - center[..., 1]
    dz = pz - center[..., 2]
    return power / torch.clamp_min(dx * dx + dy * dy + dz * dz, 0.001)


def _select_plain(pos, centers, powers, objects, obj, do_nee, seed,
                  light_index, counting):
    """The kernel's plain torch version: the same two passes over the
    columns, every lane at once. Returns (LightSelection, drawn i64[] when
    it draws and `counting`, else None)."""
    draw = do_nee is not None
    mis = light_index is not None
    num_lights = powers.shape[0]
    px, py, pz = pos.unbind(1)
    zero = torch.zeros_like(px)
    total = total_all = zero
    for col in range(num_lights):
        w = _weight(px, py, pz, centers[col], powers[col])
        if mis:
            total_all = total_all + w
        if draw:
            total = total + torch.where(objects[col] == obj, 0.0, w)
    selected = found = pdf = seed_out = drawn = None
    if draw:
        r, advanced = rng.rnd(seed)
        drew = do_nee & (total > 0.0)
        seed_out = torch.where(drew, advanced, seed)
        r1 = r * total
        run = zero
        selected = torch.zeros_like(obj)
        found = torch.zeros_like(drew)
        w_sel = zero
        for col in range(num_lights):
            w = _weight(px, py, pz, centers[col], powers[col])
            w = torch.where(objects[col] == obj, 0.0, w)
            run = run + w
            take = drew & ~found & (run >= r1)
            selected = torch.where(take, col, selected)
            w_sel = torch.where(take, w, w_sel)
            found = found | take
        pdf = torch.where(found, w_sel / torch.clamp_min(total, 1e-20), 0.0)
        if counting:
            drawn = drew.sum()
    total_out = w_this = None
    if mis:
        li = torch.clamp(light_index, 0, num_lights - 1).long()
        total_out = total_all
        w_this = _weight(px, py, pz, centers[li], powers[li])
    return LightSelection(selected, found, pdf, seed_out, total_out,
                          w_this), drawn


def _select_cuda(pos, centers, powers, objects, obj, do_nee, seed,
                 light_index, counting):
    """The kernel on the card (csrc/light_select.cu). Returns
    (LightSelection, drawn i64[] when `counting`, else None)."""
    global launches
    from raytracer_tpu_torch.ops import _build

    draw = do_nee is not None
    mis = light_index is not None
    if not draw:
        obj = seed = None
    dev = pos.device
    n = pos.shape[0]
    num_lights = powers.shape[0]
    _require("pos", pos, torch.float32, (n, 3), dev)
    _require("centers", centers, torch.float32, (num_lights, 3), dev)
    _require("powers", powers, torch.float32, (num_lights,), dev)
    _require("objects", objects, torch.int32, (num_lights,), dev)

    def out(dtype):
        return torch.empty((n,), dtype=dtype, device=dev)

    selected = found = pdf = seed_out = total_all = w_this = drawn = None
    if draw:
        _require("obj", obj, torch.int32, (n,), dev)
        _require("do_nee", do_nee, torch.bool, (n,), dev)
        _require("seed", seed, torch.int64, (n,), dev)
        selected, found = out(torch.int32), out(torch.bool)
        pdf, seed_out = out(torch.float32), out(torch.int64)
        if counting:
            drawn = torch.zeros((), dtype=torch.int64, device=dev)
    if mis:
        _require("light_index", light_index, torch.int32, (n,), dev)
        total_all, w_this = out(torch.float32), out(torch.float32)
    result = LightSelection(selected, found, pdf, seed_out, total_all,
                            w_this)
    if n == 0:
        return result, drawn

    def ptr(t):
        return None if t is None else _ptr(t)

    with torch.cuda.device(dev):
        rc = _build.light_select_lib().light_select(
            _ptr(pos), ptr(obj), ptr(do_nee), ptr(seed), ptr(light_index),
            _ptr(centers), _ptr(powers), _ptr(objects), num_lights, n,
            int(draw), int(mis), ptr(selected), ptr(found), ptr(pdf),
            ptr(seed_out), ptr(total_all), ptr(w_this), ptr(drawn),
            _stream(dev))
    if rc != 0:
        raise RuntimeError(f"light_select launch failed: cudaError {rc}")
    launches += 1
    return result, drawn
