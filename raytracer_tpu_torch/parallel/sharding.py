"""Multi-device rendering: pixel-tile data parallelism over
torch.distributed (port of raytracer_tpu/parallel/sharding.py).

  - One process per device (torchrun, or launch.spawn), and a 1-D
    `DeviceMesh` over the default process group's world, dimension
    "pixels": the counterpart of the JAX package's jax.sharding.Mesh.
  - The scene is replicated: every rank bakes the same scene and replays
    the same edits, and the renderer compares a digest of each bake across
    the ranks (check_replicas). The accumulation buffer f32[N,3], the
    ReSTIR reservoir and the adaptive state are split by rows: rank r owns
    the contiguous pixels [r * n_local, (r + 1) * n_local).
  - Each rank renders its tile with the single-device functions' tile
    arguments; lanes seed their streams and make their camera rays from
    their global pixel ids, so the image is bit-identical to the
    single-device one.
  - No collective runs in a frame, but ReSTIR's halo exchange with the
    previous and the next rank (integrator/restir.py:_exchange_halo). The
    readouts gather: ProgressiveRenderer.image(), aovs(), preview_image(),
    save_checkpoint(); adaptive_converged_fraction() sums.

Transport: NCCL when each rank has a card of its own. NCCL refuses two
ranks on one card, so such ranks use gloo, whose collectives take CPU
tensors: under gloo, card tensors travel through host memory (comm_device).
The tiles still render on the card."""

from __future__ import annotations

import hashlib
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from raytracer_tpu_torch.integrator.wavefront import (
    accumulate,
    render_wavefront,
)
from raytracer_tpu_torch.utils.config import RenderConfig

AXIS = "pixels"


def make_pixel_mesh(device_type: Optional[str] = None) -> DeviceMesh:
    """The 1-D "pixels" mesh over the default process group's world (a
    world of 1 is a mesh too). `device_type` is "cuda" (the default: each
    rank's card is cuda:(LOCAL_RANK % device_count), made current here) or
    "cpu". Raises without a process group, and for "cuda" without a card."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "a pixel mesh needs a torch.distributed process group: start "
            "the program under torchrun, or call "
            "torch.distributed.init_process_group first "
            "(raytracer_tpu_torch.parallel.launch.spawn does it)")
    device_type = device_type or "cuda"
    if device_type == "cuda":
        torch.cuda.set_device(local_device("cuda"))
    return DeviceMesh.from_group(dist.group.WORLD, device_type,
                                 mesh_dim_names=(AXIS,))


def local_device(device_type: str) -> torch.device:
    """This rank's device: cuda:(LOCAL_RANK % device_count), or the CPU.
    Raises for "cuda" without a card: the render never moves elsewhere."""
    if device_type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("a cuda pixel mesh was asked for, and "
                           "torch.cuda.is_available() is False")
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    return torch.device("cuda", local % torch.cuda.device_count())


def mesh_group(mesh: DeviceMesh):
    return mesh.get_group(AXIS)


def tile_of(cfg: RenderConfig, mesh: DeviceMesh):
    """(pixel_start, n_local) of this rank's tile of cfg's image; raises
    ValueError when the pixels do not tile over the mesh."""
    n_dev = mesh.size()
    if cfg.num_pixels % n_dev:
        raise ValueError(f"{cfg.width}x{cfg.height} pixels do not tile over "
                         f"{n_dev} devices")
    n_local = cfg.num_pixels // n_dev
    return dist.get_rank(mesh_group(mesh)) * n_local, n_local


# -- placement: this rank's rows of a full tensor, or the tensor whole ----

def _rows(a: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    n_local = a.shape[0] // mesh.size()
    start = dist.get_rank(mesh_group(mesh)) * n_local
    return a[start:start + n_local].clone()


def shard_accum(accum, mesh: DeviceMesh):
    """This rank's rows of the accumulation buffer f32[N,3]."""
    return _rows(accum, mesh)


def shard_reservoir(reservoir, mesh: DeviceMesh):
    """This rank's rows of every field of a ReSTIR Reservoir."""
    return type(reservoir)(*(_rows(a, mesh) for a in reservoir))


def shard_adaptive(state, mesh: DeviceMesh):
    """This rank's rows of every field of an AdaptiveState."""
    return type(state)(*(_rows(a, mesh) for a in state))


def replicate(tree, mesh: DeviceMesh):
    """The scene and the camera stay whole: every rank holds its own copy
    (its own bake), so there is nothing to move."""
    return tree


# -- the tiles -----------------------------------------------------------

def render_frame_sharded(scene, camera_ubo, accum, frame_number,
                         cfg: RenderConfig, mesh: DeviceMesh,
                         with_stats: bool = False):
    """One progressive step of this rank's tile: its accumulation rows
    (and its ray counts with with_stats=True). cfg.spp_batch > 1 renders
    the tile's S samples in one wavefront, as on one device."""
    from raytracer_tpu_torch.integrator.wavefront import (
        render_tile_spp_batched,
    )

    start, n_local = tile_of(cfg, mesh)
    if cfg.spp_batch > 1:
        return render_tile_spp_batched(
            scene, camera_ubo, accum, frame_number, cfg, pixel_start=start,
            n_local=n_local, with_stats=with_stats)
    out = render_wavefront(scene, camera_ubo, frame_number, cfg,
                           pixel_start=start, num_pixels=n_local,
                           with_stats=with_stats)
    if with_stats:
        return accumulate(accum, out[0], frame_number), out[1]
    return accumulate(accum, out, frame_number)


def render_frame_restir_sharded(scene, camera_ubo, accum, reservoir,
                                frame_number, cfg: RenderConfig,
                                mesh: DeviceMesh, with_stats: bool = False,
                                timer=None):
    """One ReSTIR DI step of this rank's tile: (accum rows, reservoir rows)
    (and the ray counts). Spatial reuse reads the neighbouring tiles'
    halo rows, one exchange a frame; bit-identical to the single-device
    pass whenever each tile is at least one halo tall."""
    from raytracer_tpu_torch.integrator.restir import render_frame_restir

    start, n_local = tile_of(cfg, mesh)
    return render_frame_restir(
        scene, camera_ubo, accum, reservoir, frame_number, cfg,
        pixel_start=start, num_pixels=n_local, num_tiles=mesh.size(),
        group=mesh_group(mesh), with_stats=with_stats, timer=timer)


def render_radiance_sharded(scene, camera_ubo, frame_number,
                            cfg: RenderConfig, mesh: DeviceMesh):
    """One raw radiance sample of this rank's tile (the preview path)."""
    start, n_local = tile_of(cfg, mesh)
    return render_wavefront(scene, camera_ubo, frame_number, cfg,
                            pixel_start=start, num_pixels=n_local)


def gbuffer_sharded(scene, camera_ubo, cfg: RenderConfig, mesh: DeviceMesh):
    """The denoiser's G-buffer (normal, depth, albedo) of this rank's
    tile: one primary trace, no collective."""
    from raytracer_tpu_torch.integrator.denoise import gbuffer_pass

    start, n_local = tile_of(cfg, mesh)
    return gbuffer_pass(scene, camera_ubo, cfg, pixel_start=start,
                        num_pixels=n_local)


def render_frame_adaptive_sharded(scene, camera_ubo, state,
                                  cfg: RenderConfig, mesh: DeviceMesh,
                                  with_stats: bool = False):
    """One adaptive step of this rank's tile (its AdaptiveState rows).
    Convergence is per pixel, so tiles never communicate."""
    from raytracer_tpu_torch.integrator.adaptive import render_frame_adaptive

    start, n_local = tile_of(cfg, mesh)
    return render_frame_adaptive(scene, camera_ubo, state, cfg,
                                 pixel_start=start, num_pixels=n_local,
                                 with_stats=with_stats)


# -- collectives -----------------------------------------------------------

def comm_device(group, device: torch.device) -> torch.device:
    """Where `group`'s collectives take tensors of `device`: the device
    itself, but the CPU for card tensors under gloo."""
    if device.type != "cpu" and dist.get_backend(group) == "gloo":
        return torch.device("cpu")
    return device


def gather_rows(tile: torch.Tensor, group) -> torch.Tensor:
    """Every rank's tile of `group`, in rank order, as one tensor on the
    tile's device (the whole image on every rank)."""
    comm = comm_device(group, tile.device)
    part = tile.contiguous().to(comm)
    parts = [torch.empty_like(part) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, part, group=group)
    return torch.cat(parts).to(tile.device)


def all_reduce_sum(value: torch.Tensor, group) -> torch.Tensor:
    """The sum of `value` over `group`'s ranks, on value's device."""
    comm = comm_device(group, value.device)
    total = value.to(comm, copy=True)
    dist.all_reduce(total, group=group)
    return total.to(value.device)


def scene_digest(device_scene) -> bytes:
    """SHA-256 of a baked scene: every field's bytes and shape, in order."""
    import dataclasses

    h = hashlib.sha256()
    for f in dataclasses.fields(device_scene):
        value = getattr(device_scene, f.name)
        h.update(f.name.encode())
        if isinstance(value, torch.Tensor):
            arr = value.detach().contiguous().cpu().numpy()
            h.update(f"{arr.dtype}{arr.shape}".encode())
            h.update(memoryview(np.ascontiguousarray(arr)).cast("B"))
        else:
            h.update(repr(value).encode())
    return h.digest()


def check_replicas(device_scene, group):
    """Raise unless every rank of `group` holds the same bake: the ranks
    replay the same edits and must render one scene."""
    mine = torch.tensor(list(scene_digest(device_scene)), dtype=torch.uint8)
    dev = device_scene.device
    every = gather_rows(mine.to(dev)[None], group).cpu()
    differ = [r for r in range(every.shape[0]) if not torch.equal(every[r],
                                                                    mine)]
    if differ:
        raise RuntimeError(
            f"rank {dist.get_rank(group)}: the baked scene differs from "
            f"ranks {differ}'s (every rank must bake the same scene and "
            "replay the same edits)")


class ShardedProgressiveRenderer:
    """`api.ProgressiveRenderer(mesh=...)` under a name of its own, the
    mesh defaulting to the whole world (make_pixel_mesh on `device`'s
    type)."""

    def __new__(cls, scene, camera=None, config=None,
                mesh: Optional[DeviceMesh] = None, device="cuda"):
        from raytracer_tpu_torch.api import ProgressiveRenderer

        if mesh is None:
            mesh = make_pixel_mesh(torch.device(device).type)
        return ProgressiveRenderer(scene, camera, config, device=device,
                                   mesh=mesh)
