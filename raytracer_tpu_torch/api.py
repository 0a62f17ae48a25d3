"""Public API: one-shot `render()` and the progressive renderer (port of
raytracer_tpu/api.py).

ProgressiveRenderer is the analog of Raytracing_Renderer
(`src/raytracer/raytracing_renderer.odin`): it owns the baked scene on one
torch device, the camera, the accumulation buffer and the frame counter.
`begin_frame()` replays the scene's change journal into the cheapest
device update (a prebaked scene, material tables only, a refit of the
tree, or a full bake) and resets accumulation; a dirty camera also resets
it. `prebake_async()` bakes a topology edit on a background thread while
the last frame stays on screen. `step()` runs one
progressive step (cfg.spp_batch samples in one launch) unless the
accumulation limit is reached; with cfg.adaptive_tol > 0 it samples only
the pixels that have not converged (integrator/adaptive.py). `image()`
can run the a-trous denoiser on the way out, `aovs()` reads the
denoiser's G-buffer and `preview_image()` renders a throwaway sample at a
lower resolution (integrator/denoise.py). With cfg.use_restir the step
runs ReSTIR DI (integrator/restir.py) and carries its reservoir from frame
to frame; a camera move or a scene edit empties it with the accumulation.
Checkpoints use the JAX package's .npz format, adaptive and ReSTIR state
included, so one moves between the two packages.

With `mesh` (parallel/sharding.py:make_pixel_mesh: one rank per device
under torch.distributed) the renderer is one rank of a pixel-tile render:
every rank bakes the same scene and replays the same edits (a digest of
each bake is compared across the ranks), owns the accumulation, reservoir
and adaptive rows of its contiguous pixel tile, and renders that tile with
global pixel ids, so the image is bit-identical to a single-device
render. image(), aovs(), preview_image() and save_checkpoint() gather the
tiles (rank 0 writes the checkpoint); every rank must call them together.
`timer` (utils/profiling.py PhaseTimer, off by default) times each rank's
tile render, ReSTIR halo exchange and image gather; one made with
`record=True` is also the active tracer of `step()` and `begin_frame()`,
and keeps the program's spans and counters (`rt.step` and the spans under
it) until its `export()`.

As in the JAX package, accel="cuda" falls back to accel="bvh" (the binary
tree's kernels), with a logged warning, for a t_min other than 1e-3 and for
a 4-wide tree whose stack need exceeds the kernels' stack; accel="bvh"
traces a binary tree too deep for K3/K4's stack with the JAX package's
skip-link walk (ops/traverse.py), also with a warning. Bakes are
stable-shape when cfg.stable_bake (the default, as in the JAX package) and
cut into parts past PALLAS_VMEM_BUDGET, which is None here
(scene/device_scene.py).
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import threading
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from raytracer_tpu_torch.integrator.adaptive import (
    AdaptiveState,
    active_mask,
    render_frame_adaptive,
)
from raytracer_tpu_torch.integrator.denoise import (
    atrous_denoise,
    gbuffer_pass,
    upscale_bilinear,
)
from raytracer_tpu_torch.integrator.restir import (
    Reservoir,
    render_frame_restir,
)
from raytracer_tpu_torch.integrator.wavefront import (
    render_frame,
    render_wavefront,
)
from raytracer_tpu_torch.ops import binary_traverse
from raytracer_tpu_torch.ops.camera import Camera
from raytracer_tpu_torch.ops.quad_traverse import CAP, T_MIN
from raytracer_tpu_torch.parallel import sharding
from raytracer_tpu_torch.scene.device_scene import (
    bake_scene,
    update_materials,
)
from raytracer_tpu_torch.scene.model import Scene, SceneChangeType
from raytracer_tpu_torch.utils import profiling
from raytracer_tpu_torch.utils.config import RenderConfig

log = logging.getLogger(__name__)

# The JAX package's budget for the TPU kernel's scene tables in VMEM, past
# which accel="pallas" bakes cut the tree into parts. A GPU has no VMEM and
# the card's 80 GB hold every in-repo scene, so it is None here: every bake
# is one part. Tests set it, as the JAX tests set theirs, to exercise
# multi-part bakes.
PALLAS_VMEM_BUDGET = None


def _check_modes(cfg: RenderConfig):
    """Raise for a combination of modes that cannot run together."""
    if cfg.adaptive_tol > 0 and cfg.use_restir:
        raise ValueError("adaptive_tol and use_restir are mutually exclusive "
                         "(ReSTIR carries its own temporal state)")


def _mesh_device(mesh, device) -> torch.device:
    """This rank's device for a render on `mesh`: `device` ("cuda" means
    the rank's card, cuda:(LOCAL_RANK % device_count)). Raises outside a
    process group, for anything but a 1-D DeviceMesh, and for a device of
    another type than the mesh's."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "a mesh renders under a torch.distributed process group: start "
            "the program under torchrun, or call "
            "torch.distributed.init_process_group, then pass "
            "parallel.sharding.make_pixel_mesh()")
    if not (isinstance(mesh, sharding.DeviceMesh) and mesh.ndim == 1):
        raise TypeError(f"mesh must be a 1-D DeviceMesh "
                        f"(parallel.sharding.make_pixel_mesh), not {mesh!r}")
    device = torch.device(device)
    if device.type != mesh.device_type:
        raise ValueError(f"device {device} on a {mesh.device_type} mesh")
    if device.index is None:
        device = sharding.local_device(device.type)
    return device


class ProgressiveRenderer:
    """Progressive renderer on `device` ("cuda" or "cpu"; on "cpu" the
    traversal kernels run as their plain torch versions); with `mesh`, one
    rank of a pixel-tile render (see the module docstring)."""

    def __init__(self, scene: Scene, camera: Optional[Camera] = None,
                 config: Optional[RenderConfig] = None, device="cuda",
                 mesh=None):
        self.scene = scene
        self.mesh = mesh
        self.device = (torch.device(device) if mesh is None
                       else _mesh_device(mesh, device))
        self.config = (config or RenderConfig()).resolve_accel()
        _check_modes(self.config)
        if (self.config.accel == "cuda"
                and abs(self.config.t_min - T_MIN) > 1e-9):
            # The 4-wide kernels fix the reference's traceRayEXT t_min of
            # 1e-3; another t_min renders on the binary tree's kernels.
            log.warning(
                "t_min=%g unsupported by accel='cuda' (kernel assumes "
                "1e-3); falling back to accel='bvh'", self.config.t_min)
            self.config = self.config.replace(accel="bvh")
        self.camera = camera or Camera.create(
            position=(0.0, 0.0, -3.0),
            aspect=self.config.width / self.config.height,
        )
        # This rank's pixels [pixel_start, pixel_start + rows): every pixel
        # on one device.
        self._pixel_start, self._rows = 0, self.config.num_pixels
        self.timer = None  # utils/profiling.PhaseTimer: phases and spans
        if mesh is not None:
            self._init_mesh()
        self._install(*bake_scene(self.scene, **self._bake_kwargs()))
        # The bake consumed the scene's current state.
        scene.drain_changes()
        self._prebake = None  # in-flight background bake (prebake_async)
        # How the last begin_frame() replayed the journal: None (nothing to
        # replay), "prebake", "materials", "refit" or "bake".
        self.last_replay = None
        self.accum = self._zeros()
        self.frame = 0
        self._camera_ubo_dev = None
        # Denoiser G-buffers by (width, height): the full resolution's and
        # each preview resolution's, dropped on a camera or scene change.
        self._gbuffers = {}
        # The last step's ray counts (i64[] device tensors: rays_traced,
        # shadow_rays, total_rays), read without a sync until asked for.
        self.last_stats = None
        self.reservoir = None
        if self.config.use_restir:
            self.reservoir = Reservoir.empty(self._rows, self.device)
        self.adaptive = None
        if self.config.adaptive_tol > 0:
            self.adaptive = AdaptiveState.empty(self._rows, self.device)

    def _init_mesh(self):
        """This rank's tile (ValueError when the pixels do not tile), and
        the warning for ReSTIR tiles shorter than the spatial halo."""
        cfg = self.config
        self._pixel_start, self._rows = sharding.tile_of(cfg, self.mesh)
        if cfg.use_restir:
            halo_rows = int(cfg.restir_spatial_radius) + 1
            if self._rows < halo_rows * cfg.width:
                # Spatial taps past the clamped halo are dropped, so the
                # image is no longer the single-device one.
                log.warning(
                    "ReSTIR tile height %d rows < spatial halo %d rows: "
                    "cross-tile spatial taps will be clipped (render is no "
                    "longer bit-identical to single-device)",
                    self._rows // cfg.width, halo_rows)

    def _group(self):
        return sharding.mesh_group(self.mesh)

    def _span(self, name, holder):
        """The timer's phase `name` (ended after a device sync on
        holder[0]), or nothing when the timer is off."""
        if self.timer is None:
            return contextlib.nullcontext()
        return self.timer.phase(name, holder)

    def _bake_kwargs(self):
        """The one set of bake settings for the first bake, the journal
        replay's bakes and refits, update_materials' fallback and the
        background prebake, so every re-bake has the same shapes (stable
        bakes keep small topology edits inside them). The budget applies
        to the 4-wide tree's kernels only, as the JAX package's to its
        Pallas kernels."""
        budget = PALLAS_VMEM_BUDGET if self.config.accel == "cuda" else None
        return dict(leaf_size=self.config.bvh_leaf_size, device=self.device,
                    pallas_budget_bytes=budget,
                    stable_shapes=self.config.stable_bake)

    def _install(self, device_scene, host_bvh):
        """Make (device_scene, host_bvh) the scene that frames render, after
        the checks every bake passes: a 4-wide tree whose stack need
        exceeds the kernels' CAP falls back to accel="bvh", and accel="bvh"
        traces a tree deeper than K3/K4's stack with the skip-link walk,
        whose tables the bake packed for it. A refit and a material update
        keep the tree's topology, hence its stack need and depth, so these
        checks give them the answer the tree's bake got; they run all the
        same."""
        self.device_scene, self._host_bvh = device_scene, host_bvh
        ds = device_scene
        if self.mesh is not None:
            sharding.check_replicas(ds, self._group())
        if self.config.accel == "cuda" and ds.q_stack_need > CAP:
            # Binned SAH can emit highly skewed trees on adversarial input;
            # the bake holds the binary tree too, so no second bake.
            log.warning(
                "quad-BVH stack need %d exceeds the quad traversal kernel's "
                "stack (CAP=%d); falling back to accel='bvh'",
                ds.q_stack_need, CAP)
            self.config = self.config.replace(accel="bvh")
        if (self.config.accel == "bvh"
                and not binary_traverse.stack_fits(ds.bvh_max_depth)):
            log.warning(
                "BVH depth %d exceeds the binary traversal kernels' stack "
                "(STACK_CAP=%d); tracing with the skip-link walk",
                ds.bvh_max_depth, binary_traverse.STACK_CAP)

    def _zeros(self):
        return torch.zeros((self._rows, 3), dtype=torch.float32,
                           device=self.device)

    # -- scene/camera plumbing ------------------------------------------
    def set_camera(self, camera: Camera):
        self.camera = camera
        self.camera.dirty = True

    def prebake_async(self):
        """Start baking the scene's current state (pending journal
        included) on a background thread, so a topology edit's bake and
        upload leave the edit-to-frame path: the frame in flight, or the
        editor's last preview, stays on screen, and the next begin_frame()
        takes the prebaked scene instead of baking (the JAX package's
        prebake_async). The native builder runs through ctypes, which
        releases the GIL, so the host bake overlaps the frame.

        On CUDA the worker uploads on a stream of its own and records an
        event after the upload; _take_prebake() makes the render stream
        wait on it. The prebake is keyed on the journal's length: an edit
        that lands after it makes it stale, and the replay then bakes
        synchronously."""
        key = len(self.scene.changes)
        holder = {}
        kwargs = self._bake_kwargs()
        dev = self.device

        def work():
            try:
                if dev.type == "cuda":
                    with torch.cuda.device(dev):
                        stream = torch.cuda.Stream(dev)
                        with torch.cuda.stream(stream):
                            holder["result"] = bake_scene(self.scene,
                                                          **kwargs)
                            holder["event"] = torch.cuda.Event()
                            holder["event"].record(stream)
                else:
                    holder["result"] = bake_scene(self.scene, **kwargs)
            except Exception as e:  # noqa: BLE001 (surfaced at take time)
                holder["error"] = e

        t = threading.Thread(target=work, daemon=True,
                             name="raytracer-prebake")
        t.start()
        self._prebake = (key, t, holder)

    def _take_prebake(self):
        """Join and return a valid prebaked (device_scene, host_bvh), or
        None: no prebake, a stale one, or one that failed (logged; the
        replay then bakes synchronously). A CUDA prebake's tensors are
        handed to the render stream: it waits on the upload's event, and
        each tensor is recorded on it, so the caching allocator reuses no
        block of theirs while the render stream may still read it."""
        pb, self._prebake = self._prebake, None
        if pb is None:
            return None
        key, t, holder = pb
        if key != len(self.scene.changes):
            return None  # edits landed after the prebake: stale
        t.join()
        if "error" in holder:
            log.warning("background prebake failed (%s); re-baking "
                        "synchronously", holder["error"])
            return None
        ds, bvh = holder["result"]
        if "event" in holder:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(holder["event"])
            for f in dataclasses.fields(ds):
                value = getattr(ds, f.name)
                if isinstance(value, torch.Tensor):
                    value.record_stream(stream)
        return ds, bvh

    def _replay_changes(self) -> bool:
        """Drain the journal into the cheapest device update (the JAX
        package's branches, raytracing_renderer.odin:141-187): a valid
        prebake; material edits alone rewrite the material and light tables
        (update_materials); transform edits, with or without material edits,
        refit the tree (bake_scene(reuse_bvh=...)); anything else, which
        changes the triangles, bakes anew. Records the branch in
        last_replay."""
        if not self.scene.changes:
            self._prebake = None  # nothing pending: any prebake is a no-op
            self.last_replay = None
            return False
        prebaked = self._take_prebake()
        types = {c.type for c in self.scene.drain_changes()}
        kwargs = self._bake_kwargs()
        if prebaked is not None:
            # The background bake consumed exactly this journal state.
            self.last_replay = "prebake"
            self._install(*prebaked)
        elif types == {SceneChangeType.MATERIAL_CHANGED}:
            old = self.device_scene
            new = update_materials(old, self.scene, **kwargs)
            # update_materials bakes anew when the emissive set changed.
            # The held BVH stays, as in the JAX package: it covers the same
            # triangles, and a later refit repacks every node array from it.
            self.last_replay = ("materials" if new.ptris is old.ptris
                                else "bake")
            self._install(new, self._host_bvh)
        elif types <= {SceneChangeType.OBJECT_TRANSFORM_CHANGED,
                       SceneChangeType.MATERIAL_CHANGED}:
            # Transform edits keep the triangle count: refit the existing
            # tree (TLAS UPDATE mode, gpu_scene.odin:457-482).
            self.last_replay = "refit"
            self._install(*bake_scene(self.scene, reuse_bvh=self._host_bvh,
                                      **kwargs))
        else:
            self.last_replay = "bake"
            self._install(*bake_scene(self.scene, **kwargs))
        return True

    def begin_frame(self):
        with profiling.activated(self.timer):
            scene_changed = self._replay_changes()
            if scene_changed or self.camera.dirty:
                self.reset_accumulation()
            if scene_changed:
                # Edits can move geometry or change albedo.
                self._drop_gbuffers()
            if self.camera.dirty or self._camera_ubo_dev is None:
                self._refresh_camera_ubo()
                self.camera.clear_dirty()
                self._drop_gbuffers()

    def _drop_gbuffers(self):
        self._gbuffers = {}

    def _gbuffer_for(self, cfg: RenderConfig):
        """The whole G-buffer at cfg's resolution with the current camera
        (on a mesh, each rank traces its tile and the tiles are gathered:
        the filter couples neighbouring rows)."""
        key = (cfg.width, cfg.height)
        if key not in self._gbuffers:
            ubo = self._ensure_camera_ubo()
            if self.mesh is None:
                gbuf = gbuffer_pass(self.device_scene, ubo, cfg)
            else:
                gbuf = tuple(self._gather(a) for a in sharding.gbuffer_sharded(
                    self.device_scene, ubo, cfg, self.mesh))
            self._gbuffers[key] = gbuf
        return self._gbuffers[key]

    def _gather(self, tile):
        """Every rank's tile of `tile`, gathered in pixel order (the
        timer's "gather" phase)."""
        done = []
        with self._span("gather", done):
            whole = sharding.gather_rows(tile, self._group())
            done.append(whole)
        return whole

    def reset_accumulation(self):
        self.accum = self._zeros()
        self.frame = 0
        if self.reservoir is not None:
            # Temporal reuse is valid only while the accumulation is.
            self.reservoir = Reservoir.empty(self._rows, self.device)
        if self.adaptive is not None:
            # Stale variance would freeze pixels against the old image.
            self.adaptive = AdaptiveState.empty(self._rows, self.device)

    # -- the hot loop ---------------------------------------------------
    def step(self) -> bool:
        """One progressive step: cfg.spp_batch samples (default 1) in one
        launch. Returns False when the accumulation limit has been reached
        (frame skipped). `self.frame` counts samples accumulated, not
        launches. The step is the `rt.step` span of its frame, with a
        recording timer the active tracer."""
        with profiling.activated(self.timer), profiling.span(
                "rt.step", frame=self.frame):
            self.begin_frame()
            limit = self.config.accumulation_limit
            if limit is not None and self.frame >= limit:
                return False
            if self.mesh is not None:
                self._step_sharded()
            elif self.adaptive is not None:
                self.adaptive, self.last_stats = render_frame_adaptive(
                    self.device_scene, self._camera_ubo_dev, self.adaptive,
                    self.config, with_stats=True)
                # self.accum mirrors the image (checkpoints, the denoiser).
                self.accum = self.adaptive.mean
            elif self.reservoir is not None:
                self.accum, self.reservoir, self.last_stats = (
                    render_frame_restir(
                        self.device_scene, self._camera_ubo_dev, self.accum,
                        self.reservoir, self.frame, self.config,
                        with_stats=True))
            else:
                self.accum, self.last_stats = render_frame(
                    self.device_scene, self._camera_ubo_dev, self.accum,
                    self.frame, self.config, with_stats=True)
            self.frame += self.config.spp_batch
            return True

    def _step_sharded(self):
        """This rank's tile of one step (parallel/sharding.py), timed as
        the "tile_render" phase."""
        ds, ubo, cfg = self.device_scene, self._camera_ubo_dev, self.config
        done = []
        with self._span("tile_render", done):
            if self.adaptive is not None:
                self.adaptive, self.last_stats = (
                    sharding.render_frame_adaptive_sharded(
                        ds, ubo, self.adaptive, cfg, self.mesh,
                        with_stats=True))
                self.accum = self.adaptive.mean
            elif self.reservoir is not None:
                self.accum, self.reservoir, self.last_stats = (
                    sharding.render_frame_restir_sharded(
                        ds, ubo, self.accum, self.reservoir, self.frame, cfg,
                        self.mesh, with_stats=True, timer=self.timer))
            else:
                self.accum, self.last_stats = sharding.render_frame_sharded(
                    ds, ubo, self.accum, self.frame, cfg, self.mesh,
                    with_stats=True)
            done.append(self.accum)

    def adaptive_converged_fraction(self) -> float:
        """Fraction of pixels that have stopped sampling (0.0 when adaptive
        sampling is off). One device readback (on a mesh, a sum over the
        ranks)."""
        if self.adaptive is None:
            return 0.0
        active = active_mask(self.adaptive, self.config).sum()
        if self.mesh is not None:
            active = sharding.all_reduce_sum(active, self._group())
        return float(1.0 - int(active) / self.config.num_pixels)

    def render(self, num_frames: int) -> np.ndarray:
        """Accumulate `num_frames` more samples and return the image. Each
        step takes cfg.spp_batch samples, so a count that is not a multiple
        of it ends past the target, as the JAX renderer does."""
        target = self.frame + num_frames
        while self.frame < target:
            if not self.step():
                break
        return self.image()

    def image(self, denoise: Optional[bool] = None) -> np.ndarray:
        """Accumulated linear radiance f32[H,W,3] on the host.

        `denoise` (default cfg.denoise_preview) runs the a-trous filter
        (integrator/denoise.py) on the device-resident accumulation; only
        the filtered result crosses to the host, and the accumulation is
        never modified."""
        use = self.config.denoise_preview if denoise is None else denoise
        out = self.accum if self.mesh is None else self._gather(self.accum)
        if use:
            out = atrous_denoise(
                out, *self._gbuffer_for(self.config),
                self.config.height,
                self.config.width,
                iterations=self.config.denoise_iterations)
        arr = out.detach().cpu().numpy()
        return arr.reshape(self.config.height, self.config.width, 3)

    def aovs(self) -> dict:
        """Arbitrary-output-variable images from one primary trace (the
        denoiser's G-buffer, cached until the camera or scene changes):
        {"normal": f32[H,W,3], "depth": f32[H,W], "albedo": f32[H,W,3]};
        miss pixels have normal 0, depth denoise.MISS_DEPTH, albedo 1."""
        self.begin_frame()
        nrm, depth, albedo = (a.detach().cpu().numpy()
                              for a in self._gbuffer_for(self.config))
        h, w = self.config.height, self.config.width
        return {"normal": nrm.reshape(h, w, 3), "depth": depth.reshape(h, w),
                "albedo": albedo.reshape(h, w, 3)}

    def preview_image(self, scale: int = 4, denoise: Optional[bool] = None,
                      upscale: bool = True) -> np.ndarray:
        """A low-latency preview f32[H,W,3]: one fresh sample at 1/scale
        resolution with the current camera and scene, optionally filtered
        by the a-trous denoiser at that resolution, then bilinearly
        upscaled to (height, width); `upscale=False` returns it at its
        native f32[H//scale, W//scale, 3].

        Pending scene edits and camera changes are applied first (the
        begin_frame a step() would run). Beyond that the preview is a side
        channel: the accumulation, the frame counter and the adaptive state
        are untouched. The sample uses the current frame index's RNG
        streams, so repeated calls between steps give the same image and
        successive frames decorrelate."""
        self.begin_frame()
        use_denoise = (self.config.denoise_preview if denoise is None
                       else denoise)
        s = max(int(scale), 1)
        pw = max(self.config.width // s, 1)
        ph = max(self.config.height // s, 1)
        # A plain sample: adaptive (and ReSTIR) state belongs to the
        # accumulation, not to a throwaway sample.
        cfg_p = self.config.replace(width=pw, height=ph, use_restir=False,
                                    adaptive_tol=0.0)
        ubo = self._ensure_camera_ubo()
        if self.mesh is None:
            rad = render_wavefront(self.device_scene, ubo, self.frame, cfg_p)
        else:  # ValueError when the preview's pixels do not tile
            rad = self._gather(sharding.render_radiance_sharded(
                self.device_scene, ubo, self.frame, cfg_p, self.mesh))
        if use_denoise:
            rad = atrous_denoise(rad, *self._gbuffer_for(cfg_p), ph, pw,
                                 iterations=self.config.denoise_iterations)
        if not upscale:
            return rad.detach().cpu().numpy().reshape(ph, pw, 3)
        if (pw, ph) != (self.config.width, self.config.height):
            rad = upscale_bilinear(rad, ph, pw, self.config.height,
                                   self.config.width)
        return rad.detach().cpu().numpy().reshape(
            self.config.height, self.config.width, 3)

    def _refresh_camera_ubo(self):
        """The one place the device camera UBO is built from the camera."""
        mats = self.camera.matrices()
        self._camera_ubo_dev = {
            k: torch.from_numpy(np.ascontiguousarray(mats[k])).to(self.device)
            for k in ("inverse_view", "inverse_proj")
        }
        return self._camera_ubo_dev

    def _ensure_camera_ubo(self):
        if self._camera_ubo_dev is None:
            self._refresh_camera_ubo()
        return self._camera_ubo_dev

    # -- checkpoint / resume ---------------------------------------------
    def _whole(self, a):
        """`a` of every pixel on the host: on a mesh, the ranks' rows
        gathered."""
        if self.mesh is not None:
            a = self._gather(a)
        return a.detach().cpu().numpy()

    def save_checkpoint(self, path: str):
        """Write the render state as the JAX package's .npz. On a mesh the
        rows are gathered and rank 0 writes; every rank returns once the
        file is written."""
        extra = {}
        if self.reservoir is not None:
            # The temporal history is part of the render state.
            extra = {f"reservoir_{k}": self._whole(v)
                     for k, v in self.reservoir._asdict().items()}
        if self.adaptive is not None:
            # The mean is the accumulation (saved as accum); m2 and count
            # resume the convergence decisions exactly. count is written as
            # uint32, as the JAX package writes it.
            extra.update({
                "adaptive_m2": self._whole(self.adaptive.m2),
                "adaptive_count": self._whole(self.adaptive.count).astype(
                    np.uint32),
            })
        accum = self._whole(self.accum)
        if self.mesh is None or dist.get_rank(self._group()) == 0:
            np.savez_compressed(
                path, accum=accum, frame=self.frame,
                width=self.config.width, height=self.config.height, **extra,
            )
        if self.mesh is not None:
            # The other ranks return once rank 0 has written the file.
            sharding.all_reduce_sum(torch.zeros(1, device=self.device),
                                    self._group())

    def load_checkpoint(self, path: str):
        data = np.load(path)
        if (int(data["width"]) != self.config.width
                or int(data["height"]) != self.config.height):
            raise ValueError(
                f"checkpoint is {int(data['width'])}x{int(data['height'])}, "
                f"renderer is {self.config.width}x{self.config.height}")
        # This rank's rows of each array (every row on one device).
        rows = slice(self._pixel_start, self._pixel_start + self._rows)
        self.accum = torch.from_numpy(
            np.array(data["accum"][rows], np.float32)).to(self.device)
        self.frame = int(data["frame"])
        if self.reservoir is not None:
            if "reservoir_weight_sum" in data:
                self.reservoir = Reservoir(**{
                    k: torch.from_numpy(np.array(
                        data[f"reservoir_{k}"][rows])).to(self.device)
                    for k in Reservoir._fields})
            else:
                # No reservoir in the checkpoint: the accumulation resumes
                # and temporal reuse restarts.
                self.reservoir = Reservoir.empty(self._rows, self.device)
        if self.adaptive is not None:
            n = self._rows
            if "adaptive_m2" in data:
                m2 = torch.from_numpy(np.array(data["adaptive_m2"][rows],
                                               np.float32))
                count = torch.from_numpy(np.array(
                    data["adaptive_count"][rows], np.int64))
            else:
                # A plain checkpoint has no variance history: m2 = 0 would
                # retire every pixel at once and freeze the render, so m2 =
                # +inf keeps every pixel sampling, like a plain render.
                log.warning(
                    "resuming a non-adaptive checkpoint with adaptive "
                    "sampling: no variance history, convergence detection "
                    "disabled for this render")
                m2 = torch.full((n,), float("inf"), dtype=torch.float32)
                count = torch.full((n,), self.frame, dtype=torch.int64)
            self.adaptive = AdaptiveState(
                mean=self.accum, m2=m2.to(self.device),
                count=count.to(self.device))
        # The caller asserts the camera/scene match the checkpointed render:
        # materialize the UBO and clear the dirty flag so the next
        # begin_frame() keeps the restored accumulation.
        self._refresh_camera_ubo()
        self.camera.clear_dirty()


def render(scene: Scene, camera: Optional[Camera] = None,
           config: Optional[RenderConfig] = None, num_frames: int = 1,
           device="cuda") -> np.ndarray:
    """One-shot render: `num_frames` progressive samples, returns
    f32[H,W,3] linear radiance."""
    return ProgressiveRenderer(scene, camera, config, device).render(
        num_frames)
