"""Public API: one-shot `render()` and the progressive renderer (port of
raytracer_tpu/api.py, single device).

ProgressiveRenderer is the analog of Raytracing_Renderer
(`src/raytracer/raytracing_renderer.odin`): it owns the baked scene on one
torch device, the camera, the accumulation buffer and the frame counter.
`begin_frame()` replays the scene's change journal (any change re-bakes)
and resets accumulation; a dirty camera also resets it. `step()` runs one
progressive sample unless the accumulation limit is reached. Checkpoints
use the JAX package's .npz format, so one moves between the two packages.

As in the JAX package, accel="cuda" falls back to accel="bvh" (the binary
tree's kernels), with a logged warning, for a t_min other than 1e-3 and for
a 4-wide tree whose stack need exceeds the kernels' stack.

Not ported yet, each raising with its ROADMAP.md port queue item: ReSTIR,
adaptive sampling, spp_batch > 1, denoise/preview/AOVs, multi-device
meshes, and the refit / material-only fast paths of the journal replay.
"""

from __future__ import annotations

import logging
from typing import Optional

import numpy as np
import torch

from raytracer_tpu_torch.integrator.wavefront import render_frame
from raytracer_tpu_torch.ops import binary_traverse
from raytracer_tpu_torch.ops.camera import Camera
from raytracer_tpu_torch.ops.quad_traverse import CAP, T_MIN
from raytracer_tpu_torch.scene.device_scene import bake_scene
from raytracer_tpu_torch.scene.model import Scene
from raytracer_tpu_torch.utils.config import RenderConfig

log = logging.getLogger(__name__)


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported yet: ROADMAP.md port queue item {item}")


def _check_ported(cfg: RenderConfig):
    """Raise for configuration modes the port does not run yet."""
    if cfg.use_restir:
        raise _not_ported("ReSTIR DI (use_restir)", "P10")
    if cfg.adaptive_tol > 0:
        raise _not_ported("adaptive sampling (adaptive_tol)", "P8")
    if cfg.spp_batch > 1:
        raise _not_ported("spp batching (spp_batch > 1)", "P9")
    if cfg.denoise_preview:
        raise _not_ported("the preview denoiser (denoise_preview)", "P7")


class ProgressiveRenderer:
    """Single-device progressive renderer on `device` ("cuda" or "cpu";
    on "cpu" the traversal kernels run as their plain torch versions)."""

    def __init__(self, scene: Scene, camera: Optional[Camera] = None,
                 config: Optional[RenderConfig] = None, device="cuda",
                 mesh=None):
        if mesh is not None:
            raise _not_ported("multi-device rendering (mesh)", "P12")
        self.scene = scene
        self.device = torch.device(device)
        self.config = (config or RenderConfig()).resolve_accel()
        _check_ported(self.config)
        if (self.config.accel == "cuda"
                and abs(self.config.t_min - T_MIN) > 1e-9):
            # The 4-wide kernels fix the reference's traceRayEXT t_min of
            # 1e-3; another t_min renders on the binary tree's kernels.
            log.warning(
                "t_min=%g unsupported by accel='cuda' (kernel assumes "
                "1e-3); falling back to accel='bvh'", self.config.t_min)
            self.config = self.config.replace(accel="bvh")
        if self.config.stable_bake:
            log.info("stable_bake has no effect yet (ROADMAP.md port queue "
                     "item P5): bakes are exact-shape, the same image")
        self.camera = camera or Camera.create(
            position=(0.0, 0.0, -3.0),
            aspect=self.config.width / self.config.height,
        )
        self._bake()
        # The bake consumed the scene's current state.
        scene.drain_changes()
        self.accum = self._zeros()
        self.frame = 0
        self._camera_ubo_dev = None
        # The last step's ray counts (i64[] device tensors: rays_traced,
        # shadow_rays, total_rays), read without a sync until asked for.
        self.last_stats = None

    def _bake(self):
        self.device_scene, self._host_bvh = bake_scene(
            self.scene, leaf_size=self.config.bvh_leaf_size,
            device=self.device)
        ds = self.device_scene
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
            raise ValueError(
                f"BVH depth {ds.bvh_max_depth} exceeds the binary traversal "
                f"stack (STACK_CAP={binary_traverse.STACK_CAP}); a stackless "
                "walk for such trees is ROADMAP.md port queue item P2")

    def _zeros(self):
        return torch.zeros((self.config.num_pixels, 3), dtype=torch.float32,
                           device=self.device)

    # -- scene/camera plumbing ------------------------------------------
    def set_camera(self, camera: Camera):
        self.camera = camera
        self.camera.dirty = True

    def _replay_changes(self) -> bool:
        """Drain the journal; any change re-bakes the whole scene (the
        refit and material-only fast paths are port queue item P3)."""
        if not self.scene.changes:
            return False
        self.scene.drain_changes()
        self._bake()
        return True

    def begin_frame(self):
        scene_changed = self._replay_changes()
        if scene_changed or self.camera.dirty:
            self.reset_accumulation()
        if self.camera.dirty or self._camera_ubo_dev is None:
            self._refresh_camera_ubo()
            self.camera.clear_dirty()

    def reset_accumulation(self):
        self.accum = self._zeros()
        self.frame = 0

    # -- the hot loop ---------------------------------------------------
    def step(self) -> bool:
        """One progressive sample. Returns False when the accumulation
        limit has been reached (frame skipped)."""
        self.begin_frame()
        limit = self.config.accumulation_limit
        if limit is not None and self.frame >= limit:
            return False
        self.accum, self.last_stats = render_frame(
            self.device_scene, self._camera_ubo_dev, self.accum, self.frame,
            self.config, with_stats=True)
        self.frame += 1
        return True

    def render(self, num_frames: int) -> np.ndarray:
        """Accumulate `num_frames` more samples and return the image."""
        target = self.frame + num_frames
        while self.frame < target:
            if not self.step():
                break
        return self.image()

    def image(self, denoise: Optional[bool] = None) -> np.ndarray:
        """Accumulated linear radiance f32[H,W,3] on the host."""
        if denoise:
            raise _not_ported("the preview denoiser", "P7")
        arr = self.accum.detach().cpu().numpy()
        return arr.reshape(self.config.height, self.config.width, 3)

    def preview_image(self, *args, **kwargs):
        raise _not_ported("preview_image", "P7")

    def aovs(self):
        raise _not_ported("aovs", "P7")

    def _refresh_camera_ubo(self):
        """The one place the device camera UBO is built from the camera."""
        mats = self.camera.matrices()
        self._camera_ubo_dev = {
            k: torch.from_numpy(np.ascontiguousarray(mats[k])).to(self.device)
            for k in ("inverse_view", "inverse_proj")
        }
        return self._camera_ubo_dev

    # -- checkpoint / resume ---------------------------------------------
    def save_checkpoint(self, path: str):
        np.savez_compressed(
            path, accum=self.accum.detach().cpu().numpy(), frame=self.frame,
            width=self.config.width, height=self.config.height,
        )

    def load_checkpoint(self, path: str):
        data = np.load(path)
        if (int(data["width"]) != self.config.width
                or int(data["height"]) != self.config.height):
            raise ValueError(
                f"checkpoint is {int(data['width'])}x{int(data['height'])}, "
                f"renderer is {self.config.width}x{self.config.height}")
        self.accum = torch.from_numpy(
            np.asarray(data["accum"], np.float32)).to(self.device)
        self.frame = int(data["frame"])
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
