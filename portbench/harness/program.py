"""The system under test, as the benchmark drives it: the PyTorch and CUDA
port's ProgressiveRenderer, handed the scene description as the port's
own Scene. This module is the only one of the harness that imports the
program.

With tracing on, `Spans` wraps the calls from the integrator into the
layers below it in `record_function` ranges named `portbench.<call>`, and
keeps each traversal call's lanes and live mask, for the kernels' bytes.
"""

from __future__ import annotations

import torch

RESTIR_RANGE = "portbench.restir_direct"
TRAVERSAL_CALLS = ("intersect_quad", "occlusion_quad")


def program_scene(desc):
    """The port's Scene of the description `desc`."""
    from raytracer_tpu_torch.scene.model import (
        Material,
        Mesh,
        Scene,
    )

    scene = Scene()
    for mt in desc.materials:
        scene.add_material(Material(
            name=mt.name, albedo=tuple(mt.albedo),
            emission_color=tuple(mt.emission_color),
            emission_power=mt.emission_power, roughness=mt.roughness,
            metallic=mt.metallic, transmission=mt.transmission, ior=mt.ior,
            dispersion=mt.dispersion))
    for mesh in desc.meshes:
        scene.add_mesh(Mesh(name=mesh.name, positions=mesh.positions,
                            normals=mesh.normals, indices=mesh.indices))
    for ob in desc.objects:
        scene.add_object(ob.name, ob.mesh, ob.material, position=ob.position,
                         rotation=ob.rotation, scale=ob.scale)
    return scene


def renderer(desc, settings: dict, camera: dict, device):
    """A ProgressiveRenderer over `desc` with RenderConfig(**settings) and
    the camera at camera["position"] looking at camera["target"]."""
    from raytracer_tpu_torch.api import ProgressiveRenderer
    from raytracer_tpu_torch.ops.camera import Camera
    from raytracer_tpu_torch.utils.config import RenderConfig

    cfg = RenderConfig(**settings)
    cam = Camera.create(position=tuple(camera["position"]),
                        aspect=cfg.width / cfg.height,
                        target=tuple(camera["target"]))
    return ProgressiveRenderer(program_scene(desc), cam, cfg, device=device)


class Spans:
    """record_function ranges around the integrator's calls into ReSTIR
    (`restir_direct`) and the traversal wrappers (`intersect_quad`,
    `occlusion_quad`, as the integrator module names them). `calls` logs
    every traversal call while `recording` is set: (name, lanes, live
    mask)."""

    def __init__(self):
        from raytracer_tpu_torch.integrator import restir, wavefront

        self.recording = False
        self.calls = []
        self._undo = []
        self._wrap(restir, "restir_direct", RESTIR_RANGE, log=False)
        for name in TRAVERSAL_CALLS:
            self._wrap(wavefront, name, f"portbench.{name}", log=True)

    def _wrap(self, module, name, label, log):
        own = getattr(module, name)

        def wrapped(*args, **kwargs):
            if log and self.recording:
                mask = kwargs.get("active_mask")
                self.calls.append((name, int(args[0].shape[0]), mask))
            with torch.profiler.record_function(label):
                return own(*args, **kwargs)

        setattr(module, name, wrapped)
        self._undo.append((module, name, own))

    def close(self):
        for module, name, own in reversed(self._undo):
            setattr(module, name, own)
        self._undo = []

    def lanes(self):
        """[(name, lanes, live lanes)] of the recorded calls (one device
        read of each live mask, after the profiled frames)."""
        return [(name, n, n if mask is None else int(mask.sum()))
                for name, n, mask in self.calls]
