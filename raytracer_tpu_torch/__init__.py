"""raytracer_tpu_torch — the wavefront path tracer of raytracer_tpu, ported
to PyTorch with hand-written CUDA traversal kernels for NVIDIA Hopper.

The JAX package (raytracer_tpu) is the reference; each module here mirrors
the module of the same name there and is tested against it. The port
imports torch and never jax.

  scene/       scene model, JSON/glTF/OBJ loaders, procedural scenes (numpy
               copies), and the bake to torch tensors (DeviceScene)
  accel/       binned-SAH BVH build (numpy + native C++) and the 4-wide
               collapse (copies)
  ops/         rng (TEA-16 + LCG), math3d, brdf (GGX), camera, brute
               intersection, and quad_traverse: the CUDA traversal kernels
               (csrc/quad_traverse.cu) with their plain torch versions
  integrator/  the wavefront bounce loop, NEE/MIS, accumulation
  parallel/    pixel-tile rendering over torch.distributed (one rank per
               device) and the ranks' launcher
  utils/       RenderConfig, images (PNG/SSIM), stats, profiling
  api.py       render()/ProgressiveRenderer
  cli.py       python -m raytracer_tpu_torch.cli
  compare.py   python -m raytracer_tpu_torch.compare (the SSIM gate)
"""

__version__ = "0.1.0"

from raytracer_tpu_torch.utils.config import RenderConfig  # noqa: F401


def __getattr__(name):
    # Lazy re-exports keep `import raytracer_tpu_torch` light.
    if name in ("render", "ProgressiveRenderer"):
        import raytracer_tpu_torch.api as api

        return getattr(api, name)
    if name == "Camera":
        from raytracer_tpu_torch.ops.camera import Camera

        return Camera
    if name == "load_scene":
        from raytracer_tpu_torch.scene.loaders import load_scene

        return load_scene
    raise AttributeError(name)
