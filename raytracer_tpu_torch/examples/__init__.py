"""Runnable examples of the port, the JAX package's examples/ on torch:

    python -m raytracer_tpu_torch.examples.interactive_session [--1080p]
    python -m raytracer_tpu_torch.examples.live_edit [out_prefix]
    python -m raytracer_tpu_torch.examples.turntable [--frames N]
    python -m raytracer_tpu_torch.examples.multichip --spawn N (or under
        torchrun --nproc-per-node N)

Each takes --device (default cuda; cpu runs the kernels' plain torch
versions) and a size flag, so it also runs small on the CPU."""
