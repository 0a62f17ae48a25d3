from setuptools import find_packages, setup

setup(
    name="raytracer_tpu",
    version="0.1.0",
    description=(
        "TPU-native wavefront path tracer (JAX/Pallas) with the "
        "capabilities of ARTurleite6/RayTracer"
    ),
    # raytracer_tpu_torch: the PyTorch/CUDA port (needs torch; its CUDA
    # sources are compiled at first use, so they ship as package data).
    packages=find_packages(include=["raytracer_tpu*", "raytracer_tpu_torch*"]),
    package_data={"raytracer_tpu_torch": ["csrc/*.cu"]},
    python_requires=">=3.10",
    install_requires=["jax", "numpy", "pillow"],
    entry_points={
        "console_scripts": ["rt-tpu=raytracer_tpu.cli:main"],
    },
)
