"""The benchmark harness of raytracer_tpu_torch (see portbench/run.py)."""
