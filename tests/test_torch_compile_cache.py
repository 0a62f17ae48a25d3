"""The port's build directory (utils/compile_cache.py, ops/_build.py):
RAYTRACER_TPU_CACHE_DIR, the JAX package's variable, moves the built
libraries under a subdirectory of the port's own; without it they go to
the in-package raytracer_tpu_torch/_build/. Each case runs in a fresh
process, as the variable is read at each build. The build is the C++ BVH
builder with g++ (no card needed)."""

import os
import shutil
import subprocess
import sys

import pytest

from raytracer_tpu_torch.ops import _build
from raytracer_tpu_torch.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code, env_extra):
    env = {k: v for k, v in os.environ.items()
           if k != compile_cache.ENV_VAR}
    env.update(env_extra, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return proc.stdout.strip().splitlines()[-1]


@pytest.mark.skipif(shutil.which("g++") is None, reason="needs g++")
def test_cache_dir_moves_the_build(tmp_path):
    code = ("from raytracer_tpu_torch.accel import native_builder as nb\n"
            "from raytracer_tpu_torch.ops import _build\n"
            "print(nb._compile(), _build.build_dir())\n")
    lib, where = _run(code, {compile_cache.ENV_VAR: str(tmp_path)}).split()
    want = os.path.join(str(tmp_path), "raytracer_tpu_torch")
    assert where == want
    assert os.path.dirname(lib) == want and os.path.exists(lib)


def test_default_is_the_package_build_dir(monkeypatch):
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    assert compile_cache.build_dir() == os.path.join(
        REPO, "raytracer_tpu_torch", "_build")
    assert _build.build_dir() == compile_cache.build_dir()
    monkeypatch.setenv(compile_cache.ENV_VAR, "/some/cache")
    assert _build.build_dir() == "/some/cache/raytracer_tpu_torch"
    monkeypatch.setattr(_build, "BUILD_DIR", "/elsewhere")
    assert _build.build_dir() == "/elsewhere"
