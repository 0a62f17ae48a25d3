"""The port's SSIM CLI (raytracer_tpu_torch/compare.py) against the JAX
package's (raytracer_tpu/compare.py), and the port's profiling helpers
(raytracer_tpu_torch/utils/profiling.py) on the CPU. The images are made
by numpy from a seed."""

import os

import numpy as np
import pytest
import torch

from raytracer_tpu import compare as jcompare
from raytracer_tpu.utils import profiling as jprofiling
from raytracer_tpu_torch import compare as tcompare
from raytracer_tpu_torch.utils import profiling
from raytracer_tpu_torch.utils.image import read_png, write_png

torch.set_num_threads(1)  # see test_torch_ops.py


@pytest.fixture(scope="module")
def pngs(tmp_path_factory):
    """Two 40x48 PNGs: a smooth image and a noisy copy of it."""
    d = tmp_path_factory.mktemp("png")
    rng = np.random.default_rng(21)
    y, x = np.mgrid[0:40, 0:48] / 48.0
    a = np.stack([x, y, 0.5 * (x + y)], axis=-1).astype(np.float32)
    b = np.clip(a + rng.normal(0.0, 0.08, a.shape), 0, 1).astype(np.float32)
    paths = (str(d / "a.png"), str(d / "b.png"))
    for path, img in zip(paths, (a, b)):
        write_png(path, img)
    return paths


@pytest.mark.parametrize("threshold", [None, 0.5, 0.99])
def test_compare_matches_jax(pngs, tmp_path, capsys, threshold):
    flags = [] if threshold is None else ["--threshold", str(threshold)]
    rcs, lines = [], []
    for i, main in enumerate((jcompare.main, tcompare.main)):
        diff = str(tmp_path / f"diff{i}.png")
        rcs.append(main([*pngs, "--diff", diff, *flags]))
        lines.append(capsys.readouterr().out)
    assert lines[0] == lines[1]
    assert lines[1].startswith("SSIM: ") and len(lines[1].split()) == 2
    assert rcs[0] == rcs[1]
    score = float(lines[1].split()[1])
    assert rcs[1] == (1 if threshold is not None and score < threshold
                      else 0)
    np.testing.assert_array_equal(read_png(str(tmp_path / "diff0.png")),
                                  read_png(str(tmp_path / "diff1.png")))


def test_compare_identical_images(pngs, capsys):
    assert tcompare.main([pngs[0], pngs[0], "--threshold", "1.0"]) == 0
    assert capsys.readouterr().out == "SSIM: 1.000000\n"


def test_phase_timer_counts_and_reports():
    t = profiling.PhaseTimer()
    x = torch.arange(4.0)
    for _ in range(3):
        with t.phase("render", [x * 2]):
            pass
    with t.phase("gather"):
        pass
    assert t.counts == {"render": 3, "gather": 1}
    assert all(v >= 0.0 for v in t.totals.values())
    report = t.report().splitlines()
    assert len(report) == 2 and "x3" in " ".join(report)
    # The same totals give the JAX timer's report, line for line.
    j = jprofiling.PhaseTimer()
    j.totals, j.counts = dict(t.totals), dict(t.counts)
    assert t.report() == j.report()
    assert profiling.PhaseTimer().report() == ""


def test_sync_reads_the_first_element():
    x = torch.tensor([2.5, 1.0])
    assert profiling.sync(x) == 2.5
    assert profiling.sync((x + 1, x)) == 3.5
    assert profiling.sync({"a": [x * 2]}) == 5.0


def test_device_trace_writes_a_trace(tmp_path):
    with profiling.device_trace(str(tmp_path)):
        (torch.ones(8) * 3).sum()
    assert any(name.endswith(".json") for name in os.listdir(tmp_path))
