"""The benchmark's per-layer metric `trace_live_pct`
(portbench/metrics/trace_live_pct.py), read through the harness's own
loader on a hand-made run: the live share of the traversal calls' lanes,
and nothing where no call was logged."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "portbench"), ROOT]

from harness import cell as cells  # noqa: E402
from harness import spec  # noqa: E402


def _read(calls):
    run = cells.Run()
    run.traversal_calls = calls
    return spec.readers([{"name": "trace_live_pct"}])["trace_live_pct"](run)


def test_the_live_share_of_the_lanes_launched():
    # A full-size bounce, its shadow rays, and a compacted bounce: 1,500
    # live of 5,120 lanes.
    calls = [("intersect_quad", 2048, 1024), ("occlusion_quad", 2048, 300),
             ("intersect_quad", 1024, 176), ("occlusion_quad", 0, 0)]
    assert _read(calls) == pytest.approx(100.0 * 1500 / 5120)
    assert _read([("intersect_quad", 64, 64)]) == 100.0


@pytest.mark.parametrize("calls", [[], [("intersect_quad", 0, 0)]])
def test_no_lanes_read_nothing(calls):
    assert _read(calls) is None


@pytest.mark.parametrize("name", ["glassatrium300k-nee-d8",
                                  "atrium300k-nee-d8"])
def test_the_deep_cells_report_it(name):
    assert "trace_live_pct" in {m["name"] for m in spec.cell(name).per_layer}
