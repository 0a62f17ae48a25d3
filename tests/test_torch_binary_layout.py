"""What the binary tree's traversal kernels (csrc/binary_traverse.cu, K3/K4
of accel="bvh") rely on in the baked arrays and in their wrappers, on the
CPU at small sizes:

  - the child metas sit in the node rows (pnodes lanes 12/13) as exact
    integers in f32, and every node has two real children, so the kernels'
    (int) conversion needs no NaN case;
  - stopping each leaf row at its count (ops/quad_traverse.leaf_counts,
    shared with K1/K2) gives the plain walk's result, closest hit and
    any-hit, at t_min 1e-3 and at 0.01 (a t_min that makes the renderer
    fall back to accel="bvh");
  - the plain walk's stack never holds more than bvh_max_depth + 1
    entries, so the register entry and the shared stack of
    stack_need(scene) = bvh_max_depth + 2 entries hold it;
  - the wrappers refuse a stack need outside 1..STACK_CAP and more rays
    than the int32 counter takes, and give each launch its own counter;
  - the variant lab (lab/quad_variant_lab.py) still finds K1/K2's two
    tuning constants in csrc/quad_traverse.cu, and only there, now that
    the walk they tune lives in csrc/persistent_walk.cuh.

The scenes are the Cornell box and a ~4k-triangle atrium, each baked at
leaf 8 and 16 with the numpy BVH builder."""

import contextlib
import ctypes
import os

import numpy as np
import pytest
import torch

import raytracer_tpu_torch.accel.native_builder as tnative
import raytracer_tpu_torch.scene.benchmark as tbench
import raytracer_tpu_torch.scene.model as tmodel
from raytracer_tpu_torch.lab import quad_variant_lab as qvl
from raytracer_tpu_torch.ops import _build
from raytracer_tpu_torch.ops import binary_traverse as bt
from raytracer_tpu_torch.ops import quad_traverse as qt
from raytracer_tpu_torch.scene.device_scene import bake_scene

SCENES = {"cornell": tmodel.create_cornell_box,
          "atrium4k": lambda: tbench.create_benchmark_atrium(4_000)}
LEAVES = (8, 16)
T_MINS = (1e-3, 0.01)
RAYS = 3000
_bakes = {}


@pytest.fixture(autouse=True)
def numpy_builder(monkeypatch):
    monkeypatch.setattr(tnative, "available", lambda: False)


def _bake(name, leaf):
    """DeviceScene on the CPU, baked once per module."""
    if (name, leaf) not in _bakes:
        _bakes[(name, leaf)] = bake_scene(SCENES[name](), leaf_size=leaf,
                                          device="cpu")[0]
    return _bakes[(name, leaf)]


def _rays(ds, t_min, seed=5):
    """Rays from inside the scene's bounds in random directions (a sixteenth
    along an axis), a quarter of them inactive (t_max = t_min), and a skip
    object each."""
    rng = np.random.default_rng(seed)
    v0 = ds.ptris.view(ds.ptris.shape[0], -1, qt.TRI_STRIDE)[:, :, 0:3]
    v0 = v0.reshape(-1, 3).numpy()
    lo, hi = v0.min(0), v0.max(0)
    o = rng.uniform(lo, hi, (RAYS, 3)).astype(np.float32)
    d = rng.normal(size=(RAYS, 3)).astype(np.float32)
    d[:RAYS // 16, 1:] = 0.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_max = rng.uniform(0.1, 2.0, RAYS).astype(np.float32)
    t_max *= np.float32(np.linalg.norm(hi - lo))
    t_max[rng.uniform(size=RAYS) < 0.25] = np.float32(t_min)
    skip = rng.integers(-1, 6, RAYS).astype(np.int32)
    return (torch.from_numpy(o), torch.from_numpy(d),
            torch.from_numpy(t_max), torch.from_numpy(skip))


def _counted_closest(origin, direction, rows, bt_, btri, bu, bv, t_min):
    """The closest-hit leaf test up to each row's count only, as the
    kernels run it."""
    count = qt.row_counts(rows)
    ox, oy, oz = origin.unbind(1)
    dx, dy, dz = direction.unbind(1)
    for k in range(rows.shape[1] // qt.TRI_STRIDE):
        tri = rows[:, k * qt.TRI_STRIDE:(k + 1) * qt.TRI_STRIDE]
        t, u, v, valid = qt._moller(ox, oy, oz, dx, dy, dz, tri, bt_, t_min)
        valid &= k < count
        bt_ = torch.where(valid, t, bt_)
        btri = torch.where(valid, tri[:, 9].to(torch.int32), btri)
        bu = torch.where(valid, u, bu)
        bv = torch.where(valid, v, bv)
    return bt_, btri, bu, bv


def _counted_any(origin, direction, rows, t_max, skip_f, t_min):
    """The any-hit leaf test up to each row's count only."""
    count = qt.row_counts(rows)
    ox, oy, oz = origin.unbind(1)
    dx, dy, dz = direction.unbind(1)
    found = torch.zeros_like(t_max, dtype=torch.bool)
    for k in range(rows.shape[1] // qt.TRI_STRIDE):
        tri = rows[:, k * qt.TRI_STRIDE:(k + 1) * qt.TRI_STRIDE]
        _, _, _, valid = qt._moller(ox, oy, oz, dx, dy, dz, tri, t_max,
                                    t_min)
        found |= valid & (tri[:, 10] != skip_f) & (k < count)
    return found


@pytest.mark.parametrize("leaf", LEAVES)
@pytest.mark.parametrize("name", sorted(SCENES))
def test_node_rows_hold_exact_child_metas(name, leaf):
    """pnodes lanes 12/13 are exact integers below 2**24 in magnitude: a
    meta >= 0 is an internal row, a meta < 0 the leaf block ~meta. Both
    child boxes of every row are real (no NaN), so no child is absent."""
    ds = _bake(name, leaf)
    metas = ds.pnodes[:, 12:14]
    assert not torch.isnan(ds.pnodes[:, :14]).any()
    assert (metas.abs() < 2 ** 24).all()
    assert torch.equal(metas, metas.trunc())
    ints = metas.to(torch.int32)
    inner, leaves = ints[ints >= 0], ~ints[ints < 0]
    assert (inner < ds.pnodes.shape[0]).all()
    assert (leaves < ds.ptris.shape[0]).all()
    # Every internal row but the root and every leaf block is some row's
    # child exactly once.
    assert sorted(inner.tolist()) == sorted(
        set(range(ds.pnodes.shape[0])) - {ds.binary_root})
    assert sorted(leaves.tolist()) == list(range(ds.ptris.shape[0]))


@pytest.mark.parametrize("t_min", T_MINS)
@pytest.mark.parametrize("leaf", LEAVES)
@pytest.mark.parametrize("name", sorted(SCENES))
def test_closest_stops_at_leaf_counts(name, leaf, t_min):
    """The binary closest-hit walk with each leaf row tested up to its
    count equals the plain version (every slot), bit for bit."""
    ds = _bake(name, leaf)
    o, d, tm, _ = _rays(ds, t_min)
    want = bt._intersect_binary_plain(o, d, tm, t_min, ds.binary_root,
                                      ds.pnodes, ds.ptris)
    got = qt._closest_walk(
        o, d, tm, ds.binary_root, ds.ptris,
        bt._binary_visit(o, qt._inv_dir(d), ds.pnodes, t_min), bt.STACK_CAP,
        t_min, leaf_test=_counted_closest)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert int((want[1] >= 0).sum()) > RAYS // 4


@pytest.mark.parametrize("t_min", T_MINS)
@pytest.mark.parametrize("leaf", LEAVES)
@pytest.mark.parametrize("name", sorted(SCENES))
def test_any_hit_stops_at_leaf_counts(name, leaf, t_min):
    """The binary any-hit walk with each leaf row tested up to its count
    equals the plain version's mask."""
    ds = _bake(name, leaf)
    o, d, tm, skip = _rays(ds, t_min)
    want = bt._occlusion_binary_plain(o, d, tm, skip, t_min, ds.binary_root,
                                      ds.pnodes, ds.ptris)
    got = qt._any_walk(
        o, d, tm, skip, ds.binary_root, ds.ptris,
        bt._binary_visit(o, qt._inv_dir(d), ds.pnodes, t_min), bt.STACK_CAP,
        t_min, leaf_test=_counted_any)
    assert torch.equal(got, want)
    assert 0 < int(want.sum()) < RAYS


@pytest.mark.parametrize("kind", ["closest", "any"])
@pytest.mark.parametrize("leaf", LEAVES)
@pytest.mark.parametrize("name", sorted(SCENES))
def test_stack_occupancy_fits_the_need(name, leaf, kind):
    """The plain walk's stack holds at most bvh_max_depth + 1 entries after
    any node step: one entry in the kernels' register and at most
    bvh_max_depth in the shared stack, which stack_need sizes at
    bvh_max_depth + 2 entries a thread."""
    ds = _bake(name, leaf)
    o, d, tm, skip = _rays(ds, 1e-3)
    visit = bt._binary_visit(o, qt._inv_dir(d), ds.pnodes, 1e-3)
    deepest = [0]

    def watched(stack, sp, rays, node, t_cap):
        visit(stack, sp, rays, node, t_cap)
        deepest[0] = max(deepest[0], int(sp[rays].max()))

    if kind == "closest":
        qt._closest_walk(o, d, tm, ds.binary_root, ds.ptris, watched,
                         bt.STACK_CAP, 1e-3)
    else:
        qt._any_walk(o, d, tm, skip, ds.binary_root, ds.ptris, watched,
                     bt.STACK_CAP, 1e-3)
    assert 2 <= deepest[0] <= ds.bvh_max_depth + 1
    assert bt.stack_need(ds) == ds.bvh_max_depth + 2 <= bt.STACK_CAP
    print(f"{name} leaf {leaf} {kind}: depth {ds.bvh_max_depth}, deepest "
          f"stack {deepest[0]}")


@pytest.mark.parametrize("need", [0, -1, bt.STACK_CAP + 1])
def test_launch_args_refuse_a_need_outside_the_cap(need):
    ds = _bake("cornell", 8)
    with pytest.raises(ValueError, match="stack need"):
        bt._launch_args(ds, torch.device("cpu"), need)


def test_launch_args_default_to_the_trees_need():
    """K3/K4's scene arguments: the binary root and node rows, ptris, the
    leaf counts shared with K1/K2, the leaf size, stack_need(scene) (or the
    need asked for) and a new int32[1] counter for each launch."""
    ds = _bake("atrium4k", 16)
    cpu = torch.device("cpu")
    args, counter = bt._launch_args(ds, cpu)
    args2, counter2 = bt._launch_args(ds, cpu, bt.STACK_CAP)
    assert counter.shape == (1,) and counter.dtype == torch.int32
    assert counter2.data_ptr() != counter.data_ptr()
    assert args[0] == ds.binary_root
    assert args[1].value == ds.pnodes.data_ptr()
    assert args[2].value == ds.ptris.data_ptr()
    assert args[3].value == qt.leaf_counts(ds).data_ptr()
    assert args[4:6] == (16, ds.bvh_max_depth + 2)
    assert args2[5] == bt.STACK_CAP
    assert args[6].value == counter.data_ptr()


class _FakeLib:
    """A stand-in for the built library: records each launch's arguments
    and returns `rc`."""

    def __init__(self, rc=0):
        self.rc = rc
        self.calls = []

    def binary_closest(self, *args):
        self.calls.append(("closest", args))
        return self.rc

    def binary_occlusion(self, *args):
        self.calls.append(("occlusion", args))
        return self.rc


@pytest.fixture
def fake_lib(monkeypatch):
    """K3/K4's wrappers on CPU tensors against a _FakeLib, with the device
    context and the stream stubbed; the counters the launches got are kept
    alive in `lib.counters`."""
    lib = _FakeLib()
    lib.counters = []
    launch_args = bt._launch_args

    def spy(*a, **kw):
        args, counter = launch_args(*a, **kw)
        lib.counters.append(counter)
        return args, counter

    monkeypatch.setattr(_build, "binary_traverse_lib", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(bt, "_stream", lambda dev: ctypes.c_void_p(0))
    monkeypatch.setattr(bt, "_launch_args", spy)
    return lib


def test_each_launch_has_its_own_ray_counter(fake_lib):
    """Three launches get three counters; each passes the launch's t_min,
    the stack need asked for (default the tree's) and the counter, and adds
    one to its kernel's launch count."""
    ds = _bake("cornell", 8)
    o, d, tm, skip = _rays(ds, 0.01)
    bt.reset_launch_counts()
    bt._intersect_binary_cuda(o, d, tm, 0.01, ds)
    bt._intersect_binary_cuda(o, d, tm, 1e-3, ds, need=bt.STACK_CAP)
    bt._occlusion_binary_cuda(o, d, tm, skip, 0.01, ds)
    assert (bt.closest_launches, bt.occlusion_launches) == (2, 1)
    ptrs = [c.data_ptr() for c in fake_lib.counters]
    assert len(set(ptrs)) == 3
    (k0, a0), (k1, a1), (k2, a2) = fake_lib.calls
    assert (k0, k1, k2) == ("closest", "closest", "occlusion")
    assert a0[3] == RAYS and a0[4] == pytest.approx(0.01)
    assert a1[4] == pytest.approx(1e-3)
    assert (a0[10], a1[10]) == (bt.stack_need(ds), bt.STACK_CAP)
    assert [a0[11].value, a1[11].value] == ptrs[:2]
    assert a2[4] == RAYS and a2[5] == pytest.approx(0.01)
    assert a2[12].value == ptrs[2]


def test_a_failed_launch_raises_and_is_not_counted(fake_lib):
    ds = _bake("cornell", 8)
    o, d, tm, skip = _rays(ds, 1e-3)
    fake_lib.rc = 1
    bt.reset_launch_counts()
    with pytest.raises(RuntimeError, match="binary_closest"):
        bt._intersect_binary_cuda(o, d, tm, 1e-3, ds)
    with pytest.raises(RuntimeError, match="binary_occlusion"):
        bt._occlusion_binary_cuda(o, d, tm, skip, 1e-3, ds)
    assert (bt.closest_launches, bt.occlusion_launches) == (0, 0)


def test_wrappers_refuse_more_rays_than_the_counter_takes(fake_lib,
                                                          monkeypatch):
    """A launch of more than MAX_RAYS rays raises before the library is
    called (MAX_RAYS lowered to 100 here)."""
    ds = _bake("cornell", 8)
    o, d, tm, skip = _rays(ds, 1e-3)
    monkeypatch.setattr(qt, "MAX_RAYS", 100)
    with pytest.raises(ValueError, match="rays"):
        bt._intersect_binary_cuda(o, d, tm, 1e-3, ds)
    with pytest.raises(ValueError, match="rays"):
        bt._occlusion_binary_cuda(o, d, tm, skip, 1e-3, ds)
    assert fake_lib.calls == []


def _read(name):
    with open(os.path.join(_build.CSRC_DIR, name)) as f:
        return f.read()


def test_variant_lab_edits_only_the_quad_source():
    """kGroup and kRefillAt are set once each in csrc/quad_traverse.cu, the
    lab's source, and not in the shared walk, which takes them as template
    parameters; both render-path sources include the walk, whose hash is
    in every library's name (CUDA_HEADERS)."""
    assert qvl.SOURCE == os.path.join(_build.CSRC_DIR, "quad_traverse.cu")
    quad, walk = _read("quad_traverse.cu"), _read("persistent_walk.cuh")
    assert qvl.source_values(quad) == {"group": 4, "refill_at": 16}
    for name in qvl.CONSTANTS.values():
        assert not qvl._pattern(name).search(walk)
        assert f"template <int {name}" in walk or f"int {name}," in walk
    for src in ("quad_traverse.cu", "binary_traverse.cu"):
        assert '#include "persistent_walk.cuh"' in _read(src)
    assert os.path.join(_build.CSRC_DIR, "persistent_walk.cuh") in \
        _build.CUDA_HEADERS


def test_variant_lab_builds_against_the_shared_walk(monkeypatch, tmp_path):
    """A variant's copy of quad_traverse.cu is compiled with the source
    directory on the include path and the shared headers in its hash."""
    seen = {}

    def compile_library(argv, src, stem, headers=()):
        seen.update(argv=argv, src=src, headers=headers)
        _build.build_info[stem] = {"seconds": 0.0, "log": ""}
        return str(tmp_path / f"{stem}.so")

    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build, "compile_library", compile_library)
    monkeypatch.setattr(ctypes, "CDLL", lambda path: _FakeLib())
    monkeypatch.setattr(_build, "bind", lambda lib, sigs: lib)
    text = _read("quad_traverse.cu")
    qvl.build_variant(text, 8, 24)
    assert seen["headers"] == _build.CUDA_HEADERS
    i = seen["argv"].index("-I")
    assert seen["argv"][i + 1] == _build.CSRC_DIR
    with open(seen["src"]) as f:
        built = f.read()
    assert qvl.source_values(built) == {"group": 8, "refill_at": 24}
