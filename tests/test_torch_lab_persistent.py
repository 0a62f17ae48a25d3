"""What the persistent lab kernels L1-L9 (csrc/lab_traverse.cu
lab_closest, lab_closest4, lab_occlusion, csrc/lab2_traverse.cu
lab_closest_cm, lab_closest_queued, lab_closest_pair, lab_closest4_queued,
lab_closest8_queued, lab_occlusion4_queued) rely on in the trees and in
their wrappers, on the CPU at small sizes:

  - each onodes row carries its 8 child metas at columns 48:56 as exact
    f32 integers equal to ometa, so L7 reads one row per node; an absent
    child's box is NaN and never hit;
  - the plain walks with each leaf row tested up to its count
    (ops/quad_traverse.row_counts) equal the every-slot walks, results and
    step counts both: L2's stack walk in both orders, L1's binary walks
    (base, multi-pop; leafilp's ILP leaf against the stopped serial leaf)
    and L9's in both orders ((nvisit, nleaf)), L3's component-major leaf
    stopped at the float4 group of the count (v2_kernel_lab.cm_groups),
    L4's binary queued walk (each variant at drain_at 1 and 4), L5's pair
    walk (both variants at drain_at 1 and 4, on an odd number of rays,
    with pairs of which one ray or both are inactive), L6's queued walk
    with the serial and the division-free leaf, L7, and L8 in both orders
    ((nit, nleaf)); the kernels stop their leaves there (L1's and L6's ILP
    leaves take the whole row);
  - L6 with and without descent takes the same steps to the same results;
  - the plain walks' stack never holds more than the need the wrappers
    size shared memory by (q_stack_need, OctTree.stack_need,
    binary_traverse.stack_need for L3, L4, L5 (each of a pair's two
    stacks) and L9, kernel_lab.stack_need for the multi-pop walks), and
    the leaf queue never more than LQ;
  - with a fake library, the wrappers pass the node rows (not ometa or
    qmeta), ptris's leaf counts, the tree's stack need, a ray (L5: pair)
    counter of each launch's own and (L1) the variant and the block (L4:
    drain_at and the variant; L5: drain_at and whether the pair shares its
    step kind; L3 the component-major rows with ptris's counts); they
    refuse a stack need outside 1..CAP (1..STACK_CAP for L1, L3 and L9)
    and more rays than the counter takes, raise on a failed launch, which
    is not counted, and launch nothing for zero rays; the launch-shape
    query asks each kernel's library entry and finds its ptxas spills.

The scenes are the Cornell box and a ~4k-triangle atrium, baked at leaf 8
(the labs' leaf size) with the numpy BVH builder. The JAX lab kernels
themselves are held against the port in tests/test_torch_lab.py (L1, L2,
L9), tests/test_torch_lab_queue.py (L3, L4, L6) and
tests/test_torch_lab_oct.py (L7, L8)."""

import contextlib
import ctypes
import dataclasses

import numpy as np
import pytest
import torch

import raytracer_tpu_torch.accel.native_builder as tnative
import raytracer_tpu_torch.scene.benchmark as tbench
import raytracer_tpu_torch.scene.model as tmodel
from raytracer_tpu_torch.lab import bvh4_lab as l2
from raytracer_tpu_torch.lab import kernel_lab as l1
from raytracer_tpu_torch.lab import occl_lab as l9
from raytracer_tpu_torch.lab import queue_walk as qw
from raytracer_tpu_torch.lab import r3_kernel_lab as l6
from raytracer_tpu_torch.lab import r3_occl3_lab as l8
from raytracer_tpu_torch.lab import r3_oct_lab as l7
from raytracer_tpu_torch.lab import v2_kernel_lab as l3
from raytracer_tpu_torch.lab import v3_kernel_lab as l4
from raytracer_tpu_torch.lab import v4_interleave_lab as l5
from raytracer_tpu_torch.ops import _build
from raytracer_tpu_torch.ops import binary_traverse as bt
from raytracer_tpu_torch.ops import quad_traverse as qt
from raytracer_tpu_torch.scene.device_scene import bake_scene

torch.set_num_threads(1)  # see test_torch_ops.py

SCENES = {"cornell": tmodel.create_cornell_box,
          "atrium4k": lambda: tbench.create_benchmark_atrium(4_000)}
# L7, L8 in both orders, L2 in both orders, L6 with the serial and the
# division-free leaf, L1's variants (base serves nored) and L9 in both
# orders.
L1_KINDS = tuple(f"l1_{v}" for v in ("base", "leafilp", "pop2", "pop4"))
L9_KINDS = ("l9_ordered", "l9_noorder")
# L4's (variant, drain_at) by kind: each variant at drain_at 1 and 4.
L4_KINDS = {f"l4_{v}_d{drain}": (v, drain) for v in l4.VARIANTS
            for drain in (1, 4)}
# L5's (variant, drain_at) by kind, likewise.
L5_KINDS = {f"l5_{v}_d{drain}": (v, drain) for v in l5.VARIANTS
            for drain in (1, 4)}
KINDS = ("closest8", "ordered", "fixed", "closest4_ordered",
         "closest4_noorder", "queued4_serial", "queued4_divfree", *L1_KINDS,
         *L9_KINDS, "l3", *L4_KINDS, *L5_KINDS)
CLOSEST = ("closest8", "closest4_ordered", "closest4_noorder",
           "queued4_serial", "queued4_divfree", *L1_KINDS, "l3",
           *(k for k, (v, _) in L4_KINDS.items() if v != "nocond"),
           *L5_KINDS)
# nocond drops every leaf child: no leaf steps, no hits.
NOCOND = tuple(k for k, (v, _) in L4_KINDS.items() if v == "nocond")
RAYS = 2048
_bakes = {}


@pytest.fixture(autouse=True)
def numpy_builder(monkeypatch):
    monkeypatch.setattr(tnative, "available", lambda: False)


def _bake(name):
    """(DeviceScene on the CPU at leaf 8, its OctTree), once per module."""
    if name not in _bakes:
        ds, bvh = bake_scene(SCENES[name](), leaf_size=l7.LEAF_SIZE,
                             device="cpu")
        _bakes[name] = (ds, l7.oct_tree(bvh, "cpu"))
    return _bakes[name]


def _rays(ds, seed=3, n=RAYS):
    """n rays from inside the scene's bounds in random directions (a
    sixteenth along an axis), a quarter inactive (t_max = 1e-3), and a skip
    object each."""
    rng = np.random.default_rng(seed)
    v0 = ds.ptris.view(ds.ptris.shape[0], -1, qt.TRI_STRIDE)[:, :, 0:3]
    v0 = v0.reshape(-1, 3).numpy()
    lo, hi = v0.min(0), v0.max(0)
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:n // 16, 1:] = 0.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_max = rng.uniform(0.1, 2.0, n).astype(np.float32)
    t_max *= np.float32(np.linalg.norm(hi - lo))
    t_max[rng.uniform(size=n) < 0.25] = np.float32(qt.T_MIN)
    skip = rng.integers(-1, 6, n).astype(np.int32)
    return (torch.from_numpy(o), torch.from_numpy(d),
            torch.from_numpy(t_max), torch.from_numpy(skip))


def _counted_closest(origin, direction, rows, bt, btri, bu, bv, t_min):
    """The closest-hit leaf test up to each row's count only, as the
    kernels run it."""
    count = qt.row_counts(rows)
    ox, oy, oz = origin.unbind(1)
    dx, dy, dz = direction.unbind(1)
    for k in range(rows.shape[1] // qt.TRI_STRIDE):
        tri = rows[:, k * qt.TRI_STRIDE:(k + 1) * qt.TRI_STRIDE]
        t, u, v, valid = qt._moller(ox, oy, oz, dx, dy, dz, tri, bt, t_min)
        valid &= k < count
        bt = torch.where(valid, t, bt)
        btri = torch.where(valid, tri[:, 9].to(torch.int32), btri)
        bu = torch.where(valid, u, bu)
        bv = torch.where(valid, v, bv)
    return bt, btri, bu, bv


def _counted_divfree(origin, direction, rows, bt_, btri, bu, bv, t_min):
    """L6's division-free leaf test (r3_kernel_lab._divfree_leaf) up to
    each row's count only, as the kernel runs it."""
    count = qt.row_counts(rows)
    ox, oy, oz = origin.unbind(1)
    dx, dy, dz = direction.unbind(1)
    num, den = bt_, torch.ones_like(bt_)
    for k in range(rows.shape[1] // qt.TRI_STRIDE):
        tri = rows[:, k * qt.TRI_STRIDE:(k + 1) * qt.TRI_STRIDE]
        v0x, v0y, v0z = tri[:, 0], tri[:, 1], tri[:, 2]
        e1x, e1y, e1z = tri[:, 3], tri[:, 4], tri[:, 5]
        e2x, e2y, e2z = tri[:, 6], tri[:, 7], tri[:, 8]
        px = dy * e2z - dz * e2y
        py = dz * e2x - dx * e2z
        pz = dx * e2y - dy * e2x
        det = e1x * px + e1y * py + e1z * pz
        s = torch.where(det >= 0.0, 1.0, -1.0)
        a = det * s
        tx, ty, tz = ox - v0x, oy - v0y, oz - v0z
        up = (tx * px + ty * py + tz * pz) * s
        qx = ty * e1z - tz * e1y
        qy = tz * e1x - tx * e1z
        qz = tx * e1y - ty * e1x
        vp = (dx * qx + dy * qy + dz * qz) * s
        tp = (e2x * qx + e2y * qy + e2z * qz) * s
        valid = ((a > 1e-10) & (up >= 0.0) & (vp >= 0.0) & (up + vp <= a)
                 & (tp > t_min * a) & (tp * den < num * a) & (k < count))
        num = torch.where(valid, tp, num)
        den = torch.where(valid, a, den)
        btri = torch.where(valid, tri[:, 9].to(torch.int32), btri)
        bu = torch.where(valid, up, bu)
        bv = torch.where(valid, vp, bv)
    inv = 1.0 / den
    return num * inv, btri, bu * inv, bv * inv


def _counted_cm(origin, direction, rows, bt, btri, bu, bv, t_min):
    """L3's component-major leaf (v2_kernel_lab._cm_leaf) over the float4
    groups the kernel tests (v2_kernel_lab.cm_groups) only: a slot past
    them takes part neither in the least t nor in the index at it."""
    ox, oy, oz = origin.unbind(1)
    dx, dy, dz = direction.unbind(1)
    leaf = rows.shape[1] // qt.TRI_STRIDE
    tested = torch.arange(leaf) < 4 * l3.cm_groups(rows, bt)[:, None]
    tris = rows.view(-1, qt.TRI_STRIDE, leaf).transpose(1, 2)
    tcs, trik = [], []
    for k in range(leaf):
        tri = tris[:, k]
        t, _, _, valid = qt._moller(ox, oy, oz, dx, dy, dz, tri, bt, t_min)
        tc = torch.where(valid, t, qt.BIG)
        tcs.append(torch.where(tested[:, k], tc, float("inf")))
        trik.append(torch.where(tested[:, k], tri[:, 9].to(torch.int32), -1))
    tc, trik = torch.stack(tcs, 1), torch.stack(trik, 1)
    tmin = tc.amin(1)
    trimax = torch.where(tc == tmin[:, None], trik, -1).amax(1)
    win = tmin < bt
    return torch.where(win, tmin, bt), torch.where(win, trimax, btri), bu, bv


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


def _binary_lab_walk(kind, ds, rays, counted, counts):
    """L1's or L9's plain walk (kernel_lab.closest_lab_plain,
    occl_lab.occl_lab_plain), its counts copied into `counts`; counted:
    the stopped serial or any-hit leaf in place of the variant's."""
    o, d, tm, skip = rays
    scene = (ds.binary_root, ds.pnodes, ds.ptris)
    if kind.startswith("l1_"):
        out = l1.closest_lab_plain(o, d, tm, *scene, kind[3:],
                                   _counted_closest if counted else None)
        hits = out[:4]
    else:
        out = l9.occl_lab_plain(o, d, tm, skip, *scene, kind == "l9_ordered",
                                _counted_any if counted else qt._any_leaf)
        hits = out[:1]
    if counts is not None:
        for c, got in zip(counts, out[len(hits):], strict=True):
            c.copy_(got)
    return hits


def _walk(kind, ds, tree, rays, counted=False, counts=None, descent=False):
    """The plain walk of `kind` (KINDS) on `rays`, every slot of each leaf
    row tested or (`counted`) up to its count; L6 with `descent` or not."""
    o, d, tm, skip = rays
    if kind in L1_KINDS or kind in L9_KINDS:
        return _binary_lab_walk(kind, ds, rays, counted, counts)
    if kind == "l3":
        return l3.closest_v2_plain(
            o, d, tm, ds.binary_root, ds.pnodes,
            l3.to_component_major(ds.ptris), counts=counts,
            leaf_test=_counted_cm if counted else l3._cm_leaf)
    if kind in L4_KINDS:
        variant, drain_at = L4_KINDS[kind]
        out = l4.closest_v3_plain(
            o, d, tm, ds.binary_root, ds.pnodes, ds.ptris, drain_at, variant,
            leaf_test=_counted_closest if counted else qt._serial_leaf)
        if counts is not None:
            for c, got in zip(counts, out[4:], strict=True):
                c.copy_(got)
        return out[:4]
    if kind in L5_KINDS:
        variant, drain_at = L5_KINDS[kind]
        return l5.closest_v4_plain(
            o, d, tm, ds.binary_root, ds.pnodes, ds.ptris, variant,
            counts=counts, drain_at=drain_at,
            leaf_test=_counted_closest if counted else qt._serial_leaf)
    if kind == "closest8":
        step = qw.oct_step(o, qt._inv_dir(d), tree.meta, tree.nodes)
        leaf = _counted_closest if counted else qt._serial_leaf
        return qw.queued_walk(o, d, tm, tree.root, ds.ptris, step,
                              leaf_test=leaf, counts=counts)
    if kind.startswith("closest4_"):
        leaf = _counted_closest if counted else qt._serial_leaf
        return l2.closest4_plain(o, d, tm, ds.root, ds.qmeta, ds.qnodes,
                                 ds.ptris, kind == "closest4_ordered",
                                 counts=counts, leaf_test=leaf)
    if kind.startswith("queued4_"):
        divfree = kind == "queued4_divfree"
        leaf = ((_counted_divfree if divfree else _counted_closest)
                if counted else None)
        return l6.closest_variant_plain(o, d, tm, ds.root, ds.qmeta,
                                        ds.qnodes, ds.ptris, descent,
                                        divfree, counts=counts,
                                        leaf_test=leaf)
    step = qw.quad_step(o, qt._inv_dir(d), ds.qmeta, ds.qnodes,
                        kind == "ordered")
    leaf = _counted_any if counted else qt._any_leaf
    return (qw.queued_any_walk(o, d, tm, skip, ds.root, ds.ptris, step,
                               counts=counts, leaf_test=leaf),)


def _new_counts(n=RAYS):
    return tuple(torch.zeros(n, dtype=torch.int32) for _ in range(2))


# --------------------------------------------------------------------------
# The oct rows.
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(SCENES))
def test_oct_rows_hold_exact_child_metas(name):
    """onodes[:, 48:56] equals ometa wherever a child is present, as exact
    integers below 2**24 in magnitude (internal rows >= 0, leaf blocks ~m <
    0); an absent child has a NaN box, a NaN meta column and ometa 0, and
    columns 56:64 are 0. Every leaf block is some row's child once."""
    ds, tree = _bake(name)
    onodes, ometa = tree.nodes, tree.meta.view(-1, 8)
    metas = onodes[:, 48:56]
    absent = torch.isnan(metas)
    boxes = onodes[:, :48].view(-1, 8, 6)
    assert torch.equal(absent, torch.isnan(boxes).all(dim=2))
    assert not torch.isnan(boxes[~absent]).any()
    assert (onodes[:, 56:] == 0).all()
    assert (ometa[absent] == 0).all()
    present = metas[~absent]
    assert (present.abs() < 2 ** 24).all()
    assert torch.equal(present, present.trunc())
    assert torch.equal(present.to(torch.int32), ometa[~absent])
    inner = ometa[~absent & (ometa >= 0)]
    leaves = ~ometa[~absent & (ometa < 0)]
    assert (inner > 0).all() and (inner < onodes.shape[0]).all()
    assert sorted(leaves.tolist()) == list(range(ds.ptris.shape[0]))
    assert tree.root == 0 and onodes.shape[0] > 1


@pytest.mark.parametrize("name", sorted(SCENES))
def test_absent_children_are_never_hit(name):
    """The slab test of every NaN box of the oct rows misses every ray,
    whatever its t cap."""
    ds, tree = _bake(name)
    o, d, tm, _ = _rays(ds)
    rows = tree.nodes[torch.isnan(tree.nodes[:, 48:56]).any(dim=1)]
    assert rows.shape[0] > 0
    pick = torch.arange(RAYS) % rows.shape[0]
    hit, _ = qt._slab_children(o, qt._inv_dir(d), rows[pick, :48],
                               torch.full_like(tm, 1e30), qt.T_MIN)
    absent = torch.isnan(rows[pick, 48:56])
    assert absent.any()
    assert not hit[absent].any()
    assert hit[~absent].any()


# --------------------------------------------------------------------------
# The plain queued walks stopped at the leaf counts.
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name", sorted(SCENES))
def test_queued_walks_stop_at_leaf_counts(name, kind):
    """Each leaf row tested up to its count: the same results and the same
    step counts ((nit, nleaf); L1's, L2's and L9's (nvisit, nleaf)) of
    every ray as every slot tested (leafilp: as its ILP leaf). L5 walks an
    odd number of rays, so its last pair is one ray, and some of its pairs
    have one ray inactive, some both."""
    ds, tree = _bake(name)
    n = RAYS - 1 if kind in L5_KINDS else RAYS
    rays = _rays(ds, n=n)
    c_all, c_counted = _new_counts(n), _new_counts(n)
    want = _walk(kind, ds, tree, rays, counts=c_all)
    got = _walk(kind, ds, tree, rays, counted=True, counts=c_counted)
    for g, w in zip(got, want, strict=True):
        assert torch.equal(g, w)
    for g, w in zip(c_counted, c_all):
        assert torch.equal(g, w)
    live = rays[2] > qt.T_MIN
    assert (c_all[0][~live] == 0).all() and (c_all[0][live] > 0).all()
    if kind in L5_KINDS:
        pairs = live[:-1].view(-1, 2).sum(1)
        assert (pairs == 1).any() and (pairs == 0).any() and live[-1]
    if kind in NOCOND:
        assert int(c_all[1].sum()) == 0 and (want[1] < 0).all()
        return
    assert int(c_all[1].sum()) > 0
    if kind in CLOSEST:
        assert int((want[1] >= 0).sum()) > RAYS // 4
    else:
        assert 0 < int(want[0].sum()) < int(live.sum())
    if kind == "l3":  # some leaf rows end in the first float4 group
        assert int((qt.row_counts(ds.ptris) <= 4).sum()) > 0


def _twin_cornell():
    """The Cornell box with each object twice (the same mesh, material and
    transform): every triangle has an exact copy, so every hit is a tie."""
    scene = tmodel.create_cornell_box()
    for obj in list(scene.objects):
        scene.add_object(f"{obj.name} twin", obj.mesh_index,
                         obj.material_index, transform=obj.transform)
    return scene


def test_cm_leaf_stopped_at_the_count_keeps_the_tie_rule():
    """On a scene where every hit is a tie, L3's plain walk with each leaf
    stopped at the float4 group of its count equals the every-slot walk
    (t, tri and its pops), its t equals K3's walk's (L1 base) on every ray,
    and where the triangles differ L3's is the larger index of the tie (K3
    keeps the first in slot order)."""
    ds, _ = bake_scene(_twin_cornell(), leaf_size=l7.LEAF_SIZE, device="cpu")
    o, d, tm, skip = _rays(ds)
    c_all, c_counted = _new_counts(), _new_counts()
    rays = (o, d, tm, skip)
    want = _walk("l3", ds, None, rays, counts=c_all)
    got = _walk("l3", ds, None, rays, counted=True, counts=c_counted)
    for g, w in zip((*got, *c_counted), (*want, *c_all), strict=True):
        assert torch.equal(g, w)
    k3 = l1.run_closest_lab(o, d, tm, ds, "base")
    assert torch.equal(want[0], k3[0])
    differ = want[1] != k3[1]
    assert int(differ.sum()) > RAYS // 8
    assert (want[1][differ] > k3[1][differ]).all()
    assert int((qt.row_counts(ds.ptris) <= 4).sum()) > 0


@pytest.mark.parametrize("kind", ("queued4_serial", "queued4_divfree"))
@pytest.mark.parametrize("name", sorted(SCENES))
def test_descent_takes_the_same_steps(name, kind):
    """L6 with descent (the stack's top in `cur`) and without it: the same
    results and the same (nit, nleaf) of every ray, so the kernels' times
    differ only by what the register top entry saves."""
    ds, tree = _bake(name)
    rays = _rays(ds)
    counts = [_new_counts() for _ in range(2)]
    got = [_walk(kind, ds, tree, rays, counts=c, descent=descent)
           for c, descent in zip(counts, (False, True))]
    for g, w in zip(got[1], got[0], strict=True):
        assert torch.equal(g, w)
    for g, w in zip(counts[1], counts[0], strict=True):
        assert torch.equal(g, w)
    assert int(counts[0][1].sum()) > 0


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name", sorted(SCENES))
def test_stack_and_queue_fit_the_shared_memory(name, kind, monkeypatch):
    """After every push of the plain walks, the stack holds at most the
    need the wrapper sizes shared memory by (OctTree.stack_need for L7,
    q_stack_need for L2, L6 and L8, and binary_traverse.stack_need for L4,
    at most CAP; kernel_lab.stack_need for L1 and binary_traverse
    .stack_need for L3 and L9, at most STACK_CAP), and the leaf queue at
    most LQ (L1, L2, L3 and L9 have none: their leaves go on the stack; L4
    nocond drops its leaves); L5's stacks and queues, one of each a ray,
    likewise. L4, L5 and L6 are walked without descent, whose stack holds
    the most: every internal child."""
    ds, tree = _bake(name)
    cap = qw.CAP
    if kind == "closest8":
        need = tree.stack_need
    elif kind in L1_KINDS:
        need, cap = l1.stack_need(ds, kind[3:]), bt.STACK_CAP
    elif kind in L9_KINDS or kind == "l3":
        need, cap = bt.stack_need(ds), bt.STACK_CAP
    elif kind in L4_KINDS or kind in L5_KINDS:
        need = bt.stack_need(ds)
    else:
        need = ds.q_stack_need
    deepest = {qw.CAP: 0, qw.LQ: 0, bt.STACK_CAP: 0}
    push = qt._push

    def watched(stack, sp, rays, meta, mask):
        push(stack, sp, rays, meta, mask)
        if rays.numel():
            width = stack.shape[1]
            deepest[width] = max(deepest[width], int(sp[rays].max()))

    assert qt.CAP == qw.CAP
    monkeypatch.setattr(qw, "_push", watched)
    monkeypatch.setattr(qt, "_push", watched)
    monkeypatch.setattr(bt, "_push", watched)
    _walk(kind, ds, tree, _rays(ds))
    assert 2 <= deepest[cap] <= need <= cap
    if kind.startswith(("closest4_", "l1_", "l9_", "l3")) or kind in NOCOND:
        assert deepest[qw.LQ] == 0
    else:
        assert 1 <= deepest[qw.LQ] <= qw.LQ
    print(f"{name} {kind}: need {need}, deepest stack {deepest[cap]}, "
          f"deepest queue {deepest[qw.LQ]}")


@pytest.mark.parametrize("lab", ("l7", "l8"))
@pytest.mark.parametrize("name", sorted(SCENES))
def test_lab_runs_count_through_the_leaf_hooks(name, lab, monkeypatch):
    """run(..., leaf_hooks=...) tests the plain walks' leaves through a
    new hook on each set and reports its total under "tests", with the
    same results and steps as the default run: here a hook that counts
    the leaf rows it tests, which is the leaf steps."""
    from raytracer_tpu_torch.lab import rays as lab_rays

    monkeypatch.setattr(lab_rays, "cuda_ms", lambda fn, reps: (fn(), 1.0)[1])
    monkeypatch.setattr(lab_rays, "host_ms", lambda fn: (fn(), 1.0))
    ds, tree = _bake(name)
    o, d, tm, skip = _rays(ds)

    def hooks():
        total = [0]

        def closest(o, d, rows, *rest):
            total[0] += rows.shape[0]
            return qt._serial_leaf(o, d, rows, *rest)

        def any_hit(o, d, rows, *rest):
            total[0] += rows.shape[0]
            return qt._any_leaf(o, d, rows, *rest)

        return closest, any_hit, total

    if lab == "l7":
        sets = {"set": (o, d, tm)}
        runs = [l7.run(ds, tree, sets, reps=1, log=lambda m: None,
                       leaf_hooks=h) for h in (None, hooks)]
        keys = [("set", "oct")]
    else:
        sets = {"shadow_b1_sorted": (o, d, tm, skip, tm > qt.T_MIN)}
        runs = [l8.run(ds, sets, reps=1, log=lambda m: None, leaf_hooks=h)
                for h in (None, hooks)]
        keys = [(s, order) for s in ("shadow_b1_sorted", "shadow_b1_resort")
                for order in l8.ORDERS]
    for key in keys:
        plain, hooked = runs[0][key], runs[1][key]
        assert plain["tests"] is None
        for g, w in zip((*hooked["counts"], *hooked["plain"]),
                        (*plain["counts"], *plain["plain"]), strict=True):
            assert torch.equal(g, w)
        assert hooked["tests"] == int(hooked["counts"][1].sum()) > 0


# --------------------------------------------------------------------------
# The wrappers against a fake library.
# --------------------------------------------------------------------------

class _FakeLib:
    """A stand-in for the built lab and lab2 libraries: records each
    launch's arguments and returns `rc`; the launch-shape queries fill
    their output with 1..9."""

    def __init__(self, rc=0):
        self.rc = rc
        self.calls = []

    def lab_closest(self, *args):
        self.calls.append(("closest", args))
        return self.rc

    def lab_occlusion(self, *args):
        self.calls.append(("binary_occlusion", args))
        return self.rc

    def lab_closest4(self, *args):
        self.calls.append(("closest4", args))
        return self.rc

    def lab_closest4_queued(self, *args):
        self.calls.append(("queued4", args))
        return self.rc

    def lab_closest8_queued(self, *args):
        self.calls.append(("closest8", args))
        return self.rc

    def lab_occlusion4_queued(self, *args):
        self.calls.append(("occlusion", args))
        return self.rc

    def lab_closest_cm(self, *args):
        self.calls.append(("closest_cm", args))
        return self.rc

    def lab_closest_queued(self, *args):
        self.calls.append(("queued2", args))
        return self.rc

    def lab_closest_pair(self, *args):
        self.calls.append(("pair", args))
        return self.rc

    def _info(self, entry, kernel, need, out):
        self.calls.append((entry, (kernel, need)))
        for i in range(len(qt.LAUNCH_INFO_KEYS)):
            out[i] = i + 1
        return self.rc

    def lab_launch_info(self, kernel, need, out):
        return self._info("lab_info", kernel, need, out)

    def lab2_launch_info(self, kernel, need, out):
        return self._info("info", kernel, need, out)


@pytest.fixture
def fake_lib(monkeypatch):
    """L1's-L9's CUDA wrappers on CPU tensors against a _FakeLib, with the
    device context and the stream stubbed; the counters the launches got
    are kept alive in `lib.counters`."""
    lib = _FakeLib()
    lib.counters = []
    walk_args = qt._walk_args

    def spy(*a, **kw):
        args, counter = walk_args(*a, **kw)
        lib.counters.append(counter)
        return args, counter

    monkeypatch.setattr(_build, "lab_traverse_lib", lambda: lib)
    monkeypatch.setattr(_build, "lab2_traverse_lib", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(qt, "_stream", lambda dev: ctypes.c_void_p(0))
    monkeypatch.setattr(qt, "_walk_args", spy)
    monkeypatch.setattr(bt, "_walk_args", spy)
    for mod in (l2, l6, l7, l8, l1, l9, l3, l4, l5):
        mod.reset_launch_counts()
    return lib


# L6's (descent, leaf kind) of the wrapper tests: each leaf kind once.
L6_RUNS = ((False, 0), (True, 1), (False, 2))
# L1's (variant, block) of the wrapper tests: each variant of L1a (block
# None), then L1b at each block.
L1_RUNS = (("base", None), ("leafilp", None), ("pop2", None),
           ("pop4", None), *(("nored", b) for b in l1.BLOCKS))
# L4's (variant, drain_at) of the wrapper tests: each variant once.
L4_RUNS = (("base", 4), ("nocond", 1), ("dblread", 14))
# L5's (variant, drain_at) of the wrapper tests: each variant once.
L5_RUNS = (("shared", 4), ("switch", 1))


def _launch_all(ds, tree, rays):
    """L7 once, L8 in both orders, L2 in both orders, L6 as L6_RUNS say,
    L1 as L1_RUNS say, L9 in both orders, L3 once, L4 as L4_RUNS say and
    L5 as L5_RUNS say on the fake library. Returns L3's component-major
    rows."""
    o, d, tm, skip = rays
    l7._closest8_cuda(o, d, tm, tree, ds.ptris)
    for ordered in (True, False):
        l8._occl_ordered_cuda(o, d, tm, skip, ds, ordered)
    for ordered in (True, False):
        l2._closest4_cuda(o, d, tm, ds, ordered)
    for descent, kind in L6_RUNS:
        l6._closest_variant_cuda(o, d, tm, ds, descent, kind)
    for variant, block in L1_RUNS:
        l1._closest_lab_cuda(o, d, tm, ds, variant, block)
    for ordered in (True, False):
        l9._occl_lab_cuda(o, d, tm, skip, ds, ordered)
    ptris_cm = l3.to_component_major(ds.ptris)
    l3._closest_v2_cuda(o, d, tm, ds, ptris_cm)
    for variant, drain_at in L4_RUNS:
        l4._closest_v3_cuda(o, d, tm, ds, drain_at,
                            l4._KERNEL_VARIANT[variant])
    for variant, drain_at in L5_RUNS:
        l5._closest_v4_cuda(o, d, tm, ds, drain_at, variant == "shared")
    return ptris_cm


def _launch_counts():
    return (l7.closest_launches, l8.occlusion_launches,
            l2.closest4_launches, l6.closest_launches, l1.closest_launches,
            l1.closest_ts_launches, l9.occlusion_launches,
            l3.closest_launches, l4.closest_launches, l5.closest_launches)


# The launches of _launch_all, in order: L7, L8 x 2, L2 x 2, then L6, L1,
# L9, L3, L4 and L5.
N_QUAD = 5 + len(L6_RUNS)
N_L9 = N_QUAD + len(L1_RUNS) + 2  # the end of L9's launches
N_L4 = N_L9 + 1 + len(L4_RUNS)  # the end of L4's launches
N_LAUNCHES = N_L4 + len(L5_RUNS)
ZERO_COUNTS = (0,) * 10


def test_each_launch_passes_the_rows_counts_need_and_its_own_counter(
        fake_lib):
    """L7 passes root, the onodes rows, ptris, ptris's leaf counts, the
    leaf size, OctTree.stack_need, its counter and drain_at; L8 the same
    with the qnodes rows and q_stack_need, then its order; L2 the qnodes
    rows and q_stack_need, then its order; L6 as L8, then descent and its
    leaf kind; L1 the binary root, the pnodes rows and its variant's
    stack need, then the variant's code and the block; L9 the same with
    bt.stack_need, then its order; L3 the component-major rows with
    ptris's counts and bt.stack_need; L4 as L9, then drain_at and the
    variant's code; L5 as L4, its counter counting pairs, then drain_at
    and 1 for shared, 0 for switch. None passes ometa or qmeta; each
    launch has its own counter and adds one to its kernel's count (L1b's
    to closest_ts_launches)."""
    ds, tree = _bake("atrium4k")
    ptris_cm = _launch_all(ds, tree, _rays(ds))
    assert _launch_counts() == (1, 2, 2, len(L6_RUNS), 4, len(l1.BLOCKS), 2,
                                1, len(L4_RUNS), len(L5_RUNS))
    ptrs = [c.data_ptr() for c in fake_lib.counters]
    assert len(set(ptrs)) == N_LAUNCHES
    counts = qt.ptris_leaf_counts(ds.ptris).data_ptr()
    (k7, a7), (ko, ao), (kf, af), (k2o, a2o), (k2f, a2f) = fake_lib.calls[:5]
    assert (k7, ko, kf, k2o, k2f) == ("closest8", "occlusion", "occlusion",
                                      "closest4", "closest4")
    assert a7[3] == RAYS and a7[4] == tree.root
    assert [a.value for a in (a7[5], a7[6], a7[7])] == [
        tree.nodes.data_ptr(), ds.ptris.data_ptr(), counts]
    assert a7[8:10] == (l7.LEAF_SIZE, tree.stack_need)
    assert (a7[10].value, a7[11]) == (ptrs[0], qw.DRAIN_AT)
    assert len(a7) == 17 and a7[-1].value is None  # the stream last
    for a, ordered, ptr in ((ao, 1, ptrs[1]), (af, 0, ptrs[2])):
        assert a[4] == RAYS and a[5] == ds.root
        assert [x.value for x in (a[6], a[7], a[8])] == [
            ds.qnodes.data_ptr(), ds.ptris.data_ptr(), counts]
        assert a[9:11] == (l8.LEAF_SIZE, ds.q_stack_need)
        assert (a[11].value, a[12], a[13]) == (ptr, qw.DRAIN_AT, ordered)
        assert len(a) == 16 and a[-1].value is None
    quad = [(a2o, ptrs[3], (1,)), (a2f, ptrs[4], (0,))]
    for (kind, a), (descent, leaf_kind), ptr in zip(
            fake_lib.calls[5:N_QUAD], L6_RUNS, ptrs[5:N_QUAD], strict=True):
        assert kind == "queued4"
        quad.append((a, ptr, (qw.DRAIN_AT, int(descent), leaf_kind)))
    for a, ptr, tail in quad:
        assert a[3] == RAYS and a[4] == ds.root
        assert [x.value for x in (a[5], a[6], a[7])] == [
            ds.qnodes.data_ptr(), ds.ptris.data_ptr(), counts]
        assert a[8:10] == (l2.LEAF_SIZE, ds.q_stack_need)
        assert a[10].value == ptr
        assert a[11:11 + len(tail)] == tail
        assert len(a) == 11 + len(tail) + 5 and a[-1].value is None
    binary = (ds.binary_root, ds.pnodes.data_ptr(), ds.ptris.data_ptr(),
              counts, l7.LEAF_SIZE)
    l1_calls = fake_lib.calls[N_QUAD:N_QUAD + len(L1_RUNS)]
    for (kind, a), (variant, block), ptr in zip(
            l1_calls, L1_RUNS, ptrs[N_QUAD:N_QUAD + len(L1_RUNS)],
            strict=True):
        assert kind == "closest" and a[3] == RAYS
        assert (a[4], *(x.value for x in a[5:8]), a[8]) == binary
        assert a[9] == l1.stack_need(ds, variant)
        assert a[10].value == ptr
        assert a[11:13] == (l1._KERNEL_VARIANT[variant], block or 128)
        assert len(a) == 13 + 6 + 1 and a[-1].value is None
    l9_calls = fake_lib.calls[N_QUAD + len(L1_RUNS):N_L9]
    for (kind, a), ordered, ptr in zip(l9_calls, (1, 0), ptrs[N_L9 - 2:N_L9],
                                       strict=True):
        assert kind == "binary_occlusion" and a[4] == RAYS
        assert (a[5], *(x.value for x in a[6:9]), a[9]) == binary
        assert (a[10], a[11].value, a[12]) == (bt.stack_need(ds), ptr,
                                                 ordered)
        assert len(a) == 13 + 3 + 1 and a[-1].value is None
    (kind, a) = fake_lib.calls[N_L9]
    assert kind == "closest_cm" and a[3] == RAYS
    cm_binary = (*binary[:2], ptris_cm.data_ptr(), *binary[3:])
    assert (a[4], *(x.value for x in a[5:8]), a[8]) == cm_binary
    assert (a[9], a[10].value) == (bt.stack_need(ds), ptrs[N_L9])
    assert len(a) == 11 + 4 + 1 and a[-1].value is None
    for (kind, a), (variant, drain_at), ptr in zip(
            fake_lib.calls[N_L9 + 1:N_L4], L4_RUNS, ptrs[N_L9 + 1:N_L4],
            strict=True):
        assert kind == "queued2" and a[3] == RAYS
        assert (a[4], *(x.value for x in a[5:8]), a[8]) == binary
        assert (a[9], a[10].value) == (bt.stack_need(ds), ptr)
        assert a[11:13] == (drain_at, l4._KERNEL_VARIANT[variant])
        assert len(a) == 13 + 6 + 1 and a[-1].value is None
    for (kind, a), (variant, drain_at), ptr in zip(
            fake_lib.calls[N_L4:], L5_RUNS, ptrs[N_L4:], strict=True):
        assert kind == "pair" and a[3] == RAYS
        assert (a[4], *(x.value for x in a[5:8]), a[8]) == binary
        assert (a[9], a[10].value) == (bt.stack_need(ds), ptr)
        assert a[11:13] == (drain_at, int(variant == "shared"))
        assert len(a) == 13 + 4 + 1 and a[-1].value is None
    assert l1.stack_need(ds, "pop4") == 4 * bt.stack_need(ds)
    sent = {a.value for _, args in fake_lib.calls for a in args
            if isinstance(a, ctypes.c_void_p)}
    assert tree.meta.data_ptr() not in sent
    assert ds.qmeta.data_ptr() not in sent


def test_a_failed_launch_raises_and_is_not_counted(fake_lib):
    ds, tree = _bake("cornell")
    o, d, tm, skip = _rays(ds)
    fake_lib.rc = 2
    with pytest.raises(RuntimeError, match="lab_closest8_queued"):
        l7._closest8_cuda(o, d, tm, tree, ds.ptris)
    for ordered in (True, False):
        with pytest.raises(RuntimeError, match="lab_occlusion4_queued"):
            l8._occl_ordered_cuda(o, d, tm, skip, ds, ordered)
        with pytest.raises(RuntimeError, match="lab_closest4 launch"):
            l2._closest4_cuda(o, d, tm, ds, ordered)
    for descent, kind in L6_RUNS:
        with pytest.raises(RuntimeError, match="lab_closest4_queued"):
            l6._closest_variant_cuda(o, d, tm, ds, descent, kind)
    for variant, block in L1_RUNS:
        with pytest.raises(RuntimeError, match="lab_closest launch"):
            l1._closest_lab_cuda(o, d, tm, ds, variant, block)
    for ordered in (True, False):
        with pytest.raises(RuntimeError, match="lab_occlusion launch"):
            l9._occl_lab_cuda(o, d, tm, skip, ds, ordered)
    with pytest.raises(RuntimeError, match="lab_closest_cm launch"):
        l3._closest_v2_cuda(o, d, tm, ds, l3.to_component_major(ds.ptris))
    for variant, drain_at in L4_RUNS:
        with pytest.raises(RuntimeError, match="lab_closest_queued launch"):
            l4._closest_v3_cuda(o, d, tm, ds, drain_at,
                                l4._KERNEL_VARIANT[variant])
    for variant, drain_at in L5_RUNS:
        with pytest.raises(RuntimeError, match="lab_closest_pair launch"):
            l5._closest_v4_cuda(o, d, tm, ds, drain_at, variant == "shared")
    assert _launch_counts() == ZERO_COUNTS
    assert len(fake_lib.calls) == N_LAUNCHES


@pytest.mark.parametrize("need", [0, qw.CAP + 1, bt.STACK_CAP + 1])
def test_wrappers_refuse_a_stack_need_outside_the_cap(fake_lib, need):
    """A stack need outside 1..CAP raises before the library is called, in
    the CUDA wrappers and in the public entry points (L4's and L5's: the
    binary tree's depth + 2); for L1, L3 and L9 one outside 1..STACK_CAP
    (the tree's depth + 2, times npop for pop2 and pop4)."""
    ds, tree = _bake("cornell")
    o, d, tm, skip = _rays(ds)
    deep_tree = tree._replace(stack_need=need)
    deep_scene = dataclasses.replace(ds, q_stack_need=need)
    with pytest.raises(ValueError, match="stack need"):
        l7._closest8_cuda(o, d, tm, deep_tree, ds.ptris)
    with pytest.raises(ValueError, match="stack need"):
        l7.run_closest8(o, d, tm, deep_tree, ds.ptris)
    for ordered in (True, False):
        with pytest.raises(ValueError, match="stack need"):
            l8._occl_ordered_cuda(o, d, tm, skip, deep_scene, ordered)
        with pytest.raises(ValueError, match="stack need"):
            l8.run_occl_ordered(o, d, tm, skip, deep_scene, ordered)
        with pytest.raises(ValueError, match="stack need"):
            l2._closest4_cuda(o, d, tm, deep_scene, ordered)
        with pytest.raises(ValueError, match="stack need"):
            l2.run_closest4(o, d, tm, deep_scene, ordered)
    for descent, kind in L6_RUNS:
        with pytest.raises(ValueError, match="stack need"):
            l6._closest_variant_cuda(o, d, tm, deep_scene, descent, kind)
        with pytest.raises(ValueError, match="stack need"):
            l6.run_closest_variant(o, d, tm, deep_scene, descent, kind == 1,
                                   kind == 2)
    # The public entry points refuse a need above STACK_CAP (on CPU tensors
    # they run the plain walks, which a need below 1 does not concern).
    deep_binary = dataclasses.replace(ds, bvh_max_depth=need - 2)
    for variant, block in L1_RUNS:
        l1_need = l1.stack_need(deep_binary, variant)
        if 1 <= l1_need <= bt.STACK_CAP:
            continue
        with pytest.raises(ValueError, match="stack need"):
            l1._closest_lab_cuda(o, d, tm, deep_binary, variant, block)
        if l1_need > bt.STACK_CAP:
            with pytest.raises(ValueError, match="stack"):
                if block is None:
                    l1.run_closest_lab(o, d, tm, deep_binary, variant)
                else:
                    l1.run_closest_ts(o, d, tm, deep_binary, block)
    if not 1 <= need <= bt.STACK_CAP:
        for variant in l9.VARIANTS:
            with pytest.raises(ValueError, match="stack need"):
                l9._occl_lab_cuda(o, d, tm, skip, deep_binary,
                                  variant != "noorder")
            if need > bt.STACK_CAP:
                with pytest.raises(ValueError, match="stack"):
                    l9.run_occl_lab(o, d, tm, skip, deep_binary, variant)
    ptris_cm = l3.to_component_major(ds.ptris)
    if not 1 <= need <= bt.STACK_CAP:
        with pytest.raises(ValueError, match="stack need"):
            l3._closest_v2_cuda(o, d, tm, deep_binary, ptris_cm)
        if need > bt.STACK_CAP:
            with pytest.raises(ValueError, match="stack"):
                l3.run_closest_v2(o, d, tm, deep_binary, ptris_cm)
    for variant, drain_at in L4_RUNS:
        with pytest.raises(ValueError, match="stack need"):
            l4._closest_v3_cuda(o, d, tm, deep_binary, drain_at,
                                l4._KERNEL_VARIANT[variant])
        if need > qw.CAP:
            with pytest.raises(ValueError, match="stack"):
                l4.run_closest_v3(o, d, tm, deep_binary, drain_at, variant)
    for variant, drain_at in L5_RUNS:
        with pytest.raises(ValueError, match="stack need"):
            l5._closest_v4_cuda(o, d, tm, deep_binary, drain_at,
                                variant == "shared")
        if need > qw.CAP:
            with pytest.raises(ValueError, match="stack"):
                l5.run_closest_v4(o, d, tm, deep_binary, variant, drain_at)
    assert fake_lib.calls == []


def test_wrappers_refuse_more_rays_than_the_counter_takes(fake_lib,
                                                          monkeypatch):
    """More than MAX_RAYS rays raise before the library is called
    (MAX_RAYS lowered to 100 here; L5's pairs, fewer than its rays, too)."""
    ds, tree = _bake("cornell")
    monkeypatch.setattr(qt, "MAX_RAYS", 100)
    with pytest.raises(ValueError, match="rays"):
        _launch_all(ds, tree, _rays(ds))
    o, d, tm, skip = _rays(ds)
    with pytest.raises(ValueError, match="rays"):
        l8._occl_ordered_cuda(o, d, tm, skip, ds, False)
    for ordered in (True, False):
        with pytest.raises(ValueError, match="rays"):
            l2._closest4_cuda(o, d, tm, ds, ordered)
    for descent, kind in L6_RUNS:
        with pytest.raises(ValueError, match="rays"):
            l6._closest_variant_cuda(o, d, tm, ds, descent, kind)
    for variant, block in L1_RUNS:
        with pytest.raises(ValueError, match="rays"):
            l1._closest_lab_cuda(o, d, tm, ds, variant, block)
    for ordered in (True, False):
        with pytest.raises(ValueError, match="rays"):
            l9._occl_lab_cuda(o, d, tm, skip, ds, ordered)
    with pytest.raises(ValueError, match="rays"):
        l3._closest_v2_cuda(o, d, tm, ds, l3.to_component_major(ds.ptris))
    for variant, drain_at in L4_RUNS:
        with pytest.raises(ValueError, match="rays"):
            l4._closest_v3_cuda(o, d, tm, ds, drain_at,
                                l4._KERNEL_VARIANT[variant])
    for variant, drain_at in L5_RUNS:
        with pytest.raises(ValueError, match="rays"):
            l5._closest_v4_cuda(o, d, tm, ds, drain_at, variant == "shared")
    assert fake_lib.calls == []


def test_no_rays_launch_nothing(fake_lib):
    ds, tree = _bake("cornell")
    o, d, tm, skip = (a[:0] for a in _rays(ds))
    assert l7._closest8_cuda(o, d, tm, tree, ds.ptris)[0].shape == (0,)
    assert l8._occl_ordered_cuda(o, d, tm, skip, ds, True).shape == (0,)
    for ordered in (True, False):
        assert l2._closest4_cuda(o, d, tm, ds, ordered)[0].shape == (0,)
    for descent, kind in L6_RUNS:
        out = l6._closest_variant_cuda(o, d, tm, ds, descent, kind)
        assert [t.shape for t in out] == [(0,)] * 4
    for variant, block in L1_RUNS:
        out = l1._closest_lab_cuda(o, d, tm, ds, variant, block)
        assert [t.shape for t in out] == [(0,)] * 6
    for ordered in (True, False):
        out = l9._occl_lab_cuda(o, d, tm, skip, ds, ordered)
        assert [t.shape for t in out] == [(0,)] * 3
    out = l3._closest_v2_cuda(o, d, tm, ds, l3.to_component_major(ds.ptris))
    assert [t.shape for t in out] == [(0,)] * 2
    for variant, drain_at in L4_RUNS:
        out = l4._closest_v3_cuda(o, d, tm, ds, drain_at,
                                  l4._KERNEL_VARIANT[variant])
        assert [t.shape for t in out] == [(0,)] * 6
    for variant, drain_at in L5_RUNS:
        out = l5._closest_v4_cuda(o, d, tm, ds, drain_at, variant == "shared")
        assert [t.shape for t in out] == [(0,)] * 4
    assert fake_lib.calls == []
    assert _launch_counts() == ZERO_COUNTS


# kernel -> its mangled name in a -Xptxas=-v log.
MANGLED = {
    "closest8": "_ZN12_GLOBAL__N_122closest8_queued_kernelEPKfS1_S1_ii",
    "occlusion_ordered":
        "_ZN12_GLOBAL__N_124occlusion4_queued_kernelILb1EEEvPKfS2_S2_PKi",
    "occlusion_fixed":
        "_ZN12_GLOBAL__N_124occlusion4_queued_kernelILb0EEEvPKfS2_S2_PKi",
    "closest4_ordered":
        "_ZN12_GLOBAL__N_126closest4_persistent_kernelILb1EEEvPKfS2_S2_ii",
    "closest4_noorder":
        "_ZN12_GLOBAL__N_126closest4_persistent_kernelILb0EEEvPKfS2_S2_ii",
    **{qw.l6_kernel(descent, kind):
       f"_ZN12_GLOBAL__N_133closest4_queued_persistent_kernelILb{descent}"
       f"ELi{kind}EEEvPKfS2_S2_ii"
       for kind in range(3) for descent in (0, 1)},
    **{qw.l1_kernel(variant, leaf, block):
       f"_ZN12_GLOBAL__N_129closest_lab_persistent_kernelILi{ilp}ELi{block}"
       "EEEvPKfS2_S2_ii"
       for variant, leaf, ilp, block in (
           ("base", None, 0, 128), ("leafilp", 8, 8, 128),
           ("leafilp", 16, 16, 128), *(("nored", None, 0, b)
                                       for b in (64, 256, 512, 1024)))},
    **{f"lab_closest_pop{k}":
       f"_ZN12_GLOBAL__N_123closest_multipop_kernelILi{k}EEEvPKfS2_S2_ii"
       for k in (2, 4)},
    **{f"lab_occlusion_{order}":
       f"_ZN12_GLOBAL__N_131occlusion_lab_persistent_kernelILb{b}EEEvPKfS2_"
       "S2_PKi" for order, b in (("ordered", 1), ("noorder", 0))},
    "closest_cm":
        "_ZN12_GLOBAL__N_128closest_cm_persistent_kernelEPKfS1_S1_iiPK6float4",
    **{qw.l4_kernel(variant):
       f"_ZN12_GLOBAL__N_120binary_queued_kernelILi{code}EEEvPKfS2_S2_ii"
       for code, variant in enumerate(l4.VARIANTS)},
    **{qw.l5_kernel(variant):
       f"_ZN12_GLOBAL__N_118pair_queued_kernelILb{shared}EEEvPKfS2_S2_ii"
       for variant, shared in (("shared", 1), ("switch", 0))},
}
# L1's and L9's lab_launch_info indices (after L2's 0 and 1).
L1_L9_INFO = {"lab_closest_base": 2, "lab_closest_leafilp8": 3,
              "lab_closest_leafilp16": 4, "lab_closest_pop2": 5,
              "lab_closest_pop4": 6, "lab_closest_ts64": 7,
              "lab_closest_ts256": 8, "lab_closest_ts512": 9,
              "lab_closest_ts1024": 10, "lab_occlusion_ordered": 11,
              "lab_occlusion_noorder": 12}


def test_launch_info_reads_each_kernels_shape_and_spills(fake_lib,
                                                         monkeypatch):
    """launch_info asks L2's library (lab_launch_info: 0 ordered, 1 child
    order, then L1 and L9 as L1_L9_INFO says) or the lab2 library
    (lab2_launch_info: 0 L7, 1 L8 ordered, 2 L8 child order, 3 + 2 * leaf
    kind + descent L6, 9 L3, 10 + variant code L4, 13 L5 shared, 14 L5
    switch) for the kernel at the need given, and finds that
    kernel's spills in its library's -Xptxas=-v log, each template
    instance apart."""
    assert sorted(MANGLED) == sorted(qw.LAUNCH_KERNELS)
    logs = {"lab_traverse": [], "lab2_traverse": []}
    for k, (kernel, mangled) in enumerate(MANGLED.items()):
        logs[qw.LAUNCH_KERNELS[kernel][0]] += [
            f"ptxas info    : Function properties for {mangled}",
            f"    0 bytes stack frame, {8 * k} bytes spill stores, "
            f"{8 * k + 4} bytes spill loads"]
    for library, log in logs.items():
        monkeypatch.setitem(_build.build_info, f"lib{library}",
                            {"seconds": 0.0, "log": "\n".join(log)})
    want = {"closest4_ordered": ("lab_info", 0),
            "closest4_noorder": ("lab_info", 1), "closest8": ("info", 0),
            "occlusion_ordered": ("info", 1), "occlusion_fixed": ("info", 2),
            **{qw.l6_kernel(descent, kind): ("info", 3 + 2 * kind + descent)
               for kind in range(3) for descent in (0, 1)},
            **{kernel: ("lab_info", index)
               for kernel, index in L1_L9_INFO.items()},
            "closest_cm": ("info", 9),
            **{qw.l4_kernel(v): ("info", 10 + code)
               for code, v in enumerate(l4.VARIANTS)},
            qw.l5_kernel("shared"): ("info", 13),
            qw.l5_kernel("switch"): ("info", 14)}
    for k, kernel in enumerate(MANGLED):
        info = qw.launch_info(kernel, 24, torch.device("cpu"))
        entry, index = want[kernel]
        assert fake_lib.calls[-1] == (entry, (index, 24))
        assert [info[key] for key in qt.LAUNCH_INFO_KEYS] == list(
            range(1, len(qt.LAUNCH_INFO_KEYS) + 1))
        assert info["spills"] == (8 * k, 8 * k + 4)
    assert l6.launch_kernel(True, True) == qw.l6_kernel(1, 1)
    assert l6.launch_kernel(False, False, True) == qw.l6_kernel(0, 2)
    assert [qw.l1_kernel(v, 16) for v in l1.VARIANTS] == [
        "lab_closest_base", "lab_closest_base", "lab_closest_leafilp16",
        "lab_closest_pop2", "lab_closest_pop4"]
    assert [qw.l1_kernel("nored", block=b) for b in l1.BLOCKS] == [
        "lab_closest_ts64", "lab_closest_base", "lab_closest_ts256",
        "lab_closest_ts512", "lab_closest_ts1024"]
    # The labs' launch lines ask each L1 kernel (leafilp at the bake's
    # leaf, L1b at every block but 128) and both L9 kernels at its need.
    ds, _ = _bake("cornell")
    fake_lib.calls.clear()
    cpu = torch.device("cpu")
    lines = l1.launch_lines(ds, 8, cpu) + l9.launch_lines(ds, cpu)
    need = bt.stack_need(ds)
    assert fake_lib.calls == [("lab_info", (index, k * need)) for index, k in (
        (2, 1), (3, 1), (5, 2), (6, 4), (7, 1), (8, 1), (9, 1), (10, 1),
        (11, 1), (12, 1))]
    assert len(lines) == 10
    assert all(" launch: 1 registers" in line and "blocks of 9 a SM" in line
               for line in lines)
    # L5's line counts two rays a thread in flight (4 blocks of 9 threads).
    l5_line = qw.launch_line("L5", qw.l5_kernel("switch"), need, cpu)
    l4_line = qw.launch_line("L4", qw.l4_kernel("base"), need, cpu)
    assert "LQ 16, twice" in l5_line and "72 rays in flight" in l5_line
    assert "LQ 16)" in l4_line and "36 rays in flight" in l4_line
    fake_lib.rc = 1
    with pytest.raises(RuntimeError, match="lab2_launch_info"):
        qw.launch_info("closest8", 24, torch.device("cpu"))
    with pytest.raises(RuntimeError, match="lab_launch_info"):
        qw.launch_info("closest4_ordered", 24, torch.device("cpu"))
