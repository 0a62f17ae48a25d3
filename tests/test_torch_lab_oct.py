"""The port's 8-wide lab L7 (raytracer_tpu_torch/lab/r3_oct_lab.py) and
near-first any-hit lab L8 (lab/r3_occl3_lab.py) against the JAX lab
kernels they port, run in interpret mode: tools/r3_oct_lab.run_closest8(
..., interpret=True), and tools/r3_occl3_lab._occlusion_kernel_ordered in
pl.pallas_call(..., interpret=True) with the lab's own specs (:133-146).
On CPU tensors the port runs the kernels' plain torch versions;
chip_smoke.py phase 8 holds the CUDA kernels to those on the card.

  (a) collapse_bvh8 equals the JAX lab's on the same BVH, NaN boxes in the
      same places, root and stack need included (a leaf-root scene too);
  (b) L7 on a tile of random rays (random t_max, a fifth inactive): tri
      identical, |dt| <= 1e-5 and u/v within 1e-4 on hits (XLA and torch
      round a few terms apart) against the JAX kernel, with at least 100
      hits and one miss; and identical to the port's K1 (the same
      Möller–Trumbore terms on the same triangle: on random triangles, with
      no shared edges, the walk order cannot change the hit);
  (c) L8 in both orders: the occlusion mask identical to the JAX kernel's
      and to the port's K2 on every ray (any-hit does not depend on the
      order), some rays occluded and some not, skip_object deciding some;
  (d) guards and the CPU path: a stack need above CAP, an unknown order
      and a drain threshold the queue cannot hold raise; a leaf root walks;
      CPU tensors never reach the CUDA wrappers.
"""

import dataclasses
import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from raytracer_tpu.ops.pallas_subpacket import (
    CAP,
    LANES,
    LQ,
    ROWS,
    _FULL,
    _SMEM1,
    _SP_SPEC,
)
from raytracer_tpu_torch.accel.bvh import BVH
from raytracer_tpu_torch.lab import queue_walk
from raytracer_tpu_torch.lab import r3_occl3_lab as l8
from raytracer_tpu_torch.lab import r3_oct_lab as l7
from raytracer_tpu_torch.ops import quad_traverse as qt
from tests.conftest import make_traversal_scene
from tools import r3_occl3_lab as jl8
from tools import r3_oct_lab as jl7

torch.set_num_threads(1)  # see test_torch_ops.py

DT = 1e-5
UV = 1e-4
N_OBJECTS = 5  # triangle i belongs to object i % N_OBJECTS


def _scene(n_tris=400, seed=21):
    """A conftest traversal scene with leaf 8 and few objects, the port's
    view of its arrays, and its BVH as the port's BVH class."""
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-4, 4, (n_tris, 3)).astype(np.float32)
    e1 = rng.uniform(-1, 1, (n_tris, 3)).astype(np.float32)
    e2 = rng.uniform(-1, 1, (n_tris, 3)).astype(np.float32)
    obj = (np.arange(n_tris) % N_OBJECTS).astype(np.int32)
    js = make_traversal_scene(v0, e1, e2, tri_object=obj, leaf_size=8)
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    ps = SimpleNamespace(
        ptris=t(js.ptris), qnodes=t(js.qnodes), qmeta=t(js.qmeta),
        root=int(np.asarray(js.qroot)[0]),
        q_stack_need=int(js.q_stack_need))
    bvh = BVH(**{f.name: getattr(js.bvh, f.name)
                 for f in dataclasses.fields(BVH)})
    return js, ps, bvh


@pytest.fixture(scope="module")
def scene():
    return _scene()


def _tree(bvh):
    return l7.oct_tree(bvh, "cpu")


def _rays(m, seed):
    """m random rays (random t_max, a fifth inactive) and a skip object
    each."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-5, 5, (m, 3)).astype(np.float32)
    d = rng.normal(size=(m, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tm = rng.uniform(0.5, 9.0, m).astype(np.float32)
    tm[rng.uniform(size=m) < 0.2] = 1e-3
    skip = rng.integers(0, N_OBJECTS, m).astype(np.int32)
    return o, d, tm, skip


def _tiles(arrays):
    """Per-ray arrays as [1, ROWS, LANES] tiles (one tile of rays)."""
    return [jnp.asarray(a.reshape(1, ROWS, LANES)) for a in arrays]


def _port(*arrays):
    return [torch.from_numpy(a) for a in arrays]


# --------------------------------------------------------------------------
# (a) the collapse.
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n_tris", [400, 6], ids=["tree", "leaf_root"])
def test_collapse_bvh8_matches_jax(n_tris):
    """The port's collapse_bvh8 against tools/r3_oct_lab.collapse_bvh8 on
    the same BVH: arrays equal, NaN in the same places, root and stack need
    the same; the leaf-root scene gives root ~0 and need 8."""
    js, _, bvh = _scene(n_tris)
    got = l7.collapse_bvh8(bvh)
    want = jl7.collapse_bvh8(js.bvh)
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert got[3] == want[3]
    onodes = got[0]
    # An absent child: a NaN box and a NaN meta column (ometa holds 0).
    np.testing.assert_array_equal(np.isnan(onodes[:, 48:56]),
                                  np.isnan(onodes[:, 0:48:6]))
    assert (onodes[:, 56:] == 0).all()
    if n_tris == 6:
        assert got[2][0] == ~0 and got[3] == 8
    else:
        assert got[0].shape[0] > 1 and np.isnan(onodes[:, :48]).any()
        assert got[3] <= queue_walk.CAP


def test_oct_near_is_the_first_least():
    """The 3-bit tournament with strict < at every level picks the first
    index of the least t_near (ties among small integers and BIG)."""
    rng = np.random.default_rng(5)
    tn = rng.integers(0, 4, (4096, 8)).astype(np.float32)
    tn[rng.uniform(size=tn.shape) < 0.3] = qt.BIG
    tn = torch.from_numpy(tn)
    assert torch.equal(queue_walk.oct_near(tn), torch.argmin(tn, dim=1))
    assert int(queue_walk.oct_near(torch.full((1, 8), qt.BIG))[0]) == 0


# --------------------------------------------------------------------------
# (b) L7 against the JAX kernel and the port's K1.
# --------------------------------------------------------------------------

def test_closest8_matches_jax_and_k1(scene):
    js, ps, bvh = scene
    tree = _tree(bvh)
    o, d, tm, _ = _rays(ROWS * LANES, seed=7)
    on, om, orr, _ = jl7.collapse_bvh8(js.bvh)
    out = jl7.run_closest8(*_tiles([o[:, 0], o[:, 1], o[:, 2], d[:, 0],
                                    d[:, 1], d[:, 2], tm]),
                           jnp.asarray(orr), jnp.asarray(om),
                           jnp.asarray(on), js.ptris, interpret=True)
    want = [np.asarray(a).reshape(-1) for a in out]
    got = [g.numpy() for g in l7.run_closest8(*_port(o, d, tm), tree,
                                              ps.ptris)]
    np.testing.assert_array_equal(got[1], want[1])
    assert np.abs(got[0] - want[0]).max() <= DT
    hit = want[1] >= 0
    assert 100 <= hit.sum() < len(hit)
    for g, w in zip(got[2:4], want[2:4]):
        np.testing.assert_allclose(g[hit], w[hit], atol=UV)
    k1 = qt.intersect_quad(*_port(o, d), ps, qt.T_MIN, torch.from_numpy(tm))
    for g, k in zip(got, k1[:4]):
        np.testing.assert_array_equal(g, k.numpy())


def test_closest8_walk_counts(scene):
    """Per ray the 8-wide walk takes fewer internal steps than the 4-wide
    queued walk on the same rays, and its leaf steps are leaf rows of the
    same tree."""
    _, ps, bvh = scene
    tree = _tree(bvh)
    o, d, tm, _ = _port(*_rays(4096, seed=8))
    n = o.shape[0]
    c8 = tuple(torch.zeros(n, dtype=torch.int32) for _ in range(2))
    c4 = tuple(torch.zeros(n, dtype=torch.int32) for _ in range(2))
    got = l7.closest8_plain(o, d, tm, tree, ps.ptris, c8)
    step4 = queue_walk.quad_step(o, qt._inv_dir(d), ps.qmeta, ps.qnodes)
    ref = queue_walk.queued_walk(o, d, tm, ps.root, ps.ptris, step4,
                                 counts=c4)
    assert all(torch.equal(g, r) for g, r in zip(got, ref))
    internal8 = int((c8[0] - c8[1]).sum())
    internal4 = int((c4[0] - c4[1]).sum())
    assert 0 < internal8 < internal4
    assert int(c8[1].sum()) > 0
    assert (c8[0][tm <= qt.T_MIN] == 0).all()


# --------------------------------------------------------------------------
# (c) L8 against the JAX kernel and the port's K2.
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def shadow(scene):
    """A tile of shadow-like rays and the JAX L8 kernel's mask on it."""
    js, _, _ = scene
    o, d, tm, skip = _rays(ROWS * LANES, seed=9)
    leaf_size = js.ptris.shape[1] // 12
    out = pl.pallas_call(
        functools.partial(jl8._occlusion_kernel_ordered, leaf_size),
        grid=(1,),
        in_specs=[_SP_SPEC] * 8 + [_SMEM1, _SMEM1, _FULL, _FULL],
        out_specs=[_SP_SPEC],
        out_shape=[jax.ShapeDtypeStruct((1, ROWS, LANES), jnp.int32)],
        scratch_shapes=[pltpu.SMEM((ROWS * CAP,), jnp.int32),
                        pltpu.SMEM((ROWS * LQ,), jnp.int32)],
        interpret=True,
    )(*_tiles([o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2], tm,
               skip]), js.qroot, js.qmeta, js.qnodes, js.ptris)
    return (o, d, tm, skip), np.asarray(out[0]).reshape(-1) > 0


@pytest.mark.parametrize("ordered", [True, False], ids=["ordered", "fixed"])
def test_occl_ordered_matches_jax_and_k2(ordered, scene, shadow):
    _, ps, _ = scene
    (o, d, tm, skip), want = shadow
    got = l8.run_occl_ordered(*_port(o, d, tm, skip), ps, ordered).numpy()
    np.testing.assert_array_equal(got, want)
    live = tm > 1e-3
    assert 0 < got.sum() < live.sum()
    k2 = qt.occlusion_quad(*_port(o, d), qt.T_MIN, torch.from_numpy(tm), ps,
                           torch.from_numpy(skip)).numpy()
    np.testing.assert_array_equal(got, k2)
    # skip_object decides some rays: without it they would be occluded.
    other = (skip + 1) % N_OBJECTS
    unskipped = l8.run_occl_ordered(*_port(o, d, tm, other), ps,
                                    ordered).numpy()
    assert (unskipped != got).any()


def test_occl_orders_agree_on_many_rays(scene):
    """Both orders and K2 agree on every ray of a larger batch; the order
    moves the steps, not the mask."""
    _, ps, _ = scene
    o, d, tm, skip = _port(*_rays(8192, seed=10))
    k2 = qt.occlusion_quad(o, d, qt.T_MIN, tm, ps, skip)
    n = o.shape[0]
    masks, steps = [], []
    for ordered in (True, False):
        counts = tuple(torch.zeros(n, dtype=torch.int32) for _ in range(2))
        masks.append(l8.occl_ordered_plain(o, d, tm, skip, ps.root, ps.qmeta,
                                           ps.qnodes, ps.ptris, ordered,
                                           counts))
        steps.append(int(counts[0].sum()))
    assert torch.equal(masks[0], k2) and torch.equal(masks[1], k2)
    assert steps[0] > 0 and steps[1] > 0


# --------------------------------------------------------------------------
# (d) guards, leaf root, CPU path.
# --------------------------------------------------------------------------

def test_guards(scene):
    _, ps, bvh = scene
    o, d, tm, skip = _port(*_rays(64, seed=11))
    deep = _tree(bvh)._replace(stack_need=queue_walk.CAP + 1)
    with pytest.raises(ValueError, match="CAP"):
        l7.run_closest8(o, d, tm, deep, ps.ptris)
    with pytest.raises(ValueError, match="order"):
        l8.run_occl_ordered(o, d, tm, skip, ps, ordered="near")
    with pytest.raises(ValueError, match="drain_at"):
        queue_walk.check_drain_at(queue_walk.LQ - 7, 8)
    queue_walk.check_drain_at(queue_walk.LQ - 8, 8)
    with pytest.raises(ValueError, match="drain_at"):
        queue_walk.check_drain_at(queue_walk.LQ - 1)


def test_leaf_root_walks():
    js, ps, bvh = _scene(n_tris=6)
    tree = _tree(bvh)
    assert tree.root < 0 and ps.root < 0
    o, d, tm, skip = _rays(512, seed=12)
    # Aim the rays at the triangles' centroids, so that some hit.
    centroid = np.asarray(js.tri_v0 + (js.tri_e1 + js.tri_e2) / 3.0)
    d = centroid[np.arange(len(o)) % len(centroid)] - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tm[tm > 1e-3] = 1e4
    o, d, tm, skip = _port(o, d, tm, skip)
    got = l7.run_closest8(o, d, tm, tree, ps.ptris)
    k1 = qt.intersect_quad(o, d, ps, qt.T_MIN, tm)
    assert (k1.tri >= 0).any()
    assert all(torch.equal(g, k) for g, k in zip(got, k1[:4]))
    k2 = qt.occlusion_quad(o, d, qt.T_MIN, tm, ps, skip)
    assert k2.any()
    for ordered in (True, False):
        assert torch.equal(l8.run_occl_ordered(o, d, tm, skip, ps, ordered),
                           k2)


def test_cpu_tensors_take_the_plain_versions(scene, monkeypatch):
    """CPU tensors run the plain versions and count no launch."""
    _, ps, bvh = scene
    o, d, tm, skip = _port(*_rays(256, seed=13))

    def refuse(*a, **k):
        raise AssertionError("CUDA wrapper called for CPU tensors")

    monkeypatch.setattr(l7, "_closest8_cuda", refuse)
    monkeypatch.setattr(l8, "_occl_ordered_cuda", refuse)
    l7.reset_launch_counts()
    l8.reset_launch_counts()
    l7.run_closest8(o, d, tm, _tree(bvh), ps.ptris)
    l8.run_occl_ordered(o, d, tm, skip, ps)
    assert (l7.closest_launches, l8.occlusion_launches) == (0, 0)
