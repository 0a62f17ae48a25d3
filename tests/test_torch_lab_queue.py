"""The port's deferred-leaf and component-major lab kernels
(raytracer_tpu_torch/lab: v2_kernel_lab L3, v3_kernel_lab L4,
v4_interleave_lab L5, r3_kernel_lab L6) against the JAX lab kernels they
port, each body run in pl.pallas_call(..., interpret=True) with its lab's
own specs (tools/v2_kernel_lab.py, v3_kernel_lab.py, v4_interleave_lab.py),
or through tools/r3_kernel_lab.run_closest_variant(..., interpret=True).
On CPU tensors the port runs the kernels' plain torch versions;
chip_smoke.py phase 7 holds the CUDA kernels to those on the card.

  (a) L4 counts: in tiles in which every lane holds the same ray, the
      tile's step counts (rows 0 and 1 of its nit output) are that ray's,
      so the port's per-ray nit/nleaf must equal them exactly;
  (b) hit records: a tile of random rays (random t_max, a fifth inactive);
      tri identical, |dt| <= 1e-5 and u/v within 1e-4 on hits (XLA and
      torch round a few terms apart), at least 100 hits and one miss;
  (c) identities of the plain versions: L4 dblread = base, L5 switch = L4
      base, L6 descent = no descent, bit for bit;
  (d) guards: nocond on a scene whose root is a leaf, drain_at outside
      1..LQ-2 and unknown variants raise; a leaf root walks.
"""

import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from raytracer_tpu.ops.pallas_subpacket import LANES, ROWS
from raytracer_tpu.ops.pallas_traverse import STACK_CAP, TILE_L
from raytracer_tpu_torch.lab import kernel_lab, queue_walk
from raytracer_tpu_torch.lab import r3_kernel_lab as r3
from raytracer_tpu_torch.lab import v2_kernel_lab as v2
from raytracer_tpu_torch.lab import v3_kernel_lab as v3
from raytracer_tpu_torch.lab import v4_interleave_lab as v4
from tests.conftest import make_traversal_scene
from tools import r3_kernel_lab as jr3
from tools import v2_kernel_lab as jv2
from tools import v3_kernel_lab as jv3
from tools import v4_interleave_lab as jv4

torch.set_num_threads(1)  # see test_torch_ops.py

DT = 1e-5
UV = 1e-4
ONE_RAY_TILES = 10
_SMEM1 = pl.BlockSpec(memory_space=pltpu.SMEM)
_FULL = pl.BlockSpec(memory_space=pltpu.VMEM)


def _scene(n_tris=160, seed=3):
    """A conftest traversal scene with leaf 8 and the port's view of it."""
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-3, 3, (n_tris, 3)).astype(np.float32)
    e1 = rng.uniform(-1, 1, (n_tris, 3)).astype(np.float32)
    e2 = rng.uniform(-1, 1, (n_tris, 3)).astype(np.float32)
    js = make_traversal_scene(v0, e1, e2, leaf_size=8)
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    ps = SimpleNamespace(
        pnodes=t(js.pnodes), ptris=t(js.ptris), qnodes=t(js.qnodes),
        qmeta=t(js.qmeta), binary_root=int(np.asarray(js.root_meta)[0]),
        root=int(np.asarray(js.qroot)[0]), bvh_max_depth=int(js.bvh_max_depth),
        q_stack_need=int(js.q_stack_need))
    return js, ps


@pytest.fixture(scope="module")
def scene():
    return _scene()


def _rays(m, seed=4, aimed=0):
    """m rays: the first `aimed` aimed into the scene with t_max 1e4, the
    rest random (random t_max, a fifth inactive)."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-4, 4, (m, 3)).astype(np.float32)
    target = rng.uniform(-1.5, 1.5, (m, 3)).astype(np.float32)
    d = np.where(np.arange(m)[:, None] < aimed, target - o,
                 rng.normal(size=(m, 3))).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tm = rng.uniform(0.5, 9.0, m).astype(np.float32)
    tm[rng.uniform(size=m) < 0.2] = 1e-3
    tm[:aimed] = 1e4
    return o, d, tm


def _tiles(o, d, tm, rows, lanes, one_ray=0):
    """The 7 ray tiles [T, rows, lanes]: a tile per each of the first
    `one_ray` rays (every lane that ray), then the rest padded with
    inactive lanes."""
    out = []
    comps = [o[:, c] for c in range(3)] + [d[:, c] for c in range(3)] + [tm]
    for i, a in enumerate(comps):
        one = np.broadcast_to(a[:one_ray, None, None], (one_ray, rows, lanes))
        rest = a[one_ray:]
        pad = (-len(rest)) % (rows * lanes)
        fill = 1e-3 if i == 6 else 0.0  # t_max: inactive
        rest = np.concatenate([rest, np.full(pad, fill, np.float32)])
        out.append(jnp.asarray(np.concatenate(
            [one, rest.reshape(-1, rows, lanes)])))
    return out


def _lanes(a, n, one_ray=0):
    """Per-ray values back from tiles: lane 0 of each one-ray tile, then the
    others' lanes in order."""
    a = np.asarray(a)
    return np.concatenate([a[:one_ray, 0, 0],
                           a[one_ray:].reshape(-1)[:n - one_ray]])


def _port(o, d, tm):
    return torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(tm)


def _check_hits(got, want, n_min_hits=100):
    """tri identical; |dt| <= DT everywhere; u/v within UV on hits."""
    got = [np.asarray(g) for g in got]
    np.testing.assert_array_equal(got[1], want[1])
    assert np.abs(got[0] - want[0]).max() <= DT
    hit = want[1] >= 0
    assert n_min_hits <= hit.sum() < len(hit)
    for g, w in zip(got[2:4], want[2:4]):
        np.testing.assert_allclose(g[hit], w[hit], atol=UV)


def _spec(rows, lanes):
    return pl.BlockSpec((1, rows, lanes), lambda i: (i, 0, 0),
                        memory_space=pltpu.VMEM)


def _out_shapes(n_tiles, rows, lanes, dtypes):
    return [jax.ShapeDtypeStruct((n_tiles, rows, lanes), dt) for dt in dtypes]


_HIT_DTYPES = [jnp.float32, jnp.int32, jnp.float32, jnp.float32]


def _jax_v2(js, tiles, tile_s):
    """tools/v2_kernel_lab.run_closest_v2 in interpret mode."""
    ptris_cm = jnp.asarray(jv2.to_component_major(np.asarray(js.ptris)))
    n_tiles = tiles[0].shape[0]
    spec = _spec(tile_s, TILE_L)
    return pl.pallas_call(
        functools.partial(jv2._closest_kernel_v2, 8, tile_s),
        grid=(n_tiles,), in_specs=[spec] * 7 + [_SMEM1, _FULL, _FULL],
        out_specs=[spec] * 2,
        out_shape=_out_shapes(n_tiles, tile_s, TILE_L,
                              [jnp.float32, jnp.int32]),
        scratch_shapes=[pltpu.SMEM((STACK_CAP,), jnp.int32)],
        interpret=True,
    )(*tiles, js.root_meta, js.pnodes, ptris_cm)


def _jax_v3(js, tiles, variant, drain_at=queue_walk.DRAIN_AT):
    """tools/v3_kernel_lab.run_closest_v3 in interpret mode."""
    n_tiles = tiles[0].shape[0]
    spec = _spec(jv3.ROWS, TILE_L)
    return pl.pallas_call(
        functools.partial(jv3._closest_kernel_v3, 8, drain_at, variant),
        grid=(n_tiles,),
        in_specs=[spec] * 7 + [_SMEM1, _SMEM1, _FULL, _FULL],
        out_specs=[spec] * 5,
        out_shape=_out_shapes(n_tiles, jv3.ROWS, TILE_L,
                              _HIT_DTYPES + [jnp.int32]),
        scratch_shapes=[pltpu.SMEM((jv3.ROWS * jv3.CAP,), jnp.int32),
                        pltpu.SMEM((jv3.ROWS * jv3.LQ,), jnp.int32)],
        interpret=True,
    )(*tiles, js.root_meta, js.pmeta, js.pnodes, js.ptris)


def _jax_v4(js, tiles):
    """tools/v4_interleave_lab.run_closest_v4 in interpret mode."""
    n_inst = tiles[0].shape[0]
    return pl.pallas_call(
        functools.partial(jv4._closest_kernel_v4, 8),
        grid=(n_inst,),
        in_specs=[jv4._SP2] * 7 + [_SMEM1, _SMEM1, _FULL, _FULL],
        out_specs=[jv4._SP2] * 4,
        out_shape=_out_shapes(n_inst, jv4.IL * ROWS, LANES, _HIT_DTYPES),
        scratch_shapes=[
            pltpu.SMEM((jv4.IL * ROWS * jv4.CAP,), jnp.int32),
            pltpu.SMEM((jv4.IL * ROWS * jv4.LQ,), jnp.int32)],
        interpret=True,
    )(*tiles, js.root_meta, js.pmeta, js.pnodes, js.ptris)


# --------------------------------------------------------------------------
# (a) + (b): against the JAX lab kernels.
# --------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["base", "dblread", "nocond"])
def test_v3_counts_and_hits_match_jax(variant, scene):
    """L4: ONE_RAY_TILES one-ray tiles, whose rows 0 and 1 of nit must
    equal the port's per-ray nit and nleaf, and a tile of random rays
    whose hit records must match (nocond's, wrong by design, too)."""
    js, ps = scene
    tile = jv3.ROWS * TILE_L
    o, d, tm = _rays(ONE_RAY_TILES + tile, aimed=ONE_RAY_TILES)
    n = len(o)
    out = _jax_v3(js, _tiles(o, d, tm, jv3.ROWS, TILE_L, ONE_RAY_TILES),
                  variant)
    want = [_lanes(a, n, ONE_RAY_TILES) for a in out[:4]]
    nit = np.asarray(out[4])
    want_nit, want_nleaf = nit[:ONE_RAY_TILES, 0, 0], nit[:ONE_RAY_TILES, 1, 0]
    got = [g.numpy() for g in v3.run_closest_v3(*_port(o, d, tm), ps,
                                                variant=variant)]
    print(f"{variant}: JAX one-ray tiles nit {want_nit.tolist()} nleaf "
          f"{want_nleaf.tolist()}")
    np.testing.assert_array_equal(got[4][:ONE_RAY_TILES], want_nit)
    np.testing.assert_array_equal(got[5][:ONE_RAY_TILES], want_nleaf)
    assert want_nit.max() > 5
    if variant == "nocond":
        assert want_nleaf.max() == 0 and (want[1] < 0).all()
        for g, w in zip(got[:4], want):
            np.testing.assert_array_equal(g, w)
    else:
        assert want_nleaf.max() > 0
        _check_hits(got[:4], want)


@pytest.mark.parametrize("tile_s", [8, 16])
def test_v2_matches_jax(tile_s, scene):
    """L3: the JAX kernel at both tile heights against the port (whose
    result has no tile height)."""
    js, ps = scene
    o, d, tm = _rays(tile_s * TILE_L, seed=5)
    out = _jax_v2(js, _tiles(o, d, tm, tile_s, TILE_L), tile_s)
    want_t, want_tri = (_lanes(a, len(o)) for a in out)
    got_t, got_tri = v2.run_closest_v2(*_port(o, d, tm), ps,
                                       v2.to_component_major(ps.ptris))
    np.testing.assert_array_equal(got_tri.numpy(), want_tri)
    assert np.abs(got_t.numpy() - want_t).max() <= DT
    assert 100 <= (want_tri >= 0).sum() < len(o)


def test_to_component_major_matches_jax(scene):
    js, ps = scene
    np.testing.assert_array_equal(
        v2.to_component_major(ps.ptris).numpy(),
        jv2.to_component_major(np.asarray(js.ptris)))


@pytest.mark.parametrize("variant", ["shared", "switch"])
def test_v4_matches_jax(variant, scene, monkeypatch):
    """L5: one [16, 256] instance of random rays."""
    js, ps = scene
    monkeypatch.setattr(jv4, "VARIANT", variant)
    o, d, tm = _rays(jv4.IL * ROWS * LANES, seed=6)
    out = _jax_v4(js, _tiles(o, d, tm, jv4.IL * ROWS, LANES))
    want = [_lanes(a, len(o)) for a in out]
    _check_hits(v4.run_closest_v4(*_port(o, d, tm), ps, variant), want)


@pytest.mark.parametrize("combo", [
    (False, False, False), (True, False, False), (False, True, False),
    (True, True, False), (False, False, True)],
    ids=["base", "descent", "divfree", "descent+divfree", "leafpar"])
def test_r3_matches_jax(combo, scene):
    """L6: one [8, 256] tile of random rays through
    tools/r3_kernel_lab.run_closest_variant(interpret=True)."""
    js, ps = scene
    o, d, tm = _rays(ROWS * LANES, seed=7)
    out = jr3.run_closest_variant(*_tiles(o, d, tm, ROWS, LANES), js.qroot,
                                  js.qmeta, js.qnodes, js.ptris, *combo,
                                  interpret=True)
    want = [_lanes(a, len(o)) for a in out]
    _check_hits(r3.run_closest_variant(*_port(o, d, tm), ps, *combo), want)


# --------------------------------------------------------------------------
# (c) identities, (d) guards.
# --------------------------------------------------------------------------

def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b, strict=True))


def test_plain_identities(scene):
    """Per ray, dblread is base (counts included), L5 switch is L4 base and
    L6 descent pops in the stack version's order; the deferred leaf only
    moves when leaves are read, so L4/L5/L6 find K3's and K1's hits."""
    _, ps = scene
    o, d, tm = _port(*_rays(4096, seed=9))
    base = v3.run_closest_v3(o, d, tm, ps)
    assert _equal(v3.run_closest_v3(o, d, tm, ps, variant="dblread"), base)
    assert _equal(v4.run_closest_v4(o, d, tm, ps, "switch"), base[:4])
    for divfree in (False, True):
        assert _equal(r3.run_closest_variant(o, d, tm, ps, True, divfree),
                      r3.run_closest_variant(o, d, tm, ps, False, divfree))
    k3 = kernel_lab.run_closest_lab(o, d, tm, ps, "base")
    assert torch.equal(base[1], k3[1]) and torch.equal(base[0], k3[0])
    assert int(base[5].sum()) > 0
    # A larger drain threshold queues more leaves before it tests them.
    late = v3.run_closest_v3(o, d, tm, ps, drain_at=8)
    assert torch.equal(late[1], k3[1])
    assert int(late[4].sum()) != int(base[4].sum())


def test_guards_and_leaf_root():
    """nocond on a one-leaf scene (the JAX loop never ends there), drain_at
    outside 1..LQ-2 and unknown names raise; the walks take a leaf root."""
    _, tiny = _scene(n_tris=6)
    assert tiny.binary_root < 0 and tiny.root < 0
    o, d, tm = _port(*_rays(512, seed=11))
    with pytest.raises(ValueError, match="nocond"):
        v3.run_closest_v3(o, d, tm, tiny, variant="nocond")
    for bad in (0, queue_walk.LQ - 1):
        with pytest.raises(ValueError, match="drain_at"):
            v3.run_closest_v3(o, d, tm, tiny, drain_at=bad)
    with pytest.raises(ValueError, match="variant"):
        v3.run_closest_v3(o, d, tm, tiny, variant="pop2")
    with pytest.raises(ValueError, match="variant"):
        v4.run_closest_v4(o, d, tm, tiny, "both")
    ref = kernel_lab.run_closest_lab(o, d, tm, tiny, "base")
    assert (ref[1] >= 0).any()
    assert _equal(v3.run_closest_v3(o, d, tm, tiny)[:4], ref[:4])
    assert _equal(v4.run_closest_v4(o, d, tm, tiny, "shared"), ref[:4])
    for descent in (False, True):
        got = r3.run_closest_variant(o, d, tm, tiny, descent, False)
        assert _equal(got, ref[:4])


def test_refuses_what_the_kernels_do_not_take(scene):
    """The ILP leaf exists for leaf 8, the component-major leaf reads
    float4s, and the queued stack holds depth + 2 entries."""
    _, ps = scene
    o, d, tm = _port(*_rays(64, seed=12))
    wide = SimpleNamespace(**{**vars(ps), "ptris": ps.ptris.repeat(1, 2)})
    with pytest.raises(ValueError, match="leafpar"):
        r3.run_closest_variant(o, d, tm, wide, False, False, leafpar=True)
    odd = SimpleNamespace(**{**vars(ps), "ptris": ps.ptris[:, :72]})
    with pytest.raises(ValueError, match="multiple of 4"):
        v2.run_closest_v2(o, d, tm, odd, odd.ptris)
    deep = SimpleNamespace(**{**vars(ps), "bvh_max_depth": 63})
    with pytest.raises(ValueError, match="CAP"):
        v3.run_closest_v3(o, d, tm, deep)


def test_cpu_tensors_take_the_plain_versions(scene, monkeypatch):
    """CPU tensors run the plain versions and count no launch."""
    _, ps = scene
    o, d, tm = _port(*_rays(256, seed=13))

    def refuse(*a, **k):
        raise AssertionError("CUDA wrapper called for CPU tensors")

    for mod, fn in ((v2, "_closest_v2_cuda"), (v3, "_closest_v3_cuda"),
                    (v4, "_closest_v4_cuda"), (r3, "_closest_variant_cuda")):
        monkeypatch.setattr(mod, fn, refuse)
        mod.reset_launch_counts()
    v2.run_closest_v2(o, d, tm, ps, v2.to_component_major(ps.ptris))
    v3.run_closest_v3(o, d, tm, ps, variant="nocond")
    v4.run_closest_v4(o, d, tm, ps)
    r3.run_closest_variant(o, d, tm, ps, True, True)
    assert (v2.closest_launches, v3.closest_launches, v4.closest_launches,
            r3.closest_launches) == (0, 0, 0, 0)
