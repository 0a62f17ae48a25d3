"""The port's fixed-sequence labs (raytracer_tpu_torch/lab: visit_cost_lab
L11a/L11b, smem_lab L10, bf16_lab L12) against the JAX lab kernels they
port, run in interpret mode on CPU: tools/visit_cost_lab.py (`kernel`,
`leaf_kernel`), tools/smem_lab.py (`smem_kernel` with its SMEM scratch and
DMA, `transp_kernel`) and tools/bf16_lab.py (the six `_kernel_*`), each in
pl.pallas_call(..., interpret=True) with the lab's own specs and K (and
TILES) set small on the imported module. On CPU tensors the port runs the
kernels' plain torch versions; chip_smoke.py phase 9 holds the CUDA
kernels to those on the card. Every output is compared bit for bit.

  - L11a: the lab's constant rays, a ray that misses every box, and
    one-ray tiles of seeded random rays aimed into the scene (each tile's
    lanes one ray, so the TPU's tile reductions and the port's warp
    reductions agree); `full` must see some child hit. What the kernel's
    redux.sync minimum relies on, on the Cornell box's pnodes with the
    lab's rays and with seeded aimed rays: every value `full` and `noslab`
    reduce is positive (a hit child's t_near >= 1e-3, or BIG), so a warp's
    minimum of the uint32 bit patterns is its float minimum. The SASS loop
    count of phase 9, the ring depth and the launch-shape query.
  - L11b (tile heights 8 and 32) and L10: the constant rays and one tile
    of distinct seeded random rays aimed into the scene, of which at least
    a quarter must hit.
  - L12: TILES = 2, K = 64, on the lab's ones input and on a seeded
    random input in [0.5, 2]: against the kernel bodies run op by op
    (every jnp operation rounding on its own, as the body is written), and
    in interpret mode, where XLA's rewrites of the f32 chains on the CPU
    show (test_bf16_matches_jax_interpret).
"""

import contextlib
import ctypes
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from raytracer_tpu.ops.pallas_traverse import TILE_L, TILE_S
from raytracer_tpu_torch.lab import bf16_lab
from raytracer_tpu_torch.lab import fixed_seq as fs
from raytracer_tpu_torch.lab import smem_lab
from raytracer_tpu_torch.lab import visit_cost_lab as vc
from raytracer_tpu_torch.ops import _build
from raytracer_tpu_torch.ops.quad_traverse import BIG, T_MIN
from tests.conftest import make_traversal_scene
from tests.test_torch_lab import _port_scene
from tools import bf16_lab as jbf
from tools import smem_lab as jsm
from tools import visit_cost_lab as jvc

torch.set_num_threads(1)  # see test_torch_ops.py

RANDOM_TILES = 5  # L11a's one-ray tiles
K_NODES = 64  # L11a's visits in the tests


@pytest.fixture(scope="module")
def scene():
    """A leaf-8 traversal scene of 256 random triangles, in both packages."""
    rng = np.random.default_rng(3)
    t = 256
    v0 = rng.uniform(-2.5, 2.5, (t, 3)).astype(np.float32)
    e1 = rng.uniform(-1, 1, (t, 3)).astype(np.float32)
    e2 = rng.uniform(-1, 1, (t, 3)).astype(np.float32)
    js = make_traversal_scene(v0, e1, e2, leaf_size=8)
    return js, _port_scene(js)


def _aimed(m, seed):
    """m rays from the box [-4, 4]^3 toward points of [-1.5, 1.5]^3."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-4, 4, (m, 3)).astype(np.float32)
    d = rng.uniform(-1.5, 1.5, (m, 3)).astype(np.float32) - o
    return o, (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(
        np.float32)


def _const(m):
    ray = np.full((m, 3), 0.1, np.float32)
    return ray, ray.copy()


def _jax_tiles(o, d, rows):
    """The six ray component tiles [G, rows, TILE_L] of rays f32[G*rows*
    TILE_L, 3]."""
    return [jnp.asarray(a[:, c].reshape(-1, rows, TILE_L))
            for a in (o, d) for c in range(3)]


def _jax_call(kern, tiles, table, rows, scratch=()):
    g = tiles[0].shape[0]
    spec = pl.BlockSpec((1, rows, TILE_L), lambda i: (i, 0, 0),
                        memory_space=pltpu.VMEM)
    out_spec = pl.BlockSpec((1, 8, TILE_L), lambda i: (i, 0, 0),
                            memory_space=pltpu.VMEM)
    (out,) = pl.pallas_call(
        kern, grid=(g,), in_specs=[spec] * 6 + [jvc._FULL],
        out_specs=[out_spec],
        out_shape=[jax.ShapeDtypeStruct((g, 8, TILE_L), jnp.int32)],
        scratch_shapes=list(scratch), interpret=True,
    )(*tiles, table)
    return np.asarray(out)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# --------------------------------------------------------------------------
# L11a
# --------------------------------------------------------------------------

def _visit_rays():
    """The constant ray, a ray missing every box, RANDOM_TILES aimed rays;
    one ray per tile."""
    o, d = _aimed(RANDOM_TILES, seed=5)
    co, cd = _const(1)
    miss_o = np.full((1, 3), 40.0, np.float32)
    miss_d = np.full((1, 3), 3 ** -0.5, np.float32)
    return (np.concatenate([co, miss_o, o]),
            np.concatenate([cd, miss_d, d]))


@pytest.mark.parametrize("variant", vc.VISIT_VARIANTS)
def test_visit_matches_jax(variant, scene, monkeypatch):
    js, ps = scene
    monkeypatch.setattr(jvc, "K", K_NODES)
    o, d = _visit_rays()
    tile = TILE_S * TILE_L
    o_t, d_t = (np.repeat(a, tile, axis=0) for a in (o, d))
    want = _jax_call(functools.partial(jvc.kernel, variant),
                     _jax_tiles(o_t, d_t, TILE_S), js.pnodes, TILE_S)
    assert (want == want[:, :1, :1]).all()  # the accumulator, broadcast
    want = want[:, 0, 0]
    # The port: each tile's ray in a warp of 32 lanes.
    o_w, d_w = (_t(np.repeat(a, fs.WARP, axis=0)) for a in (o, d))
    got = vc.run_visit(o_w, d_w, ps.pnodes, variant, K_NODES).numpy()
    print(f"L11a {variant}: JAX {want.tolist()}")
    np.testing.assert_array_equal(got, np.repeat(want, fs.WARP))
    if variant == "full":
        # m_near + m_far is lmeta + rmeta, so full - (the miss ray's) is
        # the number of hit children along the sequence.
        assert (want[2:] > want[1]).any()
    if variant == "empty":
        assert want[0] == K_NODES * (K_NODES - 1) // 2


def test_visit_reduces_per_warp(scene):
    """With distinct rays in a warp, the reductions run over the warp: the
    plain version's `full` on 32 rays equals it on the same rays in any
    order, and `nored` takes lane 0's values."""
    _, ps = scene
    o, d = (_t(a) for a in _aimed(2 * fs.WARP, seed=6))
    full = vc.run_visit(o, d, ps.pnodes, "full", K_NODES)
    perm = torch.randperm(fs.WARP, generator=torch.Generator().manual_seed(0))
    perm = torch.cat([perm, perm + fs.WARP])
    assert torch.equal(vc.run_visit(o[perm].contiguous(), d[perm].contiguous(),
                                    ps.pnodes, "full", K_NODES), full)
    assert bool((full.view(2, fs.WARP) == full.view(2, fs.WARP)[:, :1]).all())
    nored = vc.run_visit(o, d, ps.pnodes, "nored", K_NODES)
    lane0 = vc.run_visit(o[::fs.WARP].repeat_interleave(fs.WARP, 0),
                         d[::fs.WARP].repeat_interleave(fs.WARP, 0),
                         ps.pnodes, "nored", K_NODES)
    assert torch.equal(nored, lane0)
    with pytest.raises(ValueError, match="multiple"):
        vc.run_visit(o[:40], d[:40], ps.pnodes, "full", K_NODES)


@pytest.fixture(scope="module")
def cornell_pnodes():
    """The Cornell box's pnodes, baked at leaf 8 with the numpy builder."""
    import raytracer_tpu_torch.accel.native_builder as tnative
    import raytracer_tpu_torch.scene.model as tmodel
    from raytracer_tpu_torch.scene.device_scene import bake_scene

    available = tnative.available
    tnative.available = lambda: False
    try:
        ds, _ = bake_scene(tmodel.create_cornell_box(), leaf_size=8,
                           device="cpu")
    finally:
        tnative.available = available
    return ds.pnodes


@pytest.mark.parametrize("rays", ["lab", "aimed"])
@pytest.mark.parametrize("variant", ["full", "noslab"])
def test_visit_minimums_reduce_as_bit_patterns(variant, rays,
                                               cornell_pnodes):
    """Every value `full` and `noslab` reduce with a warp minimum over a
    pass of the Cornell box's rows is positive (a hit child's t_near at
    least t_min 1e-3, or BIG; noslab's t_cap or BIG), and each warp's
    minimum of their uint32 bit patterns, as one redux.sync takes it, has
    the bits of its float minimum."""
    m = 4 * fs.WARP
    o, d = _const(m) if rays == "lab" else _aimed(m, seed=8)
    k = cornell_pnodes.shape[0]
    vals = vc.minimum_inputs(_t(o), _t(d), cornell_pnodes, variant, k)
    assert vals.shape == (k, 2, m)
    assert bool(((vals >= T_MIN) & (vals <= BIG)).all())
    if variant == "full":
        assert bool(((vals == BIG) | (vals < fs.T_CAP)).all())
        hits = int((vals < BIG).sum())
        print(f"{rays}: {hits} of {vals.numel()} values are a hit's t_near")
        assert hits > 0 and (rays == "lab" or hits < vals.numel())
    else:
        assert bool(((vals == BIG) | (vals == fs.T_CAP)).all())
    warps = vals.view(k, 2, -1, fs.WARP)
    as_u32 = warps.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    redux = as_u32.amin(-1).to(torch.int32)
    assert torch.equal(redux, warps.amin(-1).view(torch.int32))


def test_loop_body_is_the_longest_loop():
    """loop_body takes a function's longest loop, from a backward branch's
    target to the branch, whether cuobjdump names the target by label or
    by address, and only in the function asked for."""
    sass = """
        Function : _ZN12_GLOBAL__N_112visit_kernelILi0ELi4EEEvPKf
        /*0000*/                   MOV R1, c[0x0][0x28] ;  /* 0x0 */
.L_x_0:
        /*0010*/                   FADD R2, R3, R4 ;  /* 0x0 */
        /*0020*/                   REDUX.MIN UR4, R2 ;  /* 0x0 */
.L_x_1:
        /*0030*/                   BSSY B0, 0x40 ;  /* 0x0 */
        /*0040*/               @P0 BRA `(.L_x_1) ;  /* 0x0 */
        /*0050*/               @P1 BRA `(.L_x_0) ;  /* 0x0 */
        /*0060*/               @P1 BRA `(.L_x_2) ;  /* 0x0 */
.L_x_2:
        /*0070*/                   EXIT ;  /* 0x0 */
        Function : _ZN12_GLOBAL__N_112visit_kernelILi1ELi4EEEvPKf
        /*0000*/                   MOV R1, c[0x0][0x28] ;  /* 0x0 */
        /*0010*/                   FADD R2, R3, R4 ;  /* 0x0 */
        /*0020*/               @P0 BRA 0x10 ;  /* 0x0 */
        /*0030*/                   EXIT ;  /* 0x0 */
"""
    body = vc.loop_body(sass, "visit_kernelILi0E")
    assert body[0] == "FADD R2, R3, R4" and len(body) == 5
    assert len(vc.loop_body(sass, "visit_kernelILi1E")) == 2
    assert vc.loop_body(sass, "visit_kernelILi2E") == []


def test_loop_body_skips_loops_that_call():
    """L11b's and L10's kernels end in a rerun of their visits with the
    IEEE division, a longer loop that calls the division's slow path:
    loop_body takes the K loop, the longest loop that makes no call."""
    sass = """
        Function : _ZN12_GLOBAL__N_117leaf_visit_kernelILb0EEEvPKf
        /*0000*/                   MOV R1, c[0x0][0x28] ;  /* 0x0 */
        /*0010*/                   FMUL R2, R3, R4 ;  /* 0x0 */
        /*0020*/                   MUFU.RCP R5, R2 ;  /* 0x0 */
        /*0030*/               @P0 BRA 0x10 ;  /* 0x0 */
        /*0040*/                   FADD R2, R3, R4 ;  /* 0x0 */
        /*0050*/                   FMUL R2, R3, R4 ;  /* 0x0 */
        /*0060*/               @P1 CALL.REL.NOINC 0x100 ;  /* 0x0 */
        /*0070*/                   FADD R2, R3, R4 ;  /* 0x0 */
        /*0080*/               @P0 BRA 0x40 ;  /* 0x0 */
        /*0090*/                   EXIT ;  /* 0x0 */
"""
    body = vc.loop_body(sass, "leaf_visit_kernelILb0E")
    assert body == ["FMUL R2, R3, R4", "MUFU.RCP R5, R2", "@P0 BRA 0x10"]


def _lab3_source():
    with open(f"{_build.CSRC_DIR}/lab3_traverse.cu") as f:
        return f.read()


def _mangled(kernel):
    """The distinctive part of a kernel's mangled name from its source
    spelling: visit_kernel<kVFull, ...> -> visit_kernelILi0E,
    leaf_visit_kernel<true> -> leaf_visit_kernelILb1E."""
    name, _, args = kernel.partition("<")
    first = args.split(",")[0].strip(" >")
    if first in ("true", "false"):
        return f"{name}ILb{int(first == 'true')}E"
    enum = ("kVFull", "kVNored", "kVNoslab", "kVExtracts", "kVRowonly",
            "kVEmpty")
    return f"{name}ILi{enum.index(first)}E"


def test_launch_kernels_follow_lab3_launch_info():
    """fixed_seq.LAUNCH_KERNELS lists csrc/lab3_traverse.cu's
    lab3_launch_info table in order: L11a's variants in lab_visit's order,
    L11b's in lab_leaf_visit's (visit_cost_lab.LEAF_VARIANTS: base, ilp,
    slice, sliceilp), L10's smem and transp (smem_lab.VARIANTS), each its
    own template instance."""
    src = _lab3_source()
    table = src[src.index("extern \"C\" int lab3_launch_info"):]
    names = re.findall(r"reinterpret_cast<const void\*>\(([\w<>, ]+)\)",
                       table)
    assert [label for label, _ in fs.LAUNCH_KERNELS] == [
        *(f"L11a {v}" for v in vc.VISIT_VARIANTS),
        *(f"L11b {v}" for v in vc.LEAF_VARIANTS),
        *(f"L10 {v}" for v in smem_lab.VARIANTS)]
    assert len(names) == len(fs.LAUNCH_KERNELS) == 12
    assert [_mangled(k) for k in names] == [m for _, m in fs.LAUNCH_KERNELS]
    assert len(set(names)) == len(names)
    for label, _ in fs.LAUNCH_KERNELS:
        assert fs.LAUNCH_KERNELS[fs.launch_index(label)][0] == label


@pytest.mark.parametrize("entry,variants,base", [
    ("lab_leaf_visit", vc.LEAF_VARIANTS, 6),
    ("lab_smem", smem_lab.VARIANTS, 10)])
def test_launch_codes_follow_the_launch_table(entry, variants, base):
    """Each entry point launches, for variant code c (the variant's index
    in its lab's variants), the kernel at lab3_launch_info's index base +
    c: the launch table, the entry points and LAUNCH_KERNELS agree."""
    src = _lab3_source()
    body = src[src.index(f"extern \"C\" int {entry}("):]
    body = body[:body.index("\n}\n")]
    launched = re.findall(r"((?:leaf_visit|slice_visit|staged)_kernel<\w+>)",
                          body)
    if entry == "lab_smem":  # if (transp) <true> else <false>
        launched = launched[::-1]
    assert [_mangled(k) for k in launched] == [
        fs.LAUNCH_KERNELS[base + c][1] for c in range(len(variants))]


class _LaunchLib:
    """A stand-in for the lab3 library's launches: records (entry, variant
    code) and returns `rc`; lab_rcp_check writes `counts`."""

    def __init__(self):
        self.rc = 0
        self.calls = []
        self.counts = (fs.RCP_FLOATS, 0)

    def _launch(self, entry, args):
        self.calls.append((entry, args[6]))
        return self.rc

    def lab_leaf_visit(self, *args):
        return self._launch("lab_leaf_visit", args)

    def lab_smem(self, *args):
        return self._launch("lab_smem", args)

    def lab_rcp_check(self, counts, stream):
        out = ctypes.cast(counts, ctypes.POINTER(ctypes.c_int64))
        out[0], out[1] = self.counts
        return self.rc


@pytest.fixture
def launch_lib(monkeypatch):
    lib = _LaunchLib()
    monkeypatch.setattr(_build, "lab3_traverse_lib", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(fs, "_stream", lambda dev: ctypes.c_void_p(0))
    for mod in (vc, smem_lab):
        mod.reset_launch_counts()
    return lib


@pytest.mark.parametrize("lab", ["L11b", "L10"])
def test_wrappers_pass_a_code_for_each_variant(lab, scene, launch_lib):
    """The CUDA wrappers of L11b and L10 pass each variant its own code,
    its index in the lab's variants (lab_leaf_visit: 0 base, 1 ilp, 2
    slice, 3 sliceilp; lab_smem: 0 smem, 1 transp), and count one launch
    each; a failed launch raises and is not counted."""
    _, ps = scene
    o, d = (_t(a) for a in _const(64))
    if lab == "L11b":
        entry, variants, wrap = ("lab_leaf_visit", vc.LEAF_VARIANTS,
                                 vc._leaf_visit_cuda)
        count = lambda: vc.leaf_visit_launches  # noqa: E731
    else:
        entry, variants, wrap = "lab_smem", smem_lab.VARIANTS, \
            smem_lab._smem_cuda
        count = lambda: smem_lab.smem_launches  # noqa: E731
    for v in variants:
        out = wrap(o, d, ps.ptris, v, 4, None)
        assert out.shape == (64,) and out.dtype == torch.int32
    assert launch_lib.calls == [(entry, c) for c in range(len(variants))]
    assert count() == len(variants)
    launch_lib.rc = 2
    with pytest.raises(RuntimeError, match=entry):
        wrap(o, d, ps.ptris, variants[0], 4, None)
    assert count() == len(variants)


def test_rcp_check_reads_both_counts(launch_lib):
    """fixed_seq.rcp_check returns lab_rcp_check's two counts, the floats
    checked (RCP_FLOATS: both signs of exponent fields 1-252) and those
    that differ, and raises on a failed launch."""
    cpu = torch.device("cpu")
    assert fs.RCP_FLOATS == 2 * (252 - 1 + 1) * 2 ** 23
    assert fs.rcp_check(cpu) == (fs.RCP_FLOATS, 0)
    launch_lib.counts = (7, 3)
    assert fs.rcp_check(cpu) == (7, 3)
    launch_lib.rc = 1
    with pytest.raises(RuntimeError, match="lab_rcp_check"):
        fs.rcp_check(cpu)


def test_lab3_launch_info_reads_each_kernels_shape_and_spills(monkeypatch):
    """fixed_seq.launch_info asks lab3_launch_info for the kernel's index
    and finds that kernel's spills in the -Xptxas=-v log, each template
    instance apart; a failed query raises."""
    calls = []

    class Lib:
        rc = 0

        def lab3_launch_info(self, index, out):
            calls.append(index)
            for i in range(len(fs.LAUNCH_INFO_KEYS)):
                out[i] = 10 * index + i
            return self.rc

    lib = Lib()
    monkeypatch.setattr(_build, "lab3_traverse_lib", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    log = []
    for k, (_, name) in enumerate(fs.LAUNCH_KERNELS):
        log += [f"ptxas info    : Function properties for _ZN12_GLOBAL__N_"
                f"{name}Ev",
                f"    0 bytes stack frame, {k} bytes spill stores, {k + 1} "
                "bytes spill loads"]
    monkeypatch.setitem(_build.build_info, "liblab3_traverse",
                        {"seconds": 0.0, "log": "\n".join(log)})
    cpu = torch.device("cpu")
    for k in range(len(fs.LAUNCH_KERNELS)):
        info = fs.launch_info(k, cpu)
        assert calls[-1] == k
        assert [info[key] for key in fs.LAUNCH_INFO_KEYS] == [
            10 * k + i for i in range(len(fs.LAUNCH_INFO_KEYS))]
        assert info["spills"] == (k, k + 1)
    assert fs.launch_line(1, cpu).startswith(
        "L11a nored launch: 10 registers, spill stores 1 B")
    lib.rc = 2
    with pytest.raises(RuntimeError, match="lab3_launch_info"):
        fs.launch_info(0, cpu)


# --------------------------------------------------------------------------
# L11b and L10
# --------------------------------------------------------------------------

def _leaf_rays(rows):
    """A tile of the constant ray, then a tile of distinct aimed rays."""
    tile = rows * TILE_L
    co, cd = _const(tile)
    o, d = _aimed(tile, seed=7)
    return np.concatenate([co, o]), np.concatenate([cd, d])


def _check_leaf(want, got, record, rows):
    """JAX rows 0-7 of each tile against the port's per-ray outputs; at
    least a quarter of the random tile's first 1024 rays hit."""
    got = got.reshape(2, rows, TILE_L)[:, :8]
    np.testing.assert_array_equal(got, want)
    btri = record.reshape(2, rows, TILE_L)[1, :8]
    print(f"hits in the random tile's first 8 rows: {(btri >= 0).sum()} of "
          f"{btri.size}; constant-ray outputs {np.unique(want[0]).tolist()}")
    assert (btri >= 0).mean() >= 0.25


@pytest.mark.parametrize("rows", [8, 32])
@pytest.mark.parametrize("variant", vc.LEAF_VARIANTS)
def test_leaf_visit_matches_jax(variant, rows, scene, monkeypatch):
    js, ps = scene
    visits = ps.ptris.shape[0]  # one pass over every leaf row
    monkeypatch.setattr(jvc, "K", 8 * visits)
    o, d = _leaf_rays(rows)
    want = _jax_call(functools.partial(jvc.leaf_kernel, variant),
                     _jax_tiles(o, d, rows), js.ptris, rows)
    o, d = _t(o), _t(d)
    got = vc.run_leaf_visit(o, d, ps.ptris, variant, visits).numpy()
    btri, _ = vc.leaf_visit_plain(o, d, ps.ptris, variant, visits)
    _check_leaf(want, got, btri.numpy(), rows)


@pytest.mark.parametrize("variant", smem_lab.VARIANTS)
def test_smem_matches_jax(variant, scene, monkeypatch):
    js, ps = scene
    visits = ps.ptris.shape[0]
    monkeypatch.setattr(jsm, "K", visits)
    o, d = _leaf_rays(jsm.TS)
    if variant == "smem":
        kern = jsm.smem_kernel
        scratch = [pltpu.SMEM((1, 96), jnp.float32),
                   pltpu.SemaphoreType.DMA(())]
    else:
        kern, scratch = jsm.transp_kernel, []
    want = _jax_call(kern, _jax_tiles(o, d, jsm.TS), js.ptris, jsm.TS,
                     scratch)
    o, d = _t(o), _t(d)
    got = smem_lab.run_smem(o, d, ps.ptris, variant, visits).numpy()
    btri, _ = smem_lab.smem_plain(o, d, ps.ptris, variant, visits)
    _check_leaf(want, got, btri.numpy(), jsm.TS)
    if variant == "smem":  # L10 smem computes L11b base at TS = 8
        base = vc.run_leaf_visit(o, d, ps.ptris, "base", visits).numpy()
        np.testing.assert_array_equal(got, base)


def test_cm_leaf_reduction_takes_minus_one():
    """The component-major leaf's index reduction is the TPU kernels': max
    over the triangles of (t at the least ? index : -1), so a winner whose
    index is below -1 gives -1 while another triangle lies above the
    least t, and keeps its index when all tie."""
    from raytracer_tpu_torch.lab.v2_kernel_lab import _cm_leaf

    def row(tri_a, tri_b, second_hits):
        # Two triangles crossing the ray's path at t = 2 (a) and t = 2 or
        # 3 (b), the rest degenerate (t = BIG); component-major, leaf 4.
        tris = np.zeros((4, 12), np.float32)
        tris[0, :9] = (-1, -1, 2, 3, 0, 0, 0, 3, 0)
        tris[1, :9] = (-1, -1, 2 if second_hits else 3, 3, 0, 0, 0, 3, 0)
        tris[0, 9], tris[1, 9] = tri_a, tri_b
        return torch.from_numpy(tris.T.reshape(1, 48).copy())

    o = torch.zeros((1, 3))
    d = torch.tensor([[0.0, 0.0, 1.0]])
    bt, btri = torch.tensor([1e4]), torch.tensor([-1], dtype=torch.int32)
    for tri_a, tri_b, tie, want in ((-5.0, -7.0, False, -1),
                                    (7.0, -7.0, False, 7),
                                    (-5.0, -7.0, True, -1)):
        t, tri, _, _ = _cm_leaf(o, d, row(tri_a, tri_b, tie), bt, btri,
                                None, None, 1e-3)
        assert float(t) == 2.0 and int(tri) == want, (tri_a, tri_b, tie)


# --------------------------------------------------------------------------
# L12
# --------------------------------------------------------------------------

JAX_BF16 = {"f32": jbf._kernel_f32, "bf16": jbf._kernel_bf16,
            "f32_mul": jbf._kernel_f32_mul, "bf16_mul": jbf._kernel_bf16_mul,
            "f32_ilp": jbf._kernel_f32_ilp, "bf16_ilp": jbf._kernel_bf16_ilp}
K_CHAIN, TILES = 64, 2


def _to_jax(t):
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.view(torch.int16).numpy().view(jnp.bfloat16))
    return jnp.asarray(t.numpy())


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16 if a.dtype.itemsize == 2 else np.uint32)


def _port_bits(t):
    return _bits(t.view(torch.int16).numpy() if t.dtype == torch.bfloat16
                 else t.numpy())


class _OutRef:
    """The output ref of a kernel body run outside pallas_call."""

    def __setitem__(self, idx, value):
        self.value = value


def _jax_op_by_op(variant, args):
    """The JAX lab kernel's body, tile by tile, on JAX arrays outside any
    jit: every jnp operation is compiled and rounded on its own, as the
    body writes it."""
    tiles = []
    for t in range(args[0].shape[0]):
        out = _OutRef()
        JAX_BF16[variant](*(_to_jax(a[t:t + 1]) for a in args), out)
        tiles.append(np.asarray(out.value))
    return np.stack(tiles)


def _jax_interpret(variant, args):
    shape = bf16_lab.tile_shape(variant)
    spec = pl.BlockSpec((1, *shape), lambda i: (i, 0, 0),
                        memory_space=pltpu.VMEM)
    dt = jnp.bfloat16 if bf16_lab.is_bf16(variant) else jnp.float32
    return pl.pallas_call(
        JAX_BF16[variant], grid=(TILES,), in_specs=[spec] * len(args),
        out_specs=spec, out_shape=jax.ShapeDtypeStruct((TILES, *shape), dt),
        interpret=True)(*(_to_jax(a) for a in args))


@pytest.mark.parametrize("seed", [None, 11], ids=["ones", "random"])
@pytest.mark.parametrize("variant", bf16_lab.VARIANTS)
def test_bf16_matches_jax(variant, seed, monkeypatch):
    """Each of the six chains against the JAX kernel body, op by op."""
    monkeypatch.setattr(jbf, "K", K_CHAIN)
    x, y = bf16_lab.inputs(variant, TILES, seed=seed)
    want = _jax_op_by_op(variant, [x] if y is None else [x, y])
    got = bf16_lab.run_bf16(variant, x, y, K_CHAIN)
    np.testing.assert_array_equal(_port_bits(got), _bits(want))
    assert np.isfinite(np.asarray(want, np.float32)).all()
    if seed is None and variant == "bf16":
        # b is below half an ulp of x on the ones input: bf16 = bf16_mul.
        mul = bf16_lab.run_bf16("bf16_mul", x, None, K_CHAIN)
        assert torch.equal(got.view(torch.int16), mul.view(torch.int16))


# In interpret mode XLA compiles the whole body on the CPU and rewrites the
# f32 chains: it contracts x*a + b into one fused multiply-add, and folds
# the multiply chains' constants and factors x*c + y*c. The bf16 chains and
# the ones input come out as the body writes them; on the random input the
# f32 chain comes out as the port's fused form, f32_fma. The rewritten
# f32_mul and f32_ilp have no counterpart in the port.
INTERPRET_CASES = (
    [(v, s, v) for v in bf16_lab.VARIANTS if bf16_lab.is_bf16(v)
     for s in (None, 11)]
    + [(v, None, v) for v in bf16_lab.VARIANTS if not bf16_lab.is_bf16(v)]
    + [("f32", 11, "f32_fma")])


@pytest.mark.parametrize(
    "variant,seed,port", INTERPRET_CASES,
    ids=[f"{v}-{'ones' if s is None else 'random'}-{p}"
         for v, s, p in INTERPRET_CASES])
def test_bf16_matches_jax_interpret(variant, seed, port, monkeypatch):
    """The JAX lab kernels in pl.pallas_call(interpret=True) against the
    port's chain that computes what XLA makes of them."""
    monkeypatch.setattr(jbf, "K", K_CHAIN)
    monkeypatch.setattr(jbf, "TILES", TILES)
    x, y = bf16_lab.inputs(variant, TILES, seed=seed)
    want = _jax_interpret(variant, [x] if y is None else [x, y])
    got = bf16_lab.run_bf16(port, x, y, K_CHAIN)
    np.testing.assert_array_equal(_port_bits(got), _bits(want))


def test_fused_forms_round_once():
    """f32_fma with one step against the correctly rounded x*a + b (an
    80-bit long double product and sum, rounded once to f32), and
    bf16_fma against the f32 x*a + b (exact there) rounded once; within 1
    ulp (the plain versions' own tolerance)."""
    x, y = bf16_lab.inputs("f32_fma", 1, seed=12)
    got = bf16_lab.run_bf16("f32_fma", x, y, 1)
    a, b = (np.uint32(bf16_lab.F32_BITS[c]).view(np.float32) for c in "ab")
    ref = [(v.numpy().astype(np.longdouble) * np.longdouble(a)
            + np.longdouble(b)).astype(np.float32) for v in (x, y)]
    ref = torch.from_numpy(ref[0] + ref[1])
    assert int(bf16_lab.ulp_diff(got, ref).max()) <= 1
    xb, _ = bf16_lab.inputs("bf16_fma", 1, seed=12)
    got = bf16_lab.run_bf16("bf16_fma", xb, None, 1)
    ab, bb = (bf16_lab.bf16_const(bf16_lab.BF16_BITS[c], "cpu").float()
              for c in "ab")
    ref = (xb.float() * ab + bb).to(torch.bfloat16)
    assert int(bf16_lab.ulp_diff(got, ref).max()) <= 1
    unfused = bf16_lab.run_bf16("f32", x, y, 1)
    assert int(bf16_lab.ulp_diff(bf16_lab.run_bf16("f32_fma", x, y, 1),
                                 unfused).max()) <= 2


# --------------------------------------------------------------------------
# Helpers and the CPU path
# --------------------------------------------------------------------------

def test_sat_i32_matches_jax_astype():
    probe = np.array([1e20, -1e20, np.nan, np.inf, -np.inf, 2.9e9, -2.7,
                      2.7, 2147483520.0, -2147483648.0], np.float32)
    want = np.asarray(jnp.asarray(probe).astype(jnp.int32))
    np.testing.assert_array_equal(fs.sat_i32(torch.from_numpy(probe)).numpy(),
                                  want)
    big = torch.tensor([2 ** 31, 2 ** 32 + 5, -(2 ** 31) - 1, 262144 * 262143
                        // 2])
    want = np.array([2 ** 31, 2 ** 32 + 5, -(2 ** 31) - 1,
                     262144 * 262143 // 2]).astype(np.int64).astype(np.int32)
    np.testing.assert_array_equal(fs.wrap_i32(big).numpy(), want)
    assert int(fs.wrap_i32(torch.tensor([262144 * 262143 // 2]))[0]) == int(
        jnp.sum(jnp.arange(262144, dtype=jnp.int32)))


def test_lab_constants_are_the_jax_scalars():
    f32 = lambda v: int(np.asarray(jnp.float32(v)).view(np.uint32))  # noqa
    bf = lambda v: int(np.asarray(jnp.bfloat16(v)).view(np.uint16))  # noqa
    assert bf16_lab.F32_BITS == {
        "a": f32(1.0000001), "b": f32(1e-7),
        "scales": tuple(f32(1.0 + i * 1e-6) for i in range(4))}
    assert bf16_lab.BF16_BITS == {
        "a": bf(1.0078125), "b": bf(0.001),
        "scales": tuple(bf(1.0 + i * 0.01) for i in range(8))}
    assert float(bf16_lab.f32_const(bf16_lab.F32_BITS["a"], "cpu")) == float(
        jnp.float32(1.0000001))
    assert float(bf16_lab.bf16_const(bf16_lab.BF16_BITS["b"], "cpu")) == \
        float(jnp.bfloat16(0.001))
    assert (fs.K_VISIT, fs.K_LEAF, fs.K_SMEM, bf16_lab.K, bf16_lab.TILES) \
        == (jvc.K, jvc.K // 8, jsm.K, jbf.K, jbf.TILES)


def test_cpu_tensors_take_the_plain_versions(scene, monkeypatch):
    """CPU tensors run the plain versions and count no launch; unknown
    variants and malformed inputs are refused."""
    _, ps = scene

    def refuse(*a, **k):
        raise AssertionError("CUDA wrapper called for CPU tensors")

    monkeypatch.setattr(fs, "launch", refuse)
    monkeypatch.setattr(bf16_lab, "_bf16_cuda", refuse)
    for mod in (vc, smem_lab, bf16_lab):
        mod.reset_launch_counts()
    o, d = (_t(a) for a in _const(64))
    vc.run_visit(o, d, ps.pnodes, "full", 4)
    vc.run_leaf_visit(o, d, ps.ptris, "ilp", 4)
    smem_lab.run_smem(o, d, ps.ptris, "transp", 4)
    x, y = bf16_lab.inputs("f32_ilp", 1)
    bf16_lab.run_bf16("f32_ilp", x, y, 8)
    assert (vc.visit_launches, vc.leaf_visit_launches,
            smem_lab.smem_launches, bf16_lab.bf16_launches) == (0, 0, 0, 0)
    with pytest.raises(ValueError, match="variant"):
        vc.run_leaf_visit(o, d, ps.ptris, "full", 4)
    with pytest.raises(ValueError, match="width"):
        smem_lab.run_smem(o, d, ps.pnodes, "smem", 4)
    with pytest.raises(ValueError, match="one input"):
        bf16_lab.run_bf16("bf16", x.to(torch.bfloat16), y, 8)
